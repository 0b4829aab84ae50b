"""Interpreter exit with live dispatch threads.

Runs ``--runs`` processes, ``--parallel`` at a time. Each builds a
``ShardedUpscaler`` in frames mode over ``[device] * 2``, on the plain path
so that no kernel is built, and runs three batches. It keeps the upscaler
alive to interpreter exit, as a restorer in a reference cycle stays alive.
The upscaler's ``atexit`` finalizer must then stop its two dispatch
threads and wait for them before the interpreter finalizes: a thread still
leaving its CUDA contexts at that point is stopped inside PyTorch's C++
code, which aborts the process with code 134 ("terminate called without an
active exception"). Each process reports the dispatch threads still alive
after the finalizers; the check fails if a process exits other than 0 or
reports one::

    python -m video_restore_tpu_torch.tools.exit_check [--runs 8] [--parallel 4] [--cpu]

``--root DIR`` puts DIR first on the processes' ``PYTHONPATH``, to run the
check against another copy of the package. The last line is a JSON object:
runs, failures, the exit codes seen, and the wall.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# one process; argv[1] is the device type
CHILD = """
import atexit, sys, threading
# registered before any weakref.finalize (torch's import makes some):
# atexit runs it after the finalizers
atexit.register(lambda: print("alive at exit:", sorted(
    t.name for t in threading.enumerate() if t.name.startswith(("dispatch", "tiles"))), flush=True))
import numpy as np, torch
from video_restore_tpu_torch.config import RestoreConfig
from video_restore_tpu_torch.models.zoo import random_model
from video_restore_tpu_torch.ops.tiles import TileGrid
from video_restore_tpu_torch.parallel.dispatch import ShardedUpscaler
torch.set_num_threads(1)
dev = torch.device(sys.argv[1])
cfg = RestoreConfig(model_name="RealESRGAN_x4_v3", tile_size=0, precision="fp32", audio_copy=False,
                    enhanced_mode=True, temporal=True, sharpen=0.3)
ups = ShardedUpscaler(random_model("RealESRGAN_x4_v3"), TileGrid.build(32, 48, 0, 0, 4), cfg,
                      [dev, dev], plain=True)
ups.cycle = ups  # alive to the end
for i in range(3):
    ups.process_batch(np.full((2, 32, 48, 3), 40 * i, np.uint8))
print("alive before exit:", sorted(t.name for t in threading.enumerate() if t.name.startswith("dispatch")),
      flush=True)
"""


def run_one(device: str, root: str, timeout: float) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-c", CHILD, device], capture_output=True, text=True,
                           env=env, cwd=root, timeout=timeout)
        rc, out, err = r.returncode, r.stdout, r.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = None, e.stdout or "", f"[killed after {timeout}s]"
    return dict(rc=rc, out=out, err=err, wall_s=time.perf_counter() - t0,
                ok=rc == 0 and "alive before exit: ['dispatch-0', 'dispatch-1']" in out
                and "alive at exit: []" in out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=8)
    p.add_argument("--parallel", type=int, default=4)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (else cuda:0)")
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="directory put first on the processes' PYTHONPATH (default: this checkout)")
    p.add_argument("--timeout", type=float, default=120.0, help="seconds per process")
    args = p.parse_args(argv)
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device available; pass --cpu", file=sys.stderr)
            return 1
    device = "cpu" if args.cpu else "cuda:0"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max(args.parallel, 1)) as ex:
        res = list(ex.map(lambda _: run_one(device, args.root, args.timeout), range(args.runs)))
    failed = [r for r in res if not r["ok"]]
    for r in failed:
        print(f"rc {r['rc']}: {r['out'][-300:]!r} {r['err'][-500:]!r}", file=sys.stderr)
    print(json.dumps(dict(runs=len(res), failed=len(failed), rcs=sorted({str(r["rc"]) for r in res}),
                          wall_s=time.perf_counter() - t0)))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
