"""Run one cell of ``BENCHMARK.json`` once, on the GPU this process sees:

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Prints, last on standard output, one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
untraced, its per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; its last key, ``checks``, holds each number compared with
its limit, which are also the last lines on standard error. Exits non-zero
with no result when CUDA or the cell's cards are missing, or when JAX or
the JAX package was loaded.

A traced run makes each attempt in a fresh process: now and then the
profiler of a process loses every kernel of the program (it keeps the
copies and its own markers, and a second trace in the same process loses
them too), and such an attempt prints no result and exits with
``RETRY``; the run then tries again, twice at most, and fails when no
attempt traced the kernels.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches of the program's toolchains at fixed paths inside the checkout
BUILD = ROOT / "build" / "benchmark"
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "video_restore_tpu")
TRACE_ATTEMPT = "BENCHMARK_TRACE_ATTEMPT"  # set in the environment of each traced attempt
RETRY = 75  # an attempt whose trace lost the program's kernels
RETRY_BEFORE_S = 230.0  # a third attempt starts only this soon: each takes ~100 s warm


def loaded_forbidden(modules) -> list:
    """The forbidden top-level packages among module names, compared whole:
    ``video_restore_tpu_torch`` is not ``video_restore_tpu``."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.trace and TRACE_ATTEMPT not in os.environ:
        return traced(sys.argv[1:] if argv is None else list(argv))

    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s), this process sees {n}", file=sys.stderr)
        return 2
    from benchmark.harness import runner

    device = torch.device("cuda", 0)
    res = runner.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    bad = loaded_forbidden(sys.modules)
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    dev = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": cell.chips,
        "memory_peak_bytes": res["memory_peak_bytes"],
    }
    info = json.dumps({"info": res["info"], "device_limit": _power_limit()}, default=str)
    if args.trace and res["info"].get("trace_sound") is False:
        print(info, file=sys.stderr)
        print(f"benchmark: attempt {os.environ[TRACE_ATTEMPT]}: the trace lost the program's kernels", file=sys.stderr)
        return RETRY
    if args.trace:
        dev["busy_s"] = res["busy_s"]
        dev["window_s"] = res["window_s"]
    print(info)
    out = {
        "correct": res["correct"],
        "attempted": res["attempted"],
        "failed": res["failed"],
        "metrics": res["metrics"],
        "device": dev,
    }
    if args.trace:
        out["breakdown"] = res["breakdown"]
    out["checks"] = res["checks"]
    for name, c in res["checks"].items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {name} {c['value']!r} {rel} {c['limit']!r}", file=sys.stderr)
    if "error" in res["info"]:
        print(f"check error {res['info']['error']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


def traced(argv, command=None) -> int:
    """Runs the traced attempts, each a process of ``command`` (this
    script) with ``argv``, one at a time; returns the exit code of the one
    that ended the run."""
    import signal
    import subprocess

    def stop(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, stop)
    t0 = time.monotonic()
    for attempt in (1, 2, 3):
        if attempt == 3 and time.monotonic() - t0 > RETRY_BEFORE_S:
            break
        child = subprocess.Popen([*(command or [sys.executable, str(Path(__file__).resolve())]), *argv],
                                 env=dict(os.environ, **{TRACE_ATTEMPT: str(attempt)}))
        try:
            rc = child.wait()
        finally:
            if child.poll() is None:
                child.terminate()
                child.wait()
        if rc != RETRY:
            return rc
    print("benchmark: no traced attempt recorded the program's kernels", file=sys.stderr)
    return 4


def _power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return r.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"


if __name__ == "__main__":
    sys.exit(main())
