"""The controls and planted faults of a cell's comparison, on the GPU at
the cell's own size:

    python3 benchmark/control.py --workload CELL --seeds 1,2,3 --mode MODE [--seconds S]

For each seed, one JSON line with the numbers compared and their limits:

- ``fp8``: the float8 control (``reference/precision.py::Fp8``, the
  reference in the precision below the configurations' bf16, put in the
  program's place) against the float32 reference, on the first frames
  after the first cut;
- ``program``: a run of S seconds of the program as the configuration
  states it (the sound runs that set the lower end of each limit);
- ``int8``: a run of S seconds of the program's own lower-precision path
  (``--precision int8``: the W8A8 body);
- ``fault-state``, ``fault-answer``: a run of S seconds with that fault
  planted in the program (``harness/faults.py``).

The benchmark's own runs do not run this; its readings set the upper end
of each limit (``limits/<cell>.json``, PERF.md).
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def fp8_control(cell, seed: int, device):
    from benchmark.harness import check
    from benchmark.harness.video import Stream

    stream = Stream(cell.traffic, seed)
    cut = stream.shot_frames
    ref = check.reference_shot(cell, seed, stream, cut, device, "fp32")
    ctl = check.reference_shot(cell, seed, stream, cut, device, "fp8")
    return check.judge(cell, ctl[0], ref, cut)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", required=True, choices=("fp8", "program", "int8", "fault-state", "fault-answer"))
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.mode == "fp8":
            numbers, info = fp8_control(cell, seed, device)
            print(json.dumps({"seed": seed, "mode": args.mode, "checks": numbers, **_readings(info)}), flush=True)
            continue
        import contextlib

        from benchmark.harness import runner
        from benchmark.harness.faults import FAULTS

        extra = ["--precision", "int8"] if args.mode == "int8" else []
        planted = FAULTS[args.mode[6:]]() if args.mode.startswith("fault-") else contextlib.nullcontext()
        with planted:
            res = runner.run(cell, seed, args.seconds, False, device, time.monotonic(), extra_args=extra)
        print(json.dumps({"seed": seed, "mode": args.mode, "correct": res["correct"], "checks": res["checks"],
                          **_readings(res["info"]), "error": res["info"].get("error"),
                          "launches": res["info"]["launches"]}), flush=True)
    return 0


def _readings(info):
    keys = ("cut", "frame_rms", "bytes_off2_pct", "bytes_off3_pct", "beta", "cut_test")
    return {k: info.get(k) for k in keys}


if __name__ == "__main__":
    sys.exit(main())
