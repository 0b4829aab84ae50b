"""One rank of the sharded (dp, tp) train step, for checks and timings.

Run it once per rank, as ``torchrun`` does (``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``) or with ``--coordinator``, ``--world-size`` and
``--rank``::

    torchrun --nproc-per-node 4 -m video_restore_tpu_torch.tools.train_sharded \\
        --dp 2 --tp 2 --job job.pt --out result.pt

Every rank forms the process group (``parallel/multihost.py::
init_multihost``: NCCL where each rank has a GPU of its own, gloo where
ranks share one or run on ``--cpu``; ``--backend`` chooses, and nothing
switches on error), builds the ``("dp", "tp")`` mesh (``parallel/mesh.py::
train_mesh``) and runs ``train_step_sharded`` on the same batches. The job
(``--job FILE``, written by :func:`make_job`, as the tests and
``chip_smoke.py`` write it) is a ``torch.save`` of ``{"arch": "srvgg" |
"rrdbnet", "spec": {...}, "state": {...}, "lr_rate": float, "batches":
[(lr, hr), ...]}``: the model's fp32 state and the batches. After the
steps, ``--time-steps`` more are timed (host clock around synchronised
steps). Rank 0 writes ``--out``: the loss of each step, the step-1
gradients and Adam's moments after step 1, and the weights after the
job's steps (before the timed ones), whole (gathered over "tp"), and ms
per step.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, List, Optional

import torch

from video_restore_tpu_torch.models import rrdbnet, srvgg
from video_restore_tpu_torch.training import train


def _nets():
    return {"rrdbnet": (rrdbnet.RRDBNetSpec, rrdbnet.RRDBNet), "srvgg": (srvgg.SRVGGSpec, srvgg.SRVGGNet)}


def make_job(spec, state: Dict[str, torch.Tensor], lr_rate: float, batches) -> dict:
    """The job a rank runs: ``spec`` an ``RRDBNetSpec`` or ``SRVGGSpec``,
    ``state`` its fp32 state dict, ``batches`` a list of (lr, hr) NHWC
    float32 tensors."""
    arch = "rrdbnet" if isinstance(spec, rrdbnet.RRDBNetSpec) else "srvgg"
    return {"arch": arch, "spec": dataclasses.asdict(spec), "state": state,
            "lr_rate": lr_rate, "batches": batches}


def run_rank(job: dict, dp: int, tp: int, device: torch.device, time_steps: int = 0) -> Optional[dict]:
    """This rank's part of the job on ``device`` (the group formed); returns
    the result on rank 0, None elsewhere."""
    import torch.distributed as dist

    from video_restore_tpu_torch.parallel.mesh import train_mesh

    spec_cls, net_cls = _nets()[job["arch"]]
    net = net_cls(spec_cls(**job["spec"]))
    net.load_state_dict(job["state"])
    net = net.to(device=device, dtype=torch.float32).requires_grad_(True)
    mesh = train_mesh(dp, tp, device.type)
    opt = train.adam(net.parameters(), job["lr_rate"])
    step = train.train_step_sharded(net, opt, mesh)
    losses: List[float] = []
    grads = moments = None
    for i, (lr, hr) in enumerate(job["batches"]):
        losses.append(float(step(lr.to(device), hr.to(device))))
        if i == 0:
            named = list(net.named_parameters())
            grads = train.gather_sharded({n: p.grad for n, p in named}, step.shardings, mesh)
            moments = {k: train.gather_sharded({n: opt.state[p][k] for n, p in named}, step.shardings, mesh)
                       for k in ("exp_avg", "exp_avg_sq")}
    state = train.gather_sharded(dict(net.named_parameters()), step.shardings, mesh)
    ms = None
    if time_steps:  # after the job's steps, on its first batch: the weights above are the job's
        lr, hr = (t.to(device) for t in job["batches"][0])
        step(lr, hr)  # warm
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(time_steps):
            step(lr, hr)
        sync()
        ms = 1e3 * (time.perf_counter() - t0) / time_steps
    if dist.get_rank() != 0:
        return None
    return {"losses": losses, "ms_per_step": ms, "dp": dp, "tp": tp,
            "shardings": step.shardings,
            "grads": {k: v.cpu() for k, v in grads.items()},
            "moments": {m: {k: v.cpu() for k, v in t.items()} for m, t in moments.items()},
            "state": {k: v.cpu() for k, v in state.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dp", type=int, required=True)
    ap.add_argument("--tp", type=int, required=True)
    ap.add_argument("--job", required=True, help="a torch.save'd job (make_job)")
    ap.add_argument("--time-steps", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="default: nccl when every rank has a GPU of its own, else gloo")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--out", default=None, help="rank 0's result (torch.save)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from video_restore_tpu_torch.parallel.multihost import init_multihost
    from video_restore_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.cpu)
    job = torch.load(args.job, weights_only=True)
    backend = args.backend
    if backend is None:
        world = args.world_size
        if world is None:
            import os

            world = int(os.environ.get("WORLD_SIZE", "1"))
        backend = "nccl" if device.type == "cuda" and world <= torch.cuda.device_count() else "gloo"
    rank, world = init_multihost(args.coordinator, args.world_size, args.rank, backend=backend)
    try:
        if device.type == "cuda" and backend == "nccl":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        res = run_rank(job, args.dp, args.tp, device, args.time_steps)
        if res is not None:
            res["backend"] = backend
            if args.out:
                torch.save(res, args.out)
            print(f"dp {args.dp} tp {args.tp} ({backend}, {world} ranks): losses "
                  + ", ".join(f"{v:.7f}" for v in res["losses"])
                  + (f"; {res['ms_per_step']:.3f} ms/step" if res["ms_per_step"] else ""), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
