"""Micro-benchmark: one RDB layer on the port's kernels, at the JAX tile-chunk
shape (4, 384, 504, 64) bf16 by default.

Counterpart of ``tools/bench_rdb.py`` of the JAX package: the same shape,
23 chained applications per timed step (one 23-block model's rdb1s, the
output of each feeding the next) and the same useful-MAC count for TF/s.
Weights come from a seed (Kaiming fan-in x 0.1, the body init of
``models/rrdbnet.py::init_params``).

    python -m video_restore_tpu_torch.tools.bench_rdb
        [k1|fused|rrdb|int8|int8s ...] [--cpu] [--shape B,H,W]

Modes (default: all five):

- ``k1``: the default body's RDB, five K1 launches
  (``ops/stripe.py::rdb_fused``);
- ``fused``: one RDB in one K5 launch (``ops/rdb.py::rdb_fused``), the
  counterpart of the JAX tool's ``stripe:BH`` modes (``rdb_stripe``);
- ``rrdb``: a whole RRDB in one K5 launch (``ops/rdb.py::rrdb_fused``), the
  counterpart of ``rrdb:BH`` / ``rrdbp:BH`` (``rrdb_stripe_padded``),
  ceil(23 / 3) RRDBs per step, reported per RDB;
- ``int8``: the W8A8 RDB, five K4 launches (``ops/stripe.py::rdb_fused_i8``),
  the counterpart of ``s2q``;
- ``int8s``: the static-A8 W8A8 RDB, the same five K4 launches with fixed
  activation scales and no amax (``rdb_fused_i8(..., sas=)``), the
  counterpart of ``s2qs``: the scales are calibrated in fp32 on the first
  image's 128x128 crop of the bench input
  (``models/rrdbnet.py::calibrate_rdb_act_scales``), as the JAX tool does.

The JAX tool's other modes (``accum``, ``regroup``, ``old64``, the 2D
blocks ``s2d``/``s2s``, the packed or im2col contractions, ``acc_bf16``)
choose TPU layouts and accumulators; they have no counterpart here.

On the card every mode's first application is checked against its plain
version, then each step is timed with CUDA events. ``--cpu`` runs the plain
versions on the host (host clock) at the shape given, which is all a CPU
run can say: its times are not the card's.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch

NF, GC = 64, 32
SHAPE = (4, 384, 504)
REPS = 23  # RDB applications per timed step (one 23-block model's rdb1s)
MODES = ("k1", "fused", "rrdb", "int8", "int8s")


def useful_flops(b: int, h: int, w: int, nf: int = NF, gc: int = GC) -> int:
    """Useful operations of one RDB application (2 per MAC), the JAX
    tool's count (``tools/bench_rdb.py:54-57``)."""
    return b * 2 * 9 * h * w * (
        nf * (nf + 4 * gc) + gc * ((nf + 3 * gc) + (nf + 2 * gc) + (nf + gc) + nf)
    )


def rdb_weights(gen: torch.Generator, nf: int = NF, gc: int = GC):
    """Seeded fp32 weights and biases of one RDB, HWIO."""
    ws, bs = [], []
    for k in range(5):
        cin, cout = nf + k * gc, gc if k < 4 else nf
        std = math.sqrt(2.0 / (9 * cin)) * 0.1
        ws.append(torch.randn(3, 3, cin, cout, generator=gen) * std)
        bs.append(torch.randn(cout, generator=gen) * 0.01)
    return ws, bs


def _steps(mode: str, ws, bs, x: torch.Tensor, plain: bool):
    """(one application, applications per timed step) for ``mode``; an
    application maps x -> x (int8: (x, amax) -> (x, amax)). ``x`` is the
    bench input, which ``int8s`` calibrates on."""
    from video_restore_tpu_torch.models.rrdbnet import calibrate_rdb_act_scales
    from video_restore_tpu_torch.ops import quant, rdb, stripe

    if mode == "k1":
        fn = stripe.rdb_fused_plain if plain else stripe.rdb_fused
        return (lambda h: fn(h, ws, bs)), REPS
    if mode == "fused":
        fn = rdb.rdb_fused_plain if plain else rdb.rdb_fused
        return (lambda h: fn(h, ws, bs)), REPS
    if mode == "rrdb":
        fn = rdb.rrdb_fused_plain if plain else rdb.rrdb_fused
        three = [(ws, bs)] * 3
        return (lambda h: fn(h, three)), -(-REPS // 3)
    if mode in ("int8", "int8s"):
        qs = [
            quant.quantize_conv_weights(ws[k], quant.rdb_segments(NF, GC, k + 1))
            for k in range(5)
        ]
        wq, sw = [q for q, _ in qs], [s for _, s in qs]
        wp = [quant.pack_i8_weights(q) for q in wq]  # K4's tensor-core routes, as a model prepares it
        fn = stripe.rdb_fused_i8_plain if plain else stripe.rdb_fused_i8
        if mode == "int8s":
            sas = calibrate_rdb_act_scales(ws, bs, x[:1, :128, :128])
            return (lambda h: fn(h, wq, sw, bs, sas=sas, wp=wp)[0]), REPS
        return (lambda h: fn(h[0], wq, sw, bs, x_amax=h[1], wp=wp)), REPS
    raise ValueError(f"unknown mode {mode!r} (expected one of {MODES})")


def bench(
    modes: Sequence[str] = MODES,
    shape: Sequence[int] = SHAPE,
    device: str = "cuda",
    iters: int = 3,
) -> List[Dict]:
    """Run the modes; returns one record per mode. On the card: ``err``,
    the first application's max |kernel - plain|, and ``scale``, the plain
    output's max |value|; ``ms_per_rdb`` and ``tflops`` from CUDA events."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --cpu for the host")
    b, h, w = shape
    gen = torch.Generator().manual_seed(0)
    ws, bs = rdb_weights(gen)
    ws = [t.to(dev, torch.bfloat16) for t in ws]
    bs = [t.to(dev, torch.bfloat16) for t in bs]
    x = torch.rand(b, h, w, NF, generator=gen).to(dev, torch.bfloat16)
    on_card = dev.type == "cuda"
    flops = useful_flops(b, h, w)
    records = []
    for mode in modes:
        app, per_step = _steps(mode, ws, bs, x, plain=not on_card)
        rdbs_per_app = 3 if mode == "rrdb" else 1
        h0 = x
        if mode == "int8":
            from video_restore_tpu_torch.ops.quant import act_amax, act_amax_plain

            h0 = (x, (act_amax if on_card else act_amax_plain)(x))
        rec: Dict = dict(mode=mode, shape=[b, h, w, NF], device=str(dev))
        if on_card:
            ref, _ = _steps(mode, ws, bs, x, plain=True)
            k, p = app(h0), ref(h0)
            k, p = (k[0], p[0]) if mode == "int8" else (k, p)
            rec["err"] = (k.float() - p.float()).abs().max().item()
            rec["scale"] = p.float().abs().max().item()
            del k, p

        def step(hc):
            for _ in range(per_step):
                hc = app(hc)
            return hc

        y = step(h0)  # warm-up (and, on the card, the build)
        if on_card:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(iters):
                y = step(y)
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                y = step(y)
            ms = 1e3 * (time.perf_counter() - t0)
        per_rdb = ms / (iters * per_step * rdbs_per_app)
        rec.update(
            ms_per_rdb=per_rdb, tflops=flops / (per_rdb * 1e-3) / 1e12,
            rdbs_timed=iters * per_step * rdbs_per_app,
        )
        where = torch.cuda.get_device_name(dev) if on_card else "cpu, plain versions, host clock"
        print(
            f"{mode:>6}: {per_rdb:9.3f} ms/RDB-call {rec['tflops']:7.2f} TF/s "
            f"(useful, {b}x{h}x{w}x{NF} bf16; {where})"
            + (f" first-call err {rec['err']:.3g} (|plain| max {rec['scale']:.3g})"
               if on_card else ""),
            flush=True,
        )
        records.append(rec)
        del y
    return records


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("modes", nargs="*", help=f"any of {', '.join(MODES)} (default: all)")
    ap.add_argument("--cpu", action="store_true", help="plain versions on the host")
    ap.add_argument("--shape", default=",".join(map(str, SHAPE)), help="B,H,W")
    args = ap.parse_args(argv)
    shape = tuple(int(v) for v in args.shape.split(","))
    if len(shape) != 3:
        ap.error("--shape takes B,H,W")
    for m in args.modes:
        if m not in MODES:
            ap.error(f"unknown mode {m!r} (expected one of {', '.join(MODES)})")
    try:
        bench(args.modes or MODES, shape, "cpu" if args.cpu else "cuda")
    except RuntimeError as e:
        print(f"E {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
