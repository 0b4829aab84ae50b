"""One RDB, or a whole RRDB, in one launch of kernel K5 (``csrc/rdb_fused.cu``).

Counterpart of ``video_restore_tpu/ops/pallas_rdb.py``. It covers four
Pallas entry points that compute the same two functions:

- :func:`rdb_fused`, one RDB, replaces ``pallas_rdb.py:313 rdb_fused``
  (square blocks) and ``pallas_stripe.py:2079 rdb_stripe`` (stripes,
  unpadded NHWC);
- :func:`rrdb_fused`, a whole RRDB (three RDBs and the residual
  ``x + 0.2 * RDB3(RDB2(RDB1(x)))``), replaces ``pallas_rdb.py:257
  rrdb_fused`` (the ``VRT_PALLAS=1`` body) and ``pallas_stripe.py:1016
  rrdb_stripe_padded`` (padded stripes).

Both take the torch-ordered HWIO weights of ``ops/stripe.py``; the TPU
regroup and prefix layouts are not carried over. On a CUDA tensor a
wrapper launches K5 or raises; on a CPU tensor it runs its plain version.
K5 is two hand-written kernels of one function, and :func:`rdb_route` says
which a call takes: ``"mma"`` (``csrc/rdb_fused_mma.cu``: bf16 ``mma.sync``
on the tile routines of ``csrc/mma_tile.cuh``) for bf16 at nf 64 / gc 32,
``"fma"`` (``csrc/rdb_fused.cu``: fp32 FMAs) for fp32 and the narrow nf 16
/ gc 8 of the checks. The kernel notes (design, bound) are at the top of
the two sources.

The border. The ``pallas_stripe.py`` forms mask every growth tensor to the
frame, so each conv has exact SAME zero padding. The ``pallas_rdb.py`` forms
zero-pad only their input and never mask c1..c4 or, in ``rrdb_fused``, the
intermediate RDB outputs: outside the frame those are non-zero and the next
conv reads them, so near the frame edge (within 4 pixels for one RDB, 14 for
an RRDB) they compute another function than the model's. The port computes
the model's function, SAME at every conv, as the stripe forms and every
other ported path do; the square-block border is a reference behaviour, not
something to copy (``tests/test_torch_rdb.py`` measures it).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from video_restore_tpu_torch.ops import _build
from video_restore_tpu_torch.ops.stripe import rdb_fused_plain
from video_restore_tpu_torch.ops.tail import _DTYPES, PAIR_ROUTES as ROUTES, forced_route

# (nf, gc) pairs K5 is instantiated for: every RRDBNet of the zoo, and the
# narrow width of the tests and checks
WIDTHS = ((64, 32), (16, 8))

RdbWeights = Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]


def rdb_route(dtype: torch.dtype, nf: int, gc: int) -> str:
    """Which of K5's two kernels a call on a CUDA tensor launches: a pure
    function of the call. ``"mma"`` (tensor cores) takes bf16 at (nf, gc) =
    (64, 32), the width of every RRDBNet of the zoo; ``"fma"`` takes fp32
    and the narrow (16, 8)."""
    if dtype == torch.bfloat16 and (nf, gc) == (64, 32):
        return "mma"
    return "fma"


def _pick_route(name: str, x: torch.Tensor, nf: int, gc: int, route: Optional[str]) -> str:
    """The route of a call: :func:`rdb_route`, or ``route`` when the caller
    forces one (a side-by-side timing of the two kernels); ``"mma"`` only
    where the tensor-core kernel is instantiated."""
    return forced_route(name, rdb_route(x.dtype, nf, gc), route, "bf16 at (64, 32)")


def _check(name: str, x: torch.Tensor, rdbs: Sequence[RdbWeights]) -> Tuple[int, int]:
    """Validate x and the RDB weights for a K5 launch; returns (nf, gc)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (fp32, bf16)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NHWC tensor")
    nf = x.shape[-1]
    gc = rdbs[0][0][0].shape[-1]
    if (nf, gc) not in WIDTHS:
        raise ValueError(f"{name}: (nf, gc) = ({nf}, {gc}) not in {WIDTHS}")
    for ws, bs in rdbs:
        if len(ws) != 5 or len(bs) != 5:
            raise ValueError(f"{name}: an RDB has five convs")
        for k in range(5):
            cout = gc if k < 4 else nf
            for t, shape in ((ws[k], (3, 3, nf + k * gc, cout)), (bs[k], (cout,))):
                if tuple(t.shape) != shape:
                    raise ValueError(
                        f"{name}: conv{k + 1} operand {tuple(t.shape)} != {shape}"
                    )
                if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
                    raise ValueError(
                        f"{name}: conv{k + 1} operands must be contiguous "
                        f"{x.dtype} on {x.device}"
                    )
    return nf, gc


def rdb_fused(
    x: torch.Tensor,
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    x0: Optional[torch.Tensor] = None,
    *,
    route: Optional[str] = None,
) -> torch.Tensor:
    """One RDB, optionally with the RRDB residual ``x0 + 0.2 * RDB(x)``:
    the function of ``ops/stripe.py::rdb_fused`` in one K5 launch.

    x, x0: (B, H, W, nf) contiguous; ws: the five HWIO conv weights
    (3, 3, nf + (k-1) gc, gc) and (3, 3, nf + 4 gc, nf); bs: their biases;
    all in x's dtype (fp32 or bf16). ``route``: None for :func:`rdb_route`'s
    kernel, ``"fma"`` to force the fp32-FMA kernel. The launch is counted
    under ``rdb_fused_k5`` and under its route, ``rdb_fused_k5:mma`` or
    ``rdb_fused_k5:fma``."""
    if x.device.type == "cpu":
        return rdb_fused_plain(x, ws, bs, x0)
    nf, gc = _check("rdb_fused", x, [(ws, bs)])
    route = _pick_route("rdb_fused", x, nf, gc, route)
    if x0 is not None and (
        x0.shape != x.shape or x0.dtype != x.dtype or x0.device != x.device
        or not x0.is_contiguous()
    ):
        raise ValueError("rdb_fused: x0 must be contiguous like x")
    out = torch.empty_like(x)
    b, h, w, _ = x.shape
    lib = _build.load()
    fn = lib.vr_rdb_fused_mma if route == "mma" else lib.vr_rdb_fused
    with torch.cuda.device(x.device):
        code = fn(
            _DTYPES[x.dtype], nf, gc, x.data_ptr(),
            x0.data_ptr() if x0 is not None else None, out.data_ptr(),
            _build.pointers(ws), _build.pointers(bs), b, h, w,
            _build.stream_ptr(x),
        )
    _build.check(lib, code, f"rdb_fused (K5) kernel ({route})")
    _build.count_launch("rdb_fused_k5")
    _build.count_launch(f"rdb_fused_k5:{route}")
    return out


def rrdb_fused(
    x: torch.Tensor, rdb_weights: Sequence[RdbWeights], *, route: Optional[str] = None
) -> torch.Tensor:
    """A whole RRDB, ``x + 0.2 * RDB3(RDB2(RDB1(x)))``, in one cooperative
    K5 launch.

    x: (B, H, W, nf) contiguous; rdb_weights: three ``(ws, bs)`` pairs as
    :func:`rdb_fused` takes them, in x's dtype. ``route`` as for
    :func:`rdb_fused`; the launch is counted under ``rrdb_fused`` and
    ``rrdb_fused:<route>``."""
    if x.device.type == "cpu":
        return rrdb_fused_plain(x, rdb_weights)
    if len(rdb_weights) != 3:
        raise ValueError("rrdb_fused: an RRDB has three RDBs")
    nf, gc = _check("rrdb_fused", x, rdb_weights)
    route = _pick_route("rrdb_fused", x, nf, gc, route)
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)
    b, h, w, _ = x.shape
    ws = [t for r in rdb_weights for t in r[0]]
    bs = [t for r in rdb_weights for t in r[1]]
    lib = _build.load()
    fn = lib.vr_rrdb_fused_mma if route == "mma" else lib.vr_rrdb_fused
    with torch.cuda.device(x.device):
        code = fn(
            _DTYPES[x.dtype], nf, gc, x.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), _build.pointers(ws), _build.pointers(bs),
            b, h, w, _build.stream_ptr(x),
        )
    _build.check(lib, code, f"rrdb_fused (K5) kernel ({route})")
    _build.count_launch("rrdb_fused")
    _build.count_launch(f"rrdb_fused:{route}")
    return out


def rrdb_fused_plain(x, rdb_weights):
    """Three plain RDBs and the residual, the RDB3 output rounded to x's
    dtype before ``x + 0.2 *`` in fp32 (``pallas_stripe.py:987``)."""
    (w1, b1), (w2, b2), (w3, b3) = rdb_weights
    out = rdb_fused_plain(x, w1, b1)
    out = rdb_fused_plain(out, w2, b2)
    return rdb_fused_plain(out, w3, b3, x0=x)
