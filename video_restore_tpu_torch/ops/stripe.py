"""One residual dense block (RDB) on kernel K1 (``ops/tail.py::conv3x3``).

Port of the RDB entry points of ``video_restore_tpu/ops/pallas_stripe.py``:
``rdb_stripe2d_split`` (``:1963``, the production form) and its fallbacks
``rdb_stripe2d_padded`` (``:1525``) and ``rdb_res_stripe2d_padded``
(``:1689``). All three compute, for one RDB with growth gc::

    c_k = lrelu(conv_k(cat(x, c_1 .. c_{k-1})))     k = 1..4
    out = x + 0.2 * conv_5(cat(x, c_1 .. c_4))
    out = x0 + 0.2 * out                             (rdb3: RRDB residual)

The TPU kernels fuse the five convs in VMEM with a prefix-ordered
accumulator (``pallas_stripe.py:21-26``) and mask every growth tensor to
the frame so each conv has SAME zero padding (``:28-32``). Here the prefix
idea becomes the memory layout: one growth buffer ``[x | c1 | c2 | c3 | c4]``
(nf + 4 gc channels), conv k reads its prefix ``[0, nf + (k-1) gc)`` and
writes c_k at its offset, so the concat never exists; each K1 launch
bounds-checks its reads, which gives the same SAME padding. On K1's
``"wgmma"`` route (gc its 32-channel stage) the layout is blocked instead:
c1 .. c4 are the four contiguous blocks of one (4, B, H, W, gc) tensor, and
conv k reads x and blocks ``[0, k-1)`` through two TMA maps, so every
c_k is written, and every stage read, in whole pixels (the 64-byte slices
of the 384-byte pixels of the growth buffer wrote at half the card's rate,
and x is not copied). Five K1 launches per RDB; c_k is rounded to the
activation dtype between launches, as the Pallas kernel rounds it. The same function in one launch, with
c1..c4 kept on chip, is ``ops/rdb.py`` (K5, the ``VRT_PALLAS=1`` body).

:func:`rdb_fused_i8` is the same RDB with the W8A8 int8 convs of
``--precision int8`` (the ``sws`` arguments of the same entry points): five
launches of K4 (``csrc/conv3x3_i8_wgmma.cu`` on the int8 tensor cores at nf
64 / gc 32, ``csrc/conv3x3_i8.cu`` otherwise: ``ops/quant.py::
conv3x3_i8_route``), conv k reading the segments x, c1 .. c_{k-1}, each
quantised with its own per-image scale: on the ``"wgmma"`` route c1 .. c4
in K1's blocks (:func:`blocked_i8`), on the others (and forced ``"mma"``)
in the growth buffer, conv k reading its prefix. The |max| of each segment comes from the launch
that wrote it (K4's output amax) or, for x, from the caller (the previous
RDB's output amax) or the amax kernel, so no conv waits on the host.

With ``sas`` (five calibrated scales for x, c1 .. c4, from
``models/rrdbnet.py::calibrate_rdb_act_scales``) it is the static-A8 form,
the ``sas`` arguments of ``rdb_stripe2d_padded`` / ``rdb_stripe2d_split``
(``:1536``, ``:1976``): the same five K4 launches with fixed scales, no
amax kernel and no amax array.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from video_restore_tpu_torch.ops.quant import (
    act_amax,
    act_amax_plain,
    conv3x3_i8,
    conv3x3_i8_plain,
    pick_i8_route,
    rdb_segments,
)
from video_restore_tpu_torch.ops.tail import (
    WGMMA_KC,
    conv3x3,
    conv3x3_call_route,
    conv3x3_plain,
)


def _check_rdb(x, ws, bs):
    """(nf, gc) of an RDB, after checking that the five convs close one."""
    if len(ws) != 5 or len(bs) != 5:
        raise ValueError("an RDB has five convs")
    nf, gc = x.shape[-1], ws[0].shape[-1]
    if ws[4].shape[-1] != nf or ws[4].shape[-2] != nf + 4 * gc:
        raise ValueError(
            f"conv5 weight {tuple(ws[4].shape)} does not close an RDB of "
            f"nf={nf}, gc={gc}"
        )
    return nf, gc


def _growth_buffer(x, ws, bs):
    """The (B, H, W, nf + 4 gc) buffer ``[x | c1 .. c4]`` with x in place,
    after checking that the five convs close an RDB."""
    nf, gc = _check_rdb(x, ws, bs)
    bsz, h, w, _ = x.shape
    grow = torch.empty((bsz, h, w, nf + 4 * gc), dtype=x.dtype, device=x.device)
    grow[..., :nf] = x
    return grow, nf, gc


def _rdb(conv, x, ws, bs, x0, blocked=False, **kw):
    if blocked:
        _check_rdb(x, ws, bs)
        bsz, h, w, nf = x.shape
        tail = torch.empty((4, bsz, h, w, ws[0].shape[-1]), dtype=x.dtype, device=x.device)
        for k in range(4):
            conv(x, ws[k], bs[k], act="lrelu", out=tail[k], x_tail=tail[:k] if k else None,
                 **kw)
        return conv(x, ws[4], bs[4], r1=x, s1=0.2, r2=x0, s2=0.2, x_tail=tail, **kw)
    grow, nf, gc = _growth_buffer(x, ws, bs)
    for k in range(4):
        lo = nf + k * gc
        conv(
            grow[..., :lo], ws[k], bs[k], act="lrelu",
            out=grow[..., lo : lo + gc], **kw,
        )
    return conv(
        grow, ws[4], bs[4], r1=grow[..., :nf], s1=0.2,
        r2=x0, s2=0.2, **kw,
    )


def rdb_fused(
    x: torch.Tensor,
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    x0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One RDB, optionally with the RRDB residual ``x0 + 0.2 * RDB(x)``.

    x, x0: (B, H, W, nf); ws: the five torch-ordered conv weights, HWIO
    (3, 3, nf + (k-1) gc, gc) for k < 5 and (3, 3, nf + 4 gc, nf) for
    conv5; bs: their biases; all in x's dtype. Five K1 launches on CUDA
    (on the ``"wgmma"`` route with c1 .. c4 in blocks: :func:`blocked`;
    fp32 on ``"bf16x3"`` in the growth buffer, conv k reading its prefix
    at a pixel stride of nf + 4 gc values), the plain version on the CPU."""
    return _rdb(conv3x3, x, ws, bs, x0, blocked=blocked(x, ws, bs), counter="rdb_fused")


def blocked(x: torch.Tensor, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor]) -> bool:
    """Whether :func:`rdb_fused` keeps c1 .. c4 in blocks: a CUDA x whose
    first conv takes K1's ``"wgmma"`` route, with gc the route's stage
    (``ops/tail.py::WGMMA_KC``) and nf whole stages of it."""
    gc = ws[0].shape[-1]
    return (
        x.device.type == "cuda" and gc == WGMMA_KC and x.shape[-1] % WGMMA_KC == 0
        and conv3x3_call_route(x, ws[0], bs[0]) == "wgmma"
    )


def rdb_fused_plain(x, ws, bs, x0=None):
    return _rdb(conv3x3_plain, x, ws, bs, x0)


def _rdb_i8(conv, amax_fn, x, wq, sw, bs, x0, x_amax, sas, wp=None, **kw):
    route = kw.get("route")
    blocked = blocked_i8(x, wq, bs, route)
    if blocked:
        nf, gc = _check_rdb(x, wq, bs)
        # c1 .. c4 as the four blocks of one tail; conv k reads x and the
        # first k - 1 of them
        tail = torch.empty((4, *x.shape[:3], gc), dtype=x.dtype, device=x.device)
    else:
        grow, nf, gc = _growth_buffer(x, wq, bs)
    static = sas is not None
    if static:
        if x_amax is not None:
            raise ValueError("rdb_fused_i8: static A8 (sas) takes no x_amax")
        if len(sas) != 5:
            raise ValueError("static A8 takes five scales: x, c1 .. c4")
        amax = None
    else:
        # column 0: |max| of x; k: of c_k; 5: of the output
        amax = torch.zeros((x.shape[0], 6), dtype=torch.float32, device=x.device)
        if x_amax is None:
            amax_fn(x, out=amax[:, 0])
        else:
            amax[:, 0] = x_amax

    def scales(k):
        """Conv k's A8 arguments: its k sources' fixed scales, or the
        column that receives its output's |max|; and its packed weight,
        where the caller gave one."""
        a8 = dict(sas=tuple(sas[:k])) if static else dict(out_amax=amax[:, k])
        return a8 if wp is None else dict(a8, wp=wp[k - 1])

    def src(k):
        """Conv k's input (x, or the growth buffer's prefix) and, for k < 5,
        where c_k goes."""
        if blocked:
            return dict(x_tail=tail[: k - 1] if k > 1 else None), x, tail[k - 1] if k < 5 else None
        lo = nf + (k - 1) * gc
        return {}, grow[..., :lo], grow[..., lo : lo + gc] if k < 5 else None

    for k in range(1, 5):
        t, xk, out = src(k)
        conv(
            xk, rdb_segments(nf, gc, k), amax, wq[k - 1], sw[k - 1], bs[k - 1],
            act="lrelu", out=out, **t, **scales(k), **kw,
        )
    t, xk, _ = src(5)
    out = conv(
        xk, rdb_segments(nf, gc, 5), amax, wq[4], sw[4], bs[4],
        r1=x if blocked else grow[..., :nf], s1=0.2, r2=x0, s2=0.2, **t, **scales(5), **kw,
    )
    return out, None if static else amax[:, 5]


def blocked_i8(x: torch.Tensor, wq: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
               route: Optional[str] = None) -> bool:
    """Whether :func:`rdb_fused_i8` keeps c1 .. c4 in blocks (as
    :func:`blocked` does for K1): a CUDA x whose first conv takes K4's
    ``"wgmma"`` route (its own, or forced), gc that route's 32-channel
    stage and nf whole stages of it. Forced ``"mma"`` or ``"dp4a"`` keep
    the growth buffer, the layout those kernels read."""
    gc = wq[0].shape[-1]
    return (
        x.device.type == "cuda" and route in (None, "wgmma") and gc == WGMMA_KC
        and x.shape[-1] % WGMMA_KC == 0
        and pick_i8_route(x, rdb_segments(x.shape[-1], gc, 1), wq[0], bs[0]) == "wgmma"
    )


def rdb_fused_i8(
    x: torch.Tensor,
    wq: Sequence[torch.Tensor],
    sw: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    x0: Optional[torch.Tensor] = None,
    x_amax: Optional[torch.Tensor] = None,
    sas: Optional[Sequence[float]] = None,
    wp: Optional[Sequence[torch.Tensor]] = None,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One W8A8 RDB, optionally with the RRDB residual: returns the output
    (as :func:`rdb_fused`) and its per-image |max| (fp32 (B,)), which is
    the next RDB's ``x_amax``.

    x, x0: (B, H, W, nf) bf16; wq: the five int8 HWIO conv weights; sw:
    their fp32 scales (k, cout) for conv k (one row per source segment,
    ``quant.quantize_conv_weights``); bs: the biases in x's dtype; x_amax:
    x's per-image |max| (computed by the amax kernel when not given). Five
    K4 launches on CUDA, the plain version on the CPU.

    sas: static A8, the fixed activation scales of x, c1 .. c4 (python
    floats); ``x_amax`` is then not taken, no amax is computed and the
    returned |max| is None.

    wp: the five weights packed by ``quant.pack_i8_weights``, which K4's
    tensor-core routes read (each conv packs its own when not given); the
    plain version reads ``wq`` and ignores them. route: None for each
    conv's own K4 route, ``"mma"`` or ``"dp4a"`` to force that kernel (a
    side-by-side timing, on the growth buffer)."""
    return _rdb_i8(
        conv3x3_i8, act_amax, x, wq, sw, bs, x0, x_amax, sas, wp,
        route=route, counter="rdb_fused_i8",
    )


def rdb_fused_i8_plain(x, wq, sw, bs, x0=None, x_amax=None, sas=None, wp=None):
    return _rdb_i8(conv3x3_i8_plain, act_amax_plain, x, wq, sw, bs, x0, x_amax, sas)
