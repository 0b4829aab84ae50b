"""One residual dense block (RDB) on kernel K1 (``csrc/conv3x3.cu``).

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
bounds-checks its reads, which gives the same SAME padding. Five K1
launches per RDB; c_k is rounded to the activation dtype between launches,
as the Pallas kernel rounds it. A one-launch RDB that keeps c1..c4 on chip
is later work.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from video_restore_tpu_torch.ops.tail import conv3x3, conv3x3_plain


def _rdb(conv, x, ws, bs, x0, **kw):
    if len(ws) != 5 or len(bs) != 5:
        raise ValueError("an RDB has five convs")
    bsz, h, w, nf = x.shape
    gc = ws[0].shape[-1]
    width = nf + 4 * gc
    if ws[4].shape[-1] != nf or ws[4].shape[-2] != width:
        raise ValueError(
            f"conv5 weight {tuple(ws[4].shape)} does not close an RDB of "
            f"nf={nf}, gc={gc}"
        )
    grow = torch.empty((bsz, h, w, width), dtype=x.dtype, device=x.device)
    grow[..., :nf] = x
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
    conv5; bs: their biases; all in x's dtype. Five K1 launches on CUDA,
    the plain version on the CPU."""
    return _rdb(conv3x3, x, ws, bs, x0, counter="rdb_fused")


def rdb_fused_plain(x, ws, bs, x0=None):
    return _rdb(conv3x3_plain, x, ws, bs, x0)
