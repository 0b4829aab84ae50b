"""W8A8 int8 convolution: kernel K4 (``csrc/conv3x3_i8.cu``) and its plain
versions.

Port of the int8 branch of ``_conv_prefix``
(``video_restore_tpu/ops/pallas_stripe.py:358``), which the RDB and SRVGG
body kernels run with ``--precision int8``, and of what feeds it:

- W8, once at prepare time (:func:`quantize_conv_weights`): per input
  segment s and output channel o, ``s = max(amax, 1e-12) / 127`` over the
  3x3 x cin_s taps of the compute-dtype weight, ``q = clip(round_half_even(w
  / s), -127, 127)``. For an RDB the segments are the sources x, c1 .. c4
  of each conv, which is ``quantize_prefix_weights`` (``:200-236``) on the
  source-major weights of ``prefix_rdb_weights`` (``:75-108``); for SRVGG
  one segment per conv (``models/srvgg.py:180-185``).
- A8, dynamic (:func:`quant_act_plain`): one scale per (image, segment),
  ``sa = max(amax, 1e-12) * float32(1/127)``, then ``_quant_act`` and
  ``_round_clip_i8`` (``:239-290``) in the activation dtype.
- A8, static (:func:`quant_act_static_plain`; ``_quant_act_static``,
  ``:293-304``, the ``sa_static`` branch of ``_conv_prefix``, ``:396-404``):
  one fixed calibrated scale ``sa_s`` per segment, ``inv = T(1 / sa_s)``
  rounded once from the host's double, the same ``_round_clip_i8``, and the
  dequant factor ``sw[s, o] * float32(sa_s)`` (``fold_static_act_scales``,
  ``:904-914``). No amax is read or written. The ``sas`` argument of
  :func:`conv3x3_i8` selects it.
- The conv (:func:`conv3x3_i8`): an exact integer dot per segment,
  ``float(acc_s) * (sa_s * sw[s, o])``, summed over the segments in order,
  then K1's epilogue (bias, lrelu/PReLU, ``r1 + s1 v``, ``r2 + s2 T(v)``),
  with every multiply-add rounded once: XLA fuses the JAX kernel's
  multiply-adds so (``tests/test_torch_int8.py`` holds the port to it
  bit for bit in bf16).

The JAX kernels take one activation scale per row chunk of their VMEM
window; the port takes one per image (per tile when tiled). The two agree
when one stripe and one chunk cover the frame (ROADMAP queue 3).

:func:`conv3x3_i8` and :func:`act_amax` take their plain versions for CPU
tensors; for CUDA tensors they launch K4 (bf16 only) or raise. K4 is three
hand-written kernels of one function, and :func:`conv3x3_i8_route` says
which a call takes: ``"wgmma"`` (``csrc/conv3x3_i8_wgmma.cu``: int8
``wgmma`` m64nNk32 fed by TMA, a producer warpgroup quantising on load; its
launch plan is :func:`i8_wgmma_plan`) for the calls whose widths feed the
tensor cores, ``"dp4a"`` (``csrc/conv3x3_i8.cu``: ``__dp4a`` on the CUDA
cores, HWIO weights) for the rest; ``"mma"`` (``csrc/conv3x3_i8_mma.cu``:
int8 ``mma.sync`` m16n8k32 on the tile routines of ``csrc/mma_tile.cuh``)
takes the same calls as ``"wgmma"`` when forced (side-by-side timings and
checks). The tensor-core kernels read the weights packed by
:func:`pack_i8_weights`. The integer sums are exact in any order and the
kernels repeat the same fp32 steps, so they agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from video_restore_tpu_torch.ops import _build
from video_restore_tpu_torch.ops.conv import conv2d_f32
from video_restore_tpu_torch.ops.tail import (
    _ACTS,
    _TMA_BOX_MAX,
    _TMA_STRIDE_MAX,
    _pixel_stride,
    _sm_count,
    forced_route,
    operands_aligned,
)

_INV127 = float(np.float32(1.0 / 127.0))  # the fp32 constant JAX multiplies by
MAX_SEGMENTS = 5
I8_ROUTES = ("wgmma", "mma", "dp4a")  # K4's kernels; "dp4a" takes every call
_I8_MMA_K = 32  # input channels per k32 step (m16n8k32, m64nNk32)
_I8_MMA_COUT = (32, 64)  # the widths the tensor-core kernels are instantiated for
_I8_MMA_MAX_CIN = 192  # every stage of the weights resident in shared memory
_I8_TAKES = ("bf16 with segments of multiples of 32, cin up to 192, cout 32 or 64 and aligned "
             "operands")


def conv3x3_i8_route(
    dtype: torch.dtype, segs: Sequence[int], cout: int, aligned: bool = True
) -> str:
    """Which of K4's kernels a call on a CUDA tensor launches: a pure
    function of the call. ``"wgmma"`` (int8 tensor cores) takes bf16 with
    every segment width a multiple of 32 (one k32 step per 32 input
    channels, each step inside one segment: every RDB at nf 64 / gc 32, the
    SRVGG body at nf 64), cin up to 192 (the conv's weights stay in shared
    memory), cout 32 or 64, and ``aligned`` operands
    (:func:`~video_restore_tpu_torch.ops.tail.operands_aligned`);
    ``"dp4a"`` takes every other call: the narrow test widths (nf 16 / gc 8)
    and unaligned views. ``"mma"`` takes the calls of ``"wgmma"`` only when
    forced (:func:`pick_i8_route`)."""
    if (
        dtype == torch.bfloat16
        and all((hi - lo) % _I8_MMA_K == 0 for lo, hi in zip(segs[:-1], segs[1:]))
        and segs[-1] <= _I8_MMA_MAX_CIN
        and cout in _I8_MMA_COUT
        and aligned
    ):
        return "wgmma"
    return "dp4a"


def pick_i8_route(x, segs, wq, b, alpha=None, out=None, r1=None, r2=None, wp=None,
                  route: Optional[str] = None, x_tail=None) -> str:
    """The route of a K4 call: :func:`conv3x3_i8_route` of its operands
    (``out=None``: a fresh contiguous tensor; ``wp=None``: a fresh packed
    copy; both are aligned), or the forced ``route``
    (``ops/tail.py::forced_route`` with K4's route names :data:`I8_ROUTES`:
    ``"dp4a"`` for any call, ``"wgmma"`` only where it is the call's own
    route, ``"mma"`` also there: the ``mma.sync`` kernel takes every such
    call). Only ``"wgmma"`` reads an ``x_tail``."""
    own = conv3x3_i8_route(
        x.dtype, segs, wq.shape[-1], operands_aligned(x, wp, b, alpha, out, r1, r2, x_tail)
    )
    if route == "mma" and own == "wgmma":
        route = "mma"
    else:
        route = forced_route("conv3x3_i8", own, route, _I8_TAKES, routes=I8_ROUTES)
    if x_tail is not None and route != "wgmma":
        raise ValueError(f"conv3x3_i8: x_tail is read by the wgmma kernel only, not {route}")
    return route


# conv3x3_i8_wgmma.cu as shipped (the build reports its own:
# vr_conv3x3_i8_wgmma_config): output rows of a tile by cout (two consumer
# warpgroups of 4 m64 rows at cout 32, of 2 at cout 64, whose s32 and fp32
# sums take twice the registers), pixels of a tile row, channels a stage, the
# int8 ring's depth, the most raw slots, the bytes of the parameters and the
# dynamic shared memory a block can have
I8_WGMMA = dict(rows={32: 8, 64: 4}, tw=64, kc=32, q_depth=3, raw_max=6, param_bytes=2048,
                smem_max=232448)


def i8_wgmma_window(cout: int, geometry: Optional[dict] = None) -> Tuple[int, int]:
    """Bytes of a raw slot (a stage's bf16 window, (rows + 2) x (tw + 2)
    pixels of kc channels) and of an int8 slot (the same window quantised,
    padded to 1024 bytes) at cout."""
    g = I8_WGMMA if geometry is None else geometry
    px = (g["rows"][cout] + 2) * (g["tw"] + 2)
    return px * g["kc"] * 2, -(-px * g["kc"] // 1024) * 1024


class I8WgmmaPlan(NamedTuple):
    """What ``vr_conv3x3_i8_wgmma`` encodes and launches: x's 4-D tensor map
    over (channels, W, H, B) (dims, the byte strides of dims 1-3, the box:
    kc channels of a (TH + 2) x (TW + 2) window, bf16, no swizzle), the
    tail's 32-channel blocks, the byte strides of its 5-D map over (kc, W,
    H, B, blocks) and that map's box (zeros without a tail), the packed
    weights' 3-D map over (cin, cout, 9) int8 (a box of one stage's kc input
    channels of every tap and cout, in the ``w_swizzle``-byte swizzle), the
    persistent grid, the tile, the raw ring's depth (as many bf16 windows as
    fit beside the resident weights), the int8 ring's, the dynamic shared
    memory, and the stage schedule: each stage's segment and the stages
    that start and end one (``folds``: where the s32 sums are folded into
    the fp32 ones)."""

    a_dims: Tuple[int, int, int, int]
    a_strides: Tuple[int, int, int]
    a_box: Tuple[int, int, int, int]
    tail: int
    t_strides: Tuple[int, int, int, int]
    t_box: Tuple[int, int, int, int, int]
    w_dims: Tuple[int, int, int]
    w_strides: Tuple[int, int]
    w_box: Tuple[int, int, int]
    w_swizzle: int
    grid: int
    tiles: int
    tile: Tuple[int, int]
    raw_depth: int
    q_depth: int
    smem: int
    stage_seg: Tuple[int, ...]
    starts: Tuple[int, ...]
    folds: Tuple[int, ...]

    def array(self) -> ctypes.Array:
        """The plan as the C launcher reads it (40 int64 values)."""
        seg_of = sum(s << (4 * k) for k, s in enumerate(self.stage_seg))
        vals = (*self.a_dims, *self.a_strides, *self.a_box, self.tail, *self.t_strides,
                *self.t_box, *self.w_dims, *self.w_strides, *self.w_box, self.w_swizzle,
                self.grid, *self.tile, self.raw_depth, self.q_depth, self.smem,
                len(self.stage_seg), seg_of, sum(1 << k for k in self.starts),
                sum(1 << k for k in self.folds))
        return (ctypes.c_longlong * len(vals))(*vals)


def i8_wgmma_smem(nk: int, cout: int, raw_depth: int, geometry: Optional[dict] = None) -> int:
    """Dynamic shared memory of a ``"wgmma"`` call (``smem_bytes`` of the
    source): the 1024-byte alignment, nk stages of resident weights (9 x
    cout x kc bytes each), the int8 ring, ``raw_depth`` raw windows, the
    parameters and the barriers (the int8 ring's full and empty, the raw
    ring's full, the weights')."""
    g = I8_WGMMA if geometry is None else geometry
    raw, q = i8_wgmma_window(cout, g)
    return (1024 + nk * 9 * cout * g["kc"] + g["q_depth"] * q + raw_depth * raw
            + g["param_bytes"] + (2 * g["q_depth"] + raw_depth + 1) * 8)


def i8_wgmma_plan(
    shape: Sequence[int], xs: int, segs: Sequence[int], cout: int, *, sms: int, tail: int = 0,
    geometry: Optional[dict] = None,
) -> I8WgmmaPlan:
    """The ``"wgmma"`` route's tensor maps, grid, rings and stage schedule
    for a bf16 call: a pure function of x's shape (B, H, W, cx), its pixel
    stride ``xs`` in elements (a channel-prefix view of a wider buffer has
    xs > cx), the segments ``segs`` of the cin = cx + 32 ``tail`` channels
    read (x's, then the tail's blocks), cout (which sets the tile's rows),
    the card's SM count and the build's ``geometry`` (:data:`I8_WGMMA`).
    The same plan serves dynamic and static A8. Raises ValueError for a
    call the kernel does not take or TMA cannot describe."""
    g = I8_WGMMA if geometry is None else geometry
    bsz, h, w, cx = (int(v) for v in shape)
    kc = g["kc"]
    cin = cx + tail * kc
    if min(bsz, h, w, cx) <= 0:
        raise ValueError(f"i8_wgmma_plan: empty shape {tuple(shape)}")
    if xs % 8 or xs < cx:
        raise ValueError(f"i8_wgmma_plan: pixel stride {xs} (a multiple of 8, >= {cx})")
    if (segs[0] != 0 or segs[-1] != cin or len(segs) - 1 > MAX_SEGMENTS
            or any(hi <= lo or (hi - lo) % kc for lo, hi in zip(segs[:-1], segs[1:]))):
        raise ValueError(f"i8_wgmma_plan: segments {tuple(segs)} of cin {cin} (widths of {kc})")
    if cx % kc or cin > _I8_MMA_MAX_CIN or cout not in _I8_MMA_COUT:
        raise ValueError(f"i8_wgmma_plan: x's {cx} channels, cin {cin} (<= {_I8_MMA_MAX_CIN}), "
                         f"cout {cout} (32 or 64)")
    th, tw = g["rows"][cout], g["tw"]
    e = 2  # bf16
    a_strides = (xs * e, w * xs * e, h * w * xs * e)
    a_box = (kc, tw + 2, th + 2, 1)
    t_strides = (kc * e, w * kc * e, h * w * kc * e, bsz * h * w * kc * e) if tail else (0,) * 4
    t_box = (kc, tw + 2, th + 2, 1, 1) if tail else (0,) * 5
    w_dims, w_strides, w_box = (cin, cout, 9), (cin, cout * cin), (kc, cout, 9)
    if max(a_box + w_box) > _TMA_BOX_MAX:
        raise ValueError(f"i8_wgmma_plan: a box over {_TMA_BOX_MAX} elements")
    for st in a_strides + w_strides + t_strides[: 4 if tail else 0]:
        if st % 16 or st >= _TMA_STRIDE_MAX:
            raise ValueError(f"i8_wgmma_plan: byte stride {st} (a multiple of 16, < 2^40)")
    nk = cin // kc
    stage_seg = tuple(max(s for s in range(len(segs) - 1) if segs[s] <= k * kc) for k in range(nk))
    starts = tuple(k for k in range(nk) if k * kc in segs)
    folds = tuple(k for k in range(nk) if (k + 1) * kc in segs)
    room = g["smem_max"] - i8_wgmma_smem(nk, cout, 0, g)
    raw_depth = min(g["raw_max"], room // (i8_wgmma_window(cout, g)[0] + 8))
    if raw_depth < 1:
        raise ValueError(f"i8_wgmma_plan: {nk} stages of cout {cout} leave no room for a window")
    tiles = bsz * -(-h // th) * -(-w // tw)
    return I8WgmmaPlan(
        a_dims=(cx, w, h, bsz), a_strides=a_strides, a_box=a_box, tail=tail,
        t_strides=t_strides, t_box=t_box, w_dims=w_dims, w_strides=w_strides, w_box=w_box,
        w_swizzle=kc, grid=min(tiles, sms), tiles=tiles, tile=(th, tw), raw_depth=raw_depth,
        q_depth=g["q_depth"], smem=i8_wgmma_smem(nk, cout, raw_depth, g),
        stage_seg=stage_seg, starts=starts, folds=folds,
    )


def i8_wgmma_geometry(lib) -> dict:
    """:data:`I8_WGMMA` as a loaded build of ``conv3x3_i8_wgmma.cu`` reports
    it (``vr_conv3x3_i8_wgmma_config``)."""
    cfg = (ctypes.c_int * 13)()
    lib.vr_conv3x3_i8_wgmma_config(cfg)
    g = dict(rows={32: cfg[0], 64: cfg[1]}, tw=cfg[2], kc=cfg[3], q_depth=cfg[4],
             raw_max=cfg[5], param_bytes=cfg[7], smem_max=cfg[8])
    windows = ((cfg[9], cfg[10]), (cfg[11], cfg[12]))
    if (i8_wgmma_window(32, g), i8_wgmma_window(64, g)) != windows:
        raise RuntimeError(f"conv3x3_i8_wgmma: the build's windows {windows} are not the plan's")
    return g


_i8_build: Optional[dict] = None


def _i8_geometry(lib) -> dict:
    """:func:`i8_wgmma_geometry` of the port's library, read once."""
    global _i8_build
    if _i8_build is None:
        _i8_build = i8_wgmma_geometry(lib)
    return _i8_build


def pack_i8_weights(wq: torch.Tensor) -> torch.Tensor:
    """The int8 HWIO weight (3, 3, cin, cout) as the tensor-core routes read
    it: (9, cout, cin), contiguous (n-major, k contiguous: a plain
    ``ldmatrix`` gives the m16n8k32 B fragment, and int8 ``wgmma`` takes
    only K-major operands). A pure function, for the model to call once at
    prepare time, beside the HWIO ``wq`` that the plain version and the
    ``"dp4a"`` route read."""
    if wq.dim() != 4 or tuple(wq.shape[:2]) != (3, 3) or wq.dtype != torch.int8:
        raise ValueError(f"pack_i8_weights: {tuple(wq.shape)} {wq.dtype} is not int8 (3, 3, cin, cout)")
    return wq.reshape(9, wq.shape[2], wq.shape[3]).transpose(1, 2).contiguous()


def rdb_segments(nf: int, gc: int, k: int) -> Tuple[int, ...]:
    """Channel bounds of the sources read by RDB conv ``k`` (1..5): x, then
    c1 .. c_{k-1}."""
    return (0,) + tuple(nf + i * gc for i in range(k))


@torch.no_grad()
def quantize_conv_weights(
    w: torch.Tensor, segs: Sequence[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """W8 of one (3, 3, cin, cout) conv weight whose input channels split
    at ``segs`` (``segs[0] == 0``, ``segs[-1] == cin``): int8 weights in the
    same layout and fp32 scales (len(segs) - 1, cout). Computed in fp32 on
    the CPU from the weight as given (the compute dtype), then placed on the
    weight's device."""
    wf = w.detach().float().cpu()
    if tuple(wf.shape[:2]) != (3, 3) or segs[0] != 0 or segs[-1] != wf.shape[2]:
        raise ValueError(f"segments {tuple(segs)} do not split weight {tuple(w.shape)}")
    q = torch.empty(wf.shape, dtype=torch.int8)
    scales = []
    for lo, hi in zip(segs[:-1], segs[1:]):
        part = wf[:, :, lo:hi]
        amax = part.abs().amax(dim=(0, 1, 2))
        s = torch.clamp(amax, min=1e-12) / 127.0
        q[:, :, lo:hi] = torch.clamp(torch.round(part / s), -127.0, 127.0).to(torch.int8)
        scales.append(s)
    return q.to(w.device), torch.stack(scales).to(w.device)


def quant_act_plain(
    a: torch.Tensor, amax: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A8 with one scale per image: a (B, H, W, C) in bf16 or fp32 ->
    (int8 tensor, fp32 scales (B,)). ``amax`` (B,) is a's per-image |max|
    (computed when not given). The chain runs in a's dtype, as
    ``_quant_act`` runs it: ``inv = T(1 / sa)``, ``p = T(a inv)``,
    ``q = trunc(clip(T(p + copysign(0.5, p)), -127.5, 127.5))``."""
    dt = a.dtype
    if amax is None:
        amax = act_amax_plain(a)
    sa = torch.clamp(amax.float(), min=1e-12) * _INV127
    inv = (1.0 / sa).to(dt).view(-1, 1, 1, 1)
    return _round_clip_i8(a * inv), sa


def _round_clip_i8(p: torch.Tensor) -> torch.Tensor:
    """Round half away from zero in p's dtype, clip, truncate to int8."""
    p = p + torch.copysign(torch.full_like(p, 0.5), p)
    return torch.clamp(p, -127.5, 127.5).to(torch.int8)


def static_act_inverse(sa: float, dt: torch.dtype) -> float:
    """``T(1 / sa)`` of the static quantiser: the reciprocal in double on
    the host, rounded once to the activation dtype (held as a float)."""
    return torch.tensor(1.0 / sa, dtype=torch.float64).to(dt).item()


def quant_act_static_plain(a: torch.Tensor, sa: float) -> torch.Tensor:
    """A8 with a fixed scale (``_quant_act_static``): a in bf16 or fp32 ->
    int8, ``q = round_clip(a * T(1 / sa))`` in a's dtype; values beyond
    127 sa saturate."""
    return _round_clip_i8(a * static_act_inverse(sa, a.dtype))


def act_amax_plain(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-image |max| of x (B, H, W, C) as fp32 (B,)."""
    m = x.abs().amax(dim=(1, 2, 3)).float()
    if out is None:
        return m
    out.copy_(m)
    return out


def act_amax(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-image |max| of x (B, H, W, C), or of a channel-prefix view of a
    wider NHWC buffer, as fp32 (B,), written into ``out`` when given (any
    1-D fp32 view on x's device). The amax entry point of K4's source on
    CUDA (bf16), the plain version on the CPU."""
    if x.device.type == "cpu":
        return act_amax_plain(x, out)
    if x.device.type != "cuda":
        raise ValueError(f"act_amax: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"act_amax: dtype {x.dtype} not supported (bf16)")
    bsz, h, w, c = x.shape
    if out is None:
        out = torch.zeros(bsz, dtype=torch.float32, device=x.device)
    else:
        if out.shape != (bsz,) or out.dtype != torch.float32 or out.device != x.device:
            raise ValueError(f"act_amax: out must be fp32 ({bsz},) on {x.device}")
        out.zero_()
    xs = _pixel_stride(x, "x")
    lib = _build.load()
    with torch.cuda.device(x.device):  # the grid is sized to this card's SMs
        code = lib.vr_amax_bf16(
            x.data_ptr(), out.data_ptr(), bsz, h * w, c, xs, out.stride(0),
            _build.stream_ptr(x),
        )
    _build.check(lib, code, "amax kernel")
    _build.count_launch("act_amax")
    return out


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in fp32 with one rounding (the products of two fp32
    values are exact in float64)."""
    b = b.double() if isinstance(b, torch.Tensor) else float(np.float32(b))
    return (a.double() * b + c.double()).float()


def conv3x3_i8_plain(
    x: torch.Tensor,
    segs: Sequence[int],
    amax: torch.Tensor,
    wq: torch.Tensor,
    sw: torch.Tensor,
    b: torch.Tensor,
    *,
    act: str = "none",
    alpha: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    out_amax: Optional[torch.Tensor] = None,
    r1: Optional[torch.Tensor] = None,
    s1: float = 1.0,
    r2: Optional[torch.Tensor] = None,
    s2: float = 1.0,
    sas: Optional[Sequence[float]] = None,
    x_tail: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K4 (same arguments as :func:`conv3x3_i8`),
    in x's dtype (bf16, or fp32 as JAX's fp32 branch). The integer dot is
    an fp32 conv over integer values, exact below 2^24 (rounded, so a conv
    algorithm that is not exact on the card gives the same integers).
    Every multiply-add rounds once, as XLA fuses the JAX kernel's: the
    dequantised terms ``acc_s * (sa_s sw_s)`` added in source order, the
    bias after a single source, and the residuals."""
    dt = x.dtype
    if x_tail is not None:
        x = torch.cat([x, *x_tail.unbind(0)], dim=-1)
    bias = b.float()
    _check_static(sas, len(segs) - 1, amax, out_amax)
    for s, (lo, hi) in enumerate(zip(segs[:-1], segs[1:])):
        if sas is None:
            q, sa = quant_act_plain(x[..., lo:hi], amax[:, s])
            sc = sa.view(-1, 1, 1, 1) * sw[s].float()
        else:
            q = quant_act_static_plain(x[..., lo:hi], sas[s])
            sc = sw[s].float() * float(np.float32(sas[s]))
        acc = torch.round(conv2d_f32(q.float(), wq[:, :, lo:hi].float()))
        if s == 0:
            y = _fma(acc, sc, bias.expand_as(acc)) if len(segs) == 2 else acc * sc
        else:
            y = _fma(acc, sc, y)
    if len(segs) > 2:
        y = y + bias
    if act == "lrelu":
        y = torch.where(y >= 0, y, y * 0.2)
    elif act == "prelu":
        y = torch.where(y > 0, y, y * alpha.float())
    if r1 is not None:
        y = _fma(y, s1, r1)
    if r2 is not None:
        y = _fma(y.to(dt), s2, r2)
    y = y.to(dt)
    if out is not None:
        y = out.copy_(y)
    if out_amax is not None:
        act_amax_plain(y, out_amax)
    return y


def _check_static(sas, nseg, amax, out_amax) -> None:
    """Static A8 takes one positive scale per segment and no amax."""
    if sas is None:
        return
    if len(sas) != nseg or not all(float(v) > 0 for v in sas):
        raise ValueError(f"conv3x3_i8: sas {tuple(sas)} must be {nseg} positive scales")
    if amax is not None or out_amax is not None:
        raise ValueError("conv3x3_i8: static A8 (sas) reads and writes no amax")


def conv3x3_i8(
    x: torch.Tensor,
    segs: Sequence[int],
    amax: Optional[torch.Tensor],
    wq: torch.Tensor,
    sw: torch.Tensor,
    b: torch.Tensor,
    *,
    act: str = "none",
    alpha: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    out_amax: Optional[torch.Tensor] = None,
    r1: Optional[torch.Tensor] = None,
    s1: float = 1.0,
    r2: Optional[torch.Tensor] = None,
    s2: float = 1.0,
    sas: Optional[Sequence[float]] = None,
    wp: Optional[torch.Tensor] = None,
    route: Optional[str] = None,
    x_tail: Optional[torch.Tensor] = None,
    counter: str,
) -> torch.Tensor:
    """W8A8 ``out = r2 + s2 * (r1 + s1 * act(conv3x3_SAME(x, w) + b))``.

    x: (B, H, W, cin) NHWC or a channel-prefix view of a wider buffer, its
    channels split into segments at ``segs`` (0 = segs[0] < ... <
    segs[-1] = cin, at most 5). amax: fp32 (B, >= nseg), the |max| of each
    image's segment s in column s (any 2-D fp32 view). wq: int8 (3, 3, cin,
    cout) HWIO; sw: fp32 (nseg, cout). b, alpha (cout,), r1, r2 and
    ``out`` as :func:`~video_restore_tpu_torch.ops.tail.conv3x3`, in x's
    dtype. ``out_amax``: an fp32 (B,) view that receives the per-image
    |max| of the stored output (the next conv's scale). ``sas``: static
    A8, one fixed activation scale per segment (python floats) in place of
    ``amax``, which is then None, as is ``out_amax``. ``wp``: ``wq`` packed
    by :func:`pack_i8_weights`, which the tensor-core routes read (packed
    here when not given). ``route``: None for :func:`conv3x3_i8_route`'s
    kernel, ``"mma"`` or ``"dp4a"`` to force that kernel where it takes the
    call (:func:`pick_i8_route`: side-by-side timings). ``x_tail``: a
    contiguous (n, B, H, W, 32) tensor of n blocks whose channels follow
    x's (cin, the segments and the weights count them), which only the
    ``"wgmma"`` kernel reads (the RDB's c1 .. c4 on that route:
    ``ops/stripe.py``). ``counter`` names the launch counter the calling
    wrapper owns; the launch is also counted under ``conv3x3_i8:<route>``."""
    nseg = len(segs) - 1
    if x.device.type == "cpu":
        return conv3x3_i8_plain(
            x, segs, amax, wq, sw, b, act=act, alpha=alpha, out=out,
            out_amax=out_amax, r1=r1, s1=s1, r2=r2, s2=s2, sas=sas, x_tail=x_tail,
        )
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_i8: unsupported device {x.device}")
    dt = torch.bfloat16
    if x.dtype != dt:
        raise TypeError(f"conv3x3_i8: dtype {x.dtype} not supported (bf16)")
    if act not in _ACTS:
        raise ValueError(f"conv3x3_i8: unknown act {act!r}")
    if act == "prelu" and alpha is None:
        raise ValueError("conv3x3_i8: act='prelu' needs alpha (cout,)")
    bsz, h, wd, cin = x.shape
    cout = wq.shape[-1]
    if x_tail is not None:
        if (x_tail.dim() != 5 or tuple(x_tail.shape[1:]) != (bsz, h, wd, _I8_MMA_K)
                or not x_tail.is_contiguous() or x_tail.dtype != dt or x_tail.device != x.device):
            raise ValueError(
                f"conv3x3_i8: x_tail {tuple(x_tail.shape)} is not contiguous {dt} "
                f"(n, {bsz}, {h}, {wd}, {_I8_MMA_K}) on {x.device}"
            )
        cin += x_tail.shape[0] * _I8_MMA_K
    if not 1 <= nseg <= MAX_SEGMENTS or segs[0] != 0 or segs[-1] != cin or any(
        lo >= hi for lo, hi in zip(segs[:-1], segs[1:])
    ):
        raise ValueError(f"conv3x3_i8: bad segments {tuple(segs)} for cin {cin}")
    if tuple(wq.shape) != (3, 3, cin, cout) or wq.dtype != torch.int8:
        raise ValueError(f"conv3x3_i8: weight {tuple(wq.shape)} {wq.dtype} != int8 (3, 3, {cin}, {cout})")
    if tuple(sw.shape) != (nseg, cout) or sw.dtype != torch.float32:
        raise ValueError(f"conv3x3_i8: scales {tuple(sw.shape)} {sw.dtype} != fp32 {(nseg, cout)}")
    _check_static(sas, nseg, amax, out_amax)
    if sas is None and (amax.dim() != 2 or amax.shape[0] != bsz or amax.shape[1] < nseg or amax.dtype != torch.float32 or amax.stride(1) != 1):
        raise ValueError(f"conv3x3_i8: amax {tuple(amax.shape)} must be fp32 ({bsz}, >={nseg}), unit column stride")
    if out is None:
        out = torch.empty((bsz, h, wd, cout), dtype=dt, device=x.device)
    operands = {"x": x, "wq": wq, "sw": sw, "b": b, "out": out}
    for name, t in (("amax", amax), ("alpha", alpha), ("r1", r1), ("r2", r2), ("out_amax", out_amax)):
        if t is not None:
            operands[name] = t
    for name, t in operands.items():
        if t.device != x.device:
            raise ValueError(f"conv3x3_i8: {name} is on {t.device}, expected {x.device}")
        if name in ("b", "alpha", "r1", "r2", "out") and t.dtype != dt:
            raise ValueError(f"conv3x3_i8: {name} is {t.dtype}, expected {dt}")
    for name in ("wq", "sw", "b", "alpha"):
        if name in operands and not operands[name].is_contiguous():
            raise ValueError(f"conv3x3_i8: {name} must be contiguous")
    if b.shape != (cout,) or (alpha is not None and alpha.shape != (cout,)):
        raise ValueError("conv3x3_i8: bias/alpha must have shape (cout,)")
    for name in ("out", "r1", "r2"):
        if name in operands and tuple(operands[name].shape) != (bsz, h, wd, cout):
            raise ValueError(
                f"conv3x3_i8: {name} shape {tuple(operands[name].shape)} != {(bsz, h, wd, cout)}"
            )
    if out_amax is not None and (out_amax.shape != (bsz,) or out_amax.dtype != torch.float32):
        raise ValueError(f"conv3x3_i8: out_amax must be fp32 ({bsz},)")
    xs = _pixel_stride(x, "x")
    ys = _pixel_stride(out, "out")
    r1s = _pixel_stride(r1, "r1") if r1 is not None else 0
    r2s = _pixel_stride(r2, "r2") if r2 is not None else 0
    if wp is not None and (
        tuple(wp.shape) != (9, cout, cin) or wp.dtype != torch.int8
        or wp.device != x.device or not wp.is_contiguous()
    ):
        raise ValueError(f"conv3x3_i8: wp {tuple(wp.shape)} {wp.dtype} != contiguous int8 (9, {cout}, {cin})")
    route = pick_i8_route(x, segs, wq, b, alpha, out, r1, r2, wp, route, x_tail)
    if route == "dp4a":
        wk, fn = wq, "vr_conv3x3_i8"
    else:
        wk, fn = pack_i8_weights(wq) if wp is None else wp, f"vr_conv3x3_i8_{route}"
    if out_amax is not None:
        out_amax.zero_()
    seg_arr = (ctypes.c_int * (MAX_SEGMENTS + 1))(*segs)
    sa_arr = inv_arr = None
    if sas is not None:
        sa_arr = (ctypes.c_float * nseg)(*(float(v) for v in sas))
        inv_arr = (ctypes.c_float * nseg)(*(static_act_inverse(float(v), dt) for v in sas))
    lib = _build.load()
    extra = ()
    with torch.cuda.device(x.device):  # the launch's device is x's
        if route == "wgmma":
            plan = i8_wgmma_plan(
                x.shape, xs, segs, cout, sms=_sm_count(x.device),
                tail=0 if x_tail is None else x_tail.shape[0], geometry=_i8_geometry(lib),
            ).array()
            extra = (plan, len(plan), None if x_tail is None else x_tail.data_ptr())
        code = getattr(lib, fn)(
            x.data_ptr(), amax.data_ptr() if amax is not None else None,
            wk.data_ptr(), sw.data_ptr(),
            b.data_ptr(),
            alpha.data_ptr() if alpha is not None else None,
            r1.data_ptr() if r1 is not None else None,
            r2.data_ptr() if r2 is not None else None,
            out.data_ptr(),
            out_amax.data_ptr() if out_amax is not None else None,
            bsz, h, wd, cin, cout, xs, ys, r1s, r2s,
            amax.stride(0) if amax is not None else 0,
            out_amax.stride(0) if out_amax is not None else 0,
            nseg, seg_arr, sa_arr, inv_arr, _ACTS[act], float(s1), float(s2),
            _build.stream_ptr(x), *extra,
        )
    _build.check(lib, code, f"conv3x3_i8 kernel ({route})")
    _build.count_launch(counter)
    _build.count_launch(f"conv3x3_i8:{route}")
    return out
