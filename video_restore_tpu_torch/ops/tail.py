"""The 3x3 convs around the RRDBNet body, on kernel K1 (``csrc/conv3x3_wgmma.cu``,
``csrc/conv3x3_bf16x3_wgmma.cu`` (fp32) and ``csrc/conv3x3_mma.cu`` on the
tensor cores, ``csrc/conv3x3_narrow.cu`` for the stems and conv_last,
``csrc/conv3x3.cu`` for the rest, both on the CUDA cores), and the
one-launch tail (``csrc/tail_fused_wgmma.cu`` and, for fp32,
``csrc/tail_fused_bf16x3.cu`` on Hopper's tensor cores; K6's
``csrc/tail_fused_mma.cu`` on ``mma.sync`` and ``csrc/tail_fused.cu`` on the
CUDA cores).

Port of ``video_restore_tpu/ops/pallas_tail.py``:

- :func:`conv3x3_fused` replaces ``conv3x3_fused`` (``pallas_tail.py:767``):
  ``act(conv3x3(x) + b) + res``, the stem and ``conv_body`` + the long
  residual;
- :func:`up1_fused` replaces ``up1_fused`` (``:603``):
  ``lrelu(conv3x3(nearest2x(x)) + b)``, giving a plain (B, 2H, 2W, nf)
  tensor (the port has no raw or masked layout);
- :func:`tail_fused` replaces ``tail_fused_raw`` (``:266``) and
  ``tail_fused`` (``:425``): upconv2 (lrelu, nearest 2x) -> conv_hr (lrelu)
  -> conv_last with intermediates in the activation dtype, as the Pallas
  tail rounds them (``pallas_tail.py:188-212``): one launch of
  ``csrc/tail_fused_wgmma.cu`` that keeps both 64-channel intermediates in
  shared memory (bf16 at nf 64: :func:`default_tail_route`), else three K1
  launches (``"chain"``; fp32 among them);
- :func:`tail_fused_q` replaces ``tail_fused_q`` (``pallas_tail.py:1018``,
  the ``VRT_TAIL_Q=1`` tail): the same function, in the same one launch
  (bf16 at nf 64), in one launch of ``csrc/tail_fused_bf16x3.cu`` (fp32 at
  nf 64, on the plan of :func:`tail_x3_plan`), else in one K6 launch; each
  kernel reads up1's output
  and keeps both intermediates on chip, each zeroed outside the frame and
  rounded to the activation dtype as it is stored (``_tail_q_kernel``'s
  ``post_u2`` and ``post_hr``). What is not carried over is the TPU layout: the 4-way
  column packing with its structural-zero weight matrices
  (``wsd_kernel_r``, ``:907``) and up1's ``masked=True`` raw output of
  (b, o) lane pairs exist to fill 128 lanes; here x is a plain NHWC tensor
  and the weights are read as given. The JAX knob's verdict on the TPU
  (``docs/KNOBS.md``: a dead end there, for the MACs the packing spends on
  structural zeros) says nothing about this card: a tile kernel has no such
  zeros, only a recomputed halo.

:func:`conv3x3` is the binding of K1 itself, with :func:`conv3x3_plain`,
its plain PyTorch version, beside it. A wrapper given a CPU tensor runs the
plain version; given a CUDA tensor it launches the kernel or raises. K1 is
one function behind five routes of hand-written kernels, and
:func:`conv3x3_route` says which a call takes: ``"wgmma"``
(``csrc/conv3x3_wgmma.cu``: Hopper's ``wgmma`` on shared-memory operands
that TMA fills, warp-specialised, persistent; its tensor maps from
:func:`wgmma_plan`; read through nearest 2x (up1, upconv2) its producer
warpgroup copies each window at the fine grid with ``cp.async``, since a
TMA box cannot read the 2x grid) for the bf16 convs whose widths feed the
tensor cores, ``"bf16x3"`` (``csrc/conv3x3_bf16x3_wgmma.cu``: the same
``wgmma``s on the three bf16 parts of each fp32 value, six products a MAC
summed in fp32, :func:`split3`; its plan from :func:`bf16x3_plan`) for the
fp32 calls of those widths, ``"mma"`` (``csrc/conv3x3_mma.cu``: bf16 ``mma.sync`` fed by
``ldmatrix`` from shared memory that ``cp.async`` fills), forced beside
``"wgmma"`` for side-by-side runs, ``"narrow"`` (``csrc/conv3x3_narrow.cu``:
fp32 FMAs in ``conv3x3.cu``'s order, one kernel for the stems, cin 3 or 12
-> 64, in bf16 and fp32, one for the bf16 ``conv_last``, 64 -> 3, and one
for the fp32 ``conv_last``, fed by TMA on the plan of :func:`last32_plan`),
``"fma"`` (``csrc/conv3x3.cu``: fp32 FMAs) for the rest: the narrow test
widths and operands the other kernels cannot load. The one-launch tail is four kernels the same way, chosen by
:func:`tail_fused_route`: ``"wgmma"`` (``csrc/tail_fused_wgmma.cu``, on the
launch plan of :func:`tail_wgmma_plan`) for bf16 at nf 64, ``"bf16x3"``
(``csrc/tail_fused_bf16x3.cu``, on :func:`tail_x3_plan`; upconv2 and
conv_hr as K1's ``"bf16x3"`` convs, conv_last as its ``"narrow"``) for fp32 at
nf 64, ``"fma"`` (K6's ``csrc/tail_fused.cu``) for nf 16 and forced calls,
and K6's ``"mma"`` (``csrc/tail_fused_mma.cu``) where a caller forces it
beside ``"wgmma"``.
The kernel notes (what bounds each kernel on the H100 and what its design
does about it) are at the top of the sources.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from video_restore_tpu_torch.ops import _build
from video_restore_tpu_torch.ops.conv import conv2d_f32, upsample_nearest

_ACTS = {"none": 0, "lrelu": 1, "prelu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

ROUTES = ("wgmma", "bf16x3", "mma", "narrow", "fma")  # K1's kernels; "fma" takes every call
PAIR_ROUTES = ("mma", "fma")  # the wrappers with a tensor-core and an fp32-FMA kernel
TAIL_ROUTES = ("wgmma", "bf16x3", "mma", "fma")  # tail_fused_q's kernels; "fma" takes every call
# the one-launch routes the default tail (tail_fused) takes where
# tail_fused_route chooses them; any other call runs as the chain. The fp32
# one launch ("bf16x3") is not among them: on the H100 it is slower than
# the fp32 chain (PERF.md), so it serves tail_fused_q (VRT_TAIL_Q=1) only
DEFAULT_ONE_LAUNCH = ("wgmma",)
CHAIN_ROUTES = (*DEFAULT_ONE_LAUNCH, "chain")  # tail_fused: one launch, or three K1 launches
_TAIL_TAKES = {"wgmma": "bf16 at nf 64 with aligned operands",
               "mma": "bf16 at nf 64 with aligned operands",
               "bf16x3": "fp32 at nf 64 with aligned operands"}
_MMA_COUT = (32, 64)  # the widths of conv3x3_mma.cu, conv3x3_wgmma.cu and the bf16x3 kernel
# (cin, cout) of conv3x3_narrow.cu's kernels by dtype: the stems and
# conv_last, each in bf16 and fp32
_NARROW = {torch.bfloat16: ((3, 64), (12, 64), (64, 3)),
           torch.float32: ((3, 64), (12, 64), (64, 3))}
_K1_TAKES = {
    "wgmma": "bf16 with cin a multiple of 16, cout 32 or 64 and aligned operands",
    "bf16x3": "fp32 with cin a multiple of 16, cout 32 or 64 and aligned operands",
    "mma": "bf16 with cin a multiple of 16, cout 32 or 64 and aligned operands",
    "narrow": "stems (cin 3 or 12 -> 64) and conv_last (64 -> 3), bf16 or fp32, "
              "without residuals or upsample2, with operands it can load",
}


def conv3x3_route(
    dtype: torch.dtype, cin: int, cout: int, aligned: bool = True, narrow: bool = True,
    upsample2: bool = False,
) -> str:
    """Which of K1's kernels a call on a CUDA tensor launches: a pure
    function of the call. The tensor-core widths are bf16 with cin a
    multiple of 16 (one k16 step per 16 input channels), cout 32 or 64 (gc
    and nf of every released model) and ``aligned`` operands
    (:func:`operands_aligned`: 16-byte copies and TMA boxes, paired
    stores); ``"wgmma"`` takes them, also read through nearest 2x
    (``upsample2``: up1 and upconv2, whose windows its producer copies at
    the fine grid); ``"bf16x3"`` takes the same widths in fp32 (the fp32
    flagship's dense-block convs, conv_body, up1, upconv2 and conv_hr, the
    SRVGG body), read through nearest 2x or not; ``"narrow"`` takes the
    stems (cin 3 or 12 -> cout 64) and ``conv_last`` (cin 64 -> cout 3),
    each in bf16 and fp32, where ``narrow`` says the rest of the call suits
    it (:func:`narrow_operands`); ``"fma"`` takes every other call (the
    narrow test widths, operands the other kernels cannot load)."""
    if cin % 16 == 0 and cout in _MMA_COUT and aligned:
        if dtype == torch.bfloat16:
            return "wgmma"
        if dtype == torch.float32:
            return "bf16x3"
    if narrow and (cin, cout) in _NARROW.get(dtype, ()):
        return "narrow"
    return "fma"


def operands_aligned(*tensors: Optional[torch.Tensor], piece_elems: int = 8) -> bool:
    """Whether every given tensor (None is skipped) starts on a 16-byte
    boundary and, where it is NHWC, has a pixel stride that is a multiple of
    ``piece_elems`` elements: at 8, what the tensor-core routes' 16-byte
    copies and TMA boxes need."""
    for t in tensors:
        if t is None:
            continue
        if t.data_ptr() % 16:
            return False
        if t.dim() == 4 and t.stride(2) % piece_elems:
            return False
    return True


def narrow_operands(x, cout, out=None, r1=None, r2=None, upsample2=False) -> bool:
    """Whether a call of the narrow widths suits ``"narrow"``'s kernels: no
    residuals and no ``upsample2``; ``conv_last`` (cout 3) reads x 16 bytes
    (8 bf16 channels; in fp32 4, by TMA) at a time, so x must start on 16
    bytes with a pixel stride of whole 16-byte pieces (a multiple of 8
    elements in bf16, of 4 in fp32); a stem writes ``out`` 16 bytes (8 bf16
    or 4 fp32 couts) at a time, so ``out`` (None: a fresh contiguous tensor)
    must (a pixel stride that is a multiple of 8 elements in bf16, of 4 in
    fp32), while its x is read one value at a time at any pixel stride (cin
    3: 3). Weights, bias and alpha are read one value at a time."""
    if upsample2 or r1 is not None or r2 is not None:
        return False
    t = x if cout == 3 else out
    return t is None or operands_aligned(t, piece_elems=16 // t.element_size())


def conv3x3_call_route(x, w, b, alpha=None, out=None, r1=None, r2=None, upsample2=False) -> str:
    """:func:`conv3x3_route` of one call's operands (``out=None``: a fresh
    contiguous tensor, which is aligned)."""
    cout = w.shape[-1]
    return conv3x3_route(
        x.dtype, w.shape[-2], cout,
        operands_aligned(x, w, b, alpha, out, r1, r2),
        narrow_operands(x, cout, out, r1, r2, upsample2),
        upsample2,
    )


def _pixel_stride(t: torch.Tensor, name: str) -> int:
    """Pixel stride of a channel-prefix view of a contiguous NHWC buffer
    (a whole tensor or ``buf[..., a:b]``); raises for any other layout."""
    if t.dim() != 4:
        raise ValueError(f"{name} must be NHWC, got shape {tuple(t.shape)}")
    b, h, w, c = t.shape
    s0, s1, s2, s3 = t.stride()
    if not (s3 == 1 and s2 >= c and s1 == w * s2 and (b == 1 or s0 == h * s1)):
        raise ValueError(
            f"{name} must be a channel slice of a contiguous NHWC buffer "
            f"(shape {tuple(t.shape)}, strides {t.stride()})"
        )
    return s2


# conv3x3_wgmma.cu as shipped: rows and pixels of an output tile, blocks an
# SM, input channels a stage (the build reports its own:
# vr_conv3x3_wgmma_config)
WGMMA_TILE = (4, 64)
WGMMA_PER_SM = 1
WGMMA_KC = 32
_TMA_BOX_MAX = 256  # elements a box dimension
_TMA_STRIDE_MAX = 1 << 40  # bytes


class WgmmaPlan(NamedTuple):
    """What ``vr_conv3x3_wgmma`` encodes and launches: x's 4-D tensor map
    over (channels, W, H, B) (dims, the byte strides of dims 1-3, the box:
    KC channels of a (TH + 2) x (TW + 2) window, in the ``a_swizzle``-byte
    swizzle, KC * 2 bytes), w's 3-D map over (cout, cin, 9) (a box of one
    stage's KC input channels of every tap, in the ``w_swizzle``-byte
    swizzle), the persistent grid, the tile it assumes, and the tail: its
    number of KC-channel blocks whose channels follow x's, the byte strides
    of its 5-D map over (KC, W, H, B, blocks) and that map's box (zeros
    without a tail)."""

    a_dims: Tuple[int, int, int, int]
    a_strides: Tuple[int, int, int]
    a_box: Tuple[int, int, int, int]
    a_swizzle: int
    w_dims: Tuple[int, int, int]
    w_strides: Tuple[int, int]
    w_box: Tuple[int, int, int]
    w_swizzle: int
    grid: int
    tiles: int
    tile: Tuple[int, int]
    tail: int
    t_strides: Tuple[int, int, int, int]
    t_box: Tuple[int, int, int, int, int]

    def array(self) -> ctypes.Array:
        """The plan as the C launcher reads it (34 int64 values)."""
        vals = (*self.a_dims, *self.a_strides, *self.a_box, self.a_swizzle, *self.w_dims,
                *self.w_strides, *self.w_box, self.w_swizzle, self.grid, *self.tile,
                self.tail, *self.t_strides, *self.t_box)
        return (ctypes.c_longlong * len(vals))(*vals)


def wgmma_plan(
    shape: Sequence[int], xs: int, cout: int, *, sms: int, tail: int = 0,
    tile: Tuple[int, int] = WGMMA_TILE, per_sm: int = WGMMA_PER_SM, kc: int = WGMMA_KC,
    upsample2: bool = False,
) -> WgmmaPlan:
    """The ``"wgmma"`` route's tensor maps and grid for a bf16 call: a pure
    function of x's shape (B, H, W, cin), its pixel stride ``xs`` in
    elements (a channel-prefix view of a wider buffer has xs > cin), cout,
    the card's SM count, the blocks of a ``tail`` (a contiguous (tail, B,
    H, W, kc) tensor whose channels follow x's: the conv reads cin + tail
    kc channels) and the build's tile (rows, pixels), blocks per SM and
    channels a stage ``kc`` (a last stage past cin reads the maps' zero
    fill). ``upsample2``: x is read through nearest 2x, so the tiles cover
    the (2H, 2W) output; x's map is then only checked by the launcher (its
    producer copies the windows itself), and there is no tail. Raises
    ValueError for a call TMA cannot describe: a pixel stride
    that is not a multiple of 8 elements (16 bytes), cin not a multiple of
    16, cout other than 32 or 64, a box or stride over TMA's limits."""
    bsz, h, w, cin = (int(v) for v in shape)
    th, tw = tile
    if min(bsz, h, w, cin) <= 0:
        raise ValueError(f"wgmma_plan: empty shape {tuple(shape)}")
    if xs % 8:
        raise ValueError(f"wgmma_plan: pixel stride {xs} is not a multiple of 8 elements")
    if xs < cin:
        raise ValueError(f"wgmma_plan: pixel stride {xs} < cin {cin}")
    if cin % 16 or cout not in _MMA_COUT:
        raise ValueError(f"wgmma_plan: cin {cin} (a multiple of 16), cout {cout} (32 or 64)")
    if tail and cin % kc:
        raise ValueError(f"wgmma_plan: a tail follows whole stages of x: cin {cin}, kc {kc}")
    if tail and upsample2:
        raise ValueError("wgmma_plan: no tail is read through nearest 2x")
    e = 2  # bf16
    a_strides = (xs * e, w * xs * e, h * w * xs * e)
    a_box = (kc, tw + 2, th + 2, 1)
    cin_all = cin + tail * kc
    w_strides = (cout * e, cin_all * cout * e)
    w_box = (cout, kc, 9)
    t_strides = (kc * e, w * kc * e, h * w * kc * e, bsz * h * w * kc * e) if tail else (0,) * 4
    t_box = (kc, tw + 2, th + 2, 1, 1) if tail else (0,) * 5
    if max(a_box + w_box) > _TMA_BOX_MAX:
        raise ValueError(f"wgmma_plan: a box over {_TMA_BOX_MAX} elements")
    for st in a_strides + w_strides + t_strides[: 4 if tail else 0]:
        if st % 16 or st >= _TMA_STRIDE_MAX:
            raise ValueError(f"wgmma_plan: byte stride {st} (a multiple of 16, < 2^40)")
    up = 2 if upsample2 else 1
    tiles = bsz * -(-up * h // th) * -(-up * w // tw)
    return WgmmaPlan(
        a_dims=(cin, w, h, bsz), a_strides=a_strides, a_box=a_box, a_swizzle=kc * e,
        w_dims=(cout, cin_all, 9), w_strides=w_strides, w_box=w_box,
        w_swizzle=cout * e, grid=min(tiles, sms * per_sm), tiles=tiles, tile=(th, tw),
        tail=tail, t_strides=t_strides, t_box=t_box,
    )


def wgmma_call_plan(
    x: torch.Tensor, w: torch.Tensor, x_tail: Optional[torch.Tensor] = None, **kw
) -> WgmmaPlan:
    """:func:`wgmma_plan` of one call's x (a tensor or a channel-prefix view
    of a wider NHWC buffer), tail and HWIO weights; ``kw`` as there."""
    tail = 0 if x_tail is None else x_tail.shape[0]
    return wgmma_plan(x.shape, _pixel_stride(x, "x"), w.shape[-1], tail=tail, **kw)


def split3(t: torch.Tensor) -> torch.Tensor:
    """The three bf16 parts of an fp32 tensor, stacked on a new first axis
    (contiguous): ``t0 = bf16(t)``, ``t1 = bf16(t - t0)``, ``t2 = bf16(t -
    t0 - t1)``, so that ``t0 + t1 + t2 == t`` exactly (each difference is
    exact in fp32, and bf16 has fp32's exponent range). Of HWIO weights it
    is the (3, 3, 3, cin, cout) tensor the ``"bf16x3"`` kernel reads
    (:func:`weight_parts` keeps it)."""
    t = t.float()
    p0 = t.to(torch.bfloat16)
    r = t - p0.float()
    p1 = r.to(torch.bfloat16)
    p2 = (r - p1.float()).to(torch.bfloat16)
    return torch.stack([p0, p1, p2]).contiguous()


# weight -> {(layout, offset, shape, strides, address, version): its split3
# parts}; keyed on the tensor that owns the storage, so that a view taken
# anew at every call (an SRVGG body conv's w[i]) finds the parts of the last
# one
_PARTS = WeakIdKeyDictionary()


def _parts(w: torch.Tensor, k_major: bool) -> torch.Tensor:
    p = split3(w)
    return p.transpose(-1, -2).contiguous() if k_major else p


def weight_parts(w: torch.Tensor, k_major: bool = False) -> torch.Tensor:
    """:func:`split3` of K1 weights, split once: kept beside the tensor
    that owns ``w``'s storage for as long as that tensor lives, and split
    again when ``w`` was written in place (its version counter moved) or
    now lies elsewhere. An inference-mode tensor has no version counter,
    so its parts are split at every call. ``k_major``: the parts with
    their last two axes swapped, (3, 3, 3, cout, cin) contiguous, the
    K-major B operand that K3's ``"bf16x3"`` kernel reads
    (``ops/srvgg.py``), kept beside the N-major ones."""
    if w.is_inference():
        return _parts(w, k_major)
    base = w if w._base is None else w._base
    key = (bool(k_major), w.storage_offset(), tuple(w.shape), w.stride(), w.data_ptr(),
           w._version)
    kept = _PARTS.get(base)
    if kept is None or key not in kept:
        kept = _PARTS[base] = {k: v for k, v in (kept or {}).items() if k[:4] != key[:4]}
        kept[key] = _parts(w, k_major)
    return kept[key]


# conv3x3_bf16x3_wgmma.cu as shipped: tile rows at cout 32 and 64, pixels of
# a tile row, input channels a stage (the build reports its own:
# vr_conv3x3_bf16x3_config)
BF16X3 = dict(th32=8, th64=4, tw=64, kc=16)
_BF16X3_STAGES = 2  # stages of split windows and their weights: a third cannot fit


def bf16x3_smem(cout: int, th: int, kc: int = 16, tw: int = 64) -> int:
    """Dynamic shared memory bytes of a block of
    ``conv3x3_bf16x3_wgmma.cu`` at ``cout`` with ``th``-row tiles: 1024
    bytes of alignment, two stages of the three weight parts (9 taps x kc
    x cout bf16 each) and the three window parts ((th + 2) x (tw + 2)
    pixels of kc bf16, each part on 1024 bytes), one raw fp32 window, then
    the barriers."""
    ph, pw = th + 2, tw + 2
    w_part = 9 * kc * cout * 2
    a_part = -(-ph * pw * kc * 2 // 1024) * 1024
    raw = ph * pw * kc * 4
    stages = _BF16X3_STAGES
    return 1024 + stages * (3 * w_part + 3 * a_part) + raw + (2 * stages + 1) * 8


class Bf16x3Plan(NamedTuple):
    """What ``vr_conv3x3_bf16x3`` encodes and launches: x's fp32 4-D tensor
    map over (channels, W, H, B) (dims, the byte strides of dims 1-3, the
    box: kc channels of a (TH + 2) x (TW + 2) window, no swizzle), the split
    weights' bf16 4-D map over (cout, cin, 9, 3) (a box of one stage's kc
    input channels of every tap of the three parts, in the ``w_swizzle``-byte
    swizzle), the persistent grid, the tile and the block's shared memory;
    ``tiles`` is kept for the checks and not sent."""

    a_dims: Tuple[int, int, int, int]
    a_strides: Tuple[int, int, int]
    a_box: Tuple[int, int, int, int]
    w_dims: Tuple[int, int, int, int]
    w_strides: Tuple[int, int, int]
    w_box: Tuple[int, int, int, int]
    w_swizzle: int
    grid: int
    tiles: int
    tile: Tuple[int, int]
    smem: int

    def array(self) -> ctypes.Array:
        """The plan as the C launcher reads it (27 int64 values)."""
        vals = (*self.a_dims, *self.a_strides, *self.a_box, *self.w_dims, *self.w_strides,
                *self.w_box, self.w_swizzle, self.grid, *self.tile, self.smem)
        return (ctypes.c_longlong * len(vals))(*vals)


def bf16x3_plan(
    shape: Sequence[int], xs: int, cout: int, *, sms: int, upsample2: bool = False,
    geometry: Optional[dict] = None,
) -> Bf16x3Plan:
    """The ``"bf16x3"`` route's tensor maps, grid and shared memory for an
    fp32 call: a pure function of x's shape (B, H, W, cin), its pixel stride
    ``xs`` in elements (a channel-prefix view of a wider buffer has xs >
    cin), cout, the card's SM count and the build's ``geometry``
    (:data:`BF16X3`, or :func:`bf16x3_geometry` of a loaded build): tiles of
    ``th32`` rows at cout 32 and ``th64`` at cout 64, ``tw`` pixels wide.
    ``upsample2``: x is read through nearest 2x, so the tiles cover the (2H,
    2W) output; x's map is then only checked by the launcher (the producer
    copies the windows itself). Raises ValueError for a call the kernel
    cannot take: an empty shape, a pixel stride that is not a multiple of 4
    elements (16 bytes) or is below cin, cin not a multiple of 16, cout
    other than 32 or 64, a box or stride over TMA's limits."""
    g = dict(BF16X3 if geometry is None else geometry)
    bsz, h, w, cin = (int(v) for v in shape)
    kc, tw = g["kc"], g["tw"]
    if min(bsz, h, w, cin) <= 0:
        raise ValueError(f"bf16x3_plan: empty shape {tuple(shape)}")
    if xs % 4:
        raise ValueError(f"bf16x3_plan: pixel stride {xs} is not a multiple of 4 elements")
    if xs < cin:
        raise ValueError(f"bf16x3_plan: pixel stride {xs} < cin {cin}")
    if cin % kc or cout not in _MMA_COUT:
        raise ValueError(f"bf16x3_plan: cin {cin} (a multiple of {kc}), cout {cout} (32 or 64)")
    th = g["th32"] if cout == 32 else g["th64"]
    a_strides = (xs * 4, w * xs * 4, h * w * xs * 4)
    a_box = (kc, tw + 2, th + 2, 1)
    w_strides = (cout * 2, cin * cout * 2, 9 * cin * cout * 2)
    w_box = (cout, kc, 9, 3)
    if max(a_box + w_box) > _TMA_BOX_MAX:
        raise ValueError(f"bf16x3_plan: a box over {_TMA_BOX_MAX} elements")
    for st in a_strides + w_strides:
        if st % 16 or st >= _TMA_STRIDE_MAX:
            raise ValueError(f"bf16x3_plan: byte stride {st} (a multiple of 16, < 2^40)")
    smem = bf16x3_smem(cout, th, kc, tw)
    if smem > SMEM_MAX:
        raise ValueError(f"bf16x3_plan: shared memory {smem} B over {SMEM_MAX}")
    up = 2 if upsample2 else 1
    tiles = bsz * -(-up * h // th) * -(-up * w // tw)
    return Bf16x3Plan(
        a_dims=(cin, w, h, bsz), a_strides=a_strides, a_box=a_box,
        w_dims=(cout, cin, 9, 3), w_strides=w_strides, w_box=w_box, w_swizzle=cout * 2,
        grid=min(tiles, sms), tiles=tiles, tile=(th, tw), smem=smem,
    )


def bf16x3_geometry(lib) -> dict:
    """:func:`bf16x3_plan`'s ``geometry`` of a loaded build of
    ``conv3x3_bf16x3_wgmma.cu`` (``vr_conv3x3_bf16x3_config``)."""
    cfg = (ctypes.c_int * 7)()
    lib.vr_conv3x3_bf16x3_config(cfg)
    return dict(th32=cfg[0], th64=cfg[1], tw=cfg[2], kc=cfg[3])


_bf16x3_build: Optional[dict] = None


def _bf16x3_geometry(lib) -> dict:
    """:func:`bf16x3_geometry` of the port's library, read once."""
    global _bf16x3_build
    if _bf16x3_build is None:
        _bf16x3_build = bf16x3_geometry(lib)
    return _bf16x3_build


def bf16x3_call_plan(x: torch.Tensor, w: torch.Tensor, **kw) -> Bf16x3Plan:
    """:func:`bf16x3_plan` of one call's x (a tensor or a channel-prefix
    view of a wider NHWC buffer) and HWIO weights; ``kw`` as there."""
    return bf16x3_plan(x.shape, _pixel_stride(x, "x"), w.shape[-1], **kw)


# conv3x3_narrow.cu's fp32 conv_last as shipped (its launcher refuses a
# plan of another geometry): tile rows and pixels, input channels a stage
# (64 bytes a pixel), box pixels a patch row (the tile's 34 and one more: an
# odd row pitch of 64-byte pixels); one block an SM
LAST32 = dict(th=32, tw=32, cs=16, bw=35)
_LAST32_PLAN_LEN = 14


class Last32Plan(NamedTuple):
    """What ``vr_conv3x3_narrow`` encodes and launches for the fp32
    conv_last: x's fp32 4-D tensor map over (channels, W, H, B) (dims, the
    byte strides of dims 1-3, the box: cs channels, 64 bytes, of bw pixels
    x (th + 2) rows, in the 64-byte swizzle; the map's zero fill outside
    the frame is the SAME padding), the persistent grid and the tile;
    ``tiles`` is kept for the checks and not sent."""

    a_dims: Tuple[int, int, int, int]
    a_strides: Tuple[int, int, int]
    a_box: Tuple[int, int, int, int]
    grid: int
    tiles: int
    tile: Tuple[int, int]

    def array(self) -> ctypes.Array:
        """The plan as the C launcher reads it (14 int64 values)."""
        vals = (*self.a_dims, *self.a_strides, *self.a_box, self.grid, *self.tile)
        return (ctypes.c_longlong * len(vals))(*vals)


def last32_plan(shape: Sequence[int], xs: int, *, sms: int) -> Last32Plan:
    """The fp32 conv_last's tensor map and grid: a pure function of x's
    shape (B, H, W, 64), its pixel stride ``xs`` in elements (a
    channel-prefix view of a wider buffer has xs > 64) and the card's SM
    count. A tile is th x tw output pixels (:data:`LAST32`); a stage copies
    its (th + 2)-row patch from (oy0 - 1, ox0 - 1) on, bw pixels a row, cs
    channels at a time; block b walks tiles b, b + grid, ... in row-major
    order. Raises ValueError for a call the kernel cannot take: an empty
    shape, cin other than 64, a pixel stride that is not a multiple of 4
    elements (16 bytes) or is below cin."""
    bsz, h, w, cin = (int(v) for v in shape)
    th, tw, cs, bw = (LAST32[k] for k in ("th", "tw", "cs", "bw"))
    if min(bsz, h, w, cin) <= 0:
        raise ValueError(f"last32_plan: empty shape {tuple(shape)}")
    if cin != 64:
        raise ValueError(f"last32_plan: cin {cin} (64)")
    if xs % 4:
        raise ValueError(f"last32_plan: pixel stride {xs} is not a multiple of 4 elements")
    if xs < cin:
        raise ValueError(f"last32_plan: pixel stride {xs} < cin {cin}")
    tiles = bsz * -(-h // th) * -(-w // tw)
    return Last32Plan(
        a_dims=(cin, w, h, bsz), a_strides=(xs * 4, w * xs * 4, h * w * xs * 4),
        a_box=(cs, bw, th + 2, 1), grid=min(tiles, sms), tiles=tiles, tile=(th, tw),
    )


def last32_call_plan(x: torch.Tensor, **kw) -> Last32Plan:
    """:func:`last32_plan` of one call's x (a tensor or a channel-prefix
    view of a wider NHWC buffer); ``kw`` as there."""
    return last32_plan(x.shape, _pixel_stride(x, "x"), **kw)


def launch_args(x, w, b, alpha, out, r1, r2, act, upsample2, s1, s2) -> tuple:
    """The arguments every K1 kernel takes but the stream: the operands'
    addresses (None for an absent one), x's shape, cin and cout, the pixel
    strides of x, out, r1 and r2 (0 for an absent one), the act code,
    upsample2, s1 and s2. cin is the weights' (x's, and a tail's after it)."""
    bsz, h, wd, _ = x.shape
    return (
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        alpha.data_ptr() if alpha is not None else None,
        r1.data_ptr() if r1 is not None else None,
        r2.data_ptr() if r2 is not None else None,
        out.data_ptr(),
        bsz, h, wd, w.shape[-2], w.shape[-1], _pixel_stride(x, "x"), _pixel_stride(out, "out"),
        _pixel_stride(r1, "r1") if r1 is not None else 0,
        _pixel_stride(r2, "r2") if r2 is not None else 0,
        _ACTS[act], int(upsample2), float(s1), float(s2),
    )


_wgmma_build: Optional[dict] = None
_sms: dict = {}


def wgmma_geometry(lib) -> dict:
    """:func:`wgmma_plan`'s ``tile``, ``per_sm`` and ``kc`` of a loaded
    build of ``conv3x3_wgmma.cu`` (``vr_conv3x3_wgmma_config``)."""
    cfg = (ctypes.c_int * 11)()
    lib.vr_conv3x3_wgmma_config(cfg)
    return dict(tile=(cfg[0], cfg[1]), per_sm=cfg[3], kc=cfg[7])


def _wgmma_geometry(lib) -> dict:
    """:func:`wgmma_geometry` of the port's library, read once."""
    global _wgmma_build
    if _wgmma_build is None:
        _wgmma_build = wgmma_geometry(lib)
    return _wgmma_build


def _sm_count(device: torch.device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device]


def conv3x3_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    act: str = "none",
    alpha: Optional[torch.Tensor] = None,
    upsample2: bool = False,
    out: Optional[torch.Tensor] = None,
    r1: Optional[torch.Tensor] = None,
    s1: float = 1.0,
    r2: Optional[torch.Tensor] = None,
    s2: float = 1.0,
    x_tail: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (same arguments as :func:`conv3x3`):
    fp32 products and sums, fp32 epilogue, one rounding to x's dtype (two
    when ``r2`` is given)."""
    dt = x.dtype
    if x_tail is not None:
        x = torch.cat([x, *x_tail.unbind(0)], dim=-1)
    xi = upsample_nearest(x, 2) if upsample2 else x
    y = conv2d_f32(xi, w)
    del xi
    y += b.float()  # in place: at the 8K tail each fp32 copy is 8.5 GB
    if act == "lrelu":
        y = torch.nn.functional.leaky_relu_(y, 0.2)
    elif act == "prelu":
        y = torch.where(y > 0, y, y * alpha.float())
    if r1 is not None:
        y = r1.float() + s1 * y
    if r2 is not None:
        y = r2.float() + s2 * y.to(dt).float()
    y = y.to(dt)
    if out is None:
        return y
    out.copy_(y)
    return out


def conv3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    act: str = "none",
    alpha: Optional[torch.Tensor] = None,
    upsample2: bool = False,
    out: Optional[torch.Tensor] = None,
    r1: Optional[torch.Tensor] = None,
    s1: float = 1.0,
    r2: Optional[torch.Tensor] = None,
    s2: float = 1.0,
    x_tail: Optional[torch.Tensor] = None,
    counter: str,
    route: Optional[str] = None,
) -> torch.Tensor:
    """``out = r2 + s2 * (r1 + s1 * act(conv3x3_SAME(x', w) + b))``.

    x: (B, H, W, cin) NHWC, or a channel-prefix view of a wider buffer;
    x' is x, or x read through nearest 2x upsampling (zero padding on the
    2x grid) when ``upsample2``, or x with the channels of ``x_tail`` after
    its own: a contiguous (n, B, H, W, WGMMA_KC) tensor of n blocks, which
    only the ``"wgmma"`` kernel reads (the RDB's c1 .. c4 on that route:
    ``ops/stripe.py``). w: (3, 3, cin, cout) HWIO, cin counting the tail's
    channels; b, alpha:
    (cout,). r1, r2 and ``out`` are NHWC at the output grid, each possibly
    a channel slice of a wider buffer (``out`` is written in place). Every
    tensor has x's dtype (fp32 or bf16); sums are fp32 (the ``"bf16x3"``
    kernel reads the weights' three bf16 parts, :func:`weight_parts`,
    split once a weight). ``counter`` names
    the launch counter the calling wrapper owns; the launch is also counted
    under its route, ``conv3x3:wgmma``, ``conv3x3:bf16x3``, ``conv3x3:mma``,
    ``conv3x3:narrow`` or ``conv3x3:fma``
    (:func:`conv3x3_route`), and a narrow one under its kernel,
    ``conv3x3:narrow stem`` or ``conv3x3:narrow conv_last`` (in fp32 also
    under ``conv3x3:narrow stem:fp32`` or ``conv3x3:narrow conv_last:fp32``).
    ``route``:
    None for :func:`conv3x3_route`'s kernel, or a route forced where its
    kernel takes the call (``"mma"`` takes every call of ``"wgmma"``,
    ``"fma"`` every call: side-by-side timings; :func:`forced_route`)."""
    if x.device.type == "cpu":
        return conv3x3_plain(
            x, w, b, act=act, alpha=alpha, upsample2=upsample2, out=out,
            r1=r1, s1=s1, r2=r2, s2=s2, x_tail=x_tail,
        )
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    dt = x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"conv3x3: dtype {dt} not supported (fp32, bf16)")
    if act not in _ACTS:
        raise ValueError(f"conv3x3: unknown act {act!r}")
    if act == "prelu" and alpha is None:
        raise ValueError("conv3x3: act='prelu' needs alpha (cout,)")
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    if x_tail is not None:
        if (x_tail.dim() != 5 or tuple(x_tail.shape[1:]) != (bsz, h, wd, WGMMA_KC)
                or not x_tail.is_contiguous() or upsample2):
            raise ValueError(
                f"conv3x3: x_tail {tuple(x_tail.shape)} is not (n, {bsz}, {h}, {wd}, "
                f"{WGMMA_KC}) contiguous, or upsample2"
            )
        cin += x_tail.shape[0] * WGMMA_KC
    if tuple(w.shape) != (3, 3, cin, cout):
        raise ValueError(f"conv3x3: weight {tuple(w.shape)} != (3, 3, {cin}, {cout})")
    oh, ow = (2 * h, 2 * wd) if upsample2 else (h, wd)
    if out is None:
        out = torch.empty((bsz, oh, ow, cout), dtype=dt, device=x.device)
    operands = {"x": x, "w": w, "b": b, "out": out}
    for name, t in (("alpha", alpha), ("r1", r1), ("r2", r2), ("x_tail", x_tail)):
        if t is not None:
            operands[name] = t
    for name, t in operands.items():
        if t.device != x.device or t.dtype != dt:
            raise ValueError(
                f"conv3x3: {name} is {t.dtype} on {t.device}, expected "
                f"{dt} on {x.device}"
            )
    for name in ("w", "b", "alpha"):
        if name in operands and not operands[name].is_contiguous():
            raise ValueError(f"conv3x3: {name} must be contiguous")
    if b.shape != (cout,) or (alpha is not None and alpha.shape != (cout,)):
        raise ValueError("conv3x3: bias/alpha must have shape (cout,)")
    for name in ("out", "r1", "r2"):
        if name in operands and tuple(operands[name].shape) != (bsz, oh, ow, cout):
            raise ValueError(
                f"conv3x3: {name} shape {tuple(operands[name].shape)} != "
                f"{(bsz, oh, ow, cout)}"
            )
    route = _pick_conv_route(x, w, b, alpha, out, r1, r2, upsample2, route)
    if x_tail is not None and route != "wgmma":
        raise ValueError(f"conv3x3: x_tail is read by the wgmma kernel only, not {route}")
    lib = _build.load()
    args = launch_args(x, w, b, alpha, out, r1, r2, act, upsample2, s1, s2) + (
        _build.stream_ptr(x),
    )
    # the kernel sizes its grid and raises its shared-memory limit on the
    # current device: make it x's
    with torch.cuda.device(x.device):
        if route == "wgmma":
            plan = wgmma_call_plan(x, w, x_tail, sms=_sm_count(x.device), upsample2=upsample2,
                                   **_wgmma_geometry(lib)).array()
            code = lib.vr_conv3x3_wgmma(
                *args, plan, len(plan), None if x_tail is None else x_tail.data_ptr()
            )
        elif route == "bf16x3":
            plan = bf16x3_call_plan(x, w, sms=_sm_count(x.device), upsample2=upsample2,
                                    geometry=_bf16x3_geometry(lib)).array()
            code = lib.vr_conv3x3_bf16x3(
                *launch_args(x, weight_parts(w), b, alpha, out, r1, r2, act, upsample2, s1,
                             s2),
                _build.stream_ptr(x), plan, len(plan),
            )
        elif route == "mma":
            code = lib.vr_conv3x3_mma(*args)
        elif route == "narrow":
            plan = None
            if dt == torch.float32 and cout == 3:  # conv_last: its TMA map
                plan = last32_call_plan(x, sms=_sm_count(x.device)).array()
            code = lib.vr_conv3x3_narrow(_DTYPES[dt], *args, plan,
                                         0 if plan is None else len(plan))
        else:
            code = lib.vr_conv3x3(_DTYPES[dt], *args)
    _build.check(lib, code, f"conv3x3 kernel ({route})")
    _build.count_launch(counter)
    _build.count_launch(f"conv3x3:{route}")
    if route == "narrow":
        kind = "conv3x3:narrow " + ("conv_last" if cout == 3 else "stem")
        _build.count_launch(kind)
        if dt == torch.float32:
            _build.count_launch(kind + ":fp32")
    return out


def conv3x3_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    res: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
    *,
    act: str = "none",
) -> torch.Tensor:
    """``act(conv2d(x, w, b)) + res`` (``pallas_tail.py:767``): the stem
    and ``conv_body`` + the long residual. One K1 launch."""
    return conv3x3(
        x, w, b, act=act, alpha=alpha, r1=res, counter="conv3x3_fused"
    )


def conv3x3_fused_plain(x, w, b, res=None, alpha=None, *, act="none"):
    return conv3x3_plain(x, w, b, act=act, alpha=alpha, r1=res)


def up1_fused(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``leaky_relu(conv2d(upsample_nearest(x, 2), w, b))``: (B, H, W, nf)
    -> (B, 2H, 2W, nf) (``pallas_tail.py:603``). One K1 launch."""
    return conv3x3(x, w, b, act="lrelu", upsample2=True, counter="up1_fused")


def up1_fused_plain(x, w, b):
    return conv3x3_plain(x, w, b, act="lrelu", upsample2=True)


# tail_fused_wgmma.cu as shipped: output rows a step (consumer warpgroups),
# output columns of a stripe, pixels of an x ring row, coarse x, u2 and hr
# rows held, weight slots, dynamic shared memory a block, threads a block
# (the build reports its own: vr_tail_fused_wgmma_config)
TAIL_WGMMA = dict(step_rows=3, stripe=60, ring_px=72, x_rows=5, u2_rows=5, hr_rows=6, slots=3,
                  smem=206960, threads=512)
TAIL_MIN_ROWS = 32  # the fewest rows a block of the persistent grid takes
SMEM_MAX = 232448  # dynamic shared memory a block can have on the H100
_TAIL_SLOT = 18432  # bytes of a weight stage: 16 cin x 9 taps x 64 cout, bf16


def tail_hr_row(stripe: int) -> int:
    """Bytes of an hr ring row of ``tail_fused_wgmma.cu``: its even pixels
    (144 bytes each), then, from an offset of 64 mod 128 bytes (16 banks
    on), its odd ones."""
    px = stripe + 2
    return (-(-px // 2) * 144 + 64 + 127) // 128 * 128 - 64 + px // 2 * 144


def tail_smem(step_rows: int, stripe: int, slots: int) -> int:
    """Dynamic shared memory of a block of ``tail_fused_wgmma.cu``: 1024
    bytes of alignment, the weight slots, the x ring (R + 2 rows of two
    32-channel planes of the stripe's SW + 6 fine pixels, whole 8-pixel
    atoms), the u2 ring (R + 2 rows of 64 pixels, two planes), the hr ring
    (R + 3 rows of :func:`tail_hr_row` bytes: the SW + 2 pixels conv_last
    reads, 144 bytes each), conv_last's fp32 weights, the biases, the slots'
    barriers and the hr ring's two."""
    r = step_rows
    ring_px = (stripe + 6 + 7) // 8 * 8
    return (1024 + slots * _TAIL_SLOT + (r + 2) * 2 * ring_px * 64 + (r + 2) * 2 * 64 * 64
            + (r + 3) * tail_hr_row(stripe) + 9 * 64 * 16 + 2 * 64 * 2 + 16
            + (2 * slots + 2) * 8)


def _block_rows(plan, block: int) -> Tuple[int, int]:
    """Block ``block``'s run [r0, r1) of a tail plan's concatenated
    stripes' rows."""
    return plan.rows * block // plan.grid, plan.rows * (block + 1) // plan.grid


def _stripe_segments(plan, block: int) -> Iterator[Tuple[int, int, int, int]]:
    """Block ``block``'s segments of a tail plan, in its order: (image, the
    stripe's first output column, first row, end row), as the kernels walk
    them."""
    oh = plan.frame[1]
    r, r1 = _block_rows(plan, block)
    while r < r1:
        idx, y0 = divmod(r, oh)
        n = min(oh - y0, r1 - r)
        yield idx // plan.stripes, (idx % plan.stripes) * plan.stripe, y0, y0 + n
        r += n


class TailWgmmaPlan(NamedTuple):
    """What ``vr_tail_fused_wgmma`` checks, encodes and launches: the
    build's geometry as the plan assumed it (rows a step, stripe columns, x
    ring pixels, x, u2 and hr rows held, weight slots, shared memory), the
    persistent grid, the stripes and the rows the blocks share (B x stripes
    x OH, cut into ``grid`` runs), the weight maps' box (64 couts x 16 input
    channels x 9 taps) and swizzle, the threads a block; ``frame`` (B, OH,
    OW) is the output's, kept for :meth:`segments` and not sent."""

    step_rows: int
    stripe: int
    ring_px: int
    x_rows: int
    u2_rows: int
    hr_rows: int
    slots: int
    smem: int
    grid: int
    stripes: int
    rows: int
    w_box: Tuple[int, int, int]
    w_swizzle: int
    threads: int
    frame: Tuple[int, int, int]

    def array(self) -> ctypes.Array:
        """The plan as the C launcher reads it (16 int64 values)."""
        vals = (self.step_rows, self.stripe, self.ring_px, self.x_rows, self.u2_rows,
                self.hr_rows, self.slots, self.smem, self.grid, self.stripes, self.rows,
                *self.w_box, self.w_swizzle, self.threads)
        return (ctypes.c_longlong * len(vals))(*vals)

    block_rows = _block_rows
    segments = _stripe_segments

    def steps(self, seg_rows: int) -> int:
        """Steps of a segment of ``seg_rows`` output rows: until conv_last,
        three rows behind upconv2's, has written the last."""
        r = self.step_rows
        return (seg_rows + r + 4) // r

    def executed_ops(self, nf: int = 64) -> int:
        """Operations (2 per MAC) the kernel's two wide convs execute: 64
        pixels of every row each computes, the stripes' recomputed columns
        and each segment's fill rows included."""
        per_row = 2 * 2 * 64 * 9 * nf * nf
        return sum(self.step_rows * self.steps(y1 - y0) * per_row
                   for blk in range(self.grid) for _, _, y0, y1 in self.segments(blk))


def tail_wgmma_plan(b: int, h2: int, w2: int, geometry: Optional[dict] = None, *,
                    sms: int = 132) -> TailWgmmaPlan:
    """The ``"wgmma"`` tail's plan for x of shape (b, h2, w2, 64) (the
    output is (b, 2 h2, 2 w2, 3)): a pure function of the shape, the build's
    ``geometry`` (:data:`TAIL_WGMMA`, or :func:`tail_geometry` of a loaded
    build) and the card's SM count. Stripes of the build's output columns
    (60 as shipped), B x stripes x OH rows cut into one run a block (at
    least :data:`TAIL_MIN_ROWS` rows, at most one block an SM). Raises
    ValueError for what the kernel cannot take: an empty shape, a frame of
    2^30 rows or columns or more, a geometry whose rings or shared memory
    are not its own or exceed the card's."""
    g = dict(TAIL_WGMMA if geometry is None else geometry)
    b, h2, w2 = int(b), int(h2), int(w2)
    if min(b, h2, w2) <= 0:
        raise ValueError(f"tail_wgmma_plan: empty shape {(b, h2, w2)}")
    if max(h2, w2) > 1 << 29:
        raise ValueError(f"tail_wgmma_plan: a frame of {(2 * h2, 2 * w2)} is 2^30 or more")
    r, sw = g["step_rows"], g["stripe"]
    want = dict(x_rows=r + 2, u2_rows=r + 2, hr_rows=r + 3, threads=128 * r + 128,
                ring_px=(sw + 6 + 7) // 8 * 8)
    if any(g[k] != v for k, v in want.items()) or sw % 2 or sw + 4 > 64 or not 1 <= r <= 3:
        raise ValueError(f"tail_wgmma_plan: geometry {g} is not its own ({want}; an even "
                         f"stripe of at most 60 columns, 1-3 rows a step)")
    smem = tail_smem(r, sw, g["slots"])
    if smem != g["smem"] or smem > SMEM_MAX:
        raise ValueError(f"tail_wgmma_plan: shared memory {smem} B (the build: {g['smem']} B, "
                         f"the card: at most {SMEM_MAX} B)")
    oh, ow = 2 * h2, 2 * w2
    stripes = -(-ow // sw)
    rows = b * stripes * oh
    grid = max(1, min(sms, -(-rows // TAIL_MIN_ROWS)))
    return TailWgmmaPlan(
        step_rows=r, stripe=sw, ring_px=g["ring_px"], x_rows=g["x_rows"], u2_rows=g["u2_rows"],
        hr_rows=g["hr_rows"], slots=g["slots"], smem=smem, grid=grid, stripes=stripes,
        rows=rows, w_box=(64, 16, 9), w_swizzle=128, threads=g["threads"], frame=(b, oh, ow),
    )


def tail_geometry(lib) -> dict:
    """:func:`tail_wgmma_plan`'s ``geometry`` of a loaded build of
    ``tail_fused_wgmma.cu`` (``vr_tail_fused_wgmma_config``)."""
    cfg = (ctypes.c_int * 9)()
    lib.vr_tail_fused_wgmma_config(cfg)
    return dict(step_rows=cfg[0], stripe=cfg[1], ring_px=cfg[2], x_rows=cfg[3],
                u2_rows=cfg[4], hr_rows=cfg[5], slots=cfg[6], smem=cfg[7], threads=cfg[8])


_tail_build: Optional[dict] = None


def _tail_plan(x: torch.Tensor, lib) -> TailWgmmaPlan:
    """:func:`tail_wgmma_plan` of a call, for the port's library (its
    geometry read once)."""
    global _tail_build
    if _tail_build is None:
        _tail_build = tail_geometry(lib)
    b, h2, w2, _ = x.shape
    return tail_wgmma_plan(b, h2, w2, _tail_build, sms=_sm_count(x.device))


def tail_fused(
    x: torch.Tensor,
    w_up2: torch.Tensor,
    b_up2: torch.Tensor,
    w_hr: torch.Tensor,
    b_hr: torch.Tensor,
    w_last: torch.Tensor,
    b_last: torch.Tensor,
    *,
    route: Optional[str] = None,
) -> torch.Tensor:
    """(B, H2, W2, nf) -> (B, 2 H2, 2 W2, 3): equivalent to::

        f = leaky_relu(conv2d(upsample_nearest(x, 2), w_up2, b_up2))
        f = leaky_relu(conv2d(f, w_hr, b_hr))
        return conv2d(f, w_last, b_last)

    (``pallas_tail.py:266`` / ``:425``). ``"wgmma"`` (:func:`tail_fused_route`:
    bf16 at nf 64, aligned contiguous operands) is one launch of
    ``csrc/tail_fused_wgmma.cu`` on a CUDA tensor, both intermediates on
    chip, counted under ``tail_fused`` and ``tail_fused:wgmma``; any other
    call, or ``route="chain"`` (forced, a side-by-side run), is three K1
    calls whose 64-channel intermediates go through device memory, each
    counted under ``tail_fused`` and its K1 route (:func:`chain_route`). On
    the CPU the one launch is the plain version, and each K1 call its
    own."""
    ops = (x, w_up2, b_up2, w_hr, b_hr, w_last, b_last)
    one = chain_route(*ops, route=route)
    if one != "chain":
        if x.device.type == "cpu":
            return tail_fused_plain(*ops)
        return _tail_wgmma(*ops, counter="tail_fused")
    f = conv3x3(x, w_up2, b_up2, act="lrelu", upsample2=True, counter="tail_fused")
    f = conv3x3(f, w_hr, b_hr, act="lrelu", counter="tail_fused")
    return conv3x3(f, w_last, b_last, counter="tail_fused")


def default_tail_route(dtype: torch.dtype, nf: int, aligned: bool = True) -> str:
    """The route of the default tail (:func:`tail_fused`) for a call of
    ``dtype`` at ``nf``: :func:`tail_fused_route`'s where it is one of
    :data:`DEFAULT_ONE_LAUNCH` (one launch, both intermediates on chip),
    else ``"chain"`` (three K1 calls, both intermediates in device
    memory)."""
    own = tail_fused_route(dtype, nf, aligned)
    return own if own in DEFAULT_ONE_LAUNCH else "chain"


def chain_route(x, w_up2, b_up2, w_hr, b_hr, w_last=None, b_last=None, *,
                route: Optional[str] = None) -> str:
    """The route of a :func:`tail_fused` call: :func:`default_tail_route`
    of its operands (``"wgmma"``, one launch, or ``"chain"``, three K1
    calls); or the forced ``route`` (:func:`forced_route` with
    :data:`CHAIN_ROUTES`: ``"chain"`` takes every call)."""
    own = default_tail_route(x.dtype, x.shape[-1],
                             _tail_aligned(x, w_up2, b_up2, w_hr, b_hr, w_last, b_last))
    return forced_route("tail_fused", own, route, _TAIL_TAKES.get(route, ""),
                        routes=CHAIN_ROUTES)


def tail_fused_plain(x, w_up2, b_up2, w_hr, b_hr, w_last, b_last):
    f = conv3x3_plain(x, w_up2, b_up2, act="lrelu", upsample2=True)
    f = conv3x3_plain(f, w_hr, b_hr, act="lrelu")
    return conv3x3_plain(f, w_last, b_last)


def tail_fused_route(dtype: torch.dtype, nf: int, aligned: bool = True) -> str:
    """Which kernel a one-launch tail call on a CUDA tensor launches: a pure
    function of the call. At nf 64, the width of every RRDBNet of the zoo,
    with ``aligned`` operands (x and the two wide convs' weights and biases
    on 16-byte boundaries, every operand contiguous: :func:`_tail_aligned`),
    ``"wgmma"`` (``csrc/tail_fused_wgmma.cu``: Hopper's tensor cores,
    summing in K1's order) takes bf16 and ``"bf16x3"``
    (``csrc/tail_fused_bf16x3.cu``: the same tensor cores on three bf16
    parts a value, summing as K1's ``"bf16x3"`` route, conv_last as K1's
    ``"narrow"`` and ``"fma"``) takes fp32; ``"fma"`` (K6's ``csrc/tail_fused.cu``: fp32
    FMAs) takes the rest (the narrow nf 16 of the checks) and every forced
    call. K6's ``"mma"`` (``csrc/tail_fused_mma.cu``) takes the calls of
    ``"wgmma"`` when :func:`tail_fused_q`'s caller forces it."""
    if nf == 64 and aligned:
        if dtype == torch.bfloat16:
            return "wgmma"
        if dtype == torch.float32:
            return "bf16x3"
    return "fma"


def _tail_aligned(x, w_up2, b_up2, w_hr, b_hr, w_last=None, b_last=None) -> bool:
    """Whether one call's operands are contiguous, with x and the two wide
    convs' weights and biases on 16-byte boundaries."""
    dense = all(t is None or t.is_contiguous() for t in (x, w_up2, b_up2, w_hr, b_hr, w_last, b_last))
    return dense and operands_aligned(x, w_up2, b_up2, w_hr, b_hr)


def _tail_own_route(x, w_up2, b_up2, w_hr, b_hr, w_last=None, b_last=None) -> str:
    """:func:`tail_fused_route` of one call's operands."""
    return tail_fused_route(
        x.dtype, x.shape[-1], _tail_aligned(x, w_up2, b_up2, w_hr, b_hr, w_last, b_last)
    )


def _check_tail(name, x, w_up2, b_up2, w_hr, b_hr, w_last, b_last) -> None:
    """Validate a one-launch tail call on a CUDA tensor: fp32 or bf16, nf
    64 or 16, every operand of its shape, contiguous, in x's dtype on x's
    device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    dt = x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"{name}: dtype {dt} not supported (fp32, bf16)")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    bsz, h2, w2, nf = x.shape
    if nf not in (64, 16):
        raise ValueError(f"{name}: nf {nf} not built (64, 16)")
    shapes = {
        "x": (x, (bsz, h2, w2, nf)),
        "w_up2": (w_up2, (3, 3, nf, nf)), "b_up2": (b_up2, (nf,)),
        "w_hr": (w_hr, (3, 3, nf, nf)), "b_hr": (b_hr, (nf,)),
        "w_last": (w_last, (3, 3, nf, 3)), "b_last": (b_last, (3,)),
    }
    for what, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} shape {tuple(t.shape)} != {shape}")
        if t.device != x.device or t.dtype != dt:
            raise ValueError(
                f"{name}: {what} is {t.dtype} on {t.device}, expected {dt} on {x.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def _tail_wgmma(x, w_up2, b_up2, w_hr, b_hr, w_last, b_last, *, counter: str) -> torch.Tensor:
    """One launch of ``csrc/tail_fused_wgmma.cu``, counted under ``counter``
    and ``<counter>:wgmma``."""
    _check_tail(counter, x, w_up2, b_up2, w_hr, b_hr, w_last, b_last)
    bsz, h2, w2, nf = x.shape
    out = torch.empty((bsz, 2 * h2, 2 * w2, 3), dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        plan = _tail_plan(x, lib).array()
        code = lib.vr_tail_fused_wgmma(
            _DTYPES[x.dtype], nf, x.data_ptr(), out.data_ptr(),
            w_up2.data_ptr(), b_up2.data_ptr(), w_hr.data_ptr(), b_hr.data_ptr(),
            w_last.data_ptr(), b_last.data_ptr(), bsz, h2, w2,
            _build.stream_ptr(x), plan, len(plan),
        )
    _build.check(lib, code, f"{counter} kernel (wgmma)")
    _build.count_launch(counter)
    _build.count_launch(f"{counter}:wgmma")
    return out


# tail_fused_bf16x3.cu's constants: output columns of a stripe, weight slots
# (stages of one tap row), threads a block; its launcher refuses a plan that
# does not carry them and its shared memory (tail_x3_smem)
TAIL_X3_STRIPE, TAIL_X3_SLOTS, TAIL_X3_THREADS = 60, 3, 448
_X3_SLOT = 3 * 3 * 16 * 64 * 2  # a weight stage: 3 taps x 3 parts x 16 cin x 64 couts, bf16


def tail_x3_smem() -> int:
    """Dynamic shared memory of a block of ``tail_fused_bf16x3.cu``: 1024
    bytes of alignment, the weight slots, two stages of the three parts of
    upconv2's 3 x 66-pixel window of 16 channels (each part on 256 bytes),
    the u2 ring (3 rows of 4 x 3 planes, a 16-channel stage of one part of
    66 pixels, bf16), the hr ring (3 rows of the stripe + 2 pixels conv_last
    reads, 272 bytes each, fp32), conv_last's fp32 weights (a float4 a tap
    and channel), the biases (64 + 64 + 4 fp32) and 2 slots + 6 barriers."""
    a_part = -(-3 * 66 * 32 // 256) * 256
    slots = TAIL_X3_SLOTS
    return (1024 + slots * _X3_SLOT + 2 * 3 * a_part + 3 * 4 * 3 * 66 * 32
            + 3 * (TAIL_X3_STRIPE + 2) * 272 + 9 * 64 * 16 + (2 * 64 + 4) * 4
            + (2 * slots + 6) * 8)


class TailX3Plan(NamedTuple):
    """What ``vr_tail_fused_bf16x3`` checks, encodes and launches: the
    build's stripe, weight slots, shared memory and threads as the plan
    assumed them, the persistent grid, the stripes and the rows the blocks
    share (B x stripes x OH, cut into ``grid`` runs), the weight boxes (32
    couts x 16 input channels x 3 taps, of each of the three parts);
    ``frame`` (B, OH, OW) is the output's, kept for :meth:`segments` and not
    sent."""

    stripe: int
    slots: int
    smem: int
    threads: int
    grid: int
    stripes: int
    rows: int
    w_box: Tuple[int, int, int]
    frame: Tuple[int, int, int]

    def array(self) -> ctypes.Array:
        """The plan as the C launcher reads it (10 int64 values)."""
        vals = (self.stripe, self.slots, self.smem, self.threads, self.grid, self.stripes,
                self.rows, *self.w_box)
        return (ctypes.c_longlong * len(vals))(*vals)

    block_rows = _block_rows
    segments = _stripe_segments

    @staticmethod
    def steps(seg_rows: int) -> int:
        """Steps of a segment of ``seg_rows`` output rows, one row a step:
        upconv2 from the segment's first row - 2 until conv_last, two rows
        behind it, has written the last."""
        return seg_rows + 4

    def executed_ops(self, nf: int = 64) -> int:
        """Operations (2 per MAC, one product a MAC) the two wide convs
        execute: 64 pixels of every row each computes, the stripes'
        recomputed columns and each segment's fill rows included."""
        per_row = 2 * 2 * 64 * 9 * nf * nf
        return sum(self.steps(y1 - y0) * per_row
                   for blk in range(self.grid) for _, _, y0, y1 in self.segments(blk))


def tail_x3_plan(b: int, h2: int, w2: int, *, sms: int = 132) -> TailX3Plan:
    """The ``"bf16x3"`` tail's plan for fp32 x of shape (b, h2, w2, 64) (the
    output is (b, 2 h2, 2 w2, 3)): a pure function of the shape and the
    card's SM count. Stripes of :data:`TAIL_X3_STRIPE` output columns, B x
    stripes x OH rows cut into one run a block (at least
    :data:`TAIL_MIN_ROWS` rows, at most one block an SM). Raises ValueError
    for what the kernel cannot take: an empty shape, a frame of 2^30 rows
    or columns or more."""
    b, h2, w2 = int(b), int(h2), int(w2)
    if min(b, h2, w2) <= 0:
        raise ValueError(f"tail_x3_plan: empty shape {(b, h2, w2)}")
    if max(h2, w2) > 1 << 29:
        raise ValueError(f"tail_x3_plan: a frame of {(2 * h2, 2 * w2)} is 2^30 or more")
    oh, ow = 2 * h2, 2 * w2
    stripes = -(-ow // TAIL_X3_STRIPE)
    rows = b * stripes * oh
    grid = max(1, min(sms, -(-rows // TAIL_MIN_ROWS)))
    return TailX3Plan(stripe=TAIL_X3_STRIPE, slots=TAIL_X3_SLOTS, smem=tail_x3_smem(),
                      threads=TAIL_X3_THREADS, grid=grid, stripes=stripes, rows=rows,
                      w_box=(32, 16, 3), frame=(b, oh, ow))


def _tail_x3(x, w_up2, b_up2, w_hr, b_hr, w_last, b_last, *, counter: str) -> torch.Tensor:
    """One launch of ``csrc/tail_fused_bf16x3.cu`` (the two wide convs'
    weights as :func:`weight_parts`), counted under ``counter`` and
    ``<counter>:bf16x3``."""
    _check_tail(counter, x, w_up2, b_up2, w_hr, b_hr, w_last, b_last)
    bsz, h2, w2, nf = x.shape
    out = torch.empty((bsz, 2 * h2, 2 * w2, 3), dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        plan = tail_x3_plan(bsz, h2, w2, sms=_sm_count(x.device)).array()
        code = lib.vr_tail_fused_bf16x3(
            nf, x.data_ptr(), out.data_ptr(), weight_parts(w_up2).data_ptr(), b_up2.data_ptr(),
            weight_parts(w_hr).data_ptr(), b_hr.data_ptr(), w_last.data_ptr(), b_last.data_ptr(),
            bsz, h2, w2, _build.stream_ptr(x), plan, len(plan),
        )
    _build.check(lib, code, f"{counter} kernel (bf16x3)")
    _build.count_launch(counter)
    _build.count_launch(f"{counter}:bf16x3")
    return out


def tail_fused_q(
    x: torch.Tensor,
    w_up2: torch.Tensor,
    b_up2: torch.Tensor,
    w_hr: torch.Tensor,
    b_hr: torch.Tensor,
    w_last: torch.Tensor,
    b_last: torch.Tensor,
    *,
    route: Optional[str] = None,
) -> torch.Tensor:
    """:func:`tail_fused` in one launch (``pallas_tail.py:1018``): x (B, H2,
    W2, nf), up1's output, -> (B, 2 H2, 2 W2, 3), with upconv2's and
    conv_hr's outputs kept on chip. One launch on CUDA (fp32 or bf16, nf 64
    or 16, contiguous operands) or an error; the plain version on the CPU.
    ``route``: None for :func:`tail_fused_route`'s kernel, ``"mma"`` to
    force K6's ``mma.sync`` kernel where ``"wgmma"`` takes the call,
    ``"fma"`` to force the fp32-FMA kernel (side-by-side timings). The
    launch is counted under ``tail_fused_q`` and ``tail_fused_q:<route>``."""
    if x.device.type == "cpu":
        return tail_fused_q_plain(x, w_up2, b_up2, w_hr, b_hr, w_last, b_last)
    ops = (x, w_up2, b_up2, w_hr, b_hr, w_last, b_last)
    _check_tail("tail_fused_q", *ops)
    route = _pick_tail_route(x, w_up2, b_up2, w_hr, b_hr, route)
    if route == "wgmma":
        return _tail_wgmma(*ops, counter="tail_fused_q")
    if route == "bf16x3":
        return _tail_x3(*ops, counter="tail_fused_q")
    bsz, h2, w2, nf = x.shape
    out = torch.empty((bsz, 2 * h2, 2 * w2, 3), dtype=x.dtype, device=x.device)
    lib = _build.load()
    fn = lib.vr_tail_fused_mma if route == "mma" else lib.vr_tail_fused
    with torch.cuda.device(x.device):
        code = fn(
            _DTYPES[x.dtype], nf, x.data_ptr(), out.data_ptr(),
            w_up2.data_ptr(), b_up2.data_ptr(), w_hr.data_ptr(), b_hr.data_ptr(),
            w_last.data_ptr(), b_last.data_ptr(), bsz, h2, w2,
            _build.stream_ptr(x),
        )
    _build.check(lib, code, f"tail_fused_q (K6) kernel ({route})")
    _build.count_launch("tail_fused_q")
    _build.count_launch(f"tail_fused_q:{route}")
    return out


def forced_route(
    name: str, own: str, route: Optional[str], takes: str,
    routes: Sequence[str] = PAIR_ROUTES,
) -> str:
    """The route of a call to a wrapper with several kernels: ``own`` (its
    route function's choice), or ``route`` when the caller forces one (a
    side-by-side timing of the kernels). The last of ``routes`` (``"fma"``,
    K4's ``"dp4a"``) takes every call; any other route only where its kernel
    takes the call, which is where the route function chose it (``takes``
    says what that kernel takes). ``routes``: the wrapper's route names (K1's
    :data:`ROUTES`, K4's ``("mma", "dp4a")``)."""
    if route is None:
        return own
    if route not in routes:
        raise ValueError(f"{name}: unknown route {route!r} (expected one of {tuple(routes)})")
    if route != routes[-1] and route != own:
        raise ValueError(f"{name}: the {route} kernel takes {takes} only")
    return route


def _pick_conv_route(x, w, b, alpha, out, r1, r2, upsample2, route: Optional[str]) -> str:
    """The route of a K1 call: :func:`conv3x3_call_route` of its operands,
    or the forced ``route`` (:func:`forced_route` with K1's :data:`ROUTES`;
    ``"mma"`` also where the call's own route is ``"wgmma"``: the
    ``mma.sync`` kernel takes every such call)."""
    own = conv3x3_call_route(x, w, b, alpha, out, r1, r2, upsample2)
    if route == "mma" and own == "wgmma":
        return "mma"
    return forced_route("conv3x3", own, route, _K1_TAKES.get(route, ""), routes=ROUTES)


def _pick_tail_route(x, w_up2, b_up2, w_hr, b_hr, route: Optional[str]) -> str:
    """The route of a one-launch tail call: :func:`tail_fused_route` of its
    operands, or the forced ``route`` (:func:`forced_route` with
    :data:`TAIL_ROUTES`; ``"mma"`` also where the call's own route is
    ``"wgmma"``: K6's ``mma.sync`` kernel takes every such call)."""
    own = _tail_own_route(x, w_up2, b_up2, w_hr, b_hr)
    if route == "mma" and own == "wgmma":
        return "mma"
    return forced_route("tail_fused_q", own, route, _TAIL_TAKES.get(route, ""),
                        routes=TAIL_ROUTES)


# the same function with the same rounding points: both intermediates in the
# activation dtype, SAME zero padding at the frame edge of each conv
tail_fused_q_plain = tail_fused_plain
