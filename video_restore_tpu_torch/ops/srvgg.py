"""The SRVGGNetCompact body and upsampler on kernels K1 and K3.

Port of ``video_restore_tpu/ops/pallas_srvgg.py``:

- :func:`srvgg_body` replaces the chained conv3x3 + PReLU body kernels
  ``srvgg_stripe2d_split`` (``:635``), ``srvgg_stripe2d_padded`` (``:370``,
  the full-frame 2D-blocked forms) and ``srvgg_stripe_padded`` (``:131``,
  the full-width stripe form the tiled path takes). All three compute, per
  conv i, ``h = prelu(conv3x3_SAME(h, w[i]) + b[i], alpha[i])`` with fp32
  sums, bias and PReLU, rounded to the activation dtype between convs
  (``pallas_srvgg.py:101-111``); they differ in TPU layout and launch split
  only. Here: one K1 launch (``ops/tail.py::conv3x3``, ``act="prelu"``;
  ``csrc/conv3x3_wgmma.cu`` at the zoo's widths in bf16,
  ``csrc/conv3x3_bf16x3_wgmma.cu`` in fp32) per conv, whose
  bounds-checked reads give SAME zero padding at every frame and tile
  edge.
- :func:`srvgg_body_i8` is the same body with the W8A8 int8 convs of
  ``--precision int8`` (the ``sws`` argument of the same three entry
  points): one K4 launch (``csrc/conv3x3_i8_wgmma.cu`` on the int8 tensor
  cores at nf 64, ``csrc/conv3x3_i8.cu`` otherwise:
  ``ops/quant.py::conv3x3_i8_route``) per conv, each conv's
  input quantised with its per-image scale, which the launch before wrote
  (the amax kernel for the body's input).
- :func:`srvgg_up_fused` replaces ``srvgg_up_fused_raw`` (``:1025``) and
  ``srvgg_up_fused`` (``:854``): ``pixel_shuffle(conv3x3(feat) + b, r) +
  upsample_nearest(x_in, r)`` in one launch of K3, fp32 until one final
  rounding. K3 is three hand-written kernels of one function, and
  :func:`srvgg_up_route` says which a call takes: ``"mma"``
  (``csrc/srvgg_up_mma.cu``: bf16 ``mma.sync`` on the tile routines of
  ``csrc/mma_tile.cuh``) for bf16 with cin a multiple of 16 up to 64,
  ``"bf16x3"`` (``csrc/srvgg_up_bf16x3.cu``: Hopper's bf16 ``wgmma`` on
  the three bf16 parts of each fp32 value, six products a MAC summed in
  fp32, K1 ``"bf16x3"``'s producer warpgroup; its tensor maps from
  :func:`srvgg_up_x3_plan`) for fp32 at the same widths, ``"fma"``
  (``csrc/srvgg_up.cu``: fp32 FMAs) for the rest and forced calls. The
  tensor-core kernels read cout padded to a multiple of 16 (r 2: 12 -> 16
  zero columns), which :func:`srvgg_up_weights` prepares once; the
  ``"bf16x3"`` kernel reads its split parts K-major
  (``ops/tail.py::weight_parts(k_major=True)``, split once a weight).

Each wrapper has its plain PyTorch version beside it (``*_plain``). A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from video_restore_tpu_torch.ops import _build
from video_restore_tpu_torch.ops.conv import (
    conv2d_f32,
    pixel_shuffle,
    upsample_nearest,
)
from video_restore_tpu_torch.ops.quant import (
    act_amax,
    act_amax_plain,
    conv3x3_i8,
    conv3x3_i8_plain,
)
from video_restore_tpu_torch.ops.tail import (
    _DTYPES,
    _TMA_STRIDE_MAX,
    _sm_count,
    conv3x3,
    conv3x3_plain,
    forced_route,
    weight_parts,
)

UP_SCALES = (2, 4)  # the scales the JAX model sends to its fused upsampler
UP_MMA_MAX_CIN = 64  # the whole patch and weights of a block in shared memory
ROUTES = ("mma", "bf16x3", "fma")  # K3's kernels; "fma" takes every call
_UP_TAKES = {"mma": "bf16 with cin 16..64", "bf16x3": "fp32 with cin 16..64"}


def srvgg_up_route(dtype: torch.dtype, cin: int, r: int) -> str:
    """Which of K3's three kernels a call on a CUDA tensor launches: a pure
    function of the call. The tensor-core widths are cin a multiple of 16
    (one k16 step per 16 input channels) up to :data:`UP_MMA_MAX_CIN`, at a
    scale of :data:`UP_SCALES`: ``"mma"`` takes them in bf16, ``"bf16x3"``
    in fp32; ``"fma"`` takes every other call: widths the tensor-core
    kernels are not built for."""
    if cin % 16 == 0 and 0 < cin <= UP_MMA_MAX_CIN and r in UP_SCALES:
        if dtype == torch.bfloat16:
            return "mma"
        if dtype == torch.float32:
            return "bf16x3"
    return "fma"


def up_width(r: int, colours: int = 3) -> int:
    """conv_out's width as the tensor-core kernels read it: ``colours *
    r^2`` padded to a multiple of 16 (r 4: 48; r 2: 16)."""
    return -(-colours * r * r // 16) * 16


def srvgg_up_weights(w_out: torch.Tensor, r: int) -> torch.Tensor:
    """conv_out's HWIO weight (3, 3, nf, 3 r^2) padded with zero output
    columns to :func:`up_width`, contiguous: what the tensor-core kernels
    read (``"bf16x3"`` its split parts). A pure function, for the model to
    call once; the conv of the padded weight is the conv of ``w_out`` in
    its first 3 r^2 channels."""
    pad = up_width(r, w_out.shape[-1] // (r * r)) - w_out.shape[-1]
    return torch.nn.functional.pad(w_out, (0, pad)).contiguous()


# srvgg_up_bf16x3.cu's geometry: tile rows at r 2 and r 4, pixels of a tile
# row, input channels a stage (the launcher refuses a plan that does not
# match its build: vr_srvgg_up_bf16x3_config)
UP_X3 = dict(th2=8, th4=4, tw=64, kc=16)
UP_X3_PLAN_LEN = 26


def _pad1k(v: int) -> int:
    return -(-v // 1024) * 1024


def srvgg_up_x3_smem(r: int) -> int:
    """Dynamic shared memory bytes of a block of ``srvgg_up_bf16x3.cu`` at
    scale ``r`` (tiles of th rows, tw pixels, kc channels a stage:
    :data:`UP_X3`): 1024 bytes of alignment, two stages (the three weight
    parts, 9 taps x kc x :func:`up_width` bf16 each, then from the next 1024
    bytes the three window parts, (th + 2) x (tw + 2) pixels of kc bf16,
    each on 1024 bytes), one raw fp32 window, the five barriers, then from
    the next 128 bytes each of the 8 consumer warps' staging: r fine rows of
    16 pixels' r x 3 fp32 values."""
    n = up_width(r)
    th = UP_X3["th4"] if r == 4 else UP_X3["th2"]
    kc, tw = UP_X3["kc"], UP_X3["tw"]
    ph, pw = th + 2, tw + 2
    w_part = 9 * kc * n * 2
    stage = _pad1k(3 * w_part) + 3 * _pad1k(ph * pw * kc * 2)
    bars = 2 * stage + ph * pw * kc * 4
    staging = -(-(bars + 5 * 8) // 128) * 128
    return 1024 + staging + 8 * r * 16 * r * 3 * 4


class UpX3Plan(NamedTuple):
    """What ``vr_srvgg_up_bf16x3`` checks, encodes and launches: feat's fp32
    4-D tensor map over (cin, W, H, B) (dims, the byte strides of dims 1-3,
    the box: kc channels of a (TH + 2) x (TW + 2) window, no swizzle), the
    K-major split weights' bf16 4-D map over (cin, N, 9, 3) (a box of one
    stage's kc input channels of every cout, tap and part, in the 32-byte
    swizzle), the persistent grid, the tile and the block's shared memory;
    ``tiles`` is kept for the checks and not sent."""

    a_dims: Tuple[int, int, int, int]
    a_strides: Tuple[int, int, int]
    a_box: Tuple[int, int, int, int]
    w_dims: Tuple[int, int, int, int]
    w_strides: Tuple[int, int, int]
    w_box: Tuple[int, int, int, int]
    grid: int
    tiles: int
    tile: Tuple[int, int]
    smem: int

    def array(self) -> ctypes.Array:
        """The plan as the C launcher reads it (:data:`UP_X3_PLAN_LEN` int64
        values)."""
        vals = (*self.a_dims, *self.a_strides, *self.a_box, *self.w_dims, *self.w_strides,
                *self.w_box, self.grid, *self.tile, self.smem)
        return (ctypes.c_longlong * len(vals))(*vals)


def srvgg_up_x3_plan(shape: Sequence[int], r: int, *, sms: int) -> UpX3Plan:
    """The ``"bf16x3"`` route's tensor maps, grid and shared memory for an
    fp32 upsampler call: a pure function of feat's shape (B, H, W, cin) (a
    contiguous tensor), the scale r and the card's SM count, on
    :data:`UP_X3`'s tiles (``th2`` rows at r 2 and ``th4`` at r 4, ``tw`` LR
    pixels wide, ``kc`` channels a stage). Raises ValueError for a call the
    kernel cannot take: an empty shape, r not in :data:`UP_SCALES`, cin not
    a multiple of kc, 2^31 pixels or more, a byte stride over TMA's limit."""
    bsz, h, w, cin = (int(v) for v in shape)
    kc, tw = UP_X3["kc"], UP_X3["tw"]
    if min(bsz, h, w, cin) <= 0:
        raise ValueError(f"srvgg_up_x3_plan: empty shape {tuple(shape)}")
    if r not in UP_SCALES:
        raise ValueError(f"srvgg_up_x3_plan: r {r} (one of {UP_SCALES})")
    if cin % kc:
        raise ValueError(f"srvgg_up_x3_plan: cin {cin} (a multiple of {kc})")
    if bsz * h * w >= 1 << 31:
        raise ValueError(f"srvgg_up_x3_plan: {bsz * h * w} pixels (fewer than 2^31)")
    n = up_width(r)
    th = UP_X3["th4"] if r == 4 else UP_X3["th2"]
    a_strides = (cin * 4, w * cin * 4, h * w * cin * 4)
    a_box = (kc, tw + 2, th + 2, 1)
    w_strides = (cin * 2, n * cin * 2, 9 * n * cin * 2)
    w_box = (kc, n, 9, 3)
    for st in a_strides + w_strides:
        if st >= _TMA_STRIDE_MAX:
            raise ValueError(f"srvgg_up_x3_plan: byte stride {st} (< 2^40)")
    tiles = bsz * -(-h // th) * -(-w // tw)
    return UpX3Plan(
        a_dims=(cin, w, h, bsz), a_strides=a_strides, a_box=a_box,
        w_dims=(cin, n, 9, 3), w_strides=w_strides, w_box=w_box,
        grid=min(tiles, sms), tiles=tiles, tile=(th, tw), smem=srvgg_up_x3_smem(r),
    )


def _check_body(w, b, alpha):
    if w.dim() != 5 or b.shape != w.shape[:1] + w.shape[-1:] or alpha.shape != b.shape:
        raise ValueError(
            f"srvgg_body: weights {tuple(w.shape)}, biases {tuple(b.shape)}, "
            f"alphas {tuple(alpha.shape)} are not a stack of (3, 3, nf, nf) "
            "convs with (nf,) biases and alphas"
        )


def _body(conv, x, w, b, alpha, **kw):
    _check_body(w, b, alpha)
    for i in range(w.shape[0]):
        x = conv(x, w[i], b[i], act="prelu", alpha=alpha[i], **kw)
    return x


def srvgg_body(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, alpha: torch.Tensor
) -> torch.Tensor:
    """``num_conv`` chained ``prelu(conv3x3(x) + b)``: x (B, H, W, nf), w
    (num_conv, 3, 3, nf, nf) HWIO, b and alpha (num_conv, nf), all in x's
    dtype. One K1 launch per conv on CUDA (fp32 on the ``"bf16x3"``
    route), the plain version on the CPU."""
    return _body(conv3x3, x, w, b, alpha, counter="srvgg_body")


def srvgg_body_plain(x, w, b, alpha):
    return _body(conv3x3_plain, x, w, b, alpha)


def _body_i8(conv, amax_fn, x, wq, sw, b, alpha, wp=None, **kw):
    _check_body(wq, b, alpha)
    n, nf = b.shape
    if tuple(sw.shape) != (n, nf):
        raise ValueError(f"srvgg_body_i8: scales {tuple(sw.shape)} != {(n, nf)}")
    # column i: |max| of conv i's input
    amax = torch.zeros((x.shape[0], n + 1), dtype=torch.float32, device=x.device)
    amax_fn(x, out=amax[:, 0])
    for i in range(n):
        x = conv(
            x, (0, nf), amax[:, i : i + 1], wq[i], sw[i : i + 1], b[i],
            act="prelu", alpha=alpha[i], out_amax=amax[:, i + 1],
            **({} if wp is None else {"wp": wp[i]}), **kw,
        )
    return x


def srvgg_body_i8(
    x: torch.Tensor,
    wq: torch.Tensor,
    sw: torch.Tensor,
    b: torch.Tensor,
    alpha: torch.Tensor,
    wp: Optional[torch.Tensor] = None,
    route: Optional[str] = None,
) -> torch.Tensor:
    """``num_conv`` chained W8A8 ``prelu(conv3x3(x) + b)``: x (B, H, W, nf)
    bf16, wq (num_conv, 3, 3, nf, nf) int8 HWIO, sw (num_conv, nf) fp32
    weight scales, b and alpha (num_conv, nf) in x's dtype; wp (num_conv, 9,
    nf, nf) int8, each conv's weight packed by ``quant.pack_i8_weights``
    for K4's ``"mma"`` route (each conv packs its own when not given; the
    plain version ignores it). One amax-kernel launch and one K4 launch per
    conv on CUDA, the plain version on the CPU. route: None for each conv's
    own K4 route, ``"dp4a"`` to force the ``__dp4a`` kernel."""
    return _body_i8(
        conv3x3_i8, act_amax, x, wq, sw, b, alpha, wp, route=route, counter="srvgg_body_i8"
    )


def srvgg_body_i8_plain(x, wq, sw, b, alpha, wp=None):
    return _body_i8(conv3x3_i8_plain, act_amax_plain, x, wq, sw, b, alpha)


def _check_up(feat, w_out, b_out, x_in, r):
    """Validate the shapes; returns cout (colours). w_out may be conv_out's
    weight (3, 3, nf, cout r^2) or :func:`srvgg_up_weights` of it."""
    if r not in UP_SCALES:
        raise ValueError(f"srvgg_up_fused: r must be one of {UP_SCALES}, got {r}")
    bsz, h, w, nf = feat.shape
    cout = b_out.shape[0] // (r * r) if b_out.dim() == 1 else 0
    if (
        cout < 1 or b_out.shape != (cout * r * r,) or w_out.dim() != 4
        or tuple(w_out.shape[:3]) != (3, 3, nf)
        or w_out.shape[-1] not in (cout * r * r, up_width(r, cout))
    ):
        raise ValueError(
            f"srvgg_up_fused: weight {tuple(w_out.shape)} / bias "
            f"{tuple(b_out.shape)} do not map {nf} channels to cout*r*r"
        )
    if tuple(x_in.shape) != (bsz, h, w, cout):
        raise ValueError(
            f"srvgg_up_fused: x_in {tuple(x_in.shape)} != {(bsz, h, w, cout)}"
        )
    return cout


def srvgg_up_fused_plain(
    feat: torch.Tensor,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    x_in: torch.Tensor,
    r: int = 4,
) -> torch.Tensor:
    """Plain PyTorch version of K3: fp32 conv sums, bias and skip, one
    rounding to feat's dtype. w_out: conv_out's weight or its padded form
    (:func:`srvgg_up_weights`)."""
    _check_up(feat, w_out, b_out, x_in, r)
    y = conv2d_f32(feat, w_out[..., : b_out.shape[0]]) + b_out.float()
    y = pixel_shuffle(y, r) + upsample_nearest(x_in.float(), r)
    return y.to(feat.dtype)


def srvgg_up_fused(
    feat: torch.Tensor,
    w_out: torch.Tensor,
    b_out: torch.Tensor,
    x_in: torch.Tensor,
    r: int = 4,
    *,
    route: Optional[str] = None,
) -> torch.Tensor:
    """``pixel_shuffle(conv2d(feat, w_out, b_out), r) +
    upsample_nearest(x_in, r)``: feat (B, H, W, nf), w_out (3, 3, nf,
    3 r^2) HWIO or its padded form (:func:`srvgg_up_weights`, what a
    prepared model passes), b_out (3 r^2,), x_in (B, H, W, 3) -> (B, rH,
    rW, 3), all in feat's dtype (fp32 or bf16); r in {2, 4}. One K3 launch
    on CUDA, the plain version on the CPU. ``route``: None for
    :func:`srvgg_up_route`'s kernel, ``"fma"`` to force the fp32-FMA kernel
    (a side-by-side timing), or the call's own route. The launch is counted
    under ``srvgg_up_fused`` and ``srvgg_up_fused:<route>``."""
    if feat.device.type == "cpu":
        return srvgg_up_fused_plain(feat, w_out, b_out, x_in, r)
    if feat.device.type != "cuda":
        raise ValueError(f"srvgg_up_fused: unsupported device {feat.device}")
    cout = _check_up(feat, w_out, b_out, x_in, r)
    if cout != 3:
        raise ValueError(f"srvgg_up_fused: K3 writes 3 colours, not {cout}")
    dt = feat.dtype
    if dt not in _DTYPES:
        raise TypeError(f"srvgg_up_fused: dtype {dt} not supported (fp32, bf16)")
    for name, t in (("w_out", w_out), ("b_out", b_out), ("x_in", x_in), ("feat", feat)):
        if t.device != feat.device or t.dtype != dt:
            raise ValueError(
                f"srvgg_up_fused: {name} is {t.dtype} on {t.device}, expected "
                f"{dt} on {feat.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"srvgg_up_fused: {name} must be contiguous")
    bsz, h, w, nf = feat.shape
    route = forced_route("srvgg_up_fused", srvgg_up_route(dt, nf, r), route,
                         _UP_TAKES.get(route, ""), routes=ROUTES)
    # each kernel's weight width: a direct caller's unpadded r-2 weight is
    # padded here, off the model's path
    padded = route in ("mma", "bf16x3")
    width = up_width(r) if padded else 3 * r * r
    if w_out.shape[-1] != width:
        w_out = (srvgg_up_weights(w_out, r) if padded
                 else w_out[..., :width].contiguous())
    out = torch.empty((bsz, r * h, r * w, cout), dtype=dt, device=feat.device)
    lib = _build.load()
    args = (
        r, feat.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
        x_in.data_ptr(), out.data_ptr(), bsz, h, w, nf,
        _build.stream_ptr(feat),
    )
    with torch.cuda.device(feat.device):
        if route == "mma":
            code = lib.vr_srvgg_up_mma(*args)
        elif route == "bf16x3":
            plan = srvgg_up_x3_plan(feat.shape, r, sms=_sm_count(feat.device)).array()
            code = lib.vr_srvgg_up_bf16x3(
                r, feat.data_ptr(), weight_parts(w_out, k_major=True).data_ptr(),
                *args[3:], plan, len(plan),
            )
        else:
            code = lib.vr_srvgg_up(_DTYPES[dt], *args)
    _build.check(lib, code, f"srvgg_up kernel ({route})")
    _build.count_launch("srvgg_up_fused")
    _build.count_launch(f"srvgg_up_fused:{route}")
    return out
