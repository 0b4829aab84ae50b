"""The 3x3 convs around the RRDBNet body, on kernel K1 (``csrc/conv3x3_wgmma.cu``
and ``csrc/conv3x3_mma.cu`` on the tensor cores, ``csrc/conv3x3_narrow.cu``
for the stems and conv_last,
``csrc/conv3x3.cu`` for the rest, both on the CUDA cores), and the
one-launch tail on kernel K6 (``csrc/tail_fused_mma.cu`` on the tensor cores,
``csrc/tail_fused.cu`` on the CUDA cores).

Port of ``video_restore_tpu/ops/pallas_tail.py``:

- :func:`conv3x3_fused` replaces ``conv3x3_fused`` (``pallas_tail.py:767``):
  ``act(conv3x3(x) + b) + res``, the stem and ``conv_body`` + the long
  residual;
- :func:`up1_fused` replaces ``up1_fused`` (``:603``):
  ``lrelu(conv3x3(nearest2x(x)) + b)``, giving a plain (B, 2H, 2W, nf)
  tensor (the port has no raw or masked layout);
- :func:`tail_fused` replaces ``tail_fused_raw`` (``:266``) and
  ``tail_fused`` (``:425``): upconv2 (lrelu, nearest 2x) -> conv_hr (lrelu)
  -> conv_last, three K1 launches with intermediates in the activation
  dtype, as the Pallas tail rounds them (``pallas_tail.py:188-212``);
- :func:`tail_fused_q` replaces ``tail_fused_q`` (``pallas_tail.py:1018``,
  the ``VRT_TAIL_Q=1`` tail): the same function as :func:`tail_fused` in
  one K6 launch that reads up1's output and keeps both 64-channel
  intermediates in shared memory, each zeroed outside the frame and rounded
  to the activation dtype as it is stored (``_tail_q_kernel``'s ``post_u2``
  and ``post_hr``). What is not carried over is the TPU layout: the 4-way
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
one function behind four routes of hand-written kernels, and
:func:`conv3x3_route` says which a call takes: ``"wgmma"``
(``csrc/conv3x3_wgmma.cu``: Hopper's ``wgmma`` on shared-memory operands
that TMA fills, warp-specialised, persistent; its tensor maps from
:func:`wgmma_plan`) for the bf16 convs whose widths feed the tensor cores,
``"mma"`` (``csrc/conv3x3_mma.cu``: bf16 ``mma.sync`` fed by ``ldmatrix``
from shared memory that ``cp.async`` fills) for the same widths read
through nearest 2x (up1, upconv2: TMA copies boxes of the tensor as it
lies, and the 2x grid is not one), and forced beside ``"wgmma"`` for
side-by-side runs, ``"narrow"`` (``csrc/conv3x3_narrow.cu``: fp32 FMAs in
``conv3x3.cu``'s order, one kernel for the bf16 stems, cin 3 or 12 -> 64,
and one for ``conv_last``, 64 -> 3), ``"fma"`` (``csrc/conv3x3.cu``: fp32
FMAs) for the rest: fp32 and the narrow test widths. K6 is two kernels the
same way, chosen by :func:`tail_fused_route`: ``"mma"``
(``csrc/tail_fused_mma.cu``) for bf16 at nf 64, ``"fma"``
(``csrc/tail_fused.cu``) for fp32 and nf 16. The kernel notes (what bounds each kernel on the H100 and what its design does about
it) are at the top of the sources.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from video_restore_tpu_torch.ops import _build
from video_restore_tpu_torch.ops.conv import conv2d_f32, upsample_nearest

_ACTS = {"none": 0, "lrelu": 1, "prelu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

ROUTES = ("wgmma", "mma", "narrow", "fma")  # K1's kernels; "fma" takes every call
PAIR_ROUTES = ("mma", "fma")  # the wrappers with a tensor-core and an fp32-FMA kernel
_MMA_COUT = (32, 64)  # the widths conv3x3_mma.cu and conv3x3_wgmma.cu are built for
# (cin, cout) of conv3x3_narrow.cu's kernels: the stems and conv_last
_NARROW = ((3, 64), (12, 64), (64, 3))
_K1_TAKES = {
    "wgmma": "bf16 with cin a multiple of 16, cout 32 or 64 and aligned operands, "
             "without upsample2",
    "mma": "bf16 with cin a multiple of 16, cout 32 or 64 and aligned operands",
    "narrow": "bf16 stems (cin 3 or 12 -> 64) and conv_last (64 -> 3) without residuals "
              "or upsample2, with operands it can load",
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
    stores); ``"wgmma"`` takes them, and ``"mma"`` takes them read through
    nearest 2x (``upsample2``: up1 and upconv2), which a TMA box cannot
    express; ``"narrow"`` takes bf16 stems (cin 3 or 12 -> cout 64) and
    ``conv_last`` (cin 64 -> cout 3) where ``narrow`` says the rest of the
    call suits it (:func:`narrow_operands`); ``"fma"`` takes every other
    call."""
    if dtype == torch.bfloat16 and cin % 16 == 0 and cout in _MMA_COUT and aligned:
        return "mma" if upsample2 else "wgmma"
    if dtype == torch.bfloat16 and (cin, cout) in _NARROW and narrow:
        return "narrow"
    return "fma"


def operands_aligned(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether every given tensor (None is skipped) starts on a 16-byte
    boundary and, where it is NHWC, has a pixel stride that is a multiple of
    8 elements: what the tensor-core routes' 16-byte copies and TMA boxes
    need."""
    for t in tensors:
        if t is None:
            continue
        if t.data_ptr() % 16:
            return False
        if t.dim() == 4 and t.stride(2) % 8:
            return False
    return True


def narrow_operands(x, cout, out=None, r1=None, r2=None, upsample2=False) -> bool:
    """Whether a call of the narrow widths suits ``"narrow"``'s kernels: no
    residuals and no ``upsample2``; ``conv_last`` (cout 3) reads x 16 bytes
    (8 channels) at a time, so x must be :func:`operands_aligned`; a stem
    writes ``out`` 16 bytes (8 couts) at a time, so ``out`` (None: a fresh
    contiguous tensor) must be, while its x is read 2 bytes at a time at any
    pixel stride (cin 3: 3). Weights, bias and alpha are read 2 bytes at a
    time."""
    if upsample2 or r1 is not None or r2 is not None:
        return False
    return operands_aligned(x if cout == 3 else out)


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
) -> WgmmaPlan:
    """The ``"wgmma"`` route's tensor maps and grid for a bf16 call: a pure
    function of x's shape (B, H, W, cin), its pixel stride ``xs`` in
    elements (a channel-prefix view of a wider buffer has xs > cin), cout,
    the card's SM count, the blocks of a ``tail`` (a contiguous (tail, B,
    H, W, kc) tensor whose channels follow x's: the conv reads cin + tail
    kc channels) and the build's tile (rows, pixels), blocks per SM and
    channels a stage ``kc`` (a last stage past cin reads the maps' zero
    fill). Raises ValueError for a call TMA cannot describe: a pixel stride
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
    tiles = bsz * -(-h // th) * -(-w // tw)
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
    tensor has x's dtype (fp32 or bf16); sums are fp32. ``counter`` names
    the launch counter the calling wrapper owns; the launch is also counted
    under its route, ``conv3x3:wgmma``, ``conv3x3:mma``, ``conv3x3:narrow`` or
    ``conv3x3:fma``
    (:func:`conv3x3_route`), and a narrow one under its kernel,
    ``conv3x3:narrow stem`` or ``conv3x3:narrow conv_last``. ``route``:
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
            plan = wgmma_call_plan(x, w, x_tail, sms=_sm_count(x.device),
                                   **_wgmma_geometry(lib)).array()
            code = lib.vr_conv3x3_wgmma(
                *args, plan, len(plan), None if x_tail is None else x_tail.data_ptr()
            )
        elif route == "mma":
            code = lib.vr_conv3x3_mma(*args)
        elif route == "narrow":
            code = lib.vr_conv3x3_narrow(*args)
        else:
            code = lib.vr_conv3x3(_DTYPES[dt], *args)
    _build.check(lib, code, f"conv3x3 kernel ({route})")
    _build.count_launch(counter)
    _build.count_launch(f"conv3x3:{route}")
    if route == "narrow":
        _build.count_launch("conv3x3:narrow " + ("conv_last" if cout == 3 else "stem"))
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


def tail_fused(
    x: torch.Tensor,
    w_up2: torch.Tensor,
    b_up2: torch.Tensor,
    w_hr: torch.Tensor,
    b_hr: torch.Tensor,
    w_last: torch.Tensor,
    b_last: torch.Tensor,
) -> torch.Tensor:
    """(B, H2, W2, nf) -> (B, 2 H2, 2 W2, 3): equivalent to::

        f = leaky_relu(conv2d(upsample_nearest(x, 2), w_up2, b_up2))
        f = leaky_relu(conv2d(f, w_hr, b_hr))
        return conv2d(f, w_last, b_last)

    (``pallas_tail.py:266`` / ``:425``). Three K1 launches; both
    64-channel intermediates go through device memory."""
    f = conv3x3(x, w_up2, b_up2, act="lrelu", upsample2=True, counter="tail_fused")
    f = conv3x3(f, w_hr, b_hr, act="lrelu", counter="tail_fused")
    return conv3x3(f, w_last, b_last, counter="tail_fused")


def tail_fused_plain(x, w_up2, b_up2, w_hr, b_hr, w_last, b_last):
    f = conv3x3_plain(x, w_up2, b_up2, act="lrelu", upsample2=True)
    f = conv3x3_plain(f, w_hr, b_hr, act="lrelu")
    return conv3x3_plain(f, w_last, b_last)


def tail_fused_route(dtype: torch.dtype, nf: int, aligned: bool = True) -> str:
    """Which of K6's two kernels a call on a CUDA tensor launches: a pure
    function of the call. ``"mma"`` (``csrc/tail_fused_mma.cu``: tensor
    cores, summing in K1's order) takes bf16 at nf 64, the width of every
    RRDBNet of the zoo, with ``aligned`` operands (x and the two wide convs'
    weights and biases on 16-byte boundaries: :func:`operands_aligned`);
    ``"fma"`` (``csrc/tail_fused.cu``: fp32 FMAs) takes fp32 and the narrow
    nf 16 of the checks."""
    if dtype == torch.bfloat16 and nf == 64 and aligned:
        return "mma"
    return "fma"


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
    conv_hr's outputs kept on chip. One K6 launch on CUDA (fp32 or bf16,
    nf 64 or 16, contiguous operands) or an error; the plain version on the
    CPU. ``route``: None for :func:`tail_fused_route`'s kernel, ``"fma"`` to
    force the fp32-FMA kernel (a side-by-side timing). The launch is counted
    under ``tail_fused_q`` and ``tail_fused_q:<route>``."""
    if x.device.type == "cpu":
        return tail_fused_q_plain(x, w_up2, b_up2, w_hr, b_hr, w_last, b_last)
    if x.device.type != "cuda":
        raise ValueError(f"tail_fused_q: unsupported device {x.device}")
    dt = x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"tail_fused_q: dtype {dt} not supported (fp32, bf16)")
    if x.dim() != 4:
        raise ValueError(f"tail_fused_q: x must be NHWC, got {tuple(x.shape)}")
    bsz, h2, w2, nf = x.shape
    if nf not in (64, 16):
        raise ValueError(f"tail_fused_q: nf {nf} not built (64, 16)")
    shapes = {
        "x": (x, (bsz, h2, w2, nf)),
        "w_up2": (w_up2, (3, 3, nf, nf)), "b_up2": (b_up2, (nf,)),
        "w_hr": (w_hr, (3, 3, nf, nf)), "b_hr": (b_hr, (nf,)),
        "w_last": (w_last, (3, 3, nf, 3)), "b_last": (b_last, (3,)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"tail_fused_q: {name} shape {tuple(t.shape)} != {shape}")
        if t.device != x.device or t.dtype != dt:
            raise ValueError(
                f"tail_fused_q: {name} is {t.dtype} on {t.device}, expected "
                f"{dt} on {x.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"tail_fused_q: {name} must be contiguous")
    route = _pick_tail_route(x, w_up2, b_up2, w_hr, b_hr, route)
    out = torch.empty((bsz, 2 * h2, 2 * w2, 3), dtype=dt, device=x.device)
    lib = _build.load()
    fn = lib.vr_tail_fused_mma if route == "mma" else lib.vr_tail_fused
    with torch.cuda.device(x.device):
        code = fn(
            _DTYPES[dt], nf, x.data_ptr(), out.data_ptr(),
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
    """The route of a K6 call: :func:`tail_fused_route` of its operands, or
    the forced ``route`` (:func:`forced_route`)."""
    own = tail_fused_route(
        x.dtype, x.shape[-1], operands_aligned(x, w_up2, b_up2, w_hr, b_hr)
    )
    return forced_route("tail_fused_q", own, route, "bf16 at nf 64 with aligned operands")


# the same function with the same rounding points: both intermediates in the
# activation dtype, SAME zero padding at the frame edge of each conv
tail_fused_q_plain = tail_fused_plain
