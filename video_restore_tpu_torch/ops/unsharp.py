"""Single-pass unsharp mask on kernel K2, two routes of hand-written kernels.

Port of ``video_restore_tpu/ops/pallas_post.py`` ``unsharp_fused``
(``:131-186``): ``clip(x + amount * (x - gauss_sep(x)), 0, 1)`` on
(B, H, W, C) fp32 or bf16, computed in fp32 and rounded once to x's dtype
(the Pallas kernel widens its window and casts its result to ``x.dtype``,
``:98-119``, ``:175``), edge-replicate padding on both axes, taps from
``_gaussian_kernel1d(sigma, radius)``, and the ``threshold`` branch. One
read and one write of the frame. Unlike the Pallas wrapper, which falls
back to XLA when ``h % 8`` or ``h < block_h + 16`` (``:150-158``), both
kernels take every frame height. The kernel's function in plain PyTorch is
:func:`unsharp_fused_plain`.

:func:`unsharp_route` says which kernel a call launches: ``"rows"``
(``csrc/unsharp_rows.cuh``: streams down rows of a strip, four values a
thread in 16- or 8-byte loads and stores, C a template parameter,
instantiated for :data:`ROWS_CHANNELS`; its fp32 instance is built in
``unsharp_rows.cu``, its bf16 one in ``unsharp_rows_bf16.cu``) or
``"tile"`` (``csrc/unsharp.cu``: 32x16 tiles, any C). Each has an fp32
and a bf16 instance. Both routes sum the same rounded products in the same
order, so their outputs are equal bit for bit (held on the card by
``chip_smoke.py --only k2``); each kernel's note is at the top of its
source.

``VRT_POST_BF16`` and ``VRT_POST_DT`` do not reach the kernels, as they do
not reach the Pallas kernel on the TPU (they change only the XLA form,
``ops/post.py::unsharp_mask``). On the CPU the wrapper runs that XLA form's
port, :func:`~video_restore_tpu_torch.ops.post.unsharp_mask`, as the JAX
step does off the TPU (``parallel/dispatch.py:157-175``); with both knobs
unset it equals :func:`unsharp_fused_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from video_restore_tpu_torch.ops import _build
from video_restore_tpu_torch.ops.post import _gaussian_kernel1d, _unsharp_f32, unsharp_mask

MAX_RADIUS = 16  # kMaxRadius in csrc/unsharp.cu and csrc/unsharp_rows.cuh
ROWS_CHANNELS = (3,)  # the C that vr_unsharp_rows instantiates: RGB frames
ROUTES = ("rows", "tile")
DTYPES = (torch.float32, torch.bfloat16)  # each route's instances
_TAG = {torch.float32: "fp32", torch.bfloat16: "bf16"}


def unsharp_route(x: torch.Tensor, radius: int) -> str:
    """Which of K2's kernels a call on a CUDA tensor launches: a pure
    function of x's dtype and channel count and of the radius. ``"rows"``
    takes fp32 and bf16 with C in :data:`ROWS_CHANNELS` and radius 0..16,
    at any H and B and up to 2^30 values a row (W*C; a frame may hold more
    than 2^31 values; rows whose W*C values are no whole number of groups
    take its narrow copies); ``"tile"`` takes every other call."""
    if x.dtype in DTYPES and x.shape[-1] in ROWS_CHANNELS and 0 <= radius <= MAX_RADIUS:
        return "rows"
    return "tile"


def _pick_route(x: torch.Tensor, radius: int, route: Optional[str]) -> str:
    """The route of a call: :func:`unsharp_route`'s, or the forced
    ``route``: ``"tile"`` takes every call, ``"rows"`` only where the route
    function chose it."""
    own = unsharp_route(x, radius)
    if route is None:
        return own
    if route not in ROUTES:
        raise ValueError(f"unsharp_fused: unknown route {route!r} (expected one of {ROUTES})")
    if route == "rows" and own != "rows":
        raise ValueError(
            f"unsharp_fused: the rows kernel takes C in {ROWS_CHANNELS} only"
        )
    return route


def rows_kernel_info(dtype: torch.dtype, radius: int) -> Tuple[int, int]:
    """The rows kernel's instance for ``dtype`` at ``radius`` (C = 3):
    registers a thread and resident blocks per SM on the current CUDA
    device, as the CUDA runtime reports them. Needs the card."""
    if dtype not in DTYPES or not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"rows_kernel_info: no instance for {dtype} at radius {radius}")
    lib = _build.load()
    fn = lib.vr_unsharp_rows_bf16_info if dtype == torch.bfloat16 else lib.vr_unsharp_rows_info
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    _build.check(lib, fn(radius, ctypes.byref(regs), ctypes.byref(blocks)),
                 f"unsharp rows kernel info ({_TAG[dtype]})")
    return regs.value, blocks.value


def check_kernel_operand(x: torch.Tensor) -> None:
    """Raise unless x is what both kernels read: a contiguous (B, H, W, C)
    float32 or bfloat16 tensor."""
    if x.dtype not in DTYPES or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(
            "unsharp_fused: x must be a contiguous (B, H, W, C) float32 or "
            f"bfloat16 tensor (got {x.dtype}, shape {tuple(x.shape)}, strides {x.stride()})"
        )


def unsharp_fused_plain(
    x: torch.Tensor,
    amount: float = 0.5,
    sigma: float = 1.0,
    radius: int = 3,
    threshold: float = 0.0,
) -> torch.Tensor:
    """K2's function in plain PyTorch, for the checks: ``unsharp_mask`` of
    ``x.float()`` with ``VRT_POST_DT`` and ``VRT_POST_BF16`` unset, rounded
    once to x's dtype. In fp32 it is ``unsharp_mask`` itself. Not on any
    path of the step: on the card the step runs the kernel, on the CPU
    ``unsharp_mask``."""
    return _unsharp_f32(x.float(), amount, sigma, radius, threshold).to(x.dtype)


def unsharp_fused(
    x: torch.Tensor,
    amount: float = 0.5,
    sigma: float = 1.0,
    radius: int = 3,
    threshold: float = 0.0,
    route: Optional[str] = None,
) -> torch.Tensor:
    """Unsharp mask of x (B, H, W, C) fp32 or bf16 in [0, 1], in x's dtype;
    one K2 launch on CUDA (the instance of x's dtype), the JAX step's
    off-TPU form ``unsharp_mask`` on the CPU (any strides there).

    ``route``: None for :func:`unsharp_route`'s kernel, or ``"tile"`` to
    force the tile kernel, which takes every call (a side-by-side check or
    timing); ``"rows"`` only where the route function chose it. A launch
    counts under ``unsharp_fused``, ``unsharp_fused:<route>`` and
    ``unsharp_fused:<route>:<fp32|bf16>``."""
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"unsharp_fused: radius must be in [0, {MAX_RADIUS}]")
    if x.dtype not in DTYPES or x.dim() != 4:
        raise ValueError(
            "unsharp_fused: x must be (B, H, W, C) float32 or bfloat16 "
            f"(got {x.dtype}, shape {tuple(x.shape)})"
        )
    route = _pick_route(x, radius, route)
    if x.device.type == "cpu":
        return unsharp_mask(x, amount, sigma, radius, threshold)
    if x.device.type != "cuda":
        raise ValueError(f"unsharp_fused: unsupported device {x.device}")
    check_kernel_operand(x)
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    taps = (ctypes.c_float * (2 * radius + 1))(
        *[float(t) for t in _gaussian_kernel1d(sigma, radius)]
    )
    lib = _build.load()
    tag = _TAG[x.dtype]
    fn = getattr(lib, {"rows": "vr_unsharp_rows", "tile": "vr_unsharp"}[route]
                 + ("_bf16" if tag == "bf16" else ""))
    with torch.cuda.device(x.device):  # the launch's device is x's
        code = fn(
            x.data_ptr(), out.data_ptr(), b, h, w, c, radius, taps,
            float(amount), float(threshold), _build.stream_ptr(x),
        )
    _build.check(lib, code, f"unsharp kernel ({route}, {tag})")
    _build.count_launch("unsharp_fused")
    _build.count_launch(f"unsharp_fused:{route}")
    _build.count_launch(f"unsharp_fused:{route}:{tag}")
    return out
