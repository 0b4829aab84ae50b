"""K2's two routes: which calls take the rows kernel, what the wrapper
refuses, and the function against the JAX package at the shapes the rows
kernel has to get right.

``"rows"`` (``csrc/unsharp_rows.cuh``, its fp32 instance built in
``unsharp_rows.cu`` and its bf16 one in ``unsharp_rows_bf16.cu``) streams
down rows of a strip, four values a thread, with C a template parameter (3,
RGB frames); ``"tile"`` (``csrc/unsharp.cu``) takes every call. Each has an
fp32 and a bf16 instance (fp32 inside, one rounding on the store; the bf16
function against the Pallas kernel is in ``test_torch_post_dt.py``, against
``post.unsharp_mask`` of the widened frame here). Both sum in ``ops/post.py``'s order,
so their outputs are equal bit for bit (held on the card by ``chip_smoke.py
--only k2``). The route is a pure function of the call, tested here on the
CPU, where the wrapper runs the plain version and launches nothing.

The bf16 function (``unsharp_fused_plain``) against the JAX package's
``post.unsharp_mask`` of the same bf16 frame widened to fp32, its result
rounded once to bf16, as the kernels compute: both sum fp32 products of the
same taps, in another order, so a value near a rounding boundary may round
the other way: within one bf16 step (2^-8 relative) per value.

Against the JAX package with the same numpy inputs, fp32 on both sides:
``pallas_post.unsharp_fused(interpret=True)`` where the Pallas kernel takes
the shape itself (8 | h, h >= block_h + 16, radius <= 8;
``pallas_post.py:150``), ``post.unsharp_mask`` elsewhere. Both sides sum
the same fp32 products in the same order, so the tolerance is float
rounding only: rtol = atol = 1e-6, as in ``test_torch_kernels_cpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.ops import _build, unsharp
from video_restore_tpu_torch.ops.post import unsharp_mask

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

F32, BF = torch.float32, torch.bfloat16


def _x(b=1, h=4, w=5, c=3, dt=F32):
    return torch.zeros(b, h, w, c, dtype=dt)


# ---- the route table ---------------------------------------------------------


@pytest.mark.parametrize(
    "c,radius,w,dt,route",
    [
        (3, 4, 4, F32, "rows"),    # the paths' frames: W*C % 4 == 0
        (3, 4, 53, F32, "rows"),   # W*C % 4 == 3: the rows kernel's 4-byte path
        (3, 0, 1, F32, "rows"),
        (3, 16, 7, F32, "rows"),
        (1, 4, 4, F32, "tile"),    # C the rows kernel does not instantiate
        (4, 4, 4, F32, "tile"),
        (2, 1, 3, F32, "tile"),
        (3, 17, 4, F32, "tile"),   # beyond either kernel (the wrapper refuses it)
        (3, 4, 4, BF, "rows"),     # the bf16 instance (VRT_POST_DT=bf16 frames)
        (3, 4, 53, BF, "rows"),    # W*C % 8 != 0: its 2-byte copies
        (4, 4, 4, BF, "tile"),
        (3, 4, 4, torch.float16, "tile"),  # neither instance (the wrapper refuses it)
    ],
)
def test_the_route_table(c, radius, w, dt, route):
    assert unsharp.unsharp_route(_x(w=w, c=c, dt=dt), radius) == route
    assert unsharp.ROUTES == ("rows", "tile")


@pytest.mark.parametrize("radius", range(unsharp.MAX_RADIUS + 1))
def test_the_bf16_route_table_at_every_radius(radius):
    """``unsharp_rows_bf16.cu`` instantiates C = 3 at every radius 0..16, as
    ``unsharp_rows.cu`` does in fp32; any other C takes the tile kernel."""
    for dt in (BF, F32):
        assert unsharp.unsharp_route(_x(w=7, dt=dt), radius) == "rows"
        for c in (1, 2, 4, 5):
            assert unsharp.unsharp_route(_x(w=7, c=c, dt=dt), radius) == "tile"


@pytest.mark.parametrize("dtype,radius", [(torch.float16, 4), (F32, 17), (BF, -1)])
def test_rows_kernel_info_refuses_what_has_no_instance(dtype, radius):
    """The registers and blocks per SM are asked only of an instance that
    exists (fp32 or bf16, radius 0..16); the question itself needs the
    card."""
    with pytest.raises(ValueError, match="no instance"):
        unsharp.rows_kernel_info(dtype, radius)


def test_the_route_is_a_function_of_c_and_radius_only():
    """H, W, B and strides do not move the route: the rows kernel takes
    every frame size and W*C % 4."""
    for b, h, w in ((1, 1, 1), (2, 37, 53), (1, 4, 3000), (3, 4320, 4)):
        assert unsharp.unsharp_route(_x(b, h, w), 4) == "rows"
        assert unsharp.unsharp_route(_x(b, h, w, c=4), 4) == "tile"
    assert unsharp.unsharp_route(_x(w=6)[:, :, ::2], 4) == "rows"


@pytest.mark.parametrize("dt", [F32, BF])
def test_a_frame_of_more_than_2_31_values_takes_rows(dt):
    """The x4 output of a 10240x5760 frame, 40960x23040x3 (2.8 G values):
    the rows kernel keeps a row's offset in its frame 64-bit, so it takes
    such a frame (held against the tile kernel above 2^31 values on the card
    by ``chip_smoke.py --only k2``)."""
    x = torch.empty(1, 23040, 40960, 3, dtype=dt, device="meta")
    assert x.numel() > 2**31
    assert unsharp.unsharp_route(x, 4) == "rows"
    assert unsharp.unsharp_route(x[..., :2], 4) == "tile"


def test_a_forced_route_is_checked():
    """``"tile"`` takes every call (a side-by-side check or timing);
    ``"rows"`` only where the route function chose it."""
    assert unsharp._pick_route(_x(), 4, None) == "rows"
    assert unsharp._pick_route(_x(), 4, "rows") == "rows"
    assert unsharp._pick_route(_x(), 4, "tile") == "tile"
    assert unsharp._pick_route(_x(c=4), 4, None) == "tile"
    assert unsharp._pick_route(_x(c=4), 4, "tile") == "tile"
    with pytest.raises(ValueError, match="rows kernel takes"):
        unsharp._pick_route(_x(c=4), 4, "rows")


# ---- what the wrapper refuses ----------------------------------------------------


@pytest.mark.parametrize(
    "case", ["radius 17", "radius -1", "fp16", "fp64", "3-d", "route 'fma'", "forced rows at C 4",
             "meta device"]
)
def test_the_wrapper_refuses(case):
    x = torch.rand(1, 6, 7, 3)
    call = {
        "radius 17": lambda: unsharp.unsharp_fused(x, 0.3, 1.5, 17),
        "radius -1": lambda: unsharp.unsharp_fused(x, 0.3, 1.5, -1),
        "fp16": lambda: unsharp.unsharp_fused(x.to(torch.float16), 0.3, 1.5, 4),
        "fp64": lambda: unsharp.unsharp_fused(x.double(), 0.3, 1.5, 4),
        "3-d": lambda: unsharp.unsharp_fused(x[0], 0.3, 1.5, 4),
        "route 'fma'": lambda: unsharp.unsharp_fused(x, 0.3, 1.5, 4, route="fma"),
        "forced rows at C 4": lambda: unsharp.unsharp_fused(
            torch.rand(1, 6, 7, 4), 0.3, 1.5, 4, route="rows"),
        "meta device": lambda: unsharp.unsharp_fused(x.to("meta"), 0.3, 1.5, 4),
    }[case]
    _build.reset_launches()
    with pytest.raises(ValueError):
        call()
    assert _build.launches() == {}


def test_the_kernels_refuse_a_strided_x():
    """Both kernels read a contiguous frame: on a CUDA tensor the wrapper
    raises for any other (``check_kernel_operand``); on the CPU the plain
    version takes any strides."""
    x = torch.rand(1, 6, 14, 3)[:, :, ::2]
    assert not x.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        unsharp.check_kernel_operand(x)
    unsharp.check_kernel_operand(x.contiguous())
    assert torch.equal(unsharp.unsharp_fused(x, 0.3, 1.5, 4), unsharp_mask(x, 0.3, 1.5, 4))


@pytest.mark.parametrize("mode", ["seamless", "legacy"])
def test_the_tiled_model_output_is_what_the_kernels_read(mode):
    """``restore_step`` hands ``tiled_apply``'s output to the sharpen
    kernel: on a grid whose crop of the canvas is strided (legacy, padded)
    it comes back contiguous, so ``--tile-size N --no-seamless --sharpen``
    runs on the card."""
    from video_restore_tpu_torch.ops import tiles

    grid = tiles.TileGrid.build(37, 53, tile=32, overlap=8, scale=2, mode=mode, tile_chunk=4)
    assert grid.n_tiles > 1

    def up2(t):
        return t.float().repeat_interleave(2, 1).repeat_interleave(2, 2)

    y = tiles.tiled_apply(up2, torch.rand(1, 37, 53, 3), grid)
    assert y.shape == (1, 74, 106, 3)
    unsharp.check_kernel_operand(y)


def test_on_the_cpu_the_wrapper_runs_plain_and_launches_nothing():
    g = torch.Generator().manual_seed(0)
    _build.reset_launches()
    for shape, route in (((2, 9, 13, 3), None), ((1, 5, 4, 3), "rows"), ((1, 7, 6, 4), "tile")):
        x = torch.rand(*shape, generator=g)
        got = unsharp.unsharp_fused(x, 0.3, 1.5, 4, 0.02, route=route)
        assert torch.equal(got, unsharp_mask(x, 0.3, 1.5, 4, 0.02))
    assert _build.launches() == {}


# ---- the function against the JAX package --------------------------------------


def _pallas_takes(h, radius, block_h=8):
    return h % 8 == 0 and h >= block_h + 16 and radius <= 8


@pytest.mark.parametrize(
    "b,h,w,c,radius,thr",
    [
        # the Pallas kernel takes these (block_h 8)
        (1, 24, 13, 3, 4, 0.0),    # W*C % 4 != 0
        (2, 32, 53, 3, 4, 0.02),   # B = 2, the threshold branch
        (1, 24, 3, 3, 4, 0.0),     # W < r
        (1, 24, 1, 3, 1, 0.0),     # W = 1
        (1, 24, 16, 1, 1, 0.02),   # C = 1
        (1, 32, 12, 4, 8, 0.0),    # C = 4, the Pallas kernel's largest radius
        # post.unsharp_mask: heights the Pallas kernel hands to XLA, radius 0, 16
        (1, 1, 13, 3, 4, 0.0),     # H = 1 < 2r + 1
        (1, 5, 53, 3, 4, 0.02),    # H = 5 < 2r + 1
        (1, 1, 1, 3, 4, 0.0),      # one pixel
        (2, 9, 13, 3, 0, 0.0),     # radius 0
        (1, 37, 53, 3, 16, 0.02),  # radius 16
        (2, 5, 3, 1, 16, 0.0),     # C = 1, W < r, H < 2r + 1
        (1, 7, 1, 4, 16, 0.02),    # C = 4
    ],
)
def test_plain_version_matches_jax(b, h, w, c, radius, thr):
    rng = np.random.default_rng(1000 * h + 10 * w + c)
    x = rng.random((b, h, w, c)).astype(np.float32)
    if _pallas_takes(h, radius):
        from video_restore_tpu.ops.pallas_post import unsharp_fused as jax_unsharp

        ref = jax_unsharp(
            jnp.asarray(x), amount=0.3, sigma=1.5, radius=radius, threshold=thr,
            block_h=8, interpret=True,
        )
    else:
        from video_restore_tpu.ops.post import unsharp_mask as jax_unsharp_mask

        ref = jax_unsharp_mask.__wrapped__(
            jnp.asarray(x), amount=0.3, sigma=1.5, radius=radius, threshold=thr
        )
    got = unsharp.unsharp_fused(torch.from_numpy(x), 0.3, 1.5, radius, thr)
    assert got.shape == (b, h, w, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def _within_one_bf16_step(got, ref):
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    mag = np.maximum(np.abs(got), np.abs(ref))
    step = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)
    assert np.all(np.abs(got - ref) <= step), np.abs(got - ref).max()


@pytest.mark.parametrize(
    "b,h,w,radius,thr",
    [
        (1, 9, 13, 0, 0.0),     # radius 0
        (2, 7, 5, 1, 0.02),     # B = 2, the threshold branch
        (1, 24, 16, 4, 0.0),    # the paths' radius
        (1, 5, 53, 4, 0.02),    # H < 2r + 1
        (1, 37, 11, 16, 0.0),   # radius 16, W < r
        (1, 3, 4, 16, 0.02),    # both extents below the halo
    ],
)
def test_plain_bf16_is_unsharp_mask_of_the_widened_frame(monkeypatch, b, h, w, radius, thr):
    from video_restore_tpu.ops.post import unsharp_mask as jax_unsharp_mask

    for name in ("VRT_POST_DT", "VRT_POST_BF16"):
        monkeypatch.delenv(name, raising=False)
    x = np.random.default_rng(100 * h + 10 * w + radius).random((b, h, w, 3)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(BF)
    ref = jax_unsharp_mask.__wrapped__(
        xj.astype(jnp.float32), amount=0.3, sigma=1.5, radius=radius, threshold=thr
    ).astype(jnp.bfloat16)
    got = unsharp.unsharp_fused_plain(xt, 0.3, 1.5, radius, thr)
    assert got.dtype == BF and got.shape == (b, h, w, 3)
    _within_one_bf16_step(got, ref)
