"""K3's fp32 route (``"bf16x3"``, ``csrc/srvgg_up_bf16x3.cu``), on a machine without a card.

The kernel computes the SRVGG upsampler, ``pixel_shuffle(conv3x3(feat, w)
+ b, r) + upsample_nearest(x_in, r)``, on the bf16 tensor cores as K1
``"bf16x3"`` does a conv: the six products ``a_i * w_j`` (i + j <= 2) of
each value's three bf16 parts (``ops/tail.py::split3``), per 16 input
channels, the nine taps in order, summed in one fp32 accumulator; then the
bias and the skip in fp32. Its weights are conv_out's padded to N = 48 (r
4) or 16 (r 2) columns and split K-major (``weight_parts(k_major=True)``).
What is held here:

- ``srvgg_up_x3_plan``: the tile of each scale, the grid, the two maps'
  dims, byte strides and boxes, the shared memory, its refusals, and the
  Python plan against the build's constants (read from the sources);
- the K-major split parts: exact, the transpose of the N-major ones, kept
  once a weight beside them;
- a CPU emulation of the kernel's arithmetic (the split parts, the six
  products in the kernel's k16 order: each k16 group of a part's product
  summed in float64 in channel order and rounded once, added to one fp32
  accumulator; then the epilogue) agrees with ``srvgg_up_fused_plain`` at
  fp32 and with the JAX package's ``srvgg_up_fused`` (``pallas_srvgg.py:854``)
  and ``srvgg_up_fused_raw`` (``:1025``) in interpret mode within 1e-4 of
  the largest output value (fp32 sums in another order), at r 2 and 4, nf
  16 and 64.

The kernel itself runs on the card only (``chip_smoke.py --only k3``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.models.srvgg import SRVGGNet, SRVGGSpec
from video_restore_tpu_torch.ops import _build, srvgg, tail
from video_restore_tpu_torch.ops.conv import pixel_shuffle, upsample_nearest

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

F32, BF = torch.float32, torch.bfloat16
SRC = (_build.CSRC / "srvgg_up_bf16x3.cu").read_text()
K1_SRC = (_build.CSRC / "conv3x3_bf16x3_wgmma.cu").read_text()
TOL = 1e-4  # of the largest output value: fp32 sums in another order
SIX = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))  # a_i * w_j, smallest first


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# ---- the plan ----------------------------------------------------------------------


def test_the_python_plan_matches_the_build():
    """The tile rows at r 2 and 4 (K1's consumer warpgroups x its rows at N
    16 and 48), the tile pixels and stage channels of K1's source, whose
    producer the kernel runs, and the plan's length the launcher reads."""
    g = srvgg.UP_X3
    nc = _const(K1_SRC, "NC")
    assert g["th2"] == nc * _const(K1_SRC, "ROWS16")
    assert g["th4"] == nc * _const(K1_SRC, "ROWS48")
    assert g["tw"] == _const(K1_SRC, "TW") and g["kc"] == _const(K1_SRC, "KC")
    assert _const(K1_SRC, "QS") == 2 and _const(K1_SRC, "DR") == 1
    assert srvgg.UP_X3_PLAN_LEN == _const(SRC, "UP_PLAN_LEN") == 26
    for r in (2, 4):
        assert len(srvgg.srvgg_up_x3_plan((1, 8, 8, 64), r, sms=132).array()) == 26


@pytest.mark.parametrize("r,th,n,smem", [(4, 4, 48, 214912), (2, 8, 16, 207232)])
def test_shared_memory_of_a_block(r, th, n, smem):
    """Two stages (three weight parts on 256-byte swizzle atoms, the window
    parts from the next 1024 bytes), one raw window, the barriers and 8
    warps' staging of r fine rows: within the card's 232448 bytes, with no
    room for a third stage."""
    assert srvgg.up_width(r) == n
    assert srvgg.srvgg_up_x3_smem(r) == smem <= tail.SMEM_MAX
    assert srvgg.srvgg_up_x3_plan((1, 8, 8, 64), r, sms=132).tile == (th, 64)
    ph = th + 2
    w_part = 9 * 16 * n * 2
    assert w_part % 256 == 0
    stage = -(-3 * w_part // 1024) * 1024 + 3 * (-(-ph * 66 * 32 // 1024) * 1024)
    assert smem + stage > tail.SMEM_MAX


def test_the_config4_plan():
    """The config-4 frame, 1x1080x1920x64 at r 4: feat's map over (cin, W,
    H, B), 16 fp32 channels of a 6 x 66 window; the K-major parts' map over
    (cin, 48, 9, 3), 16 channels of every cout, tap and part."""
    p = srvgg.srvgg_up_x3_plan((1, 1080, 1920, 64), 4, sms=132)
    assert p.a_dims == (64, 1920, 1080, 1)
    assert p.a_strides == (256, 1920 * 256, 1080 * 1920 * 256)
    assert p.a_box == (16, 66, 6, 1)
    assert p.w_dims == (64, 48, 9, 3)
    assert p.w_strides == (128, 48 * 128, 9 * 48 * 128)
    assert p.w_box == (16, 48, 9, 3)
    assert p.tile == (4, 64) and p.tiles == 270 * 30 and p.grid == 132
    assert list(p.array()) == [*p.a_dims, *p.a_strides, *p.a_box, *p.w_dims, *p.w_strides,
                               *p.w_box, 132, 4, 64, 214912]


@pytest.mark.parametrize(
    "shape,r,tiles",
    [((6, 376, 448, 64), 4, 6 * 94 * 7), ((1, 270, 481, 64), 2, 34 * 8), ((1, 5, 7, 16), 2, 1),
     ((3, 70, 200, 64), 4, 3 * 18 * 4), ((1, 1, 1, 64), 4, 1), ((1, 64, 64, 64), 4, 16),
     ((2, 9, 65, 32), 2, 2 * 2 * 2), ((1, 64, 64, 16), 2, 8)],
)
def test_tiles_and_grid(shape, r, tiles):
    """The tile batch, an odd width at r 2, frames smaller than one tile:
    boxes reach past the frame (TMA zero-fills them: the SAME padding); the
    grid is never larger than the tiles."""
    p = srvgg.srvgg_up_x3_plan(shape, r, sms=132)
    assert p.tiles == tiles and p.grid == min(tiles, 132)
    assert p.w_dims == (shape[-1], srvgg.up_width(r), 9, 3)


@pytest.mark.parametrize(
    "shape,r,match",
    [
        ((0, 4, 5, 64), 4, "empty shape"),
        ((1, 4, 5, 64), 3, "r 3"),
        ((1, 4, 5, 24), 4, "cin 24"),
        ((1 << 11, 1 << 10, 1 << 10, 16), 4, "2\\^31"),
        ((1, 1 << 15, 1 << 15, 1024), 4, "byte stride"),
        ((1, 1 << 15, 1 << 15, 1024), 2, "byte stride"),
    ],
)
def test_calls_the_kernel_cannot_take_are_refused(shape, r, match):
    with pytest.raises(ValueError, match=match):
        srvgg.srvgg_up_x3_plan(shape, r, sms=132)


# ---- the K-major parts ---------------------------------------------------------------


@pytest.mark.parametrize("r", [2, 4])
def test_the_k_major_parts(r):
    """The padded conv_out weight's parts, (3, 3, 3, N, cin): exact, the
    N-major parts transposed, split once a weight, kept beside the N-major
    ones, split again after a write in place."""
    g = torch.Generator().manual_seed(r)
    w = srvgg.srvgg_up_weights(torch.randn(3, 3, 64, 3 * r * r, generator=g) * 0.05, r)
    k = tail.weight_parts(w, k_major=True)
    n = srvgg.up_width(r)
    assert k.shape == (3, 3, 3, n, 64) and k.dtype == BF and k.is_contiguous()
    assert torch.equal(k.float().sum(0), w.transpose(-1, -2))
    p = tail.weight_parts(w)
    assert torch.equal(k, p.transpose(-1, -2))
    assert tail.weight_parts(w, k_major=True) is k and tail.weight_parts(w) is p
    with torch.no_grad():
        w.mul_(-0.5)
    k2 = tail.weight_parts(w, k_major=True)
    assert k2 is not k and torch.equal(k2.float().sum(0), w.transpose(-1, -2))


# ---- the arithmetic ------------------------------------------------------------------


def k3_emulated(feat, w_out, b_out, x_in, r):
    """The kernel's arithmetic on the CPU: conv_out padded to N columns,
    per 16 input channels, the nine taps in order, the six part products
    smallest first, each a k16 group (16 exact products summed in float64 in
    channel order, rounded once to fp32) added to one fp32 accumulator; then
    (acc + b) + skip in fp32 at each fine pixel."""
    wp = srvgg.srvgg_up_weights(w_out, r)
    bsz, h, wd, cin = feat.shape
    xp = torch.nn.functional.pad(feat.float(), (0, 0, 1, 1, 1, 1))  # SAME: zeros
    ap, bp = tail.split3(xp).double(), tail.split3(wp).double()
    acc = torch.zeros(bsz, h, wd, wp.shape[-1], dtype=F32)
    for c0 in range(0, cin, 16):
        for ky in range(3):
            for kx in range(3):
                for i, j in SIX:
                    a = ap[i][:, ky:ky + h, kx:kx + wd, c0:c0 + 16]
                    wt = bp[j][ky, kx, c0:c0 + 16]
                    s = a[..., 0:1] * wt[0]
                    for c in range(1, 16):
                        s = s + a[..., c:c + 1] * wt[c]
                    acc = acc + s.float()
    y = acc[..., : 3 * r * r] + b_out
    return pixel_shuffle(y, r) + upsample_nearest(x_in.float(), r)


def _case(seed, r, shape, nf):
    rng = np.random.default_rng(seed)
    feat = rng.uniform(-1, 1, (*shape, nf)).astype(np.float32)
    x_in = rng.random((*shape, 3)).astype(np.float32)
    w_out = rng.normal(0, 0.05, (3, 3, nf, 3 * r * r)).astype(np.float32)
    b_out = rng.normal(0, 0.05, 3 * r * r).astype(np.float32)
    return feat, w_out, b_out, x_in


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), err
    return err


@pytest.mark.parametrize("nf", [16, 64])
@pytest.mark.parametrize("r", [2, 4])
def test_the_emulation_agrees_with_the_plain_upsampler(r, nf):
    feat, w_out, b_out, x_in = (torch.from_numpy(a) for a in _case(r + nf, r, (2, 5, 7), nf))
    got = k3_emulated(feat, w_out, b_out, x_in, r)
    ref = srvgg.srvgg_up_fused_plain(feat, w_out, b_out, x_in, r)
    assert got.shape == ref.shape == (2, 5 * r, 7 * r, 3)
    _close(got, ref)
    # a conv of the bf16-rounded operands alone is not the fp32 function
    one = srvgg.srvgg_up_fused_plain(feat.to(BF).float(), w_out.to(BF).float(), b_out, x_in, r)
    assert np.abs((one - ref).numpy()).max() > 10 * TOL * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("nf", [16, 64])
@pytest.mark.parametrize("r", [2, 4])
def test_the_emulation_agrees_with_pallas_srvgg_up_fused(r, nf):
    """Against the JAX ``srvgg_up_fused`` (#18, the tiled form) in interpret
    mode, B = 2, extents no block divides."""
    from video_restore_tpu.ops.pallas_srvgg import srvgg_up_fused as jax_up

    arrays = _case(10 + r + nf, r, (2, 6, 9), nf)
    ref = np.asarray(jax_up(*(jnp.asarray(a) for a in arrays), r=r, block_h=4, interpret=True))
    _close(k3_emulated(*(torch.from_numpy(a) for a in arrays), r), ref)


@pytest.mark.parametrize("nf", [16, 64])
@pytest.mark.parametrize("r", [2, 4])
def test_the_emulation_agrees_with_pallas_srvgg_up_fused_raw(r, nf):
    """Against the JAX ``srvgg_up_fused_raw`` (#17, the full-frame form that
    reads the body's 2D-padded array in place) in interpret mode."""
    from video_restore_tpu.ops.pallas_srvgg import srvgg_up_fused_raw
    from video_restore_tpu.ops.pallas_stripe import pad_stripe2d_entry

    feat, w_out, b_out, x_in = _case(20 + r + nf, r, (1, 10, 13), nf)
    xp = pad_stripe2d_entry(jnp.asarray(feat), block_h=8, block_w=8)
    ref = np.asarray(srvgg_up_fused_raw(
        xp, jnp.asarray(w_out), jnp.asarray(b_out), jnp.asarray(x_in), r=r, frame_h=10,
        frame_w=13, block_h2=8, block_w2=8, interpret=True,
    ))
    got = k3_emulated(*(torch.from_numpy(a) for a in (feat, w_out, b_out, x_in)), r)
    _close(got, ref)


# ---- the route on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("r", [2, 4])
def test_the_model_and_the_wrapper_on_the_cpu(r):
    """An fp32 SRVGGNet prepares the padded conv_out its route reads (r 2:
    16 columns); on CPU tensors the wrapper runs the plain version and
    launches nothing, whatever the route would be on the card."""
    net = SRVGGNet(SRVGGSpec(num_feat=16, num_conv=1, scale=r)).prepare(F32, "cpu")
    assert srvgg.srvgg_up_route(F32, 16, r) == "bf16x3"
    assert hasattr(net, "w_up") is (r == 2)
    feat, w_out, b_out, x_in = (torch.from_numpy(a) for a in _case(r, r, (1, 3, 4), 16))
    _build.reset_launches()
    got = srvgg.srvgg_up_fused(feat, srvgg.srvgg_up_weights(w_out, r), b_out, x_in, r)
    assert torch.equal(got, srvgg.srvgg_up_fused_plain(feat, w_out, b_out, x_in, r))
    assert _build.launches() == {}
