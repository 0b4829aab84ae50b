"""K1's fp32 route on the bf16 tensor cores (``"bf16x3"``), on a machine without a card.

``csrc/conv3x3_bf16x3_wgmma.cu`` computes an fp32 conv as the six products
``a_i * w_j`` (i + j <= 2) of each value's three bf16 parts
(``ops/tail.py::split3``), summed in fp32. What is held here:

- the split is exact: ``a0 + a1 + a2 == a`` bit for bit for seeded fp32
  values across the exponents activations and weights reach (2^-40 .. 2^20),
  for activations and for HWIO weights;
- a CPU emulation of the kernel's arithmetic (the six products of the bf16
  parts, each an exact fp32 product, summed in fp32, smallest first) agrees
  with ``conv3x3_plain`` at fp32 and with the JAX package's fp32 conv
  (``video_restore_tpu.ops.conv.conv2d``, and the Pallas ``conv3x3_fused`` in
  interpret mode) within 1e-4 of the largest output value: the tolerance of
  the fp32 parity tests (``tests/test_torch_rrdbnet.py``), for sums in
  another order; the three products left out are ~2^-24 of each term;
- ``bf16x3_plan``'s tensor maps (dims, byte strides, boxes, swizzle), grid,
  tile and shared memory for every view the port hands the kernel, and its
  refusals, as ``tests/test_torch_wgmma_plan.py`` does for the bf16 route;
- ``weight_parts`` splits a weight once: the parts are kept while the
  weight lives and is unchanged (also through a view taken anew at every
  call, as an SRVGG body conv's), split again after a write in place, and
  dropped with the weight.

The kernel itself runs on the card only (``chip_smoke.py --only k1``;
``python -m video_restore_tpu_torch.tools.probe_k1 --dtype fp32``).
"""

import gc
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.models.srvgg import SRVGGNet, SRVGGSpec
from video_restore_tpu_torch.ops import _build, tail
from video_restore_tpu_torch.ops.conv import conv2d_f32, upsample_nearest

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

F32, BF = torch.float32, torch.bfloat16
SRC = (_build.CSRC / "conv3x3_bf16x3_wgmma.cu").read_text()
TOL = 1e-4  # of the largest output value: fp32 sums in another order


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _values(rng, shape, lo=-40, hi=20):
    """Seeded fp32 values with every mantissa bit in play, at exponents
    from 2^lo to 2^hi, both signs."""
    m = rng.uniform(1.0, 2.0, shape)
    e = rng.integers(lo, hi + 1, shape)
    s = rng.choice([-1.0, 1.0], shape)
    return torch.from_numpy((s * m * np.exp2(e)).astype(np.float32))


# ---- the split -------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi", [(-40, 20), (-8, 4), (-1, 0)])
def test_the_split_is_exact(lo, hi):
    rng = np.random.default_rng(lo + 100)
    a = _values(rng, (4, 9, 11, 64), lo, hi)
    p = tail.split3(a)
    assert p.shape == (3, *a.shape) and p.dtype == BF and p.is_contiguous()
    back = p[0].float() + p[1].float() + p[2].float()
    assert torch.equal(back, a)
    # each part is the rounding of what the parts before it leave
    assert torch.equal(p[0], a.to(BF))
    assert torch.equal(p[1], (a - p[0].float()).to(BF))
    # the parts fall off by at least 2^-8 each
    big = p[0].float().abs()
    assert bool((p[1].float().abs() <= big * 2.0**-8).all())
    assert bool((p[2].float().abs() <= big * 2.0**-16).all())


@pytest.mark.parametrize("cin,cout", [(64, 32), (192, 64), (64, 64)])
def test_the_split_of_weights_is_exact(cin, cout):
    """HWIO weights at the zoo's scale (Kaiming x 0.1 in the body) and at
    the full exponent range: (3, 3, 3, cin, cout), part-major, the tensor
    the kernel's 4-D map reads."""
    rng = np.random.default_rng(cin + cout)
    for w in (torch.from_numpy(rng.normal(0, 0.006, (3, 3, cin, cout)).astype(np.float32)),
              _values(rng, (3, 3, cin, cout))):
        p = tail.split3(w)
        assert p.shape == (3, 3, 3, cin, cout) and p.dtype == BF
        assert torch.equal(p[0].float() + p[1].float() + p[2].float(), w)


def test_zero_and_bf16_values_split_into_one_part():
    a = torch.tensor([0.0, -0.0, 1.0, 0.5, -3.0, 2.0**-30], dtype=F32)
    p = tail.split3(a)
    assert torch.equal(p[0].float(), a)
    assert not p[1].float().any() and not p[2].float().any()


# ---- the arithmetic -----------------------------------------------------------


def _emulated(x, w, b, act="none", alpha=None, upsample2=False, r1=None, s1=1.0,
              r2=None, s2=1.0):
    """The kernel's arithmetic on the CPU: the six products of the bf16
    parts (each product exact in fp32, as in the tensor cores), summed in
    fp32 smallest first, then conv3x3.cu's epilogue in fp32."""
    xi = upsample_nearest(x, 2) if upsample2 else x
    xp, wp = tail.split3(xi), tail.split3(w)
    y = None
    for i, j in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)):
        t = conv2d_f32(xp[i].float(), wp[j].float())
        y = t if y is None else y + t
    y = y + b
    if act == "lrelu":
        y = torch.where(y >= 0, y, 0.2 * y)
    elif act == "prelu":
        y = torch.where(y > 0, y, y * alpha)
    if r1 is not None:
        y = r1 + s1 * y
    if r2 is not None:
        y = r2 + s2 * y
    return y


def _case(shape, cin, cout, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (*shape, cin)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, scale, (3, 3, cin, cout)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32))
    return rng, x, w, b


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), err
    return err


@pytest.mark.parametrize(
    "shape,cin,cout,kw",
    [
        ((2, 7, 9), 64, 32, dict(act="lrelu")),           # an RDB conv, B = 2
        ((1, 5, 6), 192, 64, dict(r1=True, r2=True)),     # conv5 with x and the RRDB residual
        ((1, 6, 5), 64, 64, dict(act="prelu")),           # the SRVGG body
        ((1, 4, 5), 64, 64, dict(act="lrelu", upsample2=True)),  # up1, upconv2
        ((1, 3, 3), 16, 32, dict()),                      # one stage
    ],
)
def test_the_emulation_agrees_with_the_plain_conv(shape, cin, cout, kw):
    rng, x, w, b = _case(shape, cin, cout, cin + cout)
    kw = dict(kw)
    if kw.get("act") == "prelu":
        kw["alpha"] = torch.from_numpy(rng.uniform(0.1, 0.4, cout).astype(np.float32))
    oshape = (shape[0], 2 * shape[1], 2 * shape[2]) if kw.get("upsample2") else shape
    for r in ("r1", "r2"):
        if kw.pop(r, False):
            kw[r] = torch.from_numpy(rng.uniform(-1, 1, (*oshape, cout)).astype(np.float32))
            kw["s" + r[1]] = 0.2
    got = _emulated(x, w, b, **kw)
    ref = tail.conv3x3_plain(x, w, b, **kw)
    _close(got, ref)
    if "r1" not in kw:
        # a conv of the bf16-rounded operands alone is not the fp32 function
        one = tail.conv3x3_plain(x.to(BF).float(), w.to(BF).float(), b, **kw)
        assert np.abs(np.asarray(one) - np.asarray(ref)).max() > 10 * TOL * max(
            1.0, float(ref.abs().max()))


@pytest.mark.parametrize("act", ["none", "lrelu"])
def test_the_emulation_agrees_with_the_jax_fp32_conv(act):
    """Against the JAX package: its plain fp32 conv (``ops/conv.py``), and
    the Pallas ``conv3x3_fused`` in interpret mode with its residual."""
    from video_restore_tpu.ops.conv import conv2d
    from video_restore_tpu.ops.pallas_tail import conv3x3_fused

    rng, x, w, b = _case((1, 9, 12), 64, 64, 7)
    res = torch.from_numpy(rng.uniform(-1, 1, (1, 9, 12, 64)).astype(np.float32))
    y = np.asarray(conv2d(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), jnp.asarray(b.numpy())))
    if act == "lrelu":
        y = np.where(y >= 0, y, 0.2 * y)
    _close(_emulated(x, w, b, act=act), y)
    yp = conv3x3_fused(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), jnp.asarray(b.numpy()),
                       jnp.asarray(res.numpy()), act=act, interpret=True)
    _close(_emulated(x, w, b, act=act, r1=res), np.asarray(jax.device_get(yp)))


def test_the_rdb_of_the_emulation_agrees_with_the_plain_rdb():
    """Five chained convs on one growth buffer, as the fp32 RDB runs them."""
    from video_restore_tpu_torch.ops import stripe

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 6, 7, 64)).astype(np.float32))
    ws = [torch.from_numpy(rng.normal(0, 0.03, (3, 3, 64 + 32 * k, 32 if k < 4 else 64))
                           .astype(np.float32)) for k in range(5)]
    bs = [torch.from_numpy(rng.normal(0, 0.05, 32 if k < 4 else 64).astype(np.float32))
          for k in range(5)]

    def conv(xk, w, b, *, out=None, **kw):
        y = _emulated(xk, w, b, **kw)
        if out is None:
            return y
        out.copy_(y)
        return out

    got = stripe._rdb(conv, x, ws, bs, None)
    _close(got, stripe.rdb_fused_plain(x, ws, bs))


# ---- the plan ----------------------------------------------------------------------


def test_the_python_plan_matches_the_shipped_build():
    """The tile rows, stage width, stages and raw windows of the source,
    and the plan's length the launcher reads."""
    g = tail.BF16X3
    nc = _const("NC")
    assert g["th32"] == nc * _define("VR_X3_ROWS32") and g["th64"] == nc * _define("VR_X3_ROWS64")
    assert g["tw"] == _const("TW") and g["kc"] == _const("KC")
    assert _const("QS") == tail._BF16X3_STAGES == 2 and _const("DR") == 1
    plan = tail.bf16x3_plan((1, 8, 8, 64), 64, 64, sms=132)
    assert len(plan.array()) == _const("PLAN_LEN") == 27


@pytest.mark.parametrize("cout,th,smem", [(32, 8, 227624), (64, 4, 216872)])
def test_shared_memory_of_a_block(cout, th, smem):
    """Two stages of three weight and three window parts, one raw fp32
    window: within the card's 232448 bytes, no room for a second window
    or a third stage."""
    assert tail.bf16x3_smem(cout, th) == smem
    assert smem <= tail.SMEM_MAX
    ph = th + 2
    stage = 3 * 9 * 16 * cout * 2 + 3 * (-(-ph * 66 * 32 // 1024) * 1024)
    assert smem + ph * 66 * 64 > tail.SMEM_MAX  # a second raw window does not fit
    assert smem == 1024 + 2 * stage + ph * 66 * 64 + 5 * 8
    assert smem + stage > tail.SMEM_MAX  # a third stage does not fit


@pytest.mark.parametrize("cin", [64, 96, 128, 160, 192])
def test_each_growth_buffer_prefix(cin):
    """The fp32 RDB: conv k reads buf[..., :cin] of a (1, 1080, 1920, 192)
    fp32 buffer; the map spans cin channels, its W stride is the buffer's
    pixel (192 x 4 bytes); the weights' map spans the three parts."""
    buf = torch.empty(1, 1080, 1920, 192, dtype=F32, device="meta")
    cout = 64 if cin == 192 else 32
    w = torch.empty(3, 3, cin, cout, dtype=F32, device="meta")
    p = tail.bf16x3_call_plan(buf[..., :cin], w, sms=132)
    th = 4 if cout == 64 else 8
    assert p.a_dims == (cin, 1920, 1080, 1)
    assert p.a_strides == (768, 1920 * 768, 1080 * 1920 * 768)
    assert p.a_box == (16, 66, th + 2, 1)  # 16 fp32 channels of a window
    assert p.w_dims == (cout, cin, 9, 3)
    assert p.w_strides == (cout * 2, cin * cout * 2, 9 * cin * cout * 2)
    assert p.w_box == (cout, 16, 9, 3)  # one stage's channels, every tap, three parts
    assert p.w_swizzle == cout * 2
    assert p.tile == (th, 64) and p.tiles == (1080 // th) * 30 and p.grid == 132
    vals = list(p.array())
    assert vals == [*p.a_dims, *p.a_strides, *p.a_box, *p.w_dims, *p.w_strides, *p.w_box,
                    cout * 2, 132, th, 64, p.smem]


def test_up2_tiles_cover_the_fine_grid():
    """up1 and upconv2: the tiles cover (2H, 2W); x's map stays the coarse
    tensor's (the launcher checks it, the producer copies the windows)."""
    p = tail.bf16x3_plan((1, 1080, 1920, 64), 64, 64, sms=132, upsample2=True)
    assert p.a_dims == (64, 1920, 1080, 1)
    assert p.tiles == (2160 // 4) * 60 and p.grid == 132
    q = tail.bf16x3_plan((1, 2160, 3840, 64), 64, 64, sms=132, upsample2=True)
    assert q.tiles == (4320 // 4) * 120


@pytest.mark.parametrize(
    "shape,cout,tiles", [((1, 3, 7), 32, 1), ((1, 9, 7), 32, 2), ((2, 37, 53), 64, 2 * 10),
                         ((6, 19, 70), 32, 6 * 3 * 2), ((1, 1, 1), 64, 1)]
)
def test_frames_smaller_than_a_tile(shape, cout, tiles):
    """Ragged extents and frames smaller than one tile: boxes reach past
    the frame (TMA zero-fills them: the SAME padding); the grid is never
    larger than the tiles."""
    p = tail.bf16x3_plan((*shape, 64), 64, cout, sms=132)
    assert p.tiles == tiles and p.grid == min(tiles, 132)


def test_the_geometry_of_another_build():
    p = tail.bf16x3_plan((1, 64, 64, 64), 64, 32, sms=132,
                         geometry=dict(th32=4, th64=2, tw=64, kc=16))
    assert p.tile == (4, 64) and p.a_box == (16, 66, 6, 1)
    assert p.smem == tail.bf16x3_smem(32, 4)


@pytest.mark.parametrize(
    "shape,xs,cout,match",
    [
        ((1, 4, 5, 64), 66, 64, "not a multiple of 4"),
        ((1, 4, 5, 64), 60, 64, "pixel stride 60 < cin"),
        ((1, 4, 5, 24), 24, 64, "cin 24"),
        ((1, 4, 5, 64), 64, 48, "cout 48"),
        ((1, 4, 5, 64), 64, 3, "cout 3"),
        ((0, 4, 5, 64), 64, 64, "empty shape"),
    ],
)
def test_calls_the_kernel_cannot_take_are_refused(shape, xs, cout, match):
    with pytest.raises(ValueError, match=match):
        tail.bf16x3_plan(shape, xs, cout, sms=132)


def test_a_box_over_tma_limits_is_refused():
    with pytest.raises(ValueError, match="box over 256"):
        tail.bf16x3_plan((1, 8, 8, 64), 64, 64, sms=132,
                         geometry=dict(th32=8, th64=255, tw=64, kc=16))


def test_a_view_that_is_not_a_channel_slice_is_refused():
    buf = torch.zeros(1, 8, 5, 64, dtype=F32)
    with pytest.raises(ValueError, match="channel slice of a contiguous NHWC buffer"):
        tail.bf16x3_call_plan(buf[:, ::2], torch.zeros(3, 3, 64, 64), sms=132)


def _weight(seed, shape=(3, 3, 64, 32)):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * 0.05


def test_the_parts_are_split_once_a_weight():
    w = _weight(0)
    p = tail.weight_parts(w)
    assert p.shape == (3, 3, 3, 64, 32) and p.dtype == BF and p.is_contiguous()
    assert torch.equal(p.float().sum(0), w)  # exact, in any order of three
    assert tail.weight_parts(w) is p
    # another weight of the same values has parts of its own
    assert tail.weight_parts(w.clone()) is not p


def test_the_parts_follow_a_write_in_place():
    w = _weight(1)
    p = tail.weight_parts(w)
    w.mul_(-0.5)
    q = tail.weight_parts(w)
    assert q is not p and torch.equal(q.float().sum(0), w)
    assert tail.weight_parts(w) is q
    with torch.no_grad():
        w.copy_(_weight(2))
    assert torch.equal(tail.weight_parts(w).float().sum(0), _weight(2))


def test_the_parts_of_a_view_taken_anew_are_kept():
    """An SRVGG body conv's weight is body.w[i], a new view at every call:
    each conv's parts are split once, and again after a write to the body."""
    net = SRVGGNet(SRVGGSpec(num_conv=3))
    g = torch.Generator().manual_seed(3)
    for p in net.parameters():
        p.data = torch.randn(p.shape, generator=g) * 0.05
    net.prepare(F32, "cpu")
    w = net.body.w
    parts = [tail.weight_parts(w[i]) for i in range(3)]
    for i in range(3):
        assert tail.weight_parts(w[i]) is parts[i]
        assert torch.equal(parts[i].float().sum(0), w[i])
    with torch.no_grad():
        w[1].mul_(2.0)
    for i in range(3):
        q = tail.weight_parts(w[i])
        assert q is not parts[i] and torch.equal(q.float().sum(0), w[i])


def test_the_parts_go_with_their_weight():
    w = _weight(4)
    tail.weight_parts(w)
    tail.weight_parts(w[..., :16])
    n = len(tail._PARTS)
    del w
    gc.collect()
    assert len(tail._PARTS) == n - 1
    with torch.inference_mode():  # no version counter: split at every call
        v = _weight(5)
        p = tail.weight_parts(v)
        assert tail.weight_parts(v) is not p and torch.equal(p.float().sum(0), v)
    assert len(tail._PARTS) == n - 1
