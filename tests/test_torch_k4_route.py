"""Which of K4's kernels each int8 conv of the port takes on the card, the
packed weights its tensor-core kernels read, and the int8 RDB's plain
version against the JAX kernels at the width those kernels serve.

K4 (``ops/quant.py::conv3x3_i8``, the W8A8 conv of ``--precision int8``) is
one function behind three hand-written CUDA kernels: ``"wgmma"``
(``csrc/conv3x3_i8_wgmma.cu``: int8 ``wgmma`` m64nNk32 fed by TMA, with a
quantiser warpgroup), ``"mma"`` (``csrc/conv3x3_i8_mma.cu``: int8
``mma.sync`` m16n8k32, taken only when forced) and ``"dp4a"``
(``csrc/conv3x3_i8.cu``: ``__dp4a`` on the CUDA cores). ``conv3x3_i8_route``
chooses from the call alone, so the choice is tested here, on the CPU,
without a kernel: each model runs on a tiny frame through the plain versions
while a recorder asks the route of each int8 conv. The numbers are the ones
the chip smoke test asserts on the card: 345 ``conv3x3_i8:wgmma`` per int8
flagship frame (69 RDBs x 5 convs), 32 per int8 config-4 frame, no
``mma`` or ``dp4a``.

The tensor-core kernels read each weight packed (9, cout, cin) by
``pack_i8_weights``, made once at prepare time beside the HWIO ``wq``.

The plain version the kernels are held to on the card (bit for bit) is held
here to the JAX kernels at nf 64 / gc 32, the widths of the tensor-core
routes (``tests/test_torch_int8.py`` does so at nf 16 / gc 8), on a
1x12x20 frame, bf16, exact: dynamic A8 against ``rdb_stripe_padded`` and
``rdb_res_stripe_padded(sws)`` with one stripe (one scale per image, as the
port), static A8 against ``rdb_stripe2d_padded(sws, sas)`` with two 12x16
blocks (fixed scales, the same in every block). All in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.models.rrdbnet import RRDBNet, RRDBNetSpec
from video_restore_tpu_torch.models.srvgg import SRVGGNet
from video_restore_tpu_torch.models.zoo import MODEL_ZOO
from video_restore_tpu_torch.ops import _build, quant, srvgg, stripe

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize(
    "dtype,segs,cout,aligned,route",
    [
        # every RDB conv at nf 64 / gc 32 (1..5 segments) and an SRVGG conv
        *[(BF, quant.rdb_segments(64, 32, k), 32 if k < 5 else 64, True, "wgmma")
          for k in range(1, 6)],
        (BF, (0, 64), 64, True, "wgmma"),
        (BF, quant.rdb_segments(16, 8, 3), 8, True, "dp4a"),   # nf 16 / gc 8
        (BF, quant.rdb_segments(16, 8, 5), 16, True, "dp4a"),
        (BF, (0, 64, 96), 32, False, "dp4a"),                   # unaligned
        (F32, (0, 64, 96), 32, True, "dp4a"),                   # fp32
        (BF, (0, 48), 64, True, "dp4a"),                        # 48 channels
        (BF, (0, 64, 80), 32, True, "dp4a"),                    # a segment of 16
        (BF, (0, 64), 48, True, "dp4a"),                        # cout 48
        (BF, (0, 64), 16, True, "dp4a"),                        # cout 16
        (BF, (0, 64, 96, 128, 160, 192, 224), 64, True, "dp4a"),  # cin 224
        (BF, (0, 64, 96, 128, 160, 192, 224), 32, True, "dp4a"),  # cin 224 at cout 32
    ],
)
def test_conv3x3_i8_route(dtype, segs, cout, aligned, route):
    assert quant.conv3x3_i8_route(dtype, segs, cout, aligned) == route
    assert route in quant.I8_ROUTES


def _conv(cin=96, cout=32, segs=(0, 64, 96), dt=BF, x=None):
    x = torch.zeros(1, 4, 5, cin, dtype=dt) if x is None else x
    return x, segs, torch.zeros(3, 3, cin, cout, dtype=torch.int8), torch.zeros(cout, dtype=dt)


def test_a_forced_route_is_checked():
    """``route="mma"`` and ``route="dp4a"`` reach the older kernels for a
    side-by-side timing; neither tensor-core kernel is ever forced onto a
    call it is not built for, and the route names are K4's own."""
    ops = _conv()
    assert quant.pick_i8_route(*ops) == "wgmma"
    assert quant.pick_i8_route(*ops, route="wgmma") == "wgmma"
    assert quant.pick_i8_route(*ops, route="dp4a") == "dp4a"
    assert quant.pick_i8_route(*ops, route="mma") == "mma"
    for route in ("mma", "wgmma"):
        with pytest.raises(ValueError, match="segments of multiples of 32"):
            quant.pick_i8_route(*_conv(24, 8, (0, 16, 24)), route=route)
        with pytest.raises(ValueError, match="segments of multiples of 32"):
            quant.pick_i8_route(*_conv(dt=F32), route=route)
    with pytest.raises(ValueError, match="unknown route"):
        quant.pick_i8_route(*ops, route="fma")


def test_a_misaligned_input_takes_dp4a():
    """A view of x that starts off a 16-byte boundary is not the tensor-core
    kernel's: its route is ``"dp4a"`` and a forced ``"mma"`` or ``"wgmma"``
    raises."""
    buf = torch.zeros(1 * 4 * 5 * 96 + 1, dtype=BF)
    x = buf[1:].view(1, 4, 5, 96)
    assert x.data_ptr() % 16 and x.is_contiguous()
    ops = _conv(x=x)
    assert quant.pick_i8_route(*ops) == "dp4a"
    for route in ("mma", "wgmma"):
        with pytest.raises(ValueError, match="aligned operands"):
            quant.pick_i8_route(*ops, route=route)


def test_only_the_wgmma_kernel_reads_a_tail():
    """The blocked RDB's c1 .. c4 (``x_tail``) are read by the ``"wgmma"``
    kernel only: a forced ``"mma"`` or ``"dp4a"`` with a tail raises; on the
    CPU the wrapper is the plain version of the concatenation."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 3, 5, 64, generator=g).to(BF)
    t = torch.rand(2, 2, 3, 5, 32, generator=g).to(BF)
    wq = torch.randint(-127, 128, (3, 3, 128, 32), generator=g).to(torch.int8)
    b = torch.zeros(32, dtype=BF)
    segs = quant.rdb_segments(64, 32, 3)
    assert quant.pick_i8_route(x, segs, wq, b, x_tail=t) == "wgmma"
    for route in ("mma", "dp4a"):
        with pytest.raises(ValueError, match="x_tail is read by the wgmma kernel only"):
            quant.pick_i8_route(x, segs, wq, b, route=route, x_tail=t)
    sw = torch.rand(3, 32, generator=g) * 1e-2
    cat = torch.cat([x, t[0], t[1]], dim=-1)
    amax = torch.stack([quant.act_amax_plain(cat[..., lo:hi])
                        for lo, hi in zip(segs[:-1], segs[1:])], 1)
    got = quant.conv3x3_i8(x, segs, amax, wq, sw, b, act="lrelu", x_tail=t, counter="t")
    assert torch.equal(got, quant.conv3x3_i8_plain(cat, segs, amax, wq, sw, b, act="lrelu"))


def test_the_blocked_int8_rdb_is_for_the_card_only():
    """On the CPU the int8 RDB keeps its growth buffer (the plain version);
    the blocks are the wgmma route's layout on the card."""
    wq = [torch.zeros(3, 3, 64 + 32 * k, 32 if k < 4 else 64, dtype=torch.int8) for k in range(5)]
    bs = [torch.zeros(32 if k < 4 else 64, dtype=BF) for k in range(5)]
    assert not stripe.blocked_i8(torch.zeros(1, 4, 5, 64, dtype=BF), wq, bs)


@pytest.mark.parametrize("cin,cout", [(64, 32), (192, 64), (24, 8)])
def test_pack_i8_weights_inverts_to_hwio(cin, cout):
    g = torch.Generator().manual_seed(cin)
    wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=g).to(torch.int8)
    wp = quant.pack_i8_weights(wq)
    assert wp.shape == (9, cout, cin) and wp.dtype == torch.int8 and wp.is_contiguous()
    assert torch.equal(wp.transpose(1, 2).reshape(3, 3, cin, cout), wq)
    # the layout the mma kernel reads: row (tap, n), k contiguous
    assert torch.equal(wp[4, 1], wq[1, 1, :, 1])
    with pytest.raises(ValueError, match="int8"):
        quant.pack_i8_weights(wq.float())


def test_prepare_int8_registers_the_packed_weights():
    net = RRDBNet(RRDBNetSpec(num_feat=64, num_block=1, num_grow_ch=32, scale=4))
    net.prepare(BF, "cpu", precision="int8")
    rdb = net.body[0].rdb2
    got = rdb.int8_weights()
    assert set(got) == {"wq", "sw", "bs", "wp"}
    for k in range(5):
        assert torch.equal(got["wp"][k], quant.pack_i8_weights(got["wq"][k]))
        assert got["wp"][k].shape == (9, 32 if k < 4 else 64, 64 + 32 * k)
    v3 = SRVGGNet(MODEL_ZOO["RealESRGAN_x4_v3"].spec).prepare(BF, "cpu", precision="int8")
    assert v3.body.wp.shape == (32, 9, 64, 64)
    for i in (0, 31):
        assert torch.equal(v3.body.wp[i], quant.pack_i8_weights(v3.body.wq[i]))


def _record(monkeypatch, module):
    """Patch ``module``'s ``conv3x3_i8`` with a recorder of each call's
    route; the wrapper (the plain version, on CPU tensors) still computes."""
    calls = []
    real = module.conv3x3_i8

    def recorder(x, segs, amax, wq, sw, b, *, alpha=None, out=None, r1=None, r2=None,
                 wp=None, **kw):
        calls.append(quant.pick_i8_route(x, segs, wq, b, alpha, out, r1, r2, wp))
        return real(x, segs, amax, wq, sw, b, alpha=alpha, out=out, r1=r1, r2=r2, wp=wp, **kw)

    monkeypatch.setattr(module, "conv3x3_i8", recorder)
    return calls


def test_int8_flagship_frame_takes_345_wgmma(monkeypatch):
    """RealESRGAN_x4plus at full width (nf 64, gc 32, 23 blocks) with
    ``--precision int8``: 69 RDBs x 5 int8 convs per frame, all on Hopper's
    tensor cores."""
    spec = MODEL_ZOO["RealESRGAN_x4plus"].spec
    assert (spec.num_feat, spec.num_grow_ch, spec.num_block) == (64, 32, 23)
    net = RRDBNet(spec).prepare(BF, "cpu", precision="int8")
    calls = _record(monkeypatch, stripe)
    _build.reset_launches()
    y = net(torch.rand(1, 5, 6, 3))
    assert y.shape == (1, 20, 24, 3) and y.dtype == BF
    assert calls == ["wgmma"] * 345
    assert _build.launches() == {}  # CPU tensors: the plain versions


def test_int8_config4_frame_takes_32_wgmma(monkeypatch):
    spec = MODEL_ZOO["RealESRGAN_x4_v3"].spec
    assert (spec.num_feat, spec.num_conv) == (64, 32)
    net = SRVGGNet(spec).prepare(BF, "cpu", precision="int8")
    calls = _record(monkeypatch, srvgg)
    y = net(torch.rand(1, 5, 6, 3))
    assert y.shape == (1, 20, 24, 3)
    assert calls == ["wgmma"] * 32


@pytest.mark.parametrize("dt", [BF, F32])
def test_int8_narrow_rrdb_takes_dp4a(monkeypatch, dt):
    """nf 16 / gc 8 (the width of the CPU tests and of phase 3's narrow
    checks) and fp32 stay on the ``__dp4a`` kernel."""
    net = RRDBNet(RRDBNetSpec(num_feat=16, num_block=1, num_grow_ch=8, scale=4))
    net.prepare(dt, "cpu", precision="int8")
    calls = _record(monkeypatch, stripe)
    net(torch.rand(1, 5, 6, 3))
    assert calls == ["dp4a"] * 15


NF, GC, H, W = 64, 32, 12, 20


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _rdb64(rng):
    """numpy bf16-valued weights of one RDB at nf 64 / gc 32, its JAX W8
    (production prefix form) and the port's."""
    from video_restore_tpu.ops.pallas_stripe import (
        prefix_rdb_weights,
        production_prefix_weights,
        quantize_prefix_weights,
    )

    ws = [_bf16((rng.random((3, 3, NF + k * GC, GC if k < 4 else NF)) - 0.5) * 0.08)
          for k in range(5)]
    bs = [_bf16((rng.random(GC if k < 4 else NF) - 0.5) * 0.1) for k in range(5)]
    rdb = {f"conv{k + 1}": {"w": jnp.asarray(ws[k], jnp.bfloat16),
                            "b": jnp.asarray(bs[k], jnp.bfloat16)} for k in range(5)}
    pws, pbs = prefix_rdb_weights(rdb, NF, GC)
    qws, sws = quantize_prefix_weights(production_prefix_weights(pws))
    qs = [quant.quantize_conv_weights(torch.from_numpy(ws[k]).bfloat16(),
                                      quant.rdb_segments(NF, GC, k + 1)) for k in range(5)]
    port = ([q for q, _ in qs], [s for _, s in qs], [torch.from_numpy(b).bfloat16() for b in bs])
    return (qws, sws, pbs), port


@pytest.mark.parametrize("with_x0", [False, True])
def test_rdb_i8_plain_matches_pallas_at_nf64(rng, with_x0):
    """Dynamic A8, one stripe per image (the JAX scale is the port's): the
    plain int8 RDB at nf 64 / gc 32 equals ``rdb_stripe_padded`` /
    ``rdb_res_stripe_padded(sws)`` bit for bit in bf16."""
    from video_restore_tpu.ops.pallas_stripe import (
        pad_stripe_entry,
        rdb_res_stripe_padded,
        rdb_stripe_padded,
        unpad_stripe_exit,
    )

    (qws, sws, pbs), (wq, sw, bs) = _rdb64(rng)
    x = _bf16((rng.random((1, H, W, NF)) - 0.5) * 3)
    x0 = _bf16(rng.random((1, H, W, NF)) - 0.5) if with_x0 else None
    kw = dict(frame_h=H, frame_w=W, block_h=H, sws=sws, interpret=True)
    xp = pad_stripe_entry(jnp.asarray(x, jnp.bfloat16), block_h=H)
    if with_x0:
        x0p = pad_stripe_entry(jnp.asarray(x0, jnp.bfloat16), block_h=H)
        out = rdb_res_stripe_padded(xp, x0p, qws, pbs, **kw)
    else:
        out = rdb_stripe_padded(xp, qws, pbs, **kw)
    ref = np.asarray(unpad_stripe_exit(out, H, W, NF, block_h=H), np.float32)
    got, amax = stripe.rdb_fused_i8_plain(
        torch.from_numpy(x).bfloat16(), wq, sw, bs,
        None if x0 is None else torch.from_numpy(x0).bfloat16(),
    )
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert amax.item() == np.abs(ref).max()


def test_rdb_i8_static_plain_matches_pallas_stripe2d_at_nf64(rng):
    """Static A8 (fixed scales, the same in every block): the plain int8
    RDB at nf 64 / gc 32 equals ``rdb_stripe2d_padded(sws, sas)`` with two
    12x16 blocks bit for bit in bf16."""
    from video_restore_tpu.ops.pallas_stripe import (
        pad_stripe2d_entry,
        rdb_stripe2d_padded,
        unpad_stripe2d_exit,
    )

    (qws, sws, pbs), (wq, sw, bs) = _rdb64(rng)
    x = _bf16((rng.random((1, H, W, NF)) - 0.5) * 3)
    # below each source's |max| / 127, so some values saturate
    sas = (0.0101, 0.0042, 0.0039, 0.0051, 0.0047)
    xp = pad_stripe2d_entry(jnp.asarray(x, jnp.bfloat16), block_h=H, block_w=16)
    out = rdb_stripe2d_padded(xp, qws, pbs, frame_h=H, frame_w=W, block_h=H, block_w=16,
                              sws=sws, sas=sas, interpret=True)
    ref = np.asarray(unpad_stripe2d_exit(out, H, W, NF, block_h=H, block_w=16), np.float32)
    got, amax = stripe.rdb_fused_i8_plain(torch.from_numpy(x).bfloat16(), wq, sw, bs, sas=sas)
    assert amax is None
    np.testing.assert_array_equal(got.float().numpy(), ref)
