"""Which of K5's and K3's two kernels each call of the port takes on the card,
and the padded conv_out weight of K3's tensor-core route.

K5 (one RDB or a whole RRDB in one launch) is one function behind three
hand-written CUDA kernels: ``"wgmma"`` (``csrc/rdb_fused_wgmma.cu``: Hopper
tensor cores fed by TMA), ``"mma"`` (``csrc/rdb_fused_mma.cu``:
``mma.sync``, reached only when a caller forces it) and ``"fma"``
(``csrc/rdb_fused.cu``: fp32 FMAs); K3 (the SRVGG upsampler) is three:
``"mma"`` (``csrc/srvgg_up_mma.cu``, bf16), ``"bf16x3"``
(``csrc/srvgg_up_bf16x3.cu``, fp32 on the bf16 tensor cores) and ``"fma"``
(``csrc/srvgg_up.cu``).
``ops/rdb.py::rdb_route`` and ``ops/srvgg.py::srvgg_up_route`` choose from
the call alone, so the choice is tested here, on the CPU, without a kernel:
each model runs at full width on a tiny frame in bf16 through the plain
versions while a recorder asks the route of each call. The numbers are the
ones the chip smoke test asserts on the card: 23 ``rrdb_fused:wgmma`` per
frame of the ``VRT_PALLAS=1`` flagship body, one ``srvgg_up_fused:mma`` per
config-4 frame (``srvgg_up_fused:bf16x3`` at fp32).

K3's tensor-core kernels read conv_out with its output columns padded to a
multiple of 16 (r 2: 12 -> 16 zero columns), which
``srvgg_up_weights`` prepares once; the plain version takes either width.
Held here against the JAX ``srvgg_up_fused`` (``pallas_srvgg.py:854``) in
interpret mode at nf 16 and small extents: fp32 within 1e-5 (the same fp32
sums in another order), bf16 within one bf16 step of the larger value (one
rounding of the same fp32 sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.models import rrdbnet as rrdbnet_mod
from video_restore_tpu_torch.models import srvgg as srvgg_model
from video_restore_tpu_torch.models.rrdbnet import RRDBNet, RRDBNetSpec
from video_restore_tpu_torch.models.srvgg import SRVGGNet, SRVGGSpec
from video_restore_tpu_torch.models.zoo import MODEL_ZOO
from video_restore_tpu_torch.ops import _build, rdb, srvgg
from video_restore_tpu_torch.ops.tail import forced_route

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize(
    "dtype,nf,gc,route",
    [
        (BF, 64, 32, "wgmma"),  # every RRDBNet of the zoo
        (F32, 64, 32, "bf16x3"),  # fp32: three bf16 parts a value on the same tensor cores
        (BF, 16, 8, "fma"),    # the narrow width of the tests and checks
        (F32, 16, 8, "fma"),
        (BF, 64, 16, "fma"),   # a growth the kernel is not built for
    ],
)
def test_rdb_route(dtype, nf, gc, route):
    assert rdb.rdb_route(dtype, nf, gc) == route
    assert route in rdb.ROUTES


def test_fp32_operands_off_16_bytes_take_fma():
    """``"bf16x3"`` reads x, x0 and the biases 16 bytes at a time: an fp32
    call with one of them off a 16-byte boundary takes ``"fma"``, and a
    forced ``"bf16x3"`` raises."""
    assert rdb.rdb_route(F32, 64, 32, aligned=False) == "fma"
    buf = torch.zeros(1 * 4 * 5 * 64 + 1)
    x = buf[1:].view(1, 4, 5, 64)
    assert rdb._pick_route("t", x, 64, 32, None) == "fma"
    with pytest.raises(ValueError, match="fp32 at \\(64, 32\\)"):
        rdb._pick_route("t", x, 64, 32, "bf16x3")
    xa = torch.zeros(1, 4, 5, 64)
    assert rdb._pick_route("t", xa, 64, 32, None) == "bf16x3"
    assert rdb._pick_route("t", xa, 64, 32, "fma") == "fma"
    assert rdb._pick_route("t", xa, 64, 32, "bf16x3") == "bf16x3"
    with pytest.raises(ValueError, match="bf16 at \\(64, 32\\)"):
        rdb._pick_route("t", xa, 64, 32, "wgmma")


@pytest.mark.parametrize(
    "dtype,cin,r,route",
    [
        (BF, 64, 4, "mma"),   # config 4 (RealESRGAN_x4_v3): cout 48
        (BF, 64, 2, "mma"),   # cout 12, padded to 16
        (BF, 16, 4, "mma"),   # one k16 step
        (BF, 48, 2, "mma"),
        (F32, 64, 4, "bf16x3"),  # fp32: three bf16 parts a value on the tensor cores
        (BF, 24, 4, "fma"),   # cin not a multiple of 16
        (BF, 8, 2, "fma"),
        (BF, 128, 4, "fma"),  # above what one block holds in shared memory
        (BF, 64, 3, "fma"),   # not a scale of the fused upsampler
        (F32, 64, 2, "bf16x3"),  # cout 12, padded to 16
        (F32, 16, 4, "bf16x3"),
        (F32, 24, 4, "fma"),  # the widths the tensor-core kernels are not built for
        (F32, 128, 4, "fma"),
        (F32, 64, 3, "fma"),
    ],
)
def test_srvgg_up_route(dtype, cin, r, route):
    assert srvgg.srvgg_up_route(dtype, cin, r) == route
    assert route in srvgg.ROUTES


def test_a_forced_route_is_checked():
    """``route="mma"`` and ``route="fma"`` reach the older kernels for a
    side-by-side timing; neither tensor-core kernel is ever forced onto a
    call it is not built for."""
    xb = torch.zeros(1, 4, 5, 64, dtype=BF)
    assert rdb._pick_route("t", xb, 64, 32, None) == "wgmma"
    assert rdb._pick_route("t", xb, 64, 32, "fma") == "fma"
    assert rdb._pick_route("t", xb, 64, 32, "mma") == "mma"
    assert rdb._pick_route("t", xb, 64, 32, "wgmma") == "wgmma"
    for route in ("mma", "wgmma"):
        with pytest.raises(ValueError, match="64, 32"):
            rdb._pick_route("t", xb.float(), 64, 32, route)
        with pytest.raises(ValueError, match="64, 32"):
            rdb._pick_route("t", xb, 16, 8, route)
    with pytest.raises(ValueError, match="unknown route"):
        rdb._pick_route("t", xb, 64, 32, "dp4a")


def test_a_forced_k3_route_is_checked():
    """K3: ``"fma"`` takes every call (the side-by-side timings); ``"mma"``
    only bf16 and ``"bf16x3"`` only fp32 at the tensor-core widths."""
    own = srvgg.srvgg_up_route(F32, 64, 4)
    assert own == "bf16x3"

    def pick(own, route):
        return forced_route("srvgg_up_fused", own, route, srvgg._UP_TAKES.get(route, ""),
                            routes=srvgg.ROUTES)

    assert pick(own, None) == pick(own, "bf16x3") == "bf16x3"
    assert pick(own, "fma") == pick("fma", "fma") == "fma"
    with pytest.raises(ValueError, match="the mma kernel takes bf16"):
        pick(own, "mma")
    with pytest.raises(ValueError, match="the bf16x3 kernel takes fp32"):
        pick(srvgg.srvgg_up_route(BF, 64, 4), "bf16x3")
    with pytest.raises(ValueError, match="the bf16x3 kernel takes fp32"):
        pick(srvgg.srvgg_up_route(F32, 24, 4), "bf16x3")


def _record(monkeypatch, module, name, route_of):
    """Patch ``module.name`` with a recorder of each call's route; the
    wrapper (the plain version, on CPU tensors) still computes."""
    calls = []
    real = getattr(module, name)

    def recorder(*a, **kw):
        calls.append(route_of(*a))
        return real(*a, **kw)

    monkeypatch.setattr(module, name, recorder)
    return calls


def _rrdb_route(x, rdb_weights):
    return rdb.rdb_route(x.dtype, x.shape[-1], rdb_weights[0][0][0].shape[-1])


@pytest.mark.parametrize(
    "name,n", [("RealESRGAN_x4plus", 23), ("RealESRGAN_x4plus_anime_6B", 6)]
)
def test_pallas_body_at_full_width_takes_wgmma(monkeypatch, name, n):
    """The ``VRT_PALLAS=1`` body: one K5 launch per RRDB block, every one on
    the Hopper tensor cores (``"wgmma"``)."""
    spec = MODEL_ZOO[name].spec
    net = RRDBNet(spec).prepare(BF, "cpu", mode="pallas")
    calls = _record(monkeypatch, rrdbnet_mod, "rrdb_fused", _rrdb_route)
    y = net(torch.rand(1, 6, 7, 3))
    assert y.shape == (1, 6 * spec.scale, 7 * spec.scale, 3)
    assert calls == ["wgmma"] * n


@pytest.mark.parametrize("dt,nf,gc", [(F32, 64, 32), (BF, 16, 8), (F32, 16, 8)])
def test_pallas_body_of_fp32_and_narrow_models_takes_fma(monkeypatch, dt, nf, gc):
    """The narrow widths take the fp32-FMA kernel; fp32 at full width the
    one-launch RRDB on three bf16 parts a value (``"bf16x3"``)."""
    net = RRDBNet(RRDBNetSpec(num_feat=nf, num_block=2, num_grow_ch=gc, scale=4))
    net.prepare(dt, "cpu", mode="pallas")
    calls = _record(monkeypatch, rrdbnet_mod, "rrdb_fused", _rrdb_route)
    net(torch.rand(1, 5, 6, 3))
    route = "bf16x3" if (dt, nf, gc) == (F32, 64, 32) else "fma"
    assert calls == [route, route]


def _up_route(feat, w_out, b_out, x_in, r):
    return srvgg.srvgg_up_route(feat.dtype, feat.shape[-1], r), w_out.shape[-1]


@pytest.mark.parametrize(
    "spec,dt,expected",
    [
        (MODEL_ZOO["RealESRGAN_x4_v3"].spec, BF, [("mma", 48)]),  # config 4
        (SRVGGSpec(num_feat=64, num_conv=2, scale=2), BF, [("mma", 16)]),  # padded once
        (MODEL_ZOO["RealESRGAN_x4_v3"].spec, F32, [("bf16x3", 48)]),
        (SRVGGSpec(num_feat=64, num_conv=2, scale=2), F32, [("bf16x3", 16)]),  # padded once
        (SRVGGSpec(num_feat=8, num_conv=2, scale=4), BF, [("fma", 48)]),
    ],
)
def test_upsampler_call_of_one_frame(monkeypatch, spec, dt, expected):
    """One upsampler call per frame; its route, and the conv_out width the
    model hands it (prepared once: the padded buffer ``w_up`` exists only
    where a tensor-core route, ``"mma"`` or ``"bf16x3"``, reads a padded
    weight)."""
    net = SRVGGNet(spec).prepare(dt, "cpu")
    assert hasattr(net, "w_up") is (expected[0][1] != 3 * spec.scale**2)
    calls = _record(monkeypatch, srvgg_model, "srvgg_up_fused", _up_route)
    y = net(torch.rand(1, 6, 5, 3))
    assert y.shape == (1, 6 * spec.scale, 5 * spec.scale, 3) and y.dtype == dt
    assert calls == expected


def test_srvgg_up_weights_pads_with_zero_columns():
    w2 = torch.randn(3, 3, 16, 12)
    p2 = srvgg.srvgg_up_weights(w2, 2)
    assert p2.shape == (3, 3, 16, 16) and p2.is_contiguous()
    assert torch.equal(p2[..., :12], w2) and not p2[..., 12:].any()
    assert torch.equal(srvgg.srvgg_up_weights(p2, 2), p2)  # idempotent
    w4 = torch.randn(3, 3, 16, 48)
    assert torch.equal(srvgg.srvgg_up_weights(w4, 4), w4)
    assert (srvgg.up_width(2), srvgg.up_width(4)) == (16, 48)


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("r", [2, 4])
def test_padded_plain_upsampler_matches_pallas(rng, r, bf16):
    """The plain version fed :func:`srvgg_up_weights` (the weight the
    tensor-core route reads) against JAX ``srvgg_up_fused`` in interpret
    mode, B = 2, nf 16, extents no block divides; the unpadded weight gives
    the same values, and so does the CPU wrapper."""
    from video_restore_tpu.ops.pallas_srvgg import srvgg_up_fused as jax_up

    b, h, w, nf = 2, 9, 13, 16
    feat = ((rng.random((b, h, w, nf)) - 0.5)).astype(np.float32)
    x_in = rng.random((b, h, w, 3)).astype(np.float32)
    w_out = ((rng.random((3, 3, nf, 3 * r * r)) - 0.5) * 0.3).astype(np.float32)
    b_out = ((rng.random(3 * r * r) - 0.5) * 0.1).astype(np.float32)
    if bf16:
        feat, x_in, w_out, b_out = (_bf16(a) for a in (feat, x_in, w_out, b_out))
    dt, jdt = (BF, jnp.bfloat16) if bf16 else (F32, jnp.float32)
    t = [torch.from_numpy(a).to(dt) for a in (feat, w_out, b_out, x_in)]
    padded = srvgg.srvgg_up_weights(t[1], r)
    assert padded.shape[-1] == srvgg.up_width(r)
    got = srvgg.srvgg_up_fused_plain(t[0], padded, t[2], t[3], r)
    assert got.shape == (b, r * h, r * w, 3) and got.dtype == dt
    assert torch.equal(got, srvgg.srvgg_up_fused_plain(t[0], t[1], t[2], t[3], r))
    _build.reset_launches()
    assert torch.equal(got, srvgg.srvgg_up_fused(t[0], padded, t[2], t[3], r))
    assert _build.launches() == {}
    ref = np.asarray(
        jax_up(*(jnp.asarray(a, jdt) for a in (feat, w_out, b_out, x_in)),
               r=r, block_h=4, interpret=True),
        np.float32,
    )
    got = got.float().numpy()
    if bf16:
        mag = np.maximum(np.abs(got), np.abs(ref))
        step = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert (np.abs(got - ref) <= step).all()
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_upsampler_rejects_a_weight_of_another_width():
    feat = torch.zeros(1, 4, 5, 16)
    x_in = torch.zeros(1, 4, 5, 3)
    b_out = torch.zeros(12)
    for width in (12, 16):
        srvgg.srvgg_up_fused_plain(feat, torch.zeros(3, 3, 16, width), b_out, x_in, 2)
    with pytest.raises(ValueError, match="do not map"):
        srvgg.srvgg_up_fused_plain(feat, torch.zeros(3, 3, 16, 14), b_out, x_in, 2)
    with pytest.raises(ValueError, match="do not map"):
        srvgg.srvgg_up_fused_plain(feat, torch.zeros(3, 3, 8, 12), b_out, x_in, 2)


def test_every_cuda_source_is_built():
    """One nvcc per source: each ``.cu`` under ``csrc/`` is in the build,
    the tensor-core sources of K5, K3 and K6, K1's narrow and wgmma sources,
    K5's wgmma source, the tail's wgmma source, K2's rows sources (fp32 and bf16, each its own
    translation unit), K5's fp32-FMA instances (each its own translation
    unit on ``rdb_fused.cuh``) and the fp32 ``bf16x3`` sources of K1, K5,
    the tail and K3 included."""
    on_disk = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.SOURCES) == on_disk
    assert {"rdb_fused_mma.cu", "srvgg_up_mma.cu", "tail_fused_mma.cu",
            "conv3x3_narrow.cu", "unsharp_rows.cu", "unsharp_rows_bf16.cu",
            "conv3x3_wgmma.cu", "rdb_fused_wgmma.cu", "rdb_fused_f32.cu",
            "rdb_fused_bf16.cu", "rdb_fused_narrow.cu", "tail_fused_wgmma.cu",
            "conv3x3_bf16x3_wgmma.cu", "rdb_fused_bf16x3.cu", "tail_fused_bf16x3.cu",
            "srvgg_up_bf16x3.cu"} <= set(on_disk)
