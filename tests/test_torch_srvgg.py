"""The port's SRVGGNetCompact against the JAX package.

- ``params_from_jax`` and the npz loader take the JAX pytree key for key;
- the model: the port's forward == ``apply_srvgg(stripe=False)`` at nf 16,
  num_conv 4, r 2 and 4, fp32 on both sides (tolerance 1e-4: fp32 sums in
  another order through 6 chained convs);
- the body: ``srvgg_body_plain`` == ``srvgg_stripe_padded`` and
  ``srvgg_stripe2d_padded`` (interpret mode), fp32 within 1e-4, bf16
  within one bf16 step of the output's largest value (both sides round the
  same fp32 sums after every conv; a sum near a rounding boundary may land
  one step away, and the next conv carries that step into its sums, so a
  small output value can move by more than its own step), with
  exact-zero pre-activations
  (JAX's PReLU tests ``x >= 0``, K1's ``x > 0``: equal at 0);
- the upsampler: ``srvgg_up_fused_plain`` == ``srvgg_up_fused`` and
  ``srvgg_up_fused_raw`` (interpret), r 2 and 4, fp32 within 1e-5, bf16
  within one bf16 step (one rounding of the same fp32 sum);
- the full-width ``RealESRGAN_x4_v3`` golden through the port's converter at
  >= 45 dB.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.models import zoo as port_zoo
from video_restore_tpu_torch.models.srvgg import (
    SRVGGNet,
    SRVGGSpec as PortSpec,
    params_from_jax,
)
from video_restore_tpu_torch.ops import _build
from video_restore_tpu_torch.ops.srvgg import (
    srvgg_body,
    srvgg_body_plain,
    srvgg_up_fused,
    srvgg_up_fused_plain,
)

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _mk(rng, *shape, scale=1.0, shift=0.0):
    return ((rng.random(shape) - 0.5) * 2 * scale + shift).astype(np.float32)


def _bf16(a):
    """numpy fp32 holding bf16-representable values (rounded once)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _within_one_bf16_step(got, ref, of_max=False):
    """|got - ref| <= one bf16 step (2^-7 relative) of the larger value,
    or of the largest value of ``ref`` when ``of_max``."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    mag = np.maximum(np.abs(got), np.abs(ref))
    if of_max:
        mag = np.full_like(mag, np.abs(ref).max())
    step = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    bad = np.abs(got - ref) > step
    assert not bad.any(), (np.abs(got - ref)[bad].max(), bad.sum())


def _jax_params(spec_kw, seed=3):
    """JAX ``init_srvgg`` weights scaled to an informative magnitude (the
    init's 0.1 gain makes the 32-conv body vanish) with non-zero biases and
    alphas."""
    from video_restore_tpu.models.srvgg import SRVGGSpec, init_srvgg

    spec = SRVGGSpec(**spec_kw)
    p = jax.tree.map(np.asarray, init_srvgg(jax.random.PRNGKey(seed), spec))
    rng = np.random.default_rng(seed)
    p["conv_in"]["w"] = p["conv_in"]["w"] * 10
    p["body"]["w"] = p["body"]["w"] * 10
    p["body"]["b"] = rng.normal(0, 0.02, p["body"]["b"].shape).astype(np.float32)
    p["body"]["alpha"] = rng.uniform(0.05, 0.4, p["body"]["alpha"].shape).astype(np.float32)
    p["conv_out"]["b"] = rng.normal(0, 0.02, p["conv_out"]["b"].shape).astype(np.float32)
    return spec, p


def test_params_from_jax_and_npz_key_for_key(tmp_path):
    from video_restore_tpu.models.zoo import random_model, save_params_npz

    spec_kw = dict(num_feat=16, num_conv=4, scale=4)
    _, params = _jax_params(spec_kw)
    sd = params_from_jax(params)
    net = SRVGGNet(PortSpec(**spec_kw))
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    np.testing.assert_array_equal(sd["body.w"].numpy(), params["body"]["w"])
    np.testing.assert_array_equal(sd["body.alpha"].numpy(), params["body"]["alpha"])
    np.testing.assert_array_equal(sd["alpha_in"].numpy(), params["alpha_in"])

    jm = random_model("RealESRGAN_x4_v3", seed=1)
    path = tmp_path / "RealESRGAN_x4_v3.npz"
    save_params_npz(jm.params, path)
    tree = port_zoo.load_params_npz("RealESRGAN_x4_v3", path)
    ref = jax.tree.map(np.asarray, jm.params)
    for k in ("w", "b", "alpha"):
        np.testing.assert_array_equal(tree["body"][k], ref["body"][k])
    np.testing.assert_array_equal(tree["conv_out"]["w"], ref["conv_out"]["w"])
    port_zoo.save_params_npz(tree, tmp_path / "again.npz")
    with np.load(path) as a, np.load(tmp_path / "again.npz") as b:
        assert set(a.files) == set(b.files)


@pytest.mark.parametrize("scale,h,w", [(4, 14, 18), (2, 16, 11)])
def test_model_matches_jax(rng, scale, h, w):
    from video_restore_tpu.models.srvgg import apply_srvgg

    spec_kw = dict(num_feat=16, num_conv=4, scale=scale)
    spec, params = _jax_params(spec_kw)
    x = rng.random((2, h, w, 3)).astype(np.float32)
    ref = np.asarray(
        apply_srvgg(jax.tree.map(jnp.asarray, params), jnp.asarray(x), spec,
                    stripe=False)
    )
    net = SRVGGNet(PortSpec(**spec_kw))
    net.load_state_dict(params_from_jax(params))
    got = net(_t(x), plain=True)
    assert got.shape == ref.shape == (2, h * scale, w * scale, 3)
    # the net is informative: far from the nearest-upsampled input
    near = np.repeat(np.repeat(x, scale, 1), scale, 2)
    assert np.abs(ref - near).mean() > 0.01
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    # the kernel forward on CPU tensors is the same plain computation
    np.testing.assert_array_equal(net(_t(x)).numpy(), got.numpy())


def _body_case(rng, g, nf, b, h, w, bf16):
    x = _mk(rng, b, h, w, nf, scale=0.5)
    ws = _mk(rng, g, 3, 3, nf, nf, scale=0.15)
    bs = _mk(rng, g, nf, scale=0.05)
    al = _mk(rng, g, nf, scale=0.2, shift=0.2)
    # channel 0 of every conv: zero weights and bias -> exact-zero
    # pre-activation through PReLU on both sides
    ws[..., 0] = 0.0
    bs[:, 0] = 0.0
    if bf16:
        x, ws, bs, al = (_bf16(a) for a in (x, ws, bs, al))
    return x, ws, bs, al


def _port_body(x, ws, bs, al, bf16):
    dt = torch.bfloat16 if bf16 else torch.float32
    out = srvgg_body_plain(*(_t(a).to(dt) for a in (x, ws, bs, al)))
    assert (out[..., 0] == 0).all()
    return out.float().numpy()


@pytest.mark.parametrize("bf16", [False, True])
def test_body_matches_pallas_stripe(rng, bf16):
    """Full-width stripe form (the tiled path's body, #16), B=2 tiles."""
    from video_restore_tpu.ops.pallas_srvgg import fold_dy, srvgg_stripe_padded
    from video_restore_tpu.ops.pallas_stripe import (
        pad_stripe_entry,
        unpad_stripe_exit,
    )

    g, nf, b, h, w, bh = 4, 16, 2, 20, 24, 8
    x, ws, bs, al = _body_case(rng, g, nf, b, h, w, bf16)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    xp = pad_stripe_entry(jnp.asarray(x, jdt), block_h=bh)
    o = srvgg_stripe_padded(
        xp, fold_dy(jnp.asarray(ws, jdt)), jnp.asarray(bs), jnp.asarray(al),
        frame_h=h, frame_w=w, group=g, block_h=bh, interpret=True,
    )
    ref = np.asarray(unpad_stripe_exit(o, h, w, nf, block_h=bh), np.float32)
    got = _port_body(x, ws, bs, al, bf16)
    if bf16:
        _within_one_bf16_step(got, ref, of_max=True)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bf16", [False, True])
def test_body_matches_pallas_stripe2d(rng, bf16):
    """2D-blocked form (the full-frame body, #15; #14 is its split
    launch), hp > h and wp > w."""
    from video_restore_tpu.ops.pallas_srvgg import fold_dy, srvgg_stripe2d_padded
    from video_restore_tpu.ops.pallas_stripe import (
        pad_stripe2d_entry,
        unpad_stripe2d_exit,
    )

    g, nf, b, h, w, bh, bw = 4, 16, 1, 56, 73, 24, 40
    x, ws, bs, al = _body_case(rng, g, nf, b, h, w, bf16)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    xp = pad_stripe2d_entry(jnp.asarray(x, jdt), block_h=bh, block_w=bw)
    o = srvgg_stripe2d_padded(
        xp, fold_dy(jnp.asarray(ws, jdt)), jnp.asarray(bs), jnp.asarray(al),
        frame_h=h, frame_w=w, group=g, block_h=bh, block_w=bw, interpret=True,
    )
    ref = np.asarray(
        unpad_stripe2d_exit(o, h, w, nf, block_h=bh, block_w=bw), np.float32
    )
    got = _port_body(x, ws, bs, al, bf16)
    if bf16:
        _within_one_bf16_step(got, ref, of_max=True)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def _up_case(rng, r, b, h, w, nf, bf16):
    feat = _mk(rng, b, h, w, nf, scale=0.5)
    x_in = rng.random((b, h, w, 3)).astype(np.float32)
    w_out = _mk(rng, 3, 3, nf, 3 * r * r, scale=0.15)
    b_out = _mk(rng, 3 * r * r, scale=0.05)
    if bf16:
        feat, x_in, w_out, b_out = (_bf16(a) for a in (feat, x_in, w_out, b_out))
    return feat, x_in, w_out, b_out


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("r", [2, 4])
def test_up_fused_matches_pallas(rng, r, bf16):
    """``srvgg_up_fused`` (#18, plain NHWC input, B=2 tiles) and
    ``srvgg_up_fused_raw`` (#17, the 2D-padded body array, hp > h and
    wp > w)."""
    from video_restore_tpu.ops.pallas_srvgg import (
        srvgg_up_fused as jax_up,
        srvgg_up_fused_raw,
    )
    from video_restore_tpu.ops.pallas_stripe import pad_stripe2d_entry

    jdt = jnp.bfloat16 if bf16 else jnp.float32
    dt = torch.bfloat16 if bf16 else torch.float32

    def check(got, ref):
        ref = np.asarray(ref, np.float32)
        if bf16:
            _within_one_bf16_step(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)

    nf = 16
    for b, h, w, raw in ((2, 12, 20, False), (1, 56, 73, True)):
        feat, x_in, w_out, b_out = _up_case(rng, r, b, h, w, nf, bf16)
        got = srvgg_up_fused_plain(
            *(_t(a).to(dt) for a in (feat, w_out, b_out, x_in)), r=r
        )
        assert got.shape == (b, r * h, r * w, 3) and got.dtype == dt
        got = got.float().numpy()
        jargs = [jnp.asarray(a, jdt) for a in (w_out, b_out, x_in)]
        if raw:
            bh2, bw2 = 24, 40
            xp = pad_stripe2d_entry(jnp.asarray(feat, jdt), block_h=bh2, block_w=bw2)
            ref = srvgg_up_fused_raw(
                xp, *jargs, r=r, frame_h=h, frame_w=w, block_h2=bh2,
                block_w2=bw2, interpret=True,
            )
        else:
            ref = jax_up(
                jnp.asarray(feat, jdt), *jargs, r=r, block_h=4, interpret=True
            )
        check(got, ref)


def test_wrappers_on_cpu_run_plain_and_reject_other_scales(rng):
    feat, x_in, w_out, b_out = _up_case(rng, 4, 1, 5, 7, 8, False)
    args = [_t(a) for a in (feat, w_out, b_out, x_in)]
    _build.reset_launches()
    assert torch.equal(srvgg_up_fused(*args, r=4), srvgg_up_fused_plain(*args, r=4))
    x, ws, bs, al = _body_case(rng, 3, 8, 1, 5, 7, False)
    body = [_t(a) for a in (x, ws, bs, al)]
    assert torch.equal(srvgg_body(*body), srvgg_body_plain(*body))
    assert _build.launches() == {}
    assert _build._lib is None
    f3, x3, w3, b3 = _up_case(rng, 3, 1, 5, 7, 8, False)
    with pytest.raises(ValueError, match="r must be one of"):
        srvgg_up_fused(_t(f3), _t(w3), _t(b3), _t(x3), r=3)


def test_full_width_golden_x4_v3(tmp_path):
    sys.path.insert(0, str(REPO / "tools"))
    import golden_parity

    name = "RealESRGAN_x4_v3"
    pth = golden_parity.synthetic_sr_checkpoint(name, tmp_path)
    handle = port_zoo.get_model(name, tmp_path)  # port converter, caches npz
    assert (tmp_path / f"{name}.npz").exists() and pth.exists()
    net = handle.module(torch.float32, "cpu")
    assert (net.spec.num_feat, net.spec.num_conv, net.spec.scale) == (64, 32, 4)
    x = golden_parity.golden_tiles()
    got = net(torch.from_numpy(x)).numpy()
    golden = np.load(REPO / "tests" / "goldens" / f"{name}.npz")["out"]
    psnr, ssim = golden_parity._scores(got, golden)
    assert psnr >= golden_parity.PSNR_PASS, psnr
    assert ssim >= golden_parity.SSIM_PASS, ssim
    # and again from the cached npz
    again = port_zoo.get_model(name, tmp_path).module(torch.float32, "cpu")
    np.testing.assert_array_equal(again(torch.from_numpy(x)).numpy(), got)
