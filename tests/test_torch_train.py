"""The port's fine-tuning slice against the JAX package, on the CPU, from
the same numpy inputs and weights (nf 16, 2 RRDB blocks with gc 8; SRVGG
with 4 convs):

- the four losses (``l1_loss``, ``charbonnier_loss``, ``psnr``, ``ssim``):
  within 1e-6 (of the value, 1 for ``psnr``'s dB);
- ``forward_train`` of RRDBNet (scale 4; scale 2 with the pixel-unshuffle
  stem; scale 2 with one upsample stage) and of SRVGG (r 4 and 2) against
  ``ModelHandle.apply_fn(differentiable=True)``: within 1e-4 of the
  output's largest value (fp32 sums in another order through up to 37
  chained convs);
- the Charbonnier gradient of every leaf against ``jax.grad``: within 1e-4
  of the leaf's largest gradient;
- the Adam update against optax ``adam`` on the same gradients: within
  1e-6 relative per value (one formula, rounded in another order); three
  steps of ``make_train_step`` against the optax step on the same batches:
  the losses within 1e-5 relative, the weights within ``2 * steps * lr``
  absolute everywhere (a gradient within rounding of 0 may take Adam's
  step, which is +-lr whatever the gradient's size, the other way) and
  within 1e-6 absolute on 99.9% of the values;
- ``degrade_batch``: with the noise off, against JAX's blur and
  antialiased linear downscale at scales 2 and 4 and odd patch sizes,
  within 1e-6; with JAX's own noise passed in, against JAX's
  ``degrade_batch`` within 1e-6;
- ``params_to_jax`` is the inverse of ``params_from_jax``, and an ``.npz``
  the port writes gives the same output through the JAX zoo's loader and
  model (within 1e-4).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_restore_tpu.models import zoo as jax_zoo
from video_restore_tpu.models.rrdbnet import RRDBNetSpec, init_rrdbnet
from video_restore_tpu.models.srvgg import SRVGGSpec, init_srvgg
from video_restore_tpu.training import losses as jax_losses
from video_restore_tpu.training.train import degrade_batch as jax_degrade
from video_restore_tpu_torch.models import rrdbnet as port_rrdbnet
from video_restore_tpu_torch.models import srvgg as port_srvgg
from video_restore_tpu_torch.models import zoo as port_zoo
from video_restore_tpu_torch.training import losses as port_losses
from video_restore_tpu_torch.training.train import adam, degrade_batch, make_train_step

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

NETS = {
    "rrdb_x4": RRDBNetSpec(num_feat=16, num_block=2, num_grow_ch=8, scale=4),
    "rrdb_x2_unshuffle": RRDBNetSpec(num_feat=16, num_block=2, num_grow_ch=8, scale=2),
    "rrdb_x2_one_stage": RRDBNetSpec(
        num_feat=16, num_block=2, num_grow_ch=8, scale=2, unshuffle=False
    ),
    "srvgg_x4": SRVGGSpec(num_feat=16, num_conv=4, scale=4),
    "srvgg_x2": SRVGGSpec(num_feat=16, num_conv=4, scale=2),
}


def _port_spec(spec):
    if isinstance(spec, RRDBNetSpec):
        return port_rrdbnet.RRDBNetSpec(
            num_feat=spec.num_feat, num_block=spec.num_block,
            num_grow_ch=spec.num_grow_ch, scale=spec.scale, unshuffle=spec.unshuffle,
        )
    return port_srvgg.SRVGGSpec(num_feat=spec.num_feat, num_conv=spec.num_conv, scale=spec.scale)


def _jax_params(spec, seed=0):
    """Random JAX weights, every leaf perturbed so that no bias is 0; the
    SRVGG convs at Kaiming scale (the JAX init's x0.1 leaves the net close
    to its nearest-upsampled input)."""
    rrdb = isinstance(spec, RRDBNetSpec)
    init = init_rrdbnet if rrdb else init_srvgg
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), spec))
    rng = np.random.default_rng(seed)
    gain = 1.0 if rrdb else 10.0
    return jax.tree.map(
        lambda a: (a * (gain if a.ndim >= 4 else 1.0)
                   + rng.normal(0, 0.02, a.shape)).astype(np.float32),
        params,
    )


def _handles(name, seed=0):
    """(JAX ModelHandle, port ModelHandle) of the same weights."""
    spec = NETS[name]
    params = _jax_params(spec, seed)
    pspec = _port_spec(spec)
    arch = port_rrdbnet if isinstance(spec, RRDBNetSpec) else port_srvgg
    return (
        jax_zoo.ModelHandle(name, spec, jax.tree.map(jnp.asarray, params)),
        port_zoo.ModelHandle(name, pspec, arch.params_from_jax(params)),
    )


def _max_rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(1.0, np.abs(np.asarray(b)).max()))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["l1_loss", "charbonnier_loss", "psnr", "ssim"])
def test_losses_match_jax(name, rng):
    a = rng.random((2, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    for y in (b, a):  # apart, and equal (the floor of each loss)
        ref = float(getattr(jax_losses, name)(jnp.asarray(a), jnp.asarray(y)))
        got = float(getattr(port_losses, name)(torch.from_numpy(a), torch.from_numpy(y)))
        assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref)), (name, got, ref)


# ---------------------------------------------------------------------------
# the differentiable forwards and their gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(NETS))
def test_forward_train_matches_jax_differentiable(name, rng):
    jm, pm = _handles(name)
    x = rng.random((2, 12, 10, 3)).astype(np.float32)
    ref = np.asarray(jm.apply_fn(differentiable=True)(jm.params, jnp.asarray(x)))
    net = pm.train_module("cpu")
    got = net.forward_train(torch.from_numpy(x))
    assert got.requires_grad and got.dtype == torch.float32
    s = NETS[name].scale
    assert got.shape == ref.shape == (2, 12 * s, 10 * s, 3)
    assert _max_rel(got.detach().numpy(), ref) <= 1e-4


@pytest.mark.parametrize("name", ["rrdb_x4", "rrdb_x2_unshuffle", "rrdb_x2_one_stage", "srvgg_x4"])
def test_charbonnier_gradients_match_jax_grad(name, rng):
    """The targets sit at least 0.05 from JAX's output, on either side:
    Charbonnier with eps 1e-6 is L1 within 1e-6 of a zero difference, and
    each value's gradient term jumps from -1/N to +1/N there, so a target
    within the forwards' rounding (~1e-5 at these magnitudes) of the output
    would flip terms by 2/N whichever backward pass ran."""
    jm, pm = _handles(name, seed=1)
    x = rng.random((2, 8, 10, 3)).astype(np.float32)
    fn = jm.apply_fn(differentiable=True)
    y = np.asarray(fn(jm.params, jnp.asarray(x)))
    gap = (0.05 + 0.2 * rng.random(y.shape)) * rng.choice([-1.0, 1.0], y.shape)
    hr = (y + gap).astype(np.float32)
    gj = jax.grad(lambda p: jax_losses.charbonnier_loss(fn(p, jnp.asarray(x)), jnp.asarray(hr)))(jm.params)
    net = pm.train_module("cpu")
    port_losses.charbonnier_loss(net.forward_train(torch.from_numpy(x)), torch.from_numpy(hr)).backward()
    arch = port_rrdbnet if isinstance(NETS[name], RRDBNetSpec) else port_srvgg
    gp = arch.params_to_jax({k: p.grad for k, p in net.named_parameters()})
    flat_j = dict(jax.tree_util.tree_flatten_with_path(gj)[0])
    flat_p = dict(jax.tree_util.tree_flatten_with_path(gp)[0])
    assert flat_j.keys() == flat_p.keys()
    for k, a in flat_j.items():
        a, b = np.asarray(a), flat_p[k]
        scale = np.abs(a).max()
        assert scale > 0, k
        assert np.abs(a - b).max() <= 1e-4 * scale, (jax.tree_util.keystr(k), np.abs(a - b).max(), scale)


# ---------------------------------------------------------------------------
# Adam and the train step
# ---------------------------------------------------------------------------


def test_adam_update_equals_optax_adam():
    """The same gradient sequence (values from 1e-10 to 1, both signs)
    through ``train.adam`` and optax ``adam``: the weights agree within
    1e-6 relative to the step size after every step."""
    rng = np.random.default_rng(5)
    lr = 1e-3
    w0 = rng.normal(0, 1, 4096).astype(np.float32)
    grads = [
        (rng.normal(0, 1, 4096) * 10.0 ** rng.uniform(-10, 0, 4096)).astype(np.float32)
        for _ in range(6)
    ]
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = adam([p], lr)
    tx = optax.adam(lr)
    wj = jnp.asarray(w0)
    state = tx.init(wj)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state, wj)
        wj = optax.apply_updates(wj, upd)
        d = np.abs(p.detach().numpy() - np.asarray(wj)).max()
        assert d <= 1e-6 * lr + 2 * np.spacing(np.float32(np.abs(w0).max())), d


@pytest.mark.parametrize("name", ["rrdb_x4", "srvgg_x4"])
def test_three_train_steps_match_optax(name, rng):
    jm, pm = _handles(name, seed=2)
    s = NETS[name].scale
    lr_rate, steps = 1e-3, 3
    batches = [
        (rng.random((2, 8, 8, 3)).astype(np.float32),
         rng.random((2, 8 * s, 8 * s, 3)).astype(np.float32))
        for _ in range(steps)
    ]
    tx = optax.adam(lr_rate)
    fn = jm.apply_fn(differentiable=True)

    def loss(p, lr, hr):
        return jax_losses.charbonnier_loss(fn(p, lr), hr)

    params, opt_state, jax_losses_ = jm.params, tx.init(jm.params), []
    for lr, hr in batches:
        val, g = jax.value_and_grad(loss)(params, jnp.asarray(lr), jnp.asarray(hr))
        upd, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
        jax_losses_.append(float(val))
    net = pm.train_module("cpu")
    step = make_train_step(net, adam(net.parameters(), lr_rate))
    port = [float(step(torch.from_numpy(lr), torch.from_numpy(hr))) for lr, hr in batches]
    np.testing.assert_allclose(port, jax_losses_, rtol=1e-5)
    arch = port_rrdbnet if isinstance(NETS[name], RRDBNetSpec) else port_srvgg
    got = jax.tree.leaves(arch.params_to_jax(net.state_dict()))
    want = [np.asarray(a) for a in jax.tree.leaves(params)]
    d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, want)])
    assert d.max() <= 2 * steps * lr_rate, d.max()
    assert np.mean(d <= 1e-6) >= 0.999, np.mean(d <= 1e-6)


# ---------------------------------------------------------------------------
# the degradation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale,h,w", [(2, 33, 45), (4, 32, 32), (4, 37, 50), (2, 128, 128)])
def test_degrade_batch_matches_jax(scale, h, w, rng):
    from video_restore_tpu.ops.post import gaussian_blur

    hr = rng.random((3, h, w, 3)).astype(np.float32)
    shape = (3, h // scale, w // scale, 3)
    ref = jnp.clip(jax.image.resize(gaussian_blur(jnp.asarray(hr), 0.8, 2), shape, method="linear"), 0, 1)
    got = degrade_batch(torch.from_numpy(hr), scale, noise=torch.zeros(shape))
    assert got.shape == shape
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6
    # the whole function, JAX's own noise passed in
    key = jax.random.PRNGKey(h * w + scale)
    noise = jax.random.normal(jax.random.split(key)[1], shape, jnp.float32)
    ref = jax_degrade(key, jnp.asarray(hr), scale)
    got = degrade_batch(torch.from_numpy(hr), scale, noise=torch.from_numpy(np.array(noise)))
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6


def test_degrade_batch_draws_from_the_generator():
    hr = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    a = degrade_batch(hr, 2, generator=torch.Generator().manual_seed(7))
    b = degrade_batch(hr, 2, generator=torch.Generator().manual_seed(7))
    c = degrade_batch(hr, 2, generator=torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= 0 and a.max() <= 1


# ---------------------------------------------------------------------------
# the weights back to the JAX layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["rrdb_x4", "rrdb_x2_one_stage", "srvgg_x4"])
def test_params_to_jax_inverts_params_from_jax(name):
    spec = NETS[name]
    params = _jax_params(spec)
    arch = port_rrdbnet if isinstance(spec, RRDBNetSpec) else port_srvgg
    back = arch.params_to_jax(arch.params_from_jax(params))
    a = jax.tree_util.tree_flatten_with_path(params)
    b = jax.tree_util.tree_flatten_with_path(back)
    assert a[1] == b[1]  # the same tree: no conv_up2 for one upsample stage
    for (ka, la), (kb, lb) in zip(a[0], b[0]):
        assert ka == kb and lb.dtype == np.float32 and np.array_equal(la, lb)


@pytest.mark.parametrize("model", ["RealESRGAN_x4_v3", "RealESRGAN_x4plus_anime_6B"])
def test_port_npz_through_the_jax_zoo(model, tmp_path, rng):
    """Weights the port trained a step on, written by the port's
    ``save_params_npz``, load through the JAX zoo (full width) and give the
    port's output."""
    pm = port_zoo.random_model(model, seed=3)
    net = pm.train_module("cpu")
    step = make_train_step(net, adam(net.parameters(), 1e-3))
    step(torch.rand(1, 6, 6, 3), torch.rand(1, 24, 24, 3))
    trained = port_zoo.ModelHandle(model, pm.spec, {k: v.detach() for k, v in net.state_dict().items()})
    path = tmp_path / f"{model}.npz"
    port_zoo.save_params_npz(trained.jax_params(), path)
    jm = jax_zoo.get_model(model, tmp_path, allow_download=False)
    x = rng.random((1, 6, 7, 3)).astype(np.float32)
    ref = np.asarray(jm.apply_fn(differentiable=True)(jm.params, jnp.asarray(x)))
    back = port_zoo.get_model(model, tmp_path)
    got = back.train_module("cpu").forward_train(torch.from_numpy(x)).detach().numpy()
    assert _max_rel(got, ref) <= 1e-4
    for k, v in trained.state.items():
        assert torch.equal(back.state[k], v), k
