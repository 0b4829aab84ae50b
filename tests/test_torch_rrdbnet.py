"""The port's RRDBNet and weight loading against the JAX model.

- ``params_from_jax`` maps the JAX pytree key for key and leaf for leaf;
- the port's npz loader reads what the JAX zoo writes;
- the port's plain forward == ``apply_rrdbnet(naive=True)`` at nf 16,
  2 blocks, for the scale-4, scale-2 (pixel-unshuffled stem) and
  single-upsample x2 variants, fp32 on both sides (tolerance 1e-4: fp32
  sums in another order through ~40 chained convs);
- the full-width goldens: a schema-exact synthetic checkpoint of each
  RRDBNet release (RealESRGAN_x4plus, x2plus, anime_6B, BSRGAN, BSRGANx2)
  goes through the port's own converter and forward and must reach the
  repo's golden bar, >= 45 dB against ``tests/goldens/<name>.npz``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.models.rrdbnet import (
    RRDBNet,
    RRDBNetSpec as PortSpec,
    params_from_jax,
)
from video_restore_tpu_torch.models import zoo as port_zoo

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _jax_params(spec_kw, seed=3):
    from video_restore_tpu.models.rrdbnet import RRDBNetSpec, init_rrdbnet

    spec = RRDBNetSpec(**spec_kw)
    params = init_rrdbnet(jax.random.PRNGKey(seed), spec)
    # non-zero biases so the bias path is checked too
    leaves, tdef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [
        np.asarray(a) + (rng.normal(0, 0.02, a.shape).astype(np.float32)
                         if a.ndim in (1, 2) else 0)
        for a in leaves
    ]
    return spec, jax.tree_util.tree_unflatten(tdef, leaves)


def test_params_from_jax_key_for_key():
    spec_kw = dict(num_feat=16, num_block=2, num_grow_ch=8, scale=4)
    _, params = _jax_params(spec_kw)
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    net = RRDBNet(PortSpec(**spec_kw))
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)  # shapes match the module
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    n = 0
    for kp, leaf in flat:
        keys = [k.key for k in kp]
        leaf = np.asarray(leaf)
        if keys[0] == "body":
            _, r, conv, wb = keys
            for i in range(leaf.shape[0]):
                np.testing.assert_array_equal(
                    sd[f"body.{i}.{r}.{conv}.{wb}"].numpy(), leaf[i]
                )
                n += 1
        else:
            np.testing.assert_array_equal(sd[".".join(keys)].numpy(), leaf)
            n += 1
    assert n == len(sd)


def test_npz_written_by_jax_zoo_loads(tmp_path):
    from video_restore_tpu.models.zoo import random_model, save_params_npz

    jm = random_model("RealESRGAN_x4plus_anime_6B", seed=1)
    path = tmp_path / "RealESRGAN_x4plus_anime_6B.npz"
    save_params_npz(jm.params, path)
    tree = port_zoo.load_params_npz("RealESRGAN_x4plus_anime_6B", path)
    ref = jax.tree.map(np.asarray, jm.params)
    np.testing.assert_array_equal(
        tree["body"]["rdb2"]["conv3"]["w"], ref["body"]["rdb2"]["conv3"]["w"]
    )
    np.testing.assert_array_equal(tree["conv_last"]["b"], ref["conv_last"]["b"])
    # and the port's writer round-trips through the same keys
    port_zoo.save_params_npz(tree, tmp_path / "again.npz")
    with np.load(path) as a, np.load(tmp_path / "again.npz") as b:
        assert set(a.files) == set(b.files)


@pytest.mark.parametrize(
    "spec_kw,h,w",
    [
        (dict(num_feat=16, num_block=2, num_grow_ch=8, scale=4), 14, 18),
        (dict(num_feat=16, num_block=2, num_grow_ch=8, scale=2), 16, 20),
        (dict(num_feat=16, num_block=2, num_grow_ch=8, scale=2,
              unshuffle=False, key_style="esrgan"), 12, 10),
    ],
)
def test_plain_forward_matches_naive(rng, spec_kw, h, w):
    from video_restore_tpu.models.rrdbnet import apply_rrdbnet

    spec, params = _jax_params(spec_kw)
    x = rng.random((2, h, w, 3)).astype(np.float32)
    ref = np.asarray(apply_rrdbnet(params, jnp.asarray(x), spec, naive=True))
    net = RRDBNet(PortSpec(**spec_kw))
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    got = net(torch.from_numpy(x), plain=True)
    assert got.shape == ref.shape == (2, h * spec.scale, w * spec.scale, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    # the kernel forward on CPU tensors is the same plain computation
    np.testing.assert_array_equal(net(torch.from_numpy(x)).numpy(), got.numpy())


def _golden_case(name, tmp_path):
    sys.path.insert(0, str(REPO / "tools"))
    import golden_parity

    pth = golden_parity.synthetic_sr_checkpoint(name, tmp_path)
    handle = port_zoo.get_model(name, tmp_path)  # port converter, caches npz
    assert (tmp_path / f"{name}.npz").exists()
    net = handle.module(torch.float32, "cpu")
    x = golden_parity.golden_tiles()
    got = net(torch.from_numpy(x)).numpy()
    golden = np.load(REPO / "tests" / "goldens" / f"{name}.npz")["out"]
    psnr, ssim = golden_parity._scores(got, golden)
    assert psnr >= golden_parity.PSNR_PASS, psnr
    assert ssim >= golden_parity.SSIM_PASS, ssim
    assert pth.exists()


def test_full_width_golden_x4plus(tmp_path):
    _golden_case("RealESRGAN_x4plus", tmp_path)


@pytest.mark.parametrize(
    "name",
    ["RealESRGAN_x2plus", "BSRGAN", "BSRGANx2", "RealESRGAN_x4plus_anime_6B"],
)
def test_full_width_golden_rrdb_releases(tmp_path, name):
    _golden_case(name, tmp_path)
