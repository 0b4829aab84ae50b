"""The port's GFPGAN v1-clean prior (``video_restore_tpu_torch/models/
gfpgan.py``) against the JAX package's ``models/gfpgan.py``, on the CPU.

- ``modulated_conv2d`` (plain, upsample, downsample, no demodulation)
  against JAX's on the same numpy inputs: 2e-5, as ``test_gfpgan.py`` holds
  JAX's to the torch reference.
- The forward at ``GFPGANSpec(out_size=64)`` (the full topology, 4 levels)
  against ``apply_gfpgan(init_gfpgan(PRNGKey(0)))``, the weights crossing
  through ``gfpgan_params_from_jax``: 1e-4.
- The key schema key for key and shape for shape; the converter against
  JAX's converter on the same synthetic state dict (equal tensors, and the
  forward above holds JAX's weights);
  the bad-shape refusal; ``init_gfpgan``'s geometry; the loader's refusal
  without weights and ``VRT_GFPGAN_RANDOM=1``.
- The schema-exact synthetic checkpoint and ``golden_tiles`` equal to
  ``tools/golden_parity.py``'s; one full-width 512 forward, loaded from a
  ``.pth`` through ``load_gfpgan``, against ``tests/goldens/GFPGANv1.4.npz``:
  >= 45 dB PSNR and SSIM >= 0.99 (the repo's golden bar), the scores also
  computed by the JAX package's metrics.
- ``gfpgan_flops`` equal to ``torch.utils.flop_counter``'s count.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu.models import gfpgan as jg
from video_restore_tpu_torch.models import gfpgan as pg

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = jg.GFPGANSpec(out_size=64)
PSMALL = pg.GFPGANSpec(out_size=64)


def _golden_parity():
    sys.path.insert(0, str(REPO / "tools"))
    import golden_parity

    return golden_parity


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _port_net(state, spec=PSMALL):
    net = pg.GFPGAN(spec)
    net.load_state_dict(state)
    return net.eval()


@pytest.mark.parametrize(
    "sample_mode,demodulate", [(None, True), ("upsample", True), ("downsample", True), (None, False)]
)
def test_modulated_conv_matches_jax(rng, sample_mode, demodulate):
    b, h, w, cin, cout = 2, 8, 8, 6, 5
    x = rng.random((b, h, w, cin)).astype(np.float32)
    wgt = rng.random((3, 3, cin, cout)).astype(np.float32) - 0.5
    style = rng.random((b, cin)).astype(np.float32) + 0.5
    want = np.asarray(
        jg.modulated_conv2d(jnp.asarray(x), jnp.asarray(wgt), jnp.asarray(style),
                            demodulate=demodulate, sample_mode=sample_mode)
    )
    got = pg.modulated_conv2d(
        _nchw(x), torch.from_numpy(wgt.transpose(3, 2, 0, 1).copy()), torch.from_numpy(style),
        demodulate=demodulate, sample_mode=sample_mode,
    )
    assert got.shape[2:] == want.shape[1:3]
    np.testing.assert_allclose(_nhwc(got), want, rtol=2e-5, atol=2e-5)


def test_forward_small_matches_jax(rng):
    params = jg.init_gfpgan(jax.random.PRNGKey(0), SMALL)
    x = rng.random((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jg.apply_gfpgan(params, jnp.asarray(x), SMALL))
    net = _port_net(pg.gfpgan_params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = _nhwc(net(_nchw(x)))
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert 0.0 <= got.min() and got.max() <= 1.0


@pytest.mark.parametrize("size", [64, 512])
def test_key_schema_matches_jax(size):
    want = jg.gfpgan_key_schema(jg.GFPGANSpec(out_size=size))
    got = pg.gfpgan_key_schema(pg.GFPGANSpec(out_size=size))
    assert list(got.items()) == list(want.items())
    # the module's state dict is the schema
    shapes = {k: tuple(v.shape) for k, v in pg.GFPGAN(pg.GFPGANSpec(out_size=size)).state_dict().items()}
    assert shapes == dict(got)


def test_converter_matches_jax(rng):
    schema = jg.gfpgan_key_schema(SMALL)
    sd = {k: (rng.standard_normal(v) * 0.1).astype(np.float32) for k, v in schema.items()}
    for k in sd:
        if k.endswith("modulation.bias"):
            sd[k] = np.ones(schema[k], np.float32)
    jp = jg.convert_gfpgan_state_dict(sd, SMALL)
    state = pg.convert_gfpgan_state_dict(sd, PSMALL)
    from_jax = pg.gfpgan_params_from_jax(jax.tree.map(np.asarray, jp))
    assert set(state) == set(from_jax)
    for k in state:
        assert torch.equal(state[k], from_jax[k]), k
    _port_net(state)  # loads


@pytest.mark.parametrize("key,bad", [("final_conv.weight", (1, 2, 3, 4)), (None, None)])
def test_converter_rejects_what_jax_rejects(key, bad):
    schema = jg.gfpgan_key_schema(SMALL)
    sd = {k: np.zeros(v, np.float32) for k, v in schema.items()}
    if key is None:  # a missing key
        del sd["stylegan_decoder.noises.noise3"]
        err, match = KeyError, "noise3"
    else:
        sd[key] = np.zeros(bad, np.float32)
        err, match = ValueError, key
    with pytest.raises(err, match=match):
        jg.convert_gfpgan_state_dict(sd, SMALL)
    with pytest.raises(err, match=match):
        pg.convert_gfpgan_state_dict(sd, PSMALL)


def test_init_geometry_matches_jax():
    want = pg.gfpgan_params_from_jax(
        jax.tree.map(np.asarray, jg.init_gfpgan(jax.random.PRNGKey(0), SMALL))
    )
    got = pg.init_gfpgan(PSMALL, torch.Generator().manual_seed(3))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k, v in got.items():  # the JAX init's constants
        if k.endswith("modulation.bias"):
            assert torch.equal(v, torch.ones_like(v)), k
        elif k.endswith(".bias") or (v.shape == (1,) and ".style_conv" in k):
            assert torch.equal(v, want[k]), k
    _port_net(got)  # loads


def test_load_gfpgan_never_downloads(tmp_path, monkeypatch):
    monkeypatch.delenv("VRT_GFPGAN_RANDOM", raising=False)
    with pytest.raises(RuntimeError, match="nothing is downloaded") as e:
        pg.load_gfpgan(tmp_path, spec=PSMALL)
    assert str(tmp_path / "GFPGANv1.4.pth") in str(e.value)
    monkeypatch.setenv("VRT_GFPGAN_RANDOM", "1")
    state, spec = pg.load_gfpgan(tmp_path, spec=PSMALL)
    assert spec == PSMALL and set(state) == set(pg.gfpgan_key_schema(PSMALL))


def test_precision_is_per_call():
    net = _port_net(pg.init_gfpgan(PSMALL))
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        # on the CPU the TF32 flags change nothing
        assert torch.equal(net(x, precision="tf32"), net(x))
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before
    with pytest.raises(ValueError, match="precision"):
        net(x, precision="bf16")


def test_synthetic_checkpoint_and_tiles_equal_golden_parity():
    gp = _golden_parity()
    want, _ = gp.synthetic_gfpgan_sd()
    got = pg.synthetic_gfpgan_sd()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    for args in ((), (11, 1, 512, 512)):
        assert np.array_equal(pg.golden_tiles(*args), gp.golden_tiles(*args))


def test_full_width_against_the_golden(tmp_path):
    """``GFPGANSpec()`` (512 px, 512 style features, channel multiplier 2)
    from the synthetic checkpoint written as a .pth and read back through
    ``load_gfpgan``, on ``golden_tiles(seed=11, 1, 512, 512)``."""
    from video_restore_tpu.metrics import frame_psnr, frame_ssim

    torch.save({"params_ema": {k: torch.from_numpy(v) for k, v in pg.synthetic_gfpgan_sd().items()}},
               tmp_path / "GFPGANv1.4.pth")
    state, spec = pg.load_gfpgan(tmp_path)
    assert spec == pg.GFPGANSpec()
    x = pg.golden_tiles(seed=11, n=1, h=512, w=512)
    with torch.no_grad():
        got = _nhwc(_port_net(state, spec)(_nchw(x)))
    ref = np.load(REPO / "tests" / "goldens" / "GFPGANv1.4.npz")["out"]
    assert got.shape == ref.shape == (1, 512, 512, 3)
    psnr, ssim = pg.golden_scores(got, ref)
    assert psnr >= 45.0 and ssim >= 0.99, (psnr, ssim)
    # the same scores by the JAX package's metrics (golden_parity._scores)
    ref64, got64 = ref.astype(np.float64), got.astype(np.float64)
    lo, span = ref64.min(), max(ref64.max() - ref64.min(), 1.0)
    a, b = (got64 - lo) / span * 255.0, (ref64 - lo) / span * 255.0
    assert psnr == pytest.approx(frame_psnr(a[0], b[0]), rel=1e-9)
    assert ssim == pytest.approx(frame_ssim(a[0], b[0]), rel=1e-9)


def test_flops_match_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    net = _port_net(pg.init_gfpgan(PSMALL)).requires_grad_(False)
    counter = FlopCounterMode(display=False)
    with counter:
        net(torch.rand(1, 3, 64, 64))
    assert pg.gfpgan_flops(PSMALL) == counter.get_total_flops()
    assert 390e9 < pg.gfpgan_flops() < 400e9  # one 512 crop
