"""The port's restore step against the JAX ``restore_step`` (XLA path, one
shard): two batches of ``tiny_frames`` with the temporal carry chained,
the enhanced stack on (bilateral 0.5, CLAHE on the LR input, unsharp 0.3,
temporal EMA) and a hard cut inside the second batch. The model is either
RRDBNet (nf 16, 1 block, the same weights on both sides) or a nearest-2x
"model" whose output follows its input, so that the cut survives the model
and the scene-cut branch runs. fp32 compute.

Tolerance: the float paths agree to ~1e-5, so u8 outputs may differ by one
level where a value sits at a rounding boundary: max 1 level, and at most
0.5% of the values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.models.rrdbnet import RRDBNet, RRDBNetSpec as PortSpec
from video_restore_tpu_torch.models.rrdbnet import params_from_jax
from video_restore_tpu_torch.ops.conv import upsample_nearest
from video_restore_tpu_torch.ops.tiles import TileGrid as PortGrid
from video_restore_tpu_torch.parallel import dispatch as port

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def _assert_u8_close(got, ref):
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 0.005, (d > 0).mean()


@pytest.mark.parametrize("model", ["rrdbnet", "nearest"])
def test_restore_step_matches_jax_with_carry_and_cut(tiny_frames, model):
    from video_restore_tpu.models.rrdbnet import (
        RRDBNetSpec,
        apply_rrdbnet,
        init_rrdbnet,
    )
    from video_restore_tpu.ops.tiles import TileGrid
    from video_restore_tpu.parallel.dispatch import StepConfig, restore_step

    frames = tiny_frames.copy()
    frames[6:] = 255 - frames[6:]  # hard cut between frames 5 and 6
    spec_kw = dict(num_feat=16, num_block=1, num_grow_ch=8, scale=2)
    spec = RRDBNetSpec(**spec_kw)
    params = init_rrdbnet(jax.random.PRNGKey(5), spec)
    h, w = frames.shape[1:3]

    cfg_kw = dict(
        denoise=0.5, sharpen=0.3, color_enhance=True, clahe_lr=True,
        temporal=True, temporal_strength=0.3, scene_cut_thresh=0.12,
        scene_cut_hist=0.35,
    )
    jgrid = TileGrid.build(h, w, tile=0, overlap=0, scale=2)
    jcarry = {
        "frame": jnp.zeros((1, 2 * h, 2 * w, 3), jnp.uint8),
        "valid": jnp.zeros((1,), jnp.float32),
    }

    net = RRDBNet(PortSpec(**spec_kw))
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    pgrid = PortGrid.build(h, w, tile=0, overlap=0, scale=2)
    pcarry = {
        "frame": torch.zeros((1, 2 * h, 2 * w, 3), dtype=torch.uint8),
        "valid": torch.zeros(1),
    }

    if model == "rrdbnet":
        jax_apply = lambda p, t: apply_rrdbnet(p, t, spec, naive=True)  # noqa: E731
        port_apply = net
    else:
        jax_apply = lambda p, t: jnp.repeat(jnp.repeat(t, 2, 1), 2, 2)  # noqa: E731
        port_apply = lambda t: upsample_nearest(t, 2)  # noqa: E731

    for batch in (frames[:4], frames[4:]):
        ref, jcarry = restore_step(
            params, jnp.asarray(batch), jcarry,
            model_apply=jax_apply,
            grid=jgrid, step_cfg=StepConfig(**cfg_kw),
            compute_dtype=jnp.float32, n_shards=1,
        )
        got, pcarry = port.restore_step(
            torch.from_numpy(batch), pcarry,
            model_apply=port_apply, grid=pgrid,
            step_cfg=port.StepConfig(**cfg_kw), compute_dtype=torch.float32,
        )
        assert got.shape == ref.shape == (4, 2 * h, 2 * w, 3)
        _assert_u8_close(got.numpy(), np.asarray(ref))
        _assert_u8_close(pcarry["frame"].numpy(), np.asarray(jcarry["frame"]))
        np.testing.assert_array_equal(
            pcarry["valid"].numpy(), np.asarray(jcarry["valid"])
        )

    if model == "rrdbnet":
        return  # random weights saturate the output: the cut may not survive
    # the cut frame passes through: a fresh-stream run of frame 6 alone
    # gives the same output as the chained run, and frame 5 (no cut) does not
    fresh = {
        "frame": torch.zeros((1, 2 * h, 2 * w, 3), dtype=torch.uint8),
        "valid": torch.zeros(1),
    }
    for i, cut in ((6, True), (5, False)):
        alone, _ = port.restore_step(
            torch.from_numpy(frames[i : i + 1]), dict(fresh),
            model_apply=port_apply, grid=pgrid,
            step_cfg=port.StepConfig(**cfg_kw), compute_dtype=torch.float32,
        )
        same = np.array_equal(alone[0].numpy(), got[i - 4].numpy())
        assert same == cut, i


def test_step_config_from_config_matches_jax():
    from video_restore_tpu.config import RestoreConfig
    from video_restore_tpu.parallel.dispatch import StepConfig

    from video_restore_tpu_torch.config import RestoreConfig as PortConfig

    for kw in (
        dict(enhanced_mode=True, denoise=0.5, sharpen=0.3),
        dict(enhanced_mode=False, denoise=0.2, sharpen=0.1, dither=True),
    ):
        ref = StepConfig.from_config(RestoreConfig(**kw))
        got = port.StepConfig.from_config(PortConfig(**kw))
        assert vars(got) == vars(ref)
