"""The port's tile engine against the JAX package's ``ops/tiles.py``.

- ``ramp_window``, the grid plans (offsets, extents, pads) and each axis's
  ``window``/``norm`` vectors are equal to JAX's (exact: the same float64
  numpy code);
- ``auto_tile_chunk`` and ``auto_full_frame`` (at a fixed device memory)
  make the same choices;
- ``tiled_apply`` == JAX ``tiled_apply`` with the same simple model (a 3x3
  conv followed by a nearest upsample, the same numpy weights on both
  sides), seamless and legacy, at 1x1, 2x3 and other grids and odd frame
  sizes, with and without chunking: fp32, 1e-5 (both sides blend the same
  fp32 values; the conv sums in another order);
- the restore step on a tiled grid for each model family against the JAX
  ``restore_step`` (u8 within 1 level on <= 0.5% of the values, as in
  ``test_torch_step.py``);
- the runner picks full frame or tiles as the JAX runner does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.ops import tiles as pt

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

GRIDS = [
    # (h, w, tile, overlap, scale, mode, chunk)
    (37, 53, 0, 8, 2, "seamless", 0),  # tile 0: one padded tile (odd dims)
    (36, 60, 0, 8, 2, "seamless", 0),  # one exact tile: no blend
    (48, 64, 32, 8, 2, "seamless", 0),  # 2x3
    (48, 64, 32, 8, 2, "seamless", 4),  # 2x3 in chunks of 4 (last padded)
    (33, 45, 16, 4, 2, "seamless", 0),  # odd frame
    (40, 56, 16, 4, 1, "legacy", 0),
    (37, 53, 16, 6, 2, "legacy", 5),
    (20, 26, 16, 8, 2, "legacy", 0),  # legacy pads >= the frame: edge mode
]


def _jax_grid(h, w, tile, overlap, scale, mode, chunk):
    from video_restore_tpu.ops.tiles import TileGrid

    return TileGrid.build(h, w, tile, overlap, scale, mode=mode, tile_chunk=chunk)


@pytest.mark.parametrize("case", GRIDS)
def test_grid_plan_window_and_norm_equal_jax(case):
    jg = _jax_grid(*case)
    pg = pt.TileGrid.build(*case[:5], mode=case[5], tile_chunk=case[6])
    for ja, pa in ((jg.rows, pg.rows), (jg.cols, pg.cols)):
        assert (pa.dim, pa.extract, pa.offsets, pa.padded, pa.lead) == (
            ja.dim, ja.extract, ja.offsets, ja.padded, ja.lead
        )
        args = (pg.scale, pg.mode, pg.halo, pg.overlap)
        np.testing.assert_array_equal(pa.window(*args), ja.window(*args))
        np.testing.assert_array_equal(pa.norm(*args), ja.norm(*args))
    assert (pg.n_tiles, pg.halo, pg.tile_shape) == (jg.n_tiles, jg.halo, jg.tile_shape)


def test_ramp_window_equal_jax():
    from video_restore_tpu.ops.tiles import ramp_window

    for size, ramp in ((64, 16), (40, 32), (7, 3), (10, 0), (1536, 128)):
        np.testing.assert_array_equal(pt.ramp_window(size, ramp), ramp_window(size, ramp))


def test_auto_choices_equal_jax():
    from video_restore_tpu.ops.tiles import auto_full_frame, auto_tile_chunk

    for eh, ew, s, n in ((384, 504, 4, 12), (376, 448, 4, 6), (512, 512, 2, 9),
                         (1024, 1024, 4, 2), (64, 64, 4, 7), (600, 900, 4, 7)):
        assert pt.auto_tile_chunk(eh, ew, s, n) == auto_tile_chunk(eh, ew, s, n)
    for h, w, s, frames in ((1080, 1920, 4, 1), (2160, 3840, 4, 1),
                            (1080, 1920, 4, 8), (720, 1280, 2, 2)):
        for dev_bytes in (80 * 10**9, 16 << 30, 4 << 30):
            assert pt.auto_full_frame(h, w, s, dev_bytes, frames=frames) == (
                auto_full_frame(h, w, s, dev_bytes, frames=frames)
            )


def _model_pair(rng, scale):
    """The same model on both sides: SAME 3x3 conv (3 -> 3) + bias, then a
    nearest ``scale``x upsample."""
    from video_restore_tpu.ops.conv import conv2d as jconv

    from video_restore_tpu_torch.ops.conv import conv2d as tconv

    w = (rng.standard_normal((3, 3, 3, 3)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(3) * 0.1).astype(np.float32)
    jw, jb = jnp.asarray(w), jnp.asarray(b)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)

    def jmodel(t):
        y = jconv(t, jw, jb)
        return jnp.repeat(jnp.repeat(y, scale, 1), scale, 2)

    def tmodel(t):
        y = tconv(t, tw, tb)
        return y.repeat_interleave(scale, 1).repeat_interleave(scale, 2)

    return jmodel, tmodel


@pytest.mark.parametrize("case", GRIDS)
def test_tiled_apply_matches_jax(rng, case):
    from video_restore_tpu.ops.tiles import tiled_apply

    h, w, tile, overlap, scale, mode, chunk = case
    jmodel, tmodel = _model_pair(rng, scale)
    x = rng.random((2, h, w, 3)).astype(np.float32)
    ref = np.asarray(tiled_apply(jmodel, jnp.asarray(x), _jax_grid(*case)))
    calls = []

    def counted(t):
        calls.append(t.shape[0])
        return tmodel(t)

    pg = pt.TileGrid.build(h, w, tile, overlap, scale, mode=mode, tile_chunk=chunk)
    got = pt.tiled_apply(counted, torch.from_numpy(x), pg)
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (2, h * scale, w * scale, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # one model call per chunk of the frames' tiles, every call the same
    # batch size (the last chunk zero-padded)
    n = 2 * pg.n_tiles
    assert len(calls) == (1 if chunk == 0 or chunk >= n else -(-n // chunk))
    assert len(set(calls)) == 1
    if chunk:
        assert pg.n_chunks == -(-pg.n_tiles // chunk)  # per frame


def test_tiled_apply_bf16_tiles_in_fp32_out(rng):
    """The model gets compute-dtype tiles; the blend returns fp32."""
    seen = []

    def model(t):
        seen.append(t.dtype)
        return t.repeat_interleave(2, 1).repeat_interleave(2, 2)

    g = pt.TileGrid.build(48, 64, 32, 8, 2)
    x = torch.from_numpy(rng.random((1, 48, 64, 3)).astype(np.float32))
    out = pt.tiled_apply(model, x.bfloat16(), g)
    assert seen == [torch.bfloat16] and out.dtype == torch.float32
    ref = x.bfloat16().float().repeat_interleave(2, 1).repeat_interleave(2, 2)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)


def _srvgg_pair(seed=4):
    from video_restore_tpu.models.srvgg import SRVGGSpec, apply_srvgg, init_srvgg

    from video_restore_tpu_torch.models.srvgg import (
        SRVGGNet,
        SRVGGSpec as PortSpec,
        params_from_jax,
    )

    kw = dict(num_feat=16, num_conv=4, scale=2)
    spec = SRVGGSpec(**kw)
    p = jax.tree.map(np.asarray, init_srvgg(jax.random.PRNGKey(seed), spec))
    for k in ("conv_in", "body", "conv_out"):  # informative magnitude
        p[k]["w"] = p[k]["w"] * 10
    net = SRVGGNet(PortSpec(**kw))
    net.load_state_dict(params_from_jax(p))
    jp = jax.tree.map(jnp.asarray, p)
    return jp, (lambda q, t: apply_srvgg(q, t, spec, stripe=False)), net


def _rrdb_pair(seed=5):
    from video_restore_tpu.models.rrdbnet import (
        RRDBNetSpec,
        apply_rrdbnet,
        init_rrdbnet,
    )

    from video_restore_tpu_torch.models.rrdbnet import (
        RRDBNet,
        RRDBNetSpec as PortSpec,
        params_from_jax,
    )

    kw = dict(num_feat=16, num_block=1, num_grow_ch=8, scale=2)
    spec = RRDBNetSpec(**kw)
    jp = init_rrdbnet(jax.random.PRNGKey(seed), spec)
    net = RRDBNet(PortSpec(**kw))
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    return jp, (lambda q, t: apply_rrdbnet(q, t, spec, naive=True)), net


@pytest.mark.parametrize("family", ["rrdbnet", "srvgg"])
@pytest.mark.parametrize("mode", ["seamless", "legacy"])
def test_tiled_restore_step_matches_jax(tiny_frames, family, mode):
    from video_restore_tpu.ops.tiles import TileGrid
    from video_restore_tpu.parallel.dispatch import StepConfig, restore_step

    from video_restore_tpu_torch.parallel import dispatch as port

    frames = tiny_frames[:4].copy()
    frames[3:] = 255 - frames[3:]  # hard cut
    h, w = frames.shape[1:3]
    jp, japply, net = _rrdb_pair() if family == "rrdbnet" else _srvgg_pair()
    cfg_kw = dict(
        denoise=0.5, sharpen=0.3, color_enhance=True, clahe_lr=True,
        temporal=True, temporal_strength=0.3, scene_cut_thresh=0.12,
        scene_cut_hist=0.35,
    )
    jgrid = TileGrid.build(h, w, tile=32, overlap=8, scale=2, mode=mode, tile_chunk=4)
    pgrid = pt.TileGrid.build(h, w, tile=32, overlap=8, scale=2, mode=mode, tile_chunk=4)
    assert pgrid.n_tiles > 1
    ref, _ = restore_step(
        jp, jnp.asarray(frames),
        {"frame": jnp.zeros((1, 2 * h, 2 * w, 3), jnp.uint8),
         "valid": jnp.zeros((1,), jnp.float32)},
        model_apply=japply, grid=jgrid, step_cfg=StepConfig(**cfg_kw),
        compute_dtype=jnp.float32, n_shards=1,
    )
    got, _ = port.restore_step(
        torch.from_numpy(frames),
        {"frame": torch.zeros((1, 2 * h, 2 * w, 3), dtype=torch.uint8),
         "valid": torch.zeros(1)},
        model_apply=net, grid=pgrid, step_cfg=port.StepConfig(**cfg_kw),
        compute_dtype=torch.float32,
    )
    assert got.shape == ref.shape == (4, 2 * h, 2 * w, 3)
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 0.005, (d > 0).mean()


@pytest.mark.parametrize(
    "cfg_kw,tiled",
    [
        (dict(tile_size=32, tile_overlap=8, full_frame="auto"), True),
        (dict(tile_size=32, tile_overlap=8, full_frame="on"), False),
        (dict(tile_size=32, tile_overlap=8, full_frame="on", legacy_tiling=True), True),
        (dict(tile_size=0, tile_overlap=8), False),
    ],
)
def test_runner_picks_tiles_as_jax_on_cpu(cfg_kw, tiled):
    """full_frame "on" takes one tile, legacy tiling keeps its tiles, and
    "auto" on the CPU keeps the tiles (no device memory to size against;
    the JAX runner upgrades only with its TPU body kernels). The chunk is
    ``auto_tile_chunk``'s."""
    from video_restore_tpu_torch.config import RestoreConfig
    from video_restore_tpu_torch.models.zoo import random_model
    from video_restore_tpu_torch.pipeline.runner import VideoRestorer

    cfg = RestoreConfig(model_name="RealESRGAN_x4_v3", **cfg_kw)
    r = VideoRestorer(cfg, model=random_model("RealESRGAN_x4_v3"), cpu=True)
    grid = r._upscaler_for(100, 140).grid
    assert (grid.n_tiles > 1) == tiled
    assert grid.tile_chunk == pt.auto_tile_chunk(
        grid.rows.extract, grid.cols.extract, 4, grid.n_tiles
    )
