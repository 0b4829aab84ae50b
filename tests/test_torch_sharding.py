"""The port's multi-device restore step against the JAX package on its 8
virtual CPU devices (``tests/conftest.py``), on the CPU (nf 16 and nf 8
nets, frames of 48x64 and smaller):

- ``device_count`` and ``frame_mesh``: the same counts and the same
  "Requested N devices but only M available" error as JAX's;
- ``restore_step(n_shards=2, 4)`` against JAX's ``restore_step`` with the
  same numpy frames and weights: two batches with the carry chained, a hard
  cut, the enhanced stack (RRDBNet nf 16, or a nearest-2x "model"). The
  float paths agree to ~1e-5, so u8 values may differ by one level at a
  rounding boundary: max 1 level, on at most 0.5% of the values (as
  ``test_torch_step.py``); the carry's valid flags exactly;
- JAX's identity-model carry tests (``test_sharding.py:182-327``: an
  all-black previous frame is a valid previous frame, a cut passes the
  frame through, the histogram vetoes a motion false cut and confirms a
  real one, the stale carry of 8 shards still blends static content and
  gates moving content): each property holds for the port, and its bytes
  equal JAX's;
- ``ShardedUpscaler`` on ``[cpu] * D`` against JAX's on ``frame_mesh(D)``,
  frames and tiles mode, the enhanced stack with the temporal carry
  (SRVGG nf 8, seeded weights): 1 level on 0.5%, as above;
- the per-device path (one dispatch thread per shard, a carry row each)
  equal in bytes to one ``restore_step(n_shards=D)`` call on the batch;
  tiles mode equal in bytes to frames mode (no temporal: JAX's
  ``test_tile_sharded_matches_frame_sharded``); the indivisible batch's
  error;
- ``VideoRestorer`` over ``[cpu] * 2`` (frames, with the face pass and the
  outscale resize run on each shard's thread; tiles): the file equals the
  sharded upscaler's frames; ``auto_full_frame`` sized against the
  smallest device;
- one path for every mesh: one device is one shard on the caller's thread,
  frames mode a dispatch thread per device, tiles mode one per device but
  the first; ``close`` and the ``atexit`` finalizer end those threads and
  wait for them;
- the launch counters lose no count under many threads, and the TF32
  flags (``utils/device.py::tf32``) are held by one thread at a time.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.config import RestoreConfig as PConfig
from video_restore_tpu_torch.models import srvgg as port_srvgg
from video_restore_tpu_torch.models import zoo as port_zoo
from video_restore_tpu_torch.models.rrdbnet import RRDBNet, RRDBNetSpec as PortRRDBSpec
from video_restore_tpu_torch.models.rrdbnet import params_from_jax
from video_restore_tpu_torch.ops.conv import upsample_nearest
from video_restore_tpu_torch.ops.tiles import TileGrid as PGrid
from video_restore_tpu_torch.parallel import dispatch as port
from video_restore_tpu_torch.parallel import mesh as port_mesh

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _assert_u8_close(got, ref):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(ref).astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 0.005, (d > 0).mean()


# ---------------------------------------------------------------------------
# device_count and frame_mesh
# ---------------------------------------------------------------------------


def test_device_count_and_frame_mesh_match_jax():
    from video_restore_tpu.parallel import mesh as jax_mesh

    assert port_mesh.device_count(cpu=True) == 1
    assert port_mesh.device_count(1, cpu=True) == 1
    assert port_mesh.frame_mesh(cpu=True) == [CPU]
    assert port_mesh.frame_mesh(1, cpu=True) == [CPU]
    # an explicit list is taken as it is, repeats included (JAX's devices=)
    assert port_mesh.frame_mesh(devices=["cpu"] * 3) == [CPU] * 3
    assert jax_mesh.frame_mesh(devices=jax.devices()[:3]).devices.size == 3
    with pytest.raises(ValueError, match="empty"):
        port_mesh.frame_mesh(devices=[])
    # the same error text as JAX's, at its count of devices
    with pytest.raises(RuntimeError, match="Requested 9 devices but only 8 available"):
        jax_mesh.device_count(9)
    with pytest.raises(RuntimeError, match="Requested 9 devices but only 8 available"):
        jax_mesh.frame_mesh(9)
    with pytest.raises(RuntimeError, match="Requested 2 devices but only 1 available"):
        port_mesh.device_count(2, cpu=True)
    with pytest.raises(RuntimeError, match="Requested 2 devices but only 1 available"):
        port_mesh.frame_mesh(2, cpu=True)


def test_frame_mesh_without_cuda_refuses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.frame_mesh()
    assert port_mesh.device_count() == 1


# ---------------------------------------------------------------------------
# restore_step with carry shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("model", ["rrdbnet", "nearest"])
def test_restore_step_n_shards_matches_jax(tiny_frames, model, n_shards):
    from video_restore_tpu.models.rrdbnet import RRDBNetSpec, apply_rrdbnet, init_rrdbnet
    from video_restore_tpu.ops.tiles import TileGrid
    from video_restore_tpu.parallel.dispatch import StepConfig, restore_step

    frames = tiny_frames.copy()
    frames[6:] = 255 - frames[6:]  # hard cut between frames 5 and 6
    spec_kw = dict(num_feat=16, num_block=1, num_grow_ch=8, scale=2)
    # jitted: one compile instead of an eager dispatch per leaf
    params = jax.jit(init_rrdbnet, static_argnums=1)(jax.random.PRNGKey(5), RRDBNetSpec(**spec_kw))
    h, w = frames.shape[1:3]
    cfg_kw = dict(
        denoise=0.5, sharpen=0.3, color_enhance=True, clahe_lr=True,
        temporal=True, temporal_strength=0.3, scene_cut_thresh=0.12,
        scene_cut_hist=0.35,
    )
    jgrid = TileGrid.build(h, w, tile=0, overlap=0, scale=2)
    pgrid = PGrid.build(h, w, tile=0, overlap=0, scale=2)
    jcarry = {
        "frame": jnp.zeros((n_shards, 2 * h, 2 * w, 3), jnp.uint8),
        "valid": jnp.zeros((n_shards,), jnp.float32),
    }
    pcarry = {
        "frame": torch.zeros((n_shards, 2 * h, 2 * w, 3), dtype=torch.uint8),
        "valid": torch.zeros(n_shards),
    }
    if model == "rrdbnet":
        net = RRDBNet(PortRRDBSpec(**spec_kw))
        net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
        spec = RRDBNetSpec(**spec_kw)
        jax_apply = lambda p, t: apply_rrdbnet(p, t, spec, naive=True)  # noqa: E731
        port_apply = net
    else:
        jax_apply = lambda p, t: jnp.repeat(jnp.repeat(t, 2, 1), 2, 2)  # noqa: E731
        port_apply = lambda t: upsample_nearest(t, 2)  # noqa: E731
    for batch in (frames[:4], frames[4:]):
        ref, jcarry = restore_step(
            params, jnp.asarray(batch), jcarry, model_apply=jax_apply, grid=jgrid,
            step_cfg=StepConfig(**cfg_kw), compute_dtype=jnp.float32, n_shards=n_shards,
        )
        got, pcarry = port.restore_step(
            torch.from_numpy(batch), pcarry, model_apply=port_apply, grid=pgrid,
            step_cfg=port.StepConfig(**cfg_kw), compute_dtype=torch.float32,
            n_shards=n_shards,
        )
        assert got.shape == ref.shape == (4, 2 * h, 2 * w, 3)
        _assert_u8_close(got.numpy(), ref)
        assert pcarry["frame"].shape == (n_shards, 2 * h, 2 * w, 3)
        _assert_u8_close(pcarry["frame"].numpy(), jcarry["frame"])
        np.testing.assert_array_equal(pcarry["valid"].numpy(), np.asarray(jcarry["valid"]))


def test_restore_step_indivisible_batch_raises(tiny_frames):
    h, w = tiny_frames.shape[1:3]
    carry = {"frame": torch.zeros((3, 2 * h, 2 * w, 3), dtype=torch.uint8), "valid": torch.zeros(3)}
    with pytest.raises(ValueError, match="not divisible by 3"):
        port.restore_step(
            torch.from_numpy(tiny_frames[:4]), carry, model_apply=lambda t: upsample_nearest(t, 2),
            grid=PGrid.build(h, w, tile=0, overlap=0, scale=2),
            step_cfg=port.StepConfig(temporal=True), compute_dtype=torch.float32, n_shards=3,
        )


# ---- JAX's identity-model carry tests, both packages -----------------------


def _identity_steps(frames_u8, carry, *, strength=0.5, n_shards=1, cut=0.12, cut_hist=0.35):
    """One restore_step of each package with a nearest-2x "model" (pixel
    values exactly predictable); ``carry`` is a (jax, port) pair, or None
    for a fresh one. Returns ((jax out, jax carry), (port out, port carry))."""
    from video_restore_tpu.ops.tiles import TileGrid
    from video_restore_tpu.parallel.dispatch import StepConfig, restore_step

    h, w = frames_u8.shape[1:3]
    if carry is None:
        carry = (
            {"frame": jnp.zeros((n_shards, 2 * h, 2 * w, 3), jnp.uint8),
             "valid": jnp.zeros((n_shards,), jnp.float32)},
            {"frame": torch.zeros((n_shards, 2 * h, 2 * w, 3), dtype=torch.uint8),
             "valid": torch.zeros(n_shards)},
        )
    kw = dict(temporal=True, temporal_strength=strength, scene_cut_thresh=cut, scene_cut_hist=cut_hist)
    j = restore_step(
        None, jnp.asarray(frames_u8), carry[0],
        model_apply=lambda p, t: jnp.repeat(jnp.repeat(t, 2, axis=1), 2, axis=2).astype(jnp.float32),
        grid=TileGrid.build(h, w, 16, 4, 2), step_cfg=StepConfig(**kw),
        compute_dtype=jnp.float32, n_shards=n_shards,
    )
    p = port.restore_step(
        torch.from_numpy(np.ascontiguousarray(frames_u8)), carry[1],
        model_apply=lambda t: upsample_nearest(t, 2).float(),
        grid=PGrid.build(h, w, 16, 4, 2), step_cfg=port.StepConfig(**kw),
        compute_dtype=torch.float32, n_shards=n_shards,
    )
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(p[1]["frame"].numpy(), np.asarray(j[1]["frame"]))
    np.testing.assert_array_equal(p[1]["valid"].numpy(), np.asarray(j[1]["valid"]))
    return j, p


def _carry(j, p):
    return (j[1], p[1])


def _run_black_frame_is_valid_prev():
    """An all-black previous frame acts as a previous frame, not as the
    stream-start sentinel."""
    h, w = 32, 32
    black = np.zeros((1, h, w, 3), np.uint8)
    dim = np.full((1, h, w, 3), 10, np.uint8)
    j, p = _identity_steps(black, None)
    assert p[0].max() == 0 and float(p[1]["valid"][0]) == 1.0
    _, p1 = _identity_steps(dim, _carry(j, p))
    _, fresh = _identity_steps(dim, None)
    assert fresh[0].max() == 10
    assert p1[0].max() < 10  # blended toward the black previous frame


def _run_cut_passes_frame_through():
    h, w = 32, 32
    a = np.full((1, h, w, 3), 51, np.uint8)
    b = np.full((1, h, w, 3), 204, np.uint8)  # mean delta 0.6 >> 0.12
    j, p = _identity_steps(a, None)
    _, cut = _identity_steps(b, _carry(j, p))
    _, fresh = _identity_steps(b, None)
    assert torch.equal(cut[0], fresh[0])
    assert torch.equal(cut[1]["frame"][0], cut[0][0])


def _run_hist_vetoes_motion_false_cut():
    h, w = 32, 32
    base = np.full((1, h, w, 3), 100, np.uint8)
    nxt = base.copy()
    nxt[:, 0:4] += 2
    nxt[:, 8:24, 8:24] = 255  # mean delta ~0.15 trips, ~28% of the histogram moves
    raw = nxt.repeat(2, 1).repeat(2, 2)
    outs = {}
    for cut_hist in (0.35, 0.0):
        j, p = _identity_steps(base, None, strength=1.0)
        _, p1 = _identity_steps(nxt, _carry(j, p), strength=1.0, cut_hist=cut_hist)
        outs[cut_hist] = p1[0].numpy()
    assert outs[0.35][0, 0, 0, 0] < 102 and outs[0.35][0, 32, 32, 0] == 255
    np.testing.assert_array_equal(outs[0.0], raw)


def _run_hist_confirms_real_cut():
    h, w = 32, 32
    a = np.full((1, h, w, 3), 100, np.uint8)
    b = np.full((1, h, w, 3), 150, np.uint8)  # delta 0.196, tvd ~1
    j, p = _identity_steps(a, None, strength=1.0)
    _, p1 = _identity_steps(b, _carry(j, p), strength=1.0)
    np.testing.assert_array_equal(p1[0].numpy(), b.repeat(2, 1).repeat(2, 2))


def _run_stale_carry_gate():
    """D = 8: the carry is B - k + 1 = 8 frames old; static content still
    blends, steadily moving content is gated as in the sequential case."""
    h, w, d = 16, 16, 8
    base = np.full((d, h, w, 3), 100, np.uint8)
    j, p = _identity_steps(base, None, n_shards=d, strength=1.0)
    _, p1 = _identity_steps(base + 1, _carry(j, p), n_shards=d, strength=1.0)
    assert p1[0].max() < 101
    j, p = _identity_steps(base, None, n_shards=d, cut=1.0)
    far = base + 13
    _, p2 = _identity_steps(far, _carry(j, p), n_shards=d, cut=1.0)
    np.testing.assert_array_equal(p2[0].numpy(), far.repeat(2, 1).repeat(2, 2))


@pytest.mark.parametrize("case", [
    _run_black_frame_is_valid_prev, _run_cut_passes_frame_through,
    _run_hist_vetoes_motion_false_cut, _run_hist_confirms_real_cut, _run_stale_carry_gate,
], ids=lambda f: f.__name__[5:])
def test_identity_carry_semantics_match_jax(case):
    case()


# ---------------------------------------------------------------------------
# ShardedUpscaler
# ---------------------------------------------------------------------------


def _tiny_models(scale=2):
    """(JAX ModelHandle, port ModelHandle) of one SRVGG (nf 8, 2 convs)
    whose convs are at Kaiming scale plus a seeded perturbation (the JAX
    init's x0.1 leaves the net close to its nearest-upsampled input)."""
    from video_restore_tpu.models.srvgg import SRVGGSpec, init_srvgg
    from video_restore_tpu.models.zoo import ModelHandle

    spec = SRVGGSpec(num_feat=8, num_conv=2, scale=scale)
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: (np.asarray(a) * (10.0 if a.ndim >= 4 else 1.0)
                   + rng.normal(0, 0.02, a.shape)).astype(np.float32),
        init_srvgg(jax.random.PRNGKey(0), spec),
    )
    pspec = port_srvgg.SRVGGSpec(num_feat=8, num_conv=2, scale=scale)
    return (
        ModelHandle("tiny", spec, jax.tree.map(jnp.asarray, params)),
        port_zoo.ModelHandle("tiny", pspec, port_srvgg.params_from_jax(params)),
    )


_CFG = dict(model_name="RealESRGAN_x4_v3", tile_size=16, tile_overlap=4, precision="fp32",
            audio_copy=False)
_ENH = dict(enhanced_mode=True, denoise=0.5, sharpen=0.3, color_enhance=True, temporal=True)


@pytest.mark.parametrize("mode,d", [("frames", 2), ("frames", 4), ("tiles", 3)])
def test_sharded_upscaler_matches_jax(tiny_frames, mode, d):
    from video_restore_tpu.config import RestoreConfig
    from video_restore_tpu.ops.tiles import TileGrid
    from video_restore_tpu.parallel.dispatch import ShardedUpscaler
    from video_restore_tpu.parallel.mesh import frame_mesh

    jm, pm = _tiny_models()
    h, w = tiny_frames.shape[1:3]
    kw = dict(_CFG, **_ENH, shard_mode=mode)
    jups = ShardedUpscaler(jm, TileGrid.build(h, w, 16, 4, 2), RestoreConfig(**kw), frame_mesh(d))
    pups = port.ShardedUpscaler(pm, PGrid.build(h, w, 16, 4, 2), PConfig(**kw), [CPU] * d)
    assert pups.frames_per_batch == jups.frames_per_batch == (d if mode == "frames" else 1)
    b = pups.frames_per_batch
    for i in range(0, 2 * b if mode == "frames" else 4, b):  # the carry over batches
        ref = np.asarray(jups.process_batch(tiny_frames[i : i + b]))
        got = pups.process_batch(tiny_frames[i : i + b])
        assert got.dtype == torch.uint8 and got.shape == ref.shape == (b, 2 * h, 2 * w, 3)
        _assert_u8_close(got.numpy(), ref)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("yuv", [False, True])
def test_per_device_path_equals_one_n_shards_call(tiny_frames, d, yuv):
    """Each shard's thread runs the step on its chunk with its carry row;
    the bytes equal one ``restore_step(n_shards=D)`` call on the batch,
    over three batches (the carry chained, a hard cut in the last)."""
    _, pm = _tiny_models()
    h, w = tiny_frames.shape[1:3]
    frames = np.concatenate([tiny_frames, 255 - tiny_frames[:4]])
    cfg = PConfig(**_CFG, **_ENH)
    grid = PGrid.build(h, w, 16, 4, 2)
    pups = port.ShardedUpscaler(pm, grid, cfg, [CPU] * d, yuv420_out=yuv)
    one = port.Upscaler(pm, grid, cfg, CPU, yuv420_out=yuv)
    carry = {"frame": torch.zeros((d, 2 * h, 2 * w, 3), dtype=torch.uint8), "valid": torch.zeros(d)}
    for i in range(0, len(frames), d):
        got = pups.process_batch(frames[i : i + d])
        ref, carry = port.restore_step(
            torch.from_numpy(frames[i : i + d]), carry, model_apply=one.net, grid=grid,
            step_cfg=one.step_cfg, compute_dtype=torch.float32, n_shards=d,
        )
        assert torch.equal(got, ref), i
    rows = torch.cat([up._carry["frame"] for up in pups.shards])
    assert torch.equal(rows, carry["frame"])


def test_tiles_mode_equals_frames_mode(tiny_frames):
    """Tile shards (the frame's 20 tiles padded to 21, 7 per device) give
    the frames mode's bytes (JAX's ``test_tile_sharded_matches_frame_sharded``;
    the model's output per tile does not depend on the batch it ran in)."""
    _, pm = _tiny_models()
    h, w = tiny_frames.shape[1:3]
    grid = PGrid.build(h, w, 16, 4, 2)
    assert grid.n_tiles == 20
    frames_mode = port.ShardedUpscaler(pm, grid, PConfig(**_CFG), [CPU] * 8)
    tiles_mode = port.ShardedUpscaler(pm, grid, PConfig(**_CFG, shard_mode="tiles"), [CPU] * 3)
    assert tiles_mode.frames_per_batch == 1
    out_f = frames_mode.process_batch(tiny_frames)
    out_t = torch.cat([tiles_mode.process_batch(tiny_frames[i : i + 1]) for i in range(8)])
    assert torch.equal(out_f, out_t)


def test_tiled_apply_tile_sharding_pads_and_splits():
    """The padded tile batch is split into contiguous parts, one per
    device, and the padding's outputs are dropped (``tiles.py:386-394``)."""
    from video_restore_tpu_torch.ops.tiles import tiled_apply

    grid = PGrid.build(40, 40, 16, 4, 2)
    x = torch.rand(2, 40, 40, 3, generator=torch.Generator().manual_seed(0))
    seen = []

    class Parts:
        n_parts = 4

        def __call__(self, parts):
            seen.extend(p.shape[0] for p in parts)
            return [upsample_nearest(p, 2) for p in parts]

    ref = tiled_apply(lambda t: upsample_nearest(t, 2), x, grid)
    got = tiled_apply(None, x, grid, tile_sharding=Parts())
    assert sum(seen) == -(-2 * grid.n_tiles // 4) * 4 and len(set(seen)) == 1
    assert torch.equal(got, ref)


def test_indivisible_batch_raises(tiny_frames):
    """A batch that D does not divide raises (``dispatch.py:370-377``)."""
    _, pm = _tiny_models()
    ups = port.ShardedUpscaler(pm, PGrid.build(48, 64, 16, 4, 2), PConfig(**_CFG), [CPU] * 4)
    for b in (5, 6):
        with pytest.raises(ValueError, match=rf"batch {b} not divisible by 4 \(frames-sharded over 4 devices\)"):
            ups.process_batch(tiny_frames[:b])


# ---------------------------------------------------------------------------
# the runner over a device list
# ---------------------------------------------------------------------------


def _write_clip(path, frames):
    from video_restore_tpu_torch.video.y4m import Y4MWriter

    with Y4MWriter(path, frames.shape[2], frames.shape[1], 25) as wr:
        for f in frames:
            wr.write(f)


@pytest.mark.parametrize("kind", ["frames", "tiles", "frames_post"])
def test_runner_over_two_devices(tmp_path, tiny_frames, kind):
    """``VideoRestorer(mesh=[cpu] * 2)``: 5 frames (the last batch padded)
    through the pipeline equal the sharded upscaler's frames; with
    ``frames_post`` (RGB out) the face pass (the region heuristic, no
    faces found here, and each frame's boxes waited for) and the outscale
    resize run on each shard's thread."""
    from video_restore_tpu_torch.ops.resample import resize_lanczos4
    from video_restore_tpu_torch.pipeline.runner import VideoRestorer
    from video_restore_tpu_torch.video.y4m import Y4MReader

    _, pm = _tiny_models()
    frames = tiny_frames[:5]
    src = tmp_path / "in.y4m"
    _write_clip(src, frames)
    with Y4MReader(src) as rd:
        decoded = np.stack(list(rd))
    kw = dict(_CFG, **_ENH, shard_mode="tiles" if kind == "tiles" else "frames")
    if kind == "frames_post":
        kw.update(face_enhance=True, face_model="regions", outscale=1.5, device_yuv="off")
    cfg = PConfig(**kw)
    r = VideoRestorer(cfg, model=pm, mesh=[CPU] * 2)
    assert r.process_video(src, tmp_path / "out.npz", show_progress=False)
    st = r.last_stats
    assert st.decoded == st.inferred == st.encoded == 5
    (key, ups), = r._upscalers.items()
    assert isinstance(ups, port.ShardedUpscaler) and ups.n_devices == 2
    ups.reset_temporal()
    b = ups.frames_per_batch
    padded = np.concatenate([decoded, decoded[-1:]]) if b == 2 else decoded
    want = torch.cat([ups.process_batch(padded[i : i + b]) for i in range(0, len(padded), b)])[:5]
    if kind == "frames_post":
        assert "faces" in st.stages and "resize" in st.stages
        want = resize_lanczos4(want, (96, 72))
    got = np.load(tmp_path / "out.npz")["frames"]
    np.testing.assert_array_equal(got, want.numpy())


def test_runner_auto_full_frame_sizes_against_the_smallest_device(monkeypatch):
    """``auto_full_frame`` reads the smallest card of the mesh; shard mode
    "tiles" never takes full frame (``runner.py:204-206``). The 1080p
    flagship's estimate is 3.34 GiB (its one-launch tail keeps both
    64-channel intermediates on chip): it fits half of 80 GiB, not half of
    6 GiB."""
    from video_restore_tpu_torch.models.zoo import MODEL_ZOO, ModelHandle
    from video_restore_tpu_torch.pipeline import runner

    handle = ModelHandle("RealESRGAN_x4plus", MODEL_ZOO["RealESRGAN_x4plus"].spec, {})
    mem = {0: 80 << 30, 1: 6 << 30}
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (0, mem[torch.device(d).index]))

    class Fake:
        def __init__(self, model, grid, cfg, mesh, yuv420_out=False):
            self.grid = grid

    monkeypatch.setattr(runner, "ShardedUpscaler", Fake)
    for devs, mode, full in (([0, 0], "frames", True), ([0, 1], "frames", False), ([0, 0], "tiles", False)):
        cfg = PConfig(model_name="RealESRGAN_x4plus", full_frame="auto", tile_size=512, shard_mode=mode)
        r = runner.VideoRestorer(cfg, model=handle, mesh=[torch.device("cuda", i) for i in devs])
        assert (r._upscaler_for(1080, 1920).grid.n_tiles == 1) is full, (devs, mode)


def test_launch_counts_under_many_threads():
    """``_build.count_launch`` from more dispatch threads than cores, with a
    short switch interval: no count is lost (each wrapper counts from its
    shard's thread)."""
    import os
    import sys
    import threading

    from video_restore_tpu_torch.ops import _build

    n_threads, per = 4 * (os.cpu_count() or 2), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _build.reset_launches()
        threads = [threading.Thread(target=lambda: [_build.count_launch("k") for _ in range(per)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert _build.launches() == {"k": n_threads * per}
    finally:
        sys.setswitchinterval(old)
        _build.reset_launches()


@pytest.mark.parametrize("mode,d,threads", [("frames", 1, 0), ("frames", 2, 2), ("tiles", 1, 0), ("tiles", 3, 2)])
def test_dispatch_threads_per_mode(mode, d, threads):
    """One path for every mesh: a ``ShardedUpscaler`` over one device is one
    shard on the caller's thread (no dispatch thread); frames mode starts a
    thread per device, tiles mode one per device but the first (part 0 runs
    on the caller's thread). Exact counts."""
    _, pm = _tiny_models()
    ups = port.ShardedUpscaler(pm, PGrid.build(48, 64, 16, 4, 2), PConfig(**_CFG, shard_mode=mode), [CPU] * d)
    assert ups.frames_per_batch == (d if mode == "frames" else 1)
    assert len(ups.shards) == ups.frames_per_batch
    tiles = ups.shards[0].tile_sharding
    assert len(ups._workers) + (len(tiles.workers) if tiles is not None else 0) == threads
    assert (tiles is not None) == (mode == "tiles" and d > 1)


@pytest.mark.parametrize("mode,d", [("frames", 2), ("tiles", 3)])
def test_close_ends_the_dispatch_threads(tiny_frames, mode, d):
    """``ShardedUpscaler.close`` stops its dispatch threads and waits for
    them: none is alive when it returns, and a second close does nothing."""
    _, pm = _tiny_models()
    h, w = tiny_frames.shape[1:3]
    ups = port.ShardedUpscaler(pm, PGrid.build(h, w, 16, 4, 2), PConfig(**_CFG, shard_mode=mode), [CPU] * d)
    ups.process_batch(tiny_frames[: ups.frames_per_batch])
    tiles = ups.shards[0].tile_sharding
    threads = [w._thread for w in ups._workers + (tiles.workers if tiles is not None else [])]
    assert len(threads) == d - (mode == "tiles") and all(t.is_alive() for t in threads)
    ups.close()
    assert not any(t.is_alive() for t in threads)
    ups.close()


def test_dispatch_threads_end_before_interpreter_exit():
    """``tools/exit_check.py`` on the CPU: two processes, each keeping a
    frames-mode upscaler over ``[cpu] * 2`` alive to interpreter exit. Its
    ``atexit`` finalizer stops the dispatch threads and waits for them
    before the interpreter finalizes (a thread still leaving its CUDA
    contexts then is stopped inside PyTorch's C++ code, which aborts the
    process): each exits 0, and no dispatch thread is alive after the
    finalizers (exact)."""
    from video_restore_tpu_torch.tools import exit_check

    assert exit_check.main(["--cpu", "--runs", "2", "--parallel", "2", "--timeout", "120"]) == 0


def test_tf32_flags_are_held_by_one_thread_at_a_time():
    """``utils/device.py::tf32`` from two dispatch threads (each shard's
    face pass runs the GFPGAN prior inside it): the second thread's block
    starts only after the first's has ended, each sees its own setting
    inside, and the process's flags are back after both (exact)."""
    import threading
    import time

    from video_restore_tpu_torch.utils.device import tf32

    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, mm.allow_tf32
    cudnn.allow_tf32, mm.allow_tf32 = True, False
    inside, done_a = threading.Event(), threading.Event()
    seen = {}

    def a():
        with tf32(False):
            inside.set()
            time.sleep(0.2)  # b tries to enter meanwhile
            seen["a"] = (cudnn.allow_tf32, mm.allow_tf32)
            done_a.set()

    def b():
        inside.wait(10)
        with tf32(True):
            seen["b_after_a"] = done_a.is_set()
            seen["b"] = (cudnn.allow_tf32, mm.allow_tf32)

    try:
        threads = [threading.Thread(target=a), threading.Thread(target=b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert seen == {"a": (False, False), "b_after_a": True, "b": (True, True)}
        assert (cudnn.allow_tf32, mm.allow_tf32) == (True, False)
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = prev
