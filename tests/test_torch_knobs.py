"""The two remaining backend-neutral JAX knobs on the port: ``VRT_HBM_BYTES``
(the device bytes that the full-frame decision sizes against) and
``VRT_PRECISION`` (the body precision when the caller names none), each
against the JAX package's behaviour.

Decisions are compared exactly: the same ``auto_full_frame`` answer and the
same tile grid as JAX's at the same pinned budget, the same
``default_precision`` or the same ``ValueError``. A model prepared with no
precision under ``VRT_PRECISION=int8`` is held ``torch.equal`` to one
prepared with ``precision="int8"`` (the same module, so the same bits).
"""

import numpy as np
import pytest
import torch

from video_restore_tpu_torch.config import RestoreConfig as PConfig
from video_restore_tpu_torch.models import rrdbnet as port_rrdbnet
from video_restore_tpu_torch.models.rrdbnet import RRDBNet, RRDBNetSpec
from video_restore_tpu_torch.models.srvgg import SRVGGNet, SRVGGSpec
from video_restore_tpu_torch.models.zoo import ModelHandle
from video_restore_tpu_torch.ops import tiles as port_tiles

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

GB80 = 80 * 10**9


# ---- VRT_HBM_BYTES ---------------------------------------------------------------


@pytest.mark.parametrize("env,total,want", [
    ("17179869184", GB80, 16 << 30),  # digits: the cap
    ("1000", GB80, 1000),
    (None, GB80, GB80),  # unset: the device's total
    ("", GB80, GB80),
    ("16G", GB80, GB80),  # not digits: ignored, as JAX ignores it
])
def test_device_budget(monkeypatch, env, total, want):
    if env is None:
        monkeypatch.delenv("VRT_HBM_BYTES", raising=False)
    else:
        monkeypatch.setenv("VRT_HBM_BYTES", env)
    assert port_tiles.device_budget(total) == want


@pytest.mark.parametrize("budget", [1 << 30, 8 << 30, 16 << 30, 80 << 30])
@pytest.mark.parametrize("h,w,s,frames", [(24, 32, 4, 1), (720, 1280, 4, 1), (1080, 1920, 4, 1),
                                          (1080, 1920, 4, 8), (1080, 1920, 2, 2)])
def test_auto_full_frame_reads_the_pinned_budget_as_jax(monkeypatch, budget, h, w, s, frames):
    """With no explicit bytes, both read ``VRT_HBM_BYTES`` (the port in
    place of the card's total, here an 80 GB card that the knob caps)."""
    from video_restore_tpu.ops.tiles import auto_full_frame as jax_auto

    monkeypatch.setenv("VRT_HBM_BYTES", str(budget))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (GB80, GB80))
    assert port_tiles.auto_full_frame(h, w, s, frames=frames) == jax_auto(h, w, s, frames=frames)


class _FakeUpscaler:
    def __init__(self, model, grid, cfg, mesh, yuv420_out=False):
        self.grid = grid


@pytest.mark.parametrize("budget,full", [(16 << 30, True), (1000, False)])
def test_runner_tile_choice_with_the_budget_pinned(monkeypatch, budget, full):
    """JAX's ``tests/test_pipeline.py:38`` case (a tiny RRDB, 24x32 frames,
    ``full_frame="auto"``) on both runners with ``VRT_HBM_BYTES`` pinned:
    16 GiB upgrades the bucket to full frame, 1000 bytes keeps the tiles;
    ``full_frame="off"`` keeps them either way. The port's runner sizes
    against the knob in place of a card's memory (here a card that
    reports 1 byte), behind its CUDA gate, JAX's behind its stripe gate."""
    import jax

    from video_restore_tpu.config import RestoreConfig
    from video_restore_tpu.models.rrdbnet import RRDBNetSpec as JaxSpec
    from video_restore_tpu.models.rrdbnet import init_rrdbnet
    from video_restore_tpu.models.zoo import ModelHandle as JaxHandle
    from video_restore_tpu.pipeline import runner as jrunner
    from video_restore_tpu_torch.models.rrdbnet import params_from_jax
    from video_restore_tpu_torch.pipeline import runner as prunner

    kw = dict(num_feat=16, num_block=1, num_grow_ch=8, scale=4)
    params = init_rrdbnet(jax.random.PRNGKey(1), JaxSpec(**kw))
    jmodel = JaxHandle("tiny-rrdb", JaxSpec(**kw), params)
    pmodel = ModelHandle("tiny-rrdb", RRDBNetSpec(**kw),
                         params_from_jax(jax.tree.map(np.asarray, params)))
    monkeypatch.setenv("VRT_STRIPE", "1")  # JAX's TPU gate, forced on the CPU
    monkeypatch.setenv("VRT_HBM_BYTES", str(budget))
    monkeypatch.setattr(jrunner, "ShardedUpscaler", lambda m, grid, c, mesh, **k: grid)
    monkeypatch.setattr(prunner, "ShardedUpscaler", _FakeUpscaler)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1, 1))
    cfg = dict(model_name="RealESRGAN_x4plus", tile_size=16, tile_overlap=4, precision="fp32",
               audio_copy=False)
    for mode in ("auto", "off"):
        jgrid = jrunner.VideoRestorer(RestoreConfig(**cfg, full_frame=mode),
                                      model=jmodel)._upscaler_for(24, 32)
        pr = prunner.VideoRestorer(PConfig(**cfg, full_frame=mode), model=pmodel, cpu=True)
        pr.device = torch.device("cuda", 0)  # only the decision is exercised
        pr.mesh = [pr.device]
        pgrid = pr._upscaler_for(24, 32).grid
        assert pgrid.n_tiles == jgrid.n_tiles, mode
        assert (pgrid.n_tiles == 1) is (full and mode == "auto"), mode


# ---- VRT_PRECISION ---------------------------------------------------------------


@pytest.mark.parametrize("env,want", [(None, "bf16"), ("bf16", "bf16"), ("int8", "int8"),
                                      ("INT8", "int8"), ("Bf16", "bf16")])
def test_default_precision_matches_jax(monkeypatch, env, want):
    from video_restore_tpu.models.rrdbnet import default_precision as jax_default

    if env is None:
        monkeypatch.delenv("VRT_PRECISION", raising=False)
    else:
        monkeypatch.setenv("VRT_PRECISION", env)
    assert port_rrdbnet.default_precision() == jax_default() == want


@pytest.mark.parametrize("env", ["fp32", "int4", ""])
def test_default_precision_refuses_what_jax_refuses(monkeypatch, env):
    from video_restore_tpu.models.rrdbnet import default_precision as jax_default

    monkeypatch.setenv("VRT_PRECISION", env)
    with pytest.raises(ValueError, match="VRT_PRECISION"):
        jax_default()
    with pytest.raises(ValueError, match="VRT_PRECISION"):
        port_rrdbnet.default_precision()
    net = SRVGGNet(SRVGGSpec(num_feat=8, num_conv=2, scale=2))
    with pytest.raises(ValueError, match="VRT_PRECISION"):
        net.prepare(torch.float32, "cpu")


def _nets(family):
    g = torch.Generator().manual_seed(7)
    if family == "rrdbnet":
        spec = RRDBNetSpec(num_feat=16, num_block=1, num_grow_ch=8, scale=4)
        make = RRDBNet
    else:
        spec = SRVGGSpec(num_feat=16, num_conv=4, scale=4)
        make = SRVGGNet
    a, b = make(spec), make(spec)
    for p in a.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    b.load_state_dict(a.state_dict())
    return spec, a, b


@pytest.mark.parametrize("family", ["rrdbnet", "srvgg"])
def test_prepare_without_precision_reads_vrt_precision(monkeypatch, family):
    spec, a, b = _nets(family)
    monkeypatch.setenv("VRT_PRECISION", "int8")
    a.prepare(torch.float32, "cpu")
    b.prepare(torch.float32, "cpu", "int8")
    assert a.precision == b.precision == "int8"
    x = torch.rand(2, 12, 16, 3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a(x), b(x))
    # the float body gives another output: the knob reached the body
    _, c, _ = _nets(family)
    monkeypatch.delenv("VRT_PRECISION")
    c.prepare(torch.float32, "cpu")
    assert c.precision == "bf16"
    assert not torch.equal(c(x), a(x))


def test_the_handle_and_the_cli_config(monkeypatch):
    """``ModelHandle.module`` with no precision follows the knob; the
    restore step passes the config's precision (the CLI's ``--precision``),
    which wins over it."""
    from video_restore_tpu_torch.ops.tiles import TileGrid
    from video_restore_tpu_torch.parallel.dispatch import Upscaler

    spec = SRVGGSpec(num_feat=8, num_conv=2, scale=2)
    net = SRVGGNet(spec)
    handle = ModelHandle("tiny", spec, net.state_dict())
    monkeypatch.setenv("VRT_PRECISION", "int8")
    assert handle.module(torch.float32, "cpu").precision == "int8"
    assert handle.module(torch.float32, "cpu", "bf16").precision == "bf16"
    grid = TileGrid.build(16, 16, tile=0, overlap=0, scale=2)
    ups = Upscaler(handle, grid, PConfig(model_name="RealESRGAN_x4_v3", precision="bf16"),
                   torch.device("cpu"))
    assert ups.net.precision == "bf16"
