"""Which of K1's routes each conv of the port takes on the card, and the
full-frame memory estimate with the chain tail counted.

K1 is one function behind five routes of hand-written CUDA kernels:
``"wgmma"`` (``csrc/conv3x3_wgmma.cu``, Hopper's ``wgmma`` fed by TMA, or,
for the tensor-core widths read through nearest 2x (up1, upconv2), by its
producer warpgroup's copies at the fine grid), ``"bf16x3"``
(``csrc/conv3x3_bf16x3_wgmma.cu``: the same widths in fp32, on three bf16
parts a value), ``"mma"``
(``csrc/conv3x3_mma.cu``, ``mma.sync``: forced beside it), ``"narrow"``
(``csrc/conv3x3_narrow.cu``: the stems and conv_last, in bf16 and fp32)
and ``"fma"``
(``csrc/conv3x3.cu``, fp32 FMAs). ``ops/tail.py::conv3x3_route`` chooses
from the call alone (dtype, widths, alignment, upsample2), so the choice is
tested here, on the CPU, without a kernel: every model runs at full width on
a tiny frame in bf16 through the plain versions while a recorder asks the
route of each K1 call. The numbers of the split are the ones the chip smoke
test asserts on the card (347 ``wgmma`` + 1 ``narrow`` per flagship frame,
no ``mma``, no ``fma``; the tail is one launch of its own kernel,
``tests/test_torch_k6_route.py``; at fp32 349 ``bf16x3``, the stem and
conv_last on ``narrow``, no ``fma``, with the tail as three K1 launches).

``auto_full_frame``: equal to the JAX function at its default (held in
``test_torch_tiles.py``); with ``tail_in_memory`` it also counts the two
64-channel tensors at output resolution that the three-launch tail writes
to device memory, and the runner passes the keyword by the tail's route:
only where the tail runs as three K1 launches (fp32, a width other than 64).
"""

import dataclasses

import pytest
import torch

from video_restore_tpu_torch.models.rrdbnet import RRDBNet, RRDBNetSpec
from video_restore_tpu_torch.models.srvgg import SRVGGNet, SRVGGSpec
from video_restore_tpu_torch.models.zoo import MODEL_ZOO
from video_restore_tpu_torch.ops import srvgg, stripe, tail
from video_restore_tpu_torch.ops import tiles as pt

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize(
    "dtype,cin,cout,aligned,route",
    [
        (BF, 64, 64, True, "wgmma"),   # conv_body, up1, upconv2, conv_hr, SRVGG body
        (BF, 64, 32, True, "wgmma"),   # RDB conv1
        (BF, 96, 32, True, "wgmma"),   # RDB conv2: 6 k16 steps
        (BF, 128, 32, True, "wgmma"),
        (BF, 160, 32, True, "wgmma"),  # RDB conv4: 10 k16 steps
        (BF, 192, 64, True, "wgmma"),  # RDB conv5
        (F32, 64, 64, True, "bf16x3"),  # fp32 conv_body, up1, upconv2, conv_hr, SRVGG body
        (F32, 64, 32, True, "bf16x3"),  # fp32 RDB conv1
        (F32, 160, 32, True, "bf16x3"),
        (F32, 192, 64, True, "bf16x3"),  # fp32 RDB conv5
        (F32, 3, 64, True, "narrow"),  # the fp32 stem: the narrow kernel's fp32 instance
        (F32, 12, 64, True, "narrow"),
        (F32, 64, 3, True, "narrow"),  # the fp32 conv_last: the narrow kernel's TMA-fed instance
        (F32, 16, 8, True, "fma"),     # fp32 nf 16 / gc 8: the checks' widths
        (F32, 48, 16, True, "fma"),
        (F32, 64, 48, True, "fma"),
        (F32, 64, 64, False, "fma"),   # misaligned fp32 operands
        (BF, 3, 64, True, "narrow"),   # the stem
        (BF, 12, 64, True, "narrow"),  # x2plus's pixel-unshuffled stem
        (BF, 64, 3, True, "narrow"),   # conv_last
        (BF, 64, 48, True, "fma"),   # SRVGG's conv_out width: not K1's to take
        (BF, 16, 8, True, "fma"),    # the nf 16 / gc 8 test model
        (BF, 24, 8, True, "fma"),    # cin not a multiple of 16
        (BF, 40, 16, True, "fma"),
        (BF, 64, 64, False, "fma"),  # misaligned operands
        (BF, 192, 64, False, "fma"),
    ],
)
def test_conv3x3_route(dtype, cin, cout, aligned, route):
    """The tensor-core widths take ``"wgmma"``, read through nearest 2x (up1,
    upconv2) or not, and so do the same widths in fp32 on ``"bf16x3"``; the
    other cases take their route either way but ``"narrow"``, which has no
    upsample2."""
    up2 = route != "narrow"
    assert tail.conv3x3_route(dtype, cin, cout, aligned, upsample2=up2) == route
    assert tail.conv3x3_route(dtype, cin, cout, aligned) == route
    assert route in tail.ROUTES


@pytest.mark.parametrize("up2", [False, True])
@pytest.mark.parametrize(
    "cin,cout",
    [(64, 64), (64, 32), (96, 32), (128, 32), (160, 32), (192, 64), (16, 32), (208, 64)],
)
def test_the_tensor_core_widths_take_wgmma_but_upsample2(cin, cout, up2):
    """Every call ``"mma"`` took before ``"wgmma"`` existed takes ``"wgmma"``
    now, the upsample2 ones too since its producer warpgroup copies their
    windows at the fine grid (a TMA box cannot read the 2x grid: the test's
    name is from before); misaligned operands stay on ``"fma"`` either way;
    fp32 takes ``"bf16x3"``, whose producer copies the fine-grid windows
    too."""
    assert tail.conv3x3_route(BF, cin, cout, upsample2=up2) == "wgmma"
    assert tail.conv3x3_route(BF, cin, cout, False, upsample2=up2) == "fma"
    assert tail.conv3x3_route(F32, cin, cout, upsample2=up2) == "bf16x3"
    assert tail.conv3x3_route(F32, cin, cout, False, upsample2=up2) == "fma"


def _operands(cin=64, cout=64, dt=BF):
    x = torch.zeros(1, 4, 5, cin, dtype=dt)
    w = torch.zeros(3, 3, cin, cout, dtype=dt)
    b = torch.zeros(cout, dtype=dt)
    return x, w, b


def test_call_route_follows_alignment_of_every_operand():
    x, w, b = _operands()
    assert tail.conv3x3_call_route(x, w, b) == "wgmma"
    assert tail.conv3x3_call_route(x, w, b, upsample2=True) == "wgmma"
    buf = torch.zeros(1, 4, 5, 192, dtype=BF)
    # the growth-buffer views: prefix in, 32 channels out at their offset
    for lo in (64, 96, 128, 160):
        wk = torch.zeros(3, 3, lo, 32, dtype=BF)
        assert tail.conv3x3_call_route(
            buf[..., :lo], wk, b[:32], out=buf[..., lo : lo + 32]
        ) == "wgmma"
    w5 = torch.zeros(3, 3, 192, 64, dtype=BF)
    assert tail.conv3x3_call_route(buf, w5, b, r1=buf[..., :64], r2=x) == "wgmma"
    # a channel offset that is not a multiple of 8 elements (16 bytes)
    wide = torch.zeros(1, 4, 5, 72, dtype=BF)
    assert tail.conv3x3_call_route(wide[..., 4:68], w, b) == "fma"
    assert tail.conv3x3_call_route(x, w, b, out=wide[..., 4:68]) == "fma"
    assert tail.conv3x3_call_route(x, w, b, r1=wide[..., 4:68]) == "fma"
    assert tail.conv3x3_call_route(x, w, b, r2=wide[..., 4:68]) == "fma"
    # a pixel stride that is not a multiple of 8 elements
    odd = torch.zeros(1, 4, 5, 68, dtype=BF)
    assert tail.conv3x3_call_route(odd[..., :64], w, b) == "fma"
    # a bias or alpha that starts off a 16-byte boundary
    bb = torch.zeros(72, dtype=BF)
    assert tail.conv3x3_call_route(x, w, bb[4:68]) == "fma"
    assert tail.conv3x3_call_route(x, w, b, alpha=bb[4:68]) == "fma"
    assert tail.conv3x3_call_route(x, w, b, alpha=bb[8:72]) == "wgmma"
    # fp32 takes the tensor cores on three bf16 parts, under the same
    # alignment rules
    assert tail.conv3x3_call_route(*_operands(dt=F32)) == "bf16x3"
    xf, wf, bf_ = _operands(dt=F32)
    assert tail.conv3x3_call_route(xf, wf, bf_, upsample2=True) == "bf16x3"
    wide32 = torch.zeros(1, 4, 5, 72, dtype=F32)
    assert tail.conv3x3_call_route(wide32[..., 2:66], wf, bf_) == "fma"  # 8 bytes off
    assert tail.conv3x3_call_route(xf, wf, bf_, out=wide32[..., 8:72]) == "bf16x3"


def _record_routes(monkeypatch):
    """Patch every module's binding of K1 with a recorder of (counter,
    route); the plain version still computes."""
    calls = []
    real = tail.conv3x3

    def recorder(x, w, b, *, counter, **kw):
        calls.append((counter, tail.conv3x3_call_route(
            x, w, b, kw.get("alpha"), kw.get("out"), kw.get("r1"), kw.get("r2"),
            kw.get("upsample2", False),
        )))
        return real(x, w, b, counter=counter, **kw)

    for mod in (tail, stripe, srvgg):
        monkeypatch.setattr(mod, "conv3x3", recorder)
    return calls


def _split(calls):
    """(tensor cores: wgmma + mma, narrow, fma) launches of the calls."""
    n = {r: sum(1 for _, r_ in calls if r_ == r) for r in tail.ROUTES}
    return n["wgmma"] + n["mma"], n["narrow"], n["fma"]


@pytest.mark.parametrize(
    "name,n_mma,n_narrow,n_fma",
    [
        # 345 dense-block convs + conv_body, up1 | the stem; the tail is
        # one launch of tail_fused_wgmma.cu, no K1 call
        ("RealESRGAN_x4plus", 347, 1, 0),
        ("RealESRGAN_x2plus", 347, 1, 0),  # the stem has cin 12
        ("RealESRGAN_x4plus_anime_6B", 6 * 15 + 2, 1, 0),
        ("RealESRGAN_x4_v3", 32, 1, 0),  # config 4: the body | the stem
    ],
)
def test_routes_of_one_frame_at_full_width(monkeypatch, name, n_mma, n_narrow, n_fma):
    spec = MODEL_ZOO[name].spec
    net = (RRDBNet if isinstance(spec, RRDBNetSpec) else SRVGGNet)(spec)
    net.prepare(BF, "cpu")
    calls = _record_routes(monkeypatch)
    y = net(torch.rand(1, 8, 8, 3))
    assert y.shape == (1, 8 * spec.scale, 8 * spec.scale, 3)
    # n_mma: the tensor-core launches, every one on wgmma (up1 too)
    assert _split(calls) == (n_mma, n_narrow, n_fma)
    narrow = [c for c, r in calls if r == "narrow"]
    on = {r: [c for c, r_ in calls if r_ == r] for r in ("wgmma", "mma")}
    if isinstance(spec, RRDBNetSpec):
        assert narrow == ["conv3x3_fused"]  # the stem
        assert set(on["wgmma"]) == {"rdb_fused", "conv3x3_fused", "up1_fused"}
        assert len(on["wgmma"]) == n_mma and on["wgmma"][-1] == "up1_fused"
        assert on["mma"] == []
    else:
        assert narrow == ["conv3x3_fused"]
        assert on == {"wgmma": ["srvgg_body"] * n_mma, "mma": []}


@pytest.mark.parametrize("family", ["rrdbnet", "srvgg"])
@pytest.mark.parametrize("dt", [BF, F32])
def test_routes_of_the_narrow_test_models_stay_on_fma(monkeypatch, family, dt):
    """nf 16 / gc 8 (the widths of the parity tests and of the smoke test's
    small checks) and every fp32 call: the old kernel."""
    if family == "rrdbnet":
        net = RRDBNet(RRDBNetSpec(num_feat=16, num_block=2, num_grow_ch=8, scale=4))
        n = 2 * 15 + 6
    else:
        net = SRVGGNet(SRVGGSpec(num_feat=16, num_conv=4, scale=4))
        n = 5
    net.prepare(dt, "cpu")
    calls = _record_routes(monkeypatch)
    net(torch.rand(1, 6, 7, 3))
    assert _split(calls) == (0, 0, n)


def _full_width_fp32_routes(monkeypatch):
    spec = dataclasses.replace(MODEL_ZOO["RealESRGAN_x4plus"].spec, num_block=1)
    net = RRDBNet(spec).prepare(F32, "cpu")
    calls = _record_routes(monkeypatch)
    net(torch.rand(1, 6, 6, 3))
    return calls


def test_full_width_fp32_stays_on_fma(monkeypatch):
    """At full width in fp32 of the convs the tensor cores cannot take,
    none stays on ``"fma"`` (the test's name is from before the fp32
    conv_last's kernel): the stem (cin 3) and conv_last (cout 3) take the
    narrow kernels' fp32 instances, 1 a frame each; no fp32 call takes a
    bf16 route."""
    calls = _full_width_fp32_routes(monkeypatch)
    assert _split(calls) == (0, 2, 0)
    assert [c for c, r in calls if r == "fma"] == []
    assert [c for c, r in calls if r == "narrow"] == ["conv3x3_fused", "tail_fused"]


def test_full_width_fp32_takes_bf16x3_but_stem_and_conv_last(monkeypatch):
    """The other fp32 convs take ``"bf16x3"``: one RRDB's 15 dense-block
    convs, conv_body, up1, and the chain tail's upconv2 and conv_hr (349 a
    frame of the 23-block flagship)."""
    calls = _full_width_fp32_routes(monkeypatch)
    on = [c for c, r in calls if r == "bf16x3"]
    assert on == ["rdb_fused"] * 15 + ["conv3x3_fused", "up1_fused", "tail_fused", "tail_fused"]
    assert len(on) + 2 == len(calls)


@pytest.mark.parametrize("name,n_x3", [("RealESRGAN_x4plus", 349), ("RealESRGAN_x4_v3", 32)])
def test_the_fp32_paths_launch_bf16x3_per_frame(monkeypatch, name, n_x3):
    """The counts the chip smoke test asserts on its fp32 paths: 349
    ``bf16x3`` launches per flagship frame (345 dense-block convs, conv_body,
    up1, upconv2, conv_hr), 2 ``narrow`` (the stem, conv_last) and no
    ``fma``; 32 per config-4 frame (the body) and 1 ``narrow`` (the
    stem)."""
    spec = MODEL_ZOO[name].spec
    net = (RRDBNet if isinstance(spec, RRDBNetSpec) else SRVGGNet)(spec).prepare(F32, "cpu")
    calls = _record_routes(monkeypatch)
    net(torch.rand(1, 4, 4, 3))
    n = {r: sum(1 for _, r_ in calls if r_ == r) for r in tail.ROUTES}
    assert n == {"wgmma": 0, "bf16x3": n_x3, "mma": 0,
                 "narrow": 2 if isinstance(spec, RRDBNetSpec) else 1, "fma": 0}


# ---- auto_full_frame with the chain tail's intermediates ---------------------

GB80 = 80 * 10**9


@pytest.mark.parametrize(
    "frames,jax_like,with_tail",
    [(1, True, True), (3, True, True), (8, True, False)],
)
def test_auto_full_frame_counts_the_chain_tail(frames, jax_like, with_tail):
    """1080x1920, scale 4, 80e9 bytes: 1 and 3 frames fit either way; 8
    frames fit by the JAX estimate (28.7 GB) but not with the two 4.25 GB
    tail intermediates per frame counted (96.6 GB)."""
    args = (1080, 1920, 4, GB80)
    assert pt.auto_full_frame(*args, frames=frames) is jax_like
    assert pt.auto_full_frame(*args, frames=frames, tail_in_memory=False) is jax_like
    assert pt.auto_full_frame(*args, frames=frames, tail_in_memory=True) is with_tail


def test_full_frame_bytes_terms():
    hw = 1080 * 1920
    base = 5 * hw * 64 * 2 + 4 * hw * 64 * 2 + 3 * 16 * hw * 3 * 4
    assert pt.full_frame_bytes(1080, 1920, 4) == base
    tail_bytes = 2 * 16 * hw * 64 * 2
    assert pt.full_frame_bytes(1080, 1920, 4, tail_in_memory=True) == base + tail_bytes
    assert pt.full_frame_bytes(1080, 1920, 4, frames=8, tail_in_memory=True) == 8 * (
        base + tail_bytes
    )
    # the measured flagship peak (9.65 GiB) lies under the new estimate and
    # far above the old one
    assert base < 4 * 10**9 < 10.36 * 10**9 < base + tail_bytes


@pytest.mark.parametrize("frames", [1, 3])
def test_full_frame_bytes_counts_the_compute_dtype(frames):
    """At fp32 (4 bytes a value) the feature terms double: the body, up1 and
    the chain tail's two 8.5 GB intermediates at 1080p x4; the RGB buffers
    are fp32 either way. The default (2 bytes) is the JAX estimate."""
    hw = 1080 * 1920
    rgb = 3 * 16 * hw * 3 * 4
    feats = 5 * hw * 64 + 4 * hw * 64 + 2 * 16 * hw * 64  # values, the tail's included
    assert pt.full_frame_bytes(1080, 1920, 4, frames=frames, tail_in_memory=True) == frames * (
        2 * feats + rgb)
    got = pt.full_frame_bytes(1080, 1920, 4, frames=frames, tail_in_memory=True, value_bytes=4)
    assert got == frames * (4 * feats + rgb)
    assert pt.full_frame_bytes(1080, 1920, 4, value_bytes=4) == 4 * 9 * hw * 64 + rgb
    # 3 fp32 frames (64 GiB) no longer fit half of an 80 GB card; bf16 ones did
    assert pt.auto_full_frame(1080, 1920, 4, GB80, frames=3, tail_in_memory=True)
    assert not pt.auto_full_frame(1080, 1920, 4, GB80, frames=3, tail_in_memory=True,
                                  value_bytes=4)


@pytest.mark.parametrize("precision,vb", [("fp32", 4), ("bf16", 2), ("int8", 2)])
def test_runner_counts_the_compute_dtype(monkeypatch, precision, vb):
    from video_restore_tpu_torch.config import RestoreConfig
    from video_restore_tpu_torch.models.zoo import ModelHandle
    from video_restore_tpu_torch.pipeline import runner

    name = "RealESRGAN_x4plus"
    handle = ModelHandle(name, MODEL_ZOO[name].spec, {})
    seen = []

    class FakeUpscaler:
        def __init__(self, model, grid, cfg, mesh, yuv420_out=False):
            self.grid = grid

    monkeypatch.setattr(runner, "ShardedUpscaler", FakeUpscaler)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (GB80, GB80))
    monkeypatch.setattr(runner, "auto_full_frame", lambda *a, **kw: seen.append(kw) or True)
    r = runner.VideoRestorer(RestoreConfig(model_name=name, full_frame="auto",
                                           precision=precision), model=handle, cpu=True)
    r.device = torch.device("cuda", 0)  # only the decision is exercised
    assert r._upscaler_for(1080, 1920).grid.n_tiles == 1
    assert seen[-1]["value_bytes"] == vb


@pytest.mark.parametrize(
    "model,knob,precision,expected",
    [
        # the chain tail mode in bf16 at nf 64: one launch, nothing in memory
        ("RealESRGAN_x4plus", None, "bf16", False),
        ("RealESRGAN_x4plus", None, "int8", False),
        # fp32: the chain runs as three K1 launches
        ("RealESRGAN_x4plus", None, "fp32", True),
        ("RealESRGAN_x4plus", "1", "fp32", True),  # the knob counts only on a CUDA device
        ("RealESRGAN_x4_v3", None, "bf16", False),   # SRVGG has no such tail
    ],
)
def test_runner_passes_tail_in_memory_by_tail_mode(monkeypatch, model, knob, precision,
                                                    expected):
    from video_restore_tpu_torch.config import RestoreConfig
    from video_restore_tpu_torch.models.zoo import ModelHandle
    from video_restore_tpu_torch.pipeline import runner

    if knob:
        monkeypatch.setenv("VRT_TAIL_Q", knob)
    else:
        monkeypatch.delenv("VRT_TAIL_Q", raising=False)
    handle = ModelHandle(model, MODEL_ZOO[model].spec, {})
    cfg = RestoreConfig(model_name=model, precision=precision)
    r = runner.VideoRestorer(cfg, model=handle, cpu=True)
    assert r._tail_in_memory() is expected
    # on a CUDA device the tail mode "q" keeps both intermediates on chip
    monkeypatch.setattr(runner, "tail_mode", lambda device: "q")
    assert r._tail_in_memory() is False


def test_runner_hands_the_keyword_to_auto_full_frame(monkeypatch):
    """The decision as the runner makes it on a card with 80e9 bytes and
    ``--frames-per-batch 8``: tiles for the chain tail where it runs as three
    K1 launches (fp32), full frame for the one-launch tails in bf16 (``"q"``,
    and the chain mode); fp32 with ``"q"`` keeps its tail off the estimate
    but counts 4 bytes a feature value, and 8 such frames (47.8 GB) do not
    fit half the card either."""
    from video_restore_tpu_torch.config import RestoreConfig
    from video_restore_tpu_torch.models.zoo import ModelHandle
    from video_restore_tpu_torch.pipeline import runner

    name = "RealESRGAN_x4plus"
    handle = ModelHandle(name, MODEL_ZOO[name].spec, {})
    seen = []

    class FakeUpscaler:
        def __init__(self, model, grid, cfg, mesh, yuv420_out=False):
            self.grid = grid

    monkeypatch.setattr(runner, "ShardedUpscaler", FakeUpscaler)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (GB80, GB80))
    real = runner.auto_full_frame

    def spy(*a, **kw):
        seen.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(runner, "auto_full_frame", spy)
    for mode, precision, tiled, in_memory in (
            ("chain", "fp32", True, True), ("chain", "bf16", False, False),
            ("q", "fp32", True, False), ("q", "bf16", False, False)):
        monkeypatch.setattr(runner, "tail_mode", lambda device, m=mode: m)
        cfg = RestoreConfig(model_name=name, frames_per_batch=8, full_frame="auto",
                            precision=precision)
        r = runner.VideoRestorer(cfg, model=handle, cpu=True)
        r.device = torch.device("cuda", 0)  # only the decision is exercised
        grid = r._upscaler_for(1080, 1920).grid
        assert (grid.n_tiles > 1) is tiled, (mode, precision)
        assert seen[-1]["tail_in_memory"] is in_memory
        assert seen[-1]["frames"] == 8
        assert seen[-1]["value_bytes"] == (4 if precision == "fp32" else 2)


@pytest.mark.parametrize(
    "precision,nf,route,gib",
    [
        ("bf16", 64, "wgmma", 3.34),   # the flagship: nothing of the tail in memory
        ("fp32", 64, "bf16x3", 21.38),  # the default tail: the chain of three K1 launches
        ("bf16", 32, "fma", None),     # a width the one launch is not built for
    ],
)
def test_tail_in_memory_follows_the_route(monkeypatch, precision, nf, route, gib):
    """For each route of the one-launch tail the runner's flag, and at 1080p
    scale 4 the estimate ``auto_full_frame`` weighs: 3.34 GiB where the
    default tail is one launch, 21.38 GiB where both 64-channel
    intermediates go through device memory at fp32 (11.25 GiB if they were
    bf16: ``value_bytes`` 2). fp32's one launch (``"bf16x3"``) serves
    ``VRT_TAIL_Q=1`` only: the default fp32 tail is the chain."""
    from video_restore_tpu_torch.config import RestoreConfig
    from video_restore_tpu_torch.models.zoo import ModelHandle
    from video_restore_tpu_torch.pipeline import runner

    monkeypatch.delenv("VRT_TAIL_Q", raising=False)
    dt = F32 if precision == "fp32" else BF
    assert tail.tail_fused_route(dt, nf) == route
    spec = dataclasses.replace(MODEL_ZOO["RealESRGAN_x4plus"].spec, num_feat=nf)
    handle = ModelHandle("RealESRGAN_x4plus", spec, {})
    r = runner.VideoRestorer(RestoreConfig(precision=precision), model=handle, cpu=True)
    assert r._tail_in_memory() is (tail.default_tail_route(dt, nf) == "chain")
    assert r._tail_in_memory() is (route != "wgmma")
    if gib is not None:
        est = pt.full_frame_bytes(1080, 1920, 4, tail_in_memory=r._tail_in_memory(),
                                  value_bytes=r._value_bytes())
        assert round(est / 2**30, 2) == gib
        if precision == "fp32":
            bf16_est = pt.full_frame_bytes(1080, 1920, 4, tail_in_memory=True)
            assert round(bf16_est / 2**30, 2) == 11.25


@pytest.mark.parametrize(
    "precision,route,in_memory",
    [("fp32", "chain", True), ("bf16", "wgmma", False), ("int8", "wgmma", False)],
)
def test_tail_in_memory_at_fp32_matches_the_default_tail(monkeypatch, precision, route,
                                                         in_memory):
    """The flagship's default tail at each precision: fp32 keeps the chain
    of three K1 launches (its one launch, ``"bf16x3"``, is slower on the
    card and serves ``VRT_TAIL_Q=1`` only), so ``auto_full_frame`` counts
    both 4x intermediates; bf16 and int8 run the one launch."""
    from video_restore_tpu_torch.config import RestoreConfig
    from video_restore_tpu_torch.models.zoo import ModelHandle
    from video_restore_tpu_torch.pipeline import runner

    monkeypatch.delenv("VRT_TAIL_Q", raising=False)
    dt = F32 if precision == "fp32" else BF
    assert tail.default_tail_route(dt, 64) == route
    assert route in tail.CHAIN_ROUTES and (route == "chain") is in_memory
    name = "RealESRGAN_x4plus"
    handle = ModelHandle(name, MODEL_ZOO[name].spec, {})
    r = runner.VideoRestorer(RestoreConfig(precision=precision), model=handle, cpu=True)
    assert r._tail_in_memory() is in_memory


# ---- the RDB's layout on the wgmma route -------------------------------------


def _rdb_operands(nf=64, gc=32, dt=BF, shape=(2, 9, 11)):
    g = torch.Generator().manual_seed(1)
    x = torch.rand(*shape, nf, generator=g).to(dt)
    ws = [((torch.rand(3, 3, nf + k * gc, gc if k < 4 else nf, generator=g) - 0.5) * 0.1).to(dt)
          for k in range(5)]
    bs = [((torch.rand(gc if k < 4 else nf, generator=g) - 0.5) * 0.1).to(dt) for k in range(5)]
    return x, ws, bs


@pytest.mark.parametrize("x0", [False, True])
def test_the_blocked_rdb_is_the_growth_buffer_rdb(x0):
    """On the wgmma route c1 .. c4 live in four blocks of one tail tensor and
    conv k reads x and the blocks before it: the same function, value for
    value, as the growth buffer (the plain versions of both layouts)."""
    x, ws, bs = _rdb_operands()
    r = torch.rand_like(x) if x0 else None
    grow = stripe._rdb(tail.conv3x3_plain, x, ws, bs, r)
    blk = stripe._rdb(tail.conv3x3_plain, x, ws, bs, r, blocked=True)
    assert torch.equal(grow, blk)
    assert torch.equal(grow, stripe.rdb_fused(x, ws, bs, r))


def test_which_rdbs_take_the_blocked_layout():
    """Only a CUDA x whose convs take wgmma with gc the route's 32-channel
    stage: on the CPU, at nf 16 / gc 8 and in fp32 the growth buffer stays."""
    x, ws, bs = _rdb_operands()
    assert not stripe.blocked(x, ws, bs)  # the CPU
    xm = x.to("meta")
    assert not stripe.blocked(xm, ws, bs)
    assert tail.conv3x3_call_route(x, ws[0], bs[0]) == "wgmma"
    assert tail.WGMMA_KC == ws[0].shape[-1] == 32
    x16, ws16, bs16 = _rdb_operands(16, 8)
    assert tail.conv3x3_call_route(x16, ws16[0], bs16[0]) == "fma"
