"""K1's narrow route: which calls take it, what a forced route accepts, how
many K1 calls of each full-width model take it per frame, and its function
against the JAX conv at the route's exact widths.

``"narrow"`` (``csrc/conv3x3_narrow.cu``) is a route of K1
(``ops/tail.py::conv3x3_route``): one kernel for the stems in bf16 and fp32
(cin 3 or 12 -> cout 64, act none, lrelu or PReLU), one for the bf16
``conv_last`` (cin 64 -> cout 3) and one for the fp32 ``conv_last`` (fed by
TMA: ``tests/test_torch_last_f32.py``), each summing in
``csrc/conv3x3.cu``'s order, so a forced ``"fma"`` gives their outputs bit
for bit (held on the card by ``chip_smoke.py --only k1n``). The choice is a
pure function of the call, tested here on the
CPU without a kernel: every model runs at full width on a tiny frame
through the plain versions while a recorder asks the route of each K1 call.
The per-frame numbers are the ones the chip smoke test asserts on the card.

Against the JAX ``conv3x3_fused`` (``pallas_tail.py:767``) in interpret mode
at the narrow widths, fp32 on both sides with the same numpy inputs: rtol =
atol = 1e-4, ``tests/test_torch_kernels_cpu.py``'s tolerance (the same fp32
sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.models.rrdbnet import RRDBNet
from video_restore_tpu_torch.models.srvgg import SRVGGNet
from video_restore_tpu_torch.models.zoo import MODEL_ZOO
from video_restore_tpu_torch.ops import rdb, srvgg, stripe, tail
from video_restore_tpu_torch.ops.tail import conv3x3_fused

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

BF, F32 = torch.bfloat16, torch.float32


def _ops(cin, cout, dt=BF, h=4, w=5):
    return (torch.zeros(1, h, w, cin, dtype=dt), torch.zeros(3, 3, cin, cout, dtype=dt),
            torch.zeros(cout, dtype=dt))


def _route(x, w, b, **kw):
    return tail.conv3x3_call_route(
        x, w, b, kw.get("alpha"), kw.get("out"), kw.get("r1"), kw.get("r2"),
        kw.get("upsample2", False),
    )


# ---- the route table ---------------------------------------------------------


@pytest.mark.parametrize(
    "cin,cout,act",
    [
        (3, 64, "none"),    # RRDBNet's conv_first
        (3, 64, "prelu"),   # SRVGG's conv_in
        (3, 64, "lrelu"),
        (12, 64, "none"),   # x2plus's stem, after the pixel unshuffle
        (12, 64, "prelu"),
        (64, 3, "none"),    # conv_last
    ],
)
def test_the_narrow_widths_take_the_narrow_route(cin, cout, act):
    x, w, b = _ops(cin, cout)
    alpha = torch.zeros(cout, dtype=BF) if act == "prelu" else None
    assert tail.conv3x3_route(BF, cin, cout) == "narrow"
    assert _route(x, w, b, alpha=alpha) == "narrow"
    assert tail.ROUTES == ("wgmma", "bf16x3", "mma", "narrow", "fma")


@pytest.mark.parametrize("cin", [3, 12])
@pytest.mark.parametrize("act", ["none", "lrelu", "prelu"])
def test_fp32_stems_take_the_narrow_route(cin, act):
    """The fp32 paths' conv_first (cin 3; 12 after x2plus's unshuffle) and
    SRVGG's conv_in: the narrow stem kernel's fp32 instance."""
    x, w, b = _ops(cin, 64, F32)
    alpha = torch.zeros(64) if act == "prelu" else None
    assert tail.conv3x3_route(F32, cin, 64) == "narrow"
    assert _route(x, w, b, alpha=alpha) == "narrow"
    assert _pick((x, w, b), None, alpha=alpha) == "narrow"


def _view(c_buf, lo, hi, offset=0, h=4, w=5, dt=BF):
    """buf[..., lo:hi] of a (1, h, w, c_buf) buffer that starts ``offset``
    elements into its storage."""
    flat = torch.zeros(offset + h * w * c_buf, dtype=dt)
    return flat[offset:].view(1, h, w, c_buf)[..., lo:hi]


@pytest.mark.parametrize(
    "case",
    ["fp32 stem", "upsample2", "stem r1", "conv_last r2", "cout 48",
     "cin 3 cout 32", "nf 16 stem", "nf 16 conv_last", "stem out misaligned",
     "stem out pixel stride 68", "conv_last x misaligned", "conv_last x pixel stride 68",
     "fp32 stem out misaligned", "fp32 stem r1", "fp32 stem upsample2", "fp32 nf 16 stem",
     "fp32 conv_last x off 16 bytes", "fp32 conv_last x pixel stride 66", "fp32 conv_last r2",
     "fp32 conv_last upsample2"],
)
def test_the_rest_stays_off_the_narrow_route(case):
    """Residuals, ``upsample2``, other widths, and operands the narrow
    kernels cannot load take the fma kernel: an fp32 stem's ``out`` too must
    be written in whole 16-byte pieces (pixel stride 66: 264 bytes), and
    the fp32 conv_last's x read in them by TMA (a start 8 bytes off, a pixel
    stride of 66: 264 bytes)."""
    x3, w3, b3 = _ops(3, 64)
    x64, wl, bl = _ops(64, 3)
    s3, l32 = _ops(3, 64, F32), _ops(64, 3, F32)
    route = {
        "fp32 stem": lambda: _route(*s3, out=_view(66, 0, 64, dt=F32)),
        "upsample2": lambda: _route(x3, w3, b3, upsample2=True),
        "stem r1": lambda: _route(x3, w3, b3, r1=torch.zeros(1, 4, 5, 64, dtype=BF)),
        "conv_last r2": lambda: _route(x64, wl, bl, r2=torch.zeros(1, 4, 5, 3, dtype=BF)),
        "cout 48": lambda: _route(*_ops(64, 48)),
        "cin 3 cout 32": lambda: _route(*_ops(3, 32)),
        "nf 16 stem": lambda: _route(*_ops(3, 16)),
        "nf 16 conv_last": lambda: _route(*_ops(16, 3)),
        "stem out misaligned": lambda: _route(x3, w3, b3, out=_view(72, 4, 68)),
        "stem out pixel stride 68": lambda: _route(x3, w3, b3, out=_view(68, 0, 64)),
        "conv_last x misaligned": lambda: _route(_view(72, 4, 68), wl, bl),
        "conv_last x pixel stride 68": lambda: _route(_view(68, 0, 64), wl, bl),
        "fp32 stem out misaligned": lambda: _route(*s3, out=_view(68, 2, 66, dt=F32)),
        "fp32 stem r1": lambda: _route(*s3, r1=torch.zeros(1, 4, 5, 64)),
        "fp32 stem upsample2": lambda: _route(*s3, upsample2=True),
        "fp32 nf 16 stem": lambda: _route(*_ops(3, 16, F32)),
        "fp32 conv_last x off 16 bytes": lambda: _route(_view(72, 2, 66, dt=F32), *l32[1:]),
        "fp32 conv_last x pixel stride 66": lambda: _route(_view(66, 0, 64, dt=F32), *l32[1:]),
        "fp32 conv_last r2": lambda: _route(*l32, r2=torch.zeros(1, 4, 5, 3)),
        "fp32 conv_last upsample2": lambda: _route(*l32, upsample2=True),
    }[case]()
    assert route == "fma"


@pytest.mark.parametrize(
    "case",
    ["cin 3 pixel stride 3", "cin 3 pixel stride 4", "cin 3 off 16 bytes",
     "stem out a slice", "stem alpha off 16 bytes", "conv_last x a prefix of 72",
     "conv_last out off 16 bytes", "fp32 cin 3 pixel stride 3", "fp32 cin 3 off 16 bytes",
     "fp32 stem out a slice of stride 68", "fp32 stem out a slice of stride 132",
     "fp32 conv_last", "fp32 conv_last x a prefix of 72", "fp32 conv_last x a slice of stride 68",
     "fp32 conv_last out off 16 bytes"],
)
def test_the_narrow_operand_rule(case):
    """The narrow route has its own operand rule: a stem's x is read one
    value at a time (any pixel stride, any start) and its out written 16
    bytes at a time (8 bf16 or 4 fp32 couts: a pixel stride that is a
    multiple of 8 or of 4 elements); conv_last's x is read 16 bytes at a
    time (8 bf16 or, by TMA, 4 fp32 channels) and its out one value at a
    time. ``operands_aligned``, the mma rule, is False for every cin-3 x."""
    x3, w3, b3 = _ops(3, 64)
    x64, wl, bl = _ops(64, 3)
    s3, l32 = _ops(3, 64, F32), _ops(64, 3, F32)
    assert not tail.operands_aligned(x3)
    xs = {
        "cin 3 pixel stride 3": lambda: _route(x3, w3, b3),
        "cin 3 pixel stride 4": lambda: _route(_view(4, 0, 3), w3, b3),
        "cin 3 off 16 bytes": lambda: _route(_view(3, 0, 3, offset=1), w3, b3),
        "stem out a slice": lambda: _route(x3, w3, b3, out=_view(72, 8, 72)),
        "stem alpha off 16 bytes": lambda: _route(
            x3, w3, b3, alpha=torch.zeros(65, dtype=BF)[1:]),
        "conv_last x a prefix of 72": lambda: _route(_view(72, 0, 64), wl, bl),
        "conv_last out off 16 bytes": lambda: _route(x64, wl, bl, out=_view(4, 1, 4)),
        "fp32 cin 3 pixel stride 3": lambda: _route(*s3),
        "fp32 cin 3 off 16 bytes": lambda: _route(_view(3, 0, 3, offset=1, dt=F32), *s3[1:]),
        "fp32 stem out a slice of stride 68": lambda: _route(*s3, out=_view(68, 4, 68, dt=F32)),
        "fp32 stem out a slice of stride 132": lambda: _route(
            *s3, out=_view(132, 64, 128, dt=F32)),
        "fp32 conv_last": lambda: _route(*l32),
        "fp32 conv_last x a prefix of 72": lambda: _route(_view(72, 0, 64, dt=F32), *l32[1:]),
        "fp32 conv_last x a slice of stride 68": lambda: _route(
            _view(68, 4, 68, dt=F32), *l32[1:]),
        "fp32 conv_last out off 16 bytes": lambda: _route(*l32, out=_view(4, 1, 4, dt=F32)),
    }
    assert xs[case]() == "narrow"


# ---- forced routes -------------------------------------------------------------


def _pick(ops, route, **kw):
    return tail._pick_conv_route(
        *ops, kw.get("alpha"), kw.get("out"), kw.get("r1"), kw.get("r2"),
        kw.get("upsample2", False), route,
    )


def test_a_forced_route_is_checked():
    """``route="fma"`` reaches the old kernel for any call (a side-by-side
    timing); ``"narrow"``, ``"wgmma"`` and ``"mma"`` only where their kernel
    takes the call."""
    stem, last, wide = _ops(3, 64), _ops(64, 3), _ops(64, 64)
    assert _pick(stem, None) == "narrow"
    assert _pick(stem, "narrow") == "narrow"
    assert _pick(stem, "fma") == "fma"
    assert _pick(last, "fma") == "fma"
    assert _pick(wide, None) == "wgmma"
    assert _pick(wide, "mma") == "mma"  # the mma.sync kernel takes every wgmma call
    assert _pick(wide, "wgmma") == "wgmma"
    assert _pick(wide, "fma") == "fma"
    up2 = dict(upsample2=True)  # up1, upconv2: wgmma's nearest-2x producer
    assert _pick(wide, None, **up2) == "wgmma"
    assert _pick(wide, "wgmma", **up2) == "wgmma"
    assert _pick(wide, "mma", **up2) == "mma"
    with pytest.raises(ValueError, match="the wgmma kernel takes bf16"):
        _pick(_ops(64, 64, F32), "wgmma", **up2)
    # fp32 at the tensor-core widths: its own route, or fma forced
    assert _pick(_ops(64, 64, F32), None, **up2) == "bf16x3"
    assert _pick(_ops(64, 64, F32), "fma", **up2) == "fma"
    assert _pick(_ops(64, 64, F32), "bf16x3") == "bf16x3"
    with pytest.raises(ValueError, match="the bf16x3 kernel takes fp32"):
        _pick(wide, "bf16x3")
    with pytest.raises(ValueError, match="the bf16x3 kernel takes fp32"):
        _pick(_ops(3, 64, F32), "bf16x3")
    with pytest.raises(ValueError, match="the narrow kernel takes stems"):
        _pick(wide, "narrow")
    # the fp32 stems and conv_last: their own route is narrow, fma forced
    # beside it
    assert _pick(_ops(3, 64, F32), "narrow") == "narrow"
    assert _pick(_ops(12, 64, F32), None) == "narrow"
    assert _pick(_ops(3, 64, F32), "fma") == "fma"
    assert _pick(_ops(64, 3, F32), None) == "narrow"
    assert _pick(_ops(64, 3, F32), "narrow") == "narrow"
    assert _pick(_ops(64, 3, F32), "fma") == "fma"
    with pytest.raises(ValueError, match="the narrow kernel takes"):
        _pick((_view(66, 0, 64, dt=F32), *_ops(64, 3, F32)[1:]), "narrow")
    with pytest.raises(ValueError, match="the narrow kernel takes"):
        _pick(stem, "narrow", upsample2=True)
    with pytest.raises(ValueError, match="the narrow kernel takes"):
        _pick(last, "narrow", r1=torch.zeros(1, 4, 5, 3, dtype=BF))
    with pytest.raises(ValueError, match="the mma kernel takes bf16 with cin a multiple of 16"):
        _pick(stem, "mma")
    with pytest.raises(ValueError, match="unknown route"):
        _pick(stem, "dp4a")


def test_the_two_kernel_wrappers_have_no_narrow_route():
    """K6 keeps its two routes, K3 its three (for fp32, ``"bf16x3"`` between
    them), K5 its four (its Hopper ``"wgmma"`` and, for fp32, ``"bf16x3"``
    before them): ``"narrow"`` is unknown there."""
    assert tail.PAIR_ROUTES == ("mma", "fma")
    assert srvgg.ROUTES == ("mma", "bf16x3", "fma")
    with pytest.raises(ValueError, match="unknown route"):
        tail.forced_route("srvgg_up_fused", "bf16x3", "narrow", "", routes=srvgg.ROUTES)
    assert rdb.ROUTES == ("wgmma", "bf16x3", "mma", "fma")
    with pytest.raises(ValueError, match="unknown route"):
        rdb._pick_route("t", torch.zeros(1, 4, 5, 64, dtype=BF), 64, 32, "narrow")
    with pytest.raises(ValueError, match="unknown route"):
        tail._pick_tail_route(torch.zeros(1, 4, 5, 64, dtype=BF), *_ops(64, 64)[1:],
                              *_ops(64, 64)[1:], "narrow")


# ---- routes per frame of each full-width model ---------------------------------


def _record(monkeypatch):
    calls = []
    real = tail.conv3x3

    def recorder(x, w, b, *, counter, **kw):
        calls.append((counter, _route(x, w, b, **kw), tuple(w.shape[2:])))
        return real(x, w, b, counter=counter, **kw)

    for mod in (tail, stripe, srvgg):
        monkeypatch.setattr(mod, "conv3x3", recorder)
    return calls


@pytest.mark.parametrize(
    "name,precision,tail_mode,split,narrow",
    [
        # the default tail mode in bf16 at nf 64 is one launch of
        # tail_fused_wgmma.cu: upconv2, conv_hr and conv_last are no K1 call
        ("RealESRGAN_x4plus", "bf16", "chain", (347, 0, 1, 0), [("conv3x3_fused", (3, 64))]),
        ("RealESRGAN_x2plus", "bf16", "chain", (347, 0, 1, 0), [("conv3x3_fused", (12, 64))]),
        ("RealESRGAN_x4plus_anime_6B", "bf16", "chain", (6 * 15 + 2, 0, 1, 0),
         [("conv3x3_fused", (3, 64))]),
        ("RealESRGAN_x4_v3", "bf16", None, (32, 0, 1, 0), [("conv3x3_fused", (3, 64))]),
        # W8A8: the RDB convs are K4's; K1 keeps conv_body and up1
        ("RealESRGAN_x4plus", "int8", "chain", (2, 0, 1, 0), [("conv3x3_fused", (3, 64))]),
        ("RealESRGAN_x4_v3", "int8", None, (0, 0, 1, 0), [("conv3x3_fused", (3, 64))]),
        # the VRT_TAIL_Q=1 tail: the same one launch
        ("RealESRGAN_x4plus", "bf16", "q", (347, 0, 1, 0), [("conv3x3_fused", (3, 64))]),
        # fp32: the wide convs on bf16x3 (counted first in ``split``), the
        # stem and the chain tail's conv_last on narrow's fp32 instances
        ("RealESRGAN_x4plus", "fp32", "chain", (349, 0, 2, 0),
         [("conv3x3_fused", (3, 64)), ("tail_fused", (64, 3))]),
        ("RealESRGAN_x2plus", "fp32", "chain", (349, 0, 2, 0),
         [("conv3x3_fused", (12, 64)), ("tail_fused", (64, 3))]),
        ("RealESRGAN_x4_v3", "fp32", None, (32, 0, 1, 0), [("conv3x3_fused", (3, 64))]),
        # the VRT_TAIL_Q=1 fp32 tail: one launch, conv_last inside it
        ("RealESRGAN_x4plus", "fp32", "q", (347, 0, 1, 0), [("conv3x3_fused", (3, 64))]),
    ],
)
def test_routes_per_frame(monkeypatch, name, precision, tail_mode, split, narrow):
    spec = MODEL_ZOO[name].spec
    dt = F32 if precision == "fp32" else BF
    if tail_mode is None:
        net = SRVGGNet(spec).prepare(dt, "cpu", precision=precision)
    else:
        net = RRDBNet(spec).prepare(dt, "cpu", precision=precision, tail=tail_mode)
    calls = _record(monkeypatch)
    y = net(torch.rand(1, 8, 8, 3))
    assert y.shape == (1, 8 * spec.scale, 8 * spec.scale, 3)
    # (the tensor-core route: wgmma, bf16x3 in fp32; mma, narrow, fma)
    n = {r: sum(1 for _, r_, _ in calls if r_ == r) for r in tail.ROUTES}
    tc = "bf16x3" if precision == "fp32" else "wgmma"
    assert (n[tc], n["mma"], n["narrow"], n["fma"]) == split
    assert n["wgmma" if precision == "fp32" else "bf16x3"] == 0
    assert [(c, wh) for c, r, wh in calls if r == "narrow"] == narrow


# ---- the function at the narrow widths, against JAX ----------------------------


def _mk(rng, *shape, scale=1.0, shift=0.0):
    return ((rng.random(shape) - 0.5) * 2 * scale + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize(
    "cin,cout,act",
    [(3, 64, "none"), (3, 64, "prelu"), (12, 64, "none"), (64, 3, "none")],
)
def test_the_narrow_widths_match_pallas(rng, cin, cout, act):
    from video_restore_tpu.ops.pallas_tail import conv3x3_fused as jax_conv

    x = _mk(rng, 2, 9, 11, cin)
    w = _mk(rng, 3, 3, cin, cout, scale=0.1)
    b = _mk(rng, cout, scale=0.05)
    alpha = _mk(rng, cout, scale=0.25, shift=0.25) if act == "prelu" else None
    ref = jax_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), None,
        None if alpha is None else jnp.asarray(alpha),
        act=act, block_h=4, interpret=True,
    )
    got = conv3x3_fused(_t(x), _t(w), _t(b), None, None if alpha is None else _t(alpha), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
