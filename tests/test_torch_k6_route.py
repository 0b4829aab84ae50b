"""Which kernel each one-launch tail call of the port takes on the card,
and the tail's plain version against the JAX quad tail.

The one-launch tail (upconv2 -> conv_hr -> conv_last) is one function
behind three hand-written CUDA kernels: ``"wgmma"``
(``csrc/tail_fused_wgmma.cu``: Hopper's tensor cores over rolling rows),
K6's ``"mma"`` (``csrc/tail_fused_mma.cu``: ``mma.sync``, forced beside it)
and ``"fma"`` (``csrc/tail_fused.cu``: fp32 FMAs), all summing in the order
of K1's tensor-core route. ``ops/tail.py::tail_fused_q`` (the
``VRT_TAIL_Q=1`` tail) launches it; so does ``tail_fused`` (the default
tail) where ``chain_route`` takes the call, else it runs as three K1
launches. ``tail_fused_route`` and ``chain_route`` choose from the call
alone, so the choice is tested here, on the CPU, without a kernel: each
model runs on a tiny frame through the plain versions while a recorder asks
the route of each tail call. The numbers are the ones the chip smoke test
asserts on the card: one ``tail_fused_q:wgmma`` per frame of the
``VRT_TAIL_Q=1`` flagship, one ``tail_fused:wgmma`` per frame of the
default one.

The plain version the kernels are held to on the card is held here against
the JAX ``tail_fused_q`` (``pallas_tail.py:1018``) fed by ``up1_fused(
masked=True)``, both in interpret mode, at nf 16 on inputs built with
numpy (biases shifted +0.3 away from the leaky-relu kink): fp32, rtol = atol
= 2e-4, the tolerance of ``tests/test_torch_tailq.py`` and of the JAX
package's own quad-tail test (fp32 sums in another order over a chain of
four convs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.models import rrdbnet as rrdbnet_mod
from video_restore_tpu_torch.models.rrdbnet import RRDBNet, RRDBNetSpec
from video_restore_tpu_torch.models.zoo import MODEL_ZOO
from video_restore_tpu_torch.ops import _build, tail

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize(
    "dtype,nf,aligned,route",
    [
        (BF, 64, True, "wgmma"),  # every RRDBNet of the zoo
        (BF, 64, False, "fma"),   # an operand off a 16-byte boundary
        (F32, 64, True, "bf16x3"),  # fp32: three bf16 parts a value on the same tensor cores
        (F32, 64, False, "fma"),  # an fp32 operand off a 16-byte boundary
        (BF, 16, True, "fma"),    # the narrow width of the tests and checks
        (F32, 16, True, "fma"),
        (BF, 32, True, "fma"),    # a width no kernel is built for
    ],
)
def test_tail_fused_route(dtype, nf, aligned, route):
    assert tail.tail_fused_route(dtype, nf, aligned) == route
    assert route in tail.ROUTES and route in tail.TAIL_ROUTES


def _operands(nf, dt, b=1, h=4, w=5):
    return [torch.zeros(b, h, w, nf, dtype=dt), torch.zeros(3, 3, nf, nf, dtype=dt),
            torch.zeros(nf, dtype=dt), torch.zeros(3, 3, nf, nf, dtype=dt),
            torch.zeros(nf, dtype=dt)]


def test_a_forced_route_is_checked():
    """``route="mma"`` and ``route="fma"`` reach K6's kernels for a
    side-by-side timing; no tensor-core kernel is forced onto a call it is
    not built for."""
    ops = _operands(64, BF)
    assert tail._pick_tail_route(*ops, None) == "wgmma"
    assert tail._pick_tail_route(*ops, "wgmma") == "wgmma"
    assert tail._pick_tail_route(*ops, "fma") == "fma"
    assert tail._pick_tail_route(*ops, "mma") == "mma"
    for route in ("mma", "wgmma"):
        with pytest.raises(ValueError, match="bf16 at nf 64"):
            tail._pick_tail_route(*_operands(64, F32), route)
        with pytest.raises(ValueError, match="bf16 at nf 64"):
            tail._pick_tail_route(*_operands(16, BF), route)
    with pytest.raises(ValueError, match="unknown route"):
        tail._pick_tail_route(*ops, "chain")


def test_a_misaligned_input_takes_fma():
    """A view of x that starts off a 16-byte boundary is not the tensor-core
    kernel's: its route is ``"fma"`` and a forced ``"mma"`` raises."""
    buf = torch.zeros(1 * 4 * 5 * 64 + 1, dtype=BF)
    x = buf[1:].view(1, 4, 5, 64)
    assert x.data_ptr() % 16 and x.is_contiguous()
    ops = [x] + _operands(64, BF)[1:]
    assert tail._pick_tail_route(*ops, None) == "fma"
    assert tail.chain_route(*ops) == "chain"
    for route in ("mma", "wgmma"):
        with pytest.raises(ValueError, match="bf16 at nf 64"):
            tail._pick_tail_route(*ops, route)


def _record(monkeypatch):
    """Patch the model's ``tail_fused_q`` with a recorder of each call's
    route; the wrapper (the plain version, on CPU tensors) still computes."""
    calls = []
    real = rrdbnet_mod.tail_fused_q

    def recorder(x, w_up2, b_up2, w_hr, b_hr, *rest, **kw):
        calls.append(tail._pick_tail_route(x, w_up2, b_up2, w_hr, b_hr, None))
        return real(x, w_up2, b_up2, w_hr, b_hr, *rest, **kw)

    monkeypatch.setattr(rrdbnet_mod, "tail_fused_q", recorder)
    return calls


@pytest.mark.parametrize("frames", [1, 2])
def test_flagship_tail_q_takes_wgmma_once_per_frame(monkeypatch, frames):
    """RealESRGAN_x4plus at full width in bf16 with ``VRT_TAIL_Q=1`` (the
    tail mode a CUDA device resolves): one call per frame, on Hopper's
    tensor cores (``"wgmma"``), and no three-launch tail."""
    monkeypatch.setenv("VRT_TAIL_Q", "1")
    mode = rrdbnet_mod.tail_mode("cuda")
    assert mode == "q"
    spec = MODEL_ZOO["RealESRGAN_x4plus"].spec
    assert (spec.num_feat, spec.num_block) == (64, 23)
    net = RRDBNet(spec).prepare(BF, "cpu", tail=mode)
    calls = _record(monkeypatch)
    chain = []
    real_chain = rrdbnet_mod.tail_fused
    monkeypatch.setattr(rrdbnet_mod, "tail_fused",
                        lambda *a, **k: chain.append(1) or real_chain(*a, **k))
    _build.reset_launches()
    for _ in range(frames):
        y = net(torch.rand(1, 5, 6, 3))
        assert y.shape == (1, 20, 24, 3) and y.dtype == BF
    assert calls == ["wgmma"] * frames and chain == []
    assert _build.launches() == {}  # CPU tensors: the plain versions


def _record_chain(monkeypatch):
    """Patch the model's ``tail_fused`` with a recorder of each call's
    ``chain_route``; the wrapper (the plain versions, on CPU tensors) still
    computes, and each K1 call of a chain is recorded too."""
    calls, k1 = [], []
    real, real_k1 = rrdbnet_mod.tail_fused, tail.conv3x3

    def recorder(*a, **kw):
        calls.append(tail.chain_route(*a))
        return real(*a, **kw)

    def k1_recorder(x, w, b, *, counter, **kw):
        k1.append(counter)
        return real_k1(x, w, b, counter=counter, **kw)

    monkeypatch.setattr(rrdbnet_mod, "tail_fused", recorder)
    monkeypatch.setattr(tail, "conv3x3", k1_recorder)
    return calls, k1


@pytest.mark.parametrize("name", ["RealESRGAN_x4plus", "RealESRGAN_x2plus",
                                  "RealESRGAN_x4plus_anime_6B"])
@pytest.mark.parametrize("frames", [1, 2])
def test_the_default_tail_takes_the_one_launch_route(monkeypatch, name, frames):
    """The default ``"chain"`` tail mode of every RRDBNet of the zoo, in
    bf16 at full width: one ``tail_fused`` call per frame on the ``"wgmma"``
    route, so no K1 launch of upconv2, conv_hr or conv_last (the chip smoke
    test's ``tail_fused:wgmma`` once a frame, ``conv3x3:mma`` 0)."""
    monkeypatch.delenv("VRT_TAIL_Q", raising=False)
    assert rrdbnet_mod.tail_mode("cuda") == "chain"
    spec = MODEL_ZOO[name].spec
    net = RRDBNet(spec).prepare(BF, "cpu")
    calls, k1 = _record_chain(monkeypatch)
    for _ in range(frames):
        y = net(torch.rand(1, 6, 8, 3))  # even: x2plus unshuffles by 2
        assert y.shape == (1, 6 * spec.scale, 8 * spec.scale, 3)
    assert calls == ["wgmma"] * frames and "tail_fused" not in k1


@pytest.mark.parametrize("dt,nf,gc", [(F32, 64, 32), (BF, 16, 8), (F32, 16, 8)])
def test_the_default_tail_of_fp32_and_narrow_models_is_the_chain(monkeypatch, dt, nf, gc):
    """fp32 and nf 16: ``tail_fused`` runs as its three K1 calls."""
    net = RRDBNet(RRDBNetSpec(num_feat=nf, num_block=1, num_grow_ch=gc, scale=4))
    net.prepare(dt, "cpu")
    calls, k1 = _record_chain(monkeypatch)
    net(torch.rand(1, 5, 6, 3))
    assert calls == ["chain"] and k1.count("tail_fused") == 3


def test_a_forced_chain_route_is_checked():
    """``route="chain"`` takes every call (the side-by-side timing of the
    three K1 launches); ``route="wgmma"`` only bf16 at nf 64 with aligned
    operands; and both give the plain version's bits on the CPU."""
    g = torch.Generator().manual_seed(3)

    def r(*shape):
        return ((torch.rand(*shape, generator=g) - 0.5) * 0.2).to(BF)

    tw = [r(3, 3, 64, 64), r(64), r(3, 3, 64, 64), r(64), r(3, 3, 64, 3), r(3)]
    x = r(1, 4, 5, 64)
    assert tail.chain_route(x, *tw) == "wgmma"
    assert tail.chain_route(x, *tw, route="chain") == "chain"
    with pytest.raises(ValueError, match="unknown route"):
        tail.chain_route(x, *tw, route="mma")
    with pytest.raises(ValueError, match="bf16 at nf 64"):
        tail.chain_route(x.float(), *(t.float() for t in tw), route="wgmma")
    want = tail.tail_fused_plain(x, *tw)
    assert torch.equal(tail.tail_fused(x, *tw), want)
    assert torch.equal(tail.tail_fused(x, *tw, route="chain"), want)


@pytest.mark.parametrize("dt,nf,gc", [(F32, 64, 32), (BF, 16, 8), (F32, 16, 8)])
def test_tail_q_of_fp32_and_narrow_models_takes_fma(monkeypatch, dt, nf, gc):
    """The narrow widths take K6's fp32-FMA kernel; fp32 at nf 64 the
    one-launch tail on three bf16 parts a value (``"bf16x3"``)."""
    net = RRDBNet(RRDBNetSpec(num_feat=nf, num_block=1, num_grow_ch=gc, scale=4))
    net.prepare(dt, "cpu", tail="q")
    calls = _record(monkeypatch)
    net(torch.rand(1, 5, 6, 3))
    assert calls == ["bf16x3" if (dt, nf) == (F32, 64) else "fma"]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("b,h1,w1", [(1, 12, 16), (2, 10, 12), (1, 7, 9)])
def test_tail_fused_q_plain_matches_pallas_at_nf16(rng, b, h1, w1):
    from video_restore_tpu.ops.pallas_tail import tail_fused_q, up1_fused

    nf = 16

    def mk(*s, shift=0.0):
        return (rng.random(s) * 0.1 + shift).astype(np.float32)

    x1 = rng.random((b, h1, w1, nf)).astype(np.float32)
    wu1, bu1 = mk(3, 3, nf, nf), mk(nf, shift=0.3)
    tw = [
        mk(3, 3, nf, nf), mk(nf, shift=0.3),
        mk(3, 3, nf, nf), mk(nf, shift=0.3),
        mk(3, 3, nf, 3), mk(3),
    ]
    xq = up1_fused(jnp.asarray(x1), jnp.asarray(wu1), jnp.asarray(bu1), masked=True,
                   block_h=4, interpret=True)
    ref = np.asarray(tail_fused_q(xq, *(jnp.asarray(a) for a in tw), h2=2 * h1, w1=w1,
                                  block_h=4, interpret=True))
    up = tail.up1_fused_plain(_t(x1), _t(wu1), _t(bu1))
    got = tail.tail_fused_q_plain(up, *(_t(a) for a in tw))
    assert got.shape == ref.shape == (b, 4 * h1, 4 * w1, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    _build.reset_launches()
    assert torch.equal(tail.tail_fused_q(up, *(_t(a) for a in tw)), got)
    assert _build.launches() == {}
