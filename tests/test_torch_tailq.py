"""The port's one-launch tail (``tail_fused_q``, the ``VRT_TAIL_Q=1`` tail
mode of RRDBNet) against the JAX package, on the CPU.

- ``tail_fused_q`` (its plain version on CPU tensors), fed by the port's
  ``up1_fused``, against the Pallas quad tail ``up1_fused(masked=True)`` ->
  ``tail_fused_q`` in interpret mode and against the XLA chain, fp32, at the
  shapes of ``tests/test_pallas_stripe.py::test_tail_fused_q_parity`` (nf 8,
  12x16 and 10x20, ``block_h=4``, biases shifted +0.3 away from the
  leaky-relu kink, where a sum taken in another order may change a sign):
  rtol = atol = 2e-4, that test's tolerance (fp32 sums in another order over
  a chain of four convs).
- ``RRDBNet`` prepared with ``tail="q"`` (nf 16, gc 8, one block; scale 4,
  and scale 2 with the unshuffled stem, which also has ``conv_up2``) against
  JAX ``apply_rrdbnet`` with ``VRT_TAIL_KERNEL=1 VRT_TAIL_Q=1`` and the tail
  kernels in interpret mode: rtol = atol = 2e-3, the tolerance of the JAX
  package's own full-model tail tests; and against ``apply_rrdbnet(
  naive=True)`` at 1e-4 (as ``tests/test_torch_rrdbnet.py``).
- The knob: ``tail_mode`` is ``"chain"`` on the CPU even with
  ``VRT_TAIL_Q=1`` and follows the knob on a CUDA device; a single-upsample
  net (BSRGANx2's spec, no ``conv_up2``) ignores the mode; ``"q"`` combines
  with the ``"pallas"`` body and with ``precision="int8"`` and changes only
  the tail call.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.models import rrdbnet as port
from video_restore_tpu_torch.ops import _build
from video_restore_tpu_torch.ops import tail as port_tail

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("h1,w1", [(12, 16), (10, 20)])
def test_tail_fused_q_matches_pallas_quad_tail(rng, h1, w1):
    from video_restore_tpu.ops.conv import conv2d, leaky_relu, upconv2x
    from video_restore_tpu.ops.pallas_tail import tail_fused_q, up1_fused

    nf = 8

    def mk(*s, shift=0.0):
        return (rng.random(s) * 0.1 + shift).astype(np.float32)

    x1 = rng.random((1, h1, w1, nf)).astype(np.float32)
    wu1, bu1 = mk(3, 3, nf, nf), mk(nf, shift=0.3)
    tw = [
        mk(3, 3, nf, nf), mk(nf, shift=0.3),
        mk(3, 3, nf, nf), mk(nf, shift=0.3),
        mk(3, 3, nf, 3), mk(3),
    ]
    jw = [jnp.asarray(a) for a in tw]
    xq = up1_fused(
        jnp.asarray(x1), jnp.asarray(wu1), jnp.asarray(bu1), masked=True,
        block_h=4, interpret=True,
    )
    ref_q = np.asarray(
        tail_fused_q(xq, *jw, h2=2 * h1, w1=w1, block_h=4, interpret=True)
    )
    f = leaky_relu(upconv2x(jnp.asarray(x1), jnp.asarray(wu1), jnp.asarray(bu1)))
    f = leaky_relu(upconv2x(f, jw[0], jw[1]))
    f = leaky_relu(conv2d(f, jw[2], jw[3]))
    ref_xla = np.asarray(conv2d(f, jw[4], jw[5]))

    _build.reset_launches()
    up = port_tail.up1_fused(_t(x1), _t(wu1), _t(bu1))
    got = port_tail.tail_fused_q(up, *[_t(a) for a in tw])
    assert _build.launches() == {}  # CPU tensors: the plain versions
    assert got.shape == ref_q.shape == (1, 4 * h1, 4 * w1, 3)
    np.testing.assert_allclose(got.numpy(), ref_q, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), ref_xla, rtol=2e-4, atol=2e-4)
    # one function, two kernel routes: the chain of three convs
    chain = port_tail.tail_fused(up, *[_t(a) for a in tw])
    np.testing.assert_array_equal(got.numpy(), chain.numpy())


def test_tail_fused_q_rounds_both_intermediates_to_bf16(rng):
    """In bf16 the plain version rounds upconv2's and conv_hr's outputs to
    bf16 as they are stored, as ``_tail_q_kernel`` does (``post_u2``,
    ``post_hr``): it equals the three convs applied one by one with a bf16
    tensor between them, and differs from the same chain kept in fp32."""
    from video_restore_tpu_torch.ops.tail import conv3x3_plain

    nf = 8
    bf = torch.bfloat16
    x = _t(rng.random((1, 6, 7, nf))).to(bf)
    tw = [
        _t(rng.random((3, 3, nf, nf)) - 0.5).to(bf), _t(rng.random(nf) * 0.1).to(bf),
        _t(rng.random((3, 3, nf, nf)) - 0.5).to(bf), _t(rng.random(nf) * 0.1).to(bf),
        _t(rng.random((3, 3, nf, 3)) - 0.5).to(bf), _t(rng.random(3) * 0.1).to(bf),
    ]
    got = port_tail.tail_fused_q(x, *tw)
    assert got.dtype == bf and got.shape == (1, 12, 14, 3)
    u2 = conv3x3_plain(x, tw[0], tw[1], act="lrelu", upsample2=True)
    hr = conv3x3_plain(u2, tw[2], tw[3], act="lrelu")
    assert u2.dtype == hr.dtype == bf
    assert torch.equal(got, conv3x3_plain(hr, tw[4], tw[5]))
    f32 = port_tail.tail_fused_q(x.float(), *[t.float() for t in tw])
    assert not torch.equal(got.float(), f32.to(bf).float())


def _interpret_tail(pt):
    """Patches that run the JAX tail kernels in interpret mode."""
    patches = []
    for name in ("up1_fused", "tail_fused_q"):
        orig = getattr(pt, name)

        def interp(*a, _orig=orig, **k):
            k["interpret"] = True
            return _orig(*a, **k)

        patches.append(mock.patch.object(pt, name, interp))
    return patches


@pytest.mark.parametrize("scale", [4, 2])
def test_rrdbnet_tail_q_matches_jax_vrt_tail_q(rng, monkeypatch, scale):
    import contextlib

    import video_restore_tpu.ops.pallas_tail as pt
    from video_restore_tpu.models.rrdbnet import (
        RRDBNetSpec,
        _apply,
        apply_rrdbnet,
        init_rrdbnet,
    )

    spec_kw = dict(num_feat=16, num_block=1, num_grow_ch=8, scale=scale)
    spec = RRDBNetSpec(**spec_kw)
    params = init_rrdbnet(jax.random.PRNGKey(7), spec)
    assert "conv_up2" in params
    x = rng.random((1, 18, 22, 3)).astype(np.float32)
    naive = np.asarray(apply_rrdbnet(params, jnp.asarray(x), spec, naive=True))

    monkeypatch.setenv("VRT_TAIL_KERNEL", "1")
    monkeypatch.setenv("VRT_TAIL_Q", "1")
    called = []
    orig_q = pt.tail_fused_q
    _apply.clear_cache()
    with contextlib.ExitStack() as st:
        for p in _interpret_tail(pt):
            st.enter_context(p)
        interp_q = pt.tail_fused_q

        def counted(*a, **k):
            called.append(1)
            return interp_q(*a, **k)

        st.enter_context(mock.patch.object(pt, "tail_fused_q", counted))
        ref = np.asarray(apply_rrdbnet(params, jnp.asarray(x), spec, use_pallas=False))
    _apply.clear_cache()
    assert called and orig_q is pt.tail_fused_q  # the quad tail ran; patches undone

    net = port.RRDBNet(port.RRDBNetSpec(**spec_kw))
    net.load_state_dict(port.params_from_jax(jax.tree.map(np.asarray, params)))
    net.prepare(torch.float32, "cpu", tail="q")
    assert net.tail == "q"
    with mock.patch.object(port, "tail_fused_q", wraps=port.tail_fused_q) as q, \
            mock.patch.object(port, "tail_fused", wraps=port.tail_fused) as chain:
        got = net(_t(x)).numpy()
    assert q.call_count == 1 and chain.call_count == 0
    assert got.shape == ref.shape == (1, 18 * scale, 22 * scale, 3)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, naive, rtol=1e-4, atol=1e-4)
    # the plain path takes the tail's plain version
    with mock.patch.object(port, "tail_fused_q_plain", wraps=port.tail_fused_q_plain) as qp:
        plain = net(_t(x), plain=True).numpy()
    assert qp.call_count == 1
    np.testing.assert_array_equal(plain, got)


def test_tail_mode_follows_the_knob_on_cuda_only(monkeypatch):
    monkeypatch.delenv("VRT_TAIL_Q", raising=False)
    assert port.tail_mode("cpu") == "chain" and port.tail_mode("cuda") == "chain"
    monkeypatch.setenv("VRT_TAIL_Q", "1")
    assert port.tail_mode("cpu") == "chain"
    assert port.tail_mode("cuda") == "q" and port.tail_mode(torch.device("cuda", 0)) == "q"
    monkeypatch.setenv("VRT_TAIL_Q", "0")
    assert port.tail_mode("cuda") == "chain"
    with pytest.raises(ValueError):
        port.RRDBNet(port.RRDBNetSpec(num_feat=16, num_block=1, num_grow_ch=8)).prepare(
            torch.float32, "cpu", tail="quad"
        )


def test_model_handle_resolves_tail_mode(monkeypatch):
    """``ModelHandle.module`` reads the knob as it reads ``VRT_PALLAS``: on
    the CPU both stay at their defaults."""
    from video_restore_tpu_torch.models.zoo import random_model

    monkeypatch.setenv("VRT_TAIL_Q", "1")
    monkeypatch.setenv("VRT_PALLAS", "1")
    handle = random_model("RealESRGAN_x4plus_anime_6B", seed=0)
    net = handle.module(torch.float32, "cpu")
    assert (net.mode, net.tail) == ("stripe", "chain")
    with mock.patch.object(port, "tail_mode", return_value="q") as tm:
        net = handle.module(torch.float32, "cpu")
    tm.assert_called_once_with("cpu")
    assert (net.mode, net.tail) == ("stripe", "q")


def test_single_upsample_net_ignores_tail_mode(rng):
    """BSRGANx2's spec (scale 2, no unshuffle) has one upsample stage and no
    ``conv_up2``: mode "q" leaves its two-conv tail as it is."""
    spec = port.RRDBNetSpec(
        num_feat=16, num_block=1, num_grow_ch=8, scale=2, unshuffle=False,
        key_style="esrgan",
    )
    assert spec.num_upsample == 1
    sd = port.init_params(spec, torch.Generator().manual_seed(3))
    x = _t(rng.random((1, 9, 11, 3)))
    outs = {}
    for tail in port.TAIL_MODES:
        net = port.RRDBNet(spec)
        assert not hasattr(net, "conv_up2")
        net.load_state_dict(sd)
        net.prepare(torch.float32, "cpu", tail=tail)
        with mock.patch.object(port, "tail_fused_q", wraps=port.tail_fused_q) as q:
            outs[tail] = net(x)
        assert q.call_count == 0
    assert outs["q"].shape == (1, 18, 22, 3)
    assert torch.equal(outs["q"], outs["chain"])


@pytest.mark.parametrize(
    "mode,precision", [("stripe", "bf16"), ("pallas", "bf16"), ("stripe", "int8"), ("pallas", "int8")]
)
def test_tail_q_combines_with_body_mode_and_precision(rng, mode, precision):
    """The tail mode is independent of the body: with either body and either
    precision, ``tail="q"`` swaps the tail call and nothing else, so the
    output equals the chain tail's (one function on the CPU)."""
    spec = port.RRDBNetSpec(num_feat=16, num_block=1, num_grow_ch=8, scale=4)
    sd = port.init_params(spec, torch.Generator().manual_seed(5))
    x = _t(rng.random((1, 10, 12, 3)))
    outs, calls = {}, {}
    for tail in port.TAIL_MODES:
        net = port.RRDBNet(spec)
        net.load_state_dict(sd)
        net.prepare(torch.float32, "cpu", precision, mode, tail)
        assert net.mode == mode and net.tail == tail
        assert net.precision == ("bf16" if mode == "pallas" else precision)
        with mock.patch.object(port, "tail_fused_q", wraps=port.tail_fused_q) as q, \
                mock.patch.object(port, "tail_fused", wraps=port.tail_fused) as chain, \
                mock.patch.object(port, "rrdb_fused", wraps=port.rrdb_fused) as k5, \
                mock.patch.object(port, "rdb_fused_i8", wraps=port.rdb_fused_i8) as k4, \
                mock.patch.object(port, "rdb_fused", wraps=port.rdb_fused) as k1:
            outs[tail] = net(x)
        calls[tail] = (q.call_count, chain.call_count)
        body = (k5.call_count, k4.call_count, k1.call_count)
        expect = (1, 0, 0) if mode == "pallas" else (0, 3, 0) if precision == "int8" else (0, 0, 3)
        assert body == expect
    assert calls == {"chain": (0, 1), "q": (1, 0)}
    assert outs["q"].shape == (1, 40, 48, 3)
    assert torch.equal(outs["q"], outs["chain"])
