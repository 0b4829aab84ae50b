"""The port's W8A8 int8 body (``--precision int8``) against the JAX package.

- W8: ``quantize_conv_weights`` on each RDB conv (segments x, c1 .. c4)
  equals ``quantize_prefix_weights(production_prefix_weights(
  prefix_rdb_weights(rdb)))`` after the layout is mapped, int8 and scales
  exactly; on the SRVGG body it equals ``quantize_prefix_weights`` of the
  dy-folded (roll) and N-packed (pack) stacks exactly.
- A8: ``quant_act_plain`` equals ``_quant_act`` exactly (int8 values and
  the scale), bf16 and fp32, on random data and on a grid of ties.
- One RDB (plain, and rdb3's ``x0`` form) against ``rdb_stripe_padded`` /
  ``rdb_res_stripe_padded(sws=...)`` in interpret mode at one-stripe
  geometry (B 2, 32x48, ``block_h=32``, one row chunk): bf16 exact, fp32
  within 1e-6 (XLA may fuse the fp32 dequantise-and-add differently). With
  2D blocks (``rdb_stripe2d_padded`` at 64x96, ``rdb_stripe2d_split`` at
  96x144, blocks 32x48) JAX scales per block window and the port per image:
  both stay > 50 dB from the fp32 naive RDB, and the port is within 4 bf16
  steps (of the output's largest value) of JAX.
- The SRVGG body against ``srvgg_stripe_padded(sws=...)`` the same way
  (one stripe: bf16 exact, fp32 within 1e-6). With ``srvgg_stripe2d_padded``
  at 64x96 each of the four chained convs quantises with other scales, so
  the port and JAX carry two draws of the quantisation noise: both > 45 dB
  from the fp32 chain, and > 45 dB from each other.
- The whole model against JAX ``_apply(stripe=True, precision="int8")``
  with the Pallas calls in interpret mode (one stripe per image), fp32:
  within 2e-3 (the stem and tail sum in another order than XLA, and a
  value at a rounding boundary of the A8 quantiser may then move by one
  int8 step).
- The restore step on the CPU: int8 against bf16 on u8 (RRDBNet >= 40 dB,
  SRVGGNetCompact >= 35 dB).
- Static A8 (``sas``): ``calibrate_rdb_act_scales`` against JAX's on the
  same RDB and input (five floats, relative 1e-6: fp32 convs summed in
  another order); ``quant_act_static_plain`` equal to ``_quant_act_static``
  (bf16 and fp32, with values that saturate); one static RDB against
  ``rdb_stripe2d_padded(sws=..., sas=..., interpret=True)`` at the
  multi-block geometry of
  ``tests/test_pallas_stripe.py::test_rdb_stripe2d_int8_static_interpret``
  (nf 16, gc 8, 96x144, blocks 32x48), where a fixed scale is the same for
  every block, so unlike the dynamic form the two must agree: bf16 exact,
  fp32 within 1e-6, and > 45 dB from the fp32 naive RDB; and ``bench_rdb
  int8s`` on the CPU at a tiny shape.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.ops.quant import (
    quant_act_plain,
    quant_act_static_plain,
    quantize_conv_weights,
    rdb_segments,
)
from video_restore_tpu_torch.ops.srvgg import srvgg_body_i8, srvgg_body_i8_plain
from video_restore_tpu_torch.ops.stripe import rdb_fused_i8, rdb_fused_i8_plain

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

NF, GC = 16, 8


def _t(a, dt=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dt)


def _mk(rng, *shape, scale=1.0, shift=0.0):
    return ((rng.random(shape) - 0.5) * 2 * scale + shift).astype(np.float32)


def _bf16(a):
    """numpy fp32 holding bf16-representable values (rounded once)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _psnr(a, ref):
    mse = np.mean((a.astype(np.float64) - ref.astype(np.float64)) ** 2)
    span = float(ref.max() - ref.min())
    return 10 * np.log10(span * span / max(mse, 1e-20))


def _within_bf16_steps(got, ref, n):
    """|got - ref| <= n bf16 steps (2^-7 relative) of ref's largest value."""
    step = np.exp2(np.floor(np.log2(np.abs(ref).max())) - 7)
    err = np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32)).max()
    assert err <= n * step, (err, step)


def _rdb_case(rng, bf16):
    """numpy weights of one RDB (nf 16, gc 8) at an informative scale."""
    ws = [_mk(rng, 3, 3, NF + k * GC, GC if k < 4 else NF, scale=0.08) for k in range(5)]
    bs = [_mk(rng, GC if k < 4 else NF, scale=0.05) for k in range(5)]
    if bf16:
        ws, bs = [_bf16(w) for w in ws], [_bf16(b) for b in bs]
    return ws, bs


def _jax_rdb(ws, bs, jdt):
    rdb = {
        f"conv{k + 1}": {"w": jnp.asarray(ws[k], jdt), "b": jnp.asarray(bs[k], jdt)}
        for k in range(5)
    }
    return rdb


def _jax_quant_rdb(ws, bs, jdt):
    """JAX's W8 of one RDB: production prefix form, then int8."""
    from video_restore_tpu.ops.pallas_stripe import (
        prefix_rdb_weights,
        production_prefix_weights,
        quantize_prefix_weights,
    )

    pws, pbs = prefix_rdb_weights(_jax_rdb(ws, bs, jdt), NF, GC)
    qws, sws = quantize_prefix_weights(production_prefix_weights(pws))
    return qws, sws, pbs


def _port_quant_rdb(ws, dt):
    qs = [quantize_conv_weights(_t(ws[k], dt), rdb_segments(NF, GC, k + 1)) for k in range(5)]
    return [q for q, _ in qs], [s for _, s in qs]


@pytest.mark.parametrize("bf16", [False, True])
def test_w8_rdb_matches_quantize_prefix_weights(rng, bf16):
    from video_restore_tpu.ops.pallas_stripe import (
        prefix_rdb_weights,
        production_prefix_weights,
    )

    ws, bs = _rdb_case(rng, bf16)
    dt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    qws, sws, _ = _jax_quant_rdb(ws, bs, jdt)
    wq, sw = _port_quant_rdb(ws, dt)
    for k in range(5):
        assert wq[k].dtype == torch.int8 and sw[k].shape == (k + 1, ws[k].shape[-1])
    # int8: the port's per-conv HWIO weights through JAX's layout transforms
    rdb_q = {
        f"conv{k + 1}": {"w": jnp.asarray(wq[k].numpy()), "b": jnp.asarray(bs[k])}
        for k in range(5)
    }
    mapped = production_prefix_weights(prefix_rdb_weights(rdb_q, NF, GC)[0])
    for s in range(5):
        assert np.asarray(qws[s]).dtype == np.int8
        np.testing.assert_array_equal(np.asarray(mapped[s]), np.asarray(qws[s]))
    # scales: source s's columns are destinations conv5, conv4, .., conv_{s+1}
    for s in range(5):
        cols = [sw[k][s].numpy() for k in range(4, s - 1, -1)]
        np.testing.assert_array_equal(np.concatenate(cols), np.asarray(sws[s]))


@pytest.mark.parametrize("kform", ["roll", "pack"])
def test_w8_srvgg_matches_quantize_prefix_weights(rng, kform):
    from video_restore_tpu.ops.pallas_srvgg import fold_dy
    from video_restore_tpu.ops.pallas_stripe import quantize_prefix_weights

    n, g = 8, 4
    w = _bf16(_mk(rng, n, 3, 3, NF, NF, scale=0.2))

    def layout(a):
        a = fold_dy(jnp.asarray(a))  # (n, 3, 3nf, nf), as srvgg._apply
        if kform == "pack":
            return jnp.swapaxes(a, -3, -2).reshape(n // g, g, 3 * NF, 3 * NF)
        return a.reshape(n // g, g, 3, 3 * NF, NF)

    (qj,), (sj,) = quantize_prefix_weights((layout(jnp.asarray(w, jnp.bfloat16)),))
    qs = [quantize_conv_weights(_t(w[i], torch.bfloat16), (0, NF)) for i in range(n)]
    wq = torch.stack([q for q, _ in qs])
    sw = torch.cat([s for _, s in qs])
    np.testing.assert_array_equal(np.asarray(layout(wq.numpy())), np.asarray(qj))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(sj).reshape(n, NF))


def _ties():
    """The grid of test_pallas_stripe.py::test_quant_act_bitwise_rounding:
    integers and halves across the int8 range, amax 127 (scale 1.0)."""
    vals = np.concatenate([
        np.arange(-127, 128, dtype=np.float32),
        np.arange(-126, 127, dtype=np.float32) + 0.5,
        np.array([-127.0, 127.0], np.float32),
    ])
    return np.pad(vals, (0, (-vals.size) % 8)).reshape(1, -1, 8)


@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("bf16", [False, True])
def test_a8_matches_quant_act(rng, case, bf16):
    from video_restore_tpu.ops.pallas_stripe import _quant_act

    a = _ties() if case == "ties" else _mk(rng, 12, 40, 24, scale=3.7, shift=0.4)
    if bf16:
        a = _bf16(a)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    qj, sj = jax.jit(_quant_act)(jnp.asarray(a, jdt))
    q, sa = quant_act_plain(_t(a, torch.bfloat16 if bf16 else torch.float32)[None])
    assert q.dtype == torch.int8 and np.asarray(qj).dtype == np.int8
    np.testing.assert_array_equal(q[0].numpy(), np.asarray(qj))
    np.testing.assert_array_equal(sa.numpy(), np.asarray(sj).reshape(1))
    if case == "ties":
        assert sa.item() == 1.0
        ref = np.clip(np.trunc(a + np.copysign(0.5, a)), -127, 127)
        np.testing.assert_array_equal(q[0].numpy(), ref)


def _port_rdb(x, ws, bs, x0, dt):
    wq, sw = _port_quant_rdb(ws, dt)
    out, amax = rdb_fused_i8_plain(
        _t(x, dt), wq, sw, [_t(b, dt) for b in bs], None if x0 is None else _t(x0, dt)
    )
    # the returned amax is the output's per-image |max|
    np.testing.assert_array_equal(amax.numpy(), out.float().abs().amax(dim=(1, 2, 3)).numpy())
    return out.float().numpy()


@pytest.mark.parametrize("with_x0", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_rdb_i8_matches_pallas_one_stripe(rng, with_x0, bf16):
    """rdb_stripe_padded / rdb_res_stripe_padded (#9/#10) with sws, one
    stripe and one chunk per image: the JAX scale is the port's."""
    from video_restore_tpu.ops.pallas_stripe import (
        pad_stripe_entry,
        rdb_res_stripe_padded,
        rdb_stripe_padded,
        unpad_stripe_exit,
    )

    b, h, w, bh = 2, 32, 48, 32
    ws, bs = _rdb_case(rng, bf16)
    x = _mk(rng, b, h, w, NF, scale=1.5)
    x0 = _mk(rng, b, h, w, NF) if with_x0 else None
    if bf16:
        x = _bf16(x)
        x0 = None if x0 is None else _bf16(x0)
    dt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    qws, sws, pbs = _jax_quant_rdb(ws, bs, jdt)
    kw = dict(frame_h=h, frame_w=w, block_h=bh, sws=sws, interpret=True)
    xp = pad_stripe_entry(jnp.asarray(x, jdt), block_h=bh)
    if with_x0:
        x0p = pad_stripe_entry(jnp.asarray(x0, jdt), block_h=bh)
        out = rdb_res_stripe_padded(xp, x0p, qws, pbs, **kw)
    else:
        out = rdb_stripe_padded(xp, qws, pbs, **kw)
    ref = np.asarray(unpad_stripe_exit(out, h, w, NF, block_h=bh), np.float32)
    got = _port_rdb(x, ws, bs, x0, dt)
    if bf16:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("form", ["padded", "split"])
def test_rdb_i8_matches_pallas_stripe2d(rng, form):
    """2D-blocked forms (#3 and #2, the full-frame body), bf16: JAX scales
    per block window, the port per image."""
    from video_restore_tpu.models.rrdbnet import _rdb_apply
    from video_restore_tpu.ops.pallas_stripe import (
        pad_stripe2d_entry,
        rdb_stripe2d_padded,
        rdb_stripe2d_split,
        stripe2d_split_ok,
        unpad_stripe2d_exit,
    )

    h, w = (64, 96) if form == "padded" else (96, 144)
    bh, bw = 32, 48
    ws, bs = _rdb_case(rng, True)
    x = _bf16(_mk(rng, 1, h, w, NF, scale=1.5))
    qws, sws, pbs = _jax_quant_rdb(ws, bs, jnp.bfloat16)
    kw = dict(frame_h=h, frame_w=w, block_h=bh, block_w=bw, sws=sws, interpret=True)
    xp = pad_stripe2d_entry(jnp.asarray(x, jnp.bfloat16), block_h=bh, block_w=bw)
    if form == "split":
        assert stripe2d_split_ok(h, w, bh, bw)
        out = rdb_stripe2d_split(xp, qws, pbs, **kw)
    else:
        out = rdb_stripe2d_padded(xp, qws, pbs, **kw)
    jx = np.asarray(unpad_stripe2d_exit(out, h, w, NF, block_h=bh, block_w=bw), np.float32)
    naive = np.asarray(_rdb_apply(_jax_rdb(ws, bs, jnp.float32), jnp.asarray(x)))
    got = _port_rdb(x, ws, bs, None, torch.bfloat16)
    assert _psnr(jx, naive) > 50.0
    assert _psnr(got, naive) > 50.0
    _within_bf16_steps(got, jx, 4)


def _srvgg_case(rng, n, b, h, w, bf16):
    x = _mk(rng, b, h, w, NF, scale=0.8)
    ws = _mk(rng, n, 3, 3, NF, NF, scale=0.15)
    bs = _mk(rng, n, NF, scale=0.05)
    al = _mk(rng, n, NF, scale=0.2, shift=0.2)
    if bf16:
        x, ws, bs, al = (_bf16(a) for a in (x, ws, bs, al))
    return x, ws, bs, al


def _jax_quant_srvgg(ws, jdt, g):
    from video_restore_tpu.ops.pallas_srvgg import fold_dy
    from video_restore_tpu.ops.pallas_stripe import quantize_prefix_weights

    n = ws.shape[0]
    wsg = fold_dy(jnp.asarray(ws, jdt)).reshape(n // g, g, 3, 3 * NF, NF)
    (q,), (s,) = quantize_prefix_weights((wsg,))
    return q, s


def _port_srvgg(x, ws, bs, al, dt):
    qs = [quantize_conv_weights(_t(w, dt), (0, NF)) for w in ws]
    out = srvgg_body_i8_plain(
        _t(x, dt), torch.stack([q for q, _ in qs]), torch.cat([s for _, s in qs]),
        _t(bs, dt), _t(al, dt),
    )
    return out.float().numpy()


@pytest.mark.parametrize("bf16", [False, True])
def test_srvgg_body_i8_matches_pallas_one_stripe(rng, bf16):
    """srvgg_stripe_padded (#16) with sws, group 4, one stripe per image."""
    from video_restore_tpu.ops.pallas_srvgg import srvgg_stripe_padded
    from video_restore_tpu.ops.pallas_stripe import pad_stripe_entry, unpad_stripe_exit

    g, b, h, w, bh = 4, 2, 32, 48, 32
    x, ws, bs, al = _srvgg_case(rng, g, b, h, w, bf16)
    dt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    q, s = _jax_quant_srvgg(ws, jdt, g)
    xp = pad_stripe_entry(jnp.asarray(x, jdt), block_h=bh)
    o = srvgg_stripe_padded(
        xp, q[0], jnp.asarray(bs), jnp.asarray(al), frame_h=h, frame_w=w,
        group=g, block_h=bh, sws=s[0], interpret=True,
    )
    ref = np.asarray(unpad_stripe_exit(o, h, w, NF, block_h=bh), np.float32)
    got = _port_srvgg(x, ws, bs, al, dt)
    if bf16:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_srvgg_body_i8_matches_pallas_stripe2d(rng):
    """srvgg_stripe2d_padded (#15, the full-frame body) with sws, bf16,
    pack form as the JAX full-frame path: JAX scales per block window."""
    from video_restore_tpu.ops.pallas_srvgg import fold_dy, srvgg_stripe2d_padded
    from video_restore_tpu.ops.pallas_stripe import (
        pad_stripe2d_entry,
        quantize_prefix_weights,
        unpad_stripe2d_exit,
    )
    from video_restore_tpu_torch.ops.srvgg import srvgg_body_plain

    g, h, w, bh, bw = 4, 64, 96, 32, 48
    x, ws, bs, al = _srvgg_case(rng, g, 1, h, w, True)
    wsg = jnp.swapaxes(fold_dy(jnp.asarray(ws, jnp.bfloat16)), -3, -2).reshape(g, 3 * NF, 3 * NF)
    (q,), (s,) = quantize_prefix_weights((wsg,))
    xp = pad_stripe2d_entry(jnp.asarray(x, jnp.bfloat16), block_h=bh, block_w=bw)
    o = srvgg_stripe2d_padded(
        xp, q, jnp.asarray(bs), jnp.asarray(al), frame_h=h, frame_w=w, group=g,
        block_h=bh, block_w=bw, sws=s, interpret=True,
    )
    jx = np.asarray(unpad_stripe2d_exit(o, h, w, NF, block_h=bh, block_w=bw), np.float32)
    chain = srvgg_body_plain(*(_t(a) for a in (x, ws, bs, al))).numpy()
    got = _port_srvgg(x, ws, bs, al, torch.bfloat16)
    assert _psnr(jx, chain) > 45.0
    assert _psnr(got, chain) > 45.0
    # four chained convs with other scales: two draws of the same noise
    assert _psnr(got, jx) > 45.0


def _interpret(module, *names):
    """Patch Pallas entry points of ``module`` to run in interpret mode."""
    patches = []
    for name in names:
        orig = getattr(module, name)

        def interp(*a, _orig=orig, **k):
            k["interpret"] = True
            return _orig(*a, **k)

        patches.append(mock.patch.object(module, name, interp))
    return patches


def test_rrdbnet_int8_matches_jax_apply(rng):
    """RRDBNet nf 16, 2 blocks, x4, fp32, B 2 of 16x24 (bh 16: one stripe)."""
    import contextlib

    import video_restore_tpu.ops.pallas_stripe as pk
    from video_restore_tpu.models.rrdbnet import RRDBNetSpec, _apply, init_rrdbnet
    from video_restore_tpu_torch.models.rrdbnet import (
        RRDBNet,
        RRDBNetSpec as PortSpec,
        params_from_jax,
    )

    spec_kw = dict(num_feat=NF, num_block=2, num_grow_ch=GC, scale=4)
    params = jax.tree.map(np.asarray, init_rrdbnet(jax.random.PRNGKey(1), RRDBNetSpec(**spec_kw)))
    x = rng.random((2, 16, 24, 3)).astype(np.float32)
    with contextlib.ExitStack() as st:
        for p in _interpret(pk, "rdb_stripe_padded", "rdb_res_stripe_padded"):
            st.enter_context(p)
        ref = np.asarray(
            _apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), 4,
                   stripe=True, precision="int8")
        )
    net = RRDBNet(PortSpec(**spec_kw))
    net.load_state_dict(params_from_jax(params))
    net.prepare(torch.float32, "cpu", "int8")
    got = net(_t(x)).numpy()
    assert got.shape == ref.shape == (2, 64, 96, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    # the body really is int8: the float body gives another output
    net_f = RRDBNet(PortSpec(**spec_kw))
    net_f.load_state_dict(params_from_jax(params))
    assert np.abs(net_f(_t(x)).numpy() - got).max() > 1e-5


def test_srvgg_int8_matches_jax_apply(rng, monkeypatch):
    """SRVGGNetCompact nf 16, 8 convs (group 4), x4, fp32, B 2 of 16x24
    through ``apply_srvgg`` with VRT_SRVGG_STRIPE=1 (one stripe per image)."""
    import contextlib

    from video_restore_tpu.models.srvgg import SRVGGSpec, apply_srvgg, init_srvgg
    from video_restore_tpu.ops import pallas_srvgg as pk
    from video_restore_tpu_torch.models.srvgg import (
        SRVGGNet,
        SRVGGSpec as PortSpec,
        params_from_jax,
    )

    monkeypatch.setenv("VRT_SRVGG_STRIPE", "1")
    monkeypatch.setenv("VRT_SRVGG_GROUP", "4")
    spec_kw = dict(num_feat=NF, num_conv=8, scale=4)
    p = jax.tree.map(np.asarray, init_srvgg(jax.random.PRNGKey(2), SRVGGSpec(**spec_kw)))
    # an informative scale (the JAX init's 0.1 gain makes the body vanish)
    p["conv_in"]["w"] = p["conv_in"]["w"] * 10
    p["body"]["w"] = p["body"]["w"] * 10
    p["body"]["b"] = rng.normal(0, 0.02, p["body"]["b"].shape).astype(np.float32)
    x = rng.random((2, 16, 24, 3)).astype(np.float32)
    with contextlib.ExitStack() as st:
        for patch in _interpret(pk, "srvgg_stripe_padded", "srvgg_up_fused"):
            st.enter_context(patch)
        ref = np.asarray(
            apply_srvgg(jax.tree.map(jnp.asarray, p), jnp.asarray(x), SRVGGSpec(**spec_kw),
                        precision="int8")
        )
    net = SRVGGNet(PortSpec(**spec_kw))
    net.load_state_dict(params_from_jax(p))
    net.prepare(torch.float32, "cpu", "int8")
    got = net(_t(x)).numpy()
    assert got.shape == ref.shape == (2, 64, 96, 3)
    near = np.repeat(np.repeat(x, 4, 1), 4, 2)
    assert np.abs(ref - near).mean() > 0.01
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)


def test_cpu_wrappers_run_plain_and_launch_nothing(rng):
    """On CPU tensors the int8 wrappers are their plain versions, and no
    launch is counted."""
    from video_restore_tpu_torch.ops import _build

    _build.reset_launches()
    ws, bs = _rdb_case(rng, True)
    x = _t(_bf16(_mk(rng, 1, 9, 11, NF)), torch.bfloat16)
    wq, sw = _port_quant_rdb(ws, torch.bfloat16)
    b = [_t(v, torch.bfloat16) for v in bs]
    k, ka = rdb_fused_i8(x, wq, sw, b)
    p, pa = rdb_fused_i8_plain(x, wq, sw, b)
    assert torch.equal(k, p) and torch.equal(ka, pa)
    xs, ws2, bs2, al = _srvgg_case(rng, 2, 1, 9, 11, True)
    qs = [quantize_conv_weights(_t(w, torch.bfloat16), (0, NF)) for w in ws2]
    args = (
        _t(xs, torch.bfloat16), torch.stack([q for q, _ in qs]),
        torch.cat([s for _, s in qs]), _t(bs2, torch.bfloat16), _t(al, torch.bfloat16),
    )
    assert torch.equal(srvgg_body_i8(*args), srvgg_body_i8_plain(*args))
    assert _build.launches() == {}


@pytest.mark.parametrize(
    "model,min_db", [("RealESRGAN_x4plus_anime_6B", 40.0), ("RealESRGAN_x4_v3", 35.0)]
)
def test_restore_step_int8_close_to_bf16(tiny_frames, model, min_db):
    """The restore step (plain path, CPU) of a random model at full width
    on 48x64 frames: the int8 body against the bf16 body on u8, frame by
    frame, >= 40 dB for RRDBNet and >= 35 dB for SRVGGNetCompact, whose 32
    chained random convs (Kaiming body, the chip smoke's weights) carry
    more quantisation noise into an output far from its input."""
    from video_restore_tpu_torch.config import RestoreConfig
    from video_restore_tpu_torch.models.zoo import ModelHandle, random_model
    from video_restore_tpu_torch.ops.tiles import TileGrid
    from video_restore_tpu_torch.parallel.dispatch import Upscaler

    handle = random_model(model, seed=0)
    if model == "RealESRGAN_x4_v3":
        # the JAX init's 0.1 gain makes a random SRVGG its nearest-upsampled
        # input: Kaiming stem and body, conv_out gain 0.1, as chip_smoke.py
        g = np.random.default_rng(0)
        state = dict(handle.state)
        for k, gain in (("conv_in.w", 1.0), ("body.w", 1.0), ("conv_out.w", 0.1)):
            shape = state[k].shape
            std = (2.0 / (9 * shape[-2])) ** 0.5 * gain
            state[k] = torch.from_numpy(g.normal(0, std, shape).astype(np.float32))
        handle = ModelHandle(model, handle.spec, state)
    frames = tiny_frames[:2]
    grid = TileGrid.build(48, 64, tile=0, overlap=0, scale=4)
    outs = {}
    for precision in ("bf16", "int8"):
        cfg = RestoreConfig(model_name=model, precision=precision)
        ups = Upscaler(handle, grid, cfg, torch.device("cpu"))
        outs[precision] = ups.process_batch(frames).numpy()
    assert outs["int8"].shape == (2, 192, 256, 3)
    assert not np.array_equal(outs["int8"], outs["bf16"])
    for a, b in zip(outs["int8"], outs["bf16"]):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        assert 10 * np.log10(255.0**2 / mse) >= min_db


def _static_case(rng, bf16):
    """One RDB, its input at 96x144, and JAX's calibrated scales."""
    from video_restore_tpu.models.rrdbnet import calibrate_rdb_act_scales

    ws, bs = _rdb_case(rng, bf16)
    x = _mk(rng, 1, 96, 144, NF, scale=1.5)
    if bf16:
        x = _bf16(x)
    sas = calibrate_rdb_act_scales(_jax_rdb(ws, bs, jnp.float32), jnp.asarray(x))
    return ws, bs, x, sas


def test_calibrate_rdb_act_scales_matches_jax(rng):
    from video_restore_tpu.models.rrdbnet import calibrate_rdb_act_scales as jax_cal
    from video_restore_tpu_torch.models.rrdbnet import calibrate_rdb_act_scales

    ws, bs, x, ref = _static_case(rng, False)
    got = calibrate_rdb_act_scales([_t(w) for w in ws], [_t(b) for b in bs], _t(x))
    assert len(got) == 5 and all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert got[0] == float(np.float32(np.abs(x).max())) / 127.0
    # the margin scales every entry; bf16 weights and input calibrate in fp32
    wide = calibrate_rdb_act_scales([_t(w) for w in ws], [_t(b) for b in bs], _t(x), margin=1.5)
    np.testing.assert_allclose(wide, 1.5 * np.asarray(got), rtol=1e-12)
    ref_m = jax_cal(_jax_rdb(ws, bs, jnp.float32), jnp.asarray(x), margin=1.5)
    np.testing.assert_allclose(wide, ref_m, rtol=1e-6, atol=0)
    wsb, bsb = [_bf16(w) for w in ws], [_bf16(b) for b in bs]
    from_bf16 = calibrate_rdb_act_scales(
        [_t(w, torch.bfloat16) for w in wsb], [_t(b, torch.bfloat16) for b in bsb],
        _t(_bf16(x), torch.bfloat16),
    )
    ref_b = jax_cal(_jax_rdb(wsb, bsb, jnp.float32), jnp.asarray(_bf16(x)))
    np.testing.assert_allclose(from_bf16, ref_b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("scale", [0.02917, 1.0, 3.3e-3])
@pytest.mark.parametrize("bf16", [False, True])
def test_a8_static_matches_quant_act_static(rng, bf16, scale):
    """Exact, on random data that reaches past 127 scale (saturates at
    +-127) and, at scale 1.0, on the grid of ties."""
    from video_restore_tpu.ops.pallas_stripe import _quant_act_static

    a = _mk(rng, 12, 40, 24, scale=160 * scale, shift=0.4 * scale)
    if scale == 1.0:
        a = np.concatenate([a.reshape(1, -1, 8), _ties()], axis=1)
    if bf16:
        a = _bf16(a)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    qj = np.asarray(jax.jit(lambda v: _quant_act_static(v, scale))(jnp.asarray(a, jdt)))
    q = quant_act_static_plain(_t(a, torch.bfloat16 if bf16 else torch.float32), scale)
    assert q.dtype == torch.int8 and qj.dtype == np.int8
    np.testing.assert_array_equal(q.numpy(), qj)
    assert q.max().item() == 127 and q.min().item() == -127
    assert (np.abs(a) > 128 * scale).any()  # some values saturate


@pytest.mark.parametrize("bf16", [False, True])
def test_rdb_i8_static_matches_pallas_stripe2d(rng, bf16):
    """rdb_stripe2d_padded (#3) with sws and sas, 3x3 blocks of 32x48."""
    from video_restore_tpu.models.rrdbnet import _rdb_apply
    from video_restore_tpu.ops.pallas_stripe import (
        pad_stripe2d_entry,
        rdb_stripe2d_padded,
        unpad_stripe2d_exit,
    )

    h, w, bh, bw = 96, 144, 32, 48
    ws, bs, x, sas = _static_case(rng, bf16)
    dt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    qws, sws, pbs = _jax_quant_rdb(ws, bs, jdt)
    xp = pad_stripe2d_entry(jnp.asarray(x, jdt), block_h=bh, block_w=bw)
    out = rdb_stripe2d_padded(
        xp, qws, pbs, frame_h=h, frame_w=w, block_h=bh, block_w=bw, sws=sws,
        sas=sas, interpret=True,
    )
    ref = np.asarray(unpad_stripe2d_exit(out, h, w, NF, block_h=bh, block_w=bw), np.float32)
    wq, sw = _port_quant_rdb(ws, dt)
    got, amax = rdb_fused_i8_plain(_t(x, dt), wq, sw, [_t(b, dt) for b in bs], sas=sas)
    assert amax is None  # static A8 computes no amax
    got = got.float().numpy()
    if bf16:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    naive = np.asarray(_rdb_apply(_jax_rdb(ws, bs, jnp.float32), jnp.asarray(x)))
    assert _psnr(got, naive) > 45.0
    # fixed scales, not the image's: the dynamic form gives other values
    dyn, _ = rdb_fused_i8_plain(_t(x, dt), wq, sw, [_t(b, dt) for b in bs])
    assert not np.array_equal(dyn.float().numpy(), got)


def test_rdb_i8_static_wrapper_and_arguments(rng):
    """On CPU tensors the static wrapper is its plain version and counts no
    launch (so no amax kernel either); rdb3's ``x0`` form works; the static
    form refuses an amax."""
    from video_restore_tpu_torch.ops import _build
    from video_restore_tpu_torch.ops.quant import conv3x3_i8

    ws, bs = _rdb_case(rng, True)
    x = _t(_bf16(_mk(rng, 2, 9, 11, NF)), torch.bfloat16)
    x0 = _t(_bf16(_mk(rng, 2, 9, 11, NF)), torch.bfloat16)
    wq, sw = _port_quant_rdb(ws, torch.bfloat16)
    b = [_t(v, torch.bfloat16) for v in bs]
    sas = (0.011, 0.004, 0.005, 0.006, 0.007)
    _build.reset_launches()
    k, ka = rdb_fused_i8(x, wq, sw, b, x0, sas=sas)
    p, pa = rdb_fused_i8_plain(x, wq, sw, b, x0, sas=sas)
    assert ka is None and pa is None and torch.equal(k, p)
    assert _build.launches() == {}
    assert not torch.equal(k, rdb_fused_i8_plain(x, wq, sw, b, sas=sas)[0])
    with pytest.raises(ValueError):
        rdb_fused_i8(x, wq, sw, b, x_amax=torch.ones(2), sas=sas)
    with pytest.raises(ValueError):
        rdb_fused_i8(x, wq, sw, b, sas=sas[:4])
    segs = rdb_segments(NF, GC, 1)
    with pytest.raises(ValueError):
        conv3x3_i8(x, segs, torch.ones(2, 1), wq[0], sw[0], b[0], sas=sas[:1], counter="t")
    with pytest.raises(ValueError):
        conv3x3_i8(x, segs, None, wq[0], sw[0], b[0], sas=(0.0,), counter="t")


def test_bench_rdb_int8s_runs_on_cpu(capsys):
    """``python -m video_restore_tpu_torch.tools.bench_rdb int8s --cpu`` at
    a tiny shape: the static mode calibrates, runs its 23 chained RDBs per
    step through the plain version and prints one line."""
    from video_restore_tpu_torch.tools import bench_rdb

    assert bench_rdb.MODES == ("k1", "fused", "rrdb", "int8", "int8s")
    assert bench_rdb.main(["int8s", "--cpu", "--shape", "1,6,10"]) == 0
    out = capsys.readouterr().out
    assert " int8s:" in out and "cpu, plain versions" in out
    (rec,) = bench_rdb.bench(["int8s"], (1, 6, 10), "cpu", iters=1)
    assert rec["mode"] == "int8s" and rec["rdbs_timed"] == bench_rdb.REPS
    assert "err" not in rec  # the kernel-vs-plain check belongs to the card
