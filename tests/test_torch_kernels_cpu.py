"""The port's kernel wrappers, run on the CPU (their plain versions), against
the JAX Pallas entry points they replace, run in interpret mode.

Same numpy inputs and weights on both sides, all fp32, so the only
difference is the summation order of fp32 sums (~1e-6 relative); the
tolerances (rtol = atol = 1e-4) leave room for that over chains of up to
five convs and nothing more.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from video_restore_tpu_torch.ops import _build
from video_restore_tpu_torch.ops.post import unsharp_mask as port_unsharp_mask
from video_restore_tpu_torch.ops.stripe import rdb_fused
from video_restore_tpu_torch.ops.tail import conv3x3_fused, tail_fused, up1_fused
from video_restore_tpu_torch.ops.unsharp import unsharp_fused

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _mk(rng, *shape, scale=1.0, shift=0.0):
    return ((rng.random(shape) - 0.5) * 2 * scale + shift).astype(np.float32)


@pytest.mark.parametrize(
    "cin,cout,act,use_res,h",
    [
        (3, 16, "none", False, 20),  # stem form
        (16, 16, "none", True, 18),  # conv_body + residual, H not a multiple of the stripe
        (16, 16, "lrelu", False, 21),
        (3, 16, "prelu", False, 19),
    ],
)
def test_conv3x3_fused_matches_pallas(rng, cin, cout, act, use_res, h):
    from video_restore_tpu.ops.pallas_tail import conv3x3_fused as jax_conv

    x = _mk(rng, 2, h, 23, cin)
    w = _mk(rng, 3, 3, cin, cout, scale=0.1)
    b = _mk(rng, cout, scale=0.05)
    alpha = _mk(rng, cout, scale=0.25, shift=0.25) if act == "prelu" else None
    res = _mk(rng, 2, h, 23, cout) if use_res else None
    ref = jax_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if res is None else jnp.asarray(res),
        None if alpha is None else jnp.asarray(alpha),
        act=act, block_h=4, interpret=True,
    )
    got = conv3x3_fused(
        _t(x), _t(w), _t(b),
        None if res is None else _t(res),
        None if alpha is None else _t(alpha),
        act=act,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("h1,w1", [(20, 24), (18, 21)])
def test_up1_fused_matches_pallas(rng, h1, w1):
    from video_restore_tpu.ops.pallas_tail import up1_fused as jax_up1

    nf = 16
    x = _mk(rng, 2, h1, w1, nf)
    w = _mk(rng, 3, 3, nf, nf, scale=0.1)
    b = _mk(rng, nf, scale=0.05)
    ref = jax_up1(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), block_h=4,
        interpret=True,
    )
    got = up1_fused(_t(x), _t(w), _t(b))
    assert got.shape == (2, 2 * h1, 2 * w1, nf)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_tail_matches_pallas_raw_chain(rng):
    """up1_fused + tail_fused == the production Pallas chain
    up1_fused(masked=True) -> tail_fused_raw, and == tail_fused on a plain
    2x-grid input; W not a multiple of 8."""
    from video_restore_tpu.ops.pallas_tail import tail_fused as jax_tail
    from video_restore_tpu.ops.pallas_tail import tail_fused_raw
    from video_restore_tpu.ops.pallas_tail import up1_fused as jax_up1

    nf, h1, w1 = 16, 12, 11
    x1 = _mk(rng, 1, h1, w1, nf, scale=0.5)
    wu1, bu1 = _mk(rng, 3, 3, nf, nf, scale=0.2), _mk(rng, nf, scale=0.05)
    tw = [
        _mk(rng, 3, 3, nf, nf, scale=0.2), _mk(rng, nf, scale=0.05),
        _mk(rng, 3, 3, nf, nf, scale=0.2), _mk(rng, nf, scale=0.05),
        _mk(rng, 3, 3, nf, 3, scale=0.2), _mk(rng, 3, scale=0.05),
    ]
    jw = [jnp.asarray(a) for a in tw]
    xq = jax_up1(
        jnp.asarray(x1), jnp.asarray(wu1), jnp.asarray(bu1), masked=True,
        interpret=True,
    )
    ref = tail_fused_raw(xq, *jw, h2=2 * h1, w2=2 * w1, interpret=True)
    f = up1_fused(_t(x1), _t(wu1), _t(bu1))
    got = tail_fused(f, *[_t(a) for a in tw])
    assert got.shape == (1, 4 * h1, 4 * w1, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

    ref_plain = jax_tail(jnp.asarray(f.numpy()), *jw, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_plain), **TOL)


@pytest.mark.parametrize("with_x0", [False, True])
def test_rdb_fused_matches_pallas_split(rng, with_x0):
    """rdb_fused (plain RDB, and rdb3 with the RRDB residual) ==
    rdb_stripe2d_split at the geometry the JAX split test uses (nf 16,
    gc 8, 64x72 frame, 16x24 blocks: a true interior exists)."""
    from video_restore_tpu.ops.pallas_stripe import (
        pad_stripe2d_entry,
        prefix_rdb_weights,
        rdb_stripe2d_split,
        stripe2d_split_ok,
        unpad_stripe2d_exit,
    )

    nf, gc, b, h, w, bh, bw = 16, 8, 2, 64, 72, 16, 24
    assert stripe2d_split_ok(h, w, bh, bw)
    ws = [
        _mk(rng, 3, 3, nf + k * gc, gc if k < 4 else nf, scale=0.05)
        for k in range(5)
    ]
    bs = [_mk(rng, gc if k < 4 else nf, scale=0.05) for k in range(5)]
    rdb = {
        f"conv{k + 1}": {"w": jnp.asarray(ws[k]), "b": jnp.asarray(bs[k])}
        for k in range(5)
    }
    pws, pbs = prefix_rdb_weights(rdb, nf, gc)
    x = _mk(rng, b, h, w, nf)
    x0 = _mk(rng, b, h, w, nf) if with_x0 else None
    kw = dict(frame_h=h, frame_w=w, block_h=bh, block_w=bw, interpret=True)
    xp = pad_stripe2d_entry(jnp.asarray(x), block_h=bh, block_w=bw)
    if with_x0:
        x0p = pad_stripe2d_entry(jnp.asarray(x0), block_h=bh, block_w=bw)
        out = rdb_stripe2d_split(xp, pws, pbs, x0=x0p, res=True, **kw)
    else:
        out = rdb_stripe2d_split(xp, pws, pbs, **kw)
    ref = unpad_stripe2d_exit(out, h, w, nf, block_h=bh, block_w=bw)
    got = rdb_fused(
        _t(x), [_t(a) for a in ws], [_t(a) for a in bs],
        None if x0 is None else _t(x0),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_unsharp_fused_matches_pallas(rng):
    """H a multiple of 8 (the Pallas kernel's own path), with and without
    the threshold branch. Both sides sum the same fp32 products in the
    same order, so the tolerance is float rounding only (1e-6)."""
    from video_restore_tpu.ops.pallas_post import unsharp_fused as jax_unsharp

    for h, w, thr in ((40, 18, 0.0), (48, 13, 0.02)):
        x = rng.random((2, h, w, 3)).astype(np.float32)
        ref = jax_unsharp(
            jnp.asarray(x), amount=0.3, sigma=1.5, radius=4, threshold=thr,
            block_h=16, interpret=True,
        )
        got = unsharp_fused(_t(x), 0.3, 1.5, 4, thr)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6
        )


def test_unsharp_fused_any_height_matches_xla(rng):
    """Heights the Pallas kernel hands back to XLA (h % 8 != 0, tiny h):
    the port's kernel takes every height, so its plain version is checked
    against post.unsharp_mask directly."""
    from video_restore_tpu.ops.post import unsharp_mask as jax_unsharp_mask

    for h, w in ((37, 53), (5, 9), (1, 4)):
        x = rng.random((1, h, w, 3)).astype(np.float32)
        ref = jax_unsharp_mask.__wrapped__(
            jnp.asarray(x), amount=0.3, sigma=1.5, radius=4, threshold=0.0
        )
        got = unsharp_fused(_t(x), 0.3, 1.5, 4)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6
        )
        np.testing.assert_array_equal(
            got.numpy(), port_unsharp_mask(_t(x), 0.3, 1.5, 4).numpy()
        )


def test_cpu_wrappers_launch_nothing(rng):
    """On CPU tensors the wrappers run their plain versions: no kernel
    launch is counted."""
    _build.reset_launches()
    x = _t(_mk(rng, 1, 6, 7, 8))
    w = _t(_mk(rng, 3, 3, 8, 8, scale=0.1))
    b = _t(_mk(rng, 8, scale=0.1))
    conv3x3_fused(x, w, b)
    up1_fused(x, w, b)
    assert _build.launches() == {}


@pytest.mark.parametrize("dt", [np.float32, "bfloat16"])
def test_plain_conv_primitives_match_jax(rng, dt):
    """ops/conv.py: conv2d (fp32 sums, fp32 bias, result in x's dtype),
    leaky_relu, prelu, pixel_unshuffle, upsample_nearest. fp32: 1e-5; bf16:
    one bf16 step of the result (the two sides round the same fp32 sums)."""
    from video_restore_tpu.ops import conv as jc

    from video_restore_tpu_torch.ops import conv as pc

    x = _mk(rng, 2, 6, 8, 5)
    w = _mk(rng, 3, 3, 5, 7, scale=0.3)
    b = _mk(rng, 7, scale=0.1)
    a = _mk(rng, 7, scale=0.25, shift=0.25)
    if dt == "bfloat16":
        jx, tx = jnp.asarray(x, jnp.bfloat16), _t(x).bfloat16()
        jw, tw = jnp.asarray(w, jnp.bfloat16), _t(w).bfloat16()
        tol = dict(rtol=1e-2, atol=1e-2)
    else:
        jx, tx, jw, tw = jnp.asarray(x), _t(x), jnp.asarray(w), _t(w)
        tol = dict(rtol=1e-5, atol=1e-5)

    def same(got, ref):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(ref, np.float32), **tol
        )

    y = pc.conv2d(tx, tw, _t(b))
    assert y.dtype == tx.dtype
    same(y, jc.conv2d(jx, jw, jnp.asarray(b)))
    same(pc.leaky_relu(tx), jc.leaky_relu(jx))
    same(pc.prelu(tx[..., :5], _t(a[:5])), jc.prelu(jx[..., :5], jnp.asarray(a[:5])))
    same(pc.pixel_unshuffle(tx, 2), jc.pixel_unshuffle(jx, 2))
    same(pc.upsample_nearest(tx, 2), jc.upsample_nearest(jx, 2))
