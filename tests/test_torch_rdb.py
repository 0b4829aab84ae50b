"""The port's one-launch RDB and RRDB (``ops/rdb.py``, kernel K5) against the
four fused-RDB Pallas kernels of the JAX package, in interpret mode on the
CPU, where each port wrapper runs its plain version. Weights come from the
JAX ``init_rrdbnet`` (nf 16, gc 8; biases made non-zero from a numpy seed)
through ``params_from_jax``; inputs from numpy seeds.

- one RDB against ``rdb_stripe`` (``pallas_stripe.py:2079``): fp32 within
  1e-5 (rtol and atol; exact SAME on both sides, only the fp32 sum order
  differs), including odd extents; bf16 within 2 bf16 steps of the output's
  largest value (both round each c_k to bf16 after fp32 sums taken in
  another order, so a sum at a rounding boundary moves one step and the
  next convs carry it);
- one RDB against ``rdb_fused`` (``pallas_rdb.py:313``), with the body
  weights scaled x5 so the border shows: within 1e-5 at 5 or more pixels
  from the frame edge, off by more than 1e-2 on the outer ring (the square
  block kernel leaves c1..c4 unmasked outside the frame); the port equals
  ``_rdb_apply`` (SAME) everywhere within 1e-5;
- the whole RRDB against ``rrdb_stripe_padded`` (``pallas_stripe.py:1016``,
  through ``pad_stripe_entry``/``unpad_stripe_exit``) within 1e-5, and
  against ``rrdb_fused`` (``pallas_rdb.py:257``, weights x5) within 1e-5 at
  15 or more pixels from the edge, and off near it;
- the ``"pallas"`` body mode of the model (nf 16, gc 8, 2 blocks) against
  JAX ``apply_rrdbnet(use_pallas=True)`` with ``rrdb_fused`` in interpret
  mode at ``tests/test_pallas_rdb.py``'s tolerance (rtol 5e-2, atol 5e-3:
  the JAX border), and against ``use_pallas=False`` within 1e-4 (fp32 sums
  in another order through ~40 chained convs);
- ``"pallas"`` with int8 runs the bf16 body (bit-equal), ``VRT_PALLAS``
  selects the mode on a CUDA device only, the CPU wrappers launch nothing,
  and ``tools/bench_rdb.py --cpu`` runs all five modes at a tiny shape.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.models.rrdbnet import (
    RRDBNet,
    RRDBNetSpec as PortSpec,
    body_mode,
    params_from_jax,
)
from video_restore_tpu_torch.ops.rdb import (
    rdb_fused,
    rdb_fused_plain,
    rrdb_fused,
    rrdb_fused_plain,
)

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

NF, GC = 16, 8


def _params(seed, num_block=1, body_gain=1.0):
    """JAX RRDBNet params (numpy leaves) with non-zero biases; the body's
    conv weights scaled by ``body_gain``."""
    from video_restore_tpu.models.rrdbnet import RRDBNetSpec, init_rrdbnet

    spec = RRDBNetSpec(num_feat=NF, num_block=num_block, num_grow_ch=GC, scale=4)
    params = jax.tree.map(np.asarray, init_rrdbnet(jax.random.PRNGKey(seed), spec))
    rng = np.random.default_rng(seed)

    def fix(path, a):
        keys = [k.key for k in path]
        if keys[-1] == "b":
            return a + rng.normal(0, 0.02, a.shape).astype(np.float32)
        return a * body_gain if keys[0] == "body" else a

    return spec, jax.tree_util.tree_map_with_path(fix, params)


def _block(seed, body_gain=1.0, dt=torch.float32):
    """(JAX block 0 as {rdb1..3: {conv1..5: {w, b}}}, the port's three
    ``(ws, bs)``), the port's carried over by ``params_from_jax``."""
    _, params = _params(seed, body_gain=body_gain)
    sd = params_from_jax(params)
    block = jax.tree.map(lambda a: a[0], params["body"])
    port = [
        (
            [sd[f"body.0.{r}.conv{k}.w"].to(dt) for k in range(1, 6)],
            [sd[f"body.0.{r}.conv{k}.b"].to(dt) for k in range(1, 6)],
        )
        for r in ("rdb1", "rdb2", "rdb3")
    ]
    return block, port


def _prefix(rdb_params):
    from video_restore_tpu.ops.pallas_stripe import prefix_rdb_weights

    return prefix_rdb_weights(rdb_params, NF, GC)


def _ring(h, w, d):
    """Boolean (h, w) mask of the pixels closer than ``d`` to the edge."""
    yy, xx = np.mgrid[0:h, 0:w]
    return (yy < d) | (xx < d) | (yy >= h - d) | (xx >= w - d)


@pytest.mark.parametrize(
    "shape", [(1, 32, 32), (2, 64, 48), (1, 40, 56), (1, 33, 31)]
)
def test_rdb_matches_rdb_stripe(rng, shape):
    from video_restore_tpu.ops.pallas_stripe import rdb_stripe

    block, port = _block(0)
    ws, bs = _prefix(block["rdb1"])
    x = rng.random(shape + (NF,)).astype(np.float32)
    ref = np.asarray(rdb_stripe(jnp.asarray(x), ws, bs, interpret=True))
    got = rdb_fused(torch.from_numpy(x), *port[0]).numpy()
    assert got.shape == ref.shape == shape + (NF,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_rdb_matches_rdb_stripe_bf16(rng):
    from video_restore_tpu.ops.pallas_stripe import rdb_stripe

    block, port = _block(1, dt=torch.bfloat16)
    # the same bf16 values on both sides (JAX keeps the biases in fp32)
    block = jax.tree.map(
        lambda a: torch.from_numpy(a).bfloat16().float().numpy(), block
    )
    ws, bs = _prefix(block["rdb1"])
    x = torch.from_numpy(rng.random((2, 24, 40, NF)).astype(np.float32)).bfloat16()
    ref = np.asarray(
        rdb_stripe(jnp.asarray(x.float().numpy(), jnp.bfloat16), ws, bs, interpret=True)
    ).astype(np.float32)
    got = rdb_fused(x, *port[0])
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    step = np.exp2(np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.abs(got - ref).max() <= 2 * step


def test_rdb_border_against_square_block_kernel(rng):
    from video_restore_tpu.models.rrdbnet import _rdb_apply, _regroup_rdb_weights
    from video_restore_tpu.ops.pallas_rdb import rdb_fused as rdb_square

    block, port = _block(2, body_gain=5.0)
    ws, bs = _regroup_rdb_weights(block["rdb1"], NF, GC)
    x = rng.random((1, 48, 48, NF)).astype(np.float32)
    sq = np.asarray(rdb_square(jnp.asarray(x), tuple(ws), tuple(bs), interpret=True))[0]
    same = np.asarray(_rdb_apply(block["rdb1"], jnp.asarray(x)))
    got = rdb_fused(torch.from_numpy(x), *port[0]).numpy()
    np.testing.assert_allclose(got, same, rtol=1e-5, atol=1e-5)
    got = got[0]
    inner = ~_ring(48, 48, 5)
    np.testing.assert_allclose(got[inner], sq[inner], rtol=1e-5, atol=1e-5)
    assert np.abs(got - sq)[_ring(48, 48, 1)].max() > 1e-2


def test_rrdb_matches_rrdb_stripe_padded(rng):
    from video_restore_tpu.ops.pallas_stripe import (
        pad_stripe_entry,
        rrdb_stripe_padded,
        unpad_stripe_exit,
    )

    block, port = _block(3)
    ws, bs = [], []
    for r in ("rdb1", "rdb2", "rdb3"):
        w5, b5 = _prefix(block[r])
        ws += list(w5)
        bs += list(b5)
    b, h, w, bh = 2, 56, 40, 32  # h not a multiple of bh
    x = rng.random((b, h, w, NF)).astype(np.float32)
    xp = pad_stripe_entry(jnp.asarray(x), block_h=bh)
    o = rrdb_stripe_padded(xp, ws, bs, frame_h=h, frame_w=w, block_h=bh, interpret=True)
    ref = np.asarray(unpad_stripe_exit(o, h, w, NF, block_h=bh))
    got = rrdb_fused(torch.from_numpy(x), port).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_rrdb_border_against_square_block_kernel(rng):
    from video_restore_tpu.models.rrdbnet import _regroup_rdb_weights
    from video_restore_tpu.ops.pallas_rdb import rrdb_fused as rrdb_square

    block, port = _block(4, body_gain=5.0)
    tp = {}
    for r in ("rdb1", "rdb2", "rdb3"):
        ws, bs = _regroup_rdb_weights(block[r], NF, GC)
        tp[r] = {"w": tuple(ws), "b": tuple(bs)}
    x = rng.random((1, 48, 48, NF)).astype(np.float32)
    sq = np.asarray(rrdb_square(jnp.asarray(x), tp, interpret=True))[0]
    got = rrdb_fused(torch.from_numpy(x), port).numpy()[0]
    inner = ~_ring(48, 48, 15)
    np.testing.assert_allclose(got[inner], sq[inner], rtol=1e-5, atol=1e-5)
    assert np.abs(got - sq)[_ring(48, 48, 1)].max() > 1e-3


def _pallas_model(params, spec, precision="bf16", dt=torch.float32):
    net = RRDBNet(PortSpec(num_feat=NF, num_block=spec.num_block, num_grow_ch=GC, scale=4))
    net.load_state_dict(params_from_jax(params))
    return net.prepare(dt, "cpu", precision, mode="pallas")


def test_pallas_mode_model_matches_jax(rng):
    import video_restore_tpu.ops.pallas_rdb as pk
    from video_restore_tpu.models.rrdbnet import apply_rrdbnet

    spec, params = _params(1, num_block=2)
    x = rng.random((1, 16, 16, 3)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    orig = pk.rrdb_fused

    def interp(xx, tp, interpret=False):
        return orig(xx, tp, interpret=True)

    with mock.patch.object(pk, "rrdb_fused", interp):
        ref_pallas = np.asarray(apply_rrdbnet(jp, jnp.asarray(x), spec, use_pallas=True))
    ref_xla = np.asarray(apply_rrdbnet(jp, jnp.asarray(x), spec, use_pallas=False))
    net = _pallas_model(params, spec)
    assert net.mode == "pallas"
    got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref_xla.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, ref_pallas, rtol=5e-2, atol=5e-3)
    np.testing.assert_allclose(got, ref_xla, rtol=1e-4, atol=1e-4)
    # the plain forward is the same computation on the CPU
    np.testing.assert_array_equal(net(torch.from_numpy(x), plain=True).numpy(), got)


def test_pallas_mode_ignores_int8(rng):
    spec, params = _params(2, num_block=2)
    x = torch.from_numpy(rng.random((1, 12, 14, 3)).astype(np.float32))
    a = _pallas_model(params, spec, "int8", torch.bfloat16)
    b = _pallas_model(params, spec, "bf16", torch.bfloat16)
    assert a.precision == "bf16" and not hasattr(a.body[0].rdb1, "wq1")
    assert torch.equal(a(x), b(x))
    # the stripe body does take int8, and then differs
    c = RRDBNet(PortSpec(num_feat=NF, num_block=2, num_grow_ch=GC, scale=4))
    c.load_state_dict(params_from_jax(params))
    c.prepare(torch.bfloat16, "cpu", "int8")
    assert c.precision == "int8" and not torch.equal(c(x), a(x))


def test_vrt_pallas_selects_the_mode_on_cuda_only(monkeypatch):
    from video_restore_tpu_torch.models.zoo import random_model

    monkeypatch.delenv("VRT_PALLAS", raising=False)
    assert body_mode("cuda") == body_mode("cpu") == "stripe"
    monkeypatch.setenv("VRT_PALLAS", "1")
    assert body_mode("cuda") == "pallas"
    assert body_mode(torch.device("cuda", 0)) == "pallas"
    assert body_mode("cpu") == "stripe"
    net = random_model("RealESRGAN_x4plus_anime_6B").module(torch.float32, "cpu")
    assert net.mode == "stripe"
    with pytest.raises(ValueError, match="unknown RRDBNet body mode"):
        net.prepare(torch.float32, "cpu", mode="accum")


def test_cpu_wrappers_run_plain_and_launch_nothing(rng):
    from video_restore_tpu_torch.ops import _build

    _, port = _block(5)
    x = torch.from_numpy(rng.random((2, 9, 11, NF)).astype(np.float32))
    x0 = torch.from_numpy(rng.random((2, 9, 11, NF)).astype(np.float32))
    _build.reset_launches()
    assert torch.equal(rdb_fused(x, *port[0], x0), rdb_fused_plain(x, *port[0], x0))
    assert torch.equal(rrdb_fused(x, port), rrdb_fused_plain(x, port))
    # the RRDB's plain version is the default body's three RDBs
    out = rdb_fused_plain(x, *port[0])
    out = rdb_fused_plain(out, *port[1])
    assert torch.equal(rrdb_fused_plain(x, port), rdb_fused_plain(out, *port[2], x0=x))
    assert _build.launches() == {}
    assert _build._lib is None


def test_bench_rdb_cpu_tiny(capsys):
    from video_restore_tpu_torch.tools import bench_rdb

    assert bench_rdb.main(["--cpu", "--shape", "1,6,10"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == ["k1", "fused", "rrdb", "int8", "int8s"]
    assert all("ms/RDB-call" in ln and "1x6x10x64 bf16; cpu" in ln for ln in lines)
    records = bench_rdb.bench(["rrdb"], (1, 6, 10), "cpu", iters=1)
    assert records[0]["ms_per_rdb"] > 0 and records[0]["rdbs_timed"] == 24
    with pytest.raises(SystemExit):
        bench_rdb.main(["nope", "--cpu"])
