"""K5's fp32 route (``"bf16x3"``, ``csrc/rdb_fused_bf16x3.cu``), on a machine without a card.

The kernel runs one RDB (or a whole RRDB) as the phases of one persistent
cooperative launch, each phase K1 ``"bf16x3"``'s conv: the six products of
each value's three bf16 parts, per 16 input channels, the nine taps in
order, summed in fp32. What is held here:

- ``rdb_x3_plan``: the tiles of each width, the grid, the two maps' dims,
  byte strides and boxes, the shared memory of the larger ring, the phases
  in launch order and the work they execute, its refusals, and the Python
  plan against the shipped build's constants (read from the source);
- a CPU emulation of the kernel's schedule (its buffers: the RDB's input,
  c_1 .. c_4 in one 128-channel buffer, y and scratch; each conv as the
  kernel sums it: every k16 group of a part's product summed in float64 in
  channel order and rounded once, added to one fp32 accumulator in the
  kernel's order) is bit-equal to the same emulated conv run as K1's
  five-launch chain (``ops/stripe.py``'s growth buffer), for one RDB with
  and without x0 and for a whole RRDB;
- the emulation agrees with the JAX package, in interpret mode, within
  1e-4 of the largest output value (fp32 sums in another order, 15 chained
  convs): ``rrdb_stripe_padded`` (``pallas_stripe.py:1016``, exact SAME)
  everywhere, ``rrdb_fused`` (``pallas_rdb.py:257``) away from the
  14-pixel band where its square blocks read unmasked intermediates (as
  ``tests/test_torch_rdb.py`` compares it).

The kernel itself runs on the card only (``chip_smoke.py --only k5``;
``python -m video_restore_tpu_torch.tools.probe_k5k3 --dtype fp32``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.ops import _build, rdb, stripe, tail

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

F32 = torch.float32
NF, GC = 64, 32
SRC = (_build.CSRC / "rdb_fused_bf16x3.cu").read_text()
K1_SRC = (_build.CSRC / "conv3x3_bf16x3_wgmma.cu").read_text()
TOL = 1e-4  # of the largest output value: fp32 sums in another order
SIX = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))  # a_i * w_j, smallest first


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _define(src, name):
    return int(re.search(rf"#define {name} (\d+)", src).group(1))


# ---- the emulation --------------------------------------------------------------


def x3_conv(x, w, b, *, act="none", upsample2=False, out=None, r1=None, s1=1.0, r2=None,
            s2=1.0):
    """K1 ``"bf16x3"``'s conv as the kernel schedules it: per 16 input
    channels, the nine taps in order, the six part products smallest first,
    each a k16 group (16 exact products summed in float64 in channel order,
    rounded once to fp32) added to one fp32 accumulator; then conv3x3.cu's
    epilogue in fp32. ``out``: written in place (a channel slice)."""
    xi = tail.upsample_nearest(x, 2) if upsample2 else x
    bsz, h, wd, cin = xi.shape
    xp = torch.nn.functional.pad(xi.float(), (0, 0, 1, 1, 1, 1))  # SAME: zeros
    ap, wp = tail.split3(xp).double(), tail.split3(w).double()
    acc = torch.zeros(bsz, h, wd, w.shape[-1], dtype=F32)
    for c0 in range(0, cin, 16):
        for ky in range(3):
            for kx in range(3):
                for i, j in SIX:
                    a = ap[i][:, ky:ky + h, kx:kx + wd, c0:c0 + 16]
                    wt = wp[j][ky, kx, c0:c0 + 16]
                    s = a[..., 0:1] * wt[0]
                    for c in range(1, 16):
                        s = s + a[..., c:c + 1] * wt[c]
                    acc = acc + s.float()
    y = acc + b
    if act == "lrelu":
        y = torch.where(y >= 0, y, 0.2 * y)
    if r1 is not None:
        y = r1 + s1 * y
    if r2 is not None:
        y = r2 + s2 * y
    if out is None:
        return y
    out.copy_(y)
    return out


def k5_emulated(x, rdb_weights, x0=None):
    """The kernel's phases on its buffers: conv k of RDB r reads the RDB's
    input (64 channels) and c_1 .. c_{k-1} (the first 32 (k - 1) channels
    of one 128-channel buffer), writes c_k there (k < 5) or the RDB's
    output: its input + 0.2 conv, then x0 + 0.2 that (RRDB: RDB1 x -> y,
    RDB2 y -> scratch, RDB3 scratch -> y with x0 = x)."""
    c = torch.zeros(*x.shape[:3], 4 * GC, dtype=F32)
    bufs = {"x": x}
    rdbs = len(rdb_weights)
    for r, (ws, bs) in enumerate(rdb_weights):
        src = "x" if rdbs == 1 else ("x", "y", "scratch")[r]
        dst = "scratch" if rdbs == 3 and r == 1 else "y"
        inp = bufs[src]
        for k in range(4):
            x3_conv(torch.cat([inp, c[..., : k * GC]], -1), ws[k], bs[k], act="lrelu",
                    out=c[..., k * GC: (k + 1) * GC])
        r2 = x0 if rdbs == 1 else (x if r == 2 else None)
        bufs[dst] = x3_conv(torch.cat([inp, c], -1), ws[4], bs[4], r1=inp, s1=0.2, r2=r2, s2=0.2)
    return bufs["y"]


def k1_chain(x, rdb_weights, x0=None):
    """The same conv as K1's five-launch RDB runs it (one growth buffer per
    RDB, conv k reading its prefix), three of them and the residual."""
    if len(rdb_weights) == 1:
        return stripe._rdb(x3_conv, x, *rdb_weights[0], x0)
    o = stripe._rdb(x3_conv, x, *rdb_weights[0], None)
    o = stripe._rdb(x3_conv, o, *rdb_weights[1], None)
    return stripe._rdb(x3_conv, o, *rdb_weights[2], x)


def _weights(rng, n=3):
    return [([torch.from_numpy(rng.normal(0, 0.03, (3, 3, NF + k * GC, GC if k < 4 else NF))
                               .astype(np.float32)) for k in range(5)],
             [torch.from_numpy(rng.normal(0, 0.05, GC if k < 4 else NF).astype(np.float32))
              for k in range(5)]) for _ in range(n)]


def _x(rng, shape):
    return torch.from_numpy(rng.uniform(-1, 1, (*shape, NF)).astype(np.float32))


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), err
    return err


@pytest.mark.parametrize("shape,x0", [((1, 5, 7), False), ((2, 4, 6), True)])
def test_the_one_launch_rdb_is_bit_equal_to_the_k1_chain(shape, x0):
    rng = np.random.default_rng(11)
    w = _weights(rng, 1)
    x = _x(rng, shape)
    z = _x(rng, shape) if x0 else None
    got = k5_emulated(x, w, z)
    assert torch.equal(got, k1_chain(x, w, z))
    _close(got, rdb.rdb_fused_plain(x, *w[0], z))


def test_the_one_launch_rrdb_is_bit_equal_to_the_k1_chain():
    rng = np.random.default_rng(12)
    w = _weights(rng)
    x = _x(rng, (1, 6, 5))
    got = k5_emulated(x, w)
    assert torch.equal(got, k1_chain(x, w))
    _close(got, rdb.rrdb_fused_plain(x, w))


def _jax_block(seed):
    """A JAX RRDBNet block at nf 64 / gc 32 (non-zero biases) and the port's
    three (ws, bs), carried over by ``params_from_jax``."""
    from video_restore_tpu.models.rrdbnet import RRDBNetSpec, init_rrdbnet

    from video_restore_tpu_torch.models.rrdbnet import params_from_jax

    spec = RRDBNetSpec(num_feat=NF, num_block=1, num_grow_ch=GC, scale=4)
    params = jax.tree.map(np.asarray, init_rrdbnet(jax.random.PRNGKey(seed), spec))
    rng = np.random.default_rng(seed)

    def fix(path, a):
        keys = [k.key for k in path]
        if keys[-1] == "b":
            return a + rng.normal(0, 0.02, a.shape).astype(np.float32)
        return a * 5.0 if keys[0] == "body" else a

    params = jax.tree_util.tree_map_with_path(fix, params)
    sd = params_from_jax(params)
    block = jax.tree.map(lambda a: a[0], params["body"])
    port = [([sd[f"body.0.{r}.conv{k}.w"] for k in range(1, 6)],
             [sd[f"body.0.{r}.conv{k}.b"] for k in range(1, 6)])
            for r in ("rdb1", "rdb2", "rdb3")]
    return block, port


def test_the_emulation_agrees_with_rrdb_stripe_padded():
    from video_restore_tpu.ops.pallas_stripe import (
        pad_stripe_entry,
        prefix_rdb_weights,
        rrdb_stripe_padded,
        unpad_stripe_exit,
    )

    block, port = _jax_block(3)
    ws, bs = [], []
    for r in ("rdb1", "rdb2", "rdb3"):
        w5, b5 = prefix_rdb_weights(block[r], NF, GC)
        ws += list(w5)
        bs += list(b5)
    b, h, w, bh = 1, 40, 12, 32  # h not a multiple of bh
    x = np.random.default_rng(4).random((b, h, w, NF)).astype(np.float32)
    xp = pad_stripe_entry(jnp.asarray(x), block_h=bh)
    o = rrdb_stripe_padded(xp, ws, bs, frame_h=h, frame_w=w, block_h=bh, interpret=True)
    ref = np.asarray(unpad_stripe_exit(o, h, w, NF, block_h=bh))
    _close(k5_emulated(torch.from_numpy(x), port), ref)


def test_the_emulation_agrees_with_rrdb_fused_away_from_its_edge_band():
    from video_restore_tpu.models.rrdbnet import _regroup_rdb_weights
    from video_restore_tpu.ops.pallas_rdb import rrdb_fused as rrdb_square

    block, port = _jax_block(4)
    tp = {}
    for r in ("rdb1", "rdb2", "rdb3"):
        ws, bs = _regroup_rdb_weights(block[r], NF, GC)
        tp[r] = {"w": tuple(ws), "b": tuple(bs)}
    n = 32
    x = np.random.default_rng(5).random((1, n, n, NF)).astype(np.float32)
    sq = np.asarray(rrdb_square(jnp.asarray(x), tp, interpret=True))[0]
    got = k5_emulated(torch.from_numpy(x), port).numpy()[0]
    yy, xx = np.mgrid[0:n, 0:n]
    inner = (yy >= 15) & (xx >= 15) & (yy < n - 15) & (xx < n - 15)
    _close(got[inner], sq[inner])


# ---- the plan ----------------------------------------------------------------------


def test_the_python_plan_matches_the_shipped_build():
    """The tile rows, stage width and tile pixels of K1's source (whose
    roles the kernel runs), the shared memory of the larger ring, the
    threads, the plan's length and the producer's registers."""
    g = rdb.K5_X3
    nc = _const(K1_SRC, "NC")
    assert g["th32"] == nc * _define(K1_SRC, "VR_X3_ROWS32")
    assert g["th64"] == nc * _define(K1_SRC, "VR_X3_ROWS64")
    assert g["tw"] == _const(K1_SRC, "TW") and g["kc"] == _const(K1_SRC, "KC")
    assert g["threads"] == nc * 128 + 128
    assert g["plan_len"] == _const(SRC, "K5_PLAN_LEN") == 31
    assert len(rdb.rdb_x3_plan(1, 8, 8).array()) == 31
    assert _const(SRC, "K5_PRODUCER_REGS") * 128 + nc * 128 * 216 <= 65536


def test_shared_memory_is_the_larger_ring():
    """The cout-32 layout (8-row tiles, a 42 KB raw window) sets it: the
    cout-64 one fits inside, the barriers follow both."""
    assert rdb.K5_X3["smem"] == 227624 == tail.bf16x3_smem(32, 8)
    assert tail.bf16x3_smem(64, 4) < tail.bf16x3_smem(32, 8) <= tail.SMEM_MAX


def test_the_1080p_plan():
    p = rdb.rdb_x3_plan(1, 1080, 1920, sms=132)
    assert (p.tiles_x, p.tiles_y32, p.tiles_y64, p.grid) == (30, 135, 270, 132)
    assert p.in_dims == (64, 1920, 1080, 1) and p.c_dims == (128, 1920, 1080, 1)
    assert p.in_strides == (256, 1920 * 256, 1080 * 1920 * 256)
    assert p.c_strides == (512, 1920 * 512, 1080 * 1920 * 512)
    assert p.box32 == (16, 66, 10, 1) and p.box64 == (16, 66, 6, 1)
    vals = list(p.array())
    assert vals[:9] == [8, 4, 64, 16, 227624, 132, 30, 135, 270]
    assert vals[9:] == [*p.in_dims, *p.in_strides, *p.c_dims, *p.c_strides, *p.box32, *p.box64]
    # 1080 x 1920 is whole tiles: the phases execute exactly the useful work
    useful = sum(2 * 1080 * 1920 * 9 * (NF + k * GC) * (GC if k < 4 else NF) for k in range(5))
    assert p.executed_ops() == useful and p.executed_ops(3) == 3 * useful


def test_the_phases_in_launch_order():
    p = rdb.rdb_x3_plan(2, 37, 53, sms=132)
    assert list(p.phases()) == [(64, 32, 2 * 5), (96, 32, 2 * 5), (128, 32, 2 * 5),
                                (160, 32, 2 * 5), (192, 64, 2 * 10)]
    assert len(list(p.phases(3))) == 15
    assert p.grid == 20  # the widest phase's tiles: blocks with none wait at the barrier


@pytest.mark.parametrize("shape,grid", [((1, 5, 7), 2), ((1, 9, 64), 3), ((4, 384, 504), 132)])
def test_the_grid_is_at_most_one_block_an_sm(shape, grid):
    assert rdb.rdb_x3_plan(*shape, sms=132).grid == grid


def test_the_geometry_of_another_build():
    g = dict(rdb.K5_X3, th32=4, smem=max(tail.bf16x3_smem(32, 4), tail.bf16x3_smem(64, 4)))
    p = rdb.rdb_x3_plan(1, 64, 64, g, sms=132)
    assert p.box32 == (16, 66, 6, 1) and p.tiles_y32 == 16 and p.smem == g["smem"]


@pytest.mark.parametrize(
    "shape,geometry,match",
    [
        ((0, 4, 5), None, "empty shape"),
        ((1 << 11, 1 << 10, 1 << 10), None, "2\\^31 pixels"),
        ((1, 4, 5), dict(rdb.K5_X3, smem=1), "shared memory"),
        ((1, 4, 5), dict(rdb.K5_X3, th32=16, smem=tail.bf16x3_smem(32, 16)), "shared memory"),
    ],
)
def test_calls_the_kernel_cannot_take_are_refused(shape, geometry, match):
    with pytest.raises(ValueError, match=match):
        rdb.rdb_x3_plan(*shape, geometry)


def test_the_wrappers_count_the_route_on_the_cpu_never():
    """On CPU tensors both wrappers run their plain versions and launch
    nothing, whatever the route would be on the card."""
    rng = np.random.default_rng(2)
    w = _weights(rng)
    x = _x(rng, (1, 3, 4))
    assert rdb.rdb_route(F32, NF, GC) == "bf16x3"
    _build.reset_launches()
    assert torch.equal(rdb.rrdb_fused(x, w), rdb.rrdb_fused_plain(x, w))
    assert torch.equal(rdb.rdb_fused(x, *w[0]), rdb.rdb_fused_plain(x, *w[0]))
    assert _build.launches() == {}
