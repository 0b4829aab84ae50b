"""K5's ``"wgmma"`` route on a machine without a card: its launch plan, and a
CPU emulation of its schedule.

``csrc/rdb_fused_wgmma.cu`` walks column stripes of 54 output columns down
rolling rings of rows in shared memory: conv k computes one 64-pixel row per
output row, one row behind conv k - 1, c_k lives in a ring of R + 6 - k rows
(R output rows a step) and x in a FIFO of R + 6 rows that TMA refills once
conv 5 has read a step's x part. The wrapper's plan
(``ops/rdb.py::rdb_wgmma_plan``) cuts B x stripes x H rows into one run a
block; the C launcher only checks it against its build and encodes it.

Held here: the plan against the source's compile-time defaults (the way
``tests/test_torch_wgmma_plan.py`` holds K1's), at odd shapes (5x7, below
one stripe, 1920 = 35 x 54 + 30, B = 2): every (image, stripe, row) in
exactly one segment of one block, the blocks' runs within one row of each
other, shared memory within the card's 232,448 bytes, and what TMA cannot
describe refused. Then :func:`emulate`, the kernel's schedule in plain
PyTorch fp32 (the plan's segments, the x FIFO with TMA's zero fill and its
early refill, the c rings with their modulo and the reads past a row's
64th pixel, the lag of one row per conv, the frame mask, the stores of the
segment's rows): on integer-valued data, where every fp32 sum is exact in
any order, it equals ``rdb_fused_plain`` bit for bit, so only the schedule
could differ; on random bf16 data it is within 2 bf16 steps of the
output's largest value of the JAX ``rdb_stripe`` in interpret mode (both
round each c_k to bf16 after fp32 sums in another order:
``tests/test_torch_rdb.py``'s tolerance). The kernel itself runs on the card
only (``chip_smoke.py --only k5``; ``python -m
video_restore_tpu_torch.tools.probe_k5k3 --route wgmma``).
"""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from video_restore_tpu_torch.ops import _build, rdb

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

BF = torch.bfloat16
NF, GC = 64, 32
SRC = (_build.CSRC / "rdb_fused_wgmma.cu").read_text()


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


def _constexpr(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_the_python_plan_matches_the_shipped_build():
    """:data:`rdb.K5_WGMMA` is the source's own geometry: rows a step,
    stripe, x ring pixels, weight slots, the early x release, the rings'
    depths and the shared memory they take; the plan has the length the
    launcher reads."""
    g = rdb.K5_WGMMA
    r = _define("VR_K5_ROWS")
    assert g["step_rows"] == r == 3
    assert g["slots"] == _define("VR_K5_WSLOTS")
    assert g["early_x"] == _define("VR_K5_EARLY_X")
    assert g["stripe"] == _define("VR_K5_SW") == 54
    assert g["ring_px"] == 64  # conv 1 reads the stripe's 54 + 10 x columns
    assert g["threads"] == r * 128 + 128  # the consumer warpgroups and the producer's
    assert g["x_rows"] == r + 6 and g["c_rows"] == tuple(r + 6 - k for k in range(1, 5))
    assert g["smem"] == rdb.k5_smem(g["x_rows"], g["c_rows"], g["slots"]) <= rdb.SMEM_MAX
    plan = rdb.rdb_wgmma_plan(1, 8, 8)
    assert len(plan.array()) == _constexpr("PLAN_LEN") == 33


@pytest.mark.parametrize(
    "shape,stripes",
    [
        ((1, 5, 7), 1),          # below one stripe and one segment's fill
        ((1, 9, 50), 1),         # below one stripe
        ((1, 1080, 1920), 36),   # 1920 = 35 x 54 + 30
        ((2, 37, 53), 1),        # B = 2
        ((2, 130, 150), 3),
        ((4, 384, 504), 10),     # bench_rdb's shape
    ],
)
def test_plan_covers_every_row_once(shape, stripes):
    b, h, w = shape
    p = rdb.rdb_wgmma_plan(b, h, w, sms=132)
    assert p.stripes == stripes and p.rows == b * stripes * h
    assert p.a_dims == (64, w, h, b)
    assert p.a_strides == (128, w * 128, h * w * 128)
    assert p.a_box == (32, 64, 1, 1) and p.a_swizzle == 64
    assert (p.w_box, p.w_swizzle, p.w5_box, p.w5_swizzle) == ((32, 32, 9), 64, (64, 16, 9), 128)
    assert 1 <= p.grid <= 132 and p.grid <= -(-p.rows // rdb.K5_MIN_ROWS)
    seen = np.zeros((b, stripes, h), np.int32)
    runs = []
    for blk in range(p.grid):
        n_rows = 0
        for n, x0, y0, y1 in p.segments(blk):
            assert 0 <= n < b and x0 % 54 == 0 and 0 <= y0 < y1 <= h
            seen[n, x0 // 54, y0:y1] += 1
            n_rows += y1 - y0
        runs.append(n_rows)
    assert (seen == 1).all()
    assert max(runs) - min(runs) <= 1


def test_the_flagship_frame_cuts_into_equal_runs():
    """1x1080x1920: 36 stripes x 1080 rows over 132 blocks, 294 or 295 rows
    each, in at most two segments; executed over useful work 1.22 (64 of 54
    columns, the last stripe's 30 of 54, and each segment's fill)."""
    p = rdb.rdb_wgmma_plan(1, 1080, 1920, sms=132)
    assert p.grid == 132 and p.rows == 38880
    segs = [list(p.segments(blk)) for blk in range(p.grid)]
    assert max(len(s) for s in segs) == 2
    assert {sum(y1 - y0 for _, _, y0, y1 in s) for s in segs} == {294, 295}
    useful = 2 * 9 * 1080 * 1920 * sum((NF + k * GC) * (GC if k < 4 else NF) for k in range(5))
    assert 1.21 < p.executed_ops() / useful < 1.23
    # steps: conv 5, four rows behind conv 1, reaches the segment's last row;
    # at 3 rows a step conv 2 runs from the first and conv 3 from the second
    assert p.steps(294) == 101 and [p.first_step(k) for k in range(1, 6)] == [0, 0, 1, 2, 2]


@pytest.mark.parametrize("variant", [dict(step_rows=1, stripe=56, ring_px=72),
                                     dict(step_rows=2, stripe=56, ring_px=72),
                                     dict(step_rows=2, slots=4), dict(slots=2),
                                     dict(stripe=50, ring_px=64)])
def test_the_probe_variants_fit(variant):
    g = dict(rdb.K5_WGMMA, **variant)
    r = g["step_rows"]
    g.update(x_rows=r + 6, c_rows=tuple(r + 6 - k for k in range(1, 5)))
    g["smem"] = rdb.k5_smem(g["x_rows"], g["c_rows"], g["slots"], g["ring_px"], g["stripe"])
    p = rdb.rdb_wgmma_plan(1, 1080, 1920, g)
    assert p.step_rows == r and p.smem <= rdb.SMEM_MAX
    assert p.stripes == -(-1920 // g["stripe"]) and p.a_box == (32, g["ring_px"], 1, 1)


def test_the_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="empty shape"):
        rdb.rdb_wgmma_plan(1, 0, 8)
    # three rows a step of 56-column stripes do not fit the card's shared memory
    g = dict(rdb.K5_WGMMA, stripe=56, ring_px=72)
    g["smem"] = rdb.k5_smem(9, g["c_rows"], 3, 72, 56)
    with pytest.raises(ValueError, match="shared memory"):
        rdb.rdb_wgmma_plan(1, 8, 8, g)
    # a build whose shared memory is not what its geometry needs
    with pytest.raises(ValueError, match="shared memory"):
        rdb.rdb_wgmma_plan(1, 8, 8, dict(rdb.K5_WGMMA, smem=rdb.K5_WGMMA["smem"] + 16))
    with pytest.raises(ValueError, match="rows held"):
        rdb.rdb_wgmma_plan(1, 8, 8, dict(rdb.K5_WGMMA, x_rows=10))
    # x ring rows too short for conv 1's reads
    with pytest.raises(ValueError, match="x ring rows"):
        rdb.rdb_wgmma_plan(1, 8, 8, dict(rdb.K5_WGMMA, stripe=56))
    # strides TMA cannot describe: an image of 2^40 bytes or more
    with pytest.raises(ValueError, match="byte stride"):
        rdb.rdb_wgmma_plan(1, 1 << 16, 1 << 17)
    with pytest.raises(ValueError, match="2\\^32"):
        rdb.rdb_wgmma_plan(1, 1, 1 << 32)


# ---- the schedule, emulated -------------------------------------------------------


def emulate(x, ws, bs, x0=None, plan=None):
    """``rdb_fused_wgmma.cu``'s schedule in plain PyTorch fp32: one RDB of x
    (B, H, W, 64) bf16 with the five HWIO bf16 weights, biases and the
    optional x0, block by block over the plan's segments, with the kernel's
    rings, their slots and their refills. Sums per 16 input channels in
    growth order, the nine taps in order; c_k rounded to bf16 as it is
    stored."""
    b_, h, w, _ = x.shape
    p = plan or rdb.rdb_wgmma_plan(b_, h, w)
    r_, dx = p.step_rows, p.x_rows
    xf = F.pad(x.float(), (0, 0, 8, 80, 8, 8))  # zero fill around the frame
    sw = p.stripe
    x0f = None if x0 is None else F.pad(x0.float(), (0, 0, 0, sw))
    wf = [t.float() for t in ws]
    bf = [t.float() for t in bs]
    out = torch.full((b_, h, w, NF), float("nan"))
    for blk in range(p.grid):
        # the kernel's layout: c_1 .. c_4 (rows of the columns a needed
        # output reads), then the x FIFO (each row two planes of ring_px
        # pixels), then a pad; a read past a row's end lands in what follows
        xp = p.ring_px
        cp = [p.stripe + 10 - 2 * k for k in range(1, 5)]  # c_k's row: the needed columns
        c_at = np.cumsum([0] + [d * c for d, c in zip(p.c_rows, cp)])
        x_at = -(-int(c_at[-1]) // 16) * 16  # the c region rounded to 1024 bytes
        flat = torch.zeros(x_at + dx * 2 * xp + 16, GC)
        xn = 0  # x rows loaded into the FIFO

        for n, X, y0, y1 in p.segments(blk):
            xbase = xn

            def load(row, n=n, X=X):
                nonlocal xn
                # TMA's box: ring_px pixels from column X - 5, zero outside
                src = xf[n, row + 8, X - 5 + 8: X - 5 + 8 + xp]
                at = x_at + (xn % dx) * 2 * xp
                flat[at:at + xp] = src[:, :GC]
                flat[at + xp:at + 2 * xp] = src[:, GC:]
                xn += 1

            def x_rows(row, plane, shift, y0=y0, xbase=xbase):
                at = x_at + ((xbase + row - (y0 - 5)) % dx * 2 + plane) * xp + shift
                return flat[at:at + 64]

            def c_rows(k, row, shift):
                at = int(c_at[k - 1]) + (row % p.c_rows[k - 1]) * cp[k - 1] + shift
                return flat[at:at + 64]

            for i in range(r_ + 2):
                load(y0 - 5 + i)
            steps = p.steps(y1 - y0)
            for t in range(steps):
                base = y0 - 4 + r_ * t
                x_next = t + 1 < steps  # the next step's rows still to load
                for k in range(1, 6):
                    if t < p.first_step(k):
                        continue
                    rows = [base - (k - 1) + i for i in range(r_)]
                    cout = GC if k < 5 else NF
                    # conv 5's residual, read before the x rows may be refilled
                    res = [torch.cat([x_rows(row, 0, 5), x_rows(row, 1, 5)], -1)[:sw]
                           for row in rows] if k == 5 else None
                    acc = [torch.zeros(64, cout) for _ in rows]
                    # the stages in growth order: x's 64 channels, then c_1 ..
                    chunks = [(0, c) for c in range(4)] + [
                        (s, c) for s in range(1, k) for c in range(2)]
                    for ci, (s, c) in enumerate(chunks):
                        if k == 5 and ci == 4 and x_next:
                            # conv 5's x part is read: the oldest rows go
                            for i in range(r_):
                                load(base + r_ + 1 + i)
                            x_next = False
                        lo = c * 16 if s else (c % 2) * 16
                        wlo = (c * 16 if s == 0 else NF + (s - 1) * GC + c * 16)
                        for ri, row in enumerate(rows):
                            for tap in range(9):
                                ky, kx = divmod(tap, 3)
                                shift = kx + k - 1 - s
                                if s == 0:
                                    a = x_rows(row - 1 + ky, c // 2, shift)[:64, lo:lo + 16]
                                else:
                                    a = c_rows(s, row - 1 + ky, shift)[:64, lo:lo + 16]
                                acc[ri] += a @ wf[k - 1][ky, kx, wlo:wlo + 16]
                    for ri, row in enumerate(rows):
                        v = acc[ri] + bf[k - 1]
                        if k < 5:
                            v = F.leaky_relu(v, 0.2)
                            fx = torch.arange(64) + X - 5 + k
                            inside = (fx >= 0) & (fx < w) & (0 <= row < h)
                            v = torch.where(inside[:, None], v, torch.zeros(()))
                            at = int(c_at[k - 1]) + (row % p.c_rows[k - 1]) * cp[k - 1]
                            flat[at:at + cp[k - 1]] = v[:cp[k - 1]].to(BF).float()
                        elif y0 <= row < y1:
                            o = res[ri] + 0.2 * v[:sw]
                            if x0f is not None:
                                o = x0f[n, row, X:X + sw] + 0.2 * o.to(BF).float()
                            m = min(sw, w - X)
                            out[n, row, X:X + m] = o[:m]
                if x_next:  # conv 5 did not run: the rows go after the step
                    for i in range(r_):
                        load(base + r_ + 1 + i)
    assert not out.isnan().any()
    return out.to(BF)


def _weights(rng, integer):
    ws, bs = [], []
    for k in range(5):
        cin, cout = NF + k * GC, GC if k < 4 else NF
        if integer:
            w = (rng.random((3, 3, cin, cout)) < 1 / 48).astype(np.float32)
            b = rng.integers(0, 3, cout).astype(np.float32)
        else:
            w = ((rng.random((3, 3, cin, cout)) - 0.5) * 0.1).astype(np.float32)
            b = ((rng.random(cout) - 0.5) * 0.1).astype(np.float32)
        ws.append(torch.from_numpy(w).to(BF))
        bs.append(torch.from_numpy(b).to(BF))
    return ws, bs


@pytest.mark.parametrize(
    "shape,x0",
    [
        ((1, 5, 7), False),    # below one stripe and one step's fill
        ((2, 11, 60), True),   # B = 2, two stripes, the last of 4 columns
        ((1, 9, 70), False),   # a last stripe of 16 columns
        ((1, 40, 57), True),   # several blocks, segments across stripes
    ],
)
def test_the_schedule_equals_plain_on_exact_data(shape, x0):
    """Integer data (x and biases in 0..2, weights 0 or 1): every fp32 sum of
    the chain stays an integer below 2^24, so it is exact in any order and
    only the schedule (rings, slots, lag, masks, stores) could differ."""
    rng = np.random.default_rng(sum(shape))
    ws, bs = _weights(rng, integer=True)
    x = torch.from_numpy(rng.integers(0, 3, shape + (NF,)).astype(np.float32)).to(BF)
    xr = torch.from_numpy(rng.integers(0, 3, shape + (NF,)).astype(np.float32)).to(BF) if x0 else None
    plan = rdb.rdb_wgmma_plan(*shape, sms=4)  # several blocks even at these sizes
    got = emulate(x, ws, bs, xr, plan)
    want = rdb.rdb_fused_plain(x, ws, bs, xr)
    # the exactness the test rests on: every partial sum (no term is
    # negative) at most conv 5's, about 5x the output, below 2^24
    assert float(want.float().abs().max()) * 5 < 2**24
    assert torch.equal(got, want)


@pytest.mark.parametrize("geometry", [dict(step_rows=1, stripe=56, ring_px=72),
                                      dict(step_rows=2, stripe=56, ring_px=72),
                                      dict(step_rows=2, slots=4)])
def test_the_probe_geometries_schedule_equals_plain(geometry):
    """The probe's other builds (one or two rows a step on 56-column
    stripes, two on 54 with a fourth weight slot), emulated at a shape with
    several blocks and a ragged last stripe, on the exact data of the test
    above."""
    g = dict(rdb.K5_WGMMA, **geometry)
    r = g["step_rows"]
    g.update(x_rows=r + 6, c_rows=tuple(r + 6 - k for k in range(1, 5)))
    g["smem"] = rdb.k5_smem(g["x_rows"], g["c_rows"], g["slots"], g["ring_px"], g["stripe"])
    shape = (1, 37, 70)
    rng = np.random.default_rng(5)
    ws, bs = _weights(rng, integer=True)
    x = torch.from_numpy(rng.integers(0, 3, shape + (NF,)).astype(np.float32)).to(BF)
    plan = rdb.rdb_wgmma_plan(*shape, g, sms=3)
    assert plan.grid == 3 and plan.stripes == 2
    assert max(len(list(plan.segments(b))) for b in range(3)) == 2  # across a stripe
    want = rdb.rdb_fused_plain(x, ws, bs)
    assert float(want.float().abs().max()) * 5 < 2**24
    assert torch.equal(emulate(x, ws, bs, plan=plan), want)


@pytest.mark.parametrize("shape", [(1, 7, 60), (2, 13, 9)])
def test_the_schedule_matches_jax_rdb_stripe(shape):
    """Random bf16 data: the emulation within 2 bf16 steps of the largest
    value of the JAX ``rdb_stripe`` (``pallas_stripe.py:2079``) in interpret
    mode, and of ``rdb_fused_plain``."""
    import jax.numpy as jnp

    from video_restore_tpu.ops.pallas_stripe import prefix_rdb_weights, rdb_stripe

    rng = np.random.default_rng(7)
    ws, bs = _weights(rng, integer=False)
    x = torch.from_numpy(rng.random(shape + (NF,)).astype(np.float32)).to(BF)
    got = emulate(x, ws, bs, plan=rdb.rdb_wgmma_plan(*shape, sms=2)).float().numpy()
    params = {f"conv{k + 1}": {"w": jnp.asarray(ws[k].float().numpy()),
                               "b": jnp.asarray(bs[k].float().numpy())} for k in range(5)}
    pw, pb = prefix_rdb_weights(params, NF, GC)
    ref = np.asarray(rdb_stripe(jnp.asarray(x.float().numpy(), jnp.bfloat16), pw, pb,
                                interpret=True)).astype(np.float32)
    step = np.exp2(np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.abs(got - ref).max() <= 2 * step
    plain = rdb.rdb_fused_plain(x, ws, bs).float().numpy()
    assert np.abs(got - plain).max() <= 2 * step
