"""The fp32 one-launch tail (``"bf16x3"``, ``csrc/tail_fused_bf16x3.cu``), on a machine without a card.

The kernel runs upconv2 -> conv_hr -> conv_last in one launch over rolling
rows: a block walks down its segments of 60-column stripes, one output row
a step, upconv2 and conv_hr as K1 ``"bf16x3"``'s conv (the six products of
each value's three bf16 parts) at 64 pixels a row, u2 and hr in rings of 3
rows, conv_last on fp32 FMAs in ``conv3x3.cu``'s order. What is held here:

- ``tail_x3_plan``: the stripes, the rows the blocks share and each block's
  segments, the shared memory, the threads, the weight box, the steps of a
  segment and the work they execute, its refusals, and the Python plan
  against the shipped build's constants (read from the source);
- a CPU emulation of the kernel's schedule (each block's segments in its
  order; per step the window of upconv2's u2 row at the fine grid, u2 into
  its ring, conv_hr's window from the ring, hr into its ring, conv_last's
  row from the ring; every mask and ring index as the kernel has them; the
  convs summed as the kernel sums them: each k16 group of a part's product
  in float64 in channel order, rounded once, added to one fp32 accumulator,
  conv_last's FMAs emulated in float64 and rounded once each) is bit-equal
  to the same arithmetic run as the three-launch chain over whole frames,
  at B = 2, ragged extents, two stripes, a last stripe of 2 columns and
  more segments than blocks;
- the emulation agrees with the JAX package's ``tail_fused_q``
  (``pallas_tail.py:1018``, in interpret mode, fed by its ``up1_fused``)
  within 1e-4 of the largest output value (fp32 sums in another order).

The kernel itself runs on the card only (``chip_smoke.py --only k6``;
``python -m video_restore_tpu_torch.tools.probe_k6 --dtype fp32``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.ops import _build, tail

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

F32 = torch.float32
NF = 64
SRC = (_build.CSRC / "tail_fused_bf16x3.cu").read_text()
TOL = 1e-4  # of the largest output value: fp32 sums in another order
SIX = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))  # a_i * w_j, smallest first


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


# ---- the arithmetic -------------------------------------------------------------


def _x3_sum(a, w):
    """K1 ``"bf16x3"``'s sums: a (..., ky 3, kx + n, cin) windows of the
    three parts' rows, w (3, 3, 3, cin, cout) parts -> (..., n, cout):
    output n reads a[..., ky, n + kx, :]; per 16 input channels, the taps
    in order, the six products smallest first, each k16 group summed in
    float64 in channel order and rounded once, added to one fp32
    accumulator."""
    n = a.shape[-2] - 2
    cin = a.shape[-1]
    acc = torch.zeros(*a.shape[1:-3], n, w.shape[-1], dtype=F32)
    for c0 in range(0, cin, 16):
        for ky in range(3):
            for kx in range(3):
                for i, j in SIX:
                    x = a[i][..., ky, kx:kx + n, c0:c0 + 16]
                    wt = w[j][ky, kx, c0:c0 + 16]
                    s = x[..., 0:1] * wt[0]
                    for c in range(1, 16):
                        s = s + x[..., c:c + 1] * wt[c]
                    acc = acc + s.float()
    return acc


def _windows(t):
    """A frame (B, H, W, C), zero-padded by 1, as (B, H, ky 3, W + 2, C):
    row y's three source rows."""
    p = torch.nn.functional.pad(t, (0, 0, 1, 1, 1, 1))
    return torch.stack([p[:, ky:ky + t.shape[1]] for ky in range(3)], 2)


def _lrelu(v):
    return torch.where(v >= 0, v, 0.2 * v)


def _last(h, w, b):
    """conv3x3.cu's sums for conv_last: h (..., ky 3, n + 2, 64) -> (..., n,
    3), from zero, per input channel over ky, kx, each FMA emulated in
    float64 and rounded once; then the bias."""
    n = h.shape[-2] - 2
    acc = torch.zeros(*h.shape[:-3], n, 3, dtype=F32)
    hd, wd = h.double(), w.double()
    for ci in range(h.shape[-1]):
        for ky in range(3):
            for kx in range(3):
                acc = (hd[..., ky, kx:kx + n, ci:ci + 1] * wd[ky, kx, ci] + acc.double()).float()
    return acc + b


def chain(x, w_up2, b_up2, w_hr, b_hr, w_last, b_last):
    """The three-launch chain's arithmetic over whole frames: upconv2 and
    conv_hr as K1 ``"bf16x3"``, conv_last as K1 ``"fma"``."""
    fine = tail.upsample_nearest(x, 2)
    wp = tail.split3(w_up2).double()
    u2 = _lrelu(_x3_sum(tail.split3(_windows(fine)).double(), wp) + b_up2)
    hr = _lrelu(_x3_sum(tail.split3(_windows(u2)).double(), tail.split3(w_hr).double()) + b_hr)
    return _last(_windows(hr), w_last, b_last)


def kernel_emulated(x, w_up2, b_up2, w_hr, b_hr, w_last, b_last, sms):
    """The kernel's schedule: each block's segments (the plan's), its rings
    zero at the start; per step u of a segment [y0, y1) (u = y0 - 2 ..
    y1 + 1): upconv2's u2 row u (fine columns X - 2 .. X + 61) from its
    3 x 66 window of the fine grid into the u2 ring, conv_hr's hr row u - 1
    (X - 1 .. X + 62, the first 62 kept) from u2 rows u - 2 .. u of the
    ring, each zero outside the frame; conv_last's output row u - 2 (X ..
    X + 59) from hr rows u - 3 .. u - 1 where the segment needs it."""
    b, h2, w2, nf = x.shape
    oh, ow = 2 * h2, 2 * w2
    plan = tail.tail_x3_plan(b, h2, w2, sms=sms)
    sw = plan.stripe
    # zeros 3 rows above and below the frame, 3 columns left and 66 right
    fine = torch.nn.functional.pad(tail.upsample_nearest(x, 2), (0, 0, 3, 66, 3, 3))
    p_up2, p_hr = tail.split3(w_up2).double(), tail.split3(w_hr).double()
    out = torch.full((b, oh, ow, 3), float("nan"))
    cols = torch.arange(64)
    for blk in range(plan.grid):
        uring, hring = torch.zeros(3, 66, nf), torch.zeros(3, sw + 2, nf)
        for n, X, y0, y1 in plan.segments(blk):
            for u in range(y0 - 2, y1 + 2):
                win = fine[n, u + 2:u + 5, X:X + 66]  # fine rows u - 1 .. u + 1, columns X - 3 ..
                v = _lrelu(_x3_sum(tail.split3(win).double(), p_up2) + b_up2)
                inside = (0 <= u < oh) & (X - 2 + cols >= 0) & (X - 2 + cols < ow)
                uring[u % 3, :64] = torch.where(inside[:, None], v, 0.0)
                win = torch.stack([uring[(u - 2 + ky) % 3] for ky in range(3)])
                v = _lrelu(_x3_sum(tail.split3(win).double(), p_hr) + b_hr)
                inside = (0 <= u - 1 < oh) & (X - 1 + cols >= 0) & (X - 1 + cols < ow)
                hring[(u - 1) % 3] = torch.where(inside[:, None], v, 0.0)[: sw + 2]
                if u - 2 >= y0:
                    rows = torch.stack([hring[(u - 3 + ky) % 3] for ky in range(3)])
                    o = _last(rows, w_last, b_last)
                    k = min(sw, ow - X)
                    out[n, u - 2, X:X + k] = o[:k]
    return out


def _ops(rng, nf=NF):
    def mk(*s, shift=0.0):
        return torch.from_numpy((rng.normal(0, 0.05, s) + shift).astype(np.float32))

    return [mk(3, 3, nf, nf), mk(nf, shift=0.1), mk(3, 3, nf, nf), mk(nf, shift=0.1),
            mk(3, 3, nf, 3), mk(3)]


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), err
    return err


@pytest.mark.parametrize(
    "shape,sms",
    [
        ((1, 3, 5), 3),    # 6 x 10: one stripe, three blocks of two rows
        ((2, 2, 33), 5),   # 2 x 4 x 66: two stripes, a last one of 6 columns, B = 2
        ((1, 2, 31), 2),   # 4 x 62: a last stripe of 2 columns
    ],
)
def test_the_kernel_schedule_is_bit_equal_to_the_chain(shape, sms):
    rng = np.random.default_rng(sum(shape) + sms)
    x = torch.from_numpy(rng.uniform(-1, 1, (*shape, NF)).astype(np.float32))
    ops = _ops(rng)
    got = kernel_emulated(x, *ops, sms=sms)
    assert not torch.isnan(got).any()  # every output written once
    assert torch.equal(got, chain(x, *ops))
    _close(got, tail.tail_fused_q_plain(x, *ops))


def test_the_emulation_agrees_with_the_jax_quad_tail():
    from video_restore_tpu.ops.pallas_tail import tail_fused_q, up1_fused

    rng = np.random.default_rng(7)
    h1, w1 = 3, 5
    x1 = rng.random((1, h1, w1, NF)).astype(np.float32)
    wu1 = (rng.random((3, 3, NF, NF)) * 0.02).astype(np.float32)
    bu1 = (rng.random(NF) * 0.1 + 0.3).astype(np.float32)
    ops = _ops(rng)
    xq = up1_fused(jnp.asarray(x1), jnp.asarray(wu1), jnp.asarray(bu1), masked=True,
                   block_h=4, interpret=True)
    ref = np.asarray(tail_fused_q(xq, *[jnp.asarray(t.numpy()) for t in ops], h2=2 * h1, w1=w1,
                                  block_h=4, interpret=True))
    up = tail.up1_fused(torch.from_numpy(x1), torch.from_numpy(wu1), torch.from_numpy(bu1))
    got = kernel_emulated(up, *ops, sms=2)
    assert got.shape == ref.shape == (1, 4 * h1, 4 * w1, 3)
    _close(got, ref)


# ---- the plan ----------------------------------------------------------------------


def test_the_python_plan_matches_the_shipped_build():
    assert tail.TAIL_X3_STRIPE == _const("T_SW") == 60
    assert tail.TAIL_X3_SLOTS == _const("T_WS") == 3
    assert tail.TAIL_X3_THREADS == 14 * 32  # 2 consumer warpgroups, the producer's, 2 warps
    assert tail.tail_x3_smem() == 231184 <= tail.SMEM_MAX
    assert len(tail.tail_x3_plan(1, 4, 4).array()) == _const("T_PLAN_LEN") == 10


def test_the_flagship_tail_plan():
    p = tail.tail_x3_plan(1, 2160, 3840, sms=132)
    assert (p.stripes, p.rows, p.grid) == (128, 128 * 4320, 132)
    assert p.frame == (1, 4320, 7680) and p.w_box == (32, 16, 3)
    assert list(p.array()) == [60, 3, 231184, 448, 132, 128, 128 * 4320, 32, 16, 3]
    # every block's rows in segments of one stripe, covering the frame once
    seen = 0
    for blk in range(p.grid):
        r0, r1 = p.block_rows(blk)
        segs = list(p.segments(blk))
        assert sum(y1 - y0 for _, _, y0, y1 in segs) == r1 - r0
        seen += r1 - r0
    assert seen == p.rows
    useful = 2 * 2 * 4320 * 7680 * 9 * NF * NF
    assert 1.06 < p.executed_ops() / useful < 1.08  # 64 of 60 columns, 4 fill steps a segment


def test_a_segment_takes_four_more_steps_than_rows():
    assert [tail.TailX3Plan.steps(n) for n in (1, 2, 33)] == [5, 6, 37]


@pytest.mark.parametrize("shape,grid", [((1, 5, 7), 1), ((2, 37, 53), 10), ((1, 100, 150), 32),
                                        ((1, 1000, 1500), 132)])
def test_the_grid_takes_at_least_32_rows_a_block(shape, grid):
    p = tail.tail_x3_plan(*shape, sms=132)
    assert p.grid == grid == max(1, min(132, -(-p.rows // tail.TAIL_MIN_ROWS)))


@pytest.mark.parametrize(
    "shape,match",
    [
        ((0, 4, 5), "empty shape"),
        ((1, 0, 5), "empty shape"),
        ((1, 4, -3), "empty shape"),
        ((1, 1 << 30, 4), "2\\^30"),
        ((1, 4, 1 << 30), "2\\^30"),
    ],
)
def test_calls_the_kernel_cannot_take_are_refused(shape, match):
    with pytest.raises(ValueError, match=match):
        tail.tail_x3_plan(*shape)
