"""The one-launch tail's ``"wgmma"`` route and up1's nearest-2x producer on a
machine without a card: the launch plan, and CPU emulations of both
kernels' schedules.

``csrc/tail_fused_wgmma.cu`` walks column stripes of 60 output columns down
rolling rings of rows in shared memory: R = 3 rows a step, upconv2 one
64-pixel row per output row from a ring of R + 2 fine-width x rows (coarse
row c in slot c mod (R + 2), fine pixel f holding coarse pixel (f + 1) >> 1
of the stripe's window), conv_hr one row behind from a ring of R + 2 u2
rows, conv_last two rows behind that from a ring of R + 3 hr rows. The
wrapper's plan (``ops/tail.py::tail_wgmma_plan``) cuts B x stripes x OH
rows into one run a block; the C launcher only checks it against its build.

Held here: the plan against the source's compile-time defaults (as
``tests/test_torch_k5_wgmma_plan.py`` holds K5's), at odd shapes (a frame
narrower than one stripe, a last stripe of 2 columns, B = 2 and 6, the 8K
frame): every (image, stripe, row) in exactly one segment of one block, the
blocks' runs within one row of each other, shared memory within the card's
232,448 bytes, and what the kernel cannot take refused. Then
:func:`emulate`, the kernel's schedule in plain PyTorch (the plan's
segments, the x copies one step ahead into their ring slots, the rings with
their modulo and the reads past a u2 row's 64th pixel, the lags, the frame
masks, the stores of the segment's rows): on integer-valued data, where
every fp32 sum is exact in any order, it equals ``tail_fused_plain`` bit
for bit, and a ring one row short breaks it; in fp32 it is within the
rtol = atol = 2e-4 of ``tests/test_torch_tailq.py`` of the JAX
``tail_fused`` (``pallas_tail.py:425``) in interpret mode. Last,
:func:`emulate_up2`, K1's ``wgmma`` conv read through nearest 2x as its
producer warpgroup fills each window (``csrc/conv3x3_wgmma.cu``), against
``conv3x3_plain(upsample2=True)`` bit for bit on integer data. The kernels
run on the card only (``chip_smoke.py --only k6,k1``; ``python -m
video_restore_tpu_torch.tools.probe_k6 --route wgmma``).
"""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from video_restore_tpu_torch.ops import _build, tail

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

BF, F32 = torch.bfloat16, torch.float32
NF = 64
SRC = (_build.CSRC / "tail_fused_wgmma.cu").read_text()


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


def _constexpr(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _geometry(**variant):
    """:data:`tail.TAIL_WGMMA` with ``variant`` applied and the rings,
    threads and shared memory that follow from it (as the source derives
    them)."""
    g = dict(tail.TAIL_WGMMA, **variant)
    r, sw = g["step_rows"], g["stripe"]
    g.update(x_rows=r + 2, u2_rows=r + 2, hr_rows=r + 3, ring_px=(sw + 13) // 8 * 8,
             threads=128 * r + 128)
    g["smem"] = tail.tail_smem(r, sw, g["slots"])
    return g


def test_the_python_plan_matches_the_shipped_build():
    """:data:`tail.TAIL_WGMMA` is the source's own geometry: rows a step,
    stripe, weight slots, the rings' depths, the threads and the shared
    memory they take (conv_last on three warps of a fourth warpgroup, an hr
    row even pixels first); the plan has the length the launcher reads."""
    g = tail.TAIL_WGMMA
    r = _define("VR_TAIL_ROWS")
    assert g["step_rows"] == r == 3
    assert g["stripe"] == _define("VR_TAIL_SW") == 60
    assert g["slots"] == _define("VR_TAIL_WSLOTS") == 3
    assert _constexpr("LAST_WARPS") == 3
    assert g["ring_px"] == 72  # upconv2 reads the stripe's 60 + 6 fine columns
    assert (g["x_rows"], g["u2_rows"], g["hr_rows"]) == (r + 2, r + 2, r + 3)
    assert g["threads"] == r * 128 + 128  # the consumers, then a fourth warpgroup
    assert g == _geometry()
    # an hr row: 31 even pixels, then from 4544 bytes (64 mod 128: 16 banks
    # on) 31 odd ones, 144 bytes each
    assert tail.tail_hr_row(60) == 4544 + 31 * 144
    assert g["smem"] == tail.tail_smem(r, 60, 3) == 206960 <= tail.SMEM_MAX
    plan = tail.tail_wgmma_plan(1, 8, 8)
    assert len(plan.array()) == _constexpr("PLAN_LEN") == 16


@pytest.mark.parametrize(
    "shape,stripes",
    [
        ((1, 5, 7), 1),            # 10 x 14: narrower than one stripe
        ((1, 1, 31), 2),           # 2 x 62: a last stripe of 2 columns
        ((2, 37, 53), 2),          # B = 2, 74 x 106
        ((3, 7, 200), 7),          # 14 x 400: more stripes than rows a block
        ((6, 376, 448), 15),       # the 720p tile batch's up1 output
        ((1, 2160, 3840), 128),    # the flagship: 4320 x 7680, 7680 = 128 x 60
    ],
)
def test_plan_covers_every_row_once(shape, stripes):
    b, h2, w2 = shape
    p = tail.tail_wgmma_plan(b, h2, w2, sms=132)
    oh = 2 * h2
    assert p.stripes == stripes and p.rows == b * stripes * oh and p.frame == (b, oh, 2 * w2)
    assert (p.w_box, p.w_swizzle, p.threads) == ((64, 16, 9), 128, 512)
    assert 1 <= p.grid <= 132 and p.grid <= -(-p.rows // tail.TAIL_MIN_ROWS)
    seen = np.zeros((b, stripes, oh), np.int32)
    runs = []
    for blk in range(p.grid):
        n_rows = 0
        for n, x0, y0, y1 in p.segments(blk):
            assert 0 <= n < b and x0 % 60 == 0 and 0 <= y0 < y1 <= oh
            seen[n, x0 // 60, y0:y1] += 1
            n_rows += y1 - y0
        runs.append(n_rows)
    assert (seen == 1).all()
    assert max(runs) - min(runs) <= 1


def test_the_flagship_frame_cuts_into_equal_runs():
    """1x2160x3840 -> 4320 x 7680: 128 stripes x 4320 rows over 132 blocks,
    4189 or 4190 rows each, in at most two segments; the wide convs execute
    1.0696x their useful work (64 of 60 columns, each segment's fill)."""
    p = tail.tail_wgmma_plan(1, 2160, 3840, sms=132)
    assert p.grid == 132 and p.rows == 552960
    segs = [list(p.segments(blk)) for blk in range(p.grid)]
    assert max(len(s) for s in segs) == 2
    assert {sum(y1 - y0 for _, _, y0, y1 in s) for s in segs} == {4189, 4190}
    useful = 2 * 2 * 4320 * 7680 * 9 * NF * NF
    assert 1.069 < p.executed_ops() / useful < 1.071
    # conv_last, three rows behind upconv2, reaches the segment's last row
    assert p.steps(1) == 2 and p.steps(4189) == 1398


@pytest.mark.parametrize("variant", [dict(step_rows=2), dict(step_rows=2, slots=4),
                                     dict(step_rows=1), dict(slots=4)])
def test_the_probe_variants_fit(variant):
    """The builds of ``tools/probe_k6.py --route wgmma`` (rows2, rows2_s4,
    rows1, s4) are plans the launcher takes, within the card's shared
    memory."""
    g = _geometry(**variant)
    p = tail.tail_wgmma_plan(1, 2160, 3840, g)
    assert p.step_rows == g["step_rows"] and p.smem <= tail.SMEM_MAX
    assert p.threads == 128 * g["step_rows"] + 128


def test_the_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="empty shape"):
        tail.tail_wgmma_plan(1, 0, 8)
    with pytest.raises(ValueError, match="2\\^30"):
        tail.tail_wgmma_plan(1, 1, (1 << 29) + 1)
    # a build whose rings are not its own
    with pytest.raises(ValueError, match="not its own"):
        tail.tail_wgmma_plan(1, 8, 8, dict(tail.TAIL_WGMMA, hr_rows=5))
    with pytest.raises(ValueError, match="not its own"):
        tail.tail_wgmma_plan(1, 8, 8, _geometry(stripe=62))  # u2's 64 pixels cover 60 + 4
    # a build whose shared memory is not what its geometry needs, or too much
    with pytest.raises(ValueError, match="shared memory"):
        tail.tail_wgmma_plan(1, 8, 8, dict(tail.TAIL_WGMMA, smem=tail.TAIL_WGMMA["smem"] + 16))
    with pytest.raises(ValueError, match="shared memory"):
        tail.tail_wgmma_plan(1, 8, 8, _geometry(slots=5))


# ---- the tail's schedule, emulated --------------------------------------------------


def emulate(x, tw, plan=None, short=None):
    """``tail_fused_wgmma.cu``'s schedule in plain PyTorch: x (B, H2, W2,
    64) in its dtype (bf16 as the kernel; fp32 to compare with the JAX
    package's fp32 tail), the six tail weights, block by block over the
    plan's segments, with the kernel's rings, their slots and their refills.
    upconv2 and conv_hr sum per 16 input channels in order, the nine taps in
    order; u2, hr and the output are rounded to x's dtype as they are
    stored. ``short``: "x", "u2" or "hr" holds that ring one row short."""
    dt = x.dtype
    b_, h2, w2, _ = x.shape
    p = plan or tail.tail_wgmma_plan(b_, h2, w2)
    r_, sw, xp = p.step_rows, p.stripe, p.ring_px
    dx = p.x_rows - (short == "x")
    du = p.u2_rows - (short == "u2")
    dh = p.hr_rows - (short == "hr")
    oh, ow = 2 * h2, 2 * w2
    w_up2, b_up2, w_hr, b_hr, w_last, b_last = [t.float() for t in tw]
    out = torch.full((b_, oh, ow, 3), float("nan"))
    xf = x.float()

    def coarse(n, c, cx):  # a coarse pixel row, zero outside the frame
        if not 0 <= c < h2:
            return torch.zeros(len(cx), NF)
        ok = (cx >= 0) & (cx < w2)
        return torch.where(ok[:, None], xf[n, c, cx.clamp(0, w2 - 1)], torch.zeros(()))

    for blk in range(p.grid):
        # the rings as shared memory lays them out: x (dx rows of two planes
        # of xp fine pixels), u2 (du rows of two planes of 64 pixels, a read
        # past a row's end landing in the next plane or row; after the last
        # row, the hr ring, here NaN: no needed output may read it), hr (dh
        # rows of the 62 pixels conv_last reads)
        xr = torch.zeros(dx * 2 * xp, 32)
        u2 = torch.cat([torch.zeros(du * 2 * 64, 32), torch.full((2, 32), float("nan"))])
        hr = torch.zeros(dh, sw + 2, NF)
        for n, X, y0, y1 in p.segments(blk):
            f = torch.arange(sw + 6)
            cx = X // 2 - 2 + (f + 1) // 2

            def load(c0, c1, n=n, cx=cx):  # coarse rows [c0, c1] at fine width
                for c in range(c0, c1 + 1):
                    row = coarse(n, c, cx)
                    for plane in range(2):
                        at = ((c % dx) * 2 + plane) * xp
                        xr[at:at + sw + 6] = row[:, 32 * plane:32 * plane + 32]

            steps = p.steps(y1 - y0)
            u = y0 - 2
            hi = (u + r_) >> 1
            load((u - 1) >> 1, hi)
            for t in range(steps):
                if t + 1 < steps and (u + 2 * r_) >> 1 > hi:
                    load(hi + 1, (u + 2 * r_) >> 1)
                    hi = (u + 2 * r_) >> 1
                # upconv2 at rows u .. u + R - 1, then conv_hr one row behind
                for conv, rows, ring_rows, src_rows in (
                        (0, [u + w for w in range(r_)], None, None),
                        (1, [u - 1 + w for w in range(r_)], None, None)):
                    wt, bias = (w_up2, b_up2) if conv == 0 else (w_hr, b_hr)
                    new = []
                    for row in rows:
                        acc = torch.zeros(64, NF)
                        for c in range(4):
                            plane, lo = c >> 1, (c & 1) * 16
                            for tap in range(9):
                                ky, kx = divmod(tap, 3)
                                if conv == 0:
                                    at = ((((row - 1 + ky) >> 1) % dx) * 2 + plane) * xp + kx
                                    a = xr[at:at + 64, lo:lo + 16]
                                else:
                                    at = (((row - 1 + ky) % du) * 2 + plane) * 64 + kx
                                    a = u2[at:at + 64, lo:lo + 16]
                                acc += a @ wt[ky, kx, 16 * c:16 * c + 16]
                        v = F.leaky_relu(acc + bias, 0.2)
                        fx = torch.arange(64) + X - 2 + conv
                        inside = (fx >= 0) & (fx < ow) & (0 <= row < oh)
                        new.append((row, torch.where(inside[:, None], v, torch.zeros(())).to(dt)))
                    for row, v in new:  # every row's MMAs before any store: the barrier
                        if conv == 0:
                            for plane in range(2):
                                at = ((row % du) * 2 + plane) * 64
                                u2[at:at + 64] = v[:, 32 * plane:32 * plane + 32].float()
                        else:
                            hr[row % dh] = v[:sw + 2].float()
                # conv_last two rows behind conv_hr: rows u - 3 .. u + R - 4
                for j in range(r_):
                    row = u - 3 + j
                    if not y0 <= row < y1:
                        continue
                    win = torch.stack([hr[(row - 1 + ky) % dh] for ky in range(3)])  # 3, sw+2, 64
                    acc = torch.zeros(sw, 3)
                    for ky in range(3):
                        for kx in range(3):
                            acc += win[ky, kx:kx + sw] @ w_last[ky, kx]
                    v = (acc + b_last).to(dt)
                    m = min(sw, ow - X)
                    out[n, row, X:X + m] = v[:m].float()
                u += r_
    assert not out.isnan().any()
    return out.to(dt)


def _tail_weights(rng, integer, dt=BF):
    def mk(*shape):
        if integer:
            return (rng.random(shape) < 1 / 48).astype(np.float32)
        return ((rng.random(shape) - 0.5) * 0.1).astype(np.float32)

    def bias(n):
        if integer:  # negative ones too: the leaky-relu branch
            return rng.integers(-3, 3, n).astype(np.float32)
        return ((rng.random(n) - 0.5) * 0.1 + 0.3).astype(np.float32)

    ws = [mk(3, 3, NF, NF), bias(NF), mk(3, 3, NF, NF), bias(NF), mk(3, 3, NF, 3), bias(3)]
    return [torch.from_numpy(a).to(dt) for a in ws]


def _integer_x(rng, shape):
    return torch.from_numpy(rng.integers(0, 3, shape + (NF,)).astype(np.float32)).to(BF)


@pytest.mark.parametrize(
    "shape,sms",
    [
        ((2, 3, 9), 4),     # B = 2, 6 x 18: ragged, below one stripe, segments across images
        ((1, 5, 7), 1),     # 10 x 14: narrower than one stripe, one block
        ((1, 2, 31), 3),    # 4 x 62: a last stripe of 2 columns
        ((1, 6, 61), 2),    # 12 x 122: three stripes, the last of 2
        ((2, 4, 40), 5),    # 8 x 80: more stripes' segments than blocks take whole
    ],
)
def test_the_schedule_equals_plain_on_exact_data(shape, sms):
    """Integer data (x in 0..2, weights 0 or 1, biases -3..2, so the leaky
    branch runs): every fp32 sum of the chain is exact in any order and the
    rounding of each stored value the same, so only the schedule (rings,
    slots, lags, masks, stores) could differ."""
    rng = np.random.default_rng(sum(shape))
    tw = _tail_weights(rng, integer=True)
    x = _integer_x(rng, shape)
    plan = tail.tail_wgmma_plan(*shape, sms=sms)
    want = tail.tail_fused_plain(x, *tw)
    assert torch.equal(emulate(x, tw, plan), want)


def test_many_blocks_and_stripes():
    """More stripes than blocks, several segments a block, across stripes
    and images: 3 x 14 x 400 (7 stripes, 294 rows) over 10 blocks of at
    least 32 rows."""
    rng = np.random.default_rng(11)
    tw = _tail_weights(rng, integer=True)
    x = _integer_x(rng, (3, 7, 200))
    plan = tail.tail_wgmma_plan(3, 7, 200, sms=16)
    assert plan.stripes == 7 and plan.grid == 10
    assert max(len(list(plan.segments(b))) for b in range(plan.grid)) >= 2
    assert torch.equal(emulate(x, tw, plan), tail.tail_fused_plain(x, *tw))


@pytest.mark.parametrize("ring", ["x", "u2", "hr"])
def test_a_ring_one_row_short_fails(ring):
    """The rings' depths are needed: each one row short, the emulation no
    longer equals the plain version on the same exact data."""
    rng = np.random.default_rng(3)
    tw = _tail_weights(rng, integer=True)
    x = _integer_x(rng, (1, 9, 20))
    plan = tail.tail_wgmma_plan(1, 9, 20, sms=1)
    want = tail.tail_fused_plain(x, *tw)
    assert torch.equal(emulate(x, tw, plan), want)
    assert not torch.equal(emulate(x, tw, plan, short=ring), want)


@pytest.mark.parametrize("variant", [dict(step_rows=2), dict(step_rows=1), dict(slots=4)])
def test_the_probe_geometries_schedule_equals_plain(variant):
    """The probe's other builds, emulated at a shape with several blocks and
    a ragged last stripe, on exact data."""
    rng = np.random.default_rng(5)
    tw = _tail_weights(rng, integer=True)
    x = _integer_x(rng, (1, 24, 35))
    plan = tail.tail_wgmma_plan(1, 24, 35, _geometry(**variant), sms=3)
    assert plan.grid == 3 and plan.stripes == 2
    assert torch.equal(emulate(x, tw, plan), tail.tail_fused_plain(x, *tw))


@pytest.mark.parametrize("shape", [(1, 6, 10), (2, 4, 7)])
def test_the_schedule_matches_jax_tail_fused(shape):
    """fp32: the emulation within rtol = atol = 2e-4 of the JAX
    ``tail_fused`` (``pallas_tail.py:425``) in interpret mode (fp32 sums in
    another order over three convs, ``tests/test_torch_tailq.py``'s bound)."""
    import jax.numpy as jnp

    from video_restore_tpu.ops.pallas_tail import tail_fused as jax_tail_fused

    rng = np.random.default_rng(9)
    tw = _tail_weights(rng, integer=False, dt=F32)
    x = torch.from_numpy(rng.random(shape + (NF,)).astype(np.float32))
    got = emulate(x, tw, tail.tail_wgmma_plan(*shape, sms=2)).numpy()
    ref = np.asarray(jax_tail_fused(jnp.asarray(x.numpy()),
                                    *(jnp.asarray(t.numpy()) for t in tw),
                                    block_h=4, interpret=True))
    assert got.shape == ref.shape == (shape[0], 2 * shape[1], 2 * shape[2], 3)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, tail.tail_fused_plain(x, *tw).numpy(), rtol=2e-4, atol=2e-4)


# ---- up1 on K1's wgmma route: the nearest-2x producer, emulated --------------------


def emulate_up2(x, w, b, tile=tail.WGMMA_TILE, kc=tail.WGMMA_KC):
    """``conv3x3_wgmma.cu``'s ``up2`` instance in plain PyTorch: per output
    tile of ``tile`` (rows, 64 pixels) and per stage of ``kc`` input
    channels, the producer's window of (rows + 2) x 66 fine pixels, each
    read from coarse pixel (y >> 1, x >> 1), zero outside the 2x frame and
    past cin; then the consumers' sums per 16 channels, the nine taps in
    order, and K1's epilogue (bias, lrelu, rounding) with partial tiles
    masked."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    th, tw_ = tile
    oh, ow = 2 * h, 2 * wd
    xf, wf, bf = x.float(), w.float(), b.float()
    out = torch.full((bsz, oh, ow, cout), float("nan"))
    nk = -(-cin // kc)
    for n in range(bsz):
        for oy0 in range(0, oh, th):
            for ox0 in range(0, ow, tw_):
                acc = torch.zeros(th, tw_, cout)
                for k in range(nk):
                    fy = torch.arange(th + 2) + oy0 - 1
                    fx = torch.arange(tw_ + 2) + ox0 - 1
                    win = torch.zeros(th + 2, tw_ + 2, kc)
                    ok = ((fy >= 0) & (fy < oh))[:, None] & ((fx >= 0) & (fx < ow))[None, :]
                    cy, cxs = (fy.clamp(0, oh - 1) >> 1), (fx.clamp(0, ow - 1) >> 1)
                    c1 = min(cin, (k + 1) * kc)
                    src = xf[n][cy][:, cxs, k * kc:c1]
                    win[..., :c1 - k * kc] = torch.where(ok[..., None], src, torch.zeros(()))
                    for j in range(kc // 16):
                        lo = k * kc + 16 * j
                        if lo >= cin:
                            continue  # the window's zero fill past cin: nothing to add
                        for tap in range(9):
                            ky, kx = divmod(tap, 3)
                            a = win[ky:ky + th, kx:kx + tw_, 16 * j:16 * j + 16]
                            acc += a @ wf[ky, kx, lo:lo + 16]
                v = F.leaky_relu(acc + bf, 0.2).to(x.dtype).float()
                ry, rx = min(th, oh - oy0), min(tw_, ow - ox0)
                out[n, oy0:oy0 + ry, ox0:ox0 + rx] = v[:ry, :rx]
    assert not out.isnan().any()
    return out.to(x.dtype)


@pytest.mark.parametrize(
    "shape,cin,cout",
    [
        ((2, 5, 33), 64, 64),   # up1's widths, B = 2, a ragged tile column
        ((1, 3, 7), 64, 32),    # below one tile
        ((1, 4, 40), 48, 32),   # the last stage half past cin (zero fill)
        ((1, 2, 9), 192, 64),   # six stages: the weights stream
    ],
)
def test_up1_window_equals_plain_on_exact_data(shape, cin, cout):
    rng = np.random.default_rng(cin + cout)
    x = torch.from_numpy(rng.integers(0, 3, shape + (cin,)).astype(np.float32)).to(BF)
    w = torch.from_numpy((rng.random((3, 3, cin, cout)) < 1 / 32).astype(np.float32)).to(BF)
    b = torch.from_numpy(rng.integers(-3, 3, cout).astype(np.float32)).to(BF)
    want = tail.conv3x3_plain(x, w, b, act="lrelu", upsample2=True)
    assert torch.equal(emulate_up2(x, w, b), want)
    # the plan of such a call: tiles over the 2x output, x's coarse map
    plan = tail.wgmma_plan(x.shape, cin, cout, sms=132, upsample2=True)
    b_, h, wd = shape
    assert plan.tiles == b_ * -(-2 * h // 4) * -(-2 * wd // 64)
    assert plan.a_dims == (cin, wd, h, b_) and plan.tail == 0
