"""The fp32 conv_last on K1's narrow route (``csrc/conv3x3_narrow.cu``,
``last32``), on a machine without a card.

The kernel computes SAME 3x3, 64 -> 3, plus bias, fp32 in and out: the
conv_last stage of ``pallas_tail.py:266 tail_fused_raw`` (and of ``:425
tail_fused``, and the ``conv3x3_fused`` form, ``:767``). Persistent blocks
walk 32 x 32 output tiles; per tile one thread of a producer warp copies the
34-row patch by TMA in four stages of 16 channels (64 bytes a pixel, a box
35 pixels wide in the 64-byte swizzle, two slots), and four consumer warps
sum it, a thread 1 row x 8 pixels x the 3 couts, each value one fp32
accumulator over ci, then ky, then kx (``conv3x3.cu``'s order). What is held
here:

- ``ops/tail.py::last32_plan`` and :data:`tail.LAST32` against the shipped
  source's constants: the tile, the stages, the box, the shared memory of
  one block within 232,448 bytes (a third slot does not fit), the plan the
  C launcher reads, and its refusals;
- the window reads of every quarter warp, through the swizzle as the kernel
  addresses them, fall on eight different 16-byte bank groups;
- a CPU emulation of the kernel (each block's tiles in its order, each
  stage's box as TMA fills it through the plan's map, with zero fill
  outside the frame and at strided and prefix-view x, into its slot in the
  swizzled layout; each thread's window read back at the kernel's
  addresses; each output written once) agrees with ``conv3x3_plain``'s
  arithmetic within 1e-6 in float64 (and with the fp32 ``conv3x3_plain``
  within 4e-6), with its FMAs rounded to fp32 equals ``conv3x3.cu``'s
  order over the whole frame bit for bit, and agrees with the JAX conv
  (``conv3x3_fused`` in interpret mode, and the plain ``conv2d``) at rtol =
  atol = 1e-4.

The kernel itself runs on the card only (``chip_smoke.py --only k1n``;
``python -m video_restore_tpu_torch.tools.probe_k1n``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.ops import _build, tail

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

NF = 64
G = tail.LAST32
_SRC = (_build.CSRC / "conv3x3_narrow.cu").read_text()
SRC = _SRC[_SRC.index("namespace last32 {"):_SRC.index("}  // namespace last32")]


def _const(name):
    return int(re.search(rf"\b{name} = (\d+)[;,]", SRC).group(1))


TH, TW, CS, BW = G["th"], G["tw"], G["cs"], G["bw"]
DEPTH = _const("DEPTH")  # stages held: the slots
PH = TH + 2
BOX = CS * 4 * BW * PH
SLOT = -(-BOX // 1024) * 1024
THREADS = 128  # the consumers: 4 warps, a thread 1 row x 8 pixels
P = 8


def _swz64(a):
    """The 64-byte swizzle TMA writes: bits 4-5 of the address XOR bits 7-8."""
    return a ^ ((a >> 3) & 0x30)


def _threads():
    """Each consumer thread's output row in the tile and first pixel."""
    tid = np.arange(THREADS)
    warp, lane = tid >> 5, tid & 31
    return warp * 8 + (lane & 7), (lane >> 3) * P


def _window_at():
    """(THREADS, 3, 8) offsets of the thread's window pieces at slot 0,
    chunk 0, as the kernel computes them."""
    orow, col0 = _threads()
    ky, j = np.arange(3), np.arange(8)
    p = (orow[:, None, None] + ky[None, :, None]) * BW + col0[:, None, None] + j[None, None, :]
    return _swz64(p * 64)


# ---- the geometry ---------------------------------------------------------------


def test_the_python_geometry_is_the_shipped_builds():
    assert (TH, TW, CS) == (_const("TH"), _const("TW"), _const("CS"))
    assert BW == TW + int(re.search(r"BW = TW \+ (\d+);", SRC).group(1))
    assert THREADS == _const("kConsumers")
    assert tail._LAST32_PLAN_LEN == 4 + 3 + 4 + 1 + 2 == len(
        tail.last32_plan((1, 4, 5, NF), NF, sms=1).array())
    # four warps of 8 rows, four x-groups of 8 pixels: the tile
    assert (TH, TW) == (4 * 8, 4 * P)


def _smem(depth):
    """A block's dynamic shared memory as conv3x3_narrow.cu lays it out:
    1024 bytes of alignment, the slots (each on 1024 bytes), the weights (28
    floats a channel: 9 taps x 3 couts and a pad), bias and alpha (two
    float4s), a full and an empty barrier a slot."""
    return 1024 + depth * SLOT + NF * 28 * 4 + 2 * 16 + 2 * depth * 8


def test_one_block_fits_and_a_third_slot_does_not():
    assert SLOT % 1024 == 0 and BOX == 76160
    assert _smem(DEPTH) == 161856 <= tail.SMEM_MAX  # one block an SM
    assert _smem(DEPTH + 1) > tail.SMEM_MAX


def test_the_box_is_the_swizzle_span_with_an_odd_pitch():
    """16 fp32 channels, 64 bytes: the 64-byte swizzle's span (TMA takes no
    wider inner box in it); the tile's 34 pixels and one more, an odd row
    pitch; within TMA's 256 elements a dimension."""
    assert CS * 4 == 64 and NF % CS == 0
    assert BW >= TW + 2 and BW % 2 == 1 and max(CS, BW, PH) <= 256


@pytest.mark.parametrize("slot", range(DEPTH))
def test_the_window_reads_are_free_of_bank_conflicts(slot):
    """A 16-byte read of a warp is served a quarter warp at a time: the
    eight lanes of each quarter (eight consecutive rows, one x-group) must
    fall on eight different 16-byte bank groups, for every piece of the
    window, every chunk and either slot."""
    at = _window_at()
    for g in range(CS // 4):
        for ky in range(3):
            for j in range(P + 2):
                ad = ((at[:, ky, j & 7] + slot * SLOT) ^ (g << 4)) + (j >> 3) * 512
                groups = (ad >> 4) & 7
                for q in range(THREADS // 8):
                    assert len(set(groups[8 * q:8 * q + 8].tolist())) == 8, (g, ky, j, q)


def test_the_plan_of_a_prefix_view():
    """A 64-channel prefix of a 72-channel buffer: the map's dims are the
    view's, its strides the buffer's pixel stride (288 bytes)."""
    plan = tail.last32_plan((2, 37, 53, NF), 72, sms=132)
    assert plan.a_dims == (NF, 53, 37, 2)
    assert plan.a_strides == (288, 53 * 288, 37 * 53 * 288)
    assert plan.a_box == (CS, BW, PH, 1)
    assert plan.tiles == 2 * 2 * 2 and plan.grid == 8 and plan.tile == (TH, TW)
    assert len(plan.array()) == tail._LAST32_PLAN_LEN
    big = tail.last32_plan((1, 4320, 7680, NF), NF, sms=132)
    assert big.tiles == 135 * 240 and big.grid == 132
    x = torch.zeros(2, 37, 53, 72)[..., :NF]
    assert tail.last32_call_plan(x, sms=132) == plan


@pytest.mark.parametrize(
    "shape,xs,match",
    [((1, 4, 5, NF), 66, "multiple of 4"), ((1, 4, 5, 48), 48, "cin 48"),
     ((1, 0, 5, NF), NF, "empty"), ((1, 4, 5, NF), 60, "pixel stride 60 < cin")],
)
def test_the_plan_refuses(shape, xs, match):
    with pytest.raises(ValueError, match=match):
        tail.last32_plan(shape, xs, sms=132)


# ---- the emulation ---------------------------------------------------------------


def _box(flat, offset, plan, c0, x0, y0, n):
    """The (PH, BW, CS) box TMA copies from (c0, x0, y0, n) through the
    plan's map over the flat storage, zero outside the map's dims."""
    dims = plan.a_dims
    es = [s // 4 for s in plan.a_strides]
    c = c0 + np.arange(CS)
    xx = x0 + np.arange(BW)
    yy = y0 + np.arange(PH)
    inside = ((c < dims[0])[None, None, :] & ((xx >= 0) & (xx < dims[1]))[None, :, None]
              & ((yy >= 0) & (yy < dims[2]))[:, None, None]) & (0 <= n < dims[3])
    idx = (offset + n * es[2] + yy[:, None, None] * es[1] + xx[None, :, None] * es[0]
           + c[None, None, :])
    return np.where(inside, flat[np.clip(idx, 0, flat.size - 1)], 0.0)


def _fill(sm, slot, box):
    """TMA's write of a box into a slot: pixel (row, px) 64 bytes at (row *
    BW + px) * 64, its 16-byte chunks in the 64-byte swizzle."""
    row, px, c = np.meshgrid(np.arange(PH), np.arange(BW), np.arange(CS), indexing="ij")
    byte = _swz64((row * BW + px) * 64 + (c >> 2) * 16) + (c & 3) * 4
    sm[(slot * SLOT + byte) // 4] = box


def run(x, w, b, sms, fp32=False):
    """:func:`emulate` of a tensor x (contiguous or a channel view of a
    wider NHWC buffer) on its plan for ``sms`` SMs."""
    base = x if x._base is None else x._base
    flat = base.detach().reshape(-1).double().numpy()
    plan = tail.last32_call_plan(x, sms=sms)
    return emulate(flat, x.storage_offset(), plan, x.shape, w.double().numpy(),
                   b.double().numpy(), fp32)


def emulate(flat, offset, plan, shape, w, b, fp32):
    """The kernel on the CPU: x (B, H, W, 64) at ``offset`` of the flat
    storage ``flat`` (float64) through the plan's map; w (3, 3, 64, 3), b
    (3,). Returns the output and how often each output value was written.
    With ``fp32`` each FMA and the bias add are rounded to fp32, as the card
    rounds them."""
    bsz, h, wd, _ = shape
    rnd = (lambda v: v.astype(np.float32).astype(np.float64)) if fp32 else (lambda v: v)
    tiles_x, tiles_y = -(-wd // TW), -(-h // TH)
    out = np.zeros((bsz, h, wd, 3))
    count = np.zeros((bsz, h, wd), np.int64)
    orow, col0 = _threads()
    at = _window_at()
    for blk in range(plan.grid):
        sm = np.zeros((DEPTH * SLOT) // 4)
        s = 0
        for tile in range(blk, plan.tiles, plan.grid):
            n, r = divmod(tile, tiles_x * tiles_y)
            ty, tx = divmod(r, tiles_x)
            oy0, ox0 = ty * TH, tx * TW
            acc = np.zeros((THREADS, P, 3))
            for k in range(NF // CS):
                _fill(sm, s, _box(flat, offset, plan, k * CS, ox0 - 1, oy0 - 1, n))
                for g in range(CS // 4):
                    win = np.empty((THREADS, 3, P + 2, 4))
                    for ky in range(3):
                        for j in range(P + 2):
                            ad = ((at[:, ky, j & 7] + s * SLOT) ^ (g << 4)) + (j >> 3) * 512
                            win[:, ky, j] = sm[(ad // 4)[:, None] + np.arange(4)]
                    for cl in range(4):
                        ci = k * CS + 4 * g + cl
                        for ky in range(3):
                            for kx in range(3):
                                xv = win[:, ky, kx:kx + P, cl][:, :, None]
                                acc = rnd(acc + xv * w[ky, kx, ci][None, None, :])
                s = (s + 1) % DEPTH
            v = rnd(acc + b[None, None, :])
            oy = oy0 + orow[:, None] + np.zeros((1, P), np.int64)
            ox = ox0 + col0[:, None] + np.arange(P)[None, :]
            keep = (oy < h) & (ox < wd)
            out[n, oy[keep], ox[keep]] = v[keep]
            np.add.at(count, (n, oy[keep], ox[keep]), 1)
    return out, count


def conv3x3_order(x, w, b):
    """``conv3x3.cu``'s sums over a whole frame with each FMA rounded to
    fp32: per output, one accumulator from 0 over ci, then ky, then kx
    (zeros outside the frame), then the bias."""
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    bsz, h, wd, cin = x.shape
    acc = np.zeros((bsz, h, wd, 3))
    for ci in range(cin):
        for ky in range(3):
            for kx in range(3):
                acc = (acc + xp[:, ky:ky + h, kx:kx + wd, ci, None] * w[ky, kx, ci]).astype(
                    np.float32).astype(np.float64)
    return (acc + b).astype(np.float32).astype(np.float64)


def _inputs(seed, shape, c_buf=NF, lo=0):
    """x (a (B, H, W, 64) view at channel ``lo`` of a c_buf-channel buffer),
    w, b: fp32 values from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.uniform(-1, 1, (*shape, c_buf)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-0.05, 0.05, (3, 3, NF, 3)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-0.1, 0.1, 3).astype(np.float32))
    return buf[..., lo:lo + NF], w, b


CASES = {
    "B 2 below one tile": dict(shape=(2, 5, 7), sms=2),
    "two tile rows and columns": dict(shape=(1, 34, 40), sms=3),
    "x a prefix of 72": dict(shape=(1, 9, 33), c_buf=72, sms=1),
    "x a slice of stride 68": dict(shape=(2, 6, 35), c_buf=68, lo=4, sms=2),
    "six tile rows, one column": dict(shape=(1, 165, 8), sms=4),
}


@pytest.mark.parametrize("case", CASES)
def test_each_output_is_written_once_and_matches_plain(case):
    kw = dict(CASES[case])
    sms = kw.pop("sms")
    x, w, b = _inputs(1, **kw)
    got, count = run(x, w, b, sms)
    assert (count == 1).all()
    # conv3x3_plain's arithmetic (its conv, then the bias) in float64, and
    # conv3x3_plain itself, whose fp32 sums (oneDNN's on the CPU) lie up to
    # ~1.2e-6 from the exact ones at these inputs
    ref64 = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1), padding=1,
    ).permute(0, 2, 3, 1) + b.double()
    np.testing.assert_allclose(got, ref64.numpy(), rtol=0, atol=1e-6)
    ref = tail.conv3x3_plain(x, w, b).double().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=4e-6)


@pytest.mark.parametrize("case", ["B 2 below one tile", "x a slice of stride 68"])
def test_its_fp32_sums_are_conv3x3_cu_bit_for_bit(case):
    """With each FMA rounded to fp32 the tile walk, the stages and the
    window addresses give ``conv3x3.cu``'s order over the whole frame
    exactly: the kernel's outputs equal the forced ``fma`` route's."""
    kw = dict(CASES[case])
    sms = kw.pop("sms")
    x, w, b = _inputs(2, **kw)
    got, _ = run(x, w, b, sms, fp32=True)
    ref = conv3x3_order(x.double().numpy(), w.double().numpy(), b.double().numpy())
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("case", ["B 2 below one tile", "x a prefix of 72"])
def test_it_matches_the_jax_conv(case):
    """Against the JAX package's conv_last: ``conv3x3_fused`` (the
    ``pallas_tail.py:767`` form) in interpret mode, and its plain
    ``conv2d``, fp32 on both sides with the same numpy inputs."""
    from video_restore_tpu.ops.conv import conv2d as jax_conv2d
    from video_restore_tpu.ops.pallas_tail import conv3x3_fused as jax_fused

    kw = dict(CASES[case])
    sms = kw.pop("sms")
    x, w, b = _inputs(3, **kw)
    got, _ = run(x, w, b, sms)
    xn = np.ascontiguousarray(x.numpy())
    for ref in (jax_fused(jnp.asarray(xn), jnp.asarray(w.numpy()), jnp.asarray(b.numpy()), None,
                          None, act="none", block_h=4, interpret=True),
                jax_conv2d(jnp.asarray(xn), jnp.asarray(w.numpy()), jnp.asarray(b.numpy()))):
        np.testing.assert_allclose(got, np.asarray(ref, np.float64), rtol=1e-4, atol=1e-4)
