"""K4's ``"wgmma"`` route on a machine without a card: its launch plan, and a
CPU emulation of its schedule.

``csrc/conv3x3_i8_wgmma.cu`` reads each stage's bf16 window (32 channels
of a (TH + 2) x (TW + 2) window) with TMA into a ring of raw slots; a
producer warpgroup quantises it into a ring of int8 slots (one pixel a
32-byte row in the 32-byte swizzle); two consumer warpgroups run int8
``wgmma`` m64nNk32 on it against the weights, resident in shared memory
(TMA, 32-byte swizzle), and fold each segment's s32 sums into fp32 sums at
the segment's last stage. The wrapper's plan (``ops/quant.py::
i8_wgmma_plan``) gives the maps' dims, strides and boxes, the grid, the ring
depths, the shared memory and the stage schedule; the C launcher only checks
it and encodes it.

Held here: the plan against the source's compile-time defaults, for each
RDB conv (x and c1 .. c4 in K1's blocks, or a growth-buffer prefix) and the
SRVGG conv, and the calls it refuses. Then :func:`emulate`, the kernel's
schedule in numpy: TMA boxes read through the plan's dims and byte strides
(zero fill outside), one flat shared memory laid out as the kernel lays it
out, the raw ring filled ``raw_depth`` steps ahead, the producer as far
ahead of the consumers as the int8 ring lets it, the quantiser's bf16
chain, the ``wgmma`` operands read through their descriptors (8-row groups
``sbo`` bytes apart, the 32-byte swizzle on the address), the fold at the
plan's fold points, the epilogue and the per-image output amax. At nf 64 /
gc 32 with B = 2 (different scales per image) and partial tiles, it equals
``conv3x3_i8_plain`` bit for bit for every instance the paths launch (the
five RDB convs, dynamic and static, and the SRVGG conv), and the blocked
int8 RDB through it equals ``rdb_fused_i8_plain`` and the JAX kernel
(``rdb_stripe_padded`` / ``rdb_res_stripe_padded``, one stripe, interpret
mode) bit for bit; a descriptor stride or a ring one step short breaks it.
The kernel itself runs on the card only (``chip_smoke.py --only k4``;
``python -m video_restore_tpu_torch.tools.probe_k4 --route wgmma``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_restore_tpu_torch.ops import _build, quant, stripe

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

BF = torch.bfloat16
NF, GC = 64, 32
G = quant.I8_WGMMA
SRC = (_build.CSRC / "conv3x3_i8_wgmma.cu").read_text()


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


def _constexpr(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_the_python_plan_matches_the_shipped_build():
    """:data:`quant.I8_WGMMA` is the source's own geometry, and the plan has
    the length the launcher reads."""
    nc = _constexpr("NC")
    assert G["rows"] == {32: nc * _define("VR_I8_ROWS32"), 64: nc * _define("VR_I8_ROWS64")}
    assert G["rows"] == {32: 8, 64: 4}
    tw, kc = _constexpr("TW"), _constexpr("KC")
    assert (G["tw"], G["kc"]) == (tw, kc) == (64, 32)
    assert G["q_depth"] == _define("VR_I8_QSTAGES")
    assert G["raw_max"] == _define("VR_I8_RAW_MAX")
    for cout, th in G["rows"].items():
        assert quant.i8_wgmma_window(cout) == ((th + 2) * (tw + 2) * kc * 2,
                                               -(-(th + 2) * (tw + 2) * kc // 1024) * 1024)
    assert G["param_bytes"] == _constexpr("PARAM_BYTES")
    assert G["smem_max"] == _constexpr("SMEM_MAX") == quant.I8_WGMMA["smem_max"]
    plan = quant.i8_wgmma_plan((1, 8, 8, 64), 64, (0, 64), 64, sms=132)
    assert len(plan.array()) == _constexpr("PLAN_LEN") == 40


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_the_plan_of_each_blocked_rdb_conv(k):
    """conv k at 1080p reads x (64 channels) and k - 1 blocks of the
    (4, 1, 1080, 1920, 32) tail: two x stages, then one a block; the
    weights stay resident and the raw ring takes what is left. Tiles of 8
    rows at cout 32, of 4 at cout 64."""
    segs = quant.rdb_segments(NF, GC, k)
    cout = GC if k < 5 else NF
    th = 8 if k < 5 else 4
    p = quant.i8_wgmma_plan((1, 1080, 1920, NF), NF, segs, cout, sms=132, tail=k - 1)
    assert p.a_dims == (64, 1920, 1080, 1)
    assert p.a_strides == (128, 1920 * 128, 1080 * 1920 * 128)
    assert p.a_box == (32, 66, th + 2, 1)  # 32 channels of a (th + 2) x 66 window
    assert p.tail == k - 1
    if k > 1:
        assert p.t_strides == (64, 1920 * 64, 1080 * 1920 * 64, 1080 * 1920 * 64)
        assert p.t_box == (32, 66, th + 2, 1, 1)
    cin = NF + (k - 1) * GC
    assert p.w_dims == (cin, cout, 9) and p.w_strides == (cin, cout * cin)
    assert p.w_box == (32, cout, 9) and p.w_swizzle == 32
    assert p.tiles == -(-1080 // th) * 30 and p.grid == 132 and p.tile == (th, 64)
    assert p.stage_seg == (0, 0) + tuple(range(1, k))
    assert p.starts == (0,) + tuple(range(2, k + 1)) and p.folds == tuple(range(1, k + 1))
    assert p.q_depth == 3 and p.raw_depth == (3, 3, 3, 2, 3)[k - 1]
    assert p.smem == quant.i8_wgmma_smem(cin // 32, cout, p.raw_depth) <= G["smem_max"]
    raw, _ = quant.i8_wgmma_window(cout)
    assert p.smem + raw + 8 > G["smem_max"] or p.raw_depth == G["raw_max"]


def test_the_plan_of_a_growth_buffer_prefix_and_the_srvgg_conv():
    """Forced comparisons read a prefix of the 192-channel growth buffer
    (every stage from x, its pixel 384 bytes); the SRVGG conv is one
    segment of two stages."""
    p = quant.i8_wgmma_plan((2, 9, 70, 128), 192, quant.rdb_segments(NF, GC, 3), GC, sms=132)
    assert p.a_dims == (128, 70, 9, 2) and p.a_strides == (384, 70 * 384, 9 * 70 * 384)
    assert p.tail == 0 and p.t_strides == (0,) * 4 and p.t_box == (0,) * 5
    assert p.tiles == 2 * 2 * 2 and p.grid == 8 and p.tile == (8, 64)
    v = quant.i8_wgmma_plan((1, 1080, 1920, NF), NF, (0, NF), NF, sms=132)
    assert v.stage_seg == (0, 0) and v.starts == (0,) and v.folds == (1,)
    assert v.raw_depth == 6 and v.smem <= G["smem_max"]
    vals = list(v.array())
    assert vals[11:21] == [0] * 10 and vals[30:] == [132, 4, 64, 6, 3, v.smem, 2, 0, 1, 2]


@pytest.mark.parametrize(
    "shape,xs,segs,cout,tail,match",
    [
        ((1, 4, 5, 64), 68, (0, 64), 64, 0, "pixel stride 68"),
        ((1, 4, 5, 64), 56, (0, 64), 64, 0, "pixel stride 56"),
        ((1, 4, 5, 80), 80, (0, 64, 80), 32, 0, "segments"),
        ((1, 4, 5, 64), 64, (0, 64, 224), 32, 5, "cin 224"),
        ((1, 4, 5, 64), 64, (0, 64), 48, 0, "cout 48"),
        ((1, 0, 5, 64), 64, (0, 64), 64, 0, "empty shape"),
    ],
)
def test_calls_the_route_does_not_take_are_refused(shape, xs, segs, cout, tail, match):
    with pytest.raises(ValueError, match=match):
        quant.i8_wgmma_plan(shape, xs, segs, cout, sms=132, tail=tail)


# ---- the schedule, emulated -------------------------------------------------------


def _sw32(a):
    """The 32-byte swizzle of byte addresses: bit 4 ^= bit 7."""
    return a ^ ((a >> 3) & 0x10)


def _bytes_of(t):
    """(all bytes of t's storage as uint8, byte offset of t's first element)."""
    buf = torch.empty(0, dtype=torch.uint8).set_(t.untyped_storage())
    return buf.numpy(), t.storage_offset() * t.element_size()


def _tma_box(buf, base, esize, dims, strides, box, coords):
    """A TMA tile load: the box at ``coords`` of the map (dims, byte strides
    of dims 1..), as the bytes it lands as (innermost dimension first),
    zero-filled where an element lies outside the dims."""
    rank = len(box)
    off = np.zeros(box[::-1], np.int64)
    ok = np.ones(box[::-1], bool)
    for d in range(rank):
        shape = [1] * rank
        shape[rank - 1 - d] = box[d]
        i = (np.arange(box[d]) + coords[d]).reshape(shape)
        off = off + i * (esize if d == 0 else strides[d - 1])
        ok = ok & (i >= 0) & (i < dims[d])
    addr = off[..., None] + base + np.arange(esize)
    vals = np.where(ok[..., None], buf[np.clip(addr, 0, len(buf) - 1)], 0)
    return vals.reshape(-1).astype(np.uint8)


def _operand(smem, start, rows, sbo):
    """A K-major ``wgmma`` operand in the 32-byte swizzle through its
    descriptor: ``rows`` rows of 32 int8, 8-row groups ``sbo`` bytes apart."""
    r = np.arange(rows)[:, None]
    addr = start + (r // 8) * sbo + (r % 8) * 32 + np.arange(32)[None, :]
    return smem[_sw32(addr)].view(np.int8).astype(np.int32)


def _f32_fma(a, b, c):
    """a * b + c with one fp32 rounding (the product is exact in float64),
    as the plain version's ``_fma``."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF).float().numpy()


def emulate(x, segs, amax, wq, sw, b, *, act="none", alpha=None, out=None, out_amax=None,
            r1=None, s1=1.0, r2=None, s2=1.0, sas=None, x_tail=None, sms=3,
            raw_slots=None, q_slots=None, a_sbo=256, b_sbo=256):
    """``conv3x3_i8_wgmma.cu``'s schedule in numpy, with ``conv3x3_i8``'s
    arguments (CPU tensors; ``out`` written in place when given). ``sms``
    sizes the persistent grid (a few blocks, so each walks several tiles
    through its rings). ``raw_slots`` / ``q_slots``: the rings' slots in
    shared memory where the kernel's lookahead assumes the plan's depths;
    ``a_sbo`` / ``b_sbo``: the descriptors' 8-row group strides (a faulty
    kernel's, for the tests that must see it break)."""
    bsz, h, w, cx = x.shape
    nblk = 0 if x_tail is None else x_tail.shape[0]
    cout = wq.shape[-1]
    plan = quant.i8_wgmma_plan(x.shape, x.stride(2), segs, cout, sms=sms, tail=nblk)
    th, tw = plan.tile
    kc = G["kc"]
    ph, pw = th + 2, tw + 2
    nk = len(plan.stage_seg)
    dr, qd = plan.raw_depth, plan.q_depth
    raw_n, q_n = raw_slots or dr, q_slots or qd
    tap_bytes = cout * kc
    stage_w = 9 * tap_bytes
    qring = nk * stage_w  # the kernel's layout, from its 1024-aligned base
    raw_b, q_b = quant.i8_wgmma_window(cout)
    raw = qring + q_n * q_b
    smem = np.zeros(raw + raw_n * raw_b, np.uint8)
    wp = quant.pack_i8_weights(wq)
    xbuf, xbase = _bytes_of(x)
    if nblk:
        tbuf, tbase = _bytes_of(x_tail)
    wbuf, wbase = _bytes_of(wp)
    static = sas is not None
    nseg = len(segs) - 1

    def scale(n, s):
        """(sa, bf16(1 / sa)) of segment s of image n, as the kernel takes them."""
        if static:
            return np.float32(sas[s]), np.float32(quant.static_act_inverse(float(sas[s]), BF))
        sa = np.float32(max(np.float32(amax[n, s]), np.float32(1e-12))) * np.float32(quant._INV127)
        return sa, np.float32(torch.tensor(np.float32(1.0) / sa).to(BF).float().item())

    y = np.zeros((bsz, h, w, cout), np.float32)
    m = np.zeros(bsz, np.float32)
    per_image = -(-h // th) * -(-w // tw)
    bias = b.float().numpy()
    al = None if alpha is None else alpha.float().numpy()
    r1n = None if r1 is None else r1.float().numpy()
    r2n = None if r2 is None else r2.float().numpy()
    for blk in range(plan.grid):
        tiles = list(range(blk, plan.tiles, plan.grid))
        steps = [(t, k) for t in tiles for k in range(nk)]
        # every weight, once: stage k's box of every tap and cout
        for k in range(nk):
            box = _tma_box(wbuf, wbase, 1, plan.w_dims, plan.w_strides, plan.w_box, (k * kc, 0, 0))
            smem[_sw32(k * stage_w + np.arange(box.size))] = box

        def load(i):  # TMA: step i's window into raw slot i % raw_n
            t, k = steps[i]
            n, rem = divmod(t, per_image)
            ty, tx = divmod(rem, -(-w // tw))
            at = raw + (i % raw_n) * raw_b
            if k < plan.a_dims[0] // kc:
                box = _tma_box(xbuf, xbase, 2, plan.a_dims, plan.a_strides, plan.a_box,
                               (k * kc, tx * tw - 1, ty * th - 1, n))
            else:
                box = _tma_box(tbuf, tbase, 2, (kc, w, h, bsz, nblk), plan.t_strides, plan.t_box,
                               (0, tx * tw - 1, ty * th - 1, n, k - plan.a_dims[0] // kc))
            smem[at:at + box.size] = box

        def quantise(i):  # the producer: raw slot i % raw_n -> int8 slot i % q_n
            t, k = steps[i]
            _, inv = scale(t // per_image, plan.stage_seg[k])
            at = raw + (i % raw_n) * raw_b
            v = torch.from_numpy(smem[at:at + raw_b].copy()).view(BF)
            q = quant._round_clip_i8(v * torch.tensor(float(inv), dtype=BF)).numpy()
            dst = qring + (i % q_n) * q_b
            smem[_sw32(dst + np.arange(q.size))] = q.view(np.uint8)
            if i + dr < len(steps):
                load(i + dr)

        for i in range(min(dr, len(steps))):
            load(i)
        done = 0  # steps the producer has quantised
        acc = np.zeros((th, tw, cout), np.int64)
        fsum = np.zeros((th, tw, cout), np.float32)
        for c, (t, k) in enumerate(steps):
            # the producer runs as far ahead as the int8 ring lets it
            while done < min(len(steps), c + qd):
                quantise(done)
                done += 1
            n, rem = divmod(t, per_image)
            ty, tx = divmod(rem, -(-w // tw))
            s = plan.stage_seg[k]
            st = qring + (c % q_n) * q_b
            for row in range(th):
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    a = _operand(smem, st + ((row + ky) * pw + kx) * kc, 64, a_sbo)
                    bm = _operand(smem, k * stage_w + tap * tap_bytes, cout, b_sbo)
                    prod = a @ bm.T
                    acc[row] = prod if (k in plan.starts and tap == 0) else acc[row] + prod
            if k in plan.folds and nseg > 1:
                sa, _ = scale(n, s)
                sc = (sa * sw[s].numpy()).astype(np.float32)
                v = acc.astype(np.float32)
                fsum = (v * sc).astype(np.float32) if s == 0 else _f32_fma(v, sc, fsum)
            if k != nk - 1:
                continue
            # the epilogue
            if nseg > 1:
                u = (fsum + bias).astype(np.float32)
            else:
                sa, _ = scale(n, 0)
                u = _f32_fma(acc.astype(np.float32), (sa * sw[0].numpy()).astype(np.float32),
                             np.broadcast_to(bias, acc.shape))
            oyc = np.minimum(ty * th + np.arange(th)[:, None], h - 1)  # rows and columns
            oxc = np.minimum(tx * tw + np.arange(tw)[None, :], w - 1)  # past the frame unstored
            if act == "lrelu":
                u = np.where(u >= 0, u, (np.float32(0.2) * u).astype(np.float32))
            elif act == "prelu":
                u = np.where(u > 0, u, (u * al).astype(np.float32))
            if r1n is not None:
                u = _f32_fma(u, np.float32(s1), r1n[n][oyc, oxc])
            if r2n is not None:
                u = _f32_fma(_bf16(u), np.float32(s2), r2n[n][oyc, oxc])
            u = _bf16(u)
            for r in range(min(th, h - ty * th)):
                nx = min(tw, w - tx * tw)
                y[n, ty * th + r, tx * tw:tx * tw + nx] = u[r, :nx]
                m[n] = max(m[n], np.abs(u[r, :nx]).max())
    got = torch.from_numpy(y).to(BF)
    if out is not None:
        out.copy_(got)
        got = out
    if out_amax is not None:
        out_amax.copy_(torch.from_numpy(m))
    return got


def _rdb8(rng):
    """One int8 RDB at nf 64 / gc 32 from bf16 weights: (wq, sw, bs)."""
    ws = [_bf16((rng.random((3, 3, NF + k * GC, GC if k < 4 else NF)) - 0.5) * 0.08)
          for k in range(5)]
    bs = [torch.from_numpy(_bf16((rng.random(GC if k < 4 else NF) - 0.5) * 0.1)).to(BF)
          for k in range(5)]
    qs = [quant.quantize_conv_weights(torch.from_numpy(ws[k]).to(BF), quant.rdb_segments(NF, GC, k + 1))
          for k in range(5)]
    return [q for q, _ in qs], [s for _, s in qs], bs, ws


def _frames(rng, shape, c):
    """bf16 frames whose images differ in scale (4x for the second)."""
    a = (rng.random(shape + (c,)) - 0.5) * 3
    a[1:] *= 4
    return torch.from_numpy(_bf16(a)).to(BF)


SAS = (0.0101, 0.0042, 0.0039, 0.0051, 0.0047)  # some values saturate
SHAPE = (2, 9, 70)  # B = 2, partial tiles both ways


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_each_blocked_rdb_conv_equals_plain(k, static):
    """conv k on x and k - 1 tail blocks, as the wgmma route's RDB runs it."""
    rng = np.random.default_rng(10 * k + static)
    wq, sw, bs, _ = _rdb8(rng)
    x = _frames(rng, SHAPE, NF)
    tail = torch.stack([_frames(rng, SHAPE, GC) for _ in range(k - 1)]) if k > 1 else None
    segs = quant.rdb_segments(NF, GC, k)
    srcs = [x] + ([] if tail is None else list(tail.unbind(0)))
    amax = torch.stack([quant.act_amax_plain(t) for t in srcs], 1)
    kw = dict(act="lrelu") if k < 5 else dict(r1=x, s1=0.2, r2=_frames(rng, SHAPE, NF), s2=0.2)
    a8 = dict(sas=SAS[:k]) if static else {}
    oa, pa = torch.zeros(2), torch.zeros(2)
    if not static:
        a8_e, a8_p = dict(out_amax=oa), dict(out_amax=pa)
    else:
        a8_e = a8_p = {}
    got = emulate(x, segs, None if static else amax, wq[k - 1], sw[k - 1], bs[k - 1],
                  x_tail=tail, **a8, **a8_e, **kw)
    want = quant.conv3x3_i8_plain(x, segs, None if static else amax, wq[k - 1], sw[k - 1],
                                  bs[k - 1], x_tail=tail, **a8, **a8_p, **kw)
    assert torch.equal(got, want)
    assert torch.equal(oa, pa)
    assert (amax[1] > 3 * amax[0]).all()  # each image quantised with a scale of its own


def test_a_growth_buffer_prefix_equals_plain():
    """conv 3 on the first 128 channels of a 192-channel buffer (pixel
    stride 192), writing into its slice: the forced comparisons' layout."""
    rng = np.random.default_rng(3)
    wq, sw, bs, _ = _rdb8(rng)
    grow = _frames(rng, SHAPE, NF + 4 * GC)
    segs = quant.rdb_segments(NF, GC, 3)
    amax = torch.stack([quant.act_amax_plain(grow[..., lo:hi]) for lo, hi in
                        zip(segs[:-1], segs[1:])], 1)
    a, b_ = grow.clone(), grow.clone()
    emulate(a[..., :128], segs, amax, wq[2], sw[2], bs[2], act="lrelu", out=a[..., 128:160])
    quant.conv3x3_i8_plain(b_[..., :128], segs, amax, wq[2], sw[2], bs[2], act="lrelu",
                           out=b_[..., 128:160])
    assert torch.equal(a, b_)


@pytest.mark.parametrize("static", [False, True])
def test_the_srvgg_conv_equals_plain(static):
    """The SRVGG body conv: 64 -> 64, one segment of two stages, PReLU."""
    rng = np.random.default_rng(40 + static)
    x = _frames(rng, SHAPE, NF)
    w = torch.from_numpy(_bf16((rng.random((3, 3, NF, NF)) - 0.5) * 0.1)).to(BF)
    wq, sw = quant.quantize_conv_weights(w, (0, NF))
    b = torch.from_numpy(_bf16((rng.random(NF) - 0.5) * 0.1)).to(BF)
    alpha = torch.from_numpy(_bf16(rng.random(NF) * 0.3)).to(BF)
    amax = None if static else quant.act_amax_plain(x)[:, None]
    kw = dict(act="prelu", alpha=alpha, sas=(0.0079,) if static else None)
    oa, pa = (None, None) if static else (torch.zeros(2), torch.zeros(2))
    got = emulate(x, (0, NF), amax, wq, sw, b, out_amax=oa, **kw)
    want = quant.conv3x3_i8_plain(x, (0, NF), amax, wq, sw, b, out_amax=pa, **kw)
    assert torch.equal(got, want)
    assert static or torch.equal(oa, pa)


@pytest.mark.parametrize("fault", [dict(a_sbo=224), dict(b_sbo=224), dict(raw_slots="short"),
                                   dict(q_slots="short")])
def test_a_stride_or_a_ring_one_step_short_breaks_the_schedule(fault):
    """The emulation sees the kernel's layout: an 8-row group stride one
    32-byte row short in either descriptor, or a ring one slot short of the
    lookahead the plan's depth gives, changes the output."""
    rng = np.random.default_rng(7)
    wq, sw, bs, _ = _rdb8(rng)
    x = _frames(rng, SHAPE, NF)
    tail = torch.stack([_frames(rng, SHAPE, GC) for _ in range(4)])
    segs = quant.rdb_segments(NF, GC, 5)
    plan = quant.i8_wgmma_plan(x.shape, NF, segs, NF, sms=3, tail=4)
    fault = {key: (plan.raw_depth - 1 if key == "raw_slots" else plan.q_depth - 1)
             if v == "short" else v for key, v in fault.items()}
    kw = dict(sas=SAS, r1=x, s1=0.2, x_tail=tail)
    want = quant.conv3x3_i8_plain(x, segs, None, wq[4], sw[4], bs[4], **kw)
    assert torch.equal(emulate(x, segs, None, wq[4], sw[4], bs[4], **kw), want)
    assert not torch.equal(emulate(x, segs, None, wq[4], sw[4], bs[4], **kw, **fault), want)


def _emulated_rdb(x, wq, sw, bs, x0=None, sas=None):
    """The blocked int8 RDB (ops/stripe.py on the wgmma route) through the
    emulation: c1 .. c4 in a (4, B, H, W, 32) tail, the amax columns written
    by the convs that write their segments."""
    tail = torch.zeros((4, *x.shape[:3], GC), dtype=BF)
    amax = None if sas is not None else torch.zeros(x.shape[0], 6)
    if amax is not None:
        amax[:, 0] = quant.act_amax_plain(x)

    def a8(k):
        return dict(sas=tuple(sas[:k])) if sas is not None else dict(out_amax=amax[:, k])

    for k in range(1, 5):
        emulate(x, quant.rdb_segments(NF, GC, k), amax, wq[k - 1], sw[k - 1], bs[k - 1],
                act="lrelu", out=tail[k - 1], x_tail=tail[: k - 1] if k > 1 else None, **a8(k))
    out = emulate(x, quant.rdb_segments(NF, GC, 5), amax, wq[4], sw[4], bs[4], r1=x, s1=0.2,
                  r2=x0, s2=0.2, x_tail=tail, **a8(5))
    return out, None if amax is None else amax[:, 5]


@pytest.mark.parametrize("static,with_x0", [(False, False), (False, True), (True, True)])
def test_the_blocked_rdb_equals_plain(static, with_x0):
    rng = np.random.default_rng(20 + 2 * static + with_x0)
    wq, sw, bs, _ = _rdb8(rng)
    x = _frames(rng, SHAPE, NF)
    x0 = _frames(rng, SHAPE, NF) if with_x0 else None
    sas = SAS if static else None
    got, ga = _emulated_rdb(x, wq, sw, bs, x0, sas)
    want, wa = stripe.rdb_fused_i8_plain(x, wq, sw, bs, x0, sas=sas)
    assert torch.equal(got, want)
    assert (ga is None and wa is None) or torch.equal(ga, wa)


@pytest.mark.parametrize("with_x0", [False, True])
def test_the_blocked_rdb_equals_the_jax_kernel(with_x0):
    """One image, one stripe and one chunk (the JAX scale is the port's):
    the emulated RDB equals ``rdb_stripe_padded`` /
    ``rdb_res_stripe_padded(sws)`` in interpret mode bit for bit in bf16."""
    from video_restore_tpu.ops.pallas_stripe import (
        pad_stripe_entry,
        prefix_rdb_weights,
        production_prefix_weights,
        quantize_prefix_weights,
        rdb_res_stripe_padded,
        rdb_stripe_padded,
        unpad_stripe_exit,
    )

    h, w = 12, 70
    rng = np.random.default_rng(30 + with_x0)
    wq, sw, bs, ws = _rdb8(rng)
    rdb = {f"conv{k + 1}": {"w": jnp.asarray(ws[k], jnp.bfloat16),
                            "b": jnp.asarray(bs[k].float().numpy(), jnp.bfloat16)}
           for k in range(5)}
    pws, pbs = prefix_rdb_weights(rdb, NF, GC)
    qws, sws = quantize_prefix_weights(production_prefix_weights(pws))
    x = _bf16((rng.random((1, h, w, NF)) - 0.5) * 3)
    x0 = _bf16(rng.random((1, h, w, NF)) - 0.5) if with_x0 else None
    kw = dict(frame_h=h, frame_w=w, block_h=h, sws=sws, interpret=True)
    xp = pad_stripe_entry(jnp.asarray(x, jnp.bfloat16), block_h=h)
    if with_x0:
        ref = rdb_res_stripe_padded(xp, pad_stripe_entry(jnp.asarray(x0, jnp.bfloat16), block_h=h),
                                    qws, pbs, **kw)
    else:
        ref = rdb_stripe_padded(xp, qws, pbs, **kw)
    ref = np.asarray(unpad_stripe_exit(ref, h, w, NF, block_h=h), np.float32)
    got, amax = _emulated_rdb(torch.from_numpy(x).to(BF), wq, sw, bs,
                              None if x0 is None else torch.from_numpy(x0).to(BF))
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert amax.item() == np.abs(ref).max()
