"""One RDB, or a whole RRDB, in one launch of kernel K5 (``csrc/rdb_fused.cu``).

Counterpart of ``video_restore_tpu/ops/pallas_rdb.py``. It covers four
Pallas entry points that compute the same two functions:

- :func:`rdb_fused`, one RDB, replaces ``pallas_rdb.py:313 rdb_fused``
  (square blocks) and ``pallas_stripe.py:2079 rdb_stripe`` (stripes,
  unpadded NHWC);
- :func:`rrdb_fused`, a whole RRDB (three RDBs and the residual
  ``x + 0.2 * RDB3(RDB2(RDB1(x)))``), replaces ``pallas_rdb.py:257
  rrdb_fused`` (the ``VRT_PALLAS=1`` body) and ``pallas_stripe.py:1016
  rrdb_stripe_padded`` (padded stripes).

Both take the torch-ordered HWIO weights of ``ops/stripe.py``; the TPU
regroup and prefix layouts are not carried over. On a CUDA tensor a
wrapper launches K5 or raises; on a CPU tensor it runs its plain version.
K5 is four hand-written kernels of one function, and :func:`rdb_route`
says which a call takes: ``"wgmma"`` (``csrc/rdb_fused_wgmma.cu``: Hopper
``wgmma`` fed by TMA over rolling rings of rows, on the launch plan of
:func:`rdb_wgmma_plan`) for bf16 at nf 64 / gc 32, ``"bf16x3"``
(``csrc/rdb_fused_bf16x3.cu``: K1 ``"bf16x3"``'s conv, three bf16 parts a
fp32 value on ``wgmma``, as the phases of one persistent cooperative launch,
on the plan of :func:`rdb_x3_plan`) for fp32 at nf 64 / gc 32 with aligned
operands, ``"fma"`` (``csrc/rdb_fused.cu``: fp32 FMAs) for the narrow nf 16
/ gc 8 of the checks and every forced call. ``"mma"`` (``csrc/rdb_fused_mma.cu``: ``mma.sync`` on the tile
routines of ``csrc/mma_tile.cuh``) takes the same calls as ``"wgmma"`` when
a caller forces it (a side-by-side timing; its sums are in the same order,
so the two give the same bits); ``"bf16x3"`` sums as K1's ``"bf16x3"``
route does, so it gives the bits of ``ops/stripe.py::rdb_fused``'s five
fp32 launches. The kernel notes (design, bound) are at the
top of the sources.

The border. The ``pallas_stripe.py`` forms mask every growth tensor to the
frame, so each conv has exact SAME zero padding. The ``pallas_rdb.py`` forms
zero-pad only their input and never mask c1..c4 or, in ``rrdb_fused``, the
intermediate RDB outputs: outside the frame those are non-zero and the next
conv reads them, so near the frame edge (within 4 pixels for one RDB, 14 for
an RRDB) they compute another function than the model's. The port computes
the model's function, SAME at every conv, as the stripe forms and every
other ported path do; the square-block border is a reference behaviour, not
something to copy (``tests/test_torch_rdb.py`` measures it).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch

from video_restore_tpu_torch.ops import _build
from video_restore_tpu_torch.ops.stripe import rdb_fused_plain
from video_restore_tpu_torch.ops.tail import (
    _DTYPES,
    _sm_count,
    bf16x3_smem,
    forced_route,
    operands_aligned,
    weight_parts,
)

# (nf, gc) pairs K5 is instantiated for: every RRDBNet of the zoo, and the
# narrow width of the tests and checks
WIDTHS = ((64, 32), (16, 8))
ROUTES = ("wgmma", "bf16x3", "mma", "fma")
_TAKES = {"wgmma": "bf16 at (64, 32)", "mma": "bf16 at (64, 32)",
          "bf16x3": "fp32 at (64, 32) with aligned operands"}

RdbWeights = Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]


def rdb_route(dtype: torch.dtype, nf: int, gc: int, aligned: bool = True) -> str:
    """Which of K5's kernels a call on a CUDA tensor launches: a pure
    function of the call. At (nf, gc) = (64, 32), the width of every RRDBNet
    of the zoo, ``"wgmma"`` (Hopper tensor cores) takes bf16 and
    ``"bf16x3"`` (the same tensor cores on three bf16 parts a value) fp32
    whose operands are ``aligned`` (x, x0 and the biases on 16-byte
    boundaries: :func:`_pick_route`); ``"fma"`` takes the rest (the narrow
    (16, 8))."""
    if (nf, gc) == (64, 32):
        if dtype == torch.bfloat16:
            return "wgmma"
        if dtype == torch.float32 and aligned:
            return "bf16x3"
    return "fma"


def _pick_route(name: str, x: torch.Tensor, nf: int, gc: int, route: Optional[str],
                x0: Optional[torch.Tensor] = None, bs: Sequence[torch.Tensor] = ()) -> str:
    """The route of a call: :func:`rdb_route` (with x, x0 and the biases
    ``bs`` as its operands), or ``route`` when the caller forces one (a
    side-by-side timing of the kernels): ``"mma"`` where the call's own
    route is ``"wgmma"`` (the ``mma.sync`` kernel takes every such call),
    ``"fma"`` anywhere."""
    own = rdb_route(x.dtype, nf, gc, operands_aligned(x, x0, *bs))
    if route == "mma" and own == "wgmma":
        return "mma"
    return forced_route(name, own, route, _TAKES.get(route, ""), ROUTES)


# rdb_fused_wgmma.cu as shipped: output rows a step (consumer warpgroups),
# output columns of a stripe, pixels of an x ring row, x rows held, c_1 ..
# c_4 rows held, weight slots, dynamic shared memory a block, the early x
# release, threads a block (the build reports its own:
# vr_rdb_fused_wgmma_config)
K5_WGMMA = dict(step_rows=3, stripe=54, ring_px=64, x_rows=9, c_rows=(8, 7, 6, 5), slots=3,
                smem=231744, early_x=1, threads=512)
K5_MIN_ROWS = 32  # the fewest rows a block of the persistent grid takes
SMEM_MAX = 232448  # dynamic shared memory a block can have on the H100
_SLOT = 18432  # bytes of a weight stage (32 x 9 x 32 or 16 x 9 x 64 bf16)
_TMA_DIM_MAX = 1 << 32
_TMA_STRIDE_MAX = 1 << 40


def k5_smem(x_rows: int, c_rows: Sequence[int], slots: int, ring_px: int = 64,
            stripe: int = 54) -> int:
    """Dynamic shared memory of a block of ``rdb_fused_wgmma.cu``: 1024
    bytes of alignment, the weight slots, the four c rings end to end (c_k's
    rows of the stripe + 10 - 2 k pixels a needed output reads, the region
    rounded to 1024 bytes), the x ring (rows of ``ring_px`` pixels in two
    32-channel planes) and 1024 bytes after it, the rings' barriers and
    three RDBs' biases (bf16)."""
    c_px = sum(d * (stripe + 10 - 2 * k) for k, d in enumerate(c_rows, 1))
    return (1024 + slots * _SLOT + -(-c_px * 64 // 1024) * 1024 + x_rows * 2 * ring_px * 64
            + 1024 + (2 * x_rows + 2 * slots) * 8 + 3 * (4 * 32 + 64) * 2)


class RdbWgmmaPlan(NamedTuple):
    """What ``vr_rdb_fused_wgmma`` / ``vr_rrdb_fused_wgmma`` check, encode
    and launch: the build's geometry as the plan assumed it (rows a step,
    stripe columns, x ring pixels, x and c_1 .. c_4 rows held, weight slots,
    shared memory), the persistent grid, the stripes and the rows the blocks
    share (B x stripes x H, cut into ``grid`` runs), x's 4-D map over
    (channels, W, H, B) (dims, byte strides of dims 1-3, a box of 32
    channels of one ring row, 64-byte swizzle) and the weight boxes of conv
    1-4 (32 couts x 32 input channels x 9 taps, 64-byte swizzle) and conv 5
    (64 x 16 x 9, 128-byte swizzle)."""

    step_rows: int
    stripe: int
    ring_px: int
    x_rows: int
    c_rows: Tuple[int, int, int, int]
    slots: int
    smem: int
    grid: int
    stripes: int
    rows: int
    a_dims: Tuple[int, int, int, int]
    a_strides: Tuple[int, int, int]
    a_box: Tuple[int, int, int, int]
    a_swizzle: int
    w_box: Tuple[int, int, int]
    w_swizzle: int
    w5_box: Tuple[int, int, int]
    w5_swizzle: int

    def array(self) -> ctypes.Array:
        """The plan as the C launcher reads it (33 int64 values)."""
        vals = (self.step_rows, self.stripe, self.ring_px, self.x_rows, *self.c_rows,
                self.slots, self.smem, self.grid, self.stripes, self.rows, *self.a_dims,
                *self.a_strides, *self.a_box, self.a_swizzle, *self.w_box, self.w_swizzle,
                *self.w5_box, self.w5_swizzle)
        return (ctypes.c_longlong * len(vals))(*vals)

    def block_rows(self, block: int) -> Tuple[int, int]:
        """Block ``block``'s run [r0, r1) of the concatenated stripes' rows."""
        return self.rows * block // self.grid, self.rows * (block + 1) // self.grid

    def segments(self, block: int) -> Iterator[Tuple[int, int, int, int]]:
        """Block ``block``'s segments, in its order: (image, the stripe's
        first column, first row, end row), as the kernel walks them."""
        h = self.a_dims[2]
        r, r1 = self.block_rows(block)
        while r < r1:
            idx, y0 = divmod(r, h)
            n = min(h - y0, r1 - r)
            yield idx // self.stripes, (idx % self.stripes) * self.stripe, y0, y0 + n
            r += n

    def steps(self, seg_rows: int) -> int:
        """Steps of a segment of ``seg_rows`` output rows: until conv 5,
        four rows behind conv 1, has written the last."""
        return (seg_rows + 7) // self.step_rows + 1

    def first_step(self, k: int) -> int:
        """The first step at which conv k (1..5) runs: the first whose rows
        a needed output reads."""
        return (2 * k - 2) // self.step_rows

    def executed_ops(self, nf: int = 64, gc: int = 32) -> int:
        """Operations (2 per MAC) the kernel executes for one RDB: every
        conv over 64 pixels of each row it computes, the recomputed columns
        and the fill rows of each segment included."""
        per_row = [2 * 64 * 9 * (nf + (k - 1) * gc) * (gc if k < 5 else nf) for k in range(1, 6)]
        total = 0
        for blk in range(self.grid):
            for _, _, y0, y1 in self.segments(blk):
                t = self.steps(y1 - y0)
                total += sum(self.step_rows * (t - self.first_step(k)) * per_row[k - 1]
                             for k in range(1, 6))
        return total


def rdb_wgmma_plan(b: int, h: int, w: int, geometry: Optional[Dict] = None, *,
                   sms: int = 132) -> RdbWgmmaPlan:
    """The ``"wgmma"`` route's plan for a (b, h, w, 64) bf16 RDB or RRDB: a
    pure function of the shape, the build's ``geometry`` (:data:`K5_WGMMA`,
    or :func:`wgmma_geometry` of a loaded build) and the card's SM count.
    Stripes of the build's output columns (54 as shipped), B x stripes x H
    rows cut into one run a block (at least :data:`K5_MIN_ROWS` rows, at
    most one block an SM).
    Raises ValueError for what the kernel cannot take: an empty shape, a
    geometry whose shared memory is not its own or exceeds the card's, a
    frame TMA cannot describe (a dimension of 2^32 or more, a byte stride
    of 2^40 or more)."""
    g = dict(K5_WGMMA if geometry is None else geometry)
    b, h, w = int(b), int(h), int(w)
    if min(b, h, w) <= 0:
        raise ValueError(f"rdb_wgmma_plan: empty shape {(b, h, w)}")
    r, c_rows = g["step_rows"], tuple(g["c_rows"])
    want = (r + 6, tuple(r + 6 - k for k in range(1, 5)))
    if (g["x_rows"], c_rows) != want:
        raise ValueError(f"rdb_wgmma_plan: rows held {g['x_rows']}, {c_rows} are not "
                         f"{want} for {r} rows a step")
    if g["ring_px"] != (g["stripe"] + 17) // 8 * 8:
        raise ValueError(f"rdb_wgmma_plan: x ring rows of {g['ring_px']} pixels for a stripe of "
                         f"{g['stripe']} columns (conv 1 reads {g['stripe'] + 10})")
    smem = k5_smem(g["x_rows"], c_rows, g["slots"], g["ring_px"], g["stripe"])
    if smem != g["smem"] or smem > SMEM_MAX:
        raise ValueError(f"rdb_wgmma_plan: shared memory {smem} B (the build: {g['smem']} B, "
                         f"the card: at most {SMEM_MAX} B)")
    if max(w, h, b) >= _TMA_DIM_MAX:
        raise ValueError(f"rdb_wgmma_plan: a dimension of {(b, h, w)} is 2^32 or more")
    e = 2  # bf16
    a_strides = (64 * e, w * 64 * e, h * w * 64 * e)
    if max(a_strides) >= _TMA_STRIDE_MAX:
        raise ValueError(f"rdb_wgmma_plan: byte stride {max(a_strides)} is 2^40 or more")
    stripes = -(-w // g["stripe"])
    rows = b * stripes * h
    grid = max(1, min(sms, -(-rows // K5_MIN_ROWS)))
    return RdbWgmmaPlan(
        step_rows=r, stripe=g["stripe"], ring_px=g["ring_px"], x_rows=g["x_rows"],
        c_rows=c_rows, slots=g["slots"], smem=smem, grid=grid, stripes=stripes, rows=rows,
        a_dims=(64, w, h, b), a_strides=a_strides, a_box=(32, g["ring_px"], 1, 1), a_swizzle=64,
        w_box=(32, 32, 9), w_swizzle=64, w5_box=(64, 16, 9), w5_swizzle=128,
    )


def wgmma_geometry(lib) -> Dict:
    """:func:`rdb_wgmma_plan`'s ``geometry`` of a loaded build of
    ``rdb_fused_wgmma.cu`` (``vr_rdb_fused_wgmma_config``)."""
    cfg = (ctypes.c_int * 12)()
    lib.vr_rdb_fused_wgmma_config(cfg)
    return dict(step_rows=cfg[0], stripe=cfg[1], ring_px=cfg[2], x_rows=cfg[3],
                c_rows=tuple(cfg[4:8]), slots=cfg[8], smem=cfg[9], early_x=cfg[10],
                threads=cfg[11])


# rdb_fused_bf16x3.cu as shipped: tile rows at cout 32 and 64, tile pixels,
# input channels a stage, dynamic shared memory a block, threads a block,
# the plan's length (the build reports its own: vr_rdb_fused_bf16x3_config)
K5_X3 = dict(th32=8, th64=4, tw=64, kc=16, smem=227624, threads=384, plan_len=31)


class RdbX3Plan(NamedTuple):
    """What ``vr_rdb_fused_bf16x3`` checks, encodes and launches: the
    build's geometry as the plan assumed it (tile rows at cout 32 and 64,
    tile pixels, input channels a stage, shared memory), the persistent
    grid, the tile columns and the tile rows at each width, the 4-D maps
    over (channels, W, H, B) of an RDB's input (64 fp32 channels) and of
    c_1 .. c_4 (one 128-channel buffer): dims and byte strides, and the two
    boxes (kc channels of a (TH + 2) x (TW + 2) window at each width)."""

    th32: int
    th64: int
    tw: int
    kc: int
    smem: int
    grid: int
    tiles_x: int
    tiles_y32: int
    tiles_y64: int
    in_dims: Tuple[int, int, int, int]
    in_strides: Tuple[int, int, int]
    c_dims: Tuple[int, int, int, int]
    c_strides: Tuple[int, int, int]
    box32: Tuple[int, int, int, int]
    box64: Tuple[int, int, int, int]

    def array(self) -> ctypes.Array:
        """The plan as the C launcher reads it (31 int64 values)."""
        vals = (self.th32, self.th64, self.tw, self.kc, self.smem, self.grid, self.tiles_x,
                self.tiles_y32, self.tiles_y64, *self.in_dims, *self.in_strides, *self.c_dims,
                *self.c_strides, *self.box32, *self.box64)
        return (ctypes.c_longlong * len(vals))(*vals)

    def phases(self, rdbs: int = 1, nf: int = 64, gc: int = 32) -> Iterator[Tuple[int, int, int]]:
        """(cin, cout, tiles) of each phase, in launch order: conv 1 .. 5
        of each RDB."""
        b = self.in_dims[3]
        for _ in range(rdbs):
            for k in range(5):
                rows = self.tiles_y32 if k < 4 else self.tiles_y64
                yield nf + k * gc, gc if k < 4 else nf, b * self.tiles_x * rows

    def executed_ops(self, rdbs: int = 1) -> int:
        """Operations (2 per MAC, one product a MAC) the phases' tiles
        execute, the ragged tiles' masked pixels included."""
        return sum(tiles * (self.th32 if cout == 32 else self.th64) * self.tw * 2 * 9 * cin * cout
                   for cin, cout, tiles in self.phases(rdbs))


def rdb_x3_plan(b: int, h: int, w: int, geometry: Optional[Dict] = None, *,
                sms: int = 132) -> RdbX3Plan:
    """The ``"bf16x3"`` route's plan for a (b, h, w, 64) fp32 RDB or RRDB:
    a pure function of the shape, the build's ``geometry`` (:data:`K5_X3`,
    or :func:`x3_geometry` of a loaded build) and the card's SM count. The
    grid is one block an SM, at most the tiles of the widest phase; a block
    with no tile in a phase waits at its barrier. Raises ValueError for what
    the kernel cannot take: an empty shape, 2^31 pixels or more, a geometry
    whose shared memory is not its own or exceeds the card's, a byte stride
    TMA cannot describe (2^40 or more)."""
    g = dict(K5_X3 if geometry is None else geometry)
    b, h, w = int(b), int(h), int(w)
    if min(b, h, w) <= 0:
        raise ValueError(f"rdb_x3_plan: empty shape {(b, h, w)}")
    if b * h * w >= 1 << 31:
        raise ValueError(f"rdb_x3_plan: {(b, h, w)} is 2^31 pixels or more")
    th32, th64, tw, kc = g["th32"], g["th64"], g["tw"], g["kc"]
    smem = max(bf16x3_smem(32, th32, kc, tw), bf16x3_smem(64, th64, kc, tw))
    if smem != g["smem"] or smem > SMEM_MAX:
        raise ValueError(f"rdb_x3_plan: shared memory {smem} B (the build: {g['smem']} B, "
                         f"the card: at most {SMEM_MAX} B)")
    in_strides = (64 * 4, w * 64 * 4, h * w * 64 * 4)
    c_strides = (128 * 4, w * 128 * 4, h * w * 128 * 4)
    if max(c_strides) >= _TMA_STRIDE_MAX:
        raise ValueError(f"rdb_x3_plan: byte stride {max(c_strides)} is 2^40 or more")
    tiles_x = -(-w // tw)
    ty32, ty64 = -(-h // th32), -(-h // th64)
    return RdbX3Plan(
        th32=th32, th64=th64, tw=tw, kc=kc, smem=smem,
        grid=min(sms, b * tiles_x * max(ty32, ty64)), tiles_x=tiles_x, tiles_y32=ty32,
        tiles_y64=ty64, in_dims=(64, w, h, b), in_strides=in_strides, c_dims=(128, w, h, b),
        c_strides=c_strides, box32=(kc, tw + 2, th32 + 2, 1), box64=(kc, tw + 2, th64 + 2, 1),
    )


def x3_geometry(lib) -> Dict:
    """:func:`rdb_x3_plan`'s ``geometry`` of a loaded build of
    ``rdb_fused_bf16x3.cu`` (``vr_rdb_fused_bf16x3_config``)."""
    cfg = (ctypes.c_int * 7)()
    lib.vr_rdb_fused_bf16x3_config(cfg)
    return dict(th32=cfg[0], th64=cfg[1], tw=cfg[2], kc=cfg[3], smem=cfg[4], threads=cfg[5],
                plan_len=cfg[6])


_x3_geometry: Optional[Dict] = None


def _x3(name: str, x: torch.Tensor, rdb_weights: Sequence[RdbWeights],
        x0: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of ``rdb_fused_bf16x3.cu``: one RDB (one ``(ws, bs)``
    pair, with x0) or an RRDB (three), fp32 at (64, 32)."""
    global _x3_geometry
    lib = _build.load()
    if _x3_geometry is None:
        _x3_geometry = x3_geometry(lib)
    b, h, w, nf = x.shape
    gc = rdb_weights[0][0][0].shape[-1]
    rdbs = len(rdb_weights)
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if rdbs == 3 else None
    c = torch.empty((b, h, w, 4 * gc), dtype=x.dtype, device=x.device)
    parts = [weight_parts(t) for ws, _ in rdb_weights for t in ws]
    bs = [t for _, bs_ in rdb_weights for t in bs_]
    with torch.cuda.device(x.device):
        plan = rdb_x3_plan(b, h, w, _x3_geometry, sms=_sm_count(x.device)).array()
        code = lib.vr_rdb_fused_bf16x3(
            nf, gc, rdbs, x.data_ptr(), None if x0 is None else x0.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), c.data_ptr(),
            _build.pointers(parts), _build.pointers(bs), b, h, w, _build.stream_ptr(x), plan,
            len(plan),
        )
    _build.check(lib, code, f"{name} (K5) kernel (bf16x3)")
    return out


_geometry: Optional[Dict] = None


def _plan(x: torch.Tensor, lib) -> RdbWgmmaPlan:
    """:func:`rdb_wgmma_plan` of a call, for the port's library (its
    geometry read once)."""
    global _geometry
    if _geometry is None:
        _geometry = wgmma_geometry(lib)
    b, h, w, _ = x.shape
    return rdb_wgmma_plan(b, h, w, _geometry, sms=_sm_count(x.device))


def _check(name: str, x: torch.Tensor, rdbs: Sequence[RdbWeights]) -> Tuple[int, int]:
    """Validate x and the RDB weights for a K5 launch; returns (nf, gc)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (fp32, bf16)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NHWC tensor")
    nf = x.shape[-1]
    gc = rdbs[0][0][0].shape[-1]
    if (nf, gc) not in WIDTHS:
        raise ValueError(f"{name}: (nf, gc) = ({nf}, {gc}) not in {WIDTHS}")
    for ws, bs in rdbs:
        if len(ws) != 5 or len(bs) != 5:
            raise ValueError(f"{name}: an RDB has five convs")
        for k in range(5):
            cout = gc if k < 4 else nf
            for t, shape in ((ws[k], (3, 3, nf + k * gc, cout)), (bs[k], (cout,))):
                if tuple(t.shape) != shape:
                    raise ValueError(
                        f"{name}: conv{k + 1} operand {tuple(t.shape)} != {shape}"
                    )
                if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
                    raise ValueError(
                        f"{name}: conv{k + 1} operands must be contiguous "
                        f"{x.dtype} on {x.device}"
                    )
    return nf, gc


def rdb_fused(
    x: torch.Tensor,
    ws: Sequence[torch.Tensor],
    bs: Sequence[torch.Tensor],
    x0: Optional[torch.Tensor] = None,
    *,
    route: Optional[str] = None,
) -> torch.Tensor:
    """One RDB, optionally with the RRDB residual ``x0 + 0.2 * RDB(x)``:
    the function of ``ops/stripe.py::rdb_fused`` in one K5 launch.

    x, x0: (B, H, W, nf) contiguous; ws: the five HWIO conv weights
    (3, 3, nf + (k-1) gc, gc) and (3, 3, nf + 4 gc, nf); bs: their biases;
    all in x's dtype (fp32 or bf16). ``route``: None for :func:`rdb_route`'s
    kernel, ``"mma"`` or ``"fma"`` to force another (:func:`_pick_route`;
    ``"fma"`` is the yardstick of the ``"bf16x3"`` route).
    The launch is counted under ``rdb_fused_k5`` and under its route,
    ``rdb_fused_k5:wgmma``, ``:bf16x3``, ``:mma`` or ``:fma``."""
    if x.device.type == "cpu":
        return rdb_fused_plain(x, ws, bs, x0)
    nf, gc = _check("rdb_fused", x, [(ws, bs)])
    if x0 is not None and (
        x0.shape != x.shape or x0.dtype != x.dtype or x0.device != x.device
        or not x0.is_contiguous()
    ):
        raise ValueError("rdb_fused: x0 must be contiguous like x")
    route = _pick_route("rdb_fused", x, nf, gc, route, x0, bs)
    if route == "bf16x3":
        out = _x3("rdb_fused", x, [(ws, bs)], x0)
        _build.count_launch("rdb_fused_k5")
        _build.count_launch("rdb_fused_k5:bf16x3")
        return out
    out = torch.empty_like(x)
    b, h, w, _ = x.shape
    lib = _build.load()
    fn = {"wgmma": lib.vr_rdb_fused_wgmma, "mma": lib.vr_rdb_fused_mma,
          "fma": lib.vr_rdb_fused}[route]
    with torch.cuda.device(x.device):
        args = (
            _DTYPES[x.dtype], nf, gc, x.data_ptr(),
            x0.data_ptr() if x0 is not None else None, out.data_ptr(),
            _build.pointers(ws), _build.pointers(bs), b, h, w,
            _build.stream_ptr(x),
        )
        if route == "wgmma":
            plan = _plan(x, lib).array()
            args += (plan, len(plan))
        code = fn(*args)
    _build.check(lib, code, f"rdb_fused (K5) kernel ({route})")
    _build.count_launch("rdb_fused_k5")
    _build.count_launch(f"rdb_fused_k5:{route}")
    return out


def rrdb_fused(
    x: torch.Tensor, rdb_weights: Sequence[RdbWeights], *, route: Optional[str] = None
) -> torch.Tensor:
    """A whole RRDB, ``x + 0.2 * RDB3(RDB2(RDB1(x)))``, in one cooperative
    K5 launch.

    x: (B, H, W, nf) contiguous; rdb_weights: three ``(ws, bs)`` pairs as
    :func:`rdb_fused` takes them, in x's dtype. ``route`` as for
    :func:`rdb_fused`; the launch is counted under ``rrdb_fused`` and
    ``rrdb_fused:<route>`` (``wgmma``, ``bf16x3``, ``mma`` or ``fma``)."""
    if x.device.type == "cpu":
        return rrdb_fused_plain(x, rdb_weights)
    if len(rdb_weights) != 3:
        raise ValueError("rrdb_fused: an RRDB has three RDBs")
    nf, gc = _check("rrdb_fused", x, rdb_weights)
    route = _pick_route("rrdb_fused", x, nf, gc, route,
                        bs=[t for _, bs_ in rdb_weights for t in bs_])
    if route == "bf16x3":
        out = _x3("rrdb_fused", x, rdb_weights, None)
        _build.count_launch("rrdb_fused")
        _build.count_launch("rrdb_fused:bf16x3")
        return out
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)
    b, h, w, _ = x.shape
    ws = [t for r in rdb_weights for t in r[0]]
    bs = [t for r in rdb_weights for t in r[1]]
    lib = _build.load()
    fn = {"wgmma": lib.vr_rrdb_fused_wgmma, "mma": lib.vr_rrdb_fused_mma,
          "fma": lib.vr_rrdb_fused}[route]
    with torch.cuda.device(x.device):
        args = (
            _DTYPES[x.dtype], nf, gc, x.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), _build.pointers(ws), _build.pointers(bs),
            b, h, w, _build.stream_ptr(x),
        )
        if route == "wgmma":
            plan = _plan(x, lib).array()
            args += (plan, len(plan))
        code = fn(*args)
    _build.check(lib, code, f"rrdb_fused (K5) kernel ({route})")
    _build.count_launch("rrdb_fused")
    _build.count_launch(f"rrdb_fused:{route}")
    return out


def rrdb_fused_plain(x, rdb_weights):
    """Three plain RDBs and the residual, the RDB3 output rounded to x's
    dtype before ``x + 0.2 *`` in fp32 (``pallas_stripe.py:987``)."""
    (w1, b1), (w2, b2), (w3, b3) = rdb_weights
    out = rdb_fused_plain(x, w1, b1)
    out = rdb_fused_plain(out, w2, b2)
    return rdb_fused_plain(out, w3, b3, x0=x)
