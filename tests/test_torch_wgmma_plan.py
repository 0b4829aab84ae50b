"""The tensor-map plan of K1's ``"wgmma"`` route, on a machine without a card.

``csrc/conv3x3_wgmma.cu`` reads its input window and its weights with TMA.
The wrapper (``ops/tail.py::wgmma_plan``) computes both tensor maps' dims,
byte strides and boxes and the persistent grid as a pure function of the
call; the C launcher only encodes them, after checking that the plan fits
its build. The plan is held here for every view the port hands the kernel:
each growth-buffer prefix of a 192-channel RDB buffer, ``out`` slices, the
tile paths' B = 6 batch, frames smaller than one tile, and the calls TMA
cannot describe. The kernel itself runs on the card only (``chip_smoke.py
--only k1``; ``python -m video_restore_tpu_torch.tools.probe_k1 --route
wgmma``).
"""

import re

import pytest
import torch

from video_restore_tpu_torch.ops import _build, tail

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

BF = torch.bfloat16
SRC = (_build.CSRC / "conv3x3_wgmma.cu").read_text()


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", SRC).group(1))


def test_the_python_plan_matches_the_shipped_build():
    """The wrapper's default tile and blocks an SM are the source's own, and
    the plan has the length the launcher reads."""
    th = _define("VR_WG_CONSUMERS") * _define("VR_WG_ROWS")
    assert tail.WGMMA_TILE == (th, int(re.search(r"constexpr int TW = (\d+);", SRC).group(1)))
    assert tail.WGMMA_PER_SM == _define("VR_WG_CTAS")
    plan = tail.wgmma_plan((1, 8, 8, 64), 64, 64, sms=132)
    n = int(re.search(r"constexpr int PLAN_LEN = (\d+);", SRC).group(1))
    assert len(plan.array()) == n == 34
    assert tail.WGMMA_KC == _define("VR_WG_KC")


@pytest.mark.parametrize("cin", [64, 96, 128, 160, 192])
def test_each_growth_buffer_prefix(cin):
    """conv k reads buf[..., :cin] of a (1, 1080, 1920, 192) buffer: the map
    spans cin channels, its W stride is the buffer's pixel (192 x 2 bytes)."""
    buf = torch.empty(1, 1080, 1920, 192, dtype=BF, device="meta")  # shape only
    cout = 64 if cin == 192 else 32
    w = torch.empty(3, 3, cin, cout, dtype=BF, device="meta")
    p = tail.wgmma_call_plan(buf[..., :cin], w, sms=132)
    assert p.a_dims == (cin, 1920, 1080, 1)
    assert p.a_strides == (384, 1920 * 384, 1080 * 1920 * 384)
    assert p.a_box == (32, 66, 6, 1)  # 32 channels of a 6 x 66 window
    assert p.a_swizzle == 64  # one 64-byte swizzle row a pixel
    assert p.w_dims == (cout, cin, 9)
    assert p.w_strides == (cout * 2, cin * cout * 2)
    assert p.w_box == (cout, 32, 9)  # one stage's channels of every tap
    assert p.w_swizzle == cout * 2  # 128-byte rows at cout 64, 64 at cout 32
    th = 4
    assert p.tiles == (1080 // th) * 30 and p.grid == 132
    assert p.tail == 0 and p.t_strides == (0,) * 4 and p.t_box == (0,) * 5
    vals = list(p.array())
    assert vals == [*p.a_dims, *p.a_strides, *p.a_box, 64, *p.w_dims, *p.w_strides,
                    *p.w_box, p.w_swizzle, p.grid, th, 64, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("lo", [64, 96, 128, 160])
def test_out_slices_are_passed_as_views(lo):
    """conv k writes buf[..., lo:lo + 32]: the kernel gets the slice's first
    element and the buffer's pixel stride, and the route stays wgmma."""
    buf = torch.zeros(1, 4, 5, 192, dtype=BF)
    x, out = buf[..., :lo], buf[..., lo : lo + 32]
    w, b = torch.zeros(3, 3, lo, 32, dtype=BF), torch.zeros(32, dtype=BF)
    assert tail.conv3x3_call_route(x, w, b, out=out) == "wgmma"
    args = tail.launch_args(x, w, b, None, out, None, None, "lrelu", False, 1.0, 1.0)
    assert args[0] == buf.data_ptr() and args[6] == buf.data_ptr() + 2 * lo
    assert args[7:16] == (1, 4, 5, lo, 32, 192, 192, 0, 0)
    assert args[16:] == (1, 0, 1.0, 1.0)
    r1 = buf[..., :64]
    args = tail.launch_args(buf, torch.zeros(3, 3, 192, 64, dtype=BF), torch.zeros(64, dtype=BF),
                            None, torch.zeros(1, 4, 5, 64, dtype=BF), r1, None, "none", False,
                            0.2, 1.0)
    assert args[4] == buf.data_ptr() and args[13:16] == (64, 192, 0)


def test_the_tile_batch():
    """The tile paths' (6, 376, 448) batch: B is the map's fourth dimension,
    and every image has its own row of tiles."""
    p = tail.wgmma_plan((6, 376, 448, 64), 64, 64, sms=132)
    assert p.a_dims == (64, 448, 376, 6)
    assert p.a_strides == (128, 448 * 128, 376 * 448 * 128)
    assert p.tiles == 6 * 94 * 7 and p.grid == 132


@pytest.mark.parametrize(
    "shape,tiles", [((1, 3, 7), 1), ((1, 5, 7), 2), ((2, 37, 53), 2 * 10), ((1, 1, 1), 1)]
)
def test_frames_smaller_than_a_tile(shape, tiles):
    """A frame narrower than the 4 x 64 tile is one column of tiles, each
    box reaching past the frame (TMA zero-fills it: the SAME padding); the
    grid is never larger than the tiles."""
    p = tail.wgmma_plan((*shape, 64), 64, 32, sms=132)
    assert p.a_dims == (64, shape[2], shape[1], shape[0])
    assert p.a_box == (32, 66, 6, 1)
    assert p.tiles == tiles and p.grid == tiles


def test_a_build_with_another_tile():
    """The probe's variants pass their own tile, blocks an SM and channels a
    stage (16: 32-byte swizzle rows)."""
    p = tail.wgmma_plan((1, 1080, 1920, 64), 64, 64, sms=132, tile=(8, 64), per_sm=2, kc=16)
    assert p.a_box == (16, 66, 10, 1) and p.tile == (8, 64)
    assert p.a_swizzle == 32 and p.w_box == (64, 16, 9)
    assert p.tiles == 135 * 30 and p.grid == 264


@pytest.mark.parametrize("cin", [96, 160, 16, 208])
def test_a_last_stage_past_cin(cin):
    """cin need not be a multiple of the stage's 32 channels: the maps'
    dims stop at cin, and TMA's zero fill of the rest adds nothing."""
    p = tail.wgmma_plan((1, 8, 8, cin), 224, 32, sms=132)
    assert p.a_dims[0] == cin and p.w_dims == (32, cin, 9)
    assert p.a_box[0] == p.w_box[1] == 32


@pytest.mark.parametrize(
    "shape,xs,cout,match",
    [
        ((1, 4, 5, 64), 68, 64, "not a multiple of 8"),  # a 68-channel buffer
        ((1, 4, 5, 64), 56, 64, "pixel stride 56 < cin"),
        ((1, 4, 5, 24), 24, 64, "cin 24"),
        ((1, 4, 5, 64), 64, 48, "cout 48"),
        ((1, 0, 5, 64), 64, 64, "empty shape"),
    ],
)
def test_calls_tma_cannot_describe_are_refused(shape, xs, cout, match):
    with pytest.raises(ValueError, match=match):
        tail.wgmma_plan(shape, xs, cout, sms=132)


def test_a_box_over_tma_limits_is_refused():
    with pytest.raises(ValueError, match="box over 256"):
        tail.wgmma_plan((1, 8, 8, 64), 64, 64, sms=132, tile=(255, 64))


def test_a_view_that_is_not_a_channel_slice_is_refused():
    """Every map assumes rows of W pixels of one stride: a view with a row
    step is not one."""
    buf = torch.zeros(1, 8, 5, 64, dtype=BF)
    with pytest.raises(ValueError, match="channel slice of a contiguous NHWC buffer"):
        tail.wgmma_call_plan(buf[:, ::2], torch.zeros(3, 3, 64, 64, dtype=BF), sms=132)


@pytest.mark.parametrize("blocks", [1, 2, 3, 4])
def test_a_tail_of_blocks(blocks):
    """The RDB on the wgmma route: conv k reads x (64 channels) and the first
    k - 1 blocks of a (4, B, H, W, 32) tail through a 5-D map whose last
    dimension steps from block to block; the weights span all of them."""
    x = torch.empty(6, 376, 448, 64, dtype=BF, device="meta")
    tail_t = torch.empty(4, 6, 376, 448, 32, dtype=BF, device="meta")
    cin = 64 + 32 * blocks
    w = torch.empty(3, 3, cin, 64 if blocks == 4 else 32, dtype=BF, device="meta")
    p = tail.wgmma_call_plan(x, w, tail_t[:blocks], sms=132)
    assert p.a_dims == (64, 448, 376, 6) and p.a_strides[0] == 128
    assert p.w_dims == (w.shape[-1], cin, 9) and p.w_strides[1] == cin * w.shape[-1] * 2
    assert p.tail == blocks
    assert p.t_strides == (64, 448 * 64, 376 * 448 * 64, 6 * 376 * 448 * 64)
    assert p.t_box == (32, 66, 6, 1, 1)  # one block's window a stage
    assert list(p.array())[24:] == [blocks, *p.t_strides, *p.t_box]


def test_a_tail_follows_whole_stages_of_x():
    with pytest.raises(ValueError, match="a tail follows whole stages of x"):
        tail.wgmma_plan((1, 8, 8, 48), 48, 32, sms=132, tail=1)


def test_the_plain_version_reads_a_tail_after_x():
    """x_tail's channels follow x's: the plain version is the conv of the
    concatenation."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 5, 7, 64, generator=g).to(BF)
    t = torch.rand(2, 2, 5, 7, 32, generator=g).to(BF)
    w = (torch.rand(3, 3, 128, 32, generator=g) * 0.1).to(BF)
    b = torch.rand(32, generator=g).to(BF)
    cat = torch.cat([x, t[0], t[1]], dim=-1)
    got = tail.conv3x3(x, w, b, act="lrelu", x_tail=t, counter="t")
    assert torch.equal(got, tail.conv3x3_plain(cat, w, b, act="lrelu"))
