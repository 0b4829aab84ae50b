"""The least work of one RealESRGAN_x4plus frame (RRDBNet, num_feat 64,
num_grow_ch 32, 23 RRDBs, x4) at LR size h x w, as a roofline counts it.

Each 3x3 conv is 9 taps a pixel, except a conv that reads a nearest-2x
upsampled input: each of its outputs sees 2 x 2 distinct input pixels,
so it counts 4 taps (the phase form); no implementation then reads above
its bound. A MAC is two FLOPs. Bytes: the bf16 input and output and every
bf16 weight, each once.
"""

NF, GC, NB, CIN, COUT, SCALE = 64, 32, 23, 3, 3, 4


def macs_per_lr_pixel() -> int:
    rdb = sum(9 * (NF + k * GC) * (GC if k < 4 else NF) for k in range(5))
    return (
        9 * CIN * NF  # conv_first
        + 3 * NB * rdb  # the dense blocks
        + 9 * NF * NF  # conv_body
        + 4 * 4 * NF * NF  # conv_up1: 4 outputs a LR pixel, 4 taps
        + 16 * 4 * NF * NF  # conv_up2: 16 outputs a LR pixel, 4 taps
        + 16 * 9 * NF * NF  # conv_hr
        + 16 * 9 * NF * COUT  # conv_last
    )


def params() -> int:
    rdb = sum(9 * (NF + k * GC) * (GC if k < 4 else NF) + (GC if k < 4 else NF) for k in range(5))
    return 9 * CIN * NF + NF + 3 * NB * rdb + 4 * (9 * NF * NF + NF) + 9 * NF * COUT + COUT


def flops_per_frame(h: int, w: int) -> float:
    return 2.0 * macs_per_lr_pixel() * h * w


def bytes_per_frame(h: int, w: int) -> float:
    return 2.0 * (h * w * CIN + h * w * SCALE * SCALE * COUT + params())
