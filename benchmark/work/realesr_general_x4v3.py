"""The least work of one realesr-general-x4v3 frame (SRVGGNetCompact,
num_feat 64, 32 body convs, x4) at LR size h x w: every conv at LR
resolution, 9 taps a pixel, a MAC two FLOPs. Bytes: the bf16 input and
output and every bf16 weight, each once."""

NF, NCONV, CIN, COUT, SCALE = 64, 32, 3, 3, 4


def macs_per_lr_pixel() -> int:
    return 9 * CIN * NF + NCONV * 9 * NF * NF + 9 * NF * COUT * SCALE * SCALE


def params() -> int:
    return 9 * CIN * NF + 2 * NF + NCONV * (9 * NF * NF + 2 * NF) + 9 * NF * COUT * SCALE * SCALE + COUT * SCALE * SCALE


def flops_per_frame(h: int, w: int) -> float:
    return 2.0 * macs_per_lr_pixel() * h * w


def bytes_per_frame(h: int, w: int) -> float:
    return 2.0 * (h * w * CIN + h * w * SCALE * SCALE * COUT + params())
