"""Key/shape manifests of the released Real-ESRGAN checkpoints.

Port of ``video_restore_tpu/models/manifests.py`` (RRDBNet and
SRVGGNetCompact).

The reference loads these exact files (video_upscaler.py:344-348 URL
table); their serialization layout is public information (basicsr /
realesrgan repos). Hardcoding the expected torch state_dict schema lets
the converter be validated — and real conversions be *checked* — in
environments where the checkpoints themselves are unreachable: a key-name
or shape deviation fails loudly here instead of producing a broken model
while unit tests stay green (round-1 review, missing item #4).

Layout facts encoded below:

- RRDBNet (basicsr): ``conv_first``, ``body.{i}.rdb{j}.conv{k}`` for
  i < num_block, j in 1..3, k in 1..5 (dense growth num_grow_ch, conv5
  back to num_feat), ``conv_body``, ``conv_up1``, ``conv_up2``,
  ``conv_hr``, ``conv_last`` — each with ``.weight`` (OIHW) + ``.bias``.
  For scale 2 the input is pixel-unshuffled, so conv_first sees
  num_in_ch*4 channels (scale 1: *16).
- SRVGGNetCompact (realesrgan): a flat ``body`` ModuleList — conv at
  index 0, PReLU at 1, then (conv, PReLU) pairs at (2+2i, 3+2i) for
  i < num_conv, and the final conv (to num_out_ch*scale^2 channels,
  pixel-shuffled) at index 2+2*num_conv. PReLU weights have num_feat
  parameters.
- Checkpoint nesting: the x4plus / anime_6B / x2plus releases store the
  EMA weights under a top-level ``params_ema`` dict; realesr-general-x4v3
  stores plain ``params``.
"""

from __future__ import annotations

from typing import Dict, Tuple

from video_restore_tpu_torch.models.rrdbnet import RRDBNetSpec
from video_restore_tpu_torch.models.srvgg import SRVGGSpec

Shape = Tuple[int, ...]

# top-level nesting key of each released .pth (public serialization fact);
# "" = bare state_dict (the KAIR/BSRGAN releases)
CHECKPOINT_NEST_KEY: Dict[str, str] = {
    "RealESRGAN_x4plus": "params_ema",
    "RealESRGAN_x4plus_anime_6B": "params_ema",
    "RealESRGAN_x2plus": "params_ema",
    "RealESRGAN_x4_v3": "params",
    "BSRGAN": "",
    "BSRGANx2": "",
}

# torch key naming per RRDBNetSpec.key_style: basicsr (Real-ESRGAN
# releases) vs original-ESRGAN/KAIR (the BSRGAN releases)
RRDB_KEY_STYLES: Dict[str, Dict[str, str]] = {
    "basicsr": {
        "body": "body.{i}.rdb{j}.conv{k}",
        "conv_body": "conv_body",
        "conv_up1": "conv_up1",
        "conv_up2": "conv_up2",
        "conv_hr": "conv_hr",
    },
    "esrgan": {
        "body": "RRDB_trunk.{i}.RDB{j}.conv{k}",
        "conv_body": "trunk_conv",
        "conv_up1": "upconv1",
        "conv_up2": "upconv2",
        "conv_hr": "HRconv",
    },
}


def rrdbnet_manifest(spec: RRDBNetSpec) -> Dict[str, Shape]:
    m: Dict[str, Shape] = {}
    names = RRDB_KEY_STYLES[spec.key_style]

    def conv(prefix: str, cin: int, cout: int) -> None:
        m[f"{prefix}.weight"] = (cout, cin, 3, 3)
        m[f"{prefix}.bias"] = (cout,)

    nf, gc = spec.num_feat, spec.num_grow_ch
    conv("conv_first", spec.stem_in_ch, nf)
    for i in range(spec.num_block):
        for j in (1, 2, 3):
            for k in range(1, 6):
                cin = nf + (k - 1) * gc
                cout = gc if k < 5 else nf
                conv(names["body"].format(i=i, j=j, k=k), cin, cout)
    conv(names["conv_body"], nf, nf)
    conv(names["conv_up1"], nf, nf)
    if spec.num_upsample == 2:
        conv(names["conv_up2"], nf, nf)
    conv(names["conv_hr"], nf, nf)
    conv("conv_last", nf, spec.num_out_ch)
    return m


def srvgg_manifest(spec: SRVGGSpec) -> Dict[str, Shape]:
    m: Dict[str, Shape] = {}

    def conv(prefix: str, cin: int, cout: int) -> None:
        m[f"{prefix}.weight"] = (cout, cin, 3, 3)
        m[f"{prefix}.bias"] = (cout,)

    nf = spec.num_feat
    conv("body.0", spec.num_in_ch, nf)
    m["body.1.weight"] = (nf,)  # PReLU
    for i in range(spec.num_conv):
        conv(f"body.{2 + 2 * i}", nf, nf)
        m[f"body.{3 + 2 * i}.weight"] = (nf,)  # PReLU
    conv(f"body.{2 + 2 * spec.num_conv}", nf, spec.num_out_ch * spec.scale**2)
    return m


def state_dict_manifest(model_name: str) -> Dict[str, Shape]:
    from video_restore_tpu_torch.models.zoo import MODEL_ZOO

    spec = MODEL_ZOO[model_name].spec
    if isinstance(spec, RRDBNetSpec):
        return rrdbnet_manifest(spec)
    return srvgg_manifest(spec)


def validate_state_dict(sd: Dict[str, "object"], model_name: str) -> None:
    """Raise with a precise diff if ``sd`` deviates from the released
    checkpoint's schema (after top-level unnesting)."""
    manifest = state_dict_manifest(model_name)
    missing = sorted(set(manifest) - set(sd))
    unexpected = sorted(set(sd) - set(manifest))
    mismatched = [
        f"{k}: {tuple(getattr(sd[k], 'shape', ()))} != {manifest[k]}"
        for k in manifest
        if k in sd and tuple(getattr(sd[k], "shape", ())) != manifest[k]
    ]
    if missing or unexpected or mismatched:
        parts = []
        if missing:
            parts.append(f"missing keys ({len(missing)}): {missing[:5]}")
        if unexpected:
            parts.append(
                f"unexpected keys ({len(unexpected)}): {unexpected[:5]}"
            )
        if mismatched:
            parts.append(f"shape mismatches: {mismatched[:5]}")
        raise ValueError(
            f"{model_name} state_dict does not match the released "
            f"checkpoint schema — {'; '.join(parts)}"
        )
