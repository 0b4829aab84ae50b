"""Torch ``.pth`` checkpoint -> param pytree in the JAX layout.

Port of ``video_restore_tpu/models/convert.py``: the released
Real-ESRGAN/BSRGAN state dicts (OIHW conv weights, sometimes nested under
``params_ema``/``params``) are validated against the manifest and mapped
onto the pytree the JAX package uses (HWIO weights, the body blocks or
convs stacked on axis 0), with numpy leaves. ``params_from_jax`` of
``models/rrdbnet.py`` or ``models/srvgg.py`` turns that pytree into the
module's weights, so both packages load the same files the same way.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Union

import numpy as np
import torch


def _load_state_dict(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        # weights_only=False executes arbitrary pickle code: only allow it
        # on explicit opt-in (a corrupt or hostile .pth must not silently
        # escalate to code execution)
        if os.environ.get("VRT_UNSAFE_PICKLE") != "1":
            raise RuntimeError(
                f"safe (weights_only) load of {path} failed: {e}. If you "
                "trust this checkpoint, retry with VRT_UNSAFE_PICKLE=1."
            ) from e
        import logging

        logging.getLogger("video_restore_tpu_torch").warning(
            "loading %s with weights_only=False (VRT_UNSAFE_PICKLE=1): "
            "pickle code in the file will execute", path,
        )
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("params_ema", "params", "state_dict"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {k: v.detach().cpu().numpy() for k, v in ckpt.items()}


def _conv(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    w = sd[f"{prefix}.weight"]  # OIHW
    b = sd.get(f"{prefix}.bias")
    out = {"w": np.transpose(w, (2, 3, 1, 0)).astype(np.float32)}
    out["b"] = (b if b is not None else np.zeros(w.shape[0])).astype(np.float32)
    return out


def convert_rrdbnet(
    sd: Dict[str, np.ndarray],
    num_block: int,
    key_style: str = "basicsr",
    num_upsample: int = 2,
) -> Dict[str, Any]:
    """``key_style``/``num_upsample`` select the checkpoint flavour: basicsr
    (Real-ESRGAN releases) vs original-ESRGAN/KAIR naming (BSRGAN; its x2
    variant has a single upsample stage and no conv_up2)."""
    from video_restore_tpu_torch.models.manifests import RRDB_KEY_STYLES

    names = RRDB_KEY_STYLES[key_style]
    body: Dict[str, Any] = {}
    for j in (1, 2, 3):
        rdb = {}
        for k in range(1, 6):
            convs = [
                _conv(sd, names["body"].format(i=i, j=j, k=k))
                for i in range(num_block)
            ]
            rdb[f"conv{k}"] = {
                leaf: np.stack([c[leaf] for c in convs]) for leaf in ("w", "b")
            }
        body[f"rdb{j}"] = rdb
    params = {
        "conv_first": _conv(sd, "conv_first"),
        "body": body,
        "conv_body": _conv(sd, names["conv_body"]),
        "conv_up1": _conv(sd, names["conv_up1"]),
        "conv_hr": _conv(sd, names["conv_hr"]),
        "conv_last": _conv(sd, "conv_last"),
    }
    if num_upsample == 2:
        params["conv_up2"] = _conv(sd, names["conv_up2"])
    return params


def convert_srvgg(sd: Dict[str, np.ndarray], num_conv: int) -> Dict[str, Any]:
    """SRVGGNetCompact's flat ``body`` ModuleList: conv_in at 0, its PReLU
    at 1, (conv, PReLU) pairs at (2 + 2i, 3 + 2i), conv_out at
    2 + 2 num_conv."""
    body = [
        {
            **_conv(sd, f"body.{2 + 2 * i}"),
            "alpha": sd[f"body.{3 + 2 * i}.weight"].astype(np.float32),
        }
        for i in range(num_conv)
    ]
    return {
        "conv_in": _conv(sd, "body.0"),
        "alpha_in": sd["body.1.weight"].astype(np.float32),
        "body": {k: np.stack([c[k] for c in body]) for k in ("w", "b", "alpha")},
        "conv_out": _conv(sd, f"body.{2 + 2 * num_conv}"),
    }


def convert_pth_to_params(
    path: Union[str, Path], model_name: str
) -> Dict[str, Any]:
    from video_restore_tpu_torch.models.manifests import validate_state_dict
    from video_restore_tpu_torch.models.rrdbnet import RRDBNetSpec
    from video_restore_tpu_torch.models.zoo import MODEL_ZOO

    spec = MODEL_ZOO[model_name].spec
    sd = _load_state_dict(path)
    # fail loudly (with a key diff) on any deviation from the released
    # checkpoint schema rather than producing a silently broken model
    validate_state_dict(sd, model_name)
    if isinstance(spec, RRDBNetSpec):
        return convert_rrdbnet(
            sd, spec.num_block, spec.key_style, spec.num_upsample
        )
    return convert_srvgg(sd, spec.num_conv)
