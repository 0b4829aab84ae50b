"""Model registry and weight loading.

Port of ``video_restore_tpu/models/zoo.py``: the same ``MODEL_ZOO`` specs,
a :class:`ModelHandle`, ``random_model``, and the two weight files the JAX
zoo reads, in the same order: ``{models_dir}/{name}.npz`` (the converted
pytree, keys are JAX ``keystr`` paths such as
``['body']['rdb1']['conv1']['w']`` with the body stacked on axis 0,
``zoo.py:199-219``), then the released ``.pth`` (converted and cached as
that npz). Weights are never downloaded here; without a file, random
weights are used only when the caller allows them.

Both families load: RRDBNet (``models/rrdbnet.py``) and SRVGGNetCompact
(``RealESRGAN_x4_v3``, ``models/srvgg.py``).

``ModelHandle.train_module`` is the PyTorch form of the JAX
``apply_fn(differentiable=True)``: a trainable fp32 module whose
``forward_train`` fine-tuning runs; ``ModelHandle.jax_params`` turns a
(fine-tuned) state back into the JAX pytree that ``save_params_npz`` writes
and both packages' ``load_params_npz`` read.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from video_restore_tpu_torch.models import rrdbnet, srvgg
from video_restore_tpu_torch.models.rrdbnet import RRDBNet, RRDBNetSpec
from video_restore_tpu_torch.models.srvgg import SRVGGNet, SRVGGSpec

Spec = Union[RRDBNetSpec, SRVGGSpec]


@dataclasses.dataclass(frozen=True)
class ZooEntry:
    spec: Spec
    pth_name: str  # filename of the released checkpoint


MODEL_ZOO: Dict[str, ZooEntry] = {
    "RealESRGAN_x4plus": ZooEntry(
        RRDBNetSpec(num_block=23, scale=4), "RealESRGAN_x4plus.pth"
    ),
    "RealESRGAN_x4_v3": ZooEntry(
        SRVGGSpec(num_conv=32, scale=4), "realesr-general-x4v3.pth"
    ),
    "RealESRGAN_x4plus_anime_6B": ZooEntry(
        RRDBNetSpec(num_block=6, scale=4), "RealESRGAN_x4plus_anime_6B.pth"
    ),
    "RealESRGAN_x2plus": ZooEntry(
        RRDBNetSpec(num_block=23, scale=2), "RealESRGAN_x2plus.pth"
    ),
    "BSRGAN": ZooEntry(
        RRDBNetSpec(num_block=23, scale=4, key_style="esrgan"), "BSRGAN.pth"
    ),
    "BSRGANx2": ZooEntry(
        RRDBNetSpec(num_block=23, scale=2, unshuffle=False, key_style="esrgan"),
        "BSRGANx2.pth",
    ),
}


@dataclasses.dataclass
class ModelHandle:
    """A loaded model: its name, spec and weights (an fp32 state dict of
    :class:`RRDBNet` or :class:`SRVGGNet`, on the CPU)."""

    name: str
    spec: Spec
    state: Dict[str, torch.Tensor]

    @property
    def scale(self) -> int:
        return self.spec.scale

    def module(
        self, dtype: torch.dtype, device, precision: Optional[str] = None
    ) -> Union[RRDBNet, SRVGGNet]:
        """The prepared network in ``dtype`` on ``device``; ``precision``
        "int8" selects the W8A8 body (None: ``VRT_PRECISION``, through
        ``rrdbnet.default_precision``), and an RRDBNet's body mode follows
        ``VRT_PALLAS`` and its tail mode ``VRT_TAIL_Q`` on a CUDA device
        (``zoo.py:120-157`` of the JAX package, ``rrdbnet.body_mode``,
        ``rrdbnet.tail_mode``)."""
        net = _NET[type(self.spec)](self.spec)
        net.load_state_dict(self.state)
        if isinstance(net, RRDBNet):
            return net.prepare(
                dtype, device, precision, rrdbnet.body_mode(device),
                rrdbnet.tail_mode(device),
            )
        return net.prepare(dtype, device, precision)

    def train_module(self, device) -> Union[RRDBNet, SRVGGNet]:
        """The network with trainable fp32 weights on ``device``, for its
        ``forward_train`` (the JAX ``apply_fn(differentiable=True)``,
        ``zoo.py:104-119``): no cast, no prepared buffers, no kernel."""
        net = _NET[type(self.spec)](self.spec)
        net.load_state_dict(self.state)
        return net.to(device=device, dtype=torch.float32).requires_grad_(True)

    def jax_params(self) -> Dict[str, Any]:
        """The weights as the JAX param pytree (float32 numpy leaves, the
        body stacked on axis 0), as :func:`save_params_npz` writes them."""
        return _arch(self.spec).params_to_jax(self.state)


_NET = {RRDBNetSpec: RRDBNet, SRVGGSpec: SRVGGNet}


def _arch(spec: Spec):
    """The model module of ``spec``'s family (its ``init_params``,
    ``params_from_jax`` and ``params_to_jax``)."""
    return srvgg if isinstance(spec, SRVGGSpec) else rrdbnet


def random_model(name: str, seed: int = 0) -> ModelHandle:
    """Architecture-correct random weights from ``torch.Generator(seed)``."""
    spec = MODEL_ZOO[name].spec
    g = torch.Generator().manual_seed(seed)
    return ModelHandle(name, spec, _arch(spec).init_params(spec, g))


def _keystr(path: Tuple[str, ...]) -> str:
    return "".join(f"['{k}']" for k in path)


def _leaves(tree: Dict[str, Any], prefix=()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _template(spec: Spec) -> Dict[str, Any]:
    """The JAX pytree's leaf shapes for ``spec`` (``init_rrdbnet`` /
    ``init_srvgg``)."""

    def conv(cin, cout, stack=()):
        return {"w": stack + (3, 3, cin, cout), "b": stack + (cout,)}

    if isinstance(spec, SRVGGSpec):
        nf, n = spec.num_feat, spec.num_conv
        return {
            "conv_in": conv(spec.num_in_ch, nf),
            "alpha_in": (nf,),
            "body": {**conv(nf, nf, (n,)), "alpha": (n, nf)},
            "conv_out": conv(nf, spec.num_out_ch * spec.scale**2),
        }
    nf, gc, nb = spec.num_feat, spec.num_grow_ch, spec.num_block
    rdb = {
        f"conv{k}": conv(nf + (k - 1) * gc, gc if k < 5 else nf, (nb,))
        for k in range(1, 6)
    }
    t = {
        "conv_first": conv(spec.stem_in_ch, nf),
        "body": {"rdb1": rdb, "rdb2": rdb, "rdb3": rdb},
        "conv_body": conv(nf, nf),
        "conv_up1": conv(nf, nf),
        "conv_up2": conv(nf, nf),
        "conv_hr": conv(nf, nf),
        "conv_last": conv(nf, spec.num_out_ch),
    }
    if spec.num_upsample == 1:
        del t["conv_up2"]
    return t


def save_params_npz(params: Dict[str, Any], path: Path) -> None:
    """Write a JAX-layout pytree with the JAX zoo's key format."""
    np.savez(path, **{_keystr(p): np.asarray(v) for p, v in _leaves(params)})


def load_params_npz(name: str, path: Path) -> Dict[str, Any]:
    """Read a converted npz (written by either package) into a JAX-layout
    pytree of numpy arrays, checking every leaf's shape."""
    spec = MODEL_ZOO[name].spec
    out: Dict[str, Any] = {}
    with np.load(path) as data:
        for p, shape in _leaves(_template(spec)):
            key = _keystr(p)
            arr = data[key]
            if arr.shape != shape:
                raise ValueError(
                    f"checkpoint/arch mismatch at {key}: {arr.shape} vs {shape}"
                )
            node = out
            for k in p[:-1]:
                node = node.setdefault(k, {})
            node[p[-1]] = arr
    return out


def get_model(
    name: str,
    models_dir: Union[str, Path] = "models",
    *,
    allow_random: bool = False,
    seed: int = 0,
) -> ModelHandle:
    """Load a zoo model: npz cache -> .pth conversion -> (optional) random
    weights."""
    if name not in MODEL_ZOO:
        raise ValueError(f"Unknown model: {name}")
    entry = MODEL_ZOO[name]
    spec = entry.spec
    mdir = Path(models_dir)
    npz_path = mdir / f"{name}.npz"
    pth_path = mdir / entry.pth_name
    if npz_path.exists():
        params = load_params_npz(name, npz_path)
    elif pth_path.exists():
        from video_restore_tpu_torch.models.convert import convert_pth_to_params

        params = convert_pth_to_params(pth_path, name)
        save_params_npz(params, npz_path)
    elif allow_random:
        return random_model(name, seed)
    else:
        raise FileNotFoundError(
            f"No weights for {name} under {mdir}/ (expected {name}.npz or "
            f"{entry.pth_name}); set VRT_ALLOW_RANDOM_WEIGHTS=1 for random "
            "weights"
        )
    return ModelHandle(name, spec, _arch(spec).params_from_jax(params))
