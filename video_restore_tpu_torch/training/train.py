"""The fine-tuning step, degrade-on-the-fly and the training loop.

Port of ``video_restore_tpu/training/train.py`` on torch autograd:

- :func:`make_train_step`: one step takes the Charbonnier loss of the
  model's ``forward_train`` (``RRDBNet``/``SRVGGNet``: fp32 ``F.conv2d``,
  no kernel, as JAX's ``apply_fn(differentiable=True)`` runs no Pallas
  kernel), runs ``backward`` and then ``optimizer.step()``, and returns the
  loss. TF32 is off unless asked for, per call (the JAX reference is fp32).
- :func:`adam`: ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``,
  whose update ``lr * m_hat / (sqrt(v_hat) + eps)`` is optax ``adam``'s
  with ``eps_root=0`` (held to optax in ``tests/test_torch_train.py``).
- :func:`degrade_batch`: the light Real-ESRGAN-style degradation: a
  Gaussian blur, the antialiased linear downscale of ``jax.image.resize``
  (``ops/resample.py::resize_linear_aa``), Gaussian noise, a clip.
- :class:`Trainer`: the loop over HR patches from the user's footage.
  Batches are drawn as in JAX (``min(8, n)`` indices with replacement,
  then the noise) but from a ``torch.Generator(seed)`` on the device, so
  the sequences differ from ``jax.random``'s; the patches go to the device
  once, not once per step.
- :func:`save_checkpoint` / :func:`restore_checkpoint`: ``torch.save`` of
  ``{"params", "opt_state", "step"}`` in a directory, read back with
  ``torch.load(weights_only=True)``: the counterpart of the orbax
  checkpoint. Neither package reads the other's checkpoints; the weights
  themselves cross through ``models/zoo.py::save_params_npz``.

One device only: the sharded ``(dp, tp)`` step (``mesh=``,
:func:`shard_train_state`, :func:`train_step_sharded`) raises
``NotImplementedError`` until multi-GPU is ported (``ROADMAP.md`` queue 1
item 5).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

from video_restore_tpu_torch.ops.post import gaussian_blur
from video_restore_tpu_torch.ops.resample import resize_linear_aa
from video_restore_tpu_torch.training.losses import charbonnier_loss
from video_restore_tpu_torch.utils.device import resolve_device, tf32

_MULTI_GPU = (
    "sharded (dp, tp) training over several GPUs is not ported yet "
    "(ROADMAP.md queue 1 item 5); train on one device"
)
CHECKPOINT_FILE = "checkpoint.pt"


@dataclasses.dataclass
class TrainState:
    """The training state a checkpoint holds: the model's state dict, the
    optimizer's state dict and the step count."""

    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    step: int = 0


def adam(params: Iterable[torch.nn.Parameter], learning_rate: float) -> torch.optim.Adam:
    """optax ``adam(learning_rate)``: betas (0.9, 0.999), eps 1e-8 outside
    the square root."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable = charbonnier_loss,
    allow_tf32: bool = False,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Returns ``train_step(lr_batch, hr_batch) -> loss``: the loss of
    ``model.forward_train(lr)`` against ``hr``, its gradients (left in each
    parameter's ``.grad`` after the step), and one optimizer step, with
    cuDNN's and cuBLAS's TF32 set to ``allow_tf32`` for the call."""

    def train_step(lr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        with tf32(allow_tf32):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(model.forward_train(lr), hr)
            loss.backward()
            optimizer.step()
        return loss.detach()

    return train_step


def shard_train_state(*args, **kwargs):
    raise NotImplementedError(_MULTI_GPU)


def train_step_sharded(*args, **kwargs):
    raise NotImplementedError(_MULTI_GPU)


# ---------------------------------------------------------------------------
# Degrade-on-the-fly paired patch sampling (Real-ESRGAN-style, light)
# ---------------------------------------------------------------------------


def degrade_batch(
    hr: torch.Tensor,
    scale: int,
    *,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """LR inputs from HR patches (N, H, W, C) in [0, 1]: ``gaussian_blur(hr,
    0.8, 2)``, the antialiased linear downscale to (H // scale, W // scale),
    ``+ 0.01 * noise`` and a clip to [0, 1]. ``noise`` is N(0, 1) of the LR
    shape, drawn from ``generator`` (on ``hr``'s device) unless given."""
    n, h, w, c = hr.shape
    lr = resize_linear_aa(gaussian_blur(hr, 0.8, 2), (h // scale, w // scale))
    if noise is None:
        noise = torch.randn(lr.shape, generator=generator, device=lr.device)
    return torch.clamp(lr + noise.to(lr.device) * 0.01, 0.0, 1.0)


def save_checkpoint(
    path: Union[str, Path], params: Dict[str, torch.Tensor], opt_state: Dict[str, Any], step: int
) -> None:
    """The full training state, resumable, as ``path/checkpoint.pt``
    (written to a temporary name, then renamed)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (CHECKPOINT_FILE + ".part")
    torch.save({"params": params, "opt_state": opt_state, "step": step}, tmp)
    os.replace(tmp, path / CHECKPOINT_FILE)


def restore_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """``{"params", "opt_state", "step"}`` from :func:`save_checkpoint`'s
    directory, tensors on the CPU; only tensors and plain containers load."""
    return torch.load(Path(path) / CHECKPOINT_FILE, map_location="cpu", weights_only=True)


class Trainer:
    """Minimal fine-tuning loop over frames from the user's own footage.

    ``model`` is a trainable module with ``forward_train``
    (``ModelHandle.train_module``); it is moved to ``device``, which is the
    current CUDA device unless given (without one, this raises: training
    never moves to the CPU on its own)."""

    def __init__(
        self,
        model: torch.nn.Module,
        scale: int,
        learning_rate: float = 1e-4,
        mesh: Any = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if mesh is not None:
            raise NotImplementedError(_MULTI_GPU)
        self.device = resolve_device() if device is None else torch.device(device)
        self.model = model.to(self.device)
        self.scale = scale
        self.optimizer = adam(self.model.parameters(), learning_rate)
        self._step = make_train_step(self.model, self.optimizer)
        self.losses: List[float] = []

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The model's state dict, detached, on the CPU."""
        return {k: v.detach().cpu() for k, v in self.model.state_dict().items()}

    @property
    def opt_state(self) -> Dict[str, Any]:
        return self.optimizer.state_dict()

    def fit_patches(self, hr_patches: np.ndarray, steps: int, seed: int = 0) -> Dict[str, torch.Tensor]:
        """hr_patches: (N, H, W, 3) float32 in [0,1], H/W divisible by
        scale. Each step samples a batch, degrades it, and minimizes the
        Charbonnier loss. Returns :attr:`params`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        patches = torch.from_numpy(np.ascontiguousarray(hr_patches, np.float32)).to(self.device)
        n = patches.shape[0]
        for _ in range(steps):
            idx = torch.randint(0, n, (min(8, n),), generator=gen, device=self.device)
            hr = patches[idx]
            lr = degrade_batch(hr, self.scale, generator=gen)
            self.losses.append(float(self._step(lr, hr)))
        return self.params
