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
  once, not once per step. Under a ``mesh`` every rank draws the same
  batches from the same seed, and the sharded step takes its share.
- :func:`save_checkpoint` / :func:`restore_checkpoint`: ``torch.save`` of
  ``{"params", "opt_state", "step"}`` in a directory, read back with
  ``torch.load(weights_only=True)``: the counterpart of the orbax
  checkpoint. Neither package reads the other's checkpoints; the weights
  themselves cross through ``models/zoo.py::save_params_npz``.

The sharded step (``train.py:61-125``, ``:170-186``): SPMD over a
``DeviceMesh`` of shape (dp, tp) named ``("dp", "tp")`` (``parallel/
mesh.py::train_mesh``), one rank per mesh device. :func:`shard_train_state`
keeps each rank's slice of every leaf that :func:`_param_spec` shards (the
output channels on "tp") and of Adam's moments; :func:`train_step_sharded`
splits the batch over "dp", runs each tp-sharded conv on the rank's output
channels and gathers them (:class:`TensorParallel`), averages the gradients
over "dp" and steps Adam on the local slices. Where JAX's GSPMD inserts the
collectives, the port places them by hand: a gather whose backward keeps
the rank's own slice of the gradient (the layers after it run replicated on
every tp rank, each with the whole gradient), and at each sharded conv's
input an identity whose backward sums the partial input gradients over
"tp". The backend is the caller's: NCCL where each rank has a GPU of its
own, gloo where ranks share one (the CPU tests, ``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Union

import numpy as np
import torch

from video_restore_tpu_torch.ops.post import gaussian_blur
from video_restore_tpu_torch.ops.resample import resize_linear_aa
from video_restore_tpu_torch.training.losses import charbonnier_loss
from video_restore_tpu_torch.utils.device import resolve_device, tf32

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


# ---------------------------------------------------------------------------
# The sharded (dp, tp) step
# ---------------------------------------------------------------------------


def _param_spec(leaf: torch.Tensor, tp: int) -> Optional[int]:
    """The dimension along which a leaf is sharded on "tp", or None for a
    replicated leaf (``train.py:61-69``): the output-channel dimension when
    it divides by tp and holds at least 4 tp channels. The port keeps the
    JAX layout (HWIO convs, the SRVGG body stacked on axis 0), so that is
    the last dimension of a conv weight, its bias and a PReLU alpha, as in
    JAX."""
    if leaf.dim() >= 1 and leaf.shape[-1] % tp == 0 and leaf.shape[-1] >= tp * 4:
        return leaf.dim() - 1
    return None


class _EnterTP(torch.autograd.Function):
    """Identity at a tp-sharded conv's input; its backward sums the input
    gradient over "tp" (each rank's conv gives the share of its own output
    channels)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherTP(torch.autograd.Function):
    """All-gather of an NCHW activation's channels over "tp"; its backward
    keeps the rank's own slice of the gradient (every tp rank holds the
    whole gradient of the replicated layers after the gather)."""

    @staticmethod
    def forward(ctx, y, group, size, rank):
        import torch.distributed as dist

        ctx.c, ctx.rank = y.shape[1], rank
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        c, r = ctx.c, ctx.rank
        return g[:, r * c : (r + 1) * c], None, None, None


class TensorParallel:
    """The "tp" axis of one rank, as the models' ``forward_train(x, tp=)``
    uses it: :meth:`is_sharded` tells whether a parameter holds only this
    rank's output channels; such a conv runs on :meth:`enter` of its input
    and its output goes through :meth:`gather`."""

    def __init__(self, group, sharded: Iterable[torch.Tensor]):
        import torch.distributed as dist

        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self._ids: Set[int] = {id(p) for p in sharded}

    def is_sharded(self, p: torch.Tensor) -> bool:
        return id(p) in self._ids

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _EnterTP.apply(x, self.group)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        return _GatherTP.apply(y, self.group, self.size, self.rank)


def shard_train_state(
    model: torch.nn.Module, optimizer: torch.optim.Optimizer, mesh
) -> Dict[str, Optional[int]]:
    """Keep this rank's slice of every parameter :func:`_param_spec` shards
    (its tp index's contiguous block of output channels), and of Adam's
    ``exp_avg``/``exp_avg_sq`` where the optimizer has them; the step count
    and every other leaf stay replicated (``train.py:72-98``). The module
    and the optimizer are changed in place (their parameters keep their
    identity); returns each parameter's sharded dimension, or None."""
    tp = mesh["tp"].size()
    r = mesh.get_local_rank("tp")
    shardings = {}
    for name, p in model.named_parameters():
        dim = _param_spec(p, tp)
        shardings[name] = dim
        if dim is None:
            continue
        c = p.shape[dim] // tp
        with torch.no_grad():
            p.data = p.data.narrow(dim, r * c, c).clone()
            state = optimizer.state.get(p, {})
            for k in ("exp_avg", "exp_avg_sq"):
                if k in state:
                    state[k] = state[k].narrow(dim, r * c, c).clone()
        p.grad = None
    return shardings


def gather_sharded(
    tensors: Dict[str, torch.Tensor], shardings: Dict[str, Optional[int]], mesh
) -> Dict[str, torch.Tensor]:
    """Whole tensors from this rank's slices (parameters, or their
    gradients), gathered over "tp" along each one's sharded dimension;
    every rank takes part and gets them."""
    import torch.distributed as dist

    group = mesh.get_group("tp")
    out = {}
    for name, t in tensors.items():
        dim = shardings.get(name)
        if dim is None:
            out[name] = t.detach().clone()
            continue
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        out[name] = torch.cat(parts, dim)
    return out


def train_step_sharded(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    mesh,
    loss_fn: Callable = charbonnier_loss,
    allow_tf32: bool = False,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The (dp, tp) step (``train.py:101-125``): places the state with
    :func:`shard_train_state`, then returns ``step(lr_batch, hr_batch) ->
    loss``, which every rank calls with the same whole batch. The rank takes
    its dp index's contiguous share, runs ``forward_train(x, tp=)`` (each
    tp-sharded conv on its output channels, gathered), averages the
    gradients over "dp" (one all-reduce of them all, with the loss) and
    steps the optimizer on its slices; the loss returned is the batch's.
    After a step each parameter's ``.grad`` holds this rank's slice of the
    averaged gradient; ``step.shardings`` is :func:`shard_train_state`'s
    result."""
    import torch.distributed as dist

    shardings = shard_train_state(model, optimizer, mesh)
    named = list(model.named_parameters())
    params = [p for _, p in named]
    tp = TensorParallel(mesh.get_group("tp"), [p for n, p in named if shardings[n] is not None])
    dp_group = mesh.get_group("dp")
    dp = mesh["dp"].size()
    lo = mesh.get_local_rank("dp")

    def train_step(lr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        b = lr.shape[0]
        if b % dp:
            raise ValueError(f"train_step_sharded: batch {b} not divisible by dp {dp}")
        k = b // dp
        part = slice(lo * k, (lo + 1) * k)
        with tf32(allow_tf32):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(model.forward_train(lr[part], tp=tp), hr[part])
            loss.backward()
            loss = loss.detach()
            if dp > 1:
                flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.reshape(1)])
                dist.all_reduce(flat, group=dp_group)
                flat /= dp
                i = 0
                for p in params:
                    n = p.grad.numel()
                    p.grad.copy_(flat[i : i + n].view_as(p.grad))
                    i += n
                loss = flat[i]
            optimizer.step()
        return loss

    train_step.shardings = shardings
    return train_step


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
        self.device = resolve_device() if device is None else torch.device(device)
        self.model = model.to(self.device)
        self.scale = scale
        self.mesh = mesh
        self.optimizer = adam(self.model.parameters(), learning_rate)
        if mesh is not None:
            self._step = train_step_sharded(self.model, self.optimizer, mesh)
        else:
            self._step = make_train_step(self.model, self.optimizer)
        self.losses: List[float] = []

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The model's state dict, detached, on the CPU; under a mesh the
        whole weights, gathered over "tp" (every rank takes part)."""
        sd = self.model.state_dict()
        if self.mesh is not None:
            sd = gather_sharded(sd, self._step.shardings, self.mesh)
        return {k: v.detach().cpu() for k, v in sd.items()}

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
