"""Fine-tuning on torch autograd (port of ``video_restore_tpu/training``).

Charbonnier/L1 pixel losses, PSNR/SSIM on the device, the Adam train step
on the models' differentiable forwards, degrade-on-the-fly patch sampling,
the loop and the ``finetune`` CLI, and the sharded (dp, tp) step over a
``DeviceMesh`` (``train_step_sharded``, ``Trainer(mesh=)``).
"""

from video_restore_tpu_torch.training.losses import (
    charbonnier_loss,
    l1_loss,
    psnr,
    ssim,
)
from video_restore_tpu_torch.training.train import (
    TrainState,
    make_train_step,
    shard_train_state,
    train_step_sharded,
)

__all__ = [
    "charbonnier_loss",
    "l1_loss",
    "psnr",
    "ssim",
    "TrainState",
    "make_train_step",
    "shard_train_state",
    "train_step_sharded",
]
