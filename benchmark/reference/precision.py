"""The precision the plain references compute in.

``Exact``: float32 throughout (TF32 is switched off by the caller).
``Fp8``: the control, the step below the configurations' bf16: every
weight rounded to float8 e4m3 with one scale per output channel, and every
activation the model stores (its input, each conv's output after its
activation, each residual sum) rounded to float8 e4m3 with one scale per
tensor; products and sums stay float32.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


class Exact:
    def act(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return w


def _round_e4m3(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Fp8:
    def act(self, t: torch.Tensor) -> torch.Tensor:
        scale = torch.clamp(t.abs().amax(), min=1e-12) / E4M3_MAX
        return _round_e4m3(t, scale)

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """HWIO (or stacked ...HWIO) weights, one scale per output channel."""
        lead = w.shape[:-4]
        flat = w.reshape(*lead, -1, w.shape[-1])
        scale = torch.clamp(flat.abs().amax(dim=-2, keepdim=True), min=1e-12) / E4M3_MAX
        return _round_e4m3(flat, scale).reshape(w.shape)


PRECISIONS = {"fp32": Exact, "fp8": Fp8}
