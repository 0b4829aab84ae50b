"""RRDBNet (the ESRGAN generator) as a PyTorch module.

Port of ``video_restore_tpu/models/rrdbnet.py``: ``RRDBNetSpec`` is copied,
and :class:`RRDBNet` runs the same network as ``_apply`` in stripe mode
(``rrdbnet.py:532-892``): conv stem -> ``num_block`` RRDB blocks (three
RDBs each, the RRDB residual fused into rdb3) -> ``conv_body`` + the long
residual -> two nearest-2x upsample + conv stages -> ``conv_hr`` ->
``conv_last``. Scale-2 and scale-1 basicsr nets pixel-unshuffle the input
first (``:546-549``); ESRGAN-style x2 nets (BSRGANx2) have one upsample
stage and no ``conv_up2`` (``:741-769``).

Weights keep the JAX layout: HWIO convs, the same names as the JAX param
pytree, with the body as a list of blocks instead of a stacked axis.
:func:`params_from_jax` turns a JAX pytree (numpy leaves, stacked body) into
this module's state dict.

``forward(x)`` runs the kernel wrappers (K1 launches on CUDA tensors, their
plain versions on CPU tensors); ``forward(x, plain=True)`` runs the plain
versions on any device, which is the reference the kernel path is checked
against on the GPU.

``forward_train(x)`` is the differentiable forward that fine-tuning runs
(the JAX ``apply_rrdbnet(..., differentiable=True)``): fp32 ``F.conv2d``
under autograd, no kernel. :func:`params_to_jax` is the inverse of
:func:`params_from_jax`, so fine-tuned weights go back to the npz layout.

``prepare(..., precision="int8")`` selects the W8A8 body of the JAX
``_apply(stripe=True, precision="int8")`` (``rrdbnet.py:660-664``): every
RDB conv keeps int8 weights and fp32 scales per (source, output channel),
quantised once from the compute-dtype weights, and runs on K4
(``ops/stripe.py::rdb_fused_i8``); the stem, ``conv_body`` and the tail
stay in the compute dtype, as in JAX (``rrdbnet.py:384-391``).

``prepare(..., mode="pallas")`` selects the body of the JAX
``_apply(use_pallas=True)`` (``rrdbnet.py:650-651``, ``VRT_PALLAS=1``): one
K5 launch per RRDB block (``ops/rdb.py::rrdb_fused``) instead of the
default ``"stripe"`` body's 15 K1 launches. As in JAX (``zoo.py:154``),
int8 applies only to the stripe body: ``"pallas"`` keeps the compute dtype.
:func:`body_mode` resolves the mode the way the JAX ``default_use_pallas``
does.

``prepare(..., tail="q")`` selects the entry point of the JAX
``VRT_TAIL_Q=1`` (``rrdbnet.py:783-800``), ``ops/tail.py::tail_fused_q``,
in place of the default ``"chain"`` mode's ``ops/tail.py::tail_fused``, for
the nets with two upsample stages. In bf16 at nf 64 both modes launch
``csrc/tail_fused_wgmma.cu`` once a frame; in fp32 at nf 64 ``"q"``
launches ``csrc/tail_fused_bf16x3.cu`` once a frame, where ``"chain"``
runs three K1 launches; ``"q"`` runs K6 (``csrc/tail_fused.cu``) for nf 16,
or K6's ``mma`` kernel when a caller forces it. It is
independent of the body mode and of the precision; :func:`tail_mode`
resolves it from the knob.

:func:`calibrate_rdb_act_scales` gives the fixed activation scales of the
static-A8 int8 RDB (``ops/stripe.py::rdb_fused_i8(..., sas=)``); as in JAX,
no model or CLI path takes them.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from video_restore_tpu_torch.ops.conv import pixel_unshuffle
from video_restore_tpu_torch.ops.quant import (
    act_amax,
    act_amax_plain,
    pack_i8_weights,
    quantize_conv_weights,
    rdb_segments,
)
from video_restore_tpu_torch.ops.rdb import rrdb_fused, rrdb_fused_plain
from video_restore_tpu_torch.ops.stripe import (
    rdb_fused,
    rdb_fused_i8,
    rdb_fused_i8_plain,
    rdb_fused_plain,
)
from video_restore_tpu_torch.ops.tail import (
    conv3x3_fused,
    conv3x3_fused_plain,
    conv3x3_plain,
    tail_fused,
    tail_fused_plain,
    tail_fused_q,
    tail_fused_q_plain,
    up1_fused,
    up1_fused_plain,
)


@dataclasses.dataclass(frozen=True)
class RRDBNetSpec:
    num_in_ch: int = 3
    num_out_ch: int = 3
    num_feat: int = 64
    num_block: int = 23
    num_grow_ch: int = 32
    scale: int = 4
    # basicsr (Real-ESRGAN) reaches scale<4 by pixel-unshuffling the input
    # and keeping two 2x upsample stages; the original ESRGAN/KAIR nets
    # (BSRGAN) instead feed the raw input and use log2(scale) stages.
    unshuffle: bool = True
    # torch state_dict naming of the released checkpoint this spec loads:
    # "basicsr" (body.{i}.rdb{j}...) or "esrgan" (RRDB_trunk.{i}.RDB{j}...)
    key_style: str = "basicsr"

    @property
    def stem_in_ch(self) -> int:
        """Input channels after the scale<4 pixel-unshuffle."""
        if not self.unshuffle:
            return self.num_in_ch
        if self.scale == 2:
            return self.num_in_ch * 4
        if self.scale == 1:
            return self.num_in_ch * 16
        return self.num_in_ch

    @property
    def num_upsample(self) -> int:
        """Nearest-up+conv 2x stages in the tail (2 for every basicsr
        variant; log2(scale) for ESRGAN-style nets, e.g. BSRGANx2 has 1)."""
        if self.unshuffle or self.scale == 4:
            return 2
        return 1


class Conv3x3(nn.Module):
    """Weights of one 3x3 conv, HWIO, and its bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(3, 3, cin, cout), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(cout), requires_grad=False)


class RDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.nf, self.gc = nf, gc
        for k in range(1, 6):
            cout = gc if k < 5 else nf
            setattr(self, f"conv{k}", Conv3x3(nf + (k - 1) * gc, cout))

    def weights(self):
        convs = [getattr(self, f"conv{k}") for k in range(1, 6)]
        return [c.w for c in convs], [c.b for c in convs]

    def quantize(self) -> None:
        """W8 of the five convs, one scale per (source, output channel):
        buffers ``wq{k}`` (int8 HWIO), ``sw{k}`` (fp32 (k, cout)) and
        ``wp{k}`` (``wq{k}`` packed (9, cout, cin) for K4's ``"mma"``
        route)."""
        for k in range(1, 6):
            q, s = quantize_conv_weights(
                getattr(self, f"conv{k}").w, rdb_segments(self.nf, self.gc, k)
            )
            self.register_buffer(f"wq{k}", q, persistent=False)
            self.register_buffer(f"sw{k}", s, persistent=False)
            self.register_buffer(f"wp{k}", pack_i8_weights(q), persistent=False)

    def int8_weights(self):
        """``rdb_fused_i8``'s weight arguments, by name."""
        ks = range(1, 6)
        return dict(
            wq=[getattr(self, f"wq{k}") for k in ks],
            sw=[getattr(self, f"sw{k}") for k in ks],
            bs=[getattr(self, f"conv{k}").b for k in ks],
            wp=[getattr(self, f"wp{k}") for k in ks],
        )


class RRDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.rdb1 = RDB(nf, gc)
        self.rdb2 = RDB(nf, gc)
        self.rdb3 = RDB(nf, gc)

    def weights(self):
        """The three RDBs' ``(ws, bs)``, as ``ops/rdb.py::rrdb_fused`` takes
        them."""
        return [r.weights() for r in (self.rdb1, self.rdb2, self.rdb3)]


MODES = ("stripe", "pallas")


def body_mode(device) -> str:
    """The RRDB body mode for ``device``: ``"pallas"`` when ``VRT_PALLAS=1``
    and the device is a CUDA device, else ``"stripe"``. The JAX
    ``default_use_pallas`` (``rrdbnet.py:510-522``) honours the knob only on
    its accelerator and ignores it on the CPU; so does the port."""
    if os.environ.get("VRT_PALLAS") != "1":
        return "stripe"
    return "pallas" if torch.device(device).type == "cuda" else "stripe"


PRECISIONS = ("bf16", "int8")


def default_precision() -> str:
    """The body's precision when the caller names none: ``VRT_PRECISION``
    ("bf16" by default, or "int8", any case), read at call time; any other
    value raises ``ValueError`` (JAX ``rrdbnet.py:383-398``, the default of
    its ``apply`` and of ``srvgg.py``'s). The CLI always passes
    ``--precision``, so only callers of the API see it."""
    v = os.environ.get("VRT_PRECISION", "bf16").lower()
    if v not in PRECISIONS:
        raise ValueError(f"VRT_PRECISION must be bf16 or int8 (got {v!r})")
    return v


TAIL_MODES = ("chain", "q")


def tail_mode(device) -> str:
    """The tail mode for ``device``: ``"q"`` (``tail_fused_q``) when
    ``VRT_TAIL_Q=1`` and the device is a CUDA device, else ``"chain"``
    (``tail_fused``); in bf16 at nf 64 both are one launch of
    ``csrc/tail_fused_wgmma.cu``, and they differ only where that kernel
    does not run (``"q"``: one K6 launch, ``"chain"``: three K1 launches;
    module note). JAX reads the knob only where its tail kernels run
    (``default_use_tail_kernel``, ``rrdbnet.py:939-955``: the TPU); on the
    CPU it changes nothing, there or here."""
    if os.environ.get("VRT_TAIL_Q") != "1":
        return "chain"
    return "q" if torch.device(device).type == "cuda" else "chain"


@torch.no_grad()
def calibrate_rdb_act_scales(ws, bs, x: torch.Tensor, margin: float = 1.0):
    """Static activation scales of one RDB for ``rdb_fused_i8(..., sas=)``
    (``rrdbnet.py:162-192`` of the JAX package): ``max(|t|max, 1e-12) *
    margin / 127`` for t in (x, c1 .. c4), the dense block's intermediates
    on representative data ``x`` (B, H, W, nf), computed in fp32 through the
    plain conv. ws, bs: the five torch-ordered HWIO weights and biases.
    Returns five python floats."""
    feats = [x.float()]
    for k in range(4):
        feats.append(
            conv3x3_plain(
                torch.cat(feats, -1), ws[k].float(), bs[k].float(), act="lrelu"
            )
        )
    return tuple(
        max(float(t.abs().max()), 1e-12) * margin / 127.0 for t in feats
    )


class RRDBNet(nn.Module):
    """RRDBNet on NHWC activations: (N, H, W, 3) in [0, 1] -> (N, H*s, W*s, 3)
    in the module's dtype."""

    def __init__(self, spec: RRDBNetSpec):
        super().__init__()
        self.spec = spec
        nf, gc = spec.num_feat, spec.num_grow_ch
        self.conv_first = Conv3x3(spec.stem_in_ch, nf)
        self.body = nn.ModuleList(RRDB(nf, gc) for _ in range(spec.num_block))
        self.conv_body = Conv3x3(nf, nf)
        self.conv_up1 = Conv3x3(nf, nf)
        if spec.num_upsample == 2:
            self.conv_up2 = Conv3x3(nf, nf)
        self.conv_hr = Conv3x3(nf, nf)
        self.conv_last = Conv3x3(nf, spec.num_out_ch)
        self.precision = "bf16"
        self.mode = "stripe"
        self.tail = "chain"

    @torch.no_grad()
    def prepare(
        self, dtype: torch.dtype, device, precision: Optional[str] = None,
        mode: str = "stripe", tail: str = "chain",
    ) -> "RRDBNet":
        """Move the weights once to the compute dtype and device (biases
        included, as the JAX zoo casts every leaf). They stay contiguous
        HWIO, the layout K1 and K5 read, so no per-call packing is left.
        ``mode`` picks the body (:data:`MODES`). With ``precision="int8"``
        and the stripe body every RDB also quantises its cast weights (the
        W8A8 body); the pallas body ignores int8. ``tail`` picks the tail
        (:data:`TAIL_MODES`), whatever the body. ``precision`` None:
        :func:`default_precision`. Returns self."""
        if precision is None:
            precision = default_precision()
        if mode not in MODES:
            raise ValueError(f"unknown RRDBNet body mode {mode!r}")
        if tail not in TAIL_MODES:
            raise ValueError(f"unknown RRDBNet tail mode {tail!r}")
        self.to(device=device, dtype=dtype)
        self.mode = mode
        self.tail = tail
        self.precision = "bf16" if mode == "pallas" and precision == "int8" else precision
        if self.precision == "int8":
            for blk in self.body:
                for rdb in (blk.rdb1, blk.rdb2, blk.rdb3):
                    rdb.quantize()
        return self

    @torch.no_grad()
    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        spec = self.spec
        conv = conv3x3_fused_plain if plain else conv3x3_fused
        rdb = rdb_fused_plain if plain else rdb_fused
        x = x.to(self.conv_first.w.dtype)
        if spec.unshuffle and spec.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif spec.unshuffle and spec.scale == 1:
            x = pixel_unshuffle(x, 4)
        feat = conv(x, self.conv_first.w, self.conv_first.b)
        h = feat
        if self.precision == "int8":
            rdb = rdb_fused_i8_plain if plain else rdb_fused_i8
            amax = (act_amax_plain if plain else act_amax)(h)
            for blk in self.body:
                out, a = rdb(h, **blk.rdb1.int8_weights(), x_amax=amax)
                out, a = rdb(out, **blk.rdb2.int8_weights(), x_amax=a)
                h, amax = rdb(out, **blk.rdb3.int8_weights(), x0=h, x_amax=a)
        elif self.mode == "pallas":
            rrdb = rrdb_fused_plain if plain else rrdb_fused
            for blk in self.body:
                h = rrdb(h, blk.weights())
        else:
            for blk in self.body:
                out = rdb(h, *blk.rdb1.weights())
                out = rdb(out, *blk.rdb2.weights())
                h = rdb(out, *blk.rdb3.weights(), x0=h)
        feat = conv(h, self.conv_body.w, self.conv_body.b, feat)
        up1 = up1_fused_plain if plain else up1_fused
        feat = up1(feat, self.conv_up1.w, self.conv_up1.b)
        if spec.num_upsample == 2:
            if self.tail == "q":
                tail = tail_fused_q_plain if plain else tail_fused_q
            else:
                tail = tail_fused_plain if plain else tail_fused
            return tail(
                feat,
                self.conv_up2.w, self.conv_up2.b,
                self.conv_hr.w, self.conv_hr.b,
                self.conv_last.w, self.conv_last.b,
            )
        feat = conv(feat, self.conv_hr.w, self.conv_hr.b, act="lrelu")
        return conv(feat, self.conv_last.w, self.conv_last.b)

    def forward_train(self, x: torch.Tensor, tp=None) -> torch.Tensor:
        """The differentiable forward: what the JAX ``_apply(use_pallas=False,
        stripe=False, differentiable=True)`` computes (``rrdbnet.py:1129-1134``),
        in fp32 with ``F.conv2d`` under autograd and no kernel. Every op is
        out of place: the serving path's growth buffer, written slice by
        slice, cannot be differentiated. Call it on a module built from the
        fp32 state (``ModelHandle.train_module``), not on one that
        ``prepare`` cast. ``tp``: the sharded train step's tensor-parallel
        axis (``training/train.py::TensorParallel``), where each conv whose
        weights it holds sharded computes this rank's output channels and
        gathers them. (N, H, W, 3) -> (N, H*s, W*s, 3) fp32."""
        spec = self.spec
        x = x.float()
        if spec.unshuffle and spec.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif spec.unshuffle and spec.scale == 1:
            x = pixel_unshuffle(x, 4)
        feat = _conv_nchw(x.permute(0, 3, 1, 2), self.conv_first, tp)
        h = feat
        for blk in self.body:
            out = h
            for rdb in (blk.rdb1, blk.rdb2, blk.rdb3):
                out = _rdb_train(rdb, out, tp)
            h = out * 0.2 + h
        feat = feat + _conv_nchw(h, self.conv_body, tp)
        ups = [self.conv_up1] + ([self.conv_up2] if spec.num_upsample == 2 else [])
        for up in ups:
            feat = F.leaky_relu(
                _conv_nchw(F.interpolate(feat, scale_factor=2, mode="nearest"), up, tp), 0.2
            )
        feat = F.leaky_relu(_conv_nchw(feat, self.conv_hr, tp), 0.2)
        return _conv_nchw(feat, self.conv_last, tp).permute(0, 2, 3, 1)


def _conv_nchw(x: torch.Tensor, conv: Conv3x3, tp=None, act=None) -> torch.Tensor:
    """SAME 3x3 conv of an NCHW activation with a :class:`Conv3x3`'s HWIO
    weights, differentiable in both, then ``act`` (a per-channel function,
    or None); sharded where ``tp`` holds ``conv.w`` sharded
    (:func:`_conv_hwio`)."""
    return _conv_hwio(x, conv.w, conv.b, tp if tp is not None and tp.is_sharded(conv.w) else None, act)


def _conv_hwio(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tp=None, act=None) -> torch.Tensor:
    """SAME 3x3 conv of an NCHW activation with HWIO weights ``w``, then
    ``act``. With ``tp`` (``w`` and ``b`` hold this rank's output channels
    of the sharded train step) the input goes through ``tp.enter``, and the
    rank's channels, after ``act``, through ``tp.gather``."""
    if tp is not None:
        x = tp.enter(x)
    y = F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=1)
    if act is not None:
        y = act(y)
    return tp.gather(y) if tp is not None else y


def _rdb_train(rdb: RDB, x: torch.Tensor, tp=None) -> torch.Tensor:
    """One RDB on NCHW, the JAX ``_rdb_apply``: five convs over the growing
    concatenation, LeakyReLU(0.2) after the first four, 0.2 residual."""
    feats = [x]
    for k in range(1, 5):
        feats.append(F.leaky_relu(_conv_nchw(torch.cat(feats, 1), getattr(rdb, f"conv{k}"), tp), 0.2))
    return _conv_nchw(torch.cat(feats, 1), rdb.conv5, tp) * 0.2 + x


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX RRDBNet param pytree (numpy leaves, body stacked on axis 0 as
    ``init_rrdbnet``/``convert_rrdbnet`` build it) -> :class:`RRDBNet` state
    dict (fp32)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix: str, leaf: Dict[str, Any]) -> None:
        for k in ("w", "b"):
            sd[f"{prefix}.{k}"] = torch.tensor(np.asarray(leaf[k], np.float32))

    for name in ("conv_first", "conv_body", "conv_up1", "conv_up2",
                 "conv_hr", "conv_last"):
        if name in tree:
            put(name, tree[name])
    body = tree["body"]
    nb = np.asarray(body["rdb1"]["conv1"]["w"]).shape[0]
    for i in range(nb):
        for r in ("rdb1", "rdb2", "rdb3"):
            for k in range(1, 6):
                c = body[r][f"conv{k}"]
                put(f"body.{i}.{r}.conv{k}", {"w": c["w"][i], "b": c["b"][i]})
    return sd


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """:class:`RRDBNet` state dict -> JAX RRDBNet param pytree of float32
    numpy leaves, the body stacked on axis 0: the inverse of
    :func:`params_from_jax` (a net with one upsample stage has no
    ``conv_up2``, and neither has its tree)."""

    def leaf(prefix: str) -> Dict[str, np.ndarray]:
        return {k: state[f"{prefix}.{k}"].detach().cpu().float().numpy() for k in ("w", "b")}

    tree: Dict[str, Any] = {
        name: leaf(name)
        for name in ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_hr", "conv_last")
        if f"{name}.w" in state
    }
    nb = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("body."))

    def stacked(r: str, k: int) -> Dict[str, np.ndarray]:
        blocks = [leaf(f"body.{i}.{r}.conv{k}") for i in range(nb)]
        return {p: np.stack([b[p] for b in blocks]) for p in ("w", "b")}

    tree["body"] = {
        r: {f"conv{k}": stacked(r, k) for k in range(1, 6)} for r in ("rdb1", "rdb2", "rdb3")
    }
    return tree


_LAST_GAIN = 0.005


def init_params(
    spec: RRDBNetSpec, generator: Optional[torch.Generator] = None
) -> Dict[str, torch.Tensor]:
    """Random weights (fp32 state dict): Kaiming-normal (fan_in) scaled by
    0.1 for the dense-block convs and 1.0 elsewhere, zero biases, as the
    JAX ``init_rrdbnet`` (the numbers differ: another generator) — except
    ``conv_last``, scaled by ``_LAST_GAIN`` with biases 0.5.

    Why: an untrained RRDB is close to ``1.2 x``, so the body's activations
    grow ~1.2^23 and a Kaiming ``conv_last`` puts almost every output value
    far outside [0, 1]. Clipped, such a frame is nearly all 0 or 255, and
    its few unclipped pixels sit where a huge signal crosses the range, so
    one rounding step upstream moves them by tens of levels. The small last
    layer centres a random model's output in [0, 1] like a trained one's,
    so a u8 comparison of two paths sees every pixel at a sane scale."""
    sd = {}
    for name, p in RRDBNet(spec).named_parameters():
        if name.endswith(".b"):
            fill = 0.5 if name == "conv_last.b" else 0.0
            sd[name] = torch.full(p.shape, fill)
            continue
        gain = {"conv_last.w": _LAST_GAIN}.get(
            name, 0.1 if name.startswith("body.") else 1.0
        )
        fan_in = p.shape[0] * p.shape[1] * p.shape[2]
        std = math.sqrt(2.0 / fan_in) * gain
        sd[name] = torch.randn(p.shape, generator=generator) * std
    return sd
