"""NHWC conv building blocks of the port, named as the flax tree.

- :class:`Conv3x3`: 3x3/s1 conv with bias (flax ``PallasCapableConv3x3``).
- :class:`DownBlock`: conv3x3 -> conv4x4/s2/p1 -> BatchNorm -> ReLU.
- :class:`UpBlock`: conv3x3 -> convT4x4/s2/p1 -> BatchNorm -> ReLU.

Weights keep the JAX layouts: conv kernels HWIO ``(kh, kw, C, O)`` and the
transposed-conv kernel in its input-dilated, spatially flipped form. Every
conv runs through a fused kernel (``ops/fused_conv.py``), forward and input
gradient, in both modes:

- training (``module.train()``): the strided conv runs with its bias as the
  shift, then :class:`BatchNorm` normalises with the batch statistics and
  updates the running ones, then ReLU;
- eval: the strided tail of a block folds BatchNorm's running statistics
  into ``(scale, shift)`` and runs as one fused kernel with the ReLU.

:func:`use_plain_path` switches a model's convs (and its ELBO reductions) to
the kernels' plain versions: the reference that the kernels are held
against on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from simple_vae_rs_tpu_torch.ops import fused_conv as fc


def _uniform_(param: torch.Tensor, rng: np.random.Generator, bound: float) -> None:
    vals = rng.uniform(-bound, bound, tuple(param.shape)).astype(np.float32)
    with torch.no_grad():
        param.copy_(torch.from_numpy(vals))


class Routed(nn.Module):
    """A module whose convs run through the fused kernels, or through their
    plain versions when ``plain`` is set (:func:`use_plain_path`)."""

    plain = False


class ConvWeights(nn.Module):
    """Kernel ``(k, k, C, O)`` and bias ``(O,)`` of a conv (flax ``kernel``/``bias``)."""

    def __init__(self, k: int, in_features: int, features: int, fan: int,
                 device=None) -> None:
        super().__init__()
        self.fan = fan  # torch-default init: U(+-1/sqrt(fan)) for both
        self.kernel = nn.Parameter(torch.empty(k, k, in_features, features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        # the fused kernels' scale when the conv runs with its bias alone
        self.register_buffer("unit_scale", torch.ones(features, device=device),
                             persistent=False)

    def reset_parameters(self, rng: np.random.Generator) -> None:
        bound = 1.0 / math.sqrt(self.fan)
        _uniform_(self.kernel, rng, bound)
        _uniform_(self.bias, rng, bound)


class Conv3x3(ConvWeights, Routed):
    """3x3/s1 SAME conv with bias, through the fused 3x3 kernel."""

    def __init__(self, in_features: int, features: int, device=None) -> None:
        super().__init__(3, in_features, features, in_features * 9, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fc.fused_conv("fused_conv3x3_bn_relu", x, self.kernel, self.unit_scale,
                             self.bias, False, self.plain)


class BatchNorm(nn.Module):
    """BatchNorm parameters (``scale``, ``bias``) and running statistics
    (``mean``, ``var``), eps 1e-5, as flax ``nn.BatchNorm(momentum=0.9)``
    configures it (JAX ``conv_blocks.batch_norm``).

    Called, it normalises with the batch statistics over (B, H, W): the
    biased ``var = max(0, E[x^2] - E[x]^2)``, the gradient flowing through
    both, and updates the running statistics in place to
    ``0.9 * old + 0.1 * batch`` with that same biased variance (not
    ``nn.BatchNorm2d``, whose running variance is unbiased). In eval it is
    folded into the conv before it (:meth:`fold`).
    """

    eps = 1e-5
    momentum = 0.9

    def __init__(self, features: int, device=None) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("mean", torch.empty(features, device=device))
        self.register_buffer("var", torch.empty(features, device=device))

    def reset_parameters(self, rng: Optional[np.random.Generator] = None) -> None:
        del rng  # flax's BatchNorm init is deterministic
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = (0, 1, 2)
        mean = x.mean(dim=dims)
        var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
        with torch.no_grad():
            self.mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        return (x - mean) * (self.scale * torch.rsqrt(var + self.eps)) + self.bias

    def fold(self, conv: ConvWeights):
        """``(kernel, scale, shift)`` of ``conv`` followed by this BatchNorm."""
        return fc.fold_conv_bn(conv.kernel, conv.bias, self.scale, self.bias,
                               self.mean, self.var, self.eps)


class _Block(Routed):
    """conv3x3 -> strided tail conv -> BN -> ReLU; subclasses name the tail."""

    _kernel = ""  # fused_conv kernel of the tail
    _tail_name = ""  # flax name of the tail conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        tail = getattr(self, self._tail_name)
        if self.training:
            h = fc.fused_conv(self._kernel, x, tail.kernel, tail.unit_scale, tail.bias,
                              False, self.plain)
            return torch.relu(self.bn(h))
        kernel, s, t = self.bn.fold(tail)
        return fc.fused_conv(self._kernel, x, kernel, s, t, True, self.plain)


class DownBlock(_Block):
    """conv3x3 -> strided conv4x4 (spatial /2) -> BN -> ReLU (reference
    ``models/layers.py:217-256``); in eval the tail is one fused 4x4/s2 kernel."""

    _kernel = "fused_conv4x4s2_bn_relu"
    _tail_name = "downsample"

    def __init__(self, in_features: int, features: int, device=None) -> None:
        super().__init__()
        self.conv = Conv3x3(in_features, in_features, device=device)
        self.downsample = ConvWeights(4, in_features, features, in_features * 16,
                                      device=device)
        self.bn = BatchNorm(features, device=device)


class UpBlock(_Block):
    """conv3x3 -> convT4x4 (spatial *2) -> BN -> ReLU (reference
    ``models/layers.py:259-297``); in eval the tail is one fused convT kernel."""

    _kernel = "fused_convT4x4s2_bn_relu"
    _tail_name = "upsample"

    def __init__(self, in_features: int, features: int, device=None) -> None:
        super().__init__()
        self.conv = Conv3x3(in_features, in_features, device=device)
        # torch's init fan for a transposed conv is out * kh * kw
        self.upsample = ConvWeights(4, in_features, features, features * 16,
                                    device=device)
        self.bn = BatchNorm(features, device=device)


def use_plain_path(model: nn.Module, plain: bool = True) -> None:
    """Route every conv of ``model`` (forward and input gradient) and its
    ELBO reductions through the plain versions (``True``) or the kernels
    (``False``, the default)."""
    for mod in model.modules():
        if isinstance(mod, Routed):
            mod.plain = plain
