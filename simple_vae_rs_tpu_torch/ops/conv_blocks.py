"""NHWC conv building blocks of the port (eval path), named as the flax tree.

- :class:`Conv3x3`: 3x3/s1 conv with bias (flax ``PallasCapableConv3x3``).
- :class:`DownBlock`: conv3x3 -> conv4x4/s2/p1 -> BatchNorm -> ReLU.
- :class:`UpBlock`: conv3x3 -> convT4x4/s2/p1 -> BatchNorm -> ReLU.

Weights keep the JAX layouts: conv kernels HWIO ``(kh, kw, C, O)`` and the
transposed-conv kernel in its input-dilated, spatially flipped form. In eval
the strided tail of a block folds BatchNorm into ``(scale, shift)`` and runs
as one fused kernel (``ops/fused_conv.py``). Only the eval path is ported;
a block in training mode raises.

:func:`use_plain_path` switches a model's convs to the kernels' plain
versions: the reference that the kernels are held against on the card.
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


class _Eval(nn.Module):
    """Eval-only module: ``plain`` routes its convs to the plain versions."""

    plain = False

    def _require_eval(self) -> None:
        if self.training:
            raise NotImplementedError(
                f"{type(self).__name__}: only the eval path is ported; call .eval()"
            )


class ConvWeights(nn.Module):
    """Kernel ``(k, k, C, O)`` and bias ``(O,)`` of a conv (flax ``kernel``/``bias``)."""

    def __init__(self, k: int, in_features: int, features: int, fan: int,
                 device=None) -> None:
        super().__init__()
        self.fan = fan  # torch-default init: U(+-1/sqrt(fan)) for both
        self.kernel = nn.Parameter(torch.empty(k, k, in_features, features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def reset_parameters(self, rng: np.random.Generator) -> None:
        bound = 1.0 / math.sqrt(self.fan)
        _uniform_(self.kernel, rng, bound)
        _uniform_(self.bias, rng, bound)


class Conv3x3(ConvWeights, _Eval):
    """3x3/s1 SAME conv with bias, through the fused 3x3 kernel."""

    def __init__(self, in_features: int, features: int, device=None) -> None:
        super().__init__(3, in_features, features, in_features * 9, device=device)
        self.register_buffer("unit_scale", torch.ones(features, device=device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = fc.conv3x3_plain if self.plain else fc.fused_conv3x3_bn_relu
        return fn(x, self.kernel, self.unit_scale, self.bias, False)


class BatchNorm(nn.Module):
    """BatchNorm parameters (``scale``, ``bias``) and running statistics
    (``mean``, ``var``), eps 1e-5; used in eval, folded into the conv before it."""

    eps = 1e-5

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

    def fold(self, conv: ConvWeights):
        """``(kernel, scale, shift)`` of ``conv`` followed by this BatchNorm."""
        return fc.fold_conv_bn(conv.kernel, conv.bias, self.scale, self.bias,
                               self.mean, self.var, self.eps)


class DownBlock(_Eval):
    """conv3x3 -> strided conv4x4 (spatial /2) -> BN -> ReLU (reference
    ``models/layers.py:217-256``); the tail is one fused 4x4/s2 kernel."""

    def __init__(self, in_features: int, features: int, device=None) -> None:
        super().__init__()
        self.conv = Conv3x3(in_features, in_features, device=device)
        self.downsample = ConvWeights(4, in_features, features, in_features * 16,
                                      device=device)
        self.bn = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._require_eval()
        x = self.conv(x)
        kernel, s, t = self.bn.fold(self.downsample)
        fn = fc.conv4x4s2_plain if self.plain else fc.fused_conv4x4s2_bn_relu
        return fn(x, kernel, s, t, True)


class UpBlock(_Eval):
    """conv3x3 -> convT4x4 (spatial *2) -> BN -> ReLU (reference
    ``models/layers.py:259-297``); the tail is one fused convT kernel."""

    def __init__(self, in_features: int, features: int, device=None) -> None:
        super().__init__()
        self.conv = Conv3x3(in_features, in_features, device=device)
        # torch's init fan for a transposed conv is out * kh * kw
        self.upsample = ConvWeights(4, in_features, features, features * 16,
                                    device=device)
        self.bn = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._require_eval()
        x = self.conv(x)
        kernel, s, t = self.bn.fold(self.upsample)
        fn = fc.convT4x4s2_plain if self.plain else fc.fused_convT4x4s2_bn_relu
        return fn(x, kernel, s, t, True)


def use_plain_path(model: nn.Module, plain: bool = True) -> None:
    """Route every conv of ``model`` through the plain versions (``True``)
    or the fused kernels (``False``, the default)."""
    for mod in model.modules():
        if isinstance(mod, _Eval):
            mod.plain = plain
