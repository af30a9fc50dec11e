"""Multi-head self-attention over the H*W token grid of a feature map (the
JAX package's ``ops/attention.py``, after the reference's
``models/layers.py:300-354``): 1x1-conv query, key and value projections,
scaled dot-product attention per head over the flattened spatial tokens, a
1x1-conv output projection and the residual. No shipped model uses it; it is
part of the layer API. JAX runs it through ``jax.nn.dot_product_attention``,
no Pallas kernel, so the port runs it in plain PyTorch
(``F.scaled_dot_product_attention``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from simple_vae_rs_tpu_torch.ops.conv_blocks import ConvWeights, Routed

Tensor = torch.Tensor


class Conv1x1(ConvWeights, Routed):
    """1x1 conv with bias, NHWC (flax ``nn.Conv`` of kernel ``(1, 1, C, O)``),
    in the compute dtype; torch's default init (fan = C)."""

    def __init__(self, in_features: int, features: int, device=None) -> None:
        super().__init__(1, in_features, features, in_features, "", device=device)

    def forward(self, x: Tensor) -> Tensor:
        dt = self.dtype
        return x.to(dt) @ self.kernel[0, 0].to(dt) + self.bias.to(dt)


class SelfAttention2D(Routed):
    """Convolutional multi-head self-attention with a residual connection
    (flax ``SelfAttention2D(features, num_heads)``; parameters ``query``,
    ``key``, ``value`` and ``out``)."""

    def __init__(self, features: int, num_heads: int = 8, device=None) -> None:
        super().__init__()
        if features % num_heads != 0:
            raise ValueError("features must be divisible by num_heads")
        self.features, self.num_heads = features, num_heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Conv1x1(features, features, device=device))

    def forward(self, x: Tensor) -> Tensor:
        b, h, w, c = x.shape
        hd = self.features // self.num_heads

        def heads(t: Tensor) -> Tensor:  # (B, heads, H*W tokens, head_dim)
            return t.reshape(b, h * w, self.num_heads, hd).transpose(1, 2)

        out = F.scaled_dot_product_attention(heads(self.query(x)), heads(self.key(x)),
                                             heads(self.value(x)))
        out = out.transpose(1, 2).reshape(b, h, w, c)
        return self.out(out) + x
