"""Auto-planned down- and upsample sequences from a compression ratio (the
JAX package's ``ops/sequences.py``, a sound redesign of the reference's dead
``models/layers.py:25-214``). No shipped model uses them; they are part of
the layer API.

- :class:`DownsampleSequence`: K stride-2 stages (:class:`DownBlock`, the
  last without ReLU; an optional :class:`SelfAttention2D` after each), the
  channels growing toward a count that makes the flattened output
  ``round(prod(shape) / cr)`` on the final grid.
- :class:`UpsampleSequence`: the largest square grid that divides the flat
  input, then K stride-2 :class:`UpBlock` stages (the last without
  BatchNorm and ReLU) to the target shape, a 3x3 ``proj`` where the
  channels differ, and a sigmoid in float32.

The blocks run the port's conv kernels (#1, #5, #6) as the models' do;
training or eval mode is the module's (``.train()`` / ``.eval()``), where
JAX takes ``train=``. Parameters carry the flax names (``down{i}``,
``attn{i}``, ``up{i}``, ``proj``), so ``utils/jax_weights`` loads JAX's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from simple_vae_rs_tpu_torch.ops.attention import SelfAttention2D
from simple_vae_rs_tpu_torch.ops.conv_blocks import (
    Conv3x3,
    DownBlock,
    Routed,
    UpBlock,
    reset_parameters,
    set_dtype,
)

Tensor = torch.Tensor


def plan_downsample(in_shape: Tuple[int, int, int], compression_ratio: float,
                    num_steps: Optional[int]) -> Tuple[int, List[int], int]:
    """-> (steps, channel schedule, out_flat_size); ``in_shape`` = (H, W, C)."""
    h, w, c = in_shape
    target_flat = int(round(h * w * c / compression_ratio))
    steps = num_steps
    if steps is None:
        # halve the grid until the per-position channel target is reasonable
        steps = 0
        th = h
        while th > 4 and th % 2 == 0 and steps < 4:
            th //= 2
            steps += 1
    if h % (1 << steps) or w % (1 << steps):
        raise ValueError(f"spatial {h}x{w} not divisible by 2^{steps}")
    gh, gw = h >> steps, w >> steps
    out_channels = max(1, target_flat // (gh * gw))
    schedule = []
    ch = c
    for i in range(steps):
        ch = out_channels if i == steps - 1 else min(out_channels, ch * 4)
        schedule.append(ch)
    return steps, schedule, out_channels * gh * gw


def plan_upsample(in_size: int, out_shape: Tuple[int, int, int], num_steps: Optional[int]
                  ) -> Tuple[int, int, List[int]]:
    """-> (steps, in_channels, channel schedule); ``out_shape`` = (H, W, C)."""
    h, w, c = out_shape
    max_steps = 0
    th = h
    while th > 1 and th % 2 == 0:
        th //= 2
        max_steps += 1
    # the largest square grid (fewest steps) whose size divides in_size
    candidates = range(num_steps, num_steps + 1) if num_steps else range(0, max_steps + 1)
    for steps in candidates:
        gh, gw = h >> steps, w >> steps
        if gh and gw and h % (1 << steps) == 0 and in_size % (gh * gw) == 0:
            in_channels = in_size // (gh * gw)
            schedule = [c if i == steps - 1 else max(c, in_channels // (4 ** (i + 1)))
                        for i in range(steps)]
            return steps, in_channels, schedule
    raise ValueError(f"in_size {in_size} admits no square grid dividing output {h}x{w}")


class DownsampleSequence(Routed):
    """Auto-planned encoder stack: (B, H, W, C) -> a flat (B, out_size) embedding."""

    def __init__(self, in_shape: Tuple[int, int, int], compression_ratio: float,
                 num_steps: Optional[int] = None, with_attention: bool = False,
                 attention_heads: int = 2, device=None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.steps, schedule, self.out_size = plan_downsample(tuple(in_shape),
                                                              compression_ratio, num_steps)
        self.with_attention = with_attention
        c = in_shape[2]
        for i, ch in enumerate(schedule):
            self.add_module(f"down{i}", DownBlock(c, ch, device=device,
                                                  with_relu=i < self.steps - 1))
            if with_attention:
                self.add_module(f"attn{i}", SelfAttention2D(ch, num_heads=min(attention_heads, ch),
                                                            device=device))
            c = ch
        set_dtype(self, dtype)

    def init_weights(self, seed: int) -> "DownsampleSequence":
        reset_parameters(self, np.random.default_rng(seed))
        return self

    def forward(self, x: Tensor) -> Tensor:
        for i in range(self.steps):
            x = getattr(self, f"down{i}")(x)
            if self.with_attention:
                x = getattr(self, f"attn{i}")(x)
        return x.reshape(x.shape[0], -1)


class UpsampleSequence(Routed):
    """Auto-planned decoder stack: a flat (B, in_size) -> (B, H, W, C) in
    [0, 1], float32."""

    def __init__(self, in_size: int, out_shape: Tuple[int, int, int],
                 num_steps: Optional[int] = None, device=None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.in_size, self.out_shape = in_size, tuple(out_shape)
        self.steps, self.in_channels, schedule = plan_upsample(in_size, self.out_shape,
                                                               num_steps)
        c_out = self.out_shape[2]
        c = self.in_channels
        for i, ch in enumerate(schedule):
            last = i == self.steps - 1
            self.add_module(f"up{i}", UpBlock(c, ch, device=device, with_relu=not last,
                                              with_bn=not last))
            c = ch
        self.proj = Conv3x3(c, c_out, device=device) if self.steps == 0 or c != c_out else None
        set_dtype(self, dtype)

    def init_weights(self, seed: int) -> "UpsampleSequence":
        reset_parameters(self, np.random.default_rng(seed))
        return self

    def forward(self, z: Tensor) -> Tensor:
        h, w, _ = self.out_shape
        x = z.reshape(z.shape[0], h >> self.steps, w >> self.steps, self.in_channels)
        for i in range(self.steps):
            x = getattr(self, f"up{i}")(x)
        if self.proj is not None:
            x = self.proj(x)
        return torch.sigmoid(x.float())
