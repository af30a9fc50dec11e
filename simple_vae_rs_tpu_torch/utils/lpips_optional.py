"""LPIPS where its weights are on disk, else nothing (the JAX package's
``utils/lpips_optional.py`` with its npz backend only).

The JAX module's second backend, ``lpips.LPIPS(net="alex")``, downloads
torchvision's AlexNet weights on first use; this module never downloads:
without the ``.npz`` (``ops/lpips.weights_path``) :func:`load` gives None and
the trainer leaves the LPIPS metrics out.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from simple_vae_rs_tpu_torch.ops import lpips as lp

Tensor = torch.Tensor


def load(device) -> Optional[Dict[str, Tensor]]:
    """The LPIPS weights as tensors on ``device``, or None without a weights
    file."""
    params = lp.load_weights()
    if params is None:
        return None
    return {k: torch.from_numpy(v).to(device) for k, v in params.items()}


def lpips_batch(a: Tensor, b: Tensor, params: Optional[Dict[str, Tensor]]) -> Optional[Tensor]:
    """Per-image LPIPS of NHWC batches (BGR as the reference), or None
    without weights or for images below AlexNet's footprint."""
    if params is None or min(a.shape[1], a.shape[2]) < lp.MIN_INPUT:
        return None
    return lp.lpips(a, b, params)
