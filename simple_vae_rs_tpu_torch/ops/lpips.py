"""LPIPS (AlexNet) perceptual distance in plain PyTorch (port of the JAX
package's ``ops/lpips.py``, which computes it with ``lax.conv``, not Pallas).

The reference computes LPIPS-alex through the ``lpips`` package on BGR
images (``models/base.py:37``, ``models/vae.py:170-172``). Here, on the
images' device:

- the scaling layer ``(x - shift) / scale``, the [0, 1] images fed as the
  reference feeds them;
- AlexNet's feature stack: five conv + ReLU taps, a 3x3/s2 max pool after
  the first two (skipped where fewer than 3 pixels remain);
- per tap: each pixel's channel vector divided by its norm plus 1e-10 (eps
  outside the sqrt, as ``lpips.normalize_tensor``), the squared difference,
  the non-negative 1x1 calibration weights, the spatial mean; summed over
  taps.

LPIPS is learned: it needs the pretrained weights as an ``.npz``
(``SVRS_LPIPS_WEIGHTS``, or ``~/.cache/svrs_lpips_alex.npz``; the JAX
package's ``scripts/export_lpips_weights.py`` writes one on a machine with
the ``lpips`` package): ``conv{i}_w`` (O, I, kh, kw), ``conv{i}_b``,
``lin{i}``, ``shift``, ``scale``. Without it ``utils/lpips_optional`` skips
the metric.
"""

from __future__ import annotations

import os
import zipfile
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# AlexNet ``features`` (torchvision): output channels, kernel, stride, padding
_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
_POOL_AFTER = (0, 1)
MIN_INPUT = 11  # AlexNet's first kernel: a smaller input has no output
DEFAULT_WEIGHTS = os.path.expanduser("~/.cache/svrs_lpips_alex.npz")


def weights_path() -> str:
    return os.environ.get("SVRS_LPIPS_WEIGHTS", DEFAULT_WEIGHTS)


def load_weights(path: Optional[str] = None) -> Optional[Dict[str, np.ndarray]]:
    """The weights ``.npz`` as float32 arrays (conv weights in torch's (O, I,
    kh, kw) layout); None when the file is absent or not AlexNet's."""
    path = path or weights_path()
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            params = {k: np.asarray(z[k], np.float32) for k in z.files}
        for i, (out, *_) in enumerate(_CONVS):
            if params[f"conv{i}_w"].shape[0] != out:
                return None
            params[f"lin{i}"] = params[f"lin{i}"].reshape(-1)
        params["shift"] = params["shift"].reshape(3)
        params["scale"] = params["scale"].reshape(3)
    except (KeyError, ValueError, OSError, zipfile.BadZipFile):
        return None
    return params


def _prep(x: Tensor) -> Tensor:
    """NHWC, any band count -> NCHW RGB: bands [2, 1, 0] for three or more
    (the reference's BGR convention), the first band three times otherwise."""
    x = x.float()
    x = x[..., [2, 1, 0]] if x.shape[-1] >= 3 else x[..., :1].expand(*x.shape[:-1], 3)
    return x.permute(0, 3, 1, 2)


def _features(x: Tensor, params: Dict[str, Tensor]) -> list:
    h = (x - params["shift"].view(1, 3, 1, 1)) / params["scale"].view(1, 3, 1, 1)
    taps = []
    for i, (_, _, stride, pad) in enumerate(_CONVS):
        h = torch.relu(F.conv2d(h, params[f"conv{i}_w"], params[f"conv{i}_b"], stride=stride,
                                padding=pad))
        taps.append(h)
        if i in _POOL_AFTER and min(h.shape[2], h.shape[3]) >= 3:
            h = F.max_pool2d(h, 3, stride=2)
    return taps


def lpips(a: Tensor, b: Tensor, params: Dict[str, Tensor]) -> Tensor:
    """Per-image LPIPS of NHWC batches (any band count): (B,) float32.
    ``params``: :func:`load_weights`'s arrays as tensors on the images'
    device."""
    if min(a.shape[1], a.shape[2]) < MIN_INPUT:
        raise ValueError(f"LPIPS(alex) needs inputs >= {MIN_INPUT}px; got {tuple(a.shape)}")
    total = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    for i, (fa, fb) in enumerate(zip(_features(_prep(a), params), _features(_prep(b), params))):
        na = fa / (torch.sqrt((fa * fa).sum(dim=1, keepdim=True)) + 1e-10)
        nb = fb / (torch.sqrt((fb * fb).sum(dim=1, keepdim=True)) + 1e-10)
        d = (na - nb) ** 2
        total = total + (d * params[f"lin{i}"].view(1, -1, 1, 1)).sum(dim=1).mean(dim=(1, 2))
    return total
