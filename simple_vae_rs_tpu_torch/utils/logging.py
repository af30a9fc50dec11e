"""Metric and image logging of the port (the JAX package's
``utils/logging.py``): a small protocol and its sinks.

- ``JsonlLogger``: one JSON object per ``log`` call appended to
  ``<run_dir>/metrics.jsonl``, images as PNG files (where PIL imports; without
  it images are skipped);
- ``WandbLogger``: where the ``wandb`` package imports;
- ``NullLogger``: discards everything.

Metric names are the reference's ("Loss/loss", "Metrics/SSIM_SR",
"HyperParameters/Gamma_X", ...). Values may be Python numbers or 0-dim
tensors; images are NHWC arrays or tensors in [0, 1].
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Protocol

import numpy as np


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a tensor, on any device
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


class Logger(Protocol):
    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None: ...

    def log_images(self, images: Dict[str, Any], step: Optional[int] = None) -> None: ...

    def finish(self) -> None: ...


class NullLogger:
    def log(self, metrics, step=None):
        pass

    def log_images(self, images, step=None):
        pass

    def finish(self):
        pass


class JsonlLogger:
    """One JSON object per call to ``{run_dir}/metrics.jsonl`` (keys ``_step``,
    ``_time`` and the metrics); images as PNG under ``{run_dir}/images``."""

    def __init__(self, run_dir: str) -> None:
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._fh = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    def log(self, metrics, step=None):
        rec = {"_step": step, "_time": time.time()}
        for k, v in metrics.items():
            rec[k] = float(v) if np.isscalar(v) or hasattr(v, "item") else v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def log_images(self, images, step=None):
        img_dir = os.path.join(self.run_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        for name, batch in images.items():
            arr = _numpy(batch)
            if arr.ndim == 3:
                arr = arr[None]
            for i, img in enumerate(arr):
                _save_png(os.path.join(img_dir, f"{name.replace('/', '_')}_s{step}_{i}.png"), img)

    def finish(self):
        self._fh.close()


def to_png_bytes(img: np.ndarray) -> Optional[bytes]:
    """(H, W, C) float in [0, 1] -> PNG bytes, bands [2, 1, 0] as RGB for three
    or more bands (the reference's visual convention, ``models/base.py:317``),
    the first band as gray otherwise; None without PIL."""
    try:
        from io import BytesIO

        from PIL import Image
    except ImportError:
        return None
    img = _numpy(img)
    if img.shape[-1] >= 3:
        img = img[..., [2, 1, 0]]
    else:
        img = np.repeat(img[..., :1], 3, axis=-1)
    arr = np.clip(np.nan_to_num(img) * 255.0, 0, 255).astype(np.uint8)
    buf = BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _save_png(path: str, img: np.ndarray) -> None:
    data = to_png_bytes(img)
    if data is None:
        return
    with open(path, "wb") as fh:
        fh.write(data)


class WandbLogger:
    def __init__(self, project: str, name: str, config: Dict[str, Any]) -> None:
        import wandb

        self._wandb = wandb
        self.run = wandb.init(project=project, name=name, config=config)

    def log(self, metrics, step=None):
        self.run.log({k: float(v) for k, v in metrics.items()}, step=step)

    def log_images(self, images, step=None):
        payload = {}
        for name, batch in images.items():
            arr = _numpy(batch)
            if arr.ndim == 3:
                arr = arr[None]
            payload[name] = [self._wandb.Image(np.clip(img[..., [2, 1, 0]], 0, 1))
                             for img in arr]
        self.run.log(payload, step=step)

    def finish(self):
        self.run.finish()


def make_logger(project: str, name: str, config: Dict[str, Any], run_dir: str = "runs") -> Logger:
    """wandb where it imports and starts a run, else JSONL under
    ``<run_dir>/<project>-<name>`` (as the JAX package's ``make_logger``)."""
    try:
        return WandbLogger(project, name, config)
    except Exception:  # no wandb, or a run it cannot start (no login, no network)
        return JsonlLogger(os.path.join(run_dir, f"{project}-{name}"))
