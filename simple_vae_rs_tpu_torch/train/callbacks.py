"""Epoch callbacks of the port (the JAX package's ``train/callbacks.py``,
after the reference's ``callbacks.py:9-153``): hooks that return True to stop
training, ``EarlyStopping`` and ``ModelCheckpoint``.

Both resolve their monitor against the logged keys with difflib's fuzzy
match: the reference's ``"val_loss"`` names ``"Loss/val_loss"``, the key the
engine logs (upstream EarlyStopping's exact key never matched, so it never
fired; here it does). ``ModelCheckpoint`` writes the port's checkpoint
(``train/checkpoint.py``) of the trainer it is handed.
"""

from __future__ import annotations

import abc
from difflib import get_close_matches
from typing import Any, Dict

from simple_vae_rs_tpu_torch.train import checkpoint


class Callback(abc.ABC):
    """Hooks called with keyword arguments; True stops training."""

    @abc.abstractmethod
    def on_epoch_begin(self, **kwargs) -> bool:
        return False

    @abc.abstractmethod
    def on_epoch_end(self, **kwargs) -> bool:
        return False


class EarlyStopping(Callback):
    """Stop when the monitored val loss has not improved by more than
    ``delta`` for ``patience`` epochs. A value within ``delta`` of the best
    neither resets nor advances the counter (the reference's dead band)."""

    def __init__(self, patience: int = 10, delta: float = 0.0,
                 monitor: str = "Loss/val_loss") -> None:
        self.patience = patience
        self.delta = delta
        self.monitor = monitor
        self.counter = 0
        self.best_loss = float("inf")
        self.best_epoch = 0
        self._resolved = False

    def on_epoch_begin(self, **kwargs) -> bool:
        return False

    def _resolve_monitor(self, logs: Dict[str, float]) -> None:
        if self.monitor not in logs:
            matches = get_close_matches(self.monitor, logs.keys(), n=1, cutoff=0)
            if not matches:
                raise ValueError(
                    f"EarlyStopping monitor '{self.monitor}' not found and no "
                    f"logs to match against. Available: {list(logs.keys())}"
                )
            self.monitor = matches[0]
        self._resolved = True

    def on_epoch_end(self, **kwargs) -> bool:
        logs: Dict[str, float] = kwargs.get("logs", {})
        if not logs:
            return False
        if not self._resolved:
            self._resolve_monitor(logs)
        current = logs.get(self.monitor)
        if current is None:
            return False
        if current < self.best_loss - self.delta:
            self.best_loss = current
            self.best_epoch = kwargs.get("epoch", 0)
            self.counter = 0
        elif current > self.best_loss + self.delta:
            self.counter += 1
        return self.counter >= self.patience


class ModelCheckpoint(Callback):
    """Save the trainer's checkpoint to ``<save_path>/<job_id>`` when the
    monitored metric improves (``save_best_only``), else to
    ``<save_path>/<job_id>_epoch_<n>`` every epoch. The monitor is resolved
    at epoch 1. ``async_save`` writes on the checkpoint module's writer
    thread; ``Trainer.fit`` waits for it on exit."""

    def __init__(self, job_id: str, save_path: str, monitor: str = "val_loss",
                 mode: str = "min", save_best_only: bool = True,
                 async_save: bool = False) -> None:
        self.job_id = job_id
        self.save_path = save_path
        self.monitor = monitor
        self.mode = mode
        self.save_best_only = save_best_only
        self.async_save = async_save
        self.best_metric = float("inf") if mode == "min" else float("-inf")
        self.best_epoch = 0

    def on_epoch_begin(self, **kwargs) -> bool:
        return False

    def _resolve_monitor(self, logs: Dict[str, float]) -> None:
        if self.monitor not in logs:
            matches = get_close_matches(self.monitor, logs.keys(), n=1, cutoff=0)
            if not matches:
                raise ValueError(
                    f"Monitor metric '{self.monitor}' not found in logs. "
                    f"Available metrics: {list(logs.keys())}"
                )
            self.monitor = matches[0]

    def on_epoch_end(self, **kwargs) -> bool:
        logs: Dict[str, float] = kwargs.get("logs", {})
        epoch: int = kwargs.get("epoch", 0)
        trainer = kwargs.get("trainer")
        extra: Dict[str, Any] = kwargs.get("extra", {})
        if trainer is None:
            return False
        if epoch == 1:
            self._resolve_monitor(logs)
        current = logs.get(self.monitor, float("inf"))
        if not self.save_best_only:
            checkpoint.save_checkpoint(f"{self.save_path}/{self.job_id}_epoch_{epoch}",
                                       trainer, epoch=epoch, extra=extra,
                                       block=not self.async_save)
            return False
        if (self.mode == "min" and current < self.best_metric) or (
                self.mode == "max" and current > self.best_metric):
            self.best_metric = current
            self.best_epoch = epoch
            checkpoint.save_checkpoint(f"{self.save_path}/{self.job_id}", trainer, epoch=epoch,
                                       extra=extra, block=not self.async_save)
        return False
