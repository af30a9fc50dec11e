"""The learning-rate schedule of the epoch loop (port of the JAX package's
``train/schedule.py``): ``ReduceLROnPlateau`` on the epoch's val loss, with
``torch.optim.lr_scheduler.ReduceLROnPlateau``'s defaults (relative threshold
1e-4, no cooldown, min_lr 0), as the reference configures it
(``models/base.py:51-53``). The learning rate is a plain number the trainer
passes to each step, so the optimizer state never changes with it."""

from __future__ import annotations


class ReduceLROnPlateau:
    """Multiply the learning rate by ``factor`` once the metric has not
    improved for more than ``patience`` epochs."""

    def __init__(self, lr: float, mode: str = "min", factor: float = 0.5,
                 patience: int = 500, threshold: float = 1e-4, min_lr: float = 0.0) -> None:
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.lr = lr
        self.best = float("inf") if mode == "min" else float("-inf")
        self.num_bad_epochs = 0
        self.last_epoch = 0

    def _is_better(self, metric: float) -> bool:
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        """Advance one epoch with the monitored metric; returns the lr."""
        self.last_epoch += 1
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def get_last_lr(self):
        """torch's accessor (reference ``vae.py:225``)."""
        return [self.lr]

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad_epochs": self.num_bad_epochs,
                "last_epoch": self.last_epoch}

    def load_state_dict(self, state: dict) -> None:
        self.lr = state["lr"]
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]
        self.last_epoch = state["last_epoch"]
