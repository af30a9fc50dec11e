"""Device health probing with a hard deadline (the JAX package's
``utils/health.py``).

An unattended entry point that touches the card should learn within a
bounded time whether the card answers, rather than hang in the CUDA runtime's
initialization: :func:`probe_backend` runs that first contact in a daemon
thread against a deadline (``python -m simple_vae_rs_tpu_torch.doctor
--budget``).

The training engine's ``scan_steps`` auto mode decides once, after the
first trained epoch, whether to fuse :data:`AUTO_SCAN_K` optimizer steps
into one dispatch, by one of two rules:

- JAX's (on the CPU): :func:`dispatch_latency` against the measured step
  time, :func:`choose_scan_steps`; fuse where one launch's round trip
  rivals computing;
- the card's: a trial at the head of the next epoch times
  :data:`AUTO_SCAN_TRIAL_WINDOWS` windows of :data:`AUTO_SCAN_TRIAL_STEPS`
  eager steps against as many replayed (``Trainer._train_epoch``), and
  :func:`choose_scan_steps_by_trial` fuses where the replay is measurably
  faster. A launch's round trip on the card is microseconds, so JAX's rule
  never fires there, while a replay takes the host out of a bfloat16 step.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Optional

import torch

from simple_vae_rs_tpu_torch.serve import resolve_device


def _device(device) -> torch.device:
    """``device``; None is the card (raises where torch sees none: the CPU
    is probed only when asked for)."""
    return resolve_device("cuda") if device is None else torch.device(device)


def _round_trip(device) -> None:
    """One trivial launch on ``device`` and its result back on the host."""
    x = torch.zeros((8, 128), device=device)
    float((x + 1).sum())


def probe_backend(budget_s: float, progress: bool = True, out=None,
                  device=None) -> Optional[float]:
    """Latency (seconds) of the first contact with ``device`` (default: the
    card): its initialization plus one
    trivial launch and the sync that fetches its result; None when that
    takes longer than ``budget_s`` or fails (the cause is printed to
    ``out``, stderr by default). It runs in a daemon thread while the caller
    waits out the budget, printing progress every 30 s with ``progress``."""
    out = out or sys.stderr
    done = threading.Event()
    latency: list = []
    error: list = []

    def run() -> None:
        try:
            t0 = time.monotonic()
            _round_trip(_device(device))
            latency.append(time.monotonic() - t0)
        except Exception as e:  # the real cause, at once: no waiting out the budget
            error.append(e)
        done.set()

    threading.Thread(target=run, daemon=True).start()
    deadline = time.monotonic() + budget_s
    while True:
        left = deadline - time.monotonic()
        if done.wait(min(30.0, max(0.0, left))):
            if error:
                print(f"device probe failed: {type(error[0]).__name__}: {error[0]}", file=out)
                return None
            return latency[0]
        if time.monotonic() >= deadline:
            return None
        if progress:
            print(f"device probe still pending ({deadline - time.monotonic():.0f}s of budget "
                  "left)", file=out)


def dispatch_latency(reps: int = 3, device=None) -> Optional[float]:
    """Warm round trip (seconds) of one trivial launch plus the sync that
    fetches its result, best of ``reps`` after a warm-up call, on ``device``
    (default: the card); None if it fails. This is what a host loop pays per dispatch. Called where the
    device has just done real work (the end of a trained epoch), so it needs
    no deadline."""
    try:
        dev = _device(device)
        _round_trip(dev)
        best = None
        for _ in range(max(1, reps)):
            t0 = time.monotonic()
            _round_trip(dev)
            dt = time.monotonic() - t0
            best = dt if best is None else min(best, dt)
        return best
    except Exception:
        return None


#: optimizer steps per replay that the auto mode engages (the JAX package's value)
AUTO_SCAN_K = 2
#: the share of a step's wall time that one dispatch's round trip must pass
#: before fusing pays
AUTO_SCAN_THRESHOLD = 0.25


def choose_scan_steps(per_step_s: float, latency_s: Optional[float]) -> int:
    """The auto mode's policy: :data:`AUTO_SCAN_K` optimizer steps per
    dispatch when the measured round trip ``latency_s`` exceeds
    :data:`AUTO_SCAN_THRESHOLD` of the step's wall time ``per_step_s``,
    else 1 (also without a measurement, or without a positive step time)."""
    if latency_s is None or per_step_s <= 0:
        return 1
    return AUTO_SCAN_K if latency_s > AUTO_SCAN_THRESHOLD * per_step_s else 1


#: the card's trial: windows of eager steps, and as many of replayed ones
AUTO_SCAN_TRIAL_WINDOWS = 2
#: steps a trial window (a multiple of :data:`AUTO_SCAN_K`)
AUTO_SCAN_TRIAL_STEPS = 4
#: the least share of the eager step that a replay must save to be kept: a
#: replay holds a memory pool of its own beside the eager cache (bfloat16
#: saves 6-31% of a step on the H100, float32 1.0-1.6%)
AUTO_SCAN_MIN_GAIN = 0.03


def choose_scan_steps_by_trial(eager_s: Optional[float], replay_s: Optional[float]) -> int:
    """The card's policy: :data:`AUTO_SCAN_K` optimizer steps per dispatch
    where the trial's median replayed step ``replay_s`` is at most (1 -
    :data:`AUTO_SCAN_MIN_GAIN`) of its median eager step ``eager_s``
    (seconds), else 1 (also without both measurements, or without positive
    times)."""
    if eager_s is None or replay_s is None or eager_s <= 0 or replay_s <= 0:
        return 1
    return AUTO_SCAN_K if replay_s <= (1.0 - AUTO_SCAN_MIN_GAIN) * eager_s else 1
