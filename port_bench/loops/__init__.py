"""The loops a traffic mix drives, one a file (``loops/<loop>.py``), found by
the mix's ``loop`` key; each drives the program under test,
``simple_vae_rs_tpu_torch``, and the plain reference over the same work.
A later kind of traffic is a file added here; the harness (``cell.py``)
never branches on the loop.

A loop module gives a class ``Loop(cfg, traffic, seed, device)`` with:

- ``kind``: what the per-layer readers see as ``ctx["kind"]``;
- ``KEYS``: every key of its traffic mix besides :data:`HARNESS_KEYS`
  (any other, or one missing, is refused, never ignored);
- ``plant``: None, or a fault of ``harness/faults.py`` that ``setup``
  applies once the program exists;
- ``setup()``: builds the program from the seed and warms every shape the
  window uses; ``setup_parts``, the seconds of its phases;
- ``window(seconds)``: measures; returns ``units`` (what the per-layer
  metrics count), ``attempted``, ``failed``, ``elapsed_s`` and the cell's
  end-to-end metrics by name;
- ``work()``: one unit's operations and conv bound (``harness/work.py``);
- ``program_records(result)``: the program's records of the work the check
  compares, after the window; frees the program;
- ``reference_records(rounding)``: the reference's records of that work
  (``rounding`` the precision of its convs: the control's, or float32);
- ``compare(program, reference)``: the numbers the workload's limits hold.
"""

from __future__ import annotations

import importlib
from typing import Iterable

import torch

HARNESS_KEYS = ("loop",)  # the traffic keys the harness reads itself


def load(name: str):
    """The ``Loop`` of ``loops/<name>.py``."""
    module = f"port_bench.loops.{name}"
    try:
        return importlib.import_module(module).Loop
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"no loop {name!r} (port_bench/loops/{name}.py)") from None


def check_keys(traffic: dict, keys: Iterable[str], loop: str) -> None:
    """Refuse a traffic mix with a key the loop does not read, or without
    one it does."""
    keys = set(keys) | set(HARNESS_KEYS)
    unknown, missing = sorted(set(traffic) - keys), sorted(keys - set(traffic))
    if unknown or missing:
        raise ValueError(f"loop {loop!r}: traffic keys not read {unknown}, missing {missing}")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    return torch.profiler.record_function(name)
