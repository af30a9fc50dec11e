"""A model family: all that the harness needs of one kind of model, on both
sides of the check, in ``families/<family>.py``, found by the
configuration's ``family``. A later family is a file added here (and its
plain reference beside ``reference/models.py``); the loops, the check and
the yardstick never branch on the family.

A family module gives:

- ``CONFIG_KEYS``: the configuration keys it reads (with :data:`INFO_KEYS`,
  every key its file may hold: any other is refused, never ignored);
- ``TERMS``: the loss terms a training step returns, ``loss`` first;
- ``port_model(cfg, dtype, device)``: the program's model;
- ``lr_patch(cfg)``: the LR pixels one patch covers;
- ``program_batch(cfg, lr_tiles, hr_tiles)``: the program's batch, made on
  the card by its data layer (``ops/patchify``);
- ``param_spec(cfg)``, ``trainable(cfg)``: the reference's leaves;
- ``streams(cfg, lr_tiles, hr_tiles)``: the reference's batch;
- ``noise_shapes(cfg, batch)``: one training step's draws, in order;
- ``loss(cfg, params, streams, noise, rounding, stats)``: the reference's terms;
- ``conv_sites(cfg, batch, part)``: every conv of a pass, for the yardstick;
- for a family that serves N-draw requests, ``draws(cfg, params, y,
  gen, samples, rounding)``.
"""

from __future__ import annotations

import importlib

# what a configuration's file may hold besides a family's CONFIG_KEYS
INFO_KEYS = frozenset({"family", "source", "reduced", "assumed", "precision", "parameters"})


def load(cfg: dict):
    """The family module of ``cfg``; raises on a family with no file and on
    a configuration key that the family does not read."""
    name = cfg["family"]
    module = f"port_bench.families.{name}"
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"no model family {name!r} (port_bench/families/{name}.py)") from None
    unknown = sorted(set(cfg) - INFO_KEYS - mod.CONFIG_KEYS)
    if unknown:
        raise ValueError(f"family {name!r} reads no configuration key {unknown}")
    return mod
