"""Shared pieces of the benchmark's tests: the repository root on the path,
and each cell's files cut to a size the CPU runs in seconds."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench.harness import cell  # noqa: E402

CELLS = ("cond_srvae.train_bf16", "vae.train_bf16", "cond_srvae.uq_bf16",
         "cond_srvae.train_f32")


def tiny_parts(name: str, dtype=None) -> dict:
    """The cell's workload, configuration and traffic mix at a CPU size: a
    Cond_SRVAE of 16-pixel patches (cr 2), a VAE of 8, tiles of 16 LR
    pixels, a pool of 8, two tiles a step, 16 draws a request. ``dtype``
    replaces the traffic's compute dtype."""
    parts = copy.deepcopy(cell.load_cell(name))
    cfg, tr = parts["config"], parts["traffic"]
    cfg.update(patch_size=8 if cfg["family"] == "vae" else 16, cr=2.0)
    tr.update(pool_tiles=8, lr_tile=16)
    if tr["loop"] == "train":
        tr.update(tiles_per_step=2)
    else:
        tr.update(samples=16, checked_requests=3)
    if dtype is not None:
        tr["dtype"] = dtype
    return parts


@pytest.fixture
def tiny():
    return tiny_parts
