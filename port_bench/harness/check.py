"""The comparison that decides ``correct``: the program's records of the
timed path against the plain reference's, as numbers that each have a
limit (the cell's workload file holds the limits, and ``PERF.md`` the
readings they were set from).

Training (the checked steps, which run through the window's own call):

- ``loss_gap``: the largest ``|L - L_ref| / |L_ref|`` over the steps;
- ``terms_gap``: the same over the steps and each term of the loss but the
  sum (Cond_SRVAE's ``mse_x``, ``kld_u``, ``mse_y``, ``kld_z``; the VAE's
  ``mse``, ``kld``), each against its own reference value, so a term small
  beside the others is seen on its own;
- ``moment_gap``: Adam's first moment after the first call (the clipped
  first gradient, times 0.1, after one step; after a call of two steps its
  mix of the first two), by the worst leaf: ``| |m| - |m_ref| |`` over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
- ``change_gap``: the parameters' change over the checked steps, by the
  worst leaf in the same way, leaving out the leaves whose first gradient
  in the reference is under a thousandth of the median leaf's (a conv's
  bias before BatchNorm: its gradient is nought but round-off, and Adam
  moves it by round-off alone);
- ``moment_gap_median``, ``change_gap_median``: the same by the median leaf;
- ``failed_steps`` (``loops/train.py``): the window's steps whose terms were
  not finite, each one a step that says the wrong thing.

A cell compares the numbers its workload file gives a limit; the others
are read (``calibrate.py``) and not compared.

Requests (a sample of the window's, drawn from the seed):

- ``mean_gap``: the largest ``|mean - mean_ref|`` over the pixels of the
  sampled requests' mean maps (outputs in [0, 1]);
- ``std_gap``: the largest ``|std - std_ref|`` over the std maps, over the
  largest ``std_ref`` of that request.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

TINY_GRAD = 1e-3  # of the median leaf's first gradient: a leaf left out of change_gap


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> List[float]:
    med = statistics.median(ref[n] for n in leaves)
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-300) for n in leaves]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Each number by the worst leaf (``*_gap``) and by the median leaf
    (``*_gap_median``: steady from seed to seed where one small leaf's
    noise sets the worst), and ``loss_gap`` and ``terms_gap`` over the
    steps (``prog["terms"]`` and ``ref["terms"]``: a dict of terms a step)."""
    if len(prog["terms"]) != len(ref["terms"]):
        raise ValueError(f"{len(prog['terms'])} program steps against {len(ref['terms'])}")
    steps = list(zip(prog["terms"], ref["terms"]))
    losses = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in steps]
    terms = {(i, n): abs(a[n] - b[n]) / abs(b[n])
             for i, (a, b) in enumerate(steps) for n in b if n != "loss"}
    worst_term = max(terms, key=terms.get)
    names = list(ref["moment"])
    med_g = statistics.median(ref["grad"].values())
    moving = [n for n in names if ref["grad"][n] >= TINY_GRAD * med_g]
    moment = _leaf_gaps(prog["moment"], ref["moment"], names)
    change = _leaf_gaps(prog["change"], ref["change"], moving)
    return {"loss_gap": max(losses), "terms_gap": terms[worst_term],
            "terms_worst": f"step {worst_term[0]} {worst_term[1]}",
            "moment_gap": max(moment), "change_gap": max(change),
            "moment_gap_median": statistics.median(moment),
            "change_gap_median": statistics.median(change),
            "moment_worst_leaf": names[moment.index(max(moment))],
            "change_worst_leaf": moving[change.index(max(change))]}


def request_numbers(prog: Dict[int, tuple], ref: Dict[int, tuple]) -> Dict[str, float]:
    """``prog`` and ``ref`` map a request to its (mean, std) maps; a
    request missing from ``prog`` (failed) reads infinite."""
    mean_gap = std_gap = 0.0
    for i, (mean_r, std_r) in ref.items():
        if i not in prog:
            return {"mean_gap": float("inf"), "std_gap": float("inf")}
        mean_p, std_p = prog[i]
        mean_gap = max(mean_gap, float((mean_p.float() - mean_r).abs().max()))
        std_gap = max(std_gap, float((std_p.float() - std_r).abs().max())
                      / max(float(std_r.max()), 1e-30))
    return {"mean_gap": mean_gap, "std_gap": std_gap}


def verdict(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> bool:
    """Every number with a limit at or under it (NaN fails)."""
    return all(limits.get(k) is None or numbers[k] <= limits[k] for k in numbers)
