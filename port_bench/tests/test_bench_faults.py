"""The check against a broken program and against the control, on the CPU
at a small size. Each cell's run, the harness's look for a card skipped,
drives the timed path with each fault the cell can have planted under it
(``harness/faults.py``): a step that returns its state unchanged, half of
the batch left out (the mean taken over the rest), an answer altered where
it is produced; ``correct`` comes out false, on a number that reads at
least ten times what the same run without the fault reads. The control,
the reference at the precision below the cell's in the program's place,
comes out not correct too. (One card, so no exchange between chips to
leave out.) The readings of the same faults and controls at the cells' own
sizes on the card are in PERF.md."""

import pytest

from port_bench.harness import cell

from .conftest import tiny_parts

FAULTS = {"cond_srvae.train_bf16": ("unchanged", "half_batch"),
          "vae.train_bf16": ("unchanged", "half_batch"),
          "cond_srvae.train_f32": ("unchanged", "half_batch"),
          "cond_srvae.uq_bf16": ("half_draws", "altered")}
CONTROL = {"cond_srvae.train_bf16": "fp8", "vae.train_bf16": "fp8",
           "cond_srvae.train_f32": "tf32", "cond_srvae.uq_bf16": "fp8"}
SEED = 2**35 + 11


def _run(name, fault=None):
    # float32 compute at this size: the sound run's numbers are round-off alone
    return cell.run_cell(name, SEED, 0.2, False, device="cpu",
                         parts=tiny_parts(name, dtype="float32"), fault=fault)


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in sorted(FAULTS.items()) for f in fs])
def test_a_planted_fault_is_incorrect(name, fault):
    sound, broken = _run(name), _run(name, fault)
    assert not broken["correct"], broken["checks"]
    caught = [k for k, c in broken["checks"].items()
              if c["value"] > c["limit"] and c["value"] >= 10 * sound["numbers"][k]]
    assert caught, (sound["checks"], broken["checks"])


@pytest.mark.parametrize("name", sorted(CONTROL))
def test_the_control_is_incorrect(name):
    out = cell.run_cell(name, SEED, 0.2, False, device="cpu", parts=tiny_parts(name),
                        control=CONTROL[name])
    assert not out["correct"], out["numbers"]
