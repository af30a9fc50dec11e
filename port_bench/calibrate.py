"""Readings that a cell's limits are set from, many seeds in one process.

    python3 port_bench/calibrate.py --workload <cell> --seeds 11 12 ... \\
        [--control fp8|tf32 --control-seeds 21 22 23] [--faults NAME ... --fault-seeds 31 32 33]
        [--seconds 1] [--out FILE]

For each of ``--seeds``, one run of the cell with a short window (the
program's numbers, as a run of ``run.py`` reads them); for each of
``--control-seeds``, the control: the plain reference at the lower precision
in the program's place; for each of ``--fault-seeds``, a run with each of
``--faults`` planted in the program (``harness/faults.py``). Prints one JSON
line a reading and appends it to ``--out``. Needs a CUDA card; the benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", choices=("tf32", "fp8"))
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[], help="faults of harness/faults.py")
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)  # load from one process with one host thread: steadier windows

    from port_bench.harness import cell

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    runs = ([(s, None, None) for s in args.seeds]
            + [(s, args.control, None) for s in args.control_seeds]
            + [(s, None, f) for f in args.faults for s in args.fault_seeds])
    for seed, control, fault in runs:
        t0 = time.perf_counter()
        out = cell.run_cell(args.workload, seed, args.seconds, False, control=control,
                            fault=fault)
        line = {"workload": args.workload, "seed": seed, "control": control, "fault": fault,
                "numbers": out["numbers"], "correct": out["correct"],
                "seconds": time.perf_counter() - t0}
        if control is None:
            line["metrics"] = {k: v["value"] for k, v in out["metrics"].items()}
            line["window"] = out["window"]
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
