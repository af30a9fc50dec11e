"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is ``port_bench/workloads/<cell>.json``.
Set-up builds the program (``simple_vae_rs_tpu_torch``) from the seed and
warms every shape the window uses; the window measures for ``--seconds``;
then the program is freed and the plain reference in ``port_bench/reference``
checks what the timed path produced. With ``--trace 0`` the metrics are the
cell's end-to-end ones, with ``--trace 1`` its per-layer ones, read from a
``torch.profiler`` trace of the window. The last line of standard output is
one JSON object; the last lines of standard error are the check's numbers
beside their limits. Exits 2, printing no result, without a CUDA card, and 3
if a module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ.setdefault("USE_FLAX", "0")  # no library of the port's may load JAX

    import torch

    torch.set_num_threads(1)  # load from one process with one host thread: steadier windows

    from port_bench.harness import cell

    parts = cell.load_cell(args.workload)
    chips = int(parts["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = cell.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                        t_start=T_START, parts=parts)
    found = cell.forbidden_modules()
    if found:
        print(f"port_bench: loaded {', '.join(found)}; the benchmark may load no JAX",
              file=sys.stderr)
        return 3
    print(f"window {json.dumps(out.pop('window'))}", file=sys.stderr)
    print(f"setup {json.dumps(out['setup_parts'])}", file=sys.stderr)
    print(f"numbers {json.dumps(out.pop('numbers'))}", file=sys.stderr)
    lines, last = cell.result_line(out)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(last, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
