"""Run one cell traced and print what the program's own spans read.

    python3 port_bench/span_report.py --workload <cell> --seed <n> [--seconds 5]

From the root of a checkout, as ``run.py``. The run is ``harness/cell.py``'s
traced run (``--trace 1``) as it stands, check included. Its traced branch
passes the per-layer readers no events and no capture count, so this script
keeps the trace's events and ``Trainer.graph_captures`` before and after the
window, and reads the span metrics (:data:`SPAN_METRICS`, ``metrics/``)
from them through ``harness/spans.py``. The last line of standard output is
one JSON object: the run's ``correct``, its traced rate (``window``), its
per-layer metrics, the span metrics that found something to read, the
span notes (idle time by program span, the step roles' device time, the
share of a root's device time that a span below it takes), and the idle
time split by span against the window's whole idle time. A program that
records no ``svrs.*`` span, or whose trainer counts no captures, reads
nothing there: the metrics are left out. Exits 2 without a CUDA card
(``--device cpu`` rehearses on the host).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPAN_METRICS = ("prior_ms.uq", "conv_host_us.uq", "decode_device_ms.uq", "program_idle.uq",
                "weight_grad_ms.train", "optimizer_ms.train", "graph_captures.train")


def run(name: str, seed: int, seconds: float, device="cuda", parts=None) -> dict:
    """One traced run of cell ``name`` and its span readings."""
    from port_bench import loops
    from port_bench.harness import cell, spans, trace

    kept: dict = {}
    read, load = trace.read, loops.load

    def keep_events(prof, tmpdir=None):
        kept["events"] = read(prof, tmpdir)
        return kept["events"]

    def counted(loop_name: str):
        class Counted(load(loop_name)):
            def window(self, seconds):
                trainer = getattr(self, "trainer", None)
                before = getattr(trainer, "graph_captures", None)
                res = super().window(seconds)
                if before is not None:
                    kept["graph_captures"] = trainer.graph_captures - before
                kept["kind"] = self.kind
                return res

        return Counted

    trace.read, loops.load = keep_events, counted
    try:
        out = cell.run_cell(name, seed, seconds, True, device=device, parts=parts)
    finally:
        trace.read, loops.load = read, load
    events = kept.pop("events")
    t0, t1, tid = trace.window_of(events)
    ctx = {"kind": kept.pop("kind"), "units": out["notes"]["traced_units"],
           "window_s": (t1 - t0) / 1e6, "busy_s": trace.gpu_busy_us(events, t0, t1) / 1e6,
           **kept, **spans.span_ctx(events, t0, t1, tid)}
    del events
    values = {m: cell.reader(m)(ctx) for m in SPAN_METRICS}
    idle = ctx["idle_by_span"]["self"]
    return {"workload": name, "seed": seed, "correct": out["correct"], "window": out["window"],
            "metrics": out["metrics"],
            "span_metrics": {m: v for m, v in values.items() if v is not None},
            "notes": spans.span_notes(ctx),
            "idle_split": {"window_idle_s": ctx["window_s"] - ctx["busy_s"],
                           "by_span_s": sum(idle.values()),
                           "outside_s": idle.get(spans.OUTSIDE, 0.0)},
            "device": out["device"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    torch.set_num_threads(1)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("span_report: needs a CUDA card", file=sys.stderr)
        return 2
    parts = None
    if args.device == "cpu":
        from port_bench.tests.conftest import tiny_parts

        parts = tiny_parts(args.workload)
    report = run(args.workload, args.seed, args.seconds, args.device, parts)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
