"""One run of one cell: find its files by name, set up, measure, read the
trace, check, and build the result line.

A cell is ``workloads/<name>.json``: its configuration (``configs/<config>.json``,
whose ``family`` names ``families/<family>.py``), its traffic mix
(``traffic/<traffic>.json``, whose ``loop`` names ``loops/<loop>.py``), the
end-to-end and per-layer metrics it reports, and the limits of its check.
A per-layer metric is ``metrics/<metric>.py``, whose ``read(ctx)`` returns
the number or None (nothing to read). Nothing here knows a family, a loop
or a metric by name.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from port_bench import loops
from port_bench.harness import check, faults, trace, work
from port_bench.reference import models

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # port_bench/
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "simple_vae_rs_tpu")
TRACE_SECONDS = 5.0  # a traced run's window: the trace of a longer one takes long to read


def load_json(kind: str, name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, kind, name + ".json")) as fh:
        return json.load(fh)


def load_cell(name: str, root: str = HERE) -> Dict[str, dict]:
    """The workload, its configuration and its traffic mix, by name."""
    cell = load_json("workloads", name, root)
    return {"cell": cell, "config": load_json("configs", cell["config"], root),
            "traffic": load_json("traffic", cell["traffic"], root)}


def reader(metric: str, root: str = HERE):
    """``read`` of ``metrics/<metric>.py``."""
    path = os.path.join(root, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("port_bench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card() -> Dict[str, object]:
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        limit = "unknown"
    return {"kind": name, "power_limit": limit}


def build_kernels(device) -> float:
    """Build the program's CUDA kernels, or find them built, in the
    checkout's ``build/svrs_torch_kernels/``; the seconds it took (the
    build itself on a checkout's first run, a look at the cache after)."""
    if torch.device(device).type != "cuda":
        return 0.0
    from simple_vae_rs_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    return time.perf_counter() - t0


def run_cell(name: str, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: Optional[float] = None, parts: Optional[Dict[str, dict]] = None,
             control: Optional[str] = None, fault: Optional[str] = None
             ) -> Dict[str, object]:
    """One run; returns the result line's fields (and ``lines``, the check's
    numbers beside their limits, for standard error). ``parts`` replaces
    the files (tests); ``control`` (``tf32`` or ``fp8``) puts the reference
    at that precision in the program's place and measures nothing; ``fault``
    plants one of ``faults.FAULTS`` in the program."""
    t_start = time.perf_counter() if t_start is None else t_start
    t_cell = time.perf_counter()
    parts = parts or load_cell(name)
    cell, traffic = parts["cell"], parts["traffic"]
    loop = loops.load(traffic["loop"])(parts["config"], traffic, seed, device)
    if fault is not None:
        loop.plant = faults.FAULTS[fault]
    if control is not None:
        return _control(loop, cell, control)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.init()
    t_cuda = time.perf_counter()
    build_s = build_kernels(device)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    setup_parts = {"start_s": t_cell - t_start, "cuda_s": t_cuda - t_cell, "build_s": build_s,
                   **loop.setup_parts}
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    out: Dict[str, object] = {}
    if traced:
        seconds = min(seconds, TRACE_SECONDS)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                    + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
                                    ) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                res = loop.window(seconds)
        peak_window = torch.cuda.max_memory_allocated() if cuda else 0
        # reserved, not allocated: a replay's activations live in its graph's pool
        reserved_window = torch.cuda.max_memory_reserved() if cuda else 0
    else:
        res = loop.window(seconds)
        peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    device_info = {"platform": "gpu" if cuda else "cpu", "count": 1,
                   "memory_peak_bytes": max(peak_setup, peak_window)}
    if cuda:
        device_info.update(card())
    metrics: Dict[str, dict] = {}
    if traced:
        events = trace.read(prof, os.environ.get("TMPDIR"))
        t0, t1, tid = trace.window_of(events)
        by_name = trace.device_time_by_name(events, t0, t1)
        ctx = {"kind": loop.kind, "dtype": traffic["dtype"], "units": res["units"],
               "window_s": (t1 - t0) / 1e6, "busy_s": trace.gpu_busy_us(events, t0, t1) / 1e6,
               "conv_device_s": sum(s for n, s in by_name.items()
                                    if any(k in n for k in work.CONV_KERNELS)),
               "peak_mem_bytes": reserved_window, "work": loop.work()}
        for metric in cell["per_layer"]:
            value = reader(metric)(ctx)
            if value is not None:
                metrics[metric] = {"value": value, "unit": cell["units"][metric]}
        device_info.update({"busy_s": ctx["busy_s"], "window_s": ctx["window_s"]})
        out["breakdown"] = {"device_ops": trace.top(by_name),
                            "idle_gaps": trace.top(trace.idle_by_host(events, t0, t1, tid))}
        out["notes"] = {"conv_bound_ops_share": ctx["work"]["conv_bound_ops_share"],
                        "conv_device_s": ctx["conv_device_s"], "traced_units": res["units"]}
        del events, prof
    else:
        res["setup_s"] = setup_s
        for metric in cell["end_to_end"]:
            metrics[metric] = {"value": res[metric], "unit": cell["units"][metric]}
    out["window"] = {k: v for k, v in res.items() if k != "units"}
    out["setup_parts"] = setup_parts
    # the window has closed and the peak is read: free the program, then check
    numbers = loop.compare(loop.program_records(res), loop.reference_records(models.F32))
    limits = cell["limits"]
    compared = {k: numbers[k] for k in limits}
    out.update({"correct": bool(check.verdict(compared, limits)),
                "attempted": int(res["attempted"]), "failed": int(res["failed"]),
                "metrics": metrics, "device": device_info})
    out["numbers"] = numbers
    out["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in compared.items()}
    out["lines"] = [f"check {k} {v!r} limit {limits[k]!r}" for k, v in compared.items()]
    return out


def result_line(out: Dict[str, object]):
    """The run's last lines of standard error (each number compared beside
    its limit) and its last line of standard output (one JSON object, the
    numbers compared under ``checks``, its last key)."""
    out = dict(out)
    lines = out.pop("lines")
    # a number that is not finite has failed its check already; JSON has no NaN
    out["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"]) else 1e300,
                         "limit": c["limit"]} for k, c in out.pop("checks").items()}
    return lines, json.dumps(out)


def _control(loop, cell: dict, control: str) -> Dict[str, object]:
    """The reference at ``control``'s precision in the program's place: its
    numbers against the float32 reference's, on the work a run checks."""
    numbers = loop.compare(loop.reference_records(models.Rounding(control)),
                           loop.reference_records(models.F32))
    limits = cell["limits"]
    compared = {k: numbers[k] for k in limits}
    return {"control": control, "numbers": numbers, "correct": check.verdict(compared, limits)}
