"""Reading a ``torch.profiler`` Chrome trace of the measured window: the
card's busy time (the union of kernels, copies and sets: ``chip_smoke.py``'s
``gpu_busy_us``, copied), device time by kernel name, and the idle gaps
labelled by what the host's main thread was doing."""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
WINDOW = "bench.window"  # the harness's span around the measured window


def device_spans(events: List[dict]) -> List[Tuple[float, float, str]]:
    return [(e["ts"], e["ts"] + e["dur"], e.get("name", "")) for e in events
            if e.get("cat") in DEVICE_CATS and "dur" in e]


def gpu_busy_us(events: List[dict], t0: float, t1: float) -> float:
    """The union of the card's kernels, copies and sets in a Chrome trace's
    events, clipped to [t0, t1], in microseconds."""
    busy, _ = _union(events, t0, t1)
    return busy


def _union(events, t0, t1):
    spans = sorted((max(a, t0), min(b, t1)) for a, b, _ in device_spans(events) if b > t0 and a < t1)
    busy, end, gaps = 0.0, t0, []
    for a, b in spans:
        if a > end:
            gaps.append((end, a))
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    if end < t1:
        gaps.append((end, t1))
    return busy, gaps


def window_of(events: List[dict]) -> Tuple[float, float, int]:
    """(start, end, thread id) of the harness's window span, microseconds."""
    marks = [e for e in events if e.get("name") == WINDOW and "dur" in e
             and e.get("cat") == "user_annotation"]  # not its copy on the device's timeline
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} '{WINDOW}' spans, not one")
    e = marks[0]
    return e["ts"], e["ts"] + e["dur"], e["tid"]


def device_time_by_name(events: List[dict], t0: float, t1: float) -> Dict[str, float]:
    """Seconds of device time by operation name inside [t0, t1]."""
    out: Dict[str, float] = {}
    for a, b, name in device_spans(events):
        if b > t0 and a < t1:
            out[name] = out.get(name, 0.0) + (min(b, t1) - max(a, t0)) / 1e6
    return out


def idle_by_host(events: List[dict], t0: float, t1: float, tid) -> Dict[str, float]:
    """Seconds the card was idle inside [t0, t1], by the innermost host
    span of the main thread (``tid``) open when each gap began."""
    _, gaps = _union(events, t0, t1)
    host = sorted((e["ts"], e["ts"] + e["dur"], e.get("name", "")) for e in events
                  if e.get("cat") in HOST_CATS and e.get("tid") == tid and "dur" in e)
    out: Dict[str, float] = {}
    stack: List[Tuple[float, float, str]] = []  # the spans open at the sweep's time, nested
    i = 0
    for a, b in gaps:
        while i < len(host) and host[i][0] <= a:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < a:
            stack.pop()
        label = stack[-1][2] if stack else "host: outside any span"
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return out


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def load(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh)["traceEvents"]


def read(prof, tmpdir: Optional[str] = None) -> List[dict]:
    """The events of a finished ``torch.profiler.profile``, through a
    Chrome trace written to (and removed from) ``tmpdir``."""
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return load(path)
    finally:
        os.remove(path)
