"""Reading the program's own spans in a Chrome trace of the measured window.

The port records ``svrs.*`` spans (``simple_vae_rs_tpu_torch/utils/trace.py``)
while a ``torch.profiler`` records: ``user_annotation`` events on the
profiler's clock, nested on the thread that opened them, beside CUPTI's
launches (``cuda_runtime`` / ``cuda_driver``) and the card's kernels, copies
and sets. Here:

- :func:`program_spans`: the ``svrs.*`` spans by thread;
- :func:`device_time_by_span`: each kernel, copy and set (clipped to the
  window) put down, through its ``correlation``, to the spans open on the
  thread that launched it: ``self`` by the innermost, ``total`` by every
  span enclosing the launch. A launch on a thread that holds no root span
  (autograd's device thread, in a backward on the card) also counts for
  the spans open then on the thread that holds one. A replay's kernels
  share the ``cudaGraphLaunch``'s correlation, so they fall to the span
  around the replay;
- :func:`idle_by_span`: the card's idle time in the window split by the
  spans open on the main thread at each moment (``self`` and ``total`` as
  above); ``self`` sums to the whole idle time.

:func:`span_ctx` gathers them under the keys the span readers of
``metrics/`` read, and :func:`span_notes` the ``notes`` a traced run keeps.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from port_bench.harness import trace

PREFIX = "svrs."
ROOTS = ("svrs.uq.request", "svrs.step")  # a request's and a step's root span
OUTSIDE = "(outside svrs spans)"
NO_LAUNCH = "(launch not in trace)"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Span(NamedTuple):
    name: str
    start: float  # microseconds, the profiler's clock
    end: float


def program_spans(events: List[dict]) -> Dict[object, List[Span]]:
    """The ``svrs.*`` spans of the trace by host thread, in start order
    (an enclosing span before the spans it encloses)."""
    out: Dict[object, List[Span]] = {}
    for e in events:
        if e.get("cat") == "user_annotation" and "dur" in e \
                and str(e.get("name", "")).startswith(PREFIX):
            out.setdefault(e["tid"], []).append(
                Span(e["name"], e["ts"], e["ts"] + e["dur"]))
    for spans in out.values():
        spans.sort(key=lambda s: (s.start, -s.end))
    return out


def _segments(spans: Sequence[Span], t0: float, t1: float
              ) -> List[Tuple[float, float, Tuple[str, ...]]]:
    """[t0, t1) cut where a span of one thread opens or closes: each piece
    with the names of the spans open over it, outermost first."""
    inf = float("inf")
    out: List[Tuple[float, float, Tuple[str, ...]]] = []
    stack: List[Span] = []
    cur, i = t0, 0
    while cur < t1:
        opens = spans[i].start if i < len(spans) else inf
        closes = stack[-1].end if stack else inf
        nxt = min(opens, closes, t1)
        if nxt > cur:
            out.append((cur, nxt, tuple(s.name for s in stack)))
            cur = nxt
        if closes <= opens:
            if stack:
                stack.pop()
        else:
            stack.append(spans[i])
            i += 1
    return out


def _stack_at(segments, starts: List[float], ts: float) -> Tuple[str, ...]:
    j = bisect.bisect_right(starts, ts) - 1
    if j < 0 or ts >= segments[j][1]:
        return ()
    return segments[j][2]


def _add(d: Dict[str, float], key: str, value: float) -> None:
    d[key] = d.get(key, 0.0) + value


def device_time_by_span(events: List[dict], t0: float, t1: float
                        ) -> Dict[str, Dict[str, float]]:
    """Seconds of device time inside [t0, t1] by the ``svrs.*`` span open
    at each operation's launch on its launching thread: ``{"self": by the
    innermost, "total": by every enclosing name (once each)}``; ``self``
    puts an operation launched outside any span under :data:`OUTSIDE`, one
    whose launch the trace lacks under :data:`NO_LAUNCH`."""
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["ts"], e.get("tid"))
    by_thread = program_spans(events)
    whole = (float("-inf"), float("inf"))  # a launch may precede the window
    segs = {tid: _segments(spans, *whole) for tid, spans in by_thread.items()}
    starts = {tid: [s[0] for s in seg] for tid, seg in segs.items()}
    rooted = [tid for tid, spans in by_thread.items() if any(s.name in ROOTS for s in spans)]
    self_: Dict[str, float] = {}
    total: Dict[str, float] = {}
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATS or "dur" not in e:
            continue
        a, b = e["ts"], e["ts"] + e["dur"]
        if b <= t0 or a >= t1:
            continue
        seconds = (min(b, t1) - max(a, t0)) / 1e6
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            _add(self_, NO_LAUNCH, seconds)
            continue
        ts, tid = launch
        stack = _stack_at(segs[tid], starts[tid], ts) if tid in segs else ()
        if not any(n in ROOTS for n in stack):
            for other in rooted:
                outer = _stack_at(segs[other], starts[other], ts) if other != tid else ()
                if outer and outer[0] in ROOTS:
                    stack = outer + stack
                    break
        _add(self_, stack[-1] if stack else OUTSIDE, seconds)
        for name in dict.fromkeys(stack):
            _add(total, name, seconds)
    return {"self": self_, "total": total}


def idle_by_span(events: List[dict], t0: float, t1: float, tid
                 ) -> Dict[str, Dict[str, float]]:
    """Seconds the card was idle inside [t0, t1] by the ``svrs.*`` spans the
    main thread (``tid``) had open at each moment: ``{"self": by the
    innermost (:data:`OUTSIDE` where none was open), "total": by every
    open name (once each)}``. ``self`` sums to the window's idle time."""
    _, gaps = trace._union(events, t0, t1)
    segs = _segments(program_spans(events).get(tid, []), t0, t1)
    self_: Dict[str, float] = {}
    total: Dict[str, float] = {}
    j = 0
    for a, b in gaps:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                names = segs[k][2]
                _add(self_, names[-1] if names else OUTSIDE, (hi - lo) / 1e6)
                for name in dict.fromkeys(names):
                    _add(total, name, (hi - lo) / 1e6)
            k += 1
    return {"self": self_, "total": total}


def span_ctx(events: List[dict], t0: float, t1: float, tid) -> Dict[str, object]:
    """The keys the span readers of ``metrics/`` read from a traced run's
    ``ctx``: the window's bounds, the main thread's spans and the two
    attributions above."""
    return {"window_us": (t0, t1), "spans": program_spans(events).get(tid, []),
            "device_by_span": device_time_by_span(events, t0, t1),
            "idle_by_span": idle_by_span(events, t0, t1, tid)}


def durations(ctx: dict, name: str, root: Optional[str] = None) -> List[float]:
    """Microseconds of each main-thread span ``name`` inside the window (and
    inside a ``root`` span, where given)."""
    t0, t1 = ctx["window_us"]
    spans = [s for s in ctx["spans"] if t0 <= s.start and s.end <= t1]
    roots = sorted((s.start, s.end) for s in spans if s.name == root) if root else None
    out = []
    for s in spans:
        if s.name != name:
            continue
        if roots is not None:
            j = bisect.bisect_right(roots, (s.start, float("inf"))) - 1
            if j < 0 or s.end > roots[j][1]:
                continue
        out.append(s.end - s.start)
    return out


def count(ctx: dict, name: str) -> int:
    """Main-thread spans ``name`` inside the window."""
    return len(durations(ctx, name))


def span_notes(ctx: dict) -> Dict[str, object]:
    """What a traced run keeps beside its metrics: the top ten of the idle
    time by innermost program span (seconds), each step role's device time
    (seconds, every span it encloses included), and the share of the device
    time launched inside a request or step root that a span below the root
    takes."""
    dev = ctx["device_by_span"]
    covered = {}
    for root in ROOTS:
        inside = dev["total"].get(root, 0.0)
        if inside > 0:
            covered[root] = 1.0 - dev["self"].get(root, 0.0) / inside
    return {"idle_by_span": trace.top(ctx["idle_by_span"]["self"]),
            "step_roles_device_s": {n: v for n, v in sorted(dev["total"].items())
                                    if n.startswith("svrs.step.")},
            "covered_below_root": covered}
