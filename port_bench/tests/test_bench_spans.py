"""The readings of the program's own spans (``harness/spans.py``), the span
readers of ``metrics/`` and ``span_report.py``, on the CPU: device time by
span on a synthetic Chrome trace (a launch on a second thread, nested
spans, clipping to the window, a replay's kernels behind its
``cudaGraphLaunch``), idle time by span (summing to the window's idle
time), each reader's arithmetic and its None where it has nothing to read,
and a traced tiny cell, also of a program that records no span."""

import pytest
import torch

from port_bench import span_report
from port_bench.harness import cell, spans, trace

from .conftest import tiny_parts

UQ = ("prior_ms.uq", "conv_host_us.uq", "decode_device_ms.uq", "program_idle.uq")
TRAIN = ("weight_grad_ms.train", "optimizer_ms.train", "graph_captures.train")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "ph": "X"}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur, tid=1):
    return _ev("user_annotation", name, ts, dur, tid)


def _launched(corr, at, kernel_ts, dur, tid=1, name="cudaLaunchKernel"):
    return [_ev("cuda_runtime", name, at, 1, tid, corr),
            _ev("kernel", f"k{corr}", kernel_ts, dur, 7, corr)]


def _synthetic():
    return [
        _span(trace.WINDOW, 0, 200),
        _ev("gpu_user_annotation", "svrs.uq.request", 10, 80, tid=7),  # the device's copy
        _span("svrs.uq.request", 10, 80), _span("svrs.uq.prior", 12, 28),
        _span("svrs.conv", 20, 10), _span("svrs.uq.decode", 40, 40), _span("svrs.conv", 45, 15),
        *_launched(1, 25, 30, 10),     # a conv in the prior pass
        *_launched(2, 50, 55, 20),     # a conv in a decode
        *_launched(3, 70, 80, 5),      # the decode's own (the noise)
        *_launched(4, 85, 195, 10),    # the request's own, run past the window's end
        # a step: the backward on the main thread, a weight gradient on autograd's
        _span("svrs.step", 100, 80), _span("svrs.step.backward", 110, 40),
        _span("svrs.step.weight_grad", 120, 10, tid=2),
        *_launched(5, 125, 130, 8, tid=2),
        # a replay: two kernels behind one cudaGraphLaunch
        _span("svrs.step.replay", 160, 10),
        _ev("cuda_runtime", "cudaGraphLaunch", 165, 1, 1, 6),
        _ev("kernel", "g1", 170, 3, 7, 6), _ev("kernel", "g2", 175, 3, 7, 6),
        *_launched(8, 190, 190, 2),    # outside every span
        _ev("kernel", "orphan", 185, 1, 7, 99),  # its launch is not in the trace
        _span("other", 0, 200), _span("svrs.conv", 300, 5),  # not a span / outside the window
    ]


def test_program_spans_by_thread_in_start_order():
    by = spans.program_spans(_synthetic())
    assert set(by) == {1, 2}
    assert [s.name for s in by[1][:3]] == ["svrs.uq.request", "svrs.uq.prior", "svrs.conv"]
    assert [s.name for s in by[2]] == ["svrs.step.weight_grad"]


def test_device_time_by_span_follows_each_launch():
    got = spans.device_time_by_span(_synthetic(), 0, 200)
    us = 1e-6
    assert got["self"] == pytest.approx({
        "svrs.conv": 30 * us, "svrs.uq.decode": 5 * us, "svrs.uq.request": 5 * us,
        "svrs.step.weight_grad": 8 * us, "svrs.step.replay": 6 * us,
        spans.OUTSIDE: 2 * us, spans.NO_LAUNCH: 1 * us})
    total = got["total"]
    assert total["svrs.uq.request"] == pytest.approx(40 * us)  # 10 + 20 + 5 + 5 (clipped)
    assert total["svrs.uq.prior"] == pytest.approx(10 * us)
    assert total["svrs.uq.decode"] == pytest.approx(25 * us)
    # the weight gradient, launched on autograd's thread, counts for the
    # step and the backward open on the main thread
    assert total["svrs.step.backward"] == pytest.approx(8 * us)
    assert total["svrs.step"] == pytest.approx(14 * us)
    assert sum(got["self"].values()) == pytest.approx(57 * us)  # every kernel once


def test_idle_by_span_splits_each_gap_and_sums_to_the_idle_time():
    events = [_span(trace.WINDOW, 0, 100), _span("svrs.uq.request", 10, 80),
              _span("svrs.uq.prior", 10, 30), _span("svrs.uq.decode", 40, 40),
              _span("svrs.conv", 20, 60, tid=2),  # another thread's: not the main one's
              _ev("kernel", "a", 0, 20, 7), _ev("kernel", "b", 50, 10, 7)]
    got = spans.idle_by_span(events, 0, 100, 1)
    us = 1e-6
    assert got["self"] == pytest.approx({"svrs.uq.prior": 20 * us, "svrs.uq.decode": 30 * us,
                                         "svrs.uq.request": 10 * us, spans.OUTSIDE: 10 * us})
    assert got["total"] == pytest.approx({"svrs.uq.request": 60 * us,
                                          "svrs.uq.prior": 20 * us, "svrs.uq.decode": 30 * us})
    busy = trace.gpu_busy_us(events, 0, 100)
    assert sum(got["self"].values()) == pytest.approx((100 - busy) * us)


def _ctx(kind):
    events = _synthetic()
    return {"kind": kind, "units": 1, "window_s": 200e-6, "busy_s": 50e-6,
            "graph_captures": 0, **spans.span_ctx(events, 0, 200, 1)}


def test_span_readers_arithmetic():
    uq, train = _ctx("uq"), _ctx("train")
    # one request in the window; its prior 28 us, its two convs 10 and 15 us
    assert cell.reader("prior_ms.uq")(uq) == pytest.approx(0.028)
    assert cell.reader("conv_host_us.uq")(uq) == pytest.approx(12.5)
    assert cell.reader("decode_device_ms.uq")(uq) == pytest.approx(0.025)
    idle = uq["idle_by_span"]["total"]["svrs.uq.request"]
    assert cell.reader("program_idle.uq")(uq) == pytest.approx(100 * idle / 200e-6)
    # one step; its weight gradient 8 us
    assert cell.reader("weight_grad_ms.train")(train) == pytest.approx(0.008)
    assert cell.reader("graph_captures.train")(train) == 0
    clip = dict(train, device_by_span={"self": {}, "total": {"svrs.step.clip": 1e-3,
                                                            "svrs.step.adam": 2e-3}})
    assert cell.reader("optimizer_ms.train")(clip) == pytest.approx(3.0)


@pytest.mark.parametrize("metric", UQ + TRAIN)
def test_a_span_reader_reads_nothing_off_its_kind_or_without_its_spans(metric):
    kind = "uq" if metric.endswith(".uq") else "train"
    other = "train" if kind == "uq" else "uq"
    assert cell.reader(metric)(_ctx(other)) is None
    # the harness's ctx as it stands: no span keys, no capture count
    bare = {"kind": kind, "units": 3, "window_s": 5.0, "busy_s": 4.0, "conv_device_s": 1.0,
            "peak_mem_bytes": 1, "work": {}}
    assert cell.reader(metric)(bare) is None
    # a program that records no span inside the window
    empty = dict(_ctx(kind), spans=[], graph_captures=None,
                 device_by_span={"self": {}, "total": {}},
                 idle_by_span={"self": {}, "total": {}})
    assert cell.reader(metric)(empty) is None


@pytest.mark.parametrize("program", ["spans", "parent"])
def test_a_traced_tiny_cell_reads_the_span_metrics(program, monkeypatch):
    if program == "parent":  # a program without the spans and the capture counter
        from simple_vae_rs_tpu_torch.train.engine import Trainer
        from simple_vae_rs_tpu_torch.utils import trace as port_trace

        class Off:
            _is_profiler_enabled = False

        monkeypatch.setattr(port_trace, "_profiler", Off)
        init = Trainer.__init__

        def init_without_counter(self, *args, **kwargs):
            init(self, *args, **kwargs)
            del self.graph_captures

        monkeypatch.setattr(Trainer, "__init__", init_without_counter)
    for name, seen in (("cond_srvae.uq_bf16", ("prior_ms.uq", "conv_host_us.uq",
                                               "program_idle.uq")),
                       ("cond_srvae.train_f32", ("graph_captures.train",))):
        rep = span_report.run(name, 2**35 + 11, 0.3, device="cpu", parts=tiny_parts(name))
        assert rep["idle_split"]["by_span_s"] == pytest.approx(
            rep["idle_split"]["window_idle_s"], rel=1e-9)
        if program == "parent":
            assert rep["span_metrics"] == {}
        else:
            # no device on the CPU: the device-time metrics read nothing
            assert set(rep["span_metrics"]) == set(seen)
            assert rep["span_metrics"].get("graph_captures.train", 0) == 0
