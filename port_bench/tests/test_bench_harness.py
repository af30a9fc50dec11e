"""The harness's own arithmetic and plumbing, on the CPU: cells, loops and
families found by file name (and refused where a file is missing or a key
is not read), the operation and byte counts, the roofline and MFU shares,
the 95th percentile, the sample of requests kept, the idle share of a
trace, and the result line."""

import json
import shutil

import pytest

from port_bench import families, loops
from port_bench.harness import cell, trace, work
from port_bench.loops.requests import p95

from .conftest import CELLS, tiny_parts


def test_a_workload_file_dropped_in_is_found_without_an_edit(tmp_path):
    root = tmp_path / "port_bench"
    shutil.copytree(cell.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    wl = json.loads((root / "workloads" / "vae.train_bf16.json").read_text())
    wl["why"] = "a cell that only a data file adds"
    (root / "workloads" / "vae.train_later.json").write_text(json.dumps(wl))
    parts = cell.load_cell("vae.train_later", root=str(root))
    assert parts["cell"]["why"] == wl["why"]
    assert parts["config"]["family"] == "vae"
    for metric in parts["cell"]["per_layer"]:
        assert callable(cell.reader(metric, root=str(root)))


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_names_files_that_exist(name):
    parts = cell.load_cell(name)
    loop = loops.load(parts["traffic"]["loop"])
    assert {"dtype"} <= set(loop.KEYS)
    assert families.load(parts["config"]).TERMS[0] == "loss"
    for metric in parts["cell"]["per_layer"]:
        cell.reader(metric)
    assert set(parts["cell"]["units"]) == set(parts["cell"]["end_to_end"]
                                              + parts["cell"]["per_layer"])


def test_a_loop_and_a_family_dropped_in_are_found_by_name(tmp_path, monkeypatch):
    pkg = tmp_path / "port_bench"
    (pkg / "loops").mkdir(parents=True)
    (pkg / "families").mkdir()
    (pkg / "loops" / "later_loop.py").write_text("class Loop:\n    kind = 'later'\n")
    (pkg / "families" / "later_family.py").write_text("CONFIG_KEYS = frozenset({'width'})\n")
    monkeypatch.setattr(loops, "__path__", [str(pkg / "loops")] + list(loops.__path__))
    monkeypatch.setattr(families, "__path__", [str(pkg / "families")] + list(families.__path__))
    assert loops.load("later_loop").kind == "later"
    assert families.load({"family": "later_family", "width": 8, "source": "x"}).CONFIG_KEYS


@pytest.mark.parametrize("what", ["family", "config_key", "traffic_key", "missing_key", "loop"])
def test_what_no_file_reads_is_refused(what):
    parts = tiny_parts("cond_srvae.uq_bf16")
    cfg, tr = parts["config"], parts["traffic"]
    if what == "family":
        cfg["family"] = "srvae"  # no families/srvae.py: never run as another family
    elif what == "config_key":
        cfg["int8"] = True  # a flag no family reads
    elif what == "traffic_key":
        tr["int8"] = True
    elif what == "missing_key":
        del tr["samples"]
    else:
        tr["loop"] = "serve_http"
    with pytest.raises(ValueError):
        cell.run_cell("cond_srvae.uq_bf16", 1, 0.1, False, device="cpu", parts=parts)


def test_the_requests_kept_are_a_sample_of_the_window(tiny):
    parts = tiny("cond_srvae.uq_bf16")
    loop = loops.load("requests")(parts["config"], parts["traffic"], 2**40 + 1, "cpu")
    loop.setup()
    res = {"attempted": 0}
    while res["attempted"] <= loop.n_checked:  # more requests than the sample
        first = loop.next_request
        res = loop.window(1.0)
    kept = loop.program_records(res)
    assert sorted(kept) == loop.checked and len(kept) == loop.n_checked
    assert all(first <= i < first + res["attempted"] for i in kept)


@pytest.mark.parametrize("kind,flops", [
    ("conv3x3", 2 * 2 * 8 * 8 * 9 * 3 * 5),        # every output pixel, 9 taps
    ("conv4x4s2", 2 * 2 * 4 * 4 * 16 * 3 * 5),     # a quarter of the pixels, 16 taps
    ("convT4x4s2", 2 * 2 * 16 * 16 * 4 * 3 * 5),   # 4x the pixels, 4 live taps each
])
def test_conv_flops_by_hand(kind, flops):
    assert work.conv_flops(kind, (2, 8, 8, 3), 5) == flops


def test_conv_bytes_by_hand():
    # bf16: x 2*8*8*3, out 2*8*8*5, weight 9*3*5, 2 bytes each; f32 scale+shift of 5
    assert work.conv_bytes("conv3x3", (2, 8, 8, 3), 5, "bfloat16", "forward") == \
        2 * (384 + 640 + 135) + 4 * 2 * 5
    # the input gradient reads the output's gradient, writes x's; scale+shift of C
    assert work.conv_bytes("conv4x4s2", (2, 8, 8, 3), 5, "float32", "dx") == \
        4 * (384 + 160 + 240) + 4 * 2 * 3


def test_bound_takes_the_longer_side():
    t, which = work.bound_s(989e12, 1.0, "bfloat16")
    assert (t, which) == (1.0, "operations")
    t, which = work.bound_s(1.0, 3.35e12 * 2, "float32")
    assert (t, which) == (2.0, "bytes")
    assert work.peak_flops("float32") == pytest.approx(165e12)


def test_per_layer_readers_arithmetic():
    ctx = {"kind": "train", "dtype": "bfloat16", "units": 10, "window_s": 2.0, "busy_s": 1.5,
           "conv_device_s": 0.5, "peak_mem_bytes": 3 * 2**30,
           "work": {"model_flops": 98.9e12, "conv_bound_s": 0.01}}
    assert cell.reader("mfu.train")(ctx) == pytest.approx(50.0)  # 494.5 TFLOP/s of 989
    assert cell.reader("conv_roofline.train")(ctx) == pytest.approx(20.0)
    assert cell.reader("device_idle.train")(ctx) == pytest.approx(25.0)
    assert cell.reader("peak_mem_gib.train")(ctx) == pytest.approx(3.0)
    # a reader with nothing to read returns nothing, never 0
    assert cell.reader("mfu.uq")(ctx) is None
    assert cell.reader("conv_roofline.train")(dict(ctx, conv_device_s=0.0)) is None


def test_p95_is_over_all_requests():
    values = [float(i) for i in range(1, 101)]
    assert p95(values) == pytest.approx(95.05)
    tail = [1.0] * 90 + [50.0] * 10  # ten slow requests of a hundred
    assert p95(tail) == 50.0


def _ev(cat, name, ts, dur, tid=1):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "ph": "X"}


def test_idle_share_and_gaps_on_a_synthetic_trace():
    events = [_ev("user_annotation", trace.WINDOW, 0, 100),
              _ev("gpu_user_annotation", trace.WINDOW, 0, 100, tid=7),
              _ev("cpu_op", "aten::copy_", 10, 30), _ev("cuda_runtime", "cudaMemcpyAsync", 15, 5),
              _ev("kernel", "conv_tc_bf16<0>", 0, 10, tid=7),
              _ev("kernel", "other", 5, 10, tid=7),       # overlaps: the union counts it once
              _ev("gpu_memcpy", "Memcpy DtoH", 40, 20, tid=7),
              _ev("kernel", "conv_wg_bf16", 90, 20, tid=7)]  # clipped at the window's end
    t0, t1, tid = trace.window_of(events)
    assert (t0, t1, tid) == (0, 100, 1)
    assert trace.gpu_busy_us(events, t0, t1) == 15 + 20 + 10
    by_name = trace.device_time_by_name(events, t0, t1)
    assert by_name["conv_wg_bf16"] == pytest.approx(10e-6)
    idle = trace.idle_by_host(events, t0, t1, tid)
    # 15-40: the innermost span open at 15 is the runtime call; 60-90: the harness's own loop
    assert idle == pytest.approx({"cudaMemcpyAsync": 25e-6, trace.WINDOW: 30e-6})
    assert 100 * (1 - 45 / 100) == pytest.approx(55.0)


def test_result_line_schema(tiny):
    out = cell.run_cell("cond_srvae.train_f32", 2**33 + 5, 0.2, False, device="cpu",
                        parts=tiny("cond_srvae.train_f32"))
    lines, last = cell.result_line(out)
    line = json.loads(last)
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert set(line["metrics"]) == {"train_patches_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert {"platform", "count", "memory_peak_bytes"} <= set(line["device"])
    assert set(line["checks"]) == set(cell.load_cell("cond_srvae.train_f32")["cell"]["limits"])
    assert {"loss_gap", "terms_gap", "failed_steps"} <= set(line["checks"])
    assert all("limit" in c and "value" in c for c in line["checks"].values())
    assert len(lines) == len(line["checks"]) and all(" limit " in s for s in lines)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0


def test_traced_line_holds_the_per_layer_metrics(tiny):
    out = cell.run_cell("cond_srvae.uq_bf16", 9, 0.3, True, device="cpu",
                        parts=tiny("cond_srvae.uq_bf16"))
    line = json.loads(cell.result_line(out)[1])
    assert "busy_s" in line["device"] and line["device"]["window_s"] > 0
    assert set(line["metrics"]) <= set(cell.load_cell("cond_srvae.uq_bf16")["cell"]["per_layer"])
    assert "mfu.uq" in line["metrics"]
    assert len(line["breakdown"]["device_ops"]) <= 10 and len(line["breakdown"]["idle_gaps"]) <= 10
