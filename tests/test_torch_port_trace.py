"""The port's own spans (``utils/trace.span``), on the CPU.

While no profiler records, a span is one shared no-op context and no
``record_function`` is made. Under ``torch.profiler.profile`` an
uncertainty request emits ``svrs.uq.request`` enclosing its input, prior,
one decode per chunk, moments and conv spans; an eager training step emits
``svrs.step`` enclosing forward, ELBO, backward (with the convs' input and
weight gradients inside), clip and Adam; ``profile_dir``'s Chrome trace
carries them. ``Trainer.graph_captures`` counts CUDA graph captures, which
the CPU path never makes. The outputs are bit-equal with spans on and off.
"""

import json

import numpy as np
import pytest
import torch

from simple_vae_rs_tpu_torch import tasks
from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, TrainConfig, VAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.vae import VAE
from simple_vae_rs_tpu_torch.serve import SuperResolver
from simple_vae_rs_tpu_torch.train import engine
from simple_vae_rs_tpu_torch.train.engine import Trainer
from simple_vae_rs_tpu_torch.utils import trace

PS = 16  # the Cond_SRVAE's HR patch; LR 8
STEP_ROLES = ("svrs.step.forward", "svrs.step.elbo", "svrs.step.backward", "svrs.step.clip",
              "svrs.step.adam")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model():
    return CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(0)


def _lr(seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (1, PS // 2, PS // 2, 4)).astype(np.float32)


def _batch(seed=0, bs=2):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.uniform(0, 1, (bs, PS // 2, PS // 2, 4)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 1, (bs, PS, PS, 4)).astype(np.float32))
    return y, x


def _profiled(fn):
    """``fn()`` under ``torch.profiler``: its result and the ``svrs.*``
    spans recorded, as (name, start, end) in start order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith("svrs.")), key=lambda s: (s[1], -s[2]))
    return out, spans


def _inside(spans, root):
    """The spans inside each ``root`` span, by root."""
    roots = [s for s in spans if s[0] == root]
    return [[s for s in spans if s is not r and r[1] <= s[1] and s[2] <= r[2]] for r in roots]


def test_span_is_the_shared_noop_while_no_profiler_records(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function made with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("svrs.step") is trace.span("svrs.conv")
    with trace.span("svrs.uq.request"), trace.span("svrs.uq.request"):  # reentrant
        pass
    # every site of a request and of a step, with record_function refused
    SuperResolver(_model(), device="cpu").uncertainty(_lr(), samples=4, chunk=2, seed=1)
    Trainer(_model(), TrainConfig(), device="cpu").train_step(_batch())


@pytest.mark.parametrize("samples,chunk", [(4, 4), (6, 2)])
def test_uncertainty_spans_nest_in_the_request(samples, chunk):
    sr = SuperResolver(_model(), device="cpu")
    _, spans = _profiled(lambda: sr.uncertainty(_lr(), samples=samples, chunk=chunk, seed=3))
    (inside,) = _inside(spans, "svrs.uq.request")
    names = [s[0] for s in inside]
    assert len(inside) == len(spans) - 1  # every other span is inside the request
    top = [n for n in names if n != "svrs.conv"]
    assert top == ["svrs.uq.input", "svrs.uq.prior"] + ["svrs.uq.decode"] * (samples // chunk) \
        + ["svrs.uq.moments"]
    # the convs run inside the prior pass and the decodes, none outside them
    outer = [s for s in inside if s[0] in ("svrs.uq.prior", "svrs.uq.decode")]
    convs = [s for s in inside if s[0] == "svrs.conv"]
    assert convs and all(any(o[1] <= c[1] and c[2] <= o[2] for o in outer) for c in convs)
    # one span per conv call: no conv span inside another
    assert not any(a is not b and a[1] <= b[1] and b[2] <= a[2] for a in convs for b in convs)


def test_vae_draws_emit_the_prior_and_a_decode_per_chunk():
    model = VAE(VAEConfig(cr=2.0, patch_size=8)).init_weights(0)
    y = torch.from_numpy(_lr()[:, :8, :8])
    _, spans = _profiled(lambda: tasks.sample_chunked(model, y, torch.Generator().manual_seed(0),
                                                      samples=6, chunk=3))
    assert [s[0] for s in spans if s[0] != "svrs.conv"] == ["svrs.uq.prior"] + [
        "svrs.uq.decode"] * 2


def test_train_step_spans_nest_in_the_step():
    tt = Trainer(_model(), TrainConfig(), device="cpu")
    _, spans = _profiled(lambda: tt.train_step(_batch()))
    (inside,) = _inside(spans, "svrs.step")
    names = [s[0] for s in inside]
    assert len(inside) == len(spans) - 1
    assert [n for n in names if n in STEP_ROLES] == list(STEP_ROLES)
    # on the CPU the backward runs on the calling thread: the convs' input
    # and weight gradients nest inside it
    (backward,) = [s for s in inside if s[0] == "svrs.step.backward"]
    for role in ("svrs.step.input_grad", "svrs.step.weight_grad"):
        grads = [s for s in inside if s[0] == role]
        assert grads and all(backward[1] <= s[1] and s[2] <= backward[2] for s in grads)
    (forward,) = [s for s in inside if s[0] == "svrs.step.forward"]
    convs = [s for s in inside if s[0] == "svrs.conv"]
    assert convs and all(forward[1] <= s[1] and s[2] <= forward[2] for s in convs)


def test_train_multi_step_on_the_cpu_is_one_step_span_a_step():
    tt = Trainer(_model(), TrainConfig(), device="cpu")
    stacks = engine.stack_batches([_batch(1), _batch(2)])
    _, spans = _profiled(lambda: tt.train_multi_step(stacks))
    assert [s[0] for s in spans].count("svrs.step") == 2
    assert all(len([s for s in inside if s[0] == "svrs.step"]) == 0
               for inside in _inside(spans, "svrs.step"))


def test_graph_captures_start_at_zero_and_the_cpu_path_makes_none():
    tt = Trainer(_model(), TrainConfig(), device="cpu")
    assert tt.graph_captures == 0
    tt.train_step(_batch())
    tt.train_multi_step(engine.stack_batches([_batch(1), _batch(2)]))
    assert tt.graph_captures == 0 and not tt.graphs


@pytest.mark.parametrize("path", ["uncertainty", "train_step"])
def test_outputs_are_bit_equal_with_spans_on_and_off(path):
    def run():
        if path == "uncertainty":
            sr = SuperResolver(_model(), device="cpu")
            return sr.uncertainty(_lr(), samples=6, chunk=2, seed=5)
        tt = Trainer(_model(), TrainConfig(), device="cpu", seed=4)
        terms = tt.train_step(_batch())
        return {**terms, **{"p." + n: p.detach().clone() for n, p in tt.params.items()}}

    off = run()
    on, spans = _profiled(run)
    assert spans
    assert off.keys() == on.keys()
    for key in off:
        assert torch.equal(off[key], on[key]), key


def test_profile_dir_trace_carries_the_step_spans(tmp_path):
    rng = np.random.default_rng(0)
    batches = [(rng.uniform(0, 1, (2, PS // 2, PS // 2, 4)).astype(np.float32),
                rng.uniform(0, 1, (2, PS, PS, 4)).astype(np.float32))]
    tt = Trainer(_model(), TrainConfig(profile_dir=str(tmp_path)), device="cpu")
    tt.fit(batches, batches, epochs=1, val_metrics_every=10)
    events = json.loads((tmp_path / "train_epoch_1.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"svrs.step", *STEP_ROLES, "svrs.conv"} <= names
