"""``scan_steps`` in the port against the JAX package, on the CPU.

k full optimizer steps per dispatch (``Trainer.train_multi_step``; one CUDA
graph replay on the card, k eager steps here), the epoch loop that gathers
them (a shape change and the ragged tail as single steps), the auto mode's
probe (``utils/health``) and the card's trial of it (switched on here
through the trainer's ``_trial_rule``, its window times handed out by a
stand-in clock), ``ClipAdam`` with its learning rate and bias
corrections read from device tensors, and a two-rank gloo mesh
(``tests/torch_mesh_worker.py``).

The same weights (the JAX trainer's initial state, ``load_jax_variables``),
batches (numpy, seeded) and noise (the port's ``stream_noise`` replaced by
the draws the JAX engine makes from ``fold_in(rng, step)``, and per
microbatch ``fold_in(step_rng, i)``). Tolerances, with their reasons:

- the terms summed over the k steps: 1e-4 relative (``tests/test_training.py``
  holds JAX's fused steps to its unfused ones so);
- parameters after the k steps: JAX's own tolerance between its fused and
  unfused dispatch (rtol 2e-3, atol 1e-4: float sums reassociated, which
  Adam's rsqrt amplifies near 0), and every element within 2 * lr a step
  (Adam moves an element whose gradient is rounding noise by lr either way);
- BatchNorm statistics rtol 5e-3, atol 1e-5 (JAX's: the second step's
  statistics see the first step's parameters);
- an epoch's logged means 1e-4 relative (``tests/test_torch_port_fit.py``);
- ``ClipAdam`` on device-held numbers: bit for bit against the updates it
  made from Python numbers before (the same operations, the same order).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_vae_rs_tpu.config import CondSRVAEConfig as JConfig
from simple_vae_rs_tpu.config import TrainConfig as JTrainConfig
from simple_vae_rs_tpu.config import VAEConfig as JVAEConfig
from simple_vae_rs_tpu.models import CondSRVAE as JCondSRVAE
from simple_vae_rs_tpu.models import VAE as JVAE
from simple_vae_rs_tpu.train.engine import Trainer as JTrainer
from simple_vae_rs_tpu.utils import health as jhealth

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, TrainConfig, VAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.vae import VAE
from simple_vae_rs_tpu_torch.train import engine
from simple_vae_rs_tpu_torch.train.engine import Trainer
from simple_vae_rs_tpu_torch.train.state import ClipAdam
from simple_vae_rs_tpu_torch.utils import health
from simple_vae_rs_tpu_torch.utils.jax_weights import _flatten, load_jax_variables
from tests.test_torch_port_fit import _jax_noise as _fit_noise
from tests.test_torch_port_tiling import one_torch_thread  # noqa: F401 (autouse)

PS = 16  # the Cond_SRVAE's HR patch; LR 8
LR = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")


def _batches(n, bs, seed, ps=PS):
    rng = np.random.default_rng(seed)
    return [(rng.random((bs, ps // 2, ps // 2, 4), dtype=np.float32),
             rng.random((bs, ps, ps, 4), dtype=np.float32)) for _ in range(n)]


def _jax_noise(kind, cfg, rng, trainer, accum):
    """The port's ``stream_noise`` replaced by the JAX engine's draws: step
    ``trainer.step``'s key, folded with the microbatch index under
    accumulation (the port draws a microbatch's noise in order)."""
    seen = {"step": None, "micro": 0}

    def draw(stream, b, hw):
        assert stream == "train"
        key = jax.random.fold_in(rng, trainer.step)
        if accum > 1:
            seen["micro"] = seen["micro"] + 1 if seen["step"] == trainer.step else 0
            seen["step"] = trainer.step
            key = jax.random.fold_in(key, seen["micro"])
        if kind == "vae":
            return (torch.from_numpy(np.array(jax.random.normal(key, (b, cfg.latent_dim)))),)
        g = cfg.patch_size // 8
        ku, kz = jax.random.split(key)
        return (torch.from_numpy(np.array(jax.random.normal(ku, (b, g, g, cfg.u_channels)))),
                torch.from_numpy(np.array(jax.random.normal(kz, (b, g, g, cfg.z_channels)))))
    return draw


# ---------------------------------------------------------- k steps at once
@pytest.mark.parametrize("accum", [1, 2])
def test_train_multi_step_matches_jax_multi_step(accum, monkeypatch):
    """Two steps in one dispatch against JAX's ``_train_multi_step`` (a
    ``lax.scan`` of its train step): the terms summed over the steps, the
    parameters and the BatchNorm statistics; with ``accum_steps=2`` each of
    the two updates averages two microbatches (scan_steps x accum_steps)."""
    b0, b1 = _batches(2, 4, 3)
    jmodel = JCondSRVAE(JConfig(cr=2.0, patch_size=PS))
    jt = JTrainer(jmodel, JTrainConfig(learning_rate=LR, scan_steps=2, accum_steps=accum))
    state0 = jax.device_get(jt.init_state(b0, seed=0))
    stack = tuple(np.stack([a, b]) for a, b in zip(b0, b1))
    state, want = jt._train_multi_step(jax.tree_util.tree_map(jnp.asarray, state0),
                                       tuple(map(jnp.asarray, stack)), jnp.float32(LR))
    state = jax.device_get(state)

    tmodel = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS))
    load_jax_variables(tmodel, {"params": state0.params, "batch_stats": state0.batch_stats})
    tt = Trainer(tmodel, TrainConfig(learning_rate=LR, scan_steps=2, accum_steps=accum),
                 device="cpu")
    monkeypatch.setattr(tt, "stream_noise",
                        _jax_noise("cond", tmodel.config, state0.rng, tt, accum))
    got = tt.train_multi_step(stack, lr=LR)

    assert tt.step == tt.opt.count == int(state.step) == 2
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=1e-4, err_msg=k)
    for name, w in _flatten(state.params).items():
        g = tt.params[name].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-4, err_msg=name)
        assert np.abs(g - w).max() <= 2 * 2 * LR * (1 + 1e-3), name
    buffers = dict(tt.model.named_buffers())
    for name, w in _flatten(state.batch_stats).items():
        np.testing.assert_allclose(buffers[name].numpy(), w, rtol=5e-3, atol=1e-5, err_msg=name)


def test_train_multi_step_is_k_train_steps_on_the_cpu():
    """On the CPU the k steps are k eager ``train_step`` calls: the same bits,
    the same generator state after, the step and count advanced by k."""
    batches = _batches(3, 2, 4)
    fused = Trainer(CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(0),
                    TrainConfig(learning_rate=LR, scan_steps=3), device="cpu", seed=5)
    eager = Trainer(CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(0),
                    TrainConfig(learning_rate=LR), device="cpu", seed=5)
    got = fused.train_multi_step(engine.stack_batches(batches), lr=LR)
    want = {}
    for b in batches:
        want = engine._add(want, eager.train_step(b, lr=LR))
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    assert fused.step == eager.step == fused.opt.count == 3
    assert torch.equal(fused._rng.get_state(), eager._rng.get_state())
    for name, p in fused.params.items():
        assert torch.equal(p, eager.params[name]), name


def test_a_gloo_mesh_refuses_a_captured_step():
    """A mesh whose collectives run over gloo cannot be captured (gloo copies
    through the host): the card's ``step_graph`` raises before any capture."""
    class GlooMesh:
        distributed, backend = True, "gloo"

    m = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(0)
    tr = Trainer(m, TrainConfig(scan_steps=2), device="cpu")
    tr.mesh = GlooMesh()
    stacks = tuple(torch.from_numpy(s) for s in engine.stack_batches(_batches(2, 2, 1)))
    with pytest.raises(ValueError, match="needs NCCL"):
        tr.step_graph(stacks)
    assert tr.graphs == {}


# ----------------------------------------------------------------- the fit
class _Log:
    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append((step, {k: float(v) for k, v in metrics.items()}))

    def log_images(self, images, step=None):
        pass

    def finish(self):
        pass


def _fit_both(train, val, epochs, jcfg, tcfg, monkeypatch, patch_probe=None, mesh=None,
              setup=None):
    """One JAX fit and one port fit of the VAE (patch 16, on the LR stream of
    ``_batches(..., ps=32)``) from the same state on the same data and noise
    (every stream's: ``tests/test_torch_port_fit._jax_noise``): (JAX
    trainer, its final state, its log, the port trainer, its log, the epoch
    of each of the port's multi-step dispatches). The port trains on
    ``mesh``; ``setup`` gets its trainer before the fit."""
    jt = JTrainer(JVAE(JVAEConfig(cr=2.0, patch_size=PS)), jcfg, logger=(jlog := _Log()))
    state0 = jax.device_get(jt.init_state(train[0]))
    tmodel = VAE(VAEConfig(cr=2.0, patch_size=PS))
    load_jax_variables(tmodel, {"params": state0.params, "batch_stats": state0.batch_stats})
    tt = Trainer(tmodel, tcfg, device="cpu", logger=(tlog := _Log()), mesh=mesh)
    monkeypatch.setattr(tt, "stream_noise", _fit_noise("vae", tmodel.config, state0.rng, tt))
    fused = []
    orig = tt.train_multi_step
    monkeypatch.setattr(tt, "train_multi_step",
                        lambda *a, **k: (fused.append(tt.current_epoch), orig(*a, **k))[1])
    if setup is not None:
        setup(tt)
    if patch_probe is not None:
        monkeypatch.setattr(jhealth, "dispatch_latency", lambda reps=3: patch_probe)
        monkeypatch.setattr(health, "dispatch_latency", lambda reps=3, device=None: patch_probe)
    jstate = jt.fit(train, val, epochs=epochs, val_metrics_every=100)
    tt.fit(train, val, epochs=epochs, val_metrics_every=100)
    return jt, jstate, jlog, tt, tlog, fused


def _losses(log, prefix="Loss/"):
    return {(step, k): v for step, m in log.records for k, v in m.items()
            if k.startswith(prefix)}


def test_fit_scan_steps_with_a_shape_change_matches_jax(monkeypatch):
    """``scan_steps=2`` over five batches with a batch size change in the
    middle: [b0, b1] fused, b2 alone (the next batch's shape differs), [b3,
    b4] fused, as JAX's loop runs them. Every batch trains once (5 steps)
    and the epoch's logged means equal JAX's."""
    train = _batches(2, 4, 5, 32) + _batches(1, 2, 6, 32) + _batches(2, 4, 7, 32)
    jt, jstate, jlog, tt, tlog, fused = _fit_both(
        train, train[:1], 1, JTrainConfig(learning_rate=LR, scan_steps=2),
        TrainConfig(learning_rate=LR, scan_steps=2), monkeypatch)
    assert tt.step == tt.opt.count == int(jstate.step) == len(train)
    assert fused == [1, 1]  # two dispatches of two; b2 single
    want, got = _losses(jlog), _losses(tlog)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4, err_msg=str(key))


def test_auto_scan_engages_from_epoch_two_in_both_packages(monkeypatch):
    """``scan_steps=0`` (the default): after epoch 1 both engines probe a
    dispatch's round trip; on a dispatch-bound link (the probe monkeypatched
    in both packages) both fuse ``AUTO_SCAN_K`` = 2 steps a dispatch from
    epoch 2, with the same losses."""
    train = _batches(4, 2, 21, 32)
    jt, jstate, jlog, tt, tlog, fused = _fit_both(
        train, train[:1], 2, JTrainConfig(learning_rate=LR), TrainConfig(learning_rate=LR),
        monkeypatch, patch_probe=1e6)
    assert tt.cfg.scan_steps == 0
    assert jt._auto_scan_k == tt._auto_scan_k == health.AUTO_SCAN_K == 2
    assert fused == [2, 2]  # epoch 1 unfused; epoch 2 two dispatches of two
    assert tt.step == int(jstate.step) == 2 * len(train)
    want, got = _losses(jlog), _losses(tlog)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4, err_msg=str(key))


@pytest.mark.parametrize("latency, scan_steps, want_k, want_fused", [
    (0.0, 0, 1, []),  # a fast link: the probe keeps one step a dispatch
    (None, 0, 1, []),  # a probe that failed: unfused
    ("boom", 2, None, [1, 2]),  # an explicit k: no probe at all
], ids=["fast-link", "probe-failed", "explicit-k"])
def test_auto_scan_policy_of_the_port(latency, scan_steps, want_k, want_fused, monkeypatch):
    def probe(reps=3, device=None):
        if latency == "boom":
            raise AssertionError("the probe must not run with an explicit scan_steps")
        return latency

    monkeypatch.setattr(health, "dispatch_latency", probe)
    m = VAE(VAEConfig(cr=2.0, patch_size=PS)).init_weights(0)
    tt = Trainer(m, TrainConfig(learning_rate=LR, scan_steps=scan_steps), device="cpu")
    fused = []
    orig = tt.train_multi_step
    monkeypatch.setattr(tt, "train_multi_step",
                        lambda *a, **k: (fused.append(tt.current_epoch), orig(*a, **k))[1])
    train = _batches(2, 2, 22, 32)
    tt.fit(train, train[:1], epochs=2, val_metrics_every=100)
    assert tt._auto_scan_k == want_k
    assert fused == want_fused
    assert tt.step == 4


@pytest.mark.parametrize("per_step, latency, want", [
    (1.0, 0.25, 1),  # at the threshold: not above it
    (1.0, np.nextafter(0.25, 1.0), 2),  # just above
    (1.0, 0.2499, 1),
    (0.004, 0.0011, 2),  # 27.5% of a short step
    (1.0, None, 1),  # no measurement
    (0.0, 1.0, 1),  # no step time
    (-1.0, 1.0, 1),
    (1.0, 0.0, 1),
], ids=lambda v: repr(v))
def test_choose_scan_steps_at_the_thresholds_edges(per_step, latency, want):
    assert health.choose_scan_steps(per_step, latency) == want
    assert jhealth.choose_scan_steps(per_step, latency) == want
    assert (health.AUTO_SCAN_K, health.AUTO_SCAN_THRESHOLD) == (jhealth.AUTO_SCAN_K,
                                                               jhealth.AUTO_SCAN_THRESHOLD)


@pytest.mark.parametrize("eager, replay, want", [
    (1.0, 1.0 - health.AUTO_SCAN_MIN_GAIN, health.AUTO_SCAN_K),  # the gain at the margin
    (1.0, np.nextafter(1.0 - health.AUTO_SCAN_MIN_GAIN, 0.0), health.AUTO_SCAN_K),  # above
    (1.0, np.nextafter(1.0 - health.AUTO_SCAN_MIN_GAIN, 1.0), 1),  # just below it
    (0.06960, 0.06544, health.AUTO_SCAN_K),  # the bf16 step on the H100: 6% off
    (0.19083, 0.18873, 1),  # the f32 step: 1.1% off
    (1.0, 2.0, 1),  # the replay slower
    (None, 1.0, 1),  # no measurement of a side
    (1.0, None, 1),
    (None, None, 1),
    (0.0, 0.5, 1),  # non-positive times
    (1.0, 0.0, 1),
    (1.0, -0.5, 1),
    (-1.0, -2.0, 1),
], ids=lambda v: repr(v))
def test_choose_scan_steps_by_trial_at_its_edges(eager, replay, want):
    """The card's rule: ``AUTO_SCAN_K`` steps a dispatch where the trial's
    replayed step is at most ``1 - AUTO_SCAN_MIN_GAIN`` of its eager step."""
    assert health.choose_scan_steps_by_trial(eager, replay) == want
    assert health.AUTO_SCAN_MIN_GAIN == 0.03
    assert health.AUTO_SCAN_TRIAL_STEPS % health.AUTO_SCAN_K == 0


class _Epochs:
    """A loader whose i-th pass yields the first ``lengths[i]`` batches, the
    lengths in turn (a JAX fit, then a port fit)."""

    def __init__(self, batches, lengths):
        self.batches, self.lengths, self.passes = batches, lengths, 0

    def __getitem__(self, i):
        return self.batches[i]

    def __iter__(self):
        n = self.lengths[self.passes % len(self.lengths)]
        self.passes += 1
        return iter(self.batches[:n])


# epoch lengths, the trial clock's readings in order (a window's start, its
# end), the dispatches of each epoch ("step", "capture", "multi") and k
_TRIALS = {
    "replay-wins": ([2, 8], [0.0, 1.0, 10.0, 10.5],
                    [["step"] * 2, ["step", "step", "capture", "multi", "multi"]], 2),
    "replay-loses": ([2, 7], [0.0, 1.0, 10.0, 11.0],
                     [["step"] * 2, ["step", "step", "capture", "multi", "step"]], 1),
    # epoch 2 ends in the trial's replay window: its times are dropped and
    # epoch 3 runs the trial again from its head
    "short-epoch": ([2, 5, 6], [0.0, 1.0, 5.0, 10.0, 11.0, 20.0, 20.5],
                    [["step"] * 2, ["step", "step", "capture", "step"],
                     ["step", "step", "capture", "multi"]], 2),
    "gloo-mesh": ([2, 6], [], [["step"] * 2, ["step"] * 6], 1),
}


@pytest.mark.parametrize("case", list(_TRIALS))
def test_card_trial_of_the_auto_mode_against_the_jax_fit(case, monkeypatch, capsys):
    """The card's auto ``scan_steps`` (the trial switched on through the
    trainer's hook, its window times handed out by a clock, its constants
    cut to one window of two steps) in a port fit against JAX's unfused
    fit: the dispatches of each epoch (eager steps, the capturing dispatch,
    replays, and the choice from the trial's end on), one decision said
    once, every batch trained once and the epoch means within 1e-4."""
    import torch.distributed as dist

    from simple_vae_rs_tpu_torch.parallel.mesh import make_mesh

    lengths, ticks, want_log, want_k = _TRIALS[case]
    monkeypatch.setattr(health, "AUTO_SCAN_TRIAL_WINDOWS", 1)
    monkeypatch.setattr(health, "AUTO_SCAN_TRIAL_STEPS", 2)
    clock = iter(ticks)
    log = []

    def setup(tt):
        tt._trial_rule = True
        monkeypatch.setattr(tt, "_trial_clock", lambda: next(clock))
        inside = []

        def logged(name, fn):
            def run(*a, **k):
                if not inside:
                    log.append((tt.current_epoch, name))
                inside.append(name)
                try:
                    return fn(*a, **k)
                finally:
                    inside.pop()
            return run

        for attr, name in (("train_step", "step"), ("train_multi_step", "multi"),
                           ("_trial_capture", "capture")):
            monkeypatch.setattr(tt, attr, logged(name, getattr(tt, attr)))

    train = _Epochs(_batches(max(lengths), 4, 23, 32), lengths)
    gloo = case == "gloo-mesh"
    if gloo:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                                world_size=1)
    try:
        mesh = make_mesh() if gloo else None
        jt, jstate, jlog, tt, tlog, fused = _fit_both(
            train, train[:1], len(lengths), JTrainConfig(learning_rate=LR, scan_steps=1),
            TrainConfig(learning_rate=LR), monkeypatch, mesh=mesh, setup=setup)
    finally:
        if gloo:
            dist.destroy_process_group()
    got_log = [[name for epoch, name in log if epoch == e] for e in range(1, len(lengths) + 1)]
    assert got_log == want_log
    assert next(clock, None) is None  # every reading taken
    assert tt._auto_scan_k == want_k and tt._scan_trial is None and tt.graphs == {}
    assert capsys.readouterr().out.count("scan_steps auto:") == 1
    if not gloo:
        trial = tt.auto_scan_trial
        assert trial["k"] == want_k and trial["steps_a_window"] == 2
        assert len(trial["eager_windows_s"]) == len(trial["replay_windows_s"]) == 1
        assert trial["eager_ms"] == 1e3 * trial["eager_windows_s"][0] / 2 == 500.0
    assert tt.step == tt.opt.count == int(jstate.step) == sum(lengths)
    want, got = _losses(jlog), _losses(tlog)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4, err_msg=str(key))


def test_probes_time_out_and_answer(capsys):
    """``probe_backend`` gives the first round trip's latency, None past its
    budget (a stuck first contact) and None with the cause printed when the
    device fails; ``dispatch_latency`` the best warm round trip."""
    import io
    import threading

    assert health.probe_backend(10.0, device="cpu") >= 0.0
    assert health.dispatch_latency(device="cpu") >= 0.0
    release = threading.Event()
    real = health._round_trip
    try:
        health._round_trip = lambda device: release.wait(30)
        out = io.StringIO()
        assert health.probe_backend(0.2, progress=True, out=out, device="cpu") is None
    finally:
        release.set()
        health._round_trip = real
    out = io.StringIO()
    # a failure answers at once; the budget only bounds a hang (the first
    # meta-device call imports torch's meta kernels: 2 s here unloaded)
    assert health.probe_backend(60.0, device="meta", out=out) is None
    assert "device probe failed" in out.getvalue()
    assert health.dispatch_latency(device="meta") is None


# ----------------------------------------------------------- the optimizer
def _adam_before(opt, params, grads, lr):
    """The update ``ClipAdam`` made before its step could be captured, as it
    was written: the bias corrections and the learning rate as Python
    numbers, ``b1`` for a bfloat16 moment made by ``torch.tensor``."""
    g = opt.clip(grads)
    if opt.mu_dtype == torch.float32:
        mu = opt.mu
        torch._foreach_mul_(mu, opt.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - opt.b1)
    else:
        b1 = torch.tensor(opt.b1, dtype=opt.mu_dtype, device=g[0].device)
        decayed = [torch.empty_like(m, dtype=torch.float32) for m in opt.mu]
        torch._foreach_copy_(decayed, torch._foreach_mul(opt.mu, b1))
        mu = torch._foreach_mul(g, 1.0 - opt.b1)
        torch._foreach_add_(mu, decayed)
    torch._foreach_mul_(opt.nu, opt.b2)
    torch._foreach_addcmul_(opt.nu, g, g, value=1.0 - opt.b2)
    opt.count += 1

    def corr(decay):
        return float(np.float32(1.0) - np.float32(decay) ** np.float32(opt.count))

    denom = torch._foreach_div(opt.nu, corr(opt.b2))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, opt.eps)
    updates = torch._foreach_div(mu, corr(opt.b1))
    torch._foreach_div_(updates, denom)
    if opt.mu_dtype != torch.float32:
        torch._foreach_copy_(opt.mu, mu)
    torch._foreach_add_(params, updates, alpha=-lr)


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_clip_adam_on_device_numbers_is_bit_equal_to_before(mu_dtype):
    """Five steps (the clip engaging, idling, engaging): ``step`` with the
    learning rate a 0-dim tensor and each count's row of ``corrections``
    (what an eager and a captured step read), against the update as it was
    written before, with Python numbers: the same parameters, moments and
    count to the bit."""
    rng = np.random.default_rng(12)
    shapes = [(3, 4), (5,), (), (2, 3, 3, 7)]
    p0 = [torch.from_numpy(np.asarray(rng.standard_normal(s), np.float32)) for s in shapes]
    runs = {name: ([p.clone() for p in p0], ClipAdam(p0, mu_dtype=mu_dtype))
            for name in ("before", "tensors")}
    lr = 3e-3
    lr_t = torch.tensor(lr, dtype=torch.float32)
    table = runs["tensors"][1].corrections(5)
    for step, scale in enumerate((3.0, 0.05, 10.0, 2.0, 0.5)):
        grads = [torch.from_numpy(np.asarray(rng.standard_normal(s) * scale / 3, np.float32))
                 for s in shapes]
        params, opt = runs["before"]
        with torch.no_grad():
            _adam_before(opt, params, grads, lr)
        params, opt = runs["tensors"]
        row = opt.corrections()[0]
        assert torch.equal(row, table[step])
        opt.step(params, grads, lr_t, row)
    want_p, want = runs["before"]
    params, opt = runs["tensors"]
    assert opt.count == want.count == 5
    for a, b in zip(params + opt.mu + opt.nu, want_p + want.mu + want.nu):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------------ a gloo mesh
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_scan_steps_is_the_one_process_scan(tmp_path):
    """Two gloo ranks (``data=2``) run two steps as one ``train_multi_step``
    on their halves of two global batches, with the global noise of the
    shared generator: the terms, statistics and parameters of one process
    on the global batches (the rules of ``tests/test_torch_port_mesh.py``:
    terms 1e-4 relative, statistics rtol 1e-4, parameters within 2 lr a
    step), the same update on both ranks; and the auto mode's decision is
    rank 0's on both (rank 1's probe says otherwise)."""
    m = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(0)
    batches = [tuple(torch.from_numpy(t) for t in b) for b in _batches(2, 8, 31)]
    inp = {"ps": PS, "weights": m.state_dict(), "lr": LR, "scan": batches, "seed": 3}
    torch.save(inp, tmp_path / "in.pt")
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, WORKER, str(tmp_path / "in.pt"),
                                       str(tmp_path)], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    one = Trainer(m, TrainConfig(learning_rate=LR, scan_steps=2), device="cpu", seed=3)
    terms = one.train_multi_step(engine.stack_batches(batches), lr=LR)
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)["scan"] for r in range(2)]
    buffers = dict(one.model.named_buffers())
    for r in ranks:
        assert r["step"] == r["count"] == 2
        assert r["auto_k"] == 2  # rank 0 probed a dispatch-bound link, rank 1 a fast one
        for k, v in terms.items():
            assert abs(float(r["terms"][k]) - float(v)) <= 1e-4 * abs(float(v)), k
        for name, v in r["buffers"].items():
            torch.testing.assert_close(v, buffers[name], rtol=1e-4, atol=1e-5)
        for name, v in r["params"].items():
            assert float((v - one.params[name].detach()).abs().max()) <= 2 * 2 * LR, name
    for name in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name])
