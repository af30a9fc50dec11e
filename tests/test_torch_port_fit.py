"""The port's epoch loop against the JAX package's ``Trainer.fit``, on the CPU.

The same weights (the JAX trainer's initial state, carried over by
``load_jax_variables``), the same batches (numpy, seeded) and the same noise:
the port's noise source (``Trainer.stream_noise``) is replaced by the draws
the JAX engine makes from its keys (``fold_in(state.rng, step)`` for a train
or pre-training step, ``fold_in(state.rng, 0xFFF1/2/3)`` for the val,
eval-metrics and eval-image steps). Float32 on both sides, the port on its
plain versions (what a CPU tensor runs).

Tolerances, with their reasons:

- every logged metric (the loss terms averaged over an epoch, the gammas,
  SSIM, PSNR, the baseline) within 1e-4 relative: float32 through about 50
  layers and a few optimizer steps, summed in other orders;
- the parameters after the fit: not to 1e-4 relative element by element.
  Adam moves an element by about lr * sign(g) per step whatever |g| is, so an
  element whose gradient is rounding noise (a bias that BatchNorm follows has
  a true gradient of 0; a conv weight that BatchNorm follows cancels to
  near 0 in places) or changes sign between steps may go either way: each
  element within 2 * lr per optimizer step (the rule of the training-step
  tests, ``test_torch_port_train.py``), and the whole difference within 5% of
  the JAX fit's own movement in norm, ||port - JAX|| <= 0.05 ||JAX - init||
  (a wrong lr, a lost step or a wrong gradient leaf moves it to the order
  of 100%); the BatchNorm running variances rtol 1e-4, atol
  1e-5, the running means within 2 * lr per step (a running mean carries the
  bias of the conv before it, which moves by the rule above).
"""

import numpy as np
import jax
import pytest
import torch

from simple_vae_rs_tpu.config import CondSRVAEConfig as JConfig
from simple_vae_rs_tpu.config import TrainConfig as JTrainConfig
from simple_vae_rs_tpu.config import VAEConfig as JVAEConfig
from simple_vae_rs_tpu.models import CondSRVAE as JCondSRVAE
from simple_vae_rs_tpu.models import VAE as JVAE
from simple_vae_rs_tpu.models.srvae import SRVAE as JSRVAE
from simple_vae_rs_tpu.train.engine import Trainer as JTrainer

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, TrainConfig, VAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.srvae import SRVAE
from simple_vae_rs_tpu_torch.models.vae import VAE
from simple_vae_rs_tpu_torch.train import engine
from simple_vae_rs_tpu_torch.train.engine import Trainer
from simple_vae_rs_tpu_torch.utils.jax_weights import _flatten, load_jax_variables

PS = 32  # LR 16: SSIM's 11-pixel windows fit
LR = 1e-4
CONSTS = {"val": 0xFFF1, "metrics": 0xFFF2, "images": 0xFFF3}


class ListLogger:
    def __init__(self):
        self.records, self.images, self.finished = [], [], False

    def log(self, metrics, step=None):
        self.records.append((step, {k: float(v) for k, v in metrics.items()}))

    def log_images(self, images, step=None):
        self.images.append((step, sorted(images)))

    def finish(self):
        self.finished = True


def _batches(n, bs, seed):
    rng = np.random.default_rng(seed)
    return [(rng.random((bs, PS // 2, PS // 2, 4), dtype=np.float32),
             rng.random((bs, PS, PS, 4), dtype=np.float32)) for _ in range(n)]


def _jax_noise(kind, cfg, rng, trainer):
    """The port's ``stream_noise`` replaced by the JAX engine's draws."""
    def draw(stream, b, hw):
        if stream in ("train", "pretrain"):
            key = jax.random.fold_in(rng, trainer.step)
        else:
            key = jax.random.fold_in(rng, CONSTS[stream])
        if kind == "vae":  # JAX VAE: reparameterize(rng, mu, logvar) on (B, dim)
            return (torch.from_numpy(np.array(
                jax.random.normal(key, (b, cfg.latent_dim)))),)
        g = cfg.patch_size // 8
        if stream == "pretrain":  # lr_autoencode: reparameterize(rng, ...) unsplit
            return (torch.from_numpy(np.array(jax.random.normal(key, (b, g, g, cfg.u_channels)))),)
        ku, kz = jax.random.split(key)
        return (torch.from_numpy(np.array(jax.random.normal(ku, (b, g, g, cfg.u_channels)))),
                torch.from_numpy(np.array(jax.random.normal(kz, (b, g, g, cfg.z_channels)))))
    return draw


_MODELS = {
    "cond": (lambda: JCondSRVAE(JConfig(cr=2.0, patch_size=PS)),
             lambda: CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS))),
    "srvae": (lambda: JSRVAE(JConfig(cr=2.0, patch_size=PS)),
              lambda: SRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS))),
    "vae": (lambda: JVAE(JVAEConfig(cr=2.0, patch_size=PS // 2)),
            lambda: VAE(VAEConfig(cr=2.0, patch_size=PS // 2))),
}


def _run_both(kind, epochs, pre_epochs, train, val, monkeypatch):
    """One JAX fit and one port fit from the same state on the same data and
    noise: the loggers, the JAX initial and final states and the port
    trainer."""
    jmodel_fn, tmodel_fn = _MODELS[kind]
    jlog, tlog = ListLogger(), ListLogger()
    jt = JTrainer(jmodel_fn(), JTrainConfig(learning_rate=LR, scan_steps=1), logger=jlog)
    state = jt.init_state(train[0])
    state0 = jax.device_get(state)
    tmodel = tmodel_fn()
    load_jax_variables(tmodel, {"params": state0.params, "batch_stats": state0.batch_stats})
    tt = Trainer(tmodel, TrainConfig(learning_rate=LR), device="cpu", logger=tlog)
    monkeypatch.setattr(tt, "stream_noise", _jax_noise(kind, tmodel.config, state0.rng, tt))
    if pre_epochs:
        jt.pretrain_lr_branch(train, pre_epochs)
        tt.pretrain_lr_branch(train, pre_epochs)
    state = jt.fit(train, val, epochs=epochs, val_metrics_every=1)
    tt.fit(train, val, epochs=epochs, val_metrics_every=1)
    return {"jlog": jlog, "state0": state0, "jstate": jax.device_get(state), "tlog": tlog,
            "tt": tt}


def _by_step(records):
    out = {}
    for step, metrics in records:
        for k, v in metrics.items():
            assert (step, k) not in out, (step, k)
            out[(step, k)] = v
    return out


@pytest.fixture(scope="module")
def cond_fit():
    mp = pytest.MonkeyPatch()
    try:
        yield _run_both("cond", 2, 1, _batches(2, 4, 0), _batches(1, 4, 1), mp)
    finally:
        mp.undo()


def test_fit_logs_the_jax_metrics(cond_fit):
    jlog, tlog = cond_fit["jlog"], cond_fit["tlog"]
    want, got = _by_step(jlog.records), _by_step(tlog.records)
    assert sorted(got) == sorted(want)
    assert {k for _, k in got} == set(engine.FIT_KEYS["cond"]) | {engine.PRETRAIN_KEY}
    for key, w in want.items():
        if key[1] == "Perf/train_epoch_seconds":
            continue
        np.testing.assert_allclose(got[key], w, rtol=1e-4, err_msg=str(key))
    # the image panel at epoch 1 (cadence 10), the same names; finish() called
    assert tlog.images == jlog.images == [(1, sorted(jlog.images[0][1]))]
    assert tlog.finished and jlog.finished


def test_fit_final_parameters_match_jax(cond_fit):
    jstate, tt = cond_fit["jstate"], cond_fit["tt"]
    steps = tt.step
    assert steps == int(jstate.step) == 2 + 4  # pre-training 2 steps, then 2 epochs of 2
    init = _flatten(cond_fit["state0"].params)
    diff2 = moved2 = 0.0
    for name, w in _flatten(jstate.params).items():
        diff = tt.params[name].detach().numpy() - w
        assert np.abs(diff).max() <= 2 * LR * steps, name
        diff2 += float((diff.astype(np.float64) ** 2).sum())
        moved2 += float(((w - init[name]).astype(np.float64) ** 2).sum())
    assert diff2 ** 0.5 <= 0.05 * moved2 ** 0.5
    stats = dict(tt.model.named_buffers())
    for name, w in _flatten(jstate.batch_stats).items():
        if name.endswith(".mean"):
            assert np.abs(stats[name].numpy() - w).max() <= 2 * LR * steps, name
        else:
            np.testing.assert_allclose(stats[name].numpy(), w, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("kind", ["srvae", "vae"])
def test_one_epoch_fit_of_the_other_families_matches_jax(kind, monkeypatch):
    run = _run_both(kind, 1, 0, _batches(1, 4, 2), _batches(1, 4, 3), monkeypatch)
    want, got = _by_step(run["jlog"].records), _by_step(run["tlog"].records)
    assert sorted(got) == sorted(want)
    assert {k for _, k in got} == set(engine.FIT_KEYS[kind])
    for key, w in want.items():
        if key[1] != "Perf/train_epoch_seconds":
            np.testing.assert_allclose(got[key], w, rtol=1e-4, err_msg=str(key))


# ------------------------------------------------------ LR pre-training
def _lr_branch(name):
    return name.split(".")[0].startswith(("ey_", "dy_")) or name == "gammay"


def test_lr_autoencode_and_pretraining_match_jax(monkeypatch):
    """``lr_autoencode`` in training mode, then two pre-training steps (one
    pre-epoch over two batches) from the same state and noise: only the LR
    branch moves, on both sides."""
    train = _batches(2, 4, 4)
    jt = JTrainer(JCondSRVAE(JConfig(cr=2.0, patch_size=PS)),
                  JTrainConfig(learning_rate=LR), logger=(jlog := ListLogger()))
    state0 = jax.device_get(jt.init_state(train[0]))
    variables = {"params": state0.params, "batch_stats": state0.batch_stats}
    key = jax.random.PRNGKey(3)
    y = train[0][0]
    (want, _) = jt.model.apply(variables, y, key, True, method=JCondSRVAE.lr_autoencode,
                               mutable=["batch_stats"])
    tmodel = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS))
    load_jax_variables(tmodel, variables)
    g = PS // 8
    eps_u = torch.from_numpy(np.array(jax.random.normal(key, (4, g, g, tmodel.config.u_channels))))
    tmodel.train()
    got = tmodel.lr_autoencode(torch.from_numpy(y), eps_u)
    for gt, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(gt.detach().numpy() - w).max() <= 1e-5 * np.abs(w).max()

    load_jax_variables(tmodel, variables)  # the forward above moved the statistics
    tt = Trainer(tmodel, TrainConfig(learning_rate=LR), device="cpu", logger=(tlog := ListLogger()))
    monkeypatch.setattr(tt, "stream_noise", _jax_noise("cond", tmodel.config, state0.rng, tt))
    jt.pretrain_lr_branch(train, 1)
    tt.pretrain_lr_branch(train, 1)
    assert tt.step == int(jt.state.step) == 2
    ((_, w_log),), ((_, g_log),) = jlog.records, tlog.records
    assert list(g_log) == list(w_log) == [engine.PRETRAIN_KEY]
    np.testing.assert_allclose(g_log[engine.PRETRAIN_KEY], w_log[engine.PRETRAIN_KEY], rtol=1e-5)
    init, want_params = _flatten(state0.params), _flatten(jax.device_get(jt.state.params))
    for name, w in want_params.items():
        got_p = tt.params[name].detach().numpy()
        if _lr_branch(name):
            assert np.abs(got_p - w).max() <= 2 * LR * 2, name  # Adam's rule, two steps
        else:  # not touched by the loss: zero gradients, zero Adam updates
            assert np.array_equal(got_p, init[name]) and np.array_equal(w, init[name]), name
    assert any(not np.array_equal(want_params[n], init[n]) for n in init if _lr_branch(n))


def test_pretraining_an_srvae_uses_its_box_downsampled_view():
    model = SRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(0)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    tt = Trainer(model, TrainConfig(learning_rate=LR), device="cpu", logger=(log := ListLogger()))
    tt.pretrain_lr_branch(_batches(1, 2, 5), 2)
    assert [r[0] for r in log.records] == [1, 2] and tt.step == 2
    for name, p in model.named_parameters():
        moved = not torch.equal(p, before[name])
        assert moved == _lr_branch(name.split(".", 1)[1]), name
    vae = VAE(VAEConfig(cr=2.0, patch_size=PS // 2)).init_weights(0)
    tv = Trainer(vae, device="cpu")
    tv.pretrain_lr_branch(_batches(1, 2, 5), 2)  # a VAE has no LR branch
    assert tv.step == 0


# ------------------------------------------------------------ guards
def test_nan_loss_aborts_fit_with_the_jax_message():
    bad = [(np.full((2, PS // 2, PS // 2, 4), np.nan, np.float32),
            np.full((2, PS, PS, 4), np.nan, np.float32))]
    tt = Trainer(CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(0),
                 TrainConfig(epochs=1), device="cpu", logger=(log := ListLogger()))
    with pytest.raises(ValueError, match=r"^NaN detected in training loss at epoch 1\. "
                                         r"Check your model and data\.$"):
        tt.fit(bad, bad, epochs=1, val_metrics_every=10)
    assert log.finished


def test_sigterm_finishes_the_epoch_and_writes_a_preemption_checkpoint(tmp_path):
    import os
    import signal

    from simple_vae_rs_tpu_torch.train.callbacks import ModelCheckpoint
    from simple_vae_rs_tpu_torch.train.checkpoint import load_checkpoint

    class Preempt:
        """SIGTERM to this process at the end of epoch 2."""

        def on_epoch_begin(self, **kw):
            return False

        def on_epoch_end(self, **kw):
            if kw.get("epoch") == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return False

    batches = _batches(1, 2, 6)
    cb = ModelCheckpoint("job", str(tmp_path), monitor="Loss/val_loss")
    tt = Trainer(CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(0),
                 TrainConfig(learning_rate=1e-3), device="cpu", callbacks=[Preempt(), cb])
    tt.fit(batches, batches, epochs=9, val_metrics_every=9)
    assert tt.current_epoch == 2
    fresh = Trainer(CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)), device="cpu")
    meta = load_checkpoint(str(tmp_path / "job_preempt"), fresh)
    assert meta["epoch"] == 2 and meta["model"]["type"] == "Cond_SRVAE"
    assert meta["scheduler"] == tt.scheduler.state_dict() == fresh.scheduler.state_dict()
    assert fresh.step == tt.step == 2
    for name, p in tt.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[name], p), name
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


# ------------------------------------------------------------ remat
@pytest.mark.parametrize("accum", [1, 2])
def test_remat_step_is_the_plain_step_with_one_statistics_update(accum):
    """``remat`` recomputes each microbatch's forward in the backward (each
    conv's forward runs twice) and gives the plain step's gradients, terms
    and running statistics to the bit: the recomputation leaves the
    statistics alone."""
    from simple_vae_rs_tpu_torch.ops.conv_blocks import Conv3x3

    batch = _batches(1, 4, 7)[0]
    runs = {}
    for remat in (False, True):
        model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(0)
        calls = []
        for mod in model.modules():
            if isinstance(mod, Conv3x3):
                mod.register_forward_pre_hook(lambda m, a: calls.append(1))
        tt = Trainer(model, TrainConfig(remat=remat, accum_steps=accum), device="cpu", seed=1)
        before = {k: v.clone() for k, v in model.named_buffers()}
        grads, terms = tt.grads_and_terms(batch)
        runs[remat] = (grads, terms, dict(model.named_buffers()), len(calls), before)
    (g0, t0, s0, n0, init), (g1, t1, s1, n1, _) = runs[False], runs[True]
    assert n1 == 2 * n0 > 0
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    for key in t0:
        assert torch.equal(t0[key], t1[key]), key
    for name in s0:
        assert torch.equal(s0[name], s1[name]), name
    assert any(not torch.equal(s0[n], init[n]) for n in s0)


@pytest.mark.parametrize("epochs,traced", [(3, 2), (1, 1)])
def test_profile_dir_traces_the_second_epoch(tmp_path, epochs, traced):
    """``profile_dir`` writes a profiler trace of the second trained epoch
    (the first pays for the kernel builds), or of the last of a shorter run."""
    batches = _batches(1, 2, 8)
    tt = Trainer(CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(0),
                 TrainConfig(profile_dir=str(tmp_path / "prof")), device="cpu")
    tt.fit(batches, batches, epochs=epochs, val_metrics_every=10)
    assert sorted(p.name for p in (tmp_path / "prof").iterdir()) == [
        f"train_epoch_{traced}.json"]
