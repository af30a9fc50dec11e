"""The port's evaluation pieces against the JAX package, on the CPU: the
metrics, the bicubic baseline, the plateau schedule, the callbacks, the
JSONL logger, LPIPS, ``Trainer.evaluate`` and the reference-checkpoint
converter.

Tolerances, with their reasons:

- SSIM, PSNR, MSE: 1e-5 relative (float32 window sums in another order);
- bicubic 2x: 1e-6 absolute on [0, 1] images (four taps in float32 either
  way), and the same against ``F.interpolate(mode="bicubic")``, the
  reference's baseline itself;
- the schedule, the callbacks' decisions, the logger's keys and steps, the
  converter's trees: equal;
- LPIPS on synthetic AlexNet-shaped weights: 1e-5 relative (five float32
  conv layers, XLA's against PyTorch's);
- ``Trainer.evaluate`` with JAX's noise injected: every metric 1e-4
  relative (the models' forward, as the serving tests), the bicubic baseline
  1e-5; both with an absolute 1e-6 beside, because the mean SSIM of random
  images lies near 0 (a mean of signed window values that cancels), where
  the float32 window sums' own error (about 1e-7) is no small share of it.
"""

import json
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from simple_vae_rs_tpu.config import CondSRVAEConfig as JConfig
from simple_vae_rs_tpu.config import TrainConfig as JTrainConfig
from simple_vae_rs_tpu.config import VAEConfig as JVAEConfig
from simple_vae_rs_tpu.models import CondSRVAE as JCondSRVAE
from simple_vae_rs_tpu.models import VAE as JVAE
from simple_vae_rs_tpu.ops import lpips as jlpips
from simple_vae_rs_tpu.ops import metrics as jmetrics
from simple_vae_rs_tpu.ops.resize import bicubic_upsample_2x as j_bicubic
from simple_vae_rs_tpu.train import callbacks as jcb
from simple_vae_rs_tpu.train import checkpoint as jck
from simple_vae_rs_tpu.train.engine import Trainer as JTrainer
from simple_vae_rs_tpu.train.schedule import ReduceLROnPlateau as JPlateau
from simple_vae_rs_tpu.utils import convert as jconvert
from simple_vae_rs_tpu.utils import logging as jlogging
from simple_vae_rs_tpu.utils import lpips_optional as jlo

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, TrainConfig, VAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.vae import VAE
from simple_vae_rs_tpu_torch.ops import lpips as tlpips
from simple_vae_rs_tpu_torch.ops import metrics as tmetrics
from simple_vae_rs_tpu_torch.ops.resize import bicubic_upsample_2x
from simple_vae_rs_tpu_torch.train import callbacks as tcb
from simple_vae_rs_tpu_torch.train import checkpoint as tck
from simple_vae_rs_tpu_torch.train.engine import Trainer
from simple_vae_rs_tpu_torch.train.schedule import ReduceLROnPlateau
from simple_vae_rs_tpu_torch.utils import convert as tconvert
from simple_vae_rs_tpu_torch.utils import logging as tlogging
from simple_vae_rs_tpu_torch.utils import lpips_optional as tlo
from simple_vae_rs_tpu_torch.utils.jax_weights import _flatten, load_jax_variables
from tests.test_convert import _synthesize_state_dict
from tests.test_lpips import _write_random_weights
from tests.test_torch_port_fit import ListLogger, _batches, _jax_noise

PS = 32


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


# ------------------------------------------------------------- metrics
@pytest.mark.parametrize("shape", [(3, 16, 16, 4), (2, 11, 13, 3), (1, 32, 24, 1)])
def test_metrics_match_jax(shape):
    a, b = _pair(shape, sum(shape))
    for name in ("ssim", "psnr", "batch_mse"):
        want = np.asarray(getattr(jmetrics, name)(a, b))
        got = getattr(tmetrics, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        assert got.shape == want.shape == (shape[0],)
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    assert float(tmetrics.psnr(torch.ones(1, 4, 4, 1), torch.ones(1, 4, 4, 1))) == 120.0


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 5, 7, 3), (3, 1, 2, 2)])
def test_bicubic_matches_jax_and_torch_interpolate(shape):
    y = np.random.default_rng(shape[1]).random(shape, dtype=np.float32)
    got = bicubic_upsample_2x(torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_bicubic(y)), rtol=0, atol=1e-6)
    ref = F.interpolate(torch.from_numpy(y).permute(0, 3, 1, 2), scale_factor=2,
                        mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)


# --------------------------------------------------------- schedule
def test_plateau_schedule_follows_jax():
    rng = np.random.default_rng(0)
    metrics = list(np.cumsum(rng.standard_normal(60)) + 100) + [50.0] * 10
    for patience, factor, mode in ((2, 0.5, "min"), (0, 0.1, "max"), (5, 0.5, "min")):
        j = JPlateau(lr=1e-3, mode=mode, factor=factor, patience=patience, min_lr=1e-6)
        t = ReduceLROnPlateau(lr=1e-3, mode=mode, factor=factor, patience=patience, min_lr=1e-6)
        assert [t.step(float(m)) for m in metrics] == [j.step(float(m)) for m in metrics]
        assert t.state_dict() == j.state_dict() and t.get_last_lr() == j.get_last_lr()
        u = ReduceLROnPlateau(lr=1.0)
        u.load_state_dict(t.state_dict())
        assert u.state_dict() == t.state_dict()
    with pytest.raises(ValueError):
        ReduceLROnPlateau(lr=1.0, mode="median")


# -------------------------------------------------------- callbacks
_LOGS = [{"Loss/val_loss": v, "Loss/val_mse_x": v / 2} for v in
         (10.0, 9.0, 9.005, 9.5, 8.0, 8.2, 8.3, 8.4, 7.99, 8.5, 9.0, 9.1)]


@pytest.mark.parametrize("patience,delta,monitor", [(2, 0.01, "Loss/val_loss"),
                                                    (3, 0.0, "val_loss"),
                                                    (1, 0.5, "mse")])
def test_early_stopping_decides_as_jax(patience, delta, monitor):
    j = jcb.EarlyStopping(patience=patience, delta=delta, monitor=monitor)
    t = tcb.EarlyStopping(patience=patience, delta=delta, monitor=monitor)
    for epoch, logs in enumerate(_LOGS, 1):
        assert t.on_epoch_end(epoch=epoch, logs=logs) == j.on_epoch_end(epoch=epoch, logs=logs)
        assert (t.monitor, t.counter, t.best_loss, t.best_epoch) == (
            j.monitor, j.counter, j.best_loss, j.best_epoch)
    assert t.on_epoch_begin() is False and t.on_epoch_end(logs={}) is False


@pytest.mark.parametrize("mode,best_only", [("min", True), ("max", True), ("min", False)])
def test_model_checkpoint_saves_as_jax(mode, best_only, monkeypatch):
    saved = {"jax": [], "port": []}
    monkeypatch.setattr(jck, "save_checkpoint", lambda path, state, epoch, extra, block:
                        saved["jax"].append((path, epoch, extra, block)))
    monkeypatch.setattr(tck, "save_checkpoint", lambda path, trainer, epoch, extra, block:
                        saved["port"].append((path, epoch, extra, block)))
    j = jcb.ModelCheckpoint("job", "ck", mode=mode, save_best_only=best_only, async_save=True)
    t = tcb.ModelCheckpoint("job", "ck", mode=mode, save_best_only=best_only, async_save=True)
    for epoch, logs in enumerate(_LOGS, 1):
        extra = {"model": {"type": "x"}, "epoch_seen": epoch}
        assert not j.on_epoch_end(epoch=epoch, logs=logs, state=object(), extra=extra)
        assert not t.on_epoch_end(epoch=epoch, logs=logs, trainer=object(), extra=extra)
    assert t.monitor == j.monitor == "Loss/val_loss"  # "val_loss" resolved at epoch 1
    assert saved["port"] == saved["jax"] and saved["port"]
    assert (t.best_metric, t.best_epoch) == (j.best_metric, j.best_epoch)
    with pytest.raises(ValueError):
        tcb.ModelCheckpoint("job", "ck").on_epoch_end(epoch=1, logs={}, trainer=object())


# ------------------------------------------------------------ logging
def test_jsonl_logger_writes_the_jax_lines(tmp_path):
    calls = [({"Loss/loss": 1.5, "Loss/kld_u": np.float32(0.25)}, 1),
             ({"Metrics/SSIM_SR": 0.5}, 1), ({"Loss/pretrain_y_loss": 3.0}, None)]
    lines = {}
    for side, mod in (("jax", jlogging), ("port", tlogging)):
        log = mod.JsonlLogger(str(tmp_path / side))
        for metrics, step in calls:
            log.log(metrics, step=step)
        log.finish()
        with open(tmp_path / side / "metrics.jsonl") as fh:
            lines[side] = [json.loads(line) for line in fh]
    for got, want in zip(lines["port"], lines["jax"], strict=True):
        assert list(got) == list(want) and got["_step"] == want["_step"]
        assert {k: v for k, v in got.items() if k != "_time"} == {
            k: v for k, v in want.items() if k != "_time"}
    log = tlogging.JsonlLogger(str(tmp_path / "t"))
    log.log({"x": torch.tensor(2.5)}, step=3)  # a 0-dim tensor is a number
    log.finish()
    assert json.loads(open(tmp_path / "t" / "metrics.jsonl").read())["x"] == 2.5
    tlogging.NullLogger().log({"a": 1})


def test_png_panels_are_the_jax_bytes(tmp_path):
    pytest.importorskip("PIL")
    img = np.random.default_rng(3).random((8, 8, 4), dtype=np.float32)
    assert tlogging.to_png_bytes(img) == jlogging.to_png_bytes(img)
    assert tlogging.to_png_bytes(torch.from_numpy(img[..., :1])) == \
        jlogging.to_png_bytes(img[..., :1])
    log = tlogging.JsonlLogger(str(tmp_path))
    log.log_images({"Images/SR_Output": torch.from_numpy(img[None].repeat(2, 0))}, step=4)
    log.finish()
    assert sorted(p.name for p in (tmp_path / "images").iterdir()) == [
        "Images_SR_Output_s4_0.png", "Images_SR_Output_s4_1.png"]


def test_images_are_skipped_without_pil(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert tlogging.to_png_bytes(np.zeros((4, 4, 4), np.float32)) is None
    log = tlogging.JsonlLogger(str(tmp_path))
    log.log_images({"Images/Input": np.zeros((1, 4, 4, 4), np.float32)}, step=1)
    log.finish()
    assert list((tmp_path / "images").iterdir()) == []


def test_make_logger_falls_back_to_jsonl(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    log = tlogging.make_logger("Cond_SRVAE", "run", {}, run_dir=str(tmp_path))
    assert isinstance(log, tlogging.JsonlLogger)
    assert log.run_dir == str(tmp_path / "Cond_SRVAE-run")
    log.finish()


# -------------------------------------------------------------- LPIPS
@pytest.fixture
def lpips_weights(tmp_path, monkeypatch):
    path = _write_random_weights(tmp_path / "lpips_alex.npz")
    monkeypatch.setenv("SVRS_LPIPS_WEIGHTS", path)
    jlo.reset()
    yield path
    jlo.reset()


@pytest.mark.parametrize("shape", [(3, 16, 16, 4), (2, 35, 35, 3), (1, 11, 12, 1)])
def test_lpips_matches_jax(lpips_weights, shape):
    a, b = _pair(shape, shape[1])
    want = np.asarray(jlpips.lpips(a, b, jlpips.load_weights(lpips_weights)))
    params = tlo.load("cpu")
    got = tlo.lpips_batch(torch.from_numpy(a), torch.from_numpy(b), params).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(tlpips.lpips(torch.from_numpy(a), torch.from_numpy(a), params).abs().max()) == 0
    assert tlo.lpips_batch(torch.zeros(1, 10, 10, 4), torch.zeros(1, 10, 10, 4), params) is None


def test_lpips_eps_sits_outside_the_sqrt(tmp_path):
    """With features near 1e-9 the two eps placements differ by orders of
    magnitude (||x|| + 1e-10 against sqrt(||x||^2 + 1e-10) ~ 1e-5): the port
    follows JAX and the lpips package (x / (||x|| + 1e-10))."""
    rng = np.random.default_rng(11)
    arrays = {"shift": np.array([-0.030, -0.088, -0.188], np.float32),
              "scale": np.array([0.458, 0.448, 0.450], np.float32)}
    for i, s in enumerate([(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3),
                           (256, 384, 3, 3), (256, 256, 3, 3)]):
        arrays[f"conv{i}_w"] = (rng.standard_normal(s) * (1e-9 if i == 0 else 1.0)).astype(
            np.float32)
        arrays[f"conv{i}_b"] = np.zeros(s[0], np.float32)
        arrays[f"lin{i}"] = rng.random(s[0]).astype(np.float32)
    path = str(tmp_path / "tiny.npz")
    np.savez(path, **arrays)
    a, b = _pair((2, 35, 35, 4), 12)
    want = np.asarray(jlpips.lpips(a, b, jlpips.load_weights(path)))
    params = {k: torch.from_numpy(v) for k, v in tlpips.load_weights(path).items()}
    got = tlpips.lpips(torch.from_numpy(a), torch.from_numpy(b), params).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    # eps inside the sqrt would give another value by far
    fa = F.relu(F.conv2d((torch.from_numpy(a[..., [2, 1, 0]]).permute(0, 3, 1, 2)
                          - params["shift"].view(1, 3, 1, 1)) / params["scale"].view(1, 3, 1, 1),
                         params["conv0_w"], stride=4, padding=2))
    norm = torch.sqrt((fa * fa).sum(dim=1))
    assert float(norm.max()) < 1e-6  # the tap really is in the eps regime


def test_lpips_is_absent_without_weights_and_downloads_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("SVRS_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))

    def no_download(*a, **k):
        raise AssertionError("a download was tried")

    stub = types.ModuleType("lpips")
    stub.LPIPS = no_download
    monkeypatch.setitem(sys.modules, "lpips", stub)
    monkeypatch.setattr(torch.hub, "load_state_dict_from_url", no_download)
    monkeypatch.setattr(torch.hub, "download_url_to_file", no_download)
    assert tlo.load("cpu") is None
    assert tlo.lpips_batch(torch.zeros(1, 16, 16, 4), torch.zeros(1, 16, 16, 4), None) is None
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip")
    assert tlpips.load_weights(str(bad)) is None


# ------------------------------------------------- Trainer.evaluate
def _eval_pair(kind, monkeypatch):
    if kind == "cond":
        jm, tm = JCondSRVAE(JConfig(cr=2.0, patch_size=PS)), CondSRVAE(
            CondSRVAEConfig(cr=2.0, patch_size=PS))
    else:
        jm, tm = JVAE(JVAEConfig(cr=2.0, patch_size=PS // 2)), VAE(
            VAEConfig(cr=2.0, patch_size=PS // 2))
    val = _batches(2, 5, 20)
    jt = JTrainer(jm, JTrainConfig(), logger=(jlog := ListLogger()))
    state = jax.device_get(jt.init_state(val[0]))
    load_jax_variables(tm, {"params": state.params, "batch_stats": state.batch_stats})
    tt = Trainer(tm, TrainConfig(), device="cpu", logger=(tlog := ListLogger()))
    monkeypatch.setattr(tt, "stream_noise", _jax_noise(kind, tm.config, state.rng, tt))
    return jt, jlog, tt, tlog, val


@pytest.mark.parametrize("kind", ["cond", "vae"])
def test_evaluate_logs_the_jax_metrics_with_lpips(kind, lpips_weights, monkeypatch):
    jt, jlog, tt, tlog, val = _eval_pair(kind, monkeypatch)
    if kind == "cond":
        jt.baseline_metrics = jt.compute_bicubic_baseline(val)
        tt.baseline_metrics = tt.compute_bicubic_baseline(val)
        assert sorted(tt.baseline_metrics) == ["lpips_base", "psnr_base", "ssim_base"]
        for k, w in jt.baseline_metrics.items():
            np.testing.assert_allclose(tt.baseline_metrics[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    jt.evaluate(val, 1, full_val=True)
    tt.evaluate(val, 1, full_val=True)
    (step_w, want), (step_g, got) = jlog.records[0], tlog.records[0]
    assert step_w == step_g == 1 and sorted(got) == sorted(want)
    assert any("LPIPS" in k for k in got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6, err_msg=k)
    assert tlog.images == jlog.images == [(1, sorted(jlog.images[0][1]))]


def test_evaluate_without_full_val_logs_images_on_the_cadence(monkeypatch):
    _, _, tt, tlog, val = _eval_pair("cond", monkeypatch)
    for epoch in (2, 10, 11):
        tt.evaluate(val, epoch, full_val=False)
    assert tlog.records == [] and [s for s, _ in tlog.images] == [10]
    assert tt.compute_bicubic_baseline([]) == {}
    tt.evaluate([], 1, full_val=True)  # an empty loader logs nothing
    assert tlog.records == []


# ---------------------------------------------------------- converter
@pytest.mark.parametrize("kind", ["cond", "vae", "cond_regroup"])
def test_convert_matches_jax_and_exports_back(kind, tmp_path):
    if kind == "vae":
        jm, tm = JVAE(JVAEConfig(cr=2.0, patch_size=16)), VAE(VAEConfig(cr=2.0, patch_size=16))
        mapping, convert = jconvert._VAE_ENCODER + jconvert._VAE_DECODER, "vae"
        x = jnp.zeros((1, 16, 16, 4))
        variables = jm.init({"params": jax.random.PRNGKey(0)}, x, jax.random.PRNGKey(1),
                            train=False)
    else:
        jm = JCondSRVAE(JConfig(cr=2.0, patch_size=16))
        tm = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=16,
                                       torch_regroup=kind == "cond_regroup"))
        mapping, convert = jconvert._COND_MAP, "cond"
        variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16, 16, 4)),
                            jnp.zeros((1, 8, 8, 4)), jax.random.PRNGKey(1), train=False)
    sd = _synthesize_state_dict(mapping, jax.device_get(variables))
    want = getattr(jconvert, f"convert_{convert}_state_dict")(sd)
    got = getattr(tconvert, f"convert_{convert}_state_dict")(sd)
    for col in ("params", "batch_stats"):
        w, g = _flatten(want[col]), _flatten(got[col])
        assert sorted(g) == sorted(w)
        assert all(np.array_equal(g[k], w[k]) for k in w)
    ref = load_jax_variables(type(tm)(tm.config), want)
    tconvert.load_reference_state_dict(tm, {k: torch.from_numpy(v) for k, v in sd.items()})
    for name, t in ref.state_dict().items():
        assert torch.equal(tm.state_dict()[name], t), name
    back = getattr(tconvert, f"export_{convert}_state_dict")(tconvert.model_variables(tm))
    want_back = getattr(jconvert, f"export_{convert}_state_dict")(want)
    assert sorted(back) == sorted(want_back) == sorted(
        set(sd) | {k.replace(".weight", ".num_batches_tracked") for k in sd if ".bn.weight" in k})
    for k, w in want_back.items():
        assert np.array_equal(back[k], w), k
        if k in sd:
            assert np.array_equal(back[k], sd[k]), k
    path = str(tmp_path / "ref.pth")
    tconvert.save_torch_state_dict(path, back)
    loaded = tconvert.load_torch_state_dict(path)
    assert all(np.array_equal(loaded[k], v) for k, v in back.items())
    gammas = getattr(tconvert, f"export_{convert}_state_dict")(tconvert.model_variables(tm),
                                                               include_gammas=True)
    assert set(gammas) - set(back) == ({"gamma"} if kind == "vae" else {"gammax", "gammay"})
