"""Checkpoints of the port (``train/checkpoint.py``), resume, the JAX
package's ``.msgpack`` checkpoints and ``SuperResolver.from_checkpoint``, on
the CPU.

A resume is exact here: 2 epochs straight equal 1 epoch + save + load + 1
epoch in a fresh trainer to the bit (the CPU path is deterministic, and the
checkpoint carries the parameters, the statistics, both moments in their
dtypes, Adam's count, the generator state, the step and the scheduler). A
JAX checkpoint is compared leaf for leaf with the JAX state it was written
from (the same bytes), and its served forward with JAX's within 1e-4
relative, atol 2e-5 (float32 convolutions summed in other orders, as the
serving tests).
"""

import os
import sys

import numpy as np
import jax
import pytest
import torch

from simple_vae_rs_tpu.config import CondSRVAEConfig as JConfig
from simple_vae_rs_tpu.config import TrainConfig as JTrainConfig
from simple_vae_rs_tpu.models import CondSRVAE as JCondSRVAE
from simple_vae_rs_tpu.train import checkpoint as jck
from simple_vae_rs_tpu.train.engine import Trainer as JTrainer

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, TrainConfig, VAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.srvae import SRVAE
from simple_vae_rs_tpu_torch.models.vae import VAE
from simple_vae_rs_tpu_torch.serve import SuperResolver
from simple_vae_rs_tpu_torch.train import checkpoint as ck
from simple_vae_rs_tpu_torch.train.engine import Trainer
from simple_vae_rs_tpu_torch.train.state import ClipAdam
from simple_vae_rs_tpu_torch.utils.jax_weights import _flatten
from tests.test_torch_port_fit import ListLogger, _batches

PS = 32


def _cond(seed=0, **kw):
    return CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS, **kw)).init_weights(seed)


def _same_state(a: Trainer, b: Trainer):
    for name, t in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[name], t), name
    sa, sb = a.opt.state_dict(), b.opt.state_dict()
    assert sa["count"] == sb["count"]
    for key in ("mu", "nu"):
        for x, y in zip(sa[key], sb[key]):
            assert x.dtype == y.dtype and torch.equal(x, y), key
    assert torch.equal(a._rng.get_state(), b._rng.get_state())
    assert a.step == b.step and a.seed == b.seed


def test_clip_adam_state_dict_round_trip_and_dtype_check():
    params = [torch.randn(3, 2), torch.randn(4)]
    a = ClipAdam(params, mu_dtype=torch.bfloat16)
    a.update([torch.randn(3, 2), torch.randn(4)])
    b = ClipAdam(params, mu_dtype=torch.bfloat16)
    b.load_state_dict(a.state_dict())
    assert b.count == 1 and b.mu[0].dtype == torch.bfloat16
    assert all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu))
    with pytest.raises(ValueError, match="bfloat16"):
        ClipAdam(params).load_state_dict(a.state_dict())
    with pytest.raises(ValueError, match="moments"):
        ClipAdam(params[:1]).load_state_dict(a.state_dict())


@pytest.mark.parametrize("bf16_moments", [False, True], ids=["f32_moments", "bf16_moments"])
def test_resume_is_exact(tmp_path, bf16_moments):
    train, val = _batches(2, 4, 10), _batches(1, 4, 11)
    cfg = TrainConfig(learning_rate=1e-3, bf16_moments=bf16_moments)
    straight = Trainer(_cond(), cfg, device="cpu", seed=3, logger=(log_a := ListLogger()))
    straight.fit(train, val, epochs=2, val_metrics_every=1)

    first = Trainer(_cond(), cfg, device="cpu", seed=3)
    first.fit(train, val, epochs=1, val_metrics_every=1)
    ck.save_checkpoint(str(tmp_path / "run"), first, epoch=1, extra={
        "scheduler": first.scheduler.state_dict(), "model": first._model_meta()})
    resumed = Trainer(_cond(seed=99), cfg, device="cpu", seed=5, logger=(log_b := ListLogger()))
    meta = ck.load_checkpoint(str(tmp_path / "run"), resumed)
    assert meta["epoch"] == 1 and resumed.scheduler.state_dict() == first.scheduler.state_dict()
    if bf16_moments:
        assert all(m.dtype == torch.bfloat16 for m in resumed.opt.mu)
    resumed.fit(train, val, epochs=2, start_epoch=meta["epoch"] + 1, val_metrics_every=1)
    _same_state(straight, resumed)
    want = [(s, {k: v for k, v in m.items() if k != "Perf/train_epoch_seconds"})
            for s, m in log_a.records if s == 2]
    got = [(s, {k: v for k, v in m.items() if k != "Perf/train_epoch_seconds"})
           for s, m in log_b.records]
    assert got == want


def test_checkpoint_files_and_meta(tmp_path):
    tt = Trainer(_cond(), device="cpu")
    path = str(tmp_path / "sub" / "job")
    assert not ck.checkpoint_exists(path) and ck.read_meta(path) == {}
    ck.save_checkpoint(path, tt, epoch=4, extra={"model": tt._model_meta()})
    assert sorted(os.listdir(tmp_path / "sub")) == ["job.meta.json", "job.pt"]  # no .tmp left
    assert ck.checkpoint_exists(path)
    assert ck.read_meta(path) == {"epoch": 4, "model": {
        "type": "Cond_SRVAE", "cr": 2.0, "patch_size": PS, "channels": 4,
        "latent_size_override": 0, "torch_regroup": False}}
    state = torch.load(path + ".pt", weights_only=True)
    assert state["epoch"] == 4 and state["step"] == 0 and state["format"] == ck.FORMAT
    # a torn temporary from a crashed write is never read
    with open(path + ".pt.tmp", "wb") as fh:
        fh.write(b"torn")
    assert ck.load_checkpoint(path, Trainer(_cond(1), device="cpu"))["epoch"] == 4
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint(str(tmp_path / "nothing"), tt)


def test_async_saves_land_in_order_and_loads_wait_for_them(tmp_path):
    tt = Trainer(_cond(), device="cpu")
    path = str(tmp_path / "job")
    for epoch in range(1, 6):
        tt.step = epoch
        ck.save_checkpoint(path, tt, epoch=epoch, block=False)
    fresh = Trainer(_cond(1), device="cpu")
    assert ck.load_checkpoint(path, fresh)["epoch"] == 5 and fresh.step == 5
    tt.step = 6
    ck.save_checkpoint(path, tt, epoch=6, block=False)
    assert ck.read_meta(path)["epoch"] == 6  # the meta read waits too


def test_async_writer_errors_surface_after_every_save_ends(tmp_path, monkeypatch):
    tt = Trainer(_cond(), device="cpu")
    real, written = ck._write, []

    def flaky(path, payload, meta):
        if meta["epoch"] in (1, 2):
            raise OSError(f"disk full at {meta['epoch']}")
        real(path, payload, meta)
        written.append(meta["epoch"])

    monkeypatch.setattr(ck, "_write", flaky)
    for epoch in (1, 2, 3):
        ck.save_checkpoint(str(tmp_path / f"e{epoch}"), tt, epoch=epoch, block=False)
    with pytest.raises(OSError, match="disk full at 1"):
        ck.wait_for_saves()
    assert written == [3]  # the later save ran to its end before the error came out
    ck.wait_for_saves()  # drained: the next wait is clean


def test_fit_surfaces_a_checkpoint_writer_error(tmp_path, monkeypatch):
    from simple_vae_rs_tpu_torch.train.callbacks import ModelCheckpoint

    def boom(path, payload, meta):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "_write", boom)
    batches = _batches(1, 2, 12)
    tt = Trainer(_cond(), device="cpu", logger=(log := ListLogger()),
                 callbacks=[ModelCheckpoint("job", str(tmp_path), async_save=True)])
    with pytest.raises(OSError, match="disk full"):
        tt.fit(batches, batches, epochs=1, val_metrics_every=1)
    assert log.finished


# ------------------------------------------------------- JAX checkpoints
@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX Trainer's state after one step, written by the JAX package's
    ``save_checkpoint`` with orbax unavailable, so it takes its ``.msgpack``
    path; bf16 first moments, so a bfloat16 leaf is in the file."""
    path = str(tmp_path_factory.mktemp("jax") / "job")
    jt = JTrainer(JCondSRVAE(JConfig(cr=2.0, patch_size=PS)),
                  JTrainConfig(learning_rate=1e-3, bf16_moments=True, scan_steps=1))
    batch = _batches(1, 4, 13)[0]
    state = jt.init_state(batch)
    state, _ = jt._train_step(state, tuple(map(jax.numpy.asarray, batch)),
                              jax.numpy.float32(1e-3))
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "orbax.checkpoint", None)  # import fails: msgpack path
    try:
        jck.save_checkpoint(path, state, epoch=1, extra={"model": jt._model_meta()})
    finally:
        mp.undo()
    assert os.path.exists(path + ".msgpack") and not os.path.exists(path + ".orbax")
    return path, jax.device_get(state), jt


def test_jax_msgpack_checkpoint_reads_leaf_for_leaf(jax_checkpoint):
    path, state, _ = jax_checkpoint
    tree = ck.read_jax_checkpoint(path)
    for col in ("params", "batch_stats"):
        want, got = _flatten(getattr(state, col)), _flatten(tree[col])
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert got[name].dtype == np.float32 and np.array_equal(got[name], w), name
    assert int(tree["step"]) == 1
    mu = [leaf for name, leaf in _flatten(tree["opt_state"]).items() if ".mu." in f".{name}."]
    want_mu = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(state.opt_state[1].mu)]
    assert len(mu) == len(want_mu) > 0
    assert sorted(float(np.abs(m).sum()) for m in mu) == sorted(
        float(np.abs(m).sum()) for m in want_mu)  # the exact float32 upcast of bf16


def test_from_checkpoint_serves_a_jax_checkpoint(jax_checkpoint):
    path, state, jt = jax_checkpoint
    sr = SuperResolver.from_checkpoint(path, device="cpu")
    assert isinstance(sr.model, CondSRVAE) and sr.model.config.patch_size == PS
    rng = np.random.default_rng(14)
    y = rng.random((2, PS // 2, PS // 2, 4), dtype=np.float32)
    x = rng.random((2, PS, PS, 4), dtype=np.float32)
    key = jax.random.PRNGKey(5)
    want = jt.model.apply({"params": state.params, "batch_stats": state.batch_stats}, x, y,
                          key, train=False)
    ku, kz = jax.random.split(key)
    g = PS // 8
    eps = (torch.from_numpy(np.array(jax.random.normal(ku, (2, g, g, sr.model.config.u_channels)))),
           torch.from_numpy(np.array(jax.random.normal(kz, (2, g, g, sr.model.config.z_channels)))))
    with torch.no_grad():
        got = sr.model(torch.from_numpy(x), torch.from_numpy(y), *eps)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=1e-4, atol=2e-5)


def test_reading_msgpack_without_the_package_raises(jax_checkpoint, monkeypatch):
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError, match="msgpack"):
        ck.read_jax_checkpoint(jax_checkpoint[0])


# ------------------------------------------------------- from_checkpoint
def _saved(tmp_path, model, name="job"):
    tt = Trainer(model, device="cpu")
    path = str(tmp_path / name)
    ck.save_checkpoint(path, tt, epoch=1, extra={"model": tt._model_meta()})
    return path


def test_from_checkpoint_serves_the_same_bits_as_the_model(tmp_path):
    model = _cond()
    path = _saved(tmp_path, model)
    y = np.random.default_rng(15).random((3, PS // 2, PS // 2, 4), dtype=np.float32)
    for kw in ({}, {"int8": True}, {"chain": True}):
        want = SuperResolver(model, device="cpu", seed=2, **kw)
        got = SuperResolver.from_checkpoint(path, device="cpu", seed=2, **kw)
        assert torch.equal(got.super_resolve(y, seed=4), want.super_resolve(y, seed=4)), kw
        assert torch.equal(got.uncertainty(y[0], samples=6, seed=5)["std"],
                           want.uncertainty(y[0], samples=6, seed=5)["std"]), kw
    bf16 = SuperResolver.from_checkpoint(path, device="cpu", dtype=torch.bfloat16)
    assert bf16.model.dtype == torch.bfloat16


def test_from_checkpoint_rebuilds_the_c_major_graph_from_the_meta(tmp_path):
    """``torch_regroup`` comes from the meta: the parameters fit either
    wiring, so only the generation would silently differ."""
    model = _cond(torch_regroup=True)
    path = _saved(tmp_path, model)
    assert ck.read_meta(path)["model"]["torch_regroup"] is True
    sr = SuperResolver.from_checkpoint(path, device="cpu")
    assert sr.model.config.torch_regroup is True
    y = np.random.default_rng(16).random((2, PS // 2, PS // 2, 4), dtype=np.float32)
    want = SuperResolver(model, device="cpu").super_resolve(y, seed=1)
    assert torch.equal(sr.super_resolve(y, seed=1), want)
    shuffled = SuperResolver(_cond(torch_regroup=False), device="cpu")
    shuffled.model.load_state_dict(model.state_dict())
    assert not torch.equal(shuffled.super_resolve(y, seed=1), want)


def test_from_checkpoint_config_resolution(tmp_path, capsys):
    path = _saved(tmp_path, _cond())
    # an explicit argument wins, with a warning where it differs from the meta
    # (latent 2048 at cr=2, ps=32 either way, so the weights still fit)
    sr = SuperResolver.from_checkpoint(path, device="cpu", latent_size=2048)
    assert sr.model.config.latent_size_override == 2048
    assert "latent_size_override=2048 overrides the checkpoint's recorded " \
           "latent_size_override=0" in capsys.readouterr().out
    SuperResolver.from_checkpoint(path, device="cpu", cr=2.0, patch_size=PS)
    assert "warning" not in capsys.readouterr().out
    # the SRVAE type from the meta; a VAE is not served
    srv = SuperResolver.from_checkpoint(_saved(tmp_path, SRVAE(CondSRVAEConfig(
        cr=2.0, patch_size=PS)).init_weights(0), "srvae"), device="cpu")
    assert isinstance(srv.model, SRVAE)
    with pytest.raises(ValueError, match="'VAE'"):
        SuperResolver.from_checkpoint(_saved(tmp_path, VAE(VAEConfig(cr=2.0, patch_size=16))
                                             .init_weights(0), "vae"), device="cpu")
    with pytest.raises(FileNotFoundError):
        SuperResolver.from_checkpoint(str(tmp_path / "none"), device="cpu")
    with open(path + ".msgpack", "wb"):
        pass
    with pytest.raises(ValueError, match="both"):
        SuperResolver.from_checkpoint(path, device="cpu")


def test_from_checkpoint_defaults_to_the_card(tmp_path, monkeypatch):
    path = _saved(tmp_path, _cond())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        SuperResolver.from_checkpoint(path)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        Trainer(_cond())
