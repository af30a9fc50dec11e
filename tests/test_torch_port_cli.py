"""The port's command line, ``run_task``, ``evaluate``, ``doctor`` and the
TensorBoard writer against the JAX package's, on the CPU.

The whole-run test runs the JAX CLI and the port's with the same flags at a
small size (``--dataset synthetic --patch_size 16 --batch_size 2 --epochs 2
--pre_epochs 1 --samples 8 --backend cpu``): the port starts from the JAX
run's initial weights (carried over by ``load_jax_variables``) and draws
JAX's noise and crops, injected where the port draws its own:
``Trainer.stream_noise`` (``fold_in(state.rng, step)`` and the eval streams'
constants), ``DeviceLoader.crop_offsets`` (``fold_in(PRNGKey(seed + 7919 *
epoch), step)`` then ``fold_in(.., 0/1)`` for top and left) and
``tasks.sample_chunked`` (``PRNGKey(seed)`` split into the u and z keys).

Tolerances, with their reasons: every logged metric within 1e-4, relative or
absolute, whichever is larger (float32 through about 50 layers and 75
optimizer steps, summed in other orders). The absolute 1e-4 holds the values
near 0: the untrained model's KL terms (about 0.01 nats) and SSIM (about
0.04, on a scale of 1) are differences of nearly equal quantities, and after
the second epoch's 25 Adam steps (each element moves by about lr * sign(g),
whatever the sign of a gradient that is rounding noise) they differ from JAX
by up to 2e-5 absolute, 0.16% relative, while every loss and PSNR stays
within 1e-5 relative and the first epoch within 4e-5. A NaN (SSIM of an
8-pixel LR image, smaller than its 11-pixel window) must equal NaN. ``run_task``'s MMSE and
``evaluate``'s metrics within 1e-5 relative (one forward or one scoring
pass).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from simple_vae_rs_tpu import cli as jcli
from simple_vae_rs_tpu import evaluate as jevaluate
from simple_vae_rs_tpu import tasks as jtasks
from simple_vae_rs_tpu.config import CondSRVAEConfig as JConfig
from simple_vae_rs_tpu.config import VAEConfig as JVAEConfig
from simple_vae_rs_tpu.data.datasets import SyntheticSRDataset as JSyntheticSRDataset
from simple_vae_rs_tpu.data.tiffio import write_tiff as jwrite_tiff
from simple_vae_rs_tpu.models import VAE as JVAE
from simple_vae_rs_tpu.models import CondSRVAE as JCondSRVAE
from simple_vae_rs_tpu.train import checkpoint as jckpt
from simple_vae_rs_tpu.train.engine import Trainer as JTrainer
from simple_vae_rs_tpu.utils import cache as jcache
from simple_vae_rs_tpu.utils import tensorboard as jtb

from simple_vae_rs_tpu_torch import cli as tcli
from simple_vae_rs_tpu_torch import doctor as tdoctor
from simple_vae_rs_tpu_torch import evaluate as tevaluate
from simple_vae_rs_tpu_torch import tasks as ttasks
from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, VAEConfig
from simple_vae_rs_tpu_torch.data.datasets import SyntheticSRDataset
from simple_vae_rs_tpu_torch.data.loader import DeviceLoader
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.vae import VAE
from simple_vae_rs_tpu_torch.train.engine import Trainer
from simple_vae_rs_tpu_torch.utils import tensorboard as ttb
from simple_vae_rs_tpu_torch.utils.convert import model_variables
from simple_vae_rs_tpu_torch.utils.jax_weights import load_jax_variables
from tests.test_torch_port_data import _arm_tree

FLAGS = ("--dataset synthetic --patch_size 16 --batch_size 2 --epochs 2 --pre_epochs 1 "
         "--samples 8 --backend cpu").split()
CONSTS = {"val": 0xFFF1, "metrics": 0xFFF2, "images": 0xFFF3}


def _np(x):
    return np.array(jax.device_get(x))  # a writable copy


# ------------------------------------------------------------ JAX's draws
def stream_noise_of(rng):
    """``Trainer.stream_noise`` drawing the JAX engine's noise from its state
    key ``rng``."""
    def draw(self, stream, b, hw):
        key = (jax.random.fold_in(rng, self.step) if stream in ("train", "pretrain")
               else jax.random.fold_in(rng, CONSTS[stream]))
        cfg = self.model.config
        if self.kind == "vae":
            return (torch.from_numpy(_np(jax.random.normal(key, (b, cfg.latent_dim)))),)
        g = hw[0] // 4
        if stream == "pretrain":
            return (torch.from_numpy(_np(jax.random.normal(key, (b, g, g, cfg.u_channels)))),)
        ku, kz = jax.random.split(key)
        return (torch.from_numpy(_np(jax.random.normal(ku, (b, g, g, cfg.u_channels)))),
                torch.from_numpy(_np(jax.random.normal(kz, (b, g, g, cfg.z_channels)))))
    return draw


def jax_crop_offsets(self, step, b, lr_hw, generator):
    """``DeviceLoader.crop_offsets`` drawing the JAX loader's crops."""
    rng = jax.random.fold_in(jax.random.PRNGKey(self.seed + 7919 * self.epoch), step)
    p2 = self.patch_size // 2
    top = jax.random.randint(jax.random.fold_in(rng, 0), (b,), 0, lr_hw[0] - p2)
    left = jax.random.randint(jax.random.fold_in(rng, 1), (b,), 0, lr_hw[1] - p2)
    return torch.from_numpy(_np(top).astype(np.int64)), torch.from_numpy(_np(left).astype(np.int64))


def jax_draws(model, rng, samples, chunk):
    """The noise JAX ``tasks.sample_chunked`` draws from ``rng``, as the port's
    ``eps_u`` / ``eps_z`` (for a VAE ``eps_z`` alone)."""
    n = -(-samples // chunk)
    cfg = model.config
    if isinstance(model, VAE):
        eps = np.concatenate([_np(jax.random.normal(jax.random.fold_in(rng, i),
                                                    (chunk, cfg.latent_dim)))
                              for i in range(n)])[:samples]
        return None, torch.from_numpy(eps)
    g = cfg.patch_size // 8
    rng_u, rng_z = jax.random.split(rng)
    eps_u = _np(jax.random.normal(rng_u, (1, g, g, cfg.u_channels)))
    eps_z = np.concatenate([_np(jax.random.normal(jax.random.fold_in(rng_z, i),
                                                  (chunk, g, g, cfg.z_channels)))
                            for i in range(n)])[:samples]
    return torch.from_numpy(eps_u), torch.from_numpy(eps_z)


def jax_sample_chunked(rng):
    """``tasks.sample_chunked`` on JAX's draws from ``rng``."""
    real = ttasks.sample_chunked

    def sample(model, y, generator=None, samples=1000, chunk=100, **kw):
        eps_u, eps_z = jax_draws(model, rng, samples, chunk)
        return real(model, y, samples=samples, chunk=chunk, eps_u=eps_u, eps_z=eps_z)
    return sample


def memoized_items(cls):
    """``cls.__getitem__`` computing each deterministic item once (the three
    runs read every tile about ten times; each costs about 20 ms to draw)."""
    real, items = cls.__getitem__, {}

    def getitem(self, idx):
        key = (self.length, self.hr_size, self.channels, self.seed, int(idx))
        if key not in items:
            items[key] = real(self, idx)
        return items[key]
    return getitem


def _records(run_root):
    (name,) = os.listdir(os.path.join(run_root, "runs"))
    with open(os.path.join(run_root, "runs", name, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    out = {}
    for r in recs:
        for k, v in r.items():
            if k not in ("_step", "_time"):
                assert (r["_step"], k) not in out
                out[(r["_step"], k)] = v
    return name, out


# ------------------------------------------------------------- the whole run
@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The JAX CLI and the port's with FLAGS, from the same weights, noise and
    crops; then a port resume to epoch 3. Every patch is undone before the
    tests read the results."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("cli")
    # one torch thread: at these sizes more only contend with JAX's threads
    # in this process and with the other test processes for the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mp.setenv("SLURM_JOB_ID", "job")
        mp.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
        for cls in (JSyntheticSRDataset, SyntheticSRDataset):
            mp.setattr(cls, "__getitem__", memoized_items(cls))
        states, mmse = [], {}
        real_init, real_task = JTrainer.init_state, jtasks.run_task

        def init_state(self, *a, **k):
            states.append(real_init(self, *a, **k))
            return states[-1]

        def run_task(*a, **k):
            mmse["jax"] = real_task(*a, **k)["mmse"]
            return mmse

        mp.setattr(JTrainer, "init_state", init_state)
        mp.setattr(jtasks, "run_task", run_task)
        (root / "jax").mkdir()
        mp.chdir(root / "jax")
        # one device: the tests' CPU platform has eight, which a
        # batch of 2 cannot be sharded over
        jcli.main(jcli.parse_args(FLAGS + ["--mesh_data", "1"]))
        state0 = jax.device_get(states[0])

        def init_weights(self, seed):
            load_jax_variables(self, {"params": state0.params,
                                      "batch_stats": state0.batch_stats})
            return self

        mp.setattr(CondSRVAE, "init_weights", init_weights)
        mp.setattr(Trainer, "stream_noise", stream_noise_of(state0.rng))
        mp.setattr(DeviceLoader, "crop_offsets", jax_crop_offsets)
        mp.setattr(ttasks, "sample_chunked", jax_sample_chunked(jax.random.PRNGKey(0)))
        (root / "port").mkdir()
        mp.chdir(root / "port")
        port = tcli.main(tcli.parse_args(FLAGS))
        saved = json.loads((root / "port" / "ckpt" / "job.meta.json").read_text())
        resumed = tcli.main(tcli.parse_args(FLAGS[:-8] + [
            "--epochs", "3", "--samples", "8", "--backend", "cpu", "--model_ckpt", "ckpt/job"]))
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    return {"root": root, "jax_mmse": mmse["jax"], "port": port, "saved": saved,
            "resumed": resumed}


def test_cli_run_logs_the_jax_metrics(cli_runs):
    jname, want = _records(cli_runs["root"] / "jax")
    tname, got = _records(cli_runs["root"] / "port")
    assert tname == jname
    epochs12 = {k: v for k, v in got.items() if k[0] in (1, 2)}
    assert sorted(epochs12) == sorted(want)
    for key, w in want.items():
        if key[1] == "Perf/train_epoch_seconds":
            continue
        if np.isnan(w):
            assert np.isnan(got[key]), key
        else:
            np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-4, err_msg=str(key))
    np.testing.assert_allclose(cli_runs["port"]["task"]["mmse"], cli_runs["jax_mmse"], rtol=1e-4)
    task_dir = cli_runs["root"] / "port" / cli_runs["port"]["task"]["results_dir"]
    assert (task_dir / "error_mean_std_maps.png").exists()
    assert (task_dir / "generated_image.png").exists()


def test_cli_resume_starts_at_the_saved_epoch_plus_one(cli_runs):
    """``--model_ckpt`` without ``--test`` resumes at the saved epoch + 1 with
    the optimizer, the step and the plateau scheduler's state."""
    port, resumed = cli_runs["port"], cli_runs["resumed"]
    meta = cli_runs["saved"]  # the best checkpoint of the first run (epoch 2's)
    assert meta["epoch"] == 2 and resumed["start_epoch"] == 3
    _, got = _records(cli_runs["root"] / "port")
    assert sorted(k[0] for k in got if k[1] == "Loss/loss") == [1, 2, 3]
    assert meta["scheduler"]["last_epoch"] == 2
    assert resumed["trainer"].scheduler.last_epoch == 3
    assert resumed["trainer"].step == port["trainer"].step + 25


# ------------------------------------------------------------------ flags
def test_flag_defaults_are_the_jax_clis():
    """Every flag of the JAX CLI, with its default, and no other."""
    assert vars(tcli.parse_args([])) == vars(jcli.parse_args([]))


def _jax_msgpack_checkpoint(path, model, meta_model):
    """A JAX model's initial state written by the JAX package's
    ``save_checkpoint`` down its ``.msgpack`` path (orbax unimportable)."""
    import sys

    jt = JTrainer(model, scan_steps_config())
    jt._model_meta = lambda: meta_model
    state = jt.init_state(_cond_batches(1, 2, 16, 0)[0])
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "orbax.checkpoint", None)
    try:
        jckpt.save_checkpoint(str(path), state, epoch=4, extra={"model": meta_model})
    finally:
        mp.undo()
    assert os.path.exists(f"{path}.msgpack")
    return jax.device_get(state)


def scan_steps_config():
    from simple_vae_rs_tpu.config import TrainConfig as JTrainConfig

    return JTrainConfig(scan_steps=1)


def _cond_batches(n, bs, ps, seed):
    rng = np.random.default_rng(seed)
    return [(rng.random((bs, ps // 2, ps // 2, 4), dtype=np.float32),
             rng.random((bs, ps, ps, 4), dtype=np.float32)) for _ in range(n)]


def test_model_flags_resolve_from_a_port_and_a_jax_checkpoint(tmp_path):
    """``--model_ckpt`` alone gives the model flags: from a port checkpoint's
    meta and from a JAX ``.msgpack`` one's (a VAE's patch flag is twice its
    model's patch); an explicit flag wins, and the drift lines name it."""
    from simple_vae_rs_tpu_torch.train.checkpoint import save_checkpoint

    model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=32)).init_weights(0)
    tr = Trainer(model, device="cpu")
    save_checkpoint(str(tmp_path / "port"), tr, epoch=3, extra={"model": tr._model_meta()})
    args = tcli.parse_args(["--model_ckpt", str(tmp_path / "port")])
    assert (args.model_type, args.compression_ratio, args.patch_size, args.latent_size) == (
        "Cond_SRVAE", 2.0, 32, 0)
    assert tcli.parse_args(["--model_ckpt", str(tmp_path / "port"), "-cr", "3"]
                           ).compression_ratio == 3.0

    jmodel = JVAE(JVAEConfig(cr=2.0, patch_size=8))
    meta = {"type": "VAE", "cr": 2.0, "patch_size": 8, "channels": 4,
            "latent_size_override": 0, "torch_regroup": False}
    _jax_msgpack_checkpoint(tmp_path / "jax", jmodel, meta)
    args = tcli.parse_args(["--model_ckpt", str(tmp_path / "jax")])
    jargs = jcli.parse_args(["--model_ckpt", str(tmp_path / "jax")])
    assert vars(args) == vars(jargs)
    assert (args.model_type, args.compression_ratio, args.patch_size) == ("VAE", 2.0, 16)
    drift = tcli._config_drift(meta, {**meta, "cr": 1.5})
    assert drift == jcli._config_drift(meta, {**meta, "cr": 1.5}) == [
        "warning: cr=1.5 differs from the checkpoint's recorded cr=2.0"]


def test_test_mode_serves_a_jax_checkpoint_and_refuses_to_resume_it(tmp_path, monkeypatch):
    """``--test --model_ckpt`` on a JAX ``.msgpack``: the task runs on its
    weights (the flags from its meta); without ``--test`` training resumes
    from it at ``epoch + 1`` (``train/checkpoint.load_jax_checkpoint``)."""
    jmodel = JVAE(JVAEConfig(cr=2.0, patch_size=8))
    meta = {"type": "VAE", "cr": 2.0, "patch_size": 8, "channels": 4,
            "latent_size_override": 0, "torch_regroup": False}
    _jax_msgpack_checkpoint(tmp_path / "jax", jmodel, meta)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SLURM_JOB_ID", "jt")
    common = ["--model_ckpt", str(tmp_path / "jax"), "--dataset", "synthetic",
              "--batch_size", "2", "--backend", "cpu", "--samples", "4"]
    out = tcli.main(tcli.parse_args(["--test"] + common))
    assert out["start_epoch"] == 5 and np.isfinite(out["task"]["mmse"])
    assert out["trainer"].step == 0  # nothing trained
    resumed = tcli.main(tcli.parse_args(common + ["--epochs", "5"]))
    assert resumed["start_epoch"] == 5
    assert resumed["trainer"].step == resumed["trainer"].opt.count == 51 // 2


@pytest.mark.parametrize("argv, match", [
    (["--test", "--dataset", "synthetic"], "--test requires --model_ckpt"),
    (["-cr", "-1"], "Compression ratio"),
    (["--dataset", "bogus", "--backend", "cpu"], "Unknown dataset"),
    (["--backend", "tpu"], "--backend"),
    # the mesh flags are ported: accepted on one process, refused where the
    # layout needs more ranks or the process group has no environment
    (["--mesh_data", "1", "--zero1", "--dataset", "bogus", "--backend", "cpu"],
     "Unknown dataset"),
    # the model axis is ported: one process cannot fill a model axis of 2
    (["--mesh_model", "2", "--backend", "cpu"], "mesh 1x0x2 needs 2 devices, have 1"),
    (["--mesh_dcn", "2"], "mesh 2x0x1 needs 2 devices, have 1"),
    (["--multihost"], "torchrun"),
    (["--mesh_data", "2", "--backend", "cpu"], "mesh 1x2x1 needs 2 devices, have 1"),
    (["--train_elbo", "pallas"], "ROADMAP A.3"),
    (["--pallas_conv"], "ROADMAP A.3"),
])
def test_cli_refusals(argv, match):
    with pytest.raises(ValueError, match=match):
        tcli.main(tcli.parse_args(argv))


def test_cli_scan_steps_trains_on_the_cpu(tmp_path, monkeypatch):
    """``--scan_steps 2`` is ported: one epoch trains every batch once, two
    optimizer steps a ``Trainer.train_multi_step`` dispatch and a ragged
    tail as single steps, and the checkpoint records the steps."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SLURM_JOB_ID", "scan")
    calls = {"multi": 0, "single": 0}
    multi, single = Trainer.train_multi_step, Trainer.train_step

    def count(kind, fn):
        def wrapped(self, *a, **k):
            calls[kind] += 1
            return fn(self, *a, **k)
        return wrapped

    monkeypatch.setattr(Trainer, "train_multi_step", count("multi", multi))
    monkeypatch.setattr(Trainer, "train_step", count("single", single))
    # 15 train tiles in batches of 4: 3 steps, one dispatch of 2 and a tail of 1
    tree = _arm_tree(str(tmp_path / "ARM"), 19, lr_px=16, seed=9)
    out = tcli.main(tcli.parse_args(["--dataset", "s2v", "--data_root", tree, "--crop", "grid",
                                     "--patch_size", "16", "-cr", "2", "--batch_size", "4",
                                     "--epochs", "1", "--samples", "2", "--backend", "cpu",
                                     "--scan_steps", "2"]))
    tr = out["trainer"]
    assert tr.cfg.scan_steps == 2 and calls["multi"] == 1
    # on the CPU a dispatch's 2 steps are train_step calls, and the tail one
    assert tr.step == tr.opt.count == calls["single"] == 3
    assert json.loads((tmp_path / "ckpt" / "scan.meta.json").read_text())["epoch"] == 1


def test_backend_flag_maps_to_one_device_policy():
    """The CLI and ``evaluate`` read ``--backend`` through one function."""
    from simple_vae_rs_tpu_torch.serve import backend_device

    assert [backend_device(b) for b in ("", "cuda", "cpu")] == ["cuda", "cuda", "cpu"]
    with pytest.raises(ValueError, match="--backend 'tpu'"):
        tevaluate.main(["sr.tif", "truth.tif", "--backend", "tpu"])


def test_cli_refuses_the_card_when_there_is_none(monkeypatch):
    """Without ``--backend cpu`` the CLI asks for the card, and without one it
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tcli.main(tcli.parse_args(["--dataset", "synthetic"]))


# --------------------------------------------------------------- run_task
class ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("kind", ["cond", "vae"])
def test_run_task_matches_jax(kind, tmp_path, monkeypatch):
    """The same weights, val batch and draws: MMSE within 1e-5 relative; the
    error maps written, and for a Cond_SRVAE the generation panel."""
    ps = 16
    batch = _cond_batches(1, 3, ps, 5)
    if kind == "cond":
        jmodel = JCondSRVAE(JConfig(cr=2.0, patch_size=ps))
        tmodel = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=ps))
    else:
        jmodel = JVAE(JVAEConfig(cr=2.0, patch_size=ps // 2))
        tmodel = VAE(VAEConfig(cr=2.0, patch_size=ps // 2))
    # the port's initial weights as JAX's variable tree (no JAX init to trace)
    variables = model_variables(tmodel.init_weights(0))
    rng = jax.random.PRNGKey(3)
    want = jtasks.run_task(jmodel, variables, ListLoader(batch), "job", 2.0, rng=rng,
                           samples=8, chunk=4, results_root=str(tmp_path / "jax"))
    monkeypatch.setattr(ttasks, "sample_chunked", jax_sample_chunked(rng))
    got = ttasks.run_task(tmodel, ListLoader(batch), "job", 2.0, samples=8, chunk=4,
                          results_root=str(tmp_path / "port"))
    np.testing.assert_allclose(got["mmse"], want["mmse"], rtol=1e-5)
    out = tmp_path / "port" / "job_CRx2.0"
    assert got["results_dir"] == str(out)
    assert (out / "error_mean_std_maps.png").exists()
    assert (out / "generated_image.png").exists() == (kind == "cond")


def test_run_task_refuses_an_empty_loader(tmp_path):
    model = VAE(VAEConfig(cr=2.0, patch_size=8)).init_weights(0)
    with pytest.raises(ValueError, match="Validation loader is empty"):
        ttasks.run_task(model, ListLoader([]), "job", 2.0, results_root=str(tmp_path))


# --------------------------------------------------------------- evaluate
def _rasters(h=41, w=48, seed=7):
    """Truth in digital numbers, a product near it, the 2x2 box LR."""
    rng = np.random.default_rng(seed)
    truth = (rng.random((h, w, 4)) * 900 + 100).astype(np.float32)
    sr = truth + rng.normal(0, 25, truth.shape).astype(np.float32)
    lr = truth[: h // 2 * 2].reshape(h // 2, 2, w // 2, 2, 4).mean(axis=(1, 3))
    return sr, truth, lr.astype(np.float32)


def test_evaluate_in_memory_matches_jax():
    sr, truth, lr = _rasters()
    want = jevaluate.evaluate_product(sr, truth, lr=lr)
    got = tevaluate.evaluate_product(sr, truth, lr=lr, device="cpu")
    assert got["lpips"] is None and got["lpips_baseline"] is None  # no weights on disk
    for key in ("psnr", "ssim", "rmse_input_units", "psnr_baseline", "ssim_baseline"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    # a product already in [0, 1] is scored as it is
    unit = (sr - truth.min()) / (truth.max() - truth.min())
    np.testing.assert_allclose(tevaluate.evaluate_product(unit, truth, device="cpu")["psnr"],
                               jevaluate.evaluate_product(unit, truth)["psnr"], rtol=1e-5)


@pytest.mark.parametrize("win, h, w", [(16, 41, 48), (64, 40, 40)])
def test_evaluate_streamed_matches_jax(tmp_path, win, h, w):
    """The strip-windowed sweep over files the port wrote (int16 truth and LR,
    LZW with the predictor; a float32 product in strips of 8 rows): JAX's
    values within 1e-5; with one window over the raster, the in-memory ones."""
    from simple_vae_rs_tpu_torch.data.tiffio import TiffStripWriter, write_tiff

    sr, truth, lr = _rasters(h, w)
    truth_i, lr_i = np.rint(truth).astype(np.int16), np.rint(lr).astype(np.int16)
    paths = {k: str(tmp_path / f"{k}.tif") for k in ("sr", "truth", "lr")}
    with TiffStripWriter(paths["sr"], *sr.shape, dtype=np.float32, rows_per_strip=8) as wr:
        wr.write_rows(sr)
    write_tiff(paths["truth"], truth_i, compression="lzw", predictor=True)
    write_tiff(paths["lr"], lr_i, compression="lzw", predictor=True)
    want = jevaluate.evaluate_product_streamed(paths["sr"], paths["truth"], paths["lr"], win=win)
    got = tevaluate.evaluate_product_streamed(paths["sr"], paths["truth"], paths["lr"],
                                              win=win, device="cpu")
    for key in ("psnr", "ssim", "rmse_input_units", "psnr_baseline", "ssim_baseline"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    mem = tevaluate.evaluate_product(sr, truth_i.astype(np.float32), lr_i.astype(np.float32),
                                     device="cpu")
    for key in ("psnr", "rmse_input_units", "psnr_baseline"):  # exact in both sweeps
        np.testing.assert_allclose(got[key], mem[key], rtol=1e-5, err_msg=key)
    if min(win, h, w) >= max(h, w):
        for key in ("ssim", "ssim_baseline"):
            np.testing.assert_allclose(got[key], mem[key], rtol=1e-5, err_msg=key)


def test_evaluate_main_prints_one_json_line(tmp_path, capsys):
    sr, truth, lr = _rasters()
    for name, arr in (("sr", sr), ("truth", truth), ("lr", lr)):
        jwrite_tiff(str(tmp_path / f"{name}.tif"), arr)
    argv = [str(tmp_path / "sr.tif"), str(tmp_path / "truth.tif"), "--lr",
            str(tmp_path / "lr.tif"), "--backend", "cpu"]
    assert tevaluate.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jevaluate.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == set(want) and line["metric"] == "product_eval"
    for key in ("psnr", "ssim", "psnr_baseline", "ssim_baseline"):
        np.testing.assert_allclose(line[key], want[key], rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ TensorBoard
def test_tensorboard_events_read_back_by_jax(tmp_path):
    """A port event file, read by JAX's ``read_tfevents``: the records the JAX
    writer gives for the same calls (scalars, an image record)."""
    def write(mod, d):
        tb = mod.TensorBoardLogger(str(d))
        tb.log({"Loss/loss": 1.5, "Metrics/SSIM": torch.tensor(0.25)}, step=1)
        tb.log({"Loss/loss": -2.0}, step=-3)
        tb.log_images({"Images/SR": np.full((2, 4, 4, 4), 0.5, np.float32)}, step=2)
        tb.finish()
        (name,) = os.listdir(d)
        return str(d / name)

    port = write(ttb, tmp_path / "port")
    jax_file = write(jtb, tmp_path / "jax")
    got = jtb.read_tfevents(port)
    assert got == ttb.read_tfevents(port) == jtb.read_tfevents(jax_file)
    assert got[1] == {"step": 1, "Loss/loss": 1.5, "Metrics/SSIM": 0.25}
    assert got[3] == {"step": 2, "Images/SR/0": "<image>", "Images/SR/1": "<image>"}
    assert ttb._crc32c(b"123456789") == jtb._crc32c(b"123456789") == 0xE3069283


def test_make_logger_tees_into_tensorboard(tmp_path):
    from simple_vae_rs_tpu_torch.utils.logging import make_logger

    lg = make_logger("Cond_SRVAE", "run", {}, run_dir=str(tmp_path), tensorboard=True)
    lg.log({"Loss/loss": 3.0}, step=1)
    lg.finish()
    tb_dir = tmp_path / "Cond_SRVAE-run" / "tb"
    (name,) = os.listdir(tb_dir)
    assert jtb.read_tfevents(str(tb_dir / name))[1] == {"step": 1, "Loss/loss": 3.0}
    assert (tmp_path / "Cond_SRVAE-run" / "metrics.jsonl").exists()


# ------------------------------------------------------------------ doctor
def test_doctor_exits_2_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card answers here")
    assert tdoctor.main([]) == 2
    out = capsys.readouterr().out
    assert "CUDA card UNREACHABLE" in out and "native LZW codec" in out


def test_doctor_budget_gates_a_probe_that_does_not_answer(capsys, monkeypatch):
    """``--budget``: a device whose first round trip outlasts the deadline
    fails the gate with exit 2, and ``run_checks`` says the probe is stuck,
    so ``main`` leaves at once (its thread may sit in the CUDA runtime);
    ``--backend cpu`` probes the host, which answers."""
    import threading

    from simple_vae_rs_tpu_torch.utils import health

    release = threading.Event()
    exits = []
    monkeypatch.setattr(health, "_round_trip", lambda device: release.wait(30))
    monkeypatch.setattr(tdoctor.os, "_exit", exits.append)
    try:
        assert tdoctor.run_checks(0.2) == (2, True)
        assert tdoctor.main(["--budget", "0.2"]) == 2
    finally:
        release.set()
    out = capsys.readouterr().out
    assert exits == [2]
    assert "no answer within the 0.2 s budget" in out and "UNREACHABLE" in out
    monkeypatch.undo()
    assert tdoctor.main(["--backend", "cpu", "--budget", "30"]) == 0
    out = capsys.readouterr().out
    assert "host (--backend cpu)" in out and "all checks passed for the host" in out


def test_ssim_of_an_image_below_the_window_is_nan_as_in_jax():
    """Repaired here: the port's SSIM raised on an image smaller than its
    11-pixel window (``avg_pool2d`` refuses it), where JAX's gives NaN, the
    mean over no window; the CLI run at ``--patch_size 16`` logs it for the
    8-pixel LR images. At the window's size both give the same number."""
    from simple_vae_rs_tpu.ops.metrics import ssim as jssim

    from simple_vae_rs_tpu_torch.ops.metrics import ssim

    rng = np.random.default_rng(4)
    for px in (8, 11):
        a, b = (rng.random((2, px, px, 4), dtype=np.float32) for _ in range(2))
        got, want = ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy(), _np(jssim(a, b))
        assert np.isnan(got).all() == np.isnan(want).all() == (px < 11)
        if px == 11:
            np.testing.assert_allclose(got, want, rtol=1e-5)


def test_make_logger_never_starts_wandb(tmp_path, monkeypatch):
    """A wandb run reaches the network: the port's ``make_logger`` writes
    JSONL even where the package imports, unlike the JAX ``make_logger``,
    which starts a run whenever it can."""
    import sys
    import types

    from simple_vae_rs_tpu_torch.utils import logging as tlogging

    runs = []
    fake = types.SimpleNamespace(init=lambda **kw: runs.append(kw))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    for tb in (False, True):
        lg = tlogging.make_logger("Cond_SRVAE", "run", {"cr": 1.2}, run_dir=str(tmp_path),
                                  tensorboard=tb)
        lg.log({"Loss/loss": 1.0}, step=1)
        lg.finish()
    assert runs == [] and not hasattr(tlogging, "WandbLogger")
    assert len((tmp_path / "Cond_SRVAE-run" / "metrics.jsonl").read_text().splitlines()) == 2
