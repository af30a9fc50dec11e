"""The port's checkpoint and data tools against the JAX package's, on the CPU:
``make_index`` (JAX ``scripts/make_index.py``), ``convert_checkpoint`` (JAX
``scripts/convert_checkpoint.py``), ``utils/convert.load_torch_state_dict``'s
pickle opt-in, and resuming training from a JAX ``.msgpack``
(``train/checkpoint.load_jax_checkpoint``, ``cli --model_ckpt``).

The JAX scripts are loaded with ``importlib`` and run in process. A JAX
``.msgpack`` is written with ``flax.serialization.to_bytes`` of the state
tree (the file the JAX ``save_checkpoint`` writes where orbax is absent), or
by the JAX converter with orbax made unimportable. Tiny shapes throughout:
``CondSRVAEConfig(cr=2.0, patch_size=16)``, the weights of
``tests/test_torch_port_tiling.tiny_pair`` (no JAX init compile).

Tolerances: ``make_index`` and the converters are exact (bytes, exit codes,
leaf-for-leaf bits). The resumed step is held to
``tests/test_torch_port_train.py``'s step tolerance: parameters within
2 * lr, 99% of elements within 1e-2 * lr; the step's gradients within
1e-4 of their block's largest, which carries into the moments as
``(1 - b1) * that`` for ``mu`` (plus one bfloat16 ulp at the element with
``bf16_moments``) and ``(1 - b2) * (2 |g| d + d^2)`` for ``nu``, d the
gradient bound, plus float32 rounding of ``nu`` (1e-6 relative).
"""

import importlib.util
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from simple_vae_rs_tpu.config import TrainConfig as JTrainConfig
from simple_vae_rs_tpu.train import checkpoint as jckpt
from simple_vae_rs_tpu.train.engine import Trainer as JTrainer
from simple_vae_rs_tpu.train.state import create_train_state

from simple_vae_rs_tpu_torch import cli as tcli
from simple_vae_rs_tpu_torch import convert_checkpoint as tconv
from simple_vae_rs_tpu_torch import make_index as tmi
from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, TrainConfig
from simple_vae_rs_tpu_torch.data.tiffio import write_tiff
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.vae import VAE
from simple_vae_rs_tpu_torch.train import checkpoint as tck
from simple_vae_rs_tpu_torch.train.engine import Trainer
from simple_vae_rs_tpu_torch.utils import convert as tcv
from simple_vae_rs_tpu_torch.utils.jax_weights import _flatten
from tests.test_torch_port_tiling import one_torch_thread, tiny_pair  # noqa: F401
from tests.test_torch_port_train import _jax_eps, _t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS = 16
LR = 1e-4


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -------------------------------------------------------------- make_index
def _tile(path, h, w, seed):
    write_tiff(str(path), (np.random.default_rng(seed).random((h, w, 4)) * 3000)
               .astype(np.int16), compression="lzw", predictor=True)


def _tree(root, bad=False):
    """Two sound pairs (one in a sub-directory) and a dangling LR tile; with
    ``bad`` also a pair whose HR is not 2x its LR and a corrupt LR tile."""
    (root / "sub").mkdir(parents=True)
    _tile(root / "S2_a_10m.tif", 8, 8, 0)
    _tile(root / "S2_a_05m.tif", 16, 16, 1)
    _tile(root / "sub" / "S2_b_10m.tif", 8, 12, 2)
    _tile(root / "sub" / "S2_b_05m.tif", 16, 24, 3)
    _tile(root / "lonely_10m.tif", 8, 8, 4)
    if bad:
        _tile(root / "geo_10m.tif", 8, 8, 5)
        _tile(root / "geo_05m.tif", 12, 12, 6)
        (root / "junk_10m.tif").write_bytes(b"II*\x00garbage, not a tiff")
        _tile(root / "junk_05m.tif", 16, 16, 7)


@pytest.mark.parametrize("case, flags", [
    ("sound", ["--validate"]),
    ("sound", ["--dry_run"]),
    ("sound", []),
    ("bad", ["--validate"]),
    ("bad", []),
    ("empty", ["--validate"]),
])
def test_make_index_equals_jax(case, flags, tmp_path, capsys):
    """The same index bytes, stdout, stderr lines and exit code as the JAX
    script on the same int16 tree."""
    root = tmp_path / "ARM"
    if case == "empty":
        root.mkdir()
    else:
        _tree(root, bad=case == "bad")
    index = root / "index.csv"
    jmi = _script("make_index")
    runs = []
    for main in (jmi.main, tmi.main):
        rc = main([str(root), *flags])
        out, err = capsys.readouterr()
        runs.append((rc, out, err, index.read_bytes() if index.exists() else None))
        if index.exists():
            index.unlink()
    assert runs[0] == runs[1]
    rc, out, err, written = runs[1]
    assert "skipping lonely_10m.tif: no _05m sibling" in err or case == "empty"
    if case == "bad" and flags:
        assert rc == 1 and written is None and "2 invalid pair(s)" in err
    elif case == "empty":
        assert rc == 1 and "no *_10m*/*_05m* tile pairs" in err
    else:
        assert rc == 0 and (written is None) == ("--dry_run" in flags)
    assert tmi.find_pairs(str(root)) == jmi.find_pairs(str(root))


# -------------------------------------------------------- convert_checkpoint
def _run_jax_converter(argv, monkeypatch):
    """The JAX converter's ``main`` with ``argv``, orbax unimportable so its
    ``save_checkpoint`` writes ``.msgpack``."""
    script = _script("convert_checkpoint")
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py", *argv])
    script.main()


@pytest.mark.parametrize("model_type, latent", [("Cond_SRVAE", 0), ("VAE", 128)])
def test_import_equals_the_jax_converter(model_type, latent, tmp_path, monkeypatch):
    """A reference ``.pth`` imported by both converters: the same weights leaf
    for leaf, the same meta; the port's optimizer state fresh."""
    if model_type == "VAE":
        from simple_vae_rs_tpu_torch.config import VAEConfig

        model = VAE(VAEConfig(cr=2.0, patch_size=PS, latent_size_override=latent))
        export = tcv.export_vae_state_dict
    else:
        model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS))
        export = tcv.export_cond_state_dict
    model.init_weights(5)
    src = str(tmp_path / "ref.pth")
    tcv.save_torch_state_dict(src, export(tcv.model_variables(model)))
    flags = ["--model_type", model_type, "-cr", "2.0", "--patch_size", str(PS),
             "--latent_size", str(latent)]
    _run_jax_converter([src, str(tmp_path / "jax"), *flags], monkeypatch)
    assert tconv.main([src, str(tmp_path / "port"), *flags]) == 0
    jtree = tck.read_jax_checkpoint(str(tmp_path / "jax"))
    want = {**_flatten(jtree["params"]), **_flatten(jtree["batch_stats"])}
    state = tck.load_state(str(tmp_path / "port"))
    got = {k: v for k, v in state["model"].items()}
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
    assert tck.read_meta(str(tmp_path / "port")) == jckpt.read_meta(str(tmp_path / "jax"))
    assert state["epoch"] == 0 and state["step"] == 0 and state["optimizer"]["count"] == 0
    assert not any(t.any() for t in state["optimizer"]["mu"] + state["optimizer"]["nu"])


def test_import_refuses_a_tree_of_another_model(tmp_path):
    model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(0)
    src = str(tmp_path / "ref.pth")
    tcv.save_torch_state_dict(src, tcv.export_cond_state_dict(tcv.model_variables(model)))
    with pytest.raises(SystemExit, match="does not match the model structure"):
        tconv.main([src, str(tmp_path / "out"), "-cr", "1.2", "--patch_size", str(PS)])


@pytest.mark.parametrize("keep_gammas", [False, True], ids=["strict", "keep_gammas"])
def test_to_torch_equals_the_jax_converter(keep_gammas, tmp_path, monkeypatch):
    """The same weights as a JAX ``.msgpack`` and as a port checkpoint: the
    two ``--to_torch`` outputs hold the same tensors, bit for bit, and the
    port's ``.pth`` imports back losslessly."""
    from simple_vae_rs_tpu.train.state import make_optimizer

    _, variables, tmodel = tiny_pair()
    state = create_train_state(variables, make_optimizer(JTrainConfig()), jax.random.PRNGKey(0))
    tree = {"params": state.params, "batch_stats": state.batch_stats,
            "opt_state": state.opt_state, "rng": state.rng, "step": state.step}
    (tmp_path / "jax.msgpack").write_bytes(serialization.to_bytes(jax.device_get(tree)))
    tr = Trainer(tmodel, device="cpu")
    tck.save_checkpoint(str(tmp_path / "port"), tr, extra={"model": tr._model_meta()})
    flags = ["--to_torch", "-cr", "2.0", "--patch_size", str(PS)] + (
        ["--keep_gammas"] if keep_gammas else [])
    _run_jax_converter([str(tmp_path / "jax"), str(tmp_path / "jax.pth"), *flags], monkeypatch)
    assert tconv.main([str(tmp_path / "port"), str(tmp_path / "port.pth"), *flags]) == 0
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    assert ("gammax" in want) == keep_gammas
    got = torch.load(tmp_path / "port.pth", weights_only=True)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype and torch.equal(got[key], w), key
    if keep_gammas:  # import back: the port checkpoint's weights again
        assert tconv.main([str(tmp_path / "port.pth"), str(tmp_path / "back"), "-cr", "2.0",
                           "--patch_size", str(PS)]) == 0
        back = tck.load_state(str(tmp_path / "back"))["model"]
        assert all(torch.equal(back[k], v) for k, v in tmodel.state_dict().items())
        assert tck.read_meta(str(tmp_path / "back"))["model"]["torch_regroup"] is True


def test_allow_pickle_refuses_then_loads_a_numpy_pickle(tmp_path):
    import warnings

    p = str(tmp_path / "np.pth")
    torch.save({"w": np.ones((2, 3), np.float32)}, p)
    with pytest.raises(ValueError, match="allow_pickle"):
        tcv.load_torch_state_dict(p)
    with pytest.raises(ValueError, match="allow_pickle"):
        tconv.main([p, str(tmp_path / "out"), "-cr", "2", "--patch_size", "16"])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        sd = tcv.load_torch_state_dict(p, allow_pickle=True)
    assert sd["w"].shape == (2, 3) and any("weights_only" in str(w.message) for w in rec)
    p2 = str(tmp_path / "t.pth")
    torch.save({"w": torch.ones(2, 3)}, p2)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert tcv.load_torch_state_dict(p2)["w"].shape == (2, 3)
    assert not any("weights_only" in str(w.message) for w in rec)


# ------------------------------------------------------ resuming from JAX
@pytest.fixture(scope="module")
def micro_grads():
    """JAX's gradient of one microbatch (one compile for both moment dtypes:
    the gradient does not depend on the optimizer)."""
    jmodel, _, _ = tiny_pair()
    return jmodel, jax.jit(JTrainer(jmodel, JTrainConfig(learning_rate=LR))._micro_grads)


def _trainable(variables):
    """``tiny_pair``'s tree with the gammas at their init value, 1 (its 0 has
    no gradient: the ELBO takes their log)."""
    one = np.float32(1.0)
    return {**variables, "params": {**variables["params"], "gammax": one, "gammay": one}}


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.random((4, PS // 2, PS // 2, 4), dtype=np.float32),
             rng.random((4, PS, PS, 4), dtype=np.float32)) for _ in range(n)]


def _jax_msgpack(path, state, meta):
    tree = {"params": state.params, "batch_stats": state.batch_stats,
            "opt_state": state.opt_state, "rng": state.rng, "step": state.step}
    with open(path + ".msgpack", "wb") as fh:
        fh.write(serialization.to_bytes(jax.device_get(tree)))
    with open(path + ".meta.json", "w") as fh:
        json.dump(meta, fh)


@pytest.mark.parametrize("bf16_moments", [False, True], ids=["f32_moments", "bf16_moments"])
def test_resume_from_msgpack_takes_jaxs_next_step(bf16_moments, micro_grads, tmp_path):
    """A JAX run of two steps saved as ``.msgpack``; JAX resumes it for one
    step, the port resumes it (``load_jax_checkpoint``) for one step on the
    same batch with the same noise."""
    jmodel, grads_fn = micro_grads
    variables = _trainable(tiny_pair()[1])
    jt = JTrainer(jmodel, JTrainConfig(learning_rate=LR, bf16_moments=bf16_moments))
    # host copies: the JAX step donates its input state
    host = lambda tree: jax.tree_util.tree_map(np.array, jax.device_get(tree))
    state0 = host(create_train_state(variables, jt.tx, jax.random.PRNGKey(7)))
    batches = [tuple(map(jnp.asarray, b)) for b in _batches(3, 17)]
    state = jax.tree_util.tree_map(jnp.asarray, state0)
    for b in batches[:2]:
        state, _ = jt._train_step(state, b, jnp.float32(LR))
    path = str(tmp_path / "job")
    scheduler = {"lr": LR, "best": 0.25, "num_bad_epochs": 1, "last_epoch": 1}
    _jax_msgpack(path, state, {"epoch": 1, "scheduler": scheduler, "model": jt._model_meta()})

    jstate, jmeta = jckpt.load_checkpoint(path, state0)
    step_rng = jax.random.fold_in(jstate.rng, jstate.step)
    g, _, _ = grads_fn(jstate.params, jstate.batch_stats, batches[2], step_rng)
    want_g = _flatten(jax.device_get(g))
    adam = host(jstate.opt_state[1])
    new, _ = jt._train_step(jax.tree_util.tree_map(jnp.asarray, host(jstate)), batches[2],
                            jnp.float32(LR))
    new = jax.device_get(new)

    tr = Trainer(CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)),
                 TrainConfig(learning_rate=LR, bf16_moments=bf16_moments), device="cpu")
    meta = tck.load_jax_checkpoint(path, tr)
    assert meta == jmeta and tr.scheduler.state_dict() == scheduler
    assert tr.step == 2 and tr.opt.count == 2
    for mine, theirs in ((tr.opt.mu, adam.mu), (tr.opt.nu, adam.nu)):  # JAX's bits
        theirs = _flatten(theirs)
        for name, m in zip(tr.params, mine):
            want_dtype = torch.bfloat16 if bf16_moments and mine is tr.opt.mu else torch.float32
            assert m.dtype == want_dtype
            np.testing.assert_array_equal(m.float().numpy(), np.asarray(theirs[name], np.float32))
    mu_old = [m.float().clone() for m in tr.opt.mu]
    b = tuple(np.array(a) for a in batches[2])
    tr.train_step(b, lr=LR, eps=[tuple(_t(*_jax_eps(step_rng, jmodel.config, 4)))])

    assert tr.step == int(new.step) == 3 and tr.opt.count == int(new.opt_state[1].count) == 3
    block = {}
    for name, w in want_g.items():
        blk = name.split(".")[0]
        block[blk] = max(block.get(blk, 0.0), float(np.abs(w).max()))
    want_mu = _flatten(new.opt_state[1].mu)
    want_nu = _flatten(new.opt_state[1].nu)
    want_p = _flatten(new.params)
    diffs = []
    for i, name in enumerate(tr.params):
        d = 1e-4 * block[name.split(".")[0]]
        g = np.abs(want_g[name])
        mu = tr.opt.mu[i].float().numpy()
        ulp = (np.spacing(np.abs(mu).astype(np.float32)) * 2**16 if bf16_moments
               else 0.0)  # a bfloat16 ulp: float32's spacing times 2^16
        assert (np.abs(mu - np.asarray(want_mu[name], np.float32))
                <= 0.1 * d + ulp + 1e-7 * np.abs(mu_old[i].numpy())).all(), name
        nu = np.asarray(want_nu[name], np.float32)
        assert (np.abs(tr.opt.nu[i].numpy() - nu)
                <= 1e-3 * (2 * g * d + d * d) + 1e-6 * nu).all(), name
        diff = np.abs(tr.params[name].detach().numpy() - want_p[name]).ravel()
        assert diff.max() <= 2 * LR * (1 + 1e-3), name
        diffs.append(diff)
    assert np.mean(np.concatenate(diffs) <= 1e-2 * LR) >= 0.99


def test_load_jax_checkpoint_refuses_a_tree_without_adam(tmp_path):
    _, variables, tmodel = tiny_pair()
    path = str(tmp_path / "job")
    with open(path + ".msgpack", "wb") as fh:
        fh.write(serialization.to_bytes({"params": variables["params"],
                                         "batch_stats": variables["batch_stats"],
                                         "opt_state": {"0": {}}, "step": np.int32(0)}))
    with pytest.raises(ValueError, match="scale_by_adam"):
        tck.load_jax_checkpoint(path, Trainer(tmodel, device="cpu"))


def test_cli_resumes_training_from_a_jax_msgpack(tmp_path, monkeypatch):
    """``cli --model_ckpt <jax .msgpack>`` without ``--test`` trains on from
    ``epoch + 1`` with the JAX run's optimizer count and step."""
    from simple_vae_rs_tpu.train.state import make_optimizer

    jmodel, variables, _ = tiny_pair()
    variables = _trainable(variables)
    jt = JTrainer(jmodel, JTrainConfig())
    state = create_train_state(variables, make_optimizer(JTrainConfig()), jax.random.PRNGKey(0))
    state = state.replace(step=jnp.asarray(5, jnp.int32))
    state = state.replace(opt_state=(state.opt_state[0],
                                     state.opt_state[1]._replace(count=jnp.asarray(5, jnp.int32))))
    _jax_msgpack(str(tmp_path / "jax"), state, {"epoch": 2, "model": jt._model_meta()})
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SLURM_JOB_ID", "resume")
    out = tcli.main(tcli.parse_args([
        "--model_ckpt", str(tmp_path / "jax"), "--dataset", "synthetic", "--batch_size", "8",
        "--epochs", "3", "--backend", "cpu", "--samples", "4"]))
    steps = 51 // 8  # the synthetic train split: 51 pairs
    assert out["start_epoch"] == 3
    assert out["trainer"].step == 5 + steps and out["trainer"].opt.count == 5 + steps
    assert os.path.exists(tmp_path / "ckpt" / "resume.pt")
