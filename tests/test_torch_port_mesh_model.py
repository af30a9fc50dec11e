"""The mesh's ``model`` axis (``simple_vae_rs_tpu_torch/parallel/mesh.py``:
the wide heads channel-sharded over a model process group) against one
process and against the JAX package's ``data=2 x model=2`` mesh, on the CPU
at a tiny size: the Cond_SRVAE at cr=2.0, ps=16 (its head widths 32, 16 and
4 divide by 2 and 4), a global batch of 8, as ``tests/test_torch_port_mesh.py``.

The four-rank checks run in ONE spawn of four gloo processes for the module
(``tests/torch_mesh_model_worker.py``, ``data=2 x model=2``): placement, the
train step (``accum_steps`` 1 and 2, the clip binding, ``remat``, bf16),
ZeRO-1 on top, a checkpoint moving between ``model=2`` and ``model=1``, the
eval and pre-training steps, the SRVAE and VAE, and the command line. JAX's
meshed steps compile in this process on 4 of its 8 virtual CPU devices
while the ranks run; placement on the canonical shapes, the refusal and
serving run in this process.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_vae_rs_tpu.config import CondSRVAEConfig as JConfig
from simple_vae_rs_tpu.config import MeshConfig as JMeshConfig
from simple_vae_rs_tpu.config import TrainConfig as JTrainConfig
from simple_vae_rs_tpu.models.cond_vae import CondSRVAE as JCondSRVAE
from simple_vae_rs_tpu.parallel import mesh as jmesh
from simple_vae_rs_tpu.train.engine import Trainer as JTrainer
from simple_vae_rs_tpu.train.state import create_train_state
from simple_vae_rs_tpu_torch import SRVAE, VAE, CondSRVAE, CondSRVAEConfig, MeshConfig
from simple_vae_rs_tpu_torch import SuperResolver, TrainConfig, Trainer, VAEConfig, cli
from simple_vae_rs_tpu_torch import make_mesh
from simple_vae_rs_tpu_torch.parallel import mesh as pm
from simple_vae_rs_tpu_torch.train.checkpoint import load_state, save_checkpoint
from simple_vae_rs_tpu_torch.utils.jax_weights import _flatten
from tests.test_torch_port_data import _arm_tree
from tests.test_torch_port_mesh import (
    B,
    CLI_FLAGS,
    CLI_STEPS,
    LR,
    PS,
    _block_max,
    _free_port,
    _permuted_grads,
    _port,
    _rel,
    _single_step,
    _weights,
)
from tests.test_torch_port_tiling import WIN, one_torch_thread  # noqa: F401
from tests.test_torch_port_train import _jax_eps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_model_worker.py")
CLIP = 0.05  # the tiny model's global gradient norm is far above it: the clip binds
HEADS = ["ey_head", "ex_head", "yz_conv2", "uz_conv2", "pz_mu_conv1", "pz_mu_conv2",
         "pz_lv_conv1", "pz_lv_conv2"]


def _jax_mesh_steps(jmodel, variables, batch):
    """JAX's ``Trainer._train_step`` on ``make_mesh(MeshConfig(data=2,
    model=m))`` for m = 2 and 1 from the same weights: (parameters, terms,
    statistics, Adam's first moment) after one step, for ``accum_steps`` 1
    and 2 and with the clip binding, by ``(m, case)``."""
    out = {}
    for model in (2, 1):
        jm = jmesh.make_mesh(JMeshConfig(data=2, model=model), jax.devices()[:2 * model])
        for key, kw in (("step1", {}), ("step2", {"accum_steps": 2}),
                        ("clip", {"grad_clip_norm": CLIP})):
            jt = JTrainer(jmodel, JTrainConfig(learning_rate=LR, **kw), mesh=jm)
            state = create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), jt.tx,
                                       jax.random.PRNGKey(0))
            state = jmesh.shard_state(jm, state)
            new, terms = jt._train_step(state, jt._device_batch(batch), jnp.float32(LR))
            adam = [s for s in jax.tree_util.tree_leaves(
                new.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")][0]
            out[model, key] = (_flatten(jax.device_get(new.params)), jax.device_get(terms),
                               _flatten(jax.device_get(new.batch_stats)),
                               _flatten(jax.device_get(adam.mu)))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Weights, the global batch, JAX's noise, and the four ranks' results."""
    tmp = tmp_path_factory.mktemp("mesh_model")
    jmodel, variables, tmodel = _weights()
    rng = np.random.default_rng(11)
    y = rng.random((B, PS // 2, PS // 2, 4)).astype(np.float32)
    x = rng.random((B, PS, PS, 4)).astype(np.float32)
    step_rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)  # the JAX state's rng at step 0
    eps1 = [tuple(torch.tensor(e) for e in _jax_eps(step_rng, jmodel.config, B))]
    eps2 = [tuple(torch.tensor(e) for e in _jax_eps(jax.random.fold_in(step_rng, i),
                                                    jmodel.config, B // 2)) for i in range(2)]
    cfg = CondSRVAEConfig(cr=2.0, patch_size=PS)
    tree = _arm_tree(str(tmp / "ARM"), 20, lr_px=16, seed=9)
    os.makedirs(tmp / "cli")
    inp = {"ps": PS, "weights": tmodel.state_dict(), "batch": (torch.from_numpy(y),
                                                               torch.from_numpy(x)),
           "eps1": eps1, "eps2": eps2, "lr": LR, "clip": CLIP,
           "srvae_weights": SRVAE(cfg).init_weights(4).state_dict(),
           "vae_weights": VAE(VAEConfig(cr=2.0, patch_size=PS)).init_weights(5).state_dict(),
           "cli_dir": str(tmp / "cli"),
           "cli_argv": CLI_FLAGS + ["--data_root", tree, "--multihost", "--mesh_data", "2",
                                    "--mesh_model", "2"]}
    torch.save(inp, tmp / "in.pt")
    port = _free_port()
    procs = []
    for r in range(4):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="4", LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE="4", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   SLURM_JOB_ID="mesh_model")
        procs.append(subprocess.Popen([sys.executable, WORKER, str(tmp / "in.pt"), str(tmp)],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    # JAX's meshed steps run here while the four ranks run
    jax_steps = _jax_mesh_steps(jmodel, variables, (y, x))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return {"inp": inp, "ranks": ranks, "tree": tree, "jax_steps": jax_steps, "tmp": tmp}


def _spec_names(tree, specs):
    return {jax.tree_util.keystr(path, simple=True, separator="."): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]}


def _jax_specs(shapes, model):
    jm = jmesh.make_mesh(JMeshConfig(data=8 // model, model=model))
    return _spec_names(shapes, jmesh.param_shardings(jm, shapes))


def _nested(shapes):
    """A port model's whole parameter shapes as a nested tree of the names."""
    tree = {}
    for name, shape in shapes.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jax.ShapeDtypeStruct(shape, jnp.float32)
    return tree


# ------------------------------------------------------------ in this process
@pytest.mark.parametrize("size", ["tiny", "canonical"])
def test_placement_is_jaxs_param_shardings(size):
    """Every parameter's spec is JAX's ``param_shardings`` on the same tree
    as ``jax.eval_shape`` gives it (the Cond_SRVAE), and JAX's rule on the
    port's own names (the SRVAE's core heads, the VAE's ``enc_head``)."""
    cr, ps = (2.0, PS) if size == "tiny" else (1.2, 64)
    jmodel = JCondSRVAE(JConfig(cr=cr, patch_size=ps))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, ps, ps, 4)),
        jnp.zeros((1, ps // 2, ps // 2, 4)), jax.random.PRNGKey(1), train=False))["params"]
    mesh = pm.Mesh({"data": 4, "model": 2})
    port = pm.whole_shapes(CondSRVAE(CondSRVAEConfig(cr=cr, patch_size=ps), device="meta"))
    want = _jax_specs(shapes, 2)
    got = pm.param_shardings(mesh, port)
    assert got == want
    sharded = sorted({n.rsplit(".", 1)[0] for n, s in got.items() if "model" in s})
    assert sharded == sorted(HEADS)
    for cls, cfg, heads in ((SRVAE, CondSRVAEConfig(cr=cr, patch_size=ps),
                             ["core." + h for h in HEADS]),
                            (VAE, VAEConfig(cr=cr, patch_size=ps), ["enc_head"])):
        port = pm.whole_shapes(cls(cfg, device="meta"))
        got = pm.param_shardings(mesh, port)
        assert got == _jax_specs(_nested(port), 2), cls.__name__
        assert sorted({n.rsplit(".", 1)[0] for n, s in got.items() if "model" in s}) == \
            sorted(heads)
    assert set(pm.param_shardings(pm.Mesh({"data": 8, "model": 1}), port).values()) == {()}


def test_canonical_model_refuses_model_4_naming_ey_head():
    """JAX's ``device_put`` refuses ``ey_head``'s 106 outputs over 4; the
    port refuses before it swaps any head."""
    model = CondSRVAE(CondSRVAEConfig(cr=1.2, patch_size=64), device="meta")
    with pytest.raises(ValueError, match=r"ey_head\.kernel: its dim 3 of size 106 does not "
                                         r"divide by the mesh's model axis of 4"):
        pm.shard_model(model, pm.Mesh({"data": 1, "model": 4}))
    assert not pm.sharded_convs(model)
    # model=2 divides every head of the canonical model
    assert "model" in set(sum(pm.param_shardings(pm.Mesh({"data": 1, "model": 2}),
                                                 pm.whole_shapes(model)).values(), ()))


@pytest.mark.parametrize("data", [1, 2])
def test_model_axis_device_mesh_serves_as_one_device(data):
    """A ``model=2`` device mesh on the CPU: the parameters replicated, the
    request split over the batch axes alone (one replica per batch shard),
    each shard's rows as the one-device resolver's."""
    model = _weights()[2]
    single = SuperResolver(model, device="cpu", seed=1)
    mesh = make_mesh(MeshConfig(data=data, model=2), ["cpu"] * (2 * data))
    meshed = SuperResolver(model, seed=1, mesh=mesh)
    assert len(meshed._replicas) == data == mesh.n_shards
    assert mesh.shape == dict(jmesh.make_mesh(JMeshConfig(data=data, model=2),
                                              jax.devices()[:2 * data]).shape)
    y = np.random.default_rng(3).random((3, WIN, WIN, 4)).astype(np.float32)
    torch.testing.assert_close(meshed.super_resolve(y, seed=5), single.super_resolve(y, seed=5),
                               rtol=0, atol=1e-6)
    got = meshed.uncertainty(y[0], samples=4, chunk=2, seed=7)
    want = single.uncertainty(y[0], samples=4, chunk=2, seed=7)
    torch.testing.assert_close(got["mean"], want["mean"], rtol=0, atol=1e-6)


# ------------------------------------------------------------------ four ranks
def test_four_ranks_form_the_mesh_as_jax_lays_it_out(setup):
    """Rank r at (r // model, r % model), JAX's ``reshape(data, model)``;
    each wide head holds its half of the output channels."""
    jm = jmesh.make_mesh(JMeshConfig(data=2, model=2), jax.devices()[:4])
    devs = np.asarray(jm.devices)
    whole = {k: tuple(v.shape) for k, v in setup["inp"]["weights"].items()}
    for r, out in enumerate(setup["ranks"]):
        assert out["rank"] == r and out["shape"] == {"data": 2, "model": 2}
        assert devs[out["shard"], out["model_index"]] == jax.devices()[r]
        pl = out["placement"]
        assert pl["sharded"] == sorted(HEADS)
        for name, shape in pl["shapes"].items():
            want = list(whole[name])
            if name.rsplit(".", 1)[0] in HEADS:
                want[-1] //= 2
            assert shape == tuple(want), name


def _grads_rule(got, want, noise):
    bmax = _block_max(want)
    for name, g in want.items():
        err = float((got[name] - g).abs().max())
        tol = 1e-4 * bmax[name.split(".")[0]] + 2 * float((noise[name] - g).abs().max())
        assert err <= tol, (name, err, tol)


def _single_case(inp, case):
    """The one-process step of ``case``: gradients, terms, the trainer after
    the step, float32's own noise (the permuted batch's gradients) and the
    clip's factor."""
    accum = 2 if case == "step2" else 1
    eps = inp[f"eps{accum}"]
    grads, terms, tr = _single_step(inp, accum, eps)
    noise = _permuted_grads(inp, accum)
    clip = CLIP if case == "clip" else TrainConfig().grad_clip_norm
    if case == "clip":
        tr = Trainer(_port(inp["weights"]), TrainConfig(learning_rate=LR, grad_clip_norm=CLIP),
                     device="cpu")
        tr.train_step(inp["batch"], eps=eps)
    norm = float(tr.opt.global_norm(list(grads.values())))
    return grads, terms, tr, noise, norm, min(1.0, clip / norm)


@pytest.mark.parametrize("case", ["step1", "step2", "clip"])
def test_model_axis_step_is_the_single_process_step(setup, case):
    """The ``data=2 x model=2`` step against the one-process step on the
    global batch: gradients gathered whole (each leaf within 1e-4 of its
    block's largest beside twice float32's own noise), terms, statistics,
    parameters (Adam's rule), the clip's global norm (of the whole tree, and
    of the heads' leaves alone against the norm of their gathered gradients:
    the gammas' gradients dominate the whole tree's) and the clipped first moment (the default clip binds too: the
    tiny model's norm is in the thousands). Dropping the heads' input-gradient all-reduce, summing the
    norm on one rank's shards, or reducing the gradients over the world
    fails it."""
    inp, ranks = setup["inp"], setup["ranks"]
    grads, terms, tr, noise, norm, factor = _single_case(inp, case)
    if case == "clip":
        assert factor < 0.25  # the clip binds
    mu = dict(zip(tr.params, tr.opt.mu))
    for r in ranks:
        got = r[case]
        _grads_rule(got["grads"], grads, noise)
        for k, v in terms.items():
            assert _rel(got["terms"][k], v) <= 1e-4, k
        buffers = dict(tr.model.named_buffers())
        for name, v in got["buffers"].items():
            torch.testing.assert_close(v, buffers[name], rtol=1e-4, atol=1e-5)
        for name, v in got["params"].items():
            assert float((v - tr.params[name].detach()).abs().max()) <= 2 * LR, name
        assert _rel(got["norm"], norm) <= 1e-5
        # the heads' blocks' squares summed over the model group: the norm of
        # the rank's own gathered head gradients
        heads = [g.double() for n, g in got["grads"].items() if n.rsplit(".", 1)[0] in HEADS]
        assert len(heads) == 2 * len(HEADS)
        assert _rel(got["heads_norm"], torch.linalg.vector_norm(torch.cat(
            [g.flatten() for g in heads]))) <= 1e-5
        _grads_rule(dict(zip(tr.params, got["mu"])), mu,
                    {k: mu[k] + 0.1 * factor * (noise[k] - grads[k]) for k in mu})
    for name in grads:  # every rank holds the same update
        for r in ranks[1:]:
            assert torch.equal(ranks[0][case]["params"][name], r[case]["params"][name])


def _ex_encoder(name):
    return name.startswith("ex_") and not name.startswith("ex_head")


def _ratio(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (b @ b))


def test_jax_reference_model_axis_step_doubles_the_ex_encoders_gradient(setup):
    """Why the four-rank step's gradients and parameters are held against
    JAX's ``data=2`` step and not its ``data=2 x model=2`` one: on the CPU
    (XLA's SPMD partitioner) JAX's ``model=2`` step takes twice the true
    gradient for every leaf below ``ex_head`` (the ``ex_*`` encoder), so its
    clip norm and every clipped moment move too, while its forward (terms,
    statistics) is right but with ``accum_steps=2``, where the ``dx_up1``
    BatchNorm's running statistics move away from the ``data=2`` step's
    (which the port's match). Its first moment against the ``data=2``
    step's: the ex encoder's kernels at twice the ratio of every other
    kernel (within the noise of the clip factor's rounding)."""
    steps = setup["jax_steps"]
    mu2, mu1 = steps[2, "step1"][3], steps[1, "step1"][3]
    kernels = [n for n in mu1 if n.endswith("kernel")]
    rest = [_ratio(mu2[n], mu1[n]) for n in kernels if not _ex_encoder(n)]
    ex = [_ratio(mu2[n], mu1[n]) for n in kernels if _ex_encoder(n)]
    k = float(np.median(rest))
    assert len(ex) == 9 and max(abs(r / k - 1) for r in rest) < 2e-3
    assert max(abs(r / k - 2) for r in ex) < 5e-3
    for case in ("step1", "clip"):
        for name, w in steps[2, case][2].items():
            np.testing.assert_allclose(w, steps[1, case][2][name], rtol=1e-4, atol=1e-5)
    stats2, stats1 = steps[2, "step2"][2], steps[1, "step2"][2]
    assert np.abs(stats2["dx_up1.bn.mean"] - stats1["dx_up1.bn.mean"]).max() > 1e-3


@pytest.mark.parametrize("case", ["step1", "step2", "clip"])
def test_model_axis_step_matches_jax_mesh(setup, case):
    """The four-rank step against JAX's meshed steps with JAX's noise.
    JAX's ``data=2 x model=2`` step: the terms at JAX's 2e-4, every
    parameter within Adam's rule (2 lr). JAX's ``data=2`` step (the same
    function, which JAX computes right on the CPU; see
    :func:`test_jax_reference_model_axis_step_doubles_the_ex_encoders_gradient`):
    the statistics, the gradients (read from Adam's first moment, 0.1 x the
    clipped gradient) by the rule of the one-process test, the parameters
    at 2e-3 relative + 2e-5 for 99.9% of the elements
    (``tests/test_sharding.py``'s)."""
    inp = setup["inp"]
    got = setup["ranks"][0][case]
    params, terms, _, _ = setup["jax_steps"][2, case]
    for k, v in terms.items():
        assert _rel(got["terms"][k], v) <= 2e-4, k
    for name, w in params.items():
        assert np.abs(got["params"][name].numpy() - w).max() <= 2 * LR * (1 + 1e-3), name
    params, _, stats, mu = setup["jax_steps"][1, case]
    for name, w in stats.items():
        np.testing.assert_allclose(got["buffers"][name].numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    grads, _, _, noise, _, factor = _single_case(inp, case)
    want = {k: torch.from_numpy(np.array(v)) for k, v in mu.items()}
    _grads_rule(dict(zip(got["params"], got["mu"])), want,
                {k: want[k] + 0.1 * factor * (noise[k] - grads[k]) for k in want})
    outside, total = 0, 0
    for name, w in params.items():
        diff = np.abs(got["params"][name].numpy() - w)
        assert diff.max() <= 2 * LR * (1 + 1e-3), name
        outside += int((diff > 2e-5 + 2e-3 * np.abs(w)).sum())
        total += diff.size
    assert outside <= 1e-3 * total, (outside, total)


def test_remat_and_bf16_steps_hold_on_the_model_axis(setup):
    """``remat`` recomputes the sharded heads (their collectives re-run on
    every rank alike): its gradients equal the step's. The bf16 step holds
    against the one-process bf16 step by the bf16 rule: within twice the
    one-process bf16 step's distance from float32 + 1e-3 of the block's
    largest."""
    inp = setup["inp"]
    f32, _, _ = _single_step(inp, 1, inp["eps1"])
    m = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS), dtype=torch.bfloat16)
    m.load_state_dict(inp["weights"])
    bf16, terms16 = Trainer(m, TrainConfig(learning_rate=LR, use_bfloat16=True),
                            device="cpu").grads_and_terms(inp["batch"], inp["eps1"])
    bmax = _block_max(bf16)
    for r in setup["ranks"]:
        for name, g in r["step1"]["grads"].items():
            torch.testing.assert_close(r["remat"]["grads"][name], g, rtol=0,
                                       atol=1e-6 * bmax[name.split(".")[0]] + 1e-12)
        for name, g in bf16.items():
            err = float((r["bf16"]["grads"][name] - g).abs().max())
            tol = 2 * float((f32[name] - g).abs().max()) + 1e-3 * bmax[name.split(".")[0]]
            assert err <= tol, (name, err, tol)
        for k, v in terms16.items():
            assert _rel(r["bf16"]["terms"][k], v) <= 1e-3, k


def test_zero1_on_the_model_axis_is_the_replicated_step(setup):
    """ZeRO-1 on top of ``model=2`` gives the model axis alone's parameters
    and whole moments bit for bit over two steps."""
    for r in setup["ranks"]:
        z = r["zero1"]
        assert sum(d is not None for d in z["dims"]) >= 10
        for name, v in z[True]["params"].items():
            assert torch.equal(v, z[False]["params"][name]), name
        for a, b in zip(z[True]["mu"] + z[True]["nu"], z[False]["mu"] + z[False]["nu"]):
            assert torch.equal(a, b)


def test_checkpoint_moves_between_model_2_and_model_1(setup):
    """A ``model=2`` checkpoint is the one-process layout (the same keys,
    shapes and dtypes as a one-process save); it resumes at ``model=1``
    (``data=4``) and back at ``model=2`` with the saved state bit for bit,
    and each steps on: back at ``model=2`` as the saved trainer does, bit
    for bit, at ``model=1`` within Adam's rule."""
    inp = setup["inp"]
    state = load_state(os.path.join(setup["tmp"], "ckpt", "model2"))
    one = Trainer(_port(inp["weights"]), TrainConfig(learning_rate=LR), device="cpu")
    save_checkpoint(str(setup["tmp"] / "one"), one, epoch=3)
    ref = load_state(str(setup["tmp"] / "one"))
    for key in ("model",):
        assert {k: (tuple(v.shape), v.dtype) for k, v in state[key].items()} == \
            {k: (tuple(v.shape), v.dtype) for k, v in ref[key].items()}
    for key in ("mu", "nu"):
        assert [(tuple(v.shape), v.dtype) for v in state["optimizer"][key]] == \
            [(tuple(v.shape), v.dtype) for v in ref["optimizer"][key]]
    for r in setup["ranks"]:
        c = r["ckpt"]
        assert c["epoch"] == 3
        for name, v in c["saved"]["params"].items():
            assert torch.equal(state["model"][name], v), name
            assert torch.equal(c["at_model1"]["params"][name], v), name
            assert torch.equal(c["back"]["params"][name], v), name
        for a, b, w in zip(c["at_model1"]["mu"] + c["back"]["mu"],
                           c["saved"]["mu"] * 2, state["optimizer"]["mu"] * 2):
            assert torch.equal(a, b) and torch.equal(a, w)
        s = c["stepped"]
        for name, v in s["saved"]["params"].items():
            assert torch.equal(s["back"]["params"][name], v), name
            assert float((s["at_model1"]["params"][name] - v).abs().max()) <= 2 * LR, name


def test_model_axis_eval_and_pretraining_match_one_process(setup):
    inp = setup["inp"]
    tr = Trainer(_port(inp["weights"]), TrainConfig(learning_rate=LR), device="cpu")
    val, metrics = tr.val_step(inp["batch"]), tr.eval_metrics_step(inp["batch"])
    images = tr.eval_images_step(inp["batch"])
    pre = tr.pretrain_step(inp["batch"], tr.make_optimizer(), LR)
    for r in setup["ranks"]:
        e = r["eval"]
        for k, v in val.items():
            assert _rel(e["val"][k], v) <= 1e-5, k
        for k, v in metrics.items():
            if np.isfinite(float(v)):
                assert _rel(e["metrics"][k], v) <= 1e-5, k
        assert float(e["metrics"]["count"]) == B
        for k, v in images.items():
            torch.testing.assert_close(e["images"][k], v, rtol=0, atol=1e-6)
        assert _rel(e["pretrain_loss"], pre) <= 1e-5
        for name, v in e["pretrain_params"].items():
            assert float((v - tr.params[name].detach()).abs().max()) <= 2 * LR, name


@pytest.mark.parametrize("kind", ["srvae", "vae"])
def test_srvae_and_vae_shard_their_heads_and_step_as_one_process(setup, kind):
    """The SRVAE shards its core's heads, the VAE its ``enc_head``; one step's
    gradients and terms as one process's (the same seed draws the same
    global noise)."""
    inp = setup["inp"]
    cfg = CondSRVAEConfig(cr=2.0, patch_size=PS)
    model = SRVAE(cfg) if kind == "srvae" else VAE(VAEConfig(cr=2.0, patch_size=PS))
    model.load_state_dict(inp[f"{kind}_weights"])
    batch = inp["batch"] if kind == "srvae" else (inp["batch"][1],)
    grads, terms = Trainer(model, TrainConfig(learning_rate=LR), device="cpu",
                           seed=7).grads_and_terms(batch)
    bmax = _block_max(grads)
    heads = ["core." + h for h in HEADS] if kind == "srvae" else ["enc_head"]
    for r in setup["ranks"]:
        f = r["family"][kind]
        assert f["sharded"] == sorted(heads)
        for k, v in terms.items():
            assert _rel(f["terms"][k], v) <= 1e-4, k
        for name, g in grads.items():
            err = float((f["grads"][name] - g).abs().max())
            assert err <= 1e-3 * bmax[name.split(".")[0]] + 1e-7, (name, err)


def test_model_axis_cli_is_the_one_process_cli(setup, tmp_path, monkeypatch):
    """``--multihost --mesh_data 2 --mesh_model 2`` on four ranks: the mesh
    line, rank 0 alone prints the epoch, runs the task (on the whole model)
    and writes the checkpoint, and the trained parameters are the
    one-process CLI's (Adam's rule: an element whose gradient is rounding
    noise moves by lr a step)."""
    ranks = setup["ranks"]
    for r in ranks:
        assert "Mesh: {'data': 2, 'model': 2} over 4 device(s)" in r["cli"]["stdout"]
        assert r["cli"]["mesh"] == {"data": 2, "model": 2}
    assert "Epoch 1/1" in ranks[0]["cli"]["stdout"]
    assert all("Epoch 1/1" not in r["cli"]["stdout"] for r in ranks[1:])
    assert np.isfinite(ranks[0]["cli"]["task"]["mmse"])
    assert all(r["cli"]["task"] == {} for r in ranks[1:])
    cli_dir = setup["inp"]["cli_dir"]
    assert sorted(os.listdir(os.path.join(cli_dir, "ckpt"))) == ["mesh_model.meta.json",
                                                                "mesh_model.pt"]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SLURM_JOB_ID", "one")
    res = cli.main(cli.parse_args(CLI_FLAGS + ["--data_root", setup["tree"]]))
    lr = TrainConfig().learning_rate
    moved = []
    for name, p in res["trainer"].params.items():
        d = (ranks[0]["cli"]["params"][name] - p.detach()).abs()
        assert float(d.max()) <= 2 * lr * CLI_STEPS, name
        moved.append(d.flatten())
    assert float((torch.cat(moved) > 1e-5).float().mean()) < 1e-2
