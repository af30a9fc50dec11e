"""The port's mesh (``simple_vae_rs_tpu_torch/parallel/mesh.py`` and what
takes a mesh) against one process and against the JAX package's mesh, on
the CPU at a tiny size: the Cond_SRVAE at cr=2.0, ps=16, a global batch of 8,
as ``tests/test_sharding.py`` uses.

The two-rank checks run in ONE spawn of two gloo processes for the module
(``tests/torch_mesh_worker.py``; about 25 s): global-batch BatchNorm, the
sharded train step (``accum_steps`` 1 and 2), the val, metrics, images and
pre-training steps, ZeRO-1 and its checkpoint, the rank-0-only write and the
barrier, the loader's rank slices and the command line. Serving runs two
replicas on the CPU in this process.
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
from jax.sharding import PartitionSpec as P

from simple_vae_rs_tpu.config import MeshConfig as JMeshConfig
from simple_vae_rs_tpu.config import TrainConfig as JTrainConfig
from simple_vae_rs_tpu.parallel import mesh as jmesh
from simple_vae_rs_tpu.train.engine import Trainer as JTrainer
from simple_vae_rs_tpu.train.state import create_train_state
from simple_vae_rs_tpu_torch import CondSRVAE, CondSRVAEConfig, MeshConfig, SuperResolver
from simple_vae_rs_tpu_torch import TrainConfig, Trainer, VAE, VAEConfig, cli, make_mesh, server
from simple_vae_rs_tpu_torch.data.datasets import SyntheticSRDataset
from simple_vae_rs_tpu_torch.data.loader import DeviceLoader
from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
from simple_vae_rs_tpu_torch.parallel import mesh as pm
from simple_vae_rs_tpu_torch.tasks import sample_chunked
from simple_vae_rs_tpu_torch.train.checkpoint import save_checkpoint
from simple_vae_rs_tpu_torch.train.state import make_optimizer
from simple_vae_rs_tpu_torch.utils.jax_weights import _flatten
from tests.test_torch_port_data import _arm_tree
from tests.test_torch_port_tiling import WIN, one_torch_thread, tiny_pair  # noqa: F401
from tests.test_torch_port_train import _jax_eps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
PS, B, LR = 16, 8, 1e-3
CLI_FLAGS = ["--dataset", "s2v", "--crop", "grid", "--patch_size", str(PS), "-cr", "2",
             "--batch_size", "4", "--epochs", "1", "--samples", "2", "--backend", "cpu",
             "--seed", "0", "--val_metrics_every", "1"]
CLI_STEPS = 4  # 16 train tiles in batches of 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _weights():
    """The tiny pair's flax tree, gammas 1 (0 trains to NaN), and a port
    model on it."""
    jmodel, variables, _ = tiny_pair()
    params = dict(variables["params"])
    for g in ("gammax", "gammay"):
        params[g] = np.ones_like(np.asarray(params[g]))
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    tmodel = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS))
    from simple_vae_rs_tpu_torch.utils.jax_weights import load_jax_variables

    load_jax_variables(tmodel, variables)
    return jmodel, variables, tmodel


def _jax_mesh_steps(jmodel, variables, batch):
    """JAX's meshed ``Trainer._train_step`` (``make_mesh(MeshConfig(data=2))``)
    from the same weights, for both accumulation settings: (parameters,
    terms, statistics) after one step."""
    out = {}
    for accum in (1, 2):
        jm = jmesh.make_mesh(JMeshConfig(data=2, model=1))
        jt = JTrainer(jmodel, JTrainConfig(learning_rate=LR, accum_steps=accum), mesh=jm)
        state = create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), jt.tx,
                                   jax.random.PRNGKey(0))
        state = jmesh.shard_state(jm, state)
        new, terms = jt._train_step(state, jt._device_batch(batch), jnp.float32(LR))
        out[accum] = (_flatten(jax.device_get(new.params)), jax.device_get(terms),
                      _flatten(jax.device_get(new.batch_stats)))
    return out


def _port(state_dict):
    m = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS))
    m.load_state_dict(state_dict)
    return m


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Weights, the global batch, JAX's noise for both accumulation
    settings, and the two ranks' results."""
    tmp = tmp_path_factory.mktemp("mesh")
    jmodel, variables, tmodel = _weights()
    rng = np.random.default_rng(11)
    y = rng.random((B, PS // 2, PS // 2, 4)).astype(np.float32)
    x = rng.random((B, PS, PS, 4)).astype(np.float32)
    step_rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)  # the JAX state's rng at step 0
    eps1 = [tuple(torch.tensor(e) for e in _jax_eps(step_rng, jmodel.config, B))]
    eps2 = [tuple(torch.tensor(e) for e in _jax_eps(jax.random.fold_in(step_rng, i),
                                                    jmodel.config, B // 2)) for i in range(2)]
    bn = blocks.BatchNorm(6)
    bn.reset_parameters()
    g = torch.Generator().manual_seed(3)
    tree = _arm_tree(str(tmp / "ARM"), 20, lr_px=16, seed=9)
    os.makedirs(tmp / "cli")
    inp = {"ps": PS, "weights": tmodel.state_dict(), "batch": (torch.from_numpy(y),
                                                               torch.from_numpy(x)),
           "eps1": eps1, "eps2": eps2, "lr": LR,
           "bn_x": torch.randn((B, 4, 4, 6), generator=g) * 2 + 1,
           "bn_w": torch.randn((B, 4, 4, 6), generator=g), "bn_state": bn.state_dict(),
           "cli_dir": str(tmp / "cli"),
           "cli_argv": CLI_FLAGS + ["--data_root", tree, "--multihost", "--mesh_data", "2",
                                    "--zero1"]}
    torch.save(inp, tmp / "in.pt")
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   SLURM_JOB_ID="mesh")
        procs.append(subprocess.Popen([sys.executable, WORKER, str(tmp / "in.pt"), str(tmp)],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    # JAX's meshed steps run here while the two ranks run
    jax_steps = _jax_mesh_steps(jmodel, variables, (y, x))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"inp": inp, "ranks": ranks, "tree": tree, "jax_steps": jax_steps}


def _block_max(grads):
    out = {}
    for name, g in grads.items():
        blk = name.split(".")[0]
        out[blk] = max(out.get(blk, 0.0), float(np.abs(np.asarray(g)).max()))
    return out


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-12)


# ------------------------------------------------------------ pure functions
@pytest.mark.parametrize("layout", [(-1, 1, 1, 8), (2, 1, 1, 8), (-1, 1, 2, 8), (2, 1, 2, 4),
                                    (-1, 2, 1, 8), (3, 1, 1, 2), (-1, 1, 4, 2)])
def test_mesh_config_axis_sizes_match_jax(layout):
    data, model, dcn, n = layout
    assert MeshConfig(data, model, dcn).axis_sizes(n) == \
        JMeshConfig(data, model, dcn).axis_sizes(n)


@pytest.mark.parametrize("dcn, data", [(1, 2), (2, 2), (1, 4)])
def test_batch_slices_are_jaxs_shards(dcn, data):
    """Shard k of ``shard_batch`` holds the rows JAX's ``P(("dcn", "data"))``
    places on the k-th device of the mesh, in its order."""
    batch = (np.arange(8 * 3, dtype=np.float32).reshape(8, 3),)
    jm = jmesh.make_mesh(JMeshConfig(data=data, model=1, dcn=dcn), jax.devices()[:dcn * data])
    (arr,) = jmesh.shard_batch(jm, batch)
    order = list(jm.devices.flat)
    tm = make_mesh(MeshConfig(data=data, model=1, dcn=dcn), ["cpu"] * (dcn * data))
    assert dict(tm.shape) == dict(jm.shape) and tm.n_shards == dcn * data
    assert pm.batch_axes(tm) == jmesh.batch_axes(jm)
    for shard in arr.addressable_shards:
        k = order.index(shard.device)
        (mine,) = pm.shard_batch(tm, batch, shard=k)
        np.testing.assert_array_equal(mine, np.asarray(shard.data))


def test_zero1_spec_matches_jax_on_the_canonical_shapes():
    """JAX's rule (largest dim that divides, ties to the later one, 2^20
    elements at least) on every parameter of the canonical Cond_SRVAE."""
    model = CondSRVAE(CondSRVAEConfig(cr=1.2, patch_size=64), device="meta")
    sharded = 0
    for d in (2, 4, 8, 3):
        for name, p in model.named_parameters():
            leaf = jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32)
            want = tuple(jmesh._zero1_spec(P(), leaf, d))
            assert pm._zero1_spec((), tuple(p.shape), d) == want, (name, d)
            sharded += "data" in want
    assert sharded > 10


def test_make_mesh_refuses_what_jax_refuses_and_the_model_axis():
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(JMeshConfig(data=3), jax.devices()[:2])
    with pytest.raises(ValueError) as got:
        make_mesh(MeshConfig(data=3), ["cpu", "cpu"])
    assert str(got.value) == str(want.value) == "mesh 1x3x1 needs 3 devices, have 2"
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(MeshConfig(data=2))  # one process, no group
    # the model axis: accepted where the devices fill it, as JAX's
    two = make_mesh(MeshConfig(data=1, model=2), ["cpu"] * 2)
    assert two.shape == dict(jmesh.make_mesh(JMeshConfig(data=1, model=2),
                                             jax.devices()[:2]).shape) == {"data": 1, "model": 2}
    assert two.n_shards == 1
    one = make_mesh()
    assert one.shape == {"data": 1, "model": 1} and one.is_process and not one.distributed
    # a head whose output channels do not divide by the axis is refused
    with pytest.raises(ValueError, match=r"ey_head\.kernel: its dim 3 of size 3 does not "
                                         r"divide by the mesh's model axis of 2"):
        pm.param_shardings(pm.Mesh({"data": 1, "model": 2}),
                           {"w": torch.zeros(2), "ey_head.kernel": torch.zeros(3, 3, 4, 3)})


# ------------------------------------------------------------------ two ranks
def test_two_ranks_form_the_mesh(setup):
    r0, r1 = setup["ranks"]
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["shape"] == r1["shape"] == {"data": 2, "model": 1}


def test_global_batchnorm_matches_one_process(setup):
    """The all-reduced sums give the global statistics; the gradient flows
    back through the all-reduce (the SUM backward) to each rank's rows."""
    inp, (r0, r1) = setup["inp"], setup["ranks"]
    bn = blocks.BatchNorm(6)
    bn.load_state_dict(inp["bn_state"])
    x = inp["bn_x"].clone().requires_grad_(True)
    y = bn(x)
    (y * inp["bn_w"]).sum().backward()
    torch.testing.assert_close(torch.cat([r0["bn"]["y"], r1["bn"]["y"]]), y.detach(),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([r0["bn"]["dx"], r1["bn"]["dx"]]), x.grad,
                               rtol=1e-5, atol=1e-5)
    for r in (r0, r1):
        torch.testing.assert_close(r["bn"]["dscale"], bn.scale.grad, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(r["bn"]["dbias"], bn.bias.grad, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(r["bn"]["mean"], bn.mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(r["bn"]["var"], bn.var, rtol=1e-5, atol=1e-6)


def _single_step(inp, accum, eps):
    tr = Trainer(_port(inp["weights"]), TrainConfig(learning_rate=LR, accum_steps=accum),
                 device="cpu")
    grads, _ = tr.grads_and_terms(inp["batch"], eps)
    tr = Trainer(_port(inp["weights"]), TrainConfig(learning_rate=LR, accum_steps=accum),
                 device="cpu")
    terms = tr.train_step(inp["batch"], eps=eps)
    return grads, terms, tr


def _permuted_grads(inp, accum):
    """float32's own noise: the one-process gradients on the batch with each
    microbatch's halves swapped (a BatchNorm output within 1e-7 of the
    ReLU's kink moves a whole channel's gradient with the summation order)."""
    n = B // accum
    perm = torch.cat([torch.arange(i * n, (i + 1) * n).roll(n // 2) for i in range(accum)])
    batch = tuple(t[perm] for t in inp["batch"])
    eps = [tuple(e.roll(n // 2, 0) for e in micro) for micro in inp[f"eps{accum}"]]
    tr = Trainer(_port(inp["weights"]), TrainConfig(learning_rate=LR, accum_steps=accum),
                 device="cpu")
    return tr.grads_and_terms(batch, eps)[0]


@pytest.mark.parametrize("accum", [1, 2])
def test_meshed_step_is_the_single_process_step(setup, accum):
    """Gradients (each leaf within 1e-4 of its block's largest, beside twice
    float32's own noise on the leaf), terms, statistics and parameters of the
    two-rank step against the one-process step on the global batch.
    Averaging the squared-error gradient over the ranks (DDP's mean), or
    cutting microbatches per rank, fails it."""
    inp, ranks = setup["inp"], setup["ranks"]
    key = f"step{accum}"
    grads, terms, tr = _single_step(inp, accum, inp[f"eps{accum}"])
    noise = _permuted_grads(inp, accum)
    bmax = _block_max(grads)
    for r in ranks:
        for name, g in grads.items():
            err = float((r[key]["grads"][name] - g).abs().max())
            tol = 1e-4 * bmax[name.split(".")[0]] + 2 * float((noise[name] - g).abs().max())
            assert err <= tol, (name, err, tol)
        for k, v in terms.items():
            assert _rel(r[key]["terms"][k], v) <= 1e-4, k
        buffers = dict(tr.model.named_buffers())
        for name, v in r[key]["buffers"].items():
            torch.testing.assert_close(v, buffers[name], rtol=1e-4, atol=1e-5)
        for name, v in r[key]["params"].items():
            # Adam moves an element whose gradient is rounding noise by lr
            assert float((v - tr.params[name].detach()).abs().max()) <= 2 * LR, name
    for name in grads:  # every rank holds the same update
        assert torch.equal(ranks[0][key]["params"][name], ranks[1][key]["params"][name])


@pytest.mark.parametrize("accum", [1, 2])
def test_meshed_step_matches_jax_mesh(setup, accum):
    """The two-rank step against JAX's step on a two-device data mesh, with
    JAX's noise injected: the loss terms at JAX's own tolerance
    (``tests/test_sharding.py``: 2e-4 relative), the parameters at JAX's
    2e-3 relative + 2e-5 for 99.9% of the elements and by Adam's rule for
    every one (an element whose gradient is rounding noise, a conv bias
    before BatchNorm, moves by up to lr whichever side the noise falls:
    ``tests/test_torch_port_train.py``'s rule)."""
    params, terms, stats = setup["jax_steps"][accum]
    got = setup["ranks"][0][f"step{accum}"]
    for k, v in terms.items():
        assert _rel(got["terms"][k], v) <= 2e-4, k
    outside, total = 0, 0
    for name, w in params.items():
        diff = np.abs(got["params"][name].numpy() - w)
        assert diff.max() <= 2 * LR * (1 + 1e-3), name
        outside += int((diff > 2e-5 + 2e-3 * np.abs(w)).sum())
        total += diff.size
    assert outside <= 1e-3 * total, (outside, total)
    for name, w in stats.items():
        np.testing.assert_allclose(got["buffers"][name].numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_meshed_eval_and_pretraining_match_one_process(setup):
    inp, (r0, r1) = setup["inp"], setup["ranks"]
    tr = Trainer(_port(inp["weights"]), TrainConfig(learning_rate=LR), device="cpu")
    val, metrics = tr.val_step(inp["batch"]), tr.eval_metrics_step(inp["batch"])
    images = tr.eval_images_step(inp["batch"])
    opt = make_optimizer(tr.cfg, list(tr.params.values()))
    pre = tr.pretrain_step(inp["batch"], opt, LR)
    for r in (r0, r1):
        for k, v in val.items():
            assert _rel(r["eval"]["val"][k], v) <= 1e-5, k
        for k, v in metrics.items():
            if np.isfinite(float(v)):
                assert _rel(r["eval"]["metrics"][k], v) <= 1e-5, k
        assert float(r["eval"]["metrics"]["count"]) == B
        for k, v in images.items():  # the global batch's first images, on every rank
            torch.testing.assert_close(r["eval"]["images"][k], v, rtol=0, atol=1e-6)
        assert _rel(r["eval"]["pretrain_loss"], pre) <= 1e-5
        for name, v in r["eval"]["pretrain_params"].items():
            assert float((v - tr.params[name].detach()).abs().max()) <= 2 * LR, name


def test_zero1_is_the_replicated_step_and_its_checkpoint_round_trips(setup):
    """ZeRO-1 (the tiny model's 4k-element moments sharded, as the JAX test
    lowers the bar) gives the replicated layout's parameters bit for bit
    over two steps; its moments are blocks along ``_zero1_spec``'s dim; its
    checkpoint holds the whole moments and a resume re-shards and steps on
    exactly."""
    for rank, r in enumerate(setup["ranks"]):
        z = r["zero1"]
        for name, v in z["zero1_True"]["params"].items():
            assert torch.equal(v, z["zero1_False"]["params"][name]), name
        sharded = [i for i, d in enumerate(z["dims"]) if d is not None]
        assert len(sharded) >= 10
        for i in sharded:
            whole, d = z["whole_mu"][i], z["dims"][i]
            n = whole.shape[d] // 2
            assert z["mu_shapes"][i][d] == n
            torch.testing.assert_close(z["loaded_mu"][i], whole.narrow(d, rank * n, n),
                                       rtol=0, atol=0)
        for a, b in zip(z["whole_mu"] + z["whole_nu"], z["rep_mu"] + z["rep_nu"]):
            assert torch.equal(a, b)
        assert z["loaded_epoch"] == 7
        for name, v in z["loaded"]["params"].items():
            assert torch.equal(v, z["zero1_True"]["params"][name])
        for name, v in z["resumed_params"].items():
            assert torch.equal(v, z["saved_params"][name])


def test_rank0_alone_writes_and_a_load_waits_at_the_barrier(setup):
    """Both ranks call the save; rank 0 alone writes (on its writer thread,
    one second late), and rank 1's load right after still reads epoch 7:
    it waited at the barrier for rank 0's write."""
    r0, r1 = setup["ranks"]
    assert (r0["zero1"]["writes"], r1["zero1"]["writes"]) == (1, 0)
    assert r1["zero1"]["loaded_epoch"] == 7


def test_loader_rank_slices_make_the_global_batches(setup):
    """Each rank's batches (its tiles decoded, the crops drawn for the global
    batch and sliced) concatenate to the one-process loader's, two epochs."""
    ds = SyntheticSRDataset(length=8, hr_size=32, seed=4)
    r0, r1 = setup["ranks"]
    for crop in ("random", "grid"):
        ld = DeviceLoader(ds, 4, 16, crop=crop, shuffle=True, seed=2, device="cpu")
        want = [b for _ in range(2) for b in ld]
        got0, got1 = r0["loader"][crop], r1["loader"][crop]
        assert len(want) == len(got0) == len(got1) == 4
        for w, a, b in zip(want, got0, got1):
            for wt, at, bt in zip(w, a, b):
                assert at.shape[0] == bt.shape[0] == wt.shape[0] // 2
                assert torch.equal(torch.cat([at, bt]), wt)
    with pytest.raises(ValueError, match="equal shards"):
        DeviceLoader(ds, 3, 16, device="cpu", mesh=pm.Mesh({"data": 2, "model": 1}))


def test_two_rank_cli_is_the_one_process_cli(setup, tmp_path, monkeypatch):
    """``--multihost --mesh_data 2 --zero1`` on two ranks: the mesh line,
    rank 0 alone prints the epoch, runs the task and writes the checkpoint,
    and the trained parameters are the one-process CLI's (Adam's rule: an
    element whose gradient is rounding noise moves by lr a step)."""
    r0, r1 = setup["ranks"]
    for r in (r0, r1):
        assert "Mesh: {'data': 2, 'model': 1} over 2 device(s)" in r["cli"]["stdout"]
        assert "backend gloo" in r["cli"]["stdout"]
        assert r["cli"]["mesh"] == {"data": 2, "model": 1}
    assert "Epoch 1/1" in r0["cli"]["stdout"] and "Epoch 1/1" not in r1["cli"]["stdout"]
    assert np.isfinite(r0["cli"]["task"]["mmse"]) and r1["cli"]["task"] == {}
    cli_dir = setup["inp"]["cli_dir"]
    assert sorted(os.listdir(os.path.join(cli_dir, "ckpt"))) == ["mesh.meta.json", "mesh.pt"]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SLURM_JOB_ID", "one")
    res = cli.main(cli.parse_args(CLI_FLAGS + ["--data_root", setup["tree"]]))
    assert res["mesh"].shape == {"data": 1, "model": 1}
    lr = TrainConfig().learning_rate
    moved = []
    for name, p in res["trainer"].params.items():
        d = (r0["cli"]["params"][name] - p.detach()).abs()
        assert float(d.max()) <= 2 * lr * CLI_STEPS, name
        moved.append(d.flatten())
    moved = torch.cat(moved)
    assert float((moved > 1e-5).float().mean()) < 1e-2  # most elements agree closely


# -------------------------------------------------------------------- serving
def _lr(b, seed):
    return np.random.default_rng(seed).random((b, WIN, WIN, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair()[2]


def _two_cpus():
    return make_mesh(MeshConfig(data=2), ["cpu", "cpu"])


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8_weights", "chain"])
def test_meshed_resolver_is_the_single_one(tiny, mode):
    """Two replicas on the CPU against the one-device resolver for one seed:
    a batch of 4 and a ragged 3, the rolling generator, the moments and
    ``uncertainty`` (the chunk rounded up to the replica count). Within
    1e-6 (the plain CPU convs may pick another algorithm for half the
    batch)."""
    model = tiny
    if mode == "bf16":
        model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS), dtype=torch.bfloat16)
        model.load_state_dict(tiny.state_dict())
    kw = {"int8_weights": {"int8_weights": True}, "chain": {"chain": True}}.get(mode, {})
    single = SuperResolver(model, device="cpu", seed=1, **kw)
    meshed = SuperResolver(model, seed=1, mesh=_two_cpus(), **kw)
    assert len(meshed._replicas) == 2 and meshed._replicas[0] is meshed.model
    for b in (4, 3):
        y = _lr(b, b)
        torch.testing.assert_close(meshed.super_resolve(y, seed=5),
                                   single.super_resolve(y, seed=5), rtol=0, atol=1e-6)
        torch.testing.assert_close(meshed.super_resolve(y), single.super_resolve(y),
                                   rtol=0, atol=1e-6)
        for a, s in zip(meshed.super_resolve_moments(y, 3, seed=2),
                        single.super_resolve_moments(y, 3, seed=2)):
            torch.testing.assert_close(a, s, rtol=0, atol=1e-5)
    got = meshed.uncertainty(_lr(1, 9)[0], samples=6, chunk=3, seed=7)
    want = single.uncertainty(_lr(1, 9)[0], samples=6, chunk=4, seed=7)
    for k in ("mean", "variance"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6)


def test_meshed_w8a8_takes_one_activation_scale_per_replica(tiny):
    """W8A8's activation scale spans the rows of one call: a meshed request
    is the single-card resolver run on each replica's rows with the same
    noise, as JAX's shard_map runs it per shard."""
    single = SuperResolver(tiny, device="cpu", seed=1, int8=True)
    meshed = SuperResolver(tiny, seed=1, int8=True, mesh=_two_cpus())
    y = torch.from_numpy(_lr(3, 4))
    gen = torch.Generator().manual_seed(5)
    eps_u, eps_z = single._noise(3, (WIN, WIN), gen)
    pad = [torch.cat([t, t[-1:]]) for t in (y, eps_u, eps_z)]  # 3 rows padded to 4
    with torch.no_grad():
        want = torch.cat([single.model.conditional_generation_eps(
            pm_y, pm_u, pm_z) for pm_y, pm_u, pm_z in zip(*(t.split(2) for t in pad))])[:3]
    got = meshed.super_resolve(y, seed=5, normalize=False)
    assert torch.equal(got, want)
    f32 = SuperResolver(tiny, seed=1, mesh=_two_cpus()).super_resolve(y, seed=5, normalize=False)
    assert not torch.allclose(got, f32, rtol=0, atol=1e-6)  # the int8 kernels ran


def test_sample_chunked_on_a_mesh_is_the_one_device_decode(tiny):
    y = torch.from_numpy(_lr(1, 6))
    vae = VAE(VAEConfig(cr=2.0, patch_size=PS)).init_weights(0).eval()
    for model, inp in ((tiny.eval(), y), (vae, torch.rand((1, PS, PS, 4),
                                                          generator=torch.Generator()
                                                          .manual_seed(2)))):
        a = sample_chunked(model, inp, torch.Generator().manual_seed(3), samples=6, chunk=4)
        b = sample_chunked(model, inp, torch.Generator().manual_seed(3), samples=6, chunk=4,
                           replicas=pm.replicate(_two_cpus(), model))
        assert a.shape == b.shape == (6, PS, PS, 4)
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6)


def test_server_mesh_data_builds_its_mesh_and_healthz_reports_it(tiny, tmp_path, monkeypatch):
    tr = Trainer(tiny, device="cpu")
    ck = str(tmp_path / "tiny")
    save_checkpoint(ck, tr, epoch=1, extra={"model": tr._model_meta()})
    made = {}

    def fake_make_server(resolver, *a, **k):
        made["resolver"] = resolver
        raise KeyboardInterrupt  # stop before serve_forever

    monkeypatch.setattr(server, "make_server", fake_make_server)
    with pytest.raises(KeyboardInterrupt):
        server.main(["--model_ckpt", ck, "--backend", "cpu", "--mesh_data", "2", "--no_warmup"])
    res = made["resolver"]
    monkeypatch.undo()
    assert res.mesh.shape == dict(jmesh.make_mesh(JMeshConfig(data=2, model=1)).shape)
    srv = server.make_server(res, port=0)
    import threading

    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        from simple_vae_rs_tpu_torch import client

        health = client.Client(f"http://127.0.0.1:{srv.server_address[1]}").health()
        assert health["mesh"] == {"data": 2, "model": 1} and health["status"] == "ok"
    finally:
        srv.shutdown()
        srv.server_close()
