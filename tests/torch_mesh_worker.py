"""One rank of the port's two-process mesh (gloo), for
``tests/test_torch_port_mesh.py`` on the CPU and, with ``card`` in the
inputs, ``tests/test_torch_port_gpu.py`` on ``cuda:0``: it imports torch and
the port only.

    python tests/torch_mesh_worker.py INPUTS.pt OUT_DIR

with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` in the
environment (as torchrun sets them). ``INPUTS.pt`` (written by the test)
holds the weights, the global batches, the noise and the paths; every check
below runs in this one process group, in order, and the rank writes what it
computed to ``OUT_DIR/rank<r>.pt``.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from simple_vae_rs_tpu_torch import CondSRVAE, CondSRVAEConfig, MeshConfig  # noqa: E402
from simple_vae_rs_tpu_torch import TrainConfig, Trainer, make_mesh  # noqa: E402
from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks  # noqa: E402
from simple_vae_rs_tpu_torch.parallel import mesh as pm  # noqa: E402
from simple_vae_rs_tpu_torch.train import checkpoint as ck  # noqa: E402
from simple_vae_rs_tpu_torch.train.state import make_optimizer  # noqa: E402


def _model(inp):
    m = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=inp["ps"]))
    m.load_state_dict(inp["weights"])
    return m


def _state(trainer):
    return {"params": {k: v.detach().clone() for k, v in trainer.params.items()},
            "buffers": {k: v.clone() for k, v in trainer.model.named_buffers()}}


def bn_check(inp, mesh):
    """Global-batch BatchNorm: this rank's output and input gradient, the
    summed parameter gradients and the running statistics."""
    bn = blocks.BatchNorm(inp["bn_x"].shape[-1])
    bn.load_state_dict(inp["bn_state"])
    blocks.sync_batchnorm(bn, mesh.group)
    rows = pm.shard_rows(mesh, inp["bn_x"].shape[0])
    x = inp["bn_x"][rows].clone().requires_grad_(True)
    y = bn(x)
    (y * inp["bn_w"][rows]).sum().backward()
    grads = [bn.scale.grad.clone(), bn.bias.grad.clone()]
    pm.all_reduce_flat_(mesh, grads)
    return {"y": y.detach(), "dx": x.grad, "dscale": grads[0], "dbias": grads[1],
            "mean": bn.mean.clone(), "var": bn.var.clone()}


def step_check(inp, mesh, accum, eps):
    local = pm.shard_batch(mesh, inp["batch"])
    tr = Trainer(_model(inp), TrainConfig(learning_rate=inp["lr"], accum_steps=accum),
                 device="cpu", mesh=mesh)
    grads, _ = tr.grads_and_terms(local, eps)
    tr = Trainer(_model(inp), TrainConfig(learning_rate=inp["lr"], accum_steps=accum),
                 device="cpu", mesh=mesh)
    terms = tr.train_step(local, eps=eps)
    return {"grads": {k: v.clone() for k, v in grads.items()}, "terms": terms, **_state(tr)}


def zero1_check(inp, mesh, out_dir):
    """ZeRO-1 against the replicated layout over two steps, its moments'
    blocks, its checkpoint's round trip, the rank-0-only write and the
    barrier before a load."""
    local = pm.shard_batch(mesh, inp["batch"])
    pm._ZERO1_MIN_ELEMS = 1 << 12  # the tiny model's convs cross the bar
    res = {}
    trainers = {}
    for zero1 in (False, True):
        tr = Trainer(_model(inp), TrainConfig(learning_rate=inp["lr"], zero1=zero1),
                     device="cpu", mesh=mesh, seed=3)
        for _ in range(2):
            terms = tr.train_step(local)
        trainers[zero1] = tr
        res[f"zero1_{zero1}"] = {"terms": terms, **_state(tr)}
    tz = trainers[True]
    res["dims"] = list(tz.opt.dims)
    res["mu_shapes"] = [tuple(m.shape) for m in tz.opt.mu]
    whole = tz.opt.state_dict()  # gathers
    res["whole_mu"] = [m.clone() for m in whole["mu"]]
    res["whole_nu"] = [v.clone() for v in whole["nu"]]
    res["rep_mu"] = [m.clone() for m in trainers[False].opt.mu]
    res["rep_nu"] = [v.clone() for v in trainers[False].opt.nu]

    # the checkpoint: rank 0 writes (slowly, on the writer thread), and the
    # other rank's load must wait for it at the barrier
    writes = []
    orig = ck._write

    def slow_write(path, payload, meta):
        time.sleep(1.0)
        writes.append(path)
        orig(path, payload, meta)

    ck._write = slow_write
    path = os.path.join(out_dir, "ckpt", "zero1")
    try:
        ck.save_checkpoint(path, tz, epoch=7, block=False)
        fresh = Trainer(_model(inp), TrainConfig(learning_rate=inp["lr"], zero1=True),
                        device="cpu", mesh=mesh, seed=3)
        meta = ck.load_checkpoint(path, fresh)
    finally:
        ck._write = orig
    res["writes"] = len(writes)
    res["loaded_epoch"] = meta["epoch"]
    res["loaded"] = _state(fresh)
    res["loaded_mu"] = [m.clone() for m in fresh.opt.mu]
    res["loaded_nu"] = [v.clone() for v in fresh.opt.nu]
    # the resumed ZeRO-1 trainer steps on as the saved one does
    res["resumed_terms"] = fresh.train_step(local)
    res["saved_terms"] = tz.train_step(local)
    res["resumed_params"] = _state(fresh)["params"]
    res["saved_params"] = _state(tz)["params"]
    pm._ZERO1_MIN_ELEMS = 1 << 20
    return res


def eval_check(inp, mesh):
    local = pm.shard_batch(mesh, inp["batch"])
    tr = Trainer(_model(inp), TrainConfig(learning_rate=inp["lr"]), device="cpu", mesh=mesh)
    out = {"val": tr.val_step(local), "metrics": tr.eval_metrics_step(local),
           "images": tr.eval_images_step(local)}
    opt = make_optimizer(tr.cfg, list(tr.params.values()))
    out["pretrain_loss"] = tr.pretrain_step(local, opt, inp["lr"])
    out["pretrain_params"] = _state(tr)["params"]
    return out


def loader_check(inp, mesh):
    from simple_vae_rs_tpu_torch.data.loader import DeviceLoader
    from simple_vae_rs_tpu_torch.data.datasets import SyntheticSRDataset

    ds = SyntheticSRDataset(length=8, hr_size=32, seed=4)
    out = {}
    for crop in ("random", "grid"):
        ld = DeviceLoader(ds, 4, 16, crop=crop, shuffle=True, seed=2, device="cpu", mesh=mesh)
        out[crop] = [[t.clone() for t in b] for _ in range(2) for b in ld]
    return out


def cli_check(inp, mesh):
    """The port CLI on this rank (the process group is already up)."""
    from simple_vae_rs_tpu_torch import cli

    cwd = os.getcwd()
    os.chdir(inp["cli_dir"])
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = cli.main(cli.parse_args(inp["cli_argv"]))
    finally:
        os.chdir(cwd)
    return {"stdout": buf.getvalue(), "params": _state(res["trainer"])["params"],
            "mesh": dict(res["mesh"].shape), "task": res["task"]}


def card_check(inp, mesh):
    """The step on ``cuda:0`` (both ranks share the card, gloo): gradients,
    terms and the kernel launches by kernel and role of this rank's step."""
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_elbo as fe

    local = tuple(t.cuda() for t in pm.shard_batch(mesh, inp["batch"]))
    eps = [tuple(e.cuda() for e in micro) for micro in inp["eps1"]]
    tr = Trainer(_model(inp).cuda(), TrainConfig(learning_rate=inp["lr"]), device="cuda",
                 mesh=mesh)
    tr.grads_and_terms(local, eps)  # builds and warms the kernels
    tr = Trainer(_model(inp).cuda(), TrainConfig(learning_rate=inp["lr"]), device="cuda",
                 mesh=mesh)
    fc.reset_launches()
    fe.reset_launches()
    grads, terms = tr.grads_and_terms(local, eps)
    torch.cuda.synchronize()
    return {"grads": {k: v.cpu() for k, v in grads.items()},
            "terms": {k: float(v) for k, v in terms.items()},
            "launches": {k: dict(v) for k, v in fc.role_launches.items()},
            "rows": dict(fe.launches)}


def main() -> None:
    inp_path, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method="env://")
    mesh = make_mesh(MeshConfig(data=-1))
    inp = torch.load(inp_path, weights_only=False)
    out = {"rank": mesh.rank, "shape": dict(mesh.shape)}
    if inp.get("card"):
        out["card"] = card_check(inp, mesh)
        torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
        torch.distributed.destroy_process_group()
        return
    out["bn"] = bn_check(inp, mesh)
    out["step1"] = step_check(inp, mesh, 1, inp["eps1"])
    out["step2"] = step_check(inp, mesh, 2, inp["eps2"])
    out["eval"] = eval_check(inp, mesh)
    out["zero1"] = zero1_check(inp, mesh, out_dir)
    out["loader"] = loader_check(inp, mesh)
    out["cli"] = cli_check(inp, mesh)
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
