"""One rank of the port's four-process mesh with a ``model`` axis
(``data=2 x model=2``, gloo), for ``tests/test_torch_port_mesh_model.py`` on
the CPU: it imports torch and the port only.

    python tests/torch_mesh_model_worker.py INPUTS.pt OUT_DIR

with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` in the
environment (as torchrun sets them). ``INPUTS.pt`` (written by the test)
holds the weights, the global batches, the noise and the paths; every check
below runs in this one process group, in order, and the rank writes what it
computed, every sharded leaf gathered whole, to ``OUT_DIR/rank<r>.pt``.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from simple_vae_rs_tpu_torch import CondSRVAE, CondSRVAEConfig, MeshConfig  # noqa: E402
from simple_vae_rs_tpu_torch import SRVAE, VAE, TrainConfig, Trainer, VAEConfig  # noqa: E402
from simple_vae_rs_tpu_torch import make_mesh  # noqa: E402
from simple_vae_rs_tpu_torch.parallel import mesh as pm  # noqa: E402
from simple_vae_rs_tpu_torch.train import checkpoint as ck  # noqa: E402
from torch_mesh_worker import cli_check as _cli  # noqa: E402


def _model(inp, dtype=torch.float32):
    m = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=inp["ps"]), dtype=dtype)
    m.load_state_dict(inp["weights"])
    return m


def _trainer(inp, mesh, dtype=torch.float32, **cfg):
    return Trainer(_model(inp, dtype), TrainConfig(learning_rate=inp["lr"], **cfg),
                   device="cpu", mesh=mesh)


def _whole(tr):
    """The trainer's parameters (whole), statistics and moments (whole)."""
    params = pm.gather_params(tr.model, {k: v.detach().clone() for k, v in tr.params.items()})
    opt = tr.opt.state_dict()
    return {"params": params,
            "buffers": {k: v.clone() for k, v in tr.model.state_dict().items()
                        if k not in tr.params},
            "mu": [m.clone() for m in opt["mu"]], "nu": [v.clone() for v in opt["nu"]]}


def placement(inp, mesh):
    tr = _trainer(inp, mesh)
    return {"shapes": {k: tuple(v.shape) for k, v in tr.params.items()},
            "sharded": sorted(pm.sharded_convs(tr.model)),
            "model_dims": pm.model_dims(tr.model)}


def step_check(inp, mesh, eps, dtype=torch.float32, **cfg):
    """One train step: the global gradients (whole), terms, clip norm, and
    the state after it."""
    tr = _trainer(inp, mesh, dtype, **cfg)
    grads, terms = tr.grads_and_terms(pm.shard_batch(mesh, inp["batch"]), eps)
    norm = tr.opt.global_norm(list(grads.values()))
    # the heads' leaves alone: their squares summed over the model group
    heads_norm = tr.opt.global_norm([g if d is not None else torch.zeros_like(g)
                                     for g, d in zip(grads.values(), tr._model_dims)])
    whole = pm.gather_params(tr.model, {k: v.clone() for k, v in grads.items()})
    tr.apply_grads(grads, inp["lr"])
    return {"grads": whole, "terms": terms, "norm": norm, "heads_norm": heads_norm,
            **_whole(tr)}


def zero1_check(inp, mesh):
    """ZeRO-1 on top of the model axis against the model axis alone, two
    steps (the tiny model's moments over a lowered bar, as the JAX test)."""
    local = pm.shard_batch(mesh, inp["batch"])
    pm._ZERO1_MIN_ELEMS = 1 << 12
    try:
        res = {}
        for zero1 in (False, True):
            tr = _trainer(inp, mesh, zero1=zero1)
            for _ in range(2):
                tr.train_step(local)
            res[zero1] = _whole(tr)
            if zero1:
                res["dims"] = list(tr.opt.dims)
    finally:
        pm._ZERO1_MIN_ELEMS = 1 << 20
    return res


def checkpoint_check(inp, mesh, out_dir):
    """A ``model=2`` checkpoint: its file (read by the test), a resume at
    ``model=1`` (``data=4``) and back at ``model=2``, each stepping on."""
    local2 = pm.shard_batch(mesh, inp["batch"])
    mesh1 = make_mesh(MeshConfig(data=4))
    local1 = pm.shard_batch(mesh1, inp["batch"])
    path = os.path.join(out_dir, "ckpt", "model2")
    t2 = _trainer(inp, mesh)
    t2.train_step(local2)
    ck.save_checkpoint(path, t2, epoch=3, block=True)
    t1 = _trainer(inp, mesh1)
    meta = ck.load_checkpoint(path, t1)
    back = _trainer(inp, mesh)
    ck.load_checkpoint(path, back)
    res = {"epoch": meta["epoch"], "saved": _whole(t2), "at_model1": _whole(t1),
           "back": _whole(back)}
    for tr, local in ((t2, local2), (t1, local1), (back, local2)):
        tr.train_step(local)
    res["stepped"] = {"saved": _whole(t2), "at_model1": _whole(t1), "back": _whole(back)}
    return res


def eval_check(inp, mesh):
    local = pm.shard_batch(mesh, inp["batch"])
    tr = _trainer(inp, mesh)
    out = {"val": tr.val_step(local), "metrics": tr.eval_metrics_step(local),
           "images": tr.eval_images_step(local)}
    out["pretrain_loss"] = tr.pretrain_step(local, tr.make_optimizer(), inp["lr"])
    out["pretrain_params"] = _whole(tr)["params"]
    return out


def family_check(inp, mesh):
    """One step of the SRVAE (its core's heads sharded) and the VAE
    (``enc_head``), noise from the trainer's seed: whole gradients, terms."""
    out = {}
    cfg = CondSRVAEConfig(cr=2.0, patch_size=inp["ps"])
    for kind, model in (("srvae", SRVAE(cfg)), ("vae", VAE(VAEConfig(cr=2.0,
                                                                     patch_size=inp["ps"])))):
        model.load_state_dict(inp[f"{kind}_weights"])
        tr = Trainer(model, TrainConfig(learning_rate=inp["lr"]), device="cpu", mesh=mesh,
                     seed=7)
        batch = pm.shard_batch(mesh, inp["batch"])
        if kind == "vae":
            batch = (batch[1],)
        grads, terms = tr.grads_and_terms(batch)
        out[kind] = {"grads": pm.gather_params(tr.model, dict(grads)), "terms": terms,
                     "sharded": sorted(pm.sharded_convs(tr.model))}
    return out


def cli_check(inp, mesh):
    """The port CLI on this rank, ``--mesh_data 2 --mesh_model 2``: its
    output and the trained parameters gathered whole."""
    from simple_vae_rs_tpu_torch import cli

    real = cli.main
    kept = {}

    def keep(args):
        res = real(args)
        kept["params"] = _whole(res["trainer"])["params"]
        return res

    cli.main = keep
    try:
        out = _cli(inp, mesh)
    finally:
        cli.main = real
    out["params"] = kept["params"]
    return out


def main() -> None:
    inp_path, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method="env://")
    mesh = make_mesh(MeshConfig(data=2, model=2))
    inp = torch.load(inp_path, weights_only=False)
    out = {"rank": mesh.rank, "shape": dict(mesh.shape), "shard": mesh.shard,
           "model_index": mesh.model_index}
    out["placement"] = placement(inp, mesh)
    out["step1"] = step_check(inp, mesh, inp["eps1"])
    out["step2"] = step_check(inp, mesh, inp["eps2"], accum_steps=2)
    out["clip"] = step_check(inp, mesh, inp["eps1"], grad_clip_norm=inp["clip"])
    out["remat"] = step_check(inp, mesh, inp["eps1"], remat=True)
    out["bf16"] = step_check(inp, mesh, inp["eps1"], dtype=torch.bfloat16, use_bfloat16=True)
    out["zero1"] = zero1_check(inp, mesh)
    out["ckpt"] = checkpoint_check(inp, mesh, out_dir)
    out["eval"] = eval_check(inp, mesh)
    out["family"] = family_check(inp, mesh)
    out["cli"] = cli_check(inp, mesh)
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
