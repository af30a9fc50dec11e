"""Checkpoints of the port: the whole training state, for an exact resume,
and the model config beside it, for serving (the JAX package's
``train/checkpoint.py``, in the port's own format).

A checkpoint at ``path`` is two files:

- ``<path>.pt``, written with ``torch.save`` (tensors on the CPU) and read
  with ``torch.load(weights_only=True, mmap=True)`` (a reader that needs only
  the model, as serving does, reads only its bytes): the model's ``state_dict``
  (parameters with the gammas, BatchNorm running statistics), the
  ``ClipAdam`` moments (``mu`` in its ``mu_dtype``) and count, the trainer's
  generator state and seed (which seeds its eval noise streams), ``step``,
  ``epoch`` and the meta below;
- ``<path>.meta.json``: the JAX package's sidecar keys: ``epoch``, and from
  the trainer ``scheduler`` and ``model`` (type, cr, patch_size, channels,
  latent_size_override, torch_regroup), so :func:`read_meta` gives the config
  without reading the weights.

Each file is written under a temporary name and moved into place with
``os.replace``, so a reader sees the old file or the new one, never a torn
one, and no older file is left that a load would prefer.

``save_checkpoint(block=False)`` copies the state to the CPU on the calling
thread, then writes on one background writer thread (one thread keeps saves
to one path in order); :func:`wait_for_saves` awaits every pending write and
re-raises the first error. Every load, meta read and blocking save waits
first, so a reader always sees finished saves.

On a process mesh (``Trainer(mesh=...)``) every rank calls
:func:`save_checkpoint`: ZeRO-1 moments and the blocks of the heads sharded
over the ``model`` axis (parameters and moments) are gathered first
(collectives) and only rank 0 writes, so the file is the replicated one,
byte for byte the layout of a one-process run's. :func:`load_checkpoint`
waits at a barrier (after rank 0's pending writes) before any rank reads,
and each rank takes its blocks of the whole leaves and moments it loads
(the JAX ``checkpoint.py:49-70``, ``:109-130``): a checkpoint moves between
layouts.

:func:`read_jax_checkpoint` reads the JAX package's ``<path>.msgpack``
(flax ``serialization.to_bytes``) into nested dicts of numpy arrays, for
``utils/jax_weights.load_jax_variables``; its ``.orbax`` trees are not read.
:func:`load_jax_checkpoint` resumes a trainer from such a file.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

SUFFIX = ".pt"
JAX_SUFFIX = ".msgpack"
FORMAT = "simple_vae_rs_tpu_torch/1"

_WRITER_LOCK = threading.Lock()
_WRITER = None  # the single writer thread's executor, made on first use
_PENDING: List[Any] = []  # futures of the writes not yet awaited


def _meta_path(path: str) -> str:
    return path + ".meta.json"


def _replace_into(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _write(path: str, payload: Dict[str, Any], meta: Dict[str, Any]) -> None:
    def write_meta(tmp):
        with open(tmp, "w") as fh:
            json.dump(meta, fh)

    _replace_into(path + SUFFIX, lambda tmp: torch.save(payload, tmp))
    _replace_into(_meta_path(path), write_meta)


def wait_for_saves() -> None:
    """Wait until every scheduled save has been written; re-raise the first
    writer error after all of them have ended (a failed checkpoint must not
    pass silently, and a later write must not be left running)."""
    with _WRITER_LOCK:
        pending, _PENDING[:] = _PENDING[:], []
    first_err: Optional[BaseException] = None
    for fut in pending:
        try:
            fut.result()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def save_checkpoint(path: str, trainer, epoch: int = 0, extra: Optional[Dict] = None,
                    block: bool = True) -> None:
    """Write ``trainer``'s state (+ the sidecar meta ``{"epoch": epoch,
    **extra}``) to ``path``. With ``block=False`` the state is copied to the
    CPU here and written on the writer thread. On a mesh every rank calls
    it and rank 0 alone writes."""
    path = os.path.abspath(path)
    opt = trainer.opt.state_dict()  # ZeRO-1, the model axis: gathered on every rank
    mesh = getattr(trainer, "mesh", None)
    model = trainer.model.state_dict()
    if mesh is not None:
        from simple_vae_rs_tpu_torch.parallel.mesh import gather_params

        model = gather_params(trainer.model, model)
        if mesh.rank != 0:
            return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    meta = {"epoch": int(epoch), **(extra or {})}
    payload = {
        "format": FORMAT,
        "model": {k: _cpu(v) for k, v in model.items()},
        "optimizer": {"mu": [_cpu(t) for t in opt["mu"]], "nu": [_cpu(t) for t in opt["nu"]],
                      "count": int(opt["count"])},
        "rng": _cpu(trainer._rng.get_state()),
        "seed": int(trainer.seed),
        "step": int(trainer.step),
        "epoch": int(epoch),
        "meta": meta,
    }
    if block:
        wait_for_saves()  # an older pending write must not land on top of this one
        _write(path, payload, meta)
        return
    global _WRITER
    with _WRITER_LOCK:
        if _WRITER is None:
            from concurrent.futures import ThreadPoolExecutor

            _WRITER = ThreadPoolExecutor(max_workers=1, thread_name_prefix="svrs-torch-ckpt")
        _PENDING.append(_WRITER.submit(_write, path, payload, meta))


def read_meta(path: str) -> Dict[str, Any]:
    """The sidecar meta of the checkpoint at ``path`` ({} without one)."""
    wait_for_saves()
    mp = _meta_path(os.path.abspath(path))
    if not os.path.exists(mp):
        return {}
    with open(mp) as fh:
        return json.load(fh)


def checkpoint_exists(path: str) -> bool:
    """Whether ``path`` holds a port checkpoint or a JAX ``.msgpack`` one."""
    wait_for_saves()
    path = os.path.abspath(path)
    return os.path.exists(path + SUFFIX) or os.path.exists(path + JAX_SUFFIX)


def load_state(path: str) -> Dict[str, Any]:
    """The port checkpoint at ``path`` as saved, its tensors on the CPU,
    memory-mapped from the file (read where they are used)."""
    wait_for_saves()
    path = os.path.abspath(path)
    if not os.path.exists(path + SUFFIX):
        if os.path.exists(path + JAX_SUFFIX):
            raise FileNotFoundError(
                f"{path}{JAX_SUFFIX} is a JAX checkpoint: serve it with "
                "SuperResolver.from_checkpoint, or read its weights with read_jax_checkpoint")
        raise FileNotFoundError(f"no checkpoint at {path}{SUFFIX}")
    state = torch.load(path + SUFFIX, map_location="cpu", weights_only=True, mmap=True)
    if state.get("format") != FORMAT:
        raise ValueError(f"{path}{SUFFIX}: not a checkpoint of this package "
                         f"(format {state.get('format')!r})")
    return state


def load_checkpoint(path: str, trainer) -> Dict[str, Any]:
    """Restore ``trainer`` from the checkpoint at ``path``: the model's
    parameters and statistics, the optimizer's moments and count, the
    generator state, the seed and the step, and the scheduler where the meta
    holds one. Returns the meta (``epoch`` and the rest). On a mesh every
    rank calls it and none reads before rank 0's writes have ended."""
    mesh = getattr(trainer, "mesh", None)
    if mesh is not None:
        from simple_vae_rs_tpu_torch.parallel.mesh import barrier

        wait_for_saves()
        barrier(mesh)
    state = load_state(path)
    # copies onto the model's device; a sharded head cuts its block
    trainer.model.load_state_dict(state["model"])
    trainer.opt.load_state_dict(state["optimizer"])
    trainer._rng.set_state(state["rng"])
    trainer.seed = int(state["seed"])
    trainer.step = int(state["step"])
    meta = dict(state["meta"])
    if "scheduler" in meta:
        trainer.scheduler.load_state_dict(meta["scheduler"])
    return meta


# ------------------------------------------------------- JAX checkpoints
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3  # flax's msgpack ext type codes


def _ndarray(data: bytes, msgpack) -> np.ndarray:
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":  # no numpy dtype: the exact float32 upcast
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The JAX package's ``<path>.msgpack`` as nested dicts of numpy arrays
    (``params``, ``batch_stats``, ``opt_state``, ``rng``, ``step``; a bfloat16
    leaf comes back as its float32 upcast). Needs the ``msgpack`` package."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError("reading a JAX .msgpack checkpoint needs the msgpack package, "
                          "which is not installed") from e

    def ext_hook(code, data):
        if code == _EXT_NDARRAY:
            return _ndarray(data, msgpack)
        if code == _EXT_NPSCALAR:
            return _ndarray(data, msgpack)[()]
        if code == _EXT_COMPLEX:
            re, im = msgpack.unpackb(data)
            return complex(re, im)
        return msgpack.ExtType(code, data)

    with open(os.path.abspath(path) + JAX_SUFFIX, "rb") as fh:
        tree = msgpack.unpackb(fh.read(), ext_hook=ext_hook, raw=False)
    return _unchunk(tree)


def _adam_state(opt_state) -> Optional[Dict[str, Any]]:
    """optax ``scale_by_adam``'s state in a serialized chain state: flax
    writes a chain as nested dicts keyed ``"0"``, ``"1"``, ..., so it is
    found by its ``count`` / ``mu`` / ``nu`` keys, not by its position."""
    if not isinstance(opt_state, dict):
        return None
    if {"count", "mu", "nu"} <= set(opt_state):
        return opt_state
    for value in opt_state.values():
        found = _adam_state(value)
        if found is not None:
            return found
    return None


def load_jax_checkpoint(path: str, trainer) -> Dict[str, Any]:
    """Resume ``trainer`` from the JAX package's ``<path>.msgpack``: the
    parameters and BatchNorm statistics (``utils/jax_weights``), optax's
    ``clip_by_global_norm`` + ``scale_by_adam`` state (count, mu, nu) mapped
    by leaf name into ``ClipAdam``'s parameter order (a bfloat16 ``mu``,
    ``bf16_moments``, is read as its exact float32 upcast and rounds back to
    the same bfloat16), ``step``, and the plateau scheduler from the sidecar
    meta. Returns the meta (``epoch`` and the rest).

    The JAX run's ``rng`` key has no torch counterpart: the trainer keeps
    its own generator and seed (the command line's ``--seed``). Needs the
    ``msgpack`` package, as :func:`read_jax_checkpoint` does."""
    from simple_vae_rs_tpu_torch.utils.jax_weights import _flatten, load_jax_variables

    tree = read_jax_checkpoint(path)
    where = os.path.abspath(path) + JAX_SUFFIX
    load_jax_variables(trainer.model, {"params": tree["params"],
                                       "batch_stats": tree.get("batch_stats", {})})
    adam = _adam_state(tree.get("opt_state"))
    if adam is None:
        raise ValueError(f"{where}: its opt_state holds no scale_by_adam state (count, mu, nu)")
    opt = trainer.opt
    state: Dict[str, Any] = {"count": int(np.asarray(adam["count"]))}
    for key, mine in (("mu", opt.mu), ("nu", opt.nu)):
        leaves = _flatten(adam[key])
        if set(leaves) != set(trainer.params):
            raise KeyError(f"{where}: {key} leaves differ from the model's parameters: missing "
                           f"{sorted(set(trainer.params) - set(leaves))}, extra "
                           f"{sorted(set(leaves) - set(trainer.params))}")
        moments = []
        for name, m in zip(trainer.params, mine):
            f32 = torch.from_numpy(np.array(leaves[name], dtype=np.float32))
            t = f32.to(m.dtype)
            if not torch.allclose(t.float(), f32, rtol=0.0, atol=0.0, equal_nan=True):
                raise ValueError(f"{where}: {key} of {name} is not representable in {m.dtype} "
                                 "(the JAX run's bf16_moments differs from this trainer's)")
            moments.append(t)
        state[key] = moments
    opt.load_state_dict(state)
    trainer.step = int(np.asarray(tree["step"]))
    meta = read_meta(path)
    if "scheduler" in meta:
        trainer.scheduler.load_state_dict(meta["scheduler"])
    return meta
