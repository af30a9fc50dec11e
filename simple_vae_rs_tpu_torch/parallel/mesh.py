"""The mesh of the port (the JAX package's ``parallel/mesh.py``).

JAX drives every local chip from one process and lets GSPMD insert the
collectives. PyTorch drives one card per process through
``torch.distributed``, so the port's mesh has two forms, both made by
:func:`make_mesh`:

- **a process mesh** (training; ``devices=None``): the ranks of the default
  process group, ``world = dcn x data x model`` with ``model == 1``. The batch
  axes (``dcn``, ``data``) split the global batch over the ranks in
  contiguous blocks in rank order, as JAX's ``P(("dcn", "data"))`` lays it
  out; ``dcn`` only factors the world and changes no number. Without a
  process group the mesh is one rank and every collective is skipped.
- **a device mesh** (serving; ``devices=[...]``): one process over a list of
  devices, one replica of the model on each (:func:`replicate`). A request
  is split over the replicas (:meth:`Replicas.map`), every replica's
  launches are issued before any host sync, and the result is gathered on
  the first device.

A layout the world or the device list cannot fill raises with JAX's message
(``mesh {dcn}x{data}x{model} needs {need} devices, have {n}``); a training
layout that leaves ranks out raises too (JAX would use the first devices).
The ``model`` axis above 1 (channel-sharded heads) is ROADMAP A.8c.

:func:`init_distributed` starts the process group from torchrun's
environment: NCCL where every rank has a card of its own, gloo where ranks
share a card or run on the CPU (the tensors stay where they are either way).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from simple_vae_rs_tpu_torch.config import MeshConfig

Tensor = torch.Tensor
Spec = Tuple[Optional[str], ...]  # an axis name or None per dim; () is replicated

MODEL_AXIS_TODO = ("the mesh's model axis (channel-sharded heads) is not ported yet "
                   "(ROADMAP A.8c)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` is JAX's ``dict(mesh.shape)``: ``{"data", "model"}``, or
    ``{"dcn", "data", "model"}`` when ``dcn > 1``. A process mesh has
    ``group`` (None without a process group: one rank) and this process's
    ``rank``; a device mesh has ``devices``."""

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...] = ()
    group: Any = None
    rank: int = 0
    backend: str = ""

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def n_shards(self) -> int:
        """How many slices the batch splits into (the batch axes' product)."""
        n = 1
        for a in batch_axes(self):
            n *= self.shape[a]
        return n

    @property
    def is_process(self) -> bool:
        return not self.devices

    @property
    def distributed(self) -> bool:
        """Whether collectives run: a process mesh with a process group."""
        return self.is_process and self.group is not None


def _shape(dcn: int, data: int, model: int) -> Dict[str, int]:
    if dcn > 1:
        return {"dcn": dcn, "data": data, "model": model}
    return {"data": data, "model": model}


def _check_layout(cfg: MeshConfig, n: int) -> Tuple[int, int, int]:
    dcn, data, model = cfg.axis_sizes(n)
    if model > 1:
        raise ValueError(f"mesh {dcn}x{data}x{model}: {MODEL_AXIS_TODO}")
    need = dcn * max(data, 1) * model
    if need > n or data < 1:
        raise ValueError(f"mesh {dcn}x{data}x{model} needs {need} devices, have {n}")
    return dcn, data, model


def make_mesh(cfg: Optional[MeshConfig] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A device mesh over the first ``dcn x data`` of ``devices`` when they
    are given, else a process mesh over the default process group's ranks
    (one rank when there is none). A process mesh must use every rank."""
    cfg = cfg or MeshConfig()
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        dcn, data, model = _check_layout(cfg, len(devs))
        return Mesh(_shape(dcn, data, model), devices=tuple(devs[:dcn * data * model]))
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        group, backend = dist.group.WORLD, str(dist.get_backend())
    else:
        world, rank, group, backend = 1, 0, None, ""
    dcn, data, model = _check_layout(cfg, world)
    if dcn * data * model < world:
        raise ValueError(f"mesh {dcn}x{data}x{model} uses {dcn * data * model} of the "
                         f"{world} ranks: a training mesh must use every rank")
    return Mesh(_shape(dcn, data, model), group=group, rank=rank, backend=backend)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes the batch dim shards over (``dcn`` included when present)."""
    return ("dcn", "data") if "dcn" in mesh.shape else ("data",)


def shard_rows(mesh: Mesh, n: int, shard: Optional[int] = None) -> slice:
    """The rows of a batch of ``n`` that shard ``shard`` (default this
    rank) holds: contiguous blocks in shard order."""
    k = mesh.n_shards
    if n % k:
        raise ValueError(f"a batch of {n} does not split into {k} equal shards")
    i = mesh.rank if shard is None else int(shard)
    return slice(i * (n // k), (i + 1) * (n // k))


def shard_batch(mesh: Mesh, batch: Sequence[Any], shard: Optional[int] = None
                ) -> Tuple[Any, ...]:
    """This rank's contiguous slice (or shard ``shard``'s) of each array of
    the global ``batch`` (tensors or numpy arrays, batch dim first)."""
    return tuple(a[shard_rows(mesh, a.shape[0], shard)] for a in batch)


# ---------------------------------------------------------------- collectives
class _AllReduceSum(torch.autograd.Function):
    """All-reduce SUM forward and backward: with each rank's loss its share
    of the global loss, the backward's sum is the global gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: Tensor, group) -> Tensor:
    """``x`` summed over the ranks of ``group``, differentiably."""
    return _AllReduceSum.apply(x, group)


_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def all_reduce_(mesh: Mesh, t: Tensor, op: str = "sum") -> Tensor:
    """In-place all-reduce of ``t`` over a process mesh (nothing without
    one); returns ``t``."""
    if mesh is not None and mesh.distributed:
        dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]), group=mesh.group)
    return t


def all_gather_rows(mesh: Mesh, t: Tensor) -> Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order: the global batch from the local slices."""
    if mesh is None or not mesh.distributed:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts)


def first_rows(mesh: Mesh, t: Tensor, n: int) -> Tensor:
    """The first ``n`` rows of the global batch whose local slice is ``t``
    (each rank sends at most ``n`` rows)."""
    return all_gather_rows(mesh, t[:n])[:n]


def barrier(mesh: Mesh) -> None:
    if mesh is not None and mesh.distributed:
        dist.barrier(group=mesh.group)


def agree(mesh: Mesh, flag: bool, op: str = "min") -> bool:
    """One answer on every rank: the MIN (all agree) or MAX (any) of ``flag``."""
    if mesh is None or not mesh.distributed:
        return bool(flag)
    device = _collective_device(mesh)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    all_reduce_(mesh, t, op)
    return bool(t.item())


def _collective_device(mesh: Mesh) -> torch.device:
    if mesh.backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_shards(mesh: Mesh, shard: Tensor, dim: int) -> Tensor:
    """The whole tensor from every rank's equal ``shard`` along ``dim``
    (list ``all_gather``: gloo has no reduce-scatter nor gather-into)."""
    parts = [torch.empty_like(shard) for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(parts, shard.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=dim)


def all_reduce_flat_(mesh: Mesh, tensors: List[Tensor]) -> None:
    """All-reduce SUM of a list of tensors through one flat buffer per
    dtype and device (one collective each), in place."""
    if mesh is None or not mesh.distributed or not tensors:
        return
    groups: Dict[Tuple[torch.dtype, torch.device], List[Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        torch._foreach_copy_(ts, [f.view_as(t) for f, t in
                                  zip(torch.split(flat, [t.numel() for t in ts]), ts)])


# ------------------------------------------------------------ state layout
def param_shardings(mesh: Mesh, params: Dict[str, Tensor]) -> Dict[str, Spec]:
    """Each parameter's layout: replicated (``()``). The ``model`` axis,
    which channel-shards the wide heads in JAX, raises (ROADMAP A.8c)."""
    if mesh.shape.get("model", 1) > 1:
        raise ValueError(MODEL_AXIS_TODO)
    return {name: () for name in params}


# ZeRO-1 pays off on tensors whose update traffic matters; tiny leaves would
# trade a fused elementwise update for collective latency (JAX's bar)
_ZERO1_MIN_ELEMS = 1 << 20


def _zero1_spec(spec: Spec, shape: Sequence[int], data_axis: int) -> Spec:
    """JAX's rule: extend ``spec`` by sharding the largest still-unsharded
    dim of a moment of at least 2^20 elements that divides by ``data_axis``
    over ``data``; ties go to the later dim."""
    size = 1
    for d in shape:
        size *= int(d)
    if len(shape) == 0 or size < _ZERO1_MIN_ELEMS or data_axis <= 1:
        return tuple(spec)
    dims = list(spec) + [None] * (len(shape) - len(spec))
    best, best_size = None, 0
    for i, (d, cur) in enumerate(zip(shape, dims)):
        if cur is None and d % data_axis == 0 and d >= best_size:
            best, best_size = i, d
    if best is None:
        return tuple(spec)
    dims[best] = "data"
    return tuple(dims)


def zero1_dims(mesh: Mesh, params: Dict[str, Tensor]) -> List[Optional[int]]:
    """Per parameter, in order, the dim its moments shard over (None: kept
    whole), from :func:`_zero1_spec` with the rank count as the ``data``
    size: with ``dcn > 1`` the shards span both batch axes (JAX keeps a copy
    of each ``data`` shard per ``dcn`` slice; ``dcn`` changes no number)."""
    data = mesh.n_shards
    dims = []
    for spec, p in zip(param_shardings(mesh, params).values(), params.values()):
        z = _zero1_spec(spec, tuple(p.shape), data)
        dims.append(z.index("data") if "data" in z else None)
    return dims


def replicate(mesh: Mesh, module: nn.Module):
    """Place ``module`` replicated over ``mesh``. A process mesh broadcasts
    its parameters and buffers from rank 0 in place and returns it. A
    device mesh returns :class:`Replicas`: ``module`` itself on the first
    device, a copy on each other."""
    if mesh.is_process:
        if mesh.distributed:
            with torch.no_grad():
                for t in list(module.parameters()) + list(module.buffers()):
                    if t.numel():
                        dist.broadcast(t.data, src=0, group=mesh.group)
        return module
    import copy

    first = module.to(mesh.devices[0])
    return Replicas(mesh, [first] + [copy.deepcopy(first).to(d) for d in mesh.devices[1:]])


def shard_state(mesh: Mesh, trainer, zero1: bool = False):
    """Place a trainer's state on a process mesh: the model's parameters and
    statistics replicated from rank 0, and with ``zero1`` each large Adam
    moment sharded over ``data`` (:func:`_zero1_spec`): the optimizer then
    keeps and advances this rank's shard only. Returns ``trainer``."""
    replicate(mesh, trainer.model)
    if zero1 and mesh.distributed:
        trainer.opt.shard(mesh, zero1_dims(mesh, trainer.params))
    return trainer


# --------------------------------------------------------- device replicas
def _device_scope(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class Replicas(list):
    """One replica of a module per device of a device mesh."""

    def __init__(self, mesh: Mesh, modules: Sequence[nn.Module]) -> None:
        super().__init__(modules)
        self.mesh = mesh

    def map(self, fn: Callable[..., Tensor], *rows: Tensor) -> Tensor:
        """``fn(replica, *parts)`` over the replicas, each given its
        contiguous block of the rows of ``rows`` (padded with copies of the
        last row to a multiple of the replica count), on its device; every
        replica's work is issued before the outputs are gathered, in order,
        on the first device and the padding cut off."""
        b = int(rows[0].shape[0])
        n = len(self)
        pad = (-b) % n
        if pad:
            rows = tuple(torch.cat([r, r[-1:].expand((pad,) + tuple(r.shape[1:]))])
                         for r in rows)
        m = (b + pad) // n
        outs = []
        for k, (mod, dev) in enumerate(zip(self, self.mesh.devices)):
            with _device_scope(dev):
                parts = [r[k * m:(k + 1) * m].to(dev, non_blocking=True) for r in rows]
                outs.append(fn(mod, *parts))
        first = self.mesh.devices[0]
        out = torch.cat([o.to(first, non_blocking=True) for o in outs])
        return out[:b] if pad else out


# ------------------------------------------------------------ process group
def init_distributed(device: str = "cuda") -> torch.device:
    """Start the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` where set) and return this
    rank's device. On the card the backend is NCCL when every rank of the
    host has a card of its own, gloo when ranks share one (rank r on card
    ``r % cards``); on the CPU it is gloo. The choice is printed. Raises a
    ``ValueError`` without that environment (as ``jax.distributed.initialize()``
    fails without a coordinator)."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise ValueError(
            f"the process group starts from torchrun's environment, which lacks "
            f"{', '.join(missing)}: launch with `torchrun --nproc_per_node N -m "
            f"simple_vae_rs_tpu_torch.cli --multihost ...`")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the process group was asked for on the card, but no CUDA card "
                               "is available; pass --backend cpu")
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= local_world else "gloo"
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
        why = (f"{local_world} rank(s) of this host over {cards} card(s): "
               + ("one card each" if backend == "nccl" else "ranks share a card"))
    else:
        backend, why = "gloo", "on the CPU"
    if not dist.is_initialized():
        dist.init_process_group(backend=backend, init_method="env://", rank=rank,
                                world_size=world)
    print(f"distributed: rank {rank} of {world}, backend {backend} ({why}), device {dev}")
    return dev
