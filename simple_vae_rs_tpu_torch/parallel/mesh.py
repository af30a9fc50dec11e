"""The mesh of the port (the JAX package's ``parallel/mesh.py``).

JAX drives every local chip from one process and lets GSPMD insert the
collectives. PyTorch drives one card per process through
``torch.distributed``, so the port's mesh has two forms, both made by
:func:`make_mesh`:

- **a process mesh** (training; ``devices=None``): the ranks of the default
  process group, ``world = dcn x data x model``, laid out as JAX's
  ``devices.reshape(dcn, data, model)``: rank ``r`` is batch shard
  ``r // model`` (its coordinate over the batch axes) and model index
  ``r % model``, so the ``model`` ranks of one batch shard are consecutive.
  The batch axes (``dcn``, ``data``) split the global batch over the shards
  in contiguous blocks in shard order, as JAX's ``P(("dcn", "data"))`` lays
  it out; ``dcn`` only factors the world and changes no number. Each rank
  belongs to two subgroups: its ``data_group`` (the ranks of its model
  index, one per batch shard: the batch reductions) and its ``model_group``
  (the ranks of its batch shard: the heads' collectives). Without a
  process group the mesh is one rank and every collective is skipped.
- **a device mesh** (serving; ``devices=[...]``): one process over a list of
  devices, one replica of the model per batch shard, on the shard's first
  device (:func:`replicate`; the parameters are replicated, as JAX serves).
  A request is split over the replicas (:meth:`Replicas.map`), every
  replica's launches are issued before any host sync, and the result is
  gathered on the first device.

The ``model`` axis channel-shards the wide heads (JAX's ``_MODEL_SHARDED``:
``yz_conv2``, ``uz_conv2``, ``pz_mu_conv1/2``, ``pz_lv_conv1/2``,
``ex_head``, ``ey_head`` and the VAE's ``enc_head``) on a process mesh:
:func:`shard_model` swaps each for ``ops/conv_blocks.ShardedConv3x3``, which
holds this rank's block of the output channels of the kernel and bias
(:func:`param_shardings`: ``(None, None, None, "model")`` and
``("model",)``) and is column-parallel with the output gathered: the input
passes through :func:`copy_to_model` (identity forward, the partial input
gradients all-reduced over the model group backward) and the conv's output
through :func:`gather_channels` (all-gathered along channels forward, this
rank's channel slice of the gradient backward). :func:`whole_state_dict`
and :func:`unshard_model` gather the whole leaves back.

A layout the world or the device list cannot fill raises with JAX's message
(``mesh {dcn}x{data}x{model} needs {need} devices, have {n}``); a training
layout that leaves ranks out raises too (JAX would use the first devices),
and so does a head whose output channels do not divide by ``model``.

:func:`init_distributed` starts the process group from torchrun's
environment: NCCL where every rank has a card of its own, gloo where ranks
share a card or run on the CPU (the tensors stay where they are either way).
A training step captured into a CUDA graph (``TrainConfig.scan_steps``)
captures its NCCL collectives with it; gloo's copy through the host and
cannot be captured, so on the card ``scan_steps`` above 1 needs NCCL.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from simple_vae_rs_tpu_torch.config import MeshConfig

Tensor = torch.Tensor
Spec = Tuple[Optional[str], ...]  # an axis name or None per dim; () is replicated


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` is JAX's ``dict(mesh.shape)``: ``{"data", "model"}``, or
    ``{"dcn", "data", "model"}`` when ``dcn > 1``. A process mesh has
    ``group`` (the world; None without a process group: one rank), this
    process's ``rank``, and its ``data_group`` and ``model_group`` (the world
    and None when ``model == 1``); a device mesh has ``devices``."""

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...] = ()
    group: Any = None
    rank: int = 0
    backend: str = ""
    data_group: Any = None
    model_group: Any = None

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
    def model(self) -> int:
        """The ``model`` axis' size."""
        return self.shape.get("model", 1)

    @property
    def shard(self) -> int:
        """This rank's batch shard: its coordinate over the batch axes."""
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """This rank's coordinate on the ``model`` axis."""
        return self.rank % self.model

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
    need = dcn * max(data, 1) * model
    if need > n or data < 1:
        raise ValueError(f"mesh {dcn}x{data}x{model} needs {need} devices, have {n}")
    return dcn, data, model


def _subgroups(shards: int, model: int, rank: int) -> Tuple[Any, Any]:
    """This rank's data group (the ranks of its model index) and model group
    (the ranks of its batch shard). Every rank makes every group, in one
    order, as ``dist.new_group`` requires."""
    data_groups = [dist.new_group([k + model * s for s in range(shards)])
                   for k in range(model)]
    model_groups = [dist.new_group(list(range(s * model, (s + 1) * model)))
                    for s in range(shards)]
    return data_groups[rank % model], model_groups[rank // model]


def make_mesh(cfg: Optional[MeshConfig] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A device mesh over the first ``dcn x data x model`` of ``devices``
    when they are given, else a process mesh over the default process
    group's ranks (one rank when there is none). A process mesh must use
    every rank."""
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
    data_group, model_group = group, None
    if model > 1:
        data_group, model_group = _subgroups(dcn * data, model, rank)
    return Mesh(_shape(dcn, data, model), group=group, rank=rank, backend=backend,
                data_group=data_group, model_group=model_group)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes the batch dim shards over (``dcn`` included when present)."""
    return ("dcn", "data") if "dcn" in mesh.shape else ("data",)


def shard_rows(mesh: Mesh, n: int, shard: Optional[int] = None) -> slice:
    """The rows of a batch of ``n`` that batch shard ``shard`` (default this
    rank's) holds: contiguous blocks in shard order."""
    k = mesh.n_shards
    if n % k:
        raise ValueError(f"a batch of {n} does not split into {k} equal shards")
    i = mesh.shard if shard is None else int(shard)
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


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the gradient all-reduced (SUM) over the
    model group: a column-parallel conv's input gradient is a partial sum
    over this rank's output channels."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def copy_to_model(x: Tensor, group) -> Tensor:
    """``x``, whose gradient is summed over the model ``group``."""
    return _CopyToModel.apply(x, group)


def gather_cat(t: Tensor, group, n: int, dim: int) -> Tensor:
    """The ``n`` ranks of ``group``'s equal ``t`` concatenated along ``dim``
    in rank order (list ``all_gather``: gloo has no gather-into)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


class _GatherChannels(torch.autograd.Function):
    """All-gather along the last dim over the model group, in rank order;
    backward, this rank's slice of the gradient (every rank of the group
    computes the same loss from the gathered tensor)."""

    @staticmethod
    def forward(ctx, y, group, index, shards):
        ctx.index, ctx.shards = index, shards
        return gather_cat(y, group, shards, -1)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1] // ctx.shards
        return g[..., ctx.index * n:(ctx.index + 1) * n].contiguous(), None, None, None


def gather_channels(y: Tensor, group, index: int, shards: int) -> Tensor:
    """The whole channels of the ``shards`` ranks' ``y`` blocks (this rank's
    is block ``index``), differentiably."""
    return _GatherChannels.apply(y, group, index, shards)


_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def all_reduce_(mesh: Mesh, t: Tensor, op: str = "sum") -> Tensor:
    """In-place all-reduce of ``t`` over the batch shards of a process mesh
    (its data group; nothing without one); returns ``t``."""
    if mesh is not None and mesh.distributed:
        dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]), group=mesh.data_group)
    return t


def all_gather_rows(mesh: Mesh, t: Tensor) -> Tensor:
    """Every batch shard's ``t`` (equal shapes) concatenated along dim 0 in
    shard order: the global batch from the local slices."""
    if mesh is None or not mesh.distributed:
        return t
    return gather_cat(t, mesh.data_group, mesh.n_shards, 0)


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
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=_collective_device(mesh))
    dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]), group=mesh.group)
    return bool(t.item())


def broadcast_int(mesh: Mesh, value: int) -> int:
    """Rank 0's ``value`` on every rank (``value`` itself without collectives)."""
    if mesh is None or not mesh.distributed:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_collective_device(mesh))
    dist.broadcast(t, src=0, group=mesh.group)
    return int(t.item())


def _collective_device(mesh: Mesh) -> torch.device:
    if mesh.backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_shards(mesh: Mesh, shard: Tensor, dim: int) -> Tensor:
    """The whole tensor from every batch shard's equal ``shard`` along
    ``dim`` (gloo has no reduce-scatter)."""
    return gather_cat(shard, mesh.data_group, mesh.n_shards, dim)


def gather_model(mesh: Mesh, block: Tensor, dim: int) -> Tensor:
    """The whole leaf from every model rank's equal ``block`` along ``dim``."""
    return gather_cat(block, mesh.model_group, mesh.model, dim)


def _flat_sum_(tensors: List[Tensor], group) -> None:
    """All-reduce SUM over ``group`` of a list of tensors through one flat
    buffer per dtype and device (one collective each), in place."""
    groups: Dict[Tuple[torch.dtype, torch.device], List[Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        torch._foreach_copy_(ts, [f.view_as(t) for f, t in
                                  zip(torch.split(flat, [t.numel() for t in ts]), ts)])


def all_reduce_flat_(mesh: Mesh, tensors: List[Tensor],
                     model_dims: Optional[Sequence[Optional[int]]] = None) -> None:
    """All-reduce SUM over the batch shards (the data group) of a list of
    tensors, in place: the gradients. With a ``model`` axis, ``model_dims``
    (per tensor its model-axis dim, :func:`model_dims`; None: replicated)
    splits them: a sharded head's blocks are summed over the data group,
    every replicated tensor over the world and divided by the axis' size,
    the mean of the model group's copies (the same sums in exact
    arithmetic): every rank then holds the same bits, where the data
    groups' sums alone differ in the last bits between the model ranks (on
    the card cuDNN's weight gradients are not deterministic) and the
    replicated parameters would drift apart."""
    if mesh is None or not mesh.distributed or not tensors:
        return
    if mesh.model == 1:
        _flat_sum_(tensors, mesh.data_group)
        return
    if model_dims is None or len(model_dims) != len(tensors):
        raise ValueError("a model axis needs each tensor's model dim (parallel.mesh.model_dims)")
    replicated = [t for t, d in zip(tensors, model_dims) if d is None]
    sharded = [t for t, d in zip(tensors, model_dims) if d is not None]
    if replicated:
        _flat_sum_(replicated, mesh.group)
        torch._foreach_mul_(replicated, 1.0 / mesh.model)
    if sharded:
        _flat_sum_(sharded, mesh.data_group)


# ------------------------------------------------------------ state layout
# The leaves whose output-channel dim shards over ``model`` when it has size
# > 1: the wide prior/conditioning heads (JAX ``parallel/mesh.py``).
MODEL_SHARDED = re.compile(
    r"(yz_conv2|uz_conv2|pz_mu_conv\d|pz_lv_conv\d|ex_head|ey_head|enc_head)"
)


def _spec_for(name: str, ndim: int) -> Spec:
    if ndim == 4 and MODEL_SHARDED.search(name):
        return (None, None, None, "model")  # (kh, kw, in, out)
    if ndim == 1 and MODEL_SHARDED.search(name):
        return ("model",)  # bias
    return ()


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in getattr(leaf, "shape", leaf))


def param_shardings(mesh: Mesh, params: Dict[str, Any]) -> Dict[str, Spec]:
    """Each parameter's layout (JAX's ``param_shardings`` rule on the port's
    names; ``params`` maps names to whole tensors or shapes): replicated
    (``()``), except the wide heads' kernels ``(None, None, None, "model")``
    and biases ``("model",)`` when the ``model`` axis is above 1. Raises a
    ``ValueError`` naming a leaf whose sharded dim does not divide by it."""
    model = mesh.shape.get("model", 1)
    if model == 1:
        return {name: () for name in params}
    out = {}
    for name, leaf in params.items():
        shape = _shape_of(leaf)
        spec = _spec_for(name, len(shape))
        if "model" in spec:
            d = spec.index("model")
            if shape[d] % model:
                raise ValueError(f"{name}: its dim {d} of size {shape[d]} does not divide by "
                                 f"the mesh's model axis of {model}")
        out[name] = spec
    return out


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


def zero1_dims(mesh: Mesh, params: Dict[str, Any]) -> List[Optional[int]]:
    """Per parameter, in order, the dim its moments shard over (None: kept
    whole), from :func:`_zero1_spec` on the whole leaves (``params``: names
    to whole tensors or shapes) composed with :func:`param_shardings`, with
    the batch shard count as the ``data`` size: with ``dcn > 1`` the shards
    span both batch axes (JAX keeps a copy of each ``data`` shard per
    ``dcn`` slice; ``dcn`` changes no number)."""
    dims = []
    for spec, p in zip(param_shardings(mesh, params).values(), params.values()):
        z = _zero1_spec(spec, _shape_of(p), mesh.n_shards)
        dims.append(z.index("data") if "data" in z else None)
    return dims


def replicate(mesh: Mesh, module: nn.Module):
    """Place ``module`` replicated over ``mesh``. A process mesh broadcasts
    its parameters and buffers from rank 0 in place and returns it (before
    :func:`shard_model`). A device mesh returns :class:`Replicas`: ``module``
    itself on the first device, a copy on the first device of each other
    batch shard."""
    if mesh.is_process:
        if mesh.distributed:
            with torch.no_grad():
                for t in list(module.parameters()) + list(module.buffers()):
                    if t.numel():
                        dist.broadcast(t.data, src=0, group=mesh.group)
        return module
    import copy

    devices = mesh.devices[::mesh.model]
    first = module.to(devices[0])
    return Replicas(mesh, [first] + [copy.deepcopy(first).to(d) for d in devices[1:]])


# ---------------------------------------------------------- the model axis
def sharded_convs(model: nn.Module) -> Dict[str, nn.Module]:
    """The model's channel-sharded heads by module name."""
    from simple_vae_rs_tpu_torch.ops.conv_blocks import ShardedConv3x3

    return {name: mod for name, mod in model.named_modules()
            if isinstance(mod, ShardedConv3x3)}


def model_dims(model: nn.Module) -> List[Optional[int]]:
    """Per parameter of ``model``, in order, the dim it is sharded over on
    the ``model`` axis (None: whole on every rank)."""
    heads = sharded_convs(model)
    return [_owner(heads, n)[2] for n, _ in model.named_parameters()]


def _owner(heads: Dict[str, nn.Module], name: str):
    prefix, _, leaf = name.rpartition(".")
    head = heads.get(prefix)
    dim = head.dim_of(leaf) if head is not None else None
    return head, leaf, dim


def whole_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's whole shape, by name (a sharded head's leaves
    times the ``model`` axis along their sharded dim)."""
    heads = sharded_convs(model)
    out = {}
    for name, p in model.named_parameters():
        head, _, dim = _owner(heads, name)
        shape = list(p.shape)
        if dim is not None:
            shape[dim] *= head.shards
        out[name] = tuple(shape)
    return out


def shard_params(model: nn.Module, tensors: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """``tensors`` (whole leaves by the model's names) with each leaf of a
    sharded head replaced by this rank's block (a view)."""
    heads = sharded_convs(model)
    out = {}
    for name, t in tensors.items():
        head, leaf, dim = _owner(heads, name)
        out[name] = t if dim is None else head.block(leaf, t)
    return out


def gather_params(model: nn.Module, tensors: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """``tensors`` (leaves by the model's names, a sharded head's as this
    rank's blocks) with every block gathered whole over the model group (a
    collective: every rank of the group calls it)."""
    heads = sharded_convs(model)
    out = {}
    for name, t in tensors.items():
        head, _, dim = _owner(heads, name)
        out[name] = t if dim is None else head.gather(t, dim)
    return out


def whole_state_dict(model: nn.Module) -> Dict[str, Tensor]:
    """``model.state_dict()`` with the sharded heads' leaves whole (a
    collective); the same as ``state_dict()`` on a model not sharded."""
    return gather_params(model, model.state_dict())


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Replicate ``model`` over the process ``mesh`` from rank 0, then with
    a ``model`` axis above 1 swap every head JAX channel-shards
    (:data:`MODEL_SHARDED`) for a ``ops/conv_blocks.ShardedConv3x3`` holding
    this rank's block, in place; parameter names and order stay. Raises
    (:func:`param_shardings`) before anything changes when a head's output
    channels do not divide by the axis. Returns ``model``."""
    from simple_vae_rs_tpu_torch.ops.conv_blocks import Conv3x3, ShardedConv3x3

    param_shardings(mesh, whole_shapes(model))
    replicate(mesh, model)
    if mesh.model == 1:
        return model
    if not mesh.distributed:
        raise ValueError("the model axis shards over a process group: start one "
                         "(parallel.mesh.init_distributed) with dcn x data x model ranks")
    for name, mod in list(model.named_modules()):
        if (type(mod) is Conv3x3 and MODEL_SHARDED.search(name)):
            parent, _, attr = name.rpartition(".")
            owner = model.get_submodule(parent) if parent else model
            setattr(owner, attr, ShardedConv3x3(mod, mesh.model_group, mesh.model_index,
                                                mesh.model))
    return model


def unshard_model(model: nn.Module) -> nn.Module:
    """A whole copy of a model whose heads are sharded (a collective: every
    rank of the model group calls it), on the same device, dtype and
    switches; ``model`` itself when nothing is sharded."""
    if not sharded_convs(model):
        return model
    from simple_vae_rs_tpu_torch.ops.conv_blocks import use_chain, use_plain_path

    state = whole_state_dict(model)
    p = next(model.parameters())
    whole = type(model)(model.config, device=p.device, dtype=model.dtype)
    whole.load_state_dict(state)
    use_plain_path(whole, model.plain)
    use_chain(whole, model.chain)
    return whole.train(model.training)


def shard_state(mesh: Mesh, trainer, zero1: bool = False):
    """Lay a trainer's optimizer out on a process mesh (its model placed by
    :func:`shard_model`, its optimizer made over the model axis by
    ``Trainer.make_optimizer``): with ``zero1`` each large Adam moment is
    also sharded over the batch shards (:func:`_zero1_spec`): the optimizer
    then keeps and advances this rank's block only. Returns ``trainer``."""
    if zero1 and mesh.distributed:
        trainer.opt.shard(mesh, zero1_dims(mesh, whole_shapes(trainer.model)))
    return trainer


# --------------------------------------------------------- device replicas
def _device_scope(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class Replicas(list):
    """One replica of a module per batch shard of a device mesh."""

    def __init__(self, mesh: Mesh, modules: Sequence[nn.Module]) -> None:
        super().__init__(modules)
        self.mesh = mesh
        self.devices = mesh.devices[::mesh.model]  # each batch shard's first

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
        for k, (mod, dev) in enumerate(zip(self, self.devices)):
            with _device_scope(dev):
                parts = [r[k * m:(k + 1) * m].to(dev, non_blocking=True) for r in rows]
                outs.append(fn(mod, *parts))
        first = self.devices[0]
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
