"""NHWC conv building blocks of the port, named as the flax tree.

- :class:`Conv3x3`: 3x3/s1 conv with bias (flax ``PallasCapableConv3x3``);
  :class:`ShardedConv3x3` holds its block of output channels on the mesh's
  ``model`` axis and gathers the output.
- :class:`DownBlock`: conv3x3 -> conv4x4/s2/p1 -> BatchNorm -> ReLU.
- :class:`UpBlock`: conv3x3 -> convT4x4/s2/p1 -> BatchNorm -> ReLU.

Either block takes ``with_bn`` and ``with_relu`` (JAX ``conv_blocks.py:388-389``,
``:447-448``): without BatchNorm the tail is the conv with its bias, and its
eval kernel runs with ``(scale, shift) = (1, bias)``; without ReLU the
kernel's ``relu`` is off (``ops/sequences.py`` turns both off at the last
stage).

Weights keep the JAX layouts: conv kernels HWIO ``(kh, kw, C, O)`` and the
transposed-conv kernel in its input-dilated, spatially flipped form. Every
conv runs through a fused kernel (``ops/fused_conv.py``), forward and input
gradient, in both modes:

- training (``module.train()``): the strided conv runs with its bias as the
  shift, then :class:`BatchNorm` normalises with the batch statistics and
  updates the running ones, then ReLU. On a mesh (:func:`sync_batchnorm`)
  the statistics are those of the global batch: the per-channel sums, sums
  of squares and the count are all-reduced, the gradient flowing back
  through the all-reduce;
- eval: the strided tail of a block folds BatchNorm's running statistics
  into ``(scale, shift)`` and runs as one fused kernel with the ReLU.

A conv that carries int8 weights (``kernel_q`` / ``kernel_s``, attached by
``ops/quantize.attach_quant``) runs in eval through the W8A8 kernels of
``ops/fused_int8.py`` with the same ``(scale, shift)``, on its input cast to
the compute dtype (the JAX blocks' ``x.astype(dtype)``); their presence on
the module is the only switch, so int8 and float models coexist in a
process. Training never takes that path.

:func:`use_plain_path` switches a model's convs, float32 and int8, (and its
ELBO reductions) to the kernels' plain versions: the reference that the
kernels are held against on the card.

Compute dtype (:func:`set_dtype`; the models' ``dtype`` argument): float32,
or bfloat16 as the JAX modules' ``dtype=jnp.bfloat16``. Parameters, the
BatchNorm statistics, the fused kernels' ``scale`` and ``shift`` stay
float32; every conv casts its input and its kernel to the compute dtype per
call and returns that dtype. BatchNorm in training computes its statistics
and the normalisation in float32 and rounds once (flax ``BatchNorm(dtype,
param_dtype=float32)``); the eval tails fold BatchNorm in float32 and cast
only the kernel. The int8 kernels take a bfloat16 input as they take a
float32 one and return bfloat16; their int8 weights and scales are the same
in both dtypes (quantized from the float32 parameters).

:func:`tail_chain` runs an eval-mode tail of 3x3 convs (the four convs that
end each decoder and encoder) as one launch of the chain kernel of
``ops/fused_chain.py`` on a model whose chain is switched on
(:func:`use_chain`; off by default, as in the JAX package), in either
compute dtype: in bfloat16 its kernels are cast per call and each layer is
rounded to bfloat16 with its bias rounded to bfloat16 first (the JAX chain
kernel's function). It steps aside on a model that carries any int8 weight,
as the JAX ``tail_chain`` does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from simple_vae_rs_tpu_torch.ops import fused_chain
from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.ops import fused_int8 as f8
from simple_vae_rs_tpu_torch.parallel import mesh as pm
from simple_vae_rs_tpu_torch.parallel.mesh import all_reduce_sum

# The reference quantizes an UpBlock's transposed conv only from this many
# input channels up; below it the tail runs in float32 on the float weights
# even when int8 weights are attached. This defines which layers of the model
# are W8A8 (the canonical decoder's 128-channel ``dx_up3`` tail is not); it is
# no speed threshold of this port.
INT8_CONVT_MIN_CHANNELS = 192


def _uniform_(param: torch.Tensor, rng: np.random.Generator, bound: float) -> None:
    vals = rng.uniform(-bound, bound, tuple(param.shape)).astype(np.float32)
    with torch.no_grad():
        param.copy_(torch.from_numpy(vals))


class Routed(nn.Module):
    """A module whose convs run through the fused kernels, or through their
    plain versions when ``plain`` is set (:func:`use_plain_path`); a model
    whose ``chain`` is set (:func:`use_chain`) runs its eval-mode conv tails
    through the chain kernel (:func:`tail_chain`). ``dtype`` is the compute
    dtype of its convs (:func:`set_dtype`)."""

    plain = False
    chain = False
    dtype = torch.float32


class ConvWeights(nn.Module):
    """Kernel ``(k, k, C, O)`` and bias ``(O,)`` of a conv (flax ``kernel``/``bias``);
    ``int8_kernel`` names the W8A8 kernel that runs it when int8 weights are
    attached, which fixes how they are packed."""

    def __init__(self, k: int, in_features: int, features: int, fan: int,
                 int8_kernel: str, device=None) -> None:
        super().__init__()
        self.fan = fan
        self.int8_kernel = int8_kernel  # torch-default init: U(+-1/sqrt(fan)) for both
        self.kernel = nn.Parameter(torch.empty(k, k, in_features, features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        # the fused kernels' scale when the conv runs with its bias alone
        self.register_buffer("unit_scale", torch.ones(features, device=device),
                             persistent=False)
        # int8 weights (flax collection ``quant``): absent on a float32 conv
        self.register_buffer("kernel_q", None)
        self.register_buffer("kernel_s", None)
        # kernel_q packed for its int8 kernel: a cache, rebuilt by set_quant
        self.register_buffer("kernel_p", None, persistent=False)

    def reset_parameters(self, rng: np.random.Generator) -> None:
        bound = 1.0 / math.sqrt(self.fan)
        _uniform_(self.kernel, rng, bound)
        _uniform_(self.bias, rng, bound)

    def set_quant(self, kernel_q, kernel_s) -> None:
        """Attach int8 weights (``kernel_q`` shaped like ``kernel``,
        ``kernel_s`` ``(O,)``; tensors or arrays), or remove them with None."""
        if kernel_q is None or kernel_s is None:
            self.kernel_q = self.kernel_s = self.kernel_p = None
            return

        def own(leaf, dtype):  # np.array copies: the buffer must not alias an array
            t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))
            return t.to(device=self.kernel.device, dtype=dtype).contiguous()

        q, s = own(kernel_q, torch.int8), own(kernel_s, torch.float32)
        if q.shape != self.kernel.shape or tuple(s.shape) != (self.kernel.shape[-1],):
            raise ValueError(f"int8 weights {tuple(q.shape)} / {tuple(s.shape)} do not match "
                             f"a kernel of {tuple(self.kernel.shape)}")
        self.kernel_q, self.kernel_s = q, s
        self.kernel_p = f8.pack_kernel_q(q)


class Conv3x3(ConvWeights, Routed):
    """3x3/s1 SAME conv with bias, through the fused 3x3 kernel."""

    def __init__(self, in_features: int, features: int, device=None) -> None:
        super().__init__(3, in_features, features, in_features * 9, "int8_conv3x3_bn_relu",
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.kernel_q is not None and not self.training:
            return f8.int8_conv("int8_conv3x3_bn_relu", x.to(dt), self.kernel_q, self.kernel_s,
                                self.unit_scale, self.bias, False, self.plain,
                                packed=self.kernel_p)
        return fc.fused_conv("fused_conv3x3_bn_relu", x.to(dt), self.kernel.to(dt),
                             self.unit_scale, self.bias, False, self.plain)


class ShardedConv3x3(Conv3x3):
    """A :class:`Conv3x3` that holds this rank's block of the output
    channels (kernel ``(3, 3, C, O / shards)``, bias ``(O / shards,)``) of a
    head sharded over the mesh's ``model`` axis (``parallel/mesh.
    shard_model``): column-parallel, the output gathered. The input passes
    through ``copy_to_model`` (its gradient, a partial sum over this rank's
    channels, all-reduced over the model ``group``), the block runs through
    the same fused 3x3 kernel as any conv, and its output through
    ``gather_channels`` (the whole channels, in rank order; backward, this
    rank's slice). The gathered output and the reduced input gradient stay
    in the compute dtype. ``load_state_dict`` takes whole leaves (this
    rank's block is cut from them) or blocks. Int8 weights are refused: a
    sharded model trains, and serves whole (``parallel/mesh.unshard_model``)."""

    def __init__(self, conv: Conv3x3, group, index: int, shards: int) -> None:
        c, o = int(conv.kernel.shape[2]), int(conv.kernel.shape[3])
        if o % shards:
            raise ValueError(f"{o} output channels do not divide into {shards} shards")
        super().__init__(c, o // shards, device=conv.kernel.device)
        self.group, self.index, self.shards = group, int(index), int(shards)
        self.fan = conv.fan
        with torch.no_grad():
            self.kernel.copy_(self.block("kernel", conv.kernel))
            self.bias.copy_(self.block("bias", conv.bias))
        self.plain, self.chain, self.dtype = conv.plain, conv.chain, conv.dtype
        self.train(conv.training)

    @staticmethod
    def dim_of(leaf: str) -> Optional[int]:
        """The dim leaf ``leaf`` is sharded over (None: not a sharded leaf)."""
        return {"kernel": 3, "bias": 0}.get(leaf)

    def block(self, leaf: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole ``leaf`` (a view)."""
        d = self.dim_of(leaf)
        n = whole.shape[d] // self.shards
        return whole.narrow(d, self.index * n, n)

    def gather(self, block: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole leaf from the group's blocks along ``dim``."""
        return pm.gather_cat(block.detach(), self.group, self.shards, dim)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for leaf in ("kernel", "bias"):
            key = prefix + leaf
            mine = getattr(self, leaf)
            if key in state_dict and state_dict[key].shape != mine.shape:
                whole = list(mine.shape)
                whole[self.dim_of(leaf)] *= self.shards
                if tuple(state_dict[key].shape) == tuple(whole):
                    state_dict[key] = self.block(leaf, state_dict[key])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def set_quant(self, kernel_q, kernel_s) -> None:
        if kernel_q is not None or kernel_s is not None:
            raise ValueError("a head sharded over the model axis takes no int8 weights: "
                             "quantize the whole model (parallel.mesh.unshard_model)")
        super().set_quant(None, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = pm.copy_to_model(x.to(dt), self.group)
        y = fc.fused_conv("fused_conv3x3_bn_relu", x, self.kernel.to(dt), self.unit_scale,
                          self.bias, False, self.plain)
        return pm.gather_channels(y, self.group, self.index, self.shards)


class BatchNorm(nn.Module):
    """BatchNorm parameters (``scale``, ``bias``) and running statistics
    (``mean``, ``var``), eps 1e-5, as flax ``nn.BatchNorm(momentum=0.9)``
    configures it (JAX ``conv_blocks.batch_norm``).

    Called, it normalises with the batch statistics over (B, H, W): the
    biased ``var = max(0, E[x^2] - E[x]^2)``, the gradient flowing through
    both, and updates the running statistics in place to
    ``0.9 * old + 0.1 * batch`` with that same biased variance (not
    ``nn.BatchNorm2d``, whose running variance is unbiased). In eval it is
    folded into the conv before it (:meth:`fold`). While ``update_stats`` is
    False (:func:`frozen_statistics`) the running statistics stay as they are.
    With a process ``group`` (:func:`sync_batchnorm`) the batch is the
    global one: the sums over (B, H, W) of ``x`` and ``x^2`` and the count
    are all-reduced (``parallel/mesh.all_reduce_sum``, whose backward sums
    the gradients), and the running statistics move alike on every rank.
    """

    eps = 1e-5
    momentum = 0.9
    update_stats = True
    group = None

    def __init__(self, features: int, device=None) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("mean", torch.empty(features, device=device))
        self.register_buffer("var", torch.empty(features, device=device))

    def reset_parameters(self, rng: Optional[np.random.Generator] = None) -> None:
        del rng  # flax's BatchNorm init is deterministic
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Normalised ``x`` in ``x``'s dtype; statistics and arithmetic in
        float32 (a bfloat16 ``x`` is upcast, and the result rounded once)."""
        dims = (0, 1, 2)
        x32 = x.float()
        if self.group is None:
            mean = x32.mean(dim=dims)
            ex2 = (x32 * x32).mean(dim=dims)
        else:
            c = x32.shape[-1]
            count = x32.new_full((1,), float(x32.numel() // c))
            sums = all_reduce_sum(torch.cat([x32.sum(dim=dims), (x32 * x32).sum(dim=dims),
                                             count]), self.group)
            mean, ex2 = sums[:c] / sums[2 * c], sums[c:2 * c] / sums[2 * c]
        var = torch.clamp_min(ex2 - mean * mean, 0.0)
        if self.update_stats:
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        y = (x32 - mean) * (self.scale * torch.rsqrt(var + self.eps)) + self.bias
        return y.to(x.dtype)

    def fold(self, conv: ConvWeights):
        """``(kernel, scale, shift)`` of ``conv`` followed by this BatchNorm."""
        return fc.fold_conv_bn(conv.kernel, conv.bias, self.scale, self.bias,
                               self.mean, self.var, self.eps)


class _Block(Routed):
    """conv3x3 -> strided tail conv -> BN -> ReLU (each of the last two where
    ``with_bn`` / ``with_relu``); subclasses name the tail."""

    _kernel = ""  # fused_conv kernel of the tail
    _int8_kernel = ""  # fused_int8 kernel of the tail
    _int8_min_channels = 0  # the tail is W8A8 from this many input channels up
    _tail_name = ""  # flax name of the tail conv

    def _build(self, conv: "Conv3x3", tail: ConvWeights, features: int, with_relu: bool,
               with_bn: bool, device) -> None:
        self.with_relu, self.with_bn = bool(with_relu), bool(with_bn)
        self.conv = conv
        setattr(self, self._tail_name, tail)
        if self.with_bn:
            self.bn = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        tail = getattr(self, self._tail_name)
        dt = self.dtype
        if self.training:
            h = fc.fused_conv(self._kernel, x, tail.kernel.to(dt), tail.unit_scale, tail.bias,
                              False, self.plain)
            if self.with_bn:
                h = self.bn(h)
            return torch.relu(h) if self.with_relu else h
        if self.with_bn:
            kernel, s, t = self.bn.fold(tail)  # float32; only the kernel is cast
        else:
            kernel, s, t = tail.kernel, tail.unit_scale, tail.bias
        if tail.kernel_q is not None and x.shape[3] >= self._int8_min_channels:
            return f8.int8_conv(self._int8_kernel, x.to(dt), tail.kernel_q, tail.kernel_s, s, t,
                                self.with_relu, self.plain, packed=tail.kernel_p)
        return fc.fused_conv(self._kernel, x, kernel.to(dt), s, t, self.with_relu, self.plain)


class DownBlock(_Block):
    """conv3x3 -> strided conv4x4 (spatial /2) -> BN -> ReLU (reference
    ``models/layers.py:217-256``); in eval the tail is one fused 4x4/s2 kernel."""

    _kernel = "fused_conv4x4s2_bn_relu"
    _int8_kernel = "int8_conv4x4s2_bn_relu"
    _tail_name = "downsample"

    def __init__(self, in_features: int, features: int, device=None, with_relu: bool = True,
                 with_bn: bool = True) -> None:
        super().__init__()
        self._build(Conv3x3(in_features, in_features, device=device),
                    ConvWeights(4, in_features, features, in_features * 16, self._int8_kernel,
                                device=device), features, with_relu, with_bn, device)


class UpBlock(_Block):
    """conv3x3 -> convT4x4 (spatial *2) -> BN -> ReLU (reference
    ``models/layers.py:259-297``); in eval the tail is one fused convT kernel."""

    _kernel = "fused_convT4x4s2_bn_relu"
    _int8_kernel = "int8_convT4x4s2_bn_relu"
    _int8_min_channels = INT8_CONVT_MIN_CHANNELS
    _tail_name = "upsample"

    def __init__(self, in_features: int, features: int, device=None, with_relu: bool = True,
                 with_bn: bool = True) -> None:
        super().__init__()
        # torch's init fan for a transposed conv is out * kh * kw
        self._build(Conv3x3(in_features, in_features, device=device),
                    ConvWeights(4, in_features, features, features * 16, self._int8_kernel,
                                device=device), features, with_relu, with_bn, device)


def reset_parameters(model: nn.Module, rng: np.random.Generator) -> None:
    """Fill every conv and BatchNorm of ``model`` from ``rng``, in module order."""
    for mod in model.modules():
        if isinstance(mod, (ConvWeights, BatchNorm)):
            mod.reset_parameters(rng)


def use_plain_path(model: nn.Module, plain: bool = True) -> None:
    """Route every conv of ``model`` (forward and input gradient; float32
    and int8) and its ELBO reductions through the plain versions (``True``)
    or the kernels
    (``False``, the default)."""
    for mod in model.modules():
        if isinstance(mod, Routed):
            mod.plain = plain


def set_dtype(model: nn.Module, dtype: torch.dtype) -> None:
    """Set the compute dtype of every conv of ``model``: float32 (the
    default of a new model) or bfloat16. Parameters stay float32."""
    if dtype not in fc.DTYPES:
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    for mod in model.modules():
        if isinstance(mod, Routed):
            mod.dtype = dtype


@contextlib.contextmanager
def frozen_statistics(model: nn.Module) -> Iterator[None]:
    """Within the block, ``model``'s BatchNorms in training mode normalise
    with the batch statistics as always but leave their running statistics
    alone: a forward recomputed during the backward (``TrainConfig.remat``)
    must not update them a second time."""
    bns = [mod for mod in model.modules() if isinstance(mod, BatchNorm)]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = True


def sync_batchnorm(model: nn.Module, group=None) -> None:
    """Make every BatchNorm of ``model`` normalise over the global batch of
    the process ``group`` in training (None: each process's own batch)."""
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.group = group


def use_chain(model: nn.Module, chain: bool = True) -> None:
    """Switch ``model``'s eval-mode conv tails to the fused chain kernel
    (``True``) or back to one launch per conv (``False``, the default of a
    new model)."""
    for mod in model.modules():
        if isinstance(mod, Routed):
            mod.chain = chain


def has_int8(model: nn.Module) -> bool:
    """Whether any conv of ``model`` carries int8 weights (``ops/quantize.
    has_quant``, which this module cannot import: it imports this one)."""
    return any(isinstance(mod, ConvWeights) and mod.kernel_q is not None
               for mod in model.modules())


def tail_chain(owner: Routed, convs: Sequence[Conv3x3], h: torch.Tensor
               ) -> Optional[torch.Tensor]:
    """The linear tail ``convs`` (3x3/s1 + bias each, nothing between) of
    ``owner`` applied to ``h`` in one launch of the chain kernel (its plain
    version on the plain path) in ``owner``'s compute dtype, or ``None``
    when the caller is to run the convs one by one: when the chain is not
    switched on, in training mode and wherever a gradient is being recorded
    (the chain has no backward; the per-layer kernels have theirs), and when
    ``owner`` carries any int8 weight, in any of its convs (the JAX
    ``tail_chain`` steps aside on a model with a ``quant`` collection, so
    that W8A8 serving keeps its int8 kernels: the float tails of such a
    model run layer by layer, which in bfloat16 adds each bias in float32
    where the chain rounds it to bfloat16 first), and where a conv of the
    tail is a head sharded over the model axis (it runs with its
    collectives).

    In bfloat16 the kernels are cast to bfloat16 per call and the biases
    stay float32: the chain rounds them itself, as JAX ``fused_conv3x3_chain``
    casts them to ``x.dtype``."""
    if (not owner.chain or owner.training or has_int8(owner)
            or any(isinstance(conv, ShardedConv3x3) for conv in convs)):
        return None
    if torch.is_grad_enabled() and (h.requires_grad
                                    or any(conv.kernel.requires_grad for conv in convs)):
        return None
    dt = owner.dtype
    return fused_chain.fused_conv3x3_chain(h.to(dt), [conv.kernel.to(dt) for conv in convs],
                                           [conv.bias for conv in convs], plain=owner.plain)


def conv_tail(owner: Routed, convs: Sequence[Conv3x3], h: torch.Tensor) -> torch.Tensor:
    """``convs`` applied to ``h`` in order: one chain launch where
    :func:`tail_chain` takes it, else conv by conv."""
    chained = tail_chain(owner, convs, h)
    if chained is not None:
        return chained
    for conv in convs:
        h = conv(h)
    return h
