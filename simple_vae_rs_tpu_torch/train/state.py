"""The training step's optimizer (port of the JAX package's ``train/state.py``
``make_optimizer``): a global-norm clip, then Adam.

It is ``optax.chain(clip_by_global_norm(max_norm), scale_by_adam(b1, b2,
eps))`` over a list of tensors, written with PyTorch's multi-tensor
(``_foreach``) ops: ``update`` returns the transformed updates ``u`` and the
caller applies ``p <- p - lr * u``, so the learning rate can change per call
without touching the optimizer state (as the JAX engine does for its plateau
scheduler). The clip and the step stay on the device: no host sync.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from simple_vae_rs_tpu_torch.config import TrainConfig
from simple_vae_rs_tpu_torch.parallel import mesh as pm

Tensor = torch.Tensor


class ClipAdam:
    """Global-norm clip to ``max_norm``, then Adam (optax ``scale_by_adam``
    with ``eps_root=0``). The second moment is float32; the first is float32
    or, with ``mu_dtype=torch.bfloat16`` (``TrainConfig.bf16_moments``),
    stored in bfloat16 in optax's order: the new moment is computed in
    float32 from the stored one (whose decay term ``b1 * mu`` JAX rounds to
    bfloat16, with ``b1`` itself in bfloat16) and the float32 gradient, the
    update uses it, and only then is it rounded to bfloat16 and stored.

    ZeRO-1 (:meth:`shard`, from ``parallel/mesh.shard_state``): each rank of
    a process mesh keeps only its block of every large moment along the dim
    the mesh picks; :meth:`step` clips the whole (already reduced) gradient
    as ever, advances this rank's blocks of the moments, updates that block
    of the parameter and all-gathers the blocks (over the batch shards: the
    mesh's data group). :meth:`state_dict` gathers, so a ZeRO-1 checkpoint
    is the replicated one, and :meth:`load_state_dict` takes this rank's
    blocks of a whole one.

    The ``model`` axis (:meth:`over_model`, from ``Trainer.make_optimizer``):
    the leaves of a head sharded over it are this rank's
    blocks, so are their moments; the clip's global norm sums their squares
    over the model group once and counts every other leaf once (optax's
    norm of the whole tree), and :meth:`state_dict` / :meth:`load_state_dict`
    gather and cut their moments as ZeRO-1's."""

    def __init__(self, params: Sequence[Tensor], max_norm: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: torch.dtype = torch.float32) -> None:
        if mu_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"mu_dtype must be float32 or bfloat16, got {mu_dtype}")
        self.max_norm, self.b1, self.b2, self.eps = max_norm, b1, b2, eps
        self.mu_dtype = mu_dtype
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.count = 0
        self.mesh: Optional[pm.Mesh] = None
        self.dims: List[Optional[int]] = [None] * len(self.mu)  # ZeRO-1 dim per leaf
        self.model_mesh: Optional[pm.Mesh] = None
        self.model_dims: List[Optional[int]] = [None] * len(self.mu)  # model-axis dim per leaf

    def _block(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's block of leaf ``i``'s whole tensor ``t`` (a view)."""
        d = self.dims[i]
        if d is None:
            return t
        n = t.shape[d] // self.mesh.n_shards
        return t.narrow(d, self.mesh.shard * n, n)

    def _model_block(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's model-axis block of leaf ``i``'s whole tensor ``t``."""
        d = self.model_dims[i]
        if d is None:
            return t
        n = t.shape[d] // self.model_mesh.model
        return t.narrow(d, self.model_mesh.model_index * n, n)

    def over_model(self, mesh: pm.Mesh, dims: Sequence[Optional[int]]) -> None:
        """The ``model`` axis of the process ``mesh``: leaf ``i`` is this
        rank's block along ``dims[i]`` (None: whole on every rank). Call it
        before :meth:`shard`."""
        if len(dims) != len(self.mu):
            raise ValueError(f"{len(dims)} dims for {len(self.mu)} moments")
        self.model_mesh, self.model_dims = mesh, list(dims)

    def shard(self, mesh: pm.Mesh, dims: Sequence[Optional[int]]) -> None:
        """ZeRO-1 over the process mesh ``mesh``: leaf ``i``'s moments keep
        only this rank's block along ``dims[i]`` (None: whole)."""
        if len(dims) != len(self.mu):
            raise ValueError(f"{len(dims)} dims for {len(self.mu)} moments")
        if self.mesh is not None:
            raise ValueError("the moments are sharded already")
        self.mesh, self.dims = mesh, list(dims)
        self.mu = [self._block(m, i).clone() for i, m in enumerate(self.mu)]
        self.nu = [self._block(v, i).clone() for i, v in enumerate(self.nu)]

    def global_norm(self, grads: Sequence[Tensor]) -> Tensor:
        """``sqrt(sum_leaves sum(g^2))`` of the whole tree as a 0-dim tensor
        on the grads' device: over the model axis the sharded leaves' squares
        are summed over the model group, every other leaf counted once."""
        norms = torch.stack(torch._foreach_norm(list(grads)))
        if self.model_mesh is None:
            return torch.linalg.vector_norm(norms)
        sq = norms.square()
        mask = torch.tensor([d is not None for d in self.model_dims], device=sq.device)
        sharded = sq[mask].sum().reshape(1)
        torch.distributed.all_reduce(sharded, group=self.model_mesh.model_group)
        return torch.sqrt(sq[~mask].sum() + sharded[0])

    def clip(self, grads: Sequence[Tensor]) -> List[Tensor]:
        """optax ``clip_by_global_norm``: ``g * max_norm / |g|`` when
        ``|g| >= max_norm``, else ``g`` (no ``+1e-6`` in the denominator, unlike
        ``torch.nn.utils.clip_grad_norm_``)."""
        norm = self.global_norm(grads)
        factor = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
        return torch._foreach_mul(list(grads), factor)

    def _bias_correction(self, decay: float) -> float:
        # optax computes 1 - decay**count in float32
        return float(np.float32(1.0) - np.float32(decay) ** np.float32(self.count))

    @torch.no_grad()
    def step(self, params: Sequence[Tensor], grads: Sequence[Tensor], lr: float) -> None:
        """``p <- p - lr * update(grads)`` in place; under ZeRO-1 on this
        rank's block of each sharded leaf, then all-gathered."""
        params = list(params)
        if self.mesh is None:
            torch._foreach_add_(params, self.update(grads), alpha=-float(lr))
            return
        # contiguous blocks: the multi-tensor kernels then take every leaf as
        # they take the replicated layout's, so ZeRO-1 gives the same bits
        blocks = [self._block(p, i).contiguous() for i, p in enumerate(params)]
        torch._foreach_add_(blocks, self.update(grads), alpha=-float(lr))
        for i, (p, d) in enumerate(zip(params, self.dims)):
            if d is not None:
                p.copy_(pm.gather_shards(self.mesh, blocks[i], d))

    @torch.no_grad()
    def update(self, grads: Sequence[Tensor]) -> List[Tensor]:
        """Clip, advance the moments, and return ``m_hat / (sqrt(v_hat) + eps)``
        (under ZeRO-1, for this rank's block of each sharded leaf)."""
        g = self.clip(grads)
        if self.mesh is not None:
            g = [self._block(t, i).contiguous() for i, t in enumerate(g)]
        if self.mu_dtype == torch.float32:
            mu = self.mu
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        else:
            # optax: (1 - b1) * g + b1 * mu, where b1 * mu is bfloat16 math;
            # multi-tensor ops throughout (a loop over the leaves costs a
            # launch per leaf and operation)
            b1 = torch.tensor(self.b1, dtype=self.mu_dtype, device=g[0].device)
            decayed = [torch.empty_like(m, dtype=torch.float32) for m in self.mu]
            torch._foreach_copy_(decayed, torch._foreach_mul(self.mu, b1))
            mu = torch._foreach_mul(g, 1.0 - self.b1)
            torch._foreach_add_(mu, decayed)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - self.b2)
        self.count += 1
        denom = torch._foreach_div(self.nu, self._bias_correction(self.b2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, self._bias_correction(self.b1))
        torch._foreach_div_(updates, denom)
        if self.mu_dtype != torch.float32:
            torch._foreach_copy_(self.mu, mu)  # rounded to bfloat16, to nearest even
        return updates

    def state_dict(self) -> dict:
        """The moments (``mu`` in its ``mu_dtype``), as lists in parameter
        order, and the step count. Under ZeRO-1 and over the model axis
        every rank gathers the whole moments (a collective: every rank calls
        it)."""
        if self.mesh is None and self.model_mesh is None:
            return {"mu": list(self.mu), "nu": list(self.nu), "count": self.count}

        def whole(ts):
            out = []
            for t, d, md in zip(ts, self.dims, self.model_dims):
                if d is not None:
                    t = pm.gather_shards(self.mesh, t, d)
                if md is not None:
                    t = pm.gather_model(self.model_mesh, t, md)
                out.append(t)
            return out

        return {"mu": whole(self.mu), "nu": whole(self.nu), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` in, from any device onto this optimizer's.
        Raises ``ValueError`` when the moments' number, shapes or dtypes
        differ (a bfloat16 first moment does not load into a float32 one, nor
        back). The moments given are whole: under ZeRO-1 and over the model
        axis this rank takes its blocks."""
        for key, mine in (("mu", self.mu), ("nu", self.nu)):
            theirs = state[key]
            if len(theirs) != len(mine):
                raise ValueError(f"{key}: {len(theirs)} moments for {len(mine)} parameters")
            theirs = [self._model_block(t, i) for i, t in enumerate(theirs)]
            theirs = [t if self.mesh is None else self._block(t, i)
                      for i, t in enumerate(theirs)]
            for i, (m, t) in enumerate(zip(mine, theirs)):
                if t.shape != m.shape or t.dtype != m.dtype:
                    raise ValueError(f"{key}[{i}]: {tuple(t.shape)} {t.dtype} does not match "
                                     f"{tuple(m.shape)} {m.dtype}")
            for m, t in zip(mine, theirs):
                m.copy_(t)
        self.count = int(state["count"])


def make_optimizer(cfg: TrainConfig, params: Sequence[Tensor]) -> ClipAdam:
    """Global-norm clip ``cfg.grad_clip_norm`` -> Adam (b1 0.9, b2 0.999,
    eps 1e-8; the first moment in bfloat16 with ``cfg.bf16_moments``), as
    the JAX package's ``make_optimizer``."""
    return ClipAdam(params, max_norm=cfg.grad_clip_norm,
                    mu_dtype=torch.bfloat16 if cfg.bf16_moments else torch.float32)
