"""Weight bridge: the JAX package's flax variables -> a port model, in place.

The flax tree arrives as nested dicts of numpy arrays (what ``jax.device_get``
returns): ``{"params": {...}, "batch_stats": {...}}`` and, for a W8A8 model,
``"quant": {...}`` (``ops/quantize.quantize_params_tree``). The port keeps the JAX
layouts (NHWC activations, HWIO conv kernels, the input-dilated transposed
conv kernel) and the flax names, so a leaf at path ``a/b/c`` of either
collection is the port's parameter or buffer ``a.b.c``, with the same shape;
a ``quant`` node ``a/b/{kernel_q, kernel_s}`` is the int8 weight of the conv
module ``a.b``. This is the one place where a layout change would go. The
layer API's modules carry the flax names too (``ops/sequences``: ``down{i}``,
``attn{i}`` with ``query``/``key``/``value``/``out``, ``up{i}``, ``proj``), so
they load the same way. Into a model whose heads are sharded over the
mesh's ``model`` axis (``parallel/mesh.shard_model``) the tree loads whole
and each sharded leaf takes this rank's block (``parallel/mesh.shard_params``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from simple_vae_rs_tpu_torch.ops.quantize import attach_quant
from simple_vae_rs_tpu_torch.parallel.mesh import shard_params, whole_shapes

COLLECTIONS = ("params", "batch_stats")
QUANT = "quant"
_QUANT_LEAVES = ("kernel_q", "kernel_s")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = np.asarray(val)
    return out


def load_jax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Copy a flax variables tree into ``model``; every leaf must match a
    parameter or persistent buffer of the same name and shape, and every
    parameter and persistent buffer must be given. The convs named in a
    ``quant`` collection get its int8 weights and every other conv loses any
    it had, so the model is W8A8 exactly where the JAX model is. Raises
    ``KeyError`` on a missing or extra leaf and ``ValueError`` on a shape
    mismatch."""
    extra_cols = set(variables) - set(COLLECTIONS) - {QUANT}
    if extra_cols:
        raise KeyError(f"unexpected variable collections: {sorted(extra_cols)}")
    leaves: Dict[str, np.ndarray] = {}
    for col in COLLECTIONS:
        for name, arr in _flatten(variables.get(col, {})).items():
            if name in leaves:
                raise KeyError(f"leaf {name!r} appears in more than one collection")
            leaves[name] = arr
    attach_quant(model, variables.get(QUANT, {}))
    targets = {name: t for name, t in model.state_dict(keep_vars=True).items()
               if name.rsplit(".", 1)[-1] not in _QUANT_LEAVES}
    missing = sorted(set(targets) - set(leaves))
    extra = sorted(set(leaves) - set(targets))
    if missing or extra:
        raise KeyError(f"weight trees differ: missing {missing}, extra {extra}")
    # a head sharded over the mesh's model axis: the tree is whole, checked
    # whole, and this rank's block copied in
    whole = {name: tuple(t.shape) for name, t in targets.items()}
    whole.update(whole_shapes(model))
    for name, dst in targets.items():
        src = leaves[name]
        if tuple(src.shape) != whole[name]:
            raise ValueError(
                f"{name}: shape {tuple(src.shape)} does not match {whole[name]}"
            )
        src = torch.from_numpy(np.array(src, dtype=np.float32))
        with torch.no_grad():
            dst.copy_(shard_params(model, {name: src})[name])
    return model
