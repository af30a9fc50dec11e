"""Checkpoints of the reference's PyTorch code into the port and back (the
JAX package's ``utils/convert.py``, with its own copy of the key map).

A ``.pth`` ``state_dict`` saved by the reference's ``ModelCheckpoint``
(``callbacks.py:140-143``) becomes the flax-named variables tree
``{"params", "batch_stats"}`` of numpy arrays (``convert_*``), which
``utils/jax_weights.load_jax_variables`` copies into a port model
(:func:`load_reference_state_dict` does both); a port model goes back to a
strict-loadable reference ``state_dict`` (``export_*``,
:func:`model_variables`). Tensor rules:

- ``Conv2d.weight`` (out, in, kh, kw) -> kernel (kh, kw, in, out);
- ``ConvTranspose2d.weight`` (in, out, kh, kw) -> kernel (kh, kw, in, out),
  spatially flipped (the port's transposed conv is the input-dilated
  regular conv on the flipped kernel);
- ``BatchNorm2d``: weight -> scale, bias -> bias, running_mean/var ->
  ``batch_stats`` mean/var;
- the gammas are not in reference checkpoints (plain tensors there): 1.0.

A Cond_SRVAE converts exactly when built with
``CondSRVAEConfig(torch_regroup=True)``, the reference's C-major latent
regrouping; with the default pixel shuffle the prior heads see a permuted
latent (fine-tune after converting). The VAE converts exactly either way.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from simple_vae_rs_tpu_torch.utils.jax_weights import load_jax_variables

Tensors = Dict[str, np.ndarray]


def _conv(src: Tensors, torch_prefix: str, transpose: bool = False) -> Dict:
    w = np.asarray(src[f"{torch_prefix}.weight"])
    if transpose:
        kernel = w.transpose(2, 3, 0, 1)[::-1, ::-1]  # (in, out, kh, kw) -> flipped HWIO
    else:
        kernel = w.transpose(2, 3, 1, 0)  # (out, in, kh, kw) -> (kh, kw, in, out)
    out = {"kernel": np.ascontiguousarray(kernel, dtype=np.float32)}
    bias = src.get(f"{torch_prefix}.bias")
    if bias is not None:
        out["bias"] = np.asarray(bias, dtype=np.float32)
    return out


def _bn(src: Tensors, torch_prefix: str) -> Tuple[Dict, Dict]:
    params = {"scale": np.asarray(src[f"{torch_prefix}.weight"], np.float32),
              "bias": np.asarray(src[f"{torch_prefix}.bias"], np.float32)}
    stats = {"mean": np.asarray(src[f"{torch_prefix}.running_mean"], np.float32),
             "var": np.asarray(src[f"{torch_prefix}.running_var"], np.float32)}
    return params, stats


def _block(src: Tensors, torch_prefix: str, up: bool) -> Tuple[Dict, Dict]:
    """A reference down_block / up_block -> DownBlock / UpBlock params and
    batch_stats."""
    sub = "upsample" if up else "downsample"
    params = {"conv": _conv(src, f"{torch_prefix}.conv"),
              sub: _conv(src, f"{torch_prefix}.{sub}", transpose=up)}
    stats = {}
    if f"{torch_prefix}.bn.weight" in src:
        params["bn"], stats["bn"] = _bn(src, f"{torch_prefix}.bn")
    return params, stats


# the port's module name -> (reference Sequential entry, is a block, is an up block)
_VAE_ENCODER: List[Tuple[str, str, bool, bool]] = [
    ("enc_down1", "encoder.0", True, False),
    ("enc_down2", "encoder.1", True, False),
    ("enc_conv1", "encoder.2", False, False),
    ("enc_conv2", "encoder.3", False, False),
    ("enc_conv3", "encoder.4", False, False),
    ("enc_head", "encoder.5", False, False),
]
_VAE_DECODER: List[Tuple[str, str, bool, bool]] = [
    ("dec_up1", "decoder.1", True, True),
    ("dec_up2", "decoder.2", True, True),
    ("dec_conv1", "decoder.3", False, False),
    ("dec_conv2", "decoder.4", False, False),
    ("dec_conv3", "decoder.5", False, False),
    ("dec_conv4", "decoder.6", False, False),
]
_COND_MAP: List[Tuple[str, str, bool, bool]] = [
    # encoder_y (reference cond_vae.py:27-49)
    ("ey_down1", "encoder_y.0", True, False),
    ("ey_down2", "encoder_y.1", True, False),
    ("ey_conv1", "encoder_y.2", False, False),
    ("ey_conv2", "encoder_y.3", False, False),
    ("ey_conv3", "encoder_y.4", False, False),
    ("ey_head", "encoder_y.5", False, False),
    # decoder_y (51-81)
    ("dy_up1", "decoder_y.1", True, True),
    ("dy_up2", "decoder_y.2", True, True),
    ("dy_conv1", "decoder_y.3", False, False),
    ("dy_conv2", "decoder_y.4", False, False),
    ("dy_conv3", "decoder_y.5", False, False),
    ("dy_conv4", "decoder_y.6", False, False),
    # encoder_x (83-108)
    ("ex_down1", "encoder_x.0", True, False),
    ("ex_down2", "encoder_x.1", True, False),
    ("ex_down3", "encoder_x.2", True, False),
    ("ex_conv1", "encoder_x.3", False, False),
    ("ex_conv2", "encoder_x.4", False, False),
    ("ex_conv3", "encoder_x.5", False, False),
    ("ex_head", "encoder_x.6", False, False),
    # decoder_x (110-144)
    ("dx_up1", "decoder_x.1", True, True),
    ("dx_up2", "decoder_x.2", True, True),
    ("dx_up3", "decoder_x.3", True, True),
    ("dx_conv1", "decoder_x.4", False, False),
    ("dx_conv2", "decoder_x.5", False, False),
    ("dx_conv3", "decoder_x.6", False, False),
    ("dx_conv4", "decoder_x.7", False, False),
    # y_to_z (146-165)
    ("yz_down1", "y_to_z.0", True, False),
    ("yz_down2", "y_to_z.1", True, False),
    ("yz_down3", "y_to_z.2", True, False),
    ("yz_conv1", "y_to_z.3", False, False),
    ("yz_conv2", "y_to_z.4", False, False),
    # u_to_z (167-189)
    ("uz_conv1", "u_to_z.1", False, False),
    ("uz_conv2", "u_to_z.2", False, False),
    # prior heads (191-231)
    ("pz_mu_conv1", "mu_u_y_to_z.1", False, False),
    ("pz_mu_conv2", "mu_u_y_to_z.2", False, False),
    ("pz_lv_conv1", "logvar_u_y_to_z.1", False, False),
    ("pz_lv_conv2", "logvar_u_y_to_z.2", False, False),
]


def _convert(mapping, src: Tensors) -> Tuple[Dict, Dict]:
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for ours, theirs, is_block, is_up in mapping:
        if is_block:
            params[ours], s = _block(src, theirs, is_up)
            if s:
                stats[ours] = s
        else:
            params[ours] = _conv(src, theirs)
    return params, stats


def convert_vae_state_dict(src: Tensors) -> Dict[str, Any]:
    """Reference VAE ``state_dict`` -> {'params', 'batch_stats'}."""
    params, stats = _convert(_VAE_ENCODER + _VAE_DECODER, src)
    params["gamma"] = np.float32(src.get("gamma", 1.0))
    return {"params": params, "batch_stats": stats}


def convert_cond_state_dict(src: Tensors) -> Dict[str, Any]:
    """Reference Cond_SRVAE ``state_dict`` -> {'params', 'batch_stats'}."""
    params, stats = _convert(_COND_MAP, src)
    params["gammax"] = np.float32(src.get("gammax", 1.0))
    params["gammay"] = np.float32(src.get("gammay", 1.0))
    return {"params": params, "batch_stats": stats}


def load_reference_state_dict(model: nn.Module, src: Tensors) -> nn.Module:
    """A reference ``state_dict`` (numpy arrays or tensors) into a port
    ``VAE`` or ``CondSRVAE``, in place."""
    from simple_vae_rs_tpu_torch.models.vae import VAE

    src = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in src.items()}
    convert = convert_vae_state_dict if isinstance(model, VAE) else convert_cond_state_dict
    return load_jax_variables(model, convert(src))


def model_variables(model: nn.Module) -> Dict[str, Any]:
    """A port model's parameters and BatchNorm statistics as the flax-named
    tree ``{"params", "batch_stats"}`` of numpy arrays (the inverse of
    ``load_jax_variables``)."""
    from simple_vae_rs_tpu_torch.ops.conv_blocks import BatchNorm

    stats_names = {f"{name}.{leaf}" for name, mod in model.named_modules()
                   if isinstance(mod, BatchNorm) for leaf in ("mean", "var")}
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        if name.rsplit(".", 1)[-1] in ("kernel_q", "kernel_s"):
            continue
        node = tree["batch_stats" if name in stats_names else "params"]
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return tree


# ------------------------------------------------------------------ export
# Exact inverses of the rules above; the gammas are left out unless asked
# for, because the reference's state_dict loads strictly without them.
def _conv_export(params: Dict, torch_prefix: str, transpose: bool = False) -> Tensors:
    k = np.asarray(params["kernel"], np.float32)
    if transpose:
        w = np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1))
    else:
        w = np.ascontiguousarray(k.transpose(3, 2, 0, 1))
    out = {f"{torch_prefix}.weight": w}
    if "bias" in params:
        out[f"{torch_prefix}.bias"] = np.asarray(params["bias"], np.float32)
    return out


def _bn_export(params: Dict, stats: Dict, torch_prefix: str) -> Tensors:
    return {
        f"{torch_prefix}.weight": np.asarray(params["scale"], np.float32),
        f"{torch_prefix}.bias": np.asarray(params["bias"], np.float32),
        f"{torch_prefix}.running_mean": np.asarray(stats["mean"], np.float32),
        f"{torch_prefix}.running_var": np.asarray(stats["var"], np.float32),
        # BatchNorm2d carries this buffer and a strict load needs the key
        f"{torch_prefix}.num_batches_tracked": np.asarray(0, np.int64),
    }


def _export(mapping, params: Dict, stats: Dict) -> Tensors:
    sd: Tensors = {}
    for ours, theirs, is_block, is_up in mapping:
        mod = params[ours]
        if is_block:
            sub = "upsample" if is_up else "downsample"
            sd.update(_conv_export(mod["conv"], f"{theirs}.conv"))
            sd.update(_conv_export(mod[sub], f"{theirs}.{sub}", transpose=is_up))
            if "bn" in mod:
                sd.update(_bn_export(mod["bn"], stats[ours]["bn"], f"{theirs}.bn"))
        else:
            sd.update(_conv_export(mod, theirs))
    return sd


def export_vae_state_dict(tree: Dict[str, Any], include_gammas: bool = False) -> Tensors:
    """{'params', 'batch_stats'} -> reference VAE ``state_dict``;
    ``include_gammas`` adds ``gamma`` (then the reference loads it with
    ``strict=False``)."""
    params = tree["params"]
    sd = _export(_VAE_ENCODER + _VAE_DECODER, params, tree.get("batch_stats", {}))
    if include_gammas:
        sd["gamma"] = np.asarray(params["gamma"], np.float32)
    return sd


def export_cond_state_dict(tree: Dict[str, Any], include_gammas: bool = False) -> Tensors:
    """{'params', 'batch_stats'} -> reference Cond_SRVAE ``state_dict``
    (exact for ``torch_regroup=True``); ``include_gammas`` adds ``gammax`` and
    ``gammay``."""
    params = tree["params"]
    sd = _export(_COND_MAP, params, tree.get("batch_stats", {}))
    if include_gammas:
        sd["gammax"] = np.asarray(params["gammax"], np.float32)
        sd["gammay"] = np.asarray(params["gammay"], np.float32)
    return sd


def save_torch_state_dict(path: str, sd: Tensors) -> None:
    """An exported ``state_dict`` as a ``.pth`` of plain tensors (loadable with
    ``torch.load(weights_only=True)``)."""
    torch.save({k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}, path)


def load_torch_state_dict(path: str, allow_pickle: bool = False) -> Tensors:
    """A ``.pth`` ``state_dict`` as numpy arrays.

    Read with ``torch.load(weights_only=True)`` first: plain tensor
    ``state_dict`` files, the reference's format. A file that pickles numpy
    arrays or other non-tensor leaves needs the legacy unpickler, which runs
    arbitrary pickle bytecode: only with ``allow_pickle=True`` (command line:
    ``--allow_pickle``), never as a silent fallback, and with a warning.
    Without it such a file raises a ``ValueError`` that says so."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as exc:  # torch raises an UnpicklingError subclass, or others
        if not allow_pickle:
            raise ValueError(
                f"{path}: not loadable with weights_only=True (non-tensor pickle content). "
                "Loading it needs the legacy unpickler, which can execute arbitrary code: "
                "pass allow_pickle=True (command line: --allow_pickle) only for checkpoints "
                "you trust.") from exc
        import warnings

        warnings.warn(f"{path}: not loadable with weights_only=True (non-tensor pickle "
                      "content); falling back to the legacy unpickler: only convert "
                      "checkpoints you trust.", stacklevel=2)
        sd = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in sd.items()}
