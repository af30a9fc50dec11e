"""Convert checkpoints between the reference's PyTorch format and the port's
(the counterpart of the JAX package's ``scripts/convert_checkpoint.py``,
with its flags).

Import (a reference ``.pth`` ``state_dict`` -> a port checkpoint)::

    python -m simple_vae_rs_tpu_torch.convert_checkpoint ckpt.pth out_ckpt \\
        --model_type Cond_SRVAE -cr 1.2 --patch_size 64

Export (a port checkpoint -> a ``.pth`` the reference loads strictly)::

    python -m simple_vae_rs_tpu_torch.convert_checkpoint ckpt/best out.pth --to_torch \\
        --model_type Cond_SRVAE -cr 1.2 --patch_size 64

Import writes ``out_ckpt.pt`` + ``out_ckpt.meta.json`` (``train/checkpoint``):
the converted weights, checked leaf by leaf against the shapes of a freshly
built model, a fresh ``ClipAdam`` state, ``epoch`` 0 and the model config in
the meta under the JAX script's keys, so ``SuperResolver.from_checkpoint``
and ``cli --model_ckpt`` take it as it is. Export reads a port checkpoint
and writes plain tensors; with ``--keep_gammas`` the trained gamma scalars
too (lossless here; the reference then needs ``load_state_dict(strict=False)``). Both directions are exact for both
model types: a Cond_SRVAE is built with ``torch_regroup=True``, the
reference's C-major latent wiring (``utils/convert.py``). Conversion runs on
the host; it touches no card.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence


def _build(model_type: str, cr: float, patch_size: int, latent_size: int):
    """A port model of the flags' config on the CPU, its weights unset."""
    from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, VAEConfig
    from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
    from simple_vae_rs_tpu_torch.models.vae import VAE

    if model_type == "VAE":
        return VAE(VAEConfig(cr=cr, patch_size=patch_size, latent_size_override=latent_size))
    return CondSRVAE(CondSRVAEConfig(cr=cr, patch_size=patch_size, torch_regroup=True,
                                     latent_size_override=latent_size))


def _shapes(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}


def import_reference(src: str, dst: str, model_type: str, cr: float, patch_size: int,
                     latent_size: int = 0, allow_pickle: bool = False) -> None:
    """The reference ``.pth`` at ``src`` as a port checkpoint at ``dst``."""
    from simple_vae_rs_tpu_torch.config import TrainConfig
    from simple_vae_rs_tpu_torch.train.checkpoint import save_checkpoint
    from simple_vae_rs_tpu_torch.train.engine import Trainer
    from simple_vae_rs_tpu_torch.utils import convert as cv
    from simple_vae_rs_tpu_torch.utils.jax_weights import load_jax_variables

    sd = cv.load_torch_state_dict(src, allow_pickle=allow_pickle)
    model = _build(model_type, cr, patch_size, latent_size)
    convert = cv.convert_vae_state_dict if model_type == "VAE" else cv.convert_cond_state_dict
    converted = convert(sd)
    # the converted tree must have the model's structure exactly
    if _shapes(converted["params"]) != _shapes(cv.model_variables(model)["params"]):
        raise SystemExit("converted tree does not match the model structure")
    load_jax_variables(model, converted)
    trainer = Trainer(model, TrainConfig(), device="cpu")
    save_checkpoint(dst, trainer, epoch=0, extra={"model": trainer._model_meta()})


def export_reference(src: str, dst: str, model_type: str, cr: float, patch_size: int,
                     latent_size: int = 0, keep_gammas: bool = False) -> int:
    """The port checkpoint at ``src`` as a reference ``.pth`` at ``dst``;
    returns the number of tensors written."""
    from simple_vae_rs_tpu_torch.train.checkpoint import load_state
    from simple_vae_rs_tpu_torch.utils import convert as cv

    model = _build(model_type, cr, patch_size, latent_size)
    model.load_state_dict(load_state(src)["model"])
    export = cv.export_vae_state_dict if model_type == "VAE" else cv.export_cond_state_dict
    sd = export(cv.model_variables(model), keep_gammas)
    cv.save_torch_state_dict(dst, sd)
    return len(sd)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m simple_vae_rs_tpu_torch.convert_checkpoint")
    ap.add_argument("src", help="reference .pth state_dict")
    ap.add_argument("dst", help="output checkpoint path (no extension)")
    ap.add_argument("--model_type", default="Cond_SRVAE", choices=["Cond_SRVAE", "VAE"])
    ap.add_argument("-cr", "--compression_ratio", type=float, required=True)
    ap.add_argument("--patch_size", type=int, required=True)
    ap.add_argument("--latent_size", type=int, default=0,
                    help="Fixed latent budget override; must match the --latent_size the "
                    "checkpoint was trained with (0 = the cr-derived default).")
    ap.add_argument("--allow_pickle", action="store_true",
                    help="Permit the legacy torch unpickler for checkpoints with non-tensor "
                    "pickle content (executes pickle bytecode; trusted files only).")
    ap.add_argument("--to_torch", action="store_true",
                    help="Reverse direction: src is a checkpoint of the port (path without "
                    ".pt), dst a .pth state_dict the reference loads strictly.")
    ap.add_argument("--keep_gammas", action="store_true",
                    help="With --to_torch: also store the trained gamma scalars (lossless "
                    "re-import here; the reference then needs load_state_dict(strict=False)).")
    args = ap.parse_args(argv)
    flags = dict(model_type=args.model_type, cr=args.compression_ratio,
                 patch_size=args.patch_size, latent_size=args.latent_size)
    if args.to_torch:
        n = export_reference(args.src, args.dst, keep_gammas=args.keep_gammas, **flags)
        print(f"exported {args.src} -> {args.dst} ({n} tensors)")
    else:
        import_reference(args.src, args.dst, allow_pickle=args.allow_pickle, **flags)
        print(f"converted {args.src} -> {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
