"""Fused ELBO row reductions: a CUDA kernel, its plain versions, the loss assembly.

The port of ``simple_vae_rs_tpu/ops/pallas_elbo.py``. Each row reduction
reads 2 or 4 float32 ``(B, D)`` inputs and writes one float32 sum per row:

- :func:`sq_rows`: ``sum_d (a - b)^2``;
- :func:`kl_std_rows`: ``sum_d mu^2 + e^lv - 1 - lv``;
- :func:`kl_gen_rows`: ``sum_d (lv3 - lv2 - 1) + e^(lv2 - lv3) + (mu2 - mu3)^2 e^(-lv3)``.

Each is a ``torch.autograd.Function``. Its forward, given CPU tensors,
computes the plain version (``*_rows_plain``); given CUDA tensors it
launches the hand-written kernel in ``csrc/elbo_rows.cu`` on the current
stream or raises. ``plain=True`` takes the plain version on any device (the
reference the kernel is held against on the card). The backward is the
analytic elementwise gradient in plain PyTorch, as in the JAX package, whose
backward is jnp and not Pallas. :data:`launches` counts kernel launches.

:func:`fused_cond_loss` and :func:`fused_base_loss` assemble the loss terms
from the row sums; they equal ``ops/losses.cond_loss``/``base_loss``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

Tensor = torch.Tensor

SOURCE = "elbo_rows.cu"
MODES = {"sq_rows": (0, 2), "kl_std_rows": (1, 2), "kl_gen_rows": (2, 4)}  # mode, inputs

# Launches of each kernel since the last reset_launches(); the launcher adds
# one where it launches the kernel and nowhere else.
launches: Dict[str, int] = {name: 0 for name in MODES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_THREADS = 256
_SMS = 132  # H100 SXM streaming multiprocessors
_MIN_BLOCKS = 2 * _SMS  # fewer rows than this: split the columns
_TARGET_BLOCKS = 4 * _SMS


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(b: int, d: int) -> Tuple[int, int]:
    """``(chunk, parts)`` for ``b, d >= 1``: columns per block (a multiple
    of 4, so every part starts 16-byte aligned) and blocks per row. A row is
    one block when the batch alone gives ``_MIN_BLOCKS``; otherwise its
    columns split into parts of at least one float4 per thread, so the grid
    reaches about ``_TARGET_BLOCKS``."""
    parts = 1
    if b < _MIN_BLOCKS:
        parts = max(1, min(_cdiv(_TARGET_BLOCKS, b), _cdiv(d, 4 * _THREADS)))
    chunk = _cdiv(_cdiv(d, parts), 4) * 4
    return chunk, _cdiv(d, chunk)


# ------------------------------------------------------------ plain versions
def sq_rows_plain(a: Tensor, b: Tensor) -> Tensor:
    """Plain version of :func:`sq_rows` (JAX ``_sq_rows_impl``)."""
    return torch.sum((a.float() - b.float()) ** 2, dim=1)


def kl_std_rows_plain(mu: Tensor, logvar: Tensor) -> Tensor:
    """Plain version of :func:`kl_std_rows` (JAX ``_kl_std_rows_impl``)."""
    mu, logvar = mu.float(), logvar.float()
    return torch.sum(mu**2 + torch.exp(logvar) - 1.0 - logvar, dim=1)


def kl_gen_rows_plain(mu2: Tensor, lv2: Tensor, mu3: Tensor, lv3: Tensor) -> Tensor:
    """Plain version of :func:`kl_gen_rows` (JAX ``_kl_gen_rows_impl``)."""
    mu2, lv2, mu3, lv3 = (t.float() for t in (mu2, lv2, mu3, lv3))
    return torch.sum((lv3 - lv2 - 1.0) + torch.exp(lv2 - lv3)
                     + (mu2 - mu3) ** 2 * torch.exp(-lv3), dim=1)


PLAIN = {"sq_rows": sq_rows_plain, "kl_std_rows": kl_std_rows_plain,
         "kl_gen_rows": kl_gen_rows_plain}


# ------------------------------------------------------------------ launcher
_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from simple_vae_rs_tpu_torch.ops import _build

        lib = _build.load(SOURCE)
        fn = lib.svrs_elbo_rows
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(name: str, rows: Tuple[Tensor, ...]) -> Tensor:
    mode, n_in = MODES[name]
    if len(rows) != n_in:
        raise ValueError(f"{name}: takes {n_in} inputs, got {len(rows)}")
    dev = rows[0].device
    shape = tuple(rows[0].shape)
    for t in rows:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, one is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {t.dtype}")
        if t.dim() != 2 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: inputs must be one (B, D) shape, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    b, d = shape
    if b * d >= 2**31:
        raise ValueError(f"{name}: tensor too large for 32-bit column indices")
    out = torch.empty((b,), device=dev, dtype=torch.float32)
    if b == 0 or d == 0:
        return out.zero_()
    chunk, parts = plan(b, d)
    vec = int(d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in rows))
    ws = torch.empty((b * parts,), device=dev, dtype=torch.float32) if parts > 1 else None
    ptrs = [t.data_ptr() for t in rows] + [None] * (4 - n_in)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().svrs_elbo_rows(mode, *ptrs, out.data_ptr(),
                                        ws.data_ptr() if ws is not None else None,
                                        b, d, chunk, parts, vec, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    launches[name] += 1
    return out


def _forward(name: str, rows: Tuple[Tensor, ...], plain: bool) -> Tensor:
    dev = rows[0].device.type
    if plain or dev == "cpu":
        return PLAIN[name](*rows)
    if dev != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA card, not {dev}")
    return _launch(name, rows)


# ------------------------------------------------------ autograd Functions
class _SqRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, plain):
        ctx.save_for_backward(a, b)
        return _forward("sq_rows", (a, b), plain)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (2.0 * g[:, None]) * (a - b)
        return ga, -ga, None


class _KlStdRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, lv, plain):
        ctx.save_for_backward(mu, lv)
        return _forward("kl_std_rows", (mu, lv), plain)

    @staticmethod
    def backward(ctx, g):
        mu, lv = ctx.saved_tensors
        g = g[:, None]
        return 2.0 * g * mu, g * (torch.exp(lv) - 1.0), None


class _KlGenRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu2, lv2, mu3, lv3, plain):
        ctx.save_for_backward(mu2, lv2, mu3, lv3)
        return _forward("kl_gen_rows", (mu2, lv2, mu3, lv3), plain)

    @staticmethod
    def backward(ctx, g):
        mu2, lv2, mu3, lv3 = ctx.saved_tensors
        g = g[:, None]
        e_dlv = torch.exp(lv2 - lv3)
        e_nlv3 = torch.exp(-lv3)
        dm = mu2 - mu3
        dmu2 = g * 2.0 * dm * e_nlv3
        dlv2 = g * (e_dlv - 1.0)
        dlv3 = g * (1.0 - e_dlv - dm * dm * e_nlv3)
        return dmu2, dlv2, -dmu2, dlv3, None


def sq_rows(a: Tensor, b: Tensor, plain: bool = False) -> Tensor:
    """(B, D) x2 -> (B,) row sums of (a - b)^2."""
    return _SqRows.apply(a, b, plain)


def kl_std_rows(mu: Tensor, logvar: Tensor, plain: bool = False) -> Tensor:
    """(B, D) x2 -> (B,) row sums of mu^2 + e^lv - 1 - lv."""
    return _KlStdRows.apply(mu, logvar, plain)


def kl_gen_rows(mu2: Tensor, lv2: Tensor, mu3: Tensor, lv3: Tensor,
                plain: bool = False) -> Tensor:
    """(B, D) x4 -> (B,) row sums of the general-Gaussian KL terms."""
    return _KlGenRows.apply(mu2, lv2, mu3, lv3, plain)


# ------------------------------------------------------------------ assembly
def _flat(t: Tensor) -> Tensor:
    return t.reshape(t.shape[0], -1)


def fused_base_loss(recon_x: Tensor, x: Tensor, mu: Tensor, logvar: Tensor,
                    gamma: Tensor, plain: bool = False) -> Tuple[Tensor, Tensor]:
    """Plain-VAE ``(mse, kld)``, equal to ``ops.losses.base_loss``:
    ``mse = sum_sq / (2 g^2) + d log g``."""
    gamma = gamma.float()
    d = recon_x.numel()
    sum_sq = torch.sum(sq_rows(_flat(recon_x), _flat(x), plain))
    mse = sum_sq / (2.0 * gamma**2) + d * torch.log(gamma)
    kld = 0.5 * torch.mean(kl_std_rows(mu, logvar, plain))
    return mse, kld


def fused_cond_loss(recon_x: Tensor, x: Tensor, recon_y: Tensor, y: Tensor,
                    mu_u: Tensor, logvar_u: Tensor, mu_z: Tensor, logvar_z: Tensor,
                    mu_z_uy: Tensor, logvar_z_uy: Tensor, gammax: Tensor,
                    gammay: Tensor, plain: bool = False
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Cond_SRVAE ``(mse_x, kld_u, mse_y, kld_z)``, equal to
    ``ops.losses.cond_loss``; four row reductions."""
    gammax, gammay = gammax.float(), gammay.float()
    nx, ny = recon_x.numel(), recon_y.numel()
    mse_x = (torch.sum(sq_rows(_flat(recon_x), _flat(x), plain)) / (2.0 * gammax**2)
             + nx * torch.log(gammax))
    mse_y = (torch.sum(sq_rows(_flat(recon_y), _flat(y), plain)) / (2.0 * gammay**2)
             + ny * torch.log(gammay))
    kld_u = 0.5 * torch.mean(kl_std_rows(mu_u, logvar_u, plain))
    kld_z = 0.5 * torch.mean(kl_gen_rows(mu_z, logvar_z, mu_z_uy, logvar_z_uy, plain))
    return mse_x, kld_u, mse_y, kld_z
