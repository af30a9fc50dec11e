"""Plain PyTorch reference of the benchmarked models: Cond_SRVAE and the
Gaussian VAE of Etienne-bdt/Simple-VAE-RS (``models/cond_vae.py``,
``models/vae.py``), in float32, NCHW, with ``torch.nn.functional`` convs
and autograd. No kernel, no fused op, no cache.

Parameters are a dict of tensors keyed by the names the measured program
gives its leaves (``ey_down1.conv.kernel``, ...), with conv kernels in the
HWIO layout ``(kh, kw, C, O)``; a transposed conv's kernel is stored in its
input-dilated, spatially flipped form, so ``convT(x) = correlate(dilate(x),
k)`` with a padding of 2. :func:`param_spec` lists every leaf with its
shape and its init bound, which is how the benchmark makes the weights it
hands to both sides.

Layout rules the reference follows on purpose (they fix which weight meets
which activation): a latent map's channels split into (mu, logvar) halves;
noise is drawn in NHWC order and permuted; the space-to-depth regroup puts
channel ``c`` of pixel ``(2h + i, 2w + j)`` at channel ``(2i + j) C + c``.

``rounding`` (:class:`Rounding`) is the precision of every conv: ``f32`` is
the reference; ``tf32`` and ``fp8`` round each conv's operands, and the
gradient that reaches its output, to a TF32 or an fp8 (e4m3, one scale per
tensor) value first, the control that a lower precision must fail.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
CHANNELS = 4  # Sentinel-2 / Venus bands
FAMILIES = ("cond_srvae", "vae")  # the families this file describes


# ------------------------------------------------------------------ precision
def round_tf32(t: Tensor) -> Tensor:
    """``t`` rounded to the nearest TF32 value (10 mantissa bits), ties away."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(t: Tensor) -> Tensor:
    """``t`` through fp8 e4m3 with one scale for the tensor (its absmax at
    448, e4m3's largest finite value), back in float32."""
    t = t.float()
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Rounding:
    """The precision of the reference's convs: ``f32`` (none), ``tf32`` or
    ``fp8``."""

    def __init__(self, mode: str = "f32") -> None:
        self.fn = {"f32": None, "tf32": round_tf32, "fp8": round_fp8}[mode]
        self.mode = mode

    def operand(self, t: Tensor) -> Tensor:
        if self.fn is None:
            return t
        return t + (self.fn(t.detach()) - t).detach()  # rounded forward, identity backward

    def output(self, t: Tensor) -> Tensor:
        if self.fn is None or not t.requires_grad:
            return t
        return _RoundGrad.apply(t, self.fn)


F32 = Rounding("f32")


# ---------------------------------------------------------------- conv pieces
def _oihw(k: Tensor) -> Tensor:
    return k.permute(3, 2, 0, 1)


def conv3x3(x: Tensor, p: Params, name: str, r: Rounding) -> Tensor:
    y = F.conv2d(r.operand(x), r.operand(_oihw(p[name + ".kernel"])), padding=1)
    return r.output(y) + p[name + ".bias"].view(1, -1, 1, 1)


def conv4x4s2(x: Tensor, p: Params, name: str, r: Rounding) -> Tensor:
    y = F.conv2d(r.operand(x), r.operand(_oihw(p[name + ".kernel"])), stride=2, padding=1)
    return r.output(y) + p[name + ".bias"].view(1, -1, 1, 1)


def convT4x4s2(x: Tensor, p: Params, name: str, r: Rounding) -> Tensor:
    # correlate(dilate(x), k, pad 2) is conv_transpose2d with w[c, o, i, j] = k[3-i, 3-j, c, o]
    w = p[name + ".kernel"].flip(0, 1).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(r.operand(x), r.operand(w), stride=2, padding=1)
    return r.output(y) + p[name + ".bias"].view(1, -1, 1, 1)


def batch_norm(x: Tensor, p: Params, name: str, train: bool,
               stats: Optional[Dict[str, Tensor]]) -> Tensor:
    """Training: batch statistics over (B, H, W), the biased variance
    ``max(0, E[x^2] - E[x]^2)``; ``stats`` (if given) gets the running
    statistics moved by 0.1 (by ``stats["_momentum"]``'s complement where
    it has that key: 0 collects the batch's). Eval: the running statistics."""
    scale, bias = p[name + ".scale"].view(1, -1, 1, 1), p[name + ".bias"].view(1, -1, 1, 1)
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        if stats is not None:
            mom = stats.get("_momentum", BN_MOMENTUM)
            with torch.no_grad():
                for key, v in ((".mean", mean), (".var", var)):
                    stats[name + key] = mom * stats[name + key] + (1 - mom) * v.detach()
    else:
        mean, var = p[name + ".mean"], p[name + ".var"]
    return (x - mean.view(1, -1, 1, 1)) * (scale * torch.rsqrt(var.view(1, -1, 1, 1) + BN_EPS)) \
        + bias


def down_block(x, p, name, r, train, stats):
    h = conv3x3(x, p, name + ".conv", r)
    h = conv4x4s2(h, p, name + ".downsample", r)
    return torch.relu(batch_norm(h, p, name + ".bn", train, stats))


def up_block(x, p, name, r, train, stats):
    h = conv3x3(x, p, name + ".conv", r)
    h = convT4x4s2(h, p, name + ".upsample", r)
    return torch.relu(batch_norm(h, p, name + ".bn", train, stats))


def space_to_depth(x: Tensor) -> Tensor:
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def depth_to_space(x: Tensor) -> Tensor:
    b, c4, h, w = x.shape
    c = c4 // 4
    x = x.reshape(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c, 2 * h, 2 * w)


def nchw(t: Tensor) -> Tensor:
    return t.permute(0, 3, 1, 2)


def nhwc(t: Tensor) -> Tensor:
    return t.permute(0, 2, 3, 1)


# -------------------------------------------------------------------- sizes
def cond_sizes(cfg: dict) -> Dict[str, int]:
    """Cond_SRVAE's latent sizes (reference ``cond_vae.py:21``): the
    latent, the LR latent (a quarter), and the grids' channels."""
    ps, cr = int(cfg["patch_size"]), float(cfg["cr"])
    latent = int((ps * ps * CHANNELS / cr) // 256) * 256
    ly = latent // 4
    return {"ps": ps, "latent": latent, "latent_y": ly, "z_ch": latent // 64,
            "u_ch": ly // 64, "z16": latent // 16, "u16": ly // 16, "grid": ps // 8}


def vae_sizes(cfg: dict) -> Dict[str, int]:
    """The VAE's latent size (reference ``vae.py:29-31``, a floor division
    by cr first) and its map: ``latent // 64`` channels on a (ps/4)^2 grid."""
    ps, cr = int(cfg["patch_size"]), float(cfg["cr"])
    latent = int((ps * ps * CHANNELS // cr) // 16) * 16
    return {"ps": ps, "latent": latent, "ch": latent // 64, "grid": ps // 4,
            "dim": (latent // 64) * (ps // 4) ** 2}


# ------------------------------------------------------------ architecture
def _layers(cfg: dict) -> List[Tuple[str, str, int, int]]:
    """Every conv layer and block as ``(name, kind, C, O)``; kind is
    ``conv`` (3x3), ``down`` or ``up`` (a block: 3x3 C->C, then the strided
    conv C->O, BatchNorm, ReLU)."""
    ch = CHANNELS
    if cfg["family"] not in FAMILIES:
        raise ValueError(f"no reference of the model family {cfg['family']!r}")
    if cfg["family"] == "vae":
        s = vae_sizes(cfg)
        return [("enc_down1", "down", ch, 16), ("enc_down2", "down", 16, 64),
                ("enc_conv1", "conv", 64, 64), ("enc_conv2", "conv", 64, 128),
                ("enc_conv3", "conv", 128, 128), ("enc_head", "conv", 128, 2 * s["ch"]),
                ("dec_up1", "up", s["ch"], 128), ("dec_up2", "up", 128, 64),
                ("dec_conv1", "conv", 64, 64), ("dec_conv2", "conv", 64, 16),
                ("dec_conv3", "conv", 16, 16), ("dec_conv4", "conv", 16, ch)]
    s = cond_sizes(cfg)
    lz64, lz16, ly64, ly16 = s["z_ch"], s["z16"], s["u_ch"], s["u16"]
    return [
        ("ey_down1", "down", ch, 16), ("ey_down2", "down", 16, 64),
        ("ey_conv1", "conv", 64, 64), ("ey_conv2", "conv", 64, 128),
        ("ey_conv3", "conv", 128, 128), ("ey_head", "conv", 128, 2 * ly64),
        ("dy_up1", "up", ly64, 128), ("dy_up2", "up", 128, 64),
        ("dy_conv1", "conv", 64, 64), ("dy_conv2", "conv", 64, 16),
        ("dy_conv3", "conv", 16, 16), ("dy_conv4", "conv", 16, ch),
        ("ex_down1", "down", ch, 16), ("ex_down2", "down", 16, 64),
        ("ex_down3", "down", 64, 128), ("ex_conv1", "conv", 128, 128),
        ("ex_conv2", "conv", 128, 128), ("ex_conv3", "conv", 128, 128),
        ("ex_head", "conv", 128, 2 * lz64),
        ("dx_up1", "up", 2 * lz64, 256), ("dx_up2", "up", 256, 128),
        ("dx_up3", "up", 128, 64), ("dx_conv1", "conv", 64, 64),
        ("dx_conv2", "conv", 64, 16), ("dx_conv3", "conv", 16, 16),
        ("dx_conv4", "conv", 16, ch),
        ("yz_down1", "down", ch, 16), ("yz_down2", "down", 16, 64),
        ("yz_down3", "down", 64, 128), ("yz_conv1", "conv", 128, 128),
        ("yz_conv2", "conv", 128, lz16),
        ("uz_conv1", "conv", ly16, ly16), ("uz_conv2", "conv", ly16, lz16),
        ("pz_mu_conv1", "conv", 2 * lz16, lz16), ("pz_mu_conv2", "conv", lz16, lz16),
        ("pz_lv_conv1", "conv", 2 * lz16, lz16), ("pz_lv_conv2", "conv", lz16, lz16),
    ]


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """Every leaf of the model as ``(name, shape, init, bound)``: ``init``
    is ``uniform`` (U(-bound, bound), torch's default for a conv: bound
    1/sqrt(fan), a transposed conv's fan being O * 16), ``one``, ``zero``,
    or ``bn_mean`` / ``bn_var`` (running statistics, buffers)."""
    out: List[Tuple[str, Tuple[int, ...], str, float]] = []
    gammas = ["gamma"] if cfg["family"] == "vae" else ["gammax", "gammay"]
    out += [(g, (), "one", 0.0) for g in gammas]

    def conv(name, k, c, o, fan):
        b = 1.0 / math.sqrt(fan)
        out.append((name + ".kernel", (k, k, c, o), "uniform", b))
        out.append((name + ".bias", (o,), "uniform", b))

    for name, kind, c, o in _layers(cfg):
        if kind == "conv":
            conv(name, 3, c, o, 9 * c)
            continue
        conv(name + ".conv", 3, c, c, 9 * c)
        if kind == "down":
            conv(name + ".downsample", 4, c, o, 16 * c)
        else:
            conv(name + ".upsample", 4, c, o, 16 * o)
        out += [(name + ".bn.scale", (o,), "one", 0.0), (name + ".bn.bias", (o,), "zero", 0.0),
                (name + ".bn.mean", (o,), "bn_mean", 0.0), (name + ".bn.var", (o,), "bn_var", 0.0)]
    return out


def trainable(cfg: dict) -> List[str]:
    """The leaves an optimizer steps (all but the running statistics)."""
    return [n for n, _, init, _ in param_spec(cfg) if init not in ("bn_mean", "bn_var")]


def conv_sites(cfg: dict, batch: int, part: str = "all"
               ) -> List[Tuple[str, Tuple[int, ...], int, bool]]:
    """Every conv one forward pass runs, as ``(kind, (B, H, W, C), O,
    needs_dx)`` with kind ``conv3x3``, ``conv4x4s2`` or ``convT4x4s2``, the
    input NHWC, and whether a training step computes its input gradient (not
    where the input is the data). ``part`` picks what a request runs:
    ``all`` (a training forward), ``prior`` (the conditioning pass of an
    N-draw request: q(u|y), the y-embedding and the prior) or ``decode``
    (the HR decoder alone)."""
    layers = {name: (kind, c, o) for name, kind, c, o in _layers(cfg)}
    sites: List[Tuple[str, Tuple[int, ...], int, bool]] = []

    def run(names, s, from_data=False):
        for name in names:
            kind, c, o = layers[name]
            first = from_data and name == names[0]
            if kind == "conv":
                sites.append(("conv3x3", (batch, s, s, c), o, not first))
                continue
            sites.append(("conv3x3", (batch, s, s, c), c, not first))
            strided = "conv4x4s2" if kind == "down" else "convT4x4s2"
            sites.append((strided, (batch, s, s, c), o, True))
            s = s // 2 if kind == "down" else s * 2

    ps = int(cfg["patch_size"])
    if cfg["family"] == "vae":
        run(["enc_down1", "enc_down2", "enc_conv1", "enc_conv2", "enc_conv3", "enc_head"], ps,
            True)
        run(["dec_up1", "dec_up2", "dec_conv1", "dec_conv2", "dec_conv3", "dec_conv4"], ps // 4)
        return sites
    g = cond_sizes(cfg)["grid"]
    lr = ps // 2
    if part in ("all", "prior"):
        run(["ey_down1", "ey_down2", "ey_conv1", "ey_conv2", "ey_conv3", "ey_head"], lr, True)
        if part == "all":
            run(["ex_down1", "ex_down2", "ex_down3", "ex_conv1", "ex_conv2", "ex_conv3",
                 "ex_head"], ps, True)
        run(["yz_down1", "yz_down2", "yz_down3", "yz_conv1", "yz_conv2"], lr, True)
        run(["uz_conv1", "uz_conv2"], g // 2)
        run(["pz_mu_conv1", "pz_mu_conv2"], g // 2)
        run(["pz_lv_conv1", "pz_lv_conv2"], g // 2)
    if part in ("all", "decode"):
        run(["dx_up1", "dx_up2", "dx_up3", "dx_conv1", "dx_conv2", "dx_conv3", "dx_conv4"], g)
    if part == "all":
        run(["dy_up1", "dy_up2", "dy_conv1", "dy_conv2", "dy_conv3", "dy_conv4"], g)
    return sites


# ------------------------------------------------------------------ Cond_SRVAE
def _tail(h, p, names, r):
    for n in names:
        h = conv3x3(h, p, n, r)
    return h


def cond_encode_y(p, y, r, train, stats):
    h = down_block(y, p, "ey_down1", r, train, stats)
    h = down_block(h, p, "ey_down2", r, train, stats)
    h = _tail(h, p, ("ey_conv1", "ey_conv2", "ey_conv3", "ey_head"), r)
    c = h.shape[1] // 2
    return h[:, :c], h[:, c:]


def cond_encode_x(p, x, r, train, stats):
    h = x
    for n in ("ex_down1", "ex_down2", "ex_down3"):
        h = down_block(h, p, n, r, train, stats)
    h = _tail(h, p, ("ex_conv1", "ex_conv2", "ex_conv3", "ex_head"), r)
    c = h.shape[1] // 2
    return h[:, :c], h[:, c:]


def cond_y_embedding(p, y, r, train, stats):
    h = y
    for n in ("yz_down1", "yz_down2", "yz_down3"):
        h = down_block(h, p, n, r, train, stats)
    return _tail(h, p, ("yz_conv1", "yz_conv2"), r)


def cond_prior(p, y_feat, u, r):
    u_feat = _tail(space_to_depth(u), p, ("uz_conv1", "uz_conv2"), r)
    joint = torch.cat([y_feat, u_feat], dim=1)
    mu = _tail(joint, p, ("pz_mu_conv1", "pz_mu_conv2"), r)
    lv = _tail(joint, p, ("pz_lv_conv1", "pz_lv_conv2"), r).clamp(-7.0, 7.0)
    return depth_to_space(mu), depth_to_space(lv)


def cond_decode_x(p, z, y_feat, r, train, stats):
    h = torch.cat([depth_to_space(y_feat).expand(z.shape[0], -1, -1, -1), z], dim=1)
    for n in ("dx_up1", "dx_up2", "dx_up3"):
        h = up_block(h, p, n, r, train, stats)
    return torch.sigmoid(_tail(h, p, ("dx_conv1", "dx_conv2", "dx_conv3", "dx_conv4"), r))


def cond_decode_y(p, u, r, train, stats):
    h = up_block(u, p, "dy_up1", r, train, stats)
    h = up_block(h, p, "dy_up2", r, train, stats)
    return torch.sigmoid(_tail(h, p, ("dy_conv1", "dy_conv2", "dy_conv3", "dy_conv4"), r))


def gaussian_nll(recon: Tensor, target: Tensor, gamma: Tensor) -> Tensor:
    """``sum((recon - target)^2) / (2 gamma^2) + numel * log(gamma)``."""
    return torch.sum((recon - target) ** 2) / (2.0 * gamma ** 2) + recon.numel() * torch.log(gamma)


def kl_std(mu: Tensor, lv: Tensor) -> Tensor:
    """KL(N(mu, e^lv) || N(0, I)), summed per row, averaged over the rows."""
    rows = torch.sum((mu ** 2 + torch.exp(lv) - 1.0 - lv).flatten(1), dim=1)
    return 0.5 * rows.mean()


def kl_gen(mu_q, lv_q, mu_p, lv_p) -> Tensor:
    """KL(N(mu_q, e^lv_q) || N(mu_p, e^lv_p)), per row, averaged."""
    t = (lv_p - lv_q - 1.0) + torch.exp(lv_q - lv_p) + (mu_q - mu_p) ** 2 * torch.exp(-lv_p)
    return 0.5 * torch.sum(t.flatten(1), dim=1).mean()


def cond_loss(p: Params, y: Tensor, x: Tensor, eps_u: Tensor, eps_z: Tensor,
              r: Rounding = F32, stats=None) -> Dict[str, Tensor]:
    """The training loss of one batch: ``y`` (B, ps/2, ps/2, C) and ``x``
    (B, ps, ps, C) NHWC, the noise NHWC as drawn; BatchNorm on batch
    statistics. Returns ``loss, mse_x, kld_u, mse_y, kld_z``."""
    y, x = nchw(y), nchw(x)
    mu_u, lv_u = cond_encode_y(p, y, r, True, stats)
    u = mu_u + nchw(eps_u) * torch.exp(0.5 * lv_u)
    mu_z, lv_z = cond_encode_x(p, x, r, True, stats)
    z = mu_z + nchw(eps_z) * torch.exp(0.5 * lv_z)
    y_feat = cond_y_embedding(p, y, r, True, stats)
    mu_p, lv_p = cond_prior(p, y_feat, u, r)
    x_hat = cond_decode_x(p, z, y_feat, r, True, stats)
    y_hat = cond_decode_y(p, u, r, True, stats)
    terms = {"mse_x": gaussian_nll(x_hat, x, p["gammax"]), "kld_u": kl_std(mu_u, lv_u),
             "mse_y": gaussian_nll(y_hat, y, p["gammay"]),
             "kld_z": kl_gen(mu_z, lv_z, mu_p, lv_p)}
    terms["loss"] = terms["mse_x"] + terms["kld_u"] + terms["mse_y"] + terms["kld_z"]
    return terms


def vae_loss(p: Params, x: Tensor, eps: Tensor, cfg: dict, r: Rounding = F32,
             stats=None) -> Dict[str, Tensor]:
    """The VAE's training loss on ``x`` (B, ps, ps, C) NHWC; ``eps`` (B,
    latent) in the map's HWC order. Returns ``loss, mse, kld``."""
    s = vae_sizes(cfg)
    xn = nchw(x)
    h = down_block(xn, p, "enc_down1", r, True, stats)
    h = down_block(h, p, "enc_down2", r, True, stats)
    h = _tail(h, p, ("enc_conv1", "enc_conv2", "enc_conv3", "enc_head"), r)
    mu, lv = h[:, :s["ch"]], h[:, s["ch"]:]
    e = nchw(eps.reshape(eps.shape[0], s["grid"], s["grid"], s["ch"]))
    z = mu + e * torch.exp(0.5 * lv)
    h = up_block(z, p, "dec_up1", r, True, stats)
    h = up_block(h, p, "dec_up2", r, True, stats)
    x_hat = torch.sigmoid(_tail(h, p, ("dec_conv1", "dec_conv2", "dec_conv3", "dec_conv4"), r))
    terms = {"mse": gaussian_nll(x_hat, xn, p["gamma"]), "kld": kl_std(mu, lv)}
    terms["loss"] = terms["mse"] + terms["kld"]
    return terms


def train_noise_shapes(cfg: dict, batch: int) -> List[Tuple[int, ...]]:
    """The shapes of one training step's noise, in draw order: ``eps_u``
    then ``eps_z`` (NHWC on the LR/4 grid), or the VAE's ``(B, latent)``."""
    if cfg["family"] == "vae":
        return [(batch, vae_sizes(cfg)["dim"])]
    s = cond_sizes(cfg)
    g = s["grid"]
    return [(batch, g, g, s["u_ch"]), (batch, g, g, s["z_ch"])]


def draw_chunk(samples: int, patch_size: int, budget_bytes: int = 1 << 30) -> int:
    """The draws decoded at a time in an N-draw request, which fixes the
    order the noise is drawn in: the served path's rule (the widest decoder
    activation, 64 channels at the HR patch, counted at 2 bytes with 2x
    headroom, under 1 GiB)."""
    return max(1, min(samples, budget_bytes // (patch_size * patch_size * 64 * 2 * 2)))


@torch.no_grad()
def cond_draws(p: Params, y: Tensor, gen: torch.Generator, samples: int, chunk: int,
               r: Rounding = F32) -> Tensor:
    """``samples`` draws of the HR image given one LR image ``y`` (1, ps/2,
    ps/2, C), NCHW out (samples, C, ps, ps), in eval mode: one draw of u
    from q(u|y), the prior p(z|u, y) once, then chunks of z from it, each
    decoded. The noise comes from ``gen``: ``eps_u`` shaped like u (NHWC),
    then per chunk ``(chunk, grid, grid, z_ch)``."""
    yn = nchw(y)
    mu_u, lv_u = cond_encode_y(p, yn, r, False, None)
    eps_u = torch.randn(tuple(nhwc(mu_u).shape), generator=gen, device=y.device)
    u = mu_u + nchw(eps_u) * torch.exp(0.5 * lv_u)
    y_feat = cond_y_embedding(p, yn, r, False, None)
    mu_p, lv_p = cond_prior(p, y_feat, u, r)
    std_p = torch.exp(0.5 * lv_p)
    outs = []
    for _ in range(0, samples, chunk):
        noise = torch.randn((chunk,) + tuple(nhwc(mu_p).shape[1:]), generator=gen,
                            device=y.device)
        outs.append(cond_decode_x(p, mu_p + nchw(noise) * std_p, y_feat, r, False, None))
    return torch.cat(outs)[:samples]
