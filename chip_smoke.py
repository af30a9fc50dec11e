#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (H100): the quickest proof
that the port builds, is right, serves and trains at full width.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase's failure is caught):

1. Print torch's version and the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from ``simple_vae_rs_tpu_torch/csrc`` (nvcc, one
   process per source, all started together) and print ptxas's registers and
   spills per kernel.
3. Hold each kernel against its plain PyTorch version on ragged shapes.
4. Build the canonical Cond_SRVAE (cr=1.2, ps=64; random weights from a numpy
   seed) and serve through ``SuperResolver``: ``super_resolve`` on a
   (16, 32, 32, 4) batch, then ``uncertainty`` with 1000 draws. Every launch
   counter is set to 0 just before and read just after; each must be > 0.
   The same requests (same seeds, so the same noise) then run through the
   plain path on the card and must agree.
5. Hold each kernel against its plain version at every distinct shape the
   serving run launched, and time kernel, plain version and one library call
   (cuDNN conv + bias, TF32 off) with CUDA events; compute each shape's bound
   (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, H100 SXM).
6. Train: the canonical model from ``init_weights(0)``, 32 synthetic tiles
   (LR 128x128x4, HR 256x256x4, values x1000, numpy seed 0) cut by the
   port's ``grid_sr_batch`` on the card into 512 pairs, and
   ``Trainer.train_step`` / ``val_step``. The counters are set to 0 just
   before one train step and read just after, by kernel and role (forward,
   input gradient "dx"), and asserted against the calls hooks recorded; the
   same for one val step. Then 1 more warm-up step and 5 timed steps
   (synchronised, median), patches/s and peak memory.
7. Hold each kernel and role against its plain version at every distinct
   training shape and time it, with the library call that computes the same
   function (cuDNN forward for a forward role, cuDNN backward-data for a dx
   role, none for the row reductions); time the library weight-gradient
   calls (not a kernel port: the JAX package leaves them to XLA), each held
   against float64 on 2 images so TF32 cannot slip in, and give each
   part's share of the step.
8. Two copies of the model take one step on the same batch and noise, one
   through the kernels and one through the plain path (which must launch
   nothing): loss terms, every gradient leaf, BatchNorm statistics and the
   parameters after the step must agree; then one val step each.

Output: per-shape lines, a ``{"kernels": [...]}`` line (each kernel's
launches, times and bounds summed over the serving run, one train step and
one val step), then the last line
``{"ok": true, "device": {...}}``. A per-shape report is written to
``chiprun_out/chip_smoke_report.json``. Exits non-zero without a CUDA card.

Tolerances: kernel vs plain max|diff| <= 1e-4 * max|plain| (float32 both,
summed in another order); row reductions 1e-5 * max|plain| (every element
term is >= 0); served outputs in [0, 1] within 1e-4. The training step,
kernels vs plain path: loss terms and BatchNorm statistics relative 1e-4;
each gradient leaf max|diff| <= 8 * the same leaf's max|diff| between the
plain path and the plain path on the permuted batch (the same function,
summed in another order: float32's own noise) + 1e-4 * the largest |plain
gradient| of its block (top-level module). A fixed share of the leaf does
not hold at B=512: the weight gradient of a conv that BatchNorm follows is
a long sum that cancels, and the permuted batch alone moves it by up to
0.6% of the leaf's largest value; the bias of such a conv has a true
gradient of 0. Parameters after the step within 2 * lr (Adam's first step
moves a weight by about lr * sign(g)), and 99% of all elements within
1e-2 * lr.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_TOL = 1e-4  # of max|plain|
ROW_TOL = 1e-5  # of max|plain|
SERVE_TOL = 1e-4  # absolute, on outputs in [0, 1]
TERMS_TOL = STATS_TOL = 1e-4  # relative
GRAD_TOL = 1e-4  # of the largest |plain gradient| in the leaf's block, beside
NOISE_FACTOR = 8.0  # times float32's own noise: the plain path on the permuted batch
SOURCE = "simple_vae_rs_tpu_torch/csrc/fused_conv.cu"
ROW_SOURCE = "simple_vae_rs_tpu_torch/csrc/elbo_rows.cu"
REPLACES = {
    "fused_conv3x3_bn_relu": "simple_vae_rs_tpu/ops/pallas_conv.py:128",
    "fused_conv4x4s2_bn_relu": "simple_vae_rs_tpu/ops/pallas_conv.py:682",
    "fused_convT4x4s2_bn_relu": "simple_vae_rs_tpu/ops/pallas_conv.py:792",
    # pallas_elbo._rows_call (:135) with each row kernel's body
    "sq_rows": "simple_vae_rs_tpu/ops/pallas_elbo.py:167",
    "kl_std_rows": "simple_vae_rs_tpu/ops/pallas_elbo.py:200",
    "kl_gen_rows": "simple_vae_rs_tpu/ops/pallas_elbo.py:239",
}
ROW_OPS = {"sq_rows": 3, "kl_std_rows": 5, "kl_gen_rows": 11}  # float ops per element
LR = 1e-4
RAGGED = [
    ("fused_conv3x3_bn_relu", (3, 5, 7, 5), 13, True),
    ("fused_conv3x3_bn_relu", (2, 9, 11, 4), 3, False),
    ("fused_conv3x3_bn_relu", (1, 4, 4, 300), 200, False),
    ("fused_conv4x4s2_bn_relu", (3, 6, 10, 5), 7, True),
    ("fused_conv4x4s2_bn_relu", (2, 7, 9, 3), 20, False),
    ("fused_convT4x4s2_bn_relu", (2, 3, 5, 7), 9, True),
    ("fused_convT4x4s2_bn_relu", (1, 4, 4, 130), 70, False),
]


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def library_fn(name, x, kernel, scale, shift, relu):
    """One cuDNN call computing the same function (scale folded into the
    weights beforehand): the yardstick, never used by the port."""
    xn = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory (channels_last)
    if name == "fused_convT4x4s2_bn_relu":
        wt = (kernel * scale).flip(0, 1).permute(2, 3, 0, 1).contiguous()

        def call():
            y = F.conv_transpose2d(xn, wt, shift, stride=2, padding=1)
            return F.relu(y) if relu else y
    else:
        wt = (kernel * scale).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        stride, pad = (2, 1) if name == "fused_conv4x4s2_bn_relu" else (1, 1)

        def call():
            y = F.conv2d(xn, wt, shift, stride=stride, padding=pad)
            return F.relu(y) if relu else y
    return call


def library_dx(site, g, kernel):
    """One cuDNN backward-data call computing the input gradient of conv
    ``site`` from ``g``, where ``kernel`` is the flip-swapped weight its dx
    kernel takes (``flip_swap`` is its own inverse)."""
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc

    k_site = fc.flip_swap(kernel)
    in_shape = fc.output_shape(fc.DX_KERNEL[site], g.shape, kernel.shape[-1])
    gn = g.permute(0, 3, 1, 2)
    xn = torch.empty(in_shape, device=g.device).permute(0, 3, 1, 2)
    if site == "fused_convT4x4s2_bn_relu":
        w, stride, transposed = k_site.flip(0, 1).permute(2, 3, 0, 1).contiguous(), 2, True
    else:
        w, transposed = k_site.permute(3, 2, 0, 1).contiguous(), False
        stride = 2 if site == "fused_conv4x4s2_bn_relu" else 1

    def call():
        return torch.ops.aten.convolution_backward(
            gn, xn, w, None, [stride, stride], [1, 1], [1, 1], transposed, [0, 0], 1,
            [True, False, False])[0]
    return call


def check_shape(fc, name, shape, o, relu, seed, timing: bool, site=None):
    """Kernel vs plain version at one shape; with ``timing``, also the times.
    ``site`` names the conv whose input gradient the call computes (the dx
    role: unit scale, zero shift, no ReLU, library = backward-data)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = 3 if name == "fused_conv3x3_bn_relu" else 4
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda")
    kernel = torch.randn((k, k, c, o), generator=gen, device="cuda") / math.sqrt(k * k * c)
    if site is None:
        scale = torch.rand((o,), generator=gen, device="cuda") + 0.5
        shift = torch.randn((o,), generator=gen, device="cuda")
    else:
        scale, shift = torch.ones(o, device="cuda"), torch.zeros(o, device="cuda")
    got = getattr(fc, name)(x, kernel, scale, shift, relu=relu)
    want = fc.PLAIN[name](x, kernel, scale, shift, relu)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ref = float(want.abs().max())
    if not (err <= KERNEL_TOL * ref) or not torch.isfinite(got).all():
        raise AssertionError(f"{name} {shape}->{o}: max|diff| {err} > {KERNEL_TOL} * {ref}")
    row = {"name": name, "role": "forward" if site is None else "dx", "x": list(shape),
           "o": o, "relu": relu, "max_abs_err": err, "max_abs_ref": ref}
    if timing:
        if site is None:
            lib = library_fn(name, x, kernel, scale, shift, relu)
        else:
            lib = library_dx(site, x, kernel)
        lib_err = float((lib().permute(0, 2, 3, 1) - want).abs().max())
        if not lib_err <= KERNEL_TOL * ref:
            raise AssertionError(f"library call disagrees at {name} {shape}: {lib_err}")
        first = cuda_ms(lambda: getattr(fc, name)(x, kernel, scale, shift, relu=relu), 1)
        reps = max(3, min(50, int(30.0 / max(first, 1e-3))))
        row["ms"] = cuda_ms(lambda: getattr(fc, name)(x, kernel, scale, shift, relu=relu), reps)
        row["plain_ms"] = cuda_ms(lambda: fc.PLAIN[name](x, kernel, scale, shift, relu), reps)
        row["library_ms"] = cuda_ms(lib, reps)
        m, n, kk, phases = fc.geometry(name, x, kernel)
        flops = 2.0 * phases * m * n * kk
        nbytes = 4.0 * (x.numel() + kernel.numel() + 2 * o + got.numel())
        row["flops"], row["bytes"] = flops, nbytes
        row["bound_ms"] = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
        row["bound_by"] = "operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES else "bytes"
    return row


def randomize_bn(model, seed: int) -> None:
    """Non-trivial BatchNorm parameters and running statistics (numpy seed),
    so the folded tails are exercised."""
    from simple_vae_rs_tpu_torch.ops.conv_blocks import BatchNorm

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.scale.numel()
                for t, vals in ((mod.scale, rng.uniform(0.8, 1.2, n)),
                                (mod.bias, rng.normal(0.0, 0.1, n)),
                                (mod.mean, rng.normal(0.0, 0.1, n)),
                                (mod.var, rng.uniform(0.5, 1.5, n))):
                    t.copy_(torch.from_numpy(vals.astype(np.float32)))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def record_conv_calls(model, calls):
    """Hooks recording every conv launch the model's next passes make, as
    ``(kernel, role, kernel input shape, O, relu, site, site input shape)``:
    a forward call when a conv runs, and a dx call when autograd computes the
    gradient of a conv's input (a tensor hook, so only inputs that need one)."""
    from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc

    def site(name, x, o, relu):
        shape = tuple(x.shape)
        calls.append((name, "forward", shape, o, relu, name, shape))
        if x.requires_grad:
            dx = (fc.DX_KERNEL[name], "dx", fc.output_shape(name, shape, o), shape[-1], False,
                  name, shape)
            x.register_hook(lambda g: calls.append(dx))

    hooks = []
    for mod in model.modules():
        if isinstance(mod, blocks.Conv3x3):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, args: site("fused_conv3x3_bn_relu", args[0], m.kernel.shape[-1],
                                     False)))
        if isinstance(mod, (blocks.DownBlock, blocks.UpBlock)):
            # the tail conv's input is the output of the block's 3x3 conv
            hooks.append(mod.conv.register_forward_hook(
                lambda m, args, out, blk=mod: site(
                    blk._kernel, out, getattr(blk, blk._tail_name).kernel.shape[-1],
                    not blk.training)))
    return hooks


def counts_by_role(calls):
    out = {}
    for c in calls:
        out[(c[0], c[1])] = out.get((c[0], c[1]), 0) + 1
    return out


def row_shapes(cfg, batch):
    """(name, B, D) of the four row reductions of one Cond_SRVAE loss."""
    g = cfg.patch_size // 8
    return [("sq_rows", batch, cfg.patch_size ** 2 * cfg.channels),
            ("sq_rows", batch, cfg.lr_patch_size ** 2 * cfg.channels),
            ("kl_std_rows", batch, g * g * cfg.u_channels),
            ("kl_gen_rows", batch, g * g * cfg.z_channels)]


def profiled_device_ms(fn, reps: int, match: str):
    """Device time per call of the kernels whose name holds ``match``, from
    ``torch.profiler`` (for kernels shorter than their wrapper's host time,
    which CUDA events around a loop of calls measure instead); None when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages()
             if match in e.key)
    return us / reps / 1e3 if us else None


def check_rows(fe, name, b, d, seed):
    """Row kernel vs plain version at one shape, timed."""
    n_in = fe.MODES[name][1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = [torch.randn((b, d), generator=gen, device="cuda") if i % 2 == 0
            else torch.rand((b, d), generator=gen, device="cuda") * 6 - 3 for i in range(n_in)]
    got = getattr(fe, name)(*rows)
    want = fe.PLAIN[name](*rows)
    torch.cuda.synchronize()
    err, ref = float((got - want).abs().max()), float(want.abs().max())
    if not err <= ROW_TOL * ref:
        raise AssertionError(f"{name} ({b}, {d}): max|diff| {err} > {ROW_TOL} * {ref}")
    if not torch.equal(getattr(fe, name)(*rows), got):
        raise AssertionError(f"{name} ({b}, {d}): sums differ between two runs")
    nbytes = 4.0 * (n_in * b * d + b)
    flops = float(ROW_OPS[name] * b * d)
    return {"name": name, "x": [b, d], "max_abs_err": err, "max_abs_ref": ref,
            "ms": cuda_ms(lambda: getattr(fe, name)(*rows), 50),
            "plain_ms": cuda_ms(lambda: fe.PLAIN[name](*rows), 50),
            "device_ms": profiled_device_ms(lambda: getattr(fe, name)(*rows), 20, "rows_"),
            "library_ms": None, "flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES),
            "bound_by": "operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES else "bytes"}


def time_weight_grad(fc, site, shape, o, seed):
    """The library weight-gradient call of conv ``site`` at one shape, timed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = 3 if site == "fused_conv3x3_bn_relu" else 4
    x = torch.randn(shape, generator=gen, device="cuda")
    g = torch.randn(fc.output_shape(site, shape, o), generator=gen, device="cuda")
    kernel = torch.randn((k, k, shape[-1], o), generator=gen, device="cuda")
    # TF32 off: on the first 2 images (sums short enough that float32's own
    # rounding stays near 1e-6 of the largest value) against float64; TF32's
    # 10-bit mantissa would miss by ~1e-3 whatever the sum's length
    dk = fc.weight_grad(site, x[:2], g[:2], kernel)
    want = fc.weight_grad(site, x[:2].double(), g[:2].double(), kernel.double())
    err = float((dk.double() - want).abs().max() / want.abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"library weight gradient {site} {shape}: {err} of max vs float64")
    m, n, kk, phases = fc.geometry(site, x, kernel)
    flops = 2.0 * phases * m * n * kk
    nbytes = 4.0 * (x.numel() + g.numel() + kernel.numel())
    return {"site": site, "x": list(shape), "o": o, "rel_err_vs_float64": err,
            "ms": cuda_ms(lambda: fc.weight_grad(site, x, g, kernel), 5),
            "flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)}


def kernels_vs_plain(cfg, init_state, batch):
    """Phase 8: one train step and one val step from the same state, batch and
    noise, through the kernels and through the plain path; a third copy takes
    the plain step on the batch permuted (the same function, summed in
    another order), which measures float32's own noise in each gradient."""
    from simple_vae_rs_tpu_torch import CondSRVAE, TrainConfig, Trainer
    from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_elbo as fe

    y, x = batch
    n = y.shape[0]

    def copy_trainer(plain):
        m = CondSRVAE(cfg, device="cuda")
        m.load_state_dict(init_state)
        blocks.use_plain_path(m, plain)
        return Trainer(m, TrainConfig(learning_rate=LR), device="cuda")

    tk, tp = copy_trainer(False), copy_trainer(True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    eps = tk.noise(n, y.shape[1:3], gen)
    grads_k, terms_k = tk.grads_and_terms(batch, eps)
    tk.apply_grads(grads_k, LR)
    torch.cuda.synchronize()
    before = (dict(fc.launches), dict(fe.launches))
    grads_p, terms_p = tp.grads_and_terms(batch, eps)
    tp.apply_grads(grads_p, LR)
    perm = torch.randperm(n, generator=gen, device="cuda")
    grads_q, _ = copy_trainer(True).grads_and_terms((y[perm], x[perm]),
                                                    (eps[0][perm], eps[1][perm]))
    torch.cuda.synchronize()
    if (dict(fc.launches), dict(fe.launches)) != before:
        raise AssertionError("the plain training path launched a kernel")
    failures = []
    cmp = {"terms": {}, "grads": {}}
    for key, v in terms_p.items():
        rel = abs(float(terms_k[key] - v)) / max(abs(float(v)), 1e-30)
        cmp["terms"][key] = rel
        if not rel <= TERMS_TOL:
            failures.append(f"train step {key}: relative diff {rel} > {TERMS_TOL}")
    block_max = {}
    for name, g in grads_p.items():
        blk = name.split(".")[0]
        block_max[blk] = max(block_max.get(blk, 0.0), float(g.abs().max()))
    for name, g in grads_p.items():
        err = float((grads_k[name] - g).abs().max())
        noise = float((grads_q[name] - g).abs().max())
        cmp["grads"][name] = {
            "max_abs_err": err, "perm_noise": noise, "leaf_max": float(g.abs().max()),
            "of_block_max": err / max(block_max[name.split(".")[0]], 1e-30),
            "of_leaf_max": err / max(float(g.abs().max()), 1e-30)}
        cmp["grads"][name]["of_noise"] = err / max(noise, 1e-30)
        limit = NOISE_FACTOR * noise + GRAD_TOL * block_max[name.split(".")[0]]
        if not err <= limit:
            failures.append(f"grad {name}: max|diff| {err} > {NOISE_FACTOR} * {noise} "
                            f"(permuted-batch noise) + {GRAD_TOL} of its block's max")
    log("gradient leaves, worst 15 of block max: leaf, kernels-vs-plain max|diff|, "
        "permuted-plain-vs-plain max|diff|, leaf max, block max")
    for name, c in sorted(cmp["grads"].items(), key=lambda kv: -kv[1]["of_block_max"])[:15]:
        log(f"  {name}: {c['max_abs_err']:.3e} {c['perm_noise']:.3e} {c['leaf_max']:.3e} "
            f"{block_max[name.split('.')[0]]:.3e}")
    worst_stat = 0.0
    for (name, buf), buf_p in zip(tk.model.named_buffers(), tp.model.buffers()):
        rel = float((buf - buf_p).abs().max()) / max(float(buf_p.abs().max()), 1e-30)
        worst_stat = max(worst_stat, rel)
        if not rel <= STATS_TOL:
            failures.append(f"BatchNorm statistic {name}: relative diff {rel}")
    diffs = torch.cat([(p - tp.params[name]).detach().abs().flatten()
                       for name, p in tk.params.items()])
    max_dp = float(diffs.max())
    share_close = float((diffs <= 1e-2 * LR).float().mean())
    if not (max_dp <= 2 * LR * (1 + 1e-3) and share_close >= 0.99):
        failures.append(f"parameters after the step: max|diff| {max_dp}, "
                        f"{share_close:.4f} within 1e-2 * lr")
    vk, vp = tk.val_step(batch), tp.val_step(batch)
    cmp["val_terms"] = {}
    for key, v in vp.items():
        rel = abs(float(vk[key] - v)) / max(abs(float(v)), 1e-30)
        cmp["val_terms"][key] = rel
        if not rel <= TERMS_TOL:
            failures.append(f"val step {key}: relative diff {rel} > {TERMS_TOL}")
    worst = max((c["of_block_max"], name) for name, c in cmp["grads"].items())
    worst_noise = max((c["of_noise"], name) for name, c in cmp["grads"].items())
    cmp.update({"worst_grad_of_block": worst, "worst_grad_of_noise": worst_noise,
                "worst_stat_rel": worst_stat,
                "param_max_abs_diff": max_dp, "param_share_within_1e-2_lr": share_close,
                "failures": failures})
    log(f"train step kernels vs plain path: terms rel {max(cmp['terms'].values()):.2e}, "
        f"grads worst {worst[0]:.2e} of block max ({worst[1]}), worst {worst_noise[0]:.2f}x "
        f"the permuted-batch noise ({worst_noise[1]}), BN stats rel "
        f"{worst_stat:.2e}, params max|diff| {max_dp:.3e} ({share_close:.4f} within 1e-2 lr), "
        f"val terms rel {max(cmp['val_terms'].values()):.2e}")
    return cmp


def train_phase(report):
    """Phases 6-8; returns per-kernel totals over one train step and one val
    step, and each kernel's launches by path and role."""
    from simple_vae_rs_tpu_torch import CondSRVAE, CondSRVAEConfig, TrainConfig, Trainer
    from simple_vae_rs_tpu_torch import grid_sr_batch
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_elbo as fe

    def reset():
        fc.reset_launches()
        fe.reset_launches()

    # 6. set-up, the counted steps, the timed steps
    cfg = CondSRVAEConfig(cr=1.2, patch_size=64)
    model = CondSRVAE(cfg, device="cuda").init_weights(seed=0)
    init_state = copy.deepcopy(model.state_dict())
    rng = np.random.default_rng(0)
    lr_tiles = torch.from_numpy(rng.random((32, 128, 128, 4), dtype=np.float32) * 1000).cuda()
    hr_tiles = torch.from_numpy(rng.random((32, 256, 256, 4), dtype=np.float32) * 1000).cuda()
    batch = grid_sr_batch(lr_tiles, hr_tiles, cfg.patch_size)
    y, x = batch
    if tuple(y.shape) != (512, 32, 32, 4) or tuple(x.shape) != (512, 64, 64, 4):
        raise AssertionError(f"grid_sr_batch gave {tuple(y.shape)}, {tuple(x.shape)}")
    n = y.shape[0]
    trainer = Trainer(model, TrainConfig(learning_rate=LR), device="cuda")

    train_calls, val_calls = [], []
    hooks = record_conv_calls(model, train_calls)
    reset()
    terms0 = trainer.train_step(batch)
    torch.cuda.synchronize()
    step_roles = {k: dict(v) for k, v in fc.role_launches.items()}
    step_rows = dict(fe.launches)
    for h in hooks:
        h.remove()
    hooks = record_conv_calls(model, val_calls)
    reset()
    val0 = trainer.val_step(batch)
    torch.cuda.synchronize()
    val_convs, val_rows = dict(fc.launches), dict(fe.launches)
    for h in hooks:
        h.remove()
    for what, terms in (("train", terms0), ("val", val0)):
        if not all(torch.isfinite(v) for v in terms.values()):
            raise AssertionError(f"{what} step: non-finite loss terms {terms}")

    recorded = counts_by_role(train_calls)
    roles_line = []
    for name, roles in step_roles.items():
        for role, count in roles.items():
            if count <= 0 or recorded.get((name, role), 0) != count:
                raise AssertionError(f"train step: {name} {role} launched {count} times, "
                                     f"hooks recorded {recorded.get((name, role), 0)}")
        roles_line.append(f"{name} forward={roles['forward']} dx={roles['dx']} "
                          f"total={sum(roles.values())}")
    recorded_val = counts_by_role(val_calls)
    for name, count in val_convs.items():
        if count <= 0 or recorded_val.get((name, "forward"), 0) != count:
            raise AssertionError(f"val step: {name} launched {count} times, hooks recorded "
                                 f"{recorded_val.get((name, 'forward'), 0)}")
    want_rows = {"sq_rows": 2, "kl_std_rows": 1, "kl_gen_rows": 1}
    if step_rows != want_rows or val_rows != want_rows:
        raise AssertionError(f"row kernels launched {step_rows} (train), {val_rows} (val)")
    log("train step launches: " + " | ".join(roles_line) + " | "
        + " ".join(f"{k}={v}" for k, v in step_rows.items()))
    log("val step launches: " + " ".join(f"{k}={v}" for k, v in val_convs.items()) + " "
        + " ".join(f"{k}={v}" for k, v in val_rows.items()))

    timed(lambda: trainer.train_step(batch))  # second warm-up step
    torch.cuda.reset_peak_memory_stats()
    step_ms = [timed(lambda: trainer.train_step(batch))[1] for _ in range(5)]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    val_ms = [timed(lambda: trainer.val_step(batch))[1] for _ in range(3)]
    med = statistics.median(step_ms)
    log(f"train step B={n}: median {med:.2f} ms over 5 ({', '.join(f'{t:.2f}' for t in step_ms)}),"
        f" {n / (med / 1e3):.1f} patches/s, peak memory {peak_gib:.2f} GiB; "
        f"val step median {statistics.median(val_ms):.2f} ms")
    del trainer, model

    # 7. every distinct training shape, by kernel and role: check and time
    def key_of(call):
        name, role, shape, o, relu, site, _ = call
        return name, role, shape, o, relu, site if role == "dx" else None

    per_key = {}
    for i, call in enumerate(sorted(set(train_calls + val_calls), key=str)):
        name, role, shape, o, relu, site = key = key_of(call)
        if key in per_key:
            continue
        per_key[key] = row = check_shape(fc, name, shape, o, relu, seed=300 + i, timing=True,
                                         site=site)
        log(f"train shape {name} {role} x{shape} O={o} relu={relu}: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), max|diff| {row['max_abs_err']:.2e}")
    fields = ("ms", "plain_ms", "library_ms", "bound_ms", "flops", "bytes")
    by_role = {}
    for path, path_calls in (("train_step", train_calls), ("val_step", val_calls)):
        for call in path_calls:
            row = per_key[key_of(call)]
            d = by_role.setdefault((path, call[0], call[1]),
                                   dict.fromkeys(("launches",) + fields, 0.0))
            d["launches"] += 1
            for k in fields:
                d[k] += row[k]
    totals = {}
    for (path, name, role), d in by_role.items():
        log(f"{path} {name} {role}: launches {int(d['launches'])}, kernel {d['ms']:.3f} ms, "
            f"bound {d['bound_ms']:.3f} ms, plain {d['plain_ms']:.3f} ms, library "
            f"{d['library_ms']:.3f} ms")
        tot = totals.setdefault(name, dict.fromkeys(fields + ("max_abs_err",), 0.0))
        for k in fields:
            tot[k] += d[k]
    for row in per_key.values():
        totals[row["name"]]["max_abs_err"] = max(totals[row["name"]]["max_abs_err"],
                                                 row["max_abs_err"])
    conv_ms = {name: sum(d["ms"] for (path, n, _), d in by_role.items()
                         if path == "train_step" and n == name) for name in totals}
    rows = list(per_key.values())
    rows_ms = 0.0
    for i, (name, b, d) in enumerate(row_shapes(cfg, n)):
        row = check_rows(fe, name, b, d, seed=400 + i)
        rows.append(row)
        tot = totals.setdefault(name, dict.fromkeys(fields + ("max_abs_err",), 0.0))
        for k in ("ms", "plain_ms", "bound_ms", "flops", "bytes"):
            tot[k] += 2 * row[k]  # once in the train step, once in the val step
        tot["library_ms"] = None
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_abs_err"])
        rows_ms += row["ms"]
        log(f"train rows {name} ({b}, {d}): kernel {row['ms']:.4f} ms (profiler device time "
            f"{row['device_ms']} ms), plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), max|diff| {row['max_abs_err']:.2e}")
    dk_rows = {}
    for call in train_calls:
        name, role, shape, o, relu, site, site_shape = call
        if role == "forward":
            key = (site, site_shape, o)
            if key not in dk_rows:
                dk_rows[key] = dict(time_weight_grad(fc, site, site_shape, o, 500 + len(dk_rows)),
                                    launches=0)
            dk_rows[key]["launches"] += 1
    dk_ms = sum(r["ms"] * r["launches"] for r in dk_rows.values())
    dk_bound = sum(r["bound_ms"] * r["launches"] for r in dk_rows.values())
    log(f"train step {med:.2f} ms: conv kernels {sum(conv_ms.values()):.2f} ms "
        f"({100 * sum(conv_ms.values()) / med:.1f}%: "
        + ", ".join(f"{k} {v:.2f}" for k, v in conv_ms.items())
        + f"), library weight gradients {dk_ms:.2f} ms ({100 * dk_ms / med:.1f}%, "
        f"{sum(r['launches'] for r in dk_rows.values())} calls, bound {dk_bound:.2f} ms), "
        f"row kernels {rows_ms:.3f} ms ({100 * rows_ms / med:.2f}%); the rest is BatchNorm, "
        f"elementwise ops, the optimizer, launches and host time")
    # 8. kernels vs the plain path
    cmp = kernels_vs_plain(cfg, init_state, batch)
    report["training"] = {
        "batch": n, "step_ms": step_ms, "step_ms_median": med,
        "patches_per_s": n / (med / 1e3), "peak_memory_gib": peak_gib, "val_step_ms": val_ms,
        "launches_train_step": step_roles, "rows_train_step": step_rows,
        "launches_val_step": val_convs, "rows_val_step": val_rows,
        "kernels_vs_plain": cmp, "shapes": rows,
        "by_role": {" ".join(k): v for k, v in by_role.items()},
        "weight_grads": [dict(r, site_shape=list(k[1])) for k, r in dk_rows.items()],
        "step_share_ms": {"conv_kernels": conv_ms, "weight_grads": dk_ms, "rows": rows_ms},
    }
    launches_by = {}
    for name, roles in step_roles.items():
        launches_by[name] = {"train_step_forward": roles["forward"], "train_step_dx": roles["dx"],
                             "val_step": val_convs[name]}
    for name in ROW_OPS:
        launches_by[name] = {"train_step": step_rows[name], "val_step": val_rows[name]}
    if cmp["failures"]:
        raise AssertionError("kernels vs plain path: " + "; ".join(cmp["failures"]))
    return totals, launches_by


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from simple_vae_rs_tpu_torch import CondSRVAE, CondSRVAEConfig, SuperResolver, warmup
    from simple_vae_rs_tpu_torch.ops import _build
    from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. versions and card
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"card: {card}")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for src, report in _build.ptxas_logs.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas {src}: {line.strip()}")

    # 3. ragged shapes
    report = {"card": card, "torch": torch.__version__, "ragged": [], "shapes": []}
    for i, (name, shape, o, relu) in enumerate(RAGGED):
        row = check_shape(fc, name, shape, o, relu, seed=100 + i, timing=False)
        report["ragged"].append(row)
        log(f"ragged {name} x{shape} O={o} relu={relu}: max|diff| {row['max_abs_err']:.3e}")

    # 4. serving at full width
    cfg = CondSRVAEConfig(cr=1.2, patch_size=64)
    model = CondSRVAE(cfg, device="cuda").init_weights(seed=0)
    randomize_bn(model, seed=1)
    n_params = sum(p.numel() for n, p in model.named_parameters() if not n.startswith("gamma"))
    log(f"model: Cond_SRVAE cr={cfg.cr} ps={cfg.patch_size} params={n_params} (+2 gammas)")
    sr = SuperResolver(model, device="cuda", seed=0)
    warmup(sr)
    y = np.random.default_rng(2).random((16, cfg.lr_patch_size, cfg.lr_patch_size, 4),
                                        dtype=np.float32)

    calls = []  # (kernel, x shape, O) of every conv the serving run launches
    kinds = ((blocks.Conv3x3, "fused_conv3x3_bn_relu", "kernel"),
             (blocks.DownBlock, "fused_conv4x4s2_bn_relu", "downsample"),
             (blocks.UpBlock, "fused_convT4x4s2_bn_relu", "upsample"))
    hooks = []
    for mod in model.modules():
        for cls, name, attr in kinds:
            if type(mod) is cls:
                w = getattr(mod, attr)
                o = (w if attr == "kernel" else w.kernel).shape[-1]
                relu = cls is not blocks.Conv3x3
                hooks.append(mod.register_forward_pre_hook(
                    lambda m, args, name=name, o=o, relu=relu:
                        calls.append((name, tuple(args[0].shape), o, relu))))

    torch.cuda.reset_peak_memory_stats()
    fc.reset_launches()
    sr_out, sr_ms = timed(lambda: sr.super_resolve(y, seed=11))
    sr_counts = dict(fc.launches)
    n_sr_calls = len(calls)
    uq, uq_ms = timed(lambda: sr.uncertainty(y[0], samples=1000, seed=12))
    launches = dict(fc.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for h in hooks:
        h.remove()
    log("kernels: " + " ".join(f"{k}={v}" for k, v in launches.items())
        + " | super_resolve(16): " + " ".join(f"{k}={v}" for k, v in sr_counts.items()))
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched by the serving path")
        recorded = sum(1 for c in calls if c[0] == name)
        if recorded != count:
            raise AssertionError(f"{name}: {count} launches but {recorded} calls")

    # served outputs are right: shapes, range, and the plain path on the card
    if tuple(sr_out.shape) != (16, 64, 64, 4) or not torch.isfinite(sr_out).all():
        raise AssertionError(f"super_resolve output {tuple(sr_out.shape)} is wrong")
    if float(sr_out.min()) < 0 or float(sr_out.max()) > 1:
        raise AssertionError("super_resolve output leaves [0, 1]")
    for key in ("mean", "std", "variance"):
        if tuple(uq[key].shape) != (64, 64, 4) or not torch.isfinite(uq[key]).all():
            raise AssertionError(f"uncertainty[{key}] is wrong")
    if not float(uq["std"].max()) > 0:
        raise AssertionError("uncertainty draws do not differ")
    rep_sr = [timed(lambda: sr.super_resolve(y, seed=11))[1] for _ in range(5)]
    rep_uq = [timed(lambda: sr.uncertainty(y[0], samples=1000, seed=12))[1] for _ in range(3)]

    blocks.use_plain_path(model)
    before = dict(fc.launches)
    plain_sr = sr.super_resolve(y, seed=11)
    plain_uq = sr.uncertainty(y[0], samples=1000, seed=12)
    plain_sr_ms = timed(lambda: sr.super_resolve(y, seed=11))[1]  # warm repeats
    plain_uq_ms = timed(lambda: sr.uncertainty(y[0], samples=1000, seed=12))[1]
    if fc.launches != before:
        raise AssertionError("the plain path launched a kernel")
    blocks.use_plain_path(model, False)
    serve_err = {
        "super_resolve": float((sr_out - plain_sr).abs().max()),
        **{f"uncertainty.{k}": float((uq[k] - plain_uq[k]).abs().max())
           for k in ("mean", "std")},
    }
    for key, err in serve_err.items():
        if not err <= SERVE_TOL:
            raise AssertionError(f"{key}: kernels vs plain path max|diff| {err} > {SERVE_TOL}")
    serving = {
        "super_resolve_b16_ms": sr_ms, "super_resolve_b16_ms_repeats": rep_sr,
        "uncertainty_n1000_ms": uq_ms, "uncertainty_n1000_ms_repeats": rep_uq,
        "plain_super_resolve_b16_ms": plain_sr_ms, "plain_uncertainty_n1000_ms": plain_uq_ms,
        "peak_memory_gib": peak_gib, "max_abs_err_vs_plain": serve_err,
        "launches": launches, "launches_super_resolve_b16": sr_counts,
    }
    report["serving"] = serving
    log(f"super_resolve B=16: {sr_ms:.2f} ms (repeats median "
        f"{statistics.median(rep_sr):.2f} ms), plain path {plain_sr_ms:.2f} ms")
    log(f"uncertainty N=1000: {uq_ms:.2f} ms (repeats median "
        f"{statistics.median(rep_uq):.2f} ms), plain path {plain_uq_ms:.2f} ms")
    log(f"peak memory {peak_gib:.2f} GiB; kernels vs plain path max|diff| {serve_err}")

    # 5. every distinct serving shape: check and time
    weight = {}
    for c in calls:
        weight[c] = weight.get(c, 0) + 1
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                     "flops": 0.0, "bytes": 0.0, "max_abs_err": 0.0} for name in launches}
    for i, ((name, shape, o, relu), count) in enumerate(sorted(weight.items())):
        row = check_shape(fc, name, shape, o, relu, seed=200 + i, timing=True)
        row["launches"] = count
        report["shapes"].append(row)
        tot = totals[name]
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "flops", "bytes"):
            tot[key] += count * row[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_abs_err"])
        log(f"shape {name} x{shape} O={o} x{count}: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"max|diff| {row['max_abs_err']:.2e}")
    for row in report["ragged"]:
        tot = totals[row["name"]]
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_abs_err"])
    for name, tot in totals.items():
        log(f"serving {name}: launches {launches[name]}, kernel {tot['ms']:.3f} ms, bound "
            f"{tot['bound_ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, library "
            f"{tot['library_ms']:.3f} ms")
    kernel_ms = {(r["name"], tuple(r["x"]), r["o"], r["relu"]): r["ms"] for r in report["shapes"]}
    for req, part, wall in (("super_resolve_b16", calls[:n_sr_calls], rep_sr),
                            ("uncertainty_n1000", calls[n_sr_calls:], rep_uq)):
        busy = sum(kernel_ms[c] for c in part)
        wall_ms = statistics.median(wall)
        serving[f"{req}_kernel_ms"] = busy
        log(f"{req}: conv kernels {busy:.3f} ms of {wall_ms:.3f} ms median wall "
            f"({100 * busy / wall_ms:.1f}%; the rest is other ops, launches and host time)")

    # 6-8. training at full width
    train_totals, train_launches = train_phase(report)

    kernels = []
    for name in dict.fromkeys(list(totals) + list(train_totals)):
        tot = {key: 0.0 for key in ("ms", "plain_ms", "library_ms", "bound_ms", "flops",
                                    "bytes", "max_abs_err")}
        for part in (totals.get(name), train_totals.get(name)):
            if part is None:
                continue
            for key in tot:
                if key == "max_abs_err":
                    tot[key] = max(tot[key], part[key])
                elif part.get(key) is not None:
                    tot[key] += part[key]
        is_row = name in ROW_OPS
        kernels.append({
            "name": name, "route": "cuda", "source": ROW_SOURCE if is_row else SOURCE,
            "replaces": REPLACES[name],
            "launches": launches.get(name, 0) + sum(train_launches[name].values()),
            "launches_by_path": {"serving": launches.get(name, 0), **train_launches[name]},
            "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["flops"] / PEAK_F32_FLOPS
                         > tot["bytes"] / PEAK_BYTES else "bytes"),
            "library_ms": None if is_row else tot["library_ms"],
        })
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"total {report['seconds']:.1f} s; times per kernel are sums over its launches in "
        f"the serving run (super_resolve B=16 + uncertainty N=1000), one train step and "
        f"one val step (B=512)")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
