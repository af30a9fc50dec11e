"""What the benchmark makes from ``--seed`` and hands to both sides: the
weights, the tile pool, the orders of the steps and of the requests.

Everything on the device is drawn there from a ``torch.Generator`` in a
few large calls; the orders come from numpy, on the host, and are small.
The seed may be any whole number: it is spread by numpy's ``SeedSequence``
into the sub-seeds below, so seeds past 32 bits are fine.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import models
from port_bench.reference.train import tf32_off

Tensor = torch.Tensor

# the sub-streams one seed is spread into
STREAMS = ("weights", "tiles", "order", "trainer", "requests", "sample", "settle")


def sub_seeds(seed: int) -> Dict[str, int]:
    """One 63-bit seed per stream of :data:`STREAMS`, from ``seed``."""
    ss = np.random.SeedSequence(int(seed))
    words = ss.generate_state(len(STREAMS), dtype=np.uint64)
    return {name: int(w) >> 1 for name, w in zip(STREAMS, words)}


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def make_weights(spec, seed: int, device, random_bn: bool = False) -> Dict[str, Tensor]:
    """Every leaf of ``spec`` (a family's ``param_spec``: name, shape, init,
    bound) in float32 on ``device``:
    the uniform leaves cut from one draw of U(-1, 1) and scaled by their
    bounds; BatchNorm at identity and the gammas at 1, unless
    ``random_bn``, which draws BatchNorm's affine and running statistics
    too (scale U(0.8, 1.2), bias and mean N(0, 0.1), var U(0.5, 1.5)), as a
    trained model would hold other than identity there."""
    gen = generator(seed, device)
    sizes = [int(np.prod(shape)) for _, shape, init, _ in spec if init == "uniform"]
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    n_bn = sum(int(np.prod(shape)) for name, shape, _, _ in spec if ".bn." in name)
    if random_bn:
        uniform = torch.rand(n_bn, generator=gen, device=device)
        normal = torch.randn(n_bn, generator=gen, device=device)
    out: Dict[str, Tensor] = {}
    at = bn_at = 0
    for name, shape, init, bound in spec:
        n = int(np.prod(shape))
        if init == "uniform":
            out[name] = (flat[at:at + n] * bound).reshape(shape).contiguous()
            at += n
        elif random_bn and ".bn." in name:
            u, z = uniform[bn_at:bn_at + n], normal[bn_at:bn_at + n]
            bn_at += n
            value = {"scale": 0.8 + 0.4 * u, "var": 0.5 + u}.get(name.rsplit(".", 1)[1], 0.1 * z)
            out[name] = value.reshape(shape).contiguous()
        else:
            fill = {"one": 1.0, "zero": 0.0, "bn_mean": 0.0, "bn_var": 1.0}[init]
            out[name] = torch.full(shape, fill, device=device)
    return out


def settle_batch_norm(loss: Callable, weights: Dict[str, Tensor], streams, noise) -> None:
    """Set ``weights``' BatchNorm running statistics to the batch
    statistics of one training-mode forward of the reference (float32,
    ``loss(params, streams, noise, rounding, stats)``) on ``streams`` with
    ``noise``, as a trained model's statistics follow its data: in eval each
    block then normalizes its output, and the served draws spread as a
    trained model's do (at init statistics the activations shrink layer by
    layer and the draws hardly differ)."""
    stats = {k: v for k, v in weights.items() if k.endswith((".bn.mean", ".bn.var"))}
    stats["_momentum"] = 0.0
    with torch.no_grad(), tf32_off():
        loss(weights, streams, noise, models.F32, stats)
    del stats["_momentum"]
    weights.update(stats)


def load_into(model: torch.nn.Module, weights: Dict[str, Tensor]) -> None:
    """Copy ``weights`` into the program's model by leaf name: every
    parameter and BatchNorm statistic, and nothing else (strict)."""
    model.load_state_dict(weights, strict=True)


def make_tiles(pool: int, lr: int, seed: int, device) -> Dict[str, Tensor]:
    """A pool of 4-band tile pairs, NHWC float32 on ``device``: the HR
    tile (2 lr)^2 a smooth random field (a coarse Gaussian grid upsampled
    bilinearly) with fine noise on it, at reflectance-like values around
    1000; the LR tile its 2x2 box average, so LR patch i covers the ground
    of HR patch i."""
    gen = generator(seed, device)
    hr = 2 * lr
    coarse = torch.randn((pool, models.CHANNELS, hr // 16, hr // 16), generator=gen,
                         device=device)
    field = F.interpolate(coarse, size=(hr, hr), mode="bilinear", align_corners=False)
    field += 0.25 * torch.randn((pool, models.CHANNELS, hr, hr), generator=gen, device=device)
    field = 1000.0 + 300.0 * field
    lr_t = F.avg_pool2d(field, 2)
    return {"hr": field.permute(0, 2, 3, 1).contiguous(),
            "lr": lr_t.permute(0, 2, 3, 1).contiguous()}


def step_orders(seed: int, pool: int, per_step: int, steps: int) -> np.ndarray:
    """(steps, per_step) tile indices: consecutive slices of fresh
    permutations of the pool, so the rows of a step, and of the first
    steps together, all differ."""
    rng = np.random.default_rng(seed)
    per_perm = pool // per_step
    perms = [rng.permutation(pool) for _ in range(-(-steps // per_perm))]
    idx = np.concatenate(perms)[:steps * per_step]
    return idx.reshape(steps, per_step)


def request_plan(seed: int, windows: int, n: int) -> Dict[str, List[int]]:
    """The first ``n`` requests: a window index each (uniform over the
    pool) and a seed each for its draws."""
    rng = np.random.default_rng(seed)
    return {"window": rng.integers(0, windows, n).tolist(),
            "seed": rng.integers(0, 2**62, n, dtype=np.int64).tolist()}
