"""The plain reference against the port's CPU path at a small size: the
leaves it describes are the program's, its training steps give the
program's terms, moments and parameters, and its N-draw request gives the
program's maps, on the same weights, tiles and noise."""

import functools
import statistics

import pytest
import torch

from port_bench import families
from port_bench.harness import data
from port_bench.reference import models
from port_bench.reference import train as rt

from .conftest import tiny_parts


def _port(cfg):
    return families.load(cfg).port_model(cfg, torch.float32, "cpu")


@pytest.mark.parametrize("cfg", [
    {"family": "cond_srvae", "patch_size": 64, "cr": 1.2},
    {"family": "vae", "patch_size": 32, "cr": 1.28},
    {"family": "cond_srvae", "patch_size": 16, "cr": 2.0},
], ids=["cond_srvae", "vae", "cond_tiny"])
def test_param_spec_is_the_programs_state(cfg):
    model = _port(cfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {name: shape for name, shape, _, _ in models.param_spec(cfg)}
    assert got == want
    trainable = sum(p.numel() for p in model.parameters())
    assert trainable == sum(torch.Size(s).numel() for n, s, i, _ in models.param_spec(cfg)
                            if i not in ("bn_mean", "bn_var"))


def test_canonical_sizes_are_the_published_ones():
    cond = models.cond_sizes({"patch_size": 64, "cr": 1.2})
    assert (cond["latent"], cond["latent_y"]) == (13568, 3392)
    vae = models.vae_sizes({"patch_size": 32, "cr": 1.28})
    # 4096 // 1.28 is 3199.0 in floating point, so 3184 and 49 channels, not 3200 and 50
    assert (vae["latent"], vae["ch"]) == (3184, 49)


@pytest.mark.parametrize("name", ["cond_srvae.train_f32", "vae.train_bf16"])
def test_reference_steps_are_the_programs(name):
    from simple_vae_rs_tpu_torch import TrainConfig, Trainer

    parts = tiny_parts(name, dtype="float32")
    cfg, tr = parts["config"], parts["traffic"]
    fam = families.load(cfg)
    weights = data.make_weights(fam.param_spec(cfg), 5, "cpu")
    model = _port(cfg)
    data.load_into(model, weights)
    trainer = Trainer(model, TrainConfig(grad_clip_norm=tr["grad_clip_norm"]), device="cpu",
                      seed=11)
    tiles = data.make_tiles(8, 16, 7, "cpu")
    order = data.step_orders(3, 8, 2, 3)
    steps, moments = [], None
    for i in range(3):
        lr_t, hr_t = tiles["lr"][order[i]], tiles["hr"][order[i]]
        terms = trainer.train_step(fam.program_batch(cfg, lr_t, hr_t))
        steps.append({n: float(terms[n]) for n in fam.TERMS})
        if i == 0:
            moments = {n: float(m.norm()) for n, m in zip(trainer.params, trainer.opt.mu)}
    gen = data.generator(11, "cpu")
    batches, noises = [], []
    for i in range(3):
        streams = fam.streams(cfg, tiles["lr"][order[i]], tiles["hr"][order[i]])
        batches.append(streams)
        noises.append([torch.randn(s, generator=gen)
                       for s in fam.noise_shapes(cfg, streams[0].shape[0])])
    ref = rt.run_steps(fam.trainable(cfg), functools.partial(fam.loss, cfg), weights, batches,
                       noises, 1e-4, tr["grad_clip_norm"])
    # float32 through ~30 convs summed in other orders: 1e-5 of the loss; 1e-4 of a
    # KL term, a sum of positive and negative parts that cancel to a small total
    for got, want in zip(steps, ref["terms"]):
        assert set(got) == set(want)
        for n in want:
            assert got[n] == pytest.approx(want[n], rel=1e-5 if n == "loss" else 1e-4), n
    ref_m = {n: float(m.norm()) for n, m in ref["moments"].items()}
    med = statistics.median(ref_m.values())
    for n, v in ref_m.items():
        assert abs(moments[n] - v) <= 1e-4 * max(v, med), n
    for n, p in trainer.params.items():
        change = float((p.detach() - weights[n]).norm())
        want = float((ref["params"][n] - weights[n]).norm())
        if ref["first_grad_norms"][n] >= 1e-3 * statistics.median(ref["first_grad_norms"].values()):
            assert abs(change - want) <= 1e-2 * max(want, 1e-6), n


def test_reference_draws_are_the_programs():
    from simple_vae_rs_tpu_torch import SuperResolver

    parts = tiny_parts("cond_srvae.uq_bf16", dtype="float32")
    cfg = parts["config"]
    tiles = data.make_tiles(4, 16, 3, "cpu")
    fam = families.load(cfg)
    weights = data.make_weights(fam.param_spec(cfg), 5, "cpu", random_bn=True)
    model = _port(cfg)
    data.load_into(model, weights)
    y = rt.grid_patches(tiles["lr"], 8)[:1]
    out = SuperResolver(model, device="cpu").uncertainty(y, samples=40, chunk=None, seed=123)
    draws = fam.draws(cfg, weights, rt.normalize(y), data.generator(123, "cpu"), 40, models.F32)
    hwc = models.nhwc(draws)
    assert torch.allclose(hwc.mean(0), out["mean"], atol=2e-6)
    assert torch.allclose(hwc.std(0, correction=0), out["std"], atol=2e-6)


def test_rounding_controls_round():
    t = torch.tensor([1.0 + 2 ** -12, 3.0, -1.0 - 2 ** -11, 1e-3])
    assert models.round_tf32(t).tolist()[:3] == [1.0, 3.0, -1.0 - 2 ** -10]
    f8 = models.round_fp8(t)
    assert torch.all((f8 - t).abs() <= 0.07 * t.abs().max())
    assert not torch.equal(f8, t)
