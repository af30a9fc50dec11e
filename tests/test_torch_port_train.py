"""The port's training step against the JAX package, on the CPU.

Inputs and noise are made with numpy (or, for the step's noise, from the JAX
keys the JAX engine folds) and go through the JAX function and the port's
counterpart, which on the CPU runs its plain versions along the same routes
the card takes (input gradients through the flip-swapped kernels' plain
versions, weight gradients through the same library call). Float32 both.

Tolerances, with their reasons:

- row reductions and loss terms: rtol 1e-5 (one float32 reduction, summed in
  another order; every element term is >= 0, so nothing cancels);
- single conv gradients and BatchNorm: rtol 1e-4, atol 1e-5 (float32
  convolutions summed in another order);
- the model forward: rtol 1e-4, atol 2e-5, as the serving tests;
- one training step: loss terms rtol 1e-4; every gradient leaf
  max|port - JAX| <= 1e-4 * the largest |JAX gradient| in the leaf's block
  (its top-level module, e.g. ``yz_down3``): float32 through about 50 layers
  of backward, summed in other orders, and the bias of a conv that BatchNorm
  follows has a true gradient of 0, so its computed value is rounding noise
  of the block's gradients and no measure relative to the leaf itself holds
  (measured: at most 7e-6 of the block); BatchNorm statistics rtol 1e-4,
  atol 1e-5; parameters after the step |port - JAX| <= 2 * lr, because Adam's
  first step moves each weight by about lr * sign(g) whatever |g| is, so a
  gradient element near 0 (all of a bias that BatchNorm follows) may move
  either way, and for 99% of all the elements within 1e-2 * lr;
- clip + Adam on identical gradients: rtol 1e-5, atol 1e-8.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from simple_vae_rs_tpu.config import CondSRVAEConfig as JConfig
from simple_vae_rs_tpu.config import TrainConfig as JTrainConfig
from simple_vae_rs_tpu.models import CondSRVAE as JCondSRVAE
from simple_vae_rs_tpu.ops import losses as jlosses
from simple_vae_rs_tpu.ops import pallas_conv as pc
from simple_vae_rs_tpu.ops import pallas_elbo as pe
from simple_vae_rs_tpu.ops import patchify as jpatchify
from simple_vae_rs_tpu.train.engine import Trainer as JTrainer
from simple_vae_rs_tpu.train.state import make_optimizer as j_make_optimizer

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, TrainConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.ops import conv_blocks as tblocks
from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.ops import fused_elbo as fe
from simple_vae_rs_tpu_torch.ops import losses as tlosses
from simple_vae_rs_tpu_torch.ops import patchify as tpatchify
from simple_vae_rs_tpu_torch.train.engine import Trainer
from simple_vae_rs_tpu_torch.train.state import ClipAdam
from simple_vae_rs_tpu_torch.utils.jax_weights import _flatten, load_jax_variables
from tests.test_torch_port_conv import _random_bn

PS = 16
LR = 1e-4


def _t(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _close(got, want, rtol, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# --------------------------------------------------------------- row kernels
ROWS = {
    "sq_rows": (pe._sq_rows_impl, pe.sq_rows, 2),
    "kl_std_rows": (pe._kl_std_rows_impl, pe.kl_std_rows, 2),
    "kl_gen_rows": (pe._kl_gen_rows_impl, pe.kl_gen_rows, 4),
}


def _row_inputs(n_in, b, d, seed):
    rng = np.random.default_rng(seed)
    # (mu, logvar) pairs: logvars in [-3, 3]
    return [(rng.standard_normal((b, d)) if i % 2 == 0 else rng.uniform(-3, 3, (b, d)))
            .astype(np.float32) for i in range(n_in)]


@pytest.mark.parametrize("b,d", [(5, 37), (8, 256), (13, 1030)])
@pytest.mark.parametrize("name", list(ROWS))
def test_row_reduction_and_grads_match_jax(name, b, d):
    impl, vjp_fn, n_in = ROWS[name]
    inputs = _row_inputs(n_in, b, d, seed=b * d)
    want = impl(*inputs, interpret=True)  # the Pallas kernel in interpret mode
    got_plain = fe.PLAIN[name](*_t(*inputs))
    tin = [t.requires_grad_() for t in _t(*inputs)]
    got = getattr(fe, name)(*tin)  # CPU tensors: the plain version
    _close(got_plain, want, 1e-5, 1e-5)
    assert torch.equal(got.detach(), got_plain)
    cot = np.random.default_rng(d).standard_normal(b).astype(np.float32)
    _, pullback = jax.vjp(vjp_fn, *inputs)
    want_grads = pullback(jnp.asarray(cot))
    got_grads = torch.autograd.grad(got, tin, torch.from_numpy(cot))
    for g, w in zip(got_grads, want_grads):
        _close(g, w, 1e-5, 1e-6)


def test_row_plan_covers_columns():
    for b, d in [(512, 16384), (512, 3392), (16, 13568), (5, 37), (1, 1), (3, 4096)]:
        chunk, parts = fe.plan(b, d)
        assert chunk % 4 == 0 and (parts - 1) * chunk < d <= parts * chunk
        if b >= 2 * fe._SMS:
            assert parts == 1
        elif d >= 2 * 4 * fe._THREADS:
            assert parts > 1


def _loss_inputs(seed, b=3):
    rng = np.random.default_rng(seed)
    x, y = rng.random((b, 8, 8, 4)), rng.random((b, 4, 4, 4))
    x_hat, y_hat = rng.random(x.shape), rng.random(y.shape)
    lat = [rng.standard_normal((b, 24)) if i % 2 == 0 else rng.uniform(-2, 2, (b, 24))
           for i in range(6)]
    gammas = rng.uniform(0.5, 1.5, 2)
    return [np.asarray(a, np.float32) for a in (x_hat, x, y_hat, y, *lat, *gammas)]


def test_fused_losses_match_jax_losses():
    args = _loss_inputs(0)
    want = jlosses.cond_loss(*args)
    got = fe.fused_cond_loss(*_t(*args))
    got_ref = tlosses.cond_loss(*_t(*args))
    for g, r, w in zip(got, got_ref, want):
        _close(g, w, 1e-5, 1e-5)
        _close(r, w, 1e-5, 1e-5)
    base = (args[0], args[1], args[4], args[5], args[10])
    for g, w in zip(fe.fused_base_loss(*_t(*base)), jlosses.base_loss(*base)):
        _close(g, w, 1e-5, 1e-5)


def test_row_wrappers_reject_other_devices():
    a, b = _t(*_row_inputs(2, 2, 4, 0))
    with pytest.raises(ValueError):
        fe.sq_rows(a.to("meta"), b.to("meta"))


# --------------------------------------------------------- conv gradients
_JAX_GRAD = {
    "fused_conv3x3_bn_relu": (pc.fused_conv3x3_bn_relu_grad, 3),
    "fused_conv4x4s2_bn_relu": (pc.fused_conv4x4s2_bn_relu_grad, 4),
    "fused_convT4x4s2_bn_relu": (pc.fused_convT4x4s2_bn_relu_grad, 4),
}


@pytest.mark.parametrize("name,shape,o", [
    ("fused_conv3x3_bn_relu", (2, 6, 5, 4), 7),
    ("fused_conv3x3_bn_relu", (1, 4, 4, 24), 16),
    ("fused_conv4x4s2_bn_relu", (2, 8, 6, 5), 6),
    ("fused_convT4x4s2_bn_relu", (2, 3, 5, 6), 5),
])
def test_conv_function_grads_match_jax_vjp(name, shape, o):
    fn, k = _JAX_GRAD[name]
    rng = np.random.default_rng(sum(shape) + o)
    x = rng.standard_normal(shape).astype(np.float32)
    kern = (rng.standard_normal((k, k, shape[-1], o)) * 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, o).astype(np.float32)
    shift = rng.standard_normal(o).astype(np.float32)
    out, pullback = jax.vjp(lambda *a: fn(*a, True), x, kern, scale, shift)
    g = rng.standard_normal(out.shape).astype(np.float32)
    want = pullback(jnp.asarray(g))
    tin = [t.requires_grad_() for t in _t(x, kern, scale, shift)]
    got_out = fc.fused_conv(name, *tin, True)
    _close(got_out, out, 1e-4, 1e-5)
    got = torch.autograd.grad(got_out, tin, torch.from_numpy(g))
    for what, gg, w in zip(("dx", "dk", "dscale", "dshift"), got, want):
        assert gg.shape == w.shape, what
        np.testing.assert_allclose(gg.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=what)


def test_conv_function_skips_dx_of_data_inputs():
    x, kern, s, t = _t(*[np.ones(s, np.float32) for s in ((1, 4, 4, 2), (3, 3, 2, 3),
                                                         (3,), (3,))])
    kern.requires_grad_()
    out = fc.fused_conv("fused_conv3x3_bn_relu", x, kern, s, t, False)
    (dk,) = torch.autograd.grad(out.sum(), [kern])
    assert dk.shape == kern.shape and not x.requires_grad


def test_conv4x4s2_dx_route_matches_pallas_convT():
    """The 4x4/s2 input gradient is the convT kernel on the flip-swapped
    weight: the port's route against JAX ``conv4x4s2_dx`` running the Pallas
    convT kernel in interpret mode."""
    rng = np.random.default_rng(9)
    g = rng.standard_normal((2, 4, 3, 12)).astype(np.float32)
    kern = (rng.standard_normal((4, 4, 5, 12)) * 0.2).astype(np.float32)
    want = pc.conv4x4s2_dx(g, kern, interpret=True)
    got = fc.input_grad("fused_conv4x4s2_bn_relu", *_t(g, kern), (2, 8, 6, 5))
    _close(got, want, 1e-4, 1e-5)
    with pytest.raises(ValueError):
        fc.input_grad("fused_conv4x4s2_bn_relu", *_t(g, kern), (2, 9, 6, 5))


# --------------------------------------------------------------- BatchNorm
def test_batchnorm_train_matches_flax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 4, 6)) * 2 + 1).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    stats = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    want, new = bn.apply({"params": params, "batch_stats": stats}, x,
                         mutable=["batch_stats"])
    tbn = tblocks.BatchNorm(6)
    load_jax_variables(tbn, {"params": params, "batch_stats": stats})
    got = tbn(torch.from_numpy(x))
    _close(got, want, 1e-4, 1e-5)
    _close(tbn.mean, new["batch_stats"]["mean"], 1e-4, 1e-5)
    _close(tbn.var, new["batch_stats"]["var"], 1e-4, 1e-5)


# ------------------------------------------------------- training forward
def _jax_eps(rng, cfg, b):
    """The noise JAX ``CondSRVAE.__call__`` draws from ``rng``."""
    rng_u, rng_z = jax.random.split(rng)
    g = cfg.patch_size // 8
    return (np.asarray(jax.random.normal(rng_u, (b, g, g, cfg.u_channels))),
            np.asarray(jax.random.normal(rng_z, (b, g, g, cfg.z_channels))))


# ------------------------------------------------------------ training step
@pytest.fixture(scope="module")
def jax_setup():
    """A JAX Trainer's initial state on a batch of 8 patch pairs, and the
    jitted ``_micro_grads`` at the microbatch of 4 (shared by both
    accumulation settings)."""
    jmodel = JCondSRVAE(JConfig(cr=2.0, patch_size=PS))
    rng = np.random.default_rng(11)
    y = rng.random((8, PS // 2, PS // 2, 4)).astype(np.float32)
    x = rng.random((8, PS, PS, 4)).astype(np.float32)
    j1 = JTrainer(jmodel, JTrainConfig(learning_rate=LR))
    state = j1.init_state((y[:4], x[:4]))
    state0 = jax.tree_util.tree_map(np.array, jax.device_get(state))
    return jmodel, j1, state0, (y, x), jax.jit(j1._micro_grads)


@pytest.mark.parametrize("torch_regroup", [False, True], ids=["pixel_shuffle", "torch_regroup"])
def test_training_forward_matches_jax(jax_setup, torch_regroup):
    _, _, state0, _, _ = jax_setup  # the regroup mode changes no parameter
    jcfg = JConfig(cr=2.0, patch_size=PS, torch_regroup=torch_regroup)
    jmodel = JCondSRVAE(jcfg)
    rng = np.random.default_rng(5)
    x = rng.random((4, PS, PS, 4)).astype(np.float32)
    y = rng.random((4, PS // 2, PS // 2, 4)).astype(np.float32)
    variables = _random_bn({"params": state0.params, "batch_stats": state0.batch_stats}, seed=6)
    key = jax.random.PRNGKey(7)
    want, new = jax.jit(lambda v, a, b, k: jmodel.apply(
        v, a, b, k, train=True, mutable=["batch_stats"]))(variables, x, y, key)
    tmodel = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS, torch_regroup=torch_regroup))
    load_jax_variables(tmodel, variables)
    tmodel.train()
    got = tmodel(*_t(x, y, *_jax_eps(key, jcfg, 4)))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        _close(g, w, 1e-4, 2e-5)
    stats = dict(tmodel.named_buffers())
    for name, w in _flatten(new["batch_stats"]).items():
        _close(stats[name], w, 1e-4, 1e-5)


def _port_trainer(state0, accum):
    tmodel = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS))
    load_jax_variables(tmodel, {"params": state0.params, "batch_stats": state0.batch_stats})
    return Trainer(tmodel, TrainConfig(learning_rate=LR, accum_steps=accum), device="cpu")


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(jax_setup, accum):
    jmodel, j1, state0, (y, x), micro_grads = jax_setup
    b = 4 * accum
    batch = (y[:b], x[:b])
    step_rng = jax.random.fold_in(state0.rng, 0)
    rngs = [step_rng] if accum == 1 else [jax.random.fold_in(step_rng, i) for i in range(accum)]
    eps = [tuple(_t(*_jax_eps(r, jmodel.config, 4))) for r in rngs]

    # JAX: the grads of each microbatch (stats threaded), averaged; then one step
    stats, want_grads = state0.batch_stats, None
    for i, r in enumerate(rngs):
        mb = (jnp.asarray(y[4 * i:4 * i + 4]), jnp.asarray(x[4 * i:4 * i + 4]))
        g, _, stats = micro_grads(state0.params, stats, mb, r)
        g = _flatten(jax.device_get(g))
        want_grads = g if want_grads is None else {k: want_grads[k] + v for k, v in g.items()}
    want_grads = {k: v / accum for k, v in want_grads.items()}
    jt = j1 if accum == 1 else JTrainer(jmodel, JTrainConfig(learning_rate=LR, accum_steps=2))
    jstate = jax.tree_util.tree_map(jnp.asarray, state0)
    new_state, want_terms = jt._train_step(jstate, tuple(map(jnp.asarray, batch)),
                                           jnp.float32(LR))
    want_params = _flatten(jax.device_get(new_state.params))
    want_stats = _flatten(jax.device_get(new_state.batch_stats))

    trainer = _port_trainer(state0, accum)
    grads, _ = trainer.grads_and_terms(batch, eps)
    block_max = {}
    for name, w in want_grads.items():
        blk = name.split(".")[0]
        block_max[blk] = max(block_max.get(blk, 0.0), float(np.abs(w).max()))
    for name, w in want_grads.items():
        err = float(np.abs(grads[name].numpy() - w).max())
        assert err <= 1e-4 * block_max[name.split(".")[0]], (name, err)

    trainer = _port_trainer(state0, accum)  # fresh: grads_and_terms moved the stats
    terms = trainer.train_step(batch, eps=eps)
    for key, w in want_terms.items():
        _close(terms[key], w, 1e-4, 1e-6)
    buffers = dict(trainer.model.named_buffers())
    for name, w in want_stats.items():
        _close(buffers[name], w, 1e-4, 1e-5)
    diffs = []
    for name, w in want_params.items():
        diff = np.abs(trainer.params[name].detach().numpy() - w).ravel()
        assert diff.max() <= 2 * LR * (1 + 1e-3), name
        diffs.append(diff)
    assert np.mean(np.concatenate(diffs) <= 1e-2 * LR) >= 0.99
    assert trainer.step == 1


def test_trainer_draws_noise_and_validates(jax_setup, monkeypatch):
    _, _, state0, (y, x), _ = jax_setup
    trainer = _port_trainer(state0, 1)
    a = trainer.val_step((y[:4], x[:4]))
    b = trainer.val_step((y[:4], x[:4]))
    assert {k: float(v) for k, v in a.items()} == {k: float(v) for k, v in b.items()}
    assert not trainer.model.training
    terms = trainer.train_step((y[:4], x[:4]))
    assert all(np.isfinite(float(v)) for v in terms.values())
    assert trainer.model.training
    with pytest.raises(ValueError):
        _port_trainer(state0, 3).train_step((y[:4], x[:4]))
    with pytest.raises(NotImplementedError):
        TrainConfig(use_bfloat16=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Trainer(trainer.model)  # the default device is the card


# --------------------------------------------------------------- optimizer
def test_clip_adam_matches_optax():
    rng = np.random.default_rng(12)
    shapes = [(3, 4), (5,), ()]
    params = [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]
    tx = j_make_optimizer(JTrainConfig())
    jstate = tx.init(params)
    opt = ClipAdam(_t(*params))
    # global norms over, under, and over 1: the clip engages, idles, engages
    for step, scale in enumerate((3.0, 0.05, 10.0)):
        grads = [np.asarray(rng.standard_normal(s) * scale / 3, np.float32) for s in shapes]
        norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in grads)))
        assert (norm > 1.0) == (step != 1)
        want, jstate = tx.update(grads, jstate, params)
        got = opt.update(_t(*grads))
        _close(opt.global_norm(_t(*grads)), np.float32(norm), 1e-5, 0)
        for g, w in zip(got, want):
            _close(g, w, 1e-5, 1e-8)
    assert opt.count == 3


# ----------------------------------------------------------------- patchify
def test_grid_sr_batch_matches_jax():
    rng = np.random.default_rng(13)
    lr_tiles = (rng.random((2, 16, 20, 4)) * 1000).astype(np.float32)
    hr_tiles = (rng.random((2, 32, 40, 4)) * 1000).astype(np.float32)
    want = jpatchify.grid_sr_batch(jnp.asarray(lr_tiles), jnp.asarray(hr_tiles), 16)
    got = tpatchify.grid_sr_batch(*_t(lr_tiles, hr_tiles), 16)
    for g, w in zip(got, want):
        _close(g, w, 1e-6, 1e-6)
    patches = tpatchify.grid_patchify(torch.from_numpy(hr_tiles[:, :32, :32]), 16)
    assert torch.equal(tpatchify.grid_unpatchify(patches, 2), torch.from_numpy(hr_tiles[:, :32, :32]))
