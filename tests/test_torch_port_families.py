"""The port's VAE and SRVAE families, chained serving and the task
statistics, against the JAX package, on the CPU.

Each flax model is initialised at a small configuration, its BatchNorm
parameters and statistics are randomised with numpy, and the tree is carried
into the port with ``load_jax_variables``. Inputs are made with numpy; noise
is made with numpy and injected on both sides, or, where the JAX entry point
draws its own (the models' ``__call__``, the JAX ``SuperResolver``, the JAX
``Trainer``), drawn from the same JAX keys and handed to the port. The port
runs its plain versions, with the chain switched on where the test says so
(on the CPU the JAX package never chains, so chained port == unchained JAX).

Tolerances, as the files for Cond_SRVAE state them and for the same reasons:
model and serving outputs rtol 1e-4, atol 2e-5 (float32 through ~25
convolutions, summed in other orders); BatchNorm statistics rtol 1e-4, atol
1e-5; a training step's loss terms rtol 1e-4, each gradient leaf within 1e-4
of the largest |JAX gradient| in its block, parameters after the step within
2 * lr and 99% of all elements within 1e-2 * lr (see
``tests/test_torch_port_train.py``); the task statistics rtol 1e-5, atol 1e-6
(plain reductions of the same numbers); configurations exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simple_vae_rs_tpu import tasks as jtasks
from simple_vae_rs_tpu.config import CondSRVAEConfig as JCondConfig
from simple_vae_rs_tpu.config import TrainConfig as JTrainConfig
from simple_vae_rs_tpu.config import VAEConfig as JVAEConfig
from simple_vae_rs_tpu.models import CondSRVAE as JCondSRVAE
from simple_vae_rs_tpu.models.srvae import SRVAE as JSRVAE
from simple_vae_rs_tpu.models.srvae import box_downsample_2x as j_box_downsample_2x
from simple_vae_rs_tpu.models.vae import VAE as JVAE
from simple_vae_rs_tpu.ops import pallas_conv as pc
from simple_vae_rs_tpu.serve import SuperResolver as JSuperResolver
from simple_vae_rs_tpu.train.engine import Trainer as JTrainer
from simple_vae_rs_tpu.utils.image import normalize_image as j_normalize_image

from simple_vae_rs_tpu_torch import tasks as ttasks
from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, TrainConfig, VAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.srvae import SRVAE, box_downsample_2x
from simple_vae_rs_tpu_torch.models.vae import VAE
from simple_vae_rs_tpu_torch.ops import conv_blocks as tblocks
from simple_vae_rs_tpu_torch.serve import SuperResolver
from simple_vae_rs_tpu_torch.train.engine import TERMS, VAE_TERMS, Trainer
from simple_vae_rs_tpu_torch.utils.jax_weights import _flatten, load_jax_variables
from tests.test_torch_port_conv import _random_bn

RTOL, ATOL = 1e-4, 2e-5
PS = 16
LR = 1e-4


def _t(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture(scope="module", autouse=True)
def pallas_on():
    """The JAX models with the Pallas switch on, as they are served (on the
    CPU their fused kernels fall through to their references)."""
    prev = pc.is_enabled()
    pc.enable(True)
    yield
    pc.enable(prev)


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("cr", [1.2, 1.5, 2.0, 3.0, 4.0, 7.5])
@pytest.mark.parametrize("ps", [16, 32, 64, 128])
def test_vae_config_matches_jax(cr, ps):
    want, got = JVAEConfig(cr=cr, patch_size=ps), VAEConfig(cr=cr, patch_size=ps)
    for field in ("latent_size", "latent_channels", "latent_spatial", "latent_dim"):
        assert getattr(got, field) == getattr(want, field), field
    over = VAEConfig(cr=cr, patch_size=ps, latent_size_override=640)
    assert over.latent_size == JVAEConfig(cr=cr, patch_size=ps,
                                          latent_size_override=640).latent_size == 640
    with pytest.raises(ValueError):
        VAEConfig(latent_size_override=100)


def test_canonical_vae_param_count():
    model = VAE(VAEConfig(cr=1.5, patch_size=32), device="meta")
    assert model.config.latent_channels == 42
    jmodel = JVAE(JVAEConfig(cr=1.5, patch_size=32))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 4)), jax.random.PRNGKey(1),
        train=False))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == want == 805_562 + 1  # + gamma


# --------------------------------------------------------------------- VAE
@pytest.fixture(scope="module")
def vae_pair():
    """(jax VAE, flax variables with non-trivial BatchNorm, port VAE)."""
    jmodel = JVAE(JVAEConfig(cr=2.0, patch_size=PS))
    variables = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, PS, PS, 4)),
                            jax.random.PRNGKey(1), train=False)
    variables = _random_bn(variables, seed=5)
    tmodel = VAE(VAEConfig(cr=2.0, patch_size=PS))
    load_jax_variables(tmodel, variables)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("chain", [False, True], ids=["conv_by_conv", "chained"])
def test_vae_eval_pieces_match_jax(vae_pair, chain):
    jmodel, variables, tmodel = vae_pair
    rng = np.random.default_rng(6)
    x = rng.random((3, PS, PS, 4)).astype(np.float32)
    z = rng.standard_normal((3, tmodel.config.latent_dim)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    eps = np.asarray(jax.random.normal(key, z.shape))  # what JAX ``reparameterize`` draws
    want_mu, want_lv = jmodel.apply(variables, x, False, method=JVAE.encode)
    want_dec = jmodel.apply(variables, z, False, method=JVAE.decode)
    want_fwd = jmodel.apply(variables, x, key, train=False)
    tmodel.eval()
    tblocks.use_chain(tmodel, chain)
    try:
        with torch.no_grad():
            mu, lv = tmodel.encode(*_t(x))
            dec = tmodel.decode(*_t(z))
            fwd = tmodel(*_t(x, eps))
    finally:
        tblocks.use_chain(tmodel, False)
    for g, w in ((mu, want_mu), (lv, want_lv), (dec, want_dec), *zip(fwd, want_fwd)):
        _close(g, w)
    assert mu.shape == (3, tmodel.config.latent_dim) and dec.shape == (3, PS, PS, 4)


def test_vae_training_forward_matches_jax(vae_pair):
    jmodel, variables, _ = vae_pair
    x = np.random.default_rng(7).random((4, PS, PS, 4)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    eps = np.asarray(jax.random.normal(key, (4, jmodel.config.latent_dim)))
    want, new = jmodel.apply(variables, x, key, train=True, mutable=["batch_stats"])
    tmodel = VAE(VAEConfig(cr=2.0, patch_size=PS))
    load_jax_variables(tmodel, variables)
    tblocks.use_chain(tmodel)  # no effect in training mode
    got = tmodel.train()(*_t(x, eps))
    for g, w in zip(got, want):
        _close(g, w)
    stats = dict(tmodel.named_buffers())
    for name, w in _flatten(new["batch_stats"]).items():
        _close(stats[name], w, 1e-4, 1e-5)


def test_vae_sample_chunked_matches_jax_with_injected_noise(vae_pair):
    jmodel, variables, tmodel = vae_pair
    rng = np.random.default_rng(10)
    y = rng.random((1, PS, PS, 4)).astype(np.float32)
    samples = 5
    eps = rng.standard_normal((samples, tmodel.config.latent_dim)).astype(np.float32)

    def draws(m, y, eps):
        mu, logvar = m.encode(y, train=False)
        return m.decode(mu + eps * jnp.exp(0.5 * logvar), train=False)

    want = jmodel.apply(variables, y, eps, method=draws)
    tmodel.eval()
    tblocks.use_chain(tmodel)
    try:
        got = ttasks.sample_chunked(tmodel, *_t(y), samples=samples, chunk=2, eps_z=_t(eps)[0])
        one = tmodel.sample(*_t(y), samples=samples, eps=_t(eps)[0])
        gen = ttasks.sample_chunked(tmodel, *_t(y), torch.Generator().manual_seed(0),
                                    samples=3, chunk=2)
    finally:
        tblocks.use_chain(tmodel, False)
    _close(got, want)
    _close(one, want)
    assert gen.shape == (3, PS, PS, 4) and float(gen.std(dim=0).max()) > 0
    with pytest.raises(TypeError):
        ttasks.sample_chunked(torch.nn.Identity(), *_t(y))


# ------------------------------------------------------------------- SRVAE
@pytest.fixture(scope="module", params=[False, True], ids=["pixel_shuffle", "torch_regroup"])
def srvae_pair(request):
    jcfg = JCondConfig(cr=2.0, patch_size=PS, torch_regroup=request.param)
    jmodel = JSRVAE(jcfg)
    variables = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, PS, PS, 4)),
                            jax.random.PRNGKey(1), train=False)
    variables = _random_bn(variables, seed=11)
    assert set(variables["params"]) == {"core"}
    tmodel = SRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS, torch_regroup=request.param))
    load_jax_variables(tmodel, variables)
    return jmodel, variables, tmodel


def _cond_eps(key, cfg, batch):
    """The noise JAX ``CondSRVAE.__call__`` draws from ``key``."""
    rng_u, rng_z = jax.random.split(key)
    g = cfg.patch_size // 8
    return (np.asarray(jax.random.normal(rng_u, (batch, g, g, cfg.u_channels))),
            np.asarray(jax.random.normal(rng_z, (batch, g, g, cfg.z_channels))))


def test_box_downsample_matches_jax():
    x = np.random.default_rng(12).standard_normal((2, 8, 12, 3)).astype(np.float32)
    _close(box_downsample_2x(*_t(x)), j_box_downsample_2x(jnp.asarray(x)), 1e-6, 1e-6)


@pytest.mark.parametrize("train", [False, True], ids=["eval_chained", "train"])
def test_srvae_forward_nine_tuple_matches_jax(srvae_pair, train):
    jmodel, variables, tmodel = srvae_pair
    x = np.random.default_rng(13).random((3, PS, PS, 4)).astype(np.float32)
    key = jax.random.PRNGKey(14)
    eps = _cond_eps(key, jmodel.config, 3)
    if train:
        want, new = jmodel.apply(variables, x, key, train=True, mutable=["batch_stats"])
        fresh = SRVAE(tmodel.config)
        load_jax_variables(fresh, variables)
        got = fresh.train()(*_t(x, *eps))
        stats = dict(fresh.named_buffers())
        for name, w in _flatten(new["batch_stats"]).items():
            _close(stats[name], w, 1e-4, 1e-5)
    else:
        want = jmodel.apply(variables, x, key, train=False)
        tblocks.use_chain(tmodel.eval())
        try:
            with torch.no_grad():
                got = tmodel(*_t(x, *eps))
        finally:
            tblocks.use_chain(tmodel, False)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        _close(g, w)
    _close(got[8], j_box_downsample_2x(jnp.asarray(x)), 1e-6, 1e-6)


def test_srvae_serving_pieces_match_jax(srvae_pair):
    """HR-sized and LR-sized inputs through ``conditional_generation_eps`` and
    the SRVAE branch of ``sample_chunked``, on injected noise."""
    jmodel, variables, tmodel = srvae_pair
    cfg = tmodel.config
    rng = np.random.default_rng(15)
    g = PS // 8
    hr = rng.random((2, PS, PS, 4)).astype(np.float32)
    lr = rng.random((2, PS // 2, PS // 2, 4)).astype(np.float32)
    eps_u = rng.standard_normal((2, g, g, cfg.u_channels)).astype(np.float32)
    eps_z = rng.standard_normal((2, g, g, cfg.z_channels)).astype(np.float32)
    samples = 4
    eps_draws = rng.standard_normal((samples, g, g, cfg.z_channels)).astype(np.float32)

    def draws(m, y, eps_u, eps_z):  # JAX ``tasks._cond_prep_method`` and the chunk decode
        core = m.core
        if y.shape[1] == m.config.patch_size:
            y = j_box_downsample_2x(y)
        mu_u, lv_u = core.encode_y(y, train=False)
        y_feat = core.y_embedding(y, train=False)
        mu_p, lv_p = core.z_cond(y_feat, mu_u + eps_u * jnp.exp(0.5 * lv_u), train=False)
        z = mu_p + eps_z * jnp.exp(0.5 * lv_p)
        yf = jnp.broadcast_to(y_feat, (samples,) + y_feat.shape[1:])
        return core.decode_x_from_features(z, yf, train=False)

    tmodel.eval()
    assert tmodel.generation_noise_shapes(2, (PS, PS)) == tmodel.generation_noise_shapes(
        2, (PS // 2, PS // 2)) == (eps_u.shape, eps_z.shape)
    for y in (hr, lr):
        want = jmodel.apply(variables, y, eps_u, eps_z, method=JSRVAE.conditional_generation_eps)
        with torch.no_grad():
            got = tmodel.conditional_generation_eps(*_t(y, eps_u, eps_z))
        _close(got, want)
        want_draws = jmodel.apply(variables, y[:1], eps_u[:1], eps_draws, method=draws)
        got_draws = ttasks.sample_chunked(tmodel, *_t(y[:1]), samples=samples, chunk=3,
                                          eps_u=_t(eps_u[:1])[0], eps_z=_t(eps_draws)[0])
        _close(got_draws, want_draws)
    gen = torch.Generator().manual_seed(3)
    y_hat, x_hat = tmodel.generation(gen)
    assert y_hat.shape == (1, PS // 2, PS // 2, 4) and x_hat.shape == (1, PS, PS, 4)
    assert tmodel.conditional_generation(*_t(hr), gen).shape == (2, PS, PS, 4)


def test_load_jax_variables_carries_and_checks_the_family_trees(vae_pair, srvae_pair):
    _, vvars, tvae = vae_pair
    _, svars, tsr = srvae_pair
    np.testing.assert_array_equal(tvae.enc_head.kernel.detach().numpy(),
                                  np.asarray(vvars["params"]["enc_head"]["kernel"]))
    np.testing.assert_array_equal(tsr.core.dx_up1.bn.var.numpy(),
                                  np.asarray(svars["batch_stats"]["core"]["dx_up1"]["bn"]["var"]))
    with pytest.raises(KeyError):  # a Cond_SRVAE tree is no SRVAE tree: no ``core``
        load_jax_variables(SRVAE(tsr.config), {"params": svars["params"]["core"],
                                               "batch_stats": svars["batch_stats"]["core"]})
    with pytest.raises(KeyError, match="gamma"):
        load_jax_variables(VAE(tvae.config), {
            "params": {k: v for k, v in vvars["params"].items() if k != "gamma"},
            "batch_stats": vvars["batch_stats"]})


# ------------------------------------------------- the task statistics
def test_error_statistics_and_uncertainty_maps_match_jax(vae_pair):
    rng = np.random.default_rng(16)
    draws = rng.random((7, 6, 5, 4)).astype(np.float32)
    target = rng.random((1, 6, 5, 4)).astype(np.float32)
    want = jtasks.error_statistics(jnp.asarray(draws), jnp.asarray(target))
    got = ttasks.error_statistics(*_t(draws, target))
    assert set(got) == set(want)
    for key, w in want.items():
        _close(got[key], w, 1e-5, 1e-6)
    _, _, tmodel = vae_pair
    y = _t(rng.random((1, PS, PS, 4)))[0]
    tmodel.eval()
    maps = ttasks.uncertainty_maps(tmodel, y, torch.Generator().manual_seed(4), samples=6, chunk=4)
    same = ttasks.sample_chunked(tmodel, y, torch.Generator().manual_seed(4), samples=6, chunk=4)
    for key, w in (("mean", jnp.mean), ("variance", jnp.var), ("std", jnp.std)):  # JAX's maps
        _close(maps[key], w(jnp.asarray(same.numpy()), axis=0), 1e-5, 1e-6)


# ------------------------------------------- chained serving against JAX
@pytest.mark.parametrize("torch_regroup", [False, True], ids=["pixel_shuffle", "torch_regroup"])
def test_chained_resolver_matches_the_jax_resolver(torch_regroup):
    """``SuperResolver(chain=True)`` against the JAX ``SuperResolver`` on
    carried-over weights: the JAX resolver draws its noise from the request's
    seed; the same draws go through the port's chained resolver model."""
    jcfg = JCondConfig(cr=2.0, patch_size=PS, torch_regroup=torch_regroup)
    jmodel = JCondSRVAE(jcfg)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, PS, PS, 4)),
        jnp.zeros((1, PS // 2, PS // 2, 4)), jax.random.PRNGKey(1), train=False)
    variables = _random_bn(variables, seed=17)
    jsr = JSuperResolver(jmodel, variables, seed=3)
    tmodel = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS, torch_regroup=torch_regroup))
    load_jax_variables(tmodel, variables)
    sr = SuperResolver(tmodel, device="cpu", seed=3, chain=True)
    assert sr.model is not tmodel and sr.model.chain and not tmodel.chain

    y = (np.random.default_rng(18).random((3, PS // 2, PS // 2, 4)) * 900).astype(np.float32)
    g = PS // 8
    want = jsr.super_resolve(y, seed=5)
    _, k_u, k_z = jax.random.split(jax.random.PRNGKey(5), 3)  # JAX ``_sr_call``'s keys
    eps_u = np.asarray(jax.random.normal(k_u, (3, g, g, jcfg.u_channels)))
    eps_z = np.asarray(jax.random.normal(k_z, (3, g, g, jcfg.z_channels)))
    with torch.no_grad():
        got = sr.model.conditional_generation_eps(sr._input(y, True), *_t(eps_u, eps_z))
    _close(got, want)

    samples, chunk = 5, 2
    want_maps = jsr.uncertainty(y[0], samples=samples, chunk=chunk, seed=6)
    rng_u, rng_z = jax.random.split(jax.random.PRNGKey(6))  # JAX ``sample_chunked``'s keys
    eps_u = np.asarray(jax.random.normal(rng_u, (1, g, g, jcfg.u_channels)))
    eps_draws = np.concatenate([
        np.asarray(jax.random.normal(jax.random.fold_in(rng_z, i), (chunk, g, g, jcfg.z_channels)))
        for i in range(-(-samples // chunk))])[:samples]
    draws = ttasks.sample_chunked(sr.model, sr._input(y[0], True)[:1], samples=samples,
                                  chunk=chunk, eps_u=_t(eps_u)[0], eps_z=_t(eps_draws)[0])
    _close(draws.mean(dim=0), want_maps["mean"])
    _close(draws.std(dim=0, correction=0), want_maps["std"], RTOL, 1e-4)
    # the JAX resolver normalizes as the port's does
    _close(sr._input(y, True), j_normalize_image(jnp.asarray(y)), 1e-6, 1e-6)


def test_resolver_serves_an_srvae_and_rejects_a_vae(srvae_pair, vae_pair):
    _, _, tsr = srvae_pair
    sr = SuperResolver(tsr, device="cpu", seed=1, chain=True)
    rng = np.random.default_rng(19)
    hr = (rng.random((2, PS, PS, 4)) * 500).astype(np.float32)
    out = sr.super_resolve(hr, seed=2)
    lr_view = box_downsample_2x(sr._input(hr, True))
    assert torch.equal(out, sr.super_resolve(lr_view, normalize=False, seed=2))
    maps = sr.uncertainty(hr[0][:PS // 2, :PS // 2], samples=3, seed=4)
    assert out.shape == (2, PS, PS, 4) and maps["std"].shape == (PS, PS, 4)
    plain = SuperResolver(tsr, device="cpu", seed=1)
    torch.testing.assert_close(plain.super_resolve(hr, seed=2), out, rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        SuperResolver(vae_pair[2], device="cpu")


# ------------------------------------------------------ one training step
def _step_case(kind):
    # (seed 20 puts one BatchNorm output of dx_up2 1e-8 from the ReLU's kink,
    # where float32 and float64 take different sides: a gradient that no
    # tolerance holds)
    rng = np.random.default_rng(23)
    y = rng.random((4, PS // 2, PS // 2, 4)).astype(np.float32)
    x = rng.random((4, PS, PS, 4)).astype(np.float32)
    if kind == "vae":  # trains on the LR stream: patches of ps / 2
        jmodel = JVAE(JVAEConfig(cr=2.0, patch_size=PS // 2))
        tmodel = VAE(VAEConfig(cr=2.0, patch_size=PS // 2))
    else:
        jmodel = JSRVAE(JCondConfig(cr=2.0, patch_size=PS))
        tmodel = SRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS))
    return jmodel, tmodel, (y, x)


@pytest.mark.parametrize("kind", ["vae", "srvae"])
def test_train_and_val_step_of_the_new_kinds_match_jax(kind):
    jmodel, tmodel, batch = _step_case(kind)
    jt = JTrainer(jmodel, JTrainConfig(learning_rate=LR))
    assert jt.kind == kind
    state0 = jax.tree_util.tree_map(np.array, jax.device_get(jt.init_state(batch)))
    load_jax_variables(tmodel, {"params": state0.params, "batch_stats": state0.batch_stats})
    tblocks.use_chain(tmodel)  # the val step chains; the train step must not
    trainer = Trainer(tmodel, TrainConfig(learning_rate=LR), device="cpu")
    assert trainer.kind == kind

    def eps_of(key):
        if kind == "vae":
            return _t(jax.random.normal(key, (4, jmodel.config.latent_dim)))
        return _t(*_cond_eps(key, jmodel.config, 4))

    jbatch = tuple(map(jnp.asarray, batch))
    want_val = jt._val_step(jax.tree_util.tree_map(jnp.asarray, state0), jbatch)
    val = trainer.val_step(batch, eps=eps_of(jax.random.fold_in(state0.rng, 0xFFF1)))
    assert tuple(val) == (VAE_TERMS if kind == "vae" else TERMS)
    for key, w in want_val.items():
        _close(val[key], w, 1e-4, 1e-6)

    step_rng = jax.random.fold_in(state0.rng, 0)
    want_grads, _, _ = jax.jit(jt._micro_grads)(state0.params, state0.batch_stats, jbatch,
                                                step_rng)
    want_grads = _flatten(jax.device_get(want_grads))
    new_state, want_terms = jt._train_step(jax.tree_util.tree_map(jnp.asarray, state0), jbatch,
                                           jnp.float32(LR))
    stats0 = {k: v.clone() for k, v in tmodel.state_dict().items()}
    grads, _ = trainer.grads_and_terms(batch, eps_of(step_rng))

    def block(name):
        parts = name.split(".")
        return parts[1] if parts[0] == "core" else parts[0]

    block_max = {}
    for name, w in want_grads.items():
        block_max[block(name)] = max(block_max.get(block(name), 0.0), float(np.abs(w).max()))
    assert set(grads) == set(want_grads)
    for name, w in want_grads.items():
        err = float(np.abs(grads[name].numpy() - w).max())
        assert err <= 1e-4 * block_max[block(name)], (name, err)

    tmodel.load_state_dict(stats0)  # grads_and_terms moved the running statistics
    terms = trainer.train_step(batch, eps=eps_of(step_rng))
    for key, w in want_terms.items():
        _close(terms[key], w, 1e-4, 1e-6)
    buffers = dict(tmodel.named_buffers())
    for name, w in _flatten(jax.device_get(new_state.batch_stats)).items():
        _close(buffers[name], w, 1e-4, 1e-5)
    diffs = []
    for name, w in _flatten(jax.device_get(new_state.params)).items():
        diff = np.abs(trainer.params[name].detach().numpy() - w).ravel()
        assert diff.max() <= 2 * LR * (1 + 1e-3), name
        diffs.append(diff)
    assert np.mean(np.concatenate(diffs) <= 1e-2 * LR) >= 0.99
    with pytest.raises(TypeError):
        Trainer(torch.nn.Identity(), device="cpu")
