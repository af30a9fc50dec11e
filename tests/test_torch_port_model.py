"""The port's Cond_SRVAE serving path against the JAX package's model.

The flax model is initialised at ``CondSRVAEConfig(cr=2.0, patch_size=16)``,
its BatchNorm parameters and statistics are randomised with numpy, and the
tree is carried into the port with ``load_jax_variables``. The JAX model runs
with the Pallas switch on (on the CPU its fused kernels fall through to their
references); the port runs its plain versions on the CPU. Both get the same
numpy inputs and noise. Tolerance: rtol 1e-4, atol 2e-5 (float32 through ~25
convolutions, summed in different orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simple_vae_rs_tpu.config import CondSRVAEConfig as JConfig
from simple_vae_rs_tpu.models import CondSRVAE as JCondSRVAE
from simple_vae_rs_tpu.ops import pallas_conv as pc

from simple_vae_rs_tpu_torch import serve as tserve
from simple_vae_rs_tpu_torch.config import CondSRVAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.ops import conv_blocks as tblocks
from simple_vae_rs_tpu_torch.serve import SuperResolver
from simple_vae_rs_tpu_torch.tasks import auto_chunk, sample_chunked
from simple_vae_rs_tpu_torch.utils.jax_weights import load_jax_variables
from tests.test_torch_port_conv import _random_bn

RTOL, ATOL = 1e-4, 2e-5
PS = 16


@pytest.fixture(scope="module", params=[False, True], ids=["pixel_shuffle", "torch_regroup"])
def pair(request):
    """(jax model, flax variables, port model) on the same weights."""
    prev = pc.is_enabled()
    pc.enable(True)
    jcfg = JConfig(cr=2.0, patch_size=PS, torch_regroup=request.param)
    jmodel = JCondSRVAE(jcfg)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, PS, PS, 4)), jnp.zeros((1, PS // 2, PS // 2, 4)),
        jax.random.PRNGKey(1), train=False,
    )
    variables = _random_bn(variables, seed=3)
    tmodel = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS, torch_regroup=request.param))
    load_jax_variables(tmodel, variables)
    yield jmodel, variables, tmodel.eval()
    pc.enable(prev)


def _inputs(tmodel, batch, seed):
    rng = np.random.default_rng(seed)
    y = rng.random((batch, PS // 2, PS // 2, 4)).astype(np.float32)
    shape_u, shape_z = tmodel.generation_noise_shapes(batch, (PS // 2, PS // 2))
    return (y, rng.standard_normal(shape_u).astype(np.float32),
            rng.standard_normal(shape_z).astype(np.float32))


def _close(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_conditional_generation_eps_matches_jax(pair):
    jmodel, variables, tmodel = pair
    y, eps_u, eps_z = _inputs(tmodel, 3, seed=4)
    want = jmodel.apply(variables, y, eps_u, eps_z,
                        method=JCondSRVAE.conditional_generation_eps)
    with torch.no_grad():
        got = tmodel.conditional_generation_eps(*map(torch.from_numpy, (y, eps_u, eps_z)))
    _close(got, want)
    # the noise shapes the port computes from the config are the probe's
    probe = jax.eval_shape(lambda: jmodel.apply(
        variables, y, method=JCondSRVAE.generation_noise_shapes))
    assert [tuple(p.shape) for p in probe] == [eps_u.shape, eps_z.shape]


def test_prior_pieces_match_jax(pair):
    jmodel, variables, tmodel = pair
    y, eps_u, _ = _inputs(tmodel, 2, seed=5)

    def pieces(m, y, eps_u):
        mu_u, lv_u = m.encode_y(y, train=False)
        y_feat = m.y_embedding(y, train=False)
        mu_p, lv_p = m.z_cond(y_feat, mu_u + eps_u * jnp.exp(0.5 * lv_u), train=False)
        return mu_u, lv_u, y_feat, mu_p, lv_p

    want = jmodel.apply(variables, y, eps_u, method=pieces)
    with torch.no_grad():
        ty, teu = torch.from_numpy(y), torch.from_numpy(eps_u)
        mu_u, lv_u = tmodel.encode_y(ty)
        y_feat = tmodel.y_embedding(ty)
        mu_p, lv_p = tmodel.z_cond(y_feat, mu_u + teu * torch.exp(0.5 * lv_u))
    for g, w in zip((mu_u, lv_u, y_feat, mu_p, lv_p), want):
        _close(g, w)
    assert float(lv_p.max()) <= 7.0 and float(lv_p.min()) >= -7.0


def test_decode_x_from_features_matches_jax(pair):
    jmodel, variables, tmodel = pair
    cfg = tmodel.config
    rng = np.random.default_rng(6)
    z = rng.standard_normal((4, cfg.z_spatial, cfg.z_spatial, cfg.z_channels)).astype(np.float32)
    yf = rng.standard_normal((4, PS // 16, PS // 16, cfg.latent_size // 16)).astype(np.float32)
    want = jmodel.apply(variables, z, yf, False,
                        method=JCondSRVAE.decode_x_from_features)
    with torch.no_grad():
        got = tmodel.decode_x_from_features(torch.from_numpy(z), torch.from_numpy(yf))
    _close(got, want)


def test_sample_chunked_matches_jax_with_injected_noise(pair):
    jmodel, variables, tmodel = pair
    y, eps_u, _ = _inputs(tmodel, 1, seed=7)
    cfg = tmodel.config
    samples = 5
    eps_z = np.random.default_rng(8).standard_normal(
        (samples, cfg.z_spatial, cfg.z_spatial, cfg.z_channels)).astype(np.float32)

    def draws(m, y, eps_u, eps_z):
        mu_u, lv_u = m.encode_y(y, train=False)
        y_feat = m.y_embedding(y, train=False)
        mu_p, lv_p = m.z_cond(y_feat, mu_u + eps_u * jnp.exp(0.5 * lv_u), train=False)
        z = mu_p + eps_z * jnp.exp(0.5 * lv_p)
        yf = jnp.broadcast_to(y_feat, (samples,) + y_feat.shape[1:])
        return m.decode_x_from_features(z, yf, train=False)

    want = jmodel.apply(variables, y, eps_u, eps_z, method=draws)
    got = sample_chunked(tmodel, torch.from_numpy(y), samples=samples, chunk=2,
                         eps_u=torch.from_numpy(eps_u), eps_z=torch.from_numpy(eps_z))
    _close(got, want)


def test_load_jax_variables_rejects_mismatched_trees(pair):
    _, variables, _ = pair
    fresh = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS))
    missing = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    del missing["params"]["gammax"]
    with pytest.raises(KeyError, match="gammax"):
        load_jax_variables(fresh, missing)
    extra = {**variables, "params": {**variables["params"], "stray": np.zeros(1)}}
    with pytest.raises(KeyError, match="stray"):
        load_jax_variables(fresh, extra)
    wrong = {**variables, "params": {**variables["params"],
                                     "dx_conv4": {"kernel": np.zeros((3, 3, 16, 5)),
                                                  "bias": np.zeros(5)}}}
    with pytest.raises(ValueError, match="dx_conv4"):
        load_jax_variables(fresh, wrong)
    with pytest.raises(KeyError, match="quant"):
        load_jax_variables(fresh, {**variables, "quant": {"stray": np.zeros(1)}})
    with pytest.raises(KeyError, match="cache"):
        load_jax_variables(fresh, {**variables, "cache": {}})


@pytest.mark.parametrize("cr,ps", [(1.2, 64), (2.0, 16)])
def test_latent_dims_match_jax(cr, ps):
    """``z_dim`` and ``u_dim``: the elements of one z and one u."""
    got, want = CondSRVAEConfig(cr=cr, patch_size=ps), JConfig(cr=cr, patch_size=ps)
    assert (got.z_dim, got.u_dim) == (want.z_dim, want.u_dim)
    assert got.z_dim == got.z_channels * got.z_spatial ** 2 > got.u_dim > 0


def test_canonical_param_count():
    model = CondSRVAE(CondSRVAEConfig(cr=1.2, patch_size=64), device="meta")
    named = dict(model.named_parameters())
    gammas = [n for n in named if n.startswith("gamma")]
    assert sorted(gammas) == ["gammax", "gammay"]
    assert all(named[n].numel() == 1 for n in gammas)
    assert sum(p.numel() for n, p in named.items() if n not in gammas) == 48_953_912


# ------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def resolver():
    model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(0)
    return SuperResolver(model, device="cpu", seed=4)


def test_cuda_resolver_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SuperResolver(model, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SuperResolver(model)  # the default device is the card


def test_seeded_requests_reproduce(resolver):
    y = np.random.default_rng(9).random((2, PS // 2, PS // 2, 4)).astype(np.float32)
    a = resolver.super_resolve(y, seed=5)
    rolling = resolver._rng.get_state()
    b = resolver.super_resolve(y, seed=5)
    assert torch.equal(resolver._rng.get_state(), rolling)  # seeded: stream untouched
    assert torch.equal(a, b)
    assert not torch.equal(a, resolver.super_resolve(y, seed=6))
    u1, u2 = resolver.super_resolve(y), resolver.super_resolve(y)
    assert not torch.equal(u1, u2)  # unseeded: fresh draws each call
    m1 = resolver.uncertainty(y[0], samples=4, chunk=3, seed=2)
    m2 = resolver.uncertainty(y[0], samples=4, chunk=3, seed=2)
    for key in ("mean", "std", "variance"):
        assert m1[key].shape == (PS, PS, 4) and torch.equal(m1[key], m2[key])
    torch.testing.assert_close(m1["std"] ** 2, m1["variance"])
    assert torch.equal(resolver.mmse_estimate(y[0], samples=4, chunk=3, seed=2), m1["mean"])


def test_moments_and_chunks_agree(resolver):
    y = np.random.default_rng(10).random((2, PS // 2, PS // 2, 4)).astype(np.float32)
    s1, s2 = resolver.super_resolve_moments(y, 3, normalize=True, seed=1)
    gen = torch.Generator().manual_seed(1)
    draws = []
    for _ in range(3):
        eps = resolver._noise(2, (PS // 2, PS // 2), gen)
        yy = resolver._input(y, True)
        draws.append(resolver.model.conditional_generation_eps(yy, *eps))
    torch.testing.assert_close(s1, sum(draws))
    torch.testing.assert_close(s2, sum(d * d for d in draws))
    one = resolver.uncertainty(y[0], samples=5, chunk=5, seed=3)["mean"]
    assert one.shape == (PS, PS, 4)
    assert auto_chunk(1000, 64) == 1000 and auto_chunk(1000, 128) == 256
    with pytest.raises(ValueError):
        resolver.super_resolve(np.zeros((1, 6, 6, 4), np.float32))
    with pytest.raises(ValueError):
        resolver.super_resolve_moments(y, 0)


def test_warmup_and_plain_switch(resolver):
    tserve.warmup(resolver, lr_shape=(1, PS // 2, PS // 2, 4))
    y = np.random.default_rng(11).random((1, PS // 2, PS // 2, 4)).astype(np.float32)
    a = resolver.super_resolve(y, seed=3)
    tblocks.use_plain_path(resolver.model)
    try:
        assert torch.equal(resolver.super_resolve(y, seed=3), a)  # CPU: same function
    finally:
        tblocks.use_plain_path(resolver.model, False)
