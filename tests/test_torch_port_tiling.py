"""The port's whole-raster endpoints (``tiling.py`` and ``SuperResolver``'s
tile endpoints) against the JAX package's.

The numpy pieces (``subseed``, ``grid_starts``, ``feather_profile``,
``stitch``) and the ``TileEndpoints`` plumbing driven by one deterministic
stand-in resolver must give exactly equal arrays. On the tiny Cond_SRVAE
(``CondSRVAEConfig(cr=2.0, patch_size=16)``, JAX's weights carried into the
port by ``load_jax_variables``), the port's seeded ``SuperResolver(device=
"cpu")`` draws each dispatch's noise from JAX's keys for that dispatch's
seed and must match JAX's tile endpoints at rtol 1e-4 / atol 2e-5 (float32
through ~25 convolutions, summed in different orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simple_vae_rs_tpu import tiling as jtiling
from simple_vae_rs_tpu.config import CondSRVAEConfig as JConfig
from simple_vae_rs_tpu.models import CondSRVAE as JCondSRVAE
from simple_vae_rs_tpu.serve import SuperResolver as JSuperResolver

from simple_vae_rs_tpu_torch import tiling
from simple_vae_rs_tpu_torch.config import CondSRVAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.serve import SuperResolver, warmup
from simple_vae_rs_tpu_torch.utils.jax_weights import load_jax_variables
from tests.test_torch_port_conv import _random_bn

RTOL, ATOL = 1e-4, 2e-5
PS = 16
WIN = PS // 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: at these sizes more only contend with JAX's threads
    in this process and with the other test processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_pair():
    """(jax model, flax variables, port model) on the same weights: the tiny
    Cond_SRVAE's variable tree (``jax.eval_shape`` of its init: no compile)
    filled from a numpy seed (kernels N(0, 1/fan_in), small biases,
    randomised BatchNorm), carried into the port by load_jax_variables."""
    jmodel = JCondSRVAE(JConfig(cr=2.0, patch_size=PS))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, PS, PS, 4)), jnp.zeros((1, WIN, WIN, 4)),
        jax.random.PRNGKey(1), train=False,
    ))
    rng = np.random.default_rng(2)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return np.ones(leaf.shape, np.float32)
        if name.startswith("gamma"):
            return np.zeros(leaf.shape, np.float32)
        return (rng.standard_normal(leaf.shape) * 0.01).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    variables = _random_bn(variables, seed=3)
    tmodel = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS))
    load_jax_variables(tmodel, variables)
    return jmodel, variables, tmodel.eval()


class JaxNoiseResolver(SuperResolver):
    """The port's resolver with the noise of every seeded ``super_resolve``
    and ``super_resolve_moments`` drawn from the JAX resolver's keys for
    that seed: ``_sr_call``'s ``split(key, 3)`` (JAX serve.py:96-108) and
    ``_sr_moments_call``'s ``split(key, k)`` then ``split(key_i)``
    (:180-192). Unseeded requests and ``uncertainty`` keep the port's own
    generators."""

    _jax = False  # inside a seeded request of the two endpoints
    _k = None  # the draw count of the moments request in progress

    def _generator(self, seed):
        if not self._jax or seed is None:
            return super()._generator(seed)
        return {"key": jax.random.PRNGKey(int(seed)), "k": self._k, "i": 0}

    def super_resolve(self, y, normalize=None, seed=None):
        self._jax = True
        try:
            return super().super_resolve(y, normalize=normalize, seed=seed)
        finally:
            self._jax = False

    def super_resolve_moments(self, y, samples, normalize=False, seed=None):
        self._jax, self._k = True, int(samples)
        try:
            return super().super_resolve_moments(y, samples, normalize=normalize, seed=seed)
        finally:
            self._jax, self._k = False, None

    def _noise(self, batch, lr_hw, gen):
        if not isinstance(gen, dict):
            return super()._noise(batch, lr_hw, gen)
        shape_u, shape_z = self.model.generation_noise_shapes(batch, lr_hw)
        if gen["k"] is None:
            _, k_u, k_z = jax.random.split(gen["key"], 3)
        else:
            k_u, k_z = jax.random.split(jax.random.split(gen["key"], gen["k"])[gen["i"]])
            gen["i"] += 1
        draw = lambda k, s: torch.from_numpy(np.array(jax.random.normal(k, s, jnp.float32)))
        return draw(k_u, shape_u), draw(k_z, shape_z)


@pytest.fixture(scope="module")
def resolvers():
    jmodel, variables, tmodel = tiny_pair()
    return (JSuperResolver(jmodel, variables, seed=4),
            JaxNoiseResolver(tmodel, device="cpu", seed=4))


# ------------------------------------------------------------ numpy pieces
@pytest.mark.parametrize("seed,path", [(0, ()), (7, (3,)), (123456789, (2, 5)), (2**40, (0, 0, 9))])
def test_subseed_matches_jax(seed, path):
    assert tiling.subseed(seed, *path) == jtiling.subseed(seed, *path)
    with pytest.raises(ValueError, match="non-negative"):
        tiling.subseed(-1, *path)


@pytest.mark.parametrize("size,patch,stride", [(8, 8, 8), (20, 8, 6), (27, 8, 6), (23, 8, 4),
                                               (64, 32, 28), (1024, 32, 28), (9, 8, 7)])
def test_grid_starts_match_jax(size, patch, stride):
    assert tiling.grid_starts(size, patch, stride) == jtiling.grid_starts(size, patch, stride)


@pytest.mark.parametrize("bad", [(5, 8, 4), (8, 0, 4), (8, 8, 0)])
def test_grid_starts_refuses_as_jax(bad):
    for mod in (tiling, jtiling):
        with pytest.raises(ValueError):
            mod.grid_starts(*bad)


@pytest.mark.parametrize("patch,overlap", [(8, 0), (8, 2), (8, 4), (16, 8), (64, 8), (63, 31)])
def test_feather_profile_matches_jax(patch, overlap):
    got = tiling.feather_profile(patch, overlap)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jtiling.feather_profile(patch, overlap))


@pytest.mark.parametrize("hw,p,overlap", [((20, 27), 8, 2), ((16, 16), 16, 0), ((33, 18), 8, 4)])
def test_stitch_matches_jax(hw, p, overlap):
    rng = np.random.default_rng(sum(hw) + p)
    stride = p - overlap if overlap else p
    starts = [(a, b) for a in tiling.grid_starts(hw[0], p, stride)
              for b in tiling.grid_starts(hw[1], p, stride)]
    patches = rng.random((len(starts), p, p, 3)).astype(np.float32)
    got = tiling.stitch(patches, starts, hw, overlap)
    np.testing.assert_array_equal(got, jtiling.stitch(patches, starts, hw, overlap))
    # crops of one image come back exactly
    img = rng.random((*hw, 3)).astype(np.float32)
    crops = np.stack([img[a:a + p, b:b + p] for a, b in starts])
    np.testing.assert_allclose(tiling.stitch(crops, starts, hw, overlap), img, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="outside"):
        tiling.stitch(patches[:1], [(hw[0], 0)], hw, overlap)


def test_to_host_takes_tensors_numpy_and_lazy_results():
    x = np.arange(6, dtype=np.float64).reshape(2, 3)
    for given in (x, torch.from_numpy(x), torch.from_numpy(x).to(torch.bfloat16),
                  torch.from_numpy(x).requires_grad_()):
        got = tiling.to_host(given)
        assert got.dtype == np.float32 and np.array_equal(got, x)

    class Lazy:
        def __array__(self, dtype=None, copy=None):
            return x.astype(dtype or x.dtype)

    assert np.array_equal(tiling.to_host(Lazy()), x)


# ------------------------------------------ the mixin on a stand-in resolver
def _det_sr(y, seed=None):
    """Deterministic stand-in for a draw: 2x repeat, a per-window constant
    (so overlapping windows disagree) and a seed-dependent offset."""
    y = np.asarray(y, np.float32)
    up = np.repeat(np.repeat(y, 2, axis=1), 2, axis=2)
    shift = np.float32(0.0 if seed is None else (seed % 997) / 1e4)
    return up + 0.1 * y.mean(axis=(1, 2, 3), keepdims=True) + shift


def _det_moments(wins, samples, seed=None):
    draws = [_det_sr(wins, seed) + np.float32(0.01 * i) for i in range(samples)]
    s1 = np.sum(draws, axis=0, dtype=np.float32)
    return s1, np.sum([d * d for d in draws], axis=0, dtype=np.float32)


def _stand_in(base, as_tensor, moments):
    """A stand-in resolver over ``base``'s TileEndpoints; the port's returns
    CPU tensors (through ``to_host``), JAX's numpy."""
    wrap = (lambda a: torch.from_numpy(np.ascontiguousarray(a))) if as_tensor else (lambda a: a)

    class StandIn(base):
        window, normalize = WIN, True

        def super_resolve(self, y, normalize=None, seed=None):
            return wrap(_det_sr(y, seed))

        if moments:
            def super_resolve_moments(self, wins, samples, normalize=False, seed=None):
                return tuple(map(wrap, _det_moments(wins, samples, seed)))

    return StandIn()


def _rows(gen, moments):
    rows = list(gen)
    if moments:
        return [r0 for r0, _ in rows], {k: np.concatenate([b[k] for _, b in rows])
                                        for k in ("mean", "std", "variance")}
    return [r0 for r0, _ in rows], np.concatenate([b for _, b in rows])


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
        return
    assert a.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("moments", [False, True], ids=["draw_packing", "moments_hook"])
def test_tile_endpoints_equal_jax_on_a_stand_in(moments):
    port = _stand_in(tiling.TileEndpoints, True, moments)
    ref = _stand_in(jtiling.TileEndpoints, False, moments)
    rng = np.random.default_rng(5)
    raster = (rng.random((23, 27, 4)) * 900 + 50).astype(np.float32)
    for kw in ({}, {"overlap": 2, "batch": 4}, {"overlap": 3, "batch": 5, "seed": 11},
               {"samples": 3, "batch": 4, "seed": 12}):
        _equal(port.super_resolve_tile(raster, **kw), ref.super_resolve_tile(raster, **kw))
    for kw in ({"samples": 2}, {"samples": 3, "overlap": 4, "batch": 3, "seed": 8}):
        _equal(port.uncertainty_tile(raster, **kw), ref.uncertainty_tile(raster, **kw))
    small = raster[:5, :6]  # below one window: reflect-padded, then cropped
    out = port.super_resolve_tile(small, seed=2)
    assert out.shape == (10, 12, 4)
    _equal(out, ref.super_resolve_tile(small, seed=2))
    for bad in (dict(samples=0), dict(overlap=5), dict(batch=0)):
        with pytest.raises(ValueError):
            port.super_resolve_tile(raster, **bad)


@pytest.mark.parametrize("moments", [False, True], ids=["sr", "uq"])
def test_iter_tile_rows_equal_jax_resumed_at_every_band(moments):
    port = _stand_in(tiling.TileEndpoints, True, moments)
    ref = _stand_in(jtiling.TileEndpoints, False, moments)
    rng = np.random.default_rng(6)
    lr = rng.random((31, 19, 4)).astype(np.float32)  # flush-tail gap 1 < overlap 4
    kw = dict(overlap=4, batch=3, samples=3 if moments else 1, moments=moments, seed=9)
    read = lambda a, b: lr[a:b]
    n_bands = len(tiling.grid_starts(31, WIN, WIN - 4))
    starts, whole = _rows(port.iter_tile_rows(read, 31, 19, **kw), moments)
    _equal(whole, _rows(ref.iter_tile_rows(read, 31, 19, **kw), moments)[1])
    for band in range(n_bands):
        r0, got = _rows(port.iter_tile_rows(read, 31, 19, start_band=band, **kw), moments)
        assert r0 == starts[band:]
        _equal(got, _rows(ref.iter_tile_rows(read, 31, 19, start_band=band, **kw), moments)[1])
        tail = {k: v[starts[band]:] for k, v in whole.items()} if moments \
            else whole[starts[band]:]
        _equal(got, tail)
    with pytest.raises(ValueError, match="start_band"):
        next(port.iter_tile_rows(read, 31, 19, start_band=n_bands, **kw))
    with pytest.raises(ValueError, match="smaller than one"):
        next(port.iter_tile_rows(read, 5, 19))


# ----------------------------------------------------- the tiny Cond_SRVAE
def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_seeded_tile_endpoints_match_jax_on_the_tiny_model(resolvers):
    jres, tres = resolvers
    assert tres.window == jres.window == WIN
    rng = np.random.default_rng(7)
    raster = (rng.random((20, 27, 4)) * 3000 + 100).astype(np.float32)
    got = tres.super_resolve_tile(raster, overlap=2, batch=8, seed=21)
    assert isinstance(got, np.ndarray) and got.shape == (40, 54, 4)
    _close(got, jres.super_resolve_tile(raster, overlap=2, batch=8, seed=21))
    maps = tres.uncertainty_tile(raster, samples=3, overlap=2, batch=8, seed=22)
    want = jres.uncertainty_tile(raster, samples=3, overlap=2, batch=8, seed=22)
    # the std map is sqrt(max(E[x^2] - E[x]^2, 0)): where the variance is a
    # cancellation at float32's noise (~2e-7 here), sqrt turns a last-bit
    # difference into ~4e-4, so the two moments are held to the tolerance
    # and the std to sqrt of the port's own variance (the stand-in tests
    # hold that numpy step to JAX's exactly)
    _close({k: maps[k] for k in ("mean", "variance")},
           {k: want[k] for k in ("mean", "variance")})
    assert np.array_equal(maps["std"], np.sqrt(maps["variance"]))
    assert float(maps["std"].max()) > 0


def test_seeded_row_sweep_matches_jax_on_the_tiny_model(resolvers):
    jres, tres = resolvers
    y = np.random.default_rng(8).random((20, 27, 4)).astype(np.float32)
    kw = dict(overlap=2, batch=8, seed=23)
    got = list(tres.iter_tile_rows(lambda a, b: y[a:b], 20, 27, **kw))
    want = list(jres.iter_tile_rows(lambda a, b: y[a:b], 20, 27, **kw))
    assert [r for r, _ in got] == [r for r, _ in want]
    _close(np.concatenate([b for _, b in got]), np.concatenate([b for _, b in want]))
    resumed = list(tres.iter_tile_rows(lambda a, b: y[a:b], 20, 27, start_band=1, **kw))
    assert np.array_equal(np.concatenate([b for _, b in resumed]),
                          np.concatenate([b for _, b in got[1:]]))


def test_plain_resolver_tiles_reproduce_and_warm_up():
    _, _, tmodel = tiny_pair()
    res = SuperResolver(tmodel, device="cpu", seed=1)
    warmup(res, lr_shape=(1, WIN, WIN, 4), tile_batch=4, uq_samples=2)
    raster = np.random.default_rng(9).random((14, 19, 4)).astype(np.float32)
    a = res.super_resolve_tile(raster, batch=4, seed=3)
    assert np.array_equal(a, res.super_resolve_tile(raster, batch=4, seed=3))
    assert not np.array_equal(a, res.super_resolve_tile(raster, batch=4, seed=4))
    assert np.isfinite(a).all() and 0.0 <= a.min() and a.max() <= 1.0
    m = res.uncertainty_tile(raster, samples=2, batch=4, seed=5)
    np.testing.assert_allclose(m["std"] ** 2, m["variance"], rtol=1e-5, atol=1e-7)
    # a bfloat16 model tiles too; its outputs are float32
    bf = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS), dtype=torch.bfloat16)
    bf.load_state_dict(tmodel.state_dict())
    out = SuperResolver(bf, device="cpu").super_resolve_tile(raster, batch=4, seed=3)
    assert out.dtype == np.float32 and out.shape == (28, 38, 4)
    assert np.abs(out - a).max() < 0.1
