"""The port's fused conv kernels, blocks and reshapes against the JAX package.

Inputs are made with numpy from a seed and go through the JAX function
(Pallas kernel in interpret mode, or its ``_reference*``) and the port's
plain version, in float32 on the CPU. Tolerance: rtol 1e-4, atol 1e-5 for
unit-scale data (summation order differs between XLA and PyTorch's CPU
convolutions; both accumulate in float32). The CUDA kernels themselves run
only in the tests marked ``gpu``, against the same plain versions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simple_vae_rs_tpu.ops import pallas_conv as pc
from simple_vae_rs_tpu.ops import conv_blocks as jblocks
from simple_vae_rs_tpu.ops import reshape as jreshape
from simple_vae_rs_tpu.utils.image import normalize_image as j_normalize_image

from simple_vae_rs_tpu_torch.ops import conv_blocks as tblocks
from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.ops import reshape as treshape
from simple_vae_rs_tpu_torch.utils.image import normalize_image as t_normalize_image
from simple_vae_rs_tpu_torch.utils.jax_weights import load_jax_variables

RTOL, ATOL = 1e-4, 1e-5

# (name, x shape, O, relu): C=4 image-facing shapes, ragged H/W/C/O, the
# prior-head pattern (few pixels, many channels) and relu on and off
CASES = [
    ("fused_conv3x3_bn_relu", (2, 8, 8, 4), 4, False),
    ("fused_conv3x3_bn_relu", (3, 5, 7, 5), 13, True),
    ("fused_conv3x3_bn_relu", (1, 4, 4, 40), 24, False),
    ("fused_conv4x4s2_bn_relu", (2, 8, 8, 4), 16, True),
    ("fused_conv4x4s2_bn_relu", (3, 10, 6, 5), 7, False),
    ("fused_convT4x4s2_bn_relu", (2, 4, 4, 8), 6, True),
    ("fused_convT4x4s2_bn_relu", (3, 5, 7, 4), 9, False),
]

_JAX_FUSED = {
    "fused_conv3x3_bn_relu": (pc.fused_conv3x3_bn_relu, pc._reference3, 3),
    "fused_conv4x4s2_bn_relu": (pc.fused_conv4x4s2_bn_relu, pc._reference4, 4),
    "fused_convT4x4s2_bn_relu": (pc.fused_convT4x4s2_bn_relu, pc._referenceT, 4),
}


def _data(shape, o, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    kern = (rng.standard_normal((k, k, shape[-1], o)) * 0.2).astype(np.float32)
    scale = rng.standard_normal(o).astype(np.float32)
    shift = rng.standard_normal(o).astype(np.float32)
    return x, kern, scale, shift


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_kernel_function_matches_jax(case):
    name, shape, o, relu = case
    fused, reference, k = _JAX_FUSED[name]
    x, kern, s, t = _data(shape, o, k, seed=len(shape) + o)
    want_kernel = np.asarray(fused(x, kern, s, t, relu=relu, interpret=True))
    want_ref = np.asarray(reference(x, kern, s, t, relu))
    got_plain = fc.PLAIN[name](*_t(x, kern, s, t), relu).numpy()
    got_wrapper = getattr(fc, name)(*_t(x, kern, s, t), relu=relu).numpy()
    assert got_plain.shape == want_ref.shape == fc.output_shape(name, shape, o)
    np.testing.assert_allclose(got_plain, want_kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_plain, want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_wrapper, got_plain)  # CPU tensor -> plain
    if relu:
        assert got_plain.min() >= 0.0
    else:
        assert got_plain.min() < 0.0


def _implicit_gemm(name, x, kern, scale, shift, relu):
    """The CUDA kernels' index arithmetic (tap geometry, K splits, output
    phases) replayed in numpy, so a wrong tap or offset shows on the CPU."""
    _, taps, stride, phases = fc._KERNELS[name]
    b, h, w, c = x.shape
    o = kern.shape[-1]
    m, n, k, _ = fc.geometry(name, torch.from_numpy(x), torch.from_numpy(kern))
    ho, wo = (h // 2, w // 2) if stride == 2 else (h, w)
    _, splits, kchunk = fc.plan_tc(m, n, k, phases)
    wflat = kern.reshape(-1, o)
    out = np.zeros(fc.output_shape(name, x.shape, o), np.float32)
    for p in range(phases):
        a = np.zeros((m, k), np.float32)
        rows = np.zeros(k, np.int64)
        for kk in range(k):
            t, ci = divmod(kk, c)
            if name == "fused_conv3x3_bn_relu":
                dy, dx, wtap = t // 3 - 1, t % 3 - 1, t
            elif name == "fused_conv4x4s2_bn_relu":
                dy, dx, wtap = t // 4 - 1, t % 4 - 1, t
            else:
                ta, tb, u, v = t >> 1, t & 1, p >> 1, p & 1
                dy, dx, wtap = ta + u - 1, tb + v - 1, (2 * ta + u) * 4 + 2 * tb + v
            rows[kk] = wtap * c + ci
            for mm in range(m):
                bb, r = divmod(mm, ho * wo)
                oy, ox = divmod(r, wo)
                iy, ix = oy * stride + dy, ox * stride + dx
                if 0 <= iy < h and 0 <= ix < w:
                    a[mm, kk] = x[bb, iy, ix, ci]
        acc = sum(a[:, lo:lo + kchunk] @ wflat[rows[lo:lo + kchunk]]
                  for lo in range(0, splits * kchunk, kchunk))
        y = acc * scale + shift
        y = np.maximum(y, 0.0) if relu else y
        for mm in range(m):
            bb, r = divmod(mm, ho * wo)
            oy, ox = divmod(r, wo)
            if phases == 1:
                out[bb, oy, ox] = y[mm]
            else:
                out[bb, 2 * oy + (p >> 1), 2 * ox + (p & 1)] = y[mm]
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_kernel_index_arithmetic_matches_plain(case):
    name, shape, o, relu = case
    x, kern, s, t = _data(shape, o, 4 if "4x4" in name else 3, seed=7)
    got = _implicit_gemm(name, x, kern, s, t, relu)
    want = fc.PLAIN[name](*_t(x, kern, s, t), relu).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("m,n,k,phases", [
    (16, 848, 15264, 1),      # prior head at one image
    (256, 848, 15264, 1),     # prior head at B=16
    (4096000, 64, 576, 1),    # 64x64 tail at the 1000-draw chunk
    (1024, 256, 1696, 4),     # dx_up1 tail at B=16
    (16384, 4, 36, 1),        # image-facing conv
])
def test_plan_covers_k_and_fills_card(m, n, k, phases):
    cfg, splits, kchunk = fc.plan_tc(m, n, k, phases)
    bm, bn = fc.TC_TILES[cfg][:2]
    assert kchunk % fc.TC_BK == 0 and (splits - 1) * kchunk < k <= splits * kchunk
    blocks = -(-m // bm) * -(-n // bn) * phases
    if blocks < 132 and k >= 2 * fc._TC_MIN_SPLIT_K:
        assert splits > 1 and blocks * splits >= 132
    if blocks >= 132:
        assert splits == 1


def test_wrappers_reject_other_devices_and_bad_shapes():
    x, kern, s, t = _t(*_data((1, 4, 4, 3), 2, 3, seed=0))
    with pytest.raises(ValueError):
        fc.fused_conv3x3_bn_relu(x.to("meta"), kern.to("meta"), s.to("meta"), t.to("meta"))
    with pytest.raises(ValueError):
        fc._check("fused_conv3x3_bn_relu", x, kern[:, :, :2], s, t)
    with pytest.raises(ValueError):
        fc._check("fused_conv4x4s2_bn_relu", x, kern, s, t)
    with pytest.raises(ValueError):
        fc._check("fused_conv3x3_bn_relu", x, kern, s[:1], t)


def test_fold_conv_bn_matches_jax():
    rng = np.random.default_rng(3)
    kern = rng.standard_normal((4, 4, 5, 6)).astype(np.float32)
    leaves = [rng.standard_normal(6).astype(np.float32) for _ in range(4)]
    var = rng.uniform(0.2, 2.0, 6).astype(np.float32)
    want = pc.fold_conv_bn(kern, leaves[0], leaves[1], leaves[2], leaves[3], var)
    got = fc.fold_conv_bn(*_t(kern, leaves[0], leaves[1], leaves[2], leaves[3], var))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    got_nobias = fc.fold_conv_bn(*_t(kern), None, *_t(leaves[1], leaves[2], leaves[3], var))
    want_nobias = pc.fold_conv_bn(kern, None, leaves[1], leaves[2], leaves[3], var)
    np.testing.assert_allclose(got_nobias[2].numpy(), np.asarray(want_nobias[2]),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture
def pallas_on():
    prev = pc.is_enabled()
    pc.enable(True)
    yield
    pc.enable(prev)


def _random_bn(variables, seed):
    """Flax variables with non-trivial BatchNorm parameters and statistics."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            elif "bn" in path:
                if key == "var":
                    tree[key] = rng.uniform(0.3, 2.0, val.shape).astype(np.float32)
                elif key == "scale":
                    tree[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
                else:
                    tree[key] = (rng.standard_normal(val.shape) * 0.2).astype(np.float32)

    out = {col: dict(tree) for col, tree in out.items()}
    for tree in out.values():
        walk(tree, ())
    return out


@pytest.mark.parametrize("block,cin,cout,hw", [
    ("DownBlock", 4, 16, 8),
    ("DownBlock", 6, 10, 6),
    ("UpBlock", 8, 4, 4),
    ("UpBlock", 5, 7, 3),
])
def test_blocks_eval_match_jax(pallas_on, block, cin, cout, hw):
    jmod = getattr(jblocks, block)(cin, cout)
    x = np.random.default_rng(cin * cout).standard_normal((2, hw, hw, cin)).astype(np.float32)
    variables = _random_bn(
        jmod.init(jax.random.PRNGKey(cin), jnp.zeros_like(x), train=False), seed=cout
    )
    want = np.asarray(jmod.apply(variables, x, train=False))
    tmod = getattr(tblocks, block)(cin, cout).eval()
    load_jax_variables(tmod, variables)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        tblocks.use_plain_path(tmod)
        np.testing.assert_array_equal(tmod(torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("c,hw", [(4, 8), (6, 5)])
def test_residual_matches_jax(pallas_on, c, hw):
    """``Residual`` around a conv (``x + module(x)``), its weights carried
    over from the flax tree's ``module``."""
    jmod = jblocks.Residual(jblocks.PallasCapableConv3x3(features=c, in_features=c))
    x = np.random.default_rng(c * hw).standard_normal((2, hw, hw, c)).astype(np.float32)
    variables = jmod.init(jax.random.PRNGKey(c), jnp.zeros_like(x))
    want = np.asarray(jmod.apply(variables, x))
    tmod = tblocks.Residual(tblocks.Conv3x3(c, c)).eval()
    load_jax_variables(tmod, variables)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_block_training_mode_is_not_ported():
    """Training mode does not take the eval path: a block in ``train()``
    normalises with its batch statistics and updates its running ones, as
    the JAX block with ``train=True`` does, where the eval fold reads them."""
    x = np.random.default_rng(21).standard_normal((3, 8, 8, 4)).astype(np.float32)
    for block in ("DownBlock", "UpBlock"):
        jmod = getattr(jblocks, block)(4, 8)
        variables = _random_bn(
            jmod.init(jax.random.PRNGKey(2), jnp.zeros_like(x), train=False), seed=22)
        want, new = jmod.apply(variables, x, train=True, mutable=["batch_stats"])
        tmod = getattr(tblocks, block)(4, 8).train()
        load_jax_variables(tmod, variables)
        got = tmod(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        for key in ("mean", "var"):
            np.testing.assert_allclose(getattr(tmod.bn, key).numpy(),
                                       np.asarray(new["batch_stats"]["bn"][key]),
                                       rtol=RTOL, atol=ATOL)
        with torch.no_grad():
            assert not torch.allclose(tmod.eval()(torch.from_numpy(x)), got)


@pytest.mark.parametrize("fn", [
    "space_to_depth", "depth_to_space", "cmajor_regroup_down", "cmajor_regroup_up",
    "flatten_map",
])
def test_reshapes_match_jax(fn):
    x = np.random.default_rng(1).standard_normal((2, 4, 6, 8)).astype(np.float32)
    want = np.asarray(getattr(jreshape, fn)(jnp.asarray(x)))
    got = getattr(treshape, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(6, 5, 4), (3, 6, 5, 4)])
def test_normalize_image_matches_jax(shape):
    x = (np.random.default_rng(2).standard_normal(shape) * 3 + 1).astype(np.float32)
    want = np.asarray(j_normalize_image(jnp.asarray(x)))
    got = t_normalize_image(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        t_normalize_image(torch.zeros(4, 4))
