"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports neither JAX nor the JAX package, so it also runs where JAX
is not installed: ``pytest --noconftest -m gpu tests/test_torch_port_gpu.py``.
Tolerance: max|kernel - plain| <= 1e-4 * max|plain| (float32 both, TF32 off,
sums in another order); the row reductions 1e-5 (every element term >= 0);
a training step as ``chip_smoke.py`` holds it (loss terms rtol 1e-4, each
gradient leaf 1e-3 of the largest gradient in its block).
"""

import copy
import math

import numpy as np
import pytest
import torch

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, TrainConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.ops import fused_elbo as fe
from simple_vae_rs_tpu_torch.serve import SuperResolver
from simple_vae_rs_tpu_torch.train.engine import Trainer

TOL = 1e-4

CASES = [
    ("fused_conv3x3_bn_relu", (2, 8, 8, 4), 4, False),
    ("fused_conv3x3_bn_relu", (3, 5, 7, 5), 13, True),
    ("fused_conv3x3_bn_relu", (1, 4, 4, 1696), 848, False),  # split-K prior head
    ("fused_conv3x3_bn_relu", (4, 16, 16, 64), 16, False),
    ("fused_conv4x4s2_bn_relu", (2, 8, 8, 4), 16, True),
    ("fused_conv4x4s2_bn_relu", (3, 10, 6, 5), 7, False),
    ("fused_conv4x4s2_bn_relu", (2, 7, 9, 3), 20, True),  # odd H and W
    ("fused_convT4x4s2_bn_relu", (3, 5, 7, 4), 9, False),
    ("fused_convT4x4s2_bn_relu", (16, 8, 8, 424), 256, True),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(name, shape, o, seed, device):
    rng = np.random.default_rng(seed)
    k = 3 if name == "fused_conv3x3_bn_relu" else 4
    arrays = (rng.standard_normal(shape),
              rng.standard_normal((k, k, shape[-1], o)) / math.sqrt(k * k * shape[-1]),
              rng.uniform(0.5, 1.5, o), rng.standard_normal(o))
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_cuda_kernel_matches_plain(cuda, case):
    name, shape, o, relu = case
    x, kern, s, t = _inputs(name, shape, o, seed=sum(shape) + o, device=cuda)
    before = fc.launches[name]
    got = getattr(fc, name)(x, kern, s, t, relu=relu)
    torch.cuda.synchronize()
    assert fc.launches[name] == before + 1
    want = fc.PLAIN[name](x, kern, s, t, relu)
    assert got.shape == want.shape == fc.output_shape(name, shape, o)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, kern, s, t = _inputs("fused_conv3x3_bn_relu", (1, 4, 4, 3), 2, 0, cuda)
    with pytest.raises(TypeError):
        fc.fused_conv3x3_bn_relu(x.double(), kern, s, t)
    with pytest.raises(ValueError):
        fc.fused_conv3x3_bn_relu(x.transpose(1, 2), kern, s, t)
    with pytest.raises(ValueError):
        fc.fused_conv3x3_bn_relu(x, kern.cpu(), s, t)


@pytest.mark.gpu
def test_cuda_serving_matches_plain_path(cuda):
    model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=16)).init_weights(1)
    sr = SuperResolver(model, device="cuda", seed=0)
    y = np.random.default_rng(12).random((3, 8, 8, 4)).astype(np.float32)
    fc.reset_launches()
    got = sr.super_resolve(y, seed=1)
    maps = sr.uncertainty(y[0], samples=20, chunk=8, seed=2)
    assert all(v > 0 for v in fc.launches.values())
    blocks.use_plain_path(sr.model)
    want = sr.super_resolve(y, seed=1)
    want_maps = sr.uncertainty(y[0], samples=20, chunk=8, seed=2)
    assert float((got - want).abs().max()) <= 1e-4
    assert float((maps["std"] - want_maps["std"]).abs().max()) <= 1e-4


# (name, b, d): ragged B, D not a multiple of 4 (scalar loads), a split-column
# case (few rows, long rows) and the training shapes' widths
ROW_CASES = [
    ("sq_rows", 5, 37), ("sq_rows", 512, 16384), ("sq_rows", 3, 20000),
    ("kl_std_rows", 13, 1030), ("kl_std_rows", 512, 3392),
    ("kl_gen_rows", 300, 13568), ("kl_gen_rows", 7, 13568), ("kl_gen_rows", 2, 9),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ROW_CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_row_kernel_matches_plain(cuda, case):
    name, b, d = case
    n_in = fe.MODES[name][1]
    rng = np.random.default_rng(b + d)
    rows = [torch.tensor(rng.standard_normal((b, d)) if i % 2 == 0 else rng.uniform(-3, 3, (b, d)),
                         dtype=torch.float32, device=cuda) for i in range(n_in)]
    before = fe.launches[name]
    got = getattr(fe, name)(*rows)
    torch.cuda.synchronize()
    assert fe.launches[name] == before + 1
    want = fe.PLAIN[name](*rows)
    assert got.shape == (b,)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(getattr(fe, name)(*rows), got)  # the same sums every run


DX_CASES = [
    ("fused_conv3x3_bn_relu", (2, 8, 8, 16), 24),
    ("fused_conv3x3_bn_relu", (1, 4, 4, 1696), 848),  # split-K: 16 pixels, K = 9 * 848
    ("fused_conv4x4s2_bn_relu", (3, 8, 6, 5), 16),
    ("fused_convT4x4s2_bn_relu", (2, 5, 3, 24), 7),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DX_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_conv_dx_route_matches_plain(cuda, case):
    name, shape, o = case
    x, kern, s, t = _inputs(name, shape, o, seed=sum(shape), device=cuda)
    g = torch.randn(fc.output_shape(name, shape, o), device=cuda)
    dx_name = fc.DX_KERNEL[name]
    before = fc.role_launches[dx_name]["dx"]
    got = fc.input_grad(name, g, kern, shape)
    torch.cuda.synchronize()
    assert fc.role_launches[dx_name]["dx"] == before + 1
    want = fc.input_grad(name, g, kern, shape, plain=True)
    assert got.shape == want.shape == shape
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    # the whole Function: every gradient against its plain route
    tin = [a.clone().requires_grad_() for a in (x, kern, s, t)]
    out = fc.fused_conv(name, *tin, True)
    grads = torch.autograd.grad(out, tin, g)
    tin_p = [a.clone().requires_grad_() for a in (x, kern, s, t)]
    grads_p = torch.autograd.grad(fc.fused_conv(name, *tin_p, True, plain=True), tin_p, g)
    for gk, gp in zip(grads, grads_p):
        assert float((gk - gp).abs().max()) <= TOL * float(gp.abs().max())


def _step_pair(device):
    model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=16), device=device).init_weights(3)
    plain = copy.deepcopy(model)
    blocks.use_plain_path(plain)
    return (Trainer(model, TrainConfig(), device=device),
            Trainer(plain, TrainConfig(), device=device))


def _assert_grads_close(grads, grads_p, rtol):
    block_max = {}
    for name, g in grads_p.items():
        blk = name.split(".")[0]
        block_max[blk] = max(block_max.get(blk, 0.0), float(g.abs().max()))
    for name, g in grads.items():
        err = float((g - grads_p[name]).abs().max())
        assert err <= rtol * block_max[name.split(".")[0]], (name, err)


@pytest.mark.gpu
def test_cuda_train_and_val_step_match_plain_path(cuda):
    kernels, plain = _step_pair(cuda)
    rng = np.random.default_rng(14)
    y = torch.tensor(rng.random((6, 8, 8, 4)), dtype=torch.float32, device=cuda)
    x = torch.tensor(rng.random((6, 16, 16, 4)), dtype=torch.float32, device=cuda)
    eps = kernels.noise(6, (8, 8), torch.Generator(device=cuda).manual_seed(1))
    fc.reset_launches()
    fe.reset_launches()
    grads, terms = kernels.grads_and_terms((y, x), eps)
    torch.cuda.synchronize()
    assert all(v["forward"] > 0 and v["dx"] > 0 for v in fc.role_launches.values())
    assert all(v == 1 or (k == "sq_rows" and v == 2) for k, v in fe.launches.items())
    counts = dict(fc.launches), dict(fe.launches)
    grads_p, terms_p = plain.grads_and_terms((y, x), eps)
    torch.cuda.synchronize()
    assert (dict(fc.launches), dict(fe.launches)) == counts  # the plain path launched nothing
    for key in terms:
        assert abs(float(terms[key] - terms_p[key])) <= 1e-4 * abs(float(terms_p[key])) + 1e-6
    _assert_grads_close(grads, grads_p, 1e-3)
    for (name, buf), buf_p in zip(kernels.model.named_buffers(), plain.model.buffers()):
        assert torch.allclose(buf, buf_p, rtol=1e-4, atol=1e-6), name
    val, val_p = kernels.val_step((y, x)), plain.val_step((y, x))
    assert fe.launches["kl_gen_rows"] == 2
    for key in val:
        assert abs(float(val[key] - val_p[key])) <= 1e-4 * abs(float(val_p[key])) + 1e-6
