"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports neither JAX nor the JAX package, so it also runs where JAX
is not installed: ``pytest --noconftest -m gpu tests/test_torch_port_gpu.py``.
Tolerance: max|kernel - plain| <= 1e-4 * max|plain| (float32 both, TF32 off,
sums in another order).
"""

import math

import numpy as np
import pytest
import torch

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.serve import SuperResolver

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
