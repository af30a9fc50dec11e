"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports neither JAX nor the JAX package, so it also runs where JAX
is not installed: ``pytest --noconftest -m gpu tests/test_torch_port_gpu.py``.
Tolerance: max|kernel - plain| <= 1e-4 * max|plain| (float32 both, TF32 off,
sums in another order); the row reductions 1e-5 (every element term >= 0);
a training step as ``chip_smoke.py`` holds it (loss terms rtol 1e-4, each
gradient leaf 1e-3 of the largest gradient in its block). The int8 convs
(#9, #11, #12, all on the int8 tensor cores) and their quantize pass bit for
bit (the same integers summed exactly on both sides, the same float32
epilogue); the stochastic quantizer byte for byte, a leaf alone and a whole
quant tree in one call, the int8 resolver against its plain path
2e-3 absolute (a float32 layer above an int8 conv may move an activation
across a rounding boundary). The chain kernel 1e-4 * max|plain| as the other
float32 kernels; chained against unchained served outputs 1e-4 absolute.

The bfloat16 instances: the int8 absmax and quantize passes and the three
int8 convs bit for bit (the upcast is exact; the one rounding to bfloat16 is
the plain version's); #1, #5 and #6 and each layer of the chain within one
bfloat16 ulp at the element plus 1e-4 of max|plain| (``fc.compare_bf16``:
each side rounds a float32 sum taken in another order once). A whole chain
rounds each layer to bfloat16, so a layer one ulp apart carries that on:
the chain's output is held to the noise rule of the CPU parity tests
against its plain version (2x the plain bfloat16 chain's own distance from
the float32 chain, plus 1e-4 of max|plain|), each of its layers to one ulp.
"""

import copy
import math

import numpy as np
import pytest
import torch

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, TrainConfig, VAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.srvae import SRVAE
from simple_vae_rs_tpu_torch.models.vae import VAE
from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
from simple_vae_rs_tpu_torch.ops import fused_chain as fch
from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.ops import fused_elbo as fe
from simple_vae_rs_tpu_torch.ops import fused_int8 as f8
from simple_vae_rs_tpu_torch.ops import quantize as qz
from simple_vae_rs_tpu_torch.serve import SuperResolver
from simple_vae_rs_tpu_torch.tasks import sample_chunked
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


# the tensor-core kernel (3x3, 4x4/s2 and transposed) at its edge paths:
# C % 4 != 0 (4-byte copies: C = 53, 106, 7), N = 4 (a skipped n8 tile) and
# 53 (ragged weight slices and stores), M <= 64 (per phase) with a K split
# and K not a multiple of 32, the strided kernel with C % 4 != 0, and the
# canonical prior head
TC_CASES = [
    ("fused_conv3x3_bn_relu", (2, 8, 8, 53), 53, True),
    ("fused_conv3x3_bn_relu", (3, 8, 8, 106), 128, False),
    ("fused_conv3x3_bn_relu", (4, 16, 16, 16), 4, True),
    ("fused_conv3x3_bn_relu", (1, 4, 4, 212), 848, False),
    ("fused_conv3x3_bn_relu", (1, 4, 4, 1696), 848, False),
    ("fused_conv4x4s2_bn_relu", (2, 16, 16, 128), 53, False),
    ("fused_conv4x4s2_bn_relu", (3, 10, 12, 7), 9, True),
    ("fused_conv4x4s2_bn_relu", (1, 8, 8, 53), 424, True),
    ("fused_convT4x4s2_bn_relu", (2, 8, 8, 53), 128, True),
    ("fused_convT4x4s2_bn_relu", (4, 16, 16, 16), 4, False),
    ("fused_convT4x4s2_bn_relu", (2, 8, 8, 128), 53, True),
    ("fused_convT4x4s2_bn_relu", (1, 4, 4, 424), 256, False),
    ("fused_convT4x4s2_bn_relu", (1, 3, 4, 106), 13, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_tensor_core_kernel_matches_plain_in_both_roles(cuda, case):
    name, shape, o, relu = case
    x, kern, s, t = _inputs(name, shape, o, seed=sum(shape) + 2 * o, device=cuda)
    before = fc.role_launches[name]["forward"]
    got = getattr(fc, name)(x, kern, s, t, relu=relu)
    torch.cuda.synchronize()
    assert fc.role_launches[name]["forward"] == before + 1
    want = fc.PLAIN[name](x, kern, s, t, relu)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    assert torch.equal(getattr(fc, name)(x, kern, s, t, relu=relu), got)  # the same bits
    # the same kernel as the input gradient of the conv it is the adjoint of,
    # with x as that conv's output gradient
    site = fc.DX_KERNEL[name]
    in_shape = fc.output_shape(name, shape, o)
    before = fc.role_launches[name]["dx"]
    got = fc.input_grad(site, x, fc.flip_swap(kern), in_shape)
    torch.cuda.synchronize()
    assert fc.role_launches[name]["dx"] == before + 1
    want = fc.input_grad(site, x, fc.flip_swap(kern), in_shape, plain=True)
    assert got.shape == want.shape == in_shape
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    assert torch.equal(fc.input_grad(site, x, fc.flip_swap(kern), in_shape), got)


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
    assert all(v > 0 for k, v in fc.launches.items() if k != fc.CHAIN)
    assert fc.launches[fc.CHAIN] == 0  # the chain is off unless asked for
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


# (name, x shape, O, relu, act_group): ragged packs (C=3, C=6), odd H/W, O=5,
# a K split (few pixels, many channels), groups smaller than the batch with a
# ragged last group, and the canonical deep decoder shapes; also C = 5, 7,
# 130, 300 and 424 (padded to 16, 16, 144, 304, 432), O = 9, 13, 70 and 200
# (weight rows that are not whole 16-byte words) and every tile; for the
# strided conv (#11) odd H and W, C = 4 (12 of every 16 bytes padding), 130,
# a K split and its canonical DownBlock shapes
INT8_CASES = [
    ("int8_conv3x3_bn_relu", (2, 8, 8, 4), 8, True, None),
    ("int8_conv3x3_bn_relu", (3, 5, 7, 3), 5, False, None),
    ("int8_conv3x3_bn_relu", (5, 9, 11, 6), 13, True, 2),
    ("int8_conv3x3_bn_relu", (1, 4, 4, 300), 200, False, None),
    ("int8_conv3x3_bn_relu", (16, 8, 8, 424), 424, False, None),
    ("int8_conv3x3_bn_relu", (4, 64, 64, 16), 4, False, 1),
    ("int8_conv3x3_bn_relu", (3, 5, 7, 7), 9, True, None),
    ("int8_conv3x3_bn_relu", (2, 9, 9, 130), 70, True, 1),
    ("int8_conv3x3_bn_relu", (3, 6, 7, 5), 30, False, 2),
    ("int8_conv3x3_bn_relu", (16, 64, 64, 64), 16, True, None),
    ("int8_conv4x4s2_bn_relu", (3, 10, 6, 5), 7, False, 1),
    ("int8_conv4x4s2_bn_relu", (2, 7, 9, 3), 20, True, None),
    ("int8_conv4x4s2_bn_relu", (16, 16, 16, 64), 128, True, None),
    ("int8_conv4x4s2_bn_relu", (5, 9, 11, 4), 13, False, 2),
    ("int8_conv4x4s2_bn_relu", (3, 11, 12, 130), 24, True, None),
    ("int8_conv4x4s2_bn_relu", (1, 8, 8, 130), 200, False, None),
    ("int8_conv4x4s2_bn_relu", (16, 64, 64, 4), 16, True, None),
    ("int8_convT4x4s2_bn_relu", (3, 5, 7, 4), 9, False, 2),
    ("int8_convT4x4s2_bn_relu", (16, 8, 8, 424), 256, True, None),
    ("int8_convT4x4s2_bn_relu", (4, 4, 4, 130), 70, False, 3),
    ("int8_convT4x4s2_bn_relu", (3, 5, 6, 5), 13, True, 2),
    ("int8_convT4x4s2_bn_relu", (1, 4, 4, 300), 200, False, None),
    ("int8_convT4x4s2_bn_relu", (2, 7, 5, 6), 24, True, None),
    ("int8_convT4x4s2_bn_relu", (16, 16, 16, 256), 128, True, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", INT8_CASES, ids=lambda c: "-".join(map(str, c)))
def test_int8_cuda_kernel_matches_plain(cuda, case):
    name, shape, o, relu, group = case
    x, kern, s, t = _inputs(f8.float_name(name), shape, o, seed=sum(shape) + o, device=cuda)
    x = x * torch.linspace(0.3, 2.0, shape[0], device=cuda).view(-1, 1, 1, 1)
    kq, ks = qz.quantize_rtn(kern)
    before = dict(f8.launches)
    got = f8.WRAPPERS[name](x, kq, ks, s, t, relu=relu, act_group=group)
    torch.cuda.synchronize()
    assert f8.launches[name] == before[name] + 1
    assert f8.launches["act_absmax"] == before["act_absmax"] + 1
    # every int8 conv quantizes in a pass of its own, once a call
    assert f8.launches["act_quant"] == before["act_quant"] + 1
    want = f8.PLAIN[name](x, kq, ks, s, t, relu, group)
    assert got.shape == want.shape == f8.output_shape(name, shape, o)
    assert torch.equal(got, want)  # exact int32 sums, the plain version's epilogue
    assert torch.equal(f8.act_absmax(x, group), f8.act_absmax_plain(x, group))
    # a cached packing gives the same result, and the same result every run
    again = f8.WRAPPERS[name](x, kq, ks, s, t, relu=relu, act_group=group,
                              packed=f8.pack_kernel_q(kq))
    assert torch.equal(again, got)


# the quantize pass at the CPU replay's shapes (float4 and scalar reads,
# short last groups), at a 1000-draw decode layer's (262 MB) and with values
# exactly on a rounding boundary (scales 1/8 and 1/16)
QUANT_CASES = [((3, 5, 7, 3), None), ((5, 3, 4, 5), 2), ((2, 3, 3, 7), 1), ((3, 4, 4, 16), 2),
               ((2, 3, 5, 64), None), ((2, 2, 3, 130), 1), ((3, 2, 2, 424), 2),
               ((1000, 16, 16, 256), None), ((1000, 8, 8, 424), 7)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,act_group", QUANT_CASES, ids=str)
def test_act_quant_cuda_kernel_gives_the_plain_versions_bytes(cuda, shape, act_group):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=cuda)
    x = x * (0.25 + 2 * torch.rand((shape[0], 1, 1, 1), generator=gen, device=cuda))
    amax = f8.act_absmax(x, act_group)
    before = f8.launches["act_quant"]
    got = f8.act_quant(x, amax, act_group)
    torch.cuda.synchronize()
    assert f8.launches["act_quant"] == before + 1
    assert torch.equal(got, f8.act_quant_plain(x, amax, act_group))
    assert torch.equal(f8.act_quant(x, amax, act_group), got)
    # on a rounding boundary: 2.5 and 3.5 steps round to the even 2 and 4
    xb = torch.zeros((2, 1, 2, 6), device=cuda)
    xb[0, 0, 0] = torch.tensor([15.875, 0.3125, -0.3125, 0.4375, 0.0625, -15.875])
    xb[1, 0, 1, :5] = torch.tensor([7.9375, 0.15625, 0.21875, -0.21875, 2.0 ** -24])
    ab = f8.act_absmax(xb, 1)
    qb = f8.act_quant(xb, ab, 1)
    assert torch.equal(qb, f8.act_quant_plain(xb, ab, 1))
    assert qb[0, 0, 0, :6].tolist() == [127, 2, -2, 4, 0, -127]
    assert qb[1, 0, 1, :5].tolist() == [127, 2, 4, -4, 0]


# the absmax pass at the CPU replay's shapes (odd H*W*C, groups that start
# inside a 16-byte word, groups shorter than a word, a short last group,
# several blocks a group) and at a 1000-draw decode layer's (262 MB)
ABSMAX_CASES = [((5, 3, 5, 7), None), ((5, 3, 5, 7), 2), ((5, 3, 5, 7), 1), ((6, 1, 1, 3), 1),
                ((5, 1, 1, 1), 2), ((7, 2, 3, 2), 3), ((3, 16, 16, 53), None),
                ((3, 16, 16, 53), 1), ((4, 16, 16, 16), 3), ((4, 32, 32, 16), 2),
                ((1000, 16, 16, 256), None), ((1000, 8, 8, 424), 7)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,act_group", ABSMAX_CASES, ids=str)
def test_act_absmax_cuda_kernel_equals_plain(cuda, shape, act_group):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=cuda)
    x = x * (0.25 + 2 * torch.rand((shape[0], 1, 1, 1), generator=gen, device=cuda))
    before = f8.launches["act_absmax"]
    got = f8.act_absmax(x, act_group)
    torch.cuda.synchronize()
    assert f8.launches["act_absmax"] == before + 1
    assert torch.equal(got, f8.act_absmax_plain(x, act_group))
    # an offset view: the wrapper copies it to 16-byte alignment
    x2 = x.reshape(-1)[1:1 + x.numel() - x[0].numel()].view((shape[0] - 1,) + shape[1:]) \
        if shape[0] > 1 else x
    assert torch.equal(f8.act_absmax(x2, act_group), f8.act_absmax_plain(x2, act_group))


@pytest.mark.gpu
def test_int8_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, kern, s, t = _inputs("fused_conv3x3_bn_relu", (1, 4, 4, 3), 2, 0, cuda)
    kq, ks = qz.quantize_rtn(kern)
    with pytest.raises(TypeError):
        f8.int8_conv3x3_bn_relu(x.double(), kq, ks, s, t)
    with pytest.raises(ValueError):
        f8.int8_conv3x3_bn_relu(x.transpose(1, 2), kq, ks, s, t)
    with pytest.raises(ValueError):
        f8.int8_conv3x3_bn_relu(x, kq.cpu(), ks, s, t)
    with pytest.raises(ValueError):
        f8.int8_conv3x3_bn_relu(x, kq, ks, s, t, packed=f8.pack_kernel_q(kq)[:, :1])
    with pytest.raises(ValueError):  # ceil(C / 4) words a tap, not round_up(C, 16) / 4
        f8.int8_conv3x3_bn_relu(x, kq, ks, s, t, packed=f8.pack_kernel_q(kq)[:9])
    with pytest.raises(ValueError):  # one scale per group
        f8.act_quant(x, f8.act_absmax(x, 1)[:0], 1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 3, 5, 7), (4, 4, 424, 256), (1000, 3)])
def test_quantizer_cuda_kernel_gives_the_plain_versions_bytes(cuda, shape):
    w = torch.tensor(np.random.default_rng(sum(shape)).standard_normal(shape) * 0.3,
                     dtype=torch.float32, device=cuda)
    before = qz.launches["quantize_stochastic"]
    q, s = qz.quantize_stochastic(w, seed=(9 << 32) | 1234)
    torch.cuda.synchronize()
    assert qz.launches["quantize_stochastic"] == before + 2  # the tree of one leaf
    q_plain, s_plain = qz.quantize_stochastic_plain(w, seed=(9 << 32) | 1234)
    assert torch.equal(q, q_plain) and torch.equal(s, s_plain)
    # the same bytes as on the CPU, and other bytes for another seed
    q_cpu, s_cpu = qz.quantize_stochastic(w.cpu(), seed=(9 << 32) | 1234)
    assert torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)
    assert not torch.equal(qz.quantize_stochastic(w, seed=5)[0], q)
    assert float((q.float() - w / s).abs().max()) < 1.0
    # a whole tree in one call: the decoder of a small model, this leaf, a
    # NaN and an infinity in a channel, a zero channel, an empty leaf and
    # more leaves than one table holds, each leaf the plain version's bytes
    model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=16), device=cuda).init_weights(2)
    leaves = [(mod.kernel.detach(), qz.leaf_seed(3, path + ("kernel",)))
              for path, mod in qz._conv_modules(model)]
    odd = w.clone().reshape(-1, w.shape[-1])
    odd[0, 0], odd[-1, -1] = float("nan"), float("-inf")
    if odd.shape[-1] > 2:
        odd[:, 1] = 0.0
    leaves += [(w, 11), (odd, 12), (torch.zeros((3, 3, 4, 0), device=cuda), 13)]
    leaves += [(w[..., :1] * (i + 1), 20 + i) for i in range(qz.TABLE_LEAVES)]
    live = sum(leaf.numel() > 0 for leaf, _ in leaves)
    before = qz.launches["quantize_stochastic"]
    got = qz.quantize_leaves(leaves)
    torch.cuda.synchronize()
    assert qz.launches["quantize_stochastic"] == before + 2 * -(-live // qz.TABLE_LEAVES)
    for (leaf, seed), (q, s) in zip(leaves, got):
        q_plain, s_plain = qz.quantize_stochastic_plain(leaf, seed)
        assert torch.equal(q, q_plain) and torch.equal(s, s_plain), tuple(leaf.shape)
    again = qz.quantize_leaves(leaves)
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(got, again))
    # quantize_params_tree: one call of two launches for the decoder's 18 leaves
    before = qz.launches["quantize_stochastic"]
    tree = qz.quantize_params_tree(model, seed=3)
    assert qz.launches["quantize_stochastic"] == before + 2
    for path, mod in qz._conv_modules(model):
        if any(c.startswith(qz.DECODER_PREFIXES) for c in path):
            node = tree
            for comp in path:
                node = node[comp]
            q_plain, s_plain = qz.quantize_stochastic_plain(
                mod.kernel.detach(), qz.leaf_seed(3, path + ("kernel",)))
            assert torch.equal(node["kernel_q"], q_plain) and torch.equal(node["kernel_s"], s_plain)


@pytest.mark.gpu
def test_int8_cuda_serving_matches_plain_path(cuda):
    model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=16)).init_weights(1)
    y = np.random.default_rng(12).random((3, 8, 8, 4)).astype(np.float32)
    f32 = SuperResolver(model, device="cuda", seed=0).super_resolve(y, seed=1)
    for mode in ("int8", "int8_weights"):
        sr = SuperResolver(model, device="cuda", seed=0, **{mode: True})
        f8.reset_launches()
        got = sr.super_resolve(y, seed=1)
        maps = sr.uncertainty(y[0], samples=20, chunk=8, seed=2)
        int8_ran = (f8.launches["int8_conv3x3_bn_relu"] > 0
                    and f8.launches["int8_convT4x4s2_bn_relu"] > 0)
        assert int8_ran == (mode == "int8")
        blocks.use_plain_path(sr.model)
        want = sr.super_resolve(y, seed=1)
        want_maps = sr.uncertainty(y[0], samples=20, chunk=8, seed=2)
        assert float((got - want).abs().max()) <= 2e-3
        assert float((maps["std"] - want_maps["std"]).abs().max()) <= 2e-3
        mse = float(((got - f32) ** 2).mean())
        assert 10 * math.log10(1.0 / max(mse, 1e-12)) > 30.0
    assert not qz.has_quant(model)


# (x shape, later channel widths): one, two and four layers; odd H, W and
# channel widths; a 40-channel input (K over several weight slots); the
# models' tails at a small batch; one image in many strips and 16 images in
# strips of 8 rows (seams inside an image, the rings wrapping); an image too
# wide for full rows (panels); a layer wider than one n tile (N = 136)
CHAIN_CASES = [
    ((2, 5, 7, 3), (6,)),
    ((3, 9, 11, 5), (7, 3)),
    ((2, 19, 23, 64), (64, 16, 16, 4)),
    ((1, 37, 21, 13), (18, 5, 9, 2)),
    ((1, 4, 4, 40), (24, 9)),
    ((2, 64, 64, 64), (64, 16, 16, 4)),
    ((3, 32, 32, 64), (64, 16, 16, 4)),
    ((5, 8, 8, 64), (64, 128, 128, 106)),
    ((3, 8, 8, 128), (128, 128, 128, 424)),
    ((1, 8, 8, 64), (64, 128, 128, 84)),
    ((1, 64, 64, 64), (64, 16, 16, 4)),
    ((16, 64, 64, 64), (64, 16, 16, 4)),
    ((4, 29, 30, 64), (64, 16, 16, 4)),
    ((1, 12, 200, 64), (64, 16, 16, 4)),
    ((1, 5, 6, 8), (136, 7)),
]


def _chain_inputs(shape, widths, seed, device):
    rng = np.random.default_rng(seed)
    chans = (shape[-1],) + tuple(widths)
    x = torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=device)
    ks = [torch.tensor(rng.standard_normal((3, 3, chans[i], chans[i + 1]))
                       / math.sqrt(9 * chans[i]), dtype=torch.float32, device=device)
          for i in range(len(widths))]
    bs = [torch.tensor(rng.standard_normal(c), dtype=torch.float32, device=device)
          for c in widths]
    return x, ks, bs


@pytest.mark.gpu
@pytest.mark.parametrize("case", CHAIN_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_chain_cuda_kernel_matches_plain(cuda, case):
    shape, widths = case
    x, ks, bs = _chain_inputs(shape, widths, seed=sum(shape) + len(widths), device=cuda)
    before = dict(fc.launches)
    got = fch.fused_conv3x3_chain(x, ks, bs)
    torch.cuda.synchronize()
    after = dict(fc.launches)
    assert after.pop(fc.CHAIN) == before.pop(fc.CHAIN) + 1 and after == before  # one launch
    want = fch.conv3x3_chain_plain(x, ks, bs)
    assert got.shape == want.shape == shape[:3] + (widths[-1],)
    plan = fch.plan_chain(*shape[:3], (shape[-1],) + widths)
    if shape[0] == 1 and shape[1] == 64:
        assert plan.strips > 1  # seams inside the image
    if shape[2] == 200:
        assert plan.panels > 1
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    assert torch.equal(fch.fused_conv3x3_chain(x, ks, bs), got)  # the same sums every run
    assert torch.equal(fch.fused_conv3x3_chain(x, ks, bs, plain=True), want)


@pytest.mark.gpu
def test_chain_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, ks, bs = _chain_inputs((1, 4, 4, 3), (5, 2), 0, cuda)
    with pytest.raises(TypeError):
        fch.fused_conv3x3_chain(x.double(), ks, bs)
    with pytest.raises(ValueError):
        fch.fused_conv3x3_chain(x.transpose(1, 2), ks, bs)
    with pytest.raises(ValueError):
        fch.fused_conv3x3_chain(x, [ks[0].cpu(), ks[1]], bs)
    with pytest.raises(RuntimeError, match="no backward"):
        fch.fused_conv3x3_chain(x, [ks[0].requires_grad_(), ks[1]], bs)


@pytest.mark.gpu
def test_chained_cuda_serving_matches_unchained_and_plain_path(cuda):
    model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=16)).init_weights(1)
    y = np.random.default_rng(12).random((3, 8, 8, 4)).astype(np.float32)
    base = SuperResolver(model, device="cuda", seed=0)
    want = base.super_resolve(y, seed=1)
    want_maps = base.uncertainty(y[0], samples=20, chunk=8, seed=2)
    for mode in ({}, {"int8_weights": True}, {"int8": True}):
        sr = SuperResolver(model, device="cuda", seed=0, chain=True, **mode)
        fc.reset_launches()
        got = sr.super_resolve(y, seed=1)
        # ey and dx tails; a W8A8 model (any int8 weight) chains no tail
        assert fc.launches[fc.CHAIN] == (0 if mode.get("int8") else 2)
        maps = sr.uncertainty(y[0], samples=20, chunk=8, seed=2)
        assert fc.launches[fc.CHAIN] == (0 if mode.get("int8") else 2 + 1 + 3)
        if not mode:
            assert float((got - want).abs().max()) <= 1e-4
            assert float((maps["std"] - want_maps["std"]).abs().max()) <= 1e-4
        blocks.use_plain_path(sr.model)
        count = fc.launches[fc.CHAIN]
        plain = sr.super_resolve(y, seed=1)
        assert fc.launches[fc.CHAIN] == count
        assert float((got - plain).abs().max()) <= (2e-3 if mode.get("int8") else 1e-4)
    assert not model.chain


@pytest.mark.gpu
def test_vae_and_srvae_cuda_paths_match_plain_path(cuda):
    rng = np.random.default_rng(21)
    vae = VAE(VAEConfig(cr=2.0, patch_size=16), device=cuda).init_weights(2)
    blocks.use_chain(vae)
    y = torch.tensor(rng.random((1, 16, 16, 4)), dtype=torch.float32, device=cuda)
    eps = torch.randn((10, vae.config.latent_dim), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(3))
    fc.reset_launches()
    got = sample_chunked(vae.eval(), y, samples=10, chunk=4, eps_z=eps)
    assert fc.launches[fc.CHAIN] == 1 + 3  # the encoder once, the decoder per chunk
    blocks.use_plain_path(vae)
    want = sample_chunked(vae, y, samples=10, chunk=4, eps_z=eps)
    blocks.use_plain_path(vae, False)
    assert got.shape == (10, 16, 16, 4) and float((got - want).abs().max()) <= 1e-4
    batch = (torch.tensor(rng.random((6, 16, 16, 4)), dtype=torch.float32, device=cuda),
             torch.tensor(rng.random((6, 32, 32, 4)), dtype=torch.float32, device=cuda))
    for model in (vae, SRVAE(CondSRVAEConfig(cr=2.0, patch_size=32), device=cuda).init_weights(4)):
        blocks.use_chain(model)
        plain = copy.deepcopy(model)
        blocks.use_plain_path(plain)
        tk, tp = Trainer(model, device=cuda), Trainer(plain, device=cuda)
        noise = tk.noise(6, tk._batch(batch)[0].shape[1:3],
                         torch.Generator(device=cuda).manual_seed(5))
        fc.reset_launches()
        grads, terms = tk.grads_and_terms(batch, noise)
        assert fc.launches[fc.CHAIN] == 0  # training runs conv by conv
        grads_p, terms_p = tp.grads_and_terms(batch, noise)
        for key in terms:
            assert abs(float(terms[key] - terms_p[key])) <= 1e-4 * abs(float(terms_p[key])) + 1e-6
        _assert_grads_close(grads, grads_p, 1e-3)
        val, val_p = tk.val_step(batch), tp.val_step(batch)
        assert fc.launches[fc.CHAIN] == (2 if model is vae else 4)
        for key in val:
            assert abs(float(val[key] - val_p[key])) <= 1e-4 * abs(float(val_p[key])) + 1e-6


# ----------------------------------------------------------------- bfloat16
# The bfloat16 instances of #1, #5 and #6 at the edge paths of their loaders:
# C % 8 == 0 (16-byte copies) beside C % 8 != 0 (plain 2-byte loads: C = 53,
# 106, 4, 7, 12), O % 8 != 0 (O = 53, 13, 9, 4), odd H and W, M <= 64 with a
# K split and K not a multiple of 64, the canonical prior head. Bound: one
# bfloat16 ulp at the element plus 1e-4 of max|plain| (fc.compare_bf16).
BF16_CASES = TC_CASES + [
    ("fused_conv3x3_bn_relu", (2, 8, 8, 64), 64, True),
    ("fused_conv3x3_bn_relu", (2, 8, 8, 60), 64, True),
    ("fused_conv3x3_bn_relu", (3, 5, 7, 12), 9, False),
    ("fused_conv4x4s2_bn_relu", (2, 16, 16, 16), 64, True),
    ("fused_conv4x4s2_bn_relu", (2, 16, 16, 12), 64, True),
    ("fused_convT4x4s2_bn_relu", (2, 8, 8, 64), 16, True),
    ("fused_convT4x4s2_bn_relu", (2, 7, 5, 60), 16, False),
]


def _bf16_inputs(name, shape, o, seed, device):
    x, kern, s, t = _inputs(name, shape, o, seed, device)
    return x.bfloat16(), kern.bfloat16(), s, t


@pytest.mark.gpu
@pytest.mark.parametrize("case", BF16_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_bf16_kernel_matches_plain_in_both_roles(cuda, case):
    name, shape, o, relu = case
    x, kern, s, t = _bf16_inputs(name, shape, o, seed=sum(shape) + 3 * o, device=cuda)
    f32_before = {k: dict(v) for k, v in fc.role_launches.items()}
    before = fc.bf16_launches[name]["forward"]
    got = getattr(fc, name)(x, kern, s, t, relu=relu)
    torch.cuda.synchronize()
    assert fc.bf16_launches[name]["forward"] == before + 1
    assert got.dtype == torch.bfloat16
    want = fc.PLAIN[name](x, kern, s, t, relu)
    assert want.dtype == torch.bfloat16 and got.shape == want.shape
    assert fc.compare_bf16(got, want)["of_bound"] <= 1.0
    assert torch.equal(getattr(fc, name)(x, kern, s, t, relu=relu), got)  # the same bits
    site = fc.DX_KERNEL[name]
    in_shape = fc.output_shape(name, shape, o)
    before = fc.bf16_launches[name]["dx"]
    got = fc.input_grad(site, x, fc.flip_swap(kern), in_shape)
    torch.cuda.synchronize()
    assert fc.bf16_launches[name]["dx"] == before + 1
    want = fc.input_grad(site, x, fc.flip_swap(kern), in_shape, plain=True)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape == in_shape
    assert fc.compare_bf16(got, want)["of_bound"] <= 1.0
    assert torch.equal(fc.input_grad(site, x, fc.flip_swap(kern), in_shape), got)
    # a bfloat16 tensor never reaches the float32 kernel
    assert {k: dict(v) for k, v in fc.role_launches.items()} == f32_before


# conv_wg_bf16 (csrc/conv_wg.cu, bfloat16 #1, #5 and #6 on wgmma fed by TMA)
# at the CPU replay's ragged shapes: C % 64 != 0 (72, 200, 8, 424), O = 8, 24
# and 136, odd H and W (#5: an odd output grid), a batch not a multiple of
# the box's images, a row wider than one 128-pixel box (#5: a 128-wide
# output row, its strided box at TMA's 256-element limit)
WG_CASES = [
    ("fused_conv3x3_bn_relu", (3, 9, 11, 72), 24, True),
    ("fused_conv3x3_bn_relu", (2, 6, 7, 200), 8, False),
    ("fused_conv3x3_bn_relu", (11, 4, 4, 64), 136, True),
    ("fused_conv3x3_bn_relu", (3, 8, 8, 16), 64, False),
    ("fused_conv3x3_bn_relu", (1, 2, 130, 8), 16, True),
    ("fused_convT4x4s2_bn_relu", (3, 5, 6, 72), 24, False),
    ("fused_convT4x4s2_bn_relu", (11, 4, 4, 64), 8, True),
    ("fused_convT4x4s2_bn_relu", (3, 8, 8, 136), 136, True),
    ("fused_convT4x4s2_bn_relu", (3, 6, 8, 16), 128, False),
    ("fused_conv4x4s2_bn_relu", (3, 16, 16, 72), 24, True),
    ("fused_conv4x4s2_bn_relu", (11, 8, 8, 64), 136, True),
    ("fused_conv4x4s2_bn_relu", (2, 6, 10, 16), 8, False),
    ("fused_conv4x4s2_bn_relu", (1, 4, 256, 8), 16, True),
    ("fused_conv4x4s2_bn_relu", (3, 8, 8, 424), 8, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WG_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_wg_kernel_matches_plain(cuda, case):
    name, shape, o, relu = case
    x, kern, s, t = _bf16_inputs(name, shape, o, seed=sum(shape) + 5 * o, device=cuda)
    assert fc.wg_supported(name, x, kern)
    fc.reset_launches()
    got = fc.launch_bf16(name, "wg", x, kern, s, t, relu)
    torch.cuda.synchronize()
    want = fc.PLAIN[name](x, kern, s, t, relu)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert fc.compare_bf16(got, want)["of_bound"] <= 1.0
    assert torch.equal(fc.launch_bf16(name, "wg", x, kern, s, t, relu), got)  # the same bits
    assert fc.bf16_impl_launches[name]["forward"] == {"wg": 2, "tc": 0}
    assert fc.bf16_launches[name]["forward"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fused_conv3x3_bn_relu", "fused_convT4x4s2_bn_relu",
                                  "fused_conv4x4s2_bn_relu"])
def test_wg_routing_runs_conv_wg_in_both_roles(cuda, name):
    # a shape past the kernel's measured cut (operations, tiles, k-group
    # steps on the busiest block: fc.WG_CUTS) goes to conv_wg_bf16 through the
    # wrapper and through input_grad (of the conv whose adjoint it is: #5 is
    # the transposed conv's); one below it to conv_tc_bf16
    shape, o = {"fused_conv3x3_bn_relu": ((256, 16, 16, 128), 128),
                "fused_convT4x4s2_bn_relu": ((128, 16, 16, 128), 64),
                "fused_conv4x4s2_bn_relu": ((256, 32, 32, 64), 128)}[name]
    x, kern, s, t = _bf16_inputs(name, shape, o, seed=3, device=cuda)
    assert fc.wg_eligible(name, x, kern)
    fc.reset_launches()
    got = getattr(fc, name)(x, kern, s, t, relu=True)
    want = fc.PLAIN[name](x, kern, s, t, True)
    assert fc.compare_bf16(got, want)["of_bound"] <= 1.0
    assert fc.bf16_impl_launches[name]["forward"] == {"wg": 1, "tc": 0}
    site = fc.DX_KERNEL[name]  # the conv whose input gradient runs kernel `name`
    in_shape = fc.output_shape(name, shape, o)
    g = x  # a gradient of the site's pre-affine output has x's shape here
    got = fc.input_grad(site, g, fc.flip_swap(kern), in_shape)
    want = fc.input_grad(site, g, fc.flip_swap(kern), in_shape, plain=True)
    assert fc.compare_bf16(got, want)["of_bound"] <= 1.0
    assert fc.bf16_impl_launches[name]["dx"] == {"wg": 1, "tc": 0}
    small = x[:2].contiguous()
    assert not fc.wg_eligible(name, small, kern)
    getattr(fc, name)(small, kern, s, t, relu=True)
    assert fc.bf16_impl_launches[name]["forward"] == {"wg": 1, "tc": 1}


@pytest.mark.gpu
def test_wg_launch_refuses_what_it_does_not_take(cuda):
    x, kern, s, t = _bf16_inputs("fused_conv3x3_bn_relu", (2, 8, 8, 12), 16, 0, cuda)
    with pytest.raises(ValueError):  # C % 8 != 0
        fc.launch_bf16("fused_conv3x3_bn_relu", "wg", x, kern, s, t)
    x, kern, s, t = _bf16_inputs("fused_conv4x4s2_bn_relu", (2, 9, 8, 16), 16, 0, cuda)
    with pytest.raises(ValueError):  # #5 at an odd H (JAX #5 requires even H and W)
        fc.launch_bf16("fused_conv4x4s2_bn_relu", "wg", x, kern, s, t)
    with pytest.raises(ValueError):  # float32
        fc.launch_bf16("fused_conv3x3_bn_relu", "wg", x.float(),
                       kern.float()[:3, :3].contiguous(), s, t)


@pytest.mark.gpu
def test_bf16_wrapper_rejects_mixed_dtypes(cuda):
    x, kern, s, t = _bf16_inputs("fused_conv3x3_bn_relu", (1, 4, 4, 8), 8, 0, cuda)
    for args in ((x, kern.float(), s, t), (x.float(), kern, s, t), (x, kern, s.bfloat16(), t),
                 (x, kern, s, t.bfloat16()), (x.half(), kern.half(), s, t)):
        with pytest.raises(TypeError):
            fc.fused_conv3x3_bn_relu(*args)
    assert fc.fused_conv3x3_bn_relu(x, kern, s, t).dtype == torch.bfloat16


def _bf16_pair(device, kind="cond"):
    if kind == "vae":
        model = VAE(VAEConfig(cr=2.0, patch_size=8), device=device, dtype=torch.bfloat16)
    elif kind == "srvae":
        model = SRVAE(CondSRVAEConfig(cr=2.0, patch_size=16), device=device,
                      dtype=torch.bfloat16)
    else:
        model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=16), device=device,
                          dtype=torch.bfloat16)
    model.init_weights(4)
    plain = copy.deepcopy(model)
    blocks.use_plain_path(plain)
    return model, plain


@pytest.mark.gpu
def test_bf16_serving_matches_plain_path(cuda):
    model, plain = _bf16_pair(cuda)
    y = np.random.default_rng(15).random((3, 8, 8, 4)).astype(np.float32)
    sr, sr_p = SuperResolver(model, device="cuda", chain=True), SuperResolver(plain, device="cuda")
    fc.reset_launches()
    got = sr.super_resolve(y, seed=1)
    maps = sr.uncertainty(y[0], samples=20, chunk=8, seed=2)
    torch.cuda.synchronize()
    # every bfloat16 instance, the chain's included; no float32 kernel
    assert all(v["forward"] > 0 for v in fc.bf16_launches.values())
    assert fc.bf16_launches[fc.CHAIN]["forward"] == 2 + 1 + 3
    assert sum(fc.launches.values()) == 0
    want = sr_p.super_resolve(y, seed=1)
    want_maps = sr_p.uncertainty(y[0], samples=20, chunk=8, seed=2)
    assert got.dtype == maps["std"].dtype == torch.float32
    # outputs in [0, 1] through ~25 bfloat16 layers: a few bfloat16 ulps of 1
    assert float((got - want).abs().max()) <= 2e-2
    assert float((maps["mean"] - want_maps["mean"]).abs().max()) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "int8_weights", "chain"])
def test_bf16_quantized_and_chained_serving_match_plain_path(cuda, mode):
    """A bfloat16 model in each mode the JAX resolver serves it in: W8A8
    through the bfloat16 int8 instances (no float32 int8 launch), weights
    only through the bfloat16 #1/#5/#6 on the unpacked float32 parameters,
    chained through the chain's bfloat16 instance; against the plain path of
    the same resolver within the bfloat16 serving bound, and the int8 modes
    above 30 dB against the float32 resolver."""
    model, _ = _bf16_pair(cuda)
    y = np.random.default_rng(17).random((3, 8, 8, 4)).astype(np.float32)
    m32 = copy.deepcopy(model)
    blocks.set_dtype(m32, torch.float32)
    f32 = SuperResolver(m32, device="cuda").super_resolve(y, seed=1)
    sr = SuperResolver(model, device="cuda", seed=0, **{mode: True})
    fc.reset_launches()
    f8.reset_launches()
    got = sr.super_resolve(y, seed=1)
    maps = sr.uncertainty(y[0], samples=20, chunk=8, seed=2)
    torch.cuda.synchronize()
    assert sum(fc.launches.values()) == 0 and sum(f8.launches.values()) == 0
    if mode == "int8":
        assert all(f8.bf16_launches[k] > 0 for k in ("int8_conv3x3_bn_relu",
                                                     "int8_convT4x4s2_bn_relu", "act_absmax",
                                                     "act_quant"))
        assert fc.bf16_launches[fc.CHAIN]["forward"] == 0
    else:
        assert sum(f8.bf16_launches.values()) == 0
        assert (fc.bf16_launches[fc.CHAIN]["forward"] > 0) == (mode == "chain")
    blocks.use_plain_path(sr.model)
    want = sr.super_resolve(y, seed=1)
    want_maps = sr.uncertainty(y[0], samples=20, chunk=8, seed=2)
    assert got.dtype == maps["mean"].dtype == torch.float32
    assert float((got - want).abs().max()) <= 2e-2
    assert float((maps["mean"] - want_maps["mean"]).abs().max()) <= 2e-2
    if mode != "chain":
        mse = float(((got - f32) ** 2).mean())
        assert 10 * math.log10(1.0 / max(mse, 1e-12)) > 30.0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["cond", "srvae", "vae"])
def test_bf16_train_step_matches_plain_path(cuda, kind):
    """A bfloat16 step through the kernels against the plain path. A
    bfloat16 activation one ulp apart (the two sides round float32 sums
    taken in other orders) moves a gradient that cancels (a conv that
    BatchNorm follows) by far more than an ulp of it, so each leaf is held,
    as in ``chip_smoke.py``, to the noise rule: 2x its own bfloat16 error
    (the plain path in float32 against the plain path in bfloat16) plus
    1e-3 of its block's largest gradient."""
    model, plain = _bf16_pair(cuda, kind)
    f32 = copy.deepcopy(plain)
    blocks.set_dtype(f32, torch.float32)
    cfg = TrainConfig(use_bfloat16=True, bf16_moments=True)
    kernels, plain = Trainer(model, cfg, device=cuda), Trainer(plain, cfg, device=cuda)
    rng = np.random.default_rng(16)
    batch = (torch.tensor(rng.random((6, 8, 8, 4)), dtype=torch.float32, device=cuda),
             torch.tensor(rng.random((6, 16, 16, 4)), dtype=torch.float32, device=cuda))
    eps = kernels.noise(6, (8, 8), torch.Generator(device=cuda).manual_seed(1))
    fc.reset_launches()
    grads, terms = kernels.grads_and_terms(batch, eps)
    torch.cuda.synchronize()
    assert all(fc.bf16_launches[k]["forward"] > 0 and fc.bf16_launches[k]["dx"] > 0
               for k in fc.TC_KERNELS)
    assert sum(fc.launches.values()) == 0
    before = {k: dict(v) for k, v in fc.bf16_launches.items()}
    grads_p, terms_p = plain.grads_and_terms(batch, eps)
    grads_f, terms_f = Trainer(f32, TrainConfig(), device=cuda).grads_and_terms(batch, eps)
    assert {k: dict(v) for k, v in fc.bf16_launches.items()} == before  # plain: no launch
    assert all(g.dtype == torch.float32 for g in grads.values())
    for key in terms:
        noise = abs(float(terms_f[key] - terms_p[key]))
        assert abs(float(terms[key] - terms_p[key])) <= 2 * noise + 1e-3 * abs(float(
            terms_p[key])), key
    block_max = {}
    for name, g in grads_p.items():
        blk = name.split(".")[0]
        block_max[blk] = max(block_max.get(blk, 0.0), float(g.abs().max()))
    for name, g in grads.items():
        err = float((g - grads_p[name]).abs().max())
        noise = float((grads_f[name] - grads_p[name]).abs().max())
        assert err <= 2 * noise + 1e-3 * block_max[name.split(".")[0]], (name, err, noise)
    kernels.apply_grads(grads, 1e-4)
    assert all(m.dtype == torch.bfloat16 for m in kernels.opt.mu)


# The bfloat16 int8 instances (the absmax and quantize passes and int8_tc with
# a bfloat16 output) at the float32 cases' shapes: ragged C on the masked
# 2-byte loads (3, 5, 7, 130), odd O (element stores), K splits in all three
# modes (the reduce's stores), the convT's phase rows; bit for bit.
@pytest.mark.gpu
@pytest.mark.parametrize("case", INT8_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bf16_int8_cuda_kernel_matches_plain(cuda, case):
    name, shape, o, relu, group = case
    x, kern, s, t = _inputs(f8.float_name(name), shape, o, seed=sum(shape) + o + 1, device=cuda)
    x = (x * torch.linspace(0.3, 2.0, shape[0], device=cuda).view(-1, 1, 1, 1)).bfloat16()
    kq, ks = qz.quantize_rtn(kern)
    before, f32_before = dict(f8.bf16_launches), dict(f8.launches)
    got = f8.WRAPPERS[name](x, kq, ks, s, t, relu=relu, act_group=group)
    amax = f8.act_absmax(x, group)
    qx = f8.act_quant(x, amax, group)
    torch.cuda.synchronize()
    assert f8.bf16_launches[name] == before[name] + 1
    assert f8.bf16_launches["act_absmax"] == before["act_absmax"] + 2
    assert f8.bf16_launches["act_quant"] == before["act_quant"] + 2
    assert f8.launches == f32_before  # a bfloat16 tensor never reaches a float32 instance
    want = f8.PLAIN[name](x, kq, ks, s, t, relu, group)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, want)  # exact int32 sums, one rounding of the same epilogue
    assert amax.dtype == torch.float32 and torch.equal(amax, f8.act_absmax_plain(x, group))
    assert torch.equal(qx, f8.act_quant_plain(x, amax, group))
    assert torch.equal(f8.WRAPPERS[name](x, kq, ks, s, t, relu=relu, act_group=group), got)


def _bf16_chain_check(x, ks, bs):
    """The bfloat16 chain against its plain version: each layer (a launch of
    the chain's first l layers: a layer's sums do not depend on the plan)
    within one ulp of the plain layer on the kernel's own input, the whole
    chain by the noise rule; the same bits on a second launch."""
    xb, kb = x.bfloat16(), [k.bfloat16() for k in ks]
    before = fc.bf16_launches[fc.CHAIN]["forward"]
    got = fch.fused_conv3x3_chain(xb, kb, bs)
    torch.cuda.synchronize()
    assert fc.bf16_launches[fc.CHAIN]["forward"] == before + 1 and got.dtype == torch.bfloat16
    assert torch.equal(fch.fused_conv3x3_chain(xb, kb, bs), got)
    h = xb
    for l in range(len(ks)):
        layer = fch.fused_conv3x3_chain(xb, kb[:l + 1], bs[:l + 1])
        want_l = fch.conv3x3_chain_plain(h, kb[l:l + 1], bs[l:l + 1])
        assert fc.compare_bf16(layer, want_l)["of_bound"] <= 1.0, l
        h = layer
    assert torch.equal(h, got)
    want = fch.conv3x3_chain_plain(xb, kb, bs)
    noise = float((want.float() - fch.conv3x3_chain_plain(x, ks, [b for b in bs])).abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2 * noise + TOL * float(want.float().abs().max()), (err, noise)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("case", CHAIN_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_bf16_chain_cuda_kernel_matches_plain(cuda, case):
    shape, widths = case
    x, ks, bs = _chain_inputs(shape, widths, seed=sum(shape) + len(widths) + 1, device=cuda)
    f32_before = dict(fc.launches)
    got = _bf16_chain_check(x, ks, bs)
    assert fc.launches == f32_before and got.shape == shape[:3] + (widths[-1],)
    plan = fch.plan_chain(*shape[:3], (shape[-1],) + widths, 2)
    assert plan.smem_bytes <= fch.SMEM_BYTES


@pytest.mark.gpu
def test_cuda_fit_checkpoint_resume_and_serving(cuda, tmp_path):
    """A short fit on the card through the kernels, with a checkpoint; the
    checkpoint served by ``from_checkpoint`` gives the trained model's bits;
    a fresh trainer loaded from it runs epoch 2 to the same bits as the
    trainer that goes on (cuDNN's weight gradients held deterministic for
    the comparison); ``remat`` moves the running statistics once."""
    from simple_vae_rs_tpu_torch.train.callbacks import ModelCheckpoint
    from simple_vae_rs_tpu_torch.train.checkpoint import load_checkpoint

    rng = np.random.default_rng(21)
    batches = [(torch.tensor(rng.random((4, 16, 16, 4)), dtype=torch.float32, device=cuda),
                torch.tensor(rng.random((4, 32, 32, 4)), dtype=torch.float32, device=cuda))
               for _ in range(2)]
    cfg = CondSRVAEConfig(cr=2.0, patch_size=32)
    ckpt = ModelCheckpoint("job", str(tmp_path), monitor="Loss/val_loss")
    trainer = Trainer(CondSRVAE(cfg, device=cuda).init_weights(0), TrainConfig(), device=cuda,
                      callbacks=[ckpt])
    fc.reset_launches()
    fe.reset_launches()
    trainer.pretrain_lr_branch(batches, 1)
    trainer.fit(batches, batches[:1], epochs=1, val_metrics_every=1)
    torch.cuda.synchronize()
    assert all(v > 0 for k, v in fc.launches.items() if k != fc.CHAIN)
    assert all(v > 0 for v in fe.launches.values())
    assert ckpt.best_epoch == 1
    y = batches[0][0]
    served = SuperResolver.from_checkpoint(str(tmp_path / "job"), seed=3)
    assert served.device.type == "cuda"
    want = SuperResolver(trainer.model, device=cuda, seed=3)
    assert torch.equal(served.super_resolve(y, seed=4), want.super_resolve(y, seed=4))

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        resumed = Trainer(CondSRVAE(cfg, device=cuda), TrainConfig(), device=cuda)
        meta = load_checkpoint(str(tmp_path / "job"), resumed)
        resumed.fit(batches, batches[:1], epochs=2, start_epoch=meta["epoch"] + 1)
        trainer.fit(batches, batches[:1], epochs=2, start_epoch=2)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for name, t in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], t), name
    assert all(torch.equal(a, b) for a, b in zip(trainer.opt.mu, resumed.opt.mu))

    stats = {}
    for remat in (False, True):
        model = CondSRVAE(cfg, device=cuda).init_weights(1)
        Trainer(model, TrainConfig(remat=remat), device=cuda, seed=2).train_step(batches[0])
        stats[remat] = dict(model.named_buffers())
    for name, t in stats[False].items():
        assert torch.equal(stats[True][name], t), name


def _int16_tree(root, n, lr_px, seed):
    """An ARM-shaped tree of int16 DN tiles (LZW with the predictor) and its
    index.csv, written with the port's own TIFF writer."""
    import os

    from simple_vae_rs_tpu_torch.data.tiffio import write_tiff

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = ["b2b3b4b8_10m\tb2b3b4b8_05m"]
    for i in range(n):
        lr = (rng.random((lr_px, lr_px, 4)) * 9000).astype(np.int16)
        hr = (rng.random((2 * lr_px, 2 * lr_px, 4)) * 9000).astype(np.int16)
        write_tiff(os.path.join(root, f"lr_{i}.tif"), lr, compression="lzw", predictor=True)
        write_tiff(os.path.join(root, f"hr_{i}.tif"), hr, compression="lzw", predictor=True)
        rows.append(f"lr_{i}.tif\thr_{i}.tif")
    with open(os.path.join(root, "index.csv"), "w") as fh:
        fh.write("\n".join(rows))
    return root


@pytest.mark.gpu
@pytest.mark.parametrize("crop", ["grid", "random"])
def test_loader_pinned_batches_equal_its_cpu_batches(cuda, tmp_path, crop):
    """Three epochs from disk with four decode threads and two batches in
    flight: the card's batches (pinned host tensors, non-blocking copies,
    crop and normalization on the card) equal the same loader's on the CPU,
    bit for bit; so no pinned buffer was refilled under its copy."""
    from simple_vae_rs_tpu_torch.data.loader import init_dataloader

    root = _int16_tree(str(tmp_path / "ARM"), 20, 64, seed=31)
    loaders = {dev: init_dataloader("s2v", 4, 64, crop=crop, data_root=root, seed=2,
                                    workers=4, device=dev, timing=True)
               for dev in ("cpu", "cuda")}
    for _ in range(3):
        for split in (0, 1):
            got = [tuple(t.clone() for t in b) for b in loaders["cuda"][split]]
            want = list(loaders["cpu"][split])
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g[0].is_cuda and g[0].dtype == torch.float32
                assert all(torch.equal(a.cpu(), b) for a, b in zip(g, w))
    t = loaders["cuda"][0].timings()
    assert t["batches"] == 3 * 4 and t["h2d_ms"] > 0 and t["crop_ms"] > 0


@pytest.mark.gpu
def test_cli_one_epoch_on_the_card(cuda, tmp_path, monkeypatch):
    """``python -m simple_vae_rs_tpu_torch.cli`` at a small size on the card:
    one epoch from an int16 tree on disk through the kernels, a checkpoint,
    the task's PNG-free report and a finite MMSE."""
    import os

    from simple_vae_rs_tpu_torch import cli

    root = _int16_tree(str(tmp_path / "ARM"), 10, 32, seed=32)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SLURM_JOB_ID", "gpu")
    fc.reset_launches()
    fe.reset_launches()
    out = cli.main(cli.parse_args(
        ["--dataset", "s2v", "--data_root", root, "--crop", "grid", "--batch_size", "2",
         "--patch_size", "32", "-cr", "2", "--epochs", "1", "--pre_epochs", "1",
         "--val_metrics_every", "1", "--samples", "16", "--workers", "2"]))
    torch.cuda.synchronize()
    assert out["trainer"].device.type == "cuda" and out["start_epoch"] == 1
    assert math.isfinite(out["task"]["mmse"])
    assert os.path.exists(tmp_path / "ckpt" / "gpu.pt")
    assert all(v > 0 for k, v in fc.launches.items() if k != fc.CHAIN)
    assert all(v > 0 for v in fe.launches.values())


@pytest.mark.gpu
def test_cuda_tile_requests_match_plain_path(cuda):
    """Whole-raster requests on the card: ``super_resolve_tile`` and
    ``uncertainty_tile`` through the kernels (every conv kernel launched)
    against the plain path on the same seed, 1e-4 absolute; a seeded repeat
    the same bits; a row sweep resumed at a middle band the same bits as
    the uninterrupted one."""
    model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=16)).init_weights(1)
    sr = SuperResolver(model, device="cuda", seed=0)
    raster = np.random.default_rng(13).random((37, 45, 4)).astype(np.float32) * 900
    fc.reset_launches()
    got = sr.super_resolve_tile(raster, batch=8, seed=1)
    maps = sr.uncertainty_tile(raster, samples=4, batch=8, seed=2)
    assert all(v > 0 for k, v in fc.launches.items() if k != fc.CHAIN)
    assert got.shape == (74, 90, 4) and isinstance(got, np.ndarray)
    assert np.array_equal(got, sr.super_resolve_tile(raster, batch=8, seed=1))
    lr = raster / raster.max()
    rows = lambda band: np.concatenate([b for _, b in sr.iter_tile_rows(
        lambda a, b: lr[a:b], 37, 45, batch=8, seed=3, start_band=band)])
    whole = rows(0)
    starts = [r for r, _ in sr.iter_tile_rows(lambda a, b: lr[a:b], 37, 45, batch=8, seed=3)]
    assert np.array_equal(rows(2), whole[starts[2]:])
    blocks.use_plain_path(sr.model)
    want = sr.super_resolve_tile(raster, batch=8, seed=1)
    want_maps = sr.uncertainty_tile(raster, samples=4, batch=8, seed=2)
    assert float(np.abs(got - want).max()) <= 1e-4
    for k in ("mean", "variance"):
        assert float(np.abs(maps[k] - want_maps[k]).max()) <= 1e-4, k


@pytest.mark.gpu
def test_cuda_server_round_trip(cuda):
    """The port's server on the card, driven by the port's client: a seeded
    request over the float32 npy wire is the in-process call's bits; over
    the u16 wire within its step; a tile stitched by the server equals the
    same request stitched by ``RemoteResolver``."""
    import threading

    from simple_vae_rs_tpu_torch.client import Client
    from simple_vae_rs_tpu_torch.server import make_server

    model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=16)).init_weights(1)
    sr = SuperResolver(model, device="cuda", seed=0)
    srv = make_server(sr, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        y = np.random.default_rng(14).random((16, 8, 8, 4)).astype(np.float32)
        local = sr.super_resolve(y, seed=5).cpu().numpy()
        assert np.array_equal(Client(url, timeout=60).super_resolve(y, seed=5), local)
        u16 = Client(url, timeout=60, wire="u16").super_resolve(y, seed=5)
        assert np.abs(u16 - local).max() <= 1.0 / 65535
        c = Client(url, timeout=60)
        raster = np.random.default_rng(15).random((29, 33, 4)).astype(np.float32)
        rr = c.resolver()
        try:
            assert np.array_equal(rr.super_resolve_tile(raster, batch=8, seed=6),
                                  c.super_resolve_tile(raster, batch=8, seed=6))
        finally:
            rr.close()
        assert c.health()["status"] == "ok"
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.gpu
def test_cuda_streamed_raster_resumes_bit_equal(cuda, tmp_path, monkeypatch):
    """``python -m simple_vae_rs_tpu_torch.raster --stream --resume`` on the
    card: a sweep that fails after a few bands, resumed from its journal,
    writes the bytes of an uninterrupted sweep."""
    import os

    from simple_vae_rs_tpu_torch import raster
    from simple_vae_rs_tpu_torch.data import tiffio
    from simple_vae_rs_tpu_torch.train.checkpoint import save_checkpoint

    tr = Trainer(CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=16), device=cuda).init_weights(1),
                 TrainConfig(), device=cuda)
    ck = str(tmp_path / "tiny")
    save_checkpoint(ck, tr, epoch=1, extra={"model": tr._model_meta()})
    lr = (np.random.default_rng(16).random((60, 44, 4)) * 3000).astype(np.int16)
    src = str(tmp_path / "lr.tif")
    tiffio.write_tiff(src, lr, compression="lzw", predictor=True)
    flags = ["--model_ckpt", ck, "--stream", "--uncertainty", "--samples", "3", "--batch", "8",
             "--request_seed", "7"]
    full, part = str(tmp_path / "full.tif"), str(tmp_path / "part.tif")
    raster.main([src, full, *flags])
    real, calls = tiffio.TiffStripWriter.write_rows, {"n": 0}

    def bomb(self, block):
        calls["n"] += 1
        if calls["n"] > 5:
            raise RuntimeError("simulated crash")
        return real(self, block)

    monkeypatch.setattr(tiffio.TiffStripWriter, "write_rows", bomb)
    with pytest.raises(RuntimeError, match="simulated crash"):
        raster.main([src, part, *flags, "--resume"])
    monkeypatch.setattr(tiffio.TiffStripWriter, "write_rows", real)
    assert os.path.exists(part + ".resume.json")
    raster.main([src, part, *flags, "--resume"])
    for a, b in ((full, part), (full[:-4] + "_std.tif", part[:-4] + "_std.tif")):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def _every_launch():
    """The sum of every kernel launch counter of the port (float32 and
    bfloat16 conv kernels, the chain, the int8 kernels and passes, the
    quantizer, the ELBO rows)."""
    counts = [*fc.launches.values(), *f8.launches.values(), *f8.bf16_launches.values(),
              *qz.launches.values(), *fe.launches.values()]
    counts += [n for roles in fc.bf16_launches.values() for n in roles.values()]
    return sum(counts)


@pytest.mark.gpu
def test_cuda_artifact_matches_plain_path_and_launches_no_kernel(cuda, tmp_path):
    """An f32 artifact (``export.py``, traced on the host) loaded on the
    card: CUDA outputs within 1e-4 of the live resolver's plain path on the
    same seed, and no hand-written kernel launched (the artifact is the
    plain graph, as the JAX artifact carries no Pallas call)."""
    from simple_vae_rs_tpu_torch.export import export_resolver, load_exported

    model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=16)).init_weights(1)
    path = export_resolver(SuperResolver(model, device="cpu"), str(tmp_path / "m.pt2"), batch=8)
    esr = load_exported(path)  # on the card by default
    y = np.random.default_rng(17).random((11, 8, 8, 4)).astype(np.float32) * 900
    fc.reset_launches(), f8.reset_launches(), qz.reset_launches(), fe.reset_launches()
    got = esr.super_resolve(y, seed=5)
    moments = esr.super_resolve_moments(y[:8], 3, seed=6)
    torch.cuda.synchronize()
    assert _every_launch() == 0
    assert got.is_cuda and all(m.is_cuda for m in moments)
    sr = SuperResolver(model, device="cuda", seed=0)
    blocks.use_plain_path(sr.model)
    assert float((got - sr.super_resolve(y, seed=5)).abs().max()) <= TOL
    for g, w in zip(moments, sr.super_resolve_moments(y[:8], 3, seed=6)):
        assert float((g - w).abs().max()) <= 3 * TOL * max(1.0, float(w.abs().max()))
