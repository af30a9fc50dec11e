"""The port's sequence and attention ops (``ops/attention.py``,
``ops/sequences.py``) and the flagged ``DownBlock``/``UpBlock`` against the
JAX package's, on JAX's weights (``utils/jax_weights``), in float32 on the
CPU, in training mode (batch statistics, the running ones updated) and in
eval mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_vae_rs_tpu.ops import conv_blocks as jblocks
from simple_vae_rs_tpu.ops import sequences as jseq
from simple_vae_rs_tpu.ops.attention import SelfAttention2D as JSelfAttention2D
from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.ops import sequences as tseq
from simple_vae_rs_tpu_torch.ops import tiling as ttiling
from simple_vae_rs_tpu_torch.ops.attention import SelfAttention2D
from simple_vae_rs_tpu_torch.utils.jax_weights import _flatten, load_jax_variables
from tests.test_torch_port_conv import _random_bn
from tests.test_torch_port_tiling import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-4, 2e-5


def _x(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _init(module, x, seed, **kw):
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), **kw)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    return _random_bn(variables, seed + 1) if "batch_stats" in variables else variables


def _both_modes(jmod, tmod, variables, x, train_kw=True):
    """The port module against the JAX one on ``variables`` in training mode
    (output and new running statistics) and in eval mode."""
    load_jax_variables(tmod, variables)
    kw = {"train": True} if train_kw else {}
    if "batch_stats" in variables:
        want, new = jmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"], **kw)
    else:
        want, new = jmod.apply(variables, jnp.asarray(x), **kw), {}
    tmod.train()
    got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    buffers = dict(tmod.named_buffers())
    for name, w in _flatten(new.get("batch_stats", {})).items():
        np.testing.assert_allclose(buffers[name].numpy(), w, rtol=RTOL, atol=1e-6, err_msg=name)
    load_jax_variables(tmod, variables)  # the statistics before the training pass
    want = jmod.apply(variables, jnp.asarray(x), **({"train": False} if train_kw else {}))
    tmod.eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ planners
@pytest.mark.parametrize("case", [((32, 32, 4), 2.0, None), ((16, 16, 4), 4.0, None),
                                  ((64, 32, 3), 1.5, 2), ((8, 8, 4), 3.0, 3),
                                  ((12, 12, 4), 2.0, None), ((6, 6, 4), 2.0, 2)])
def test_plan_downsample_matches_jax(case):
    try:
        want = jseq.plan_downsample(*case)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tseq.plan_downsample(*case)
        assert str(got.value) == str(e)
        return
    assert tseq.plan_downsample(*case) == want


@pytest.mark.parametrize("case", [(512, (16, 16, 4), None), (1024, (32, 32, 4), None),
                                  (48, (8, 8, 3), None), (7, (16, 16, 4), None),
                                  (1024, (16, 16, 4), None), (64, (16, 16, 4), 2),
                                  (5, (6, 6, 4), None), (100, (16, 16, 4), 1)])
def test_plan_upsample_matches_jax_and_refuses_what_it_refuses(case):
    try:
        want = jseq.plan_upsample(*case)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tseq.plan_upsample(*case)
        assert str(got.value) == str(e)
        return
    assert tseq.plan_upsample(*case) == want


def test_upsample_rejects_impossible():
    with pytest.raises(ValueError, match="admits no square grid"):
        tseq.plan_upsample(5, (6, 6, 4), None)  # no grid of 6x6/3x3 divides 5


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("features, heads", [(8, 2), (16, 8), (4, 4)])
def test_self_attention_matches_jax(features, heads):
    x = _x((2, 4, 6, features), features + heads)
    jmod = JSelfAttention2D(features, num_heads=heads)
    variables = _init(jmod, x, 3)
    _both_modes(jmod, SelfAttention2D(features, num_heads=heads), variables, x, train_kw=False)


def test_self_attention_refuses_uneven_heads():
    with pytest.raises(ValueError, match="divisible by num_heads"):
        SelfAttention2D(6, num_heads=4)


# ------------------------------------------------------------ flagged blocks
@pytest.mark.parametrize("with_relu, with_bn", [(True, True), (False, True), (True, False),
                                                (False, False)])
@pytest.mark.parametrize("kind", ["down", "up"])
def test_flagged_blocks_match_jax(kind, with_relu, with_bn):
    x = _x((2, 8, 8, 6), 5)
    jcls, tcls = ((jblocks.DownBlock, blocks.DownBlock) if kind == "down"
                  else (jblocks.UpBlock, blocks.UpBlock))
    jmod = jcls(6, 10, with_relu=with_relu, with_bn=with_bn)
    variables = _init(jmod, x, 7, train=False)
    assert ("bn" in variables["params"]) == with_bn
    tmod = tcls(6, 10, with_relu=with_relu, with_bn=with_bn)
    assert hasattr(tmod, "bn") == with_bn
    _both_modes(jmod, tmod, variables, x)


@pytest.mark.parametrize("kind", ["down", "up"])
def test_flagged_eval_tails_run_the_fused_tail_kernel(kind, monkeypatch):
    """Without BatchNorm the eval tail is still one fused-kernel call (#5 or
    #6) with ``(scale, shift) = (1, bias)``, its ReLU as the flag says."""
    calls = []
    real = fc.fused_conv

    def spy(name, x, kernel, scale, shift, relu, plain=False):
        calls.append((name, bool(relu), scale, shift))
        return real(name, x, kernel, scale, shift, relu, plain)

    monkeypatch.setattr(blocks.fc, "fused_conv", spy)
    cls, tail_kernel = ((blocks.DownBlock, "fused_conv4x4s2_bn_relu") if kind == "down"
                        else (blocks.UpBlock, "fused_convT4x4s2_bn_relu"))
    for with_relu in (True, False):
        mod = cls(4, 8, with_relu=with_relu, with_bn=False)
        blocks.reset_parameters(mod, np.random.default_rng(0))
        mod.eval()
        calls.clear()
        with torch.no_grad():
            mod(torch.rand(1, 8, 8, 4))
        (tail,) = [c for c in calls if c[0] == tail_kernel]
        tail_mod = mod.downsample if kind == "down" else mod.upsample
        assert tail[1] == with_relu
        assert torch.equal(tail[2], torch.ones(8)) and torch.equal(tail[3], tail_mod.bias)


# ---------------------------------------------------------------- sequences
@pytest.mark.parametrize("attention", [False, True])
def test_downsample_sequence_matches_jax(attention):
    shape = (16, 16, 4)
    x = _x((2,) + shape, 11)
    jmod = jseq.DownsampleSequence(in_shape=shape, compression_ratio=4.0,
                                   with_attention=attention)
    variables = _init(jmod, x, 13, train=False)
    variables.pop("intermediates", None)
    tmod = tseq.DownsampleSequence(shape, 4.0, with_attention=attention)
    assert tmod.out_size == jmod.out_size
    assert ("attn0" in variables["params"]) == attention == hasattr(tmod, "attn0")
    _both_modes(jmod, tmod, variables, x)


@pytest.mark.parametrize("in_size, out_shape", [(512, (16, 16, 4)), (48, (8, 8, 3)),
                                                (1024, (16, 16, 4)), (7, (8, 8, 4))])
def test_upsample_sequence_matches_jax(in_size, out_shape):
    z = _x((2, in_size), in_size) - 0.5
    jmod = jseq.UpsampleSequence(in_size=in_size, out_shape=out_shape)
    variables = _init(jmod, z, 17, train=False)
    tmod = tseq.UpsampleSequence(in_size, out_shape)
    assert ("proj" in variables["params"]) == (tmod.proj is not None)
    steps = tmod.steps
    if steps:  # the last stage carries neither BatchNorm nor ReLU
        last = getattr(tmod, f"up{steps - 1}")
        assert not last.with_bn and not last.with_relu and not hasattr(last, "bn")
    _both_modes(jmod, tmod, variables, z)
    with torch.no_grad():
        out = tmod.eval()(torch.from_numpy(z))
    assert out.shape == (2,) + out_shape and out.dtype == torch.float32
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def test_down_up_roundtrip_shapes():
    down = tseq.DownsampleSequence((32, 32, 4), 2.0).init_weights(0).eval()
    with torch.no_grad():
        z = down(torch.from_numpy(_x((2, 32, 32, 4), 1)))
        assert z.shape == (2, down.out_size)
        y = tseq.UpsampleSequence(z.shape[1], (32, 32, 4)).init_weights(1).eval()(z)
    assert y.shape == (2, 32, 32, 4)


def test_ops_tiling_reexports_the_tiling_module():
    from simple_vae_rs_tpu_torch import tiling

    for name in ttiling.__all__:
        assert getattr(ttiling, name) is getattr(tiling, name)
