"""The port's W8A8 int8 convs, blocks and serving against the JAX package.

Inputs are made with numpy from a seed and go through the JAX function (the
Pallas kernel in interpret mode and ``int8_reference*``) and the port's plain
version, in float32 on the CPU. Both sides quantize with the same scale bits
and sum the same integers, exactly while K * 127**2 stays below 2**24 (every
case here), so what is left is the epilogue's rounding: rtol 1e-4, atol 1e-5,
the JAX package's own tolerance (``tests/test_int8.py``).

The whole int8 slice is looser: the float32 layers above the decoder differ
from JAX by about 1e-6, so a few activations that sit on a rounding boundary
quantize one step apart. Bound: 2e-3 absolute on outputs in [0, 1]; the test
also holds the share of elements beyond 1e-5 under 5%. Measured on this
configuration: at most 9.9e-5, with 1.3% of the elements beyond 1e-5 (the
5-draw decode with the pixel shuffle; 2.0e-5 and 0.4% with the C-major
regroup; the 3-image generation with the pixel shuffle agrees to 6e-8). The
weights-only
slice dequantizes to the same float32 weights on both sides and keeps the
float32 slice's tolerance (rtol 1e-4, atol 2e-5).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simple_vae_rs_tpu.config import CondSRVAEConfig as JConfig
from simple_vae_rs_tpu.models import CondSRVAE as JCondSRVAE
from simple_vae_rs_tpu.ops import conv_blocks as jblocks
from simple_vae_rs_tpu.ops import pallas_conv as pc
from simple_vae_rs_tpu.ops import pallas_int8 as p8
from simple_vae_rs_tpu.ops import quantize as jq
from simple_vae_rs_tpu.serve import SuperResolver as JSuperResolver

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.ops import conv_blocks as tblocks
from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.ops import fused_int8 as f8
from simple_vae_rs_tpu_torch.ops import quantize as tq
from simple_vae_rs_tpu_torch.serve import SuperResolver
from simple_vae_rs_tpu_torch.tasks import sample_chunked
from simple_vae_rs_tpu_torch.utils.jax_weights import load_jax_variables
from tests.test_torch_port_conv import _random_bn

RTOL, ATOL = 1e-4, 1e-5
SLICE_ATOL = 2e-3
PS = 16

# (name, x shape, O, relu): ragged H/W, C=3 (a ragged pack of four channels),
# O=5, more channels than one K step (C=40 -> 10 packs), relu on and off
CASES = [
    ("int8_conv3x3_bn_relu", (2, 8, 8, 4), 8, True),
    ("int8_conv3x3_bn_relu", (3, 5, 7, 3), 5, False),
    ("int8_conv3x3_bn_relu", (1, 4, 4, 40), 24, False),
    ("int8_conv4x4s2_bn_relu", (2, 10, 6, 4), 8, True),
    ("int8_conv4x4s2_bn_relu", (3, 8, 6, 3), 5, False),
    ("int8_convT4x4s2_bn_relu", (2, 5, 7, 4), 8, True),
    ("int8_convT4x4s2_bn_relu", (1, 6, 6, 3), 5, False),
]

_JAX = {
    "int8_conv3x3_bn_relu": (p8.int8_conv3x3_bn_relu, p8.int8_reference3, 3),
    "int8_conv4x4s2_bn_relu": (p8.int8_conv4x4s2_bn_relu, p8.int8_reference4, 4),
    "int8_convT4x4s2_bn_relu": (p8.int8_convT4x4s2_bn_relu, p8.int8_referenceT, 4),
}


def _data(shape, o, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    kern = (rng.standard_normal((k, k, shape[-1], o)) * 0.3).astype(np.float32)
    kq, ks = jq.quantize_rtn(jnp.asarray(kern))
    scale = (rng.random(o) + 0.5).astype(np.float32)
    shift = (rng.standard_normal(o) * 0.1).astype(np.float32)
    return x, np.asarray(kq), np.asarray(ks), scale, shift


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _pallas_tile(name, shape, o):
    """(per-image VMEM bytes, weight bytes, bt): the batch tile the Pallas
    kernel picks, i.e. the images that share one activation scale there."""
    b, h, w, c = shape
    k = _JAX[name][2]
    kw = {"int8_conv4x4s2_bn_relu": dict(ho=h // 2, wo=w // 2),
          "int8_convT4x4s2_bn_relu": dict(out_mult=4)}.get(name, {})
    per = p8._tile_bytes_int8(h, w, c, o, **kw)
    wbytes = p8._wbytes(k * k, c, o)
    return per, wbytes, p8._batch_tile(b, per, wbytes)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_int8_plain_matches_jax(case):
    name, shape, o, relu = case
    kernel, reference, k = _JAX[name]
    x, kq, ks, s, t = _data(shape, o, k, seed=sum(shape) + o)
    want_kernel = np.asarray(kernel(x, kq, ks, s, t, relu=relu, interpret=True))
    want_ref = np.asarray(reference(x, kq, ks, s, t, relu))
    got_plain = f8.PLAIN[name](*_t(x, kq, ks, s, t), relu).numpy()
    got_wrapper = f8.WRAPPERS[name](*_t(x, kq, ks, s, t), relu=relu).numpy()
    assert got_plain.shape == want_ref.shape == f8.output_shape(name, shape, o)
    np.testing.assert_allclose(got_plain, want_ref, rtol=RTOL, atol=ATOL)
    # the Pallas kernel takes one scale per batch tile: 3 images have no
    # divisor in its ladder, so each is a program of its own there
    bt = _pallas_tile(name, shape, o)[2]
    assert bt == (1 if shape[0] == 3 else shape[0])
    got_tiled = f8.PLAIN[name](*_t(x, kq, ks, s, t), relu, act_group=bt).numpy()
    np.testing.assert_allclose(got_tiled, want_kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_wrapper, got_plain)  # CPU tensor -> plain
    assert (got_plain.min() >= 0.0) if relu else (got_plain.min() < 0.0)


@pytest.mark.parametrize("name,shape,o", [
    ("int8_conv3x3_bn_relu", (4, 16, 16, 8), 8),
    ("int8_conv4x4s2_bn_relu", (4, 16, 16, 8), 8),
    ("int8_convT4x4s2_bn_relu", (4, 8, 8, 8), 8),
])
def test_act_group_reproduces_a_multi_program_launch(monkeypatch, name, shape, o):
    """A Pallas launch of several programs takes one activation scale per
    batch tile of ``bt`` images; ``act_group = bt`` is that grouping. The
    VMEM budget is lowered so that the tile holds 2 of the 4 images, and
    the images are scaled apart so that the grouping matters."""
    kernel, reference, k = _JAX[name]
    x, kq, ks, s, t = _data(shape, o, k, seed=31)
    x *= np.array([1.0, 0.2, 3.0, 0.5], np.float32).reshape(4, 1, 1, 1)
    per, wbytes, _ = _pallas_tile(name, shape, o)
    # the fit test reads pallas_int8's copy of the budget, the batch tile pallas_conv's
    monkeypatch.setattr(p8, "_VMEM_BUDGET", 2 * per + wbytes + 1)
    monkeypatch.setattr(pc, "_VMEM_BUDGET", 2 * per + wbytes + 1)
    assert _pallas_tile(name, shape, o)[2] == 2
    want = np.asarray(kernel(x, kq, ks, s, t, relu=True, interpret=True))
    got = f8.WRAPPERS[name](*_t(x, kq, ks, s, t), relu=True, act_group=2).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # and the default, one scale for the whole batch, is the reference
    whole = f8.WRAPPERS[name](*_t(x, kq, ks, s, t), relu=True).numpy()
    np.testing.assert_allclose(whole, np.asarray(reference(x, kq, ks, s, t, True)),
                               rtol=RTOL, atol=ATOL)
    assert np.abs(whole - got).max() > 1e-3  # the grouping is not a no-op


def test_act_absmax_groups():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 3, 4, 2)).astype(np.float32))
    per_image = x.abs().amax(dim=(1, 2, 3))
    assert torch.equal(f8.act_absmax(x), per_image.max().reshape(1))
    assert torch.equal(f8.act_absmax(x, 1), per_image)
    got = f8.act_absmax(x, 2)  # a ragged last group
    want = torch.stack([per_image[:2].max(), per_image[2:4].max(), per_image[4]])
    assert torch.equal(got, want)
    q, a = f8.quantize_act(torch.zeros(2, 2, 2, 4))
    assert float(a.max()) == pytest.approx(1e-12) and float(q.abs().max()) == 0.0
    with pytest.raises(ValueError):
        f8.act_absmax(x, 0)


def absmax_replay(x, act_group, itemsize=4):
    """``act_absmax``'s launch replayed in numpy: the grid of
    :func:`f8.absmax_plan` (group ``blockIdx.x``, block of the group
    ``blockIdx.y``), each group's scalar head and tail read by its block 0,
    its whole 16-byte words (4 float32 or, with ``itemsize`` 2, 8 bfloat16
    elements: ``x`` then holds bfloat16 values) by every block in trips of 4
    words a thread, and the blocks' maxima combined by atomicMax on the bit
    patterns. Returns the result and the number of reads of each element."""
    threads, unroll = 256, 4
    v = 16 // itemsize
    flat = np.abs(x.reshape(-1))
    numel, b = flat.size, x.shape[0]
    group = b if act_group is None else max(1, min(act_group, b))
    groups, per_group = -(-b // group), group * (numel // b)
    blocks = f8.absmax_plan(per_group, groups, itemsize)
    reads = np.zeros(numel, np.int64)
    amax = np.zeros(groups, np.uint32)
    tid = np.arange(threads)
    for gx in range(groups):
        s = gx * per_group
        e = min(numel, s + per_group)
        a = min((s + v - 1) & ~(v - 1), e)
        z = max(e & ~(v - 1), a)
        nv = (z - a) // v
        trip = blocks * threads * unroll
        for by in range(blocks):
            idx = [np.zeros(0, np.int64)]  # a block past the group's words reads nothing
            if by == 0:
                head = tid < a - s
                tail = ~head & (tid >= v) & (tid - v < e - z)
                idx += [s + tid[head], z + tid[tail] - v]
            for base in range(by * threads * unroll, max(nv, 1), trip):
                for u in range(unroll):
                    j = base + tid + u * threads
                    j = j[j < nv]
                    idx.append((a + v * j[:, None] + np.arange(v)).ravel())
            idx = np.concatenate(idx).astype(np.int64)
            assert ((idx >= s) & (idx < e)).all()  # a block reads its own group only
            np.add.at(reads, idx, 1)
            m = flat[idx].max() if idx.size else np.float32(0)
            amax[gx] = max(amax[gx], np.float32(m).view(np.uint32))
    return amax.view(np.float32), reads


# (x shape, act_group): odd H*W*C (105 floats an image), groups that start
# inside a 16-byte word (210 floats a group), groups shorter than a word
# (3 and 1 floats: head and tail only), a short last group, several blocks
# a group (40,704 floats: 4 blocks, the last one's share ragged; 32,768: 4
# blocks in each of 2 groups)
ABSMAX_CASES = [((5, 3, 5, 7), None), ((5, 3, 5, 7), 2), ((5, 3, 5, 7), 1), ((6, 1, 1, 3), 1),
                ((5, 1, 1, 1), 2), ((7, 2, 3, 2), 3), ((3, 16, 16, 53), None),
                ((3, 16, 16, 53), 1), ((4, 16, 16, 16), 3), ((4, 32, 32, 16), 2)]


@pytest.mark.parametrize("shape,act_group", ABSMAX_CASES, ids=str)
def test_act_absmax_kernel_index_arithmetic_matches_plain(shape, act_group):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x *= rng.uniform(0.25, 2.25, (shape[0], 1, 1, 1)).astype(np.float32)
    got, reads = absmax_replay(x, act_group)
    assert (reads == 1).all()  # every element once
    want = f8.act_absmax_plain(torch.from_numpy(x), act_group).numpy()
    np.testing.assert_array_equal(got, want)  # a max is exact in any order
    group = shape[0] if act_group is None else act_group
    jax_max = [np.asarray(jnp.max(jnp.abs(jnp.asarray(x[i:i + group]))))
               for i in range(0, shape[0], group)]
    np.testing.assert_array_equal(got, np.array(jax_max, np.float32))


@pytest.mark.parametrize("shape,act_group", ABSMAX_CASES, ids=str)
def test_bf16_act_absmax_kernel_index_arithmetic_matches_plain(shape, act_group):
    """The bfloat16 pass: words of eight elements, heads and tails of up to
    seven, each element read once; the float32 result equals the plain
    version's on the bfloat16 tensor and on its exact float32 upcast."""
    rng = np.random.default_rng(sum(shape) + 2)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= rng.uniform(0.25, 2.25, (shape[0], 1, 1, 1)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    x = xb.float().numpy()
    got, reads = absmax_replay(x, act_group, itemsize=2)
    assert (reads == 1).all()  # every element once
    want = f8.act_absmax_plain(xb, act_group)
    assert want.dtype == torch.float32
    np.testing.assert_array_equal(got, want.numpy())
    assert torch.equal(want, f8.act_absmax_plain(torch.from_numpy(x), act_group))
    assert torch.equal(f8.act_absmax(xb, act_group), want)  # CPU wrapper: the plain version


def test_absmax_plan_fills_the_card_with_tens_of_kb_a_block():
    sms = fc._SMS
    assert f8.absmax_plan(40704, 1) == f8.absmax_plan(32768, 2) == 4
    for per_group, groups in [(1000 * 16 * 16 * 256, 1), (16 * 8 * 8 * 424, 1),
                              (16 * 16 * 256, 1000), (105, 5), (40704, 1)]:
        blocks = f8.absmax_plan(per_group, groups)
        assert blocks >= 1 and blocks * groups < 8 * sms + groups  # one wave, rounded up
        assert blocks == 1 or per_group / blocks >= 8192  # >= 32 KB a block
        if per_group >= 8 * sms * 8192 / groups:
            assert blocks * groups >= 8 * sms - groups  # every SM full


def test_pack_kernel_q_layout():
    """Word (tap, j, o) holds channels 4j..4j+3 of output channel o, channel
    4j+i in byte i, zeros past C, up to round_up(C, 16)."""
    kq = torch.from_numpy(
        np.random.default_rng(2).integers(-127, 128, (3, 3, 6, 5)).astype(np.int8))
    words = f8.pack_kernel_q(kq)
    assert words.dtype == torch.int32 and tuple(words.shape) == (9 * 4, 5)
    raw = words.numpy().view(np.int8).reshape(9, 4, 5, 4)
    for tap in (0, 4, 8):
        for o in (0, 3):
            got = raw[tap, :, o, :].reshape(-1)
            np.testing.assert_array_equal(got[:6], kq.numpy()[tap // 3, tap % 3, :, o])
            assert not got[6:].any()


def _implicit_gemm_int8(name, x, kq, ks, scale, shift, relu, act_group):
    """The CUDA kernel's index arithmetic replayed in numpy on the packed
    operands: tap geometry, words of four channels with the ragged last word
    and the words of the 16-channel padding, the packed weight rows, the K
    splits of ``plan_int8_tc``, output phases and the per-group activation
    scale, so a wrong tap, row or offset shows on the CPU.
    (``tests/test_torch_port_int8_tc.py`` replays the kernel block by block,
    down to its MMA fragments.)"""
    _, taps, stride, phases = fc._KERNELS[f8.float_name(name)]
    b, h, w, c = x.shape
    o = kq.shape[-1]
    c4 = f8.padded_channels(c) // 4
    m, n, k4, _ = f8.geometry(name, x.shape, o)
    assert k4 == taps * c4
    ho, wo = (h // 2, w // 2) if stride == 2 else (h, w)
    _, splits, kchunk = f8.plan_int8_tc(m, n, k4, phases)
    # (kh*kw*c4, O) int32
    wwords = f8.pack_kernel_q(torch.from_numpy(np.array(kq))).numpy()
    wbytes = wwords.view(np.int8).reshape(wwords.shape[0], o, 4).astype(np.int64)
    group = b if act_group is None else act_group
    amax = f8.act_absmax_plain(torch.from_numpy(x), group).numpy()
    a_scale = np.maximum(amax / np.float32(127.0), np.float32(1e-12)).astype(np.float32)
    out = np.zeros(f8.output_shape(name, x.shape, o), np.float32)
    for p in range(phases):
        a = np.zeros((m, k4, 4), np.int64)
        rows = np.zeros(k4, np.int64)
        for kk in range(k4):
            t, j = divmod(kk, c4)
            if name == "int8_conv3x3_bn_relu":
                dy, dx, wtap = t // 3 - 1, t % 3 - 1, t
            elif name == "int8_conv4x4s2_bn_relu":
                dy, dx, wtap = t // 4 - 1, t % 4 - 1, t
            else:
                ta, tb, u, v = t >> 1, t & 1, p >> 1, p & 1
                dy, dx, wtap = ta + u - 1, tb + v - 1, (2 * ta + u) * 4 + 2 * tb + v
            rows[kk] = wtap * c4 + j
            for mm in range(m):
                bb, r = divmod(mm, ho * wo)
                oy, ox = divmod(r, wo)
                iy, ix = oy * stride + dy, ox * stride + dx
                live = min(4, c - 4 * j)  # <= 0 in a word of the padding
                if 0 <= iy < h and 0 <= ix < w and live > 0:
                    vals = x[bb, iy, ix, 4 * j:4 * j + live] / a_scale[bb // group]
                    a[mm, kk, :live] = np.clip(np.rint(vals), -127, 127)
        acc = np.zeros((m, o), np.int64)
        for lo in range(0, splits * kchunk, kchunk):
            hi = min(k4, lo + kchunk)
            acc += np.einsum("mki,koi->mo", a[:, lo:hi], wbytes[rows[lo:hi]])
        assert np.abs(acc).max() < 2**31
        for mm in range(m):
            bb, r = divmod(mm, ho * wo)
            oy, ox = divmod(r, wo)
            mult = (a_scale[bb // group] * ks) * scale
            y = acc[mm].astype(np.float32) * mult + shift
            y = np.maximum(y, 0.0) if relu else y
            if phases == 1:
                out[bb, oy, ox] = y
            else:
                out[bb, 2 * oy + (p >> 1), 2 * ox + (p & 1)] = y
    return out


@pytest.mark.parametrize("act_group", [None, 2])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_int8_kernel_index_arithmetic_matches_plain(case, act_group):
    name, shape, o, relu = case
    x, kq, ks, s, t = _data(shape, o, _JAX[name][2], seed=9)
    got = _implicit_gemm_int8(name, x, kq, ks, s, t, relu, act_group)
    want = f8.PLAIN[name](*_t(x, kq, ks, s, t), relu, act_group).numpy()
    # the same integers and the same float32 epilogue: equal to the last bit
    np.testing.assert_array_equal(got, want)


def test_plain_version_accumulates_exactly():
    """At K = 9 * 424 the sums pass 2**24: the plain version must still be
    the exact integer sum (the kernels accumulate in int32)."""
    rng = np.random.default_rng(3)
    x = np.full((1, 3, 3, 424), 1.0, np.float32)
    x[0, 1, 1, 0] = 1.0 + 2.0 ** -20
    kq = np.full((3, 3, 424, 2), 127, np.int8)
    kq[..., 1] = rng.integers(-127, 128, (3, 3, 424))
    ones, zeros = np.ones(2, np.float32), np.zeros(2, np.float32)
    a_scale = np.float32(x.max()) / np.float32(127.0)
    got = f8.int8_conv3x3_plain(*_t(x, kq, ones, ones, zeros), relu=False).numpy()
    want = (9 * 424 * 127 * 127, int(127 * kq[..., 1].astype(np.int64).sum()))
    assert want[0] > 2**24
    for ch in (0, 1):
        assert got[0, 1, 1, ch] == np.float32(want[ch]) * np.float32(a_scale)


def test_wrappers_reject_bad_inputs():
    x, kq, ks, s, t = _t(*_data((1, 4, 4, 3), 2, 3, seed=0))
    with pytest.raises(TypeError, match="int8"):
        f8.int8_conv3x3_bn_relu(x, kq.float(), ks, s, t)
    with pytest.raises(ValueError):
        f8.int8_conv3x3_bn_relu(x, kq, ks[:1], s, t)
    with pytest.raises(ValueError):
        f8.int8_conv4x4s2_bn_relu(x, kq, ks, s, t)  # a 3x3 kernel
    with pytest.raises(ValueError):
        f8.int8_conv3x3_bn_relu(*(a.to("meta") for a in (x, kq, ks, s, t)))
    with pytest.raises(ValueError):
        f8.int8_conv3x3_bn_relu(x, kq, ks, s, t, act_group=0)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_bf16_int8_plain_matches_jax(case):
    """The plain versions on bfloat16 x against JAX ``int8_reference*`` and
    the Pallas kernels (interpret mode) on the same bfloat16 x: both upcast
    x to float32 (exact), quantize with the same scale bits, sum the same
    integers exactly and round the float32 epilogue once to bfloat16, so
    where the two float32 epilogues differ in the last bit (the float32
    test's rtol) the outputs are one bfloat16 ulp apart at most. The output
    is bfloat16 on both sides, and the port's equals its float32 plain
    version on the upcast x, rounded."""
    name, shape, o, relu = case
    kernel, reference, k = _JAX[name]
    x, kq, ks, s, t = _data(shape, o, k, seed=sum(shape) + o + 1)
    xb = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    got = f8.PLAIN[name](xb, *_t(kq, ks, s, t), relu)
    assert got.dtype == torch.bfloat16 and got.shape == f8.output_shape(name, shape, o)
    assert torch.equal(got, f8.PLAIN[name](xb.float(), *_t(kq, ks, s, t), relu).bfloat16())
    assert torch.equal(f8.WRAPPERS[name](xb, *_t(kq, ks, s, t), relu=relu), got)
    bt = _pallas_tile(name, shape, o)[2]
    tiled = f8.PLAIN[name](xb, *_t(kq, ks, s, t), relu, act_group=bt)
    for port, want in ((got, reference(xj, kq, ks, s, t, relu)),
                       (tiled, kernel(xj, kq, ks, s, t, relu=relu, interpret=True))):
        assert want.dtype == jnp.bfloat16
        w = torch.from_numpy(np.array(want.astype(jnp.float32)))
        err = (port.float() - w).abs()
        assert bool((err <= fc.bf16_ulp(torch.maximum(port.float().abs(), w.abs()))).all()), \
            float(err.max())


# -------------------------------------------------------------- block path
@pytest.mark.parametrize("block,cin,cout,hw", [
    ("DownBlock", 8, 12, 8),     # kernel #11: only a block given a quant tree reaches it
    ("DownBlock", 3, 5, 6),
    ("UpBlock", 256, 8, 4),      # at or above the 192-channel floor: int8 tail
    ("UpBlock", 192, 6, 3),
])
def test_int8_blocks_eval_match_jax(block, cin, cout, hw):
    jmod = getattr(jblocks, block)(cin, cout)
    x = np.random.default_rng(cin + cout).standard_normal((2, hw, hw, cin)).astype(np.float32)
    variables = _random_bn(
        jmod.init(jax.random.PRNGKey(cin), jnp.zeros_like(x), train=False), seed=cout)
    quant = jax.device_get(jq.quantize_params_tree(
        variables["params"], jax.random.PRNGKey(2), prefixes=("",)))
    variables["quant"] = quant
    want = np.asarray(jmod.apply(variables, x, train=False))
    tmod = getattr(tblocks, block)(cin, cout).eval()
    load_jax_variables(tmod, variables)
    tail = getattr(tmod, tmod._tail_name)
    assert tmod.conv.kernel_q is not None and tail.kernel_q is not None
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
        tblocks.use_plain_path(tmod)
        np.testing.assert_array_equal(tmod(torch.from_numpy(x)).numpy(), got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # without the quant collection the same module is the float block again
    f32 = {k: v for k, v in variables.items() if k != "quant"}
    load_jax_variables(tmod, f32)
    assert tmod.conv.kernel_q is None and tail.kernel_q is None
    with torch.no_grad():
        off = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(off, np.asarray(jmod.apply(f32, x, train=False)),
                               rtol=RTOL, atol=ATOL)
    assert np.abs(off - got).max() > 0


def test_int8_convT_channel_floor_routing():
    """JAX ``test_int8_convT_channel_floor_routing`` on the port: below 192
    input channels an UpBlock's tail runs in float32 on the float weights
    even with int8 weights attached (bit-identical to the float block); from
    192 up it runs the int8 kernel."""
    assert tblocks.INT8_CONVT_MIN_CHANNELS == 192

    def outputs(c_in):
        rng = np.random.default_rng(11)
        x = rng.standard_normal((2, 4, 4, c_in)).astype(np.float32)
        jmod = jblocks.UpBlock(in_features=c_in, features=8)
        vs = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
        quant = jax.device_get(jq.quantize_params_tree(
            vs["params"], jax.random.PRNGKey(1), prefixes=("upsample",)))
        tmod = tblocks.UpBlock(c_in, 8).eval()
        load_jax_variables(tmod, {**vs, "quant": quant})
        assert tmod.upsample.kernel_q is not None and tmod.conv.kernel_q is None
        want = np.asarray(jmod.apply({**vs, "quant": quant}, x, train=False))
        before = dict(f8.launches)
        with torch.no_grad():
            with_int8 = tmod(torch.from_numpy(x)).numpy()
            tq.attach_quant(tmod, {})
            without = tmod(torch.from_numpy(x)).numpy()
        assert f8.launches == before  # CPU tensors launch nothing
        # a float32 conv feeds the int8 tail here, so where it differs from
        # JAX's in the last bits an activation on a rounding boundary
        # quantizes one step apart: the slice's bound, not the kernel's
        diff = np.abs(with_int8 - want)
        assert diff.max() <= SLICE_ATOL and np.mean(diff > ATOL) < 0.1
        return with_int8, without

    a, b = outputs(128)
    np.testing.assert_array_equal(a, b)
    a, b = outputs(256)
    assert np.abs(a - b).max() > 0


def test_int8_never_routes_in_training_mode():
    tmod = tblocks.Conv3x3(4, 4)
    tmod.reset_parameters(np.random.default_rng(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 4, 4, 4)).astype(np.float32))
    want = tmod.train()(x)
    tmod.set_quant(*tq.quantize_rtn(tmod.kernel))
    assert torch.equal(tmod.train()(x), want)
    with torch.no_grad():
        assert not torch.equal(tmod.eval()(x), want)
    with pytest.raises(ValueError, match="do not match"):
        tmod.set_quant(torch.zeros(3, 3, 4, 5, dtype=torch.int8), torch.ones(5))


# ---------------------------------------------------------------- the slice
@pytest.fixture(scope="module", params=[False, True], ids=["pixel_shuffle", "torch_regroup"])
def pair(request):
    """(jax model, flax variables with non-trivial BatchNorm, port config)."""
    jmodel = JCondSRVAE(JConfig(cr=2.0, patch_size=PS, torch_regroup=request.param))
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, PS, PS, 4)),
        jnp.zeros((1, PS // 2, PS // 2, 4)), jax.random.PRNGKey(1), train=False)
    variables = _random_bn(variables, seed=3)
    return jmodel, variables, CondSRVAEConfig(cr=2.0, patch_size=PS,
                                              torch_regroup=request.param)


def _noise(cfg, batch, samples, seed):
    rng = np.random.default_rng(seed)
    g = PS // 8
    y = rng.random((batch, PS // 2, PS // 2, 4)).astype(np.float32)
    eps_u = rng.standard_normal((batch, g, g, cfg.u_channels)).astype(np.float32)
    eps_z = rng.standard_normal((batch, g, g, cfg.z_channels)).astype(np.float32)
    eps_draws = rng.standard_normal((samples, g, g, cfg.z_channels)).astype(np.float32)
    return y, eps_u, eps_z, eps_draws


def _jax_draws(samples):
    def draws(m, y, eps_u, eps_z):
        mu_u, lv_u = m.encode_y(y, train=False)
        y_feat = m.y_embedding(y, train=False)
        mu_p, lv_p = m.z_cond(y_feat, mu_u + eps_u * jnp.exp(0.5 * lv_u), train=False)
        z = mu_p + eps_z * jnp.exp(0.5 * lv_p)
        yf = jnp.broadcast_to(y_feat, (samples,) + y_feat.shape[1:])
        return m.decode_x_from_features(z, yf, train=False)
    return draws


def test_int8_resolver_matches_jax_on_the_same_int8_weights(pair):
    """``SuperResolver(int8=True)``: the JAX resolver quantizes, the port
    loads its ``quant`` collection (an already-quantized model is served as
    it is), and both run the same requests on injected noise."""
    jmodel, variables, cfg = pair
    jsr = JSuperResolver(jmodel, variables, seed=7, int8=True)
    qvars = jax.device_get(jsr.variables)
    assert set(qvars["quant"]) == {f"d{a}_{b}" for a in "xy" for b in
                                   ("up1", "up2", "conv1", "conv2", "conv3", "conv4")} | {"dx_up3"}
    tmodel = CondSRVAE(cfg)
    load_jax_variables(tmodel, qvars)
    sr = SuperResolver(tmodel, device="cpu", seed=7, int8=True)
    assert sr.model is tmodel  # already quantized: left alone, not quantized again
    np.testing.assert_array_equal(sr.model.dx_conv1.kernel_q.numpy(),
                                  qvars["quant"]["dx_conv1"]["kernel_q"])
    samples = 5
    y, eps_u, eps_z, eps_draws = _noise(cfg, 3, samples, seed=4)
    want = np.asarray(jmodel.apply(jsr.variables, y, eps_u, eps_z,
                                   method=JCondSRVAE.conditional_generation_eps))
    with torch.no_grad():
        got = sr.model.conditional_generation_eps(*_t(y, eps_u, eps_z)).numpy()
    want_draws = np.asarray(jmodel.apply(jsr.variables, y[:1], eps_u[:1], eps_draws,
                                         method=_jax_draws(samples)))
    # one chunk: a decode chunk's activation scale is its own, as in JAX
    got_draws = sample_chunked(sr.model, torch.from_numpy(y[:1]), samples=samples,
                               chunk=samples, eps_u=torch.from_numpy(eps_u[:1]),
                               eps_z=torch.from_numpy(eps_draws)).numpy()
    for g, w in ((got, want), (got_draws, want_draws)):
        assert g.shape == w.shape
        diff = np.abs(g - w)
        assert diff.max() <= SLICE_ATOL, diff.max()
        assert np.mean(diff > 1e-5) < 0.05, np.mean(diff > 1e-5)
    # the int8 path really ran: the float model on the same inputs differs
    f32 = CondSRVAE(cfg)
    load_jax_variables(f32, {k: v for k, v in qvars.items() if k != "quant"})
    with torch.no_grad():
        off = f32.eval().conditional_generation_eps(*_t(y, eps_u, eps_z)).numpy()
    assert np.abs(off - got).max() > 1e-6


def test_int8_weights_resolver_matches_jax(pair):
    """``SuperResolver(int8_weights=True)``: both packages dequantize the
    same bytes and run the float32 graph."""
    jmodel, variables, cfg = pair
    jsr = JSuperResolver(jmodel, variables, seed=7, int8_weights=True)
    tmodel = CondSRVAE(cfg)
    load_jax_variables(tmodel, variables)
    sr = SuperResolver(tmodel, device="cpu", seed=7, int8_weights=True)
    assert sr.model is not tmodel and tmodel.dx_conv1.kernel.numel() > 0
    samples = 4
    y, eps_u, eps_z, eps_draws = _noise(cfg, 2, samples, seed=5)
    jvars = jq.unpack_weights(jsr._payload, jsr._pack_spec)
    want = np.asarray(jmodel.apply(jvars, y, eps_u, eps_z,
                                   method=JCondSRVAE.conditional_generation_eps))
    with torch.no_grad(), tq.unpack_weights(sr.model, sr._packed):
        got = sr.model.conditional_generation_eps(*_t(y, eps_u, eps_z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    want_draws = np.asarray(jmodel.apply(jvars, y[:1], eps_u[:1], eps_draws,
                                         method=_jax_draws(samples)))
    got_draws = sample_chunked(sr.model, torch.from_numpy(y[:1]), samples=samples, chunk=3,
                               eps_u=torch.from_numpy(eps_u[:1]),
                               eps_z=torch.from_numpy(eps_draws), packed=sr._packed).numpy()
    np.testing.assert_allclose(got_draws, want_draws, rtol=1e-4, atol=2e-5)
    # between requests no packed leaf is held in float32
    params = dict(sr.model.named_parameters())
    assert len(sr._packed) > 20 and all(params[n].numel() == 0 for n in sr._packed)
    assert all(q.dtype == torch.int8 for q, _ in sr._packed.values())


def _psnr(a, b):
    return float(10 * torch.log10(1.0 / torch.clamp_min(((a - b) ** 2).mean(), 1e-12)))


def test_int8_and_f32_resolvers_coexist_both_orders():
    """JAX ``test_int8_and_f32_resolvers_coexist_both_orders`` on the port:
    routing follows the int8 weights on the resolver's own model copy, so a
    float32 resolver of the same model is untouched by an int8 one built
    before or after it."""
    cfg = CondSRVAEConfig(cr=2.0, patch_size=PS)
    y = np.random.default_rng(3).random((2, PS // 2, PS // 2, 4)).astype(np.float32)
    model_a = CondSRVAE(cfg).init_weights(0)
    f32_a = SuperResolver(model_a, device="cpu", seed=7)
    before = f32_a.super_resolve(y, seed=3)
    q_a = SuperResolver(model_a, device="cpu", seed=7, int8=True)
    out_q_a = q_a.super_resolve(y, seed=3)
    assert torch.equal(f32_a.super_resolve(y, seed=3), before)
    assert not tq.has_quant(model_a) and tq.has_quant(q_a.model)

    model_b = CondSRVAE(cfg).init_weights(0)
    q_b = SuperResolver(model_b, device="cpu", seed=7, int8=True)
    out_q_b = q_b.super_resolve(y, seed=3)
    w_b = SuperResolver(model_b, device="cpu", seed=7, int8_weights=True)
    out_w_b = w_b.super_resolve(y, seed=3)
    f32_b = SuperResolver(model_b, device="cpu", seed=7)
    out_f32_b = f32_b.super_resolve(y, seed=3)

    assert torch.equal(out_q_a, out_q_b) and torch.equal(before, out_f32_b)
    assert not torch.allclose(out_q_a, before, atol=1e-6)
    assert not torch.equal(out_w_b, before)
    assert _psnr(out_q_a, before) > 30.0 and _psnr(out_w_b, before) > 30.0
    # another seed quantizes to other bytes
    q_c = SuperResolver(model_a, device="cpu", seed=8, int8=True)
    assert not torch.equal(q_c.model.dx_up1.conv.kernel_q, q_a.model.dx_up1.conv.kernel_q)
    # every endpoint answers in both modes
    for sr in (q_a, w_b):
        maps = sr.uncertainty(y[0], samples=4, chunk=2, seed=1)
        assert maps["mean"].shape == (PS, PS, 4) and torch.isfinite(maps["std"]).all()
        s1, s2 = sr.super_resolve_moments(y, 2, normalize=True, seed=1)
        assert s1.shape == (2, PS, PS, 4) and bool((s2 >= 0).all())
    with pytest.raises(ValueError, match="pick one"):
        SuperResolver(model_a, device="cpu", int8=True, int8_weights=True)


def test_load_jax_variables_checks_the_quant_collection(pair):
    jmodel, variables, cfg = pair
    quant = jax.device_get(jq.quantize_params_tree(variables["params"], jax.random.PRNGKey(0)))
    fresh = CondSRVAE(cfg)
    with pytest.raises(KeyError, match="no conv"):
        load_jax_variables(fresh, {**variables, "quant": {"dx_other": quant["dx_conv1"]}})
    with pytest.raises(ValueError, match="do not match"):
        load_jax_variables(fresh, {**variables, "quant": {"dx_conv1": quant["dx_conv2"]}})
    with pytest.raises(KeyError, match="cache"):
        load_jax_variables(fresh, {**variables, "cache": {}})
    load_jax_variables(fresh, {**variables, "quant": quant})
    assert tq.has_quant(fresh)
    load_jax_variables(fresh, variables)  # a float tree clears the int8 weights
    assert not tq.has_quant(fresh)
