"""The port's int8 weight quantizers against the JAX package's.

Inputs are made with numpy from a seed. ``channel_scales``, ``quantize_rtn``,
``dequantize`` and the weights-only pack are deterministic and must agree bit
for bit with the JAX functions (one IEEE division and one round-half-even per
element on both sides). The stochastic quantizer draws from another stream
than ``jax.random``, so against ``quantize_stochastic_ref`` its contract is
distributional: every value within one grid step of ``w / scale``, and a mean
over seeds that is unbiased where round-to-nearest is not. The CUDA kernel
computes the integer hash that ``hash_uniform`` computes; a pure-Python replay
pins that algorithm here, a numpy replay of the two passes of
``csrc/quantize.cu`` (one C call per quant tree) holds their index arithmetic
against the plain version leaf by leaf, and ``tests/test_torch_port_gpu.py``
holds the kernels' bytes against the plain version's on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simple_vae_rs_tpu import export as jexport
from simple_vae_rs_tpu.config import CondSRVAEConfig as JConfig
from simple_vae_rs_tpu.models import CondSRVAE as JCondSRVAE
from simple_vae_rs_tpu.ops import quantize as jq

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.ops import quantize as tq
from simple_vae_rs_tpu_torch.utils.jax_weights import load_jax_variables

PS = 16


def _w(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _zero_channel(shape, seed):
    w = _w(shape, seed)
    w[..., 1] = 0.0
    return w


WEIGHTS = [_w((3, 3, 4, 8), 0), _w((4, 4, 5, 7), 1, 2.0), _zero_channel((3, 3, 6, 3), 2),
           _w((40, 24), 3, 1e-3)]


@pytest.mark.parametrize("w", WEIGHTS, ids=lambda w: "x".join(map(str, w.shape)))
def test_scales_rtn_and_dequantize_are_bit_equal_to_jax(w):
    tw = torch.from_numpy(w)
    want_s = np.asarray(jq.channel_scales(jnp.asarray(w)))
    np.testing.assert_array_equal(tq.channel_scales(tw).numpy(), want_s)
    want_q, _ = jq.quantize_rtn(jnp.asarray(w))
    got_q, got_s = tq.quantize_rtn(tw)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    # the host-side formulation the JAX export and the weights-only mode use
    q_np, s_np = jexport._rtn_numpy(w)
    np.testing.assert_array_equal(got_q.numpy(), q_np)
    np.testing.assert_array_equal(got_s.numpy(), s_np)
    np.testing.assert_array_equal(tq.dequantize(got_q, got_s).numpy(),
                                  np.asarray(jq.dequantize(want_q, jnp.asarray(want_s))))


def test_zero_channel_gets_scale_one():
    s = tq.channel_scales(torch.from_numpy(_zero_channel((3, 3, 6, 3), 2)))
    assert float(s[1]) == 1.0 and float(s[0]) > 0


def _mix32(x):
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


@pytest.mark.parametrize("seed", [0, 7, (3 << 32) | 0xDEADBEEF])
def test_hash_uniform_is_the_documented_hash(seed):
    """Element i draws mantissa(mix32(mix32(i ^ k0) + k1)): replayed with
    Python integers, which is also what the CUDA kernel computes."""
    k0 = _mix32((seed & 0xFFFFFFFF) + 0x9E3779B9)
    k1 = _mix32((seed >> 32) ^ k0 ^ 0x85EBCA6B)
    assert tq.seed_words(seed) == (k0, k1)
    got = tq.hash_uniform(1000, seed).numpy()
    for i in (0, 1, 2, 31, 255, 999):
        bits = _mix32((_mix32(i ^ k0) + k1) & 0xFFFFFFFF)
        want = np.array([(bits >> 9) | 0x3F800000], np.uint32).view(np.float32)[0] - 1.0
        assert got[i] == want
    assert got.min() >= 0.0 and got.max() < 1.0


def test_hash_uniform_is_uniform_and_seeds_differ():
    u = tq.hash_uniform(200_000, 5).numpy().astype(np.float64)
    se = 1 / np.sqrt(12 * u.size)
    assert abs(u.mean() - 0.5) < 4 * se
    assert abs(np.mean(u < 0.25) - 0.25) < 4 * np.sqrt(0.25 * 0.75 / u.size)
    # neighbouring elements and neighbouring seeds are uncorrelated
    assert abs(np.corrcoef(u[:-1], u[1:])[0, 1]) < 4 / np.sqrt(u.size)
    v = tq.hash_uniform(200_000, 6).numpy().astype(np.float64)
    assert abs(np.corrcoef(u, v)[0, 1]) < 4 / np.sqrt(u.size)
    assert abs(np.corrcoef(u[1:], v[:-1])[0, 1]) < 4 / np.sqrt(u.size)
    with pytest.raises(ValueError):
        tq.hash_uniform(2**32, 0, device="meta")


def test_quantize_stochastic_matches_ref_distribution():
    """Against ``quantize_stochastic_ref``: the same scales, every value one
    of the two grid points around w / scale on both sides, and the same
    share of values rounded up (the two streams differ)."""
    w = _w((3, 3, 16, 32), 4)
    q, s = tq.quantize_stochastic(torch.from_numpy(w), seed=0)
    jq_q, jq_s = jq.quantize_stochastic_ref(jnp.asarray(w), jax.random.PRNGKey(0))
    assert q.dtype == torch.int8 and q.shape == w.shape
    np.testing.assert_array_equal(s.numpy(), np.asarray(jq_s))
    x = w / s.numpy()
    for got in (q.numpy().astype(np.float32), np.asarray(jq_q).astype(np.float32)):
        assert np.abs(got - x).max() < 1.0
        assert np.all((got == np.floor(x)) | (got == np.floor(x) + 1))
        assert np.abs(got).max() <= 127
    up = np.mean(q.numpy() > np.floor(x))
    up_ref = np.mean(np.asarray(jq_q) > np.floor(x))
    assert abs(up - up_ref) < 4 * np.sqrt(0.5 / x.size)
    # mean error within 4 standard errors of 0 (a Bernoulli carry's variance
    # is frac * (1 - frac) <= 1/4)
    err = q.numpy().astype(np.float64) - x
    assert abs(err.mean()) < 4 * 0.5 / np.sqrt(x.size)
    # the same bytes for the same (weights, seed), other bytes for another seed
    q2, _ = tq.quantize_stochastic(torch.from_numpy(w), seed=0)
    q3, _ = tq.quantize_stochastic(torch.from_numpy(w), seed=1)
    assert torch.equal(q, q2) and not torch.equal(q, q3)


# csrc/quantize.cu's launch geometry
THREADS, AMAX_COLS, AMAX_ROWS, QUANT_PER_BLOCK = 256, 32, 256, 8 * 256
AMAX_LANES = THREADS // AMAX_COLS
M32 = np.uint64(0xFFFFFFFF)


def _mix32_np(x):
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x7FEB352D)) & M32
    x = x ^ (x >> np.uint64(15))
    x = (x * np.uint64(0x846CA68B)) & M32
    return x ^ (x >> np.uint64(16))


def _leaf_of(block0, b):
    """``leaf_of``: the last leaf whose first block is <= b."""
    l = np.zeros(b.shape, np.int64)
    for j in range(1, block0.size):
        l = np.where(block0[j] <= b, j, l)
    return l


def quantize_tree_replay(leaves):
    """``svrs_quantize_tree`` as ``quantize_leaves`` calls it, in numpy: the
    empty leaves to the plain version, the others in tables of
    ``TABLE_LEAVES``, each one ``col_absmax`` launch (a block: 32 columns x
    ``AMAX_ROWS`` rows of one leaf, its column maxima folded into the zeroed
    scratch by an integer max of the bits of |w|) and one
    ``stochastic_round`` launch (a block: ``QUANT_PER_BLOCK`` consecutive
    elements of one leaf, the scale inline from the scratch, row 0 writing
    it), every block finding its leaf by the table's first-block offsets.
    Returns ``[(q, scale)]`` and the number of launches; asserts that pass
    1 reads every element once and pass 2 writes every byte and scale once."""
    out = [None] * len(leaves)
    live = []
    for i, (w, seed) in enumerate(leaves):
        if w.size == 0:
            q, sc = tq.quantize_stochastic_plain(torch.from_numpy(w), seed)
            out[i] = (q.numpy(), sc.numpy())
        else:
            live.append(i)
    launches = 0
    for first in range(0, len(live), tq.TABLE_LEAVES):
        chunk = live[first:first + tq.TABLE_LEAVES]
        w_flat = np.concatenate([leaves[i][0].reshape(-1) for i in chunk])
        numel = np.array([leaves[i][0].size for i in chunk], np.int64)
        o = np.array([leaves[i][0].shape[-1] for i in chunk], np.int64)
        m = numel // o
        base = np.concatenate([[0], np.cumsum(numel)[:-1]])  # w, q
        soff = np.concatenate([[0], np.cumsum(o)[:-1]])      # scale, amax
        keys = np.array([tq.seed_words(leaves[i][1]) for i in chunk], np.uint64)
        a_blocks = -(-m // AMAX_ROWS) * -(-o // AMAX_COLS)
        q_blocks = -(-numel // QUANT_PER_BLOCK)
        a0 = np.concatenate([[0], np.cumsum(a_blocks)[:-1]])
        q0 = np.concatenate([[0], np.cumsum(q_blocks)[:-1]])
        amax = np.zeros(o.sum(), np.uint32)  # the memset
        t = np.arange(THREADS)

        # col_absmax
        b = np.arange(a_blocks.sum())
        l = _leaf_of(a0, b)[:, None]
        tiles = -(-o[l] // AMAX_COLS)
        bb = b[:, None] - a0[l]
        split, tile = bb // tiles, bb % tiles
        lane, row = t % AMAX_COLS, t // AMAX_COLS
        col = tile * AMAX_COLS + lane
        r1 = np.minimum(m[l], (split + 1) * AMAX_ROWS)
        mx = np.zeros((b.size, THREADS), np.uint32)
        reads = np.zeros(w_flat.size, np.int64)
        for it in range(AMAX_ROWS // AMAX_LANES):
            r = split * AMAX_ROWS + row + it * AMAX_LANES
            ok = (col < o[l]) & (r < r1)
            addr = np.where(ok, base[l] + r * o[l] + col, 0)
            np.add.at(reads, addr[ok], 1)
            bits = np.abs(w_flat[addr]).view(np.uint32)
            mx = np.where(ok, np.maximum(mx, bits), mx)
        col_max = mx.reshape(b.size, AMAX_LANES, AMAX_COLS).max(axis=1)  # the shared reduce
        col0 = col[:, :AMAX_COLS]
        ok0 = col0 < o[l]
        np.maximum.at(amax, (soff[l] + col0)[ok0], col_max[ok0])
        assert (reads == 1).all()

        # stochastic_round
        b = np.arange(q_blocks.sum())
        l = _leaf_of(q0, b)[:, None]
        q_flat = np.zeros(w_flat.size, np.int8)
        s_flat = np.zeros(o.sum(), np.float32)
        q_writes = np.zeros(w_flat.size, np.int64)
        s_writes = np.zeros(o.sum(), np.int64)
        for k in range(QUANT_PER_BLOCK // THREADS):
            i = (b[:, None] - q0[l]) * QUANT_PER_BLOCK + t + k * THREADS
            ok = i < numel[l]
            i = np.where(ok, i, 0)
            c = i % o[l]
            a = amax[soff[l] + c].view(np.float32)
            with np.errstate(invalid="ignore", divide="ignore"):
                scale = np.where(a > 0, a / np.float32(127.0), np.float32(1.0)).astype(np.float32)
                first_row = ok & (i < o[l])
                np.add.at(s_writes, (soff[l] + i)[first_row], 1)
                s_flat[(soff[l] + i)[first_row]] = scale[first_row]
                bits = _mix32_np((_mix32_np(i.astype(np.uint64) ^ keys[l[:, 0], 0][:, None])
                                  + keys[l[:, 0], 1][:, None]) & M32)
                u = ((bits >> np.uint64(9)) | np.uint64(0x3F800000)).astype(np.uint32) \
                    .view(np.float32) - np.float32(1.0)
                x = (w_flat[base[l] + i] / scale).astype(np.float32)
                lo = np.floor(x)
                v = lo + (u < (x - lo)).astype(np.float32)
                v = np.where(v < -127, np.float32(-127), np.where(v > 127, np.float32(127), v))
                qv = np.where(np.isnan(v), 0, v).astype(np.int8)
            np.add.at(q_writes, (base[l] + i)[ok], 1)
            q_flat[(base[l] + i)[ok]] = qv[ok]
        assert (q_writes == 1).all() and (s_writes == 1).all()
        for j, i in enumerate(chunk):
            out[i] = (q_flat[base[j]:base[j] + numel[j]].reshape(leaves[i][0].shape),
                      s_flat[soff[j]:soff[j] + o[j]])
        launches += 2
    return out, launches


def _ragged_leaves():
    """O = 1, 3 and 424; M not a multiple of the row split (300, 257, 600);
    a zero channel; an empty leaf; a NaN and an infinity in a channel."""
    nan = _w((3, 3, 5, 6), 13)
    nan[1, 2, 3, 4] = np.nan
    inf = _w((2, 2, 3, 5), 14)
    inf[0, 1, 2, 0] = -np.inf
    return [(_w((300, 1), 10), 1), (_w((257, 3), 11, 2.0), 2), (_w((600, 424), 12), 3),
            (_zero_channel((3, 3, 6, 3), 2), 4), (np.zeros((3, 3, 4, 0), np.float32), 5),
            (nan, 6), (inf, 7)]


def _decoder_leaves():
    """The 18 leaves of the W8A8 decoder, with their seeds, at the test widths."""
    model = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(3)
    leaves = []
    for path, mod in tq._conv_modules(model):
        leaf = path + ("kernel",)
        if any(c.startswith(p) for c in leaf for p in tq.DECODER_PREFIXES):
            leaves.append((mod.kernel.detach().numpy().copy(), tq.leaf_seed(7, leaf)))
    return model, leaves


@pytest.mark.parametrize("tree", ["ragged", "decoder", "two_tables"])
def test_quantize_tree_kernels_replay_gives_the_plain_versions_bytes(tree):
    if tree == "ragged":
        leaves = _ragged_leaves()
    elif tree == "decoder":
        model, leaves = _decoder_leaves()
        assert len(leaves) == 18
    else:  # more leaves than one table holds: two C-side tables
        rng = np.random.default_rng(8)
        leaves = [(_w(tuple(rng.integers(1, 6, 3)) + (int(rng.integers(1, 40)),), 20 + i), i)
                  for i in range(tq.TABLE_LEAVES + 5)]
    got, launches = quantize_tree_replay(leaves)
    live = sum(w.size > 0 for w, _ in leaves)
    assert launches == 2 * -(-live // tq.TABLE_LEAVES)
    for (w, seed), (q, sc) in zip(leaves, got):
        want_q, want_s = tq.quantize_stochastic_plain(torch.from_numpy(w), seed)
        np.testing.assert_array_equal(q, want_q.numpy())
        np.testing.assert_array_equal(sc.view(np.uint32), want_s.numpy().view(np.uint32))
    # the CPU wrapper of the tree is the same plain version, leaf by leaf
    for (q, sc), (tq_q, tq_s) in zip(got, tq.quantize_leaves(
            [(torch.from_numpy(w), seed) for w, seed in leaves])):
        np.testing.assert_array_equal(q, tq_q.numpy())
        np.testing.assert_array_equal(sc, tq_s.numpy())
    if tree == "decoder":  # and quantize_params_tree's leaves are these, in this order
        flat = [(n["kernel_q"], n["kernel_s"]) for n in _nodes(tq.quantize_params_tree(model, 7))]
        assert len(flat) == 18
        for (q, sc), (tq_q, tq_s) in zip(got, flat):
            np.testing.assert_array_equal(q, tq_q.numpy())
            np.testing.assert_array_equal(sc, tq_s.numpy())


def test_quantize_tree_replay_keeps_nan_and_zero_channels_as_the_plain_version():
    """A NaN weight makes its channel's scale 1 and its own byte 0 (torch's
    amax propagates the NaN, NaN > 0 is false, the cast of NaN gives 0); an
    infinity makes its channel's scale inf and the whole channel 0 but itself
    0 too; a zero channel gets scale 1 and bytes 0."""
    leaves = _ragged_leaves()
    got, _ = quantize_tree_replay(leaves)
    (nan_q, nan_s), (inf_q, inf_s), (zero_q, zero_s) = got[5], got[6], got[3]
    assert nan_s[4] == 1.0 and nan_q[1, 2, 3, 4] == 0
    assert np.isinf(inf_s[0]) and not inf_q[..., 0].any()
    assert zero_s[1] == 1.0 and not zero_q[..., 1].any()


def _nodes(tree):
    """The ``{kernel_q, kernel_s}`` nodes of a quant tree in insertion order."""
    for val in tree.values():
        if "kernel_q" in val:
            yield val
        else:
            yield from _nodes(val)


def test_quantize_stochastic_is_unbiased_where_rtn_is_not():
    """JAX ``test_quantize_stochastic_ref_is_unbiased`` on the port: a value
    mid-cell (0.123 * 127 = 15.62), averaged over 400 seeds."""
    w = np.full((4, 4, 4, 4), 0.123, np.float32)
    w[0, 0] = 1.0
    tw = torch.from_numpy(w)
    draws = [tq.dequantize(*tq.quantize_stochastic(tw, seed=i)).numpy() for i in range(400)]
    mean = np.stack(draws).mean(0)
    grid = float(tq.channel_scales(tw)[0])
    bias = np.abs(mean - w).max()
    assert bias < 0.15 * grid
    rtn_bias = np.abs(tq.dequantize(*tq.quantize_rtn(tw)).numpy() - w).max()
    assert bias < rtn_bias


@pytest.fixture(scope="module")
def models():
    jmodel = JCondSRVAE(JConfig(cr=2.0, patch_size=PS))
    variables = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, PS, PS, 4)),
        jnp.zeros((1, PS // 2, PS // 2, 4)), jax.random.PRNGKey(1), train=False))
    tmodel = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS))
    load_jax_variables(tmodel, variables)
    return jmodel, variables, tmodel


def _paths(tree, prefix=()):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_paths(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = val
    return out


def test_quantize_params_tree_names_the_leaves_jax_names(models):
    _, variables, tmodel = models
    want = _paths(jq.quantize_params_tree(variables["params"], jax.random.PRNGKey(2)))
    tree = tq.quantize_params_tree(tmodel, seed=2)
    got = _paths(tree)
    assert set(got) == set(want) and len(got) == 2 * 18
    assert all(p[0].startswith(("dx_", "dy_")) for p in got)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert str(leaf.dtype).split(".")[-1] == str(want[path].dtype), path
        if path[-1] == "kernel_s":
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[path]))
    # every value is one of the two grid points around w / scale
    kernel = variables["params"]["dx_up1"]["upsample"]["kernel"]
    node = tree["dx_up1"]["upsample"]
    assert np.abs(node["kernel_q"].numpy() - kernel / node["kernel_s"].numpy()).max() < 1.0
    # reproducible for a seed, and other bytes for another
    again = _paths(tq.quantize_params_tree(tmodel, seed=2))
    other = _paths(tq.quantize_params_tree(tmodel, seed=3))
    assert all(torch.equal(got[p], again[p]) for p in got)
    assert not torch.equal(got[("dx_conv1", "kernel_q")], other[("dx_conv1", "kernel_q")])


def test_each_leaf_has_its_own_stream():
    """Two convs with the same weights at different paths round differently
    (the per-leaf seed folds the CRC-32 of the flax path in)."""
    tmodel = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(0)
    with torch.no_grad():
        tmodel.dx_conv3.kernel.copy_(tmodel.dy_conv3.kernel)
    tree = tq.quantize_params_tree(tmodel, seed=0)
    a, b = tree["dx_conv3"], tree["dy_conv3"]
    assert torch.equal(a["kernel_s"], b["kernel_s"])
    assert not torch.equal(a["kernel_q"], b["kernel_q"])
    assert tq.leaf_seed(5, ("dx_conv3", "kernel")) != tq.leaf_seed(5, ("dy_conv3", "kernel"))
    assert tq.leaf_seed(5, ("a",)) >> 32 == 5


@pytest.mark.parametrize("prefixes,want", [
    (("upsample",), {("upsample",)}),
    (("",), {("conv",), ("upsample",)}),
    (("dx_",), set()),
])
def test_prefixes_match_any_path_component(prefixes, want):
    from simple_vae_rs_tpu_torch.ops.conv_blocks import UpBlock

    block = UpBlock(8, 4)
    for mod in block.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(np.random.default_rng(0))
    tree = tq.quantize_params_tree(block, 0, prefixes=prefixes)
    assert {p[:-1] for p in _paths(tree)} == want


def test_attach_quant_sets_and_clears(models):
    _, _, tmodel = models
    tmodel = CondSRVAE(tmodel.config).init_weights(1)
    assert not tq.has_quant(tmodel)
    tree = tq.quantize_params_tree(tmodel, 0)
    tq.attach_quant(tmodel, tree)
    assert tq.has_quant(tmodel)
    assert tmodel.dx_up1.upsample.kernel_q.dtype == torch.int8
    assert tmodel.dx_up1.upsample.kernel_p.dtype == torch.int32
    assert tmodel.ex_down1.conv.kernel_q is None
    assert "dx_conv1.kernel_q" in tmodel.state_dict()
    assert "dx_conv1.kernel_p" not in tmodel.state_dict()  # the repack is a cache
    with pytest.raises(KeyError, match="no conv"):
        tq.attach_quant(tmodel, {"dx_nothing": tree["dx_conv1"]})
    with pytest.raises(KeyError, match="kernel_q and"):
        tq.attach_quant(tmodel, {"dx_conv1": {"kernel_q": tree["dx_conv1"]["kernel_q"]}})
    with pytest.raises(ValueError, match="do not match"):
        tq.attach_quant(tmodel, {"dx_conv1": tree["dx_conv2"]})
    tq.attach_quant(tmodel, {})
    assert not tq.has_quant(tmodel) and "dx_conv1.kernel_q" not in tmodel.state_dict()


def test_pack_int8_weights_matches_jax_pack(models):
    """The weights-only payload: the same leaves packed (floating, ndim >= 2,
    at least 4096 elements) with the same bytes and scales as the JAX
    package's, and no packed leaf left in float32."""
    import copy

    _, variables, tmodel = models
    payload, (tags, treedef) = jq.pack_int8_weights(variables)
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    want = {}
    for (path, _), tag, ent in zip(flat, tags, payload):
        if tag == "int8":
            name = ".".join(p.key for p in path[1:])
            want[name] = ent
    model = copy.deepcopy(tmodel)
    sizes = {n: p.numel() for n, p in model.named_parameters()}
    dense = {n: p.detach().clone() for n, p in model.named_parameters()}
    packed = tq.pack_int8_weights(model)
    assert set(packed) == set(want) and len(packed) > 20
    assert all(sizes[n] >= tq.PACK_MIN_SIZE for n in packed)
    assert tq.PACK_MIN_SIZE == jexport._PACK_MIN_SIZE
    for name, (q, s) in packed.items():
        np.testing.assert_array_equal(q.numpy(), np.asarray(want[name][0]))
        np.testing.assert_array_equal(s.numpy(), np.asarray(want[name][1]))
    params = dict(model.named_parameters())
    assert all(params[n].numel() == 0 for n in packed)
    assert all(params[n].numel() == sizes[n] for n in sizes if n not in packed)
    with tq.unpack_weights(model, packed):
        for name in packed:
            assert params[name].shape == dense[name].shape
            scale = packed[name][1]
            err = float((params[name] - dense[name]).abs().max())
            assert err <= 0.5 * float(scale.max()) + 1e-7
    assert all(params[n].numel() == 0 for n in packed)  # released again
    with tq.unpack_weights(model, None) as same:
        assert same is model
