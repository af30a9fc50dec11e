"""The port's fused 3x3 chain and its routing, against the JAX package.

Inputs are made with numpy from a seed and go through the JAX function (the
two Pallas chain kernels in interpret mode, and ``_chain_reference``) and the
port's plain version, in float32 on the CPU. The CUDA kernel itself runs only
in the tests marked ``gpu``; here its index arithmetic (tiles, halos clipped
to the image, padded pixel strides, weight slices, the ragged last tiles and
channel tails) is replayed in numpy against the plain version.

Tolerances: against ``_chain_reference`` atol 1e-5 (the same sequential
float32 convs); against the Pallas kernels in interpret mode and for the
replay 1e-5 of the largest |reference| (they sum the taps in another order,
and the test chains' outputs reach 120); chained against unchained model
outputs rtol 1e-5, atol 1e-5, as the JAX package's own routing test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simple_vae_rs_tpu.ops import pallas_conv as pc

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.ops import conv_blocks as tblocks
from simple_vae_rs_tpu_torch.ops import fused_chain as fch
from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.ops import quantize as qz

PS = 16


def _chain_case(seed=13, b=2, h=32, w=16, chans=(8, 8, 16, 4)):
    """The JAX package's own chain test case (``tests/test_pallas_conv.py``)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, chans[0])).astype(np.float32)
    ks = [(rng.standard_normal((3, 3, chans[i], chans[i + 1])).astype(np.float32) * 0.3)
          for i in range(len(chans) - 1)]
    bs = [rng.standard_normal(chans[i + 1]).astype(np.float32) for i in range(len(chans) - 1)]
    return x, ks, bs


def _plain(x, ks, bs):
    t = torch.from_numpy
    return fch.conv3x3_chain_plain(t(x), [t(k) for k in ks], [t(b) for b in bs]).numpy()


JAX_CASES = {
    "default": dict(),
    "multi_strip": dict(seed=14),
    "small_outputs_32x32": dict(seed=15, b=2, h=32, w=32, chans=(16, 16, 4)),
    "one_layer_ragged": dict(seed=16, b=3, h=8, w=24, chans=(5, 7)),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_chain_plain_matches_jax_reference_and_pallas_kernels(case, monkeypatch):
    x, ks, bs = _chain_case(**JAX_CASES[case])
    chans = [x.shape[-1]] + [k.shape[-1] for k in ks]
    got = _plain(x, ks, bs)
    want = np.asarray(pc._chain_reference(jnp.asarray(x), tuple(ks), tuple(bs)))
    assert got.shape == want.shape == x.shape[:3] + (chans[-1],)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if case == "multi_strip":  # several row strips, as the JAX test forces them
        monkeypatch.setattr(pc, "_VMEM_BUDGET", 2_000_000)
        th = pc._chain_strip_rows(x.shape[1], x.shape[2], chans, 4)
        assert th and th < x.shape[1]
    tol = 1e-5 * float(np.abs(want).max())
    for kernel in (pc.fused_conv3x3_chain, pc.fused_conv3x3_chain_wl):
        interp = np.asarray(kernel(jnp.asarray(x), tuple(ks), tuple(bs), interpret=True))
        np.testing.assert_allclose(got, interp, rtol=0, atol=tol)
    # a CPU tensor takes the plain version, with or without the flag
    t = torch.from_numpy
    for plain in (False, True):
        wrapped = fch.fused_conv3x3_chain(t(x), [t(k) for k in ks], [t(b) for b in bs],
                                          plain=plain)
        np.testing.assert_array_equal(wrapped.numpy(), got)


# ------------------------------------------------------ the kernel's indices
def _replay(x, ks, bs, tile=None):
    """``csrc/conv_chain.cu`` replayed in numpy, block by block and thread by
    thread (vectorised over a block's 256 threads): the same rectangles,
    offsets into the flat shared-memory buffers, weight slices, tile shapes
    and masks. Shared memory starts as NaN, so a read of anything the kernel
    did not write shows."""
    b, h, w, c0 = x.shape
    chans = (c0,) + tuple(k.shape[-1] for k in ks)
    n = len(ks)
    if tile is None:
        th, tw, buf0, buf1 = fch.plan_chain(h, w, chans)
    else:
        th, tw = tile
        buf0, buf1 = fch.stage_buffers(th, tw, h, w, chans)
    assert buf0 % 4 == 0 and buf1 % 4 == 0
    assert 4 * (buf0 + buf1 + fch.WS_FLOATS) <= fch.SMEM_BYTES
    nt, bk = 256, fch.BK
    tiles_x, tiles_y = -(-w // tw), -(-h // th)
    out = np.full((b * h * w * chans[-1],), np.nan, np.float32)
    xflat = x.ravel()
    tid = np.arange(nt)
    for block in range(b * tiles_x * tiles_y):
        bb, tile_i = divmod(block, tiles_x * tiles_y)
        ty0, tx0 = (tile_i // tiles_x) * th, (tile_i % tiles_x) * tw
        stored, computed = fch.tile_rects(ty0, tx0, th, tw, n, h, w)
        smem = np.full((buf0 + buf1 + fch.WS_FLOATS,), np.nan, np.float32)
        bufs = [smem[:buf0], smem[buf0:buf0 + buf1]]
        ws = smem[buf0 + buf1:]
        sy0, sx0, sh, sw = stored[0]
        c0p = fch.pixel_stride(c0)
        idx = np.arange(sh * sw * c0p)
        pix, c = idx // c0p, idx % c0p
        yy, xx = sy0 + pix // sw, sx0 + pix % sw
        ok = (c < c0) & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        src_idx = ((bb * h + yy) * w + xx) * c0 + c
        bufs[0][idx] = np.where(ok, xflat[np.where(ok, src_idx, 0)], 0.0)
        for l in range(n):
            last = l == n - 1
            src, dst = bufs[l & 1], bufs[(l + 1) & 1]
            cin, cout = chans[l], chans[l + 1]
            cin4, cin_p = fch.chan4(cin), fch.pixel_stride(cin)
            cout4, cout_p = fch.chan4(cout), fch.pixel_stride(cout)
            in_y0, in_x0, _, in_w = stored[l]
            cy0, cx0, ch, cw = computed[l + 1]
            if not last:
                oy0, ox0, oh, ow = stored[l + 1]
                dst[:oh * ow * cout_p] = 0.0
            m_all = ch * cw
            tx_n, tm = fch.layer_tile(cout, m_all)
            ty_n = nt // tx_n
            bm, bn = tm * ty_n, 4 * tx_n
            tx, ty = tid % tx_n, tid // tx_n
            kchunks = -(-cin4 // bk)
            wflat, bias = ks[l].ravel(), bs[l]
            for m0 in range(0, m_all, bm):
                m = m0 + ty[:, None] + np.arange(tm)[None, :] * ty_n  # (threads, TM)
                valid = m < m_all
                mm = np.where(valid, m, 0)
                y, xpos = cy0 + mm // cw, cx0 + mm % cw
                in_off = ((y - 1 - in_y0) * in_w + (xpos - 1 - in_x0)) * cin_p
                if last:
                    out_off = ((bb * h + y) * w + xpos) * cout
                else:
                    out_off = ((y - oy0) * ow + (xpos - ox0)) * cout_p
                for n0 in range(0, cout4, bn):
                    acc = np.zeros((nt, tm, 4), np.float32)
                    for chunk in range(9 * kchunks):
                        t, c_lo = chunk // kchunks, (chunk % kchunks) * bk
                        e = np.arange(bk * bn)
                        kk, nn = e // bn, n0 + e % bn
                        live = (c_lo + kk < cin) & (nn < cout)
                        widx = (t * cin + c_lo + kk) * cout + nn
                        ws[e] = np.where(live, wflat[np.where(live, widx, 0)], 0.0)
                        rows = min(bk, cin4 - c_lo)
                        tap = ((t // 3) * in_w + t % 3) * cin_p + c_lo
                        for k4 in range(0, rows, 4):
                            a = src[in_off[:, :, None] + tap + k4 + np.arange(4)]  # (T, TM, 4)
                            for j in range(4):
                                bq = ws[(k4 + j) * bn + tx[:, None] * 4 + np.arange(4)]  # (T, 4)
                                acc += a[:, :, j, None] * bq[:, None, :]
                    nvec = n0 + tx * 4
                    chan = nvec[:, None] + np.arange(4)  # (T, 4)
                    bv = np.where(chan < cout, bias[np.minimum(chan, cout - 1)], 0.0)
                    vals = acc + bv[:, None, :].astype(np.float32)
                    writes = np.broadcast_to(
                        valid[:, :, None] & (nvec < cout4)[:, None, None], vals.shape)
                    if last:
                        writes = writes & (chan < cout)[:, None, :]
                    target = out if last else dst
                    where = out_off[:, :, None] + chan[:, None, :]
                    target[where[writes]] = vals[writes]
    assert not np.isnan(out).any()
    return out.reshape(b, h, w, chans[-1])


REPLAY_CASES = {
    # (x shape, later channel widths, forced tile or None for the planned one)
    "two_layers_ragged_tiles": ((2, 9, 11, 5), (7, 3), (4, 8)),
    "four_layers_small_tiles": ((1, 12, 10, 8), (20, 6, 4, 3), (4, 4)),
    "one_layer_planned": ((1, 5, 7, 3), (6,), None),
    "deep_input_two_weight_slices": ((1, 4, 4, 40), (24, 9), None),
    "wide_tile_pixel_loop": ((1, 12, 12, 4), (18, 5), (8, 16)),
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_chain_kernel_index_arithmetic_matches_plain(case):
    shape, widths, tile = REPLAY_CASES[case]
    x, ks, bs = _chain_case(seed=len(case), b=shape[0], h=shape[1], w=shape[2],
                            chans=(shape[3],) + widths)
    want = _plain(x, ks, bs)
    got = _replay(x, ks, bs, tile)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("h,w,chans", [
    (64, 64, (64, 64, 16, 16, 4)),      # Cond dx tail
    (32, 32, (64, 64, 16, 16, 4)),      # Cond dy tail, VAE decoder tail
    (8, 8, (64, 64, 128, 128, 106)),    # Cond ey tail
    (8, 8, (128, 128, 128, 128, 424)),  # Cond ex tail
    (8, 8, (64, 64, 128, 128, 84)),     # VAE encoder tail
    (19, 23, (5, 13, 3)),
    (1, 1, (3, 2)),
])
def test_plan_chain_fits_and_covers(h, w, chans):
    th, tw, buf0, buf1 = fch.plan_chain(h, w, chans)
    n = len(chans) - 1
    assert 4 * (buf0 + buf1 + fch.WS_FLOATS) <= fch.SMEM_BYTES
    assert (buf0, buf1) == fch.stage_buffers(th, tw, h, w, chans)
    covered = np.zeros((h, w), int)
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            stored, computed = fch.tile_rects(ty0, tx0, th, tw, n, h, w)
            y0, x0, ch, cw = computed[n]
            covered[y0:y0 + ch, x0:x0 + cw] += 1
            for s in range(n):
                sy, sx, sh, sw = stored[s]
                cy, cx, hh, ww = computed[s]
                assert sh * sw * fch.pixel_stride(chans[s]) <= (buf0, buf1)[s & 1]
                # computed = stored clipped to the image; the next stage's
                # computed rectangle reads one pixel around itself, all stored
                assert (cy, cx, cy + hh, cx + ww) == (max(sy, 0), max(sx, 0),
                                                      min(sy + sh, h), min(sx + sw, w))
                ny, nx, nh, nw = computed[s + 1]
                assert (sy, sx, sh, sw) == (ny - 1, nx - 1, nh + 2, nw + 2)
    assert (covered == 1).all()
    if h == 8:  # one block holds the whole image: no halo is recomputed
        assert (th, tw) == (8, 8)


def test_pixel_stride_separates_banks():
    for c in (1, 3, 4, 16, 53, 64, 106, 128, 212, 424):
        p = fch.pixel_stride(c)
        assert p % 4 == 0 and p >= fch.chan4(c) >= c and (p // 4) % 2 == 1


def test_chain_wrapper_rejects_what_the_kernel_does_not_take():
    x, ks, bs = _chain_case(b=1, h=4, w=4, chans=(3, 5, 2))
    t = torch.from_numpy
    tx, tks, tbs = t(x), [t(k) for k in ks], [t(b) for b in bs]
    with pytest.raises(ValueError):
        fch.fused_conv3x3_chain(tx.to("meta"), [k.to("meta") for k in tks],
                                [b.to("meta") for b in tbs])
    with pytest.raises(ValueError):
        fch.fused_conv3x3_chain(tx, tks[::-1], tbs[::-1])  # widths do not chain
    with pytest.raises(ValueError):
        fch.fused_conv3x3_chain(tx, tks, tbs[:1])
    with pytest.raises(ValueError):
        fch.fused_conv3x3_chain(tx, [], [])
    with pytest.raises(ValueError):
        fch.fused_conv3x3_chain(tx[0], tks, tbs)
    with pytest.raises(RuntimeError, match="no backward"):
        fch.fused_conv3x3_chain(tx.requires_grad_(), tks, tbs)
    with pytest.raises(ValueError, match="fits"):
        fch.plan_chain(8, 8, (4000, 4000, 4))


# ------------------------------------------------------------- the routing
@pytest.fixture(scope="module")
def model():
    m = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(3)
    rng = np.random.default_rng(4)
    with torch.no_grad():  # non-trivial BatchNorm statistics
        for mod in m.modules():
            if isinstance(mod, tblocks.BatchNorm):
                mod.mean.copy_(torch.from_numpy(rng.normal(0, 0.2, mod.mean.shape)).float())
                mod.var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, mod.var.shape)).float())
    return m.eval()


def _forward_inputs(m, batch, seed):
    rng = np.random.default_rng(seed)
    shape_u, shape_z = m.generation_noise_shapes(batch, (PS // 2, PS // 2))
    arrays = (rng.random((batch, PS, PS, 4)), rng.random((batch, PS // 2, PS // 2, 4)),
              rng.standard_normal(shape_u), rng.standard_normal(shape_z))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


@pytest.fixture
def chain_calls(monkeypatch):
    """Records the widths of every chain the models route."""
    calls = []
    orig = fch.fused_conv3x3_chain

    def spy(x, kernels, biases, plain=False):
        calls.append((tuple(x.shape), tuple(k.shape[-1] for k in kernels), plain))
        return orig(x, kernels, biases, plain=plain)

    monkeypatch.setattr(fch, "fused_conv3x3_chain", spy)
    return calls


def test_tail_chain_routing_matches_the_conv_by_conv_path(model, chain_calls):
    inputs = _forward_inputs(model, 2, seed=5)
    with torch.no_grad():
        want = model(*inputs)
        assert not chain_calls  # off by default
        tblocks.use_chain(model)
        try:
            got = model(*inputs)
        finally:
            tblocks.use_chain(model, False)
    cfg = model.config
    # the full 8-tuple: both encoder heads and both decoder tails chained
    assert sorted(c[1] for c in chain_calls) == sorted([
        (64, 128, 128, 2 * cfg.u_channels), (128, 128, 128, 2 * cfg.z_channels),
        (64, 16, 16, 4), (64, 16, 16, 4)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def test_tail_chain_defers_in_training_and_under_autograd(model, chain_calls):
    inputs = _forward_inputs(model, 2, seed=6)
    tblocks.use_chain(model)
    try:
        model.train()
        stats = {k: v.clone() for k, v in model.state_dict().items()}
        model(*inputs)
        model.load_state_dict(stats)  # the training pass moved the running statistics
        model.eval()
        assert not chain_calls
        out = model(*inputs)  # eval, but a gradient is recorded: conv by conv
        assert not chain_calls and out[0].requires_grad
        with torch.no_grad():
            model(*inputs)
        assert len(chain_calls) == 4
    finally:
        model.eval()
        tblocks.use_chain(model, False)


def test_tail_chain_defers_to_int8_weights(model, chain_calls):
    """A tail whose convs carry int8 weights keeps the W8A8 kernels; the
    float32 ``ey`` tail of the same model still chains."""
    import copy

    m = copy.deepcopy(model)
    qz.attach_quant(m, qz.quantize_params_tree(m, seed=0))
    tblocks.use_chain(m)
    y, eps_u, eps_z = _forward_inputs(m, 2, seed=7)[1:]
    with torch.no_grad():
        got = m.conditional_generation_eps(y, eps_u, eps_z)
        assert [c[1] for c in chain_calls] == [(64, 128, 128, 2 * m.config.u_channels)]
        tblocks.use_chain(m, False)
        want = m.conditional_generation_eps(y, eps_u, eps_z)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    # one int8 conv among the four is enough to defer
    m2 = copy.deepcopy(model)
    tblocks.use_chain(m2)
    q, s = qz.quantize_rtn(m2.dx_conv3.kernel.detach())
    m2.dx_conv3.set_quant(q, s)
    chain_calls.clear()
    with torch.no_grad():
        m2.decode_y(torch.zeros(1, 2, 2, m2.config.u_channels))
        m2.decode_x_from_features(torch.zeros(1, 2, 2, m2.config.z_channels),
                                  torch.zeros(1, 1, 1, m2.config.latent_size // 16))
    assert [c[1] for c in chain_calls] == [(64, 16, 16, 4)]  # dy chained, dx deferred


def test_tail_chain_obeys_the_plain_path(model, chain_calls):
    y, eps_u, eps_z = _forward_inputs(model, 1, seed=8)[1:]
    tblocks.use_chain(model)
    tblocks.use_plain_path(model)
    try:
        before = dict(fc.launches)
        with torch.no_grad():
            model.conditional_generation_eps(y, eps_u, eps_z)
        assert [c[2] for c in chain_calls] == [True, True]
        assert fc.launches == before
    finally:
        tblocks.use_plain_path(model, False)
        tblocks.use_chain(model, False)
    assert fc.CHAIN in fc.launches and fc.CHAIN not in fc.role_launches
    fc.launches[fc.CHAIN] = 3
    fc.reset_launches()
    assert fc.launches[fc.CHAIN] == 0
