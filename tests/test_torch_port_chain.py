"""The port's fused 3x3 chain and its routing, against the JAX package.

Inputs are made with numpy from a seed and go through the JAX function (the
two Pallas chain kernels in interpret mode, and ``_chain_reference``) and the
port's plain version, in float32 on the CPU. The CUDA kernel itself runs only
in the tests marked ``gpu``; here its launch is replayed in numpy against the
plain version: the plan (strips, panels, rows a step, the rings in shared
memory), the row schedule with its ring slots, seams and zero border rows,
and per layer step the weight slots and each lane's m16n8k8 fragment
offsets, with the 3xTF32 products.

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
def _tf32(a):
    """What the tensor core reads of a TF32 operand: the top 19 bits."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    """The kernel's split_tf32 as the tensor core sees it: hi = a truncated,
    lo = a - hi (exact in float32), truncated in turn."""
    hi = _tf32(a)
    return hi, _tf32((a - hi).astype(np.float32))


def _replay(x, ks, bs, plan=None):
    """``csrc/conv_chain.cu`` replayed in numpy, block by block: the plan,
    the strips and panels with their stage spans, the row schedule
    (``fch.advance``), the ring slots, the stage-0 loads and zero border
    rows, and per layer step the m and n tiles, the weight ring's 32-row
    slots, each lane's m16n8k8 fragment offsets into the rings (vectorised
    over warps and lanes), the 3xTF32 products with a rounded add per 8-deep
    k group, and the epilogue's addresses. Shared memory is NaN where the
    kernel does not zero it, so a read of a weight cell no copy wrote shows;
    every ring slot carries the row it holds, so a read of a row that was
    overwritten, or a store over a row a layer still reads, fails. Returns
    (output, writes per output element)."""
    b, h, w, c0 = x.shape
    chans = (c0,) + tuple(k.shape[-1] for k in ks)
    n = len(ks)
    plan = plan or fch.plan_chain(b, h, w, chans)
    assert plan.smem_bytes <= fch.SMEM_BYTES
    pstride = [fch.pixel_stride(c) for c in chans]
    out = np.full(b * h * w * chans[-1], np.nan, np.float32)
    writes = np.zeros(out.size, np.int64)
    xflat = x.ravel()
    lane = np.arange(32)
    gq, tq = lane >> 2, lane & 3
    for blk in range(b * plan.strips * plan.panels):
        bb, rem = divmod(blk, plan.strips * plan.panels)
        o0 = (rem // plan.panels) * plan.strip
        x0 = (rem % plan.panels) * plan.panel
        rspan = fch.stage_spans(o0, min(h, o0 + plan.strip), n, h)
        cspan = fch.stage_spans(x0, min(w, x0 + plan.panel), n, w)
        smem = np.full(plan.smem_bytes // 4, np.nan, np.float32)
        smem[:plan.ws_off] = 0.0  # the rings start zeroed
        held = [np.full(plan.rows[s], -99) for s in range(n)]
        for s in range(n):
            assert cspan[s][1] - cspan[s][0] <= plan.cols[s]
        nxt, hi = [lo for lo, _ in rspan], [e for _, e in rspan]

        def ring_row(s, y):  # offset of the ring row holding row y of stage s
            return plan.offsets[s] + ((y + 1) % plan.rows[s]) * plan.cols[s] * pstride[s]

        def store(s, y, values=None):
            """Row y of stage s takes its ring slot: the row there before must
            be one layer s no longer reads (it next reads from nxt[s+1] - 1)."""
            slot = (y + 1) % plan.rows[s]
            assert held[s][slot] == -99 or held[s][slot] < nxt[s + 1] - 1
            held[s][slot] = y
            if values is None:  # a border row: zeros
                smem[ring_row(s, y):ring_row(s, y) + plan.cols[s] * pstride[s]] = 0.0

        def gemm(l, ra, rb):
            cin, cout = chans[l], chans[l + 1]
            bm, bn, wm_t, wn_t, ks_ = fch.LAYER_TILES[fch.layer_tile(cout)]
            warps_m, warps_n, mi_n, ni_n = bm // wm_t, bn // wn_t, wm_t // 16, wn_t // 8
            assert warps_m * warps_n == fch.NT // 32
            b_ld = fch.b_ld(bn)
            wslot = plan.ws_slot
            assert ks_ * b_ld <= wslot
            k8, n8 = fch.c8(cin), fch.c8(cout)
            k_all = 9 * k8
            pin, q_in = pstride[l], plan.rows[l]
            in_row = plan.cols[l] * pin
            last = l == n - 1
            xin_lo, xout_lo = cspan[l][0], cspan[l + 1][0]
            cx0 = max(0, xout_lo)
            cw = min(w, cspan[l + 1][1]) - cx0
            m_all = (rb - ra) * cw
            wflat = ks[l].reshape(9 * cin, cout)
            nq_n = bn // 4
            wm_i, wn_i = np.arange(warps_m), np.arange(warps_n)
            mi_i, h_i = np.arange(mi_n), np.arange(2)
            for m0 in range(0, m_all, bm):
                m = (m0 + wm_i[:, None, None, None] * wm_t + mi_i[None, :, None, None] * 16
                     + gq[None, None, None, :] + 8 * h_i[None, None, :, None])  # (WM, MI, 2, 32)
                mm = np.where(m < m_all, m, m0)
                frow, fcol = ra + mm // cw, cx0 + mm % cw
                for n0 in range(0, n8, bn):
                    live = ((m0 + wm_i * wm_t < m_all)[:, None]
                            & (n0 + wn_i * wn_t < n8)[None, :])  # (WM, WN)

                    def load_slot(slot, k0):
                        base = plan.ws_off + slot * wslot
                        smem[base:base + wslot] = np.nan
                        e = np.arange(ks_ * nq_n)
                        kk, nq = e // nq_n, e % nq_n
                        kr, nn = k0 + kk, n0 + 4 * nq
                        t, c = kr // k8, kr % k8
                        kv = (kr < k_all) & (c < cin)
                        for q in range(4):
                            v = kv & (nn + q < cout)
                            smem[base + kk * b_ld + 4 * nq + q] = np.where(
                                v, wflat[np.where(v, t * cin + c, 0), np.where(v, nn + q, 0)],
                                np.float32(0))

                    acc = np.zeros((warps_m, warps_n, mi_n, ni_n, 32, 4), np.float32)
                    nsteps = -(-k_all // ks_)
                    for st in range(fch.STAGES - 1):
                        if st < nsteps:
                            load_slot(st, st * ks_)
                    for step in range(nsteps):
                        if step + fch.STAGES - 1 < nsteps:
                            load_slot((step + fch.STAGES - 1) % fch.STAGES,
                                      (step + fch.STAGES - 1) * ks_)
                        bs_base = (plan.ws_off + (step % fch.STAGES) * wslot
                                   + (tq * b_ld)[None, :] + (wn_i * wn_t)[:, None] + gq[None, :])
                        # the tap and first channel of the slot's first k group
                        g0 = step * (ks_ // 8)
                        t0 = g0 // (k8 // 8)
                        c0_, ky, kx = (g0 - t0 * (k8 // 8)) * 8, t0 // 3, t0 % 3
                        for kk in range(0, ks_, 8):
                            if step * ks_ + kk >= k_all:
                                break
                            yy = frow + ky - 1  # the input row each fragment pixel reads
                            ok = m < m_all
                            assert (held[l][(yy[ok] + 1) % q_in] == yy[ok]).all()
                            ap = (plan.offsets[l] + ((frow + ky) % q_in) * in_row
                                  + (fcol - 1 - xin_lo) * pin + tq + kx * pin + c0_)
                            a_hw = np.full((warps_m, mi_n, 16, 8), np.nan, np.float32)
                            a_hw[:, :, gq, tq] = smem[ap[:, :, 0, :]]
                            a_hw[:, :, gq + 8, tq] = smem[ap[:, :, 1, :]]
                            a_hw[:, :, gq, tq + 4] = smem[ap[:, :, 0, :] + 4]
                            a_hw[:, :, gq + 8, tq + 4] = smem[ap[:, :, 1, :] + 4]
                            bp = (bs_base[:, None, :] + kk * b_ld
                                  + (np.arange(ni_n) * 8)[None, :, None])
                            b_hw = np.full((warps_n, ni_n, 8, 8), np.nan, np.float32)
                            b_hw[:, :, tq, gq] = smem[bp]
                            b_hw[:, :, tq + 4, gq] = smem[bp + 4 * b_ld]
                            (ah, al), (bh, bl) = _split(a_hw), _split(b_hw)
                            d = sum(np.einsum("amik,bnkj->abmnij", p_.astype(np.float64),
                                              q_.astype(np.float64))
                                    for p_, q_ in ((al, bh), (ah, bl), (ah, bh)))
                            regs = np.stack([d[..., gq, 2 * tq], d[..., gq, 2 * tq + 1],
                                             d[..., gq + 8, 2 * tq],
                                             d[..., gq + 8, 2 * tq + 1]], -1)
                            acc = np.where(live[:, :, None, None, None, None],
                                           (acc + regs).astype(np.float32), acc)
                            c0_ += 8
                            if c0_ == k8:
                                c0_, kx = 0, kx + 1
                                if kx == 3:
                                    kx, ky = 0, ky + 1
                    # epilogue
                    for wmi in range(warps_m):
                        for wni in range(warps_n):
                            if not live[wmi, wni]:
                                continue
                            for mi in range(mi_n):
                                for hh in range(2):
                                    mv = m[wmi, mi, hh]
                                    y, xc = frow[wmi, mi, hh], fcol[wmi, mi, hh]
                                    for ni in range(ni_n):
                                        nv = n0 + wni * wn_t + ni * 8 + 2 * tq
                                        for col, reg in ((nv, 2 * hh), (nv + 1, 2 * hh + 1)):
                                            bias = np.where(col < cout,
                                                            bs[l][np.minimum(col, cout - 1)],
                                                            np.float32(0))
                                            val = acc[wmi, wni, mi, ni, :, reg] + bias
                                            sel = (mv < m_all) & (nv < n8)
                                            if last:
                                                sel = sel & (col < cout)
                                                dst = ((bb * h + y) * w + xc) * cout + col
                                                out[dst[sel]] = val[sel]
                                                np.add.at(writes, dst[sel], 1)
                                            else:
                                                dst = (ring_row(l + 1, y) + (xc - xout_lo)
                                                       * pstride[l + 1] + col)
                                                smem[dst[sel]] = val[sel]

        def load(r0, r1):  # stage 0's rows [r0, r1)
            for y in range(r0, r1):
                if 0 <= y < h:
                    store(0, y, values=True)
                    cx0, cx1 = max(0, cspan[0][0]), min(w, cspan[0][1])
                    dst = ring_row(0, y) + (cx0 - cspan[0][0]) * pstride[0]
                    px = np.arange(cx1 - cx0)
                    for c in range(c0):
                        src = ((bb * h + y) * w + cx0 + px) * c0 + c
                        smem[dst + px * pstride[0] + c] = xflat[src]
                else:
                    store(0, y)

        # a step's input rows are loaded as soon as layer 0 of the step before is done
        load(nxt[0], min(hi[0], nxt[0] + plan.rs))
        while nxt[n] < hi[n]:
            new = fch.advance(nxt, hi, plan.rs)
            assert new != nxt  # every step moves
            nxt[0] = new[0]
            for l in range(n):
                r0, r1 = nxt[l + 1], new[l + 1]
                if r1 > r0:
                    if plan.clear >> (l + 1) & 1 and r0 == rspan[l + 1][0]:  # takes over a ring
                        size = plan.rows[l + 1] * plan.cols[l + 1] * pstride[l + 1]
                        smem[plan.offsets[l + 1]:plan.offsets[l + 1] + size] = 0.0
                        held[l + 1][:] = -99
                    if l + 1 < n:
                        for y in range(r0, r1):
                            store(l + 1, y, values=None if (y < 0 or y >= h) else True)
                    if max(r0, 0) < min(r1, h):
                        gemm(l, max(r0, 0), min(r1, h))
                    nxt[l + 1] = r1
                if l == 0:
                    assert not plan.clear or nxt[0] == hi[0]  # stage 2 shares stage 0's ring
                    load(nxt[0], min(hi[0], nxt[0] + plan.rs))
    assert not np.isnan(out).any()
    return out.reshape(b, h, w, chans[-1]), writes


REPLAY_CASES = {
    # (x shape, later channel widths, (strip, panel, rows a step) or None for the plan)
    "two_layers_ragged_seams": ((2, 9, 11, 5), (7, 3), (4, 11, 2)),
    "four_layers_panels_one_row_a_step": ((1, 12, 10, 8), (20, 6, 4, 3), (4, 4, 1)),
    "one_layer_planned": ((1, 5, 7, 3), (6,), None),
    "deep_input_two_weight_slices": ((1, 4, 4, 40), (24, 9), None),
    "full_rows_ring_of_five": ((1, 12, 12, 4), (18, 5), (12, 12, 3)),
    "one_image_several_strips_planned": ((1, 16, 8, 16), (16, 16, 4), None),
    "odd_hw_o4_planned": ((2, 7, 9, 12), (16, 16, 4), None),
    "tail_widths_seam_in_image": ((1, 20, 8, 64), (64, 16, 16, 4), (7, 8, 4)),
    "wide_layer_two_n_tiles": ((1, 5, 6, 8), (136, 7), None),
    "one_step_shared_rings": ((2, 6, 7, 16), (8, 4, 5), None),
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_chain_kernel_index_arithmetic_matches_plain(case):
    shape, widths, forced = REPLAY_CASES[case]
    x, ks, bs = _chain_case(seed=len(case), b=shape[0], h=shape[1], w=shape[2],
                            chans=(shape[3],) + widths)
    chans = (shape[3],) + widths
    plan = fch.chain_layout(shape[1], shape[2], chans, *forced) if forced else None
    if case == "one_image_several_strips_planned":
        assert fch.plan_chain(*shape[:3], chans).strips > 1
    if case == "one_step_shared_rings":  # stage 2 over stage 0, at another pixel stride
        p = fch.plan_chain(*shape[:3], chans)
        assert p.offsets[2] == p.offsets[0] and p.clear == 4 and p.rs >= shape[1] + 2
    want = _plain(x, ks, bs)
    got, writes = _replay(x, ks, bs, plan)
    assert (writes == 1).all()  # every output element once
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


# (B, H, W, channels) at the batch of each canonical path, then ragged shapes
PLAN_CASES = [
    (1000, 64, 64, (64, 64, 16, 16, 4)),     # Cond dx tail, the 1000-draw decode
    (512, 32, 32, (64, 64, 16, 16, 4)),      # Cond dy tail, VAE decoder tail
    (512, 8, 8, (64, 64, 128, 128, 106)),    # Cond ey tail
    (512, 8, 8, (128, 128, 128, 128, 424)),  # Cond ex tail
    (512, 8, 8, (64, 64, 128, 128, 84)),     # VAE encoder tail
    (3, 19, 23, (5, 13, 3)),
    (1, 1, 1, (3, 2)),
]


@pytest.mark.parametrize("b,h,w,chans", PLAN_CASES)
def test_plan_chain_fits_and_covers(b, h, w, chans):
    plan = fch.plan_chain(b, h, w, chans)
    n = len(chans) - 1
    assert plan.smem_bytes <= fch.SMEM_BYTES
    assert plan == fch.chain_layout(h, w, chans, plan.strip, plan.panel, plan.rs)
    # the rings at 16-byte alignment, the weight ring after them; two stages
    # share memory only in a one-step plan, and then only stages s and s + 2
    sizes = [plan.rows[s] * plan.cols[s] * fch.pixel_stride(chans[s]) for s in range(n)]
    one_step = plan.rs >= max(hi - lo for lo, hi in (
        fch.stage_spans(o0, min(h, o0 + plan.strip), n, h)[0] for o0 in range(0, h, plan.strip)))
    for s in range(n):
        assert plan.offsets[s] % 4 == 0 and plan.offsets[s] + sizes[s] <= plan.ws_off
        for t in range(s):
            overlap = (plan.offsets[t] < plan.offsets[s] + sizes[s]
                       and plan.offsets[s] < plan.offsets[t] + sizes[t])
            assert not overlap or (one_step and (s - t) % 2 == 0 and plan.clear >> s & 1)
    assert plan.smem_bytes == 4 * (plan.ws_off + fch.STAGES * plan.ws_slot)
    assert plan.ws_slot == max(fch.slot_floats(c) for c in chans[1:])
    rows, cols = np.zeros(h, int), np.zeros(w, int)
    for o0 in range(0, h, plan.strip):
        spans = fch.stage_spans(o0, min(h, o0 + plan.strip), n, h)
        rows[spans[n][0]:spans[n][1]] += 1
        for s in range(n):  # each layer's rows read one row around them, all stored
            lo, hi = spans[s]
            assert (lo, hi) == (max(-1, spans[s + 1][0] - 1), min(h + 1, spans[s + 1][1] + 1))
            assert plan.rows[s] == min(plan.rs + 2, hi - lo) or plan.rows[s] > hi - lo - 1
    for x0 in range(0, w, plan.panel):
        spans = fch.stage_spans(x0, min(w, x0 + plan.panel), n, w)
        cols[spans[n][0]:spans[n][1]] += 1
        assert all(hi - lo <= plan.cols[s] for s, (lo, hi) in enumerate(spans[:n]))
    assert (rows == 1).all() and (cols == 1).all()  # every output row and column in one block
    assert plan.panel == w  # full rows at every canonical shape
    if h == 8 and b >= fch.SMS:  # the encoder tails: one block holds the whole image
        assert (plan.strip, plan.panel) == (8, 8)
    if h == 64 and b >= fch.SMS:  # the decoder tails: whole images, 128 pixels a step
        assert (plan.strip, plan.rs) == (64, 2)


def test_row_schedule_lags_one_row_and_ends():
    """fch.advance from every start a block takes: each stage lags its input
    by at most one row (so a ring of rs + 2 rows holds what a layer reads),
    takes at most rs rows a step, and every stage reaches its end."""
    for h, strip, n, rs in [(64, 64, 4, 2), (64, 8, 4, 2), (8, 1, 4, 9), (19, 5, 2, 1),
                            (8, 8, 4, 6), (37, 37, 4, 6)]:
        for o0 in range(0, h, strip):
            spans = fch.stage_spans(o0, min(h, o0 + strip), n, h)
            nxt, hi = [lo for lo, _ in spans], [e for _, e in spans]
            for _ in range(10 * h):
                if nxt[n] == hi[n]:
                    break
                new = fch.advance(nxt, hi, rs)
                for s in range(n + 1):
                    assert nxt[s] <= new[s] <= min(hi[s], nxt[s] + rs)
                    if s and new[s] > nxt[s]:  # its input rows are stored
                        assert new[s] <= new[s - 1] - 1 or new[s - 1] == hi[s - 1]
                        assert new[s - 1] - new[s] <= 1 or new[s] == hi[s]
                nxt = new
            assert nxt == hi


def test_pixel_stride_separates_banks():
    """An A fragment read (8 neighbouring pixels x 4 channels, at a0 and at
    a2 four channels on) and a B fragment read (4 k rows x 8 columns of a
    weight slot) each fall on 32 distinct banks."""
    for c in (1, 3, 4, 5, 13, 16, 40, 53, 64, 106, 128, 212, 424):
        p = fch.pixel_stride(c)
        assert p % 4 == 0 and p >= fch.c8(c) >= c and (p // 4) % 2 == 1
        for c0 in range(0, fch.c8(c), 8):
            for extra in (0, 4):
                banks = {(g * p + c0 + extra + t) % 32 for g in range(8) for t in range(4)}
                assert len(banks) == 32
    for _, bn, _, _, _ in fch.LAYER_TILES:
        ld = fch.b_ld(bn)
        assert len({(t * ld + g) % 32 for t in range(4) for g in range(8)}) == 32


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
        fch.plan_chain(1, 8, 8, (4000, 4000, 4))


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


def test_tail_chain_steps_aside_on_a_bf16_model(chain_calls):
    """The chain is float32 only (ROADMAP A.3.2c): a bfloat16 model's eval
    tails never chain, chain switched on or not, and each runs as four
    bfloat16 #1 calls, each rounded to bfloat16. That is the function the
    JAX chain computes in bfloat16 (``_kernel3_chain`` rounds every layer to
    ``x.dtype``): held against the JAX chain in bfloat16 in interpret mode by
    the noise rule of ``tests/test_torch_port_bf16.py`` (the JAX chain also
    rounds each bias to bfloat16; the port's kernel adds it in float32), and
    against four bfloat16 #1 calls on the plain path, bit for bit."""
    m = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS), dtype=torch.bfloat16).init_weights(3)
    m.eval()
    tblocks.use_chain(m)
    with torch.no_grad():
        out = m(*_forward_inputs(m, 2, seed=9))
    assert not chain_calls and all(o.dtype == torch.float32 for o in out)
    convs = (m.dx_conv1, m.dx_conv2, m.dx_conv3, m.dx_conv4)
    rng = np.random.default_rng(10)
    h = torch.from_numpy(rng.standard_normal((2, PS, PS, 64)).astype(np.float32)).bfloat16()
    assert tblocks.tail_chain(m, convs, h) is None
    with torch.no_grad():
        got = tblocks.conv_tail(m, convs, h)
        want = h
        for conv in convs:
            want = fc.conv3x3_plain(want, conv.kernel.bfloat16(), conv.unit_scale, conv.bias,
                                    False)
    assert not chain_calls and got.dtype == torch.bfloat16 and torch.equal(got, want)
    ks = [jnp.asarray(c.kernel.detach().numpy()) for c in convs]
    bs = [jnp.asarray(c.bias.detach().numpy()) for c in convs]
    hj = jnp.asarray(h.float().numpy())
    jb = pc.fused_conv3x3_chain(hj.astype(jnp.bfloat16), ks, bs, interpret=True)
    jf = pc.fused_conv3x3_chain(hj, ks, bs, interpret=True)
    assert jb.dtype == jnp.bfloat16
    jb, jf = np.asarray(jb.astype(jnp.float32)), np.asarray(jf)
    err = float(np.abs(got.float().numpy() - jb).max())
    assert err <= 2 * float(np.abs(jb - jf).max()) + 1e-3
    # the float32 model with the same weights still chains
    m32 = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS)).init_weights(3).eval()
    tblocks.use_chain(m32)
    with torch.no_grad():
        assert tblocks.tail_chain(m32, (m32.dx_conv1, m32.dx_conv2, m32.dx_conv3, m32.dx_conv4),
                                  h.float()) is not None
