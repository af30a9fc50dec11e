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

The bfloat16 chain is JAX #3's function on bfloat16 operands (each bias
rounded to bfloat16 before the add, each layer rounded to bfloat16): its
bias rounding is pinned bit for bit against #3 in interpret mode, ragged
chains are held against #3 and #4 in bfloat16 by the noise rule of
``tests/test_torch_port_bf16.py``, and the bfloat16 kernel's launch is
replayed (``ldmatrix`` lanes, m16n8k16 fragments) within one bfloat16 ulp
at the element plus 1e-4 of max|plain| (``fused_conv.compare_bf16``).
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


def _bf16(a):
    """``a`` rounded to bfloat16 (nearest, ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _ldmatrix(smem, addr, trans=False):
    """``ldmatrix.x4`` (``.x2`` for 16 addresses) as the hardware runs it:
    lane ``8 i + j`` gives the address of row ``j`` of 8x8 matrix ``i`` (8
    contiguous bfloat16 from a 16-byte aligned address); each lane ``t``
    receives, of every matrix, row ``t // 4``, elements ``2 (t % 4)`` and
    ``2 (t % 4) + 1`` (with ``trans``, of the transpose). ``addr`` (..., L)
    for L = 32 or 16 lanes; returns (..., matrices, 32 lanes, 2)."""
    assert (addr % 8 == 0).all()  # 16-byte aligned rows
    rows = smem[addr[..., None] + np.arange(8)]  # (..., L, 8)
    mats = rows.reshape(addr.shape[:-1] + (addr.shape[-1] // 8, 8, 8))
    if trans:
        mats = np.swapaxes(mats, -1, -2)
    t = np.arange(32)
    return mats[..., (t >> 2)[:, None], (2 * (t & 3))[:, None] + np.arange(2)]


def _replay(x, ks, bs, plan=None, itemsize=4):
    """``csrc/conv_chain.cu`` replayed in numpy, block by block: the plan,
    the strips and panels with their stage spans, the row schedule
    (``fch.advance``), the ring slots, the stage-0 loads and zero border
    rows, and per layer step the m and n tiles, the weight ring's slots and
    each lane's fragment offsets into the rings (vectorised over warps and
    lanes): in float32 (``itemsize`` 4) the m16n8k8 fragments with the
    3xTF32 products and a rounded add per 8-deep k group; in bfloat16 (2,
    ``x`` and ``ks`` bfloat16 values held as float32) the ``ldmatrix``
    addresses each lane gives, the registers ``ldmatrix`` hands each lane
    and where the m16n8k16 fragments place them, the products summed over
    four 16-deep k groups and added with one rounded add, and the
    epilogue's bias rounded to bfloat16 and the layer rounded to bfloat16. Shared
    memory is NaN where the kernel does not zero it, so a read of a weight
    cell no copy wrote shows; every ring slot carries the row it holds, so a
    read of a row that was overwritten, or a store over a row a layer still
    reads, fails. Returns (output, writes per output element)."""
    b, h, w, c0 = x.shape
    chans = (c0,) + tuple(k.shape[-1] for k in ks)
    n = len(ks)
    bf = itemsize == 2
    vec = 16 // itemsize  # elements in one 16-byte copy
    kg = 16 if bf else 8  # k group depth
    plan = plan or fch.plan_chain(b, h, w, chans, itemsize)
    assert plan.smem_bytes <= fch.SMEM_BYTES
    pstride = [fch.pixel_stride(c, itemsize) for c in chans]
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
        smem = np.full(plan.smem_bytes // itemsize, np.nan, np.float32)
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
            bm, bn, wm_t, wn_t, _ = fch.LAYER_TILES[fch.layer_tile(cout)]
            ks_ = fch.slot_rows(cout, itemsize)
            warps_m, warps_n, mi_n, ni_n = bm // wm_t, bn // wn_t, wm_t // 16, wn_t // 8
            assert warps_m * warps_n == fch.NT // 32
            b_ld = fch.b_ld(bn)
            wslot = plan.ws_slot
            assert ks_ * b_ld == fch.slot_size(cout, itemsize) <= wslot
            kt, n8 = fch.k_per_tap(cin, itemsize), fch.c8(cout)
            k_all = 9 * kt
            pin, q_in = pstride[l], plan.rows[l]
            in_row = plan.cols[l] * pin
            last = l == n - 1
            xin_lo, xout_lo = cspan[l][0], cspan[l + 1][0]
            cx0 = max(0, xout_lo)
            cw = min(w, cspan[l + 1][1]) - cx0
            m_all = (rb - ra) * cw
            wflat = ks[l].reshape(9 * cin, cout)
            nq_n = bn // vec
            bias = _bf16(bs[l]) if bf else bs[l]
            wm_i, wn_i = np.arange(warps_m), np.arange(warps_n)
            mi_i, h_i = np.arange(mi_n), np.arange(2)
            for m0 in range(0, m_all, bm):
                # the epilogue's fragment pixels, and in bfloat16 the pixel each
                # lane addresses for ldmatrix: (WM, MI, 2, 32) and (WM, MI, 32)
                m = (m0 + wm_i[:, None, None, None] * wm_t + mi_i[None, :, None, None] * 16
                     + gq[None, None, None, :] + 8 * h_i[None, None, :, None])
                mm = np.where(m < m_all, m, m0)
                frow, fcol = ra + mm // cw, cx0 + mm % cw
                m_l = (m0 + wm_i[:, None, None] * wm_t + mi_i[None, :, None] * 16
                       + (lane & 15)[None, None, :])
                mm_l = np.where(m_l < m_all, m_l, m0)
                lrow, lcol = ra + mm_l // cw, cx0 + mm_l % cw
                for n0 in range(0, n8, bn):
                    live = ((m0 + wm_i * wm_t < m_all)[:, None]
                            & (n0 + wn_i * wn_t < n8)[None, :])  # (WM, WN)

                    def load_slot(slot, k0):
                        base = plan.ws_off + slot * wslot
                        smem[base:base + wslot] = np.nan
                        e = np.arange(ks_ * nq_n)
                        kk, nq = e // nq_n, e % nq_n
                        kr, nn = k0 + kk, n0 + vec * nq
                        t, c = kr // kt, kr % kt
                        kv = (kr < k_all) & (c < cin)
                        for q in range(vec):
                            v = kv & (nn + q < cout)
                            smem[base + kk * b_ld + vec * nq + q] = np.where(
                                v, wflat[np.where(v, t * cin + c, 0), np.where(v, nn + q, 0)],
                                np.float32(0))

                    def products_f32(slot, kk, ky, kx, c0_):
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
                        bs_base = (plan.ws_off + slot * wslot + (tq * b_ld)[None, :]
                                   + (wn_i * wn_t)[:, None] + gq[None, :])
                        bp = bs_base[:, None, :] + kk * b_ld + (np.arange(ni_n) * 8)[None, :, None]
                        b_hw = np.full((warps_n, ni_n, 8, 8), np.nan, np.float32)
                        b_hw[:, :, tq, gq] = smem[bp]
                        b_hw[:, :, tq + 4, gq] = smem[bp + 4 * b_ld]
                        (ah, al), (bh, bl) = _split(a_hw), _split(b_hw)
                        return sum(np.einsum("amik,bnkj->abmnij", p_.astype(np.float64),
                                             q_.astype(np.float64))
                                   for p_, q_ in ((al, bh), (ah, bl), (ah, bh)))

                    def products_bf16(slot, kk, ky, kx, c0_):
                        yy = lrow + ky - 1  # the input row each ldmatrix lane reads
                        ok = m_l < m_all
                        assert (held[l][(yy[ok] + 1) % q_in] == yy[ok]).all()
                        # A: lane l gives pixel l & 15 of its fragment, k half l >> 4
                        addr = (plan.offsets[l] + ((lrow + ky) % q_in) * in_row
                                + (lcol - 1 - xin_lo) * pin + 8 * (lane >> 4) + kx * pin + c0_)
                        regs = _ldmatrix(smem, addr)  # (WM, MI, 4, 32, 2)
                        a_hw = np.full((warps_m, mi_n, 16, 16), np.nan, np.float32)
                        for i, (ro, ko) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                            a_hw[:, :, (gq + ro)[:, None], (2 * tq + ko)[:, None] + np.arange(2)] \
                                = regs[:, :, i]
                        # B: ldmatrix.x4.trans on pairs of n tiles (.x2 for one)
                        b_lane = (plan.ws_off + slot * wslot + ((lane & 15) * b_ld)[None, :]
                                  + (wn_i * wn_t)[:, None] + (8 * (lane >> 4))[None, :] + kk * b_ld)
                        b_hw = np.full((warps_n, ni_n, 16, 8), np.nan, np.float32)
                        if ni_n == 1:
                            r = _ldmatrix(smem, b_lane[:, :16], trans=True)  # (WN, 2, 32, 2)
                            tiles = [(0, 0, 0), (0, 1, 8)]
                        else:
                            r = _ldmatrix(smem, b_lane[:, None, :]
                                          + (np.arange(0, ni_n, 2) * 8)[None, :, None], trans=True)
                            tiles = [(ni + j, 4 * (ni // 2) + 2 * j + kh, 8 * kh)
                                     for ni in range(0, ni_n, 2) for j in (0, 1) for kh in (0, 1)]
                            r = r.reshape(warps_n, -1, 32, 2)
                        for ni, reg, ko in tiles:
                            b_hw[:, ni, (2 * tq + ko)[:, None] + np.arange(2), gq[:, None]] = \
                                r[:, reg]
                        return np.einsum("amik,bnkj->abmnij", a_hw.astype(np.float64),
                                         b_hw.astype(np.float64))

                    acc = np.zeros((warps_m, warps_n, mi_n, ni_n, 32, 4), np.float32)
                    nsteps = -(-k_all // ks_)
                    for st in range(fch.STAGES - 1):
                        if st < nsteps:
                            load_slot(st, st * ks_)
                    for step in range(nsteps):
                        if step + fch.STAGES - 1 < nsteps:
                            load_slot((step + fch.STAGES - 1) % fch.STAGES,
                                      (step + fch.STAGES - 1) * ks_)
                        slot = step % fch.STAGES
                        # the tap and first channel of the slot's first k group
                        g0 = step * (ks_ // kg)
                        t0 = g0 // (kt // kg)
                        c0_, ky, kx = (g0 - t0 * (kt // kg)) * kg, t0 // 3, t0 % 3
                        # bfloat16: four groups a rounded add in a whole slot, one
                        # in the slot that ends K; float32: one
                        part_n = 4 if bf and (step + 1) * ks_ <= k_all else 1
                        part = 0.0
                        for j, kk in enumerate(range(0, ks_, kg)):
                            if step * ks_ + kk >= k_all:
                                break
                            d = (products_bf16 if bf else products_f32)(slot, kk, ky, kx, c0_)
                            part = part + np.stack(
                                [d[..., gq, 2 * tq], d[..., gq, 2 * tq + 1],
                                 d[..., gq + 8, 2 * tq], d[..., gq + 8, 2 * tq + 1]], -1)
                            if (j + 1) % part_n == 0:
                                acc = np.where(live[:, :, None, None, None, None],
                                               (acc + part.astype(np.float32)).astype(np.float32),
                                               acc)
                                part = 0.0
                            c0_ += kg
                            if c0_ == kt:
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
                                            bcol = np.where(col < cout,
                                                            bias[np.minimum(col, cout - 1)],
                                                            np.float32(0))
                                            val = acc[wmi, wni, mi, ni, :, reg] + bcol
                                            if bf:
                                                val = _bf16(val)
                                            sel = (mv < m_all) & (nv < n8)
                                            if last:
                                                sel = sel & (col < cout)
                                                dst = ((bb * h + y) * w + xc) * cout + col
                                                out[dst[sel]] = val[sel]
                                                np.add.at(writes, dst[sel], 1)
                                            else:
                                                dst = (ring_row(l + 1, y) + (xc - xout_lo)
                                                       * pstride[l + 1] + col)
                                                if bf:  # a pair at an even element
                                                    assert (dst[sel & (col % 2 == 0)] % 2 == 0).all()
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


def _replay_case(case, itemsize):
    """(replay output, writes, plain output) of a replay case in float32
    (``itemsize`` 4) or bfloat16 (2: x and the kernels rounded to bfloat16,
    the plain version on bfloat16 tensors)."""
    shape, widths, forced = REPLAY_CASES[case]
    x, ks, bs = _chain_case(seed=len(case), b=shape[0], h=shape[1], w=shape[2],
                            chans=(shape[3],) + widths)
    chans = (shape[3],) + widths
    plan = fch.chain_layout(shape[1], shape[2], chans, *forced, itemsize) if forced else None
    if case == "one_image_several_strips_planned":
        assert fch.plan_chain(*shape[:3], chans, itemsize).strips > 1
    if case == "one_step_shared_rings":  # stage 2 over stage 0, at another pixel stride
        p = fch.plan_chain(*shape[:3], chans, itemsize)
        assert p.offsets[2] == p.offsets[0] and p.clear == 4 and p.rs >= shape[1] + 2
    if itemsize == 2:
        x, ks = _bf16(x), [_bf16(k) for k in ks]
        t = torch.from_numpy
        want = fch.conv3x3_chain_plain(t(x).bfloat16(), [t(k).bfloat16() for k in ks],
                                       [t(b) for b in bs]).float().numpy()
    else:
        want = _plain(x, ks, bs)
    got, writes = _replay(x, ks, bs, plan, itemsize)
    return got, writes, want


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_chain_kernel_index_arithmetic_matches_plain(case):
    got, writes, want = _replay_case(case, 4)
    assert (writes == 1).all()  # every output element once
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_bf16_chain_kernel_index_arithmetic_matches_plain(case):
    """The bfloat16 instance's launch: the same plan and schedule at
    bfloat16 strides, ldmatrix lanes and m16n8k16 fragments; within one
    bfloat16 ulp at the element plus 1e-4 of max|plain| (``compare_bf16``:
    each side rounds each layer once, from float32 sums in another order)."""
    got, writes, want = _replay_case(case, 2)
    assert (writes == 1).all()  # every output element once
    t = torch.from_numpy
    assert fc.compare_bf16(t(got).bfloat16(), t(want).bfloat16())["of_bound"] <= 1.0


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


def _plan_fits_and_covers(b, h, w, chans, itemsize):
    plan = fch.plan_chain(b, h, w, chans, itemsize)
    n = len(chans) - 1
    vec = 16 // itemsize
    assert plan.smem_bytes <= fch.SMEM_BYTES
    assert plan == fch.chain_layout(h, w, chans, plan.strip, plan.panel, plan.rs, itemsize)
    # the rings at 16-byte alignment, the weight ring after them; two stages
    # share memory only in a one-step plan, and then only stages s and s + 2
    sizes = [plan.rows[s] * plan.cols[s] * fch.pixel_stride(chans[s], itemsize)
             for s in range(n)]
    one_step = plan.rs >= max(hi - lo for lo, hi in (
        fch.stage_spans(o0, min(h, o0 + plan.strip), n, h)[0] for o0 in range(0, h, plan.strip)))
    for s in range(n):
        assert plan.offsets[s] % vec == 0 and plan.offsets[s] + sizes[s] <= plan.ws_off
        for t in range(s):
            overlap = (plan.offsets[t] < plan.offsets[s] + sizes[s]
                       and plan.offsets[s] < plan.offsets[t] + sizes[t])
            assert not overlap or (one_step and (s - t) % 2 == 0 and plan.clear >> s & 1)
    assert plan.ws_off % vec == 0 and plan.ws_slot % vec == 0
    assert plan.smem_bytes == itemsize * (plan.ws_off + fch.STAGES * plan.ws_slot)
    assert plan.ws_slot == max(fch.slot_size(c, itemsize) for c in chans[1:])
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
    return plan


@pytest.mark.parametrize("b,h,w,chans", PLAN_CASES)
def test_plan_chain_fits_and_covers(b, h, w, chans):
    _plan_fits_and_covers(b, h, w, chans, 4)


@pytest.mark.parametrize("b,h,w,chans", PLAN_CASES)
def test_bf16_plan_chain_fits_and_covers(b, h, w, chans):
    """The same at bfloat16 strides (half the ring bytes: at least as many
    rows a step as float32 in the same shared memory)."""
    plan = _plan_fits_and_covers(b, h, w, chans, 2)
    assert plan.smem_bytes <= fch.plan_chain(b, h, w, chans).smem_bytes or (
        plan.rs > fch.plan_chain(b, h, w, chans).rs)


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


def test_bf16_pixel_stride_separates_bank_groups():
    """bfloat16: the 8 rows of an ldmatrix phase are 16 bytes each, 16-byte
    aligned, and fall on the 8 distinct 16-byte groups of the 32 banks: 8
    neighbouring pixels of a ring row at any 16-channel group (the A
    fragments), and 8 consecutive k rows of a weight slot (B, .trans). A
    tap's K is padded to 16 channels, so every 16-deep group lies in one tap."""
    for c in (1, 3, 4, 5, 13, 16, 40, 53, 64, 106, 128, 212, 424):
        p = fch.pixel_stride(c, 2)
        assert fch.k_per_tap(c, 2) == fch.c16(c) >= c and fch.c16(c) % 16 == 0
        assert p % 8 == 0 and p >= fch.c16(c) + 8 and (p // 8) % 2 == 1
        for c0 in range(0, fch.c16(c), 8):
            groups = {(g * p + c0) // 8 % 8 for g in range(8)}
            assert len(groups) == 8
    for _, bn, _, _, _ in fch.LAYER_TILES:
        ld = fch.b_ld(bn)
        assert ld % 8 == 0 and len({(t * ld) // 8 % 8 for t in range(8)}) == 8
    for cout in (4, 16, 64, 106, 424):  # the same slot bytes, twice the rows
        assert fch.slot_rows(cout, 2) == 2 * fch.slot_rows(cout) and fch.slot_rows(cout, 2) % 64 == 0
        assert 2 * fch.slot_size(cout, 2) == 4 * fch.slot_size(cout)


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
    # bfloat16: x and the kernels of one dtype, the biases float32
    with pytest.raises(TypeError, match="kernels"):
        fch.fused_conv3x3_chain(tx.detach().bfloat16(), tks, tbs)
    with pytest.raises(TypeError, match="biases"):
        fch.fused_conv3x3_chain(tx.detach().bfloat16(), [k.bfloat16() for k in tks],
                                [b.bfloat16() for b in tbs])


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


def _defers_to_int8_weights(model, chain_calls, dtype):
    """A model that carries any int8 weight chains no tail, as the JAX
    ``tail_chain`` steps aside on a model with a ``quant`` collection: the
    W8A8 decoder keeps its int8 kernels and the float ``ey`` tail runs layer
    by layer (in bfloat16 that adds each bias in float32, where the chain
    rounds it to bfloat16 first). One int8 conv anywhere in the model is
    enough."""
    import copy

    m = copy.deepcopy(model)
    tblocks.set_dtype(m, dtype)
    qz.attach_quant(m, qz.quantize_params_tree(m, seed=0))
    tblocks.use_chain(m)
    y, eps_u, eps_z = _forward_inputs(m, 2, seed=7)[1:]
    with torch.no_grad():
        got = m.conditional_generation_eps(y, eps_u, eps_z)
        assert chain_calls == []
        tblocks.use_chain(m, False)
        want = m.conditional_generation_eps(y, eps_u, eps_z)
    assert torch.equal(got, want)
    # one int8 conv among the model's is enough: no tail chains, dy's included
    m2 = copy.deepcopy(model)
    tblocks.set_dtype(m2, dtype)
    tblocks.use_chain(m2)
    with torch.no_grad():
        m2.decode_y(torch.zeros(1, 2, 2, m2.config.u_channels))
    assert [c[1] for c in chain_calls] == [(64, 16, 16, 4)]  # chained without int8
    q, sc = qz.quantize_rtn(m2.dx_conv3.kernel.detach())
    m2.dx_conv3.set_quant(q, sc)
    assert tblocks.has_int8(m2) and not tblocks.has_int8(model)
    chain_calls.clear()
    with torch.no_grad():
        m2.decode_y(torch.zeros(1, 2, 2, m2.config.u_channels))
        m2.decode_x_from_features(torch.zeros(1, 2, 2, m2.config.z_channels),
                                  torch.zeros(1, 1, 1, m2.config.latent_size // 16))
    assert chain_calls == []


def test_tail_chain_defers_to_int8_weights(model, chain_calls):
    _defers_to_int8_weights(model, chain_calls, torch.float32)


def test_bf16_tail_chain_defers_to_int8_weights(model, chain_calls):
    _defers_to_int8_weights(model, chain_calls, torch.bfloat16)


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
    """A bfloat16 model does not step aside: it chains its eval tails like a
    float32 one, and each tail is JAX #3's bfloat16 function
    (``fused_conv3x3_chain`` on ``h.astype(bf16)``): the port's
    chain on the bfloat16 tail equals its plain version bit for bit on the
    CPU, is held against the JAX chain in bfloat16 in interpret mode by the
    noise rule of ``tests/test_torch_port_bf16.py``, and differs from the
    four bfloat16 #1 calls it replaces only where #3 rounds a bias to
    bfloat16 and #1 adds it in float32."""
    m = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS), dtype=torch.bfloat16).init_weights(3)
    m.eval()
    tblocks.use_chain(m)
    with torch.no_grad():
        out = m(*_forward_inputs(m, 2, seed=9))
    assert all(o.dtype == torch.float32 for o in out)
    cfg = m.config
    assert sorted(c[1] for c in chain_calls) == sorted([
        (64, 128, 128, 2 * cfg.u_channels), (128, 128, 128, 2 * cfg.z_channels),
        (64, 16, 16, 4), (64, 16, 16, 4)])
    convs = (m.dx_conv1, m.dx_conv2, m.dx_conv3, m.dx_conv4)
    rng = np.random.default_rng(10)
    h = torch.from_numpy(rng.standard_normal((2, PS, PS, 64)).astype(np.float32)).bfloat16()
    ks_bf = [c.kernel.detach().bfloat16() for c in convs]
    bs32 = [c.bias.detach() for c in convs]
    with torch.no_grad():
        got = tblocks.tail_chain(m, convs, h)
        per_layer = h
        for conv in convs:
            per_layer = fc.conv3x3_plain(per_layer, conv.kernel.bfloat16(), conv.unit_scale,
                                         conv.bias, False)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fch.conv3x3_chain_plain(h, ks_bf, bs32))
    # the biases rounded to bfloat16 are what sets the chain apart from #1 calls
    with torch.no_grad():
        rounded = h
        for conv in convs:
            rounded = fc.conv3x3_plain(rounded, conv.kernel.bfloat16(), conv.unit_scale,
                                       conv.bias.bfloat16().float(), False)
    assert torch.equal(got, rounded)
    assert not all(torch.equal(b.bfloat16().float(), b) for b in bs32)
    ks = [jnp.asarray(c.kernel.detach().numpy()) for c in convs]
    bs = [jnp.asarray(c.bias.detach().numpy()) for c in convs]
    hj = jnp.asarray(h.float().numpy())
    jb = pc.fused_conv3x3_chain(hj.astype(jnp.bfloat16), ks, bs, interpret=True)
    jf = pc.fused_conv3x3_chain(hj, ks, bs, interpret=True)
    assert jb.dtype == jnp.bfloat16
    jb, jf = np.asarray(jb.astype(jnp.float32)), np.asarray(jf)
    err = float(np.abs(got.float().numpy() - jb).max())
    assert err <= 2 * float(np.abs(jb - jf).max()) + 1e-3
    assert float(np.abs(per_layer.float().numpy() - jb).max()) <= (
        2 * float(np.abs(jb - jf).max()) + 1e-3)


def test_bf16_chain_rounds_its_biases_as_jax_3_does():
    """JAX #3 (``fused_conv3x3_chain``) casts each bias to ``x.dtype``
    before it adds it; its reference off a TPU (``_chain_reference``) keeps
    it float32. A case where the two differ, bit for bit: x all ones, a
    kernel that is zero but for the centre tap of channel 0 (acc = 1.0
    exactly) and the bias 2^-8 + 2^-20. Rounded to bfloat16 first, the bias
    is 2^-8 and 1 + 2^-8 is a tie that rounds to the even 1.0; added in
    float32 it lifts the sum past the tie to 1 + 2^-7. The port's plain
    bfloat16 chain gives #3's bits, in interpret mode, at every pixel."""
    x = np.ones((1, 8, 8, 2), np.float32)
    k = np.zeros((3, 3, 2, 2), np.float32)
    k[1, 1, 0, 0] = 1.0
    b = np.array([2.0**-8 + 2.0**-20, 0.25], np.float32)
    want = pc.fused_conv3x3_chain(jnp.asarray(x).astype(jnp.bfloat16), (jnp.asarray(k),),
                                  (jnp.asarray(b),), interpret=True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert (want[..., 0] == 1.0).all()  # #3: the bias rounded first
    ref = np.asarray(pc._chain_reference(jnp.asarray(x).astype(jnp.bfloat16), (jnp.asarray(k),),
                                         (jnp.asarray(b),)).astype(jnp.float32))
    assert (ref[..., 0] == 1.0 + 2.0**-7).all()  # the float32 bias: another bit
    t = torch.from_numpy
    got = fch.fused_conv3x3_chain(t(x).bfloat16(), [t(k).bfloat16()], [t(b)])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # a chain of more layers (the zero kernel of a second layer passes its bias on)
    got2 = fch.fused_conv3x3_chain(t(x).bfloat16(), [t(k).bfloat16(), t(k).bfloat16()],
                                   [t(b), t(b)])
    want2 = pc.fused_conv3x3_chain(jnp.asarray(x).astype(jnp.bfloat16),
                                   (jnp.asarray(k), jnp.asarray(k)), (jnp.asarray(b),) * 2,
                                   interpret=True)
    np.testing.assert_array_equal(got2.float().numpy(), np.asarray(want2.astype(jnp.float32)))


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_bf16_chain_plain_matches_the_pallas_chain_in_bf16(case, monkeypatch):
    """The plain bfloat16 chain against JAX #3 and #4 in bfloat16 in
    interpret mode (#4 keeps its biases float32: within the same rule) by
    the noise rule: max|port - JAX bf16| <= 2 max|JAX bf16 - JAX f32| +
    1e-3, the two sides summing each layer in another order."""
    x, ks, bs = _chain_case(**JAX_CASES[case])
    chans = [x.shape[-1]] + [k.shape[-1] for k in ks]
    if case == "multi_strip":
        monkeypatch.setattr(pc, "_VMEM_BUDGET", 2_000_000)
        assert 0 < pc._chain_strip_rows(x.shape[1], x.shape[2], chans, 2) < x.shape[1]
    xb = _bf16(x)
    t = torch.from_numpy
    got = fch.fused_conv3x3_chain(t(xb).bfloat16(), [t(k).bfloat16() for k in ks],
                                  [t(b) for b in bs])
    assert got.dtype == torch.bfloat16
    jf = np.asarray(pc.fused_conv3x3_chain(jnp.asarray(xb), tuple(ks), tuple(bs),
                                           interpret=True))
    for kernel in (pc.fused_conv3x3_chain, pc.fused_conv3x3_chain_wl):
        jb = kernel(jnp.asarray(xb).astype(jnp.bfloat16), tuple(ks), tuple(bs), interpret=True)
        assert jb.dtype == jnp.bfloat16
        jb = np.asarray(jb.astype(jnp.float32))
        err = float(np.abs(got.float().numpy() - jb).max())
        assert err <= 2 * float(np.abs(jb - jf).max()) + 1e-3, (kernel.__name__, err)
