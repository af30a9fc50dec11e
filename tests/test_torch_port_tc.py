"""The tensor-core conv kernel (``conv_tc`` in ``csrc/fused_conv.cu``: the 3x3,
4x4/s2 and transposed 4x4/s2 kernels, 3xTF32 on ``mma.sync``) replayed on the
CPU.

The kernel itself runs only on the card (``tests/test_torch_port_gpu.py``).
Here its arithmetic is held against the plain versions: the TF32 split it
computes with ``cvt.rna.tf32.f32``, emulated bit for bit, keeps sums over K
up to 15,264 within the kernel tolerance of the float32 plain version
(1e-4 of max|plain|), where TF32 alone does not; and a numpy replay of its
index arithmetic (the launch plan, the tiles, K in the order tap * C + c in
32-deep steps through the cp.async ring, k / C by multiply-high, the
transposed conv's four output phases with their live taps and weight rows,
the zero-filled border and K tail, the 16-byte and 4-byte staging paths, the
m16n8k8 fragment maps, the epilogue and the ordered split-K sum over the
``[split][phase]`` workspace) computes every output element once
and agrees with the plain version (rtol 1e-4, atol 1e-5: float32 sums in
another order) at ragged shapes, with C % 4 != 0, at every tile
configuration. Inputs come from numpy seeds.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from simple_vae_rs_tpu.ops import pallas_conv as pc
from simple_vae_rs_tpu_torch.ops import fused_chain as fch
from simple_vae_rs_tpu_torch.ops import fused_conv as fc

RTOL, ATOL = 1e-4, 1e-5
KERNEL_TOL = 1e-4  # of max|plain|, the card's kernel check
SMEM_LIMIT = 232448  # bytes of shared memory one block may have on the H100 (227 KB)
SMS = 132


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round float32 to 10 mantissa bits, to nearest,
    ties away from zero (add half of the dropped 13 bits' range, cut them)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(a: torch.Tensor):
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def _np_split(a: np.ndarray):
    hi, lo = split_tf32(torch.from_numpy(np.ascontiguousarray(a, np.float32)))
    return hi.numpy(), lo.numpy()


def test_tf32_rounding_matches_the_instruction():
    # 1 + 2^-11 is halfway between two TF32 values: away from zero, both signs
    vals = torch.tensor([1.0, 1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 3 * 2**-11,
                         3.0e-39, 0.0, -2.5], dtype=torch.float32)
    got = tf32_rna(vals)
    want = torch.tensor([1.0, 1 + 2**-10, -(1 + 2**-10), 1.0, 1 + 2**-9, 0.0, 0.0, -2.5],
                        dtype=torch.float32)
    want[5] = tf32_rna(torch.tensor([3.0e-39]))[0]  # a subnormal keeps its top 10 bits
    assert torch.equal(got, want)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    assert torch.all((tf32_rna(x).view(torch.int32) & 0x1FFF) == 0)
    assert float(((tf32_rna(x) - x) / x).abs().max()) <= 2.0**-11


def test_3xtf32_product_error_is_below_2_to_minus_20():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal(100000).astype(np.float32) * 10)
    b = torch.from_numpy(rng.standard_normal(100000).astype(np.float32))
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    # each product of two TF32 values is exact in float32 (11 + 11 significant bits)
    assert torch.equal((ah * bl).double(), ah.double() * bl.double())
    three = al.double() * bh.double() + ah.double() * bl.double() + ah.double() * bh.double()
    exact = a.double() * b.double()
    assert float(((three - exact).abs() / exact.abs()).max()) <= 2.0**-20
    assert float(((ah.double() * bh.double() - exact).abs() / exact.abs()).max()) > 2.0**-12


@pytest.mark.parametrize("k", [36, 576, 2304, 15264])
def test_3xtf32_sums_over_k_stay_within_the_kernel_tolerance(k):
    """Sums as the kernel forms them (three TF32 products a k-step, float32
    accumulation) against the float64 sum: within the kernel tolerance of
    the float32 plain version's own error; TF32 alone is not, from K = 576."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(np.maximum(rng.standard_normal((16, k)), 0).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((k, 24)) / np.sqrt(k)).astype(np.float32))
    exact = a.double() @ b.double()
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    acc = torch.zeros((16, 24), dtype=torch.float32)
    tf32 = torch.zeros((16, 24), dtype=torch.float32)
    for k0 in range(0, k, 8):
        s = slice(k0, k0 + 8)
        acc = acc + al[:, s] @ bh[s]
        acc = acc + ah[:, s] @ bl[s]
        acc = acc + ah[:, s] @ bh[s]
        tf32 = tf32 + ah[:, s] @ bh[s]
    ref = float(exact.abs().max())
    plain_err = float(((a @ b).double() - exact).abs().max())
    err = float((acc.double() - exact).abs().max())
    assert err <= KERNEL_TOL * ref
    assert err <= 4 * plain_err + 1e-6 * ref
    if k >= 576:
        assert float((tf32.double() - exact).abs().max()) > KERNEL_TOL * ref


# ------------------------------------------------------------ the replay
def _cdiv(a, b):
    return -(-a // b)


def div_c_params(c):
    """``make_geo``'s constants for ``div_c`` (k / C by a multiply-high)."""
    l = max(c - 1, 0).bit_length()  # ceil(log2 C)
    if c <= 1:
        return 0, 0
    return ((1 << (31 + l)) + c - 1) // c, l - 1


def div_c(k, c):
    """``div_c``: ``umulhi(k, c_mul) >> c_shr`` in 32-bit unsigned arithmetic."""
    mul, shr = div_c_params(c)
    if c == 1:
        return np.asarray(k)
    k = np.asarray(k, np.uint64)
    return ((k * np.uint64(mul)) >> np.uint64(32 + shr)).astype(np.int64)


def test_div_c_is_exact_division():
    """The loaders' k / C for every k the kernels see (k < 16 * C, and more)
    at every C of the canonical model, odd and power-of-two C, and the
    largest k below 2**31."""
    rng = np.random.default_rng(5)
    cs = [1, 2, 3, 4, 5, 7, 16, 53, 64, 106, 128, 212, 256, 424, 848, 1696, 4096, 65535,
          2**20 + 3] + rng.integers(2, 1 << 16, 40).tolist()
    for c in cs:
        mul, shr = div_c_params(c)
        assert 0 <= mul < 2**32 and 0 <= shr < 32
        k = np.concatenate([np.arange(min(16 * c + 64, 1 << 18)),
                            rng.integers(0, 2**31, 4096), [2**31 - 1, 2**31 - c]])
        np.testing.assert_array_equal(div_c(k, c), k // c)


def _tap(mode, t, p):
    """tap_geometry: input offsets (relative to oy*stride, ox*stride) and the
    weight tap of GEMM tap ``t`` in phase ``p``."""
    if mode == "fused_conv3x3_bn_relu":
        return t // 3 - 1, t % 3 - 1, t
    if mode == "fused_conv4x4s2_bn_relu":
        return (t >> 2) - 1, (t & 3) - 1, t
    ta, tb, u, v = t >> 1, t & 1, p >> 1, p & 1  # the transposed conv's _T_TAPS
    return ta + u - 1, tb + v - 1, (2 * ta + u) * 4 + 2 * tb + v


def conv_tc_replay(name, x, kern, scale, shift, relu, cfg=None):
    """The kernel's launch replayed block by block in numpy, over
    ``blockIdx.z = phase * splits + split``. Shared memory is NaN before
    every load, so a read of a cell no copy wrote shows; writes to the output
    and to the ``[split][phase][M][O]`` workspace are counted. Returns
    (output, writes per output element)."""
    b, h, w, c = x.shape
    o = kern.shape[-1]
    stride = 2 if name == "fused_conv4x4s2_bn_relu" else 1
    m_all, _, k_all, phases = fc.geometry(name, torch.from_numpy(x), torch.from_numpy(kern))
    ho, wo = (h // 2, w // 2) if stride == 2 else (h, w)
    plan_cfg, splits, kchunk = fc.plan_tc(m_all, o, k_all, phases)
    cfg = plan_cfg if cfg is None else cfg
    bm, bn, wm_t, wn_t, stages = fc.TC_TILES[cfg]
    warps_m, warps_n = bm // wm_t, bn // wn_t
    nt = warps_m * warps_n * 32
    bk = fc.TC_BK
    kq_n, nq = bk // 4, bn // 4
    a_rows, b_vecs = bm * kq_n // nt, _cdiv(bk * nq, nt)
    a_ld, b_ld = bk + 4, bn + 8
    mi_n, ni_n = wm_t // 16, wn_t // 8
    assert fc.tc_smem_bytes(cfg) == 4 * stages * (bm * a_ld + bk * b_ld)
    xf, wf = x.reshape(-1), kern.reshape(-1)  # HWIO: row tap * C + c, column n
    vec_a, vec_b = c % 4 == 0, o % 4 == 0
    out_shape = fc.output_shape(name, x.shape, o)

    def out_offset(p, m, n):
        if phases == 1:
            return m * o + n
        bb, r = np.divmod(m, ho * wo)
        i, j = np.divmod(r, wo)
        return ((bb * 2 * ho + 2 * i + (p >> 1)) * 2 * wo + 2 * j + (p & 1)) * o + n

    def weight_row(kr, p):
        if phases == 1:
            return kr
        t = div_c(kr, c)
        return kr + (_tap(name, t, p)[2] - t) * c

    tid = np.arange(nt)
    kq = tid % kq_n
    rows = tid[:, None] // kq_n + np.arange(a_rows)[None, :] * (nt // kq_n)  # (nt, a_rows)
    lane = np.arange(32)
    gq, tq = lane >> 2, lane & 3
    out = np.full(int(np.prod(out_shape)), np.nan, np.float32)
    writes = np.zeros(out.size, np.int64)
    ws = np.full((splits, phases, m_all, o), np.nan, np.float32)
    ws_writes = np.zeros((splits, phases, m_all, o), np.int64)

    for bz in range(phases * splits):
        p, s = divmod(bz, splits)
        kbeg = s * kchunk
        kend = min(k_all, kbeg + kchunk)
        nsteps = _cdiv(kend - kbeg, bk) if kend > kbeg else 0
        for bx in range(_cdiv(m_all, bm)):
            m0 = bx * bm
            mm = m0 + rows
            valid_m = mm < m_all
            bb, r = np.divmod(mm, ho * wo)
            oy, ox = np.divmod(r, wo)
            a_y = np.where(valid_m, oy * stride, -(1 << 24))
            a_x = np.where(valid_m, ox * stride, 0)
            a_pix = np.where(valid_m, (bb * h + a_y) * w + a_x, 0)
            for by in range(_cdiv(o, bn)):
                n0 = by * bn
                a_sm = np.full((stages, bm * a_ld), np.nan, np.float32)
                b_sm = np.full((stages, bk * b_ld), np.nan, np.float32)

                def gather(v, idx):
                    return np.where(v, xf[np.where(v, idx, 0)], np.float32(0))

                def load(slot, k0):
                    a_sm[slot] = np.nan
                    b_sm[slot] = np.nan
                    dst = rows * a_ld + 4 * kq[:, None]
                    k = k0 + 4 * kq
                    if vec_a:  # one 16-byte copy: channels c .. c+3 of one tap
                        kv = k < kend
                        t = np.where(kv, div_c(k, c), 0)
                        cc = k - t * c
                        dy, dx, _ = _tap(name, t, p)
                        iy, ix = a_y + dy[:, None], a_x + dx[:, None]
                        v = kv[:, None] & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                        src = (a_pix + (dy * w + dx)[:, None]) * c + cc[:, None]
                        for j in range(4):
                            a_sm[slot, dst + j] = gather(v, src + j)
                    else:  # four 4-byte copies, each resolved on its own
                        for j in range(4):
                            kv = k + j < kend
                            t = np.where(kv, div_c(k + j, c), 0)
                            cc = k + j - t * c
                            dy, dx, _ = _tap(name, t, p)
                            iy, ix = a_y + dy[:, None], a_x + dx[:, None]
                            v = kv[:, None] & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                            src = (a_pix + (dy * w + dx)[:, None]) * c + cc[:, None]
                            a_sm[slot, dst + j] = gather(v, src)
                    b_dst = []
                    for jv in range(b_vecs):
                        e = tid + jv * nt
                        e = e[e < bk * nq]  # the last round may stage fewer groups
                        kk, nqi = np.divmod(e, nq)
                        kr, n = k0 + kk, n0 + 4 * nqi
                        kv = kr < kend
                        row = np.where(kv, weight_row(np.where(kv, kr, 0), p), 0) * o
                        for q in range(4):
                            v = kv & ((n < o) if vec_b else (n + q < o))
                            b_sm[slot, kk * b_ld + 4 * nqi + q] = np.where(
                                v, wf[np.where(v, row + n + q, 0)], np.float32(0))
                        b_dst.append(kk * b_ld + 4 * nqi)
                    # every cell of both tiles is written once; the pads are not
                    a_cells = (dst[..., None] + np.arange(4)).ravel()
                    b_cells = (np.concatenate(b_dst)[:, None] + np.arange(4)).ravel()
                    assert len(np.unique(a_cells)) == a_cells.size == bm * bk
                    assert len(np.unique(b_cells)) == b_cells.size == bk * bn
                    assert not np.isnan(a_sm[slot].reshape(bm, a_ld)[:, :bk]).any()
                    assert not np.isnan(b_sm[slot].reshape(bk, b_ld)[:, :bn]).any()

                acc = np.zeros((warps_m, warps_n, mi_n, ni_n, 32, 4), np.float32)
                for st in range(stages - 1):
                    if st < nsteps:
                        load(st, kbeg + st * bk)
                for step in range(nsteps):
                    nxt = step + stages - 1
                    if nxt < nsteps:
                        load(nxt % stages, kbeg + nxt * bk)
                    a_s, b_s = a_sm[step % stages], b_sm[step % stages]
                    for kk in range(0, bk, 8):
                        for wmi in range(warps_m):
                            for wni in range(warps_n):
                                ap = ((wmi * wm_t + gq) * a_ld + tq)[None, :] \
                                    + (np.arange(mi_n) * 16 * a_ld)[:, None] + kk
                                bp = (tq * b_ld + wni * wn_t + gq)[None, :] \
                                    + kk * b_ld + (np.arange(ni_n) * 8)[:, None]
                                # the registers each lane reads, placed where the
                                # m16n8k8 .tf32 fragment layout says they sit
                                a_hw = np.full((mi_n, 16, 8), np.nan, np.float32)
                                a_hw[:, gq, tq] = a_s[ap]
                                a_hw[:, gq + 8, tq] = a_s[ap + 8 * a_ld]
                                a_hw[:, gq, tq + 4] = a_s[ap + 4]
                                a_hw[:, gq + 8, tq + 4] = a_s[ap + 8 * a_ld + 4]
                                b_hw = np.full((ni_n, 8, 8), np.nan, np.float32)
                                b_hw[:, tq, gq] = b_s[bp]
                                b_hw[:, tq + 4, gq] = b_s[bp + 4 * b_ld]
                                (ah, al), (bh, bl) = _np_split(a_hw), _np_split(b_hw)
                                d = sum(np.einsum("mik,nkj->mnij", p_.astype(np.float64),
                                                  q_.astype(np.float64))
                                        for p_, q_ in ((al, bh), (ah, bl), (ah, bh)))
                                regs = np.stack([d[:, :, gq, 2 * tq], d[:, :, gq, 2 * tq + 1],
                                                 d[:, :, gq + 8, 2 * tq],
                                                 d[:, :, gq + 8, 2 * tq + 1]], -1)
                                acc[wmi, wni] = (acc[wmi, wni] + regs).astype(np.float32)
                # epilogue: the row of pixel m, then its columns
                for wmi in range(warps_m):
                    for wni in range(warps_n):
                        for mi in range(mi_n):
                            for hh in range(2):
                                m = m0 + wmi * wm_t + mi * 16 + gq + 8 * hh
                                for ni in range(ni_n):
                                    n = n0 + wni * wn_t + ni * 8 + 2 * tq
                                    for col, reg in ((n, 2 * hh), (n + 1, 2 * hh + 1)):
                                        ok = (m < m_all) & (n < o) & (col < o)
                                        val = acc[wmi, wni, mi, ni, :, reg][ok]
                                        mo, co = m[ok], col[ok]
                                        if splits == 1:
                                            y = val * scale[co] + shift[co]
                                            dst = out_offset(p, mo, co)
                                            out[dst] = np.maximum(y, 0) if relu else y
                                            np.add.at(writes, dst, 1)
                                        else:
                                            ws[s, p, mo, co] = val
                                            np.add.at(ws_writes, (s, p, mo, co), 1)
    if splits > 1:  # splitk_reduce: partials in split order, then the epilogue
        assert (ws_writes == 1).all()
        tot = np.zeros((phases, m_all, o), np.float32)
        for s in range(splits):
            tot = (tot + ws[s]).astype(np.float32)
        y = tot * scale + shift
        y = np.maximum(y, 0) if relu else y
        pp, mm, nn = np.meshgrid(np.arange(phases), np.arange(m_all), np.arange(o),
                                 indexing="ij")
        dst = out_offset(pp, mm, nn).ravel()
        out[dst] = y.ravel()
        np.add.at(writes, dst, 1)
    return out.reshape(out_shape), writes.reshape(out_shape)


def _data(shape, o, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    kern = (rng.standard_normal((k, k, shape[-1], o)) / np.sqrt(k * k * shape[-1])).astype(
        np.float32)
    scale = rng.uniform(0.5, 1.5, o).astype(np.float32)
    shift = rng.standard_normal(o).astype(np.float32)
    return x, kern, scale, shift


# (name, x shape, O, relu, tile config the plan picks): C % 4 != 0 (3, 5, 7,
# 53, 106) on the 4-byte path, N = 4 and 53 (an n8 tile wholly past N, ragged
# weight slices), odd O, M <= 64 (per phase) with a K split and K not a
# multiple of 32, and every tile configuration, for each of the three convs
REPLAY_CASES = [
    ("fused_conv3x3_bn_relu", (3, 5, 7, 5), 13, True, 2),
    ("fused_conv3x3_bn_relu", (2, 9, 11, 4), 3, False, 2),
    ("fused_conv3x3_bn_relu", (2, 8, 8, 16), 4, True, 2),
    ("fused_conv3x3_bn_relu", (2, 6, 6, 53), 53, False, 1),
    ("fused_conv3x3_bn_relu", (1, 9, 9, 8), 72, True, 0),
    ("fused_conv3x3_bn_relu", (1, 4, 4, 212), 96, False, 3),
    ("fused_conv4x4s2_bn_relu", (3, 10, 12, 7), 9, True, 2),
    ("fused_conv4x4s2_bn_relu", (2, 16, 16, 12), 53, False, 1),
    ("fused_conv4x4s2_bn_relu", (1, 8, 8, 53), 40, True, 3),
    ("fused_convT4x4s2_bn_relu", (2, 6, 5, 53), 9, True, 3),
    ("fused_convT4x4s2_bn_relu", (2, 6, 6, 53), 24, False, 1),
    ("fused_convT4x4s2_bn_relu", (2, 8, 8, 16), 4, True, 2),
    ("fused_convT4x4s2_bn_relu", (2, 6, 7, 12), 53, False, 1),
    ("fused_convT4x4s2_bn_relu", (1, 9, 9, 8), 72, True, 0),
    ("fused_convT4x4s2_bn_relu", (1, 4, 4, 64), 24, False, 3),
    ("fused_convT4x4s2_bn_relu", (1, 3, 4, 106), 13, True, 3),
]
_REFERENCE = {"fused_conv3x3_bn_relu": pc._reference3, "fused_conv4x4s2_bn_relu": pc._reference4,
              "fused_convT4x4s2_bn_relu": pc._referenceT}


@pytest.mark.parametrize("case", REPLAY_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_conv_tc_index_arithmetic_matches_plain(case):
    name, shape, o, relu, cfg = case
    x, kern, s, t = _data(shape, o, 4 if "4x4" in name else 3, seed=sum(shape) + o)
    m, n, k, phases = fc.geometry(name, torch.from_numpy(x), torch.from_numpy(kern))
    assert fc.plan_tc(m, n, k, phases)[0] == cfg
    got, writes = conv_tc_replay(name, x, kern, s, t, relu)
    assert (writes == 1).all()  # every output element once
    want = fc.PLAIN[name](*map(torch.from_numpy, (x, kern, s, t)), relu).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # and the JAX package's reference of the same function
    ref = _REFERENCE[name](x, kern, s, t, relu)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_conv_tc_replay_splits_k_when_few_pixels():
    # the K-split case above really splits, and its K is not a multiple of 32
    m, n, k = 16, 96, 9 * 212
    cfg, splits, kchunk = fc.plan_tc(m, n, k)
    assert cfg == 3 and splits > 1 and k % fc.TC_BK != 0


@pytest.mark.parametrize("m,n,k", [(16, 24, 4 * 64), (12, 13, 4 * 106)])
def test_conv_tc_replay_splits_k_per_phase(m, n, k):
    # the transposed conv's K-split cases above: M <= 64 pixels per phase,
    # four phases of blocks, and the C = 106 one with K not a multiple of 32
    cfg, splits, kchunk = fc.plan_tc(m, n, k, phases=4)
    assert cfg == 3 and splits > 1 and (splits - 1) * kchunk < k <= splits * kchunk
    assert fc.plan_tc(m, n, k, phases=4)[1] <= fc.plan_tc(m, n, k)[1]


# the canonical Cond_SRVAE (cr=1.2, ps=64): every conv geometry of #1, #5 and
# #6 per image, forward and input-gradient roles, as (kernel, H, W, C, O) of
# the kernel's own input
_CANONICAL = [
    ("fused_conv3x3_bn_relu", hw, hw, c, o) for hw, c, o in [
        (4, 128, 128), (4, 128, 848), (4, 212, 212), (4, 212, 848), (4, 848, 848),
        (4, 1696, 848), (4, 848, 128), (4, 848, 212), (4, 848, 1696),
        (8, 53, 53), (8, 64, 64), (8, 64, 128), (8, 128, 106), (8, 128, 128), (8, 128, 424),
        (8, 424, 424), (8, 106, 128), (8, 128, 64), (8, 424, 128),
        (16, 16, 16), (16, 64, 64), (16, 128, 128), (16, 256, 256),
        (32, 4, 4), (32, 16, 4), (32, 16, 16), (32, 64, 16), (32, 64, 64), (32, 128, 128),
        (32, 4, 16), (32, 16, 64),
        (64, 4, 4), (64, 16, 4), (64, 16, 16), (64, 64, 16), (64, 64, 64), (64, 4, 16),
        (64, 16, 64)]
] + [
    ("fused_conv4x4s2_bn_relu", hw, hw, c, o) for hw, c, o in [
        (8, 64, 128), (16, 16, 64), (16, 64, 128), (32, 4, 16), (32, 16, 64), (64, 4, 16),
        (16, 128, 53), (16, 256, 424), (32, 64, 128), (32, 128, 256), (64, 64, 128)]
] + [
    # #6 forward (the UpBlocks) and as the input gradient of each DownBlock's
    # 4x4/s2 conv (LR and HR: O = 4, 16, 64)
    ("fused_convT4x4s2_bn_relu", hw, hw, c, o) for hw, c, o in [
        (8, 53, 128), (16, 128, 64), (8, 424, 256), (16, 256, 128), (32, 128, 64),
        (16, 16, 4), (8, 64, 16), (4, 128, 64), (32, 16, 4), (16, 64, 16), (8, 128, 64)]
]


@pytest.mark.parametrize("batch", [1, 16, 512, 1000])
def test_plan_tc_at_every_canonical_shape(batch):
    """Serving (B = 1 and 16), training (B = 512) and the 1000-draw decode:
    the ring fits in shared memory, K is covered by 32-deep steps, and the
    card is filled (the transposed conv's four phases counted) unless K is
    too short to split further."""
    for name, h, w, c, o in _CANONICAL:
        _, taps, stride, phases = fc._KERNELS[name]
        m, k = batch * (h // stride) * (w // stride), taps * c
        cfg, splits, kchunk = fc.plan_tc(m, o, k, phases)
        bm, bn = fc.TC_TILES[cfg][:2]
        assert fc.tc_smem_bytes(cfg) <= SMEM_LIMIT
        assert kchunk % fc.TC_BK == 0 and (splits - 1) * kchunk < k <= splits * kchunk
        blocks = _cdiv(m, bm) * _cdiv(o, bn) * phases
        if blocks >= SMS:
            assert splits == 1
        else:
            assert blocks * splits >= SMS or kchunk < 2 * fc._TC_MIN_SPLIT_K, (name, m, o, k)
        assert (cfg == 3) == (m <= 64)
        if m > 64:
            assert bn >= min(o, 64) or cfg == 2


def test_every_float_conv_kernel_takes_the_tensor_cores():
    assert set(fc.TC_KERNELS) == set(fc.WRAPPERS) == {
        "fused_conv3x3_bn_relu", "fused_conv4x4s2_bn_relu", "fused_convT4x4s2_bn_relu"}
    # each tile's cp.async ring leaves room for a second block on the SM
    for cfg, (bm, bn, wm, wn, stages) in fc.TC_TILES.items():
        assert bm % wm == 0 and bn % wn == 0 and wm % 16 == 0 and wn % 8 == 0
        threads = (bm // wm) * (bn // wn) * 32
        assert threads in (128, 256) and (bm * fc.TC_BK // 4) % threads == 0
        assert 2 * fc.tc_smem_bytes(cfg) <= 228 * 1024 - 2048


# every chain the canonical models launch, at the batch sizes of their paths:
# (B, H, W, C_0 .. C_n)
_CHAIN_TAIL = (64, 64, 16, 16, 4)
_CANONICAL_CHAINS = [(b, 64, 64, _CHAIN_TAIL) for b in (16, 512, 1000)] + [
    (b, 32, 32, _CHAIN_TAIL) for b in (16, 512, 1000)] + [
    (b, 8, 8, (64, 64, 128, 128, 106)) for b in (1, 16, 512)] + [
    (512, 8, 8, (128, 128, 128, 128, 424))] + [
    (b, 8, 8, (64, 64, 128, 128, 84)) for b in (1, 512)]


def test_the_chain_takes_the_tensor_cores():
    """The chain's multiply-adds run on mma.sync TF32 with the 3xTF32 split
    and the rounded promotion of each 8-deep partial (as conv_tc), and no
    scalar FMA loop is left; its plan fits in shared memory at every
    canonical chain, full-width rows."""
    src = (Path(fc.__file__).resolve().parent.parent / "csrc" / fch.SOURCE).read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "split_tf32(a0[0], ah[0], al[0])" in src and "split_tf32(bp[0]" in src
    for product in ("mma_tf32(part, al, bh[ni])", "mma_tf32(part, ah, bl[ni])",
                    "mma_tf32(part, ah, bh[ni])", "acc[mi][ni][r] += part[r]"):
        assert product in src
    assert "fmaf(" not in src
    for b, h, w, chans in _CANONICAL_CHAINS:
        plan = fch.plan_chain(b, h, w, chans)
        assert plan.smem_bytes <= SMEM_LIMIT and plan.panel == w
        # the card is filled: nine in ten SMs at least, or a block per output row
        assert b * plan.strips * plan.panels >= min(0.9 * SMS, b * h)



# ------------------------------------------------- the bfloat16 instances
def _bf16(a):
    """float32 -> nearest bfloat16 (ties to even), held in float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _bank_groups_distinct(byte_offsets):
    """The eight 16-byte rows one ldmatrix phase reads sit on eight distinct
    16-byte bank groups (no conflict): rows 16-byte aligned, (offset / 16) % 8
    all different."""
    byte_offsets = np.asarray(byte_offsets)
    assert (byte_offsets % 16 == 0).all()
    return len(np.unique((byte_offsets // 16) % 8)) == 8


def conv_tc_bf16_replay(name, x, kern, scale, shift, relu):
    """``conv_tc_bf16``'s launch replayed block by block in numpy: the plan
    with 64-deep K steps, the A loader in 8-channel groups (one 16-byte copy
    when C % 8 == 0, else eight masked 2-byte loads), the B loader likewise by
    O, ldmatrix.x4 for A and ldmatrix.x4.trans for B emulated lane by lane
    from the addresses each lane gives (every phase checked free of bank
    conflicts), the registers placed where the m16n8k16 .bf16 fragment maps
    say, each step's four products summed before the float32 running sum,
    the epilogue rounded to bfloat16 and the ordered split-K reduce. Shared
    memory is NaN before each load. Returns (output as float32, writes per
    output element)."""
    b, h, w, c = x.shape
    o = kern.shape[-1]
    stride = 2 if name == "fused_conv4x4s2_bn_relu" else 1
    m_all, _, k_all, phases = fc.geometry(name, torch.from_numpy(x), torch.from_numpy(kern))
    ho, wo = (h // 2, w // 2) if stride == 2 else (h, w)
    bk = fc.TC_BK_BF16
    cfg, splits, kchunk = fc.plan_tc(m_all, o, k_all, phases, bk=bk)
    bm, bn, wm_t, wn_t, stages = fc.TC_TILES[cfg]
    warps_m, warps_n = bm // wm_t, bn // wn_t
    nt = warps_m * warps_n * 32
    kq_n, nq = bk // 8, bn // 8
    a_rows, b_vecs = bm * kq_n // nt, _cdiv(bk * nq, nt)
    a_ld, b_ld = bk + 8, bn + 8
    mi_n, ni_n = wm_t // 16, wn_t // 8
    a_tile, b_tile = bm * a_ld, bk * b_ld
    assert fc.tc_smem_bytes(cfg, bf16=True) == 2 * stages * (a_tile + b_tile)
    assert fc.tc_smem_bytes(cfg, bf16=True) == fc.tc_smem_bytes(cfg)  # the same bytes a stage
    xf, wf = x.reshape(-1), kern.reshape(-1)
    vec_a, vec_b = c % 8 == 0, o % 8 == 0
    out_shape = fc.output_shape(name, x.shape, o)

    def out_offset(p, m, n):
        if phases == 1:
            return m * o + n
        bb, r = np.divmod(m, ho * wo)
        i, j = np.divmod(r, wo)
        return ((bb * 2 * ho + 2 * i + (p >> 1)) * 2 * wo + 2 * j + (p & 1)) * o + n

    def weight_row(kr, p):
        if phases == 1:
            return kr
        t = div_c(kr, c)
        return kr + (_tap(name, t, p)[2] - t) * c

    tid = np.arange(nt)
    kq = tid % kq_n
    rows = tid[:, None] // kq_n + np.arange(a_rows)[None, :] * (nt // kq_n)
    lane = np.arange(32)
    gq, tq = lane >> 2, lane & 3
    out = np.full(int(np.prod(out_shape)), np.nan, np.float32)
    writes = np.zeros(out.size, np.int64)
    ws = np.full((splits, phases, m_all, o), np.nan, np.float32)
    ws_writes = np.zeros((splits, phases, m_all, o), np.int64)

    def ldsm(sm, addr, trans):
        """ldmatrix.x4 (.trans) of one warp: ``addr[l]`` is lane l's row
        address (elements); returns regs[t, j, half] for thread t."""
        regs = np.zeros((32, 4, 2), np.float32)
        for j in range(4):
            base = addr[8 * j: 8 * j + 8]
            assert _bank_groups_distinct(2 * base)
            mat = sm[base[:, None] + np.arange(8)[None, :]]  # [row][col] of matrix j
            if trans:
                mat = mat.T
            regs[:, j, 0] = mat[lane // 4, 2 * (lane % 4)]
            regs[:, j, 1] = mat[lane // 4, 2 * (lane % 4) + 1]
        return regs

    for bz in range(phases * splits):
        p, s = divmod(bz, splits)
        kbeg = s * kchunk
        kend = min(k_all, kbeg + kchunk)
        nsteps = _cdiv(kend - kbeg, bk) if kend > kbeg else 0
        for bx in range(_cdiv(m_all, bm)):
            m0 = bx * bm
            mm = m0 + rows
            valid_m = mm < m_all
            bb, r = np.divmod(mm, ho * wo)
            oy, ox = np.divmod(r, wo)
            a_y = np.where(valid_m, oy * stride, -(1 << 24))
            a_x = np.where(valid_m, ox * stride, 0)
            a_pix = np.where(valid_m, (bb * h + a_y) * w + a_x, 0)
            for by in range(_cdiv(o, bn)):
                n0 = by * bn
                a_sm = np.full((stages, a_tile), np.nan, np.float32)
                b_sm = np.full((stages, b_tile), np.nan, np.float32)

                def gather(v, idx):
                    return np.where(v, xf[np.where(v, idx, 0)], np.float32(0))

                def load(slot, k0):
                    a_sm[slot] = np.nan
                    b_sm[slot] = np.nan
                    dst = rows * a_ld + 8 * kq[:, None]
                    assert ((2 * dst) % 16 == 0).all()  # each group one aligned 16-byte store
                    k = k0 + 8 * kq
                    if vec_a:  # channels c .. c+7 of one tap, one 16-byte copy
                        kv = k < kend
                        t = np.where(kv, div_c(k, c), 0)
                        cc = k - t * c
                        dy, dx, _ = _tap(name, t, p)
                        iy, ix = a_y + dy[:, None], a_x + dx[:, None]
                        v = kv[:, None] & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                        src = (a_pix + (dy * w + dx)[:, None]) * c + cc[:, None]
                        assert ((2 * src[v]) % 16 == 0).all()  # the copy's source is aligned
                        for j in range(8):
                            a_sm[slot, dst + j] = gather(v, src + j)
                    else:  # eight 2-byte loads, each resolved on its own
                        for j in range(8):
                            kv = k + j < kend
                            t = np.where(kv, div_c(k + j, c), 0)
                            cc = k + j - t * c
                            dy, dx, _ = _tap(name, t, p)
                            iy, ix = a_y + dy[:, None], a_x + dx[:, None]
                            v = kv[:, None] & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                            src = (a_pix + (dy * w + dx)[:, None]) * c + cc[:, None]
                            a_sm[slot, dst + j] = gather(v, src)
                    b_dst = []
                    for jv in range(b_vecs):
                        e = tid + jv * nt
                        e = e[e < bk * nq]
                        kk, nqi = np.divmod(e, nq)
                        kr, n = k0 + kk, n0 + 8 * nqi
                        kv = kr < kend
                        row = np.where(kv, weight_row(np.where(kv, kr, 0), p), 0) * o
                        if vec_b:
                            assert ((2 * (row + n)[kv & (n < o)]) % 16 == 0).all()
                        for q in range(8):
                            v = kv & ((n < o) if vec_b else (n + q < o))
                            b_sm[slot, kk * b_ld + 8 * nqi + q] = np.where(
                                v, wf[np.where(v, row + n + q, 0)], np.float32(0))
                        b_dst.append(kk * b_ld + 8 * nqi)
                    a_cells = (dst[..., None] + np.arange(8)).ravel()
                    b_cells = (np.concatenate(b_dst)[:, None] + np.arange(8)).ravel()
                    assert len(np.unique(a_cells)) == a_cells.size == bm * bk
                    assert len(np.unique(b_cells)) == b_cells.size == bk * bn
                    assert not np.isnan(a_sm[slot].reshape(bm, a_ld)[:, :bk]).any()
                    assert not np.isnan(b_sm[slot].reshape(bk, b_ld)[:, :bn]).any()

                acc = np.zeros((warps_m, warps_n, mi_n, ni_n, 32, 4), np.float32)
                for st in range(stages - 1):
                    if st < nsteps:
                        load(st, kbeg + st * bk)
                for step in range(nsteps):
                    nxt = step + stages - 1
                    if nxt < nsteps:
                        load(nxt % stages, kbeg + nxt * bk)
                    a_s, b_s = a_sm[step % stages], b_sm[step % stages]
                    for wmi in range(warps_m):
                        for wni in range(warps_n):
                            part = np.zeros((mi_n, ni_n, 32, 4), np.float64)
                            for ks in range(bk // 16):
                                b_frag = np.full((ni_n, 16, 8), np.nan, np.float32)
                                for ni in range(0, ni_n, 2):
                                    addr = ((ks * 16 + (lane & 15)) * b_ld + wni * wn_t
                                            + ni * 8 + 8 * (lane >> 4))
                                    regs = ldsm(b_s, addr, trans=True)
                                    for tile, (j0, j1) in ((ni, (0, 1)), (ni + 1, (2, 3))):
                                        for jj, k_off in ((j0, 0), (j1, 8)):
                                            b_frag[tile, k_off + 2 * tq, gq] = regs[:, jj, 0]
                                            b_frag[tile, k_off + 2 * tq + 1, gq] = regs[:, jj, 1]
                                for mi in range(mi_n):
                                    addr = ((wmi * wm_t + mi * 16 + (lane & 15)) * a_ld
                                            + ks * 16 + 8 * (lane >> 4))
                                    regs = ldsm(a_s, addr, trans=False)
                                    a_frag = np.full((16, 16), np.nan, np.float32)
                                    for jj, (r_off, k_off) in enumerate(
                                            ((0, 0), (8, 0), (0, 8), (8, 8))):
                                        a_frag[gq + r_off, k_off + 2 * tq] = regs[:, jj, 0]
                                        a_frag[gq + r_off, k_off + 2 * tq + 1] = regs[:, jj, 1]
                                    d = np.einsum("ik,nkj->nij", a_frag.astype(np.float64),
                                                  b_frag.astype(np.float64))
                                    part[mi] += np.stack(
                                        [d[:, gq, 2 * tq], d[:, gq, 2 * tq + 1],
                                         d[:, gq + 8, 2 * tq], d[:, gq + 8, 2 * tq + 1]], -1)
                            acc[wmi, wni] = (acc[wmi, wni]
                                             + part.astype(np.float32)).astype(np.float32)
                for wmi in range(warps_m):
                    for wni in range(warps_n):
                        for mi in range(mi_n):
                            for hh in range(2):
                                m = m0 + wmi * wm_t + mi * 16 + gq + 8 * hh
                                for ni in range(ni_n):
                                    n = n0 + wni * wn_t + ni * 8 + 2 * tq
                                    for col, reg in ((n, 2 * hh), (n + 1, 2 * hh + 1)):
                                        ok = (m < m_all) & (n < o) & (col < o)
                                        val = acc[wmi, wni, mi, ni, :, reg][ok]
                                        mo, co = m[ok], col[ok]
                                        if splits == 1:
                                            y = val * scale[co] + shift[co]
                                            dst = out_offset(p, mo, co)
                                            out[dst] = _bf16(np.maximum(y, 0) if relu else y)
                                            np.add.at(writes, dst, 1)
                                        else:
                                            ws[s, p, mo, co] = val
                                            np.add.at(ws_writes, (s, p, mo, co), 1)
    if splits > 1:
        assert (ws_writes == 1).all()
        tot = np.zeros((phases, m_all, o), np.float32)
        for s in range(splits):
            tot = (tot + ws[s]).astype(np.float32)
        y = tot * scale + shift
        y = np.maximum(y, 0) if relu else y
        pp, mm, nn = np.meshgrid(np.arange(phases), np.arange(m_all), np.arange(o),
                                 indexing="ij")
        dst = out_offset(pp, mm, nn).ravel()
        out[dst] = _bf16(y).ravel()
        np.add.at(writes, dst, 1)
    return out.reshape(out_shape), writes.reshape(out_shape)


# (name, x shape, O, relu, tile config): C % 8 == 0 beside C % 8 != 0 (4, 12,
# 53, 7, 106: the 2-byte loads), O % 8 != 0 (13, 53, 9, 4: the same for B),
# odd H and W, M <= 64 (per phase) with a K split and K not a multiple of
# 64, and every tile configuration, for each of the three convs
BF16_REPLAY_CASES = [
    ("fused_conv3x3_bn_relu", (3, 5, 7, 8), 13, True, 2),
    ("fused_conv3x3_bn_relu", (2, 9, 11, 4), 3, False, 2),
    ("fused_conv3x3_bn_relu", (2, 6, 6, 53), 53, False, 1),
    ("fused_conv3x3_bn_relu", (1, 9, 9, 16), 72, True, 0),
    ("fused_conv3x3_bn_relu", (1, 9, 9, 12), 72, True, 0),
    ("fused_conv3x3_bn_relu", (1, 4, 4, 212), 96, False, 3),
    ("fused_conv4x4s2_bn_relu", (3, 10, 12, 7), 9, True, 2),
    ("fused_conv4x4s2_bn_relu", (2, 16, 16, 16), 53, False, 1),
    ("fused_conv4x4s2_bn_relu", (1, 8, 8, 53), 40, True, 3),
    ("fused_convT4x4s2_bn_relu", (2, 6, 5, 53), 9, True, 3),
    ("fused_convT4x4s2_bn_relu", (2, 6, 7, 16), 24, False, 1),
    ("fused_convT4x4s2_bn_relu", (2, 8, 8, 16), 4, True, 2),
    ("fused_convT4x4s2_bn_relu", (1, 9, 9, 8), 72, True, 0),
    ("fused_convT4x4s2_bn_relu", (1, 4, 4, 64), 24, False, 3),
    ("fused_convT4x4s2_bn_relu", (1, 3, 4, 130), 13, True, 3),
]


@pytest.mark.parametrize("case", BF16_REPLAY_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_conv_tc_bf16_index_arithmetic_matches_plain(case):
    name, shape, o, relu, cfg = case
    x, kern, s, t = _data(shape, o, 4 if "4x4" in name else 3, seed=sum(shape) + 2 * o)
    x, kern = _bf16(x), _bf16(kern)
    m, n, k, phases = fc.geometry(name, torch.from_numpy(x), torch.from_numpy(kern))
    assert fc.plan_tc(m, n, k, phases, bk=fc.TC_BK_BF16)[0] == cfg
    got, writes = conv_tc_bf16_replay(name, x, kern, s, t, relu)
    assert (writes == 1).all()
    xb, kb = torch.from_numpy(x).bfloat16(), torch.from_numpy(kern).bfloat16()
    want = fc.PLAIN[name](xb, kb, *map(torch.from_numpy, (s, t)), relu)
    assert want.dtype == torch.bfloat16
    assert fc.compare_bf16(torch.from_numpy(got).bfloat16(), want)["of_bound"] <= 1.0


def test_conv_tc_bf16_plan_splits_k_in_64_deep_steps():
    # the K-split replay cases above really split, with K not a multiple of 64
    for m, n, k, phases in ((16, 96, 9 * 212, 1), (4, 40, 16 * 53, 1), (12, 13, 4 * 130, 4)):
        cfg, splits, kchunk = fc.plan_tc(m, n, k, phases, bk=fc.TC_BK_BF16)
        assert cfg == 3 and splits > 1 and kchunk % fc.TC_BK_BF16 == 0
        assert (splits - 1) * kchunk < k <= splits * kchunk and k % fc.TC_BK_BF16 != 0


@pytest.mark.parametrize("batch", [1, 16, 512, 1000])
def test_plan_tc_bf16_at_every_canonical_shape(batch):
    """The bfloat16 plan at every canonical shape: the ring fits, K is
    covered by 64-deep steps, the card is filled unless K is too short."""
    for name, h, w, c, o in _CANONICAL:
        _, taps, stride, phases = fc._KERNELS[name]
        m, k = batch * (h // stride) * (w // stride), taps * c
        cfg, splits, kchunk = fc.plan_tc(m, o, k, phases, bk=fc.TC_BK_BF16)
        bm, bn = fc.TC_TILES[cfg][:2]
        assert fc.tc_smem_bytes(cfg, bf16=True) <= SMEM_LIMIT
        assert kchunk % fc.TC_BK_BF16 == 0 and (splits - 1) * kchunk < k <= splits * kchunk
        blocks = _cdiv(m, bm) * _cdiv(o, bn) * phases
        if blocks >= SMS:
            assert splits == 1
        else:
            # or each split is at most twice the shortest (four 64-deep steps)
            assert blocks * splits >= SMS or kchunk <= 8 * fc.TC_BK_BF16, (name, m, o, k)


def test_bf16_instances_are_mma_bf16_in_all_three_modes():
    src = (Path(fc.__file__).resolve().parent.parent / "csrc" / fc.SOURCE).read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in src
    for mode in ("kConv3", "kConv4", "kConvT"):
        assert f"launch<{mode}, bf16>" in src
    for cfg, (bm, bn, wm, wn, stages) in fc.TC_TILES.items():
        threads = (bm // wm) * (bn // wn) * 32
        assert wn % 16 == 0 and (bm * fc.TC_BK_BF16 // 8) % threads == 0
        assert 2 * fc.tc_smem_bytes(cfg, bf16=True) <= 228 * 1024 - 2048


# ------------------------------------------ conv_wg_bf16 (wgmma fed by TMA)
class _Mbar:
    """An mbarrier: ``count`` arrivals and the bytes announced by
    ``expect_tx`` complete a phase; ``try_wait(parity)`` passes once the
    phase of that parity has completed (the current phase's parity differs),
    so a fresh barrier passes a wait on parity 1 at once."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def _flip(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def arrive(self):
        assert self.pending > 0
        self.pending -= 1
        self._flip()

    def expect_tx(self, nbytes):
        self.tx += nbytes
        self.arrive()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        assert self.tx >= 0, "more bytes landed than expect_tx announced"
        self._flip()

    def try_wait(self, parity):
        return (self.phase & 1) != parity


def _swizzle(addr, sw_bytes):
    """TMA's and wgmma's swizzle of a shared-memory byte address: bits
    [7, 7 + b) XORed into bits [4, 4 + b), b = log2(sw_bytes / 16)."""
    b = {128: 3, 32: 1}[sw_bytes]
    return addr ^ (((addr >> 7) & ((1 << b) - 1)) << 4)


def _desc(addr, lbo, sbo, layout):
    """The kernel's smem_desc: start, leading and stride byte offsets >> 4
    and the swizzle code (1: 128-byte rows, 3: 32-byte rows)."""
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32) | (layout << 62)


def _undesc(d):
    sw = {1: 128, 3: 32}[d >> 62]
    return ((d & 0x3FFF) << 4, ((d >> 16) & 0x3FFF) << 4, ((d >> 32) & 0x3FFF) << 4, sw)


def _a_operand_addrs(d):
    """Byte addresses of wgmma's 64 x 16 A operand (K-major) under
    descriptor ``d``: rows 8 to a core group of 128-byte... rows of the
    swizzle width, 8-row groups SBO apart, 16-byte k chunks side by side
    (the leading offset is unused when swizzled)."""
    start, _, sbo, sw = _undesc(d)
    m, k = np.arange(64)[:, None], np.arange(16)[None, :]
    return _swizzle(start + (m % 8) * sw + (m // 8) * sbo + (k // 8) * 16 + (k % 8) * 2, sw)


def _b_operand_addrs(d, n):
    """Byte addresses of wgmma's 16 x n B operand (MN-major, "transposed")
    under descriptor ``d``: n contiguous within a row of the swizzle width,
    the next row's worth of n (an atom) LBO on, k rows of the swizzle width,
    8-row groups SBO apart."""
    start, lbo, sbo, sw = _undesc(d)
    k, nn = np.arange(16)[:, None], np.arange(n)[None, :]
    per_row = sw // 2
    return _swizzle(start + (nn % per_row) * 2 + (nn // per_row) * lbo + (k % 8) * sw
                    + (k // 8) * sbo, sw)


def _ring(n, stages):
    """(stage, parity) of the n k-groups a block walks: the consumers wait on
    full[stage] with the parity, the producer on empty[stage] with its
    complement."""
    return [(it % stages, (it // stages) & 1) for it in range(n)]


def conv_wg_replay(name, x, kern, scale, shift, relu, schedule="producer_first"):
    """``conv_wg_bf16``'s launch replayed block by block in numpy: the plan
    (box, BN, stages, persistent grid), the tile order, the producer and the
    two consumer warpgroups as coroutines over the mbarrier ring (full and
    empty barriers, parities), TMA boxes with per-dimension zero fill landing
    under the 128- or 32-byte swizzle with the bytes counted against
    expect_tx, the wgmma operands read back through their descriptors,
    each 64-deep k-group summed before the float32 running sum, the m64nNk16
    fragment map and the epilogue (pixels of the box, the transposed conv's
    strided pixels, rows past the box, the image or the batch not stored).
    The 4x4/s2 conv's A box is traversed with element strides (1, 2, 2, 1):
    a (KC, 2 wb, 2 th, nb) box that lands KC wb th nb elements, every second
    input pixel from (c0, 2 x0 + kx - 1, 2 y0 + ky - 1, n0).
    Shared memory is NaN before the launch. Returns (output as float32,
    writes per output element, TMA loads as (stage, kind, coordinates))."""
    b, h, w, c = x.shape
    o = kern.shape[-1]
    _, taps, stride, phases = fc._KERNELS[name]  # stride: the A box's element stride
    oh, ow = h // stride, w // stride  # the tiles' pixel grid (one phase's for #6)
    plan = fc.plan_wg(name, b, h, w, c, o)
    wb, th, nb, bn, kc, stages = plan.wb, plan.th, plan.nb, plan.bn, plan.kc, plan.stages
    assert 1 <= wb * th * nb <= fc.WG_BM and kc in (16, 64)
    assert max(stride * wb, stride * th, nb) <= 256  # TMA's boxDim limit, strided
    xs, ys = _cdiv(ow, wb), _cdiv(oh, th)
    mtiles, ntiles = xs * ys * _cdiv(b, nb), _cdiv(o, bn)
    assert plan.tiles == phases * mtiles * ntiles and plan.grid == min(plan.tiles, SMS)
    chunks = _cdiv(c, kc)
    kgroups = taps * chunks
    ar, rb = 2 * kc, min(bn, 64) * 2      # A's and B's row bytes, each its swizzle
    code = {128: 1, 32: 3}
    a_bytes, b_bytes, b_box = 128 * ar, kc * bn * 2, kc * rb
    smem_bytes = 1024 + stages * (a_bytes + b_bytes) + 2 * stages * 8
    assert smem_bytes <= SMEM_LIMIT
    a_box_bytes = kc * wb * th * nb * 2
    w_taps = kern.reshape(-1, c, o)       # (taps, C, O): the B tensor map's view
    out_shape = fc.output_shape(name, x.shape, o)
    out = np.full(int(np.prod(out_shape)), np.nan, np.float32)
    writes = np.zeros(out.size, np.int64)
    loads = []

    def tile_of(t):
        nt, q = t % ntiles, t // ntiles
        mt, p = q % mtiles, q // mtiles
        seg, q = mt % xs, mt // xs
        return p, seg * wb, (q % ys) * th, (q // ys) * nb, nt * bn

    for bid in range(plan.grid):
        sm = np.full((stages * (a_bytes + b_bytes)) // 2, np.nan, np.float32)  # bf16 cells
        full = [_Mbar(1) for _ in range(stages)]
        empty = [_Mbar(8) for _ in range(stages)]
        my_tiles = list(range(bid, plan.tiles, plan.grid))

        def tma_a(s, c0, x0, y0, n0):
            ci, xi, yi, ni = np.meshgrid(np.arange(kc), np.arange(wb), np.arange(th),
                                         np.arange(nb), indexing="ij")
            cc, xx, yy, nn = c0 + ci, x0 + stride * xi, y0 + stride * yi, n0 + ni
            ok = (cc >= 0) & (cc < c) & (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h) & (nn < b)
            val = np.where(ok, x[np.where(ok, nn, 0), np.where(ok, yy, 0), np.where(ok, xx, 0),
                                 np.where(ok, cc, 0)], np.float32(0))
            row = (ni * th + yi) * wb + xi
            addr = _swizzle(s * a_bytes + row * ar + ci * 2, ar)
            sm[addr.ravel() // 2] = val.ravel()
            loads.append((s, "A", (c0, x0, y0, n0)))
            return val.size * 2

        def tma_b(s, j, o0, c0, wtap):
            oi, ci = np.meshgrid(np.arange(rb // 2), np.arange(kc), indexing="ij")
            oo, cc = o0 + oi, c0 + ci
            ok = (oo < o) & (cc < c)
            val = np.where(ok, w_taps[wtap, np.where(ok, cc, 0), np.where(ok, oo, 0)],
                           np.float32(0))
            addr = _swizzle(stages * a_bytes + s * b_bytes + j * b_box + ci * rb + oi * 2, rb)
            sm[addr.ravel() // 2] = val.ravel()
            loads.append((s, "B", (o0, c0, wtap)))
            return val.size * 2

        def producer():
            ring = iter(_ring(len(my_tiles) * kgroups, stages))
            for t in my_tiles:
                p, x0, y0, n0, o0 = tile_of(t)
                for tap in range(taps):
                    dy, dx, wtap = _tap(name, tap, p)
                    for ch in range(chunks):
                        s, ph = next(ring)
                        while not empty[s].try_wait(ph ^ 1):
                            yield
                        full[s].expect_tx(a_box_bytes + b_bytes)
                        landed = tma_a(s, ch * kc, stride * x0 + dx, stride * y0 + dy, n0)
                        for j in range(max(1, bn // 64)):
                            landed += tma_b(s, j, o0 + 64 * j, ch * kc, wtap)
                        assert landed == a_box_bytes + b_bytes  # whole boxes, zero fill too
                        full[s].complete_tx(landed)

        lane = np.arange(128) % 32
        wq = np.arange(128) // 32

        def consumer():
            ring = iter(_ring(len(my_tiles) * kgroups, stages))
            nr = bn // 2
            for t in my_tiles:
                p, x0, y0, n0, o0 = tile_of(t)
                acc = np.zeros((2, 128, nr), np.float32)
                for _ in range(kgroups):
                    s, ph = next(ring)
                    while not full[s].try_wait(ph):
                        yield
                    for wg in range(2):
                        da = _desc(s * a_bytes + wg * 64 * ar, 16, 8 * ar, code[ar])
                        db = _desc(stages * a_bytes + s * b_bytes, b_box, 8 * rb, code[rb])
                        part = np.zeros((64, bn), np.float64)
                        for k in range(kc // 16):
                            a_op = sm[_a_operand_addrs(da + (32 * k >> 4)) // 2]
                            b_op = sm[_b_operand_addrs(db + (16 * rb * k >> 4), bn) // 2]
                            assert not np.isnan(b_op).any()
                            part += a_op.astype(np.float64) @ b_op.astype(np.float64)
                        # the m64nNk16 fragment: d[4j + 2h + e] of thread (wq, lane)
                        # is row 16 wq + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
                        j, hh, e = np.meshgrid(np.arange(bn // 8), np.arange(2), np.arange(2),
                                               indexing="ij")
                        reg = (4 * j + 2 * hh + e).ravel()
                        rows = 16 * wq[:, None] + lane[:, None] // 4 + 8 * hh.ravel()[None, :]
                        cols = 8 * j.ravel()[None, :] + 2 * (lane[:, None] % 4) + e.ravel()[None, :]
                        frag = np.zeros((128, nr), np.float32)
                        frag[:, reg] = part.astype(np.float32)[rows, cols]
                        acc[wg] = (acc[wg] + frag).astype(np.float32)
                    for _ in range(8):  # lane 0 of each consumer warp
                        empty[s].arrive()
                # epilogue
                for wg in range(2):
                    for hh in range(2):
                        r = 64 * wg + 16 * wq + lane // 4 + 8 * hh
                        xi, q = r % wb, r // wb
                        yi, ni = q % th, q // th
                        xx, yy, nn = x0 + xi, y0 + yi, n0 + ni
                        keep = (ni < nb) & (xx < ow) & (yy < oh) & (nn < b)
                        if phases == 1:
                            pix = (nn * oh + yy) * ow + xx
                        else:
                            pix = (nn * 2 * oh + 2 * yy + (p >> 1)) * (2 * ow) + 2 * xx + (p & 1)
                        for j in range(bn // 8):
                            col = o0 + 8 * j + 2 * (lane % 4)
                            ok = keep & (col < o)
                            for e in range(2):
                                n = np.minimum(col + e, o - 1)
                                v = acc[wg][:, 4 * j + 2 * hh + e] * scale[n] + shift[n]
                                v = np.maximum(v, 0) if relu else v
                                dst = (pix * o + col + e)[ok]
                                assert not np.isnan(v[ok]).any()
                                out[dst] = _bf16(v[ok])
                                np.add.at(writes, dst, 1)

        roles = {"producer_first": [producer(), consumer()],
                 "consumer_first": [consumer(), producer()]}[schedule]
        live = list(roles)
        while live:  # each role runs until it would wait, then the other
            for role in list(live):
                try:
                    next(role)
                except StopIteration:
                    live.remove(role)
        assert all(f.pending == 1 and f.tx == 0 for f in full)
    return out.reshape(out_shape), writes.reshape(out_shape), loads


# (name, x shape, O, relu): C % 64 != 0 (72, 200: zero-filled channels), C =
# 16 and 8 (16-channel k-groups in 32-byte rows), O = 8, 24 and 136 (a
# 16-wide, a part-filled 64-wide and a last 8-wide 128 channel tile), odd H
# and W, a batch that is not a multiple of the box's images (11 in boxes of
# 8 at 4x4, 3 in boxes of 2 at 8x8), a row wider than one 128-pixel box, and
# all three convs (#5 on an 8x8 and a 4x4 output grid, an odd output grid and
# a 128-wide output row: its strided box at TMA's 256-element limit)
WG_REPLAY_CASES = [
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
]


@pytest.mark.parametrize("case", WG_REPLAY_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3]}")
def test_conv_wg_bf16_index_arithmetic_matches_plain(case):
    name, shape, o, relu = case
    x, kern, s, t = _data(shape, o, 4 if "4x4" in name else 3, seed=sum(shape) + 3 * o)
    x, kern = _bf16(x), _bf16(kern)
    xb, kb = torch.from_numpy(x).bfloat16(), torch.from_numpy(kern).bfloat16()
    assert fc.wg_supported(name, xb, kb)
    got, writes, _ = conv_wg_replay(name, x, kern, s, t, relu)
    assert (writes == 1).all()
    want = fc.PLAIN[name](xb, kb, *map(torch.from_numpy, (s, t)), relu)
    assert fc.compare_bf16(torch.from_numpy(got).bfloat16(), want)["of_bound"] <= 1.0


# (name, x shape, O) of the transposed convs whose input gradient #5
# computes: C = 24 and 16 of the convT (the gradient's O), O = 72 and 64 of
# the convT (the gradient's C, 72 with a zero-filled channel tail)
WG_DX_CASES = [
    ("fused_convT4x4s2_bn_relu", (3, 4, 4, 24), 72),
    ("fused_convT4x4s2_bn_relu", (2, 3, 5, 16), 64),
]


@pytest.mark.parametrize("case", WG_DX_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_conv_wg_bf16_replays_the_transposed_convs_input_gradient(case):
    """#5's dx role: ``input_grad`` of a transposed conv runs #5 on the
    flip-swapped weight (a fresh contiguous tensor), scale 1, shift 0, no
    ReLU; the replay of that launch against the plain route."""
    name, shape, o = case
    x, kern, _, _ = _data(shape, o, 4, seed=sum(shape) + o)
    kern = _bf16(kern)
    out_shape = fc.output_shape(name, shape, o)
    g = _bf16(np.random.default_rng(o).standard_normal(out_shape).astype(np.float32))
    dx_name, c = fc.DX_KERNEL[name], shape[-1]
    assert dx_name == "fused_conv4x4s2_bn_relu"
    kf = fc.flip_swap(torch.from_numpy(kern).bfloat16())
    assert fc.wg_supported(dx_name, torch.from_numpy(g).bfloat16(), kf)
    ones, zeros = np.ones(c, np.float32), np.zeros(c, np.float32)
    got, writes, _ = conv_wg_replay(dx_name, g, kf.float().numpy(), ones, zeros, False)
    assert (writes == 1).all() and got.shape == shape
    want = fc.input_grad(name, torch.from_numpy(g).bfloat16(), torch.from_numpy(kern).bfloat16(),
                         shape, plain=True)
    assert fc.compare_bf16(torch.from_numpy(got).bfloat16(), want)["of_bound"] <= 1.0


def test_conv_wg_bf16_ring_order_does_not_change_the_result():
    # the consumers running ahead (waiting at once) and the producer running
    # ahead (filling every free slot first) give the same bits, over a block
    # that walks several tiles (the ring wraps across tiles); the 3x3 conv
    # and the 4x4/s2 conv (16 taps of two chunks, the ring wrapping in a tile)
    for name, shape, o in (("fused_conv3x3_bn_relu", (5, 4, 4, 72), 136),
                           ("fused_conv4x4s2_bn_relu", (9, 8, 8, 72), 136)):
        x, kern, s, t = _data(shape, o, 3 if "3x3" in name else 4, seed=5)
        x, kern = _bf16(x), _bf16(kern)
        a, wa, _ = conv_wg_replay(name, x, kern, s, t, True, "producer_first")
        b, wb_, _ = conv_wg_replay(name, x, kern, s, t, True, "consumer_first")
        assert (wa == 1).all() and (wb_ == 1).all()
        np.testing.assert_array_equal(a, b)


def test_conv_wg_bf16_tma_boxes_and_zero_fill():
    """The A box of tile 0 walks the taps at (c0, x0 + dx, y0 + dy, n0) with
    negative and past-the-end coordinates (zero filled), 64-channel chunks
    of C = 72 (the second one 8 channels, 56 zero filled); the transposed
    conv's phases read their four live taps and weight taps (_T_TAPS)."""
    name, shape, o = "fused_conv3x3_bn_relu", (1, 4, 4, 72), 8
    x, kern, s, t = _data(shape, o, 3, seed=1)
    _, _, loads = conv_wg_replay(name, _bf16(x), _bf16(kern), s, t, False)
    a_coords = [cd for _, kind, cd in loads if kind == "A"]
    want = [(64 * ch, dx, dy, 0) for dy in (-1, 0, 1) for dx in (-1, 0, 1) for ch in (0, 1)]
    assert a_coords == want
    b_coords = [cd for _, kind, cd in loads if kind == "B"]
    assert b_coords == [(0, 64 * ch, tap) for tap in range(9) for ch in (0, 1)]
    # the transposed conv: phase (u, v) reads rows i + u - 1 + ta and columns
    # j + v - 1 + tb against weight tap (2 ta + u) * 4 + 2 tb + v
    name, shape, o = "fused_convT4x4s2_bn_relu", (2, 4, 4, 64), 8
    x, kern, s, t = _data(shape, o, 4, seed=2)
    _, writes, loads = conv_wg_replay(name, _bf16(x), _bf16(kern), s, t, False)
    assert (writes == 1).all()
    a_coords = [cd for _, kind, cd in loads if kind == "A"]
    b_coords = [cd for _, kind, cd in loads if kind == "B"]
    assert len(a_coords) == 16  # four phases x four live taps, one chunk
    for p in range(4):
        u, v = p >> 1, p & 1
        for tap in range(4):
            ta, tb = tap >> 1, tap & 1
            assert a_coords[4 * p + tap] == (0, tb + v - 1, ta + u - 1, 0)
            assert b_coords[4 * p + tap] == (0, 0, (2 * ta + u) * 4 + 2 * tb + v)
            # the JAX kernel's table: phase row u reads kernel row dy + u, dy of _T_TAPS[0]
            assert (2 * ta + u) == pc._T_TAPS[0][ta][1] + u
            assert (2 * tb + v) == pc._T_TAPS[v][tb][1]
    # the 4x4/s2 conv: output pixel (i, j) reads input (2 i + ky - 1, 2 j + kx - 1)
    # through a box of every second pixel, started at (2 x0 + kx - 1, 2 y0 + ky - 1):
    # tile 0 at -1 (zero filled) and past the end (W = 4: column 4 at kx = 3),
    # two 64-channel chunks of C = 72, 16 weight taps in HWIO order
    name, shape, o = "fused_conv4x4s2_bn_relu", (1, 4, 4, 72), 8
    x, kern, s, t = _data(shape, o, 4, seed=3)
    got, writes, loads = conv_wg_replay(name, _bf16(x), _bf16(kern), s, t, False)
    assert (writes == 1).all() and fc.plan_wg(name, *shape, o)[:3] == (2, 2, 1)
    a_coords = [cd for _, kind, cd in loads if kind == "A"]
    assert a_coords == [(64 * ch, kx - 1, ky - 1, 0)
                        for ky in range(4) for kx in range(4) for ch in (0, 1)]
    b_coords = [cd for _, kind, cd in loads if kind == "B"]
    assert b_coords == [(0, 64 * ch, tap) for tap in range(16) for ch in (0, 1)]
    # a box of NaN outside the image would make the output NaN: the pad of 1
    # reads 0 (the output's corner takes 9 of its 16 taps from inside)
    want = fc.PLAIN[name](*(torch.from_numpy(a).bfloat16() for a in (_bf16(x), _bf16(kern))),
                          torch.from_numpy(s), torch.from_numpy(t), False)
    assert fc.compare_bf16(torch.from_numpy(got).bfloat16(), want)["of_bound"] <= 1.0


def test_conv_wg_bf16_swizzle_and_descriptors():
    """The 128-byte swizzle TMA writes is the one the descriptors read: A's
    K-major operand of consumer warpgroup wg at k step k is rows 64 wg..
    of the box, channels 16 k.., and B's MN-major operand is weight rows
    16 k.. (k), outputs 0..n across both 64-wide boxes; every 8-row group of
    A and of B sits on 8 distinct 16-byte bank groups per k chunk."""
    # A: row r, channel c of a slot landed at swizzle(r * ar + 2 c), ar the
    # k-group's row bytes (64 channels: 128, 16 channels: 32)
    for ar, code in ((128, 1), (32, 3)):
        for wg in range(2):
            for k in range(ar // 32):
                d = _desc(wg * 64 * ar + 32 * k, 16, 8 * ar, code)
                assert d >> 62 == code and (d >> 16) & 0x3FFF == 1
                assert (d >> 32) & 0x3FFF == 8 * ar // 16
                addr = _a_operand_addrs(d)
                m, kk = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
                np.testing.assert_array_equal(
                    addr, _swizzle((64 * wg + m) * ar + 2 * (16 * k + kk), ar))
                if ar == 128:  # rows 8g..8g+7 of one 16-byte chunk: 8 bank groups
                    for g in range(8):
                        assert len(np.unique((addr[8 * g: 8 * g + 8, 0] // 16) % 8)) == 8
    # B: box j holds outputs 64 j.., weight row c at c * rb, under rb's swizzle
    for bn in (16, 64, 128):
        rb = min(bn, 64) * 2
        layout = {128: 1, 32: 3}[rb]
        for k in range(4):
            d = _desc(16 * rb * k, 64 * rb, 8 * rb, layout)
            addr = _b_operand_addrs(d, bn)
            kk, n = np.meshgrid(np.arange(16), np.arange(bn), indexing="ij")
            landed = (n // 64) * 64 * rb + (16 * k + kk) * rb + (n % 64) * 2
            np.testing.assert_array_equal(addr, _swizzle(landed, rb))
    # the descriptor's fields do not overflow: 14 bits of address >> 4
    assert (1024 + 6 * (16384 + 16384) + 96) >> 4 < (1 << 14)


def test_conv_wg_bf16_ring_stage_parity_sequence():
    stages = 6
    seq = _ring(20, stages)
    assert seq[:7] == [(0, 0), (1, 0), (2, 0), (3, 0), (4, 0), (5, 0), (0, 1)]
    assert seq[12] == (0, 0) and seq[19] == (1, 1)
    # a fresh barrier: the producer's first wait (parity 1) passes, the
    # consumers' (parity 0) waits for the data
    full, empty = _Mbar(1), _Mbar(8)
    assert empty.try_wait(1) and not full.try_wait(0)
    full.expect_tx(100)
    assert not full.try_wait(0)  # arrived, bytes outstanding
    full.complete_tx(100)
    assert full.try_wait(0) and not full.try_wait(1)
    for _ in range(7):
        empty.arrive()
    assert not empty.try_wait(0)  # seven of eight consumer warps
    empty.arrive()
    assert empty.try_wait(0) and not empty.try_wait(1)
    with pytest.raises(AssertionError):
        _Mbar(1).complete_tx(1)  # more bytes than announced


def test_conv_wg_bf16_epilogue_map_skips_rows_past_the_batch():
    # 11 images in boxes of 8 (4x4): rows 48.. of the second tile are images
    # 11..15, past the batch: stored nowhere, and every real output element
    # once, through the transposed conv's strided pixels too
    for name, o in (("fused_conv3x3_bn_relu", 8), ("fused_convT4x4s2_bn_relu", 24)):
        shape = (11, 4, 4, 64)
        plan = fc.plan_wg(name, *shape, o)
        assert (plan.wb, plan.th, plan.nb) == (4, 4, 8)
        x, kern, s, t = _data(shape, o, 3 if "3x3" in name else 4, seed=9)
        got, writes, _ = conv_wg_replay(name, _bf16(x), _bf16(kern), s, t, False)
        assert (writes == 1).all() and not np.isnan(got).any()


# which canonical bf16 #1/#6 launches run conv_wg_bf16, per batch: none at
# B = 1 and 16 (below the measured cut), and at B = 512 and 1000 these
# (kernel, H = W, C, O); every other canonical shape runs conv_tc_bf16
_WG_ROUTED = {
    512: {("3x3", 4, 128, 848), ("3x3", 4, 848, 848), ("3x3", 4, 1696, 848),
          ("3x3", 4, 848, 128), ("3x3", 4, 848, 1696), ("3x3", 8, 128, 424),
          ("3x3", 8, 424, 424), ("3x3", 8, 424, 128), ("3x3", 16, 64, 64),
          ("3x3", 16, 128, 128), ("3x3", 16, 256, 256), ("3x3", 32, 16, 64),
          ("3x3", 32, 64, 16), ("3x3", 32, 64, 64), ("3x3", 32, 128, 128), ("3x3", 64, 16, 16),
          ("3x3", 64, 16, 64), ("3x3", 64, 64, 16), ("3x3", 64, 64, 64), ("T", 16, 128, 64),
          ("T", 8, 424, 256), ("T", 16, 256, 128), ("T", 32, 128, 64), ("T", 8, 128, 64),
          # #5 as the input gradient of the UpBlocks' transposed convs (dx_up1..3,
          # dy_up2), and forward in the HR DownBlock ex_down3
          ("4x4s2", 16, 256, 424), ("4x4s2", 32, 64, 128), ("4x4s2", 32, 128, 256),
          ("4x4s2", 64, 64, 128), ("4x4s2", 16, 64, 128)},
}
_WG_ROUTED[1000] = _WG_ROUTED[512] | {("3x3", 8, 128, 128), ("3x3", 8, 128, 64),
                                      ("T", 16, 64, 16), ("4x4s2", 32, 16, 64)}


@pytest.mark.parametrize("batch", [1, 16, 512, 1000])
def test_plan_wg_and_routing_at_every_canonical_shape(batch):
    """Serving (B = 1 and 16), training (B = 512) and the 1000-draw decode,
    forward and input-gradient shapes: the plan's box holds at most 128
    pixels, in whole rows when W <= 128, the ring fits in shared memory, the
    grid is persistent; the routing is the table above."""
    routed = set()
    for name, h, w, c, o in _CANONICAL:
        if name not in fc.WG_KERNELS:
            assert not fc.wg_route(name, (batch, h, w, c), o)
            continue
        plan = fc.plan_wg(name, batch, h, w, c, o)
        ow, oh = (w // 2, h // 2) if name == "fused_conv4x4s2_bn_relu" else (w, h)
        assert plan.wb * plan.th * plan.nb <= fc.WG_BM and plan.wb == min(ow, fc.WG_BM)
        assert plan.nb == 1 or plan.th == oh
        assert plan.kc == (16 if c <= 16 else 64)
        slot = 128 * 2 * plan.kc + plan.kc * plan.bn * 2
        assert 1024 + plan.stages * slot + 16 * plan.stages <= SMEM_LIMIT
        assert plan.bn >= min(o, 128) or o > 128
        assert plan.grid == min(plan.tiles, SMS)
        x = torch.empty((batch, h, w, c), dtype=torch.bfloat16)
        kern = torch.empty((3 if "3x3" in name else 4,) * 2 + (c, o), dtype=torch.bfloat16)
        assert fc.wg_eligible(name, x, kern) == fc.wg_route(name, x.shape, o)
        assert fc.wg_supported(name, x, kern) == (c % 8 == 0 and o % 8 == 0)
        if fc.wg_route(name, x.shape, o):
            routed.add(({"fused_conv3x3_bn_relu": "3x3", "fused_conv4x4s2_bn_relu": "4x4s2"}
                        .get(name, "T"), h, c, o))
    assert routed == _WG_ROUTED.get(batch, set())
    # a float32 launch never does
    x = torch.empty((batch, 16, 16, 256))
    assert not fc.wg_eligible("fused_conv3x3_bn_relu", x, torch.empty((3, 3, 256, 256)))


def test_wg_route_of_the_4x4s2_conv_at_the_training_steps_shapes():
    """B = 512: #5's input-gradient launch of dx_up3 (the gradient of the
    last UpBlock's convT, 137 GFLOP) goes to conv_wg_bf16; dy_up1's (O = 53)
    and the 4-channel inputs of the *_down1 DownBlocks stay on conv_tc_bf16,
    which takes any C and O, and so do the DownBlocks' small forward launches
    below the cut."""
    name = "fused_conv4x4s2_bn_relu"
    assert fc.wg_route(name, (512, 64, 64, 64), 128)            # dx_up3
    assert not fc.wg_route(name, (512, 16, 16, 128), 53)        # dy_up1: O % 8 != 0
    assert not fc._wg_takes(name, (512, 16, 16, 128), 53)
    for hw in (32, 64):                                         # ey_down1, ex_down1: C = 4
        assert not fc._wg_takes(name, (512, hw, hw, 4), 16)
        assert not fc.wg_route(name, (512, hw, hw, 4), 16)
    assert not fc.wg_route(name, (512, 8, 8, 64), 128)          # below the cut
    # odd H or W: the kernel does not take it (JAX #5 requires even ones)
    assert not fc._wg_takes(name, (512, 65, 64, 64), 128)
    assert not fc._wg_takes(name, (512, 64, 63, 64), 128)


def test_conv_wg_bf16_source_is_wgmma_fed_by_tma():
    src = (Path(fc.__file__).resolve().parent.parent / "csrc" / fc.WG_SOURCE).read_text()
    for needle in ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                   "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes",
                   "mbarrier.try_wait.parity", "setmaxnreg.inc.sync.aligned.u32 232",
                   "setmaxnreg.dec.sync.aligned.u32 40", "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE",
                   "__launch_bounds__(NTHREADS, 1)", "int svrs_conv4x4s2_wg_bf16(",
                   "const cuuint32_t step[4] = {1, (cuuint32_t)S, (cuuint32_t)S, 1};"):
        assert needle in src
    # one instance per (KC, BN) of the plan, with its stage count
    for (kc, bn), stages in fc.WG_STAGES.items():
        if kc == 64:
            assert f"if (bn == {bn} && stages == {stages}) return launch_wg<MODE, {bn}, 64, " \
                   f"{stages}>" in src
        else:
            assert stages == 8 and f"if (bn == {bn}) return launch_wg<MODE, {bn}, 16, 8>" in src
