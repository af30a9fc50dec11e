"""The W8A8 tensor-core kernels (``int8_tc`` and ``act_quant`` in
``csrc/int8_conv.cu``: the 3x3 conv #9, the strided 4x4 conv #11 and the
transposed conv #12 on ``mma.sync.m16n8k32`` s8, fed by one quantize pass)
replayed on the CPU.

The kernels run only on the card (``tests/test_torch_port_gpu.py``). Here a
numpy replay of each launch is held against the plain versions, which the
other int8 tests hold against the JAX package:

- ``act_quant``: one thread per 16 channels of a pixel, 16-byte reads where
  C % 4 == 0, the group scale of the pixel's image, a true division, round
  half to even, the 16-channel zero padding: byte for byte equal to
  ``act_quant_plain`` (``quantize_act`` padded and cast), every input
  element read once, values exactly on a rounding boundary included;
- ``int8_tc``: the launch plan (tiles, K splits, phases), block by block
  with ``blockIdx.z = phase * splits + split``, the strided conv's rows
  and columns read from 2 oy - 1 and 2 ox - 1, K in words of four channels
  in the order tap * Cp/4 + word through the cp.async ring, k / (Cp/4) by
  multiply-high, the zero-filled border and K tail, the padded weight
  packing, the m16n8k32 s8 fragment maps (A a0..a3, B b0/b1, C c0..c3 at
  the lanes PTX assigns them), the skipped sub-steps past K, the epilogue
  with the row's group scale and the exact int32 split-K sum: equal to the
  plain version bit for bit, every output element written once, at ragged
  and canonical channel widths and at every tile.

The bfloat16 instances (``x`` and the output bfloat16; ``*_bf16`` entry
points) replay the same launches with the bfloat16 loaders and store map:
``act_quant`` reading a pixel's 16 channels as two 16-byte words of eight
where C % 8 == 0 and one masked 2-byte load a channel otherwise (C = 3 .. 7,
130: a channel run on a 2-byte boundary), giving the float32 pass's bytes on
the upcast tensor; ``int8_tc`` storing each epilogue value rounded once to
bfloat16, a pair of neighbours as one 4-byte store at an even element
offset where O is even (the transposed conv's phase rows included), element
by element where O is odd, in the direct epilogue and in the K-split reduce
alike: equal to the bfloat16 plain version bit for bit.

Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_vae_rs_tpu.ops import pallas_int8 as p8
from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.ops import fused_int8 as f8
from simple_vae_rs_tpu_torch.ops import quantize as qz

SMEM_LIMIT = 232448  # bytes of shared memory one block may have on the H100 (227 KB)
SMS = 132


def _cdiv(a, b):
    return -(-a // b)


def div_w_params(c4):
    """``make_geo``'s constants for ``div_w`` (k / C4 by a multiply-high; C4
    = round_up(C, 16) / 4 >= 4)."""
    assert c4 >= 4
    l = (c4 - 1).bit_length()  # ceil(log2 C4)
    return ((1 << (31 + l)) + c4 - 1) // c4, l - 1


def div_w(k, c4):
    """``div_w``: ``umulhi(k, c_mul) >> c_shr`` in 32-bit unsigned arithmetic."""
    mul, shr = div_w_params(c4)
    k = np.asarray(k, np.uint64)
    return ((k * np.uint64(mul)) >> np.uint64(32 + shr)).astype(np.int64)


def _tap(name, t, p):
    """tap_geometry: input offsets (relative to oy, ox) and the weight tap of
    GEMM tap ``t`` in phase ``p``."""
    if name == "int8_conv3x3_bn_relu":
        return t // 3 - 1, t % 3 - 1, t
    if name == "int8_conv4x4s2_bn_relu":
        return (t >> 2) - 1, (t & 3) - 1, t
    ta, tb, u, v = t >> 1, t & 1, p >> 1, p & 1  # the transposed conv's _T_TAPS
    return ta + u - 1, tb + v - 1, (2 * ta + u) * 4 + 2 * tb + v


def _act_scale(amax):
    return np.maximum(np.float32(amax) / np.float32(127.0), np.float32(1e-12)).astype(np.float32)


def _bf16(a):
    """``a`` rounded to bfloat16 (nearest, ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def act_quant_replay(x, amax, act_group, itemsize=4):
    """``act_quant``'s launch in numpy: thread ``e`` quantizes channels
    16j .. 16j+15 of pixel ``e // (Cp/16)`` (16-byte reads of four float32
    or eight bfloat16 channels when C is a multiple of that and x is
    16-byte aligned, else one read a channel, of 4 or 2 bytes) into one
    16-byte word. ``x`` holds float32 values, bfloat16 ones for ``itemsize``
    2 (the kernel upcasts them, exactly). Returns qx as int8 ``(B, H, W,
    Cp)`` and the number of reads of each element of x."""
    vec = 16 // itemsize
    b, h, w, c = x.shape
    cp = f8.padded_channels(c)
    c16 = cp // 16
    group = b if act_group is None else max(1, min(act_group, b))
    xf = x.reshape(-1)
    e = np.arange(b * h * w * c16)
    pix, j = np.divmod(e, c16)
    a = _act_scale(amax)[(pix // (h * w)) // group]
    live = np.minimum(16, c - 16 * j)
    reads = np.zeros(xf.size, np.int64)
    q = np.zeros((e.size, 16), np.int64)
    for i in range(16):
        # vec: 16-byte word i // vec is read when vec * (i // vec) < live, and
        # C % vec == 0 makes that the same as i < live
        rd = (vec * (i // vec) < live) if c % vec == 0 else (i < live)
        if c % vec == 0:  # a word's bytes start 16-byte aligned
            assert ((pix * c + 16 * j + vec * (i // vec)) * itemsize % 16 == 0).all()
        idx = pix * c + 16 * j + i
        np.add.at(reads, idx[rd], 1)
        v = np.where(rd, xf[np.where(rd, idx, 0)], np.float32(0)).astype(np.float32)
        q[:, i] = np.where(rd, np.clip(np.rint(v / a), -127, 127), 0)
    return q.astype(np.int8).reshape(b, h, w, cp), reads


def int8_tc_replay(name, x, kq, ks, scale, shift, relu, act_group, itemsize=4):
    """``svrs_int8_tc`` replayed in numpy: the quantize pass, then the conv's
    launch block by block over ``blockIdx.z = phase * splits + split`` with
    the plan's tile, then the K-split reduce. Shared memory is tracked cell
    by cell: a fragment read of a cell no copy wrote in that step fails.
    With ``itemsize`` 2 (``svrs_int8_tc_bf16``; ``x`` holds bfloat16
    values) every stored value is rounded to bfloat16 and each store's
    element offset is checked: a pair at an even offset where O is even.
    Returns (output, writes per output element, plan)."""
    b, h, w, c = x.shape
    o = kq.shape[-1]
    cp = f8.padded_channels(c)
    c4 = cp // 4
    group = b if act_group is None else max(1, min(act_group, b))
    m_all, _, k_all, phases = f8.geometry(name, x.shape, o)
    cfg, splits, kchunk = f8.plan_int8_tc(m_all, o, k_all, phases)
    bm, bn, wm_t, wn_t, stages = f8.TC_TILES[cfg]
    warps_m, warps_n = bm // wm_t, bn // wn_t
    nt = warps_m * warps_n * 32
    bk = f8.TC_BKW
    kq_n, nq = bk // 4, bn // 4
    a_rows, b_vecs = bm * kq_n // nt, _cdiv(bk * nq, nt)
    a_ld, b_ld = bk + 4, bn + 8
    mi_n, ni_n = wm_t // 16, wn_t // 8
    assert f8.tc_smem_bytes(cfg) == 4 * stages * (bm * a_ld + bk * b_ld)

    amax = f8.act_absmax_plain(torch.from_numpy(x), act_group).numpy()
    qx, _ = act_quant_replay(x, amax, act_group, itemsize)
    qw = qx.reshape(-1).view(np.int32)  # words of four channels, C4 a pixel
    wq = f8.pack_kernel_q(torch.from_numpy(kq)).numpy().reshape(-1)  # (rows, O) words
    assert wq.size == kq.shape[0] * kq.shape[1] * c4 * o
    stride = 2 if name == "int8_conv4x4s2_bn_relu" else 1
    ho, wo = h // stride, w // stride
    out_shape = f8.output_shape(name, x.shape, o)
    vec_b = o % 4 == 0

    def out_offset(p, m, n):
        if phases == 1:
            return m * o + n
        bb, r = np.divmod(m, ho * wo)
        i, j = np.divmod(r, wo)
        return ((bb * 2 * ho + 2 * i + (p >> 1)) * 2 * wo + 2 * j + (p & 1)) * o + n

    def weight_row(kr, p):
        if phases == 1:
            return kr
        t = div_w(kr, c4)
        return kr + (_tap(name, t, p)[2] - t) * c4

    def epilogue(acc, m, n):
        assert np.abs(acc).max(initial=0) < 2**31  # exact in int32
        a = _act_scale(amax)[(m // (ho * wo)) // group]
        mult = ((a * ks[n]).astype(np.float32) * scale[n]).astype(np.float32)
        y = (acc.astype(np.float32) * mult).astype(np.float32) + shift[n]
        y = np.maximum(y, np.float32(0)) if relu else y
        return _bf16(y) if itemsize == 2 else y  # the one rounding to the output type

    tid = np.arange(nt)
    kq_i = tid % kq_n
    rows = tid[:, None] // kq_n + np.arange(a_rows)[None, :] * (nt // kq_n)  # (nt, a_rows)
    lane = np.arange(32)
    gq, tq = lane >> 2, lane & 3
    byte = np.arange(4)
    out = np.zeros(int(np.prod(out_shape)), np.float32)
    writes = np.zeros(out.size, np.int64)
    ws = np.zeros((splits, phases, m_all, o), np.int64)
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
                a_sm = np.zeros((stages, bm * a_ld), np.int64)
                b_sm = np.zeros((stages, bk * b_ld), np.int64)
                a_ok = np.zeros((stages, bm * a_ld), bool)
                b_ok = np.zeros((stages, bk * b_ld), bool)

                def load(slot, k0):
                    a_ok[slot] = b_ok[slot] = False
                    a_sm[slot] = b_sm[slot] = -(1 << 40)  # no int32 word
                    dst = rows * a_ld + 4 * kq_i[:, None]
                    k = k0 + 4 * kq_i  # words k .. k+3: 16 channels of one tap
                    kv = k < kend
                    t = np.where(kv, div_w(k, c4), 0)
                    cc = k - t * c4
                    dy, dx, _ = _tap(name, t, p)
                    iy, ix = a_y + dy[:, None], a_x + dx[:, None]
                    v = kv[:, None] & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                    src = (a_pix + (dy * w + dx)[:, None]) * c4 + cc[:, None]
                    for j in range(4):  # one 16-byte cp.async, zero-filled when not v
                        a_sm[slot, dst + j] = np.where(v, qw[np.where(v, src + j, 0)], 0)
                        a_ok[slot, dst + j] = True
                    b_dst = []
                    for jv in range(b_vecs):
                        e = tid + jv * nt
                        e = e[e < bk * nq]  # the last round may stage fewer groups
                        kk, nqi = np.divmod(e, nq)
                        kr, n = k0 + kk, n0 + 4 * nqi
                        kvb = kr < kend
                        row = np.where(kvb, weight_row(np.where(kvb, kr, 0), p), 0) * o
                        for q in range(4):
                            vb = kvb & ((n < o) if vec_b else (n + q < o))
                            b_sm[slot, kk * b_ld + 4 * nqi + q] = np.where(
                                vb, wq[np.where(vb, row + n + q, 0)], 0)
                            b_ok[slot, kk * b_ld + 4 * nqi + q] = True
                        b_dst.append(kk * b_ld + 4 * nqi)
                    # every cell of both tiles is written once; the pads are not
                    a_cells = (dst[..., None] + np.arange(4)).ravel()
                    b_cells = (np.concatenate(b_dst)[:, None] + np.arange(4)).ravel()
                    assert len(np.unique(a_cells)) == a_cells.size == bm * bk
                    assert len(np.unique(b_cells)) == b_cells.size == bk * bn

                def words(sm, ok, idx):
                    assert ok[idx].all()  # a read of a cell this step's copies wrote
                    return sm[idx].astype(np.uint32).view(np.int8).reshape(idx.shape + (4,))

                acc = np.zeros((warps_m, warps_n, mi_n, ni_n, 32, 4), np.int64)
                for st in range(stages - 1):
                    if st < nsteps:
                        load(st, kbeg + st * bk)
                for step in range(nsteps):
                    nxt = step + stages - 1
                    if nxt < nsteps:
                        load(nxt % stages, kbeg + nxt * bk)
                    slot = step % stages
                    live = kend - (kbeg + step * bk)
                    for kk in range(0, bk, 8):
                        if kk >= live:
                            break  # a sub-step wholly past the end of K
                        for wmi in range(warps_m):
                            for wni in range(warps_n):
                                ap = ((wmi * wm_t + gq) * a_ld + tq)[None, :] \
                                    + (np.arange(mi_n) * 16 * a_ld)[:, None] + kk
                                bp = (tq * b_ld + wni * wn_t + gq)[None, :] \
                                    + kk * b_ld + (np.arange(ni_n) * 8)[:, None]
                                a_regs = [words(a_sm[slot], a_ok[slot], ap + off)
                                          for off in (0, 8 * a_ld, 4, 8 * a_ld + 4)]
                                b_regs = [words(b_sm[slot], b_ok[slot], bp + off)
                                          for off in (0, 4 * b_ld)]
                                # each lane's registers placed where the m16n8k32
                                # .s8 fragment layout says they sit: A row gq (+8),
                                # k bytes 4tq..4tq+3 (+16); B k bytes 4tq.. (+16),
                                # column gq
                                a_hw = np.zeros((mi_n, 16, 32), np.int64)
                                for reg, (ro, ko) in enumerate(((0, 0), (8, 0), (0, 16),
                                                                (8, 16))):
                                    a_hw[:, (gq + ro)[:, None], ko + 4 * tq[:, None] + byte] = \
                                        a_regs[reg]
                                b_hw = np.zeros((ni_n, 32, 8), np.int64)
                                for reg, ko in enumerate((0, 16)):
                                    b_hw[:, ko + 4 * tq[:, None] + byte, gq[:, None]] = \
                                        b_regs[reg]
                                d = np.einsum("mik,nkj->mnij", a_hw, b_hw)
                                acc[wmi, wni] += np.stack(
                                    [d[:, :, gq, 2 * tq], d[:, :, gq, 2 * tq + 1],
                                     d[:, :, gq + 8, 2 * tq], d[:, :, gq + 8, 2 * tq + 1]], -1)
                # epilogue: the row of pixel m with its group's scale, then its columns
                for wmi in range(warps_m):
                    for wni in range(warps_n):
                        for mi in range(mi_n):
                            for hh in range(2):
                                m = m0 + wmi * wm_t + mi * 16 + gq + 8 * hh
                                for ni in range(ni_n):
                                    n = n0 + wni * wn_t + ni * 8 + 2 * tq
                                    if splits == 1 and o % 2 == 0:  # pairs: an aligned store
                                        ok = (m < m_all) & (n < o)
                                        assert (out_offset(p, m[ok], n[ok]) % 2 == 0).all()
                                    for col, reg in ((n, 2 * hh), (n + 1, 2 * hh + 1)):
                                        ok = (m < m_all) & (n < o) & (col < o)
                                        val = acc[wmi, wni, mi, ni, :, reg][ok]
                                        mo, co = m[ok], col[ok]
                                        if splits == 1:
                                            dst = out_offset(p, mo, co)
                                            out[dst] = epilogue(val, mo, co)
                                            np.add.at(writes, dst, 1)
                                        else:
                                            ws[s, p, mo, co] = val
                                            np.add.at(ws_writes, (s, p, mo, co), 1)
    if splits > 1:  # splitk_reduce: exact int32 sums, then the epilogue
        assert (ws_writes == 1).all()
        tot = ws.sum(axis=0)
        pp, mm, nn = np.meshgrid(np.arange(phases), np.arange(m_all), np.arange(o),
                                 indexing="ij")
        dst = out_offset(pp, mm, nn).ravel()
        out[dst] = epilogue(tot.ravel(), mm.ravel(), nn.ravel())
        np.add.at(writes, dst, 1)
    return out.reshape(out_shape), writes.reshape(out_shape), (cfg, splits, kchunk)


def _data(name, shape, o, seed):
    """x with images of different ranges (so the grouping of the scale
    matters), an int8 kernel with its scales, and the affine."""
    rng = np.random.default_rng(seed)
    k = 3 if name == "int8_conv3x3_bn_relu" else 4
    x = rng.standard_normal(shape).astype(np.float32)
    x *= rng.uniform(0.25, 2.25, (shape[0], 1, 1, 1)).astype(np.float32)
    kern = rng.standard_normal((k, k, shape[-1], o)).astype(np.float32) / np.sqrt(k * k * shape[-1])
    kq, ks = qz.quantize_rtn(torch.from_numpy(kern))
    scale = rng.uniform(0.5, 1.5, o).astype(np.float32)
    shift = rng.standard_normal(o).astype(np.float32)
    return x, kq.numpy(), ks.numpy(), scale, shift


# (name, x shape, O, relu, act_group, tile config the plan picks): C = 3, 5,
# 6, 7, 130, 300 and 424 (padded to 16, 16, 16, 16, 144, 304, 432), O = 5,
# 9, 13, 30, 70 and 200 (weight rows that are not whole 16-byte words: the
# 4-byte B path), groups smaller than the batch with a short last group,
# odd H and W, K splits in both modes, the canonical deep widths (424 ->
# 424 / 256, 256 -> 128) and the 64x64 tail's (16 -> 4, 64 -> 16), and
# every tile configuration in both modes
REPLAY_CASES = [
    ("int8_conv3x3_bn_relu", (3, 5, 7, 3), 5, True, None, 2),
    ("int8_conv3x3_bn_relu", (5, 9, 11, 6), 13, False, 2, 2),
    ("int8_conv3x3_bn_relu", (3, 6, 7, 5), 30, True, 2, 1),
    ("int8_conv3x3_bn_relu", (2, 7, 9, 16), 64, False, 1, 1),
    ("int8_conv3x3_bn_relu", (1, 9, 9, 130), 70, True, None, 0),
    ("int8_conv3x3_bn_relu", (1, 4, 4, 300), 200, False, None, 3),
    ("int8_conv3x3_bn_relu", (1, 4, 4, 424), 424, False, None, 3),
    ("int8_conv3x3_bn_relu", (2, 8, 8, 16), 4, False, 1, 2),
    ("int8_conv3x3_bn_relu", (2, 8, 8, 64), 16, True, None, 2),
    ("int8_convT4x4s2_bn_relu", (2, 3, 5, 7), 9, True, None, 3),
    ("int8_convT4x4s2_bn_relu", (4, 4, 4, 130), 70, False, 3, 3),
    ("int8_convT4x4s2_bn_relu", (3, 5, 6, 5), 13, True, 2, 2),
    ("int8_convT4x4s2_bn_relu", (2, 7, 5, 6), 24, False, None, 1),
    ("int8_convT4x4s2_bn_relu", (1, 9, 9, 64), 200, True, None, 0),
    ("int8_convT4x4s2_bn_relu", (2, 6, 6, 256), 128, True, None, 0),
    ("int8_convT4x4s2_bn_relu", (1, 4, 4, 424), 256, True, None, 3),
    # the strided 4x4 conv (#11): odd H and W (the last row and column of
    # the input unread), C = 3, 4 (Cp = 16: 12 of every 16 bytes padding),
    # 5, 64 and 130, O = 5, 13, 24, 70, 128 and 200, a group smaller than
    # the batch with a short last group, K splits and every tile
    ("int8_conv4x4s2_bn_relu", (3, 7, 9, 3), 5, True, None, 3),
    ("int8_conv4x4s2_bn_relu", (5, 9, 11, 4), 13, False, 2, 2),
    ("int8_conv4x4s2_bn_relu", (3, 11, 12, 130), 24, True, None, 1),
    ("int8_conv4x4s2_bn_relu", (2, 12, 13, 5), 70, True, 1, 0),
    ("int8_conv4x4s2_bn_relu", (1, 8, 8, 130), 200, False, None, 3),
    ("int8_conv4x4s2_bn_relu", (2, 16, 16, 64), 128, True, None, 0),
]


@pytest.mark.parametrize("case", REPLAY_CASES, ids=lambda c: "-".join(map(str, c[:5])))
def test_int8_tc_index_arithmetic_matches_plain(case):
    name, shape, o, relu, group, cfg = case
    x, kq, ks, s, t = _data(name, shape, o, seed=sum(shape) + o)
    got, writes, (plan_cfg, _, _) = int8_tc_replay(name, x, kq, ks, s, t, relu, group)
    assert plan_cfg == cfg
    assert (writes == 1).all()  # every output element once
    want = f8.PLAIN[name](*map(torch.from_numpy, (x, kq, ks, s, t)), relu, group).numpy()
    # exact integer sums and the same float32 epilogue: equal to the last bit
    np.testing.assert_array_equal(got, want)


# every case above: odd O (5, 9, 13: element stores), even O with the
# transposed conv's phase rows, K splits (the reduce's stores) in all three
# modes, C % 8 == 0 and not
BF16_REPLAY_CASES = REPLAY_CASES


@pytest.mark.parametrize("case", BF16_REPLAY_CASES, ids=lambda c: "-".join(map(str, c[:5])))
def test_bf16_int8_tc_index_arithmetic_matches_plain(case):
    """The bfloat16 instance's launch against the plain version on bfloat16
    x, bit for bit: the same scales and integers (the upcast is exact), the
    same float32 epilogue, one rounding to bfloat16."""
    name, shape, o, relu, group, cfg = case
    x, kq, ks, s, t = _data(name, shape, o, seed=sum(shape) + o)
    x = _bf16(x)
    got, writes, (plan_cfg, _, _) = int8_tc_replay(name, x, kq, ks, s, t, relu, group, 2)
    assert plan_cfg == cfg
    assert (writes == 1).all()  # every output element once
    xb = torch.from_numpy(x).bfloat16()
    want = f8.PLAIN[name](xb, *map(torch.from_numpy, (kq, ks, s, t)), relu, group)
    assert want.dtype == torch.bfloat16
    np.testing.assert_array_equal(got, want.float().numpy())
    # the float32 plain version on the upcast x, rounded once: the same bits
    want32 = f8.PLAIN[name](torch.from_numpy(x), *map(torch.from_numpy, (kq, ks, s, t)), relu,
                            group)
    assert torch.equal(want, want32.bfloat16())


def test_bf16_int8_replays_cover_the_store_map():
    """The bfloat16 cases hold odd O, even O in every mode, and K splits in
    every mode (the reduce's stores), and C on both quantize loaders."""
    seen = set()
    for name, shape, o, _, _, _ in BF16_REPLAY_CASES:
        splits = f8.plan_int8_tc(*f8.geometry(name, shape, o))[1]
        seen |= {(name, o % 2, splits > 1, shape[-1] % 8 == 0)}
    for name in f8.TC_KERNELS:
        assert {(k[1], k[2]) for k in seen if k[0] == name} >= {(0, False), (0, True)}
        assert any(k[0] == name and k[1] == 1 for k in seen)
    assert {k[3] for k in seen} == {False, True}


def test_int8_tc_replay_splits_k_in_both_modes():
    # the K-split cases above really split, in each mode
    for name, shape, o in (("int8_conv3x3_bn_relu", (1, 4, 4, 424), 424),
                           ("int8_conv3x3_bn_relu", (1, 9, 9, 130), 70),
                           ("int8_conv4x4s2_bn_relu", (3, 11, 12, 130), 24),
                           ("int8_conv4x4s2_bn_relu", (1, 8, 8, 130), 200),
                           ("int8_conv4x4s2_bn_relu", (2, 16, 16, 64), 128),
                           ("int8_convT4x4s2_bn_relu", (2, 6, 6, 256), 128),
                           ("int8_convT4x4s2_bn_relu", (1, 4, 4, 424), 256)):
        m, n, k, phases = f8.geometry(name, shape, o)
        cfg, splits, kchunk = f8.plan_int8_tc(m, n, k, phases)
        assert splits > 1 and (splits - 1) * kchunk < k <= splits * kchunk, (name, shape)


# (x shape, act_group): C % 4 == 0 on the float4 path (16, 64, 424: a last
# 16-channel word with 8 live channels) and C % 4 != 0 on the scalar path
# (3, 5, 7, 130), groups smaller than the batch with a short last group
QUANT_CASES = [((3, 5, 7, 3), None), ((5, 3, 4, 5), 2), ((2, 3, 3, 7), 1), ((3, 4, 4, 16), 2),
               ((2, 3, 5, 64), None), ((2, 2, 3, 130), 1), ((3, 2, 2, 424), 2)]


# C % 8 == 0 (16, 64, 424) on the 16-byte path and C % 8 != 0 (3, 5, 7, 12,
# 130) on the masked 2-byte loads: a channel run on a 2-byte boundary
BF16_QUANT_CASES = QUANT_CASES + [((2, 3, 3, 12), None)]


@pytest.mark.parametrize("shape,act_group", BF16_QUANT_CASES, ids=str)
def test_bf16_act_quant_replay_gives_the_plain_versions_bytes(shape, act_group):
    """The bfloat16 pass: every element read once, the bytes of the float32
    pass on the upcast tensor (the scale from the float32 absmax of the
    same values)."""
    rng = np.random.default_rng(sum(shape) + 1)
    x = rng.standard_normal(shape).astype(np.float32)
    x = _bf16(x * rng.uniform(0.25, 2.25, (shape[0], 1, 1, 1)).astype(np.float32))
    xb = torch.from_numpy(x).bfloat16()
    amax = f8.act_absmax_plain(xb, act_group)
    assert amax.dtype == torch.float32
    assert torch.equal(amax, f8.act_absmax_plain(torch.from_numpy(x), act_group))
    got, reads = act_quant_replay(x, amax.numpy(), act_group, itemsize=2)
    assert (reads == 1).all()
    want = f8.act_quant_plain(xb, amax, act_group)
    np.testing.assert_array_equal(got, want.numpy())
    assert torch.equal(want, f8.act_quant_plain(torch.from_numpy(x), amax, act_group))
    assert torch.equal(f8.act_quant(xb, amax, act_group), want)  # CPU wrapper: the plain version


@pytest.mark.parametrize("shape,act_group", QUANT_CASES, ids=str)
def test_act_quant_replay_gives_the_plain_versions_bytes(shape, act_group):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x *= rng.uniform(0.25, 2.25, (shape[0], 1, 1, 1)).astype(np.float32)
    xt = torch.from_numpy(x)
    amax = f8.act_absmax_plain(xt, act_group)
    got, reads = act_quant_replay(x, amax.numpy(), act_group)
    assert (reads == 1).all()  # every element once
    want = f8.act_quant_plain(xt, amax, act_group)
    assert want.dtype == torch.int8 and want.shape == shape[:3] + (f8.padded_channels(shape[3]),)
    np.testing.assert_array_equal(got, want.numpy())
    # the plain version is the in-kernel quantization, padded and cast
    q, _ = f8.quantize_act(xt, act_group)
    np.testing.assert_array_equal(want[..., :shape[3]].numpy(), q.numpy().astype(np.int8))
    assert not want[..., shape[3]:].any()
    assert torch.equal(f8.act_quant(xt, amax, act_group), want)  # CPU wrapper: the plain version


def test_act_quant_rounds_half_to_even_on_a_boundary():
    """amax 15.875 gives the scale 0.125 exactly, so x = 0.3125 is 2.5 steps:
    on a rounding boundary, which rounds to the even 2 (-2.5 to -2, 3.5 to
    4); the second image (amax 7.9375, scale 0.0625) the same at other
    values. A multiply by a rounded reciprocal of a scale that is not a
    power of two would move such values; a true division does not."""
    x = np.zeros((2, 1, 2, 6), np.float32)
    x[0, 0, 0, :6] = [15.875, 0.3125, -0.3125, 0.4375, 0.0625, -15.875]
    x[1, 0, 1, :5] = [7.9375, 0.15625, 0.21875, -0.21875, 2.0 ** -24]
    xt = torch.from_numpy(x)
    amax = f8.act_absmax_plain(xt, 1)
    assert amax.tolist() == [15.875, 7.9375]
    got, _ = act_quant_replay(x, amax.numpy(), 1)
    want = f8.act_quant_plain(xt, amax, 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0, 0, 0, :6].tolist() == [127, 2, -2, 4, 0, -127]
    assert want[1, 0, 1, :5].tolist() == [127, 2, 4, -4, 0]
    # the TPU kernel's in-kernel quantizer gives the same integers, image by image
    for i in range(2):
        qj, aj = p8._quant_act(jnp.asarray(x[i:i + 1]))
        assert np.float32(aj) == _act_scale(amax.numpy())[i]
        np.testing.assert_array_equal(np.asarray(qj)[0], want[i, ..., :6])


def test_div_w_is_exact_division():
    """The loaders' k / (Cp/4) for every word k the kernels see, at every
    padded width of the canonical model and the ragged cases (Cp = 16 .. 432)
    and at the largest k below 2**31."""
    rng = np.random.default_rng(7)
    for c in (3, 4, 16, 53, 64, 106, 128, 130, 212, 256, 300, 424, 848, 1696):
        c4 = f8.padded_channels(c) // 4
        mul, shr = div_w_params(c4)
        assert c4 % 4 == 0 and 0 <= mul < 2**32 and 0 <= shr < 32
        k = np.concatenate([np.arange(16 * c4 + 64), rng.integers(0, 2**31, 4096),
                            [2**31 - 1, 2**31 - c4]])
        np.testing.assert_array_equal(div_w(k, c4), k // c4)


def test_pack_for_pads_each_tap_to_16_channels():
    """The weight every int8 conv takes: (kh * kw * Cp/4, O) words, channel
    4j + i of tap t in byte i of row t * Cp/4 + j, zero in the padding."""
    kq = torch.from_numpy(
        np.random.default_rng(2).integers(-127, 128, (3, 3, 6, 5)).astype(np.int8))
    words = f8.pack_kernel_q(kq)
    assert words.dtype == torch.int32 and tuple(words.shape) == (9 * 4, 5)
    raw = words.numpy().view(np.int8).reshape(9, 4, 5, 4)
    for tap in range(9):
        for o in range(5):
            got = raw[tap, :, o, :].reshape(-1)
            np.testing.assert_array_equal(got[:6], kq.numpy()[tap // 3, tap % 3, :, o])
            assert not got[6:].any()
    k4 = torch.from_numpy(np.random.default_rng(3).integers(-127, 128, (4, 4, 7, 3)).astype(np.int8))
    raw4 = f8.pack_kernel_q(k4).numpy().view(np.int8).reshape(16, 4, 3, 4)
    assert raw4.shape[:3] == (16, 4, 3)  # 16 taps of Cp/4 = 4 words, for #11 and #12 alike
    for tap in (0, 5, 15):
        got = raw4[tap, :, 2, :].reshape(-1)
        np.testing.assert_array_equal(got[:7], k4.numpy()[tap // 4, tap % 4, :, 2])
        assert not got[7:].any()


@pytest.mark.parametrize("cls,cin,cout,tail,kernel,rows", [
    ("Conv3x3", 5, 7, None, "int8_conv3x3_bn_relu", 9 * 4),
    ("DownBlock", 5, 7, "downsample", "int8_conv4x4s2_bn_relu", 16 * 4),
    ("UpBlock", 200, 7, "upsample", "int8_convT4x4s2_bn_relu", 16 * 52),
])
def test_each_module_keeps_the_packing_its_kernel_takes(cls, cin, cout, tail, kernel, rows):
    mod = getattr(blocks, cls)(cin, cout)
    conv = getattr(mod, tail) if tail else mod
    rng = np.random.default_rng(4)
    q = rng.integers(-127, 128, tuple(conv.kernel.shape)).astype(np.int8)
    conv.set_quant(q, np.ones(conv.kernel.shape[-1], np.float32))
    assert conv.int8_kernel == kernel
    assert tuple(conv.kernel_p.shape) == (rows, cout)
    assert torch.equal(conv.kernel_p, f8.pack_kernel_q(conv.kernel_q))


# Every int8 conv geometry of the canonical Cond_SRVAE (cr=1.2, ps=64) per
# image, as (kernel, H, W, C, O): the W8A8 decoder (serving) and the
# DownBlocks' 3x3 convs and strided 4x4 tails of the block path
_CANONICAL = [
    ("int8_conv3x3_bn_relu", hw, hw, c, o) for hw, c, o in [
        (8, 424, 424), (16, 256, 256), (32, 128, 128), (64, 64, 64), (64, 64, 16),
        (64, 16, 16), (64, 16, 4), (32, 4, 4), (16, 16, 16), (8, 64, 64), (64, 4, 4),
        (32, 16, 16), (16, 64, 64)]
] + [("int8_convT4x4s2_bn_relu", 8, 8, 424, 256), ("int8_convT4x4s2_bn_relu", 16, 16, 256, 128)
      ] + [("int8_conv4x4s2_bn_relu", hw, hw, c, o) for c, o, hw in [
          (4, 16, 32), (16, 64, 16), (64, 128, 8), (4, 16, 64), (16, 64, 32), (64, 128, 16)]]


@pytest.mark.parametrize("batch", [16, 1000])
def test_plan_int8_tc_at_every_canonical_shape(batch):
    """``super_resolve`` (B = 16) and the 1000-draw decode: the ring fits in
    shared memory, K is covered by 32-word steps, the tile follows M and N,
    and the card is filled (the transposed conv's four phases counted)
    unless K is too short to split further."""
    for name, h, w, c, o in _CANONICAL:
        m, n, k, phases = f8.geometry(name, (batch, h, w, c), o)
        taps = {"int8_conv3x3_bn_relu": 9, "int8_conv4x4s2_bn_relu": 16}.get(name, 4)
        assert k == taps * f8.padded_channels(c) // 4 and n == o
        cfg, splits, kchunk = f8.plan_int8_tc(m, n, k, phases)
        bm, bn = f8.TC_TILES[cfg][:2]
        assert f8.tc_smem_bytes(cfg) <= SMEM_LIMIT
        assert kchunk % f8.TC_BKW == 0 and (splits - 1) * kchunk < k <= splits * kchunk
        blocks_ = _cdiv(m, bm) * _cdiv(n, bn) * phases
        if blocks_ >= SMS:
            assert splits == 1
        else:
            assert blocks_ * splits >= SMS or kchunk < 2 * fc._TC_MIN_SPLIT_K, (name, m, o, k)
        assert (cfg == 3) == (m <= 64)
        if m > 64:
            assert cfg == {True: 2, False: 1 if n <= 64 else 0}[n <= 16]
    # the B = 16 deep layers split K: 8x8x424 has M = 1024 (32 blocks of the wide tile)
    if batch == 16:
        assert f8.plan_int8_tc(*f8.geometry("int8_conv3x3_bn_relu", (16, 8, 8, 424), 424))[1] > 1
        assert f8.plan_int8_tc(*f8.geometry("int8_convT4x4s2_bn_relu", (16, 8, 8, 424), 256))[1] > 1


def test_int8_tc_tiles_meet_the_kernels_static_checks():
    """What the CUDA source's static_asserts and fragment reads need: whole
    warp tiles, whole 16-byte groups per thread, conflict-free fragment reads
    (A's row stride 36 words, B's BN + 8), and a ring that fits."""
    # all three int8 convs, in the C entry point's modes kConv3, kConv4, kConvT
    assert f8.TC_KERNELS == {"int8_conv3x3_bn_relu": 0, "int8_conv4x4s2_bn_relu": 1,
                             "int8_convT4x4s2_bn_relu": 2}
    assert set(f8.TC_KERNELS) == set(f8.PLAIN)
    lane = np.arange(32)
    gq, tq = lane >> 2, lane & 3
    for cfg, (bm, bn, wm, wn, stages) in f8.TC_TILES.items():
        assert bm % wm == 0 and bn % wn == 0 and wm % 16 == 0 and wn % 8 == 0 and bn % 16 == 0
        threads = (bm // wm) * (bn // wn) * 32
        kq = f8.TC_BKW // 4
        assert threads in (128, 256) and threads % kq == 0 and (bm * kq) % threads == 0
        b_ld = bn + 8
        assert len(set(((f8.TC_BKW + 4) * gq + tq) % 32)) == 32
        assert len(set((b_ld * tq + gq) % 32)) == 32
        assert f8.tc_smem_bytes(cfg) <= SMEM_LIMIT
