// Fused conv + per-channel affine + optional ReLU kernels for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of the serving path
// (simple_vae_rs_tpu/ops/pallas_conv.py):
//   svrs_conv3x3        <- fused_conv3x3_bn_relu     (3x3, stride 1, SAME)
//   svrs_conv4x4s2      <- fused_conv4x4s2_bn_relu   (4x4, stride 2, pad 1)
//   svrs_convT4x4s2     <- fused_convT4x4s2_bn_relu  (transposed 4x4, stride 2,
//                                                      pad 1, input-dilated form)
// Each computes out = act(conv(x, W) * scale + shift) in float32, with x and
// out NHWC and W in HWIO layout (kh, kw, C, O), row-major. The same kernels
// compute every conv's input gradient (the adjoint's kernel on the
// flip-swapped weight, scale 1, shift 0).
//
// One design, conv_tc, runs all three: an implicit GEMM with M = output
// pixels (per output phase for the transposed conv), N = O, K = live taps * C
// in the order k = tap * C + c (the HWIO weight's own row order). A block
// owns a BM x BN output tile of one phase (blockIdx.z) and walks K; the A
// operand is the im2col row, gathered on the fly with the kernel's padded and
// strided input coordinates and masked at every edge. The affine and the
// ReLU run in the epilogue, so the output makes one trip to device memory.
// When the output tiles alone leave most SMs idle (the 4x4-spatial prior
// heads: C=1696, O=848, K=15,264 at one image, bound by the 52 MB weight
// read), K is split over blocks that stream disjoint weight slices, and a
// second pass sums the partials (laid out [split][phase][M][O]) in split
// order and applies the epilogue: deterministic, no atomics, the same bits
// every run.
//
// The transposed conv computes each of the four output phases (u, v) from
// its four live taps only (the Pallas kernel's _T_TAPS table): output row
// 2i+u reads input rows i+u-1 and i+u against kernel rows u and u+2, and the
// same for columns (tap_geometry), so K = 4 * C and no dilation zeros are
// stored or multiplied. GEMM row k of phase p reads weight row
// wtap(k / C, p) * C + k % C (weight_row), and the epilogue writes pixel
// (2i+u, 2j+v) (out_offset).
//
// What bounds it: at the 64x64 decoder tail, the training batch and the
// 1000-draw decode the work is operations-bound; float32 FMA on the CUDA
// cores tops out at 67 TFLOP/s, the TF32 tensor cores at 495. TF32 alone
// keeps 10 mantissa bits (about 1e-3 relative), too coarse for the port's
// 1e-4 tolerances, so every operand is split as a = hi + lo with
// hi = rna.tf32(a), lo = rna.tf32(a - hi) (split_tf32), and each product is
// lo*b_hi + hi*b_lo + hi*b_hi on mma.sync.m16n8k8 (3xTF32; the dropped
// lo*lo term is about 2^-22 of |a*b|): at most 495/3 = 165 TFLOP/s of float32
// work. The tensor core's float32 accumulate truncates, which over
// K = 15,264 loses 1e-4 of the sum; so the three products of each 8-deep
// step are summed there and added to the running sum in registers with a
// rounded add (float32 plain-version accuracy, 4 FADDs per 3 MMAs).
// mma.sync and not wgmma: wgmma takes TF32 only with K contiguous in both
// operands, and B here keeps the HWIO weight's N-contiguous rows (no
// transposed copy). Measured on the H100 the 128x128 and 128x64 tiles reach
// 32-40 TFLOP/s of float32 work, a fifth of that bound: per MMA a warp also
// issues the operand splits, the fragment loads and the rounded adds, and
// the three MMAs of one tile depend on each other, with 8-16 warps an SM
// (167 and 142 registers a thread) to hide that.
//
// Layout: A staged as [BM][BK+4] (K contiguous: the channel run of one tap)
// and B as [BK][BN+8] (the weight rows as stored); the padding makes both
// fragment reads hit 32 distinct banks. BK = 32.
// Staging: a ring of STAGES cp.async slots in dynamic shared memory with one
// barrier per 32-deep step, so global latency hides behind the MMAs of the
// slots in flight. When C % 4 == 0, four consecutive k lie in one tap and
// are four contiguous channels, so A moves 16 bytes per cp.async and each
// thread resolves its (tap, channel) with tap_geometry once per step for all
// the rows it stages, not once per element; a tap outside the image is a
// 16-byte zero fill (src-size 0 from a valid dummy address), which is the
// SAME padding. C % 4 != 0 (C = 53, 106 in the canonical model) takes 4-byte
// copies with per-element masks; O % 4 != 0 does the same for B. Every
// k / C in the loaders (the A tap, and the transposed conv's weight row for
// each staged B row) is a multiply-high by a constant the host computes once
// per launch (div_c), not an integer division, so the B loader of the
// transposed conv costs a few integer operations a 16-byte copy. K is padded
// to BK with zero fill only at the end of the K range, so a narrow C (4 or
// 16) wastes no tensor-core work on zeros.
// Tiles (ops/fused_conv.plan_tc, which counts the phases' blocks): 128x128
// (N > 64), 128x64 (N <= 64), 64x16 with all four warps along M (N <= 16:
// N = 4 and 16 at millions of pixels, where the n8 tile past N = 4
// multiplies zeros: a skip's predicates cost more than its MMAs), and 32x128
// for M <= 64 per phase (the weight-bound prior heads, with a K split).
//
// bf16 instances (conv_tc_bf16; the JAX kernels' bf16 operands, as the
// models' dtype=bfloat16 gives them): x, W and out bf16, scale and shift
// float32, the products on mma.sync.m16n8k16 bf16 with float32 accumulation
// (one MMA per 16-deep step where 3xTF32 issues three per 8-deep step; the
// bf16 dense peak is 989 TFLOP/s). A bf16 x bf16 product is exact in float32,
// so no operand split is needed; each 64-deep step's four MMAs are summed in
// the tensor core and added to the running sum with a rounded add, as above.
// The epilogue is acc * scale + shift, the ReLU, then one round to nearest
// even to bf16 (__float2bfloat16_rn); K-split partials stay float32 in the
// workspace and the reduce rounds once. The geometry, the modes, the tile
// configurations, the phase layout and the split-K plan are the float32
// kernel's; BK = 64 (twice as deep at the same shared-memory bytes). A is
// staged [BM][BK+8] and B [BK][BN+8] (rows 16-byte aligned, the eight rows
// of one ldmatrix phase on eight distinct 16-byte bank groups); A's fragments
// come from ldmatrix.x4, B's from ldmatrix.x4.trans straight off the HWIO
// rows (two k per register, no transposed copy of the weight). C % 8 == 0
// stages A in 16-byte cp.async copies of 8 channels of one tap, O % 8 == 0
// B the same; otherwise a pixel's channel run can start on a 2-byte
// boundary (C = 53, 106, 4 in the canonical model), which cp.async cannot
// copy, so that operand goes through plain 2-byte loads into shared memory
// with the same masks.
//
// Interface: plain C, loaded with ctypes. Every function launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for a tile
// configuration it does not know). Each conv_tc instance gets its dynamic
// shared memory limit raised once per device, on its first launch there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

enum Mode { kConv3 = 0, kConv4 = 1, kConvT = 2 };

struct Geo {
  int B, H, W, C, O;  // input batch/height/width/channels, output channels
  int Ho, Wo;         // GEMM grid per phase (output pixels of one phase)
  int M;              // B * Ho * Wo
  int K;              // live taps * C
  int phases;         // 1, or 4 for the transposed conv
  unsigned c_mul;     // k / C == umulhi(k, c_mul) >> c_shr for 0 <= k < 2^31, C > 1
  int c_shr;
};

// k / C without a division instruction (the round-up method of Granlund and
// Montgomery, as CUTLASS's FastDivmod): exact for 0 <= k < 2^31.
__device__ __forceinline__ int div_c(const Geo& g, int k) {
  return g.C == 1 ? k : (int)(__umulhi((unsigned)k, g.c_mul) >> g.c_shr);
}

// Input offsets (relative to oy*stride, ox*stride) and weight row of tap t.
template <int MODE>
__device__ __forceinline__ void tap_geometry(int t, int p, int& dy, int& dx, int& wtap) {
  if constexpr (MODE == kConv3) {
    const int ky = t / 3, kx = t - 3 * (t / 3);
    dy = ky - 1; dx = kx - 1; wtap = t;
  } else if constexpr (MODE == kConv4) {
    const int ky = t >> 2, kx = t & 3;
    dy = ky - 1; dx = kx - 1; wtap = t;
  } else {
    const int ta = t >> 1, tb = t & 1, u = p >> 1, v = p & 1;
    dy = ta + u - 1; dx = tb + v - 1;
    wtap = (2 * ta + u) * 4 + (2 * tb + v);
  }
}

// Row of the (taps * C, O) weight matrix that GEMM index k of phase p reads.
template <int MODE>
__device__ __forceinline__ int weight_row(const Geo& g, int k, int p) {
  if constexpr (MODE != kConvT) {
    return k;  // every tap is live, in the weight's own order
  } else {
    const int t = div_c(g, k);
    int dy, dx, wtap;
    tap_geometry<MODE>(t, p, dy, dx, wtap);
    return k + (wtap - t) * g.C;  // wtap * C + k % C
  }
}

// Offset of output element (pixel m of phase p, channel n).
template <int MODE>
__device__ __forceinline__ int64_t out_offset(const Geo& g, int p, int m, int n) {
  if constexpr (MODE != kConvT) return (int64_t)m * g.O + n;
  const int hw = g.Ho * g.Wo;
  const int b = m / hw, r = m - b * hw;
  const int i = r / g.Wo, j = r - i * g.Wo;
  const int oh = 2 * i + (p >> 1), ow = 2 * j + (p & 1);
  return (((int64_t)b * (2 * g.Ho) + oh) * (2 * g.Wo) + ow) * g.O + n;
}

// ---------------------------------------------------------------- conv_tc
constexpr int TC_BK = 32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// a = hi + lo, both TF32 rounded to nearest, ties away from zero: for a
// finite a the bits cvt.rna.tf32.f32 gives, in two integer operations where
// the instruction takes four (it also tests for inf and NaN). The tensor
// core reads only the top 19 bits of a TF32 operand, so lo's rounding is the
// added half unit alone; its low 13 bits need no clearing.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi)) + 0x1000u;
}

// d += a * b on one m16n8k8 tile (A row-major 16x8, B column-major 8x8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BN, int STAGES>
constexpr int tc_smem_bytes() {
  return STAGES * (BM * (TC_BK + 4) + TC_BK * (BN + 8)) * (int)sizeof(float);
}

// Warps tile the block as WARPS_M x WARPS_N, each owning a WM x WN output
// tile of (WM/16) x (WN/8) mma tiles. Fragment maps (PTX m16n8k8 .tf32,
// lane = 4 * gq + tq): A a0 (gq, tq), a1 (gq+8, tq), a2 (gq, tq+4),
// a3 (gq+8, tq+4); B b0 (k=tq, n=gq), b1 (k=tq+4, n=gq); C c0/c1
// (gq, 2tq / 2tq+1), c2/c3 (gq+8, 2tq / 2tq+1).
template <int MODE, int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
conv_tc(const float* __restrict__ x, const float* __restrict__ w,
        const float* __restrict__ scale, const float* __restrict__ shift,
        float* __restrict__ out, float* __restrict__ ws, Geo g, int relu,
        int splits, int kchunk, int vec_a, int vec_b) {
  constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int A_LD = TC_BK + 4, B_LD = BN + 8;
  constexpr int A_TILE = BM * A_LD, B_TILE = TC_BK * B_LD;
  constexpr int KQ = TC_BK / 4;           // 16-byte groups in a row of A
  constexpr int A_ROWS = BM * KQ / NT;    // rows of A a thread stages per step
  constexpr int NQ = BN / 4;              // 16-byte groups in a row of B
  constexpr int B_VECS = (TC_BK * NQ + NT - 1) / NT;  // groups of B a thread stages per step
  constexpr int STRIDE = MODE == kConv4 ? 2 : 1;
  static_assert(WM % 16 == 0 && WN % 8 == 0 && STAGES >= 2, "warp tile");
  static_assert(NT % KQ == 0 && (BM * KQ) % NT == 0, "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* const As = smem;
  float* const Bs = smem + STAGES * A_TILE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int p = blockIdx.z / splits;
  const int s = blockIdx.z - p * splits;
  const int kbeg = s * kchunk;
  const int kend = min(g.K, kbeg + kchunk);
  const int nsteps = kend > kbeg ? (kend - kbeg + TC_BK - 1) / TC_BK : 0;

  // The A rows a thread stages keep their pixels for every step: row
  // tid / KQ + i * (NT / KQ), K group tid % KQ. A row past M gets a y far
  // outside the image, so every tap of it is masked.
  const int kq = tid % KQ;
  int a_pix[A_ROWS], a_y[A_ROWS], a_x[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int m = m0 + tid / KQ + i * (NT / KQ);
    if (m < g.M) {
      const int hw = g.Ho * g.Wo;
      const int b = m / hw, r = m - b * hw;
      const int oy = r / g.Wo, ox = r - oy * g.Wo;
      a_y[i] = oy * STRIDE;
      a_x[i] = ox * STRIDE;
      a_pix[i] = (b * g.H + a_y[i]) * g.W + a_x[i];
    } else {
      a_y[i] = -(1 << 24); a_x[i] = 0; a_pix[i] = 0;
    }
  }

  auto load_stage = [&](int slot, int k0) {
    float* const as = As + slot * A_TILE + (tid / KQ) * A_LD + 4 * kq;
    float* const bs = Bs + slot * B_TILE;
    const int k = k0 + 4 * kq;  // the first of this thread's four K indices
    if (vec_a) {
      // C % 4 == 0: k .. k+3 are channels c .. c+3 of one tap
      const bool kv = k < kend;
      const int t = kv ? div_c(g, k) : 0;
      const int c = k - t * g.C;
      int dy, dx, wtap;
      tap_geometry<MODE>(t, p, dy, dx, wtap);
      const int off = dy * g.W + dx;
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i) {
        const int iy = a_y[i] + dy, ix = a_x[i] + dx;
        const bool v = kv && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
        cp_async16(as + i * (NT / KQ) * A_LD, v ? x + (a_pix[i] + off) * g.C + c : x, v);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool kv = k + j < kend;
        const int t = kv ? div_c(g, k + j) : 0;
        const int c = k + j - t * g.C;
        int dy, dx, wtap;
        tap_geometry<MODE>(t, p, dy, dx, wtap);
        const int off = dy * g.W + dx;
#pragma unroll
        for (int i = 0; i < A_ROWS; ++i) {
          const int iy = a_y[i] + dy, ix = a_x[i] + dx;
          const bool v = kv && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
          cp_async4(as + i * (NT / KQ) * A_LD + j, v ? x + (a_pix[i] + off) * g.C + c : x, v);
        }
      }
    }
    // Each of the transposed conv's weight rows resolves its tap (weight_row);
    // eight of them unrolled together (the thin tile) spilled in ptxas, so
    // that loop goes two rows at a time.
    constexpr int B_UNROLL = MODE == kConvT && B_VECS > 4 ? 2 : B_VECS;
#pragma unroll (B_UNROLL)
    for (int j = 0; j < B_VECS; ++j) {
      const int e = tid + j * NT;
      const int kk = e / NQ, nq = e - kk * NQ;
      const int kr = k0 + kk, n = n0 + 4 * nq;
      float* const dst = bs + kk * B_LD + 4 * nq;
      if ((TC_BK * NQ) % NT != 0 && e >= TC_BK * NQ) continue;  // fewer groups than threads
      const bool kv = kr < kend;
      const float* const row = w + (int64_t)(kv ? weight_row<MODE>(g, kr, p) : 0) * g.O;
      if (vec_b) {
        const bool v = kv && n < g.O;
        cp_async16(dst, v ? row + n : w, v);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool v = kv && n + q < g.O;
          cp_async4(dst + q, v ? row + n + q : w, v);
        }
      }
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load_stage(st, kbeg + st * TC_BK);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    // slot step has landed for every thread, and every warp is done with
    // slot step - 1, which the next load refills
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = step + STAGES - 1;
    if (next < nsteps) load_stage(next % STAGES, kbeg + next * TC_BK);
    cp_async_commit();

    const float* const as = As + (step % STAGES) * A_TILE + (wm * WM + gq) * A_LD + tq;
    const float* const bs = Bs + (step % STAGES) * B_TILE + tq * B_LD + wn * WN + gq;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 8) {
      uint32_t bh[NI][2], bl[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const float* const bp = bs + kk * B_LD + ni * 8;
        split_tf32(bp[0], bh[ni][0], bl[ni][0]);
        split_tf32(bp[4 * B_LD], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float* const ap = as + mi * 16 * A_LD + kk;
        uint32_t ah[4], al[4];
        split_tf32(ap[0], ah[0], al[0]);
        split_tf32(ap[8 * A_LD], ah[1], al[1]);
        split_tf32(ap[4], ah[2], al[2]);
        split_tf32(ap[8 * A_LD + 4], ah[3], al[3]);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          // The tensor core's float32 accumulate truncates, so a sum carried
          // in it over K would lose about K * 2^-24 of itself: each 8-deep
          // product is formed there (small terms first) and added to the
          // running sum with a rounded add.
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(part, al, bh[ni]);
          mma_tf32(part, ah, bl[ni]);
          mma_tf32(part, ah, bh[ni]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][ni][r] += part[r];
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left; leave none in flight

  const bool pairs = (g.O & 1) == 0;  // n is even, so n, n+1 is one 8-byte store
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + mi * 16 + gq + 8 * h;
      if (m >= g.M) continue;
      // the output row of pixel m (its phase's pixel for the transposed
      // conv), or its row of this split's partials
      float* const row = splits == 1 ? out + out_offset<MODE>(g, p, m, 0)
                                     : ws + (((int64_t)s * g.phases + p) * g.M + m) * g.O;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn * WN + ni * 8 + 2 * tq;
        if (n >= g.O) continue;
        float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (splits == 1) {
          v0 = fmaf(v0, scale[n], shift[n]);
          if (relu) v0 = fmaxf(v0, 0.f);
          if (n + 1 < g.O) {
            v1 = fmaf(v1, scale[n + 1], shift[n + 1]);
            if (relu) v1 = fmaxf(v1, 0.f);
          }
        }
        if (pairs) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
        } else {
          row[n] = v0;
          if (n + 1 < g.O) row[n + 1] = v1;
        }
      }
    }
  }
}

// ------------------------------------------------------------ conv_tc_bf16
constexpr int TB_BK = 64;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

// d = a * b + c on one m16n8k16 tile (A row-major 16x16, B column-major 16x8),
// bf16 operands, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

template <int BM, int BN, int STAGES>
constexpr int tcb_smem_bytes() {
  return STAGES * (BM * (TB_BK + 8) + TB_BK * (BN + 8)) * 2;
}

__device__ __forceinline__ uint4 pack8(const uint16_t (&v)[8]) {
  uint4 q;
  q.x = v[0] | ((uint32_t)v[1] << 16);
  q.y = v[2] | ((uint32_t)v[3] << 16);
  q.z = v[4] | ((uint32_t)v[5] << 16);
  q.w = v[6] | ((uint32_t)v[7] << 16);
  return q;
}

// The float32 kernel's structure on bf16 operands (see the header). Fragment
// maps (PTX m16n8k16 .bf16, lane = 4 * gq + tq, two k per register, the
// lower k in the low half): A a0 (gq, 2tq..2tq+1), a1 (gq+8, 2tq..),
// a2 (gq, 2tq+8..), a3 (gq+8, 2tq+8..); B b0 (k = 2tq.., n = gq),
// b1 (k = 2tq+8.., n = gq); C as the float32 kernel. ldmatrix.x4: lane l
// gives the address of row (l & 7) of 8x8 matrix l >> 3 and receives, of
// each matrix, row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 (with .trans:
// of the transpose). For A the four matrices are (rows 0-7 | 8-15) x (k 0-7
// | 8-15), so lane l points at row l & 15, k 8 (l >> 4) of its 16x16 tile;
// for B (rows k of [BK][BN+8]) they are (k 0-7 | 8-15) x (n 0-7 | 8-15):
// lane l points at k row l & 15, n 8 (l >> 4), and the four registers are
// b0, b1 of n tile ni, then of ni + 1.
template <int MODE, int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
conv_tc_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ shift,
             bf16* __restrict__ out, float* __restrict__ ws, Geo g, int relu,
             int splits, int kchunk, int vec_a, int vec_b) {
  constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int A_LD = TB_BK + 8, B_LD = BN + 8;
  constexpr int A_TILE = BM * A_LD, B_TILE = TB_BK * B_LD;
  constexpr int KQ = TB_BK / 8;           // 16-byte groups in a row of A
  constexpr int A_ROWS = BM * KQ / NT;    // rows of A a thread stages per step
  constexpr int NQ = BN / 8;              // 16-byte groups in a row of B
  constexpr int B_VECS = (TB_BK * NQ + NT - 1) / NT;  // groups of B a thread stages per step
  constexpr int KS = TB_BK / 16;          // m16n8k16 steps in a K step
  constexpr int STRIDE = MODE == kConv4 ? 2 : 1;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && STAGES >= 2, "warp tile");
  static_assert(NT % KQ == 0 && (BM * KQ) % NT == 0, "tile shape");
  static_assert((A_LD * 2) % 16 == 0 && (B_LD * 2) % 16 == 0, "16-byte rows");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const As = reinterpret_cast<bf16*>(smem_raw);
  bf16* const Bs = As + STAGES * A_TILE;
  const uint16_t* const xs = reinterpret_cast<const uint16_t*>(x);
  const uint16_t* const wsrc = reinterpret_cast<const uint16_t*>(w);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int p = blockIdx.z / splits;
  const int s = blockIdx.z - p * splits;
  const int kbeg = s * kchunk;
  const int kend = min(g.K, kbeg + kchunk);
  const int nsteps = kend > kbeg ? (kend - kbeg + TB_BK - 1) / TB_BK : 0;

  // as the float32 kernel: row tid / KQ + i * (NT / KQ), K group tid % KQ
  const int kq = tid % KQ;
  int a_pix[A_ROWS], a_y[A_ROWS], a_x[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int m = m0 + tid / KQ + i * (NT / KQ);
    if (m < g.M) {
      const int hw = g.Ho * g.Wo;
      const int b = m / hw, r = m - b * hw;
      const int oy = r / g.Wo, ox = r - oy * g.Wo;
      a_y[i] = oy * STRIDE;
      a_x[i] = ox * STRIDE;
      a_pix[i] = (b * g.H + a_y[i]) * g.W + a_x[i];
    } else {
      a_y[i] = -(1 << 24); a_x[i] = 0; a_pix[i] = 0;
    }
  }

  auto load_stage = [&](int slot, int k0) {
    bf16* const as = As + slot * A_TILE + (tid / KQ) * A_LD + 8 * kq;
    bf16* const bs = Bs + slot * B_TILE;
    const int k = k0 + 8 * kq;  // the first of this thread's eight K indices
    if (vec_a) {
      // C % 8 == 0: k .. k+7 are channels c .. c+7 of one tap
      const bool kv = k < kend;
      const int t = kv ? div_c(g, k) : 0;
      const int c = k - t * g.C;
      int dy, dx, wtap;
      tap_geometry<MODE>(t, p, dy, dx, wtap);
      const int off = dy * g.W + dx;
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i) {
        const int iy = a_y[i] + dy, ix = a_x[i] + dx;
        const bool v = kv && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
        cp_async16(as + i * (NT / KQ) * A_LD, v ? x + (a_pix[i] + off) * g.C + c : x, v);
      }
    } else {
      // C % 8 != 0: a channel run may start on a 2-byte boundary, which
      // cp.async cannot copy; eight plain loads per row, each masked alone
      uint16_t vals[A_ROWS][8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool kv = k + j < kend;
        const int t = kv ? div_c(g, k + j) : 0;
        const int c = k + j - t * g.C;
        int dy, dx, wtap;
        tap_geometry<MODE>(t, p, dy, dx, wtap);
        const int off = dy * g.W + dx;
#pragma unroll
        for (int i = 0; i < A_ROWS; ++i) {
          const int iy = a_y[i] + dy, ix = a_x[i] + dx;
          const bool v = kv && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
          vals[i][j] = v ? __ldg(xs + (a_pix[i] + off) * g.C + c) : (uint16_t)0;
        }
      }
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i)
        *reinterpret_cast<uint4*>(as + i * (NT / KQ) * A_LD) = pack8(vals[i]);
    }
    // the transposed conv's weight rows each resolve their tap: unrolled,
    // the 128x64 tile spilled at 128 registers, so that loop is not
    constexpr int B_UNROLL = MODE == kConvT ? 1 : B_VECS;
#pragma unroll (B_UNROLL)
    for (int j = 0; j < B_VECS; ++j) {
      const int e = tid + j * NT;
      const int kk = e / NQ, nq = e - kk * NQ;
      const int kr = k0 + kk, n = n0 + 8 * nq;
      bf16* const dst = bs + kk * B_LD + 8 * nq;
      if ((TB_BK * NQ) % NT != 0 && e >= TB_BK * NQ) continue;  // fewer groups than threads
      const bool kv = kr < kend;
      const int64_t row = (int64_t)(kv ? weight_row<MODE>(g, kr, p) : 0) * g.O;
      if (vec_b) {
        const bool v = kv && n < g.O;
        cp_async16(dst, v ? w + row + n : w, v);
      } else {
        uint16_t v8[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const bool v = kv && n + q < g.O;
          v8[q] = v ? __ldg(wsrc + row + n + q) : (uint16_t)0;
        }
        *reinterpret_cast<uint4*>(dst) = pack8(v8);
      }
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load_stage(st, kbeg + st * TB_BK);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    // slot step has landed for every thread (cp.async, and the plain stores
    // before the barrier), and every warp is done with slot step - 1
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = step + STAGES - 1;
    if (next < nsteps) load_stage(next % STAGES, kbeg + next * TB_BK);
    cp_async_commit();

    const bf16* const as = As + (step % STAGES) * A_TILE
                           + (wm * WM + (lane & 15)) * A_LD + 8 * (lane >> 4);
    const bf16* const bs = Bs + (step % STAGES) * B_TILE
                           + (lane & 15) * B_LD + wn * WN + 8 * (lane >> 4);
    uint32_t bfr[KS][NI][2];  // the step's B fragments
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int ni = 0; ni < NI; ni += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + ks * 16 * B_LD + ni * 8);
        bfr[ks][ni][0] = r[0]; bfr[ks][ni][1] = r[1];
        bfr[ks][ni + 1][0] = r[2]; bfr[ks][ni + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      uint32_t afr[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(afr[ks], as + mi * 16 * A_LD + ks * 16);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        // the step's 64-deep product formed in the tensor core, then added
        // to the running sum with a rounded add (the accumulate truncates)
        float part[4];
        mma_bf16(part, afr[0], bfr[0][ni][0], bfr[0][ni][1], zero);
#pragma unroll
        for (int ks = 1; ks < KS; ++ks)
          mma_bf16(part, afr[ks], bfr[ks][ni][0], bfr[ks][ni][1], part);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] += part[r];
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left; leave none in flight

  const bool pairs = (g.O & 1) == 0;  // n is even, so n, n+1 is one aligned store
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + mi * 16 + gq + 8 * h;
      if (m >= g.M) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn * WN + ni * 8 + 2 * tq;
        if (n >= g.O) continue;
        float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (splits > 1) {  // this split's float32 partials
          float* const row = ws + (((int64_t)s * g.phases + p) * g.M + m) * g.O;
          if (pairs) {
            *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
          } else {
            row[n] = v0;
            if (n + 1 < g.O) row[n + 1] = v1;
          }
          continue;
        }
        bf16* const row = out + out_offset<MODE>(g, p, m, 0);
        v0 = fmaf(v0, scale[n], shift[n]);
        if (relu) v0 = fmaxf(v0, 0.f);
        if (n + 1 < g.O) {
          v1 = fmaf(v1, scale[n + 1], shift[n + 1]);
          if (relu) v1 = fmaxf(v1, 0.f);
        }
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          row[n] = __float2bfloat16_rn(v0);
          if (n + 1 < g.O) row[n + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// Sums the K-split partials in split order and applies the epilogue (and,
// for a bf16 output, the one rounding).
template <int MODE, typename T>
__global__ void splitk_reduce(const float* __restrict__ ws, const float* __restrict__ scale,
                              const float* __restrict__ shift, T* __restrict__ out,
                              Geo g, int relu, int splits) {
  const int64_t total = (int64_t)g.phases * g.M * g.O;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int n = (int)(e % g.O);
    const int64_t r = e / g.O;
    const int p = (int)(r / g.M), m = (int)(r - (int64_t)p * g.M);
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += ws[s * total + e];
    float v = fmaf(acc, scale[n], shift[n]);
    if (relu) v = fmaxf(v, 0.f);
    store_out(out + out_offset<MODE>(g, p, m, n), v);
  }
}

template <int MODE, typename T>
cudaError_t reduce_splits(const float* scale, const float* shift, T* out, float* ws,
                          const Geo& g, int relu, int splits, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t total = (int64_t)g.phases * g.M * g.O;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  splitk_reduce<MODE, T><<<blocks, 256, 0, st>>>(ws, scale, shift, out, g, relu, splits);
  return cudaGetLastError();
}

// Tile configurations, picked by ops/fused_conv.plan_tc; the bf16 instances
// take the same four (the same plan, BK = 64).
//   0 wide:   BM=128 BN=128 warps 2x4 of 64x32, 3 stages  (N > 64)
//   1 mid:    BM=128 BN=64  warps 4x2 of 32x32, 3 stages  (16 < N <= 64)
//   2 narrow: BM=64  BN=16  warps 4x1 of 16x16, 4 stages  (N <= 16)
//   3 thin:   BM=32  BN=128 warps 1x4 of 32x32, 4 stages  (M <= 64 per phase)
// T is float (conv_tc) or bf16 (conv_tc_bf16).
template <int MODE, int BM, int BN, int WM, int WN, int STAGES, typename T>
cudaError_t launch_tc(const T* x, const T* w, const float* scale, const float* shift,
                      T* out, float* ws, const Geo& g, int relu, int splits, int kchunk,
                      cudaStream_t st) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int NT = (BM / WM) * (BN / WN) * 32;
  constexpr int SMEM = F32 ? tc_smem_bytes<BM, BN, STAGES>() : tcb_smem_bytes<BM, BN, STAGES>();
  constexpr int VEC = 16 / sizeof(T);  // elements in one 16-byte copy
  const auto kernel = [] {
    if constexpr (F32) return conv_tc<MODE, BM, BN, WM, WN, STAGES>;
    else return conv_tc_bf16<MODE, BM, BN, WM, WN, STAGES>;
  }();
  // The attribute holds per device; set it on this instance's first launch
  // on each device (a repeat from two threads at once is harmless).
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev].store(true, std::memory_order_release);
  }
  const int vec_a = g.C % VEC == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int vec_b = g.O % VEC == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  dim3 grid((g.M + BM - 1) / BM, (g.O + BN - 1) / BN, g.phases * splits);
  kernel<<<grid, NT, SMEM, st>>>(x, w, scale, shift, out, ws, g, relu, splits, kchunk,
                                 vec_a, vec_b);
  return reduce_splits<MODE>(scale, shift, out, ws, g, relu, splits, st);
}

template <int MODE, typename T>
int launch(int cfg, const void* x, const void* w, const void* scale, const void* shift,
           void* out, void* ws, Geo g, int relu, int splits, int kchunk, void* stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const float* sf = static_cast<const float*>(scale);
  const float* tf = static_cast<const float*>(shift);
  T* ot = static_cast<T*>(out);
  float* wsf = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cfg) {
    case 0: return launch_tc<MODE, 128, 128, 64, 32, 3>(xt, wt, sf, tf, ot, wsf, g, relu, splits, kchunk, st);
    case 1: return launch_tc<MODE, 128, 64, 32, 32, 3>(xt, wt, sf, tf, ot, wsf, g, relu, splits, kchunk, st);
    case 2: return launch_tc<MODE, 64, 16, 16, 16, 4>(xt, wt, sf, tf, ot, wsf, g, relu, splits, kchunk, st);
    case 3: return launch_tc<MODE, 32, 128, 32, 32, 4>(xt, wt, sf, tf, ot, wsf, g, relu, splits, kchunk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

Geo make_geo(int B, int H, int W, int C, int O, int mode) {
  Geo g;
  g.B = B; g.H = H; g.W = W; g.C = C; g.O = O;
  if (mode == kConv3) { g.Ho = H; g.Wo = W; g.K = 9 * C; g.phases = 1; }
  else if (mode == kConv4) { g.Ho = H / 2; g.Wo = W / 2; g.K = 16 * C; g.phases = 1; }
  else { g.Ho = H; g.Wo = W; g.K = 4 * C; g.phases = 4; }
  g.M = B * g.Ho * g.Wo;
  // div_c's constants: c_shr = 31 + ceil(log2 C) - 32, c_mul = ceil(2^(c_shr + 32) / C)
  int l = 0;
  while ((1u << l) < (unsigned)C) ++l;
  g.c_shr = C > 1 ? l - 1 : 0;
  g.c_mul = C > 1 ? (unsigned)(((1ull << (31 + l)) + C - 1) / C) : 0u;
  return g;
}

}  // namespace

extern "C" {

int svrs_conv3x3(int cfg, const void* x, const void* w, const void* scale, const void* shift,
                 void* out, void* ws, int B, int H, int W, int C, int O, int relu,
                 int splits, int kchunk, void* stream) {
  return launch<kConv3, float>(cfg, x, w, scale, shift, out, ws, make_geo(B, H, W, C, O, kConv3),
                        relu, splits, kchunk, stream);
}

int svrs_conv4x4s2(int cfg, const void* x, const void* w, const void* scale, const void* shift,
                   void* out, void* ws, int B, int H, int W, int C, int O, int relu,
                   int splits, int kchunk, void* stream) {
  return launch<kConv4, float>(cfg, x, w, scale, shift, out, ws, make_geo(B, H, W, C, O, kConv4),
                        relu, splits, kchunk, stream);
}

int svrs_convT4x4s2(int cfg, const void* x, const void* w, const void* scale, const void* shift,
                    void* out, void* ws, int B, int H, int W, int C, int O, int relu,
                    int splits, int kchunk, void* stream) {
  return launch<kConvT, float>(cfg, x, w, scale, shift, out, ws, make_geo(B, H, W, C, O, kConvT),
                        relu, splits, kchunk, stream);
}

int svrs_conv3x3_bf16(int cfg, const void* x, const void* w, const void* scale,
                      const void* shift, void* out, void* ws, int B, int H, int W, int C,
                      int O, int relu, int splits, int kchunk, void* stream) {
  return launch<kConv3, bf16>(cfg, x, w, scale, shift, out, ws, make_geo(B, H, W, C, O, kConv3),
                              relu, splits, kchunk, stream);
}

int svrs_conv4x4s2_bf16(int cfg, const void* x, const void* w, const void* scale,
                        const void* shift, void* out, void* ws, int B, int H, int W, int C,
                        int O, int relu, int splits, int kchunk, void* stream) {
  return launch<kConv4, bf16>(cfg, x, w, scale, shift, out, ws, make_geo(B, H, W, C, O, kConv4),
                              relu, splits, kchunk, stream);
}

int svrs_convT4x4s2_bf16(int cfg, const void* x, const void* w, const void* scale,
                         const void* shift, void* out, void* ws, int B, int H, int W, int C,
                         int O, int relu, int splits, int kchunk, void* stream) {
  return launch<kConvT, bf16>(cfg, x, w, scale, shift, out, ws, make_geo(B, H, W, C, O, kConvT),
                              relu, splits, kchunk, stream);
}

}  // extern "C"
