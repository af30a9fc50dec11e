// Fused chain of 3x3 convolutions for Hopper (sm_90a): n layers in one launch.
//
// Replaces the two Pallas TPU chain kernels of the eval-mode decoder and
// encoder tails (simple_vae_rs_tpu/ops/pallas_conv.py):
//   svrs_conv3x3_chain  <- fused_conv3x3_chain     (_kernel3_chain, channels in lanes)
//                       <- fused_conv3x3_chain_wl  (_kernel3_chain_wl, width in lanes)
// Both compute the same function, a linear chain
//   h_0 = x,  h_{l+1} = conv3x3/s1 SAME(h_l, W_l) + b_l   (no activation between),
// in float32, with x and the result NHWC and each W_l in HWIO layout
// (3, 3, C_l, C_{l+1}), row-major. One Hopper kernel serves both.
//
// What bounds it: operations. The decoder tails (64 -> 64 -> 16 -> 16 -> 4
// channels at 64x64 and 32x32, up to 1000 images) do 49k multiply-adds a
// pixel and move 272 bytes of input and output: float32 FMA on the CUDA
// cores tops out at 67 TFLOP/s, the TF32 tensor cores at 495, so at float32
// accuracy (3xTF32, below) at 165. What the chain saves is the trips of the
// intermediates to device memory and three launches; it pays for that only
// if it recomputes nothing and multiplies as fast as the per-layer kernel.
// (The kernel this one replaced ran scalar FMA on 2-D tiles that recomputed
// a halo around every tile, 2.24x the multiply-adds of a 64x64 tail.)
//
// Design: a block owns a strip of output rows of one image across a panel of
// columns (the whole width wherever the rings fit: the models' tails always)
// and streams down the rows, as the TPU kernel streams full-width row strips.
// For each stage s (the input of layer s) it keeps a ring of the last few
// rows in shared memory, rows of the stage's stored columns at pixel_stride
// floats a pixel. A step first takes up to RS new input rows into stage 0's
// ring, then each layer produces up to RS rows of the next stage, each from
// the three rows above, beside and below it in its input ring; the last layer
// writes the output to device memory. Each stage then lags its input by at
// most one row (ops/fused_chain.advance, the schedule every block follows),
// so a ring of RS + 2 rows holds every row a layer still reads, and every
// intermediate row is computed once per strip: only the seams between two
// strips of an image recompute, n - s rows per side at stage s (and the same
// for columns between panels). The next step's input rows are copied in
// (cp.async) while layers 1 .. n-1 run. Stage s is stored n - s rows and
// columns out from the block's output, clipped to the image and its
// one-pixel border; stored positions outside the image stay zero (the ring
// starts zeroed, a border row is written as zeros, border columns are never
// written): exactly the SAME padding each layer sees on the image. Where RS
// covers a block's whole strip (the 8x8 encoder tails), the block runs the
// chain in one step and the even stages share one region of shared memory,
// the odd stages another.
//
// Each layer step is an implicit GEMM on mma.sync.m16n8k8 TF32: M = the
// pixels of its rows, N = C_{l+1} padded to 8, K = 9 taps x C_l padded to 8
// (so that every 8-deep k group lies in one tap: no k / C in the inner loop,
// the tap and channel advance as the loop walks K). The A fragment is read
// straight from the input ring; pixel_stride = round_up(C, 8) + 4 floats, an
// odd number of 16-byte words, puts the 8 pixels x 4 channels of a fragment
// read on 32 distinct banks. The weights stream through a ring of two
// cp.async slots of KS k rows each ([KS][BN + 8], the rows as the HWIO
// weight stores them, zero-filled past C_l and C_{l+1}; KS = 64, and 128 for
// the narrow layers, whose slots hold less work between two barriers): layer
// 1 of a 64-channel tail (147 KB) does not fit beside the stage rings. TF32
// alone keeps 10 mantissa bits, too coarse for the 1e-4 the chain is held
// to, so each operand is split as a = hi + lo (split_tf32) and each product
// is lo*b_hi + hi*b_lo + hi*b_hi (3xTF32); each 8-deep partial is added to
// the register sum with a rounded add, since the tensor core's float32
// accumulate truncates (as conv_tc in fused_conv.cu). The bias is added in
// the epilogue. Eight warps a block; the warp tile follows the layer's
// width: 32x32 for N > 16 (128x64 or 64x128 a block), 16x16 for N <= 16,
// 16x8 for N <= 8. A warp whose tile lies wholly past M or N skips its MMAs.
// No atomics and a fixed order of summation: the same bits every launch.
// Measured on the H100 (PERF.md), the layers run at about the per-layer
// kernel's rate, the narrow ones slower; barrier and copy waits are a few
// percent of a block's time, so the MMAs and their operand splits bound it.
//
// bf16 instance (svrs_conv3x3_chain_bf16; the chain of a bf16 model, as JAX
// fused_conv3x3_chain runs on x.astype(bf16)): x, the weights, the stage rings
// and the output in bf16, the biases float32, rounded to bf16 in the epilogue.
// Each layer is #3's function: acc in float32, then bf16(acc + float(bf16(b_l)))
// (#3 casts the biases to x.dtype, pallas_conv.py:634, and rounds every layer
// to x.dtype, :366). Each layer step is the same implicit GEMM on
// mma.sync.m16n8k16 bf16 with float32 accumulation: one MMA per 16-deep k
// group where 3xTF32 issues three per 8-deep one, a bf16 x bf16 product being
// exact in float32. K per tap is padded to 16 (every 16-deep group in one
// tap); four groups are summed in the tensor core and added to the register
// sum with a rounded add (as conv_tc_bf16 in fused_conv.cu). A's fragments
// come from ldmatrix.x4 straight off the rings: a pixel holds round_up(C, 16)
// + 8 bf16, an odd number of 16-byte words, so the eight rows of one ldmatrix
// phase (eight neighbouring pixels) fall on eight distinct 16-byte bank groups.
// B's come from ldmatrix.x4.trans (.x2.trans for an 8-wide warp tile) off the
// HWIO weight rows in the slot, whose rows are BN + 8 bf16 apart, again an
// odd number of 16-byte words. The weight slots hold twice the rows in the
// same bytes (KS = 128 and 256). Stage 0 and the weights move in 16-byte
// cp.async copies where C_0 (C_{l+1}) % 8 == 0; otherwise a pixel's channel
// run (a weight row) can start on a 2-byte boundary, which cp.async cannot
// copy, and each element is a plain masked 2-byte load. Rows outside the
// image are zeroed between layers as in the float32 kernel, which is #3's
// halo masking (pallas_conv.py:368-378).
//
// Launch geometry (ops/fused_chain.plan_chain, passed in): strip height,
// panel width and RS (up to 128 output pixels a step, fewer where the rings
// do not fit), and per stage its ring rows, ring pixels and offset. Strips
// are chosen so that the grid fills the SMs: a whole image a block at the
// training batch and the 1000-draw decode, strips at 1 and 16 images.
//
// Interface: plain C, loaded with ctypes. The function makes the given device
// current for the call, launches on the given stream, does not synchronise,
// allocates nothing, and returns the CUDA error of the launch (0 on success).
// The dynamic shared memory limit is raised once per device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAXL = 8;        // layers in one chain
constexpr int NT = 256;        // threads per block: eight warps
constexpr int STAGES = 2;      // slots of the weight ring
constexpr int SMEM_MAX = 232448;

typedef __nv_bfloat16 bf16;

struct Chain {
  const void* w[MAXL];   // layer l's HWIO weights, in the chain's type T
  const float* bias[MAXL];
  int C[MAXL + 1];  // channel widths C_0 .. C_n
  int n;
  int B, H, W;
  int strip, panel, rs;  // output rows and columns a block owns; rows a step
  int strips, panels;
  int Q[MAXL];    // ring rows of stage s
  int NX[MAXL];   // stored pixels a ring row of stage s
  int off[MAXL];  // offset (elements of T) of stage s's ring
  int ws_off;     // offset (elements of T) of the weight ring
  int ws_slot;    // elements of T a slot of the weight ring holds
  int clear;      // bit s: stage s shares its ring with stage s - 2; zero it first
  int vec_x;      // x moves in 16-byte copies
  int vec_w;      // bit l: layer l's weight rows move in 16-byte copies
};

// Channels rounded up to whole 8-deep (16-deep) k groups.
__host__ __device__ __forceinline__ int c8(int c) { return (c + 7) & ~7; }
__host__ __device__ __forceinline__ int c16(int c) { return (c + 15) & ~15; }
// Elements between two stored pixels: an odd number of 16-byte words.
template <typename T>
__host__ __device__ __forceinline__ int pixel_stride(int c) {
  return sizeof(T) == 4 ? c8(c) + 4 : c16(c) + 8;
}

struct Span { int lo, hi; };

// The span of stage s a block with output [o0, o1) stores along an axis of
// `size` (ops/fused_chain.stage_spans); stage n is the output itself.
__device__ __forceinline__ Span stage_span(int o0, int o1, int n, int s, int size) {
  if (s == n) return Span{o0, o1};
  return Span{max(-1, o0 - (n - s)), min(size + 1, o1 + (n - s))};
}

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

// a = hi + lo in two instructions: the tensor core reads only the top 19
// bits of a TF32 operand, so a itself serves as hi (a truncated to TF32),
// and lo = a - trunc(a) is exact; the tensor core truncates lo in turn, by
// at most 2^-10 of itself (2^-20 of a). (split_tf32 in fused_conv.cu rounds
// both halves, in four instructions: here the splits of the operands a warp
// reads again at every tap are a large share of its instructions.)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a);
  lo = __float_as_uint(a - __uint_as_float(hi & 0xffffe000u));
}

// d += a * b on one m16n8k8 tile (A row-major 16x8, B column-major 8x8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Zeroes `count` elements from `dst` (a multiple of 16 bytes, 16-byte aligned).
template <typename T>
__device__ __forceinline__ void zero16(T* dst, int count) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  const int words = count * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < words; i += NT) d[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Zeroes the ring row of stage s that holds row y (a border row).
template <typename T>
__device__ __forceinline__ void zero_row(T* smem, const Chain& p, int s, int y) {
  const int row = p.NX[s] * pixel_stride<T>(p.C[s]);  // a multiple of 16 bytes
  zero16(smem + p.off[s] + ((y + 1) % p.Q[s]) * row, row);
}

// Rows [r0, r1) of stage 0: the input's columns [x0, x1) of image b (16-byte
// cp.async, or 4-byte cp.async (float32) / a plain 2-byte copy (bf16) an
// element, one commit group, waited for by the caller), a row outside the
// image as zeros. Channels past C_0 are never written: they stay zero.
template <typename T>
__device__ void load_rows(const T* __restrict__ x, T* smem, const Chain& p, int b, int r0,
                          int r1, Span xs) {
  constexpr int V = 16 / (int)sizeof(T);  // elements in a 16-byte copy
  const int C = p.C[0], P = pixel_stride<T>(C);
  const int cx0 = max(0, xs.lo), cw = min(p.W, xs.hi) - cx0;
  for (int y = r0; y < r1; ++y) {
    if (y < 0 || y >= p.H) {
      zero_row(smem, p, 0, y);
      continue;
    }
    T* dst = smem + p.off[0] + ((y + 1) % p.Q[0]) * p.NX[0] * P + (cx0 - xs.lo) * P;
    const T* src = x + ((int64_t)(b * p.H + y) * p.W + cx0) * C;
    if (p.vec_x) {
      const int words = C / V, total = cw * words;
      for (int i = threadIdx.x; i < total; i += NT) {
        const int px = i / words, q = i - px * words;
        cp_async16(dst + px * P + V * q, src + V * i, true);
      }
    } else {
      const int total = cw * C;
      for (int i = threadIdx.x; i < total; i += NT) {
        const int px = i / C, c = i - px * C;
        if constexpr (sizeof(T) == 4) {
          cp_async4(reinterpret_cast<float*>(dst) + px * P + c,
                    reinterpret_cast<const float*>(src) + i, true);
        } else {
          reinterpret_cast<unsigned short*>(dst)[px * P + c] =
              __ldg(reinterpret_cast<const unsigned short*>(src) + i);
        }
      }
    }
  }
  cp_async_commit();
}

// Layer l on rows [ra, rb) of stage l + 1 (inside the image), computed
// columns [cx0, cx0 + cw): M = (rb - ra) * cw pixels in tiles of BM, N in
// tiles of BN, K = 9 * c8(C_l) in slots of KS rows through the weight ring.
// Warps tile the block as WARPS_M x WARPS_N of WM x WN. Fragment maps (PTX
// m16n8k8 .tf32, lane = 4 * gq + tq): A a0 (gq, tq), a1 (gq+8, tq),
// a2 (gq, tq+4), a3 (gq+8, tq+4); B b0 (k=tq, n=gq), b1 (k=tq+4, n=gq);
// C c0/c1 (gq, 2tq / 2tq+1), c2/c3 (gq+8, 2tq / 2tq+1).
// The k groups of a slot run as straight-line code (the tap and channel
// advance by selects, the input row by a select among three), so that the
// compiler can overlap one group's loads and splits with another's MMAs;
// only the last slot of K, when partial, checks each group.
template <int BM, int BN, int WM, int WN, int KS>
__device__ void layer_gemm(float* smem, const Chain& p, int l, int b, int ra, int rb, int cx0,
                           int cw, int xlo_in, int xlo_out, float* __restrict__ out) {
  constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static_assert(WARPS_M * WARPS_N * 32 == NT && WM % 16 == 0 && WN % 8 == 0, "warp tile");
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int B_LD = (BN < 16 ? 16 : BN) + 8;
  constexpr int NQ = BN / 4;  // 16-byte groups in a row of a weight slot
  constexpr int B_VECS = (KS * NQ + NT - 1) / NT;
  constexpr int GROUPS = KS / 8;
  // a wide warp tile has work enough in one group; unrolling it spills
  constexpr int UNROLL = MI * NI >= 8 ? 1 : 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int gq = lane >> 2, tq = lane & 3;
  const int Cin = p.C[l], Cout = p.C[l + 1];
  const int K8 = c8(Cin), G8 = K8 / 8, K = 9 * K8, N8 = c8(Cout);
  const int Pin = pixel_stride<float>(Cin), Qin = p.Q[l], in_row = p.NX[l] * Pin;
  const bool last = l == p.n - 1;
  const int Pout = last ? 0 : pixel_stride<float>(Cout);
  const int Qout = last ? 1 : p.Q[l + 1], out_row = last ? 0 : p.NX[l + 1] * Pout;
  const float* const ring = smem + p.off[l];
  float* const wsm = smem + p.ws_off;
  const float* const wg = static_cast<const float*>(p.w[l]);
  const float* const bias = p.bias[l];
  const bool vec_w = (p.vec_w >> l) & 1;
  const int M = (rb - ra) * cw;
  const int nsteps = (K + KS - 1) / KS;

  for (int m0 = 0; m0 < M; m0 += BM) {
    // This thread's fragment pixels (a pixel past M reads the tile's first
    // pixel and is not written), and for each the ring offset of its input
    // rows ky - 1 = -1, 0, 1 at column -1, lane column tq included.
    int frow[MI][2], fcol[MI][2], roff[3][MI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * WM + mi * 16 + gq + 8 * h;
        const int mm = m < M ? m : m0;
        const int r = mm / cw;
        frow[mi][h] = ra + r;
        fcol[mi][h] = cx0 + (mm - r * cw);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
          roff[ky][mi][h] = ((frow[mi][h] + ky) % Qin) * in_row
                            + (fcol[mi][h] - 1 - xlo_in) * Pin + tq;
      }
    const bool m_live = m0 + wm * WM < M;
    for (int n0 = 0; n0 < N8; n0 += BN) {
      const bool live = m_live && n0 + wn * WN < N8;

      auto load_slot = [&](int slot, int k0) {
        float* const bs = wsm + slot * p.ws_slot;
#pragma unroll
        for (int j = 0; j < B_VECS; ++j) {
          const int e = tid + j * NT;
          if ((KS * NQ) % NT != 0 && e >= KS * NQ) continue;  // fewer groups than threads
          const int kk = e / NQ, nq = e - kk * NQ;
          const int kr = k0 + kk, n = n0 + 4 * nq;
          const int t = kr / K8, c = kr - t * K8;
          const bool kv = kr < K && c < Cin;
          const float* const row = wg + (int64_t)(kv ? t * Cin + c : 0) * Cout;
          float* const dst = bs + kk * B_LD + 4 * nq;
          if (vec_w) {
            const bool v = kv && n < Cout;
            cp_async16(dst, v ? row + n : wg, v);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const bool v = kv && n + q < Cout;
              cp_async4(dst + q, v ? row + n + q : wg, v);
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

      // one 8-deep k group: tap (ky, kx), channels c0 .. c0 + 7, B rows kk ..
      auto group = [&](const float* bs, int kk, int ky, int kx, int c0) {
        uint32_t bh[NI][2], bl[NI][2];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const float* const bp = bs + kk * B_LD + ni * 8;
          split_tf32(bp[0], bh[ni][0], bl[ni][0]);
          split_tf32(bp[4 * B_LD], bh[ni][1], bl[ni][1]);
        }
        const int koff = kx * Pin + c0;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int o0 = ky == 0 ? roff[0][mi][0] : ky == 1 ? roff[1][mi][0] : roff[2][mi][0];
          const int o1 = ky == 0 ? roff[0][mi][1] : ky == 1 ? roff[1][mi][1] : roff[2][mi][1];
          const float* const a0 = ring + o0 + koff;
          const float* const a1 = ring + o1 + koff;
          uint32_t ah[4], al[4];
          split_tf32(a0[0], ah[0], al[0]);
          split_tf32(a1[0], ah[1], al[1]);
          split_tf32(a0[4], ah[2], al[2]);
          split_tf32(a1[4], ah[3], al[3]);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            // each 8-deep product formed in the tensor core (small terms
            // first), then added to the running sum with a rounded add
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(part, al, bh[ni]);
            mma_tf32(part, ah, bl[ni]);
            mma_tf32(part, ah, bh[ni]);
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mi][ni][r] += part[r];
          }
        }
      };

#pragma unroll
      for (int st = 0; st < STAGES - 1; ++st) {
        if (st < nsteps) load_slot(st, st * KS);
        cp_async_commit();
      }
      for (int step = 0; step < nsteps; ++step) {
        // slot step has landed for every thread, and every warp is done with
        // slot step - 1, which the next load refills
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        const int nxt = step + STAGES - 1;
        if (nxt < nsteps) load_slot(nxt % STAGES, nxt * KS);
        cp_async_commit();
        if (!live) continue;

        const float* const bs = wsm + (step % STAGES) * p.ws_slot + tq * B_LD + wn * WN + gq;
        // the tap and first channel of the slot's first k group
        const int g0 = step * GROUPS, t0 = g0 / G8;
        int c0 = (g0 - t0 * G8) * 8, ky = t0 / 3, kx = t0 - 3 * ky;
        if ((step + 1) * KS <= K) {
#pragma unroll UNROLL
          for (int j = 0; j < GROUPS; ++j) {
            group(bs, 8 * j, ky, kx, c0);
            c0 += 8;
            const bool next_tap = c0 == K8;
            c0 = next_tap ? 0 : c0;
            kx += next_tap;
            const bool next_row = kx == 3;
            kx = next_row ? 0 : kx;
            ky += next_row;
          }
        } else {
          for (int j = 0; j < GROUPS && step * KS + 8 * j < K; ++j) {
            group(bs, 8 * j, ky, kx, c0);
            c0 += 8;
            if (c0 == K8) {
              c0 = 0;
              if (++kx == 3) { kx = 0; ++ky; }
            }
          }
        }
      }
      cp_async_wait<0>();  // only empty groups are left; leave none in flight

      if (live) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm * WM + mi * 16 + gq + 8 * h;
            if (m >= M) continue;
            const int y = frow[mi][h], xc = fcol[mi][h];
            float* const dst = last
                ? out + ((int64_t)(b * p.H + y) * p.W + xc) * Cout
                : smem + p.off[l + 1] + ((y + 1) % Qout) * out_row + (xc - xlo_out) * Pout;
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
              const int n = n0 + wn * WN + ni * 8 + 2 * tq;
              if (n >= N8) continue;
              // channels past C_{l+1} hold 0 + 0: the next layer's K reads them
              const float v0 = acc[mi][ni][2 * h] + (n < Cout ? __ldg(bias + n) : 0.f);
              const float v1 = acc[mi][ni][2 * h + 1] + (n + 1 < Cout ? __ldg(bias + n + 1) : 0.f);
              if (!last) {
                *reinterpret_cast<float2*>(dst + n) = make_float2(v0, v1);
              } else if ((Cout & 1) == 0) {
                if (n < Cout) *reinterpret_cast<float2*>(dst + n) = make_float2(v0, v1);
              } else {
                if (n < Cout) dst[n] = v0;
                if (n + 1 < Cout) dst[n + 1] = v1;
              }
            }
          }
      }
      __syncthreads();  // the weight ring is refilled by the next tile
    }
  }
}

// ------------------------------------------------------------ bf16 layers
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

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a) : "memory");
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

__device__ __forceinline__ uint4 pack8(const unsigned short (&v)[8]) {
  uint4 q;
  q.x = v[0] | ((uint32_t)v[1] << 16);
  q.y = v[2] | ((uint32_t)v[3] << 16);
  q.z = v[4] | ((uint32_t)v[5] << 16);
  q.w = v[6] | ((uint32_t)v[7] << 16);
  return q;
}

// A float32 bias as #3 adds it: rounded to bf16 first.
__device__ __forceinline__ float bf16_bias(const float* bias, int n) {
  return __bfloat162float(__float2bfloat16_rn(__ldg(bias + n)));
}

// The float32 layer step's structure on bf16 operands (the header's bf16
// paragraph): M, N and the tiles as there, K = 9 * c16(C_l) in 16-deep
// groups, KS weight rows a slot. Fragment maps (PTX m16n8k16 .bf16, lane =
// 4 * gq + tq, two k per register, the lower k in the low half): A a0 (gq,
// 2tq..), a1 (gq+8, 2tq..), a2 (gq, 2tq+8..), a3 (gq+8, 2tq+8..); B b0 (k =
// 2tq.., n = gq), b1 (k = 2tq+8.., n = gq); C as the float32 kernel.
// ldmatrix.x4: lane l gives the address of row (l & 7) of 8x8 matrix l >> 3;
// for A the matrices are (pixels 0-7 | 8-15) x (k 0-7 | 8-15), so lane l
// points at pixel l & 15 of its 16-pixel fragment, k 8 (l >> 4); for B (k rows
// of [KS][B_LD]) they are (k 0-7 | 8-15) x (n 0-7 | 8-15): lane l points at k
// row l & 15, n 8 (l >> 4), and the four registers are b0, b1 of n tile ni,
// then of ni + 1 (.x2: lanes 0-15, the one n tile of an 8-wide warp tile).
template <int BM, int BN, int WM, int WN, int KS>
__device__ void layer_gemm(bf16* smem, const Chain& p, int l, int b, int ra, int rb, int cx0,
                           int cw, int xlo_in, int xlo_out, bf16* __restrict__ out) {
  constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static_assert(WARPS_M * WARPS_N * 32 == NT && WM % 16 == 0, "warp tile");
  static_assert(WN == 8 || WN % 16 == 0, "an ldmatrix.x4.trans takes two n tiles");
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int B_LD = (BN < 16 ? 16 : BN) + 8;
  constexpr int NQ = BN / 8;  // 16-byte groups in a row of a weight slot
  constexpr int B_VECS = (KS * NQ + NT - 1) / NT;
  constexpr int GROUPS = KS / 16;
  constexpr int PART = 4;  // k groups summed in the tensor core before a rounded add
  static_assert(BN % 8 == 0 && GROUPS % PART == 0, "slot shape");
  // a wide warp tile has work enough in one partial
  constexpr int UNROLL = MI * NI >= 8 ? 1 : 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int gq = lane >> 2, tq = lane & 3;
  const int Cin = p.C[l], Cout = p.C[l + 1];
  const int K16 = c16(Cin), G16 = K16 / 16, K = 9 * K16, N8 = c8(Cout);
  const int Pin = pixel_stride<bf16>(Cin), Qin = p.Q[l], in_row = p.NX[l] * Pin;
  const bool last = l == p.n - 1;
  const int Pout = last ? 0 : pixel_stride<bf16>(Cout);
  const int Qout = last ? 1 : p.Q[l + 1], out_row = last ? 0 : p.NX[l + 1] * Pout;
  const bf16* const ring = smem + p.off[l];
  bf16* const wsm = smem + p.ws_off;
  const bf16* const wg = static_cast<const bf16*>(p.w[l]);
  const unsigned short* const wg16 = reinterpret_cast<const unsigned short*>(wg);
  const float* const bias = p.bias[l];
  const bool vec_w = (p.vec_w >> l) & 1;
  const int M = (rb - ra) * cw;
  const int nsteps = (K + KS - 1) / KS;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  for (int m0 = 0; m0 < M; m0 += BM) {
    // The pixel this lane addresses for ldmatrix in fragment mi (a pixel past
    // M reads the tile's first pixel and is not written), and its ring offset
    // of input rows ky - 1 = -1, 0, 1 at column -1, its k half included.
    int aoff[3][MI];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int m = m0 + wm * WM + mi * 16 + (lane & 15);
      const int mm = m < M ? m : m0;
      const int r = mm / cw;
      const int y = ra + r, xc = cx0 + (mm - r * cw);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
        aoff[ky][mi] = ((y + ky) % Qin) * in_row + (xc - 1 - xlo_in) * Pin + 8 * (lane >> 4);
    }
    const bool m_live = m0 + wm * WM < M;
    for (int n0 = 0; n0 < N8; n0 += BN) {
      const bool live = m_live && n0 + wn * WN < N8;

      auto load_slot = [&](int slot, int k0) {
        bf16* const bs = wsm + slot * p.ws_slot;
        // not unrolled: the 2-byte path holds eight loads a group in registers,
        // and unrolled over the wide tile's eight groups it spilled at 255
#pragma unroll 1
        for (int j = 0; j < B_VECS; ++j) {
          const int e = tid + j * NT;
          if ((KS * NQ) % NT != 0 && e >= KS * NQ) continue;  // fewer groups than threads
          const int kk = e / NQ, nq = e - kk * NQ;
          const int kr = k0 + kk, n = n0 + 8 * nq;
          const int t = kr / K16, c = kr - t * K16;
          const bool kv = kr < K && c < Cin;
          const int64_t row = (int64_t)(kv ? t * Cin + c : 0) * Cout;
          bf16* const dst = bs + kk * B_LD + 8 * nq;
          if (vec_w) {
            const bool v = kv && n < Cout;
            cp_async16(dst, v ? wg + row + n : wg, v);
          } else {
            // a weight row may start on a 2-byte boundary: eight plain loads
            unsigned short v8[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const bool v = kv && n + q < Cout;
              v8[q] = v ? __ldg(wg16 + row + n + q) : (unsigned short)0;
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

      // one 16-deep k group: tap (ky, kx), channels c0 .. c0 + 15, B rows kk ..;
      // its products summed into part (which it starts when first), which is
      // added to the sums with a rounded add when last
      auto group = [&](const bf16* bs, int kk, int ky, int kx, int c0,
                       float (&part)[MI][NI][4], bool first, bool last_group) {
        uint32_t bfr[NI][2];
        if constexpr (NI == 1) {
          uint32_t r[2];
          ldmatrix_x2_trans(r, bs + kk * B_LD);
          bfr[0][0] = r[0]; bfr[0][1] = r[1];
        } else {
#pragma unroll
          for (int ni = 0; ni < NI; ni += 2) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, bs + kk * B_LD + ni * 8);
            bfr[ni][0] = r[0]; bfr[ni][1] = r[1];
            bfr[ni + 1][0] = r[2]; bfr[ni + 1][1] = r[3];
          }
        }
        const int koff = kx * Pin + c0;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int o = ky == 0 ? aoff[0][mi] : ky == 1 ? aoff[1][mi] : aoff[2][mi];
          uint32_t afr[4];
          ldmatrix_x4(afr, ring + o + koff);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            if (first) mma_bf16(part[mi][ni], afr, bfr[ni][0], bfr[ni][1], zero);
            else mma_bf16(part[mi][ni], afr, bfr[ni][0], bfr[ni][1], part[mi][ni]);
            if (last_group) {
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[mi][ni][r] += part[mi][ni][r];
            }
          }
        }
      };

#pragma unroll
      for (int st = 0; st < STAGES - 1; ++st) {
        if (st < nsteps) load_slot(st, st * KS);
        cp_async_commit();
      }
      for (int step = 0; step < nsteps; ++step) {
        // slot step has landed for every thread (cp.async, and the plain
        // stores before the barrier), and every warp is done with slot
        // step - 1, which the next load refills
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        const int nxt = step + STAGES - 1;
        if (nxt < nsteps) load_slot(nxt % STAGES, nxt * KS);
        cp_async_commit();
        if (!live) continue;

        const bf16* const bs = wsm + (step % STAGES) * p.ws_slot + (lane & 15) * B_LD + wn * WN
                               + 8 * (lane >> 4);
        // the tap and first channel of the slot's first k group
        const int g0 = step * GROUPS, t0 = g0 / G16;
        int c0 = (g0 - t0 * G16) * 16, ky = t0 / 3, kx = t0 - 3 * ky;
        auto next = [&]() {
          c0 += 16;
          const bool next_tap = c0 == K16;
          c0 = next_tap ? 0 : c0;
          kx += next_tap;
          const bool next_row = kx == 3;
          kx = next_row ? 0 : kx;
          ky += next_row;
        };
        if ((step + 1) * KS <= K) {
#pragma unroll UNROLL
          for (int jb = 0; jb < GROUPS; jb += PART) {
            float part[MI][NI][4];
#pragma unroll
            for (int j = 0; j < PART; ++j) {
              group(bs, 16 * (jb + j), ky, kx, c0, part, j == 0, j == PART - 1);
              next();
            }
          }
        } else {
          for (int j = 0; j < GROUPS && step * KS + 16 * j < K; ++j) {
            float part[MI][NI][4];
            group(bs, 16 * j, ky, kx, c0, part, true, true);
            next();
          }
        }
      }
      cp_async_wait<0>();  // only empty groups are left; leave none in flight

      if (live) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm * WM + mi * 16 + gq + 8 * h;
            if (m >= M) continue;
            const int r = m / cw;
            const int y = ra + r, xc = cx0 + (m - r * cw);
            bf16* const dst = last
                ? out + ((int64_t)(b * p.H + y) * p.W + xc) * Cout
                : smem + p.off[l + 1] + ((y + 1) % Qout) * out_row + (xc - xlo_out) * Pout;
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
              const int n = n0 + wn * WN + ni * 8 + 2 * tq;
              if (n >= N8) continue;
              // channels past C_{l+1} hold 0 + 0: the next layer's K reads them
              const float v0 = acc[mi][ni][2 * h] + (n < Cout ? bf16_bias(bias, n) : 0.f);
              const float v1 = acc[mi][ni][2 * h + 1] + (n + 1 < Cout ? bf16_bias(bias, n + 1) : 0.f);
              if (!last || (Cout & 1) == 0) {  // n even: an aligned pair
                if (!last || n < Cout)
                  *reinterpret_cast<__nv_bfloat162*>(dst + n) = __floats2bfloat162_rn(v0, v1);
              } else {
                if (n < Cout) dst[n] = __float2bfloat16_rn(v0);
                if (n + 1 < Cout) dst[n + 1] = __float2bfloat16_rn(v1);
              }
            }
          }
      }
      __syncthreads();  // the weight ring is refilled by the next tile
    }
  }
}

// ------------------------------------------------------------ the chain
// Layer l produces rows [r0, r1) of stage l + 1: its border rows as zeros,
// the rest by the GEMM with the layer's warp tile.
template <typename T>
__device__ void layer_rows(T* smem, const Chain& p, int l, int b, int r0, int r1, int x0, int x1,
                           T* __restrict__ out) {
  constexpr int KF = 4 / (int)sizeof(T);  // bf16 slots hold twice the rows
  const int n = p.n;
  if (l + 1 < n)
    for (int y = r0; y < r1; ++y)
      if (y < 0 || y >= p.H) zero_row(smem, p, l + 1, y);
  const int ra = max(r0, 0), rb = min(r1, p.H);
  if (rb <= ra) return;
  const Span xin = stage_span(x0, x1, n, l, p.W), xout = stage_span(x0, x1, n, l + 1, p.W);
  const int cx0 = max(0, xout.lo), cw = min(p.W, xout.hi) - cx0;
  const int n8 = c8(p.C[l + 1]);
  // ops/fused_chain.LAYER_TILES: (BM, BN, WM, WN, KS) by the layer's width
  if (n8 <= 8) layer_gemm<128, 8, 16, 8, 128 * KF>(smem, p, l, b, ra, rb, cx0, cw, xin.lo, xout.lo, out);
  else if (n8 <= 16) layer_gemm<128, 16, 16, 16, 128 * KF>(smem, p, l, b, ra, rb, cx0, cw, xin.lo, xout.lo, out);
  else if (n8 <= 64) layer_gemm<128, 64, 32, 32, 64 * KF>(smem, p, l, b, ra, rb, cx0, cw, xin.lo, xout.lo, out);
  else layer_gemm<64, 128, 32, 32, 64 * KF>(smem, p, l, b, ra, rb, cx0, cw, xin.lo, xout.lo, out);
}

// T: float (the float32 chain) or bf16 (its bf16 instance).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
chain_kernel(const T* __restrict__ x, T* __restrict__ out, Chain p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int per_image = p.strips * p.panels;
  const int b = blockIdx.x / per_image;
  const int blk = blockIdx.x - b * per_image;
  const int o0 = (blk / p.panels) * p.strip, o1 = min(p.H, o0 + p.strip);
  const int x0 = (blk % p.panels) * p.panel, x1 = min(p.W, x0 + p.panel);
  const int n = p.n;

  // every ring starts as zeros: border columns and pad channels stay so
  zero16(smem, p.ws_off);
  int nxt[MAXL + 1], hi[MAXL + 1];
  for (int s = 0; s <= n; ++s) {
    const Span r = stage_span(o0, o1, n, s, p.H);
    nxt[s] = r.lo;
    hi[s] = r.hi;
  }
  const Span x_in = stage_span(x0, x1, n, 0, p.W);
  __syncthreads();

  // The row schedule of ops/fused_chain.advance: stage 0 takes up to RS
  // rows, then each layer up to RS rows whose input rows are stored. A
  // step's input rows are loaded while the step before runs its layers
  // 1 .. n-1: they replace rows layer 0 no longer reads (each stage lags its
  // input by at most one row), and no layer but layer 0 reads stage 0. (A
  // one-step plan, whose stage 2 shares stage 0's memory, loads all its
  // input rows in the first step.)
  int loading = min(hi[0], nxt[0] + p.rs);  // rows [nxt[0], loading) in flight
  load_rows(x, smem, p, b, nxt[0], loading, x_in);
  while (nxt[n] < hi[n]) {
    if (loading > nxt[0]) {
      cp_async_wait<0>();
      __syncthreads();
      nxt[0] = loading;
    }
    for (int l = 0; l < n; ++l) {
      const int lim = nxt[l] == hi[l] ? hi[l + 1] : nxt[l] - 1;
      const int e = min(min(hi[l + 1], nxt[l + 1] + p.rs), lim);
      if (e > nxt[l + 1]) {
        if ((p.clear >> (l + 1)) & 1 && nxt[l + 1] == stage_span(o0, o1, n, l + 1, p.H).lo) {
          // a one-step plan: stage l + 1 takes over the ring of stage l - 1,
          // which no layer reads again; the layer's first barrier orders these
          // zeros before its epilogue's writes
          zero16(smem + p.off[l + 1], p.Q[l + 1] * p.NX[l + 1] * pixel_stride<T>(p.C[l + 1]));
        }
        layer_rows(smem, p, l, b, nxt[l + 1], e, x0, x1, out);
        __syncthreads();
        nxt[l + 1] = e;
      }
      if (l == 0) {
        loading = min(hi[0], nxt[0] + p.rs);
        if (loading > nxt[0]) load_rows(x, smem, p, b, nxt[0], loading, x_in);
      }
    }
  }
}

// Elements of T a weight slot of a layer with `cout` outputs holds: its
// tile's KS rows of BN + 8 (ops/fused_chain.slot_size).
template <typename T>
int slot_size(int cout) {
  const int n8 = (cout + 7) & ~7;
  const int bn = n8 <= 8 ? 8 : n8 <= 16 ? 16 : n8 <= 64 ? 64 : 128;
  return (n8 <= 16 ? 128 : 64) * (4 / (int)sizeof(T)) * ((bn < 16 ? 16 : bn) + 8);
}

// Makes `device` current for a call (restored by the destructor).
struct OnDevice {
  int prev = 0, device;
  cudaError_t err;
  explicit OnDevice(int d) : device(d) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~OnDevice() {
    if (err == cudaSuccess && prev != device) cudaSetDevice(prev);
  }
};

template <typename T>
int chain_call(int device, const void* x, const void* const* ws, const void* const* bs,
               const int* chans, int n, void* out, int B, int H, int W, const int* geo,
               void* stream) {
  constexpr int V = 16 / (int)sizeof(T);  // elements in 16 bytes
  if (n < 1 || n > MAXL || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Chain p;
  for (int l = 0; l < n; ++l) {
    p.w[l] = ws[l];
    p.bias[l] = static_cast<const float*>(bs[l]);
  }
  for (int l = 0; l <= n; ++l) p.C[l] = chans[l];
  p.n = n; p.B = B; p.H = H; p.W = W;
  p.strip = geo[0]; p.panel = geo[1]; p.rs = geo[2];
  p.ws_off = geo[3]; p.ws_slot = geo[4];
  const int smem = geo[5];
  p.clear = geo[6];
  if (p.strip < 1 || p.panel < 1 || p.rs < 1 || p.ws_off % V) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < n; ++s) {
    p.Q[s] = geo[7 + s];
    p.NX[s] = geo[7 + n + s];
    p.off[s] = geo[7 + 2 * n + s];
    const int size = p.Q[s] * p.NX[s] * pixel_stride<T>(p.C[s]);
    if (p.Q[s] < 1 || p.NX[s] < 1 || p.off[s] < 0 || p.off[s] % V || p.off[s] + size > p.ws_off)
      return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l < n; ++l)
    if (slot_size<T>(p.C[l + 1]) > p.ws_slot) return (int)cudaErrorInvalidValue;
  if (p.ws_slot % V || smem > SMEM_MAX
      || smem < (int)sizeof(T) * (p.ws_off + STAGES * p.ws_slot))
    return (int)cudaErrorInvalidValue;
  p.strips = (H + p.strip - 1) / p.strip;
  p.panels = (W + p.panel - 1) / p.panel;
  p.vec_x = p.C[0] % V == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  p.vec_w = 0;
  for (int l = 0; l < n; ++l)
    if (p.C[l + 1] % V == 0 && (reinterpret_cast<uintptr_t>(ws[l]) & 15) == 0) p.vec_w |= 1 << l;

  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  // The attribute holds per device; set it on the first launch there (a
  // repeat from two threads at once is harmless).
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> ready[kMaxDevices];
  if (device < 0 || device >= kMaxDevices || !ready[device].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < kMaxDevices) ready[device].store(true, std::memory_order_release);
  }
  const unsigned grid = (unsigned)B * p.strips * p.panels;
  chain_kernel<T><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// chans holds C_0 .. C_n; ws and bs hold n device pointers each (host arrays).
// geo is the plan of ops/fused_chain.plan_chain: strip, panel, rows a step, the weight
// ring's offset and slot size, the shared memory in bytes, the stages zeroed
// before their first row, then per stage its ring rows, ring pixels and ring
// offset (n each); offsets and sizes in elements of the chain's type. The
// biases are float32 in both instances; x, the weights and out are float32
// (svrs_conv3x3_chain) or bf16 (svrs_conv3x3_chain_bf16).
int svrs_conv3x3_chain(int device, const void* x, const void* const* ws, const void* const* bs,
                       const int* chans, int n, void* out, int B, int H, int W, const int* geo,
                       void* stream) {
  return chain_call<float>(device, x, ws, bs, chans, n, out, B, H, W, geo, stream);
}

int svrs_conv3x3_chain_bf16(int device, const void* x, const void* const* ws,
                            const void* const* bs, const int* chans, int n, void* out, int B,
                            int H, int W, const int* geo, void* stream) {
  return chain_call<bf16>(device, x, ws, bs, chans, n, out, B, H, W, geo, stream);
}

}  // extern "C"
