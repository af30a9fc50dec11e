// W8A8 int8 fused conv kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of simple_vae_rs_tpu/ops/pallas_int8.py:
//   svrs_act_absmax      <- the absmax half of _quant_act / _act_quant_host
//   svrs_act_quant       <- the quantize half of _quant_act (:67), which every
//                           TPU kernel runs once on its tile
//   svrs_int8_tc         <- int8_conv3x3_bn_relu (:216) and its row-strip
//                           variant _int8_conv3x3_strips (:169), mode kConv3;
//                           int8_conv4x4s2_bn_relu (:328), mode kConv4 (4x4,
//                           stride 2, pad 1); int8_convT4x4s2_bn_relu (:441),
//                           mode kConvT (transposed 4x4, stride 2, pad 1,
//                           kernel in the input-dilated form)
// Each conv computes, with x NHWC float32 and the weight int8 with one
// float32 scale ks[o] per output channel,
//   a      = max(absmax(x over the image's group) / 127, 1e-12)
//   qx     = clip(rint(x / a), -127, 127)           (half to even, a true division)
//   acc    = sum over taps and channels of qx * wq   (int32, exact)
//   out    = act(float(acc) * ((a * ks[o]) * scale[o]) + shift[o])
// A group is act_group consecutive images: the whole batch is what the
// reference int8_reference* and the strip kernel compute, a smaller group
// reproduces a Pallas launch of several programs.
//
// Design of the three convs (int8_tc). The TPU kernel holds a whole padded
// batch tile in VMEM, takes its absmax there, quantizes it once (_quant_act)
// and runs int8 dots with int32 accumulation. A block here owns one output
// tile and no block sees the whole group, so the work is three passes on one
// stream, with no host sync:
//   1. act_absmax: the group's absmax (a read-bound streaming reduction: see
//      its note below). Absmax over the padded tile equals absmax over x (the
//      pad is zeros), so no pad is stored.
//   2. act_quant: x quantized ONCE into an int8 NHWC buffer qx whose channel
//      stride is Cp = round_up(C, 16), the pad channels 0. Bound by bytes: 4
//      read and Cp / C written per element. A thread owns 16 channels of one
//      pixel: up to four 16-byte loads, one 16-byte store.
//   3. int8_tc: an implicit GEMM on the int8 tensor cores
//      (mma.sync.m16n8k32.s8.s8.s32) over qx: M = output pixels (per output
//      phase for the transposed conv, blockIdx.z = phase * splits + split;
//      the strided conv's pixel (oy, ox) reads from (2 oy - 1, 2 ox - 1)),
//      N = O, K = live taps * Cp, counted in 32-bit words of four channels
//      (Kw = taps * Cp / 4) in the order tap * Cp + c. A 16-byte word of qx
//      is 16 channels of one pixel and one tap, so A moves by 16-byte
//      cp.async only (a tap outside the image is a zero fill), with the tap
//      of each staged word resolved once per step. The weight is packed once
//      per module (ops/fused_int8.pack_kernel_q) to (kh * kw * Cp / 4, O)
//      words, four consecutive channels of one output channel in one word:
//      the s8 MMA's B fragment layout as it stands. The epilogue
//      dequantises with the row's group scale and applies the affine and the
//      ReLU with separate roundings, as the plain version does.
// The int8 product sums exactly in int32 (|acc| <= 127^2 * 16 * 432 < 2^31
// at the canonical widths), in the tensor core and across K splits alike, so
// the kernel equals its plain version bit for bit; nothing of the float
// kernels' rounded promotion is needed.
// What bounds it: at the 64x64 decoder tail (C, O <= 64, millions of pixels)
// bytes (float32 in, twice, for the two passes; float32 out); at the deep
// layers (C = 424, 256) operations, against the int8 tensor-core peak of
// 1,979 TOP/s. With the MMAs nearly free, quantizing per tap and per N tile
// would be the whole kernel (the first, CUDA-core dp4a design of these convs
// did: 9 to 16 true divisions per activation); pass 2 does each division
// once, and the MMA loop reads int8 words only. mma.sync and not wgmma: the
// first tensor-core version keeps conv_tc's shape (csrc/fused_conv.cu) and
// its proven fragment maps.
// Later work: wgmma with TMA-fed operands, and folding the quantize pass into
// the kernel that produces x (its epilogue would need the group's absmax
// before the group is complete, so that is a two-kernel handshake).
//
// bf16 instances (the *_bf16 entry points; a bf16 model's convs hand the int8
// kernels x in bf16, as the JAX blocks hand them x.astype(dtype)): the absmax
// and quantize passes read bf16 and upcast each element to float32, which is
// exact, so the group absmax, the scales and every byte of qx equal what the
// float32 passes give on the upcast tensor (the TPU kernels upcast the tile
// before _quant_act, pallas_int8.py:97). int8_tc is templated on its output
// type: the same exact int32 sums and float32 epilogue, then one round to
// nearest even to bf16 (__float2bfloat16_rn), in the direct epilogue and in
// the K-split reduce alike (the TPU kernels store out.astype(x.dtype)). A bf16
// pair is stored as one __nv_bfloat162 where O is even (every row, and every
// phase's row of the transposed conv, then starts on an even element), else
// element by element. The passes stream 2 bytes an element instead of 4: the
// absmax pass's body reads whole 16-byte words (8 elements) with a head and a
// tail of up to 7 elements read alone, and the quantize pass reads a pixel's
// 16 channels as two 16-byte words where C % 8 == 0; otherwise a pixel's
// channel run starts on a 2-byte boundary and each channel is one masked
// 2-byte load (a wider load could reach past the tensor).
// Layout: A staged [BM][32 + 4] words, B [32][BN + 8] words, a ring of
// cp.async slots in dynamic shared memory; the padding makes every fragment
// read hit 32 distinct banks. Fragment maps
// (PTX m16n8k32 .s8, lane = 4 * gq + tq, in words of four k): A a0 (row gq,
// word tq), a1 (gq + 8, tq), a2 (gq, tq + 4), a3 (gq + 8, tq + 4); B b0
// (word tq, column gq), b1 (word tq + 4, column gq); C c0/c1 (gq, 2tq /
// 2tq+1), c2/c3 (gq + 8, 2tq / 2tq+1): at word granularity the m16n8k8 TF32
// maps of conv_tc. A step is 32 words (128 channels); its 8-word sub-steps
// past the end of K are skipped (a block-uniform branch), so a narrow C
// (Cp = 16: 36 words) multiplies few zeros. Tiles (ops/fused_int8.
// plan_int8_tc, which counts the phases' blocks and splits K when the tiles
// leave SMs idle): 128x128 (N > 64), 128x64 (16 < N <= 64), 128x16 (N <= 16:
// the 64x64 tail's O = 16 and O = 4, columns past O masked) and 32x128 for
// M <= 64 per phase. The transposed conv's weight row of staged word k is
// wtap(k / (Cp/4), phase) * Cp/4 + k % (Cp/4), k / (Cp/4) a multiply-high
// by host-computed constants (div_w), not an integer division. Each int8_tc
// instance gets its dynamic shared memory limit raised once per device, on
// its first launch there. svrs_int8_tc runs passes 2 and 3 and the K-split
// reduce in one C call that makes the device current itself, so the wrapper
// needs no device context and no Stream object.
//
// Interface: plain C, loaded with ctypes. Every function launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue for a mode
// or tile configuration it does not know).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

enum Mode { kConv3 = 0, kConv4 = 1, kConvT = 2 };

typedef __nv_bfloat16 bf16;

// The activations' element type T (float or bf16): elements in one 16-byte
// word, and an element as float32 (exact for both).
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const bf16* p) {
  return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// The elements of one 16-byte word as float32, in order.
__device__ __forceinline__ void unpack(const uint4& w, const float*, float* v) {
  v[0] = __uint_as_float(w.x); v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z); v[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, const bf16*, float* v) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);              // the lower element
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// One output element, or two neighbours (n even, the element offset even),
// rounded once to the output type.
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

struct Geo {
  int B, H, W, C, O;  // input batch/height/width/channels, output channels
  int C4;             // words of four channels per tap: Cp / 4 = round_up(C, 16) / 4
                      // (qx's pixel stride)
  int Ho, Wo;         // GEMM grid per phase (output pixels of one phase)
  int M;              // B * Ho * Wo
  int K4;             // live taps * C4
  int phases;         // 1, or 4 for the transposed conv
  int act_group;      // images per activation scale
  unsigned c_mul;     // k / C4 == umulhi(k, c_mul) >> c_shr for 0 <= k < 2^31
  int c_shr;
};

// k / C4 without a division instruction (the round-up method of Granlund and
// Montgomery, as CUTLASS's FastDivmod): exact for 0 <= k < 2^31.
__device__ __forceinline__ int div_w(const Geo& g, int k) {
  return (int)(__umulhi((unsigned)k, g.c_mul) >> g.c_shr);
}

__device__ __forceinline__ float act_scale(const float* __restrict__ amax, int group) {
  return fmaxf(__fdiv_rn(amax[group], 127.0f), 1e-12f);
}

__device__ __forceinline__ int quant1(float v, float a) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, a)), -127.0f), 127.0f);
  return __float2int_rn(r);
}

__device__ __forceinline__ int pack4(int q0, int q1, int q2, int q3) {
  // byte j holds channel j: the layout of the repacked weight words
  return (int)((unsigned)(q0 & 0xff) | ((unsigned)(q1 & 0xff) << 8) |
               ((unsigned)(q2 & 0xff) << 16) | ((unsigned)q3 << 24));
}

// Input offsets (relative to oy*stride, ox*stride) and weight tap of tap t.
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

template <int MODE>
__device__ __forceinline__ int64_t out_offset(const Geo& g, int p, int m, int n) {
  if constexpr (MODE != kConvT) return (int64_t)m * g.O + n;
  const int hw = g.Ho * g.Wo;
  const int b = m / hw, r = m - b * hw;
  const int i = r / g.Wo, j = r - i * g.Wo;
  const int oh = 2 * i + (p >> 1), ow = 2 * j + (p & 1);
  return (((int64_t)b * (2 * g.Ho) + oh) * (2 * g.Wo) + ow) * g.O + n;
}

__device__ __forceinline__ float epilogue(int acc, float a, float ks, float scale,
                                          float shift, int relu) {
  // separate roundings, as the plain version computes it (no fused multiply-add)
  const float mult = __fmul_rn(__fmul_rn(a, ks), scale);
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), mult), shift);
  return relu ? fmaxf(v, 0.0f) : v;
}

// Sums the K-split partials (exact in int32) and applies the epilogue (and,
// for a bf16 output, the one rounding).
template <typename TO, int MODE>
__global__ void splitk_reduce(const int* __restrict__ ws, const float* __restrict__ ks,
                              const float* __restrict__ scale, const float* __restrict__ shift,
                              const float* __restrict__ amax, TO* __restrict__ out,
                              Geo g, int relu, int splits) {
  const int64_t total = (int64_t)g.phases * g.M * g.O;
  const int hw = g.Ho * g.Wo;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int n = (int)(e % g.O);
    const int64_t r = e / g.O;
    const int p = (int)(r / g.M), m = (int)(r - (int64_t)p * g.M);
    int acc = 0;
    for (int s = 0; s < splits; ++s) acc += ws[s * total + e];
    const float a = act_scale(amax, (m / hw) / g.act_group);
    store1(out + out_offset<MODE>(g, p, m, n), epilogue(acc, a, ks[n], scale[n], shift[n], relu));
  }
}

template <typename TO, int MODE>
cudaError_t reduce_splits(const float* ks, const float* scale, const float* shift,
                          const float* amax, TO* out, const int* ws, const Geo& g, int relu,
                          int splits, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t total = (int64_t)g.phases * g.M * g.O;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  splitk_reduce<TO, MODE><<<blocks, 256, 0, st>>>(ws, ks, scale, shift, amax, out, g, relu,
                                                   splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- act_quant
// One thread: channels 16j .. 16j+15 of one pixel, one 16-byte word of qx.
// vec: C a multiple of kVec<T> (4 floats, 8 bf16) and x 16-byte aligned, so a
// pixel's channels start on a 16-byte boundary and come as whole 16-byte
// words; otherwise one masked load a channel.
constexpr int QUANT_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
act_quant(const T* __restrict__ x, const float* __restrict__ amax, int4* __restrict__ qx,
          int words, int C16, int hw, int C, int act_group, int vec) {
  constexpr int V = kVec<T>;
  const int e = blockIdx.x * QUANT_THREADS + threadIdx.x;
  if (e >= words) return;
  const int pix = e / C16, j = e - pix * C16;
  const float a = act_scale(amax, (pix / hw) / act_group);
  const T* const src = x + (int64_t)pix * C + 16 * j;
  const int live = min(16, C - 16 * j);
  int q[16];
  if (vec) {
#pragma unroll
    for (int w = 0; w < 16 / V; ++w) {
      float v[V];
      if (V * w < live) {
        unpack(__ldg(reinterpret_cast<const uint4*>(src) + w), src, v);
#pragma unroll
        for (int i = 0; i < V; ++i) q[V * w + i] = quant1(v[i], a);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) q[V * w + i] = 0;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) q[i] = i < live ? quant1(load_f(src + i), a) : 0;
  }
  qx[e] = make_int4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                    pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
}

template <typename T>
cudaError_t launch_act_quant(const T* x, const float* amax, void* qx, const Geo& g,
                             cudaStream_t st) {
  const int c16 = g.C4 / 4;
  const int words = g.B * g.H * g.W * c16;
  if (words == 0) return cudaSuccess;
  const int vec = g.C % kVec<T> == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  act_quant<T><<<(words + QUANT_THREADS - 1) / QUANT_THREADS, QUANT_THREADS, 0, st>>>(
      x, amax, static_cast<int4*>(qx), words, c16, g.H * g.W, g.C, g.act_group, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- int8_tc
constexpr int TC_BKW = 32;  // words of K per step: 128 channels

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
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

// d += a * b on one m16n8k32 tile (A row-major 16x32 s8, B column-major
// 32x8 s8, D 16x8 s32), exact.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BN, int STAGES>
constexpr int tc_smem_bytes() {
  return STAGES * (BM * (TC_BKW + 4) + TC_BKW * (BN + 8)) * (int)sizeof(int);
}

// Weight row (of the (kh * kw * Cp/4, O) packed words) that staged word k of
// phase p reads.
template <int MODE>
__device__ __forceinline__ int weight_row(const Geo& g, int k, int p) {
  if constexpr (MODE != kConvT) {
    return k;  // every tap is live, in the weight's own order
  } else {
    const int t = div_w(g, k);
    int dy, dx, wtap;
    tap_geometry<MODE>(t, p, dy, dx, wtap);
    return k + (wtap - t) * g.C4;  // wtap * Cp/4 + k % (Cp/4)
  }
}

// TO, the output type: float, or bf16 for the bf16 instances (the same
// kernel; only the epilogue's store rounds).
template <typename TO, int MODE, int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
int8_tc(const int* __restrict__ qx, const int* __restrict__ wq,
        const float* __restrict__ ks, const float* __restrict__ scale,
        const float* __restrict__ shift, const float* __restrict__ amax,
        TO* __restrict__ out, int* __restrict__ ws, Geo g, int relu,
        int splits, int kchunk, int vec_b) {
  constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int A_LD = TC_BKW + 4, B_LD = BN + 8;
  constexpr int A_TILE = BM * A_LD, B_TILE = TC_BKW * B_LD;
  constexpr int KQ = TC_BKW / 4;          // 16-byte groups in a row of A
  constexpr int A_ROWS = BM * KQ / NT;    // rows of A a thread stages per step
  constexpr int NQ = BN / 4;              // 16-byte groups in a row of B
  constexpr int B_VECS = (TC_BKW * NQ + NT - 1) / NT;  // groups of B a thread stages per step
  constexpr int STRIDE = MODE == kConv4 ? 2 : 1;
  static_assert(WM % 16 == 0 && WN % 8 == 0 && STAGES >= 2 && BN % 16 == 0, "warp tile");
  static_assert(B_LD % 32 == 8 || B_LD % 32 == 24, "conflict-free B fragment reads");
  static_assert(NT % KQ == 0 && (BM * KQ) % NT == 0, "tile shape");

  extern __shared__ __align__(16) int smem[];
  int* const As = smem;
  int* const Bs = smem + STAGES * A_TILE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int p = blockIdx.z / splits;
  const int s = blockIdx.z - p * splits;
  const int kbeg = s * kchunk;
  const int kend = min(g.K4, kbeg + kchunk);
  const int nsteps = kend > kbeg ? (kend - kbeg + TC_BKW - 1) / TC_BKW : 0;

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
    int* const as = As + slot * A_TILE + (tid / KQ) * A_LD + 4 * kq;
    int* const bs = Bs + slot * B_TILE;
    // words k .. k+3: 16 channels of one tap (Cp / 4 is a multiple of 4)
    const int k = k0 + 4 * kq;
    const bool kv = k < kend;
    const int t = kv ? div_w(g, k) : 0;
    const int c = k - t * g.C4;
    int dy, dx, wtap;
    tap_geometry<MODE>(t, p, dy, dx, wtap);
    const int off = dy * g.W + dx;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const int iy = a_y[i] + dy, ix = a_x[i] + dx;
      const bool v = kv && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
      cp_async16(as + i * (NT / KQ) * A_LD, v ? qx + (a_pix[i] + off) * g.C4 + c : qx, v);
    }
    // Each of the transposed conv's weight rows resolves its tap
    // (weight_row); as in conv_tc, the thin tile's eight go two at a time.
    constexpr int B_UNROLL = MODE == kConvT && B_VECS > 4 ? 2 : B_VECS;
#pragma unroll (B_UNROLL)
    for (int j = 0; j < B_VECS; ++j) {
      const int e = tid + j * NT;
      const int kk = e / NQ, nq = e - kk * NQ;
      const int kr = k0 + kk, n = n0 + 4 * nq;
      int* const dst = bs + kk * B_LD + 4 * nq;
      if ((TC_BKW * NQ) % NT != 0 && e >= TC_BKW * NQ) continue;  // fewer groups than threads
      const bool kv = kr < kend;
      const int* const row = wq + (int64_t)(kv ? weight_row<MODE>(g, kr, p) : 0) * g.O;
      if (vec_b) {
        const bool v = kv && n < g.O;
        cp_async16(dst, v ? row + n : wq, v);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool v = kv && n + q < g.O;
          cp_async4(dst + q, v ? row + n + q : wq, v);
        }
      }
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load_stage(st, kbeg + st * TC_BKW);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    // slot step has landed for every thread, and every warp is done with
    // slot step - 1, which the next load refills
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = step + STAGES - 1;
    if (next < nsteps) load_stage(next % STAGES, kbeg + next * TC_BKW);
    cp_async_commit();

    const int live = kend - (kbeg + step * TC_BKW);  // words of K left, block-uniform
    const int* const as = As + (step % STAGES) * A_TILE + (wm * WM + gq) * A_LD + tq;
    const int* const bs = Bs + (step % STAGES) * B_TILE + tq * B_LD + wn * WN + gq;
#pragma unroll
    for (int kk = 0; kk < TC_BKW; kk += 8) {
      if (kk >= live) break;  // a sub-step wholly past the end of K
      uint32_t b[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int* const bp = bs + kk * B_LD + ni * 8;
        b[ni][0] = (uint32_t)bp[0];
        b[ni][1] = (uint32_t)bp[4 * B_LD];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int* const ap = as + mi * 16 * A_LD + kk;
        const uint32_t a[4] = {(uint32_t)ap[0], (uint32_t)ap[8 * A_LD], (uint32_t)ap[4],
                               (uint32_t)ap[8 * A_LD + 4]};
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], a, b[ni]);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left; leave none in flight

  // n is even, and with O even so is every element offset (the transposed
  // conv's phase rows included): n, n+1 is one 8-byte (4-byte bf16) store
  const bool pairs = (g.O & 1) == 0;
  const int hw = g.Ho * g.Wo;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + mi * 16 + gq + 8 * h;
      if (m >= g.M) continue;
      const float a = act_scale(amax, (m / hw) / g.act_group);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn * WN + ni * 8 + 2 * tq;
        if (n >= g.O) continue;
        const int v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (splits == 1) {
          TO* const row = out + out_offset<MODE>(g, p, m, 0);
          const float f0 = epilogue(v0, a, ks[n], scale[n], shift[n], relu);
          if (pairs) {
            store2(row + n, f0, epilogue(v1, a, ks[n + 1], scale[n + 1], shift[n + 1], relu));
          } else {
            store1(row + n, f0);
            if (n + 1 < g.O)
              store1(row + n + 1, epilogue(v1, a, ks[n + 1], scale[n + 1], shift[n + 1], relu));
          }
        } else {
          int* const row = ws + (((int64_t)s * g.phases + p) * g.M + m) * g.O;
          if (pairs) {
            *reinterpret_cast<int2*>(row + n) = make_int2(v0, v1);
          } else {
            row[n] = v0;
            if (n + 1 < g.O) row[n + 1] = v1;
          }
        }
      }
    }
  }
}

// int8_tc's tile configurations, picked by ops/fused_int8.plan_int8_tc.
//   0 wide:   BM=128 BN=128 warps 2x4 of 64x32, 3 stages  (N > 64)
//   1 mid:    BM=128 BN=64  warps 4x2 of 32x32, 3 stages  (16 < N <= 64)
//   2 narrow: BM=128 BN=16  warps 8x1 of 16x16, 4 stages  (N <= 16; with four
//             warps of 32x16, eight A rows a thread, ptxas spilled at 64 registers)
//   3 thin:   BM=32  BN=128 warps 1x4 of 32x32, 4 stages  (M <= 64 per phase)
template <typename TO, int MODE, int BM, int BN, int WM, int WN, int STAGES>
cudaError_t launch_tc(const int* qx, const int* wq, const float* ks, const float* scale,
                      const float* shift, const float* amax, TO* out, int* ws,
                      const Geo& g, int relu, int splits, int kchunk, cudaStream_t st) {
  constexpr int NT = (BM / WM) * (BN / WN) * 32;
  constexpr int SMEM = tc_smem_bytes<BM, BN, STAGES>();
  // The attribute holds per device; set it on this instance's first launch
  // on each device (a repeat from two threads at once is harmless).
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(int8_tc<TO, MODE, BM, BN, WM, WN, STAGES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev].store(true, std::memory_order_release);
  }
  const int vec_b = g.O % 4 == 0 && (reinterpret_cast<uintptr_t>(wq) & 15) == 0;
  dim3 grid((g.M + BM - 1) / BM, (g.O + BN - 1) / BN, g.phases * splits);
  int8_tc<TO, MODE, BM, BN, WM, WN, STAGES><<<grid, NT, SMEM, st>>>(
      qx, wq, ks, scale, shift, amax, out, ws, g, relu, splits, kchunk, vec_b);
  return reduce_splits<TO, MODE>(ks, scale, shift, amax, out, ws, g, relu, splits, st);
}

template <typename TO, int MODE>
cudaError_t launch_tc_cfg(int cfg, const int* qx, const int* wq, const float* ks,
                          const float* scale, const float* shift, const float* amax,
                          TO* out, int* ws, const Geo& g, int relu, int splits, int kchunk,
                          cudaStream_t st) {
  switch (cfg) {
    case 0: return launch_tc<TO, MODE, 128, 128, 64, 32, 3>(qx, wq, ks, scale, shift, amax, out, ws, g, relu, splits, kchunk, st);
    case 1: return launch_tc<TO, MODE, 128, 64, 32, 32, 3>(qx, wq, ks, scale, shift, amax, out, ws, g, relu, splits, kchunk, st);
    case 2: return launch_tc<TO, MODE, 128, 16, 16, 16, 4>(qx, wq, ks, scale, shift, amax, out, ws, g, relu, splits, kchunk, st);
    case 3: return launch_tc<TO, MODE, 32, 128, 32, 32, 4>(qx, wq, ks, scale, shift, amax, out, ws, g, relu, splits, kchunk, st);
    default: return cudaErrorInvalidValue;
  }
}

// A tap's words: Cp / 4 = round_up(C, 16) / 4, qx's pixel stride.
Geo make_geo(int B, int H, int W, int C, int O, int act_group, int mode) {
  Geo g;
  g.B = B; g.H = H; g.W = W; g.C = C; g.O = O;
  g.C4 = (C + 15) / 16 * 4;
  g.act_group = act_group;
  int taps;
  if (mode == kConv3) { g.Ho = H; g.Wo = W; taps = 9; g.phases = 1; }
  else if (mode == kConv4) { g.Ho = H / 2; g.Wo = W / 2; taps = 16; g.phases = 1; }
  else { g.Ho = H; g.Wo = W; taps = 4; g.phases = 4; }
  g.K4 = taps * g.C4;
  g.M = B * g.Ho * g.Wo;
  // div_w's constants (C4 >= 4): c_shr = 31 + ceil(log2 C4) - 32,
  // c_mul = ceil(2^(c_shr + 32) / C4)
  int l = 0;
  while ((1u << l) < (unsigned)g.C4) ++l;
  g.c_shr = l - 1;
  g.c_mul = (unsigned)(((1ull << (31 + l)) + g.C4 - 1) / g.C4);
  return g;
}

// Makes `device` current for a call (restored by the destructor), so the
// Python wrappers need no device context.
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

// Per-group absmax of x (svrs_act_absmax), group g = elements
// [g * per_group, min(numel, (g + 1) * per_group)).
//
// What bounds it: bytes. It reads x once and writes one float per group, so
// its bound is numel * sizeof(T) bytes over 3.35 TB/s (78 us for the 262 MB
// float32 input of a 1000-draw decode layer). To stream at that rate each SM
// needs tens of KB of reads in flight: a thread here issues AMAX_UNROLL
// independent 16-byte loads a loop trip (4 KB a warp), and the grid
// (ops/fused_int8.absmax_plan) gives every group enough blocks that all of
// them together fill the SMs, each block with at least 32 KB to read. The
// body of a group is the 16-byte words that lie wholly inside it; the up to
// kVec - 1 elements before its first word (the head) and after its last (the
// tail) are read alone by block 0 of the group, so a group whose element
// count is not a multiple of the word, or a word that straddles two groups,
// stays exact. Each element is read once.
//
// A block's maximum is combined across blocks with one atomicMax on the bit
// pattern of |x|, which orders like the value for non-negative floats, so the
// result is the same in any order and bit-equal to the plain version (for
// finite x: fmaxf drops a NaN). The atomics need a zeroed result:
// svrs_act_absmax zeroes it with cudaMemsetAsync on the same stream, in the
// same call, so a pass is one call from Python and no separate fill launch
// (per-block partials reduced by the group's last block would need a zeroed
// counter all the same).
constexpr int AMAX_THREADS = 256, AMAX_UNROLL = 4;

template <typename T>
__global__ void __launch_bounds__(AMAX_THREADS)
act_absmax(const T* __restrict__ x, float* __restrict__ amax, int64_t per_group,
           int64_t numel) {
  constexpr int V = kVec<T>;
  const int64_t s = (int64_t)blockIdx.x * per_group;  // blockIdx.x: the group
  const int64_t e = min(numel, s + per_group);
  const int64_t a = min((s + V - 1) & ~(int64_t)(V - 1), e);  // start of its first whole word
  const int64_t z = max(e & ~(int64_t)(V - 1), a);            // end of its last whole word
  const int tid = threadIdx.x;
  float m = 0.0f;
  if (blockIdx.y == 0) {
    if (tid < a - s) m = fabsf(load_f(x + s + tid));                       // head
    else if (tid >= V && tid - V < e - z) m = fabsf(load_f(x + z + tid - V));  // tail
  }
  const uint4* const v = reinterpret_cast<const uint4*>(x + a);
  const int64_t nv = (z - a) / V;
  const int64_t trip = (int64_t)gridDim.y * AMAX_THREADS * AMAX_UNROLL;
  for (int64_t i = (int64_t)blockIdx.y * AMAX_THREADS * AMAX_UNROLL + tid; i < nv; i += trip) {
    uint4 r[AMAX_UNROLL];
#pragma unroll
    for (int u = 0; u < AMAX_UNROLL; ++u) {
      const int64_t j = i + u * AMAX_THREADS;
      r[u] = j < nv ? __ldg(v + j) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < AMAX_UNROLL; ++u) {
      float f[V];
      unpack(r[u], x, f);
#pragma unroll
      for (int k = 0; k < V; ++k) m = fmaxf(m, fabsf(f[k]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[AMAX_THREADS / 32];
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < AMAX_THREADS / 32 ? warp_max[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    // non-negative floats order like their bit patterns
    if (lane == 0) atomicMax(reinterpret_cast<unsigned int*>(amax) + blockIdx.x, __float_as_uint(m));
  }
}

template <typename T>
int absmax_call(int device, const void* x, void* amax, long long per_group, long long numel,
                int groups, int blocks_per_group, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float) * (size_t)groups, st);
  if (err == cudaSuccess) {
    act_absmax<T><<<dim3(groups, blocks_per_group), AMAX_THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<float*>(amax), (int64_t)per_group,
        (int64_t)numel);
    err = cudaGetLastError();
  }
  return (int)err;
}

template <typename T>
int quant_call(int device, const void* x, const void* amax, void* qx, int B, int H, int W, int C,
               int act_group, void* stream) {
  const OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const Geo g = make_geo(B, H, W, C, 0, act_group, kConv3);
  return (int)launch_act_quant(static_cast<const T*>(x), static_cast<const float*>(amax), qx, g,
                               static_cast<cudaStream_t>(stream));
}

// T: the type of x and of out (float, or bf16).
template <typename T>
int int8_tc_call(int device, int mode, int cfg, const void* x, const void* wq, const void* ks,
                 const void* scale, const void* shift, const void* amax, void* qx, void* out,
                 void* ws, int B, int H, int W, int C, int O, int act_group, int relu,
                 int splits, int kchunk, void* stream) {
  if (mode != kConv3 && mode != kConv4 && mode != kConvT) return (int)cudaErrorInvalidValue;
  const OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo g = make_geo(B, H, W, C, O, act_group, mode);
  const float* af = static_cast<const float*>(amax);
  cudaError_t err = launch_act_quant(static_cast<const T*>(x), af, qx, g, st);
  if (err != cudaSuccess) return (int)err;
  const int* q = static_cast<const int*>(qx);
  const int* w = static_cast<const int*>(wq);
  const float* kf = static_cast<const float*>(ks);
  const float* sf = static_cast<const float*>(scale);
  const float* tf = static_cast<const float*>(shift);
  T* of = static_cast<T*>(out);
  int* wsi = static_cast<int*>(ws);
  if (mode == kConv3)
    return (int)launch_tc_cfg<T, kConv3>(cfg, q, w, kf, sf, tf, af, of, wsi, g, relu, splits, kchunk, st);
  if (mode == kConv4)
    return (int)launch_tc_cfg<T, kConv4>(cfg, q, w, kf, sf, tf, af, of, wsi, g, relu, splits, kchunk, st);
  return (int)launch_tc_cfg<T, kConvT>(cfg, q, w, kf, sf, tf, af, of, wsi, g, relu, splits, kchunk, st);
}

}  // namespace

extern "C" {

// x must be 16-byte aligned and numel > 0; amax gets one float per group.
// The _bf16 entry points take x (and give out) in bf16.
int svrs_act_absmax(int device, const void* x, void* amax, long long per_group,
                    long long numel, int groups, int blocks_per_group, void* stream) {
  return absmax_call<float>(device, x, amax, per_group, numel, groups, blocks_per_group, stream);
}

int svrs_act_absmax_bf16(int device, const void* x, void* amax, long long per_group,
                         long long numel, int groups, int blocks_per_group, void* stream) {
  return absmax_call<bf16>(device, x, amax, per_group, numel, groups, blocks_per_group, stream);
}

// qx: B * H * W * round_up(C, 16) bytes, 16-byte aligned, fewer than 2^31.
int svrs_act_quant(int device, const void* x, const void* amax, void* qx, int B, int H, int W,
                   int C, int act_group, void* stream) {
  return quant_call<float>(device, x, amax, qx, B, H, W, C, act_group, stream);
}

int svrs_act_quant_bf16(int device, const void* x, const void* amax, void* qx, int B, int H,
                        int W, int C, int act_group, void* stream) {
  return quant_call<bf16>(device, x, amax, qx, B, H, W, C, act_group, stream);
}

// The 3x3 (mode 0), strided 4x4 (mode 1) or transposed (mode 2) W8A8 conv on
// the tensor cores:
// act_quant of x into qx, int8_tc over qx, and the K-split reduce when
// splits > 1, on `stream` of `device`. amax is the group absmax of x
// (svrs_act_absmax); wq the packed weight, (kh * kw * round_up(C, 16) / 4, O)
// words; ws splits * phases * M * O ints when splits > 1.
int svrs_int8_tc(int device, int mode, int cfg, const void* x, const void* wq, const void* ks,
                 const void* scale, const void* shift, const void* amax, void* qx, void* out,
                 void* ws, int B, int H, int W, int C, int O, int act_group, int relu,
                 int splits, int kchunk, void* stream) {
  return int8_tc_call<float>(device, mode, cfg, x, wq, ks, scale, shift, amax, qx, out, ws, B, H,
                             W, C, O, act_group, relu, splits, kchunk, stream);
}

int svrs_int8_tc_bf16(int device, int mode, int cfg, const void* x, const void* wq,
                      const void* ks, const void* scale, const void* shift, const void* amax,
                      void* qx, void* out, void* ws, int B, int H, int W, int C, int O,
                      int act_group, int relu, int splits, int kchunk, void* stream) {
  return int8_tc_call<bf16>(device, mode, cfg, x, wq, ks, scale, shift, amax, qx, out, ws, B, H,
                            W, C, O, act_group, relu, splits, kchunk, stream);
}

}  // extern "C"
