// W8A8 int8 fused conv kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of simple_vae_rs_tpu/ops/pallas_int8.py:
//   svrs_act_absmax      <- the absmax half of _quant_act / _act_quant_host
//   svrs_int8_conv3x3    <- int8_conv3x3_bn_relu and its row-strip variant
//                           _int8_conv3x3_strips (3x3, stride 1, SAME)
//   svrs_int8_conv4x4s2  <- int8_conv4x4s2_bn_relu   (4x4, stride 2, pad 1)
//   svrs_int8_convT4x4s2 <- int8_convT4x4s2_bn_relu  (transposed 4x4, stride 2,
//                           pad 1, kernel in the input-dilated form)
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
// Design. The TPU kernel holds a whole padded batch tile in VMEM, takes its
// absmax there and quantizes it once. A block here owns one output tile and
// no block sees the whole group, so the absmax is a pass of its own
// (svrs_act_absmax, a read-bound streaming reduction: see its note) and the
// conv reads the group's absmax from device memory: no host sync. Absmax over the padded tile equals absmax over x
// (the pad is zeros), so no pad is stored.
//
// The conv is the implicit GEMM of fused_conv.cu with K counted in packs of
// four channels: M = output pixels (per output phase for the transposed
// conv), N = O, K4 = live taps * ceil(C / 4). The wrapper repacks the weight
// once to (taps, ceil(C/4), O) int32, four consecutive channels of one output
// channel in one word (zero for channels past C). A block stages a BK-pack
// deep slice: activations are read as float32, quantized and packed to one
// int32 per four channels while they are staged (one float4 load when C is a
// multiple of 4), weights are read as packed words, and each thread
// accumulates a TM x TN micro-tile with __dp4a in int32 registers. The
// dequantisation, the affine and the ReLU run in the epilogue. When the
// output tiles alone would leave most SMs idle the launcher splits K; int32
// partials add exactly in any order, and a second pass sums them and applies
// the epilogue.
//
// The transposed conv computes each of the four output phases (u, v) from
// its four live taps only (the Pallas _T_TAPS table), as fused_conv.cu does.
//
// What bounds it on this card: the 64x64 decoder tail (C, O <= 64) is bound
// by bytes (float32 activations in and out); the deep layers (C = 424, 256)
// by operations: dp4a on the CUDA cores does 8 integer operations per lane
// and instruction, four times the float32 FMA rate and well below the int8
// tensor-core peak the bound is stated against. The division per staged
// activation (a multiply by the reciprocal would flip values on rounding
// boundaries) is paid once per N tile and tap.
//
// Interface: plain C, loaded with ctypes. Every function launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kConv3 = 0, kConv4 = 1, kConvT = 2 };

struct Geo {
  int B, H, W, C, O;  // input batch/height/width/channels, output channels
  int C4;             // packs of four channels per tap: ceil(C / 4)
  int Ho, Wo;         // GEMM grid per phase (output pixels of one phase)
  int M;              // B * Ho * Wo
  int K4;             // live taps * C4
  int phases;         // 1, or 4 for the transposed conv
  int act_group;      // images per activation scale
};

constexpr int BK = 8;  // packs per K step: 32 channels

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

template <int MODE, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
int8_igemm(const float* __restrict__ x, const int* __restrict__ wq,
           const float* __restrict__ ks, const float* __restrict__ scale,
           const float* __restrict__ shift, const float* __restrict__ amax,
           float* __restrict__ out, int* __restrict__ ws, Geo g, int relu,
           int splits, int kchunk) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int A_LD = BM * BK / NT;
  constexpr int B_LD = (BK * BN + NT - 1) / NT;
  constexpr int STRIDE = MODE == kConv4 ? 2 : 1;
  static_assert(NT % BK == 0 && (BM * BK) % NT == 0, "tile shape");
  static_assert(TM % 4 == 0, "micro-tile rows are read as int4");

  // +4 pads the rows so the transposed stores below hit distinct banks.
  __shared__ __align__(16) int As[BK][BM + 4];
  __shared__ __align__(16) int Bs[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int p = blockIdx.z / splits;
  const int s = blockIdx.z - p * splits;
  const int kbeg = s * kchunk;
  const int kend = min(g.K4, kbeg + kchunk);
  const int hw = g.Ho * g.Wo;
  const bool vec = (g.C & 3) == 0;

  // The pixels a thread stages keep for every K step: resolve them, and
  // their group's activation scale, once.
  const int ak = tid % BK;
  int a_b[A_LD], a_y[A_LD], a_x[A_LD];
  float a_sc[A_LD];
#pragma unroll
  for (int i = 0; i < A_LD; ++i) {
    const int m = m0 + tid / BK + i * (NT / BK);
    if (m < g.M) {
      const int b = m / hw, r = m - b * hw;
      const int oy = r / g.Wo;
      a_b[i] = b;
      a_y[i] = oy * STRIDE;
      a_x[i] = (r - oy * g.Wo) * STRIDE;
      a_sc[i] = act_scale(amax, b / g.act_group);
    } else {
      a_b[i] = -1; a_y[i] = 0; a_x[i] = 0; a_sc[i] = 1.0f;
    }
  }

  int a_reg[A_LD], b_reg[B_LD];
  auto load = [&](int k0) {
    {
      const int k = k0 + ak;
      const bool kv = k < kend;
      const int t = kv ? k / g.C4 : 0;
      const int c = 4 * (k - t * g.C4);
      int dy, dx, wtap;
      tap_geometry<MODE>(t, p, dy, dx, wtap);
#pragma unroll
      for (int i = 0; i < A_LD; ++i) {
        const int iy = a_y[i] + dy, ix = a_x[i] + dx;
        const bool v = kv && a_b[i] >= 0 && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
        int packed = 0;
        if (v) {
          const float* src = x + (((int64_t)a_b[i] * g.H + iy) * g.W + ix) * g.C + c;
          const float a = a_sc[i];
          if (vec) {
            const float4 f = __ldg(reinterpret_cast<const float4*>(src));
            packed = pack4(quant1(f.x, a), quant1(f.y, a), quant1(f.z, a), quant1(f.w, a));
          } else {
            const int left = g.C - c;  // 1..3 live channels in a ragged last pack
            const int q0 = quant1(__ldg(src), a);
            const int q1 = left > 1 ? quant1(__ldg(src + 1), a) : 0;
            const int q2 = left > 2 ? quant1(__ldg(src + 2), a) : 0;
            const int q3 = left > 3 ? quant1(__ldg(src + 3), a) : 0;
            packed = pack4(q0, q1, q2, q3);
          }
        }
        a_reg[i] = packed;
      }
    }
#pragma unroll
    for (int j = 0; j < B_LD; ++j) {
      const int e = tid + j * NT;
      const int kk = e / BN, nn = e - kk * BN;
      const int k = k0 + kk, n = n0 + nn;
      int v = 0;
      if (e < BK * BN && k < kend && n < g.O) {
        int row = k;
        if constexpr (MODE == kConvT) {
          const int t = k / g.C4;
          int dy, dx, wtap;
          tap_geometry<MODE>(t, p, dy, dx, wtap);
          row = wtap * g.C4 + (k - t * g.C4);
        }
        v = __ldg(wq + (int64_t)row * g.O + n);
      }
      b_reg[j] = v;
    }
  };

  // Thread (tx, ty) owns rows ty*TM .. ty*TM+TM-1 (contiguous: one vector
  // shared-memory read, broadcast across the warp) and columns
  // tx, tx + BN/TN, ... (strided: conflict-free reads, coalesced writes).
  constexpr int TX = BN / TN;
  const int tx = tid % TX, ty = tid / TX;
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  if (kbeg < kend) load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_LD; ++i) As[ak][tid / BK + i * (NT / BK)] = a_reg[i];
#pragma unroll
    for (int j = 0; j < B_LD; ++j) {
      const int e = tid + j * NT;
      if (e < BK * BN) Bs[e / BN][e % BN] = b_reg[j];
    }
    __syncthreads();
    if (k0 + BK < kend) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const int4 v = *reinterpret_cast<const int4*>(&As[kk][ty * TM + i]);
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= g.M) continue;
    const float a = act_scale(amax, (m / hw) / g.act_group);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n >= g.O) continue;
      if (splits == 1) {
        out[out_offset<MODE>(g, p, m, n)] = epilogue(acc[i][j], a, ks[n], scale[n], shift[n], relu);
      } else {
        ws[(((int64_t)s * g.phases + p) * g.M + m) * g.O + n] = acc[i][j];
      }
    }
  }
}

// Sums the K-split partials (exact in int32) and applies the epilogue.
template <int MODE>
__global__ void splitk_reduce(const int* __restrict__ ws, const float* __restrict__ ks,
                              const float* __restrict__ scale, const float* __restrict__ shift,
                              const float* __restrict__ amax, float* __restrict__ out,
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
    out[out_offset<MODE>(g, p, m, n)] = epilogue(acc, a, ks[n], scale[n], shift[n], relu);
  }
}

// Tile configurations, the same as fused_conv.cu's; the Python launcher
// picks one by (M, N).
//   0 wide:  BM=128 BN=128 TM=8 TN=8   (N > 64)
//   1 mid:   BM=128 BN=64  TM=8 TN=4   (32 < N <= 64)
//   2 narrow:BM=256 BN=16  TM=8 TN=2   (N <= 32)
//   3 thin:  BM=32  BN=128 TM=4 TN=4   (M <= 64)
template <int MODE, int BM, int BN, int TM, int TN>
cudaError_t launch_cfg(const float* x, const int* wq, const float* ks, const float* scale,
                       const float* shift, const float* amax, float* out, int* ws,
                       const Geo& g, int relu, int splits, int kchunk, cudaStream_t st) {
  constexpr int NT = (BM / TM) * (BN / TN);
  dim3 grid((g.M + BM - 1) / BM, (g.O + BN - 1) / BN, g.phases * splits);
  int8_igemm<MODE, BM, BN, TM, TN><<<grid, NT, 0, st>>>(x, wq, ks, scale, shift, amax, out,
                                                        ws, g, relu, splits, kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t total = (int64_t)g.phases * g.M * g.O;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  splitk_reduce<MODE><<<blocks, 256, 0, st>>>(ws, ks, scale, shift, amax, out, g, relu, splits);
  return cudaGetLastError();
}

Geo make_geo(int B, int H, int W, int C, int O, int act_group, int mode) {
  Geo g;
  g.B = B; g.H = H; g.W = W; g.C = C; g.O = O;
  g.C4 = (C + 3) / 4;
  g.act_group = act_group;
  int taps;
  if (mode == kConv3) { g.Ho = H; g.Wo = W; taps = 9; g.phases = 1; }
  else if (mode == kConv4) { g.Ho = H / 2; g.Wo = W / 2; taps = 16; g.phases = 1; }
  else { g.Ho = H; g.Wo = W; taps = 4; g.phases = 4; }
  g.K4 = taps * g.C4;
  g.M = B * g.Ho * g.Wo;
  return g;
}

template <int MODE>
int launch(int cfg, const void* x, const void* wq, const void* ks, const void* scale,
           const void* shift, const void* amax, void* out, void* ws, int B, int H, int W,
           int C, int O, int act_group, int relu, int splits, int kchunk, void* stream) {
  const Geo g = make_geo(B, H, W, C, O, act_group, MODE);
  const float* xf = static_cast<const float*>(x);
  const int* wi = static_cast<const int*>(wq);
  const float* kf = static_cast<const float*>(ks);
  const float* sf = static_cast<const float*>(scale);
  const float* tf = static_cast<const float*>(shift);
  const float* af = static_cast<const float*>(amax);
  float* of = static_cast<float*>(out);
  int* wsi = static_cast<int*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cfg) {
    case 0: return launch_cfg<MODE, 128, 128, 8, 8>(xf, wi, kf, sf, tf, af, of, wsi, g, relu, splits, kchunk, st);
    case 1: return launch_cfg<MODE, 128, 64, 8, 4>(xf, wi, kf, sf, tf, af, of, wsi, g, relu, splits, kchunk, st);
    case 2: return launch_cfg<MODE, 256, 16, 8, 2>(xf, wi, kf, sf, tf, af, of, wsi, g, relu, splits, kchunk, st);
    case 3: return launch_cfg<MODE, 32, 128, 4, 4>(xf, wi, kf, sf, tf, af, of, wsi, g, relu, splits, kchunk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Per-group absmax of x (svrs_act_absmax), group g = floats
// [g * per_group, min(numel, (g + 1) * per_group)).
//
// What bounds it: bytes. It reads x once and writes one float per group, so
// its bound is numel * 4 bytes over 3.35 TB/s (78 us for the 262 MB input of
// a 1000-draw decode layer). To stream at that rate each SM needs tens of KB
// of reads in flight: a thread here issues AMAX_UNROLL independent 16-byte
// loads a loop trip (4 KB a warp), and the grid (ops/fused_int8.absmax_plan)
// gives every group enough blocks that all of them together fill the SMs,
// each block with at least 32 KB to read. The body of a group is the 16-byte
// words that lie wholly inside it; the up to 3 floats before its first word
// (the head) and after its last (the tail) are read as scalars by block 0 of
// the group, so a group whose float count is not a multiple of 4, or a word
// that straddles two groups, stays exact. Each element is read once.
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

__global__ void __launch_bounds__(AMAX_THREADS)
act_absmax(const float* __restrict__ x, float* __restrict__ amax, int64_t per_group,
           int64_t numel) {
  const int64_t s = (int64_t)blockIdx.x * per_group;  // blockIdx.x: the group
  const int64_t e = min(numel, s + per_group);
  const int64_t a = min((s + 3) & ~(int64_t)3, e);    // start of its first whole word
  const int64_t z = max(e & ~(int64_t)3, a);          // end of its last whole word
  const int tid = threadIdx.x;
  float m = 0.0f;
  if (blockIdx.y == 0) {
    if (tid < a - s) m = fabsf(__ldg(x + s + tid));                    // head
    else if (tid >= 4 && tid - 4 < e - z) m = fabsf(__ldg(x + z + tid - 4));  // tail
  }
  const float4* const v = reinterpret_cast<const float4*>(x + a);
  const int64_t nv = (z - a) >> 2;
  const int64_t trip = (int64_t)gridDim.y * AMAX_THREADS * AMAX_UNROLL;
  for (int64_t i = (int64_t)blockIdx.y * AMAX_THREADS * AMAX_UNROLL + tid; i < nv; i += trip) {
    float4 r[AMAX_UNROLL];
#pragma unroll
    for (int u = 0; u < AMAX_UNROLL; ++u) {
      const int64_t j = i + u * AMAX_THREADS;
      r[u] = j < nv ? __ldg(v + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < AMAX_UNROLL; ++u)
      m = fmaxf(m, fmaxf(fmaxf(fabsf(r[u].x), fabsf(r[u].y)), fmaxf(fabsf(r[u].z), fabsf(r[u].w))));
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

}  // namespace

extern "C" {

// x must be 16-byte aligned and numel > 0; amax gets one float per group.
// Runs on CUDA device `device` (made current for the call, then restored),
// so the Python wrapper needs no device context.
int svrs_act_absmax(int device, const void* x, void* amax, long long per_group,
                    long long numel, int groups, int blocks_per_group, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(amax, 0, sizeof(float) * (size_t)groups, st);
  if (err == cudaSuccess) {
    act_absmax<<<dim3(groups, blocks_per_group), AMAX_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(amax), (int64_t)per_group,
        (int64_t)numel);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

int svrs_int8_conv3x3(int cfg, const void* x, const void* wq, const void* ks,
                      const void* scale, const void* shift, const void* amax, void* out,
                      void* ws, int B, int H, int W, int C, int O, int act_group, int relu,
                      int splits, int kchunk, void* stream) {
  return launch<kConv3>(cfg, x, wq, ks, scale, shift, amax, out, ws, B, H, W, C, O, act_group,
                        relu, splits, kchunk, stream);
}

int svrs_int8_conv4x4s2(int cfg, const void* x, const void* wq, const void* ks,
                        const void* scale, const void* shift, const void* amax, void* out,
                        void* ws, int B, int H, int W, int C, int O, int act_group, int relu,
                        int splits, int kchunk, void* stream) {
  return launch<kConv4>(cfg, x, wq, ks, scale, shift, amax, out, ws, B, H, W, C, O, act_group,
                        relu, splits, kchunk, stream);
}

int svrs_int8_convT4x4s2(int cfg, const void* x, const void* wq, const void* ks,
                         const void* scale, const void* shift, const void* amax, void* out,
                         void* ws, int B, int H, int W, int C, int O, int act_group, int relu,
                         int splits, int kchunk, void* stream) {
  return launch<kConvT>(cfg, x, wq, ks, scale, shift, amax, out, ws, B, H, W, C, O, act_group,
                        relu, splits, kchunk, stream);
}

}  // extern "C"
