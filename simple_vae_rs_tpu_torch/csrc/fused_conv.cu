// Fused conv + per-channel affine + optional ReLU kernels for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of the serving path
// (simple_vae_rs_tpu/ops/pallas_conv.py):
//   svrs_conv3x3        <- fused_conv3x3_bn_relu     (3x3, stride 1, SAME)
//   svrs_conv4x4s2      <- fused_conv4x4s2_bn_relu   (4x4, stride 2, pad 1)
//   svrs_convT4x4s2     <- fused_convT4x4s2_bn_relu  (transposed 4x4, stride 2,
//                                                      pad 1, input-dilated form)
// Each computes out = act(conv(x, W) * scale + shift) in float32, with x and
// out NHWC and W in HWIO layout (kh, kw, C, O), row-major.
//
// Design: an implicit GEMM. M = output pixels (per output phase for the
// transposed conv), N = O, K = live taps * C. A block owns a BM x BN output
// tile; each step stages a BK-deep slice of the gathered input (the im2col
// row, built on the fly with the kernel's own padded and strided input
// coordinates, masked at every edge) and of the weight rows in shared
// memory, and every thread accumulates a TM x TN micro-tile in f32
// registers. The next slice is fetched into registers while the current one
// is multiplied. The affine and the ReLU run in the epilogue, so the output
// makes one trip to device memory.
//
// What bounds it on this card: at the 64x64 decoder tail and the chunked
// 1000-draw decode the work is operations-bound (float32 FMA on the CUDA
// cores, no tensor cores yet); the micro-tiles give 16-64 FMAs per shared
// memory load. The 4x4-spatial prior heads (C=1696, O=848, K=15,264 at one
// or a few images) are bound by the 52 MB weight read: there the launcher is
// given a thin tile (BM=32) and a K split, so a few hundred blocks stream
// disjoint weight slices; a second pass sums the partials in a fixed order
// and applies the epilogue (deterministic, no atomics).
//
// The transposed conv computes each of the four output phases (u, v) from
// its four live taps only (the Pallas kernel's _T_TAPS table): output row
// 2i+u reads input rows i+u-1 and i+u against kernel rows u and u+2, and
// the same for columns. No dilation zeros are stored or multiplied.
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
  int Ho, Wo;         // GEMM grid per phase (output pixels of one phase)
  int M;              // B * Ho * Wo
  int K;              // live taps * C
  int phases;         // 1, or 4 for the transposed conv
};

constexpr int BK = 8;

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

template <int MODE>
__device__ __forceinline__ int64_t out_offset(const Geo& g, int p, int m, int n) {
  if constexpr (MODE != kConvT) return (int64_t)m * g.O + n;
  const int hw = g.Ho * g.Wo;
  const int b = m / hw, r = m - b * hw;
  const int i = r / g.Wo, j = r - i * g.Wo;
  const int oh = 2 * i + (p >> 1), ow = 2 * j + (p & 1);
  return (((int64_t)b * (2 * g.Ho) + oh) * (2 * g.Wo) + ow) * g.O + n;
}

template <int MODE, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv_igemm(const float* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ shift,
           float* __restrict__ out, float* __restrict__ ws, Geo g, int relu,
           int splits, int kchunk) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int A_LD = BM * BK / NT;
  constexpr int B_LD = (BK * BN + NT - 1) / NT;
  constexpr int STRIDE = MODE == kConv4 ? 2 : 1;
  static_assert(NT % BK == 0 && (BM * BK) % NT == 0, "tile shape");
  static_assert(TM % 4 == 0, "micro-tile rows are read as float4");

  // +4 pads the rows so the transposed stores below hit distinct banks.
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int p = blockIdx.z / splits;
  const int s = blockIdx.z - p * splits;
  const int kbeg = s * kchunk;
  const int kend = min(g.K, kbeg + kchunk);

  // The A (gathered input) elements a thread stages keep the same pixels
  // for every K step: resolve them once.
  const int ak = tid % BK;
  int a_b[A_LD], a_y[A_LD], a_x[A_LD];
#pragma unroll
  for (int i = 0; i < A_LD; ++i) {
    const int m = m0 + tid / BK + i * (NT / BK);
    if (m < g.M) {
      const int hw = g.Ho * g.Wo;
      const int b = m / hw, r = m - b * hw;
      const int oy = r / g.Wo;
      a_b[i] = b;
      a_y[i] = oy * STRIDE;
      a_x[i] = (r - oy * g.Wo) * STRIDE;
    } else {
      a_b[i] = -1; a_y[i] = 0; a_x[i] = 0;
    }
  }

  float a_reg[A_LD], b_reg[B_LD];
  auto load = [&](int k0) {
    {
      const int k = k0 + ak;
      const bool kv = k < kend;
      const int t = kv ? k / g.C : 0;
      const int c = k - t * g.C;
      int dy, dx, wtap;
      tap_geometry<MODE>(t, p, dy, dx, wtap);
#pragma unroll
      for (int i = 0; i < A_LD; ++i) {
        const int iy = a_y[i] + dy, ix = a_x[i] + dx;
        const bool v = kv && a_b[i] >= 0 && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
        a_reg[i] = v ? __ldg(x + (((int64_t)a_b[i] * g.H + iy) * g.W + ix) * g.C + c) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < B_LD; ++j) {
      const int e = tid + j * NT;
      const int kk = e / BN, nn = e - kk * BN;
      const int k = k0 + kk, n = n0 + nn;
      float v = 0.f;
      if (e < BK * BN && k < kend && n < g.O) {
        int row = k;
        if constexpr (MODE == kConvT) {
          const int t = k / g.C;
          int dy, dx, wtap;
          tap_geometry<MODE>(t, p, dy, dx, wtap);
          row = wtap * g.C + (k - t * g.C);
        }
        v = __ldg(w + (int64_t)row * g.O + n);
      }
      b_reg[j] = v;
    }
  };

  // Thread (tx, ty) owns rows ty*TM .. ty*TM+TM-1 (contiguous: one vector
  // shared-memory read, broadcast across the warp) and columns
  // tx, tx + BN/TN, ... (strided: conflict-free reads, coalesced writes).
  constexpr int TX = BN / TN;
  const int tx = tid % TX, ty = tid / TX;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

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
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&As[kk][ty * TM + i]);
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n >= g.O) continue;
      if (splits == 1) {
        float v = fmaf(acc[i][j], scale[n], shift[n]);
        if (relu) v = fmaxf(v, 0.f);
        out[out_offset<MODE>(g, p, m, n)] = v;
      } else {
        ws[(((int64_t)s * g.phases + p) * g.M + m) * g.O + n] = acc[i][j];
      }
    }
  }
}

// Sums the K-split partials in split order and applies the epilogue.
template <int MODE>
__global__ void splitk_reduce(const float* __restrict__ ws, const float* __restrict__ scale,
                              const float* __restrict__ shift, float* __restrict__ out,
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
    out[out_offset<MODE>(g, p, m, n)] = v;
  }
}

// Tile configurations; the Python launcher picks one by (M, N).
//   0 wide:  BM=128 BN=128 TM=8 TN=8   (N > 64)
//   1 mid:   BM=128 BN=64  TM=8 TN=4   (32 < N <= 64)
//   2 narrow:BM=256 BN=16  TM=8 TN=2   (N <= 32)
//   3 thin:  BM=32  BN=128 TM=4 TN=4   (M <= 64: the weight-bound prior heads)
template <int MODE, int BM, int BN, int TM, int TN>
cudaError_t launch_cfg(const float* x, const float* w, const float* scale,
                       const float* shift, float* out, float* ws, const Geo& g,
                       int relu, int splits, int kchunk, cudaStream_t st) {
  constexpr int NT = (BM / TM) * (BN / TN);
  dim3 grid((g.M + BM - 1) / BM, (g.O + BN - 1) / BN, g.phases * splits);
  conv_igemm<MODE, BM, BN, TM, TN><<<grid, NT, 0, st>>>(x, w, scale, shift, out, ws, g,
                                                        relu, splits, kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t total = (int64_t)g.phases * g.M * g.O;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  splitk_reduce<MODE><<<blocks, 256, 0, st>>>(ws, scale, shift, out, g, relu, splits);
  return cudaGetLastError();
}

template <int MODE>
int launch(int cfg, const void* x, const void* w, const void* scale, const void* shift,
           void* out, void* ws, Geo g, int relu, int splits, int kchunk, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(scale);
  const float* tf = static_cast<const float*>(shift);
  float* of = static_cast<float*>(out);
  float* wsf = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cfg) {
    case 0: return launch_cfg<MODE, 128, 128, 8, 8>(xf, wf, sf, tf, of, wsf, g, relu, splits, kchunk, st);
    case 1: return launch_cfg<MODE, 128, 64, 8, 4>(xf, wf, sf, tf, of, wsf, g, relu, splits, kchunk, st);
    case 2: return launch_cfg<MODE, 256, 16, 8, 2>(xf, wf, sf, tf, of, wsf, g, relu, splits, kchunk, st);
    case 3: return launch_cfg<MODE, 32, 128, 4, 4>(xf, wf, sf, tf, of, wsf, g, relu, splits, kchunk, st);
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
  return g;
}

}  // namespace

extern "C" {

int svrs_conv3x3(int cfg, const void* x, const void* w, const void* scale, const void* shift,
                 void* out, void* ws, int B, int H, int W, int C, int O, int relu,
                 int splits, int kchunk, void* stream) {
  return launch<kConv3>(cfg, x, w, scale, shift, out, ws, make_geo(B, H, W, C, O, kConv3),
                        relu, splits, kchunk, stream);
}

int svrs_conv4x4s2(int cfg, const void* x, const void* w, const void* scale, const void* shift,
                   void* out, void* ws, int B, int H, int W, int C, int O, int relu,
                   int splits, int kchunk, void* stream) {
  return launch<kConv4>(cfg, x, w, scale, shift, out, ws, make_geo(B, H, W, C, O, kConv4),
                        relu, splits, kchunk, stream);
}

int svrs_convT4x4s2(int cfg, const void* x, const void* w, const void* scale, const void* shift,
                    void* out, void* ws, int B, int H, int W, int C, int O, int relu,
                    int splits, int kchunk, void* stream) {
  return launch<kConvT>(cfg, x, w, scale, shift, out, ws, make_geo(B, H, W, C, O, kConvT),
                        relu, splits, kchunk, stream);
}

}  // extern "C"
