// ELBO row reductions for Hopper (sm_90a): (B, D) float32 rows -> (B,) sums.
//
// Replaces the Pallas TPU kernel simple_vae_rs_tpu/ops/pallas_elbo.py
// (_rows_call with _sq_kernel, _kl_std_kernel and _kl_gen_kernel):
//   mode 0  sq_rows      sum_d (a - b)^2                              2 inputs
//   mode 1  kl_std_rows  sum_d mu^2 + e^lv - 1 - lv                   2 inputs
//   mode 2  kl_gen_rows  sum_d (lv3 - lv2 - 1) + e^(lv2 - lv3)
//                              + (mu2 - mu3)^2 e^(-lv3)               4 inputs
//
// What bounds it on this card: bytes. Each element is read once and costs a
// handful of float operations (one or two expf), far below the ~20
// operations per byte at which the H100's float32 units would become the
// limit. So the design streams the inputs at full width and keeps nothing
// else in device memory: no (a - b) or exp temporaries, one float per row
// written.
//
// Design: block (row, part) reduces columns [part*chunk, part*chunk + chunk)
// of one row. Each thread walks its columns with a stride of the block's
// width, with 16-byte (float4) loads when the row length and the pointers
// allow, and keeps its own float partial; the block then sums the 256
// partials in a fixed tree (warp shuffles, then the 8 warp sums). When the
// batch alone gives enough blocks (the training batch of 512 rows) a row is
// one part and the block writes the row sum. When it does not (small
// batches), the launcher splits the columns into parts, each block writes
// its partial into a workspace, and a second pass sums each row's partials
// in part order. The result is the same from run to run: no atomics. The
// ragged edge of a row is masked; nothing is padded.
//
// Interface: plain C, loaded with ctypes. The function launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int MODE>
__device__ __forceinline__ float term(float a, float b, float c, float d) {
  if constexpr (MODE == 0) {
    const float t = a - b;
    return t * t;
  } else if constexpr (MODE == 1) {
    return a * a + expf(b) - 1.0f - b;
  } else {
    // a = mu2, b = lv2, c = mu3, d = lv3
    const float dm = a - c;
    return (d - b - 1.0f) + expf(b - d) + dm * dm * expf(-d);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads)
rows_partial(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ c, const float* __restrict__ d,
             float* __restrict__ dst, int D, int chunk, int parts) {
  const int row = blockIdx.x;
  const int part = blockIdx.y;
  const int64_t base = (int64_t)row * D;
  const int lo = part * chunk;
  const int hi = min(D, lo + chunk);
  const int tid = threadIdx.x;
  float acc = 0.f;
  if constexpr (VEC) {
    // lo, D and every pointer are multiples of 4 floats (checked by the launcher)
#pragma unroll 4
    for (int i = lo + 4 * tid; i < hi; i += 4 * kThreads) {
      const float4 va = __ldg(reinterpret_cast<const float4*>(a + base + i));
      const float4 vb = __ldg(reinterpret_cast<const float4*>(b + base + i));
      float4 vc = make_float4(0.f, 0.f, 0.f, 0.f), vd = vc;
      if constexpr (MODE == 2) {
        vc = __ldg(reinterpret_cast<const float4*>(c + base + i));
        vd = __ldg(reinterpret_cast<const float4*>(d + base + i));
      }
      acc += term<MODE>(va.x, vb.x, vc.x, vd.x);
      acc += term<MODE>(va.y, vb.y, vc.y, vd.y);
      acc += term<MODE>(va.z, vb.z, vc.z, vd.z);
      acc += term<MODE>(va.w, vb.w, vc.w, vd.w);
    }
  } else {
#pragma unroll 4
    for (int i = lo + tid; i < hi; i += kThreads) {
      const float vc = MODE == 2 ? __ldg(c + base + i) : 0.f;
      const float vd = MODE == 2 ? __ldg(d + base + i) : 0.f;
      acc += term<MODE>(__ldg(a + base + i), __ldg(b + base + i), vc, vd);
    }
  }

  __shared__ float warp_part[kThreads / 32];
  acc = warp_sum(acc);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? warp_part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) dst[(int64_t)row * parts + part] = v;
  }
}

// Sums each row's partials in part order.
__global__ void rows_finish(const float* __restrict__ ws, float* __restrict__ out, int B,
                            int parts) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  float acc = 0.f;
  for (int p = 0; p < parts; ++p) acc += ws[(int64_t)row * parts + p];
  out[row] = acc;
}

template <int MODE>
cudaError_t launch(const float* a, const float* b, const float* c, const float* d,
                   float* out, float* ws, int B, int D, int chunk, int parts, int vec,
                   cudaStream_t st) {
  const dim3 grid(B, parts);
  float* dst = parts > 1 ? ws : out;
  if (vec) {
    rows_partial<MODE, true><<<grid, kThreads, 0, st>>>(a, b, c, d, dst, D, chunk, parts);
  } else {
    rows_partial<MODE, false><<<grid, kThreads, 0, st>>>(a, b, c, d, dst, D, chunk, parts);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return err;
  rows_finish<<<(B + 255) / 256, 256, 0, st>>>(ws, out, B, parts);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 0 sq_rows, 1 kl_std_rows, 2 kl_gen_rows (c and d are read by mode 2
// only). ws holds B * parts floats when parts > 1 and may be null otherwise.
int svrs_elbo_rows(int mode, const void* a, const void* b, const void* c, const void* d,
                   void* out, void* ws, int B, int D, int chunk, int parts, int vec,
                   void* stream) {
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  const float* df = static_cast<const float*>(d);
  float* of = static_cast<float*>(out);
  float* wf = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<0>(af, bf, cf, df, of, wf, B, D, chunk, parts, vec, st);
    case 1: return launch<1>(af, bf, cf, df, of, wf, B, D, chunk, parts, vec, st);
    case 2: return launch<2>(af, bf, cf, df, of, wf, B, D, chunk, parts, vec, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
