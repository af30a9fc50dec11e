// Stochastic-round int8 weight quantizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _quant_kernel / _quantize_tpu
// (simple_vae_rs_tpu/ops/quantize.py): for a weight viewed as (M, O) float32
// with one scale per output channel o (the last axis),
//   x = w / scale[o]                      (a true division)
//   q = clip(floor(x) + (u < x - floor(x)), -127, 127)   as int8
// with u uniform in [0, 1). The TPU kernel draws u from the core's own
// generator, seeded per row block. Here u is counter-based: element i hashes
// (seed, i) with two rounds of a 32-bit integer finalizer,
//   bits = mix32(mix32(i ^ k0) + k1),
//   mix32(x): x ^= x >> 16; x *= 0x7feb352d; x ^= x >> 15; x *= 0x846ca68b;
//             x ^= x >> 16,
// where (k0, k1) are the two key words the wrapper derives from the 64-bit
// seed. The top 23 bits become the mantissa of a float in [1, 2), minus 1
// (the exponent trick of the TPU kernel). The wrapper's plain version
// computes the same hash in PyTorch integer arithmetic, so kernel and plain
// version agree byte for byte and the result does not depend on the launch
// geometry.
//
// What bounds it: bytes (4 read, 1 written per element; about 20 integer
// operations each). It runs once per conv at model load, on at most 1.6M
// elements, so a grid-stride loop with one element per thread step is
// enough: neighbouring threads read neighbouring floats and write
// neighbouring bytes.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream, does
// not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

__global__ void quantize_stochastic(const float* __restrict__ w,
                                    const float* __restrict__ scale,
                                    int8_t* __restrict__ q, int64_t numel, int o,
                                    uint32_t k0, uint32_t k1) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < numel;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint32_t bits = mix32(mix32((uint32_t)i ^ k0) + k1);
    const float u = __uint_as_float((bits >> 9) | 0x3f800000U) - 1.0f;
    const float x = __fdiv_rn(w[i], scale[i % o]);
    const float lo = floorf(x);
    float v = lo + (u < (x - lo) ? 1.0f : 0.0f);
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    q[i] = (int8_t)__float2int_rn(v);
  }
}

}  // namespace

extern "C" int svrs_quantize_stochastic(const void* w, const void* scale, void* q,
                                        long long numel, int o, unsigned k0, unsigned k1,
                                        void* stream) {
  const int threads = 256;
  long long blocks = (numel + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  quantize_stochastic<<<(int)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(scale),
      static_cast<int8_t*>(q), (int64_t)numel, o, k0, k1);
  return (int)cudaGetLastError();
}
