// Stochastic-round int8 weight quantizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _quant_kernel / _quantize_tpu
// (simple_vae_rs_tpu/ops/quantize.py): for a weight viewed as (M, O) float32
// with one scale per output channel o (the last axis),
//   amax[o]  = max over rows of |w[:, o]|
//   scale[o] = amax[o] > 0 ? amax[o] / 127 : 1          (a true division)
//   x = w / scale[o]                                     (a true division)
//   q = clip(floor(x) + (u < x - floor(x)), -127, 127)   as int8
// with u uniform in [0, 1). The TPU kernel draws u from the core's own
// generator, seeded per row block. Here u is counter-based: element i of a
// leaf hashes (seed, i) with two rounds of a 32-bit integer finalizer,
//   bits = mix32(mix32(i ^ k0) + k1),
//   mix32(x): x ^= x >> 16; x *= 0x7feb352d; x ^= x >> 15; x *= 0x846ca68b;
//             x ^= x >> 16,
// where (k0, k1) are the two key words the wrapper derives from the leaf's
// 64-bit seed. The top 23 bits become the mantissa of a float in [1, 2),
// minus 1 (the exponent trick of the TPU kernel). The wrapper's plain version
// computes the same hash in PyTorch integer arithmetic, so kernel and plain
// version agree byte for byte and the result does not depend on the launch
// geometry.
//
// What bounds it: bytes (each weight read for the scales and again for the
// rounding, 1 byte written per element; about 20 integer operations each),
// but at model load the work is small (the canonical W8A8 decoder: 18 leaves,
// 5.3M elements, 21 MB) and the cost was the host's: one wrapper call per
// leaf, each with its own scale computation in four or five torch ops, a
// device context and a launch. So one C call quantizes a whole quant tree
// (svrs_quantize_tree): the leaves go to the device in a table passed by
// value (a __grid_constant__ parameter, under the 4 KB parameter limit, read
// through the constant cache), and each pass is one launch over every leaf,
// a block finding its leaf by the table's first-block offsets:
//   1. col_absmax: a block takes 32 columns of AMAX_ROWS rows of one leaf
//      (256 threads: a warp reads 32 neighbouring floats of a row, eight
//      warps take every eighth row) and folds its column maxima into amax[o]
//      with one atomicMax on the bit pattern of |w| (non-negative floats
//      order like their bit patterns; a NaN, whose bits lie above +inf's,
//      wins, as torch's amax propagates it). The amax scratch is zeroed with
//      cudaMemsetAsync in the same call.
//   2. stochastic_round: a block takes QUANT_PER_BLOCK consecutive elements
//      of one leaf; each element computes its column's scale inline from
//      amax (true division, scale 1 for a zero or NaN maximum), the elements
//      of row 0 write it out, and the weights are read a second time, from
//      L2 for a tree of the decoder's size (50 MB).
// Per tree that is one memset and two launches (two per MAX_LEAVES leaves).
//
// Interface: plain C, loaded with ctypes. Launches on the given stream, does
// not synchronise, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 48;  // 64 bytes a leaf: the table stays under 4 KB
constexpr int THREADS = 256;
constexpr int AMAX_COLS = 32;                       // columns of a col_absmax block
constexpr int AMAX_LANES = THREADS / AMAX_COLS;     // rows read at once
constexpr int AMAX_ROWS = 256;                      // rows of a col_absmax block (32 KB)
constexpr int QUANT_PER_BLOCK = 8 * THREADS;        // elements of a stochastic_round block

// One leaf on the device: w (m, o) float32 in, q (m, o) int8 and scale (o,)
// float32 out, amax (o,) scratch; the first block of each pass.
struct Leaf {
  const float* w;
  int8_t* q;
  float* scale;
  unsigned* amax;
  unsigned m, o, numel;  // numel = m * o < 2^31
  unsigned k0, k1;
  unsigned amax_block0, quant_block0;
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int n;
};
static_assert(sizeof(Table) <= 4096, "kernel parameters are limited to 4 KB");

// The leaf of block b: the last whose first block is <= b (a leaf without
// blocks shares its first block with the next and is passed over).
__device__ __forceinline__ const Leaf& leaf_of(const Table& t, unsigned b, bool quant) {
  int l = 0;
  for (int j = 1; j < t.n; ++j)
    if ((quant ? t.leaf[j].quant_block0 : t.leaf[j].amax_block0) <= b) l = j;
  return t.leaf[l];
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(THREADS) col_absmax(const __grid_constant__ Table t) {
  const Leaf& L = leaf_of(t, blockIdx.x, false);
  const unsigned tiles = (L.o + AMAX_COLS - 1) / AMAX_COLS;
  const unsigned b = blockIdx.x - L.amax_block0;
  const unsigned split = b / tiles, tile = b - split * tiles;
  const unsigned lane = threadIdx.x % AMAX_COLS, row = threadIdx.x / AMAX_COLS;
  const unsigned col = tile * AMAX_COLS + lane;
  const unsigned r1 = min(L.m, (split + 1) * AMAX_ROWS);
  unsigned mx = 0;  // the bits of max |w|
  if (col < L.o) {
#pragma unroll 4
    for (unsigned r = split * AMAX_ROWS + row; r < r1; r += AMAX_LANES)
      mx = max(mx, __float_as_uint(fabsf(__ldg(L.w + (size_t)r * L.o + col))));
  }
  __shared__ unsigned part[AMAX_LANES][AMAX_COLS];
  part[row][lane] = mx;
  __syncthreads();
  if (row == 0 && col < L.o) {
#pragma unroll
    for (int i = 1; i < AMAX_LANES; ++i) mx = max(mx, part[i][lane]);
    atomicMax(L.amax + col, mx);
  }
}

__global__ void __launch_bounds__(THREADS) stochastic_round(const __grid_constant__ Table t) {
  const Leaf& L = leaf_of(t, blockIdx.x, true);
  const unsigned base = (blockIdx.x - L.quant_block0) * QUANT_PER_BLOCK + threadIdx.x;
#pragma unroll 2
  for (int k = 0; k < QUANT_PER_BLOCK / THREADS; ++k) {
    const unsigned i = base + k * THREADS;
    if (i >= L.numel) break;
    const unsigned o = i % L.o;
    const float amax = __uint_as_float(L.amax[o]);
    // channel_scales: a zero channel (and a NaN maximum: NaN > 0 is false) gets 1
    const float scale = amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
    if (i < L.o) L.scale[i] = scale;  // row 0 writes the scales
    const uint32_t bits = mix32(mix32(i ^ L.k0) + L.k1);
    const float u = __uint_as_float((bits >> 9) | 0x3f800000U) - 1.0f;
    const float x = __fdiv_rn(__ldg(L.w + i), scale);
    const float lo = floorf(x);
    float v = lo + (u < (x - lo) ? 1.0f : 0.0f);
    // a clamp that keeps a NaN, as torch.clamp does; the conversion then
    // gives 0 for it, as the plain version's cast to int8 does
    v = v < -127.0f ? -127.0f : (v > 127.0f ? 127.0f : v);
    L.q[i] = (int8_t)__float2int_rn(v);
  }
}

}  // namespace

extern "C" {

// One leaf as the wrapper passes it (ctypes Structure of the same layout).
struct SvrsQuantLeaf {
  const void* w;
  void* q;
  void* scale;
  long long numel;  // 0 < numel < 2^31
  int o;            // > 0, divides numel
  unsigned k0, k1;
};

// Quantizes n leaves in two launches per MAX_LEAVES of them, on `stream` of
// `device` (made current for the call). amax: scratch of the sum of the
// leaves' o, as unsigned words, zeroed here.
int svrs_quantize_tree(int device, const SvrsQuantLeaf* leaves, int n, void* amax,
                       void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* scratch = static_cast<unsigned*>(amax);
  long long total_o = 0;
  for (int i = 0; i < n; ++i) total_o += leaves[i].o;
  err = cudaMemsetAsync(scratch, 0, sizeof(unsigned) * (size_t)total_o, st);
  for (int first = 0; err == cudaSuccess && first < n; first += MAX_LEAVES) {
    Table t;
    t.n = n - first < MAX_LEAVES ? n - first : MAX_LEAVES;
    unsigned amax_blocks = 0, quant_blocks = 0;
    for (int j = 0; j < t.n; ++j) {
      const SvrsQuantLeaf& a = leaves[first + j];
      Leaf& L = t.leaf[j];
      L.w = static_cast<const float*>(a.w);
      L.q = static_cast<int8_t*>(a.q);
      L.scale = static_cast<float*>(a.scale);
      L.amax = scratch;
      scratch += a.o;
      L.numel = (unsigned)a.numel;
      L.o = (unsigned)a.o;
      L.m = L.numel / L.o;
      L.k0 = a.k0;
      L.k1 = a.k1;
      L.amax_block0 = amax_blocks;
      L.quant_block0 = quant_blocks;
      amax_blocks += ((L.m + AMAX_ROWS - 1) / AMAX_ROWS) * ((L.o + AMAX_COLS - 1) / AMAX_COLS);
      quant_blocks += (L.numel + QUANT_PER_BLOCK - 1) / QUANT_PER_BLOCK;
    }
    col_absmax<<<amax_blocks, THREADS, 0, st>>>(t);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    stochastic_round<<<quant_blocks, THREADS, 0, st>>>(t);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // extern "C"
