// The bf16 3x3 conv (#1), the bf16 4x4/s2 conv (#5) and the bf16 transposed
// conv (#6) for Hopper (sm_90a) on wgmma fed by TMA.
//
// Replaces, for bfloat16 operands, the Pallas TPU kernels
// (simple_vae_rs_tpu/ops/pallas_conv.py):
//   svrs_conv3x3_wg_bf16     <- fused_conv3x3_bn_relu     (:128; 3x3, stride 1, SAME)
//   svrs_conv4x4s2_wg_bf16   <- fused_conv4x4s2_bn_relu   (:682; 4x4, stride 2, pad 1)
//   svrs_convT4x4s2_wg_bf16  <- fused_convT4x4s2_bn_relu  (:792; transposed 4x4,
//                                stride 2, pad 1, input-dilated form, _T_TAPS)
// Each computes out = act(conv(x, W) * scale + shift) with x and out NHWC
// bfloat16, W HWIO (kh, kw, C, O) bfloat16, scale and shift float32: the
// products in the bf16 tensor cores with float32 accumulation, the affine
// and the ReLU in float32, one round to nearest even to bf16. The same
// kernels compute the input gradients (the flip-swapped weight, scale 1,
// shift 0): the 3x3 conv's on #1, the 4x4/s2 conv's on #6 and the
// transposed conv's on #5. ops/fused_conv routes every bf16 launch of #1,
// #5 and #6 that qualifies here (wg_eligible); everything else stays on
// conv_tc_bf16 in fused_conv.cu.
//
// What bounds it: the wide shapes of the canonical model (C and O of 128 to
// 1696 at 1000 draws or a 512-patch batch) are operations-bound, at 989
// TFLOP/s in bf16; conv_tc_bf16 reaches 13-19% of that on mma.sync, where
// every warp issues its own fragment loads and MMAs, every thread computes
// the im2col addresses and masks of its cp.async copies, and a block takes a
// barrier each 64-deep step. Only wgmma reaches the tensor cores' rate.
//
// Design: an implicit GEMM, M = output pixels (per output phase for the
// transposed conv), N = O, K = live taps x C in k-groups of KC channels of
// one tap (tap-major): KC = 64, or 16 where C <= 16, so that the 64x64
// layers' 16-channel inputs do not fill three quarters of each k-group with
// zeros. A persistent block per SM walks its tiles (BM = 128 pixels x
// BN channels) in the order phase, pixel tile, channel tile. One producer
// thread issues TMA loads into a ring of STAGES slots with a full and an
// empty mbarrier each; two consumer warpgroups (64 rows each) run
// wgmma.mma_async m64nBNk16 (bf16 -> f32) on the slot that has landed and
// release it; setmaxnreg moves registers from the producer warpgroup to
// the consumers. The producer runs ahead into the next tile while the
// consumers store the last one.
//
// The A operand is a TMA box, not a per-thread gather: a tile's pixels are
// a 4-D box (KC channels, wb pixels of a row, th rows, nb images) of the
// NHWC input with wb * th * nb <= BM (the whole row when W <= 128: 64x64 ->
// two rows, 8x8 -> two images, 4x4 -> eight). Tap (dy, dx) loads that box
// at (c0, x0 + dx, y0 + dy, n0); TMA's per-dimension out-of-bounds zero fill
// is the SAME padding at each image's and each row's edge, zeroes channels
// >= C where C % 64 != 0 (C = 424, 848, 1696) and images past the batch.
// The transposed conv's output phase (u, v), a tile coordinate beside the pixels,
// takes the same box at its four live taps (dy = ta + u - 1, dx = tb + v - 1,
// fused_conv.cu's tap_geometry), weight tap (2 ta + u) * 4 + 2 tb + v, and
// stores pixel (2 i + u, 2 j + v).
//
// The 4x4/s2 conv's tile is in output pixels too, and tap (ky, kx) reads
// input pixel (2 i + ky - 1, 2 j + kx - 1): a stride-2 gather in H and W. Its
// A tensor map traverses the input with element strides {1, 2, 2, 1} in a
// box of (KC, 2 wb, 2 th, nb), so one load lands KC x wb x th x nb elements,
// the same box in shared memory as the other two modes, and tap (ky, kx)
// loads it at (c0, 2 x0 + kx - 1, 2 y0 + ky - 1, n0). That keeps TMA's
// per-dimension zero fill: the pad of 1 (a start of -1 at the first row or
// column, W at the last) and channels >= C where C % 64 != 0. The other
// design, JAX #5's phase-plane view of x as (2 C, W / 2, 2, H / 2, B), would
// read the other phase's channels past C inside a k-group and cancel them
// only through the weight box's zero rows (a NaN there would poison the
// sum), so it needs KC | C or a channel tail of its own. A box dimension is at
// most 256 elements, so 2 wb <= 256 (wb <= 128, as for the other modes); the
// bytes one load lands, which expect_tx counts, are the strided count
// KC wb th nb 2. H and W must be even, as JAX #5 requires.
//
// In every mode the box lands in shared memory as rows of one pixel's KC
// channels (128 or 32 bytes) under the swizzle of that width: wgmma reads
// it K-major (leading offset unused, stride offset 8 rows between 8-row
// groups, +32 bytes per 16-deep step). The B operand is the HWIO weight
// viewed as (taps, C, O), a box of KC channels x min(BN, 64) outputs per
// load (two loads for BN = 128): O is contiguous, so wgmma reads it MN-major
// ("transposed" B, which bf16 allows) under the 128- or 32-byte swizzle of
// its row width (BN = 64 or 128, or 16; leading offset = the next 64
// outputs, stride offset = the next 8 k rows, +16 rows per 16-deep step).
// Every expect_tx counts the whole boxes, zero fill included.
//
// The tensor core's float32 accumulate truncates (ROADMAP C; the float32
// kernels' pitfall), so each k-group's KC / 16 wgmmas go into a zeroed
// register partial and, after wgmma.wait_group, the partial is added to the
// running sum with a rounded add, as conv_tc_bf16 does per 64-deep step.
// While one warpgroup adds, the other one's wgmmas keep the tensor cores
// busy. The partial and the sum take BN registers a thread, so BN <= 128.
//
// Interface: plain C, loaded with ctypes. Each entry point encodes the two
// tensor maps on the host (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint, no -lcuda), launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for a plan it has no instance for, 10000 +
// the CUresult of a tensor map that fails to encode, or 20000 when
// cuTensorMapEncodeTiled cannot be found. The plan (box, BN, KC, stages,
// grid) comes from ops/fused_conv.plan_wg.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef __nv_bfloat16 bf16;

enum Mode { kConv3 = 0, kConv4 = 1, kConvT = 2 };  // fused_conv.cu's numbering

// Per mode: live taps a tile walks, taps of the HWIO weight, output phases,
// and input pixels per output pixel (the A box's element stride in H and W)
__host__ __device__ constexpr int mode_taps(int m) {
  return m == kConv3 ? 9 : m == kConv4 ? 16 : 4;
}
__host__ __device__ constexpr int weight_taps(int m) { return m == kConv3 ? 9 : 16; }
__host__ __device__ constexpr int mode_phases(int m) { return m == kConvT ? 4 : 1; }
__host__ __device__ constexpr int mode_stride(int m) { return m == kConv4 ? 2 : 1; }

constexpr int BM = 128;          // pixels of a tile: two consumer warpgroups of 64 rows
constexpr int NTHREADS = 384;    // warps 0-7 consume, warps 8-11 hold the producer thread
constexpr int CONSUMER_WARPS = 8;

struct WgGeo {
  int B, H, W, C, O;      // input batch/height/width/channels, output channels
  int oh, ow;             // the tiles' pixel grid: the output's (of one phase for kConvT)
  int wb, th, nb;         // the A box: pixels of a row, rows, images
  int xs, ys;             // row segments per row, row groups per image
  int mtiles, ntiles;     // pixel tiles per phase, channel tiles
  int tiles;              // phases * mtiles * ntiles
  int chunks;             // k-groups per tap: ceil(C / KC)
  int relu;
  int a_box_bytes;        // KC * wb * th * nb * 2: what one A load lands
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// seconds is a fault (an expect_tx above what lands, a lost arrival): trap,
// so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (int tries = 0;; ++tries) {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// ------------------------------------------------------------ TMA loads
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// ------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (all >> 4) and the swizzle (1: 128-byte rows, 3: 32-byte rows).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers at this point of the instruction stream: the compiler sees
// a wgmma's results as written when it is issued, so without this it could
// read them before wgmma.wait_group, or write them after the issue.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A * B on m64nNk16: A K-major and B MN-major ("transposed", the
// last immediate) from shared memory, bf16 in, float32 out; acc = 0 ignores
// d's old values. Fragment of d (PTX wgmma .m64nNk16 .f32; warp q of the
// warpgroup, lane l): d[4 j + 2 h + e] is row 16 q + l / 4 + 8 h, column
// 8 j + 2 (l % 4) + e.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], uint64_t da, uint64_t db,
                                                int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t da, uint64_t db,
                                                int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da, uint64_t db,
                                                int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db,
                                                int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void setmaxnreg_dec40() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}

__device__ __forceinline__ void setmaxnreg_inc232() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// ------------------------------------------------------------ geometry
// Input offsets (dy, dx) of live tap t in output phase p, and its weight tap
// (the HWIO weight's tap index): fused_conv.cu's tap_geometry.
template <int MODE>
__device__ __forceinline__ void wg_tap(int t, int p, int& dy, int& dx, int& wtap) {
  if constexpr (MODE == kConv3) {
    const int ky = t / 3, kx = t - 3 * (t / 3);
    dy = ky - 1; dx = kx - 1; wtap = t;
  } else if constexpr (MODE == kConv4) {
    dy = (t >> 2) - 1; dx = (t & 3) - 1; wtap = t;  // from (2 i, 2 j)
  } else {
    const int ta = t >> 1, tb = t & 1, u = p >> 1, v = p & 1;
    dy = ta + u - 1; dx = tb + v - 1;
    wtap = (2 * ta + u) * 4 + (2 * tb + v);
  }
}

struct Tile {
  int p;             // output phase (0 for the 3x3 conv)
  int x0, y0, n0;    // the box's first pixel of a row, row, image
  int o0;            // first output channel
};

// Tile t in the order phase, pixel tile (image group, row group, row
// segment), channel tile.
template <int BN>
__device__ __forceinline__ Tile tile_of(const WgGeo& g, int t) {
  Tile r;
  const int nt = t % g.ntiles;
  int q = t / g.ntiles;
  const int mt = q % g.mtiles;
  r.p = q / g.mtiles;
  const int seg = mt % g.xs;
  q = mt / g.xs;
  r.x0 = seg * g.wb;
  r.y0 = (q % g.ys) * g.th;
  r.n0 = (q / g.ys) * g.nb;
  r.o0 = nt * BN;
  return r;
}

// A k-group is KC channels of one tap: 64 (one 128-byte swizzled row a
// pixel), or 16 where C <= 16 (a 32-byte row), so that a narrow input does
// not fill three quarters of every k-group with zeros. Rows of A and B are
// 128 or 32 bytes, each under the swizzle of its width (a descriptor's code
// 1 or 3).
__host__ __device__ constexpr uint32_t swizzle_code(int row_bytes) {
  return row_bytes == 128 ? 1u : 3u;
}
template <int KC>
__host__ __device__ constexpr int a_bytes() { return BM * KC * 2; }  // a slot of A
// B's row width in bytes (a box of min(BN, 64) outputs: BN is 16, 64 or
// 128) and a slot of B (KC k rows of all of its boxes).
template <int BN>
__host__ __device__ constexpr int b_row_bytes() { return (BN < 64 ? BN : 64) * 2; }
template <int BN, int KC>
__host__ __device__ constexpr int b_bytes() { return KC * BN * 2; }

template <int BN, int KC, int STAGES>
constexpr int wg_smem_bytes() {
  return 1024 + STAGES * (a_bytes<KC>() + b_bytes<BN, KC>()) + 2 * STAGES * 8;
}

template <int MODE, int BN, int KC, int STAGES>
__global__ void __launch_bounds__(NTHREADS, 1)
conv_wg_bf16(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
             const float* __restrict__ scale, const float* __restrict__ shift,
             bf16* __restrict__ out, const WgGeo g) {
  constexpr int TAPS = mode_taps(MODE);
  constexpr int S = mode_stride(MODE);
  constexpr int A_BYTES = a_bytes<KC>();
  constexpr int AR = KC * 2;                  // A's row bytes: one pixel's KC channels
  constexpr int RB = b_row_bytes<BN>();
  constexpr int B_BYTES = b_bytes<BN, KC>();
  constexpr int B_BOX = KC * RB;              // bytes of one B box (KC k rows)
  constexpr int B_BOXES = BN < 64 ? 1 : BN / 64;
  constexpr int NR = BN / 2;                  // accumulator registers a thread

  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment (the 128-byte pattern's period)
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t a_base = (raw + 1023u) & ~1023u;
  const uint32_t b_base = a_base + STAGES * A_BYTES;
  const uint32_t full = b_base + STAGES * B_BYTES;  // STAGES mbarriers, then STAGES more
  const uint32_t empty = full + 8 * STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                 // the producer's expect_tx
      mbar_init(empty + 8 * s, CONSUMER_WARPS);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int kgroups = TAPS * g.chunks;
  if (threadIdx.x >= CONSUMER_WARPS * 32) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec40();
    if (threadIdx.x != CONSUMER_WARPS * 32) return;
    const uint32_t tx = (uint32_t)(g.a_box_bytes + B_BYTES);
    uint32_t it = 0;  // k-groups issued by this block, over all its tiles
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      const Tile tl = tile_of<BN>(g, t);
      for (int tap = 0; tap < TAPS; ++tap) {
        int dy, dx, wtap;
        wg_tap<MODE>(tap, tl.p, dy, dx, wtap);
        for (int ch = 0; ch < g.chunks; ++ch, ++it) {
          const uint32_t s = it % STAGES, ph = (it / STAGES) & 1;
          mbar_wait(empty + 8 * s, ph ^ 1);  // the consumers released the slot
          mbar_expect_tx(full + 8 * s, tx);
          tma_load_4d(a_base + s * A_BYTES, &tm_x, full + 8 * s, ch * KC, S * tl.x0 + dx,
                      S * tl.y0 + dy, tl.n0);
#pragma unroll
          for (int j = 0; j < B_BOXES; ++j)
            tma_load_3d(b_base + s * B_BYTES + j * B_BOX, &tm_w, full + 8 * s,
                        tl.o0 + 64 * j, ch * KC, wtap);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  setmaxnreg_inc232();
  const int wg = threadIdx.x >> 7;          // 0 or 1: rows 64 wg .. 64 wg + 63 of the tile
  const int wq = (threadIdx.x >> 5) & 3;    // warp of the warpgroup
  const int lane = threadIdx.x & 31;
  float acc[NR], part[NR];
  uint32_t it = 0;
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const Tile tl = tile_of<BN>(g, t);
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] = 0.f;
    for (int kg = 0; kg < kgroups; ++kg, ++it) {
      const uint32_t s = it % STAGES, ph = (it / STAGES) & 1;
      mbar_wait(full + 8 * s, ph);
      // A: K-major, AR-byte rows, 8-row groups 8 AR apart, +32 bytes per
      // 16-deep step; B: MN-major, RB-byte rows, the next 64 outputs one box
      // (B_BOX bytes) on, 8-row groups 8 RB apart, +16 rows per step
      const uint64_t da = smem_desc(a_base + s * A_BYTES + wg * (64 * AR), 16, 8 * AR,
                                    swizzle_code(AR));
      const uint64_t db = smem_desc(b_base + s * B_BYTES, B_BOX, 8 * RB, swizzle_code(RB));
      fence_operands(part);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KC / 16; ++k)
        wgmma_bf16<BN>(part, da + (uint64_t)((32 * k) >> 4), db + (uint64_t)((16 * RB * k) >> 4),
                       k);
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(part);
      if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done reading the slot
      // the k-group's sum, formed in the tensor core, joins the running sum
      // with a rounded add (the tensor core's accumulate truncates)
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[i] += part[i];
    }

    // epilogue: row r of the tile is pixel (x0 + r % wb, y0 + r / wb % th,
    // n0 + r / (wb th)) of the box; rows past the box, the row, the image or
    // the batch are not stored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * wq + (lane >> 2) + 8 * h;
      const int xi = r % g.wb, q = r / g.wb;
      const int yi = q % g.th, ni = q / g.th;
      const int x = tl.x0 + xi, y = tl.y0 + yi, n = tl.n0 + ni;
      if (ni >= g.nb || x >= g.ow || y >= g.oh || n >= g.B) continue;
      const int64_t pix = MODE == kConvT
          ? ((int64_t)n * 2 * g.oh + 2 * y + (tl.p >> 1)) * (2 * g.ow) + 2 * x + (tl.p & 1)
          : ((int64_t)n * g.oh + y) * g.ow + x;
      bf16* const row = out + pix * g.O;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = tl.o0 + 8 * j + 2 * (lane & 3);
        if (col >= g.O) continue;  // O % 8 == 0, so col + 1 < O as well
        float v0 = fmaf(acc[4 * j + 2 * h], scale[col], shift[col]);
        float v1 = fmaf(acc[4 * j + 2 * h + 1], scale[col + 1], shift[col + 1]);
        if (g.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ------------------------------------------------------------ host side
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p) : nullptr;
  }();
  return fn;
}

CUtensorMapSwizzle swizzle_of(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
}

constexpr int kNoEncoder = 20000;
constexpr int kEncodeFailed = 10000;

// The input as a 4-D tensor (C, W, H, B), innermost first, in boxes of
// (KC, S wb, S th, nb) traversed with element strides (1, S, S, 1), so that
// a box lands (KC, wb, th, nb) elements, under the swizzle of a KC-channel
// row; out-of-bounds elements read 0.
template <int KC, int S>
int encode_x(CUtensorMap* map, const void* x, const WgGeo& g) {
  const auto enc = encode_fn();
  if (!enc) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)g.C, (cuuint64_t)g.W, (cuuint64_t)g.H, (cuuint64_t)g.B};
  const cuuint64_t strides[3] = {(cuuint64_t)g.C * 2, (cuuint64_t)g.W * g.C * 2,
                                 (cuuint64_t)g.H * g.W * g.C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)KC, (cuuint32_t)(S * g.wb), (cuuint32_t)(S * g.th),
                             (cuuint32_t)g.nb};
  const cuuint32_t step[4] = {1, (cuuint32_t)S, (cuuint32_t)S, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                         strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(KC * 2),
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

// The weight as a 3-D tensor (O, C, taps), in boxes of (min(BN, 64), KC, 1)
// under the swizzle of that row width.
template <int BN, int KC>
int encode_w(CUtensorMap* map, const void* w, const WgGeo& g, int taps) {
  const auto enc = encode_fn();
  if (!enc) return kNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)g.O, (cuuint64_t)g.C, (cuuint64_t)taps};
  const cuuint64_t strides[2] = {(cuuint64_t)g.O * 2, (cuuint64_t)g.C * g.O * 2};
  const cuuint32_t box[3] = {(cuuint32_t)(b_row_bytes<BN>() / 2), (cuuint32_t)KC, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         swizzle_of(b_row_bytes<BN>()),
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <int MODE, int BN, int KC, int STAGES>
int launch_wg(const void* x, const void* w, const float* scale, const float* shift, bf16* out,
              WgGeo g, int grid, cudaStream_t st) {
  constexpr int SMEM = wg_smem_bytes<BN, KC, STAGES>();
  static_assert(SMEM <= 232448, "shared memory of one block");
  const auto kernel = conv_wg_bf16<MODE, BN, KC, STAGES>;
  // the attribute holds per device: set on this instance's first launch there
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
  g.chunks = (g.C + KC - 1) / KC;
  g.a_box_bytes = KC * g.wb * g.th * g.nb * 2;
  CUtensorMap tm_x, tm_w;
  int rc = encode_x<KC, mode_stride(MODE)>(&tm_x, x, g);
  if (rc) return rc;
  rc = encode_w<BN, KC>(&tm_w, w, g, weight_taps(MODE));
  if (rc) return rc;
  kernel<<<grid, NTHREADS, SMEM, st>>>(tm_x, tm_w, scale, shift, out, g);
  return cudaGetLastError();
}

// The instances: (BN, KC, stages) of ops/fused_conv.WG_STAGES, the ring as
// deep as 227 KB of shared memory allows with 64-channel k-groups, 8 slots
// with 16-channel ones; one block per SM.
template <int MODE>
int launch(const void* x, const void* w, const void* scale, const void* shift, void* out,
           int B, int H, int W, int C, int O, int relu, int wb, int th, int nb, int bn, int kc,
           int stages, int grid, void* stream) {
  constexpr int S = mode_stride(MODE);
  if (B < 1 || H < S || W < S || H % S || W % S || C < 8 || O < 8 || C % 8 || O % 8 ||
      wb < 1 || th < 1 || nb < 1 || wb > 128 || wb * th * nb > BM || th > H / S || nb > B ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  WgGeo g;
  g.B = B; g.H = H; g.W = W; g.C = C; g.O = O;
  g.oh = H / S; g.ow = W / S;
  g.wb = wb; g.th = th; g.nb = nb;
  g.xs = (g.ow + wb - 1) / wb;
  g.ys = (g.oh + th - 1) / th;
  g.mtiles = g.xs * g.ys * ((B + nb - 1) / nb);
  g.ntiles = (O + bn - 1) / bn;
  g.tiles = mode_phases(MODE) * g.mtiles * g.ntiles;
  g.relu = relu;
  const float* sf = static_cast<const float*>(scale);
  const float* tf = static_cast<const float*>(shift);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kc == 64) {
    if (bn == 128 && stages == 6) return launch_wg<MODE, 128, 64, 6>(x, w, sf, tf, o, g, grid, st);
    if (bn == 64 && stages == 8) return launch_wg<MODE, 64, 64, 8>(x, w, sf, tf, o, g, grid, st);
    if (bn == 16 && stages == 8) return launch_wg<MODE, 16, 64, 8>(x, w, sf, tf, o, g, grid, st);
  } else if (kc == 16 && stages == 8) {
    if (bn == 128) return launch_wg<MODE, 128, 16, 8>(x, w, sf, tf, o, g, grid, st);
    if (bn == 64) return launch_wg<MODE, 64, 16, 8>(x, w, sf, tf, o, g, grid, st);
    if (bn == 16) return launch_wg<MODE, 16, 16, 8>(x, w, sf, tf, o, g, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int svrs_conv3x3_wg_bf16(const void* x, const void* w, const void* scale, const void* shift,
                         void* out, int B, int H, int W, int C, int O, int relu, int wb, int th,
                         int nb, int bn, int kc, int stages, int grid, void* stream) {
  return launch<kConv3>(x, w, scale, shift, out, B, H, W, C, O, relu, wb, th, nb, bn, kc, stages,
                        grid, stream);
}

int svrs_conv4x4s2_wg_bf16(const void* x, const void* w, const void* scale, const void* shift,
                           void* out, int B, int H, int W, int C, int O, int relu, int wb, int th,
                           int nb, int bn, int kc, int stages, int grid, void* stream) {
  return launch<kConv4>(x, w, scale, shift, out, B, H, W, C, O, relu, wb, th, nb, bn, kc, stages,
                        grid, stream);
}

int svrs_convT4x4s2_wg_bf16(const void* x, const void* w, const void* scale, const void* shift,
                            void* out, int B, int H, int W, int C, int O, int relu, int wb,
                            int th, int nb, int bn, int kc, int stages, int grid, void* stream) {
  return launch<kConvT>(x, w, scale, shift, out, B, H, W, C, O, relu, wb, th, nb, bn, kc, stages,
                        grid, stream);
}

}  // extern "C"
