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
// Design. A block owns one TH x TW output tile of one image and carries it
// through every layer; the intermediates live in two shared-memory buffers
// that the layers read and write in turn, and never reach device memory.
// Stage s (the input of layer s) is stored on the rectangle S_s = C_{s+1}
// grown by one pixel per side, where C_s is the part of S_s that lies inside
// the image and C_n is the tile itself: an n-layer chain reads an n-pixel
// halo, clipped to the image plus its one-pixel zero border. A layer
// computes only the positions of C_{s+1}; every other stored position of a
// stage stays zero, which is exactly the SAME padding each layer sees on the
// image (an intermediate outside the image is zero, not bias and not a conv
// of padded input). At an 8 x 8 image one tile is the whole image and no
// halo is recomputed; at 64 x 64 the halo costs (T + 2n)^2 / T^2 in the
// first layer.
//
// Each layer is an implicit GEMM, M = pixels of C_{s+1}, N = C_{s+1}
// channels, K = 9 * C_s. The A operand is read straight from the stored
// stage (four channels per 16-byte load; the pixel stride is padded to an odd
// number of 16-byte words so that neighbouring pixels fall in different
// banks). The weights do not fit in shared memory (9 * 128 * 128 * 4 bytes a
// layer at the encoder heads), so they stream from L2 in slices of BK rows,
// the next slice fetched into registers while the current one is multiplied.
// A thread accumulates TM pixels x 4 channels in registers; the tile shape
// (TX threads along N, TM pixels a thread) is picked per layer by its width
// (64 -> 64 -> 16 -> 16 -> 4 in the decoder tails). The bias is added in the
// epilogue, which writes the next stage to shared memory or, for the last
// layer, the output to device memory.
//
// What bounds it on this card: float32 FMA on the CUDA cores. The chain
// saves the intermediates' trips to device memory (each under a
// millisecond at the 1000-draw decode) and pays for the halo in operations.
// 227 KB of shared memory hold two float32 stages of 64 channels only up to
// about 24 x 16 pixels, so the 64-channel tails run on 8 x 16 tiles and
// recompute more than twice the first layer's work; the launcher picks, per
// shape, the tile that fits with the least work.
//
// Interface: plain C, loaded with ctypes. The function launches on the given
// stream, does not synchronise, allocates nothing, and returns the CUDA error
// of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXL = 8;             // layers in one chain
constexpr int NT = 256;             // threads per block
constexpr int BK = 32;              // weight rows staged per step
constexpr int WS_FLOATS = BK * 64;  // the staged slice: BK rows x the widest N tile

struct Chain {
  const float* w[MAXL];
  const float* bias[MAXL];
  int C[MAXL + 1];  // channel widths C_0 .. C_n
  int n;
  int B, H, W;
  int TH, TW;       // output tile
  int tiles_x, tiles_y;
  int buf1;         // offset (floats) of the second stage buffer
  int wsoff;        // offset (floats) of the weight slice
};

struct Rect { int y0, x0, h, w; };

// Channels rounded up to whole 16-byte words: the depth of the K loop.
__device__ __forceinline__ int chan4(int c) { return (c + 3) & ~3; }
// Floats between two stored pixels: chan4 padded to an odd number of words.
__device__ __forceinline__ int pixel_stride(int c) {
  const int s = chan4(c);
  return ((s >> 2) & 1) ? s : s + 4;
}

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One layer on one tile. TX threads along N (4 channels each), NT / TX along
// M (TM pixels each, strided by NT / TX so that a warp reads neighbouring
// pixels).
template <int TX, int TM>
__device__ __forceinline__ void layer(const float* __restrict__ src, float* __restrict__ dst,
                                      float* __restrict__ ws, const float* __restrict__ wgt,
                                      const float* __restrict__ bias, int Cin, int Cout,
                                      Rect sin, Rect cout, Rect sout, bool last,
                                      float* __restrict__ out, int b, int H, int W) {
  constexpr int TY = NT / TX, BM = TM * TY, BN = 4 * TX;
  constexpr int W_LD = (BK * BN + NT - 1) / NT;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int cin4 = chan4(Cin), cin_p = pixel_stride(Cin);
  const int cout4 = chan4(Cout), cout_p = pixel_stride(Cout);
  const int M = cout.h * cout.w;
  const int kchunks = (cin4 + BK - 1) / BK;
  const int nchunks = 9 * kchunks;

  for (int m0 = 0; m0 < M; m0 += BM) {
    int in_off[TM], out_off[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + i * TY;
      const bool ok = m < M;
      const int mm = ok ? m : 0;
      const int oy = mm / cout.w;
      const int y = cout.y0 + oy, x = cout.x0 + (mm - oy * cout.w);
      // the pixel above and left of (y, x) in the stored input stage
      in_off[i] = ((y - 1 - sin.y0) * sin.w + (x - 1 - sin.x0)) * cin_p;
      if (!ok) out_off[i] = -1;
      else if (last) out_off[i] = ((b * H + y) * W + x) * Cout;
      else out_off[i] = ((y - sout.y0) * sout.w + (x - sout.x0)) * cout_p;
    }
    for (int n0 = 0; n0 < cout4; n0 += BN) {
      float acc[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

      float wreg[W_LD];
      auto fetch = [&](int chunk) {
        const int t = chunk / kchunks;
        const int c0 = (chunk - t * kchunks) * BK;
#pragma unroll
        for (int j = 0; j < W_LD; ++j) {
          const int e = tid + j * NT;
          const int kk = e / BN, c = c0 + kk, n = n0 + (e - kk * BN);
          float v = 0.f;
          if (e < BK * BN && c < Cin && n < Cout)
            v = __ldg(wgt + ((int64_t)(t * Cin + c)) * Cout + n);
          wreg[j] = v;
        }
      };

      fetch(0);
      for (int chunk = 0; chunk < nchunks; ++chunk) {
#pragma unroll
        for (int j = 0; j < W_LD; ++j) {
          const int e = tid + j * NT;
          if (e < BK * BN) ws[e] = wreg[j];
        }
        __syncthreads();
        if (chunk + 1 < nchunks) fetch(chunk + 1);
        const int t = chunk / kchunks;
        const int c0 = (chunk - t * kchunks) * BK;
        const int rows = min(BK, cin4 - c0);
        const int ky = t / 3;
        const int tap = (ky * sin.w + (t - 3 * ky)) * cin_p + c0;
        for (int kk = 0; kk < rows; kk += 4) {
          float4 a[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            a[i] = *reinterpret_cast<const float4*>(src + in_off[i] + tap + kk);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 bq = *reinterpret_cast<const float4*>(ws + (kk + j) * BN + tx * 4);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float av = lane(a[i], j);
              acc[i][0] = fmaf(av, bq.x, acc[i][0]);
              acc[i][1] = fmaf(av, bq.y, acc[i][1]);
              acc[i][2] = fmaf(av, bq.z, acc[i][2]);
              acc[i][3] = fmaf(av, bq.w, acc[i][3]);
            }
          }
        }
        __syncthreads();
      }

      const int n = n0 + tx * 4;
      if (n < cout4) {
        float bv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = n + q < Cout ? __ldg(bias + n + q) : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (out_off[i] < 0) continue;
          // channels past Cout hold 0 + 0: the next layer's K loop reads them
          const float4 v = make_float4(acc[i][0] + bv[0], acc[i][1] + bv[1],
                                       acc[i][2] + bv[2], acc[i][3] + bv[3]);
          if (!last) {
            *reinterpret_cast<float4*>(dst + out_off[i] + n) = v;
          } else if ((Cout & 3) == 0) {
            *reinterpret_cast<float4*>(out + out_off[i] + n) = v;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (n + q < Cout) out[out_off[i] + n + q] = lane(v, q);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
chain_kernel(const float* __restrict__ x, float* __restrict__ out, Chain p) {
  extern __shared__ __align__(16) float smem[];
  float* bufs[2] = {smem, smem + p.buf1};
  float* ws = smem + p.wsoff;
  const int tid = threadIdx.x;
  const int tiles = p.tiles_x * p.tiles_y;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int ty0 = (tile / p.tiles_x) * p.TH, tx0 = (tile % p.tiles_x) * p.TW;
  const int n = p.n;

  // S[s]: where stage s is stored; Cc[s]: where it is computed (inside the image).
  Rect S[MAXL], Cc[MAXL + 1];
  Cc[n] = Rect{ty0, tx0, min(p.TH, p.H - ty0), min(p.TW, p.W - tx0)};
  for (int s = n - 1; s >= 0; --s) {
    S[s] = Rect{Cc[s + 1].y0 - 1, Cc[s + 1].x0 - 1, Cc[s + 1].h + 2, Cc[s + 1].w + 2};
    const int y0 = max(S[s].y0, 0), y1 = min(S[s].y0 + S[s].h, p.H);
    const int x0 = max(S[s].x0, 0), x1 = min(S[s].x0 + S[s].w, p.W);
    Cc[s] = Rect{y0, x0, y1 - y0, x1 - x0};
  }

  {  // stage 0: the input on S[0], zero outside the image and past C_0
    const Rect s0 = S[0];
    const int C0 = p.C[0], c0p = pixel_stride(C0);
    const int total = s0.h * s0.w * c0p;
    for (int idx = tid; idx < total; idx += NT) {
      const int pix = idx / c0p, c = idx - pix * c0p;
      const int py = pix / s0.w;
      const int yy = s0.y0 + py, xx = s0.x0 + (pix - py * s0.w);
      float v = 0.f;
      if (c < C0 && yy >= 0 && yy < p.H && xx >= 0 && xx < p.W)
        v = __ldg(x + (((int64_t)b * p.H + yy) * p.W + xx) * C0 + c);
      bufs[0][idx] = v;
    }
  }
  __syncthreads();

  for (int l = 0; l < n; ++l) {
    const bool last = l == n - 1;
    const float* src = bufs[l & 1];
    float* dst = bufs[(l + 1) & 1];
    const int Cin = p.C[l], Cout = p.C[l + 1];
    const Rect sout = last ? Rect{0, 0, 0, 0} : S[l + 1];
    if (!last) {  // the next stage starts as zeros: its border and pad channels stay so
      const int total = sout.h * sout.w * pixel_stride(Cout);
      for (int idx = tid; idx < total; idx += NT) dst[idx] = 0.f;
      __syncthreads();
    }
    const int M = Cc[l + 1].h * Cc[l + 1].w;
#define SVRS_LAYER(TX, TM)                                                                  \
  layer<TX, TM>(src, dst, ws, p.w[l], p.bias[l], Cin, Cout, S[l], Cc[l + 1], sout, last, \
                out, b, p.H, p.W)
    if (Cout > 16) {
      if (M <= 64) SVRS_LAYER(16, 4); else SVRS_LAYER(16, 8);
    } else if (Cout > 4) {
      if (M <= 256) SVRS_LAYER(4, 4); else SVRS_LAYER(4, 8);
    } else {
      SVRS_LAYER(1, 2);
    }
#undef SVRS_LAYER
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// chans holds C_0 .. C_n; ws and bs hold n device pointers each (host arrays).
// buf0 and buf1 are the two stage buffers' sizes in floats (multiples of 4).
int svrs_conv3x3_chain(const void* x, const void* const* ws, const void* const* bs,
                       const int* chans, int n, void* out, int B, int H, int W, int TH,
                       int TW, int buf0, int buf1, void* stream) {
  if (n < 1 || n > MAXL || TH < 1 || TW < 1 || (buf0 & 3) || (buf1 & 3))
    return (int)cudaErrorInvalidValue;
  Chain p;
  for (int l = 0; l < n; ++l) {
    p.w[l] = static_cast<const float*>(ws[l]);
    p.bias[l] = static_cast<const float*>(bs[l]);
  }
  for (int l = 0; l <= n; ++l) p.C[l] = chans[l];
  p.n = n; p.B = B; p.H = H; p.W = W; p.TH = TH; p.TW = TW;
  p.tiles_x = (W + TW - 1) / TW;
  p.tiles_y = (H + TH - 1) / TH;
  p.buf1 = buf0;
  p.wsoff = buf0 + buf1;
  const size_t bytes = sizeof(float) * ((size_t)buf0 + buf1 + WS_FLOATS);
  cudaError_t err = cudaFuncSetAttribute(chain_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)B * p.tiles_x * p.tiles_y;
  chain_kernel<<<grid, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}

}  // extern "C"
