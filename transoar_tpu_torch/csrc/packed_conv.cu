// Depth-packed stage-0 band conv, forward, for Hopper (sm_90a).
//
// Replaces: transoar_tpu/ops/pallas/packed_conv.py::_conv_rows (the Pallas
// TPU kernel behind ``packed_conv``). It computes the same function: a 3x3
// conv over (H, W) with stride 1 and zero padding 1 on each side, applied to
// flattened depth-packed rows
//
//     y[bd, h, w, co] = sum_{kh, kw, ci} x[bd, h + kh - 1, w + kw - 1, ci]
//                                        * wp[kh, kw, ci, co]
//
// with x [BD, H, W, Cin] and wp [3, 3, Cin, Cout] in the I/O type (bf16 on
// the serving path, f32 for checks), f32 accumulation, y [BD, H, W, Cout]
// in the I/O type.
//
// What bounds it on the H100: at the flagship's second stage-0 conv
// (Cin = 144, Cout = 96) every output pixel costs 9 * 144 * 96 * 2 = 248,832
// FLOP against 480 bytes of bf16 input and output, about 520 FLOP per byte,
// far above the card's ridge point: the conv is bound by arithmetic, so the
// bf16 path must run on the tensor cores.
//
// What the design does about it:
// - bf16 (``conv_mma``): an implicit GEMM with M = output pixels, N = Cout,
//   K = 9 taps x Cin, on warp-level mma.sync m16n8k16 (bf16 in, f32
//   accumulate). A block owns TH x TW = 2 x 64 output pixels of one row bd
//   and up to MMA_TN = 96 output channels (the flagship's Cout: each input
//   patch is staged once for all of them). It loops over Cin in chunks of 16
//   (one mma k-step per tap), staging the (TH + 2) x (TW + 2) x 16 input
//   patch (zeros outside H and W, so no padded copy exists in device memory)
//   and the 3 x 3 x 16 x 96 weight slice in shared memory; the whole band
//   weight (248,832 bytes at 144 -> 96) is above the 227 KB a block may hold,
//   so it is never resident at once. A tap's A operand is the patch shifted
//   by (kh, kw): ldmatrix takes one row address per pixel, so the shift costs
//   nothing. Rows of both tiles are padded so that ldmatrix is free of bank
//   conflicts. Input chunks are loaded 16 bytes at a time when Cin % 8 == 0
//   and x is 16-byte aligned, the weight when Cout % 8 == 0 and wp is
//   aligned; otherwise element by element (Cin = 6 on the first conv: 12-byte
//   pixels), and the padded channels are zeros.
// - f32 (``conv_fma``): the same tiling idea on the CUDA cores in f32 FMA,
//   for exact checks against f32 references: each thread keeps a TH x CPT
//   register tile and reuses every input value for CPT channels and 3 taps.
// Left for later work: wgmma and TMA with a pipelined chunk loop, skipping
// the zero half of the band (conv3d.py:_packed_band_kernel), vector stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_TH = 2;                        // output rows per block
constexpr int MMA_TW = 64;                       // output columns per block
constexpr int MMA_TN = 96;                       // output channels per block
constexpr int MMA_CK = 16;                       // input channels per chunk
constexpr int MMA_WARPS_M = 4;                   // 32 pixels per warp
constexpr int MMA_WARPS_N = 2;                   // 48 channels per warp
constexpr int MMA_NT = MMA_TN / MMA_WARPS_N / 8;  // n8 tiles per warp: 6
constexpr int MMA_THREADS = 32 * MMA_WARPS_M * MMA_WARPS_N;  // 256
constexpr int PATCH_W = MMA_TW + 2;
constexpr int PATCH_PIX = (MMA_TH + 2) * PATCH_W;
constexpr int XS_STRIDE = MMA_CK + 8;   // 48-byte pixel rows: no conflicts
constexpr int WS_STRIDE = MMA_TN + 8;   // 208-byte k rows: no conflicts

static_assert(MMA_TH * MMA_TW == 32 * MMA_WARPS_M, "one m32 slab per warp");
static_assert(MMA_TW % 32 == 0, "a warp's 32 pixels lie in one output row");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x, w are bf16 bit patterns (uint16_t); y is bf16.
__global__ void __launch_bounds__(MMA_THREADS)
conv_mma(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
         __nv_bfloat16* __restrict__ y, int H, int W, int Cin, int Cout,
         int w_tiles, int n_tiles, int vec_x, int vec_w) {
  __shared__ __align__(16) uint16_t xs[PATCH_PIX][XS_STRIDE];
  __shared__ __align__(16) uint16_t ws[9][MMA_CK][WS_STRIDE];

  int b = blockIdx.x;
  const int nt = b % n_tiles;
  b /= n_tiles;
  const int wt = b % w_tiles;
  const int bd = b / w_tiles;
  const int h0 = blockIdx.y * MMA_TH;
  const int w0 = wt * MMA_TW;
  const int n0 = nt * MMA_TN;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % MMA_WARPS_M;
  const int wn = warp / MMA_WARPS_M;
  const int row = wm / (MMA_TW / 32);          // output row in the tile
  const int col0 = (wm % (MMA_TW / 32)) * 32;  // first output column

  float acc[2][MMA_NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < MMA_NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;

  const uint16_t* xb = x + (size_t)bd * H * W * Cin;

  for (int c0 = 0; c0 < Cin; c0 += MMA_CK) {
    const int kc = min(MMA_CK, Cin - c0);
    // input patch rows h0-1 .. h0+TH, columns w0-1 .. w0+TW, channels
    // c0 .. c0+15 (zero outside the image and past Cin)
    if (vec_x) {  // Cin % 8 == 0, so kc is 8 or 16
      for (int i = tid; i < PATCH_PIX * 2; i += MMA_THREADS) {
        const int p = i >> 1, half = i & 1;
        const int h = h0 - 1 + p / PATCH_W, ww = w0 - 1 + p % PATCH_W;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (8 * half < kc && h >= 0 && h < H && ww >= 0 && ww < W)
          v = *reinterpret_cast<const uint4*>(
              xb + ((size_t)h * W + ww) * Cin + c0 + 8 * half);
        *reinterpret_cast<uint4*>(&xs[p][8 * half]) = v;
      }
    } else {
      for (int i = tid; i < PATCH_PIX * MMA_CK; i += MMA_THREADS) {
        const int p = i / MMA_CK, ci = i % MMA_CK;
        const int h = h0 - 1 + p / PATCH_W, ww = w0 - 1 + p % PATCH_W;
        uint16_t v = 0;
        if (ci < kc && h >= 0 && h < H && ww >= 0 && ww < W)
          v = xb[((size_t)h * W + ww) * Cin + c0 + ci];
        xs[p][ci] = v;
      }
    }
    // weight slice wp[:, :, c0:c0+16, n0:n0+96] (zero past Cin and Cout)
    if (vec_w) {  // Cout % 8 == 0: a group of 8 channels is all in or out
      for (int i = tid; i < 9 * MMA_CK * (MMA_TN / 8); i += MMA_THREADS) {
        const int g = i % (MMA_TN / 8);
        const int k = (i / (MMA_TN / 8)) % MMA_CK;
        const int tap = i / (MMA_TN / 8) / MMA_CK;
        const int n = n0 + 8 * g;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k < kc && n < Cout)
          v = *reinterpret_cast<const uint4*>(
              w + ((size_t)tap * Cin + c0 + k) * Cout + n);
        *reinterpret_cast<uint4*>(&ws[tap][k][8 * g]) = v;
      }
    } else {
      for (int i = tid; i < 9 * MMA_CK * MMA_TN; i += MMA_THREADS) {
        const int n = i % MMA_TN;
        const int k = (i / MMA_TN) % MMA_CK;
        const int tap = i / MMA_TN / MMA_CK;
        uint16_t v = 0;
        if (k < kc && n0 + n < Cout)
          v = w[((size_t)tap * Cin + c0 + k) * Cout + n0 + n];
        ws[tap][k][n] = v;
      }
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap % 3;
      // A: 16 pixels x 16 channels per m16 tile; lane l addresses pixel
      // l % 16 and channel half l / 16 (ldmatrix fragment order a0..a3)
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = (row + kh) * PATCH_W + col0 + 16 * i + lane % 16 + kw;
        ldsm_x4(a[i], &xs[p][(lane / 16) * 8]);
      }
      // B: two n8 tiles per ldmatrix.trans; lane l addresses k row
      // l % 8 + 8 * ((l / 8) % 2) of n tile (l / 16)
#pragma unroll
      for (int j = 0; j < MMA_NT / 2; ++j) {
        uint32_t bf[4];
        const int k = lane % 8 + 8 * ((lane / 8) % 2);
        const int n = wn * (MMA_TN / MMA_WARPS_N) + 16 * j + 8 * (lane / 16);
        ldsm_x4_trans(bf, &ws[tap][k][n]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * j], a[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * j + 1], a[i], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }

  // C fragment: c0, c1 at (pixel lane / 4, channels 2 * (lane % 4) + {0, 1}),
  // c2, c3 at pixel + 8
  const int h = h0 + row;
  if (h >= H) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int wo = w0 + col0 + 16 * i + lane / 4 + 8 * half;
      if (wo >= W) continue;
      __nv_bfloat16* yp = y + (((size_t)bd * H + h) * W + wo) * Cout;
#pragma unroll
      for (int t = 0; t < MMA_NT; ++t) {
        const int co = n0 + wn * (MMA_TN / MMA_WARPS_N) + 8 * t +
                       2 * (lane % 4);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (co + e < Cout)
            yp[co + e] = __float2bfloat16(acc[i][t][2 * half + e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int TH = 8;                 // output rows per block (and per thread)
constexpr int TW = 64;                // output columns per block
constexpr int TC = 32;                // output channels per block
constexpr int CPT = 8;                // output channels per thread
constexpr int CK = 8;                 // input channels staged per pass
constexpr int LANES = TC / CPT;       // threads sharing one output column
constexpr int THREADS = LANES * TW;   // 256

__global__ void __launch_bounds__(THREADS)
conv_fma(const float* __restrict__ x, const float* __restrict__ w,
         float* __restrict__ y, int H, int W, int Cin, int Cout, int w_tiles,
         int c_tiles) {
  __shared__ float xs[CK][TH + 2][TW + 2];
  __shared__ __align__(16) float ws[3][3][CK][TC];

  int b = blockIdx.x;
  const int ct = b % c_tiles;
  b /= c_tiles;
  const int wt = b % w_tiles;
  const int bd = b / w_tiles;
  const int h0 = blockIdx.y * TH;
  const int w0 = wt * TW;
  const int c0 = ct * TC;

  const int tid = threadIdx.x;
  const int lane_c = tid % LANES;  // channels c0 + lane_c * CPT + [0, CPT)
  const int px = tid / LANES;      // output column w0 + px

  float acc[TH][CPT];
#pragma unroll
  for (int r = 0; r < TH; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;

  const float* xb = x + (size_t)bd * H * W * Cin;

  for (int k0 = 0; k0 < Cin; k0 += CK) {
    const int kc = min(CK, Cin - k0);
    for (int i = tid; i < (TH + 2) * (TW + 2) * CK; i += THREADS) {
      const int ci = i % CK;
      const int rc = i / CK;
      const int c = rc % (TW + 2);
      const int r = rc / (TW + 2);
      const int h = h0 - 1 + r;
      const int ww = w0 - 1 + c;
      float v = 0.f;
      if (ci < kc && h >= 0 && h < H && ww >= 0 && ww < W)
        v = xb[((size_t)h * W + ww) * Cin + k0 + ci];
      xs[ci][r][c] = v;
    }
    for (int i = tid; i < 9 * CK * TC; i += THREADS) {
      const int co = i % TC;
      const int rest = i / TC;
      const int ci = rest % CK;
      const int tap = rest / CK;  // kh * 3 + kw
      float v = 0.f;
      if (ci < kc && c0 + co < Cout)
        v = w[((size_t)tap * Cin + k0 + ci) * Cout + c0 + co];
      ws[tap / 3][tap % 3][ci][co] = v;
    }
    __syncthreads();

    for (int ci = 0; ci < kc; ++ci) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        float xv[TH + 2];
#pragma unroll
        for (int r = 0; r < TH + 2; ++r) xv[r] = xs[ci][r][px + kw];
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const float4 wa = *reinterpret_cast<const float4*>(
              &ws[kh][kw][ci][lane_c * CPT]);
          const float4 wb = *reinterpret_cast<const float4*>(
              &ws[kh][kw][ci][lane_c * CPT + 4]);
          const float wv[CPT] = {wa.x, wa.y, wa.z, wa.w,
                                 wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int r = 0; r < TH; ++r)
#pragma unroll
            for (int j = 0; j < CPT; ++j)
              acc[r][j] = fmaf(xv[r + kh], wv[j], acc[r][j]);
        }
      }
    }
    __syncthreads();
  }

  const int wo = w0 + px;
  if (wo >= W) return;
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const int h = h0 + r;
    if (h >= H) break;
    float* yp = y + (((size_t)bd * H + h) * W + wo) * Cout;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int co = c0 + lane_c * CPT + j;
      if (co < Cout) yp[co] = acc[r][j];
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C interface, bound with ctypes. Every pointer is a device pointer to
// a contiguous tensor; ``stream`` is a cudaStream_t. Returns the launch's
// cudaError_t (0 on success).
extern "C" int packed_conv_fwd_bf16(const void* x, const void* w, void* y,
                                    int BD, int H, int W, int Cin, int Cout,
                                    void* stream) {
  const int w_tiles = (W + MMA_TW - 1) / MMA_TW;
  const int n_tiles = (Cout + MMA_TN - 1) / MMA_TN;
  const dim3 grid((unsigned)BD * w_tiles * n_tiles,
                  (H + MMA_TH - 1) / MMA_TH);
  conv_mma<<<grid, MMA_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<__nv_bfloat16*>(y), H, W, Cin, Cout, w_tiles, n_tiles,
      Cin % 8 == 0 && aligned16(x), Cout % 8 == 0 && aligned16(w));
  return (int)cudaGetLastError();
}

extern "C" int packed_conv_fwd_f32(const void* x, const void* w, void* y,
                                   int BD, int H, int W, int Cin, int Cout,
                                   void* stream) {
  const int w_tiles = (W + TW - 1) / TW;
  const int c_tiles = (Cout + TC - 1) / TC;
  const dim3 grid((unsigned)BD * w_tiles * c_tiles, (H + TH - 1) / TH);
  conv_fma<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), H, W, Cin, Cout, w_tiles, c_tiles);
  return (int)cudaGetLastError();
}
