// Depth-packed stage-0 band conv, forward and weight gradient, for Hopper
// (sm_90a). The input gradient is the forward kernel run on dy with the
// flipped, transposed band (ops/kernels/packed_conv.py:packed_conv_dx); the
// weight gradient is further down (``dw_wide`` / ``dw_fold`` / ``dw_mma`` /
// ``dw_fma``).
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
// far above the card's ridge point (295): bound by arithmetic, so it must
// run on wgmma, the only path to the tensor cores' full rate. The first conv
// (Cin = 6, Cout = 96) does 54 multiply-adds per output value and writes 16
// bytes for every byte it reads: bound by the bytes of its output.
//
// What the design does about it: three bf16 kernels, one function, chosen
// by shape in the wrapper (ops/kernels/packed_conv.py:_variant):
// - wide (``conv_wide<N>``, Cin % 8 == 0, N = Cout in {64, 96, 144}): an
//   implicit GEMM, M = 2 x 128 output pixels of two rows, N = all of Cout in
//   one wgmma tile, K = 9 taps x Cin in chunks of 16 channels. One thread
//   keeps a ring of 3-4 stages filled (TMA for the zero-padded input
//   patch, one bulk copy for the weight chunk), signalled by mbarriers;
//   two warpgroups run m64nNk16 wgmma with both operands read from
//   shared memory by descriptor (no swizzle, K-major: a tap's shift is a
//   descriptor 16 bytes per pixel further on) while the next chunks land.
//   The epilogue stages bf16 rows in shared memory and writes 16-byte
//   stores, a tile row being one contiguous span of y. A block streams the
//   whole band weight (249 KB at 144 -> 96) through L2 once per 256 output
//   pixels, half of conv_mma's 128: 4.08 GB of L2 reads at the flagship
//   training shape against 8.15 GB.
// - fold (``conv_fold<N>``, Cin 2, 4 or 6 with W * Cin % 8 == 0): the taps
//   fold into K = 9 Cin <= 54, padded to 64 (4 k16 steps, not 9 mostly
//   empty ones); the folded weight stays in shared memory; a persistent
//   grid walks 2 x 128 tiles, fetching the next tile's input rows (one
//   16-byte-aligned span per row) with cp.async while it computes; A is
//   built in registers from those rows (wgmma with A from registers); the
//   same staged, coalesced epilogue.
// - generic (``conv_mma``, every other bf16 shape: Cin odd or above 8 and
//   not a multiple of 8, other Cout, unaligned operands): warp-level
//   mma.sync m16n8k16, a block of TH x TW = 2 x 64 output pixels and up to
//   96 output channels, Cin in synchronous chunks of 16 channels staged in
//   shared memory, ldmatrix with one row address per pixel (the shift by
//   (kh, kw) costs nothing), element-wise loads where a pixel is not 16
//   bytes aligned, stores straight from the accumulator fragment.
// All three are deterministic: no split-K, no atomics.
// - f32 (``conv_fma``): the same tiling idea on the CUDA cores in f32 FMA,
//   for exact checks against f32 references: each thread keeps a TH x CPT
//   register tile and reuses every input value for CPT channels and 3 taps.
// Left for later work: skipping the zero half of the band
// (conv3d.py:_packed_band_kernel); a 2-block cluster multicasting each
// weight chunk (halving the L2 weight traffic again); a persistent wide grid
// whose epilogue overlaps the next tile's loads.

#include <cuda.h>  // CUtensorMap and its enums (header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

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
// bf16 on wgmma: the wide path (Cin % 8 == 0) and the folded-tap path
// (Cin = 2, 4 or 6), one template over N = Cout each
// ---------------------------------------------------------------------------

constexpr int T_H = 2;                         // output rows per tile
constexpr int T_W = 128;                       // output columns per tile
constexpr int T_PIX = T_H * T_W;               // 256: two warpgroups x m128
constexpr int TILE_THREADS = 2 * 128;          // two warpgroups, a row each

// The accumulators of a tile: warpgroup g owns output row g, as two m64
// tiles of 64 columns, each [64, N] in wgmma's D fragment (warp w of the
// group rows 16w + lane / 4 (+ 8), columns 8j + 2 (lane % 4) + {0, 1}).
// Both groups stage their bf16 rows in shared memory (``out``, rows padded
// to N + 8 elements so the fragment writes are free of bank conflicts),
// then copy them out as 16-byte stores: a tile row is one contiguous span
// of y. Called by the block's 256 threads; ``out`` holds T_PIX x (N + 8).
template <int N>
__device__ __forceinline__ void store_tile(float (&acc)[2][N / 2],
                                           __nv_bfloat16* out,
                                           __nv_bfloat16* __restrict__ y,
                                           int bd, int h0, int w0, int H,
                                           int W) {
  constexpr int OS = N + 8;
  const int t = threadIdx.x % 128, g = threadIdx.x / 128;
  const int warp = t / 32, lane = t % 32;
  __nv_bfloat16* rows = out + g * T_W * OS;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 64 * i + 16 * warp + lane / 4 + 8 * half;
        *reinterpret_cast<__nv_bfloat162*>(&rows[p * OS + 8 * j +
                                                 2 * (lane % 4)]) =
            __floats2bfloat162_rn(acc[i][4 * j + 2 * half],
                                  acc[i][4 * j + 2 * half + 1]);
      }
  hopper::bar_sync(2 + g, 128);
  const int h = h0 + g;
  if (h >= H) return;
  const int npix = min(T_W, W - w0);
  uint4* dst = reinterpret_cast<uint4*>(y + (((size_t)bd * H + h) * W + w0) *
                                                N);
  for (int q = t; q < npix * (N / 8); q += 128) {
    const int p = q / (N / 8), v = q % (N / 8);
    dst[q] = *reinterpret_cast<const uint4*>(&rows[p * OS + 8 * v]);
  }
}

// Wide path. An implicit GEMM per tile of T_H x T_W output pixels: M = 256
// pixels, N = Cout in one tile, K = 9 taps x Cin in chunks of 16 channels.
// Stage s of the ring holds chunk c's input patch, (T_H + 2) x (T_W + 2)
// pixels x 16 channels as [channel half][pixel][8] (two TMA boxes; zeros
// outside the image, so the padding costs nothing), and its weight slice
// [tap][channel half][N][8] (one bulk copy of the wrapper's re-laid-out
// band). Both are K-major wgmma operands without swizzle: tap (kh, kw)'s A
// is the patch shifted by kh rows and kw pixels, a descriptor 16 bytes per
// pixel further on. Warpgroups 0 and 1 consume, each m64 x 2 over one
// output row, releasing a stage once the wgmma that read it has retired
// (one group kept in flight).
template <int N>
struct Wide {
  static constexpr int PW = T_W + 2;                    // patch columns
  static constexpr int HALF = (T_H + 2) * PW * 16;      // bytes per half
  static constexpr int PATCH = 2 * HALF;                // 16,640
  static constexpr int WCHUNK = 9 * 2 * N * 16;         // weight bytes
  static constexpr int STAGE = PATCH + WCHUNK;
  static constexpr int STAGES = N > 96 ? 3 : 4;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8;
  static_assert(T_PIX * (N + 8) * 2 <= STAGES * STAGE, "epilogue fits");
  static_assert(SMEM <= 232448, "fits the SM's shared memory");
};

// Thread 0 also produces: it fills the ring ahead and refills a stage once
// all eight warps have released it. With a producer warp (288
// threads) or warpgroup (384, setmaxnreg notwithstanding) ptxas held every
// thread to 168 registers, too few beside the 144 accumulators of N = 144:
// they spilled. At 256 threads a thread may hold 255.
template <int N>
__device__ __forceinline__ void wide_load(const CUtensorMap* xmap,
                                          const uint16_t* wk, uint8_t* smem,
                                          uint64_t* full, int c, int w0,
                                          int h0, int bd) {
  using C = Wide<N>;
  const int s = c % C::STAGES;
  uint8_t* st = smem + s * C::STAGE;
  hopper::mbar_expect_tx(&full[s], C::STAGE);
  for (int half = 0; half < 2; ++half)
    hopper::tma_load_5d(st + half * C::HALF, xmap, &full[s], 0, 2 * c + half,
                        w0 - 1, h0 - 1, bd);
  hopper::bulk_load(st + C::PATCH, wk + (size_t)c * (C::WCHUNK / 2),
                    C::WCHUNK, &full[s]);
}

template <int N>
__global__ void __launch_bounds__(TILE_THREADS, 1)
conv_wide(const __grid_constant__ CUtensorMap xmap,
          const uint16_t* __restrict__ wk, __nv_bfloat16* __restrict__ y,
          int H, int W, int chunks, int w_tiles) {
  using C = Wide<N>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;

  const int wt = blockIdx.x % w_tiles, bd = blockIdx.x / w_tiles;
  const int h0 = blockIdx.y * T_H, w0 = wt * T_W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], TILE_THREADS / 32);  // one per warp
    }
    hopper::mbar_init_fence();
    for (int c = 0; c < min(chunks, C::STAGES); ++c)
      wide_load<N>(&xmap, wk, smem, full, c, w0, h0, bd);
  }
  __syncthreads();

  const int g = warp / 4;  // warpgroup: output row h0 + g
  float acc[2][N / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[i][e] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    const int s = c % C::STAGES;
    hopper::mbar_wait(&full[s], (c / C::STAGES) & 1);
    const uint32_t xs = hopper::smem_u32(smem + s * C::STAGE);
    const uint32_t ws = xs + C::PATCH;
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);
    hopper::wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap % 3;
      const uint64_t bdesc = hopper::desc(ws + tap * 2 * N * 16, N * 16, 128);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        hopper::wgmma_ss<N>(
            acc[i],
            hopper::desc(xs + ((g + kh) * C::PW + 64 * i + kw) * 16, C::HALF,
                         128),
            bdesc);
    }
    hopper::wgmma_commit();
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);
    hopper::wgmma_wait<1>();  // chunk c - 1's products have retired
    if (c > 0) {
      const int done = c - 1, s_done = done % C::STAGES;
      if (lane == 0) hopper::mbar_arrive(&empty[s_done]);
      if (threadIdx.x == 0 && done + C::STAGES < chunks) {
        hopper::mbar_wait(&empty[s_done], (done / C::STAGES) & 1);
        wide_load<N>(&xmap, wk, smem, full, done + C::STAGES, w0, h0, bd);
      }
      __syncwarp();  // wgmma is warp-aligned: lane 0 rejoins its warp
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc[0]);
  hopper::fence_regs(acc[1]);
  // every load was consumed and every product has retired: the ring's
  // memory is free for the epilogue
  __syncthreads();
  store_tile<N>(acc, reinterpret_cast<__nv_bfloat16*>(smem), y, bd, h0, w0,
                H, W);
}

// Folded-tap path for Cin = 2, 4 or 6 (the first stage-0 conv: 6): the nine
// taps fold into K = 9 Cin <= 54, zero-padded to 64, so a tile is four k16
// steps instead of nine half-empty ones. The folded weight [64, N], as the
// wrapper lays it out ([k group][N][8], K-major), stays in shared memory for
// the block's life. The grid is persistent over T_H x T_W tiles; a tile's
// input rows h0 - 1 .. h0 + T_H and columns w0 - 8 .. w0 + T_W + 7 are one
// contiguous, 16-byte-aligned span per row (W * Cin % 8 == 0), fetched with
// 16-byte cp.async (zeros outside the image) into one of two buffers while
// the other tile computes. A is built in registers straight from those rows
// (a pair of adjacent k is a pair of channels of one pixel and tap, since
// Cin is even: one 32-bit load each), then wgmma with B from shared memory.
// The output (16 bytes written per input byte read at 6 -> 96) goes through
// the same staged, coalesced epilogue as the wide path.
constexpr int FOLD_K = 64;
constexpr int FOLD_RW = T_W + 16;                   // raw row columns
constexpr int FOLD_RAW = (T_H + 2) * FOLD_RW * 6;   // elements, Cin <= 6

template <int N>
struct Fold {
  static constexpr int WBYTES = FOLD_K * N * 2;
  static constexpr int OUT = T_PIX * (N + 8) * 2;
  static constexpr int SMEM = WBYTES + OUT + 2 * FOLD_RAW * 2;
};

template <int N>
__global__ void __launch_bounds__(TILE_THREADS, 1)
conv_fold(const uint16_t* __restrict__ x, const uint16_t* __restrict__ wf,
          __nv_bfloat16* __restrict__ y, int BD, int H, int W, int Cin) {
  using C = Fold<N>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint16_t* ws = reinterpret_cast<uint16_t*>(smem);
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(smem + C::WBYTES);
  uint16_t* raw = reinterpret_cast<uint16_t*>(smem + C::WBYTES + C::OUT);

  const int t = threadIdx.x % 128, g = threadIdx.x / 128;
  const int warp = t / 32, lane = t % 32;
  const int h_tiles = (H + T_H - 1) / T_H, w_tiles = (W + T_W - 1) / T_W;
  const long long tiles = (long long)BD * h_tiles * w_tiles;
  const int row_elems = FOLD_RW * Cin;      // a multiple of 8
  const long long img_row = (long long)W * Cin;

  for (int i = threadIdx.x; i < C::WBYTES / 16; i += TILE_THREADS)
    reinterpret_cast<uint4*>(ws)[i] = reinterpret_cast<const uint4*>(wf)[i];
  hopper::fence_async_smem();

  // this lane's k offsets into the raw rows, per k16 step and k half
  // (k = 16 s + 8 hk + 2 (lane % 4)); -1 past 9 Cin
  int koff[4][2];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      const int k = 16 * s + 8 * hk + 2 * (lane % 4);
      const int tap = k / Cin, ci = k % Cin;
      koff[s][hk] = k < 9 * Cin
                        ? ((tap / 3) * FOLD_RW + tap % 3 + 7) * Cin + ci
                        : -1;
    }

  auto fetch = [&](long long tile, uint16_t* buf) {
    const int wt = (int)(tile % w_tiles);
    const long long r = tile / w_tiles;
    const int h0 = (int)(r % h_tiles) * T_H, bd = (int)(r / h_tiles);
    const long long c0 = (long long)(wt * T_W - 8) * Cin;  // row element
    for (int q = threadIdx.x; q < (T_H + 2) * (row_elems / 8);
         q += TILE_THREADS) {
      const int rr = q / (row_elems / 8), v = q % (row_elems / 8);
      const int h = h0 - 1 + rr;
      const long long e = c0 + 8 * v;
      const bool ok = h >= 0 && h < H && e >= 0 && e < img_row;
      const uint16_t* src =
          ok ? x + ((long long)bd * H + h) * img_row + e : x;
      hopper::cp_async16(buf + rr * row_elems + 8 * v, src, ok);
    }
    hopper::cp_async_commit();
  };

  long long tile = blockIdx.x;
  if (tile < tiles) fetch(tile, raw);
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    uint16_t* cur = raw + (it & 1) * FOLD_RAW;
    const long long next = tile + gridDim.x;
    if (next < tiles) {
      fetch(next, raw + ((it + 1) & 1) * FOLD_RAW);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();  // this tile's rows (and, the first time, ws) are in

    float acc[2][N / 2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[i][e] = 0.f;
    uint32_t a[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = (g * FOLD_RW + 64 * i + 16 * warp + lane / 4) * Cin;
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // (row + 8 (r % 2), k half r / 2)
          const int off = koff[s][r / 2];
          a[i][s][r] = off < 0 ? 0u
                               : *reinterpret_cast<const uint32_t*>(
                                     cur + p + 8 * (r % 2) * Cin + off);
        }
    }
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);
    hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t bdesc = hopper::desc(
          hopper::smem_u32(ws) + 2 * s * N * 16, N * 16, 128);
#pragma unroll
      for (int i = 0; i < 2; ++i) hopper::wgmma_rs<N>(acc[i], a[i][s], bdesc);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);

    const int wt = (int)(tile % w_tiles);
    const long long r = tile / w_tiles;
    const int h0 = (int)(r % h_tiles) * T_H, bd = (int)(r / h_tiles);
    // all reads of ``cur`` and of the last tile's ``out`` are done
    __syncthreads();
    store_tile<N>(acc, out, y, bd, h0, wt * T_W, H, W);
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

// ---------------------------------------------------------------------------
// Weight gradient (dw) of the band conv
// ---------------------------------------------------------------------------
//
// Replaces: transoar_tpu/ops/pallas/packed_conv.py::_dw_rows. It computes
//
//     dw[kh, kw, ci, co] = sum_{bd, h, w} x[bd, h + kh - 1, w + kw - 1, ci]
//                                         * dy[bd, h, w, co]
//
// in f32 (zero outside H and W), x [BD, H, W, Cin], dy [BD, H, W, Cout].
// At the flagship's second stage-0 conv (batch 2, Cin = 144, Cout = 96) it
// is 1,044 GFLOP against 2 GB of bf16 input: bound by arithmetic, so the
// bf16 path runs on the tensor cores.
//
// Design: an implicit GEMM per tap with M = Cin, N = Cout, K = pixels. The
// TPU kernel summed every grid step into one VMEM block (its grid runs in
// order); blocks here run in parallel and in no order, so the sum is split:
// each block sums a contiguous range of pixel tiles into f32 registers and
// writes its partial slice of ``part[split]``; ``dw_reduce`` then adds the
// partials in split order. No atomics: the result is the same bits on every
// run. Four kernels, chosen by shape in the wrapper
// (ops/kernels/packed_conv.py:_dw_variant): the wgmma kernels ``dw_wide``
// (Cin % 16 == 0) and ``dw_fold`` (Cin 2, 4 or 6), further down, take the
// main path's shapes; ``dw_mma`` every other bf16 shape; ``dw_fma`` f32.
// - bf16 generic (``dw_mma``): block (ci chunk, n tile, split); a pixel tile is TH x TW = 2 x 64 output pixels of one
//   row bd. The block stages the (TH + 2) x (TW + 2) x 16 input patch (zeros
//   outside the image and past Cin) and the TH x TW x 96 dy tile in shared
//   memory, as the forward stages its patch. Tap (kh, kw)'s A operand
//   (16 channels x 16 pixels) is the patch shifted by (kh, kw), read with
//   ldmatrix.trans (pixel rows, channels contiguous); B is the dy tile,
//   unshifted and shared by all nine taps. Six warps: warp w owns kh = w % 3
//   and output channels 48 * (w / 3) .. + 47, so each keeps 3 x 6 m16n8 f32
//   accumulators. Same padded, conflict-free row strides as the forward.
// - f32 (``dw_fma``): the same split on the CUDA cores, for exact checks:
//   a block owns 8 input x 32 output channels, a thread one (ci, co) pair
//   and its nine taps.

constexpr int DW_TH = 2;                       // pixel rows per tile
constexpr int DW_TW = 64;                      // pixel columns per tile
constexpr int DW_CK = 16;                      // input channels per block
constexpr int DW_TN = 96;                      // output channels per block
constexpr int DW_WARPS = 6;                    // 3 kh x 2 channel halves
constexpr int DW_THREADS = 32 * DW_WARPS;      // 192
constexpr int DW_NT = DW_TN / 2 / 8;           // n8 tiles per warp: 6
constexpr int DW_PATCH_W = DW_TW + 2;
constexpr int DW_PATCH_PIX = (DW_TH + 2) * DW_PATCH_W;
constexpr int DW_DY_STRIDE = DW_TN + 8;        // 208-byte rows: no conflicts
constexpr int DW_TARGET_BLOCKS = 132 * 8;      // enough blocks to fill the SMs

static_assert(DW_TW % 16 == 0, "a k step is 16 pixels of one row");

__global__ void __launch_bounds__(DW_THREADS)
dw_mma(const uint16_t* __restrict__ x, const uint16_t* __restrict__ dy,
       float* __restrict__ part, int BD, int H, int W, int Cin, int Cout,
       int c_chunks, int n_tiles, int splits, int vec_x, int vec_dy) {
  __shared__ __align__(16) uint16_t xs[DW_PATCH_PIX][XS_STRIDE];
  __shared__ __align__(16) uint16_t dys[DW_TH * DW_TW][DW_DY_STRIDE];

  int b = blockIdx.x;
  const int cc = b % c_chunks;
  b /= c_chunks;
  const int nt = b % n_tiles;
  const int split = b / n_tiles;
  const int c0 = cc * DW_CK;
  const int n0 = nt * DW_TN;
  const int kc = min(DW_CK, Cin - c0);

  const int w_tiles = (W + DW_TW - 1) / DW_TW;
  const int h_tiles = (H + DW_TH - 1) / DW_TH;
  const long long tiles = (long long)BD * h_tiles * w_tiles;
  const long long t_begin = tiles * split / splits;
  const long long t_end = tiles * (split + 1) / splits;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int kh = warp % 3;
  const int nbase = (warp / 3) * (DW_TN / 2);

  float acc[3][DW_NT][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int t = 0; t < DW_NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;

  for (long long t = t_begin; t < t_end; ++t) {
    const int wt = (int)(t % w_tiles);
    const long long r = t / w_tiles;
    const int h0 = (int)(r % h_tiles) * DW_TH;
    const int bd = (int)(r / h_tiles);
    const int w0 = wt * DW_TW;
    const uint16_t* xb = x + (size_t)bd * H * W * Cin;
    const uint16_t* dyb = dy + (size_t)bd * H * W * Cout;

    // input patch rows h0-1 .. h0+TH, columns w0-1 .. w0+TW, channels
    // c0 .. c0+15 (zero outside the image and past Cin)
    if (vec_x) {  // Cin % 8 == 0, so kc is 8 or 16
      for (int i = tid; i < DW_PATCH_PIX * 2; i += DW_THREADS) {
        const int p = i >> 1, half = i & 1;
        const int h = h0 - 1 + p / DW_PATCH_W, ww = w0 - 1 + p % DW_PATCH_W;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (8 * half < kc && h >= 0 && h < H && ww >= 0 && ww < W)
          v = *reinterpret_cast<const uint4*>(
              xb + ((size_t)h * W + ww) * Cin + c0 + 8 * half);
        *reinterpret_cast<uint4*>(&xs[p][8 * half]) = v;
      }
    } else {
      for (int i = tid; i < DW_PATCH_PIX * DW_CK; i += DW_THREADS) {
        const int p = i / DW_CK, ci = i % DW_CK;
        const int h = h0 - 1 + p / DW_PATCH_W, ww = w0 - 1 + p % DW_PATCH_W;
        uint16_t v = 0;
        if (ci < kc && h >= 0 && h < H && ww >= 0 && ww < W)
          v = xb[((size_t)h * W + ww) * Cin + c0 + ci];
        xs[p][ci] = v;
      }
    }
    // dy tile rows h0 .. h0+TH-1, columns w0 .. w0+TW-1, channels
    // n0 .. n0+95 (zero outside the image and past Cout)
    if (vec_dy) {  // Cout % 8 == 0: a group of 8 channels is all in or out
      for (int i = tid; i < DW_TH * DW_TW * (DW_TN / 8); i += DW_THREADS) {
        const int p = i / (DW_TN / 8), g = i % (DW_TN / 8);
        const int h = h0 + p / DW_TW, ww = w0 + p % DW_TW;
        const int n = n0 + 8 * g;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (h < H && ww < W && n < Cout)
          v = *reinterpret_cast<const uint4*>(
              dyb + ((size_t)h * W + ww) * Cout + n);
        *reinterpret_cast<uint4*>(&dys[p][8 * g]) = v;
      }
    } else {
      for (int i = tid; i < DW_TH * DW_TW * DW_TN; i += DW_THREADS) {
        const int p = i / DW_TN, n = i % DW_TN;
        const int h = h0 + p / DW_TW, ww = w0 + p % DW_TW;
        uint16_t v = 0;
        if (h < H && ww < W && n0 + n < Cout)
          v = dyb[((size_t)h * W + ww) * Cout + n0 + n];
        dys[p][n] = v;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int ks = 0; ks < DW_TH * DW_TW / 16; ++ks) {
      const int row = ks / (DW_TW / 16);
      const int col0 = (ks % (DW_TW / 16)) * 16;
      // B: dy pixels (k) x channels (n), two n8 tiles per ldmatrix.trans;
      // lane l addresses pixel l % 8 + 8 * ((l / 8) % 2) of n tile l / 16
      uint32_t bf[DW_NT / 2][4];
#pragma unroll
      for (int j = 0; j < DW_NT / 2; ++j) {
        const int k = lane % 8 + 8 * ((lane / 8) % 2);
        const int n = nbase + 16 * j + 8 * (lane / 16);
        ldsm_x4_trans(bf[j], &dys[row * DW_TW + col0 + k][n]);
      }
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        // A: 16 channels (m) x 16 pixels (k) of the patch shifted by
        // (kh, kw), stored pixel-major: ldmatrix.trans, lane l addresses
        // pixel l % 8 + 8 * (l / 16) and channel half (l / 8) % 2
        uint32_t a[4];
        const int mat = lane / 8;
        const int p = (row + kh) * DW_PATCH_W + col0 + kw + lane % 8 +
                      8 * (mat / 2);
        ldsm_x4_trans(a, &xs[p][8 * (mat % 2)]);
#pragma unroll
        for (int j = 0; j < DW_NT / 2; ++j) {
          mma_bf16(acc[kw][2 * j], a, bf[j][0], bf[j][1]);
          mma_bf16(acc[kw][2 * j + 1], a, bf[j][2], bf[j][3]);
        }
      }
    }
    __syncthreads();
  }

  // C fragment: c0, c1 at (channel ci = lane / 4, output channels
  // 2 * (lane % 4) + {0, 1}), c2, c3 at ci + 8
  float* pb = part + (size_t)split * 9 * Cin * Cout;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const int tap = kh * 3 + kw;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = c0 + lane / 4 + 8 * half;
      if (ci >= Cin) continue;
#pragma unroll
      for (int t = 0; t < DW_NT; ++t) {
        const int co = n0 + nbase + 8 * t + 2 * (lane % 4);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (co + e < Cout)
            pb[((size_t)tap * Cin + ci) * Cout + co + e] =
                acc[kw][t][2 * half + e];
      }
    }
  }
}

constexpr int DWF_TH = 4;                       // pixel rows per tile
constexpr int DWF_TW = 32;                      // pixel columns per tile
constexpr int DWF_CK = 8;                       // input channels per block
constexpr int DWF_TC = 32;                      // output channels per block
constexpr int DWF_THREADS = DWF_CK * DWF_TC;    // 256: one (ci, co) each

__global__ void __launch_bounds__(DWF_THREADS)
dw_fma(const float* __restrict__ x, const float* __restrict__ dy,
       float* __restrict__ part, int BD, int H, int W, int Cin, int Cout,
       int c_chunks, int n_tiles, int splits) {
  __shared__ float xs[DWF_CK][DWF_TH + 2][DWF_TW + 2];
  __shared__ float dys[DWF_TH * DWF_TW][DWF_TC];

  int b = blockIdx.x;
  const int cc = b % c_chunks;
  b /= c_chunks;
  const int nt = b % n_tiles;
  const int split = b / n_tiles;
  const int c0 = cc * DWF_CK;
  const int n0 = nt * DWF_TC;

  const int w_tiles = (W + DWF_TW - 1) / DWF_TW;
  const int h_tiles = (H + DWF_TH - 1) / DWF_TH;
  const long long tiles = (long long)BD * h_tiles * w_tiles;
  const long long t_begin = tiles * split / splits;
  const long long t_end = tiles * (split + 1) / splits;

  const int tid = threadIdx.x;
  const int ci = tid / DWF_TC;   // one warp per input channel: broadcasts
  const int co = tid % DWF_TC;

  float acc[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = 0.f;

  for (long long t = t_begin; t < t_end; ++t) {
    const int wt = (int)(t % w_tiles);
    const long long r = t / w_tiles;
    const int h0 = (int)(r % h_tiles) * DWF_TH;
    const int bd = (int)(r / h_tiles);
    const int w0 = wt * DWF_TW;
    const float* xb = x + (size_t)bd * H * W * Cin;
    const float* dyb = dy + (size_t)bd * H * W * Cout;

    for (int i = tid; i < (DWF_TH + 2) * (DWF_TW + 2) * DWF_CK;
         i += DWF_THREADS) {
      const int k = i % DWF_CK;
      const int rc = i / DWF_CK;
      const int c = rc % (DWF_TW + 2), rr = rc / (DWF_TW + 2);
      const int h = h0 - 1 + rr, ww = w0 - 1 + c;
      float v = 0.f;
      if (c0 + k < Cin && h >= 0 && h < H && ww >= 0 && ww < W)
        v = xb[((size_t)h * W + ww) * Cin + c0 + k];
      xs[k][rr][c] = v;
    }
    for (int i = tid; i < DWF_TH * DWF_TW * DWF_TC; i += DWF_THREADS) {
      const int n = i % DWF_TC, p = i / DWF_TC;
      const int h = h0 + p / DWF_TW, ww = w0 + p % DWF_TW;
      float v = 0.f;
      if (h < H && ww < W && n0 + n < Cout)
        v = dyb[((size_t)h * W + ww) * Cout + n0 + n];
      dys[p][n] = v;
    }
    __syncthreads();

    for (int rr = 0; rr < DWF_TH; ++rr) {
      for (int c = 0; c < DWF_TW; ++c) {
        const float d = dys[rr * DWF_TW + c][co];
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            acc[kh * 3 + kw] = fmaf(xs[ci][rr + kh][c + kw], d,
                                    acc[kh * 3 + kw]);
      }
    }
    __syncthreads();
  }

  if (c0 + ci >= Cin || n0 + co >= Cout) return;
  float* pb = part + (size_t)split * 9 * Cin * Cout;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
    pb[((size_t)tap * Cin + c0 + ci) * Cout + n0 + co] = acc[tap];
}

// ---------------------------------------------------------------------------
// dw on wgmma: the wide path (Cin % 16 == 0) and the folded-tap path (Cin 2,
// 4 or 6), one template over N = Cout each
// ---------------------------------------------------------------------------
//
// Both are implicit GEMMs with K = pixels, fed by a TMA ring that thread 0
// keeps filled (as conv_wide), with dy, and in dw_wide x too, MN-major:
// TMA lands a run of channels of each pixel as one row of a swizzled block
// ([channel group][pixel][E channels], 8 pixels x 2E bytes a block), which
// wgmma reads with its transpose immediates. Groups of E = 16 (32-byte
// swizzle) make each TMA request one whole 32-byte sector, where 8-channel
// groups without swizzle read half sectors (slower on the card); dy, where
// Cout % 32 == 0, goes in groups of 32 (64-byte swizzle). (x in 64-channel
// groups, 128-byte swizzle, plus a 16-channel rest was slower again on the
// card: its descriptors had to be chosen per slab at run time.) The
// partials stay as dw_mma's: one f32 slice of
// ``part`` per block (or warpgroup), added by dw_reduce in split order, no
// atomics. wgmma's f32 sums lose precision over very long runs (rel-L2
// 1.1e-4 after 95K pixels at Cin = 144), so a block adds its accumulators
// into its slice of ``part`` every DW_FLUSH tiles.
//
// dw_wide<N>: x^T dy with the three kh taps folded into M. A stage holds
// one tile of DWW_TH x DWW_TW dy pixels, its dy [row][co group][16][E], and
// the x rows h0 - 1 .. h0 + DWW_TH at columns w0 + kw - 1 .. as
// [row][ci group][16][16] (TMA boxes from 5-D views ordered (group width,
// W, groups, H, BD); zeros outside the image). A row is G = Cin / 16
// groups further on, so M row m = kh Cin + ci of dy row r sits in block
// r G + m / 16: one descriptor with a uniform block stride covers (kh, ci)
// across the row boundary, and 3 Cin rows take ceil(3 Cin / 64) m64 slabs.
// A block owns one kw (its x box starts kw - 1 columns over) and up to 2 S
// slabs, S per warpgroup with S m64 x N accumulators (S = 4 at N <= 96: 192
// registers); each dy row of the tile is one k16 step against every slot.
// The grid is splits x 3 kw x slab groups, one wave over the SMs; a split
// is a contiguous range of tiles, so its three kw blocks walk the same
// pixels together and read x and dy through L2. ptxas serializes the whole
// wgmma chain (C7518 / C7520) when code on a branch touches the
// accumulators or holds a wgmma; so every slot runs its product (a slot
// past the last slab repeats it and the flush drops the copy), a run's
// first products overwrite the accumulators (scale-d 0) instead of zeroing
// them, and only the flush, after the last wait, reads them (a quarter less
// time than the serialized build at the flagship shape on an H100; 254
// registers at N = 96, no spills). At Cin = 144, N = 96 the 7 slabs take
// the 8 slots of one block, so 432 of the 512 rows computed are used (84.4%,
// against 432 of 576 for 64-channel slabs per tap).
//
// dw_fold<N>: the nine taps fold into M = 9 Cin <= 54 (one m64 slab, 84%
// of its rows used at Cin = 6), N = Cout, K = pixels. A persistent grid, a
// contiguous range of DWF2_TH x DWF2_TW tiles per block; warpgroup g takes
// output row g of each tile and keeps its own partial. A stage holds the dy
// tile ([row][co group][128][E], TMA) and the raw x rows h0 - 1 .. h0 +
// DWF2_TH, columns w0 - 8 .. w0 + DWF2_TW + 7 (one TMA box of 16-byte runs
// of the row-major [BD * H][W * Cin] view; zeros outside). A is built in
// registers: a register pair is two adjacent pixels of one (tap, ci), two
// 2-byte loads each (wgmma RS); B is the dy tile by descriptor. It is
// bound by dy's bytes: each dy byte is read once.

constexpr int DWW_TH = 8;    // dy rows per tile
constexpr int DWW_TW = 16;   // dy columns per tile: one k16 step per row
constexpr int DW_FLUSH = 128;             // tiles between partial flushes
constexpr int DW_SMEM_MAX = 232448;
constexpr int DW_ALIGN = 1024;            // stage alignment (swizzle, TMA)

// dy's channels per swizzled group: 32 (64-byte swizzle) or 16 (32-byte)
__host__ __device__ constexpr int dw_dy_group(int cout) {
  return cout % 32 == 0 ? 32 : 16;
}

__host__ __device__ constexpr int dww_x_bytes(int cin) {
  return (DWW_TH + 2) * DWW_TW * cin * 2;  // a multiple of 1024 (Cin % 16)
}

// m64 slabs of the folded M, 3 Cin rows
__host__ __device__ constexpr int dww_slabs(int cin) {
  return (3 * cin + 63) / 64;
}

template <int N>
struct DwWide {
  static constexpr int S = N > 96 ? 2 : 4;              // slabs per group
  static constexpr int E = dw_dy_group(N);
  static constexpr int DY = DWW_TH * DWW_TW * N * 2;    // dy bytes per stage
  static constexpr int MAX_STAGES = 4;
  static_assert(DY % DW_ALIGN == 0, "stages stay 1024-byte aligned");
  static int stages(int cin) {
    const int st = (DW_SMEM_MAX - DW_ALIGN - 2 * MAX_STAGES * 8) /
                   (dww_x_bytes(cin) + DY);
    return st < MAX_STAGES ? st : MAX_STAGES;
  }
  static int smem(int cin) {
    return DW_ALIGN + stages(cin) * (dww_x_bytes(cin) + DY) +
           2 * MAX_STAGES * 8;
  }
};

// The dynamic shared memory rounded up to DW_ALIGN (its base is only
// guaranteed 16-byte aligned).
__device__ __forceinline__ uint8_t* dw_smem_base(uint8_t* smem) {
  const uint32_t a = hopper::smem_u32(smem);
  return smem + ((DW_ALIGN - a % DW_ALIGN) % DW_ALIGN);
}

// p[0..1] = (first ? 0 : p[0..1]) + (d0, d1)
__device__ __forceinline__ void dw_add(float* p, float d0, float d1,
                                       bool first) {
  float2 v = first ? make_float2(0.f, 0.f)
                   : *reinterpret_cast<const float2*>(p);
  v.x += d0;
  v.y += d1;
  *reinterpret_cast<float2*>(p) = v;
}

template <int N>
__global__ void __launch_bounds__(TILE_THREADS, 1)
dw_wide(const __grid_constant__ CUtensorMap xmap,
        const __grid_constant__ CUtensorMap dymap, float* __restrict__ part,
        int Cin, int stages, int kinds, int h_tiles, int w_tiles, int tiles,
        int splits) {
  using C = DwWide<N>;
  constexpr int S = C::S, E = C::E;
  constexpr int GS = DWW_TW * 32;  // bytes per x channel group
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = dw_smem_base(smem_raw);
  const int xbytes = dww_x_bytes(Cin), stage_bytes = xbytes + C::DY;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  uint64_t* empty = full + C::MAX_STAGES;

  const int split = blockIdx.x / kinds, kind = blockIdx.x % kinds;
  const int kw = kind % 3, sg = kind / 3;
  const int G = Cin / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4;  // warpgroup
  const int first = sg * 2 * S + g * S;
  const int slabs = dww_slabs(Cin);
  const int t_begin = (int)((long long)tiles * split / splits);
  const int n = (int)((long long)tiles * (split + 1) / splits) - t_begin;

  auto load = [&](int i) {
    const int t = t_begin + i;
    const int w0 = t % w_tiles * DWW_TW, r = t / w_tiles;
    const int h0 = r % h_tiles * DWW_TH, bd = r / h_tiles;
    const int s = i % stages;
    uint8_t* st = smem + s * stage_bytes;
    hopper::mbar_expect_tx(&full[s], stage_bytes);
    hopper::tma_load_5d(st, &xmap, &full[s], 0, w0 + kw - 1, 0, h0 - 1, bd);
    hopper::tma_load_5d(st + xbytes, &dymap, &full[s], 0, w0, 0, h0, bd);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], TILE_THREADS / 32);  // one per warp
    }
    hopper::mbar_init_fence();
    for (int i = 0; i < min(n, stages); ++i) load(i);
  }
  __syncthreads();

  float acc[S][N / 2] = {};
  // D fragment: row m = 64 slab + 16 (warp % 4) + lane / 4 (+ 8) is (kh,
  // ci) = (m / Cin, m % Cin); columns 8 q + 2 (lane % 4) + {0, 1}. The
  // slices are written by the first flush and added to by the later ones.
  float* pb = part + (size_t)split * 9 * Cin * N;
  auto flush = [&](bool first_flush) {
#pragma unroll
    for (int j = 0; j < S; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m =
            64 * (first + j) + 16 * (warp % 4) + lane / 4 + 8 * half;
        if (first + j >= slabs || m >= 3 * Cin) continue;
        float* row = pb + ((size_t)((m / Cin) * 3 + kw) * Cin + m % Cin) * N;
#pragma unroll
        for (int q = 0; q < N / 8; ++q)
          dw_add(row + 8 * q + 2 * (lane % 4), acc[j][4 * q + 2 * half],
                 acc[j][4 * q + 2 * half + 1], first_flush);
      }
  };

  // the tiles in runs of DW_FLUSH, the accumulators flushed after each run;
  // a run's first products overwrite them (scale-d 0): writing registers
  // that wgmma owns, even zeros, makes ptxas drain its pipeline
  for (int i0 = 0; i0 < n; i0 += DW_FLUSH) {
    for (int i = i0; i < min(n, i0 + DW_FLUSH); ++i) {
      const int s = i % stages;
      hopper::mbar_wait(&full[s], (i / stages) & 1);
      const uint32_t xs = hopper::smem_u32(smem + s * stage_bytes);
      const uint32_t ds = xs + xbytes;
#pragma unroll
      for (int j = 0; j < S; ++j) hopper::fence_regs(acc[j]);
      hopper::wgmma_fence();
#pragma unroll
      for (int r = 0; r < DWW_TH; ++r) {
        const uint64_t bdesc = hopper::desc_mn(
            ds + r * DWW_TW * N * 2, 16 * E, DWW_TW * 2 * E, 2 * E);
        // every slot issues its product (a warpgroup with fewer than S
        // slabs repeats its last one and flush drops the result): a wgmma
        // on a branch is serialized
#pragma unroll
        for (int j = 0; j < S; ++j)
          hopper::wgmma_ss<N, 1, 1>(
              acc[j],
              hopper::desc_mn(
                  xs + (r * G + 4 * min(first + j, slabs - 1)) * GS, 256, GS,
                  32),
              bdesc, r > 0 || i > i0);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int j = 0; j < S; ++j) hopper::fence_regs(acc[j]);
      hopper::wgmma_wait<1>();  // tile i - 1's products have retired
      if (i > 0) {
        const int done = i - 1, s_done = done % stages;
        if (lane == 0) hopper::mbar_arrive(&empty[s_done]);
        if (threadIdx.x == 0 && done + stages < n) {
          hopper::mbar_wait(&empty[s_done], (done / stages) & 1);
          load(done + stages);
        }
        __syncwarp();  // wgmma is warp-aligned: lane 0 rejoins its warp
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < S; ++j) hopper::fence_regs(acc[j]);
    flush(i0 == 0);
  }
}

constexpr int DWF2_TH = 2;                    // dy rows per tile
constexpr int DWF2_TW = 128;                  // dy columns per tile
constexpr int DWF2_RW = DWF2_TW + 16;         // raw x row columns
constexpr int DWF2_XB = 7168;  // raw x bytes per stage (6,912 at Cin = 6)
static_assert((DWF2_TH + 2) * DWF2_RW * 6 * 2 <= DWF2_XB, "x fits");

template <int N>
struct DwFold {
  static constexpr int DY = DWF2_TH * DWF2_TW * N * 2;
  static constexpr int STAGE = DWF2_XB + DY;
  static constexpr int STAGES0 = (DW_SMEM_MAX - DW_ALIGN - 64) / STAGE;
  static constexpr int STAGES = STAGES0 < 4 ? STAGES0 : 4;
  static constexpr int SMEM = DW_ALIGN + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(STAGES >= 2, "a ring of two stages fits");
  static_assert(STAGE % DW_ALIGN == 0 && DWF2_XB % DW_ALIGN == 0,
                "the boxes land 1024-byte aligned");
};

template <int N>
__global__ void __launch_bounds__(TILE_THREADS, 1)
dw_fold(const __grid_constant__ CUtensorMap xmap,
        const __grid_constant__ CUtensorMap dymap, float* __restrict__ part,
        int Cin, int h_tiles, int w_tiles, long long tiles) {
  using C = DwFold<N>;
  constexpr int E = dw_dy_group(N), GS = DWF2_TW * 2 * E;  // dy group bytes
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = dw_smem_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / 4;  // warpgroup: dy row g of each tile
  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const int n = (int)(tiles * (blockIdx.x + 1) / gridDim.x - t_begin);
  const int xbytes = (DWF2_TH + 2) * DWF2_RW * Cin * 2;

  auto load = [&](int i) {
    const long long t = t_begin + i;
    const int w0 = (int)(t % w_tiles) * DWF2_TW;
    const long long r = t / w_tiles;
    const int h0 = (int)(r % h_tiles) * DWF2_TH, bd = (int)(r / h_tiles);
    const int s = i % C::STAGES;
    uint8_t* st = smem + s * C::STAGE;
    hopper::mbar_expect_tx(&full[s], xbytes + C::DY);
    hopper::tma_load_4d(st, &xmap, &full[s], 0, (w0 - 8) * Cin / 8, h0 - 1,
                        bd);
    hopper::tma_load_5d(st + DWF2_XB, &dymap, &full[s], 0, w0, 0, h0, bd);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], TILE_THREADS / 32);
    }
    hopper::mbar_init_fence();
    for (int i = 0; i < min(n, C::STAGES); ++i) load(i);
  }
  __syncthreads();

  // this thread's A rows m = 16 (warp % 4) + lane / 4 (+ 8) = tap * Cin +
  // ci, as element offsets into the raw rows of a stage (pixel k = 2 (lane
  // % 4) of the k step); -1 past 9 Cin
  int base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 16 * (warp % 4) + lane / 4 + 8 * h;
    const int tap = m / Cin, ci = m % Cin;
    base[h] = m < 9 * Cin ? (((tap / 3 + g) * DWF2_RW + tap % 3 + 7 +
                              2 * (lane % 4)) * Cin + ci)
                          : -1;
  }

  float acc[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;

  // row m = tap * Cin + ci is dw's row (tap, ci): part[2 block + g][m][co]
  float* pb = part + (size_t)(2 * blockIdx.x + g) * 9 * Cin * N;
  bool flushed = false;
  auto flush = [&]() {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = 16 * (warp % 4) + lane / 4 + 8 * half;
      if (m >= 9 * Cin) continue;
#pragma unroll
      for (int q = 0; q < N / 8; ++q) {
        dw_add(pb + (size_t)m * N + 8 * q + 2 * (lane % 4),
               acc[4 * q + 2 * half], acc[4 * q + 2 * half + 1], !flushed);
        acc[4 * q + 2 * half] = 0.f;
        acc[4 * q + 2 * half + 1] = 0.f;
      }
    }
    flushed = true;
  };

  for (int i = 0; i < n; ++i) {
    const int s = i % C::STAGES;
    hopper::mbar_wait(&full[s], (i / C::STAGES) & 1);
    const uint16_t* raw =
        reinterpret_cast<const uint16_t*>(smem + s * C::STAGE);
    const uint32_t ds = hopper::smem_u32(smem + s * C::STAGE + DWF2_XB);
    uint32_t a[DWF2_TW / 16][4];
#pragma unroll
    for (int ks = 0; ks < DWF2_TW / 16; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // (row + 8 (q % 2), pixel + 8 (q / 2))
        const int b = base[q % 2];
        const int o = b + (16 * ks + 8 * (q / 2)) * Cin;
        a[ks][q] = b < 0 ? 0u
                         : (uint32_t)raw[o] | ((uint32_t)raw[o + Cin] << 16);
      }
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DWF2_TW / 16; ++ks)
      hopper::wgmma_rs<N, 1>(
          acc, a[ks],
          hopper::desc_mn(ds + g * DWF2_TW * N * 2 + ks * 32 * E, 16 * E, GS,
                          2 * E));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();  // A's registers are free again
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && i + C::STAGES < n) {
      hopper::mbar_wait(&empty[s], (i / C::STAGES) & 1);
      load(i + C::STAGES);
    }
    __syncwarp();
    if ((i + 1) % DW_FLUSH == 0 && i + 1 < n) flush();
  }
  flush();
}

// One m64n96k16 product of MN-major operands, for pinning the descriptor
// conventions on the card: a [16 k][64 m] and b [16 k][96 n] (bf16,
// row-major) -> d [64][96] f32 = a^T b. Each operand is staged in swizzle
// ``swa`` / ``swb`` (0, 32 or 64 bytes) as blocks of
// 8 K rows x E elements (E = 8 without swizzle, sw / 2 with), blocks
// adjacent in K 16 E bytes apart and in M (N) 32 E apart; desc_mn gets
// those two offsets, or, with ``swap``, each in the other's place. ``rs``
// takes A from registers (wgmma RS, transposed B), else both by descriptor
// (SS, transposed A and B).
__global__ void __launch_bounds__(128)
debug_wgmma_mn(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
               float* __restrict__ d, int swa, int swb, int swap, int rs) {
  __shared__ __align__(1024) uint16_t as[8 * 128];
  __shared__ __align__(1024) uint16_t bs[12 * 128];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  auto at = [](int mn, int k, int sw) {
    const int e = sw ? sw / 2 : 8;
    const int off = (mn / e) * 32 * e + (k / 8) * 16 * e + (k % 8) * 2 * e +
                    (mn % e) * 2;
    const int mask = sw ? (sw / 16 - 1) << 4 : 0;
    return (off ^ ((off >> 3) & mask)) / 2;
  };
  for (int i = t; i < 16 * 64; i += 128) as[at(i % 64, i / 64, swa)] = a[i];
  for (int i = t; i < 16 * 96; i += 128) bs[at(i % 96, i / 96, swb)] = b[i];
  hopper::fence_async_smem();
  __syncthreads();
  float acc[48];
#pragma unroll
  for (int e = 0; e < 48; ++e) acc[e] = 0.f;
  auto dsc = [&](const void* p, int sw) {
    const uint32_t e = sw ? sw / 2 : 8, k_off = 16 * e, mn_off = 32 * e;
    return swap ? hopper::desc_mn(hopper::smem_u32(p), mn_off, k_off, sw)
                : hopper::desc_mn(hopper::smem_u32(p), k_off, mn_off, sw);
  };
  const uint64_t bdesc = dsc(bs, swb);
  uint32_t ar[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = 16 * warp + lane / 4 + 8 * (q % 2);
    const int k = 2 * (lane % 4) + 8 * (q / 2);
    ar[q] = (uint32_t)a[k * 64 + m] | ((uint32_t)a[(k + 1) * 64 + m] << 16);
  }
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
  if (rs)
    hopper::wgmma_rs<96, 1>(acc, ar, bdesc);
  else
    hopper::wgmma_ss<96, 1, 1>(acc, dsc(as, swa), bdesc);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int q = 0; q < 12; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        d[(16 * warp + lane / 4 + 8 * half) * 96 + 8 * q + 2 * (lane % 4) +
          e] = acc[4 * q + 2 * half + e];
}

// dw[i] = sum over splits of part[split][i], in split order
__global__ void dw_reduce(const float* __restrict__ part,
                          float* __restrict__ dw, int splits, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
  dw[i] = s;
}

// The dw kernels by variant, as the wrapper names them.
enum DwVariant { DW_GENERIC = 0, DW_WIDE = 1, DW_FOLD = 2, DW_FMA = 3 };

struct DwGrid {
  int c_chunks, n_tiles, kinds, blocks, splits;
  long long tiles;
  int h_tiles, w_tiles;
};

// The three output widths the wgmma paths are built for.
#define DISPATCH_COUT(COUT, CALL) \
  switch (COUT) {                 \
    case 64: {                    \
      constexpr int N = 64;       \
      return (int)CALL;           \
    }                             \
    case 96: {                    \
      constexpr int N = 96;       \
      return (int)CALL;           \
    }                             \
    case 144: {                   \
      constexpr int N = 144;      \
      return (int)CALL;           \
    }                             \
    default:                      \
      return (int)cudaErrorInvalidValue; \
  }

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    return 132;
  return sms;
}

// The slab slots of one dw_wide<Cout> warpgroup, DwWide<N>::S (for a Cout
// with no instance the launch refuses the shape).
int dww_group_slots(int cout) {
  DISPATCH_COUT(cout, DwWide<N>::S)
}

// generic / fma: (ci chunk, n tile, split) blocks, enough to fill the SMs
// 8 times over; wide: splits x 3 kw x slab groups blocks, one wave; fold:
// one block per SM, two partials (warpgroups) each.
DwGrid dw_grid(int BD, int H, int W, int Cin, int Cout, int variant) {
  DwGrid g{};
  if (variant == DW_WIDE || variant == DW_FOLD) {
    const int th = variant == DW_WIDE ? DWW_TH : DWF2_TH;
    const int tw = variant == DW_WIDE ? DWW_TW : DWF2_TW;
    g.h_tiles = (H + th - 1) / th;
    g.w_tiles = (W + tw - 1) / tw;
    g.tiles = (long long)BD * g.h_tiles * g.w_tiles;
    const long long sms = sm_count();
    if (variant == DW_WIDE) {
      const int per_block = 2 * dww_group_slots(Cout);  // two warpgroups
      g.kinds = 3 * ((dww_slabs(Cin) + per_block - 1) / per_block);
      long long s = sms / g.kinds;
      if (s > g.tiles) s = g.tiles;
      g.splits = (int)(s < 1 ? 1 : s);
      g.blocks = g.splits * g.kinds;
    } else {
      g.blocks = (int)(g.tiles < sms ? g.tiles : sms);
      g.splits = 2 * g.blocks;
    }
    return g;
  }
  const bool bf16 = variant == DW_GENERIC;
  const int th = bf16 ? DW_TH : DWF_TH, tw = bf16 ? DW_TW : DWF_TW;
  const int ck = bf16 ? DW_CK : DWF_CK, tn = bf16 ? DW_TN : DWF_TC;
  g.c_chunks = (Cin + ck - 1) / ck;
  g.n_tiles = (Cout + tn - 1) / tn;
  const long long tiles =
      (long long)BD * ((H + th - 1) / th) * ((W + tw - 1) / tw);
  const int per_split = g.c_chunks * g.n_tiles;
  long long s = (DW_TARGET_BLOCKS + per_split - 1) / per_split;
  if (s > tiles) s = tiles;
  g.splits = (int)(s < 1 ? 1 : s);
  g.blocks = per_split * g.splits;
  return g;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int N>
cudaError_t launch_wide(const void* x, const void* wk, void* y, int BD, int H,
                        int W, int Cin, cudaStream_t s) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // x as [BD][H][W][Cin / 8][8]; the box is one 8-channel group of the
  // (T_H + 2) x (T_W + 2) patch
  CUtensorMap map;
  const cuuint64_t dims[5] = {8, (cuuint64_t)Cin / 8, (cuuint64_t)W,
                              (cuuint64_t)H, (cuuint64_t)BD};
  const cuuint64_t strides[4] = {16, (cuuint64_t)Cin * 2,
                                 (cuuint64_t)W * Cin * 2,
                                 (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t box[5] = {8, 1, Wide<N>::PW, T_H + 2, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_wide<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Wide<N>::SMEM);
  if (err != cudaSuccess) return err;
  const int w_tiles = (W + T_W - 1) / T_W;
  const dim3 grid((unsigned)BD * w_tiles, (H + T_H - 1) / T_H);
  conv_wide<N><<<grid, TILE_THREADS, Wide<N>::SMEM, s>>>(
      map, static_cast<const uint16_t*>(wk), static_cast<__nv_bfloat16*>(y),
      H, W, (Cin + 15) / 16, w_tiles);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_fold(const void* x, const void* wf, void* y, int BD, int H,
                        int W, int Cin, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_fold<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Fold<N>::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, conv_fold<N>, TILE_THREADS, Fold<N>::SMEM)) != cudaSuccess)
    return err;
  const long long tiles = (long long)BD * ((H + T_H - 1) / T_H) *
                          ((W + T_W - 1) / T_W);
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  conv_fold<N><<<(unsigned)(tiles < most ? tiles : most), TILE_THREADS,
                 Fold<N>::SMEM, s>>>(static_cast<const uint16_t*>(x),
                                     static_cast<const uint16_t*>(wf),
                                     static_cast<__nv_bfloat16*>(y), BD, H, W,
                                     Cin);
  return cudaGetLastError();
}

// A tensor map over t [BD, H, W, C] (bf16) ordered (e, W, C / e, H, BD): a
// box {e, box_w, C / e, box_h, 1} lands as [row][channel group][pixel][e]
// in the swizzle of 2 e bytes (e = 16 or 32), the MN-major layout of the
// dw kernels (hopper::desc_mn).
bool encode_group_map(CUtensorMap* map, const void* t, int BD, int H, int W,
                      int C, int e, int box_w, int box_h) {
  const int groups = C / e;
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)e, (cuuint64_t)W,
                              (cuuint64_t)groups, (cuuint64_t)H,
                              (cuuint64_t)BD};
  const cuuint64_t strides[4] = {(cuuint64_t)C * 2, (cuuint64_t)e * 2,
                                 (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[5] = {(cuuint32_t)e, (cuuint32_t)box_w,
                             (cuuint32_t)groups, (cuuint32_t)box_h, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      e == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                const_cast<void*>(t), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
cudaError_t launch_dw_wide(const void* x, const void* dy, float* part,
                           int BD, int H, int W, int Cin, const DwGrid& g,
                           cudaStream_t s) {
  CUtensorMap xmap, dymap;
  const int E = DwWide<N>::E;
  if (!encode_group_map(&xmap, x, BD, H, W, Cin, 16, DWW_TW, DWW_TH + 2) ||
      !encode_group_map(&dymap, dy, BD, H, W, N, E, DWW_TW, DWW_TH))
    return cudaErrorInvalidValue;
  const int stages = DwWide<N>::stages(Cin), smem = DwWide<N>::smem(Cin);
  if (stages < 2) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dw_wide<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (g.tiles > INT32_MAX) return cudaErrorInvalidValue;
  dw_wide<N><<<g.blocks, TILE_THREADS, smem, s>>>(
      xmap, dymap, part, Cin, stages, g.kinds, g.h_tiles, g.w_tiles,
      (int)g.tiles, g.splits);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_dw_fold(const void* x, const void* dy, float* part,
                           int BD, int H, int W, int Cin, const DwGrid& g,
                           cudaStream_t s) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // x as [BD][H][W * Cin / 8][8]: a box is DWF2_TH + 2 raw rows of DWF2_RW
  // pixels (16-byte runs, since W * Cin % 8 == 0)
  CUtensorMap xmap, dymap;
  const cuuint64_t dims[4] = {8, (cuuint64_t)W * Cin / 8, (cuuint64_t)H,
                              (cuuint64_t)BD};
  const cuuint64_t strides[3] = {16, (cuuint64_t)W * Cin * 2,
                                 (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t box[4] = {8, (cuuint32_t)(DWF2_RW * Cin / 8),
                             DWF2_TH + 2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      !encode_group_map(&dymap, dy, BD, H, W, N, dw_dy_group(N), DWF2_TW,
                        DWF2_TH))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dw_fold<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DwFold<N>::SMEM);
  if (err != cudaSuccess) return err;
  dw_fold<N><<<g.blocks, TILE_THREADS, DwFold<N>::SMEM, s>>>(
      xmap, dymap, part, Cin, g.h_tiles, g.w_tiles, g.tiles);
  return cudaGetLastError();
}

template <typename Kernel>
int attrs(Kernel kernel, int dynamic, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = dynamic;
  return (int)err;
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

// Wide path: x bf16 [BD, H, W, Cin] with Cin % 8 == 0, 16-byte aligned; wk
// the band re-laid out by the wrapper as [ceil(Cin / 16)][9][2][Cout][8]
// (zero past Cin); Cout 64, 96 or 144.
extern "C" int packed_conv_fwd_wide(const void* x, const void* wk, void* y,
                                    int BD, int H, int W, int Cin, int Cout,
                                    void* stream) {
  if (Cin % 8 != 0 || !aligned16(x) || !aligned16(wk) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  DISPATCH_COUT(Cout, launch_wide<N>(x, wk, y, BD, H, W, Cin,
                                     (cudaStream_t)stream))
}

// Folded-tap path: x bf16 [BD, H, W, Cin] with Cin 2, 4 or 6, W * Cin % 8 ==
// 0, 16-byte aligned; wf the folded band [64 / 8][Cout][8] (K = tap * Cin +
// ci, zero past 9 Cin); Cout 64, 96 or 144.
extern "C" int packed_conv_fwd_fold(const void* x, const void* wf, void* y,
                                    int BD, int H, int W, int Cin, int Cout,
                                    void* stream) {
  if (Cin < 2 || Cin > 6 || Cin % 2 != 0 || (long long)W * Cin % 8 != 0 ||
      !aligned16(x) || !aligned16(wf) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  DISPATCH_COUT(Cout, launch_fold<N>(x, wf, y, BD, H, W, Cin,
                                     (cudaStream_t)stream))
}

// Registers, static shared memory, local (spill) bytes and dynamic shared
// memory of one band-conv kernel: ``which`` 0 = conv_mma (generic), 1 =
// conv_wide<cout>, 2 = conv_fold<cout>, 3 = dw_mma, 4 = dw_wide<cout> (its
// dynamic shared memory at ``cin``), 5 = dw_fold<cout>. Writes 4 ints to
// ``out``.
extern "C" int packed_conv_kernel_attrs(int which, int cout, int cin,
                                        int* out) {
  switch (which) {
    case 0:
      return attrs(conv_mma, 0, out);
    case 1:
      DISPATCH_COUT(cout, attrs(conv_wide<N>, Wide<N>::SMEM, out))
    case 2:
      DISPATCH_COUT(cout, attrs(conv_fold<N>, Fold<N>::SMEM, out))
    case 3:
      return attrs(dw_mma, 0, out);
    case 4:
      DISPATCH_COUT(cout, attrs(dw_wide<N>, DwWide<N>::smem(cin), out))
    case 5:
      DISPATCH_COUT(cout, attrs(dw_fold<N>, DwFold<N>::SMEM, out))
    default:
      return (int)cudaErrorInvalidValue;
  }
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

// 1 where dw_wide<Cout> takes Cin: Cin % 16 == 0, Cout 64, 96 or 144, and
// two stages of its ring fit in shared memory (the rule its launch holds
// to); else 0.
extern "C" int packed_conv_dw_wide_fits(int cin, int cout) {
  if (cin < 16 || cin % 16 != 0 ||
      (cout != 64 && cout != 96 && cout != 144))
    return 0;
  DISPATCH_COUT(cout, (DwWide<N>::stages(cin) >= 2))
}

// Number of partial sums the dw of this shape splits its pixels into, for
// ``variant`` 0 = generic (dw_mma), 1 = wide, 2 = fold, 3 = f32 (dw_fma);
// the caller allocates ``part`` as f32 [splits, 3, 3, Cin, Cout].
extern "C" int packed_conv_dw_splits(int BD, int H, int W, int Cin, int Cout,
                                     int variant) {
  return dw_grid(BD, H, W, Cin, Cout, variant).splits;
}

// Each launches the first kernel of one variant (the partials).
int dw_partials(const void* x, const void* dy, float* part, int BD, int H,
                int W, int Cin, int Cout, const DwGrid& g, cudaStream_t s,
                int variant) {
  switch (variant) {
    case DW_WIDE:
      DISPATCH_COUT(Cout, launch_dw_wide<N>(x, dy, part, BD, H, W, Cin, g, s))
    case DW_FOLD:
      DISPATCH_COUT(Cout, launch_dw_fold<N>(x, dy, part, BD, H, W, Cin, g, s))
    case DW_GENERIC:
      dw_mma<<<g.blocks, DW_THREADS, 0, s>>>(
          static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy),
          part, BD, H, W, Cin, Cout, g.c_chunks, g.n_tiles, g.splits,
          Cin % 8 == 0 && aligned16(x), Cout % 8 == 0 && aligned16(dy));
      return (int)cudaGetLastError();
    default:
      dw_fma<<<g.blocks, DWF_THREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(dy), part,
          BD, H, W, Cin, Cout, g.c_chunks, g.n_tiles, g.splits);
      return (int)cudaGetLastError();
  }
}

// dw f32 [3, 3, Cin, Cout] of x [BD, H, W, Cin] and dy [BD, H, W, Cout]
// through the f32 scratch ``part``: the variant's partials, then dw_reduce.
static int dw_launch(const void* x, const void* dy, void* part, void* dw,
                     int BD, int H, int W, int Cin, int Cout, int splits,
                     void* stream, int variant) {
  const DwGrid g = dw_grid(BD, H, W, Cin, Cout, variant);
  if (g.splits != splits) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = dw_partials(x, dy, static_cast<float*>(part), BD, H, W,
                              Cin, Cout, g, s, variant);
  if (err != 0) return err;
  const int n = 9 * Cin * Cout;
  dw_reduce<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), splits, n);
  return (int)cudaGetLastError();
}

extern "C" int packed_conv_dw_bf16(const void* x, const void* dy, void* part,
                                   void* dw, int BD, int H, int W, int Cin,
                                   int Cout, int splits, void* stream) {
  return dw_launch(x, dy, part, dw, BD, H, W, Cin, Cout, splits, stream,
                   DW_GENERIC);
}

// Wide path: x bf16 [BD, H, W, Cin] with Cin % 16 == 0 and dy [BD, H, W,
// Cout] with Cout 64, 96 or 144, both 16-byte aligned.
extern "C" int packed_conv_dw_wide(const void* x, const void* dy, void* part,
                                   void* dw, int BD, int H, int W, int Cin,
                                   int Cout, int splits, void* stream) {
  if (Cin % 16 != 0 || !aligned16(x) || !aligned16(dy) || !aligned16(part))
    return (int)cudaErrorInvalidValue;
  return dw_launch(x, dy, part, dw, BD, H, W, Cin, Cout, splits, stream,
                   DW_WIDE);
}

// Folded-tap path: x bf16 [BD, H, W, Cin] with Cin 2, 4 or 6 and W * Cin %
// 8 == 0, dy as for the wide path.
extern "C" int packed_conv_dw_fold(const void* x, const void* dy, void* part,
                                   void* dw, int BD, int H, int W, int Cin,
                                   int Cout, int splits, void* stream) {
  if (Cin < 2 || Cin > 6 || Cin % 2 != 0 || (long long)W * Cin % 8 != 0 ||
      !aligned16(x) || !aligned16(dy) || !aligned16(part))
    return (int)cudaErrorInvalidValue;
  return dw_launch(x, dy, part, dw, BD, H, W, Cin, Cout, splits, stream,
                   DW_FOLD);
}

extern "C" int packed_conv_dw_f32(const void* x, const void* dy, void* part,
                                  void* dw, int BD, int H, int W, int Cin,
                                  int Cout, int splits, void* stream) {
  return dw_launch(x, dy, part, dw, BD, H, W, Cin, Cout, splits, stream,
                   DW_FMA);
}

// One MN-major wgmma tile (debug_wgmma_mn): a [16, 64] and b [16, 96] bf16,
// d [64, 96] f32.
extern "C" int packed_conv_debug_wgmma_mn(const void* a, const void* b,
                                          void* d, int swa, int swb,
                                          int swap, int rs, void* stream) {
  debug_wgmma_mn<<<1, 128, 0, (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
      static_cast<float*>(d), swa, swb, swap, rs);
  return (int)cudaGetLastError();
}
