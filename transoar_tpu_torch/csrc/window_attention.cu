// Fused window attention of the 3D Swin encoder, forward and backward, for
// Hopper (sm_90a).
//
// Replaces: transoar_tpu/ops/pallas/window_attention.py::_forward (the Pallas
// TPU kernel behind ``fused_window_attention``) and ::_bwd_rule (its custom
// VJP's backward kernel, ``_bwd_kernel``). Per window b and head h, with
// q (pre-scaled), k, v [B_, H, N, d], the learned bias [H, N, N] f32 and the
// shift-region labels region [nW, N] f32 (window b uses row b % nW):
//
//     S = q k^T + bias[h] + (-100 where region[b % nW] labels differ)
//     P = softmax(S) (rows),  o = P v                     (f32 inside)
//
// and the backward, recomputing P instead of saving it:
//
//     dv = P^T do,  dP = do v^T,  dS = P o (dP - rowsum(dP o P)),
//     dq = dS k,    dk = dS^T q,  dbias[h] = sum over every window of dS.
//
// What bounds it on the H100: at the SwinFPN's stage 2 (N = 125, d = 16)
// each window-head moves 4 x 125 x 16 bf16 values (8 KB with o) for 4 x 125
// x 125 x 16 x 2 = 2 MFLOP of products, ~250 FLOP per byte: under the
// card's ridge (~295 FLOP per byte in bf16), so it is bound by the bytes
// of q, k, v and o; the backward moves 7 such tensors. The [B_, H, N, N]
// score tensor (1.25 GB in f32 at stage 2, batch 1) and the [nW, N, N] mask
// never reach device memory: both live in registers, as on the TPU.
//
// What the design does about it: three bf16 kernels for each direction's one
// function, chosen by shape in the wrapper (ops/kernels/window_attention.py:
// _window_variant): ``wg`` (``fwd_wg`` / ``bwd_wg``: d = 16, N <= 128, every
// Swin launch of the SwinFPN), ``generic`` (``fwd_mma`` / ``bwd_mma``: every
// other bf16 shape) and ``fma`` (f32).
//
// wg, the Hopper design. At d = 16 the products are tiny (S is one k16
// step) and the work per score is elementwise: the exponential (the SFU's
// 16 a clock per SM) and ~6 f32 operations in the forward, ~15 in the
// backward, against 128 FP32 lanes; at stage 2 that floor is 0.15 ms forward
// and 0.28 ms backward, near the bytes bound (0.19 / 0.33 ms). What bounds
// the kernels as built, measured on an H100 (700 W) by timing copies of
// this file with one part removed (scripts/probe_window_kernels.py, stage
// 2): not that arithmetic, but the copies. The forward's copy skeleton
// (loads, bias, stores) takes 80-94% of its 0.51-0.65 ms, ~1.3 TB/s on rows
// of 32 bytes at a stride; a 2-stage ring is 10-16% slower than 3, and the
// exponentials cost 2-9%. The backward's skeleton takes 55-60% of its
// 1.26-1.46 ms; the exponentials, the mask and the hi / lo staging cost
// 3-10% each, the dv and dk products 6-12%: the rest is the serial chain
// of one window at a time per SM. Of the skeletons, the outputs' stores
// take ~0.1 ms (forward) and ~0.3 ms (backward): the memory system gives
// ~1.4-1.6 TB/s on 32-byte rows at a stride, loads and stores alike, and
// 16-byte stores after a quad shuffle were slower (1.57-1.62 ms backward).
// - Asynchronous copies: a ring of 3 stages, each one window's q, k, v (and
//   do) as four 4 KB TMA boxes ([128 tokens][16] bf16 in the 32-byte
//   swizzle: rows 125-127 come zero-filled, and the tensor maps carry the
//   views' real strides, so k and v are read in place from the qkv
//   projection's [B_, N, 3, H, d] output and q and do from [B_, N, H, d]
//   memory) plus the window's labels (one bulk copy of the wrapper's [nW,
//   128] padded rows), tracked by one mbarrier per stage. Thread 0 fills the
//   ring. In the forward it also refills: a stage one window after all
//   eight warps released it, so it never waits on a late warp. In the
//   backward the last warp to release a stage refills it at once (a counter
//   in shared memory), a window earlier: 3-7% off at stage 2; the forward
//   lost 8-26% that way, and spilled (the same probe script). Prefetching
//   the windows beyond the ring into L2 (cp.async.bulk.prefetch.tensor)
//   gained nothing in either. One thread, not a producer warp: in the band
//   conv's conv_wide a producer warp capped ptxas's registers and made it
//   spill.
// - A grid that fills the card: the host assigns each block one head and a
//   run of windows, sized so that heads x runs = the SMs x the blocks each
//   SM holds (``_wg_split`` in the wrapper): for the backward 132 blocks at
//   stages 2-4 and 120 at stage 5, for the forward (two a SM) 264, but 252
//   at stage 4. The head's f32 bias is staged once per block, in fragment
//   order (each thread's 64 entries as 16 float4s, conflict-free), with -inf
//   past N so that padded keys need no test.
// - Tensor cores through wgmma, two consumer warpgroups each taking 64 query
//   rows: S = q k^T (and dP = do v^T) on one m64n128k16 each, both operands
//   K-major from the TMA tiles. The d = 16 products run on wgmma m64n16k16
//   (``Wgmma<16>``): o = P v and dq = dS k take P and dS as A fragments from
//   the registers that computed them (RS); dv = P^T do and dk = dS^T q read
//   A MN-major from P and dS staged in shared memory as [key / 8][query][8].
//   mma.sync is the generic kernels' route for these: wgmma needs no
//   ldmatrix and no per-warp loop over n8 tiles; no measurement chose
//   between the two for these products alone (the kernels are timed whole:
//   ``ms`` against ``generic_ms`` in chip_smoke.py).
//   ``debug_wgmma_tile`` holds one tile of each form against a CPU product.
// - The backward computes dP once and turns it into dS in place, keeps the
//   f32 softmax, feeds dS to dq and dk as a bf16 hi + lo pair, and keeps the
//   dbias partial in registers (each thread owns the same 64 entries in
//   every window); the budget: S / P 64 + dP / dS 64 + dbias 64 f32 a
//   thread, then hi + lo 64 for dq's in-flight wgmmas once P has died.
//   Shared memory: bias 64 KB, ring 3 x 16.5 KB, P, hi and lo 3 x 32 KB =
//   210 KB, one block of 256 threads per SM. Partials are added by
//   ``dbias_reduce`` in block order: no atomics, the same bits every run.
// - The forward is the same pipeline without dP and dS (104 KB, two blocks
//   per SM); it normalises o, not P.
// Left for later work: the copies (a layout with each window-head's rows
// contiguous, which the strided views of the projection rule out; a TMA
// store epilogue); a second window in flight per SM in the backward, which
// its registers (246 a thread) do not allow yet.
//
// generic and f32, the first design:
// - One block takes one head and loops over a run of windows (the loop takes
//   the place of the TPU's sequential window grid axis). The head's f32 bias
//   (62.5 KB) is staged in shared memory once per block, not re-read per
//   window. N is padded to 128 with masked rows and columns; the -100 mask is
//   rebuilt from the region labels in shared memory.
// - bf16 (``fwd_mma`` / ``bwd_mma``): eight warps, each owning 16 query rows.
//   S = q k^T runs on mma.sync m16n8k16 (bf16 in, f32 accumulate); d = 16 is
//   one k step, smaller d is zero-padded. The row softmax stays in registers
//   (max and sum over the quad of lanes sharing a row), and its f32 C
//   fragments become the bf16 A fragments of P v with no trip through
//   shared memory. The backward keeps P in f32 registers, computes
//   rowsum(dP o P) exactly in f32 (dP tiles are recomputed rather than held),
//   forms dq in registers, and writes P and then dS to shared memory once
//   each, from where each warp computes dv = P^T do and dk = dS^T q for its
//   16 keys through ldmatrix.trans. dS enters both of its products as a bf16
//   hi + lo pair (two MMAs): rounded once to bf16, its rows sum with too much
//   cancellation for a bf16-accurate dq.
// - q, k, v, o (and do, dq, dk, dv) are addressed through element strides
//   (window, head, token) with the last axis contiguous, so the caller can
//   pass views of the qkv projection's [B_, N, 3, H, d] output and receive
//   [B_, N, H, d]-ordered outputs, with no copy on either side.
// - dbias is a sum over every window, and blocks run in parallel in no
//   order: each block sums its windows' dS in f32 registers (each lane owns
//   the same (row, column) entries in every window) and writes one partial;
//   ``dbias_reduce`` adds the partials in block order. No atomics: dbias is
//   the same bits on every run.
// - f32 (``fwd_fma`` / ``bwd_fma``): the same function on the CUDA cores, one
//   thread per query row (and, for dk, dv and dbias, one thread per key),
//   for checks against f32 references.
// Limits: N <= 128, d a multiple of 8 up to 64; wg d = 16.

#include <cuda.h>  // CUtensorMap and its enums (header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NP = 128;                  // tokens per window, padded
constexpr int NT = NP / 8;               // n8 key tiles
constexpr int MMA_WARPS = NP / 16;       // 16 query rows per warp
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int BSTRIDE = NP + 8;          // f32 bias rows: conflict-free float2
constexpr int PSTRIDE = NP + 8;          // bf16 P / dS rows: 272 bytes
constexpr int FWD_TARGET_BLOCKS = 132 * 8;
constexpr int BWD_TARGET_BLOCKS = 132 * 4;
constexpr float MASK = -100.f;

struct Str {
  long long b, h, n;  // element strides of window, head and token
};

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// f32 (a, b) -> hi, their bf16 pair, and lo, the bf16 pair of what hi
// misses: hi + lo carries about 16 mantissa bits into bf16 products
__device__ __forceinline__ void pack_split(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// bias[h] -> bs [NP][BSTRIDE], zeros outside N x N
__device__ void stage_bias(float* bs, const float* __restrict__ bias_h,
                           int N) {
  for (int i = threadIdx.x; i < NP * NP; i += blockDim.x) {
    const int r = i / NP, c = i % NP;
    bs[r * BSTRIDE + c] = (r < N && c < N) ? bias_h[r * N + c] : 0.f;
  }
}

// region labels of window b -> rs [NP] (zeros past N)
__device__ void stage_region(float* rs, const float* __restrict__ region,
                             int b, int N, int nW) {
  for (int i = threadIdx.x; i < NP; i += blockDim.x)
    rs[i] = i < N ? region[(size_t)(b % nW) * N + i] : 0.f;
}

// rows of (window b, head h) -> dst [NP][DP + 8] bf16, zeros past N rows and
// d columns; 16-byte loads (the wrapper guarantees 16-byte aligned rows)
template <int DP>
__device__ void stage_rows(uint16_t* dst, const uint16_t* __restrict__ src,
                           Str s, int b, int h, int N, int d) {
  constexpr int DS = DP + 8, CH = DP / 8;
  const uint16_t* base = src + b * s.b + h * s.h;
  for (int i = threadIdx.x; i < NP * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < N && 8 * c < d)
      v = *reinterpret_cast<const uint4*>(base + r * s.n + 8 * c);
    *reinterpret_cast<uint4*>(dst + r * DS + 8 * c) = v;
  }
}

// One warp's 16 query rows: S = q k^T + bias + mask, then the row softmax in
// place. C fragment: s[j][0..1] at (row0 + lane / 4, key 8j + 2 (lane % 4)
// + {0, 1}), s[j][2..3] at row + 8. Keys past N get probability 0, and so do
// the n8 tiles past ``nt``.
template <int DP>
__device__ __forceinline__ void probs(float (&s)[NT][4], const uint16_t* qs,
                                      const uint16_t* ks, const float* bs,
                                      const float* rs, int row0, int lane,
                                      int N, int nt) {
  constexpr int DS = DP + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    // A: 16 rows x 16 d; lane l addresses row l % 16, d half l / 16
    uint32_t a[4];
    ldsm_x4(a, qs + (row0 + lane % 16) * DS + 16 * kk + 8 * (lane / 16));
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      if (2 * jj < nt) {
        // B = k^T: two n8 key tiles; lane l addresses key l % 8 + 8 (l / 16)
        // and d half (l / 8) % 2 (k rows are B's columns: no transpose)
        uint32_t bf[4];
        ldsm_x4(bf, ks + (16 * jj + lane % 8 + 8 * (lane / 16)) * DS +
                        16 * kk + 8 * ((lane / 8) % 2));
        mma_bf16(s[2 * jj], a, bf[0], bf[1]);
        mma_bf16(s[2 * jj + 1], a, bf[2], bf[3]);
      }
    }
  }
  const int t = lane % 4;
  const int ra = row0 + lane / 4, rb = ra + 8;
  const float la = rs[ra], lb = rs[rb];
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const int c = 8 * j + 2 * t;
      const float2 ba = *reinterpret_cast<const float2*>(bs + ra * BSTRIDE + c);
      const float2 bb = *reinterpret_cast<const float2*>(bs + rb * BSTRIDE + c);
      const float l0 = rs[c], l1 = rs[c + 1];
      s[j][0] = c < N ? s[j][0] + ba.x + (la != l0 ? MASK : 0.f) : -INFINITY;
      s[j][1] = c + 1 < N ? s[j][1] + ba.y + (la != l1 ? MASK : 0.f)
                          : -INFINITY;
      s[j][2] = c < N ? s[j][2] + bb.x + (lb != l0 ? MASK : 0.f) : -INFINITY;
      s[j][3] = c + 1 < N ? s[j][3] + bb.y + (lb != l1 ? MASK : 0.f)
                          : -INFINITY;
      ma = fmaxf(ma, fmaxf(s[j][0], s[j][1]));
      mb = fmaxf(mb, fmaxf(s[j][2], s[j][3]));
    }
  }
  ma = quad_max(ma);  // key 0 is valid: the maxima are finite
  mb = quad_max(mb);
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      s[j][0] = __expf(s[j][0] - ma);
      s[j][1] = __expf(s[j][1] - ma);
      s[j][2] = __expf(s[j][2] - mb);
      s[j][3] = __expf(s[j][3] - mb);
      sa += s[j][0] + s[j][1];
      sb += s[j][2] + s[j][3];
    }
  }
  const float ia = 1.f / quad_sum(sa), ib = 1.f / quad_sum(sb);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] *= ia;
    s[j][1] *= ia;
    s[j][2] *= ib;
    s[j][3] *= ib;
  }
}

// acc[DP/8] (+)= X [16 rows x 16*ksteps] . Y, with X given as A fragments
// packed from f32 C fragments x[NT] (keys as the k axis) and Y [key][DP + 8]
// bf16 in shared memory (read with ldmatrix.trans: key rows are Y's k axis).
// SPLIT feeds X as bf16 hi + lo (two products) instead of one rounding.
template <int DP, bool SPLIT>
__device__ __forceinline__ void rows_times(float (&acc)[DP / 8][4],
                                           const float (&x)[NT][4],
                                           const uint16_t* ys, int lane,
                                           int nt) {
  constexpr int DS = DP + 8;
#pragma unroll
  for (int jj = 0; jj < NT / 2; ++jj) {
    if (2 * jj < nt) {
      uint32_t a[4], al[4];
      pack_split(x[2 * jj][0], x[2 * jj][1], a[0], al[0]);
      pack_split(x[2 * jj][2], x[2 * jj][3], a[1], al[1]);
      pack_split(x[2 * jj + 1][0], x[2 * jj + 1][1], a[2], al[2]);
      pack_split(x[2 * jj + 1][2], x[2 * jj + 1][3], a[3], al[3]);
#pragma unroll
      for (int nn = 0; nn < DP / 16; ++nn) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, ys + (16 * jj + lane % 8 + 8 * ((lane / 8) % 2)) *
                                   DS + 16 * nn + 8 * (lane / 16));
        mma_bf16(acc[2 * nn], a, bf[0], bf[1]);
        mma_bf16(acc[2 * nn + 1], a, bf[2], bf[3]);
        if (SPLIT) {
          mma_bf16(acc[2 * nn], al, bf[0], bf[1]);
          mma_bf16(acc[2 * nn + 1], al, bf[2], bf[3]);
        }
      }
    }
  }
}

// acc[DP/8] += X^T [16 columns c0.. of xs] . Y: xs [row][PSTRIDE] bf16 (P
// or dS), ys [row][DP + 8] bf16; the k axis is the query row (nt / 2 steps)
template <int DP>
__device__ __forceinline__ void cols_times(float (&acc)[DP / 8][4],
                                           const uint16_t* xs,
                                           const uint16_t* ys, int c0,
                                           int lane, int nt) {
  constexpr int DS = DP + 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (2 * kk < nt) {
      // A = X^T (16 columns x 16 rows) from row-major X: ldmatrix.trans,
      // lane l addresses row l % 8 + 8 (l / 16) and column half (l / 8) % 2
      uint32_t a[4];
      ldsm_x4_trans(a, xs + (16 * kk + lane % 8 + 8 * (lane / 16)) * PSTRIDE +
                           c0 + 8 * ((lane / 8) % 2));
#pragma unroll
      for (int nn = 0; nn < DP / 16; ++nn) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, ys + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) *
                                   DS + 16 * nn + 8 * (lane / 16));
        mma_bf16(acc[2 * nn], a, bf[0], bf[1]);
        mma_bf16(acc[2 * nn + 1], a, bf[2], bf[3]);
      }
    }
  }
}

template <int DP>
__device__ __forceinline__ void zero(float (&acc)[DP / 8][4]) {
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// C fragments acc[DP/8] of rows r0 + lane / 4 (+ 8) -> dst (bf16, columns
// < d, rows < N)
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, Str s,
                                           const float (&acc)[DP / 8][4],
                                           int b, int h, int r0, int lane,
                                           int N, int d) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + lane / 4 + 8 * half;
    if (r >= N) continue;
    __nv_bfloat16* row = dst + b * s.b + h * s.h + r * s.n;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + 2 * (lane % 4);
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(
            acc[i][2 * half], acc[i][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int DP>
constexpr int fwd_mma_smem() {
  return NP * BSTRIDE * 4 + 3 * NP * (DP + 8) * 2 + NP * 4;
}

template <int DP>
constexpr int bwd_mma_smem() {
  return NP * BSTRIDE * 4 + 4 * NP * (DP + 8) * 2 + 2 * NP * PSTRIDE * 2 +
         NP * 4;
}

template <int DP>
__global__ void __launch_bounds__(MMA_THREADS)
fwd_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
        const uint16_t* __restrict__ v, const float* __restrict__ bias,
        const float* __restrict__ region, __nv_bfloat16* __restrict__ o,
        Str sq, Str sk, Str sv, Str so, int B, int N, int d, int nW,
        int wpc) {
  constexpr int DS = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bs = reinterpret_cast<float*>(smem);
  uint16_t* qs = reinterpret_cast<uint16_t*>(bs + NP * BSTRIDE);
  uint16_t* ks = qs + NP * DS;
  uint16_t* vs = ks + NP * DS;
  float* rs = reinterpret_cast<float*>(vs + NP * DS);

  const int h = blockIdx.y;
  const int b_begin = blockIdx.x * wpc, b_end = min(B, b_begin + wpc);
  const int lane = threadIdx.x % 32;
  const int row0 = 16 * (threadIdx.x / 32);
  const int nt = 2 * ((N + 15) / 16);

  stage_bias(bs, bias + (size_t)h * N * N, N);
  for (int b = b_begin; b < b_end; ++b) {
    __syncthreads();  // the previous window's tiles are no longer read
    stage_rows<DP>(qs, q, sq, b, h, N, d);
    stage_rows<DP>(ks, k, sk, b, h, N, d);
    stage_rows<DP>(vs, v, sv, b, h, N, d);
    stage_region(rs, region, b, N, nW);
    __syncthreads();
    if (row0 >= N) continue;  // no barrier below in this iteration

    float p[NT][4];
    probs<DP>(p, qs, ks, bs, rs, row0, lane, N, nt);
    float acc[DP / 8][4];
    zero<DP>(acc);
    rows_times<DP, false>(acc, p, vs, lane, nt);
    store_rows<DP>(o, so, acc, b, h, row0, lane, N, d);
  }
}

template <int DP>
__global__ void __launch_bounds__(MMA_THREADS, 1)
bwd_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
        const uint16_t* __restrict__ v, const float* __restrict__ bias,
        const float* __restrict__ region, const uint16_t* __restrict__ dout,
        __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
        __nv_bfloat16* __restrict__ dv, float* __restrict__ part, Str sq,
        Str sk, Str sv, Str sdo, Str sdq, Str sdk, Str sdv, int B, int H,
        int N, int d, int nW, int wpc) {
  constexpr int DS = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bs = reinterpret_cast<float*>(smem);
  uint16_t* qs = reinterpret_cast<uint16_t*>(bs + NP * BSTRIDE);
  uint16_t* ks = qs + NP * DS;
  uint16_t* vs = ks + NP * DS;
  uint16_t* dos = vs + NP * DS;
  uint16_t* ps = dos + NP * DS;  // P, then dS's bf16 hi: [NP][PSTRIDE]
  uint16_t* pl = ps + NP * PSTRIDE;  // dS's bf16 lo
  float* rs = reinterpret_cast<float*>(pl + NP * PSTRIDE);

  const int h = blockIdx.y;
  const int b_begin = blockIdx.x * wpc, b_end = min(B, b_begin + wpc);
  const int lane = threadIdx.x % 32;
  const int row0 = 16 * (threadIdx.x / 32);  // query rows, and keys for dk/dv
  const int t = lane % 4;
  const int ra = row0 + lane / 4, rb = ra + 8;
  const int nt = 2 * ((N + 15) / 16);
  const bool active = row0 < N;

  float db[NT][4];  // this lane's entries of the block's dbias partial
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[j][e] = 0.f;

  stage_bias(bs, bias + (size_t)h * N * N, N);
  for (int b = b_begin; b < b_end; ++b) {
    __syncthreads();
    stage_rows<DP>(qs, q, sq, b, h, N, d);
    stage_rows<DP>(ks, k, sk, b, h, N, d);
    stage_rows<DP>(vs, v, sv, b, h, N, d);
    stage_rows<DP>(dos, dout, sdo, b, h, N, d);
    stage_region(rs, region, b, N, nW);
    __syncthreads();

    float p[NT][4];
    uint32_t ado[DP / 16][4];  // do as A fragments (16 rows x 16 d)
    float Da = 0.f, Db = 0.f;  // rowsum(dP o P) of rows ra, rb
    if (active) {
      probs<DP>(p, qs, ks, bs, rs, row0, lane, N, nt);
#pragma unroll
      for (int j = 0; j < NT; ++j) {  // padded rows take no part
        if (ra >= N) p[j][0] = p[j][1] = 0.f;
        if (rb >= N) p[j][2] = p[j][3] = 0.f;
        const int c = 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(ps + ra * PSTRIDE + c) =
            pack_bf16(p[j][0], p[j][1]);
        *reinterpret_cast<uint32_t*>(ps + rb * PSTRIDE + c) =
            pack_bf16(p[j][2], p[j][3]);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        ldsm_x4(ado[kk], dos + (row0 + lane % 16) * DS + 16 * kk +
                             8 * (lane / 16));
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        if (2 * jj < nt) {
          float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            uint32_t bf[4];
            ldsm_x4(bf, vs + (16 * jj + lane % 8 + 8 * (lane / 16)) * DS +
                            16 * kk + 8 * ((lane / 8) % 2));
            mma_bf16(dp[0], ado[kk], bf[0], bf[1]);
            mma_bf16(dp[1], ado[kk], bf[2], bf[3]);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            Da += p[2 * jj + u][0] * dp[u][0] + p[2 * jj + u][1] * dp[u][1];
            Db += p[2 * jj + u][2] * dp[u][2] + p[2 * jj + u][3] * dp[u][3];
          }
        }
      }
      Da = quad_sum(Da);
      Db = quad_sum(Db);
    }
    __syncthreads();  // ps holds P

    if (active) {  // dv for keys row0 .. row0 + 15: P^T do
      float acc[DP / 8][4];
      zero<DP>(acc);
      cols_times<DP>(acc, ps, dos, row0, lane, nt);
      store_rows<DP>(dv, sdv, acc, b, h, row0, lane, N, d);
    }
    __syncthreads();  // P is no longer read

    if (active) {  // dS; dq = dS k
      float ds[NT][4];
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        if (2 * jj < nt) {
          float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            uint32_t bf[4];
            ldsm_x4(bf, vs + (16 * jj + lane % 8 + 8 * (lane / 16)) * DS +
                            16 * kk + 8 * ((lane / 8) % 2));
            mma_bf16(dp[0], ado[kk], bf[0], bf[1]);
            mma_bf16(dp[1], ado[kk], bf[2], bf[3]);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = 2 * jj + u;
            ds[j][0] = p[j][0] * (dp[u][0] - Da);
            ds[j][1] = p[j][1] * (dp[u][1] - Da);
            ds[j][2] = p[j][2] * (dp[u][2] - Db);
            ds[j][3] = p[j][3] * (dp[u][3] - Db);
#pragma unroll
            for (int e = 0; e < 4; ++e) db[j][e] += ds[j][e];
            const int c = 8 * j + 2 * t;
            uint32_t hi, lo;
            pack_split(ds[j][0], ds[j][1], hi, lo);
            *reinterpret_cast<uint32_t*>(ps + ra * PSTRIDE + c) = hi;
            *reinterpret_cast<uint32_t*>(pl + ra * PSTRIDE + c) = lo;
            pack_split(ds[j][2], ds[j][3], hi, lo);
            *reinterpret_cast<uint32_t*>(ps + rb * PSTRIDE + c) = hi;
            *reinterpret_cast<uint32_t*>(pl + rb * PSTRIDE + c) = lo;
          }
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) ds[2 * jj + u][e] = 0.f;
        }
      }
      float acc[DP / 8][4];
      zero<DP>(acc);
      rows_times<DP, true>(acc, ds, ks, lane, nt);
      store_rows<DP>(dq, sdq, acc, b, h, row0, lane, N, d);
    }
    __syncthreads();  // ps, pl hold dS

    if (active) {  // dk for keys row0 .. row0 + 15: dS^T q (hi + lo)
      float acc[DP / 8][4];
      zero<DP>(acc);
      cols_times<DP>(acc, ps, qs, row0, lane, nt);
      cols_times<DP>(acc, pl, qs, row0, lane, nt);
      store_rows<DP>(dk, sdk, acc, b, h, row0, lane, N, d);
    }
  }

  if (!active) return;
  float* pb = part + ((size_t)blockIdx.x * H + h) * N * N;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? ra : rb, c = 8 * j + 2 * t + e % 2;
        if (r < N && c < N) pb[r * N + c] = db[j][e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, d = 16: wgmma fed by a TMA ring (fwd_wg / bwd_wg)
// ---------------------------------------------------------------------------

constexpr int WG_D = 16;                 // the head width these kernels take
constexpr int WG_THREADS = 256;          // two consumer warpgroups
constexpr int TILE = NP * WG_D * 2;      // one operand of one window: 4 KB
constexpr int LABELS = NP * 4;           // one window's region labels, f32
constexpr int BIAS_FRAG = NP * NP * 4;   // a head's bias, fragment-major f32
constexpr int STAGED = NP * NP * 2;      // P, dS hi or dS lo in bf16
constexpr int FWD_STAGES = 3, BWD_STAGES = 3;
constexpr float L2E = 1.4426950408889634f;

// Shared memory of a wg kernel: the bias, a ring of OPS tiles and the labels
// per stage, STAGING staged [NP, NP] bf16 matrices, then per stage an
// mbarrier for its loads and one (forward) or a counter (backward) for its
// release.
template <int OPS, int STAGES, int STAGING>
struct WgSmem {
  static constexpr int TILES = BIAS_FRAG;                  // [stage][op]
  static constexpr int LAB = TILES + STAGES * OPS * TILE;  // [stage][NP]
  static constexpr int STG = LAB + STAGES * LABELS;        // [staging]
  static constexpr int BARS = STG + STAGING * STAGED;  // full, release
  static constexpr int BYTES = BARS + 2 * STAGES * 8;
};
using FwdWg = WgSmem<3, FWD_STAGES, 0>;
using BwdWg = WgSmem<4, BWD_STAGES, 3>;
static_assert(2 * (FwdWg::BYTES + 1024) <= 233472, "two forward blocks");
static_assert(BwdWg::BYTES <= 232448, "fits the SM's shared memory");

// A tile as TMA writes it: [token][16] bf16, 32-byte rows in the 32-byte
// swizzle. Read K-major (K = d: q and k of S = q k^T, do and v of dP = do
// v^T) its 8-row atoms lie 256 bytes apart (LBO is unused); read MN-major
// (K = token: v, k, do, q as B of o, dq, dv, dk) a k16 step is 512 bytes
// and an 8-token atom 256 (one 16-wide block in N, so LBO is unused).
__device__ __forceinline__ uint64_t kdesc(uint32_t addr) {
  return hopper::desc(addr, 16, 256) | (3ull << 62);
}

__device__ __forceinline__ uint64_t mdesc(uint32_t addr) {
  return hopper::desc_mn(addr, 256, TILE, 32);
}

// A staged P or dS, [key / 8][query][8] bf16 (no swizzle), read MN-major as
// A = P^T (M = keys, K = queries): core matrices of 8 queries x 8 keys, 128
// bytes apart in K and 2048 in M.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr) {
  return hopper::desc_mn(addr, 128, NP * 16, 0);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__device__ __forceinline__ void fence_u32(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

__device__ __forceinline__ void st_u32(uint8_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// bias[h] -> bs as float4 [warpgroup][n8 tile j][thread t of the
// warpgroup]: the four entries thread t adds to its scores in tile j (rows
// ra, rb = 16 (t / 32) + t % 32 / 4 (+ 8) of the warpgroup's 64, keys 8 j +
// 2 (t % 4) + {0, 1}). Keys past N get -inf (probability 0), rows past N 0.
// Each thread reads its own 16 bytes: no bank conflicts.
__device__ void stage_bias_frag(float4* bs, const float* __restrict__ bias_h,
                                int N) {
  for (int i = threadIdx.x; i < 2 * 16 * 128; i += blockDim.x) {
    const int t = i % 128, j = (i / 128) % 16, g = i / 2048;
    const int ra = 64 * g + 16 * (t / 32) + (t % 32) / 4, rb = ra + 8;
    const int c = 8 * j + 2 * (t % 4);
    auto at = [&](int r, int cc) {
      return cc >= N ? -INFINITY : r < N ? bias_h[r * N + cc] : 0.f;
    };
    bs[i] = make_float4(at(ra, c), at(ra, c + 1), at(rb, c), at(rb, c + 1));
  }
}

// The coordinate at position ``pos`` (1-3) of a tensor map whose outer axes
// were sorted by stride: ``code`` holds 2 bits per position, 0 = token, 1 =
// head, 2 = window.
__device__ __forceinline__ int coord(int code, int pos, int h, int b) {
  const int which = (code >> (2 * (pos - 1))) & 3;
  return which == 1 ? h : which == 2 ? b : 0;
}

// Window b's OPS tiles (q, k, v and, for the backward, do) of head h by TMA,
// rows past N zero-filled, and its region labels (one bulk copy of a row of
// the [nW, NP] padded labels) into one stage; all complete on ``bar``.
template <int OPS>
__device__ __forceinline__ void wg_load(uint8_t* tiles, float* labels,
                                        uint64_t* bar, const CUtensorMap* m0,
                                        const CUtensorMap* m1,
                                        const CUtensorMap* m2,
                                        const CUtensorMap* m3, int codes,
                                        const float* __restrict__ region,
                                        int b, int h, int nW) {
  hopper::mbar_expect_tx(bar, OPS * TILE + LABELS);
  const CUtensorMap* maps[4] = {m0, m1, m2, m3};
#pragma unroll
  for (int op = 0; op < OPS; ++op) {
    const int code = codes >> (6 * op);
    hopper::tma_load_4d(tiles + op * TILE, maps[op], bar, 0,
                        coord(code, 1, h, b), coord(code, 2, h, b),
                        coord(code, 3, h, b));
  }
  hopper::bulk_load(labels, region + (size_t)(b % nW) * NP, LABELS, bar);
}

// S = q k^T (or dP = do v^T) for this warpgroup's 64 query rows: one
// m64n128k16 wgmma, both operands K-major.
__device__ __forceinline__ void scores(float (&sc)[64], uint32_t a,
                                       uint32_t b) {
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
  hopper::wgmma_ss<128>(sc, kdesc(a), kdesc(b), 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
}

// The row softmax of the score tile in place, unnormalised, in two passes.
// softmax_max adds the bias (fragment-major, -inf past N) and the -100 mask
// where the labels of row and key differ, and returns -max * log2(e) of the
// two rows. C fragment: sc[4 j + e] at row ra (e < 2) or rb, key 8 j + 2 (t
// % 4) + e % 2.
__device__ __forceinline__ void softmax_max(float (&sc)[64], const float4* bs,
                                            const float* lab, int g, int t,
                                            int ra, int rb, float& na,
                                            float& nb) {
  const float la = lab[ra], lb = lab[rb];
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float4 bv = bs[(16 * g + j) * 128 + t];
    const float2 lc =
        *reinterpret_cast<const float2*>(lab + 8 * j + 2 * (t % 4));
    sc[4 * j] += bv.x + (la != lc.x ? MASK : 0.f);
    sc[4 * j + 1] += bv.y + (la != lc.y ? MASK : 0.f);
    sc[4 * j + 2] += bv.z + (lb != lc.x ? MASK : 0.f);
    sc[4 * j + 3] += bv.w + (lb != lc.y ? MASK : 0.f);
    ma = fmaxf(ma, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mb = fmaxf(mb, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  na = -quad_max(ma) * L2E;  // key 0 is valid: the maxima are finite
  nb = -quad_max(mb) * L2E;
}

// softmax_exp: exp(s - row max) in place; returns the two rows' sums, and
// with PACK also P in bf16 as the A fragments of k16 step kk = keys 16 kk ..
// (pa[kk][0..3]: row ra, rb at keys + 0..7, then ra, rb at + 8..15).
template <bool PACK>
__device__ __forceinline__ void softmax_exp(float (&sc)[64], float na,
                                            float nb, float& sa, float& sb,
                                            uint32_t (&pa)[8][4]) {
  sa = 0.f;
  sb = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], L2E, na));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], L2E, na));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], L2E, nb));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], L2E, nb));
    sa += sc[4 * j] + sc[4 * j + 1];
    sb += sc[4 * j + 2] + sc[4 * j + 3];
    if (PACK) {  // the tile's bf16 A fragments, as soon as they exist
      pa[j / 2][2 * (j % 2)] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
  }
  sa = quad_sum(sa);
  sb = quad_sum(sb);
}

// An m64n16 accumulator (rows ra, rb; columns 8 j + c0 + {0, 1}) times
// (fa, fb) -> dst rows below N, bf16.
__device__ __forceinline__ void store16(__nv_bfloat16* __restrict__ dst,
                                        Str s, const float (&acc)[8], int b,
                                        int h, int ra, int rb, int c0, int N,
                                        float fa = 1.f, float fb = 1.f) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    const float f = half ? fb : fa;
    if (r >= N) continue;
    __nv_bfloat16* row = dst + b * s.b + h * s.h + r * s.n;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * f,
                                acc[4 * j + 2 * half + 1] * f);
  }
}

// Forward. One block = one head h and a run of ``wpb`` windows from b0 (the
// static assignment the host computes, sized to fill the card); the head's
// bias is staged once. Thread 0 also produces: it fills the ring and
// refills a stage one window after all eight warps released it. Warpgroup
// g takes query rows 64 g .. 64 g + 63: S on one m64n128k16 wgmma, the
// softmax in registers, o = P v on eight m64n16k16 wgmmas with P as the A
// fragments straight from the score registers, normalised at the store.
__global__ void __launch_bounds__(WG_THREADS, 2)
fwd_wg(const __grid_constant__ CUtensorMap qmap,
       const __grid_constant__ CUtensorMap kmap,
       const __grid_constant__ CUtensorMap vmap,
       const float* __restrict__ bias, const float* __restrict__ region,
       __nv_bfloat16* __restrict__ o, Str so, int codes, int B, int H, int N,
       int nW, int wpb) {
  using L = FwdWg;
  constexpr int S = FWD_STAGES;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  uint8_t* smem = wg_smem;
  float4* bs = reinterpret_cast<float4*>(smem);
  uint8_t* tiles = smem + L::TILES;
  float* labels = reinterpret_cast<float*>(smem + L::LAB);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + S;

  const int h = blockIdx.x % H, b0 = (blockIdx.x / H) * wpb;
  const int n = min(B - b0, wpb);
  const int t = threadIdx.x % 128, g = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int ra = 64 * g + 16 * (t / 32) + lane / 4, rb = ra + 8;
  const int c0 = 2 * (lane % 4);

  auto load = [&](int i) {
    const int s = i % S;
    wg_load<3>(tiles + s * 3 * TILE, labels + s * NP, &full[s], &qmap, &kmap,
               &vmap, &vmap, codes, region, b0 + i, h, nW);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], WG_THREADS / 32);  // one per warp
    }
    hopper::mbar_init_fence();
    for (int i = 0; i < min(n, S); ++i) load(i);
  }
  stage_bias_frag(bs, bias + (size_t)h * N * N, N);
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    const int s = i % S;
    hopper::mbar_wait(&full[s], (i / S) & 1);
    const uint32_t qs = hopper::smem_u32(tiles + s * 3 * TILE);
    const uint32_t ks = qs + TILE, vs = qs + 2 * TILE;

    float sc[64];
    scores(sc, qs + 64 * g * 32, ks);
    float na, nb, sa, sb;
    uint32_t pa[8][4];
    softmax_max(sc, bs, labels + s * NP, g, t, ra, rb, na, nb);
    softmax_exp<true>(sc, na, nb, sa, sb, pa);
    float acc[8];
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      hopper::wgmma_rs<16, 1>(acc, pa[kk], mdesc(vs + 512 * kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    fence_u32(pa);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // this window's tiles
    store16(o, so, acc, b0 + i, h, ra, rb, c0, N, 1.f / sa, 1.f / sb);
    if (threadIdx.x == 0 && i >= 1 && i - 1 + S < n) {
      hopper::mbar_wait(&empty[(i - 1) % S], ((i - 1) / S) & 1);
      load(i - 1 + S);
    }
    __syncwarp();  // wgmma is warp-aligned: lane 0 rejoins its warp
  }
}

// Backward, on the forward's ring and block assignment, with do as a
// fourth tile; the last warp to release a stage refills it. Per window,
// warpgroup g (query rows 64 g ..): S on one m64n128k16 wgmma; P
// recomputed in f32 registers (zero in rows past N); dP = do v^T on
// another; D = rowsum(P o dP); P staged in bf16; dS = P o (dP - D) in place
// of dP, added to this thread's entries of the block's dbias partial
// (registers: the same entries in every window) and split into bf16 hi +
// lo, which are staged and feed dq = dS k as register A fragments (sixteen
// m64n16k16). Both warpgroups' P, hi and lo staged (a
// barrier), warpgroup g takes keys 64 g ..: dv = P^T do and dk = dS^T q
// (hi, then lo) on wgmma with A read MN-major from the staging. A barrier
// before the next window's staging lets the other warpgroup's reads retire.
__global__ void __launch_bounds__(WG_THREADS, 1)
bwd_wg(const __grid_constant__ CUtensorMap qmap,
       const __grid_constant__ CUtensorMap kmap,
       const __grid_constant__ CUtensorMap vmap,
       const __grid_constant__ CUtensorMap dmap,
       const float* __restrict__ bias, const float* __restrict__ region,
       __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
       __nv_bfloat16* __restrict__ dv, float* __restrict__ part, Str sdq,
       Str sdk, Str sdv, int codes, int B, int H, int N, int nW, int wpb) {
  using L = BwdWg;
  constexpr int S = BWD_STAGES;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  uint8_t* smem = wg_smem;
  float4* bs = reinterpret_cast<float4*>(smem);
  uint8_t* tiles = smem + L::TILES;
  float* labels = reinterpret_cast<float*>(smem + L::LAB);
  uint8_t* stg = smem + L::STG;  // P, dS hi, dS lo
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);

  const int h = blockIdx.x % H, chunk = blockIdx.x / H, b0 = chunk * wpb;
  const int n = min(B - b0, wpb);
  const int t = threadIdx.x % 128, g = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int ra = 64 * g + 16 * (t / 32) + lane / 4, rb = ra + 8;
  const int c0 = 2 * (lane % 4);
  // this thread's staging word of rows ra (+ 8 rows: rb) in key group 0
  uint8_t* my_stg = stg + ra * 16 + 2 * c0;

  auto load = [&](int i) {
    const int s = i % S;
    wg_load<4>(tiles + s * 4 * TILE, labels + s * NP, &full[s], &qmap, &kmap,
               &vmap, &dmap, codes, region, b0 + i, h, nW);
  };
  // warps that released each stage, counted up: the eighth refills it
  uint32_t* released = reinterpret_cast<uint32_t*>(smem + L::BARS + 8 * S);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      released[s] = 0;
    }
    hopper::mbar_init_fence();
    for (int i = 0; i < min(n, S); ++i) load(i);
  }
  stage_bias_frag(bs, bias + (size_t)h * N * N, N);
  __syncthreads();

  float db[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) db[e] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int s = i % S;
    hopper::mbar_wait(&full[s], (i / S) & 1);
    const uint32_t qs = hopper::smem_u32(tiles + s * 4 * TILE);
    const uint32_t ks = qs + TILE, vs = qs + 2 * TILE, dos = qs + 3 * TILE;

    // S, its softmax, then dP: dP's 64 registers are not live while the
    // softmax runs (both tiles beside the dbias partial spilled)
    float sc[64], dp[64];
    scores(sc, qs + 64 * g * 32, ks);
    float na, nb, sa, sb;
    uint32_t unused[8][4];
    softmax_max(sc, bs, labels + s * NP, g, t, ra, rb, na, nb);
    softmax_exp<false>(sc, na, nb, sa, sb, unused);
    scores(dp, dos + 64 * g * 32, vs);
    const float ia = ra < N ? 1.f / sa : 0.f, ib = rb < N ? 1.f / sb : 0.f;
    float Da = 0.f, Db = 0.f;  // rowsum(P o dP), exactly in f32
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sc[4 * j] *= ia;
      sc[4 * j + 1] *= ia;
      sc[4 * j + 2] *= ib;
      sc[4 * j + 3] *= ib;
      Da = fmaf(sc[4 * j], dp[4 * j], fmaf(sc[4 * j + 1], dp[4 * j + 1], Da));
      Db = fmaf(sc[4 * j + 2], dp[4 * j + 2],
                fmaf(sc[4 * j + 3], dp[4 * j + 3], Db));
    }
    Da = quad_sum(Da);
    Db = quad_sum(Db);

    // the other warpgroup's wgmmas of the last window no longer read the
    // staging
    hopper::bar_sync(1, WG_THREADS);
    uint32_t hi[8][4], lo[8][4];  // dS as A fragments, k16 step kk
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * kk + u;
        uint8_t* w = my_stg + j * NP * 16;
        st_u32(w, pack_bf16(sc[4 * j], sc[4 * j + 1]));
        st_u32(w + 128, pack_bf16(sc[4 * j + 2], sc[4 * j + 3]));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - (e < 2 ? Da : Db));
          db[4 * j + e] += dp[4 * j + e];
        }
        pack_split(dp[4 * j], dp[4 * j + 1], hi[kk][2 * u], lo[kk][2 * u]);
        pack_split(dp[4 * j + 2], dp[4 * j + 3], hi[kk][2 * u + 1],
                   lo[kk][2 * u + 1]);
        st_u32(w + STAGED, hi[kk][2 * u]);
        st_u32(w + STAGED + 128, hi[kk][2 * u + 1]);
        st_u32(w + 2 * STAGED, lo[kk][2 * u]);
        st_u32(w + 2 * STAGED + 128, lo[kk][2 * u + 1]);
      }
    }
    hopper::fence_async_smem();  // the staging is read by wgmma

    float aq[8], av[8], ak[8];
    hopper::fence_regs(aq);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {  // dq = dS k, hi + lo
      hopper::wgmma_rs<16, 1>(aq, hi[kk], mdesc(ks + 512 * kk), kk > 0);
      hopper::wgmma_rs<16, 1>(aq, lo[kk], mdesc(ks + 512 * kk), 1);
    }
    hopper::wgmma_commit();
    hopper::bar_sync(2, WG_THREADS);  // all 128 rows of P, hi, lo staged

    const uint32_t st = hopper::smem_u32(stg) + g * 8 * NP * 16;
    hopper::fence_regs(av);
    hopper::fence_regs(ak);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)  // dv = P^T do
      hopper::wgmma_ss<16, 1, 1>(av, sdesc(st + 256 * kk),
                                 mdesc(dos + 512 * kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {  // dk = dS^T q, hi + lo
      hopper::wgmma_ss<16, 1, 1>(ak, sdesc(st + STAGED + 256 * kk),
                                 mdesc(qs + 512 * kk), kk > 0);
      hopper::wgmma_ss<16, 1, 1>(ak, sdesc(st + 2 * STAGED + 256 * kk),
                                 mdesc(qs + 512 * kk), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(aq);
    hopper::fence_regs(av);
    hopper::fence_regs(ak);
    fence_u32(hi);
    fence_u32(lo);
    __syncwarp();
    if (lane == 0) {  // the last warp to finish with this stage refills it
      __threadfence_block();
      if ((atomicAdd(&released[s], 1u) & 7u) == 7u && i + S < n) load(i + S);
    }

    const int b = b0 + i;
    store16(dq, sdq, aq, b, h, ra, rb, c0, N);  // query rows
    store16(dv, sdv, av, b, h, ra, rb, c0, N);  // key rows
    store16(dk, sdk, ak, b, h, ra, rb, c0, N);
    __syncwarp();
  }

  float* pb = part + ((size_t)chunk * H + h) * N * N;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? ra : rb, c = 8 * j + c0 + e % 2;
      if (r < N && c < N) pb[r * N + c] = db[4 * j + e];
    }
}

// One tile of each wgmma form of the wg kernels (debug_wgmma_tile): a [64,
// 16], b and v [128, 16] bf16 land by TMA as the kernels' tiles (a's rows
// 64-127 zero-filled); s [64, 128] = a b^T (m64n128k16, both K-major in the
// 32-byte swizzle), o [64, 16] = bf16(s) v (m64n16k16, A from registers, B
// MN-major), t [128, 16] = bf16(s)^T a (two m64n16k16 M tiles, A MN-major
// from the staging layout, B MN-major); f32.
__global__ void __launch_bounds__(128)
debug_wgmma_tile(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap vmap,
                 float* __restrict__ s, float* __restrict__ o,
                 float* __restrict__ t) {
  __shared__ __align__(1024) uint8_t tiles[3 * TILE];
  __shared__ __align__(128) uint8_t ps[STAGED];
  __shared__ uint64_t bar;
  const int lane = threadIdx.x % 32;
  const int ra = 16 * (threadIdx.x / 32) + lane / 4, rb = ra + 8;
  const int c0 = 2 * (lane % 4);
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar, 1);
    hopper::mbar_init_fence();
    hopper::mbar_expect_tx(&bar, 3 * TILE);
    hopper::tma_load_4d(tiles, &amap, &bar, 0, 0, 0, 0);
    hopper::tma_load_4d(tiles + TILE, &bmap, &bar, 0, 0, 0, 0);
    hopper::tma_load_4d(tiles + 2 * TILE, &vmap, &bar, 0, 0, 0, 0);
  }
  __syncthreads();
  hopper::mbar_wait(&bar, 0);
  const uint32_t as = hopper::smem_u32(tiles), bsm = as + TILE;
  const uint32_t vs = as + 2 * TILE;

  float sc[64];
  scores(sc, as, bsm);
  uint32_t pa[8][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[(e < 2 ? ra : rb) * NP + 8 * j + c0 + e % 2] = sc[4 * j + e];
    uint8_t* w = ps + j * NP * 16 + ra * 16 + 2 * c0;
    st_u32(w, pack_bf16(sc[4 * j], sc[4 * j + 1]));
    st_u32(w + 128, pack_bf16(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  float acc[8];
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hopper::wgmma_rs<16, 1>(acc, pa[kk], mdesc(vs + 512 * kk), kk > 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  fence_u32(pa);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    o[((e / 2) % 2 ? rb : ra) * WG_D + 8 * (e / 4) + c0 + e % 2] = acc[e];

  hopper::fence_async_smem();
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // K = the 64 rows of a
      hopper::wgmma_ss<16, 1, 1>(
          acc, sdesc(hopper::smem_u32(ps) + mt * 8 * NP * 16 + 256 * kk),
          mdesc(as + 512 * kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      t[(64 * mt + ((e / 2) % 2 ? rb : ra)) * WG_D + 8 * (e / 4) + c0 +
        e % 2] = acc[e];
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

// row r of (window b, head h) -> x[DP], zeros past d
template <int DP>
__device__ __forceinline__ void load_row(float (&x)[DP],
                                         const float* __restrict__ src, Str s,
                                         int b, int h, int r, int d) {
  const float* row = src + b * s.b + h * s.h + r * s.n;
#pragma unroll
  for (int i = 0; i < DP; ++i) x[i] = i < d ? row[i] : 0.f;
}

template <int DP>
__device__ __forceinline__ void store_row(float* __restrict__ dst, Str s,
                                          const float (&x)[DP], int b, int h,
                                          int r, int d) {
  float* row = dst + b * s.b + h * s.h + r * s.n;
#pragma unroll
  for (int i = 0; i < DP; ++i)
    if (i < d) row[i] = x[i];
}

template <int DP>
__device__ __forceinline__ float dot(const float (&x)[DP],
                                     const float* __restrict__ y, int d) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DP; ++i)
    if (i < d) s = fmaf(x[i], y[i], s);
  return s;
}

// score of query r (row qr) against key c
template <int DP>
__device__ __forceinline__ float score(const float (&qr)[DP],
                                       const float* __restrict__ kc,
                                       const float* __restrict__ bias_h,
                                       const float* rs, int r, int c, int N,
                                       int d) {
  return dot<DP>(qr, kc, d) + bias_h[r * N + c] +
         (rs[r] != rs[c] ? MASK : 0.f);
}

template <int DP>
__global__ void __launch_bounds__(NP)
fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ bias,
        const float* __restrict__ region, float* __restrict__ o, Str sq,
        Str sk, Str sv, Str so, int B, int N, int d, int nW, int wpc) {
  __shared__ float rs[NP];
  const int h = blockIdx.y;
  const int b_begin = blockIdx.x * wpc, b_end = min(B, b_begin + wpc);
  const int r = threadIdx.x;
  const float* bias_h = bias + (size_t)h * N * N;
  for (int b = b_begin; b < b_end; ++b) {
    __syncthreads();
    stage_region(rs, region, b, N, nW);
    __syncthreads();
    if (r >= N) continue;
    const float* kb = k + b * sk.b + h * sk.h;
    const float* vb = v + b * sv.b + h * sv.h;
    float qr[DP];
    load_row<DP>(qr, q, sq, b, h, r, d);
    float m = -INFINITY;
    for (int c = 0; c < N; ++c)
      m = fmaxf(m, score<DP>(qr, kb + c * sk.n, bias_h, rs, r, c, N, d));
    float l = 0.f, acc[DP];
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] = 0.f;
    for (int c = 0; c < N; ++c) {
      const float e =
          expf(score<DP>(qr, kb + c * sk.n, bias_h, rs, r, c, N, d) - m);
      l += e;
      const float* vc = vb + c * sv.n;
#pragma unroll
      for (int i = 0; i < DP; ++i)
        if (i < d) acc[i] = fmaf(e, vc[i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] /= l;
    store_row<DP>(o, so, acc, b, h, r, d);
  }
}

constexpr int bwd_fma_smem() { return NP * (NP + 1) * 4 + 4 * NP * 4; }

// Phase A, one thread per query row r: the row's max, 1 / sum, D =
// rowsum(dP o P) and dq. Phase B, one thread per key c: dk, dv, and column c
// of the block's dbias partial (in shared memory, owned by that thread).
template <int DP>
__global__ void __launch_bounds__(NP)
bwd_fma(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ bias,
        const float* __restrict__ region, const float* __restrict__ dout,
        float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
        float* __restrict__ part, Str sq, Str sk, Str sv, Str sdo, Str sdq,
        Str sdk, Str sdv, int B, int H, int N, int d, int nW, int wpc) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* dbs = reinterpret_cast<float*>(smem);  // [NP][NP + 1]
  float* rs = dbs + NP * (NP + 1);
  float* mrow = rs + NP;
  float* irow = mrow + NP;
  float* drow = irow + NP;

  const int h = blockIdx.y;
  const int b_begin = blockIdx.x * wpc, b_end = min(B, b_begin + wpc);
  const int tid = threadIdx.x;
  const float* bias_h = bias + (size_t)h * N * N;
  for (int i = tid; i < NP * (NP + 1); i += NP) dbs[i] = 0.f;

  for (int b = b_begin; b < b_end; ++b) {
    __syncthreads();
    stage_region(rs, region, b, N, nW);
    __syncthreads();
    const float* qb = q + b * sq.b + h * sq.h;
    const float* kb = k + b * sk.b + h * sk.h;
    const float* vb = v + b * sv.b + h * sv.h;
    const float* dob = dout + b * sdo.b + h * sdo.h;
    if (tid < N) {  // phase A: query row r
      const int r = tid;
      float qr[DP], dor[DP];
      load_row<DP>(qr, q, sq, b, h, r, d);
      load_row<DP>(dor, dout, sdo, b, h, r, d);
      float m = -INFINITY;
      for (int c = 0; c < N; ++c)
        m = fmaxf(m, score<DP>(qr, kb + c * sk.n, bias_h, rs, r, c, N, d));
      float l = 0.f, dsum = 0.f;
      for (int c = 0; c < N; ++c) {
        const float e =
            expf(score<DP>(qr, kb + c * sk.n, bias_h, rs, r, c, N, d) - m);
        l += e;
        dsum = fmaf(e, dot<DP>(dor, vb + c * sv.n, d), dsum);
      }
      const float il = 1.f / l, D = dsum * il;
      float acc[DP];
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = 0.f;
      for (int c = 0; c < N; ++c) {
        const float p =
            expf(score<DP>(qr, kb + c * sk.n, bias_h, rs, r, c, N, d) - m) *
            il;
        const float ds = p * (dot<DP>(dor, vb + c * sv.n, d) - D);
        const float* kc = kb + c * sk.n;
#pragma unroll
        for (int i = 0; i < DP; ++i)
          if (i < d) acc[i] = fmaf(ds, kc[i], acc[i]);
      }
      store_row<DP>(dq, sdq, acc, b, h, r, d);
      mrow[r] = m;
      irow[r] = il;
      drow[r] = D;
    }
    __syncthreads();
    if (tid < N) {  // phase B: key c
      const int c = tid;
      float kc[DP], vc[DP], gk[DP], gv[DP];
      load_row<DP>(kc, k, sk, b, h, c, d);
      load_row<DP>(vc, v, sv, b, h, c, d);
#pragma unroll
      for (int i = 0; i < DP; ++i) gk[i] = gv[i] = 0.f;
      for (int r = 0; r < N; ++r) {
        const float* qr = qb + r * sq.n;
        const float* dor = dob + r * sdo.n;
        const float s = dot<DP>(kc, qr, d) + bias_h[r * N + c] +
                        (rs[r] != rs[c] ? MASK : 0.f);
        const float p = expf(s - mrow[r]) * irow[r];
        const float ds = p * (dot<DP>(vc, dor, d) - drow[r]);
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          if (i < d) {
            gv[i] = fmaf(p, dor[i], gv[i]);
            gk[i] = fmaf(ds, qr[i], gk[i]);
          }
        }
        dbs[r * (NP + 1) + c] += ds;
      }
      store_row<DP>(dk, sdk, gk, b, h, c, d);
      store_row<DP>(dv, sdv, gv, b, h, c, d);
    }
  }
  __syncthreads();
  float* pb = part + ((size_t)blockIdx.x * H + h) * N * N;
  for (int i = tid; i < N * N; i += NP) pb[i] = dbs[(i / N) * (NP + 1) + i % N];
}

// dbias[i] = sum over blocks of part[block][i], in block order
__global__ void dbias_reduce(const float* __restrict__ part,
                             float* __restrict__ dbias, int chunks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[(size_t)c * n + i];
  dbias[i] = s;
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int windows_per_block(int B, int H, int target) {
  const long long work = (long long)B * H;
  const long long wpc = (work + target - 1) / target;
  return (int)(wpc < 1 ? 1 : wpc);
}

Str str(const long long* s) { return Str{s[0], s[1], s[2]}; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int DP>
cudaError_t launch_fwd(bool f32, const void* q, const void* k, const void* v,
                       const float* bias, const float* region, void* o,
                       const long long* st, int B, int H, int N, int d,
                       int nW, cudaStream_t s) {
  const int wpc = windows_per_block(B, H, FWD_TARGET_BLOCKS);
  const dim3 grid((B + wpc - 1) / wpc, H);
  if (f32) {
    fwd_fma<DP><<<grid, NP, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, region, static_cast<float*>(o),
        str(st), str(st + 3), str(st + 6), str(st + 9), B, N, d, nW, wpc);
  } else {
    constexpr int smem = fwd_mma_smem<DP>();
    cudaError_t err = allow_smem(fwd_mma<DP>, smem);
    if (err != cudaSuccess) return err;
    fwd_mma<DP><<<grid, MMA_THREADS, smem, s>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), bias, region,
        static_cast<__nv_bfloat16*>(o), str(st), str(st + 3), str(st + 6),
        str(st + 9), B, N, d, nW, wpc);
  }
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd(bool f32, const void* q, const void* k, const void* v,
                       const float* bias, const float* region,
                       const void* dout, void* dq, void* dk, void* dv,
                       float* part, const long long* st, int B, int H, int N,
                       int d, int nW, int chunks, cudaStream_t s) {
  const int wpc = windows_per_block(B, H, BWD_TARGET_BLOCKS);
  if ((B + wpc - 1) / wpc != chunks) return cudaErrorInvalidValue;
  const dim3 grid(chunks, H);
  if (f32) {
    constexpr int smem = bwd_fma_smem();
    cudaError_t err = allow_smem(bwd_fma<DP>, smem);
    if (err != cudaSuccess) return err;
    bwd_fma<DP><<<grid, NP, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, region,
        static_cast<const float*>(dout), static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), part, str(st),
        str(st + 3), str(st + 6), str(st + 9), str(st + 12), str(st + 15),
        str(st + 18), B, H, N, d, nW, wpc);
  } else {
    constexpr int smem = bwd_mma_smem<DP>();
    cudaError_t err = allow_smem(bwd_mma<DP>, smem);
    if (err != cudaSuccess) return err;
    bwd_mma<DP><<<grid, MMA_THREADS, smem, s>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), bias, region,
        static_cast<const uint16_t*>(dout), static_cast<__nv_bfloat16*>(dq),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
        part, str(st), str(st + 3), str(st + 6), str(st + 9), str(st + 12),
        str(st + 15), str(st + 18), B, H, N, d, nW, wpc);
  }
  return cudaGetLastError();
}

bool supported(int N, int d) {
  return N >= 1 && N <= NP && d >= 8 && d <= 64 && d % 8 == 0;
}

// A tensor map over a [B, H, N, 16] bf16 view with element strides st[0..2]
// (window, head, token), the box one window-head's [NP][16] tile (rows past
// N zero-filled) in the 32-byte swizzle. The outer axes go in the order of
// their strides; ``code`` says which axis sits where (see ``coord``).
bool encode_heads(CUtensorMap* map, const void* base, const long long* st,
                  int B, int H, int N, int* code) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  const long long stride[3] = {st[2], st[1], st[0]};  // token, head, window
  const cuuint64_t size[3] = {(cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)B};
  int w[3] = {0, 1, 2};
  for (int a = 0; a < 2; ++a)
    for (int c = 0; c < 2 - a; ++c)
      if (stride[w[c]] > stride[w[c + 1]]) {
        const int x = w[c];
        w[c] = w[c + 1];
        w[c + 1] = x;
      }
  const cuuint64_t dims[4] = {WG_D, size[w[0]], size[w[1]], size[w[2]]};
  const cuuint64_t strides[3] = {(cuuint64_t)stride[w[0]] * 2,
                                 (cuuint64_t)stride[w[1]] * 2,
                                 (cuuint64_t)stride[w[2]] * 2};
  const cuuint32_t box[4] = {WG_D, w[0] == 0 ? NP : 1u, w[1] == 0 ? NP : 1u,
                             w[2] == 0 ? NP : 1u};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  *code = w[0] | w[1] << 2 | w[2] << 4;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of ``ops`` operands (strides 3 per operand) and their codes, 6
// bits each.
bool encode_all(CUtensorMap* maps, const void* const* ops, int count,
                const long long* st, int B, int H, int N, int* codes) {
  *codes = 0;
  for (int op = 0; op < count; ++op) {
    int code;
    if (!encode_heads(&maps[op], ops[op], st + 3 * op, B, H, N, &code))
      return false;
    *codes |= code << (6 * op);
  }
  return true;
}

bool wg_args_ok(int B, int H, int N, int nW, int wpb) {
  return N >= 1 && N <= NP && H >= 1 && nW >= 1 && B % nW == 0 && wpb >= 1;
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

template <typename Kernel>
cudaError_t wg_occupancy(Kernel kernel, int smem, int* per_sm) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       WG_THREADS, smem);
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers; q, k,
// v, o (and do, dq, dk, dv) are [B, H, N, d] views given by ``strides``, a
// host array of (window, head, token) element strides per tensor, the last
// axis contiguous; bf16 rows must start 16-byte aligned. bias is a
// contiguous f32 [H, N, N], region a contiguous f32 [nW, N] with nW dividing
// B. ``f32`` selects the f32 variant, else bf16. Returns a cudaError_t.
extern "C" int window_attention_fwd(int f32, const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const void* region, void* o,
                                    const long long* strides, int B, int H,
                                    int N, int d, int nW, void* stream) {
  if (!supported(N, d) || nW < 1 || B % nW != 0)
    return (int)cudaErrorInvalidValue;
  const float* bi = static_cast<const float*>(bias);
  const float* re = static_cast<const float*>(region);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (d <= 16)
    err = launch_fwd<16>(f32, q, k, v, bi, re, o, strides, B, H, N, d, nW, s);
  else if (d <= 32)
    err = launch_fwd<32>(f32, q, k, v, bi, re, o, strides, B, H, N, d, nW, s);
  else
    err = launch_fwd<64>(f32, q, k, v, bi, re, o, strides, B, H, N, d, nW, s);
  return (int)err;
}

// Number of blocks along the windows in the backward: the caller allocates
// ``part`` as f32 [chunks, H, N, N].
extern "C" int window_attention_bwd_chunks(int B, int H) {
  const int wpc = windows_per_block(B, H, BWD_TARGET_BLOCKS);
  return (B + wpc - 1) / wpc;
}

// dq, dk, dv (views as for the forward; ``strides`` holds q, k, v, do, dq,
// dk, dv in that order) and dbias f32 [H, N, N] through the scratch ``part``.
extern "C" int window_attention_bwd(int f32, const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const void* region, const void* dout,
                                    void* dq, void* dk, void* dv, void* part,
                                    void* dbias, const long long* strides,
                                    int B, int H, int N, int d, int nW,
                                    int chunks, void* stream) {
  if (!supported(N, d) || nW < 1 || B % nW != 0)
    return (int)cudaErrorInvalidValue;
  const float* bi = static_cast<const float*>(bias);
  const float* re = static_cast<const float*>(region);
  float* pa = static_cast<float*>(part);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (d <= 16)
    err = launch_bwd<16>(f32, q, k, v, bi, re, dout, dq, dk, dv, pa, strides,
                         B, H, N, d, nW, chunks, s);
  else if (d <= 32)
    err = launch_bwd<32>(f32, q, k, v, bi, re, dout, dq, dk, dv, pa, strides,
                         B, H, N, d, nW, chunks, s);
  else
    err = launch_bwd<64>(f32, q, k, v, bi, re, dout, dq, dk, dv, pa, strides,
                         B, H, N, d, nW, chunks, s);
  if (err != cudaSuccess) return (int)err;
  const int n = H * N * N;
  dbias_reduce<<<(n + 255) / 256, 256, 0, s>>>(
      pa, static_cast<float*>(dbias), chunks, n);
  return (int)cudaGetLastError();
}

// The wg kernels (bf16, d = 16, N <= 128). Blocks of fwd_wg (``bwd`` 0) or
// bwd_wg (1) that one SM holds at once -> *out: with the SM count, the
// caller's target for the static assignment of (head, window run) to blocks.
extern "C" int window_attention_wg_blocks_per_sm(int bwd, int* out) {
  return (int)(bwd ? wg_occupancy(bwd_wg, BwdWg::BYTES, out)
                   : wg_occupancy(fwd_wg, FwdWg::BYTES, out));
}

// fwd_wg: views and ``strides`` as window_attention_fwd (rows 16-byte
// aligned, the three strides multiples of 8 elements); ``region`` the labels
// as contiguous f32 [nW, 128], zero past N; block (chunk, h) takes head h
// and windows chunk * wpb .. (the grid has ceil(B / wpb) * H blocks).
extern "C" int window_attention_fwd_wg(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* region, void* o,
                                       const long long* strides, int B, int H,
                                       int N, int nW, int wpb, void* stream) {
  if (!wg_args_ok(B, H, N, nW, wpb)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ops[3] = {q, k, v};
  int codes;
  if (!encode_all(maps, ops, 3, strides, B, H, N, &codes))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fwd_wg, FwdWg::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (B + wpb - 1) / wpb;
  fwd_wg<<<chunks * H, WG_THREADS, FwdWg::BYTES, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], static_cast<const float*>(bias),
      static_cast<const float*>(region), static_cast<__nv_bfloat16*>(o),
      str(strides + 9), codes, B, H, N, nW, wpb);
  return (int)cudaGetLastError();
}

// bwd_wg: as window_attention_bwd (``strides`` for q, k, v, do, dq, dk, dv)
// with the fwd_wg region and assignment; ``part`` is f32 [chunks, H, N, N]
// with chunks = ceil(B / wpb), added into dbias in block order.
extern "C" int window_attention_bwd_wg(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* region, const void* dout,
                                       void* dq, void* dk, void* dv,
                                       void* part, void* dbias,
                                       const long long* strides, int B, int H,
                                       int N, int nW, int wpb, int chunks,
                                       void* stream) {
  if (!wg_args_ok(B, H, N, nW, wpb) || chunks != (B + wpb - 1) / wpb)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* ops[4] = {q, k, v, dout};
  int codes;
  if (!encode_all(maps, ops, 4, strides, B, H, N, &codes))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(bwd_wg, BwdWg::BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  float* pa = static_cast<float*>(part);
  bwd_wg<<<chunks * H, WG_THREADS, BwdWg::BYTES, s>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(bias),
      static_cast<const float*>(region), static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), pa,
      str(strides + 12), str(strides + 15), str(strides + 18), codes, B, H, N,
      nW, wpb);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n = H * N * N;
  dbias_reduce<<<(n + 255) / 256, 256, 0, s>>>(
      pa, static_cast<float*>(dbias), chunks, n);
  return (int)cudaGetLastError();
}

// Registers, static shared memory, local (spill) bytes and dynamic shared
// memory of ``which``: 0 fwd_mma (d = 16), 1 bwd_mma (d = 16), 2 fwd_wg, 3
// bwd_wg. Writes 4 ints to ``out``.
extern "C" int window_attention_kernel_attrs(int which, int* out) {
  switch (which) {
    case 0:
      return attrs(fwd_mma<16>, fwd_mma_smem<16>(), out);
    case 1:
      return attrs(bwd_mma<16>, bwd_mma_smem<16>(), out);
    case 2:
      return attrs(fwd_wg, FwdWg::BYTES, out);
    case 3:
      return attrs(bwd_wg, BwdWg::BYTES, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One tile of each wgmma form of the wg kernels (debug_wgmma_tile): a [64,
// 16], b and v [128, 16] contiguous bf16 -> s [64, 128], o [64, 16], t [128,
// 16] f32.
extern "C" int window_attention_debug_wgmma_tile(const void* a, const void* b,
                                                 const void* v, void* s,
                                                 void* o, void* t,
                                                 void* stream) {
  const long long st64[3] = {64 * WG_D, 64 * WG_D, WG_D};
  const long long st128[3] = {NP * WG_D, NP * WG_D, WG_D};
  CUtensorMap maps[3];
  int code;
  if (!encode_heads(&maps[0], a, st64, 1, 1, 64, &code) ||
      !encode_heads(&maps[1], b, st128, 1, 1, NP, &code) ||
      !encode_heads(&maps[2], v, st128, 1, 1, NP, &code))
    return (int)cudaErrorInvalidValue;
  debug_wgmma_tile<<<1, 128, 0, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(s),
      static_cast<float*>(o), static_cast<float*>(t));
  return (int)cudaGetLastError();
}
