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
// What the design does about it:
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
// Limits: N <= 128, d a multiple of 8 up to 64.
// Left for later work: cp.async or TMA prefetch of the next window while
// this one computes, wgmma, packing two windows into one 128-row tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
