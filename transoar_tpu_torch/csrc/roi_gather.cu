// Backward of the Focused Decoder's RoI gather, for Hopper (sm_90a): the
// gradients of the gathered keys and values added up per token.
//
// Replaces no TPU kernel. The JAX package gathers each organ's tokens with
// XLA's ``take`` and leaves its backward (a scatter-add) to XLA. On the card
// the same backward was PyTorch's ``index_put_(accumulate=True)``: a sort of
// the gather index, then one serial run per distinct token. The index is
// static, and its pad slots (about 7,000 of 15,360 at the flagship's and
// the SwinFPN's shapes) all point at token 0, so that one run was ~7,000
// rows long, every row an exact zero (a pad slot's softmax weight is 0 in
// f32), and the op took ~7 ms a layer for ~76 MB of traffic.
//
// Function. With the inverse of the gather index in CSR form, built once
// with the model (``models/focused_decoder.py:roi_inverse_index``): the
// slots that read token s are slots[offsets[s] .. offsets[s + 1]), in
// ascending slot order, pad slots left out. For each batch row b and token
// s, and for both K and V:
//
//     d[b, s, :] = sum over j in [offsets[s], offsets[s + 1]) of
//                  grad[b, slots[j], :]          (f32, in that order)
//
// written once in the I/O type (bf16 or f32); a token no slot reads gets
// zeros.
//
// What bounds it on the H100: bytes. At the flagship's batch 2 a layer reads
// the valid slots' rows of dK_r and dV_r (2 x 2 x 8,362 x 384 bf16, 25.7
// MB) and writes dK and dV (2 x 2 x 16,384 x 384 bf16, 50.3 MB): ~76 MB,
// ~23 us at 3.35 TB/s. There are ~0.5 additions a byte.
//
// What the design does about it: one launch for dK and dV, one warp for
// each (b, token) pair, which sums that token's K row and V row (96 16-byte
// vectors at width 384 in bf16, three a lane). A lane keeps its vectors'
// sums in f32 registers and walks the token's slots in the CSR's fixed
// order, four 16-byte loads in flight at a time, then stores each vector
// once. Every output element is written exactly once, the uncovered
// tokens' zeros included: no memset, no atomics, no sort, and the result
// is the same bits on every run. Pad slots are never read. The gradient's
// rows are read at the element strides of b and of the slot, each row
// contiguous (the attention's einsum hands it over contiguous); the wrapper
// checks that every 16-byte vector is aligned, or copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;   // warps a block, one (b, token) pair each
constexpr int UNROLL = 4;  // slot rows in flight a lane

// One operand: grad [B, N, W] (element strides sb, sn; rows contiguous) and
// its result [B, S, W], contiguous.
struct Rows {
  const void* grad;
  void* out;
  long long sb, sn;
};

template <typename T>
struct Lanes;  // the elements of one 16-byte vector, widened to f32

template <>
struct Lanes<float> {
  static constexpr int N = 4;
  __device__ static void add(float (&acc)[4], const uint4& x) {
    acc[0] += __uint_as_float(x.x);
    acc[1] += __uint_as_float(x.y);
    acc[2] += __uint_as_float(x.z);
    acc[3] += __uint_as_float(x.w);
  }
  __device__ static uint4 pack(const float (&acc)[4]) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                      __float_as_uint(acc[2]), __float_as_uint(acc[3]));
  }
};

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void add(float (&acc)[8], const uint4& x) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
  __device__ static uint4 pack(const float (&acc)[8]) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    return x;
  }
};

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
roi_segment_sum(Rows k, Rows v, const int* __restrict__ offsets,
                const int* __restrict__ slots, int B, int S, int W) {
  using L = Lanes<T>;
  const long long item = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (item >= (long long)B * S) return;
  const int lane = threadIdx.x % 32;
  const long long b = item / S;
  const int s = (int)(item - b * S);
  const int beg = __ldg(offsets + s), end = __ldg(offsets + s + 1);
  const int row = W / L::N;  // vectors in a row
  for (int i = lane; i < 2 * row; i += 32) {
    const bool is_v = i >= row;  // lanes of one step may take K and V
    const long long sn = is_v ? v.sn : k.sn;
    const int e = (is_v ? i - row : i) * L::N;  // element in the row
    const T* base = static_cast<const T*>(is_v ? v.grad : k.grad)
                    + b * (is_v ? v.sb : k.sb) + e;
    float acc[L::N];
#pragma unroll
    for (int u = 0; u < L::N; ++u) acc[u] = 0.f;
    int j = beg;
    for (; j + UNROLL <= end; j += UNROLL) {
      uint4 x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        x[u] = __ldg(reinterpret_cast<const uint4*>(
            base + (long long)__ldg(slots + j + u) * sn));
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) L::add(acc, x[u]);
    }
    for (; j < end; ++j)
      L::add(acc, __ldg(reinterpret_cast<const uint4*>(
                      base + (long long)__ldg(slots + j) * sn)));
    T* out = static_cast<T*>(is_v ? v.out : k.out)
             + (b * S + s) * (long long)W + e;
    *reinterpret_cast<uint4*>(out) = L::pack(acc);
  }
}

template <typename T>
cudaError_t launch(const Rows& k, const Rows& v, const int* offsets,
                   const int* slots, int B, int S, int W, cudaStream_t s) {
  if (W % Lanes<T>::N != 0) return cudaErrorInvalidValue;
  const long long items = (long long)B * S;
  const long long blocks = (items + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks > 0)
    roi_segment_sum<T><<<(unsigned)blocks, WARPS * 32, 0, s>>>(
        k, v, offsets, slots, B, S, W);
  return cudaGetLastError();
}

}  // namespace

// dK, dV [B, S, W] (contiguous, the I/O type) from gk, gv [B, N, W]:
// ``strides`` holds gk's sb, sn, then gv's. offsets [S + 1] and slots are
// int32 (the CSR).
extern "C" int roi_gather_bwd(int f32, const void* gk, const void* gv,
                              void* dk, void* dv, const long long* strides,
                              const void* offsets, const void* slots, int B,
                              int S, int W, void* stream) {
  const Rows k{gk, dk, strides[0], strides[1]};
  const Rows v{gv, dv, strides[2], strides[3]};
  const int* off = static_cast<const int*>(offsets);
  const int* sl = static_cast<const int*>(slots);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(f32 ? launch<float>(k, v, off, sl, B, S, W, s)
                   : launch<__nv_bfloat16>(k, v, off, sl, B, S, W, s));
}
