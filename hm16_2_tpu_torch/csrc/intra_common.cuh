// Device code shared by the RD kernels (K2 intra_size_rd, K3 intra_cand_rd
// in intra_rd.cu; K7 inter_uni, K8 inter_cu_rd in inter_rd.cu; K5 inter_me
// in inter_me.cu; cp.async also by K1 in ref_buffers.cu and K6 in
// subpel.cu): the reference-buffer index of an angular intra mode, the
// context-free residual-bits model, the 8x8 Hadamard SATD, the MVD bins,
// the int32 stage item of K2's, K3's and K8's transform chains (`mm_item`),
// cp.async copies and the 49-way warp argmin.
//
// Everything is int32 arithmetic in the reference's order, except the
// bits/cost floats, which follow XLA:CPU's rounding steps: the file is built
// with --fmad=false, so a*b+c rounds twice unless written as __fmaf_rn.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hm {

// layout of the float model table (built by hm16_2_tpu_torch.kernels from
// intra_rd.LN_LAST / BITS_COEF / BITS_CONST)
enum {
  MODEL_LN = 0,        // 32 x ln(i + 1.5) as XLA:CPU returns it
  MODEL_LOG2E = 32,
  MODEL_NZC, MODEL_NNZ, MODEL_GT1, MODEL_ESC, MODEL_LAST, MODEL_CGS, MODEL_CONST,
  MODEL_LOW,           // bits of a block without coefficients (0.8)
  MODEL_FLOOR,         // lower bound of the model (2.0)
  MODEL_MODE_BITS,     // flat luma mode bits added in K2 (6.0)
  MODEL_COUNT
};

// per-launch constants of the transform chain (host struct, copied into the
// kernel parameters)
struct TqParams {
  int s, log2, bd, maxv;
  int edge;          // luma and s <= 16: DC / pure hor-ver edge filters
  int fwd_s1, fwd_s2;
  int q_scale, q_bits, q_add;
  int dq_scale, dq_shift, dq_min, dq_max;
  int inv_s2;
  unsigned long long filt;   // bit m: mode m predicts from filtered refs
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int bit_length(int v) {
  return v > 0 ? 32 - __clz(v) : 0;
}

// refMain[k] of an angular mode as an index into the (4s+1) buffer
// (corner at 2s, left bottom-up below it, top above it)
template <int S>
__device__ __forceinline__ int ref_main_index(int k, bool is_ver,
                                              int inv_angle) {
  constexpr int corner = 2 * S;
  if (k >= 0) {
    k = k < 2 * S ? k : 2 * S;
    return is_ver ? corner + k : corner - k;
  }
  int i = ((-k) * inv_angle + 128) >> 8;
  return is_ver ? corner - i : corner + i;
}

// XLA:CPU's float32 evaluation of the reference's residual-bits regression
__device__ __forceinline__ float bits_estimate(int nnz, int last_x,
                                               int last_y, int gt1,
                                               int esc_bits,
                                               const float* m) {
  if (nnz == 0) return m[MODEL_LOW];
  int nzc = (last_x + 1) * (last_y + 1) - nnz;
  nzc = nzc > 0 ? nzc : 0;
  int cgs = (last_x / 4 + 1) * (last_y / 4 + 1) - 1;   // last_* >= 0 here
  cgs = cgs > 0 ? cgs : 0;
  float lsum = __fmaf_rn(m[MODEL_LN + last_x], m[MODEL_LOG2E],
                         __fmul_rn(m[MODEL_LN + last_y], m[MODEL_LOG2E]));
  float lastpos = __fadd_rn(__fmul_rn(lsum, 2.0f), 2.0f);
  float b = __fmaf_rn(__int2float_rn(nnz), m[MODEL_NNZ],
                      __fmul_rn(__int2float_rn(nzc), m[MODEL_NZC]));
  b = __fmaf_rn(-__int2float_rn(gt1), m[MODEL_GT1], b);
  b = __fmaf_rn(__int2float_rn(esc_bits), m[MODEL_ESC], b);
  b = __fadd_rn(b, __fmul_rn(lastpos, m[MODEL_LAST]));
  b = __fmaf_rn(__int2float_rn(cgs), m[MODEL_CGS], b);
  b = __fadd_rn(b, m[MODEL_CONST]);
  return fmaxf(b, m[MODEL_FLOOR]);
}

// HM's 8x8 Hadamard SATD of one tile of differences, (sum |H d H| + 2) >> 2
__device__ __forceinline__ int satd8x8(int (&v)[64]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int h = 1; h < 8; h <<= 1)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (!(i & h)) {
          int a = v[r * 8 + i], b = v[r * 8 + i + h];
          v[r * 8 + i] = a + b;
          v[r * 8 + i + h] = a - b;
        }
  int sum = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int h = 1; h < 8; h <<= 1)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (!(i & h)) {
          int a = v[i * 8 + c], b = v[(i + h) * 8 + c];
          v[i * 8 + c] = a + b;
          v[(i + h) * 8 + c] = a - b;
        }
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[i * 8 + c] < 0 ? -v[i * 8 + c] : v[i * 8 + c];
  }
  return (sum + 2) >> 2;
}

// bins of one quarter-pel MVD component: greater0, greater1, sign + EG1
// (5 + 2 * floor(log2(max(|d| >> 1, 1))); XLA's log2 floors 8192 to 12)
__device__ __forceinline__ float mvd_comp_bits(int d) {
  int a = d < 0 ? -d : d;
  if (a == 0) return 1.f;
  if (a == 1) return 3.f;
  int h = a >> 1;
  int e = bit_length(h) - 1 - (h == 8192 ? 1 : 0);
  return __int2float_rn(5 + 2 * e);
}

__device__ __forceinline__ float mvd_bits(int dx, int dy) {
  return __fadd_rn(mvd_comp_bits(dx), mvd_comp_bits(dy));
}

// RB outputs (rows r0, r0 + T/RB, ..., column c) of the T x T product
// X Y (int32, any order: integers); four of X's row entries per 16-byte
// load, Y's column read across the warp's lanes
template <int T, int RB>
__device__ __forceinline__ void mm_item(const int* X, const int* Y, int r0,
                                        int c, int (&acc)[RB]) {
#pragma unroll
  for (int q = 0; q < RB; ++q) acc[q] = 0;
#pragma unroll
  for (int j = 0; j < T; j += 4) {
    int y0 = Y[j * T + c], y1 = Y[(j + 1) * T + c];
    int y2 = Y[(j + 2) * T + c], y3 = Y[(j + 3) * T + c];
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      int4 x = *(const int4*)(X + (r0 + q * (T / RB)) * T + j);
      acc[q] += x.x * y0 + x.y * y1 + x.z * y2 + x.w * y3;
    }
  }
}

// asynchronous copies of 4 / 16 bytes from global to shared memory (16:
// both addresses 16-byte aligned), and the wait for all of this thread's
// copies; a __syncthreads() after the wait publishes them to the CTA
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the first least of the 49 costs c[0..48] (the lowest index among equal
// costs, as jnp.argmin), on every lane of a full warp
__device__ __forceinline__ int warp_argmin49(const float* c) {
  int lane = threadIdx.x & 31, k = lane;
  float v = c[lane];
  if (lane + 32 < 49 && c[lane + 32] < v) { v = c[lane + 32]; k = lane + 32; }
  for (int off = 16; off > 0; off >>= 1) {
    float vo = __shfl_xor_sync(0xffffffffu, v, off);
    int ko = __shfl_xor_sync(0xffffffffu, k, off);
    if (vo < v || (vo == v && ko < k)) { v = vo; k = ko; }
  }
  return k;
}

}  // namespace hm
