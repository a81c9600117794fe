// Device code shared by the RD kernels (K2 intra_size_rd, K3 intra_cand_rd
// in intra_rd.cu; K7 inter_uni, K8 inter_cu_rd in inter_rd.cu; K5 inter_me
// in inter_me.cu): one sample of any of the 35 intra predictions, the
// forward transform -> quant -> dequant -> inverse chain of a residual, the
// context-free residual-bits model, the 8x8 Hadamard SATD and the MVD bins.
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

constexpr int kThreads = 256;

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

// one sample (row r, column c) of intra mode `mode`; bu/bf are the
// unfiltered / filtered buffers, ang = {ANG_TABLE[9], INV_ANG_TABLE[9]}
template <int S>
__device__ int pred_sample(const int* bu, const int* bf, const int* ang,
                           int dcval, int mode, int r, int c,
                           const TqParams& p) {
  constexpr int corner = 2 * S;
  constexpr int log2 = S == 4 ? 2 : S == 8 ? 3 : S == 16 ? 4 : 5;
  const int* buf = ((p.filt >> mode) & 1ull) ? bf : bu;
  if (mode == 0) {
    int left = buf[corner - 1 - r], top = buf[corner + 1 + c];
    int tr = buf[corner + S + 1], bl = buf[corner - S - 1];
    return ((S - 1 - c) * left + (c + 1) * tr + (S - 1 - r) * top +
            (r + 1) * bl + S) >> (log2 + 1);
  }
  if (mode == 1) {
    if (p.edge) {
      if (r == 0 && c == 0)
        return (bu[corner + 1] + bu[corner - 1] + 2 * dcval + 2) >> 2;
      if (r == 0) return (bu[corner + 1 + c] + 3 * dcval + 2) >> 2;
      if (c == 0) return (bu[corner - 1 - r] + 3 * dcval + 2) >> 2;
    }
    return dcval;
  }
  if (p.edge) {
    if (mode == 26 && c == 0)
      return clampi(bu[corner + 1] + ((bu[corner - 1 - r] - bu[corner]) >> 1),
                    0, p.maxv);
    if (mode == 10 && r == 0)
      return clampi(bu[corner - 1] + ((bu[corner + 1 + c] - bu[corner]) >> 1),
                    0, p.maxv);
  }
  bool is_ver = mode >= 18;
  int ang_mode = is_ver ? mode - 26 : 10 - mode;
  int abs_ang = ang_mode < 0 ? -ang_mode : ang_mode;
  int angle = ang_mode < 0 ? -ang[abs_ang] : ang[abs_ang];
  int inv_angle = ang[9 + abs_ang];
  int yy = is_ver ? r : c, xx = is_ver ? c : r;
  int delta = (yy + 1) * angle;
  int iidx = delta >> 5, frac = delta & 31;
  int k = 1 + iidx + xx;
  int v0 = buf[ref_main_index<S>(k, is_ver, inv_angle)];
  int v1 = buf[ref_main_index<S>(k + 1, is_ver, inv_angle)];
  return ((32 - frac) * v0 + frac * v1 + 16) >> 5;
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

// shared-memory state of a CTA that evaluates G blocks of size S
template <int S, int G>
struct BlockSmem {
  static constexpr int B = 4 * S + 1;
  int bu[G][B], bf[G][B];
  int orig[G][S * S];
  int pred[G][S * S];
  int wa[G][S * S], wb[G][S * S], wc[G][S * S];
  int tm[S * S];
  int ang[18];
  int dcval[G];
  // per-candidate statistics, reset after each candidate
  unsigned int dist[G];
  int nnz[G], gt1[G], esc[G], last_x[G], last_y[G];
};

// load the reference buffers, original blocks, transform matrix and angle
// tables of blocks n0 .. n0+G-1 (blocks past n read as zeros)
template <int S, int G>
__device__ void load_blocks(BlockSmem<S, G>& sm, const int* bufs,
                            const int* blocks, int n0, int n, const int* tm,
                            const int* ang) {
  constexpr int B = BlockSmem<S, G>::B;
  for (int q = threadIdx.x; q < G * B; q += blockDim.x) {
    int g = q / B, i = q % B;
    bool in = n0 + g < n;
    sm.bu[g][i] = in ? bufs[(size_t)(n0 + g) * 2 * B + i] : 0;
    sm.bf[g][i] = in ? bufs[(size_t)(n0 + g) * 2 * B + B + i] : 0;
  }
  for (int q = threadIdx.x; q < G * S * S; q += blockDim.x) {
    int g = q / (S * S);
    sm.orig[g][q % (S * S)] =
        n0 + g < n ? blocks[(size_t)(n0 + g) * S * S + q % (S * S)] : 0;
  }
  for (int q = threadIdx.x; q < S * S; q += blockDim.x) sm.tm[q] = tm[q];
  for (int q = threadIdx.x; q < 18; q += blockDim.x) sm.ang[q] = ang[q];
  __syncthreads();
  if ((int)threadIdx.x < G) {
    int g = threadIdx.x, sum = S;
    for (int i = 0; i < S; ++i)
      sum += sm.bu[g][2 * S + 1 + i] + sm.bu[g][2 * S - 1 - i];
    constexpr int log2 = S == 4 ? 2 : S == 8 ? 3 : S == 16 ? 4 : 5;
    sm.dcval[g] = sum >> (log2 + 1);
    sm.dist[g] = 0;
    sm.nnz[g] = sm.gt1[g] = sm.esc[g] = 0;
    sm.last_x[g] = sm.last_y[g] = -1;
  }
  __syncthreads();
}

// transform RD of the residuals in sm.wa (predictions in sm.pred, originals
// in sm.orig): adds the reconstruction SSE to sm.dist and the level
// statistics to sm.nnz ... sm.last_y
template <int S, int G>
__device__ void transform_chain(BlockSmem<S, G>& sm, const TqParams& p) {
  constexpr int SS = S * S;
  // forward stage 1: wb[i][k] = sum_j resi[i][j] * T[k][j]
  for (int q = threadIdx.x; q < G * SS; q += blockDim.x) {
    int g = q / SS, i = (q % SS) / S, k = q % S;
    int acc = 0;
    for (int j = 0; j < S; ++j) acc += sm.wa[g][i * S + j] * sm.tm[k * S + j];
    sm.wb[g][i * S + k] = p.fwd_s1 > 0
        ? (acc + (1 << (p.fwd_s1 - 1))) >> p.fwd_s1 : acc << (-p.fwd_s1);
  }
  __syncthreads();
  // forward stage 2, quant, statistics, dequant
  for (int q = threadIdx.x; q < G * SS; q += blockDim.x) {
    int g = q / SS, k = (q % SS) / S, j = q % S;
    int acc = 0;
    for (int i = 0; i < S; ++i) acc += sm.tm[k * S + i] * sm.wb[g][i * S + j];
    int coef = (acc + (1 << (p.fwd_s2 - 1))) >> p.fwd_s2;
    int a = coef < 0 ? -coef : coef;
    int lv = (a * p.q_scale + p.q_add) >> p.q_bits;
    lv = lv < 32767 ? lv : 32767;
    int level = coef < 0 ? -lv : (coef > 0 ? lv : 0);
    sm.wa[g][k * S + j] = level;
    if (lv > 0) {
      atomicAdd(&sm.nnz[g], 1);
      atomicMax(&sm.last_y[g], k);
      atomicMax(&sm.last_x[g], j);
      if (lv > 1) {
        atomicAdd(&sm.gt1[g], 1);
        atomicAdd(&sm.esc[g], 2 * bit_length(lv - 1) + 1);
      }
    }
    int dq = clampi(level, p.dq_min, p.dq_max) * p.dq_scale;
    dq = p.dq_shift > 0 ? (dq + (1 << (p.dq_shift - 1))) >> p.dq_shift
                        : dq << (-p.dq_shift);
    sm.wc[g][k * S + j] = clampi(dq, -32768, 32767);
  }
  __syncthreads();
  // inverse stage 1: wb[i][k] = clip((sum_j T[j][i] * deq[j][k] + 64) >> 7)
  for (int q = threadIdx.x; q < G * SS; q += blockDim.x) {
    int g = q / SS, i = (q % SS) / S, k = q % S;
    int acc = 0;
    for (int j = 0; j < S; ++j) acc += sm.tm[j * S + i] * sm.wc[g][j * S + k];
    sm.wb[g][i * S + k] = clampi((acc + 64) >> 7, -32768, 32767);
  }
  __syncthreads();
  // inverse stage 2, reconstruction, SSE
  for (int q = threadIdx.x; q < G * SS; q += blockDim.x) {
    int g = q / SS, i = (q % SS) / S, k = q % S;
    int acc = 0;
    for (int j = 0; j < S; ++j) acc += sm.wb[g][i * S + j] * sm.tm[j * S + k];
    int rres = clampi((acc + (1 << (p.inv_s2 - 1))) >> p.inv_s2,
                      -32768, 32767);
    int rec = clampi(sm.pred[g][i * S + k] + rres, 0, p.maxv);
    int d = sm.orig[g][i * S + k] - rec;
    atomicAdd(&sm.dist[g], (unsigned int)(d * d));
  }
  __syncthreads();
}

// transform RD of one candidate mode per block (mode_of(g) gives it):
// leaves dist in sm.dist and the level statistics in sm.nnz ... sm.last_y
template <int S, int G, typename ModeOf>
__device__ void candidate_chain(BlockSmem<S, G>& sm, const TqParams& p,
                                ModeOf mode_of) {
  constexpr int SS = S * S;
  // prediction and residual
  for (int q = threadIdx.x; q < G * SS; q += blockDim.x) {
    int g = q / SS, yx = q % SS;
    int v = pred_sample<S>(sm.bu[g], sm.bf[g], sm.ang, sm.dcval[g],
                           mode_of(g), yx / S, yx % S, p);
    sm.pred[g][yx] = v;
    sm.wa[g][yx] = sm.orig[g][yx] - v;
  }
  __syncthreads();
  transform_chain<S, G>(sm, p);
}

// bits of the candidate just evaluated; resets the statistics (thread g)
template <int S, int G>
__device__ __forceinline__ float take_bits(BlockSmem<S, G>& sm, int g,
                                           const float* model) {
  float b = bits_estimate(sm.nnz[g], sm.last_x[g], sm.last_y[g], sm.gt1[g],
                          sm.esc[g], model);
  sm.nnz[g] = sm.gt1[g] = sm.esc[g] = 0;
  sm.last_x[g] = sm.last_y[g] = -1;
  return b;
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
