// K2 intra_size_rd and K3 intra_cand_rd: the per-size intra RD of the
// all-intra frame plan.
//
// Replaces (hm16_2_tpu/encode/intra_rd.py) `_size_rd` (:172) and with it
// `predict_all_modes`, `batched_satd`, `batched_fwd_transform`,
// `batched_quant` (ops/analysis.py:153-273), `batched_dequant` (:48),
// `batched_inv_transform` (:66), `_bits_estimate` (:108) and
// `_topk_argmin` (:159); K3 replaces `_chroma_rd5` (:212) and
// `_size_rd_fixed_mode` (:232).  SATD-only mode (k = 0) serves
// `CtuSearch._premodes` (encode/top.py:3938).
//
// What bounds it: integer ALU work.  Per block the 35 predictions and
// their Hadamard SATDs cost ~35 * 3 * s^2 operations and each of the k
// candidates four s x s integer matrix products (4 * s^3 multiply-adds),
// against s^2 * 4 bytes of input: far above the memory roofline.  The
// reference gathered every prediction from (33, s, s) index tables
// (400 KB at s = 32); here each sample is computed from HM's angle tables,
// so nothing but the reference buffers and the block is read.
//
// Design: one CTA holds G blocks (G = 16/4/1/1 for s = 4/8/16/32) in
// shared memory and keeps every intermediate there: per mode, the
// prediction residual, an in-register 8-point (4-point) Hadamard over rows
// then columns, and integer atomics for the tile sums; then the top-k by
// float32 SATD (ties to the lowest mode, as jnp.argmin), and per candidate
// the transform chain with int32 multiply-adds.  Integer atomics make every
// reduction order-independent.  Plain and simple; wgmma, TMA and warp
// specialisation are later work.
#include "intra_common.cuh"

namespace hm {

template <int S> struct Group { static constexpr int G = 256 / (S * S) > 0 ? 256 / (S * S) : 1; };

template <int S, int G>
__global__ void __launch_bounds__(kThreads)
size_rd_kernel(const int* __restrict__ bufs, const int* __restrict__ blocks,
               int n, TqParams p, const int* __restrict__ tm,
               const int* __restrict__ ang, const float* __restrict__ model,
               float lam, int k, int want_satd, int* __restrict__ out_mode,
               float* __restrict__ out_cost, int* __restrict__ out_top3,
               int* __restrict__ out_satd) {
  constexpr int SS = S * S;
  constexpr int T = S % 8 == 0 ? 8 : 4;     // Hadamard tile
  constexpr int NT = (S / T) * (S / T);     // tiles per block
  __shared__ BlockSmem<S, G> sm;
  __shared__ int satd[G][35];
  __shared__ int tile[G][NT];
  __shared__ int top[G][4];
  __shared__ float cost[G][4];
  const int n0 = blockIdx.x * G;
  for (int q = threadIdx.x; q < G * 35; q += blockDim.x) satd[q / 35][q % 35] = 0;
  for (int q = threadIdx.x; q < G * NT; q += blockDim.x) tile[q / NT][q % NT] = 0;
  load_blocks<S, G>(sm, bufs, blocks, n0, n, tm, ang);

  for (int mode = 0; mode < 35; ++mode) {
    for (int q = threadIdx.x; q < G * SS; q += blockDim.x) {
      int g = q / SS, yx = q % SS;
      sm.wa[g][yx] = pred_sample<S>(sm.bu[g], sm.bf[g], sm.ang, sm.dcval[g],
                                    mode, yx / S, yx % S, p) - sm.orig[g][yx];
    }
    __syncthreads();
    // Hadamard along each row segment of T samples, in place
    for (int q = threadIdx.x; q < G * S * (S / T); q += blockDim.x) {
      int g = q / (S * (S / T)), r = (q / (S / T)) % S, tc = q % (S / T);
      int v[T];
      int* row = &sm.wa[g][r * S + tc * T];
#pragma unroll
      for (int i = 0; i < T; ++i) v[i] = row[i];
#pragma unroll
      for (int h = 1; h < T; h <<= 1)
#pragma unroll
        for (int i = 0; i < T; ++i)
          if (!(i & h)) { int a = v[i], b = v[i + h]; v[i] = a + b; v[i + h] = a - b; }
#pragma unroll
      for (int i = 0; i < T; ++i) row[i] = v[i];
    }
    __syncthreads();
    // Hadamard along each column segment, absolute sum into the tile
    for (int q = threadIdx.x; q < G * (S / T) * S; q += blockDim.x) {
      int g = q / ((S / T) * S), tr = (q / S) % (S / T), c = q % S;
      int v[T];
#pragma unroll
      for (int i = 0; i < T; ++i) v[i] = sm.wa[g][(tr * T + i) * S + c];
#pragma unroll
      for (int h = 1; h < T; h <<= 1)
#pragma unroll
        for (int i = 0; i < T; ++i)
          if (!(i & h)) { int a = v[i], b = v[i + h]; v[i] = a + b; v[i + h] = a - b; }
      int sum = 0;
#pragma unroll
      for (int i = 0; i < T; ++i) sum += v[i] < 0 ? -v[i] : v[i];
      atomicAdd(&tile[g][tr * (S / T) + c / T], sum);
    }
    __syncthreads();
    // HM normalisation per tile, summed over the block
    for (int q = threadIdx.x; q < G * NT; q += blockDim.x) {
      int g = q / NT, t = q % NT;
      int sum = tile[g][t];
      tile[g][t] = 0;
      atomicAdd(&satd[g][mode], T == 8 ? (sum + 2) >> 2 : (sum + 1) >> 1);
    }
  }
  __syncthreads();

  if (want_satd)
    for (int q = threadIdx.x; q < G * 35; q += blockDim.x)
      if (n0 + q / 35 < n) out_satd[(size_t)(n0 + q / 35) * 35 + q % 35] = satd[q / 35][q % 35];
  if (k == 0) {     // SATD-only: integer argmin, ties to the lowest mode
    if ((int)threadIdx.x < G && n0 + (int)threadIdx.x < n) {
      int g = threadIdx.x, best = 0;
      for (int m = 1; m < 35; ++m) if (satd[g][m] < satd[g][best]) best = m;
      out_mode[n0 + g] = best;
    }
    return;
  }
  // top-k modes by float32 SATD, ascending, ties to the lowest mode
  if ((int)threadIdx.x < G) {
    int g = threadIdx.x;
    float sv[35];
    for (int m = 0; m < 35; ++m) sv[m] = __int2float_rn(satd[g][m]);
    for (int j = 0; j < k; ++j) {
      int best = 0;
      for (int m = 1; m < 35; ++m) if (sv[m] < sv[best]) best = m;
      top[g][j] = best;
      sv[best] = __int_as_float(0x7f800000);
    }
  }
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    candidate_chain<S, G>(sm, p, [&](int g) { return top[g][j]; });
    if ((int)threadIdx.x < G) {
      int g = threadIdx.x;
      float dist = __int2float_rn((int)sm.dist[g]);
      sm.dist[g] = 0;
      float bits = __fadd_rn(take_bits<S, G>(sm, g, model), model[MODEL_MODE_BITS]);
      cost[g][j] = __fmaf_rn(lam, bits, dist);
    }
    __syncthreads();
  }
  // RD-ranked top 3 of the k candidates
  if ((int)threadIdx.x < G && n0 + (int)threadIdx.x < n) {
    int g = threadIdx.x, nb = n0 + g;
    float cv[4];
    for (int j = 0; j < k; ++j) cv[j] = cost[g][j];
    for (int r = 0; r < 3; ++r) {
      int best = 0;
      for (int j = 1; j < k; ++j) if (cv[j] < cv[best]) best = j;
      out_top3[(size_t)nb * 3 + r] = top[g][best];
      if (r == 0) {
        out_mode[nb] = top[g][best];
        out_cost[nb] = cv[best];
      }
      cv[best] = __int_as_float(0x7f800000);
    }
  }
}

template <int S, int G>
__global__ void __launch_bounds__(kThreads)
cand_rd_kernel(const int* __restrict__ bufs, const int* __restrict__ blocks,
               const int* __restrict__ modes, int n, int K, TqParams p,
               const int* __restrict__ tm, const int* __restrict__ ang,
               const float* __restrict__ model, float* __restrict__ out_dist,
               float* __restrict__ out_bits) {
  __shared__ BlockSmem<S, G> sm;
  __shared__ int mode[G];
  const int n0 = blockIdx.x * G;
  load_blocks<S, G>(sm, bufs, blocks, n0, n, tm, ang);
  for (int j = 0; j < K; ++j) {
    if ((int)threadIdx.x < G)
      mode[threadIdx.x] = n0 + (int)threadIdx.x < n ? modes[(size_t)(n0 + threadIdx.x) * K + j] : 0;
    __syncthreads();
    candidate_chain<S, G>(sm, p, [&](int g) { return mode[g]; });
    if ((int)threadIdx.x < G) {
      int g = threadIdx.x;
      float dist = __int2float_rn((int)sm.dist[g]);
      sm.dist[g] = 0;
      float bits = take_bits<S, G>(sm, g, model);
      if (n0 + g < n) {
        out_dist[(size_t)(n0 + g) * K + j] = dist;
        out_bits[(size_t)(n0 + g) * K + j] = bits;
      }
    }
    __syncthreads();
  }
}

template <int S>
static void launch_size_rd(const int* bufs, const int* blocks, int n,
                           const TqParams& p, const int* tm, const int* ang,
                           const float* model, float lam, int k,
                           int want_satd, int* out_mode, float* out_cost,
                           int* out_top3, int* out_satd, cudaStream_t st) {
  constexpr int G = Group<S>::G;
  size_rd_kernel<S, G><<<(n + G - 1) / G, kThreads, 0, st>>>(
      bufs, blocks, n, p, tm, ang, model, lam, k, want_satd, out_mode,
      out_cost, out_top3, out_satd);
}

template <int S>
static void launch_cand_rd(const int* bufs, const int* blocks,
                           const int* modes, int n, int K, const TqParams& p,
                           const int* tm, const int* ang, const float* model,
                           float* out_dist, float* out_bits,
                           cudaStream_t st) {
  constexpr int G = Group<S>::G;
  cand_rd_kernel<S, G><<<(n + G - 1) / G, kThreads, 0, st>>>(
      bufs, blocks, modes, n, K, p, tm, ang, model, out_dist, out_bits);
}

}  // namespace hm

extern "C" int hm_intra_size_rd(const int* bufs, const int* blocks, int n,
                                const hm::TqParams* p, const int* tm,
                                const int* ang, const float* model,
                                float lam, int k, int want_satd,
                                int* out_mode, float* out_cost,
                                int* out_top3, int* out_satd, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || k < 0 || k > 4) return (int)cudaErrorInvalidValue;
  switch (p->s) {
    case 4: hm::launch_size_rd<4>(bufs, blocks, n, *p, tm, ang, model, lam, k, want_satd, out_mode, out_cost, out_top3, out_satd, st); break;
    case 8: hm::launch_size_rd<8>(bufs, blocks, n, *p, tm, ang, model, lam, k, want_satd, out_mode, out_cost, out_top3, out_satd, st); break;
    case 16: hm::launch_size_rd<16>(bufs, blocks, n, *p, tm, ang, model, lam, k, want_satd, out_mode, out_cost, out_top3, out_satd, st); break;
    case 32: hm::launch_size_rd<32>(bufs, blocks, n, *p, tm, ang, model, lam, k, want_satd, out_mode, out_cost, out_top3, out_satd, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int hm_intra_cand_rd(const int* bufs, const int* blocks,
                                const int* modes, int n, int K,
                                const hm::TqParams* p, const int* tm,
                                const int* ang, const float* model,
                                float* out_dist, float* out_bits,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  switch (p->s) {
    case 4: hm::launch_cand_rd<4>(bufs, blocks, modes, n, K, *p, tm, ang, model, out_dist, out_bits, st); break;
    case 8: hm::launch_cand_rd<8>(bufs, blocks, modes, n, K, *p, tm, ang, model, out_dist, out_bits, st); break;
    case 16: hm::launch_cand_rd<16>(bufs, blocks, modes, n, K, *p, tm, ang, model, out_dist, out_bits, st); break;
    case 32: hm::launch_cand_rd<32>(bufs, blocks, modes, n, K, *p, tm, ang, model, out_dist, out_bits, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* hm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// the argument struct's size, checked against its ctypes mirror
extern "C" size_t hm_sizeof_tq_params() { return sizeof(hm::TqParams); }
