// K5 inter_me: dense integer motion estimation of the P-picture plan, for
// every reference and every block of each CU shape (squares 8..64, the
// 2NxN / Nx2N PUs of 16..64).
//
// Replaces `_int_me_grids` and `_me_shape` (hm16_2_tpu/encode/inter_plan.py
// :134-287).  Launches: the 4x box downsample of the current picture and
// the references; the coarse SSD of every 8x8 block at 33x33 offsets of the
// downsampled planes (edge indices clamped, in place of the reference's
// edge padding); the float32 pyramid sums to 16/32/64; per block shape, the
// coarse argmin of g + lamf * MVD bins (rect shapes sum two half-size
// cells on the fly); the +-3 full-pel SSE refinement around the coarse
// winner and around zero.
//
// What bounds it: the coarse grid, 1089 offsets x 4 samples per 8x8 block
// and reference (at 1080p with 4 references, 141M float32 = 564 MB written
// and read back by the argmins), and the refinement's 98 candidate SSEs per
// block.  Design, simple first: one thread per grid entry, one thread per
// (reference, block) for the coarse argmin (consecutive blocks read
// consecutive grid entries), one CTA per (reference, block) for the
// refinement with a warp sum per candidate and integer atomics, so every
// sum is order-independent and exact.  Costs follow XLA:CPU's rounding: both
// cost sites are fused multiply-adds (`__fmaf_rn`, file built with
// --fmad=false); argmins keep the lowest index on ties and the coarse-centred
// candidate wins an equal cost.
#include "intra_common.cuh"

namespace hm {

constexpr int kCoarseR = 16;
constexpr int kNOff = (2 * kCoarseR + 1) * (2 * kCoarseR + 1);
constexpr int kRefineR = 3;
constexpr int kNRef = (2 * kRefineR + 1) * (2 * kRefineR + 1);

__global__ void me_down_kernel(const int* __restrict__ src, int P, int h,
                               int w, int hc, int wc, int* __restrict__ out) {
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)P * hc * wc) return;
  int x = q % wc, y = (q / wc) % hc, p = q / ((long long)wc * hc);
  const int* s = src + (size_t)p * h * w + (size_t)(4 * y) * w + 4 * x;
  int sum = 0;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) sum += s[i * w + j];
  out[q] = sum >> 4;                 // non-negative: floor division by 16
}

__global__ void me_coarse8_kernel(const int* __restrict__ cd,
                                  const int* __restrict__ rd, int R, int hc,
                                  int wc, int n8y, int n8x,
                                  float* __restrict__ g8) {
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)R * kNOff * n8y * n8x;
  if (q >= total) return;
  int bx = q % n8x, by = (q / n8x) % n8y;
  int o = (q / ((long long)n8x * n8y)) % kNOff;
  int r = q / ((long long)kNOff * n8y * n8x);
  int oy = o / (2 * kCoarseR + 1) - kCoarseR;
  int ox = o % (2 * kCoarseR + 1) - kCoarseR;
  const int* ref = rd + (size_t)r * hc * wc;
  int sum = 0;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      int cy = 2 * by + i, cx = 2 * bx + j;
      int d = cd[cy * wc + cx] -
              ref[clampi(cy + oy, 0, hc - 1) * wc + clampi(cx + ox, 0, wc - 1)];
      sum += d * d;
    }
  g8[q] = __int2float_rn(sum);
}

// (RO, ny, nx) sums of 2x2 cells of a (RO, py, px) grid, in the reference's
// order ((a00 + a01) + a10) + a11
__global__ void me_quad_kernel(const float* __restrict__ p, long long RO,
                               int py, int px, int ny, int nx,
                               float* __restrict__ out) {
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= RO * ny * nx) return;
  int x = q % nx, y = (q / nx) % ny;
  long long ro = q / ((long long)nx * ny);
  const float* a = p + ro * py * px + (size_t)(2 * y) * px + 2 * x;
  out[q] = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[px]), a[px + 1]);
}

// coarse argmin per (reference, block) of one shape.  mode 0: the grid is
// the shape's own (R, O, gy, gx); mode 1 (2NxN): sum of x-pairs of the half
// grid; mode 2 (Nx2N): sum of y-pairs.  mvp: (R, Ny, Nx, 2) full-pel prior.
__global__ void me_argmin_kernel(const float* __restrict__ g, int gy, int gx,
                                 int mode, int R, int Ny, int Nx,
                                 const int* __restrict__ mvp, float lam,
                                 int* __restrict__ coarse) {
  int N = Ny * Nx;
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)R * N) return;
  int n = q % N, r = q / N, by = n / Nx, bx = n % Nx;
  int py = mvp[q * 2], px = mvp[q * 2 + 1];
  const float* gr = g + (size_t)r * kNOff * gy * gx;
  int best = 0;
  float best_v = 0.f;
  for (int o = 0; o < kNOff; ++o) {
    const float* go = gr + (size_t)o * gy * gx;
    float v = mode == 0 ? go[by * gx + bx]
            : mode == 1 ? __fadd_rn(go[by * gx + 2 * bx], go[by * gx + 2 * bx + 1])
                        : __fadd_rn(go[(2 * by) * gx + bx], go[(2 * by + 1) * gx + bx]);
    int oy = o / (2 * kCoarseR + 1) - kCoarseR;
    int ox = o % (2 * kCoarseR + 1) - kCoarseR;
    float c = __fmaf_rn(lam, mvd_bits(4 * (ox - px), 4 * (oy - py)), v);
    if (o == 0 || c < best_v) { best = o; best_v = c; }
  }
  coarse[q * 2] = 4 * (best / (2 * kCoarseR + 1) - kCoarseR);
  coarse[q * 2 + 1] = 4 * (best % (2 * kCoarseR + 1) - kCoarseR);
}

// +-3 full-pel SSE refinement around the coarse winner and around zero;
// one CTA per (block, reference): grid (N, R)
__global__ void me_refine_kernel(const int* __restrict__ cur, int h, int w,
                                 const int* __restrict__ refs, int bh, int bw,
                                 int Nx, const int* __restrict__ coarse,
                                 const int* __restrict__ mvp, float lam,
                                 int* __restrict__ out) {
  __shared__ int sse[2][kNRef];
  int n = blockIdx.x, r = blockIdx.y, N = gridDim.x;
  for (int q = threadIdx.x; q < 2 * kNRef; q += blockDim.x)
    sse[q / kNRef][q % kNRef] = 0;
  __syncthreads();
  size_t e = (size_t)r * N + n;
  int cy0 = coarse[e * 2], cx0 = coarse[e * 2 + 1];
  int by = (n / Nx) * bh, bx = (n % Nx) * bw;
  const int* ref = refs + (size_t)r * h * w;
  int npx = bh * bw;                        // a multiple of 32: one
  bool shift = npx >= 4096;                 // candidate per warp pass
  int total = 2 * kNRef * npx;
  for (int q = threadIdx.x; q < total; q += blockDim.x) {
    int pix = q % npx, cand = q / npx;
    int cc = cand / kNRef, k = cand % kNRef;
    int cy = cc == 0 ? cy0 : 0, cx = cc == 0 ? cx0 : 0;
    int y = by + pix / bw, x = bx + pix % bw;
    int ry = clampi(y + cy + k / 7 - kRefineR, 0, h - 1);
    int rx = clampi(x + cx + k % 7 - kRefineR, 0, w - 1);
    int d = cur[y * w + x] - ref[ry * w + rx];
    int sq = d * d;
    if (shift) sq >>= 2;
    int v = __reduce_add_sync(0xffffffffu, sq);
    if ((threadIdx.x & 31) == 0) atomicAdd(&sse[cc][k], v);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int py = mvp[e * 2], px = mvp[e * 2 + 1];
    int mv[2][2];
    float cost[2];
    for (int cc = 0; cc < 2; ++cc) {
      int cy = cc == 0 ? cy0 : 0, cx = cc == 0 ? cx0 : 0;
      int best = 0;
      float best_v = 0.f;
      for (int k = 0; k < kNRef; ++k) {
        int my = cy + k / 7 - kRefineR, mx = cx + k % 7 - kRefineR;
        float c = __fmaf_rn(lam, mvd_bits(4 * (mx - px), 4 * (my - py)),
                            __int2float_rn(sse[cc][k]));
        if (k == 0 || c < best_v) { best = k; best_v = c; }
      }
      mv[cc][0] = cy + best / 7 - kRefineR;
      mv[cc][1] = cx + best % 7 - kRefineR;
      cost[cc] = best_v;
    }
    int pick = cost[0] <= cost[1] ? 0 : 1;
    out[e * 2] = mv[pick][0];
    out[e * 2 + 1] = mv[pick][1];
  }
}

static unsigned blocks_of(long long n) { return (unsigned)((n + 255) / 256); }

}  // namespace hm

extern "C" int hm_me_down(const int* src, int P, int h, int w, int hc, int wc,
                          int* out, void* stream) {
  if (P <= 0 || hc <= 0 || wc <= 0) return (int)cudaErrorInvalidValue;
  hm::me_down_kernel<<<hm::blocks_of((long long)P * hc * wc), 256, 0,
                       (cudaStream_t)stream>>>(src, P, h, w, hc, wc, out);
  return (int)cudaGetLastError();
}

extern "C" int hm_me_coarse8(const int* cd, const int* rd, int R, int hc,
                             int wc, int n8y, int n8x, float* g8,
                             void* stream) {
  if (R <= 0 || n8y <= 0 || n8x <= 0) return (int)cudaErrorInvalidValue;
  hm::me_coarse8_kernel<<<hm::blocks_of((long long)R * hm::kNOff * n8y * n8x),
                          256, 0, (cudaStream_t)stream>>>(cd, rd, R, hc, wc,
                                                          n8y, n8x, g8);
  return (int)cudaGetLastError();
}

extern "C" int hm_me_quad(const float* p, long long RO, int py, int px,
                          int ny, int nx, float* out, void* stream) {
  if (RO <= 0 || ny <= 0 || nx <= 0) return (int)cudaErrorInvalidValue;
  hm::me_quad_kernel<<<hm::blocks_of(RO * ny * nx), 256, 0,
                       (cudaStream_t)stream>>>(p, RO, py, px, ny, nx, out);
  return (int)cudaGetLastError();
}

extern "C" int hm_me_argmin(const float* g, int gy, int gx, int mode, int R,
                            int Ny, int Nx, const int* mvp, float lam,
                            int* coarse, void* stream) {
  if (R <= 0 || Ny <= 0 || Nx <= 0 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  hm::me_argmin_kernel<<<hm::blocks_of((long long)R * Ny * Nx), 256, 0,
                         (cudaStream_t)stream>>>(g, gy, gx, mode, R, Ny, Nx,
                                                 mvp, lam, coarse);
  return (int)cudaGetLastError();
}

extern "C" int hm_me_refine(const int* cur, int h, int w, const int* refs,
                            int R, int bh, int bw, int Ny, int Nx,
                            const int* coarse, const int* mvp, float lam,
                            int* out, void* stream) {
  if (R <= 0 || Ny <= 0 || Nx <= 0 || (bh * bw) % 32 != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(Ny * Nx, R);
  hm::me_refine_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      cur, h, w, refs, bh, bw, Nx, coarse, mvp, lam, out);
  return (int)cudaGetLastError();
}
