// K5 inter_me: dense integer motion estimation for every reference and every
// block of each CU shape.  Two callers, which differ only in the bit model
// that prices the MV and in their outputs:
//
// - the P/B plan (`_int_me_grids`, `_me_shape`, hm16_2_tpu/encode/
//   inter_plan.py:134-287): squares 8..64 and the 2NxN / Nx2N PUs of
//   16..64, priced by exact MVD bins (`mvd_bits`), MVs out;
// - the fallback's frame ME (`me_frame`, hm16_2_tpu/encode/inter_me.py:47):
//   squares 8..64, priced by 2*log2(|d| + 1) + 1 per component (`mv_bits`,
//   computed with XLA:CPU's float32 log), MVs and their costs out.
//
// Launches: the 4x box downsample of the current picture and the
// references; the coarse SSD of every 8x8 block at 33x33 offsets of the
// downsampled planes (edge indices clamped, in place of the reference's
// edge padding); the float32 pyramid sums to 16/32/64; per block shape, the
// coarse argmin of g + lamf * bits (rect shapes sum two half-size cells on
// the fly); the +-3 full-pel SSE refinement around the coarse winner and
// around zero.
//
// Band mode, for both callers (`plan_shard.sharded_int_me`,
// `me_shard.sharded_me_frame`, hm16_2_tpu/parallel/): the current picture is
// one row band starting at picture row row0 (a multiple of 64), the
// references are the whole pictures.  The coarse window reads the
// downsampled reference at coarse row rc0 + y (rc0 = row0 / 4) and clamps at
// its full height fhc; the refinement reads picture row row0 + y and clamps
// at the full height.  With row0 = 0 and the full height equal to the
// band's, the launches are the whole-picture ones.
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

// XLA:CPU's float32 natural log for a positive normal x: the Cephes
// polynomial of its LLVM IR, with every product that has one use fused into
// the add that consumes it, as its backend contracts them
__device__ __forceinline__ float xla_logf(float x) {
  int b = __float_as_int(x);
  int e = (int)((unsigned)b >> 23) - 127;
  float m = __int_as_float((b & 0x807FFFFF) | 0x3F000000);   // [0.5, 1)
  float ef = __fadd_rn(1.f, __int2float_rn(e));
  bool lo = m < 0x1.6a09e6p-1f;                             // sqrt(1/2)
  float xx = __fadd_rn(__fsub_rn(m, 1.f), lo ? m : 0.f);
  ef = __fsub_rn(ef, lo ? 1.f : 0.f);
  float x2 = __fmul_rn(xx, xx), x3 = __fmul_rn(x2, xx);
  float y = __fmaf_rn(xx, 0x1.204376p-4f, -0x1.d7a37p-4f);
  float y1 = __fmaf_rn(xx, -0x1.fcba9ep-4f, 0x1.23d37ep-3f);
  float y2 = __fmaf_rn(xx, 0x1.999d58p-3f, -0x1.fffff8p-3f);
  y = __fmaf_rn(y, xx, 0x1.de4a34p-4f);
  y1 = __fmaf_rn(y1, xx, -0x1.555ca0p-3f);
  y2 = __fmaf_rn(y2, xx, 0x1.555554p-2f);
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(-0x1.bd0106p-13f, ef));
  float r = __fadd_rn(__fsub_rn(xx, __fmul_rn(0.5f, x2)), y);
  return __fmaf_rn(0x1.63p-1f, ef, r);
}

// me_frame's bits of one full-pel-domain MV delta component,
// 2*log2(|d| + 1) + 1: log2 is ln * 1.44269502, the 2 folded into that
// constant, the + 1 fused
__device__ __forceinline__ float mv_comp_bits(int d) {
  int a = d < 0 ? -d : d;
  return __fmaf_rn(xla_logf(__fadd_rn(__int2float_rn(a), 1.f)),
                   0x1.715476p+1f, 1.f);
}

// the two bit models, a template parameter of the argmin and refinement
struct MvdBins {           // the plan: exact MVD bins
  __device__ static float bits(int dx, int dy) { return mvd_bits(dx, dy); }
};
struct MvLog {             // me_frame: the approximate log model
  __device__ static float bits(int dx, int dy) {
    return __fadd_rn(mv_comp_bits(dy), mv_comp_bits(dx));
  }
};

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

// cd: (hc, wc) downsampled band; rd: (R, fhc, wc) downsampled references
__global__ void me_coarse8_kernel(const int* __restrict__ cd,
                                  const int* __restrict__ rd, int R, int hc,
                                  int wc, int fhc, int rc0, int n8y, int n8x,
                                  float* __restrict__ g8) {
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)R * kNOff * n8y * n8x;
  if (q >= total) return;
  int bx = q % n8x, by = (q / n8x) % n8y;
  int o = (q / ((long long)n8x * n8y)) % kNOff;
  int r = q / ((long long)kNOff * n8y * n8x);
  int oy = o / (2 * kCoarseR + 1) - kCoarseR;
  int ox = o % (2 * kCoarseR + 1) - kCoarseR;
  const int* ref = rd + (size_t)r * fhc * wc;
  int sum = 0;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      int cy = 2 * by + i, cx = 2 * bx + j;
      int d = cd[cy * wc + cx] -
              ref[clampi(rc0 + cy + oy, 0, fhc - 1) * wc +
                  clampi(cx + ox, 0, wc - 1)];
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
template <class Bits>
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
    float c = __fmaf_rn(lam, Bits::bits(4 * (ox - px), 4 * (oy - py)), v);
    if (o == 0 || c < best_v) { best = o; best_v = c; }
  }
  coarse[q * 2] = 4 * (best / (2 * kCoarseR + 1) - kCoarseR);
  coarse[q * 2 + 1] = 4 * (best % (2 * kCoarseR + 1) - kCoarseR);
}

// +-3 full-pel SSE refinement around the coarse winner and around zero;
// one CTA per (block, reference): grid (N, R).  cur: the band (w wide) whose
// first row is picture row row0; refs: (R, rh, w) whole pictures.  cost_out,
// when given, receives the winner's cost beside its MV.
template <class Bits>
__global__ void me_refine_kernel(const int* __restrict__ cur, int w,
                                 const int* __restrict__ refs, int row0,
                                 int rh, int bh, int bw,
                                 int Nx, const int* __restrict__ coarse,
                                 const int* __restrict__ mvp, float lam,
                                 int* __restrict__ out,
                                 float* __restrict__ cost_out) {
  __shared__ int sse[2][kNRef];
  int n = blockIdx.x, r = blockIdx.y, N = gridDim.x;
  for (int q = threadIdx.x; q < 2 * kNRef; q += blockDim.x)
    sse[q / kNRef][q % kNRef] = 0;
  __syncthreads();
  size_t e = (size_t)r * N + n;
  int cy0 = coarse[e * 2], cx0 = coarse[e * 2 + 1];
  int by = (n / Nx) * bh, bx = (n % Nx) * bw;
  const int* ref = refs + (size_t)r * rh * w;
  int npx = bh * bw;                        // a multiple of 32: one
  bool shift = npx >= 4096;                 // candidate per warp pass
  int total = 2 * kNRef * npx;
  for (int q = threadIdx.x; q < total; q += blockDim.x) {
    int pix = q % npx, cand = q / npx;
    int cc = cand / kNRef, k = cand % kNRef;
    int cy = cc == 0 ? cy0 : 0, cx = cc == 0 ? cx0 : 0;
    int y = by + pix / bw, x = bx + pix % bw;
    int ry = clampi(row0 + y + cy + k / 7 - kRefineR, 0, rh - 1);
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
        float c = __fmaf_rn(lam, Bits::bits(4 * (mx - px), 4 * (my - py)),
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
    if (cost_out) cost_out[e] = cost[pick];
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

// fhc: the downsampled references' height; rc0: the band's first coarse row
extern "C" int hm_me_coarse8(const int* cd, const int* rd, int R, int hc,
                             int wc, int fhc, int rc0, int n8y, int n8x,
                             float* g8, void* stream) {
  if (R <= 0 || n8y <= 0 || n8x <= 0 || rc0 < 0 || rc0 + hc > fhc)
    return (int)cudaErrorInvalidValue;
  hm::me_coarse8_kernel<<<hm::blocks_of((long long)R * hm::kNOff * n8y * n8x),
                          256, 0, (cudaStream_t)stream>>>(cd, rd, R, hc, wc,
                                                          fhc, rc0, n8y, n8x,
                                                          g8);
  return (int)cudaGetLastError();
}

extern "C" int hm_me_quad(const float* p, long long RO, int py, int px,
                          int ny, int nx, float* out, void* stream) {
  if (RO <= 0 || ny <= 0 || nx <= 0) return (int)cudaErrorInvalidValue;
  hm::me_quad_kernel<<<hm::blocks_of(RO * ny * nx), 256, 0,
                       (cudaStream_t)stream>>>(p, RO, py, px, ny, nx, out);
  return (int)cudaGetLastError();
}

// model 0: the plan's MVD bins; 1: me_frame's log model
extern "C" int hm_me_argmin(const float* g, int gy, int gx, int mode, int R,
                            int Ny, int Nx, const int* mvp, float lam,
                            int model, int* coarse, void* stream) {
  if (R <= 0 || Ny <= 0 || Nx <= 0 || mode < 0 || mode > 2 || model < 0 ||
      model > 1)
    return (int)cudaErrorInvalidValue;
  unsigned nb = hm::blocks_of((long long)R * Ny * Nx);
  if (model == 0)
    hm::me_argmin_kernel<hm::MvdBins><<<nb, 256, 0, (cudaStream_t)stream>>>(
        g, gy, gx, mode, R, Ny, Nx, mvp, lam, coarse);
  else
    hm::me_argmin_kernel<hm::MvLog><<<nb, 256, 0, (cudaStream_t)stream>>>(
        g, gy, gx, mode, R, Ny, Nx, mvp, lam, coarse);
  return (int)cudaGetLastError();
}

// model as hm_me_argmin; cost may be null; cur: the band of rows row0.. of
// the picture, refs: (R, rh, w) whole references
extern "C" int hm_me_refine(const int* cur, int w, const int* refs, int row0,
                            int rh, int R, int bh, int bw, int Ny, int Nx,
                            const int* coarse, const int* mvp, float lam,
                            int model, int* out, float* cost, void* stream) {
  if (R <= 0 || Ny <= 0 || Nx <= 0 || (bh * bw) % 32 != 0 || model < 0 ||
      model > 1 || row0 < 0 || row0 + Ny * bh > rh)
    return (int)cudaErrorInvalidValue;
  dim3 grid(Ny * Nx, R);
  if (model == 0)
    hm::me_refine_kernel<hm::MvdBins><<<grid, 128, 0, (cudaStream_t)stream>>>(
        cur, w, refs, row0, rh, bh, bw, Nx, coarse, mvp, lam, out, cost);
  else
    hm::me_refine_kernel<hm::MvLog><<<grid, 128, 0, (cudaStream_t)stream>>>(
        cur, w, refs, row0, rh, bh, bw, Nx, coarse, mvp, lam, out, cost);
  return (int)cudaGetLastError();
}
