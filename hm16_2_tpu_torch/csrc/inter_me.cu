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
// What bounds it on the H100.  The coarse argmin reads the grid once (1089
// float32 per block and reference; 564 MB for the 8x8 shape at 1080p with
// four references): bytes, if enough offsets are in flight.  One thread per
// (reference, block) walking all 1089 offsets leaves a 64x64 shape with 15
// CTAs of dependent 1089-step chains, and a row band with fewer still, so
// the argmin here gives each block 16 threads: a CTA takes 32 consecutive
// blocks of one reference (lane = block, so a warp reads 32 neighbouring
// grid cells) times 16 contiguous slices of the offsets (one warp each).
// Each block's 33 x and 33 y component bits are tabulated once per CTA in
// shared memory (the bits are separable; the log model's ln runs 66 times a
// block, not 2178), summed with the one rounded add of the reference.  The
// refinement is integer ALU work, 98 candidate SSEs over the block: it
// stages the block and its two (bh+6) x (bw+6) windows (clamped at load)
// in shared memory once, by asynchronous 4-byte copies (cp.async) whose
// sources a row table gives, and each thread owns one (centre, dx, column)
// and slides down the rows with a seven-row register ring, so it keeps the
// seven dy sums in registers; one shuffle reduction per candidate and warp
// replaces the old per-32-pixel warp sum and shared atomic, and a warp per
// block takes the two 49-way argmins.  Small shapes pack 2-4 blocks into a
// CTA (never fewer than 14 warps).
//
// Invariants (the tests hold each): argmins give ties to the lowest index
// (each offset slice keeps its first minimum and the slices merge in order
// with a strict <; the 49-way warp argmins compare (cost, index) pairs) and
// the coarse-centred candidate wins an equal cost; SSEs are int32 sums that
// wrap like the reference's (unsigned accumulation, the 64x64 >> 2 before
// the sum); both cost sites are fused multiply-adds (`__fmaf_rn`, file
// built with --fmad=false) of float32 bits and __int2float_rn of the
// wrapped sum.
#include "intra_common.cuh"

namespace hm {

constexpr int kCoarseR = 16;
constexpr int kCoarseN = 2 * kCoarseR + 1;
constexpr int kNOff = kCoarseN * kCoarseN;
constexpr int kRefineR = 3;
constexpr int kRefineN = 2 * kRefineR + 1;
constexpr int kNRef = kRefineN * kRefineN;

// the coarse argmin's CTA: kArgLanes blocks x kArgGroups offset slices
constexpr int kArgLanes = 32;
constexpr int kArgGroups = 16;
constexpr int kArgSpan = (kNOff + kArgGroups - 1) / kArgGroups;
static_assert((kArgGroups - 1) * kArgSpan < kNOff, "an empty offset slice");

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

// the two bit models, a template parameter of the argmin and refinement:
// the bits of one MV delta component
struct MvdBins {           // the plan: exact MVD bins
  __device__ static float comp(int d) { return mvd_comp_bits(d); }
};
struct MvLog {             // me_frame: the approximate log model
  __device__ static float comp(int d) { return mv_comp_bits(d); }
};

// the bits of an MV delta: its two components' bits, one rounded add
template <class Bits>
__device__ __forceinline__ float mv_bits(int dx, int dy) {
  return __fadd_rn(Bits::comp(dx), Bits::comp(dy));
}

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
  int oy = o / kCoarseN - kCoarseR;
  int ox = o % kCoarseN - kCoarseR;
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
// CTA (kArgLanes, kArgGroups), grid (ceil(N / kArgLanes), R): lane = block
// blockIdx.x * kArgLanes + x, warp y = the offsets [y * span, (y + 1) *
// span).
template <class Bits>
__global__ void __launch_bounds__(kArgLanes * kArgGroups)
me_argmin_kernel(const float* __restrict__ g, int gy, int gx, int mode,
                 int Ny, int Nx, const int* __restrict__ mvp, float lam,
                 int* __restrict__ coarse) {
  __shared__ float bits_x[kCoarseN][kArgLanes], bits_y[kCoarseN][kArgLanes];
  __shared__ float part_c[kArgGroups][kArgLanes];
  __shared__ int part_o[kArgGroups][kArgLanes];
  const int N = Ny * Nx, r = blockIdx.y;
  const int lane = threadIdx.x, grp = threadIdx.y;
  const int n0 = blockIdx.x * kArgLanes, n = n0 + lane;
  // the component bits of the 33 x and 33 y offsets of each block
  for (int q = grp * kArgLanes + lane; q < 2 * kCoarseN * kArgLanes;
       q += kArgLanes * kArgGroups) {
    int l = q % kArgLanes, j = (q / kArgLanes) % kCoarseN;
    bool is_y = q >= kCoarseN * kArgLanes;
    float b = 0.f;
    if (n0 + l < N) {
      size_t e = (size_t)r * N + n0 + l;
      b = Bits::comp(4 * (j - kCoarseR - mvp[e * 2 + (is_y ? 0 : 1)]));
    }
    (is_y ? bits_y : bits_x)[j][l] = b;
  }
  __syncthreads();
  // this warp's slice of the offsets, the first least cost
  const int o0 = grp * kArgSpan, o1 = min(o0 + kArgSpan, kNOff);
  float best_c = 0.f;
  int best_o = o0;
  if (n < N) {
    int by = n / Nx, bx = n % Nx;
    size_t cell = mode == 0 ? (size_t)by * gx + bx
                : mode == 1 ? (size_t)by * gx + 2 * bx
                            : (size_t)(2 * by) * gx + bx;
    const size_t plane = (size_t)gy * gx, second = mode == 1 ? 1 : gx;
    const float* go = g + ((size_t)r * kNOff + o0) * plane + cell;
    int oy = o0 / kCoarseN, ox = o0 % kCoarseN;
#pragma unroll 4
    for (int o = o0; o < o1; ++o, go += plane) {
      float v = mode == 0 ? go[0] : __fadd_rn(go[0], go[second]);
      float c = __fmaf_rn(lam, __fadd_rn(bits_x[ox][lane], bits_y[oy][lane]),
                          v);
      if (o == o0 || c < best_c) { best_c = c; best_o = o; }
      if (++ox == kCoarseN) { ox = 0; ++oy; }
    }
  }
  part_c[grp][lane] = best_c;
  part_o[grp][lane] = best_o;
  __syncthreads();
  // slices in offset order, strict <: the lowest offset among equal costs
  if (grp == 0 && n < N) {
    float c = part_c[0][lane];
    int o = part_o[0][lane];
    for (int k = 1; k < kArgGroups; ++k)
      if (part_c[k][lane] < c) { c = part_c[k][lane]; o = part_o[k][lane]; }
    size_t e = (size_t)r * N + n;
    coarse[e * 2] = 4 * (o / kCoarseN - kCoarseR);
    coarse[e * 2 + 1] = 4 * (o % kCoarseN - kCoarseR);
  }
}

// the refinement's CTA: refine_blocks(bw) blocks, each 2 centres x 7 dx x bw
// columns of threads; bw in {8, 16, 32, 64}
__host__ __device__ constexpr int refine_blocks(int bw) {
  return bw >= 32 ? 1 : 32 / bw;
}
__host__ __device__ constexpr int refine_threads(int bw) {
  return refine_blocks(bw) * 2 * kRefineN * bw;
}
constexpr int kRefineMaxThreads = refine_threads(64);

// shared memory of the refinement in bytes: the windows' row table (source
// offsets), the windows, the current blocks, the column partials, the
// costs, the blocks' (reference, y, x, cy, cx) and the rows' first columns
__host__ __device__ inline size_t refine_smem_bytes(int bh, int bw) {
  size_t nb = refine_blocks(bw), parts = bw > 32 ? bw / 32 : 1;
  size_t wh = bh + 2 * kRefineR, ww = bw + 2 * kRefineR, rows = nb * 2 * wh;
  return sizeof(long long) * rows +
         sizeof(int) * (rows * ww + nb * bh * bw + nb * 2 * kNRef * parts +
                        nb * 2 * kNRef + nb * 5 + rows);
}

// +-3 full-pel SSE refinement around the coarse winner and around zero of
// the (reference, block) pairs e = r * N + n.  cur: the band (w wide) whose
// first row is picture row row0; refs: (R, rh, w) whole pictures.  cost_out,
// when given, receives the winner's cost beside its MV.  bh, bw: powers of
// two.
template <class Bits>
__global__ void __launch_bounds__(kRefineMaxThreads)
me_refine_kernel(const int* __restrict__ cur, int w,
                 const int* __restrict__ refs, int row0, int rh, int bh,
                 int bw, int R, int N, int Nx,
                 const int* __restrict__ coarse, const int* __restrict__ mvp,
                 float lam, int* __restrict__ out,
                 float* __restrict__ cost_out) {
  extern __shared__ long long smem_ll[];
  const int nb = refine_blocks(bw), parts = bw > 32 ? bw / 32 : 1;
  const int wh = bh + 2 * kRefineR, ww = bw + 2 * kRefineR;
  const int npx = bh * bw, rows = nb * 2 * wh;
  const int lbw = __ffs(bw) - 1, lnpx = __ffs(npx) - 1;
  long long* rowoff = smem_ll;                  // [nb][2][wh]
  int* win = (int*)(rowoff + rows);             // [nb][2][wh][ww]
  int* cblk = win + rows * ww;                  // [nb][bh][bw]
  int* part = cblk + nb * npx;                  // [nb][2][49][parts]
  float* cost = (float*)(part + nb * 2 * kNRef * parts);   // [nb][2][49]
  int* meta = (int*)(cost + nb * 2 * kNRef);    // [nb]: r, y, x, cy, cx
  int* rowx = meta + nb * 5;                    // [nb][2][wh]
  const int e0 = blockIdx.x * nb, total = R * N;
  const int tid = threadIdx.x, nthr = blockDim.x;

  if (tid < nb) {
    int e = e0 + tid, *m = meta + tid * 5;
    m[0] = -1;
    if (e < total) {
      int n = e % N;
      m[0] = e / N;
      m[1] = (n / Nx) * bh;
      m[2] = (n % Nx) * bw;
      m[3] = coarse[e * 2];
      m[4] = coarse[e * 2 + 1];
    }
  }
  __syncthreads();

  // the current blocks, and each window row's source (the row clamped into
  // the whole reference as the reference's edge padding gives it)
  for (int q = tid; q < nb * npx; q += nthr) {
    const int* m = meta + (q >> lnpx) * 5;
    int p = q & (npx - 1);
    if (m[0] >= 0)
      cp_async4(cblk + q,
                cur + (size_t)(m[1] + (p >> lbw)) * w + m[2] + (p & (bw - 1)));
  }
  for (int rr = tid; rr < rows; rr += nthr) {
    int b = rr / (2 * wh), cc = (rr / wh) & 1, i = rr % wh;
    const int* m = meta + b * 5;
    int cy = cc == 0 ? m[3] : 0, cx = cc == 0 ? m[4] : 0;
    rowoff[rr] = m[0] < 0 ? -1 : ((long long)m[0] * rh + clampi(
        row0 + m[1] + cy - kRefineR + i, 0, rh - 1)) * w;
    rowx[rr] = m[2] + cx - kRefineR;
  }
  __syncthreads();

  // the windows, copied asynchronously: a thread per column, consecutive
  // threads on one row
  {
    const int j = tid % ww, step = nthr / ww;
    if (tid / ww < step) {
#pragma unroll 4
      for (int rr = tid / ww; rr < rows; rr += step) {
        long long off = rowoff[rr];
        if (off >= 0)
          cp_async4(win + rr * ww + j,
                    refs + off + clampi(rowx[rr] + j, 0, w - 1));
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // one (block, centre, dx, column) per thread: the seven dy sums of its
  // column in registers, the window column in a seven-row ring
  {
    const int x = tid & (bw - 1), dx = (tid >> lbw) % kRefineN;
    const int cc = (tid / (kRefineN * bw)) & 1, b = tid / (2 * kRefineN * bw);
    const int* cs = cblk + b * npx + x;
    const int* ws = win + (b * 2 + cc) * wh * ww + dx + x;
    const bool shift = npx >= 4096;
    unsigned acc[kRefineN];
    int ring[kRefineN];
#pragma unroll
    for (int k = 0; k < kRefineN; ++k) acc[k] = 0u;
#pragma unroll
    for (int k = 0; k < kRefineN - 1; ++k) ring[k + 1] = ws[k * ww];
    for (int y = 0; y < bh; ++y) {
#pragma unroll
      for (int k = 0; k < kRefineN - 1; ++k) ring[k] = ring[k + 1];
      ring[kRefineN - 1] = ws[(y + kRefineN - 1) * ww];
      const unsigned c = (unsigned)cs[y * bw];
#pragma unroll
      for (int dy = 0; dy < kRefineN; ++dy) {
        unsigned d = c - (unsigned)ring[dy];
        int sq = (int)(d * d);          // int32 d * d, wrapped
        if (shift) sq >>= 2;
        acc[dy] += (unsigned)sq;
      }
    }
    // sum the columns of each warp (groups of min(bw, 32) lanes)
    const int lanes = bw < 32 ? bw : 32;
#pragma unroll
    for (int dy = 0; dy < kRefineN; ++dy)
      for (int off = lanes / 2; off > 0; off >>= 1)
        acc[dy] += __shfl_xor_sync(0xffffffffu, acc[dy], off);
    if ((x & 31) == 0)
#pragma unroll
      for (int dy = 0; dy < kRefineN; ++dy)
        part[((b * 2 + cc) * kNRef + dy * kRefineN + dx) * parts + x / 32] =
            (int)acc[dy];
  }
  __syncthreads();

  // each candidate's cost
  for (int q = tid; q < nb * 2 * kNRef; q += nthr) {
    int b = q / (2 * kNRef), cc = (q / kNRef) & 1, k = q % kNRef;
    const int* m = meta + b * 5;
    if (m[0] < 0) continue;
    unsigned s = 0u;
    for (int p = 0; p < parts; ++p) s += (unsigned)part[q * parts + p];
    int e = e0 + b;
    int my = (cc == 0 ? m[3] : 0) + k / kRefineN - kRefineR;
    int mx = (cc == 0 ? m[4] : 0) + k % kRefineN - kRefineR;
    cost[q] = __fmaf_rn(lam, mv_bits<Bits>(4 * (mx - mvp[e * 2 + 1]),
                                           4 * (my - mvp[e * 2])),
                        __int2float_rn((int)s));
  }
  __syncthreads();

  // the two 49-way argmins (first least), a warp per block, and the pick
  // (the coarse centre on equal costs)
  const int b = tid >> 5;
  if (b < nb && meta[b * 5] >= 0) {
    const float *c0 = cost + b * 2 * kNRef, *c1 = c0 + kNRef;
    const int k0 = warp_argmin49(c0), k1 = warp_argmin49(c1);
    if ((tid & 31) == 0) {
      const int e = e0 + b, *m = meta + b * 5;
      bool coarse_wins = c0[k0] <= c1[k1];
      int k = coarse_wins ? k0 : k1;
      out[e * 2] = (coarse_wins ? m[3] : 0) + k / kRefineN - kRefineR;
      out[e * 2 + 1] = (coarse_wins ? m[4] : 0) + k % kRefineN - kRefineR;
      if (cost_out) cost_out[e] = coarse_wins ? c0[k0] : c1[k1];
    }
  }
}

static unsigned blocks_of(long long n) { return (unsigned)((n + 255) / 256); }

template <class Bits>
static int launch_refine(const int* cur, int w, const int* refs, int row0,
                         int rh, int R, int bh, int bw, int Ny, int Nx,
                         const int* coarse, const int* mvp, float lam,
                         int* out, float* cost, cudaStream_t st) {
  int N = Ny * Nx;
  size_t bytes = refine_smem_bytes(bh, bw);
  cudaError_t err = cudaFuncSetAttribute(
      me_refine_kernel<Bits>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int ctas = (R * N + refine_blocks(bw) - 1) / refine_blocks(bw);
  me_refine_kernel<Bits><<<ctas, refine_threads(bw), bytes, st>>>(
      cur, w, refs, row0, rh, bh, bw, R, N, Nx, coarse, mvp, lam, out, cost);
  return (int)cudaGetLastError();
}

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
  if (R <= 0 || R > 65535 || Ny <= 0 || Nx <= 0 || mode < 0 || mode > 2 ||
      model < 0 || model > 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Ny * Nx + hm::kArgLanes - 1) / hm::kArgLanes, R);
  dim3 block(hm::kArgLanes, hm::kArgGroups);
  if (model == 0)
    hm::me_argmin_kernel<hm::MvdBins><<<grid, block, 0, (cudaStream_t)stream>>>(
        g, gy, gx, mode, Ny, Nx, mvp, lam, coarse);
  else
    hm::me_argmin_kernel<hm::MvLog><<<grid, block, 0, (cudaStream_t)stream>>>(
        g, gy, gx, mode, Ny, Nx, mvp, lam, coarse);
  return (int)cudaGetLastError();
}

// model as hm_me_argmin; cost may be null; cur: the band of rows row0.. of
// the picture, refs: (R, rh, w) whole references; bh, bw in {8, 16, 32, 64}
extern "C" int hm_me_refine(const int* cur, int w, const int* refs, int row0,
                            int rh, int R, int bh, int bw, int Ny, int Nx,
                            const int* coarse, const int* mvp, float lam,
                            int model, int* out, float* cost, void* stream) {
  auto size_ok = [](int v) { return v == 8 || v == 16 || v == 32 || v == 64; };
  if (R <= 0 || Ny <= 0 || Nx <= 0 || !size_ok(bh) || !size_ok(bw) ||
      (long long)R * Ny * Nx > 0x7fffffff || model < 0 || model > 1 ||
      row0 < 0 || row0 + Ny * bh > rh)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return model == 0
      ? hm::launch_refine<hm::MvdBins>(cur, w, refs, row0, rh, R, bh, bw, Ny,
                                       Nx, coarse, mvp, lam, out, cost, st)
      : hm::launch_refine<hm::MvLog>(cur, w, refs, row0, rh, R, bh, bw, Ny,
                                     Nx, coarse, mvp, lam, out, cost, st);
}
