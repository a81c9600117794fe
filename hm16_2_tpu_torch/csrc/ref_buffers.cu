// K1 ref_buffers: original-pixel intra reference buffers and blocks, every
// size and plane of a picture in one launch.
//
// Replaces `_jnp_ref_buffers` (hm16_2_tpu/encode/intra_rd.py:317), and the
// numpy assembly of `CtuSearch._premodes` (encode/top.py:3959-3994), which
// is the same computation.  For every aligned s x s block inside (h, w) of a
// plane it writes bufs (N, 2, 4s+1) int32 = [unfiltered, filtered] reference
// samples (left column bottom-up, corner at 2s, top row) taken from the
// plane with the reference's edge clamping (to the plane's last row and
// column, which may lie past (h, w)), the [1 2 1] smoothing and, at s = 32,
// the strong bilinear smoothing (the corner stays unfiltered); and blocks
// (N, s, s) int32.  One launch takes up to kMaxK1 such entries (plane, s,
// bd, strong, block grid, outputs) by value in one `K1Args`: an AI
// picture's four luma sizes and its chroma planes' six, or the three sizes
// of a P/B picture's intra alternative.
//
// Band mode (`hm_ref_buffers_band_multi`) replaces the assembly of
// `frame_shard._band_rd` (hm16_2_tpu/parallel/frame_shard.py:51-101): every
// entry's plane is the same row band of the picture, with the last row of
// the band above (`halo_top`, 1 row) and the first smax rows of the band
// below (`halo_bot`), smax the largest size of the launch.  Tops come from
// [halo_top; band], except at the picture's top row, where the block's own
// first row is used; lefts come from [band; halo_bot], clipped at each
// entry's max_row = min(B + s - 1, pic_h - 1 - band_first), so an entry
// reads only the first s rows of halo_bot.  The halos are what the
// reference's `ppermute` delivers, zeros where no band sends any, and the
// clip can reach the last band's zero `halo_bot` when the banded rows stop
// short of the picture (ROADMAP "Faults found"): reproduced, not repaired.
//
// What bounds it: memory traffic, each plane read and each output written
// (the blocks and the buffers, ~8 bytes written per plane byte read at
// s = 4-32).  Design: a CTA takes a strip of NB blocks of one block row of
// one entry (K1Strip: 128 at s = 4, 64 at 8, 16 at 16, 4 at 32, so every
// CTA writes 20-33 KB); it finds its entry from the entries' first CTAs and
// its block row with one 32-bit division.  Each thread first loads its share of
// the strip's blocks (16-byte loads where the plane's rows allow: a block
// row is whole 16-byte pieces), then gathers the strip's unfiltered
// buffers into shared memory with 4-byte cp.async copies from their clamped
// positions (the row above and its 2s-sample extension to the right, the
// column left and its 2s-sample extension below), then stores the blocks
// (the strip's blocks are contiguous in `blocks`, so the stores are
// 16-byte and coalesced) while the copies land.  The strong-smoothing test
// runs once per block, on one thread.  The strip's buffers are contiguous
// in `bufs` too: each thread writes four entries with one 16-byte store,
// the filtered ones computed from their neighbours in shared memory.
// Every division by s, 4s + 1 or 8s + 2 is by a compile-time constant (a
// switch on s per CTA).
#include "intra_common.cuh"

namespace hm {

constexpr int kMaxK1 = 10;          // entries per launch
constexpr int kK1Threads = 256;

// blocks per CTA at size S
template <int S>
struct K1Strip {
  static constexpr int NB = S == 4 ? 128 : (S == 8 ? 64 : (S == 16 ? 16 : 4));
  static constexpr int L = 4 * S + 1;      // one buffer
  static constexpr int U = NB * L;         // the strip's unfiltered buffers
};
constexpr int kMaxU = 128 * 17;            // the largest K1Strip<S>::U

struct K1Entry {
  const int* plane;   // (ph, pw); in band mode the band (B, W)
  int* bufs;          // (nby * nbx, 2, 4s + 1)
  int* blocks;        // (nby * nbx, s, s), 16-byte aligned
  int ph, pw, s, bd, strong, nby, nbx;
  int max_row;        // band mode: the last row of [band; halo_bot] a left
                      // reference may read
  int first;          // the entry's first CTA (set by the launcher)
};

struct K1Args {
  int n, total;           // entries; CTAs (set by the launcher)
  const int* halo_top;    // band mode: (1, W)
  const int* halo_bot;    // band mode: (smax, W)
  int band_first;         // band mode: the band's first picture row
  K1Entry e[kMaxK1];
};

// where the unfiltered samples come from: the row above block row y0, and
// the (clamped) row of a left reference at picture row y >= y0
struct PlaneRows {
  static __device__ __forceinline__ const int* top(const K1Args&,
                                                   const K1Entry& e, int y0) {
    return e.plane + (size_t)(y0 > 0 ? y0 - 1 : 0) * e.pw;
  }
  static __device__ __forceinline__ const int* left(const K1Args&,
                                                    const K1Entry& e, int y) {
    return e.plane + (size_t)(y < e.ph - 1 ? y : e.ph - 1) * e.pw;
  }
};

struct BandRows {
  static __device__ __forceinline__ const int* top(const K1Args& a,
                                                   const K1Entry& e, int y0) {
    if (a.band_first + y0 == 0) return e.plane;   // picture top: own first row
    return y0 == 0 ? a.halo_top : e.plane + (size_t)(y0 - 1) * e.pw;
  }
  static __device__ __forceinline__ const int* left(const K1Args& a,
                                                    const K1Entry& e, int y) {
    const int r = y < e.max_row ? y : e.max_row;
    return r < e.ph ? e.plane + (size_t)r * e.pw
                    : a.halo_bot + (size_t)(r - e.ph) * e.pw;
  }
};

struct K1Smem {
  int u[kMaxU];          // u[b * L + i]: block b's unfiltered entry i
  int flag[128];         // block b takes the strong smoothing (s = 32)
};

template <int S, class Rows>
__device__ __forceinline__ void k1_strip(const K1Args& a, const K1Entry& e,
                                         int local, K1Smem& sm) {
  using St = K1Strip<S>;
  constexpr int NB = St::NB, L = St::L, L2 = 2 * L, T = kK1Threads;
  constexpr int Q = S * S / 4, R4 = S / 4;             // int4s of a block
  constexpr int NQ = (NB * Q + T - 1) / T;             // of them per thread
  const int strips = (e.nbx + NB - 1) / NB;
  const int by = local / strips, bx0 = (local - by * strips) * NB;
  const int nb = min(NB, e.nbx - bx0);
  const int y0 = by * S, c0 = bx0 * S, pw = e.pw, t = threadIdx.x;
  const size_t first = (size_t)by * e.nbx + bx0;

  // 1. load this thread's share of the blocks
  const int* src = e.plane + (size_t)y0 * pw + c0;
  const bool vec = (pw & 3) == 0 && ((uintptr_t)e.plane & 15) == 0;
  int4 blk[NQ];
#pragma unroll
  for (int m = 0; m < NQ; ++m) {
    const int q = t + m * T;
    if (q < nb * Q) {
      const int b = q / Q, r = q - b * Q, k = r / R4, x = b * S + 4 * (r % R4);
      const int* p = src + (size_t)k * pw + x;
      blk[m] = vec ? *reinterpret_cast<const int4*>(p)
                   : make_int4(p[0], p[1], p[2], p[3]);
    }
  }

  // 2. gather the unfiltered buffers into shared memory: entry i < 2s is
  // the left column, bottom-up (row y0 + 2s - 1 - i, clamped), entry 2s + j
  // the row above from column x0 - 1 + j (clamped)
  const int* trow = Rows::top(a, e, y0);
  for (int q = t; q < nb * L; q += T) {
    const int b = q / L, i = q - b * L, x0 = c0 + b * S;
    const int* p;
    if (i < 2 * S) {
      p = Rows::left(a, e, y0 + 2 * S - 1 - i) + (x0 > 0 ? x0 - 1 : 0);
    } else {
      const int x = x0 - 1 + i - 2 * S;
      p = trow + (x < 0 ? 0 : (x > pw - 1 ? pw - 1 : x));
    }
    cp_async4(&sm.u[q], p);
  }

  // 3. store the blocks while the copies land
  int4* gk = reinterpret_cast<int4*>(e.blocks + first * S * S);
#pragma unroll
  for (int m = 0; m < NQ; ++m) {
    const int q = t + m * T;
    if (q < nb * Q) gk[q] = blk[m];
  }
  cp_async_wait_all();
  __syncthreads();

  // 4. the strong-smoothing test, once per block
  const bool strong = S == 32 && e.strong;
  if (strong) {
    if (t < nb) {
      const int* u = sm.u + t * L;
      const int c = u[2 * S], thr = 1 << (e.bd - 5);
      const int dt = c + u[4 * S] - 2 * u[3 * S];
      const int dl = c + u[0] - 2 * u[S];
      sm.flag[t] = abs(dt) < thr && abs(dl) < thr;
    }
    __syncthreads();
  }

  // 5. the buffers: the strip's nb * 2L entries are contiguous in bufs
  int* gb = e.bufs + first * L2;
  const int n = nb * L2;
  auto val = [&](int j) {
    const int b = j / L2, r = j - b * L2, i = r < L ? r : r - L;
    const int* u = sm.u + b * L;
    const int v = u[i];
    if (r < L || i == 0 || i == 4 * S) return v;
    if (strong && sm.flag[b]) {
      if (i == 2 * S) return v;                      // the corner
      const int k = i > 2 * S ? i - 2 * S : 2 * S - i;
      return ((2 * S - k) * u[2 * S] + k * u[i > 2 * S ? 4 * S : 0] + S) >> 6;
    }
    return (u[i - 1] + 2 * v + u[i + 1] + 2) >> 2;
  };
  int head = (int)(((16 - ((uintptr_t)gb & 15)) & 15) >> 2);
  head = head < n ? head : n;
  const int nv = (n - head) >> 2, tail = head + 4 * nv;
  if (t < head) gb[t] = val(t);
  for (int v = t; v < nv; v += T) {
    const int j = head + 4 * v;
    *reinterpret_cast<int4*>(gb + j) =
        make_int4(val(j), val(j + 1), val(j + 2), val(j + 3));
  }
  if (t < n - tail) gb[tail + t] = val(tail + t);
}

template <class Rows>
__global__ void __launch_bounds__(kK1Threads)
ref_multi_kernel(const __grid_constant__ K1Args a) {
  __shared__ K1Smem sm;
  int k = 0;
  while (k + 1 < a.n && (int)blockIdx.x >= a.e[k + 1].first) ++k;
  const K1Entry& e = a.e[k];
  const int local = (int)blockIdx.x - e.first;
  switch (e.s) {
    case 4: k1_strip<4, Rows>(a, e, local, sm); break;
    case 8: k1_strip<8, Rows>(a, e, local, sm); break;
    case 16: k1_strip<16, Rows>(a, e, local, sm); break;
    default: k1_strip<32, Rows>(a, e, local, sm); break;
  }
}

static int k1_blocks_per_cta(int s) {
  return s == 4 ? K1Strip<4>::NB : s == 8 ? K1Strip<8>::NB
         : s == 16 ? K1Strip<16>::NB : K1Strip<32>::NB;
}

// checks the entries, sets their first CTAs and launches (nothing when no
// entry has a block)
template <class Rows>
static int launch_k1(const K1Args* in, bool band, cudaStream_t st) {
  if (in->n <= 0 || in->n > kMaxK1) return (int)cudaErrorInvalidValue;
  K1Args a = *in;
  int total = 0;
  for (int k = 0; k < a.n; ++k) {
    K1Entry& e = a.e[k];
    if ((e.s != 4 && e.s != 8 && e.s != 16 && e.s != 32) || e.nby < 0 ||
        e.nbx < 0 || e.nby * e.s > e.ph || e.nbx * e.s > e.pw ||
        e.bd < 5 || ((uintptr_t)e.blocks & 15) ||
        (band && (e.max_row < e.ph - 1 || e.max_row > e.ph + e.s - 1)))
      return (int)cudaErrorInvalidValue;
    e.first = total;
    const int nb = k1_blocks_per_cta(e.s);
    if (e.nby && e.nbx) total += e.nby * ((e.nbx + nb - 1) / nb);
  }
  a.total = total;
  if (total == 0) return 0;
  ref_multi_kernel<Rows><<<total, kK1Threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace hm

extern "C" int hm_ref_buffers_multi(const hm::K1Args* a, void* stream) {
  return hm::launch_k1<hm::PlaneRows>(a, false, (cudaStream_t)stream);
}

// band mode: every entry's plane is the band (B, W); halo_top (1, W),
// halo_bot (smax, W)
extern "C" int hm_ref_buffers_band_multi(const hm::K1Args* a, void* stream) {
  return hm::launch_k1<hm::BandRows>(a, true, (cudaStream_t)stream);
}

extern "C" size_t hm_sizeof_k1_args() { return sizeof(hm::K1Args); }
extern "C" size_t hm_k1_smem_bytes() { return sizeof(hm::K1Smem); }
