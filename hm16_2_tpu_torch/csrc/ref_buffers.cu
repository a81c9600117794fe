// K1 ref_buffers: original-pixel intra reference buffers and blocks.
//
// Replaces `_jnp_ref_buffers` (hm16_2_tpu/encode/intra_rd.py:317), and the
// numpy assembly of `CtuSearch._premodes` (encode/top.py:3959-3994), which
// is the same computation.  For every aligned s x s block inside (h, w) it
// writes bufs (N, 2, 4s+1) int32 = [unfiltered, filtered] reference samples
// (left column bottom-up, corner at 2s, top row) taken from the plane with
// the reference's edge clamping, the [1 2 1] smoothing and, at s = 32, the
// strong bilinear smoothing; and blocks (N, s, s) int32.
//
// Band mode (`hm_ref_buffers_band`) replaces the assembly of
// `frame_shard._band_rd` (hm16_2_tpu/parallel/frame_shard.py:51-101): the
// plane is one row band of the picture, with the last row of the band above
// (`halo_top`, 1 row) and the first s rows of the band below (`halo_bot`).
// Tops come from [halo_top; band], except at the picture's top row, where
// the block's own first row is used; lefts come from [band; halo_bot],
// clipped at min(B + s - 1, pic_h - 1 - band_first).  The halos are what
// the reference's `ppermute` delivers, zeros where no band sends any, and
// the clip can reach the last band's zero `halo_bot` when the banded rows
// stop short of the picture (ROADMAP "Faults found"): reproduced, not
// repaired.
//
// What bounds it: memory traffic, a few bytes per output sample, and the
// launch itself at small N.  Design: one thread per (block, buffer index)
// reads its three unfiltered neighbours (and at s = 32 the five corner
// samples of the strong-smoothing test) straight from the plane, which L2
// holds; a second launch copies the blocks with one thread per sample.  The
// two modes differ only in where an unfiltered sample comes from (a
// template parameter); the filters are shared.
#include <cuda_runtime.h>

namespace hm {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct RefGeom {
  const int* plane;
  int ph, pw, s, nbx;
};

// unfiltered buffer entry i of block (by, bx)
__device__ __forceinline__ int ref_u(const RefGeom& g, int by, int bx, int i) {
  int s = g.s, x0 = bx * s, y0 = by * s;
  int xl = x0 - 1 > 0 ? x0 - 1 : 0;
  int yt = y0 - 1 > 0 ? y0 - 1 : 0;
  if (i < 2 * s) {                 // left column, bottom-up: left[2s - i]
    int y = y0 + (2 * s - i) - 1;
    y = y < 0 ? 0 : (y > g.ph - 1 ? g.ph - 1 : y);
    return g.plane[(size_t)y * g.pw + xl];
  }
  int x = x0 + (i - 2 * s) - 1;    // corner (i = 2s) and top row
  x = x < 0 ? 0 : (x > g.pw - 1 ? g.pw - 1 : x);
  return g.plane[(size_t)yt * g.pw + x];
}

// the same entry for a block of a row band (band mode)
struct BandGeom {
  const int* band;       // (B, W)
  const int* halo_top;   // (1, W): last row of the band above
  const int* halo_bot;   // (s, W): first rows of the band below
  int B, W, s, nbx, band_first, max_row;
};

__device__ __forceinline__ int ref_u(const BandGeom& g, int by, int bx, int i) {
  int s = g.s, x0 = bx * s, y0 = by * s;
  if (i < 2 * s) {                 // left column from [band; halo_bot]
    int r = clampi(y0 + (2 * s - i) - 1, 0, g.max_row);
    int x = x0 - 1 > 0 ? x0 - 1 : 0;
    return r < g.B ? g.band[(size_t)r * g.W + x]
                   : g.halo_bot[(size_t)(r - g.B) * g.W + x];
  }
  int x = clampi(x0 + (i - 2 * s) - 1, 0, g.W - 1);
  if (g.band_first + y0 == 0)      // picture top: the block's first row
    return g.band[(size_t)y0 * g.W + x];
  return y0 == 0 ? g.halo_top[x] : g.band[(size_t)(y0 - 1) * g.W + x];
}

template <class Geom>
__global__ void ref_buffers_kernel(Geom g, int n, int bd, int strong,
                                   int* __restrict__ bufs) {
  const int s = g.s, B = 4 * s + 1;
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)n * B) return;
  int nb = (int)(q / B), i = (int)(q % B);
  int by = nb / g.nbx, bx = nb % g.nbx;
  int u = ref_u(g, by, bx, i);
  int f = u;
  if (i > 0 && i < 4 * s)
    f = (ref_u(g, by, bx, i + 1) + 2 * u + ref_u(g, by, bx, i - 1) + 2) >> 2;
  if (s == 32 && strong && i > 0 && i < 4 * s) {
    int c0 = ref_u(g, by, bx, 2 * s), cs = ref_u(g, by, bx, 3 * s);
    int c2s = ref_u(g, by, bx, 4 * s);
    int ls = ref_u(g, by, bx, s), l2s = ref_u(g, by, bx, 0);
    int thr = 1 << (bd - 5);
    int dt = c0 + c2s - 2 * cs, dl = c0 + l2s - 2 * ls;
    if ((dt < 0 ? -dt : dt) < thr && (dl < 0 ? -dl : dl) < thr) {
      if (i == 2 * s) {
        f = u;                       // the corner stays unfiltered
      } else if (i > 2 * s) {
        int k = i - 2 * s;
        f = ((2 * s - k) * c0 + k * c2s + s) >> 6;
      } else {
        int k = 2 * s - i;
        f = ((2 * s - k) * c0 + k * l2s + s) >> 6;
      }
    }
  }
  bufs[(size_t)nb * 2 * B + i] = u;
  bufs[(size_t)nb * 2 * B + B + i] = f;
}

__global__ void blocks_kernel(RefGeom g, int n, int* __restrict__ blocks) {
  const int s = g.s;
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)n * s * s) return;
  int nb = (int)(q / (s * s)), yx = (int)(q % (s * s));
  int by = nb / g.nbx, bx = nb % g.nbx;
  blocks[q] = g.plane[(size_t)(by * s + yx / s) * g.pw + bx * s + yx % s];
}

template <class Geom>
static int launch(const Geom& g, const RefGeom& blk, int n, int bd,
                  int strong, int* bufs, int* blocks, cudaStream_t st) {
  long long t1 = (long long)n * (4 * g.s + 1), t2 = (long long)n * g.s * g.s;
  ref_buffers_kernel<<<(unsigned)((t1 + 255) / 256), 256, 0, st>>>(
      g, n, bd, strong, bufs);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  blocks_kernel<<<(unsigned)((t2 + 255) / 256), 256, 0, st>>>(blk, n, blocks);
  return (int)cudaGetLastError();
}

}  // namespace hm

extern "C" int hm_ref_buffers(const int* plane, int ph, int pw, int s,
                              int bd, int strong, int nby, int nbx,
                              int* bufs, int* blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nby <= 0 || nbx <= 0 || s < 4 || s > 32) return (int)cudaErrorInvalidValue;
  hm::RefGeom g{plane, ph, pw, s, nbx};
  return hm::launch(g, g, nby * nbx, bd, strong, bufs, blocks, st);
}

// band mode: band (B, W), halo_top (1, W), halo_bot (s, W); max_row =
// min(B + s - 1, pic_h - 1 - band_first), the last row of [band; halo_bot]
// a left reference may read
extern "C" int hm_ref_buffers_band(const int* band, int B, int W,
                                   const int* halo_top, const int* halo_bot,
                                   int s, int bd, int strong, int band_first,
                                   int max_row, int nby, int nbx, int* bufs,
                                   int* blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nby <= 0 || nbx <= 0 || s < 4 || s > 32 || nby * s > B ||
      nbx * s > W || max_row < 0 || max_row > B + s - 1)
    return (int)cudaErrorInvalidValue;
  hm::BandGeom g{band, halo_top, halo_bot, B, W, s, nbx, band_first, max_row};
  hm::RefGeom blk{band, B, W, s, nbx};
  return hm::launch(g, blk, nby * nbx, bd, strong, bufs, blocks, st);
}
