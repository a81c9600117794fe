// K6 subpel_planes: the 16 quarter-pel phase planes of every reference.
//
// Replaces `_subpel_planes` (hm16_2_tpu/encode/inter_plan.py:294-337):
// plane[fy*4+fx][y, x] is HM's rounded 8-tap luma prediction sample at
// picture position (y - M + fy/4, x - M + fx/4), M = 80, bit-exact with
// interp_ref.mc_block's last-stage output; the reference's edge padding by
// (M+4, M+5) is clamped indexing here.
//
// What bounds it on the H100: the write, 16 x (R, h+2M+1, w+2M+1) int16
// (330 MB at 1080p with 4 references, 0.1086 ms at 3.35 TB/s).  The first
// kernel computed one output per thread, each a vertical 8-tap of up to
// eight horizontal 8-taps read through clamped global indexing (about 72
// multiply-adds and 64 loads per output, and 64-bit index divisions): 41x
// its bound.  Now a CTA owns an 8 x 256 tile of one reference's output
// positions.  It stages the clamped reference tile with its 7-row and
// 7-column halo in shared memory once (4-byte cp.async from clamped rows
// and columns), computes the 4 horizontal phases of the tile's rows and
// halo into shared memory once (int32; fx = 0 is a shift), and derives all
// 16 outputs of a position from them: fy = 0 is a round and shift, fy != 0
// 8 vertical taps, each thread sliding down the 8 rows of one column so
// that 15 loads serve its 8 rows.  About 8 multiply-adds per output; no
// index divisions.  Every store is a warp's 32 consecutive int16 of one
// plane row, and no byte is written twice.  The plane rows (w + 161
// samples) are not 4-byte aligned, so a tile's row segment starts and ends
// inside a 32-byte sector that its neighbour tile also writes; wide tiles
// make such sectors rare (a sweep of tile shapes on the H100 chose 256
// columns over 64 and 128, and 8 rows: the 7-row halo costs less than the
// partial sectors).  Resources (ptxas -v, printed by chip_smoke.py):
// 56 registers, no spills; 77,220 bytes of dynamic shared memory per CTA,
// opted in, so two CTAs share an SM.
#include "intra_common.cuh"

namespace hm {

constexpr int kMargin = 80;
constexpr int kSubTY = 8, kSubTX = 256, kSubThreads = 256;
constexpr int kSubRows = kSubTY * kSubTX / kSubThreads;   // rows per thread
constexpr int kSubInRows = kSubTY + 7, kSubInCols = kSubTX + 7;
constexpr size_t kSubSmem =
    sizeof(int) * (kSubInRows * kSubInCols + 4 * kSubInRows * kSubTX);

__constant__ int kLumaTaps[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};

// grid (tiles across Wp, tiles down Hp, R); output tile rows y0.., columns
// x0..; the staged input row rr, column cc is the edge-padded reference at
// padded (y0 + 1 + rr, x0 + 1 + cc), i.e. picture (.. - M - 3) clamped
__global__ void __launch_bounds__(kSubThreads, 2)
subpel_kernel(const int* __restrict__ refs, int h, int w, int bd,
              short* __restrict__ out) {
  extern __shared__ int sub_smem[];
  int* in = sub_smem;                            // [kSubInRows][kSubInCols]
  int* hp = in + kSubInRows * kSubInCols;        // [4][kSubInRows][kSubTX]
  const int Hp = h + 2 * kMargin + 1, Wp = w + 2 * kMargin + 1;
  const int r = blockIdx.z, y0 = blockIdx.y * kSubTY, x0 = blockIdx.x * kSubTX;
  const int tid = threadIdx.x;
  const int hr = bd <= 12 ? 14 - bd : 2;
  const int sh1 = 6 - hr, offs = 1 << 13, maxv = (1 << bd) - 1;
  const int* ref = refs + (size_t)r * h * w;

  for (int q = tid; q < kSubInRows * kSubInCols; q += kSubThreads) {
    int rr = q / kSubInCols, cc = q - rr * kSubInCols;
    int py = clampi(y0 + rr - kMargin - 3, 0, h - 1);
    int px = clampi(x0 + cc - kMargin - 3, 0, w - 1);
    cp_async4(in + q, ref + (size_t)py * w + px);
  }
  cp_async_wait_all();
  __syncthreads();

  // the 4 horizontal phases of every staged row, at the tile's columns
  for (int q = tid; q < kSubInRows * kSubTX; q += kSubThreads) {
    int rr = q / kSubTX, c = q % kSubTX;
    const int* p = in + rr * kSubInCols + c;
    int v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = p[k];
    int* o = hp + rr * kSubTX + c;
    o[0] = v[3] * (1 << hr) - offs;
#pragma unroll
    for (int fx = 1; fx < 4; ++fx) {
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += kLumaTaps[fx][k] * v[k];
      o[fx * kSubInRows * kSubTX] =
          sh1 >= 0 ? (acc - (offs << sh1)) >> sh1 : acc * (1 << -sh1) - offs;
    }
  }
  __syncthreads();

  // 16 outputs per position: a thread slides down kSubRows rows of one
  // column
  const int c = tid % kSubTX, yb = tid / kSubTX * kSubRows, x = x0 + c;
  if (x >= Wp) return;
  const int sh2 = 6 + hr;
  const int rnd0 = offs + (1 << (hr - 1)), rnd2 = (1 << (sh2 - 1)) + (offs << 6);
  short* base = out + (size_t)r * 16 * Hp * Wp + x;
#pragma unroll
  for (int fx = 0; fx < 4; ++fx) {
    const int* col = hp + fx * kSubInRows * kSubTX + yb * kSubTX + c;
    int v[kSubRows + 7];
#pragma unroll
    for (int t = 0; t < kSubRows + 7; ++t) v[t] = col[t * kSubTX];
#pragma unroll
    for (int i = 0; i < kSubRows; ++i) {
      int y = y0 + yb + i;
      if (y >= Hp) break;
      short* o = base + (size_t)fx * Hp * Wp + (size_t)y * Wp;
      o[0] = (short)clampi((v[i + 3] + rnd0) >> hr, 0, maxv);
#pragma unroll
      for (int fy = 1; fy < 4; ++fy) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += kLumaTaps[fy][k] * v[i + k];
        o[(size_t)fy * 4 * Hp * Wp] = (short)clampi((acc + rnd2) >> sh2, 0, maxv);
      }
    }
  }
}

}  // namespace hm

extern "C" int hm_subpel_planes(const int* refs, int R, int h, int w, int bd,
                                short* out, void* stream) {
  if (R <= 0 || R > 65535 || h <= 0 || w <= 0 || bd < 8 || bd > 12)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hm::subpel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)hm::kSubSmem);
  if (err != cudaSuccess) return (int)err;
  const int Hp = h + 2 * hm::kMargin + 1, Wp = w + 2 * hm::kMargin + 1;
  dim3 grid((Wp + hm::kSubTX - 1) / hm::kSubTX,
            (Hp + hm::kSubTY - 1) / hm::kSubTY, R);
  hm::subpel_kernel<<<grid, hm::kSubThreads, hm::kSubSmem,
                      (cudaStream_t)stream>>>(refs, h, w, bd, out);
  return (int)cudaGetLastError();
}

// K6's dynamic shared memory per CTA in bytes
extern "C" size_t hm_subpel_smem_bytes() { return hm::kSubSmem; }
