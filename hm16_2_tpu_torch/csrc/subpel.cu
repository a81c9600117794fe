// K6 subpel_planes: the 16 quarter-pel phase planes of every reference.
//
// Replaces `_subpel_planes` (hm16_2_tpu/encode/inter_plan.py:294-337):
// plane[fy*4+fx][y, x] is HM's rounded 8-tap luma prediction sample at
// picture position (y - M + fy/4, x - M + fx/4), M = 80, bit-exact with
// interp_ref.mc_block's last-stage output; the reference's edge padding by
// (M+4, M+5) is clamped indexing here.
//
// What bounds it: integer ALU work, 16 x (R, h+2M+1, w+2M+1) int16 outputs
// (330 MB at 1080p with 4 references), each a vertical 8-tap of horizontal
// 8-taps.  Design, simple first: one thread per output sample, computing
// its (up to) eight horizontal filters on the fly from the reference plane
// in the L1/L2 caches; no intermediate plane is written.
#include "intra_common.cuh"

namespace hm {

constexpr int kMargin = 80;

__constant__ int kLumaTaps[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};

__global__ void subpel_kernel(const int* __restrict__ refs, int R, int h,
                              int w, int bd, short* __restrict__ out) {
  const int Hp = h + 2 * kMargin + 1, Wp = w + 2 * kMargin + 1;
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)R * 16 * Hp * Wp) return;
  int x = q % Wp, y = (q / Wp) % Hp;
  int ph = (q / ((long long)Wp * Hp)) % 16;
  int r = q / (16LL * Wp * Hp);
  int fy = ph >> 2, fx = ph & 3;
  const int hr = bd <= 12 ? 14 - bd : 2;
  const int sh1 = 6 - hr, offs = 1 << 13;
  const int* ref = refs + (size_t)r * h * w;
  // padded (row, col) of the reference's (M+4, M+5) edge-padded plane
  auto rp = [&](int pr, int pc) {
    return ref[clampi(pr - kMargin - 4, 0, h - 1) * w +
               clampi(pc - kMargin - 4, 0, w - 1)];
  };
  auto hfilt = [&](int pr) {
    if (fx == 0) return rp(pr, 4 + x) * (1 << hr) - offs;
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += kLumaTaps[fx][k] * rp(pr, 1 + k + x);
    return sh1 >= 0 ? (acc - (offs << sh1)) >> sh1 : acc * (1 << -sh1) - offs;
  };
  int v;
  if (fy == 0) {
    v = (hfilt(4 + y) + offs + (1 << (hr - 1))) >> hr;
  } else {
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += kLumaTaps[fy][k] * hfilt(1 + k + y);
    const int sh2 = 6 + hr;
    v = (acc + (1 << (sh2 - 1)) + (offs << 6)) >> sh2;
  }
  out[q] = (short)clampi(v, 0, (1 << bd) - 1);
}

}  // namespace hm

extern "C" int hm_subpel_planes(const int* refs, int R, int h, int w, int bd,
                                short* out, void* stream) {
  if (R <= 0 || h <= 0 || w <= 0 || bd < 8 || bd > 12)
    return (int)cudaErrorInvalidValue;
  long long n = (long long)R * 16 * (h + 2 * hm::kMargin + 1) *
                (w + 2 * hm::kMargin + 1);
  hm::subpel_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                      (cudaStream_t)stream>>>(refs, R, h, w, bd, out);
  return (int)cudaGetLastError();
}
