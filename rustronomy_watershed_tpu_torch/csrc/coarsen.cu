// Coarsen kernel: fine label plane -> packed coarse plane.
//
// Replaces the TPU kernel rustronomy_watershed_tpu/ops/scan_merge.py
// `_coarsen_kernel` (launched by `component_min_coarse_from_padded`).  Coarse
// cell (i, x) stands for fine cells (2i, x) and (2i+1, x) and holds (see
// ops/scan_merge.py for why the coarse graph is exact):
//   * bits 0..23: the min of its claimed (nonzero) fine labels, 0 when both
//     are unclaimed; in columns 1 and w-2 also the labels of the claimed
//     same-row border cells (columns 0 / w-1, rows 1..h-2) next to a claimed
//     half; border columns are empty (0);
//   * bit 24 / 25: no vertical edge to the coarse cell above / below (fine
//     rows 2i-1 and 2i, resp. 2i+1 and 2i+2, not both claimed);
//   * bit 26 / 27: no horizontal edge to the left / right neighbour (neither
//     the top halves nor the bottom halves both claimed, border columns and
//     the border rows 0 and h-1 excluded).
// An empty cell sets all four bits.  Fine cells outside the image read as
// unclaimed, so the plane is (ceil(h/2), w) with no aprons and no padding:
// the TPU layout's 8-row aprons, 128-lane padding and h2 % 16 gate go.
//
// What bounds it: bytes.  It reads the fine plane (4 B/pixel) and writes
// half as many int32 cells; the arithmetic is a few compares per cell.
// Design: one thread per coarse cell, neighbouring threads on neighbouring
// columns, so every row read is coalesced; the up-to-six fine reads a cell
// needs beyond its own pair come from L1/L2.  Speed work (several cells per
// thread, 16-byte loads) is left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVal = (1 << 24) - 1;

__global__ void __launch_bounds__(kThreads)
coarsen_kernel(const int32_t* __restrict__ lab, int32_t* __restrict__ c, int h,
               int w, int hc) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (size_t)hc * w) return;
  const int x = static_cast<int>(i % w);
  const int r0 = 2 * static_cast<int>(i / w), r1 = r0 + 1;
  auto at = [&](int y, int xx) -> int {
    return (y >= 0 && y < h) ? lab[(size_t)y * w + xx] : 0;
  };
  const int top = at(r0, x), bot = at(r1, x);
  const bool tcl = top != 0, bcl = bot != 0;
  const bool ok0 = r0 != 0 && r0 != h - 1, ok1 = r1 != h - 1;

  int val = tcl ? (bcl ? min(top, bot) : top) : (bcl ? bot : 0);
  auto fold = [&](bool cl, bool ok, int nb) {
    if (cl && ok && nb != 0) val = min(val, nb & kVal);
  };
  if (x == 1) {
    fold(tcl, ok0, at(r0, 0));
    fold(bcl, ok1, at(r1, 0));
  }
  if (x == w - 2) {
    fold(tcl, ok0, at(r0, w - 1));
    fold(bcl, ok1, at(r1, w - 1));
  }
  if (x == 0 || x == w - 1) val = 0;

  const bool empty = val == 0;
  const bool vf = empty || !(at(r0 - 1, x) != 0 && tcl);
  const bool vb = empty || !(bcl && at(r1 + 1, x) != 0);
  // Horizontal edge between columns xx-1 and xx.
  auto hedge = [&](int xx) -> bool {
    if (xx - 1 < 1 || xx > w - 2) return false;
    return (ok0 && at(r0, xx - 1) != 0 && at(r0, xx) != 0) ||
           (ok1 && at(r1, xx - 1) != 0 && at(r1, xx) != 0);
  };
  const bool hf = empty || !hedge(x);
  const bool hb = empty || !hedge(x + 1);
  c[i] = val | (int(vf) << 24) | (int(vb) << 25) | (int(hf) << 26) |
         (int(hb) << 27);
}

}  // namespace

// lab: (h, w) int32 labels; c: (ceil(h/2), w) int32 out; w >= 3.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int rwt_coarsen(const void* lab, void* c, int h, int w,
                           void* stream) {
  const int hc = (h + 1) / 2;
  const size_t n = (size_t)hc * w;
  if (n == 0) return 0;
  coarsen_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lab), static_cast<int32_t*>(c), h, w, hc);
  return static_cast<int>(cudaGetLastError());
}
