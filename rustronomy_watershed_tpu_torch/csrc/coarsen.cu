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
// half as many int32 cells (2 B/pixel): 0.030 ms at 4096^2 at 3.35 TB/s;
// the arithmetic is a few compares per cell.  Design (`coarsen_strips`):
// a thread owns 4 adjacent columns, loaded as one int4, and walks K coarse
// rows down a strip (K and the grid from ops/scan_merge.py coarsen_plan).
// It keeps the fine rows it has read in registers, so each fine row is read
// once, plus one halo row at each strip end.  The walk is a chain of
// dependent loads, so short strips (K = 2: 1.5 fine-row reads per fine
// row, thousands of blocks) beat long ones on this card; loading the next
// pair a coarse row ahead did not help.  The claimed bits of columns
// x-1 and x+4, which the horizontal edge bits need, come from lane +-1 by
// shuffle; a warp's edge lanes load them.  Columns 0, 1, w-2 and w-1 lie
// in the first and last thread's int4 (w % 4 == 0), so the border-column
// folds read nothing more.  The output is one int4 store per thread and
// coarse row.  A width that is not a multiple of 4, or an unaligned plane,
// takes `coarsen_cells`: one thread per coarse cell, the up-to-six fine
// reads it needs beyond its own pair from L1/L2 (the first design).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVal = (1 << 24) - 1;

__global__ void __launch_bounds__(kThreads)
coarsen_cells(const int32_t* __restrict__ lab, int32_t* __restrict__ c, int h,
              int w, int hc) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
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

// Bit k (k = 0..3) of the result: fine cell k of the int4 is claimed.
__device__ __forceinline__ uint32_t claimed4(int4 q) {
  return (q.x != 0 ? 1u : 0u) | (q.y != 0 ? 2u : 0u) | (q.z != 0 ? 4u : 0u) | (q.w != 0 ? 8u : 0u);
}

__global__ void __launch_bounds__(kThreads)
coarsen_strips(const int32_t* __restrict__ lab, int32_t* __restrict__ c, int h, int w, int hc, int k_rows) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int x0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  const bool act = x0 < w;
  const int i0 = blockIdx.y * k_rows, i1 = min(i0 + k_rows, hc);
  auto load = [&](int y) -> int4 {
    if (act && y >= 0 && y < h) return __ldg(reinterpret_cast<const int4*>(lab + (size_t)y * w + x0));
    return make_int4(0, 0, 0, 0);
  };
  auto claimed_at = [&](int y, int x) -> uint32_t {
    return (y < h && x >= 0 && x < w && lab[(size_t)y * w + x] != 0) ? 1u : 0u;
  };
  // Bit b: column x0 - 1 + b (b = 0..5) is an interior column.
  uint32_t inner = 0;
#pragma unroll
  for (int b = 0; b < 6; ++b) inner |= (x0 - 1 + b >= 1 && x0 - 1 + b <= w - 2 ? 1u : 0u) << b;

  int4 prev = load(2 * i0 - 1), top = load(2 * i0);
  for (int i = i0; i < i1; ++i) {
    const int r0 = 2 * i, r1 = r0 + 1;
    const int4 bot = load(r1), next = load(r1 + 1);
    const bool ok0 = r0 != 0 && r0 != h - 1, ok1 = r1 != h - 1;
    const uint32_t ct = claimed4(top), cb = claimed4(bot);
    uint32_t left = __shfl_up_sync(kFull, ct | cb << 4, 1);
    uint32_t right = __shfl_down_sync(kFull, ct | cb << 4, 1);
    if (lane == 0) left = claimed_at(r0, x0 - 1) << 3 | claimed_at(r1, x0 - 1) << 7;
    if (lane == 31) right = claimed_at(r0, x0 + 4) | claimed_at(r1, x0 + 4) << 4;
    // Six columns x0-1 .. x0+4, claimed and interior, in rows off the border.
    const uint32_t et = ok0 ? (((left >> 3) & 1u) | ct << 1 | (right & 1u) << 5) & inner : 0u;
    const uint32_t eb = ok1 ? (((left >> 7) & 1u) | cb << 1 | ((right >> 4) & 1u) << 5) & inner : 0u;
    const uint32_t edge = (et & (et >> 1)) | (eb & (eb >> 1));  // bit b: columns x0-1+b and x0+b joined

    const int tv[4] = {top.x, top.y, top.z, top.w}, bv[4] = {bot.x, bot.y, bot.z, bot.w};
    const int pv[4] = {prev.x, prev.y, prev.z, prev.w}, nv[4] = {next.x, next.y, next.z, next.w};
    int out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = x0 + j;
      const bool tcl = tv[j] != 0, bcl = bv[j] != 0;
      int val = tcl ? (bcl ? min(tv[j], bv[j]) : tv[j]) : (bcl ? bv[j] : 0);
      auto fold = [&](bool cl, bool ok, int nb) {
        if (cl && ok && nb != 0) val = min(val, nb & kVal);
      };
      const int jl = j > 0 ? j - 1 : 0, jr = j < 3 ? j + 1 : 3;  // in the int4 (w % 4 == 0)
      if (j >= 1 && x == 1) {
        fold(tcl, ok0, tv[jl]);
        fold(bcl, ok1, bv[jl]);
      }
      if (j <= 2 && x == w - 2) {
        fold(tcl, ok0, tv[jr]);
        fold(bcl, ok1, bv[jr]);
      }
      if (x == 0 || x == w - 1) val = 0;
      const bool empty = val == 0;
      const bool vf = empty || !(pv[j] != 0 && tcl);
      const bool vb = empty || !(bcl && nv[j] != 0);
      const bool hf = empty || !((edge >> j) & 1u);
      const bool hb = empty || !((edge >> (j + 1)) & 1u);
      out[j] = val | (int(vf) << 24) | (int(vb) << 25) | (int(hf) << 26) | (int(hb) << 27);
    }
    if (act) *reinterpret_cast<int4*>(c + (size_t)i * w + x0) = make_int4(out[0], out[1], out[2], out[3]);
    prev = bot;
    top = next;
  }
}

}  // namespace

// lab: (h, w) int32 labels; c: (ceil(h/2), w) int32 out; w >= 3.  The
// launch plan comes from ops/scan_merge.py coarsen_plan and is launched as
// given: route 0 the strips (w % 4 == 0, both planes 16-byte aligned) on a
// (grid_x, grid_y) grid of `threads` (whole warps, at most kThreads) of 4
// columns each, strips of `k_rows` coarse rows; route 1 one thread per cell,
// grid_x blocks of `threads` (grid_y 1).  Launches on `stream`, does not
// synchronise, returns cudaGetLastError(), or cudaErrorInvalidValue for a
// plan that does not cover the plane or that the kernels do not take.
extern "C" int rwt_coarsen(const void* lab, void* c, int h, int w, int route, int threads, int k_rows,
                           int grid_x, int grid_y, void* stream) {
  const int hc = (h + 1) / 2;
  const long long n = (long long)hc * w;
  if (n == 0) return 0;
  const int32_t* l = static_cast<const int32_t*>(lab);
  int32_t* out = static_cast<int32_t*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (threads <= 0 || threads % 32 != 0 || threads > kThreads || grid_x <= 0 || grid_y <= 0 || grid_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    if (grid_y != 1 || (long long)grid_x * threads < n) return static_cast<int>(cudaErrorInvalidValue);
    coarsen_cells<<<grid_x, threads, 0, st>>>(l, out, h, w, hc);
    return static_cast<int>(cudaGetLastError());
  }
  // Every 4-column group in one thread, every coarse row in one strip.
  if (route != 0 || w % 4 != 0 || reinterpret_cast<uintptr_t>(lab) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(c) % 16 != 0 || k_rows <= 0 || 4LL * grid_x * threads < w ||
      (long long)grid_y * k_rows < hc)
    return static_cast<int>(cudaErrorInvalidValue);
  coarsen_strips<<<dim3(grid_x, grid_y), threads, 0, st>>>(l, out, h, w, hc, k_rows);
  return static_cast<int>(cudaGetLastError());
}
