// Coarse broadcast kernel: converged coarse plane -> fine component-min labels.
//
// Replaces the TPU kernel rustronomy_watershed_tpu/ops/scan_merge.py
// `_broadcast_kernel` (launched by `_coarse_broadcast`).  Each claimed fine
// cell (y, x) takes the value of its coarse cell (y/2, x): a fine pair is
// internally connected, so both halves share the component min.  A border
// column cell (x = 0 or w-1) is outside the coarse system: in rows 1..h-2 it
// takes the min of its own label and its claimed same-row interior
// neighbour's new value (column 1 or w-2), otherwise it keeps its own
// label.  Unclaimed cells stay 0.  The output is the (h, w) plane; nothing
// is cropped, since the port's planes carry no aprons.
//
// What bounds it: bytes.  It reads the fine labels (4 B/pixel) and the
// coarse plane (2 B/pixel) and writes 4 B/pixel: 0.050 ms at 4096^2 at
// 3.35 TB/s.  Design (`broadcast_rows`, the inverse of coarsen's column
// strips): a thread owns 4 adjacent columns of `k_rows` coarse rows; per
// coarse row it loads the coarse int4 once and loads and stores the int4 of
// both fine rows it stands for (one, for the last coarse row of an odd h),
// so the coarse plane is read once and every access is 16 bytes.  Columns
// 0, 1, w-2 and w-1 lie in the first and last thread's int4 (w % 4 == 0),
// so the border-column folds load nothing more.  A width that is not a
// multiple of 4, or an unaligned plane, takes `broadcast_cells`: a thread
// per fine cell, the row from the grid's y index (a row-stride loop past
// the grid), so no thread divides.  Both take their launch from
// ops/scan_merge.py broadcast_plan.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kVal = (1 << 24) - 1;

__global__ void __launch_bounds__(kMaxThreads)
broadcast_cells(const int32_t* __restrict__ c, const int32_t* __restrict__ lab, int32_t* __restrict__ out, int h,
                int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  for (int y = blockIdx.y; y < h; y += gridDim.y) {
    const size_t i = (size_t)y * w + x, crow = (size_t)(y >> 1) * w;
    const int l = lab[i];
    int o;
    if (x == 0 || x == w - 1) {
      const int nx = x == 0 ? 1 : w - 2;
      const int nb = lab[(size_t)y * w + nx] != 0 ? (c[crow + nx] & kVal) : 0;
      const bool row_ok = y != 0 && y != h - 1;
      o = (l != 0 && nb != 0 && row_ok) ? min(l, nb) : l;
    } else {
      o = l != 0 ? (c[crow + x] & kVal) : 0;
    }
    out[i] = o;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
broadcast_rows(const int32_t* __restrict__ c, const int32_t* __restrict__ lab, int32_t* __restrict__ out, int h,
               int w, int hc, int k_rows) {
  const int x0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (x0 >= w) return;
  const int i0 = blockIdx.y * k_rows, i1 = min(i0 + k_rows, hc);
  for (int i = i0; i < i1; ++i) {
    const int4 cv = __ldg(reinterpret_cast<const int4*>(c + (size_t)i * w + x0));
    const int cc[4] = {cv.x & kVal, cv.y & kVal, cv.z & kVal, cv.w & kVal};
    for (int y = 2 * i; y < min(2 * i + 2, h); ++y) {
      const size_t g = (size_t)y * w + x0;
      const int4 lv = __ldg(reinterpret_cast<const int4*>(lab + g));
      const int l[4] = {lv.x, lv.y, lv.z, lv.w};
      int o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = l[j] != 0 ? cc[j] : 0;
      const bool row_ok = y != 0 && y != h - 1;
      // The border columns: their interior neighbour is in the same int4.
      if (x0 == 0) o[0] = (l[0] != 0 && o[1] != 0 && row_ok) ? min(l[0], o[1]) : l[0];
      if (x0 + 4 == w) o[3] = (l[3] != 0 && o[2] != 0 && row_ok) ? min(l[3], o[2]) : l[3];
      *reinterpret_cast<int4*>(out + g) = make_int4(o[0], o[1], o[2], o[3]);
    }
  }
}

}  // namespace

// c: (ceil(h/2), w) int32 coarse plane; lab, out: (h, w) int32; w >= 3.  The
// launch plan comes from ops/scan_merge.py broadcast_plan and is launched as
// given: route 0 `broadcast_rows` (w % 4 == 0, the three planes 16-byte
// aligned) on a (grid_x, grid_y) grid of `threads` threads of 4 columns
// each, `k_rows` coarse rows a thread; route 1 `broadcast_cells`, a thread
// per column on (grid_x, grid_y) blocks of `threads`, fine rows strided by
// grid_y.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan that does not
// cover the plane or that the kernels do not take.
extern "C" int rwt_coarse_broadcast(const void* c, const void* lab, void* out, int h, int w, int route, int threads,
                                    int k_rows, int grid_x, int grid_y, void* stream) {
  if ((long long)h * w == 0) return 0;
  const int32_t* cp = static_cast<const int32_t*>(c);
  const int32_t* lp = static_cast<const int32_t*>(lab);
  int32_t* op = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w < 3 || threads <= 0 || threads % 32 != 0 || threads > kMaxThreads || grid_x <= 0 || grid_y <= 0 ||
      grid_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    if ((long long)grid_x * threads < w) return static_cast<int>(cudaErrorInvalidValue);
    broadcast_cells<<<dim3(grid_x, grid_y), threads, 0, st>>>(cp, lp, op, h, w);
    return static_cast<int>(cudaGetLastError());
  }
  const int hc = (h + 1) / 2;
  if (route != 0 || w % 4 != 0 || reinterpret_cast<uintptr_t>(c) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(lab) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 || k_rows <= 0 ||
      4LL * grid_x * threads < w || (long long)grid_y * k_rows < hc)
    return static_cast<int>(cudaErrorInvalidValue);
  broadcast_rows<<<dim3(grid_x, grid_y), threads, 0, st>>>(cp, lp, op, h, w, hc, k_rows);
  return static_cast<int>(cudaGetLastError());
}
