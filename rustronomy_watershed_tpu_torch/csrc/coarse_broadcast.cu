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
// coarse plane (2 B/pixel) and writes 4 B/pixel.  Design: one thread per
// fine cell, neighbouring threads on neighbouring columns (coalesced); the
// border columns' extra neighbour reads hit L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVal = (1 << 24) - 1;

__global__ void __launch_bounds__(kThreads)
broadcast_kernel(const int32_t* __restrict__ c, const int32_t* __restrict__ lab,
                 int32_t* __restrict__ out, int h, int w) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (size_t)h * w) return;
  const int x = static_cast<int>(i % w), y = static_cast<int>(i / w);
  const size_t crow = (size_t)(y / 2) * w;
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

}  // namespace

// c: (ceil(h/2), w) int32 coarse plane; lab, out: (h, w) int32; w >= 3.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int rwt_coarse_broadcast(const void* c, const void* lab, void* out,
                                    int h, int w, void* stream) {
  const size_t n = (size_t)h * w;
  if (n == 0) return 0;
  broadcast_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(c), static_cast<const int32_t*>(lab),
      static_cast<int32_t*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
