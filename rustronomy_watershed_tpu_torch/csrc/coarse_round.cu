// Coarse round kernel: one round of segmented min scans over the whole
// packed coarse plane, as two deterministic passes.
//
// Replaces the TPU kernel rustronomy_watershed_tpu/ops/scan_merge.py
// `_cmulti_kernel` (launched by `_call_multi_kernel`).  That kernel ran a
// sequential band grid with Gauss-Seidel chaining in alternating band
// order, k = 2 sub-iterations per band, a 256-lane window on the h-scans and
// `RWT_COARSE_*` knobs: all of it tuning for one TPU core walking bands in
// order.  Blocks on Hopper run in no order, so a round here is:
//   * the v-pass: in every column, a forward segmented min scan under the
//     bit-24 resets, then a backward one under the bit-25 resets, over the
//     full height (plane `in` -> `scratch`);
//   * the h-pass: the same along every row under bits 26 / 27, over the full
//     width (`scratch` -> `out`).
// A full-length scan moves a minimum across a whole run in one pass.  Each
// pass reads one plane and writes another, so one launch equals its plain
// twin (ops/scan_merge.py::coarse_round_plain) bit for bit, the change count
// included, and the fixed point is the unique component-min one.  The host
// stops after a round that changed no cell: the change-based certificate of
// scan_merge.py:1114-1128.
//
// What bounds it: bytes.  A round moves the plane (4 B per coarse cell) in
// and out of each pass.  Design of a pass: a block owns 32 (v) or 8 (h)
// lines; each line is cut into 32 chunks, one thread per chunk.  A thread
// folds its chunk into a (value, reset-seen) aggregate, one thread per line
// chains the 32 aggregates into each chunk's carry (shared memory), and the
// thread rescans its chunk from that carry; the backward scan repeats this
// on the forward result, which the thread reads back from `out`.  Changes
// are counted with warp reductions and one atomicAdd per warp.  In the
// v-pass a warp covers 32 neighbouring columns (coalesced); in the h-pass a
// warp covers the 32 chunks of one row, and L1 serves the strided reads.
// Speed work (shared-memory tiles for the h-pass, fusing the two passes'
// traffic, skipping converged lines) is left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVal = (1 << 24) - 1;
constexpr int kInf = 1 << 29;
constexpr int kChunks = 32;

__device__ __forceinline__ int value_of(int c) {
  const int x = c & kVal;
  return x == 0 ? kInf : x;
}

template <bool V>
__global__ void __launch_bounds__(1024)
pass_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
            int32_t* __restrict__ changed, int hc, int w) {
  constexpr int kLines = V ? 32 : 8;  // lines per block
  constexpr int kFwd = V ? 24 : 26, kBwd = kFwd + 1;  // reset bits
  __shared__ int agg_v[kLines][kChunks + 1];
  __shared__ int agg_r[kLines][kChunks + 1];
  __shared__ int carry[kLines][kChunks + 1];
  const int lane = threadIdx.x;
  const int li = V ? lane : threadIdx.y;  // line within the block
  const int ck = V ? threadIdx.y : lane;  // chunk within the line
  const int n = V ? hc : w, n_lines = V ? w : hc;
  const int line = blockIdx.x * kLines + li;
  const int len = (n + kChunks - 1) / kChunks;
  const int s = min(n, ck * len), e = min(n, s + len);
  const bool live = line < n_lines;
  const size_t base = V ? (size_t)line : (size_t)line * w;
  const size_t stride = V ? (size_t)w : 1;

  // Forward: F[i] = reset ? x[i] : min(x[i], F[i-1]).  Chunk aggregate =
  // F at the chunk's end as a function of the carry: (min since the last
  // reset, whether a reset was seen).
  int m = kInf, r = 0;
  if (live) {
    for (int i = s; i < e; ++i) {
      const int c = in[base + i * stride];
      const int x = value_of(c);
      if ((c >> kFwd) & 1) {
        m = x;
        r = 1;
      } else {
        m = min(m, x);
      }
    }
  }
  agg_v[li][ck] = m;
  agg_r[li][ck] = r;
  __syncthreads();
  if (ck == 0) {
    int cin = kInf;
    for (int k = 0; k < kChunks; ++k) {
      carry[li][k] = cin;
      cin = agg_r[li][k] ? agg_v[li][k] : min(agg_v[li][k], cin);
    }
  }
  __syncthreads();

  // Forward scan into `out`; on the way, the backward aggregate: B at the
  // chunk's start as a function of the carry from above = (min of F up to
  // and including the first backward reset, whether one was seen).
  int f = carry[li][ck];
  int bm = kInf, br = 0;
  if (live) {
    for (int i = s; i < e; ++i) {
      const size_t g = base + i * stride;
      const int c = in[g];
      const int x = value_of(c);
      f = ((c >> kFwd) & 1) ? x : min(x, f);
      out[g] = f;
      if (!br) {
        bm = min(bm, f);
        br = (c >> kBwd) & 1;
      }
    }
  }
  agg_v[li][ck] = bm;
  agg_r[li][ck] = br;
  __syncthreads();
  if (ck == 0) {
    int cin = kInf;
    for (int k = kChunks - 1; k >= 0; --k) {
      carry[li][k] = cin;
      cin = agg_r[li][k] ? agg_v[li][k] : min(agg_v[li][k], cin);
    }
  }
  __syncthreads();

  // Backward scan: B[i] = reset ? F[i] : min(F[i], B[i+1]); empty cells
  // stay 0, the reset bits are kept.
  int b = carry[li][ck];
  int ch = 0;
  if (live) {
    for (int i = e - 1; i >= s; --i) {
      const size_t g = base + i * stride;
      const int c = in[g];
      const int fv = out[g];
      b = ((c >> kBwd) & 1) ? fv : min(fv, b);
      const int o = (c & kVal) == 0 ? 0 : b;
      out[g] = (c & ~kVal) | o;
      ch += o != (c & kVal);
    }
  }
  ch = __reduce_add_sync(0xffffffffu, ch);
  if (lane == 0 && ch) atomicAdd(changed, ch);
}

}  // namespace

// c, scratch, out: (hc, w) int32 packed coarse planes; `out` may be `c`,
// `scratch` aliases neither.  changed: one int32, zeroed here, then the
// number of cells the v-pass and the h-pass changed.  Launches both passes
// on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int rwt_coarse_round(const void* c, void* scratch, void* out,
                                void* changed, int hc, int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(changed, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (hc == 0 || w == 0) return 0;
  int32_t* ch = static_cast<int32_t*>(changed);
  pass_kernel<true><<<(w + 31) / 32, dim3(32, 32), 0, st>>>(
      static_cast<const int32_t*>(c), static_cast<int32_t*>(scratch), ch, hc, w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  pass_kernel<false><<<(hc + 7) / 8, dim3(32, 8), 0, st>>>(
      static_cast<const int32_t*>(scratch), static_cast<int32_t*>(out), ch, hc, w);
  return static_cast<int>(cudaGetLastError());
}
