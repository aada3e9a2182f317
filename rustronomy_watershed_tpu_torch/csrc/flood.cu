// Flood kernel: `steps` global Jacobi flood sweeps at one water level in one
// launch.
//
// Replaces the TPU kernel rustronomy_watershed_tpu/ops/pallas_flood.py
// `_flood_kernel` (launched by `flood_block`): P fused flood sweeps, the
// per-call "painted" flag and the last-sweep change flag that certifies the
// per-level fixed point.  Not carried over: the per-band label ping-pong in
// device memory with its `cur` bitmap, the band activity list and the int8
// image bias, which are layout devices of the TPU.
//
// Update of one cell at level `lvl` (ops/flood.py):
//   an uncoloured cell (label 0) with img <= lvl and a coloured 4-neighbour
//   takes the least coloured 4-neighbour label; every other cell keeps its
//   label.
// The caller gives the image with its border ring forced to NEVER_FILL (255
// > every water level), so border cells are never painted but still donate
// their labels, and the kernel needs no interior mask.  Cells outside the
// image read as uncoloured and never floodable.
//
// What bounds it: on-chip work and, per call, one pass over the planes.
// Each block loads a (T+2S)^2 window of labels and the floodable bit
// (img <= lvl) into shared memory once, runs S sweeps there and writes back
// its T^2 centre: device memory sees about 5 B/cell * ((T+2S)/T)^2 in and
// 4 B/cell out per call instead of per sweep.  Design, as csrc/relax.cu:
//   * Jacobi ping-pong of two label buffers in shared memory, so one launch
//     equals exactly S global sweeps, bit for bit;
//   * sweep j updates only window cells at distance >= j from the window
//     edge, which are exact; after S sweeps the exact region is the centre;
//   * the flags count centre cells only: a centre cell at internal sweep j
//     equals global sweep j, so "the last sweep changed no centre cell in
//     any block" certifies the level's fixed point, and painting is
//     monotone (0 -> label), so "some sweep changed a centre cell" is "the
//     output differs from the input";
//   * when a sweep changes nothing in a block's exact region, the remaining
//     sweeps are the identity there, and the block stops early; a block
//     with no floodable uncoloured cell stops after its first sweep.
// Later work: skip quiet tiles without loading them (the TPU's band
// activity), no per-call host flag read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32, kTy = 8;  // block shape: one warp per window row
constexpr int kNone = 0x7fffffff;  // "no coloured neighbour"

__device__ __forceinline__ int colour_min(int a, int b) {
  // The least of the nonzero values; 0 (uncoloured) never wins.
  return b != 0 && b < a ? b : a;
}

__global__ void __launch_bounds__(kTx * kTy)
flood_kernel(const uint8_t* __restrict__ img, const int32_t* __restrict__ lab_in,
             int32_t* __restrict__ lab_out, int32_t* __restrict__ flags, int h,
             int w, int lvl, int steps, int tile) {
  extern __shared__ int32_t smem[];
  const int S = steps, T = tile, W = T + 2 * S, N = W * W;
  int32_t* lc = smem;  // current labels
  int32_t* ln = lc + N;  // next labels
  uint8_t* fl = reinterpret_cast<uint8_t*>(ln + N);  // img <= lvl
  const int y0 = blockIdx.y * T - S, x0 = blockIdx.x * T - S;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int wy = ty; wy < W; wy += kTy) {
    const int gy = y0 + wy;
    for (int wx = tx; wx < W; wx += kTx) {
      const int gx = x0 + wx, c = wy * W + wx;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const size_t g = (size_t)gy * w + gx;
        lc[c] = lab_in[g];
        fl[c] = img[g] <= lvl;
      } else {
        lc[c] = 0;
        fl[c] = 0;
      }
    }
  }
  __syncthreads();

  bool any_c = false, last_c = false;
  for (int s = 1; s <= S; ++s) {
    bool reg_c = false, ctr_c = false;
    for (int wy = s + ty; wy < W - s; wy += kTy) {
      const bool ctr_row = wy >= S && wy < S + T;
      for (int wx = s + tx; wx < W - s; wx += kTx) {
        const int c = wy * W + wx;
        const int l = lc[c];
        int nl = l;
        if (l == 0 && fl[c]) {
          int m = colour_min(kNone, lc[c - W]);
          m = colour_min(m, lc[c + W]);
          m = colour_min(m, lc[c - 1]);
          m = colour_min(m, lc[c + 1]);
          if (m != kNone) nl = m;
        }
        ln[c] = nl;
        const bool ch = nl != l;
        reg_c |= ch;
        ctr_c |= ch && ctr_row && wx >= S && wx < S + T;
      }
    }
    // Both reductions double as the barrier before the next sweep.
    const bool reg_any = __syncthreads_or(reg_c) != 0;
    last_c = __syncthreads_or(ctr_c) != 0;
    any_c |= last_c;
    int32_t* t = lc; lc = ln; ln = t;
    // Quiet exact region: every later sweep is the identity on it, so the
    // centre and last_c (already false) are final.
    if (!reg_any) break;
  }

  for (int cy = ty; cy < T; cy += kTy) {
    const int gy = blockIdx.y * T + cy;
    if (gy >= h) break;
    for (int cx = tx; cx < T; cx += kTx) {
      const int gx = blockIdx.x * T + cx;
      if (gx >= w) break;
      lab_out[(size_t)gy * w + gx] = lc[(S + cy) * W + (S + cx)];
    }
  }
  if (tx == 0 && ty == 0) {
    if (any_c) atomicOr(flags + 0, 1);
    if (last_c) atomicOr(flags + 1, 1);
  }
}

}  // namespace

// img: (h, w) u8 with its border ring at 255; lab_in -> lab_out: (h, w)
// int32 (the output must not alias the input); flags: int32 [painted,
// not_converged], initialised here.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (nonzero when the launch was
// refused).
extern "C" int rwt_flood(const void* img, const void* lab_in, void* lab_out,
                         void* flags, int h, int w, int lvl, int steps,
                         int tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = tile + 2 * steps;
  const size_t smem = (size_t)W * W * (2 * sizeof(int32_t) + 1);
  cudaError_t e = cudaFuncSetAttribute(
      flood_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(flags, 0, 2 * sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((w + tile - 1) / tile, (h + tile - 1) / tile);
  flood_kernel<<<grid, dim3(kTx, kTy), smem, st>>>(
      static_cast<const uint8_t*>(img), static_cast<const int32_t*>(lab_in),
      static_cast<int32_t*>(lab_out), static_cast<int32_t*>(flags), h, w, lvl,
      steps, tile);
  return static_cast<int>(cudaGetLastError());
}
