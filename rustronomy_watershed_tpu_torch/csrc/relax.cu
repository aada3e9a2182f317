// Relax kernel: `steps` global Jacobi sweeps of the packed-key priority
// relaxation in one launch.
//
// Replaces the TPU kernel rustronomy_watershed_tpu/ops/pallas_relax.py
// `_relax_kernel` (launched by `relax_block`), plain variant: the per-sweep
// update of pallas_relax.py:413-438, the change flags, the convergence
// witness and the d-saturation detector.  Not carried over: the stats-only
// and fused-scan epilogues, `ctr_cols`, band-activity gating and the
// in-place aliased band DMAs.
//
// Update of one cell (key = L << d_bits | d, see ops/relax.py):
//   best  = min(key, max(ext(min4 kq), vcand)),  ext(a) = min(a+1, a|d_mask)
//   label = min label of 4-neighbours with kq < best; kept if none, or if
//           best is still unclaimed (claimed-ness gate).
// Cells outside the image read as key `unclaimed`, label 0, value 255: they
// never change and never donate, as the TPU layout's aprons.  Every key is
// <= unclaimed = 255 << d_bits, so kmin + 1 and vkey + 1 stay below 2^31.
//
// What bounds it: on-chip work.  Each block loads a (T+2S)^2 window of the
// planes (T = centre tile, S = steps) into shared memory once, runs S sweeps
// there and writes back its T^2 centre: device memory sees about
// 9 B/cell * ((T+2S)/T)^2 in and 8 B/cell out per call instead of per sweep,
// and the sweeps cost shared-memory reads and integer ops.  Design:
//   * Jacobi ping-pong in shared memory (two key and two label buffers), so
//     one launch equals exactly S global sweeps, bit for bit;
//   * sweep j updates only window cells at distance >= j from the window
//     edge: those are exact (their dependency cone lies in the window), and
//     after S sweeps the exact region is precisely the centre;
//   * change counting and the saturation test run over centre cells only:
//     a centre cell at internal sweep j equals the global sweep j, so "the
//     last sweep changed no centre cell in any block" certifies the fixed
//     point (pallas_relax.py:499-508);
//   * when a sweep changes nothing in a block's exact region, the remaining
//     sweeps are the identity there, and the block stops early;
//   * block results reach the three int32 flags through atomicOr.
// Later work: skip converged tiles, TMA loads, no per-call host flag read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32, kTy = 8;  // block shape: one warp per window row
constexpr int kBigLab = 1 << 30;

__global__ void __launch_bounds__(kTx * kTy)
relax_kernel(const uint8_t* __restrict__ v, const int32_t* __restrict__ key_in,
             const int32_t* __restrict__ lab_in, int32_t* __restrict__ key_out,
             int32_t* __restrict__ lab_out, int32_t* __restrict__ flags, int h,
             int w, int steps, int d_bits, int tile) {
  extern __shared__ int32_t smem[];
  const int S = steps, T = tile, W = T + 2 * S, N = W * W;
  int32_t* kc = smem;  // current keys
  int32_t* kn = kc + N;  // next keys
  int32_t* lc = kn + N;
  int32_t* ln = lc + N;
  uint8_t* vs = reinterpret_cast<uint8_t*>(ln + N);
  const int unclaimed = 255 << d_bits;
  const int d_mask = (1 << d_bits) - 1;
  const int y0 = blockIdx.y * T - S, x0 = blockIdx.x * T - S;
  const int tx = threadIdx.x, ty = threadIdx.y;

  for (int wy = ty; wy < W; wy += kTy) {
    const int gy = y0 + wy;
    for (int wx = tx; wx < W; wx += kTx) {
      const int gx = x0 + wx, c = wy * W + wx;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const size_t g = (size_t)gy * w + gx;
        kc[c] = key_in[g];
        lc[c] = lab_in[g];
        vs[c] = v[g];
      } else {
        kc[c] = unclaimed;
        lc[c] = 0;
        vs[c] = 255;
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
        const int k = kc[c], l = lc[c];
        const int ku = kc[c - W], kd = kc[c + W], kl = kc[c - 1], kr = kc[c + 1];
        const int kmin = min(min(ku, kd), min(kl, kr));
        const int ext = min(kmin + 1, kmin | d_mask);
        const int vcand = min((static_cast<int>(vs[c]) << d_bits) + 1, unclaimed);
        const int best = min(k, max(ext, vcand));
        int lm = kBigLab;
        if (ku < best) lm = min(lm, lc[c - W]);
        if (kd < best) lm = min(lm, lc[c + W]);
        if (kl < best) lm = min(lm, lc[c - 1]);
        if (kr < best) lm = min(lm, lc[c + 1]);
        const int nl = (lm == kBigLab || best == unclaimed) ? l : lm;
        kn[c] = best;
        ln[c] = nl;
        const bool ch = best != k || nl != l;
        reg_c |= ch;
        ctr_c |= ch && ctr_row && wx >= S && wx < S + T;
      }
    }
    // Both reductions double as the barrier before the next sweep.
    const bool reg_any = __syncthreads_or(reg_c) != 0;
    last_c = __syncthreads_or(ctr_c) != 0;
    any_c |= last_c;
    int32_t* t = kc; kc = kn; kn = t;
    t = lc; lc = ln; ln = t;
    // Quiet exact region: every later sweep is the identity on it, so the
    // centre and last_c (already false) are final.
    if (!reg_any) break;
  }

  bool sat = false;
  for (int cy = ty; cy < T; cy += kTy) {
    const int gy = blockIdx.y * T + cy;
    if (gy >= h) break;
    for (int cx = tx; cx < T; cx += kTx) {
      const int gx = blockIdx.x * T + cx;
      if (gx >= w) break;
      const int c = (S + cy) * W + (S + cx);
      const size_t g = (size_t)gy * w + gx;
      const int k = kc[c], l = lc[c];
      key_out[g] = k;
      lab_out[g] = l;
      sat |= k < unclaimed && l == 0;
    }
  }
  sat = __syncthreads_or(sat) != 0;
  if (tx == 0 && ty == 0) {
    if (any_c) atomicOr(flags + 0, 1);
    if (last_c) atomicOr(flags + 1, 1);
    if (sat) atomicOr(flags + 2, 1);
  }
}

}  // namespace

// v: (h, w) u8; key_in, lab_in -> key_out, lab_out: (h, w) int32 (outputs
// must not alias inputs); flags: 3 int32 [changed_any, changed_last, sat],
// zeroed here.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (nonzero when the launch was refused).
extern "C" int rwt_relax(const void* v, const void* key_in, const void* lab_in,
                         void* key_out, void* lab_out, void* flags, int h,
                         int w, int steps, int d_bits, int tile,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = tile + 2 * steps;
  const size_t smem = (size_t)W * W * (4 * sizeof(int32_t) + 1);
  cudaError_t e = cudaFuncSetAttribute(
      relax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(flags, 0, 3 * sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((w + tile - 1) / tile, (h + tile - 1) / tile);
  relax_kernel<<<grid, dim3(kTx, kTy), smem, st>>>(
      static_cast<const uint8_t*>(v), static_cast<const int32_t*>(key_in),
      static_cast<const int32_t*>(lab_in), static_cast<int32_t*>(key_out),
      static_cast<int32_t*>(lab_out), static_cast<int32_t*>(flags), h, w,
      steps, d_bits, tile);
  return static_cast<int>(cudaGetLastError());
}
