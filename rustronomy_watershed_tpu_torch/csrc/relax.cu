// Relax kernel: `steps` global Jacobi sweeps of the packed-key priority
// relaxation in one launch.
//
// Replaces two TPU kernels of rustronomy_watershed_tpu/ops/pallas_relax.py:
// `_relax_kernel` (full-width bands, launched by `relax_block`) and
// `_relax_kernel2d` (column stripes with a 128-lane halo for widths >= 5120,
// launched by `relax_block2d`).  Both compute the same function: the
// per-sweep update of pallas_relax.py:413-438, the change flags, the
// convergence witness, the d-saturation detector and (with `stats`) the
// stats-only epilogue of pallas_relax.py:575-604.  The 2-D tiles below serve
// every width, so the stripe geometry (`resolve_stripe_config`,
// RWT_RELAX_STRIPES) was TPU tuning and is not carried over; the Jacobi
// ping-pong and centre-only writes are the striped kernel's design.  Not
// carried over either: the fused-scan epilogue, `ctr_cols`, band-activity
// gating and the in-place aliased band DMAs.  Index arithmetic is in size_t
// and the grid is (ceil(w/T), ceil(h/T)): 256 x 256 blocks at 16384^2.
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
//   * block results reach the three int32 flags through atomicOr;
//   * with `stats`, the write-back loop also reduces the merging shortcut's
//     statistics over the real image (interior = rows 1..h-2, columns
//     1..w-2; claimed = label != 0): the unclaimed interior count, whether a
//     border cell is claimed, and the least claimed interior label (kInf
//     when there is none).  Warp reductions, then shared-memory atomics,
//     then one atomicAdd / atomicOr / atomicMin per block.  `stats` is a
//     template parameter: the segmenting instantiation holds none of this
//     code (a runtime flag measured 7% slower there on an H100).
// Later work: skip converged tiles, TMA loads, no per-call host flag read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32, kTy = 8;  // block shape: one warp per window row
constexpr int kBigLab = 1 << 30;
constexpr int kInf = 1 << 29;  // "no claimed interior cell" (scan_merge _INF)

template <bool kStats>
__global__ void __launch_bounds__(kTx * kTy)
relax_kernel(const uint8_t* __restrict__ v, const int32_t* __restrict__ key_in,
             const int32_t* __restrict__ lab_in, int32_t* __restrict__ key_out,
             int32_t* __restrict__ lab_out, int32_t* __restrict__ flags, int h,
             int w, int steps, int d_bits, int tile) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t s_uncl, s_min;
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
  if (kStats && tx == 0 && ty == 0) {
    s_uncl = 0;
    s_min = kInf;
  }

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

  bool sat = false, cl_border = false;
  int uncl = 0, gmin = kInf;
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
      if constexpr (kStats) {
        if (gy >= 1 && gy <= h - 2 && gx >= 1 && gx <= w - 2) {
          if (l == 0) ++uncl;
          else gmin = min(gmin, l);
        } else {
          cl_border |= l != 0;
        }
      }
    }
  }
  if constexpr (kStats) {
    const int wu = __reduce_add_sync(0xffffffffu, uncl);
    const int wm = __reduce_min_sync(0xffffffffu, gmin);
    if (tx == 0) {
      if (wu) atomicAdd(&s_uncl, wu);
      atomicMin(&s_min, wm);
    }
  }
  // Also the barrier after the shared-memory atomics above.
  sat = __syncthreads_or(sat) != 0;
  if constexpr (kStats) cl_border = __syncthreads_or(cl_border) != 0;
  if (tx == 0 && ty == 0) {
    if (any_c) atomicOr(flags + 0, 1);
    if (last_c) atomicOr(flags + 1, 1);
    if (sat) atomicOr(flags + 2, 1);
    if constexpr (kStats) {
      if (s_uncl) atomicAdd(flags + 3, s_uncl);
      if (cl_border) atomicOr(flags + 4, 1);
      atomicMin(flags + 5, s_min);
    }
  }
}

}  // namespace

// v: (h, w) u8; key_in, lab_in -> key_out, lab_out: (h, w) int32 (outputs
// must not alias inputs); flags: int32 [changed_any, changed_last, sat],
// followed when `stats` is nonzero by [n_unclaimed_interior,
// any_claimed_border, min_claimed_interior_label], initialised here.
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// (nonzero when the launch was refused).
extern "C" int rwt_relax(const void* v, const void* key_in, const void* lab_in,
                         void* key_out, void* lab_out, void* flags, int h,
                         int w, int steps, int d_bits, int tile, int stats,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = tile + 2 * steps;
  const size_t smem = (size_t)W * W * (4 * sizeof(int32_t) + 1);
  auto kernel = stats ? relax_kernel<true> : relax_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(flags, 0, (stats ? 5 : 3) * sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (stats) {
    // Bytes of 0x7f make 0x7f7f7f7f > kInf; every block's atomicMin brings
    // the slot down to at most kInf.
    e = cudaMemsetAsync(static_cast<int32_t*>(flags) + 5, 0x7f, sizeof(int32_t), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((w + tile - 1) / tile, (h + tile - 1) / tile);
  kernel<<<grid, dim3(kTx, kTy), smem, st>>>(
      static_cast<const uint8_t*>(v), static_cast<const int32_t*>(key_in),
      static_cast<const int32_t*>(lab_in), static_cast<int32_t*>(key_out),
      static_cast<int32_t*>(lab_out), static_cast<int32_t*>(flags), h, w,
      steps, d_bits, tile);
  return static_cast<int>(cudaGetLastError());
}
