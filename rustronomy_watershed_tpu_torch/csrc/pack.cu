// Pack kernel: image -> packed relax planes (v, key, lab) + seed count.
//
// Replaces the TPU kernel rustronomy_watershed_tpu/ops/pallas_pack.py
// `_pack_kernel` (launched by `pack_domain_fused`).  Same outputs, cropped to
// the image (no aprons): seeds are the strict 8-neighbour maxima of the TRUE
// image values, interior only (quirk Q1 — a 255 pixel can be a seed),
// numbered 1..K in row-major order; v is the image with its 1-px border set
// to NEVER_FILL; key is 0 at seeds and `unclaimed` elsewhere; lab holds the
// seed numbers.
//
// What bounds it: bytes.  At 4096^2 it reads the u8 image twice (16.8 MB
// each, the second time mostly from L2) and writes 151 MB of planes
// (u8 v + int32 key + int32 lab); the arithmetic is a few compares per
// pixel.  The TPU kernel carried the running seed count across its
// sequential band grid in SMEM; Hopper blocks run in no order, so the
// row-major numbering is a device-wide exclusive scan in three passes:
//   1. count_rows: one block per row counts its seeds (__syncthreads_count);
//   2. scan_rows:  one block turns the h row counts into exclusive row
//                  offsets (warp shuffles) and writes the total;
//   3. write_rows: one block per row recomputes the mask, ranks seeds within
//                  the row (warp ballots + per-warp offsets, carried across
//                  chunks of the row) and writes all three planes, coalesced.
// Recomputing the mask in pass 3 costs a second image read instead of a
// mask plane written and read back.  Speed work (several rows per block,
// 16-byte loads) is left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNeverFill = 255;

__device__ __forceinline__ bool is_seed(const uint8_t* __restrict__ img, int y,
                                        int x, int h, int w) {
  if (y < 1 || y > h - 2 || x < 1 || x > w - 2) return false;
  const uint8_t* c = img + (size_t)y * w + x;
  const int v = c[0];
  return c[-w - 1] < v && c[-w] < v && c[-w + 1] < v && c[-1] < v &&
         c[1] < v && c[w - 1] < v && c[w] < v && c[w + 1] < v;
}

__global__ void count_rows(const uint8_t* __restrict__ img,
                           int32_t* __restrict__ row_cnt, int h, int w) {
  const int y = blockIdx.x;
  int cnt = 0;
  for (int x0 = 0; x0 < w; x0 += kThreads) {
    cnt += __syncthreads_count(is_seed(img, y, x0 + threadIdx.x, h, w));
  }
  if (threadIdx.x == 0) row_cnt[y] = cnt;
}

// In place: row_cnt[y] <- sum of row_cnt[0..y); *n_seeds <- the total.
__global__ void scan_rows(int32_t* __restrict__ row_cnt,
                          int32_t* __restrict__ n_seeds, int h) {
  __shared__ int32_t warp_sum[32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < h; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int x = i < h ? row_cnt[i] : 0;
    int incl = x;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = carry, total = 0;
    for (int k = 0; k < nwarps; ++k) {
      if (k < warp) before += warp_sum[k];
      total += warp_sum[k];
    }
    if (i < h) row_cnt[i] = before + incl - x;
    __syncthreads();  // everyone has read carry and warp_sum
    if (threadIdx.x == 0) carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) *n_seeds = carry;
}

__global__ void write_rows(const uint8_t* __restrict__ img,
                           const int32_t* __restrict__ row_off,
                           uint8_t* __restrict__ v, int32_t* __restrict__ key,
                           int32_t* __restrict__ lab, int h, int w,
                           int unclaimed) {
  __shared__ int32_t warp_cnt[kWarps];
  const int y = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const bool row_inside = y >= 1 && y <= h - 2;
  int carry = row_off[y];
  for (int x0 = 0; x0 < w; x0 += kThreads) {
    const int x = x0 + threadIdx.x;
    const bool s = is_seed(img, y, x, h, w);
    const unsigned ballot = __ballot_sync(0xffffffffu, s);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int before = carry, total = 0;
    for (int k = 0; k < kWarps; ++k) {
      if (k < warp) before += warp_cnt[k];
      total += warp_cnt[k];
    }
    if (x < w) {
      const size_t g = (size_t)y * w + x;
      const bool inside = row_inside && x >= 1 && x <= w - 2;
      v[g] = inside ? img[g] : (uint8_t)kNeverFill;
      key[g] = s ? 0 : unclaimed;
      lab[g] = s ? before + __popc(ballot & lt_mask) + 1 : 0;
    }
    carry += total;
    __syncthreads();  // warp_cnt is rewritten by the next chunk
  }
}

}  // namespace

extern "C" const char* rwt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// img: (h, w) u8; v: (h, w) u8; key, lab: (h, w) int32; row_cnt: (h,) int32
// scratch; n_seeds: int32 scalar.  All on the device; launches on `stream`
// and does not synchronise.  Returns cudaGetLastError().
extern "C" int rwt_pack(const void* img, void* v, void* key, void* lab,
                        void* row_cnt, void* n_seeds, int h, int w,
                        int unclaimed, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* im = static_cast<const uint8_t*>(img);
  int32_t* rc = static_cast<int32_t*>(row_cnt);
  count_rows<<<h, kThreads, 0, st>>>(im, rc, h, w);
  scan_rows<<<1, 1024, 0, st>>>(rc, static_cast<int32_t*>(n_seeds), h);
  write_rows<<<h, kThreads, 0, st>>>(
      im, rc, static_cast<uint8_t*>(v), static_cast<int32_t*>(key),
      static_cast<int32_t*>(lab), h, w, unclaimed);
  return static_cast<int>(cudaGetLastError());
}
