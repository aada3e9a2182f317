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
// What bounds it: bytes.  It reads the u8 image (1 B/pixel) and writes u8 v
// plus int32 key and lab (9 B/pixel): 0.05 ms at 4096^2 and 0.80 ms at
// 16384^2 at 3.35 TB/s; the arithmetic is a few SIMD compares per 4 pixels.
// The TPU kernel carried the running seed count across its sequential band
// grid in SMEM; Hopper blocks run in no order, so the row-major numbering is
// a device-wide exclusive scan, done in the same pass by a decoupled
// look-back:
//   * `pack_bands` (rows of at most 16384 pixels): a block takes a band of
//     kBandRows = 8 full rows, its band id from an atomic
//     ticket, so every band it waits on has started.  A thread owns a group
//     of 16 columns and walks down the band holding rows y-1, y and y+1 of
//     its group in registers, one 16-byte load per new row; the pixels
//     beside the group come from lane +-1 by shuffle (a warp's edge lanes
//     load one byte).  So the image is read once, plus two halo rows a band.
//     The seed test is four-bytes-at-a-time SIMD compares (__vcmpltu4 on
//     byte-shifted words).  v and key depend only on the mask, so they go
//     out at once: v as one 16-byte store, key as four 16-byte stores whose
//     lanes are transposed (a warp's store covers 512 contiguous bytes).
//     The band's 16-bit row masks stay in registers; their popcounts, two
//     rows packed per int, are scanned across the block in row-major order;
//     the band total is published as an aggregate, the look-back (one warp,
//     32 predecessors a step) gives the band's offset, the inclusive prefix
//     is published, and lab is written from the held masks, transposed as
//     key is.  The last band writes n_seeds.  Widths that are not a
//     multiple of 16, or an unaligned plane, take the same kernel with
//     byte-wise loads and stores (kVec false).
//   * Wider rows keep the first design's three launches (`count_rows`, a
//     one-block `scan_rows`, `write_rows`: one block per row, the image read
//     twice).  No main-path width takes it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeverFill = 255;
constexpr int kBandRows = 8;           // ops/pack.py _BAND_ROWS
constexpr int kMaxBandThreads = 1024;  // ops/pack.py _BAND_THREADS: 16384 columns
constexpr unsigned kFull = 0xffffffffu;

// -- the band kernel ----------------------------------------------------------

// A row of a thread's 16-column group: q[k] holds pixels 4k..4k+3 (byte 0
// the leftmost), l holds the pixel left of the group in byte 3, r the pixel
// right of it in byte 0; zeros outside the image.
struct Row {
  uint32_t q[4];
  uint32_t l, r;
};

__device__ __forceinline__ unsigned long long ld_acquire64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

template <bool kVec>
__device__ __forceinline__ Row load_row(const uint8_t* __restrict__ img, int y, int h, int w, int x0,
                                        int lane) {
  Row a = {{0u, 0u, 0u, 0u}, 0u, 0u};
  const bool in = y >= 0 && y < h;
  const uint8_t* p = img + (size_t)(in ? y : 0) * w;
  if (in && x0 < w) {
    if constexpr (kVec) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p + x0));
      a.q[0] = t.x;
      a.q[1] = t.y;
      a.q[2] = t.z;
      a.q[3] = t.w;
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (x0 + i < w) a.q[i >> 2] |= (uint32_t)p[x0 + i] << (8 * (i & 3));
    }
  }
  a.l = __shfl_up_sync(kFull, a.q[3], 1);
  a.r = __shfl_down_sync(kFull, a.q[0], 1);
  if (lane == 0) a.l = (in && x0 >= 1) ? (uint32_t)p[x0 - 1] << 24 : 0u;
  if (lane == 31) a.r = (in && x0 + 16 < w) ? (uint32_t)p[x0 + 16] : 0u;
  return a;
}

// Bit 7 of each byte -> bits 0..3.
__device__ __forceinline__ uint32_t nibble(uint32_t m) {
  return ((m & 0x80808080u) * 0x00204081u) >> 28;
}

// 16-bit mask of the group's pixels whose eight neighbours are all smaller.
__device__ __forceinline__ uint32_t strict_maxima(const Row& u, const Row& c, const Row& d) {
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t x = c.q[k];
    // Byte j of left(a) is the pixel left of pixel 4k+j, of right(a) the one right of it.
    auto left = [&](const Row& a) { return __byte_perm(k ? a.q[k - 1] : a.l, a.q[k], 0x6543); };
    auto right = [&](const Row& a) { return __byte_perm(a.q[k], k < 3 ? a.q[k + 1] : a.r, 0x4321); };
    const uint32_t m = __vcmpltu4(u.q[k], x) & __vcmpltu4(left(u), x) & __vcmpltu4(right(u), x) &
                       __vcmpltu4(left(c), x) & __vcmpltu4(right(c), x) & __vcmpltu4(d.q[k], x) &
                       __vcmpltu4(left(d), x) & __vcmpltu4(right(d), x);
    bits |= nibble(m) << (4 * k);
  }
  return bits;
}

// Bytes 0xff where the nibble's bit is set.
__device__ __forceinline__ uint32_t bytes_of(uint32_t n) {
  return (n & 1 ? 0xffu : 0u) | (n & 2 ? 0xff00u : 0u) | (n & 4 ? 0xff0000u : 0u) | (n & 8 ? 0xff000000u : 0u);
}

// status: [ticket, then one word per band: flag << 32 | count], zero at
// launch; flag 1 = the band's aggregate, 2 = the inclusive prefix.
template <bool kVec>
__global__ void __launch_bounds__(kMaxBandThreads, 1)
pack_bands(const uint8_t* __restrict__ img, uint8_t* __restrict__ v, int32_t* __restrict__ key,
           int32_t* __restrict__ lab, unsigned long long* status, int32_t* __restrict__ n_seeds, int h,
           int w, int unclaimed) {
  constexpr int R = kBandRows;
  constexpr int kP = R / 2;  // two rows' counts per int
  __shared__ int s_band, s_off;
  __shared__ uint32_t s_warp[32][kP];
  __shared__ uint32_t s_tot[kP];
  __shared__ int s_rowoff[R + 1];
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5, nw = blockDim.x >> 5;
  if (t == 0) s_band = (int)atomicAdd(reinterpret_cast<unsigned*>(status), 1u);
  __syncthreads();
  const int band = s_band, y0 = band * R;
  const int x0 = 16 * t;
  const int wx = 16 * (t & ~31);  // the warp's first column
  const int sub = lane & 3, src_lane = lane >> 2;
  uint32_t seedcols = 0, edge = 0;  // columns 1..w-2; columns 0 and w-1
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int x = x0 + i;
    seedcols |= (x >= 1 && x <= w - 2 ? 1u : 0u) << i;
    edge |= (x == 0 || x == w - 1 ? 1u : 0u) << i;
  }

  uint32_t masks[kP], cnt[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) masks[p] = cnt[p] = 0;
  Row u = load_row<kVec>(img, y0 - 1, h, w, x0, lane);
  Row c = load_row<kVec>(img, y0, h, w, x0, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = y0 + r;
    if (y >= h) break;  // uniform over the block
    const Row d = load_row<kVec>(img, y + 1, h, w, x0, lane);
    const bool inner_row = y >= 1 && y <= h - 2;
    const uint32_t m = inner_row ? strict_maxima(u, c, d) & seedcols : 0u;
    masks[r / 2] |= m << (16 * (r & 1));
    cnt[r / 2] += (uint32_t)__popc(m) << (16 * (r & 1));
    const size_t g = (size_t)y * w;
    if constexpr (kVec) {
      if (x0 < w) {
        uint4 o;
        o.x = inner_row ? c.q[0] | bytes_of(edge & 15) : 0xffffffffu;
        o.y = inner_row ? c.q[1] | bytes_of((edge >> 4) & 15) : 0xffffffffu;
        o.z = inner_row ? c.q[2] | bytes_of((edge >> 8) & 15) : 0xffffffffu;
        o.w = inner_row ? c.q[3] | bytes_of(edge >> 12) : 0xffffffffu;
        *reinterpret_cast<uint4*>(v + g + x0) = o;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // int4 k*32 + lane of the warp's 512 columns
        const uint32_t n = (__shfl_sync(kFull, m, 8 * k + src_lane) >> (4 * sub)) & 15u;
        const int xq = wx + 128 * k + 4 * lane;
        if (xq < w) {
          const int4 o = {n & 1 ? 0 : unclaimed, n & 2 ? 0 : unclaimed, n & 4 ? 0 : unclaimed,
                          n & 8 ? 0 : unclaimed};
          *reinterpret_cast<int4*>(key + g + xq) = o;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (x0 + i < w) {
          const uint32_t px = (c.q[i >> 2] >> (8 * (i & 3))) & 0xffu;
          v[g + x0 + i] = (uint8_t)(inner_row && !((edge >> i) & 1) ? px : kNeverFill);
          key[g + x0 + i] = (m >> i) & 1 ? 0 : unclaimed;
        }
      }
    }
    u = c;
    c = d;
  }

  // Exclusive prefixes of the row counts over the block's threads (two rows
  // per int: a row of at most 16384 pixels holds at most 8192 seeds).
  uint32_t incl[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    incl[p] = cnt[p];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t n = __shfl_up_sync(kFull, incl[p], o);
      if (lane >= o) incl[p] += n;
    }
    if (lane == 31) s_warp[wid][p] = incl[p];
  }
  __syncthreads();
  if (t < kP) {
    uint32_t run = 0;
    for (int k = 0; k < nw; ++k) {
      const uint32_t x = s_warp[k][t];
      s_warp[k][t] = run;
      run += x;
    }
    s_tot[t] = run;
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kP; ++p) cnt[p] = s_warp[wid][p] + incl[p] - cnt[p];  // now exclusive
  if (t == 0) {
    int run = 0;
    for (int r = 0; r < R; ++r) {
      s_rowoff[r] = run;
      run += (s_tot[r / 2] >> (16 * (r & 1))) & 0xffffu;
    }
    s_rowoff[R] = run;
  }
  __syncthreads();

  // The band's offset: publish the aggregate, look back 32 bands a step
  // until an inclusive prefix, publish the inclusive prefix.
  if (wid == 0) {
    const unsigned agg = (unsigned)s_rowoff[R];
    unsigned long long* bands = status + 1;
    unsigned excl = 0;
    if (band > 0) {
      if (lane == 0) st_release64(bands + band, (1ull << 32) | agg);
      for (int end = band;; end -= 32) {
        const int k = end - 1 - lane;
        unsigned long long s = 2ull << 32;  // before band 0: an inclusive 0
        if (k >= 0) {
          while (((s = ld_acquire64(bands + k)) >> 32) == 0) {
          }
        }
        const unsigned inc = __ballot_sync(kFull, (s >> 32) == 2);
        const int first = inc ? __ffs(inc) - 1 : 32;
        unsigned x = lane <= first ? (unsigned)s : 0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
        excl += x;
        if (inc) break;
      }
    }
    if (lane == 0) {
      st_release64(bands + band, (2ull << 32) | (excl + agg));
      s_off = (int)excl;
      if (band == gridDim.x - 1) *n_seeds = (int)(excl + agg);
    }
  }
  __syncthreads();

  const int off = s_off;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = y0 + r;
    if (y >= h) break;
    const uint32_t m = (masks[r / 2] >> (16 * (r & 1))) & 0xffffu;
    const int e = (int)((cnt[r / 2] >> (16 * (r & 1))) & 0xffffu) + s_rowoff[r] + off;
    const size_t g = (size_t)y * w;
    if constexpr (kVec) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t sm = __shfl_sync(kFull, m, 8 * k + src_lane);
        int base = __shfl_sync(kFull, e, 8 * k + src_lane) + __popc(sm & ((1u << (4 * sub)) - 1u));
        const uint32_t n = (sm >> (4 * sub)) & 15u;
        const int xq = wx + 128 * k + 4 * lane;
        int4 o;
        o.x = n & 1 ? ++base : 0;
        o.y = n & 2 ? ++base : 0;
        o.z = n & 4 ? ++base : 0;
        o.w = n & 8 ? ++base : 0;
        if (xq < w) *reinterpret_cast<int4*>(lab + g + xq) = o;
      }
    } else {
      int base = e;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const bool s = (m >> i) & 1;
        if (s) ++base;
        if (x0 + i < w) lab[g + x0 + i] = s ? base : 0;
      }
    }
  }
}

// -- the wide route: the first design, three launches --------------------------

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
  for (int x0 = 0; x0 < w; x0 += blockDim.x) {
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
  __shared__ int32_t warp_cnt[32];
  const int y = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const bool row_inside = y >= 1 && y <= h - 2;
  int carry = row_off[y];
  for (int x0 = 0; x0 < w; x0 += blockDim.x) {
    const int x = x0 + threadIdx.x;
    const bool s = is_seed(img, y, x, h, w);
    const unsigned ballot = __ballot_sync(0xffffffffu, s);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int before = carry, total = 0;
    for (int k = 0; k < nwarps; ++k) {
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" const char* rwt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// img: (h, w) u8; v: (h, w) u8; key, lab: (h, w) int32; n_seeds: int32
// scalar.  The launch plan comes from ops/pack.py pack_plan and is launched
// as given: route 0 the band kernel with 16-byte access (w % 16 == 0, every
// plane 16-byte aligned), 1 the band kernel with byte access, both as
// n_blocks bands of band_rows (= kBandRows) rows, threads (whole warps, at
// most kMaxBandThreads) of 16 columns each, status holding 1 + n_blocks
// uint64 (zeroed here); 2 the three-launch wide route, n_blocks = h blocks
// of threads (whole warps, at most 1024), status holding h int32.  All on
// the device; launches on `stream` and does not synchronise.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan that does not
// cover the image exactly or that the kernels do not take.
extern "C" int rwt_pack(const void* img, void* v, void* key, void* lab,
                        void* status, void* n_seeds, int h, int w,
                        int unclaimed, int route, int band_rows, int threads,
                        int n_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* im = static_cast<const uint8_t*>(img);
  uint8_t* vv = static_cast<uint8_t*>(v);
  int32_t* kk = static_cast<int32_t*>(key);
  int32_t* ll = static_cast<int32_t*>(lab);
  int32_t* ns = static_cast<int32_t*>(n_seeds);
  if (h <= 0 || w <= 0 || threads <= 0 || threads % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 2) {
    if (n_blocks != h || threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
    int32_t* rc = static_cast<int32_t*>(status);
    count_rows<<<h, threads, 0, st>>>(im, rc, h, w);
    scan_rows<<<1, 1024, 0, st>>>(rc, ns, h);
    write_rows<<<h, threads, 0, st>>>(im, rc, vv, kk, ll, h, w, unclaimed);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = route == 0;
  // Every column and row in exactly one thread's group and one band (the
  // last band writes n_seeds).
  if ((route != 0 && route != 1) || band_rows != kBandRows || threads > kMaxBandThreads ||
      16 * threads < w || (long long)n_blocks * kBandRows < h || (long long)(n_blocks - 1) * kBandRows >= h ||
      (vec && (w % 16 != 0 || !aligned16(img) || !aligned16(v) || !aligned16(key) || !aligned16(lab))))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long* stat = static_cast<unsigned long long*>(status);
  const cudaError_t e = cudaMemsetAsync(stat, 0, (size_t)(1 + n_blocks) * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (vec) {
    pack_bands<true><<<n_blocks, threads, 0, st>>>(im, vv, kk, ll, stat, ns, h, w, unclaimed);
  } else {
    pack_bands<false><<<n_blocks, threads, 0, st>>>(im, vv, kk, ll, stat, ns, h, w, unclaimed);
  }
  return static_cast<int>(cudaGetLastError());
}
