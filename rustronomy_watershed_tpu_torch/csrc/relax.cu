// Relax kernel: `steps` global Jacobi sweeps of the packed-key priority
// relaxation in one launch.
//
// Replaces two TPU kernels of rustronomy_watershed_tpu/ops/pallas_relax.py:
// `_relax_kernel` (full-width bands, launched by `relax_block`) and
// `_relax_kernel2d` (column stripes with a 128-lane halo for widths >= 5120,
// launched by `relax_block2d`).  Both compute the same function: the
// per-sweep update of pallas_relax.py:413-438, the change flags, the
// convergence witness, the d-saturation detector, (with `stats`) the
// stats-only epilogue of pallas_relax.py:575-604 and (with a y0 plane) the
// fused forward-scan epilogue of pallas_relax.py:541-580 and :1134-1212.
// The 2-D tiles below serve every width, so the stripe geometry
// (`resolve_stripe_config`, RWT_RELAX_STRIPES) was TPU tuning and is not
// carried over; the Jacobi ping-pong and centre-only writes are the striped
// kernel's design.  Not carried over either: the in-place aliased band
// DMAs.  Index arithmetic is in size_t.
//
// The y0 epilogue (`kScan`, which implies `kStats`): y0 is pass 1 of the
// fine component-min tail on this call's output label plane, the forward
// vertical segmented min scan (0 a barrier, border columns copied through;
// csrc/scan_round.cu `vscan_tiles<false, ., true>`).  The TPU ran its bands
// in order and carried each column's running min across them in VMEM
// scratch (`ycarry`); here the tiles run in parallel, so the carry comes by
// a decoupled look-back.  A kScan block takes its tile from an atomic
// ticket in row-major order (as csrc/pack.cu's bands do), so every tile it
// waits on has started.  After the sweeps (a block that stopped early
// included) each warp reduces its strip's centre rows per column to a scan
// aggregate in registers; the aggregates cross the 16 warps in shared
// memory; one thread per centre column combines them, publishes the tile's
// aggregate, looks back over the tiles above it in its tile column (one at
// a time, stopping at an inclusive prefix or a barrier) for the carry, and
// publishes the inclusive prefix; then every strip scans its rows from
// its carry and writes its y0 rows.  Only a call that runs every tile may
// emit y0 (a skipped tile would publish nothing): the fixed point's first
// call, which has no previous call's tile flags, so `chg_prev` and the
// centre rectangle are refused with it.  The epilogue is a function
// called out of line on a copy of the labels in local memory: inlined, with
// the labels held in registers across its barriers, it made the sweep loop
// spill (ptxas: 340 / 480 bytes against the statistics kernel's 60 / 96)
// and the call about 1.4 times as long on an H100.  The look-back is simple (a tile at a time), not tuned: the
// epilogue's barriers and device-memory round trips are not hidden, one
// block running per SM (PERF.md).
//
// The centre rectangle `[ctr_y0, ctr_y1) x [ctr_x0, ctr_x1)`, in plane
// coordinates, is the counterpart of `_relax_kernel`'s `ctr_cols=(lo, hi)`
// (pallas_relax.py:268, :387-390, :495-497): only its cells set
// changed_any, changed_last and sat.  A mesh tile's plane carries k halo rows
// and columns that evolve within a call (the TPU band kernel froze its halo
// rows, so a column range was enough there) and are rewritten by the next
// halo refresh; counting them would hold the round loop open forever.  The
// per-tile change flag (`chg`) still counts every centre cell of its kernel
// tile, halo cells included, since the quiet-tile rule is about the whole
// tile.  The whole plane (the default) compiles without the rectangle's
// masks (`kRect`).
//
// Update of one cell (key = L << d_bits | d, see ops/relax.py):
//   best  = min(key, max(ext(min4 kq), vcand)),  ext(a) = min(a+1, a|d_mask)
//   label = min label of 4-neighbours with kq < best; kept if none, or if
//           best is still unclaimed (claimed-ness gate).
// vcand = (v << d_bits) + 1 needs no clamp at the unclaimed key: where v is
// 255 it exceeds every key, and so does the clamped value, so best is the
// key either way.  Cells outside the image read as key `unclaimed`, label 0,
// value 255: they never change and never donate, as the TPU layout's
// aprons.  Every key is <= unclaimed = 255 << d_bits, so kmin + 1 and
// vcand stay below 2^31.
//
// What bounds it: integer work on chip.  Each block loads a window of the
// planes once, runs S = steps sweeps on it and writes back its centre tile
// (the window less S cells on each side): device memory sees about 9 B a
// cell in and 8 B out per call, not per sweep.  At S = 8 a 4096^2 call is
// about 0.2 G cell updates of some 27 integer operations each.  Design:
//   * register-blocked sweeps: a block is one warp wide and `warps` deep; a
//     thread holds a strip of kR rows x 4 columns (key, label and the u8
//     value) in registers, so a window is 128 columns x (kR * warps) rows.
//     Vertical neighbours inside a strip and horizontal ones inside a
//     thread are registers, horizontal ones across threads come by
//     __shfl_sync, and only a strip's top and bottom rows go through shared
//     memory (16-byte stores and loads, double-buffered by sweep parity):
//     one block barrier per sweep, which also votes the previous sweep's
//     change flag;
//   * Jacobi: a row's new values are computed from the old row above (kept
//     aside), the old row itself and the old row below, so one launch
//     equals exactly S global sweeps, bit for bit;
//   * sweep j is exact at distance >= j from the window edge (its
//     dependency cone lies in the window), so after S sweeps the centre is
//     exact.  When a sweep changes nothing in the rows of its exact region
//     (all their columns: a superset of the region), the remaining sweeps
//     are the identity on the region and the block stops early;
//   * quiet tiles are skipped: with the previous call's per-tile change
//     flags (`chg_prev`, from relax_fixed_point), a block whose tile and 8
//     neighbour tiles changed no centre cell in that call returns at once
//     (its output is already in the destination plane, see ops/relax.py);
//   * the flags: block votes (`__syncthreads_or`; nvcc 12.9 miscompiled a
//     warp vote folded into a shared atomicOr in csrc/flood.cu), then
//     changed_any / changed_last by one atomicOr per block; the saturation
//     bit and the statistics as per-tile partials (written when a tile
//     runs, kept when it is skipped), reduced over all tiles by a second
//     one-block launch.  `stats` is a template parameter: the segmenting
//     instantiation holds no statistics code, and the merging one no y0
//     code (`kScan`: 4 B a cell more out, the labels already in registers).
// The strip depth and the warps per block come from the launch plan in
// ops/relax.py (relax_plan): strips of 8 rows in 16 warps, a 128 x 128
// window, 112 x 112 centre tiles at 8 steps.  On an H100 strips of 4 rows
// in 24 warps (768 threads, 80 registers, 80 x 112 tiles) were no faster
// per call at 4096^2 and slower at 16384^2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4;           // columns a thread owns
constexpr int kWinX = 32 * kCols;  // window width: one warp across
constexpr int kBigLab = 1 << 30;
constexpr int kInf = 1 << 29;  // "no claimed interior cell" (scan_merge _INF)
constexpr unsigned kFull = 0xffffffffu;

constexpr int kR = 8;              // rows of a thread's strip
constexpr int kMaxThreads = 512;   // 16 warps: a 128 x 128 window, 128 registers a thread

// The y0 epilogue's scan elements, as csrc/scan_round.cu's fine passes: a
// value (a label, or kInf for none) in bits 0..29 and "a segment starts
// here" in bit 30; comb(a, b) is the segmented min, a then b in scan order,
// with kInf its identity.
constexpr int kSeg = 1 << 30;
constexpr int kSegVal = kSeg - 1;

__device__ __forceinline__ int comb(int a, int b) {
  return (b & kSeg) ? b : (min(a & kSegVal, b) | (a & kSeg));
}

// A status word holds its flag and its element together, so the look-back
// needs no ordering against other data: relaxed loads and stores at device
// scope (release and acquire cost a fence and an L1 invalidation each).
__device__ __forceinline__ unsigned long long ld_relaxed64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The y0 epilogue of one block (see the header): `l` the strip's labels,
// `s_agg` shared memory for the strips' aggregates ([warp][window column]),
// `wx0` the plane column of window column 0, `y0` the strip's first row.
__device__ __noinline__ void fwd_scan_epilogue(const int (&l)[kR][kCols], int* s_agg, int32_t* __restrict__ y0_out,
                                               unsigned long long* status, int h, int w, int S, int nw, int ty,
                                               int wx0, int y0, bool vec_c) {
  __shared__ int s_cin[kWinX];  // the carry into the tile per window column
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, WY = nw * kR;
  const int xw = lane * kCols, x0 = wx0 + xw;
  // The centre rows of this strip that lie in the plane.
  unsigned rows = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int yy = wid * kR + r;
    rows |= (yy >= S && yy < WY - S && y0 + r < h) ? 1u << r : 0u;
  }
  // Each strip's aggregate per window column.
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    int a = kInf;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (!((rows >> r) & 1u)) continue;
      const int c = l[r][j];
      a = c == 0 ? (kInf | kSeg) : comb(a, c);
    }
    s_agg[wid * kWinX + xw + j] = a;
  }
  __syncthreads();
  if (threadIdx.x < kWinX) {
    const int c = threadIdx.x, gx = wx0 + c;
    int cin = kInf;
    if (c >= S && c < kWinX - S && gx < w) {
      int agg = kInf;
      for (int q = 0; q < nw; ++q) agg = comb(agg, s_agg[q * kWinX + c]);
      unsigned long long* col = status + 1 + gx;  // tile row k's word at col[k * w]
      if (ty > 0) {
        st_relaxed64(col + (size_t)ty * w, (1ull << 32) | (unsigned)agg);
        int acc = kInf;  // the tiles between k and this one, in scan order
        for (int k = ty - 1; k >= 0 && !(acc & kSeg); --k) {
          unsigned long long s;
          while (((s = ld_relaxed64(col + (size_t)k * w)) >> 32) == 0) {
          }
          acc = comb((int)(unsigned)s, acc);
          if ((s >> 32) == 2) break;
        }
        cin = acc & kSegVal;
      }
      st_relaxed64(col + (size_t)ty * w, (2ull << 32) | (unsigned)(comb(cin, agg) & kSegVal));
    }
    s_cin[c] = cin;
  }
  __syncthreads();
  // The strip's carry: the tile's, then the strips above; then its rows.
  int f[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    f[j] = s_cin[xw + j];
    for (int q = 0; q < wid; ++q) f[j] = comb(f[j], s_agg[q * kWinX + xw + j]);
    f[j] &= kSegVal;
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (!((rows >> r) & 1u)) continue;
    int o[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = l[r][j], gx = x0 + j;
      f[j] = c == 0 ? kInf : min(f[j], c);
      o[j] = (c == 0 || gx == 0 || gx == w - 1) ? c : f[j];
    }
    const size_t g = (size_t)(y0 + r) * w;
    if (vec_c) {
      *reinterpret_cast<int4*>(y0_out + g + x0) = make_int4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (xw + j >= S && xw + j < kWinX - S && x0 + j < w) y0_out[g + (x0 + j)] = o[j];
    }
  }
}

// Shared-memory rows of one block: [sweep parity][warp][top key, top label,
// bottom key, bottom label][lane], one int4 (four columns) each; with kScan,
// after the sweeps, the strips' scan aggregates [warp][window column].
// status (kScan): [ticket, then one word per tile row and plane column:
// flag << 32 | scan element], zero at launch; flag 1 = the tile's
// aggregate, 2 = the inclusive prefix (a value, kInf for none).
template <bool kStats, bool kRect, bool kScan>
__global__ void __launch_bounds__(kMaxThreads, 1)
relax_kernel(const uint8_t* __restrict__ v, const int32_t* __restrict__ key_in,
             const int32_t* __restrict__ lab_in, int32_t* __restrict__ key_out,
             int32_t* __restrict__ lab_out, int32_t* __restrict__ flags,
             const int32_t* __restrict__ chg_prev, int32_t* __restrict__ chg,
             int32_t* __restrict__ part, int32_t* __restrict__ y0_out, unsigned long long* status,
             int h, int w, int steps, int d_bits, int tile_y, int tile_x, int4 rect, int vec) {
  static_assert(!kScan || (kStats && !kRect), "the y0 epilogue runs with the statistics on the whole plane");
  extern __shared__ int4 xrow[];
  __shared__ int s_red[2];  // with stats: unclaimed interior cells, least claimed interior label
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int S = steps, WY = nw * kR;
  int ty = blockIdx.y, tx = blockIdx.x;
  if constexpr (kScan) {  // tiles in ticket order: every tile above this one has started
    __shared__ int s_tile;
    if (threadIdx.x == 0) s_tile = (int)atomicAdd(reinterpret_cast<unsigned*>(status), 1u);
    __syncthreads();
    ty = s_tile / (int)gridDim.x;
    tx = s_tile - ty * (int)gridDim.x;
  }
  const int tile = ty * gridDim.x + tx;
  const int unclaimed = 255 << d_bits, d_mask = (1 << d_bits) - 1, vmul = 1 << d_bits;

  // A tile whose 3x3 neighbourhood changed nothing in the previous call.
  if (chg_prev != nullptr) {
    bool quiet = true;
    if (threadIdx.x < 9) {
      const int ny = ty + (int)threadIdx.x / 3 - 1;
      const int nx = tx + (int)threadIdx.x % 3 - 1;
      if (ny >= 0 && ny < (int)gridDim.y && nx >= 0 && nx < (int)gridDim.x)
        quiet = chg_prev[ny * gridDim.x + nx] != 1;
    }
    if (__syncthreads_and(quiet)) {
      if (threadIdx.x == 0) chg[tile] = 2;
      return;
    }
  }
  if (kStats && threadIdx.x == 0) {
    s_red[0] = 0;
    s_red[1] = kInf;
  }

  // The strip: plane rows y0 .. y0+kR-1, columns x0 .. x0+3.
  const int xw = lane * kCols;  // window column of the first owned cell
  const int y0 = ty * tile_y - S + wid * kR;
  const int x0 = tx * tile_x - S + xw;
  const bool vec_x = vec && x0 >= 0 && x0 < w && (x0 & 3) == 0;
  int k[kR][kCols], l[kR][kCols];
  uint32_t vb[kR];  // byte j: the value of column j
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int gy = y0 + r;
    const bool row_in = gy >= 0 && gy < h;
    if (row_in && vec_x) {
      const size_t g = (size_t)gy * w + x0;
      const int4 a = *reinterpret_cast<const int4*>(key_in + g);
      const int4 b = *reinterpret_cast<const int4*>(lab_in + g);
      k[r][0] = a.x; k[r][1] = a.y; k[r][2] = a.z; k[r][3] = a.w;
      l[r][0] = b.x; l[r][1] = b.y; l[r][2] = b.z; l[r][3] = b.w;
      vb[r] = *reinterpret_cast<const uint32_t*>(v + g);
    } else {
      vb[r] = 0;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int gx = x0 + j;
        uint32_t b = 255;
        k[r][j] = unclaimed;
        l[r][j] = 0;
        if (row_in && gx >= 0 && gx < w) {
          const size_t g = (size_t)gy * w + gx;
          k[r][j] = key_in[g];
          l[r][j] = lab_in[g];
          b = v[g];
        }
        vb[r] |= b << (8 * j);
      }
    }
  }

  int ctr_col[kCols];  // -1 where the column lies in the centre
  // With kRect (rect = (y0, y1, x0, x1)): bit j of rect_cols, column j lies
  // in the centre and in the rectangle; bit r of rect_rows, row r does.
  unsigned rect_cols = 0, rect_rows = 0;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    ctr_col[j] = (xw + j >= S && xw + j < kWinX - S) ? -1 : 0;
    if (kRect && ctr_col[j] && x0 + j >= rect.z && x0 + j < rect.w) rect_cols |= 1u << j;
  }
  if (kRect) {
#pragma unroll
    for (int r = 0; r < kR; ++r) rect_rows |= (y0 + r >= rect.x && y0 + r < rect.y) ? 1u << r : 0u;
  }
  bool tile_c = false, any_c = false, last_c = false, reg_c = true;
  for (int s = 1; s <= S; ++s) {
    int4* xb = xrow + ((s & 1) * nw + wid) * 4 * 32 + lane;
    xb[0] = make_int4(k[0][0], k[0][1], k[0][2], k[0][3]);
    xb[32] = make_int4(l[0][0], l[0][1], l[0][2], l[0][3]);
    xb[64] = make_int4(k[kR - 1][0], k[kR - 1][1], k[kR - 1][2], k[kR - 1][3]);
    xb[96] = make_int4(l[kR - 1][0], l[kR - 1][1], l[kR - 1][2], l[kR - 1][3]);
    // Publishes the rows and votes the previous sweep: when it changed
    // nothing in its exact region, later sweeps are the identity there.
    if (!__syncthreads_or(reg_c)) break;

    int pk[kCols], pl[kCols];  // the old row above (outside the window: unclaimed)
    if (wid > 0) {
      const int4 a = xb[-64], b = xb[-32];
      pk[0] = a.x; pk[1] = a.y; pk[2] = a.z; pk[3] = a.w;
      pl[0] = b.x; pl[1] = b.y; pl[2] = b.z; pl[3] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        pk[j] = unclaimed;
        pl[j] = 0;
      }
    }
    // Rows of this sweep's exact region count every column: a superset of
    // the region, so a quiet vote still proves it quiet (the early exit
    // stays exact); the centre, which sets the flags, is counted exactly.
    int reg = 0, ctr = 0, rct = 0;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      int dk[kCols], dl[kCols];  // the old row below
      if (r + 1 < kR) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          dk[j] = k[r + 1][j];
          dl[j] = l[r + 1][j];
        }
      } else if (wid + 1 < nw) {
        const int4 a = xb[128], b = xb[160];
        dk[0] = a.x; dk[1] = a.y; dk[2] = a.z; dk[3] = a.w;
        dl[0] = b.x; dl[1] = b.y; dl[2] = b.z; dl[3] = b.w;
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          dk[j] = unclaimed;
          dl[j] = 0;
        }
      }
      // The old left neighbour, from the thread on the left for column 0.
      int okl = __shfl_up_sync(kFull, k[r][kCols - 1], 1), oll = __shfl_up_sync(kFull, l[r][kCols - 1], 1);
      int kr3 = __shfl_down_sync(kFull, k[r][0], 1), lr3 = __shfl_down_sync(kFull, l[r][0], 1);
      if (lane == 0) {
        okl = unclaimed;
        oll = 0;
      }
      if (lane == 31) {
        kr3 = unclaimed;
        lr3 = 0;
      }
      int ed = 0, cd = 0, rd = 0;
      // In place, left to right: the old values of the cell go to the row
      // above's slot (for row r + 1) and to the left neighbour's (for j + 1).
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k0 = k[r][j], l0 = l[r][j];
        const int ku = pk[j], kd = dk[j], kl = okl, kr = j < kCols - 1 ? k[r][j + 1] : kr3;
        const int lu = pl[j], ld = dl[j], ll = oll, lr = j < kCols - 1 ? l[r][j + 1] : lr3;
        const int kmin = __vimin3_s32(ku, kd, min(kl, kr));
        const int ext = min(kmin + 1, kmin | d_mask);
        const int vc = (int)((vb[r] >> (8 * j)) & 255u) * vmul + 1;
        const int best = min(k0, max(ext, vc));
        const int lm = min(__vimin3_s32(ku < best ? lu : kBigLab, kd < best ? ld : kBigLab, kl < best ? ll : kBigLab),
                           kr < best ? lr : kBigLab);
        const int nl = (lm == kBigLab || best == unclaimed) ? l0 : lm;
        const int d = (best ^ k0) | (nl ^ l0);
        ed |= d;
        cd |= d & ctr_col[j];
        if constexpr (kRect) rd |= ((rect_cols >> j) & 1u) ? d : 0;
        pk[j] = okl = k0;
        pl[j] = oll = l0;
        k[r][j] = best;
        l[r][j] = nl;
      }
      const int yy = wid * kR + r;
      if (yy >= s && yy < WY - s) reg |= ed;
      if (yy >= S && yy < WY - S) {
        ctr |= cd;
        if (kRect && ((rect_rows >> r) & 1u)) rct |= rd;
      }
    }
    reg_c = reg != 0;
    if constexpr (kRect) tile_c |= ctr != 0;
    last_c = (kRect ? rct : ctr) != 0;
    any_c |= last_c;
  }

  // Write back the centre; the saturation bit and the statistics.
  bool sat = false, border = false;
  int uncl = 0, gmin = kInf;
  const bool vec_c = vec_x && xw >= S && xw + kCols <= kWinX - S && x0 + kCols <= w;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int yy = wid * kR + r, gy = y0 + r;
    if (yy < S || yy >= WY - S || gy >= h) continue;
    if (vec_c) {
      const size_t g = (size_t)gy * w + x0;
      *reinterpret_cast<int4*>(key_out + g) = make_int4(k[r][0], k[r][1], k[r][2], k[r][3]);
      *reinterpret_cast<int4*>(lab_out + g) = make_int4(l[r][0], l[r][1], l[r][2], l[r][3]);
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int gx = x0 + j;
      if (xw + j < S || xw + j >= kWinX - S || gx >= w) continue;
      const int kk = k[r][j], ll = l[r][j];
      if (!vec_c) {
        const size_t g = (size_t)gy * w + gx;
        key_out[g] = kk;
        lab_out[g] = ll;
      }
      if (!kRect || ((rect_rows >> r) & (rect_cols >> j) & 1u)) sat |= kk < unclaimed && ll == 0;
      if constexpr (kStats) {
        if (gy >= 1 && gy <= h - 2 && gx >= 1 && gx <= w - 2) {
          if (ll == 0) ++uncl;
          else gmin = min(gmin, ll);
        } else {
          border |= ll != 0;
        }
      }
    }
  }
  // Without a rectangle the tile's centre is the flags' centre.
  const bool blk_any = __syncthreads_or(any_c) != 0;
  const bool blk_tile = kRect ? __syncthreads_or(tile_c) != 0 : blk_any;
  const bool blk_last = __syncthreads_or(last_c) != 0;
  const bool blk_sat = __syncthreads_or(sat) != 0;
  bool blk_border = false;
  if constexpr (kStats) {
    blk_border = __syncthreads_or(border) != 0;
    uncl = __reduce_add_sync(kFull, uncl);
    gmin = __reduce_min_sync(kFull, gmin);
    if (lane == 0) {
      if (uncl) atomicAdd(&s_red[0], uncl);
      atomicMin(&s_red[1], gmin);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (blk_any) atomicOr(flags + 0, 1);
    if (blk_last) atomicOr(flags + 1, 1);
    if (chg != nullptr) chg[tile] = blk_tile ? 1 : 0;
    int4* p = reinterpret_cast<int4*>(part) + tile;
    if constexpr (kStats) *p = make_int4(blk_sat, s_red[0], blk_border, s_red[1]);
    else *p = make_int4(blk_sat, 0, 0, kInf);
  }

  if constexpr (kScan) {
    int lc[kR][kCols];  // the copy in local memory (see the header)
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) lc[r][j] = l[r][j];
    fwd_scan_epilogue(lc, reinterpret_cast<int*>(xrow), y0_out, status, h, w, S, nw, ty, tx * tile_x - S, y0, vec_c);
  }
}

// The per-tile partials [sat, unclaimed interior, claimed border, least
// claimed interior label] of all tiles into flags[2] (and flags[3..5] with
// `stats`).  `skipped` (may be null) gets three words: the number of tiles
// whose chg entry is 2, then the pixels of the other tiles' centres
// (tile_y x tile_x clipped to the h x w plane; tile t of a `gx`-wide grid
// at row t / gx) as a 64-bit count, low word first.
__global__ void __launch_bounds__(1024)
relax_reduce(const int32_t* __restrict__ chg, const int4* __restrict__ part, int n_tiles,
             int32_t* __restrict__ flags, int stats, int32_t* skipped, int h, int w, int tile_y, int tile_x,
             int gx) {
  __shared__ int s_red[5];
  __shared__ unsigned long long s_px;
  if (threadIdx.x == 0) {
    s_red[0] = s_red[1] = s_red[2] = s_red[4] = 0;
    s_red[3] = kInf;
    s_px = 0;
  }
  __syncthreads();
  int sat = 0, uncl = 0, border = 0, gmin = kInf, sk = 0;
  unsigned long long px = 0;
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    const int4 p = part[t];
    sat |= p.x;
    uncl += p.y;
    border |= p.z;
    gmin = min(gmin, p.w);
    if (skipped != nullptr) {
      if (chg[t] == 2) {
        ++sk;
      } else {
        const int ty = t / gx, tx = t - ty * gx;
        px += (unsigned long long)min(tile_y, h - ty * tile_y) * (unsigned)min(tile_x, w - tx * tile_x);
      }
    }
  }
  sat = __reduce_or_sync(kFull, sat);
  uncl = __reduce_add_sync(kFull, uncl);
  border = __reduce_or_sync(kFull, border);
  gmin = __reduce_min_sync(kFull, gmin);
  sk = __reduce_add_sync(kFull, sk);
  for (int o = 16; o > 0; o >>= 1) px += __shfl_down_sync(kFull, px, o);
  if ((threadIdx.x & 31) == 0) {
    atomicOr(&s_red[0], sat);
    atomicAdd(&s_red[1], uncl);
    atomicOr(&s_red[2], border);
    atomicMin(&s_red[3], gmin);
    atomicAdd(&s_red[4], sk);
    atomicAdd(&s_px, px);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    flags[2] = s_red[0];
    if (stats) {
      flags[3] = s_red[1];
      flags[4] = s_red[2];
      flags[5] = s_red[3];
    }
    if (skipped != nullptr) {
      skipped[0] = s_red[4];
      skipped[1] = (int32_t)(uint32_t)(s_px & 0xffffffffull);
      skipped[2] = (int32_t)(uint32_t)(s_px >> 32);
    }
  }
}

template <bool kStats, bool kRect, bool kScan>
cudaError_t launch(const dim3& grid, int threads, size_t smem, cudaStream_t st, const void* v, const void* key_in,
                   const void* lab_in, void* key_out, void* lab_out, void* flags, const void* chg_prev, void* chg,
                   void* part, void* y0, void* status, int h, int w, int steps, int d_bits, int tile_y, int tile_x,
                   int4 rect, int vec) {
  auto kernel = relax_kernel<kStats, kRect, kScan>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(
      static_cast<const uint8_t*>(v), static_cast<const int32_t*>(key_in), static_cast<const int32_t*>(lab_in),
      static_cast<int32_t*>(key_out), static_cast<int32_t*>(lab_out), static_cast<int32_t*>(flags),
      static_cast<const int32_t*>(chg_prev), static_cast<int32_t*>(chg), static_cast<int32_t*>(part),
      static_cast<int32_t*>(y0), static_cast<unsigned long long*>(status), h, w, steps, d_bits, tile_y, tile_x, rect,
      vec);
  return cudaGetLastError();
}

}  // namespace

// v: (h, w) u8; key_in, lab_in -> key_out, lab_out: (h, w) int32 (outputs
// must not alias inputs); flags: int32 [changed_any, changed_last, sat],
// followed when `stats` is nonzero by [n_unclaimed_interior,
// any_claimed_border, min_claimed_interior_label], all written here.
// The launch plan (ops/relax.py relax_plan): strips of `rows` (8) rows,
// `warps` warps per block, centre tiles of tile_y x tile_x =
// (warps * rows - 2 * steps) x (128 - 2 * steps).  Tile state, n_tiles =
// ceil(h / tile_y) * ceil(w / tile_x) entries: part, 4 int32 per tile
// (written by the tiles that run; the reduction reads every tile's);
// chg (may be null), one int32 per tile: 1 when a centre cell changed, 0
// when none did, 2 when skipped; chg_prev (may be null) the previous call's
// chg, which turns skipping on.  skipped (may be null): three int32 words,
// the number of tiles skipped, then the pixels of the centre tiles that
// ran, clipped to the plane, as a 64-bit count (low word first).  The
// centre rectangle [ctr_y0, ctr_y1) x [ctr_x0, ctr_x1) limits the flags
// (not chg); a rectangle that is not the whole plane cannot be
// combined with `stats`.  y0 (may be null): the y0 epilogue's (h, w) int32
// plane, written here; it needs `stats`, the whole plane as the centre, no
// chg_prev (every tile runs) and `scan_status`, the look-back's
// 1 + ceil(h / tile_y) * w uint64 words (zeroed here).  vec: w % 4 == 0 and
// the planes 16-byte (v 4-byte) aligned.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (nonzero when a launch was
// refused).
extern "C" int rwt_relax(const void* v, const void* key_in, const void* lab_in, void* key_out, void* lab_out,
                         void* flags, const void* chg_prev, void* chg, void* part, void* skipped, void* y0,
                         void* scan_status, int h, int w, int steps, int d_bits, int rows, int warps, int tile_y,
                         int tile_x, int ctr_y0, int ctr_y1, int ctr_x0, int ctr_x1, int stats, int vec,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rect = ctr_y0 > 0 || ctr_y1 < h || ctr_x0 > 0 || ctr_x1 < w;
  const bool scan = y0 != nullptr;
  if (rows != kR || warps < 1 || 32 * warps > kMaxThreads || steps < 1 ||
      tile_x != kWinX - 2 * steps || tile_y != warps * rows - 2 * steps || tile_x < 1 || tile_y < 1 ||
      part == nullptr || (chg_prev != nullptr && chg == nullptr) || (skipped != nullptr && chg == nullptr) ||
      (rect && stats) || (scan && (!stats || chg_prev != nullptr || scan_status == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + tile_x - 1) / tile_x, (h + tile_y - 1) / tile_y);
  const int n_tiles = static_cast<int>(grid.x * grid.y);
  cudaError_t e = cudaMemsetAsync(flags, 0, (stats ? 6 : 3) * sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (scan) {
    e = cudaMemsetAsync(scan_status, 0, (1 + (size_t)grid.y * w) * sizeof(unsigned long long), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem = (size_t)2 * warps * 4 * 32 * sizeof(int4);
  const int threads = 32 * warps;
  const int4 r = make_int4(ctr_y0, ctr_y1, ctr_x0, ctr_x1);
  if (scan)
    e = launch<true, false, true>(grid, threads, smem, st, v, key_in, lab_in, key_out, lab_out, flags, chg_prev, chg,
                                  part, y0, scan_status, h, w, steps, d_bits, tile_y, tile_x, r, vec);
  else if (stats)
    e = launch<true, false, false>(grid, threads, smem, st, v, key_in, lab_in, key_out, lab_out, flags, chg_prev, chg,
                                   part, y0, scan_status, h, w, steps, d_bits, tile_y, tile_x, r, vec);
  else if (rect)
    e = launch<false, true, false>(grid, threads, smem, st, v, key_in, lab_in, key_out, lab_out, flags, chg_prev, chg,
                                   part, y0, scan_status, h, w, steps, d_bits, tile_y, tile_x, r, vec);
  else
    e = launch<false, false, false>(grid, threads, smem, st, v, key_in, lab_in, key_out, lab_out, flags, chg_prev,
                                    chg, part, y0, scan_status, h, w, steps, d_bits, tile_y, tile_x, r, vec);
  if (e != cudaSuccess) return static_cast<int>(e);
  relax_reduce<<<1, 1024, 0, st>>>(static_cast<const int32_t*>(chg), static_cast<const int4*>(part), n_tiles,
                                   static_cast<int32_t*>(flags), stats, static_cast<int32_t*>(skipped), h, w, tile_y,
                                   tile_x, static_cast<int>(grid.x));
  return static_cast<int>(cudaGetLastError());
}
