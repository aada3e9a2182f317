// Scan-round kernels: the passes of the component-min rounds, on the fine
// label plane or on the packed coarse plane.
//
// Replaces five TPU kernels of rustronomy_watershed_tpu/ops/scan_merge.py:
//   * `_fwd_v_kernel` / `_bwd_vh_kernel`, the fine tail (launched by
//     `_call_round_kernel` from `_component_min_pallas` and
//     `component_min_from_padded`):
//       - rwt_fine_fwd_v: the forward vertical segmented min scan (0 is a
//         barrier, border columns 0 and w-1 pass through); its flag is "some
//         cell changed";
//       - rwt_fine_bwd_vh: the backward vertical scan (in -> scratch), then
//         the horizontal run-min (border rows 0 and h-1 pass through) and the
//         violation stencil over its output (scratch -> out): the flag is
//         "some claimed neighbour pair across an unblocked edge differs",
//         which certifies the fixed point (scan_merge.py:231-238); a clean
//         forward pass does not;
//   * their coarse mirrors `_cfwd_v_kernel` / `_cbwd_vh_kernel`, the legacy
//     rounds of `component_min_coarse_from_padded` (RWT_COARSE_MULTI=0):
//     rwt_coarse_fwd_v and rwt_coarse_bwd_vh, whose h-scan is full length or
//     windowed as the TPU's lane doubling with a limit is (a cell reaches
//     `reach` = 2^ceil(log2(limit)) - 1 cells each way within its run, not
//     limit - 1);
//   * `_cmulti_kernel` (launched by `_call_multi_kernel`), the default coarse
//     round: a sequential band grid with Gauss-Seidel chaining, k = 2
//     sub-iterations per band and a 256-lane h window, all of it tuning for
//     one TPU core walking bands in order.  Blocks on Hopper run in no
//     order, so rwt_coarse_round is a full-length run-min of every column
//     (plane -> scratch), then of every row (scratch -> out), counting the
//     cells that changed; the tail stops after a round that changed none
//     (the change-based certificate of scan_merge.py:1114-1128).  Its
//     launches are the fine passes' kernels in the coarse form (below).
//     The host queues rounds in blocks and reads their counts a block at a
//     time: a round given the previous round's count as `go` returns from
//     each launch at once when it reads 0, so the rounds queued after the
//     fixed point move no byte.
// Every launch reads whole planes and writes whole planes, so each entry
// point equals its plain twin (ops/scan_merge.py) bit for bit.
//
// What bounds the fine passes on this card: bytes.  Each launch reads one
// int32 plane and writes one (1 GiB each way at 16384^2, 0.32 ms each at
// 3.35 TB/s); the arithmetic is a few integer ops per cell.  So the design
// is about touching each cell once per launch, in wide coalesced accesses:
//   * Column scans (`vscan_tiles`, fwd_v and bwd_vh's first launch): tiles
//     of 128 rows x 128 columns (32 with scalar access when w % 4 != 0),
//     16 warps x 8 rows, a lane owning 4 columns and loading its 8 rows as
//     independent 16-byte loads; two blocks per SM.  The tile is read once
//     into registers; its per-column (min, reset-seen) aggregate goes to a
//     status buffer and the carry into the tile comes from a decoupled
//     look-back over the tiles above (aggregates, or an inclusive carry
//     that ends the walk).  Tile ids come from an atomic counter, so every
//     tile waited on has started and publishes without waiting: no
//     deadlock.  In place (fwd_v inside the round loop) only the 16-byte
//     groups that changed are stored, as the TPU kernel skips unchanged
//     bands.  What holds it above the bound is the latency chain of a tile
//     (counter, loads, publish, look-back) with two tiles per SM in flight.
//   * The row kernel (`row_ring`, bwd_vh's second launch): a block per band
//     of rows (about one per SM), rows streamed through a ring of three
//     buffers in dynamic shared memory by 1-D bulk copies (TMA: one thread
//     issues a row, the next step loads while this one is scanned) and
//     stored from the ring by bulk copies too, so the load and store units
//     stay free for the scan.  A step holds as many whole rows as fit
//     (rows_per_step, so narrow planes do not spend a block on a 2-cell
//     row); each thread owns 20 contiguous cells (five int4, an odd count:
//     no bank conflicts).  The run-min is a forward and a backward
//     segmented scan inside the thread's cells, then one block scan of the
//     per-thread aggregates gives the carries into the thread's leading
//     and trailing runs.  The violation stencil is fused: after a run-min
//     every interior row is constant along its runs, and border rows are
//     blocked, so only vertical pairs can violate; the row above stays in
//     the ring (the previous step's output), and each band recomputes its
//     upper neighbour row once (a shadow row, never stored) instead of
//     reading another block's output.
//   * Rows wider than the ring (kRowCap cells) take the chunked route: the
//     chunked-carry run_min_pass<false> below, then the violations<false>
//     stencil as its own launch.
// Index arithmetic is size_t: the 16384^2 plane is 1 GiB.
//
// The coarse round (rwt_coarse_round) runs the same two kernels in their
// coarse form (kCoarse): a scan restarts at a cell whose reset bit for its
// direction is set (24 forward / 25 backward down columns, 26 / 27 along
// rows) instead of at an unclaimed cell, empty cells (value 0) scan as kInf
// and stay, bits 24-31 pass through (with_value<true>), no border line is
// kept, and the kernels count the cells whose value changed (warp sums, one
// atomicAdd per warp) where the fine ones raise flags.  The v-pass is two
// `vscan_tiles` launches: forward c -> scratch, then backward in place on
// scratch, counting against c (a cell's value only falls, so it changed in
// the v-pass iff it differs from c; at 4096^2 the 33.5 MB coarse plane sits
// in L2 for that second read).  One launch that also waited on the tiles
// below for the backward carry could deadlock under the atomic tile order,
// so the directions stay apart.  The h-pass is `row_ring` with no shadow
// row and no stencil; rows over kRowCap cells take run_min_pass<true>.
//
// The legacy coarse passes.  Their column scans (v_pass<true,*>: cfwd_v,
// and cbwd_vh's first launch) are the chunked-carry design: a block owns 32
// columns, each cut into 32 chunks, one thread per chunk; a thread folds its
// chunk into a (value, reset-seen) aggregate, one thread per column chains
// the aggregates into each chunk's carry (shared memory), and the thread
// rescans its chunk from that carry; every access is coalesced, and cfwd_v
// runs at about 60% of its bound on the H100.  cbwd_vh's row half is
// `hwin_ring`: row_ring's TMA ring and block scans, with the h-window exact
// at O(1) work a cell (van Herk / Gil-Werman blocks of reach + 1 columns)
// and the whole violation stencil fused (a windowed scan leaves rows not
// constant along their runs, so horizontal pairs are checked too, and each
// band recomputes the row above it, as the fine kernel does).  Rows wider
// than the ring keep the chunked launches: run_min_pass<true> (a block owns
// 8 rows walked at a stride) or hwin_pass (a thread per cell walking at
// most `reach` cells each way), then violations<true> over the output.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kVal = (1 << 24) - 1;
constexpr int kInf = 1 << 29;  // "no value" (scan_merge _INF), above every label
constexpr int kChunks = 32;
constexpr int kVf = 24, kVb = 25, kHf = 26, kHb = 27;  // coarse reset bits

template <bool kCoarse>
__device__ __forceinline__ int label_of(int c) {
  return kCoarse ? (c & kVal) : c;
}

// The value a cell brings into a scan: its label, or kInf when empty.
template <bool kCoarse>
__device__ __forceinline__ int value_of(int c) {
  const int x = label_of<kCoarse>(c);
  return x == 0 ? kInf : x;
}

// Whether a scan along the direction of coarse reset bit `bit` restarts at
// this cell.
template <bool kCoarse>
__device__ __forceinline__ bool resets(int c, int bit) {
  return kCoarse ? ((c >> bit) & 1) != 0 : c == 0;
}

// The cell with its label replaced by scan value `s` (empty cells stay).
template <bool kCoarse>
__device__ __forceinline__ int with_value(int c, int s) {
  if (label_of<kCoarse>(c) == 0) return c;
  return kCoarse ? ((c & ~kVal) | s) : s;
}

// Chains the per-chunk aggregates of the lines in a block into the carry
// each chunk starts from, in scan order (chunk 0 first when forward).
__device__ __forceinline__ void chain(int (*agg_v)[kChunks + 1],
                                      int (*agg_r)[kChunks + 1],
                                      int (*carry)[kChunks + 1], int li,
                                      bool fwd) {
  int cin = kInf;
  for (int j = 0; j < kChunks; ++j) {
    const int k = fwd ? j : kChunks - 1 - j;
    carry[li][k] = cin;
    cin = agg_r[li][k] ? agg_v[li][k] : min(agg_v[li][k], cin);
  }
}

// One directional segmented min scan down every column: in -> out (which may
// be `in`).  Fine border columns keep their cells.  `changed` (may be null)
// gets 1 when some cell changed.
template <bool kCoarse, bool kFwd>
__global__ void __launch_bounds__(1024)
v_pass(const int32_t* in, int32_t* out, int32_t* changed, int h, int w) {
  constexpr int kBit = kFwd ? kVf : kVb;
  __shared__ int agg_v[32][kChunks + 1];
  __shared__ int agg_r[32][kChunks + 1];
  __shared__ int carry[32][kChunks + 1];
  const int li = threadIdx.x, ck = threadIdx.y;
  const int col = blockIdx.x * 32 + li;
  const int len = (h + kChunks - 1) / kChunks;
  const int s = min(h, ck * len), e = min(h, s + len);
  const bool live = col < w;
  const bool keep = !kCoarse && (col == 0 || col == w - 1);

  int m = kInf, r = 0;
  if (live) {
    for (int j = 0; j < e - s; ++j) {
      const int i = kFwd ? s + j : e - 1 - j;
      const int c = in[(size_t)i * w + col];
      const int x = value_of<kCoarse>(c);
      if (resets<kCoarse>(c, kBit)) {
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
  if (ck == 0) chain(agg_v, agg_r, carry, li, kFwd);
  __syncthreads();

  int f = carry[li][ck];
  bool ch = false;
  if (live) {
    for (int j = 0; j < e - s; ++j) {
      const int i = kFwd ? s + j : e - 1 - j;
      const size_t g = (size_t)i * w + col;
      const int c = in[g];
      const int x = value_of<kCoarse>(c);
      f = resets<kCoarse>(c, kBit) ? x : min(x, f);
      const int o = keep ? c : with_value<kCoarse>(c, f);
      out[g] = o;
      ch |= o != c;
    }
  }
  ch = __syncthreads_or(ch) != 0;
  if (changed != nullptr && ch && li == 0 && ck == 0) atomicOr(changed, 1);
}

// The full-length run-min of every row: a forward scan under the forward
// resets into `out`, then a backward scan of that under the backward resets
// (the run-min, as the TPU's min of two independent scans is).  in -> out,
// which must not alias.  Fine border rows keep their cells.  `changed` (may
// be null) gets the number of cells whose value changed.  A block owns 8
// rows, each cut into 32 chunks (a warp covers the chunks of one row, at a
// stride): the route for rows wider than the ring row kernel takes.  Coarse
// with `go` (may be null): the launch returns at once when *go is 0 (a
// coarse round's stop, rwt_coarse_round).
template <bool kCoarse>
__global__ void __launch_bounds__(256)
run_min_pass(const int32_t* __restrict__ in, int32_t* __restrict__ out,
             int32_t* changed, int h, int w, const int32_t* go = nullptr) {
  if constexpr (kCoarse) {
    if (go != nullptr && *go == 0) return;
  }
  constexpr int kLines = 8;
  constexpr int kFwd = kHf, kBwd = kHb;
  __shared__ int agg_v[kLines][kChunks + 1];
  __shared__ int agg_r[kLines][kChunks + 1];
  __shared__ int carry[kLines][kChunks + 1];
  const int li = threadIdx.y;  // row within the block
  const int ck = threadIdx.x;  // chunk within the row
  const int line = blockIdx.x * kLines + li;
  const int len = (w + kChunks - 1) / kChunks;
  const int s = min(w, ck * len), e = min(w, s + len);
  const bool live = line < h;
  const bool keep = !kCoarse && (line == 0 || line == h - 1);
  const size_t base = (size_t)line * w;
  constexpr size_t stride = 1;

  int m = kInf, r = 0;
  if (live) {
    for (int i = s; i < e; ++i) {
      const int c = in[base + i * stride];
      const int x = value_of<kCoarse>(c);
      if (resets<kCoarse>(c, kFwd)) {
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
  if (ck == 0) chain(agg_v, agg_r, carry, li, true);
  __syncthreads();

  // Forward scan into `out`; on the way, the backward aggregate: the min of
  // the forward values up to and including the chunk's first backward reset.
  int f = carry[li][ck];
  int bm = kInf, br = 0;
  if (live) {
    for (int i = s; i < e; ++i) {
      const size_t g = base + i * stride;
      const int c = in[g];
      const int x = value_of<kCoarse>(c);
      f = resets<kCoarse>(c, kFwd) ? x : min(x, f);
      out[g] = f;
      if (!br) {
        bm = min(bm, f);
        br = resets<kCoarse>(c, kBwd);
      }
    }
  }
  agg_v[li][ck] = bm;
  agg_r[li][ck] = br;
  __syncthreads();
  if (ck == 0) chain(agg_v, agg_r, carry, li, false);
  __syncthreads();

  int b = carry[li][ck];
  int ch = 0;
  if (live) {
    for (int i = e - 1; i >= s; --i) {
      const size_t g = base + i * stride;
      const int c = in[g];
      const int fv = out[g];
      b = resets<kCoarse>(c, kBwd) ? fv : min(fv, b);
      const int o = keep ? c : with_value<kCoarse>(c, b);
      out[g] = o;
      ch += o != c;
    }
  }
  if (changed != nullptr) {
    ch = __reduce_add_sync(0xffffffffu, ch);
    if ((threadIdx.x & 31) == 0 && ch) atomicAdd(changed, ch);
  }
}

// The windowed horizontal pass of the coarse plane for rows wider than the
// ring: each cell takes the min of a forward scan reaching at most `reach`
// cells back and a backward scan reaching at most `reach` cells ahead, each
// stopping after the first cell that resets it.  in -> out, which must not
// alias.
__global__ void __launch_bounds__(256)
hwin_pass(const int32_t* __restrict__ in, int32_t* __restrict__ out, int hc,
          int w, int reach) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= w) return;
  for (int row = blockIdx.y; row < hc; row += gridDim.y) {
    const int32_t* line = in + (size_t)row * w;
    const int c = line[col];
    int o = c;
    if ((c & kVal) != 0) {
      int mf = kInf;
      for (int j = col, lo = max(0, col - reach); j >= lo; --j) {
        const int cj = line[j];
        mf = min(mf, value_of<true>(cj));
        if ((cj >> kHf) & 1) break;
      }
      int mb = kInf;
      for (int j = col, hi = min(w - 1, col + reach); j <= hi; ++j) {
        const int cj = line[j];
        mb = min(mb, value_of<true>(cj));
        if ((cj >> kHb) & 1) break;
      }
      o = (c & ~kVal) | min(mf, mb);
    }
    out[(size_t)row * w + col] = o;
  }
}

// The fixed-point violation stencil: `viol` gets 1 when some neighbour pair
// joined by an unblocked edge holds two labels.  Fine: both cells claimed,
// vertical pairs off the border columns, horizontal pairs off the border
// rows.  Coarse: the pair's edge is present (the cell's forward reset bit is
// clear; the bits fold in emptiness).
template <bool kCoarse>
__global__ void __launch_bounds__(256)
violations(const int32_t* __restrict__ p, int32_t* viol, int h, int w) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  bool bad = false;
  if (col < w) {
    for (int row = blockIdx.y; row < h; row += gridDim.y) {
      const size_t g = (size_t)row * w + col;
      const int c = p[g];
      const int x = label_of<kCoarse>(c);
      if (row >= 1) {
        const int u = label_of<kCoarse>(p[g - w]);
        bad |= kCoarse ? !((c >> kVf) & 1) && u != x
                       : x > 0 && u > 0 && u != x && col != 0 && col != w - 1;
      }
      if (col >= 1) {
        const int l = label_of<kCoarse>(p[g - 1]);
        bad |= kCoarse ? !((c >> kHf) & 1) && l != x
                       : x > 0 && l > 0 && l != x && row != 0 && row != h - 1;
      }
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(viol, 1);
}

// -- the fine passes ----------------------------------------------------------
//
// A scan element packs a cell's contribution into one int: its value (a
// label, or kInf for "none") in bits 0..29 and "a segment starts here" in
// bit 30.  comb(a, b) is the segmented-min operator, a then b in scan order;
// kInf with bit 30 clear is its identity.

constexpr int kR = 1 << 30;
constexpr int kVM = kR - 1;
constexpr int kTileWarps = 16, kWarpRows = 8;
constexpr int kTileRows = kTileWarps * kWarpRows;  // ops/scan_merge.py _VSCAN_TILE_ROWS
constexpr int kCells = 20;                          // row kernel: cells per thread
constexpr int kRing = 3;                            // row kernel: buffers in the ring
constexpr int kRowCap = 18432;                      // ops/scan_merge.py _ROW_CAP
constexpr int kWinThreads = 480;  // hwin_ring<true>: the most threads whose six buffers fit a block
constexpr int kHC = 20;           // hwin_ring: cells per thread (ops/scan_merge.py _LEGACY_CELLS)

__device__ __forceinline__ int comb(int a, int b) {
  return (b & kR) ? b : (min(a & kVM, b) | (a & kR));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// One directional segmented min scan down every column: in -> out (which
// may be `in`).  Fine: 0 restarts the scan, border columns kept; `changed`
// (may be null) gets 1 when some cell changed.  Coarse: bit 24 (forward) or
// 25 (backward) restarts it, empty cells scan as kInf and stay; `changed`
// (may be null; then `orig` too) gets the number of cells whose output
// differs from `orig`, the plane before the v-pass's forward launch.  A block
// scans one tile of kTileRows x (32 * lanes' columns); tiles are numbered in
// scan order (row of tiles, then column of tiles) by `status[0]`, an atomic
// counter.  status: [counter, flag per tile], zero at launch; carry:
// [aggregate per tile and column, inclusive carry per tile and column].
// Coarse: block 0 first zeroes `zero` (may be null; the round's change
// count, which the next launch adds to), and with `go` (may be null) every
// block returns at once, before it takes a tile, when *go is 0 (a coarse
// round's stop, rwt_coarse_round).
template <bool kCoarse, bool kVec, bool kFwd>
__global__ void __launch_bounds__(32 * kTileWarps, 32 / kTileWarps)
vscan_tiles(const int32_t* in, int32_t* out, int32_t* changed, int32_t* status, int32_t* carry, int h, int w,
            int n_tc, const int32_t* __restrict__ orig, const int32_t* __restrict__ go, int32_t* zero) {
  if constexpr (kCoarse) {
    if (zero != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *zero = 0;
    if (go != nullptr && *go == 0) return;
  }
  constexpr int kBit = kFwd ? kVf : kVb;
  constexpr int kLane = kVec ? 4 : 1;  // columns per lane
  constexpr int kTC = 32 * kLane;      // columns per tile
  __shared__ int s_tile;
  __shared__ int s_pre[kTileWarps][kTC];  // per warp: aggregate, then exclusive prefix
  __shared__ int s_carry[kTC];
  const int n_tiles = gridDim.x;
  int* flags = status + 1;
  int* agg = carry;
  int* incl = agg + (size_t)n_tiles * kTC;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  if (t == 0) s_tile = atomicAdd(status, 1);
  __syncthreads();
  const int tile = s_tile, ti = tile / n_tc, tj = tile - ti * n_tc;
  const int c0 = tj * kTC + lane * kLane;
  const bool inplace = in == out;

  // Logical row l counts in scan order; its plane row is l or h - 1 - l.
  // A cell outside the plane reads as kInf, the scan's identity (no coarse
  // reset bit is set in it); a fine 0 (an unclaimed cell) restarts the scan
  // with no value.
  int cell[kWarpRows][kLane];
#pragma unroll
  for (int k = 0; k < kWarpRows; ++k) {
    const int l = ti * kTileRows + wid * kWarpRows + k;
#pragma unroll
    for (int j = 0; j < kLane; ++j) cell[k][j] = kInf;
    if (l < h && c0 < w) {
      const size_t g = (size_t)(kFwd ? l : h - 1 - l) * w + c0;
      if constexpr (kVec) {
        const int4 q = *reinterpret_cast<const int4*>(in + g);
        cell[k][0] = q.x;
        cell[k][1] = q.y;
        cell[k][2] = q.z;
        cell[k][3] = q.w;
      } else {
        cell[k][0] = in[g];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kLane; ++j) {
    int a = kInf;
    bool r = false;
#pragma unroll
    for (int k = 0; k < kWarpRows; ++k) {
      const int c = cell[k][j];
      if constexpr (kCoarse) {
        const bool rs = resets<true>(c, kBit);
        a = rs ? value_of<true>(c) : min(a, value_of<true>(c));
        r |= rs;
      } else {
        a = c == 0 ? kInf : min(a, c);
        r |= c == 0;
      }
    }
    s_pre[wid][lane * kLane + j] = a | (r ? kR : 0);
  }
  __syncthreads();

  // One thread per column: the warps' exclusive prefixes, the tile's
  // aggregate, published; then the look-back for the carry into the tile.
  int tile_agg = kInf;
  if (t < kTC) {
    for (int v = 0; v < kTileWarps; ++v) {
      const int x = s_pre[v][t];
      s_pre[v][t] = tile_agg;
      tile_agg = comb(tile_agg, x);
    }
    (ti > 0 ? agg : incl)[(size_t)tile * kTC + t] = tile_agg;
    __threadfence();
  }
  __syncthreads();
  if (t == 0) st_release(flags + tile, ti > 0 ? 1 : 2);
  if (t < kTC) {
    int acc = kInf;  // the tiles above this one, combined in scan order
    if (ti > 0) {
      for (int k = ti - 1;; --k) {
        const int pt = k * n_tc + tj;
        int f;
        while ((f = ld_acquire(flags + pt)) == 0) {
        }
        acc = comb(__ldcg((f == 2 ? incl : agg) + (size_t)pt * kTC + t), acc);
        if (f == 2) break;
      }
      incl[(size_t)tile * kTC + t] = comb(acc, tile_agg);
      __threadfence();
    }
    s_carry[t] = acc;
  }
  __syncthreads();
  if (t == 0 && ti > 0) st_release(flags + tile, 2);

  int f[kLane];
#pragma unroll
  for (int j = 0; j < kLane; ++j) f[j] = comb(s_carry[lane * kLane + j], s_pre[wid][lane * kLane + j]) & kVM;
  bool ch = false;
  int n_ch = 0;
#pragma unroll
  for (int k = 0; k < kWarpRows; ++k) {
    const int l = ti * kTileRows + wid * kWarpRows + k;
    if (l >= h || c0 >= w) continue;
    int o[kLane];
    bool diff = false;
#pragma unroll
    for (int j = 0; j < kLane; ++j) {
      const int c = cell[k][j];
      if constexpr (kCoarse) {
        f[j] = resets<true>(c, kBit) ? value_of<true>(c) : min(f[j], value_of<true>(c));
        o[j] = with_value<true>(c, f[j]);
      } else {
        const int col = c0 + j;
        f[j] = c == 0 ? kInf : min(f[j], c);
        o[j] = (c == 0 || col == 0 || col == w - 1) ? c : f[j];
      }
      diff |= o[j] != c;
    }
    ch |= diff;
    const size_t g = (size_t)(kFwd ? l : h - 1 - l) * w + c0;
    if (!inplace || diff) {
      if constexpr (kVec) {
        *reinterpret_cast<int4*>(out + g) = make_int4(o[0], o[1], o[2], o[3]);
      } else {
        out[g] = o[0];
      }
    }
    if (kCoarse && changed != nullptr) {
#pragma unroll
      for (int j = 0; j < kLane; ++j) n_ch += o[j] != orig[g + j];
    }
  }
  if (changed == nullptr) return;
  if constexpr (kCoarse) {
    n_ch = __reduce_add_sync(0xffffffffu, n_ch);
    if (lane == 0 && n_ch) atomicAdd(changed, n_ch);
  } else {
    if (__syncthreads_or(ch) && t == 0) atomicOr(changed, 1);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(int* s, const int32_t* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(s)), "l"(g) : "memory");
}

// 1-D bulk copies (TMA): global -> shared completing on an mbarrier, and
// shared -> global in a bulk group.  Addresses 16-byte aligned, sizes a
// multiple of 16.
__device__ __forceinline__ void bulk_load(int* s, const int32_t* g, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(smem_addr(s)),
      "l"(g), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(int32_t* g, const int* s, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(g), "r"(smem_addr(s)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n @!p bra WAIT_%=;\n}" ::"r"(
          smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Which int of its 16-byte line a pointer addresses.
__device__ __forceinline__ int phase_of(const int32_t* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The row kernels' ring (row_ring, hwin_ring): kRing buffers of one step's
// span each, buffer positions matching the plane's 16-byte lines.

// Thread 0: the ring's mbarriers, one per buffer.
__device__ __forceinline__ void ring_init(uint64_t* bars, int n = kRing) {
  for (int b = 0; b < n; ++b)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bars[b])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Thread 0 fills buffer `buf` with the S cells at `src`, cell i at buffer
// position phase_of(src) + i: the 16-byte-aligned body by one bulk copy on
// `bar`, the ragged ends (at most three cells each) by cp.async, first
// waiting until the bulk store that last read the buffer (all but the newest
// bulk group) is done with it.
__device__ __forceinline__ void ring_fill(int* buf, const int32_t* src, int S, uint64_t* bar) {
  const int ph = phase_of(src);
  int* dst = buf + ph;
  const int hd = min(S, (4 - ph) & 3), nq = (S - hd) >> 2;
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
  for (int i = 0; i < hd; ++i) cp_async4(dst + i, src + i);
  for (int i = hd + 4 * nq; i < S; ++i) cp_async4(dst + i, src + i);
  mbar_expect(bar, 16u * nq);
  if (nq > 0) bulk_load(dst + hd, src + hd, 16u * nq, bar);
}

// Stores cells [lo, S) of a step (cell i at cur[i], cur's 16-byte lines at
// phase ph) to dst: one bulk copy of the 16-byte-aligned body where dst's
// lines match the ring's, the ends by threads; else every cell by threads.
// Commits one bulk group either way (empty in the second), which ring_fill
// counts.
__device__ __forceinline__ void ring_store(int32_t* dst, const int* cur, int lo, int S, int ph, int tid, int T) {
  if (phase_of(dst) == ph) {
    const int hd = min(S, lo + ((4 - ((ph + lo) & 3)) & 3)), nq = (S - hd) >> 2;
    if (tid == 0) {
      if (nq > 0) bulk_store(dst + hd, cur + hd, 16u * nq);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (tid < hd - lo) dst[lo + tid] = cur[lo + tid];
    if (tid < S - hd - 4 * nq) dst[hd + 4 * nq + tid] = cur[hd + 4 * nq + tid];
  } else {
    if (tid == 0) asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    for (int i = lo + tid; i < S; i += T) dst[i] = cur[i];
  }
}

// Exclusive block scans of one element per thread under comb: NF forward
// (threads in order) and NB backward (in reverse order).  On return each
// element holds the combination of the threads before its thread in its
// scan's order (kInf, no restart, for the first).  s_f, s_b: NF and NB rows
// of 32 ints of shared memory.  Every thread of the block calls it; two
// barriers.  The second level scans the warps' aggregates in warp 0, or, for
// more than two scans in a block of as many warps, one warp a scan.
template <int NF, int NB>
__device__ __forceinline__ void block_scans(int (&f)[NF], int (&b)[NB], int (*s_f)[32], int (*s_b)[32]) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int xf[NF], xb[NB];
#pragma unroll
  for (int j = 0; j < NF; ++j) xf[j] = f[j];
#pragma unroll
  for (int j = 0; j < NB; ++j) xb[j] = b[j];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int y = __shfl_up_sync(0xffffffffu, xf[j], d);
      if (lane >= d) xf[j] = comb(y, xf[j]);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int y = __shfl_down_sync(0xffffffffu, xb[j], d);
      if (lane + d < 32) xb[j] = comb(y, xb[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    f[j] = __shfl_up_sync(0xffffffffu, xf[j], 1);
    if (lane == 0) f[j] = kInf;
    if (lane == 31) s_f[j][wid] = xf[j];
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    b[j] = __shfl_down_sync(0xffffffffu, xb[j], 1);
    if (lane == 31) b[j] = kInf;
    if (lane == 0) s_b[j][wid] = xb[j];
  }
  __syncthreads();
  if (NF + NB > 2 && nw >= NF + NB) {
    // One warp a scan.
    if (wid < NF + NB) {
      int* row = wid < NF ? s_f[wid] : s_b[wid - NF];
      int p = lane < nw ? row[lane] : kInf;
      if (wid < NF) {
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, p, d);
          if (lane >= d) p = comb(y, p);
        }
        const int q = __shfl_up_sync(0xffffffffu, p, 1);
        if (lane < nw) row[lane] = lane == 0 ? kInf : q;
      } else {
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_down_sync(0xffffffffu, p, d);
          if (lane + d < 32) p = comb(y, p);
        }
        const int q = __shfl_down_sync(0xffffffffu, p, 1);
        if (lane < nw) row[lane] = lane == 31 ? kInf : q;
      }
    }
  } else if (wid == 0) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      int p = lane < nw ? s_f[j][lane] : kInf;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, p, d);
        if (lane >= d) p = comb(y, p);
      }
      const int q = __shfl_up_sync(0xffffffffu, p, 1);
      if (lane < nw) s_f[j][lane] = lane == 0 ? kInf : q;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      int p = lane < nw ? s_b[j][lane] : kInf;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_down_sync(0xffffffffu, p, d);
        if (lane + d < 32) p = comb(y, p);
      }
      const int q = __shfl_down_sync(0xffffffffu, p, 1);
      if (lane < nw) s_b[j][lane] = lane == 31 ? kInf : q;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NF; ++j) f[j] = comb(s_f[j][wid], f[j]);
#pragma unroll
  for (int j = 0; j < NB; ++j) b[j] = comb(s_b[j][wid], b[j]);
}

// The fine horizontal run-min (border rows kept) fused with the vertical
// half of the violation stencil: scratch `in` -> `out`, which must not
// alias.  Block b owns rows [b * band_rows, +band_rows) and walks them from
// the row above its band (the shadow row: computed for the stencil, not
// stored) in steps of at most `rows_per_step` whole rows.  A step's span of
// cells lies in ring buffer s % 3 at logical cell `phase + i`, so that its
// 16-byte lines match the plane's; thread t owns logical cells [20t, 20t+20).
// `flag` gets 1 when a claimed vertical pair off the border columns differs.
// The coarse form (kCoarse) is the h-pass of a coarse round: a forward
// segment restarts at a cell with bit 26, a backward one at a cell with bit
// 27 (and both at a row's end, as each row is its own scan), empty cells
// scan as kInf and stay, the high bits pass through; no shadow row and no
// stencil: `flag` gets the number of cells whose value changed, and with
// `go` (may be null) the launch returns at once when *go is 0 (a coarse
// round's stop, rwt_coarse_round).
template <bool kCoarse>
__global__ void __launch_bounds__(1024)
row_ring(const int32_t* __restrict__ in, int32_t* __restrict__ out, int32_t* flag, int h, int w,
         int rows_per_step, int band_rows, const int32_t* __restrict__ go) {
  if constexpr (kCoarse) {
    if (go != nullptr && *go == 0) return;
  }
  extern __shared__ int4 ring4[];
  int* ring = reinterpret_cast<int*>(ring4);
  __shared__ int s_wf[32], s_wb[32];
  __shared__ uint64_t s_bar[kRing];
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, wid = tid >> 5, nw = T >> 5;
  const int L = T * kCells;  // cells of one buffer
  const int G = rows_per_step;
  const int r0 = blockIdx.x * band_rows, r_end = min(h, r0 + band_rows);
  const int rs = (r0 > 0 && !kCoarse) ? r0 - 1 : r0;
  const int n_steps = (r_end - rs + G - 1) / G;

  // Thread 0 fills buffer s % 3 for step s (ring_fill waits for the bulk
  // store of step s - 3 from it).
  auto issue = [&](int s) {
    const int a = rs + s * G;
    ring_fill(ring + (s % kRing) * L, in + (size_t)a * w, min(G, r_end - a) * w, &s_bar[s % kRing]);
  };

  if (tid == 0) {
    ring_init(s_bar);
    issue(0);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  __syncthreads();
  bool bad = false;
  int n_ch = 0;
  for (int s = 0; s < n_steps; ++s) {
    if (tid == 0 && s + 1 < n_steps) issue(s + 1);
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    mbar_wait(&s_bar[s % kRing], (s / kRing) & 1);
    __syncthreads();
    const int a = rs + s * G, S = min(G, r_end - a) * w;
    const int ph = phase_of(in + (size_t)a * w);
    int* buf = ring + (s % kRing) * L;

    // The owned cells as scan values: a label, or kInf for an unclaimed
    // cell or one outside the span.  Masks, bit k for cell k: inside the
    // span, first / last of its row, on a border row (kept).  Cells before
    // the span start at negative columns.
    const int i0 = tid * kCells - ph;
    unsigned m_in, m_first, m_last, m_keep;
    if (G == 1) {  // the span is row `a`
      const int lo_k = max(0, -i0), hi_k = min(kCells, S - i0);
      m_in = hi_k > lo_k ? ((1u << hi_k) - 1u) & ~((1u << lo_k) - 1u) : 0u;
      m_first = (i0 <= 0 && -i0 < kCells) ? 1u << -i0 : 0u;
      m_last = (S - 1 - i0 >= 0 && S - 1 - i0 < kCells) ? 1u << (S - 1 - i0) : 0u;
      m_keep = (!kCoarse && (a == 0 || a == h - 1)) ? m_in : 0u;
    } else {
      m_in = m_first = m_last = m_keep = 0;
      int col = i0, row = a;
      if (i0 > 0) {
        row = a + i0 / w;
        col = i0 % w;
      }
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        if (i0 + k >= 0 && i0 + k < S) {
          m_in |= 1u << k;
          if (col == 0) m_first |= 1u << k;
          if (col == w - 1) m_last |= 1u << k;
          if (!kCoarse && (row == 0 || row == h - 1)) m_keep |= 1u << k;
        }
        if (++col == w) {
          col = 0;
          ++row;
        }
      }
    }
    int v[kCells], F[kCells];
    const int4* own = reinterpret_cast<const int4*>(buf) + tid * (kCells / 4);
#pragma unroll
    for (int q = 0; q < kCells / 4; ++q) {
      const int4 x = own[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
    // The run-min inside the thread's cells: a forward scan, then a backward
    // one folded into min(forward, backward).  Segments restart at an
    // unclaimed cell (kInf from here on, as cells outside the span) and at a
    // row's first (forward) or last (backward) cell.  Most threads hold 20
    // cells of one row's inside: `plain` drops the masks from their loops.
    unsigned m_inf = 0, rf, rb;
    int af, ab;
    auto local = [&](auto plain_tag) {
      constexpr bool kPlain = decltype(plain_tag)::value;
      if constexpr (kCoarse) {
        // Resets from the cells' bits; cells outside the span reset both
        // ways with no value, as the fine form's unclaimed cells do.
        unsigned bf = 0, bb = 0;
#pragma unroll
        for (int k = 0; k < kCells; ++k) {
          bf |= static_cast<unsigned>((v[k] >> kHf) & 1) << k;
          bb |= static_cast<unsigned>((v[k] >> kHb) & 1) << k;
          v[k] = (!kPlain && !((m_in >> k) & 1)) ? kInf : value_of<true>(v[k]);
        }
        const unsigned out_k = kPlain ? 0u : ~m_in & ((1u << kCells) - 1u);
        rf = kPlain ? bf : bf | out_k | m_first;
        rb = kPlain ? bb : bb | out_k | m_last;
      } else {
#pragma unroll
        for (int k = 0; k < kCells; ++k) {
          if (v[k] == 0 || (!kPlain && !((m_in >> k) & 1))) v[k] = kInf;
          if (v[k] == kInf) m_inf |= 1u << k;
        }
        rf = kPlain ? m_inf : m_inf | m_first;
        rb = kPlain ? m_inf : m_inf | m_last;
      }
      int f = kInf, b = kInf;
#pragma unroll
      for (int k = 0; k < kCells; ++k) {
        f = ((rf >> k) & 1) ? v[k] : min(f, v[k]);
        F[k] = f;
      }
#pragma unroll
      for (int k = kCells - 1; k >= 0; --k) {
        b = ((rb >> k) & 1) ? v[k] : min(b, v[k]);
        F[k] = min(F[k], b);
      }
      af = f | (rf ? kR : 0);
      ab = b | (rb ? kR : 0);
    };
    if (m_in == (1u << kCells) - 1u && (m_first | m_last) == 0) {
      local(std::true_type{});
    } else {
      local(std::false_type{});
    }

    // Block scans of the (value, restarted) aggregates: forward over the
    // threads in order, backward in reverse (block_scans<1, 1> written out:
    // calling it gave row_ring<false> 4 bytes of spills, -Xptxas -v).
    int xf = af, xb = ab;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int yf = __shfl_up_sync(0xffffffffu, xf, d);
      const int yb = __shfl_down_sync(0xffffffffu, xb, d);
      if (lane >= d) xf = comb(yf, xf);
      if (lane + d < 32) xb = comb(yb, xb);
    }
    int ef = __shfl_up_sync(0xffffffffu, xf, 1), eb = __shfl_down_sync(0xffffffffu, xb, 1);
    if (lane == 0) ef = kInf;
    if (lane == 31) eb = kInf;
    if (lane == 31) s_wf[wid] = xf;
    if (lane == 0) s_wb[wid] = xb;
    __syncthreads();
    if (wid == 0) {
      int pf = lane < nw ? s_wf[lane] : kInf, pb = lane < nw ? s_wb[lane] : kInf;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int yf = __shfl_up_sync(0xffffffffu, pf, d);
        const int yb = __shfl_down_sync(0xffffffffu, pb, d);
        if (lane >= d) pf = comb(yf, pf);
        if (lane + d < 32) pb = comb(yb, pb);
      }
      int qf = __shfl_up_sync(0xffffffffu, pf, 1), qb = __shfl_down_sync(0xffffffffu, pb, 1);
      if (lane == 0) qf = kInf;
      if (lane == 31) qb = kInf;
      if (lane < nw) {
        s_wf[lane] = qf;
        s_wb[lane] = qb;
      }
    }
    __syncthreads();
    // The thread's leading run (before its first forward restart) continues
    // the run of the threads before it; its trailing run (after its last
    // backward restart) that of the threads after it.
    const int cf = comb(s_wf[wid], ef) & kVM, cb = comb(s_wb[wid], eb) & kVM;
    const unsigned lead = rf ? (rf & -rf) - 1u : ~0u;
    const unsigned trail = rb ? ~((2u << (31 - __clz(rb))) - 1u) : ~0u;
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int o = __vimin3_s32(F[k], ((lead >> k) & 1) ? cf : kInf, ((trail >> k) & 1) ? cb : kInf);
      F[k] = ((m_inf >> k) & 1) ? 0 : (((m_keep >> k) & 1) ? v[k] : o);
    }
    int4* mine = reinterpret_cast<int4*>(buf) + tid * (kCells / 4);
    if constexpr (kCoarse) {
      // The run-min merged into the cells, read again from the buffer.
#pragma unroll
      for (int q = 0; q < kCells / 4; ++q) {
        const int4 x = own[q];
        const int c[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * q + j;
          F[k] = with_value<true>(c[j], F[k]);
          n_ch += ((m_in >> k) & 1) && F[k] != c[j];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kCells / 4; ++q) mine[q] = make_int4(F[4 * q], F[4 * q + 1], F[4 * q + 2], F[4 * q + 3]);

    const int lo = (!kCoarse && s == 0 && r0 > 0) ? w : 0;  // the shadow row is not stored
    int32_t* dst = out + (size_t)a * w;
    const int* cur = buf + ph;
    const int ph_prev = s > 0 ? phase_of(in + (size_t)(a - G) * w) : ph;
    if (kCoarse) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
    } else if (G == 1 && ph_prev == ph) {
      // One row per step, aligned alike in this buffer and the previous
      // one: each thread checks its own cells against the row above.
      if (s > 0) {
        const int4* up = reinterpret_cast<const int4*>(ring + ((s + kRing - 1) % kRing) * L) + tid * (kCells / 4);
        const unsigned inner = m_in & ~(m_first | m_last);
#pragma unroll
        for (int q = 0; q < kCells / 4; ++q) {
          const int4 u = up[q];
          const int us[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = 4 * q + j;
            bad |= ((inner >> k) & 1) && min(F[k], us[j]) > 0 && F[k] != us[j];
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
    } else {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      // Vertical pairs (r-1, r) for the rows this band owns: the first row
      // of step 0 is row 0 or the shadow row, whose pair belongs elsewhere.
      // The row above a step's first row ends the previous (full) step.
      const int* prev = s > 0 ? ring + ((s + kRing - 1) % kRing) * L + ph_prev + G * w : cur;
      for (int i = (s == 0 ? w : 0) + tid; i < S; i += T) {
        const int col = G == 1 ? i : i % w;
        if (col == 0 || col == w - 1) continue;
        const int o = cur[i], u = i >= w ? cur[i - w] : prev[i - w];
        bad |= o > 0 && u > 0 && o != u;
      }
      __syncthreads();  // the previous buffer is free for the next load
    }
    // Store the step's rows (not the shadow row).
    ring_store(dst, cur, lo, S, ph, tid, T);
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  if constexpr (kCoarse) {
    n_ch = __reduce_add_sync(0xffffffffu, n_ch);
    if (lane == 0 && n_ch) atomicAdd(flag, n_ch);
  } else {
    if (__syncthreads_or(bad) && tid == 0) atomicOr(flag, 1);
  }
}

// The legacy coarse pass 2's row half with the violation stencil fused
// (rwt_coarse_bwd_vh's ring route): scratch `in` (the backward column scan
// of the pass's input, whose reset bits it keeps) -> `out`, which must not
// alias.  The ring walk is row_ring's with the fine form's shadow row: block
// b owns rows [b * band_rows, +band_rows) and walks them from the row above
// its band (computed for the stencil, not stored), a step of at most
// rows_per_step whole rows in buffer s % 3, cell i at buffer position
// phase + i, thread t owning positions [20t, 20t + 20).  A cell takes
// min(hf, hb): hf the forward scan under bit 26 reaching at most `reach`
// cells back, hb the backward scan under bit 27 reaching `reach` ahead, each
// stopping at (and taking) the cell that resets it; a row's ends reset both;
// empty cells scan as kInf and stay.  With reach < 0 or >= w - 1 both are
// the whole run (row_ring<true>'s run-min).  Windowed, B = reach + 1 is a
// power of two and blocks of B columns start at each row's column 0 (van
// Herk / Gil-Werman: O(1) work a cell, whatever the window); kWin selects
// the windowed form (reach >= 0 and < w - 1): a ring of four buffers (two
// steps loaded ahead) and two for G and H, at most kWinThreads threads
// (128 registers each):
//   hf[x] = Pf[x] if a forward reset lies in [x - B + 1, x], else
//           min(H[x - B + 1], G[x]);
//   hb[x] = Pb[x] if a backward reset lies in [x, x + B - 1], else
//           min(H[x], G[x + B - 1]);
// Pf and Pb the run scans, G the min from x's block start to x, H the min
// from x to its block end (both in shared memory after the ring, for the
// reads B - 1 cells away), and the nearest resets from scans of their
// positions.  Each scan is segmented inside a thread's cells; block_scans
// gives the carries into its leading (trailing) segment.  `flag` gets 1 when
// some pair joined by an edge (the later cell's bit 24 clear for a vertical
// pair, bit 26 for a horizontal one) holds two values: a windowed scan
// leaves a row not constant along its runs, so both halves are checked, on
// the step's output in the ring (the row above a step's first row ends the
// previous buffer; a band's first row has its shadow row above it).
template <bool kWin>
__global__ void __launch_bounds__(kWin ? kWinThreads : 1024)
hwin_ring(const int32_t* __restrict__ in, int32_t* __restrict__ out, int32_t* flag, int h, int w,
          int rows_per_step, int band_rows, int reach) {
  extern __shared__ int4 ring4[];
  int* ring = reinterpret_cast<int*>(ring4);
  constexpr int kD = kWin ? kRing + 1 : kRing;  // ring buffers: windowed, two steps prefetched
  __shared__ int s_f[3][32], s_b[3][32];
  __shared__ uint64_t s_bar[kD];
  constexpr unsigned kAll = (1u << kHC) - 1u;
  const int T = blockDim.x, tid = threadIdx.x;
  const int L = T * kHC, p0 = tid * kHC;  // cells of one buffer; the thread's first position
  const int G = rows_per_step;
  const int r0 = blockIdx.x * band_rows, r_end = min(h, r0 + band_rows);
  const int rs = r0 > 0 ? r0 - 1 : 0;
  const int n_steps = (r_end - rs + G - 1) / G;
  const int B = reach + 1;
  int* gs = ring + kD * L;  // windowed: G, then H, at the step's buffer positions
  int* hs = gs + L;

  auto issue = [&](int s) {
    const int a = rs + s * G;
    ring_fill(ring + (s % kD) * L, in + (size_t)a * w, min(G, r_end - a) * w, &s_bar[s % kD]);
  };
  // Steps 0 .. kD - 3 are loaded ahead of the loop, one commit group each.
  if (tid == 0) ring_init(s_bar, kD);
#pragma unroll
  for (int s = 0; s < kD - 2; ++s) {
    if (tid == 0 && s < n_steps) issue(s);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  __syncthreads();  // the mbarriers are initialised
  bool bad = false;
  for (int s = 0; s < n_steps; ++s) {
    // Step s + kD - 2 loads into the buffer of step s - 2, which step s - 1
    // read as the row above before its last barrier; ring_fill waits for
    // that step's bulk store.
    if (tid == 0 && s + kD - 2 < n_steps) issue(s + kD - 2);
    asm volatile("cp.async.commit_group;" ::: "memory");
    if constexpr (kD == 4) {
      asm volatile("cp.async.wait_group 2;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    }
    mbar_wait(&s_bar[s % kD], (s / kD) & 1);
    __syncthreads();
    const int a = rs + s * G, S = min(G, r_end - a) * w;
    const int ph = phase_of(in + (size_t)a * w);
    int* buf = ring + (s % kD) * L;
    const int i0 = p0 - ph;  // the thread's first cell in the span (negative: before it)

    // Masks, bit k for cell k: inside the span, first / last of its row.
    unsigned m_in, m_first, m_last;
    if (G == 1) {
      const int lo_k = max(0, -i0), hi_k = min(kHC, S - i0);
      m_in = hi_k > lo_k ? ((1u << hi_k) - 1u) & ~((1u << lo_k) - 1u) : 0u;
      m_first = (i0 <= 0 && -i0 < kHC) ? 1u << -i0 : 0u;
      m_last = (S - 1 - i0 >= 0 && S - 1 - i0 < kHC) ? 1u << (S - 1 - i0) : 0u;
    } else {
      m_in = m_first = m_last = 0;
      int col = i0 > 0 ? i0 % w : i0;
#pragma unroll
      for (int k = 0; k < kHC; ++k) {
        if (i0 + k >= 0 && i0 + k < S) {
          m_in |= 1u << k;
          if (col == 0) m_first |= 1u << k;
          if (col == w - 1) m_last |= 1u << k;
        }
        if (++col == w) col = 0;
      }
    }
    const unsigned out_k = ~m_in & kAll;
    const int4* own = reinterpret_cast<const int4*>(buf) + tid * (kHC / 4);
    // The cells' values (kInf outside the span) and reset bits.
    int v[kHC];
    unsigned bf = 0, bb = 0, bv = 0;
#pragma unroll
    for (int q = 0; q < kHC / 4; ++q) {
      const int4 x = own[q];
      const int c[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * q + j;
        bf |= static_cast<unsigned>((c[j] >> kHf) & 1) << k;
        bb |= static_cast<unsigned>((c[j] >> kHb) & 1) << k;
        bv |= static_cast<unsigned>((c[j] >> kVf) & 1) << k;
        v[k] = ((m_in >> k) & 1) ? value_of<true>(c[j]) : kInf;
      }
    }
    const unsigned rf = bf | out_k | m_first, rb = bb | out_k | m_last;

    int o[kHC];  // min(hf, hb)
    if constexpr (!kWin) {
      // The run-min, as row_ring<true>: local scans, then the carries into
      // the leading and trailing runs.
      int f = kInf, b = kInf;
#pragma unroll
      for (int k = 0; k < kHC; ++k) {
        f = ((rf >> k) & 1) ? v[k] : min(f, v[k]);
        o[k] = f;
      }
#pragma unroll
      for (int k = kHC - 1; k >= 0; --k) {
        b = ((rb >> k) & 1) ? v[k] : min(b, v[k]);
        o[k] = min(o[k], b);
      }
      int xf[1] = {f | (rf ? kR : 0)}, xb[1] = {b | (rb ? kR : 0)};
      block_scans(xf, xb, s_f, s_b);
      const int cf = xf[0] & kVM, cb = xb[0] & kVM;
      const unsigned lead = rf ? (rf & -rf) - 1u : ~0u;
      const unsigned trail = rb ? ~((2u << (31 - __clz(rb))) - 1u) : ~0u;
#pragma unroll
      for (int k = 0; k < kHC; ++k)
        o[k] = __vimin3_s32(o[k], ((lead >> k) & 1) ? cf : kInf, ((trail >> k) & 1) ? cb : kInf);
    } else {
      // Block starts and ends (a row's ends too); cells outside the span
      // restart every scan.  One row a step: the starts are every B-th cell
      // from the first at or after the thread's (rep: bits B apart).
      unsigned bs = 0, be = 0;
      if (G == 1) {
        const unsigned rep = B >= 32 ? 1u : 0xffffffffu / ((1u << B) - 1u);
        const int k0 = -i0 & reach;
        bs = k0 < kHC ? rep << k0 : 0u;
        be = (bs >> 1) | (((i0 + kHC) & reach) == 0 ? 1u << (kHC - 1) : 0u);
      } else {
        int col = i0 > 0 ? i0 % w : i0;
#pragma unroll
        for (int k = 0; k < kHC; ++k) {
          bs |= static_cast<unsigned>((col & reach) == 0) << k;
          be |= static_cast<unsigned>((col & reach) == reach) << k;
          if (++col == w) col = 0;
        }
      }
      const unsigned rg = (bs & m_in) | out_k | m_first, rh = (be & m_in) | out_k | m_last;
      // The thread's aggregates: Pf, G and the last forward reset's
      // position; Pb, H and the first backward reset's.
      int f = kInf, g = kInf, b = kInf, hh = kInf;
#pragma unroll
      for (int k = 0; k < kHC; ++k) {
        f = ((rf >> k) & 1) ? v[k] : min(f, v[k]);
        g = ((rg >> k) & 1) ? v[k] : min(g, v[k]);
      }
#pragma unroll
      for (int k = kHC - 1; k >= 0; --k) {
        b = ((rb >> k) & 1) ? v[k] : min(b, v[k]);
        hh = ((rh >> k) & 1) ? v[k] : min(hh, v[k]);
      }
      int xf[3] = {f | (rf ? kR : 0), g | (rg ? kR : 0), rf ? (p0 + 31 - __clz(rf)) | kR : kInf};
      int xb[3] = {b | (rb ? kR : 0), hh | (rh ? kR : 0), rb ? (p0 + __ffs(rb) - 1) | kR : kInf};
      block_scans(xf, xb, s_f, s_b);
      // G and H of the thread's cells, from the carries.
      g = xf[1] & kVM;
      hh = xb[1] & kVM;
#pragma unroll
      for (int q = 0; q < kHC / 4; ++q) {
        int y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * q + j;
          y[j] = g = ((rg >> k) & 1) ? v[k] : min(g, v[k]);
        }
        reinterpret_cast<int4*>(gs + p0)[q] = make_int4(y[0], y[1], y[2], y[3]);
      }
#pragma unroll
      for (int q = kHC / 4 - 1; q >= 0; --q) {
        int y[4];
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          const int k = 4 * q + j;
          y[j] = hh = ((rh >> k) & 1) ? v[k] : min(hh, v[k]);
        }
        reinterpret_cast<int4*>(hs + p0)[q] = make_int4(y[0], y[1], y[2], y[3]);
      }
      __syncthreads();
      // hf, then min(hf, hb).  The thread's H[p - B + 1] and G[p + B - 1]
      // come as int2 pairs from the cell before the first (an even
      // position: B is even), with 2-way bank conflicts as int4 reads would
      // have; they stay inside the G and H arrays (or the ring below them),
      // since B <= L - 3.  in_f, in_b: bit k when cell k's window holds a
      // reset (every cell outside the span restarts both scans at itself),
      // from the thread's resets by doubling and the nearest ones before
      // and after it; such a cell takes its run scan instead.
      unsigned in_f = rf, in_b = rb;
      for (int sh = 1; sh < B && sh < kHC; sh <<= 1) {
        in_f |= in_f << sh;
        in_b |= in_b >> sh;
      }
      // Cells [0, n_f) reach back to the last reset before the thread (if
      // any); cells [n_b, kHC) ahead to the first one after it.
      const int n_f = (xf[2] & kR) ? (xf[2] & kVM) + B - p0 : 0, n_b = (xb[2] & kVM) - B + 1 - p0;
      in_f |= n_f >= kHC ? kAll : (n_f > 0 ? (1u << n_f) - 1u : 0u);
      in_b |= n_b <= 0 ? kAll : (n_b < kHC ? kAll & ~((1u << n_b) - 1u) : 0u);
      int x[kHC + 2];
      const int2* hw = reinterpret_cast<const int2*>(hs + p0 - B);
#pragma unroll
      for (int q = 0; q < kHC / 2 + 1; ++q) {
        const int2 y = hw[q];
        x[2 * q] = y.x, x[2 * q + 1] = y.y;
      }
      int pf = xf[0] & kVM;
#pragma unroll
      for (int q = 0; q < kHC / 4; ++q) {
        const int4 g4 = reinterpret_cast<const int4*>(gs + p0)[q];
        const int gq[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * q + j;
          pf = ((rf >> k) & 1) ? v[k] : min(pf, v[k]);
          o[k] = ((in_f >> k) & 1) ? pf : min(x[k + 1], gq[j]);
        }
      }
      const int2* gw = reinterpret_cast<const int2*>(gs + p0 + B - 2);
#pragma unroll
      for (int q = 0; q < kHC / 2 + 1; ++q) {
        const int2 y = gw[q];
        x[2 * q] = y.x, x[2 * q + 1] = y.y;
      }
      int pb = xb[0] & kVM;
#pragma unroll
      for (int q = kHC / 4 - 1; q >= 0; --q) {
        const int4 h4 = reinterpret_cast<const int4*>(hs + p0)[q];
        const int hq[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          const int k = 4 * q + j;
          pb = ((rb >> k) & 1) ? v[k] : min(pb, v[k]);
          o[k] = min(o[k], ((in_b >> k) & 1) ? pb : min(hq[j], x[k + 1]));
        }
      }
    }

    // The output cells into the buffer; o becomes their values, 0 for an
    // empty cell or one outside the span (v = kInf), as the stencil
    // compares them.
    int4* mine = reinterpret_cast<int4*>(buf) + tid * (kHC / 4);
#pragma unroll
    for (int q = 0; q < kHC / 4; ++q) {
      const int4 x = own[q];
      const int c[4] = {x.x, x.y, x.z, x.w};
      int y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * q + j;
        o[k] = v[k] == kInf ? 0 : o[k];
        y[j] = (c[j] & ~kVal) | o[k];
      }
      mine[q] = make_int4(y[0], y[1], y[2], y[3]);
    }
    // Pairs to check: vertical where bit 24 is clear, horizontal where bit
    // 26 is clear and the cell is not first in its row.  Step 0's first row
    // is row 0 (no row above) or the shadow row (its pairs are the band
    // above's).  d: bit k when cell k differs from its neighbour.
    unsigned ev = ~bv & m_in, eh = ~bf & m_in & ~m_first;
    if (s == 0) {
      const int n0 = w - i0;  // cells of the thread in the first row
      const unsigned row0 = n0 >= kHC ? kAll : (n0 > 0 ? (1u << n0) - 1u : 0u);
      ev &= ~row0;
      if (r0 > 0) eh &= ~row0;
    }
    unsigned d = 0;
#pragma unroll
    for (int k = 1; k < kHC; ++k) d |= static_cast<unsigned>(o[k - 1] != o[k]) << k;
    bad |= (d & eh & ~1u) != 0;
    // The first row's cells against the row above, which ends the previous
    // buffer; the other pairs against this step's output, after the barrier.
    const int* cur = buf + ph;
    const unsigned first_row = (i0 < w ? 2u << min(w - 1 - i0, kHC - 1) : 1u) - 1u;
    if (ev & first_row) {
      const int ph_prev = phase_of(in + (size_t)(a - G) * w);
      const int* prev = ring + ((s + kD - 1) % kD) * L;
      d = 0;
      if (G == 1 && ph_prev == ph) {
        // One row a step, aligned alike in both buffers: the cell above
        // lies at the same position in the previous buffer.
        const int4* up = reinterpret_cast<const int4*>(prev) + tid * (kHC / 4);
#pragma unroll
        for (int q = 0; q < kHC / 4; ++q) {
          const int4 u = up[q];
          const int us[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) d |= static_cast<unsigned>(label_of<true>(us[j]) != o[4 * q + j]) << (4 * q + j);
        }
      } else {
        prev += ph_prev + G * w;
#pragma unroll
        for (int k = 0; k < kHC; ++k)
          if (((ev & first_row) >> k) & 1) d |= static_cast<unsigned>(label_of<true>(prev[i0 + k - w]) != o[k]) << k;
      }
      bad |= (d & ev & first_row) != 0;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    // Store the step's rows (not the shadow row), then check the pairs that
    // reach into other threads' cells of this step.
    ring_store(out + (size_t)a * w, cur, (s == 0 && r0 > 0) ? w : 0, S, ph, tid, T);
    if (eh & 1u) bad |= label_of<true>(cur[i0 - 1]) != o[0];
    if (ev & ~first_row) {
#pragma unroll
      for (int k = 0; k < kHC; ++k)
        if (((ev & ~first_row) >> k) & 1) bad |= label_of<true>(cur[i0 + k - w]) != o[k];
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  if (__syncthreads_or(bad) && tid == 0) atomicOr(flag, 1);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device; `set_to` (the caller's, one entry per device) keeps what it was
// last set to there, so that it is set again only when a launch needs more.
template <typename K>
cudaError_t allow_smem(K kernel, int smem, int (&set_to)[16]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 16 && set_to[dev] >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < 16) set_to[dev] = smem;
  return e;
}

template <bool kCoarse>
cudaError_t ring_smem(int smem) {
  static int set_to[16] = {};
  return allow_smem(row_ring<kCoarse>, smem, set_to);
}

dim3 cell_grid(int h, int w) {
  return dim3((w + 255) / 256, h < 4096 ? h : 4096);
}

// The column scan, one block per tile: with `zero`, the status counter and
// flags are zeroed first (else they must be zero already); `carry` is
// status + 1 + n_tiles when null.  `vec` asks for 16-byte access (w % 4 ==
// 0, the planes 16-byte aligned; refused otherwise).  `go` and `to_zero`:
// the coarse round's stop word and change count (vscan_tiles), or null.
template <bool kCoarse, bool kFwd>
cudaError_t vscan(const int32_t* in, int32_t* out, int32_t* changed, int32_t* status, int h, int w,
                  int vec, cudaStream_t st, const int32_t* orig = nullptr, int32_t* carry = nullptr,
                  bool zero = true, const int32_t* go = nullptr, int32_t* to_zero = nullptr) {
  const int tc = vec ? 128 : 32;
  const int n_tc = (w + tc - 1) / tc;
  const long long n_tiles = (long long)((h + kTileRows - 1) / kTileRows) * n_tc;
  if (n_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  if (vec && (w % 4 != 0 || reinterpret_cast<uintptr_t>(in) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(out) % 16 != 0 || reinterpret_cast<uintptr_t>(orig) % 16 != 0))
    return cudaErrorInvalidValue;
  if (carry == nullptr) carry = status + 1 + n_tiles;
  if (zero) {
    const cudaError_t e = cudaMemsetAsync(status, 0, (size_t)(1 + n_tiles) * sizeof(int32_t), st);
    if (e != cudaSuccess) return e;
  }
  if (vec) {
    vscan_tiles<kCoarse, true, kFwd><<<(unsigned)n_tiles, 32 * kTileWarps, 0, st>>>(in, out, changed, status, carry,
                                                                                     h, w, n_tc, orig, go, to_zero);
  } else {
    vscan_tiles<kCoarse, false, kFwd><<<(unsigned)n_tiles, 32 * kTileWarps, 0, st>>>(in, out, changed, status,
                                                                                      carry, h, w, n_tc, orig, go,
                                                                                      to_zero);
  }
  return cudaGetLastError();
}

}  // namespace

// in, out: (h, w) int32 fine label planes; `out` may be `in`.  flag: one
// int32, zeroed here, then 1 when some cell changed.  status: the column
// scan's status buffer, 1 + n_tiles + 2 * n_tiles * tile_cols int32
// (ops/scan_merge.py vscan_plan), of which the first 1 + n_tiles are zeroed
// here.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int rwt_fine_fwd_v(const void* in, void* out, void* flag, void* status, int h, int w,
                              int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (h == 0 || w == 0) return 0;
  return static_cast<int>(vscan<false, true>(static_cast<const int32_t*>(in), static_cast<int32_t*>(out),
                                      static_cast<int32_t*>(flag), static_cast<int32_t*>(status), h, w,
                                      vec, st));
}

// in, scratch, out: (h, w) int32 fine label planes; `out` may be `in`,
// `scratch` aliases neither.  flag: one int32, zeroed here, then 1 when the
// output violates the fixed point.  status and vec: as for rwt_fine_fwd_v
// (vec for `in` and `scratch`).  The row plan (ops/scan_merge.py row_plan):
// `threads` > 0 runs the ring row kernel with `rows_per_step` rows per step,
// a block per `band_rows` rows and `smem` bytes of ring; `threads` == 0
// (rows wider than the ring) the chunked run-min and the stencil launch.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int rwt_fine_bwd_vh(const void* in, void* scratch, void* out, void* flag, void* status, int h,
                               int w, int vec, int rows_per_step, int band_rows, int threads, int smem,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (h == 0 || w == 0) return 0;
  const int32_t* i = static_cast<const int32_t*>(in);
  int32_t* s = static_cast<int32_t*>(scratch);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* f = static_cast<int32_t*>(flag);
  if (threads == 0) {
    if (w <= kRowCap) return static_cast<int>(cudaErrorInvalidValue);
  } else if (w > kRowCap || threads % 32 != 0 || threads > 1024 || rows_per_step < 1 || band_rows < 1 ||
             (long long)rows_per_step * w + 3 > (long long)threads * kCells ||
             smem != kRing * threads * kCells * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  e = vscan<false, false>(i, s, nullptr, static_cast<int32_t*>(status), h, w, vec, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (threads == 0) {
    run_min_pass<false><<<(h + 7) / 8, dim3(kChunks, 8), 0, st>>>(s, o, nullptr, h, w);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    violations<false><<<cell_grid(h, w), 256, 0, st>>>(o, f, h, w);
    return static_cast<int>(cudaGetLastError());
  }
  e = ring_smem<false>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  row_ring<false><<<(h + band_rows - 1) / band_rows, threads, smem, st>>>(s, o, f, h, w, rows_per_step, band_rows,
                                                                          nullptr);
  return static_cast<int>(cudaGetLastError());
}

// in, out: (h, w) int32 packed coarse planes; `out` may be `in`.  flag: one
// int32, zeroed here, then 1 when some cell changed.  Launches on `stream`,
// does not synchronise, returns cudaGetLastError().
extern "C" int rwt_coarse_fwd_v(const void* in, void* out, void* flag, int h, int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (h == 0 || w == 0) return 0;
  v_pass<true, true><<<(w + 31) / 32, dim3(32, kChunks), 0, st>>>(
      static_cast<const int32_t*>(in), static_cast<int32_t*>(out), static_cast<int32_t*>(flag), h, w);
  return static_cast<int>(cudaGetLastError());
}

// in, scratch, out: (h, w) int32 packed coarse planes; `out` may be `in`,
// `scratch` aliases neither.  reach: the horizontal window (cells each way,
// 2^k - 1), or < 0 for full length.  flag: one int32, zeroed here, then 1
// when the output violates the fixed point.  The backward column scan in ->
// scratch (v_pass), then the row plan (ops/scan_merge.py legacy_row_plan):
// `threads` > 0 runs hwin_ring with `rows_per_step` rows per step, a block
// per `band_rows` rows and `smem` bytes of ring (and, windowed, of the block
// mins); `threads` == 0 (rows wider than the ring, or windowed rows whose
// buffers do not fit a block) the chunked windowed or full-length scan and
// the stencil launch.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int rwt_coarse_bwd_vh(const void* in, void* scratch, void* out, void* flag, int h, int w, int reach,
                                 int rows_per_step, int band_rows, int threads, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (h == 0 || w == 0) return 0;
  const bool win = reach >= 0 && reach < w - 1;
  if (win && (reach & (reach + 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (threads != 0 && (w > kRowCap || threads % 32 != 0 || threads > 1024 || rows_per_step < 1 || band_rows < 1 ||
             (long long)rows_per_step * w + 3 > (long long)threads * kHC ||
             (win && (threads > kWinThreads || reach + 4 > threads * kHC)) ||
             smem != (win ? kRing + 3 : kRing) * threads * kHC * 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* i = static_cast<const int32_t*>(in);
  int32_t* s = static_cast<int32_t*>(scratch);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* f = static_cast<int32_t*>(flag);
  v_pass<true, false><<<(w + 31) / 32, dim3(32, kChunks), 0, st>>>(i, s, nullptr, h, w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (threads == 0) {
    if (win) {
      hwin_pass<<<cell_grid(h, w), 256, 0, st>>>(s, o, h, w, reach);
    } else {
      run_min_pass<true><<<(h + 7) / 8, dim3(kChunks, 8), 0, st>>>(s, o, nullptr, h, w);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    violations<true><<<cell_grid(h, w), 256, 0, st>>>(o, f, h, w);
    return static_cast<int>(cudaGetLastError());
  }
  static int set_to[2][16] = {};
  const unsigned n_bands = (h + band_rows - 1) / band_rows;
  if (win) {
    e = allow_smem(hwin_ring<true>, smem, set_to[1]);
    if (e != cudaSuccess) return static_cast<int>(e);
    hwin_ring<true><<<n_bands, threads, smem, st>>>(s, o, f, h, w, rows_per_step, band_rows, reach);
  } else {
    e = allow_smem(hwin_ring<false>, smem, set_to[0]);
    if (e != cudaSuccess) return static_cast<int>(e);
    hwin_ring<false><<<n_bands, threads, smem, st>>>(s, o, f, h, w, rows_per_step, band_rows, reach);
  }
  return static_cast<int>(cudaGetLastError());
}

// c, scratch, out: (hc, w) int32 packed coarse planes; `out` may be `c`,
// `scratch` aliases neither.  One coarse round on `stream`: the v-pass as
// two column scans (forward under bit 24 c -> scratch, backward under bit
// 25 in place on scratch, counting against c), then the h-pass scratch ->
// out.  changed: one int32, not `go`, zeroed by the forward column scan's
// first block (here, for an empty plane), which ends as the number of cells
// the v-pass and the h-pass changed.  status: [the forward scan's counter
// and tile flags, the backward scan's, the carries of one scan], 2 * (1 +
// n_tiles) + 2 * n_tiles * tile_cols int32 (ops/scan_merge.py vscan_plan),
// of which all but the carries are zeroed here.  go: null, or one int32
// (the previous round's `changed`) read by each of the round's three
// launches, which return at once when it is 0: such a round leaves the
// planes as they were and `changed` 0, so a round that reads it as its `go`
// stops too.  vec: as for rwt_fine_fwd_v (for c and scratch).  The row plan
// (ops/scan_merge.py row_plan with coarse=True): `threads` > 0 runs the ring
// row kernel, `threads` == 0 (rows wider than the ring) the chunked
// run-min.  Does not synchronise, returns cudaGetLastError().
extern "C" int rwt_coarse_round(const void* c, void* scratch, void* out, void* changed, const void* go, void* status,
                                int hc, int w, int vec, int rows_per_step, int band_rows, int threads, int smem,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* ch = static_cast<int32_t*>(changed);
  const int32_t* g = static_cast<const int32_t*>(go);
  const int tc = vec ? 128 : 32;
  const long long n_tiles = (long long)((hc + kTileRows - 1) / kTileRows) * ((w + tc - 1) / tc);
  if (n_tiles > 0x3fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(status, 0, (size_t)(2 + 2 * n_tiles) * sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (hc == 0 || w == 0) return static_cast<int>(cudaMemsetAsync(ch, 0, sizeof(int32_t), st));
  if (threads == 0) {
    if (w <= kRowCap) return static_cast<int>(cudaErrorInvalidValue);
  } else if (w > kRowCap || threads % 32 != 0 || threads > 1024 || rows_per_step < 1 || band_rows < 1 ||
             (long long)rows_per_step * w + 3 > (long long)threads * kCells ||
             smem != kRing * threads * kCells * 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* i = static_cast<const int32_t*>(c);
  int32_t* s = static_cast<int32_t*>(scratch);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* stat_f = static_cast<int32_t*>(status);
  int32_t* stat_b = stat_f + 1 + n_tiles;
  int32_t* carry = stat_b + 1 + n_tiles;
  e = vscan<true, true>(i, s, nullptr, stat_f, hc, w, vec, st, nullptr, carry, false, g, ch);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = vscan<true, false>(s, s, ch, stat_b, hc, w, vec, st, i, carry, false, g);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (threads == 0) {
    run_min_pass<true><<<(hc + 7) / 8, dim3(kChunks, 8), 0, st>>>(s, o, ch, hc, w, g);
    return static_cast<int>(cudaGetLastError());
  }
  e = ring_smem<true>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  row_ring<true><<<(hc + band_rows - 1) / band_rows, threads, smem, st>>>(s, o, ch, hc, w, rows_per_step, band_rows,
                                                                          g);
  return static_cast<int>(cudaGetLastError());
}
