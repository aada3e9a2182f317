// Scan-round kernels: the passes of the component-min rounds, on the fine
// label plane or on the packed coarse plane.
//
// Replaces five TPU kernels of rustronomy_watershed_tpu/ops/scan_merge.py:
//   * `_fwd_v_kernel` / `_bwd_vh_kernel`, the fine tail (launched by
//     `_call_round_kernel` from `_component_min_pallas` and
//     `component_min_from_padded`), and their coarse mirrors
//     `_cfwd_v_kernel` / `_cbwd_vh_kernel`, the legacy rounds of
//     `component_min_coarse_from_padded` (RWT_COARSE_MULTI=0):
//       - rwt_scan_fwd_v: the forward vertical segmented min scan; its flag
//         is "some cell changed";
//       - rwt_scan_bwd_vh: the backward vertical scan (in -> scratch), the
//         horizontal run-min (scratch -> out), full length, or for the
//         coarse plane windowed as the TPU's lane doubling with a limit is
//         (a cell reaches `reach` = 2^ceil(log2(limit)) - 1 cells each way
//         within its run, not limit - 1), then the violation stencil over
//         `out`: its flag is "some unblocked claimed neighbour pair
//         differs", which certifies the fixed point (scan_merge.py:231-238);
//         a clean forward pass does not;
//   * `_cmulti_kernel` (launched by `_call_multi_kernel`), the default coarse
//     round: a sequential band grid with Gauss-Seidel chaining, k = 2
//     sub-iterations per band and a 256-lane h window, all of it tuning for
//     one TPU core walking bands in order.  Blocks on Hopper run in no
//     order, so rwt_coarse_round is a full-length run-min of every column
//     (plane -> scratch), then of every row (scratch -> out), counting the
//     cells that changed; the host stops after a round that changed none
//     (the change-based certificate of scan_merge.py:1114-1128).
// The bodies differ only in the cell encoding, so one template serves them:
//   * fine: a cell is a label, 0 = unclaimed = a scan barrier in every
//     direction; the vertical passes leave border columns 0 and w-1 as they
//     were, the horizontal pass leaves border rows 0 and h-1 as they were
//     (border-border edges never merge);
//   * coarse: a cell is the packed plane of ops/scan_merge.py (value bits
//     0..23, 0 = empty; reset bits 24..27 for forward / backward, vertical /
//     horizontal), the reset bits are kept on write.
// The TPU kernels walk bands in order with a carry row; here every launch
// reads one whole plane and writes another, so blocks need no order and each
// launch equals its plain twin (ops/scan_merge.py) bit for bit.
//
// What bounds it: bytes.  A pass reads a plane and writes one (4 B per cell
// each way); the violation stencil reads it once more.  Design of a scan
// launch: a block owns 32 columns or 8 rows; each line is cut into 32
// chunks, one thread per chunk, so a 16384-row plane still has 16 threads
// per column.  A thread folds its chunk into a (value, reset-seen)
// aggregate, one thread per line chains the aggregates into each chunk's
// carry (shared memory), and the thread rescans its chunk from that carry;
// a backward scan after a forward one reads the forward values back from
// `out`.  Vertical launches are coalesced (a warp reads 32 neighbouring
// columns); horizontal ones walk rows at a stride and lean on L1.  The
// windowed scan walks at most `reach` cells each way from each cell.  Speed
// work (shared-memory row tiles for the h-pass, fusing the stencil into it,
// skipping quiet lines, fewer rounds) is left for later.

#include <cstdint>
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

// The full-length run-min of every column (kV) or row: a forward scan under
// the forward resets into `out`, then a backward scan of that under the
// backward resets (the run-min, as the TPU's min of two independent scans
// is).  in -> out, which must not alias.  Fine border lines keep their
// cells.  `changed` (may be null) gets the number of cells whose value
// changed.  A block owns 32 columns (a warp reads 32 neighbouring columns,
// coalesced) or 8 rows (a warp covers the 32 chunks of one row, at a
// stride).
template <bool kCoarse, bool kV>
__global__ void __launch_bounds__(kV ? 1024 : 256)
run_min_pass(const int32_t* __restrict__ in, int32_t* __restrict__ out,
             int32_t* changed, int h, int w) {
  constexpr int kLines = kV ? 32 : 8;
  constexpr int kFwd = kV ? kVf : kHf, kBwd = kFwd + 1;
  __shared__ int agg_v[kLines][kChunks + 1];
  __shared__ int agg_r[kLines][kChunks + 1];
  __shared__ int carry[kLines][kChunks + 1];
  const int li = kV ? threadIdx.x : threadIdx.y;  // line within the block
  const int ck = kV ? threadIdx.y : threadIdx.x;  // chunk within the line
  const int n = kV ? h : w, n_lines = kV ? w : h;
  const int line = blockIdx.x * kLines + li;
  const int len = (n + kChunks - 1) / kChunks;
  const int s = min(n, ck * len), e = min(n, s + len);
  const bool live = line < n_lines;
  const bool keep = !kCoarse && (line == 0 || line == n_lines - 1);
  const size_t base = kV ? (size_t)line : (size_t)line * w;
  const size_t stride = kV ? (size_t)w : 1;

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

// The windowed horizontal pass of the coarse plane: each cell takes the min
// of a forward scan reaching at most `reach` cells back and a backward scan
// reaching at most `reach` cells ahead, each stopping after the first cell
// that resets it.  in -> out, which must not alias.
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

dim3 cell_grid(int h, int w) {
  return dim3((w + 255) / 256, h < 4096 ? h : 4096);
}

template <bool kCoarse>
int fwd_v(const int32_t* in, int32_t* out, int32_t* flag, int h, int w,
          cudaStream_t st) {
  v_pass<kCoarse, true><<<(w + 31) / 32, dim3(32, kChunks), 0, st>>>(
      in, out, flag, h, w);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCoarse>
int bwd_vh(const int32_t* in, int32_t* scratch, int32_t* out, int32_t* flag,
           int h, int w, int reach, cudaStream_t st) {
  v_pass<kCoarse, false><<<(w + 31) / 32, dim3(32, kChunks), 0, st>>>(
      in, scratch, nullptr, h, w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (kCoarse && reach >= 0 && reach < w - 1) {
    hwin_pass<<<cell_grid(h, w), 256, 0, st>>>(scratch, out, h, w, reach);
  } else {
    run_min_pass<kCoarse, false><<<(h + 7) / 8, dim3(kChunks, 8), 0, st>>>(
        scratch, out, nullptr, h, w);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  violations<kCoarse><<<cell_grid(h, w), 256, 0, st>>>(out, flag, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in, out: (h, w) int32 planes, fine labels (coarse == 0) or packed coarse
// cells (coarse != 0); `out` may be `in`.  flag: one int32, zeroed here, then
// 1 when some cell changed.  Launches on `stream`, does not synchronise,
// returns cudaGetLastError().
extern "C" int rwt_scan_fwd_v(const void* in, void* out, void* flag, int h,
                              int w, int coarse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (h == 0 || w == 0) return 0;
  const int32_t* i = static_cast<const int32_t*>(in);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* f = static_cast<int32_t*>(flag);
  return coarse ? fwd_v<true>(i, o, f, h, w, st) : fwd_v<false>(i, o, f, h, w, st);
}

// in, scratch, out: (h, w) int32 planes as above; `out` may be `in`,
// `scratch` aliases neither.  reach: the coarse horizontal window (cells
// each way), or < 0 for full length; the fine pass ignores it.  flag: one
// int32, zeroed here, then 1 when the output violates the fixed point.
// Launches three kernels on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int rwt_scan_bwd_vh(const void* in, void* scratch, void* out,
                               void* flag, int h, int w, int coarse, int reach,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (h == 0 || w == 0) return 0;
  const int32_t* i = static_cast<const int32_t*>(in);
  int32_t* s = static_cast<int32_t*>(scratch);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* f = static_cast<int32_t*>(flag);
  return coarse ? bwd_vh<true>(i, s, o, f, h, w, reach, st)
                : bwd_vh<false>(i, s, o, f, h, w, reach, st);
}

// c, scratch, out: (hc, w) int32 packed coarse planes; `out` may be `c`,
// `scratch` aliases neither.  changed: one int32, zeroed here, then the
// number of cells the v-pass and the h-pass changed.  One coarse round:
// both passes, on `stream`; does not synchronise, returns
// cudaGetLastError().
extern "C" int rwt_coarse_round(const void* c, void* scratch, void* out,
                                void* changed, int hc, int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(changed, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (hc == 0 || w == 0) return 0;
  int32_t* ch = static_cast<int32_t*>(changed);
  run_min_pass<true, true><<<(w + 31) / 32, dim3(32, kChunks), 0, st>>>(
      static_cast<const int32_t*>(c), static_cast<int32_t*>(scratch), ch, hc, w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  run_min_pass<true, false><<<(hc + 7) / 8, dim3(kChunks, 8), 0, st>>>(
      static_cast<const int32_t*>(scratch), static_cast<int32_t*>(out), ch, hc, w);
  return static_cast<int>(cudaGetLastError());
}
