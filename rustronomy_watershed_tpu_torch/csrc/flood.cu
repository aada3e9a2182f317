// Flood kernel: `steps` global Jacobi flood sweeps at one water level in one
// launch.
//
// Replaces the TPU kernel rustronomy_watershed_tpu/ops/pallas_flood.py
// `_flood_kernel` (launched by `flood_block`): P fused flood sweeps, the
// per-call "painted" flag and the last-sweep change flag that certifies the
// per-level fixed point, and the band activity vector (pallas_flood.py:18-24),
// here on 2-D tiles.  Not carried over: the per-band label ping-pong in
// device memory with its `cur` bitmap and the int8 image bias, which are
// layout devices of the TPU.
//
// Update of one cell at level `lvl` (ops/flood.py):
//   an uncoloured cell (label 0) with img <= lvl and a coloured 4-neighbour
//   takes the least coloured 4-neighbour label; every other cell keeps its
//   label.
// The caller gives the image with its border ring forced to NEVER_FILL (255
// > every water level), so border cells are never painted but still donate
// their labels, and the kernel needs no interior mask.  Cells outside the
// image read as uncoloured and never floodable.  In registers a label l is
// held as the unsigned l - 1, so "uncoloured" is 0xffffffff and the least
// coloured neighbour is a plain unsigned min of four.
//
// What bounds it: per call, one pass over the planes (5 B a cell in, 4 B
// out: 0.045 ms at 4096^2) and the integer work of the sweeps on chip.
// Design, the relax kernel's (csrc/relax.cu):
//   * register-blocked sweeps: a block is one warp wide and `warps` deep; a
//     thread holds a strip of 8 rows x 4 columns of labels in registers and
//     the floodable bits (img <= lvl) of its 32 cells in one 32-bit mask, so
//     a window is 128 columns x (8 * warps) rows.  Horizontal neighbours
//     across threads come by __shfl_sync, and only a strip's top and bottom
//     rows go through shared memory (int4 stores and loads, double-buffered
//     by sweep parity): one block barrier per sweep, which also votes the
//     previous sweep's change in the exact region (the early exit);
//   * Jacobi: a row's new values come from the old row above (kept aside),
//     the old row itself and the old row below, so one launch equals exactly
//     S global sweeps, bit for bit; sweep j is exact at distance >= j from
//     the window edge, so after S sweeps the centre tile (the window less S
//     cells on each side) is exact, and only the centre is written back;
//   * the flags count centre cells only: a centre cell at internal sweep j
//     equals global sweep j, so "the last sweep changed no centre cell in any
//     block" certifies the level's fixed point; painting is monotone (0 ->
//     label), so "some sweep changed a centre cell" is "the output differs
//     from the input";
//   * loads: labels as int4, the image as 16-byte groups whose floodable
//     bits a warp stages in shared memory (one 16-bit mask a group), from
//     which each thread takes its 4-bit slice per row;
//   * quiet tiles skip their sweeps (the reference's activity vector on 2-D
//     tiles): given the previous call's per-tile change bytes (`chg_prev`:
//     bit 0, some centre cell changed in some sweep; bit 1, in the last
//     sweep) and, on a level's first call, the per-tile presence bits of the
//     256 pixel values, a block runs its sweeps only when some tile of its
//     3 x 3 neighbourhood changed in the previous call's last sweep, or when
//     this is the level's first call and some tile of its neighbourhood
//     holds a pixel of value lvl.  Otherwise it returns before it loads
//     anything, unless its own tile changed in the previous call: then it
//     copies its centre from the source to the destination plane first.
// Why this is exact (with steps <= the tile edge, so that a call's
// dependency cone stays in the 3 x 3 neighbourhood; ops/flood_block.py
// flood_fixed_point_block says the same):
//   * a cell changes in a sweep only if a 4-neighbour changed in the sweep
//     before (it was uncoloured and floodable, and had no coloured
//     neighbour then), or, in the first sweep of a level, if it has the
//     level's value: at the previous level's fixed point no uncoloured cell
//     below lvl has a coloured neighbour (merging relabels coloured cells
//     and never changes which are coloured; levels with no pixel are not
//     run).  So a cell changed in sweep j of a call lies within j cells of
//     a cell changed in the previous call's last sweep, or on a first call
//     within j - 1 cells of a pixel of value lvl; a tile with neither in its
//     neighbourhood changes nothing, and its output is its input;
//   * the ping-pong: a tile that runs no sweeps must find its destination
//     (the previous call's source) equal to its source.  That holds unless
//     the tile changed in the previous call, and then it copies.  The
//     previous call's change bytes carry across the level boundary, and the
//     caller brings both planes in sync after it relabels one
//     (ops/level_driver.py).
// The launch plan (strip rows, warps, tiles, grid) comes from
// ops/flood_block.py flood_plan, which shares relax_plan's geometry.  The
// device code is not shared with relax.cu: the cells differ (a key, a label
// and a value byte there; a label and a mask bit here), and code shared by
// the fine and coarse column scans made them spill (scan_round.cu).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kR = 8;              // rows of a thread's strip
constexpr int kCols = 4;           // columns a thread owns
constexpr int kWinX = 32 * kCols;  // window width: one warp across
constexpr int kMaxThreads = 512;   // 16 warps
constexpr int kGroups = kWinX / 16 + 1;  // 16-byte image groups a window row spans
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // uncoloured, as label - 1

// Bit k (k = 0..3) of the result: byte k of `word` is <= the level in every
// byte of `lvl4`.
__device__ __forceinline__ uint32_t floodable4(uint32_t word, uint32_t lvl4) {
  return (((__vcmpleu4(word, lvl4) & 0x01010101u) * 0x01020408u) >> 24) & 15u;
}

// The block's centre tile from `src` to `dst` (int4 when vec and the tile's
// columns are whole 4-column groups: no store may reach a neighbour tile,
// which another block may be writing).
__device__ void copy_centre(const int32_t* __restrict__ src, int32_t* __restrict__ dst, int h, int w, int tile_y,
                            int tile_x, int vec) {
  const int y0 = blockIdx.y * tile_y, x0 = blockIdx.x * tile_x;
  const int rows = min(tile_y, h - y0), cols = min(tile_x, w - x0);
  if (vec && (x0 & 3) == 0 && (cols & 3) == 0) {
    const int c4 = cols >> 2;
    for (int i = threadIdx.x; i < rows * c4; i += blockDim.x) {
      const size_t g = (size_t)(y0 + i / c4) * w + x0 + 4 * (i % c4);
      *reinterpret_cast<int4*>(dst + g) = __ldg(reinterpret_cast<const int4*>(src + g));
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const size_t g = (size_t)(y0 + i / cols) * w + x0 + i % cols;
      dst[g] = src[g];
    }
  }
}

// Shared memory of one block: [sweep parity][warp][top, bottom][lane] int4
// rows, then [warp][kR * kGroups] image masks.
__global__ void __launch_bounds__(kMaxThreads, 1)
flood_kernel(const uint8_t* __restrict__ img, const int32_t* __restrict__ lab_in,
             int32_t* __restrict__ lab_out, int32_t* __restrict__ flags,
             const uint8_t* __restrict__ chg_prev, uint8_t* __restrict__ chg,
             const uint8_t* __restrict__ presence, int h, int w, int lvl, int steps,
             int first, int tile_y, int tile_x, int vec) {
  extern __shared__ int4 xrow[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int S = steps, WY = nw * kR;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;

  // The run rule, from the 3 x 3 neighbourhood of tiles.
  if (chg_prev != nullptr) {
    bool hot = false;
    if (threadIdx.x < 9) {
      const int ny = (int)blockIdx.y + (int)threadIdx.x / 3 - 1;
      const int nx = (int)blockIdx.x + (int)threadIdx.x % 3 - 1;
      if (ny >= 0 && ny < (int)gridDim.y && nx >= 0 && nx < (int)gridDim.x) {
        const int n = ny * gridDim.x + nx;
        hot = (chg_prev[n] & 2) || (first && ((presence[n * 32 + (lvl >> 3)] >> (lvl & 7)) & 1));
      }
    }
    if (!__syncthreads_or(hot)) {
      const bool stale = chg_prev[tile] & 1;
      if (stale) copy_centre(lab_in, lab_out, h, w, tile_y, tile_x, vec);
      if (threadIdx.x == 0) {
        chg[tile] = 0;
        atomicAdd(flags + 2, 1);
        if (stale) atomicAdd(flags + 3, 1);
      }
      return;
    }
  }

  // The strip: plane rows y0 .. y0+kR-1, columns x0 .. x0+3.
  const int xw = lane * kCols;
  const int wx0 = (int)blockIdx.x * tile_x - S;  // the window's first column
  const int y0 = (int)blockIdx.y * tile_y - S + wid * kR;
  const int x0 = wx0 + xw;
  const uint32_t lvl4 = 0x01010101u * (uint32_t)lvl;

  // The floodable mask: bit 4r + j for row r, column j of the strip.
  uint32_t fl = 0;
  if (vec) {
    // w % 16 == 0 and a 16-byte aligned image: a group lies wholly inside
    // or wholly outside the image.  The warp loads the kGroups groups of
    // each of its kR rows, starting at the 16-byte line at or before wx0.
    uint32_t* im = reinterpret_cast<uint32_t*>(xrow + 2 * nw * 2 * 32) + wid * kR * kGroups;
    const int a0 = wx0 & ~15;
    for (int slot = lane; slot < kR * kGroups; slot += 32) {
      const int r = slot / kGroups, g = slot % kGroups;
      const int gy = y0 + r, gx = a0 + 16 * g;
      uint32_t m = 0;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(img + (size_t)gy * w + gx));
        m = floodable4(q.x, lvl4) | floodable4(q.y, lvl4) << 4 | floodable4(q.z, lvl4) << 8 |
            floodable4(q.w, lvl4) << 12;
      }
      im[slot] = m;
    }
    __syncwarp();
    const int o = wx0 - a0 + xw, g = o >> 4, sh = o & 15;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const uint32_t lo = im[r * kGroups + g];
      const uint32_t hi = g + 1 < kGroups ? im[r * kGroups + g + 1] : 0u;
      fl |= (((lo | hi << 16) >> sh) & 15u) << (4 * r);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int gy = y0 + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int gx = x0 + j;
        if (gy >= 0 && gy < h && gx >= 0 && gx < w && img[(size_t)gy * w + gx] <= lvl) fl |= 1u << (4 * r + j);
      }
    }
  }

  const bool vec_x = vec && x0 >= 0 && x0 < w && (x0 & 3) == 0;
  unsigned u[kR][kCols];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int gy = y0 + r;
    const bool row_in = gy >= 0 && gy < h;
    if (row_in && vec_x) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(lab_in + (size_t)gy * w + x0));
      u[r][0] = (unsigned)a.x - 1u; u[r][1] = (unsigned)a.y - 1u;
      u[r][2] = (unsigned)a.z - 1u; u[r][3] = (unsigned)a.w - 1u;
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int gx = x0 + j;
        u[r][j] = (row_in && gx >= 0 && gx < w) ? (unsigned)lab_in[(size_t)gy * w + gx] - 1u : kNone;
      }
    }
  }

  unsigned ctr_col[kCols];  // all ones where the column lies in the centre
#pragma unroll
  for (int j = 0; j < kCols; ++j) ctr_col[j] = (xw + j >= S && xw + j < kWinX - S) ? kFull : 0u;
  bool any_c = false, last_c = false, reg_c = true;
  for (int s = 1; s <= S; ++s) {
    int4* xb = xrow + ((s & 1) * nw + wid) * 2 * 32 + lane;
    xb[0] = make_int4((int)u[0][0], (int)u[0][1], (int)u[0][2], (int)u[0][3]);
    xb[32] = make_int4((int)u[kR - 1][0], (int)u[kR - 1][1], (int)u[kR - 1][2], (int)u[kR - 1][3]);
    // Publishes the rows and votes the previous sweep: when it changed
    // nothing in its exact region, later sweeps are the identity there.
    if (!__syncthreads_or(reg_c)) break;

    unsigned pu[kCols];  // the old row above (outside the window: uncoloured)
    if (wid > 0) {
      const int4 a = xb[-32];
      pu[0] = (unsigned)a.x; pu[1] = (unsigned)a.y; pu[2] = (unsigned)a.z; pu[3] = (unsigned)a.w;
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) pu[j] = kNone;
    }
    // Rows of this sweep's exact region count every column (a superset of
    // the region, so a quiet vote still proves it quiet); the centre, which
    // sets the flags, is counted exactly.
    unsigned reg = 0, ctr = 0;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      unsigned du[kCols];  // the old row below
      if (r + 1 < kR) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) du[j] = u[r + 1][j];
      } else if (wid + 1 < nw) {
        const int4 a = xb[64];
        du[0] = (unsigned)a.x; du[1] = (unsigned)a.y; du[2] = (unsigned)a.z; du[3] = (unsigned)a.w;
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) du[j] = kNone;
      }
      unsigned ol = __shfl_up_sync(kFull, u[r][kCols - 1], 1);  // the old left neighbour
      unsigned rr3 = __shfl_down_sync(kFull, u[r][0], 1);
      if (lane == 0) ol = kNone;
      if (lane == 31) rr3 = kNone;
      unsigned ed = 0, cd = 0;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const unsigned old = u[r][j];
        const unsigned rn = j < kCols - 1 ? u[r][j + 1] : rr3;
        const unsigned m = __vimin3_u32(pu[j], du[j], min(ol, rn));
        const unsigned nv = (old == kNone && ((fl >> (4 * r + j)) & 1u)) ? m : old;
        const unsigned d = nv ^ old;
        ed |= d;
        cd |= d & ctr_col[j];
        pu[j] = ol = old;
        u[r][j] = nv;
      }
      const int yy = wid * kR + r;
      if (yy >= s && yy < WY - s) reg |= ed;
      if (yy >= S && yy < WY - S) ctr |= cd;
    }
    reg_c = reg != 0;
    last_c = ctr != 0;
    any_c |= last_c;
  }

  // Write back the centre.
  const bool vec_c = vec_x && xw >= S && xw + kCols <= kWinX - S && x0 + kCols <= w;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int yy = wid * kR + r, gy = y0 + r;
    if (yy < S || yy >= WY - S || gy >= h) continue;
    if (vec_c) {
      *reinterpret_cast<int4*>(lab_out + (size_t)gy * w + x0) =
          make_int4((int)(u[r][0] + 1u), (int)(u[r][1] + 1u), (int)(u[r][2] + 1u), (int)(u[r][3] + 1u));
      continue;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int gx = x0 + j;
      if (xw + j < S || xw + j >= kWinX - S || gx >= w) continue;
      lab_out[(size_t)gy * w + gx] = (int)(u[r][j] + 1u);
    }
  }
  // The block's flags by two block votes.  (A warp vote folded into a
  // shared-memory atomicOr, relax.cu's form, compiled here to an atomic
  // that was skipped when both flags were set: nvcc 12.9, sm_90a.)
  const bool blk_any = __syncthreads_or(any_c) != 0;
  const bool blk_last = __syncthreads_or(last_c) != 0;
  if (threadIdx.x == 0) {
    if (blk_any) atomicOr(flags + 0, 1);
    if (blk_last) atomicOr(flags + 1, 1);
    if (chg != nullptr) chg[tile] = (blk_any ? 1 : 0) | (blk_last ? 2 : 0);
  }
}

}  // namespace

// img: (h, w) u8 with its border ring at 255; lab_in -> lab_out: (h, w)
// int32 (the output must not alias the input); flags: int32 [painted,
// not_converged, tiles that ran no sweeps, of them the tiles copied],
// written here.  The launch plan
// (ops/flood_block.py flood_plan): `threads` = 32 * warps threads in strips
// of `rows` (8) rows, centre tiles of tile_y x tile_x = (8 * warps -
// 2 * steps) x (128 - 2 * steps), a (grid_y, grid_x) grid, `smem` bytes.
// Tile state, one byte per tile: chg (may be null) gets bit 0 when a centre
// cell changed in some sweep and bit 1 when one changed in the last sweep
// (0 for a tile that ran no sweeps); chg_prev (may be null: every tile
// runs) is the previous call's chg; presence (32 bytes a tile, bit v: the
// tile holds a pixel of value v) is read on a `first` call of a level.
// vec: w % 16 == 0 and the planes 16-byte aligned.  Launches on `stream`,
// does not synchronise, returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan that does not cover the plane or that
// the kernel does not take.
extern "C" int rwt_flood(const void* img, const void* lab_in, void* lab_out, void* flags, const void* chg_prev,
                         void* chg, const void* presence, int h, int w, int lvl, int steps, int first, int rows,
                         int threads, int tile_y, int tile_x, int grid_y, int grid_x, int smem, int vec,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps = threads / 32;
  if (rows != kR || threads % 32 != 0 || threads < 32 || threads > kMaxThreads || steps < 1 || lvl < 0 ||
      lvl > 255 || tile_x != kWinX - 2 * steps || tile_y != warps * kR - 2 * steps || tile_x < 1 || tile_y < 1 ||
      grid_x < 1 || grid_y < 1 || grid_y > 65535 || (long long)grid_x * tile_x < w ||
      (long long)grid_y * tile_y < h || smem < (int)((2 * warps * 2 * 32) * sizeof(int4) + warps * kR * kGroups * 4) ||
      (chg_prev != nullptr && chg == nullptr) || (first && chg_prev != nullptr && presence == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(flags, 0, 4 * sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (h == 0 || w == 0) return 0;
  e = cudaFuncSetAttribute(flood_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flood_kernel<<<dim3(grid_x, grid_y), threads, smem, st>>>(
      static_cast<const uint8_t*>(img), static_cast<const int32_t*>(lab_in), static_cast<int32_t*>(lab_out),
      static_cast<int32_t*>(flags), static_cast<const uint8_t*>(chg_prev), static_cast<uint8_t*>(chg),
      static_cast<const uint8_t*>(presence), h, w, lvl, steps, first, tile_y, tile_x, vec);
  return static_cast<int>(cudaGetLastError());
}
