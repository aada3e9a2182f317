// Native host oracle of the reference watershed semantics.
//
// Independent C++ implementation of the behaviour documented in SURVEY.md §3
// (reference src/lib.rs:1328-1522) under the pinned deterministic
// plateau tie-break (min coloured 4-neighbour label, SURVEY.md Q2/Q9).  Used
// by the parity harness to cross-check the TPU kernels at sizes where the
// NumPy oracle is too slow, and as a fast host fallback engine.
//
// Semantics:
//   * level loop 0..=max_water_level,
//   * per level, sweep-synchronised Jacobi colouring: candidates are
//     interior, uncoloured, img <= lvl, with >= 1 coloured 4-neighbour; the
//     painted colour is the min 4-neighbour label read from the sweep-start
//     snapshot (epoch-tagged paints avoid copying the plane per sweep),
//   * merging variant: after each level's fixed point, transitively merge
//     all 4-adjacent differing coloured labels (interior centres), min label
//     wins, applied to the plane via a LUT.
//
// Build: g++ -O3 -shared -fPIC (see parity/native.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int64_t> parent;
  explicit UnionFind(int64_t n) : parent(n) {
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
  }
  int64_t find(int64_t a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];
      a = parent[a];
    }
    return a;
  }
  void union_min(int64_t a, int64_t b) {
    int64_t ra = find(a), rb = find(b);
    if (ra == rb) return;
    if (ra < rb)
      parent[rb] = ra;
    else
      parent[ra] = rb;
  }
};

}  // namespace

extern "C" {

// Full transform.  img: (h*w) u8 row-major.  labels: (h*w) int64, seeds
// pre-painted by the caller (colours 1..K), output written in place.
// If sizes_out != nullptr it must hold (max_lvl+1) * (n_labels+1) int64 and
// receives the per-level lake-size histogram.  Returns 0 on success.
int watershed_oracle(const uint8_t* img, int64_t h, int64_t w,
                     int64_t* labels, int64_t n_labels, int max_lvl,
                     int merging, int64_t* sizes_out) {
  const int64_t n = h * w;
  std::vector<int32_t> epoch(n, 0);   // sweep index at which a pixel was painted
  std::vector<int64_t> frontier;      // pixels painted in the previous sweep
  std::vector<int64_t> scratch;
  frontier.reserve(1 << 16);
  scratch.reserve(1 << 16);

  auto idx = [w](int64_t y, int64_t x) { return y * w + x; };
  int32_t sweep = 0;

  for (int lvl = 0; lvl <= max_lvl; ++lvl) {
    // Level-start frontier: every coloured pixel (cheap and always correct;
    // the sweep loop below immediately narrows to painted pixels).
    frontier.clear();
    for (int64_t i = 0; i < n; ++i)
      if (labels[i] != 0) frontier.push_back(i);

    // Jacobi sweeps to the fixed point.
    while (!frontier.empty()) {
      ++sweep;
      scratch.clear();
      // Phase 1: collect unique candidates adjacent to the frontier.
      for (int64_t f : frontier) {
        const int64_t y = f / w, x = f % w;
        const int64_t nb[4] = {f - w, f + w, f - 1, f + 1};
        const bool ok[4] = {y > 0, y < h - 1, x > 0, x < w - 1};
        for (int k = 0; k < 4; ++k) {
          if (!ok[k]) continue;
          const int64_t c = nb[k];
          const int64_t cy = c / w, cx = c % w;
          if (cy == 0 || cy == h - 1 || cx == 0 || cx == w - 1) continue;
          if (labels[c] != 0 || img[c] > lvl) continue;
          if (epoch[c] == -1) continue;  // already queued this sweep
          epoch[c] = -1;
          scratch.push_back(c);
        }
      }
      // Phase 2: paint each candidate with the min neighbour label coloured
      // before this sweep (epoch < current), reproducing snapshot reads.
      frontier.clear();
      for (int64_t c : scratch) {
        const int64_t y = c / w, x = c % w;
        int64_t best = INT64_MAX;
        const int64_t nb[4] = {c - w, c + w, c - 1, c + 1};
        const bool ok[4] = {y > 0, y < h - 1, x > 0, x < w - 1};
        for (int k = 0; k < 4; ++k) {
          if (!ok[k]) continue;
          const int64_t q = nb[k];
          if (labels[q] != 0 && epoch[q] < sweep && labels[q] < best)
            best = labels[q];
        }
        epoch[c] = 0;
        if (best != INT64_MAX) {
          labels[c] = best;
          epoch[c] = sweep;
          frontier.push_back(c);
        }
      }
    }

    if (merging) {
      UnionFind uf(n_labels + 1);
      bool any = false;
      for (int64_t y = 1; y < h - 1; ++y)
        for (int64_t x = 1; x < w - 1; ++x) {
          const int64_t c = labels[idx(y, x)];
          if (c == 0) continue;
          const int64_t r = labels[idx(y, x + 1)];
          const int64_t d = labels[idx(y + 1, x)];
          const int64_t l = labels[idx(y, x - 1)];
          const int64_t u = labels[idx(y - 1, x)];
          if (r != 0 && r != c) uf.union_min(c, r), any = true;
          if (d != 0 && d != c) uf.union_min(c, d), any = true;
          if (l != 0 && l != c) uf.union_min(c, l), any = true;
          if (u != 0 && u != c) uf.union_min(c, u), any = true;
        }
      if (any) {
        std::vector<int64_t> lut(n_labels + 1);
        for (int64_t i = 0; i <= n_labels; ++i) lut[i] = uf.find(i);
        for (int64_t i = 0; i < n; ++i) labels[i] = lut[labels[i]];
      }
    }

    if (sizes_out != nullptr) {
      int64_t* row = sizes_out + (int64_t)lvl * (n_labels + 1);
      std::memset(row, 0, sizeof(int64_t) * (n_labels + 1));
      for (int64_t i = 0; i < n; ++i) ++row[labels[i]];
    }
  }
  return 0;
}

// transform_to_list (merging) host tail in one native pass: cumulative
// segmenting counts + per-level Kruskal union (min-label representative,
// SURVEY.md Q9) + redistribution onto representatives.  Replaces the
// NumPy host_cumulative_counts + merged_sizes_host pair (bit-identical
// integer arithmetic; pinned by tests/test_merge_fast.py) — the Python
// tail dominated the public entry point (r6: union 0.55 s + counts 0.24 s
// at 1024²/254 levels).
//
//   labels: (npx) int32 final SEGMENTING labels (claimed-ness gate => label
//           0 iff unclaimed)
//   lv8:    (npx) uint8 claim levels clipped to [0, levels] (value ==
//           levels marks never-claimed)
//   k1:     label-table size (n_labels + 1)
//   levels: max_water_level + 1
//   lo/hi/act: (n_edges) int32 deduplicated merge edges + activation level
//           (act <= max_water_level by construction, ops/merge_curve.py)
//   out:    (levels * out_width) int64.  Rows are `out_width` wide: the
//           caller's requested counts_length (reference rows are n_pixels+1
//           long, src/lib.rs:630; compact callers pass K+1).  Representatives
//           >= out_width are dropped (the truncation _expand_rows applied);
//           columns in [k1, out_width) are NEVER written — the caller
//           provides a zeroed buffer (np.zeros is calloc-lazy, so the
//           untouched tail costs no memory traffic).
int merged_curve_oracle(const int32_t* labels, const uint8_t* lv8,
                        int64_t npx, int64_t k1, int levels,
                        const int32_t* lo, const int32_t* hi,
                        const int32_t* act, int64_t n_edges, int64_t* out,
                        int64_t out_width) {
  // Counting-sort pixel labels by claim level so each level's count delta
  // streams exactly once (no (levels+1) x k1 counts table).
  std::vector<int64_t> off(levels + 2, 0);
  for (int64_t i = 0; i < npx; ++i) ++off[(int64_t)lv8[i] + 1];
  for (int64_t l = 1; l <= levels + 1; ++l) off[l] += off[l - 1];
  std::vector<int32_t> bucketed(npx);
  {
    std::vector<int64_t> cur(off.begin(), off.end() - 1);
    for (int64_t i = 0; i < npx; ++i) bucketed[cur[lv8[i]]++] = labels[i];
  }
  // Counting-sort edge indices by activation level.
  std::vector<int64_t> eoff(levels + 1, 0);
  for (int64_t e = 0; e < n_edges; ++e) ++eoff[act[e] + 1];
  for (int64_t l = 1; l <= levels; ++l) eoff[l] += eoff[l - 1];
  std::vector<int64_t> ebkt(n_edges);
  {
    std::vector<int64_t> cur(eoff.begin(), eoff.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e) ebkt[cur[act[e]]++] = e;
  }

  // Incremental per-root sums: claims add to the CURRENT root of their
  // label, unions move the losing root's whole sum onto the winner.  A
  // level's output row is then a straight memcpy of rootsum — the old
  // per-level redistribution (levels * k1 union-find lookups + a full-row
  // memset) measured ~0.7 s at 1024^2/131k labels; this is one find per
  // PIXEL (npx total) plus levels memcpys.
  UnionFind uf(k1);
  std::vector<int64_t> rootsum(k1, 0);
  int64_t claimed = 0;
  const int64_t copy_w = k1 < out_width ? k1 : out_width;
  for (int lvl = 0; lvl < levels; ++lvl) {
    for (int64_t i = off[lvl]; i < off[lvl + 1]; ++i) {
      const int32_t lab = bucketed[i];
      if (lab != 0) {  // claimed <=> label nonzero; column 0 is recomputed
        ++rootsum[uf.find(lab)];
        ++claimed;
      }
    }
    for (int64_t i = eoff[lvl]; i < eoff[lvl + 1]; ++i) {
      const int64_t e = ebkt[i];
      const int64_t ra = uf.find(lo[e]), rb = uf.find(hi[e]);
      if (ra == rb) continue;
      const int64_t win = ra < rb ? ra : rb, lose = ra < rb ? rb : ra;
      uf.parent[lose] = win;
      rootsum[win] += rootsum[lose];
      rootsum[lose] = 0;
    }
    int64_t* row = out + (int64_t)lvl * out_width;
    std::memcpy(row, rootsum.data(), sizeof(int64_t) * copy_w);
    row[0] = npx - claimed;
  }
  return 0;
}

// Reference find_local_minima (strict local maxima by code, Q1): writes a
// 0/1 mask; caller extracts row-major coordinates.
int local_extrema_oracle(const uint8_t* img, int64_t h, int64_t w,
                         uint8_t* mask) {
  std::memset(mask, 0, (size_t)(h * w));
  for (int64_t y = 1; y < h - 1; ++y)
    for (int64_t x = 1; x < w - 1; ++x) {
      const uint8_t c = img[y * w + x];
      bool all_less = true;
      for (int64_t dy = -1; dy <= 1 && all_less; ++dy)
        for (int64_t dx = -1; dx <= 1; ++dx) {
          if (dy == 0 && dx == 0) continue;
          if (img[(y + dy) * w + (x + dx)] >= c) {
            all_less = false;
            break;
          }
        }
      if (all_less) mask[y * w + x] = 1;
    }
  return 0;
}

}  // extern "C"
