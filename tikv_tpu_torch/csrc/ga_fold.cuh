// The tile walk and fold of the grouped partials kernels.
//
// Shared by fused_group_agg_partials (fused_agg.cu: one plan over one image,
// the GaParams block in the kernel's parameters) and batch_partials
// (fused_batch.cu: the tasks of a batch, each BtTask copied into shared
// memory); the functions take any block with the leaf tables:
//   * each thread walks R consecutive rows of one block at a time (the tile
//     walk of fa_walk.cuh: the stack in registers, no local memory; the
//     instance's D stack slots are the launcher's pick from the plan's
//     depth), the tiles of the image in a grid stride; a tile never
//     straddles two blocks, and tile u goes to CTA (u mod n_ctas * THREADS)
//     / THREADS (copr/fused_group_agg.py:partials_plain follows it);
//   * the tile's group ids are loaded once a tile before the walk: host ids
//     (R int32 in one load where aligned) or the mixed radix of the key
//     columns' dictionary codes (jax_eval._mixed_radix_gids); a row whose id
//     lies outside [0, C) takes no part;
//   * the walk hands each aggregate's argument to the fold in registers:
//       - one group (no key, no host ids): each lane folds its rows in order
//         into its own column of `stage`; at the end the lanes fold in lane
//         order into the warp's row;
//       - integer leaves (count, int64 sum, the bit operations, min, max,
//         first's row): a shared-memory atomic a row into the warp's row of
//         its id (ga_row_atomic), in no order that matters;
//       - f64 leaves (sum, sum of squares, min, max) per row of the tile:
//         the lanes that share an id (__match_any_sync) are folded in lane
//         order by their lowest lane into the warp's row, staged in
//         `stage`, so that the order depends on the shapes alone;
//   * the tracker (GROUP BY's first row): per row of the tile, the lowest
//     lane of each id keeps its row with a plain store.
// At the end the warps' rows fold in warp order into one row of partials
// per CTA, [n_leaves, C] int64 words.
// first's value (GA_FIRSTVAL) is not folded: the combine reads it at the
// winning row.
//
// Shared memory a CTA: `stage` [warps][L][32] then the rows [warps][L][C],
// int64 words.  The wide route (group_wide_partials of fused_agg.cu) walks
// the same tiles, takes its rows' ids from ga_tile_ids and folds into one
// state in device memory.

#pragma once

#include "fa_walk.cuh"
#include "ga_leaf.cuh"

// Leaf l's integer word at `w` (shared memory) merged with v by a
// shared-memory atomic, for the kinds a warp does not reduce itself: a
// 64-bit add as two 32-bit ones (the low half's carry into the high half),
// the bit operations a 32-bit half at a time, min and max (first's row
// among them) once a plain read says v wins (the word only moves v's way).
// The 32-bit operations name the shared window's address, so they are the
// shared-memory atomic unit's whatever the compiler infers of `w`.
__device__ __forceinline__ void ga_row_atomic(int kind, long long* w, long long v) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(w);
  const unsigned lo = (unsigned)(u64)v, hi = (unsigned)((u64)v >> 32);
  switch (kind) {
    case GA_COUNT:
    case GA_SUM: {
      unsigned old;
      asm volatile("atom.shared.add.u32 %0, [%1], %2;" : "=r"(old) : "r"(a), "r"(lo) : "memory");
      const unsigned up = hi + (old + lo < old ? 1u : 0u);
      asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(a + 4), "r"(up) : "memory");
      break;
    }
    case GA_AND:
      if (lo != ~0u) asm volatile("red.shared.and.b32 [%0], %1;" ::"r"(a), "r"(lo) : "memory");
      if (hi != ~0u) asm volatile("red.shared.and.b32 [%0], %1;" ::"r"(a + 4), "r"(hi) : "memory");
      break;
    case GA_OR:
      if (lo != 0) asm volatile("red.shared.or.b32 [%0], %1;" ::"r"(a), "r"(lo) : "memory");
      if (hi != 0) asm volatile("red.shared.or.b32 [%0], %1;" ::"r"(a + 4), "r"(hi) : "memory");
      break;
    case GA_XOR:
      if (lo != 0) asm volatile("red.shared.xor.b32 [%0], %1;" ::"r"(a), "r"(lo) : "memory");
      if (hi != 0) asm volatile("red.shared.xor.b32 [%0], %1;" ::"r"(a + 4), "r"(hi) : "memory");
      break;
    case GA_MAX:
      if (v > *w) atomicMax(w, v);
      break;
    default:  // GA_MIN, GA_FIRSTROW
      if (v < *w) atomicMin(w, v);
      break;
  }
}

// The group ids of the tile at flat row f0 (rows i0 .. i0 + n of block
// blk) into gid: host ids `gids` [n_blocks, block_rows] (R int32 in one load
// where aligned), or, with none, the mixed radix of the key columns'
// dictionary codes (jax_eval._mixed_radix_gids; no key: slot 0).  Returns
// the rows whose id lies in [0, C), as bits: a row whose id is outside the
// slots touches none, as XLA drops out-of-range scatter updates.
template <int R, class P>
__device__ __forceinline__ unsigned ga_tile_ids(const P& p, const int* gids, long long f0,
                                                long long blk, long long i0, int n,
                                                int (&gid)[R]) {
  long long g[R];
  if (gids != nullptr) {
    fa_lanes<R>(gids + f0, n, g);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) g[r] = 0;
    for (int q = 0; q < p.n_keys; ++q) {
      long long x[R];
      unsigned xn;
      fa_load_tile<R>(p, p.key_slot[q], f0, blk, i0, n, x, xn);
      const long long dlen = p.key_dlen[q];
#pragma unroll
      for (int r = 0; r < R; ++r) g[r] = g[r] * (dlen + 1) + ((xn >> r) & 1 ? dlen : x[r]);
    }
  }
  unsigned ok = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool in = g[r] >= 0 && g[r] < p.capacity;
    gid[r] = in ? (int)g[r] : 0;
    ok |= (unsigned)in << r;
  }
  return ok;
}

// The CTA's rows [warps][L][C] at their leaves' identities and, with no
// group key, each lane's column of `stage`.  The caller syncs.
template <int THREADS, class P>
__device__ __forceinline__ void ga_rows_init(const P& p, long long* stage, long long* wrows,
                                             bool keyed) {
  const int L = p.n_leaves;
  const int C = p.capacity;
  const long long words = (long long)(THREADS / 32) * L * C;
  for (long long idx = threadIdx.x; idx < words; idx += THREADS) {
    wrows[idx] = p.leaf_ident[(idx / C) % L];
  }
  if (!keyed) {
    const int lane = threadIdx.x & 31;
    for (int l = 0; l < L; ++l) stage[l * 32 + lane] = p.leaf_ident[l];
  }
}

// The tiles CTA `cta` of `n_ctas` walks (R rows of a block a tile, D stack
// slots), folded into its warp's row `mine`.  `gids`: host ids [n_blocks,
// block_rows], or null (ids from the key codes; with no key, one group).
// `n_valid(blk)`: block blk's valid rows.  Every lane of a warp runs the
// same number of steps (the loop is on the warp's first tile), so the
// warp-wide operations see all 32 lanes.
template <int R, int D, int THREADS, class P, class NValid>
__device__ __forceinline__ void ga_walk_tiles(const P& p, const int* gids, NValid n_valid,
                                              long long cta, long long n_ctas, long long* stage,
                                              long long* mine) {
  constexpr unsigned FULL = 0xFFFFFFFFu;
  const int L = p.n_leaves;
  const int C = p.capacity;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool keyed = gids != nullptr || p.n_keys > 0;
  const long long rows = p.block_rows;
  const long long tpb = (rows + R - 1) / R;  // tiles a block
  const long long total = p.n_blocks * tpb;
  const long long stride = n_ctas * THREADS;
  long long base = cta * THREADS + warp * 32;
  long long t = base + lane;
  long long blk = tpb > 0 ? t / tpb : 0;
  long long ti = t - blk * tpb;
  const long long step_b = tpb > 0 ? stride / tpb : 0;
  const long long step_t = stride - step_b * tpb;

  for (; base < total; base += stride, t += stride) {
    long long i0 = 0, f0 = 0;
    int n = 0;
    unsigned valid = 0;
    if (t < total) {
      i0 = ti * R;
      f0 = blk * rows + i0;
      n = rows - i0 < R ? (int)(rows - i0) : R;
      const long long nv = n_valid(blk) - i0;
      const int live = nv <= 0 ? 0 : nv < n ? (int)nv : n;
      valid = (1u << live) - 1;
    }
    // the tile's group ids
    int gid[R];
#pragma unroll
    for (int r = 0; r < R; ++r) gid[r] = 0;
    if (keyed) {
      // ga_tile_ids' steps, written out: calling it here made the compiled
      // batch_partials 0.15% and the one-slot grouped partials 1.3% slower
      // (paired runs on an H100)
      long long g[R];
      if (gids != nullptr) {
        fa_lanes<R>(gids + f0, n, g);
      } else {
        // mixed radix over the key columns' codes
#pragma unroll
        for (int r = 0; r < R; ++r) g[r] = 0;
        for (int q = 0; q < p.n_keys; ++q) {
          long long x[R];
          unsigned xn;
          fa_load_tile<R>(p, p.key_slot[q], f0, blk, i0, n, x, xn);
          const long long dlen = p.key_dlen[q];
#pragma unroll
          for (int r = 0; r < R; ++r) g[r] = g[r] * (dlen + 1) + ((xn >> r) & 1 ? dlen : x[r]);
        }
      }
      // a row whose id is outside the slots touches none, as XLA drops
      // out-of-range scatter updates
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (g[r] >= 0 && g[r] < C) {
          gid[r] = (int)g[r];
        } else {
          valid &= ~(1u << r);
        }
      }
    }
    // per row of the tile, the lanes whose row has the same id (the
    // invalid rows' lanes share id -1)
    unsigned same[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      same[r] = keyed ? __match_any_sync(FULL, (valid >> r) & 1 ? gid[r] : -1) : 0;
    }

    const unsigned active = fa_walk_tile<R, D>(
        p, f0, blk, i0, n, valid,
        [&](int k, unsigned live, const long long (&x)[R], unsigned) {
          const int l0 = p.agg_leaf0[k];
          for (int l = l0; l < l0 + p.agg_nleaves[k]; ++l) {
            const int kind = p.leaf_kind[l];
            if (kind == GA_FIRSTVAL) continue;
            const bool is_f = p.leaf_f64[l];
            long long* cells = mine + (long long)l * C;
            // the tile's rows one at a time, each rotated into slot 0, so
            // that the fold's code is there once
            long long v[R];
            int g[R];
            unsigned sm[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              v[r] = x[r];
              g[r] = gid[r];
              sm[r] = same[r];
            }
#pragma unroll 1
            for (int r = 0; r < R; ++r) {
              const bool on = (live >> r) & 1;
              const long long c = ga_contrib(p, l, on, v[0], f0 + r);
              if (!keyed) {
                // one group: each lane folds its rows in order
                if (on) stage[l * 32 + lane] = ga_merge(kind, is_f, stage[l * 32 + lane], c);
              } else {
                const unsigned lv = __ballot_sync(FULL, on);
                if (lv != 0) {
                  // the lowest lane of each id folds what its lanes add
                  const unsigned m = sm[0] & lv;
                  const bool lead = ((valid >> r) & 1) && lane == __ffs(sm[0]) - 1 && m != 0;
                  if (is_f) {
                    // f64: its lanes' values in lane order, staged
                    stage[l * 32 + lane] = c;
                    __syncwarp();
                    if (lead) {
                      long long a = cells[g[0]];
                      for (unsigned b = m; b != 0; b &= b - 1) {
                        a = ga_merge(kind, true, a, stage[l * 32 + __ffs(b) - 1]);
                      }
                      cells[g[0]] = a;
                    }
                    __syncwarp();
                  } else if (on) {
                    ga_row_atomic(kind, cells + g[0], c);
                  }
                }
              }
#pragma unroll
              for (int r2 = 0; r2 + 1 < R; ++r2) {
                v[r2] = v[r2 + 1];
                g[r2] = g[r2 + 1];
                sm[r2] = sm[r2 + 1];
              }
            }
          }
        },
        [](int, const long long (&)[R], unsigned) {});

    if (p.track) {
      // leaf 0: the first active row of each group.  A lane's rows come in
      // order, and within a row of the tile in lane order
      if (!keyed) {
        const long long f1 = f0 + __ffs(active) - 1;
        if (active != 0 && f1 < stage[lane]) stage[lane] = f1;
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool on = (active >> r) & 1;
          const unsigned peers = __match_any_sync(FULL, on ? gid[r] : -1);
          if (on && lane == __ffs(peers) - 1 && f0 + r < mine[gid[r]]) mine[gid[r]] = f0 + r;
        }
      }
    }
    blk += step_b;
    ti += step_t;
    if (ti >= tpb) {
      ti -= tpb;
      ++blk;
    }
  }

  if (!keyed) {
    // each lane's fold, in lane order, into the warp's row
    __syncwarp();
    for (int l = lane; l < L; l += 32) {
      const int kind = p.leaf_kind[l];
      long long acc = mine[(long long)l * C];
      for (int j = 0; j < 32; ++j) acc = ga_merge(kind, p.leaf_f64[l], acc, stage[l * 32 + j]);
      mine[(long long)l * C] = acc;
    }
  }
}

// The CTA's rows folded in warp order into its row of partials `part`
// [L][C].  The caller syncs first.
template <int THREADS, class P>
__device__ __forceinline__ void ga_rows_out(const P& p, const long long* wrows, long long* part) {
  const int L = p.n_leaves;
  const int C = p.capacity;
  const long long LC = (long long)L * C;
  for (long long idx = threadIdx.x; idx < LC; idx += THREADS) {
    const int l = (int)(idx / C);
    const int kind = p.leaf_kind[l];
    const bool is_f = p.leaf_f64[l];
    long long acc = wrows[idx];
    for (int w = 1; w < THREADS / 32; ++w) acc = ga_merge(kind, is_f, acc, wrows[w * LC + idx]);
    part[idx] = acc;
  }
}
