// Zone-tile kernels of the coprocessor's warm aggregation rung.
//
// Replaces these JAX programs of the reference package (tikv_tpu/copr):
//   * jax_zone.py:ZoneEvaluator._full_fn (site jax_zone.full): the full
//     tiles' reductions, with no mask and no walk of the selection;
//   * jax_zone.py:ZoneEvaluator._partial_fn (site jax_zone.partial): the
//     partial tiles, the selection and arguments walked per row (rpn.py
//     eval_rpn, through the bytecode walk of fa_walk.cuh);
//   * the jax.ops.segment_sum/min/max calls inside both and
//     jax_zone.py:_merge_states: the fold of both into the group slots.
//
// The layout (copr/zone.py ZoneLayout) is flat over tiles of tile_rows rows:
// each referenced column is one lane per row, narrowed to int8/16/32 or
// int64/f64, with pad and NULL slots 0 (loaded as plain lanes at their own
// width: no frame to add, no NULL slot to clear); `valid` marks real rows,
// `ridx` holds each row's global valid-row index and `tile_first` each
// tile's least ridx.
//
// zone_full and zone_partial spread the listed tiles over blocks of
// ZN_THREADS threads, each tile on up to ZN_TILE_WARPS warps of one block
// (zn_tile_warps: a function of tile_rows alone; 2 for a 4,096-row tile, so
// that each thread walks ZN_STEPS steps of it).  No accumulator is indexed
// at run time in registers: each thread keeps its leaves in its own column
// of a dynamic shared table [n_leaves][ZN_THREADS], sized by the program's
// leaves.
//   * zone_tiles<PARTIAL, D>: ZN_ROWS rows a thread a step through
//     fa_walk_tile<ZN_ROWS, D> (the operand stack in registers, D = 2, 4 or
//     8 slots, the launcher's pick from the program's depth; a `column <cmp>
//     constant` conjunct in one step), the R values of each aggregate folded
//     in registers first and then one read-modify-write a leaf.  Partial
//     tiles take the `valid` bytes as bits (a step with none is skipped) and
//     their NULL lanes; the tracker (leaf 0, the least ridx of the active
//     rows) loads the R ridx words, and merges, only when some row is active.
//     A full tile passes all rows valid, reads no mask and no NULL (the
//     classification lists a tile as full only when it has no pad row and no
//     NULL in a referenced column) and holds no selection.
//   * zone_bare: a full tile whose every argument is a bare column or
//     count(*) (warm Q1) takes no walk, one warp a tile (ZN_BARE_WARPS,
//     which measured fastest): column by column, each thread loads
//     ZN_LANE_BYTES of the lane at a time as words (16 int8 rows, 8 int16,
//     4 int32, 2 int64) and keeps the sum, and the sum of squares, min and
//     max where a leaf needs them, in registers; a count is the tile's rows.
// The tile's fold: each leaf across a warp's lanes by a shuffle tree (all
// leaves, no barrier), then one barrier and the tile's warps in order, a
// leaf a lane of its first warp.  Each tile thus reduces in an order fixed by
// its shape (rows in step order within a thread, the tree, the warps), so
// two runs are bit-identical, the f64 sum of squares included.  Output: one
// row of partials per listed tile, [n_list, n_leaves] int64 words, f64 as
// their bits; the tracker leaf is tile_first for a full tile, the least ridx
// of the active rows for a partial one, NO_ROW with no GROUP BY.
//
// zone_fold: the rows of partials into the group slots, in an order the
// layout fixes once (copr/fused_zone.py fold_order): slot_tiles lists every
// tile of the layout by (slot, tile), and each slot's range is cut into
// segments of ZN_FOLD_TILES tiles, a block each.  The tile kernels record
// each listed tile's row in a map of the query's own (row_of: its other
// words are whatever the memory held, and a row is taken only where
// tiles[row] is the tile), so the fold is one launch, with no sort, upload
// or clearing a query.  A lane takes a tile: its row's leaves load 8 at a
// time, and each leaf folds across the warp by a shuffle tree, its merge
// the same on every lane; then warp 0 folds the warps' rows in order, a
// lane a leaf; and the last segment of a slot to finish (a ticket on the
// slot's counter, which it sets back to 0) folds the slot's segment rows
// (by its warp 0 up to ZN_FOLD_BATCH of them, else over its warps) and
// writes its column of the packed state [n_int, C] / [n_f64, C].  The order
// is fixed by the layout and ZN_FOLD_TILES, and there are no float atomics,
// so the f64 leaves are bit-identical from run to run.  The grid is the
// segments, so it fills the card however the rows fall into slots.
//
// What bounds it on an H100: memory.  A full tile of warm Q1 reads 6 bytes a
// row (three narrowed columns); a partial tile adds the valid byte, and the
// 4-byte ridx where some row is active.  The walk's instructions, not the
// bytes, set a partial tile's time (as in fused_agg_partials): the design
// walks R rows per decoded instruction and loads each lane's rows in one
// word.  What it does not do yet: cp.async/TMA.  The fold reads each listed
// row once (8 bytes a leaf) and two words a tile of the layout; at the main
// paths' few MB its time is its launch and its chain of dependent loads
// (the tile, its row, the check, the rows; then a segment's ticket).
//
// Layout contract with tikv_tpu_torch/copr/fused_zone.py (the wrapper checks
// sizeof(ZnParams), sizeof(ZnFold) and ZN_FOLD_TILES at load; a CPU test
// checks the leaf kinds).

#include "fa_walk.cuh"

#define ZN_THREADS 256
#define ZN_WARPS (ZN_THREADS / 32)
#define ZN_MAX_LEAVES 64
#define ZN_NO_ROW (1LL << 62)
#define ZN_ROWS 8          // rows a thread walks at once (its step)
#define ZN_LANE_BYTES 16   // bytes of a column a zone_bare step loads a thread
#define ZN_TILE_WARPS 4    // most warps that share one tile of the walk
#define ZN_STEPS 8         // least steps a thread walks of a tile they share
#define ZN_BARE_WARPS 1    // warps on one tile of zone_bare

// leaf kinds: the same table as LEAF_* in copr/fused_group_agg.py (the zone
// rung uses these six)
enum { ZN_TRACK = 0, ZN_COUNT = 1, ZN_SUM = 2, ZN_SUMSQ = 3, ZN_MIN = 4, ZN_MAX = 5 };
enum { ZN_BARE_WALK = -1, ZN_BARE_COUNT = -2 };

struct ZnParams {
  const void* col[FA_MAX_COLS];            // layout lanes [n_rows] of the program's columns
  const unsigned char* nul[FA_MAX_COLS];   // bool null lanes, or null (full tiles: always)
  FaEnc enc;                               // each column's lane width (plain lanes)
  const unsigned char* valid;              // [n_rows]: a real row, not a pad row
  const int* ridx;                         // [n_rows]: global valid-row index
  const long long* tile_first;             // [n_tiles]: least ridx of the tile
  const long long* tiles;                  // the listed tiles [n_list]
  int* row_of;                             // [n_tiles]: tile tiles[i]'s row, row_base + i
  long long n_list;
  long long tile_rows;
  long long consts[FA_MAX_CONSTS];
  long long leaf_ident[ZN_MAX_LEAVES];     // identity of each leaf, raw 64-bit word
  int code[FA_MAX_CODE];
  int n_code;
  int n_cols;
  int n_aggs;
  int n_leaves;
  int track;                               // leaf 0 tracks the first active row (GROUP BY)
  int all_bare;                            // every argument is a bare column or count(*)
  int row_base;                            // row of partials of the list's first tile
  int agg_leaf0[FA_MAX_AGGS];              // first leaf of aggregate k
  int agg_nleaves[FA_MAX_AGGS];
  int bare[FA_MAX_AGGS];                   // column slot of a bare argument, or ZN_BARE_*
  signed char leaf_kind[ZN_MAX_LEAVES];
  signed char leaf_f64[ZN_MAX_LEAVES];     // the leaf is stored as f64 (the sum of squares)
  signed char leaf_slot[ZN_MAX_LEAVES];    // row in the packed int64 or f64 matrix
};

// The zone rung's merge rules, one type each, and the rule of each leaf
// kind (zn_rule): every merge below is derived from these two.
struct ZnAdd {
  static __device__ __forceinline__ long long m(long long a, long long b) { return fa_wadd(a, b); }
};
struct ZnFadd {
  static __device__ __forceinline__ long long m(long long a, long long b) {
    return fa_raw(fa_f(a) + fa_f(b));
  }
};
struct ZnMin {
  static __device__ __forceinline__ long long m(long long a, long long b) { return a < b ? a : b; }
};
struct ZnMax {
  static __device__ __forceinline__ long long m(long long a, long long b) { return a > b ? a : b; }
};

enum { ZN_RULE_ADD, ZN_RULE_FADD, ZN_RULE_MIN, ZN_RULE_MAX };

__device__ __forceinline__ int zn_rule(int kind) {
  return kind == ZN_COUNT || kind == ZN_SUM ? ZN_RULE_ADD
       : kind == ZN_SUMSQ                   ? ZN_RULE_FADD
       : kind == ZN_MAX                     ? ZN_RULE_MAX
                                            : ZN_RULE_MIN;  // ZN_MIN, ZN_TRACK
}

// f(rule) with the rule of leaf kind `kind`, picked by one branch.
template <class F>
__device__ __forceinline__ long long zn_with_rule(int kind, F&& f) {
  switch (zn_rule(kind)) {
    case ZN_RULE_ADD: return f(ZnAdd{});
    case ZN_RULE_FADD: return f(ZnFadd{});
    case ZN_RULE_MAX: return f(ZnMax{});
    default: return f(ZnMin{});
  }
}

__device__ __forceinline__ long long zn_merge(int kind, long long a, long long b) {
  return zn_with_rule(kind, [a, b](auto rule) { return decltype(rule)::m(a, b); });
}

// The warps that share a tile of `tile_rows` rows: the most, up to
// ZN_TILE_WARPS, that still leave each thread ZN_STEPS steps of ZN_ROWS
// rows.  A function of the tile's shape alone, and so is every fold's order.
__host__ __device__ __forceinline__ int zn_tile_warps(long long tile_rows) {
  int w = ZN_TILE_WARPS;
  while (w > 1 && tile_rows < (long long)w * 32 * ZN_ROWS * ZN_STEPS) w >>= 1;
  return w;
}

// Leaf `kind` of the rows set in `live` (values x) merged into acc: the R
// values folded in registers first, in row order, then one merge.  Zone
// arguments are never REAL, so the sum of squares squares int64 values.
template <int R>
__device__ __forceinline__ long long zn_fold_rows(int kind, long long acc, unsigned live,
                                                  const long long (&x)[R]) {
  switch (kind) {
    case ZN_COUNT: return fa_wadd(acc, __popc(live));
    case ZN_SUM: {
      u64 t = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) t += (live >> r) & 1 ? (u64)x[r] : 0ULL;
      return fa_wadd(acc, (long long)t);
    }
    case ZN_SUMSQ: {
      double t = 0.0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const double v = (double)x[r];
        if ((live >> r) & 1) t += v * v;
      }
      return fa_raw(fa_f(acc) + t);
    }
    case ZN_MAX:
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (((live >> r) & 1) && x[r] > acc) acc = x[r];
      }
      return acc;
    default:  // ZN_MIN
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (((live >> r) & 1) && x[r] < acc) acc = x[r];
      }
      return acc;
  }
}

// The least of m and the ridx words of the rows set in `active` at `base`
// (n <= ZN_ROWS rows), compared in 32 bits: one word where aligned.  (A
// template over the rows here stops nvcc's front end with an internal
// error.)
__device__ __forceinline__ long long zn_least_ridx(const int* base, int n, unsigned active,
                                                   long long m) {
  constexpr int R = ZN_ROWS;
  static_assert(R % 4 == 0, "int4 words of ridx");
  int least = 0x7FFFFFFF;  // a pad row's ridx, never active
  if (n == R && ((u64)base & 15) == 0) {
#pragma unroll
    for (int k = 0; k < R / 4; ++k) {
      const int4 q = __ldg((const int4*)base + k);
      const unsigned on = active >> (4 * k);
      if ((on & 1) && q.x < least) least = q.x;
      if ((on & 2) && q.y < least) least = q.y;
      if ((on & 4) && q.z < least) least = q.z;
      if ((on & 8) && q.w < least) least = q.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (((active >> r) & 1) && r < n) {
        const int v = __ldg(base + r);
        if (v < least) least = v;
      }
    }
  }
  return least < m ? least : m;
}

// The tile of list entry li folded from its threads' columns of the table
// (leaf l of thread t at table[l * ZN_THREADS + t]) into its row of `out`:
// each leaf across a warp's lanes by a shuffle tree, lane 0 keeping the
// warp's value in its column; one barrier (every thread of the block comes
// here); then the tile's tw warps in order, a leaf a lane of its first warp.
// A full tile's tracker is its tile_first.  With a row map, the first warp's
// lane 0 records the tile's row there (zone_fold reads it).
template <bool PARTIAL>
__device__ __forceinline__ void zn_fold_tile(const ZnParams& p, long long* table, int li, int tw,
                                             long long* out) {
  const int L = p.n_leaves;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int l = 0; l < L; ++l) {
    const int kind = p.leaf_kind[l];
    long long v = table[l * ZN_THREADS + tid];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = zn_merge(kind, v, __shfl_down_sync(0xFFFFFFFFu, v, off));
    }
    if (lane == 0) table[l * ZN_THREADS + tid] = v;
  }
  __syncthreads();
  if (warp % tw != 0 || li >= p.n_list) return;
  if (lane == 0) p.row_of[__ldg(p.tiles + li)] = p.row_base + li;
  long long* row = out + (long long)li * L;
  for (int l = lane; l < L; l += 32) {
    const int kind = p.leaf_kind[l];
    long long v;
    if (!PARTIAL && kind == ZN_TRACK) {
      v = p.track ? __ldg(p.tile_first + __ldg(p.tiles + li)) : ZN_NO_ROW;
    } else {
      const long long* at = table + l * ZN_THREADS + warp * 32;
      v = at[0];
      for (int w = 1; w < tw; ++w) v = zn_merge(kind, v, at[w * 32]);
    }
    row[l] = v;
  }
}

// Thread (list entry, warp of its tile): list entry li of the block's
// ZN_WARPS / tw tiles, gw-th of the tw warps on it (the launcher keeps the
// list under 2^31 entries).
__device__ __forceinline__ int zn_entry(int tw, int& gw) {
  const int warp = threadIdx.x >> 5;
  gw = warp % tw;
  return (int)blockIdx.x * (ZN_WARPS / tw) + warp / tw;
}

// zone_full (PARTIAL false) and zone_partial over the listed tiles on the
// walk of D stack slots (see the top of the file).
template <bool PARTIAL, int D>
__global__ void __launch_bounds__(ZN_THREADS)
zone_tiles(const __grid_constant__ ZnParams p, long long* __restrict__ out) {
  constexpr int R = ZN_ROWS;
  extern __shared__ long long zn_table[];  // [n_leaves][ZN_THREADS]
  const int L = p.n_leaves;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tw = zn_tile_warps(p.tile_rows);
  int gw;
  const int li = zn_entry(tw, gw);
  for (int l = 0; l < L; ++l) zn_table[l * ZN_THREADS + tid] = p.leaf_ident[l];

  if (li < p.n_list) {
    const long long tile = __ldg(p.tiles + li);
    const int tr = (int)p.tile_rows;
    const long long base = tile * p.tile_rows;
    for (int r0 = (gw * 32 + lane) * R; r0 < tr; r0 += tw * 32 * R) {
      const long long f0 = base + r0;
      const int n = tr - r0 < R ? tr - r0 : R;
      const unsigned valid = PARTIAL ? fa_flag_bits<R>(p.valid + f0, n) : (1u << n) - 1;
      if (valid == 0) continue;
      const unsigned active = fa_walk_tile<R, D>(
          p, f0, 0, f0, n, valid,
          [&](int k, unsigned live, const long long (&x)[R], unsigned) {
            if (live == 0) return;
            const int l0 = p.agg_leaf0[k], l1 = l0 + p.agg_nleaves[k];
            for (int l = l0; l < l1; ++l) {
              const int at = l * ZN_THREADS + tid;
              zn_table[at] = zn_fold_rows<R>(p.leaf_kind[l], zn_table[at], live, x);
            }
          },
          [](int, const long long (&)[R], unsigned) {});
      if (PARTIAL && p.track && active != 0) {  // the tracker, leaf 0
        zn_table[tid] = zn_least_ridx(p.ridx + f0, n, active, zn_table[tid]);
      }
    }
  }
  zn_fold_tile<PARTIAL>(p, zn_table, li, tw, out);
}

// A bare column's statistics over a thread's rows.
struct ZnStats {
  u64 sum;
  double sq;
  long long mn;
  long long mx;
};

// The thread's rows of one bare column of a tile (lane `col`, tr rows): R =
// ZN_LANE_BYTES / sizeof(T) rows a step in one word where aligned, starting
// at the thread's `first` R-row chunk and striding `stride` chunks.  `need`
// holds a bit (1 << kind) for each of the min, max and sum of squares some
// leaf reads; the sum is always kept.
template <typename T>
__device__ __forceinline__ void zn_bare_rows(const T* col, int tr, int first, int stride,
                                             unsigned need, ZnStats& s) {
  constexpr int R = ZN_LANE_BYTES / (int)sizeof(T);
#pragma unroll 2
  for (int r0 = first * R; r0 < tr; r0 += stride * R) {
    const int n = tr - r0 < R ? tr - r0 : R;
    long long x[R];
    fa_lanes<R>(col + r0, n, x);  // rows past n load as 0
    if constexpr (sizeof(T) <= 2) {
      int t = 0;  // at most 16 int8 or 8 int16 rows: no int32 overflow
#pragma unroll
      for (int r = 0; r < R; ++r) t += (int)x[r];
      s.sum += (u64)(long long)t;
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) s.sum += (u64)x[r];
    }
    if (need & ((1u << ZN_MIN) | (1u << ZN_MAX))) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < n) {
          s.mn = x[r] < s.mn ? x[r] : s.mn;
          s.mx = x[r] > s.mx ? x[r] : s.mx;
        }
      }
    }
    if (need & (1u << ZN_SUMSQ)) {
      double t = 0.0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const double v = (double)x[r];
        t += v * v;  // a row past n adds +0.0
      }
      s.sq += t;
    }
  }
}

// zone_full of a program whose every argument is a bare column or count(*):
// no walk (see the top of the file).  Each leaf's value goes into the
// thread's column of the table; a count leaf of the tile's first thread
// holds the tile's rows.  Then the same fold as zone_tiles.
__global__ void __launch_bounds__(ZN_THREADS)
zone_bare(const __grid_constant__ ZnParams p, long long* __restrict__ out) {
  extern __shared__ long long zn_table[];  // [n_leaves][ZN_THREADS]
  const int L = p.n_leaves;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tw = ZN_BARE_WARPS;
  int gw;
  const int li = zn_entry(tw, gw);
  const bool lead = gw == 0 && lane == 0;
  for (int l = 0; l < L; ++l) {
    zn_table[l * ZN_THREADS + tid] =
        p.leaf_kind[l] == ZN_COUNT && lead ? p.tile_rows : p.leaf_ident[l];
  }
  if (li < p.n_list) {
    const int tr = (int)p.tile_rows;
    const long long base = __ldg(p.tiles + li) * p.tile_rows;
    for (int j = 0; j < p.n_cols; ++j) {
      // the leaf kinds of the aggregates over column j, counts aside
      unsigned need = 0;
      for (int k = 0; k < p.n_aggs; ++k) {
        if (p.bare[k] != j) continue;
        for (int l = p.agg_leaf0[k]; l < p.agg_leaf0[k] + p.agg_nleaves[k]; ++l) {
          need |= 1u << p.leaf_kind[l];
        }
      }
      need &= ~(1u << ZN_COUNT);
      if (need == 0) continue;
      ZnStats s = {0ULL, 0.0, 0x7FFFFFFFFFFFFFFFLL, (long long)0x8000000000000000ULL};
      const int at = gw * 32 + lane, stride = tw * 32;
      switch (p.enc.width[j]) {
        case 1: zn_bare_rows((const signed char*)p.col[j] + base, tr, at, stride, need, s); break;
        case 2: zn_bare_rows((const short*)p.col[j] + base, tr, at, stride, need, s); break;
        case 4: zn_bare_rows((const int*)p.col[j] + base, tr, at, stride, need, s); break;
        default: zn_bare_rows((const long long*)p.col[j] + base, tr, at, stride, need, s); break;
      }
      for (int k = 0; k < p.n_aggs; ++k) {
        if (p.bare[k] != j) continue;
        for (int l = p.agg_leaf0[k]; l < p.agg_leaf0[k] + p.agg_nleaves[k]; ++l) {
          long long* at = zn_table + l * ZN_THREADS + tid;
          switch (p.leaf_kind[l]) {
            case ZN_SUM: *at = (long long)s.sum; break;
            case ZN_SUMSQ: *at = fa_raw(s.sq); break;
            case ZN_MIN: *at = s.mn; break;
            case ZN_MAX: *at = s.mx; break;
            default: break;  // the count: the tile's rows, above
          }
        }
      }
    }
  }
  zn_fold_tile<false>(p, zn_table, li, tw, out);
}

typedef void (*ZnTilesKernel)(ZnParams, long long*);

// The instance that serves a program: slots 0 is zone_bare (a full-tile
// program with every argument bare), else the walk of `slots` stack slots
// (2, 4 or 8); nullptr for any other pick.
static ZnTilesKernel zn_tiles_kernel(int partial, int slots) {
  static_assert(FA_MAX_STACK == 8, "the walk instances' slots");
  if (slots == 0) return partial ? nullptr : zone_bare;
  switch (slots) {
    case 2: return partial ? zone_tiles<true, 2> : zone_tiles<false, 2>;
    case 4: return partial ? zone_tiles<true, 4> : zone_tiles<false, 4>;
    case 8: return partial ? zone_tiles<true, 8> : zone_tiles<false, 8>;
    default: return nullptr;
  }
}

// ---------------------------------------------------------------------------
// zone_fold: the tile partials into the group slots, over the layout's fold
// order (see the top of the file)
// ---------------------------------------------------------------------------

#define ZN_FOLD_WARPS 16                       // warps of a fold block
#define ZN_FOLD_THREADS (ZN_FOLD_WARPS * 32)
#define ZN_FOLD_TILES (ZN_FOLD_WARPS * 32)     // tiles of a segment, a block's: one a lane
#define ZN_FOLD_LEAVES 8                       // leaves whose loads a lane keeps in flight
#define ZN_FOLD_BATCH 16                       // rows whose loads a lane keeps in flight
#define ZN_FULL 0xFFFFFFFFu

struct ZnFold {
  const long long* parts;   // [n_list][n_leaves]: row i is listed tile tiles[i]'s
  const long long* tiles;   // [n_list]: the listed tiles
  const int* row_of;        // [n_tiles]: a listed tile's row of parts; any value for another
  const int* slot_tiles;    // [n_tiles]: every tile of the layout by (slot, tile)
  const int* segs;          // [5][n_segs]: tile lo, tile hi, slot, its slot's first
                            // segment and segments
  int* count;               // [capacity]: arrivals a slot, 0 before a launch and after it
  long long* rows;          // scratch [n_segs][n_leaves]: each segment's folded row
  long long* out_i;         // [n_int][capacity]
  double* out_f;            // [n_f64][capacity]
  long long n_list;
  long long leaf_ident[ZN_MAX_LEAVES];
  int n_tiles;
  int n_segs;
  int capacity;
  int n_leaves;
  signed char leaf_kind[ZN_MAX_LEAVES];
  signed char leaf_f64[ZN_MAX_LEAVES];
  signed char leaf_slot[ZN_MAX_LEAVES];
};

template <class Op>
__device__ __forceinline__ long long zn_tree(long long v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = Op::m(v, __shfl_down_sync(ZN_FULL, v, s));
  return v;
}

// One leaf's value across a warp's lanes folded by a shuffle tree (lane i
// takes lane i + s for s = 16, ..., 1, as zn_fold_tile's tree); lane 0
// returns the total.  The kind is the same on every lane, and its rule is
// picked once, not at each step (a branch between shuffles costs the warp
// a reconvergence each time).
__device__ __forceinline__ long long zn_warp_fold(int kind, long long v) {
  return zn_with_rule(kind, [v](auto rule) { return zn_tree<decltype(rule)>(v); });
}

// zn_merge of a lane's own leaf kind, by selects: where a warp's lanes hold
// different leaves, a switch would run every kind's path in turn.
__device__ __forceinline__ long long zn_lane_merge(int kind, long long a, long long b) {
  const int rule = zn_rule(kind);
  const long long add = ZnAdd::m(a, b), fadd = ZnFadd::m(a, b);
  const long long lo = ZnMin::m(a, b), hi = ZnMax::m(a, b);
  return rule == ZN_RULE_ADD ? add : rule == ZN_RULE_FADD ? fadd : rule == ZN_RULE_MAX ? hi : lo;
}

// Each leaf of the rows `src` of the lanes that hold one (the others hold
// the identity) folded across the warp into dst[l] by lane 0: the loads of
// ZN_FOLD_LEAVES leaves in flight at once, two leaves a 16-byte load where
// a row's words are 16-byte aligned (an even count of leaves).
__device__ __forceinline__ void zn_fold_leaves(const long long* src, int L, const int* kind,
                                               const long long* ident, long long* dst) {
  const int lane = threadIdx.x & 31;
  for (int l0 = 0; l0 < L; l0 += ZN_FOLD_LEAVES) {
    long long x[ZN_FOLD_LEAVES];
    if ((L & 1) == 0) {
#pragma unroll
      for (int j = 0; j < ZN_FOLD_LEAVES; j += 2) {
        const int l = l0 + j < L ? l0 + j : l0;
        const longlong2 w = src != nullptr ? __ldg((const longlong2*)(src + l))
                                           : make_longlong2(ident[l], ident[l + 1]);
        x[j] = w.x;
        x[j + 1] = w.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < ZN_FOLD_LEAVES; ++j) {
        const int l = l0 + j < L ? l0 + j : l0;
        x[j] = src != nullptr ? __ldg(src + l) : ident[l];
      }
    }
#pragma unroll
    for (int j = 0; j < ZN_FOLD_LEAVES; ++j) {
      const int l = l0 + j;
      if (l >= L) break;
      const long long v = zn_warp_fold(kind[l], x[j]);
      if (lane == 0) dst[l] = v;
    }
  }
}

// Rows row0, row0 + step, ... (n of them; ld words apart) of `rows` folded
// in order into lane l's leaves l and l + 32 (a0, a1), ZN_FOLD_BATCH rows'
// loads in flight at once, each row one coalesced load of its n_leaves
// words.  Read through L2 (ld.global.cg) where another SM wrote the rows in
// the launch.
template <bool L2>
__device__ __forceinline__ void zn_fold_run(const long long* rows, int ld, int L, int row0,
                                            int step, int n, int k0, int k1, long long& a0,
                                            long long& a1) {
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < n; b += ZN_FOLD_BATCH) {
    long long x0[ZN_FOLD_BATCH], x1[ZN_FOLD_BATCH];
#pragma unroll
    for (int i = 0; i < ZN_FOLD_BATCH; ++i) {
      const long long* src = rows + (long long)(row0 + (b + i < n ? b + i : b) * step) * ld;
      x0[i] = lane < L ? (L2 ? __ldcg(src + lane) : src[lane]) : 0;
      x1[i] = lane + 32 < L ? (L2 ? __ldcg(src + lane + 32) : src[lane + 32]) : 0;
    }
#pragma unroll
    for (int i = 0; i < ZN_FOLD_BATCH; ++i) {
      if (b + i < n) {
        a0 = zn_lane_merge(k0, a0, x0[i]);
        a1 = zn_lane_merge(k1, a1, x1[i]);
      }
    }
  }
}

// Slot g's column of the packed state from lane l's leaves l and l + 32.
__device__ __forceinline__ void zn_write_slot(const ZnFold& f, int g, long long a0,
                                              long long a1) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = lane + 32 * h;
    if (l >= f.n_leaves) break;
    const long long v = h == 0 ? a0 : a1;
    const long long cell = (long long)f.leaf_slot[l] * f.capacity + g;
    if (f.leaf_f64[l]) {
      f.out_f[cell] = fa_f(v);
    } else {
      f.out_i[cell] = v;
    }
  }
}

// A block a segment: up to ZN_FOLD_TILES consecutive entries of slot_tiles,
// one slot's, in ascending tile order.  Warp w takes the segment's tiles 32w
// .. 32w + 31, a lane each: the tile's row from row_of, taken only where
// tiles[row] is the tile (a word no tile kernel of this query wrote is never
// taken).  Each leaf is folded across the lanes by a shuffle tree, its kind
// the same on every lane (a lane a row: no lane runs another leaf's merge).
// Warp 0 then folds the warps' rows in order, lane l holding leaves l and l
// + 32.  A slot of one segment is then done.  In a slot of more, each
// segment's row goes to scratch, and the block of the last to arrive (a
// ticket on the slot's counter, which it sets back to 0) folds them: up to
// ZN_FOLD_BATCH segments in order by its warp 0 (one round of loads), more
// with segment k on warp k mod ZN_FOLD_WARPS in ascending k, then the warps
// in order.  That block writes the slot's column of the packed state.
__global__ void __launch_bounds__(ZN_FOLD_THREADS) zone_fold(const __grid_constant__ ZnFold f) {
  __shared__ long long s_rows[ZN_FOLD_WARPS][ZN_MAX_LEAVES];
  __shared__ long long s_ident[ZN_MAX_LEAVES];
  __shared__ int s_kind[ZN_MAX_LEAVES];
  __shared__ int s_share;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = blockIdx.x, S = f.n_segs;
  const int L = f.n_leaves;
  if (threadIdx.x < ZN_MAX_LEAVES) {
    s_ident[threadIdx.x] = f.leaf_ident[threadIdx.x];
    s_kind[threadIdx.x] = f.leaf_kind[threadIdx.x];
  }
  const int t_lo = __ldg(f.segs + seg), t_hi = __ldg(f.segs + S + seg);
  const int g = __ldg(f.segs + 2 * S + seg);
  const int seg0 = __ldg(f.segs + 3 * S + seg), n_seg = __ldg(f.segs + 4 * S + seg);
  const int q = t_lo + warp * 32 + lane;
  const int tile = q < t_hi ? __ldg(f.slot_tiles + q) : -1;
  const int r = tile >= 0 ? __ldg(f.row_of + tile) : -1;
  const bool in = (unsigned)r < (unsigned)f.n_list && __ldg(f.tiles + r) == tile;
  __syncthreads();
  zn_fold_leaves(in ? f.parts + (long long)r * L : nullptr, L, s_kind, s_ident, s_rows[warp]);
  __syncthreads();
  const int k0 = s_kind[lane], k1 = s_kind[lane + 32];
  long long a0 = s_ident[lane], a1 = s_ident[lane + 32];
  if (warp == 0) {
    zn_fold_run<false>(&s_rows[0][0], ZN_MAX_LEAVES, L, 0, 1, ZN_FOLD_WARPS, k0, k1, a0, a1);
    bool last = true;
    if (n_seg > 1) {
      long long* dst = f.rows + (long long)seg * L;
      if (lane < L) dst[lane] = a0;
      if (lane + 32 < L) dst[lane + 32] = a1;
      __threadfence();
      __syncwarp();
      int arrived = 0;
      if (lane == 0) arrived = atomicAdd(f.count + g, 1);
      last = __shfl_sync(ZN_FULL, arrived, 0) == n_seg - 1;
      if (last && lane == 0) f.count[g] = 0;  // every segment of the slot has arrived
      __threadfence();
      if (last && n_seg <= ZN_FOLD_BATCH) {
        a0 = s_ident[lane];
        a1 = s_ident[lane + 32];
        zn_fold_run<true>(f.rows, L, L, seg0, 1, n_seg, k0, k1, a0, a1);
      }
    }
    if (last && n_seg <= ZN_FOLD_BATCH) zn_write_slot(f, g, a0, a1);
    if (lane == 0) s_share = last && n_seg > ZN_FOLD_BATCH;
  }
  __syncthreads();
  if (!s_share) return;
  a0 = s_ident[lane];
  a1 = s_ident[lane + 32];
  const int n = (n_seg - warp + ZN_FOLD_WARPS - 1) / ZN_FOLD_WARPS;
  zn_fold_run<true>(f.rows, L, L, seg0 + warp, ZN_FOLD_WARPS, n, k0, k1, a0, a1);
  s_rows[warp][lane] = a0;
  s_rows[warp][lane + 32] = a1;
  __syncthreads();
  if (warp != 0) return;
  a0 = s_ident[lane];
  a1 = s_ident[lane + 32];
  zn_fold_run<false>(&s_rows[0][0], ZN_MAX_LEAVES, L, 0, 1, ZN_FOLD_WARPS, k0, k1, a0, a1);
  zn_write_slot(f, g, a0, a1);
}

extern "C" {

int zn_params_size(void) { return (int)sizeof(ZnParams); }
int zn_threads(void) { return ZN_THREADS; }

// partial: 0 for zone_full, 1 for zone_partial; slots: the instance
// (zn_tiles_kernel; cudaErrorInvalidValue for another pick, or slots 0 for
// a program with an argument to walk).  A block holds ZN_WARPS / (warps a
// tile) listed tiles; dynamic shared memory n_leaves * ZN_THREADS * 8
// bytes.  Returns cudaGetLastError() right after the launch.
int zn_launch_tiles(const ZnParams* p, int partial, int slots, long long* out, void* stream) {
  const ZnTilesKernel k = zn_tiles_kernel(partial, slots);
  if (k == nullptr || (slots == 0 && !p->all_bare) || p->tile_rows < 1
      || p->tile_rows >= (1LL << 31) || p->n_list >= (1LL << 31) || p->n_leaves < 1
      || p->n_leaves > ZN_MAX_LEAVES) {
    return (int)cudaErrorInvalidValue;
  }
  if (p->n_list <= 0) return 0;
  const int tw = slots == 0 ? ZN_BARE_WARPS : zn_tile_warps(p->tile_rows);
  const long long per_block = ZN_WARPS / tw;
  const long long grid = (p->n_list + per_block - 1) / per_block;
  const int smem = p->n_leaves * ZN_THREADS * 8;
  cudaError_t err = cudaFuncSetAttribute((const void*)k,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k<<<(unsigned)grid, ZN_THREADS, smem, (cudaStream_t)stream>>>(*p, out);
  return (int)cudaGetLastError();
}

// cudaFuncGetAttributes of the instance (partial, slots): registers a thread,
// local (spilled) and static shared bytes, into out[0..3).
int zn_tiles_attributes(int partial, int slots, int* out) {
  const ZnTilesKernel k = zn_tiles_kernel(partial, slots);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)k);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

int zn_fold_size(void) { return (int)sizeof(ZnFold); }
int zn_fold_tiles(void) { return ZN_FOLD_TILES; }

// zone_fold of the listed tiles f->tiles [f->n_list] (each tile at most
// once; parts row i is tiles[i]'s, recorded in row_of by the tile kernels),
// a block a segment.  Returns cudaGetLastError() after the launch.
int zn_launch_fold(const ZnFold* f, void* stream) {
  if (f->n_leaves < 1 || f->n_leaves > ZN_MAX_LEAVES || f->n_list < 0
      || f->n_list > f->n_tiles || f->n_segs < 1 || f->capacity < 1) {
    return (int)cudaErrorInvalidValue;
  }
  zone_fold<<<f->n_segs, ZN_FOLD_THREADS, 0, (cudaStream_t)stream>>>(*f);
  return (int)cudaGetLastError();
}

// cudaFuncGetAttributes of zone_fold: registers a thread, local (spilled)
// and static shared bytes, into out[0..3).
int zn_fold_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)zone_fold);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

}  // extern "C"
