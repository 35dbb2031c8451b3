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
// each referenced column is one lane per row, narrowed to int8/16/32 (loaded
// by fa_load as a bitpacked lane with frame 0) or int64/f64 (plain), with
// pad and NULL slots 0; `valid` marks real rows, `ridx` holds each row's
// global valid-row index and `tile_first` each tile's least ridx.
//
// zone_tiles<FULL>: one block per listed full tile.  Its threads stride the
// tile's rows; each row's leaves are accumulated per thread (count, int64
// sum in unsigned arithmetic that wraps as int64 does, f64 sum of squares,
// int64 min/max); bare-column arguments read the lane directly, expression
// arguments walk the bytecode, which holds no selection.  No valid mask and
// no null mask is read: the classification lists a tile as full only when it
// has no pad row and no NULL in a referenced column.  The tracker leaf is
// the tile's tile_first.
// zone_tiles<PARTIAL>: the same over the listed partial tiles, each row
// masked by `valid` and walked with its selection; the tracker is the least
// ridx of the tile's active rows.
// Both reduce each leaf in a fixed order (lane, then a warp shuffle tree,
// then the warps in order) and write one row of partials per listed tile:
// [n_list, n_leaves] int64 words, f64 as their bits.
//
// zone_fold: one block per group slot.  Slot g's rows of partials are
// order[starts[g] .. starts[g+1]) (copr/zone.py fold_order: the slot's tiles
// in ascending tile order); the threads fold them strided, then a fixed
// shared-memory tree, and the block writes the slot's column of the packed
// state [n_int, C] / [n_f64, C].  The order is fixed and there are no float
// atomics, so the f64 leaves are bit-identical from run to run.
//
// What bounds it on an H100: memory.  A full tile of warm Q1 reads 8 bytes a
// row (four narrowed columns); a partial tile adds the valid byte and the
// 4-byte ridx.  What the design does not do yet: vector loads, several tiles
// per block, cp.async/TMA.
//
// Layout contract with tikv_tpu_torch/copr/fused_zone.py (the wrapper checks
// sizeof(ZnParams) at load; a CPU test checks the leaf kinds).

#include "fa_walk.cuh"

#define ZN_THREADS 256
#define ZN_WARPS (ZN_THREADS / 32)
#define ZN_MAX_LEAVES 64
#define ZN_NO_ROW (1LL << 62)

// leaf kinds: the same table as LEAF_* in copr/fused_group_agg.py (the zone
// rung uses these six)
enum { ZN_TRACK = 0, ZN_COUNT = 1, ZN_SUM = 2, ZN_SUMSQ = 3, ZN_MIN = 4, ZN_MAX = 5 };
enum { ZN_BARE_WALK = -1, ZN_BARE_COUNT = -2 };

struct ZnParams {
  const void* col[FA_MAX_COLS];            // layout lanes [n_rows] of the program's columns
  const unsigned char* nul[FA_MAX_COLS];   // bool null lanes, or null (full tiles: always)
  FaEnc enc;                               // how each column loads (plain or narrow, frame 0)
  const unsigned char* valid;              // [n_rows]: a real row, not a pad row
  const int* ridx;                         // [n_rows]: global valid-row index
  const long long* tile_first;             // [n_tiles]: least ridx of the tile
  const long long* tiles;                  // the listed tiles [n_list]
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
  int agg_leaf0[FA_MAX_AGGS];              // first leaf of aggregate k
  int agg_nleaves[FA_MAX_AGGS];
  int bare[FA_MAX_AGGS];                   // column slot of a bare argument, or ZN_BARE_*
  signed char leaf_kind[ZN_MAX_LEAVES];
  signed char leaf_f64[ZN_MAX_LEAVES];     // the leaf is stored as f64 (the sum of squares)
  signed char leaf_slot[ZN_MAX_LEAVES];    // row in the packed int64 or f64 matrix
};

__device__ __forceinline__ long long zn_merge(int kind, long long a, long long b) {
  switch (kind) {
    case ZN_COUNT:
    case ZN_SUM: return fa_wadd(a, b);
    case ZN_SUMSQ: return fa_raw(fa_f(a) + fa_f(b));
    case ZN_MAX: return a > b ? a : b;
    default: return a < b ? a : b;  // ZN_MIN, ZN_TRACK
  }
}

// What a live row with argument `value` adds to a leaf of its aggregate.
__device__ __forceinline__ long long zn_contrib(int kind, long long value) {
  switch (kind) {
    case ZN_COUNT: return 1;
    case ZN_SUMSQ: {
      const double x = (double)value;  // zone arguments are never REAL
      return fa_raw(x * x);
    }
    default: return value;
  }
}

// The block's fold of one leaf in a fixed order: lanes by a shuffle tree,
// then warps in order by thread 0, which returns the result.
__device__ __forceinline__ long long zn_block_fold(int kind, long long v, long long* s_warp) {
  for (int off = 16; off > 0; off >>= 1) {
    v = zn_merge(kind, v, __shfl_down_sync(0xFFFFFFFFu, v, off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  long long r = v;
  if (threadIdx.x == 0) {
    r = s_warp[0];
    for (int w = 1; w < ZN_WARPS; ++w) r = zn_merge(kind, r, s_warp[w]);
  }
  __syncthreads();
  return r;
}

template <bool PARTIAL>
__global__ void __launch_bounds__(ZN_THREADS)
zone_tiles(const __grid_constant__ ZnParams p, long long* __restrict__ out) {
  __shared__ long long s_warp[ZN_WARPS];
  const int L = p.n_leaves;
  long long acc[ZN_MAX_LEAVES];
  for (int l = 0; l < L; ++l) acc[l] = p.leaf_ident[l];

  const long long tile = __ldg(p.tiles + blockIdx.x);
  const long long base = tile * p.tile_rows;
  for (long long r = threadIdx.x; r < p.tile_rows; r += ZN_THREADS) {
    const long long f = base + r;
    auto on_agg = [&](int k, bool live, long long value) {
      if (!live) return;
      const int l0 = p.agg_leaf0[k];
      for (int l = l0; l < l0 + p.agg_nleaves[k]; ++l) {
        const int kind = p.leaf_kind[l];
        acc[l] = zn_merge(kind, acc[l], zn_contrib(kind, value));
      }
    };
    if (PARTIAL) {
      if (!__ldg(p.valid + f)) continue;
      const bool active = fa_walk(p, f, 0, f, on_agg);
      if (active && p.track) acc[0] = zn_merge(ZN_TRACK, acc[0], __ldg(p.ridx + f));
    } else if (p.all_bare) {
      long long v[FA_MAX_COLS];
      bool nul;
#pragma unroll
      for (int j = 0; j < FA_MAX_COLS; ++j) {
        if (j < p.n_cols) v[j] = fa_load(p, j, f, 0, f, nul);
      }
      for (int k = 0; k < p.n_aggs; ++k) {
        const int b = p.bare[k];
        on_agg(k, true, b >= 0 ? v[b] : 0LL);
      }
    } else {
      fa_walk(p, f, 0, f, on_agg);
    }
  }

  long long* row = out + (long long)blockIdx.x * L;
  for (int l = 0; l < L; ++l) {
    const int kind = p.leaf_kind[l];
    if (kind == ZN_TRACK && !PARTIAL) {
      if (threadIdx.x == 0) row[l] = p.track ? __ldg(p.tile_first + tile) : ZN_NO_ROW;
      continue;
    }
    const long long r = zn_block_fold(kind, acc[l], s_warp);
    if (threadIdx.x == 0) row[l] = r;
  }
}

__global__ void __launch_bounds__(ZN_THREADS)
zone_fold(const __grid_constant__ ZnParams p, const long long* __restrict__ parts,
          const int* __restrict__ order, const int* __restrict__ starts, int capacity,
          long long* out_i, double* out_f) {
  __shared__ long long s_warp[ZN_WARPS];
  const int g = blockIdx.x;
  const int L = p.n_leaves;
  const int lo = __ldg(starts + g), hi = __ldg(starts + g + 1);
  for (int l = 0; l < L; ++l) {
    const int kind = p.leaf_kind[l];
    long long v = p.leaf_ident[l];
    for (int q = lo + threadIdx.x; q < hi; q += ZN_THREADS) {
      v = zn_merge(kind, v, __ldg(parts + (long long)__ldg(order + q) * L + l));
    }
    v = zn_block_fold(kind, v, s_warp);
    if (threadIdx.x == 0) {
      const long long cell = (long long)p.leaf_slot[l] * capacity + g;
      if (p.leaf_f64[l]) {
        out_f[cell] = fa_f(v);
      } else {
        out_i[cell] = v;
      }
    }
  }
}

extern "C" {

int zn_params_size(void) { return (int)sizeof(ZnParams); }
int zn_threads(void) { return ZN_THREADS; }

// partial: 0 for zone_full, 1 for zone_partial; one block per listed tile.
// Returns cudaGetLastError() right after the launch.
int zn_launch_tiles(const ZnParams* p, int partial, long long* out, void* stream) {
  if (p->n_list <= 0) return 0;
  if (partial) {
    zone_tiles<true><<<(unsigned)p->n_list, ZN_THREADS, 0, (cudaStream_t)stream>>>(*p, out);
  } else {
    zone_tiles<false><<<(unsigned)p->n_list, ZN_THREADS, 0, (cudaStream_t)stream>>>(*p, out);
  }
  return (int)cudaGetLastError();
}

int zn_launch_fold(const ZnParams* p, const long long* parts, const int* order,
                   const int* starts, int capacity, long long* out_i, double* out_f,
                   void* stream) {
  zone_fold<<<capacity, ZN_THREADS, 0, (cudaStream_t)stream>>>(*p, parts, order, starts,
                                                               capacity, out_i, out_f);
  return (int)cudaGetLastError();
}

}  // extern "C"
