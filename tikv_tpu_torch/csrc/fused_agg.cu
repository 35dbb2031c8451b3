// Fused scan-filter-aggregate kernels of the coprocessor's device path.
//
// Replaces these JAX programs of the reference package (tikv_tpu/copr):
//   * rpn.py:eval_rpn(xp=jnp), inlined into the programs below, through the
//     bytecode walk of fa_walk.cuh;
//   * jax_eval.py:_build_agg_fn (site jax_eval.agg_step), i.e. _fused_step
//     plus _DeviceAgg.update, at group capacity 1, for count/sum/avg/min/max;
//   * jax_eval.py:_build_scan_fn (site jax_eval.scan): the same block step
//     over every block of a stacked [n_blocks, block_rows] image;
//   * jax_eval.py:_pack_state (site jax_eval.pack): the carry packed into
//     one int64 and one f64 matrix for a single pull;
//   * with GROUP BY, or any of the ten device aggregates (count sum avg min
//     max var_pop first bit_and bit_or bit_xor): the same three programs at
//     capacity C >= 1 (fused_group_agg_partials + fused_group_agg_combine_pack,
//     host group ids; past the shared-memory rows the wide route,
//     group_wide_partials + group_wide_combine, which also replaces the
//     scatter branch's _seg_sum and _seg_extreme at any capacity) and
//     jax_eval.py:_build_scan_fn_coded (site
//     jax_eval.scan_coded: group ids from resident dictionary codes), each
//     with _fused_step's first-active-row tracker.
//
// What bounds it on an H100: memory.  TPC-H Q6 reads four int64 columns,
// 32 bytes a row, and does a few dozen integer operations on them, far
// below the card's operation rate per byte of HBM (3.35 TB/s).  The least
// time is the bytes of the valid rows over the memory rate.
//
// What the design does about it:
//   * one pass: predicates, aggregate arguments and the aggregates are
//     evaluated from registers, so no mask or intermediate column is
//     written back to device memory;
//   * every partials kernel walks GA_ROWS consecutive rows of one block a
//     thread (a tile) with the tile walk of fa_walk.cuh: the operand stack
//     in registers (instances of 2, 4 and 8 stack slots, the launcher's
//     pick from the plan's depth), each lane's rows in one vector load
//     where aligned, a `column <cmp> constant` conjunct in one step; no
//     local memory;
//   * a tile with no valid row (the padding past n_valid, a block zone maps
//     pruned) costs the read of its block's n_valid;
//   * the plan is bytecode in the kernel's parameter block
//     (__grid_constant__, served from constant memory): every thread of
//     the grid reads the same instruction, so the walk never diverges and
//     one compiled kernel serves every plan.
// fused_agg_partials folds each thread's rows into its own column of a
// shared-memory table (the aggregate is known only at run time, and an
// array indexed by it would live in local memory); fused_group_agg_partials
// folds as batch_partials does (ga_fold.cuh); group_wide_partials walks
// the selection first and queues the rows it keeps, so that the
// aggregates' arguments, group ids and atomics run on full warps of kept
// rows.  No cp.async/TMA pipelining: later work.
//
// Encoded images: every column is read through fa_load_tile or fa_load
// (program #1, in fa_walk.cuh), also the dictionary codes of the coded
// group ids and the winning row that `first` walks again in the combine.
//
// Determinism: the grid depends on the image's shape alone (at most FA_GRID
// blocks of FA_THREADS threads), a tile of GA_ROWS rows goes to thread
// (its index mod the grid's threads), and every reduction runs in a fixed
// order, so f64 sums are bit-identical from run to run; the wide route's
// f64 sums are exact until one rounding, so their order does not matter at
// all.  Integer arithmetic is done in unsigned 64-bit and cast back, which
// wraps as numpy does (signed overflow is undefined in C++), so integer and
// decimal results are exact and independent of order.
//
// Layout contract with tikv_tpu_torch/copr/fused_agg.py and
// copr/fused_group_agg.py (CPU tests check the opcode and leaf tables; the
// wrappers check sizeof(FaParams) and sizeof(GaParams) at load).

#include <cuda_pipeline.h>

#include "ga_fold.cuh"

#define FA_THREADS 256
#define FA_GRID 528
#define GA_ROWS 4  // rows a partials thread walks at once (its tile)

enum { FA_AGG_COUNT = 0, FA_AGG_SUM = 1, FA_AGG_MIN = 2, FA_AGG_MAX = 3 };

struct FaParams {
  const void* col[FA_MAX_COLS];            // payloads: [n_blocks, block_rows] lanes (rle: run values)
  const unsigned char* nul[FA_MAX_COLS];   // bool null masks, or null for NOT NULL columns
  FaEnc enc;                               // how each column loads (program #1)
  const long long* n_valids;               // [n_blocks], or null: n_valid_all for every block
  long long n_valid_all;
  long long n_blocks;
  long long block_rows;
  long long consts[FA_MAX_CONSTS];         // raw 64-bit words (int64 or f64 bits)
  int code[FA_MAX_CODE];
  int n_code;
  int n_cols;
  int n_aggs;
  int agg_kind[FA_MAX_AGGS];
  int agg_f64[FA_MAX_AGGS];
  int cnt_slot[FA_MAX_AGGS];               // row of the count in the packed int64 matrix
  int val_slot[FA_MAX_AGGS];               // row of the value in the int64 or f64 matrix
};

// NaN-propagating, as jnp.minimum / torch.minimum
__device__ __forceinline__ double fa_dmin(double a, double b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ double fa_dmax(double a, double b) { return (a != a || a > b) ? a : b; }

__device__ __forceinline__ long long fa_identity(int kind, bool is_f) {
  if (kind == FA_AGG_MIN) return is_f ? 0x7FF0000000000000LL : 0x7FFFFFFFFFFFFFFFLL;
  if (kind == FA_AGG_MAX) {
    return is_f ? (long long)0xFFF0000000000000ULL : (long long)0x8000000000000000ULL;
  }
  return 0;  // count and sum: int64 0 and f64 +0.0 share the bit pattern
}

__device__ __forceinline__ long long fa_merge(int kind, bool is_f, long long a, long long b) {
  switch (kind) {
    case FA_AGG_SUM: return is_f ? fa_raw(fa_f(a) + fa_f(b)) : fa_wadd(a, b);
    case FA_AGG_MIN: return is_f ? fa_raw(fa_dmin(fa_f(a), fa_f(b))) : (a < b ? a : b);
    case FA_AGG_MAX: return is_f ? fa_raw(fa_dmax(fa_f(a), fa_f(b))) : (a > b ? a : b);
    default: return a;
  }
}

// Partials of the capacity-1 pair, one row per block: [gridDim.x, n_aggs,
// 2] int64 words (count, value bits).  A thread walks the tiles t, t +
// the grid's threads, ... in order (D stack slots) and folds each
// aggregate's live rows, in row order, into its own column of the dynamic
// shared tables s_cnt and s_val [n_aggs][FA_THREADS]; then a fixed-order
// tree over the block's threads, all aggregates at each level.  Tile
// indices are 32-bit (the launcher refuses 2^31 tiles): a 64-bit division
// is a subroutine call, around which the 2-slot instance spilled.  That
// instance (Q6's) fits four blocks an SM in 64 registers, which the walk's
// memory latency needs; the deeper ones take what they need.
template <int D>
__global__ void __launch_bounds__(FA_THREADS, D == 2 ? 4 : 1)
fused_agg_partials(const __grid_constant__ FaParams p, long long* __restrict__ scratch) {
  constexpr int R = GA_ROWS;
  extern __shared__ long long fa_smem[];
  const int A = p.n_aggs;
  const int tid = threadIdx.x;
  u64* s_cnt = (u64*)fa_smem;
  long long* s_val = fa_smem + A * FA_THREADS;
  for (int k = 0; k < A; ++k) {
    s_cnt[k * FA_THREADS + tid] = 0;
    s_val[k * FA_THREADS + tid] = fa_identity(p.agg_kind[k], p.agg_f64[k]);
  }

  const long long rows = p.block_rows;
  const unsigned tpb = (unsigned)((rows + R - 1) / R);  // tiles a block
  const unsigned total = (unsigned)(p.n_blocks * tpb);
  const unsigned stride = gridDim.x * FA_THREADS;
  unsigned t = blockIdx.x * FA_THREADS + tid;
  // (block, tile in block) of tile t, advanced by the stride without a
  // division per tile
  unsigned blk = tpb > 0 ? t / tpb : 0;
  unsigned ti = t - blk * tpb;
  const unsigned step_b = tpb > 0 ? stride / tpb : 0;
  const unsigned step_t = stride - step_b * tpb;
  for (; t < total; t += stride) {
    const long long i0 = (long long)ti * R;
    const long long nv = (p.n_valids != nullptr ? __ldg(p.n_valids + blk) : p.n_valid_all) - i0;
    if (nv > 0) {
      const int n = rows - i0 < R ? (int)(rows - i0) : R;
      const int live = nv < n ? (int)nv : n;
      fa_walk_tile<R, D>(
          p, (long long)blk * rows + i0, blk, i0, n, (1u << live) - 1,
          [&](int k, unsigned on, const long long (&x)[R], unsigned) {
            if (on == 0) return;
            const int at = k * FA_THREADS + tid;
            s_cnt[at] += __popc(on);
            const int kind = p.agg_kind[k];
            if (kind != FA_AGG_COUNT) {
              const bool is_f = p.agg_f64[k];
              long long acc = s_val[at];
#pragma unroll
              for (int r = 0; r < R; ++r) {
                if ((on >> r) & 1) acc = fa_merge(kind, is_f, acc, x[r]);
              }
              s_val[at] = acc;
            }
          },
          [](int, const long long (&)[R], unsigned) {});
    }
    blk += step_b;
    ti += step_t;
    if (ti >= tpb) {
      ti -= tpb;
      ++blk;
    }
  }

  __syncthreads();
  for (int s = FA_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      for (int k = 0; k < A; ++k) {
        const int at = k * FA_THREADS + tid;
        s_cnt[at] += s_cnt[at + s];
        s_val[at] = fa_merge(p.agg_kind[k], p.agg_f64[k], s_val[at], s_val[at + s]);
      }
    }
    __syncthreads();
  }
  for (int k = tid; k < A; k += FA_THREADS) {
    long long* out = scratch + ((long long)blockIdx.x * A + k) * 2;
    out[0] = (long long)s_cnt[k * FA_THREADS];
    out[1] = s_val[k * FA_THREADS];
  }
}

typedef void (*FaPartialsKernel)(FaParams, long long*);

// The instance whose stack holds `slots` operands (2, 4 or 8); nullptr else.
static FaPartialsKernel fa_partials_kernel(int slots) {
  static_assert(FA_MAX_STACK == 8, "the partials instances' slots");
  switch (slots) {
    case 2: return fused_agg_partials<2>;
    case 4: return fused_agg_partials<4>;
    case 8: return fused_agg_partials<8>;
    default: return nullptr;
  }
}

// fa_merge's f64 rules, one type each, for the combine's tree: an f64 sum
// is a plain add (not ga_dadd), min and max fa_dmin and fa_dmax (not
// ga_dmin, ga_dmax), so that the partials' fold and the combine agree.  The
// integer rules are ga_leaf.cuh's GaWadd, GaImin and GaImax, fa_merge's
// expressions.
struct FaFadd {
  static __device__ __forceinline__ long long m(long long a, long long b) {
    return fa_raw(fa_f(a) + fa_f(b));
  }
};
struct FaDmin {
  static __device__ __forceinline__ long long m(long long a, long long b) {
    return fa_raw(fa_dmin(fa_f(a), fa_f(b)));
  }
};
struct FaDmax {
  static __device__ __forceinline__ long long m(long long a, long long b) {
    return fa_raw(fa_dmax(fa_f(a), fa_f(b)));
  }
};

#define FA_COMBINE_ROUNDS 3  // rounds of the tree's parts loaded at once: the grid's 528 in one

// A block of one warp an aggregate folds the partials in block order (the
// first design's 256-thread tree, so the same words, f64 included), merges
// them into the carry (carry first, as jax_eval's `carry + block`) and
// writes the packed state: the first-row leaf at int64 row 0 (block 0),
// then every aggregate's leaves at their slots.  No barrier: each warp's
// rule is picked once.  out may alias carry: each leaf is read before it is
// written, by the same thread.  What bounds it is the partials' bytes, read
// once; at the main paths' few KB, the launch and one or two rounds of
// loads.
__global__ void __launch_bounds__(32)
fused_agg_combine_pack(const __grid_constant__ FaParams p, const long long* __restrict__ scratch,
                       int n_partials, const long long* carry_i, const double* carry_f,
                       long long* out_i, double* out_f) {
  const int k = blockIdx.x;
  const int lane = threadIdx.x;
  if (k == 0 && lane == 0) out_i[0] = carry_i != nullptr ? carry_i[0] : FA_NO_ROW;
  if (k >= p.n_aggs) return;
  const int kind = p.agg_kind[k];
  const bool is_f = p.agg_f64[k];
  const long long id = fa_identity(kind, is_f);
  const long long* src = scratch + 2LL * k;
  const long long stride = 2LL * p.n_aggs;
  longlong2 cv;
  switch (kind) {
    case FA_AGG_SUM:
      cv = is_f ? ga_tree_fold2<FaFadd, FA_COMBINE_ROUNDS>(src, stride, 0, n_partials, lane, id)
                : ga_tree_fold2<GaWadd, FA_COMBINE_ROUNDS>(src, stride, 0, n_partials, lane, id);
      break;
    case FA_AGG_MIN:
      cv = is_f ? ga_tree_fold2<FaDmin, FA_COMBINE_ROUNDS>(src, stride, 0, n_partials, lane, id)
                : ga_tree_fold2<GaImin, FA_COMBINE_ROUNDS>(src, stride, 0, n_partials, lane, id);
      break;
    case FA_AGG_MAX:
      cv = is_f ? ga_tree_fold2<FaDmax, FA_COMBINE_ROUNDS>(src, stride, 0, n_partials, lane, id)
                : ga_tree_fold2<GaImax, FA_COMBINE_ROUNDS>(src, stride, 0, n_partials, lane, id);
      break;
    default:  // a count: its value is not written
      cv = ga_tree_fold2<GaWadd, FA_COMBINE_ROUNDS>(src, stride, 0, n_partials, lane, id);
      break;
  }
  if (lane != 0) return;
  const int cs = p.cnt_slot[k];
  const int vs = p.val_slot[k];
  const u64 c0 = carry_i != nullptr ? (u64)carry_i[cs] : 0;
  out_i[cs] = (long long)(c0 + (u64)cv.x);
  if (kind != FA_AGG_COUNT) {
    if (is_f) {
      const long long v0 = carry_f != nullptr ? fa_raw(carry_f[vs]) : fa_identity(kind, true);
      out_f[vs] = fa_f(fa_merge(kind, true, v0, cv.y));
    } else {
      const long long v0 = carry_i != nullptr ? carry_i[vs] : fa_identity(kind, false);
      out_i[vs] = fa_merge(kind, false, v0, cv.y);
    }
  }
}

// ---------------------------------------------------------------------------
// Grouped: fused_group_agg_partials + fused_group_agg_combine_pack
// ---------------------------------------------------------------------------
//
// The same walk, then a group id per row and per-group leaves.  A leaf is
// one row of the packed state (jax_eval._pack_state's order: the
// first-active-row tracker, then each aggregate's carry leaves); its kind
// says how a row contributes and how two values merge.

#define GA_WARPS (FA_THREADS / 32)

struct GaParams {
  const void* col[FA_MAX_COLS];            // payloads: [n_blocks, block_rows] lanes (rle: run values)
  const unsigned char* nul[FA_MAX_COLS];   // bool null masks, or null for NOT NULL columns
  FaEnc enc;                               // how each column loads (program #1)
  const long long* n_valids;               // [n_blocks], or null: n_valid_all for every block
  const long long* offsets;                // [n_blocks] global row of each block's row 0, or null: offset_all
  const int* gids;                         // host group ids [n_blocks, block_rows], or null: coded
  long long n_valid_all;
  long long offset_all;
  long long n_blocks;
  long long block_rows;
  long long consts[FA_MAX_CONSTS];
  long long leaf_ident[GA_MAX_LEAVES];     // identity of each leaf, raw 64-bit word
  int code[FA_MAX_CODE];
  int n_code;
  int n_cols;
  int n_aggs;
  int n_leaves;
  int capacity;                            // C: group slots
  int track;                               // leaf 0 tracks the first active row (GROUP BY)
  int n_keys;                              // coded ids: key columns (0: every row in slot 0)
  int key_slot[GA_MAX_KEYS];               // column slot of each key's dictionary codes
  int key_dlen[GA_MAX_KEYS];               // its dictionary's length; NULL is code dlen
  int agg_leaf0[FA_MAX_AGGS];              // first leaf of aggregate k
  int agg_nleaves[FA_MAX_AGGS];
  // per-leaf tables as bytes, which keeps the block (and the combine's
  // parameters with it) under the 4 KB kernel-parameter limit
  signed char leaf_kind[GA_MAX_LEAVES];
  signed char leaf_f64[GA_MAX_LEAVES];      // the leaf is stored as f64
  signed char leaf_arg_f64[GA_MAX_LEAVES];  // its aggregate's argument lane is f64
  signed char leaf_slot[GA_MAX_LEAVES];     // row in the packed int64 or f64 matrix
  signed char leaf_agg[GA_MAX_LEAVES];      // aggregate of the leaf, -1 for the tracker
  signed char leaf_aux[GA_MAX_LEAVES];      // GA_FIRSTVAL: index of its GA_FIRSTROW leaf
};

// f / d for 0 <= f < 2^52 and d >= 1 with no 64-bit division (a subroutine
// whose call frame is local memory): the quotient from an f32 reciprocal
// refined twice in f64 is within one, and the remainder corrects it.
__device__ __forceinline__ long long ga_div(long long f, long long d) {
  const double dd = (double)d;
  double r = (double)__fdividef(1.0f, (float)d);
  r = r * fma(-dd, r, 2.0);
  r = r * fma(-dd, r, 2.0);
  long long q = (long long)((double)f * r);
  long long rem = f - q * d;
  while (rem < 0) {
    --q;
    rem += d;
  }
  while (rem >= d) {
    ++q;
    rem -= d;
  }
  return q;
}

// Global row of flat index f (block * block_rows + row): the block's offset
// plus the row; FA_NO_ROW stays.
__device__ __forceinline__ long long ga_global_row(const GaParams& p, long long f) {
  if (f >= FA_NO_ROW) return FA_NO_ROW;
  const long long blk = ga_div(f, p.block_rows);
  const long long off = p.offsets != nullptr ? __ldg(p.offsets + blk) : p.offset_all;
  return off + (f - blk * p.block_rows);
}

// Exact integer merges of a whole leaf value into device memory.
__device__ __forceinline__ void ga_atomic(int kind, long long* dst, long long v) {
  switch (kind) {
    case GA_COUNT:
    case GA_SUM: atomicAdd((u64*)dst, (u64)v); break;
    case GA_MIN:
    case GA_TRACK:
    case GA_FIRSTROW: atomicMin(dst, v); break;
    case GA_MAX: atomicMax(dst, v); break;
    case GA_AND: atomicAnd((u64*)dst, (u64)v); break;
    case GA_OR: atomicOr((u64*)dst, (u64)v); break;
    case GA_XOR: atomicXor((u64*)dst, (u64)v); break;
    default: break;
  }
}


// Partials of every leaf for every group slot, C <= C_MAX, [gridDim.x,
// n_leaves, C] int64 words (f64 as bits), one row per block, by the tile
// walk and fold of ga_fold.cuh (shared with batch_partials): GA_ROWS rows of
// one block a thread, the tile's group ids (host ids or the key codes' mixed
// radix) once a tile, integer leaves by shared-memory atomics into the row
// of the thread's lane group, f64 leaves folded in lane order by the lowest
// lane of each id, the tracker by that lane with a plain store; at the end
// the rows fold in warp order.  Every f64 leaf is therefore summed in one
// fixed order: reruns are bit-identical.  Dynamic shared memory: GA_WARPS *
// n_leaves * (32 + C) * 8 bytes, so
//     C_MAX = GA_SMEM_MAX / (GA_WARPS * 8 * n_leaves) - 32
// (331 group slots for TPC-H Q1's 10 leaves; 1,784 for one count).  Past
// C_MAX the grouped pair is group_wide_partials + group_wide_combine.  D:
// the stack slots of the tile walk (the launcher's pick from the plan's
// depth).
template <int D>
__global__ void __launch_bounds__(FA_THREADS)
fused_group_agg_partials(const __grid_constant__ GaParams p, long long* __restrict__ out) {
  extern __shared__ long long ga_smem[];
  const int L = p.n_leaves;
  const int C = p.capacity;
  const int warp = threadIdx.x >> 5;
  long long* stage = ga_smem + (long long)warp * L * 32;  // [L][32]: f64 values, a keyless fold
  long long* wrows = ga_smem + (long long)GA_WARPS * L * 32;  // [GA_WARPS][L][C]
  long long* mine = wrows + (long long)warp * L * C;
  ga_rows_init<FA_THREADS>(p, stage, wrows, p.gids != nullptr || p.n_keys > 0);
  __syncthreads();
  ga_walk_tiles<GA_ROWS, D, FA_THREADS>(
      p, p.gids,
      [&](long long b) { return p.n_valids != nullptr ? __ldg(p.n_valids + b) : p.n_valid_all; },
      blockIdx.x, gridDim.x, stage, mine);
  __syncthreads();
  ga_rows_out<FA_THREADS>(p, wrows, out + (long long)blockIdx.x * L * C);
}

typedef void (*GaPartialsKernel)(GaParams, long long*);

// The instance whose stack holds `slots` operands (2, 4 or 8); nullptr else.
static GaPartialsKernel ga_partials_kernel(int slots) {
  static_assert(FA_MAX_STACK == 8, "the partials instances' slots");
  switch (slots) {
    case 2: return fused_group_agg_partials<2>;
    case 4: return fused_group_agg_partials<4>;
    case 8: return fused_group_agg_partials<8>;
    default: return nullptr;
  }
}

// ---------------------------------------------------------------------------
// The wide route: any capacity, state in device memory, exact in any order
// ---------------------------------------------------------------------------
//
// Past C_MAX the group state does not fit one block's shared memory, and a
// [grid, n_leaves, C] copy per block in device memory would cost 528 * L * C
// words (11 GB for Q1's 10 leaves at 262,144 slots).  group_wide_partials
// keeps one state, words [n_leaves, C] plus an exact accumulator per f64
// sum cell, and every update is an integer atomic whose result does not
// depend on the order the rows arrive in:
//   * integer leaves: the lanes of one group fold in lane order, then one
//     64-bit atomic (add as unsigned words, min, max, and, or, xor); the
//     tracker and first's row take the minimum flat row;
//   * f64 min and max: atomicMin/atomicMax on an order-preserving key of the
//     folded value (ga_fkey), NaN the least key for min and the greatest for
//     max, -0.0 below +0.0: XLA's semantics, as ga_dmin/ga_dmax;
//   * f64 sums (REAL sum, the sum of squares): each row's value is added
//     exactly into GA_XW signed 64-bit words, word k counting units of
//     2^(32k - 1074) (ga_xadd: at most three atomicAdds a value); NaN and
//     the infinities set bits of the cell's word.  No rounding happens
//     until the combine, which rounds the exact sum to nearest (gw_xround):
//     the result is the same whatever the order, the grid or the device.
// Scratch: GA_XW * 8 = 528 bytes a f64 sum cell; at 262,144 slots 138 MB a
// leaf.  A word takes at most one add of < 2^32 a row, so it cannot
// overflow below 2^31 rows a launch.
// first's value is read at the winning row by the combine (ga_finish_cell:
// the tile walk over that one row).

#define GA_XW 66
#define GA_XFLAG_POSINF 1
#define GA_XFLAG_NEGINF 2
#define GA_XFLAG_NAN 4
#define GA_LLMAX 0x7FFFFFFFFFFFFFFFLL
#define GA_LLMIN (-GA_LLMAX - 1)
#define GA_QNAN 0x7FF8000000000000LL

__host__ __device__ __forceinline__ bool ga_xleaf(int kind, bool is_f) {
  return is_f && (kind == GA_SUM || kind == GA_SUMSQ);
}

// order-preserving key of a double: negative values flip their magnitude
// bits, so the keys order as the values do with -0.0 below +0.0; NaN is the
// least key for min and the greatest for max (it propagates)
__device__ __forceinline__ long long ga_fkey(double x, bool is_max) {
  if (x != x) return is_max ? GA_LLMAX : GA_LLMIN;
  const long long b = fa_raw(x);
  return b < 0 ? b ^ GA_LLMAX : b;
}
__device__ __forceinline__ double ga_funkey(long long k, bool is_max) {
  if (k == (is_max ? GA_LLMAX : GA_LLMIN)) return fa_f(GA_QNAN);
  return fa_f(k < 0 ? k ^ GA_LLMAX : k);
}

// Add v exactly to the accumulator `cell` (GA_XW words), its specials to
// `flags`.  v = m * 2^(pos - 1074): m's 53 bits shifted to bit pos spread
// over three 32-bit digits from word pos / 32.
__device__ __forceinline__ void ga_xadd(long long* flags, long long* cell, double v) {
  const long long b = fa_raw(v);
  const int e = (int)((b >> 52) & 0x7FF);
  unsigned long long m = (unsigned long long)b & 0xFFFFFFFFFFFFFULL;
  if (e == 0x7FF) {
    const unsigned long long bit = m ? GA_XFLAG_NAN : b < 0 ? GA_XFLAG_NEGINF : GA_XFLAG_POSINF;
    atomicOr((unsigned long long*)flags, bit);
    return;
  }
  if (e) m |= 1ULL << 52;
  if (m == 0) return;
  const int pos = e ? e - 1 : 0;
  const int sh = pos & 31;
  unsigned long long* w = (unsigned long long*)(cell + (pos >> 5));
  const unsigned long long hi = m >> (32 - sh);
  const unsigned long long d[3] = {(m << sh) & 0xFFFFFFFFULL, hi & 0xFFFFFFFFULL, hi >> 32};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (d[q]) atomicAdd(w + q, b < 0 ? 0ULL - d[q] : d[q]);
  }
}

// One device-memory atomic merging acc, the fold of a row's lanes of one
// group, into the state word of its cell: integer leaves as they are, f64
// min and max as order-preserving keys.
__device__ __forceinline__ void gw_atomic(int kind, bool is_f, long long* word, long long acc) {
  if (!is_f) {
    ga_atomic(kind, word, acc);
  } else if (kind == GA_MAX) {
    atomicMax(word, ga_fkey(fa_f(acc), true));
  } else {
    atomicMin(word, ga_fkey(fa_f(acc), false));
  }
}

// One selected row a lane (`mine`; flat row f, row i of block blk) of the
// wide route's partials through the walk: its group id, then for
// aggregate k the lanes whose row is live match their ids
// (__match_any_sync, once for live rows that differ from the last
// aggregate's), each f64 sum cell takes every live lane's value exactly
// (ga_xadd), and for every other leaf the lowest live lane of each id takes
// one atomic: of its own contribution where no two live lanes share an id
// (the rule for many groups), else of its lanes' contributions folded in
// lane order, staged in shared memory.  Every update commutes, so the state
// is the same whatever the order of the rows.  Then the tracker (leaf 0):
// each group's least active flat row.  Every warp-wide operation sits in a
// branch that is uniform across the warp.
template <int D>
__device__ __forceinline__ void gw_row(const GaParams& p, long long* __restrict__ words,
                                       long long* __restrict__ xacc, const signed char* xidx,
                                       long long* stage, long long f, long long blk, long long i,
                                       bool mine) {
  constexpr unsigned FULL = 0xFFFFFFFFu;
  const int C = p.capacity;
  const int lane = threadIdx.x & 31;
  int gid[1] = {0};
  const unsigned ok = mine ? ga_tile_ids<1>(p, p.gids, f, blk, i, 1, gid) : 0;
  const int g = gid[0];
  unsigned matched = ~0u;  // the live rows `same` was matched for
  unsigned same = 0;
  const unsigned active = fa_walk_tile<1, D>(
      p, f, blk, i, mine ? 1 : 0, ok,
      [&](int k, unsigned live, const long long (&x)[1], unsigned) {
        const bool on = live & 1;
        if (!__any_sync(FULL, on)) return;
        if (__any_sync(FULL, live != matched)) {
          same = __match_any_sync(FULL, on ? g : -1);
          matched = live;
        }
        const unsigned m = same & __ballot_sync(FULL, on);  // the live lanes of this id
        const bool lead = on && lane == __ffs(m) - 1;
        const bool fold = __any_sync(FULL, (m & (m - 1)) != 0);
        const int l0 = p.agg_leaf0[k];
        for (int l = l0; l < l0 + p.agg_nleaves[k]; ++l) {
          const int kind = p.leaf_kind[l];
          if (kind == GA_FIRSTVAL) continue;  // read at the winning row by the combine
          const long long c = ga_contrib(p, l, on, x[0], f);
          long long* word = words + (long long)l * C + g;
          if (xidx[l] >= 0) {
            // every lane adds its own value: exact, so no fold is needed
            if (on) ga_xadd(word, xacc + ((long long)xidx[l] * C + g) * GA_XW, fa_f(c));
            continue;
          }
          const bool is_f = p.leaf_f64[l];
          long long acc = c;
          if (fold) {
            stage[lane] = c;
            __syncwarp();
            if (lead) {
              acc = p.leaf_ident[l];
              for (unsigned b = m; b != 0; b &= b - 1) {
                acc = ga_merge(kind, is_f, acc, stage[__ffs(b) - 1]);
              }
            }
            __syncwarp();
          }
          if (lead && acc != p.leaf_ident[l]) gw_atomic(kind, is_f, word, acc);
        }
      },
      [](int, const long long (&)[1], unsigned) {});
  if (p.track) {
    const bool on = active & 1;
    if (__any_sync(FULL, on)) {
      const unsigned peers = __match_any_sync(FULL, on ? g : -1);
      if (on && lane == __ffs(peers) - 1) atomicMin(words + g, f);
    }
  }
}

#define GW_QUEUE 256  // a warp's ring of selected rows: 31 left over, 128 a step

// words [n_leaves, C] at the wrapper's initial words (wide_idents), xacc
// [n_xleaves, C, GA_XW] zeros.  The tiles of GA_ROWS rows of one block go
// to the grid's warps as in fused_group_agg_partials (D stack slots).
// Selection first: a warp step walks its tiles' conjuncts alone (a Select
// walk stops at the first aggregate) and queues the rows they keep in the
// warp's ring in shared memory; every 32 queued rows walk again, one a lane
// (gw_row), the aggregates' arguments, group ids and folds for the rows
// kept alone.  A selective plan (TPC-H Q15's window keeps 4% of the rows)
// so spends its walk of the aggregates and its folds on full warps; a plan
// that keeps every row pays the conjuncts twice (a dense walk of the tile
// in place was measured no faster, and is not kept).
template <int D>
__global__ void __launch_bounds__(FA_THREADS)
group_wide_partials(const __grid_constant__ GaParams p, long long* __restrict__ words,
                    long long* __restrict__ xacc) {
  constexpr int R = GA_ROWS;
  constexpr unsigned FULL = 0xFFFFFFFFu;
  static_assert((GW_QUEUE & (GW_QUEUE - 1)) == 0 && GW_QUEUE >= 31 + 32 * R, "the queue's ring");
  __shared__ long long gw_stage[FA_THREADS];   // a warp's 32 contributions to one leaf
  __shared__ int gw_qblk[GA_WARPS][GW_QUEUE];  // queued rows: block
  __shared__ int gw_qrow[GA_WARPS][GW_QUEUE];  // and row in block
  __shared__ signed char xidx[GA_MAX_LEAVES];  // each f64 sum leaf's accumulator
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long* stage = gw_stage + warp * 32;
  int* qblk = gw_qblk[warp];
  int* qrow = gw_qrow[warp];
  if (threadIdx.x == 0) {
    int x = 0;
    for (int l = 0; l < p.n_leaves; ++l) {
      xidx[l] = ga_xleaf(p.leaf_kind[l], p.leaf_f64[l]) ? x++ : -1;
    }
  }
  __syncthreads();

  // 32-bit tile indices, as fused_agg_partials'
  const long long rows = p.block_rows;
  const unsigned tpb = (unsigned)((rows + R - 1) / R);  // tiles a block
  const unsigned total = (unsigned)(p.n_blocks * tpb);
  const unsigned stride = gridDim.x * FA_THREADS;
  unsigned base = blockIdx.x * FA_THREADS + warp * 32;
  unsigned t = base + lane;
  unsigned blk = tpb > 0 ? t / tpb : 0;
  unsigned ti = t - blk * tpb;
  const unsigned step_b = tpb > 0 ? stride / tpb : 0;
  const unsigned step_t = stride - step_b * tpb;
  // the warp's queue: `queued` rows from ring slot `head`, the same in
  // every lane
  int head = 0, queued = 0;

  // one row a lane for the queue's first `cnt` rows
  auto round = [&](int cnt) {
    const bool mine = lane < cnt;
    const int at = (head + lane) & (GW_QUEUE - 1);
    const long long b1 = mine ? qblk[at] : 0;
    const long long i1 = mine ? qrow[at] : 0;
    head = (head + cnt) & (GW_QUEUE - 1);
    queued -= cnt;
    gw_row<D>(p, words, xacc, xidx, stage, b1 * rows + i1, b1, i1, mine);
  };

  // every lane of a warp runs the same steps (the loop is on the warp's
  // first tile), so the warp-wide operations see all 32 lanes
  for (; base < total; base += stride, t += stride) {
    long long i0 = 0, f0 = 0;
    int n = 0;
    unsigned valid = 0;
    if (t < total) {
      i0 = (long long)ti * R;
      f0 = (long long)blk * rows + i0;
      n = rows - i0 < R ? (int)(rows - i0) : R;
      const long long nv = (p.n_valids != nullptr ? __ldg(p.n_valids + blk) : p.n_valid_all) - i0;
      const int live = nv <= 0 ? 0 : nv < n ? (int)nv : n;
      valid = (1u << live) - 1;
    }
    if (__any_sync(FULL, valid != 0)) {
      const unsigned act = fa_walk_tile<R, D, false, true>(
          p, f0, blk, i0, n, valid, [](int, unsigned, const long long (&)[R], unsigned) {},
          [](int, const long long (&)[R], unsigned) {});
      // this lane's place among the warp's selected rows, and their number
      const int mine = __popc(act);
      const unsigned lower = (1u << lane) - 1;
      int before = 0, selected = 0;
#pragma unroll
      for (int bit = 0; bit < 3; ++bit) {
        const unsigned b = __ballot_sync(FULL, (mine >> bit) & 1);
        before += __popc(b & lower) << bit;
        selected += __popc(b) << bit;
      }
      if (selected > 0) {
        __syncwarp();  // the last round's reads of the ring are done
        int at = head + queued + before;
        for (unsigned b = act; b != 0; b &= b - 1, ++at) {
          qblk[at & (GW_QUEUE - 1)] = (int)blk;
          qrow[at & (GW_QUEUE - 1)] = (int)i0 + __ffs(b) - 1;
        }
        queued += selected;
        __syncwarp();
        while (queued >= 32) round(32);
      }
    }
    blk += step_b;
    ti += step_t;
    if (ti >= tpb) {
      ti -= tpb;
      ++blk;
    }
  }
  if (queued > 0) round(queued);
}

typedef void (*GwPartialsKernel)(GaParams, long long*, long long*);

static GwPartialsKernel gw_partials_kernel(int slots) {
  switch (slots) {
    case 2: return group_wide_partials<2>;
    case 4: return group_wide_partials<4>;
    case 8: return group_wide_partials<8>;
    default: return nullptr;
  }
}

// The end of a combine for one (leaf l, group g) cell: `blk` is this
// launch's partials of the leaf folded together (of first's row leaf, for
// first's value leaf), c0 the cell's carried word (the identity with no
// carry).  Merges blk into the carry (carry first, as jax_eval's `carry +
// block`), turns the tracker's flat row index into a global row, and for
// `first` reads the value at the winning row (the tile walk once more, one
// row, D stack slots in registers) and writes the value and the row leaf
// together.  out may alias carry: each cell is read and then written by one
// thread, and first's row leaf is skipped by the callers and written here.
template <int D>
__device__ __forceinline__ void ga_finish_cell(const GaParams& p, int l, int g, long long blk,
                                               long long c0, const long long* carry_i,
                                               long long* out_i, double* out_f) {
  const int C = p.capacity;
  const int kind = p.leaf_kind[l];
  const bool is_f = p.leaf_f64[l];
  const long long cell = (long long)p.leaf_slot[l] * C + g;
  long long res;
  if (kind == GA_FIRSTVAL) {
    const long long rcell = (long long)p.leaf_slot[p.leaf_aux[l]] * C + g;
    const long long row = ga_global_row(p, blk);
    const long long crow = carry_i == nullptr ? FA_NO_ROW : carry_i[rcell];
    res = c0;
    if (row < crow) {
      const int want = p.leaf_agg[l];
      const long long b = ga_div(blk, p.block_rows);  // blk: the winning flat row
      fa_walk_tile<1, D>(
          p, blk, b, blk - b * p.block_rows, 1, 1u,
          [&](int k, unsigned, const long long (&x)[1], unsigned) {
            if (k == want) res = x[0];
          },
          [](int, const long long (&)[1], unsigned) {});
    }
    out_i[rcell] = row < crow ? row : crow;
  } else {
    if (kind == GA_TRACK) blk = ga_global_row(p, blk);
    res = ga_merge_ordered(kind, is_f, c0, blk);
  }
  if (is_f) {
    out_f[cell] = fa_f(res);
  } else {
    out_i[cell] = res;
  }
}

// The leaf whose partials a cell folds: first's value leaf folds its row
// leaf (the winning row); -1 for first's row leaf, which its value leaf writes.
__device__ __forceinline__ int ga_folded_leaf(const GaParams& p, int l) {
  const int kind = p.leaf_kind[l];
  if (kind == GA_FIRSTROW) return -1;
  return kind == GA_FIRSTVAL ? p.leaf_aux[l] : l;
}

#define GA_COMBINE_ROUNDS 2  // rounds past the tree's first loaded at once: 768 parts in two

// Folds the shared-memory partials [n_parts, n_leaves, C] (one row per block
// of fused_group_agg_partials) into the carry and writes the packed state
// [n_int, C] / [n_f64, C]: a block of one warp a (leaf, group) cell, so
// that the cells' loads spread over the SMs; no barrier.  The warp runs the combine's tree of GA_TREE threads
// (ga_tree_fold, ga_leaf.cuh: part q into tree thread q mod 256 in ascending
// q, then the halving tree, in registers and shuffles), its leaf's merge
// rule picked once (ga_with_rule), the loads of up to 768 parts in two
// rounds (the partials grid is at most FA_GRID rows); lane 0 finishes the
// cell (ga_finish_cell: the carry, the tracker's global row, first's value
// by the tile walk of D stack slots).  The order is fixed, so f64 cells
// come out bit-identical from run to run, and it is the one mesh_fold keeps
// (the same function), so the two give the same words.  What bounds it is
// the partials' bytes, read once; at the main paths' few KB the launch and
// one or two rounds of loads.

template <int D>
__global__ void __launch_bounds__(32)
fused_group_agg_combine_pack(const __grid_constant__ GaParams p,
                             const long long* __restrict__ parts, int n_parts,
                             const long long* carry_i, const double* carry_f,
                             long long* out_i, double* out_f) {
  const int C = p.capacity;
  const int L = p.n_leaves;
  const int lane = threadIdx.x;
  // 32-bit cells (the launcher keeps them below 2^31): no 64-bit division
  const int cell = (int)blockIdx.x;
  const int l = cell / C;
  const int g = cell - l * C;
  const int fl = ga_folded_leaf(p, l);
  if (fl < 0) return;
  const long long id = p.leaf_ident[fl];
  const long long* src = parts + (long long)fl * C + g;
  long long blk = id;
  ga_with_rule(p.leaf_kind[fl], p.leaf_f64[fl], [&](auto rule) {
    blk = ga_tree_fold<decltype(rule), GA_COMBINE_ROUNDS>(src, (long long)L * C, 0, n_parts, lane,
                                                          id);
  });
  if (lane != 0) return;
  const bool is_f = p.leaf_f64[l];
  const long long at = (long long)p.leaf_slot[l] * C + g;
  const long long c0 = carry_i == nullptr ? p.leaf_ident[l]
                     : is_f ? fa_raw(carry_f[at]) : carry_i[at];
  ga_finish_cell<D>(p, l, g, blk, c0, carry_i, out_i, out_f);
}

typedef void (*GaCombineKernel)(GaParams, const long long*, int, const long long*, const double*,
                                long long*, double*);

// The instance whose walk (first's value) holds `slots` operands (2, 4 or
// 8); nullptr else.
static GaCombineKernel ga_combine_kernel(int slots) {
  switch (slots) {
    case 2: return fused_group_agg_combine_pack<2>;
    case 4: return fused_group_agg_combine_pack<4>;
    case 8: return fused_group_agg_combine_pack<8>;
    default: return nullptr;
  }
}

// ---------------------------------------------------------------------------
// group_wide_combine: a block a run of slots, the sum cells staged
// ---------------------------------------------------------------------------
//
// An f64 sum cell is 66 words (528 bytes): a warp that reads one word of
// each of 32 cells touches 32 lines, and 67 digits in an array indexed at
// run time live in local memory.  So a block takes GW_SLOTS consecutive
// slots, a thread each.  The cells of the slots' first
// REAL-sum leaf, contiguous in the state, go to shared memory by cp.async
// (16 bytes a copy, coalesced) at once; while they are in flight each
// thread finishes its slot's other leaves, their words and carries loaded
// GW_CHUNK leaves at a time; then each thread carries its own cell's words
// from shared memory (16 bytes a load, conflict-free at a cell's 528-byte
// stride) and keeps only what the rounding reads, in registers; the next sum
// leaf's cells are staged while it merges the result into the carry.  No
// walk with its stack in memory: first's value comes from the tile walk at
// the winning row.  What bounds it is the state's bytes, read once (528
// bytes a sum cell).

#define GW_SLOTS 64  // slots a combine block takes: 33 KB of staged sum cells
#define GW_CHUNK 8   // leaves whose words a combine thread loads at once

// What the rounding reads of a cell's 67 digits: the highest nonzero digit
// h (-1: none), the digits h, h - 1 and h - 2 (0 below digit 0), and the
// lowest nonzero digit lo.
struct GwDigits {
  int h, lo;
  unsigned x0, x1, x2;
};

// The words of a cell in shared memory (GA_XW of them, 16-byte aligned),
// negated with `neg`, carried into 32-bit digits word by word, digit GA_XW
// the carry out of the top word; returns that carry (negative: the sum is).
__device__ __forceinline__ long long gw_digits(const long long* s, bool neg, GwDigits& r) {
  long long c = 0;
  unsigned p1 = 0, p2 = 0;  // the two digits below the current one
  r.h = -1;
  r.lo = GA_XW + 1;
  r.x0 = r.x1 = r.x2 = 0;
  auto digit = [&](int k, unsigned d) {
    if (d != 0) {
      r.h = k;
      r.x0 = d;
      r.x1 = p1;
      r.x2 = p2;
      r.lo = r.lo < k ? r.lo : k;
    }
    p2 = p1;
    p1 = d;
  };
#pragma unroll 3
  for (int k2 = 0; k2 < GA_XW / 2; ++k2) {
    const longlong2 q = ((const longlong2*)s)[k2];
    long long v = (neg ? -q.x : q.x) + c;
    c = v >> 32;
    digit(2 * k2, (unsigned)v);
    v = (neg ? -q.y : q.y) + c;
    c = v >> 32;
    digit(2 * k2 + 1, (unsigned)v);
  }
  digit(GA_XW, (unsigned)c);
  return c;
}

// 2^e for e in [-1022, 1023], from its bits.
__device__ __forceinline__ double gw_pow2(int e) { return fa_f((long long)(e + 1023) << 52); }

// The exact sum held in the cell at `s` (shared memory; GA_XW words, word k
// counting units of 2^(32k - 1074)) rounded to the nearest double, ties to
// even; copr/fused_group_agg.py:_xround is its plain version.  The words
// carry into 32-bit digits (again from the negated words when the top carry
// says the sum is negative); the 62 bits from the leading one down (the
// bits below as a sticky bit) round to 53, scaled by exact powers of two (a
// result in the subnormal range has no bits below 2^-1074 to lose).
__device__ __forceinline__ double gw_xround(const long long* s) {
  GwDigits r;
  const bool neg = gw_digits(s, false, r) < 0;
  if (neg) gw_digits(s, true, r);
  if (r.h < 0) return 0.0;
  const int h = r.h;
  bool sticky = r.lo < h - 2;  // a digit below the three
  const int top = 32 * h + 31 - __clz(r.x0);  // the leading one's bit
  const int t = top - 61;                       // the window's lowest bit
  long long win = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (h - j < 0) break;
    const int sh = 32 * (h - j) - t;
    const long long v = j == 0 ? r.x0 : j == 1 ? r.x1 : r.x2;
    if (sh >= 0) {
      win |= v << sh;
    } else {
      win |= v >> -sh;
      sticky = sticky || (v & ((1LL << -sh) - 1)) != 0;
    }
  }
  long long mant = win >> 9;
  const long long rem = (win & 0x1FF) | (sticky ? 1 : 0);
  if (rem > 0x100 || (rem == 0x100 && (mant & 1))) ++mant;
  const int e = t + 9 - 1074;
  const int e1 = e > -1000 ? e : -1000;
  const double res = (double)mant * gw_pow2(e1) * gw_pow2(e - e1);
  return neg ? -res : res;
}

// The wide route's combine: block b takes slots [b * GW_SLOTS, ...), a
// thread a slot; every leaf but the REAL sums (an integer word, a decoded
// min/max key, the tracker, first) through ga_finish_cell, then each REAL-sum
// leaf of `xmask` in order: its cells staged in shared memory, each rounded
// by its thread (gw_xround; NaN where a NaN or both infinities were added,
// else an infinity where one was) and merged into the carry as
// ga_finish_cell merges it.  Every output cell is written by one thread, so
// out may alias carry.
template <int D>
__global__ void __launch_bounds__(GW_SLOTS)
group_wide_combine(const __grid_constant__ GaParams p, const long long* __restrict__ words,
                   const long long* __restrict__ xacc, const long long* carry_i,
                   const double* carry_f, long long* out_i, double* out_f,
                   unsigned long long xmask) {
  __shared__ __align__(16) long long stage[GW_SLOTS * GA_XW];
  const int C = p.capacity;
  const int tid = threadIdx.x;
  const long long g0 = (long long)blockIdx.x * GW_SLOTS;
  const int n = C - g0 < GW_SLOTS ? (int)(C - g0) : GW_SLOTS;  // the block's slots
  const int g = (int)g0 + tid;
  const bool mine = tid < n;
  // leaf x's cells of the block's slots, contiguous: GA_XW / 2 16-byte
  // copies a cell where 16-byte aligned, else GA_XW of 8 bytes
  auto stage_cells = [&](int x) {
    const long long* src = xacc + ((long long)x * C + g0) * GA_XW;
    if (((unsigned long long)src & 15) == 0) {
      for (int i = tid; i < n * (GA_XW / 2); i += GW_SLOTS) {
        __pipeline_memcpy_async(stage + 2 * i, src + 2 * i, 16);
      }
    } else {
      for (int i = tid; i < n * GA_XW; i += GW_SLOTS) {
        __pipeline_memcpy_async(stage + i, src + i, 8);
      }
    }
    __pipeline_commit();
  };
  if (xmask != 0) stage_cells(0);
  if (mine) {
    for (int l0 = 0; l0 < p.n_leaves; l0 += GW_CHUNK) {
      long long w[GW_CHUNK], c0[GW_CHUNK];
#pragma unroll
      for (int j = 0; j < GW_CHUNK; ++j) {  // the chunk's loads all in flight
        const int l = l0 + j < p.n_leaves ? l0 + j : l0;
        const int fl = ga_folded_leaf(p, l);
        const bool f = p.leaf_f64[l];
        const bool on = l0 + j < p.n_leaves && fl >= 0 && !ga_xleaf(p.leaf_kind[l], f);
        const long long cell = (long long)p.leaf_slot[l] * C + g;
        w[j] = on ? words[(long long)fl * C + g] : 0;
        c0[j] = !on || carry_i == nullptr ? p.leaf_ident[l]
              : f ? fa_raw(carry_f[cell]) : carry_i[cell];
      }
      const int end = p.n_leaves - l0 < GW_CHUNK ? p.n_leaves - l0 : GW_CHUNK;
      for (int j = 0; j < end; ++j) {  // one copy of the finish: w[j] by selects
        const int l = l0 + j;
        const int kind = p.leaf_kind[l];
        const bool f = p.leaf_f64[l];
        if (ga_folded_leaf(p, l) < 0 || ga_xleaf(kind, f)) continue;
        long long wj = w[0], cj = c0[0];
#pragma unroll
        for (int i = 1; i < GW_CHUNK; ++i) {
          wj = i == j ? w[i] : wj;
          cj = i == j ? c0[i] : cj;
        }
        const long long blk = f && (kind == GA_MIN || kind == GA_MAX)
                                  ? fa_raw(ga_funkey(wj, kind == GA_MAX)) : wj;
        ga_finish_cell<D>(p, l, g, blk, cj, carry_i, out_i, out_f);
      }
    }
  }
  int x = 0;
  for (unsigned long long m = xmask; m != 0; m &= m - 1, ++x) {
    const int l = __ffsll((long long)m) - 1;
    const long long cell = (long long)p.leaf_slot[l] * C + g;
    const long long flags = mine ? words[(long long)l * C + g] : 0;
    const long long c0 = !mine || carry_i == nullptr ? p.leaf_ident[l] : fa_raw(carry_f[cell]);
    __pipeline_wait_prior(0);
    __syncthreads();
    double total = 0.0;
    if ((flags & GA_XFLAG_NAN) || (flags & 3) == 3) {
      total = fa_f(GA_QNAN);
    } else if (flags & GA_XFLAG_POSINF) {
      total = fa_f(0x7FF0000000000000LL);
    } else if (flags & GA_XFLAG_NEGINF) {
      total = fa_f((long long)0xFFF0000000000000ULL);
    } else if (mine) {
      total = gw_xround(stage + tid * GA_XW);
    }
    __syncthreads();  // every cell read before the next leaf's are staged
    if ((m & (m - 1)) != 0) stage_cells(x + 1);
    if (mine) out_f[cell] = fa_f(ga_merge_ordered(p.leaf_kind[l], true, c0, fa_raw(total)));
  }
}

typedef void (*GwCombineKernel)(GaParams, const long long*, const long long*, const long long*,
                                const double*, long long*, double*, unsigned long long);

static GwCombineKernel gw_combine_kernel(int slots) {
  switch (slots) {
    case 2: return group_wide_combine<2>;
    case 4: return group_wide_combine<4>;
    case 8: return group_wide_combine<8>;
    default: return nullptr;
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed explicitly.
template <class K, class... Args>
static int ga_launch_smem(K kernel, int grid, int smem_bytes, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, FA_THREADS, smem_bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

extern "C" {

int fa_params_size(void) { return (int)sizeof(FaParams); }
int fa_grid(void) { return FA_GRID; }
int fa_threads(void) { return FA_THREADS; }

// cudaFuncGetAttributes of a kernel: registers a thread, local and static
// shared bytes, into out[0..3).
static int kernel_attributes(const void* k, int* out) {
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, k);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

// Each launcher returns cudaGetLastError() right after its launch: a launch
// that is refused (too many threads, too much shared memory) never runs, and a
// later synchronize would not say so.

// scratch: [grid, n_aggs, 2]; the instance of `slots` stack slots
// (cudaErrorInvalidValue for another count); dynamic shared memory n_aggs *
// FA_THREADS * 16 bytes
int fa_launch_partials(const FaParams* p, long long* scratch, int grid, int slots,
                       void* stream) {
  const FaPartialsKernel k = fa_partials_kernel(slots);
  if (k == nullptr || grid < 1 || grid > FA_GRID) return (int)cudaErrorInvalidValue;
  return ga_launch_smem(k, grid, p->n_aggs * FA_THREADS * 16, stream, *p, scratch);
}

int fa_partials_attributes(int slots, int* out) {
  return kernel_attributes((const void*)fa_partials_kernel(slots), out);
}

// a block of one warp an aggregate (one block when there is none: the
// tracker's word)
int fa_launch_combine(const FaParams* p, const long long* scratch, int n_partials,
                      const long long* carry_i, const double* carry_f, long long* out_i,
                      double* out_f, void* stream) {
  if (p->n_aggs < 0 || p->n_aggs > FA_MAX_AGGS) return (int)cudaErrorInvalidValue;
  const int grid = p->n_aggs > 0 ? p->n_aggs : 1;
  fused_agg_combine_pack<<<grid, 32, 0, (cudaStream_t)stream>>>(*p, scratch, n_partials, carry_i,
                                                                carry_f, out_i, out_f);
  return (int)cudaGetLastError();
}

int fa_combine_attributes(int* out) {
  return kernel_attributes((const void*)fused_agg_combine_pack, out);
}

int ga_params_size(void) { return (int)sizeof(GaParams); }
int ga_smem_max(void) { return GA_SMEM_MAX; }
int ga_xwords(void) { return GA_XW; }

int ga_tile_rows(void) { return GA_ROWS; }

// out: [grid, n_leaves, C]; the instance of `slots` stack slots
// (cudaErrorInvalidValue for another count)
int ga_launch_partials(const GaParams* p, long long* out, int grid, int smem_bytes, int slots,
                       void* stream) {
  const GaPartialsKernel k = ga_partials_kernel(slots);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return ga_launch_smem(k, grid, smem_bytes, stream, *p, out);
}

int ga_partials_attributes(int slots, int* out) {
  return kernel_attributes((const void*)ga_partials_kernel(slots), out);
}

// a block of one warp a cell; the instance of `slots` stack
// slots (first's walk at the winning row; cudaErrorInvalidValue for another
// count, or for 2^31 cells or more)
int ga_launch_combine(const GaParams* p, const long long* parts, int n_parts,
                      const long long* carry_i, const double* carry_f, long long* out_i,
                      double* out_f, int slots, void* stream) {
  const GaCombineKernel k = ga_combine_kernel(slots);
  const long long cells = (long long)p->n_leaves * p->capacity;
  if (k == nullptr || cells >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (cells == 0) return 0;
  k<<<(unsigned)cells, 32, 0, (cudaStream_t)stream>>>(*p, parts, n_parts, carry_i, carry_f, out_i,
                                                      out_f);
  return (int)cudaGetLastError();
}

int ga_combine_attributes(int slots, int* out) {
  return kernel_attributes((const void*)ga_combine_kernel(slots), out);
}

// words: [n_leaves, C] at their initial words; xacc: [n_xleaves, C, GA_XW]
// zeros; the instance of `slots` stack slots
int gw_launch_partials(const GaParams* p, long long* words, long long* xacc, int grid,
                       int slots, void* stream) {
  const GwPartialsKernel k = gw_partials_kernel(slots);
  if (k == nullptr || grid < 1 || grid > FA_GRID) return (int)cudaErrorInvalidValue;
  k<<<grid, FA_THREADS, 0, (cudaStream_t)stream>>>(*p, words, xacc);
  return (int)cudaGetLastError();
}

int gw_partials_attributes(int slots, int* out) {
  return kernel_attributes((const void*)gw_partials_kernel(slots), out);
}

// the instance of `slots` stack slots (first's walk at the winning row);
// ceil(C / GW_SLOTS) blocks of GW_SLOTS threads
int gw_launch_combine(const GaParams* p, const long long* words, const long long* xacc,
                      const long long* carry_i, const double* carry_f, long long* out_i,
                      double* out_f, int slots, void* stream) {
  const GwCombineKernel k = gw_combine_kernel(slots);
  if (k == nullptr || p->capacity < 1) return (int)cudaErrorInvalidValue;
  unsigned long long xmask = 0;
  for (int l = 0; l < p->n_leaves; ++l) {
    if (ga_xleaf(p->leaf_kind[l], p->leaf_f64[l])) xmask |= 1ULL << l;
  }
  if (xmask != 0 && xacc == nullptr) return (int)cudaErrorInvalidValue;
  const int grid = (p->capacity + GW_SLOTS - 1) / GW_SLOTS;
  k<<<grid, GW_SLOTS, 0, (cudaStream_t)stream>>>(*p, words, xacc, carry_i, carry_f, out_i, out_f,
                                                 xmask);
  return (int)cudaGetLastError();
}

int gw_combine_attributes(int slots, int* out) {
  return kernel_attributes((const void*)gw_combine_kernel(slots), out);
}

}  // extern "C"
