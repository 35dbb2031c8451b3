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
//     evaluated per row from registers and local memory, so no mask or
//     intermediate column is written back to device memory;
//   * each thread issues all its row's column loads before it evaluates
//     anything, so several loads per thread are in flight;
//   * rows past a block's n_valid (padding) are never read;
//   * the plan is bytecode in the kernel's parameter block
//     (__grid_constant__, served from constant memory): every thread of
//     the grid reads the same instruction, so the walk never diverges and
//     one compiled kernel serves every plan.
// fused_group_agg_partials walks GA_ROWS rows a thread with the tile walk
// (fa_walk_tile: the stack in registers, each lane's rows in one vector
// load where aligned) and folds them as batch_partials does (ga_fold.cuh);
// the capacity-1 pair and the wide route still walk a row a step
// (fa_walk), with no cp.async/TMA pipelining: later work.
//
// Encoded images: every column is read through fa_load (program #1, in
// fa_walk.cuh), also the dictionary codes of the coded group ids and the
// winning row that `first` walks again in the combine.
//
// Determinism: the grid depends on the image's shape alone (at most FA_GRID
// blocks of FA_THREADS threads), a row (a tile of GA_ROWS rows, for
// fused_group_agg_partials) goes to thread (its index mod the grid's
// threads), and every reduction runs in a fixed order, so f64 sums are
// bit-identical from run to run; the
// wide route's f64 sums are exact until one rounding, so their order does
// not matter at all.
// Integer arithmetic is done in unsigned 64-bit and cast back, which wraps
// as numpy does (signed overflow is undefined in C++), so integer and
// decimal results are exact and independent of order.
//
// Layout contract with tikv_tpu_torch/copr/fused_agg.py and
// copr/fused_group_agg.py (CPU tests check the opcode and leaf tables; the
// wrappers check sizeof(FaParams) and sizeof(GaParams) at load).

#include "ga_fold.cuh"

#define FA_THREADS 256
#define FA_GRID 528
#define GA_ROWS 4  // rows a fused_group_agg_partials thread walks at once (its tile)

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

// One row of partials per block: [gridDim.x, n_aggs, 2] int64 words
// (count, value bits).
__global__ void __launch_bounds__(FA_THREADS)
fused_agg_partials(const __grid_constant__ FaParams p, long long* __restrict__ scratch) {
  u64 cnt[FA_MAX_AGGS];
  long long acc[FA_MAX_AGGS];
  for (int k = 0; k < p.n_aggs; ++k) {
    cnt[k] = 0;
    acc[k] = fa_identity(p.agg_kind[k], p.agg_f64[k]);
  }

  const long long rows = p.block_rows;
  const long long total = p.n_blocks * rows;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // (block, row in block) of flat row f, advanced by the stride without a
  // division per row
  long long blk = rows > 0 ? f / rows : 0;
  long long i = f - blk * rows;
  const long long step_b = rows > 0 ? stride / rows : 0;
  const long long step_i = stride - step_b * rows;

  for (; f < total; f += stride) {
    const long long nv = p.n_valids != nullptr ? __ldg(p.n_valids + blk) : p.n_valid_all;
    if (i < nv) {
      fa_walk(p, f, blk, i, [&](int k, bool live, long long value) {
        if (live) {
          cnt[k] += 1;
          const int kind = p.agg_kind[k];
          if (kind != FA_AGG_COUNT) acc[k] = fa_merge(kind, p.agg_f64[k], acc[k], value);
        }
      });
    }
    blk += step_b;
    i += step_i;
    if (i >= rows) {
      i -= rows;
      ++blk;
    }
  }

  // fixed-order tree over the block's threads, one aggregate at a time
  __shared__ u64 s_cnt[FA_THREADS];
  __shared__ long long s_val[FA_THREADS];
  const int tid = threadIdx.x;
  for (int k = 0; k < p.n_aggs; ++k) {
    const int kind = p.agg_kind[k];
    const bool is_f = p.agg_f64[k];
    s_cnt[tid] = cnt[k];
    s_val[tid] = acc[k];
    __syncthreads();
    for (int s = FA_THREADS / 2; s > 0; s >>= 1) {
      if (tid < s) {
        s_cnt[tid] += s_cnt[tid + s];
        s_val[tid] = fa_merge(kind, is_f, s_val[tid], s_val[tid + s]);
      }
      __syncthreads();
    }
    if (tid == 0) {
      long long* out = scratch + ((long long)blockIdx.x * p.n_aggs + k) * 2;
      out[0] = (long long)s_cnt[0];
      out[1] = s_val[0];
    }
    __syncthreads();
  }
}

// One block folds the partials in block order, merges them into the carry
// (carry first, as jax_eval's `carry + block`) and writes the packed state:
// the first-row leaf at int64 row 0, then every aggregate's leaves at their
// slots.  out may alias carry: each leaf is read before it is written, by
// the same thread.
__global__ void __launch_bounds__(FA_THREADS)
fused_agg_combine_pack(const __grid_constant__ FaParams p, const long long* __restrict__ scratch,
                       int n_partials, const long long* carry_i, const double* carry_f,
                       long long* out_i, double* out_f) {
  __shared__ u64 s_cnt[FA_THREADS];
  __shared__ long long s_val[FA_THREADS];
  const int tid = threadIdx.x;
  for (int k = 0; k < p.n_aggs; ++k) {
    const int kind = p.agg_kind[k];
    const bool is_f = p.agg_f64[k];
    u64 c = 0;
    long long v = fa_identity(kind, is_f);
    for (int r = tid; r < n_partials; r += FA_THREADS) {
      const long long* part = scratch + ((long long)r * p.n_aggs + k) * 2;
      c += (u64)part[0];
      v = fa_merge(kind, is_f, v, part[1]);
    }
    s_cnt[tid] = c;
    s_val[tid] = v;
    __syncthreads();
    for (int s = FA_THREADS / 2; s > 0; s >>= 1) {
      if (tid < s) {
        s_cnt[tid] += s_cnt[tid + s];
        s_val[tid] = fa_merge(kind, is_f, s_val[tid], s_val[tid + s]);
      }
      __syncthreads();
    }
    if (tid == 0) {
      const int cs = p.cnt_slot[k];
      const int vs = p.val_slot[k];
      const u64 c0 = carry_i != nullptr ? (u64)carry_i[cs] : 0;
      out_i[cs] = (long long)(c0 + s_cnt[0]);
      if (kind != FA_AGG_COUNT) {
        if (is_f) {
          const long long v0 = carry_f != nullptr ? fa_raw(carry_f[vs]) : fa_identity(kind, true);
          out_f[vs] = fa_f(fa_merge(kind, true, v0, s_val[0]));
        } else {
          const long long v0 = carry_i != nullptr ? carry_i[vs] : fa_identity(kind, false);
          out_i[vs] = fa_merge(kind, false, v0, s_val[0]);
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) out_i[0] = carry_i != nullptr ? carry_i[0] : FA_NO_ROW;
}

// ---------------------------------------------------------------------------
// Grouped: fused_group_agg_partials + fused_group_agg_combine_pack
// ---------------------------------------------------------------------------
//
// The same walk per row, then a group id per row and per-group leaves.  A
// leaf is one row of the packed state (jax_eval._pack_state's order: the
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

// Global row of flat index f (block * block_rows + row): the block's offset
// plus the row; FA_NO_ROW stays.
__device__ __forceinline__ long long ga_global_row(const GaParams& p, long long f) {
  if (f >= FA_NO_ROW) return FA_NO_ROW;
  const long long blk = f / p.block_rows;
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


// The row loop of the wide route's partials kernel.  Each thread walks its rows
// (flat row f = base + lane, base stepping by the grid's size), stages each
// row's contribution to every leaf in its warp's `stage` [L][32] and its
// group id; then `fold(active, gid, same)` runs on every lane, `same`
// being the lanes of the step that hold the same group (__match_any_sync).
// Every lane of a warp runs the same number of steps (the loop is on the
// warp's first row), so the warp-wide operations see all 32 lanes.
template <class Fold>
__device__ __forceinline__ void ga_rows(const GaParams& p, long long* stage, Fold fold) {
  const int C = p.capacity;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long rows = p.block_rows;
  const long long total = p.n_blocks * rows;
  const long long stride = (long long)gridDim.x * FA_THREADS;
  long long base = (long long)blockIdx.x * FA_THREADS + warp * 32;
  long long f = base + lane;
  long long blk = rows > 0 ? f / rows : 0;
  long long i = f - blk * rows;
  const long long step_b = rows > 0 ? stride / rows : 0;
  const long long step_i = stride - step_b * rows;

  for (; base < total; base += stride, f += stride) {
    bool active = false;
    int gid = -1;
    if (f < total) {
      const long long nv = p.n_valids != nullptr ? __ldg(p.n_valids + blk) : p.n_valid_all;
      if (i < nv) {
        active = fa_walk(p, f, blk, i, [&](int k, bool live, long long value) {
          const int l0 = p.agg_leaf0[k];
          for (int l = l0; l < l0 + p.agg_nleaves[k]; ++l) {
            stage[l * 32 + lane] = ga_contrib(p, l, live, value, f);
          }
        });
        if (active) {
          if (p.gids != nullptr) {
            gid = __ldg(p.gids + f);
          } else {
            // mixed radix over the key columns' codes (jax_eval._mixed_radix_gids),
            // narrowed int8/int16 codes sign-extended by the column load
            long long g = 0;
            for (int q = 0; q < p.n_keys; ++q) {
              const long long dlen = p.key_dlen[q];
              bool nul;
              const long long code = fa_load(p, p.key_slot[q], f, blk, i, nul);
              g = g * (dlen + 1) + (nul ? dlen : code);
            }
            gid = (g >= 0 && g < C) ? (int)g : -1;
          }
          // a row whose id is outside the slots touches none, as XLA drops
          // out-of-range scatter updates
          active = gid >= 0 && gid < C;
          stage[lane] = p.track ? f : FA_NO_ROW;
        }
      }
    }
    const unsigned same = __match_any_sync(0xFFFFFFFFu, active ? gid : -1);
    __syncwarp();
    fold(active, gid, same);
    __syncwarp();
    blk += step_b;
    i += step_i;
    if (i >= rows) {
      i -= rows;
      ++blk;
    }
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
//     until the combine, which rounds the exact sum to nearest (ga_xround):
//     the result is the same whatever the order, the grid or the device.
// Scratch: GA_XW * 8 = 528 bytes a f64 sum cell; at 262,144 slots 138 MB a
// leaf.  A word takes at most one add of < 2^32 a row, so it cannot
// overflow below 2^31 rows a launch.
// first's value is read at the winning row by the combine (ga_finish_cell).

#define GA_XW 66
#define GA_XFLAG_POSINF 1
#define GA_XFLAG_NEGINF 2
#define GA_XFLAG_NAN 4
#define GA_LLMAX 0x7FFFFFFFFFFFFFFFLL
#define GA_LLMIN (-GA_LLMAX - 1)
#define GA_QNAN 0x7FF8000000000000LL

__device__ __forceinline__ bool ga_xleaf(int kind, bool is_f) {
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

// The exact sum held in `cell`, rounded to the nearest double (ties to
// even).  The words carry into 32-bit digits d[0..GA_XW] (the last one the
// top carry); a negative sum is carried again from the negated words.  The
// 62 bits from the leading one down (the bits below as a sticky bit) round
// to 53, scaled by ldexp, which is exact: a result in the subnormal range
// has no bits below 2^-1074 to lose.  copr/fused_group_agg.py:_xround is
// the same integer steps.
__device__ double ga_xround(const long long* cell) {
  long long c = 0;
  for (int k = 0; k < GA_XW; ++k) c = (cell[k] + c) >> 32;
  const bool neg = c < 0;
  unsigned int d[GA_XW + 1];
  c = 0;
  for (int k = 0; k < GA_XW; ++k) {
    const long long v = (neg ? -cell[k] : cell[k]) + c;
    d[k] = (unsigned int)(v & 0xFFFFFFFFLL);
    c = v >> 32;
  }
  d[GA_XW] = (unsigned int)c;
  int h = GA_XW;
  while (h >= 0 && d[h] == 0) --h;
  if (h < 0) return 0.0;
  const int lz = __clz(d[h]);
  const int top = 32 * h + 31 - lz;  // the leading one's bit
  const int t = top - 61;            // the window's lowest bit
  long long win = 0;
  bool sticky = false;
  for (int k = h; k >= 0 && k >= h - 2; --k) {
    const int s = 32 * k - t;
    const long long x = d[k];
    if (s >= 0) {
      win |= x << s;
    } else {
      win |= x >> -s;
      sticky |= (x & ((1LL << -s) - 1)) != 0;
    }
  }
  for (int k = h - 3; k >= 0 && !sticky; --k) sticky = d[k] != 0;
  long long mant = win >> 9;
  const long long rem = (win & 0x1FF) | (sticky ? 1 : 0);
  if (rem > 0x100 || (rem == 0x100 && (mant & 1))) ++mant;
  const double r = ldexp((double)mant, t + 9 - 1074);
  return neg ? -r : r;
}

__device__ __forceinline__ double ga_xtotal(long long flags, const long long* cell) {
  if ((flags & GA_XFLAG_NAN) || (flags & 3) == 3) return fa_f(GA_QNAN);
  if (flags & GA_XFLAG_POSINF) return fa_f(0x7FF0000000000000LL);
  if (flags & GA_XFLAG_NEGINF) return fa_f((long long)0xFFF0000000000000ULL);
  return ga_xround(cell);
}

// words [n_leaves, C] at ga_wide_ident (the wrapper's initial words), xacc
// [n_xleaves, C, GA_XW] zeros; dynamic shared memory GA_WARPS * n_leaves *
// 32 * 8 bytes (the stage).
__global__ void __launch_bounds__(FA_THREADS)
group_wide_partials(const __grid_constant__ GaParams p, long long* __restrict__ words,
                    long long* __restrict__ xacc) {
  extern __shared__ long long ga_smem[];
  __shared__ signed char xidx[GA_MAX_LEAVES];  // each f64 sum leaf's accumulator
  const int L = p.n_leaves;
  const int C = p.capacity;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long* stage = ga_smem + (long long)warp * L * 32;
  if (threadIdx.x == 0) {
    int x = 0;
    for (int l = 0; l < L; ++l) xidx[l] = ga_xleaf(p.leaf_kind[l], p.leaf_f64[l]) ? x++ : -1;
  }
  __syncthreads();

  ga_rows(p, stage, [&](bool active, int gid, unsigned same) {
    if (!active) return;
    const bool leader = lane == __ffs(same) - 1;
    for (int l = 0; l < L; ++l) {
      const int kind = p.leaf_kind[l];
      if (kind == GA_FIRSTVAL) continue;
      const bool is_f = p.leaf_f64[l];
      long long* word = words + (long long)l * C + gid;
      if (xidx[l] >= 0) {
        // every lane adds its own value: exact, so no fold is needed
        ga_xadd(word, xacc + ((long long)xidx[l] * C + gid) * GA_XW, fa_f(stage[l * 32 + lane]));
        continue;
      }
      if (!leader) continue;
      long long acc = p.leaf_ident[l];
      for (unsigned m = same; m != 0; m &= m - 1) {
        acc = ga_merge(kind, is_f, acc, stage[l * 32 + __ffs(m) - 1]);
      }
      if (acc == p.leaf_ident[l]) continue;
      if (is_f) {
        const bool is_max = kind == GA_MAX;
        const long long key = ga_fkey(fa_f(acc), is_max);
        if (is_max) {
          atomicMax(word, key);
        } else {
          atomicMin(word, key);
        }
      } else {
        ga_atomic(kind, word, acc);
      }
    }
  });
}

// The end of the combine for one (leaf l, group g) cell: `blk` is this
// launch's partials of the leaf folded together (of first's row leaf, for
// first's value leaf).  Merges it into the carry (carry first, as
// jax_eval's `carry + block`), turns the tracker's flat row index into a
// global row, and for `first` reads the value at the winning row (the walk
// once more, at that row) and writes the value and the row leaf together.
// out may alias carry: each cell is read and then written by one thread, and
// first's row leaf is skipped by the callers and written here.
__device__ __forceinline__ void ga_finish_cell(const GaParams& p, int l, int g, long long blk,
                                               const long long* carry_i, const double* carry_f,
                                               long long* out_i, double* out_f) {
  const int C = p.capacity;
  const int kind = p.leaf_kind[l];
  const bool is_f = p.leaf_f64[l];
  const long long cell = (long long)p.leaf_slot[l] * C + g;
  const long long c0 = carry_i == nullptr ? p.leaf_ident[l]
                     : is_f ? fa_raw(carry_f[cell]) : carry_i[cell];
  long long res;
  if (kind == GA_FIRSTVAL) {
    const long long rcell = (long long)p.leaf_slot[p.leaf_aux[l]] * C + g;
    const long long row = ga_global_row(p, blk);
    const long long crow = carry_i == nullptr ? FA_NO_ROW : carry_i[rcell];
    res = c0;
    if (row < crow) {
      const int want = p.leaf_agg[l];
      const long long b = blk / p.block_rows;  // blk: the winning flat row
      fa_walk(p, blk, b, blk - b * p.block_rows, [&](int k, bool, long long value) {
        if (k == want) res = value;
      });
    }
    out_i[rcell] = row < crow ? row : crow;
  } else {
    if (kind == GA_TRACK) blk = ga_global_row(p, blk);
    res = ga_merge(kind, is_f, c0, blk);
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

// Folds the shared-memory partials [n_parts, n_leaves, C] (one row per block
// of fused_group_agg_partials) into the carry and writes the packed state
// [n_int, C] / [n_f64, C]: one block per (leaf, group) cell; its threads
// fold the partials q = t, t + FA_THREADS, ... in order, then a fixed-order
// tree over the threads, so f64 cells come out bit-identical from run to run.
__global__ void __launch_bounds__(FA_THREADS)
fused_group_agg_combine_pack(const __grid_constant__ GaParams p,
                             const long long* __restrict__ parts, int n_parts,
                             const long long* carry_i, const double* carry_f,
                             long long* out_i, double* out_f) {
  __shared__ long long s_acc[FA_THREADS];
  const int C = p.capacity;
  const int L = p.n_leaves;
  const int l = blockIdx.x / C;
  const int g = blockIdx.x - l * C;
  const int fl = ga_folded_leaf(p, l);
  if (fl < 0) return;
  const int fkind = p.leaf_kind[fl];
  const bool is_f = p.leaf_f64[fl];
  const int tid = threadIdx.x;
  long long acc = p.leaf_ident[fl];
  for (int q = tid; q < n_parts; q += FA_THREADS) {
    acc = ga_merge(fkind, is_f, acc, parts[((long long)q * L + fl) * C + g]);
  }
  s_acc[tid] = acc;
  __syncthreads();
  for (int st = FA_THREADS / 2; st > 0; st >>= 1) {
    if (tid < st) s_acc[tid] = ga_merge(fkind, is_f, s_acc[tid], s_acc[tid + st]);
    __syncthreads();
  }
  if (tid == 0) ga_finish_cell(p, l, g, s_acc[0], carry_i, carry_f, out_i, out_f);
}

// The wide route's combine: one thread per group slot, leaf by leaf; each
// cell's total (an integer word, a decoded min/max key, or the rounded
// exact sum) goes through ga_finish_cell as the shared route's does.
__global__ void __launch_bounds__(FA_THREADS)
group_wide_combine(const __grid_constant__ GaParams p, const long long* __restrict__ words,
                   const long long* __restrict__ xacc, const long long* carry_i,
                   const double* carry_f, long long* out_i, double* out_f) {
  const int C = p.capacity;
  const long long g = (long long)blockIdx.x * FA_THREADS + threadIdx.x;
  if (g >= C) return;
  int x = 0;
  for (int l = 0; l < p.n_leaves; ++l) {
    const int kind = p.leaf_kind[l];
    const bool is_f = p.leaf_f64[l];
    const bool xl = ga_xleaf(kind, is_f);
    const int fl = ga_folded_leaf(p, l);
    if (fl >= 0) {
      long long blk = words[(long long)fl * C + g];
      if (xl) {
        blk = fa_raw(ga_xtotal(blk, xacc + ((long long)x * C + g) * GA_XW));
      } else if (is_f && (kind == GA_MIN || kind == GA_MAX)) {
        blk = fa_raw(ga_funkey(blk, kind == GA_MAX));
      }
      ga_finish_cell(p, l, (int)g, blk, carry_i, carry_f, out_i, out_f);
    }
    x += xl;
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

// Each launcher returns cudaGetLastError() right after its launch: a launch
// that is refused (too many threads, too much shared memory) never runs, and a
// later synchronize would not say so.
int fa_launch_partials(const FaParams* p, long long* scratch, void* stream) {
  fused_agg_partials<<<FA_GRID, FA_THREADS, 0, (cudaStream_t)stream>>>(*p, scratch);
  return (int)cudaGetLastError();
}

int fa_launch_combine(const FaParams* p, const long long* scratch, int n_partials,
                      const long long* carry_i, const double* carry_f, long long* out_i,
                      double* out_f, void* stream) {
  fused_agg_combine_pack<<<1, FA_THREADS, 0, (cudaStream_t)stream>>>(
      *p, scratch, n_partials, carry_i, carry_f, out_i, out_f);
  return (int)cudaGetLastError();
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

// cudaFuncGetAttributes of the fused_group_agg_partials instance of `slots`
// stack slots: registers a thread, local and static shared bytes, into
// out[0..3).
int ga_partials_attributes(int slots, int* out) {
  const GaPartialsKernel k = ga_partials_kernel(slots);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)k);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

int ga_launch_combine(const GaParams* p, const long long* parts, int n_parts,
                      const long long* carry_i, const double* carry_f, long long* out_i,
                      double* out_f, void* stream) {
  fused_group_agg_combine_pack<<<p->n_leaves * p->capacity, FA_THREADS, 0,
                                 (cudaStream_t)stream>>>(*p, parts, n_parts, carry_i, carry_f,
                                                         out_i, out_f);
  return (int)cudaGetLastError();
}

// words: [n_leaves, C] at their initial words; xacc: [n_xleaves, C, GA_XW] zeros
int gw_launch_partials(const GaParams* p, long long* words, long long* xacc, int grid,
                       int smem_bytes, void* stream) {
  return ga_launch_smem(group_wide_partials, grid, smem_bytes, stream, *p, words, xacc);
}

int gw_launch_combine(const GaParams* p, const long long* words, const long long* xacc,
                      const long long* carry_i, const double* carry_f, long long* out_i,
                      double* out_f, void* stream) {
  group_wide_combine<<<(p->capacity + FA_THREADS - 1) / FA_THREADS, FA_THREADS, 0,
                       (cudaStream_t)stream>>>(*p, words, xacc, carry_i, carry_f, out_i, out_f);
  return (int)cudaGetLastError();
}

}  // extern "C"
