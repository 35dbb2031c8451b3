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
//     host group ids) and jax_eval.py:_build_scan_fn_coded (site
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
// What it does not do yet: vector loads, cp.async/TMA pipelining, several
// rows per thread.  Those are later work.
//
// Encoded images: every column is read through fa_load (program #1, in
// fa_walk.cuh), also the dictionary codes of the coded group ids and the
// winning row that `first` walks again in the combine.
//
// Determinism: the grid is fixed (FA_GRID blocks of FA_THREADS threads), a
// row goes to thread (flat row index mod grid size), and every reduction
// runs in a fixed order, so f64 sums are bit-identical from run to run.
// Integer arithmetic is done in unsigned 64-bit and cast back, which wraps
// as numpy does (signed overflow is undefined in C++), so integer and
// decimal results are exact and independent of order.
//
// Layout contract with tikv_tpu_torch/copr/fused_agg.py and
// copr/fused_group_agg.py (CPU tests check the opcode and leaf tables; the
// wrappers check sizeof(FaParams) and sizeof(GaParams) at load).

#include "fa_walk.cuh"

#define FA_THREADS 256
#define FA_GRID 528

// first-row sentinel of the packed state (jax_eval.py _NO_ROW)
#define FA_NO_ROW (1LL << 62)

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

#define GA_MAX_LEAVES 64
#define GA_MAX_KEYS 4
#define GA_WARPS (FA_THREADS / 32)
// dynamic shared memory a block may use on Hopper (227 KB)
#define GA_SMEM_MAX 232448

enum {
  GA_TRACK = 0,      // min flat row index over active rows (tracker)
  GA_COUNT = 1,      // + 1 per live row
  GA_SUM = 2,        // + value (int64 wrapping, or f64)
  GA_SUMSQ = 3,      // + (double)value * (double)value, f64
  GA_MIN = 4,
  GA_MAX = 5,
  GA_AND = 6,
  GA_OR = 7,
  GA_XOR = 8,
  GA_FIRSTROW = 9,   // min flat row index over live rows (first's row)
  GA_FIRSTVAL = 10,  // first's value: read at the winning row by the combine
};

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

// min/max as XLA's: NaN propagates and -0.0 orders below +0.0, so the result
// does not depend on the order of the operands
__device__ __forceinline__ double ga_dmin(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a < b) return a;
  if (b < a) return b;
  return fa_raw(a) < 0 ? a : b;  // equal: a zero; keep -0.0 if either is
}
__device__ __forceinline__ double ga_dmax(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a > b) return a;
  if (b > a) return b;
  return fa_raw(a) < 0 ? b : a;  // equal: a zero; keep +0.0 if either is
}

__device__ __forceinline__ long long ga_merge(int kind, bool is_f, long long a, long long b) {
  switch (kind) {
    case GA_COUNT:
      return fa_wadd(a, b);
    case GA_SUM:
    case GA_SUMSQ:
      return is_f ? fa_raw(fa_f(a) + fa_f(b)) : fa_wadd(a, b);
    case GA_MIN:
      return is_f ? fa_raw(ga_dmin(fa_f(a), fa_f(b))) : (a < b ? a : b);
    case GA_MAX:
      return is_f ? fa_raw(ga_dmax(fa_f(a), fa_f(b))) : (a > b ? a : b);
    case GA_AND: return a & b;
    case GA_OR: return a | b;
    case GA_XOR: return a ^ b;
    case GA_TRACK:
    case GA_FIRSTROW:
      return a < b ? a : b;
    default:
      return a;  // GA_FIRSTVAL: not folded
  }
}

// What row f adds to leaf l of an aggregate that saw (live, value).
__device__ __forceinline__ long long ga_contrib(const GaParams& p, int l, bool live,
                                                long long value, long long f) {
  if (!live) return p.leaf_ident[l];
  switch (p.leaf_kind[l]) {
    case GA_COUNT: return 1;
    case GA_SUMSQ: {
      const double x = fa_num(value, p.leaf_arg_f64[l]);
      return fa_raw(x * x);
    }
    case GA_FIRSTROW: return f;
    case GA_FIRSTVAL: return p.leaf_ident[l];
    default: return value;
  }
}

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

// Partials of every leaf for every group slot.
//
// SHARED_ROWS (C <= C_MAX): each warp owns a shared-memory row [n_leaves][C]
// and writes [gridDim.x, n_leaves, C] int64 words (f64 as bits), one row per
// block, with no atomics: for each 32-row step the lanes of one group
// (__match_any_sync) are folded in lane order by the lowest of them into the
// warp's row; at the end the warp rows are folded in warp order.  Every f64
// leaf is therefore summed in one fixed order: reruns are bit-identical.
// Dynamic shared memory: GA_WARPS * n_leaves * (32 + C) * 8 bytes, so
//     C_MAX = GA_SMEM_MAX / (GA_WARPS * 8 * n_leaves) - 32
// (331 group slots for TPC-H Q1's 10 leaves; 1,784 for one count).
//
// !SHARED_ROWS (C > C_MAX, integer leaves only): the group's folded value
// goes to `out` ([1, n_leaves, C], holding each leaf's identity) through one
// 64-bit atomic per leaf, exact in any order.  The wrapper declines plans
// with f64 leaves there (real_group_capacity_not_ported).
template <bool SHARED_ROWS>
__global__ void __launch_bounds__(FA_THREADS)
fused_group_agg_partials(const __grid_constant__ GaParams p, long long* __restrict__ out) {
  extern __shared__ long long ga_smem[];
  const int L = p.n_leaves;
  const int C = p.capacity;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long* stage = ga_smem + (long long)warp * L * 32;  // [L][32]: this step's contributions
  long long* wrows = ga_smem + (long long)GA_WARPS * L * 32;  // [GA_WARPS][L][C]
  long long* mine = wrows + (long long)warp * L * C;
  if (SHARED_ROWS) {
    for (long long idx = threadIdx.x; idx < (long long)GA_WARPS * L * C; idx += FA_THREADS) {
      wrows[idx] = p.leaf_ident[(idx / C) % L];
    }
    __syncthreads();
  }

  const long long rows = p.block_rows;
  const long long total = p.n_blocks * rows;
  const long long stride = (long long)gridDim.x * FA_THREADS;
  // every lane of a warp runs the same number of steps (the loop is on the
  // warp's first row), so the warp-wide operations below see all 32 lanes
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
    if (active && lane == __ffs(same) - 1) {
      for (int l = 0; l < L; ++l) {
        const int kind = p.leaf_kind[l];
        if (kind == GA_FIRSTVAL) continue;
        const bool is_f = p.leaf_f64[l];
        long long acc = SHARED_ROWS ? mine[(long long)l * C + gid] : p.leaf_ident[l];
        for (unsigned m = same; m != 0; m &= m - 1) {
          acc = ga_merge(kind, is_f, acc, stage[l * 32 + __ffs(m) - 1]);
        }
        if (SHARED_ROWS) {
          mine[(long long)l * C + gid] = acc;
        } else if (acc != p.leaf_ident[l]) {
          ga_atomic(kind, out + (long long)l * C + gid, acc);
        }
      }
    }
    __syncwarp();
    blk += step_b;
    i += step_i;
    if (i >= rows) {
      i -= rows;
      ++blk;
    }
  }

  if (SHARED_ROWS) {
    __syncthreads();
    long long* part = out + (long long)blockIdx.x * L * C;
    for (long long idx = threadIdx.x; idx < (long long)L * C; idx += FA_THREADS) {
      const int l = (int)(idx / C);
      const int kind = p.leaf_kind[l];
      const bool is_f = p.leaf_f64[l];
      long long acc = wrows[idx];
      for (int w = 1; w < GA_WARPS; ++w) acc = ga_merge(kind, is_f, acc, wrows[(long long)w * L * C + idx]);
      part[idx] = acc;
    }
  }
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

// Folds the partials [n_parts, n_leaves, C] into the carry and writes the
// packed state [n_int, C] / [n_f64, C].
//
// TREE (the shared-memory partials, one row per block of the partials
// kernel): one block per (leaf, group) cell; its threads fold the partials
// q = t, t + FA_THREADS, ... in order, then a fixed-order tree over the
// threads, so f64 cells come out bit-identical from run to run.
// !TREE (the atomic partials: one row): one thread per group, leaf by leaf.
template <bool TREE>
__global__ void __launch_bounds__(FA_THREADS)
fused_group_agg_combine_pack(const __grid_constant__ GaParams p,
                             const long long* __restrict__ parts, int n_parts,
                             const long long* carry_i, const double* carry_f,
                             long long* out_i, double* out_f) {
  const int C = p.capacity;
  const int L = p.n_leaves;
  if (!TREE) {
    const int g = blockIdx.x * FA_THREADS + threadIdx.x;
    if (g >= C) return;
    for (int l = 0; l < L; ++l) {
      const int fl = ga_folded_leaf(p, l);
      if (fl < 0) continue;
      const int fkind = p.leaf_kind[fl];
      const bool is_f = p.leaf_f64[fl];
      long long blk = p.leaf_ident[fl];
      for (int q = 0; q < n_parts; ++q) {
        blk = ga_merge(fkind, is_f, blk, parts[((long long)q * L + fl) * C + g]);
      }
      ga_finish_cell(p, l, g, blk, carry_i, carry_f, out_i, out_f);
    }
    return;
  }
  __shared__ long long s_acc[FA_THREADS];
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

// Above 48 KB a block's dynamic shared memory must be allowed explicitly.
template <bool SHARED_ROWS>
static int ga_launch_partials_t(const GaParams* p, long long* out, int grid, int smem_bytes,
                                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_group_agg_partials<SHARED_ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  fused_group_agg_partials<SHARED_ROWS><<<grid, FA_THREADS, smem_bytes, (cudaStream_t)stream>>>(
      *p, out);
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

// shared_rows: 1 for the shared-memory variant (out: [grid, n_leaves, C]),
// 0 for the atomic one (out: [1, n_leaves, C] holding the identities)
int ga_launch_partials(const GaParams* p, long long* out, int grid, int shared_rows,
                       int smem_bytes, void* stream) {
  return shared_rows ? ga_launch_partials_t<true>(p, out, grid, smem_bytes, stream)
                     : ga_launch_partials_t<false>(p, out, grid, smem_bytes, stream);
}

int ga_launch_combine(const GaParams* p, const long long* parts, int n_parts,
                      const long long* carry_i, const double* carry_f, long long* out_i,
                      double* out_f, void* stream) {
  if (n_parts > 1) {
    fused_group_agg_combine_pack<true><<<p->n_leaves * p->capacity, FA_THREADS, 0,
                                         (cudaStream_t)stream>>>(
        *p, parts, n_parts, carry_i, carry_f, out_i, out_f);
  } else {
    fused_group_agg_combine_pack<false><<<(p->capacity + FA_THREADS - 1) / FA_THREADS,
                                          FA_THREADS, 0, (cudaStream_t)stream>>>(
        *p, parts, n_parts, carry_i, carry_f, out_i, out_f);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
