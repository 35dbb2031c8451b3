// The leaves of the grouped kernels: kinds, merges and per-row contributions.
//
// A leaf is one row of the packed state of a grouped aggregation
// (jax_eval.py _pack_state's order: the first-active-row tracker, then each
// aggregate's carry leaves); its kind says how a row contributes and how two
// values merge.  Shared by fused_agg.cu (fused_group_agg_*) and
// fused_batch.cu (batch_*); the functions that read a parameter block take
// any block with the leaf tables (GaParams, BtTask).  The leaf kinds are the
// LEAF_* table of tikv_tpu_torch/copr/fused_group_agg.py (a CPU test checks
// it against this file).

#pragma once

#include "fa_walk.cuh"

// first-row sentinel of the packed state (jax_eval.py _NO_ROW)
#define FA_NO_ROW (1LL << 62)

#define GA_MAX_LEAVES 64
#define GA_MAX_KEYS 4
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

// f64 a + b whose NaN follows the operands' order: a if a is NaN, else b if
// b is, else the sum (inf - inf: the add's own NaN).  Between two NaN
// operands the add keeps the one in the place the compiler gave it, which
// two kernels computing the same fold need not share; the combines and the
// mesh's folds add through this, so that their words agree bit for bit
// whenever their association orders do.
__device__ __forceinline__ double ga_dadd(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a + b;
}

// ga_merge with f64 sums through ga_dadd: the merge of the combines and
// the mesh's folds.
__device__ __forceinline__ long long ga_merge_ordered(int kind, bool is_f, long long a,
                                                      long long b) {
  if (is_f && (kind == GA_SUM || kind == GA_SUMSQ)) return fa_raw(ga_dadd(fa_f(a), fa_f(b)));
  return ga_merge(kind, is_f, a, b);
}

// What row f adds to leaf l of an aggregate that saw (live, value).
template <class P>
__device__ __forceinline__ long long ga_contrib(const P& p, int l, bool live, long long value,
                                                long long f) {
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
