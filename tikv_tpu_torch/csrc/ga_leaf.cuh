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

// ga_merge_ordered's rules, one type each (the same expressions), so that
// a fold picks its leaf's rule once (ga_with_rule), not at every merge.
struct GaWadd {
  static __device__ __forceinline__ long long m(long long a, long long b) { return fa_wadd(a, b); }
};
struct GaFadd {
  static __device__ __forceinline__ long long m(long long a, long long b) {
    return fa_raw(ga_dadd(fa_f(a), fa_f(b)));
  }
};
struct GaImin {
  static __device__ __forceinline__ long long m(long long a, long long b) { return a < b ? a : b; }
};
struct GaImax {
  static __device__ __forceinline__ long long m(long long a, long long b) { return a > b ? a : b; }
};
struct GaDmin {
  static __device__ __forceinline__ long long m(long long a, long long b) {
    return fa_raw(ga_dmin(fa_f(a), fa_f(b)));
  }
};
struct GaDmax {
  static __device__ __forceinline__ long long m(long long a, long long b) {
    return fa_raw(ga_dmax(fa_f(a), fa_f(b)));
  }
};
struct GaAnd {
  static __device__ __forceinline__ long long m(long long a, long long b) { return a & b; }
};
struct GaOr {
  static __device__ __forceinline__ long long m(long long a, long long b) { return a | b; }
};
struct GaXor {
  static __device__ __forceinline__ long long m(long long a, long long b) { return a ^ b; }
};

// f(rule) with the rule of leaf kind `kind` (f64 or not); nothing for
// GA_FIRSTVAL, which is not folded.
template <class F>
__device__ __forceinline__ void ga_with_rule(int kind, bool is_f, F&& f) {
  switch (kind) {
    case GA_COUNT: f(GaWadd{}); break;
    case GA_SUM:
    case GA_SUMSQ:
      if (is_f) {
        f(GaFadd{});
      } else {
        f(GaWadd{});
      }
      break;
    case GA_MIN:
      if (is_f) {
        f(GaDmin{});
      } else {
        f(GaImin{});
      }
      break;
    case GA_MAX:
      if (is_f) {
        f(GaDmax{});
      } else {
        f(GaImax{});
      }
      break;
    case GA_AND: f(GaAnd{}); break;
    case GA_OR: f(GaOr{}); break;
    case GA_XOR: f(GaXor{}); break;
    case GA_TRACK:
    case GA_FIRSTROW: f(GaImin{}); break;
    default: break;
  }
}

// The combine's tree: GA_TREE threads, thread t folding the parts t, t +
// GA_TREE, ... from the identity, then halving (t takes t + s for s = 128,
// 64, ..., 1).  Here on one warp: lane j holds the threads j, j + 32, ...,
// j + 224 in registers, strides 128, 64 and 32 merge within a lane, 16 to 1
// by shuffles; the same operands in the same order, so the same words.
// Part q's word is src[(row0 + q) * stride], q < n; lane 0 returns the
// total.  Past the first GA_TREE parts, the loads of B rounds of GA_TREE
// parts are in flight together.  Shared by fused_group_agg_combine_pack (a
// warp a cell) and mesh_fold (a warp a shard), so that their words cannot
// drift apart.
#define GA_TREE 256
#define GA_LANE_PARTS (GA_TREE / 32)  // 8: the tree below is written for it

template <class Op, int B = 1>
__device__ __forceinline__ long long ga_tree_fold(const long long* src, long long stride,
                                                  long long row0, long long n, int lane,
                                                  long long id) {
  long long v[GA_LANE_PARTS];
#pragma unroll
  for (int i = 0; i < GA_LANE_PARTS; ++i) {
    const int t = lane + 32 * i;
    v[i] = t < n ? Op::m(id, __ldg(src + (row0 + t) * stride)) : id;
  }
  for (long long q0 = GA_TREE; q0 < n; q0 += B * GA_TREE) {
    long long x[B][GA_LANE_PARTS];
#pragma unroll
    for (int b = 0; b < B; ++b) {
#pragma unroll
      for (int i = 0; i < GA_LANE_PARTS; ++i) {
        const long long q = q0 + b * GA_TREE + lane + 32 * i;
        x[b][i] = q < n ? __ldg(src + (row0 + q) * stride) : 0;
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
#pragma unroll
      for (int i = 0; i < GA_LANE_PARTS; ++i) {
        if (q0 + b * GA_TREE + lane + 32 * i < n) v[i] = Op::m(v[i], x[b][i]);
      }
    }
  }
  // written out: a loop over the strides kept v in local memory
  v[0] = Op::m(v[0], v[4]);
  v[1] = Op::m(v[1], v[5]);
  v[2] = Op::m(v[2], v[6]);
  v[3] = Op::m(v[3], v[7]);
  v[0] = Op::m(v[0], v[2]);
  v[1] = Op::m(v[1], v[3]);
  v[0] = Op::m(v[0], v[1]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v[0] = Op::m(v[0], __shfl_down_sync(0xffffffffu, v[0], s));
  return v[0];
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
