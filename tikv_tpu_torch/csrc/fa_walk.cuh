// The bytecode walk shared by the coprocessor's device kernels.
//
// Replaces rpn.py:eval_rpn(xp=jnp) of the reference package (tikv_tpu/copr),
// which every device program of jax_eval.py inlines, for the ported scalar
// functions: lt le gt ge eq ne, and or xor not, is_null is_true is_false
// is_not_null, plus minus multiply unary_minus abs, bit_and bit_or bit_xor
// bit_neg, with the decimal scale_by alignment applied before each
// operation.  A plan is bytecode for a small stack machine over
// (64-bit value, null) slots; each instruction carries its operands' types,
// fixed at compile time (int64 or f64).  Included by fused_agg.cu (the
// aggregation kernels) and fused_scan.cu (the mask and top-K kernels).
//
// Also program #1 of the reference package, kernels.py:decode_device_column
// (inlined there through jax_eval.py:_build_cols): the column load fa_load.
// A warm image may be encoded (copr/encoding.py): bitpacked int8/16/32
// lanes plus one frame of reference per column, narrowed int8/16
// dictionary codes, or runs (values and ends, [n_blocks, k_cap]).  Every
// kernel that reads the image loads each column through fa_load, which
// widens it in registers, so HBM holds the narrow payload and the walk sees
// the int64 lanes of the plain image: the null slots of an encoded column
// load as 0, as the plain image holds them.  The column's descriptor (FaEnc)
// rides in the parameter block; it is the same for every thread, so the
// branch on it never diverges.
//
// Layout contract with tikv_tpu_torch/copr/fused_agg.py (a CPU test checks
// the opcode table against this file).

#pragma once

#include <cuda_runtime.h>

#define FA_MAX_COLS 16
#define FA_MAX_CONSTS 64
#define FA_MAX_CODE 256
#define FA_MAX_AGGS 16
#define FA_MAX_STACK 8

// instruction word: op | arg << 8 | flags << 16 | depth << 24
// flags bit 0: operand a (or the only operand) is f64; bit 1: operand b is f64
enum {
  FA_OP_COL = 1,       // push column `arg`
  FA_OP_CONST = 2,     // push consts[arg]
  FA_OP_NULL = 3,      // push NULL
  FA_OP_SCALE = 4,     // stack[top - depth] *= consts[arg]
  FA_OP_LT = 5,
  FA_OP_LE = 6,
  FA_OP_GT = 7,
  FA_OP_GE = 8,
  FA_OP_EQ = 9,
  FA_OP_NE = 10,
  FA_OP_AND = 11,
  FA_OP_OR = 12,
  FA_OP_XOR = 13,
  FA_OP_NOT = 14,
  FA_OP_IS_NULL = 15,
  FA_OP_IS_TRUE = 16,
  FA_OP_IS_FALSE = 17,
  FA_OP_PLUS = 18,
  FA_OP_MINUS = 19,
  FA_OP_MUL = 20,
  FA_OP_FILTER = 21,   // pop; active &= value != 0 && !null
  FA_OP_AGG = 22,      // pop; aggregate `arg` takes the value if active && !null
  FA_OP_COUNT1 = 23,   // aggregate `arg` (count of no expression) counts active
  FA_OP_KEY = 24,      // pop; sort key `arg` takes (value, null), whatever active says
  FA_OP_NEG = 25,      // unary_minus: int64 wraps (-INT64_MIN is INT64_MIN), f64 flips the sign
  FA_OP_ABS = 26,      // abs: int64 wraps (abs(INT64_MIN) is INT64_MIN), f64 clears the sign
  FA_OP_BIT_AND = 27,  // bit operators over int64 bit patterns (never f64)
  FA_OP_BIT_OR = 28,
  FA_OP_BIT_XOR = 29,
  FA_OP_BIT_NEG = 30,
  FA_OP_IS_NOT_NULL = 31,  // never NULL
};

typedef unsigned long long u64;

// How a column is loaded (program #1).  FA_ENC_NARROW is bitpack (ref = the
// frame) and narrowed dictionary codes (ref = 0).
enum { FA_ENC_PLAIN = 0, FA_ENC_NARROW = 1, FA_ENC_RLE = 2 };

// The per-column descriptors of a parameter block (copr/fused_agg.py _Enc).
struct FaEnc {
  long long ref[FA_MAX_COLS];          // bitpack frame of reference, added to the lane
  const long long* ends[FA_MAX_COLS];  // rle: run ends [n_blocks, k_cap], padded with block_rows
  int k_cap[FA_MAX_COLS];              // rle: runs a block holds (padded)
  signed char kind[FA_MAX_COLS];       // FA_ENC_*
  signed char width[FA_MAX_COLS];      // bytes of a lane (rle: of a run value): 1, 2, 4 or 8
  signed char null_runs[FA_MAX_COLS];  // the null mask is run-shaped [n_blocks, k_cap]
  signed char pad[FA_MAX_COLS];
};

__device__ __forceinline__ double fa_f(long long raw) { return __longlong_as_double(raw); }
__device__ __forceinline__ long long fa_raw(double v) { return __double_as_longlong(v); }
__device__ __forceinline__ double fa_num(long long raw, bool is_f) {
  return is_f ? fa_f(raw) : (double)raw;
}
__device__ __forceinline__ bool fa_truthy(long long raw, bool is_f) {
  return is_f ? fa_f(raw) != 0.0 : raw != 0;
}

__device__ __forceinline__ long long fa_wadd(long long a, long long b) {
  return (long long)((u64)a + (u64)b);
}
__device__ __forceinline__ long long fa_wsub(long long a, long long b) {
  return (long long)((u64)a - (u64)b);
}
__device__ __forceinline__ long long fa_wmul(long long a, long long b) {
  return (long long)((u64)a * (u64)b);
}

template <typename T>
__device__ __forceinline__ long long fa_cmp(int op, T a, T b) {
  switch (op) {
    case FA_OP_LT: return a < b;
    case FA_OP_LE: return a <= b;
    case FA_OP_GT: return a > b;
    case FA_OP_GE: return a >= b;
    case FA_OP_EQ: return a == b;
    default: return a != b;  // FA_OP_NE: NaN != x holds, as in numpy
  }
}

// Lane idx of a 1-, 2-, 4- or 8-byte integer payload, sign-extended.
__device__ __forceinline__ long long fa_lane(const void* base, long long idx, int width) {
  switch (width) {
    case 1: return __ldg((const signed char*)base + idx);
    case 2: return __ldg((const short*)base + idx);
    case 4: return __ldg((const int*)base + idx);
    default: return __ldg((const long long*)base + idx);
  }
}

// Program #1: column j at flat row f (row i of block blk) as the walk sees
// it, its NULL flag in `nul`.  Plain: the lane as it is.  Bitpack and codes:
// the narrow lane sign-extended, plus the frame.  Runs: the run holding row i
// is the number of run ends <= i (searchsorted right), found by binary
// search over the block's k_cap ends (at most 16 steps) and clipped to
// k_cap - 1 as decode_device_column clips it; then its value, and its NULL
// flag where the mask is run-shaped.  An encoded NULL slot loads as 0.
template <class P>
__device__ __forceinline__ long long fa_load(const P& p, int j, long long f, long long blk,
                                             long long i, bool& nul) {
  const int kind = p.enc.kind[j];
  const int width = p.enc.width[j];
  if (kind == FA_ENC_RLE) {
    const int k = p.enc.k_cap[j];
    const long long* ends = p.enc.ends[j] + blk * k;
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(ends + mid) <= i) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const long long r = blk * k + (lo < k ? lo : k - 1);
    nul = p.nul[j] != nullptr && __ldg(p.nul[j] + (p.enc.null_runs[j] ? r : f)) != 0;
    return nul ? 0 : fa_lane(p.col[j], r, width);
  }
  nul = p.nul[j] != nullptr && __ldg(p.nul[j] + f) != 0;
  const long long v = fa_lane(p.col[j], f, width);
  if (kind == FA_ENC_PLAIN) return v;
  return nul ? 0 : fa_wadd(v, p.enc.ref[j]);
}

// The bytecode walk over one row, flat row f (row i of block blk): loads the
// row's columns, evaluates the selection conjuncts and every aggregate
// argument, and reports each aggregate k to on_agg(k, live, value bits),
// where live = the row passed the selection and the argument is not NULL
// (count(*): passed the selection), and each sort key q to on_key(q, null,
// value bits), whatever the selection says.  Returns whether the row passed
// the selection.  P is any parameter block with the columns, their
// descriptors, the code and the constants (FaParams, GaParams, ScParams).
template <class P, class OnAgg, class OnKey>
__device__ __forceinline__ bool fa_walk_keys(const P& p, long long f, long long blk, long long i,
                                             OnAgg&& on_agg, OnKey&& on_key) {
  long long v[FA_MAX_COLS];
  bool vn[FA_MAX_COLS];
  long long sv[FA_MAX_STACK];
  bool sn[FA_MAX_STACK];
#pragma unroll
  for (int j = 0; j < FA_MAX_COLS; ++j) {
    if (j < p.n_cols) v[j] = fa_load(p, j, f, blk, i, vn[j]);
  }
  int sp = 0;
  bool active = true;
  for (int pc = 0; pc < p.n_code; ++pc) {
    const int w = p.code[pc];
    const int op = w & 0xFF;
    const int arg = (w >> 8) & 0xFF;
    const bool fa = (w >> 16) & 1;
    const bool fb = (w >> 17) & 1;
    const int dep = (w >> 24) & 0xFF;
    switch (op) {
      case FA_OP_COL:
        sv[sp] = v[arg];
        sn[sp] = vn[arg];
        ++sp;
        break;
      case FA_OP_CONST:
        sv[sp] = p.consts[arg];
        sn[sp] = false;
        ++sp;
        break;
      case FA_OP_NULL:
        sv[sp] = 0;
        sn[sp] = true;
        ++sp;
        break;
      case FA_OP_SCALE: {
        const int t = sp - 1 - dep;
        const long long m = p.consts[arg];
        sv[t] = fa ? fa_raw(fa_f(sv[t]) * (double)m) : fa_wmul(sv[t], m);
        break;
      }
      case FA_OP_LT:
      case FA_OP_LE:
      case FA_OP_GT:
      case FA_OP_GE:
      case FA_OP_EQ:
      case FA_OP_NE: {
        --sp;
        const long long a = sv[sp - 1], b = sv[sp];
        // mixed int/f64 operands compare in f64, as numpy promotes them
        sv[sp - 1] = (fa || fb) ? fa_cmp<double>(op, fa_num(a, fa), fa_num(b, fb))
                                : fa_cmp<long long>(op, a, b);
        sn[sp - 1] = sn[sp - 1] || sn[sp];
        break;
      }
      case FA_OP_AND:
      case FA_OP_OR: {
        --sp;
        const bool an = sn[sp - 1], bn = sn[sp];
        const bool ta = fa_truthy(sv[sp - 1], fa), tb = fa_truthy(sv[sp], fb);
        const bool at = ta && !an, bt = tb && !bn;
        if (op == FA_OP_AND) {
          // false AND anything is false (not null)
          const bool af = !ta && !an, bf = !tb && !bn;
          sv[sp - 1] = at && bt;
          sn[sp - 1] = (an || bn) && !af && !bf;
        } else {
          sv[sp - 1] = at || bt;
          sn[sp - 1] = (an || bn) && !at && !bt;
        }
        break;
      }
      case FA_OP_XOR:
        --sp;
        sv[sp - 1] = fa_truthy(sv[sp - 1], fa) != fa_truthy(sv[sp], fb);
        sn[sp - 1] = sn[sp - 1] || sn[sp];
        break;
      case FA_OP_NOT:
        sv[sp - 1] = !fa_truthy(sv[sp - 1], fa);
        break;
      case FA_OP_IS_NULL:
        sv[sp - 1] = sn[sp - 1];
        sn[sp - 1] = false;
        break;
      case FA_OP_IS_TRUE:
        sv[sp - 1] = fa_truthy(sv[sp - 1], fa) && !sn[sp - 1];
        sn[sp - 1] = false;
        break;
      case FA_OP_IS_FALSE:
        sv[sp - 1] = !fa_truthy(sv[sp - 1], fa) && !sn[sp - 1];
        sn[sp - 1] = false;
        break;
      case FA_OP_PLUS:
      case FA_OP_MINUS:
      case FA_OP_MUL: {
        --sp;
        const long long a = sv[sp - 1], b = sv[sp];
        if (fa || fb) {
          const double x = fa_num(a, fa), y = fa_num(b, fb);
          sv[sp - 1] = fa_raw(op == FA_OP_PLUS ? x + y : op == FA_OP_MINUS ? x - y : x * y);
        } else {
          sv[sp - 1] = op == FA_OP_PLUS ? fa_wadd(a, b)
                     : op == FA_OP_MINUS ? fa_wsub(a, b) : fa_wmul(a, b);
        }
        sn[sp - 1] = sn[sp - 1] || sn[sp];
        break;
      }
      case FA_OP_NEG:
        sv[sp - 1] = fa ? fa_raw(-fa_f(sv[sp - 1])) : fa_wsub(0, sv[sp - 1]);
        break;
      case FA_OP_ABS:
        if (fa) {
          sv[sp - 1] = fa_raw(fabs(fa_f(sv[sp - 1])));
        } else if (sv[sp - 1] < 0) {
          sv[sp - 1] = fa_wsub(0, sv[sp - 1]);
        }
        break;
      case FA_OP_BIT_AND:
      case FA_OP_BIT_OR:
      case FA_OP_BIT_XOR: {
        --sp;
        const long long a = sv[sp - 1], b = sv[sp];
        sv[sp - 1] = op == FA_OP_BIT_AND ? (a & b) : op == FA_OP_BIT_OR ? (a | b) : (a ^ b);
        sn[sp - 1] = sn[sp - 1] || sn[sp];
        break;
      }
      case FA_OP_BIT_NEG:
        sv[sp - 1] = ~sv[sp - 1];
        break;
      case FA_OP_IS_NOT_NULL:
        sv[sp - 1] = !sn[sp - 1];
        sn[sp - 1] = false;
        break;
      case FA_OP_FILTER:
        --sp;
        active = active && fa_truthy(sv[sp], fa) && !sn[sp];
        break;
      case FA_OP_AGG:
        --sp;
        on_agg(arg, active && !sn[sp], sv[sp]);
        break;
      case FA_OP_COUNT1:
        on_agg(arg, active, 0LL);
        break;
      case FA_OP_KEY:
        --sp;
        on_key(arg, sn[sp], sv[sp]);
        break;
      default:
        break;
    }
  }
  return active;
}

// The walk of a plan without sort keys.
template <class P, class OnAgg>
__device__ __forceinline__ bool fa_walk(const P& p, long long f, long long blk, long long i,
                                        OnAgg&& on_agg) {
  return fa_walk_keys(p, f, blk, i, on_agg, [](int, bool, long long) {});
}
