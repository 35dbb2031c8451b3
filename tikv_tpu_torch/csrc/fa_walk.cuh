// The bytecode walk shared by the coprocessor's device kernels.
//
// Replaces rpn.py:eval_rpn(xp=jnp) of the reference package (tikv_tpu/copr),
// which every device program of jax_eval.py inlines, for the ported scalar
// functions: lt le gt ge eq ne, and or xor not, is_null is_true is_false,
// plus minus multiply, with the decimal scale_by alignment applied before
// each operation.  A plan is bytecode for a small stack machine over
// (64-bit value, null) slots; each instruction carries its operands' types,
// fixed at compile time (int64 or f64).  Included by fused_agg.cu (the
// aggregation kernels) and fused_scan.cu (the mask and top-K kernels).
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
};

typedef unsigned long long u64;

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

// The bytecode walk over one row: loads the row's columns, evaluates the
// selection conjuncts and every aggregate argument, and reports each
// aggregate k to on_agg(k, live, value bits), where live = the row passed
// the selection and the argument is not NULL (count(*): passed the
// selection), and each sort key q to on_key(q, null, value bits), whatever
// the selection says.  Returns whether the row passed the selection.  P is
// any parameter block with the columns, the code and the constants
// (FaParams, GaParams, ScParams).
template <class P, class OnAgg, class OnKey>
__device__ __forceinline__ bool fa_walk_keys(const P& p, long long f, OnAgg&& on_agg,
                                             OnKey&& on_key) {
  long long v[FA_MAX_COLS];
  bool vn[FA_MAX_COLS];
  long long sv[FA_MAX_STACK];
  bool sn[FA_MAX_STACK];
#pragma unroll
  for (int j = 0; j < FA_MAX_COLS; ++j) {
    if (j < p.n_cols) {
      v[j] = __ldg(p.col[j] + f);
      vn[j] = p.nul[j] != nullptr && __ldg(p.nul[j] + f) != 0;
    }
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
__device__ __forceinline__ bool fa_walk(const P& p, long long f, OnAgg&& on_agg) {
  return fa_walk_keys(p, f, on_agg, [](int, bool, long long) {});
}
