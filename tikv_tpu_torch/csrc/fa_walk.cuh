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
// fa_walk_keys walks one row (the zone kernels, dict_keys, the first
// value a combine reads again); fa_walk_tile R rows a thread (the mask,
// topn_candidates and every partials kernel of the aggregations:
// fused_agg_partials, fused_group_agg_partials, group_wide_partials,
// batch_partials).
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

// ---------------------------------------------------------------------------
// The tile walk: the same bytecode over R consecutive rows per thread, with
// no local memory (fused_mask, topn_candidates and the partials kernels).
//
// fa_walk_keys keeps a row's columns and its operand stack in arrays indexed
// at run time (v[arg], sv[sp]), which nvcc places in local memory.  The tile
// walk decodes each instruction word once for the thread's R rows (the code
// is the same for every thread, so its switch never diverges) and keeps the
// stack in registers: D slots of R values, every access an unrolled select
// over the slots, so that every array index is a compile-time constant.  The
// NULL flags of a slot's R rows are the bits of one word, and so are the
// rows' selection flags (R <= 8).  A column is loaded where FA_OP_COL pushes
// it, a full aligned tile in 4-, 8- or 16-byte words.  A conjunct that
// compares a column with a constant (COL, CONST, an optional rescale, the
// comparison, FILTER) is evaluated in one step into the selection bits,
// with no stack traffic and one dispatch instead of four or five; a plan of
// such conjuncts only walks with no stack at all (fa_walk_conjuncts).  An
// aggregate's argument and a sort key are handed out as they are popped:
// on_agg(k, live, x, xn) with the rows whose argument counts (selected, not
// NULL; count(*): selected) as bits, and on_key(q, x, xn) whatever the
// selection says, the R values and their NULL bits in registers.  The
// emitter writes every conjunct before the first aggregate or key, so the
// selection bits are final by then, and a Select walk returns there: the
// selection alone.
// ---------------------------------------------------------------------------

// Lanes [0, R) at `base` of a 1-, 2-, 4- or 8-byte payload, sign-extended;
// lanes r >= n (past the block) load as 0.  A full tile of at least 4 bytes
// whose address is aligned to its bytes (at most 16) loads as words, else
// lane by lane.
template <int R, typename T>
__device__ __forceinline__ void fa_lanes(const T* base, int n, long long (&x)[R]) {
  constexpr int B = R * (int)sizeof(T);
  constexpr int A = B < 16 ? B : 16;
  if (B >= 4 && n == R && ((u64)base & (A - 1)) == 0) {
    unsigned w[B >= 4 ? B / 4 : 1];
    if constexpr (B >= 16) {
#pragma unroll
      for (int k = 0; k < B / 16; ++k) {
        const uint4 q = __ldg((const uint4*)base + k);
        w[4 * k] = q.x;
        w[4 * k + 1] = q.y;
        w[4 * k + 2] = q.z;
        w[4 * k + 3] = q.w;
      }
    } else if constexpr (B == 8) {
      const uint2 q = __ldg((const uint2*)base);
      w[0] = q.x;
      w[1] = q.y;
    } else {
      w[0] = __ldg((const unsigned*)base);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (sizeof(T) == 8) {
        x[r] = (long long)(((u64)w[2 * r + 1] << 32) | w[2 * r]);
      } else if constexpr (sizeof(T) == 4) {
        x[r] = (int)w[r];
      } else if constexpr (sizeof(T) == 2) {
        x[r] = (short)(w[r / 2] >> (16 * (r % 2)));
      } else {
        x[r] = (signed char)(w[r / 4] >> (8 * (r % 4)));
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = r < n ? (long long)__ldg(base + r) : 0;
  }
}

// Bit r: bool byte r at `base` is set (r < n); one word where aligned (R
// of 4 or 8 bytes).
template <int R>
__device__ __forceinline__ unsigned fa_flag_bits(const unsigned char* base, int n) {
  unsigned bits = 0;
  if (R >= 4 && n == R && ((u64)base & (R - 1)) == 0) {
    u64 w;
    if constexpr (R == 8) {
      w = __ldg((const unsigned long long*)base);
    } else {
      w = __ldg((const unsigned*)base);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) bits |= (unsigned)(((w >> (8 * r)) & 0xFF) != 0) << r;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < n) bits |= (unsigned)(__ldg(base + r) != 0) << r;
    }
  }
  return bits;
}

// Program #1 over a tile: column j at flat rows f0 + r (rows i0 + r of block
// blk), r < n, as fa_load gives them; their NULL flags as bits of *xn.
// Runs keep fa_load's binary search per row.  Flat: the rows may run past
// the end of block blk into the next blocks (a row-shaped lane is flat in
// memory; a run's block is found row by row).
template <int R, bool Flat = false, class P>
__device__ __forceinline__ void fa_load_tile(const P& p, int j, long long f0, long long blk,
                                             long long i0, int n, long long (&x)[R],
                                             unsigned& xn) {
  const int kind = p.enc.kind[j];
  if (kind == FA_ENC_RLE) {
    xn = 0;
    [[maybe_unused]] long long b = blk, i = i0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bool nb = false;
      if constexpr (Flat) {
        while (i >= p.block_rows) {
          i -= p.block_rows;
          ++b;
        }
        x[r] = r < n ? fa_load(p, j, f0 + r, b, i, nb) : 0;
        ++i;
      } else {
        x[r] = r < n ? fa_load(p, j, f0 + r, blk, i0 + r, nb) : 0;
      }
      xn |= (unsigned)nb << r;
    }
    return;
  }
  xn = p.nul[j] != nullptr ? fa_flag_bits<R>(p.nul[j] + f0, n) : 0;
  const void* col = p.col[j];
  switch (p.enc.width[j]) {
    case 1: fa_lanes<R>((const signed char*)col + f0, n, x); break;
    case 2: fa_lanes<R>((const short*)col + f0, n, x); break;
    case 4: fa_lanes<R>((const int*)col + f0, n, x); break;
    default: fa_lanes<R>((const long long*)col + f0, n, x); break;
  }
  if (kind != FA_ENC_PLAIN) {
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = (xn >> r) & 1 ? 0 : fa_wadd(x[r], p.enc.ref[j]);
  }
}

// The operand stack of a tile: D slots of R values and their NULL bits.
template <int R, int D>
struct FaTileStack {
  long long v[D][R];
  unsigned n[D];
};

template <int R, int D>
__device__ __forceinline__ void fa_get(const FaTileStack<R, D>& s, int t, long long (&x)[R],
                                       unsigned& xn) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (k == t) {
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = s.v[k][r];
      xn = s.n[k];
    }
  }
}

template <int R, int D>
__device__ __forceinline__ void fa_put(FaTileStack<R, D>& s, int t, const long long (&x)[R],
                                       unsigned xn) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (k == t) {
#pragma unroll
      for (int r = 0; r < R; ++r) s.v[k][r] = x[r];
      s.n[k] = xn;
    }
  }
}

// Bit r: x[r] <op> y[r] (op one of LT..NE), f64 where either side is (a
// mixed pair compares in f64, as numpy promotes it).  Each row takes three
// comparisons and no branch; the op picks their combination once: NE is the
// complement of EQ, so a NaN is unequal to everything, as in numpy.
template <int R>
__device__ __forceinline__ unsigned fa_cmp_bits(int op, const long long (&x)[R],
                                                const long long (&y)[R], bool fx, bool fy) {
  unsigned lt = 0, gt = 0, eq = 0;
  if (fx || fy) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const double a = fa_num(x[r], fx), b = fa_num(y[r], fy);
      lt |= (unsigned)(a < b) << r;
      gt |= (unsigned)(a > b) << r;
      eq |= (unsigned)(a == b) << r;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      lt |= (unsigned)(x[r] < y[r]) << r;
      gt |= (unsigned)(x[r] > y[r]) << r;
      eq |= (unsigned)(x[r] == y[r]) << r;
    }
  }
  switch (op) {
    case FA_OP_LT: return lt;
    case FA_OP_LE: return lt | eq;
    case FA_OP_GT: return gt;
    case FA_OP_GE: return gt | eq;
    case FA_OP_EQ: return eq;
    default: return ~eq & ((1u << R) - 1);  // FA_OP_NE
  }
}

// Bit r: value r is true.
template <int R>
__device__ __forceinline__ unsigned fa_truth_bits(const long long (&x)[R], bool is_f) {
  unsigned bits = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) bits |= (unsigned)fa_truthy(x[r], is_f) << r;
  return bits;
}

template <int R>
__device__ __forceinline__ void fa_set_bits(long long (&x)[R], unsigned bits) {
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] = (bits >> r) & 1;
}

// The words of a conjunct `column <cmp> constant` starting at pc, a decimal
// rescale of either side between the constant and the comparison: COL,
// CONST, SCALE (depth 0 or 1)?, LT..NE, FILTER; 0 when the code there has
// another shape.  The host's launcher asks it too (which instance to run).
template <class P>
__host__ __device__ __forceinline__ int fa_cmp_filter_len(const P& p, int pc) {
  if (pc + 3 >= p.n_code || (p.code[pc] & 0xFF) != FA_OP_COL
      || (p.code[pc + 1] & 0xFF) != FA_OP_CONST) {
    return 0;
  }
  int q = pc + 2;
  if ((p.code[q] & 0xFF) == FA_OP_SCALE) {
    if (((p.code[q] >> 24) & 0xFF) > 1) return 0;
    ++q;
  }
  if (q + 1 >= p.n_code) return 0;
  const int op = p.code[q] & 0xFF;
  if (op < FA_OP_LT || op > FA_OP_NE || (p.code[q + 1] & 0xFF) != FA_OP_FILTER) return 0;
  return q + 2 - pc;
}

// The conjunct of fa_cmp_filter_len at pc over the column's lanes x and
// NULL bits xn (loaded for its COL word): the rows it keeps, as bits.  The
// comparison's value is 0 or 1, NULL where the column is, so FILTER keeps
// the rows whose comparison holds on a non-NULL value.
template <int R, class P>
__device__ __forceinline__ unsigned fa_cmp_filter(const P& p, int pc, int len, long long (&x)[R],
                                                  unsigned xn) {
  const int wc = p.code[pc + 1];
  long long c = p.consts[(wc >> 8) & 0xFF];
  int q = pc + 2;
  if (len == 5) {
    const int ws = p.code[q++];
    const long long m = p.consts[(ws >> 8) & 0xFF];
    const bool fs = (ws >> 16) & 1;
    if (((ws >> 24) & 0xFF) == 0) {
      c = fs ? fa_raw(fa_f(c) * (double)m) : fa_wmul(c, m);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) x[r] = fs ? fa_raw(fa_f(x[r]) * (double)m) : fa_wmul(x[r], m);
    }
  }
  const int w = p.code[q];
  long long cs[R];
#pragma unroll
  for (int r = 0; r < R; ++r) cs[r] = c;
  return fa_cmp_bits(w & 0xFF, x, cs, (w >> 16) & 1, (w >> 17) & 1) & ~xn;
}

// The walk of a plan whose every conjunct compares a column with a constant
// (fa_cmp_filter_len matches at each one, which the launcher checks): no
// stack at all, so it needs the fewest registers and the card holds the
// most threads (requesting a group of conjuncts' lanes at once was slower,
// its buffers halving the threads).  The tile as in fa_walk_tile.
template <int R, class P>
__device__ __forceinline__ unsigned fa_walk_conjuncts(const P& p, long long f0, long long blk,
                                                      long long i0, int n, unsigned valid) {
  unsigned active = valid;
  for (int pc = 0; pc < p.n_code;) {
    const int len = fa_cmp_filter_len(p, pc);
    if (len == 0) break;  // another shape: the launcher runs such plans on fa_walk_tile
    long long x[R];
    unsigned xn;
    fa_load_tile<R>(p, (p.code[pc] >> 8) & 0xFF, f0, blk, i0, n, x, xn);
    active &= fa_cmp_filter<R>(p, pc, len, x, xn);
    pc += len;
  }
  return active;
}

// The walk over the tile at flat row f0 (row i0 of block blk): n rows of the
// block (n <= R; Flat: of the image, possibly past the block's end), of
// which those set in `valid` count.  Returns the rows that passed the
// selection, as bits.  The stack holds D <= FA_MAX_STACK slots: the plan's
// depth, which the caller checks.  Each aggregate's argument goes to on_agg,
// each sort key to on_key (see above).
template <int R, int D, bool Flat = false, bool Select = false, class P, class OnAgg,
          class OnKey>
__device__ __forceinline__ unsigned fa_walk_tile(const P& p, long long f0, long long blk,
                                                 long long i0, int n, unsigned valid,
                                                 OnAgg&& on_agg, OnKey&& on_key) {
  static_assert(R <= 8 && D <= FA_MAX_STACK, "tile walk limits");
  constexpr unsigned ALL = (1u << R) - 1;
  FaTileStack<R, D> s;
  long long a[R], b[R];
  unsigned an = 0, bn = 0;
  int sp = 0;
  unsigned active = valid;
  for (int pc = 0; pc < p.n_code; ++pc) {
    const int w = p.code[pc];
    const int op = w & 0xFF;
    const int arg = (w >> 8) & 0xFF;
    const bool fa = (w >> 16) & 1;
    const bool fb = (w >> 17) & 1;
    const int dep = (w >> 24) & 0xFF;
    switch (op) {
      case FA_OP_COL: {
        fa_load_tile<R, Flat>(p, arg, f0, blk, i0, n, a, an);
        // `column <cmp> constant` goes straight into the selection, past
        // the stack: the most common conjunct
        const int len = fa_cmp_filter_len(p, pc);
        if (len > 0) {
          active &= fa_cmp_filter<R>(p, pc, len, a, an);
          pc += len - 1;
        } else {
          fa_put(s, sp++, a, an);
        }
        break;
      }
      case FA_OP_CONST: {
        const long long c = p.consts[arg];
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = c;
        fa_put(s, sp++, a, 0u);
        break;
      }
      case FA_OP_NULL:
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = 0;
        fa_put(s, sp++, a, ALL);
        break;
      case FA_OP_SCALE: {
        const int t = sp - 1 - dep;
        const long long m = p.consts[arg];
        fa_get(s, t, a, an);
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = fa ? fa_raw(fa_f(a[r]) * (double)m) : fa_wmul(a[r], m);
        fa_put(s, t, a, an);
        break;
      }
      case FA_OP_LT:
      case FA_OP_LE:
      case FA_OP_GT:
      case FA_OP_GE:
      case FA_OP_EQ:
      case FA_OP_NE:
        fa_get(s, sp - 2, a, an);
        fa_get(s, sp - 1, b, bn);
        fa_set_bits(a, fa_cmp_bits(op, a, b, fa, fb));
        fa_put(s, sp - 2, a, an | bn);
        --sp;
        break;
      case FA_OP_AND:
      case FA_OP_OR: {
        fa_get(s, sp - 2, a, an);
        fa_get(s, sp - 1, b, bn);
        const unsigned ta = fa_truth_bits(a, fa), tb = fa_truth_bits(b, fb);
        const unsigned at = ta & ~an, bt = tb & ~bn;
        unsigned val, nul;
        if (op == FA_OP_AND) {
          // false AND anything is false (not null)
          const unsigned af = ~ta & ~an, bf = ~tb & ~bn;
          val = at & bt;
          nul = (an | bn) & ~af & ~bf;
        } else {
          val = at | bt;
          nul = (an | bn) & ~at & ~bt;
        }
        fa_set_bits(a, val);
        fa_put(s, sp - 2, a, nul & ALL);
        --sp;
        break;
      }
      case FA_OP_XOR:
        fa_get(s, sp - 2, a, an);
        fa_get(s, sp - 1, b, bn);
        fa_set_bits(a, fa_truth_bits(a, fa) ^ fa_truth_bits(b, fb));
        fa_put(s, sp - 2, a, an | bn);
        --sp;
        break;
      case FA_OP_NOT:
        fa_get(s, sp - 1, a, an);
        fa_set_bits(a, ~fa_truth_bits(a, fa));
        fa_put(s, sp - 1, a, an);
        break;
      case FA_OP_IS_NULL:
        fa_get(s, sp - 1, a, an);
        fa_set_bits(a, an);
        fa_put(s, sp - 1, a, 0u);
        break;
      case FA_OP_IS_TRUE:
        fa_get(s, sp - 1, a, an);
        fa_set_bits(a, fa_truth_bits(a, fa) & ~an);
        fa_put(s, sp - 1, a, 0u);
        break;
      case FA_OP_IS_FALSE:
        fa_get(s, sp - 1, a, an);
        fa_set_bits(a, ~fa_truth_bits(a, fa) & ~an);
        fa_put(s, sp - 1, a, 0u);
        break;
      case FA_OP_IS_NOT_NULL:
        fa_get(s, sp - 1, a, an);
        fa_set_bits(a, ~an);
        fa_put(s, sp - 1, a, 0u);
        break;
      case FA_OP_PLUS:
      case FA_OP_MINUS:
      case FA_OP_MUL:
        fa_get(s, sp - 2, a, an);
        fa_get(s, sp - 1, b, bn);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (fa || fb) {
            const double x = fa_num(a[r], fa), y = fa_num(b[r], fb);
            a[r] = fa_raw(op == FA_OP_PLUS ? x + y : op == FA_OP_MINUS ? x - y : x * y);
          } else {
            a[r] = op == FA_OP_PLUS ? fa_wadd(a[r], b[r])
                 : op == FA_OP_MINUS ? fa_wsub(a[r], b[r]) : fa_wmul(a[r], b[r]);
          }
        }
        fa_put(s, sp - 2, a, an | bn);
        --sp;
        break;
      case FA_OP_NEG:
        fa_get(s, sp - 1, a, an);
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = fa ? fa_raw(-fa_f(a[r])) : fa_wsub(0, a[r]);
        fa_put(s, sp - 1, a, an);
        break;
      case FA_OP_ABS:
        fa_get(s, sp - 1, a, an);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (fa) {
            a[r] = fa_raw(fabs(fa_f(a[r])));
          } else if (a[r] < 0) {
            a[r] = fa_wsub(0, a[r]);
          }
        }
        fa_put(s, sp - 1, a, an);
        break;
      case FA_OP_BIT_AND:
      case FA_OP_BIT_OR:
      case FA_OP_BIT_XOR:
        fa_get(s, sp - 2, a, an);
        fa_get(s, sp - 1, b, bn);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          a[r] = op == FA_OP_BIT_AND ? (a[r] & b[r])
               : op == FA_OP_BIT_OR ? (a[r] | b[r]) : (a[r] ^ b[r]);
        }
        fa_put(s, sp - 2, a, an | bn);
        --sp;
        break;
      case FA_OP_BIT_NEG:
        fa_get(s, sp - 1, a, an);
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = ~a[r];
        fa_put(s, sp - 1, a, an);
        break;
      case FA_OP_FILTER:
        fa_get(s, sp - 1, a, an);
        active &= fa_truth_bits(a, fa) & ~an;
        --sp;
        break;
      case FA_OP_AGG:
      case FA_OP_COUNT1: {
        if constexpr (Select) return active;
        // one call site for both, so a large fold is inlined once
        unsigned live = active;
        if (op == FA_OP_AGG) {
          fa_get(s, sp - 1, a, an);
          --sp;
          live &= ~an;
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) a[r] = 0;
          an = 0;
        }
        on_agg(arg, live, a, an);
        break;
      }
      case FA_OP_KEY:
        if constexpr (Select) return active;
        fa_get(s, sp - 1, a, an);
        --sp;
        on_key(arg, a, an);
        break;
      default:
        break;
    }
  }
  return active;
}

// The selection alone (fused_mask): aggregates and keys popped unread.
template <int R, int D, class P>
__device__ __forceinline__ unsigned fa_walk_tile(const P& p, long long f0, long long blk,
                                                 long long i0, int n, unsigned valid) {
  return fa_walk_tile<R, D>(p, f0, blk, i0, n, valid,
                            [](int, unsigned, const long long (&)[R], unsigned) {},
                            [](int, const long long (&)[R], unsigned) {});
}
