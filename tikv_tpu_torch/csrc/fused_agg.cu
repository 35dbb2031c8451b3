// Fused scan-filter-aggregate kernels of the coprocessor's device path.
//
// Replaces these JAX programs of the reference package (tikv_tpu/copr):
//   * rpn.py:eval_rpn(xp=jnp), inlined into the programs below, for the
//     ported scalar functions: lt le gt ge eq ne, and or xor not,
//     is_null is_true is_false, plus minus multiply, with the decimal
//     scale_by alignment applied before each operation;
//   * jax_eval.py:_build_agg_fn (site jax_eval.agg_step), i.e. _fused_step
//     plus _DeviceAgg.update, at group capacity 1, for count/sum/avg/min/max;
//   * jax_eval.py:_build_scan_fn (site jax_eval.scan): the same block step
//     over every block of a stacked [n_blocks, block_rows] image;
//   * jax_eval.py:_pack_state (site jax_eval.pack): the carry packed into
//     one int64 and one f64 matrix for a single pull.
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
// Determinism: the grid is fixed (FA_GRID blocks of FA_THREADS threads), a
// row goes to thread (flat row index mod grid size), and every reduction
// runs in a fixed order, so f64 sums are bit-identical from run to run.
// Integer arithmetic is done in unsigned 64-bit and cast back, which wraps
// as numpy does (signed overflow is undefined in C++), so integer and
// decimal results are exact and independent of order.
//
// Layout contract with tikv_tpu_torch/copr/fused_agg.py (a CPU test checks
// the opcode table; the wrapper checks sizeof(FaParams) at load).

#include <cuda_runtime.h>

#define FA_MAX_COLS 16
#define FA_MAX_CONSTS 64
#define FA_MAX_CODE 256
#define FA_MAX_AGGS 16
#define FA_MAX_STACK 8
#define FA_THREADS 256
#define FA_GRID 528

// first-row sentinel of the packed state (jax_eval.py _NO_ROW)
#define FA_NO_ROW (1LL << 62)

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
};

enum { FA_AGG_COUNT = 0, FA_AGG_SUM = 1, FA_AGG_MIN = 2, FA_AGG_MAX = 3 };

struct FaParams {
  const long long* col[FA_MAX_COLS];       // [n_blocks, block_rows] lanes, int64 or f64 bits
  const unsigned char* nul[FA_MAX_COLS];   // bool null masks, or null for NOT NULL columns
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

  long long v[FA_MAX_COLS];
  bool vn[FA_MAX_COLS];
  long long sv[FA_MAX_STACK];
  bool sn[FA_MAX_STACK];

  for (; f < total; f += stride) {
    const long long nv = p.n_valids != nullptr ? __ldg(p.n_valids + blk) : p.n_valid_all;
    if (i < nv) {
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
            if (active && !sn[sp]) {
              cnt[arg] += 1;
              const int kind = p.agg_kind[arg];
              if (kind != FA_AGG_COUNT) acc[arg] = fa_merge(kind, p.agg_f64[arg], acc[arg], sv[sp]);
            }
            break;
          case FA_OP_COUNT1:
            cnt[arg] += active ? 1 : 0;
            break;
          default:
            break;
        }
      }
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

}  // extern "C"
