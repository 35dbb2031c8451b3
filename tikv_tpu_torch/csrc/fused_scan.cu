// Scan kernels of the coprocessor's device path: the selection mask and the
// running top-K.
//
// Replaces these JAX programs of the reference package (tikv_tpu/copr):
//   * jax_eval.py:_build_mask_fn (site jax_eval.mask): the selection
//     conjuncts over a block, `valid & AND_i (sel_i != 0 & ~null_i)`
//     -> fused_mask (the tile walk of fa_walk.cuh);
//   * jax_eval.py:_build_topn_fn / _topn_step (site jax_eval.topn): one step
//     of the running top-K of a raw TopN, a stable lexicographic sort of
//     the carried K rows ahead of the block's rows -> topn_candidates (a
//     sorted run of K per tile of rows) + topn_merge (up to TN_FAN_MAX runs
//     merged into their first K by one block, the carry as one more run:
//     one launch for a block's or a shard's runs, three for 100M rows);
//   * jax_eval.py:_pack_leaves (site jax_eval.pack_topn): the K-row state
//     stacked into one int64 and one f64 matrix for one pull -> topn_pack,
//     which also gathers the K winners' payload columns.
// Each evaluates rpn.py:eval_rpn(xp=jnp) through the bytecode walk of
// fa_walk.cuh and reads every column of an encoded image through its column
// load fa_load (program #1, kernels.py:decode_device_column), topn_pack's
// payload gather included.  decode_column runs that load alone over one
// column, writing its int64 lanes and null bytes: the checks hold program
// #1 to its plain version with it and time it; no query path launches it.
//
// Order of a top-K entry: it is a tuple of 64-bit words compared as
// unsigned, lexicographically:
//   rank (0: the row passed the selection; 1: it did not, or lies past its
//   block's n_valid), then per sort key its null rank (NULLs first
//   ascending, last descending) and its key word, then `src`, the row's
//   position in the stream.  A key word is the value made order-preserving
//   as u64 (int64: the sign bit flipped; f64: -0 taken as +0, then the
//   sign-flip transform), bit-NOT for a descending key, 0 for NULL.  `src`
//   is unique, so the order is total and no sort needs to be stable: it is
//   jax_eval._topn_step's "stable sort, carry ahead of the block" made
//   explicit, and the CPU comparator's (executors.py:_row_cmp) order.
//
// What bounds them on an H100: memory for fused_mask (the referenced
// columns of every row, one byte of mask out; over a narrow encoded image
// its loads, one conjunct's after another, and the walk's instructions
// keep it above that) and for topn_candidates (the same columns, the runs
// out), which the walk's instructions and the select's block-wide passes
// keep above that.  topn_candidates walks a tile TN_ROWS rows a thread
// (fa_walk_tile, no local memory), holds one 64-bit chunk of each entry in
// registers, selects the tile's first k by a radix select over those
// chunks (a pass only on the bits where the tied entries differ), walks
// again only the steps that hold a candidate, and sorts at most `cap`
// candidates (about 2k) in shared memory instead of the whole tile: its
// shared memory follows k, so several blocks share an SM.
// topn_merge moves little (a shard's 33 runs of K = 100 entries: 0.1 MB):
// launches and dependent loads bound it.  Its pairwise levels, one launch
// each with every entry's place searched in device memory, became one
// block a group of runs that stages them in shared memory and merges them
// there by a tree of merge-path levels, one barrier a level, each
// comparison on 64-bit prefixes of the entries.  The candidate
// kernel reads only the columns the selection and the keys reference;
// payload columns are read by topn_pack for the K winners alone.
// topn_pack moves a few KB (K = 100, five payload columns): launch latency
// and its dependent loads bound it.  A thread a (payload column, slot) cell
// and a (word, slot) cell of the run, every load before any store: two
// rounds of loads a launch (the slot's rank and src, then the value and its
// null flag), whatever the number of payload columns.
//
// fused_mask walks SC_MASK_ROWS consecutive rows of one block a thread
// (fa_walk_tile): each instruction word is decoded once for the tile, the
// operand stack lives in registers (no local memory), a column is loaded
// where the code pushes it, in 4- to 16-byte words for a full aligned tile,
// a `column <cmp> constant` conjunct is evaluated in one step, n_valid is
// read once a tile and the tile's mask bytes are stored as one word.  A tile
// never straddles two blocks: a block whose row count is not a multiple of
// the tile ends in a short one.  The stack's depth is a template argument
// (2, 4 or 8 slots; the launcher reads the plan's depth from its code), so
// that a shallow plan holds no dead registers; a plan whose conjuncts all
// compare a column with a constant (config 2's) runs the instance with no
// stack (fa_walk_conjuncts), which needs the fewest registers; the grid is
// the number of blocks the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs), each thread
// stepping over tiles by the grid's stride.
//
// Determinism: no floating-point arithmetic in any order that varies;
// topn_candidates' atomics count (a histogram) or hand out shared-memory
// slots, whose order its sort removes (entries are unique but for the
// identical ones past the image); reruns are bit-identical.
//
// Layout contract with tikv_tpu_torch/copr/fused_mask.py and
// copr/fused_topn.py (the wrappers check sizeof(ScParams) and
// sizeof(TpParams) at load; a CPU test checks the limits).

#include <cuda_pipeline.h>

#include "fa_walk.cuh"

#define SC_MASK_THREADS 256
#define SC_MASK_ROWS 4  // rows a mask thread walks at once (its tile)
#define TN_THREADS 256
#define TP_THREADS 256       // a topn_pack block: a thread a payload cell or run cell
#define TN_TREE_THREADS 512  // a topn_merge block
#define TN_FAN_MAX 64        // runs a topn_merge block merges at most
#define TN_MERGE_WORDS 11    // the widest entry a topn_merge takes: a mesh finalize's
// dynamic shared memory a topn_merge block may use: all but its run pointers
#define TN_MERGE_SMEM (TN_SMEM_MAX - TN_FAN_MAX * 8)
#define TN_MAX_KEYS 4
#define TN_MAX_PAYLOAD 16
// dynamic shared memory a block may use on Hopper (227 KB)
#define TN_SMEM_MAX 232448

// The walk's parameters for the mask and the candidates.
struct ScParams {
  const void* col[FA_MAX_COLS];            // payloads: [n_blocks, block_rows] lanes (rle: run values)
  const unsigned char* nul[FA_MAX_COLS];   // bool null masks, or null for NOT NULL columns
  FaEnc enc;                               // how each column loads (program #1)
  const long long* n_valids;               // [n_blocks], or null: n_valid_all for every block
  long long n_valid_all;
  long long n_blocks;
  long long block_rows;
  long long src_base;                      // top-K: src of flat row 0
  long long consts[FA_MAX_CONSTS];
  int code[FA_MAX_CODE];
  int n_code;
  int n_cols;
  int n_keys;                              // top-K: sort keys
  int k;                                   // top-K: entries per run
  int tile;                                // top-K: rows per block, a power of two >= k
  int key_desc[TN_MAX_KEYS];
  int key_f64[TN_MAX_KEYS];                // the key's value lane is f64
};

static_assert(TN_MAX_PAYLOAD == FA_MAX_COLS, "FaEnc describes the payload columns too");

// topn_pack's parameters.
struct TpParams {
  const void* col[TN_MAX_PAYLOAD];           // payload columns of the image (rle: run values)
  const unsigned char* nul[TN_MAX_PAYLOAD];  // their null masks, or null
  FaEnc enc;                                 // how each payload column loads (program #1)
  const long long* carry_i;                  // the previous packed state, or null
  const double* carry_f;
  const u64* run;                            // the merged run [n_words][k]
  long long* out_i;                          // packed state [n_int][k]
  double* out_f;                             // [n_f64][k]
  u64* out_run;                              // the run as the next step's carry [n_words][k]
  long long src_base;                        // src below it: the carry's slot; else flat row + src_base
  long long block_rows;
  int k;
  int n_words;
  int n_pay;
  int pay_f64[TN_MAX_PAYLOAD];
  int pay_row[TN_MAX_PAYLOAD];               // row of the value in the int64 or f64 matrix
  int pay_null_row[TN_MAX_PAYLOAD];          // row of the null flag in the int64 matrix
};

__device__ __forceinline__ long long sc_n_valid(const ScParams& p, long long blk) {
  return p.n_valids != nullptr ? __ldg(p.n_valids + blk) : p.n_valid_all;
}

// ---------------------------------------------------------------------------
// fused_mask: SC_MASK_ROWS rows a thread (a tile of one block), grid-stride
// over tiles
// ---------------------------------------------------------------------------

static_assert(SC_MASK_ROWS == 4, "fused_mask stores a tile's mask bytes as one 32-bit word");

// The minimum of one block an SM lets ptxas give the walk the registers it
// needs: without it, the 2-slot instance is held to 64 and spills.
template <int D>
__global__ void __launch_bounds__(SC_MASK_THREADS, 1)
fused_mask(const __grid_constant__ ScParams p, unsigned char* __restrict__ out) {
  constexpr int R = SC_MASK_ROWS;
  const long long tiles = (p.block_rows + R - 1) / R;  // tiles a block
  const long long total = p.n_blocks * tiles;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  FaCursor c(t, stride, tiles);
  for (; t < total; t += stride) {
    const long long i0 = c.i * R;
    const long long f0 = c.blk * p.block_rows + i0;
    const long long left = p.block_rows - i0;
    const int n = left < R ? (int)left : R;  // the block's rows in the tile
    const long long nv = sc_n_valid(p, c.blk) - i0;
    const int live = nv <= 0 ? 0 : nv < n ? (int)nv : n;
    unsigned active = 0;
    if (live > 0) {
      if constexpr (D == 0) {
        active = fa_walk_conjuncts<R>(p, f0, c.blk, i0, n, (1u << live) - 1);
      } else {
        active = fa_walk_tile<R, D>(p, f0, c.blk, i0, n, (1u << live) - 1);
      }
    }
    unsigned char* dst = out + f0;
    if (n == R && ((u64)dst & (R - 1)) == 0) {
      unsigned word = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) word |= ((active >> r) & 1u) << (8 * r);
      *(unsigned*)dst = word;
    } else {
      for (int r = 0; r < n; ++r) dst[r] = (active >> r) & 1;
    }
    c.advance();
  }
}

typedef void (*ScMaskKernel)(ScParams, unsigned char*);

// Whether every conjunct of the plan compares a column with a constant
// (fa_cmp_filter_len matches at each one).
static bool sc_conjuncts_only(const ScParams* p) {
  for (int pc = 0; pc < p->n_code;) {
    const int len = fa_cmp_filter_len(*p, pc);
    if (len == 0) return false;
    pc += len;
  }
  return true;
}

// The instance that runs the plan and its stack slots: none for
// column-constant conjuncts only, else the fewest of 2, 4 or 8 that hold its
// stack; nullptr for a plan deeper than FA_MAX_STACK (the compiler refuses
// those).
static ScMaskKernel sc_mask_kernel(const ScParams* p, int* slots) {
  static_assert(FA_MAX_STACK == 8, "the mask instances' slots");
  if (sc_conjuncts_only(p)) {
    *slots = 0;
    return fused_mask<0>;
  }
  *slots = fa_stack_slots(*p);
  if (*slots == 0) return nullptr;
  return *slots == 2 ? fused_mask<2> : *slots == 4 ? fused_mask<4> : fused_mask<8>;
}

// ---------------------------------------------------------------------------
// decode_column: program #1 alone over column 0, every row of every block
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SC_MASK_THREADS)
decode_column(const __grid_constant__ ScParams p, long long* __restrict__ out,
              unsigned char* __restrict__ out_nul) {
  const long long total = p.n_blocks * p.block_rows;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  FaCursor c(f, stride, p.block_rows);
  for (; f < total; f += stride) {
    bool nul;
    out[f] = fa_load(p, 0, f, c.blk, c.i, nul);
    out_nul[f] = nul;
    c.advance();
  }
}

// ---------------------------------------------------------------------------
// topn_candidates: each block selects a tile's first k entries, sorts them
// ---------------------------------------------------------------------------

// Order-preserving u64 of a key value (ascending).
__device__ __forceinline__ u64 tn_order_word(long long v, bool is_f) {
  if (is_f) {
    u64 b = (u64)v;
    if ((b << 1) == 0) b = 0;  // -0 ties +0
    return (b >> 63) ? ~b : (b | 0x8000000000000000ULL);
  }
  return (u64)v ^ 0x8000000000000000ULL;
}

// -1, 0, 1 as entry x of X orders before, with, after entry y of Y; entries
// are words w at X[w * sx + x].
__device__ __forceinline__ int tn_cmp(const u64* X, long long sx, long long x, const u64* Y,
                                      long long sy, long long y, int n_words) {
  for (int w = 0; w < n_words; ++w) {
    const u64 a = X[w * sx + x], b = Y[w * sy + y];
    if (a != b) return a < b ? -1 : 1;
  }
  return 0;
}

// The words of sort key q over R rows: the null rank and the key word.
template <int R>
__device__ __forceinline__ void tn_key_words(const ScParams& p, int q, const long long (&x)[R],
                                             unsigned xn, unsigned valid, u64 (&kw)[R],
                                             unsigned& nr) {
  const bool desc = p.key_desc[q];
  const bool is_f = p.key_f64[q];
  nr = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool nul = (xn >> r) & 1;
    u64 w = tn_order_word(x[r], is_f);
    if (desc) w = ~w;
    const bool ok = (valid >> r) & 1;  // rows past n_valid or the image: 0 and 0
    kw[r] = ok && !nul ? w : 0;
    nr |= (unsigned)(ok && nul == desc) << r;
  }
}

// A tile of p.tile rows (TN_THREADS * TN_ROWS * steps, steps <= TN_STEPS):
// thread `tid` holds entries e = s * TN_ROWS + r, the tile's row s *
// TN_THREADS * TN_ROWS + tid * TN_ROWS + r.  Selecting the first k, the
// entry is seen as a string of 64-bit chunks that orders as its words do:
//   0: rank << 63 | null rank of key 0 << 62 | key word 0 >> 2;
//   then per key q: its key word (odd chunks), and, before key q + 1, its
//   null rank << 63 | its key word >> 1 (even chunks);
//   last: the row's index in the tile, which orders as src does (src is
//   unique, past the image ~0 and the rows there last in the tile).
// A radix select, 8 bits a pass from the highest bit on which the entries
// still tied differ, keeps the entries below the k-th one's bucket (`in`)
// and narrows the tied ones to that bucket, chunk by chunk (a chunk past 0
// is walked again, for the tied entries' steps only), until those below and
// those tied fit `cap` slots.  They are walked once more into shared memory
// with all their words, sorted, and the first k written.
#define TN_ROWS 4
#define TN_STEPS 4
#define TN_ENTRIES (TN_ROWS * TN_STEPS)
#define TN_BINS 256
static_assert(TN_THREADS == TN_BINS, "a thread a histogram bin");
static_assert(TN_ENTRIES <= 32, "a thread's entries as the bits of a word");

// Dynamic shared memory: n_words * cap u64 words, then cap u16 indices.
// Writes runs[blockIdx.x] = [n_words][k]: the tile's first k entries in
// order.  Rows past the image are entries of rank 1 with src = ~0.  D: the
// tile walk's stack slots.
template <int D>
__global__ void __launch_bounds__(TN_THREADS)
topn_candidates(const __grid_constant__ ScParams p, u64* __restrict__ runs, int cap) {
  constexpr int R = TN_ROWS, E = TN_ENTRIES;
  constexpr unsigned FULL = 0xFFFFFFFFu;
  extern __shared__ u64 tn_smem[];
  __shared__ unsigned hist[2][TN_BINS];  // a pass's histogram, the next one's zeroed
  __shared__ unsigned red[2][2];  // OR and AND of the tied chunks, low and high halves
  __shared__ int sel[3];          // the bucket, the tied entries below it, in it
  __shared__ int n_out;
  __shared__ u64 sk[TN_THREADS];             // at most TN_THREADS candidates: chunk 0 by
  __shared__ unsigned short ss[TN_THREADS];  // slot, then the sort's exchanges
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = p.tile / (TN_THREADS * R);
  const int W = 2 + 2 * p.n_keys;
  const int k = p.k;
  const long long total = p.n_blocks * p.block_rows;
  const long long base = (long long)blockIdx.x * p.tile;
  const int last = p.n_keys > 0 ? 2 * p.n_keys : 1;  // the index chunk
  u64* w = tn_smem;
  unsigned short* idx = (unsigned short*)(tn_smem + (long long)W * cap);

  u64 v[E];  // the chunk being selected, per entry
  const unsigned all = S * R >= 32 ? FULL : (1u << (S * R)) - 1;
  unsigned tied = all, in = 0, gather = 0;
  int below = 0;  // the entries in `in`, over the block
  int cnt = TN_THREADS * S * R;  // the tied ones

  // Walk step s (the tile's rows of entries s * R ..) for chunk c of the
  // entries in `want` (c < 0: gather them into shared memory from slot0 on).
  auto walk_step = [&](int s, int c, unsigned want, int slot0) {
    const long long f0 = base + (long long)s * (TN_THREADS * R) + tid * R;
    const long long left = total - f0;
    const int n = left <= 0 ? 0 : left < R ? (int)left : R;
    long long blk = 0, i0 = 0;
    unsigned valid = 0;
    if (n > 0) {
      blk = f0 / p.block_rows;
      i0 = f0 - blk * p.block_rows;
      long long b = blk, i = i0, nv = sc_n_valid(p, blk);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < n) {
          if (i >= p.block_rows) {
            i -= p.block_rows;
            ++b;
            nv = sc_n_valid(p, b);
          }
          valid |= (unsigned)(i < nv) << r;
          ++i;
        }
      }
    }
    // chunk c reads key kq: its whole word (odd c), or its null rank and
    // word's top (c even, past 0)
    const int kq = c <= 0 ? 0 : (c & 1) ? (c - 1) / 2 : c / 2;
    u64 kw[R];
    unsigned nr = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) kw[r] = 0;
    const unsigned active = fa_walk_tile<R, D, true>(
        p, f0, blk, i0, n, valid, [](int, unsigned, const long long (&)[R], unsigned) {},
        [&](int q, const long long (&x)[R], unsigned xn) {
          if (c >= 0 && q != kq) return;
          u64 qw[R];
          unsigned qn;
          tn_key_words<R>(p, q, x, xn, valid, qw, qn);
          if (q == kq) {
#pragma unroll
            for (int r = 0; r < R; ++r) kw[r] = qw[r];
            nr = qn;
          }
          if (c >= 0) return;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int e = s * R + r;
            if ((want >> e) & 1) {
              const int slot = slot0 + __popc(want & ((1u << e) - 1));
              w[(long long)(1 + 2 * q) * cap + slot] = (qn >> r) & 1;
              w[(long long)(2 + 2 * q) * cap + slot] = qw[r];
            }
          }
        });
    const unsigned rank1 = ~(valid & active);
    u64 y[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const u64 rank = (rank1 >> r) & 1;
      const u64 nb = (nr >> r) & 1;
      if (c <= 0) {
        y[r] = rank << 63 | (p.n_keys > 0 ? nb << 62 | kw[r] >> 2 : 0);
      } else {
        y[r] = (c & 1) ? kw[r] : nb << 63 | kw[r] >> 1;
      }
      if (c < 0) {
        const int e = s * R + r;
        if ((want >> e) & 1) {
          const int slot = slot0 + __popc(want & ((1u << e) - 1));
          w[slot] = rank;
          w[(long long)(W - 1) * cap + slot] = r < n ? (u64)(p.src_base + f0 + r) : ~0ULL;
          if (cap <= TN_THREADS) sk[slot] = y[r];  // chunk 0: the sort's first key
        }
      }
    }
    if (c >= 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e / R == s) v[e] = y[e % R];
      }
    }
  };

  // The OR and the AND of the tied entries' chunks over the block: the
  // bits on which they differ.
  auto tied_diff = [&]() -> u64 {
    u64 o = 0, a = ~0ULL;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((tied >> e) & 1) {
        o |= v[e];
        a &= v[e];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      o |= __shfl_xor_sync(FULL, o, off);
      a &= __shfl_xor_sync(FULL, a, off);
    }
    if (lane == 0) {
      atomicOr(&red[0][0], (unsigned)o);
      atomicOr(&red[0][1], (unsigned)(o >> 32));
      atomicAnd(&red[1][0], (unsigned)a);
      atomicAnd(&red[1][1], (unsigned)(a >> 32));
    }
    __syncthreads();
    const u64 oo = (u64)red[0][1] << 32 | red[0][0];
    const u64 aa = (u64)red[1][1] << 32 | red[1][0];
    return oo ^ aa;
  };

  constexpr unsigned STEP = (1u << R) - 1;  // a step's entries
  bool done = cnt <= cap;
  int hb = 0;
  hist[0][tid] = 0;
  // chunk c while selecting; once done, one more pass gathers the
  // candidates (one walk site, so the walk's code is there once)
  for (int c = 0; c <= last + 1; ++c) {
    int slot0 = 0;
    if (done) {
      gather = in | tied;
      if (tid == 0) n_out = 0;
      __syncthreads();
      slot0 = gather != 0 ? atomicAdd(&n_out, __popc(gather)) : 0;
    }
    const int mode = done ? -1 : c;
    if (mode == last) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = (u64)((e / R) * (TN_THREADS * R) + tid * R + e % R);
    } else {
      const unsigned want = done ? gather : c == 0 ? all : tied;
      for (int s = 0; s < S; ++s) {
        if (((want >> (s * R)) & STEP) != 0) walk_step(s, mode, want, slot0);
      }
    }
    if (done) break;
    __syncthreads();  // every thread has read red
    if (tid == 0) {
      red[0][0] = red[0][1] = 0;
      red[1][0] = red[1][1] = ~0u;
    }
    __syncthreads();
    u64 diff = tied_diff();
    while (diff != 0) {
      const int shift = (63 - __clzll((long long)diff)) & ~7;
      const int need = k - below;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const bool t = (tied >> e) & 1;
        const int d = (int)((v[e] >> shift) & 0xFF);
        const unsigned peers = __match_any_sync(FULL, t ? d : -1);
        if (t && lane == __ffs(peers) - 1) atomicAdd(&hist[hb][d], __popc(peers));
      }
      __syncthreads();  // also: every thread has read red
      hist[hb ^ 1][tid] = 0;
      if (warp == 0) {
        // the bucket that holds the need-th tied entry
        unsigned h[TN_BINS / 32], sum = 0;
#pragma unroll
        for (int j = 0; j < TN_BINS / 32; ++j) {
          h[j] = hist[hb][lane * (TN_BINS / 32) + j];
          sum += h[j];
        }
        unsigned incl = sum;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned o = __shfl_up_sync(FULL, incl, off);
          if (lane >= off) incl += o;
        }
        unsigned cum = incl - sum;
        if (cum < (unsigned)need && (unsigned)need <= incl) {
#pragma unroll
          for (int j = 0; j < TN_BINS / 32; ++j) {
            if (cum < (unsigned)need && (unsigned)need <= cum + h[j]) {
              sel[0] = lane * (TN_BINS / 32) + j;
              sel[1] = (int)cum;
              sel[2] = (int)h[j];
            }
            cum += h[j];
          }
        }
        if (lane == 0) {
          red[0][0] = red[0][1] = 0;
          red[1][0] = red[1][1] = ~0u;
        }
      }
      __syncthreads();
      const int bucket = sel[0];
      below += sel[1];
      cnt = sel[2];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if ((tied >> e) & 1) {
          const int d = (int)((v[e] >> shift) & 0xFF);
          if (d != bucket) {
            tied &= ~(1u << e);
            if (d < bucket) in |= 1u << e;
          }
        }
      }
      hb ^= 1;
      if (below + cnt <= cap) {
        done = true;
        break;
      }
      diff = tied_diff();
    }
    // not done: the tied entries are equal on this chunk, and the next one
    // tells them apart
  }
  __syncthreads();
  const int m = n_out;
  u64* run = runs + (long long)blockIdx.x * W * k;
  if (cap <= TN_THREADS) {
    // a thread a candidate: a bitonic sort of (chunk 0, slot) in registers
    // (shuffles within a warp, shared memory across warps); chunk 0 orders
    // the candidates as their words do unless two share it, which the
    // whole sort below then settles
    u64 key = tid < m ? sk[tid] : ~0ULL;
    int slot = tid;
    for (int size = 2; size <= TN_THREADS; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        u64 ok;
        int os;
        if (stride >= 32) {
          __syncthreads();
          sk[tid] = key;
          ss[tid] = (unsigned short)slot;
          __syncthreads();
          ok = sk[tid ^ stride];
          os = ss[tid ^ stride];
        } else {
          ok = __shfl_xor_sync(0xFFFFFFFFu, key, stride);
          os = __shfl_xor_sync(0xFFFFFFFFu, slot, stride);
        }
        const bool keep_min = ((tid & stride) == 0) == ((tid & size) == 0);
        const bool mine_first = key < ok || (key == ok && slot < os);
        if (mine_first != keep_min) {
          key = ok;
          slot = os;
        }
      }
    }
    __syncthreads();
    sk[tid] = key;
    ss[tid] = (unsigned short)slot;
    __syncthreads();
    if (!__syncthreads_or(tid + 1 < m && sk[tid] == sk[tid + 1])) {
      for (int s = tid; s < k; s += TN_THREADS) {
        const int a = ss[s];
        for (int q = 0; q < W; ++q) run[(long long)q * k + s] = w[(long long)q * cap + a];
      }
      return;
    }
  }
  int m2 = 1;
  while (m2 < m) m2 <<= 1;
  for (int t = tid; t < m2; t += TN_THREADS) idx[t] = (unsigned short)t;
  __syncthreads();
  // bitonic sort of the slots by their entries; slots past m order last.
  // A stage with a stride below 32 pairs slots of one warp's only (a
  // thread's slots are tid, tid + TN_THREADS, ...), so it needs no block
  // barrier: only the stages across warps wait for the block, before and
  // after
  for (int size = 2; size <= m2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) __syncthreads();
      for (int t = tid; t < m2; t += TN_THREADS) {
        const int u = t ^ stride;
        if (u > t) {
          const int a = idx[t], b = idx[u];
          const int c = a >= m ? (b >= m ? 0 : 1) : b >= m ? -1 : tn_cmp(w, cap, a, w, cap, b, W);
          if ((t & size) == 0 ? c > 0 : c < 0) {
            idx[t] = (unsigned short)b;
            idx[u] = (unsigned short)a;
          }
        }
      }
      if (stride >= 32) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int s = tid; s < k; s += TN_THREADS) {
    const int a = idx[s];
    for (int q = 0; q < W; ++q) run[(long long)q * k + s] = w[(long long)q * cap + a];
  }
}

typedef void (*TnCandidatesKernel)(ScParams, u64*, int);

static TnCandidatesKernel tn_candidates_kernel(int slots) {
  switch (slots) {
    case 2: return topn_candidates<2>;
    case 4: return topn_candidates<4>;
    case 8: return topn_candidates<8>;
    default: return nullptr;
  }
}

// ---------------------------------------------------------------------------
// topn_merge: runs gF .. gF + F - 1 -> run g, the first k of their merge
// ---------------------------------------------------------------------------

// A topn_merge group's entries: run j of the group, slot i, named by the
// 32-bit handle j << 16 | i.  STAGED: the runs copied into shared memory as
// they lie ([W][k] a run, the runs one after another), with an
// order-preserving prefix of each entry (tm_prefix), so that a comparison
// reads two prefixes and only on a tie the words, all in shared memory;
// otherwise (K too large for them) the words are read in place from device
// memory.
extern __shared__ u64 tm_smem[];  // a topn_merge block's dynamic shared memory

// An order-preserving prefix of an entry's first three words (the rank, a
// key's null rank and its key word at a raw TopN): a < b lexicographically
// gives prefix(a) <= prefix(b), so two prefixes that differ order their
// entries, and only equal ones need the words.  Each word saturates at 3
// and ends the prefix there; the third keeps its top 60 bits.
__device__ __forceinline__ u64 tm_prefix(u64 w0, u64 w1, u64 w2) {
  if (w0 > 2) return 3ULL << 62;
  if (w1 > 2) return (w0 << 62) | (3ULL << 60);
  return (w0 << 62) | (w1 << 60) | (w2 >> 4);
}

// The handle of slot i of run j.
__device__ __forceinline__ unsigned tm_handle(int j, int i) {
  return ((unsigned)j << 16) | (unsigned)i;
}

// Word w of entry h: STAGED, from shared memory; else from its run's words
// in device memory (runp: each run's first word).
template <int W, bool STAGED>
__device__ __forceinline__ u64 tm_word(const u64* const* runp, int k, unsigned h, int w) {
  const int j = (int)(h >> 16), i = (int)(h & 0xffffu);
  if constexpr (STAGED) {
    return tm_smem[(j * W + w) * k + i];  // the staged runs lead it
  } else {
    return __ldg(runp[j] + w * k + i);
  }
}

// Whether entry a (prefix pa) goes before entry b (prefix pb) or ties it
// (words as u64, lexicographically).  STAGED: two prefixes that differ
// decide; else all 2W words loaded at once, then compared.  In device
// memory: word by word until two differ.
template <int W, bool STAGED>
__device__ __forceinline__ bool tm_le(const u64* const* runp, int k, u64 pa, unsigned a, u64 pb,
                                      unsigned b) {
  if constexpr (STAGED) {
    if (pa != pb) return pa < pb;
    u64 x[W], y[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      x[w] = tm_word<W, true>(runp, k, a, w);
      y[w] = tm_word<W, true>(runp, k, b, w);
    }
    bool out = true;
#pragma unroll
    for (int w = W - 1; w >= 0; --w) out = x[w] != y[w] ? x[w] < y[w] : out;
    return out;
  } else {
    for (int w = 0; w < W; ++w) {
      const u64 x = tm_word<W, false>(runp, k, a, w), y = tm_word<W, false>(runp, k, b, w);
      if (x != y) return x < y;
    }
    return true;
  }
}

// Run r of `in` ([n_in][n_words][k]), or `extra` (the carry) as run n_in.
__device__ __forceinline__ const u64* tn_run(const u64* in, long long n_in, const u64* extra,
                                             long long r, int n_words, int k) {
  return r < n_in ? in + r * n_words * k : extra;
}

// One block merges its group of m <= F runs (the runs [g * F, g * F + m) of
// in ++ extra, W words of k entries each) into their first k, in order, as
// out[g].  STAGED: the group's runs are first copied into shared memory
// (cp.async, every word in flight at once) and each entry's prefix
// computed.  The merge is a tree of pairwise merges in one launch, over
// entries (handle, and prefix when STAGED) in two shared buffers of
// ceil(m / 2) lists of k: level 0 merges runs 2q and 2q + 1, each level
// after it the lists of the last, an odd last list copied, until one list
// is left.  Each pair's first k places are cut into spans of E (about
// pairs * k / blockDim places a thread): a thread finds where its span
// starts in the two lists by a binary search on its diagonal (merge path)
// and merges E places in order; an entry of the earlier list goes first on
// a tie, so each merge is stable and the tree gives the stable sort of the
// group's runs in run order (the carry, run n_in, last), cut to k.  Then
// the k winners' words are written.
template <int W, bool STAGED>
__global__ void __launch_bounds__(TN_TREE_THREADS)
topn_merge(const u64* __restrict__ in, long long n_in, const u64* __restrict__ extra,
           u64* __restrict__ out, int k, int F) {
  __shared__ const u64* runp[TN_FAN_MAX];
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * F;
  const long long n_runs = n_in + (extra != nullptr ? 1 : 0);
  const int m = (int)(n_runs - r0 < F ? n_runs - r0 : F);
  const int run_words = W * k;
  u64* O = out + (long long)blockIdx.x * run_words;
  if (m == 1) {  // a group of one run: copied
    const u64* A = tn_run(in, n_in, extra, r0, W, k);
    for (int t = tid; t < run_words; t += TN_TREE_THREADS) O[t] = A[t];
    return;
  }
  const int half = (m + 1) / 2;
  // STAGED: the runs' words, their prefixes (slot i of run j at j * k + i),
  // the two buffers' prefixes; then the two buffers' handles
  u64* stage = tm_smem;
  u64* pk0 = stage + m * run_words;
  u64* lpk = pk0 + m * k;
  unsigned* lh = (unsigned*)(STAGED ? lpk + 2 * half * k : tm_smem);
  if (STAGED) {
    // the group's runs of `in` lie together; the carry apart, after them.
    // cp.async: every word of the group in flight at once
    const int m_in = (int)(n_in - r0 < m ? (n_in > r0 ? n_in - r0 : 0) : m);
    const u64* from = in + r0 * run_words;
    for (int t = tid; t < m_in * run_words; t += TN_TREE_THREADS) {
      __pipeline_memcpy_async(stage + t, from + t, sizeof(u64));
    }
    if (m_in < m) {
      for (int t = tid; t < run_words; t += TN_TREE_THREADS) {
        __pipeline_memcpy_async(stage + m_in * run_words + t, extra + t, sizeof(u64));
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int t = tid; t < m * k; t += TN_TREE_THREADS) {
      const int j = t / k, i = t - j * k;
      const u64* e = stage + j * run_words + i;
      pk0[t] = tm_prefix(e[0], W > 1 ? e[k] : 0, W > 2 ? e[2 * k] : 0);
    }
  } else if (tid < m) {
    runp[tid] = tn_run(in, n_in, extra, r0 + tid, W, k);
  }
  __syncthreads();
  int level = 0;
  for (int n_lists = m; n_lists > 1; n_lists = (n_lists + 1) / 2, ++level) {
    const int from = (level & 1) ? 0 : half * k;  // the last level's lists
    const int to = (level & 1) ? half * k : 0;
    // entry i of list l of this level (level 0: the runs themselves): its
    // handle, and its prefix when STAGED
#define TM_HANDLE(l, i) (level == 0 ? tm_handle((l), (i)) : lh[from + (l) * k + (i)])
#define TM_PREFIX(l, i) (!STAGED ? 0ULL : level == 0 ? pk0[(l) * k + (i)] : lpk[from + (l) * k + (i)])
    const int pairs = n_lists / 2;
    const int E = (pairs * k + TN_TREE_THREADS - 1) / TN_TREE_THREADS;
    const int spans = (k + E - 1) / E;  // a pair's
    for (int item = tid; item < pairs * spans; item += TN_TREE_THREADS) {
      const int p = item / spans;
      const int o = (item - p * spans) * E;
      const int a = 2 * p, b = a + 1;
      int lo = 0, hi = o;  // entries of list a among the first o places
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (tm_le<W, STAGED>(runp, k, TM_PREFIX(a, mid), TM_HANDLE(a, mid),
                             TM_PREFIX(b, o - 1 - mid), TM_HANDLE(b, o - 1 - mid))) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      int i = lo, j = o - lo;  // i + j < k below: both inside their lists
      const int end = o + E < k ? o + E : k;
      unsigned ha = TM_HANDLE(a, i), hb = TM_HANDLE(b, j);
      u64 pa = TM_PREFIX(a, i), pb = TM_PREFIX(b, j);
      for (int q = o; q < end; ++q) {
        const int at = to + p * k + q;
        if (tm_le<W, STAGED>(runp, k, pa, ha, pb, hb)) {
          lh[at] = ha;
          if (STAGED) lpk[at] = pa;
          if (++i < k) {
            ha = TM_HANDLE(a, i);
            pa = TM_PREFIX(a, i);
          }
        } else {
          lh[at] = hb;
          if (STAGED) lpk[at] = pb;
          if (++j < k) {
            hb = TM_HANDLE(b, j);
            pb = TM_PREFIX(b, j);
          }
        }
      }
    }
    if (n_lists & 1) {
      for (int i = tid; i < k; i += TN_TREE_THREADS) {
        lh[to + pairs * k + i] = TM_HANDLE(n_lists - 1, i);
        if (STAGED) lpk[to + pairs * k + i] = TM_PREFIX(n_lists - 1, i);
      }
    }
#undef TM_HANDLE
#undef TM_PREFIX
    __syncthreads();
  }
  const unsigned* fin = lh + ((level & 1) ? 0 : half * k);
  for (int t = tid; t < run_words; t += TN_TREE_THREADS) {
    const int w = t / k, s = t - w * k;
    O[t] = tm_word<W, STAGED>(runp, k, fin[s], w);
  }
}

// The shared memory of a topn_merge block: STAGED, the staged runs, their
// prefixes and the two buffers' prefixes; the buffers' handles.
static long long tm_smem_bytes(int F, int n_words, int k, bool staged) {
  const long long lists = 2LL * ((F + 1) / 2) * k;
  return (staged ? ((long long)F * n_words * k + (long long)F * k + lists) * 8 : 0) + lists * 4;
}

// The instance for n_words (2 .. TN_MERGE_WORDS), staged or not.
static_assert(TN_MERGE_WORDS == 3 + 2 * TN_MAX_KEYS, "rank, the keys' words, src and a position");
typedef void (*TmKernel)(const u64*, long long, const u64*, u64*, int, int);

template <int W>
static TmKernel tm_kernel_w(bool staged) {
  return staged ? topn_merge<W, true> : topn_merge<W, false>;
}

static TmKernel tm_kernel(int n_words, bool staged) {
  switch (n_words) {
    case 2: return tm_kernel_w<2>(staged);
    case 3: return tm_kernel_w<3>(staged);
    case 4: return tm_kernel_w<4>(staged);
    case 5: return tm_kernel_w<5>(staged);
    case 6: return tm_kernel_w<6>(staged);
    case 7: return tm_kernel_w<7>(staged);
    case 8: return tm_kernel_w<8>(staged);
    case 9: return tm_kernel_w<9>(staged);
    case 10: return tm_kernel_w<10>(staged);
    case 11: return tm_kernel_w<11>(staged);
    default: return nullptr;
  }
}

// ---------------------------------------------------------------------------
// topn_pack: the packed state of the merged run, payload gathered
// ---------------------------------------------------------------------------

// The grid's items are first the (payload column j, slot s) cells,
// column-major (item j * k + s: a warp's stores fall on one row), then the
// (word q, slot s) cells of the run (item k * n_pay + q * k + s).  A payload
// cell loads its slot's rank and src words (the slot's cells share them
// through L1/L2), then its column's value and null flag: from the carry's
// slot src, or from the image's flat row src - src_base through fa_load
// (a division only for a run-length column); a rank-1 slot takes 0 and 0.
// A run cell copies its word into out_run (the last word is the slot s, as
// the carry of the next step: its slot order is its stream order), and
// word 0, the rank, into int64 row 0.  Every load of a thread is issued
// before its stores, and the inputs are read through the read-only path,
// so nothing orders a load behind a store: a launch is two dependent
// rounds of loads, then the stores.  f64 values move as their bits.
__global__ void __launch_bounds__(TP_THREADS) topn_pack(const __grid_constant__ TpParams p) {
  const int k = p.k;
  const int W = p.n_words;
  const int cells = k * p.n_pay;
  const int it = blockIdx.x * TP_THREADS + threadIdx.x;
  const u64* __restrict__ run = p.run;
  if (it >= cells) {
    const int c = it - cells;  // q * k + s
    if (c >= W * k) return;
    const int q = c / k;
    const int s = c - q * k;
    const u64 w = q < W - 1 ? __ldg(run + c) : (u64)s;
    p.out_run[c] = w;
    if (q == 0) p.out_i[s] = (long long)w;
    return;
  }
  const int j = it / k;
  const int s = it - j * k;
  const u64 rank = __ldg(run + s);
  const u64 src = __ldg(run + (long long)(W - 1) * k + s);
  const bool is_f = p.pay_f64[j];
  const long long cell = (long long)p.pay_row[j] * k;
  const long long ncell = (long long)p.pay_null_row[j] * k;
  long long v = 0, nul = 0;
  if (rank == 0) {
    if (src < (u64)p.src_base) {
      const long long* __restrict__ cv = is_f ? (const long long*)p.carry_f : p.carry_i;
      v = __ldg(cv + cell + (long long)src);
      nul = __ldg(p.carry_i + ncell + (long long)src);
    } else {
      const long long f = (long long)(src - (u64)p.src_base);
      const long long b = p.enc.kind[j] == FA_ENC_RLE ? f / p.block_rows : 0;
      bool nb;
      v = fa_load(p, j, f, b, f - b * p.block_rows, nb);
      nul = nb;
    }
  }
  long long* __restrict__ ov = is_f ? (long long*)p.out_f : p.out_i;
  ov[cell + s] = v;
  p.out_i[ncell + s] = nul;
}

extern "C" {

int sc_params_size(void) { return (int)sizeof(ScParams); }
int tp_params_size(void) { return (int)sizeof(TpParams); }
int tn_smem_max(void) { return TN_SMEM_MAX; }

// Each launcher returns cudaGetLastError() right after its launch.
// sc_launch_mask runs the instance that holds the plan's stack
// (cudaErrorInvalidValue past FA_MAX_STACK) over a grid of the blocks the
// card holds at once, or fewer when the image has fewer tiles.
int sc_launch_mask(const ScParams* p, unsigned char* out, void* stream) {
  int slots = 0;
  const ScMaskKernel k = sc_mask_kernel(p, &slots);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const long long tiles = p->n_blocks * ((p->block_rows + SC_MASK_ROWS - 1) / SC_MASK_ROWS);
  if (tiles == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)k, SC_MASK_THREADS, 0);
  }
  if (err != cudaSuccess) return (int)err;
  long long grid = (tiles + SC_MASK_THREADS - 1) / SC_MASK_THREADS;
  const long long full = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > full) grid = full;
  void* args[] = {(void*)p, (void*)&out};
  err = cudaLaunchKernel((const void*)k, dim3((unsigned)grid), dim3(SC_MASK_THREADS), args, 0,
                         (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// cudaFuncGetAttributes of the mask instance that runs the plan: registers a
// thread, local and static shared bytes, and its stack slots, into out[0..4).
int sc_mask_attributes(const ScParams* p, int* out) {
  int slots = 0;
  const ScMaskKernel k = sc_mask_kernel(p, &slots);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)k);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = slots;
  return 0;
}

int sc_mask_rows(void) { return SC_MASK_ROWS; }

// topn_candidates runs the instance of `slots` stack slots over tiles of
// p->tile rows (a multiple of TN_THREADS * TN_ROWS, at most TN_STEPS of
// them), gathering at most `cap` entries (a power of two, k <= cap <=
// tile); cudaErrorInvalidValue otherwise.  Above 48 KB a block's dynamic
// shared memory must be allowed explicitly.
int tn_launch_candidates(const ScParams* p, u64* runs, int n_tiles, int cap, int slots,
                         void* stream) {
  const TnCandidatesKernel kern = tn_candidates_kernel(slots);
  const int step = TN_THREADS * TN_ROWS;
  if (kern == nullptr || p->tile % step != 0 || p->tile / step > TN_STEPS || p->tile < step
      || cap < p->k || cap > p->tile || (cap & (cap - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = (2 + 2 * p->n_keys) * cap * 8 + cap * 2;
  cudaError_t err = cudaFuncSetAttribute((const void*)kern,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)p, (void*)&runs, (void*)&cap};
  err = cudaLaunchKernel((const void*)kern, dim3((unsigned)n_tiles), dim3(TN_THREADS), args, smem,
                         (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// cudaFuncGetAttributes of the candidates instance of `slots` stack slots:
// registers a thread, local and static shared bytes, into out[0..3).
int tn_candidates_attributes(int slots, int* out) {
  const TnCandidatesKernel kern = tn_candidates_kernel(slots);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)kern);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

int tn_step_rows(void) { return TN_ROWS * TN_THREADS; }

// One merge level: groups of F runs of in ++ extra, one block each, out
// [ceil(runs / F)][n_words][k]; the runs staged in shared memory where F of
// them fit beside their prefixes and handles (tn_merge_staged), else read
// in place.
int tn_launch_merge(const u64* in, long long n_in, const u64* extra, u64* out, int n_words, int k,
                    int F, void* stream) {
  if (F < 2 || F > TN_FAN_MAX || k < 1 || k > 65536) return (int)cudaErrorInvalidValue;
  const long long n_runs = n_in + (extra != nullptr ? 1 : 0);
  if (n_runs < 1) return 0;
  const bool staged = tm_smem_bytes(F, n_words, k, true) <= TN_MERGE_SMEM;
  const long long smem = tm_smem_bytes(F, n_words, k, staged);
  const TmKernel kern = tm_kernel(n_words, staged);
  if (kern == nullptr || smem > TN_MERGE_SMEM) return (int)cudaErrorInvalidValue;
  // each instance may take all of a block's shared memory: set once a device
  static unsigned long long smem_set[2][TN_MERGE_WORDS + 1] = {};
  unsigned long long& set = smem_set[staged ? 1 : 0][n_words];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev >= 64 || !((set >> dev) & 1)) {
    err = (int)cudaFuncSetAttribute((const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    TN_MERGE_SMEM);
    if (err != 0) return err;
    if (dev < 64) set |= 1ULL << dev;
  }
  kern<<<(unsigned)((n_runs + F - 1) / F), TN_TREE_THREADS, (size_t)smem,
         (cudaStream_t)stream>>>(in, n_in, extra, out, k, F);
  return (int)cudaGetLastError();
}

// Whether a topn_merge level of F runs of n_words x k stages them.
int tn_merge_staged(int F, int n_words, int k) {
  return tm_smem_bytes(F, n_words, k, true) <= TN_MERGE_SMEM ? 1 : 0;
}

// cudaFuncGetAttributes of the topn_merge instance for n_words (staged or
// not): registers a thread, local and static shared bytes, into out[0..3).
int tn_merge_attributes(int n_words, int staged, int* out) {
  const TmKernel kern = tm_kernel(n_words, staged != 0);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)kern);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

int tn_fan_max(void) { return TN_FAN_MAX; }

// One thread a payload cell and a run cell: ceil(k * (n_pay + n_words) /
// TP_THREADS) blocks.
int tn_launch_pack(const TpParams* p, void* stream) {
  const long long items = (long long)p->k * (p->n_pay + p->n_words);
  if (p->k < 1 || p->n_pay < 0 || p->n_pay > TN_MAX_PAYLOAD || p->n_words < 2
      || items > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  topn_pack<<<(unsigned)((items + TP_THREADS - 1) / TP_THREADS), TP_THREADS, 0,
              (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

// cudaFuncGetAttributes of topn_pack: registers a thread, local and static
// shared bytes, into out[0..3).
int tp_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)topn_pack);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

int dc_launch(const ScParams* p, long long* out, unsigned char* out_nul, int grid, void* stream) {
  decode_column<<<grid, SC_MASK_THREADS, 0, (cudaStream_t)stream>>>(*p, out, out_nul);
  return (int)cudaGetLastError();
}

}  // extern "C"
