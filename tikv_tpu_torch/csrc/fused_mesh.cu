// The cross-shard merge of the coprocessor's mesh path.
//
// Replaces the collectives of the reference package's mesh programs
// (tikv_tpu/parallel/mesh.py): _collective (psum, pmin, pmax, and the
// bitwise monoids by all_gather and a fold) and _combine, as they reduce
// the shards' partial aggregate states over the "regions" axis inside
//   * mesh.agg_step (ShardedDagEvaluator._build_step): the S shard states
//     of one super-block folded, then combined into the carried state, each
//     "groups" member keeping its slice of the slots;
//   * mesh.xshard (launch_xregion_sharded): each region's states from every
//     device that holds a slab of it folded into one (R, L, C) state;
//   * mesh.grouped_step (ShardedGroupedEvaluator._build_step): the S shard
//     states folded, then combined into the carry remapped to the new
//     group dictionary (`perm`, below).
// Two kernels.  mesh_fold takes the shards' raw partial rows, as
// fused_group_agg_partials writes them, and serves agg_step and grouped_step
// at the capacities the partials kernel holds in shared memory; mesh_merge
// takes packed states and serves xshard and, past those capacities, the
// wide route's states.  The caller stacks the shards' rows or states on the
// merging device (a no-op for the shards that sit there).
//
// mesh_merge: one thread per word of the output, (region r, leaf l, slot
// w), grid-stride.  It folds the parts that the table lists for r, in the
// table's order, from the leaf's identity, then combines the result into
// the carry (carry first) and writes it.  With a `perm` (the whole slot
// window only), the carry's slot i goes to slot perm[i] (perm >= width:
// dropped): mesh.grouped_step's remap of the carried slots when new keys
// reshuffle the sorted group dictionary (ShardedGroupedEvaluator,
// mesh.py:413-433, `identity.at[perm].set(carry)`).  perm is nondecreasing
// (searchsorted positions of a sorted dictionary), so slot w finds its
// carry slot by a binary search for the first i with perm[i] == w, and a
// slot that no carry slot moves to combines the identity.  The merge rule of each leaf kind
// is ga_merge_ordered (ga_leaf.cuh): counts and sums add as unsigned 64-bit
// words (f64 sums in f64, a NaN operand's NaN kept in operand order), the tracker and first's row take the minimum, f64
// min/max propagate NaN and order -0.0 below +0.0, and the bitwise leaves
// fold with and/or/xor.  first's value (GA_FIRSTVAL) has no merge rule:
// the wrappers refuse plans that hold it.
//
// mesh_fold: one block of MF_THREADS per output cell (window, leaf, slot)
// of one super-block; the windows are the "groups" members that share the
// merging device, each with its own carry and output.  Warp j takes the
// shards j, j + MF_WARPS, ...: it folds a shard's rows of the cell with
// ga_tree_fold (ga_leaf.cuh), the tree fused_group_agg_combine_pack
// (csrc/fused_agg.cu) runs on its warp of a cell -- lane l stands for the
// tree's threads l, l + 32, ..., l + 224, each folding its parts t, t +
// MF_TREE, ... from the identity, then strides 128, 64 and 32 in the lanes'
// registers and 16 to 1 by shuffles -- and finishes the shard's cell as
// ga_finish_cell finishes it from the identity carry (the tracker's flat
// row becomes a global row through the shard's offset: each shard's rows
// are one block) into shared memory.  Then one thread folds the shards'
// cells in the table's order from the identity and combines the result
// into the carry as mesh_merge does (perm the same).  Every identity merge
// of those steps is kept: an f64 sum of -0.0 and the identity +0.0 is
// +0.0, so an identity merge is not a no-op on every leaf; and the f64
// sums add through ga_dadd, as the combine's do, so that a NaN's bits
// follow the operands' order, not the compiler's.  So the output is word
// for word, f64 leaves included, that of S launches of
// fused_group_agg_combine_pack followed by mesh_merge over their packed
// states, from one launch a super-block in place of S + G.  The shards'
// trees run side by side (a cell's work is a chain of dependent steps, a
// few per SM: its latency, not bytes, sets the time), and the leaf's merge
// rule is picked once a block (a template argument), not at every merge.
//
// Determinism: the fold order is the table's (shard order), with no float
// atomics, so f64 leaves are bit-identical from run to run.
//
// What bounds them on an H100: memory.  Each reads its rows once and
// writes the output once; a few KB to a few MB on the mesh path, so launch
// latency dominates.
//
// Layout contract with tikv_tpu_torch/copr/fused_mesh.py (the wrapper
// checks sizeof(MmParams) and sizeof(MfParams) at load).

#include "fa_walk.cuh"
#include "ga_leaf.cuh"

#define MM_THREADS 256
#define MM_GRID_MAX 1056  // 8 blocks per SM of an H100

struct MmParams {
  const long long* parts_i;  // [n_parts][n_int][capacity]
  const long long* parts_f;  // [n_parts][n_f64][capacity], f64 bits
  const int* table;          // [n_regions][max_parts]: part rows in fold order, -1 empty
  const long long* carry_i;  // [n_regions][n_int][width], or null
  const long long* carry_f;  // [n_regions][n_f64][width], or null
  long long* out_i;          // [n_regions][n_int][width]; may be carry_i
  long long* out_f;          // [n_regions][n_f64][width]; may be carry_f
  const int* perm;           // [width]: the carry's slot i goes to slot perm[i]; or null
  long long leaf_ident[GA_MAX_LEAVES];
  int n_regions;
  int max_parts;
  int n_int;
  int n_f64;
  int capacity;  // slots of a part
  int lo;        // the window [lo, lo + width) of the slots
  int width;
  int n_leaves;
  signed char leaf_kind[GA_MAX_LEAVES];
  signed char leaf_f64[GA_MAX_LEAVES];
  signed char leaf_slot[GA_MAX_LEAVES];
};

// The carried word of slot w from a leaf's carry row of `width` words: the
// row's word w, or with a perm the word of the first slot i with perm[i] ==
// w, the leaf's identity where no slot moves to w.
__device__ __forceinline__ long long mm_carried(const long long* row, const int* perm, int width,
                                                int w, long long ident) {
  if (perm == nullptr) return row[w];
  int lo = 0, hi = width;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(perm + mid) < w) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < width && __ldg(perm + lo) == w ? row[lo] : ident;
}

__global__ void __launch_bounds__(MM_THREADS) mesh_merge(const __grid_constant__ MmParams p) {
  const long long total = (long long)p.n_regions * p.n_leaves * p.width;
  const long long stride = (long long)gridDim.x * MM_THREADS;
  for (long long t = (long long)blockIdx.x * MM_THREADS + threadIdx.x; t < total; t += stride) {
    const int w = (int)(t % p.width);
    const long long rl = t / p.width;
    const int l = (int)(rl % p.n_leaves);
    const int r = (int)(rl / p.n_leaves);
    const int kind = p.leaf_kind[l];
    const bool is_f = p.leaf_f64[l] != 0;
    const long long rows = is_f ? p.n_f64 : p.n_int;
    const long long slot = p.leaf_slot[l];
    const long long* src = (is_f ? p.parts_f : p.parts_i) + slot * p.capacity + p.lo + w;
    const int* parts = p.table + (long long)r * p.max_parts;
    long long acc = p.leaf_ident[l];
    for (int q = 0; q < p.max_parts; ++q) {
      const int part = parts[q];
      if (part >= 0) {
        acc = ga_merge_ordered(kind, is_f, acc, src[(long long)part * rows * p.capacity]);
      }
    }
    const long long cell = ((long long)r * rows + slot) * p.width + w;
    const long long* carry = is_f ? p.carry_f : p.carry_i;
    if (carry != nullptr) {
      acc = ga_merge_ordered(kind, is_f,
                             mm_carried(carry + cell - w, p.perm, p.width, w, p.leaf_ident[l]),
                             acc);
    }
    (is_f ? p.out_f : p.out_i)[cell] = acc;
  }
}


// ---------------------------------------------------------------------------
// mesh_fold
// ---------------------------------------------------------------------------

#define MF_THREADS 256
#define MF_WARPS (MF_THREADS / 32)
#define MF_MAX_WINDOWS 16
// the width of the combine's tree this fold keeps (ga_tree_fold, ga_leaf.cuh)
#define MF_TREE GA_TREE

struct MfWindow {
  const long long* carry_i;  // [n_int][width], or null (no carry)
  const long long* carry_f;  // [n_f64][width], f64 bits, or null
  long long* out_i;          // [n_int][width]; may be carry_i without perm
  long long* out_f;          // [n_f64][width]; may be carry_f without perm
  long long lo;              // the window's first slot
};

struct MfParams {
  const long long* rows;    // [n_rows][n_leaves][capacity]: the shards' partial rows
  const long long* shards;  // [n_shards][3]: first row, rows, offset of its row 0 less base
  const int* perm;          // [capacity]: the carry's slot i goes to slot perm[i]; or null
  long long base;           // global row of the super-block's row 0
  long long leaf_ident[GA_MAX_LEAVES];
  MfWindow win[MF_MAX_WINDOWS];
  int n_windows;
  int n_shards;
  int n_leaves;
  int capacity;  // slots of a row
  int width;     // slots of a window
  signed char leaf_kind[GA_MAX_LEAVES];
  signed char leaf_f64[GA_MAX_LEAVES];
  signed char leaf_slot[GA_MAX_LEAVES];
};

// The block's cell: the shards' totals side by side (warp j: shards j, j +
// MF_WARPS, ...), finished into s_st; then thread 0 folds them in order and
// into the carried word `carried` (read before the wait), and writes `dst`.
template <class Op>
__device__ __forceinline__ void mf_fold_cell(const MfParams& p, const long long* s_shard,
                                             long long* s_st, const long long* src,
                                             bool track, long long id, bool has_carry,
                                             long long carried, long long* dst) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)p.n_leaves * p.capacity;
  for (int k = threadIdx.x >> 5; k < p.n_shards; k += MF_WARPS) {
    long long blk = ga_tree_fold<Op>(src, stride, s_shard[3 * k], s_shard[3 * k + 1], lane, id);
    if (lane == 0) {
      if (track) blk = blk >= FA_NO_ROW ? FA_NO_ROW : p.base + s_shard[3 * k + 2] + blk;
      s_st[k] = Op::m(id, blk);
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  long long acc = id;
  for (int k = 0; k < p.n_shards; ++k) acc = Op::m(acc, s_st[k]);
  *dst = has_carry ? Op::m(carried, acc) : acc;
}

__global__ void __launch_bounds__(MF_THREADS) mesh_fold(const __grid_constant__ MfParams p) {
  // the shard table [n_shards][3], then each shard's finished cell
  extern __shared__ long long s_mem[];
  long long* s_shard = s_mem;
  long long* s_st = s_mem + 3 * p.n_shards;
  for (int i = threadIdx.x; i < 3 * p.n_shards; i += MF_THREADS) s_shard[i] = __ldg(p.shards + i);
  // 32-bit cell indices (the wrapper keeps the cells below 2^31): a 64-bit
  // division is a subroutine call, and its frame spills
  const int cell = blockIdx.x;
  const int w = cell % p.width;
  const int wl = cell / p.width;
  const int l = wl % p.n_leaves;
  const MfWindow& win = p.win[wl / p.n_leaves];
  const int kind = p.leaf_kind[l];
  const bool is_f = p.leaf_f64[l] != 0;
  const long long id = p.leaf_ident[l];
  const long long at = (long long)p.leaf_slot[l] * p.width + w;
  const long long* carry = is_f ? win.carry_f : win.carry_i;
  long long carried = 0;
  if (threadIdx.x == 0 && carry != nullptr) {
    carried = mm_carried(carry + at - w, p.perm, p.width, w, id);
  }
  long long* dst = (is_f ? win.out_f : win.out_i) + at;
  const long long* src = p.rows + (long long)l * p.capacity + win.lo + w;
  __syncthreads();
  const bool has = carry != nullptr;
  const bool track = kind == GA_TRACK;
  // the locals captured by value: captured by reference they were kept in
  // local memory (16 bytes a thread); ga_with_rule folds nothing for
  // GA_FIRSTVAL, which the wrapper refuses
  ga_with_rule(kind, is_f, [&p, s_shard, s_st, src, track, id, has, carried, dst](auto rule) {
    mf_fold_cell<decltype(rule)>(p, s_shard, s_st, src, track, id, has, carried, dst);
  });
}

extern "C" {

int mm_params_size(void) { return (int)sizeof(MmParams); }

// Returns cudaGetLastError() right after the launch.
int mm_launch(const MmParams* p, void* stream) {
  const long long total = (long long)p->n_regions * p->n_leaves * p->width;
  if (total == 0) return 0;
  long long blocks = (total + MM_THREADS - 1) / MM_THREADS;
  if (blocks > MM_GRID_MAX) blocks = MM_GRID_MAX;
  mesh_merge<<<(unsigned)blocks, MM_THREADS, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

int mf_params_size(void) { return (int)sizeof(MfParams); }
int mf_tree(void) { return MF_TREE; }
int mf_max_windows(void) { return MF_MAX_WINDOWS; }

// Returns cudaGetLastError() right after the launch; a block a cell, dynamic
// shared memory 32 bytes a shard (the wrapper keeps it within the default
// 48 KB).
int mf_launch(const MfParams* p, void* stream) {
  const long long cells = (long long)p->n_windows * p->n_leaves * p->width;
  if (cells == 0) return 0;
  mesh_fold<<<(unsigned)cells, MF_THREADS, 32 * p->n_shards, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

// cudaFuncGetAttributes of mesh_fold: registers a thread, local and static
// shared bytes, into out[0..3).
int mf_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)mesh_fold);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

}  // extern "C"
