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
//     device that holds a slab of it folded into one (R, L, C) state.
// The shards' states are copied to the merging device by the caller (a
// no-op where the shards share it); this kernel folds them there.
//
// mesh_merge: one thread per word of the output, (region r, leaf l, slot
// w), grid-stride.  It folds the parts that the table lists for r, in the
// table's order, from the leaf's identity, then combines the result into
// the carry (carry first) and writes it.  The merge rule of each leaf kind
// is ga_merge (ga_leaf.cuh): counts and sums add as unsigned 64-bit words
// (f64 sums in f64), the tracker and first's row take the minimum, f64
// min/max propagate NaN and order -0.0 below +0.0, and the bitwise leaves
// fold with and/or/xor.  first's value (GA_FIRSTVAL) has no merge rule:
// the wrapper refuses plans that hold it.
//
// Determinism: the fold order is the table's (shard order), with no float
// atomics, so f64 leaves are bit-identical from run to run.
//
// What bounds it on an H100: memory.  It reads each part's window once and
// writes the output once; a few MB at most on the mesh path, so launch
// latency dominates.
//
// Layout contract with tikv_tpu_torch/copr/fused_mesh.py (the wrapper
// checks sizeof(MmParams) at load).

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
      if (part >= 0) acc = ga_merge(kind, is_f, acc, src[(long long)part * rows * p.capacity]);
    }
    const long long cell = ((long long)r * rows + slot) * p.width + w;
    const long long* carry = is_f ? p.carry_f : p.carry_i;
    if (carry != nullptr) acc = ga_merge(kind, is_f, carry[cell], acc);
    (is_f ? p.out_f : p.out_i)[cell] = acc;
  }
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

}  // extern "C"
