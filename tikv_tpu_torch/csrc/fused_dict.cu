// The group dictionary built on the devices: key pack, bounded sorted union,
// dictionary ids.
//
// Replaces the dictionary half of the reference package's program
// mesh.grouped_step (tikv_tpu/parallel/mesh.py:ShardedGroupedEvaluator.
// _build_step), which each region shard runs inside one shard_map:
//   * the key pack (mesh.py:366-377): the selection and the group
//     expressions per row (rpn.py:eval_rpn), each value packed into one
//     int64 key, `key = (key << key_bits) | (lane & lane_max)`, a NULL as
//     the all-ones lane, a value outside [0, lane_max) flagged, an inactive
//     row the sentinel 2^62 -> dict_keys;
//   * the bounded sorted union (mesh.py:378-406): the `cap` smallest
//     distinct non-sentinel keys of (sorted dictionary ++ keys), sorted and
//     padded with the sentinel, flagged when there are more; once per shard
//     over its keys and the carried dictionary, then once over the shards'
//     gathered dictionaries (the all_gather) -> dict_union;
//   * the ids (mesh.py:407-417): `clip(searchsorted(dict, key), 0, cap-1)`
//     per row, and for the carried slots `perm = searchsorted(new_dict,
//     old_key)` (cap for a sentinel slot), which mesh_merge
//     (fused_mesh.cu) uses to move the carry -> dict_ids.
//
// dict_union: the `cap` smallest distinct keys of a union lie inside the
// union of each tile's `cap` smallest distinct keys (a key with fewer than
// cap distinct keys below it in the union has fewer below it in its tile),
// and a tile with more than cap distinct keys proves that the union has
// more.  So each block sorts one tile of T keys in shared memory (bitonic,
// T a power of two >= 2 * cap), keeps its first cap distinct keys and
// flags the overflow; the wrapper launches the same kernel again over the
// tiles' lists until one tile is left.  If no tile of any pass overflows,
// no key was dropped and the last tile counts every distinct key: the flag
// is exactly "more than cap distinct keys".
//
// What bounds them on an H100: dict_keys reads the referenced columns of
// every row and writes 8 bytes a row, with the bytecode walk (fa_walk.cuh)
// per row, as fused_mask; dict_union sorts (log2(T)^2 / 2 compare-exchange
// stages a tile) and reads each key once; dict_ids does a binary search of
// at most 13 steps per row in a shared-memory copy of the dictionary.  At
// the mesh path's shapes (131,072 rows a shard, cap 64) all three are a few
// microseconds of launch latency and a handful of tiles.
//
// Determinism: integers only; the one atomic ORs a flag bit.  Reruns are
// bit-identical.
//
// Layout contract with tikv_tpu_torch/copr/fused_dict.py (the wrapper
// checks sizeof(DkParams) and the limits at load).

#include "fa_walk.cuh"

#define DK_THREADS 256
#define DK_GRID_MAX 4096
#define DU_THREADS 1024
#define DI_THREADS 256
#define DI_GRID_MAX 1024
#define DU_TILE_MAX 16384  // 128 KB of int64 keys in shared memory
#define DK_SENTINEL (1LL << 62)
#define DK_FLAG_RANGE 1     // a key value outside [0, lane_max)
#define DK_FLAG_CAPACITY 2  // more than cap distinct keys

// dict_keys' parameters: the walk's (as ScParams of fused_scan.cu) and the
// key layout.
struct DkParams {
  const void* col[FA_MAX_COLS];           // payloads: [n_blocks, block_rows] lanes (rle: run values)
  const unsigned char* nul[FA_MAX_COLS];  // bool null masks, or null for NOT NULL columns
  FaEnc enc;                              // how each column loads (program #1)
  const long long* n_valids;              // [n_blocks], or null: n_valid_all for every block
  long long* keys;                        // out: [n_blocks * block_rows]
  int* flag;                              // DK_FLAG_RANGE is ORed in
  long long n_valid_all;
  long long n_blocks;
  long long block_rows;
  unsigned long long key_f64;             // bit q: group key q's value lane is f64
  long long consts[FA_MAX_CONSTS];
  int code[FA_MAX_CODE];
  int n_code;
  int n_cols;
  int key_bits;
};

// A REAL group value as numpy's astype(int64) on x86 converts it: toward
// zero, INT64_MIN for NaN and for values outside the int64 range.
__device__ __forceinline__ long long dk_trunc(double x) {
  return (x >= -9223372036854775808.0 && x < 9223372036854775808.0) ? (long long)x
                                                                      : (long long)(1ULL << 63);
}

// ---------------------------------------------------------------------------
// dict_keys: one row per thread, grid-stride
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(DK_THREADS) dict_keys(const __grid_constant__ DkParams p) {
  const long long total = p.n_blocks * p.block_rows;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long lane_max = (long long)((1ULL << p.key_bits) - 1);
  bool any_bad = false;
  for (long long f = (long long)blockIdx.x * blockDim.x + threadIdx.x; f < total; f += stride) {
    const long long blk = f / p.block_rows;
    const long long i = f - blk * p.block_rows;
    const long long n_valid = p.n_valids != nullptr ? __ldg(p.n_valids + blk) : p.n_valid_all;
    u64 key = 0;
    bool bad = false, active = false;
    if (i < n_valid) {
      // the keys come in order (OP_KEY q = 0, 1, ...): each shifts the key
      // left by key_bits, in unsigned arithmetic
      active = fa_walk_keys(
          p, f, blk, i, [](int, bool, long long) {},
          [&](int q, bool nul, long long raw) {
            const long long v = (p.key_f64 >> q) & 1 ? dk_trunc(fa_f(raw)) : raw;
            bad = bad || (!nul && (v < 0 || v >= lane_max));
            const u64 lane = nul ? (u64)lane_max : (u64)v;
            key = (key << p.key_bits) | (lane & (u64)lane_max);
          });
    }
    p.keys[f] = active ? (long long)key : DK_SENTINEL;
    any_bad = any_bad || (active && bad);
  }
  if (__any_sync(0xffffffffu, any_bad) && (threadIdx.x & 31) == 0) atomicOr(p.flag, DK_FLAG_RANGE);
}

// ---------------------------------------------------------------------------
// dict_union: one tile of T keys per block
// ---------------------------------------------------------------------------

// Block-wide exclusive scan of one int per thread; returns the thread's
// offset and sets *total.  `warp_sums` holds DU_THREADS / 32 ints.
__device__ __forceinline__ int du_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < DU_THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < DU_THREADS / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  *total = warp_sums[DU_THREADS / 32 - 1];
  return (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
}

// Keys [blockIdx.x * T, (blockIdx.x + 1) * T) of the virtual array
// (dict[0..n_dict) ++ keys[0..n_keys)), padded with the sentinel, sorted;
// out[blockIdx.x] = their first cap distinct non-sentinel keys, padded with
// the sentinel; DK_FLAG_CAPACITY ORed into *flag when there are more.
__global__ void __launch_bounds__(DU_THREADS)
dict_union(const long long* __restrict__ dict, long long n_dict,
           const long long* __restrict__ keys, long long n_keys, long long* __restrict__ out,
           int* flag, int cap, int T) {
  extern __shared__ long long du_smem[];
  long long* s = du_smem;
  __shared__ int warp_sums[DU_THREADS / 32];
  const long long base = (long long)blockIdx.x * T;
  for (int t = threadIdx.x; t < T; t += DU_THREADS) {
    const long long g = base + t;
    long long v = DK_SENTINEL;
    if (g < n_dict) {
      v = __ldg(dict + g);
    } else if (g - n_dict < n_keys) {
      v = __ldg(keys + (g - n_dict));
    }
    s[t] = v;
  }
  __syncthreads();
  for (int size = 2; size <= T; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < T; t += DU_THREADS) {
        const int u = t ^ stride;
        if (u > t) {
          const long long a = s[t], b = s[u];
          if ((t & size) == 0 ? a > b : a < b) {
            s[t] = b;
            s[u] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  // each thread owns E consecutive sorted keys: the distinct ones are
  // ranked by a block scan of the per-thread counts
  const int E = T / DU_THREADS;
  const int lo = threadIdx.x * E;
  int fresh = 0;
  for (int j = lo; j < lo + E; ++j) {
    fresh += s[j] < DK_SENTINEL && (j == 0 || s[j] != s[j - 1]);
  }
  int distinct;
  int rank = du_scan(fresh, warp_sums, &distinct);
  long long* dst = out + (long long)blockIdx.x * cap;
  for (int j = lo; j < lo + E; ++j) {
    if (s[j] < DK_SENTINEL && (j == 0 || s[j] != s[j - 1])) {
      if (rank < cap) dst[rank] = s[j];
      ++rank;
    }
  }
  for (int r = distinct + threadIdx.x; r < cap; r += DU_THREADS) dst[r] = DK_SENTINEL;
  if (distinct > cap && threadIdx.x == 0) atomicOr(flag, DK_FLAG_CAPACITY);
}

// ---------------------------------------------------------------------------
// dict_ids: one key per thread, grid-stride; with an old dictionary, the
// grid's last block writes perm instead
// ---------------------------------------------------------------------------

// The first position of d[0..n) (sorted) holding a value >= x.
__device__ __forceinline__ int di_lower_bound(const long long* d, int n, long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (d[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(DI_THREADS)
dict_ids(const long long* __restrict__ dict, int cap, const long long* __restrict__ keys,
         long long n, int* __restrict__ gids, const long long* __restrict__ old,
         int* __restrict__ perm) {
  extern __shared__ long long di_smem[];
  for (int t = threadIdx.x; t < cap; t += DI_THREADS) di_smem[t] = __ldg(dict + t);
  __syncthreads();
  const int id_blocks = gridDim.x - (old != nullptr ? 1 : 0);
  if ((int)blockIdx.x == id_blocks) {
    for (int t = threadIdx.x; t < cap; t += DI_THREADS) {
      const long long o = __ldg(old + t);
      perm[t] = o < DK_SENTINEL ? di_lower_bound(di_smem, cap, o) : cap;
    }
    return;
  }
  const long long stride = (long long)id_blocks * DI_THREADS;
  for (long long f = (long long)blockIdx.x * DI_THREADS + threadIdx.x; f < n; f += stride) {
    const int g = di_lower_bound(di_smem, cap, __ldg(keys + f));
    gids[f] = g < cap - 1 ? g : cap - 1;
  }
}

extern "C" {

int dk_params_size(void) { return (int)sizeof(DkParams); }
int du_tile_max(void) { return DU_TILE_MAX; }
long long dk_sentinel(void) { return DK_SENTINEL; }

// Each launcher returns cudaGetLastError() right after its launch.
int dk_launch(const DkParams* p, void* stream) {
  const long long total = p->n_blocks * p->block_rows;
  if (total == 0) return 0;
  long long grid = (total + DK_THREADS - 1) / DK_THREADS;
  if (grid > DK_GRID_MAX) grid = DK_GRID_MAX;
  dict_keys<<<(unsigned)grid, DK_THREADS, 0, (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

// One pass: ceil((n_dict + n_keys) / T) tiles, out [tiles][cap].
int du_launch(const long long* dict, long long n_dict, const long long* keys, long long n_keys,
              long long* out, int* flag, int cap, int T, void* stream) {
  const long long n = n_dict + n_keys;
  const long long tiles = n > 0 ? (n + T - 1) / T : 1;
  const int smem = T * 8;
  const int err = (int)cudaFuncSetAttribute(dict_union,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  dict_union<<<(unsigned)tiles, DU_THREADS, smem, (cudaStream_t)stream>>>(dict, n_dict, keys,
                                                                         n_keys, out, flag, cap, T);
  return (int)cudaGetLastError();
}

int di_launch(const long long* dict, int cap, const long long* keys, long long n, int* gids,
              const long long* old, int* perm, void* stream) {
  long long grid = (n + DI_THREADS - 1) / DI_THREADS;
  if (grid > DI_GRID_MAX) grid = DI_GRID_MAX;
  if (grid < 1) grid = 1;
  if (old != nullptr) ++grid;
  const int smem = cap * 8;
  const int err = (int)cudaFuncSetAttribute(dict_ids,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  dict_ids<<<(unsigned)grid, DI_THREADS, smem, (cudaStream_t)stream>>>(dict, cap, keys, n, gids,
                                                                      old, perm);
  return (int)cudaGetLastError();
}

}  // extern "C"
