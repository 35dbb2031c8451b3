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
// more.  So each block sorts one tile of T keys (T a power of two >= 2 *
// cap), keeps its first cap distinct keys and flags the overflow; the
// wrapper launches the same kernel again over the tiles' lists until one
// tile is left.  If no tile of any pass overflows, no key was dropped and
// the last tile counts every distinct key: the flag is exactly "more than
// cap distinct keys".
//
// How a block sorts its tile (T / DU_E threads, DU_E keys each):
//   1. each thread loads DU_E keys (striped across the block, so that every
//      warp load is coalesced; 16-byte loads where the tile lies in one
//      array, aligned), sentinel-padded, and sorts them in registers with a
//      bitonic network whose indices are compile-time constants;
//   2. each warp merges its lanes' runs into one run of 32 * DU_E keys by
//      bitonic exchanges over __shfl_xor_sync (a flip, then half-cleaners):
//      no shared memory, no block barrier;
//   3. the block merges the warps' runs pairwise in shared memory by merge
//      path: each thread finds where its DU_E outputs start by a binary
//      search on its diagonal and merges them sequentially, so a level costs
//      one barrier (two when the tile is too large for two buffers, past
//      DU_PINGPONG_MAX keys, and merges in place); the buffers hold one pad
//      word every DU_E keys, so that a thread's run does not fall on one
//      bank;
//   4. the distinct keys are ranked by a block scan of the threads' counts
//      (du_scan) and the first cap written.
// The tile route runs tiles of union_tile(cap) keys (copr/fused_dict.py:
// at least TILE_MIN = 1,024, so a shard's 131,072 keys at 64 slots fill 128
// blocks); the smallest tile is one warp's, DU_WARP_KEYS.
//
// Past DI_SMEM_KEYS slots a tile no longer needs to hold two lists of cap
// keys, so the union sorts in device memory instead: one dict_union pass
// with cap = T = DU_SORT_TILE gives every tile's keys sorted (its distinct
// keys, padded with the sentinel) over enough blocks to cover the card;
// dict_merge passes merge pairs of sorted runs (each key's place is its
// index plus its rank in the other run, by binary search: stable, no
// atomics) until one run is left; dict_count counts the distinct keys of
// each chunk of DC_CHUNK sorted keys and dict_compact writes the first cap
// of them in order (a chunk's offset is the sum of the counts before it, a
// key's rank within it a block scan), pads with the sentinel and flags more
// than cap.  Memory: two buffers of the keys.
//
// What bounds them on an H100: dict_keys reads the referenced columns of
// every row and writes 8 bytes a row, with the bytecode walk (fa_walk.cuh)
// per row, as the mask did before its tile walk; dict_union reads each key
// once and sorts in registers and shared memory (log2(T / 512) merge
// levels a tile after the warps' sorts); dict_ids reads each key once and
// writes 4 bytes a key: a key a thread, at most 13 steps in a
// shared-memory copy of the dictionary.  Past DI_SMEM_KEYS slots
// each step left in device memory reads a 32-byte sector of L2 for 8 bytes,
// so the search's L2 sectors, not HBM, bound it: a shared table of every
// stride-th key (at most DI_SPLITS: a larger table costs more to fill in
// every block than it saves) places the key within one stride, which
// halving narrows to its place.  The perm's lower bounds run beside the
// keys over the whole grid, not in one block.  At the mesh path's shapes
// (131,072 rows a shard, cap 64) all three are a few microseconds of launch
// latency.
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
#define DU_E 16                    // keys a dict_union thread sorts in registers
#define DU_WARP_KEYS (32 * DU_E)   // a warp's run: the smallest tile
#define DU_TILE_MAX 16384          // the largest tile (1,024 threads), 136 KB in shared memory
#define DU_PINGPONG_MAX 8192       // tiles up to this merge between two buffers
#define DU_SORT_TILE 4096          // the sort route's tile
#define DM_THREADS 256
#define DM_GRID_MAX 4096
#define DC_PER_THREAD 8
#define DC_CHUNK (DU_THREADS * DC_PER_THREAD)  // sorted keys a dict_count/dict_compact block reads
#define DI_SMEM_KEYS 8192          // past this, dict_ids' table holds every stride-th key
#define DI_SPLITS 256              // most keys of dict_ids' table past DI_SMEM_KEYS (2 KB)
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
// offset and sets *total.  `warp_sums` holds blockDim.x / 32 ints (a block
// of whole warps).
__device__ __forceinline__ int du_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < warps) warp_sums[lane] = s;
  }
  __syncthreads();
  *total = warp_sums[warps - 1];
  return (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
}

// Key g of the virtual array (dict[0..n_dict) ++ keys[0..n_keys)), the
// sentinel past its end.
__device__ __forceinline__ long long du_key(const long long* dict, long long n_dict,
                                           const long long* keys, long long n_keys, long long g) {
  if (g < n_dict) return __ldg(dict + g);
  if (g - n_dict < n_keys) return __ldg(keys + (g - n_dict));
  return DK_SENTINEL;
}

// Shared-memory slot of sorted position j: one pad word every DU_E keys.
__device__ __forceinline__ int du_pad(int j) { return j + j / DU_E; }

__device__ __forceinline__ void du_cx(long long& a, long long& b) {
  const long long lo = a < b ? a : b, hi = a < b ? b : a;
  a = lo;
  b = hi;
}

// Ascending bitonic sort of the thread's DU_E keys.
__device__ __forceinline__ void du_sort_regs(long long (&v)[DU_E]) {
#pragma unroll
  for (int size = 2; size <= DU_E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < DU_E; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          if ((i & size) == 0) {
            du_cx(v[i], v[j]);
          } else {
            du_cx(v[j], v[i]);
          }
        }
      }
    }
  }
}

// The smaller (low) or the larger of a and b.
__device__ __forceinline__ long long du_keep(long long a, long long b, bool low) {
  return low == (a < b) ? a : b;
}

// The warp's 32 sorted runs of DU_E keys merged into one: lane l ends with
// positions [l * DU_E, (l + 1) * DU_E) of the warp's sorted keys.  Step g
// merges runs of g / 2 lanes pairwise into runs of g lanes: the flip
// compares each position with its mirror in the g-lane run (key e of lane l
// with key DU_E - 1 - e of lane l ^ (g - 1)), then half-cleaners across
// lanes (lane l ^ h, the same key) and within the thread; the lower
// position keeps the smaller key.  The flip exchanges keys e and DU_E - 1 -
// e together, so that both are sent before either changes.
__device__ __forceinline__ void du_warp_merge(long long (&v)[DU_E]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 2; g <= 32; g <<= 1) {
    {
      const bool low = (lane & (g >> 1)) == 0;
#pragma unroll
      for (int e = 0; e < DU_E / 2; ++e) {
        const long long mirror_of_e = __shfl_xor_sync(0xffffffffu, v[DU_E - 1 - e], g - 1);
        const long long mirror_of_last = __shfl_xor_sync(0xffffffffu, v[e], g - 1);
        v[e] = du_keep(v[e], mirror_of_e, low);
        v[DU_E - 1 - e] = du_keep(v[DU_E - 1 - e], mirror_of_last, low);
      }
    }
#pragma unroll
    for (int h = g >> 2; h > 0; h >>= 1) {
      const bool low = (lane & h) == 0;
#pragma unroll
      for (int e = 0; e < DU_E; ++e) v[e] = du_keep(v[e], __shfl_xor_sync(0xffffffffu, v[e], h), low);
    }
#pragma unroll
    for (int stride = DU_E >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < DU_E; ++i) {
        const int j = i ^ stride;
        if (j > i) du_cx(v[i], v[j]);
      }
    }
  }
}

// The thread's DU_E outputs of one merge-path level: sorted runs of L keys
// of s, pairwise; the thread writes positions [o, o + DU_E) of its pair.
// Its split (i keys from the first run, o - i from the second) is the first
// i whose key in the first run exceeds the second run's key at o - 1 - i; a
// key of the first run goes before an equal one of the second.
__device__ __forceinline__ void du_merge_path(const long long* s, int L, long long (&v)[DU_E]) {
  const int per_pair = 2 * L / DU_E;
  const int pair = threadIdx.x / per_pair;
  const int o = (threadIdx.x - pair * per_pair) * DU_E;
  const int a0 = pair * 2 * L, b0 = a0 + L;
  int lo = o > L ? o - L : 0, hi = o < L ? o : L;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[du_pad(a0 + mid)] <= s[du_pad(b0 + o - 1 - mid)]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo, j = o - lo;
  long long x = i < L ? s[du_pad(a0 + i)] : 0, y = j < L ? s[du_pad(b0 + j)] : 0;
#pragma unroll
  for (int k = 0; k < DU_E; ++k) {
    const bool from_a = j >= L || (i < L && x <= y);
    v[k] = from_a ? x : y;
    if (from_a) {
      ++i;
      x = i < L ? s[du_pad(a0 + i)] : 0;
    } else {
      ++j;
      y = j < L ? s[du_pad(b0 + j)] : 0;
    }
  }
}

// Keys [blockIdx.x * T, (blockIdx.x + 1) * T) of the virtual array
// (dict[0..n_dict) ++ keys[0..n_keys)), padded with the sentinel, sorted;
// out[blockIdx.x] = their first cap distinct non-sentinel keys, padded with
// the sentinel; DK_FLAG_CAPACITY ORed into *flag when there are more.  T is
// a power of two in [DU_WARP_KEYS, DU_TILE_MAX], the block T / DU_E threads.
__global__ void __launch_bounds__(DU_THREADS)
dict_union(const long long* __restrict__ dict, long long n_dict,
           const long long* __restrict__ keys, long long n_keys, long long* __restrict__ out,
           int* flag, int cap, int T) {
  extern __shared__ long long du_smem[];
  __shared__ int warp_sums[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long base = (long long)blockIdx.x * T;
  long long v[DU_E];
  // 1. load (key e of thread t is tile position e * nt + t) and sort
  const long long* run = nullptr;  // the tile's keys, when they lie in one array
  if (base + T <= n_dict) {
    run = dict + base;
  } else if (base >= n_dict && base - n_dict + T <= n_keys) {
    run = keys + (base - n_dict);
  }
  if (run != nullptr && ((unsigned long long)run & 15) == 0) {
    const longlong2* r2 = (const longlong2*)run;
#pragma unroll
    for (int e = 0; e < DU_E / 2; ++e) {
      const longlong2 q = __ldg(r2 + e * nt + tid);
      v[2 * e] = q.x;
      v[2 * e + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < DU_E; ++e) v[e] = du_key(dict, n_dict, keys, n_keys, base + e * nt + tid);
  }
  du_sort_regs(v);
  // 2. the warp's run
  du_warp_merge(v);
  // 3. the warps' runs merged, level by level
  long long* src = du_smem;
  long long* dst = T <= DU_PINGPONG_MAX ? du_smem + du_pad(T) : du_smem;
#pragma unroll
  for (int e = 0; e < DU_E; ++e) src[du_pad(tid * DU_E + e)] = v[e];
  __syncthreads();
  for (int L = DU_WARP_KEYS; L < T; L <<= 1) {
    du_merge_path(src, L, v);
    if (dst == src) __syncthreads();  // in place: every read before any write
#pragma unroll
    for (int e = 0; e < DU_E; ++e) dst[du_pad(tid * DU_E + e)] = v[e];
    __syncthreads();
    long long* t = src;
    src = dst;
    dst = t;
  }
  // 4. the thread's DU_E consecutive sorted keys are in v: the distinct ones
  // are ranked by a block scan of the per-thread counts
  const int lo = tid * DU_E;
  long long prev = tid > 0 ? src[du_pad(lo - 1)] : 0;
  int fresh = 0;
#pragma unroll
  for (int e = 0; e < DU_E; ++e) {
    fresh += v[e] < DK_SENTINEL && (lo + e == 0 || v[e] != prev);
    prev = v[e];
  }
  int distinct;
  int rank = du_scan(fresh, warp_sums, &distinct);
  long long* out_tile = out + (long long)blockIdx.x * cap;
  prev = tid > 0 ? src[du_pad(lo - 1)] : 0;
#pragma unroll
  for (int e = 0; e < DU_E; ++e) {
    if (v[e] < DK_SENTINEL && (lo + e == 0 || v[e] != prev)) {
      if (rank < cap) out_tile[rank] = v[e];
      ++rank;
    }
    prev = v[e];
  }
  for (int r = distinct + tid; r < cap; r += nt) out_tile[r] = DK_SENTINEL;
  if (distinct > cap && tid == 0) atomicOr(flag, DK_FLAG_CAPACITY);
}

// ---------------------------------------------------------------------------
// dict_merge, dict_count, dict_compact: the union past DI_SMEM_KEYS slots
// ---------------------------------------------------------------------------

// The first position of d[0..n) (sorted, in device memory) holding a value
// > x (upper) or >= x (lower).
__device__ __forceinline__ long long dm_bound(const long long* d, long long n, long long x,
                                              bool upper) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long v = __ldg(d + mid);
    if (v < x || (upper && v == x)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One merge pass: the sorted runs [r * W, (r + 1) * W) of src[0..n) (the
// last one may be short) merged pairwise into dst, run 2q with run 2q + 1.
// A key of the first run goes to its index plus the count of the second's
// keys below it; one of the second run to its index plus the count of the
// first's keys at or below it.
__global__ void __launch_bounds__(DM_THREADS)
dict_merge(const long long* __restrict__ src, long long n, long long W,
           long long* __restrict__ dst) {
  const long long stride = (long long)gridDim.x * DM_THREADS;
  for (long long i = (long long)blockIdx.x * DM_THREADS + threadIdx.x; i < n; i += stride) {
    const long long a0 = i / (2 * W) * 2 * W;
    const long long b0 = a0 + W < n ? a0 + W : n;
    const long long b1 = b0 + W < n ? b0 + W : n;
    const long long x = __ldg(src + i);
    const long long at = i < b0 ? i + dm_bound(src + b0, b1 - b0, x, false)
                                : i - W + dm_bound(src + a0, b0 - a0, x, true);
    dst[at] = x;
  }
}

// Whether sorted key j of s starts a distinct non-sentinel key.
__device__ __forceinline__ int dc_fresh(const long long* s, long long j) {
  const long long v = __ldg(s + j);
  return v < DK_SENTINEL && (j == 0 || __ldg(s + j - 1) != v);
}

// counts[b]: the distinct keys among sorted keys [b * DC_CHUNK, ...) of s.
__global__ void __launch_bounds__(DU_THREADS)
dict_count(const long long* __restrict__ s, long long n, int* __restrict__ counts) {
  __shared__ int warp_sums[DU_THREADS / 32];
  const long long lo = (long long)blockIdx.x * DC_CHUNK + (long long)threadIdx.x * DC_PER_THREAD;
  int fresh = 0;
  for (long long j = lo; j < lo + DC_PER_THREAD && j < n; ++j) fresh += dc_fresh(s, j);
  int total;
  du_scan(fresh, warp_sums, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// out[0..cap): the first cap distinct keys of the sorted s[0..n), padded
// with the sentinel; DK_FLAG_CAPACITY ORed into *flag when there are more.
__global__ void __launch_bounds__(DU_THREADS)
dict_compact(const long long* __restrict__ s, long long n, const int* __restrict__ counts,
             long long* __restrict__ out, int* flag, int cap) {
  __shared__ int warp_sums[DU_THREADS / 32];
  __shared__ long long before;
  if (threadIdx.x == 0) {
    long long acc = 0;
    for (unsigned b = 0; b < blockIdx.x; ++b) acc += counts[b];
    before = acc;
  }
  const long long lo = (long long)blockIdx.x * DC_CHUNK + (long long)threadIdx.x * DC_PER_THREAD;
  int fresh = 0;
  for (long long j = lo; j < lo + DC_PER_THREAD && j < n; ++j) fresh += dc_fresh(s, j);
  int total;
  const int mine = du_scan(fresh, warp_sums, &total);  // its barriers publish `before`
  long long rank = before + mine;
  for (long long j = lo; j < lo + DC_PER_THREAD && j < n; ++j) {
    if (dc_fresh(s, j)) {
      if (rank < cap) out[rank] = __ldg(s + j);
      ++rank;
    }
  }
  const long long end = before + total;
  if (blockIdx.x == gridDim.x - 1) {
    for (long long r = end + threadIdx.x; r < cap; r += DU_THREADS) out[r] = DK_SENTINEL;
  }
  if (end > cap && threadIdx.x == 0) atomicOr(flag, DK_FLAG_CAPACITY);
}

// ---------------------------------------------------------------------------
// dict_ids: one key or perm slot a thread
// ---------------------------------------------------------------------------

// The count of the sorted s[0..n) (n >= 1, shared memory) below x: a
// search whose steps do not depend on the key (the interval's length
// halves whatever the comparison says), so the warp's lanes step together.
__device__ __forceinline__ long long di_count_below(const long long* s, int n, long long x) {
  int b = 0;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
    b = s[b + half] < x ? b + half : b;
    len -= half;
  }
  return b + (s[b] < x ? 1 : 0);
}

// searchsorted(dict, x) past DI_SMEM_KEYS slots, given c, the count of the
// table (every stride-th key of dict) below x: the place lies in (lo, hi],
// lo = (c - 1) * stride (dict[lo] < x), hi = c * stride (dict[hi] >= x) or
// cap, which halving in device memory (the dictionary stays in L2) finds.
__device__ __forceinline__ long long di_tail(const long long* __restrict__ dict, int cap,
                                             int stride, long long c, long long x) {
  if (c == 0) return 0;
  long long lo = (c - 1) * stride;
  long long hi = c * stride < cap ? c * stride : cap;
  while (hi - lo > 1) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(dict + mid) < x) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return hi;
}

// ids[u] = clip(searchsorted(dict, keys[u]), 0, cap - 1) for u < n and,
// with the old dictionary, perm[t] = searchsorted(dict, old[t]) (cap for a
// sentinel slot): the items [0, n + cap) of the grid, one a thread in a
// grid stride, so the perm's slots spread over the blocks like the keys.
// Each block first copies its table of n_tab keys into shared memory: the
// dictionary itself (TAIL false, cap <= DI_SMEM_KEYS), or every `stride`-th
// key of it (TAIL, past DI_SMEM_KEYS slots: at most DI_SPLITS keys), from
// which di_tail goes on in device memory.  (The launcher computes n_tab: a
// 64-bit division here would delay every block's start.)
template <bool TAIL>
__global__ void __launch_bounds__(DI_THREADS)
dict_ids(const long long* __restrict__ dict, int cap, int stride, int n_tab,
         const long long* __restrict__ keys, long long n, int* __restrict__ gids,
         const long long* __restrict__ old, int* __restrict__ perm) {
  extern __shared__ long long di_table[];
  const long long items = n + (old != nullptr ? cap : 0);
  const long long step = (long long)gridDim.x * DI_THREADS;
  auto item = [&](long long v) { return v < n ? __ldg(keys + v) : __ldg(old + (v - n)); };
  long long u = (long long)blockIdx.x * DI_THREADS + threadIdx.x;
  long long x = u < items ? item(u) : 0;  // in flight while the table fills
  for (int t = threadIdx.x; t < n_tab; t += DI_THREADS) {
    di_table[t] = __ldg(dict + (long long)t * stride);
  }
  __syncthreads();
  while (u < items) {
    long long c = di_count_below(di_table, n_tab, x);
    if (TAIL) c = di_tail(dict, cap, stride, c, x);
    if (u < n) {
      gids[u] = (int)(c < cap - 1 ? c : cap - 1);
    } else {
      perm[u - n] = x < DK_SENTINEL ? (int)c : cap;
    }
    u += step;
    if (u < items) x = item(u);
  }
}

// Past DI_SMEM_KEYS slots: every stride-th key in the table, the fewest
// 2^k that keep it within DI_SPLITS keys.
static int di_stride(int cap) {
  if (cap <= DI_SMEM_KEYS) return 1;
  int s = 1;
  while (((long long)cap + s - 1) / s > DI_SPLITS) s <<= 1;
  return s;
}

extern "C" {

int dk_params_size(void) { return (int)sizeof(DkParams); }
int du_tile_max(void) { return DU_TILE_MAX; }
int du_sort_tile(void) { return DU_SORT_TILE; }

// cudaFuncGetAttributes of dict_union: registers a thread, local and static
// shared bytes, into out[0..3).
int du_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)dict_union);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}
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

// The shared memory of a dict_union block for a tile of T keys.
static int du_smem_bytes(int T) {
  return (T <= DU_PINGPONG_MAX ? 2 : 1) * (T + T / DU_E) * 8;
}

// One pass: ceil((n_dict + n_keys) / T) tiles, out [tiles][cap].
int du_launch(const long long* dict, long long n_dict, const long long* keys, long long n_keys,
              long long* out, int* flag, int cap, int T, void* stream) {
  if (T < DU_WARP_KEYS || T > DU_TILE_MAX || (T & (T - 1)) != 0 || cap > T) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = n_dict + n_keys;
  const long long tiles = n > 0 ? (n + T - 1) / T : 1;
  const int smem = du_smem_bytes(T);
  const int err = (int)cudaFuncSetAttribute(dict_union,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  dict_union<<<(unsigned)tiles, T / DU_E, smem, (cudaStream_t)stream>>>(dict, n_dict, keys,
                                                                       n_keys, out, flag, cap, T);
  return (int)cudaGetLastError();
}

// One launch: the keys and (old not null) the perm's slots, one a thread;
// the table in dynamic shared memory.
int di_launch(const long long* dict, int cap, const long long* keys, long long n, int* gids,
              const long long* old, int* perm, void* stream) {
  const long long items = n + (old != nullptr ? cap : 0);
  long long grid = (items + DI_THREADS - 1) / DI_THREADS;
  if (grid > DI_GRID_MAX) grid = DI_GRID_MAX;
  if (grid < 1) grid = 1;
  const int stride = di_stride(cap);
  const int n_tab = (int)(((long long)cap + stride - 1) / stride);
  const int smem = n_tab * 8;
  const void* k = stride > 1 ? (const void*)dict_ids<true> : (const void*)dict_ids<false>;
  const int err = (int)cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  if (stride > 1) {
    dict_ids<true><<<(unsigned)grid, DI_THREADS, smem, (cudaStream_t)stream>>>(
        dict, cap, stride, n_tab, keys, n, gids, old, perm);
  } else {
    dict_ids<false><<<(unsigned)grid, DI_THREADS, smem, (cudaStream_t)stream>>>(
        dict, cap, stride, n_tab, keys, n, gids, old, perm);
  }
  return (int)cudaGetLastError();
}

// The table's stride of dict_ids at `cap` slots (1: the dictionary itself).
int di_table_stride(int cap) { return di_stride(cap); }

// cudaFuncGetAttributes of the dict_ids instance that runs at `cap` slots
// (past DI_SMEM_KEYS the one with the device-memory tail): registers a
// thread, local and static shared bytes, into out[0..3).
int di_attributes(int cap, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, di_stride(cap) > 1 ? (const void*)dict_ids<true> : (const void*)dict_ids<false>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

// One merge pass over n keys in runs of W.
int dm_launch(const long long* src, long long n, long long W, long long* dst, void* stream) {
  if (n == 0) return 0;
  long long grid = (n + DM_THREADS - 1) / DM_THREADS;
  if (grid > DM_GRID_MAX) grid = DM_GRID_MAX;
  dict_merge<<<(unsigned)grid, DM_THREADS, 0, (cudaStream_t)stream>>>(src, n, W, dst);
  return (int)cudaGetLastError();
}

// counts: one int per chunk of DC_CHUNK keys, ceil(n / DC_CHUNK) of them.
int dc_launch_count(const long long* s, long long n, int* counts, void* stream) {
  const long long chunks = (n + DC_CHUNK - 1) / DC_CHUNK;
  if (chunks == 0) return 0;
  dict_count<<<(unsigned)chunks, DU_THREADS, 0, (cudaStream_t)stream>>>(s, n, counts);
  return (int)cudaGetLastError();
}

// One block per chunk (at least one: the padding is still written).
int dc_launch_compact(const long long* s, long long n, const int* counts, long long* out,
                      int* flag, int cap, void* stream) {
  long long chunks = (n + DC_CHUNK - 1) / DC_CHUNK;
  if (chunks == 0) chunks = 1;
  dict_compact<<<(unsigned)chunks, DU_THREADS, 0, (cudaStream_t)stream>>>(s, n, counts, out, flag,
                                                                         cap);
  return (int)cudaGetLastError();
}

int dc_chunk(void) { return DC_CHUNK; }
int di_smem_keys(void) { return DI_SMEM_KEYS; }

}  // extern "C"
