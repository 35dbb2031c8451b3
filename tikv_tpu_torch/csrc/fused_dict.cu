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
// dict_merge levels merge up to DM_FAN_MAX sorted runs into one each (a key's
// place is its index plus, in each other run of its group, the count of keys
// before it: stable), two levels up to 64 runs (the mesh path's
// 163,840 and 262,144 keys), until one run is left; dict_compact writes
// the first cap distinct keys of the sorted run in order, pads with the
// sentinel and flags more than cap, in one pass (a tile's offset by a
// decoupled look-back over the tiles before it).  Memory: two buffers of the
// keys and dict_compact's status words.
//
// What bounds them on an H100: dict_keys reads the referenced columns of
// every row and writes 8 bytes a row; at a mesh shard (131,072 rows) that
// is about a microsecond of HBM, so launch latency and one tile's dependent
// loads bound it.  It walks DK_ROWS rows of a block a thread through the
// tile walk (fa_walk.cuh: the stack in registers, no local memory, a column
// loaded a tile at a time in 4- to 16-byte words), stores a full tile's
// keys as two 16-byte words, steps the grid's stride over tiles without a
// division a row, and runs on a grid of the blocks the card holds at once;
// its instances hold 2, 4 or 8 stack slots, picked from the plan's code.
// dict_union reads each key
// once and sorts in registers and shared memory (log2(T / 512) merge
// levels a tile after the warps' sorts); dict_ids reads each key once and
// writes 4 bytes a key: a key a thread, at most 13 steps in a
// shared-memory copy of the dictionary.  Past DI_SMEM_KEYS slots
// each step left in device memory reads a 32-byte sector of L2 for 8 bytes,
// so the search's L2 sectors, not HBM, bound it: a shared table of every
// stride-th key (at most DI_SPLITS: a larger table costs more to fill in
// every block than it saves) places the key within one stride, which
// halving narrows to its place.  The perm's lower bounds run beside the
// keys over the whole grid, not in one block.  dict_merge moves the keys
// once a level (1.3 MB at a shard union: under a microsecond of HBM, and the
// keys stay in L2), so launches and dependent loads bound it: the pairwise
// passes it replaces took one launch a doubling and searched every key's
// place in L2 (up to 17 dependent loads).  A level now merges up to eight
// runs in two rounds of loads a block: its keys with every run's samples
// and live count, then its windows (cp.async); the counts come from merges
// in shared memory.  A block takes DM_CHUNK = 2,048 keys, so that a
// union's grid (80 or 128 blocks) holds one block an SM.  What is left is
// the levels' fixed latency (about 10 us a block) and F - 1 merge walks a
// key.  dict_compact reads the sorted keys once and writes cap keys (1.3-2.1
// MB at the mesh path's unions, under a microsecond of HBM), so latency and
// the SMs it covers bound it: one launch, a block a tile of DC_TILE = 2,048
// keys (80-128 blocks a union, to cover the card), its keys loaded 16 bytes
// a thread, coalesced, its offset found in the same pass from the tiles
// before it.
// At the mesh path's shapes (131,072 rows a shard, cap 64) all three are a
// few microseconds of launch latency.
//
// Determinism: integers only; the atomics OR a flag bit, take tickets and
// count the blocks done, none of which reaches the output.  Reruns are
// bit-identical.
//
// Layout contract with tikv_tpu_torch/copr/fused_dict.py (the wrapper
// checks sizeof(DkParams) and the limits at load).

#include <cuda_pipeline.h>

#include "fa_walk.cuh"

#define DK_THREADS 256
#define DK_ROWS 4                  // rows a dict_keys thread walks at once (its tile)
#define DU_THREADS 1024
#define DI_THREADS 256
#define DI_GRID_MAX 1024
#define DU_E 16                    // keys a dict_union thread sorts in registers
#define DU_WARP_KEYS (32 * DU_E)   // a warp's run: the smallest tile
#define DU_TILE_MAX 16384          // the largest tile (1,024 threads), 136 KB in shared memory
#define DU_PINGPONG_MAX 8192       // tiles up to this merge between two buffers
#define DU_SORT_TILE 4096          // the sort route's tile
#define DM_THREADS 512
#define DM_CHUNK 2048              // keys of one run a dict_merge block places
#define DM_PAD 16                  // a pad slot every DM_PAD keys of a dict_merge chunk
#define DM_FAN_MAX 8               // runs a dict_merge level merges into one
#define DM_STAGE 18432             // keys of the other runs a dict_merge block stages at once
#define DM_SAMPLES 256             // the most keys of a run a dict_merge block samples
#define DM_SAMPLE_GAP 32           // the fewest keys between two of them
#define DM_BIG 4096                // a dict_merge window past this is searched, not staged
#define DM_TILE DU_SORT_TILE       // the tiles whose live keys dict_union counts
#define DC_THREADS 256
#define DC_TILE 2048               // sorted keys a dict_compact block reads
#define DC_ROWS (DC_TILE / (2 * DC_THREADS))  // rows of 16 bytes a dict_compact thread loads
#define DC_WARPS (DC_THREADS / 32)
#define DC_LOOK 4                  // status words a lane reads at once in the look-back
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
// dict_keys: DK_ROWS rows of one block a thread (a tile), grid-stride over
// tiles
// ---------------------------------------------------------------------------

static_assert(DK_ROWS == 4, "dict_keys stores a full tile's keys as two 16-byte words");

// The tile walk (fa_walk_tile) hands each sort key q out as the tile's R
// values and their NULL bits, in order q = 0, 1, ...; each row's key shifts
// left by key_bits and takes the lane (a NULL as lane_max, an f64 value
// truncated), in unsigned arithmetic.  A row the selection drops, or past
// n_valid, is the sentinel; the range flag counts selected rows only.  A
// tile never straddles two blocks: a block whose row count is not a
// multiple of R ends in a short one.  The minimum of one block an SM lets
// ptxas give the walk the registers it needs (as fused_mask).  The walk
// does not wait for the block's n_valid: it runs over the tile's rows of
// the block (the image holds them all) while n_valid is in flight, and the
// rows past it are masked out of the selection after.
template <int D>
__global__ void __launch_bounds__(DK_THREADS, 1) dict_keys(const __grid_constant__ DkParams p) {
  constexpr int R = DK_ROWS;
  const long long tiles = (p.block_rows + R - 1) / R;  // tiles a block
  const long long total = p.n_blocks * tiles;
  const long long stride = (long long)gridDim.x * DK_THREADS;
  const int kb = p.key_bits;
  const long long lane_max = (long long)((1ULL << kb) - 1);
  bool any_bad = false;
  long long t = (long long)blockIdx.x * DK_THREADS + threadIdx.x;
  FaCursor c(t, stride, tiles);
  for (; t < total; t += stride) {
    const long long i0 = c.i * R;
    const long long f0 = c.blk * p.block_rows + i0;
    const long long left = p.block_rows - i0;
    const int n = left < R ? (int)left : R;  // the block's rows in the tile
    const long long nv = (p.n_valids != nullptr ? __ldg(p.n_valids + c.blk) : p.n_valid_all) - i0;
    u64 key[R];
#pragma unroll
    for (int r = 0; r < R; ++r) key[r] = 0;
    unsigned bad = 0;
    unsigned active = fa_walk_tile<R, D>(
        p, f0, c.blk, i0, n, (1u << n) - 1,
        [](int, unsigned, const long long (&)[R], unsigned) {},
        [&](int q, const long long (&x)[R], unsigned xn) {
          const bool is_f = (p.key_f64 >> q) & 1;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const long long v = is_f ? dk_trunc(fa_f(x[r])) : x[r];
            const bool nul = (xn >> r) & 1;
            bad |= (unsigned)(!nul && (v < 0 || v >= lane_max)) << r;
            const u64 lane = nul ? (u64)lane_max : (u64)v;
            key[r] = (key[r] << kb) | (lane & (u64)lane_max);
          }
        });
    const int live = nv <= 0 ? 0 : nv < n ? (int)nv : n;
    active &= (1u << live) - 1;
    any_bad = any_bad || (active & bad) != 0;
    long long out[R];
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] = (active >> r) & 1 ? (long long)key[r] : DK_SENTINEL;
    long long* dst = p.keys + f0;
    if (n == R && ((u64)dst & 15) == 0) {
      longlong2* d2 = (longlong2*)dst;
      d2[0] = make_longlong2(out[0], out[1]);
      d2[1] = make_longlong2(out[2], out[3]);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < n) dst[r] = out[r];
      }
    }
    c.advance();
  }
  if (__any_sync(0xffffffffu, any_bad) && (threadIdx.x & 31) == 0) atomicOr(p.flag, DK_FLAG_RANGE);
}

typedef void (*DkKernel)(DkParams);

// The instance whose stack holds `slots` operands (2, 4 or 8); nullptr else.
static DkKernel dk_kernel(int slots) {
  switch (slots) {
    case 2: return dict_keys<2>;
    case 4: return dict_keys<4>;
    case 8: return dict_keys<8>;
    default: return nullptr;
  }
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
// the sentinel; DK_FLAG_CAPACITY ORed into *flag when there are more;
// tile_live[blockIdx.x] (when not null: the sort route) the count of those
// keys.  T is a power of two in [DU_WARP_KEYS, DU_TILE_MAX], the block T /
// DU_E threads.
__global__ void __launch_bounds__(DU_THREADS)
dict_union(const long long* __restrict__ dict, long long n_dict,
           const long long* __restrict__ keys, long long n_keys, long long* __restrict__ out,
           int* flag, int cap, int T, int* __restrict__ tile_live) {
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
  if (tile_live != nullptr && tid == 0) tile_live[blockIdx.x] = distinct < cap ? distinct : cap;
}

// ---------------------------------------------------------------------------
// dict_merge: the union's levels past DI_SMEM_KEYS slots
// ---------------------------------------------------------------------------

// Shared-memory slot of a dict_merge block's key t (or staged key t): one
// pad slot every DM_PAD keys, so that threads walking the keys DM_PAD apart
// meet on few banks.
__host__ __device__ constexpr int dm_pad(int t) { return t + t / DM_PAD; }

// Whether key v of another run goes before the key x in a stable merge:
// below it, or equal to it when the other run comes first (`upper`).
__device__ __forceinline__ bool dm_before(long long v, long long x, bool upper) {
  return v < x || (upper && v == x);
}

// One merge level: the sorted runs [q * W, (q + 1) * W) of src[0..n) (the
// last one may be short) merged F at a time into dst, runs gF .. gF + F - 1
// into one run of F * W keys (n and W multiples of DM_TILE, 2 <= F <=
// DM_FAN_MAX).  Every run is its live (non-sentinel) keys, sorted, then
// sentinels: tile_live[t] counts the live keys of tile t of the tile sort,
// and a run's are the sum of its tiles'.  So a group's run is its live keys
// merged, then every sentinel; a sentinel goes after the group's live keys
// and the sentinels of the runs before its own, in run order.  A block
// takes DM_CHUNK consecutive keys of one run r; a live key's place is its
// index in r plus, for each other run s of the group, the count of s's keys
// before it (below it, or equal when s comes before r: the merge is stable,
// and equal keys are equal words).  A warp a run reads evenly spaced keys of
// it (samples: a key every `stride`), which bound a window of s that holds
// every count the block's live keys need there (the samples before its
// first key and after its last live key; the keys below the window count
// for all of them).  A group whose runs already follow each other in order
// (each run's last key at most the next one's first: the tiles of a sorted
// dictionary) is copied.  A window of up to DM_BIG keys is staged in shared
// memory (DM_STAGE keys at a time, cp.async, all in flight) and merged with
// the chunk's live keys by a share of the block's threads, the shares as
// the merges' lengths, a span of the merge a thread (merge path: a search
// on its diagonal, then a walk), each key's count added into a shared count
// a key.  A larger window (a chunk whose keys spread over a run far denser
// than it) is not staged: each live key finds its place in it from the
// samples, then by halving in device memory within a stride.
__global__ void __launch_bounds__(DM_THREADS)
dict_merge(const long long* __restrict__ src, long long n, long long W, int F,
           const int* __restrict__ tile_live, long long* __restrict__ dst) {
  extern __shared__ long long dm_stage[];
  // key t of the chunk and its count at dm_pad(t)
  __shared__ long long keys[dm_pad(DM_CHUNK)];
  __shared__ int counts[dm_pad(DM_CHUNK)];
  __shared__ long long samples[DM_FAN_MAX][DM_SAMPLES];
  __shared__ long long live[DM_FAN_MAX], last[DM_FAN_MAX];
  __shared__ long long win_lo[DM_FAN_MAX], win_hi[DM_FAN_MAX], seg_at[DM_FAN_MAX];
  __shared__ int seg_off[DM_FAN_MAX], seg_len[DM_FAN_MAX], first[DM_FAN_MAX + 1];
  __shared__ int staged;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * DM_CHUNK;
  const long long r = base / W;
  const long long g0 = r / F * F;
  const long long runs = (n + W - 1) / W;
  const int m = (int)(runs - g0 < F ? runs - g0 : F);  // the group's runs
  const int jr = (int)(r - g0);                         // r among them
  // a sample every `stride` keys: ns of them a run, a power of two
  const int ns = W / DM_SAMPLE_GAP < DM_SAMPLES ? (int)(W / DM_SAMPLE_GAP) : DM_SAMPLES;
  const long long stride = W / ns;
  {  // every load of this round in flight before any is stored
    constexpr int KE = DM_CHUNK / DM_THREADS, SE = DM_FAN_MAX * DM_SAMPLES / DM_THREADS;
    long long kv[KE], sv[SE];
#pragma unroll
    for (int u = 0; u < KE; ++u) kv[u] = __ldg(src + base + tid + u * DM_THREADS);
#pragma unroll
    for (int u = 0; u < SE; ++u) {
      const int t = tid + u * DM_THREADS, j = t / ns, q = t - j * ns;
      const long long at = (g0 + j) * W + (long long)q * stride;
      sv[u] = m > 1 && j < m && at < n ? __ldg(src + at) : DK_SENTINEL;
    }
    // a run's last key: a group whose runs follow each other in order is
    // merged already
    const long long end = tid < m ? ((g0 + tid + 1) * W < n ? (g0 + tid + 1) * W : n) : 0;
    const long long last_v = m > 1 && tid < m ? __ldg(src + end - 1) : 0;
    long long c = 0;
    if (m > 1 && warp < m) {  // a warp a run: its tiles' live keys
      const long long t0 = (g0 + warp) * (W / DM_TILE);
      const long long t1 = t0 + W / DM_TILE < n / DM_TILE ? t0 + W / DM_TILE : n / DM_TILE;
      for (long long t = t0 + lane; t < t1; t += 32) c += __ldg(tile_live + t);
    }
#pragma unroll
    for (int u = 0; u < KE; ++u) {
      keys[dm_pad(tid + u * DM_THREADS)] = kv[u];
      counts[dm_pad(tid + u * DM_THREADS)] = 0;
    }
#pragma unroll
    for (int u = 0; u < SE; ++u) {
      const int t = tid + u * DM_THREADS, j = t / ns;
      if (j < m) samples[j][t - j * ns] = sv[u];
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(0xffffffffu, c, d);
    if (warp < m && lane == 0) live[warp] = c;
    if (tid < m) last[tid] = last_v;
  }
  __syncthreads();
  bool in_order = true;  // each run's last key at most the next one's first
  for (int j = 0; j + 1 < m; ++j) in_order = in_order && last[j] <= samples[j + 1][0];
  if (m == 1 || in_order) {  // a group of one run, or of runs in order: copied
    for (int t = tid; t < DM_CHUNK; t += DM_THREADS) dst[base + t] = keys[dm_pad(t)];
    return;
  }
  // the group's live keys, then the sentinels of the runs before r
  long long all_live = 0, sent_before = 0;
  for (int j = 0; j < m; ++j) {
    all_live += live[j];
    if (j < jr) {
      const long long len = n - (g0 + j) * W < W ? n - (g0 + j) * W : W;
      sent_before += len - live[j];
    }
  }
  const long long i0 = base - r * W;  // the chunk's first key's index in r
  const long long live_r = live[jr];
  const int chunk_live = (int)(live_r - i0 <= 0 ? 0 : (live_r - i0 < DM_CHUNK ? live_r - i0
                                                                              : DM_CHUNK));
  long long below = 0;
  if (chunk_live > 0) {
    const long long x_first = keys[0], x_last = keys[dm_pad(chunk_live - 1)];
    if (warp < m) {  // a warp a run: its window, from the samples before the two keys
      long long lo = 0, hi = 0;
      if (warp != jr) {
        const bool upper = warp < jr;
        int c = 0, c2 = 0;
        for (int u = lane; u < ns; u += 32) {
          const long long v = samples[warp][u];
          c += dm_before(v, x_first, upper);
          c2 += dm_before(v, x_last, upper);
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          c += __shfl_xor_sync(0xffffffffu, c, d);
          c2 += __shfl_xor_sync(0xffffffffu, c2, d);
        }
        lo = c > 0 ? (long long)(c - 1) * stride + 1 : 0;
        hi = c2 < ns ? (long long)c2 * stride : W;
        hi = hi < live[warp] ? hi : live[warp];
        hi = hi > lo ? hi : lo;
      }
      if (lane == 0) {
        win_lo[warp] = lo;
        win_hi[warp] = hi;
      }
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) below += win_lo[j];
    // the windows too large to stage: each live key's count there from the
    // samples, then halving in device memory within a stride
    for (int j = 0; j < m; ++j) {
      const long long lo_j = win_lo[j];
      if (win_hi[j] - lo_j <= DM_BIG) continue;
      const bool upper = j < jr;
      const long long* run = src + (g0 + j) * W;
      const long long hi_j = live[j];
      for (int t = tid; t < chunk_live; t += DM_THREADS) {
        const long long x = keys[dm_pad(t)];
        int c = 0;  // the samples before x: a prefix
        for (int half = ns >> 1; half > 0; half >>= 1) {
          if (dm_before(samples[j][c + half - 1], x, upper)) c += half;
        }
        if (dm_before(samples[j][c], x, upper)) ++c;
        long long a = c > 0 ? (long long)(c - 1) * stride + 1 : 0;
        long long b = c < ns ? (long long)c * stride : hi_j;
        b = b < hi_j ? b : hi_j;
        while (a < b) {
          const long long mid = (a + b) >> 1;
          if (dm_before(__ldg(run + mid), x, upper)) {
            a = mid + 1;
          } else {
            b = mid;
          }
        }
        if (a > lo_j) atomicAdd(&counts[dm_pad(t)], (int)(a - lo_j));
      }
    }
    __syncthreads();  // win_lo becomes each staged window's next unstaged key
    for (;;) {
      if (tid == 0) {
        int used = 0, work = 0;
        for (int j = 0; j < m; ++j) {
          const long long left = win_hi[j] - win_lo[j];
          const int take = left > DM_BIG ? 0 : (int)(left < DM_STAGE - used ? left
                                                                              : DM_STAGE - used);
          seg_off[j] = used;
          seg_len[j] = take;
          seg_at[j] = win_lo[j];
          win_lo[j] += take;
          used += take;
          work += take > 0 ? chunk_live + take : 0;
        }
        staged = used;
        // each staged segment's share of the threads, as its merge's length
        // (at least one each: the shares add up to DM_THREADS at most)
        int at = 0;
        for (int j = 0; j < m; ++j) {
          first[j] = at;
          if (seg_len[j] > 0) {
            at += 1 + (int)((long long)(DM_THREADS - DM_FAN_MAX) * (chunk_live + seg_len[j]) /
                            work);
          }
        }
        first[m] = at;
      }
      __syncthreads();
      if (staged == 0) break;
      for (int j = 0; j < m; ++j) {
        const long long* from = src + (g0 + j) * W + seg_at[j];
        const int off = seg_off[j];
        for (int t = tid; t < seg_len[j]; t += DM_THREADS) {
          __pipeline_memcpy_async(dm_stage + dm_pad(off + t), from + t, sizeof(long long));
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      // each staged segment merged with the chunk's live keys by its
      // threads, a span of the merge each (merge path): a key taken after
      // jj keys of the segment counts jj of them
      int j = 0;
      while (j < m && first[j + 1] <= tid) ++j;
      if (j < m && seg_len[j] > 0) {
        const int per = first[j + 1] - first[j];
        const int off = seg_off[j];  // segment key t at dm_stage[dm_pad(off + t)]
        const int L = seg_len[j], total = chunk_live + L;
        const bool upper = j < jr;
        const int span = (total + per - 1) / per;
        const int d = (tid - first[j]) * span, d_end = d + span < total ? d + span : total;
        if (d < d_end) {
          int lo = d - L > 0 ? d - L : 0, hi = d < chunk_live ? d : chunk_live;
          while (lo < hi) {  // the chunk's keys among the merge's first d
            const int mid = (lo + hi) >> 1;
            if (!dm_before(dm_stage[dm_pad(off + d - 1 - mid)], keys[dm_pad(mid)], upper)) {
              lo = mid + 1;
            } else {
              hi = mid;
            }
          }
          int i = lo, jj = d - lo;
          long long a = i < chunk_live ? keys[dm_pad(i)] : 0;
          long long b = jj < L ? dm_stage[dm_pad(off + jj)] : 0;
          while (i + jj < d_end) {
            if (i < chunk_live && (jj == L || !dm_before(b, a, upper))) {
              if (jj > 0) atomicAdd(&counts[dm_pad(i)], jj);
              ++i;
              a = i < chunk_live ? keys[dm_pad(i)] : 0;
            } else {
              ++jj;
              b = jj < L ? dm_stage[dm_pad(off + jj)] : 0;
            }
          }
        }
      }
      __syncthreads();
    }
  }
  long long* out = dst + g0 * W;
  for (int t = tid; t < DM_CHUNK; t += DM_THREADS) {
    const long long i = i0 + t;
    out[i < live_r ? i + below + counts[dm_pad(t)] : all_live + sent_before + (i - live_r)] =
        keys[dm_pad(t)];
  }
}

// ---------------------------------------------------------------------------
// dict_compact: the first cap distinct keys of the sorted keys, one pass
// ---------------------------------------------------------------------------

// dict_compact's scratch, int64 words that are zero before a launch and that
// the launch leaves zero: [0] the tile ticket, [1] the blocks done, then a
// status word a tile: the distinct keys of the tile alone (DC_AGGREGATE) or
// of it and every tile before it (DC_INCLUSIVE) in the low 62 bits, which of
// the two in the top two bits (0: not yet published).
#define DC_AGGREGATE (1ULL << 62)
#define DC_INCLUSIVE (2ULL << 62)
#define DC_COUNT_MASK (DC_AGGREGATE - 1)

__device__ __forceinline__ void dc_publish(unsigned long long* at, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(at), "l"(v) : "memory");
}

// A status word, read relaxed so that a window's reads are all in flight at
// once; the window's fence (dc_acquire) orders them as acquires.
__device__ __forceinline__ unsigned long long dc_status(const unsigned long long* at) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(at) : "memory");
  return v;
}

__device__ __forceinline__ void dc_acquire() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

// The blocks done before this one (an acquire-release add of one).
__device__ __forceinline__ unsigned long long dc_finish(unsigned long long* at) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;"
               : "=l"(old)
               : "l"(at), "l"(1ULL)
               : "memory");
  return old;
}

// out[0..cap): the first cap distinct non-sentinel keys of the sorted
// s[0..n) in order, padded with the sentinel; DK_FLAG_CAPACITY ORed into
// *flag when there are more.  One launch: a block takes the next tile of
// DC_TILE keys from a ticket (so that every tile it waits on belongs to a
// block that has started, whatever order the card runs blocks in), loads it
// in DC_ROWS rows of 16 bytes a thread (thread t keys 2t and 2t + 1 of a
// row, lane 0 also the key before its warp's first key of the row), counts
// each (row, warp) segment's distinct keys by one warp scan of the four
// rows' counts packed in bytes, the segments' offsets by a scan in warp 0,
// which publishes the tile's count (release), then looks back over the
// tiles before it 128 at a time (DC_LOOK a lane, all in flight, then an
// acquire fence) and publishes its inclusive count.
// A tile whose offset is already past cap writes no key; the one that
// crosses cap raises the flag; the last tile writes the padding; the last
// block to finish zeroes the scratch again.
__global__ void __launch_bounds__(DC_THREADS)
dict_compact(const long long* __restrict__ s, long long n, long long* __restrict__ out, int* flag,
             int cap, unsigned long long* __restrict__ scratch) {
  constexpr unsigned FULL = 0xFFFFFFFFu;
  __shared__ int seg[DC_ROWS * DC_WARPS];  // a segment's distinct keys, then its offset
  __shared__ long long tile_at, before, distinct;
  __shared__ bool last;
  unsigned long long* const status = scratch + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_at = (long long)atomicAdd(scratch, 1ULL);
  __syncthreads();
  const long long tile = tile_at, tiles = gridDim.x;
  long long v0[DC_ROWS], v1[DC_ROWS], halo[DC_ROWS];
#pragma unroll
  for (int e = 0; e < DC_ROWS; ++e) {
    const long long at = tile * DC_TILE + e * 2 * DC_THREADS + 2 * tid;
    if (at + 1 < n) {
      const longlong2 q = __ldg((const longlong2*)(s + at));
      v0[e] = q.x;
      v1[e] = q.y;
    } else {
      v0[e] = at < n ? __ldg(s + at) : DK_SENTINEL;
      v1[e] = DK_SENTINEL;
    }
    // the sentinel before key 0: a key that no live key equals
    halo[e] = lane == 0 && at > 0 && at <= n ? __ldg(s + at - 1) : DK_SENTINEL;
  }
  // bits 2e and 2e + 1: the thread's two keys of row e start distinct keys;
  // byte e: how many do
  unsigned fresh = 0, mine = 0;
#pragma unroll
  for (int e = 0; e < DC_ROWS; ++e) {
    const long long up = __shfl_up_sync(FULL, v1[e], 1);
    const long long prev = lane > 0 ? up : halo[e];
    const unsigned f0 = v0[e] < DK_SENTINEL && v0[e] != prev;
    const unsigned f1 = v1[e] < DK_SENTINEL && v1[e] != v0[e];
    fresh |= (f0 | f1 << 1) << (2 * e);
    mine |= (f0 + f1) << (8 * e);
  }
  unsigned incl = mine;  // a segment counts at most 64 keys: no byte carries
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) {
#pragma unroll
    for (int e = 0; e < DC_ROWS; ++e) seg[e * DC_WARPS + warp] = (incl >> (8 * e)) & 0xFF;
  }
  __syncthreads();
  if (warp == 0) {
    static_assert(DC_ROWS * DC_WARPS == 32, "a lane a segment");
    const int c = seg[lane];  // segments in tile order: row, then warp
    int x = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += y;
    }
    seg[lane] = x - c;
    const long long count = __shfl_sync(FULL, x, 31);
    if (lane == 0) dc_publish(status + tile, (tile == 0 ? DC_INCLUSIVE : DC_AGGREGATE) | count);
    long long prefix = 0;
    if (tile > 0) {
      // windows of 32 * DC_LOOK tiles, nearest first: entry 32q + lane is
      // tile top - 32q - lane
      for (long long top = tile - 1;; top -= 32 * DC_LOOK) {
        unsigned long long st[DC_LOOK];
#pragma unroll
        for (int q = 0; q < DC_LOOK; ++q) {
          const long long t = top - 32 * q - lane;
          st[q] = t >= 0 ? dc_status(status + t) : DC_INCLUSIVE;  // before tile 0: nothing
        }
#pragma unroll
        for (int q = 0; q < DC_LOOK; ++q) {
          while (st[q] < DC_AGGREGATE) st[q] = dc_status(status + (top - 32 * q - lane));
        }
        dc_acquire();
        int stop = 32 * DC_LOOK;  // the nearest inclusive entry
#pragma unroll
        for (int q = DC_LOOK - 1; q >= 0; --q) {
          const unsigned b = __ballot_sync(FULL, st[q] >= DC_INCLUSIVE);
          if (b != 0) stop = 32 * q + __ffs(b) - 1;
        }
        long long add = 0;
#pragma unroll
        for (int q = 0; q < DC_LOOK; ++q) {
          add += 32 * q + lane <= stop ? (long long)(st[q] & DC_COUNT_MASK) : 0;
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) add += __shfl_xor_sync(FULL, add, d);
        prefix += add;
        if (stop < 32 * DC_LOOK) break;
      }
      if (lane == 0) dc_publish(status + tile, DC_INCLUSIVE | (prefix + count));
    }
    if (lane == 0) {
      if (prefix <= cap && prefix + count > cap) atomicOr(flag, DK_FLAG_CAPACITY);
      before = prefix;
      distinct = prefix + count;
      last = dc_finish(scratch + 1) == (unsigned long long)(tiles - 1);
    }
  }
  __syncthreads();
  const long long b = before;
  if (b < cap) {
    const unsigned excl = incl - mine;
#pragma unroll
    for (int e = 0; e < DC_ROWS; ++e) {
      long long r = b + seg[e * DC_WARPS + warp] + ((excl >> (8 * e)) & 0xFF);
      if ((fresh >> (2 * e)) & 1) {
        if (r < cap) out[r] = v0[e];
        ++r;
      }
      if (((fresh >> (2 * e + 1)) & 1) && r < cap) out[r] = v1[e];
    }
  }
  if (tile == tiles - 1 && distinct < cap) {  // the padding, 16 bytes a store
    long long r0 = distinct;
    if (((unsigned long long)(out + r0) & 15) != 0) {  // up to a 16-byte boundary
      if (tid == 0) out[r0] = DK_SENTINEL;
      ++r0;
    }
    const longlong2 pad = {DK_SENTINEL, DK_SENTINEL};
    for (long long r = r0 + 2 * tid; r + 1 < cap; r += 2 * DC_THREADS) *(longlong2*)(out + r) = pad;
    if (r0 < cap && ((cap - r0) & 1) && tid == 0) out[cap - 1] = DK_SENTINEL;
  }
  if (last) {  // every block has read every status word it needs
    for (long long t = tid; t < tiles; t += DC_THREADS) status[t] = 0;
    if (tid == 0) {
      scratch[0] = 0;
      scratch[1] = 0;
    }
  }
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
// dk_launch runs the instance that holds the plan's stack, picked from its
// code (cudaErrorInvalidValue past FA_MAX_STACK), over a grid of the blocks
// the card holds at once, or fewer when the image has fewer tiles.
int dk_launch(const DkParams* p, void* stream) {
  const int slots = fa_stack_slots(*p);
  const DkKernel k = dk_kernel(slots);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const long long tiles = p->n_blocks * ((p->block_rows + DK_ROWS - 1) / DK_ROWS);
  if (tiles == 0) return 0;
  // the blocks the card holds at once, asked once a device and instance (a
  // mesh request launches dict_keys 80 times)
  static int full_grid[64][3] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int full = dev < 64 ? full_grid[dev][slots / 4] : 0;
  if (full == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)k, DK_THREADS, 0);
    }
    if (err != cudaSuccess) return (int)err;
    full = (per_sm > 0 ? per_sm : 1) * sms;
    if (dev < 64) full_grid[dev][slots / 4] = full;
  }
  long long grid = (tiles + DK_THREADS - 1) / DK_THREADS;
  if (grid > full) grid = full;
  void* args[] = {(void*)p};
  err = cudaLaunchKernel((const void*)k, dim3((unsigned)grid), dim3(DK_THREADS), args, 0,
                         (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The stack slots of the instance dk_launch runs for the plan (0: none, past
// FA_MAX_STACK).
int dk_slots(const DkParams* p) { return fa_stack_slots(*p); }

// cudaFuncGetAttributes of the dict_keys instance of `slots` stack slots:
// registers a thread, local and static shared bytes, into out[0..3).
int dk_attributes(int slots, int* out) {
  const DkKernel k = dk_kernel(slots);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)k);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

int dk_rows(void) { return DK_ROWS; }

// The shared memory of a dict_union block for a tile of T keys.
static int du_smem_bytes(int T) {
  return (T <= DU_PINGPONG_MAX ? 2 : 1) * (T + T / DU_E) * 8;
}

// One pass: ceil((n_dict + n_keys) / T) tiles, out [tiles][cap].
int du_launch(const long long* dict, long long n_dict, const long long* keys, long long n_keys,
              long long* out, int* flag, int cap, int T, int* tile_live, void* stream) {
  if (T < DU_WARP_KEYS || T > DU_TILE_MAX || (T & (T - 1)) != 0 || cap > T) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = n_dict + n_keys;
  const long long tiles = n > 0 ? (n + T - 1) / T : 1;
  const int smem = du_smem_bytes(T);
  const int err = (int)cudaFuncSetAttribute(dict_union,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  dict_union<<<(unsigned)tiles, T / DU_E, smem, (cudaStream_t)stream>>>(
      dict, n_dict, keys, n_keys, out, flag, cap, T, tile_live);
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

// One merge level over n keys in runs of W, F runs into one; tile_live: the
// tile sort's live keys a tile.
int dm_launch(const long long* src, long long n, long long W, int F, const int* tile_live,
              long long* dst, void* stream) {
  if (n == 0) return 0;
  if (n % DM_TILE != 0 || W % DM_TILE != 0 || F < 2 || F > DM_FAN_MAX || tile_live == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = dm_pad(DM_STAGE) * 8;
  static unsigned long long smem_set = 0;  // the attribute once a device
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev >= 64 || !((smem_set >> dev) & 1)) {
    err = (int)cudaFuncSetAttribute(dict_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != 0) return err;
    if (dev < 64) smem_set |= 1ULL << dev;
  }
  dict_merge<<<(unsigned)(n / DM_CHUNK), DM_THREADS, smem, (cudaStream_t)stream>>>(
      src, n, W, F, tile_live, dst);
  return (int)cudaGetLastError();
}

// cudaFuncGetAttributes of dict_merge: registers a thread, local and static
// shared bytes, into out[0..3).
int dm_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)dict_merge);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

int dm_chunk(void) { return DM_CHUNK; }
int dm_fan_max(void) { return DM_FAN_MAX; }

// One block a tile of DC_TILE keys (at least one: the padding is still
// written); scratch: 2 + tiles int64 words, zero before, left zero.
int dc_launch_compact(const long long* s, long long n, long long* out, int* flag, int cap,
                      unsigned long long* scratch, void* stream) {
  if (((unsigned long long)s & 15) != 0 || n < 0 || cap < 1) return (int)cudaErrorInvalidValue;
  long long tiles = (n + DC_TILE - 1) / DC_TILE;
  if (tiles == 0) tiles = 1;
  dict_compact<<<(unsigned)tiles, DC_THREADS, 0, (cudaStream_t)stream>>>(s, n, out, flag, cap,
                                                                       scratch);
  return (int)cudaGetLastError();
}

// cudaFuncGetAttributes of dict_compact: registers a thread, local and static
// shared bytes, into out[0..3).
int dc_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)dict_compact);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

int dc_tile(void) { return DC_TILE; }
int di_smem_keys(void) { return DI_SMEM_KEYS; }

}  // extern "C"
