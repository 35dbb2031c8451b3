// Probe kernels of the coprocessor's device equi-join rung.
//
// Replaces these JAX programs of the reference package (tikv_tpu/copr):
//   * jax_join.py:_rank_probe (site jax_join.rank): per probe code, the
//     searchsorted left and right over the stable-sorted build codes;
//   * jax_join.py:_hash_probe (site jax_join.hash): per probe key, a
//     Fibonacci hash into a power-of-two open-addressing table and a linear
//     probe to the key or an empty slot.
// Both give each probe row a (start, count) span into the one stable-sorted
// build order; the host expands the spans into row pairs
// (copr/torch_join.py).
//
// join_rank_probe: one thread per probe row, grid-stride.  A lower-bound
// binary search over the m sorted int64 build keys (signed compares), then the
// upper bound by galloping from there: start = lo, count = hi - lo.  A miss
// code (-1, below every build code) spans no row.
// join_hash_probe: one thread per probe row, grid-stride.  slot = (key as
// unsigned 64-bit * 0x9E3779B97F4A7C15) >> (64 - log2 size), then
// slot = (slot + 1) & (size - 1) until the slot holds the key or is empty
// (INT64_MIN).  The host builds the table at load <= 0.5
// (torch_join._build_hash_table), so every walk ends.  A probe equal to the
// empty sentinel (a NULL or unmapped key) matches nothing: (0, 0).
//
// What bounds them on an H100: latency, not bytes.  Each row reads 8 bytes
// and writes 16, but a rank search makes about log2(m) + 1 dependent loads
// scattered over the build keys (the first levels, shared by every row, stay
// in L1/L2; the gallop reads the lines the search ended on), and a hash probe
// one to a few scattered loads per row.  No atomics, no floats:
// reruns are bit-identical.  What the design does not do yet: a
// shared-memory or warp-cooperative search, a cache-resident table.
//
// Row counts are long long, so no 64-bit size is cut to 32 bits.

#include <cuda_runtime.h>

#define JN_THREADS 256
#define JN_EMPTY (-9223372036854775807LL - 1LL)
#define JN_MULT 0x9E3779B97F4A7C15ULL

__global__ void join_rank_probe(const long long* __restrict__ keys, long long m,
                                const long long* __restrict__ probe, long long n,
                                long long* __restrict__ starts, long long* __restrict__ counts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long k = probe[i];
    long long lo = 0, hi = m;
    while (lo < hi) {  // first position whose key is >= k
      const long long mid = lo + ((hi - lo) >> 1);
      if (keys[mid] < k) lo = mid + 1; else hi = mid;
    }
    const long long first = lo;
    // first position whose key is > k: gallop from `first` (a key's rows
    // are few, and their keys share the cache lines the search just read),
    // then bisect the last step.  A search over [first, m) would touch a
    // midpoint no other row touches at every level.
    long long step = 1;
    hi = first;
    while (hi < m && keys[hi] <= k) {
      lo = hi + 1;
      hi = lo + step;
      step <<= 1;
    }
    if (hi > m) hi = m;
    while (lo < hi) {
      const long long mid = lo + ((hi - lo) >> 1);
      if (keys[mid] <= k) lo = mid + 1; else hi = mid;
    }
    starts[i] = first;
    counts[i] = lo - first;
  }
}

__global__ void join_hash_probe(const long long* __restrict__ table_keys,
                                const long long* __restrict__ table_starts,
                                const long long* __restrict__ table_counts, int log2_size,
                                const long long* __restrict__ probe, long long n,
                                long long* __restrict__ starts, long long* __restrict__ counts) {
  const unsigned long long mask = (1ULL << log2_size) - 1ULL;
  const int shift = 64 - log2_size;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long k = probe[i];
    long long s = 0, c = 0;
    if (k != JN_EMPTY) {
      unsigned long long slot = ((unsigned long long)k * JN_MULT) >> shift;
      for (;;) {
        const long long t = table_keys[slot];
        if (t == k) {
          s = table_starts[slot];
          c = table_counts[slot];
          break;
        }
        if (t == JN_EMPTY) break;
        slot = (slot + 1ULL) & mask;
      }
    }
    starts[i] = s;
    counts[i] = c;
  }
}

extern "C" {

int jn_threads(void) { return JN_THREADS; }

// Each returns cudaGetLastError() right after its launch.
int jn_launch_rank(const long long* keys, long long m, const long long* probe, long long n,
                   long long* starts, long long* counts, int grid, void* stream) {
  if (n <= 0) return 0;
  join_rank_probe<<<grid, JN_THREADS, 0, (cudaStream_t)stream>>>(keys, m, probe, n, starts,
                                                                  counts);
  return (int)cudaGetLastError();
}

int jn_launch_hash(const long long* table_keys, const long long* table_starts,
                   const long long* table_counts, int log2_size, const long long* probe,
                   long long n, long long* starts, long long* counts, int grid, void* stream) {
  if (n <= 0) return 0;
  if (log2_size < 1 || log2_size > 62) return (int)cudaErrorInvalidValue;
  join_hash_probe<<<grid, JN_THREADS, 0, (cudaStream_t)stream>>>(
      table_keys, table_starts, table_counts, log2_size, probe, n, starts, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
