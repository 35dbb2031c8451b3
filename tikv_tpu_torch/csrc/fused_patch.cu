// The in-place patch of a pinned stacked image: the region write path's
// device work.
//
// Replaces the eager scatters of the reference package's write-through
// deltas (tikv_tpu/copr/cache.py): ColumnBlockCache.scatter_update through
// _patch_stacked, `data[j].at[bi, pos].set(vals)` over each shipped column's
// (B, rows) pin and `nulls[j].at[bi, pos].set(nl)` over each null mask.
// After a committed write changes rows of a region in place, the host blocks
// already hold the new values (copr/region_cache.py:_apply_updates); this
// kernel writes the same values into the pin on the card, so the image is
// not stacked and uploaded again.
//
// patch_stacked: one launch patches one pin.  A small descriptor lists the
// pin's data lanes (8-byte words: int64, or f64 bits) and null lanes (one
// byte a row), at most FP_MAX_LANES each.  The updates are U flat positions
// `block * block_rows + row`, with a row of U words (data) or U bytes
// (nulls) per lane.  One thread per (lane, update), grid-stride: thread t
// takes lane t / U and update t % U and stores one word or byte.
// The host checks that the positions are unique (a delta's handles are), so
// no two threads store to one address and no order is needed; the result
// is bit-identical to the plain version (index_put_ per lane) from run to
// run.
//
// What bounds it on an H100: memory latency, not bytes.  It reads 8 bytes
// of position and one word or byte of value per (lane, update) and stores
// one word or byte at a scattered address (a 32-byte sector per store):
// at 10,000 updates a few hundred KB at most, so launch latency dominates.
//
// Counts and positions are long long, so no 64-bit size is cut to 32 bits.

#include <cuda_runtime.h>

#define FP_THREADS 256
#define FP_MAX_LANES 16

struct PatchDesc {
  long long* data[FP_MAX_LANES];
  unsigned char* nulls[FP_MAX_LANES];
  int n_data;
  int n_nulls;
};

__global__ void patch_stacked(PatchDesc d, const long long* __restrict__ pos, long long n_upd,
                              const long long* __restrict__ vals,
                              const unsigned char* __restrict__ nls) {
  const long long total = n_upd * (long long)(d.n_data + d.n_nulls);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const int lane = (int)(t / n_upd);
    const long long u = t - (long long)lane * n_upd;
    const long long p = pos[u];
    if (lane < d.n_data) {
      d.data[lane][p] = vals[(long long)lane * n_upd + u];
    } else {
      const int j = lane - d.n_data;
      d.nulls[j][p] = nls[(long long)j * n_upd + u];
    }
  }
}

extern "C" {

int fp_threads(void) { return FP_THREADS; }

int fp_max_lanes(void) { return FP_MAX_LANES; }

// data_ptrs / null_ptrs: host arrays of n_data / n_nulls device pointers.
// Returns cudaGetLastError() right after the launch.
int fp_launch(const unsigned long long* data_ptrs, int n_data,
              const unsigned long long* null_ptrs, int n_nulls, const long long* pos,
              long long n_upd, const long long* vals, const unsigned char* nls, int grid,
              void* stream) {
  if (n_data < 0 || n_data > FP_MAX_LANES || n_nulls < 0 || n_nulls > FP_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  if (n_upd <= 0 || n_data + n_nulls == 0) return 0;
  PatchDesc d;
  for (int j = 0; j < FP_MAX_LANES; ++j) {
    d.data[j] = j < n_data ? (long long*)data_ptrs[j] : nullptr;
    d.nulls[j] = j < n_nulls ? (unsigned char*)null_ptrs[j] : nullptr;
  }
  d.n_data = n_data;
  d.n_nulls = n_nulls;
  patch_stacked<<<grid, FP_THREADS, 0, (cudaStream_t)stream>>>(d, pos, n_upd, vals, nls);
  return (int)cudaGetLastError();
}

}  // extern "C"
