// Batched grouped aggregation kernels of the coprocessor's device path.
//
// Replaces these JAX programs of the reference package (tikv_tpu/copr):
//   * jax_eval.py:run_batch_cached (site jax_eval.fused_batch): K aggregation
//     plans over one cached region image, each plan's _fused_step folded
//     over every block with its group ids from the dictionary codes
//     (_mixed_radix_gids), every state packed into one int64 and one f64
//     matrix for one pull;
//   * jax_eval.py:launch_xregion_cached (site jax_eval.xregion): one plan
//     over R region images, vmapped over the regions, with per-region
//     dictionary radices and frames of reference as inputs, packed per
//     region.
// Both are a table of tasks here, one (plan, image) pair each: K tasks over
// one image, or R tasks of one plan.  A task's descriptor (BtTask: its
// columns and their load descriptors, n_valid and offset vectors, bytecode,
// constants, leaf tables, dictionary radices, capacity, and where its CTAs
// and partials lie) is an entry of a table in device memory, filled by the
// wrapper per batch: 64 tasks of 16 columns would not fit the 4 KB
// parameter block.
//
// batch_partials: a grid of CTAs, each task owning a contiguous run of
// them (its share of the grid by rows).  A CTA finds its task by binary
// search over the table, copies the descriptor into shared memory (the walk
// then reads the code and constants from there, broadcast to the warp), and
// runs fused_group_agg_partials' shared-rows body over the task's rows: the
// bytecode walk of fa_walk.cuh, the mixed-radix group id from the key
// codes (loaded through fa_load, program #1), per-warp shared-memory rows
// folded lane by lane in lane order, then the warps in order, into one row
// of partials per CTA, [n_ctas, n_leaves, C] int64 words per task.
// batch_combine_pack: one warp per word of the packed output [T, li + lf,
// c_max]; its lanes fold the task's partial rows q = lane, lane + 32, ... in
// order, then a fixed shuffle tree, and lane 0 writes the leaf's value (the
// tracker and first's row as global rows; first's value from the walk
// again at the winning row), or 0 where the word pads a smaller task.
//
// Determinism: the grid and each task's CTAs depend on the shapes alone,
// and every fold runs in a fixed order with no float atomics, so f64 leaves
// are bit-identical from run to run.  Integer leaves are exact (unsigned
// arithmetic, wrapping as int64).
//
// What bounds it on an H100: memory, as the grouped kernel: the image's
// shipped lanes read once.  The kernel reads them once per task (a
// same-region batch of K plans reads its image K times, each task walking
// every shipped column), and the walk in local memory, not HBM, holds each
// pass at ten times or more of its bound.  A single pass (each row loaded
// once, K walks) is later work.  A task with more group slots than the
// shared-memory rows hold (SMEM_MAX of copr/fused_batch.py) has no entry in
// the table: the wrapper serves it by the grouped pair's wide route
// (fused_agg.cu, group_wide_partials) and copies its state into its rows of
// the output, which each entry names (out_task).
//
// Layout contract with tikv_tpu_torch/copr/fused_batch.py (the wrapper
// checks sizeof(BtTask) and the shared-memory limit at load).

#include "fa_walk.cuh"
#include "ga_leaf.cuh"

#define BT_THREADS 256
#define BT_WARPS (BT_THREADS / 32)

struct BtTask {
  const void* col[FA_MAX_COLS];            // payloads: [n_blocks, block_rows] lanes (rle: run values)
  const unsigned char* nul[FA_MAX_COLS];   // bool null masks, or null for NOT NULL columns
  FaEnc enc;                               // how each column loads (program #1)
  const long long* n_valids;               // [n_blocks], zone-pruned blocks 0
  const long long* offsets;                // [n_blocks] global row of each block's row 0
  long long n_blocks;
  long long block_rows;
  long long part0;                         // the task's partials start here (int64 words)
  long long consts[FA_MAX_CONSTS];
  long long leaf_ident[GA_MAX_LEAVES];     // identity of each leaf, raw 64-bit word
  int code[FA_MAX_CODE];
  int n_code;
  int n_cols;
  int n_aggs;
  int n_leaves;
  int capacity;                            // C: the task's group slots
  int track;                               // leaf 0 tracks the first active row (GROUP BY)
  int n_keys;                              // key columns (0: every row in slot 0)
  int cta0;                                // the task's first CTA of batch_partials
  int n_ctas;                              // and its count
  int out_task;                            // the task's row of the packed output
  int key_slot[GA_MAX_KEYS];               // column slot of each key's dictionary codes
  int key_dlen[GA_MAX_KEYS];               // its dictionary's length; NULL is code dlen
  int agg_leaf0[FA_MAX_AGGS];              // first leaf of aggregate k
  int agg_nleaves[FA_MAX_AGGS];
  signed char leaf_kind[GA_MAX_LEAVES];
  signed char leaf_f64[GA_MAX_LEAVES];      // the leaf is stored as f64
  signed char leaf_arg_f64[GA_MAX_LEAVES];  // its aggregate's argument lane is f64
  signed char leaf_slot[GA_MAX_LEAVES];     // row in the packed int64 or f64 matrix
  signed char leaf_agg[GA_MAX_LEAVES];      // aggregate of the leaf, -1 for the tracker
  signed char leaf_aux[GA_MAX_LEAVES];      // GA_FIRSTVAL: index of its GA_FIRSTROW leaf
};

static_assert(sizeof(BtTask) % 8 == 0, "a CTA copies its descriptor in 64-bit words");

// The descriptor lives in static shared memory beside the dynamic rows.
#define BT_SMEM_MAX (GA_SMEM_MAX - (int)sizeof(BtTask))

// Partials of every task: CTA q of task t writes [n_leaves, C] words at
// part0 + q * n_leaves * C.  Dynamic shared memory: BT_WARPS * n_leaves *
// (32 + C) * 8 bytes for the largest task.
__global__ void __launch_bounds__(BT_THREADS)
batch_partials(const BtTask* __restrict__ tasks, int n_tasks, long long* __restrict__ parts) {
  __shared__ BtTask task;
  extern __shared__ long long bt_smem[];
  // the task of this CTA: the last whose first CTA is at or before it
  int lo = 0, hi = n_tasks - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tasks[mid].cta0 <= (int)blockIdx.x) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  {
    const long long* src = reinterpret_cast<const long long*>(tasks + lo);
    long long* dst = reinterpret_cast<long long*>(&task);
    for (int w = threadIdx.x; w < (int)(sizeof(BtTask) / 8); w += BT_THREADS) dst[w] = src[w];
  }
  __syncthreads();
  const BtTask& p = task;
  const int L = p.n_leaves;
  const int C = p.capacity;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long* stage = bt_smem + (long long)warp * L * 32;  // [L][32]: this step's contributions
  long long* wrows = bt_smem + (long long)BT_WARPS * L * 32;  // [BT_WARPS][L][C]
  long long* mine = wrows + (long long)warp * L * C;
  for (long long idx = threadIdx.x; idx < (long long)BT_WARPS * L * C; idx += BT_THREADS) {
    wrows[idx] = p.leaf_ident[(idx / C) % L];
  }
  __syncthreads();

  const long long rows = p.block_rows;
  const long long total = p.n_blocks * rows;
  const long long stride = (long long)p.n_ctas * BT_THREADS;
  // every lane of a warp runs the same number of steps (the loop is on the
  // warp's first row), so the warp-wide operations below see all 32 lanes
  long long base = (long long)(blockIdx.x - p.cta0) * BT_THREADS + warp * 32;
  long long f = base + lane;
  long long blk = rows > 0 ? f / rows : 0;
  long long i = f - blk * rows;
  const long long step_b = rows > 0 ? stride / rows : 0;
  const long long step_i = stride - step_b * rows;

  for (; base < total; base += stride, f += stride) {
    bool active = false;
    int gid = -1;
    if (f < total && i < __ldg(p.n_valids + blk)) {
      active = fa_walk(p, f, blk, i, [&](int k, bool live, long long value) {
        const int l0 = p.agg_leaf0[k];
        for (int l = l0; l < l0 + p.agg_nleaves[k]; ++l) {
          stage[l * 32 + lane] = ga_contrib(p, l, live, value, f);
        }
      });
      if (active) {
        // mixed radix over the key columns' codes (jax_eval._mixed_radix_gids)
        long long g = 0;
        for (int q = 0; q < p.n_keys; ++q) {
          const long long dlen = p.key_dlen[q];
          bool nul;
          const long long code = fa_load(p, p.key_slot[q], f, blk, i, nul);
          g = g * (dlen + 1) + (nul ? dlen : code);
        }
        // a row whose id is outside the slots touches none, as XLA drops
        // out-of-range scatter updates
        gid = (g >= 0 && g < C) ? (int)g : -1;
        active = gid >= 0;
        stage[lane] = p.track ? f : FA_NO_ROW;
      }
    }
    const unsigned same = __match_any_sync(0xFFFFFFFFu, active ? gid : -1);
    __syncwarp();
    if (active && lane == __ffs(same) - 1) {
      for (int l = 0; l < L; ++l) {
        const int kind = p.leaf_kind[l];
        if (kind == GA_FIRSTVAL) continue;
        const bool is_f = p.leaf_f64[l];
        long long acc = mine[(long long)l * C + gid];
        for (unsigned m = same; m != 0; m &= m - 1) {
          acc = ga_merge(kind, is_f, acc, stage[l * 32 + __ffs(m) - 1]);
        }
        mine[(long long)l * C + gid] = acc;
      }
    }
    __syncwarp();
    blk += step_b;
    i += step_i;
    if (i >= rows) {
      i -= rows;
      ++blk;
    }
  }

  __syncthreads();
  long long* part = parts + p.part0 + (long long)(blockIdx.x - p.cta0) * L * C;
  for (long long idx = threadIdx.x; idx < (long long)L * C; idx += BT_THREADS) {
    const int l = (int)(idx / C);
    const int kind = p.leaf_kind[l];
    const bool is_f = p.leaf_f64[l];
    long long acc = wrows[idx];
    for (int w = 1; w < BT_WARPS; ++w) acc = ga_merge(kind, is_f, acc, wrows[(long long)w * L * C + idx]);
    part[idx] = acc;
  }
}

// The packed output: out_i [T, li, c_out] int64 and out_f [T, lf, c_out]
// f64, each table entry's rows at its out_task, one warp per word of its
// first c_grid slots (the int rows first, then the f64 rows, of each entry
// in turn); words past c_grid are the caller's zeros.
__global__ void __launch_bounds__(BT_THREADS)
batch_combine_pack(const BtTask* __restrict__ tasks, int n_tasks,
                   const long long* __restrict__ parts, int li, int lf, int c_grid, int c_out,
                   long long* __restrict__ out_i, double* __restrict__ out_f) {
  const long long w = ((long long)blockIdx.x * BT_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long per_task = (long long)(li + lf) * c_grid;
  if (w >= (long long)n_tasks * per_task) return;  // the whole warp leaves together
  const int t = (int)(w / per_task);
  const int row = (int)((w - t * per_task) / c_grid);
  const int g = (int)(w - t * per_task - (long long)row * c_grid);
  const bool in_f = row >= li;
  const int slot = in_f ? row - li : row;
  const BtTask& p = tasks[t];
  // the leaf stored at this word; -1 for padding (the same for the warp)
  int l = -1;
  if (g < p.capacity) {
    for (int k = 0; k < p.n_leaves; ++k) {
      if ((p.leaf_f64[k] != 0) == in_f && p.leaf_slot[k] == slot) {
        l = k;
        break;
      }
    }
  }
  long long res = 0;
  if (l >= 0) {
    // first's value folds its row leaf: the winning row
    const int kind = p.leaf_kind[l];
    const int fl = kind == GA_FIRSTVAL ? p.leaf_aux[l] : l;
    const int fkind = p.leaf_kind[fl];
    const bool is_f = p.leaf_f64[fl];
    const long long L = p.n_leaves, C = p.capacity;
    const long long* src = parts + p.part0 + fl * C + g;
    long long acc = p.leaf_ident[fl];
    for (int q = lane; q < p.n_ctas; q += 32) acc = ga_merge(fkind, is_f, acc, src[q * L * C]);
    for (int off = 16; off > 0; off >>= 1) {
      acc = ga_merge(fkind, is_f, acc, __shfl_down_sync(0xFFFFFFFFu, acc, off));
    }
    if (lane == 0) {
      if (kind == GA_FIRSTVAL) {
        res = p.leaf_ident[l];
        if (acc < FA_NO_ROW) {
          const int want = p.leaf_agg[l];
          const long long b = acc / p.block_rows;
          fa_walk(p, acc, b, acc - b * p.block_rows, [&](int k, bool, long long value) {
            if (k == want) res = value;
          });
        }
      } else if (kind == GA_TRACK || kind == GA_FIRSTROW) {
        // the flat row index as a global row: its block's offset plus the row
        if (acc < FA_NO_ROW) {
          const long long b = acc / p.block_rows;
          res = __ldg(p.offsets + b) + (acc - b * p.block_rows);
        } else {
          res = FA_NO_ROW;
        }
      } else {
        res = ga_merge(kind, p.leaf_f64[l], p.leaf_ident[l], acc);
      }
    }
  }
  if (lane == 0) {
    const long long o = p.out_task;
    if (in_f) {
      out_f[(o * lf + slot) * c_out + g] = fa_f(res);
    } else {
      out_i[(o * li + slot) * c_out + g] = res;
    }
  }
}

extern "C" {

int bt_task_size(void) { return (int)sizeof(BtTask); }
int bt_smem_max(void) { return BT_SMEM_MAX; }

// Each launcher returns cudaGetLastError() right after its launch: a launch
// that is refused (too much shared memory) never runs, and a later
// synchronize would not say so.  Above 48 KB a block's dynamic shared memory
// must be allowed explicitly.
int bt_launch_partials(const BtTask* tasks, int n_tasks, int grid, long long* parts,
                       int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(batch_partials,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  batch_partials<<<grid, BT_THREADS, smem_bytes, (cudaStream_t)stream>>>(tasks, n_tasks, parts);
  return (int)cudaGetLastError();
}

int bt_launch_combine(const BtTask* tasks, int n_tasks, const long long* parts, int li, int lf,
                      int c_grid, int c_out, long long* out_i, double* out_f, void* stream) {
  const long long words = (long long)n_tasks * (li + lf) * c_grid;
  const long long blocks = (words * 32 + BT_THREADS - 1) / BT_THREADS;
  if (blocks == 0) return 0;
  batch_combine_pack<<<(unsigned)blocks, BT_THREADS, 0, (cudaStream_t)stream>>>(
      tasks, n_tasks, parts, li, lf, c_grid, c_out, out_i, out_f);
  return (int)cudaGetLastError();
}

}  // extern "C"
