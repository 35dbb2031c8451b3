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
// batch_partials: a grid of CTAs, each image owning a contiguous run of
// them (its share of the grid by rows), which the tasks over that image
// share: a CTA finds its tasks by binary search over the table and, for
// each in turn, copies the descriptor into shared memory (the walk then
// reads the code and constants from there, broadcast to the warp) and
// walks its rows, so the riders of a same-region batch split the grid
// evenly whatever each one's walk costs.  The walk and fold are
// ga_fold.cuh's, which fused_group_agg_partials (fused_agg.cu) shares:
// BT_ROWS consecutive rows of a block a thread through the tile walk, the
// tile's group ids from the key codes once a tile, integer leaves by
// shared-memory atomics into the warp's row of its id, f64 leaves folded in
// lane order by the lowest lane of each id, the tracker by that lane with a
// plain store.  At the end the warps'
// rows fold in warp order into one row of partials per CTA, [n_ctas,
// n_leaves, C] int64 words per task.
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
// shipped lanes read once.  The kernel reads them once per task (a CTA
// walks its rows for each rider in turn, from HBM each time: the rows of
// the resident CTAs far outgrow L2); at the measured shapes the walk and
// the fold's instructions, not the loads, set its time.  A task with more
// group slots than the shared-memory rows hold (SMEM_MAX of
// copr/fused_batch.py) has no entry in the table: the wrapper serves it by
// the grouped pair's wide route (fused_agg.cu, group_wide_partials) and
// copies its state into its rows of the output, which each entry names
// (out_task).
//
// Layout contract with tikv_tpu_torch/copr/fused_batch.py (the wrapper
// checks sizeof(BtTask) and the shared-memory limit at load).

#include "ga_fold.cuh"

#define BT_THREADS 256
#define BT_WARPS (BT_THREADS / 32)
#define BT_ROWS 4  // rows a thread walks at once (its tile)

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

// Partials of every task: CTA q of the task's run writes [n_leaves, C]
// words at part0 + q * n_leaves * C.  Dynamic shared memory: BT_WARPS * n_leaves *
// (32 + C) * 8 bytes for the largest task (the f64 stage, then the warps'
// rows).  D: the stack slots of the tile walk.
template <int D>
__global__ void __launch_bounds__(BT_THREADS)
batch_partials(const BtTask* __restrict__ tasks, int n_tasks, long long* __restrict__ parts) {
  __shared__ BtTask task;
  extern __shared__ long long bt_smem[];
  // the tasks of this CTA: those whose CTAs begin at the last first CTA at
  // or before it (the tasks over one image share their CTAs)
  int lo = 0, hi = n_tasks - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tasks[mid].cta0 <= (int)blockIdx.x) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  int first = lo;
  while (first > 0 && tasks[first - 1].cta0 == tasks[lo].cta0) --first;
  for (int tk = first; tk <= lo; ++tk) {
    __syncthreads();  // the previous task's rows are written out
    {
      const long long* src = reinterpret_cast<const long long*>(tasks + tk);
      long long* dst = reinterpret_cast<long long*>(&task);
      for (int w = threadIdx.x; w < (int)(sizeof(BtTask) / 8); w += BT_THREADS) dst[w] = src[w];
    }
    __syncthreads();
    const BtTask& p = task;
    const int L = p.n_leaves;
    const int C = p.capacity;
    const int warp = threadIdx.x >> 5;
    // [L][32] a warp: with group keys, an f64 leaf's values of one row of
    // the tile; with none, each lane's own fold of every leaf
    long long* stage = bt_smem + (long long)warp * L * 32;
    long long* wrows = bt_smem + (long long)BT_WARPS * L * 32;  // [BT_WARPS][L][C]
    long long* mine = wrows + (long long)warp * L * C;
    ga_rows_init<BT_THREADS>(p, stage, wrows, p.n_keys > 0);
    __syncthreads();
    ga_walk_tiles<BT_ROWS, D, BT_THREADS>(
        p, nullptr, [&](long long b) { return __ldg(p.n_valids + b); }, blockIdx.x - p.cta0,
        p.n_ctas, stage, mine);
    __syncthreads();
    ga_rows_out<BT_THREADS>(p, wrows, parts + p.part0 + (long long)(blockIdx.x - p.cta0) * L * C);
  }
}

typedef void (*BtPartialsKernel)(const BtTask*, int, long long*);

// The instance whose stack holds `slots` operands (2, 4 or 8); nullptr else.
static BtPartialsKernel bt_partials_kernel(int slots) {
  static_assert(FA_MAX_STACK == 8, "the partials instances' slots");
  switch (slots) {
    case 2: return batch_partials<2>;
    case 4: return batch_partials<4>;
    case 8: return batch_partials<8>;
    default: return nullptr;
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
// batch_partials runs the instance of `slots` stack slots
// (cudaErrorInvalidValue for another count).
int bt_launch_partials(const BtTask* tasks, int n_tasks, int grid, long long* parts,
                       int smem_bytes, int slots, void* stream) {
  const BtPartialsKernel k = bt_partials_kernel(slots);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute((const void*)k,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  k<<<grid, BT_THREADS, smem_bytes, (cudaStream_t)stream>>>(tasks, n_tasks, parts);
  return (int)cudaGetLastError();
}

// cudaFuncGetAttributes of the instance of `slots` stack slots: registers a
// thread, local and static shared bytes, into out[0..3).
int bt_partials_attributes(int slots, int* out) {
  const BtPartialsKernel k = bt_partials_kernel(slots);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, (const void*)k);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

int bt_rows(void) { return BT_ROWS; }

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
