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
// evenly whatever each one's walk costs.  Each thread walks BT_ROWS consecutive rows of one block at a time
// (the tile walk of fa_walk.cuh: the stack in registers, no local memory;
// the instance's stack slots the launcher's pick from the plans' depth),
// the tiles of the task in a grid stride; a tile never straddles two
// blocks.  The tile's group ids, the mixed radix of the key codes
// (jax_eval._mixed_radix_gids), are loaded once a tile before the walk; a
// row whose id lies outside [0, C) takes no part.  The walk hands each
// aggregate's argument to the fold in registers:
//   * one group (no key): each lane folds its rows in order into its own
//     column of shared memory; at the end the lanes fold in lane order;
//   * with group keys, integer leaves (count, int64 sum, the bit
//     operations, min, max, first's row) by a shared-memory atomic a row
//     into the warp's row of its id (a 64-bit add as two 32-bit ones, the
//     low half's carry into the high half; min and max once a plain read
//     says the row wins), in no order that matters; f64 leaves (sum, sum
//     of squares, min, max) per row of the tile: the lanes that share an
//     id (__match_any_sync) are folded in lane order by their lowest lane,
//     staged in shared memory, so that the order depends on the shapes
//     alone;
//   * the tracker (GROUP BY's first row): per row of the tile, the lowest
//     lane of each id keeps its row with a plain store.
// At the end the warps' rows fold in warp order into one row of partials
// per CTA, [n_ctas, n_leaves, C] int64 words per task.  first's value
// (GA_FIRSTVAL) is not folded: the combine reads it at the winning row.
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

#include "fa_walk.cuh"
#include "ga_leaf.cuh"

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

// Leaf l's integer word at `w` (shared memory) merged with v by a
// shared-memory atomic, for the kinds a warp does not reduce itself: the
// bit operations a 32-bit half at a time, min and max (first's row among
// them) once a plain read says v wins (the word only moves v's way).  The
// bit operations name the shared window's 32-bit address, so they are the
// shared-memory atomic unit's whatever the compiler infers of `w`.
__device__ __forceinline__ void bt_atomic(int kind, long long* w, long long v) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(w);
  const unsigned lo = (unsigned)(u64)v, hi = (unsigned)((u64)v >> 32);
  switch (kind) {
    case GA_COUNT:
    case GA_SUM: {
      unsigned old;
      asm volatile("atom.shared.add.u32 %0, [%1], %2;" : "=r"(old) : "r"(a), "r"(lo) : "memory");
      const unsigned up = hi + (old + lo < old ? 1u : 0u);
      asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(a + 4), "r"(up) : "memory");
      break;
    }
    case GA_AND:
      if (lo != ~0u) asm volatile("red.shared.and.b32 [%0], %1;" ::"r"(a), "r"(lo) : "memory");
      if (hi != ~0u) asm volatile("red.shared.and.b32 [%0], %1;" ::"r"(a + 4), "r"(hi) : "memory");
      break;
    case GA_OR:
      if (lo != 0) asm volatile("red.shared.or.b32 [%0], %1;" ::"r"(a), "r"(lo) : "memory");
      if (hi != 0) asm volatile("red.shared.or.b32 [%0], %1;" ::"r"(a + 4), "r"(hi) : "memory");
      break;
    case GA_XOR:
      if (lo != 0) asm volatile("red.shared.xor.b32 [%0], %1;" ::"r"(a), "r"(lo) : "memory");
      if (hi != 0) asm volatile("red.shared.xor.b32 [%0], %1;" ::"r"(a + 4), "r"(hi) : "memory");
      break;
    case GA_MAX:
      if (v > *w) atomicMax(w, v);
      break;
    default:  // GA_MIN, GA_FIRSTROW
      if (v < *w) atomicMin(w, v);
      break;
  }
}

// Partials of every task: CTA q of the task's run writes [n_leaves, C]
// words at part0 + q * n_leaves * C.  Dynamic shared memory: BT_WARPS * n_leaves *
// (32 + C) * 8 bytes for the largest task (the f64 stage, then the warps'
// rows).  D: the stack slots of the tile walk.
template <int D>
__global__ void __launch_bounds__(BT_THREADS)
batch_partials(const BtTask* __restrict__ tasks, int n_tasks, long long* __restrict__ parts) {
  constexpr int R = BT_ROWS;
  constexpr unsigned FULL = 0xFFFFFFFFu;
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
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    // [L][32] a warp: with group keys, an f64 leaf's values of one row of
    // the tile; with none, each lane's own fold of every leaf
    long long* stage = bt_smem + (long long)warp * L * 32;
    long long* wrows = bt_smem + (long long)BT_WARPS * L * 32;  // [BT_WARPS][L][C]
    long long* mine = wrows + (long long)warp * L * C;
    for (long long idx = threadIdx.x; idx < (long long)BT_WARPS * L * C; idx += BT_THREADS) {
      wrows[idx] = p.leaf_ident[(idx / C) % L];
    }
    const bool keyed = p.n_keys > 0;
    if (!keyed) {
      for (int l = 0; l < L; ++l) stage[l * 32 + lane] = p.leaf_ident[l];
    }
    __syncthreads();

    const long long rows = p.block_rows;
    const long long tpb = (rows + R - 1) / R;  // tiles a block
    const long long total = p.n_blocks * tpb;
    const long long stride = (long long)p.n_ctas * BT_THREADS;
    // every lane of a warp runs the same number of steps (the loop is on the
    // warp's first tile), so the warp-wide operations below see all 32 lanes
    long long base = (long long)(blockIdx.x - p.cta0) * BT_THREADS + warp * 32;
    long long t = base + lane;
    long long blk = tpb > 0 ? t / tpb : 0;
    long long ti = t - blk * tpb;
    const long long step_b = tpb > 0 ? stride / tpb : 0;
    const long long step_t = stride - step_b * tpb;

    for (; base < total; base += stride, t += stride) {
      long long i0 = 0, f0 = 0;
      int n = 0;
      unsigned valid = 0;
      if (t < total) {
        i0 = ti * R;
        f0 = blk * rows + i0;
        n = rows - i0 < R ? (int)(rows - i0) : R;
        const long long nv = __ldg(p.n_valids + blk) - i0;
        const int live = nv <= 0 ? 0 : nv < n ? (int)nv : n;
        valid = (1u << live) - 1;
      }
      // the tile's group ids: mixed radix over the key columns' codes
      int gid[R];
#pragma unroll
      for (int r = 0; r < R; ++r) gid[r] = 0;
      if (keyed) {
        long long g[R];
#pragma unroll
        for (int r = 0; r < R; ++r) g[r] = 0;
        for (int q = 0; q < p.n_keys; ++q) {
          long long x[R];
          unsigned xn;
          fa_load_tile<R>(p, p.key_slot[q], f0, blk, i0, n, x, xn);
          const long long dlen = p.key_dlen[q];
#pragma unroll
          for (int r = 0; r < R; ++r) g[r] = g[r] * (dlen + 1) + ((xn >> r) & 1 ? dlen : x[r]);
        }
        // a row whose id is outside the slots touches none, as XLA drops
        // out-of-range scatter updates
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (g[r] >= 0 && g[r] < C) {
            gid[r] = (int)g[r];
          } else {
            valid &= ~(1u << r);
          }
        }
      }
      // per row of the tile, the lanes whose row has the same id (the
      // invalid rows' lanes share id -1)
      unsigned same[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        same[r] = keyed ? __match_any_sync(FULL, (valid >> r) & 1 ? gid[r] : -1) : 0;
      }

      const unsigned active = fa_walk_tile<R, D>(
          p, f0, blk, i0, n, valid,
          [&](int k, unsigned live, const long long (&x)[R], unsigned) {
            const int l0 = p.agg_leaf0[k];
            for (int l = l0; l < l0 + p.agg_nleaves[k]; ++l) {
              const int kind = p.leaf_kind[l];
              if (kind == GA_FIRSTVAL) continue;
              const bool is_f = p.leaf_f64[l];
              long long* cells = mine + (long long)l * C;
              // the tile's rows one at a time, each rotated into slot 0, so
              // that the fold's code is there once
              long long v[R];
              int g[R];
              unsigned sm[R];
#pragma unroll
              for (int r = 0; r < R; ++r) {
                v[r] = x[r];
                g[r] = gid[r];
                sm[r] = same[r];
              }
#pragma unroll 1
              for (int r = 0; r < R; ++r) {
                const bool on = (live >> r) & 1;
                const long long c = ga_contrib(p, l, on, v[0], f0 + r);
                if (!keyed) {
                  // one group: each lane folds its rows in order
                  if (on) stage[l * 32 + lane] = ga_merge(kind, is_f, stage[l * 32 + lane], c);
                } else {
                  const unsigned lv = __ballot_sync(FULL, on);
                  if (lv != 0) {
                    // the lowest lane of each id folds what its lanes add
                    const unsigned m = sm[0] & lv;
                    const bool lead = ((valid >> r) & 1) && lane == __ffs(sm[0]) - 1 && m != 0;
                    if (is_f) {
                      // f64: its lanes' values in lane order, staged
                      stage[l * 32 + lane] = c;
                      __syncwarp();
                      if (lead) {
                        long long a = cells[g[0]];
                        for (unsigned b = m; b != 0; b &= b - 1) {
                          a = ga_merge(kind, true, a, stage[l * 32 + __ffs(b) - 1]);
                        }
                        cells[g[0]] = a;
                      }
                      __syncwarp();
                    } else if (on) {
                      bt_atomic(kind, cells + g[0], c);
                    }
                  }
                }
#pragma unroll
                for (int r2 = 0; r2 + 1 < R; ++r2) {
                  v[r2] = v[r2 + 1];
                  g[r2] = g[r2 + 1];
                  sm[r2] = sm[r2 + 1];
                }
              }
            }
          },
          [](int, const long long (&)[R], unsigned) {});

      if (p.track) {
        // leaf 0: the first active row of each group.  A lane's rows come in
        // order, and within a row of the tile in lane order
        if (!keyed) {
          const long long f1 = f0 + __ffs(active) - 1;
          if (active != 0 && f1 < stage[lane]) stage[lane] = f1;
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const bool on = (active >> r) & 1;
            const unsigned peers = __match_any_sync(FULL, on ? gid[r] : -1);
            if (on && lane == __ffs(peers) - 1 && f0 + r < mine[gid[r]]) mine[gid[r]] = f0 + r;
          }
        }
      }
      blk += step_b;
      ti += step_t;
      if (ti >= tpb) {
        ti -= tpb;
        ++blk;
      }
    }

    if (!keyed) {
      // each lane's fold, in lane order, into the warp's row
      __syncwarp();
      for (int l = lane; l < L; l += 32) {
        const int kind = p.leaf_kind[l];
        long long acc = mine[(long long)l * C];
        for (int j = 0; j < 32; ++j) acc = ga_merge(kind, p.leaf_f64[l], acc, stage[l * 32 + j]);
        mine[(long long)l * C] = acc;
      }
    }
    __syncthreads();
    long long* part = parts + p.part0 + (long long)(blockIdx.x - p.cta0) * L * C;
    for (long long idx = threadIdx.x; idx < (long long)L * C; idx += BT_THREADS) {
      const int l = (int)(idx / C);
      const int kind = p.leaf_kind[l];
      const bool is_f = p.leaf_f64[l];
      long long acc = wrows[idx];
      for (int w = 1; w < BT_WARPS; ++w) {
        acc = ga_merge(kind, is_f, acc, wrows[(long long)w * L * C + idx]);
      }
      part[idx] = acc;
    }
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
