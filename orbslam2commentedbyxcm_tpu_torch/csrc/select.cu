// The ORB extractor's keypoint selection: the per-cell top-k of every level
// of the pyramid, the 20 -> 7 threshold fallback per cell, and each level's
// `budget` smallest (rank, -score) keys, in one launch.
//
// Replaces: XLA code of the JAX package, not a Pallas kernel: the per-cell
// max/mask passes and lax.top_k of orbslam2commentedbyxcm_tpu/ops/orb.py:370-441
// (ORBExtractor._extract_level), which the port ran as ~1600 small torch
// operations per extraction. Its twin, ops/orb.py `select_level` (per level,
// `select_plain` over the pyramid), gives the same bits: every step is exact
// (max, min, compares, key = rank * 1e6 - score rounded once in float32, a
// total order on (key, index)), so no order of evaluation can move them.
//
// Per level l (h x w, its slots [slot_off, slot_off + budget)):
//   * nms_hi and nms_lo (K1's buffer, laid out by the level table) are
//     zeroed within `margin` pixels of the level's edges and cut into
//     cs x cs cells, zero-padded at the ragged edge (cy x cx cells);
//   * per cell and map, k passes: s = the cell's max, i = the lowest
//     in-cell index (row * cs + col) holding a value >= s when s > 0, else
//     0; the value at i becomes -inf;
//   * a cell takes its nms_hi results when its first nms_hi max is > 0,
//     else its nms_lo results; key[cell * k + t] = t * 1e6 - s_t where
//     s_t > 0, else +inf;
//   * slot j < n_take = min(budget, cy * cx * k) takes the key index of
//     rank j in the order (key, index): the smallest keys, ties to the
//     lower index, +inf keys last by index (a stable sort's order); slots
//     from n_take on take index 0 and are invalid; valid = key finite;
//     (px, py) = the cell's origin + the in-cell index; response = s.
//
// What bounds it on an H100 (700 W): the bytes. The function must read
// nms_hi inside every level's margin once, and nms_lo there in the cells
// with no nms_hi score (at most 8 bytes a pyramid pixel, 7.6 MB at
// 640x480), and write 13 bytes a slot: at most 2.3 us at 3.35 TB/s. Its
// operations (k passes x a max and a compare per cell value and map) take
// a tenth of that at 67 TFLOP/s.
//
// Design: one cooperative launch. Phase A: one warp per cell, over the
// cells of every level (grid-stride): lane c holds column c of the cell in
// 32 registers, a pass is a register max and a 5-step shuffle max, then a
// register scan for the first row holding s and a shuffle min; lane t keeps
// pass t's result. Lane t < k writes key t of the cell, its in-cell index
// and its value to a scratch in device memory. A grid barrier
// (cooperative_groups::this_grid().sync()). Phase B: a level of at most
// MAX_SORT keys is one block's: it sorts the level's (key, index) pairs in
// shared memory, padded with +inf keys to a power of two (bitonic network,
// NT threads), and writes its slots; keys of a level of 1920x1080 (34 x 60
// cells x 4) take 8192 entries, 64 KB. A larger level (above about 4.2 MP at
// k = 4, e.g. level 0 and 1 of 3840x2160) is ranked by count instead, NT
// keys a block, the blocks spread over the grid: a key's slot is the number
// of keys before it in the order (key, index), counted over the level's
// keys in tiles staged in shared memory; a block stops once each of its
// keys has `budget` before it (it takes no slot).
// Pitfalls: the scratch is written and read within the launch, so it is
// read with __ldcg after the barrier; a dynamic index into the level table
// reads it from shared memory; the grid is never more than the blocks that
// fit on the card at once (a cooperative launch that cannot be resident is
// refused rather than deadlocked).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "coresident.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int MAX_CELL = 32;  // cell side: a lane holds one column
constexpr int MAX_K = 32;     // per-cell k: lane t keeps pass t
constexpr int NT = 512;       // threads of a block
constexpr int NW = NT / 32;
constexpr int MAX_SORT = 16384;  // most keys of a level one block sorts; larger levels are ranked by count
constexpr int LEVEL_COLS = 8;  // host layout, see orb_select
constexpr unsigned FULL = 0xffffffffu;
static_assert(NT % 32 == 0 && NT <= 1024, "whole warps");
static_assert((MAX_SORT & (MAX_SORT - 1)) == 0 && MAX_SORT >= NT, "a power of two, at least a tile");

struct Level {
  int off, h, w;    // the level in the maps' flat layout
  int cy, cx;       // cells
  int key_off;      // its first key in the scratch
  int slot_off;     // its first slot
  int budget;       // its slots (0: the level is skipped)
  int tile_off;     // its first rank-by-count item, -1 when it is sorted
};

struct Plan {
  int n_levels, cs, k, margin;
  int total;      // floats of one map
  int n_cells;    // cells of every level with a budget
  int sort_size;  // entries of the sort buffer: a power of two >= NT and every sorted level's keys
  int n_items;    // phase B's work: a sort item per level, then the rank-by-count tiles
  int cap;        // slots
  int cell_off[MAX_LEVELS + 1];  // first cell of each level in the grid-stride order
  Level lv[MAX_LEVELS];
};

// Phase B items of a level ranked by count: one a tile of NT keys.
__host__ __device__ __forceinline__ int count_tiles(const Level& L, int k) {
  return L.tile_off < 0 ? 0 : (L.cy * L.cx * k + NT - 1) / NT;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// One map's cell (rows y0.., columns x0.., of level L) into v: lane c holds
// column c, rows 0..cs-1; values outside the margin or the level are 0,
// positions outside the cell -inf (never taken while a value >= 0 is left).
__device__ __forceinline__ void load_cell(const float* __restrict__ map, const Level& L, int y0, int x0, int cs,
                                          int margin, int lane, float (&v)[MAX_CELL]) {
  const int x = x0 + lane;
  const bool col_in = lane < cs && x >= margin && x < L.w - margin;
#pragma unroll
  for (int r = 0; r < MAX_CELL; ++r) {
    const int y = y0 + r;
    float val = lane < cs && r < cs ? 0.f : neg_inf();
    if (col_in && r < cs && y >= margin && y < L.h - margin) val = __ldg(map + L.off + y * L.w + x);
    v[r] = val;
  }
}

// k passes over the cell in v; lane t < k returns pass t's (max, index).
__device__ __forceinline__ void cell_topk(float (&v)[MAX_CELL], int cs, int k, int lane, float* top_v, int* top_i) {
  float my_v = 0.f;
  int my_i = 0;
  for (int t = 0; t < k; ++t) {
    float m = v[0];
#pragma unroll
    for (int r = 1; r < MAX_CELL; ++r) m = fmaxf(m, v[r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    int i = 0;
    if (m > 0.f) {  // warp-uniform
      int cand = 0x7fffffff;
#pragma unroll
      for (int r = MAX_CELL - 1; r >= 0; --r) {
        if (v[r] >= m) cand = r * cs + lane;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) cand = min(cand, __shfl_xor_sync(FULL, cand, o));
      i = cand;
    }
    const int ir = i / cs;
    if (lane == i - ir * cs) {
#pragma unroll
      for (int r = 0; r < MAX_CELL; ++r) {
        if (r == ir) v[r] = neg_inf();
      }
    }
    if (lane == t) {
      my_v = m;
      my_i = i;
    }
  }
  *top_v = my_v;
  *top_i = my_i;
}

// Slot j of level L takes key `sel` (0 for a slot past the level's keys);
// valid when `ok`.
__device__ __forceinline__ void write_slot(const Level& L, int cs, int k, int cap, int j, int sel, bool ok,
                                           const int* key_idx, const float* key_val, int* pxy, float* response,
                                           uint8_t* valid) {
  const int cell = sel / k;
  const int cyi = cell / L.cx;
  const int inner = __ldcg(key_idx + L.key_off + sel);
  const int ir = inner / cs;
  const int slot = L.slot_off + j;
  pxy[slot] = (cell - cyi * L.cx) * cs + inner - ir * cs;
  pxy[cap + slot] = cyi * cs + ir;
  response[slot] = __ldcg(key_val + L.key_off + sel);
  valid[slot] = ok ? 1 : 0;
}

__global__ void __launch_bounds__(NT) select_fused(const float* __restrict__ maps, Plan plan_in, float* keys,
                                                   int* key_idx, float* key_val, int* pxy, float* response,
                                                   uint8_t* valid) {
  __shared__ Plan plan;
  extern __shared__ __align__(16) unsigned char smem[];
  if (threadIdx.x == 0) plan = plan_in;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cs = plan.cs, k = plan.k;
  const float* nms_hi = maps + plan.total;
  const float* nms_lo = maps + 2 * static_cast<long long>(plan.total);

  // Phase A: one warp per cell
  for (int c = blockIdx.x * NW + warp; c < plan.n_cells; c += gridDim.x * NW) {
    int l = 0;
    while (c >= plan.cell_off[l + 1]) ++l;
    const Level& L = plan.lv[l];
    const int local = c - plan.cell_off[l];
    const int ci = local / L.cx;
    const int y0 = ci * cs, x0 = (local - ci * L.cx) * cs;
    float v[MAX_CELL];
    float hi_v, lo_v;
    int hi_i, lo_i;
    load_cell(nms_hi, L, y0, x0, cs, plan.margin, lane, v);
    cell_topk(v, cs, k, lane, &hi_v, &hi_i);
    load_cell(nms_lo, L, y0, x0, cs, plan.margin, lane, v);
    cell_topk(v, cs, k, lane, &lo_v, &lo_i);
    const bool has_hi = __shfl_sync(FULL, hi_v, 0) > 0.f;
    if (lane < k) {
      const float s = has_hi ? hi_v : lo_v;
      const int at = L.key_off + local * k + lane;
      keys[at] = s > 0.f ? __fsub_rn(__fmul_rn(static_cast<float>(lane), 1e6f), s) : pos_inf();
      key_idx[at] = has_hi ? hi_i : lo_i;
      key_val[at] = s;
    }
  }
  cg::this_grid().sync();

  // Phase B: a block per sorted level, then the tiles of the levels ranked by count
  float* sk = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(smem) + plan.sort_size;
  for (int item = blockIdx.x; item < plan.n_items; item += gridDim.x) {
    int l = item;
    if (item >= plan.n_levels) {  // the level whose tiles hold this item
      l = 0;
      while (item >= plan.lv[l].tile_off + count_tiles(plan.lv[l], k)) ++l;
    }
    const Level& L = plan.lv[l];
    const int n = L.cy * L.cx * k;
    if (item < plan.n_levels) {
      if (L.budget == 0 || L.tile_off >= 0) continue;  // block-uniform
      int p = 1;
      while (p < n) p <<= 1;
      for (int i = threadIdx.x; i < p; i += NT) {
        sk[i] = i < n ? __ldcg(keys + L.key_off + i) : pos_inf();
        si[i] = i;
      }
      __syncthreads();
      for (int size = 2; size <= p; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          for (int t = threadIdx.x; t < p / 2; t += NT) {
            const int a = 2 * t - (t & (stride - 1));
            const int b = a + stride;
            const float ka = sk[a], kb = sk[b];
            const int ia = si[a], ib = si[b];
            const bool after = ka > kb || (ka == kb && ia > ib);
            if (after == ((a & size) == 0)) {
              sk[a] = kb;
              sk[b] = ka;
              si[a] = ib;
              si[b] = ia;
            }
          }
          __syncthreads();
        }
      }
      const int n_take = min(L.budget, n);
      for (int j = threadIdx.x; j < L.budget; j += NT) {
        write_slot(L, cs, k, plan.cap, j, j < n_take ? si[j] : 0, j < n_take && sk[j] < pos_inf(), key_idx, key_val,
                   pxy, response, valid);
      }
    } else {
      // rank by count: key i's slot is #{j : (key_j, j) < (key_i, i)}
      const int i = (item - L.tile_off) * NT + threadIdx.x;
      const float ki = i < n ? __ldcg(keys + L.key_off + i) : pos_inf();
      int before = 0;
      for (int j0 = 0; j0 < n; j0 += NT) {
        const int m = min(NT, n - j0);
        if (threadIdx.x < m) sk[threadIdx.x] = __ldcg(keys + L.key_off + j0 + threadIdx.x);
        __syncthreads();
        for (int t = 0; t < m; ++t) {
          const float kj = sk[t];
          before += kj < ki || (kj == ki && j0 + t < i);
        }
        if (__syncthreads_and(i >= n || before >= L.budget)) break;  // also: the tile is read before the next
      }
      if (i < n && before < L.budget) {
        write_slot(L, cs, k, plan.cap, before, i, ki < pos_inf(), key_idx, key_val, pxy, response, valid);
      }
      if (item == L.tile_off) {  // slots past the level's keys
        for (int j = n + threadIdx.x; j < L.budget; j += NT) {
          write_slot(L, cs, k, plan.cap, j, 0, false, key_idx, key_val, pxy, response, valid);
        }
      }
    }
    __syncthreads();  // the next item reuses the shared buffer
  }
}

constexpr int SORT_SIZES = 32;  // sort buffers of 2^0 .. 2^31 entries
std::atomic<int> g_capacity[SORT_SIZES][coresident::MAX_DEVICES];  // co-resident blocks, 0 until known

}  // namespace

// Selection over every level of K1's (3, total) float buffer `maps` (blur,
// nms_hi, nms_lo) in one cooperative launch on `stream` of CUDA device
// `device`. `table` (host memory) holds n_levels rows of (offset, h, w, cy,
// cx, key_off, slot_off, budget) (ops/select_kernel.py `_plan`); `scratch`
// holds 3 x n_keys words (keys, in-cell indices, values). Writes px to
// pxy[0:cap], py to pxy[cap:2 cap], response and valid (0/1 bytes) per slot.
// Returns cudaErrorInvalidValue for a table that does not fit the kernel,
// else the launch's error.
extern "C" int orb_select(const float* maps, int total, const int* table, int n_levels, int cell_size,
                          int per_cell_k, int margin, int* scratch, int n_keys, int* pxy, float* response,
                          uint8_t* valid, int cap, int device, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_levels < 1 || n_levels > MAX_LEVELS || cell_size < 1 || cell_size > MAX_CELL || per_cell_k < 1 ||
      per_cell_k > MAX_K || per_cell_k > cell_size * cell_size || margin < 0 || total < 1 || cap < 0) {
    return bad;
  }
  Plan plan{};
  plan.n_levels = n_levels;
  plan.cs = cell_size;
  plan.k = per_cell_k;
  plan.margin = margin;
  plan.total = total;
  plan.cap = cap;
  long long keys = 0, cells = 0, slots = 0, items = n_levels;
  int most = NT;
  for (int l = 0; l < n_levels; ++l) {
    const int* row = table + LEVEL_COLS * l;
    Level& L = plan.lv[l];
    L.off = row[0];
    L.h = row[1];
    L.w = row[2];
    L.cy = row[3];
    L.cx = row[4];
    L.key_off = row[5];
    L.slot_off = row[6];
    L.budget = row[7];
    if (L.h < 1 || L.w < 1 || L.off < 0 || (long long)L.off + (long long)L.h * L.w > total ||
        L.cy != (L.h + cell_size - 1) / cell_size || L.cx != (L.w + cell_size - 1) / cell_size || L.budget < 0 ||
        L.slot_off != slots) {
      return bad;
    }
    plan.cell_off[l] = static_cast<int>(cells);
    L.tile_off = -1;
    if (L.budget > 0) {
      const long long n = (long long)L.cy * L.cx * per_cell_k;
      if (L.key_off != keys) return bad;
      if (n > MAX_SORT) {
        L.tile_off = static_cast<int>(items);
        items += count_tiles(L, per_cell_k);
      } else {
        while (most < n) most <<= 1;
      }
      keys += n;
      cells += (long long)L.cy * L.cx;
    }
    slots += L.budget;
  }
  plan.cell_off[n_levels] = static_cast<int>(cells);
  if (keys != n_keys || slots != cap) return bad;
  plan.n_cells = static_cast<int>(cells);
  plan.sort_size = most;
  plan.n_items = static_cast<int>(items);
  if (cap == 0) return 0;

  int prev = -1;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int log2 = 0;
  while ((1 << log2) < plan.sort_size) ++log2;
  const int smem = static_cast<int>(sizeof(float) * 2 * plan.sort_size);
  const int limit = coresident::blocks(reinterpret_cast<const void*>(select_fused), NT, smem,
                                       static_cast<int>(sizeof(float) * 2 * MAX_SORT), device, g_capacity[log2], &e);
  if (limit > 0) {
    int want = (plan.n_cells + NW - 1) / NW;
    if (want < plan.n_items) want = plan.n_items;
    const int grid = want < limit ? want : limit;
    float* keys_p = reinterpret_cast<float*>(scratch);
    int* idx_p = scratch + n_keys;
    float* val_p = reinterpret_cast<float*>(scratch + 2 * static_cast<long long>(n_keys));
    void* args[] = {&maps, &plan, &keys_p, &idx_p, &val_p, &pxy, &response, &valid};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(select_fused), dim3(grid), dim3(NT), args, smem,
                                    static_cast<cudaStream_t>(stream));
  }
  const cudaError_t last = cudaGetLastError();  // leave no error behind for the next launch
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(e != cudaSuccess ? e : last);
}
