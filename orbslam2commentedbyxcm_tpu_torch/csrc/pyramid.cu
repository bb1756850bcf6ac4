// The ORB extractor's exposure gain and image pyramid: the gain and every
// level of an 8-level (or up to 16-level) pyramid in one launch, written
// straight into the flat level buffer that the frontend kernel (frontend.cu)
// reads.
//
// Replaces: XLA code of the JAX package, not a Pallas kernel: the gain at
// orbslam2commentedbyxcm_tpu/ops/orb.py:317-330 (jnp.mean of the image and
// of its absolute deviation) and the resize `wh @ img @ ww.T` at :337-339,
// two dense float32 matrix products per level. Every sum here has one fixed
// order, and the torch twin (ops/orb.py `_pyramid_plain`, `_exposure_gain`,
// `_tree_sum`) computes the same bits on either device:
//   * gain: the mean and the mean absolute deviation are adjacent-pair
//     halving trees over the flat image zero-padded to a power of two
//     (x[0::2] + x[1::2] until one value is left), each divided by the pixel
//     count; gain = clamp(target / max(mad, 1e-3), 1/8, 8) and
//     (x - mu) * gain + mu are separately rounded operations (__fsub_rn,
//     __fmul_rn, __fadd_rn, __fdiv_rn: nothing is contracted);
//   * resize: each output is the chain of fused multiply-adds (__fmaf_rn)
//     over its nonzero taps in ascending input index, from +0.0: first down
//     the image's columns (vertical pass), then along that result's rows.
//     The tap tables (ops/orb.py `_resize_taps`) hold the resize matrix's
//     float32 values; padded taps are zeros, which change no such sum.
//     Every level resizes level 0, as the JAX package does.
// No --use_fast_math, and no tensor cores: neither keeps an fma chain's order.
//
// The trees: a block sums 1024 consecutive values as one aligned subtree
// (each thread a subtree of 1024 / threads consecutive values, then warp
// shuffles at offsets 1, 2, 4, 8, 16, then the same over the warp sums),
// into one partial per 1024-value chunk. The total reduces the partials the
// same way, in chunks of 1024. A tree padded to a larger power of two
// differs from the twin's only in the sign of an all-(-0) sum, which changes
// no output.
//
// What bounds it on an H100 80GB HBM3 (700 W): not the bytes. The whole
// function must read the image once and write the levels once: at 640x480,
// 1.23 MB + 3.80 MB, 1.5 us at 3.35 TB/s. The resize does ~3.6 M fused
// multiply-adds there (3-8 nonzero taps per output and axis), 0.1 us at 67
// TFLOP/s. What the launch waits on is the gain's two grid barriers and the
// round trips around them, then the shared-memory loads of the fma chains
// (one 128-byte load per warp-wide fma, the pipe's rate).
//
// Design: one persistent cooperative launch per call, the grid as many
// blocks as fit on the card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// x SMs, cached per device), capped at the work. With the gain on, three
// phases separated by grid barriers (cooperative_groups::this_grid().sync()):
//   P1  blocks walk the image's 1024-value chunks: one partial each (a
//       block's first chunk stays in registers for P2), written in
//       PYR_PART_COPIES copies a line apart;
//   P2  every block reduces the partials to mu, from copy blockIdx %
//       copies, then the |x - mu| partials the same way;
//   P3  every block reduces those to mad and gain.
// The copies spread the blocks' reads of the same partials over L2: all of
// them read right after a barrier (one copy: 19.3 us with the gain, eight:
// 17.9, in one tools/profile_kernels.py call on an H100 80GB HBM3, 700 W).
// The resize is input-stationary. The image is cut into boxes of
// PYR_BOX_ROWS x PYR_BOX_COLS values; every output of a level > 0 belongs
// to the box in which its taps start. A block stages its box with a halo of
// the most taps - 1 (at most PYR_BUF_ROWS x PYR_BUF_COLS values) into shared
// memory once with cp.async, with the tap records of its row band and its
// column band (per level: the outputs whose taps start in the band, their
// starts and weights, built by the host so that one copy fetches them), and
// computes every level from there: an image value is staged about 1.6
// times for the whole pyramid (23 x 64 values per 16 x 57 owned at 8
// levels of scale 1.2), where a band per tile of every level stages it
// about 11 times. With the gain on,
// the first box is in flight through the barriers. The gain is applied once
// per staged value (each thread to the values it copied), level 0 is written
// from the box, then one vertical phase over every level's (level, output
// row) items into a shared buffer, a barrier, and one horizontal phase over
// the same items into the levels: three block barriers per box, and each
// warp has items of every level to keep in flight. The horizontal weights
// are stored tap-major so a warp reads them in one access. Lanes past a
// row's end compute on whatever lies there in shared memory and store
// nothing, so only the stores are predicated.
// Pitfalls: the partials are written and read within the launch, so they
// are read with __ldcg after the barrier, never through the non-coherent
// read-only path; a cooperative launch that cannot be resident at once is
// refused (cudaErrorCooperativeLaunchTooLarge) rather than deadlocked; never
// a spin barrier on an ordinary launch; a dynamic index into the level table
// reads it from shared memory, not from the kernel's parameters.
// Measured per 640x480 extraction on an H100 80GB HBM3 (700 W):
// chip_smoke.py phase 3, PERF.md section 6.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

// Design choices (tools/profile_kernels.py builds variants with -D).
#ifndef PYR_THREADS
#define PYR_THREADS 256  // threads of a block
#endif
#ifndef PYR_BOX_ROWS
#define PYR_BOX_ROWS 16  // image rows a box owns (the host may take fewer)
#endif
#ifndef PYR_BOX_COLS
#define PYR_BOX_COLS 64  // image columns a box owns (the host may take fewer)
#endif
#ifndef PYR_BUF_ROWS
#define PYR_BUF_ROWS 24  // most image rows a box stages: its own and the taps' halo
#endif
#ifndef PYR_BUF_COLS
#define PYR_BUF_COLS 64  // most image columns a box stages
#endif
#ifndef PYR_REC_WORDS
#define PYR_REC_WORDS 2048  // most words of one box's tap records
#endif
#ifndef PYR_T_WORDS
#define PYR_T_WORDS 4608  // most words of all levels' vertical passes in a box
#endif
#ifndef PYR_PART_COPIES
#define PYR_PART_COPIES 8  // copies of the gain's partials, so that the blocks' reads spread over L2
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int MAX_DEVICES = 64;
constexpr int HEAD = 8;        // host layout, see orb_pyramid
constexpr int LEVEL_COLS = 11;
constexpr int CHUNK = 1024;    // values per partial of the gain sums, and partials per chunk of their sum
constexpr int NT = PYR_THREADS;
constexpr int NW = NT / 32;
constexpr int BUF = PYR_BUF_ROWS * PYR_BUF_COLS;  // words of the box buffer
constexpr int REC = PYR_REC_WORDS;
constexpr int TW = PYR_T_WORDS;
constexpr int QV = (PYR_BUF_COLS + 31) / 32;  // columns per lane in the vertical pass
constexpr int QH = (PYR_BOX_COLS + 31) / 32;  // outputs per lane in the horizontal pass
constexpr int ITEMS = 256;  // most (level, output row) items of a box
constexpr int COPIES = PYR_PART_COPIES;
constexpr size_t SMEM_BYTES = sizeof(float) * (BUF + REC + TW);
static_assert(NT % 32 == 0 && NT <= CHUNK && CHUNK % NT == 0, "whole warps, a divisor of the chunk");
static_assert(REC % 4 == 0 && BUF % 4 == 0, "16-byte record copies");
static_assert(TW >= CHUNK, "the vertical passes' buffer holds the chunk sums of the partials");
static_assert(COPIES >= 1 && COPIES <= NT, "one thread writes each copy");
static_assert(REC >= 32 * QV && TW >= 32 * QH, "a lane's reads past a row's end stay in shared memory");

// Floats between two copies of the partials: a whole number of 128-byte
// lines, and one line more, so no two copies share a line.
__host__ __device__ constexpr int part_stride(int n_part) { return (n_part + 31) / 32 * 32 + 32; }

struct Level {
  int off, h, w;  // output offset in the flat buffer, output shape
  int tv, tw;     // taps per output: vertical, horizontal
  int v_at, rmax; // this level's block in a row band's record; most output rows a band starts
  int h_at, cmax; // this level's block in a column band's record; most output columns a band starts
  int t_at, t_cols;  // this level's vertical pass in the buffer: offset, row stride (its most columns)
  int item0;      // its first (level, row) item
};

struct Span {            // what one box computes of one level
  int nr, nj;            // output rows, columns whose taps start in the box
  int r_lo, j_lo;        // the first of each
  int c_first, cw;       // the box column of the first input column they read; input columns read
};

struct Plan {
  int n_levels;
  int bh, bw;          // image rows and columns a box owns
  int halo_r, halo_c;  // rows and columns staged past them (the most taps - 1)
  int n_rb, n_cb;      // row bands, column bands: boxes = n_rb x n_cb
  int v_words, h_words;  // words of a row band's and of a column band's record
  int n_items;         // (level, output row) items: the rmax of every level > 0
  Level lv[MAX_LEVELS];
};

struct Box {
  int r0, c0;      // first image row and column the box owns
  int rows, cols;  // image rows and columns staged (its own and the halo, inside the image)
  int own_r, own_c;
};

struct Gain {
  float mu, gain;
};

__device__ __forceinline__ float apply_gain(float x, Gain g) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, g.mu), g.gain), g.mu);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Adjacent-pair tree over the NT values held one per thread (thread order);
// every thread returns the root. All threads must call it together.
__device__ float block_tree(float v, float* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  __syncthreads();  // s_warp may still be read by a previous call
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < NW ? s_warp[lane] : 0.0f;
#pragma unroll
    for (int o = 1; o < NW; o <<= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) s_warp[32] = v;
  }
  __syncthreads();
  return s_warp[32];
}

constexpr int G = CHUNK / NT;  // consecutive values per thread in a chunk's tree

// The subtree of the G values in v (consecutive), into v[0].
__device__ __forceinline__ void local_tree(float (&v)[G]) {
#pragma unroll
  for (int s = 1; s < G; s <<= 1) {
#pragma unroll
    for (int g = 0; g + s < G; g += 2 * s) v[g] = __fadd_rn(v[g], v[g + s]);
  }
}

// The tree over src[0, n) zero-padded to CHUNK values. GLOBAL: src lies in
// global memory, written earlier in this launch (read through L2).
template <bool GLOBAL>
__device__ float chunk_tree(const float* src, int n, float* s_warp) {
  float v[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int i = threadIdx.x * G + g;
    v[g] = i < n ? (GLOBAL ? __ldcg(src + i) : src[i]) : 0.0f;
  }
  local_tree(v);
  return block_tree(v[0], s_warp);
}

// The sum of the n_part partials: each chunk of CHUNK partials is one
// subtree, then the chunk sums (at most CHUNK) are summed the same way.
__device__ float sum_partials(const float* part, int n_part, float* s_warp, float* s_chunk) {
  const int n_chunks = (n_part + CHUNK - 1) / CHUNK;
  if (n_chunks == 1) return chunk_tree<true>(part, n_part, s_warp);
  for (int c = 0; c < n_chunks; ++c) {
    const float r = chunk_tree<true>(part + c * CHUNK, n_part - c * CHUNK, s_warp);
    if (threadIdx.x == 0) s_chunk[c] = r;
  }
  __syncthreads();
  return chunk_tree<false>(s_chunk, n_chunks, s_warp);
}

// This thread's G consecutive values of chunk c of the image (zero past n).
__device__ __forceinline__ void load_chunk(const float* __restrict__ img, long long n, int c, bool aligned,
                                           float (&v)[G]) {
  const long long base = static_cast<long long>(c) * CHUNK + static_cast<long long>(threadIdx.x) * G;
  if constexpr (G == 4) {
    if (aligned && base + G <= n) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(img + base));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
      return;
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) v[g] = base + g < n ? __ldg(img + base + g) : 0.0f;
}

// The subtree of chunk c held in v (ABS: of |x - mu|; the padding stays +0).
template <bool ABS>
__device__ float chunk_sum(float (&v)[G], long long n, int c, float mu, float* s_warp) {
  const long long base = static_cast<long long>(c) * CHUNK + static_cast<long long>(threadIdx.x) * G;
  float x[G];
#pragma unroll
  for (int g = 0; g < G; ++g) x[g] = ABS && base + g < n ? fabsf(__fsub_rn(v[g], mu)) : v[g];
  local_tree(x);
  return block_tree(x[0], s_warp);
}

__device__ Box box_of(const Plan& p, int item, int h, int w) {
  Box b;
  const int rb = item / p.n_cb;
  b.r0 = rb * p.bh;
  b.c0 = (item - rb * p.n_cb) * p.bw;
  b.own_r = min(p.bh, h - b.r0);
  b.own_c = min(p.bw, w - b.c0);
  b.rows = min(p.bh + p.halo_r, h - b.r0);
  b.cols = min(p.bw + p.halo_c, w - b.c0);
  return b;
}

// The box's image values (warps take rows, lanes columns: each thread later
// gains the values it copied) and its row band's and column band's records.
__device__ void stage_box(const Plan& p, const float* __restrict__ img, int w, const int* __restrict__ records,
                          int item, const Box& b, float* s_box, int* s_rec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < b.rows; i += NW) {
    const float* src = img + static_cast<size_t>(b.r0 + i) * w + b.c0;
    float* dst = s_box + i * b.cols;
    for (int c = lane; c < b.cols; c += 32) cp_async4(dst + c, src + c);
  }
  const int rb = item / p.n_cb;
  const int* v_rec = records + static_cast<size_t>(rb) * p.v_words;
  const int* h_rec = records + static_cast<size_t>(p.n_rb) * p.v_words + static_cast<size_t>(item - rb * p.n_cb) * p.h_words;
  for (int i = 4 * threadIdx.x; i < p.v_words; i += 4 * NT) cp_async16(s_rec + i, v_rec + i);
  for (int i = 4 * threadIdx.x; i < p.h_words; i += 4 * NT) cp_async16(s_rec + p.v_words + i, h_rec + i);
}

__device__ void gain_box(const Box& b, float* s_box, Gain g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < b.rows; i += NW) {
    float* row = s_box + i * b.cols;
    for (int c = lane; c < b.cols; c += 32) row[c] = apply_gain(row[c], g);
  }
}

// Level 0: the box's own values, gained or copied.
__device__ void write_level0(const Level& L, const Box& b, const float* s_box, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < b.own_r; i += NW) {
    float* dst = out + L.off + static_cast<size_t>(b.r0 + i) * L.w + b.c0;
    const float* src = s_box + i * b.cols;
    for (int c = lane; c < b.own_c; c += 32) dst[c] = src[c];
  }
}

// What the box computes of level L, from its row band's record (first row,
// end row, starts[rmax], weights[rmax][tv]) and its column band's (first
// column, end column, starts[cmax], weights[tw][cmax]).
__device__ Span span_of(const Level& L, const Box& b, const int* v, const int* hr) {
  Span s;
  s.r_lo = v[0];
  s.nr = v[1] - v[0];
  s.j_lo = hr[0];
  s.nj = min(hr[1] - hr[0], 32 * QH);
  if (s.nr <= 0 || s.nj <= 0) {
    s.nr = 0;
    s.c_first = s.cw = 0;
    return s;
  }
  const int* hs = hr + 2;
  s.c_first = hs[0] - b.c0;
  s.cw = min(min(hs[s.nj - 1] + L.tw - hs[0], L.t_cols), 32 * QV);  // the host sized t_cols to the widest
  return s;
}

// Output row r of the box's vertical pass of level L: the fma chains down
// the box's columns into the level's rows of tb. Lanes past the row's
// columns compute on whatever lies there (inside the shared buffers) and
// store nothing, so only the stores are predicated.
__device__ void vertical_row(const Level& L, const Span& sp, const Box& b, const int* v, int r, const float* s_box,
                             float* tb) {
  const int lane = threadIdx.x & 31;
  const float* src = s_box + (v[2 + r] - b.r0) * b.cols + sp.c_first + lane;
  const float* wr = reinterpret_cast<const float*>(v + 2 + L.rmax) + r * L.tv;
  float acc[QV];
#pragma unroll
  for (int q = 0; q < QV; ++q) acc[q] = 0.0f;
  for (int k = 0; k < L.tv; ++k) {
    const float wk = wr[k];
#pragma unroll
    for (int q = 0; q < QV; ++q) acc[q] = __fmaf_rn(wk, src[32 * q], acc[q]);
    src += b.cols;
  }
  float* dst = tb + L.t_at + r * L.t_cols + lane;
#pragma unroll
  for (int q = 0; q < QV; ++q) {
    if (lane + 32 * q < sp.cw) dst[32 * q] = acc[q];
  }
}

// Output row r of the box's horizontal pass of level L, from tb into the
// level; the column weights are tap-major, (tw, cmax).
__device__ void horizontal_row(const Level& L, const Span& sp, const int* hr, int r, const float* tb,
                               float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int* hs = hr + 2;
  const float* hw = reinterpret_cast<const float*>(hr + 2 + L.cmax) + lane;
  const float* src = tb + L.t_at + r * L.t_cols - hs[0];
  const float* at[QH];
  float acc[QH];
#pragma unroll
  for (int q = 0; q < QH; ++q) {
    const int j = lane + 32 * q;
    at[q] = src + (j < sp.nj ? hs[j] : hs[0]);
    acc[q] = 0.0f;
  }
  for (int k = 0; k < L.tw; ++k) {
#pragma unroll
    for (int q = 0; q < QH; ++q) acc[q] = __fmaf_rn(hw[32 * q], at[q][k], acc[q]);
    hw += L.cmax;
  }
  float* dst = out + L.off + static_cast<size_t>(sp.r_lo + r) * L.w + sp.j_lo + lane;
#pragma unroll
  for (int q = 0; q < QH; ++q) {
    if (lane + 32 * q < sp.nj) dst[32 * q] = acc[q];
  }
}

__global__ void __launch_bounds__(NT) pyramid_fused(const float* __restrict__ img, int h, int w, float* part,
                                                    float target, const int* __restrict__ records,
                                                    float* __restrict__ out, const __grid_constant__ Plan plan) {
  extern __shared__ float smem[];  // the box, its records, the vertical passes
  __shared__ float s_warp[33];
  __shared__ Level s_lv[MAX_LEVELS];  // the level table, read with a dynamic index from here, not param space
  __shared__ Span s_span[MAX_LEVELS];
  __shared__ short2 s_item[ITEMS];    // (level, output row) of each item
  float* s_box = smem;
  int* s_rec = reinterpret_cast<int*>(smem + BUF);
  float* s_t = smem + BUF + REC;
  const long long n = static_cast<long long>(h) * w;
  const int stride = gridDim.x;
  const int n_boxes = plan.n_rb * plan.n_cb;
  const bool gained = part != nullptr;

  // The first global reads go out before the level table is copied: P1's
  // chunk with the gain, else the first box.
  Gain g{0.0f, 1.0f};
  int item = blockIdx.x;
  Box box{};
  const int n_part = static_cast<int>((n + CHUNK - 1) / CHUNK);
  const bool aligned = (reinterpret_cast<uintptr_t>(img) & 15) == 0;
  float first[G];
  if (gained && blockIdx.x < n_part) load_chunk(img, n, blockIdx.x, aligned, first);
  if (!gained && item < n_boxes) {
    box = box_of(plan, item, h, w);
    stage_box(plan, img, w, records, item, box, s_box, s_rec);
    cp_async_commit();
  }
  static_assert(sizeof(Level) % sizeof(int) == 0, "the level table is copied word by word");
  for (int i = threadIdx.x; i < plan.n_levels * static_cast<int>(sizeof(Level) / sizeof(int)); i += NT) {
    reinterpret_cast<int*>(s_lv)[i] = reinterpret_cast<const int*>(plan.lv)[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < plan.n_items; i += NT) {
    int l = 1;
    while (l + 1 < plan.n_levels && i >= s_lv[l + 1].item0) ++l;
    s_item[i] = make_short2(static_cast<short>(l), static_cast<short>(i - s_lv[l].item0));
  }  // published by the next barrier, before the first box's levels
  if (gained) {
    // P1: the image's chunk partials; this block's first chunk stays in
    // registers for P2. After the barrier the first box is staged.
    cg::grid_group grid = cg::this_grid();
    const float count = static_cast<float>(n);
    const int pstride = part_stride(n_part), copy = blockIdx.x % COPIES;  // the copy this block reads
    for (int c = blockIdx.x; c < n_part; c += stride) {
      float v[G];
      if (c == blockIdx.x) {
#pragma unroll
        for (int i = 0; i < G; ++i) v[i] = first[i];
      } else {
        load_chunk(img, n, c, aligned, v);
      }
      const float r = chunk_sum<false>(v, n, c, 0.0f, s_warp);
      if (threadIdx.x < COPIES) part[threadIdx.x * pstride + c] = r;
    }
    grid.sync();
    if (item < n_boxes) {  // in flight through P2, the second barrier and P3
      box = box_of(plan, item, h, w);
      stage_box(plan, img, w, records, item, box, s_box, s_rec);
    }
    cp_async_commit();
    // P2: mu, then the |x - mu| partials. The chunk sums go to the
    // vertical-pass buffers, free until the levels start.
    float* s_chunk = s_t;
    g.mu = __fdiv_rn(sum_partials(part + copy * pstride, n_part, s_warp, s_chunk), count);
    for (int c = blockIdx.x; c < n_part; c += stride) {
      float v[G];
      if (c == blockIdx.x) {
#pragma unroll
        for (int i = 0; i < G; ++i) v[i] = first[i];
      } else {
        load_chunk(img, n, c, aligned, v);
      }
      const float r = chunk_sum<true>(v, n, c, g.mu, s_warp);
      if (threadIdx.x < COPIES) part[(COPIES + threadIdx.x) * pstride + c] = r;
    }
    grid.sync();
    // P3: mad and the gain, in every block.
    const float mad = __fdiv_rn(sum_partials(part + (COPIES + copy) * pstride, n_part, s_warp, s_chunk), count);
    g.gain = fminf(fmaxf(__fdiv_rn(target, fmaxf(mad, 1e-3f)), 0.125f), 8.0f);
  }

  for (; item < n_boxes; item += stride) {
    if (item != static_cast<int>(blockIdx.x)) {  // the previous box's levels are done (barrier at loop end)
      box = box_of(plan, item, h, w);
      stage_box(plan, img, w, records, item, box, s_box, s_rec);
      cp_async_commit();
    }
    cp_async_wait_all();  // each thread sees its own copies
    if (gained) gain_box(box, s_box, g);
    __syncthreads();
    // What the box computes of each level > 0, one thread per level.
    if (threadIdx.x > 0 && threadIdx.x < plan.n_levels) {
      const Level& L = s_lv[threadIdx.x];
      s_span[threadIdx.x] = span_of(L, box, s_rec + L.v_at, s_rec + plan.v_words + L.h_at);
    }
    __syncthreads();
    // Every level's vertical pass, one (level, row) item per warp at a
    // time; then level 0 from the box.
    for (int i = threadIdx.x >> 5; i < plan.n_items; i += NW) {
      const short2 it = s_item[i];
      const Span& sp = s_span[it.x];
      if (it.y < sp.nr) {
        const Level& L = s_lv[it.x];
        vertical_row(L, sp, box, s_rec + L.v_at, it.y, s_box, s_t);
      }
    }
    write_level0(s_lv[0], box, s_box, out);
    __syncthreads();
    // Every level's horizontal pass, the same items.
    for (int i = threadIdx.x >> 5; i < plan.n_items; i += NW) {
      const short2 it = s_item[i];
      const Span& sp = s_span[it.x];
      if (it.y < sp.nr) {
        const Level& L = s_lv[it.x];
        horizontal_row(L, sp, s_rec + plan.v_words + L.h_at, it.y, s_t, out);
      }
    }
    __syncthreads();  // the box and its records are read before the next box is staged
  }
}

std::atomic<int> g_capacity[MAX_DEVICES];  // co-resident blocks per device, 0 until known

// Blocks of pyramid_fused that fit on `device` at once (cached), or 0 with *err set.
int capacity(int device, cudaError_t* err) {
  if (device >= 0 && device < MAX_DEVICES) {
    const int known = g_capacity[device].load(std::memory_order_relaxed);
    if (known > 0) return known;
  }
  *err = cudaFuncSetAttribute(pyramid_fused, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(SMEM_BYTES));
  if (*err != cudaSuccess) return 0;
  int per_sm = 0, n_sm = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pyramid_fused, NT, SMEM_BYTES);
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (*err != cudaSuccess) return 0;
  if (per_sm < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  if (device >= 0 && device < MAX_DEVICES) g_capacity[device].store(per_sm * n_sm, std::memory_order_relaxed);
  return per_sm * n_sm;
}

}  // namespace

// The compiled design choices, read by the host plan (ops/pyramid_kernel.py):
// threads, box rows, box columns, buffer rows, buffer columns, record words,
// vertical-pass words, items, copies of the gain's partials.
extern "C" const int orb_pyramid_geometry[9] = {NT,  PYR_BOX_ROWS, PYR_BOX_COLS, PYR_BUF_ROWS,
                                                 PYR_BUF_COLS, REC, TW, ITEMS, COPIES};

// The exposure gain (when `part` is given) and every level of the pyramid
// from the h x w image `img` into `out` (`total` floats), in one cooperative
// launch on `stream` of CUDA device `device`. `table` (host memory) holds
// the box plan (rows and columns a box owns, the halo rows and columns, row
// bands, column bands, words of a row band's and a column band's record),
// then n_levels rows of (out_offset, h, w, taps_v, taps_h, v_at, rmax, h_at,
// cmax, t_at, t_cols): level 0 has 0 taps and the image's shape. `records` (n_records
// int32 words) holds every row band's record, then every column band's
// (ops/pyramid_kernel.py `_plan`). With `part` (n_part_words floats of
// scratch: 2 x copies x part_stride(ceil(h * w / 1024))) the image is first
// rescaled to a mean absolute deviation of `target`; with nullptr it is
// used as it is. Returns
// cudaErrorInvalidValue for a plan that does not fit the kernel, else the
// launch's error.
extern "C" int orb_pyramid(const float* img, int h, int w, float* part, int n_part_words, float target,
                           const int* records, int n_records, float* out, int total, const int* table,
                           int n_levels, int device, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(h) * w;
  if (n_levels < 1 || n_levels > MAX_LEVELS || h < 1 || w < 1 || n > (long long)CHUNK * CHUNK * CHUNK) return bad;
  Plan plan{};
  plan.n_levels = n_levels;
  plan.bh = table[0];
  plan.bw = table[1];
  plan.halo_r = table[2];
  plan.halo_c = table[3];
  plan.n_rb = table[4];
  plan.n_cb = table[5];
  plan.v_words = table[6];
  plan.h_words = table[7];
  if (plan.bh < 1 || plan.bw < 1 || plan.halo_r < 0 || plan.halo_c < 0 || plan.bh + plan.halo_r > PYR_BUF_ROWS ||
      plan.bw + plan.halo_c > PYR_BUF_COLS || plan.n_rb != (h + plan.bh - 1) / plan.bh ||
      plan.n_cb != (w + plan.bw - 1) / plan.bw || plan.v_words < 0 || plan.h_words < 0 || plan.v_words % 4 ||
      plan.h_words % 4 || plan.v_words + plan.h_words > REC ||
      (long long)plan.n_rb * plan.v_words + (long long)plan.n_cb * plan.h_words > n_records ||
      (long long)plan.n_rb * plan.n_cb >= (1LL << 31)) {
    return bad;
  }
  for (int l = 0; l < n_levels; ++l) {
    const int* row = table + HEAD + LEVEL_COLS * l;
    Level& L = plan.lv[l];
    L.off = row[0];
    L.h = row[1];
    L.w = row[2];
    L.tv = row[3];
    L.tw = row[4];
    L.v_at = row[5];
    L.rmax = row[6];
    L.h_at = row[7];
    L.cmax = row[8];
    L.t_at = row[9];
    L.t_cols = row[10];
    L.item0 = plan.n_items;
    if (l > 0) plan.n_items += L.rmax;
    if (L.h < 1 || L.w < 1 || L.off < 0 || (long long)L.off + (long long)L.h * L.w > total) return bad;
    if (l == 0) {
      if (L.tv != 0 || L.tw != 0 || L.h != h || L.w != w) return bad;
    } else if (L.tv < 1 || L.tv > plan.halo_r + 1 || L.tw < 1 || L.tw > plan.halo_c + 1 || L.v_at < 0 ||
               L.rmax < 0 || L.h_at < 0 || L.cmax < 0 || L.cmax > 32 * QH ||
               L.v_at + 2 + L.rmax * (1 + L.tv) > plan.v_words || L.h_at + 2 + L.cmax * (1 + L.tw) > plan.h_words ||
               L.t_at < 0 || L.t_cols < 1 || L.t_at + L.rmax * L.t_cols > TW) {
      return bad;
    }
  }
  if (plan.n_items > ITEMS) return bad;
  const int n_part = static_cast<int>((n + CHUNK - 1) / CHUNK);
  if (part != nullptr && n_part_words < 2LL * COPIES * part_stride(n_part)) return bad;

  int prev = -1;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int boxes = plan.n_rb * plan.n_cb;
  const int cap = capacity(device, &e);
  if (cap > 0) {
    const int want = part != nullptr && n_part > boxes ? n_part : boxes;
    const int grid = want < cap ? want : cap;
    void* args[] = {&img, &h, &w, &part, &target, &records, &out, &plan};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(pyramid_fused), dim3(grid), dim3(NT), args,
                                    SMEM_BYTES, static_cast<cudaStream_t>(stream));
  }
  const cudaError_t last = cudaGetLastError();  // leave no error behind for the next launch
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(e != cudaSuccess ? e : last);
}
