// The ORB extractor's exposure gain and image pyramid: every level of an
// 8-level (or up to 16-level) pyramid in one launch, written straight into
// the flat level buffer that the frontend kernel (frontend.cu) reads.
//
// Replaces: XLA code of the JAX package, not a Pallas kernel: the gain at
// orbslam2commentedbyxcm_tpu/ops/orb.py:317-330 (jnp.mean of the image and
// of its absolute deviation) and the resize `wh @ img @ ww.T` at :337-339,
// two dense float32 matrix products per level. The port ran those as 14
// torch.matmul calls (cuBLAS) per extraction and its CPU twin through the
// CPU's BLAS: sums in an order of each library's own, so the card and the
// CPU built level images that differed by ulps and selected other
// keypoints. Here every sum has one fixed order, and the torch twin
// (ops/orb.py `_pyramid_plain`, `_exposure_gain`, `_tree_sum`) computes the
// same bits on either device:
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
//
// The trees, block by block: a block of 1024 threads sums 1024 consecutive
// values, which is one aligned subtree (warp shuffles at offsets 1, 2, 4, 8,
// 16 pair neighbours, then the same over the 32 warp sums), into one partial
// per block. Whoever needs the total reduces the partials the same way, in
// chunks of 1024. A tree padded to a larger power of two differs from the
// twin's only in the sign of an all-(-0) sum, which changes no output.
//
// What bounds it on an H100 80GB HBM3 (700 W): memory traffic. The whole
// function must read the image once and write the 8 levels once: at
// 640x480, 1.23 MB + 3.80 MB, 1.5 us at 3.35 TB/s. The resize does ~3.6 M
// fused multiply-adds there (3-8 nonzero taps per output and axis), 0.1 us
// at 67 TFLOP/s. The dense products it replaces did ~0.94 G.
//
// Design (simple first): three launches per extraction with the gain, one
// without. (1) and (2) are one kernel, `gain_sum`, for the sum of the image
// and then of |x - mu| (each block reduces the first launch's partials to
// mu itself). (3) `pyramid_resize`: one block per tile of RB output rows x
// CW output columns of one level, over a flat grid of every level's tiles
// (level 0 is the gained copy of the image). Each block reduces the
// partials to mu and gain, applies the gain to each input pixel it reads,
// runs the vertical pass for its rows over the input columns that its
// columns' taps touch into shared memory (float32-rounded, as the twin's
// intermediate), then the horizontal pass from there. The image (1.2 MB)
// stays in L2 across the blocks that read it.
// Measured per 640x480 extraction on an H100 80GB HBM3 (700 W), chip_smoke.py
// phase 3: 26.2-26.4 us of device time with the gain (3 launches), 16.6-16.8
// us without, against 180.2 us for the 28 device kernels of the 14
// torch.matmul calls it replaced: 5.7% of the byte bound. Not yet tuned: every resize block reduces the ~300
// partials of both sums itself, and the gain takes two launches of its own.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int TABLE_COLS = 9;    // host layout, see orb_pyramid_resize
constexpr int CHUNK = 1024;      // values per block of the gain sums, and per chunk of partials
constexpr int RB = 8;            // output rows of a resize tile
constexpr int CW = 64;           // output columns of a resize tile
constexpr int NT = 256;          // threads of a resize block

struct Level {
  int off, h, w;          // output offset in the flat buffer, output shape
  int tv, tw;             // taps per output: vertical, horizontal (0: level 0, the copy)
  int vs, vw, hs, hw;     // offsets of the start and weight tables (ints / floats)
  int tiles_x, tile0;     // tiles across, first tile of the level in the flat grid
};

struct Table {
  int n;
  Level lv[MAX_LEVELS];
};

// Adjacent-pair tree over the N values held one per thread (thread order);
// every thread returns the root. All N threads must call it together.
template <int N>
__device__ float block_tree(float v, float* s_warp) {
  static_assert(N % 32 == 0 && N <= 1024, "one value per thread of a block of whole warps");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  __syncthreads();  // s_warp may still be read by a previous call
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < N / 32 ? s_warp[lane] : 0.0f;
#pragma unroll
    for (int o = 1; o < N / 32; o <<= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) s_warp[32] = v;
  }
  __syncthreads();
  return s_warp[32];
}

// The tree over src[0, n) zero-padded to CHUNK values, with N threads (each
// takes CHUNK / N consecutive values and sums them as a subtree first).
template <int N>
__device__ float chunk_tree(const float* src, int n, float* s_warp) {
  constexpr int G = CHUNK / N;
  float v[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int i = threadIdx.x * G + g;
    v[g] = i < n ? src[i] : 0.0f;
  }
#pragma unroll
  for (int s = 1; s < G; s <<= 1) {
#pragma unroll
    for (int g = 0; g + s < G; g += 2 * s) v[g] = __fadd_rn(v[g], v[g + s]);
  }
  return block_tree<N>(v[0], s_warp);
}

// The sum of the n_part block partials of a CHUNK-block tree: each chunk of
// CHUNK partials is one subtree, then the chunk sums (at most CHUNK, checked
// by the launchers) are summed the same way.
template <int N>
__device__ float sum_partials(const float* part, int n_part, float* s_warp, float* s_chunk) {
  const int n_chunks = (n_part + CHUNK - 1) / CHUNK;
  if (n_chunks == 1) return chunk_tree<N>(part, n_part, s_warp);
  for (int c = 0; c < n_chunks; ++c) {
    const float r = chunk_tree<N>(part + c * CHUNK, n_part - c * CHUNK, s_warp);
    if (threadIdx.x == 0) s_chunk[c] = r;
  }
  __syncthreads();
  return chunk_tree<N>(s_chunk, n_chunks, s_warp);
}

struct Gain {
  float mu, gain;
};

template <int N>
__device__ Gain gain_of(const float* mean_part, const float* mad_part, int n_part, int n, float target,
                        float* s_warp, float* s_chunk) {
  const float count = static_cast<float>(n);
  Gain g;
  g.mu = __fdiv_rn(sum_partials<N>(mean_part, n_part, s_warp, s_chunk), count);
  const float mad = __fdiv_rn(sum_partials<N>(mad_part, n_part, s_warp, s_chunk), count);
  g.gain = fminf(fmaxf(__fdiv_rn(target, fmaxf(mad, 1e-3f)), 0.125f), 8.0f);
  return g;
}

__device__ __forceinline__ float apply_gain(float x, Gain g) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, g.mu), g.gain), g.mu);
}

// One CHUNK-value subtree per block: of the image (mean_part == nullptr), or
// of |x - mu| with mu from the first launch's partials.
__global__ void __launch_bounds__(CHUNK) gain_sum(const float* __restrict__ img, int n,
                                                  const float* __restrict__ mean_part, int n_part,
                                                  float* __restrict__ out_part) {
  __shared__ float s_warp[33];
  __shared__ float s_chunk[CHUNK];
  float mu = 0.0f;
  if (mean_part != nullptr) {
    mu = __fdiv_rn(sum_partials<CHUNK>(mean_part, n_part, s_warp, s_chunk), static_cast<float>(n));
  }
  const long long i = static_cast<long long>(blockIdx.x) * CHUNK + threadIdx.x;
  float v = 0.0f;
  if (i < n) v = mean_part == nullptr ? img[i] : fabsf(__fsub_rn(img[i], mu));
  const float r = block_tree<CHUNK>(v, s_warp);
  if (threadIdx.x == 0) out_part[blockIdx.x] = r;
}

__global__ void __launch_bounds__(NT) pyramid_resize(
    const float* __restrict__ img, int h, int w, const float* __restrict__ mean_part,
    const float* __restrict__ mad_part, int n_part, float target, const int* __restrict__ starts,
    const float* __restrict__ weights, float* __restrict__ out, Table tab) {
  extern __shared__ float s_t[];  // RB x window of the vertical pass
  __shared__ float s_warp[33];
  __shared__ float s_chunk[CHUNK];
  const int tid = threadIdx.x;
  const int bid = blockIdx.x;

  int l = 0;
  while (l + 1 < tab.n && bid >= tab.lv[l + 1].tile0) ++l;
  const Level L = tab.lv[l];
  const int local = bid - L.tile0;
  const int r0 = (local / L.tiles_x) * RB;
  const int j0 = (local % L.tiles_x) * CW;
  const bool gained = mean_part != nullptr;
  Gain g{0.0f, 1.0f};
  if (gained) g = gain_of<NT>(mean_part, mad_part, n_part, h * w, target, s_warp, s_chunk);
  float* __restrict__ dst = out + L.off;

  if (L.tv == 0) {  // level 0: the (gained) image
    for (int i = tid; i < RB * CW; i += NT) {
      const int y = r0 + i / CW, x = j0 + i % CW;
      if (y < L.h && x < L.w) {
        const float v = img[(size_t)y * w + x];
        dst[(size_t)y * L.w + x] = gained ? apply_gain(v, g) : v;
      }
    }
    return;
  }

  // Input columns the tile's horizontal taps read: starts are ascending.
  const int* __restrict__ hs = starts + L.hs;
  const int j_last = min(j0 + CW, L.w) - 1;
  const int c_lo = hs[j0];
  const int win = hs[j_last] + L.tw - c_lo;

  // Vertical pass: s_t[i][c] for the tile's rows and those columns.
  const int* __restrict__ vs = starts + L.vs;
  const float* __restrict__ vw = weights + L.vw;
  for (int i = tid; i < RB * win; i += NT) {
    const int r = i / win, c = i % win;
    const int y = r0 + r;
    if (y >= L.h) continue;
    const float* __restrict__ src = img + (size_t)vs[y] * w + c_lo + c;
    const float* __restrict__ wy = vw + (size_t)y * L.tv;
    float acc = 0.0f;
    for (int k = 0; k < L.tv; ++k) {
      const float x = src[(size_t)k * w];
      acc = __fmaf_rn(wy[k], gained ? apply_gain(x, g) : x, acc);
    }
    s_t[r * win + c] = acc;
  }
  __syncthreads();

  // Horizontal pass from shared memory.
  const float* __restrict__ hw = weights + L.hw;
  for (int i = tid; i < RB * CW; i += NT) {
    const int r = i / CW, j = j0 + i % CW;
    const int y = r0 + r;
    if (y >= L.h || j >= L.w) continue;
    const float* __restrict__ t = s_t + r * win + (hs[j] - c_lo);
    const float* __restrict__ wx = hw + (size_t)j * L.tw;
    float acc = 0.0f;
    for (int k = 0; k < L.tw; ++k) acc = __fmaf_rn(wx[k], t[k], acc);
    dst[(size_t)y * L.w + j] = acc;
  }
}

}  // namespace

// The two tree sums of the exposure gain over the n floats of `img`, on
// `stream`: mean_part[b] and mad_part[b] receive block b's subtree of the
// image and of |x - mu|, for b < ceil(n / 1024). Two launches. Returns
// cudaErrorInvalidValue when n is not in [1, 2^30], else cudaGetLastError().
extern "C" int orb_gain_stats(const float* img, int n, float* mean_part, float* mad_part, void* stream) {
  if (n < 1 || n > CHUNK * CHUNK * CHUNK) return static_cast<int>(cudaErrorInvalidValue);
  const int n_part = (n + CHUNK - 1) / CHUNK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gain_sum<<<n_part, CHUNK, 0, s>>>(img, n, nullptr, n_part, mean_part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gain_sum<<<n_part, CHUNK, 0, s>>>(img, n, mean_part, n_part, mad_part);
  return static_cast<int>(cudaGetLastError());
}

// Every level of `table` (n_levels rows of out_offset, h, w, taps_v,
// taps_h, vstart, vweight, hstart, hweight in host memory; level 0 has 0
// taps and the image's shape) from the h x w image `img`, into `out`
// (`total` floats) on `stream`, one launch. `starts` and `weights` hold the
// tap tables the rows point into. With mean_part and mad_part (from
// orb_gain_stats on the same image) the image is first rescaled to a mean
// absolute deviation of `target`; with nullptr it is used as it is.
// `max_win` bounds the input columns of one tile's vertical pass (the
// shared memory it takes is RB x max_win floats). Returns
// cudaErrorInvalidValue for a table that does not fit, else
// cudaGetLastError().
extern "C" int orb_pyramid_resize(const float* img, int h, int w, const float* mean_part, const float* mad_part,
                                  float target, const int* starts, const float* weights, float* out, int total,
                                  const int* table, int n_levels, int max_win, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || h < 1 || w < 1 || max_win < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(h) * w;
  if (n > (long long)CHUNK * CHUNK * CHUNK) return static_cast<int>(cudaErrorInvalidValue);
  Table tab;
  tab.n = n_levels;
  int n_tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int* row = table + TABLE_COLS * l;
    Level& L = tab.lv[l];
    L.off = row[0];
    L.h = row[1];
    L.w = row[2];
    L.tv = row[3];
    L.tw = row[4];
    L.vs = row[5];
    L.vw = row[6];
    L.hs = row[7];
    L.hw = row[8];
    if (L.h < 1 || L.w < 1 || L.off < 0 || (long long)L.off + (long long)L.h * L.w > total ||
        (l == 0) != (L.tv == 0) || (l == 0 && (L.h != h || L.w != w)) || L.tv < 0 || L.tw < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    L.tiles_x = (L.w + CW - 1) / CW;
    L.tile0 = n_tiles;
    n_tiles += L.tiles_x * ((L.h + RB - 1) / RB);
  }
  const size_t smem = sizeof(float) * RB * (size_t)max_win;
  if (smem > 40 * 1024) {  // with the static arrays, past the 48 KB default
    cudaError_t e = cudaFuncSetAttribute(pyramid_resize, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_part = static_cast<int>((n + CHUNK - 1) / CHUNK);
  pyramid_resize<<<n_tiles, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      img, h, w, mean_part, mad_part, n_part, target, starts, weights, out, tab);
  return static_cast<int>(cudaGetLastError());
}
