// Fused ORB frontend over a whole image pyramid in one launch: 9-tap
// separable Gaussian blur, dual-threshold FAST-9 score maps and 3x3
// non-maximum suppression for every level.
//
// Replaces: the Pallas kernel `fused_frontend` / `_kernel` in
// orbslam2commentedbyxcm_tpu/ops/pallas_frontend.py, which the JAX package
// calls once per level. Semantics are those of the JAX package's XLA path
// (ops/orb.py `_separable_blur`, `_fast_maps`, `_nms3`), which is what the
// torch twin (ops/orb.py) computes:
//   * blur: replicate padding for both passes; every tap is a separately
//     rounded multiply and add in tap order (__fmul_rn / __fadd_rn), so the
//     result is bit-equal to the twin; an FMA would round differently;
//   * FAST: V = max over the 16 ring windows of 9 of min(ring - center) and of
//     min(center - ring); scores V > th_hi and V > th_lo, zero outside
//     [3, H-3) x [3, W-3); min/max are exact, so the maps are bit-equal;
//   * NMS: keep s where s >= its 3x3 max (-inf outside the image) and s > 0.
//
// What bounds it on an H100 80GB HBM3 (700 W): memory traffic. Per pixel it
// reads 4 bytes and writes 12; a 640x480 8-level pyramid is 950,532 pixels,
// 15.2 MB, 4.5 us at 3.35 TB/s. The arithmetic is at most ~240 operations per
// pixel, 3.4 us at 67 TFLOP/s, and ~100 per pixel on real images (chip_smoke.py
// `k1_ops` counts what the compass test lets through).
//
// Design:
//   * One launch for all levels. The level images lie in one flat buffer,
//     each starting on a 128-byte line (ops/frontend_kernel.level_table);
//     the host passes each level's offset, H and W, and the launcher adds
//     its tiles in x and first tile to the level table it passes by value.
//     The table maps the flat 1-D grid onto the tiles of every level, and
//     each block finds its level by a scan over at most 16 entries. This
//     removes the per-level launches and their host work, and the small
//     levels no longer run as separate under-filled grids.
//   * One block per TW x TH output tile stages the tile plus a 4-pixel halo
//     (the widest stencil: blur radius 4; FAST ring 3 + NMS 1) in shared
//     memory once, issuing all of a thread's loads before its first store,
//     runs both blur passes and the FAST test from shared memory, keeps the
//     two score tiles (with their 1-pixel NMS ring) in shared memory, and
//     writes only the three output maps. Loads are clamped (the replicate
//     padding the blur needs, which TMA's zero fill would not give), stores
//     masked at ragged edges. The tile is 64x32, chosen by measurement
//     (tools/profile_kernels.py builds 32x16, 64x16 and 128x16 through
//     -DK1_TILE_W / -DK1_TILE_H to compare, PERF.md): at 640x480 it ties
//     64x16 and beats 32x16 and 128x16, and it is the fastest at 1241x376.
//     Its halo costs 1.41x the tile's pixels, against 1.88x at 32x16.
//   * FAST by doubling over the circular ring: windowed min and max of 2, 4,
//     8 then 9 samples, ~145 min/max per pixel where 16 direct windows of 9
//     take ~290. An exact early exit tests the four compass samples first;
//     about one pixel in eight passes it, but most warps hold one, so the
//     passing pixels are appended to a shared list (one atomic per warp)
//     and the full response runs over that list with every lane busy.
//   * The taps live in __constant__ memory, set once per device
//     (orb_frontend_set_taps), not passed per launch.
// Measured per extraction at 640x480: 20.9 us (PERF.md), against 58.8 us
// for the earlier design, one launch of 32x16 tiles per level, on the same
// card. What is left: all blocks run in one wave, so the staging loads and
// the final stores do not overlap the arithmetic, and the blur and NMS read
// shared memory ~45 times per pixel.

#include <cuda_runtime.h>
#include <math.h>

#ifndef K1_TILE_W
#define K1_TILE_W 64
#endif
#ifndef K1_TILE_H
#define K1_TILE_H 32
#endif

namespace {

constexpr int TW = K1_TILE_W;   // output tile width
constexpr int TH = K1_TILE_H;   // output tile height
constexpr int R = 4;            // staged halo
constexpr int NT = 256;         // threads per block
constexpr int MAX_LEVELS = 16;  // entries of the level table
constexpr int TABLE_COLS = 3;   // offset, h, w (host layout)
static_assert((TH + 2) * (TW + 2) <= 65536, "s_list indexes the score tile with 16 bits");

__constant__ float c_taps[9];

struct LevelTable {
  int n;
  int off[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int tiles_x[MAX_LEVELS];
  int tile0[MAX_LEVELS];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The exact early exit of FAST: true when the pixel staged at (sy, sx) may
// score above th. Any 9 contiguous ring samples hold two of the four
// compass samples (ring 0, 4, 8, 12), so when fewer than two pass th in
// either direction, V <= th.
template <int SW>
__device__ __forceinline__ bool compass_pass(const float (*s)[SW], int sy, int sx, float th) {
  const float c = s[sy][sx];
  const float q0 = s[sy - 3][sx] - c, q4 = s[sy][sx + 3] - c;
  const float q8 = s[sy + 3][sx] - c, q12 = s[sy][sx - 3] - c;
  const int nb = (q0 > th) + (q4 > th) + (q8 > th) + (q12 > th);
  const int nd = (-q0 > th) + (-q4 > th) + (-q8 > th) + (-q12 > th);
  return nb >= 2 || nd >= 2;
}

// FAST-9 response V of the pixel staged at (sy, sx): the largest threshold
// at which it is still a corner (bright or dark arc of 9 contiguous samples).
template <int SW>
__device__ __forceinline__ float fast_v(const float (*s)[SW], int sy, int sx) {
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const float c = s[sy][sx];
  float d[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) d[j] = s[sy + dy[j]][sx + dx[j]] - c;
  // windowed min (bright arcs) and max (dark arcs) by doubling: 2, 4, 8, 9
  float mn[16], mx[16], tn[16], tx[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    mn[k] = fminf(d[k], d[(k + 1) & 15]);
    mx[k] = fmaxf(d[k], d[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    tn[k] = fminf(mn[k], mn[(k + 2) & 15]);
    tx[k] = fmaxf(mx[k], mx[(k + 2) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    mn[k] = fminf(tn[k], tn[(k + 4) & 15]);
    mx[k] = fmaxf(tx[k], tx[(k + 4) & 15]);
  }
  float bright = -INFINITY, dark_max = INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    bright = fmaxf(bright, fminf(mn[k], d[(k + 8) & 15]));
    dark_max = fminf(dark_max, fmaxf(mx[k], d[(k + 8) & 15]));
  }
  // max_k min_j(-d_j) = -(min_k max_j d_j), exactly
  return fmaxf(bright, -dark_max);
}

__global__ void __launch_bounds__(NT) frontend_kernel(
    const float* __restrict__ img, float* __restrict__ out, int total, LevelTable tab,
    float th_hi, float th_lo) {
  constexpr int SW = TW + 2 * R;  // staged image width
  constexpr int SH = TH + 2 * R;  // staged image height
  __shared__ float s_img[SH][SW];
  __shared__ float s_hb[SH][TW];
  __shared__ float s_hi[TH + 2][TW + 2];
  __shared__ float s_lo[TH + 2][TW + 2];
  __shared__ unsigned short s_list[(TH + 2) * (TW + 2)];  // score-tile pixels past the compass test
  __shared__ int s_count;
  const int tid = threadIdx.x;
  const int bid = blockIdx.x;

  int l = 0;
  while (l + 1 < tab.n && bid >= tab.tile0[l + 1]) ++l;
  const int h = tab.h[l], w = tab.w[l];
  const int local = bid - tab.tile0[l];
  const int x0 = (local % tab.tiles_x[l]) * TW;
  const int y0 = (local / tab.tiles_x[l]) * TH;
  const float* __restrict__ src = img + tab.off[l];

  // Stage the tile + halo; clamping the coordinates is the replicate padding.
  // All of a thread's loads are issued before its first store, so their
  // latencies overlap.
  constexpr int N_STAGE = (SH * SW + NT - 1) / NT;
  float v[N_STAGE];
#pragma unroll
  for (int k = 0; k < N_STAGE; ++k) {
    const int i = tid + k * NT;
    const int sy = i / SW, sx = i % SW;
    const int gy = clampi(y0 + sy - R, 0, h - 1);
    const int gx = clampi(x0 + sx - R, 0, w - 1);
    v[k] = i < SH * SW ? __ldg(src + (size_t)gy * w + gx) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < N_STAGE; ++k) {
    const int i = tid + k * NT;
    if (i < SH * SW) s_img[i / SW][i % SW] = v[k];
  }
  if (tid == 0) s_count = 0;
  __syncthreads();

  // Horizontal blur pass for every staged row (the vertical pass needs the
  // halo rows too; a clamped halo row is the clamped row's horizontal blur).
#pragma unroll
  for (int k = 0; k < (SH * TW + NT - 1) / NT; ++k) {
    const int i = tid + k * NT;
    if (i >= SH * TW) break;
    const int sy = i / TW, c = i % TW;
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 9; ++t) acc = __fadd_rn(acc, __fmul_rn(c_taps[t], s_img[sy][c + t]));
    s_hb[sy][c] = acc;
  }

  // FAST score tiles over the output tile plus the 1-pixel NMS ring, in two
  // passes: the compass test on every pixel, which settles the border, the
  // outside and most of the interior, and appends the rest to s_list (one
  // atomic per warp); then the full response over that list, so no lane of
  // a warp idles while another computes it.
  constexpr int NPX = (TH + 2) * (TW + 2);
  const float th = fminf(th_hi, th_lo);
  const int lane = tid & 31;
#pragma unroll 1
  for (int k = 0; k < (NPX + NT - 1) / NT; ++k) {
    const int i = tid + k * NT;
    const int sy = i / (TW + 2), sx = i % (TW + 2);
    const int gy = y0 + sy - 1, gx = x0 + sx - 1;
    bool full = false;
    if (i < NPX) {
      float score;
      if (gy < 0 || gy >= h || gx < 0 || gx >= w) {
        score = -INFINITY;
      } else if (gy < 3 || gy >= h - 3 || gx < 3 || gx >= w - 3) {
        score = 0.0f;
      } else {
        full = compass_pass<SW>(s_img, sy + R - 1, sx + R - 1, th);
        score = 0.0f;  // V <= th unless full
      }
      s_hi[sy][sx] = score;
      s_lo[sy][sx] = score;
    }
    const unsigned m = __ballot_sync(0xffffffffu, full);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&s_count, __popc(m));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (full) s_list[base + __popc(m & ((1u << lane) - 1))] = static_cast<unsigned short>(i);
  }
  __syncthreads();
  const int n_full = s_count;
  for (int j = tid; j < n_full; j += NT) {
    const int i = s_list[j];
    const int sy = i / (TW + 2), sx = i % (TW + 2);
    const float v = fast_v<SW>(s_img, sy + R - 1, sx + R - 1);
    s_hi[sy][sx] = v > th_hi ? v : 0.0f;
    s_lo[sy][sx] = v > th_lo ? v : 0.0f;
  }
  __syncthreads();

  float* __restrict__ blur = out + tab.off[l];
  float* __restrict__ nms_hi = blur + total;
  float* __restrict__ nms_lo = nms_hi + total;
  for (int i = tid; i < TH * TW; i += NT) {
    const int ry = i / TW, c = i % TW;
    const int gy = y0 + ry, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    const size_t o = (size_t)gy * w + gx;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) acc = __fadd_rn(acc, __fmul_rn(c_taps[k], s_hb[ry + k][c]));
    blur[o] = acc;
    float mh = -INFINITY, ml = -INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        mh = fmaxf(mh, s_hi[ry + a][c + b]);
        ml = fmaxf(ml, s_lo[ry + a][c + b]);
      }
    }
    const float sh = s_hi[ry + 1][c + 1], sl = s_lo[ry + 1][c + 1];
    nms_hi[o] = (sh >= mh && sh > 0.0f) ? sh : 0.0f;
    nms_lo[o] = (sl >= ml && sl > 0.0f) ? sl : 0.0f;
  }
}

}  // namespace

// Copies the 9 blur taps into constant memory on the current device and
// waits for the copy; returns the CUDA error code (0 on success).
extern "C" int orb_frontend_set_taps(const float* taps_host) {
  cudaError_t e = cudaMemcpyToSymbol(c_taps, taps_host, 9 * sizeof(float));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return static_cast<int>(e);
}

// One launch over every level of `table` (n_levels rows of offset, h, w in
// host memory) on `stream`. `levels` holds the level images (`total`
// floats); `out` receives blur, nms_hi and nms_lo, each in the same layout,
// one after the other (3 * total floats). Returns cudaErrorInvalidValue for
// a table whose levels are smaller than 7x7 or do not fit in `total`, else
// cudaGetLastError() (0 on success).
extern "C" int orb_frontend_pyramid(const float* levels, float* out, int total, const int* table,
                                    int n_levels, float th_hi, float th_lo, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  LevelTable tab;
  tab.n = n_levels;
  int n_tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int* row = table + TABLE_COLS * l;
    tab.off[l] = row[0];
    tab.h[l] = row[1];
    tab.w[l] = row[2];
    if (tab.h[l] < 7 || tab.w[l] < 7 || tab.off[l] < 0 ||
        (long long)tab.off[l] + (long long)tab.h[l] * tab.w[l] > total) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tab.tiles_x[l] = (tab.w[l] + TW - 1) / TW;
    tab.tile0[l] = n_tiles;
    n_tiles += tab.tiles_x[l] * ((tab.h[l] + TH - 1) / TH);
  }
  frontend_kernel<<<n_tiles, NT, 0, static_cast<cudaStream_t>(stream)>>>(levels, out, total, tab, th_hi, th_lo);
  return static_cast<int>(cudaGetLastError());
}
