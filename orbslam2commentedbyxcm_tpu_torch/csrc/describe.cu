// The ORB extractor's orientation and rotated BRIEF descriptors for every
// selected keypoint of the pyramid, in one launch.
//
// Replaces: XLA code of the JAX package, not a Pallas kernel: the panel
// gathers and one-hot MXU contractions of
// orbslam2commentedbyxcm_tpu/ops/descriptors.py:40-134 (a fused Pallas
// kernel of them was rejected on the TPU, where Mosaic serialized the small
// dots), which the port ran as plain torch gathers and a float32 matvec.
// Its twin, ops/descriptors.py `describe_plain`, computes the same bits: the
// same separately rounded float32 operations in the same order
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn, rintf: nothing
// is contracted into an fma, and no libdevice function is called).
//
// Per slot j (px, py level coordinates from the select kernel, its level l
// given by the slot ranges of the table):
//   * patch[i][c] = bf16_rne(blurred_l[reflect(py - 24 + i)][reflect(px -
//     24 + c)]), i, c in 0..47, reflect as numpy's mode="reflect";
//   * m10, m01: the terms p k of the 31 x 31 moment window (patch rows and
//     columns 9..39), zero-padded to 32 x 32; per column the halving tree
//     over the rows (x[:16] + x[16:], then [:8] + [8:], ...), then the
//     halving tree over the columns;
//   * angle = atan2_f32(m01, m10) (below; the twin's `atan2_f32`);
//     r = sqrt(m10^2 + m01^2), (ca, sa) = (m10, m01) / r where r > 0, else
//     (1, 0);
//   * pair q of the (256, 4) pattern (x0, y0, x1, y1): each endpoint
//     rotated, rx = rint(x ca - y sa) + 24, ry = rint(x sa + y ca) + 24
//     (half to even), its value patch[ry][rx] inside the patch else 0; bit
//     q = v0 < v1; bit b of word w is bit 32 w + b;
//   * uv = (px, py) * scale_l, angle, level l and the 8 words.
//
// What bounds it on an H100 (700 W): the bytes. The patches overlap, so
// the function must read the union of the pixels they cover (at most the
// blurred pyramid, 3.8 MB at 640x480) once, and write 48 bytes a slot:
// at most 1.2 us at 3.35 TB/s for 1000 keypoints; their ~7000 operations
// each take 0.1 us at 67 TFLOP/s.
//
// Design: one warp per keypoint (grid-stride over the slots), NW warps a
// block. The block stages the pattern (as float4s) and the two moment
// windows in shared memory once. A warp stages its patch as bf16 in shared
// memory (rows of 50 halves), lane c < 31 sums moment column c in
// registers, a 5-step shuffle butterfly sums the columns, and every lane
// then holds m10, m01 and the angle. Lane
// b samples pair 32 w + b for word w; a ballot packs each word. Lanes 0..7
// write the words, lane 0 the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int NW = 4;  // warps of a block, one keypoint each at a time
constexpr int NT = 32 * NW;
constexpr int PATCH = 48;
constexpr int HALF = 24;
constexpr int STRIDE = 50;  // halves of a staged patch row
constexpr int MLO = 9;      // first patch row / column of the moment window
constexpr int MN = 31;      // the moment window's side
constexpr int PAIRS = 256;
constexpr int LEVEL_COLS = 5;  // host layout, see orb_describe
constexpr unsigned FULL = 0xffffffffu;

struct Level {
  int off, h, w;  // the level in the blurred buffer's flat layout
  int slot_off, budget;
  float scale;
};

struct Plan {
  int n_levels, cap;
  Level lv[MAX_LEVELS];
};

// Cephes atanf's polynomial and the reduction constants, float32 (the twin's
// _ATAN_P, _TAN_PI_8, _PI_4, _PI_2, _PI).
constexpr float ATAN_C0 = 8.0537446e-02f;
constexpr float ATAN_C1 = -1.3877685e-01f;
constexpr float ATAN_C2 = 1.9977711e-01f;
constexpr float ATAN_C3 = -3.333295e-01f;
constexpr float TAN_PI_8 = 4.1421357e-01f;
constexpr float PI_4 = 7.853982e-01f;
constexpr float PI_2 = 1.5707964e+00f;
constexpr float PI_F = 3.1415927e+00f;

// atan2 in float32 multiplies, adds, divides and compares, each rounded on
// its own: the ratio of the smaller to the larger magnitude in [0, 1],
// reduced past tan(pi/8) by (t - 1) / (t + 1) + pi/4, Cephes' polynomial,
// then the octant and quadrant of (x, y). Signed zeros as IEEE atan2.
__device__ __forceinline__ float atan2_f32(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const float t = mx > 0.f ? __fdiv_rn(mn, mx) : 0.f;
  const bool big = t > TAN_PI_8;
  const float u = big ? __fdiv_rn(__fsub_rn(t, 1.f), __fadd_rn(t, 1.f)) : t;
  const float z = __fmul_rn(u, u);
  float p = __fmul_rn(z, ATAN_C0);
  p = __fmul_rn(__fadd_rn(p, ATAN_C1), z);
  p = __fmul_rn(__fadd_rn(p, ATAN_C2), z);
  p = __fmul_rn(__fadd_rn(p, ATAN_C3), z);
  float a = __fadd_rn(__fmul_rn(p, u), u);
  if (big) a = __fadd_rn(a, PI_4);
  if (ay > ax) a = __fsub_rn(PI_2, a);
  if (__float_as_uint(x) >> 31) a = __fsub_rn(PI_F, a);  // sign bits: -0 counts as negative
  return __float_as_uint(y) >> 31 ? -a : a;
}

// numpy's mode="reflect" source index of position i of an axis of n >= 2
__device__ __forceinline__ int reflect(int i, int n) {
  const int period = 2 * (n - 1);
  int r = i % period;
  if (r < 0) r += period;
  return r >= n ? period - r : r;
}

__device__ __forceinline__ float bf16_value(unsigned short h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

// the patch value at the rotated, rounded pattern point (x, y), 0 outside
__device__ __forceinline__ float sample(const unsigned short* patch, float x, float y, float ca, float sa) {
  const int rx = static_cast<int>(rintf(__fsub_rn(__fmul_rn(x, ca), __fmul_rn(y, sa)))) + HALF;
  const int ry = static_cast<int>(rintf(__fadd_rn(__fmul_rn(x, sa), __fmul_rn(y, ca)))) + HALF;
  if (rx < 0 || rx >= PATCH || ry < 0 || ry >= PATCH) return 0.f;
  return bf16_value(patch[ry * STRIDE + rx]);
}

// one step of the halving trees: t[r] += t[r + H] for r < H (H a
// compile-time constant, so both arrays stay in registers)
template <int H>
__device__ __forceinline__ void halve(float (&a)[32], float (&b)[32]) {
#pragma unroll
  for (int r = 0; r < H; ++r) {
    a[r] = __fadd_rn(a[r], a[r + H]);
    b[r] = __fadd_rn(b[r], b[r + H]);
  }
}

__global__ void __launch_bounds__(NT) describe_fused(const float* __restrict__ blurred, Plan plan_in,
                                                     const int* __restrict__ pxy, const float4* __restrict__ pattern,
                                                     const float* __restrict__ moments, float* uv, float* angle,
                                                     int* level, int* desc) {
  __shared__ Plan plan;
  __shared__ float4 s_pat[PAIRS];
  __shared__ float s_mom[2 * MN * MN];
  __shared__ unsigned short s_patch[NW][PATCH * STRIDE];
  if (threadIdx.x == 0) plan = plan_in;
  for (int i = threadIdx.x; i < PAIRS; i += NT) s_pat[i] = pattern[i];
  for (int i = threadIdx.x; i < 2 * MN * MN; i += NT) s_mom[i] = moments[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned short* patch = s_patch[warp];

  for (int j = blockIdx.x * NW + warp; j < plan.cap; j += gridDim.x * NW) {
    int l = 0;
    while (j >= plan.lv[l].slot_off + plan.lv[l].budget) ++l;
    const Level& L = plan.lv[l];
    const int px = pxy[j], py = pxy[plan.cap + j];
    const float* img = blurred + L.off;
    const int c0 = reflect(px - HALF + lane, L.w);
    const int c1 = lane < PATCH - 32 ? reflect(px - HALF + 32 + lane, L.w) : 0;
    __syncwarp();  // the previous keypoint's samples are read
    for (int i = 0; i < PATCH; ++i) {
      const float* row = img + reflect(py - HALF + i, L.h) * L.w;
      patch[i * STRIDE + lane] = __bfloat16_as_ushort(__float2bfloat16_rn(__ldg(row + c0)));
      if (lane < PATCH - 32) patch[i * STRIDE + 32 + lane] = __bfloat16_as_ushort(__float2bfloat16_rn(__ldg(row + c1)));
    }
    __syncwarp();

    // moments: lane c holds column c of the window (rows 0..30, a zero
    // row 31; lane 31 zeros), sums it as a halving tree, then the lanes as
    // a butterfly: every lane ends with the same m10 and m01
    float t10[32], t01[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      t10[r] = 0.f;
      t01[r] = 0.f;
      if (r < MN && lane < MN) {
        const float p = bf16_value(patch[(MLO + r) * STRIDE + MLO + lane]);
        t10[r] = __fmul_rn(p, s_mom[r * MN + lane]);
        t01[r] = __fmul_rn(p, s_mom[MN * MN + r * MN + lane]);
      }
    }
    halve<16>(t10, t01);
    halve<8>(t10, t01);
    halve<4>(t10, t01);
    halve<2>(t10, t01);
    halve<1>(t10, t01);
    float m10 = t10[0], m01 = t01[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m10 = __fadd_rn(m10, __shfl_xor_sync(FULL, m10, o));
      m01 = __fadd_rn(m01, __shfl_xor_sync(FULL, m01, o));
    }
    const float ang = atan2_f32(m01, m10);
    const float rad = __fsqrt_rn(__fadd_rn(__fmul_rn(m10, m10), __fmul_rn(m01, m01)));
    const bool safe = rad > 0.f;
    const float ca = safe ? __fdiv_rn(m10, rad) : 1.f;
    const float sa = safe ? __fdiv_rn(m01, rad) : 0.f;

    int word = 0;
#pragma unroll
    for (int w = 0; w < PAIRS / 32; ++w) {
      const float4 q = s_pat[32 * w + lane];
      const bool bit = sample(patch, q.x, q.y, ca, sa) < sample(patch, q.z, q.w, ca, sa);
      const int bits = static_cast<int>(__ballot_sync(FULL, bit));
      if (lane == w) word = bits;
    }
    if (lane < PAIRS / 32) desc[8 * j + lane] = word;
    if (lane == 0) {
      uv[2 * j] = __fmul_rn(static_cast<float>(px), L.scale);
      uv[2 * j + 1] = __fmul_rn(static_cast<float>(py), L.scale);
      angle[j] = ang;
      level[j] = l;
    }
  }
}

}  // namespace

// Orientation and descriptors of the `cap` slots of `pxy` ((2, cap) int32
// level coordinates: px then py) from the flat blurred buffer `blurred`
// (`total` floats) in one launch on `stream` of CUDA device `device`.
// `table` (host memory) holds n_levels rows of (offset, h, w, slot_off,
// budget), `scales` (host) each level's float32 scale; `pattern` the
// (256, 4) float32 pairs, `moments` the (2, 31, 31) float32 moment windows
// (device). Writes uv (cap, 2), angle (cap), level (cap) and desc (cap, 8).
// Returns cudaErrorInvalidValue for a table that does not fit the kernel,
// else the launch's error.
extern "C" int orb_describe(const float* blurred, int total, const int* table, const float* scales, int n_levels,
                            const int* pxy, int cap, const float* pattern, const float* moments, float* uv,
                            float* angle, int* level, int* desc, int device, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_levels < 1 || n_levels > MAX_LEVELS || cap < 0 || total < 1) return bad;
  Plan plan{};
  plan.n_levels = n_levels;
  plan.cap = cap;
  long long slots = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int* row = table + LEVEL_COLS * l;
    Level& L = plan.lv[l];
    L.off = row[0];
    L.h = row[1];
    L.w = row[2];
    L.slot_off = row[3];
    L.budget = row[4];
    L.scale = scales[l];
    if (L.h < 2 || L.w < 2 || L.off < 0 || (long long)L.off + (long long)L.h * L.w > total || L.budget < 0 ||
        L.slot_off != slots) {
      return bad;
    }
    slots += L.budget;
  }
  if (slots != cap) return bad;
  if (cap == 0) return 0;
  int prev = -1;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (cap + NW - 1) / NW;
  describe_fused<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      blurred, plan, pxy, reinterpret_cast<const float4*>(pattern), moments, uv, angle, level, desc);
  e = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(e);
}
