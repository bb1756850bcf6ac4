// Motion-only bundle adjustment (reference Optimizer::PoseOptimization) in a
// single launch: 4 rounds x <= 10 damped Levenberg-Marquardt iterations with
// Huber weights in rounds 0-1, chi2 inlier relabeling between rounds, and a
// final plain-chi2 relabel.
//
// Replaces: the Pallas kernel `pose_optimization_fused` / `_pose_opt_kernel`
// (with `_gj_solve` and `_se3_exp_mul`) in
// orbslam2commentedbyxcm_tpu/ops/pallas_poseopt.py. Kept from it: edges behind
// the camera cost 1e6 and get zero weight, z is clamped at 1e-6 before the
// division, lambda starts at 1e-3 and goes x0.5 on accept / x4 on reject
// clipped to [1e-8, 1e6], a round stops when max|dx| < 1e-6 or lambda >= 1e6,
// the damped 6x6 system is solved by unpivoted Gauss-Jordan (H + lambda
// diag(H) + 1e-8 I is SPD), and the pose update is exp(dx) * T on the left.
// The stereo (u_right) Jacobian row is the exact derivative, as in the JAX
// package's XLA path; the Pallas kernel's row uses (bf - fx x / z) / z where
// the derivative has (bf - fx x) / z.
//
// What bounds it on an H100 80GB HBM3 (700 W): latency. One frame has
// ~1000 edges (29 KB of input) and each evaluation is ~260 FLOPs per edge;
// this input runs 13 evaluations, so the compute bound is ~0.05 us and the
// byte bound ~0.01 us (chip_smoke.py `k2_bound`, from the kernel's own count
// of its work). But every LM step depends on the previous one: the time is
// a chain of dependent block-wide sums and 6x6 solves.
//
// Design: one problem per launch, on one block of NT = 128 threads up to NT
// edges and on a cluster of CL_MAX = 8 such blocks above, chosen by
// measurement (tools/profile_kernels.py builds other sizes through
// -DK2_THREADS, -DK2_CLUSTER and -DK2_ONE_BLOCK_EDGES to compare, PERF.md).
// What shortens each link of the chain:
//   * The edges are split over the blocks, so the per-edge work of an
//     evaluation, which keeps one SM's issue slots busy, spreads over 8
//     SMs. Each block stages its share in shared memory once with
//     cp.async (28 bytes per edge, plus one byte of mask/active flags), as
//     the Pallas kernel keeps them in VMEM, so no evaluation goes back to
//     global memory. Past MAX_STAGED edges per block (the 227 KB dynamic
//     shared-memory limit) the same kernel, instantiated with STAGED =
//     false, reads them from global memory / L2 and keeps only the flags.
//   * Each evaluation accumulates the 21 unique Hessian entries, 6 gradient
//     entries and the robust error in registers, and reduces them with a
//     transposing butterfly: each of the five shuffle steps halves the
//     number of partial sums a lane holds (31 shuffles per warp, not
//     28 x 5), leaving lane j with sum j.
//   * The warp sums cross the cluster without a cluster barrier: each lane
//     pushes its sum into every block's receive buffer with st.async, which
//     completes 4 bytes of that block's mbarrier transaction, and a block
//     waits only on its own barrier. Against a cluster.sync() followed by
//     distributed shared-memory reads, this took a solve at N = 1000 from
//     35.0 to 22.6 us (PERF.md).
//     Receive buffers and barriers alternate between two, so one wait per
//     evaluation suffices; one block alone uses one __syncthreads().
//   * Every thread then sums the same warp sums in the same order and runs
//     the same LM solve, trial pose, accept test and lambda update in
//     registers. Identical inputs and instructions give identical results
//     in every thread of every block, so no thread waits on a serial
//     section and nothing is broadcast. Control flow stays uniform.
//   * Each thread relabels only the edges it accumulates, so the relabel
//     between rounds needs no barrier either.
//   * The solve scales each pivot row by one IEEE reciprocal, and the SE3
//     exp takes one sincosf and one reciprocal: each IEEE division is a
//     branchy sequence the compiler does not overlap, so 42 of them made
//     the 6x6 solve the longest link of an iteration.
// Measured at N = 1000: 22.2 us (PERF.md), against 63.7 us for the
// earlier design (one 256-thread block, thread 0 solving) on the same card.
// IEEE division, sqrt, sin and cos throughout (no fast math).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

#ifndef K2_THREADS
#define K2_THREADS 128
#endif
#ifndef K2_CLUSTER
#define K2_CLUSTER 8
#endif
#ifndef K2_ONE_BLOCK_EDGES
#define K2_ONE_BLOCK_EDGES K2_THREADS
#endif

namespace {

constexpr int NT = K2_THREADS;                // threads per block
constexpr int CL_MAX = K2_CLUSTER;            // blocks of the cluster above ONE_BLOCK edges
constexpr int ONE_BLOCK = K2_ONE_BLOCK_EDGES;  // problems of at most this many edges run on one block
static_assert(NT % 32 == 0 && NT <= 1024, "whole warps, at most 1024 threads");
static_assert(CL_MAX == 1 || CL_MAX == 2 || CL_MAX == 4 || CL_MAX == 8, "a portable cluster size");

constexpr int NACC = 28;  // 21 upper-triangular H, 6 g, 1 robust error
constexpr int NRED = 32;  // NACC padded to a warp: lane j ends with sum j
constexpr float CHI2_MONO = 5.991f;
constexpr float CHI2_STEREO = 7.815f;
constexpr int MAX_STAGED = 7000;  // edges a block stages: 29 bytes each in shared memory
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned char IN_MASK = 1, ACTIVE = 2;

struct Cam {
  float fx, fy, cx, cy, bf;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// T_new = exp([rho, phi]) * T for the row-major 4x4 T.
__device__ __forceinline__ void se3_exp_mul(const float* d, const float* t, float* out) {
  const float rho0 = d[0], rho1 = d[1], rho2 = d[2];
  const float p0 = d[3], p1 = d[4], p2 = d[5];
  const float th2 = p0 * p0 + p1 * p1 + p2 * p2;
  const float th = sqrtf(fmaxf(th2, 1e-16f));
  const bool small = th2 < 1e-8f;
  // one IEEE reciprocal and one sincosf: each division or libm call is a
  // separate branchy sequence that the compiler does not overlap
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float inv = 1.0f / th;
  const float a = small ? 1.0f - th2 * (1.0f / 6.0f) : sn * inv;
  const float b = small ? 0.5f - th2 * (1.0f / 24.0f) : (1.0f - cs) * (inv * inv);
  const float c = small ? 1.0f / 6.0f - th2 * (1.0f / 120.0f) : (th - sn) * (inv * inv * inv);
  const float k00 = -(p1 * p1 + p2 * p2), k11 = -(p0 * p0 + p2 * p2), k22 = -(p0 * p0 + p1 * p1);
  const float k01 = p0 * p1, k02 = p0 * p2, k12 = p1 * p2;
  // R = I + a K + b K^2, V = I + b K + c K^2, K = hat(phi)
  const float r[9] = {1.0f + b * k00, -a * p2 + b * k01, a * p1 + b * k02,
                      a * p2 + b * k01, 1.0f + b * k11, -a * p0 + b * k12,
                      -a * p1 + b * k02, a * p0 + b * k12, 1.0f + b * k22};
  const float v[9] = {1.0f + c * k00, -b * p2 + c * k01, b * p1 + c * k02,
                      b * p2 + c * k01, 1.0f + c * k11, -b * p0 + c * k12,
                      -b * p1 + c * k02, b * p0 + c * k12, 1.0f + c * k22};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float td = v[3 * i] * rho0 + v[3 * i + 1] * rho1 + v[3 * i + 2] * rho2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[4 * i + j] = r[3 * i] * t[j] + r[3 * i + 1] * t[4 + j] + r[3 * i + 2] * t[8 + j] + (j == 3 ? td : 0.0f);
    }
  }
  out[12] = 0.0f; out[13] = 0.0f; out[14] = 0.0f; out[15] = 1.0f;
}

// dx = -(H + lam diag(H) + 1e-8 I)^-1 g by unpivoted Gauss-Jordan on [Hd | g].
// `acc` holds the upper triangle of H row by row (21), then g (6). A pivot
// row is scaled by its IEEE reciprocal: one division per pivot, not seven.
__device__ __forceinline__ void lm_solve(const float* acc, float lam, float* dx) {
  float m[6][7];
  int p = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      m[i][j] = acc[p];
      m[j][i] = acc[p];
      ++p;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    m[i][i] = m[i][i] + lam * m[i][i] + 1e-8f;
    m[i][6] = acc[21 + i];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float inv = 1.0f / m[k][k];
#pragma unroll
    for (int j = 0; j < 7; ++j) m[k][j] = m[k][j] * inv;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (i == k) continue;
      const float f = m[i][k];
#pragma unroll
      for (int j = 0; j < 7; ++j) m[i][j] = m[i][j] - f * m[k][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) dx[i] = -m[i][6];
}

// One step of the transposing butterfly: a lane keeps the half of its
// 2 * OFF partial sums selected by its bit OFF and adds its partner's copy.
template <int OFF>
__device__ __forceinline__ void butterfly_step(float (&acc)[NRED], int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int j = 0; j < OFF; ++j) {
    const float send = up ? acc[j] : acc[j + OFF];
    const float keep = up ? acc[j + OFF] : acc[j];
    acc[j] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Shared-memory address `addr` of this block mapped to block `rank` of the cluster.
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Remote store that completes 4 bytes of the remote block's barrier transaction.
__device__ __forceinline__ void store_async(unsigned raddr, float v, unsigned rbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];"
               ::"r"(raddr), "f"(v), "r"(rbar) : "memory");
}

__device__ __forceinline__ void bar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Arrive once on the local barrier and expect `bytes` of transactions in this phase.
__device__ __forceinline__ void bar_arm(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity) : "memory");
}

// Sum NRED per-thread partials over the cluster; every thread of every
// block gets the NACC sums in `out`, bit-identical everywhere (each sums
// the same CL x NWARP warp sums in the same order). `k` numbers the
// reductions of a launch: reduction k uses receive buffer and barrier k % 2,
// whose phase parity is (k / 2) % 2.
//   CL == 1: each warp stores its sums in `recv`, one __syncthreads().
//   CL > 1: each lane pushes its warp's sum of slot `lane` into every
//   block's `recv` with st.async, which completes 4 bytes of that block's
//   barrier transaction; a block waits on its own barrier, re-arms it for
//   its next use and sums locally. No cluster-wide barrier: a block waits
//   only for the data it needs.
template <int NWARP, int CL>
__device__ __forceinline__ void cluster_sum(float (&acc)[NRED], float (*recv)[CL * NWARP][NRED],
                                            unsigned long long* bars, int k, float (&out)[NACC]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  butterfly_step<16>(acc, lane);
  butterfly_step<8>(acc, lane);
  butterfly_step<4>(acc, lane);
  butterfly_step<2>(acc, lane);
  butterfly_step<1>(acc, lane);
  const int b = k & 1;
  if constexpr (CL == 1) {
    recv[b][warp][lane] = acc[0];  // this warp's sum of slot `lane`
    __syncthreads();
  } else {
    const unsigned rank = cg::this_cluster().block_rank();
    const unsigned dst = smem_addr(&recv[b][rank * NWARP + warp][lane]);
    const unsigned bar = smem_addr(&bars[b]);
#pragma unroll
    for (int r = 0; r < CL; ++r) store_async(map_rank(dst, r), acc[0], map_rank(bar, r));
    bar_wait(bar, (k >> 1) & 1);
    if (threadIdx.x == 0) bar_arm(bar, CL * NWARP * NRED * sizeof(float));
  }
  float v = 0.0f;
#pragma unroll
  for (int src = 0; src < CL * NWARP; ++src) v += recv[b][src][lane];
#pragma unroll
  for (int j = 0; j < NACC; ++j) out[j] = __shfl_sync(FULL, v, j);
}

struct Edge {
  float px, py, pz;  // camera-frame point
  float ru, rv, rr;  // residuals obs - proj (rr = 0 for mono)
  float c2;          // chi2 (before the behind-camera substitution)
  float invz;
  float isig;
  bool stereo;
};

__device__ __forceinline__ Edge project(const float* t, const float* pts, const float* obs,
                                        const float* isig, int i, const Cam& cam) {
  Edge e;
  const float xw = pts[3 * i], yw = pts[3 * i + 1], zw = pts[3 * i + 2];
  const float ou = obs[3 * i], ov = obs[3 * i + 1], our = obs[3 * i + 2];
  e.isig = isig[i];
  e.px = t[0] * xw + t[1] * yw + t[2] * zw + t[3];
  e.py = t[4] * xw + t[5] * yw + t[6] * zw + t[7];
  e.pz = t[8] * xw + t[9] * yw + t[10] * zw + t[11];
  e.invz = 1.0f / (e.pz < 1e-6f ? 1e-6f : e.pz);
  const float u = cam.fx * e.px * e.invz + cam.cx;
  const float v = cam.fy * e.py * e.invz + cam.cy;
  e.stereo = our >= 0.0f;
  e.ru = ou - u;
  e.rv = ov - v;
  e.rr = e.stereo ? our - (u - cam.bf * e.invz) : 0.0f;
  e.c2 = (e.ru * e.ru + e.rv * e.rv + e.rr * e.rr) * e.isig;
  return e;
}

// One evaluation at pose t over this thread's active edges, reduced over the
// cluster -> out = [H (21), g (6), err] in every thread. `n_edges` counts
// the edges this thread evaluated.
template <int CL>
__device__ __forceinline__ void evaluate(const float* t, const float* pts, const float* obs,
                                         const float* isig, const unsigned char* flags, int cnt,
                                         const Cam& cam, bool huber,
                                         float (*recv)[CL * (NT / 32)][NRED], unsigned long long* bars,
                                         int k, float (&out)[NACC], int& n_edges) {
  float acc[NRED];
#pragma unroll
  for (int j = 0; j < NRED; ++j) acc[j] = 0.0f;
  for (int i = threadIdx.x; i < cnt; i += NT) {
    if (!(flags[i] & ACTIVE)) continue;  // an inactive edge adds exact zeros
    ++n_edges;
    const Edge e = project(t, pts, obs, isig, i, cam);
    const bool front = e.pz > 0.0f;
    const float d2 = e.stereo ? CHI2_STEREO : CHI2_MONO;
    float w = front ? e.isig : 0.0f;
    float rho = e.c2;
    if (huber && e.c2 > d2) {
      const float sd = sqrtf(d2);
      const float er = sqrtf(fmaxf(e.c2, 1e-12f));
      w = w * (sd / er);
      rho = 2.0f * sd * er - d2;
    }
    acc[27] += front ? rho : 1e6f;
    const float fx = cam.fx, fy = cam.fy, iz = e.invz;
    const float xz = e.px * iz, yz = e.py * iz;
    const float ju[6] = {-fx * iz, 0.0f, fx * xz * iz, fx * xz * yz, -fx * (1.0f + xz * xz), fx * yz};
    const float jv[6] = {0.0f, -fy * iz, fy * yz * iz, fy * (1.0f + yz * yz), -fy * xz * yz, -fy * xz};
    const float ee = (cam.bf - fx * e.px) * iz;  // d(u_right)/dz = (bf - fx x) / z^2 = ee / z
    const float s = e.stereo ? 1.0f : 0.0f;
    const float jr[6] = {-fx * iz * s, 0.0f, -ee * iz * s, -ee * yz * s, -(fx - ee * xz) * s, fx * yz * s};
    int p = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float wa_u = w * ju[a], wa_v = w * jv[a], wa_r = w * jr[a];
#pragma unroll
      for (int b = a; b < 6; ++b) {
        acc[p] += wa_u * ju[b] + wa_v * jv[b] + wa_r * jr[b];
        ++p;
      }
      acc[21 + a] += wa_u * e.ru + wa_v * e.rv + wa_r * e.rr;
    }
  }
  cluster_sum<NT / 32, CL>(acc, recv, bars, k, out);
}

__device__ __forceinline__ bool chi2_inlier(const float* t, const float* pts, const float* obs,
                                            const float* isig, int i, const Cam& cam, float* c2) {
  const Edge e = project(t, pts, obs, isig, i, cam);
  *c2 = e.pz > 0.0f ? e.c2 : 1e6f;
  return *c2 <= (e.stereo ? CHI2_STEREO : CHI2_MONO);
}

// One problem on a cluster of CL blocks of NT threads; block r owns the
// edges [r * chunk, min(n, (r + 1) * chunk)).
template <int CL, bool STAGED>
__global__ void __launch_bounds__(NT) pose_opt_kernel(
    const float* __restrict__ t_in, const float* __restrict__ pts_g, const float* __restrict__ obs_g,
    const bool* __restrict__ mask_g, const float* __restrict__ isig_g, int n, Cam cam,
    int n_rounds, int n_iters, float* __restrict__ t_out, bool* __restrict__ inliers_g,
    int* __restrict__ counts, float* __restrict__ chi2) {
  // staged: this block's pts (3 cnt floats), obs (3 cnt), inv_sigma2 (cnt),
  // then flags (cnt bytes); streamed: flags only
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_recv[2][CL * (NT / 32)][NRED];  // warp sums of reduction k in s_recv[k % 2]
  __shared__ __align__(8) unsigned long long s_bar[2];  // their arrival barriers (CL > 1)
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int chunk = (n + CL - 1) / CL;
  const int lo = min(n, rank * chunk);
  const int cnt = min(n, lo + chunk) - lo;
  float* s_f = reinterpret_cast<float*>(smem);
  unsigned char* flags = STAGED ? smem + 28 * static_cast<size_t>(chunk) : smem;
  const float* pts = STAGED ? s_f : pts_g + 3 * lo;
  const float* obs = STAGED ? s_f + 3 * cnt : obs_g + 3 * lo;
  const float* isig = STAGED ? s_f + 6 * cnt : isig_g + lo;
  const bool* mask = mask_g + lo;
  if (STAGED) {
    for (int i = tid; i < 3 * cnt; i += NT) {
      cp_async4(s_f + i, pts_g + 3 * lo + i);
      cp_async4(s_f + 3 * cnt + i, obs_g + 3 * lo + i);
    }
    for (int i = tid; i < cnt; i += NT) cp_async4(s_f + 6 * cnt + i, isig_g + lo + i);
    cp_async_wait_all();
  }
  // a thread only ever reads and writes the flags of its own edges
  for (int i = tid; i < cnt; i += NT) flags[i] = mask[i] ? (IN_MASK | ACTIVE) : 0;
  float t[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) t[j] = t_in[j];
  if constexpr (CL > 1) {
    if (tid == 0) {
      for (int b = 0; b < 2; ++b) {
        bar_init(smem_addr(&s_bar[b]), 1);
        bar_arm(smem_addr(&s_bar[b]), CL * (NT / 32) * NRED * sizeof(float));
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cg::this_cluster().sync();  // every barrier is armed before any block pushes
  } else {
    __syncthreads();
  }

  // LM state: the same values in every thread of the cluster
  float cur[NACC], ev[NACC];
  int n_eval = 0, n_edges = 0;
  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool huber = rnd < 2;
    evaluate<CL>(t, pts, obs, isig, flags, cnt, cam, huber, s_recv, s_bar, n_eval++, ev, n_edges);
#pragma unroll
    for (int j = 0; j < NACC; ++j) cur[j] = ev[j];
    float err_best = ev[27];
    float lam = 1e-3f;
    int it = 0;
    bool go = n_iters > 0;
    while (go) {
      float dx[6], trial[16];
      lm_solve(cur, lam, dx);
      se3_exp_mul(dx, t, trial);
      float max_dx = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j) max_dx = fmaxf(max_dx, fabsf(dx[j]));
      evaluate<CL>(trial, pts, obs, isig, flags, cnt, cam, huber, s_recv, s_bar, n_eval++, ev, n_edges);
      const bool accept = ev[27] < err_best;
      if (accept) {
#pragma unroll
        for (int j = 0; j < 16; ++j) t[j] = trial[j];
#pragma unroll
        for (int j = 0; j < NACC; ++j) cur[j] = ev[j];
        err_best = ev[27];
      }
      lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-8f), 1e6f);
      ++it;
      go = it < n_iters && !(max_dx < 1e-6f || lam >= 1e6f);
    }
    // relabel this thread's edges by plain chi2 at the round's pose
    for (int i = tid; i < cnt; i += NT) {
      if (!(flags[i] & IN_MASK)) continue;
      float c2;
      flags[i] = chi2_inlier(t, pts, obs, isig, i, cam, &c2) ? (IN_MASK | ACTIVE) : IN_MASK;
    }
  }

  bool* inliers = inliers_g + lo;
  float acc[NRED];
#pragma unroll
  for (int j = 0; j < NRED; ++j) acc[j] = 0.0f;
  acc[2] = static_cast<float>(n_edges);  // exact below 2^24 edge evaluations
  for (int i = tid; i < cnt; i += NT) {
    float c2;
    const bool in = (flags[i] & IN_MASK) && chi2_inlier(t, pts, obs, isig, i, cam, &c2);
    inliers[i] = in;
    if (in) {
      acc[0] += 1.0f;
      acc[1] += c2;
    }
  }
  cluster_sum<NT / 32, CL>(acc, s_recv, s_bar, n_eval, ev);
  if (rank == 0 && tid == 0) {  // t stays in registers: index it with constants only
#pragma unroll
    for (int j = 0; j < 16; ++j) t_out[j] = t[j];
    *chi2 = ev[1];
    counts[0] = static_cast<int>(ev[0] + 0.5f);
    counts[1] = n_eval;
    counts[2] = static_cast<int>(ev[2] + 0.5f);
  }
  if constexpr (CL > 1) cg::this_cluster().sync();  // no block leaves while a push to it is in flight
}

struct Out {
  float* t;      // (16,) T_cw, row-major
  bool* inliers;  // (n,)
  int* counts;    // (3,) n_inliers, evaluations, edge evaluations
  float* chi2;    // ()
};

template <int CL>
cudaError_t launch(const float* t_in, const float* pts, const float* obs, const bool* mask,
                   const float* isig, int n, const Cam& cam, int n_rounds, int n_iters,
                   const Out& out, cudaStream_t stream) {
  const int chunk = (n + CL - 1) / CL;
  const bool staged = chunk <= MAX_STAGED;
  void (*kernel)(const float*, const float*, const float*, const bool*, const float*, int, Cam, int,
                 int, float*, bool*, int*, float*) =
      staged ? pose_opt_kernel<CL, true> : pose_opt_kernel<CL, false>;
  const size_t smem = static_cast<size_t>(chunk) * (staged ? 29 : 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, t_in, pts, obs, mask, isig, n, cam, n_rounds,
                                           n_iters, out.t, out.inliers, out.counts, out.chi2);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// Launches one problem on `stream`: one block of NT threads when n <=
// ONE_BLOCK, else a cluster of CL_MAX blocks. Writes T_cw (16 floats), the
// inlier mask (n bools), counts (n_inliers, and the evaluations and edge
// evaluations the solve ran: 3 int32) and chi2 (1 float). Returns the
// launch's CUDA error code (0 on success).
extern "C" int pose_opt(const float* t_in, const float* pts, const float* obs, const bool* mask,
                        const float* isig, int n, float fx, float fy, float cx, float cy, float bf,
                        int n_rounds, int n_iters, float* t_out, bool* inliers, int* counts, float* chi2,
                        void* stream) {
  const Cam cam{fx, fy, cx, cy, bf};
  const Out o{t_out, inliers, counts, chi2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = n <= ONE_BLOCK
                            ? launch<1>(t_in, pts, obs, mask, isig, n, cam, n_rounds, n_iters, o, s)
                            : launch<CL_MAX>(t_in, pts, obs, mask, isig, n, cam, n_rounds, n_iters, o, s);
  return static_cast<int>(e);
}
