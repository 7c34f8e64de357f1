// K1: batched log-domain softmin of entropic optimal transport.
//
//   f[p, i] = -eps * LSE_j( zb[p, j] - (1 - <xn[p, i], yn[p, j]>) / eps )
//
// Replaces aadg_tpu/ops/sinkhorn_pallas.py::_softmin_kernel (driven by
// softmin_online / sinkhorn_online). The TPU kernel walked a sequential
// (i-tile, j-tile) grid with the running max and sum in VMEM scratch. Here
// one block owns one (problem p, 32-row i-tile) and loops over 32-column
// j-tiles itself: the cost tile is a 32x32 f32 FMA product of the
// normalized rows staged through shared memory in 32-wide slices of D (no
// TF32), and each warp keeps the running max and sum of four rows in
// registers (flash-style). Masking follows the TPU kernel: columns past M
// score -1e30, and a running max still at -1e30 contributes nothing when a
// real value arrives (the fully-masked-tile guard). The cost matrix never
// reaches device memory.
//
// One kernel serves both uses: the search step's rewards launch it over all
// (policy, domain pair, {xy, xx, yy}) problems at once (54 problems of 8
// points x 128 features at the flagship shape), and a single large cloud
// (4096 x 4096 x 128) runs as 128 blocks. Bound: bytes at the flagship
// shape, f32 operations for large clouds.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;     // rows per i-tile = columns per j-tile = D slice
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void softmin_kernel(float eps, const float* __restrict__ xn,
                               const float* __restrict__ yn,
                               const float* __restrict__ zb,
                               float* __restrict__ f, int n, int m, int d) {
  __shared__ float xs[kTile][kTile + 1];
  __shared__ float ys[kTile][kTile + 1];
  __shared__ float zt[kTile][kTile + 1];

  const long long p = blockIdx.y;
  const int i0 = blockIdx.x * kTile;
  const float* x = xn + p * n * (long long)d;
  const float* y = yn + p * m * (long long)d;
  const float* z = zb + p * m;
  const int tid = threadIdx.x;
  const int tx = tid % kTile;  // column of the cost tile / lane
  const int ty = tid / kTile;  // 0..7: rows ty, ty+8, ty+16, ty+24 / warp
  const float inv_eps = 1.0f / eps;

  float m_run[4], s_run[4];  // rows 4*ty .. 4*ty+3, same in every lane
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_run[r] = kNegInf;
    s_run[r] = 0.0f;
  }

  for (int j0 = 0; j0 < m; j0 += kTile) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < d; k0 += kTile) {
      for (int t = tid; t < kTile * kTile; t += kThreads) {
        const int r = t / kTile, k = t % kTile;
        const int gk = k0 + k;
        const int gi = i0 + r, gj = j0 + r;
        xs[r][k] = (gi < n && gk < d) ? x[(long long)gi * d + gk] : 0.0f;
        ys[r][k] = (gj < m && gk < d) ? y[(long long)gj * d + gk] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kTile; ++k) {
        const float yv = ys[tx][k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[r] = fmaf(xs[ty + 8 * r][k], yv, acc[r]);
      }
      __syncthreads();
    }
    const int gj = j0 + tx;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = kNegInf;
      if (gj < m) {
        const float cost = 1.0f - acc[r];
        v = __fadd_rn(z[gj], __fmul_rn(-cost, inv_eps));
      }
      zt[ty + 8 * r][tx] = v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = zt[4 * ty + r][tx];
      const float m_new = fmaxf(m_run[r], warp_max(v));
      const float scale =
          m_run[r] > kNegInf / 2 ? expf(m_run[r] - m_new) : 0.0f;
      s_run[r] = s_run[r] * scale + warp_sum(expf(v - m_new));
      m_run[r] = m_new;
    }
    __syncthreads();
  }

  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = i0 + 4 * ty + r;
      if (row < n)
        f[p * n + row] = -eps * (m_run[r] + logf(fmaxf(s_run[r], 1e-30f)));
    }
  }
}

}  // namespace

// xn: (P, n, d), yn: (P, m, d), zb: (P, m), f: (P, n); all f32, contiguous.
extern "C" int softmin_launch(float eps, const float* xn, const float* yn,
                              const float* zb, float* f, int problems, int n,
                              int m, int d, void* stream) {
  dim3 grid((n + kTile - 1) / kTile, problems);
  softmin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      eps, xn, yn, zb, f, n, m, d);
  return (int)cudaGetLastError();
}
