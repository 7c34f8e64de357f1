// The whole debiased Sinkhorn divergence of small clouds in one launch.
//
//   div[p] = max(OT(x, y) - OT(x, x)/2 - OT(y, y)/2, 0)   (OT(x, y) alone
//   without debias), OT from the dual potentials: <a, f> + <b, g>,
//   cost C_ij = 1 - <x_i, y_j> / (|x_i| |y_j|).
//
// Replaces, for clouds of up to SOLVE_MAX_POINTS points of up to
// SOLVE_MAX_DIM features (aadg_tpu_torch/ops/sinkhorn.py), the
// per-half-step loop over aadg_tpu/ops/sinkhorn_pallas.py::_softmin_kernel
// driven by the scan of sinkhorn_online, and the dense
// aadg_tpu/ops/sinkhorn.py::sinkhorn_divergence, which kept the whole cost
// matrix in VMEM for the same reason this kernel keeps it in shared memory.
//
// Bound: the bytes of both clouds (147 KB for the search step's 18
// divergences of 8 vs 8 points x 128, about 0.04 us at 3.35 TB/s), so in
// practice one launch's latency and the block's chain of dependent steps.
// The design spends exactly one launch, never returns to device memory
// between half-steps, and keeps that chain short:
//   - one thread block per divergence; half-warps load the rows of both
//     clouds (16-byte loads where the rows allow), reduce each row's norm
//     with shuffles (clamped at 1e-8), and store the normalized rows in
//     shared memory; the xy, xx and yy cost matrices are then computed
//     once into shared memory, f32 FMA dot products over D read as float4
//     (no TF32);
//   - the potentials f and g of all three problems stay in shared memory
//     through the whole epsilon schedule, double-buffered with the
//     softmin offsets z_j = log w_j + pot_j / eps of the next half-step,
//     so one Jacobi round (both half-steps from the old potentials, their
//     average, the next offsets) is one phase and one __syncthreads; then
//     two sequential half-steps at the last epsilon;
//   - a half-step gives each (side, problem, row) task a segment of S
//     lanes (S = the next power of two >= the cloud size, from 8 to 32, a
//     template parameter so the reductions unroll);
//     each lane takes columns lane, lane + S, ..., and the row's max and
//     sum of exponentials are shuffle reductions within the segment. At 8
//     points that is 384 threads, every softmin of a round at once;
//   - one warp per problem takes the dual sums, then the debias
//     combination and the clamp end the block.
// Arithmetic mirrors softmin_plain (ops/sinkhorn.py): z = log w + pot/eps,
// then + (-cost) * (1/eps), then max, exp, sum, log, with IEEE division and
// the precise expf/logf. Missing columns score -1e30 as the padded ones
// do there. No atomics: every run gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxEps = 256;       // longest epsilon schedule
constexpr int kMaxCols = 4;        // columns per lane: clouds of <= 128 points
constexpr int kMaxDim = 256;       // widest feature (SOLVE_MAX_DIM)
constexpr int kMinSeg = 8;         // lanes per softmin row, at least
constexpr int kMaxSmemBytes = 232448;  // dynamic shared memory of one block
constexpr float kNegInf = -1e30f;

struct Schedule {
  int n;
  float eps[kMaxEps];
  float inv[kMaxEps];  // 1 / eps in f32, as softmin_plain forms it
};

struct Dims {
  int n, m, d;      // points of x, points of y, features
  int len;          // max(n, m): row length of the potentials
  int lp;           // row stride of a cost matrix (odd: no bank conflicts)
  int dp;           // row stride of a staged cloud: D rounded up to 4, + 4
  int seg;          // lanes per softmin row (the kernel's SEG)
  int problems;     // 3 with debias (xy, xx, yy), else 1 (xy)
};

// Floats of dynamic shared memory; ops/sinkhorn.py::solve_smem_bytes
// mirrors this count.
__host__ __device__ inline int smem_floats(const Dims& dm) {
  const int kl = dm.problems * dm.len;
  return (dm.n + dm.m) * dm.dp + kl * dm.lp + 12 * kl + 4 * dm.len + 4;
}

// Sum / max over aligned groups of W lanes (every lane of the warp takes
// part).
template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = W >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int W>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = W >> 1; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Shared {
  float* cloud;         // [n + m][dp] normalized rows of x then y
  float* cost;          // [problems][len][lp]: 1 - <row_i, col_j>
  float *f, *g;         // [2][problems][len] row / column potentials
  float *zf, *zg;       // [2][problems][len] offsets read by f- / g-steps
  float *wa, *wb;       // [len] normalized weights of x / y
  float *la, *lb;       // [len] log(max(w, 1e-30))
  float* red;           // [4] the OT value of each problem
  int* tasks;           // [2][problems][len] packed (side, problem, row)
};

// Problem k: xy (0), xx (1), yy (2). Its rows carry f, its columns g.
__device__ __forceinline__ bool rows_are_y(int k) { return k == 2; }
__device__ __forceinline__ bool cols_are_x(int k) { return k == 1; }

// The half-steps of tasks [t_lo, t_hi) from buffer `cur`. Side 0 updates
// row i's f (softmin over the columns of C, offsets zf), side 1 column i's
// g (softmin over the rows of C, offsets zg). In a Jacobi round the new
// potential is averaged with the old one into buffer cur ^ 1, else it
// replaces it in `cur`; either way the offset the other side reads next
// (log w + pot / eps_next) is written beside it. Every thread runs the
// same number of loop trips, so the shuffles always see the full warp.
template <int SEG, int NCOL>
__device__ __forceinline__ void half_steps(const Shared& s, const Dims& dm,
                                           int cur, float eps, float inv_eps,
                                           float eps_next, int t_lo,
                                           int t_hi, bool jacobi) {
  const int lane = threadIdx.x & (SEG - 1);
  const int nseg = blockDim.x / SEG;
  const int kl = dm.problems * dm.len;
  for (int base = t_lo; base < t_hi; base += nseg) {
    const int t = base + threadIdx.x / SEG;
    const int packed = t < t_hi ? s.tasks[t] : 0;
    const int side = packed >> 16, k = (packed >> 8) & 0xff,
              i = packed & 0xff;
    const int nr = rows_are_y(k) ? dm.m : dm.n;
    const int nc = cols_are_x(k) ? dm.n : dm.m;
    const int rows = side == 0 ? nr : nc;
    const int cols = side == 0 ? nc : nr;
    const bool row_ok = t < t_hi && i < rows;
    const int at = k * dm.len;
    const float* zb = (side == 0 ? s.zf : s.zg) + cur * kl + at;
    const float* c = s.cost + at * dm.lp;
    float* pot = (side == 0 ? s.f : s.g) + at + i;
    // read now, used after the reductions: the old potential and the log
    // weight of this potential's points (the f-side rows, the g-side
    // columns)
    const bool writer = row_ok && lane == 0;
    const float old = writer && jacobi ? pot[cur * kl] : 0.0f;
    const float lw = !writer ? 0.0f
                     : side == 0 ? (rows_are_y(k) ? s.lb : s.la)[i]
                                 : (cols_are_x(k) ? s.la : s.lb)[i];
    float z[NCOL];
    float mx = kNegInf;
#pragma unroll
    for (int q = 0; q < NCOL; ++q) {
      const int j = lane + q * SEG;
      z[q] = kNegInf;
      if (row_ok && j < cols) {
        const float cost = side == 0 ? c[i * dm.lp + j] : c[j * dm.lp + i];
        z[q] = __fadd_rn(zb[j], __fmul_rn(-cost, inv_eps));
      }
      mx = fmaxf(mx, z[q]);
    }
    mx = group_max<SEG>(mx);
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < NCOL; ++q)
      if (row_ok && lane + q * SEG < cols) sum += expf(z[q] - mx);
    sum = group_sum<SEG>(sum);
    if (writer) {
      float v = __fmul_rn(-eps, __fadd_rn(mx, logf(fmaxf(sum, 1e-30f))));
      int out = cur;
      if (jacobi) {
        v = __fmul_rn(0.5f, __fadd_rn(old, v));
        out = cur ^ 1;
      }
      pot[out * kl] = v;
      (side == 0 ? s.zg : s.zf)[out * kl + at + i] =
          __fadd_rn(lw, __fdiv_rn(v, eps_next));
    }
  }
}

template <int SEG, int NCOL>
__global__ void __launch_bounds__(kMaxThreads)
    sinkhorn_solve_kernel(const float* __restrict__ x,
                          const float* __restrict__ y,
                          const float* __restrict__ wx,
                          const float* __restrict__ wy,
                          float* __restrict__ div, const Schedule sched,
                          const Dims dm) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long p = blockIdx.x;
  const int n = dm.n, m = dm.m, d = dm.d, len = dm.len;
  const int kl = dm.problems * len;

  Shared s;
  s.cloud = reinterpret_cast<float*>(smem4);
  s.cost = s.cloud + (n + m) * dm.dp;
  s.f = s.cost + kl * dm.lp;
  s.g = s.f + 2 * kl;
  s.zf = s.g + 2 * kl;
  s.zg = s.zf + 2 * kl;
  s.wa = s.zg + 2 * kl;
  s.wb = s.wa + len;
  s.la = s.wb + len;
  s.lb = s.la + len;
  s.red = s.lb + len;
  s.tasks = reinterpret_cast<int*>(s.red + 4);

  // 1. rows of both clouds, one half-warp each: load (16-byte loads where
  // the rows allow) into shared memory, norm, normalize in place
  const float* xp = x + p * n * (long long)d;
  const float* yp = y + p * m * (long long)d;
  const bool vec = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(xp) % 16 == 0)
                   && (reinterpret_cast<uintptr_t>(yp) % 16 == 0);
  const int hl = tid & 15;
  for (int r0 = 0; r0 < n + m; r0 += nt / 16) {
    const int r = r0 + tid / 16;
    const bool ok = r < n + m;
    const float* src = r < n ? xp + (long long)r * d
                             : yp + (long long)(r - n) * d;
    float4* row = reinterpret_cast<float4*>(s.cloud + r * dm.dp);
    float ss = 0.0f;
#pragma unroll 1
    for (int c = 4 * hl; ok && c < d; c += 64) {
      float4 v;
      if (vec) {
        v = *reinterpret_cast<const float4*>(src + c);
      } else {
        v.x = src[c];
        v.y = c + 1 < d ? src[c + 1] : 0.0f;
        v.z = c + 2 < d ? src[c + 2] : 0.0f;
        v.w = c + 3 < d ? src[c + 3] : 0.0f;
      }
      ss = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, ss))));
      row[c / 4] = v;
    }
    const float nrm = fmaxf(sqrtf(group_sum<16>(ss)), 1e-8f);
#pragma unroll 1
    for (int c = 4 * hl; ok && c < d; c += 64) {
      float4 v = row[c / 4];
      v.x = __fdiv_rn(v.x, nrm);
      v.y = __fdiv_rn(v.y, nrm);
      v.z = __fdiv_rn(v.z, nrm);
      v.w = __fdiv_rn(v.w, nrm);
      row[c / 4] = v;
    }
  }
  // warp 0: normalized weights, their logs and the first offsets
  if (tid < 32) {
    float sx = 0.0f, sy = 0.0f;
    if (wx != nullptr) {
      for (int i = tid; i < n; i += 32) sx += wx[p * n + i];
      sx = group_sum<32>(sx);
    }
    if (wy != nullptr) {
      for (int j = tid; j < m; j += 32) sy += wy[p * m + j];
      sy = group_sum<32>(sy);
    }
    for (int i = tid; i < n; i += 32) {
      const float w = wx == nullptr ? __fdiv_rn(1.0f, (float)n)
                                    : __fdiv_rn(wx[p * n + i], sx);
      s.wa[i] = w;
      s.la[i] = logf(fmaxf(w, 1e-30f));
    }
    for (int j = tid; j < m; j += 32) {
      const float w = wy == nullptr ? __fdiv_rn(1.0f, (float)m)
                                    : __fdiv_rn(wy[p * m + j], sy);
      s.wb[j] = w;
      s.lb[j] = logf(fmaxf(w, 1e-30f));
    }
    __syncwarp();
    // potentials start at 0, so the offsets start at log w + 0 / eps
    for (int e = tid; e < kl; e += 32) {
      const int k = (e >= len) + (e >= 2 * len), i = e - k * len;
      s.zf[e] = (cols_are_x(k) ? s.la : s.lb)[i];
      s.zg[e] = (rows_are_y(k) ? s.lb : s.la)[i];
    }
  }
  for (int e = tid; e < kl; e += nt) {
    s.f[e] = 0.0f;
    s.g[e] = 0.0f;
  }
  for (int t = tid; t < 2 * kl; t += nt) {
    const int side = t >= kl, e = t - side * kl;
    const int k = (e >= len) + (e >= 2 * len);
    s.tasks[t] = (side << 16) | (k << 8) | (e - k * len);
  }
  __syncthreads();

  // 2. the cost matrices, once
  for (int e = tid; e < kl * len; e += nt) {
    const int k = (e >= len * len) + (e >= 2 * len * len);
    const int i = (e - k * len * len) / len, j = e % len;
    const int nr = rows_are_y(k) ? m : n;
    const int nc = cols_are_x(k) ? n : m;
    if (i >= nr || j >= nc) continue;
    const float4* a = reinterpret_cast<const float4*>(
        s.cloud + ((rows_are_y(k) ? n : 0) + i) * dm.dp);
    const float4* b = reinterpret_cast<const float4*>(
        s.cloud + ((cols_are_x(k) ? 0 : n) + j) * dm.dp);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int q = 0; q < (d + 3) / 4; ++q) {
      const float4 av = a[q], bv = b[q];
      acc.x = fmaf(av.x, bv.x, acc.x);
      acc.y = fmaf(av.y, bv.y, acc.y);
      acc.z = fmaf(av.z, bv.z, acc.z);
      acc.w = fmaf(av.w, bv.w, acc.w);
    }
    s.cost[(k * len + i) * dm.lp + j] =
        1.0f - ((acc.x + acc.y) + (acc.z + acc.w));
  }
  __syncthreads();

  // 3. one Jacobi round per epsilon, then the two final half-steps
  int cur = 0;
  const int last = sched.n - 1;
  for (int it = 0; it <= last; ++it) {
    half_steps<SEG, NCOL>(s, dm, cur, sched.eps[it], sched.inv[it],
                          sched.eps[it < last ? it + 1 : last], 0, 2 * kl,
                          true);
    cur ^= 1;
    __syncthreads();
  }
  const float eps = sched.eps[last], inv = sched.inv[last];
  half_steps<SEG, NCOL>(s, dm, cur, eps, inv, eps, 0, kl, false);
  __syncthreads();
  half_steps<SEG, NCOL>(s, dm, cur, eps, inv, eps, kl, 2 * kl, false);
  __syncthreads();

  // 4. dual sums <p, f> + <q, g>, one warp per problem; the divergence
  const int k = tid / 32, lane = tid & 31;
  if (k < dm.problems) {
    const int nr = rows_are_y(k) ? m : n;
    const int nc = cols_are_x(k) ? n : m;
    const float* wr = rows_are_y(k) ? s.wb : s.wa;
    const float* wc = cols_are_x(k) ? s.wa : s.wb;
    const float* f = s.f + cur * kl + k * len;
    const float* g = s.g + cur * kl + k * len;
    float sf = 0.0f, sg = 0.0f;
    for (int i = lane; i < nr; i += 32)
      sf = __fadd_rn(sf, __fmul_rn(wr[i], f[i]));
    for (int j = lane; j < nc; j += 32)
      sg = __fadd_rn(sg, __fmul_rn(wc[j], g[j]));
    sf = group_sum<32>(sf);
    sg = group_sum<32>(sg);
    if (lane == 0) s.red[k] = sf + sg;
  }
  __syncthreads();
  if (tid == 0) {
    float v = s.red[0];
    if (dm.problems == 3) {
      v = __fsub_rn(__fsub_rn(v, __fmul_rn(0.5f, s.red[1])),
                    __fmul_rn(0.5f, s.red[2]));
      v = v < 0.0f ? 0.0f : v;  // NaN passes, as torch.clamp lets it
    }
    div[p] = v;
  }
}

template <int SEG, int NCOL>
cudaError_t launch(const float* x, const float* y, const float* wx,
                   const float* wy, float* div, const Schedule& sched,
                   const Dims& dm, int problems, int threads, int bytes,
                   cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sinkhorn_solve_kernel<SEG, NCOL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  sinkhorn_solve_kernel<SEG, NCOL><<<problems, threads, bytes, stream>>>(
      x, y, wx, wy, div, sched, dm);
  return cudaGetLastError();
}

}  // namespace

// x: (P, n, d), y: (P, m, d), wx: (P, n) or null (uniform), wy: (P, m) or
// null, eps: n_eps host floats, div: (P,); all f32 and contiguous.
extern "C" int sinkhorn_solve_launch(const float* x, const float* y,
                                     const float* wx, const float* wy,
                                     const float* eps, int n_eps, int debias,
                                     float* div, int problems, int n, int m,
                                     int d, void* stream) {
  Dims dm;
  dm.n = n;
  dm.m = m;
  dm.d = d;
  dm.len = n > m ? n : m;
  dm.lp = dm.len | 1;
  dm.dp = (d + 3) / 4 * 4 + 4;
  dm.seg = kMinSeg;
  while (dm.seg < dm.len && dm.seg < 32) dm.seg <<= 1;
  dm.problems = debias ? 3 : 1;
  const long long bytes = 4LL * smem_floats(dm);
  const int ncol = (dm.len + dm.seg - 1) / dm.seg;
  if (problems < 1 || n < 1 || m < 1 || d < 1 || d > kMaxDim ||
      n_eps < 1 || n_eps > kMaxEps || ncol > kMaxCols ||
      bytes > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  Schedule sched;
  sched.n = n_eps;
  for (int i = 0; i < n_eps; ++i) {
    sched.eps[i] = eps[i];
    sched.inv[i] = 1.0f / eps[i];
  }
  int threads = 2 * dm.problems * dm.len * dm.seg;
  threads = (threads + 31) / 32 * 32;
  if (threads < 32 * dm.problems) threads = 32 * dm.problems;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = (int)bytes;
  cudaError_t err;
  if (dm.seg == 8)
    err = launch<8, 1>(x, y, wx, wy, div, sched, dm, problems, threads, b, st);
  else if (dm.seg == 16)
    err = launch<16, 1>(x, y, wx, wy, div, sched, dm, problems, threads, b,
                        st);
  else if (ncol == 1)
    err = launch<32, 1>(x, y, wx, wy, div, sched, dm, problems, threads, b,
                        st);
  else if (ncol == 2)
    err = launch<32, 2>(x, y, wx, wy, div, sched, dm, problems, threads, b,
                        st);
  else if (ncol == 3)
    err = launch<32, 3>(x, y, wx, wy, div, sched, dm, problems, threads, b,
                        st);
  else
    err = launch<32, 4>(x, y, wx, wy, div, sched, dm, problems, threads, b,
                        st);
  return (int)err;
}
