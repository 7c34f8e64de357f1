// K2: per-channel 256-bin histogram of a batch of RGB images.
//
// Replaces aadg_tpu/ops/lut_pallas.py::_hist_kernel (driven by
// hist3_pallas), which built the histogram on the TPU as a nibble one-hot
// matrix product. Here each block keeps 768 int32 bins in shared memory and
// counts its slice of one image with block-scoped atomics; the blocks of an
// image merge into the (3, 256) output with one global atomic per nonzero
// bin. Counts stay exact: every partial count is an integer below 2^24, the
// float sum of them is exact while an image has fewer than 2^24 pixels
// (the wrapper checks this).
//
// Bound: device-memory bytes (each f32 pixel value is read once); shared
// atomics on skewed images are the expected limit of this first version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 3 * 256;

__global__ void hist3_kernel(const float* __restrict__ img,
                             float* __restrict__ out,
                             int per_image, int chunk) {
  __shared__ int bins[kBins];
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) bins[i] = 0;
  __syncthreads();

  const long long n = blockIdx.y;
  const float* base = img + n * (long long)per_image;
  const int start = blockIdx.x * chunk;
  const int end = min(start + chunk, per_image);
  for (int e = start + threadIdx.x; e < end; e += blockDim.x) {
    int v = (int)base[e];
    v = min(max(v, 0), 255);
    atomicAdd(&bins[(e % 3) * 256 + v], 1);
  }
  __syncthreads();

  float* o = out + n * kBins;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    const int cnt = bins[i];
    if (cnt) atomicAdd(&o[i], (float)cnt);
  }
}

}  // namespace

// img: (n_images, per_image) f32 holding exact integers 0..255, channel of
// element e is e % 3. out: (n_images, 768) f32, zeroed here on the stream.
extern "C" int hist3_launch(const float* img, float* out, int n_images,
                            int per_image, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(float) * (size_t)n_images * kBins, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((per_image + chunk - 1) / chunk, n_images);
  hist3_kernel<<<grid, kThreads, 0, s>>>(img, out, per_image, chunk);
  return (int)cudaGetLastError();
}
