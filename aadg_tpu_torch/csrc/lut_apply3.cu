// K3: per-image, per-channel 256-entry LUT applied to a batch of RGB images.
//
// Replaces aadg_tpu/ops/lut_pallas.py::_apply_kernel (driven by
// lut_apply3_pallas), which applied the LUT on the TPU as two nibble
// one-hot matrix products because element gathers were slow there. Here a
// block loads its image's (3, 256) LUT into shared memory once and looks
// each value up directly: out[e] = lut[e % 3][img[e]]. The result is exact.
//
// Bound: device-memory bytes (one f32 read and one f32 write per value).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLut = 3 * 256;

__global__ void lut_apply3_kernel(const float* __restrict__ img,
                                  const float* __restrict__ luts,
                                  float* __restrict__ out,
                                  int per_image, int chunk) {
  __shared__ float lut[kLut];
  const long long n = blockIdx.y;
  for (int i = threadIdx.x; i < kLut; i += blockDim.x)
    lut[i] = luts[n * kLut + i];
  __syncthreads();

  const long long off = n * (long long)per_image;
  const int start = blockIdx.x * chunk;
  const int end = min(start + chunk, per_image);
  for (int e = start + threadIdx.x; e < end; e += blockDim.x) {
    int v = (int)img[off + e];
    v = min(max(v, 0), 255);
    out[off + e] = lut[(e % 3) * 256 + v];
  }
}

}  // namespace

// img, out: (n_images, per_image) f32; luts: (n_images, 768) f32.
extern "C" int lut_apply3_launch(const float* img, const float* luts,
                                 float* out, int n_images, int per_image,
                                 int chunk, void* stream) {
  dim3 grid((per_image + chunk - 1) / chunk, n_images);
  lut_apply3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, luts, out, per_image, chunk);
  return (int)cudaGetLastError();
}
