// The bilateral grid's [1 2 1]-per-dimension blur on Hopper (sm_90a).
//
// Replaces the TPU kernel `make_pallas_blur` (scripts/profile_blur_kernel.py:
// 73-114, kernel body :76), whose function is the dense-mode `blur` of
// inverserenderingofindoorscene_tpu/ops/bilateral.py:397-431.  For each grid
// vertex i and channel c:
//   out[i, c] = 10 y[i, c] + sum_{d = 0..9, nbr[i, d] >= 0} y[nbr[i, d], c]
// over the ten (dimension, +-1) neighbours of the 5-D XYLUV grid, columns in
// the order x-, x+, y-, y+, luma-, luma+, u-, u+, v-, v+.
//
// What bounds it.  Per launch it reads y once (V C floats), the neighbour
// table once (40 bytes a vertex) and writes V C floats; the neighbours' rows
// are gathered from L2 (y is at most 0.9 MB).  At the full image (V <= 76,800
// vertices) that is 3.7 MB (C = 1) to 4.9 MB (C = 3), about 1.1-1.5 us at
// 3.35 TB/s, and 10 adds per output: bound by bytes, and at this size by the
// launch itself.
//
// What the design does about it.  One thread per (vertex, channel): a warp
// reads 32 consecutive outputs' y and, for C = 1, 32 consecutive table rows.
// The Pallas kernel's one-hot matmul windows and scalar-prefetched offsets
// exist because a TPU core has no fast gather; a GPU thread gathers directly,
// so none of that is carried over, and nothing assumes the neighbour indices
// are monotone.  The ten terms are added in the plain version's column order
// with round-to-nearest intrinsics, so no multiply-add is contracted and the
// result equals `bilateral_blur_plain` bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kDirs = 10;  // 2 x (x, y, luma, u, v)
constexpr int kThreads = 256;

__global__ void bilateral_blur_kernel(const float* __restrict__ y,
                                      const int* __restrict__ nbr,
                                      float* __restrict__ out,
                                      long long n_out, int c_num) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_out) return;
  const long long v = t / c_num;
  const int c = (int)(t - v * c_num);
  const int* row = nbr + v * kDirs;
  float acc = __fmul_rn(10.0f, y[t]);
#pragma unroll
  for (int d = 0; d < kDirs; ++d) {
    const int j = __ldg(row + d);
    if (j >= 0) acc = __fadd_rn(acc, __ldg(y + (long long)j * c_num + c));
  }
  out[t] = acc;
}

}  // namespace

extern "C" {

// Launch on `stream`; return cudaGetLastError() after the launch.  y and out
// are contiguous float32 [V, C], nbr contiguous int32 [V, 10] (-1 where a
// neighbour is absent), all on one device.
int bilateral_blur_f32(const float* y, const int* nbr, float* out,
                       long long n_vert, int c_num, void* stream) {
  const long long n_out = n_vert * c_num;
  if (n_out == 0) return (int)cudaSuccess;
  const unsigned int blocks = (unsigned int)((n_out + kThreads - 1) / kThreads);
  bilateral_blur_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      y, nbr, out, n_out, c_num);
  return (int)cudaGetLastError();
}

}  // extern "C"
