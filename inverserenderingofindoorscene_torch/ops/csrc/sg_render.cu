// Fused SG decode + Lambert/GGX shading for training, the backward, on
// Hopper (sm_90a).  The forward runs on the serving kernel's walk
// (sg_render_env.cu, `render_sg_fwd_f32`).
//
// Replaces the TPU kernel `_bwd_kernel`
// (inverserenderingofindoorscene_tpu/ops/sg_render.py:197-211, launched by
// `_sg_render_bwd` :271; math `_shade_tile_math` :56-186).  The forward
// evaluates, per pixel, the K-lobe SG mixture on the D hemisphere
// directions and integrates
//   diffuse_c = albedo_c / pi sum_d ndl_w(d) env_c(d),
//   specular_c = sum_d spec_w(d) env_c(d).
// The backward recomputes it and pulls (gd, gs) back to albedo, normal,
// rough, axis, lamb and weight with the hand-derived adjoint of
// sg_common.cuh; the view direction gets none.  PRECONDITION, as for the
// TPU kernel: |normal| <= 1 (the shortcut algebra for v.l, |h|^2, n.l and
// n.h is exact only then).  Its recomputed GGX term takes nom0 as a2 ndh^2
// + |n x h|^2 (`shade<true>`), not the TPU kernel's cancelling ndh^2 (a2 -
// 1) + 1, so that f32 keeps the gradient on the right side of the GGX
// denominator's clamp (sg_common.cuh).
//
// What bounds it.  At the training shape (N = 96,000 pixels, K=12, D=128)
// the forward does N (8K+45) D ~ 1.73 GFLOP and the backward about three
// times that, ~5.2 GFLOP (~78 us at the 67 TFLOP/s f32 rate), against
// ~74 MB moved.  Every operation is per pixel and per direction; there is
// no reuse for tensor cores.  That count takes an IEEE divide or square
// root as one operation, but each is a MUFU seed, a Newton refinement and
// a branch to a slow path: per pixel and direction the backward runs 6
// divides and 2 square roots (two `shade` calls, one `shade_adjoint`), 2
// exp2f and K expf.  In practice it is bound by the instruction issue
// rate: its SASS issues ~620 instructions per pixel and direction at K=12,
// 62% of them in the lobe loop (~32 per lobe and direction: the IEEE expf,
// the mixture, the seven sums, the shared-memory rows), ~240 M warp
// instructions a launch, ~0.23-0.26 ms at 132 SMs x 4 schedulers and
// 1.75-1.98 GHz (counted before the well-conditioned nom0 below).  It
// holds 254 registers, no spill, so 4 blocks (8 warps) are resident per
// SM; the launch takes 0.457 ms on an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 3; 0.402 with the TPU kernel's nom0).
//
// The design (as the TPU kernel, pixels along the lanes).  One
// thread per pixel, 64 pixels to a block, so that no sum crosses lanes and
// the per-pixel work (the frame, its adjoint, the epilogue) runs once per
// pixel rather than on 32 lanes.  The block stages the [D, 4] direction
// table and its pixels' lobe inputs into shared memory, the lobes as rows
// [field][k][pixel] (65 floats apart, so that the coalesced staging writes
// spread over the banks); each thread keeps its 7K lobe gradient sums in
// the same layout, so a warp's accesses to one row fall on 32 banks.  The
// threads walk the directions in lockstep, so each direction read is a
// broadcast.  Per chunk of 8 directions, in registers: (A) the radiance
// adjoint, (B) lobes outside, directions inside, the rebuilt mixture and
// each lobe's seven partial sums added to its rows, (C) the shading
// adjoint into the nine per-pixel sums (sg_render_bwd.cuh, which the CPU
// check also builds).  Then each thread runs the frame adjoint for its
// pixel, and the block writes the lobe gradients out of shared memory with
// coalesced stores.  Shared memory is 16 D + 2 x 7K x 65 x 4 bytes a block
// (45,728 B at K=12, D=128); above 48 KB (K >= 13) the launch opts in, up
// to the card's per-block limit (K <= 63 at D=128).

#include "sg_render_bwd.cuh"

namespace {

using namespace sgk;

// the backward: pixels (threads) to a block, and its shared-memory row
// length, one float of padding so that staging writes spread over banks
constexpr int kBwdThreads = 64;
constexpr int kBwdRow = kBwdThreads + 1;

// Stage one block's lobe inputs [pixel][k][i] (i < width) into rows
// [field0 + i][k][pixel] of kBwdRow floats; the global reads coalesce.
__device__ __forceinline__ void stage_rows(float* rows, const float* src,
                                           int n_here, int k_num, int width,
                                           int field0) {
  for (int e = threadIdx.x; e < n_here * k_num * width; e += kBwdThreads) {
    const int px = e / (k_num * width), r = e - px * k_num * width;
    const int k = r / width, i = r - k * width;
    rows[((field0 + i) * k_num + k) * kBwdRow + px] = src[e];
  }
}

// The inverse of stage_rows, for the gradients; the global writes coalesce.
__device__ __forceinline__ void store_rows(const float* rows, float* dst,
                                           int n_here, int k_num, int width,
                                           int field0) {
  for (int e = threadIdx.x; e < n_here * k_num * width; e += kBwdThreads) {
    const int px = e / (k_num * width), r = e - px * k_num * width;
    const int k = r / width, i = r - k * width;
    dst[e] = rows[((field0 + i) * k_num + k) * kBwdRow + px];
  }
}

// One thread per pixel, kBwdThreads pixels to a block.  Shared memory holds
// the direction table, then the block's lobe inputs and lobe gradients as
// rows [field][k][pixel].
__global__ void __launch_bounds__(kBwdThreads) render_sg_bwd_kernel(
    const float* __restrict__ albedo, const float* __restrict__ normal,
    const float* __restrict__ rough, const float* __restrict__ axis,
    const float* __restrict__ lamb, const float* __restrict__ weight,
    const float* __restrict__ view, const float4* __restrict__ dirs,
    const float* __restrict__ grad_diffuse,
    const float* __restrict__ grad_specular, float* __restrict__ d_albedo,
    float* __restrict__ d_normal, float* __restrict__ d_rough,
    float* __restrict__ d_axis, float* __restrict__ d_lamb,
    float* __restrict__ d_weight, long long n_pix, int hw, int k_num,
    int d_num, float f0) {
  extern __shared__ float4 smem4[];
  float4* s_dirs = smem4;
  float* s_lobes = reinterpret_cast<float*>(smem4 + d_num);
  float* s_grads = s_lobes + 7 * k_num * kBwdRow;
  const int t = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * kBwdThreads;
  const int n_here = (int)min((long long)kBwdThreads, n_pix - p0);
  for (int d = t; d < d_num; d += kBwdThreads) s_dirs[d] = dirs[d];
  stage_rows(s_lobes, axis + p0 * 3 * k_num, n_here, k_num, 3, 0);
  stage_rows(s_lobes, lamb + p0 * k_num, n_here, k_num, 1, 3);
  stage_rows(s_lobes, weight + p0 * 3 * k_num, n_here, k_num, 3, 4);
  __syncthreads();
  if (t < n_here) {  // the ragged block's spare threads only stage and store
    const long long p = p0 + t;
    const long long q = 3 * (p % hw);  // the view vector depends on (row, col)
    PixelIn in;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      in.normal[ch] = normal[3 * p + ch];
      in.view[ch] = view[q + ch];
      in.albedo[ch] = albedo[3 * p + ch];
      in.gd[ch] = grad_diffuse[3 * p + ch];
      in.gs[ch] = grad_specular[3 * p + ch];
    }
    in.rough = rough[p];
    const PixelGrad g = render_sg_bwd_pixel(
        in, s_dirs, d_num, f0, LobeRows{s_lobes + t, k_num, kBwdRow},
        LobeRows{s_grads + t, k_num, kBwdRow});
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      d_albedo[3 * p + ch] = g.albedo[ch];
      d_normal[3 * p + ch] = g.normal[ch];
    }
    d_rough[p] = g.rough;
  }
  __syncthreads();
  store_rows(s_grads, d_axis + p0 * 3 * k_num, n_here, k_num, 3, 0);
  store_rows(s_grads, d_lamb + p0 * k_num, n_here, k_num, 1, 3);
  store_rows(s_grads, d_weight + p0 * 3 * k_num, n_here, k_num, 3, 4);
}

// The backward's direction table, lobe rows and gradient rows.
int bwd_smem_bytes(int k_num, int d_num) {
  return (int)sizeof(float4) * d_num +
         (int)sizeof(float) * 2 * 7 * k_num * kBwdRow;
}

}  // namespace

extern "C" {

// Shared-memory bytes a backward block needs for K lobes and D directions
// (above 48 KB the launch opts in, up to the card's per-block limit).
int render_sg_bwd_smem_bytes(int k_num, int d_num) {
  return bwd_smem_bytes(k_num, d_num);
}

// As the forward, plus grad_diffuse/grad_specular [N, 3] in; out the six
// input gradients shaped like the inputs.
int render_sg_bwd_f32(const float* albedo, const float* normal,
                      const float* rough, const float* axis, const float* lamb,
                      const float* weight, const float* view,
                      const float* dirs, const float* grad_diffuse,
                      const float* grad_specular, float* d_albedo,
                      float* d_normal, float* d_rough, float* d_axis,
                      float* d_lamb, float* d_weight, long long n_pix, int hw,
                      int k_num, int d_num, float f0, void* stream) {
  const int smem = bwd_smem_bytes(k_num, d_num);
  cudaError_t err = cudaFuncSetAttribute(
      render_sg_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned int grid =
      (unsigned int)((n_pix + kBwdThreads - 1) / kBwdThreads);
  render_sg_bwd_kernel<<<grid, kBwdThreads, smem, (cudaStream_t)stream>>>(
      albedo, normal, rough, axis, lamb, weight, view,
      reinterpret_cast<const float4*>(dirs), grad_diffuse, grad_specular,
      d_albedo, d_normal, d_rough, d_axis, d_lamb, d_weight, n_pix, hw, k_num,
      d_num, f0);
  return (int)cudaGetLastError();
}

}  // extern "C"
