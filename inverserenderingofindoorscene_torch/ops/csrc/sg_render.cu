// Fused SG decode + Lambert/GGX shading for training, forward and backward,
// on Hopper (sm_90a).
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel`
// (inverserenderingofindoorscene_tpu/ops/sg_render.py:189-211, launched by
// `_run_fwd` :240 and `_sg_render_bwd` :271; math `_shade_tile_math`
// :56-186).  Per pixel the forward evaluates the K-lobe SG mixture on the D
// hemisphere directions and integrates
//   diffuse_c = albedo_c / pi sum_d ndl_w(d) env_c(d),
//   specular_c = sum_d spec_w(d) env_c(d)
// without writing the envmap out.  The backward recomputes the forward and
// pulls (gd, gs) back to albedo, normal, rough, axis, lamb and weight with
// the hand-derived adjoint of sg_common.cuh; the view direction gets none.
// PRECONDITION, as for the TPU kernel: |normal| <= 1 (the shortcut algebra
// for v.l, |h|^2, n.l and n.h is exact only then).
//
// What bounds them.  At the training shape (N = 96,000 pixels, K=12,
// D=128) the forward moves 7K+7 = 91 input floats and 6 output floats a
// pixel (~37 MB, ~11 us) but does N (8K+45) D ~ 1.73 GFLOP (~26 us at the
// 67 TFLOP/s f32 rate), so it is bound by operations; the backward does
// about three times the forward's operations (~78 us).  Every operation is
// per pixel and per direction; there is no reuse for tensor cores.
//
// What the design does about it.  One warp per pixel, eight pixels to a
// block; lane i takes directions i, i+32, ....  The pixel's 7K SG scalars
// are staged once in shared memory and read as broadcasts; the per-pixel
// frame (normal, tangent frame, view products, roughness terms) is computed
// by every lane in registers.  The forward reduces its six sums with warp
// shuffles.  The backward runs three passes over the lane's directions, all
// in registers: (A) the shading weights give the radiance adjoint
// g_env_c = gd_c albedo_c/pi ndl_w + gs_c spec_w; (B) lobes outside,
// directions inside, rebuild the mixture and reduce each lobe's seven sums
// with shuffles; (C) the shading adjoint, with the rebuilt mixture, reduced
// to nine per-pixel sums, then the per-pixel chain back to the normal.

#include "sg_common.cuh"

namespace {

using namespace sgk;

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ Frame pixel_frame(const float* normal,
                                             const float* rough,
                                             const float* view, long long p,
                                             int hw) {
  const long long q = 3 * (p % hw);  // the view vector depends on (row, col)
  return make_frame(normal[3 * p], normal[3 * p + 1], normal[3 * p + 2],
                    view[q], view[q + 1], view[q + 2], rough[p]);
}

__global__ void render_sg_fwd_kernel(
    const float* __restrict__ albedo, const float* __restrict__ normal,
    const float* __restrict__ rough, const float* __restrict__ axis,
    const float* __restrict__ lamb, const float* __restrict__ weight,
    const float* __restrict__ view, const float4* __restrict__ dirs,
    float* __restrict__ diffuse, float* __restrict__ specular,
    long long n_pix, int hw, int k_num, int d_num, float f0) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (p >= n_pix) return;  // whole warps leave; no block barrier follows
  const Lobes g = stage_lobes(smem + warp * 7 * k_num, axis, lamb, weight, p,
                              k_num, lane);
  const Frame f = pixel_frame(normal, rough, view, p, hw);
  float sum[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int d = lane; d < d_num; d += kWarp) {
    const float4 c = dirs[d];
    float env[3];
    mixture(g, k_num, c, env);
    const Shade s = shade(f, c, f0);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      sum[ch] += s.ndl_w * env[ch];
      sum[3 + ch] += s.spec_w * env[ch];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) sum[i] = warp_sum(sum[i]);
  if (lane < 3) {
    const float sd = lane == 0 ? sum[0] : (lane == 1 ? sum[1] : sum[2]);
    const float ss = lane == 0 ? sum[3] : (lane == 1 ? sum[4] : sum[5]);
    diffuse[3 * p + lane] = albedo[3 * p + lane] * (1.0f / kPi) * sd;
    specular[3 * p + lane] = ss;
  }
}

// DPL directions per lane (D <= 32 DPL), kept in registers across passes.
template <int DPL>
__global__ void render_sg_bwd_kernel(
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
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (p >= n_pix) return;
  const Lobes g = stage_lobes(smem + warp * 7 * k_num, axis, lamb, weight, p,
                              k_num, lane);
  const Frame f = pixel_frame(normal, rough, view, p, hw);
  float gd[3], gs[3], gda[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    gd[ch] = grad_diffuse[3 * p + ch];
    gs[ch] = grad_specular[3 * p + ch];
    gda[ch] = gd[ch] * albedo[3 * p + ch] * (1.0f / kPi);
  }

  // (A) radiance adjoint per direction; a missing direction (d >= D) has
  // zero solid angle, so its ndl_w, spec_w and adjoint are all zero
  float4 c[DPL];
  float genv[DPL][3], env[DPL][3];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + kWarp * j;
    c[j] = d < d_num ? dirs[d] : make_float4(0.f, 0.f, 1.f, 0.f);
    const Shade s = shade(f, c[j], f0);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      genv[j][ch] = gda[ch] * s.ndl_w + gs[ch] * s.spec_w;
      env[j][ch] = 0.0f;
    }
  }

  // (B) lobes: rebuild the mixture, reduce the seven sums of each lobe
  for (int k = 0; k < k_num; ++k) {
    float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      float cosm1;
      const float e = lobe(g, k, c[j], &cosm1);
      env[j][0] += g.weight[3 * k] * e;
      env[j][1] += g.weight[3 * k + 1] * e;
      env[j][2] += g.weight[3 * k + 2] * e;
      lobe_adjoint(g, k, c[j], genv[j], e, cosm1, acc);
    }
    write_lobe_grads(g, k, acc, p, k_num, lane, d_axis, d_lamb, d_weight);
  }

  // (C) shading adjoint against the rebuilt mixture
  FrameGrad fg{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float sd[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const Shade s = shade(f, c[j], f0);
    const float e_d =
        gda[0] * env[j][0] + gda[1] * env[j][1] + gda[2] * env[j][2];
    const float e_s =
        gs[0] * env[j][0] + gs[1] * env[j][1] + gs[2] * env[j][2];
    shade_adjoint(f, s, c[j], f0, e_d, e_s, fg);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) sd[ch] += s.ndl_w * env[j][ch];
  }
  fg.r = warp_sum(fg.r);
  fg.nv = warp_sum(fg.nv);
  fg.v_cx = warp_sum(fg.v_cx);
  fg.v_cy = warp_sum(fg.v_cy);
  fg.n_cy = warp_sum(fg.n_cy);
  fg.nn = warp_sum(fg.nn);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) sd[ch] = warp_sum(sd[ch]);
  if (lane == 0) {
    float dn[3], dr;
    frame_adjoint(f, fg, dn, &dr);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      d_albedo[3 * p + ch] = gd[ch] * (1.0f / kPi) * sd[ch];
      d_normal[3 * p + ch] = dn[ch];
    }
    d_rough[p] = dr;
  }
}

int smem_bytes(int k_num) {
  return (int)sizeof(float) * kWarpsPerBlock * 7 * k_num;
}

unsigned int n_blocks(long long n_pix) {
  return (unsigned int)((n_pix + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

// Shared-memory bytes a block needs for K lobes.
int render_sg_smem_bytes(int k_num) { return smem_bytes(k_num); }

// Launch on `stream`; return cudaGetLastError() after the launch.  Pointers
// are contiguous float32 device arrays: albedo/normal [N, 3], rough [N, 1],
// axis/weight [N, 3K], lamb [N, K], view [HW, 3] (pixel p uses row p % HW),
// dirs [D, 4]; out diffuse/specular [N, 3].
int render_sg_fwd_f32(const float* albedo, const float* normal,
                      const float* rough, const float* axis, const float* lamb,
                      const float* weight, const float* view,
                      const float* dirs, float* diffuse, float* specular,
                      long long n_pix, int hw, int k_num, int d_num, float f0,
                      void* stream) {
  render_sg_fwd_kernel<<<n_blocks(n_pix), kWarpsPerBlock * kWarp,
                         smem_bytes(k_num), (cudaStream_t)stream>>>(
      albedo, normal, rough, axis, lamb, weight, view,
      reinterpret_cast<const float4*>(dirs), diffuse, specular, n_pix, hw,
      k_num, d_num, f0);
  return (int)cudaGetLastError();
}

// As the forward, plus grad_diffuse/grad_specular [N, 3] in; out the six
// input gradients shaped like the inputs.  D <= 128.
int render_sg_bwd_f32(const float* albedo, const float* normal,
                      const float* rough, const float* axis, const float* lamb,
                      const float* weight, const float* view,
                      const float* dirs, const float* grad_diffuse,
                      const float* grad_specular, float* d_albedo,
                      float* d_normal, float* d_rough, float* d_axis,
                      float* d_lamb, float* d_weight, long long n_pix, int hw,
                      int k_num, int d_num, float f0, void* stream) {
  const dim3 grid(n_blocks(n_pix)), block(kWarpsPerBlock * kWarp);
  const int smem = smem_bytes(k_num);
  const cudaStream_t s = (cudaStream_t)stream;
  const float4* d4 = reinterpret_cast<const float4*>(dirs);
#define SG_RENDER_BWD(DPL)                                                  \
  render_sg_bwd_kernel<DPL><<<grid, block, smem, s>>>(                      \
      albedo, normal, rough, axis, lamb, weight, view, d4, grad_diffuse,    \
      grad_specular, d_albedo, d_normal, d_rough, d_axis, d_lamb, d_weight, \
      n_pix, hw, k_num, d_num, f0)
  switch ((d_num + kWarp - 1) / kWarp) {
    case 1: SG_RENDER_BWD(1); break;
    case 2: SG_RENDER_BWD(2); break;
    case 3: SG_RENDER_BWD(3); break;
    case 4: SG_RENDER_BWD(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SG_RENDER_BWD
  return (int)cudaGetLastError();
}

}  // extern "C"
