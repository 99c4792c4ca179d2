// SG mixture -> per-pixel envmap, forward and backward, on Hopper (sm_90a).
//
// Replaces the TPU kernels `_env_fwd_kernel` and `_env_bwd_kernel`
// (inverserenderingofindoorscene_tpu/ops/sg_render.py:513-528, launched by
// `_env_run_fwd` :536 and `_get_env_op.bwd` :577; math `_env_tile_math`
// :484-510).  Per pixel the forward evaluates
//   env_c(l_d) = sum_k w_kc exp(lamb_k (a_k . l_d - 1))
// on the D hemisphere directions and writes [D, 3].  The backward takes the
// envmap's adjoint g [D, 3] and writes, per lobe, the 7 sums over D
//   d w_kc = sum_d g_c e_k,   d lamb_k = sum_d ge_k e_k (a_k . l_d - 1),
//   d a_k = lamb_k sum_d ge_k e_k l_d,   ge_k = sum_c g_c w_kc.
//
// What bounds them.  At the training shape (B=5, 120x160 grid, K=12,
// D=128: N = 96,000 pixels) the forward reads 7K = 84 floats a pixel and
// writes 3D = 384; the backward reads 84 + 384 and writes 84.  The
// arithmetic (N K D ~ 147 M exp and ~1.2 GFLOP forward, ~3x that backward)
// is under 40 us at the f32 rate, so both are bound by device-memory bytes:
// ~180 MB forward (~54 us at 3.35 TB/s), ~212 MB backward (~63 us).
//
// What the design does about it.  One warp per pixel, eight pixels to a
// block; lane i takes directions i, i+32, i+64, i+96.  The pixel's 7K SG
// scalars are staged once in shared memory and read as broadcasts.  The
// envmap and its adjoint move as one contiguous run of 3D floats per pixel,
// the lanes of a warp on neighbouring triples, so those reads and writes
// coalesce.  In the backward each lane keeps its directions' adjoints in
// registers, loops over lobes outside and directions inside, and reduces
// each lobe's seven sums with warp shuffles: 7K reductions per pixel and no
// shared-memory round trip.  The TPU kernels' transposed [D, P] tiles exist
// for TPU lanes and are not carried over.

#include "sg_common.cuh"

namespace {

using namespace sgk;

constexpr int kWarpsPerBlock = 8;

__global__ void sg_envmap_fwd_kernel(const float* __restrict__ axis,
                                     const float* __restrict__ lamb,
                                     const float* __restrict__ weight,
                                     const float4* __restrict__ dirs,
                                     float* __restrict__ env, long long n_pix,
                                     int k_num, int d_num) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (p >= n_pix) return;  // whole warps leave; no block barrier follows
  const Lobes g = stage_lobes(smem + warp * 7 * k_num, axis, lamb, weight, p,
                              k_num, lane);
  float* out = env + p * 3 * d_num;
  for (int d = lane; d < d_num; d += kWarp) {
    float e[3];
    mixture(g, k_num, dirs[d], e);
    out[3 * d] = e[0];
    out[3 * d + 1] = e[1];
    out[3 * d + 2] = e[2];
  }
}

// DPL directions per lane (D <= 32 DPL), kept in registers across lobes.
template <int DPL>
__global__ void sg_envmap_bwd_kernel(
    const float* __restrict__ axis, const float* __restrict__ lamb,
    const float* __restrict__ weight, const float4* __restrict__ dirs,
    const float* __restrict__ g_env, float* __restrict__ d_axis,
    float* __restrict__ d_lamb, float* __restrict__ d_weight,
    long long n_pix, int k_num, int d_num) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (p >= n_pix) return;
  const Lobes g = stage_lobes(smem + warp * 7 * k_num, axis, lamb, weight, p,
                              k_num, lane);
  const float* gp = g_env + p * 3 * d_num;
  float4 c[DPL];
  float ge[DPL][3];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + kWarp * j;
    const bool ok = d < d_num;
    c[j] = ok ? dirs[d] : make_float4(0.f, 0.f, 0.f, 0.f);
    ge[j][0] = ok ? gp[3 * d] : 0.0f;  // a missing direction adds nothing
    ge[j][1] = ok ? gp[3 * d + 1] : 0.0f;
    ge[j][2] = ok ? gp[3 * d + 2] : 0.0f;
  }
  for (int k = 0; k < k_num; ++k) {
    float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      float cosm1;
      const float e = lobe(g, k, c[j], &cosm1);
      lobe_adjoint(g, k, c[j], ge[j], e, cosm1, acc);
    }
    write_lobe_grads(g, k, acc, p, k_num, lane, d_axis, d_lamb, d_weight);
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
int sg_envmap_smem_bytes(int k_num) { return smem_bytes(k_num); }

// Launch on `stream`; return cudaGetLastError() after the launch.  Pointers
// are contiguous float32 device arrays: axis/weight [N, 3K], lamb [N, K],
// dirs [D, 4] (x, y, z, solid angle); out env [N, D, 3].
int sg_envmap_fwd_f32(const float* axis, const float* lamb,
                      const float* weight, const float* dirs, float* env,
                      long long n_pix, int k_num, int d_num, void* stream) {
  sg_envmap_fwd_kernel<<<n_blocks(n_pix), kWarpsPerBlock * kWarp,
                         smem_bytes(k_num), (cudaStream_t)stream>>>(
      axis, lamb, weight, reinterpret_cast<const float4*>(dirs), env, n_pix,
      k_num, d_num);
  return (int)cudaGetLastError();
}

// g_env [N, D, 3] in; d_axis/d_weight [N, 3K], d_lamb [N, K] out.  D <= 128.
int sg_envmap_bwd_f32(const float* axis, const float* lamb,
                      const float* weight, const float* dirs,
                      const float* g_env, float* d_axis, float* d_lamb,
                      float* d_weight, long long n_pix, int k_num, int d_num,
                      void* stream) {
  const dim3 grid(n_blocks(n_pix)), block(kWarpsPerBlock * kWarp);
  const int smem = smem_bytes(k_num);
  const cudaStream_t s = (cudaStream_t)stream;
  const float4* d4 = reinterpret_cast<const float4*>(dirs);
#define SG_ENVMAP_BWD(DPL)                                                  \
  sg_envmap_bwd_kernel<DPL><<<grid, block, smem, s>>>(                      \
      axis, lamb, weight, d4, g_env, d_axis, d_lamb, d_weight, n_pix, k_num, \
      d_num)
  switch ((d_num + kWarp - 1) / kWarp) {
    case 1: SG_ENVMAP_BWD(1); break;
    case 2: SG_ENVMAP_BWD(2); break;
    case 3: SG_ENVMAP_BWD(3); break;
    case 4: SG_ENVMAP_BWD(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SG_ENVMAP_BWD
  return (int)cudaGetLastError();
}

}  // extern "C"
