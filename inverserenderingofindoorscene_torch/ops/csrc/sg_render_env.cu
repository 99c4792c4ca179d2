// Fused SG decode + shading + envmap output for serving, on Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_env5_kernel` launched by `render_sg_env`
// (inverserenderingofindoorscene_tpu/ops/sg_render.py:397-472; its math is
// `_shade_tile_math`, :56-186).  Per pixel it evaluates the K-lobe
// spherical-Gaussian mixture on the D hemisphere directions once, writes
// that decoded envmap [D, 3] out, and integrates Lambert + GGX against it
// into diffuse and specular [3].  Forward only: serving never
// differentiates.
//
// What bounds it.  At the serving shape (B=1, 120x160 grid, K=12, D=128)
// each pixel reads 7K+7 = 91 floats (plus its 3-float view vector) and
// writes 6 + 3D = 390; the 384-float envmap is 80% of the ~37 MB moved, and
// at 3.35 TB/s that is ~11 us.  The arithmetic (n*(8K+45)*D ~ 346 MFLOP and
// n*(K+2)*D ~ 34 M exp/exp2) is below 10 us at the f32 rate, so the kernel
// is bound by device-memory bytes, almost all of them the envmap write.
//
// What the design does about it.  One block per pixel, one thread per
// direction.  The pixel's 7K SG scalars are staged once in shared memory
// (every thread reads all of them, a broadcast); its 10 BRDF/view scalars
// are read by every thread from the same addresses (one transaction per
// warp).  Each thread keeps its direction's radiance in registers, so the
// SG mixture is evaluated once for both products.  The envmap goes through
// shared memory and leaves the block as one contiguous run of 3D floats in
// 16-byte stores, so the dominant write is fully coalesced.  The six
// diffuse/specular sums over D are reduced with warp shuffles, then across
// warps in shared memory.  Direction constants (x, y, z, solid-angle
// weight) are a [D, 4] device array read as float4: neighbouring threads
// read neighbouring directions, which `__constant__` memory would
// serialize.  The TPU kernel's transposed [D, P] tiles exist for TPU lanes
// and are not carried over.  Making it faster (several pixels per block,
// TMA for the SG block) is later work.
//
// Numerics follow `_shade_tile_math` step for step, including every clamp:
// clip(|n|^2, 1e-6, 1), the 1e-12 frame clamps, clip(h2, 1e-6),
// clip(nom, 1e-6, 4 pi), and the exp2 Fresnel.  The algebraic shortcuts for
// v.l, |h|^2, n.l and n.h hold while |normal| <= 1 (pooled unit normals
// only shrink).  Build without --use_fast_math: the tolerances against the
// plain PyTorch version assume IEEE expf/exp2f/sqrtf and division.

#include <cuda_runtime.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 1/sqrt with IEEE-rounded sqrtf and division.  The GGX term is
// ill-conditioned at low roughness (nom0 = 1 - ndh^2 (1 - alpha^2) cancels),
// and rsqrtf's 2-ulp approximation there moved specular at percent level
// from the plain version; this form reproduces the TPU kernel's f32
// arithmetic.
__device__ __forceinline__ float inv_sqrt(float x) { return 1.0f / sqrtf(x); }

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// One block per pixel p, blockDim.x = D rounded up to a warp multiple.
// Shared memory: env [3D] | sums [6W] | axis [3K] | lamb [K] | weight [3K];
// the envmap comes first so its float4 reads are 16-byte aligned.
__global__ void sg_render_env_kernel(
    const float* __restrict__ albedo, const float* __restrict__ normal,
    const float* __restrict__ rough, const float* __restrict__ axis,
    const float* __restrict__ lamb, const float* __restrict__ weight,
    const float* __restrict__ view, const float4* __restrict__ dirs,
    float* __restrict__ diffuse, float* __restrict__ specular,
    float* __restrict__ env, int hw, int k_num, int d_num, float f0) {
  extern __shared__ float4 smem4[];
  const int n_warps = blockDim.x >> 5;
  float* s_env = reinterpret_cast<float*>(smem4);
  float* s_sum = s_env + 3 * d_num;
  float* s_axis = s_sum + 6 * n_warps;
  float* s_lamb = s_axis + 3 * k_num;
  float* s_wgt = s_lamb + k_num;

  const long long p = blockIdx.x;
  const int t = threadIdx.x;
  for (int i = t; i < 3 * k_num; i += blockDim.x) {
    s_axis[i] = axis[p * 3 * k_num + i];
    s_wgt[i] = weight[p * 3 * k_num + i];
  }
  for (int i = t; i < k_num; i += blockDim.x) s_lamb[i] = lamb[p * k_num + i];

  // --- per-pixel scalars (every thread, same addresses) ---
  float nx = normal[3 * p], ny = normal[3 * p + 1], nz = normal[3 * p + 2];
  const float inv_n =
      inv_sqrt(fminf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-6f), 1.0f));
  nx *= inv_n;
  ny *= inv_n;
  nz *= inv_n;
  // tangent frame, up = (0,1,0): camy = normalize(up - (up.n) n),
  // camx = -normalize(camy x n)
  float cyx = -ny * nx, cyy = 1.0f - ny * ny, cyz = -ny * nz;
  const float inv_cy =
      inv_sqrt(fmaxf(cyx * cyx + cyy * cyy + cyz * cyz, 1e-12f));
  cyx *= inv_cy;
  cyy *= inv_cy;
  cyz *= inv_cy;
  float cxx = cyy * nz - cyz * ny;
  float cxy = cyz * nx - cyx * nz;
  float cxz = cyx * ny - cyy * nx;
  const float inv_cx =
      inv_sqrt(fmaxf(cxx * cxx + cxy * cxy + cxz * cxz, 1e-12f));
  cxx = -cxx * inv_cx;
  cxy = -cxy * inv_cx;
  cxz = -cxz * inv_cx;

  const long long q = 3 * (p % hw);  // the view vector depends on (row, col)
  const float vx = view[q], vy = view[q + 1], vz = view[q + 2];
  const float nn = nx * nx + ny * ny + nz * nz;  // 1 unless the clamp bit
  const float nv = nx * vx + ny * vy + nz * vz;
  const float v_cx = vx * cxx + vy * cxy + vz * cxz;
  const float v_cy = vx * cyx + vy * cyy + vz * cyz;
  const float n_cy = (ny - ny * nn) * inv_cy;

  const float r = (rough[p] + 1.0f) * 0.5f;
  const float k_g = (r + 1.0f) * (r + 1.0f) * (1.0f / 8.0f);
  const float alpha2 = (r * r) * (r * r);
  const float ndv = clamp01(nv);
  const float nom1 = ndv * (1.0f - k_g) + k_g;
  __syncthreads();  // SG scalars staged

  // --- this thread's direction ---
  float dr = 0.f, dg = 0.f, db = 0.f, sr = 0.f, sg = 0.f, sb = 0.f;
  if (t < d_num) {
    const float4 c = dirs[t];  // (lx, ly, lz, solid-angle weight)
    float er = 0.f, eg = 0.f, eb = 0.f;
    for (int k = 0; k < k_num; ++k) {
      const float cosv = c.x * s_axis[3 * k] + c.y * s_axis[3 * k + 1] +
                         c.z * s_axis[3 * k + 2];
      const float e = expf(s_lamb[k] * (cosv - 1.0f));
      er += s_wgt[3 * k] * e;
      eg += s_wgt[3 * k + 1] * e;
      eb += s_wgt[3 * k + 2] * e;
    }
    s_env[3 * t] = er;
    s_env[3 * t + 1] = eg;
    s_env[3 * t + 2] = eb;

    // shading dot products without materializing l and h (exact while
    // |n| <= 1): v.l, |h|^2 = (1 + v.l)/2, v.h, n.l, n.h
    const float vl = c.x * v_cx + c.y * v_cy + c.z * nv;
    const float h2 = (1.0f + vl) * 0.5f;
    const float inv_h = inv_sqrt(fmaxf(h2, 1e-6f));
    const float vdh = h2 * inv_h;
    const float frac0 =
        f0 + (1.0f - f0) * exp2f((-5.55472f * vdh - 6.98316f) * vdh);
    const float nl = c.y * n_cy + c.z * nn;
    const float ndh = clamp01((nv + nl) * 0.5f * inv_h);
    const float ndl = clamp01(nl);
    const float frac = alpha2 * frac0;
    const float nom0 = ndh * ndh * (alpha2 - 1.0f) + 1.0f;
    const float nom2 = ndl * (1.0f - k_g) + k_g;
    const float nom = fminf(
        fmaxf(4.0f * kPi * nom0 * nom0 * nom1 * nom2, 1e-6f), 4.0f * kPi);
    const float spec = frac / nom;
    const float ndl_w = ndl * c.w;
    const float spec_w = spec * ndl_w;
    dr = ndl_w * er;
    dg = ndl_w * eg;
    db = ndl_w * eb;
    sr = spec_w * er;
    sg = spec_w * eg;
    sb = spec_w * eb;
  }

  // --- reduce the six sums over directions ---
  const int lane = t & 31, warp = t >> 5;
  dr = warp_sum(dr);
  dg = warp_sum(dg);
  db = warp_sum(db);
  sr = warp_sum(sr);
  sg = warp_sum(sg);
  sb = warp_sum(sb);
  if (lane == 0) {
    s_sum[0 * n_warps + warp] = dr;
    s_sum[1 * n_warps + warp] = dg;
    s_sum[2 * n_warps + warp] = db;
    s_sum[3 * n_warps + warp] = sr;
    s_sum[4 * n_warps + warp] = sg;
    s_sum[5 * n_warps + warp] = sb;
  }
  __syncthreads();  // envmap and partial sums in shared memory
  if (t < 6) {
    float s = 0.f;
    for (int w = 0; w < n_warps; ++w) s += s_sum[t * n_warps + w];
    if (t < 3) {
      diffuse[3 * p + t] = albedo[3 * p + t] * (1.0f / kPi) * s;
    } else {
      specular[3 * p + t - 3] = s;
    }
  }

  // --- envmap out: one contiguous run of 3D floats per pixel ---
  const int n_env = 3 * d_num;
  float* out = env + p * n_env;
  if ((n_env & 3) == 0) {  // 16-byte aligned rows: float4 stores
    const float4* src = reinterpret_cast<const float4*>(s_env);
    float4* dst = reinterpret_cast<float4*>(out);
    for (int i = t; i < (n_env >> 2); i += blockDim.x) dst[i] = src[i];
  } else {
    for (int i = t; i < n_env; i += blockDim.x) out[i] = s_env[i];
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes the kernel needs for K lobes and D directions.
int sg_render_env_smem_bytes(int k_num, int d_num) {
  const int threads = ((d_num + 31) / 32) * 32;
  return (int)sizeof(float) * (7 * k_num + 3 * d_num + 6 * (threads / 32));
}

// Launch on `stream`; returns cudaGetLastError() after the launch.
// All pointers are contiguous float32 device arrays: albedo/normal [N,3],
// rough [N,1], axis/weight [N,3K], lamb [N,K], view [HW,3] (pixel p uses
// row p % HW), dirs [D,4]; out diffuse/specular [N,3], env [N,D,3].
int sg_render_env_f32(const float* albedo, const float* normal,
                      const float* rough, const float* axis, const float* lamb,
                      const float* weight, const float* view,
                      const float* dirs, float* diffuse, float* specular,
                      float* env, long long n_pix, int hw, int k_num,
                      int d_num, float f0, void* stream) {
  const int threads = ((d_num + 31) / 32) * 32;
  const int smem = sg_render_env_smem_bytes(k_num, d_num);
  sg_render_env_kernel<<<(unsigned int)n_pix, threads, smem,
                         (cudaStream_t)stream>>>(
      albedo, normal, rough, axis, lamb, weight, view,
      reinterpret_cast<const float4*>(dirs), diffuse, specular, env, hw,
      k_num, d_num, f0);
  return (int)cudaGetLastError();
}

}  // extern "C"
