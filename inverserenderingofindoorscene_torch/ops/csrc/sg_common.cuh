// Per-pixel SG lighting and shading math shared by the kernels
// (sg_envmap.cu, sg_envmap_bwd.cuh, sg_render_bwd.cuh and
// sg_render_env.cuh), forward and hand-derived adjoint.
//
// The forward follows the TPU kernels' `_shade_tile_math` and
// `_env_tile_math` (inverserenderingofindoorscene_tpu/ops/sg_render.py:56-186,
// :484-510) step for step, every clamp included.  The Pallas backwards run `jax.vjp` of that
// math inside the kernel; CUDA has no autodiff, so the adjoint is written
// out here in reverse order of the forward.  Its plain PyTorch twin,
// `ops/sg_render.py:render_sg_bwd_plain`, runs the same formulas pass for
// pass, (A) radiance adjoint, (B) lobes, (C) shading adjoint, each over all
// directions at once where the render backward kernel runs the three per
// chunk of directions; it is held against torch.autograd and jax.vjp on
// the CPU.
//
// Clamp derivatives follow jnp.clip (= minimum(maximum(x, lo), hi)): 1
// inside, 1/2 exactly at a bound, 0 outside.
//
// One departure, in the backward only: the GGX denominator's nom0 =
// ndh^2 (a2 - 1) + 1 cancels where ndh is near 1 at low roughness, and
// there nomr = 4 pi nom0^2 nom1 nom2 can sit within f32 noise of its 1e-6
// clamp, whose gate the gradient crosses with a jump: f32 then puts the
// pixel's normal and roughness gradient on the wrong side (one such pixel
// moved the normal gradient of a 5x120x160 tensor by 1.9e-2 relative L2
// from float64, chip_smoke.py phase 3 on an H100 80GB HBM3 at 700 W).  So
// the backward (`shade<true>`) takes nom0 = a2 ndh^2 + |n x h|^2, the same
// value in exact arithmetic, with |n x h|^2 = 1 - ndh^2 from the frame
// components of v + l, which do not cancel.  The identity needs a unit
// normal and half vector, so where a clamp leaves either short (|normal|^2
// or |h|^2 under 1e-6) and where ndh is clamped, the backward keeps the
// TPU formula.  The forwards keep it everywhere: their value, unlike its
// gradient, is continuous at the clamp.
//
// IEEE math only: no --use_fast_math, and 1/sqrtf rather than rsqrtf: the
// GGX term is ill-conditioned at low roughness (nom0 = 1 - ndh^2 (1 -
// alpha^2) cancels), and rsqrtf's 2-ulp approximation moved specular at
// percent level from the plain version.
//
// The per-pixel math is __host__ __device__: outside nvcc (a plain C++
// compiler building the CPU check of the render backward,
// tests/test_torch_sg_render_host.py) the CUDA qualifiers become plain C++
// and float4 a plain struct; the warp-level helpers exist only under nvcc.

#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include <math.h>
#define __host__
#define __device__
#define __forceinline__ inline
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
#endif

namespace sgk {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kLn2 = 0.69314718055994530942f;
constexpr int kWarp = 32;

__host__ __device__ __forceinline__ float inv_sqrt(float x) {
  return 1.0f / sqrtf(x);
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// d max(x, lo) / dx and d min(x, hi) / dx with jnp's tie rule
__host__ __device__ __forceinline__ float above(float x, float lo) {
  return x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
}
__host__ __device__ __forceinline__ float below(float x, float hi) {
  return x < hi ? 1.0f : (x == hi ? 0.5f : 0.0f);
}
__host__ __device__ __forceinline__ float inside(float x, float lo,
                                                 float hi) {
  return above(x, lo) * below(x, hi);
}

// One lobe's seven scalars: axis, sharpness, RGB amplitude.
struct Lobe {
  float ax, ay, az, lamb, wr, wg, wb;
};

// e_k(l) = exp(lamb_k (axis_k . l - 1)); cosm1 = axis_k . l - 1
__host__ __device__ __forceinline__ float lobe(const Lobe& g, float4 c,
                                               float* cosm1) {
  const float cosv = c.x * g.ax + c.y * g.ay + c.z * g.az;
  *cosm1 = cosv - 1.0f;
  return expf(g.lamb * *cosm1);
}

// `lobe` with exp2f of a sharpness scaled by log2(e) once a lobe (lamb2 =
// lamb_k log2 e): e_k = 2^(lamb2 (axis_k . l - 1)).  On the card exp2f is
// a MUFU.EX2 with a range check, ~4 instructions against ~8 for expf; the
// extra rounding of lamb2 moves e by ~1e-7 relative where e is not tiny.
// Only the kernels that choose it call this; `lobe` stays as it is.
constexpr float kLog2e = 1.44269504088896340736f;

__host__ __device__ __forceinline__ float lobe_exp2(const Lobe& g, float4 c,
                                                    float lamb2,
                                                    float* cosm1) {
  const float cosv = c.x * g.ax + c.y * g.ay + c.z * g.az;
  *cosm1 = cosv - 1.0f;
  return exp2f(lamb2 * *cosm1);
}

// Per-pixel scalars of the shading: the normalised normal, its tangent frame
// (up = (0,1,0): camy = normalize(up - (up.n) n), camx = -normalize(camy x
// n)), the view products and the roughness terms.  Intermediates the
// adjoint needs are kept; the forward kernels let the compiler drop them.
struct Frame {
  float nx, ny, nz, s, inv_n;          // raw normal, clip(|n|^2), 1/sqrt
  float ux, uy, uz;                    // normalised normal
  float cy0x, cy0y, cy0z, q1, inv_cy;  // camy before normalising
  float cyx, cyy, cyz;
  float cx0x, cx0y, cx0z, q2, inv_cx;  // camy x n before normalising
  float cxx, cxy, cxz;
  float vx, vy, vz;
  float nn, nv, v_cx, v_cy, n_cy;
  float r, kg, a2, ndv, nom1;
};

__host__ __device__ __forceinline__ Frame make_frame(float nx, float ny,
                                                     float nz, float vx,
                                                     float vy, float vz,
                                                     float rough) {
  Frame f;
  f.nx = nx;
  f.ny = ny;
  f.nz = nz;
  f.s = nx * nx + ny * ny + nz * nz;
  f.inv_n = inv_sqrt(fminf(fmaxf(f.s, 1e-6f), 1.0f));
  f.ux = nx * f.inv_n;
  f.uy = ny * f.inv_n;
  f.uz = nz * f.inv_n;
  f.cy0x = -f.uy * f.ux;
  f.cy0y = 1.0f - f.uy * f.uy;
  f.cy0z = -f.uy * f.uz;
  f.q1 = f.cy0x * f.cy0x + f.cy0y * f.cy0y + f.cy0z * f.cy0z;
  f.inv_cy = inv_sqrt(fmaxf(f.q1, 1e-12f));
  f.cyx = f.cy0x * f.inv_cy;
  f.cyy = f.cy0y * f.inv_cy;
  f.cyz = f.cy0z * f.inv_cy;
  f.cx0x = f.cyy * f.uz - f.cyz * f.uy;
  f.cx0y = f.cyz * f.ux - f.cyx * f.uz;
  f.cx0z = f.cyx * f.uy - f.cyy * f.ux;
  f.q2 = f.cx0x * f.cx0x + f.cx0y * f.cx0y + f.cx0z * f.cx0z;
  f.inv_cx = inv_sqrt(fmaxf(f.q2, 1e-12f));
  f.cxx = -f.cx0x * f.inv_cx;
  f.cxy = -f.cx0y * f.inv_cx;
  f.cxz = -f.cx0z * f.inv_cx;
  f.vx = vx;
  f.vy = vy;
  f.vz = vz;
  f.nn = f.ux * f.ux + f.uy * f.uy + f.uz * f.uz;  // 1 unless the clamp bit
  f.nv = f.ux * vx + f.uy * vy + f.uz * vz;
  f.v_cx = vx * f.cxx + vy * f.cxy + vz * f.cxz;
  f.v_cy = vx * f.cyx + vy * f.cyy + vz * f.cyz;
  f.n_cy = (f.uy - f.uy * f.nn) * f.inv_cy;
  f.r = (rough + 1.0f) * 0.5f;
  f.kg = (f.r + 1.0f) * (f.r + 1.0f) * (1.0f / 8.0f);
  f.a2 = (f.r * f.r) * (f.r * f.r);
  f.ndv = clamp01(f.nv);
  f.nom1 = f.ndv * (1.0f - f.kg) + f.kg;
  return f;
}

// Lambert + GGX weights of direction c = (lx, ly, lz, solid angle), from
// the shortcut algebra for v.l, |h|^2, n.l and n.h (exact while |n| <= 1).
// kGrad: nom0 as a2 ndh^2 + |n x h|^2 where `cross` (the backward's; see
// the top), with sx, sy the x and y of v + l in the pixel's frame.
struct Shade {
  float vl, h2, inv_h, vdh, ex2, frac0, nl, t, ndh, ndl;
  float sx, sy, nom0, nom2, nomr, nom, spec, ndl_w, spec_w;
  bool cross;
};

template <bool kGrad = false>
__host__ __device__ __forceinline__ Shade shade(const Frame& f, float4 c,
                                                float f0) {
  Shade s;
  s.vl = c.x * f.v_cx + c.y * f.v_cy + c.z * f.nv;
  s.h2 = (1.0f + s.vl) * 0.5f;
  s.inv_h = inv_sqrt(fmaxf(s.h2, 1e-6f));
  s.vdh = s.h2 * s.inv_h;
  s.ex2 = exp2f((-5.55472f * s.vdh - 6.98316f) * s.vdh);
  s.frac0 = f0 + (1.0f - f0) * s.ex2;
  s.nl = c.y * f.n_cy + c.z * f.nn;
  s.t = (f.nv + s.nl) * 0.5f * s.inv_h;
  s.ndh = clamp01(s.t);
  s.ndl = clamp01(s.nl);
  s.cross = kGrad && f.s >= 1e-6f && s.h2 >= 1e-6f && s.t > 0.0f &&
            s.t < 1.0f;
  if (s.cross) {
    s.sx = c.x + f.v_cx;
    s.sy = c.y + f.v_cy;
    s.nom0 = f.a2 * s.ndh * s.ndh +
             (s.sx * s.sx + s.sy * s.sy) * 0.25f * s.inv_h * s.inv_h;
  } else {
    s.sx = s.sy = 0.0f;
    s.nom0 = s.ndh * s.ndh * (f.a2 - 1.0f) + 1.0f;
  }
  s.nom2 = s.ndl * (1.0f - f.kg) + f.kg;
  s.nomr = 4.0f * kPi * s.nom0 * s.nom0 * f.nom1 * s.nom2;
  s.nom = fminf(fmaxf(s.nomr, 1e-6f), 4.0f * kPi);
  s.spec = f.a2 * s.frac0 / s.nom;
  s.ndl_w = s.ndl * c.w;
  s.spec_w = s.spec * s.ndl_w;
  return s;
}

// Sums over directions of the adjoints of the per-pixel scalars.
struct FrameGrad {
  float r, nv, v_cx, v_cy, n_cy, nn;
};

// Pull the adjoints of direction c's ndl_w and spec_w back to the
// per-pixel scalars and add them to `acc`.  Ed = sum_c gd_c albedo_c/pi
// env_c and Es = sum_c gs_c env_c are the adjoints of ndl_w and spec_w
// through diffuse and specular.  `s` is shade<true>'s.
__host__ __device__ __forceinline__ void shade_adjoint(const Frame& f,
                                                       const Shade& s,
                                                       float4 c, float f0,
                                                       float e_d, float e_s,
                                                       FrameGrad& acc) {
  const float g_ndlw = e_d + s.spec * e_s;
  const float g_spec = s.ndl_w * e_s;
  float g_ndl = g_ndlw * c.w;
  // spec = frac / nom, frac = a2 frac0
  const float frac = f.a2 * s.frac0;
  const float g_frac = g_spec / s.nom;
  const float g_nom = -g_spec * frac / (s.nom * s.nom);
  const float g_nomr = g_nom * inside(s.nomr, 1e-6f, 4.0f * kPi);
  // nomr = 4 pi nom0^2 nom1 nom2
  const float cg = 4.0f * kPi * g_nomr;
  const float g_nom0 = cg * 2.0f * s.nom0 * f.nom1 * s.nom2;
  const float g_nom1 = cg * s.nom0 * s.nom0 * s.nom2;
  const float g_nom2 = cg * s.nom0 * s.nom0 * f.nom1;
  float g_a2 = g_frac * s.frac0 + g_nom0 * s.ndh * s.ndh;
  const float g_frac0 = g_frac * f.a2;
  // frac0 = f0 + (1 - f0) 2^u, u = (-5.55472 vdh - 6.98316) vdh
  const float g_vdh = g_frac0 * (1.0f - f0) * s.ex2 * kLn2 *
                      (-2.0f * 5.55472f * s.vdh - 6.98316f);
  // nom0 = a2 ndh^2 + sin2 where s.cross, sin2 = (sx^2 + sy^2) inv_h^2 / 4
  const float g_ndh = g_nom0 * 2.0f * s.ndh * (s.cross ? f.a2 : f.a2 - 1.0f);
  const float g_sin2 = s.cross ? g_nom0 : 0.0f;
  const float g_s = g_sin2 * 0.5f * s.inv_h * s.inv_h;
  g_ndl += g_nom2 * (1.0f - f.kg);
  const float g_kg = g_nom2 * (1.0f - s.ndl) + g_nom1 * (1.0f - f.ndv);
  float g_nl = g_ndl * inside(s.nl, 0.0f, 1.0f);
  const float g_t = g_ndh * inside(s.t, 0.0f, 1.0f);
  float g_nv = g_t * 0.5f * s.inv_h +
               g_nom1 * (1.0f - f.kg) * inside(f.nv, 0.0f, 1.0f);
  g_nl += g_t * 0.5f * s.inv_h;
  const float g_invh = g_t * (f.nv + s.nl) * 0.5f + g_vdh * s.h2 +
                      g_sin2 * (s.sx * s.sx + s.sy * s.sy) * 0.5f * s.inv_h;
  const float g_h2 = g_vdh * s.inv_h + g_invh * -0.5f * s.inv_h * s.inv_h *
                                           s.inv_h * above(s.h2, 1e-6f);
  const float g_vl = 0.5f * g_h2;
  g_nv += g_vl * c.z;
  acc.r += g_a2 * 4.0f * f.r * f.r * f.r + g_kg * (f.r + 1.0f) * 0.25f;
  acc.nv += g_nv;
  acc.v_cx += g_vl * c.x + g_s * s.sx;
  acc.v_cy += g_vl * c.y + g_s * s.sy;
  acc.n_cy += g_nl * c.y;
  acc.nn += g_nl * c.z;
}

// The per-pixel chain from the summed adjoints back to the raw normal and
// the roughness input.
__host__ __device__ __forceinline__ void frame_adjoint(const Frame& f,
                                                       const FrameGrad& g,
                                                       float d_normal[3],
                                                       float* d_rough) {
  *d_rough = 0.5f * g.r;
  // n_cy = (uy - uy nn) inv_cy
  float gux = 0.0f, guy = g.n_cy * (1.0f - f.nn) * f.inv_cy, guz = 0.0f;
  const float g_nn = g.nn - g.n_cy * f.uy * f.inv_cy;
  float g_invcy = g.n_cy * (f.uy - f.uy * f.nn);
  // nn = |u|^2, nv = u . v
  gux += 2.0f * g_nn * f.ux + g.nv * f.vx;
  guy += 2.0f * g_nn * f.uy + g.nv * f.vy;
  guz += 2.0f * g_nn * f.uz + g.nv * f.vz;
  // v_cx = v . cx, v_cy = v . cy
  float gcyx = g.v_cy * f.vx, gcyy = g.v_cy * f.vy, gcyz = g.v_cy * f.vz;
  // cx = -cx0 inv_cx
  float gx0x = -g.v_cx * f.vx * f.inv_cx;
  float gx0y = -g.v_cx * f.vy * f.inv_cx;
  float gx0z = -g.v_cx * f.vz * f.inv_cx;
  const float g_invcx =
      -g.v_cx * (f.vx * f.cx0x + f.vy * f.cx0y + f.vz * f.cx0z);
  const float g_q2 = g_invcx * -0.5f * f.inv_cx * f.inv_cx * f.inv_cx *
                     above(f.q2, 1e-12f);
  gx0x += 2.0f * g_q2 * f.cx0x;
  gx0y += 2.0f * g_q2 * f.cx0y;
  gx0z += 2.0f * g_q2 * f.cx0z;
  // cx0 = cy x u: d cy += u x g, d u += g x cy
  gcyx += f.uy * gx0z - f.uz * gx0y;
  gcyy += f.uz * gx0x - f.ux * gx0z;
  gcyz += f.ux * gx0y - f.uy * gx0x;
  gux += gx0y * f.cyz - gx0z * f.cyy;
  guy += gx0z * f.cyx - gx0x * f.cyz;
  guz += gx0x * f.cyy - gx0y * f.cyx;
  // cy = cy0 inv_cy
  float gy0x = gcyx * f.inv_cy, gy0y = gcyy * f.inv_cy,
        gy0z = gcyz * f.inv_cy;
  g_invcy += gcyx * f.cy0x + gcyy * f.cy0y + gcyz * f.cy0z;
  const float g_q1 = g_invcy * -0.5f * f.inv_cy * f.inv_cy * f.inv_cy *
                     above(f.q1, 1e-12f);
  gy0x += 2.0f * g_q1 * f.cy0x;
  gy0y += 2.0f * g_q1 * f.cy0y;
  gy0z += 2.0f * g_q1 * f.cy0z;
  // cy0 = (-uy ux, 1 - uy^2, -uy uz)
  gux += -gy0x * f.uy;
  guy += -gy0x * f.ux - 2.0f * gy0y * f.uy - gy0z * f.uz;
  guz += -gy0z * f.uy;
  // u = n inv_n, inv_n = 1/sqrt(clip(s, 1e-6, 1))
  const float g_invn = gux * f.nx + guy * f.ny + guz * f.nz;
  const float g_s = g_invn * -0.5f * f.inv_n * f.inv_n * f.inv_n *
                    inside(f.s, 1e-6f, 1.0f);
  d_normal[0] = gux * f.inv_n + 2.0f * g_s * f.nx;
  d_normal[1] = guy * f.inv_n + 2.0f * g_s * f.ny;
  d_normal[2] = guz * f.inv_n + 2.0f * g_s * f.nz;
}

// Adjoint of the SG mixture at direction c for lobe g, given the radiance
// adjoint genv[3] there: adds d w_c, d lamb and (d axis) / lamb, in that
// order, to acc[7].
__host__ __device__ __forceinline__ void lobe_adjoint(const Lobe& g, float4 c,
                                                      const float genv[3],
                                                      float e, float cosm1,
                                                      float acc[7]) {
  const float ge = genv[0] * g.wr + genv[1] * g.wg + genv[2] * g.wb;
  acc[0] += genv[0] * e;
  acc[1] += genv[1] * e;
  acc[2] += genv[2] * e;
  const float gee = ge * e;
  acc[3] += gee * cosm1;
  acc[4] += gee * c.x;
  acc[5] += gee * c.y;
  acc[6] += gee * c.z;
}

#ifdef __CUDACC__

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One thread's asynchronous copy of 16 (or 4) bytes from device memory to
// shared memory; the caller commits and waits for cp.async groups.
__device__ __forceinline__ void copy16(float* s, const float* g) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(g)
               : "memory");
}

__device__ __forceinline__ void copy4(float* s, const float* g) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(g)
               : "memory");
}

#endif  // __CUDACC__

}  // namespace sgk
