// The render backward's per-pixel arithmetic: one pixel's gradients from
// its inputs, its 7K lobe scalars and the two cotangents, by the adjoint of
// sg_common.cuh.  `render_sg_bwd_kernel` (sg_render.cu) runs it on one
// thread per pixel with the lobe rows in shared memory; the CPU check
// (tests/test_torch_sg_render_host.py) runs it under g++, one pixel at a
// time.  Everything but the staging and the stores is here.
//
// The directions go in chunks of kChunk.  Per chunk: (A) the shading
// weights give the radiance adjoint genv_c = gd_c albedo_c/pi ndl_w +
// gs_c spec_w; (B) lobes outside, the chunk's directions inside, rebuild
// the mixture and add each lobe's seven partial sums into its rows;
// (C) the shading again, and its adjoint against the rebuilt mixture into
// the six frame sums and the diffuse sums.  Every sum stays with its pixel:
// no sum crosses threads.

#pragma once

#include "sg_common.cuh"

namespace sgk {

constexpr int kChunk = 8;  // directions per chunk, kept in registers

// A pixel's 7K lobe floats laid out [field][k], `stride` floats apart:
// fields axis x, y, z | lamb | weight r, g, b.  The gradient rows use the
// same fields for d_axis, d_lamb, d_weight.
struct LobeRows {
  float* p;
  int k_num;
  int stride;

  __host__ __device__ __forceinline__ float& at(int field, int k) const {
    return p[(field * k_num + k) * stride];
  }
  __host__ __device__ __forceinline__ Lobe lobe(int k) const {
    return Lobe{at(0, k), at(1, k), at(2, k), at(3, k),
                at(4, k), at(5, k), at(6, k)};
  }
};

// The per-pixel inputs besides the lobes.
struct PixelIn {
  float normal[3], view[3], rough, albedo[3], gd[3], gs[3];
};

// The per-pixel gradients besides the lobes'.
struct PixelGrad {
  float albedo[3], normal[3], rough;
};

// One pixel's backward.  dirs [d_num] (x, y, z, solid angle); `lobes` holds
// the pixel's lobe rows, `grads` receives its lobe gradients.
__host__ __device__ __forceinline__ PixelGrad render_sg_bwd_pixel(
    const PixelIn& in, const float4* dirs, int d_num, float f0,
    const LobeRows& lobes, const LobeRows& grads) {
  const int k_num = lobes.k_num;
  const Frame f = make_frame(in.normal[0], in.normal[1], in.normal[2],
                             in.view[0], in.view[1], in.view[2], in.rough);
  float gda[3];
  for (int ch = 0; ch < 3; ++ch) gda[ch] = in.gd[ch] * in.albedo[ch] *
                                           (1.0f / kPi);
  for (int i = 0; i < 7 * k_num; ++i) grads.at(0, i) = 0.0f;  // row i
  FrameGrad fg{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float sd[3] = {0.f, 0.f, 0.f};

  for (int d0 = 0; d0 < d_num; d0 += kChunk) {
    // (A) radiance adjoint per direction; a missing direction (d >= D) has
    // zero solid angle, so its ndl_w, spec_w and adjoints are all zero
    float4 c[kChunk];
    float genv[kChunk][3], env[kChunk][3];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int d = d0 + j;
      c[j] = d < d_num ? dirs[d] : make_float4(0.f, 0.f, 1.f, 0.f);
      const Shade s = shade<true>(f, c[j], f0);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        genv[j][ch] = gda[ch] * s.ndl_w + in.gs[ch] * s.spec_w;
        env[j][ch] = 0.0f;
      }
    }

    // (B) lobes: rebuild the mixture, add the seven partial sums of each
    for (int k = 0; k < k_num; ++k) {
      const Lobe g = lobes.lobe(k);
      // lobe_adjoint's order: d weight r, g, b | d lamb | d axis / lamb
      float acc[7] = {grads.at(4, k), grads.at(5, k), grads.at(6, k),
                      grads.at(3, k), grads.at(0, k), grads.at(1, k),
                      grads.at(2, k)};
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float cosm1;
        const float e = lobe(g, c[j], &cosm1);
        env[j][0] += g.wr * e;
        env[j][1] += g.wg * e;
        env[j][2] += g.wb * e;
        lobe_adjoint(g, c[j], genv[j], e, cosm1, acc);
      }
      grads.at(4, k) = acc[0];
      grads.at(5, k) = acc[1];
      grads.at(6, k) = acc[2];
      grads.at(3, k) = acc[3];
      grads.at(0, k) = acc[4];
      grads.at(1, k) = acc[5];
      grads.at(2, k) = acc[6];
    }

    // (C) shading adjoint against the rebuilt mixture
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const Shade s = shade<true>(f, c[j], f0);
      const float e_d =
          gda[0] * env[j][0] + gda[1] * env[j][1] + gda[2] * env[j][2];
      const float e_s =
          in.gs[0] * env[j][0] + in.gs[1] * env[j][1] + in.gs[2] * env[j][2];
      shade_adjoint(f, s, c[j], f0, e_d, e_s, fg);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) sd[ch] += s.ndl_w * env[j][ch];
    }
  }

  // d axis = lamb * sum gee l
  for (int k = 0; k < k_num; ++k) {
    const float lam = lobes.at(3, k);
    grads.at(0, k) *= lam;
    grads.at(1, k) *= lam;
    grads.at(2, k) *= lam;
  }
  PixelGrad out;
  frame_adjoint(f, fg, out.normal, &out.rough);
  for (int ch = 0; ch < 3; ++ch) out.albedo[ch] = in.gd[ch] * (1.0f / kPi) *
                                                  sd[ch];
  return out;
}

}  // namespace sgk
