// The SG walk's per-pixel and per-lane arithmetic: the raw layout of a
// pixel's SG inputs, its lobe records, the frame prologue and one lane's
// pass over its directions.  `sg_render_walk_kernel` (sg_render_env.cu)
// runs them on one warp per pixel, each warp walking its own pixels, for
// three entries: `render_sg_env` stores the envmap and shades,
// `render_sg_fwd` shades without storing, `sg_envmap_fwd` stores without
// shading.  The CPU check (tests/test_torch_sg_render_env_host.py)
// builds this header with g++ and runs the same functions warp by warp and
// lane by lane, so the pixel walk, the frame batches, the lane split, the
// tail of the directions, the record layout and the envmap stores are
// checked before the card.  The shading is sg_common.cuh's `make_frame`
// and `shade`, as in training.

#pragma once

#include "sg_common.cuh"

namespace sgk {

constexpr int kDirsPerLane = 4;  // directions a lane holds in registers
constexpr int kPassDirs = kWarp * kDirsPerLane;  // directions a warp pass
constexpr int kRecord = 8;  // floats a lobe record: ax ay az lamb | wr wg wb -
// a pixel's frame slot: the 8 scalars `shade` reads, then albedo / pi, pad
constexpr int kFrameFloats = 12;

// A pixel's raw SG inputs as they arrive from device memory, each run
// starting on 16 bytes: axis [3K] | lamb [K] | weight [3K].
struct Raw {
  static __host__ __device__ int lamb(int k_num) { return round4(3 * k_num); }
  static __host__ __device__ int weight(int k_num) {
    return lamb(k_num) + round4(k_num);
  }
  static __host__ __device__ int floats(int k_num) {
    return weight(k_num) + round4(3 * k_num);
  }
};

// Pixel j of the warp numbered `warp_id` of `n_warps`: the warps take the
// pixels in turn, so their counts differ by one at most.
__host__ __device__ __forceinline__ int warp_pixel(int warp_id, int j,
                                                   int n_warps) {
  return warp_id + j * n_warps;
}

// The lobe records of one pixel from its raw inputs: record k = (axis_k,
// lamb_k | weight_k, 0), with lamb_k log2(e) in place of lamb_k for
// kExp2's exponential (sg_common.cuh `lobe_exp2`).  Threads first, first +
// step, ... take lobes first, first + step, ...
template <bool kExp2>
__host__ __device__ __forceinline__ void build_records(float* rec,
                                                       const float* raw,
                                                       int k_num, int first,
                                                       int step) {
  const float* ax = raw;
  const float* lm = raw + Raw::lamb(k_num);
  const float* wt = raw + Raw::weight(k_num);
  for (int k = first; k < k_num; k += step) {
    float4* r = reinterpret_cast<float4*>(rec + kRecord * k);
    const float lamb = kExp2 ? lm[k] * kLog2e : lm[k];
    r[0] = make_float4(ax[3 * k], ax[3 * k + 1], ax[3 * k + 2], lamb);
    r[1] = make_float4(wt[3 * k], wt[3 * k + 1], wt[3 * k + 2], 0.0f);
  }
}

// The prologue: pixel p's frame slot, the scalars of (normal, view, rough)
// that `shade` reads and albedo / pi, computed once a pixel.  Pixel p
// reads view row p % hw.
__host__ __device__ __forceinline__ void frame_slot(
    const float* albedo, const float* normal, const float* rough,
    const float* view, int p, int hw, float out[kFrameFloats]) {
  const int q = 3 * (p % hw);
  const Frame f = make_frame(normal[3 * p], normal[3 * p + 1],
                             normal[3 * p + 2], view[q], view[q + 1],
                             view[q + 2], rough[p]);
  out[0] = f.v_cx;
  out[1] = f.v_cy;
  out[2] = f.nv;
  out[3] = f.n_cy;
  out[4] = f.nn;
  out[5] = f.a2;
  out[6] = f.kg;
  out[7] = f.nom1;
  for (int ch = 0; ch < 3; ++ch) out[8 + ch] = albedo[3 * p + ch] * (1.0f / kPi);
  out[11] = 0.0f;
}

// A Frame holding the slot's scalars (two 16-byte loads); the fields
// `shade` does not read stay zero.
__host__ __device__ __forceinline__ Frame load_frame(const float* in) {
  const float4 a = reinterpret_cast<const float4*>(in)[0];
  const float4 b = reinterpret_cast<const float4*>(in)[1];
  Frame f{};
  f.v_cx = a.x;
  f.v_cy = a.y;
  f.nv = a.z;
  f.n_cy = a.w;
  f.nn = b.x;
  f.a2 = b.y;
  f.kg = b.z;
  f.nom1 = b.w;
  return f;
}

// One lane's share of a warp's pass over directions c0 .. c0 + kPassDirs
// - 1 of one pixel: d = c0 + lane + kWarp j, j < kDirsPerLane.  The mixture
// first: lobes outside, the lane's directions inside, so each record (two
// 16-byte loads) serves all of them.  Directions past d_num (the tail) run
// on a dummy direction of zero solid angle.  Keeps the directions in c and
// their mixture in env and, with kStoreEnv, writes the mixture at d to
// env_pass[3 (d - c0) + ch] for d < d_num (the kernel passes the pixel's
// envmap in device memory: the warp's three stores of one j fill 384
// contiguous bytes); without it env_pass is not touched.  kExp2 takes the
// records of build_records<true> and lobe_exp2's exponential.
template <bool kStoreEnv, bool kExp2>
__host__ __device__ __forceinline__ void env_lane_mix(
    const float* rec, int k_num, const float4* dirs, int d_num, int c0,
    int lane, float4 c[kDirsPerLane], float env[kDirsPerLane][3],
    float* env_pass) {
#pragma unroll
  for (int j = 0; j < kDirsPerLane; ++j) {
    const int d = c0 + lane + kWarp * j;
    c[j] = d < d_num ? dirs[d] : make_float4(0.f, 0.f, 1.f, 0.f);
    env[j][0] = env[j][1] = env[j][2] = 0.0f;
  }
  const float4* rec4 = reinterpret_cast<const float4*>(rec);
#pragma unroll 2
  for (int k = 0; k < k_num; ++k) {
    const float4 a = rec4[2 * k], w = rec4[2 * k + 1];
    const Lobe g{a.x, a.y, a.z, a.w, w.x, w.y, w.z};
#pragma unroll
    for (int j = 0; j < kDirsPerLane; ++j) {
      float cosm1;
      const float e = kExp2 ? lobe_exp2(g, c[j], g.lamb, &cosm1)
                            : lobe(g, c[j], &cosm1);
      env[j][0] += g.wr * e;
      env[j][1] += g.wg * e;
      env[j][2] += g.wb * e;
    }
  }
  if (!kStoreEnv) return;
#pragma unroll
  for (int j = 0; j < kDirsPerLane; ++j) {
    const int i = lane + kWarp * j;
    if (c0 + i < d_num) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) env_pass[3 * i + ch] = env[j][ch];
    }
  }
}

// Then the shading of the same directions: adds each one's Lambert and GGX
// products with its mixture to sums[ch] and sums[3 + ch].  A dummy
// direction's solid angle is 0, so it adds 0 and needs no branch.
__host__ __device__ __forceinline__ void env_lane_shade(
    const Frame& f, const float4 c[kDirsPerLane],
    const float env[kDirsPerLane][3], float f0, float sums[6]) {
#pragma unroll
  for (int j = 0; j < kDirsPerLane; ++j) {
    const Shade s = shade(f, c[j], f0);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      sums[ch] += s.ndl_w * env[j][ch];
      sums[3 + ch] += s.spec_w * env[j][ch];
    }
  }
}

}  // namespace sgk
