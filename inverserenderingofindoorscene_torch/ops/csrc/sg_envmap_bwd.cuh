// The envmap backward's per-thread arithmetic and its shared-memory layout.
// `sg_envmap_bwd_kernel` (sg_envmap.cu) runs one thread a few lobes of one
// pixel: a block takes groups of `bwd_group_pixels(K)` pixels, S =
// `bwd_pixel_threads(K)` threads a pixel (thread t: pixel t / S of the
// group, lobes kBwdLobes (t % S) ..), and stages each group's envmap
// adjoint in chunks of at most kBwdChunk directions.  Each thread keeps its
// lobes' seven scalars and seven sums in registers and walks the staged
// directions in order, so no sum crosses threads.  The CPU
// check (tests/test_torch_sg_envmap_host.py) builds this header with g++
// and runs the same functions block by block and thread by thread, so the
// pixel groups, the lobe split, the padded slots, the direction loop and
// the tails of D are checked before the card.

#pragma once

#include "sg_common.cuh"

namespace sgk {

constexpr int kBwdChunk = 64;        // directions a stage holds at most
constexpr int kBwdLobes = 3;         // lobes a thread
constexpr int kBwdMaxThreads = 256;  // a block's threads at most
constexpr int kBwdMaxPixels = 16;    // pixels a group

// Threads a pixel at K lobes (K <= kBwdLobes kBwdMaxThreads): thread j of
// a pixel owns its lobes j kBwdLobes + l, l < kBwdLobes, those below K.
__host__ __device__ __forceinline__ int bwd_pixel_threads(int k_num) {
  return (k_num + kBwdLobes - 1) / kBwdLobes;
}

// Pixels in a block's group at K lobes; the block has that many times
// bwd_pixel_threads(K) threads.
__host__ __device__ __forceinline__ int bwd_group_pixels(int k_num) {
  const int g = kBwdMaxThreads / bwd_pixel_threads(k_num);
  return g < kBwdMaxPixels ? g : kBwdMaxPixels;
}

// One stage of the double buffer: a chunk of n directions of one pixel
// group, for chunks of up to `chunk` = min(kBwdChunk, round4(D))
// directions (a multiple of 4).  The chunk's direction rows [chunk][4]
// (x, y, z, solid angle), then one slot a pixel holding the envmap
// adjoint of the chunk's directions, [3 chunk] floats.  A slot's stride
// is the least above 3 chunk that is 4 floats past a multiple of 32, so
// the 16-byte reads of the up to 8 pixels in a quarter warp fall on
// different banks; every slot starts on 16 bytes.
struct BwdStage {
  static __host__ __device__ int slot_stride(int chunk) {
    return 3 * chunk + ((4 - 3 * chunk) & 31);
  }
  static __host__ __device__ int floats(int chunk, int group) {
    return 4 * chunk + group * slot_stride(chunk);
  }
  // where pixel px's slot starts, in floats from the stage's start
  static __host__ __device__ int slot(int chunk, int px) {
    return 4 * chunk + px * slot_stride(chunk);
  }
};

// The tail of a staged chunk of n directions: directions n .. round4(n) -
// 1 become dummy rows (0, 0, 1) of zero solid angle with a zero adjoint in
// each of the `n_px` slots, so the loop over whole quads adds exactly 0
// for them.  Threads first, first + step, ... share the writes.
__host__ __device__ __forceinline__ void stage_tail(float* stage, int chunk,
                                                    int n, int n_px,
                                                    int first, int step) {
  const int pad = round4(n) - n;
  for (int i = first; i < pad * (1 + n_px); i += step) {
    const int d = n + i % pad, px = i / pad - 1;
    if (px < 0) {
      reinterpret_cast<float4*>(stage)[d] = make_float4(0.f, 0.f, 1.f, 0.f);
    } else {
      float* g = stage + BwdStage::slot(chunk, px) + 3 * d;
      g[0] = g[1] = g[2] = 0.0f;
    }
  }
}

// A thread's lobes (all zero past K, or for a pixel past N: they add
// nothing and are not stored), lamb log2 e of each for lobe_exp2, and
// each lobe's seven sums (d w r, g, b | d lamb | d axis / lamb).
struct ThreadLobes {
  Lobe lb[kBwdLobes];
  float lamb2[kBwdLobes];
  float acc[kBwdLobes][7];
};

// Thread j's lobes of pixel p (p < N) from axis/weight [N, K, 3], lamb
// [N, K], with their sums zeroed.
__host__ __device__ __forceinline__ ThreadLobes load_lobes(
    const float* axis, const float* lamb, const float* weight, long long p,
    int j, int k_num) {
  ThreadLobes t{};
  for (int l = 0; l < kBwdLobes; ++l) {
    const int k = j * kBwdLobes + l;
    if (k < k_num) {
      const long long i = p * k_num + k;
      t.lb[l] = Lobe{axis[3 * i],   axis[3 * i + 1],   axis[3 * i + 2],
                     lamb[i],       weight[3 * i],     weight[3 * i + 1],
                     weight[3 * i + 2]};
      t.lamb2[l] = t.lb[l].lamb * kLog2e;
    }
  }
  return t;
}

// A thread's lobes against one staged chunk of 4 n4 directions: adds
// lobe_adjoint's seven sums over the directions, in order, to each lobe's.
// `dirs` the chunk's rows; `g` the pixel's slot, direction i's adjoint at
// g[3 i .. 3 i + 2], read as three 16-byte loads a quad.  The exponential
// is lobe_exp2's.
__host__ __device__ __forceinline__ void lobe_chunk(ThreadLobes& t,
                                                    const float4* dirs,
                                                    const float* g, int n4) {
  const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll 1
  for (int q = 0; q < n4; ++q) {
    const float4 a = g4[3 * q], b = g4[3 * q + 1], c = g4[3 * q + 2];
    const float genv[4][3] = {{a.x, a.y, a.z}, {a.w, b.x, b.y},
                              {b.z, b.w, c.x}, {c.y, c.z, c.w}};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 l = dirs[4 * q + j];
#pragma unroll
      for (int m = 0; m < kBwdLobes; ++m) {
        float cosm1;
        const float e = lobe_exp2(t.lb[m], l, t.lamb2[m], &cosm1);
        lobe_adjoint(t.lb[m], l, genv[j], e, cosm1, t.acc[m]);
      }
    }
  }
}

// Thread j's sums of pixel p to the gradients of its lobes below K: d
// weight, d lamb, and d axis = lamb times the last three sums.
__host__ __device__ __forceinline__ void store_lobe_grads(
    const ThreadLobes& t, long long p, int j, int k_num, float* d_axis,
    float* d_lamb, float* d_weight) {
  for (int l = 0; l < kBwdLobes; ++l) {
    const int k = j * kBwdLobes + l;
    if (k < k_num) {
      const long long i = p * k_num + k;
      const float* acc = t.acc[l];
      d_weight[3 * i] = acc[0];
      d_weight[3 * i + 1] = acc[1];
      d_weight[3 * i + 2] = acc[2];
      d_lamb[i] = acc[3];
      d_axis[3 * i] = t.lb[l].lamb * acc[4];
      d_axis[3 * i + 1] = t.lb[l].lamb * acc[5];
      d_axis[3 * i + 2] = t.lb[l].lamb * acc[6];
    }
  }
}

}  // namespace sgk
