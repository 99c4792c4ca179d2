// The SG-envmap backward on Hopper (sm_90a).
//
// Replaces the TPU kernel `_env_bwd_kernel`
// (inverserenderingofindoorscene_tpu/ops/sg_render.py:520-528, launched by
// `_get_env_op.bwd` :577; the forward's math `_env_tile_math` :484-510).
// The forward, env_c(l_d) = sum_k w_kc exp(lamb_k (a_k . l_d - 1)) on the
// D hemisphere directions, is the SG walk without the shading
// (sg_render_env.cu, `sg_envmap_fwd_f32`).  The backward takes the
// envmap's adjoint g [D, 3] and writes, per lobe, the 7 sums over D
//   d w_kc = sum_d g_c e_k,   d lamb_k = sum_d ge_k e_k (a_k . l_d - 1),
//   d a_k = lamb_k sum_d ge_k e_k l_d,   ge_k = sum_c g_c w_kc.
//
// What bounds it.  At the training shape (B=5, 120x160 grid, K=12,
// D=128: N = 96,000 pixels) it reads 7K + 3D = 468 floats a pixel and
// writes 7K = 84: ~212 MB (~63 us at 3.35 TB/s).  Counted as f32
// operations (an IEEE expf as one) it is ~0.053 ms at 67 TFLOP/s, but it
// is bound by instruction issue: in SASS (`cuobjdump -sass` of the built
// library) its direction loop is 252 instructions for 12 lobe-directions,
// 21.0 each with the exp2f of lobe_exp2 (25.2 each with expf, which is why
// the exponential is exp2f), so N K D 21 / 32 ~ 97 M warp instructions,
// ~0.093 ms at 132 SMs x 4 schedulers x 1.98 GHz.  It runs at 0.156 ms on
// an H100 80GB HBM3 at 700 W (chip_smoke.py phase 3), ~60% of the issue
// rate, against 0.300 for the earlier design of one warp a pixel, which
// summed each lobe's seven products across the warp with shuffles (~40%
// of what it issued).  What the card showed (build-time variants of this
// source timed side by side by a probe that is not kept): 3 lobes a
// thread beat 1, 2 and 4; chunks of 64 directions beat 128 there; reading
// g and the directions straight from device memory through L1, without
// staging, was slower at K=12 and more so at K=4 and D=200; a register
// cap for more blocks an SM spilled or was no faster.  120 registers, no
// spill.
//
// The design.  The lobes are independent: lobe k's seven sums read only its
// own seven scalars and the pixel's g [D, 3].  So one thread owns 3 lobes of
// one pixel (kBwdLobes; S = ceil(K / 3) threads a pixel), keeps their scalars
// and seven sums each in registers and walks all D directions: no sum crosses
// threads, and each thread stores its own gradients.  Threads run
// pixel-major, lobe-minor, so the lobe loads and gradient stores are
// coalesced runs.  A block takes groups of G = min(16, 256 / S) pixels (G S
// threads) and walks its groups (b, b + gridDim.x, ...) and each group's
// chunks of up to 64 directions as one sequence of stages in a shared-memory
// double buffer: while the threads work on one stage, cp.async (16-byte
// copies where D is a multiple of 4) brings the next one, the chunk's
// direction rows and each pixel's g run into a padded slot, so the S threads
// of a pixel read each direction and its adjoint as broadcasts, and each
// thread's lobes of its next group come into registers (sg_envmap_bwd.cuh).
// Any D runs: a tail of a chunk becomes dummy directions with a zero adjoint.
// The grid is as many blocks as fit on the card at once.  The TPU kernel's
// transposed [D, P] tiles exist for TPU lanes and are not carried over.

#include <climits>

#include "sg_envmap_bwd.cuh"

namespace {

using namespace sgk;

// The copies of one stage's slots: thread t takes copies t, t + T, ... of
// the n_px q copies of `width` floats (copy j of pixel px at float
// width j of its slot and of its run in g_env), walking (px, j) without a
// division a copy.
template <int kWidth>
__device__ __forceinline__ void copy_slots(float* stage, const float* src,
                                           int chunk, int n_px, int q,
                                           int d_num) {
  const int dpx = blockDim.x / q, dj = blockDim.x - dpx * q;
#pragma unroll 1
  for (int px = threadIdx.x / q, j = threadIdx.x % q; px < n_px;) {
    float* s = stage + BwdStage::slot(chunk, px) + kWidth * j;
    const float* g = src + (long long)px * 3 * d_num + kWidth * j;
    if (kWidth == 4) {
      copy16(s, g);
    } else {
      copy4(s, g);
    }
    px += dpx;
    j += dj;
    if (j >= q) {
      j -= q;
      ++px;
    }
  }
}

// Start copying stage (grp, ch) into `stage`: the chunk's direction rows
// and each pixel's adjoint of those directions.  One cp.async group a
// call, empty past the last group.  With `vec` (D a multiple of 4 and both
// sources 16-byte aligned) the copies are of 16 bytes, else of 4 bytes and
// the chunk's tail is written as dummy directions.
__device__ __forceinline__ void stage_chunk(float* stage, const float* dirs,
                                            const float* g_env, int grp,
                                            int ch, int group, int chunk,
                                            int n_groups, int n_pix,
                                            int d_num, bool vec) {
  if (grp < n_groups) {
    const int c0 = ch * kBwdChunk, n = min(kBwdChunk, d_num - c0);
    const int p0 = grp * group, n_px = min(group, n_pix - p0);
    const float* src = g_env + ((long long)p0 * d_num + c0) * 3;
    if (vec) {
#pragma unroll 1
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        copy16(stage + 4 * i, dirs + 4 * (c0 + i));
      }
      copy_slots<4>(stage, src, chunk, n_px, 3 * n / 4, d_num);
    } else {
#pragma unroll 1
      for (int i = threadIdx.x; i < 4 * n; i += blockDim.x) {
        copy4(stage + i, dirs + 4 * c0 + i);
      }
      copy_slots<1>(stage, src, chunk, n_px, 3 * n, d_num);
      stage_tail(stage, chunk, n, n_px, threadIdx.x, blockDim.x);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One thread a few lobes of a pixel, G S threads a block (G =
// bwd_group_pixels, S = bwd_pixel_threads).  Block b walks groups b, b +
// gridDim.x, ... and each group's chunks as one sequence of stages s,
// stage s in buffer s % 2; the copy of stage s + 1 runs while the threads
// work on stage s, and each thread's lobes of the next group are loaded
// into registers while it works on this one.
__global__ void __launch_bounds__(kBwdMaxThreads) sg_envmap_bwd_kernel(
    const float* __restrict__ axis, const float* __restrict__ lamb,
    const float* __restrict__ weight, const float* __restrict__ dirs,
    const float* __restrict__ g_env, float* __restrict__ d_axis,
    float* __restrict__ d_lamb, float* __restrict__ d_weight, int n_pix,
    int k_num, int d_num) {
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  const int group = bwd_group_pixels(k_num);
  const int chunk = min(kBwdChunk, round4(d_num));
  const int stage_n = BwdStage::floats(chunk, group);
  const int n_chunks = (d_num + kBwdChunk - 1) / kBwdChunk;
  const int n_groups = (n_pix + group - 1) / group;
  const int per_px = bwd_pixel_threads(k_num);
  const int px = threadIdx.x / per_px, j = threadIdx.x - px * per_px;
  const bool vec = (d_num & 3) == 0 &&
                   ((reinterpret_cast<unsigned long long>(dirs) |
                     reinterpret_cast<unsigned long long>(g_env)) & 15) == 0;
  // this thread's lobes in group grp: zeros past the last pixel
  auto lobes_of = [&](int grp) {
    const int p = grp * group + px;
    return grp < n_groups && p < n_pix
               ? load_lobes(axis, lamb, weight, p, j, k_num)
               : ThreadLobes{};
  };
  stage_chunk(stages, dirs, g_env, blockIdx.x, 0, group, chunk, n_groups,
              n_pix, d_num, vec);
  ThreadLobes next = lobes_of(blockIdx.x);
  for (int grp = blockIdx.x, s = 0; grp < n_groups; grp += gridDim.x) {
    const int p = grp * group + px;
    ThreadLobes t = next;
    next = lobes_of(grp + gridDim.x);
    for (int ch = 0; ch < n_chunks; ++ch, ++s) {
      const bool last = ch + 1 == n_chunks;
      stage_chunk(stages + ((s + 1) & 1) * stage_n, dirs, g_env,
                  last ? grp + gridDim.x : grp, last ? 0 : ch + 1, group,
                  chunk, n_groups, n_pix, d_num, vec);
      asm volatile("cp.async.wait_group 1;" ::: "memory");  // stage s's
      __syncthreads();
      const float* st = stages + (s & 1) * stage_n;
      const int n = min(kBwdChunk, d_num - ch * kBwdChunk);
      if (p < n_pix) {
        lobe_chunk(t, reinterpret_cast<const float4*>(st),
                   st + BwdStage::slot(chunk, px), round4(n) / 4);
      }
      __syncthreads();  // stage s is read; its buffer takes stage s + 2
    }
    if (p < n_pix) store_lobe_grads(t, p, j, k_num, d_axis, d_lamb, d_weight);
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

int launch_bwd(const float* axis, const float* lamb, const float* weight,
               const float* dirs, const float* g_env, float* d_axis,
               float* d_lamb, float* d_weight, long long n_pix, int k_num,
               int d_num, cudaStream_t stream) {
  if (k_num < 1 || bwd_pixel_threads(k_num) > kBwdMaxThreads || d_num < 1 ||
      n_pix > (INT_MAX >> 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int group = bwd_group_pixels(k_num);
  const int threads = group * bwd_pixel_threads(k_num);
  const int smem = (int)sizeof(float) * 2 *
                   BwdStage::floats(min(kBwdChunk, round4(d_num)), group);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      sg_envmap_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sg_envmap_bwd_kernel, threads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  const long long groups = (n_pix + group - 1) / group;
  const long long slots = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned int grid = (unsigned int)(groups < slots ? groups : slots);
  sg_envmap_bwd_kernel<<<grid, threads, smem, stream>>>(
      axis, lamb, weight, dirs, g_env, d_axis, d_lamb, d_weight, (int)n_pix,
      k_num, d_num);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// g_env [N, D, 3] in; d_axis/d_weight [N, 3K], d_lamb [N, K] out; any D,
// K <= 768 (else cudaErrorInvalidValue).
int sg_envmap_bwd_f32(const float* axis, const float* lamb,
                      const float* weight, const float* dirs,
                      const float* g_env, float* d_axis, float* d_lamb,
                      float* d_weight, long long n_pix, int k_num, int d_num,
                      void* stream) {
  return launch_bwd(axis, lamb, weight, dirs, g_env, d_axis, d_lamb,
                    d_weight, n_pix, k_num, d_num, (cudaStream_t)stream);
}

}  // extern "C"
