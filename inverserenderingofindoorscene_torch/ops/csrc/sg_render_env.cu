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
// The same walk serves two more entries, one template
// sg_render_walk_kernel<Walk> (render_sg_env is Walk::kServe, its SASS as
// before the template, but for register names).  Without the envmap
// stores it is the training forward `render_sg_fwd` (Walk::kTrain,
// `render_sg_fwd_f32`), which replaces the TPU kernel `_fwd_kernel`
// launched by `_run_fwd` (ops/sg_render.py:189, :240): with the
// exponential as exp2f of a sharpness scaled by log2(e) in the lobe
// records, its lobe loop is 105 instructions for 8 lobe-directions (13.1
// each, against 17.4 with expf).  At the training shape (B=5, 120x160,
// K=12, D=128) it takes 0.144 ms on an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 3), against 0.213 for the earlier forward of one
// 8-warp block per 8 pixels, whose every lane built the pixel's frame and
// read each lobe as 7 scalar loads.
//
// Without the shading it is the envmap forward `sg_envmap_fwd`
// (Walk::kEnvmap, `sg_envmap_fwd_f32`), which replaces the TPU kernel
// `_env_fwd_kernel` launched by `_env_run_fwd` (ops/sg_render.py:513,
// :536; math `_env_tile_math`, :484-510): no frames, no shading, no
// shuffles, only the inputs' prefetch, the records, the lobe loop (105
// instructions for 8 lobe-directions, with exp2f) and the envmap stores;
// any D.  At the training shape it reads 7K = 84 floats a pixel and
// writes 3D = 384, ~180 MB (~54 us at 3.35 TB/s), and issues ~800 warp
// instructions a pixel, ~77 M in all (~74 us at 132 SMs x 4 schedulers x
// 1.98 GHz): it is bound by issue.  64 registers with a minimum of 4
// blocks an SM (72 and 3 blocks without one; 48 for 5 blocks, 40 or fewer
// for 6 or 8 spill), 8,448 bytes of shared memory a block at K=12.
// Device time 0.096 ms (H100 80GB HBM3, 700 W; chip_smoke.py phase 3)
// against 0.162 for the earlier kernel of one warp a pixel, which read
// each lobe as 7 scalar shared loads for every direction, with expf.
// What the card showed (probe_sg_envmap_fwd.py, variants of this source
// side by side in one call): lanes on four consecutive directions, each
// storing its 12 floats as three float4, 2% slower; streaming stores
// (__stcs) 1-4% slower; expf 24% slower; 5, 6 or 8 blocks an SM slower;
// the bare ex2.approx.ftz in place of exp2f (which adds a range check
// for results below 2^-126) 12% faster, not taken here, as lobe_exp2 is
// also render_sg_fwd's and sg_envmap_bwd's exponential.
//
// What bounds the serving kernel.  At the serving shape (B=1, 120x160 grid,
// K=12, D=128) each pixel reads 7K+7 = 91 floats (plus its 3-float view
// vector) and writes 6 + 3D = 390; the envmap is 80% of the ~37 MB moved, ~11
// us at 3.35 TB/s, and counted as f32 operations (an IEEE expf, divide or
// square root as one) the work is ~5 us.  Both sit below what the SMs can
// issue.  In SASS (`cuobjdump -sass` of the built library) the lobe loop is
// 139 instructions for 8 lobe-directions (17.4 each, 8 of them the expf), the
// rest of a pass at most 524 for a lane's 4 directions (131 each: the
// shading's IEEE square root, reciprocal and divide each carry a range check
// and a slow-path call), and the per-pixel code at most 566 a lane (142 a
// direction), most of it the frame batch that runs once every 32 pixels.  The
// lobe loop alone at K=12 is 19200 x 128 x 12 x 17.4 / 32 warp instructions,
// ~17 us at 132 SMs x 4 schedulers x 1.755 GHz.  80 registers, no spill;
// 12,288 + 704 K bytes of shared memory a block for K a multiple of 4 (20,736
// at K=12).  Device time 0.0388 ms at K=12 and 0.0263 at K=4 (chip_smoke.py
// phase 3, H100 80GB HBM3, 700 W), against 0.0630 and 0.0456 for the earlier
// design of one 128-thread block a pixel, which recomputed the frame on every
// thread and summed across warps through shared memory.
//
// What the card showed (build-time variants of this source, timed side by
// side in one run each): warps that never wait for each other were alone
// no faster than blocks of 8-pixel tiles with two barriers a tile; the
// gain came from storing the envmap straight from registers (faster than
// float4 stores through shared memory and than a 1-D bulk copy,
// cp.async.bulk, by lane 0), 32-bit pixel indices and one copy loop for
// the three input runs.  A 72- or 64-register cap for 28 or 32 warps an SM
// spilled and ran slower.
//
// The design.  One warp a pixel, and every warp walks its own pixels
// (warp w of W takes pixels w, w + W, ...), so no barrier joins the warps
// of a block.  Lane i holds directions i, i+32, i+64, i+96 of a pass of
// 128 (D > 128 takes several passes; a tail of D runs on dummy directions
// of zero solid angle).  While the warp works on a pixel, cp.async brings
// its next pixel's SG inputs (three contiguous runs, in 16-byte copies
// where K is a multiple of 4) into a second buffer; the lanes turn the
// arrived inputs into 8-float lobe records (ax ay az lamb | wr wg wb -), so
// a lane reads a lobe with two broadcast 16-byte loads.  Every 32 pixels,
// lane i computes the frame of the warp's i-th next pixel (sg_common.cuh
// `make_frame`) into a slot of shared memory, so the frame runs once a
// pixel and its load latency once every 32 pixels.  Each lane walks the
// lobes in the outer loop (unrolled by 2) and its four directions inside,
// so one record load feeds four independent expf, stores the four mixtures
// straight from registers (the warp's three stores of one direction slot
// fill 384 contiguous bytes), then shades them with sg_common.cuh's
// `shade`.  Each lane sums its directions' six products in registers; one
// shuffle reduction a sum gives the pixel's diffuse and specular.
// Per-lane code is in sg_render_env.cuh.
//
// Tensor cores do not apply: axis_k . l_d is a product with an inner
// dimension of 3, the exponential is elementwise, and the final K x 3
// weighting is too small and would need TF32.
//
// Numerics follow `_shade_tile_math` step for step, including every clamp,
// through sg_common.cuh.  Build without --use_fast_math: the tolerances
// against the plain PyTorch version assume IEEE expf/exp2f/sqrtf and
// division (and 1/sqrtf, not rsqrtf).  In render_sg_env the lobe stays
// expf(lamb (cos - 1)), as the TPU kernel's jnp.exp; the exp2f of
// render_sg_fwd and sg_envmap_fwd passes the same tolerances.  The
// mixture keeps `_env_tile_math`'s order: lobes in order, one FMA a
// channel.

#include <climits>

#include "sg_render_env.cuh"

namespace {

using namespace sgk;

// The walk's three entries: render_sg_env stores the envmap and shades
// with expf; render_sg_fwd shades with exp2f; sg_envmap_fwd stores the
// envmap with exp2f and does not shade.
enum class Walk { kServe, kTrain, kEnvmap };

constexpr int kWarps = 8;  // warps (pixels at a time) a block
constexpr int kThreads = kWarps * kWarp;
// blocks an SM: the shading walks three (24 warps; 80 registers, no
// spill; a 72- or 64-register cap for more warps spills and runs slower),
// the envmap walk four (32 warps; 64 registers, no spill)
constexpr int kBlocksPerSM = 3;
constexpr int kEnvBlocksPerSM = 4;

// A warp's shared memory, in floats: with the shading, the frame slots of
// its next 32 pixels | one pixel's lobe records | two buffers of a pixel's
// raw SG inputs.  Every part is a multiple of 4 floats, so each starts on
// 16 bytes.
struct WarpSmem {
  static constexpr int kFrames = kWarp * kFrameFloats;
  static __host__ __device__ int floats(int k_num, bool shade) {
    return (shade ? kFrames : 0) + kRecord * k_num + 2 * Raw::floats(k_num);
  }
};

// Start the copy of pixel p's SG inputs into the raw buffer `raw`; one
// cp.async group a call, empty past the last pixel.  With `vec` (K a
// multiple of 4 and the three inputs 16-byte aligned) the three runs lie
// back to back in `raw` and lane i copies 16-byte chunks i, i + 32, ... of
// them; else every float alone.
__device__ __forceinline__ void prefetch_pixel(float* raw, const float* axis,
                                               const float* lamb,
                                               const float* weight, int p,
                                               int n_pix, int k_num, bool vec,
                                               int lane) {
  if (p < n_pix) {
    const float* ax = axis + (long long)p * 3 * k_num;
    const float* lm = lamb + (long long)p * k_num;
    const float* wt = weight + (long long)p * 3 * k_num;
    if (vec) {
      const int a4 = 3 * k_num / 4, l4 = k_num / 4;
#pragma unroll 1
      for (int i = lane; i < 2 * a4 + l4; i += kWarp) {
        const float* g = i < a4 ? ax + 4 * i
                                : (i < a4 + l4 ? lm + 4 * (i - a4)
                                               : wt + 4 * (i - a4 - l4));
        copy16(raw + 4 * i, g);
      }
    } else {
#pragma unroll 1
      for (int i = lane; i < 3 * k_num; i += kWarp) {
        copy4(raw + i, ax + i);
        copy4(raw + Raw::weight(k_num) + i, wt + i);
      }
#pragma unroll 1
      for (int i = lane; i < k_num; i += kWarp) {
        copy4(raw + Raw::lamb(k_num) + i, lm + i);
      }
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Warp w of W = gridDim.x kWarps takes pixels w, w + W, ...; the warps are
// numbered warp-major, so the warps with one pixel more spread over the
// SMs.  The envmap walk (kEnvmap) reads only axis, lamb, weight and dirs
// and writes only env; render_sg_fwd passes no env.
template <Walk kWalk>
__global__ void __launch_bounds__(kThreads, kWalk == Walk::kEnvmap
                                                ? kEnvBlocksPerSM
                                                : kBlocksPerSM)
    sg_render_walk_kernel(
        const float* __restrict__ albedo, const float* __restrict__ normal,
        const float* __restrict__ rough, const float* __restrict__ axis,
        const float* __restrict__ lamb, const float* __restrict__ weight,
        const float* __restrict__ view, const float4* __restrict__ dirs,
        float* __restrict__ diffuse, float* __restrict__ specular,
        float* __restrict__ env, int n_pix, int hw, int k_num, int d_num,
        float f0) {
  constexpr bool kShade = kWalk != Walk::kEnvmap;
  constexpr bool kStoreEnv = kWalk != Walk::kTrain;
  constexpr bool kExp2 = kWalk != Walk::kServe;
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  float* frames =  // the warp's part; no frame slots without the shading
      reinterpret_cast<float*>(smem4) + warp * WarpSmem::floats(k_num, kShade);
  float* rec = frames + (kShade ? WarpSmem::kFrames : 0);
  float* raw = rec + kRecord * k_num;
  const int raw_n = Raw::floats(k_num);
  const int n_warps = gridDim.x * kWarps;
  const int warp_id = warp * gridDim.x + blockIdx.x;
  const bool vec = (k_num & 3) == 0 &&
                   ((reinterpret_cast<unsigned long long>(axis) |
                     reinterpret_cast<unsigned long long>(lamb) |
                     reinterpret_cast<unsigned long long>(weight)) & 15) == 0;
  prefetch_pixel(raw, axis, lamb, weight, warp_id, n_pix, k_num, vec, lane);
  for (int j = 0, p = warp_id; p < n_pix; ++j, p += n_warps) {
    prefetch_pixel(raw + ((j + 1) & 1) * raw_n, axis, lamb, weight,
                   p + n_warps, n_pix, k_num, vec, lane);
    if (kShade && (j & (kWarp - 1)) == 0) {  // frames of this, the next 31
      const int q = warp_pixel(warp_id, j + lane, n_warps);
      if (q < n_pix) {
        frame_slot(albedo, normal, rough, view, q, hw,
                   frames + kFrameFloats * lane);
      }
    }
    asm volatile("cp.async.wait_group 1;" ::: "memory");  // this pixel's
    __syncwarp();
    build_records<kExp2>(rec, raw + (j & 1) * raw_n, k_num, lane, kWarp);
    __syncwarp();

    const float* slot = frames + kFrameFloats * (j & (kWarp - 1));
    Frame f{};
    if constexpr (kShade) f = load_frame(slot);
    float* out = kStoreEnv ? env + (long long)p * (3 * d_num) : nullptr;
    float sum[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < d_num; c0 += kPassDirs) {
      float4 c[kDirsPerLane];
      float mix[kDirsPerLane][3];
      env_lane_mix<kStoreEnv, kExp2>(rec, k_num, dirs, d_num, c0, lane, c,
                                     mix, kStoreEnv ? out + 3 * c0 : nullptr);
      if constexpr (kShade) env_lane_shade(f, c, mix, f0, sum);
    }
    if constexpr (kShade) {
#pragma unroll
      for (int i = 0; i < 6; ++i) sum[i] = warp_sum(sum[i]);
      if (lane < 3) {
        const float sd = lane == 0 ? sum[0] : (lane == 1 ? sum[1] : sum[2]);
        const float ss = lane == 0 ? sum[3] : (lane == 1 ? sum[4] : sum[5]);
        diffuse[3 * p + lane] = slot[8 + lane] * sd;
        specular[3 * p + lane] = ss;
      }
    }
    __syncwarp();  // the slot, records and raw buffer are read
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

int smem_bytes(int k_num, bool shade) {
  return (int)sizeof(float) * kWarps * WarpSmem::floats(k_num, shade);
}

// Launch the walk on `stream` on as many blocks as fit on the card at
// once; return the first CUDA error of the launch.
template <Walk kWalk>
int launch_walk(const float* albedo, const float* normal, const float* rough,
                const float* axis, const float* lamb, const float* weight,
                const float* view, const float* dirs, float* diffuse,
                float* specular, float* env, long long n_pix, int hw,
                int k_num, int d_num, float f0, cudaStream_t stream) {
  const auto kernel = sg_render_walk_kernel<kWalk>;
  const int smem = smem_bytes(k_num, kWalk != Walk::kEnvmap);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  // pixel indices are 32-bit, and a frame batch looks 31 strides past a
  // warp's pixel
  if (err == cudaSuccess && n_pix > (INT_MAX >> 1)) {
    err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_pix + kWarps - 1) / kWarps;
  const long long slots = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned int grid = (unsigned int)(blocks < slots ? blocks : slots);
  kernel<<<grid, kThreads, smem, stream>>>(
      albedo, normal, rough, axis, lamb, weight, view,
      reinterpret_cast<const float4*>(dirs), diffuse, specular, env,
      (int)n_pix, hw, k_num, d_num, f0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes a block needs for K lobes, with the shading
// (render_sg_env, render_sg_fwd) or without (sg_envmap_fwd); above 48 KB
// the launch opts in, up to the card's per-block limit.  D does not enter.
int sg_walk_smem_bytes(int k_num, int shade) {
  return smem_bytes(k_num, shade != 0);
}

// Launch on `stream`; return the first CUDA error of the launch.  All
// pointers are contiguous float32 device arrays: albedo/normal [N,3],
// rough [N,1], axis/weight [N,3K], lamb [N,K], view [HW,3] (pixel p uses
// row p % HW), dirs [D,4]; out diffuse/specular [N,3], env [N,D,3].
int sg_render_env_f32(const float* albedo, const float* normal,
                      const float* rough, const float* axis, const float* lamb,
                      const float* weight, const float* view,
                      const float* dirs, float* diffuse, float* specular,
                      float* env, long long n_pix, int hw, int k_num,
                      int d_num, float f0, void* stream) {
  return launch_walk<Walk::kServe>(albedo, normal, rough, axis, lamb, weight,
                                   view, dirs, diffuse, specular, env, n_pix,
                                   hw, k_num, d_num, f0, (cudaStream_t)stream);
}

// The same walk without the envmap, with lobe_exp2's exponential:
// diffuse/specular [N,3] out.
int render_sg_fwd_f32(const float* albedo, const float* normal,
                      const float* rough, const float* axis, const float* lamb,
                      const float* weight, const float* view,
                      const float* dirs, float* diffuse, float* specular,
                      long long n_pix, int hw, int k_num, int d_num, float f0,
                      void* stream) {
  return launch_walk<Walk::kTrain>(albedo, normal, rough, axis, lamb, weight,
                                   view, dirs, diffuse, specular, nullptr,
                                   n_pix, hw, k_num, d_num, f0,
                                   (cudaStream_t)stream);
}

// The same walk without the shading, with lobe_exp2's exponential: axis /
// weight [N,3K], lamb [N,K] and dirs [D,4] in, env [N,D,3] out; any D.
int sg_envmap_fwd_f32(const float* axis, const float* lamb,
                      const float* weight, const float* dirs, float* env,
                      long long n_pix, int k_num, int d_num, void* stream) {
  return launch_walk<Walk::kEnvmap>(nullptr, nullptr, nullptr, axis, lamb,
                                    weight, nullptr, dirs, nullptr, nullptr,
                                    env, n_pix, 1, k_num, d_num, 0.0f,
                                    (cudaStream_t)stream);
}

}  // extern "C"
