// Bilinear gathers for Hopper (sm_90a): the halfway warp and the sampler.
//
// Replaces the Pallas builders videomorphing_tpu/pallas/warp.py:206
// (_build_warp_call) and :311 (_build_sample_call, which samples n images
// of one shape, each at its own coordinate map). On the TPU those
// kernels enumerate per-tile residual offsets over row-phase copies because
// the TPU has no gather unit; on Hopper a warp is a per-pixel gather, so
// both kernels are one thread per output pixel with no fit test and no
// fallback. Both are bound by memory: 4 taps x C reads per image and the
// output writes, with neighbouring threads on neighbouring pixels so the
// taps of a warp coalesce through L1/L2 for smooth fields.
//
// Semantics are those of ops/resample.py bilinear_sample_with_grad: clamp to
// [0, n-1] before floor, y1 = min(y0 + 1, h - 1), derivative masks from the
// strict raw-coordinate tests 0 < y < h - 1. The lerps use __fadd_rn /
// __fmul_rn so no multiply-add is contracted and each step rounds as the
// plain PyTorch version's separate operations do.
//
// The halfway warp also has a row-offset form for the row-sharded solve
// (videomorphing_tpu/parallel/spatial.py:264-273, an XLA gather there): it
// warps ho rows starting at global row row0 of the full images, with v of
// those rows, and writes zero planes for rows outside [0, h). Offset 0 with
// ho = h is the whole-frame warp.

#include <cuda_runtime.h>

namespace {

struct Taps {
  int i00, i01, i10, i11;  // flat (y * w + x) indices of the 4 corners
  float fy, fx;
};

__device__ __forceinline__ Taps corner_taps(float y, float x, int h, int w) {
  y = fminf(fmaxf(y, 0.0f), (float)(h - 1));
  x = fminf(fmaxf(x, 0.0f), (float)(w - 1));
  float y0 = floorf(y), x0 = floorf(x);
  int y0i = (int)y0, x0i = (int)x0;
  int y1i = min(y0i + 1, h - 1), x1i = min(x0i + 1, w - 1);
  Taps t;
  t.i00 = y0i * w + x0i;
  t.i01 = y0i * w + x1i;
  t.i10 = y1i * w + x0i;
  t.i11 = y1i * w + x1i;
  t.fy = __fsub_rn(y, y0);
  t.fx = __fsub_rn(x, x0);
  return t;
}

// a + (b - a) * f, rounded step by step
__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), f));
}

// One halfway image: sample img at p -/+ v and write C value planes and
// 2C derivative planes (y, x per channel) of the (6C, H, W) stack.
__device__ __forceinline__ void warp_one(const float* __restrict__ img, float yr, float xr,
                                         int h, int w, int C, int pix, int hw,
                                         float* __restrict__ out_val,
                                         float* __restrict__ out_d) {
  Taps t = corner_taps(yr, xr, h, w);
  float oky = (yr > 0.0f && yr < (float)(h - 1)) ? 1.0f : 0.0f;
  float okx = (xr > 0.0f && xr < (float)(w - 1)) ? 1.0f : 0.0f;
  float gy = __fsub_rn(1.0f, t.fy);
  for (int c = 0; c < C; ++c) {
    float v00 = img[t.i00 * C + c], v01 = img[t.i01 * C + c];
    float v10 = img[t.i10 * C + c], v11 = img[t.i11 * C + c];
    float top = lerp_rn(v00, v01, t.fx);
    float bot = lerp_rn(v10, v11, t.fx);
    out_val[c * hw + pix] = lerp_rn(top, bot, t.fy);
    out_d[(2 * c) * hw + pix] = __fmul_rn(__fsub_rn(bot, top), oky);
    float dx = __fadd_rn(__fmul_rn(__fsub_rn(v01, v00), gy),
                         __fmul_rn(__fsub_rn(v11, v10), t.fy));
    out_d[(2 * c + 1) * hw + pix] = __fmul_rn(dx, okx);
  }
}

__global__ void halfway_warp_kernel(const float* __restrict__ i0, const float* __restrict__ i1,
                                    const float* __restrict__ v, float* __restrict__ out,
                                    int h, int w, int C, int row0, int ho) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= ho) return;
  int pix = y * w + x;
  int hw = ho * w;  // plane stride of the output
  int gy = y + row0;
  if (gy < 0 || gy >= h) {
    for (int q = 0; q < 6 * C; ++q) out[(size_t)q * hw + pix] = 0.0f;
    return;
  }
  float vy = v[2 * pix], vx = v[2 * pix + 1];
  // plane order: w0 (C), w1 (C), dw0 (y, x per channel), dw1
  warp_one(i0, __fsub_rn((float)gy, vy), __fsub_rn((float)x, vx), h, w, C, pix, hw,
           out, out + (size_t)2 * C * hw);
  warp_one(i1, __fadd_rn((float)gy, vy), __fadd_rn((float)x, vx), h, w, C, pix, hw,
           out + (size_t)C * hw, out + (size_t)4 * C * hw);
}

// n images of one shape (h, w, C), each sampled at its own m coordinate
// pairs: one thread per output pixel over a (ceil(m / 256), n) grid, so
// neighbouring threads read neighbouring coordinates and write neighbouring
// outputs. Offsets are size_t: a batched clip can pass more than 2^31
// values. The single-image form is n = 1.
__global__ void bilinear_sample_kernel(const float* __restrict__ img,
                                       const float* __restrict__ coords,
                                       float* __restrict__ out, int h, int w, int C,
                                       long long m) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  size_t k = blockIdx.y;
  const float* im = img + k * (size_t)h * w * C;
  size_t pix = k * (size_t)m + (size_t)j;
  Taps t = corner_taps(coords[2 * pix], coords[2 * pix + 1], h, w);
  for (int c = 0; c < C; ++c) {
    float top = lerp_rn(im[(size_t)t.i00 * C + c], im[(size_t)t.i01 * C + c], t.fx);
    float bot = lerp_rn(im[(size_t)t.i10 * C + c], im[(size_t)t.i11 * C + c], t.fx);
    out[pix * C + c] = lerp_rn(top, bot, t.fy);
  }
}

constexpr int BX = 32, BY = 8;
constexpr int SAMPLE_THREADS = 256;

}  // namespace

// i0, i1 (h, w, C); v (ho, w, 2) and out (6C, ho, w) for the global rows
// [row0, row0 + ho)
extern "C" int vm_halfway_warp(const float* i0, const float* i1, const float* v, float* out,
                               int h, int w, int C, int row0, int ho, void* stream) {
  dim3 block(BX, BY);
  dim3 grid((w + BX - 1) / BX, (ho + BY - 1) / BY);
  halfway_warp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(i0, i1, v, out, h, w, C, row0,
                                                                 ho);
  return (int)cudaGetLastError();
}

// img (n, h, w, C), coords (n, m, 2) in (y, x), out (n, m, C); n <= 65535
// (the grid's y extent) and m >= 1, both checked by the wrapper.
extern "C" int vm_bilinear_sample(const float* img, const float* coords, float* out, int n,
                                  int h, int w, int C, long long m, void* stream) {
  dim3 grid((unsigned)((m + SAMPLE_THREADS - 1) / SAMPLE_THREADS), (unsigned)n);
  bilinear_sample_kernel<<<grid, SAMPLE_THREADS, 0, (cudaStream_t)stream>>>(img, coords, out,
                                                                          h, w, C, m);
  return (int)cudaGetLastError();
}
