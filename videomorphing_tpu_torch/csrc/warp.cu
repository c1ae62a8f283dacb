// Bilinear gathers for Hopper (sm_90a): the halfway warp (kernel 3) and the
// sampler (kernel 4).
//
// Replaces the Pallas builders videomorphing_tpu/pallas/warp.py:206
// (_build_warp_call) and :311 (_build_sample_call, which samples n images
// of one shape, each at its own coordinate map). On the TPU those kernels
// enumerate per-tile residual offsets over row-phase copies because the TPU
// has no gather unit; on Hopper a warp is a per-pixel gather, so both
// kernels gather per output pixel with no fit test and no fallback.
//
// What bounds them on the H100: bytes. The sampler at 1024^2, C = 4 moves
// 40 bytes per output (8 of coordinates, 16 of taps counted once, 16 out):
// 42 MB, 12.5 us at 3.35 TB/s, against ~46 operations per output (0.7 us
// at 67 TFLOP/s). What it actually moves through L1 is the 4 corner taps
// of every output, so the design is about load and store instructions:
//   - one instantiation per channel count C in {1, 2, 3, 4}, unrolled, and a
//     generic one for any other C (the wrapper's contract takes any C);
//   - the vector instantiations load a coordinate pair as a float2 (two
//     pairs as a float4), a corner as a float4 at C = 4 and a float2 at
//     C = 2, and store each thread's outputs as float4s; at C = 1 (the flow
//     warps) and C = 3 a thread computes 4 consecutive outputs so its
//     coordinate loads and its stores are 16 bytes wide, at C = 2 it
//     computes 2. At C = 4 that is 1 + 4 loads and 1 store per output,
//     where the scalar form issues 2 + 16 loads and 4 stores;
//   - the wrapper picks the vector instantiation only when the image,
//     coordinate and output pointers are aligned for those accesses (a
//     contiguous view with a storage offset may not be; kernels/warp.py
//     sample_vectorized); otherwise the scalar instantiation of the same C,
//     which loads and stores one float at a time. vm_bilinear_sample checks
//     the alignment again and refuses a vector launch that would fault.
// The coordinates arrive flattened to (n, M, 2), so the kernel does not
// know the map's (Ho, Wo) and tiles nothing in 2-D: a block covers 256 (or
// 1024 at 4 per thread) consecutive outputs of one image, and for smooth
// maps the taps of neighbouring output rows meet in L1/L2 anyway.
//
// Semantics are those of ops/resample.py bilinear_sample_with_grad: clamp to
// [0, n-1] before floor, y1 = min(y0 + 1, h - 1), derivative masks from the
// strict raw-coordinate tests 0 < y < h - 1. The lerps use __fadd_rn /
// __fmul_rn so no multiply-add is contracted and each step rounds as the
// plain PyTorch version's separate operations do: every instantiation is
// bitwise equal to the plain version.
//
// The halfway warp (one thread per output pixel, C channels in a loop; the
// same bound by bytes) also has a row-offset form for the row-sharded solve
// (videomorphing_tpu/parallel/spatial.py:264-273, an XLA gather there): it
// warps ho rows starting at global row row0 of the full images, with v of
// those rows, and writes zero planes for rows outside [0, h). Offset 0 with
// ho = h is the whole-frame warp.

#include <cuda_runtime.h>

#include <cstdint>

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

// One output of C channels from the 4 corners, with scalar loads; C = 0
// takes the channel count from nc.
template <int C>
__device__ __forceinline__ void sample_scalar(const float* __restrict__ im, float y, float x, int h,
                                              int w, int nc, float* __restrict__ o) {
  const int cc = C > 0 ? C : nc;
  Taps t = corner_taps(y, x, h, w);
#pragma unroll
  for (int c = 0; c < cc; ++c) {
    float top = lerp_rn(im[(size_t)t.i00 * cc + c], im[(size_t)t.i01 * cc + c], t.fx);
    float bot = lerp_rn(im[(size_t)t.i10 * cc + c], im[(size_t)t.i11 * cc + c], t.fx);
    o[c] = lerp_rn(top, bot, t.fy);
  }
}

__device__ __forceinline__ float4 lerp4_rn(float4 a, float4 b, float f) {
  return make_float4(lerp_rn(a.x, b.x, f), lerp_rn(a.y, b.y, f), lerp_rn(a.z, b.z, f),
                     lerp_rn(a.w, b.w, f));
}

__device__ __forceinline__ float2 lerp2_rn(float2 a, float2 b, float f) {
  return make_float2(lerp_rn(a.x, b.x, f), lerp_rn(a.y, b.y, f));
}

// One output into r[0, C) with the corners loaded as one float4 (C = 4), one
// float2 (C = 2) or C floats; the same lerps as sample_scalar.
template <int C>
__device__ __forceinline__ void sample_vector(const float* __restrict__ im, float y, float x, int h,
                                              int w, float* r) {
  Taps t = corner_taps(y, x, h, w);
  if constexpr (C == 4) {
    const float4* p = reinterpret_cast<const float4*>(im);
    float4 v = lerp4_rn(lerp4_rn(p[t.i00], p[t.i01], t.fx), lerp4_rn(p[t.i10], p[t.i11], t.fx), t.fy);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else if constexpr (C == 2) {
    const float2* p = reinterpret_cast<const float2*>(im);
    float2 v = lerp2_rn(lerp2_rn(p[t.i00], p[t.i01], t.fx), lerp2_rn(p[t.i10], p[t.i11], t.fx), t.fy);
    r[0] = v.x; r[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float top = lerp_rn(im[(size_t)t.i00 * C + c], im[(size_t)t.i01 * C + c], t.fx);
      float bot = lerp_rn(im[(size_t)t.i10 * C + c], im[(size_t)t.i11 * C + c], t.fx);
      r[c] = lerp_rn(top, bot, t.fy);
    }
  }
}

// The vector instantiations: outputs per thread and the byte alignment of
// the image, the coordinates and the output they need, per C. Mirrored by
// kernels/warp.py (VECTOR_FORMS); C * VEC is a multiple of 4, so a thread's
// outputs are whole float4s.
template <int C> struct VectorForm;
template <> struct VectorForm<1> { static constexpr int VEC = 4, IMG = 4, CO = 16, OUT = 16; };
template <> struct VectorForm<2> { static constexpr int VEC = 2, IMG = 8, CO = 16, OUT = 16; };
template <> struct VectorForm<3> { static constexpr int VEC = 4, IMG = 4, CO = 16, OUT = 16; };
template <> struct VectorForm<4> { static constexpr int VEC = 1, IMG = 16, CO = 8, OUT = 16; };

constexpr int SAMPLE_THREADS = 256;

// n images of one shape (h, w, C), each sampled at its own m coordinate
// pairs, over a (ceil(m / (256 VEC)), n) grid: each thread takes VEC
// consecutive outputs of image blockIdx.y, so neighbouring threads read
// neighbouring coordinates and write neighbouring outputs. Offsets are
// size_t: a batched clip can pass more than 2^31 values. The single-image
// form is n = 1. VECTOR selects the wide loads and stores (C in 1..4, the
// alignments of VectorForm<C>, and m a multiple of VEC when n > 1 so every
// image's rows stay aligned); a thread whose VEC outputs run past m (n = 1
// only) takes the scalar path for them. C = 0 is the generic instantiation.
template <int C, int VEC, bool VECTOR>
__global__ void __launch_bounds__(SAMPLE_THREADS)
bilinear_sample_kernel(const float* __restrict__ img, const float* __restrict__ coords,
                       float* __restrict__ out, int h, int w, int nc, long long m) {
  const int cc = C > 0 ? C : nc;
  const long long j0 = ((long long)blockIdx.x * SAMPLE_THREADS + threadIdx.x) * VEC;
  if (j0 >= m) return;
  const size_t k = blockIdx.y;
  const float* im = img + k * (size_t)h * w * cc;
  const size_t pix = k * (size_t)m + (size_t)j0;
  const float* co = coords + 2 * pix;
  float* o = out + pix * cc;
  if constexpr (VECTOR) {
    if (j0 + VEC <= m) {
    float cy[VEC], cx[VEC];
    if constexpr (VEC == 1) {
      float2 q = *reinterpret_cast<const float2*>(co);
      cy[0] = q.x;
      cx[0] = q.y;
    } else {
#pragma unroll
      for (int q = 0; q < VEC / 2; ++q) {
        float4 c4 = reinterpret_cast<const float4*>(co)[q];
        cy[2 * q] = c4.x;
        cx[2 * q] = c4.y;
        cy[2 * q + 1] = c4.z;
        cx[2 * q + 1] = c4.w;
      }
    }
    float r[VEC * C];
#pragma unroll
    for (int q = 0; q < VEC; ++q) sample_vector<C>(im, cy[q], cx[q], h, w, r + q * C);
#pragma unroll
    for (int q = 0; q < VEC * C / 4; ++q)
      reinterpret_cast<float4*>(o)[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
    return;
    }
  }
  for (int q = 0; q < VEC && j0 + q < m; ++q)
    sample_scalar<C>(im, co[2 * q], co[2 * q + 1], h, w, cc, o + q * cc);
}

template <int C, int VEC, bool VECTOR>
int launch_sample(const float* img, const float* coords, float* out, int n, int h, int w, int nc,
                  long long m, cudaStream_t stream) {
  long long threads = (m + VEC - 1) / VEC;
  dim3 grid((unsigned)((threads + SAMPLE_THREADS - 1) / SAMPLE_THREADS), (unsigned)n);
  bilinear_sample_kernel<C, VEC, VECTOR><<<grid, SAMPLE_THREADS, 0, stream>>>(img, coords, out, h,
                                                                            w, nc, m);
  return (int)cudaGetLastError();
}

template <int C>
bool vector_ok(const void* img, const void* coords, const void* out, int n, long long m) {
  using F = VectorForm<C>;
  return (uintptr_t)img % F::IMG == 0 && (uintptr_t)coords % F::CO == 0 &&
         (uintptr_t)out % F::OUT == 0 && (n == 1 || m % F::VEC == 0);
}

template <int C>
int dispatch_sample(const float* img, const float* coords, float* out, int n, int h, int w,
                    long long m, int vector, cudaStream_t stream) {
  if (!vector) return launch_sample<C, 1, false>(img, coords, out, n, h, w, C, m, stream);
  if (!vector_ok<C>(img, coords, out, n, m)) return (int)cudaErrorMisalignedAddress;
  return launch_sample<C, VectorForm<C>::VEC, true>(img, coords, out, n, h, w, C, m, stream);
}

constexpr int BX = 32, BY = 8;

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
// (the grid's y extent) and m >= 1, both checked by the wrapper. vector = 1
// asks for the vector instantiation of C (C in 1..4), which the wrapper
// chooses from the pointers' alignment; a misaligned request returns
// cudaErrorMisalignedAddress without a launch.
extern "C" int vm_bilinear_sample(const float* img, const float* coords, float* out, int n,
                                  int h, int w, int C, long long m, int vector, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: return dispatch_sample<1>(img, coords, out, n, h, w, m, vector, st);
    case 2: return dispatch_sample<2>(img, coords, out, n, h, w, m, vector, st);
    case 3: return dispatch_sample<3>(img, coords, out, n, h, w, m, vector, st);
    case 4: return dispatch_sample<4>(img, coords, out, n, h, w, m, vector, st);
    default:
      if (vector) return (int)cudaErrorInvalidValue;
      return launch_sample<0, 1, false>(img, coords, out, n, h, w, C, m, st);
  }
}
