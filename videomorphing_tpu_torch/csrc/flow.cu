// The flows' kernels for Hopper (sm_90a): kernel 5, one Horn-Schunck
// Jacobi sweep of a batch of flows, and kernels 6 and 7, one IRLS step of
// the robust flow (its weights and normal matrix; its damped-Jacobi sweeps).
//
// Kernel 5 replaces no TPU kernel: the reference's _hs_level
// (videomorphing_tpu/video/flow.py) is plain jnp, fused by XLA. In eager
// PyTorch the same sweep is about 19 launches (the edge-padded neighbour
// gathers, the average, the residual and the update, each a temporary in
// device memory), and a video's flows run 80 sweeps a pyramid level over
// every frame pair of a clip as one batch. This kernel is that sweep in
// one launch.
//
// Layout: ut, u_w (H, W, B, 2) and it, ix, iy, denom (H, W, B), float32 and
// contiguous; with j = x * B + b a site's index in its row, the left and
// right neighbours are j -/+ B and the upper and lower ones a row of W * B
// sites away. The edge replication of ops/windows.edge_pad is a clamp of x
// and y, never of b.
//
// What bounds it on the H100: bytes. A site needs 40 of them: the current
// flow (8; its neighbours' reads hit L1 for left and right and L2 for the
// rows above and below: three rows of 540 x 960 x 58 flows are 1.3 MB), the
// warp's start u_w (8), it, ix, iy and denom (16), and the new flow written
// (8); about 15 operations a site against 67 TFLOP/s. The design is about
// those bytes: one thread a site, its two flow components one float2 load,
// neighbouring threads on neighbouring sites so every load and the store
// are coalesced, a block along one row (blockIdx.y is the row, so no
// division finds it), nothing staged in device memory.
//
// Arithmetic: every operation rounds as the plain version's separate
// PyTorch operations do (kernels/flow.py hs_sweep_plain), through
// __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn so that nvcc contracts
// nothing into a multiply-add; the kernel is bitwise equal to the plain
// version on the card:
//   ua_c = 0.25 * (((up_c + dn_c) + lf_c) + rt_c)
//   r    = ((it + ix * (ua_1 - uw_1)) + iy * (ua_0 - uw_0)) / denom
//   ut'  = (ua_0 - iy * r, ua_1 - ix * r)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void hs_sweep_kernel(const float2* __restrict__ ut, const float2* __restrict__ uw,
                                const float* __restrict__ it, const float* __restrict__ ix,
                                const float* __restrict__ iy, const float* __restrict__ denom,
                                float2* __restrict__ out, int h, int row, int b) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= row) return;
  const int y = blockIdx.y;
  const long long i = (long long)y * row + j;
  const long long up = y > 0 ? i - row : i;
  const long long dn = y < h - 1 ? i + row : i;
  const long long lf = j >= b ? i - b : i;
  const long long rt = j + b < row ? i + b : i;
  const float2 u_up = ut[up], u_dn = ut[dn], u_lf = ut[lf], u_rt = ut[rt];
  const float2 w = uw[i];
  const float ua0 = __fmul_rn(0.25f, __fadd_rn(__fadd_rn(__fadd_rn(u_up.x, u_dn.x), u_lf.x), u_rt.x));
  const float ua1 = __fmul_rn(0.25f, __fadd_rn(__fadd_rn(__fadd_rn(u_up.y, u_dn.y), u_lf.y), u_rt.y));
  const float gx = ix[i], gy = iy[i];
  const float r = __fdiv_rn(__fadd_rn(__fadd_rn(it[i], __fmul_rn(gx, __fsub_rn(ua1, w.y))),
                                      __fmul_rn(gy, __fsub_rn(ua0, w.x))),
                            denom[i]);
  out[i] = make_float2(__fsub_rn(ua0, __fmul_rn(gy, r)), __fsub_rn(ua1, __fmul_rn(gx, r)));
}

// Kernels 6 and 7, the robust (Brox-class) flow's IRLS step, replace no
// TPU kernel either: the reference's _robust_level
// (videomorphing_tpu/video/flow.py) is plain jnp. Each IRLS step computes
// lagged weights (four edge-replicated smoothness weights, one Charbonnier
// weight of the three data channels), each site's 2x2 normal matrix and
// right-hand side, then runs its damped-Jacobi sweeps; in eager PyTorch
// that is about 100 launches for the weights and the matrix and about 45 a
// sweep, over a batch of 58 problems of up to 240 x 427. Kernel 6
// (irls_setup_kernel) is the weights and the matrix in one launch, kernel
// 7 (irls_sweep_kernel) one sweep in one launch.
//
// Layout: kernel 5's. ut, uw, out (H, W, B, 2) float2 a site; the nine
// per-warp channel maps (it, gy, gx of the intensity, then of the y and x
// gradient constancy) and the step's coefficients (the weights w_up,
// w_dn, w_lf, w_rt, then a11, a12, a22, b1, b2) are each a stack of nine
// (H, W, B) planes, a plane n = H * W * B floats from the next.
//
// What bounds them on the H100: bytes. Kernel 6 reads the flow (8 B a site;
// its neighbours from L1 and L2 as in kernel 5), u_w (8) and the nine maps
// (36) and writes the nine coefficients (36): 88 B a site, against about
// 80 operations. Kernel 7 reads the flow (8) and the nine coefficients
// (36) and writes the new flow (8): 52 B a site, against about 30
// operations. The sum of the weights, the diagonal term s and the
// determinant are recomputed in each sweep, in the order kernel 6 and the
// plain version use, rather than stored: the same bits, 12 B a site less.
// The design is kernel 5's: one thread a site, float2 flow loads,
// neighbouring threads on neighbouring sites, a block along one row,
// nothing staged but the coefficients, which eight sweeps read again.
//
// Arithmetic: as kernel 5, every operation is the rounded operation of the
// plain version (kernels/flow.py irls_setup_plain, irls_sweep_plain) in its
// order, no multiply-add contracted, sqrt as __fsqrt_rn and 1 / x as
// __fdiv_rn(1, x); both kernels are bitwise equal to the plain versions on
// the card. With du = ut - uw and, for channel c of weight cw_c (1, gamma,
// gamma), r_c = (it_c + gy_c * du_0) + gx_c * du_1:
//   w_k   = 1 / sqrt((d_k0 * d_k0 + d_k1 * d_k1) + eps_s^2), d_k = n_k - ut
//   wsum  = ((w_up + w_dn) + w_lf) + w_rt,  s = (alpha^2 * wsum) * 0.25
//   w_pix = 1 / sqrt((((0 + (1 * r_0) * r_0) + (gamma * r_1) * r_1)
//                     + (gamma * r_2) * r_2) + eps^2)
//   wc_c  = cw_c * w_pix, c_c = (it_c - gy_c * uw_0) - gx_c * uw_1
//   a11 = s + sum_c (wc_c * gy_c) * gy_c, a22 = s + sum_c (wc_c * gx_c) * gx_c,
//   a12 = 0 + sum_c (wc_c * gy_c) * gx_c,
//   b1 = 0 - sum_c (wc_c * gy_c) * c_c, b2 = 0 - sum_c (wc_c * gx_c) * c_c
//   (each sum in channel order), and a sweep:
//   ua_i  = (((w_up * up_i + w_dn * dn_i) + w_lf * lf_i) + w_rt * rt_i) / wsum
//   r1 = s * ua_0 + b1, r2 = s * ua_1 + b2, det = a11 * a22 - a12 * a12
//   ut'   = (0.5 * ut_0 + 0.5 * ((a22 * r1 - a12 * r2) / det),
//            0.5 * ut_1 + 0.5 * ((a11 * r2 - a12 * r1) / det))

constexpr int kMaps = 9;

__device__ __forceinline__ float smooth_weight(float2 n, float2 u, float eps2_s) {
  const float d0 = __fsub_rn(n.x, u.x), d1 = __fsub_rn(n.y, u.y);
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), eps2_s)));
}

__global__ void irls_setup_kernel(const float2* __restrict__ ut, const float2* __restrict__ uw,
                                  const float* __restrict__ maps, float* __restrict__ coef, int h, int row,
                                  int b, float alpha2, float eps2, float eps2_s, float gamma) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= row) return;
  const int y = blockIdx.y;
  const long long n = (long long)h * row;
  const long long i = (long long)y * row + j;
  const long long up = y > 0 ? i - row : i;
  const long long dn = y < h - 1 ? i + row : i;
  const long long lf = j >= b ? i - b : i;
  const long long rt = j + b < row ? i + b : i;
  const float2 u = ut[i], w = uw[i];
  const float ws0 = smooth_weight(ut[up], u, eps2_s), ws1 = smooth_weight(ut[dn], u, eps2_s);
  const float ws2 = smooth_weight(ut[lf], u, eps2_s), ws3 = smooth_weight(ut[rt], u, eps2_s);
  const float wsum = __fadd_rn(__fadd_rn(__fadd_rn(ws0, ws1), ws2), ws3);
  const float s = __fmul_rn(__fmul_rn(alpha2, wsum), 0.25f);
  const float du0 = __fsub_rn(u.x, w.x), du1 = __fsub_rn(u.y, w.y);
  const float cw[3] = {1.f, gamma, gamma};
  float it[3], gy[3], gx[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    it[c] = maps[(3 * c) * n + i];
    gy[c] = maps[(3 * c + 1) * n + i];
    gx[c] = maps[(3 * c + 2) * n + i];
  }
  float r2 = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float r = __fadd_rn(__fadd_rn(it[c], __fmul_rn(gy[c], du0)), __fmul_rn(gx[c], du1));
    r2 = __fadd_rn(r2, __fmul_rn(__fmul_rn(cw[c], r), r));
  }
  const float w_pix = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(r2, eps2)));
  float a11 = s, a12 = 0.f, a22 = s, b1 = 0.f, b2 = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float wc = __fmul_rn(cw[c], w_pix);
    const float wy = __fmul_rn(wc, gy[c]), wx = __fmul_rn(wc, gx[c]);
    a11 = __fadd_rn(a11, __fmul_rn(wy, gy[c]));
    a12 = __fadd_rn(a12, __fmul_rn(wy, gx[c]));
    a22 = __fadd_rn(a22, __fmul_rn(wx, gx[c]));
    const float cc = __fsub_rn(__fsub_rn(it[c], __fmul_rn(gy[c], w.x)), __fmul_rn(gx[c], w.y));
    b1 = __fsub_rn(b1, __fmul_rn(wy, cc));
    b2 = __fsub_rn(b2, __fmul_rn(wx, cc));
  }
  const float out[kMaps] = {ws0, ws1, ws2, ws3, a11, a12, a22, b1, b2};
#pragma unroll
  for (int k = 0; k < kMaps; ++k) coef[k * n + i] = out[k];
}

__global__ void irls_sweep_kernel(const float2* __restrict__ ut, const float* __restrict__ coef,
                                  float2* __restrict__ out, int h, int row, int b, float alpha2) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= row) return;
  const int y = blockIdx.y;
  const long long n = (long long)h * row;
  const long long i = (long long)y * row + j;
  const long long up = y > 0 ? i - row : i;
  const long long dn = y < h - 1 ? i + row : i;
  const long long lf = j >= b ? i - b : i;
  const long long rt = j + b < row ? i + b : i;
  const float2 u = ut[i], u_up = ut[up], u_dn = ut[dn], u_lf = ut[lf], u_rt = ut[rt];
  const float w0 = coef[i], w1 = coef[n + i], w2 = coef[2 * n + i], w3 = coef[3 * n + i];
  const float a11 = coef[4 * n + i], a12 = coef[5 * n + i], a22 = coef[6 * n + i];
  const float b1 = coef[7 * n + i], b2 = coef[8 * n + i];
  const float wsum = __fadd_rn(__fadd_rn(__fadd_rn(w0, w1), w2), w3);
  const float s = __fmul_rn(__fmul_rn(alpha2, wsum), 0.25f);
  const float det = __fsub_rn(__fmul_rn(a11, a22), __fmul_rn(a12, a12));
  const float ua0 = __fdiv_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w0, u_up.x), __fmul_rn(w1, u_dn.x)),
                                                  __fmul_rn(w2, u_lf.x)),
                                        __fmul_rn(w3, u_rt.x)),
                              wsum);
  const float ua1 = __fdiv_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w0, u_up.y), __fmul_rn(w1, u_dn.y)),
                                                  __fmul_rn(w2, u_lf.y)),
                                        __fmul_rn(w3, u_rt.y)),
                              wsum);
  const float r1 = __fadd_rn(__fmul_rn(s, ua0), b1), r2 = __fadd_rn(__fmul_rn(s, ua1), b2);
  const float uy = __fdiv_rn(__fsub_rn(__fmul_rn(a22, r1), __fmul_rn(a12, r2)), det);
  const float ux = __fdiv_rn(__fsub_rn(__fmul_rn(a11, r2), __fmul_rn(a12, r1)), det);
  out[i] = make_float2(__fadd_rn(__fmul_rn(0.5f, u.x), __fmul_rn(0.5f, uy)),
                       __fadd_rn(__fmul_rn(0.5f, u.y), __fmul_rn(0.5f, ux)));
}

}  // namespace

// ut, uw, out (h, w, b, 2); it, ix, iy, denom (h, w, b); h <= 65535 (the
// grid's y extent) and w * b < 2^31, both checked by the wrapper; out must
// not overlap ut.
extern "C" int vm_hs_sweep(const float* ut, const float* uw, const float* it, const float* ix,
                           const float* iy, const float* denom, float* out, int h, int w, int b,
                           void* stream) {
  const int row = w * b;
  dim3 grid((row + kThreads - 1) / kThreads, h);
  hs_sweep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)ut, (const float2*)uw, it, ix, iy, denom, (float2*)out, h, row, b);
  return (int)cudaGetLastError();
}

// ut, uw (h, w, b, 2); maps, coef (9, h, w, b); h <= 65535 and w * b < 2^31,
// checked by the wrapper; coef must not overlap the inputs.
extern "C" int vm_irls_setup(const float* ut, const float* uw, const float* maps, float* coef, int h, int w,
                             int b, float alpha2, float eps2, float eps2_s, float gamma, void* stream) {
  const int row = w * b;
  dim3 grid((row + kThreads - 1) / kThreads, h);
  irls_setup_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)ut, (const float2*)uw, maps, coef, h, row, b, alpha2, eps2, eps2_s, gamma);
  return (int)cudaGetLastError();
}

// ut, out (h, w, b, 2); coef (9, h, w, b) as vm_irls_setup wrote it; out
// must not overlap ut or coef.
extern "C" int vm_irls_sweep(const float* ut, const float* coef, float* out, int h, int w, int b, float alpha2,
                             void* stream) {
  const int row = w * b;
  dim3 grid((row + kThreads - 1) / kThreads, h);
  irls_sweep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const float2*)ut, coef, (float2*)out, h, row,
                                                                 b, alpha2);
  return (int)cudaGetLastError();
}
