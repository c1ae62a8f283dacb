// One Horn-Schunck Jacobi sweep of a batch of flows for Hopper (sm_90a):
// kernel 5, the flows' sweep.
//
// Replaces no TPU kernel: the reference's _hs_level
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
