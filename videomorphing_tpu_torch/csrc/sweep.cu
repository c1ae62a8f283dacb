// The solver's sweep for Hopper (sm_90a): energy, gradient and
// preconditioner of the halfway-domain energy on linearized warps.
//
// Replaces the Pallas builders videomorphing_tpu/pallas/sweep.py:293
// (_build_grad_call, kernel 1) and :502 (_build_energy_call, kernel 2).
// Both kernels are one template, sweep_kernel<R, WITH_GRAD>, so the energy
// the line search sees and the energy of the gradient pass cannot drift
// apart.
//
// What bounds it on the H100: operations. Per pixel and channel the
// gradient pass takes ~29 window sums and ~60 maps, all from shared memory;
// the inputs are read once per tile plus a halo. Design: one block of
// 16 x 16 threads per 16 x 16 output tile, staged through shared memory
// with the halo arithmetic of the Pallas body:
//   1. the linearized warps a0 = w0 - dw0.(v - v_lin), a1 = w1 + dw1.(v - v_lin)
//      at halo 2R (R = window radius), zero outside the image;
//   2. window statistics and the SSIM coefficient maps at halo R, with 1/n
//      the separable product ny[y] * nx[x] of in-image tap sums;
//   3. the transposed window sums down to halo 0, chained through dw0/dw1.
// Channels run in a loop so shared memory stays bounded (~33 KB at R = 2);
// the curvature accumulators persist across channels. The TPS stencils read
// v straight from global memory (L1-cached). Energy partials reduce per
// block in a fixed shared-memory tree and then across blocks in a fixed
// order by sweep_reduce_kernel: no float atomics, so reruns are bitwise
// identical.
//
// Row-shard form (Pallas: the same builders driven by
// fused_grad_parts_shard, sweep.py:936, and fused_energy_parts_shard, :959):
// the arrays hold a block of rows extended by real neighbour rows, its owned
// rows are [own0, own0 + nown), and row0 / gh place it in the global frame.
// Every in-image test, 1/n and the TPS stencil validity use global rows;
// outputs and energy partials cover the owned rows only, so the caller sums
// the raw partials over the blocks and normalizes by the global pixel count.
// The whole frame is the form with one block: row0 = own0 = 0, gh = nown = h.

#include <cuda_runtime.h>

extern "C" {
// Mirrored by ctypes in kernels/sweep.py (same field order).
struct VmSweepScalars {
  float taps[8];
  int radius;
  int use_luminance;
  float c1, c2;
  float scale;        // -1 / (npix * C), d mean(1 - s) / ds
  float lam_n;        // lambda_tps / npix
  float gui_n;        // 2 gamma_ui / npix
  float gtc_n;        // 2 beta_tc / npix
  float psim_n;       // 2 / (npix * C)
  float ptps;         // 25 lambda_tps / npix
  float pquad_n;      // 2 / npix
  float eps_n;        // precond_eps / npix
  float gamma_ui, beta_tc, lambda_tps;
  int h, w, C;        // rows of the block's arrays (owned + neighbour rows), width, channels
  int row0;           // global row of the arrays' row 0
  int gh;             // global height
  int own0, nown;     // owned rows [own0, own0 + nown) of the arrays
};
}

namespace {

constexpr int T = 16;
constexpr int NT = T * T;

__device__ __forceinline__ float tap_sum_range(const VmSweepScalars& s, int center, int n) {
  // sum of the window taps that land inside [0, n) around `center`
  float acc = 0.0f;
  for (int t = 0; t <= 2 * s.radius; ++t) {
    int q = center + t - s.radius;
    if (q >= 0 && q < n) acc += s.taps[t];
  }
  return acc;
}

// local row y lies in the block's arrays and in the global frame
__device__ __forceinline__ bool row_in(const VmSweepScalars& s, int y) {
  int g = y + s.row0;
  return y >= 0 && y < s.h && g >= 0 && g < s.gh;
}

// Second-difference maps of field component k at (y, x), zero where the
// stencil leaves the global image (solver/energy.py tps_maps).
__device__ __forceinline__ void tps_maps_at(const float* __restrict__ v, int y, int x, int k,
                                            const VmSweepScalars& s, float& vxx, float& vxy,
                                            float& vyy) {
  const int w = s.w;
  vxx = vxy = vyy = 0.0f;
  if (!row_in(s, y) || x < 0 || x >= w) return;
  auto V = [&](int yy, int xx) { return v[2 * (yy * w + xx) + k]; };
  float c = V(y, x);
  int g = y + s.row0;
  bool inx = x >= 1 && x <= w - 2;
  bool iny = g >= 1 && g <= s.gh - 2;
  if (inx) vxx = V(y, x + 1) - 2.0f * c + V(y, x - 1);
  if (iny) vyy = V(y + 1, x) - 2.0f * c + V(y - 1, x);
  if (inx && iny)
    vxy = 0.25f * (V(y + 1, x + 1) - V(y + 1, x - 1) - V(y - 1, x + 1) + V(y - 1, x - 1));
}

template <int R, bool WITH_GRAD>
__global__ void __launch_bounds__(NT)
sweep_kernel(const float* __restrict__ planes, const float* __restrict__ v_lin,
             const float* __restrict__ v, const float* __restrict__ ui_w,
             const float* __restrict__ ui_v, const float* __restrict__ tc_w,
             const float* __restrict__ tc_v, float* __restrict__ grad,
             float* __restrict__ precond, float* __restrict__ partials, VmSweepScalars s) {
  constexpr int HS = WITH_GRAD ? R : 0;  // halo of the window statistics
  constexpr int HA = HS + R;             // halo of the linearized warps
  constexpr int NA = T + 2 * HA;
  constexpr int NS = T + 2 * HS;
  constexpr int K = 2 * R + 1;

  __shared__ float sa0[NA * NA], sa1[NA * NA];
  __shared__ float svert[5][NS * NA];               // vertical pass of the 5 stats
  __shared__ float sq[4][NS * NS];     // transposed-sum inputs
  __shared__ float scurv[2][NS * NS];  // curvature, summed over channels
  __shared__ float stv[4][T * NS];     // vertical pass of the transposed sums
  __shared__ float sred[4][NT];

  const int h = s.h, w = s.w, C = s.C;
  const int hw = h * w;
  const int own_end = s.own0 + s.nown;
  const int tid = threadIdx.y * T + threadIdx.x;
  const int y0 = s.own0 + blockIdx.y * T, x0 = blockIdx.x * T;
  const int oy = y0 + threadIdx.y, ox = x0 + threadIdx.x;
  const bool own_in = oy < own_end && ox < w;
  const int opix = oy * w + ox;                // in the block's arrays
  const int qpix = (oy - s.own0) * w + ox;     // in the owned-row maps and outputs

  float taps[K];
#pragma unroll
  for (int t = 0; t < K; ++t) taps[t] = s.taps[t];

  float e_sim = 0.0f;
  float gs_y = 0.0f, gs_x = 0.0f;
  if (WITH_GRAD) {
    for (int i = tid; i < NS * NS; i += NT) {
      scurv[0][i] = 0.0f;
      scurv[1][i] = 0.0f;
    }
  }

  const float* W0 = planes;
  const float* W1 = planes + (size_t)C * hw;
  const float* D0 = planes + (size_t)2 * C * hw;
  const float* D1 = planes + (size_t)4 * C * hw;

  for (int c = 0; c < C; ++c) {
    // 1. linearized warps at halo HA, zero outside the image
    for (int i = tid; i < NA * NA; i += NT) {
      int gy = y0 - HA + i / NA, gx = x0 - HA + i % NA;
      float a0 = 0.0f, a1 = 0.0f;
      if (row_in(s, gy) && gx >= 0 && gx < w) {
        int p = gy * w + gx;
        float dvy = v[2 * p] - v_lin[2 * p];
        float dvx = v[2 * p + 1] - v_lin[2 * p + 1];
        a0 = W0[(size_t)c * hw + p] -
             (D0[(size_t)(2 * c) * hw + p] * dvy + D0[(size_t)(2 * c + 1) * hw + p] * dvx);
        a1 = W1[(size_t)c * hw + p] +
             (D1[(size_t)(2 * c) * hw + p] * dvy + D1[(size_t)(2 * c + 1) * hw + p] * dvx);
      }
      sa0[i] = a0;
      sa1[i] = a1;
    }
    __syncthreads();

    // 2a. vertical window sums of a0, a1, a0^2, a1^2, a0 a1 (rows of the stats tile)
    for (int i = tid; i < NS * NA; i += NT) {
      int r = i / NA, cx = i % NA;
      float m0 = 0.f, m1 = 0.f, q00 = 0.f, q11 = 0.f, q01 = 0.f;
#pragma unroll
      for (int t = 0; t < K; ++t) {
        float a = sa0[(r + t) * NA + cx], b = sa1[(r + t) * NA + cx];
        m0 += taps[t] * a;
        m1 += taps[t] * b;
        q00 += taps[t] * (a * a);
        q11 += taps[t] * (b * b);
        q01 += taps[t] * (a * b);
      }
      svert[0][i] = m0;
      svert[1][i] = m1;
      svert[2][i] = q00;
      svert[3][i] = q11;
      svert[4][i] = q01;
    }
    __syncthreads();

    // 2b. horizontal sums -> statistics, SSIM map and coefficient maps
    for (int i = tid; i < NS * NS; i += NT) {
      int r = i / NS, cx = i % NS;
      int gy = y0 - HS + r, gx = x0 - HS + cx;
      bool in = row_in(s, gy) && gx >= 0 && gx < w;
      float st[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < K; ++t) acc += taps[t] * svert[q][r * NA + cx + t];
        st[q] = acc;
      }
      float qv = 0.f, qc = 0.f, q0 = 0.f, q1 = 0.f, cy_ = 0.f, cx_ = 0.f;
      if (in) {
        float inv_n = 1.0f / (tap_sum_range(s, gy + s.row0, s.gh) * tap_sum_range(s, gx, w));
        float mu0 = st[0] * inv_n, mu1 = st[1] * inv_n;
        float var0 = fmaxf(st[2] * inv_n - mu0 * mu0, 0.0f);
        float var1 = fmaxf(st[3] * inv_n - mu1 * mu1, 0.0f);
        float cov = st[4] * inv_n - mu0 * mu1;
        float a2 = 2.0f * cov + s.c2;
        float b2 = var0 + var1 + s.c2;
        float a1 = 1.0f, b1 = 1.0f;
        if (s.use_luminance) {
          a1 = 2.0f * mu0 * mu1 + s.c1;
          b1 = mu0 * mu0 + mu1 * mu1 + s.c1;
        }
        float denom = b1 * b2;
        float ssim = (a1 * a2) / denom;
        if (r >= HS && r < HS + T && cx >= HS && cx < HS + T && gy < own_end) e_sim += 1.0f - ssim;
        if (WITH_GRAD) {
          float ds_da2 = a1 / denom;
          float ds_db2 = -ssim / b2;
          float c_mu0 = 0.f, c_mu1 = 0.f;
          if (s.use_luminance) {
            float ds_da1 = a2 / denom;
            float ds_db1 = -ssim / b1;
            c_mu0 = ds_da1 * 2.0f * mu1 + ds_db1 * 2.0f * mu0;
            c_mu1 = ds_da1 * 2.0f * mu0 + ds_db1 * 2.0f * mu1;
          }
          float c_var = ds_db2, c_cov = ds_da2 * 2.0f;
          qv = s.scale * c_var * inv_n;
          qc = s.scale * c_cov * inv_n;
          q0 = s.scale * (c_mu0 - 2.0f * mu0 * c_var - mu1 * c_cov) * inv_n;
          q1 = s.scale * (c_mu1 - 2.0f * mu1 * c_var - mu0 * c_cov) * inv_n;
          int p = gy * w + gx;
          float d0y = D0[(size_t)(2 * c) * hw + p], d0x = D0[(size_t)(2 * c + 1) * hw + p];
          float d1y = D1[(size_t)(2 * c) * hw + p], d1x = D1[(size_t)(2 * c + 1) * hw + p];
          float ib2 = 1.0f / b2;
          cy_ = (d0y * d0y + d1y * d1y) * ib2;
          cx_ = (d0x * d0x + d1x * d1x) * ib2;
        }
      }
      if (WITH_GRAD) {
        sq[0][i] = q0;
        sq[1][i] = q1;
        sq[2][i] = qv;
        sq[3][i] = qc;
        scurv[0][i] += cy_;
        scurv[1][i] += cx_;
      }
    }
    __syncthreads();

    if (WITH_GRAD) {
      // 3a. vertical transposed window sums
      for (int i = tid; i < T * NS; i += NT) {
        int r = i / NS, cx = i % NS;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float acc = 0.f;
#pragma unroll
          for (int t = 0; t < K; ++t) acc += taps[t] * sq[q][(r + t) * NS + cx];
          stv[q][i] = acc;
        }
      }
      __syncthreads();
      // 3b. horizontal sums at the own pixel; chain through dw0 / dw1
      if (own_in) {
        float tq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float acc = 0.f;
#pragma unroll
          for (int t = 0; t < K; ++t) acc += taps[t] * stv[q][threadIdx.y * NS + threadIdx.x + t];
          tq[q] = acc;
        }
        int la = (threadIdx.y + HA) * NA + threadIdx.x + HA;
        float w0c = sa0[la], w1c = sa1[la];
        float g0 = tq[0] + 2.0f * w0c * tq[2] + w1c * tq[3];
        float g1 = tq[1] + 2.0f * w1c * tq[2] + w0c * tq[3];
        gs_y += -g0 * D0[(size_t)(2 * c) * hw + opix] + g1 * D1[(size_t)(2 * c) * hw + opix];
        gs_x += -g0 * D0[(size_t)(2 * c + 1) * hw + opix] +
                g1 * D1[(size_t)(2 * c + 1) * hw + opix];
      }
    }
    __syncthreads();  // the next channel overwrites the staged tiles
  }

  float pc_y = 0.f, pc_x = 0.f;
  if (WITH_GRAD) {
    // window sum of the curvature (zero outside the image: scurv is 0 there)
    for (int i = tid; i < T * NS; i += NT) {
      int r = i / NS, cx = i % NS;
      float ay = 0.f, ax = 0.f;
#pragma unroll
      for (int t = 0; t < K; ++t) {
        ay += taps[t] * scurv[0][(r + t) * NS + cx];
        ax += taps[t] * scurv[1][(r + t) * NS + cx];
      }
      stv[0][i] = ay;
      stv[1][i] = ax;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < K; ++t) {
      pc_y += taps[t] * stv[0][threadIdx.y * NS + threadIdx.x + t];
      pc_x += taps[t] * stv[1][threadIdx.y * NS + threadIdx.x + t];
    }
  }

  float e_tps = 0.f, e_ui = 0.f, e_tc = 0.f;
  if (own_in) {
    float uw = ui_w[qpix], tw = tc_w[qpix];
    float gk[2];
    for (int k = 0; k < 2; ++k) {
      float vxx, vxy, vyy;
      tps_maps_at(v, oy, ox, k, s, vxx, vxy, vyy);
      e_tps += vxx * vxx + 2.0f * vxy * vxy + vyy * vyy;
      float vk = v[2 * opix + k];
      float dui = vk - ui_v[2 * qpix + k];
      float dtc = vk - tc_v[2 * qpix + k];
      e_ui += uw * (dui * dui);
      e_tc += tw * (dtc * dtc);
      if (WITH_GRAD) {
        // self-adjoint stencils of the three maps (descent.py tps_adj_*)
        float l, r_, u, d, ul, ur, dl, dr, t1, t2;
        tps_maps_at(v, oy, ox - 1, k, s, l, t1, t2);
        tps_maps_at(v, oy, ox + 1, k, s, r_, t1, t2);
        float adj_xx = l - 2.0f * vxx + r_;
        tps_maps_at(v, oy - 1, ox, k, s, t1, t2, u);
        tps_maps_at(v, oy + 1, ox, k, s, t1, t2, d);
        float adj_yy = u - 2.0f * vyy + d;
        tps_maps_at(v, oy - 1, ox - 1, k, s, t1, ul, t2);
        tps_maps_at(v, oy - 1, ox + 1, k, s, t1, ur, t2);
        tps_maps_at(v, oy + 1, ox - 1, k, s, t1, dl, t2);
        tps_maps_at(v, oy + 1, ox + 1, k, s, t1, dr, t2);
        float adj_xy = 0.25f * (ul - ur - dl + dr);
        float g_tps = 2.0f * adj_xx + 4.0f * adj_xy + 2.0f * adj_yy;
        float g_sim = k == 0 ? gs_y : gs_x;
        gk[k] = g_sim + s.lam_n * g_tps + s.gui_n * uw * dui + s.gtc_n * tw * dtc;
      }
    }
    if (WITH_GRAD) {
      float p_rest = s.ptps + s.pquad_n * (s.gamma_ui * uw + s.beta_tc * tw);
      grad[2 * qpix] = gk[0];
      grad[2 * qpix + 1] = gk[1];
      precond[2 * qpix] = s.psim_n * pc_y + p_rest + s.eps_n;
      precond[2 * qpix + 1] = s.psim_n * pc_x + p_rest + s.eps_n;
    }
  }

  // fixed-order tree over the block
  sred[0][tid] = e_sim;
  sred[1][tid] = e_tps;
  sred[2][tid] = e_ui;
  sred[3][tid] = e_tc;
  __syncthreads();
  for (int stride = NT / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int q = 0; q < 4; ++q) sred[q][tid] += sred[q][tid + stride];
    }
    __syncthreads();
  }
  if (tid < 4) {
    int b = blockIdx.y * gridDim.x + blockIdx.x;
    partials[4 * b + tid] = sred[tid][0];
  }
}

constexpr int RED = 256;

// Sums the per-block partials in a fixed order and combines them into the
// energy like pallas/sweep.py _combine_parts. out: (sim, tps, ui, tc, E); a
// row shard's E covers its own rows only, and its caller combines the raw
// partials of all shards instead.
__global__ void __launch_bounds__(RED)
sweep_reduce_kernel(const float* __restrict__ partials, int n_blocks, float* __restrict__ out,
                    VmSweepScalars s) {
  __shared__ float sred[4][RED];
  int tid = threadIdx.x;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b = tid; b < n_blocks; b += RED) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += partials[4 * b + q];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) sred[q][tid] = acc[q];
  __syncthreads();
  for (int stride = RED / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int q = 0; q < 4; ++q) sred[q][tid] += sred[q][tid + stride];
    }
    __syncthreads();
  }
  if (tid == 0) {
    float npix = (float)(s.gh * s.w);
    float npix_c = (float)(s.gh * s.w * s.C);
    out[0] = sred[0][0];
    out[1] = sred[1][0];
    out[2] = sred[2][0];
    out[3] = sred[3][0];
    out[4] = sred[0][0] / npix_c + s.lambda_tps * sred[1][0] / npix +
             s.gamma_ui * sred[2][0] / npix + s.beta_tc * sred[3][0] / npix;
  }
}

template <int R, bool WITH_GRAD>
int launch(const float* planes, const float* v_lin, const float* v, const float* ui_w,
           const float* ui_v, const float* tc_w, const float* tc_v, float* grad,
           float* precond, float* partials, float* out, const VmSweepScalars& s,
           cudaStream_t stream) {
  dim3 block(T, T);
  dim3 grid((s.w + T - 1) / T, (s.nown + T - 1) / T);
  sweep_kernel<R, WITH_GRAD><<<grid, block, 0, stream>>>(planes, v_lin, v, ui_w, ui_v, tc_w,
                                                         tc_v, grad, precond, partials, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweep_reduce_kernel<<<1, RED, 0, stream>>>(partials, (int)(grid.x * grid.y), out, s);
  return (int)cudaGetLastError();
}

template <bool WITH_GRAD>
int dispatch(const float* planes, const float* v_lin, const float* v, const float* ui_w,
             const float* ui_v, const float* tc_w, const float* tc_v, float* grad,
             float* precond, float* partials, float* out, const VmSweepScalars* s,
             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (s->radius) {
    case 1:
      return launch<1, WITH_GRAD>(planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, grad, precond,
                                  partials, out, *s, st);
    case 2:
      return launch<2, WITH_GRAD>(planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, grad, precond,
                                  partials, out, *s, st);
    case 3:
      return launch<3, WITH_GRAD>(planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, grad, precond,
                                  partials, out, *s, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vm_sweep_grad(const float* planes, const float* v_lin, const float* v,
                             const float* ui_w, const float* ui_v, const float* tc_w,
                             const float* tc_v, float* grad, float* precond, float* partials,
                             float* out, const VmSweepScalars* s, void* stream) {
  return dispatch<true>(planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, grad, precond, partials, out,
                        s, stream);
}

extern "C" int vm_sweep_energy(const float* planes, const float* v_lin, const float* v,
                               const float* ui_w, const float* ui_v, const float* tc_w,
                               const float* tc_v, float* partials, float* out,
                               const VmSweepScalars* s, void* stream) {
  return dispatch<false>(planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, nullptr, nullptr, partials,
                         out, s, stream);
}
