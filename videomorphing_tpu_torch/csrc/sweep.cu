// The solver's sweep for Hopper (sm_90a): energy, gradient and
// preconditioner of the halfway-domain energy on linearized warps.
//
// Replaces the Pallas builders videomorphing_tpu/pallas/sweep.py:293
// (_build_grad_call, kernel 1) and :502 (_build_energy_call, kernel 2).
// Both kernels are one template, sweep_kernel<R, WITH_GRAD>, so the energy
// the line search sees and the energy of the gradient pass cannot drift
// apart.
//
// What bounds it on the H100. Counting each input read once and each
// output written once, kernel 1 at 1024^2, C = 3 moves 134 MB (40 us at
// 3.35 TB/s) and does ~650 operations per pixel (10 us at 67 TFLOP/s):
// bytes, on paper. In practice it is bound by instructions and their
// latency: every owned pixel and its halo go through 5 K-tap window sums in
// two passes, the SSIM coefficient maps (divisions) and 4 transposed sums
// per channel, each stage behind a barrier, with 2 blocks (16 warps) on an
// SM. Design, per block of TILE_ROWS x TILE_COLS owned pixels, 256 threads:
//   0. once per tile: dv = v - v_lin at the warp halo 2R; the row and
//      column tap-sum tables of the in-image window and from them 1/n at
//      the statistics halo R (no tap loop per pixel and channel); and, into
//      registers, the v tile of the TPS stencils and the UI/TC maps of the
//      thread's owned pair, in flight while the channels run;
//   1. per channel, the six planes (w0, w1, dw0, dw1) of the tile and its
//      halo arrive by cp.async, zero-filled (src-size 0) outside the image.
//      The dw planes are double-buffered: channel c+1's are issued as
//      channel c starts, its w0/w1 once channel c's linearized warps
//      a0 = w0 - dw0.dv, a1 = w1 + dw1.dv are in shared memory, so both are
//      in flight during channel c's window sums; every later stage reads dw
//      from shared memory;
//   2. window statistics at halo R: the vertical pass walks column
//      segments with their window in registers (seg + 2R rows loaded for
//      seg outputs, seg_rows()); the horizontal pass takes 4 neighbouring
//      pixels per item from float4 windows, then the SSIM map and its
//      coefficient maps (the gradient's reciprocals by __fdividef; the
//      energy's SSIM keeps its IEEE division);
//   3. the transposed window sums down to the owned pixels (vertical by
//      column segments, horizontal at each thread's pair of neighbours from
//      float2 windows), chained through dw0/dw1;
//   4. after the channels: the curvature's window sum, and the TPS maps
//      computed once on a (TILE_ROWS + 2) x (TILE_COLS + 2) tile of v in
//      shared memory, from which the adjoint stencil reads its neighbours.
// The output tile is 32 x 16 rather than 16 x 16: the staged halo falls
// from 2.25x to 1.88x of the owned pixels at R = 2 (statistics from 1.56x
// to 1.41x). Shared memory is dynamic (90 KB at R = 2 for the gradient, so
// two blocks share an SM; set with cudaFuncSetAttribute and checked).
//
// cp.async rather than TMA: a TMA tile needs a 16-byte-aligned row stride,
// W % 4 == 0, and the pyramid's levels break that (a 135 x 241 level, 4K
// level widths such as 30); 4-byte cp.async takes any width and any origin.
// No tensor cores: the window sums are 3- to 7-tap float32 stencils, and
// TF32 products would break the 1e-5 gate against the plain version.
//
// Every per-pixel sum keeps its order (taps t = 0..K-1, the vertical pass
// before the horizontal one), and no value depends on where the tile
// starts, so a row shard's outputs equal the whole frame's rows bit for
// bit. Energy partials reduce per block in a fixed shared-memory tree and
// then across blocks in a fixed order by sweep_reduce_kernel: no float
// atomics, so reruns are bitwise identical.
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

// The output tile: rows x columns of owned pixels per block. kernels/sweep.py
// reads these two lines (sweep_tile()) to size the energy partials, one set
// of four per block, and vm_sweep_n_partials gives the same count here.
constexpr int TILE_ROWS = 16;
constexpr int TILE_COLS = 32;

constexpr int TY = TILE_ROWS, TX = TILE_COLS;
constexpr int NT = 256;              // threads per block
constexpr int NOWN = TY * TX / NT;   // owned outputs per thread: a pair of neighbours in a row
static_assert(NOWN == 2 && (TX / 2) * TY == NT, "each thread owns two neighbouring pixels");

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Rows per item of a vertical window pass over rows x cols outputs: each
// item keeps a column segment's window in registers, so it loads seg + 2R
// rows for seg outputs. The length with the fewest rows loaded per thread
// (passes over the block times rows per item), the longer on a tie.
__host__ __device__ constexpr int seg_rows(int rows, int cols, int R) {
  int best = 1, best_cost = 1 << 30;
  for (int seg = 1; seg <= 8; ++seg) {
    int items = (rows + seg - 1) / seg * cols;
    int cost = (items + NT - 1) / NT * (seg + 2 * R);
    if (cost <= best_cost) {
      best = seg;
      best_cost = cost;
    }
  }
  return best;
}

// Tile geometry and shared-memory layout (in floats) of one instantiation.
// Row strides are multiples of 4 floats so the horizontal passes load
// float4 / float2 windows; the extra columns are real image columns (or
// zeros) that feed only outputs outside the tile.
template <int R, bool WITH_GRAD>
struct Geo {
  static constexpr int K = 2 * R + 1;
  static constexpr int HS = WITH_GRAD ? R : 0;  // halo of the window statistics
  static constexpr int HA = HS + R;             // halo of the linearized warps
  static constexpr int SY = TY + 2 * HS, SX = TX + 2 * HS;  // statistics tile
  static constexpr int SXP = round4(SX), NS = SY * SXP;
  static constexpr int AY = TY + 2 * HA, AW = round4(SXP + 2 * R), NA = AY * AW;  // warps
  static constexpr int MY = TY + 2, MX = TX + 2, NM = MY * MX;  // TPS maps
  static constexpr int VY = TY + 4, VX = TX + 4, NV = VY * VX;  // v for the maps
  static constexpr int NJ = (NA + NT - 1) / NT;  // staged elements per thread
  static constexpr int SEG_A = seg_rows(SY, AW, R);  // rows per item, statistics' vertical pass
  static constexpr int SEG_Q = seg_rows(TY, SXP, R);  // rows per item, transposed vertical pass
  static constexpr int NF = (4 + 2 * R + 3) / 4;      // float4s of a 4-output horizontal window
  // planes: w0, w1 (2 NA) and two buffers of dw0y, dw0x, dw1y, dw1x (8 NA);
  // after the channel loop the v tile (2 NV) and the TPS maps (6 NM)
  static constexpr int P_SIZE = round4(cmax(10 * NA, 2 * NV + 6 * NM));
  static constexpr int A_SIZE = 4 * NA;  // dv (y, x) and a0, a1
  // vertical sums of the 5 statistics; later the vertical transposed sums
  // (4 TY SXP), the curvature's vertical sums and the block reduction
  static constexpr int V_SIZE = cmax(cmax(5 * SY * AW, 4 * TY * SXP), 4 * NT);
  static constexpr int Q_SIZE = WITH_GRAD ? 4 * NS : 0;  // transposed-sum inputs
  static constexpr int CURV_SIZE = WITH_GRAD ? 2 * NS : 0;
  static constexpr int FLOATS = P_SIZE + A_SIZE + V_SIZE + Q_SIZE + CURV_SIZE + NS + round4(SY) + SXP;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

__device__ __forceinline__ float tap_sum_range(const float* taps, int radius, int center, int n) {
  // sum of the window taps that land inside [0, n) around `center`
  float acc = 0.0f;
  for (int t = 0; t <= 2 * radius; ++t) {
    int q = center + t - radius;
    if (q >= 0 && q < n) acc += taps[t];
  }
  return acc;
}

// local row y lies in the block's arrays and in the global frame
__device__ __forceinline__ bool row_in(const VmSweepScalars& s, int y) {
  int g = y + s.row0;
  return y >= 0 && y < s.h && g >= 0 && g < s.gh;
}

// 4-byte asynchronous copy global -> shared; zero-fills when !in
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Second-difference maps of one field component at (y, x), zero where the
// stencil leaves the global image (solver/energy.py tps_maps); vt points at
// (y, x) in the staged v tile of row stride VX.
template <int VX>
__device__ __forceinline__ void tps_maps_at(const float* vt, int y, int x,
                                            const VmSweepScalars& s, float& vxx, float& vxy,
                                            float& vyy) {
  vxx = vxy = vyy = 0.0f;
  if (!row_in(s, y) || x < 0 || x >= s.w) return;
  float c = vt[0];
  int g = y + s.row0;
  bool inx = x >= 1 && x <= s.w - 2;
  bool iny = g >= 1 && g <= s.gh - 2;
  if (inx) vxx = vt[1] - 2.0f * c + vt[-1];
  if (iny) vyy = vt[VX] - 2.0f * c + vt[-VX];
  if (inx && iny) vxy = 0.25f * (vt[VX + 1] - vt[VX - 1] - vt[-VX + 1] + vt[-VX - 1]);
}

// Vertical K-tap window sums of NQ planes (row stride `cols`, `in_rows`
// rows each, plane stride in_stride) into NQ planes of `rows` rows (plane
// stride out_stride): each item walks a column segment of SEG outputs,
// loading its SEG + 2R input rows once. Every output sums t = 0..K-1 in
// order, as a per-output loop would.
template <int R, int SEG, int NQ>
__device__ __forceinline__ void vertical_pass(const float* __restrict__ in, int in_stride, int in_rows,
                                              float* __restrict__ out, int out_stride, int rows,
                                              int cols, const float* taps, int tid) {
  constexpr int K = 2 * R + 1;
  const int nseg = (rows + SEG - 1) / SEG;
  for (int i = tid; i < nseg * cols; i += NT) {
    int g = i / cols, c = i % cols, r0 = g * SEG;
    float acc[SEG][NQ];
#pragma unroll
    for (int j = 0; j < SEG; ++j)
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[j][q] = 0.0f;
#pragma unroll
    for (int u = 0; u < SEG + 2 * R; ++u) {
      int row = min(r0 + u, in_rows - 1);  // rows past the end feed no stored output
      float x[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) x[q] = in[q * in_stride + row * cols + c];
#pragma unroll
      for (int j = 0; j < SEG; ++j) {
        const int t = u - j;
        if (t >= 0 && t < K) {
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc[j][q] += taps[t] * x[q];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SEG; ++j) {
      if (r0 + j < rows) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) out[q * out_stride + (r0 + j) * cols + c] = acc[j][q];
      }
    }
  }
}

// K-tap horizontal window sums at the two neighbouring outputs (x0, x0 + 1)
// of one row, from float2 loads of the 2 + 2R inputs; x0 is even.
template <int R>
__device__ __forceinline__ void pair_sums(const float* __restrict__ row, int x0, const float* taps,
                                          float& s0, float& s1) {
  constexpr int K = 2 * R + 1;
  float x[2 * R + 2];
  const float2* src = reinterpret_cast<const float2*>(row + x0);
#pragma unroll
  for (int f = 0; f <= R; ++f) {
    float2 v = src[f];
    x[2 * f] = v.x;
    x[2 * f + 1] = v.y;
  }
  s0 = 0.0f;
  s1 = 0.0f;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    s0 += taps[t] * x[t];
    s1 += taps[t] * x[t + 1];
  }
}

template <int R, bool WITH_GRAD>
__global__ void __launch_bounds__(NT, 2)
sweep_kernel(const float* __restrict__ planes, const float* __restrict__ v_lin,
             const float* __restrict__ v, const float* __restrict__ ui_w,
             const float* __restrict__ ui_v, const float* __restrict__ tc_w,
             const float* __restrict__ tc_v, float* __restrict__ grad,
             float* __restrict__ precond, float* __restrict__ partials, VmSweepScalars s) {
  using G = Geo<R, WITH_GRAD>;
  constexpr int K = G::K, HS = G::HS, HA = G::HA;
  constexpr int AY = G::AY, AW = G::AW, NA = G::NA, SY = G::SY, SX = G::SX, SXP = G::SXP,
                NS = G::NS;
  constexpr int MX = G::MX, NM = G::NM, VX = G::VX, NV = G::NV, NJ = G::NJ, NF = G::NF;

  extern __shared__ float4 smem4[];
  float* const sW = reinterpret_cast<float*>(smem4);  // w0, w1 of the current channel
  float* const sD = sW + 2 * NA;                      // dw planes, 2 buffers of 4 NA
  float* const sVt = sW;                              // after the loop: v tile (2 NV)
  float* const sM = sW + 2 * NV;                      // after the loop: TPS maps (6 NM)
  float* const sDv = sW + G::P_SIZE;                  // dv y, x (2 NA)
  float* const sA = sDv + 2 * NA;                     // a0, a1 (2 NA)
  float* const sV = sA + 2 * NA;                      // vertical sums and their aliases
  float* const sQ = sV + G::V_SIZE;                   // transposed-sum inputs (4 NS)
  float* const sCurv = sQ + G::Q_SIZE;                // curvature, summed over channels (2 NS)
  float* const sInvN = sCurv + G::CURV_SIZE;          // 1 / n at the statistics tile (NS)
  float* const sNy = sInvN + NS;                      // row tap sums (SY)
  float* const sNx = sNy + round4(SY);                // column tap sums (SXP)

  const int h = s.h, w = s.w, C = s.C;
  const int hw = h * w;
  const int own_end = s.own0 + s.nown;
  const int tid = threadIdx.x;
  const int y0 = s.own0 + blockIdx.y * TY, x0 = blockIdx.x * TX;
  // this thread's owned pair: row ly, columns lx0 and lx0 + 1 of the tile
  const int ly = tid / (TX / 2), lx0 = 2 * (tid % (TX / 2));

  float taps[K];
#pragma unroll
  for (int t = 0; t < K; ++t) taps[t] = s.taps[t];

  // the staged elements of this thread: flat offset in the image, or -1
  int jp[NJ];
#pragma unroll
  for (int u = 0; u < NJ; ++u) {
    int j = tid + u * NT, p = -1;
    if (j < NA) {
      int gy = y0 - HA + j / AW, gx = x0 - HA + j % AW;
      if (row_in(s, gy) && gx >= 0 && gx < w) p = gy * w + gx;
    }
    jp[u] = p;
  }

  // cp.async of channel c's planes (zero outside the image): its four dw
  // planes into their buffer, or its w0, w1
  auto issue = [&](int c, bool dw) {
    float* dst = dw ? sD + (c & 1) * 4 * NA : sW;
#pragma unroll
    for (int u = 0; u < NJ; ++u) {
      int j = tid + u * NT;
      if (j < NA) {
        bool in = jp[u] >= 0;
        int p = in ? jp[u] : 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!dw && k >= 2) break;
          // dw0 y, dw0 x, dw1 y, dw1 x; or w0, w1
          int plane = dw ? (k < 2 ? 2 : 4) * C + 2 * c + (k & 1) : k * C + c;
          cp_async4(dst + k * NA + j, planes + (size_t)plane * hw + p, in);
        }
      }
    }
    cp_async_commit();
  };
  issue(0, true);
  issue(0, false);

  // loads of the last stage, in flight during the channel loop: this thread's
  // share of the v tile of the TPS stencils (zero outside the arrays) and the
  // constraint maps at its owned pair
  constexpr int NVJ = (NV + NT - 1) / NT;
  float vt_r[NVJ][2];
#pragma unroll
  for (int u = 0; u < NVJ; ++u) {
    int i = tid + u * NT;
    int y = y0 - 2 + i / VX, x = x0 - 2 + i % VX;
    bool in = i < NV && y >= 0 && y < h && x >= 0 && x < w;
    int p = in ? y * w + x : 0;
    vt_r[u][0] = in ? v[2 * p] : 0.0f;
    vt_r[u][1] = in ? v[2 * p + 1] : 0.0f;
  }
  float uw[2], tw[2], uiv[2][2], tcv[2][2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int oy = y0 + ly, ox = x0 + lx0 + k;
    const bool own = oy < own_end && ox < w;
    const int qpix = own ? (oy - s.own0) * w + ox : 0;  // in the owned-row maps
    uw[k] = own ? ui_w[qpix] : 0.0f;
    tw[k] = own ? tc_w[qpix] : 0.0f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uiv[k][kk] = own ? ui_v[2 * qpix + kk] : 0.0f;
      tcv[k][kk] = own ? tc_v[2 * qpix + kk] : 0.0f;
    }
  }

  // 0. dv at the warp halo, tap-sum tables, 1/n, zero curvature
#pragma unroll
  for (int u = 0; u < NJ; ++u) {
    int j = tid + u * NT;
    if (j < NA) {
      float dvy = 0.0f, dvx = 0.0f;
      if (jp[u] >= 0) {
        int p = jp[u];
        dvy = v[2 * p] - v_lin[2 * p];
        dvx = v[2 * p + 1] - v_lin[2 * p + 1];
      }
      sDv[j] = dvy;
      sDv[NA + j] = dvx;
    }
  }
  for (int i = tid; i < SY + SXP; i += NT) {
    if (i < SY) {
      int gy = y0 - HS + i;
      sNy[i] = row_in(s, gy) ? tap_sum_range(taps, R, gy + s.row0, s.gh) : 0.0f;
    } else {
      int gx = x0 - HS + (i - SY);
      sNx[i - SY] = (gx >= 0 && gx < w) ? tap_sum_range(taps, R, gx, w) : 0.0f;
    }
  }
  if (WITH_GRAD) {
    for (int i = tid; i < 2 * NS; i += NT) sCurv[i] = 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < NS; i += NT) {
    int r = i / SXP, cx = i % SXP;
    int gy = y0 - HS + r, gx = x0 - HS + cx;
    bool in = cx < SX && row_in(s, gy) && gx >= 0 && gx < w;
    sInvN[i] = in ? 1.0f / (sNy[r] * sNx[cx]) : 0.0f;
  }

  float e_sim = 0.0f;
  float gs_y[NOWN], gs_x[NOWN];
#pragma unroll
  for (int k = 0; k < NOWN; ++k) gs_y[k] = gs_x[k] = 0.0f;

  for (int c = 0; c < C; ++c) {
    const float* const sDc = sD + (c & 1) * 4 * NA;  // dw0y, dw0x, dw1y, dw1x
    cp_async_wait_all();
    __syncthreads();  // channel c's planes are in; the last channel's stages are done
    if (c + 1 < C) issue(c + 1, true);  // buffer (c+1)&1 was channel c-1's

    // 1. linearized warps at halo HA (zero outside the image: zero planes, zero dv)
#pragma unroll
    for (int u = 0; u < NJ; ++u) {
      int j = tid + u * NT;
      if (j < NA) {
        float dvy = sDv[j], dvx = sDv[NA + j];
        sA[j] = sW[j] - (sDc[j] * dvy + sDc[NA + j] * dvx);
        sA[NA + j] = sW[NA + j] + (sDc[2 * NA + j] * dvy + sDc[3 * NA + j] * dvx);
      }
    }
    __syncthreads();
    if (c + 1 < C) issue(c + 1, false);  // w0, w1 are consumed

    // 2a. vertical window sums of a0, a1, a0^2, a1^2, a0 a1 (rows of the stats tile)
    {
      constexpr int SEG = G::SEG_A;
      const int nseg = (SY + SEG - 1) / SEG;
      for (int i = tid; i < nseg * AW; i += NT) {
        int g = i / AW, cx = i % AW, r0 = g * SEG;
        float acc[SEG][5];
#pragma unroll
        for (int j = 0; j < SEG; ++j)
#pragma unroll
          for (int q = 0; q < 5; ++q) acc[j][q] = 0.0f;
#pragma unroll
        for (int u = 0; u < SEG + 2 * R; ++u) {
          int row = min(r0 + u, AY - 1);  // rows past the end feed no stored output
          float a = sA[row * AW + cx], b = sA[NA + row * AW + cx];
          float aa = a * a, bb = b * b, ab = a * b;
#pragma unroll
          for (int j = 0; j < SEG; ++j) {
            const int t = u - j;
            if (t >= 0 && t < K) {
              acc[j][0] += taps[t] * a;
              acc[j][1] += taps[t] * b;
              acc[j][2] += taps[t] * aa;
              acc[j][3] += taps[t] * bb;
              acc[j][4] += taps[t] * ab;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < SEG; ++j) {
          if (r0 + j < SY) {
#pragma unroll
            for (int q = 0; q < 5; ++q) sV[q * SY * AW + (r0 + j) * AW + cx] = acc[j][q];
          }
        }
      }
    }
    __syncthreads();

    // 2b. horizontal sums -> statistics, SSIM map and coefficient maps, four
    // neighbouring pixels per item from float4 windows
    for (int i = tid; i < SY * (SXP / 4); i += NT) {
      const int r = i / (SXP / 4), c0 = 4 * (i % (SXP / 4));
      const int gy = y0 - HS + r;
      const bool row_ok = row_in(s, gy);
      float st[4][5];
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        float x[4 * NF];
        const float4* src = reinterpret_cast<const float4*>(sV + q * SY * AW + r * AW + c0);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          float4 v4 = src[f];
          x[4 * f] = v4.x;
          x[4 * f + 1] = v4.y;
          x[4 * f + 2] = v4.z;
          x[4 * f + 3] = v4.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int t = 0; t < K; ++t) acc += taps[t] * x[j + t];
          st[j][q] = acc;
        }
      }
      const float4 invn4 = *reinterpret_cast<const float4*>(sInvN + r * SXP + c0);
      const float invn[4] = {invn4.x, invn4.y, invn4.z, invn4.w};
      float qv[4], qc[4], q0[4], q1[4], cy_[4], cx_[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cx = c0 + j, gx = x0 - HS + cx;
        const bool in = row_ok && cx < SX && gx >= 0 && gx < w;
        qv[j] = qc[j] = q0[j] = q1[j] = cy_[j] = cx_[j] = 0.f;
        if (in) {
          float inv_n = invn[j];
          float mu0 = st[j][0] * inv_n, mu1 = st[j][1] * inv_n;
          float var0 = fmaxf(st[j][2] * inv_n - mu0 * mu0, 0.0f);
          float var1 = fmaxf(st[j][3] * inv_n - mu1 * mu1, 0.0f);
          float cov = st[j][4] * inv_n - mu0 * mu1;
          float a2 = 2.0f * cov + s.c2;
          float b2 = var0 + var1 + s.c2;
          float a1 = 1.0f, b1 = 1.0f;
          if (s.use_luminance) {
            a1 = 2.0f * mu0 * mu1 + s.c1;
            b1 = mu0 * mu0 + mu1 * mu1 + s.c1;
          }
          float denom = b1 * b2;
          float ssim = (a1 * a2) / denom;
          if (r >= HS && r < HS + TY && cx >= HS && cx < HS + TX && gy < own_end) e_sim += 1.0f - ssim;
          if (WITH_GRAD) {
            float rden = __fdividef(1.0f, denom), ib2 = __fdividef(1.0f, b2);
            float ds_da2 = a1 * rden;
            float ds_db2 = -ssim * ib2;
            float c_mu0 = 0.f, c_mu1 = 0.f;
            if (s.use_luminance) {
              float ds_da1 = a2 * rden;
              float ds_db1 = -ssim * __fdividef(1.0f, b1);
              c_mu0 = ds_da1 * 2.0f * mu1 + ds_db1 * 2.0f * mu0;
              c_mu1 = ds_da1 * 2.0f * mu0 + ds_db1 * 2.0f * mu1;
            }
            float c_var = ds_db2, c_cov = ds_da2 * 2.0f;
            qv[j] = s.scale * c_var * inv_n;
            qc[j] = s.scale * c_cov * inv_n;
            q0[j] = s.scale * (c_mu0 - 2.0f * mu0 * c_var - mu1 * c_cov) * inv_n;
            q1[j] = s.scale * (c_mu1 - 2.0f * mu1 * c_var - mu0 * c_cov) * inv_n;
            int a = (r + R) * AW + cx + R;  // the same pixel in the staged planes
            float d0y = sDc[a], d0x = sDc[NA + a], d1y = sDc[2 * NA + a], d1x = sDc[3 * NA + a];
            cy_[j] = (d0y * d0y + d1y * d1y) * ib2;
            cx_[j] = (d0x * d0x + d1x * d1x) * ib2;
          }
        }
      }
      if (WITH_GRAD) {
        const int o = r * SXP + c0;
        *reinterpret_cast<float4*>(sQ + o) = make_float4(q0[0], q0[1], q0[2], q0[3]);
        *reinterpret_cast<float4*>(sQ + NS + o) = make_float4(q1[0], q1[1], q1[2], q1[3]);
        *reinterpret_cast<float4*>(sQ + 2 * NS + o) = make_float4(qv[0], qv[1], qv[2], qv[3]);
        *reinterpret_cast<float4*>(sQ + 3 * NS + o) = make_float4(qc[0], qc[1], qc[2], qc[3]);
        float4 ky = *reinterpret_cast<float4*>(sCurv + o);
        float4 kx = *reinterpret_cast<float4*>(sCurv + NS + o);
        *reinterpret_cast<float4*>(sCurv + o) =
            make_float4(ky.x + cy_[0], ky.y + cy_[1], ky.z + cy_[2], ky.w + cy_[3]);
        *reinterpret_cast<float4*>(sCurv + NS + o) =
            make_float4(kx.x + cx_[0], kx.y + cx_[1], kx.z + cx_[2], kx.w + cx_[3]);
      }
    }
    __syncthreads();

    if (WITH_GRAD) {
      // 3a. vertical transposed window sums (into sV: the statistics are consumed)
      vertical_pass<R, G::SEG_Q, 4>(sQ, NS, SY, sV, TY * SXP, TY, SXP, taps, tid);
      __syncthreads();
      // 3b. horizontal sums at the owned pair; chain through dw0 / dw1
      float tq[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) pair_sums<R>(sV + q * TY * SXP + ly * SXP, lx0, taps, tq[0][q], tq[1][q]);
      const int a = (ly + HA) * AW + lx0 + HA;
      const float2 w0c = *reinterpret_cast<const float2*>(sA + a);
      const float2 w1c = *reinterpret_cast<const float2*>(sA + NA + a);
      const float2 d0y = *reinterpret_cast<const float2*>(sDc + a);
      const float2 d0x = *reinterpret_cast<const float2*>(sDc + NA + a);
      const float2 d1y = *reinterpret_cast<const float2*>(sDc + 2 * NA + a);
      const float2 d1x = *reinterpret_cast<const float2*>(sDc + 3 * NA + a);
      const float w0p[2] = {w0c.x, w0c.y}, w1p[2] = {w1c.x, w1c.y};
      const float d0yp[2] = {d0y.x, d0y.y}, d0xp[2] = {d0x.x, d0x.y};
      const float d1yp[2] = {d1y.x, d1y.y}, d1xp[2] = {d1x.x, d1x.y};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float g0 = tq[k][0] + 2.0f * w0p[k] * tq[k][2] + w1p[k] * tq[k][3];
        float g1 = tq[k][1] + 2.0f * w1p[k] * tq[k][2] + w0p[k] * tq[k][3];
        gs_y[k] += -g0 * d0yp[k] + g1 * d1yp[k];
        gs_x[k] += -g0 * d0xp[k] + g1 * d1xp[k];
      }
    }
  }
  __syncthreads();  // the last channel's stages are done with every staged tile

  // 4. the curvature's vertical window sums (zero outside the image), and the
  // v tile of the TPS stencils (zero outside the arrays)
  if (WITH_GRAD) vertical_pass<R, G::SEG_Q, 2>(sCurv, NS, SY, sV, TY * SXP, TY, SXP, taps, tid);
#pragma unroll
  for (int u = 0; u < NVJ; ++u) {
    int i = tid + u * NT;
    if (i < NV) {
      sVt[i] = vt_r[u][0];
      sVt[NV + i] = vt_r[u][1];
    }
  }
  __syncthreads();
  // TPS maps of both components on the tile and a ring of 1
  for (int i = tid; i < NM; i += NT) {
    int r = i / MX, cx = i % MX;
    int vi = (r + 1) * VX + cx + 1;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      tps_maps_at<VX>(sVt + k * NV + vi, y0 - 1 + r, x0 - 1 + cx, s, sM[(3 * k) * NM + i],
                      sM[(3 * k + 1) * NM + i], sM[(3 * k + 2) * NM + i]);
  }
  __syncthreads();

  float pc_y[2] = {0.f, 0.f}, pc_x[2] = {0.f, 0.f};
  if (WITH_GRAD) {
    // the curvature's horizontal window sums at the owned pair
    pair_sums<R>(sV + ly * SXP, lx0, taps, pc_y[0], pc_y[1]);
    pair_sums<R>(sV + TY * SXP + ly * SXP, lx0, taps, pc_x[0], pc_x[1]);
  }
  float e_tps = 0.f, e_ui = 0.f, e_tc = 0.f;
#pragma unroll
  for (int k = 0; k < NOWN; ++k) {
    const int lx = lx0 + k;
    const int oy = y0 + ly, ox = x0 + lx;
    if (oy >= own_end || ox >= w) continue;
    int qpix = (oy - s.own0) * w + ox;  // in the owned-row maps and outputs
    int m = (ly + 1) * MX + lx + 1;
    float gk[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float* Mxx = sM + (3 * kk) * NM;
      const float* Mxy = Mxx + NM;
      const float* Myy = Mxy + NM;
      float vxx = Mxx[m], vxy = Mxy[m], vyy = Myy[m];
      e_tps += vxx * vxx + 2.0f * vxy * vxy + vyy * vyy;
      float vk = sVt[kk * NV + (ly + 2) * VX + lx + 2];
      float dui = vk - uiv[k][kk];
      float dtc = vk - tcv[k][kk];
      e_ui += uw[k] * (dui * dui);
      e_tc += tw[k] * (dtc * dtc);
      if (WITH_GRAD) {
        // self-adjoint stencils of the three maps (descent.py tps_adj_*)
        float adj_xx = Mxx[m - 1] - 2.0f * vxx + Mxx[m + 1];
        float adj_yy = Myy[m - MX] - 2.0f * vyy + Myy[m + MX];
        float adj_xy = 0.25f * (Mxy[m - MX - 1] - Mxy[m - MX + 1] - Mxy[m + MX - 1] + Mxy[m + MX + 1]);
        float g_tps = 2.0f * adj_xx + 4.0f * adj_xy + 2.0f * adj_yy;
        float g_sim = kk == 0 ? gs_y[k] : gs_x[k];
        gk[kk] = g_sim + s.lam_n * g_tps + s.gui_n * uw[k] * dui + s.gtc_n * tw[k] * dtc;
      }
    }
    if (WITH_GRAD) {
      float p_rest = s.ptps + s.pquad_n * (s.gamma_ui * uw[k] + s.beta_tc * tw[k]);
      reinterpret_cast<float2*>(grad)[qpix] = make_float2(gk[0], gk[1]);
      reinterpret_cast<float2*>(precond)[qpix] =
          make_float2(s.psim_n * pc_y[k] + p_rest + s.eps_n, s.psim_n * pc_x[k] + p_rest + s.eps_n);
    }
  }

  // fixed-order tree over the block (in sV: its last readers are done)
  __syncthreads();
  float* const sred = sV;
  sred[tid] = e_sim;
  sred[NT + tid] = e_tps;
  sred[2 * NT + tid] = e_ui;
  sred[3 * NT + tid] = e_tc;
  __syncthreads();
  for (int stride = NT / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int q = 0; q < 4; ++q) sred[q * NT + tid] += sred[q * NT + tid + stride];
    }
    __syncthreads();
  }
  if (tid < 4) {
    int b = blockIdx.y * gridDim.x + blockIdx.x;
    partials[4 * b + tid] = sred[tid * NT];
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

dim3 tile_grid(int w, int nown) { return dim3((w + TX - 1) / TX, (nown + TY - 1) / TY); }

// Opt each instantiation in to its dynamic shared memory, once per device.
template <int R, bool WITH_GRAD>
cudaError_t allow_smem() {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(sweep_kernel<R, WITH_GRAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Geo<R, WITH_GRAD>::BYTES);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <int R, bool WITH_GRAD>
int launch(const float* planes, const float* v_lin, const float* v, const float* ui_w,
           const float* ui_v, const float* tc_w, const float* tc_v, float* grad,
           float* precond, float* partials, int n_partials, float* out, const VmSweepScalars& s,
           cudaStream_t stream) {
  dim3 grid = tile_grid(s.w, s.nown);
  if ((long long)grid.x * grid.y > n_partials) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<R, WITH_GRAD>();
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<R, WITH_GRAD><<<grid, NT, Geo<R, WITH_GRAD>::BYTES, stream>>>(
      planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, grad, precond, partials, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweep_reduce_kernel<<<1, RED, 0, stream>>>(partials, (int)(grid.x * grid.y), out, s);
  return (int)cudaGetLastError();
}

template <bool WITH_GRAD>
int dispatch(const float* planes, const float* v_lin, const float* v, const float* ui_w,
             const float* ui_v, const float* tc_w, const float* tc_v, float* grad,
             float* precond, float* partials, int n_partials, float* out,
             const VmSweepScalars* s, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (s->radius) {
    case 1:
      return launch<1, WITH_GRAD>(planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, grad, precond,
                                  partials, n_partials, out, *s, st);
    case 2:
      return launch<2, WITH_GRAD>(planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, grad, precond,
                                  partials, n_partials, out, *s, st);
    case 3:
      return launch<3, WITH_GRAD>(planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, grad, precond,
                                  partials, n_partials, out, *s, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The number of blocks, and so of (sim, tps, ui, tc) partial sets, of a
// launch over nown owned rows of width w.
extern "C" int vm_sweep_n_partials(int w, int nown) {
  dim3 grid = tile_grid(w, nown);
  return (int)(grid.x * grid.y);
}

// Dynamic shared memory of one block (bytes), 0 for a radius without an
// instantiation.
extern "C" int vm_sweep_smem_bytes(int radius, int with_grad) {
  switch (radius) {
    case 1: return (int)(with_grad ? Geo<1, true>::BYTES : Geo<1, false>::BYTES);
    case 2: return (int)(with_grad ? Geo<2, true>::BYTES : Geo<2, false>::BYTES);
    case 3: return (int)(with_grad ? Geo<3, true>::BYTES : Geo<3, false>::BYTES);
    default: return 0;
  }
}

// partials holds n_partials sets of 4 floats; a launch that needs more
// returns cudaErrorInvalidValue without running.
extern "C" int vm_sweep_grad(const float* planes, const float* v_lin, const float* v,
                             const float* ui_w, const float* ui_v, const float* tc_w,
                             const float* tc_v, float* grad, float* precond, float* partials,
                             int n_partials, float* out, const VmSweepScalars* s, void* stream) {
  return dispatch<true>(planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, grad, precond, partials,
                        n_partials, out, s, stream);
}

extern "C" int vm_sweep_energy(const float* planes, const float* v_lin, const float* v,
                               const float* ui_w, const float* ui_v, const float* tc_w,
                               const float* tc_v, float* partials, int n_partials, float* out,
                               const VmSweepScalars* s, void* stream) {
  return dispatch<false>(planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, nullptr, nullptr, partials,
                         n_partials, out, s, stream);
}
