// The solver's sweep for Hopper (sm_90a): energy, gradient and
// preconditioner of the halfway-domain energy on linearized warps.
//
// Replaces the Pallas builders videomorphing_tpu/pallas/sweep.py:293
// (_build_grad_call, kernel 1: sweep_grad_kernel<R>,
// sweep_grad_strip_kernel<R> and sweep_wide_kernel<true>) and :502
// (_build_energy_call, kernel 2: sweep_energy_kernel<R>,
// sweep_energy_strip_kernel<R> and sweep_wide_kernel<false>). The kernels
// have their own designs but share
// the per-pixel arithmetic of the energy (ssim_pixel, ssim_coeffs,
// tps_maps_at, tps_energy, quad_terms) and the order of every
// window sum, so the energy the line search sees and the energy of the
// gradient pass cannot drift apart.
//
// Kernel 1 (Pallas: _build_grad_call, pallas/sweep.py:293, and its row
// shards, fused_grad_parts_shard, :936): what bounds it on the H100.
// Counting each input read once and each output written once, it moves at
// 1024^2, C = 3 134 MB (40 us at 3.35 TB/s) and does ~650 operations per
// pixel at window 5 (10 us at 67 TFLOP/s): bytes, on paper, at every
// window up to 15. In practice it is bound by instructions and their
// latency: per channel every pixel and its halo go through 5 K-tap window
// sums in two passes, the SSIM coefficient maps (divisions) and 4
// transposed sums in two passes, each stage behind a barrier. Two designs,
// by window radius R:
//
// sweep_grad_kernel<R>, R = 1, 2 (windows 3, 5; the default): a tile of
// TILE_ROWS x TILE_COLS owned pixels, 256 threads, with its halo of 2R
// staged in shared memory (90 KB at R = 2, two blocks an SM):
//   0. once per tile: dv = v - v_lin at the warp halo 2R; the row and
//      column tap-sum tables of the in-image window and from them 1/n at
//      the statistics halo R; and, into registers, the v tile of the TPS
//      stencils and the UI/TC maps of the thread's owned pair;
//   1. per channel, the six planes (w0, w1, dw0, dw1) of the tile and its
//      halo arrive by cp.async, zero-filled (src-size 0) outside the image,
//      the next channel's in flight during this one's window sums;
//   2. window statistics at halo R (vertical pass by column segments with
//      their window in registers, seg_rows(); horizontal from float4
//      windows), the SSIM map and its coefficient maps (the gradient's
//      reciprocals by __fdividef; the energy's SSIM keeps its IEEE
//      division);
//   3. the transposed window sums down to the owned pixels, chained
//      through dw0/dw1;
//   4. after the channels: the curvature's window sum, and the TPS maps
//      once on a tile of v in shared memory for the adjoint stencil.
// Its staged halo grows with R: 1.9x the owned pixels at R = 2, 3.9x at
// R = 5, and past R = 2 only one block fits an SM.
//
// sweep_grad_strip_kernel<R>, R = STRIP_MIN_RADIUS .. STRIP_MAX_RADIUS
// (windows 7-15): a block owns STRIP_ROWS x STRIP_COLS pixels and, per
// channel, walks down them STEP_ROWS rows a step, so the vertical halo of
// 4R rows is staged once per strip and channel rather than once per tile
// (1.7x the owned pixels at R = 5):
//   - a step's rows of the six planes and of v, v_lin arrive by cp.async,
//     zero-filled outside the image, one step ahead, in chunks of 4
//     columns, one a thread: 16-byte copies where the width is a multiple
//     of 4 and the pointers are aligned (the staged columns start at a
//     multiple of 4), else 4-byte ones. A thread forms a0, a1 of its own
//     chunk only and issues its next chunk at once, so no barrier waits
//     for the copies;
//   - a0, a1 go into a ring of STEP_ROWS + 2R rows; the vertical window
//     sums of the statistics R rows up come from it, then the horizontal
//     ones, the SSIM and its coefficient maps, and the curvature terms,
//     into a second ring of STEP_ROWS + 2R rows;
//   - the transposed sums 2R rows up come from that ring, then the chain
//     through dw (loaded while the window sums run); the SSIM gradient and
//     the curvature's window sums of the earlier channels wait in grad and
//     precond, read back by the thread that wrote them;
//   - the last channel adds the TPS maps (a tile of v in shared memory),
//     the UI and TC terms and writes the outputs.
// Shared memory does not grow with C and grows with R only through the
// rings and halo columns (80 KB at R = 3, 110 KB at R = 7): two blocks (16
// warps) an SM from R = 3 to 7. The curvature is summed over the channels
// after its window sums here (before them in the tile), channels in order.
//
// Kernel 2 needs neither the statistics halo nor dw after forming a0 and
// a1, and runs once per Armijo trial, so it has a design of its own. Its
// bound is the same kind (bytes on paper; 117 MB at 1024^2, C = 3), and
// what held kernel 1's staging back there was the memory path: per channel
// ten staged planes, four barrier-separated stages and 24 warps an SM. A
// warp walks a column strip, lane l holding column x0 - H + l (H halo
// lanes each side of the owned ones), so each row's loads are coalesced,
// at any width and origin:
//   - the planes arrive by 4-byte cp.async into a per-warp ring of EDEPTH
//     rows in shared memory, EDEPTH - 1 rows ahead of the row in use and
//     across the channel boundary, so loads stay in flight while the window
//     sums run; dv = v - v_lin is staged once per strip, so a channel's walk
//     loads only its six planes;
//   - per channel and row, a0 and a1 go into a register ring of K rows;
//     the vertical window sums come from the ring, the horizontal ones from
//     the neighbouring lanes by shuffles, then the SSIM of the owned lanes;
//   - TPS, UI and TC after the channels: v in a register ring of 3 rows,
//     the neighbouring columns by shuffles (the v tile's ring of 1);
//   - partials reduce by a shuffle tree per warp and the warps in order.
// No barrier in the channel loop. Two designs, by window radius R:
//
// sweep_energy_kernel<R>, R = 1 .. 3 (windows 3-7; the default): blocks of
// ENERGY_TILE_ROWS x ENERGY_TILE_COLS owned pixels, 8 warps, each walking
// ESEG = 4 owned rows plus 2R with H = 3; dv and 1/n per warp in shared
// memory that only the lane itself reads back; registers capped at 64 for
// 4 blocks (32 warps) an SM.
//
// sweep_energy_strip_kernel<R>, R = ENERGY_STRIP_MIN_RADIUS ..
// ENERGY_STRIP_MAX_RADIUS (windows 9-15): with 4-row walks, the halo rows'
// copies and a0, a1 were 3.0-4.5x the owned rows' at these R, and knocking
// them out took 21-31 % off (scripts/time_torch_energy_stages.py), the
// shuffles only 8-13 %. So a warp walks ENERGY_STRIP_ROWS = 16 owned rows
// plus 2R (1.5-1.9x) with H = R (32 - 2R owned lanes), and
// ENERGY_STRIP_WARPS = 4 warps sit side by side in a block:
//   - dv for the block's walk rows and columns is staged once by all its
//     threads, behind one barrier (the strip's only other barrier is the
//     reduction's); 1/n of an owned pixel is formed where it is used, from
//     the row's tap sum in shared memory and the column's in a register;
//   - the taps are symmetric (the wrapper checks it), so R + 1 registers
//     hold all K, and the walk is unrolled by K rows (compile-time ring
//     slots) inside a loop, to bound the code;
//   - 32 KB of shared memory a block: six blocks (24 warps) an SM at R = 4,
//     5 within 80 registers, four at R = 6, 7.
//
// cp.async rather than TMA: a TMA tile needs a 16-byte-aligned row stride,
// W % 4 == 0, and the pyramid's levels break that (a 135 x 241 level, 4K
// level widths such as 30); 4-byte cp.async takes any width and any origin
// (the strip kernel takes 16-byte copies on the widths that allow them).
// No tensor cores: the window sums are 3- to 13-tap float32 stencils, and
// TF32 products would break the 1e-5 gate against the plain version.
//
// Every per-pixel sum keeps its order (taps t = 0..K-1, the vertical pass
// before the horizontal one, channels in order), and no value depends on
// where a tile or strip starts, so a row shard's outputs equal the whole
// frame's rows bit for bit. Energy partials reduce per block in a fixed order and then across
// blocks in a fixed order by sweep_reduce_kernel: no float atomics, so
// reruns are bitwise identical.
//
// Row-shard form (Pallas: the same builders driven by
// fused_grad_parts_shard, sweep.py:936, and fused_energy_parts_shard, :959):
// the arrays hold a block of rows extended by real neighbour rows, its owned
// rows are [own0, own0 + nown), and row0 / gh place it in the global frame.
// Every in-image test, 1/n and the TPS stencil validity use global rows;
// outputs and energy partials cover the owned rows only, so the caller sums
// the raw partials over the blocks and normalizes by the global pixel count.
// The whole frame is the form with one block: row0 = own0 = 0, gh = nown = h.
//
// Window radius. The window has 2R + 1 taps (ssim_window = 2R + 1, any
// odd size, as the reference takes it); the taps sit in a small device
// buffer that VmSweepScalars points at. dispatch() chooses by R
// (tiled(), wide_strip()):
//   - kernel 1: the tile for R = 0, 1, 2, the strip for R =
//     STRIP_MIN_RADIUS .. STRIP_MAX_RADIUS; kernel 2: the tile for R = 0
//     .. 3, the strip for R = ENERGY_STRIP_MIN_RADIUS ..
//     ENERGY_STRIP_MAX_RADIUS; each instantiated per R. At R = 0 (window
//     1) the window is the pixel itself, and the tiles take it as they
//     take R = 1, 2.
//   - R = 8 .. WIDE_MAX_RADIUS (windows 17-49), both kernels: the wide
//     strip, sweep_wide_kernel, one compiled kernel per form and plane
//     type that reads R at run time. At R = 8 kernel 1's instantiated
//     strip would need 122 KB, one block an SM; the wide strip's columns
//     are narrower (WIDE_STRIP_COLS = 32) and its geometry (wide_geo) is
//     computed from R on the host and in the block: 71 KB for kernel 1 at
//     R = 8, two blocks an SM at its 128 registers (three by shared
//     memory), two up to R = 12, one from R = 14 to its reach at R = 24
//     (222 KB); kernel 2's form 32-73 KB, four blocks an SM at R = 8-16
//     and three past.
//     It walks a column strip as sweep_grad_strip_kernel does (cp.async
//     of a step's planes one step ahead, a0/a1 and coefficient-map rings),
//     with the taps between zeros in shared memory so that a window pass
//     needs no test on the tap index. One launch and the reduce; no
//     scratch buffer. Replacing the per-pixel chain took kernel 1 from
//     0.64 to 0.46 ms and kernel 2 from 0.32 to 0.16 ms at window 17,
//     1024^2 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//   - past WIDE_MAX_RADIUS: the per-pixel chain, kernels that read the
//     radius at run time
//     and keep their intermediates (a0 and a1, the vertical window sums,
//     the SSIM coefficient maps, the curvature, the per-pixel SSIM energy
//     and gradient) in a scratch buffer in device memory that the wrapper
//     allocates (vm_sweep_scratch_floats). Per channel: the linearized
//     warps on the rows within 2R of the owned ones, the vertical window
//     sums of the five statistics within R, the horizontal sums with the
//     SSIM map and its coefficient maps, the transposed sums and the chain
//     through dw; then one kernel per tile of CHAIN_TILE_ROWS x
//     CHAIN_TILE_COLS owned pixels for the TPS, UI and TC terms, the
//     preconditioner and the tile's energy partials. Every sum keeps the
//     order of the instantiated kernels per pixel (taps t = 0..K-1,
//     vertical before horizontal), and no value depends on where a block
//     starts, so its row shards equal the whole frame's rows bit for bit
//     too. Each tap of each window sum is a load through the caches rather
//     than from shared memory: a simple path for windows past 49.
//
// The bf16 form (MorphParams.pack_dtype = "bfloat16"; the reference's bf16
// pack, pallas/sweep.py:86-107, whose kernels upcast every read of the
// pack and compute in float32, :345-360): every kernel above is
// instantiated for the type PT of the plane stack and the four UI/TC maps,
// float or __nv_bfloat16, and the entry points vm_sweep_grad_bf16 and
// vm_sweep_energy_bf16 launch the bf16 instantiations. Each value of the
// planes and maps is upcast by __bfloat162float as it is read (ld, ldg);
// v and v_lin stay float32, and so does all arithmetic, but 1/n, which the
// reference stores in its pack too, is rounded to bf16 by
// __float2bfloat16_rn before use (pack_round). At C = 3 a pixel's planes
// and maps are 36 + 12 bytes where float32 has 72 + 24.
//
// The bf16 planes arrive by cp.async like the float ones, into the same
// 4-byte slots of the same shared-memory layout, with the same zero-fill,
// commit and wait points, so their loads stay in flight while the window
// sums run. cp.async copies 4, 8 or 16 aligned bytes, so a slot receives
// the aligned 4-byte word that holds its element (bf16_word; the energy
// tile's warp masks the element's index instead, for its registers):
// element idx of the stack, counted from its base, lies in the word of elements
// idx & ~1 and idx | 1, in its high half where idx is odd. The reader of a
// slot takes that half and widens it (slot_value; a bf16 is the high half
// of a float32, so the widening is exact); the parity comes from the flat
// index plane * hw + p, never from the column, since an odd h * w or w
// alternates it between planes and rows. Two neighbouring lanes fetch one
// sector, so the device-memory bytes still halve. The wrapper requires a
// 4-byte-aligned stack; it holds 6C planes, an even count of elements, so
// every word lies inside it. The strip copies a chunk of 4 elements as one
// 8-byte word pair where the width is a multiple of 4 (then each chunk
// starts at a multiple of 4 elements) and the stack 8-byte aligned, into
// the chunk's first two slots. The UI/TC maps are read once per owned
// pixel, outside the channel loop, by 2-byte loads (ld). Shared memory, the
// tiles and the order of every sum are those of the float instantiations,
// so the bf16 form's row shards equal its whole frame's rows bit for bit
// too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

extern "C" {
// Mirrored by ctypes in kernels/sweep.py (same field order).
struct VmSweepScalars {
  const float* taps;  // the window's 2 radius + 1 taps, in device memory
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

// The output tiles: rows x columns of owned pixels per block of each
// kernel. kernels/sweep.py reads these lines (sweep_tile(with_grad)) to
// size the energy partials, one set of four per block, and
// vm_sweep_n_partials gives the same count here.
constexpr int TILE_ROWS = 16;
constexpr int TILE_COLS = 32;
// The energy kernel's output tile (sweep_energy_kernel, R = 1 .. 3):
// ENERGY_TILE_ROWS rows split among its warps, ENERGY_TILE_COLS owned
// columns of each warp's 32 lanes; the lanes left over hold the window's
// halo columns.
constexpr int ENERGY_TILE_ROWS = 32;
constexpr int ENERGY_TILE_COLS = 26;
constexpr int EDEPTH = 4;  // rows of the planes in flight per warp, the current one included
// The energy kernel's strip from ENERGY_STRIP_MIN_RADIUS to
// ENERGY_STRIP_MAX_RADIUS (sweep_energy_strip_kernel): ENERGY_STRIP_WARPS
// warps side by side, each owning 32 - 2R columns (its lanes less the
// window's halo R each side) of the block's ENERGY_STRIP_ROWS rows, which it
// walks down once per channel.
constexpr int ENERGY_STRIP_ROWS = 16;
constexpr int ENERGY_STRIP_WARPS = 4;
constexpr int ENERGY_STRIP_MIN_RADIUS = 4;
constexpr int ENERGY_STRIP_MAX_RADIUS = 7;
// The wide strip (sweep_wide_kernel) takes R = 8 .. WIDE_MAX_RADIUS, the
// radius read at run time: a block owns WIDE_STRIP_ROWS (the energy form
// WIDE_ENERGY_STRIP_ROWS) x WIDE_STRIP_COLS pixels and walks down them
// WIDE_STEP_ROWS rows a step. WIDE_MAX_RADIUS is the largest R whose
// block fits an SM (wide_fits).
constexpr int WIDE_STRIP_ROWS = 128;
constexpr int WIDE_ENERGY_STRIP_ROWS = 64;
constexpr int WIDE_STRIP_COLS = 32;
constexpr int WIDE_STEP_ROWS = 8;
constexpr int WIDE_MAX_RADIUS = 24;
// The per-pixel chain takes the radii past WIDE_MAX_RADIUS, with one
// partials set per CHAIN_TILE_ROWS x CHAIN_TILE_COLS owned pixels.
constexpr int CHAIN_TILE_ROWS = 8;
constexpr int CHAIN_TILE_COLS = 32;
// The gradient kernel from STRIP_MIN_RADIUS to STRIP_MAX_RADIUS
// (sweep_grad_strip_kernel): a block owns STRIP_ROWS x STRIP_COLS pixels
// and walks down them STEP_ROWS rows at a time; R = 1, 2 keep the tile of
// TILE_ROWS x TILE_COLS (sweep_grad_kernel).
constexpr int STRIP_ROWS = 72;
constexpr int STRIP_COLS = 64;
constexpr int STEP_ROWS = 8;
constexpr int STRIP_MIN_RADIUS = 3;
constexpr int STRIP_MAX_RADIUS = 7;

constexpr int TY = TILE_ROWS, TX = TILE_COLS;
constexpr int NT = 256;              // threads per block
constexpr int NOWN = TY * TX / NT;   // owned outputs per thread: a pair of neighbours in a row
static_assert(NOWN == 2 && (TX / 2) * TY == NT, "each thread owns two neighbouring pixels");

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr int ENT = 256;                               // threads per energy block
constexpr int EWARPS = ENT / 32;
constexpr int ESEG = ENERGY_TILE_ROWS / EWARPS;        // owned rows per warp
static_assert(ESEG * EWARPS == ENERGY_TILE_ROWS, "the warps split the tile's rows evenly");
static_assert(ENERGY_STRIP_MIN_RADIUS == 4 && (32 - ENERGY_TILE_COLS) / 2 == ENERGY_STRIP_MIN_RADIUS - 1,
              "a tile warp's halo lanes hold the window's halo up to R = 3; the strip takes the rest");

// The energy kernel's shared memory (floats) per warp: dv (2 NU rows), 1/n
// (ESEG rows) and the planes' ring (EDEPTH rows of 6 planes), 32 lanes each.
template <int R>
struct EGeo {
  static_assert(R >= 0 && R < ENERGY_STRIP_MIN_RADIUS, "the tile's radii");
  static constexpr int EH = (32 - ENERGY_TILE_COLS) / 2;  // lanes left of the owned columns
  static constexpr int COLS = ENERGY_TILE_COLS;           // owned columns of a warp
  static constexpr int NU = ESEG + 2 * R;  // rows a warp walks per channel
  static_assert(NU <= 32 && EDEPTH >= 2 && EDEPTH - 1 <= NU && (EDEPTH & (EDEPTH - 1)) == 0,
                "walk rows and a power-of-two ring depth");
  static constexpr int WARP_FLOATS = 32 * (2 * NU + ESEG + 6 * EDEPTH);
  static constexpr size_t BYTES = sizeof(float) * EWARPS * WARP_FLOATS;
};

// The energy strip's geometry and shared memory (floats) per block: the
// warps' rings of EDEPTH rows of 6 planes (32 lanes each), then dv (y, x) at
// the NU rows every warp walks and the TW columns of the block with their
// halo, then the tap sums of the ENERGY_STRIP_ROWS owned rows. A lane holds
// column x0 - R + l of its warp's strip, x0 = the warp's first owned column.
template <int R>
struct ESGeo {
  static_assert(R >= ENERGY_STRIP_MIN_RADIUS && R <= ENERGY_STRIP_MAX_RADIUS, "the strip's radii");
  static constexpr int K = 2 * R + 1;
  static constexpr int S = ENERGY_STRIP_ROWS;   // owned rows
  static constexpr int NU = S + 2 * R;           // rows a warp walks per channel
  static constexpr int COLS = 32 - 2 * R;        // owned columns of a warp: lanes R .. 31 - R
  static constexpr int THREADS = 32 * ENERGY_STRIP_WARPS;
  static constexpr int TW = ENERGY_STRIP_WARPS * COLS + 2 * R;  // dv columns of the block
  static constexpr int RING_FLOATS = ENERGY_STRIP_WARPS * EDEPTH * 6 * 32;
  static constexpr int DV_FLOATS = 2 * NU * TW;
  static constexpr int FLOATS = RING_FLOATS + DV_FLOATS + S;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
  static_assert(NU <= 32, "walk rows fit a 32-bit mask");
  // six blocks (24 warps) an SM: 228 KB less 1 KB reserved per block
  static_assert(6 * (BYTES + 1024) <= 228 * 1024, "six strip blocks share an SM");
};

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

// Tile geometry and shared-memory layout (in floats) of one instantiation
// of the gradient kernel. Row strides are multiples of 4 floats so the
// horizontal passes load float4 / float2 windows; the extra columns are
// real image columns (or zeros) that feed only outputs outside the tile.
template <int R>
struct Geo {
  static constexpr int K = 2 * R + 1;
  static constexpr int HS = R;                  // halo of the window statistics
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
  static constexpr int Q_SIZE = 4 * NS;  // transposed-sum inputs
  static constexpr int CURV_SIZE = 2 * NS;
  static constexpr int FLOATS = P_SIZE + A_SIZE + V_SIZE + Q_SIZE + CURV_SIZE + NS + round4(SY) + SXP;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

// Geometry and shared-memory layout (in floats) of one instantiation of
// the strip kernel. Columns: the linearized warps' rows start at x0 - 2R
// (AWP columns), the statistics' and coefficient maps' at x0 - R (SWP
// columns), both strides multiples of 4 for the float4 / float2 windows.
// Rows: the walk's row u is the block's arrays' row y0 - 2R + u; a step
// stages the six planes and v, v_lin of STEP_ROWS rows, whose a0, a1 go
// into a ring of DR rows, and the coefficient maps of the rows R above
// them into a second ring of DR rows.
template <int R>
struct SGeo {
  static constexpr int K = 2 * R + 1;
  static constexpr int RB = STEP_ROWS;
  static constexpr int SW = STRIP_COLS + 2 * R, SWP = round4(SW);  // statistics columns
  static constexpr int AWP = round4(SWP + 2 * R);                   // warp columns
  static constexpr int DR = RB + 2 * R;                             // ring rows
  // the staged columns start at x0 - AO, a multiple of 4, so that a chunk
  // of 4 columns is one 16-byte copy where the width allows; the ring's
  // column j is staged column j + AO - 2R
  static constexpr int AO = round4(2 * R);
  static constexpr int SAW = round4(AWP + AO - 2 * R);  // staged columns
  static constexpr int NST = RB * SAW;                  // staged pixels of a step
  static constexpr int NCH = NST / 4;                   // chunks of a step, one per thread
  static_assert(NCH <= NT, "a thread stages at most one chunk of a step");
  static constexpr int NQ = 6;  // coefficient maps: q0, q1, qv, qc and the curvature's cy, cx
  static constexpr int SEG_A = seg_rows(RB, AWP, R);  // rows per item, statistics' vertical pass
  static constexpr int SEG_Q = seg_rows(RB, SWP, R);  // rows per item, transposed vertical pass
  static constexpr int NF = (4 + 2 * R + 3) / 4;      // float4s of a 4-output horizontal window
  static constexpr int VY = RB + 4, VX = STRIP_COLS + 4, NV = VY * VX;  // v for the TPS maps
  static constexpr int MY = RB + 2, MX = STRIP_COLS + 2, NM = MY * MX;  // TPS maps
  static constexpr int STAGE_SIZE = 10 * NST;  // w0, w1, dw0 y, x, dw1 y, x; v and v_lin, (y, x) pairs
  static constexpr int A_SIZE = 2 * DR * AWP;       // a0, a1 ring
  static constexpr int Q_SIZE = NQ * DR * SWP;      // coefficient ring
  // per step: the statistics' vertical sums (5 planes), then the transposed
  // vertical sums (NQ planes), then (last channel) the v tile and TPS maps;
  // at the end the block reduction
  static constexpr int X_SIZE = round4(cmax(cmax(5 * RB * AWP, NQ * RB * SWP), cmax(2 * NV + 6 * NM, 4 * NT)));
  static constexpr int NY_SIZE = round4(STRIP_ROWS + 2 * R);  // row tap sums of the statistics rows
  static constexpr int FLOATS = STAGE_SIZE + A_SIZE + Q_SIZE + X_SIZE + NY_SIZE + SWP;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
  static_assert((STRIP_COLS / 2) * RB == NT, "each thread owns two neighbouring pixels of a step");
  // two blocks an SM: 228 KB less 1 KB reserved per block
  static_assert(2 * (BYTES + 1024) <= 228 * 1024, "two strip blocks share an SM");
};

// Geometry and shared-memory layout (in floats) of the wide strip at radius
// R, for the gradient or the energy. The gradient needs the statistics at
// a halo HS = R around the owned pixels and so the linearized warps at HA
// = 2R; the energy needs the statistics at the owned pixels only (HS = 0,
// HA = R). Columns: the warps' ring starts at x0 - HA (AWP columns), the
// statistics' and coefficient maps' at x0 - HS (SWP columns); rows: walk
// row u is the arrays' row y0 - HA + u, a step stages WIDE_STEP_ROWS of
// them (the six planes, v and v_lin, from column x0 - AO, a multiple of 4)
// and their a0, a1 go into a ring of DR rows, the coefficient maps of the
// rows R above into a second ring of DR rows (gradient only).
constexpr int WIDE_TPAD = 4;  // zero taps each side of the window's K in shared memory
struct WGeo {
  int K, HS, HA, SW, SWP, AWP, AO, SAW, NST, NCH, DR, NQ;
  int tz, ny, nx, stage, a, q, x, floats;  // offsets of the regions, and the total
};
__host__ __device__ constexpr WGeo wide_geo(int R, bool with_grad) {
  constexpr int SC = WIDE_STRIP_COLS, RB = WIDE_STEP_ROWS;
  constexpr int NV = (RB + 4) * (SC + 4), NM = (RB + 2) * (SC + 2);  // the last stage's v tile and TPS maps
  WGeo g{};
  g.K = 2 * R + 1;
  g.HS = with_grad ? R : 0;
  g.HA = g.HS + R;
  g.SW = SC + 2 * g.HS;
  g.SWP = round4(g.SW);
  g.AWP = round4(g.SWP + 2 * R);  // a horizontal window of the last statistics column stays in the row
  g.AO = round4(g.HA);
  g.SAW = round4(g.AWP + g.AO - g.HA);
  g.NST = RB * g.SAW;
  g.NCH = g.NST / 4;
  g.DR = RB + 2 * R;
  g.NQ = with_grad ? 6 : 0;  // q0, q1, qv, qc and the curvature's cy, cx
  g.tz = 0;
  g.ny = g.tz + round4(g.K + 2 * WIDE_TPAD);
  g.nx = g.ny + round4((with_grad ? WIDE_STRIP_ROWS : WIDE_ENERGY_STRIP_ROWS) + 2 * g.HS);
  g.stage = g.nx + g.SWP;
  g.a = g.stage + 10 * g.NST;  // w0, w1, dw0 y, x, dw1 y, x; v and v_lin, (y, x) pairs
  g.q = g.a + 2 * g.DR * g.AWP;
  g.x = g.q + g.NQ * g.DR * g.SWP;
  // a step's vertical sums (5 statistics, or NQ transposed), the last
  // stage's v tile (and TPS maps), the block reduction
  const int xs = cmax(cmax(5 * RB * g.AWP, g.NQ * RB * g.SWP), cmax(2 * NV + (with_grad ? 6 * NM : 0), 4 * NT));
  g.floats = g.x + round4(xs);
  return g;
}
// whether the wide strip's block at radius R fits an SM (227 KB of shared
// memory a block)
__host__ __device__ constexpr bool wide_fits(int R, bool with_grad) {
  return sizeof(float) * (size_t)wide_geo(R, with_grad).floats <= 232448;
}
static_assert(wide_fits(WIDE_MAX_RADIUS, true) && !wide_fits(WIDE_MAX_RADIUS + 1, true) &&
                  wide_fits(WIDE_MAX_RADIUS, false),
              "WIDE_MAX_RADIUS is the largest radius whose gradient block fits");
static_assert(WIDE_STRIP_COLS * WIDE_STEP_ROWS == NT && WIDE_STEP_ROWS % 2 == 0 && WIDE_STRIP_COLS % 4 == 0,
              "a thread owns one pixel of a step; a step moves an even count of rows");
// two gradient blocks an SM at R = 8: 228 KB less 1 KB reserved per block
static_assert(2 * (sizeof(float) * wide_geo(8, true).floats + 1024) <= 228 * 1024, "two wide blocks share an SM");

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

// 8-byte asynchronous copy global -> shared (both 8-byte aligned); zero-fills when !in
__device__ __forceinline__ void cp_async8(float* dst, const void* src, bool in) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 8 : 0)
               : "memory");
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned); zero-fills when !in
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// A value of the planes or the UI/TC maps, upcast to float32 as it is read
// (ldg through the read-only path).
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

// 1/n as the pack of plane type PT holds it: rounded to bf16 in the bf16 form.
template <class PT>
__device__ __forceinline__ float pack_round(float x) {
  if constexpr (std::is_same_v<PT, float>) return x;
  else return __bfloat162float(__float2bfloat16_rn(x));
}

// The aligned 4-byte word that holds the bf16 element at address e of an
// array that starts on a 4-byte boundary: element idx lies in the word of
// elements idx & ~1 (low half) and idx | 1 (high half). Dropping bit 1 of
// the byte address leaves the element's own address arithmetic, the float
// form's.
__device__ __forceinline__ const float* bf16_word(const __nv_bfloat16* e) {
  return reinterpret_cast<const float*>(reinterpret_cast<size_t>(e) & ~(size_t)3);
}

// The __byte_perm selectors that widen a word's low half (an even
// element) or its high half (an odd one) into a float32: the half in the
// high bytes, zeros below. SEL_FLIP turns either into the other, so a
// reader keeps one selector per parity and flips it where a plane's
// offset or a neighbour's column is odd.
constexpr unsigned SEL_LO = 0x1044u, SEL_HI = 0x3244u, SEL_FLIP = SEL_LO ^ SEL_HI;
__device__ __forceinline__ unsigned half_sel(unsigned odd) { return odd ? SEL_HI : SEL_LO; }

// A staged slot of plane type PT as float32: the float itself, or the half
// of a bf16 word that selector `sel` (half_sel of the element's index & 1)
// takes, widened.
template <class PT>
__device__ __forceinline__ float slot_value(float slot, unsigned sel) {
  if constexpr (std::is_same_v<PT, float>) return slot;
  else return __uint_as_float(__byte_perm(__float_as_uint(slot), 0u, sel));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// waits until at most the N most recent committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// ---------------------------------------------------------------------------
// Per-pixel arithmetic of the energy, shared by both kernels so that the
// line search's energy and the gradient pass's cannot drift apart.
// ---------------------------------------------------------------------------

// Second-difference maps of one field component at (y, x), zero where the
// stencil leaves the global image (solver/energy.py tps_maps); vt(dy, dx)
// reads the component at (y + dy, x + dx), dy, dx in {-1, 0, 1}.
template <class VT>
__device__ __forceinline__ void tps_maps_at(const VT& vt, int y, int x, const VmSweepScalars& s,
                                            float& vxx, float& vxy, float& vyy) {
  vxx = vxy = vyy = 0.0f;
  if (!row_in(s, y) || x < 0 || x >= s.w) return;
  float c = vt(0, 0);
  int g = y + s.row0;
  bool inx = x >= 1 && x <= s.w - 2;
  bool iny = g >= 1 && g <= s.gh - 2;
  if (inx) vxx = vt(0, 1) - 2.0f * c + vt(0, -1);
  if (iny) vyy = vt(1, 0) - 2.0f * c + vt(-1, 0);
  if (inx && iny) vxy = 0.25f * (vt(1, 1) - vt(1, -1) - vt(-1, 1) + vt(-1, -1));
}

// E_TPS at one pixel and component from its three maps.
__device__ __forceinline__ float tps_energy(float vxx, float vxy, float vyy) {
  return vxx * vxx + 2.0f * vxy * vxy + vyy * vyy;
}

// The UI and TC terms of one pixel and component: adds w |v - target|^2 to
// each energy and returns the two differences the gradient needs.
struct QuadDiff {
  float ui, tc;
};
__device__ __forceinline__ QuadDiff quad_terms(float vk, float ui_t, float tc_t, float uw, float tw,
                                               float& e_ui, float& e_tc) {
  QuadDiff d{vk - ui_t, vk - tc_t};
  e_ui += uw * (d.ui * d.ui);
  e_tc += tw * (d.tc * d.tc);
  return d;
}

// The SSIM of one pixel and channel from the five window sums of a0, a1,
// a0^2, a1^2 and a0 a1 (vertical pass, then horizontal, taps in order) and
// 1/n; IEEE division, as the plain version's.
struct SsimPixel {
  float mu0, mu1, a1, a2, b1, b2, denom, ssim;
};
__device__ __forceinline__ SsimPixel ssim_pixel(const float st[5], float inv_n,
                                                const VmSweepScalars& s) {
  SsimPixel o;
  o.mu0 = st[0] * inv_n;
  o.mu1 = st[1] * inv_n;
  float var0 = fmaxf(st[2] * inv_n - o.mu0 * o.mu0, 0.0f);
  float var1 = fmaxf(st[3] * inv_n - o.mu1 * o.mu1, 0.0f);
  float cov = st[4] * inv_n - o.mu0 * o.mu1;
  o.a2 = 2.0f * cov + s.c2;
  o.b2 = var0 + var1 + s.c2;
  o.a1 = 1.0f;
  o.b1 = 1.0f;
  if (s.use_luminance) {
    o.a1 = 2.0f * o.mu0 * o.mu1 + s.c1;
    o.b1 = o.mu0 * o.mu0 + o.mu1 * o.mu1 + s.c1;
  }
  o.denom = o.b1 * o.b2;
  o.ssim = (o.a1 * o.a2) / o.denom;
  return o;
}

// The SSIM gradient's coefficient maps of one pixel and channel, the
// inputs of the transposed window sums (d mean(1 - s) / d statistic times
// 1/n), and 1 / b2 for the curvature; the reciprocals by __fdividef.
struct SsimCoeffs {
  float q0, q1, qv, qc, ib2;
};
__device__ __forceinline__ SsimCoeffs ssim_coeffs(const SsimPixel& sp, float inv_n,
                                                  const VmSweepScalars& s) {
  const float mu0 = sp.mu0, mu1 = sp.mu1, ssim = sp.ssim;
  float rden = __fdividef(1.0f, sp.denom), ib2 = __fdividef(1.0f, sp.b2);
  float ds_da2 = sp.a1 * rden;
  float ds_db2 = -ssim * ib2;
  float c_mu0 = 0.f, c_mu1 = 0.f;
  if (s.use_luminance) {
    float ds_da1 = sp.a2 * rden;
    float ds_db1 = -ssim * __fdividef(1.0f, sp.b1);
    c_mu0 = ds_da1 * 2.0f * mu1 + ds_db1 * 2.0f * mu0;
    c_mu1 = ds_da1 * 2.0f * mu0 + ds_db1 * 2.0f * mu1;
  }
  float c_var = ds_db2, c_cov = ds_da2 * 2.0f;
  SsimCoeffs k;
  k.qv = s.scale * c_var * inv_n;
  k.qc = s.scale * c_cov * inv_n;
  k.q0 = s.scale * (c_mu0 - 2.0f * mu0 * c_var - mu1 * c_cov) * inv_n;
  k.q1 = s.scale * (c_mu1 - 2.0f * mu1 * c_var - mu0 * c_cov) * inv_n;
  k.ib2 = ib2;
  return k;
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

// Kernel 1: energy partials, gradient and preconditioner of one tile.
template <int R, class PT>
__global__ void __launch_bounds__(NT, 2)
sweep_grad_kernel(const PT* __restrict__ planes, const float* __restrict__ v_lin,
                  const float* __restrict__ v, const PT* __restrict__ ui_w,
                  const PT* __restrict__ ui_v, const PT* __restrict__ tc_w,
                  const PT* __restrict__ tc_v, float* __restrict__ grad,
                  float* __restrict__ precond, float* __restrict__ partials, VmSweepScalars s) {
  using G = Geo<R>;
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
  // planes into their buffer, or its w0, w1; the bf16 form copies the word
  // that holds each element into the element's slot
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
          if constexpr (std::is_same_v<PT, float>) cp_async4(dst + k * NA + j, planes + (size_t)plane * hw + p, in);
          else cp_async4(dst + k * NA + j, bf16_word(planes + (size_t)plane * hw + p), in);
        }
      }
    }
    cp_async_commit();
  };
  // the bf16 form's halves: element plane * hw + p has the parity of the
  // pixel's p, flipped where plane and hw are odd (the dw x planes, w0's
  // plane c and w1's C + c when odd; never the dw y planes)
  const unsigned hb = (unsigned)hw & 1u, hfl = hb * SEL_FLIP;
  const unsigned own_sel = half_sel((unsigned)((y0 + ly) * w + x0 + lx0) & 1u);  // the thread's owned pair
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
    uw[k] = own ? ld(ui_w + qpix) : 0.0f;
    tw[k] = own ? ld(tc_w + qpix) : 0.0f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uiv[k][kk] = own ? ld(ui_v + 2 * qpix + kk) : 0.0f;
      tcv[k][kk] = own ? ld(tc_v + 2 * qpix + kk) : 0.0f;
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
  for (int i = tid; i < 2 * NS; i += NT) sCurv[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < NS; i += NT) {
    int r = i / SXP, cx = i % SXP;
    int gy = y0 - HS + r, gx = x0 - HS + cx;
    bool in = cx < SX && row_in(s, gy) && gx >= 0 && gx < w;
    sInvN[i] = in ? pack_round<PT>(1.0f / (sNy[r] * sNx[cx])) : 0.0f;
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
    const unsigned fw0 = ((unsigned)c & hb) * SEL_FLIP, fw1 = ((unsigned)(C + c) & hb) * SEL_FLIP;  // w0's, w1's flips
#pragma unroll
    for (int u = 0; u < NJ; ++u) {
      int j = tid + u * NT;
      if (j < NA) {
        float dvy = sDv[j], dvx = sDv[NA + j];
        if constexpr (std::is_same_v<PT, float>) {
          sA[j] = sW[j] - (sDc[j] * dvy + sDc[NA + j] * dvx);
          sA[NA + j] = sW[NA + j] + (sDc[2 * NA + j] * dvy + sDc[3 * NA + j] * dvx);
        } else {
          const unsigned sy = half_sel((unsigned)jp[u] & 1u), sx = sy ^ hfl;  // any half of a zero-filled slot is 0
          sA[j] = slot_value<PT>(sW[j], sy ^ fw0) -
                  (slot_value<PT>(sDc[j], sy) * dvy + slot_value<PT>(sDc[NA + j], sx) * dvx);
          sA[NA + j] = slot_value<PT>(sW[NA + j], sy ^ fw1) +
                       (slot_value<PT>(sDc[2 * NA + j], sy) * dvy + slot_value<PT>(sDc[3 * NA + j], sx) * dvx);
        }
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
      const unsigned sel0 = half_sel((unsigned)(gy * w + x0 - HS + c0) & 1u);  // the item's first pixel (bf16)
      float qv[4], qc[4], q0[4], q1[4], cy_[4], cx_[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cx = c0 + j, gx = x0 - HS + cx;
        const bool in = row_ok && cx < SX && gx >= 0 && gx < w;
        qv[j] = qc[j] = q0[j] = q1[j] = cy_[j] = cx_[j] = 0.f;
        if (in) {
          const float inv_n = invn[j];
          const SsimPixel sp = ssim_pixel(st[j], inv_n, s);
          if (r >= HS && r < HS + TY && cx >= HS && cx < HS + TX && gy < own_end) e_sim += 1.0f - sp.ssim;
          const SsimCoeffs k = ssim_coeffs(sp, inv_n, s);
          q0[j] = k.q0;
          q1[j] = k.q1;
          qv[j] = k.qv;
          qc[j] = k.qc;
          const float ib2 = k.ib2;
          int a = (r + R) * AW + cx + R;  // the same pixel in the staged planes
          const unsigned sy = (j & 1) ? sel0 ^ SEL_FLIP : sel0, sx = sy ^ hfl;
          float d0y = slot_value<PT>(sDc[a], sy), d0x = slot_value<PT>(sDc[NA + a], sx),
                d1y = slot_value<PT>(sDc[2 * NA + a], sy), d1x = slot_value<PT>(sDc[3 * NA + a], sx);
          cy_[j] = (d0y * d0y + d1y * d1y) * ib2;
          cx_[j] = (d0x * d0x + d1x * d1x) * ib2;
        }
      }
      {
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

    {
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
      const unsigned sy0 = own_sel, sy1 = own_sel ^ SEL_FLIP;  // the pair's selectors (bf16)
      const float d0yp[2] = {slot_value<PT>(d0y.x, sy0), slot_value<PT>(d0y.y, sy1)};
      const float d0xp[2] = {slot_value<PT>(d0x.x, sy0 ^ hfl), slot_value<PT>(d0x.y, sy1 ^ hfl)};
      const float d1yp[2] = {slot_value<PT>(d1y.x, sy0), slot_value<PT>(d1y.y, sy1)};
      const float d1xp[2] = {slot_value<PT>(d1x.x, sy0 ^ hfl), slot_value<PT>(d1x.y, sy1 ^ hfl)};
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
  vertical_pass<R, G::SEG_Q, 2>(sCurv, NS, SY, sV, TY * SXP, TY, SXP, taps, tid);
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
    for (int k = 0; k < 2; ++k) {
      const float* vt = sVt + k * NV + vi;
      tps_maps_at([vt](int dy, int dx) { return vt[dy * VX + dx]; }, y0 - 1 + r, x0 - 1 + cx, s,
                  sM[(3 * k) * NM + i], sM[(3 * k + 1) * NM + i], sM[(3 * k + 2) * NM + i]);
    }
  }
  __syncthreads();

  // the curvature's horizontal window sums at the owned pair
  float pc_y[2], pc_x[2];
  pair_sums<R>(sV + ly * SXP, lx0, taps, pc_y[0], pc_y[1]);
  pair_sums<R>(sV + TY * SXP + ly * SXP, lx0, taps, pc_x[0], pc_x[1]);
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
      e_tps += tps_energy(vxx, vxy, vyy);
      float vk = sVt[kk * NV + (ly + 2) * VX + lx + 2];
      const QuadDiff d = quad_terms(vk, uiv[k][kk], tcv[k][kk], uw[k], tw[k], e_ui, e_tc);
      // self-adjoint stencils of the three maps (descent.py tps_adj_*)
      float adj_xx = Mxx[m - 1] - 2.0f * vxx + Mxx[m + 1];
      float adj_yy = Myy[m - MX] - 2.0f * vyy + Myy[m + MX];
      float adj_xy = 0.25f * (Mxy[m - MX - 1] - Mxy[m - MX + 1] - Mxy[m + MX - 1] + Mxy[m + MX + 1]);
      float g_tps = 2.0f * adj_xx + 4.0f * adj_xy + 2.0f * adj_yy;
      float g_sim = kk == 0 ? gs_y[k] : gs_x[k];
      gk[kk] = g_sim + s.lam_n * g_tps + s.gui_n * uw[k] * d.ui + s.gtc_n * tw[k] * d.tc;
    }
    float p_rest = s.ptps + s.pquad_n * (s.gamma_ui * uw[k] + s.beta_tc * tw[k]);
    reinterpret_cast<float2*>(grad)[qpix] = make_float2(gk[0], gk[1]);
    reinterpret_cast<float2*>(precond)[qpix] =
        make_float2(s.psim_n * pc_y[k] + p_rest + s.eps_n, s.psim_n * pc_x[k] + p_rest + s.eps_n);
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

// Kernel 1 from R = STRIP_MIN_RADIUS: energy partials, gradient and
// preconditioner of one strip of STRIP_ROWS x STRIP_COLS owned pixels. Per
// channel the block walks down the strip STEP_ROWS rows a step: it forms
// a0, a1 of the step's rows, the statistics and coefficient maps R rows
// above them and the transposed sums and gradient 2R rows above them, each
// from a ring of rows; the SSIM gradient and the curvature's window sums
// of the earlier channels wait in grad / precond (each pixel's own thread
// reads back what it wrote), and the last channel adds the TPS, UI and TC
// terms.
template <int R, class PT>
__global__ void __launch_bounds__(NT, 2)
sweep_grad_strip_kernel(const PT* __restrict__ planes, const float* __restrict__ v_lin,
                        const float* __restrict__ v, const PT* __restrict__ ui_w,
                        const PT* __restrict__ ui_v, const PT* __restrict__ tc_w,
                        const PT* __restrict__ tc_v, float* __restrict__ grad,
                        float* __restrict__ precond, float* __restrict__ partials, VmSweepScalars s) {
  using G = SGeo<R>;
  constexpr int K = G::K, RB = G::RB, SC = STRIP_COLS, SW = G::SW, SWP = G::SWP, AWP = G::AWP,
                DR = G::DR, NST = G::NST, NQ = G::NQ, NF = G::NF;
  constexpr int VX = G::VX, NV = G::NV, MX = G::MX, NM = G::NM;

  extern __shared__ float4 smem4[];
  float* const sStage = reinterpret_cast<float*>(smem4);  // 10 planes of NST: the step's inputs
  float* const sA = sStage + G::STAGE_SIZE;              // a0, a1 ring (DR rows of AWP each)
  float* const sQ = sA + G::A_SIZE;                      // coefficient ring (NQ x DR rows of SWP)
  float* const sX = sQ + G::Q_SIZE;                      // a step's vertical sums; v tile and maps
  float* const sNy = sX + G::X_SIZE;                     // row tap sums from row y0 - R
  float* const sNx = sNy + G::NY_SIZE;                   // column tap sums from column x0 - R

  const int h = s.h, w = s.w, C = s.C;
  const size_t hw = (size_t)h * w;
  const int tid = threadIdx.x;
  const int y0 = s.own0 + blockIdx.y * STRIP_ROWS, x0 = blockIdx.x * SC;
  const int nrow = min(STRIP_ROWS, s.own0 + s.nown - y0);  // owned rows of this strip
  const int ya = y0 - 2 * R;                               // the arrays' row of walk row 0
  const int nstep = cdiv(nrow + 4 * R, RB);
  // this thread's owned pair in each step: row ro of the step's output
  // rows, columns jo and jo + 1 of the strip
  const int ro = tid / (SC / 2), jo = 2 * (tid % (SC / 2));
  const unsigned hb = (unsigned)hw & 1u;  // bf16: an odd plane flips its elements' parity

  float taps[K];
#pragma unroll
  for (int t = 0; t < K; ++t) taps[t] = s.taps[t];

  // this thread's chunk of each step: 4 neighbouring staged columns of one
  // row (tid < NCH), the first at column x0 - AO + ch_col. Where the width
  // is a multiple of 4 and the pointers allow it (every chunk then lies
  // wholly inside or outside the image), one copy a plane: 16 bytes, or in
  // the bf16 form 8 bytes into the chunk's first two slots (element m in
  // slot m / 2); else 4-byte copies, one a slot (in the bf16 form the word
  // that holds the slot's element)
  const int ch_row = tid / (G::SAW / 4), ch_col = 4 * (tid % (G::SAW / 4));
  const bool vec = (w & 3) == 0 &&
                   (std::is_same_v<PT, float> ? (((size_t)planes | (size_t)v | (size_t)v_lin) & 15) == 0
                                              : (((size_t)planes & 7) | (((size_t)v | (size_t)v_lin) & 15)) == 0);
  // cp.async of step i's rows of channel c (zero outside the image): the
  // six planes, then v and v_lin as (y, x) pairs
  auto issue = [&](int c, int i) {
    if (tid < G::NCH) {
      const PT* const src[6] = {planes + (size_t)c * hw, planes + (size_t)(C + c) * hw,
                                   planes + (size_t)(2 * C + 2 * c) * hw, planes + (size_t)(2 * C + 2 * c + 1) * hw,
                                   planes + (size_t)(4 * C + 2 * c) * hw, planes + (size_t)(4 * C + 2 * c + 1) * hw};
      const int y = ya + i * RB + ch_row, x = x0 - G::AO + ch_col;
      const bool row_ok = row_in(s, y);
      const int e = ch_row * G::SAW + ch_col;  // the chunk's first staged pixel
      float* const pv = sStage + 6 * NST + 2 * e;
      float* const pl = sStage + 8 * NST + 2 * e;
      if (vec) {
        const bool in = row_ok && x >= 0 && x < w;
        const size_t p = in ? (size_t)y * w + x : 0;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          if constexpr (std::is_same_v<PT, float>) cp_async16(sStage + k * NST + e, src[k] + p, in);
          else cp_async8(sStage + k * NST + e, src[k] + p, in);
        }
        cp_async16(pv, v + 2 * p, in);
        cp_async16(pv + 4, v + 2 * p + 4, in);
        cp_async16(pl, v_lin + 2 * p, in);
        cp_async16(pl + 4, v_lin + 2 * p + 4, in);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const bool in = row_ok && x + m >= 0 && x + m < w;
          const size_t p = in ? (size_t)y * w + x + m : 0;
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            if constexpr (std::is_same_v<PT, float>) cp_async4(sStage + k * NST + e + m, src[k] + p, in);
            else cp_async4(sStage + k * NST + e + m, bf16_word(src[k] + p), in);
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            cp_async4(pv + 2 * m + k, v + 2 * p + k, in);
            cp_async4(pl + 2 * m + k, v_lin + 2 * p + k, in);
          }
        }
      }
    }
    cp_async_commit();
  };
  issue(0, 0);
  // dw0 y, dw0 x, dw1 y, dw1 x (k = 0..3) of channel c at pixel p
  auto dw_at = [&](int c, int k, size_t p) {
    return ldg(planes + (size_t)((k < 2 ? 2 : 4) * C + 2 * c + (k & 1)) * hw + p);
  };

  // the tap-sum tables of the in-image window: 1/n of a statistics pixel
  // is 1 / (sNy[row] sNx[column])
  for (int i = tid; i < G::NY_SIZE + SWP; i += NT) {
    if (i < G::NY_SIZE) {
      const int y = y0 - R + i;
      sNy[i] = i < nrow + 2 * R && row_in(s, y) ? tap_sum_range(taps, R, y + s.row0, s.gh) : 0.0f;
    } else {
      const int j = i - G::NY_SIZE, x = x0 - R + j;
      sNx[j] = j < SW && x >= 0 && x < w ? tap_sum_range(taps, R, x, w) : 0.0f;
    }
  }

  float e_sim = 0.0f, e_tps = 0.0f, e_ui = 0.0f, e_tc = 0.0f;
  for (int c = 0; c < C; ++c) {
    for (int i = 0; i < nstep; ++i) {
      const int u0 = i * RB;  // walk row of the step's first staged row
      // the step's statistics rows are walk rows u0 - R + r and its output
      // rows u0 - 2R + r, r in [0, RB); the strip needs statistics rows
      // [R, nrow + 3R) and output rows [2R, 2R + nrow)
      const int s_lo = max(0, 2 * R - u0), o_lo = max(0, 4 * R - u0), r_hi = min(RB, nrow + 4 * R - u0);
      // 1. a0 = w0 - dw0.dv, a1 = w1 + dw1.dv into the ring (zero outside the
      // image). A thread stages and reads back its own elements, so it waits
      // for its own copies only; the ring rows it writes were last read by
      // the previous step's stages 2a and 3a, behind barriers
      cp_async_wait_all();
      if (tid < G::NCH) {
        const int e = ch_row * G::SAW + ch_col, slot = ((u0 + ch_row) % DR) * AWP;
        // bf16: the parity of the chunk's element 0 in each plane, from its
        // row's y w (the same every step: a step moves RB rows, an even
        // count; x is a multiple of 4) and the plane's offset
        const unsigned pr = (unsigned)(ya + ch_row) & (unsigned)w & 1u;
        const unsigned s0 = half_sel(pr ^ ((unsigned)c & hb)), s1 = half_sel(pr ^ ((unsigned)(C + c) & hb)),
                       sy = half_sel(pr), sx = half_sel(pr ^ hb);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int j = ch_col + m - (G::AO - 2 * R);  // the ring's column
          if (j < 0 || j >= AWP) continue;
          const float* const sv = sStage + 6 * NST + 2 * (e + m);
          const float dvy = sv[0] - sv[2 * NST], dvx = sv[1] - sv[2 * NST + 1];
          if constexpr (std::is_same_v<PT, float>) {
            const float* const st = sStage + e + m;
            sA[slot + j] = st[0] - (st[2 * NST] * dvy + st[3 * NST] * dvx);
            sA[DR * AWP + slot + j] = st[NST] + (st[4 * NST] * dvy + st[5 * NST] * dvx);
          } else {
            const float* const st = sStage + e + (vec ? m >> 1 : m);
            const unsigned o = (m & 1) ? SEL_FLIP : 0u;  // element m's parity is element 0's, flipped on odd m
            sA[slot + j] = slot_value<PT>(st[0], s0 ^ o) -
                           (slot_value<PT>(st[2 * NST], sy ^ o) * dvy + slot_value<PT>(st[3 * NST], sx ^ o) * dvx);
            sA[DR * AWP + slot + j] = slot_value<PT>(st[NST], s1 ^ o) +
                                      (slot_value<PT>(st[4 * NST], sy ^ o) * dvy + slot_value<PT>(st[5 * NST], sx ^ o) * dvx);
          }
        }
      }
      {
        const bool next_c = i + 1 == nstep;  // the next step is the next channel's first
        if (!next_c || c + 1 < C) issue(next_c ? c + 1 : c, next_c ? 0 : i + 1);
      }
      __syncthreads();

      // 2a. vertical window sums of a0, a1, a0^2, a1^2, a0 a1 at the step's
      // statistics rows (walk rows u0 - R + r read ring rows u0 - 2R + r + t)
      if (s_lo < r_hi) {
        constexpr int SEG = G::SEG_A, NSEG = cdiv(RB, SEG);
        for (int it = tid; it < NSEG * AWP; it += NT) {
          const int r0 = (it / AWP) * SEG, j = it % AWP;
          if (r0 + SEG <= s_lo || r0 >= r_hi) continue;
          float acc[SEG][5];
#pragma unroll
          for (int jj = 0; jj < SEG; ++jj)
#pragma unroll
            for (int q = 0; q < 5; ++q) acc[jj][q] = 0.0f;
          int slot = (u0 - 2 * R + r0 + 2 * DR) % DR;  // ring row of walk row u0 - 2R + r0
#pragma unroll
          for (int uu = 0; uu < SEG + 2 * R; ++uu, slot = slot + 1 == DR ? 0 : slot + 1) {
            // rows outside the needed ones feed no stored output
            const float a = sA[slot * AWP + j], b = sA[(DR + slot) * AWP + j];
            const float aa = a * a, bb = b * b, ab = a * b;
#pragma unroll
            for (int jj = 0; jj < SEG; ++jj) {
              const int t = uu - jj;
              if (t >= 0 && t < K) {
                acc[jj][0] += taps[t] * a;
                acc[jj][1] += taps[t] * b;
                acc[jj][2] += taps[t] * aa;
                acc[jj][3] += taps[t] * bb;
                acc[jj][4] += taps[t] * ab;
              }
            }
          }
#pragma unroll
          for (int jj = 0; jj < SEG; ++jj) {
            if (r0 + jj < RB) {
#pragma unroll
              for (int q = 0; q < 5; ++q) sX[(q * RB + r0 + jj) * AWP + j] = acc[jj][q];
            }
          }
        }
      }
      __syncthreads();

      // 2b. horizontal sums -> statistics, SSIM and coefficient maps of the
      // statistics rows into their ring, four neighbouring pixels per item
      if (s_lo < r_hi) {
        for (int it = tid; it < (r_hi - s_lo) * (SWP / 4); it += NT) {
          const int r = s_lo + it / (SWP / 4), c0 = 4 * (it % (SWP / 4));
          const int q = u0 - R + r, y = ya + q;  // walk row and array row
          const bool row_ok = row_in(s, y);
          // dw of the four pixels, in flight during the window sums
          float dw[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int x = x0 - R + c0 + j;
            const size_t p = row_ok && x >= 0 && x < w ? (size_t)y * w + x : 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) dw[j][k] = dw_at(c, k, p);
          }
          float st[4][5];
#pragma unroll
          for (int qq = 0; qq < 5; ++qq) {
            float x[4 * NF];
            const float4* src = reinterpret_cast<const float4*>(sX + (qq * RB + r) * AWP + c0);
#pragma unroll
            for (int f = 0; f < NF; ++f) {
              const float4 v4 = src[f];
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
              st[j][qq] = acc;
            }
          }
          float out[NQ][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int js = c0 + j, x = x0 - R + js;
#pragma unroll
            for (int qq = 0; qq < NQ; ++qq) out[qq][j] = 0.0f;
            if (row_ok && js < SW && x >= 0 && x < w) {
              const float inv_n = pack_round<PT>(1.0f / (sNy[q - R] * sNx[js]));
              const SsimPixel sp = ssim_pixel(st[j], inv_n, s);
              if (q >= 2 * R && q < 2 * R + nrow && js >= R && js < R + SC) e_sim += 1.0f - sp.ssim;
              const SsimCoeffs k = ssim_coeffs(sp, inv_n, s);
              const float d0y = dw[j][0], d0x = dw[j][1], d1y = dw[j][2], d1x = dw[j][3];
              out[0][j] = k.q0;
              out[1][j] = k.q1;
              out[2][j] = k.qv;
              out[3][j] = k.qc;
              out[4][j] = (d0y * d0y + d1y * d1y) * k.ib2;
              out[5][j] = (d0x * d0x + d1x * d1x) * k.ib2;
            }
          }
#pragma unroll
          for (int qq = 0; qq < NQ; ++qq)
            *reinterpret_cast<float4*>(sQ + (qq * DR + q % DR) * SWP + c0) =
                make_float4(out[qq][0], out[qq][1], out[qq][2], out[qq][3]);
        }
      }
      __syncthreads();

      // 3a. vertical transposed window sums at the step's output rows (walk
      // rows u0 - 2R + r read coefficient rows u0 - 3R + r + t; into sX: the
      // statistics' sums are consumed)
      if (o_lo < r_hi) {
        constexpr int SEG = G::SEG_Q, NSEG = cdiv(RB, SEG);
        for (int it = tid; it < NSEG * SWP; it += NT) {
          const int r0 = (it / SWP) * SEG, j = it % SWP;
          if (r0 + SEG <= o_lo || r0 >= r_hi) continue;
          float acc[SEG][NQ];
#pragma unroll
          for (int jj = 0; jj < SEG; ++jj)
#pragma unroll
            for (int qq = 0; qq < NQ; ++qq) acc[jj][qq] = 0.0f;
          int slot = (u0 - 3 * R + r0 + 2 * DR) % DR;  // ring row of walk row u0 - 3R + r0
#pragma unroll
          for (int uu = 0; uu < SEG + 2 * R; ++uu, slot = slot + 1 == DR ? 0 : slot + 1) {
            float x[NQ];
#pragma unroll
            for (int qq = 0; qq < NQ; ++qq) x[qq] = sQ[(qq * DR + slot) * SWP + j];
#pragma unroll
            for (int jj = 0; jj < SEG; ++jj) {
              const int t = uu - jj;
              if (t >= 0 && t < K) {
#pragma unroll
                for (int qq = 0; qq < NQ; ++qq) acc[jj][qq] += taps[t] * x[qq];
              }
            }
          }
#pragma unroll
          for (int jj = 0; jj < SEG; ++jj) {
            if (r0 + jj < RB) {
#pragma unroll
              for (int qq = 0; qq < NQ; ++qq) sX[(qq * RB + r0 + jj) * SWP + j] = acc[jj][qq];
            }
          }
        }
      }

      // this thread's pair of 3b: its a0, a1, read before the barrier (the
      // next step's stage 1 stages over their ring rows with no barrier
      // between), and loads in flight across it: the pair's dw; in the last
      // channel this thread's share of the v tile of step 4 and the pair's
      // constraint maps
      const int o = u0 - 2 * R + ro, y = ya + o;  // walk row and array row of the pair
      const bool mine = o_lo <= ro && ro < r_hi;
      const bool last = c + 1 == C && o_lo < r_hi;
      float2 w0c = make_float2(0.0f, 0.0f), w1c = w0c;
      if (mine) {
        const int a = (o % DR) * AWP + jo + 2 * R;
        w0c = *reinterpret_cast<const float2*>(sA + a);
        w1c = *reinterpret_cast<const float2*>(sA + DR * AWP + a);
      }
      float dw[2][4], vt_r[cdiv(NV, NT)][2], uw[2], tw[2], uiv[2][2], tcv[2][2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int x = x0 + jo + k;
        const bool own = mine && x < w;
        const size_t p = own ? (size_t)y * w + x : 0, qpix = own ? (size_t)(y - s.own0) * w + x : 0;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) dw[k][kk] = dw_at(c, kk, p);
        if (last) {
          uw[k] = ld(ui_w + qpix);
          tw[k] = ld(tc_w + qpix);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            uiv[k][kk] = ld(ui_v + 2 * qpix + kk);
            tcv[k][kk] = ld(tc_v + 2 * qpix + kk);
          }
        }
      }
      if (last) {
#pragma unroll
        for (int u = 0; u < cdiv(NV, NT); ++u) {
          const int e = tid + u * NT;
          const int yy = ya + u0 - 2 * R - 2 + e / VX, xx = x0 - 2 + e % VX;
          const bool in = e < NV && yy >= 0 && yy < h && xx >= 0 && xx < w;
          const size_t p = in ? (size_t)yy * w + xx : 0;
          vt_r[u][0] = in ? v[2 * p] : 0.0f;
          vt_r[u][1] = in ? v[2 * p + 1] : 0.0f;
        }
      }
      __syncthreads();

      // 3b. horizontal sums at the owned pair; chain through dw0 / dw1; the
      // SSIM gradient and the curvature's sums with the earlier channels'
      float gs[2][2], pc[2][2];  // [pixel][y, x]
      if (mine) {
        float tq[2][NQ];
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) pair_sums<R>(sX + (qq * RB + ro) * SWP, jo, taps, tq[0][qq], tq[1][qq]);
        const float w0p[2] = {w0c.x, w0c.y}, w1p[2] = {w1c.x, w1c.y};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int x = x0 + jo + k;
          if (x >= w) continue;
          const size_t qpix = (size_t)(y - s.own0) * w + x;
          const float d0y = dw[k][0], d0x = dw[k][1], d1y = dw[k][2], d1x = dw[k][3];
          const float g0 = tq[k][0] + 2.0f * w0p[k] * tq[k][2] + w1p[k] * tq[k][3];
          const float g1 = tq[k][1] + 2.0f * w1p[k] * tq[k][2] + w0p[k] * tq[k][3];
          gs[k][0] = -g0 * d0y + g1 * d1y;
          gs[k][1] = -g0 * d0x + g1 * d1x;
          pc[k][0] = tq[k][4];
          pc[k][1] = tq[k][5];
          if (c > 0) {
            const float2 g = reinterpret_cast<const float2*>(grad)[qpix];
            const float2 pp = reinterpret_cast<const float2*>(precond)[qpix];
            gs[k][0] = g.x + gs[k][0];
            gs[k][1] = g.y + gs[k][1];
            pc[k][0] = pp.x + pc[k][0];
            pc[k][1] = pp.y + pc[k][1];
          }
          if (c + 1 < C) {
            reinterpret_cast<float2*>(grad)[qpix] = make_float2(gs[k][0], gs[k][1]);
            reinterpret_cast<float2*>(precond)[qpix] = make_float2(pc[k][0], pc[k][1]);
          }
        }
      }
      if (!last) continue;

      // 4. last channel: the TPS maps of the output rows and a ring of 1
      // from a tile of v (zero outside the arrays) in sX, then the outputs
      __syncthreads();  // the transposed sums are consumed
      float* const sVt = sX;           // v tile: rows y - 2 .., columns x0 - 2 ..
      float* const sM = sX + 2 * NV;   // maps: rows y - 1 .., columns x0 - 1 ..
#pragma unroll
      for (int u = 0; u < cdiv(NV, NT); ++u) {
        const int e = tid + u * NT;
        if (e < NV) {
          sVt[e] = vt_r[u][0];
          sVt[NV + e] = vt_r[u][1];
        }
      }
      __syncthreads();
      for (int e = tid; e < NM; e += NT) {
        const int r = e / MX, cx = e % MX;
        const int vi = (r + 1) * VX + cx + 1;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float* vt = sVt + k * NV + vi;
          tps_maps_at([vt](int dy, int dx) { return vt[dy * VX + dx]; }, ya + u0 - 2 * R - 1 + r, x0 - 1 + cx, s,
                      sM[(3 * k) * NM + e], sM[(3 * k + 1) * NM + e], sM[(3 * k + 2) * NM + e]);
        }
      }
      __syncthreads();
      if (!mine) continue;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int lx = jo + k, x = x0 + lx;
        if (x >= w) continue;
        const size_t qpix = (size_t)(y - s.own0) * w + x;  // in the owned-row maps and outputs
        const int m = (ro + 1) * MX + lx + 1;
        float gk[2];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* Mxx = sM + (3 * kk) * NM;
          const float* Mxy = Mxx + NM;
          const float* Myy = Mxy + NM;
          const float vxx = Mxx[m], vxy = Mxy[m], vyy = Myy[m];
          e_tps += tps_energy(vxx, vxy, vyy);
          const float vk = sVt[kk * NV + (ro + 2) * VX + lx + 2];
          const QuadDiff d = quad_terms(vk, uiv[k][kk], tcv[k][kk], uw[k], tw[k], e_ui, e_tc);
          // self-adjoint stencils of the three maps (descent.py tps_adj_*)
          const float adj_xx = Mxx[m - 1] - 2.0f * vxx + Mxx[m + 1];
          const float adj_yy = Myy[m - MX] - 2.0f * vyy + Myy[m + MX];
          const float adj_xy = 0.25f * (Mxy[m - MX - 1] - Mxy[m - MX + 1] - Mxy[m + MX - 1] + Mxy[m + MX + 1]);
          const float g_tps = 2.0f * adj_xx + 4.0f * adj_xy + 2.0f * adj_yy;
          gk[kk] = gs[k][kk] + s.lam_n * g_tps + s.gui_n * uw[k] * d.ui + s.gtc_n * tw[k] * d.tc;
        }
        const float p_rest = s.ptps + s.pquad_n * (s.gamma_ui * uw[k] + s.beta_tc * tw[k]);
        reinterpret_cast<float2*>(grad)[qpix] = make_float2(gk[0], gk[1]);
        reinterpret_cast<float2*>(precond)[qpix] =
            make_float2(s.psim_n * pc[k][0] + p_rest + s.eps_n, s.psim_n * pc[k][1] + p_rest + s.eps_n);
      }
    }
  }

  // fixed-order tree over the block (in sX: its last readers are done)
  __syncthreads();
  float* const sred = sX;
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
  if (tid < 4) partials[4 * (blockIdx.y * gridDim.x + blockIdx.x) + tid] = sred[tid * NT];
}

// Kernel 2 at R = 1 .. 3: the energy partials of one tile of
// ENERGY_TILE_ROWS x ENERGY_TILE_COLS owned pixels, without the gradient. Each warp walks a
// column strip of ESEG owned rows: lane l holds column x0 - EH + l and
// the K rows of its linearized warps in registers; the horizontal window
// comes from the neighbouring lanes by shuffles. Each lane reads back only
// the shared memory it wrote, so the kernel's one barrier is the block's
// reduction.
template <int R, class PT>
__global__ void __launch_bounds__(ENT, 4)
sweep_energy_kernel(const PT* __restrict__ planes, const float* __restrict__ v_lin,
                    const float* __restrict__ v, const PT* __restrict__ ui_w,
                    const PT* __restrict__ ui_v, const PT* __restrict__ tc_w,
                    const PT* __restrict__ tc_v, float* __restrict__ partials,
                    VmSweepScalars s) {
  constexpr int K = 2 * R + 1;
  constexpr unsigned FULL = 0xffffffffu;
  const int w = s.w, C = s.C;
  const int hw = s.h * w;  // the launcher checks that 6 C hw offsets fit an int
  const int own_end = s.own0 + s.nown;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  using G = EGeo<R>;
  const int x = blockIdx.x * G::COLS - G::EH + lane;                   // this lane's column
  const int yw = s.own0 + blockIdx.y * ENERGY_TILE_ROWS + wid * ESEG;  // the warp's first owned row
  const bool col_in = x >= 0 && x < w;
  const bool owner = lane >= G::EH && lane < G::EH + G::COLS && x < w;

  float taps[K];
#pragma unroll
  for (int t = 0; t < K; ++t) taps[t] = s.taps[t];

  // this warp's shared memory, read back only by the lane that wrote it
  // (its own column), so no barrier: dv (y, x) at the walk's rows, 1/n at
  // the owned rows and a ring of EDEPTH rows of the six planes
  constexpr int NU = G::NU;  // rows of a channel's walk
  extern __shared__ float4 esmem4[];
  float* const s_dv = reinterpret_cast<float*>(esmem4) + wid * G::WARP_FLOATS;  // [2][NU][32]
  float* const s_invn = s_dv + 2 * NU * 32;                                     // [ESEG][32]
  float* const s_pl = s_invn + ESEG * 32;                                       // [EDEPTH][6][32]

  // 0. once per strip: dv = v - v_lin (zero outside the image) and 1/n;
  // bit u of `in` marks walk row u in the image
  unsigned in = 0;
  const float nx = col_in ? tap_sum_range(taps, R, x, w) : 0.0f;
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int y = yw - R + u;
    float dvy = 0.0f, dvx = 0.0f;
    if (col_in && row_in(s, y)) {
      in |= 1u << u;
      const int p = y * w + x;
      dvy = v[2 * p] - v_lin[2 * p];
      dvx = v[2 * p + 1] - v_lin[2 * p + 1];
    }
    s_dv[u * 32 + lane] = dvy;
    s_dv[(NU + u) * 32 + lane] = dvx;
    if (u >= R && u < R + ESEG) {
      const int yo = yw + u - R;
      s_invn[(u - R) * 32 + lane] =
          owner && yo < own_end ? pack_round<PT>(1.0f / (tap_sum_range(taps, R, yo + s.row0, s.gh) * nx)) : 0.0f;
    }
  }

  // 1. per channel: the linearized warps a0 = w0 - dw0.dv, a1 = w1 + dw1.dv
  // row by row (zero outside the image), their window statistics (vertical
  // from a register ring, horizontal by shuffles) and the SSIM map of the
  // owned pixels. The planes of walk step i = c NU + u arrive by 4-byte
  // cp.async (zero-filled outside the image) into ring slot i % EDEPTH,
  // issued EDEPTH - 1 steps ahead, across the channel boundary too (the
  // bf16 form copies the word that holds each element).
  auto issue = [&](int c, int u, int slot) {
    const bool ok = (in & (1u << u)) != 0;
    const int p = ok ? (yw - R + u) * w + x : 0;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      // w0, w1, dw0 y, dw0 x, dw1 y, dw1 x of channel c
      const int plane = k < 2 ? k * C + c : (k < 4 ? 2 * C : 4 * C) + 2 * c + (k & 1);
      // the bf16 word by its index: with bf16_word's byte address the
      // compiler keeps six plane pointers, which spill at the 64-register
      // cap of R <= 3 beside the halves' bits below
      if constexpr (std::is_same_v<PT, float>) cp_async4(s_pl + (slot * 6 + k) * 32 + lane, planes + (plane * hw + p), ok);
      else cp_async4(s_pl + (slot * 6 + k) * 32 + lane, reinterpret_cast<const float*>(planes + ((plane * hw + p) & ~1)), ok);
    }
  };
  // bf16: the parity of this lane's element in walk row u's planes is that
  // of its pixel, (yw - R + u) w + x (row 0's, flipped on odd rows of an odd
  // width), flipped on an odd plane of an odd hw (dw x; w0's, w1's by c)
  const unsigned hb = (unsigned)hw & 1u, wb = (unsigned)w & 1u;
  const unsigned par0 = (unsigned)((yw - R) * w + x) & 1u;
#pragma unroll
  for (int u = 0; u < EDEPTH - 1; ++u) {
    issue(0, u, u);
    cp_async_commit();
  }

  float e_sim = 0.0f;
  for (int c = 0; c < C; ++c) {
    const int slot0 = c * NU;  // ring position of the channel's first row
    float ra[K], rb[K];        // rows u - 2R .. u of a0 and a1, row u at u % K
    const unsigned f0 = (unsigned)c & hb, f1 = (unsigned)(C + c) & hb;  // bf16: w0's and w1's flips
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      constexpr int AHEAD = EDEPTH - 1;
      if (u + AHEAD < NU) issue(c, u + AHEAD, (slot0 + u + AHEAD) & (EDEPTH - 1));
      else if (c + 1 < C) issue(c + 1, u + AHEAD - NU, (slot0 + u + AHEAD) & (EDEPTH - 1));
      cp_async_commit();
      cp_async_wait<AHEAD>();  // step u's planes are in
      const float* const cur = s_pl + ((slot0 + u) & (EDEPTH - 1)) * 6 * 32 + lane;
      const float dvy = s_dv[u * 32 + lane], dvx = s_dv[(NU + u) * 32 + lane];
      const unsigned py = par0 ^ ((u & 1) ? wb : 0u);  // bf16: the row's parity
      const unsigned sy = half_sel(py), sx = half_sel(py ^ hb);
      const float a = slot_value<PT>(cur[0], half_sel(py ^ f0)) -
                      (slot_value<PT>(cur[2 * 32], sy) * dvy + slot_value<PT>(cur[3 * 32], sx) * dvx);
      const float b = slot_value<PT>(cur[32], half_sel(py ^ f1)) +
                      (slot_value<PT>(cur[4 * 32], sy) * dvy + slot_value<PT>(cur[5 * 32], sx) * dvx);
      ra[u % K] = a;
      rb[u % K] = b;
      if (u < 2 * R) continue;
      const int j = u - 2 * R;  // output row yw + j: rows j .. j + 2R of the walk
      float st[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const float at = ra[(j + t) % K], bt = rb[(j + t) % K];
        const float aa = at * at, bb = bt * bt, ab = at * bt;
        st[0] += taps[t] * at;
        st[1] += taps[t] * bt;
        st[2] += taps[t] * aa;
        st[3] += taps[t] * bb;
        st[4] += taps[t] * ab;
      }
      float hs[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < K; ++t) acc += taps[t] * (t == R ? st[q] : __shfl_sync(FULL, st[q], lane - R + t));
        hs[q] = acc;
      }
      if (owner && yw + j < own_end) e_sim += 1.0f - ssim_pixel(hs, s_invn[j * 32 + lane], s).ssim;
    }
  }

  // 2. TPS, UI and TC at the owned pixels: v on the strip and a ring of 1,
  // rows in a register ring of 3, the neighbouring columns by shuffles
  // (zero outside the arrays, as the gradient kernel's v tile)
  float e_tps = 0.0f, e_ui = 0.0f, e_tc = 0.0f;
  float rv[3][3][2];  // row u % 3; columns x - 1, x, x + 1; components
#pragma unroll
  for (int u = 0; u < ESEG + 2; ++u) {
    const int y = yw - 1 + u;
    const bool inside = col_in && y >= 0 && y < s.h;
    const size_t p = inside ? (size_t)y * w + x : 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float vc = inside ? v[2 * p + k] : 0.0f;
      rv[u % 3][1][k] = vc;
      rv[u % 3][0][k] = __shfl_up_sync(FULL, vc, 1);
      rv[u % 3][2][k] = __shfl_down_sync(FULL, vc, 1);
    }
    if (u < 2) continue;
    const int j = u - 2, yo = yw + j;
    if (owner && yo < own_end) {
      const size_t q = (size_t)(yo - s.own0) * w + x;  // in the owned-row maps
      const float uw = ld(ui_w + q), tw = ld(tc_w + q);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float vxx, vxy, vyy;
        tps_maps_at([&](int dy, int dx) { return rv[(j + 1 + dy) % 3][dx + 1][k]; }, yo, x, s, vxx,
                    vxy, vyy);
        e_tps += tps_energy(vxx, vxy, vyy);
        quad_terms(rv[(j + 1) % 3][1][k], ld(ui_v + 2 * q + k), ld(tc_v + 2 * q + k), uw, tw, e_ui, e_tc);
      }
    }
  }

  // 3. fixed-order reduction: a shuffle tree per warp, then the warps in order
  __shared__ float sred[4][EWARPS];
  float e[4] = {e_sim, e_tps, e_ui, e_tc};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) e[q] += __shfl_down_sync(FULL, e[q], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) sred[q][wid] = e[q];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < EWARPS; ++i) acc += sred[threadIdx.x][i];
    partials[4 * (blockIdx.y * gridDim.x + blockIdx.x) + threadIdx.x] = acc;
  }
}

// Kernel 2 at R = ENERGY_STRIP_MIN_RADIUS .. ENERGY_STRIP_MAX_RADIUS: the
// energy partials of one block of ENERGY_STRIP_ROWS x ENERGY_STRIP_WARPS
// (32 - 2R) owned pixels. Each warp walks its column strip of
// ENERGY_STRIP_ROWS owned rows plus 2R halo rows once per channel, lane l
// holding column x0 - R + l; the arithmetic of every pixel is
// sweep_energy_kernel's, in the same order.
template <int R, class PT>
__global__ void __launch_bounds__(ESGeo<R>::THREADS, R <= 5 ? 6 : 4)
sweep_energy_strip_kernel(const PT* __restrict__ planes, const float* __restrict__ v_lin,
                          const float* __restrict__ v, const PT* __restrict__ ui_w,
                          const PT* __restrict__ ui_v, const PT* __restrict__ tc_w,
                          const PT* __restrict__ tc_v, float* __restrict__ partials,
                          VmSweepScalars s) {
  using G = ESGeo<R>;
  constexpr int K = G::K, S = G::S, NU = G::NU, TW = G::TW;
  constexpr unsigned FULL = 0xffffffffu;
  const int w = s.w, C = s.C;
  const int hw = s.h * w;  // the launcher checks that 6 C hw offsets fit an int
  const int own_end = s.own0 + s.nown;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int xb = blockIdx.x * (ENERGY_STRIP_WARPS * G::COLS) - R;  // the block's first dv column
  const int col = wid * G::COLS + lane;                            // this lane's dv column
  const int x = xb + col;                                          // this lane's column
  const int yw = s.own0 + blockIdx.y * S;                          // the block's first owned row
  const bool col_in = x >= 0 && x < w;
  const bool owner = lane >= R && lane < R + G::COLS && x < w;

  // the taps are symmetric (the wrapper checks taps[t] == taps[K - 1 - t]),
  // so R + 1 registers hold all K of them
  float half[R + 1];
#pragma unroll
  for (int t = 0; t <= R; ++t) half[t] = s.taps[t];
  auto tap = [&](int t) { return half[t <= R ? t : K - 1 - t]; };

  extern __shared__ float4 essmem4[];
  float* const s_ring = reinterpret_cast<float*>(essmem4) + wid * (EDEPTH * 6 * 32);  // [EDEPTH][6][32]
  float* const s_dv = reinterpret_cast<float*>(essmem4) + G::RING_FLOATS;            // [2][NU][TW]
  float* const s_ny = s_dv + G::DV_FLOATS;                                           // [S]

  // bit u of `in` marks walk row u (arrays' row yw - R + u) of this column in the image
  unsigned in = 0;
#pragma unroll
  for (int u = 0; u < NU; ++u)
    if (col_in && row_in(s, yw - R + u)) in |= 1u << u;

  // the planes of walk step c NU + u arrive by 4-byte cp.async (zero-filled
  // outside the image) into ring slot (c NU + u) % EDEPTH, EDEPTH - 1 steps
  // ahead, across the channel boundary too (the bf16 form copies the word
  // that holds each element)
  auto issue = [&](int c, int u, int slot) {
    const bool ok = (in >> u) & 1u;
    const int p = ok ? (yw - R + u) * w + x : 0;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      // w0, w1, dw0 y, dw0 x, dw1 y, dw1 x of channel c
      const int plane = k < 2 ? k * C + c : (k < 4 ? 2 * C : 4 * C) + 2 * c + (k & 1);
      if constexpr (std::is_same_v<PT, float>) cp_async4(s_ring + (slot * 6 + k) * 32 + lane, planes + (plane * hw + p), ok);
      else cp_async4(s_ring + (slot * 6 + k) * 32 + lane, bf16_word(planes + (plane * hw + p)), ok);
    }
  };
  constexpr int AHEAD = EDEPTH - 1;
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) {
    issue(0, u, u);
    cp_async_commit();
  }

  // 0. once per block, while those copies fly: dv = v - v_lin at the walk's
  // rows and the block's columns (zero outside the image; unrolled, so a
  // thread's loads are in flight together), and the tap sums of the owned
  // rows' windows in the frame
#pragma unroll
  for (int it = 0; it < cdiv(NU * TW, G::THREADS); ++it) {
    const int e = threadIdx.x + it * G::THREADS;
    if (e >= NU * TW) break;
    const int u = e / TW, j = e - u * TW;
    const int y = yw - R + u, xx = xb + j;
    float dvy = 0.0f, dvx = 0.0f;
    if (xx >= 0 && xx < w && row_in(s, y)) {
      const int p = y * w + xx;
      dvy = v[2 * p] - v_lin[2 * p];
      dvx = v[2 * p + 1] - v_lin[2 * p + 1];
    }
    s_dv[u * TW + j] = dvy;
    s_dv[(NU + u) * TW + j] = dvx;
  }
  if (threadIdx.x < S) s_ny[threadIdx.x] = tap_sum_range(s.taps, R, yw + threadIdx.x + s.row0, s.gh);
  __syncthreads();
  const float nx = col_in ? tap_sum_range(s.taps, R, x, w) : 0.0f;

  // 1. per channel: a0 = w0 - dw0.dv, a1 = w1 + dw1.dv row by row into a
  // register ring of K rows; from the ring the vertical window sums of the
  // output row 2R up, then the horizontal ones by shuffles and the SSIM of
  // the owned lanes
  // bf16: the parity of this lane's element in walk row u's planes is that
  // of its pixel, (yw - R + u) w + x (row 0's, flipped on odd rows of an odd
  // width), flipped on an odd plane of an odd hw (dw x; w0's, w1's by c)
  const unsigned hb = (unsigned)hw & 1u, wb = (unsigned)w & 1u;
  const unsigned par0 = (unsigned)((yw - R) * w + x) & 1u;
  float e_sim = 0.0f;
  for (int c = 0; c < C; ++c) {
    const int slot0 = c * NU;  // the ring step of the channel's first row
    float ra[K], rb[K];        // rows u - 2R .. u of a0 and a1, row u at u % K
    const unsigned f0 = (unsigned)c & hb, f1 = (unsigned)(C + c) & hb;  // bf16: w0's and w1's flips
    // walk row u: issue the copies AHEAD steps on, wait for this row's planes, form a0 and a1
    auto walk = [&](int u, float& a, float& b) {
      if (u + AHEAD < NU) issue(c, u + AHEAD, (slot0 + u + AHEAD) & (EDEPTH - 1));
      else if (c + 1 < C) issue(c + 1, u + AHEAD - NU, (slot0 + u + AHEAD) & (EDEPTH - 1));
      cp_async_commit();
      cp_async_wait<AHEAD>();  // step u's planes are in
      const float* const cur = s_ring + ((slot0 + u) & (EDEPTH - 1)) * 6 * 32 + lane;
      const float dvy = s_dv[u * TW + col], dvx = s_dv[(NU + u) * TW + col];
      const unsigned py = par0 ^ ((u & 1) ? wb : 0u);  // bf16: the row's parity
      const unsigned sy = half_sel(py), sx = half_sel(py ^ hb);
      a = slot_value<PT>(cur[0], half_sel(py ^ f0)) -
          (slot_value<PT>(cur[2 * 32], sy) * dvy + slot_value<PT>(cur[3 * 32], sx) * dvx);
      b = slot_value<PT>(cur[32], half_sel(py ^ f1)) +
          (slot_value<PT>(cur[4 * 32], sy) * dvy + slot_value<PT>(cur[5 * 32], sx) * dvx);
    };
#pragma unroll
    for (int u = 0; u < 2 * R; ++u) walk(u, ra[u], rb[u]);
    // output row j takes walk rows j .. j + 2R; with j0 a multiple of K, row
    // j + 2R lies in slot (i + 2R) % K and row j + t in slot (i + t) % K
    for (int j0 = 0; j0 < S; j0 += K) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int j = j0 + i;
        if (j >= S) break;
        walk(j + 2 * R, ra[(i + 2 * R) % K], rb[(i + 2 * R) % K]);
        float st[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const float at = ra[(i + t) % K], bt = rb[(i + t) % K];
          const float aa = at * at, bb = bt * bt, ab = at * bt;
          st[0] += tap(t) * at;
          st[1] += tap(t) * bt;
          st[2] += tap(t) * aa;
          st[3] += tap(t) * bb;
          st[4] += tap(t) * ab;
        }
        float hs[5];
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < K; ++t) acc += tap(t) * (t == R ? st[q] : __shfl_sync(FULL, st[q], lane - R + t));
          hs[q] = acc;
        }
        const int yo = yw + j;
        if (owner && yo < own_end)
          e_sim += 1.0f - ssim_pixel(hs, pack_round<PT>(1.0f / (s_ny[j] * nx)), s).ssim;
      }
    }
  }

  // 2. TPS, UI and TC at the owned pixels: v on the strip and a ring of 1,
  // rows in a register ring of 3, the neighbouring columns by shuffles
  // (zero outside the arrays, as the gradient kernels' v tiles). Each turn
  // of the ring loads its rows' v and the UI/TC maps of the owned rows it
  // finishes before it uses any of them, so one load latency is exposed a
  // turn, not two a row
  constexpr int EG = 3;  // rows of a turn
  static_assert((S + 2) % EG == 0, "whole turns cover the rows");
  float e_tps = 0.0f, e_ui = 0.0f, e_tc = 0.0f;
  float rv[3][3][2];  // row u % 3; columns x - 1, x, x + 1; components
  for (int u0 = 0; u0 < S + 2; u0 += EG) {
    float vg[EG][2], mg[EG][6];  // row u0 + i's v; ui_w, tc_w, ui_v, tc_v of owned row yw + u0 + i - 2
#pragma unroll
    for (int i = 0; i < EG; ++i) {
      const int y = yw - 1 + u0 + i;
      const bool inside = col_in && y >= 0 && y < s.h;
      const size_t p = inside ? (size_t)y * w + x : 0;
      vg[i][0] = inside ? v[2 * p] : 0.0f;
      vg[i][1] = inside ? v[2 * p + 1] : 0.0f;
      const int yo = y - 1;
      const bool own = owner && u0 + i >= 2 && yo < own_end;
      const size_t q = own ? (size_t)(yo - s.own0) * w + x : 0;  // in the owned-row maps
      mg[i][0] = own ? ld(ui_w + q) : 0.0f;
      mg[i][1] = own ? ld(tc_w + q) : 0.0f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        mg[i][2 + k] = own ? ld(ui_v + 2 * q + k) : 0.0f;
        mg[i][4 + k] = own ? ld(tc_v + 2 * q + k) : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < EG; ++i) {
      const int u = u0 + i;  // row u at slot i
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        rv[i][1][k] = vg[i][k];
        rv[i][0][k] = __shfl_up_sync(FULL, vg[i][k], 1);
        rv[i][2][k] = __shfl_down_sync(FULL, vg[i][k], 1);
      }
      if (u < 2) continue;
      const int yo = yw + u - 2;  // its centre row u - 1 lies in slot (i + 2) % 3
      if (owner && yo < own_end) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float vxx, vxy, vyy;
          tps_maps_at([&](int dy, int dx) { return rv[(i + 2 + dy) % 3][dx + 1][k]; }, yo, x, s, vxx, vxy, vyy);
          e_tps += tps_energy(vxx, vxy, vyy);
          quad_terms(rv[(i + 2) % 3][1][k], mg[i][2 + k], mg[i][4 + k], mg[i][0], mg[i][1], e_ui, e_tc);
        }
      }
    }
  }

  // 3. fixed-order reduction: a shuffle tree per warp, then the warps in order
  __shared__ float sred[4][ENERGY_STRIP_WARPS];
  float e[4] = {e_sim, e_tps, e_ui, e_tc};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) e[q] += __shfl_down_sync(FULL, e[q], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) sred[q][wid] = e[q];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < ENERGY_STRIP_WARPS; ++i) acc += sred[threadIdx.x][i];
    partials[4 * (blockIdx.y * gridDim.x + blockIdx.x) + threadIdx.x] = acc;
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

// ---------------------------------------------------------------------------
// The per-pixel chain: the radii past the wide strip's reach (R >
// WIDE_MAX_RADIUS), the radius read at run time. Each kernel gives one
// thread one pixel of a band of rows, 32 columns x 8 rows a block; the
// bands, in rows of the arrays:
//   A band, rows [own0 - 2R, own0 + nown + 2R): a0 and a1 of one channel;
//   S band, rows [own0 - R, own0 + nown + R): the statistics, the SSIM
//     coefficient maps and the curvature;
//   owned rows [own0, own0 + nown): the transposed sums, the SSIM energy
//     and gradient summed over the channels, the outputs.
// Rows outside the arrays or the global frame hold zeros, as the tiled
// kernels' zero-filled tiles do.
// ---------------------------------------------------------------------------

constexpr int WT = CHAIN_TILE_ROWS * CHAIN_TILE_COLS;  // threads per chain block
static_assert(CHAIN_TILE_COLS == 32 && WT == 256, "a chain block is 8 warps, one row of 32 columns each");

// Offsets (floats) of the chain's intermediates in its scratch buffer.
struct WideLayout {
  long long na, ns;                      // rows of the A and S bands
  long long a, v, es, q, curv, gs, total;  // a0 a1 (2 na), V (5 ns; later 4 or 2 owned-row planes),
                                         // SSIM energy (1), Q (4 ns), curvature (2 ns), SSIM gradient (2)
};

WideLayout wide_layout(int w, int nown, int R, bool with_grad) {
  WideLayout L;
  L.na = nown + 4LL * R;
  L.ns = nown + 2LL * R;
  L.a = 0;
  L.v = L.a + 2 * L.na * w;
  L.es = L.v + 5 * L.ns * w;
  L.q = L.es + (long long)nown * w;
  L.curv = L.q + (with_grad ? 4 * L.ns * w : 0);
  L.gs = L.curv + (with_grad ? 2 * L.ns * w : 0);
  L.total = L.gs + (with_grad ? 2LL * nown * w : 0);
  return L;
}

// K-tap horizontal window sum at column x of one row (zero outside [0, w)),
// taps t = 0..2R in order
__device__ __forceinline__ float wide_hsum(const float* __restrict__ row, int x, int w,
                                           const float* __restrict__ taps, int R) {
  float acc = 0.0f;
  for (int t = 0; t <= 2 * R; ++t) {
    const int q = x - R + t;
    acc += __ldg(taps + t) * (q >= 0 && q < w ? row[q] : 0.0f);
  }
  return acc;
}

// a0 = w0 - dw0.dv and a1 = w1 + dw1.dv of channel c on the A band
template <class PT>
__global__ void __launch_bounds__(WT)
wide_warps_kernel(const PT* __restrict__ planes, const float* __restrict__ v_lin,
                  const float* __restrict__ v, float* __restrict__ A, int c, VmSweepScalars s) {
  const int R = s.radius, w = s.w, C = s.C;
  const long long na = s.nown + 4LL * R;
  const int x = blockIdx.x * CHAIN_TILE_COLS + threadIdx.x;
  const int i = blockIdx.y * CHAIN_TILE_ROWS + threadIdx.y;
  if (x >= w || i >= na) return;
  const int y = s.own0 - 2 * R + i;
  float a = 0.0f, b = 0.0f;
  if (row_in(s, y)) {
    const size_t hw = (size_t)s.h * w, p = (size_t)y * w + x;
    const float dvy = v[2 * p] - v_lin[2 * p], dvx = v[2 * p + 1] - v_lin[2 * p + 1];
    a = ld(planes + c * hw + p) -
        (ld(planes + (2 * C + 2 * c) * hw + p) * dvy + ld(planes + (2 * C + 2 * c + 1) * hw + p) * dvx);
    b = ld(planes + (C + c) * hw + p) +
        (ld(planes + (4 * C + 2 * c) * hw + p) * dvy + ld(planes + (4 * C + 2 * c + 1) * hw + p) * dvx);
  }
  A[(size_t)i * w + x] = a;
  A[((size_t)na + i) * w + x] = b;
}

// vertical window sums of a0, a1, a0^2, a1^2, a0 a1 on the S band
__global__ void __launch_bounds__(WT)
wide_stats_vertical_kernel(const float* __restrict__ A, float* __restrict__ V, VmSweepScalars s) {
  const int R = s.radius, w = s.w;
  const long long na = s.nown + 4LL * R, ns = s.nown + 2LL * R;
  const int x = blockIdx.x * CHAIN_TILE_COLS + threadIdx.x;
  const int i = blockIdx.y * CHAIN_TILE_ROWS + threadIdx.y;
  if (x >= w || i >= ns) return;
  const float* a0 = A + x;
  const float* a1 = A + (size_t)na * w + x;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t <= 2 * R; ++t) {
    const float a = a0[(size_t)(i + t) * w], b = a1[(size_t)(i + t) * w];
    const float aa = a * a, bb = b * b, ab = a * b;
    const float k = __ldg(s.taps + t);
    acc[0] += k * a;
    acc[1] += k * b;
    acc[2] += k * aa;
    acc[3] += k * bb;
    acc[4] += k * ab;
  }
#pragma unroll
  for (int q = 0; q < 5; ++q) V[((size_t)q * ns + i) * w + x] = acc[q];
}

// horizontal window sums -> statistics and the SSIM of channel c on the S
// band: the owned pixels' 1 - SSIM added to es; with the gradient also the
// coefficient maps (q0, q1, qv, qc) into Q and the curvature added to curv
template <bool WITH_GRAD, class PT>
__global__ void __launch_bounds__(WT)
wide_ssim_kernel(const PT* __restrict__ planes, const float* __restrict__ V, float* __restrict__ Q,
                 float* __restrict__ curv, float* __restrict__ es, int c, VmSweepScalars s) {
  const int R = s.radius, w = s.w, C = s.C;
  const long long ns = s.nown + 2LL * R;
  const int x = blockIdx.x * CHAIN_TILE_COLS + threadIdx.x;
  const int i = blockIdx.y * CHAIN_TILE_ROWS + threadIdx.y;
  if (x >= w || i >= ns) return;
  const int y = s.own0 - R + i;
  float st[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) st[q] = wide_hsum(V + ((size_t)q * ns + i) * w, x, w, s.taps, R);
  float q0 = 0.f, q1 = 0.f, qv = 0.f, qc = 0.f, cy = 0.f, cx = 0.f;
  if (row_in(s, y)) {
    const float inv_n =
        pack_round<PT>(1.0f / (tap_sum_range(s.taps, R, y + s.row0, s.gh) * tap_sum_range(s.taps, R, x, w)));
    const SsimPixel sp = ssim_pixel(st, inv_n, s);
    if (y >= s.own0 && y < s.own0 + s.nown) {
      float* e = es + (size_t)(y - s.own0) * w + x;
      *e = (c == 0 ? 0.0f : *e) + (1.0f - sp.ssim);
    }
    if constexpr (WITH_GRAD) {
      const SsimCoeffs k = ssim_coeffs(sp, inv_n, s);
      q0 = k.q0;
      q1 = k.q1;
      qv = k.qv;
      qc = k.qc;
      const float ib2 = k.ib2;
      const size_t hw = (size_t)s.h * w, p = (size_t)y * w + x;
      const float d0y = ld(planes + (2 * C + 2 * c) * hw + p), d0x = ld(planes + (2 * C + 2 * c + 1) * hw + p);
      const float d1y = ld(planes + (4 * C + 2 * c) * hw + p), d1x = ld(planes + (4 * C + 2 * c + 1) * hw + p);
      cy = (d0y * d0y + d1y * d1y) * ib2;
      cx = (d0x * d0x + d1x * d1x) * ib2;
    }
  }
  if constexpr (WITH_GRAD) {
    const size_t o = (size_t)i * w + x, plane = (size_t)ns * w;
    Q[o] = q0;
    Q[plane + o] = q1;
    Q[2 * plane + o] = qv;
    Q[3 * plane + o] = qc;
    curv[o] = (c == 0 ? 0.0f : curv[o]) + cy;
    curv[plane + o] = (c == 0 ? 0.0f : curv[plane + o]) + cx;
  }
}

// vertical window sums of nq planes of the S band (in) down to the owned
// rows (out): the transposed sums of Q, and the curvature's window sum
__global__ void __launch_bounds__(WT)
wide_vertical_kernel(const float* __restrict__ in, float* __restrict__ out, int nq, VmSweepScalars s) {
  const int R = s.radius, w = s.w, nown = s.nown;
  const long long ns = s.nown + 2LL * R;
  const int x = blockIdx.x * CHAIN_TILE_COLS + threadIdx.x;
  const int j = blockIdx.y * CHAIN_TILE_ROWS + threadIdx.y;
  if (x >= w || j >= nown) return;
  for (int q = 0; q < nq; ++q) {
    const float* col = in + (size_t)q * ns * w + x;
    float acc = 0.0f;
    for (int t = 0; t <= 2 * R; ++t) acc += __ldg(s.taps + t) * col[(size_t)(j + t) * w];
    out[((size_t)q * nown + j) * w + x] = acc;
  }
}

// the horizontal transposed sums at the owned pixels, chained through dw0
// and dw1 of channel c into the SSIM gradient (summed over the channels)
template <class PT>
__global__ void __launch_bounds__(WT)
wide_chain_kernel(const PT* __restrict__ planes, const float* __restrict__ A,
                  const float* __restrict__ VQ, float* __restrict__ gs, int c, VmSweepScalars s) {
  const int R = s.radius, w = s.w, C = s.C, nown = s.nown;
  const long long na = s.nown + 4LL * R;
  const int x = blockIdx.x * CHAIN_TILE_COLS + threadIdx.x;
  const int j = blockIdx.y * CHAIN_TILE_ROWS + threadIdx.y;
  if (x >= w || j >= nown) return;
  float tq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) tq[q] = wide_hsum(VQ + ((size_t)q * nown + j) * w, x, w, s.taps, R);
  const float a0 = A[(size_t)(j + 2 * R) * w + x], a1 = A[((size_t)na + j + 2 * R) * w + x];
  const size_t hw = (size_t)s.h * w, p = (size_t)(s.own0 + j) * w + x;
  const float d0y = ld(planes + (2 * C + 2 * c) * hw + p), d0x = ld(planes + (2 * C + 2 * c + 1) * hw + p);
  const float d1y = ld(planes + (4 * C + 2 * c) * hw + p), d1x = ld(planes + (4 * C + 2 * c + 1) * hw + p);
  const float g0 = tq[0] + 2.0f * a0 * tq[2] + a1 * tq[3];
  const float g1 = tq[1] + 2.0f * a1 * tq[2] + a0 * tq[3];
  const size_t o = (size_t)j * w + x, plane = (size_t)nown * w;
  gs[o] = (c == 0 ? 0.0f : gs[o]) + (-g0 * d0y + g1 * d1y);
  gs[plane + o] = (c == 0 ? 0.0f : gs[plane + o]) + (-g0 * d0x + g1 * d1x);
}

// one tile of CHAIN_TILE_ROWS x CHAIN_TILE_COLS owned pixels: the TPS, UI and
// TC terms; with the gradient also the TPS adjoint, the outputs and the
// preconditioner (the curvature's horizontal sums from vc); the tile's
// energy partials by a fixed-order tree
template <bool WITH_GRAD, class PT>
__global__ void __launch_bounds__(WT)
wide_final_kernel(const float* __restrict__ v, const PT* __restrict__ ui_w,
                  const PT* __restrict__ ui_v, const PT* __restrict__ tc_w,
                  const PT* __restrict__ tc_v, const float* __restrict__ es,
                  const float* __restrict__ gs, const float* __restrict__ vc,
                  float* __restrict__ grad, float* __restrict__ precond,
                  float* __restrict__ partials, VmSweepScalars s) {
  const int R = s.radius, w = s.w, h = s.h, nown = s.nown;
  const int tid = threadIdx.y * CHAIN_TILE_COLS + threadIdx.x;
  const int x = blockIdx.x * CHAIN_TILE_COLS + threadIdx.x;
  const int j = blockIdx.y * CHAIN_TILE_ROWS + threadIdx.y;
  float e_sim = 0.f, e_tps = 0.f, e_ui = 0.f, e_tc = 0.f;
  if (x < w && j < nown) {
    const int y = s.own0 + j;
    const size_t q = (size_t)j * w + x;  // in the owned-row maps and outputs
    e_sim = es[q];
    const float uw = ld(ui_w + q), tw = ld(tc_w + q);
    float gk[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      // component k of v (zero outside the arrays) and its maps at (yy, xx)
      auto vt_at = [&](int yy, int xx) {
        return yy >= 0 && yy < h && xx >= 0 && xx < w ? v[2 * ((size_t)yy * w + xx) + k] : 0.0f;
      };
      auto maps_at = [&](int yy, int xx, float& vxx, float& vxy, float& vyy) {
        tps_maps_at([&](int dy, int dx) { return vt_at(yy + dy, xx + dx); }, yy, xx, s, vxx, vxy, vyy);
      };
      float vxx, vxy, vyy;
      maps_at(y, x, vxx, vxy, vyy);
      e_tps += tps_energy(vxx, vxy, vyy);
      const QuadDiff d = quad_terms(vt_at(y, x), ld(ui_v + 2 * q + k), ld(tc_v + 2 * q + k), uw, tw, e_ui, e_tc);
      if constexpr (WITH_GRAD) {
        // self-adjoint stencils of the three maps (descent.py tps_adj_*)
        float l_xx, r_xx, u_yy, d_yy, m0, m1, m2, m3, unused0, unused1;
        maps_at(y, x - 1, l_xx, unused0, unused1);
        maps_at(y, x + 1, r_xx, unused0, unused1);
        maps_at(y - 1, x, unused0, unused1, u_yy);
        maps_at(y + 1, x, unused0, unused1, d_yy);
        maps_at(y - 1, x - 1, unused0, m0, unused1);
        maps_at(y - 1, x + 1, unused0, m1, unused1);
        maps_at(y + 1, x - 1, unused0, m2, unused1);
        maps_at(y + 1, x + 1, unused0, m3, unused1);
        float adj_xx = l_xx - 2.0f * vxx + r_xx;
        float adj_yy = u_yy - 2.0f * vyy + d_yy;
        float adj_xy = 0.25f * (m0 - m1 - m2 + m3);
        float g_tps = 2.0f * adj_xx + 4.0f * adj_xy + 2.0f * adj_yy;
        gk[k] = gs[(size_t)k * nown * w + q] + s.lam_n * g_tps + s.gui_n * uw * d.ui + s.gtc_n * tw * d.tc;
      }
    }
    if constexpr (WITH_GRAD) {
      const float pc_y = wide_hsum(vc + (size_t)j * w, x, w, s.taps, R);
      const float pc_x = wide_hsum(vc + ((size_t)nown + j) * w, x, w, s.taps, R);
      float p_rest = s.ptps + s.pquad_n * (s.gamma_ui * uw + s.beta_tc * tw);
      reinterpret_cast<float2*>(grad)[q] = make_float2(gk[0], gk[1]);
      reinterpret_cast<float2*>(precond)[q] =
          make_float2(s.psim_n * pc_y + p_rest + s.eps_n, s.psim_n * pc_x + p_rest + s.eps_n);
    }
  }
  __shared__ float sred[4][WT];
  sred[0][tid] = e_sim;
  sred[1][tid] = e_tps;
  sred[2][tid] = e_ui;
  sred[3][tid] = e_tc;
  __syncthreads();
  for (int stride = WT / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int q = 0; q < 4; ++q) sred[q][tid] += sred[q][tid + stride];
    }
    __syncthreads();
  }
  if (tid < 4) partials[4 * (blockIdx.y * gridDim.x + blockIdx.x) + tid] = sred[tid][0];
}

// Kernels 1 (WITH_GRAD) and 2 from R = 8 to WIDE_MAX_RADIUS, the radius
// read at run time: one strip of WIDE_STRIP_ROWS (WIDE_ENERGY_STRIP_ROWS)
// x WIDE_STRIP_COLS owned pixels, walked WIDE_STEP_ROWS rows a step per
// channel as
// sweep_grad_strip_kernel walks its strip (the geometry is wide_geo's). The
// taps sit in shared memory between WIDE_TPAD zeros each side, so a window
// pass that gives P neighbouring outputs from the P + 2R inputs they share
// reads tap u - j for input u and output j without a test: the zero taps
// add exact zeros (every ring and map slot holds a finite value, zeroed
// before the walk), and each output keeps its sum over t = 0..K-1 in
// order. A thread owns one pixel of a step. The energy form (WITH_GRAD
// false) stops after the SSIM: no coefficient maps, transposed sums, chain
// or curvature, so its statistics need no halo.
template <bool WITH_GRAD, class PT>
__global__ void __launch_bounds__(NT, WITH_GRAD ? 2 : 4)
sweep_wide_kernel(const PT* __restrict__ planes, const float* __restrict__ v_lin,
                  const float* __restrict__ v, const PT* __restrict__ ui_w,
                  const PT* __restrict__ ui_v, const PT* __restrict__ tc_w,
                  const PT* __restrict__ tc_v, float* __restrict__ grad,
                  float* __restrict__ precond, float* __restrict__ partials, VmSweepScalars s) {
  constexpr int SC = WIDE_STRIP_COLS, RB = WIDE_STEP_ROWS, P = 2;  // P: outputs of a window pass's item
  constexpr int ROWS = WITH_GRAD ? WIDE_STRIP_ROWS : WIDE_ENERGY_STRIP_ROWS;
  constexpr int VX = SC + 4, NV = (RB + 4) * VX, MX = SC + 2, NM = (RB + 2) * MX;
  const int R = s.radius;
  const WGeo G = wide_geo(R, WITH_GRAD);
  const int K = G.K, HS = G.HS, HA = G.HA, SW = G.SW, SWP = G.SWP, AWP = G.AWP, DR = G.DR, NST = G.NST,
            SAW = G.SAW;

  extern __shared__ float4 wsmem4[];
  float* const sm = reinterpret_cast<float*>(wsmem4);
  float* const sTap = sm + G.tz + WIDE_TPAD;  // sTap[t] = taps[t], zero for t in [-WIDE_TPAD, 0) and past K
  float* const sNy = sm + G.ny;               // row tap sums from row y0 - HS
  float* const sNx = sm + G.nx;               // column tap sums from column x0 - HS
  float* const sStage = sm + G.stage;         // 10 planes of NST: the step's inputs
  float* const sA = sm + G.a;                 // a0, a1 ring (DR rows of AWP each)
  float* const sQ = sm + G.q;                 // coefficient ring (6 x DR rows of SWP)
  float* const sX = sm + G.x;                 // a step's vertical sums; v tile and maps; the reduction

  const int h = s.h, w = s.w, C = s.C;
  const size_t hw = (size_t)h * w;
  const int tid = threadIdx.x;
  const int y0 = s.own0 + blockIdx.y * ROWS, x0 = blockIdx.x * SC;
  const int nrow = min(ROWS, s.own0 + s.nown - y0);  // owned rows of this strip
  const int ya = y0 - HA;                                        // the arrays' row of walk row 0
  const int nstep = cdiv(nrow + 2 * HA, RB);
  const int ro = tid / SC, jo = tid % SC;  // this thread's owned pixel of a step: row ro, column jo
  const unsigned hb = (unsigned)hw & 1u;   // bf16: an odd plane flips its elements' parity

  // every slot zero (rings and maps read before a step writes them feed
  // only zero taps), then the taps and the tap-sum tables of the in-image
  // window: 1/n of a statistics pixel is 1 / (sNy[row] sNx[column])
  for (int i = tid; i < G.floats / 4; i += NT) wsmem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  for (int i = tid; i < K; i += NT) sTap[i] = s.taps[i];
  for (int i = tid; i < ROWS + 2 * HS + SW; i += NT) {
    if (i < ROWS + 2 * HS) {
      const int y = y0 - HS + i;
      if (i < nrow + 2 * HS && row_in(s, y)) sNy[i] = tap_sum_range(s.taps, R, y + s.row0, s.gh);
    } else {
      const int j = i - (ROWS + 2 * HS), x = x0 - HS + j;
      if (x >= 0 && x < w) sNx[j] = tap_sum_range(s.taps, R, x, w);
    }
  }

  // a step's staging: chunks of 4 neighbouring staged columns of one row,
  // the first at column x0 - AO + 4 (ch % (SAW / 4)), thread tid holding
  // chunks tid, tid + NT, ... (sweep_grad_strip_kernel's copies: 16-byte,
  // or 8-byte in the bf16 form, where the width and the pointers allow)
  const bool vec = (w & 3) == 0 &&
                   (std::is_same_v<PT, float> ? (((size_t)planes | (size_t)v | (size_t)v_lin) & 15) == 0
                                              : (((size_t)planes & 7) | (((size_t)v | (size_t)v_lin) & 15)) == 0);
  auto issue = [&](int c, int i) {
    const PT* const src[6] = {planes + (size_t)c * hw, planes + (size_t)(C + c) * hw,
                              planes + (size_t)(2 * C + 2 * c) * hw, planes + (size_t)(2 * C + 2 * c + 1) * hw,
                              planes + (size_t)(4 * C + 2 * c) * hw, planes + (size_t)(4 * C + 2 * c + 1) * hw};
    for (int ch = tid; ch < G.NCH; ch += NT) {
      const int ch_row = ch / (SAW / 4), ch_col = 4 * (ch % (SAW / 4));
      const int y = ya + i * RB + ch_row, x = x0 - G.AO + ch_col;
      const bool row_ok = row_in(s, y);
      const int e = ch_row * SAW + ch_col;  // the chunk's first staged pixel
      float* const pv = sStage + 6 * NST + 2 * e;
      float* const pl = sStage + 8 * NST + 2 * e;
      if (vec) {
        const bool in = row_ok && x >= 0 && x < w;
        const size_t p = in ? (size_t)y * w + x : 0;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          if constexpr (std::is_same_v<PT, float>) cp_async16(sStage + k * NST + e, src[k] + p, in);
          else cp_async8(sStage + k * NST + e, src[k] + p, in);
        }
        cp_async16(pv, v + 2 * p, in);
        cp_async16(pv + 4, v + 2 * p + 4, in);
        cp_async16(pl, v_lin + 2 * p, in);
        cp_async16(pl + 4, v_lin + 2 * p + 4, in);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const bool in = row_ok && x + m >= 0 && x + m < w;
          const size_t p = in ? (size_t)y * w + x + m : 0;
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            if constexpr (std::is_same_v<PT, float>) cp_async4(sStage + k * NST + e + m, src[k] + p, in);
            else cp_async4(sStage + k * NST + e + m, bf16_word(src[k] + p), in);
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            cp_async4(pv + 2 * m + k, v + 2 * p + k, in);
            cp_async4(pl + 2 * m + k, v_lin + 2 * p + k, in);
          }
        }
      }
    }
    cp_async_commit();
  };
  __syncthreads();  // the zeros are in before any copy lands
  issue(0, 0);
  // dw0 y, dw0 x, dw1 y, dw1 x (k = 0..3) of channel c at pixel p
  auto dw_at = [&](int c, int k, size_t p) {
    return ldg(planes + (size_t)((k < 2 ? 2 : 4) * C + 2 * c + (k & 1)) * hw + p);
  };

  float e_sim = 0.0f, e_tps = 0.0f, e_ui = 0.0f, e_tc = 0.0f;
  for (int c = 0; c < C; ++c) {
    for (int i = 0; i < nstep; ++i) {
      const int u0 = i * RB;  // walk row of the step's first staged row
      // the step's statistics rows are walk rows u0 - R + r and its output
      // rows u0 - HA + r, r in [0, RB); the strip needs statistics rows
      // [R, R + nrow + 2 HS) and output rows [HA, HA + nrow)
      const int s_lo = max(0, 2 * R - u0), o_lo = max(0, 2 * HA - u0), r_hi = min(RB, nrow + 2 * HA - u0);
      // 1. a0 = w0 - dw0.dv, a1 = w1 + dw1.dv into the ring (zero outside the
      // image); a thread reads back only its own chunks' copies
      cp_async_wait_all();
      for (int ch = tid; ch < G.NCH; ch += NT) {
        const int ch_row = ch / (SAW / 4), ch_col = 4 * (ch % (SAW / 4));
        const int e = ch_row * SAW + ch_col, slot = ((u0 + ch_row) % DR) * AWP;
        // bf16: the parity of the chunk's element 0 in each plane, from its
        // row's y w (the same every step: a step moves RB rows, an even
        // count; x is a multiple of 4) and the plane's offset
        const unsigned pr = (unsigned)(ya + ch_row) & (unsigned)w & 1u;
        const unsigned s0 = half_sel(pr ^ ((unsigned)c & hb)), s1 = half_sel(pr ^ ((unsigned)(C + c) & hb)),
                       sy = half_sel(pr), sx = half_sel(pr ^ hb);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int j = ch_col + m - (G.AO - HA);  // the ring's column
          if (j < 0 || j >= AWP) continue;
          const float* const sv = sStage + 6 * NST + 2 * (e + m);
          const float dvy = sv[0] - sv[2 * NST], dvx = sv[1] - sv[2 * NST + 1];
          if constexpr (std::is_same_v<PT, float>) {
            const float* const st = sStage + e + m;
            sA[slot + j] = st[0] - (st[2 * NST] * dvy + st[3 * NST] * dvx);
            sA[DR * AWP + slot + j] = st[NST] + (st[4 * NST] * dvy + st[5 * NST] * dvx);
          } else {
            const float* const st = sStage + e + (vec ? m >> 1 : m);
            const unsigned o = (m & 1) ? SEL_FLIP : 0u;  // element m's parity is element 0's, flipped on odd m
            sA[slot + j] = slot_value<PT>(st[0], s0 ^ o) -
                           (slot_value<PT>(st[2 * NST], sy ^ o) * dvy + slot_value<PT>(st[3 * NST], sx ^ o) * dvx);
            sA[DR * AWP + slot + j] = slot_value<PT>(st[NST], s1 ^ o) +
                                      (slot_value<PT>(st[4 * NST], sy ^ o) * dvy + slot_value<PT>(st[5 * NST], sx ^ o) * dvx);
          }
        }
      }
      {
        const bool next_c = i + 1 == nstep;  // the next step is the next channel's first
        if (!next_c || c + 1 < C) issue(next_c ? c + 1 : c, next_c ? 0 : i + 1);
      }
      __syncthreads();

      // 2a. vertical window sums of a0, a1, a0^2, a1^2, a0 a1 at the step's
      // statistics rows (walk rows u0 - R + r read ring rows u0 - 2R + r + t)
      if (s_lo < r_hi) {
        for (int it = tid; it < (RB / P) * AWP; it += NT) {
          const int r0 = (it / AWP) * P, j = it % AWP;
          if (r0 + P <= s_lo || r0 >= r_hi) continue;
          float acc[P][5];
#pragma unroll
          for (int jj = 0; jj < P; ++jj)
#pragma unroll
            for (int q = 0; q < 5; ++q) acc[jj][q] = 0.0f;
          int slot = (u0 - 2 * R + r0 + 2 * DR) % DR;  // ring row of walk row u0 - 2R + r0
          for (int uu = 0; uu < P + 2 * R; ++uu, slot = slot + 1 == DR ? 0 : slot + 1) {
            const float a = sA[slot * AWP + j], b = sA[(DR + slot) * AWP + j];
            const float aa = a * a, bb = b * b, ab = a * b;
#pragma unroll
            for (int jj = 0; jj < P; ++jj) {
              const float tp = sTap[uu - jj];
              acc[jj][0] += tp * a;
              acc[jj][1] += tp * b;
              acc[jj][2] += tp * aa;
              acc[jj][3] += tp * bb;
              acc[jj][4] += tp * ab;
            }
          }
#pragma unroll
          for (int jj = 0; jj < P; ++jj)
#pragma unroll
            for (int q = 0; q < 5; ++q) sX[(q * RB + r0 + jj) * AWP + j] = acc[jj][q];
        }
      }
      __syncthreads();

      // 2b. horizontal sums -> statistics and SSIM of the statistics rows;
      // with the gradient also the coefficient maps and the curvature terms
      // into their ring; P neighbouring pixels an item
      if (s_lo < r_hi) {
        for (int it = tid; it < (r_hi - s_lo) * (SWP / P); it += NT) {
          const int r = s_lo + it / (SWP / P), c0 = P * (it % (SWP / P));
          const int q = u0 - R + r, y = ya + q;  // walk row and array row
          const bool row_ok = row_in(s, y);
          float dw[P][4];  // the gradient's dw of the P pixels, in flight during the window sums
          if constexpr (WITH_GRAD) {
#pragma unroll
            for (int j = 0; j < P; ++j) {
              const int x = x0 - HS + c0 + j;
              const size_t p = row_ok && x >= 0 && x < w ? (size_t)y * w + x : 0;
#pragma unroll
              for (int k = 0; k < 4; ++k) dw[j][k] = dw_at(c, k, p);
            }
          }
          float st[P][5];
#pragma unroll
          for (int j = 0; j < P; ++j)
#pragma unroll
            for (int qq = 0; qq < 5; ++qq) st[j][qq] = 0.0f;
          const float* const xr = sX + r * AWP + c0;
          for (int u = 0; u < P + 2 * R; ++u) {
            float xv[5];
#pragma unroll
            for (int qq = 0; qq < 5; ++qq) xv[qq] = xr[qq * RB * AWP + u];
#pragma unroll
            for (int j = 0; j < P; ++j) {
              const float tp = sTap[u - j];
#pragma unroll
              for (int qq = 0; qq < 5; ++qq) st[j][qq] += tp * xv[qq];
            }
          }
          float out[6][P];
#pragma unroll
          for (int j = 0; j < P; ++j) {
            const int js = c0 + j, x = x0 - HS + js;
#pragma unroll
            for (int qq = 0; qq < 6; ++qq) out[qq][j] = 0.0f;
            if (row_ok && js < SW && x >= 0 && x < w) {
              const float inv_n = pack_round<PT>(1.0f / (sNy[q - R] * sNx[js]));
              const SsimPixel sp = ssim_pixel(st[j], inv_n, s);
              if (q >= HA && q < HA + nrow && js >= HS && js < HS + SC) e_sim += 1.0f - sp.ssim;
              if constexpr (WITH_GRAD) {
                const SsimCoeffs k = ssim_coeffs(sp, inv_n, s);
                const float d0y = dw[j][0], d0x = dw[j][1], d1y = dw[j][2], d1x = dw[j][3];
                out[0][j] = k.q0;
                out[1][j] = k.q1;
                out[2][j] = k.qv;
                out[3][j] = k.qc;
                out[4][j] = (d0y * d0y + d1y * d1y) * k.ib2;
                out[5][j] = (d0x * d0x + d1x * d1x) * k.ib2;
              }
            }
          }
          if constexpr (WITH_GRAD) {
#pragma unroll
            for (int qq = 0; qq < 6; ++qq)
#pragma unroll
              for (int j = 0; j < P; ++j) sQ[(qq * DR + q % DR) * SWP + c0 + j] = out[qq][j];
          }
        }
      }
      __syncthreads();

      const int o = u0 - HA + ro, y = ya + o;  // walk row and array row of this thread's pixel
      const bool mine = o_lo <= ro && ro < r_hi;
      const bool last = c + 1 == C && o_lo < r_hi;
      const int x = x0 + jo;
      const bool own = mine && x < w;
      const size_t p = own ? (size_t)y * w + x : 0, qpix = own ? (size_t)(y - s.own0) * w + x : 0;
      float gs[2] = {0.0f, 0.0f}, pc[2] = {0.0f, 0.0f};  // the SSIM gradient and the curvature's sums, (y, x)
      if constexpr (WITH_GRAD) {
        // 3a. vertical transposed window sums at the step's output rows (walk
        // rows u0 - 2R + r read coefficient rows u0 - 3R + r + t; into sX: the
        // statistics' sums are consumed)
        if (o_lo < r_hi) {
          for (int it = tid; it < (RB / P) * SWP; it += NT) {
            const int r0 = (it / SWP) * P, j = it % SWP;
            if (r0 + P <= o_lo || r0 >= r_hi) continue;
            float acc[P][6];
#pragma unroll
            for (int jj = 0; jj < P; ++jj)
#pragma unroll
              for (int qq = 0; qq < 6; ++qq) acc[jj][qq] = 0.0f;
            int slot = (u0 - 3 * R + r0 + 2 * DR) % DR;  // ring row of walk row u0 - 3R + r0
            for (int uu = 0; uu < P + 2 * R; ++uu, slot = slot + 1 == DR ? 0 : slot + 1) {
              float xq[6];
#pragma unroll
              for (int qq = 0; qq < 6; ++qq) xq[qq] = sQ[(qq * DR + slot) * SWP + j];
#pragma unroll
              for (int jj = 0; jj < P; ++jj) {
                const float tp = sTap[uu - jj];
#pragma unroll
                for (int qq = 0; qq < 6; ++qq) acc[jj][qq] += tp * xq[qq];
              }
            }
#pragma unroll
            for (int jj = 0; jj < P; ++jj)
#pragma unroll
              for (int qq = 0; qq < 6; ++qq) sX[(qq * RB + r0 + jj) * SWP + j] = acc[jj][qq];
          }
        }
        // this thread's pixel of 3b: its a0, a1, read before the barrier (the
        // next step's stage 1 writes their ring row with no barrier between),
        // and its dw, in flight across it
        float a0c = 0.0f, a1c = 0.0f, dw[4];
        if (mine) {
          const int a = (o % DR) * AWP + jo + HA;
          a0c = sA[a];
          a1c = sA[DR * AWP + a];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) dw[k] = dw_at(c, k, p);
        __syncthreads();
        // 3b. horizontal sums at the owned pixel; chain through dw0 / dw1; the
        // SSIM gradient and the curvature's sums with the earlier channels'
        if (own) {
          float tq[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          const float* const xr = sX + ro * SWP + jo;
          for (int t = 0; t < K; ++t) {
            const float tp = sTap[t];
#pragma unroll
            for (int qq = 0; qq < 6; ++qq) tq[qq] += tp * xr[qq * RB * SWP + t];
          }
          const float g0 = tq[0] + 2.0f * a0c * tq[2] + a1c * tq[3];
          const float g1 = tq[1] + 2.0f * a1c * tq[2] + a0c * tq[3];
          gs[0] = -g0 * dw[0] + g1 * dw[2];
          gs[1] = -g0 * dw[1] + g1 * dw[3];
          pc[0] = tq[4];
          pc[1] = tq[5];
          if (c > 0) {
            const float2 g = reinterpret_cast<const float2*>(grad)[qpix];
            const float2 pp = reinterpret_cast<const float2*>(precond)[qpix];
            gs[0] = g.x + gs[0];
            gs[1] = g.y + gs[1];
            pc[0] = pp.x + pc[0];
            pc[1] = pp.y + pc[1];
          }
          if (c + 1 < C) {
            reinterpret_cast<float2*>(grad)[qpix] = make_float2(gs[0], gs[1]);
            reinterpret_cast<float2*>(precond)[qpix] = make_float2(pc[0], pc[1]);
          }
        }
      }
      if (!last) continue;

      // 4. last channel: the TPS maps of the output rows (with the gradient
      // also a ring of 1 for the adjoint) from a tile of v (zero outside the
      // arrays) in sX, the UI and TC terms, the outputs
      float uw = 0.0f, tw = 0.0f, uiv[2] = {0.0f, 0.0f}, tcv[2] = {0.0f, 0.0f}, vt_r[cdiv(NV, NT)][2];
      if (own) {
        uw = ld(ui_w + qpix);
        tw = ld(tc_w + qpix);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          uiv[k] = ld(ui_v + 2 * qpix + k);
          tcv[k] = ld(tc_v + 2 * qpix + k);
        }
      }
#pragma unroll
      for (int u = 0; u < cdiv(NV, NT); ++u) {
        const int e = tid + u * NT;
        const int yy = ya + u0 - HA - 2 + e / VX, xx = x0 - 2 + e % VX;
        const bool in = e < NV && yy >= 0 && yy < h && xx >= 0 && xx < w;
        const size_t pv = in ? (size_t)yy * w + xx : 0;
        vt_r[u][0] = in ? v[2 * pv] : 0.0f;
        vt_r[u][1] = in ? v[2 * pv + 1] : 0.0f;
      }
      __syncthreads();  // the window sums in sX are consumed
      float* const sVt = sX;          // v tile: rows y - 2 .., columns x0 - 2 ..
      float* const sM = sX + 2 * NV;  // maps: rows y - 1 .., columns x0 - 1 ..
#pragma unroll
      for (int u = 0; u < cdiv(NV, NT); ++u) {
        const int e = tid + u * NT;
        if (e < NV) {
          sVt[e] = vt_r[u][0];
          sVt[NV + e] = vt_r[u][1];
        }
      }
      __syncthreads();
      if constexpr (WITH_GRAD) {
        for (int e = tid; e < NM; e += NT) {
          const int r = e / MX, cx = e % MX;
          const int vi = (r + 1) * VX + cx + 1;
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float* vt = sVt + k * NV + vi;
            tps_maps_at([vt](int dy, int dx) { return vt[dy * VX + dx]; }, ya + u0 - HA - 1 + r, x0 - 1 + cx, s,
                        sM[(3 * k) * NM + e], sM[(3 * k + 1) * NM + e], sM[(3 * k + 2) * NM + e]);
          }
        }
        __syncthreads();
      }
      if (!own) continue;
      float gk[2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float vk = sVt[kk * NV + (ro + 2) * VX + jo + 2];
        const QuadDiff d = quad_terms(vk, uiv[kk], tcv[kk], uw, tw, e_ui, e_tc);
        if constexpr (WITH_GRAD) {
          const int m = (ro + 1) * MX + jo + 1;
          const float* Mxx = sM + (3 * kk) * NM;
          const float* Mxy = Mxx + NM;
          const float* Myy = Mxy + NM;
          const float vxx = Mxx[m], vxy = Mxy[m], vyy = Myy[m];
          e_tps += tps_energy(vxx, vxy, vyy);
          // self-adjoint stencils of the three maps (descent.py tps_adj_*)
          const float adj_xx = Mxx[m - 1] - 2.0f * vxx + Mxx[m + 1];
          const float adj_yy = Myy[m - MX] - 2.0f * vyy + Myy[m + MX];
          const float adj_xy = 0.25f * (Mxy[m - MX - 1] - Mxy[m - MX + 1] - Mxy[m + MX - 1] + Mxy[m + MX + 1]);
          const float g_tps = 2.0f * adj_xx + 4.0f * adj_xy + 2.0f * adj_yy;
          gk[kk] = gs[kk] + s.lam_n * g_tps + s.gui_n * uw * d.ui + s.gtc_n * tw * d.tc;
        } else {
          const float* vt = sVt + kk * NV + (ro + 2) * VX + jo + 2;
          float vxx, vxy, vyy;
          tps_maps_at([vt](int dy, int dx) { return vt[dy * VX + dx]; }, y, x, s, vxx, vxy, vyy);
          e_tps += tps_energy(vxx, vxy, vyy);
        }
      }
      if constexpr (WITH_GRAD) {
        const float p_rest = s.ptps + s.pquad_n * (s.gamma_ui * uw + s.beta_tc * tw);
        reinterpret_cast<float2*>(grad)[qpix] = make_float2(gk[0], gk[1]);
        reinterpret_cast<float2*>(precond)[qpix] =
            make_float2(s.psim_n * pc[0] + p_rest + s.eps_n, s.psim_n * pc[1] + p_rest + s.eps_n);
      }
    }
  }

  // fixed-order tree over the block (in sX: its last readers are done)
  __syncthreads();
  float* const sred = sX;
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
  if (tid < 4) partials[4 * (blockIdx.y * gridDim.x + blockIdx.x) + tid] = sred[tid * NT];
}

// Whether radius R has an instantiated kernel (the gradient's tile or
// strip, the energy kernel's tile or strip; R = 0 takes the tiles) rather
// than the wide strip or the per-pixel chain.
bool tiled(bool with_grad, int R) {
  return R >= 0 && R <= (with_grad ? STRIP_MAX_RADIUS : ENERGY_STRIP_MAX_RADIUS);
}

// Whether radius R runs the wide strip (sweep_wide_kernel): past the
// instantiated radii, up to its reach.
bool wide_strip(bool with_grad, int R) { return !tiled(with_grad, R) && R >= 0 && R <= WIDE_MAX_RADIUS; }

dim3 tile_grid(bool with_grad, int w, int nown, int R) {
  if (wide_strip(with_grad, R))
    return dim3(cdiv(w, WIDE_STRIP_COLS), cdiv(nown, with_grad ? WIDE_STRIP_ROWS : WIDE_ENERGY_STRIP_ROWS));
  if (!tiled(with_grad, R)) return dim3(cdiv(w, CHAIN_TILE_COLS), cdiv(nown, CHAIN_TILE_ROWS));
  if (with_grad && R >= STRIP_MIN_RADIUS) return dim3(cdiv(w, STRIP_COLS), cdiv(nown, STRIP_ROWS));
  if (with_grad) return dim3(cdiv(w, TX), cdiv(nown, TY));
  if (R >= ENERGY_STRIP_MIN_RADIUS)
    return dim3(cdiv(w, ENERGY_STRIP_WARPS * (32 - 2 * R)), cdiv(nown, ENERGY_STRIP_ROWS));
  return dim3(cdiv(w, ENERGY_TILE_COLS), cdiv(nown, ENERGY_TILE_ROWS));
}

// The instantiation for R: the gradient's tile (R < STRIP_MIN_RADIUS) or
// strip, or the energy kernel's tile (R < ENERGY_STRIP_MIN_RADIUS) or
// strip; its threads and dynamic shared memory.
template <int R, bool WITH_GRAD, class PT>
struct Instance {
  static constexpr bool STRIP = R >= (WITH_GRAD ? STRIP_MIN_RADIUS : ENERGY_STRIP_MIN_RADIUS);
  static constexpr int THREADS = WITH_GRAD ? NT : (STRIP ? 32 * ENERGY_STRIP_WARPS : ENT);
  static size_t bytes() {
    if constexpr (WITH_GRAD) return STRIP ? SGeo<R>::BYTES : Geo<R>::BYTES;
    else if constexpr (STRIP) return ESGeo<R>::BYTES;
    else return EGeo<R>::BYTES;
  }
  static const void* fn() {
    if constexpr (!WITH_GRAD && STRIP) return (const void*)sweep_energy_strip_kernel<R, PT>;
    else if constexpr (!WITH_GRAD) return (const void*)sweep_energy_kernel<R, PT>;
    else if constexpr (STRIP) return (const void*)sweep_grad_strip_kernel<R, PT>;
    else return (const void*)sweep_grad_kernel<R, PT>;
  }
};

// Opt kernel fn in to `bytes` of dynamic shared memory, once per device
// (a flag per Key).
template <class Key>
cudaError_t allow_smem_once(const void* fn, size_t bytes) {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

// Each instantiation's dynamic shared memory.
template <int R, bool WITH_GRAD, class PT>
cudaError_t allow_smem() {
  using I = Instance<R, WITH_GRAD, PT>;
  return allow_smem_once<I>(I::fn(), I::bytes());
}

// The wide strip's dynamic shared memory: that of its reach, the most any
// radius asks for.
template <bool WITH_GRAD, class PT>
struct WideStrip {
  static const void* fn() { return (const void*)sweep_wide_kernel<WITH_GRAD, PT>; }
  static size_t bytes(int R) { return sizeof(float) * (size_t)wide_geo(R, WITH_GRAD).floats; }
  static cudaError_t allow() { return allow_smem_once<WideStrip>(fn(), bytes(WIDE_MAX_RADIUS)); }
};

// planes and the UI/TC maps are of the instantiation's plane type PT
struct Args {
  const void *planes;
  const float *v_lin, *v;
  const void *ui_w, *ui_v, *tc_w, *tc_v;
  float *grad, *precond, *partials, *out, *scratch;
  int n_partials;
  long long n_scratch;
};

// The PT pointers of a launch: planes, ui_w, ui_v, tc_w, tc_v.
template <class PT>
struct Typed {
  const PT *planes, *ui_w, *ui_v, *tc_w, *tc_v;
  explicit Typed(const Args& a)
      : planes((const PT*)a.planes), ui_w((const PT*)a.ui_w), ui_v((const PT*)a.ui_v),
        tc_w((const PT*)a.tc_w), tc_v((const PT*)a.tc_v) {}
};

template <int R, bool WITH_GRAD, class PT>
int launch(const Args& a, const VmSweepScalars& s, cudaStream_t stream) {
  dim3 grid = tile_grid(WITH_GRAD, s.w, s.nown, R);
  if ((long long)grid.x * grid.y > a.n_partials) return (int)cudaErrorInvalidValue;
  // the energy kernel's plane offsets are ints
  if (!WITH_GRAD && 6LL * s.C * s.h * s.w > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<R, WITH_GRAD, PT>();
  if (err != cudaSuccess) return (int)err;
  const Typed<PT> t(a);
  constexpr bool STRIP = Instance<R, WITH_GRAD, PT>::STRIP;
  if constexpr (WITH_GRAD && STRIP)
    sweep_grad_strip_kernel<R, PT><<<grid, NT, SGeo<R>::BYTES, stream>>>(
        t.planes, a.v_lin, a.v, t.ui_w, t.ui_v, t.tc_w, t.tc_v, a.grad, a.precond, a.partials, s);
  else if constexpr (WITH_GRAD)
    sweep_grad_kernel<R, PT><<<grid, NT, Geo<R>::BYTES, stream>>>(
        t.planes, a.v_lin, a.v, t.ui_w, t.ui_v, t.tc_w, t.tc_v, a.grad, a.precond, a.partials, s);
  else if constexpr (STRIP)
    sweep_energy_strip_kernel<R, PT><<<grid, ESGeo<R>::THREADS, ESGeo<R>::BYTES, stream>>>(
        t.planes, a.v_lin, a.v, t.ui_w, t.ui_v, t.tc_w, t.tc_v, a.partials, s);
  else
    sweep_energy_kernel<R, PT><<<grid, ENT, EGeo<R>::BYTES, stream>>>(
        t.planes, a.v_lin, a.v, t.ui_w, t.ui_v, t.tc_w, t.tc_v, a.partials, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweep_reduce_kernel<<<1, RED, 0, stream>>>(a.partials, (int)(grid.x * grid.y), a.out, s);
  return (int)cudaGetLastError();
}

// The wide strip at the launch's radius, then the reduction.
template <bool WITH_GRAD, class PT>
int launch_wide_strip(const Args& a, const VmSweepScalars& s, cudaStream_t stream) {
  using W = WideStrip<WITH_GRAD, PT>;
  const dim3 grid = tile_grid(WITH_GRAD, s.w, s.nown, s.radius);
  if ((long long)grid.x * grid.y > a.n_partials) return (int)cudaErrorInvalidValue;
  cudaError_t err = W::allow();
  if (err != cudaSuccess) return (int)err;
  const Typed<PT> t(a);
  sweep_wide_kernel<WITH_GRAD, PT><<<grid, NT, W::bytes(s.radius), stream>>>(
      t.planes, a.v_lin, a.v, t.ui_w, t.ui_v, t.tc_w, t.tc_v, a.grad, a.precond, a.partials, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweep_reduce_kernel<<<1, RED, 0, stream>>>(a.partials, (int)(grid.x * grid.y), a.out, s);
  return (int)cudaGetLastError();
}

// The per-pixel chain: per channel its warps, statistics and SSIM (and,
// with the gradient, the transposed sums and the chain), then the tiles'
// terms and partials, then the reduction; all on `stream`, in order.
template <bool WITH_GRAD, class PT>
int launch_chain(const Args& a, const VmSweepScalars& s, cudaStream_t stream) {
  const int R = s.radius;
  const dim3 grid = tile_grid(WITH_GRAD, s.w, s.nown, R);
  const WideLayout L = wide_layout(s.w, s.nown, R, WITH_GRAD);
  if ((long long)grid.x * grid.y > a.n_partials || a.n_scratch < L.total) return (int)cudaErrorInvalidValue;
  const dim3 block(CHAIN_TILE_COLS, CHAIN_TILE_ROWS);
  auto band = [&](long long rows) { return dim3(cdiv(s.w, CHAIN_TILE_COLS), (unsigned)cdiv((int)rows, CHAIN_TILE_ROWS)); };
  float* const A = a.scratch + L.a;
  float* const V = a.scratch + L.v;  // after each channel's SSIM: the transposed sums; at last the curvature's
  float* const es = a.scratch + L.es;
  float* const Q = a.scratch + L.q;
  float* const curv = a.scratch + L.curv;
  float* const gs = a.scratch + L.gs;
  const Typed<PT> t(a);
  for (int c = 0; c < s.C; ++c) {
    wide_warps_kernel<PT><<<band(L.na), block, 0, stream>>>(t.planes, a.v_lin, a.v, A, c, s);
    wide_stats_vertical_kernel<<<band(L.ns), block, 0, stream>>>(A, V, s);
    wide_ssim_kernel<WITH_GRAD, PT><<<band(L.ns), block, 0, stream>>>(t.planes, V, Q, curv, es, c, s);
    if constexpr (WITH_GRAD) {
      wide_vertical_kernel<<<band(s.nown), block, 0, stream>>>(Q, V, 4, s);
      wide_chain_kernel<PT><<<band(s.nown), block, 0, stream>>>(t.planes, A, V, gs, c, s);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if constexpr (WITH_GRAD) wide_vertical_kernel<<<band(s.nown), block, 0, stream>>>(curv, V, 2, s);
  wide_final_kernel<WITH_GRAD, PT><<<grid, block, 0, stream>>>(a.v, t.ui_w, t.ui_v, t.tc_w, t.tc_v, es, gs, V,
                                                              a.grad, a.precond, a.partials, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sweep_reduce_kernel<<<1, RED, 0, stream>>>(a.partials, (int)(grid.x * grid.y), a.out, s);
  return (int)cudaGetLastError();
}

// Returns f.template operator()<R>() for the instantiated radius R of the
// gradient (WITH_GRAD) or the energy kernel, and other() for any other
// radius.
template <bool WITH_GRAD, class F, class W>
int at_radius(int R, const F& f, const W& other) {
  if (!tiled(WITH_GRAD, R)) return other();
  switch (R) {
    case 0: return f.template operator()<0>();
    case 1: return f.template operator()<1>();
    case 2: return f.template operator()<2>();
    case 3: return f.template operator()<3>();
    case 4: return f.template operator()<4>();
    case 5: return f.template operator()<5>();
    case 6: return f.template operator()<6>();
    case 7: return f.template operator()<7>();
  }
  return (int)cudaErrorInvalidValue;  // not reached
}
static_assert(STRIP_MAX_RADIUS == 7 && ENERGY_STRIP_MAX_RADIUS == 7,
              "at_radius() instantiates R = 0 .. 7 of both kernels");

template <bool WITH_GRAD, class PT>
struct LaunchAt {
  const Args& a;
  const VmSweepScalars& s;
  cudaStream_t st;
  template <int R>
  int operator()() const { return launch<R, WITH_GRAD, PT>(a, s, st); }
};

// The launch for the window radius: an instantiated kernel where tiled(),
// the wide strip up to its reach, the per-pixel chain past it; PT is the
// planes' and maps' type. A failed launch returns its error.
template <bool WITH_GRAD, class PT>
int dispatch(const Args& a, const VmSweepScalars* s, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (s->radius < 0) return (int)cudaErrorInvalidValue;
  if (wide_strip(WITH_GRAD, s->radius)) return launch_wide_strip<WITH_GRAD, PT>(a, *s, st);
  return at_radius<WITH_GRAD>(s->radius, LaunchAt<WITH_GRAD, PT>{a, *s, st},
                              [&]() { return launch_chain<WITH_GRAD, PT>(a, *s, st); });
}

// Registers, static and dynamic shared memory, local (spill) bytes and
// resident blocks per SM of one kernel at `threads` per block.
cudaError_t func_info(const void* fn, int threads, size_t dyn, int* info) {
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, dyn);
  if (err != cudaSuccess) return err;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)dyn;
  info[3] = (int)a.localSizeBytes;
  info[4] = blocks;
  return cudaSuccess;
}

template <int R, bool WITH_GRAD, class PT>
int kernel_info(int* info) {
  using I = Instance<R, WITH_GRAD, PT>;
  cudaError_t err = allow_smem<R, WITH_GRAD, PT>();
  if (err == cudaSuccess) err = func_info(I::fn(), I::THREADS, I::bytes(), info);
  info[5] = I::THREADS;
  return (int)err;
}

template <bool WITH_GRAD, class PT>
struct InfoAt {
  int* info;
  template <int R>
  int operator()() const { return kernel_info<R, WITH_GRAD, PT>(info); }
};

// The per-pixel chain's kernels: the most registers, shared and local
// memory and the fewest resident blocks of any of them.
template <class PT>
int chain_kernel_info(bool with_grad, int* info) {
  const void* grad_fns[] = {(const void*)wide_warps_kernel<PT>, (const void*)wide_stats_vertical_kernel,
                            (const void*)wide_ssim_kernel<true, PT>, (const void*)wide_vertical_kernel,
                            (const void*)wide_chain_kernel<PT>, (const void*)wide_final_kernel<true, PT>};
  const void* energy_fns[] = {(const void*)wide_warps_kernel<PT>, (const void*)wide_stats_vertical_kernel,
                              (const void*)wide_ssim_kernel<false, PT>, (const void*)wide_final_kernel<false, PT>};
  const void* const* fns = with_grad ? grad_fns : energy_fns;
  const int n = with_grad ? 6 : 4;
  int one[5];
  for (int i = 0; i < n; ++i) {
    cudaError_t err = func_info(fns[i], WT, 0, one);
    if (err != cudaSuccess) return (int)err;
    if (i == 0) {
      for (int k = 0; k < 5; ++k) info[k] = one[k];
    } else {
      for (int k = 0; k < 4; ++k) info[k] = info[k] > one[k] ? info[k] : one[k];
      info[4] = info[4] < one[4] ? info[4] : one[4];
    }
  }
  info[5] = WT;
  return 0;
}

}  // namespace

// The number of blocks, and so of (sim, tps, ui, tc) partial sets, of a
// launch of the gradient (with_grad) or the energy kernel over nown owned
// rows of width w at a window radius.
extern "C" int vm_sweep_n_partials(int w, int nown, int with_grad, int radius) {
  dim3 grid = tile_grid(with_grad != 0, w, nown, radius);
  return (int)(grid.x * grid.y);
}

// Floats of scratch a launch needs (the per-pixel chain's intermediates;
// 0 for the instantiated kernels and the wide strip).
extern "C" long long vm_sweep_scratch_floats(int w, int nown, int with_grad, int radius) {
  const bool g = with_grad != 0;
  return tiled(g, radius) || wide_strip(g, radius) ? 0 : wide_layout(w, nown, radius, g).total;
}

namespace {
template <bool WITH_GRAD, class PT>
int wide_strip_info(int radius, int* info) {
  using W = WideStrip<WITH_GRAD, PT>;
  cudaError_t err = W::allow();
  if (err == cudaSuccess) err = func_info(W::fn(), NT, W::bytes(radius), info);
  info[5] = NT;
  return (int)err;
}

template <class PT>
int kernel_info_of(int radius, int with_grad, int* info) {
  auto chain = [&]() { return chain_kernel_info<PT>(with_grad != 0, info); };
  if (with_grad) {
    if (wide_strip(true, radius)) return wide_strip_info<true, PT>(radius, info);
    return at_radius<true>(radius, InfoAt<true, PT>{info}, chain);
  }
  if (wide_strip(false, radius)) return wide_strip_info<false, PT>(radius, info);
  return at_radius<false>(radius, InfoAt<false, PT>{info}, chain);
}
}  // namespace

// info[0..5]: registers per thread, static shared memory, dynamic shared
// memory (bytes), local memory (bytes), resident blocks per SM and threads
// per block of the gradient (with_grad) or energy kernel at a window radius
// (for the per-pixel chain, the extremes over its kernels), in its float
// (bf16 = 0) or bf16 instantiation; returns the CUDA error.
extern "C" int vm_sweep_kernel_info(int radius, int with_grad, int bf16, int* info) {
  if (radius < 0) return (int)cudaErrorInvalidValue;
  return bf16 ? kernel_info_of<__nv_bfloat16>(radius, with_grad, info)
              : kernel_info_of<float>(radius, with_grad, info);
}

// partials holds n_partials sets of 4 floats and scratch n_scratch floats
// (vm_sweep_scratch_floats); a launch that needs more returns
// cudaErrorInvalidValue without running.
extern "C" int vm_sweep_grad(const float* planes, const float* v_lin, const float* v,
                             const float* ui_w, const float* ui_v, const float* tc_w,
                             const float* tc_v, float* grad, float* precond, float* partials,
                             int n_partials, float* scratch, long long n_scratch, float* out,
                             const VmSweepScalars* s, void* stream) {
  const Args a{planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, grad, precond, partials, out, scratch,
               n_partials, n_scratch};
  return dispatch<true, float>(a, s, stream);
}

extern "C" int vm_sweep_energy(const float* planes, const float* v_lin, const float* v,
                               const float* ui_w, const float* ui_v, const float* tc_w,
                               const float* tc_v, float* partials, int n_partials, float* scratch,
                               long long n_scratch, float* out, const VmSweepScalars* s,
                               void* stream) {
  const Args a{planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, nullptr, nullptr, partials, out, scratch,
               n_partials, n_scratch};
  return dispatch<false, float>(a, s, stream);
}

// The bf16 form: planes and the UI/TC maps in bfloat16, everything else as
// vm_sweep_grad / vm_sweep_energy.
extern "C" int vm_sweep_grad_bf16(const __nv_bfloat16* planes, const float* v_lin, const float* v,
                                  const __nv_bfloat16* ui_w, const __nv_bfloat16* ui_v,
                                  const __nv_bfloat16* tc_w, const __nv_bfloat16* tc_v, float* grad,
                                  float* precond, float* partials, int n_partials, float* scratch,
                                  long long n_scratch, float* out, const VmSweepScalars* s, void* stream) {
  const Args a{planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, grad, precond, partials, out, scratch,
               n_partials, n_scratch};
  return dispatch<true, __nv_bfloat16>(a, s, stream);
}

extern "C" int vm_sweep_energy_bf16(const __nv_bfloat16* planes, const float* v_lin, const float* v,
                                    const __nv_bfloat16* ui_w, const __nv_bfloat16* ui_v,
                                    const __nv_bfloat16* tc_w, const __nv_bfloat16* tc_v,
                                    float* partials, int n_partials, float* scratch, long long n_scratch,
                                    float* out, const VmSweepScalars* s, void* stream) {
  const Args a{planes, v_lin, v, ui_w, ui_v, tc_w, tc_v, nullptr, nullptr, partials, out, scratch,
               n_partials, n_scratch};
  return dispatch<false, __nv_bfloat16>(a, s, stream);
}
