// Tap-stencil apply for NVIDIA Hopper (sm_90a): the 3D vacuum-PEC curl-curl
// K @ X and/or mass M @ X of maxwell_tpu_torch/problems/stencil3d.py, on the
// stencil's flat edge layout, without a matrix.
//
// Replaces the Pallas TPU kernel maxwell_tpu/kernels/stencil_taps.py
// stencil_taps_pallas (body _kernel), and computes what the XLA path
// StencilPencil3D._taps_apply of maxwell_tpu/problems/stencil3d.py computes.
//
// Layout: X is (n_padded, m) f32, row-major. Rows are
// [Ex (nx, ny+1, nz+1) | Ey (nx+1, ny, nz+1) | Ez (nx+1, ny+1, nz) | pad],
// each component grid row-major. For an output edge p of component alpha,
//   Y[p, j] = mask[p] * sum_{taps (beta, d, c) of alpha}
//             c * mask[q] * X[q, j],   q = edge p + d of component beta,
// a tap whose shifted edge falls outside beta's grid reads zero; every
// offset d is in {-1, 0, 1}^3. Rows >= n come out zero. K and M share the
// tap positions (cK, cM per tap). The mask is data (PEC or all ones), and X
// is arbitrary on masked and padding rows: the kernel applies both masks.
//
// Bound: device-memory bandwidth. One fused K/M apply at 64^3, m = 9 must
// read X (29.2 MB) and the mask (3.2 MB) and write two outputs (58.4 MB):
// 27 us at 3.35 TB/s. Its arithmetic (2 x 33 taps x 2 flops per output) is
// 14 us at the f32 rate, below the byte bound. What held the first kernel
// (one thread per output, 0.34 ms) was instruction issue: per tap three
// bounds compares, index arithmetic, the input's load and its mask's. This
// one takes 0.078 ms there on an H100 SXM (80 GB, 700 W; PERF.md).
//
// Design: the TPU kernel's rolling window of three x-planes, in shared
// memory, masked once on the way in.
// - A block owns TILE_Y x tile_z positions (y, z) of the common
//   (nx+1, ny+1, nz+1) box, all m columns, and a chunk of x-planes, which
//   it walks in order. For each input component beta it keeps planes
//   x - 1, x, x + 1 of its tile plus a halo of one in a ring of three
//   shared-memory slots. A staged row, (tile_z + 2) positions x m columns,
//   is contiguous in X (z is the fastest position axis), so thread e stages
//   element e of every row: coalesced loads, conflict-free stores.
// - Each element is multiplied by its mask as it is staged, and positions
//   outside beta's own grid are staged as zero: a tap needs no bounds check
//   and no mask load.
// - The next plane's elements and their masks are loaded into registers
//   while the current plane is computed, and stored, masked, into the ring
//   slot that plane x - 1 leaves. (Copying it with cp.async into a fourth
//   buffer and masking it there in a second pass measured slower.)
// - Thread e computes output element e of a row, (z0 + e / m, column e % m),
//   for TILE_Y rows and all three components alpha from the same staged
//   planes. The 99 taps of the hex element fall in 21 columns (beta, dx,
//   dz): the kernel knows the pattern at compile time, loads a column's
//   TILE_Y + 2 staged rows once into registers and applies each of its taps
//   (alpha, dy) to the TILE_Y rows, with the coefficients as constant
//   operands: 115 shared-memory loads and 396 FMAs per operator for the 99
//   taps and 4 rows of a thread, where one load per tap and row would take
//   396. The output mask is applied and each output written once;
//   positions outside alpha's grid are skipped. No atomics: runs repeat bit
//   for bit.
// - The host plan (kernels/stencil_taps.py stencil_plan) sizes the tile for
//   m, cuts x into chunks so the card is filled once, orders the pencil's
//   taps by column and gives each column its offset in the staged tile
//   (beta's plane, dz positions; dx picks the ring slot). The entry point
//   refuses another tap pattern. Blocks after the tiles zero the padding
//   rows.
// - Three modes by template: K, M, and fused K+M, which reads each staged
//   input once and writes both outputs.
// - A launch takes at most 170 columns (a staged row is at most two
//   elements a thread, 3 m <= 512). A wider X goes in column passes of
//   near-equal width (kernels/stencil_taps.py column_passes: m 171 is 86 +
//   85), one launch each, which reads and writes its own columns in place:
//   the plan's ld is the row stride of X and the outputs (the whole X's
//   width; ld = m in a single launch), and the wrapper offsets the
//   pointers to the pass's first column. Nothing is copied out and back.
// - 32-bit index arithmetic: the wrapper checks n_padded * ld < 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kTileY = 4;  // output rows of a block (the plan's tile_y)
constexpr int kRing = 3;   // staged x-planes per input component
constexpr int kRows = kTileY + 2;
// at most 256 threads a block and three blocks to an SM: 80 registers a
// thread (more threads or fewer registers measured slower)
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 3;
constexpr int kNumCols = 21;  // (beta, dx, dz) columns of the hex element
constexpr int kNumTaps = 99;  // 33 per component

struct Col {
  int beta, dx, dz;  // input component and offsets of the column's taps
  int t0, nt;        // its taps: t0 .. t0 + nt - 1
};
struct Tap {
  int alpha, dy;  // output component and y offset
};

// The taps of the vacuum hex-element stencil, by column (beta, dx, dz),
// then (alpha, dy): the plan (kernels/stencil_taps.py stencil_plan) orders
// a pencil's taps so, and the entry point refuses any other pattern.
__host__ __device__ constexpr Col col_of(int c) {
  constexpr Col cols[kNumCols] = {
      {0, -1, -1, 0, 2},  {0, -1, 0, 2, 5},   {0, -1, 1, 7, 5},
      {0, 0, -1, 12, 5},  {0, 0, 0, 17, 8},   {0, 0, 1, 25, 8},
      {1, -1, -1, 33, 1}, {1, -1, 0, 34, 3},  {1, -1, 1, 37, 3},
      {1, 0, -1, 40, 3},  {1, 0, 0, 43, 5},   {1, 0, 1, 48, 5},
      {1, 1, -1, 53, 3},  {1, 1, 0, 56, 5},   {1, 1, 1, 61, 5},
      {2, -1, -1, 66, 2}, {2, -1, 0, 68, 5},  {2, 0, -1, 73, 5},
      {2, 0, 0, 78, 8},   {2, 1, -1, 86, 5},  {2, 1, 0, 91, 8}};
  return cols[c];
}

__host__ __device__ constexpr Tap tap_of(int t) {
  constexpr Tap taps[kNumTaps] = {
      {1, 0},  {1, 1},  {1, 0},  {1, 1},  {2, -1}, {2, 0},  {2, 1},  {1, 0},
      {1, 1},  {2, -1}, {2, 0},  {2, 1},  {0, -1}, {0, 0},  {0, 1},  {1, 0},
      {1, 1},  {0, -1}, {0, 0},  {0, 1},  {1, 0},  {1, 1},  {2, -1}, {2, 0},
      {2, 1},  {0, -1}, {0, 0},  {0, 1},  {1, 0},  {1, 1},  {2, -1}, {2, 0},
      {2, 1},  {1, 0},  {1, 0},  {2, -1}, {2, 0},  {1, 0},  {2, -1}, {2, 0},
      {0, -1}, {0, 0},  {1, 0},  {0, -1}, {0, 0},  {1, 0},  {2, -1}, {2, 0},
      {0, -1}, {0, 0},  {1, 0},  {2, -1}, {2, 0},  {0, -1}, {0, 0},  {1, 0},
      {0, -1}, {0, 0},  {1, 0},  {2, -1}, {2, 0},  {0, -1}, {0, 0},  {1, 0},
      {2, -1}, {2, 0},  {1, 0},  {1, 1},  {1, 0},  {1, 1},  {2, -1}, {2, 0},
      {2, 1},  {0, -1}, {0, 0},  {0, 1},  {1, 0},  {1, 1},  {0, -1}, {0, 0},
      {0, 1},  {1, 0},  {1, 1},  {2, -1}, {2, 0},  {2, 1},  {0, -1}, {0, 0},
      {0, 1},  {1, 0},  {1, 1},  {0, -1}, {0, 0},  {0, 1},  {1, 0},  {1, 1},
      {2, -1}, {2, 0},  {2, 1}};
  return taps[t];
}

// staged rows a column's taps read: 1 + its least dy .. kTileY + its most
__host__ __device__ constexpr int col_rows(int c, bool last) {
  int lo = 2, hi = 0;
  for (int t = col_of(c).t0; t < col_of(c).t0 + col_of(c).nt; ++t) {
    lo = tap_of(t).dy + 1 < lo ? tap_of(t).dy + 1 : lo;
    hi = tap_of(t).dy + 1 > hi ? tap_of(t).dy + 1 : hi;
  }
  return last ? hi + kTileY - 1 : lo;
}

struct Plan {
  int m, n, n_padded;
  int ld;  // row stride of x, yk, ym (floats): m, or the whole X's width
  int tile_z, chunk_x;
  int grid_z, grid_y, grid_x;
  int threads;
  int rs;      // floats of a staged row, (tile_z + 2) m
  int plane;   // floats of a staged plane, kRows rs
  int dims[3][3];
  int off[4];  // first row of each component, then n
  int box_x;   // x extent of the common box
  int col_off[kNumCols];  // beta plane + dz m of each column
  float coef[kNumTaps][2];  // cK, cM
};

using Acc = float[3][2][kTileY];  // [alpha][K, M][output row]

template <int T, bool WANT_K, bool WANT_M>
__device__ __forceinline__ void tap(Acc& acc, const float (&v)[kRows],
                                    const Plan& p) {
  constexpr int a = tap_of(T).alpha, dy = tap_of(T).dy;
  const float cK = p.coef[T][0], cM = p.coef[T][1];
#pragma unroll
  for (int r = 0; r < kTileY; ++r) {
    if (WANT_K) acc[a][0][r] = fmaf(cK, v[r + 1 + dy], acc[a][0][r]);
    if (WANT_M) acc[a][1][r] = fmaf(cM, v[r + 1 + dy], acc[a][1][r]);
  }
}

template <int C, bool WANT_K, bool WANT_M, int... Is>
__device__ __forceinline__ void column_taps(Acc& acc,
                                            const float (&v)[kRows],
                                            const Plan& p,
                                            std::integer_sequence<int, Is...>) {
  (tap<col_of(C).t0 + Is, WANT_K, WANT_M>(acc, v, p), ...);
}

// one column: its staged rows loaded once, then each of its taps on the
// kTileY output rows; src is the column's element of staged row 0
template <int C, bool WANT_K, bool WANT_M>
__device__ __forceinline__ void column(Acc& acc, const float* ring,
                                       const int (&sb)[3], int tb, int rs,
                                       const Plan& p) {
  constexpr int lo = col_rows(C, false), hi = col_rows(C, true);
  const float* src = ring + sb[col_of(C).dx + 1] + p.col_off[C] + tb;
  float v[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) v[k] = k >= lo && k <= hi ? src[k * rs] : 0.f;
  column_taps<C, WANT_K, WANT_M>(
      acc, v, p, std::make_integer_sequence<int, col_of(C).nt>{});
}

template <bool WANT_K, bool WANT_M, int... Cs>
__device__ __forceinline__ void columns(Acc& acc, const float* ring,
                                        const int (&sb)[3], int tb, int rs,
                                        const Plan& p,
                                        std::integer_sequence<int, Cs...>) {
  (column<Cs, WANT_K, WANT_M>(acc, ring, sb, tb, rs, p), ...);
}

// KM: staged elements (and output elements) of a row per thread, 1 or 2
template <int KM, bool WANT_K, bool WANT_M>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
stencil_taps_kernel(const float* __restrict__ x,
                    const float* __restrict__ mask, float* __restrict__ yk,
                    float* __restrict__ ym, const __grid_constant__ Plan p) {
  extern __shared__ __align__(16) float ring[];  // [slot][beta][plane]
  const int m = p.m;
  const int tiles = p.grid_z * p.grid_y * p.grid_x;
  if ((int)blockIdx.x >= tiles) {  // padding rows n .. n_padded: zero
    const int i = ((int)blockIdx.x - tiles) * p.threads + (int)threadIdx.x;
    if (i < (p.n_padded - p.n) * m) {
      const int e = (p.n + i / m) * p.ld + i % m;
      if (WANT_K) yk[e] = 0.0f;
      if (WANT_M) ym[e] = 0.0f;
    }
    return;
  }
  int b = blockIdx.x;
  const int z0 = (b % p.grid_z) * p.tile_z;
  b /= p.grid_z;
  const int y0 = (b % p.grid_y) * kTileY;
  const int xb = (b / p.grid_y) * p.chunk_x;
  const int xe = min(xb + p.chunk_x, p.box_x);
  const int rs = p.rs;
  const int slot_stride = 3 * p.plane;

  // the thread's elements of a staged row (e < rs) and of an output row
  // (e < tile_z m): position lz = e / m, column e % m
  int el[KM], lz[KM];
  bool stage_on[KM], out_on[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    el[k] = (int)threadIdx.x + k * p.threads;
    lz[k] = el[k] / m;
    stage_on[k] = el[k] < rs;
    out_on[k] = el[k] < p.tile_z * m;
  }

  float xv[3][kRows][KM], mv[3][kRows][KM];
  // plane xp of each input component and its masks into registers (zero
  // off the component's grid)
  auto fetch = [&](int xp) {
#pragma unroll
    for (int beta = 0; beta < 3; ++beta) {
      const int X = p.dims[beta][0], Y = p.dims[beta][1], Z = p.dims[beta][2];
      const bool xin = xp >= 0 && xp < X;
#pragma unroll
      for (int row = 0; row < kRows; ++row) {
        const int y = y0 - 1 + row;
        const bool yin = xin && y >= 0 && y < Y;
#pragma unroll
        for (int k = 0; k < KM; ++k) {
          const int z = z0 - 1 + lz[k];
          const bool ok = stage_on[k] && yin && z >= 0 && z < Z;
          const int q = p.off[beta] + (xp * Y + y) * Z + z;
          xv[beta][row][k] =
              ok ? __ldg(x + q * p.ld + (el[k] - lz[k] * m)) : 0.0f;
          mv[beta][row][k] = ok ? __ldg(mask + q) : 0.0f;
        }
      }
    }
  };
  // the fetched plane, masked, into its ring slot
  auto put = [&](int xp) {
    float* s = ring + ((xp + kRing) % kRing) * slot_stride;
#pragma unroll
    for (int beta = 0; beta < 3; ++beta)
#pragma unroll
      for (int row = 0; row < kRows; ++row)
#pragma unroll
        for (int k = 0; k < KM; ++k)
          if (stage_on[k])
            s[beta * p.plane + row * rs + el[k]] =
                xv[beta][row][k] * mv[beta][row][k];
  };

  fetch(xb - 1);
  put(xb - 1);
  fetch(xb);
  put(xb);
  fetch(xb + 1);
  for (int xc = xb; xc < xe; ++xc) {
    put(xc + 1);
    __syncthreads();
    if (xc + 2 <= xe) fetch(xc + 2);  // in flight while plane xc computes
    int sb[3];  // slots of planes xc - 1, xc, xc + 1
#pragma unroll
    for (int i = 0; i < 3; ++i) sb[i] = ((xc + i + 2) % kRing) * slot_stride;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (!out_on[k]) continue;
      Acc acc;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int r = 0; r < kTileY; ++r) acc[a][0][r] = acc[a][1][r] = 0.0f;
      // staged row 0, position lz + 1: the element above output row 0
      columns<WANT_K, WANT_M>(acc, ring, sb, el[k] + m, rs, p,
                              std::make_integer_sequence<int, kNumCols>{});
      const int z = z0 + lz[k];
      const int j = el[k] - lz[k] * m;
#pragma unroll
      for (int A = 0; A < 3; ++A) {
        const int X = p.dims[A][0], Y = p.dims[A][1], Z = p.dims[A][2];
        if (xc >= X || z >= Z) continue;
#pragma unroll
        for (int r = 0; r < kTileY; ++r) {
          const int y = y0 + r;
          if (y >= Y) break;
          const int row = p.off[A] + (xc * Y + y) * Z + z;
          const float mk = __ldg(mask + row);
          if (WANT_K) yk[row * p.ld + j] = acc[A][0][r] * mk;
          if (WANT_M) ym[row * p.ld + j] = acc[A][1][r] * mk;
        }
      }
    }
    __syncthreads();  // the slot of plane xc - 1 takes plane xc + 2 next
  }
}

template <int KM, bool WANT_K, bool WANT_M>
int launch(const Plan& p, unsigned blocks, float* yk, float* ym,
           const float* x, const float* mask, size_t smem, cudaStream_t s) {
  auto kernel = stencil_taps_kernel<KM, WANT_K, WANT_M>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, p.threads, smem, s>>>(x, mask, yk, ym, p);
  return (int)cudaGetLastError();
}

template <int KM>
int launch_modes(const Plan& p, unsigned blocks, float* yk, float* ym,
                 const float* x, const float* mask, size_t smem,
                 cudaStream_t s) {
  if (yk && ym)
    return launch<KM, true, true>(p, blocks, yk, ym, x, mask, smem, s);
  if (yk) return launch<KM, true, false>(p, blocks, yk, ym, x, mask, smem, s);
  return launch<KM, false, true>(p, blocks, yk, ym, x, mask, smem, s);
}

}  // namespace

// Plain C entry point (loaded with ctypes). plan, cols (int32) and coef
// (f32) are HOST arrays from kernels/stencil_taps.py StencilPlan.header()
// and .arrays(): plan holds m, n, n_padded, tile_y, tile_z, chunk_x,
// grid_z, grid_y, grid_x, pad_blocks, threads, row_stride, plane,
// smem_bytes, ld, the component dims (9), offsets (4), the box (3), and the
// column and tap counts; cols holds per column (beta, dx, dz, first tap,
// tap count, offset in the staged tile), then per tap (alpha, dy); coef
// (cK, cM) per tap. x, mask, yk, ym are device pointers, x, yk and ym at
// the launch's first column (rows ld floats apart); yk or ym may be null
// when that operator is not wanted (not both). Returns
// cudaGetLastError() after the launch (0 on success), 1 for a plan the
// kernel does not take (tile_y, threads, row length, shared memory, a row
// stride under m, or a tap pattern other than the hex element's).
extern "C" int stencil_taps_f32(const void* x, const void* mask, void* yk,
                                void* ym, const void* plan, const void* cols,
                                const void* coef, void* stream) {
  const int32_t* h = static_cast<const int32_t*>(plan);
  const int32_t* cl = static_cast<const int32_t*>(cols);
  const float* cf = static_cast<const float*>(coef);
  Plan p;
  p.m = h[0]; p.n = h[1]; p.n_padded = h[2];
  const int tile_y = h[3];
  p.tile_z = h[4]; p.chunk_x = h[5];
  p.grid_z = h[6]; p.grid_y = h[7]; p.grid_x = h[8];
  const int pad_blocks = h[9];
  p.threads = h[10]; p.rs = h[11]; p.plane = h[12];
  const size_t smem = (size_t)h[13];
  p.ld = h[14];
  const int32_t* d = h + 15;
  for (int a = 0; a < 3; ++a)
    for (int i = 0; i < 3; ++i) p.dims[a][i] = d[3 * a + i];
  for (int i = 0; i < 4; ++i) p.off[i] = d[9 + i];
  p.box_x = d[13];  // d[14], d[15]: the box's y and z extents
  const int ncols = d[16], ntaps = d[17];
  if (tile_y != kTileY || p.threads % 32 || p.threads > kMaxThreads ||
      p.rs != (p.tile_z + 2) * p.m || p.rs > 2 * p.threads ||
      p.plane != kRows * p.rs || p.ld < p.m ||
      smem != (size_t)kRing * 3 * p.plane * sizeof(float) ||
      ncols != kNumCols || ntaps != kNumTaps)
    return 1;
  for (int c = 0; c < kNumCols; ++c) {
    const Col col = col_of(c);
    const int32_t* q = cl + 6 * c;
    if (q[0] != col.beta || q[1] != col.dx || q[2] != col.dz ||
        q[3] != col.t0 || q[4] != col.nt)
      return 1;
    p.col_off[c] = q[5];
  }
  for (int t = 0; t < kNumTaps; ++t) {
    const int32_t* q = cl + 6 * kNumCols + 2 * t;
    if (q[0] != tap_of(t).alpha || q[1] != tap_of(t).dy) return 1;
    p.coef[t][0] = cf[2 * t];
    p.coef[t][1] = cf[2 * t + 1];
  }
  const unsigned blocks =
      (unsigned)(p.grid_z * p.grid_y * p.grid_x + pad_blocks);
  const float* xp = static_cast<const float*>(x);
  const float* mp = static_cast<const float*>(mask);
  float* kp = static_cast<float*>(yk);
  float* mo = static_cast<float*>(ym);
  cudaStream_t s = (cudaStream_t)stream;
  if (p.rs <= p.threads)
    return launch_modes<1>(p, blocks, kp, mo, xp, mp, smem, s);
  return launch_modes<2>(p, blocks, kp, mo, xp, mp, smem, s);
}
