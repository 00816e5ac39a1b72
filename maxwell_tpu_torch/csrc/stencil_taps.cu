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
// a tap whose shifted edge falls outside beta's grid reads zero. Rows >= n
// come out zero. K and M share the tap positions (cK, cM per tap).
//
// Bound: device-memory bandwidth. One fused K/M apply at 64^3, m = 9 must
// read X (29.2 MB) and the mask (3.2 MB) and write two outputs (58.4 MB):
// 27 us at 3.35 TB/s. Its arithmetic (2 x 33 taps x 2 flops per output) is
// 14 us at the f32 rate, below the byte bound.
//
// Design (simple and right first):
// - One thread per output element (row, column j); consecutive threads walk
//   j then z, so each tap's reads and the writes of a warp are contiguous.
//   The ~33 shifted reads of neighbouring outputs overlap and are served by
//   L1/L2, not by device memory.
// - The TPU kernel padded all three component grids into one common box and
//   kept a rolling window of three x-planes in VMEM. Here each tap's shifted
//   index is bounds-checked against its own component's shape (the three
//   shapes differ), and both masks (input rows and output rows) are applied
//   in the kernel.
// - Each block works on one component (blocks are split into ranges per
//   component, and a last range zeroes the padding rows), so the component
//   and, within the tap loop, the input component beta are compile-time
//   constants: shapes and offsets stay in registers, with no per-thread
//   stack. The host groups each component's taps by beta.
// - The tap table (dx, dy, dz, cK, cM; at most kMaxTaps per component) is a
//   __grid_constant__ kernel argument (constant bank), read uniformly.
// - Three modes by template: K, M, and fused K+M, which reads each shifted
//   input once and writes both outputs.
// - 32-bit index arithmetic: the wrapper checks n_padded * m < 2^31.
// Measured on the H100 at 64^3, m = 9 (PERF.md): this version runs the fused
// apply at 0.34 ms, 8% of its bound; a first version with the component
// chosen per thread and 64-bit index arithmetic kept shapes in a stack frame
// and ran it at 0.52 ms. At roughly 20 instructions per tap and output,
// instruction issue rather than bytes likely limits it; reusing loaded
// inputs across neighbouring outputs is the next step.
// Not yet used: shared-memory tiles of the x-planes, several columns per
// thread, TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 48;  // per component; the hex element gives 33
constexpr int kThreads = 256;

struct Taps {
  int seg[3][4];             // taps of (alpha, beta): seg[a][b] .. seg[a][b+1]
  int32_t d[3][kMaxTaps][3];   // dx, dy, dz
  float coef[3][kMaxTaps][2];  // cK, cM
};

struct Geometry {
  int off[4];        // first row of each component; off[3] = n
  int dims[3][3];    // (X, Y, Z) of each component grid
  int block0[4];     // first block of each component's range, then padding
  int n_padded;
  int m;
};

template <int A, bool WANT_K, bool WANT_M>
__device__ __forceinline__ void component(
    const float* __restrict__ x, const float* __restrict__ mask,
    float* __restrict__ yk, float* __restrict__ ym, const Taps& taps,
    const Geometry& g) {
  const int idx = (blockIdx.x - g.block0[A]) * kThreads + threadIdx.x;
  const int loc = idx / g.m;
  const int j = idx - loc * g.m;
  const int Y = g.dims[A][1], Z = g.dims[A][2];
  if (loc >= g.dims[A][0] * Y * Z) return;
  const int row = g.off[A] + loc;
  const int out = row * g.m + j;
  const float mk = mask[row];
  float acc_k = 0.0f, acc_m = 0.0f;
  if (mk != 0.0f) {
    const int ix = loc / (Y * Z);
    const int rem = loc - ix * (Y * Z);
    const int iy = rem / Z;
    const int iz = rem - iy * Z;
#pragma unroll
    for (int B = 0; B < 3; ++B) {
      const int bx = g.dims[B][0], by = g.dims[B][1], bz = g.dims[B][2];
      const int base = g.off[B] + (ix * by + iy) * bz + iz;
      for (int t = taps.seg[A][B]; t < taps.seg[A][B + 1]; ++t) {
        const int dx = taps.d[A][t][0], dy = taps.d[A][t][1],
                  dz = taps.d[A][t][2];
        if ((unsigned)(ix + dx) >= (unsigned)bx ||
            (unsigned)(iy + dy) >= (unsigned)by ||
            (unsigned)(iz + dz) >= (unsigned)bz)
          continue;
        const int q = base + (dx * by + dy) * bz + dz;
        const float v = __ldg(x + q * g.m + j) * __ldg(mask + q);
        if (WANT_K) acc_k += taps.coef[A][t][0] * v;
        if (WANT_M) acc_m += taps.coef[A][t][1] * v;
      }
    }
    acc_k *= mk;
    acc_m *= mk;
  }
  if (WANT_K) yk[out] = acc_k;
  if (WANT_M) ym[out] = acc_m;
}

template <bool WANT_K, bool WANT_M>
__global__ void __launch_bounds__(kThreads)
stencil_taps_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                    float* __restrict__ yk, float* __restrict__ ym,
                    const __grid_constant__ Taps taps,
                    const __grid_constant__ Geometry g) {
  const int b = blockIdx.x;
  if (b < g.block0[1]) {
    component<0, WANT_K, WANT_M>(x, mask, yk, ym, taps, g);
  } else if (b < g.block0[2]) {
    component<1, WANT_K, WANT_M>(x, mask, yk, ym, taps, g);
  } else if (b < g.block0[3]) {
    component<2, WANT_K, WANT_M>(x, mask, yk, ym, taps, g);
  } else {  // padding rows n .. n_padded come out zero
    const int i = g.off[3] * g.m + (b - g.block0[3]) * kThreads + threadIdx.x;
    if (i < g.n_padded * g.m) {
      if (WANT_K) yk[i] = 0.0f;
      if (WANT_M) ym[i] = 0.0f;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). tap_meta (int32, 4 per tap:
// beta, dx, dy, dz), tap_coef (f32, 2 per tap: cK, cM) and counts (int32, 3)
// are HOST arrays, taps of component 0 first; they are grouped by beta into
// the kernel's __grid_constant__ argument. dims holds (X, Y, Z) of the three
// component grids (int32, 9 values, host). x, mask, yk, ym are device
// pointers; yk or ym may be null when that operator is not wanted (not
// both). Returns cudaGetLastError() after the launch (0 on success), 1 for a
// tap table larger than the kernel holds or a bad beta, 2 for sizes beyond
// 32-bit indexing.
extern "C" int stencil_taps_f32(const void* x, const void* mask, void* yk,
                                void* ym, const void* tap_meta,
                                const void* tap_coef, const void* counts,
                                const void* dims, int64_t n_padded, int64_t m,
                                void* stream) {
  Taps taps;
  Geometry g;
  const int32_t* cnt = static_cast<const int32_t*>(counts);
  const int32_t* meta = static_cast<const int32_t*>(tap_meta);
  const float* coef = static_cast<const float*>(tap_coef);
  const int32_t* d = static_cast<const int32_t*>(dims);
  int first = 0;
  for (int a = 0; a < 3; ++a) {
    if (cnt[a] < 0 || cnt[a] > kMaxTaps) return 1;
    int k = 0;
    taps.seg[a][0] = 0;
    for (int b = 0; b < 3; ++b) {  // group this component's taps by beta
      for (int t = first; t < first + cnt[a]; ++t) {
        if (meta[4 * t] < 0 || meta[4 * t] > 2) return 1;
        if (meta[4 * t] != b) continue;
        for (int i = 0; i < 3; ++i) taps.d[a][k][i] = meta[4 * t + 1 + i];
        taps.coef[a][k][0] = coef[2 * t];
        taps.coef[a][k][1] = coef[2 * t + 1];
        ++k;
      }
      taps.seg[a][b + 1] = k;
    }
    first += cnt[a];
  }
  int64_t off = 0;
  int64_t blocks = 0;
  for (int a = 0; a < 3; ++a) {
    const int64_t size = (int64_t)d[3 * a] * d[3 * a + 1] * d[3 * a + 2];
    for (int i = 0; i < 3; ++i) g.dims[a][i] = d[3 * a + i];
    g.off[a] = (int)off;
    g.block0[a] = (int)blocks;
    off += size;
    blocks += (size * m + kThreads - 1) / kThreads;
  }
  if (n_padded < off || n_padded * m >= ((int64_t)1 << 31)) return 2;
  g.off[3] = (int)off;
  g.block0[3] = (int)blocks;
  blocks += ((n_padded - off) * m + kThreads - 1) / kThreads;
  g.n_padded = (int)n_padded;
  g.m = (int)m;
  const float* xp = static_cast<const float*>(x);
  const float* mp = static_cast<const float*>(mask);
  float* kp = static_cast<float*>(yk);
  float* mo = static_cast<float*>(ym);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned nb = (unsigned)blocks;
  if (kp && mo)
    stencil_taps_kernel<true, true><<<nb, kThreads, 0, s>>>(xp, mp, kp, mo,
                                                            taps, g);
  else if (kp)
    stencil_taps_kernel<true, false><<<nb, kThreads, 0, s>>>(xp, mp, kp, mo,
                                                             taps, g);
  else
    stencil_taps_kernel<false, true><<<nb, kThreads, 0, s>>>(xp, mp, kp, mo,
                                                             taps, g);
  return (int)cudaGetLastError();
}
