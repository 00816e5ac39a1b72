// Paired-chunk blocked-ELL ("BELLPairs") SpMM for NVIDIA Hopper (sm_90a) on
// the layout of maxwell_tpu_torch/sparse/bellpairs.py.
//
// Replaces the Pallas TPU kernels in maxwell_tpu/kernels/spmm.py:
//   bellpairs_matmat_pallas           (_bellpairs_kernel, _gather_chunk)
//                                       -> bellpairs_matmat_f32 (stream a or b
//                                          by pointer; m = 1 is a true m = 1
//                                          launch)
//   bellpairs_km_matmat_pallas        (_bellpairs_km_kernel)
//                                       -> bellpairs_km_matmat_f32
//   bellpairs_matmat_pallas_windowed  (_bellpairs_windowed_kernel)
//                                       -> bellpairs_matmat_windowed_f32
// (bellpairs_matmat_banded / bellpairs_km_matmat_banded are host loops over
// the first two, in kernels/bellpairs_spmm.py.)
//
// What it computes, for block row r (b = 8, a pair slot is an (8, 16) panel):
//   Y[8r + i, j] = sum_{q < npairs[r]} sum_{k < 16}
//                  vals2d[8r + i, 16q + k] * X[8 c(r, q) + k, j]
// with c(r, q) = cols[r, q], or win_start[r / 16] * Wu + cols_rel[r, q] in
// the windowed form (16 block rows make one 128-row tile). Slots past
// npairs[r] are padding with zero values and are skipped, so the result
// equals the full sum over all Q slots (the TPU kernel stopped per tile, at
// its live chunk count nch).
//
// Bound: device-memory bandwidth, on the value stream. A block row reads
// npairs[r] panels of 512 B; at 24^3 (n = 38,088) that is 16.7 pairs per
// block row on average, 40.8 MB per stream, against the 117.2 MB stored
// (the chunk padding) and 4.7 MB of CSR values (the pairs' zero fill). X
// (1.4 MB at m = 9) stays in L2. Two flops per stored value and column: far
// below the f32 peak.
//
// Design (simple and right first):
// - One warp per block row; no atomics, each output element is written once,
//   so repeated runs agree bit for bit. Lane l takes row i = l >> 2 of the
//   panel and its columns k0..k0+3 (k0 = 4 (l & 3)) with one 16-byte load:
//   a slot is eight rows of 64 contiguous bytes, one load per lane. The
//   slot's X operand is 16 consecutive rows from 8 c(r, q), one contiguous
//   (16, m) panel, read by scalar loads from L2 (lane: its four rows). Two
//   xor shuffles over the four lanes of a row finish the sum; lane 4i
//   writes row i.
// - The fused form carries two value streams and two accumulators: the X
//   panel is read once per slot and feeds both (the reason for the TPU
//   kernel, spmm.py:714-721).
// - Wider X is walked in column slices of up to 16 inside the warp (any
//   m >= 1).
// - No slot reads past the X it is given: pairs end at block column
//   nbr - 1 and the builder clamps a last-column singleton (checked on the
//   host when the layout is built), so X needs no padding.
// - The windowed form reads X through the tile's window. Where the window
//   (2 Wu b rows x m) fits in shared memory, one 512-thread block per tile
//   stages it there first (16 warps, one per block row); otherwise it reads
//   the window from global memory. The caller chooses and reports which.
// - Offsets into the value stream are 64-bit.
// Not yet used: mma on the (8, 16) panels, cp.async/TMA pipelining.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 8;              // block size
constexpr int kPair = 2 * kB;      // values per panel row (two blocks)
constexpr int kTileRows = 16;      // block rows per 128-row tile
constexpr int kWarpsPerCta = 8;    // direct and global-window launches

enum Mode { kDirect = 0, kWindowGlobal = 1, kWindowShared = 2 };

struct Params {
  const float* vals;          // (8 nbr, 16 Q) stream applied (a or b)
  const float* vals_b;        // (8 nbr, 16 Q) second stream, fused form only
  const int32_t* cols;        // (nbr, Q) absolute, or relative to the window
  const int32_t* win_start;   // (nbr / 16,) windowed forms only
  const int32_t* npairs;      // (nbr,)
  const float* x;             // (rows, m) row-major
  float* y;                   // (8 nbr, m) row-major
  float* y_b;                 // (8 nbr, m), fused form only
  int64_t nbr;
  int64_t Q;
  int64_t m;
  int64_t wu;                 // window unit in block rows (windowed form)
};

template <int MS, int MODE, bool FUSED>
__global__ void __launch_bounds__(MODE == kWindowShared ? kTileRows * 32
                                                        : kWarpsPerCta * 32)
bellpairs_kernel(const Params p) {
  extern __shared__ __align__(16) float xwin[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int64_t r;
  int64_t base = 0;  // block column added to each slot's column
  const float* xs = p.x;
  if (MODE == kWindowShared) {
    const int64_t t = blockIdx.x;
    r = t * kTileRows + warp;
    const int64_t count = 2 * p.wu * kB * p.m;
    const float* src = p.x + (int64_t)p.win_start[t] * p.wu * kB * p.m;
    for (int64_t k = threadIdx.x; k < count; k += blockDim.x) xwin[k] = src[k];
    __syncthreads();
    xs = xwin;  // columns are relative to the window's first block row
  } else {
    r = (int64_t)blockIdx.x * kWarpsPerCta + warp;
    if (r >= p.nbr) return;
    if (MODE == kWindowGlobal)
      base = (int64_t)p.win_start[r / kTileRows] * p.wu;
  }

  const int i = lane >> 2;           // panel row of the lane's values
  const int k0 = (lane & 3) * 4;     // first panel column of them
  const int np = p.npairs[r];
  const size_t voff = ((size_t)r * kB + i) * (size_t)p.Q * kPair + k0;
  const float* va = p.vals + voff;
  const float* vb = FUSED ? p.vals_b + voff : nullptr;
  const int32_t* crow = p.cols + (size_t)r * p.Q;
  const int64_t m = p.m;

  for (int64_t j0 = 0; j0 < m; j0 += MS) {
    const int ms = (int)((m - j0) < MS ? (m - j0) : MS);
    float acc[MS];
    float accb[FUSED ? MS : 1];
#pragma unroll
    for (int j = 0; j < MS; ++j) acc[j] = 0.f;
#pragma unroll
    for (int j = 0; j < (FUSED ? MS : 1); ++j) accb[j] = 0.f;

#pragma unroll 4
    for (int q = 0; q < np; ++q) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(va + (size_t)q * kPair));
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (FUSED)
        w = __ldg(reinterpret_cast<const float4*>(vb + (size_t)q * kPair));
      const int64_t xr = (base + crow[q]) * kB + k0;
      const float* xp = xs + xr * m + j0;
#pragma unroll
      for (int j = 0; j < MS; ++j) {
        if (j < ms) {
          const float x0 = xp[j], x1 = xp[m + j], x2 = xp[2 * m + j],
                      x3 = xp[3 * m + j];
          float a = acc[j];
          a = fmaf(v.x, x0, a);
          a = fmaf(v.y, x1, a);
          a = fmaf(v.z, x2, a);
          a = fmaf(v.w, x3, a);
          acc[j] = a;
          if (FUSED) {
            float c = accb[j];
            c = fmaf(w.x, x0, c);
            c = fmaf(w.y, x1, c);
            c = fmaf(w.z, x2, c);
            c = fmaf(w.w, x3, c);
            accb[j] = c;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MS; ++j) {
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 1);
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 2);
      if (FUSED) {
        accb[j] += __shfl_xor_sync(0xffffffffu, accb[j], 1);
        accb[j] += __shfl_xor_sync(0xffffffffu, accb[j], 2);
      }
    }
    if ((lane & 3) == 0) {
      const size_t yoff = ((size_t)r * kB + i) * m + j0;
#pragma unroll
      for (int j = 0; j < MS; ++j) {
        if (j < ms) {
          p.y[yoff + j] = acc[j];
          if (FUSED) p.y_b[yoff + j] = accb[j];
        }
      }
    }
  }
}

template <int MS, int MODE, bool FUSED>
int launch_ms(const Params& p, cudaStream_t stream) {
  auto kernel = bellpairs_kernel<MS, MODE, FUSED>;
  if (MODE == kWindowShared) {
    const size_t smem = (size_t)2 * p.wu * kB * p.m * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned)(p.nbr / kTileRows), kTileRows * 32, smem, stream>>>(p);
  } else {
    const unsigned grid = (unsigned)((p.nbr + kWarpsPerCta - 1) / kWarpsPerCta);
    kernel<<<grid, kWarpsPerCta * 32, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// column-slice width: the smallest template width that holds m (up to 16);
// m = 9 (the solver's block) takes 12
template <int MODE, bool FUSED>
int launch(const Params& p, cudaStream_t stream) {
  if (p.m == 1) return launch_ms<1, MODE, FUSED>(p, stream);
  if (p.m == 2) return launch_ms<2, MODE, FUSED>(p, stream);
  if (p.m <= 4) return launch_ms<4, MODE, FUSED>(p, stream);
  if (p.m <= 8) return launch_ms<8, MODE, FUSED>(p, stream);
  if (p.m <= 12) return launch_ms<12, MODE, FUSED>(p, stream);
  return launch_ms<16, MODE, FUSED>(p, stream);
}

Params make_params(const void* vals, const void* vals_b, const void* cols,
                   const void* win_start, const void* npairs, const void* x,
                   void* y, void* y_b, int64_t nbr, int64_t Q, int64_t m,
                   int64_t wu) {
  Params p;
  p.vals = static_cast<const float*>(vals);
  p.vals_b = static_cast<const float*>(vals_b);
  p.cols = static_cast<const int32_t*>(cols);
  p.win_start = static_cast<const int32_t*>(win_start);
  p.npairs = static_cast<const int32_t*>(npairs);
  p.x = static_cast<const float*>(x);
  p.y = static_cast<float*>(y);
  p.y_b = static_cast<float*>(y_b);
  p.nbr = nbr; p.Q = Q; p.m = m; p.wu = wu;
  return p;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. Shapes, types, tile alignment and the X
// rows every live slot reads are checked by the Python wrappers
// (kernels/bellpairs_spmm.py) and the layout builder; a staged window larger
// than the device's shared memory comes back as the cudaFuncSetAttribute
// error, with no launch.

extern "C" int bellpairs_matmat_f32(const void* vals, const void* cols,
                                    const void* npairs, const void* x, void* y,
                                    int64_t nbr, int64_t Q, int64_t m,
                                    void* stream) {
  const Params p = make_params(vals, nullptr, cols, nullptr, npairs, x, y,
                               nullptr, nbr, Q, m, 0);
  return launch<kDirect, false>(p, (cudaStream_t)stream);
}

extern "C" int bellpairs_km_matmat_f32(const void* vals_k, const void* vals_m,
                                       const void* cols, const void* npairs,
                                       const void* x, void* yk, void* ym,
                                       int64_t nbr, int64_t Q, int64_t m,
                                       void* stream) {
  const Params p = make_params(vals_k, vals_m, cols, nullptr, npairs, x, yk,
                               ym, nbr, Q, m, 0);
  return launch<kDirect, true>(p, (cudaStream_t)stream);
}

extern "C" int bellpairs_matmat_windowed_f32(
    const void* vals, const void* cols_rel, const void* win_start,
    const void* npairs, const void* x, void* y, int64_t nbr, int64_t Q,
    int64_t m, int64_t wu, int64_t staged, void* stream) {
  const Params p = make_params(vals, nullptr, cols_rel, win_start, npairs, x,
                               y, nullptr, nbr, Q, m, wu);
  if (staged) return launch<kWindowShared, false>(p, (cudaStream_t)stream);
  return launch<kWindowGlobal, false>(p, (cudaStream_t)stream);
}
