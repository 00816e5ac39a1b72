// Blocked-ELL SpMM and SpMV for NVIDIA Hopper (sm_90a) on the 8x8-block
// layout of maxwell_tpu_torch/sparse/bsr.py.
//
// Replaces the Pallas TPU kernels in maxwell_tpu/kernels/spmm.py:
//   bsr_matmat_pallas           (_spmm_kernel)           -> bsr_matmat_f32
//   bsr_matmat_pallas_windowed  (_spmm_windowed_kernel)  -> bsr_matmat_windowed_f32
//   bsr_matvec_pallas           (m = 1 of bsr_matmat_pallas, X widened to 8
//                                lanes there; here bsr_matmat_f32 at m = 1,
//                                a true m = 1 launch: launch_ms<1, kDirect>)
//
// What it computes, for block row r (b = 8):
//   Y[8r + i, j] = sum_{s < S} sum_{q < 8} blocks[r, s, i, q] * X[8 c(r, s) + q, j]
// with c(r, s) = cols[r, s], or win_start[r / 16] * Wu + cols_rel[r, s] in
// the windowed form (16 block rows make one 128-row tile). Padding slots hold
// zero values; slots past slot_count[r] (the row's last nonzero block) are
// padding and are skipped, so the result equals the full sum.
//
// Bound: device-memory bandwidth, on the value stream. A block row reads
// slot_count[r] blocks of 256 B; at 24^3 (n = 38,088) K has 135,183 nonzero
// 8x8 blocks, 34.6 MB, about 7x the CSR's values (the blocks' zero fill),
// while X (1.4 MB at m = 9) stays in L2. The plain C++ loop does 2 flops per
// stored value and column: far below the f32 peak.
//
// Design (simple and right first):
// - One warp per block row. Each lane loads four consecutive values of a
//   block with one 16-byte load: lanes 0-15 cover slot s, lanes 16-31 slot
//   s + 1, so a warp reads 512 contiguous bytes per step. Lane l holds row
//   i = (l & 15) / 2 and block columns q0..q0+3 (q0 = 4 (l & 1)) and
//   multiplies them with the matching four X rows, for a slice of up to MS
//   columns kept in registers. Four lanes share each output row; two xor
//   shuffles finish the sum, and the even lanes 0..14 write rows 0..7.
//   No atomics: each output element is written once, deterministically.
// - Wider X is walked in column slices inside the warp (any m >= 1).
// - The windowed form reads X through the tile's window. Where the window
//   (2 Wu b rows x m) fits in shared memory, one 512-thread block per tile
//   stages it there first (16 warps, one per block row); otherwise it reads
//   the window from global memory. The caller chooses and reports which.
// - Offsets into the value stream are 64-bit.
// Not yet used: mma/wgmma on the 8x8 blocks, cp.async/TMA pipelining.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 8;            // block size
constexpr int kBlockVals = kB * kB;
constexpr int kTileRows = 16;    // block rows per 128-row tile
constexpr int kWarpsPerCta = 8;  // direct and global-window launches

enum Mode { kDirect = 0, kWindowGlobal = 1, kWindowShared = 2 };

struct Params {
  const float* blocks;         // (nbr, S, 8, 8)
  const int32_t* cols;         // (nbr, S) absolute, or relative to the window
  const int32_t* win_start;    // (nbr / 16,) windowed forms only
  const int32_t* slot_count;   // (nbr,)
  const float* x;              // (rows, m) row-major
  float* y;                    // (8 nbr, m) row-major
  int64_t nbr;
  int64_t S;
  int64_t m;
  int64_t wu;                  // window unit in block rows (windowed forms)
};

template <int MS, int MODE>
__global__ void __launch_bounds__(MODE == kWindowShared ? kTileRows * 32
                                                        : kWarpsPerCta * 32)
bsr_spmm_kernel(const Params p) {
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

  const int half = lane >> 4;         // which slot of the pair
  const int i = (lane & 15) >> 1;     // block row of the lane's values
  const int q0 = (lane & 1) * 4;      // first block column of them
  const int ns = p.slot_count[r];
  const float* vrow = p.blocks + (size_t)r * p.S * kBlockVals + (lane & 15) * 4;
  const int32_t* crow = p.cols + (size_t)r * p.S;
  const int64_t m = p.m;

  for (int64_t j0 = 0; j0 < m; j0 += MS) {
    const int ms = (int)((m - j0) < MS ? (m - j0) : MS);
    float acc[MS];
#pragma unroll
    for (int j = 0; j < MS; ++j) acc[j] = 0.f;

#pragma unroll 4
    for (int s = half; s < ns; s += 2) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(vrow + (size_t)s * kBlockVals));
      const int64_t xr = (base + crow[s]) * kB + q0;
      const float* xp = xs + xr * m + j0;
#pragma unroll
      for (int j = 0; j < MS; ++j) {
        if (j < ms) {
          float a = acc[j];
          a = fmaf(v.x, xp[j], a);
          a = fmaf(v.y, xp[m + j], a);
          a = fmaf(v.z, xp[2 * m + j], a);
          a = fmaf(v.w, xp[3 * m + j], a);
          acc[j] = a;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MS; ++j) {
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 1);
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 16);
    }
    if (lane < 16 && (lane & 1) == 0) {
      float* yp = p.y + ((size_t)r * kB + i) * m + j0;
#pragma unroll
      for (int j = 0; j < MS; ++j)
        if (j < ms) yp[j] = acc[j];
    }
  }
}

template <int MS, int MODE>
int launch_ms(const Params& p, cudaStream_t stream) {
  auto kernel = bsr_spmm_kernel<MS, MODE>;
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
template <int MODE>
int launch(const Params& p, cudaStream_t stream) {
  if (p.m == 1) return launch_ms<1, MODE>(p, stream);
  if (p.m == 2) return launch_ms<2, MODE>(p, stream);
  if (p.m <= 4) return launch_ms<4, MODE>(p, stream);
  if (p.m <= 8) return launch_ms<8, MODE>(p, stream);
  if (p.m <= 12) return launch_ms<12, MODE>(p, stream);
  return launch_ms<16, MODE>(p, stream);
}

Params make_params(const void* blocks, const void* cols, const void* win_start,
                   const void* slot_count, const void* x, void* y, int64_t nbr,
                   int64_t S, int64_t m, int64_t wu) {
  Params p;
  p.blocks = static_cast<const float*>(blocks);
  p.cols = static_cast<const int32_t*>(cols);
  p.win_start = static_cast<const int32_t*>(win_start);
  p.slot_count = static_cast<const int32_t*>(slot_count);
  p.x = static_cast<const float*>(x);
  p.y = static_cast<float*>(y);
  p.nbr = nbr; p.S = S; p.m = m; p.wu = wu;
  return p;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. Shapes, types and tile alignment are
// checked by the Python wrappers (kernels/bsr_spmm.py); a staged window
// larger than the device's shared memory comes back as the
// cudaFuncSetAttribute error, with no launch.

extern "C" int bsr_matmat_f32(const void* blocks, const void* cols,
                              const void* slot_count, const void* x, void* y,
                              int64_t nbr, int64_t S, int64_t m, void* stream) {
  const Params p = make_params(blocks, cols, nullptr, slot_count, x, y, nbr, S,
                               m, 0);
  return launch<kDirect>(p, (cudaStream_t)stream);
}

extern "C" int bsr_matmat_windowed_f32(
    const void* blocks, const void* cols_rel, const void* win_start,
    const void* slot_count, const void* x, void* y, int64_t nbr, int64_t S,
    int64_t m, int64_t wu, int64_t staged, void* stream) {
  const Params p = make_params(blocks, cols_rel, win_start, slot_count, x, y,
                               nbr, S, m, wu);
  if (staged) return launch<kWindowShared>(p, (cudaStream_t)stream);
  return launch<kWindowGlobal>(p, (cudaStream_t)stream);
}
