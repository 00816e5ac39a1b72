// Blocked-ELL SpMM and SpMV for NVIDIA Hopper (sm_90a) on the 8x8-block
// layout of maxwell_tpu_torch/sparse/bsr.py.
//
// Replaces the Pallas TPU kernels in maxwell_tpu/kernels/spmm.py:
//   bsr_matmat_pallas           (_spmm_kernel)           -> bsr_matmat_f32
//   bsr_matmat_pallas_windowed  (_spmm_windowed_kernel)  -> bsr_matmat_windowed_f32
//   bsr_matvec_pallas           (m = 1 of bsr_matmat_pallas, X widened to 8
//                                lanes there; here bsr_matmat_f32 at m = 1,
//                                a true m = 1 launch)
// One body (bsr_spmm_kernel) serves all three; only X's address differs.
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
// while X (1.4 MB at m = 9) stays in L2. Each value is read once and each
// slot costs 3 mma per 16 columns; what K8 pays beside the value stream is
// the X gather, each slot's 8 X rows from L2 in 4-byte fragment loads
// (alone, K15c's v4_gather takes about as long as the value stream alone,
// and the two add).
//
// Design:
// - One warp per block row, four per block. Lane (g, t) = (lane / 4, lane % 4) loads values
//   (g, 2t) and (g, 2t + 1) of each 8x8 block with one 8-byte load (a
//   slot's 256 B in one coalesced warp load); the loads of the next four
//   slots are issued before the current four are used. The row's columns
//   come 32 slots at a time in one coalesced warp load (the next 32
//   prefetched) and are broadcast with __shfl_sync: no dependent column
//   load per slot. The first slots' values and columns are loaded beside
//   slot_count, before the row's length is known (padding slots hold zero
//   values and column 0, so the loads stay in bounds).
// - m >= 3: products on the tensor cores, mma.sync m16n8k8 in TF32 with f32
//   accumulation, three passes per product (3xTF32, the counterpart of the
//   TPU's multi-pass HIGHEST on its matrix unit; about 2^-22 relative error
//   per product, never single-pass TF32). The product is taken transposed,
//   Y^T = Xg^T V^T: an 8x8 block as stored is one k8 x n8 B operand
//   (b0 = V[g, 2t], b1 = V[g, 2t + 1]: the k order is permuted alike in A
//   and B, PTX k = t <-> q = 2t, k = t + 4 <-> q = 2t + 1, which leaves the
//   product as it is), A (16 x k8) is 16 columns of X by the slot's 8 X rows
//   (zero past m), D is Y^T for 16 columns. Each operand is split in
//   registers, hi = rna_tf32(a), lo = rna_tf32(a - hi) (round to nearest,
//   ties away, by integer add and mask), and the small terms go first:
//   lo_x hi_v, hi_x lo_v, then hi_x hi_v. X's columns are walked in
//   16-wide m-tiles inside the warp with the value fragments (split once)
//   in registers, so each value is read once for up to 128 columns (wider
//   X: one launch per 128 columns).
// - m = 1, 2 (the SpMV and the CG's one-column blocks): f32 FMAs, the same
//   value loads; each lane sums its two values against X's two rows, and
//   two xor shuffles finish the row's sum over its four lanes.
// - No atomics: each output element is written once, deterministically, so
//   runs repeat bit for bit, and the three entry points agree bit for bit
//   where their X values agree.
// - The windowed form reads X through the tile's window. Where the window
//   (2 Wu b rows x m) fits in shared memory, one 512-thread block per tile
//   stages it there first (16 warps, one per block row); otherwise it reads
//   the window from global memory. The caller chooses and reports which.
// - Offsets into the value stream are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"  // tf32_rna, split_tf32, mma_tf32

namespace {

constexpr int kB = 8;            // block size
constexpr int kBlockVals = kB * kB;
constexpr int kTileRows = 16;    // block rows per 128-row tile
constexpr int kWarpsPerCta = 4;  // direct and global-window launches
constexpr int kUnroll = 4;       // slots per step
constexpr int kColBatch = 32;    // slots per coalesced column load
constexpr int kMTile = 16;       // X columns per mma (its m16)
constexpr int kPassCols = 128;   // X columns per launch on the mma route

enum Mode { kDirect = 0, kWindowGlobal = 1, kWindowShared = 2 };

struct Params {
  const float* blocks;         // (nbr, S, 8, 8)
  const int32_t* cols;         // (nbr, S) absolute, or relative to the window
  const int32_t* win_start;    // (nbr / 16,) windowed forms only
  const int32_t* slot_count;   // (nbr,)
  const float* x;              // (rows, ld) row-major, at this pass's column
  float* y;                    // (8 nbr, ld) row-major, at this pass's column
  int64_t nbr;
  int64_t S;
  int64_t ld;                  // m: the row stride of X and Y
  int64_t mw;                  // columns of this launch (<= kPassCols)
  int64_t wu;                  // window unit in block rows (windowed forms)
};

template <bool SMEM>
__device__ __forceinline__ float ldx(const float* p) {
  return SMEM ? *p : __ldg(p);
}

__device__ __forceinline__ float2 ldv(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// W: the launch's width class: 1 or 2 (f32 FMAs, mw == W) or 16, 32, 64,
// 128 (3xTF32 mma on W / 16 m-tiles, mw <= W)
template <int W, int MODE>
__global__ void __launch_bounds__(MODE == kWindowShared ? kTileRows * 32
                                                        : kWarpsPerCta * 32)
bsr_spmm_kernel(const Params p) {
  constexpr bool kMma = W > 2;
  constexpr int MT = kMma ? W / kMTile : 1;
  constexpr bool SMEM = MODE == kWindowShared;
  extern __shared__ __align__(16) float xwin[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int S = (int)p.S;
  const int mw = (int)p.mw;

  int64_t r;
  if (SMEM) {
    r = (int64_t)blockIdx.x * kTileRows + warp;
  } else {
    r = (int64_t)blockIdx.x * kWarpsPerCta + warp;
    if (r >= p.nbr) return;
  }
  // issued together: the row's length, its first 64 columns and its first
  // step's values (padding slots hold zero values and column 0, so these
  // loads stay in bounds before the row's length is known)
  const int32_t* crow = p.cols + r * p.S;
  const float* vrow = p.blocks + r * p.S * kBlockVals + g * kB + 2 * t;
  const int ns = __ldg(p.slot_count + r);
  int col_cur = lane < S ? __ldg(crow + lane) : 0;
  int col_nxt = kColBatch + lane < S ? __ldg(crow + kColBatch + lane) : 0;
  float2 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    v[u] = u < S ? ldv(vrow + (int64_t)u * kBlockVals) : make_float2(0.f, 0.f);

  int64_t base = 0;  // block column added to each slot's column
  const float* xs = p.x;
  int64_t xld = p.ld;
  if (SMEM) {
    const int64_t tile = blockIdx.x;
    const int64_t rows = 2 * p.wu * kB;
    const float* src = p.x + (int64_t)p.win_start[tile] * p.wu * kB * p.ld;
    const int n = (int)(rows * mw);  // fits: the window fits shared memory
    if (mw == p.ld) {
      for (int k = threadIdx.x; k < n; k += blockDim.x) xwin[k] = src[k];
    } else {  // this pass's columns of each window row
      for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const int row = k / mw;
        xwin[k] = src[(int64_t)row * p.ld + (k - row * mw)];
      }
    }
    __syncthreads();
    xs = xwin;  // columns are relative to the window's first block row
    xld = mw;
  } else if (MODE == kWindowGlobal) {
    base = (int64_t)__ldg(p.win_start + r / kTileRows) * p.wu;
  }

  float d[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) d[mt][0] = d[mt][1] = d[mt][2] =
      d[mt][3] = 0.f;

  for (int s = 0; s < ns; s += kUnroll) {
    // the next step's values go out before this step's are used
    float2 vn[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int sn = s + kUnroll + u;
      vn[u] = sn < ns ? ldv(vrow + (int64_t)sn * kBlockVals)
                      : make_float2(0.f, 0.f);
    }
    if (s > 0 && (s & (kColBatch - 1)) == 0) {
      col_cur = col_nxt;
      const int sc = s + kColBatch + lane;
      col_nxt = sc < S ? __ldg(crow + sc) : 0;
    }
    // X rows 8 c + 2t and 8 c + 2t + 1 of each slot (the lane's k pair)
    const float* xr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = __shfl_sync(0xffffffffu, col_cur, (s + u) & (kColBatch - 1));
      xr[u] = xs + ((base + c) * kB + 2 * t) * xld;
    }
    if constexpr (kMma) {
      uint32_t bh[kUnroll][2], bl[kUnroll][2];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        split_tf32(v[u].x, bh[u][0], bl[u][0]);
        split_tf32(v[u].y, bh[u][1], bl[u][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt * kMTile >= mw) break;
        const int j = mt * kMTile + g;
        float xa[kUnroll][4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool live = s + u < ns;
          // A: a0 (X col j, k = t), a1 (col j + 8, k = t), a2 (col j,
          // k = t + 4), a3 (col j + 8, k = t + 4); zero past m
          xa[u][0] = live && j < mw ? ldx<SMEM>(xr[u] + j) : 0.f;
          xa[u][1] = live && j + 8 < mw ? ldx<SMEM>(xr[u] + j + 8) : 0.f;
          xa[u][2] = live && j < mw ? ldx<SMEM>(xr[u] + xld + j) : 0.f;
          xa[u][3] = live && j + 8 < mw ? ldx<SMEM>(xr[u] + xld + j + 8)
                                        : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (s + u >= ns) break;
          uint32_t ah[4], al[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(xa[u][q], ah[q], al[q]);
          mma_tf32(d[mt], al, bh[u][0], bh[u][1]);
          mma_tf32(d[mt], ah, bl[u][0], bl[u][1]);
          mma_tf32(d[mt], ah, bh[u][0], bh[u][1]);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s + u >= ns) break;
#pragma unroll
        for (int jj = 0; jj < W; ++jj) {
          float a = d[0][jj];
          a = fmaf(v[u].x, ldx<SMEM>(xr[u] + jj), a);
          a = fmaf(v[u].y, ldx<SMEM>(xr[u] + xld + jj), a);
          d[0][jj] = a;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = vn[u];
  }

  if constexpr (kMma) {
    // D tile mt: rows X columns 16 mt + g (+ 8), columns block rows 2t, 2t + 1
    float* y0 = p.y + (r * kB + 2 * t) * p.ld;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int j = mt * kMTile + g;
      if (j < mw) {
        y0[j] = d[mt][0];
        y0[p.ld + j] = d[mt][1];
      }
      if (j + 8 < mw) {
        y0[j + 8] = d[mt][2];
        y0[p.ld + j + 8] = d[mt][3];
      }
    }
  } else {
#pragma unroll
    for (int jj = 0; jj < W; ++jj) {
      d[0][jj] += __shfl_xor_sync(0xffffffffu, d[0][jj], 1);
      d[0][jj] += __shfl_xor_sync(0xffffffffu, d[0][jj], 2);
    }
    if (t == 0) {
      float* yp = p.y + (r * kB + g) * p.ld;
#pragma unroll
      for (int jj = 0; jj < W; ++jj) yp[jj] = d[0][jj];
    }
  }
}

template <int W, int MODE>
int launch_w(const Params& p, cudaStream_t stream) {
  auto kernel = bsr_spmm_kernel<W, MODE>;
  if (MODE == kWindowShared) {
    const size_t smem = (size_t)2 * p.wu * kB * p.mw * sizeof(float);
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

// m = 1, 2: one f32 launch; m >= 3: one mma launch per 128 columns, each of
// the smallest width class that holds them (m = 9, the solver's block: 16)
template <int MODE>
int launch(Params p, cudaStream_t stream) {
  if (p.ld <= 2) {
    p.mw = p.ld;
    return p.ld == 1 ? launch_w<1, MODE>(p, stream)
                     : launch_w<2, MODE>(p, stream);
  }
  const float* x0 = p.x;
  float* y0 = p.y;
  for (int64_t j0 = 0; j0 < p.ld; j0 += kPassCols) {
    p.x = x0 + j0;
    p.y = y0 + j0;
    p.mw = p.ld - j0 < kPassCols ? p.ld - j0 : kPassCols;
    const int rc = p.mw <= 16   ? launch_w<16, MODE>(p, stream)
                   : p.mw <= 32 ? launch_w<32, MODE>(p, stream)
                   : p.mw <= 64 ? launch_w<64, MODE>(p, stream)
                                : launch_w<128, MODE>(p, stream);
    if (rc != 0) return rc;
  }
  return 0;
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
  p.nbr = nbr; p.S = S; p.ld = m; p.mw = m; p.wu = wu;
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
