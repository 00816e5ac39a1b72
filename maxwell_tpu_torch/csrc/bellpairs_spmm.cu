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
// below the f32 peak. Measured on an H100 SXM (80 GB, 700 W; PERF.md): the
// fused form at 24^3, m 9 reads its 86 MB in 0.047 ms (1.85 TB/s), against
// 0.097 ms for the first kernel here, which issued 36 scalar X loads and
// 72 f32 FMAs per slot and lane.
//
// Design (the blocked-ELL body of bsr_spmm.cu, on 16-wide pair panels):
// - One warp per block row, four per block; no atomics, each output element
//   is written once, so repeated runs agree bit for bit, and the one-stream,
//   fused, windowed and banded forms agree bit for bit where their X values
//   agree (only X's address differs between them). Lane (g, t) =
//   (lane / 4, lane % 4) loads values (g, 4t .. 4t + 3) of each (8, 16)
//   panel with one 16-byte load (a slot's 512 B in one coalesced warp load
//   per stream); the loads of the next step's slots (four on the f32
//   route, two on the mma route, where four measured slower) are issued
//   before the current step's are used. The row's columns come 32 slots at
//   a time in one coalesced warp load (the next 32 prefetched) and are
//   broadcast with __shfl_sync: no dependent column load per slot. The
//   first slots' values and columns are loaded beside npairs, before the
//   row's length is known (padding slots hold zero values and column 0, so
//   the loads stay in bounds).
// - m >= 3: products on the tensor cores, mma.sync m16n8k8 in TF32 with f32
//   accumulation, three passes per product (tf32x3.cuh: 3xTF32, the
//   counterpart of the reference's Precision.HIGHEST; never single-pass
//   TF32). The product is taken transposed, Y^T = Xg^T V^T: a slot's (8, 16)
//   panel is two k8 x n8 B operands (n: the panel's 8 rows). The lane's four
//   values feed both k-steps: (4t, 4t + 1) k-step 0 and (4t + 2, 4t + 3)
//   k-step 1, as b0 = V[g, 4t + 2s], b1 = V[g, 4t + 2s + 1]; A's k order is
//   permuted alike (PTX k = t <-> X row 8c + 4t + 2s, k = t + 4 <-> X row
//   8c + 4t + 2s + 1), which leaves the product as it is. A (16 x k8) is 16
//   columns of X by those rows (zero past m), D is Y^T for 16 columns. Per
//   slot and k-step the products go small terms first: lo_x hi_v, hi_x lo_v,
//   hi_x hi_v. X's columns are walked in 16-wide m-tiles inside the warp with
//   the value fragments in registers, so each value is read once for up to
//   128 columns (wider X: one launch per 128 columns). In the fused form
//   each A fragment is split once and feeds both streams: 12 mma per slot
//   and m-tile.
// - m = 1, 2: f32 FMAs on the same value loads; each lane sums its four
//   values against X's four rows, and two xor shuffles finish the row's sum
//   over its four lanes.
// - The slot's X operand, 16 consecutive rows from 8 c(r, q), is read as
//   4-byte fragment loads from L2 (X, 1.4 MB at m = 9, stays there).
// - No slot reads past the X it is given: pairs end at block column
//   nbr - 1 and the builder clamps a last-column singleton (checked on the
//   host when the layout is built), so X needs no padding.
// - The windowed form reads X through the tile's window. Where the window
//   (2 Wu b rows x m) fits in shared memory, one 512-thread block per tile
//   stages it there first (16 warps, one per block row); otherwise it reads
//   the window from global memory. The caller chooses and reports which.
// - Offsets into the value stream are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"  // tf32_rna, split_tf32, mma_tf32

namespace {

constexpr int kB = 8;              // block size
constexpr int kPair = 2 * kB;      // values per panel row (two blocks)
constexpr int kTileRows = 16;      // block rows per 128-row tile
constexpr int kWarpsPerCta = 4;    // direct and global-window launches
constexpr int kUnrollFma = 4;      // slots per step, m = 1, 2
constexpr int kUnrollMma = 2;      // slots per step, m >= 3
constexpr int kColBatch = 32;      // slots per coalesced column load
constexpr int kMTile = 16;         // X columns per mma (its m16)
constexpr int kPassCols = 128;     // X columns per launch on the mma route

enum Mode { kDirect = 0, kWindowGlobal = 1, kWindowShared = 2 };

struct Params {
  const float* vals;          // (8 nbr, 16 Q) stream applied (a or b)
  const float* vals_b;        // (8 nbr, 16 Q) second stream, fused form only
  const int32_t* cols;        // (nbr, Q) absolute, or relative to the window
  const int32_t* win_start;   // (nbr / 16,) windowed forms only
  const int32_t* npairs;      // (nbr,)
  const float* x;             // (rows, ld) row-major, at this pass's column
  float* y;                   // (8 nbr, ld) row-major, at this pass's column
  float* y_b;                 // (8 nbr, ld), fused form only
  int64_t nbr;
  int64_t Q;
  int64_t ld;                 // m: the row stride of X and Y
  int64_t mw;                 // columns of this launch (<= kPassCols)
  int64_t wu;                 // window unit in block rows (windowed forms)
};

template <bool SMEM>
__device__ __forceinline__ float ldx(const float* p) {
  return SMEM ? *p : __ldg(p);
}

__device__ __forceinline__ float4 ldv(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// W: the launch's width class: 1 or 2 (f32 FMAs, mw == W) or 16, 32, 64,
// 128 (3xTF32 mma on W / 16 m-tiles, mw <= W). FUSED: two value streams
// against one X operand.
template <int W, int MODE, bool FUSED>
__global__ void __launch_bounds__(MODE == kWindowShared ? kTileRows * 32
                                                        : kWarpsPerCta * 32)
bellpairs_kernel(const Params p) {
  constexpr bool kMma = W > 2;
  constexpr int kUnroll = kMma ? kUnrollMma : kUnrollFma;
  constexpr int MT = kMma ? W / kMTile : 1;
  constexpr int NS = FUSED ? 2 : 1;  // value streams
  constexpr bool SMEM = MODE == kWindowShared;
  extern __shared__ __align__(16) float xwin[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int Q = (int)p.Q;
  const int mw = (int)p.mw;

  int64_t r;
  if (SMEM) {
    r = (int64_t)blockIdx.x * kTileRows + warp;
  } else {
    r = (int64_t)blockIdx.x * kWarpsPerCta + warp;
    if (r >= p.nbr) return;
  }
  // issued together: the row's length, its first 64 columns and its first
  // step's values
  const int32_t* crow = p.cols + r * p.Q;
  const size_t voff = ((size_t)r * kB + g) * (size_t)p.Q * kPair + 4 * t;
  const float* vrow[NS];
  vrow[0] = p.vals + voff;
  if (FUSED) vrow[NS - 1] = p.vals_b + voff;
  const int np = __ldg(p.npairs + r);
  int col_cur = lane < Q ? __ldg(crow + lane) : 0;
  int col_nxt = kColBatch + lane < Q ? __ldg(crow + kColBatch + lane) : 0;
  float4 v[NS][kUnroll];
#pragma unroll
  for (int st = 0; st < NS; ++st)
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[st][u] = u < Q ? ldv(vrow[st] + u * kPair)
                       : make_float4(0.f, 0.f, 0.f, 0.f);

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

  float d[NS][MT][4];
#pragma unroll
  for (int st = 0; st < NS; ++st)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      d[st][mt][0] = d[st][mt][1] = d[st][mt][2] = d[st][mt][3] = 0.f;

  for (int s = 0; s < np; s += kUnroll) {
    // the next step's values go out before this step's are used
    float4 vn[NS][kUnroll];
#pragma unroll
    for (int st = 0; st < NS; ++st)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int sn = s + kUnroll + u;
        vn[st][u] = sn < np ? ldv(vrow[st] + (size_t)sn * kPair)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    if (s > 0 && (s & (kColBatch - 1)) == 0) {
      col_cur = col_nxt;
      const int sc = s + kColBatch + lane;
      col_nxt = sc < Q ? __ldg(crow + sc) : 0;
    }
    // X rows 8 c + 4t .. 8 c + 4t + 3 of each slot (the lane's k quad)
    const float* xr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = __shfl_sync(0xffffffffu, col_cur, (s + u) & (kColBatch - 1));
      xr[u] = xs + ((base + c) * kB + 4 * t) * xld;
    }
    if constexpr (kMma) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt * kMTile >= mw) break;
        const int j = mt * kMTile + g;
        // A of k-step ks: a0 (X col j, row 4t + 2ks), a1 (col j + 8, same
        // row), a2 (col j, row 4t + 2ks + 1), a3 (col j + 8, that row);
        // zero past m
        float xa[kUnroll][8];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool live = s + u < np;
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // X row 4t + e
            const float* xp = xr[u] + e * xld;
            const int a = 4 * (e >> 1) + 2 * (e & 1);
            xa[u][a] = live && j < mw ? ldx<SMEM>(xp + j) : 0.f;
            xa[u][a + 1] = live && j + 8 < mw ? ldx<SMEM>(xp + j + 8) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (s + u >= np) break;
          uint32_t bh[NS][4], bl[NS][4];
#pragma unroll
          for (int st = 0; st < NS; ++st) {
            split_tf32(v[st][u].x, bh[st][0], bl[st][0]);
            split_tf32(v[st][u].y, bh[st][1], bl[st][1]);
            split_tf32(v[st][u].z, bh[st][2], bl[st][2]);
            split_tf32(v[st][u].w, bh[st][3], bl[st][3]);
          }
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            uint32_t ah[4], al[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              split_tf32(xa[u][4 * ks + q], ah[q], al[q]);
#pragma unroll
            for (int st = 0; st < NS; ++st) {
              mma_tf32(d[st][mt], al, bh[st][2 * ks], bh[st][2 * ks + 1]);
              mma_tf32(d[st][mt], ah, bl[st][2 * ks], bl[st][2 * ks + 1]);
              mma_tf32(d[st][mt], ah, bh[st][2 * ks], bh[st][2 * ks + 1]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s + u >= np) break;
#pragma unroll
        for (int jj = 0; jj < W; ++jj) {
          const float x0 = ldx<SMEM>(xr[u] + jj);
          const float x1 = ldx<SMEM>(xr[u] + xld + jj);
          const float x2 = ldx<SMEM>(xr[u] + 2 * xld + jj);
          const float x3 = ldx<SMEM>(xr[u] + 3 * xld + jj);
#pragma unroll
          for (int st = 0; st < NS; ++st) {
            float a = d[st][0][jj];
            a = fmaf(v[st][u].x, x0, a);
            a = fmaf(v[st][u].y, x1, a);
            a = fmaf(v[st][u].z, x2, a);
            a = fmaf(v[st][u].w, x3, a);
            d[st][0][jj] = a;
          }
        }
      }
    }
#pragma unroll
    for (int st = 0; st < NS; ++st)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[st][u] = vn[st][u];
  }

#pragma unroll
  for (int st = 0; st < NS; ++st) {
    float* yst = st == 0 ? p.y : p.y_b;
    if constexpr (kMma) {
      // D tile mt: rows X columns 16 mt + g (+ 8), columns panel rows 2t,
      // 2t + 1
      float* y0 = yst + (r * kB + 2 * t) * p.ld;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int j = mt * kMTile + g;
        if (j < mw) {
          y0[j] = d[st][mt][0];
          y0[p.ld + j] = d[st][mt][1];
        }
        if (j + 8 < mw) {
          y0[j + 8] = d[st][mt][2];
          y0[p.ld + j + 8] = d[st][mt][3];
        }
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < W; ++jj) {
        d[st][0][jj] += __shfl_xor_sync(0xffffffffu, d[st][0][jj], 1);
        d[st][0][jj] += __shfl_xor_sync(0xffffffffu, d[st][0][jj], 2);
      }
      if (t == 0) {
        float* yp = yst + (r * kB + g) * p.ld;
#pragma unroll
        for (int jj = 0; jj < W; ++jj) yp[jj] = d[st][0][jj];
      }
    }
  }
}

template <int W, int MODE, bool FUSED>
int launch_w(const Params& p, cudaStream_t stream) {
  auto kernel = bellpairs_kernel<W, MODE, FUSED>;
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
template <int MODE, bool FUSED>
int launch(Params p, cudaStream_t stream) {
  if (p.ld <= 2) {
    p.mw = p.ld;
    return p.ld == 1 ? launch_w<1, MODE, FUSED>(p, stream)
                     : launch_w<2, MODE, FUSED>(p, stream);
  }
  const float* x0 = p.x;
  float* y0 = p.y;
  float* yb0 = p.y_b;
  for (int64_t j0 = 0; j0 < p.ld; j0 += kPassCols) {
    p.x = x0 + j0;
    p.y = y0 + j0;
    if (FUSED) p.y_b = yb0 + j0;
    p.mw = p.ld - j0 < kPassCols ? p.ld - j0 : kPassCols;
    const int rc = p.mw <= 16   ? launch_w<16, MODE, FUSED>(p, stream)
                   : p.mw <= 32 ? launch_w<32, MODE, FUSED>(p, stream)
                   : p.mw <= 64 ? launch_w<64, MODE, FUSED>(p, stream)
                                : launch_w<128, MODE, FUSED>(p, stream);
    if (rc != 0) return rc;
  }
  return 0;
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
  p.nbr = nbr; p.Q = Q; p.ld = m; p.mw = m; p.wu = wu;
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
