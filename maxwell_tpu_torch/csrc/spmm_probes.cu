// Blocked-ELL SpMM probes for NVIDIA Hopper (sm_90a): the H100 counterparts
// of the TPU kernels inside main() of maxwell_tpu/bench/exp_spmm.py (K15c).
// No solver calls them; the probe script maxwell_tpu_torch/bench/exp_spmm.py
// does. The gather-only variant v4_gather is gather_sum of
// csrc/gather_probes.cu.
//
// The probe's data (exp_spmm.py:68-85): the blocked-ELL layout of the 24^3
// RCM brick's K, nbr = 4,768 block rows of S = 64 slots of 8 x 8 blocks,
// as the transposed value panel blocks2d (nbr b, S b) f32 (row r b + i,
// column s b + k: 78.1 MB), cols (nbr, S) int32, X (rows, m) f32 at m in
// {8, 32, 64, 128}. A tile is R = 16 block rows, 128 output rows; one block
// of 16 warps per tile in every variant, so that neighbours on the ladder
// below differ in one thing only.
//
//   bsr_f32<UNSTAGED>   v5_batched_hi (:260-291, pallas_call :277,
//                       HIGHEST): Y = A X, warp w owns block row w of the
//                       tile; per slot, the (8, m) X slice is read from
//                       global memory (L2) into registers as it is used,
//                       true f32 FMAs. Lane l owns columns 4 (l % (m/4)) ..
//                       +3 of 8 / (32 / (m/4)) rows (at m 8: one row and
//                       half the slot's k, the halves summed by a shuffle).
//   bsr_f32<PANEL>      v1_panel_hi (:111-142, :127, HIGHEST): as v5_hi,
//                       but each row's gathered X panel is first staged in
//                       shared memory (v1's VMEM scratch, :116), in chunks
//                       of 2 slots (16 X rows) at every m: a whole (S b, m)
//                       panel per warp (16 KB to 256 KB) does not fit.
//   bsr_f32<SMEM_COLS>  v6_smem_hi (:226-258, :244): as v5_hi, but the
//                       tile's (R, S) cols are staged in shared memory once,
//                       before the loop (the TPU's SMEM block).
//   bsr_bf16<false>     v5_batched_def (:277, DEFAULT): as v5_hi, but the
//                       f32 values and X slices are rounded to bf16 (nearest
//                       even) in registers and multiplied by mma.sync
//                       m16n8k16 into f32. The product is taken transposed,
//                       Y^T = Xg^T V^T: the block row's 8 rows are the
//                       instruction's n8, X's columns its m16 (at m 8 half
//                       the m16 rows are zero); a k16 step is two slots.
//   bsr_bf16<true>      v2_panel_def (:127, DEFAULT): as v5_def, with v1's
//                       staged 2-slot chunks (one k16 step each).
//   stream_bf16<false>  v3_stream (:144-171, :159): as v2_def without the
//                       gather: every block row's values @ the fixed panel
//                       X[0:S b], staged once per block where it fits
//                       (m <= 64), else read from L2; one transposed
//                       product per 8-row block. (The TPU failed to lower
//                       it: scatter.)
//   stream_bf16<true>   v3b_onedot (:173-196, :184): the same function, one
//                       (128, S b) @ (S b, m) product per tile: the values'
//                       rows are the m16 rows (two block rows per m16 tile,
//                       not transposed), X's columns the n8. Warp w takes
//                       row tile w / 2 and half w % 2 of the k range; the
//                       halves are summed through shared memory. The one
//                       change from v3: the product's shape.
//
// Bounds (at the card's published rates, the probe's inputs once): 78.1 MB
// of values dominate at m 8 (~0.024 ms by bytes); at m 128 the 5.0 GFLOP
// of the product take ~0.075 ms at the f32 peak (bf16: 0.005 ms, so the
// _def variants and v3/v3b stay bound by bytes). What the design does
// about it: the values are streamed once with 16-byte loads marked
// evict-first (__ldcs), each block row's 2 KB rows read by one warp; X
// slices (32 m bytes, contiguous) are read with 16-byte loads in the f32
// variants, as aligned scalars in the mma fragments. Every output is
// written once by one thread: no atomics, runs repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 16;              // block rows per tile
constexpr int kB = 8;               // rows and columns of a block
constexpr int kWarps = kR;          // one warp per block row
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 2;           // slots per staged chunk (v1, v2)
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100

enum { kUnstaged = 0, kPanel = 1, kSmemCols = 2 };

struct Params {
  const float* v;       // blocks2d (nbr b, S b)
  const int32_t* cols;  // (nbr, S)
  const float* x;       // (rows, m)
  float* y;             // (nbr b, m)
  int64_t S;
};

template <bool SMEM>
__device__ __forceinline__ float ld(const float* p) {
  return SMEM ? *p : __ldg(p);
}

template <bool SMEM>
__device__ __forceinline__ float4 ld4(const float* p) {
  return SMEM ? *reinterpret_cast<const float4*>(p)
              : __ldg(reinterpret_cast<const float4*>(p));
}

// Warp-private chunk of kChunk slots of block row r's X panel: 16 rows of
// m floats at stride XS, read with 16-byte loads
template <int M, int XS>
__device__ __forceinline__ void stage_chunk(const Params& p,
                                            const int32_t* crow, int64_t s0,
                                            float* panel, int lane) {
  constexpr int CG = M / 4;
  __syncwarp();
  for (int e = lane; e < kChunk * kB * CG; e += 32) {
    const int kk = e / CG;
    const int f = e - kk * CG;
    const int64_t c = __ldg(crow + s0 + kk / kB);
    *reinterpret_cast<float4*>(panel + kk * XS + 4 * f) =
        ld4<false>(p.x + (c * kB + kk % kB) * M + 4 * f);
  }
  __syncwarp();
}

template <int M, int MODE>
__global__ void __launch_bounds__(kThreads)
bsr_f32_kernel(const Params p) {
  constexpr int CG = M / 4;                   // lanes across a row of X
  constexpr int RG = 32 / CG;                 // row groups of lanes
  constexpr int KS = RG >= 8 ? RG / 8 : 1;    // k splits (m 8: 2)
  constexpr int RPL = RG >= 8 ? 1 : 8 / RG;   // rows per lane
  constexpr int KPL = kB / KS;                // k per lane
  constexpr int XS = M + 4;                   // staged panel row stride
  constexpr int STEP = MODE == kPanel ? kChunk : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kR + warp;
  const int64_t ld_v = p.S * kB;
  const int cg = lane % CG;
  const int rg = lane / CG;
  const int i0 = KS > 1 ? rg % kB : rg;
  const int k0 = KS > 1 ? (rg / kB) * KPL : 0;
  const int32_t* crow = p.cols + r * p.S;
  int32_t* scols = reinterpret_cast<int32_t*>(smem);
  float* panel = reinterpret_cast<float*>(smem) + warp * kChunk * kB * XS;
  if (MODE == kSmemCols) {
    const int32_t* tc = p.cols + (int64_t)blockIdx.x * kR * p.S;
    for (int i = threadIdx.x; i < kR * p.S; i += kThreads)
      scols[i] = __ldg(tc + i);
    __syncthreads();
  }
  const float* vrow = p.v + (r * kB + i0) * ld_v + k0;
  float acc[RPL][4];
#pragma unroll
  for (int t = 0; t < RPL; ++t) acc[t][0] = acc[t][1] = acc[t][2] =
      acc[t][3] = 0.f;
  for (int64_t s0 = 0; s0 < p.S; s0 += STEP) {
    if (MODE == kPanel) stage_chunk<M, XS>(p, crow, s0, panel, lane);
#pragma unroll
    for (int sl = 0; sl < STEP; ++sl) {
      const int64_t s = s0 + sl;
      const float* xs;
      int64_t xstride;
      if (MODE == kPanel) {
        xs = panel + sl * kB * XS + 4 * cg;
        xstride = XS;
      } else {
        const int64_t c =
            MODE == kSmemCols ? scols[warp * p.S + s] : __ldg(crow + s);
        xs = p.x + c * kB * M + 4 * cg;
        xstride = M;
      }
#pragma unroll
      for (int kq = 0; kq < KPL / 4; ++kq) {
        float4 vq[RPL];
#pragma unroll
        for (int t = 0; t < RPL; ++t)
          vq[t] = __ldcs(reinterpret_cast<const float4*>(
              vrow + t * RG * ld_v + s * kB + 4 * kq));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 xv =
              ld4<MODE == kPanel>(xs + (k0 + 4 * kq + q) * xstride);
#pragma unroll
          for (int t = 0; t < RPL; ++t) {
            const float a = q == 0 ? vq[t].x : q == 1 ? vq[t].y
                          : q == 2 ? vq[t].z : vq[t].w;
            acc[t][0] = fmaf(a, xv.x, acc[t][0]);
            acc[t][1] = fmaf(a, xv.y, acc[t][1]);
            acc[t][2] = fmaf(a, xv.z, acc[t][2]);
            acc[t][3] = fmaf(a, xv.w, acc[t][3]);
          }
        }
      }
    }
  }
  if (KS > 1) {  // the two k halves: lanes kB * CG apart
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[0][j] += __shfl_xor_sync(0xffffffffu, acc[0][j], kB * CG);
  }
  if (k0 == 0) {
#pragma unroll
    for (int t = 0; t < RPL; ++t)
      *reinterpret_cast<float4*>(p.y + (r * kB + i0 + t * RG) * M + 4 * cg) =
          make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D (16 x 8, f32) += A (16 x 16, bf16, row) @ B (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Fragments: thread (g = lane / 4, tig = lane % 4) holds k = 4 tig .. 4 tig
// + 3 of a k16 step in the PTX positions 2 tig, 2 tig + 1, 2 tig + 8, 2 tig
// + 9, in A and B alike (one permutation of k leaves the product as it
// is), so that a value row's four k load as one float4.
//
// One k16 step of the transposed product Y^T (m x 8) += Xg^T V^T: xr holds
// the thread's four X rows (row q at xr + q xs) of the step, b0/b1 its V
// row g's four k. D tile mt: rows = X columns 16 mt + g (+ 8), columns =
// the block row's rows 2 tig, 2 tig + 1.
template <int M, bool SMEM>
__device__ __forceinline__ void xt_step(float (&d)[M >= 16 ? M / 16 : 1][4],
                                        const float* xr, int64_t xs, int g,
                                        uint32_t b0, uint32_t b1) {
  constexpr int MT = M >= 16 ? M / 16 : 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int j = 16 * mt + g;
    const uint32_t a0 = pack_bf16(ld<SMEM>(xr + j), ld<SMEM>(xr + xs + j));
    const uint32_t a2 =
        pack_bf16(ld<SMEM>(xr + 2 * xs + j), ld<SMEM>(xr + 3 * xs + j));
    uint32_t a1 = 0, a3 = 0;  // m 8: X columns 8 .. 15 do not exist
    if (M >= 16) {
      a1 = pack_bf16(ld<SMEM>(xr + j + 8), ld<SMEM>(xr + xs + j + 8));
      a3 = pack_bf16(ld<SMEM>(xr + 2 * xs + j + 8),
                     ld<SMEM>(xr + 3 * xs + j + 8));
    }
    mma_bf16(d[mt], a0, a1, a2, a3, b0, b1);
  }
}

// Y rows r b + 2 tig, r b + 2 tig + 1 of the transposed product's D tiles
template <int M>
__device__ __forceinline__ void xt_store(float* y, int64_t r,
                                         float (&d)[M >= 16 ? M / 16 : 1][4],
                                         int g, int tig) {
  constexpr int MT = M >= 16 ? M / 16 : 1;
  float* y0 = y + (r * kB + 2 * tig) * M;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int j = 16 * mt + g;
    y0[j] = d[mt][0];
    y0[M + j] = d[mt][1];
    if (M >= 16) {
      y0[j + 8] = d[mt][2];
      y0[M + j + 8] = d[mt][3];
    }
  }
}

template <int M, bool STAGED>
__global__ void __launch_bounds__(kThreads)
bsr_bf16_kernel(const Params p) {
  constexpr int MT = M >= 16 ? M / 16 : 1;
  constexpr int XS = M + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int64_t r = (int64_t)blockIdx.x * kR + warp;
  const int32_t* crow = p.cols + r * p.S;
  float* panel = reinterpret_cast<float*>(smem) + warp * kChunk * kB * XS;
  const float* vg = p.v + (r * kB + g) * p.S * kB + 4 * tig;
  float d[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) d[mt][0] = d[mt][1] = d[mt][2] =
      d[mt][3] = 0.f;
  for (int64_t ks = 0; ks < p.S / kChunk; ++ks) {  // slots 2 ks, 2 ks + 1
    if (STAGED) stage_chunk<M, XS>(p, crow, ks * kChunk, panel, lane);
    const float4 v = __ldcs(reinterpret_cast<const float4*>(vg + ks * 16));
    const uint32_t b0 = pack_bf16(v.x, v.y);
    const uint32_t b1 = pack_bf16(v.z, v.w);
    if (STAGED) {
      // chunk row 8 (tig / 2) + 4 (tig % 2) + q = 4 tig + q
      xt_step<M, true>(d, panel + 4 * tig * XS, XS, g, b0, b1);
    } else {
      const int64_t c = __ldg(crow + ks * kChunk + (tig >> 1));
      xt_step<M, false>(d, p.x + (c * kB + 4 * (tig & 1)) * M, M, g, b0, b1);
    }
  }
  xt_store<M>(p.y, r, d, g, tig);
}

// The fixed panel X[0 : S b] staged in shared memory at row stride M + 4
template <int M>
__device__ __forceinline__ void stage_fixed(const float* x, int64_t P,
                                            float* panel) {
  constexpr int CG = M / 4;
  for (int64_t e = threadIdx.x; e < P * CG; e += kThreads) {
    const int64_t row = e / CG;
    const int f = (int)(e - row * CG);
    *reinterpret_cast<float4*>(panel + row * (M + 4) + 4 * f) =
        ld4<false>(x + row * M + 4 * f);
  }
  __syncthreads();
}

// v3_stream: warp w, block row w of the tile, Y^T = X[0:P]^T V^T
template <int M, bool STAGED>
__global__ void __launch_bounds__(kThreads)
stream_bf16_kernel(const Params p) {
  constexpr int MT = M >= 16 ? M / 16 : 1;
  constexpr int XS = M + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* panel = reinterpret_cast<float*>(smem);
  const int64_t P = p.S * kB;
  if (STAGED) stage_fixed<M>(p.x, P, panel);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int64_t r = (int64_t)blockIdx.x * kR + warp;
  const float* vg = p.v + (r * kB + g) * P + 4 * tig;
  float d[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) d[mt][0] = d[mt][1] = d[mt][2] =
      d[mt][3] = 0.f;
  for (int64_t k0 = 0; k0 < P; k0 += 16) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(vg + k0));
    const uint32_t b0 = pack_bf16(v.x, v.y);
    const uint32_t b1 = pack_bf16(v.z, v.w);
    if (STAGED)
      xt_step<M, true>(d, panel + (k0 + 4 * tig) * XS, XS, g, b0, b1);
    else
      xt_step<M, false>(d, p.x + (k0 + 4 * tig) * M, M, g, b0, b1);
  }
  xt_store<M>(p.y, r, d, g, tig);
}

// v3b_onedot: warp w, rows 16 (w / 2) .. + 15 of the tile and half w % 2 of
// the k range, Y = V X[0:P]; D tile nt: rows g, g + 8, columns 8 nt + 2 tig
template <int M, bool STAGED>
__global__ void __launch_bounds__(kThreads)
onedot_bf16_kernel(const Params p) {
  constexpr int NT = M / 8;
  constexpr int XS = M + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t P = p.S * kB;
  float* panel = reinterpret_cast<float*>(smem);
  float* red = panel + (STAGED ? P * XS : 0);  // [8][NT][4][32]
  if (STAGED) stage_fixed<M>(p.x, P, panel);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int rt = warp >> 1;
  const int kh = warp & 1;
  const int64_t row0 = (int64_t)blockIdx.x * kR * kB + 16 * rt;
  const float* va = p.v + (row0 + g) * P + 4 * tig;
  const float* vb = va + 8 * P;
  const float* xb = STAGED ? panel : p.x;
  const int64_t xs = STAGED ? XS : M;
  float d[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) d[nt][0] = d[nt][1] = d[nt][2] =
      d[nt][3] = 0.f;
  for (int64_t k0 = kh * (P / 2); k0 < (kh + 1) * (P / 2); k0 += 16) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(va + k0));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(vb + k0));
    const uint32_t a0 = pack_bf16(a.x, a.y), a1 = pack_bf16(b.x, b.y);
    const uint32_t a2 = pack_bf16(a.z, a.w), a3 = pack_bf16(b.z, b.w);
    const float* xr = xb + (k0 + 4 * tig) * xs;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = 8 * nt + g;
      mma_bf16(d[nt], a0, a1, a2, a3,
               pack_bf16(ld<STAGED>(xr + n), ld<STAGED>(xr + xs + n)),
               pack_bf16(ld<STAGED>(xr + 2 * xs + n),
                         ld<STAGED>(xr + 3 * xs + n)));
    }
  }
  if (kh == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) red[((rt * NT + nt) * 4 + q) * 32 + lane] =
          d[nt][q];
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        d[nt][q] += red[((rt * NT + nt) * 4 + q) * 32 + lane];
      float* y = p.y + (row0 + g) * M + 8 * nt + 2 * tig;
      *reinterpret_cast<float2*>(y) = make_float2(d[nt][0], d[nt][1]);
      *reinterpret_cast<float2*>(y + 8 * M) = make_float2(d[nt][2], d[nt][3]);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int64_t tiles, size_t smem,
           cudaStream_t stream) {
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)tiles, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int M>
int f32_m(const Params& p, int64_t tiles, int64_t mode, cudaStream_t st) {
  constexpr size_t chunk = (size_t)kWarps * kChunk * kB * (M + 4) * 4;
  if (mode == kUnstaged)
    return launch(bsr_f32_kernel<M, kUnstaged>, p, tiles, 0, st);
  if (mode == kPanel) return launch(bsr_f32_kernel<M, kPanel>, p, tiles,
                                    chunk, st);
  if (mode == kSmemCols)
    return launch(bsr_f32_kernel<M, kSmemCols>, p, tiles,
                  (size_t)kR * p.S * 4, st);
  return (int)cudaErrorInvalidValue;
}

template <int M>
int bf16_m(const Params& p, int64_t tiles, int64_t staged, cudaStream_t st) {
  constexpr size_t chunk = (size_t)kWarps * kChunk * kB * (M + 4) * 4;
  return staged ? launch(bsr_bf16_kernel<M, true>, p, tiles, chunk, st)
                : launch(bsr_bf16_kernel<M, false>, p, tiles, 0, st);
}

template <int M>
int stream_m(const Params& p, int64_t tiles, int64_t onedot, int64_t staged,
             cudaStream_t st) {
  const size_t panel = staged ? (size_t)p.S * kB * (M + 4) * 4 : 0;
  if (onedot) {
    const size_t red = (size_t)kWarps / 2 * (M / 8) * 4 * 32 * 4;
    return staged
        ? launch(onedot_bf16_kernel<M, true>, p, tiles, panel + red, st)
        : launch(onedot_bf16_kernel<M, false>, p, tiles, red, st);
  }
  return staged ? launch(stream_bf16_kernel<M, true>, p, tiles, panel, st)
                : launch(stream_bf16_kernel<M, false>, p, tiles, 0, st);
}

Params params(const void* v, const void* cols, const void* x, void* y,
              int64_t S) {
  return Params{static_cast<const float*>(v),
                static_cast<const int32_t*>(cols),
                static_cast<const float*>(x), static_cast<float*>(y), S};
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch (or the error of an unsupported m or mode): 0 on
// success. Shapes, types, alignment and index ranges are checked by the
// Python wrappers (maxwell_tpu_torch/kernels/spmm_probes.py). nbr is a
// multiple of 16, S of 4, m one of 8, 32, 64, 128.

// mode 0: v5_batched_hi, 1: v1_panel_hi, 2: v6_smem_hi
extern "C" int spmm_probe_f32(const void* v, const void* cols, const void* x,
                              void* y, int64_t nbr, int64_t S, int64_t m,
                              int64_t mode, void* stream) {
  const Params p = params(v, cols, x, y, S);
  const int64_t tiles = nbr / kR;
  cudaStream_t st = (cudaStream_t)stream;
  if (m == 8) return f32_m<8>(p, tiles, mode, st);
  if (m == 32) return f32_m<32>(p, tiles, mode, st);
  if (m == 64) return f32_m<64>(p, tiles, mode, st);
  if (m == 128) return f32_m<128>(p, tiles, mode, st);
  return (int)cudaErrorInvalidValue;
}

// staged 0: v5_batched_def, 1: v2_panel_def
extern "C" int spmm_probe_bf16(const void* v, const void* cols,
                               const void* x, void* y, int64_t nbr,
                               int64_t S, int64_t m, int64_t staged,
                               void* stream) {
  const Params p = params(v, cols, x, y, S);
  const int64_t tiles = nbr / kR;
  cudaStream_t st = (cudaStream_t)stream;
  if (m == 8) return bf16_m<8>(p, tiles, staged, st);
  if (m == 32) return bf16_m<32>(p, tiles, staged, st);
  if (m == 64) return bf16_m<64>(p, tiles, staged, st);
  if (m == 128) return bf16_m<128>(p, tiles, staged, st);
  return (int)cudaErrorInvalidValue;
}

// onedot 0: v3_stream, 1: v3b_onedot; staged: the fixed panel in shared
// memory (else read from global memory)
extern "C" int spmm_stream_bf16(const void* v, const void* x, void* y,
                                int64_t nbr, int64_t S, int64_t m,
                                int64_t onedot, int64_t staged,
                                void* stream) {
  const Params p = params(v, nullptr, x, y, S);
  const int64_t tiles = nbr / kR;
  cudaStream_t st = (cudaStream_t)stream;
  if (m == 8) return stream_m<8>(p, tiles, onedot, staged, st);
  if (m == 32) return stream_m<32>(p, tiles, onedot, staged, st);
  if (m == 64) return stream_m<64>(p, tiles, onedot, staged, st);
  if (m == 128) return stream_m<128>(p, tiles, onedot, staged, st);
  return (int)cudaErrorInvalidValue;
}
