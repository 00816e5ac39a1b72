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
// {8, 32, 64, 128}. A tile is R = 16 block rows, 128 output rows; one warp
// per block row in the gathering variants (the _hi ones in blocks of 8
// warps, half a tile; the _def ones in blocks of 16), so that neighbours on
// the ladder below differ in one thing only.
//
//   bsr_hi<UNSTAGED>    v5_batched_hi (:260-291, pallas_call :277,
//                       HIGHEST): Y = A X, warp w owns block row w of the
//                       tile; per slot, the (8, m) X slice is read from
//                       global memory (L1/L2) into registers as it is used,
//                       products on 3xTF32 mma.sync m16n8k8 (see below).
//   bsr_hi<PANEL>       v1_panel_hi (:111-142, :127, HIGHEST): as v5_hi,
//                       but each row's gathered X slices are first staged
//                       in shared memory (v1's VMEM scratch, :116), through
//                       a per-warp cp.async ring: a whole (S b, m) panel
//                       per warp (16 KB to 256 KB) does not fit.
//   bsr_hi<SMEM_COLS>   v6_smem_hi (:226-258, :244): as v5_hi, but the
//                       tile's (R, S) cols are staged in shared memory once,
//                       before the loop (the TPU's SMEM block).
//   bsr_bf16<false>     v5_batched_def (:277, DEFAULT): as v5_hi, but the
//                       f32 values and X slices are rounded to bf16 (nearest
//                       even) in registers and multiplied by mma.sync
//                       m16n8k16 into f32. The product is taken transposed,
//                       Y^T = Xg^T V^T: the block row's 8 rows are the
//                       instruction's n8, X's columns its m16 (at m 8 half
//                       the m16 rows are zero); a k16 step is two slots.
//   bsr_bf16<true>      v2_panel_def (:127, DEFAULT): as v5_def, with each
//                       warp's X panel staged in 2-slot chunks (one k16
//                       step each) by plain loads between two __syncwarp.
//   stream_kernel       v3_stream (:144-171, :159): as v2_def without the
//                       gather: every block row's values @ the fixed panel
//                       X[0:S b], one transposed product per 8-row block
//                       (mma.sync), each X^T fragment read once per k step
//                       for a warp's 2 block rows. (The TPU failed to lower
//                       it: scatter.)
//   onedot_kernel       v3b_onedot (:173-196, :184): the same function as
//                       one (64, S b) @ (S b, m) product per 64 rows on
//                       wgmma, the values the register A operand, the panel
//                       the shared-memory B. The one change from v3: the
//                       product's shape.
//                       Both are persistent (one block per SM), take the
//                       values through a TMA ring and stage the panel once
//                       per block in bf16 (see below); the other variants
//                       keep one block of 16 warps per tile.
//
// Bounds (at the card's published rates, the probe's inputs once): 78.1 MB
// of values dominate at m 8 (~0.024 ms by bytes); at m 128 the 5.0 GFLOP
// of the product take ~0.075 ms at the f32 peak (bf16: 0.005 ms, so the
// _def variants and v3/v3b stay bound by bytes). What the design does
// about it: the values are streamed once, with 16-byte loads marked
// evict-first (__ldcs) in the gathering variants, by TMA into a ring of
// stages in v3/v3b; X slices (32 m bytes, contiguous) are read with 16-byte
// loads in the _hi variants (each lane's columns contiguous), as aligned
// scalars in the _def fragments. The _hi products run on the tensor cores
// at f32 grade (3xTF32), so what is left is the X gather. Every
// output is written once by one thread: no atomics, runs repeat bit for
// bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tf32x3.cuh"  // split_tf32, mma_tf32

namespace {

constexpr int kR = 16;              // block rows per tile
constexpr int kB = 8;               // rows and columns of a block
constexpr int kWarps = kR;          // one warp per block row
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 2;           // slots per staged chunk (v2)
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
        __ldg(reinterpret_cast<const float4*>(p.x + (c * kB + kk % kB) * M) +
              f);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// v5_batched_hi, v1_panel_hi, v6_smem_hi: 3xTF32 mma.sync, one warp per
// block row
// ---------------------------------------------------------------------------
//
// The product is taken transposed, Y^T = Xg^T V^T, as K8's
// (csrc/bsr_spmm.cu): per slot one mma.sync m16n8k8 group per 16 columns,
// the block row's 8 rows the n8, the slot's 8 X rows the k8 (PTX k = t <->
// X row 2t, k = t + 4 <-> 2t + 1, permuted alike in A and B), three passes
// (lo_x hi_v, hi_x lo_v, hi_x hi_v; helpers in tf32x3.cuh). Lane (g, t)
// loads V[g][2t .. 2t + 1] of each slot as one 8-byte load and splits it
// once for every m-tile. The m16 rows are a permutation of X's columns:
// m-tile mt = 2 i + h's rows g and g + 8 are columns 32 i + 4 g + 2 h and
// + 1, so lane (g, t) holds, of its two X rows 8 c + 2t and 8 c + 2t + 1,
// the m / 32 float4s at columns 32 i + 4 g (at m 128 eight per slot in
// place of 32 4-byte values), and stores its outputs as float4s, the 8
// lanes g of a row on 128 contiguous bytes. At m 8 lane g holds column g
// and the rows g + 8 are zero, as in K8. The three modes differ in one
// thing each:
//   v5 (UNSTAGED)   X fragments from global memory (L1/L2) into registers
//                   as they are used; the row's columns 32 slots at a time
//                   by one coalesced warp load, broadcast by __shfl_sync;
//                   the next step's (U slots) values and X loads go out
//                   before the current step's mma; from m 32 each quarter
//                   warp loads one X row's 128 contiguous bytes, and the
//                   fragment values are exchanged by __shfl_sync
//   v6 (SMEM_COLS)  as v5, the block's (16, S) columns staged in shared
//                   memory once, before the loop, each slot's read there
//   v1 (PANEL)      as v5, but each warp stages its row's X slices in
//                   shared memory through a ring of NST stages of SL slots
//                   (Hi<m>), with 16-byte cp.async (L1-allocating, as v5's
//                   loads), NST - 1 stages ahead of the product;
//                   fragments are read from shared memory in the same
//                   column map. A slot's 8 rows sit even rows first (row 2t
//                   at place t, 2t + 1 at 4 + t) and each row's 16-byte
//                   chunks are XOR-swizzled by 2t, so that the 8 lanes of a
//                   quarter warp read 8 distinct bank groups (m 8: the 32
//                   lanes 32 distinct banks). Stages: m 8 four of 4 slots,
//                   m 32 and 64 three of 2, m 128 three of 1 (2-slot stages
//                   at m 128 would leave one block per SM): 32 / 48 / 96 /
//                   96 KB a block of 8 warps.
// The three share one geometry, blocks of 8 warps (kHiWarps), one warp per
// block row. v5 and v6 differ in where a slot's column is read; v5 and v1
// in whether X passes through shared memory (v1 also takes the columns on
// the copy side, NST - 1 stages ahead, and at m 32 asks the compiler for 3
// blocks per SM where v5 keeps its 4-slot step in registers). Every mode
// computes all S slots (the reference's v5/v1/v6 do), writes each output
// once from one thread, and repeats bit for bit.

// A _hi block is half a tile: 8 warps, one per block row (two blocks of 16
// warps' registers would not fit an SM from m 32 on, and the smaller block
// lets up to 3 (m 32, 64) or 2 (m 128) share one)
constexpr int kHiWarps = 8;

template <int M>
struct Hi {
  static_assert(M == 8 || M == 32 || M == 64 || M == 128,
                "the f32 ladder is built for m 8, 32, 64, 128");
  static constexpr int MT = M >= 16 ? M / 16 : 1;  // m16 tiles
  static constexpr int W = M >= 16 ? M / 8 : 1;    // columns a lane holds
  static constexpr int LC = M >= 16 ? 4 : 1;       // lane g's first: LC g
  static constexpr int U = M <= 32 ? 4 : 1;        // v5/v6 step (slots)
  static constexpr int NST = M == 8 ? 4 : 3;       // v1 ring stages
  static constexpr int SL = M == 8 ? 4 : M == 128 ? 1 : 2;  // slots a stage
  static constexpr int kStageFloats = SL * kB * M;
  // v1's dynamic shared memory: every warp's ring
  static constexpr size_t kPanelBytes =
      (size_t)kHiWarps * NST * kStageFloats * sizeof(float);
  // blocks per SM asked of the compiler (registers), by mode: v5/v6 at m 32
  // keep their 4-slot step in registers, one 8-warp block at a time
  static constexpr int min_blocks(int mode) {
    return M == 8 ? 4 : M == 128 ? 2 : (M == 32 && mode != kPanel) ? 1 : 3;
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D += A B, 3xTF32: A's four values (X columns of rows g and g + 8 at k
// t and t + 4) split here, B's (the lane's two values) split by the caller
__device__ __forceinline__ void mma_x3(float (&d)[4], float a0, float a1,
                                       float a2, float a3, uint32_t bh0,
                                       uint32_t bh1, uint32_t bl0,
                                       uint32_t bl1) {
  uint32_t ah[4], al[4];
  split_tf32(a0, ah[0], al[0]);
  split_tf32(a1, ah[1], al[1]);
  split_tf32(a2, ah[2], al[2]);
  split_tf32(a3, ah[3], al[3]);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// one slot: D += X rows (2t, 2t + 1) x the lane's values; x[h][4 i + c] is
// column 32 i + 4 g + c, m-tile 2 i + c / 2, row g + 8 (c % 2)
template <int M>
__device__ __forceinline__ void hi_slot(float (&d)[Hi<M>::MT][4], float2 v,
                                        const float (&x)[2][Hi<M>::W]) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(v.x, bh0, bl0);
  split_tf32(v.y, bh1, bl1);
  if constexpr (M == 8) {  // m-tile rows g + 8: no such columns
    mma_x3(d[0], x[0][0], 0.f, x[1][0], 0.f, bh0, bh1, bl0, bl1);
  } else {
#pragma unroll
    for (int mt = 0; mt < Hi<M>::MT; ++mt)
      mma_x3(d[mt], x[0][2 * mt], x[0][2 * mt + 1], x[1][2 * mt],
             x[1][2 * mt + 1], bh0, bh1, bl0, bl1);
  }
}

// v5 / v6: the row's S slots in steps of U; the next step's values and X
// float4s go into registers before the current step's mma. From m 32 the
// X float4s are loaded by lane 8 t' + g' (rows 2t' and 2t' + 1, columns
// 32 i + 4 g'), so that the 8 lanes of a quarter warp read one row's 128
// contiguous bytes: X rows are multiples of 128 bytes, and lane (g, t)'s
// own four rows at one column would fall in the same banks (4-way). Lane
// (g, t) takes its fragment values from lane 8 t + g by __shfl_sync as the
// step is computed.
template <int M, int MODE>
__device__ __forceinline__ void hi_direct(const Params& p, int64_t r,
                                          const int32_t* scols, int lane,
                                          float (&d)[Hi<M>::MT][4]) {
  using H = Hi<M>;
  constexpr int U = H::U, W = H::W;
  const int g = lane >> 2, t = lane & 3;
  const int S = (int)p.S;
  const int32_t* crow = p.cols + r * p.S;
  const float* vrow = p.v + (r * kB + g) * p.S * kB + 2 * t;
  // the lane's first X element of a slot's slice: m 8 its own (row 2t,
  // column g), from m 32 the loader's (row 2t', column 4 g')
  const float* xl =
      M == 8 ? p.x + (int64_t)2 * t * M + g
             : p.x + (int64_t)2 * (lane >> 3) * M + 4 * (lane & 7);
  const int src = 8 * t + g;  // the loader of lane (g, t)'s values
  int col_cur = 0, col_nxt = 0;  // v5: columns of slots 32 i .. 32 i + 31
  if (MODE == kUnstaged) {
    col_cur = lane < S ? __ldg(crow + lane) : 0;
    col_nxt = 32 + lane < S ? __ldg(crow + 32 + lane) : 0;
  }
  auto load_step = [&](int s, float2 (&vs)[U], float (&xs)[U][2][W]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      vs[u] = __ldcs(reinterpret_cast<const float2*>(vrow + (s + u) * kB));
      const int c = MODE == kSmemCols
                        ? scols[s + u]
                        : __shfl_sync(0xffffffffu, col_cur, (s + u) & 31);
      const float* xr = xl + (int64_t)c * kB * M;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (M == 8) {
          xs[u][h][0] = __ldg(xr + h * M);
        } else {
#pragma unroll
          for (int i = 0; i < W / 4; ++i) {
            const float4 q = __ldg(
                reinterpret_cast<const float4*>(xr + h * M + 32 * i));
            xs[u][h][4 * i] = q.x; xs[u][h][4 * i + 1] = q.y;
            xs[u][h][4 * i + 2] = q.z; xs[u][h][4 * i + 3] = q.w;
          }
        }
      }
    }
  };
  float2 v[U];
  float x[U][2][W];
  load_step(0, v, x);
  for (int s = 0;; s += U) {
    const bool more = s + U < S;
    float2 vn[U];
    float xn[U][2][W];
    if (more) {
      if (MODE == kUnstaged && ((s + U) & 31) == 0) {
        col_cur = col_nxt;
        const int sc = s + U + 32 + lane;
        col_nxt = sc < S ? __ldg(crow + sc) : 0;
      }
      load_step(s + U, vn, xn);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if constexpr (M == 8) {
        hi_slot<M>(d, v[u], x[u]);
      } else {
        float xf[2][W];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < W; ++i)
            xf[h][i] = __shfl_sync(0xffffffffu, x[u][h][i], src);
        hi_slot<M>(d, v[u], xf);
      }
    }
    if (!more) break;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = vn[u];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < W; ++i) x[u][h][i] = xn[u][h][i];
    }
  }
}

// v1: the warp's ring of staged X slices (see above)
template <int M>
__device__ __forceinline__ void hi_panel(const Params& p, int64_t r,
                                         float* ring, int lane,
                                         float (&d)[Hi<M>::MT][4]) {
  using H = Hi<M>;
  constexpr int NST = H::NST, SL = H::SL;
  constexpr int CPR = M / 4;               // 16-byte chunks of a row
  constexpr int CPS = kB * CPR;            // of a slot
  constexpr int PER_LANE = SL * CPS / 32;  // copies per lane and stage
  static_assert(SL * CPS % 32 == 0, "a stage is whole warp copies");
  const int g = lane >> 2, t = lane & 3;
  const int S = (int)p.S;
  const int nstage = S / SL;
  const int32_t* crow = p.cols + r * p.S;
  const float* vrow = p.v + (r * kB + g) * p.S * kB + 2 * t;
  // copy side: columns of slots 32 i .. 32 i + 31 (a stage lies in one)
  int col_cur = lane < S ? __ldg(crow + lane) : 0;
  int col_nxt = 32 + lane < S ? __ldg(crow + 32 + lane) : 0;
  auto stage_copies = [&](int k) {
    if (k > 0 && (k * SL & 31) == 0) {
      col_cur = col_nxt;
      const int sc = k * SL + 32 + lane;
      col_nxt = sc < S ? __ldg(crow + sc) : 0;
    }
    float* buf = ring + (k % NST) * H::kStageFloats;
#pragma unroll
    for (int n = 0; n < PER_LANE; ++n) {
      const int e = lane + 32 * n;
      const int j = e / CPS, row = (e % CPS) / CPR, ch = e % CPR;
      const int c = __shfl_sync(0xffffffffu, col_cur, (k * SL + j) & 31);
      const int pos = (row & 1) * 4 + (row >> 1);
      const int sw = M == 8 ? ch : ch ^ ((pos & 3) << 1);
      cp_async16(buf + (j * kB + pos) * M + 4 * sw,
                 p.x + ((int64_t)c * kB + row) * M + 4 * ch);
    }
  };
#pragma unroll
  for (int k = 0; k < NST - 1; ++k) {
    if (k < nstage) stage_copies(k);
    cp_async_commit();
  }
  float2 v[SL];
#pragma unroll
  for (int j = 0; j < SL; ++j)
    v[j] = __ldcs(reinterpret_cast<const float2*>(vrow + j * kB));
  for (int k = 0; k < nstage; ++k) {
    if (k + NST - 1 < nstage) stage_copies(k + NST - 1);
    cp_async_commit();
    const bool more = k + 1 < nstage;
    float2 vn[SL];
    if (more) {
#pragma unroll
      for (int j = 0; j < SL; ++j)
        vn[j] = __ldcs(reinterpret_cast<const float2*>(
            vrow + ((k + 1) * SL + j) * kB));
    }
    cp_async_wait<NST - 1>();
    __syncwarp();  // every lane's copies of stage k have landed
    const float* buf = ring + (k % NST) * H::kStageFloats;
#pragma unroll
    for (int j = 0; j < SL; ++j) {
      float x[2][H::W];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* rowp = buf + (j * kB + 4 * h + t) * M;  // row 2t + h
        if constexpr (M == 8) {
          x[h][0] = rowp[g];
        } else {
#pragma unroll
          for (int i = 0; i < H::W / 4; ++i) {
            const int ch = (8 * i + g) ^ (t << 1);
            const float4 q = *reinterpret_cast<const float4*>(rowp + 4 * ch);
            x[h][4 * i] = q.x; x[h][4 * i + 1] = q.y;
            x[h][4 * i + 2] = q.z; x[h][4 * i + 3] = q.w;
          }
        }
      }
      hi_slot<M>(d, v[j], x);
    }
    __syncwarp();  // every lane is done with this stage before its refill
    if (!more) break;
#pragma unroll
    for (int j = 0; j < SL; ++j) v[j] = vn[j];
  }
}

template <int M, int MODE>
__global__ void __launch_bounds__(kHiWarps * 32, Hi<M>::min_blocks(MODE))
bsr_hi_kernel(const Params p) {
  using H = Hi<M>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t r = (int64_t)blockIdx.x * kHiWarps + warp;
  int32_t* scols = reinterpret_cast<int32_t*>(smem);
  if (MODE == kSmemCols) {
    const int32_t* tc = p.cols + (int64_t)blockIdx.x * kHiWarps * p.S;
    for (int i = threadIdx.x; i < kHiWarps * p.S; i += kHiWarps * 32)
      scols[i] = __ldg(tc + i);
    __syncthreads();
  }
  float d[H::MT][4];
#pragma unroll
  for (int mt = 0; mt < H::MT; ++mt)
    d[mt][0] = d[mt][1] = d[mt][2] = d[mt][3] = 0.f;
  if (MODE == kPanel)
    hi_panel<M>(p, r,
                reinterpret_cast<float*>(smem) + warp * H::NST *
                                                     H::kStageFloats,
                lane, d);
  else
    hi_direct<M, MODE>(p, r, scols + warp * p.S, lane, d);

  // rows 2t and 2t + 1 of the block row: the float4s at columns 32 i + 4 g
  float* y0 = p.y + (r * kB + 2 * t) * M + g * H::LC;
  if constexpr (M == 8) {
    y0[0] = d[0][0];
    y0[M] = d[0][1];
  } else {
#pragma unroll
    for (int i = 0; i < H::W / 4; ++i) {
      *reinterpret_cast<float4*>(y0 + 32 * i) =
          make_float4(d[2 * i][0], d[2 * i][2], d[2 * i + 1][0],
                      d[2 * i + 1][2]);
      *reinterpret_cast<float4*>(y0 + M + 32 * i) =
          make_float4(d[2 * i][1], d[2 * i][3], d[2 * i + 1][1],
                      d[2 * i + 1][3]);
    }
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

// ---------------------------------------------------------------------------
// v3_stream and v3b_onedot: a persistent, warp-specialised stream
// ---------------------------------------------------------------------------
//
// One block per SM walks its work units in the fixed order blockIdx.x + i
// gridDim.x (no atomics: every output is written once, by one thread).
// The last warp is the producer: its lane 0 copies the values by TMA
// (cp.async.bulk.tensor.2d, 128-byte swizzle, evict-first) into a ring of
// stages in shared memory, each completed on its "full" mbarrier; the
// warps before it are the consumers (v3: 16 warps, v3b: 2 warpgroups). The
// block's units go out in steps (v3: 16 units, v3b: 2), and a stage holds
// chunk kc of each live unit of the step, one box each. In a step with
// fewer live units (the block's last), a stage holds several chunks of
// each, so the ring keeps as many bytes in flight as in a full step. Every
// consumer warp waits for every stage and releases it on its "empty"
// mbarrier (one arrival per consumer warp), after reading its own boxes if
// it has any; so no warp can wait on a stage's next phase before it has
// seen the last one, and the phase parity stays exact. The ring's first
// copies start while the consumers stage the fixed panel X[0 : P] (P = S b)
// once per block, in bf16 (nearest even) and already in the layout its
// product reads.
//
// A box is 32 f32 columns (128 B, the swizzle's span) of a unit's value
// rows: a chunk, two k16 steps. Values are read as float4: the row's k 4 t
// .. 4 t + 3 of the step, the permuted k order of xt_step. In the swizzled
// box, lanes g and g + 1 read the same four 16-byte chunks of either step;
// so lanes with odd g read their second step first, which puts the 8 lanes
// of a phase on 8 chunks, and a select puts the steps back in order.

constexpr int kBoxCols = 32;   // f32 columns of a TMA box: 128 B
constexpr int kV3Warps = 16;   // v3: consumer warps
constexpr int kV3Rows = 2;     // v3: block rows of a unit
constexpr int kV3bRows = 64;   // v3b: rows of a unit (a warpgroup's)

template <bool ONEDOT>
struct Ring {
  static constexpr int kBoxRows = ONEDOT ? kV3bRows : kV3Rows * kB;
  static constexpr int kBox = kBoxRows * kBoxCols * 4;  // v3 2 KB, v3b 8 KB
  static constexpr int kConsumers = ONEDOT ? 8 : kV3Warps;  // warps
  static constexpr int kThreads = (kConsumers + 1) * 32;  // + the producer
  static constexpr int kPerStep = ONEDOT ? 2 : kConsumers;  // units a step
  static constexpr int kStage = kPerStep * kBox;        // 32 KB, 16 KB
  static constexpr int kStages = ONEDOT ? 4 : 3;
};

// shared memory of a launch: 1 KB to align the ring (the 128-byte swizzle
// repeats every 1 KB), the ring, the bf16 panel (P m 2 bytes in either
// layout), the full and empty barriers
template <bool ONEDOT>
size_t stream_smem(int64_t P, int64_t m) {
  using Rg = Ring<ONEDOT>;
  return 1024 + (size_t)Rg::kStages * Rg::kStage + (size_t)P * m * 2 +
         2 * Rg::kStages * 8;
}

struct StreamParams {
  const float* x;  // (rows, m), rows >= P
  float* y;        // (nbr b, m)
  int P;           // S b
  int units;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
      "l"(policy)
      : "memory");
}

// the consumer threads, apart from the producer warp
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 lds4(const unsigned char* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Both steps of a box row for lane (g, t), as bf16x2 pairs: h[kk] = {k 4 t,
// 4 t + 1 | k 4 t + 2, 4 t + 3} of step kk. row: the row's 128 bytes in the
// box, g = its index mod 8.
__device__ __forceinline__ void box_row(const unsigned char* row, int g,
                                        int t, uint32_t (&h)[2][2]) {
  const int odd = g & 1;
  const float4 f = lds4(row + (((4 * odd + t) ^ g) << 4));
  const float4 s = lds4(row + (((4 * (odd ^ 1) + t) ^ g) << 4));
  const uint32_t f0 = pack_bf16(f.x, f.y), f1 = pack_bf16(f.z, f.w);
  const uint32_t s0 = pack_bf16(s.x, s.y), s1 = pack_bf16(s.z, s.w);
  h[0][0] = odd ? s0 : f0;
  h[0][1] = odd ? s1 : f1;
  h[1][0] = odd ? f0 : s0;
  h[1][1] = odd ? f1 : s1;
}

// The ring's walk, shared by the producer and the consumers: in step j the
// block's units j kPerStep + c (c < live) are live; each stage of the step
// holds chunks k0 .. k0 + cps - 1 of each (cps = kPerStep / live), chunk kc
// of unit c in box (kc - k0) live + c. A full step takes nk stages.
template <bool ONEDOT>
struct Walk {
  using Rg = Ring<ONEDOT>;
  int mine;  // the block's units
  int nk;    // chunks of a unit
  __device__ int live(int j) const {
    return min(Rg::kPerStep, mine - j * Rg::kPerStep);
  }
  __device__ int unit(int j, int c) const {
    return blockIdx.x + (j * Rg::kPerStep + c) * gridDim.x;
  }
};

// The producer: lane 0 of the last warp fills the ring stage by stage.
template <bool ONEDOT>
__device__ void produce(const CUtensorMap* map, unsigned char* ring,
                        uint64_t* bars, const Walk<ONEDOT>& w) {
  using Rg = Ring<ONEDOT>;
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  int q = 0;
  for (int j = 0; j * Rg::kPerStep < w.mine; ++j) {
    const int live = w.live(j);
    const int cps = Rg::kPerStep / live;
    for (int k0 = 0; k0 < w.nk; k0 += cps, ++q) {
      const int s = q % Rg::kStages;
      const int k1 = min(w.nk, k0 + cps);
      const uint32_t full = smem_u32(bars + s);
      mbar_wait(smem_u32(bars + Rg::kStages + s),
                ((q / Rg::kStages) & 1) ^ 1);
      mbar_expect_tx(full, (k1 - k0) * live * Rg::kBox);
      for (int kc = k0; kc < k1; ++kc)
        for (int c = 0; c < live; ++c)
          tma_load_2d(
              smem_u32(ring + s * Rg::kStage + ((kc - k0) * live + c) *
                                                   Rg::kBox),
              map, full, kc * kBoxCols, w.unit(j, c) * Rg::kBoxRows,
              policy);
    }
  }
}

// set up the barriers, split the roles; returns true in the consumers
template <bool ONEDOT>
__device__ __forceinline__ bool stream_setup(const CUtensorMap* map,
                                             unsigned char* ring,
                                             uint64_t* bars,
                                             const Walk<ONEDOT>& w) {
  using Rg = Ring<ONEDOT>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Rg::kStages; ++s) {
      mbar_init(smem_u32(bars + s), 1);
      mbar_init(smem_u32(bars + Rg::kStages + s), Rg::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < Rg::kConsumers * 32) return true;
  if (threadIdx.x == Rg::kConsumers * 32)
    produce<ONEDOT>(map, ring, bars, w);
  return false;
}

__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// the warp index, read from lane 0 so that the compiler sees it is the same
// across the warp (wgmma's issue must not look divergent)
__device__ __forceinline__ int warp_uniform() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
}

// Wait for stage q of the walk, hand back its base and empty barrier
template <bool ONEDOT>
__device__ __forceinline__ const unsigned char* take_stage(
    const unsigned char* ring, uint64_t* bars, int q, uint32_t* empty) {
  using Rg = Ring<ONEDOT>;
  const int s = q % Rg::kStages;
  mbar_wait(smem_u32(bars + s), (q / Rg::kStages) & 1);
  *empty = smem_u32(bars + Rg::kStages + s);
  return ring + s * Rg::kStage;
}

// the warp is done reading a stage
__device__ __forceinline__ void release(uint32_t empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// v3: X[0 : P]^T as mma.sync A fragments in xt_step's order: for k16 step
// kb and 16-column tile mt, lane (g, t)'s {a0, a2, a1, a3} (16 B; at m 8,
// where X's columns 8 .. 15 do not exist, {a0, a2}, 8 B) in slot
// (kb MT + mt) 32 + xt_slot(g, t). A thread takes column n of a k16 step
// (16 loads, the warp's 32 columns side by side) and writes one 8-byte
// pair into each of the four lanes (n % 8, t) of tile n / 16: {a0, a2} for
// columns 0 .. 7 of the tile, {a1, a3} for 8 .. 15. The slots are
// permuted so that those writes from 16 columns fall on 16 distinct bank
// pairs. A thread loads kStageBatch / 2 columns before it packs the first,
// so that many L2 reads are in flight.
constexpr int kStageBatch = 8;

__device__ __forceinline__ int xt_slot(int g, int t) {
  return 4 * g + (t ^ ((g >> 1) & 3));
}

template <int M, int NT>
__device__ void stage_xt_fragments(const float* __restrict__ x, int P,
                                   unsigned char* panel) {
  constexpr int MT = M >= 16 ? M / 16 : 1;
  constexpr int U = kStageBatch / 2;
  uint32_t* word = reinterpret_cast<uint32_t*>(panel);
  const int total = P / 16 * M;
  for (int e0 = threadIdx.x; e0 < total; e0 += U * NT) {
    float v[U][16];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      if (e >= total) break;
      const float* xc = x + (int64_t)(16 * (e / M)) * M + e % M;
#pragma unroll
      for (int k = 0; k < 16; ++k) v[u][k] = __ldg(xc + k * M);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      if (e >= total) break;
      const int kb = e / M, n = e % M;
      const int h = (n >> 3) & 1;  // columns 8 .. 15 of a tile: a1, a3
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint2 pair = make_uint2(pack_bf16(v[u][4 * t], v[u][4 * t + 1]),
                                      pack_bf16(v[u][4 * t + 2],
                                                v[u][4 * t + 3]));
        const int slot = (kb * MT + n / 16) * 32 + xt_slot(n & 7, t);
        reinterpret_cast<uint2*>(word)[slot * (M >= 16 ? 2 : 1) + h] = pair;
      }
    }
  }
}

// v3_stream: every block row multiplied by the fixed panel on its own,
// transposed: Y^T (m x 8) = X[0:P]^T V^T, one mma.sync m16n8k16 chain per
// block row and 16-column tile. A step's live units (2 block rows each)
// give 2 live block rows; warp w takes rows w and w + 16 of them (in a
// full step, rows of 2 units; in the block's last, those that exist, so
// that the last step's products do not fall to one warp). Each A fragment
// is read from the panel once per k step and serves the warp's rows; the B
// fragments (the rows' values) come from the ring. 16 warps of 2 rows
// ran faster than 8 of 4 at every m on an H100 (more warps to hide the
// mma and shared-memory latencies).
template <int M>
__global__ void __launch_bounds__(Ring<false>::kThreads, 1)
stream_kernel(const __grid_constant__ CUtensorMap map, const StreamParams p) {
  using Rg = Ring<false>;
  constexpr int MT = M >= 16 ? M / 16 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1k(smem_raw);
  unsigned char* panel = ring + Rg::kStages * Rg::kStage;
  uint64_t* bars = reinterpret_cast<uint64_t*>(panel + (size_t)p.P * M * 2);
  const int G = gridDim.x;
  const Walk<false> w{
      (int)blockIdx.x < p.units ? (p.units - (int)blockIdx.x + G - 1) / G
                                : 0,
      p.P / kBoxCols};
  if (!stream_setup<false>(&map, ring, bars, w)) return;
  if (w.mine > 0) stage_xt_fragments<M, kV3Warps * 32>(p.x, p.P, panel);
  consumers_sync<kV3Warps * 32>();
  const int warp = warp_uniform();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int slot = xt_slot(g, tig);  // the lane's fragment in a panel tile
  int q = 0;
  for (int j = 0; j * kV3Warps < w.mine; ++j) {
    const int live = w.live(j);
    const int cps = kV3Warps / live;
    // the warp's rows of the step: row i is the step's row warp + 16 i,
    // block row (warp + 16 i) % 2 of unit (warp + 16 i) / 2, for i < rows
    const int rows =
        min(kV3Rows, (live * kV3Rows - warp + kV3Warps - 1) / kV3Warps);
    float d[kV3Rows][MT][4];
#pragma unroll
    for (int i = 0; i < kV3Rows; ++i)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        d[i][mt][0] = d[i][mt][1] = d[i][mt][2] = d[i][mt][3] = 0.f;
    for (int k0 = 0; k0 < w.nk; k0 += cps, ++q) {
      uint32_t empty;
      const unsigned char* stage = take_stage<false>(ring, bars, q, &empty);
      if (rows == 0) {
        release(empty);
        continue;
      }
      const int k1 = min(w.nk, k0 + cps);
      for (int kc = k0; kc < k1; ++kc) {
        uint32_t b[kV3Rows][2][2];
#pragma unroll
        for (int i = 0; i < kV3Rows; ++i) {
          const int row = warp + kV3Warps * i;
          if (i < rows)
            box_row(stage + ((kc - k0) * live + row / kV3Rows) * Rg::kBox +
                        (row % kV3Rows * kB + g) * 128,
                    g, tig, b[i]);
        }
        if (kc + 1 == k1) release(empty);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int kb = 2 * kc + kk;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a0, a1 = 0, a2, a3 = 0;
            if constexpr (M >= 16) {
              const uint4 a = reinterpret_cast<const uint4*>(
                  panel)[(kb * MT + mt) * 32 + slot];
              a0 = a.x, a2 = a.y, a1 = a.z, a3 = a.w;
            } else {
              const uint2 a =
                  reinterpret_cast<const uint2*>(panel)[kb * 32 + slot];
              a0 = a.x, a2 = a.y;
            }
#pragma unroll
            for (int i = 0; i < kV3Rows; ++i)
              if (i < rows)
                mma_bf16(d[i][mt], a0, a1, a2, a3, b[i][kk][0], b[i][kk][1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kV3Rows; ++i) {
      const int row = warp + kV3Warps * i;
      if (i < rows)
        xt_store<M>(p.y,
                    (int64_t)w.unit(j, row / kV3Rows) * kV3Rows +
                        row % kV3Rows,
                    d[i], g, tig);
    }
  }
}

// v3b: X[0 : P] in bf16 as wgmma's K-major core matrices, no swizzle: for
// k16 step kb, 8-column group ng and k half h, the 128-byte core matrix
// (kb M / 8 + ng) 2 + h; its row n % 8 holds column n's 8 k of half h in
// the permuted order (h 0: k 0 1 4 5 8 9 12 13; h 1: k 2 3 6 7 10 11 14
// 15). A thread loads kStageBatch / 2 core rows' values before it packs.
template <int M, int NT>
__device__ void stage_b_cores(const float* __restrict__ x, int P,
                              unsigned char* panel) {
  constexpr int U = kStageBatch / 2;
  uint4* core = reinterpret_cast<uint4*>(panel);
  const int total = P / 16 * M;
  for (int e0 = threadIdx.x; e0 < total; e0 += U * NT) {
    float v[U][16];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      if (e >= total) break;
      const float* xc = x + (int64_t)(16 * (e / M)) * M + e % M;
#pragma unroll
      for (int k = 0; k < 16; ++k) v[u][k] = __ldg(xc + k * M);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT;
      if (e >= total) break;
      const int kb = e / M, n = e % M;
      uint4* row = core + ((kb * (M / 8) + n / 8) * 2) * 8 + n % 8;
      row[0] = make_uint4(pack_bf16(v[u][0], v[u][1]),
                          pack_bf16(v[u][4], v[u][5]),
                          pack_bf16(v[u][8], v[u][9]),
                          pack_bf16(v[u][12], v[u][13]));
      row[8] = make_uint4(pack_bf16(v[u][2], v[u][3]),
                          pack_bf16(v[u][6], v[u][7]),
                          pack_bf16(v[u][10], v[u][11]),
                          pack_bf16(v[u][14], v[u][15]));
    }
  }
}

// a shared-memory matrix descriptor: no swizzle, leading (k) and stride
// (n) byte offsets
__device__ __forceinline__ uint64_t core_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32) (+)= A (64 x 16, bf16, registers: mma.sync's m16n8k16 A
// fragment per warp, warp w rows 16 w ..) @ B (16 x N, bf16, K-major in
// shared memory); acc 0 overwrites D
__device__ __forceinline__ void wgmma_rs(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %8, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %9, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(acc), "l"(desc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %21, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(acc), "l"(desc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(acc), "l"(desc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(acc), "l"(desc));
}

// One chunk (a box: two k16 steps) of a warpgroup's unit: the lane's A
// fragments from the box (rows g and g + 8 of the warp's 16), then two
// wgmma into d; the stage is released after its last chunk (`last`). a is
// the register set this chunk writes: the group that read it two chunks
// ago has retired (wait_group 1 after each commit).
template <int M>
__device__ __forceinline__ void onedot_chunk(const unsigned char* row, int g,
                                             int tig, uint32_t (&a)[2][4],
                                             float (&d)[M / 2],
                                             uint32_t b_addr, int first,
                                             uint32_t empty, bool last) {
  uint32_t lo[2][2], hi[2][2];
  box_row(row, g, tig, lo);
  box_row(row + 8 * 128, g, tig, hi);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    a[kk][0] = lo[kk][0];
    a[kk][1] = hi[kk][0];
    a[kk][2] = lo[kk][1];
    a[kk][3] = hi[kk][1];
  }
  keep(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_rs(d, a[kk], core_desc(b_addr + kk * (M / 8) * 256, 128, 256),
             first ? kk : 1);
  wgmma_commit();
  if (last) release(empty);
  keep(d);
  wgmma_wait<1>();
}

// v3b_onedot: warpgroup h (warps 4 h .. 4 h + 3) takes the block's units
// 2 j + h, 64 rows each, and computes each as one (64, P) @ (P, m) product
// over the whole k range with wgmma m64n{m}k16: A the values, rounded to
// bf16 in registers from the ring; B the bf16 panel through its descriptor.
template <int M>
__global__ void __launch_bounds__(Ring<true>::kThreads, 1)
onedot_kernel(const __grid_constant__ CUtensorMap map, const StreamParams p) {
  using Rg = Ring<true>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1k(smem_raw);
  unsigned char* panel = ring + Rg::kStages * Rg::kStage;
  uint64_t* bars = reinterpret_cast<uint64_t*>(panel + (size_t)p.P * M * 2);
  const int G = gridDim.x;
  const Walk<true> w{
      (int)blockIdx.x < p.units ? (p.units - (int)blockIdx.x + G - 1) / G
                                : 0,
      p.P / kBoxCols};
  if (!stream_setup<true>(&map, ring, bars, w)) return;
  if (w.mine > 0) stage_b_cores<M, 256>(p.x, p.P, panel);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync<256>();
  const int warp = warp_uniform();
  const int h = warp >> 2;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int r = 16 * (warp & 3) + g;  // the lane's first row in a unit
  const uint32_t panel_addr = smem_u32(panel);
  const uint32_t b_step = 2 * (M / 8) * 256;  // a chunk's two k16 steps
  float d[M / 2];
  uint32_t a[2][2][4];  // two register sets, alternating by chunk
  int q = 0;
  for (int j = 0; 2 * j < w.mine; ++j) {
    const int live = w.live(j);
    const int cps = 2 / live;
    const bool own = h < live;
    for (int k0 = 0; k0 < w.nk; k0 += cps, ++q) {
      uint32_t empty;
      const unsigned char* stage = take_stage<true>(ring, bars, q, &empty);
      if (!own) {
        release(empty);
        continue;
      }
      const int k1 = min(w.nk, k0 + cps);
      for (int kc = k0; kc < k1; ++kc) {
        const unsigned char* row =
            stage + ((kc - k0) * live + h) * Rg::kBox + r * 128;
        // the register sets alternate by chunk
        if (kc & 1)
          onedot_chunk<M>(row, g, tig, a[1], d, panel_addr + kc * b_step,
                          false, empty, kc + 1 == k1);
        else
          onedot_chunk<M>(row, g, tig, a[0], d, panel_addr + kc * b_step,
                          kc == 0, empty, kc + 1 == k1);
      }
    }
    if (!own) continue;
    wgmma_wait<0>();
    keep(d);
    float* y = p.y + ((int64_t)w.unit(j, h) * kV3bRows + r) * M + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < M / 8; ++nt) {
      *reinterpret_cast<float2*>(y + 8 * nt) =
          make_float2(d[4 * nt], d[4 * nt + 1]);
      *reinterpret_cast<float2*>(y + 8 * M + 8 * nt) =
          make_float2(d[4 * nt + 2], d[4 * nt + 3]);
    }
  }
}

// blocks of `warps` block rows (16 to a tile for the _def kernels)
template <typename Kernel>
int launch(Kernel kernel, const Params& p, int64_t tiles, size_t smem,
           cudaStream_t stream, int warps = kWarps) {
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)(tiles * kR / warps), warps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int M>
int f32_m(const Params& p, int64_t tiles, int64_t mode, cudaStream_t st) {
  if (mode == kUnstaged)
    return launch(bsr_hi_kernel<M, kUnstaged>, p, tiles, 0, st, kHiWarps);
  if (mode == kPanel)
    return launch(bsr_hi_kernel<M, kPanel>, p, tiles, Hi<M>::kPanelBytes, st,
                  kHiWarps);
  if (mode == kSmemCols)
    return launch(bsr_hi_kernel<M, kSmemCols>, p, tiles,
                  (size_t)kHiWarps * p.S * 4, st, kHiWarps);
  return (int)cudaErrorInvalidValue;
}

template <int M>
int bf16_m(const Params& p, int64_t tiles, int64_t staged, cudaStream_t st) {
  constexpr size_t chunk = (size_t)kWarps * kChunk * kB * (M + 4) * 4;
  return staged ? launch(bsr_bf16_kernel<M, true>, p, tiles, chunk, st)
                : launch(bsr_bf16_kernel<M, false>, p, tiles, 0, st);
}

template <int M, bool ONEDOT>
int stream_launch(const CUtensorMap& map, const StreamParams& p,
                  cudaStream_t st) {
  const size_t smem = stream_smem<ONEDOT>(p.P, M);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  void (*kernel)(const CUtensorMap, const StreamParams) =
      ONEDOT ? onedot_kernel<M> : stream_kernel<M>;
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)sms, Ring<ONEDOT>::kThreads, smem, st>>>(map, p);
  return (int)cudaGetLastError();
}

template <bool ONEDOT>
int stream_m(const CUtensorMap& map, const StreamParams& p, int64_t m,
             cudaStream_t st) {
  if (m == 8) return stream_launch<8, ONEDOT>(map, p, st);
  if (m == 32) return stream_launch<32, ONEDOT>(map, p, st);
  if (m == 64) return stream_launch<64, ONEDOT>(map, p, st);
  if (m == 128) return stream_launch<128, ONEDOT>(map, p, st);
  return (int)cudaErrorInvalidValue;
}

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point query: the library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
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

// The tensor map of the value panel V (nbr b, S b) f32 for v3_stream
// (onedot 0: boxes of 32 rows) or v3b_onedot (1: 64 rows), 32 columns wide,
// 128-byte swizzle, into out (a CUtensorMap, 128 bytes of host memory).
// Returns 0, -1 if the driver has no cuTensorMapEncodeTiled, else its
// CUresult.
extern "C" int spmm_stream_tensor_map(const void* v, int64_t nbr, int64_t S,
                                      int64_t onedot, void* out) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  alignas(64) CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)(S * kB), (cuuint64_t)(nbr * kB)};
  const cuuint64_t strides[1] = {(cuuint64_t)(S * kB * 4)};
  const cuuint32_t box[2] = {
      kBoxCols, (cuuint32_t)(onedot ? Ring<true>::kBoxRows
                                    : Ring<false>::kBoxRows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(v), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)r;
  memcpy(out, &map, sizeof map);
  return 0;
}

// onedot 0: v3_stream, 1: v3b_onedot, on the tensor map that
// spmm_stream_tensor_map wrote for V and this onedot; one block per SM
extern "C" int spmm_stream_bf16(const void* map, const void* x, void* y,
                                int64_t nbr, int64_t S, int64_t m,
                                int64_t onedot, void* stream) {
  alignas(64) CUtensorMap tm;
  memcpy(&tm, map, sizeof tm);
  const StreamParams p{
      static_cast<const float*>(x), static_cast<float*>(y), (int)(S * kB),
      (int)(onedot ? nbr * kB / kV3bRows : nbr / kV3Rows)};
  cudaStream_t st = (cudaStream_t)stream;
  return onedot ? stream_m<true>(tm, p, m, st) : stream_m<false>(tm, p, m, st);
}
