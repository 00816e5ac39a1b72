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
// per block row in the gathering variants (v2_def: two, a half of its
// steps each), so that neighbours on the ladder below differ in one thing
// only.
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
//   def_direct          v5_batched_def (:277, DEFAULT): as v5_hi, but the
//                       f32 values and X slices are rounded to bf16 (nearest
//                       even) in registers and multiplied by mma.sync
//                       m16n8k16 into f32. The product is taken transposed,
//                       Y^T = Xg^T V^T: the block row's 8 rows are the
//                       instruction's n8, X's columns its m16 (at m 8 half
//                       the m16 rows are zero); a k16 step is two slots. X
//                       by 16-byte loads in the _hi column map, the step
//                       loop unrolled (see below).
//   union_def           v2_panel_def (:127, DEFAULT): as v5_def, but X
//                       passes through shared memory: a block per unit of 8
//                       block rows stages the sorted union of the unit's
//                       block columns once, in bf16, built in the kernel
//                       from cols (bitmap, prefix popcount), in passes of
//                       32 columns (see below).
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
//                       per block in bf16 (see below).
//
// Bounds (at the card's published rates, the probe's inputs once): 78.1 MB
// of values dominate at m 8 (~0.024 ms by bytes); at m 128 the 5.0 GFLOP
// of the product take ~0.075 ms at the f32 peak (bf16: 0.005 ms, so the
// _def variants and v3/v3b stay bound by bytes). What the design does
// about it: the values are streamed once, with 16-byte loads marked
// evict-first (__ldcs) in the gathering variants, by TMA into a ring of
// stages in v3/v3b; X slices (32 m bytes, contiguous) are read with 16-byte
// loads (each lane's columns contiguous); v2_def reads each of a unit's
// distinct slices once (the union of its 8 rows' columns: 84 of 512 slots
// on average at 24^3), so its X traffic from L2 falls 6x where every other
// gathering variant moves a slice per slot (1.25 GB at m 128). The _hi
// products run on the tensor cores at f32 grade (3xTF32), so what is left
// is the X gather. Every output is written once by one thread: no atomics
// on an output (v2_def's bitmap takes atomicOr in shared memory, whose
// result does not depend on the order), runs repeat bit for bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tf32x3.cuh"  // split_tf32, mma_tf32

namespace {

constexpr int kR = 16;              // block rows per tile
constexpr int kB = 8;               // rows and columns of a block
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100

enum { kUnstaged = 0, kPanel = 1, kSmemCols = 2 };

struct Params {
  const float* v;       // blocks2d (nbr b, S b)
  const int32_t* cols;  // (nbr, S)
  const float* x;       // (rows, m)
  float* y;             // (nbr b, m)
  int64_t S;
  int64_t nbr;
};

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

// ---------------------------------------------------------------------------
// v5_batched_def, v2_panel_def: bf16 mma.sync m16n8k16, one warp per block
// row, blocks of 8 warps
// ---------------------------------------------------------------------------
//
// Fragments: thread (g = lane / 4, tig = lane % 4) holds k = 4 tig .. 4 tig
// + 3 of a k16 step in the PTX positions 2 tig, 2 tig + 1, 2 tig + 8, 2 tig
// + 9, in A and B alike (one permutation of k leaves the product as it
// is), so that a value row's four k load as one float4. A k16 step is two
// slots: lane tig's k are rows 4 (tig % 2) .. 4 (tig % 2) + 3 of slot
// 2 ks + tig / 2. The product is taken transposed, Y^T (m x 8) += Xg^T V^T:
// a D tile's rows are X columns, its columns the block row's rows 2 tig,
// 2 tig + 1.
//
// Column map of the _def rungs: m-tiles 2 i and 2 i + 1 take X columns
// 32 i + 4 g .. 32 i + 4 g + 3: tile 2 i + h's row g is column 32 i + 4 g +
// 2 h and its row g + 8 the column after (bsr_hi_kernel's map). One float4
// of an X row at column 32 i + 4 g gives lane (g, tig) both tiles' A
// fragments, with no shuffle (a0, a2 from .x of rows q, q + 1 and q + 2,
// q + 3; a1, a3 from .y; tile 2 i + 1 from .z, .w), and Y is stored as
// float4s in the same map, the 8 lanes g of a row on 128 contiguous bytes.
// (v3's stream keeps the plain map, xt_store: tile mt's row g is column
// 16 mt + g, its row g + 8 column 16 mt + g + 8.)

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  mma_bf16(d, a.x, a.y, a.z, a.w, b0, b1);
}

// The A fragments of m-tiles 2 i (lo) and 2 i + 1 (hi) from the lane's
// four X rows' float4s at column 32 i + 4 g
__device__ __forceinline__ void pack_tiles(const float4 (&f)[4], uint4& lo,
                                           uint4& hi) {
  lo = make_uint4(pack_bf16(f[0].x, f[1].x), pack_bf16(f[0].y, f[1].y),
                  pack_bf16(f[2].x, f[3].x), pack_bf16(f[2].y, f[3].y));
  hi = make_uint4(pack_bf16(f[0].z, f[1].z), pack_bf16(f[0].w, f[1].w),
                  pack_bf16(f[2].z, f[3].z), pack_bf16(f[2].w, f[3].w));
}

// Y rows 2 tig and 2 tig + 1 at columns c .. c + 3 from tiles 2 i (lo) and
// 2 i + 1 (hi) of the map; y0 is row 2 tig's column c, ld the row stride
__device__ __forceinline__ void store_tiles(float* y0, int64_t ld,
                                            const float (&lo)[4],
                                            const float (&hi)[4]) {
  *reinterpret_cast<float4*>(y0) = make_float4(lo[0], lo[2], hi[0], hi[2]);
  *reinterpret_cast<float4*>(y0 + ld) =
      make_float4(lo[1], lo[3], hi[1], hi[3]);
}

// Y rows r b + 2 tig, r b + 2 tig + 1 of v3's D tiles, in the plain map
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

// v5_batched_def: X from global memory (L1/L2) into registers as it is
// used. Lane (g, tig) loads its four k rows of a step as one float4 each
// per 32 columns (m 128: 16 LDG.128 a step, each covering four whole
// 128-byte rows, where the scalar fragments took 64 4-byte loads of four
// lines each); at m 8 one scalar per row, column g (the m16 rows 8 .. 15
// are zero). The row's columns are read 32 slots at a time by one
// coalesced warp load and broadcast by __shfl_sync (hi_direct's way), so no
// step waits on its own column load. The step loop is unrolled Def<m>::UNR
// times and nothing else is staged by hand: the compiler then issues the
// next steps' value and X loads before the current step's mma.sync. (Rings
// of registers written out by hand, values 2-4 steps and X 1-2 steps
// ahead, measured slower at every m on an H100: they cost the registers
// that set how many rows' loads are in flight.) One warp per
// block row; the block size and the registers a thread may take are set
// per m for the most resident warps: 48 an SM at m 8 (blocks of 16), 40 at
// m 32, 24 at m 64, 16 at m 128 (blocks of 8); csrc's spmm_def_shape
// reports registers and blocks. It computes all S slots, as the
// reference's v5 does.
template <int M>
struct Def {
  static_assert(M == 8 || M == 32 || M == 64 || M == 128,
                "the bf16 rungs are built for m 8, 32, 64, 128");
  static constexpr int MT = M >= 16 ? M / 16 : 1;  // m16 tiles
  static constexpr int NQ = M >= 32 ? M / 32 : 1;  // float4s of a row
  static constexpr int UNR = M == 8 || M == 128 ? 4 : 2;  // steps unrolled
  static constexpr int kWarps = M == 8 ? 16 : 8;   // a block's block rows
  static constexpr int kMinBlocks = M == 8 ? 3 : M == 32 ? 5 : M == 64 ? 3
                                                                        : 2;
};

template <int M>
__global__ void __launch_bounds__(Def<M>::kWarps * 32, Def<M>::kMinBlocks)
def_direct_kernel(const Params p) {
  using D = Def<M>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t r = (int64_t)blockIdx.x * D::kWarps + warp;
  const int S = (int)p.S;
  const int nstep = S / 2;
  const int32_t* crow = p.cols + r * p.S;
  const float* vrow = p.v + (r * kB + g) * p.S * kB + 4 * t;
  // the lane's first X element of a slot's slice: row 4 (t % 2), column g
  // (m 8) or 4 g
  const float* xl = p.x + (int64_t)4 * (t & 1) * M + (M == 8 ? g : 4 * g);
  const int half = t >> 1;  // the lane's slot of a step: 2 ks + half
  int col_cur = lane < S ? __ldg(crow + lane) : 0;  // slots 32 j .. + 31
  int col_nxt = 32 + lane < S ? __ldg(crow + 32 + lane) : 0;
  float d[D::MT][4];
#pragma unroll
  for (int mt = 0; mt < D::MT; ++mt)
    d[mt][0] = d[mt][1] = d[mt][2] = d[mt][3] = 0.f;
#pragma unroll (Def<M>::UNR)
  for (int ks = 0; ks < nstep; ++ks) {
    if (ks > 0 && (ks & 15) == 0) {  // slots 2 ks .. 2 ks + 31
      col_cur = col_nxt;
      const int sc = 2 * ks + 32 + lane;
      col_nxt = sc < S ? __ldg(crow + sc) : 0;
    }
    const int c = __shfl_sync(0xffffffffu, col_cur, (2 * ks + half) & 31);
    const float4 v = __ldcs(reinterpret_cast<const float4*>(vrow + ks * 16));
    const float* xr = xl + (int64_t)c * kB * M;
    const uint32_t b0 = pack_bf16(v.x, v.y), b1 = pack_bf16(v.z, v.w);
    if constexpr (M == 8) {
      float xs[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) xs[q] = __ldg(xr + q * M);
      mma_bf16(d[0], make_uint4(pack_bf16(xs[0], xs[1]), 0u,
                                pack_bf16(xs[2], xs[3]), 0u), b0, b1);
    } else {
#pragma unroll
      for (int i = 0; i < D::NQ; ++i) {  // a column pair of tiles
        float4 f[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          f[q] = __ldg(reinterpret_cast<const float4*>(xr + q * M + 32 * i));
        uint4 lo, hi;
        pack_tiles(f, lo, hi);
        mma_bf16(d[2 * i], lo, b0, b1);
        mma_bf16(d[2 * i + 1], hi, b0, b1);
      }
    }
  }
  float* y0 = p.y + (r * kB + 2 * t) * M;
  if constexpr (M == 8) {
    y0[g] = d[0][0];
    y0[M + g] = d[0][1];
  } else {
#pragma unroll
    for (int i = 0; i < D::NQ; ++i)
      store_tiles(y0 + 32 * i + 4 * g, M, d[2 * i], d[2 * i + 1]);
  }
}

// v2_panel_def: X passes through shared memory, staged once per unit. A
// block takes a unit of kUnit = 8 block rows and stages the sorted union
// of the unit's block columns, each X slice once, rounded to bf16 once
// (the same bits as rounding at each use):
// - the union is built in the block from the probe's own cols: a bitmap
//   over X's block columns (atomicOr: the bits set, in any order, are the
//   same), a prefix popcount over its words (warp 0), which gives each
//   column its place in sorted order, the union's columns (ucol) and each
//   of the unit's 8 S slots' place, in shared memory (v6 keeps its columns
//   there too);
// - the host sizes shared memory for the largest union of the cols it is
//   given (kernels/spmm_probes.py union_plan), and a unit whose union
//   exceeds that capacity writes nothing past it: it records its size in
//   *status and returns, and the wrapper raises;
// - columns go in passes of W = 32 (m 8: one pass of 8), run back to back
//   in the block. The first pass reads the values (f32, __ldcs) and, where
//   more passes follow (MULTI: a build of its own, so that the one-pass
//   builds carry none of it), writes each lane's packed bf16 B registers
//   of each step to a scratch stream (8 bytes a lane, a warp's 256
//   contiguous bytes a step: half the f32 bytes, no conversions), which
//   the later passes read back (__ldcg, L2; the same thread wrote them).
//   The first VA steps' values go out before the union is built, and
//   before each later pass's staging. A pass stages the union's slices at
//   its columns: entry u's 8 rows x W columns
//   as W 16-byte chunks, chunk 2 cp + h of column pair cp (columns 2 cp,
//   2 cp + 1) holding rows 4 h .. 4 h + 3 as the four A registers of a
//   lane (k rows 4 h, 4 h + 1 of column 2 cp; of 2 cp + 1; rows 4 h + 2,
//   4 h + 3 of each), copied with 16-byte loads. At W 32 lane (g, tig)
//   reads column pairs 2 g and 2 g + 1 (the two tiles of the map) with one
//   LDS.128 each; lanes of the step's second slot read them in the other
//   order, so that the 8 lanes of a phase fall on 8 distinct chunks of a
//   128-byte line (entries are 512 bytes). At W 8 lane g reads pair g % 4,
//   and lanes g >= 4 repeat lanes g - 4.
// - A row's S / 2 steps are split between two warps (16 warps a block, a
//   warp per row and half): each walks its half with the values by
//   float4, VA steps ahead, the slots' places from shared memory, the
//   A fragments from the panel, the same m16n8k16 transposed product as
//   v5_def; the second half's warp leaves its sums in shared memory and
//   the first adds them to its own (first half + second half, in that
//   order) and stores. A row's chain of dependent steps is half as long,
//   and a pass's staging has 512 threads. Two blocks an SM while the panel
//   of the largest union fits twice (24^3: 162 entries, 93 KB at W 32);
//   one block's staging overlaps the other's products.
constexpr int kUnit = 8;        // block rows of a v2_def unit
constexpr int kUnitWarps = 16;  // v2_def: two warps (step halves) a row
// v2_def: value steps in flight, by build (the multi-pass build keeps
// fewer, which its 64 registers a thread hold without spilling)
template <bool MULTI>
constexpr int kVAhead = MULTI ? 3 : 4;
constexpr int kStageItems = 1;  // v2_def: staging items a thread in flight

struct UnionParams {
  const float* v;       // blocks2d (nbr b, S b)
  const int32_t* cols;  // (nbr, S)
  const float* x;       // (rows, m)
  float* y;             // (nbr b, m)
  int* status;          // the largest union that did not fit, else 0
  uint2* bs;            // (nbr, S / 2, 32) B registers for later passes
  int S, m, cap, nwords;
};

// shared memory of a v2_def block: the panel (cap entries of 16 W bytes),
// the second halves' sums (8 rows x 32 lanes x 8), the bitmap and its
// prefix (nwords each), the places of the unit's 8 S slots, the union's
// columns (cap), its size
size_t union_smem(int W, int64_t cap, int64_t nwords, int64_t S) {
  return (size_t)cap * 16 * W + (size_t)kUnit * 32 * 8 * 4 +
         8 * (size_t)nwords + 4 * (size_t)kUnit * S + 4 * (size_t)cap + 16;
}

// The union's slices at columns j0 .. j0 + W - 1 into the panel: item (u,
// quad qd, h) takes rows 4 h .. 4 h + 3 of entry u at columns 4 qd .. 4 qd
// + 3 (four 16-byte loads; the 16 items of an entry's half rows cover 128
// contiguous bytes of a row) into the chunks of pairs 2 qd and 2 qd + 1
template <int W>
__device__ __forceinline__ void stage_union(const float* __restrict__ x,
                                            int m, int j0,
                                            const int* ucol, int nu,
                                            uint4* panel) {
  constexpr int PER = W / 2;  // items of an entry
  constexpr int NT = kUnitWarps * 32;
  const int total = nu * PER;
  for (int e0 = threadIdx.x; e0 < total; e0 += kStageItems * NT) {
    float4 f[kStageItems][4];
#pragma unroll
    for (int b = 0; b < kStageItems; ++b) {
      const int e = e0 + b * NT;
      if (e < total) {
        const int u = e / PER, qd = (e % PER) >> 1, h = e & 1;
        const float* src =
            x + ((int64_t)ucol[u] * kB + 4 * h) * m + j0 + 4 * qd;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          f[b][q] = __ldg(reinterpret_cast<const float4*>(src + q * m));
      }
    }
#pragma unroll
    for (int b = 0; b < kStageItems; ++b) {
      const int e = e0 + b * NT;
      if (e < total) {
        const int u = e / PER, qd = (e % PER) >> 1, h = e & 1;
        uint4 lo, hi;
        pack_tiles(f[b], lo, hi);
        panel[u * W + 4 * qd + h] = lo;      // pair 2 qd
        panel[u * W + 4 * qd + 2 + h] = hi;  // pair 2 qd + 1
      }
    }
  }
}

template <int W, bool MULTI>
__global__ void __launch_bounds__(kUnitWarps * 32, 2)
union_def_kernel(const UnionParams p) {
  static_assert(W == 8 || W == 32, "v2_def passes are 8 or 32 columns");
  constexpr int NT = kUnitWarps * 32;
  constexpr int MT = W / 16 > 0 ? W / 16 : 1;
  constexpr int VA = kVAhead<MULTI>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* panel = reinterpret_cast<uint4*>(smem);
  // the second halves' sums: [row][lane][tile]
  float4* part = reinterpret_cast<float4*>(smem + (size_t)p.cap * 16 * W);
  uint32_t* bitmap = reinterpret_cast<uint32_t*>(part + kUnit * 32 * 2);
  int* prefix = reinterpret_cast<int*>(bitmap + p.nwords);
  int* places = prefix + p.nwords;
  int* ucol = places + kUnit * p.S;
  int* count = ucol + p.cap;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row = warp & (kUnit - 1), kh = warp / kUnit;  // row, step half
  const int g = lane >> 2, t = lane & 3, h = t & 1, half = t >> 1;
  const int nslot = kUnit * p.S;
  const int nh = p.S / 4;  // steps of a half (S is a multiple of 4)
  const int k1 = kh * nh;  // the warp's first step
  const int32_t* ucols = p.cols + (int64_t)blockIdx.x * nslot;
  const int64_t r = (int64_t)blockIdx.x * kUnit + row;
  const float* vrow = p.v + (r * kB + g) * (int64_t)p.S * kB + 4 * t;
  // the row's B registers of step ks, for the passes after the first
  // MULTI: passes follow the first (m > W), which read the B words the
  // first leaves in the scratch stream
  uint2* brow = MULTI ? p.bs + r * (p.S / 2) * 32 + lane : nullptr;
  // the first steps' values, in flight from here (f32, read once)
  float4 vf[VA];
#pragma unroll
  for (int u = 0; u < VA; ++u)
    vf[u] = u < nh ? __ldcs(reinterpret_cast<const float4*>(
                         vrow + (k1 + u) * 16))
                   : make_float4(0.f, 0.f, 0.f, 0.f);

  // the union: bitmap, prefix popcount, columns, places
  for (int w = tid; w < p.nwords; w += NT) bitmap[w] = 0u;
  __syncthreads();
  for (int i = tid; i < nslot; i += NT) {
    const int c = __ldg(ucols + i);
    atomicOr(bitmap + (c >> 5), 1u << (c & 31));
  }
  __syncthreads();
  if (warp == 0) {
    const int per = (p.nwords + 31) / 32;
    const int w0 = min(lane * per, p.nwords), w1 = min(w0 + per, p.nwords);
    int sum = 0;
    for (int w = w0; w < w1; ++w) sum += __popc(bitmap[w]);
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += n;
    }
    int run = incl - sum;
    for (int w = w0; w < w1; ++w) {
      prefix[w] = run;
      run += __popc(bitmap[w]);
    }
    if (lane == 31) *count = incl;
  }
  __syncthreads();
  const int nu = *count;
  if (nu > p.cap) {  // more entries than the host sized the panel for
    if (tid == 0) atomicMax(p.status, nu);
    return;
  }
  for (int w = tid; w < p.nwords; w += NT) {
    uint32_t bits = bitmap[w];
    int e = prefix[w];
    while (bits) {
      ucol[e++] = 32 * w + __ffs(bits) - 1;
      bits &= bits - 1u;
    }
  }
  for (int i = tid; i < nslot; i += NT) {
    const int c = __ldg(ucols + i);
    places[i] = prefix[c >> 5] +
                __popc(bitmap[c >> 5] & ((1u << (c & 31)) - 1u));
  }
  __syncthreads();

  // the passes
  const int* pl = places + row * p.S + half;
  float4* mine = part + (row * 32 + lane) * 2;
  for (int j0 = 0; j0 < p.m; j0 += W) {
    uint2 vb[VA];       // a later pass: its first steps' B words
    if (MULTI && j0 > 0) {  // in flight while it stages
#pragma unroll
      for (int u = 0; u < VA; ++u)
        vb[u] = u < nh ? __ldcg(brow + (k1 + u) * 32) : make_uint2(0u, 0u);
    }
    stage_union<W>(p.x, p.m, j0, ucol, nu, panel);
    __syncthreads();
    float d[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      d[mt][0] = d[mt][1] = d[mt][2] = d[mt][3] = 0.f;
    // step ks on the B words b0, b1: the slots' entries, two (W 8: one)
    // mma.sync
    auto step = [&](int ks, uint32_t b0, uint32_t b1) {
      const uint4* ent = panel + pl[2 * ks] * W;
      if constexpr (W == 32) {
        const uint4 q0 = ent[2 * (2 * g + half) + h];
        const uint4 q1 = ent[2 * (2 * g + (half ^ 1)) + h];
        mma_bf16(d[0], half ? q1 : q0, b0, b1);
        mma_bf16(d[1], half ? q0 : q1, b0, b1);
      } else {
        mma_bf16(d[0], ent[2 * (g & 3) + h], b0, b1);
      }
    };
    if (j0 == 0) {  // the values, packed, and kept for the later passes
      for (int k0 = 0; k0 < nh; k0 += VA) {
#pragma unroll
        for (int u = 0; u < VA; ++u) {
          const int ks = k0 + u;
          if (ks >= nh) break;
          const float4 v = vf[u];
          if (ks + VA < nh)
            vf[u] = __ldcs(reinterpret_cast<const float4*>(
                vrow + (k1 + ks + VA) * 16));
          const uint32_t b0 = pack_bf16(v.x, v.y), b1 = pack_bf16(v.z, v.w);
          if constexpr (MULTI) brow[(k1 + ks) * 32] = make_uint2(b0, b1);
          step(k1 + ks, b0, b1);
        }
      }
    } else if constexpr (MULTI) {  // the B words of the first pass
      for (int k0 = 0; k0 < nh; k0 += VA) {
#pragma unroll
        for (int u = 0; u < VA; ++u) {
          const int ks = k0 + u;
          if (ks >= nh) break;
          const uint2 b = vb[u];
          if (ks + VA < nh)
            vb[u] = __ldcg(brow + (k1 + ks + VA) * 32);
          step(k1 + ks, b.x, b.y);
        }
      }
    }
    if (kh == 1) {  // the second half's sums, for the first half's warp
      mine[0] = make_float4(d[0][0], d[0][1], d[0][2], d[0][3]);
      if constexpr (W == 32)
        mine[1] = make_float4(d[1][0], d[1][1], d[1][2], d[1][3]);
    }
    __syncthreads();
    if (kh == 0) {
      const float4 s0 = mine[0];
      d[0][0] += s0.x; d[0][1] += s0.y; d[0][2] += s0.z; d[0][3] += s0.w;
      if constexpr (W == 32) {
        const float4 s1 = mine[1];
        d[1][0] += s1.x; d[1][1] += s1.y; d[1][2] += s1.z; d[1][3] += s1.w;
      }
      float* y0 = p.y + (r * kB + 2 * t) * (int64_t)p.m + j0;
      if constexpr (W == 32) {
        store_tiles(y0 + 4 * g, p.m, d[0], d[1]);
      } else if (g < 4) {
        *reinterpret_cast<float2*>(y0 + 2 * g) =
            make_float2(d[0][0], d[0][2]);
        *reinterpret_cast<float2*>(y0 + p.m + 2 * g) =
            make_float2(d[0][1], d[0][3]);
      }
    }
    __syncthreads();  // the panel and the sums are refilled by the next pass
  }
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
// .. 4 t + 3 of the step, the _def fragments' permuted k order. In the
// swizzled box, lanes g and g + 1 read the same four 16-byte chunks of
// either step; so lanes with odd g read their second step first, which
// puts the 8 lanes of a phase on 8 chunks, and a select puts the steps
// back in order.

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

// v3: X[0 : P]^T as mma.sync A fragments in the _def fragment order (in
// the plain column map, xt_store's): for k16 step kb and 16-column tile
// mt, lane (g, t)'s {a0, a2, a1, a3} (16 B; at m 8,
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

// blocks of kHiWarps block rows (half a tile)
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
  kernel<<<(unsigned)(tiles * kR / kHiWarps), kHiWarps * 32, smem,
           stream>>>(p);
  return (int)cudaGetLastError();
}

template <int M>
int f32_m(const Params& p, int64_t tiles, int64_t mode, cudaStream_t st) {
  if (mode == kUnstaged)
    return launch(bsr_hi_kernel<M, kUnstaged>, p, tiles, 0, st);
  if (mode == kPanel)
    return launch(bsr_hi_kernel<M, kPanel>, p, tiles, Hi<M>::kPanelBytes, st);
  if (mode == kSmemCols)
    return launch(bsr_hi_kernel<M, kSmemCols>, p, tiles,
                  (size_t)kHiWarps * p.S * 4, st);
  return (int)cudaErrorInvalidValue;
}

// v5_def: blocks of Def<M>::kWarps block rows
template <int M>
int def_m(const Params& p, cudaStream_t st) {
  if (p.nbr % Def<M>::kWarps) return (int)cudaErrorInvalidValue;
  def_direct_kernel<M><<<(unsigned)(p.nbr / Def<M>::kWarps),
                         Def<M>::kWarps * 32, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// v2_def's kernel for pass width W (8 or 32), one pass or several
// (multi), with smem bytes of shared memory allowed; nullptr for another W
using UnionKernel = void (*)(const UnionParams);

UnionKernel union_kernel(int64_t W, bool multi, size_t smem,
                         cudaError_t* e) {
  UnionKernel k = nullptr;
  if (W == 8 && !multi) k = union_def_kernel<8, false>;
  if (W == 8 && multi) k = union_def_kernel<8, true>;
  if (W == 32 && !multi) k = union_def_kernel<32, false>;
  if (W == 32 && multi) k = union_def_kernel<32, true>;
  *e = k == nullptr || smem > (size_t)kSmemLimit ? cudaErrorInvalidValue
                                                  : cudaSuccess;
  if (*e == cudaSuccess && smem > 48 * 1024)
    *e = cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
  return k;
}

// registers, local memory and resident blocks per SM of a kernel launched
// with `threads` threads and smem bytes of dynamic shared memory
template <typename Kernel>
int kernel_shape(Kernel k, int threads, size_t smem, int64_t* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(k));
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = threads / 32;
  out[1] = a.numRegs;
  out[2] = (int64_t)a.localSizeBytes;
  out[3] = per_sm;
  return 0;
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
              int64_t S, int64_t nbr) {
  return Params{static_cast<const float*>(v),
                static_cast<const int32_t*>(cols),
                static_cast<const float*>(x), static_cast<float*>(y), S, nbr};
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
  const Params p = params(v, cols, x, y, S, nbr);
  const int64_t tiles = nbr / kR;
  cudaStream_t st = (cudaStream_t)stream;
  if (m == 8) return f32_m<8>(p, tiles, mode, st);
  if (m == 32) return f32_m<32>(p, tiles, mode, st);
  if (m == 64) return f32_m<64>(p, tiles, mode, st);
  if (m == 128) return f32_m<128>(p, tiles, mode, st);
  return (int)cudaErrorInvalidValue;
}

// v5_batched_def
extern "C" int spmm_probe_bf16(const void* v, const void* cols,
                               const void* x, void* y, int64_t nbr,
                               int64_t S, int64_t m, void* stream) {
  const Params p = params(v, cols, x, y, S, nbr);
  cudaStream_t st = (cudaStream_t)stream;
  if (m == 8) return def_m<8>(p, st);
  if (m == 32) return def_m<32>(p, st);
  if (m == 64) return def_m<64>(p, st);
  if (m == 128) return def_m<128>(p, st);
  return (int)cudaErrorInvalidValue;
}

// v2_panel_def: one block of kUnitWarps warps per 8-block-row unit, passes
// of W (8 or 32, dividing m) columns, a panel of cap union entries (the
// largest union of these cols); x_rows: X's rows (the bitmap covers x_rows
// / 8 block columns); status: a device int a unit with a larger union
// raises to its size (the wrapper reads it); bs: scratch of nbr S / 2 x 32
// uint2 where m > W (else unused). Needs nbr % 8 == 0 and S % 4 == 0.
extern "C" int spmm_union_bf16(const void* v, const void* cols,
                               const void* x, void* y, void* status,
                               void* bs, int64_t nbr, int64_t S, int64_t m,
                               int64_t x_rows, int64_t cap, int64_t W,
                               void* stream) {
  const int64_t nwords = (x_rows / kB + 31) / 32;
  if (W <= 0 || m % W || nbr % kUnit || S % 4 || cap < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = union_smem((int)W, cap, nwords, S);
  cudaError_t e;
  const UnionKernel k = union_kernel(W, m > W, smem, &e);
  if (e != cudaSuccess) return (int)e;
  const UnionParams p{static_cast<const float*>(v),
                      static_cast<const int32_t*>(cols),
                      static_cast<const float*>(x), static_cast<float*>(y),
                      static_cast<int*>(status), static_cast<uint2*>(bs),
                      (int)S, (int)m, (int)cap, (int)nwords};
  k<<<(unsigned)(nbr / kUnit), kUnitWarps * 32, smem,
      (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The launch of a _def rung on this card into out (int64[4]): warps a
// block, registers a thread, local memory bytes a thread, resident blocks
// per SM. kind 0: v5_batched_def at width m (smem unused); kind 1 (2):
// v2_panel_def in one pass (several) of m columns (8 or 32) with smem
// bytes of shared memory.
extern "C" int spmm_def_shape(int64_t kind, int64_t m, int64_t smem,
                              void* out) {
  int64_t* o = static_cast<int64_t*>(out);
  if (kind == 0) {
    if (m == 8)
      return kernel_shape(def_direct_kernel<8>, Def<8>::kWarps * 32, 0, o);
    if (m == 32)
      return kernel_shape(def_direct_kernel<32>, Def<32>::kWarps * 32, 0, o);
    if (m == 64)
      return kernel_shape(def_direct_kernel<64>, Def<64>::kWarps * 32, 0, o);
    if (m == 128)
      return kernel_shape(def_direct_kernel<128>, Def<128>::kWarps * 32, 0,
                          o);
    return (int)cudaErrorInvalidValue;
  }
  if (kind != 1 && kind != 2) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  const UnionKernel k = union_kernel(m, kind == 2, (size_t)smem, &e);
  if (e != cudaSuccess) return (int)e;
  return kernel_shape(k, kUnitWarps * 32, (size_t)smem, o);
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
