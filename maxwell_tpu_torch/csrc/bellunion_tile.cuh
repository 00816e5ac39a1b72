// The per-tile body of the BELLUnion SpMM, shared by csrc/bellunion_spmm.cu
// (the K2/K1/K3 kernels) and csrc/halo.cu (the fused interior SpMM + halo
// copy): one thread block computes half of a 128-row output tile, walking the
// tile's chunks tile_ptr[t] .. tile_end[t] in order (tile_end, where given,
// stops before the zero chunks that pad a layout to a common chunk count;
// else tile_ptr[t+1]). Both kernels run the same instructions per tile, so
// their products agree bit for bit.
//
// What it computes, for chunk k of tile t (b = 8, pack = 2, cl = 1024):
//   Y[128t + r, j] = sum_{k in chunks(t)} sum_{g < cl/(pack*b)} sum_{q < pack*b}
//                    vals[128k + r, g*pack*b + q] * X[ucols[k, g*pack]*b + q, j]
// In "b3" mode vals * x becomes vh*xh + vh*xl + vl*xh with
// xh = bf16_rn(x), xl = bf16_rn(x - f32(xh)); each bf16 product is exact in
// f32 and is accumulated in f32.
//
// Design (simple and right first):
// - The TPU grid walks chunks in order and keeps an output tile resident
//   while it accumulates. Here one thread block owns half of a 128-row tile
//   and walks that tile's chunks in order: no atomics, each output element
//   is written once, and results are deterministic.
// - Each chunk's gathered X block (cl rows x a slice of up to MS columns) is
//   staged in shared memory, column-major, so that lanes reading consecutive
//   lanes c of a value row hit consecutive banks. Wider X is walked in
//   column slices inside the block; any m >= 1 works.
// - Sixteen warps own 4 rows each; lanes stride along the value row with
//   16-byte (f32) or 8-byte (bf16 pairs) loads, so value reads are coalesced.
//   Each lane accumulates RP rows x MS columns in registers; a warp shuffle
//   sum finishes each (row, column) per chunk, and lane j keeps column j's
//   running sum for its warp's rows across chunks. The shape (16 warps x 4
//   rows, a 12-column slice for m = 9..12) was measured on the H100 against
//   4x16, 8x8, 8x4, 32x2 and 16x8: at m = 9 the fused b3 apply ran 0.42 ms,
//   against 1.19, 0.64, 0.51, 1.15 and 0.66 ms (PERF.md).
// - Offsets into the value stream are 64-bit.
// Its definitions sit in an anonymous namespace: each source that includes
// it gets its own internal copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;                  // warps per block
constexpr int kRowsPerWarp = 4;             // rows of a tile each warp owns
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kBlocksPerTile = 128 / kRowsPerBlock;
constexpr int kThreads = kWarps * 32;

struct Params {
  const void* va;      // stream a: f32 values, or bf16 hi
  const void* va_lo;   // stream a: bf16 lo (b3 only)
  const void* vb;      // stream b (fused only)
  const void* vb_lo;
  const int32_t* ucols;
  const int32_t* tile_ptr;
  const int32_t* tile_end;  // nullable: tile_ptr[t + 1]
  const float* x;      // (rows >= n_cols_padded, m) row-major
  float* ya;           // (n_tiles * 128, m)
  float* yb;
  int64_t m;
  int64_t cl;
  int64_t b;
  int64_t pack;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// four consecutive bf16 values (little-endian pairs) widened to f32, exactly
__device__ __forceinline__ void load4(const uint16_t* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ uint16_t bf16_bits(__nv_bfloat16 h) {
  return *reinterpret_cast<uint16_t*>(&h);
}

// Accumulate one row-pass of RP rows x MS columns over a value stream.
template <int MS, int RP, bool B3>
__device__ __forceinline__ void row_pass(
    const void* v_hi, const void* v_lo, size_t row_base, int64_t cl,
    int lane, int ms, const float* xs, const uint16_t* xs_h,
    const uint16_t* xs_l, float (&acc)[RP][MS]) {
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int j = 0; j < MS; ++j) acc[r][j] = 0.f;

#pragma unroll 2
  for (int64_t c = 4 * lane; c < cl; c += 128) {
    float vh[RP][4];
    float vl[RP][4];
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const size_t off = row_base + (size_t)r * cl + c;
      if (B3) {
        load4(static_cast<const uint16_t*>(v_hi) + off, vh[r]);
        load4(static_cast<const uint16_t*>(v_lo) + off, vl[r]);
      } else {
        load4(static_cast<const float*>(v_hi) + off, vh[r]);
      }
    }
#pragma unroll
    for (int j = 0; j < MS; ++j) {
      if (j < ms) {
        if (B3) {
          float xh[4], xl[4];
          load4(xs_h + (size_t)j * cl + c, xh);
          load4(xs_l + (size_t)j * cl + c, xl);
#pragma unroll
          for (int r = 0; r < RP; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[r][j] = fmaf(vh[r][i], xh[i], acc[r][j]);
              acc[r][j] = fmaf(vh[r][i], xl[i], acc[r][j]);
              acc[r][j] = fmaf(vl[r][i], xh[i], acc[r][j]);
            }
        } else {
          float xv[4];
          load4(xs + (size_t)j * cl + c, xv);
#pragma unroll
          for (int r = 0; r < RP; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[r][j] = fmaf(vh[r][i], xv[i], acc[r][j]);
        }
      }
    }
  }
}

// Warp-reduce acc and add (row, column j) into lane j's running sums.
template <int MS, int RP>
__device__ __forceinline__ void reduce_into(
    const float (&acc)[RP][MS], int lane, int ms, int pass,
    float (&out)[kRowsPerWarp]) {
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int j = 0; j < MS; ++j) {
      if (j < ms) {
        const float s = warp_sum(acc[r][j]);
        if (lane == j) out[pass * RP + r] += s;
      }
    }
}

// Rows [64 * half, 64 * half + 64) of output tile t. Needs MS * cl * 4 bytes
// of dynamic shared memory and kThreads threads.
template <int MS, bool B3, bool FUSED>
__device__ __forceinline__ void union_tile(const Params& p, int64_t t,
                                           int half) {
  // rows per register pass: fewer where the accumulators are many (two
  // streams, or slices wider than 8), so that registers allow 16+ warps/SM
  constexpr int RP = (FUSED || MS > 8) ? 2 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  uint16_t* xs_h = reinterpret_cast<uint16_t*>(smem);
  uint16_t* xs_l = xs_h + MS * p.cl;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = half * kRowsPerBlock + warp * kRowsPerWarp;
  const int64_t k0 = p.tile_ptr[t];
  const int64_t k1 = p.tile_end ? p.tile_end[t] : p.tile_ptr[t + 1];
  const int64_t cl = p.cl;
  const int64_t CG = cl / p.b;
  const int64_t run = p.pack * p.b;  // X rows per aligned run

  for (int64_t j0 = 0; j0 < p.m; j0 += MS) {
    const int ms = (int)((p.m - j0) < MS ? (p.m - j0) : MS);
    float out_a[kRowsPerWarp];
    float out_b[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) out_a[i] = out_b[i] = 0.f;

    for (int64_t k = k0; k < k1; ++k) {
      __syncthreads();  // the previous chunk's reads of smem are done
      const int32_t* uc = p.ucols + k * CG;
      for (int64_t idx = threadIdx.x; idx < (int64_t)ms * cl;
           idx += kThreads) {
        const int64_t j = idx / cl;
        const int64_t c = idx - j * cl;
        const int64_t g = c / run;
        const int64_t src = (int64_t)uc[g * p.pack] * p.b + (c - g * run);
        const float xv = p.x[src * p.m + j0 + j];
        if (B3) {
          const __nv_bfloat16 h = __float2bfloat16_rn(xv);
          const __nv_bfloat16 l = __float2bfloat16_rn(xv - __bfloat162float(h));
          xs_h[j * cl + c] = bf16_bits(h);
          xs_l[j * cl + c] = bf16_bits(l);
        } else {
          xs[j * cl + c] = xv;
        }
      }
      __syncthreads();

      const size_t chunk_row = (size_t)k * 128 + r0;
#pragma unroll
      for (int pass = 0; pass < kRowsPerWarp / RP; ++pass) {
        const size_t row_base = (chunk_row + (size_t)pass * RP) * cl;
        float acc[RP][MS];
        row_pass<MS, RP, B3>(p.va, p.va_lo, row_base, cl, lane, ms, xs,
                             xs_h, xs_l, acc);
        reduce_into<MS, RP>(acc, lane, ms, pass, out_a);
        if (FUSED) {
          row_pass<MS, RP, B3>(p.vb, p.vb_lo, row_base, cl, lane, ms, xs,
                               xs_h, xs_l, acc);
          reduce_into<MS, RP>(acc, lane, ms, pass, out_b);
        }
      }
    }

    if (lane < ms) {
      const int64_t row = t * 128 + r0;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        p.ya[(row + i) * p.m + j0 + lane] = out_a[i];
        if (FUSED) p.yb[(row + i) * p.m + j0 + lane] = out_b[i];
      }
    }
  }
}

// Dynamic shared memory of one block at column-slice width MS; raises the
// kernel's limit where it passes the default 48 KB.
template <int MS>
inline cudaError_t union_smem(const void* kernel, int64_t cl, size_t* smem) {
  *smem = (size_t)MS * cl * 4;  // f32, or bf16 hi + lo
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return cudaSuccess;
}

inline Params make_params(const void* va, const void* va_lo, const void* vb,
                          const void* vb_lo, const void* ucols,
                          const void* tile_ptr, const void* tile_end,
                          const void* x, void* ya, void* yb, int64_t m,
                          int64_t cl, int64_t b, int64_t pack) {
  Params p;
  p.va = va; p.va_lo = va_lo; p.vb = vb; p.vb_lo = vb_lo;
  p.ucols = static_cast<const int32_t*>(ucols);
  p.tile_ptr = static_cast<const int32_t*>(tile_ptr);
  p.tile_end = static_cast<const int32_t*>(tile_end);
  p.x = static_cast<const float*>(x);
  p.ya = static_cast<float*>(ya);
  p.yb = static_cast<float*>(yb);
  p.m = m; p.cl = cl; p.b = b; p.pack = pack;
  return p;
}

}  // namespace
