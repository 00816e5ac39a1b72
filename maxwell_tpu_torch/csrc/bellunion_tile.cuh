// The per-tile body of the BELLUnion SpMM, shared by csrc/bellunion_spmm.cu
// (the K2/K1/K3 kernels) and csrc/halo.cu (the fused interior SpMM + halo
// copy): the 16 warps of one thread block compute the 16 8-row groups of a
// 128-row output tile, walking the tile's chunks tile_ptr[t] .. tile_end[t]
// in order (tile_end, where given, stops before the zero chunks that pad a
// layout to a common chunk count; else tile_ptr[t+1]). Both kernels run the
// same instructions per row group, so their products agree bit for bit.
//
// What it computes, for chunk k of tile t (b = 8, pack = 2, cl = 1024):
//   Y[128t + r, j] = sum_{k in chunks(t)} sum_{c < cl}
//                    vals[128k + r, c] * X[ucols[k, c / b] * b + c % b, j]
// In "b3" mode vals * x becomes vh*xh + vh*xl + vl*xh with
// xh = bf16_rn(x), xl = bf16_rn(x - f32(xh)); each bf16 product is exact in
// f32 and is accumulated in f32.
//
// It reads the layout's live form (sparse/bellunion.py, LiveBlocks), not its
// full value streams: only the 8-row x 16-lane sub-blocks that hold a
// nonzero (20% of the stored ones at 16^3 and 24^3), compacted one after
// another, and per chunk only the X runs (16 lanes) that some row group
// needs (66-68%). Design:
// - One owner per output row group: warp w of block t owns row group w of
//   tile t and walks the tile's chunks in order, with its sums in registers:
//   no atomics, each output element written once, deterministic. One block
//   of 16 warps per tile: splitting a tile's groups over 2 to 16 blocks (to
//   fill the 132 SMs at 16^3's 85 tiles) was no faster (PERF.md, PR 10),
//   nor were bigger batches, loads issued before the staging wait or a
//   register cap for a third block per SM.
// - Per chunk the block stages the chunk's live X runs, columns [j0, j0 +
//   16), in shared memory as f32, transposed per run (xs[(q ms + j) 16 +
//   lane], q the run's position in the chunk's list), with 4-byte cp.async;
//   the next chunk's runs are in flight while the current one computes
//   (two buffers). Wider X is walked in 16-column slices; any m >= 1 works.
// - A sub-block's values sit in the order of the mma fragments: lane
//   l = 4 g + i of a warp holds row g, lanes 4i .. 4i + 3 (one 16-byte f32
//   or 8-byte bf16 load per stream; a warp reads 512 or 256 contiguous
//   bytes, streamed past the caches). Four sub-blocks' loads are issued
//   together before their products.
// - "b3": the transposed product Y^T (16 x 8) += X^T (16 x 16) V^T (16 x 8)
//   on the tensor cores, mma.sync m16n8k16 bf16 -> f32: the sub-block is
//   the B operand as it was loaded, X^T the A operand, split to bf16 hi and
//   lo as it is read from shared memory (one 16-byte read per X column),
//   three mma per sub-block (xh vh, xl vh, xh vl), each stream of the fused
//   kernel on the same A fragments. The k order inside a k16 step is
//   permuted alike in A and B (lane i holds k = 4i .. 4i + 3 at the PTX
//   positions 2i, 2i + 1, 2i + 8, 2i + 9), which leaves the product as it
//   is. At m <= 8 half of each mma's rows are zero.
// - "highest": the same walk with true f32 FMAs on the CUDA cores (no
//   TF32): each lane keeps its four lanes' partial sums of its row for 16
//   columns; the four lanes of a row are summed by two shuffles at the end.
// - Offsets into the value streams are 64-bit.
// Its definitions sit in an anonymous namespace: each source that includes
// it gets its own internal copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 16;        // 8-row groups of a 128-row tile
constexpr int kRunLanes = 16;      // lanes of a run: one k16 mma step
constexpr int kSlice = 16;         // X columns per pass: the mma's m16
constexpr int kThreads = 32 * kGroups;  // one warp per row group
constexpr int kUnroll = 4;         // sub-blocks whose loads go out together

struct Params {
  const void* va;      // stream a, compacted: f32 values, or bf16 hi
  const void* va_lo;   // stream a: bf16 lo (b3 only)
  const void* vb;      // stream b (fused only)
  const void* vb_lo;
  const int32_t* sb_ptr;    // (NC * 16 + 1) live sub-blocks of each group
  const int32_t* sb_run;    // per sub-block: its run's place in xr_run
  const int32_t* xr_ptr;    // (NC + 1) live runs of each chunk
  const int32_t* xr_run;    // run index within the chunk
  const int32_t* ucols;
  const int32_t* tile_ptr;
  const int32_t* tile_end;  // nullable: tile_ptr[t + 1]
  const float* x;      // (rows >= n_cols_padded, m) row-major
  float* ya;           // (n_tiles * 128, m)
  float* yb;
  int64_t m;
  int64_t cl;
  int64_t b;
  int64_t x_max;       // the most live runs of one chunk
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// all but the newest committed group have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stage chunk k's live X runs, columns [j0, j0 + ms), into xs.
__device__ __forceinline__ void stage_runs(const Params& p, int64_t k,
                                           int64_t j0, int ms, float* xs) {
  const int q0 = p.xr_ptr[k];
  const int nq = p.xr_ptr[k + 1] - q0;
  const int32_t* uc = p.ucols + k * (p.cl / p.b);
  const int lane = threadIdx.x % kRunLanes;
  for (int q = threadIdx.x / kRunLanes; q < nq;
       q += blockDim.x / kRunLanes) {
    const int64_t c = (int64_t)kRunLanes * p.xr_run[q0 + q] + lane;
    const int64_t row = (int64_t)uc[c / p.b] * p.b + c % p.b;
    const float* src = p.x + row * p.m + j0;
    float* dst = xs + (int64_t)q * ms * kRunLanes + lane;
    for (int j = 0; j < ms; ++j) cp_async4(dst + kRunLanes * j, src + j);
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bf16 hi and lo of two X values, each packed as one A register
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& h,
                                       uint32_t& l) {
  h = bf16x2_bits(x0, x1);
  l = bf16x2_bits(x0 - __uint_as_float(h << 16),
                  x1 - __uint_as_float(h & 0xffff0000u));
}

// D (16 x 8, f32) += A (16 x 16, bf16, row) @ B (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 bv) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(bv.x), "r"(bv.y));
}

// The values (and run places) of up to kUnroll consecutive sub-blocks of a
// row group, loaded together: f32 as one float4 per lane and stream, b3 as
// the bf16 hi and lo of four values (uint2) per lane and stream.
template <bool B3>
struct Lanes {
  using T = float4;
};
template <>
struct Lanes<true> {
  using T = uint2;
};

template <bool B3, bool FUSED>
struct Batch {
  typename Lanes<B3>::T a[kUnroll], al[kUnroll], b[kUnroll], bl[kUnroll];
  int q[kUnroll];
};

template <bool B3, bool FUSED>
__device__ __forceinline__ void load_batch(const Params& p, int64_t i0,
                                           int64_t s1, int lane,
                                           Batch<B3, FUSED>& bt) {
  using T = typename Lanes<B3>::T;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = i0 + u;
    if (i < s1) {
      const int64_t off = 32 * i + lane;
      bt.q[u] = p.sb_run[i];
      bt.a[u] = __ldcs(static_cast<const T*>(p.va) + off);
      if (B3) bt.al[u] = __ldcs(static_cast<const T*>(p.va_lo) + off);
      if (FUSED) {
        bt.b[u] = __ldcs(static_cast<const T*>(p.vb) + off);
        if (B3) bt.bl[u] = __ldcs(static_cast<const T*>(p.vb_lo) + off);
      }
    }
  }
}

// b3: one batch's products into the D fragments (rows: X columns g, g + 8
// of the slice; columns: the group's rows 2i, 2i + 1).
template <bool FUSED>
__device__ __forceinline__ void products_b3(const Batch<true, FUSED>& bt,
                                            int n, const float* xs, int ms,
                                            int lane, float (&da)[4],
                                            float (&db)[4]) {
  const int g = lane >> 2, i4 = 4 * (lane & 3);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (u < n) {
      const float* xq = xs + (int64_t)bt.q[u] * ms * kRunLanes + i4;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 x0 =
          g < ms ? *reinterpret_cast<const float4*>(xq + kRunLanes * g) : z;
      const float4 x1 =
          g + 8 < ms
              ? *reinterpret_cast<const float4*>(xq + kRunLanes * (g + 8))
              : z;
      uint32_t ahi[4], alo[4];
      split2(x0.x, x0.y, ahi[0], alo[0]);
      split2(x1.x, x1.y, ahi[1], alo[1]);
      split2(x0.z, x0.w, ahi[2], alo[2]);
      split2(x1.z, x1.w, ahi[3], alo[3]);
      mma_bf16(da, ahi, bt.a[u]);
      mma_bf16(da, alo, bt.a[u]);
      mma_bf16(da, ahi, bt.al[u]);
      if (FUSED) {
        mma_bf16(db, ahi, bt.b[u]);
        mma_bf16(db, alo, bt.b[u]);
        mma_bf16(db, ahi, bt.bl[u]);
      }
    }
  }
}

// highest: lane 4 g + i's partial sums of row g over its lanes 4i .. 4i + 3,
// for the slice's columns j < ms.
template <bool FUSED>
__device__ __forceinline__ void products_f32(const Batch<false, FUSED>& bt,
                                             int n, const float* xs, int ms,
                                             int lane, float (&aa)[kSlice],
                                             float (&ab)[kSlice]) {
  const int i4 = 4 * (lane & 3);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (u < n) {
      const float* xq = xs + (int64_t)bt.q[u] * ms * kRunLanes + i4;
      const float4 a = bt.a[u], b = bt.b[u];
#pragma unroll
      for (int j = 0; j < kSlice; ++j) {
        if (j < ms) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xq + kRunLanes * j);
          aa[j] = fmaf(a.x, xv.x, aa[j]);
          aa[j] = fmaf(a.y, xv.y, aa[j]);
          aa[j] = fmaf(a.z, xv.z, aa[j]);
          aa[j] = fmaf(a.w, xv.w, aa[j]);
          if (FUSED) {
            ab[j] = fmaf(b.x, xv.x, ab[j]);
            ab[j] = fmaf(b.y, xv.y, ab[j]);
            ab[j] = fmaf(b.z, xv.z, ab[j]);
            ab[j] = fmaf(b.w, xv.w, ab[j]);
          }
        }
      }
    }
  }
}

// The four lanes of row g sum their partials; lane i writes the columns
// j = i mod 4.
__device__ __forceinline__ void store_f32(float* y, int64_t m, int ms,
                                          int lane, const float (&acc)[kSlice]) {
  const int g = lane >> 2, i = lane & 3;
#pragma unroll
  for (int j = 0; j < kSlice; ++j) {
    if (j < ms) {
      float s = acc[j];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if ((j & 3) == i) y[g * m + j] = s;
    }
  }
}

// D fragment: X column g (+ 8) of the slice, group rows 2i, 2i + 1
__device__ __forceinline__ void store_b3(float* y, int64_t m, int ms,
                                         int lane, const float (&d)[4]) {
  const int g = lane >> 2, r = 2 * (lane & 3);
  if (g < ms) {
    y[r * m + g] = d[0];
    y[(r + 1) * m + g] = d[1];
  }
  if (g + 8 < ms) {
    y[r * m + g + 8] = d[2];
    y[(r + 1) * m + g + 8] = d[3];
  }
}

// Output tile t, one row group per warp of a block of kThreads. Needs
// union_smem() bytes of dynamic shared memory.
template <bool B3, bool FUSED>
__device__ __forceinline__ void union_tile(const Params& p, int64_t t) {
  extern __shared__ __align__(16) float xs_all[];
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x >> 5;
  const int64_t k0 = p.tile_ptr[t];
  const int64_t k1 = p.tile_end ? p.tile_end[t] : p.tile_ptr[t + 1];
  const int64_t row0 = t * 128 + 8 * group;
  const int64_t buf =
      p.x_max * (p.m < kSlice ? p.m : kSlice) * kRunLanes;  // floats

  for (int64_t j0 = 0; j0 < p.m; j0 += kSlice) {
    const int ms = (int)((p.m - j0) < kSlice ? (p.m - j0) : kSlice);
    float da[4] = {0.f, 0.f, 0.f, 0.f}, db[4] = {0.f, 0.f, 0.f, 0.f};
    float aa[kSlice], ab[kSlice];
#pragma unroll
    for (int j = 0; j < kSlice; ++j) aa[j] = ab[j] = 0.f;

    if (k0 < k1) stage_runs(p, k0, j0, ms, xs_all);
    cp_async_commit();
    for (int64_t k = k0; k < k1; ++k) {
      if (k + 1 < k1)
        stage_runs(p, k + 1, j0, ms, xs_all + ((k + 1 - k0) & 1) * buf);
      cp_async_commit();
      cp_async_wait_prev();
      __syncthreads();  // chunk k's runs have landed for every thread
      const float* xs = xs_all + ((k - k0) & 1) * buf;
      const int64_t s0 = p.sb_ptr[k * kGroups + group];
      const int64_t s1 = p.sb_ptr[k * kGroups + group + 1];
      for (int64_t i0 = s0; i0 < s1; i0 += kUnroll) {
        Batch<B3, FUSED> bt;
        load_batch(p, i0, s1, lane, bt);
        const int n = (int)(s1 - i0 < kUnroll ? s1 - i0 : kUnroll);
        if constexpr (B3)
          products_b3<FUSED>(bt, n, xs, ms, lane, da, db);
        else
          products_f32<FUSED>(bt, n, xs, ms, lane, aa, ab);
      }
      __syncthreads();  // every warp is done with xs before it is refilled
    }

    float* ya = p.ya + row0 * p.m + j0;
    float* yb = FUSED ? p.yb + row0 * p.m + j0 : nullptr;
    if (B3) {
      store_b3(ya, p.m, ms, lane, da);
      if (FUSED) store_b3(yb, p.m, ms, lane, db);
    } else {
      store_f32(ya, p.m, ms, lane, aa);
      if (FUSED) store_f32(yb, p.m, ms, lane, ab);
    }
  }
}

// Dynamic shared memory of one block: two staging buffers of x_max runs by
// min(m, 16) columns; raises the kernel's limit where it passes the default
// 48 KB (up to the card's 227 KB: x_max * min(m, 16) <= 1816).
inline cudaError_t union_smem(const void* kernel, const Params& p,
                              size_t* smem) {
  const int64_t ms = p.m < kSlice ? p.m : kSlice;
  *smem = (size_t)(2 * p.x_max * ms * kRunLanes) * sizeof(float);
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return cudaSuccess;
}

// The layout tables, in the order every entry point takes them.
struct Tables {
  const void* sb_ptr;
  const void* sb_run;
  const void* xr_ptr;
  const void* xr_run;
  const void* ucols;
  const void* tile_ptr;
  const void* tile_end;
};

inline Params make_params(const void* va, const void* va_lo, const void* vb,
                          const void* vb_lo, const Tables& tb, const void* x,
                          void* ya, void* yb, int64_t m, int64_t cl,
                          int64_t b, int64_t x_max) {
  Params p;
  p.va = va; p.va_lo = va_lo; p.vb = vb; p.vb_lo = vb_lo;
  p.sb_ptr = static_cast<const int32_t*>(tb.sb_ptr);
  p.sb_run = static_cast<const int32_t*>(tb.sb_run);
  p.xr_ptr = static_cast<const int32_t*>(tb.xr_ptr);
  p.xr_run = static_cast<const int32_t*>(tb.xr_run);
  p.ucols = static_cast<const int32_t*>(tb.ucols);
  p.tile_ptr = static_cast<const int32_t*>(tb.tile_ptr);
  p.tile_end = static_cast<const int32_t*>(tb.tile_end);
  p.x = static_cast<const float*>(x);
  p.ya = static_cast<float*>(ya);
  p.yb = static_cast<float*>(yb);
  p.m = m; p.cl = cl; p.b = b; p.x_max = x_max;
  return p;
}

}  // namespace
