// X-gather probes for NVIDIA Hopper (sm_90a): the H100 counterparts of the
// TPU kernels inside main() of maxwell_tpu/bench/exp_gather.py (K15e), and
// the gather-only variant v4_gather of maxwell_tpu/bench/exp_spmm.py
// (K15c). No solver calls them; the probe scripts
// maxwell_tpu_torch/bench/exp_gather.py and exp_spmm.py do.
//
// The probe's data (exp_gather.py:59-69): T tiles of R = 16 block rows of
// b = 8 rows, S slots per block row (cols (16 T, S) int32 block columns),
// X (n, m) f32 with n = 128 T, m = 8; P = S b = 512 panel rows.
//
//   gather_sum<8, M>     g0_slices (:93-113, pallas_call :103) and, at
//                        m in {8, 32, 64, 128} on the 24^3 K's cols,
//                        v4_gather (exp_spmm.py:198-224, :212): per tile,
//                        the sum of its R S slices X[8 c : 8 c + 8] (256 B
//                        at m 8, each contiguous), tiled R times down the
//                        tile's 128 rows.
//   gather_sum<16, 8>    g1_slices2x (:115-135, :125): the same over the
//                        first S / 2 slots with 16-row slices X[8 c :
//                        8 c + 16] (512 B) of X padded by 8 zero rows,
//                        tiled 8 times. The one change from g0: the slice
//                        size.
//   gather_sum_t         g4_lane_ds (:218-239, :228): g1's slices taken
//                        from X^T (m, n + 8): a slice is m rows of 16
//                        floats (64 B each), (n + 8) * 4 B apart; the (m,
//                        16) sum is tiled S times along the row to (m,
//                        16 S). The one change from g1: the layout.
//   taa0                 g2_taa0 (:137-162, :151): X[0:P] staged in shared
//                        memory once per block; per tile, idx (P, m) read
//                        coalesced, g[p, j] = src[idx[p, j], j] for all
//                        P m elements into shared memory, then the tile's
//                        (8, m) output g[lo : lo + 8] + g[hi : hi + 8]
//                        with lo = 0, hi = P - 8 (the reference's :147).
//                        The 16 output rows are kernel arguments, so no
//                        gather is dead code: all P m are live loads.
//   taa1                 g3_taa1 (:164-187, :176): X^T[:, 0:P] staged in
//                        shared memory; g[j, p] = src[j, idx[j, p]],
//                        written whole, (m, P) per tile.
//   taa1_wide            g3w_taa1_wide (:189-216, :204): g3 with the
//                        tile's own (m, 4096) block of XTW as the source,
//                        the m P elements the reference keeps (:200).
//                        Staging that block (128 KB a tile) left one
//                        block per SM, 2.26 rounds of tiles, a barrier
//                        between staging and gathering, and all 39 MB of
//                        source read for 63% of its 32-byte sectors. So
//                        nothing is staged: one warp per source row (8 T
//                        rows), lane l issues its P / 128 index loads
//                        (int4, coalesced: 512 bytes a warp load) first,
//                        then its 4 P / 128 scalar gathers from the row's
//                        16 KB through L1, then its float4 stores. One
//                        warp a block, every block resident at once
//                        (2,384 warps at T 298, 18 or 19 on each SM).
//   g5_floor (:241-254, :247) is grid_copy_f32 of csrc/grid_probes.cu.
//
// Bounds (bytes over 3.35 TB/s): g0/g1/g4 read cols and X once (1.2 MB
// each) and write 1.2 MB (g4 9.8 MB); their 78.1 MB of gathered slices come
// from L2 (X is 1.2 MB). g2/g3 read 4.9 MB of indices and write 76 KB /
// 4.9 MB; g3w reads 4.9 MB of kept indices, the source's 32-byte sectors
// its gathers touch (24.7 MB at T 298) and writes 4.9 MB. What the design
// does about it:
// slices are read with 16-byte loads, a warp reading whole slices (two at
// a time at 256 B), summed in registers across the tile's slots, one
// shared-memory reduction across the 16 warps at the end; indices are read
// with 16-byte loads, coalesced; sources are staged with 16-byte loads.
// Every output is written once by one thread: no atomics, runs repeat bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 16;              // block rows per tile
constexpr int kB = 8;               // rows per block row
constexpr int kWarps = 16;          // warps per block, as the K15c ladder
constexpr int kThreads = kWarps * 32;
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// A slice is F4 float4s (ROWS rows of M floats; for XT, M rows of 16
// floats). Warp w takes slices w * SPW + sub, stepping by 16 SPW; at F4 <=
// 32, SPW = 32 / F4 slices per warp load, lane l reads float4 l % F4 of
// slice l / F4; above, lane l reads float4s l, l + 32, ... of each slice.
template <int ROWS, int M, bool XT>
__global__ void __launch_bounds__(kThreads)
gather_sum_kernel(const int32_t* __restrict__ cols,
                  const float4* __restrict__ x, float4* __restrict__ y,
                  int64_t S, int slots, int64_t x_stride4) {
  constexpr int F4 = XT ? M * 4 : ROWS * M / 4;
  constexpr int SPW = F4 <= 32 ? 32 / F4 : 1;
  constexpr int PER = F4 <= 32 ? 1 : F4 / 32;
  static_assert(F4 <= 32 ? 32 % F4 == 0 : F4 % 32 == 0, "slice shape");
  extern __shared__ float4 part[];  // [kWarps * SPW][F4]
  const int64_t t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = F4 <= 32 ? lane / F4 : 0;
  const int f0 = F4 <= 32 ? lane % F4 : lane;
  const int32_t* crow = cols + t * kR * S;
  const int n = kR * slots;
  float4 acc[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = warp * SPW + sub; s < n; s += kWarps * SPW) {
    const int r = s / slots;
    const int64_t c = __ldg(crow + r * S + (s - r * slots));
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int f = f0 + 32 * q;
      const float4* src =
          XT ? x + (f >> 2) * x_stride4 + c * 2 + (f & 3)  // row f/4, 8c/4
             : x + c * (kB * M / 4) + f;
      acc[q] = add4(acc[q], __ldg(src));
    }
  }
#pragma unroll
  for (int q = 0; q < PER; ++q)
    part[(warp * SPW + sub) * F4 + f0 + 32 * q] = acc[q];
  __syncthreads();
  // the warps' sums, reduced in a fixed order
  for (int f = threadIdx.x; f < F4; f += kThreads) {
    float4 sum = part[f];
    for (int w = 1; w < kWarps * SPW; ++w) sum = add4(sum, part[w * F4 + f]);
    part[f] = sum;
  }
  __syncthreads();
  if (XT) {
    // (M, 16) tiled S times along each of the tile's M output rows
    const int64_t row4 = 4 * S;  // float4 of an output row (16 S floats)
    for (int64_t e = threadIdx.x; e < M * row4; e += kThreads) {
      const int64_t j = e / row4;
      y[t * M * row4 + e] = part[j * 4 + (e - j * row4) % 4];
    }
  } else {
    // (ROWS, M) tiled down the tile's 128 rows
    constexpr int kTile4 = kR * kB * M / 4;
    for (int e = threadIdx.x; e < kTile4; e += kThreads)
      y[t * kTile4 + e] = part[e % F4];
  }
}

// P rows of M = 8 floats: src staged once, each tile's P x 8 gathers
// written to shared memory, then rows lo .. lo + 7 plus hi .. hi + 7 out
__global__ void __launch_bounds__(kThreads)
taa0_kernel(const int4* __restrict__ idx, const float4* __restrict__ x,
            float* __restrict__ y, int P, int lo, int hi) {
  constexpr int M = 8;
  extern __shared__ float smem[];
  float* src = smem;       // [P][8]
  float* g = smem + P * M;  // [P][8]
  const int64_t t = blockIdx.x;
  for (int i = threadIdx.x; i < P * M / 4; i += kThreads)
    reinterpret_cast<float4*>(src)[i] = __ldg(x + i);
  __syncthreads();
  const int4* it = idx + t * P * M / 4;
  for (int i = threadIdx.x; i < P * M / 4; i += kThreads) {
    const int4 k = __ldg(it + i);
    const int j = (4 * i) % M;  // the column of the first of the four
    reinterpret_cast<float4*>(g)[i] =
        make_float4(src[k.x * M + j], src[k.y * M + j + 1],
                    src[k.z * M + j + 2], src[k.w * M + j + 3]);
  }
  __syncthreads();
  if (threadIdx.x < kB * M)
    y[t * kB * M + threadIdx.x] =
        g[lo * M + threadIdx.x] + g[hi * M + threadIdx.x];
}

// M rows of `width` floats staged (row j of the source at src + t *
// tile_stride + j * row_stride), then g[j, p] = src[j, idx[j, p]] for
// p < P, idx row j at idx + (t M + j) * idx_stride
__global__ void __launch_bounds__(kThreads)
taa1_kernel(const float* __restrict__ x, int64_t row_stride,
            int64_t tile_stride, int width, const int32_t* __restrict__ idx,
            int64_t idx_stride, float* __restrict__ y, int M, int P) {
  extern __shared__ float src[];  // [M][width]
  const int64_t t = blockIdx.x;
  const int w4 = width / 4;
  for (int i = threadIdx.x; i < M * w4; i += kThreads) {
    const int j = i / w4;
    reinterpret_cast<float4*>(src)[i] = __ldg(reinterpret_cast<const float4*>(
        x + t * tile_stride + j * row_stride) + (i - j * w4));
  }
  __syncthreads();
  const int p4 = P / 4;
  for (int i = threadIdx.x; i < M * p4; i += kThreads) {
    const int j = i / p4;
    const int p = 4 * (i - j * p4);
    const int64_t row = t * M + j;
    const int4 k =
        __ldg(reinterpret_cast<const int4*>(idx + row * idx_stride + p));
    const float* s = src + j * width;
    reinterpret_cast<float4*>(y + row * P + p)[0] =
        make_float4(s[k.x], s[k.y], s[k.z], s[k.w]);
  }
}

// One warp per source row (row `row` of x and of idx, `width` floats and
// indices): g[row, p] = x[row, idx[row, p]] for p < P, P a multiple of 4,
// in chunks of 512 columns: a lane's four int4 index loads, then its 16
// gathers, then its four float4 stores
__global__ void __launch_bounds__(32)
taa1_wide_kernel(const float* __restrict__ x,
                 const int32_t* __restrict__ idx, float* __restrict__ y,
                 int width, int P) {
  const int64_t row = blockIdx.x;
  const int lane = threadIdx.x;
  const float* src = x + row * width;
  const int32_t* ir = idx + row * width;
  float* out = y + row * P;
  for (int p0 = 4 * lane; p0 < P; p0 += 512) {
    int4 k[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (p0 + 128 * i < P)  // read once: evict first
        k[i] = __ldcs(reinterpret_cast<const int4*>(ir + p0 + 128 * i));
    float4 g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (p0 + 128 * i < P)
        g[i] = make_float4(__ldg(src + k[i].x), __ldg(src + k[i].y),
                           __ldg(src + k[i].z), __ldg(src + k[i].w));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (p0 + 128 * i < P)
        __stcs(reinterpret_cast<float4*>(out + p0 + 128 * i), g[i]);
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int ROWS, int M, bool XT>
int launch_gather(const void* cols, const void* x, void* y, int64_t T,
                  int64_t S, int64_t slots, int64_t x_stride,
                  cudaStream_t stream) {
  constexpr int F4 = XT ? M * 4 : ROWS * M / 4;
  constexpr int SPW = F4 <= 32 ? 32 / F4 : 1;
  const size_t smem = (size_t)kWarps * SPW * F4 * sizeof(float4);
  const int e = set_smem(
      reinterpret_cast<const void*>(gather_sum_kernel<ROWS, M, XT>), smem);
  if (e) return e;
  gather_sum_kernel<ROWS, M, XT><<<(unsigned)T, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const float4*>(x),
      static_cast<float4*>(y), S, (int)slots, x_stride / 4);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. Shapes, types, alignment and index ranges
// are checked by the Python wrappers (maxwell_tpu_torch/kernels/
// gather_probes.py, spmm_probes.py).

// rows 8: m in {8, 32, 64, 128} (g0, v4); rows 16: m 8, X (transposed = 0,
// g1) or X^T with row stride x_stride floats (transposed = 1, g4)
extern "C" int gather_sum_f32(const void* cols, const void* x, void* y,
                              int64_t T, int64_t S, int64_t slots,
                              int64_t rows, int64_t m, int64_t transposed,
                              int64_t x_stride, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows == 8 && !transposed) {
    if (m == 8) return launch_gather<8, 8, false>(cols, x, y, T, S, slots, 0,
                                                  st);
    if (m == 32) return launch_gather<8, 32, false>(cols, x, y, T, S, slots,
                                                    0, st);
    if (m == 64) return launch_gather<8, 64, false>(cols, x, y, T, S, slots,
                                                    0, st);
    if (m == 128) return launch_gather<8, 128, false>(cols, x, y, T, S,
                                                      slots, 0, st);
  }
  if (rows == 16 && m == 8)
    return transposed
        ? launch_gather<16, 8, true>(cols, x, y, T, S, slots, x_stride, st)
        : launch_gather<16, 8, false>(cols, x, y, T, S, slots, 0, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gather_taa0_f32(const void* idx, const void* x, void* y,
                               int64_t T, int64_t P, int64_t lo, int64_t hi,
                               void* stream) {
  const size_t smem = 2 * (size_t)P * 8 * sizeof(float);
  const int e = set_smem(reinterpret_cast<const void*>(taa0_kernel), smem);
  if (e) return e;
  taa0_kernel<<<(unsigned)T, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int4*>(idx), static_cast<const float4*>(x),
      static_cast<float*>(y), (int)P, (int)lo, (int)hi);
  return (int)cudaGetLastError();
}

extern "C" int gather_taa1_f32(const void* x, int64_t row_stride,
                               int64_t tile_stride, int64_t width,
                               const void* idx, int64_t idx_stride, void* y,
                               int64_t T, int64_t m, int64_t P, void* stream) {
  const size_t smem = (size_t)m * width * sizeof(float);
  const int e = set_smem(reinterpret_cast<const void*>(taa1_kernel), smem);
  if (e) return e;
  taa1_kernel<<<(unsigned)T, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), row_stride, tile_stride, (int)width,
      static_cast<const int32_t*>(idx), idx_stride, static_cast<float*>(y),
      (int)m, (int)P);
  return (int)cudaGetLastError();
}

// g3w: rows = 8 T source rows of `width` floats (x) and indices (idx, the
// same shape), y (rows, P)
extern "C" int gather_taa1_wide_f32(const void* x, const void* idx, void* y,
                                    int64_t rows, int64_t width, int64_t P,
                                    void* stream) {
  if (rows < 1 || P % 4 || width % 4) return (int)cudaErrorInvalidValue;
  taa1_wide_kernel<<<(unsigned)rows, 32, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<float*>(y), (int)width, (int)P);
  return (int)cudaGetLastError();
}
