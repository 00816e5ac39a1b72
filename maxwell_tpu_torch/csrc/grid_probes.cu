// BELLPairs per-tile cost probes for NVIDIA Hopper (sm_90a): the H100
// counterparts of the six TPU kernels inside main() of
// maxwell_tpu/bench/exp_grid.py (K15d). No solver calls them; the probe
// script maxwell_tpu_torch/bench/exp_grid.py does.
//
// The probe's data (exp_grid.py:32-44): T tiles of R = 16 block rows of
// b = 8 rows (128 output rows per tile), m = 8 columns, Q = NCH * Cp = 48
// pair slots per block row of which the first LIVE * Cp = 24 are read. A
// pair slice of X is 16 consecutive rows (512 bytes) from row 8 cols[r, q];
// a pair value panel is (8, 16), eight 64-byte rows 16 Q floats (3 KB)
// apart, as in K11's layout (csrc/bellpairs_spmm.cu).
//
//   grid_copy     e0_grid1 (exp_grid.py:69-78, pallas_call :74): each tile
//                 writes X[0:128], one block per tile (grid (T,)); with
//                 steps = 6, e1_grid6 (:83-96, :92): grid (T, 6), the blocks
//                 with j > 0 return at once, as the TPU's pl.when(j == 0)
//                 left five of six grid steps empty.
//   grid_steps    e2_grid6_when (:101-121, :119): X[0:128] at the first step,
//                 then += X[0:128] at each step j < min(nch[t], 6). The TPU
//                 grid axis j is a sequential loop; here it is a loop inside
//                 the block that stops at the tile's live count, as K11 stops
//                 at its live pair count (no blocks racing on one output).
//   grid_acc      e3_acc424 (:124-141, :133): the (16, 8) sum of the tile's
//                 16 x 24 X slices, summed in registers as they arrive,
//                 written tiled 8 times. 8 warps per tile, as grid_cat, so
//                 that e3 against e4 differs in the staging alone.
//   grid_cat      e4_cat424 (:143-170, :162): per block row r and chunk c,
//                 the row's 8 slices are first staged in shared memory (the
//                 TPU's concatenated panel), then summed per row; the tile's
//                 output is the first 128 rows of the (16 x 16, 8) stack,
//                 i.e. rows r < 8. Rows 8-15 are staged as the reference
//                 concatenates them; their sums are not needed.
//   grid_cat_mm   e5_cat424_mm (:172-199, :189): Y_r = sum over the 24 live
//                 slots of the (8, 16) value panel @ the (16, 8) X slice,
//                 true f32 FMAs, one warp per block row as in K11.
//
// Bounds (the function's bytes over 3.35 TB/s): e0-e4 write 1.2 MB of Y and
// read 4 KB (e0-e2) or X once (1.2 MB, e3/e4); their 58.6 MB of gathered
// slices at T 298 come from L2. e5 must read the 24 live panels of every
// block row, 58.6 MB of the 117 MB value stream, for 0.23 GFLOP: bytes.
// What the design does about it: e0-e2 have nothing to move and measure the
// per-block and per-step cost; e3/e4 gather with 16-byte loads, a warp per
// slice (32 lanes x 16 bytes = 512 bytes); e5 reads each value panel with
// one 16-byte load per lane (the panel's rows 3 KB apart, the pattern whose
// rate the probe measures) and the X slice as two 16-byte loads per row.
// Every output is written once by one thread: no atomics, runs repeat bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 16;                  // block rows per tile
constexpr int kB = 8;                   // rows per block row
constexpr int kCp = 8;                  // pair slots per chunk
constexpr int kTileF4 = kR * kB * 8 / 4;  // float4 of a (128, 8) tile: 256
constexpr int kSliceF4 = 2 * kB * 8 / 4;  // float4 of a (16, 8) slice: 32
constexpr int kAccWarps = 8;            // grid_acc: warps per tile, as grid_cat
constexpr int kCatThreads = 256;        // grid_cat: 8 warps per tile
constexpr int kMmWarps = 8;             // grid_cat_mm: block rows per block

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__global__ void __launch_bounds__(kTileF4)
grid_copy_kernel(const float4* __restrict__ x, float4* __restrict__ y) {
  if (blockIdx.y != 0) return;  // e1: the grid's empty chunk steps
  y[(size_t)blockIdx.x * kTileF4 + threadIdx.x] = __ldg(x + threadIdx.x);
}

__global__ void __launch_bounds__(kTileF4)
grid_steps_kernel(const int32_t* __restrict__ nch,
                  const float4* __restrict__ x, float4* __restrict__ y,
                  int nch_max) {
  const int t = blockIdx.x;
  const float4 v = __ldg(x + threadIdx.x);
  int live = __ldg(nch + t);
  live = live < nch_max ? live : nch_max;
  float4 acc = v;  // step 0 sets the tile
  for (int j = 0; j < live; ++j) acc = add4(acc, v);
  y[(size_t)t * kTileF4 + threadIdx.x] = acc;
}

// warp w sums slices w, w + 8, ...; lane l holds float4 l of the slice
__global__ void __launch_bounds__(kAccWarps * 32)
grid_acc_kernel(const int32_t* __restrict__ cols,
                const float4* __restrict__ x, float4* __restrict__ y,
                int64_t Q, int live_slots) {
  __shared__ float4 part[kAccWarps][kSliceF4];
  const int64_t t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int32_t* crow = cols + t * kR * Q;
  const int n = kR * live_slots;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = warp; s < n; s += kAccWarps) {
    const int r = s / live_slots;
    const int q = s - r * live_slots;
    const int64_t c = __ldg(crow + r * Q + q);
    acc = add4(acc, __ldg(x + c * (kB * 8 / 4) + lane));
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float4 s = part[0][lane];
#pragma unroll
    for (int w = 1; w < kAccWarps; ++w) s = add4(s, part[w][lane]);
    part[0][lane] = s;
  }
  __syncthreads();
  // the (16, 8) sum tiled 8 times down the tile's 128 rows
  for (int f = threadIdx.x; f < kTileF4; f += kAccWarps * 32)
    y[t * kTileF4 + f] = part[0][f % kSliceF4];
}

// per chunk: stage the (16 rows, 8 slots, 32 float4) panel, then warp w sums
// row w across the slots
__global__ void __launch_bounds__(kCatThreads)
grid_cat_kernel(const int32_t* __restrict__ cols,
                const float4* __restrict__ x, float4* __restrict__ y,
                int64_t Q, int live) {
  extern __shared__ float4 panel[];  // [kR][kCp][kSliceF4], 64 KB
  const int64_t t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int32_t* crow = cols + t * kR * Q;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < live; ++c) {
#pragma unroll 4
    for (int i = threadIdx.x; i < kR * kCp * kSliceF4; i += kCatThreads) {
      const int f = i % kSliceF4;
      const int q = (i / kSliceF4) % kCp;
      const int r = i / (kSliceF4 * kCp);
      const int64_t col = __ldg(crow + r * Q + c * kCp + q);
      panel[i] = __ldg(x + col * (kB * 8 / 4) + f);
    }
    __syncthreads();
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kCp; ++q)
      a = add4(a, panel[(warp * kCp + q) * kSliceF4 + lane]);
    acc = add4(acc, a);
    __syncthreads();
  }
  // rows r < 8 of the stack are the tile's output
  y[t * kTileF4 + warp * kSliceF4 + lane] = acc;
}

// one warp per block row: lane (i = lane / 4, k0 = 4 (lane % 4)) takes row i
// of each value panel, columns k0 .. k0 + 3, and X rows k0 .. k0 + 3 of the
// slice; two xor shuffles finish the sums, lane 4 i writes row i
__global__ void __launch_bounds__(kMmWarps * 32)
grid_cat_mm_kernel(const int32_t* __restrict__ cols,
                   const float* __restrict__ vals,
                   const float4* __restrict__ x, float4* __restrict__ y,
                   int64_t Q, int live_slots) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kMmWarps + warp;
  const int i = lane >> 2;
  const int k0 = (lane & 3) * 4;
  const float* va = vals + (r * kB + i) * (Q * 2 * kB) + k0;
  const int32_t* crow = cols + r * Q;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int s = 0; s < live_slots; ++s) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(va + s * 2 * kB));
    const float4* xr = x + ((int64_t)__ldg(crow + s) * kB + k0) * 2;
    const float vk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 a = __ldg(xr + 2 * k);
      const float4 b = __ldg(xr + 2 * k + 1);
      acc[0] = fmaf(vk[k], a.x, acc[0]);
      acc[1] = fmaf(vk[k], a.y, acc[1]);
      acc[2] = fmaf(vk[k], a.z, acc[2]);
      acc[3] = fmaf(vk[k], a.w, acc[3]);
      acc[4] = fmaf(vk[k], b.x, acc[4]);
      acc[5] = fmaf(vk[k], b.y, acc[5]);
      acc[6] = fmaf(vk[k], b.z, acc[6]);
      acc[7] = fmaf(vk[k], b.w, acc[7]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 1);
    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 2);
  }
  if ((lane & 3) == 0) {
    float4* yr = y + (r * kB + i) * 2;
    yr[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    yr[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. Shapes, types and alignment are checked by
// the Python wrappers (maxwell_tpu_torch/kernels/grid_probes.py).

extern "C" int grid_copy_f32(const void* x, void* y, int64_t T, int64_t steps,
                             void* stream) {
  grid_copy_kernel<<<dim3((unsigned)T, (unsigned)steps), kTileF4, 0,
                     (cudaStream_t)stream>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y));
  return (int)cudaGetLastError();
}

extern "C" int grid_steps_f32(const void* nch, const void* x, void* y,
                              int64_t T, int64_t nch_max, void* stream) {
  grid_steps_kernel<<<(unsigned)T, kTileF4, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(nch), static_cast<const float4*>(x),
      static_cast<float4*>(y), (int)nch_max);
  return (int)cudaGetLastError();
}

extern "C" int grid_acc_f32(const void* cols, const void* x, void* y,
                            int64_t T, int64_t Q, int64_t live_slots,
                            void* stream) {
  grid_acc_kernel<<<(unsigned)T, kAccWarps * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const float4*>(x),
      static_cast<float4*>(y), Q, (int)live_slots);
  return (int)cudaGetLastError();
}

extern "C" int grid_cat_f32(const void* cols, const void* x, void* y,
                            int64_t T, int64_t Q, int64_t live, void* stream) {
  const int smem = kR * kCp * kSliceF4 * (int)sizeof(float4);
  const cudaError_t e = cudaFuncSetAttribute(
      grid_cat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  grid_cat_kernel<<<(unsigned)T, kCatThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const float4*>(x),
      static_cast<float4*>(y), Q, (int)live);
  return (int)cudaGetLastError();
}

extern "C" int grid_cat_mm_f32(const void* cols, const void* vals,
                               const void* x, void* y, int64_t T, int64_t Q,
                               int64_t live_slots, void* stream) {
  grid_cat_mm_kernel<<<(unsigned)(T * kR / kMmWarps), kMmWarps * 32, 0,
                       (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
      static_cast<const float4*>(x), static_cast<float4*>(y), Q,
      (int)live_slots);
  return (int)cudaGetLastError();
}
