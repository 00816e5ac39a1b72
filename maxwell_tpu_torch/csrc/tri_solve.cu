// Level-scheduled sparse triangular solve for NVIDIA Hopper (sm_90a):
// X = T^-1 B for one triangular factor T of kernels/tri_solve.py, all of its
// levels in one launch.
//
// Replaces no Pallas kernel: the reference solves with the factors in a jnp
// lax.fori_loop over the levels (maxwell_tpu/kernels/tri_solve.py:149-157,
// LevelSchedule.solve), which XLA compiles as one device loop. Eager PyTorch
// has no such loop: its plain version (kernels/tri_solve.py
// level_solve_plain) launches about seven operations a level, and the
// shift-invert factors are chains (the LDL^T factor of the 128^2 rectangle
// after RCM has 32,512 levels of one row each), so the loop of launches
// would set the pace of every shift-invert apply. This kernel walks every
// level of a factor in one launch.
//
// Layout (LevelSchedule): rows (L, R) int32, the rows solved at each level,
// padding rows last; cnt (L, R) int32, each row slot's off-diagonal count
// (0 on padding); live (L,) int32, the rows of each level; cols and vals
// (L, R, S), each row's off-diagonal columns and values, padding slots
// last; dinv (n + 1,) the inverse diagonal. B and X are (n, m) row-major.
// At level l, row i = rows[l, r] takes
//   X[i, j] = (B[i, j] - sum_s vals[l, r, s] X[cols[l, r, s], j]) dinv[i],
// whose columns were all solved at earlier levels.
//
// Bound: the chain of levels. The bytes (each live value and column read
// once, B read, X written) take microseconds at the card's memory rate;
// what sets the pace is one level after another, each a few dependent
// loads (the level's rows, their columns, then X at those columns), a warp
// reduction and a block barrier.
//
// Design: a block owns one right-hand-side column j and walks every level
// in order; blocks of different columns never wait for each other. Within
// a level, warp w takes the level's live rows w, w + warps, ...; its lanes
// split the row's live slots (s = lane, lane + 32, ...), each lane summing
// its products in slot order; the warp's partial sums are combined by
// shuffles in a fixed tree, and lane 0 writes the row's X to global memory.
// Padding rows and slots are skipped by the live and cnt counts, so the
// ghost row of the reference's layout is never read. __syncthreads() ends
// each level: the block's global writes are then visible to its own reads
// at later levels. No atomics and a fixed summation order: runs repeat bit
// for bit. The warps a block takes follow the widest level (R, at most 8);
// the LDL^T chains take one warp. Templated on the value type: f32 and f64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
level_solve_kernel(const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ cnt,
                   const int32_t* __restrict__ live,
                   const int32_t* __restrict__ cols,
                   const T* __restrict__ vals, const T* __restrict__ dinv,
                   const T* __restrict__ B, T* X, int64_t n_levels,
                   int64_t R, int64_t S, int64_t m) {
  const int64_t j = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int64_t l = 0; l < n_levels; ++l) {
    const int nl = live[l];
    for (int r = warp; r < nl; r += warps) {
      const int64_t slot = l * R + r;
      const int row = rows[slot];
      const int c = cnt[slot];
      const int32_t* cl = cols + slot * S;
      const T* vl = vals + slot * S;
      T acc = T(0);
      for (int s = lane; s < c; s += 32) {
        acc += vl[s] * X[(int64_t)cl[s] * m + j];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) {
        const int64_t at = (int64_t)row * m + j;
        X[at] = (B[at] - acc) * dinv[row];
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* rows, const void* cnt, const void* live,
           const void* cols, const void* vals, const void* dinv,
           const void* b, void* x, int64_t n_levels, int64_t R, int64_t S,
           int64_t m, void* stream) {
  if (n_levels < 0 || R < 1 || S < 1 || m < 0 || m > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_levels == 0 || m == 0) return 0;
  const int warps = R < kMaxWarps ? (int)R : kMaxWarps;
  level_solve_kernel<T><<<(unsigned)m, warps * 32, 0,
                          (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cnt),
      static_cast<const int32_t*>(live), static_cast<const int32_t*>(cols),
      static_cast<const T*>(vals), static_cast<const T*>(dinv),
      static_cast<const T*>(b), static_cast<T*>(x), n_levels, R, S, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int level_solve_f32(const void* rows, const void* cnt,
                               const void* live, const void* cols,
                               const void* vals, const void* dinv,
                               const void* b, void* x, int64_t n_levels,
                               int64_t R, int64_t S, int64_t m,
                               void* stream) {
  return launch<float>(rows, cnt, live, cols, vals, dinv, b, x, n_levels, R,
                       S, m, stream);
}

extern "C" int level_solve_f64(const void* rows, const void* cnt,
                               const void* live, const void* cols,
                               const void* vals, const void* dinv,
                               const void* b, void* x, int64_t n_levels,
                               int64_t R, int64_t S, int64_t m,
                               void* stream) {
  return launch<double>(rows, cnt, live, cols, vals, dinv, b, x, n_levels,
                        R, S, m, stream);
}
