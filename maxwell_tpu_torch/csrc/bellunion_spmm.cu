// BELLUnion SpMM for NVIDIA Hopper (sm_90a): Y = A @ X and the fused
// (K @ X, M @ X) on the tile-union layout of maxwell_tpu_torch/sparse/bellunion.py.
//
// Replaces the Pallas TPU kernels in maxwell_tpu/kernels/spmm.py:
//   bellunion_matmat_pallas     (_bellunion_kernel, _bellunion_kernel_b3)
//   bellunion_km_matmat_pallas  (_bellunion_km_kernel, _bellunion_km_kernel_b3)
//   bellunion_matvec_pallas     (the m = 1 case of the single-stream kernel)
//
// What it computes and how: csrc/bellunion_tile.cuh, whose per-tile body
// this kernel shares with the fused interior SpMM of csrc/halo.cu.
//
// Bound: device-memory bandwidth. The layout streams 247 MB of values per
// stream at 24^3 (n = 38,088) for 1.17 M nonzeros: about 53x the CSR values,
// almost all zero fill that the TPU accepted for (128, 1024) dots shaped for
// its matrix unit. The layout is kept unchanged for parity with the JAX
// package; a layout shaped for the GPU is later work.
// Not yet used: wgmma/mma, TMA and cp.async pipelining, a persistent grid.

#include "bellunion_tile.cuh"

namespace {

template <int MS, bool B3, bool FUSED>
__global__ void __launch_bounds__(kThreads)
bellunion_spmm_kernel(const Params p) {
  union_tile<MS, B3, FUSED>(p, blockIdx.x, blockIdx.y);
}

template <int MS, bool B3, bool FUSED>
int launch_ms(const Params& p, int64_t n_tiles, cudaStream_t stream) {
  auto kernel = bellunion_spmm_kernel<MS, B3, FUSED>;
  size_t smem = 0;
  const cudaError_t e =
      union_smem<MS>(reinterpret_cast<const void*>(kernel), p.cl, &smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)n_tiles, kBlocksPerTile);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// column-slice width: the smallest template width that holds m (up to 16);
// m = 9 (the solver's block) takes 12
template <bool B3, bool FUSED>
int launch(const Params& p, int64_t n_tiles, cudaStream_t stream) {
  if (p.m == 1) return launch_ms<1, B3, FUSED>(p, n_tiles, stream);
  if (p.m == 2) return launch_ms<2, B3, FUSED>(p, n_tiles, stream);
  if (p.m <= 4) return launch_ms<4, B3, FUSED>(p, n_tiles, stream);
  if (p.m <= 8) return launch_ms<8, B3, FUSED>(p, n_tiles, stream);
  if (p.m <= 12) return launch_ms<12, B3, FUSED>(p, n_tiles, stream);
  return launch_ms<16, B3, FUSED>(p, n_tiles, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. Shapes are checked by the Python wrappers;
// a staged X block larger than the device's shared memory comes back as the
// cudaFuncSetAttribute error, with no launch.

extern "C" int bellunion_matmat_f32(
    const void* vals, const void* ucols, const void* tile_ptr,
    const void* tile_end, const void* x, void* y, int64_t n_tiles,
    int64_t m, int64_t cl, int64_t b, int64_t pack, void* stream) {
  const Params p = make_params(vals, nullptr, nullptr, nullptr, ucols,
                               tile_ptr, tile_end, x, y, nullptr, m, cl, b,
                               pack);
  return launch<false, false>(p, n_tiles, (cudaStream_t)stream);
}

extern "C" int bellunion_matmat_b3(
    const void* vals_h, const void* vals_l, const void* ucols,
    const void* tile_ptr, const void* tile_end, const void* x, void* y,
    int64_t n_tiles, int64_t m, int64_t cl, int64_t b, int64_t pack,
    void* stream) {
  const Params p = make_params(vals_h, vals_l, nullptr, nullptr, ucols,
                               tile_ptr, tile_end, x, y, nullptr, m, cl, b,
                               pack);
  return launch<true, false>(p, n_tiles, (cudaStream_t)stream);
}

extern "C" int bellunion_km_matmat_f32(
    const void* vals_k, const void* vals_m, const void* ucols,
    const void* tile_ptr, const void* tile_end, const void* x, void* yk,
    void* ym, int64_t n_tiles, int64_t m, int64_t cl, int64_t b,
    int64_t pack, void* stream) {
  const Params p = make_params(vals_k, nullptr, vals_m, nullptr, ucols,
                               tile_ptr, tile_end, x, yk, ym, m, cl, b,
                               pack);
  return launch<false, true>(p, n_tiles, (cudaStream_t)stream);
}

extern "C" int bellunion_km_matmat_b3(
    const void* vals_kh, const void* vals_kl, const void* vals_mh,
    const void* vals_ml, const void* ucols, const void* tile_ptr,
    const void* tile_end, const void* x, void* yk, void* ym,
    int64_t n_tiles, int64_t m, int64_t cl, int64_t b, int64_t pack,
    void* stream) {
  const Params p = make_params(vals_kh, vals_kl, vals_mh, vals_ml, ucols,
                               tile_ptr, tile_end, x, yk, ym, m, cl, b,
                               pack);
  return launch<true, true>(p, n_tiles, (cudaStream_t)stream);
}
