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
// Bound: device-memory bandwidth. The layout stores 246 MB of values per
// stream at 24^3 (n = 38,088) for 1.17 M nonzeros, about 53x the CSR
// values: the TPU's zero fill for (128, 1024) dots. The kernel reads only
// the layout's live 8 x 16 sub-blocks, compacted (49.4 MB per stream at
// 24^3, 2 bytes per value and split in b3), the X runs they need (staged in
// shared memory), the tables and Y; "b3" does its three bf16 products per
// sub-block on the tensor cores (mma.sync), "highest" true f32 FMAs.
// Not yet used: wgmma, TMA, a persistent grid.

#include "bellunion_tile.cuh"

namespace {

template <bool B3, bool FUSED>
__global__ void __launch_bounds__(kThreads)
bellunion_spmm_kernel(const Params p) {
  union_tile<B3, FUSED>(p, blockIdx.x);
}

template <bool B3, bool FUSED>
int launch(const Params& p, int64_t n_tiles, cudaStream_t stream) {
  auto kernel = bellunion_spmm_kernel<B3, FUSED>;
  size_t smem = 0;
  const cudaError_t e =
      union_smem(reinterpret_cast<const void*>(kernel), p, &smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)n_tiles, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. Shapes are checked by the Python wrappers;
// staging buffers larger than the device's shared memory come back as the
// cudaFuncSetAttribute error, with no launch. The value pointers are the
// layout's compacted live streams; the seven tables are LiveBlocks' sb_ptr,
// sb_run, xr_ptr, xr_run and the layout's ucols, tile_ptr, tile_end
// (nullable).

extern "C" int bellunion_matmat_f32(
    const void* vals, const void* sb_ptr, const void* sb_run,
    const void* xr_ptr, const void* xr_run, const void* ucols,
    const void* tile_ptr, const void* tile_end, const void* x, void* y,
    int64_t n_tiles, int64_t m, int64_t cl, int64_t b, int64_t x_max,
    void* stream) {
  const Tables tb{sb_ptr, sb_run, xr_ptr, xr_run, ucols, tile_ptr, tile_end};
  const Params p = make_params(vals, nullptr, nullptr, nullptr, tb, x, y,
                               nullptr, m, cl, b, x_max);
  return launch<false, false>(p, n_tiles, (cudaStream_t)stream);
}

extern "C" int bellunion_matmat_b3(
    const void* vals_h, const void* vals_l, const void* sb_ptr,
    const void* sb_run, const void* xr_ptr, const void* xr_run,
    const void* ucols, const void* tile_ptr, const void* tile_end,
    const void* x, void* y, int64_t n_tiles, int64_t m, int64_t cl,
    int64_t b, int64_t x_max, void* stream) {
  const Tables tb{sb_ptr, sb_run, xr_ptr, xr_run, ucols, tile_ptr, tile_end};
  const Params p = make_params(vals_h, vals_l, nullptr, nullptr, tb, x, y,
                               nullptr, m, cl, b, x_max);
  return launch<true, false>(p, n_tiles, (cudaStream_t)stream);
}

extern "C" int bellunion_km_matmat_f32(
    const void* vals_k, const void* vals_m, const void* sb_ptr,
    const void* sb_run, const void* xr_ptr, const void* xr_run,
    const void* ucols, const void* tile_ptr, const void* tile_end,
    const void* x, void* yk, void* ym, int64_t n_tiles, int64_t m,
    int64_t cl, int64_t b, int64_t x_max, void* stream) {
  const Tables tb{sb_ptr, sb_run, xr_ptr, xr_run, ucols, tile_ptr, tile_end};
  const Params p = make_params(vals_k, nullptr, vals_m, nullptr, tb, x, yk,
                               ym, m, cl, b, x_max);
  return launch<false, true>(p, n_tiles, (cudaStream_t)stream);
}

extern "C" int bellunion_km_matmat_b3(
    const void* vals_kh, const void* vals_kl, const void* vals_mh,
    const void* vals_ml, const void* sb_ptr, const void* sb_run,
    const void* xr_ptr, const void* xr_run, const void* ucols,
    const void* tile_ptr, const void* tile_end, const void* x, void* yk,
    void* ym, int64_t n_tiles, int64_t m, int64_t cl, int64_t b,
    int64_t x_max, void* stream) {
  const Tables tb{sb_ptr, sb_run, xr_ptr, xr_run, ucols, tile_ptr, tile_end};
  const Params p = make_params(vals_kh, vals_kl, vals_mh, vals_ml, tb, x, yk,
                               ym, m, cl, b, x_max);
  return launch<true, true>(p, n_tiles, (cudaStream_t)stream);
}
