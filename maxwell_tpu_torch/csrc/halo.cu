// Halo exchange of the row-sharded pencil for NVIDIA Hopper (sm_90a), with
// every shard of the stacked view (D shards of Lb rows, one after the other
// in one (D*Lb, m) tensor) held by one process on one card.
//
// Replaces the Pallas TPU kernels in maxwell_tpu/kernels/halo_rdma.py:
//   ring_shift (_ring_kernel), as exchange_halos_rdma calls it   -> ring_shift
//   union_interior_overlap (_union_overlap_kernel)               -> union_overlap
//
// ring_shift: one launch fills the halo section of all D shards. Shard d's
// left half is rows [d*Lb - Hb, d*Lb) of the stacked X (shard d-1's last Hb
// rows), its right half rows [(d+1)*Lb, (d+1)*Lb + Hb) (shard d+1's first
// Hb rows); a row outside [0, D*Lb) is written as zero, so the chain ends
// hold zeros and not whatever the buffer held (a NaN there would survive the
// zero columns of the boundary layout). Each shard's output block is
// [own Lb rows if own | left Hb | right Hb | zero rows up to out_rows],
// starting at column-block row halo_off for the halo: own = 1, halo_off =
// Lb, out_rows = Lb + 2Hb + b is the halo-extended buffer the blocked-ELL
// boundary product reads; own = 0, halo_off = 0, out_rows = 2Hb is the
// [left | right] section the union boundary product reads. The TPU kernel
// moved one buffer per remote DMA and its caller zeroed the chain ends and
// concatenated; here one pass writes the finished buffer.
// Bound: bytes (each output row written once, each source row read once).
// It only moves bytes, so f32 and f64 are one kernel: rows are copied in
// 16-, 8- or 4-byte units, the widest that the row width and the pointers'
// alignment allow.
//
// union_overlap: the interior BELLUnion SpMM of every shard (one value
// stream, or two with one X gather) and, in the same grid, the halo copy
// into the [left | right] section. The TPU kernel started two remote DMAs at
// chunk 0 and waited for them at the last chunk; here the copy is done by
// extra thread blocks placed at the front of the grid, so they are scheduled
// first and run beside the compute blocks. The per-tile body is K2's
// (csrc/bellunion_tile.cuh), so the products agree bit for bit with the
// one-stream kernel. The interior layouts of the D shards are padded to a
// common chunk count and stacked into one layout whose columns index the
// stacked X (sparse/bellunion.py, dist/partition.py), so one launch covers
// every shard; a tile stops at tile_end, before the zero padding chunks,
// which the TPU grid streamed and which here would all fall to the block of
// each shard's last tile. "highest" precision only, as the TPU kernel.
// Bound: bytes, as K2 (the stacked layout's live sub-blocks, compacted).

#include "bellunion_tile.cuh"

namespace {

constexpr int kCopyThreads = 256;  // ring_shift's blocks
constexpr int64_t kMaxCopyBlocks = 132 * 16;

// Writes element i of the stacked output (see the file comment); i runs
// over [i0, D * out_rows * units) in steps of `stride`.
template <typename U>
__device__ __forceinline__ void halo_rows(
    const U* x, U* out, int64_t D, int64_t Lb, int64_t Hb, int64_t units,
    int64_t out_rows, bool own, int64_t halo_off, int64_t i0,
    int64_t stride) {
  const int64_t total = D * out_rows * units;
  for (int64_t i = i0; i < total; i += stride) {
    const int64_t row = i / units;
    const int64_t u = i - row * units;
    const int64_t d = row / out_rows;
    const int64_t r = row - d * out_rows;
    int64_t src = -1;
    if (own && r < Lb) {
      src = d * Lb + r;
    } else if (r >= halo_off && r < halo_off + 2 * Hb) {
      const int64_t h = r - halo_off;
      src = h < Hb ? d * Lb - Hb + h : (d + 1) * Lb + (h - Hb);
      if (src >= D * Lb) src = -1;
    }
    out[i] = src >= 0 ? x[src * units + u] : U{};
  }
}

template <typename U>
__global__ void ring_shift_kernel(const U* x, U* out, int64_t D, int64_t Lb,
                                  int64_t Hb, int64_t units, int64_t out_rows,
                                  bool own, int64_t halo_off) {
  halo_rows<U>(x, out, D, Lb, Hb, units, out_rows, own, halo_off,
               (int64_t)blockIdx.x * kCopyThreads + threadIdx.x,
               (int64_t)gridDim.x * kCopyThreads);
}

template <typename U>
int ring_shift_launch(const void* x, void* out, int64_t D, int64_t Lb,
                      int64_t Hb, int64_t row_bytes, int64_t out_rows,
                      bool own, int64_t halo_off, cudaStream_t stream) {
  const int64_t units = row_bytes / (int64_t)sizeof(U);
  const int64_t total = D * out_rows * units;
  if (total == 0) return 0;
  int64_t blocks = (total + kCopyThreads - 1) / kCopyThreads;
  if (blocks > kMaxCopyBlocks) blocks = kMaxCopyBlocks;
  ring_shift_kernel<U><<<(unsigned)blocks, kCopyThreads, 0, stream>>>(
      static_cast<const U*>(x), static_cast<U*>(out), D, Lb, Hb, units,
      out_rows, own, halo_off);
  return (int)cudaGetLastError();
}

// blocks of kThreads: the first n_copy copy the halo section, the rest are
// K2's blocks of the stacked interior layout, one per tile
template <bool FUSED>
__global__ void __launch_bounds__(kThreads)
union_overlap_kernel(const Params p, float* halo, int64_t D, int64_t Lb,
                     int64_t Hb, int64_t n_copy) {
  const int64_t bx = blockIdx.x;
  if (bx < n_copy) {
    halo_rows<float>(p.x, halo, D, Lb, Hb, p.m, 2 * Hb, false, 0,
                     bx * kThreads + threadIdx.x, n_copy * kThreads);
    return;
  }
  union_tile<false, FUSED>(p, bx - n_copy);
}

template <bool FUSED>
int overlap(const Params& p, float* halo, int64_t n_tiles, int64_t D,
            int64_t Lb, int64_t Hb, cudaStream_t stream) {
  auto kernel = union_overlap_kernel<FUSED>;
  size_t smem = 0;
  const cudaError_t e =
      union_smem(reinterpret_cast<const void*>(kernel), p, &smem);
  if (e != cudaSuccess) return (int)e;
  // about eight copied values per thread
  const int64_t total = D * 2 * Hb * p.m;
  int64_t n_copy = (total + kThreads * 8 - 1) / (kThreads * 8);
  if (n_copy > kMaxCopyBlocks) n_copy = kMaxCopyBlocks;
  const int64_t blocks = n_copy + n_tiles;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p, halo, D, Lb, Hb,
                                                        n_copy);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. Shapes are checked by the Python wrappers
// (kernels/halo.py).

extern "C" int ring_shift(const void* x, void* out, int64_t D, int64_t Lb,
                          int64_t Hb, int64_t row_bytes, int64_t out_rows,
                          int64_t own, int64_t halo_off, void* stream) {
  const uintptr_t a = (uintptr_t)x | (uintptr_t)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && a % 16 == 0)
    return ring_shift_launch<uint4>(x, out, D, Lb, Hb, row_bytes, out_rows,
                                    own != 0, halo_off, s);
  if (row_bytes % 8 == 0 && a % 8 == 0)
    return ring_shift_launch<uint2>(x, out, D, Lb, Hb, row_bytes, out_rows,
                                    own != 0, halo_off, s);
  if (row_bytes % 4 == 0 && a % 4 == 0)
    return ring_shift_launch<uint32_t>(x, out, D, Lb, Hb, row_bytes,
                                       out_rows, own != 0, halo_off, s);
  return (int)cudaErrorInvalidValue;
}

// vals_b == nullptr: one stream (vals_a) into ya; else both, one X gather.
// The value pointers and tables are those of the bellunion_matmat_* entry
// points (csrc/bellunion_spmm.cu).
extern "C" int union_overlap_f32(
    const void* vals_a, const void* vals_b, const void* sb_ptr,
    const void* sb_run, const void* xr_ptr, const void* xr_run,
    const void* ucols, const void* tile_ptr, const void* tile_end,
    const void* x, void* ya, void* yb, void* halo, int64_t n_tiles,
    int64_t m, int64_t cl, int64_t b, int64_t x_max, int64_t D, int64_t Lb,
    int64_t Hb, void* stream) {
  const Tables tb{sb_ptr, sb_run, xr_ptr, xr_run, ucols, tile_ptr, tile_end};
  const Params p = make_params(vals_a, nullptr, vals_b, nullptr, tb, x, ya,
                               yb, m, cl, b, x_max);
  float* h = static_cast<float*>(halo);
  cudaStream_t s = (cudaStream_t)stream;
  if (vals_b == nullptr)
    return overlap<false>(p, h, n_tiles, D, Lb, Hb, s);
  return overlap<true>(p, h, n_tiles, D, Lb, Hb, s);
}
