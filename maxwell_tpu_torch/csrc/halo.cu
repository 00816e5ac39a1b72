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
// [own Lb rows if own | left Hb | right Hb | pad zero rows]: with own and
// pad = b the halo-extended buffer the blocked-ELL boundary product reads;
// without, the [left | right] section the union boundary product reads. The
// TPU kernel moved one buffer per remote DMA and its caller zeroed the chain
// ends and concatenated; here one pass writes the finished buffer.
// Bound: bytes (each output row written once, each source row read once).
// Design: a shard's block is at most five segments, each one contiguous
// byte range in the output and, where it copies, in X (ring_segment below;
// kernels/halo.py::ring_shift_plan is the same table on the host): own rows,
// the left halo's zero rows before X's first row, the left rows in X, the
// right rows in X, then the right halo's zero rows past X's end and the pad.
// The grid is (chunk, segment, shard); a block finds its segment with a few
// scalar operations and copies one chunk of it in units of 16, 8 or 4 bytes,
// the widest that divides every segment's byte offset and length and both
// pointers (chosen on the host, checked here), four units per thread, all
// loads issued before the first store. Index math inside a segment is
// 32-bit, with no division per unit. It only moves bytes, so f32 and f64
// are one kernel.
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
constexpr int kCopyUnroll = 4;     // units in flight per thread
constexpr int kSegments = 5;

// The geometry of one ring shift, in rows of row_bytes bytes
struct Ring {
  int64_t D, Lb, Hb, pad, rows, row_bytes;  // rows: output rows per shard
  bool own;
};

struct Segment {
  int64_t dst, src, n;  // rows; src < 0: n zero rows
};

__host__ __device__ inline int64_t clamp64(int64_t v, int64_t lo,
                                           int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Segment k of shard d (see the file comment); kernels/halo.py's
// ring_shift_plan builds the same table
__host__ __device__ inline Segment ring_segment(const Ring& g, int64_t d,
                                                int k) {
  const int64_t o = g.own ? g.Lb : 0;
  const int64_t base = d * g.rows;
  const int64_t zl = clamp64(g.Hb - d * g.Lb, 0, g.Hb);
  const int64_t rc = clamp64((g.D - 1 - d) * g.Lb, 0, g.Hb);
  switch (k) {
    case 0: return {base, d * g.Lb, o};
    case 1: return {base + o, -1, zl};
    case 2: return {base + o + zl, d * g.Lb - g.Hb + zl, g.Hb - zl};
    case 3: return {base + o + g.Hb, (d + 1) * g.Lb, rc};
    default: return {base + o + g.Hb + rc, -1, g.Hb - rc + g.pad};
  }
}

// Units [0, n) of one chunk, THREADS threads: every load, then every store
template <typename U, int THREADS>
__device__ __forceinline__ void copy_chunk(const U* src, U* dst, int n,
                                           int tid) {
  U v[kCopyUnroll];
#pragma unroll
  for (int k = 0; k < kCopyUnroll; ++k) {
    const int u = k * THREADS + tid;
    v[k] = (src != nullptr && u < n) ? src[u] : U{};
  }
#pragma unroll
  for (int k = 0; k < kCopyUnroll; ++k) {
    const int u = k * THREADS + tid;
    if (u < n) dst[u] = v[k];
  }
}

// Chunk `chunk` (THREADS * kCopyUnroll units of 1 << shift bytes) of
// segment k of shard d
template <int THREADS>
__device__ __forceinline__ void segment_copy(const void* x, void* out,
                                             const Ring& g, int shift,
                                             int64_t d, int k, int64_t chunk,
                                             int tid) {
  const Segment s = ring_segment(g, d, k);
  const int64_t c0 = chunk * (THREADS * kCopyUnroll);
  const int64_t left = ((s.n * g.row_bytes) >> shift) - c0;
  if (left <= 0) return;
  const int n = (int)(left < THREADS * kCopyUnroll ? left
                                                   : THREADS * kCopyUnroll);
  char* dst = static_cast<char*>(out) + s.dst * g.row_bytes + (c0 << shift);
  const char* src =
      s.src < 0 ? nullptr
                : static_cast<const char*>(x) + s.src * g.row_bytes +
                      (c0 << shift);
  if (shift == 4)
    copy_chunk<uint4, THREADS>(reinterpret_cast<const uint4*>(src),
                               reinterpret_cast<uint4*>(dst), n, tid);
  else if (shift == 3)
    copy_chunk<uint2, THREADS>(reinterpret_cast<const uint2*>(src),
                               reinterpret_cast<uint2*>(dst), n, tid);
  else
    copy_chunk<uint32_t, THREADS>(reinterpret_cast<const uint32_t*>(src),
                                  reinterpret_cast<uint32_t*>(dst), n, tid);
}

// Checks a unit of 1 << shift bytes against both pointers and every
// segment's offsets and length; returns the chunks of the longest segment
// for THREADS-thread blocks, 0 if nothing is copied, -1 if the unit does
// not fit or a segment's units pass 32 bits.
inline int64_t ring_chunks(const Ring& g, const void* x, const void* out,
                           int shift, int threads) {
  if (shift < 2 || shift > 4 || g.D < 1 || g.D > 65535) return -1;
  const int64_t unit = (int64_t)1 << shift;
  if (((uintptr_t)x | (uintptr_t)out) % unit) return -1;
  int64_t longest = 0;
  for (int64_t d = 0; d < g.D; ++d) {
    for (int k = 0; k < kSegments; ++k) {
      const Segment s = ring_segment(g, d, k);
      if (s.n <= 0) continue;
      const int64_t bytes = s.n * g.row_bytes;
      if ((s.dst * g.row_bytes) % unit || bytes % unit ||
          (s.src >= 0 && (s.src * g.row_bytes) % unit))
        return -1;
      if (bytes / unit > longest) longest = bytes / unit;
    }
  }
  if (longest >= ((int64_t)1 << 31)) return -1;
  const int64_t chunk = (int64_t)threads * kCopyUnroll;
  return (longest + chunk - 1) / chunk;
}

// grid (chunk, segment, shard); without own rows segment 0 is empty and
// the grid's y starts at segment 1
__global__ void __launch_bounds__(kCopyThreads)
ring_shift_kernel(const void* x, void* out, const Ring g, int shift) {
  segment_copy<kCopyThreads>(x, out, g, shift, blockIdx.z,
                             blockIdx.y + (g.own ? 0 : 1), blockIdx.x,
                             threadIdx.x);
}

// blocks of kThreads: the first n_copy copy the halo section (chunks of
// segments 1-4 of each shard, as ring_shift without own rows), the rest are
// K2's blocks of the stacked interior layout, one per tile
template <bool FUSED>
__global__ void __launch_bounds__(kThreads)
union_overlap_kernel(const Params p, float* halo, const Ring g, int shift,
                     int64_t n_chunks, int64_t n_copy) {
  const int64_t bx = blockIdx.x;
  if (bx < n_copy) {
    const int64_t t = bx / n_chunks;
    segment_copy<kThreads>(p.x, halo, g, shift, t / (kSegments - 1),
                           1 + (int)(t % (kSegments - 1)), bx % n_chunks,
                           threadIdx.x);
    return;
  }
  union_tile<false, FUSED>(p, bx - n_copy);
}

template <bool FUSED>
int overlap(const Params& p, float* halo, int64_t n_tiles, const Ring& g,
            int shift, cudaStream_t stream) {
  auto kernel = union_overlap_kernel<FUSED>;
  size_t smem = 0;
  const cudaError_t e =
      union_smem(reinterpret_cast<const void*>(kernel), p, &smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t n_chunks = ring_chunks(g, p.x, halo, shift, kThreads);
  if (n_chunks < 0) return (int)cudaErrorInvalidValue;
  const int64_t n_copy = n_chunks * (kSegments - 1) * g.D;
  const int64_t blocks = n_copy + n_tiles;
  if (blocks == 0) return 0;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p, halo, g, shift,
                                                        n_chunks, n_copy);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. Shapes are checked by the Python wrappers
// (kernels/halo.py).

// unit: the copy unit in bytes (16, 8 or 4), kernels/halo.py's choice; one
// that does not divide both pointers and every segment's offsets and
// length returns cudaErrorInvalidValue, with no launch
extern "C" int ring_shift(const void* x, void* out, int64_t D, int64_t Lb,
                          int64_t Hb, int64_t row_bytes, int64_t pad_rows,
                          int64_t own, int64_t unit, void* stream) {
  const Ring g{D, Lb, Hb, pad_rows, (own ? Lb : 0) + 2 * Hb + pad_rows,
               row_bytes, own != 0};
  const int shift = unit == 16 ? 4 : unit == 8 ? 3 : unit == 4 ? 2 : -1;
  const int64_t n_chunks = ring_chunks(g, x, out, shift, kCopyThreads);
  if (n_chunks < 0) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  const dim3 grid((unsigned)n_chunks, own ? kSegments : kSegments - 1,
                  (unsigned)D);
  ring_shift_kernel<<<grid, kCopyThreads, 0, (cudaStream_t)stream>>>(
      x, out, g, shift);
  return (int)cudaGetLastError();
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
    int64_t Hb, int64_t unit, void* stream) {
  const Tables tb{sb_ptr, sb_run, xr_ptr, xr_run, ucols, tile_ptr, tile_end};
  const Params p = make_params(vals_a, nullptr, vals_b, nullptr, tb, x, ya,
                               yb, m, cl, b, x_max);
  const Ring g{D, Lb, Hb, 0, 2 * Hb, m * (int64_t)sizeof(float), false};
  const int shift = unit == 16 ? 4 : unit == 8 ? 3 : unit == 4 ? 2 : -1;
  float* h = static_cast<float*>(halo);
  cudaStream_t s = (cudaStream_t)stream;
  if (vals_b == nullptr) return overlap<false>(p, h, n_tiles, g, shift, s);
  return overlap<true>(p, h, n_tiles, g, shift, s);
}
