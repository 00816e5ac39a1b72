// Halo exchange of the row-sharded pencil for NVIDIA Hopper (sm_90a). A
// process holds Dl consecutive shards of the D (global shards d0 .. d0 +
// Dl - 1) in a stacked view: Dl shards of Lb rows, one after the other in
// one (Dl*Lb, m) tensor. One process holds all D (d0 = 0, Dl = D), or P
// processes hold D/P each, on one card, on the cards of one host or on the
// cards of several hosts.
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
//
// Across processes (d0 > 0 or d0 + Dl < D) the copy is a push, as the TPU
// kernel's remote DMA: the left halo of this process's first shard is the
// previous process's last rows, which that process writes, and the right
// halo of its last shard the next process's first rows. So a launch skips
// those two segments of its own output and writes, from its own X, the
// previous process's last right halo and the next process's first left
// halo, straight into their outputs through pointers the caller mapped
// with the IPC entries below (a buffer of each process's own cudaMalloc,
// exported with cudaIpcGetMemHandle and opened by its neighbours). The
// launch orders nothing across processes: the caller synchronizes its
// stream and meets its neighbours at a barrier before the launch (no
// neighbour still reads the halo this launch overwrites) and after it (no
// one reads before every push has landed), kernels/halo.py HaloLink.
// A neighbour on another host cannot map this process's buffer: there the
// caller carries the halo itself (a host-staged copy between the fences),
// and the launch is told so by a per-side flag. push_left / push_right: 1
// pushes that side into the mapped peer pointer, 0 skips it; either way
// the launch leaves the side's segment of its own output to the neighbour.
// Design: a shard's block is at most five segments, each one contiguous
// byte range in the output and, where it copies, in X (ring_segment below;
// kernels/halo.py::ring_shift_plan is the same table on the host): own rows,
// the left halo's zero rows before X's first row, the left rows in X, the
// right rows in X, then the right halo's zero rows past X's end and the pad.
// The grid is (chunk, segment, task): a task is a local shard, or one of the
// two pushes. A block finds its segment with a few scalar operations and copies one chunk of it in units of 16, 8 or 4 bytes,
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

#include <cstring>

#include "bellunion_tile.cuh"

namespace {

constexpr int kCopyThreads = 256;  // ring_shift's blocks
constexpr int kCopyUnroll = 4;     // units in flight per thread
constexpr int kSegments = 5;

// The geometry of one ring shift, in rows of row_bytes bytes: D shards in
// all, this process's Dl from shard d0 on; push_l / push_r: whether the
// launch pushes into the previous / next process's output (a neighbour on
// another host gets its rows by the caller's host-staged copy instead)
struct Ring {
  int64_t D, d0, Dl, Lb, Hb, pad, rows, row_bytes;  // rows: a shard's out
  bool own, push_l, push_r;
};

// The neighbours' outputs (nullptr where none): the previous process's and
// the next one's, mapped into this process
struct Peers {
  void* left;
  void* right;
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

// Tasks of a launch: the Dl local shards, then the two pushes where
// another process holds shards
__host__ __device__ inline int64_t ring_tasks(const Ring& g) {
  return g.Dl + ((g.d0 > 0 || g.d0 + g.Dl < g.D) ? 2 : 0);
}

// Segment k of task z in the coordinates of its target (*target 0: this
// process's out, -1 the previous process's, 1 the next one's) and of this
// process's X; n = 0 where the task has nothing to copy. Task z < Dl:
// shard d0 + z, without the left halo of the first local shard when a
// process precedes and the right halo of the last when one follows (the
// neighbours push those). Task Dl: the previous shard's right halo (this
// process's first Hb rows) into the previous process; task Dl + 1: the
// next shard's left halo (this process's last Hb rows) into the next;
// each only where its side pushes (push_l, push_r).
__host__ __device__ inline Segment ring_task(const Ring& g, int64_t z, int k,
                                             int* target) {
  const bool first = g.d0 == 0, last = g.d0 + g.Dl == g.D;
  *target = 0;
  int64_t d = g.d0 + z, shift = g.d0;
  if (z >= g.Dl) {
    if (z == g.Dl && k == 3 && !first && g.push_l) {
      d = g.d0 - 1;
      shift = g.d0 - g.Dl;
      *target = -1;
    } else if (z == g.Dl + 1 && k == 2 && !last && g.push_r) {
      d = g.d0 + g.Dl;
      shift = g.d0 + g.Dl;
      *target = 1;
    } else {
      return {0, -1, 0};
    }
  } else if ((k == 2 && z == 0 && !first) ||
             (k == 3 && z == g.Dl - 1 && !last)) {
    return {0, -1, 0};
  }
  const Segment s = ring_segment(g, d, k);
  return {s.dst - shift * g.rows, s.src < 0 ? -1 : s.src - g.d0 * g.Lb, s.n};
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
// segment k of task z
template <int THREADS>
__device__ __forceinline__ void segment_copy(const void* x, void* out,
                                             const Peers& peers,
                                             const Ring& g, int shift,
                                             int64_t z, int k, int64_t chunk,
                                             int tid) {
  int target;
  const Segment s = ring_task(g, z, k, &target);
  const int64_t c0 = chunk * (THREADS * kCopyUnroll);
  const int64_t left = ((s.n * g.row_bytes) >> shift) - c0;
  if (left <= 0) return;
  const int n = (int)(left < THREADS * kCopyUnroll ? left
                                                   : THREADS * kCopyUnroll);
  void* base = target == 0 ? out : target < 0 ? peers.left : peers.right;
  char* dst = static_cast<char*>(base) + s.dst * g.row_bytes + (c0 << shift);
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

// Checks a unit of 1 << shift bytes against the pointers and every
// segment's offsets and length, and the geometry (a neighbour's pointer on
// exactly the sides that push); returns the chunks of the longest segment
// for THREADS-thread blocks, 0 if nothing is copied, -1 if the unit or the
// geometry does not fit or a segment's units pass 32 bits.
inline int64_t ring_chunks(const Ring& g, const void* x, const void* out,
                           const Peers& peers, int shift, int threads) {
  if (shift < 2 || shift > 4 || g.D < 1 || g.Dl < 1 || g.d0 < 0 ||
      g.d0 + g.Dl > g.D || g.d0 % g.Dl || g.D % g.Dl ||
      ring_tasks(g) > 65535)
    return -1;
  if ((g.d0 > 0 && g.push_l) != (peers.left != nullptr) ||
      (g.d0 + g.Dl < g.D && g.push_r) != (peers.right != nullptr))
    return -1;
  const int64_t unit = (int64_t)1 << shift;
  if (((uintptr_t)x | (uintptr_t)out | (uintptr_t)peers.left |
       (uintptr_t)peers.right) % unit)
    return -1;
  int64_t longest = 0;
  for (int64_t z = 0; z < ring_tasks(g); ++z) {
    for (int k = 0; k < kSegments; ++k) {
      int target;
      const Segment s = ring_task(g, z, k, &target);
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

// grid (chunk, segment, task); without own rows segment 0 is empty and
// the grid's y starts at segment 1
__global__ void __launch_bounds__(kCopyThreads)
ring_shift_kernel(const void* x, void* out, const Peers peers, const Ring g,
                  int shift) {
  segment_copy<kCopyThreads>(x, out, peers, g, shift, blockIdx.z,
                             blockIdx.y + (g.own ? 0 : 1), blockIdx.x,
                             threadIdx.x);
}

// blocks of kThreads: the first n_copy copy the halo section (chunks of
// segments 1-4 of each task, as ring_shift without own rows, pushes
// included), the rest are K2's blocks of the stacked interior layout, one
// per tile
template <bool FUSED>
__global__ void __launch_bounds__(kThreads)
union_overlap_kernel(const Params p, float* halo, const Peers peers,
                     const Ring g, int shift, int64_t n_chunks,
                     int64_t n_copy) {
  const int64_t bx = blockIdx.x;
  if (bx < n_copy) {
    const int64_t t = bx / n_chunks;
    segment_copy<kThreads>(p.x, halo, peers, g, shift, t / (kSegments - 1),
                           1 + (int)(t % (kSegments - 1)), bx % n_chunks,
                           threadIdx.x);
    return;
  }
  union_tile<false, FUSED>(p, bx - n_copy);
}

template <bool FUSED>
int overlap(const Params& p, float* halo, const Peers& peers,
            int64_t n_tiles, const Ring& g, int shift, cudaStream_t stream) {
  auto kernel = union_overlap_kernel<FUSED>;
  size_t smem = 0;
  const cudaError_t e =
      union_smem(reinterpret_cast<const void*>(kernel), p, &smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t n_chunks = ring_chunks(g, p.x, halo, peers, shift, kThreads);
  if (n_chunks < 0) return (int)cudaErrorInvalidValue;
  const int64_t n_copy = n_chunks * (kSegments - 1) * ring_tasks(g);
  const int64_t blocks = n_copy + n_tiles;
  if (blocks == 0) return 0;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      p, halo, peers, g, shift, n_chunks, n_copy);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. Shapes are checked by the Python wrappers
// (kernels/halo.py).

// x: this process's (Dl*Lb, m) rows, shards d0 .. d0 + Dl - 1 of D; out its
// (Dl*rows, m) output; left/right the previous and next process's outputs
// (nullptr where none, and for one process); push_left / push_right: 1
// where the launch pushes into left / right (0 where a neighbour is on
// another host, or there is none). unit: the copy unit in bytes
// (16, 8 or 4), kernels/halo.py's choice; one that does not divide the
// pointers and every segment's offsets and length, or a geometry the
// pointers do not match, returns cudaErrorInvalidValue, with no launch
extern "C" int ring_shift(const void* x, void* out, void* left, void* right,
                          int64_t D, int64_t d0, int64_t Dl, int64_t Lb,
                          int64_t Hb, int64_t row_bytes, int64_t pad_rows,
                          int64_t own, int64_t push_left, int64_t push_right,
                          int64_t unit, void* stream) {
  const Ring g{D,  d0, Dl, Lb, Hb, pad_rows,
               (own ? Lb : 0) + 2 * Hb + pad_rows, row_bytes, own != 0,
               push_left != 0, push_right != 0};
  const Peers peers{left, right};
  const int shift = unit == 16 ? 4 : unit == 8 ? 3 : unit == 4 ? 2 : -1;
  const int64_t n_chunks =
      ring_chunks(g, x, out, peers, shift, kCopyThreads);
  if (n_chunks < 0) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  const dim3 grid((unsigned)n_chunks, own ? kSegments : kSegments - 1,
                  (unsigned)ring_tasks(g));
  ring_shift_kernel<<<grid, kCopyThreads, 0, (cudaStream_t)stream>>>(
      x, out, peers, g, shift);
  return (int)cudaGetLastError();
}

// two == 0: one stream (vals_a) into ya; else both (vals_a into ya, vals_b
// into yb), one X gather. A value pointer may be null: the stacked layout
// of a process holding only padding rows has no live sub-block. The value
// pointers and tables are those of the bellunion_matmat_* entry points
// (csrc/bellunion_spmm.cu); halo, left, right, D, d0, Dl, push_left and
// push_right as ring_shift's out, left, right, geometry (without own rows
// or pad) and flags.
extern "C" int union_overlap_f32(
    const void* vals_a, const void* vals_b, const void* sb_ptr,
    const void* sb_run, const void* xr_ptr, const void* xr_run,
    const void* ucols, const void* tile_ptr, const void* tile_end,
    const void* x, void* ya, void* yb, void* halo, void* left, void* right,
    int64_t two, int64_t n_tiles, int64_t m, int64_t cl, int64_t b,
    int64_t x_max, int64_t D, int64_t d0, int64_t Dl, int64_t Lb,
    int64_t Hb, int64_t push_left, int64_t push_right, int64_t unit,
    void* stream) {
  const Tables tb{sb_ptr, sb_run, xr_ptr, xr_run, ucols, tile_ptr, tile_end};
  const Params p = make_params(vals_a, nullptr, vals_b, nullptr, tb, x, ya,
                               yb, m, cl, b, x_max);
  const Ring g{D, d0, Dl, Lb, Hb, 0, 2 * Hb, m * (int64_t)sizeof(float),
               false, push_left != 0, push_right != 0};
  const Peers peers{left, right};
  const int shift = unit == 16 ? 4 : unit == 8 ? 3 : unit == 4 ? 2 : -1;
  float* h = static_cast<float*>(halo);
  cudaStream_t s = (cudaStream_t)stream;
  if (two == 0) return overlap<false>(p, h, peers, n_tiles, g, shift, s);
  return overlap<true>(p, h, peers, n_tiles, g, shift, s);
}

// IPC buffers of the exchange across processes: a buffer of this
// process's own cudaMalloc on `device`, zeroed, outside PyTorch's caching
// allocator (a handle to one of its blocks would name the whole segment),
// its handle written to handle[0..64); a neighbour's handle opened into
// this process; closed and freed when the pencil is released. Each
// returns the CUDA error, 0 on success.
static_assert(sizeof(cudaIpcMemHandle_t) == 64, "IPC handle size");

extern "C" int ipc_alloc(int64_t bytes, int64_t device, void** ptr,
                         void* handle) {
  cudaError_t e = cudaSetDevice((int)device);
  if (e == cudaSuccess) e = cudaMalloc(ptr, (size_t)bytes);
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, (size_t)bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(&h, *ptr);
  if (e == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return (int)e;
}

extern "C" int ipc_open(const void* handle, int64_t device, void** ptr) {
  cudaError_t e = cudaSetDevice((int)device);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  if (e == cudaSuccess)
    e = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  return (int)e;
}

extern "C" int ipc_close(void* ptr, int64_t device) {
  cudaError_t e = cudaSetDevice((int)device);
  if (e == cudaSuccess) e = cudaIpcCloseMemHandle(ptr);
  return (int)e;
}

extern "C" int ipc_free(void* ptr, int64_t device) {
  cudaError_t e = cudaSetDevice((int)device);
  if (e == cudaSuccess) e = cudaFree(ptr);
  return (int)e;
}
