// BELLPairs per-tile cost probes for NVIDIA Hopper (sm_90a): the H100
// counterparts of the TPU kernels inside main() of
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
//   grid_cat      e4_cat424 (:143-170, :162): per block row r and chunk c,
//                 the row's 8 slices are staged in shared memory (the TPU's
//                 concatenated panel), then summed; the tile's output is the
//                 first 128 rows of the (16 x 16, 8) stack, i.e. rows r < 8.
//                 Rows 8-15 are staged as the reference concatenates them
//                 (the slice count stays e3's); their sums are not needed.
//   grid_cat_mm   e5_cat424_mm (:172-199, :189): Y_r = sum over the live
//                 slots of the (8, 16) value panel @ the (16, 8) X slice,
//                 true f32 FMAs.
// e3_acc424 (:124-141, :133), the tile's 16 x 24 slices summed, is
// gather_sum<16, 8> of csrc/gather_probes.cu (g1's function on the first
// LIVE * Cp slots), launched by kernels/grid_probes.py.
//
// Bounds (the function's bytes over 3.35 TB/s): e0-e4 write 1.2 MB of Y and
// read 4 KB (e0-e2) or X once (1.2 MB, e3/e4); their 58.6 MB of gathered
// slices at T 298 come from L2, whose read rate bounds them first. e5 must
// read the 24 live panels of every block row, 58.6 MB of the 117 MB value
// stream, for 0.23 GFLOP (0.0035 ms at the f32 peak): bytes.
//
// e4 and e5 share a walk (the host plan: kernels/grid_probes.py row_plan).
// A persistent grid, one block an SM, cuts the nbr block rows into
// near-equal ranges, block b rows [b nbr / grid, (b + 1) nbr / grid); warp
// w of W takes the range's rows w, w + W, ... (e4 16 warps, e5 8). A warp
// walks its rows' chunks (8 slots each) in order through a ring of 2 chunk
// stages of its own in shared memory, one chunk ahead of the one it sums.
// A row's
// columns come in one coalesced warp load (two where it has more than 32
// slots) when the walk's copies reach the row before, and each chunk's
// eight are broadcast with __shfl_sync: no copy waits on a column load
// inside the walk. Each output row is written once by one warp, in a fixed
// order of additions, with no atomics: runs repeat bit for bit.
// - e4: lane l copies float4 l of each slice by a 16-byte cp.async (L2 to
//   shared memory, no registers), so it sums only what it copied itself:
//   cp.async.wait_group, no barrier. A stage is 8 slices, 4 KB.
// - e5: a stage is the chunk's (8 rows x 128 f32) value box, eight 512-byte
//   runs 16 Q floats apart, and its 8 X slices, 8 KB. The value runs come
//   by one-dimensional bulk copies (cp.async.bulk, the TMA engine; lanes
//   0-7 a run each, evict-first) and the slices by 16-byte cp.async (a warp
//   instruction a slice), both completing on the stage's mbarrier. Lane
//   (k = lane / 2, h = lane % 2) reads slot q's
//   X row k, columns 4 h .. 4 h + 3 (the slice's float4 `lane`: a warp
//   read of 512 distinct bytes) and the eight values V[i, 16 q + k] (16
//   distinct words a warp read), and keeps the (8, 4) partial sum over its
//   k in registers: 32 FMAs a slot. At a row's end a reduce-scatter over
//   the 16 k-lanes (30 shuffles) leaves each lane two outputs, written as
//   one float2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 16;                  // block rows per tile
constexpr int kB = 8;                   // rows per block row
constexpr int kCp = 8;                  // pair slots per chunk
constexpr int kTileF4 = kR * kB * 8 / 4;  // float4 of a (128, 8) tile: 256
constexpr int kSlice = 2 * kB * 8;      // floats of a (16, 8) slice: 128
constexpr int kChunk = kCp * kSlice;    // floats of a chunk's 8 slices: 1 K
constexpr int kMaxSlots = 64;           // a row's columns: two per lane
constexpr int kCatWarps = 16;           // warps of an e4 block
constexpr int kMmWarps = 8;             // warps of an e5 block
constexpr int kStages = 2;              // chunk stages of a warp's ring

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

// ---------------------------------------------------------------------------
// e4 / e5: the block-row walk
// ---------------------------------------------------------------------------

struct RowParams {
  const int32_t* cols;  // (nbr, Q)
  const float* vals;    // (8 nbr, 16 Q), e5 only
  const float* x;       // (rows, 8)
  float* y;             // (128 T, 8) = (8 nbr, 8)
  int64_t nbr;
  int64_t Q;
  int live;  // chunks of 8 slots a row reads
};

// a row's first `slots` columns: lane l holds slots l and 32 + l
struct RowCols {
  int a, b;
};

__device__ __forceinline__ RowCols load_cols(const RowParams& p, int64_t r,
                                             int lane) {
  const int32_t* c = p.cols + r * p.Q;
  const int slots = kCp * p.live;
  RowCols rc;
  rc.a = lane < slots ? __ldg(c + lane) : 0;
  rc.b = 32 + lane < slots ? __ldg(c + 32 + lane) : 0;
  return rc;
}

// slot 8 chunk + q's column, from the lane that holds it (every lane calls
// with the same chunk; a chunk lies wholly in a or in b)
__device__ __forceinline__ int chunk_col(const RowCols& rc, int chunk,
                                         int q) {
  return __shfl_sync(0xffffffffu, chunk < 4 ? rc.a : rc.b,
                     (kCp * chunk + q) & 31);
}

// The warp's share of the block's row range and its walk: item n is chunk
// n % live of the warp's row n / live.
struct Walk {
  int64_t first;  // the warp's first row
  int W;          // the block's warps: the stride between its rows
  int rows;       // the warp's rows
  int live;
  int items;

  __device__ Walk(const RowParams& p, int warp) {
    W = blockDim.x >> 5;
    const int64_t r0 = (int64_t)blockIdx.x * p.nbr / gridDim.x;
    const int64_t r1 = ((int64_t)blockIdx.x + 1) * p.nbr / gridDim.x;
    first = r0 + warp;
    rows = first < r1 ? (int)((r1 - 1 - first) / W + 1) : 0;
    live = p.live;
    items = rows * live;
  }
  __device__ int64_t row(int k) const { return first + (int64_t)k * W; }
};

// The walk's column registers: the row whose chunks are being copied, and
// the one after it, loaded when the copies reach the first
struct ColRing {
  RowCols cur, nxt;

  __device__ void start(const RowParams& p, const Walk& w, int lane) {
    cur = RowCols{0, 0};
    nxt = w.rows > 0 ? load_cols(p, w.row(0), lane) : RowCols{0, 0};
  }
  // before the copies of item n (n in increasing order)
  __device__ void advance(const RowParams& p, const Walk& w, int n,
                          int lane) {
    const int k = n / w.live;
    if (n - k * w.live != 0) return;
    cur = nxt;
    if (k + 1 < w.rows) nxt = load_cols(p, w.row(k + 1), lane);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// e4: warp-private ring of NS chunk panels [NS][8 slices][32 float4]
__global__ void __launch_bounds__(kCatWarps * 32)
grid_cat_kernel(const RowParams p) {
  constexpr int NS = kStages;
  extern __shared__ __align__(128) float4 panels[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Walk w(p, warp);
  float4* ring = panels + (size_t)warp * NS * kCp * 32;
  const float4* x4 = reinterpret_cast<const float4*>(p.x);
  ColRing cr;
  cr.start(p, w, lane);

  auto copy_item = [&](int n) {
    cr.advance(p, w, n, lane);
    const int c = n % w.live;
    const uint32_t dst = smem_u32(ring + (n % NS) * kCp * 32 + lane);
#pragma unroll
    for (int q = 0; q < kCp; ++q) {
      const int64_t col = chunk_col(cr.cur, c, q);
      cp_async16(dst + q * 32 * 16, x4 + col * (kB * 8 / 4) + lane);
    }
  };

#pragma unroll
  for (int n = 0; n < NS - 1; ++n) {
    if (n < w.items) copy_item(n);
    cp_async_commit();  // empty groups keep the count
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int n = 0; n < w.items; ++n) {
    // the stage of item n - 1, summed by this lane alone, takes n + NS - 1
    if (n + NS - 1 < w.items) copy_item(n + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // item n's copies have landed
    const int k = n / w.live;
    const int c = n - k * w.live;
    const int64_t r = w.row(k);
    const int rr = (int)(r % kR);
    if (rr < kR / 2) {  // rows 8-15 are staged, their sums not needed
      const float4* s = ring + (n % NS) * kCp * 32 + lane;
#pragma unroll
      for (int q = 0; q < kCp; ++q) acc = add4(acc, s[q * 32]);
      if (c == w.live - 1) {
        // the tile's rows 16 rr .. 16 rr + 15: the (16, 8) sum
        reinterpret_cast<float4*>(p.y)[((r / kR) * kR * kB + rr * 2 * kB) *
                                           2 + lane] = acc;
        acc = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// a one-dimensional bulk copy (TMA engine) of `bytes` (a multiple of 16)
// from global to shared memory, completing on the barrier, under an L2
// cache policy
__device__ __forceinline__ void bulk_copy_hint(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar,
                                               uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// one step of e5's reduce-scatter: the lanes with bit H keep the upper H
// of their first 2 H values, the others the lower H, each adding its
// partner's (lane ^ H) copy of the half it keeps, into acc[0 .. H)
template <int H>
__device__ __forceinline__ void reduce_half(float (&acc)[32], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int v = 0; v < H; ++v) {
    const float send = up ? acc[v] : acc[v + H];
    const float keep = up ? acc[v + H] : acc[v];
    acc[v] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

constexpr int kMmStage = 2 * kChunk;  // floats: the value box, the slices

// cp.async's completion as one arrival on the barrier (counted in its
// init: noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// e5: warp-private ring of NS stages [value box 8 x 128][8 slices], then
// the warps' barriers
__global__ void __launch_bounds__(kMmWarps * 32, 1)
grid_cat_mm_kernel(const RowParams p) {
  constexpr int NS = kStages;
  extern __shared__ __align__(128) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Walk w(p, warp);
  float* ring = smem + (size_t)warp * NS * kMmStage;
  const uint32_t bars =
      smem_u32(smem + (size_t)w.W * NS * kMmStage) + warp * NS * 8;
  if (lane == 0) {
    // arrivals a phase: the expect_tx, and each lane's cp.async
    for (int s = 0; s < NS; ++s) mbar_init(bars + 8 * s, 33);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  uint64_t policy;  // the values are read once
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  const int64_t vrow = 2 * kB * p.Q;  // floats of a value row
  constexpr int kRun = kCp * 2 * kB;   // floats of a value row's chunk run
  ColRing cr;
  cr.start(p, w, lane);

  auto copy_item = [&](int n) {
    cr.advance(p, w, n, lane);
    const int k = n / w.live;
    const int c = n - k * w.live;
    const int s = n % NS;
    const uint32_t bar = bars + 8 * s;
    const uint32_t st = smem_u32(ring + (size_t)s * kMmStage);
    const float* vsrc = p.vals + w.row(k) * kB * vrow + c * kRun;
    __syncwarp();  // every lane is done with the stage's last item
    if (lane == 0) mbar_expect_tx(bar, kChunk * 4);
    __syncwarp();
    if (lane < kB)
      bulk_copy_hint(st + lane * kRun * 4, vsrc + lane * vrow, kRun * 4, bar,
                     policy);
#pragma unroll
    for (int q = 0; q < kCp; ++q) {
      const int64_t col = chunk_col(cr.cur, c, q);
      cp_async16(st + (kChunk + q * kSlice + 4 * lane) * 4,
                 p.x + col * kB * 8 + 4 * lane);
    }
    cp_async_arrive(bar);
  };

  for (int n = 0; n < NS - 1 && n < w.items; ++n) copy_item(n);
  const int kk = lane >> 1;  // the lane's k of each slot
  float acc[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) acc[v] = 0.f;
  for (int n = 0; n < w.items; ++n) {
    if (n + NS - 1 < w.items) copy_item(n + NS - 1);
    const int s = n % NS;
    mbar_wait(bars + 8 * s, (uint32_t)((n / NS) & 1));
    const float* V = ring + (size_t)s * kMmStage;
    const float* Xs = V + kChunk;
#pragma unroll
    for (int q = 0; q < kCp; ++q) {
      const float4 xv = *reinterpret_cast<const float4*>(Xs + q * kSlice +
                                                         4 * lane);
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        const float v = V[i * kCp * 2 * kB + q * 2 * kB + kk];
        acc[4 * i + 0] = fmaf(v, xv.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(v, xv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(v, xv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(v, xv.w, acc[4 * i + 3]);
      }
    }
    const int k = n / w.live;
    if (n - k * w.live != w.live - 1) continue;
    // reduce-scatter over the k-lanes (lane bits 1-4): lane ends with
    // values 2 (lane >> 1) and + 1, i.e. row lane >> 2, columns 4 (lane &
    // 1) + 2 ((lane >> 1) & 1) and + 1
    reduce_half<16>(acc, lane);
    reduce_half<8>(acc, lane);
    reduce_half<4>(acc, lane);
    reduce_half<2>(acc, lane);
    const int64_t r = w.row(k);
    const int j = 4 * (lane & 1) + 2 * ((lane >> 1) & 1);
    *reinterpret_cast<float2*>(p.y + (r * kB + (lane >> 2)) * 8 + j) =
        make_float2(acc[0], acc[1]);
#pragma unroll
    for (int v = 0; v < 32; ++v) acc[v] = 0.f;
  }
}

// kind 0: e4 (grid_cat), 1: e5 (grid_cat_mm)
const void* row_kernel(int64_t kind) {
  switch (kind) {
    case 0: return reinterpret_cast<const void*>(grid_cat_kernel);
    case 1: return reinterpret_cast<const void*>(grid_cat_mm_kernel);
    default: return nullptr;
  }
}

int row_warps(int64_t kind) { return kind == 0 ? kCatWarps : kMmWarps; }

// a launch's shared memory: the warps' rings (and e5's barriers)
size_t row_smem(int64_t kind) {
  return kind == 0 ? (size_t)kCatWarps * kStages * kChunk * 4
                   : (size_t)kMmWarps * kStages * (kMmStage * 4 + 8);
}

int launch_rows(int64_t kind, const RowParams& p, int64_t grid,
                cudaStream_t stream) {
  const void* k = row_kernel(kind);
  if (!k || grid < 1 || grid > p.nbr || p.live < 1 ||
      kCp * p.live > kMaxSlots || kCp * p.live > p.Q)
    return 1;
  const size_t smem = row_smem(kind);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {const_cast<RowParams*>(&p)};
  e = cudaLaunchKernel(k, dim3((unsigned)grid),
                       dim3((unsigned)(32 * row_warps(kind))), args, smem,
                       stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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

// e4 and e5 as kernels/grid_probes.py row_plan launches them: grid blocks
// (<= nbr) of 16 (e4) or 8 (e5) warps, each warp a ring of 2 stages.
// Return 1 for a launch the kernels do not take (live outside [1, 8] or
// past Q, a grid outside [1, nbr]).
extern "C" int grid_cat_f32(const void* cols, const void* x, void* y,
                            int64_t nbr, int64_t Q, int64_t live,
                            int64_t grid, void* stream) {
  RowParams p{static_cast<const int32_t*>(cols), nullptr,
              static_cast<const float*>(x), static_cast<float*>(y), nbr, Q,
              (int)live};
  return launch_rows(0, p, grid, (cudaStream_t)stream);
}

extern "C" int grid_cat_mm_f32(const void* cols, const void* vals,
                               const void* x, void* y, int64_t nbr, int64_t Q,
                               int64_t live, int64_t grid, void* stream) {
  RowParams p{static_cast<const int32_t*>(cols),
              static_cast<const float*>(vals), static_cast<const float*>(x),
              static_cast<float*>(y), nbr, Q, (int)live};
  return launch_rows(1, p, grid, (cudaStream_t)stream);
}

// The e4 (kind 0) or e5 (kind 1) launch on the current card: out =
// {registers a thread, local memory bytes a thread, resident blocks per SM
// (the occupancy API's count at the launch's shared memory), SMs, dynamic
// shared memory bytes a block, warps a block}
extern "C" int grid_rows_shape(int64_t kind, void* out) {
  const void* k = row_kernel(kind);
  if (!k) return 1;
  const size_t smem = row_smem(kind);
  cudaFuncAttributes a;
  cudaError_t c = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (c == cudaSuccess) c = cudaFuncGetAttributes(&a, k);
  int occ = 0, dev = 0, sms = 0;
  if (c == cudaSuccess)
    c = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, k, 32 * row_warps(kind), smem);
  if (c == cudaSuccess) c = cudaGetDevice(&dev);
  if (c == cudaSuccess)
    c = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (c != cudaSuccess) return (int)c;
  int64_t* o = static_cast<int64_t*>(out);
  o[0] = a.numRegs;
  o[1] = (int64_t)a.localSizeBytes;
  o[2] = occ;
  o[3] = sms;
  o[4] = (int64_t)smem;
  o[5] = row_warps(kind);
  return 0;
}
