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
//   gather_sum<16, 8, XT> g4_lane_ds (:218-239, :228): g1's slices taken
//                        from X^T (m, n + 8): a slice is m rows of 16
//                        floats (64 B each), (n + 8) * 4 B apart; the (m,
//                        16) sum is tiled S times along the row to (m,
//                        16 S). The one change from g1: the layout.
//                        All three on one body (below).
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
// from L2 (X is 1.2 MB), so the L2 read rate bounds them before device
// memory does. g2/g3 read 4.9 MB of indices and write 76 KB / 4.9 MB; g3w
// reads 4.9 MB of kept indices, the source's 32-byte sectors its gathers
// touch (24.7 MB at T 298) and writes 4.9 MB.
//
// gather_sum's design (the host plan: kernels/gather_probes.py
// gather_plan):
// - Persistent and even: the T R slots' list in (tile, block row, slot)
//   order is cut into `grid` ranges of near-equal length (multiples of 4
//   slots), one per block, two 8-warp blocks an SM (grid = 2 x the SM
//   count). One block per tile left the longest SM 1.33x the mean at T 298.
//   A block walks its range tile piece by tile piece: its teams (F4 float4s
//   of lanes, F4 the float4s of a slice) take groups of 4 slots in turn,
//   each group's indices by one int4 load where the slots lie 16-byte
//   aligned in cols (S and the slots read multiples of 4), else by 4; a
//   lane keeps 8 16-byte slice loads in flight (of 8 slices at m 8, of 1
//   at m 128), every slice read through L1 (which serves a tile's
//   repeated slices) from L2, sums in registers in slot order, then one
//   shared-memory reduction over the teams in team order. (3 or 4 blocks an SM were no faster: g0 is held
//   by L2's rate for scattered 256-byte reads.)
// - A tile cut by a range boundary: each block writes its piece's sums to
//   a scratch row of its own (2 a block: its first and last tile) and
//   counts the piece done on the tile's counter; the last to arrive adds
//   the pieces in range order, writes the tile and zeroes the counter for
//   the next launch on the stream. Every sum is taken in a fixed order:
//   runs repeat bit for bit.
// - Staging each tile's union of slices in shared memory once (a bitmap
//   and prefix popcount per piece, then every slot read from the panel)
//   ran slower than this on v4_gather's RCM layout, where a tile's 1,024
//   slots touch 124 distinct slices on average: L1 already serves the
//   repeats (PERF.md 7).
// Every output is written once by one thread: runs repeat bit for bit.
//
// g2/g3 (taa0, taa1): sources staged with 16-byte loads, indices read with
// 16-byte loads, coalesced, one block per tile.
//
// l2_read_f32 ports no TPU kernel: it re-reads one buffer that lies in L2
// from every block, the rate the slices' reads cannot beat
// (bench/timing.py l2_read_rate).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 16;              // block rows per tile
constexpr int kB = 8;               // rows per block row
constexpr int kWarps = 16;          // warps of a taa0 / taa1 block
constexpr int kThreads = kWarps * 32;
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ---------------------------------------------------------------------------
// gather_sum
// ---------------------------------------------------------------------------

constexpr int kSumWarps = 8;  // warps of a gather_sum block
constexpr int kSumThreads = kSumWarps * 32;
constexpr int kSumBlocks = 2;  // resident blocks an SM: the plan's grid
constexpr int kLoadsInFlight = 8;  // 16-byte slice loads of a lane

struct SumParams {
  const int32_t* cols;  // (16 T, S)
  const float4* x;      // X (rows, M) or X^T (M, x_stride)
  float4* y;
  float4* scratch;  // [2 grid][F4]: the pieces of cut tiles
  int* counters;    // [T]: the pieces of a cut tile done; 0 between launches
  int64_t S;        // slots of a cols row
  int slots;        // of them read, from the first (S or S / 2)
  int idx4;         // the 4 slots of a group are one aligned int4 in cols
  int64_t x_stride4;  // XT: float4s between X^T's rows
  int64_t groups;     // T R slots / 4
  int grid;           // blocks: <= groups, so every range holds a group
};

// the first slot of block b's range (a multiple of 4)
__device__ __forceinline__ int64_t range_start(int64_t b, const SumParams& p) {
  return 4 * (b * p.groups / p.grid);
}

// the block whose range holds slot e
__device__ __forceinline__ int64_t block_of(int64_t e, const SumParams& p) {
  return ((e / 4 + 1) * p.grid + p.groups - 1) / p.groups - 1;
}

// slot e's place in cols: row e / slots, column e % slots
__device__ __forceinline__ int64_t slot_pos(int64_t e, const SumParams& p) {
  const int64_t r = e / p.slots;
  return r * p.S + (e - r * p.slots);
}

// the block columns of group g's 4 slots
__device__ __forceinline__ int4 group_cols(int64_t g, const SumParams& p) {
  if (p.idx4)
    return __ldg(reinterpret_cast<const int4*>(p.cols + slot_pos(4 * g, p)));
  return make_int4(__ldg(p.cols + slot_pos(4 * g, p)),
                   __ldg(p.cols + slot_pos(4 * g + 1, p)),
                   __ldg(p.cols + slot_pos(4 * g + 2, p)),
                   __ldg(p.cols + slot_pos(4 * g + 3, p)));
}

__device__ __forceinline__ int pick(const int4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// A slice is F4 float4s: ROWS rows of M floats from X row 8 c, or for XT
// the M rows of 16 floats of X^T from column 8 c
template <int ROWS, int M, bool XT>
struct Slice {
  static constexpr int F4 = XT ? M * 4 : ROWS * M / 4;

  __device__ static const float4* src(const SumParams& p, int64_t c, int f) {
    if (XT) return p.x + (f >> 2) * p.x_stride4 + 2 * c + (f & 3);
    return p.x + c * kB * (M / 4) + f;
  }
};

// tile t's output from its slice sum sums[]: (ROWS, M) tiled down the
// tile's 128 rows, or for XT (M, 16) tiled S times along each of its M rows
template <int ROWS, int M, bool XT, int NT>
__device__ __forceinline__ void write_tile(const SumParams& p, int64_t t,
                                           const float4* sums) {
  if (XT) {
    const int64_t row4 = 4 * p.S;  // float4s of an output row (16 S floats)
    for (int64_t e = threadIdx.x; e < M * row4; e += NT)
      p.y[t * M * row4 + e] = sums[(e / row4) * 4 + (e & 3)];
  } else {
    constexpr int W4 = M / 4;
    for (int e = threadIdx.x; e < kR * kB * W4; e += NT) {
      const int i = e / W4, q = e - i * W4;
      p.y[(t * kR * kB + i) * W4 + q] = sums[(i % ROWS) * W4 + q];
    }
  }
}

template <int ROWS, int M, bool XT>
__global__ void __launch_bounds__(kSumThreads, kSumBlocks)
gather_sum_kernel(const SumParams p) {
  using SL = Slice<ROWS, M, XT>;
  constexpr int NW = kSumWarps;
  constexpr int NT = kSumThreads;
  constexpr int F4 = SL::F4;
  constexpr int SPW = F4 <= 32 ? 32 / F4 : 1;   // teams a warp
  constexpr int PER = F4 <= 32 ? 1 : F4 / 32;   // float4s a lane a slice
  constexpr int NTEAM = NW * SPW;
  // groups a team's step, slices a batch of loads: kLoadsInFlight loads
  // of a lane in flight
  constexpr int U = kLoadsInFlight / (4 * PER) > 1
                        ? kLoadsInFlight / (4 * PER) : 1;
  constexpr int SB = 4 * PER <= kLoadsInFlight ? 4 : kLoadsInFlight / PER;
  static_assert(F4 <= 32 ? 32 % F4 == 0 : F4 % 32 == 0, "slice shape");
  __shared__ __align__(16) float4 part[NTEAM * F4];  // the teams' sums
  __shared__ int last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int team = warp * SPW + (F4 <= 32 ? lane / F4 : 0);
  const int f0 = F4 <= 32 ? lane % F4 : lane;
  const int64_t b = blockIdx.x;
  const int64_t e0 = range_start(b, p), e1 = range_start(b + 1, p);
  const int n = kR * p.slots;  // slots of a tile
  const int64_t t_first = e0 / n;

  for (int64_t t = t_first; t * n < e1; ++t) {
    const int64_t a = e0 > t * n ? e0 : t * n;
    const int64_t c = e1 < (t + 1) * n ? e1 : (t + 1) * n;
    const bool whole = a == t * n && c == (t + 1) * n;
    float4 acc[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int64_t gc = c / 4;
    for (int64_t g = a / 4 + team; g < gc; g += NTEAM * U) {
      int4 cg[U];
      bool on[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t gg = g + u * NTEAM;
        on[u] = gg < gc;
        cg[u] = on[u] ? group_cols(gg, p) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k0 = 0; k0 < 4; k0 += SB) {
          float4 v[SB][PER];
#pragma unroll
          for (int k = 0; k < SB; ++k)
#pragma unroll
            for (int q = 0; q < PER; ++q)
              if (on[u])
                v[k][q] = __ldg(SL::src(p, pick(cg[u], k0 + k), f0 + 32 * q));
          if (on[u]) {
#pragma unroll
            for (int k = 0; k < SB; ++k)
#pragma unroll
              for (int q = 0; q < PER; ++q) acc[q] = add4(acc[q], v[k][q]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) part[team * F4 + f0 + 32 * q] = acc[q];
    __syncthreads();
    // the teams' sums in team order, into part[0 .. F4)
    for (int f = tid; f < F4; f += NT) {
      float4 sum = part[f];
      for (int k = 1; k < NTEAM; ++k) sum = add4(sum, part[k * F4 + f]);
      part[f] = sum;
    }
    __syncthreads();
    if (whole) {
      write_tile<ROWS, M, XT, NT>(p, t, part);
      __syncthreads();  // part takes the next tile
      continue;
    }
    // the piece goes to scratch; the last of the tile's pieces to arrive
    // adds them in range order and writes the tile
    const int sel = t == t_first ? 0 : 1;  // the block's first or last tile
    float4* row = p.scratch + (2 * b + sel) * F4;
    for (int f = tid; f < F4; f += NT) __stcg(row + f, part[f]);
    __threadfence();
    __syncthreads();
    const int64_t b_lo = block_of(t * n, p);
    const int64_t b_hi = block_of((t + 1) * n - 1, p);
    if (tid == 0)
      last = atomicAdd(p.counters + t, 1) == (int)(b_hi - b_lo);
    __syncthreads();
    if (last) {
      __threadfence();
      for (int f = tid; f < F4; f += NT) {
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int64_t bb = b_lo; bb <= b_hi; ++bb) {
          const int s = t == range_start(bb, p) / n ? 0 : 1;
          sum = add4(sum, __ldcg(p.scratch + (2 * bb + s) * F4 + f));
        }
        part[f] = sum;
      }
      if (tid == 0) p.counters[t] = 0;
      __syncthreads();
      write_tile<ROWS, M, XT, NT>(p, t, part);
    }
    __syncthreads();  // part takes the next tile
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
int launch_sum(const SumParams& p, cudaStream_t stream) {
  gather_sum_kernel<ROWS, M, XT>
      <<<(unsigned)p.grid, kSumThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// the instance of (rows, m, transposed); kernel null where none is built
struct SumKernel {
  const void* kernel;
  int (*launch)(const SumParams&, cudaStream_t);
};

template <int ROWS, int M, bool XT>
SumKernel sum_kernel() {
  return {reinterpret_cast<const void*>(gather_sum_kernel<ROWS, M, XT>),
          launch_sum<ROWS, M, XT>};
}

SumKernel find_sum(int64_t rows, int64_t m, int64_t transposed) {
  if (rows == 8 && !transposed) {
    if (m == 8) return sum_kernel<8, 8, false>();
    if (m == 32) return sum_kernel<8, 32, false>();
    if (m == 64) return sum_kernel<8, 64, false>();
    if (m == 128) return sum_kernel<8, 128, false>();
  }
  if (rows == 16 && m == 8)
    return transposed ? sum_kernel<16, 8, true>() : sum_kernel<16, 8, false>();
  return SumKernel{nullptr, nullptr};
}

// Every block reads the whole of x (n4 float4s, L2-resident once read)
// through L2 and writes one sum: the L2 read rate's probe. Block b starts
// at float4 b n4 / blocks and wraps around, so that the blocks of one SM
// never ask for the same line at once (L1 would merge those requests)
__global__ void __launch_bounds__(256)
l2_read_kernel(const float4* __restrict__ x, int64_t n4,
               float* __restrict__ out) {
  const int64_t start = (int64_t)blockIdx.x * n4 / gridDim.x;
  float s = 0.f;
  for (int64_t i = threadIdx.x; i < n4; i += 4 * 256) {
    float4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int64_t j = start + i + k * 256;
      j = j < n4 ? j : j - n4;
      v[k] = i + k * 256 < n4 ? __ldcg(x + j)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) s += v[k].x + v[k].y + v[k].z + v[k].w;
  }
  for (int o = 16; o; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(out + blockIdx.x, s);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. Shapes, types, alignment and index ranges
// are checked by the Python wrappers (maxwell_tpu_torch/kernels/
// gather_probes.py, spmm_probes.py).

// gather_sum_f32: rows 8: m in {8, 32, 64, 128} (g0, v4); rows 16: m 8, X
// (transposed = 0, g1) or X^T with row stride x_stride floats (transposed
// = 1, g4). The launch from kernels/gather_probes.py gather_plan: grid
// blocks (<= T R slots / 4). scratch holds 2 grid slices, counters T ints
// (zero, and left zero; one buffer per stream: launches on one stream run
// in turn). Returns 1 for a launch the kernel does not take (no such
// instance, grid outside [1, groups]), else cudaGetLastError() after it.
extern "C" int gather_sum_f32(const void* cols, const void* x, void* y,
                              void* scratch, void* counters, int64_t T,
                              int64_t S, int64_t slots, int64_t rows,
                              int64_t m, int64_t transposed, int64_t x_stride,
                              int64_t grid, void* stream) {
  SumParams p;
  p.cols = static_cast<const int32_t*>(cols);
  p.x = static_cast<const float4*>(x);
  p.y = static_cast<float4*>(y);
  p.scratch = static_cast<float4*>(scratch);
  p.counters = static_cast<int*>(counters);
  p.S = S;
  p.slots = (int)slots;
  p.idx4 = S % 4 == 0 && slots % 4 == 0;
  p.x_stride4 = x_stride / 4;
  p.groups = T * kR * slots / 4;
  p.grid = (int)grid;
  const SumKernel k = find_sum(rows, m, transposed);
  if (!k.kernel || grid < 1 || grid > p.groups || slots < 1) return 1;
  return k.launch(p, (cudaStream_t)stream);
}

// The gather_sum launch of (rows, m, transposed) on the current card: out =
// {registers a thread, local memory bytes a thread, resident blocks per SM
// (the occupancy API's count), SMs, static shared memory bytes a block}
extern "C" int gather_sum_shape(int64_t rows, int64_t m, int64_t transposed,
                                void* out) {
  const SumKernel k = find_sum(rows, m, transposed);
  if (!k.kernel) return 1;
  cudaFuncAttributes a;
  cudaError_t c = cudaFuncGetAttributes(&a, k.kernel);
  int occ = 0, dev = 0, sms = 0;
  if (c == cudaSuccess)
    c = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k.kernel,
                                                      kSumThreads, 0);
  if (c == cudaSuccess) c = cudaGetDevice(&dev);
  if (c == cudaSuccess)
    c = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (c != cudaSuccess) return (int)c;
  int64_t* o = static_cast<int64_t*>(out);
  o[0] = a.numRegs;
  o[1] = (int64_t)a.localSizeBytes;
  o[2] = occ;
  o[3] = sms;
  o[4] = (int64_t)a.sharedSizeBytes;
  return 0;
}

// l2_read_f32: blocks blocks each read x's n4 float4s through L2 and add
// their sum to out[block] (blocks floats, zeroed by the caller)
extern "C" int l2_read_f32(const void* x, void* out, int64_t n4,
                           int64_t blocks, void* stream) {
  if (n4 < 1 || blocks < 1) return 1;
  l2_read_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const float4*>(x), n4, static_cast<float*>(out));
  return (int)cudaGetLastError();
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
