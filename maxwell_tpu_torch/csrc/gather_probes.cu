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
//   taa0                 g2_taa0 (:137-162, :151): per tile, idx (P, m)
//                        read coalesced, g[p, j] = X[idx[p, j], j] for all
//                        P m elements from X[0:P] staged in shared memory,
//                        and the tile's (8, m) output g[lo : lo + 8] +
//                        g[hi : hi + 8] with lo = 0, hi = P - 8 (the
//                        reference's :147). The 16 output rows are kernel
//                        arguments, and every gather is a volatile shared
//                        load, so none is dead code: all P m execute.
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
// taa0/taa1's design (the host plan: kernels/gather_probes.py taa_plan):
// - Persistent and even: the T tiles' index rows are cut into units (taa0
//   8 rows of a tile, taa1 one source row of P indices), block b of the
//   grid (kTaaBlocks blocks of 8 warps an SM) takes units b units / grid ..
//   (b + 1) units / grid, a contiguous run of idx. One block per tile left
//   298 tiles on 132 SMs, 3 on some SMs and 2 on others.
// - The source (8 P floats, 16 KB at P 512) staged once per block by 16-
//   byte cp.async, not once per tile (L2 reads 4.9 MB -> grid x 16 KB),
//   and a thread's first kTaaBatch int4 index loads (evict first) issued
//   before the wait on it: the index reads from device memory overlap the
//   staging; every index of the SM's share in flight at once at T 298.
// - taa0 reads its components in a per-lane order that spreads a warp's
//   gathers over the 32 banks (see taa0_kernel); taa1's staged rows lie
//   contiguous, banks k % 32.
// Bounds (bytes): the indices once (4.9 MB at T 298), the source once,
// the output once; the time is mostly the launch and one trip to device
// memory.
//
// l2_read_f32 ports no TPU kernel: it re-reads one buffer that lies in L2
// from every block, the rate the slices' reads cannot beat
// (bench/timing.py l2_read_rate).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 16;              // block rows per tile
constexpr int kB = 8;               // rows per block row
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100
constexpr int kTaaThreads = 256;    // threads of a taa0 / taa1 block
constexpr int kTaaBlocks = 2;       // resident blocks an SM: the plan's grid
constexpr int kTaaBatch = 8;        // int4 index loads a thread has in flight

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

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

// ---------------------------------------------------------------------------
// taa0 / taa1
// ---------------------------------------------------------------------------

struct TaaParams {
  const int4* idx;     // taa0 (T P, 8), taa1 (8 T, P): int4s in row order
  const float* x;      // taa0 X (rows, 8); taa1 X^T (8, row_stride)
  float4* y;           // taa0 (8 T, 8); taa1 (8 T, P)
  int64_t row_stride;  // taa1: floats between X^T's rows
  int64_t units;       // the split's units, unit4 int4s each
  int64_t unit4;
  int P;
  int lo, hi;          // taa0: the output rows g[lo + r] + g[hi + r]
};

// block b's int4s: units b units / grid .. (b + 1) units / grid
__device__ __forceinline__ int64_t taa_start(int64_t b, const TaaParams& p) {
  return b * p.units / gridDim.x * p.unit4;
}

// the 8 P floats of the source, 16-byte cp.async: taa0 X[0:P] as it lies
// (row-major [P][8]), taa1 X^T[j, 0:P] row after row ([8][P])
template <bool TRANSPOSED>
__device__ __forceinline__ void taa_stage(const TaaParams& p, uint32_t dst) {
  const int p4 = p.P / 4;
  for (int f = threadIdx.x; f < 2 * p.P; f += kTaaThreads) {
    const float* src = p.x + 4 * (int64_t)f;
    if (TRANSPOSED) {
      const int j = f / p4;
      src = p.x + j * p.row_stride + 4 * (f - j * p4);
    }
    cp_async16(dst + 16 * f, src);
  }
  cp_async_commit();
}

// A gather that ptxas may neither drop nor predicate: taa0 reads every
// element, its output keeps two rows of them
__device__ __forceinline__ float lds_kept(uint32_t addr) {
  float v;
  asm volatile("ld.volatile.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// (a, b, c, d) -> element c ^ s in place c: s's bit 0 swaps neighbours,
// bit 1 swaps pairs (its own inverse)
template <typename V>
__device__ __forceinline__ void xor_order(V& a, V& b, V& c, V& d, int s) {
  V t;
  if (s & 1) { t = a; a = b; b = t; t = c; c = d; d = t; }
  if (s & 2) { t = a; a = c; c = t; t = b; b = d; d = t; }
}

// g2: every g[p, j] = X[idx[t P + p, j], j] gathered from X[0:P] staged
// row-major ([P][8], 32 bytes a row) once per block. A thread's index int4
// is row p's columns 4 h .. 4 h + 3, h = tid & 1 (a block's range starts
// at an even int4). The 4 LDS of an int4 take its components in the
// lane's order c ^ s, s = (lane >> 1) & 3: the bank of (k, j) is 8 (k %
// 4) + j, so in a fixed order a warp's 32 random rows fall on 8 banks
// (2 h x 4 k % 4); in the lane's order on all 32 (4 lanes a bank on
// average, as 32 random rows over 32 banks). Every gather is an
// ld.volatile.shared (lds_kept): all P m of a tile execute, 4 unpredicated
// LDS an int4 in the SASS, and none is stored: the values of rows lo ..
// lo + 7 stay in registers, and the thread holding row lo + r also
// gathers row hi + r (its index int4 loaded beside the batch's) and
// writes (lo + r) + (hi + r). The rows of hi are gathered twice, 64
// elements a tile. No barrier after the gathers, no shared g.
__global__ void __launch_bounds__(kTaaThreads, kTaaBlocks)
taa0_kernel(const TaaParams p) {
  extern __shared__ __align__(16) float4 taa_src[];
  const int tid = threadIdx.x, h = tid & 1, s = (threadIdx.x >> 1) & 3;
  const int64_t a = taa_start(blockIdx.x, p);
  const int64_t z = taa_start(blockIdx.x + 1, p);
  const uint32_t base = smem_u32(taa_src);
  taa_stage<false>(p, base);
  uint32_t col[4];  // byte offset of round c's column, 4 h + (c ^ s)
#pragma unroll
  for (int c = 0; c < 4; ++c) col[c] = base + 4 * (4 * h + (c ^ s));
  const uint32_t P = p.P;

  // batches of kTaaBatch int4s a thread; the first batch's index loads
  // go out before the wait: the index reads overlap the staging
  for (int64_t i0 = a + tid; i0 - tid < z; i0 += kTaaBatch * kTaaThreads) {
    int4 k[kTaaBatch], kh[kTaaBatch];
    uint32_t d[kTaaBatch];  // row - lo: < 8 where the int4 feeds the output
#pragma unroll
    for (int b = 0; b < kTaaBatch; ++b) {
      const int64_t i = i0 + b * kTaaThreads;
      d[b] = 8;
      if (i < z) {
        k[b] = __ldcs(p.idx + i);  // read once: evict first
        const uint32_t row = (uint32_t)(i >> 1), t = row / P;
        d[b] = row - t * P - (uint32_t)p.lo;
        if (d[b] < 8)
          kh[b] = __ldg(p.idx + 2 * ((int64_t)t * P + p.hi + d[b]) + h);
      }
    }
    if (i0 == a + tid) {
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int b = 0; b < kTaaBatch; ++b) {
      const int64_t i = i0 + b * kTaaThreads;
      if (i >= z) continue;
      int r0 = k[b].x, r1 = k[b].y, r2 = k[b].z, r3 = k[b].w;
      xor_order(r0, r1, r2, r3, s);
      float v0 = lds_kept(col[0] + 32 * r0), v1 = lds_kept(col[1] + 32 * r1),
            v2 = lds_kept(col[2] + 32 * r2), v3 = lds_kept(col[3] + 32 * r3);
      if (d[b] < 8) {
        xor_order(v0, v1, v2, v3, s);
        const float* g = reinterpret_cast<const float*>(taa_src) + 4 * h;
        const int64_t t = (uint32_t)(i >> 1) / P;
        p.y[2 * (8 * t + d[b]) + h] = make_float4(
            v0 + g[8 * kh[b].x], v1 + g[8 * kh[b].y + 1],
            v2 + g[8 * kh[b].z + 2], v3 + g[8 * kh[b].w + 3]);
      }
    }
  }
}

// g3: g[u, p] = X^T[u % 8, idx[u, p]] for the idx rows u of the block's
// units (one row of P indices a unit on the plan's split), X^T[:, 0:P]
// staged once per block ([8][P]: a warp's lanes read one row at random
// columns, banks k % 32). Int4 index loads (evict first), the 4 gathers,
// float4 stores (evict first) at the int4's own place: y is (8 T, P) as
// idx is.
__global__ void __launch_bounds__(kTaaThreads, kTaaBlocks)
taa1_kernel(const TaaParams p) {
  extern __shared__ __align__(16) float4 taa_src[];
  const int tid = threadIdx.x;
  const int64_t a = taa_start(blockIdx.x, p);
  const int64_t z = taa_start(blockIdx.x + 1, p);
  taa_stage<true>(p, smem_u32(taa_src));
  const float* src = reinterpret_cast<const float*>(taa_src);
  const uint32_t p4 = p.P / 4;

  for (int64_t i0 = a + tid; i0 - tid < z; i0 += kTaaBatch * kTaaThreads) {
    int4 k[kTaaBatch];
#pragma unroll
    for (int b = 0; b < kTaaBatch; ++b) {
      const int64_t i = i0 + b * kTaaThreads;
      if (i < z) k[b] = __ldcs(p.idx + i);
    }
    if (i0 == a + tid) {  // as in taa0: the first batch's loads are out
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int b = 0; b < kTaaBatch; ++b) {
      const int64_t i = i0 + b * kTaaThreads;
      if (i >= z) continue;
      const float* row = src + (((uint32_t)i / p4) & 7) * p.P;
      __stcs(p.y + i, make_float4(row[k[b].x], row[k[b].y], row[k[b].z],
                                  row[k[b].w]));
    }
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

// The taa launch of kernels/gather_probes.py taa_plan: `grid` blocks of
// kTaaThreads, the index rows (taa0 P a tile, taa1 8) cut into units of
// unit_rows rows, block b taking units b units / grid .. (b + 1) units /
// grid, 32 P bytes of dynamic shared memory. Returns 1 for a launch the
// kernels do not take, else the launch's error code.
namespace {

int launch_taa(const void* kernel, TaaParams p, int64_t T, int64_t rows,
               int64_t row4, int64_t unit_rows, int64_t grid, void* stream) {
  if (T < 1 || p.P < 4 || p.P % 4 || unit_rows < 1 ||
      (T * rows) % unit_rows || 32 * (int64_t)p.P > kSmemLimit)
    return 1;
  p.units = T * rows / unit_rows;
  p.unit4 = unit_rows * row4;
  if (grid < 1 || grid > p.units) return 1;
  const size_t smem = 32 * (size_t)p.P;
  const int e = set_smem(kernel, smem);
  if (e) return e;
  void* args[] = {&p};
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)grid),
                               dim3(kTaaThreads), args, smem,
                               (cudaStream_t)stream);
}

}  // namespace

// g2: idx (T P, 8) int32, x (>= P, 8) f32, y (8 T, 8): y[8 t + r] =
// g[lo + r] + g[hi + r], 0 <= lo, hi <= P - 8
extern "C" int gather_taa0_f32(const void* idx, const void* x, void* y,
                               int64_t T, int64_t P, int64_t lo, int64_t hi,
                               int64_t unit_rows, int64_t grid,
                               void* stream) {
  if (P < 8 || lo < 0 || hi < 0 || lo > P - 8 || hi > P - 8) return 1;
  TaaParams p{};
  p.idx = static_cast<const int4*>(idx);
  p.x = static_cast<const float*>(x);
  p.y = static_cast<float4*>(y);
  p.P = (int)P;
  p.lo = (int)lo;
  p.hi = (int)hi;
  return launch_taa(reinterpret_cast<const void*>(taa0_kernel), p, T, P, 2,
                    unit_rows, grid, stream);
}

// g3: x X^T (8, row_stride) f32, idx (8 T, P) int32, y (8 T, P)
extern "C" int gather_taa1_f32(const void* x, int64_t row_stride,
                               const void* idx, void* y, int64_t T,
                               int64_t P, int64_t unit_rows, int64_t grid,
                               void* stream) {
  if (row_stride < P || row_stride % 4) return 1;
  TaaParams p{};
  p.idx = static_cast<const int4*>(idx);
  p.x = static_cast<const float*>(x);
  p.y = static_cast<float4*>(y);
  p.row_stride = row_stride;
  p.P = (int)P;
  return launch_taa(reinterpret_cast<const void*>(taa1_kernel), p, T, kB,
                    P / 4, unit_rows, grid, stream);
}

// The taa0 (kind 0) or taa1 (kind 1) launch at panel P on the current card:
// out = {registers a thread, local memory bytes a thread, resident blocks
// per SM at its 32 P bytes of shared memory (the occupancy API's count),
// SMs, dynamic shared memory bytes a block, threads a block}
extern "C" int gather_taa_shape(int64_t kind, int64_t P, void* out) {
  const void* k = kind == 0 ? reinterpret_cast<const void*>(taa0_kernel)
                : kind == 1 ? reinterpret_cast<const void*>(taa1_kernel)
                            : nullptr;
  const size_t smem = 32 * (size_t)P;
  if (!k || P < 4 || smem > (size_t)kSmemLimit) return 1;
  cudaFuncAttributes a;
  int occ = 0, dev = 0, sms = 0;
  cudaError_t c = (cudaError_t)set_smem(k, smem);
  if (c == cudaSuccess) c = cudaFuncGetAttributes(&a, k);
  if (c == cudaSuccess)
    c = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, kTaaThreads,
                                                      smem);
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
  o[5] = kTaaThreads;
  return 0;
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
