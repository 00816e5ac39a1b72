// Tile-union SpMM probes for NVIDIA Hopper (sm_90a): the H100 counterparts of
// the TPU design probes in maxwell_tpu/bench/exp_union.py (K15a) and
// maxwell_tpu/bench/exp_union2.py (K15b). No solver calls them; the probe
// scripts maxwell_tpu_torch/bench/exp_union.py and exp_union2.py do.
//
// K15a, the synthetic tile-union panel (exp_union.py:79-154). Tile t of T
// 128-row tiles reads one row idx[t] of run starts (the TPU's (8, UC) SMEM
// block at t // 8, row t % 8, is that row), gathers the (K, 8) panel
//     panel[k] = X[idx[t, k / run] * 8 + k % run]        (8 columns)
// into shared memory, and writes
//     Y[128t + r] = sum_k vals[128t + r, k] * panel[k]     (rows >= 128T: 0)
//   union_panel_f32   true f32 FMAs: u0_hi (run 8), u1_runs (run 64), and
//                     with a second value stream u2_km (Y = Yk + Ym)
//   union_panel_bf16  u0_def, the TPU's DEFAULT precision: operands rounded
//                     to bf16 (nearest even), products summed in f32 by
//                     mma.sync m16n8k16 (n = 8 is the panel's width)
// Bound: device-memory bandwidth (a (128, K) f32 value block per tile,
// 512 KB at K = 1024, for 128 x 8 outputs; 156 MB at T 298).
//
// How the rows reach the SMs. One block per tile put T 298 tiles on 132
// SMs in 2.26 rounds; the f32 kernel (166 registers, its lane partials in
// local memory) held one 8-warp block per SM, so its tiles ran in three
// waves. Here the 128 T rows are cut into 16-row units (8 T: 2,384 at T
// 298), one warp's rows (the f32 route's passes, or one mma tile for
// bf16). A persistent grid of G blocks takes them in contiguous ranges:
// block b the units [U b / G, U (b + 1) / G), warp w of its W the w-th of
// W contiguous shares. G is the SM count and W = min(20, ceil(U / G)): at
// most 96 registers a thread, so one block per SM (the occupancy API's
// count). So every block, and so every SM, holds the same count of units
// to within one: at T 298, 132 blocks of 19 warps, 18 or 19 units on
// each, one unit a warp, all in one wave. A block gathers the panel of every tile its units touch (at
// most 4 at T 298: 128 KB f32, 66.5 KB bf16) once, four rows a thread at
// a time (bf16: two), while the first rows of each warp are on their way
// to L2 (a bulk prefetch: a pass of f32 rows, 512 bytes of each bf16 row)
// and its first ring step to registers; then one barrier, after which no
// warp waits for another. Where a block's tiles would not fit the 227 KB,
// G grows until they do (then no longer one wave).
// Each warp streams its rows with 16-byte evict-first loads through a ring
// of D steps in registers (f32: 4 steps of two float4, bf16: 2 of eight),
// across its passes and units without a bubble, and writes each output
// once. A warp load brings 512 bytes of a row (f32), or four loads issued
// together bring 256-byte runs of 16 rows (bf16: runs of 64 bytes, one per
// step, were 44% slower). f32: two rows a pass (u2_km: one row of both
// streams), each lane a stride of 4 columns in 128; one reduce-scatter of
// the lane partials per pass leaves lane l with entry l, so a warp writes
// 16 (8) contiguous outputs. bf16: a warp walks K in steps of 64 on its
// mma tile, four mma k-steps of 16. Within an mma k-step, thread (g, tig)
// holds k = 4 tig .. 4 tig + 3 of both operands instead of the PTX
// fragment's k = 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9: one permutation
// of k applied to A and B leaves the product unchanged, and A then loads
// as one 16-byte read per row. The bf16 panel's columns are padded by 16
// values so the 8-byte B fragment reads hit distinct banks.
// union_panel_shape reports a launch's G, W, shared memory and resident
// blocks per SM.
//
// K15b, union_unstaged (exp_union2.py:63-109, the "cat" kernel): the same
// Y = A @ X as K2 "highest" (csrc/bellunion_spmm.cu) on a BELLUnion layout,
// differing from it in one thing only: how X is gathered. It reads what K2
// reads, the layout's live form (the live 8 x 16 sub-blocks compacted, and
// sb_ptr, sb_run, xr_ptr, xr_run), and walks what K2's "highest" walk
// walks (one warp per 8-row group, the tile's chunks in order, the group's
// live sub-blocks in order, K2's FMA order and shuffles), so the two agree
// bit for bit; but it stages nothing: no shared memory, no cp.async, no
// barrier, each warp on its own. Lane 4 g + i's four X rows of a sub-block
// are the run's lanes 16 q + 4i .. + 3 through ucols, four consecutive rows
// starting at a multiple of 4 (b % 4 == 0), so at m <= 12 they are one
// 16-byte-aligned run of 4 m floats: m 16-byte loads through the read-only
// path (L1-cached; X, 1.4 MB at m 9, stays in L2 and a tile's 16 warps
// share it in L1). Where m % 4 == 0 the quads' blocks meet in the same
// banks: at m 8 each lane loads one float4 of one quad's 128 bytes and the
// quads take theirs by shuffles, at m 4 and 12 two quads read their blocks
// in rotated order (load_x). Wider X is walked in passes of 8 columns, with
// 16-byte loads where m % 4 == 0. The chain sb_run -> xr_run -> ucols -> X
// goes out a window (4 sub-blocks) ahead, one hop at a time, with the next
// window's values. A tile's 16 warps go in two blocks of 8 (no block-wide
// step), three blocks to an SM at m <= 9. (The TPU probe set or accumulated
// each output tile by `first`; one warp keeps its sums in registers across
// chunks: no atomics.) Bound: device-memory bandwidth on the live values
// (49.4 MB of the (1024, 2) layout's 245.9 MB at 24^3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint16_t bf16_bits(__nv_bfloat16 h) {
  return *reinterpret_cast<uint16_t*>(&h);
}

constexpr int kM = 8;              // panel width (b = m = 8)
constexpr int kBf16Pad = 16;       // bf16 panel column padding
constexpr int kUnitRows = 16;      // a unit: one warp's rows, an mma tile
constexpr int kUnitsPerTile = 128 / kUnitRows;
constexpr int kPanelMaxWarps = 20; // 640 threads: <= 96 registers
constexpr int kF32Depth = 4;       // ring steps (D - 1 in flight)
constexpr int kBf16Depth = 2;
constexpr int64_t kPanelSmemLimit = 232448;  // a block's on the H100

struct PanelParams {
  const int32_t* idx;  // (T, K / run) run starts, in 8-row blocks of X
  const float* va;     // (128 T, K) value stream
  const float* vb;     // second stream (u2_km) or null
  const float* x;      // (rows, 8)
  float* y;            // (rows, 8)
  int64_t T, K, run, rows;
};

// tiles that units [ua, ub) touch
__host__ __device__ __forceinline__ int64_t tiles_of(int64_t ua,
                                                     int64_t ub) {
  return ub > ua ? (ub - 1) / kUnitsPerTile - ua / kUnitsPerTile + 1 : 0;
}

// The calling warp's units [u0, u1), its block's first tile t0 (the panel
// in slot 0) and the block's tile count nt
struct Split {
  int64_t u0, u1, t0, nt;
};

__device__ __forceinline__ Split split_of(const PanelParams& p) {
  const int64_t U = p.T * kUnitsPerTile, G = gridDim.x, b = blockIdx.x;
  const int64_t ua = U * b / G, ub = U * (b + 1) / G;
  const int64_t W = blockDim.x >> 5, w = threadIdx.x >> 5, n = ub - ua;
  return {ua + n * w / W, ua + n * (w + 1) / W, ua / kUnitsPerTile,
          tiles_of(ua, ub)};
}

// rows [128 T, rows) of Y are zero, as the reference's jnp.pad makes them
__device__ __forceinline__ void zero_tail(const PanelParams& p) {
  if (blockIdx.x != 0) return;
  for (int64_t i = p.T * 128 * kM + threadIdx.x; i < p.rows * kM;
       i += blockDim.x)
    p.y[i] = 0.f;
}

// The panels of the block's tiles t0 .. t0 + nt - 1 into slots 0 .. nt - 1
// of shared memory, each column-major with stride S (a slot is 8 S
// values): item i of the nt K is panel row k = i % K of slot i / K; a
// thread reads the run starts of four items (bf16: two), then their
// 32-byte X rows, then writes their eight columns. f32, or bf16 bits
// rounded to nearest even.
template <bool BF16>
__device__ __forceinline__ void gather_panels(const PanelParams& p,
                                              const Split& s, void* panel,
                                              int64_t S) {
  constexpr int kBatch = BF16 ? 2 : 4;  // bf16: its ring holds 64 registers
  const int K = (int)p.K, run = (int)p.run, n = (int)s.nt * K;
  const int stride = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * stride) {
    int32_t start[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * stride;
      if (i < n)
        start[u] = __ldg(p.idx + (s.t0 + i / K) * (K / run) + i % K / run);
    }
    float4 lo[kBatch], hi[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = (i0 + u * stride) % K;
      if (i0 + u * stride < n) {
        const float4* src = reinterpret_cast<const float4*>(
            p.x + ((int64_t)start[u] * 8 + k % run) * kM);
        lo[u] = __ldg(src);
        hi[u] = __ldg(src + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * stride;
      if (i < n) {
        const float f[kM] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w,
                             hi[u].x, hi[u].y, hi[u].z, hi[u].w};
        const int64_t at0 = (int64_t)(i / K) * kM * S + i % K;
#pragma unroll
        for (int j = 0; j < kM; ++j) {
          if (BF16)
            static_cast<uint16_t*>(panel)[at0 + j * S] =
                bf16_bits(__float2bfloat16_rn(f[j]));
          else
            static_cast<float*>(panel)[at0 + j * S] = f[j];
        }
      }
    }
  }
}

// `bytes` (a multiple of 16) from the 16-byte aligned global address a into
// L2, with no register or barrier: a warp's first rows stream in while its
// block gathers the panels
__device__ __forceinline__ void prefetch_l2(const float* a, int64_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :
               : "l"(a), "r"((uint32_t)bytes)
               : "memory");
}

// One trade step of warp_reduce_scatter and those after it: keep half of
// the S * 2 entries and trade the other half with the partner lane (the
// steps are a template recursion, so that every loop has a constant trip
// count: a bound that depends on an unrolled outer loop left the array
// indexed at run time, in local memory)
template <int S, int N>
__device__ __forceinline__ void reduce_trade(float (&v)[N], int lane) {
  if constexpr (S >= 1) {
    const bool upper = lane & S;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float send = upper ? v[i] : v[i + S];
      const float keep = upper ? v[i + S] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
    }
    reduce_trade<S / 2>(v, lane);
  }
}

// Lane partials of N sums (N a power of two <= 32) -> the warp's sum of
// entry lane % N: fold while N < 32, then at each step keep half of the
// entries and trade the other half with the partner lane (31 shuffles for
// N = 32, against 160 for 32 separate warp sums).
template <int N>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[N],
                                                     int lane) {
#pragma unroll
  for (int o = 16; o >= N; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  reduce_trade<N / 2>(v, lane);
  return v[0];
}

__device__ __forceinline__ void fma4(float& s, const float4& a,
                                     const float4& x) {
  s = fmaf(a.x, x.x, s);
  s = fmaf(a.y, x.y, s);
  s = fmaf(a.z, x.z, s);
  s = fmaf(a.w, x.w, s);
}

// f32: a warp walks its rows in passes of RP rows (FUSED: one row of both
// streams), each pass in steps of 128 columns, lane l columns 4 l .. 4 l + 3
// of a step; the load stream runs D - 1 steps ahead of the compute stream
// through ring[D], across passes and units. At a pass's last step the lane
// partials (FUSED: Yk's plus Ym's) are reduce-scattered and written.
template <bool FUSED>
__global__ void __launch_bounds__(kPanelMaxWarps * 32, 1)
union_panel_f32_kernel(const PanelParams p) {
  constexpr int RP = FUSED ? 1 : 2;  // rows per pass
  constexpr int NV = 2;              // value float4s per step and lane
  constexpr int NA = RP * kM;        // lane partials per stream
  constexpr int D = kF32Depth;
  extern __shared__ __align__(16) unsigned char smem[];
  const float* xs = reinterpret_cast<const float*>(smem);
  const Split s = split_of(p);
  const int lane = threadIdx.x & 31;
  const int64_t K = p.K;
  const int SP = (int)((K + 127) >> 7);  // steps per pass
  const int64_t rend = s.u1 * kUnitRows;
  int64_t lrow = s.u0 * kUnitRows, crow = lrow;  // load / compute pass
  int ls = 0, cs = 0;                            // their steps
  float4 ring[D][NV];
  float acc[NA], accb[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = accb[i] = 0.f;

  auto load = [&](float4 (&v)[NV]) {
    if (lrow >= rend) return;
    const int64_t c = (int64_t)ls * 128 + 4 * lane;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float* src =
          FUSED ? (i ? p.vb : p.va) + lrow * K : p.va + (lrow + i) * K;
      v[i] = c < K ? __ldcs(reinterpret_cast<const float4*>(src + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (++ls == SP) {
      ls = 0;
      lrow += RP;
    }
  };
  auto step = [&](const float4 (&v)[NV]) {
    const int64_t c = (int64_t)cs * 128 + 4 * lane;
    if (c < K) {
      const float* xt = xs + ((crow >> 7) - s.t0) * kM * K + c;
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(xt + j * K);
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          fma4(acc[r * kM + j], v[FUSED ? 0 : r], x);
          if (FUSED) fma4(accb[r * kM + j], v[1], x);
        }
      }
    }
    if (++cs == SP) {
      if (FUSED)
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[i] += accb[i];  // Yk + Ym
      const float y = warp_reduce_scatter<NA>(acc, lane);
      if (lane < NA) p.y[crow * kM + lane] = y;  // rows crow .. + RP
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = accb[i] = 0.f;
      cs = 0;
      crow += RP;
    }
  };

  zero_tail(p);
  if (lane < NV && lrow < rend)  // the first pass's rows: 2 K floats each
    prefetch_l2(FUSED ? (lane ? p.vb : p.va) + lrow * K
                      : p.va + (lrow + lane) * K, 4 * K);
#pragma unroll
  for (int d = 0; d < D - 1; ++d) load(ring[d]);  // in flight while gathering
  gather_panels<false>(p, s, smem, K);
  __syncthreads();
  while (crow < rend) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      load(ring[(d + D - 1) % D]);
      if (crow < rend) step(ring[d]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D (16 x 8, f32) += A (16 x 16, bf16, row) @ B (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16: a warp walks its units, each one mma tile, in steps of 64 columns
// (four mma k-steps: per lane four 16-byte loads of each of rows g and
// g + 8, which the warp issues together as 256-byte runs of its 16 rows),
// the next step's loads in flight through ring[D] while one computes
__global__ void __launch_bounds__(kPanelMaxWarps * 32, 1)
union_panel_bf16_kernel(const PanelParams p) {
  constexpr int D = kBf16Depth;
  constexpr int KS = 4;  // mma k-steps per step
  extern __shared__ __align__(16) unsigned char smem[];
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(smem);
  const Split s = split_of(p);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row (and B column)
  const int tig = lane & 3;  // thread in group: k = 4 tig .. 4 tig + 3
  const int64_t K = p.K, S = K + kBf16Pad;
  const int SK = (int)((K + 16 * KS - 1) / (16 * KS));  // steps per unit
  int64_t lu = s.u0, cu = s.u0;  // load / compute unit
  int lk = 0, ck = 0;            // their steps
  float4 ring[D][2 * KS];
  float d[4] = {0.f, 0.f, 0.f, 0.f};

  auto load = [&](float4 (&v)[2 * KS]) {
    if (lu >= s.u1) return;
    const int64_t k0 = (int64_t)16 * KS * lk;
    const float* v0 = p.va + (lu * kUnitRows + g) * K + k0 + 4 * tig;
#pragma unroll
    for (int j = 0; j < KS; ++j)
      if (k0 + 16 * j < K) {
        v[2 * j] = __ldcs(reinterpret_cast<const float4*>(v0 + 16 * j));
        v[2 * j + 1] = __ldcs(  // row g + 8
            reinterpret_cast<const float4*>(v0 + 8 * K + 16 * j));
      }
    if (++lk == SK) {
      lk = 0;
      ++lu;
    }
  };
  auto step = [&](const float4 (&v)[2 * KS]) {
    const int64_t k0 = (int64_t)16 * KS * ck;
    const uint16_t* xg =
        xb + ((cu >> 3) - s.t0) * kM * S + g * S + k0 + 4 * tig;
#pragma unroll
    for (int j = 0; j < KS; ++j)
      if (k0 + 16 * j < K) {
        const uint2 x = *reinterpret_cast<const uint2*>(xg + 16 * j);
        const float4 &a = v[2 * j], &b = v[2 * j + 1];
        // registers 0/2: row g, k pairs (4tig, +1)/(+2, +3); 1/3: g + 8
        mma_bf16(d, pack_bf16(a.x, a.y), pack_bf16(b.x, b.y),
                 pack_bf16(a.z, a.w), pack_bf16(b.z, b.w), x.x, x.y);
      }
    if (++ck == SK) {
      float* y = p.y + (cu * kUnitRows + g) * kM + 2 * tig;
      *reinterpret_cast<float2*>(y) = make_float2(d[0], d[1]);
      *reinterpret_cast<float2*>(y + 8 * kM) = make_float2(d[2], d[3]);
      d[0] = d[1] = d[2] = d[3] = 0.f;
      ck = 0;
      ++cu;
    }
  };

  zero_tail(p);
  if (lane < kUnitRows && lu < s.u1)  // the first unit's rows: 128 columns
    prefetch_l2(p.va + (lu * kUnitRows + lane) * K, 4 * (K < 128 ? K : 128));
#pragma unroll
  for (int i = 0; i < D - 1; ++i) load(ring[i]);  // in flight while gathering
  gather_panels<true>(p, s, smem, S);
  __syncthreads();
  while (cu < s.u1) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      load(ring[(i + D - 1) % D]);
      if (cu < s.u1) step(ring[i]);
    }
  }
}

// A panel launch's shape: grid G, warps W a block, dynamic shared memory
// and the resident blocks per SM (the occupancy API's count)
struct PanelShape {
  int64_t grid, warps, smem, per_sm;
};

// G = the SM count, raised until every block's tiles fit in shared memory;
// W = min(kPanelMaxWarps, ceil(U / G)). One block per SM: the occupancy
// API must find room for one (where U > G W it finds no more: 20 warps of
// 94-96 registers fill the register file)
template <typename Kernel>
int panel_shape(Kernel kernel, int64_t T, int64_t slot_bytes,
                PanelShape& L) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t U = T * kUnitsPerTile, fit = kPanelSmemLimit / slot_bytes;
  if (U < 1 || fit < 2) return (int)cudaErrorInvalidValue;
  // a range of n units spans at most (n + 6) / 8 + 1 tiles
  const int64_t most = kUnitsPerTile * (fit - 1) + 1;
  const int64_t G = (U + most - 1) / most > sms ? (U + most - 1) / most
                                                 : (int64_t)sms;
  const int64_t w = (U + G - 1) / G;
  int64_t nt = 0;
  for (int64_t b = 0; b < G; ++b) {
    const int64_t n = tiles_of(U * b / G, U * (b + 1) / G);
    nt = n > nt ? n : nt;
  }
  L.grid = G;
  L.warps = w < kPanelMaxWarps ? w : kPanelMaxWarps;
  L.smem = nt * slot_bytes;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)L.smem);
  int occ = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kernel, (int)(32 * L.warps), (size_t)L.smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  L.per_sm = occ;
  return 0;
}

template <typename Kernel>
int launch_panel(Kernel kernel, const PanelParams& p, int64_t slot_bytes,
                 cudaStream_t stream) {
  PanelShape L;
  const int e = panel_shape(kernel, p.T, slot_bytes, L);
  if (e) return e;
  kernel<<<(unsigned)L.grid, (unsigned)(32 * L.warps), (size_t)L.smem,
           stream>>>(p);
  return (int)cudaGetLastError();
}

int64_t f32_slot(int64_t K) { return (int64_t)kM * K * sizeof(float); }
int64_t bf16_slot(int64_t K) {
  return (int64_t)kM * (K + kBf16Pad) * sizeof(uint16_t);
}
// K15b walks K2's groups: one warp per 8-row group, 16 per 128-row tile;
// with nothing shared, a tile's warps go in two blocks of 8, so that three
// blocks (24 warps) fit an SM at m <= 9
constexpr int kGroups = 16;
constexpr int kUWarps = 8;    // row groups (warps) of a block
constexpr int kUThreads = 32 * kUWarps;
constexpr int kWin = 4;       // sub-blocks whose X rows one step finds
constexpr int kNarrow = 12;   // widest m taken as one contiguous X block
constexpr int kWideCols = 8;  // X columns per pass above kNarrow

struct UnstagedParams {
  const float4* vals;        // live sub-blocks, lane l of i at [32 i + l]
  const int32_t* sb_ptr;     // (NC * 16 + 1)
  const int32_t* sb_run;     // per sub-block: its run's place in xr_run
  const int32_t* xr_ptr;     // (NC + 1)
  const int32_t* xr_run;     // run index within the chunk
  const int32_t* ucols;
  const int32_t* tile_ptr;
  const int32_t* tile_end;   // nullable: tile_ptr[t + 1]
  const float* x;            // (rows >= n_cols_padded, m) row-major
  float* y;                  // (n_tiles * 128, m)
  int64_t m, cl, b;
};

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Lane 4 g + i's four X rows (xr: the first one, columns from the pass's
// first), columns [0, ms) as xv[row][column]. Narrow (m = M <= kNarrow):
// the four rows are 4 M contiguous floats, 16-byte aligned (the first row
// is a multiple of 4), M 16-byte loads. At m 4 and 12 two quads' blocks
// start at the same offset modulo 128 bytes (a quad's rows are 16 m bytes,
// the two quads of a block column follow each other), so their loads at
// one index would hit the same banks: quads 2 and 3 read theirs from
// float4 2 on, and each value is selected back from the register that
// holds it. (m 8, where all four would meet, is loaded by the kernel.) Wide:
// kWideCols columns of each row, 16-byte loads where m % 4 == 0 (VEC),
// else one float at a time.
template <int M, bool WIDE, bool VEC>
__device__ __forceinline__ void load_x(const float* xr, int64_t m, int ms,
                                       int i,
                                       float (&xv)[4][WIDE ? kWideCols : M]) {
  if constexpr (!WIDE) {
    constexpr bool ROT = M % 4 == 0;
    const int rot = ROT ? 2 * (i >> 1) : 0;
    float4 f[M];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int at = k + rot < M ? k + rot : k + rot - M;
      f[k] = __ldg(reinterpret_cast<const float4*>(xr) + at);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int n = (r * M + j) / 4, c = (r * M + j) % 4;
        if constexpr (ROT)
          xv[r][j] = (i & 2) ? comp(f[(n + M - 2) % M], c) : comp(f[n], c);
        else
          xv[r][j] = comp(f[n], c);
      }
  } else if constexpr (VEC) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int h = 0; h < kWideCols / 4; ++h) {
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (4 * h < ms)
          q = __ldg(reinterpret_cast<const float4*>(xr + r * m) + h);
        xv[r][4 * h] = q.x; xv[r][4 * h + 1] = q.y;
        xv[r][4 * h + 2] = q.z; xv[r][4 * h + 3] = q.w;
      }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < kWideCols; ++j)
        xv[r][j] = j < ms ? __ldg(xr + r * m + j) : 0.f;
  }
}

// Up to kWin consecutive live sub-blocks of one chunk and row group: lane
// 4 p + i holds the first X row of sub-block p for lane quad i. k == k1:
// none.
struct UWin {
  int64_t k;
  int w, s1, xp;
};

// Output tile t, row group w (block 2 t + w / 8, warp w % 8): K2's
// "highest" walk (csrc/bellunion_tile.cuh) with X read from global memory.
// Per pass of MS columns: the tile's chunks in order, each chunk's live
// sub-blocks of the group in order; lane 4 g + i sums row g's products over
// its value lanes 4i .. 4i + 3 for each column, in K2's order
// (products_f32), and two xor shuffles finish each sum (store_f32). So the
// result equals K2's bit for bit. The sub-blocks go in windows of kWin; a
// window's X rows come from one shuffle each, and the next window's chain
// (sb_run, then xr_run, then ucols, one hop at a time between the current
// window's products) and its values (each into the register the current
// sub-block frees) go out while the current window computes.
template <int M, bool WIDE, bool VEC>
__global__ void __launch_bounds__(kUThreads, !WIDE && M <= 9 ? 3 : 2)
union_unstaged_kernel(const UnstagedParams p) {
  constexpr int MS = WIDE ? kWideCols : M;
  const int64_t t = blockIdx.x / (kGroups / kUWarps);
  const int lane = threadIdx.x & 31;
  const int grp =
      (int)(blockIdx.x % (kGroups / kUWarps)) * kUWarps + (threadIdx.x >> 5);
  const int qi = lane & 3, pl = lane >> 2;
  const int64_t k0 = p.tile_ptr[t];
  const int64_t k1 = p.tile_end ? p.tile_end[t] : p.tile_ptr[t + 1];
  const int64_t CG = p.cl / p.b;
  const int b = (int)p.b;
  const int64_t m = p.m;

  // the first window of the first chunk from k on whose group range is
  // not empty
  auto first_win = [&](int64_t k) {
    UWin w{k1, 0, 0, 0};
    for (; k < k1; ++k) {
      const int s = __ldg(p.sb_ptr + k * kGroups + grp);
      const int e = __ldg(p.sb_ptr + k * kGroups + grp + 1);
      if (s < e) {
        w.k = k; w.w = s; w.s1 = e; w.xp = __ldg(p.xr_ptr + k);
        break;
      }
    }
    return w;
  };
  auto next_win = [&](const UWin& w) {
    if (w.w + kWin < w.s1) {
      UWin n = w;
      n.w += kWin;
      return n;
    }
    return first_win(w.k + 1);
  };
  auto count = [&](const UWin& w) {
    return w.k < k1 ? (w.s1 - w.w < kWin ? w.s1 - w.w : kWin) : 0;
  };

  for (int64_t j0 = 0; j0 < m; j0 += MS) {
    const int ms = WIDE ? (int)(m - j0 < MS ? m - j0 : MS) : M;
    float acc[MS];
#pragma unroll
    for (int j = 0; j < MS; ++j) acc[j] = 0.f;

    UWin cur = first_win(k0);
    int rb = 0;  // lane 4 p + i: sub-block p's first X row for quad i
    float4 val[kWin];
    {
      const int n = count(cur);
      if (pl < n) {
        const int c = 16 * __ldg(p.xr_run + cur.xp +
                                 __ldg(p.sb_run + cur.w + pl)) + 4 * qi;
        rb = __ldg(p.ucols + cur.k * CG + c / b) * b + c % b;
      }
#pragma unroll
      for (int q = 0; q < kWin; ++q)
        if (q < n) val[q] = __ldcs(p.vals + (int64_t)32 * (cur.w + q) + lane);
    }
    UWin nxt = next_win(cur);
    while (cur.k < k1) {
      const int nw = count(cur), nn = count(nxt);
      int sbr = 0, q = 0, ucv = 0, c = 0;
      if (pl < nn) sbr = __ldg(p.sb_run + nxt.w + pl);
#pragma unroll
      for (int u = 0; u < kWin; ++u) {
        if (u == kWin / 4 && pl < nn) q = __ldg(p.xr_run + nxt.xp + sbr);
        if (u == kWin / 2) {
          c = 16 * q + 4 * qi;
          if (pl < nn) ucv = __ldg(p.ucols + nxt.k * CG + c / b);
        }
        if (u < nw) {
          float xv[4][MS];
          if constexpr (M == 8 && !WIDE) {
            // all four quads' blocks start at one offset modulo 128 bytes:
            // lane 8 i' + k loads float4 k of quad i''s 128 bytes (a quarter
            // warp one block, no two lanes on one bank), and lane 4 g + i
            // takes its quad's eight by shuffles from lanes 8 i .. 8 i + 7
            const int rq = __shfl_sync(0xffffffffu, rb, 4 * u + (lane >> 3));
            const float4 f = __ldg(
                reinterpret_cast<const float4*>(p.x + (int64_t)rq * 8) +
                (lane & 7));
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int from = 8 * qi + k;
              float* row = &xv[k / 2][4 * (k % 2)];
              row[0] = __shfl_sync(0xffffffffu, f.x, from);
              row[1] = __shfl_sync(0xffffffffu, f.y, from);
              row[2] = __shfl_sync(0xffffffffu, f.z, from);
              row[3] = __shfl_sync(0xffffffffu, f.w, from);
            }
          } else {
            const int row = __shfl_sync(0xffffffffu, rb, 4 * u + qi);
            load_x<M, WIDE, VEC>(p.x + (int64_t)row * m + j0, m, ms, qi,
                                 xv);
          }
          const float4 a = val[u];
          if (u < nn)
            val[u] = __ldcs(p.vals + (int64_t)32 * (nxt.w + u) + lane);
#pragma unroll
          for (int j = 0; j < MS; ++j) {
            if (j < ms) {
              acc[j] = fmaf(a.x, xv[0][j], acc[j]);
              acc[j] = fmaf(a.y, xv[1][j], acc[j]);
              acc[j] = fmaf(a.z, xv[2][j], acc[j]);
              acc[j] = fmaf(a.w, xv[3][j], acc[j]);
            }
          }
        } else if (u < nn) {
          val[u] = __ldcs(p.vals + (int64_t)32 * (nxt.w + u) + lane);
        }
      }
      rb = ucv * b + c % b;
      cur = nxt;
      nxt = next_win(cur);
    }

    // K2's store_f32: the four lanes of row g sum their partials; lane i
    // writes the columns j = i mod 4
    float* y = p.y + (t * 128 + 8 * grp + pl) * m + j0;
#pragma unroll
    for (int j = 0; j < MS; ++j) {
      if (j < ms) {
        float s = acc[j];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if ((j & 3) == qi) y[j] = s;
      }
    }
  }
}

template <int M, bool WIDE, bool VEC>
int launch_unstaged(const UnstagedParams& p, int64_t n_tiles,
                    cudaStream_t stream) {
  union_unstaged_kernel<M, WIDE, VEC>
      <<<(unsigned)(n_tiles * (kGroups / kUWarps)), kUThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// m <= kNarrow: the kernel for exactly m columns; wider: passes of
// kWideCols columns, 16-byte X loads where m % 4 == 0
template <int M>
int unstaged_m(const UnstagedParams& p, int64_t n_tiles, cudaStream_t st) {
  if constexpr (M > kNarrow) {
    return p.m % 4 == 0 ? launch_unstaged<0, true, true>(p, n_tiles, st)
                        : launch_unstaged<0, true, false>(p, n_tiles, st);
  } else {
    if (p.m == M) return launch_unstaged<M, false, false>(p, n_tiles, st);
    return unstaged_m<M + 1>(p, n_tiles, st);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns cudaGetLastError()
// after the launch: 0 on success. Shapes are checked by the Python wrappers
// (maxwell_tpu_torch/kernels/union_probes.py).

extern "C" int union_panel_f32(const void* idx, const void* va,
                               const void* vb, const void* x, void* y,
                               int64_t T, int64_t K, int64_t run,
                               int64_t rows, void* stream) {
  PanelParams p;
  p.idx = static_cast<const int32_t*>(idx);
  p.va = static_cast<const float*>(va);
  p.vb = static_cast<const float*>(vb);
  p.x = static_cast<const float*>(x);
  p.y = static_cast<float*>(y);
  p.T = T; p.K = K; p.run = run; p.rows = rows;
  return vb ? launch_panel(union_panel_f32_kernel<true>, p, f32_slot(K),
                           (cudaStream_t)stream)
            : launch_panel(union_panel_f32_kernel<false>, p, f32_slot(K),
                           (cudaStream_t)stream);
}

extern "C" int union_panel_bf16(const void* idx, const void* va,
                                const void* x, void* y, int64_t T, int64_t K,
                                int64_t run, int64_t rows, void* stream) {
  PanelParams p;
  p.idx = static_cast<const int32_t*>(idx);
  p.va = static_cast<const float*>(va);
  p.vb = nullptr;
  p.x = static_cast<const float*>(x);
  p.y = static_cast<float*>(y);
  p.T = T; p.K = K; p.run = run; p.rows = rows;
  return launch_panel(union_panel_bf16_kernel, p, bf16_slot(K),
                      (cudaStream_t)stream);
}

// The launch shape of union_panel_f32 (kind 0; kind 1 with two streams) or
// union_panel_bf16 (kind 2) at (T, K): out = {grid, warps a block, dynamic
// shared memory bytes, resident blocks per SM}
extern "C" int union_panel_shape(int64_t kind, int64_t T, int64_t K,
                                 void* out) {
  PanelShape L;
  int e;
  if (kind == 0)
    e = panel_shape(union_panel_f32_kernel<false>, T, f32_slot(K), L);
  else if (kind == 1)
    e = panel_shape(union_panel_f32_kernel<true>, T, f32_slot(K), L);
  else if (kind == 2)
    e = panel_shape(union_panel_bf16_kernel, T, bf16_slot(K), L);
  else
    return (int)cudaErrorInvalidValue;
  if (e) return e;
  int64_t* o = static_cast<int64_t*>(out);
  o[0] = L.grid; o[1] = L.warps; o[2] = L.smem; o[3] = L.per_sm;
  return 0;
}
extern "C" int union_unstaged_f32(const void* vals, const void* sb_ptr,
                                  const void* sb_run, const void* xr_ptr,
                                  const void* xr_run, const void* ucols,
                                  const void* tile_ptr, const void* tile_end,
                                  const void* x, void* y, int64_t n_tiles,
                                  int64_t m, int64_t cl, int64_t b,
                                  void* stream) {
  UnstagedParams p;
  p.vals = static_cast<const float4*>(vals);
  p.sb_ptr = static_cast<const int32_t*>(sb_ptr);
  p.sb_run = static_cast<const int32_t*>(sb_run);
  p.xr_ptr = static_cast<const int32_t*>(xr_ptr);
  p.xr_run = static_cast<const int32_t*>(xr_run);
  p.ucols = static_cast<const int32_t*>(ucols);
  p.tile_ptr = static_cast<const int32_t*>(tile_ptr);
  p.tile_end = static_cast<const int32_t*>(tile_end);
  p.x = static_cast<const float*>(x);
  p.y = static_cast<float*>(y);
  p.m = m; p.cl = cl; p.b = b;
  return unstaged_m<1>(p, n_tiles, (cudaStream_t)stream);
}
