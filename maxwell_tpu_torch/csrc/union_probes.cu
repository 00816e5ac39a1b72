// Tile-union SpMM probes for NVIDIA Hopper (sm_90a): the H100 counterparts of
// the TPU design probes in maxwell_tpu/bench/exp_union.py (K15a) and
// maxwell_tpu/bench/exp_union2.py (K15b). No solver calls them; the probe
// scripts maxwell_tpu_torch/bench/exp_union.py and exp_union2.py do.
//
// K15a, the synthetic tile-union panel (exp_union.py:79-154). Tile t of T
// 128-row tiles reads one row idx[t] of run starts (the TPU's (8, UC) SMEM
// block at t // 8, row t % 8, is that row), gathers the (K, 8) panel
//     panel[k] = X[idx[t, k / run] * 8 + k % run]        (8 columns)
// once into shared memory, and writes
//     Y[128t + r] = sum_k vals[128t + r, k] * panel[k]     (rows >= 128T: 0)
//   union_panel_f32   true f32 FMAs: u0_hi (run 8), u1_runs (run 64), and
//                     with a second value stream u2_km (Y = Yk + Ym)
//   union_panel_bf16  u0_def, the TPU's DEFAULT precision: operands rounded
//                     to bf16 (nearest even), products summed in f32 by
//                     mma.sync m16n8k16 (n = 8 is the panel's width)
// Bound: device-memory bandwidth (a (128, K) f32 value block per tile,
// 512 KB at K = 1024, for 128 x 8 outputs). Design: one block per tile
// streams its values once with 16-byte loads; the panel is read from
// shared memory. f32: eight warps own 16 rows each, four (two with two
// streams) rows per register pass, each lane a stride of the row; one
// reduce-scatter of the lane partials per pass leaves lane l with entry l,
// so a warp writes 4 x 8 contiguous outputs. bf16: a warp owns one 16-row
// mma tile and walks K in steps of 16. Within a step, thread (g, tig) holds
// k = 4 tig .. 4 tig + 3 of both operands instead of the PTX fragment's
// k = 2 tig, 2 tig + 1, 2 tig + 8, 2 tig + 9: one permutation of k applied
// to A and B leaves the product unchanged, and A then loads as one 16-byte
// read per row. The bf16 panel's columns are padded by 16 values so the
// 8-byte B fragment reads hit distinct banks.
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

constexpr int kPanelWarps = 8;
constexpr int kPanelThreads = kPanelWarps * 32;  // one block per tile
constexpr int kM = 8;                            // panel width (b = m = 8)
constexpr int kBf16Pad = 16;                     // bf16 panel column padding

struct PanelParams {
  const int32_t* idx;  // (T, K / run) run starts, in 8-row blocks of X
  const float* va;     // (128 T, K) value stream
  const float* vb;     // second stream (u2_km) or null
  const float* x;      // (rows, 8)
  float* y;            // (rows, 8)
  int64_t T, K, run, rows;
};

// rows [128 T, rows) of Y are zero, as the reference's jnp.pad makes them
__device__ __forceinline__ void zero_tail(const PanelParams& p) {
  if (blockIdx.x != 0) return;
  for (int64_t i = p.T * 128 * kM + threadIdx.x; i < p.rows * kM;
       i += kPanelThreads)
    p.y[i] = 0.f;
}

// Gather tile t's panel into shared memory, column-major with stride S:
// thread i reads one 16-byte half of the 32-byte X row of panel row
// k = i % K and writes its four columns. f32, or bf16 bits rounded to
// nearest even.
template <bool BF16>
__device__ __forceinline__ void gather_panel(const PanelParams& p, int64_t t,
                                             void* panel, int64_t S) {
  const int64_t K = p.K;
  const int32_t* row = p.idx + t * (K / p.run);
  for (int64_t i = threadIdx.x; i < 2 * K; i += kPanelThreads) {
    const int64_t h = i / K;
    const int64_t k = i - h * K;
    const int64_t q = k / p.run;
    const int64_t src = (int64_t)row[q] * 8 + (k - q * p.run);
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(p.x + src * kM) + h);
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t at = (4 * h + c) * S + k;
      if (BF16)
        static_cast<uint16_t*>(panel)[at] =
            bf16_bits(__float2bfloat16_rn(f[c]));
      else
        static_cast<float*>(panel)[at] = f[c];
    }
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
#pragma unroll
  for (int s = N / 2; s >= 1; s >>= 1) {
    const bool upper = lane & s;
#pragma unroll
    for (int i = 0; i < s; ++i) {
      const float send = upper ? v[i] : v[i + s];
      const float keep = upper ? v[i + s] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
  return v[0];
}

// RP rows of one or two value streams against the f32 panel: acc[r * 8 + j]
template <int RP, bool FUSED>
__device__ __forceinline__ void panel_pass(const PanelParams& p,
                                           const float* xs, int64_t row0,
                                           int lane, float (&acc)[RP * kM]) {
  const int64_t K = p.K;
  float accb[RP * kM];
#pragma unroll
  for (int i = 0; i < RP * kM; ++i) acc[i] = accb[i] = 0.f;
#pragma unroll 2
  for (int64_t c = 4 * lane; c < K; c += 128) {
    float4 xv[kM];
#pragma unroll
    for (int j = 0; j < kM; ++j)
      xv[j] = *reinterpret_cast<const float4*>(xs + j * K + c);
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const float4 a =
          __ldcs(reinterpret_cast<const float4*>(p.va + (row0 + r) * K + c));
      float4 b = a;
      if (FUSED)
        b = __ldcs(
            reinterpret_cast<const float4*>(p.vb + (row0 + r) * K + c));
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        float& s = acc[r * kM + j];
        s = fmaf(a.x, xv[j].x, s);
        s = fmaf(a.y, xv[j].y, s);
        s = fmaf(a.z, xv[j].z, s);
        s = fmaf(a.w, xv[j].w, s);
        if (FUSED) {
          float& u = accb[r * kM + j];
          u = fmaf(b.x, xv[j].x, u);
          u = fmaf(b.y, xv[j].y, u);
          u = fmaf(b.z, xv[j].z, u);
          u = fmaf(b.w, xv[j].w, u);
        }
      }
    }
  }
  if (FUSED)
#pragma unroll
    for (int i = 0; i < RP * kM; ++i) acc[i] += accb[i];  // Yk + Ym
}

template <bool FUSED>
__global__ void __launch_bounds__(kPanelThreads)
union_panel_f32_kernel(const PanelParams p) {
  // rows per register pass: RP * 8 partial sums per lane and stream
  constexpr int RP = FUSED ? 2 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  const int64_t t = blockIdx.x;
  zero_tail(p);
  gather_panel<false>(p, t, xs, p.K);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int pass = 0; pass < 16 / RP; ++pass) {
    const int64_t row0 = t * 128 + warp * 16 + pass * RP;
    float acc[RP * kM];
    panel_pass<RP, FUSED>(p, xs, row0, lane, acc);
    const float s = warp_reduce_scatter<RP * kM>(acc, lane);
    if (lane < RP * kM) p.y[row0 * kM + lane] = s;  // rows row0 .. +RP
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

__global__ void __launch_bounds__(kPanelThreads)
union_panel_bf16_kernel(const PanelParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* xb = reinterpret_cast<uint16_t*>(smem);
  const int64_t S = p.K + kBf16Pad;
  const int64_t t = blockIdx.x;
  zero_tail(p);
  gather_panel<true>(p, t, xb, S);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;    // fragment row (and B column)
  const int tig = lane & 3;   // thread in group: k = 4 tig .. 4 tig + 3
  const int64_t row = t * 128 + warp * 16 + g;
  const float* v0 = p.va + row * p.K + 4 * tig;
  const float* v1 = v0 + 8 * p.K;  // row g + 8
  const uint16_t* xg = xb + g * S + 4 * tig;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int64_t k0 = 0; k0 < p.K; k0 += 16) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(v0 + k0));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(v1 + k0));
    const uint2 x = *reinterpret_cast<const uint2*>(xg + k0);
    // registers 0/2: row g, k pairs (4tig, +1)/(+2, +3); 1/3: row g + 8
    mma_bf16(d, pack_bf16(a.x, a.y), pack_bf16(b.x, b.y),
             pack_bf16(a.z, a.w), pack_bf16(b.z, b.w), x.x, x.y);
  }
  float* y = p.y + row * kM + 2 * tig;
  *reinterpret_cast<float2*>(y) = make_float2(d[0], d[1]);
  *reinterpret_cast<float2*>(y + 8 * kM) = make_float2(d[2], d[3]);
}

template <typename Kernel>
int launch_panel(Kernel kernel, const PanelParams& p, size_t smem,
                 cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)p.T, kPanelThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
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
  const size_t smem = (size_t)kM * K * sizeof(float);
  return vb ? launch_panel(union_panel_f32_kernel<true>, p, smem,
                           (cudaStream_t)stream)
            : launch_panel(union_panel_f32_kernel<false>, p, smem,
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
  const size_t smem = (size_t)kM * (K + kBf16Pad) * sizeof(uint16_t);
  return launch_panel(union_panel_bf16_kernel, p, smem, (cudaStream_t)stream);
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
