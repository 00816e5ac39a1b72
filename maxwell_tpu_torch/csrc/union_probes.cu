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
// Y = A @ X as K2 (csrc/bellunion_spmm.cu) on a BELLUnion layout, with the
// gathered X rows read straight from global memory through the read-only
// path (a lane's four value lanes read four consecutive X rows, with
// 16-byte loads when m is 4, 8, 12 or 16), without staging each chunk's X
// block in shared memory. The TPU probe set or accumulated each output tile
// by `first`; here one block walks a tile's chunks in order (tile_ptr ..
// tile_end) and keeps the sums in registers across chunks: no atomics,
// deterministic. Its geometry is the first K2 kernel's (16 warps x 4 rows,
// half a tile per block, every stored value streamed); it differed from
// that kernel in the staging, and so needs no barrier per chunk and one
// warp sum per tile instead of one per chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// union_unstaged's geometry: 16 warps own 4 rows each, half a tile per block
constexpr int kWarps = 16;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kBlocksPerTile = 128 / kRowsPerBlock;
constexpr int kThreads = kWarps * 32;

struct UnstagedParams {
  const float* vals;   // (NC * 128, cl) value stream a
  const int32_t* ucols;
  const int32_t* tile_ptr;
  const int32_t* tile_end;  // nullable: tile_ptr[t + 1]
  const float* x;      // (rows >= n_cols_padded, m) row-major
  float* y;            // (n_tiles * 128, m)
  int64_t m, cl, b, pack;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

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

// Columns [0, ms) of four consecutive X rows (xr: the first row's first
// column of the slice, row stride m) through the read-only path: 16-byte
// loads where a row is one whole slice (m = MS, a multiple of 4; the rows
// start at multiples of 4, so the loads are aligned), else one float at a
// time; columns from ms on are 0.
template <int MS>
__device__ __forceinline__ void load_x_rows(const float* xr, int64_t m,
                                            int ms, float (&xv)[4][MS]) {
  if constexpr (MS % 4 == 0) {
    if (m == MS) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < MS; j += 4) {
          const float4 q =
              __ldg(reinterpret_cast<const float4*>(xr + i * MS + j));
          xv[i][j] = q.x;
          xv[i][j + 1] = q.y;
          xv[i][j + 2] = q.z;
          xv[i][j + 3] = q.w;
        }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < MS; ++j)
      xv[i][j] = j < ms ? __ldg(xr + i * m + j) : 0.f;
}

// Rows [64 half, 64 half + 64) of output tile t, MS columns at a time: the
// tile's chunks in order, each lane's sums kept across chunks, one warp sum
// per (row, column) at the end.
template <int MS>
__global__ void __launch_bounds__(kThreads)
union_unstaged_kernel(const UnstagedParams p) {
  constexpr int RP = MS > 8 ? 2 : 4;
  const int64_t t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * kRowsPerBlock + warp * kRowsPerWarp;
  const int64_t k0 = p.tile_ptr[t];
  const int64_t k1 = p.tile_end ? p.tile_end[t] : p.tile_ptr[t + 1];
  const int64_t cl = p.cl;
  const int64_t CG = cl / p.b;
  const int64_t run = p.pack * p.b;  // X rows per aligned run
  const float* vals = p.vals;

  for (int64_t j0 = 0; j0 < p.m; j0 += MS) {
    const int ms = (int)((p.m - j0) < MS ? (p.m - j0) : MS);
#pragma unroll 1
    for (int pass = 0; pass < kRowsPerWarp / RP; ++pass) {
      const int64_t rp = r0 + pass * RP;  // first row of the pass in a tile
      float acc[RP][MS];
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int j = 0; j < MS; ++j) acc[r][j] = 0.f;

      for (int64_t k = k0; k < k1; ++k) {
        const int32_t* uc = p.ucols + k * CG;
        const size_t row_base = ((size_t)k * 128 + rp) * cl;
#pragma unroll 2
        for (int64_t c = 4 * lane; c < cl; c += 128) {
          const int64_t g = c / run;
          // four consecutive X rows (c .. c + 3 lie in one run)
          const float* xr =
              p.x + ((int64_t)__ldg(uc + g * p.pack) * p.b + (c - g * run)) *
                        p.m + j0;
          float v[RP][4];
#pragma unroll
          for (int r = 0; r < RP; ++r)
            load4(vals + row_base + r * cl + c, v[r]);
          float xv[4][MS];
          load_x_rows<MS>(xr, p.m, ms, xv);
#pragma unroll
          for (int j = 0; j < MS; ++j) {
            if (j < ms) {
#pragma unroll
              for (int r = 0; r < RP; ++r)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  acc[r][j] = fmaf(v[r][i], xv[i][j], acc[r][j]);
            }
          }
        }
      }

      float* yr = p.y + (t * 128 + rp) * p.m + j0;
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int j = 0; j < MS; ++j) {
          if (j < ms) {
            const float s = warp_sum(acc[r][j]);
            if (lane == 0) yr[r * p.m + j] = s;
          }
        }
    }
  }
}

template <int MS>
int launch_unstaged_ms(const UnstagedParams& p, int64_t n_tiles,
                       cudaStream_t stream) {
  const dim3 grid((unsigned)n_tiles, kBlocksPerTile);
  union_unstaged_kernel<MS><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
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

extern "C" int union_unstaged_f32(const void* vals, const void* ucols,
                                  const void* tile_ptr, const void* tile_end,
                                  const void* x, void* y, int64_t n_tiles,
                                  int64_t m, int64_t cl, int64_t b,
                                  int64_t pack, void* stream) {
  UnstagedParams p;
  p.vals = static_cast<const float*>(vals);
  p.ucols = static_cast<const int32_t*>(ucols);
  p.tile_ptr = static_cast<const int32_t*>(tile_ptr);
  p.tile_end = static_cast<const int32_t*>(tile_end);
  p.x = static_cast<const float*>(x);
  p.y = static_cast<float*>(y);
  p.m = m; p.cl = cl; p.b = b; p.pack = pack;
  const cudaStream_t s = (cudaStream_t)stream;
  if (m == 1) return launch_unstaged_ms<1>(p, n_tiles, s);
  if (m == 2) return launch_unstaged_ms<2>(p, n_tiles, s);
  if (m <= 4) return launch_unstaged_ms<4>(p, n_tiles, s);
  if (m <= 8) return launch_unstaged_ms<8>(p, n_tiles, s);
  if (m <= 12) return launch_unstaged_ms<12>(p, n_tiles, s);
  return launch_unstaged_ms<16>(p, n_tiles, s);
}
