// Tap-stencil shifted-read probes for NVIDIA Hopper (sm_90a): the H100
// counterpart of the TPU kernel of maxwell_tpu/bench/exp_stencil2.py (K15f:
// one pl.pallas_call at :120 with seven bodies from _mk, :32-90). No solver
// calls it; the probe script maxwell_tpu_torch/bench/exp_stencil2.py does.
//
// The field F is (NX + 2, Y + 2, L) f32, L = ZM + 2m, the (y, z * m) minor
// layout of the tap stencil with one plane, one row and m lanes of padding on
// each side. Output plane i < NX, row y < Y, lane z < ZM:
//   O[i, y, z] = sum over 33 taps of
//                c_t * F[i + 1 + dx, 1 + y + dy, m + z + dz m]
//   p0  the unshifted read, 33 times (dx = dy = dz = 0), c_t = 1 + t
//   p1  dz = t % 3 - 1                              (lane shifts of +-m)
//   p2  dz = t % 3 - 1, dy = (t / 3) % 3 - 1
//   p3  three planes dx = -1, 0, 1 (t < 3), 11 taps each (s < 11): dz =
//       s % 3 - 1, dy = (s / 3) % 3 - 1, c = 1 + t + s
//   p4  dy = t % 3 - 1                              (row shifts only)
//   p5  p1's function; the TPU took the dz shifts by lane rotates
//       (pltpu.roll), here each lane reads its row once and takes its -m and
//       +m neighbours from lanes l - m and l + m with __shfl_up_sync /
//       __shfl_down_sync; the m lanes at each edge of the warp read theirs
//   p6  p3's function, each (plane, dy) row read once and its dz shifts taken
//       as in p5 (the TPU rolled both axes)
// The taps are summed in the reference's order, one fmaf each.
//
// Design: the TPU kernel's structure, every tap read from planes resident in
// fast memory (its BlockSpecs put three whole planes in VMEM).
// - A block owns a window of ty output rows x tz lanes and a chunk of
//   x-planes, which it walks in order (the host plan sizes them:
//   kernels/stencil_probes.py shift_plan: near-equal chunks that give the
//   busiest SM the fewest staged window-planes). For each plane it stages
//   the window with its halo, ty + 2 rows x (tz + 2m) lanes, once in shared
//   memory: p3/p6 keep planes x - 1, x, x + 1 in a ring, the others the one
//   plane they read; one slot more holds the next plane, whose copy
//   (cp.async) is in flight while the current plane is computed. Rows are
//   copied in 16-byte units where the field's row stride and the window's
//   start are 16-byte aligned (every 64^3 field: 2,176 B at m 8, 2,448 B at
//   m 9), else in 4-byte units (grid 3, m 1).
// - Thread lz computes lane z0 + lz of each of the window's ty rows, row
//   after row: every tap of a warp reads 32 consecutive floats of a staged
//   row, conflict-free. p1-p3 keep each of their 33 tap reads a load of its
//   own, as the reference body reads a shifted slice per tap: the kernel's
//   `skew` argument is 0 at run time, but the compiler cannot know it and so
//   cannot merge the taps that hit one address (p1 has 3 distinct addresses,
//   p2 9, p3 27). p0 reads once (the reference hoists it) and p4's 33 reads
//   are left to the compiler, which merges them into 3: the ladder p0 (1
//   load) / p4 (3) / p1, p2 (33) / p3 (33 over three planes) / p5 (1 + 2
//   shuffles) / p6 (9 + 18 shuffles) shows what shared-memory loads and
//   shuffles cost per output, and p3 against K4 (per output element, on a
//   field with as many outputs) what K4's masks, 99 taps and two outputs add
//   to the same staging.
//
// Bound: the field read once (10.1 MB at g 64, m 8) and the output written
// once (9.2 MB): 5.8 us at 3.35 TB/s; 2 x 33 flops per output, 2.3 us at
// 67 TFLOP/s. p1-p3 make 33 shared-memory loads per output (2.4 M warp
// loads at 64^3, m 8, about 10 us at one a clock per SM). Each output is
// written once by one thread: runs repeat bit for bit. 32-bit offsets
// inside a plane; the wrapper checks that F has fewer than 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // a block's threads (the plan's cap)
constexpr int kMinBlocks = 4;     // resident blocks an SM: <= 64 registers
constexpr int kSmemLimit = 232448;

struct ShiftParams {
  const float* f;  // (NX + 2, Y + 2, L)
  float* o;        // (NX, Y, ZM)
  int NX, Y, ZM, m, L;
  int ty, tz, grid_z, grid_y, grid_x;
  int w;     // floats of a staged row (>= tz + 2m; a multiple of 4 if vec)
  int slot;  // floats of a ring slot, (ty + 2) w
  int vec;   // 1: 16-byte copies, 0: 4-byte
  int skew;  // 0: keeps p1-p3's tap reads distinct loads
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// row[c + dz m] for dz = -1, 0, +1 from one read per lane: lanes l >= m take
// the -m neighbour from lane l - m, lanes l < 32 - m the +m one from lane
// l + m, the rest read it. row points at window lane m of a staged row; c is
// the lane's position clamped to cmax = nz + m - 1 (so its reads stay in the
// window), and so is its +m edge read.
__device__ __forceinline__ void row_shifts(const float* row, int c, int m,
                                           int cmax, int lane,
                                           float (&v)[3]) {
  const float x = row[c];
  const float up = __shfl_up_sync(0xffffffffu, x, m);
  const float dn = __shfl_down_sync(0xffffffffu, x, m);
  v[0] = lane >= m ? up : row[c - m];
  v[1] = x;
  v[2] = lane < 32 - m ? dn : row[c + m < cmax ? c + m : cmax];
}

template <int CASE>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
shift_kernel(const ShiftParams p) {
  constexpr int kPlanes = CASE == 3 || CASE == 6 ? 3 : 1;
  constexpr int kSlots = kPlanes + 1;
  extern __shared__ __align__(16) float ring[];  // [slot][ty + 2][w]
  int b = blockIdx.x;
  const int z0 = (b % p.grid_z) * p.tz;
  b /= p.grid_z;
  const int y0 = (b % p.grid_y) * p.ty;
  const int xc = b / p.grid_y;  // x-chunk: NX / grid_x planes, rounded
  const int xb = (int)((int64_t)xc * p.NX / p.grid_x);
  const int xe = (int)((int64_t)(xc + 1) * p.NX / p.grid_x);
  const int nz = min(p.tz, p.ZM - z0), ny = min(p.ty, p.Y - y0);
  const int m = p.m, w = p.w;
  const int rows = ny + 2, lanes = nz + 2 * m;
  const size_t plane = (size_t)(p.Y + 2) * p.L;
  // field row y0 (the halo row above output row y0), lane z0 (the -m lane
  // of output lane z0), of plane 0
  const float* src0 = p.f + (size_t)y0 * p.L + z0;

  // field plane pl's window into its ring slot, in flight until waited for
  auto stage = [&](int pl) {
    float* dst = ring + (pl % kSlots) * p.slot;
    const float* src = src0 + pl * plane;
    if (p.vec) {
      const int n4 = (lanes + 3) >> 2;
      for (int e = threadIdx.x; e < rows * n4; e += blockDim.x) {
        const int r = e / n4, q = e - r * n4;
        cp_async16(dst + r * w + 4 * q, src + (size_t)r * p.L + 4 * q);
      }
    } else {
      for (int e = threadIdx.x; e < rows * lanes; e += blockDim.x) {
        const int r = e / lanes, q = e - r * lanes;
        cp_async4(dst + r * w + q, src + (size_t)r * p.L + q);
      }
    }
  };

  // planes read by output plane i: i + 1 (i .. i + 2 for p3/p6)
  const int p_first = kPlanes == 3 ? xb : xb + 1;
  const int p_end = xe + (kPlanes == 3 ? 2 : 1);
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) {
    if (p_first + k < p_end) stage(p_first + k);
    cp_async_commit();
  }
  const int lz = threadIdx.x;
  const int lane = lz & 31;
  const bool live = lz < nz;
  // p5/p6: every lane of a warp with an output lane takes part in the
  // shuffles; p0-p4: the output lanes alone read
  const bool active = CASE >= 5 ? lz - lane < nz : live;
  const int cmax = nz + m - 1;
  const int zc = lz < cmax ? lz : cmax;
  for (int i = xb; i < xe; ++i) {
    const int pn = i + (kPlanes == 3 ? 3 : 2);  // in flight while i computes
    if (pn < p_end) stage(pn);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (active) {
      // window lane m + lz of staged row 0 of plane i + 1 (i for p3/p6,
      // whose dx runs over i, i + 1, i + 2)
      const float* s1 = ring + ((i + 1) % kSlots) * p.slot + m + lz;
      float* o = p.o + ((size_t)i * p.Y + y0) * p.ZM + z0 + lz;
#pragma unroll 1
      for (int r = 0; r < ny; ++r) {
        float acc = 0.f;
        if (CASE == 0) {
          const float v = s1[(r + 1) * w];
#pragma unroll
          for (int t = 0; t < 33; ++t) acc = fmaf(1.f + t, v, acc);
        } else if (CASE == 1 || CASE == 2 || CASE == 4) {
#pragma unroll
          for (int t = 0; t < 33; ++t) {
            const int dz = CASE == 4 ? 0 : t % 3 - 1;
            const int dy =
                CASE == 1 ? 0 : CASE == 2 ? (t / 3) % 3 - 1 : t % 3 - 1;
            const int skew = CASE == 4 ? 0 : t * p.skew;
            acc = fmaf(1.f + t, s1[(r + 1 + dy) * w + dz * m + skew], acc);
          }
        } else if (CASE == 3) {
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            const float* st = ring + ((i + t) % kSlots) * p.slot + m + lz;
#pragma unroll
            for (int s = 0; s < 11; ++s) {
              const int dz = s % 3 - 1;
              const int dy = (s / 3) % 3 - 1;
              acc = fmaf(1.f + t + s,
                         st[(r + 1 + dy) * w + dz * m + (11 * t + s) * p.skew],
                         acc);
            }
          }
        } else if (CASE == 5) {
          float v[3];
          row_shifts(s1 - lz + (r + 1) * w, zc, m, cmax, lane, v);
#pragma unroll
          for (int t = 0; t < 33; ++t) acc = fmaf(1.f + t, v[t % 3], acc);
        } else {
          float v[3][3][3];  // [plane][dy + 1][dz + 1]
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            const float* st = ring + ((i + t) % kSlots) * p.slot + m;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
              row_shifts(st + (r + dy) * w, zc, m, cmax, lane, v[t][dy]);
          }
#pragma unroll
          for (int t = 0; t < 3; ++t)
#pragma unroll
            for (int s = 0; s < 11; ++s)
              acc = fmaf(1.f + t + s, v[t][(s / 3) % 3][s % 3], acc);
        }
        if (live) o[(size_t)r * p.ZM] = acc;
      }
    }
    __syncthreads();  // the slot of the oldest plane takes the next copy
  }
}

template <int CASE>
const void* kernel_of() {
  return reinterpret_cast<const void*>(shift_kernel<CASE>);
}

const void* kernel_for(int64_t which) {
  switch (which) {
    case 0: return kernel_of<0>();
    case 1: return kernel_of<1>();
    case 2: return kernel_of<2>();
    case 3: return kernel_of<3>();
    case 4: return kernel_of<4>();
    case 5: return kernel_of<5>();
    case 6: return kernel_of<6>();
    default: return nullptr;
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int CASE>
int launch(const ShiftParams& p, unsigned blocks, unsigned threads,
           size_t smem, cudaStream_t stream) {
  const int e = set_smem(kernel_of<CASE>(), smem);
  if (e) return e;
  shift_kernel<CASE><<<blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Shapes are checked by the
// Python wrapper (maxwell_tpu_torch/kernels/stencil_probes.py).
//
// shift_probe_f32: plan is a HOST int32 array from ShiftPlan.header(): NX,
// Y, ZM, m, ty, tz, chunk_x, grid_z, grid_y, grid_x, threads, w, slots,
// smem_bytes, vec. Returns cudaGetLastError() after the launch, 0 on
// success; -1 for an unknown case, 1 for a plan the kernel does not take
// (threads, row length, alignment, ring slots or shared memory).
extern "C" int shift_probe_f32(const void* f, void* o, int64_t which,
                               const void* plan, int64_t skew,
                               void* stream) {
  const int32_t* h = static_cast<const int32_t*>(plan);
  ShiftParams p;
  p.f = static_cast<const float*>(f);
  p.o = static_cast<float*>(o);
  p.NX = h[0]; p.Y = h[1]; p.ZM = h[2]; p.m = h[3];
  p.ty = h[4]; p.tz = h[5];  // h[6]: the longest x-chunk
  p.grid_z = h[7]; p.grid_y = h[8]; p.grid_x = h[9];
  const int threads = h[10];
  p.w = h[11];
  const int slots = h[12];
  const size_t smem = (size_t)h[13];
  p.vec = h[14];
  p.L = p.ZM + 2 * p.m;
  p.slot = (p.ty + 2) * p.w;
  p.skew = (int)skew;
  if (which < 0 || which > 6) return -1;
  const int planes = which == 3 || which == 6 ? 3 : 1;
  if (threads % 32 || threads > kMaxThreads || threads < p.tz ||
      p.tz < 1 || p.ty < 1 || p.m < 1 || p.m >= 32 ||
      p.w < p.tz + 2 * p.m || slots != planes + 1 ||
      smem != (size_t)slots * p.slot * sizeof(float) ||
      (int64_t)p.grid_z * p.tz < p.ZM || (int64_t)p.grid_y * p.ty < p.Y ||
      p.grid_x < 1 || p.grid_x > p.NX ||
      (p.vec && (p.L % 4 || p.w % 4 || p.tz % 4 ||
                 reinterpret_cast<uintptr_t>(f) % 16)))
    return 1;
  const unsigned blocks = (unsigned)(p.grid_z * p.grid_y * p.grid_x);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (which) {
    case 0: return launch<0>(p, blocks, threads, smem, s);
    case 1: return launch<1>(p, blocks, threads, smem, s);
    case 2: return launch<2>(p, blocks, threads, smem, s);
    case 3: return launch<3>(p, blocks, threads, smem, s);
    case 4: return launch<4>(p, blocks, threads, smem, s);
    case 5: return launch<5>(p, blocks, threads, smem, s);
    default: return launch<6>(p, blocks, threads, smem, s);
  }
}

// The launch of case `which` at `threads` threads and `smem` bytes on the
// current card: out = {registers a thread, local memory bytes a thread,
// resident blocks per SM (the occupancy API's count)}
extern "C" int shift_probe_shape(int64_t which, int64_t threads,
                                 int64_t smem, void* out) {
  const void* k = kernel_for(which);
  if (!k) return -1;
  int e = set_smem(k, (size_t)smem);
  if (e) return e;
  cudaFuncAttributes a;
  cudaError_t c = cudaFuncGetAttributes(&a, k);
  int occ = 0;
  if (c == cudaSuccess)
    c = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, (int)threads,
                                                      (size_t)smem);
  if (c != cudaSuccess) return (int)c;
  int64_t* o = static_cast<int64_t*>(out);
  o[0] = a.numRegs;
  o[1] = (int64_t)a.localSizeBytes;
  o[2] = occ;
  return 0;
}
