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
//       (pltpu.roll), here each lane loads its row once and takes its -m and
//       +m neighbours from lanes l - m and l + m with __shfl_up_sync /
//       __shfl_down_sync; the m lanes at each edge of the warp load theirs
//   p6  p3's function, each (plane, dy) row read once and its dz shifts taken
//       as in p5 (the TPU rolled both axes)
// The taps are summed in the reference's order, one fmaf each.
//
// One thread per output element (y, z) of a plane, as K4
// (csrc/stencil_taps.cu) reads its taps: block (y, i) walks row y of plane i
// in warps of 32 consecutive lanes z, so every tap's read of a warp is 128
// contiguous bytes.
// p1-p3 keep each of their 33 tap reads a load of its own, as the reference
// body reads a shifted slice per tap: the kernel's `skew` argument is 0 at
// run time, but the compiler cannot know it and so cannot merge the taps that
// hit one address (p1 has 3 distinct addresses, p2 9, p3 27). p0 reads once
// (the reference hoists it) and p4's 33 reads are left to the compiler, which
// merges them into 3: the ladder p0 (1 load) / p4 (3) / p1, p2 (33) / p3 (33
// over three planes) / p5 (1 + 2 shuffles) / p6 (9 + 18 shuffles) shows what
// loads and shuffles cost per output, and p3 against K4 (per output
// element, on a field with as many outputs) what K4's masks, bounds checks
// and index arithmetic add.
//
// Bound: the field read once (10.1 MB at g 64, m 8) and the output written
// once (9.2 MB): 5.8 us at 3.35 TB/s; 2 x 33 flops per output, 2.3 us at
// 67 TFLOP/s. The taps' re-reads are served by L1/L2. 32-bit indices: the
// wrapper checks that F has fewer than 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ShiftParams {
  const float* f;  // (NX + 2, Y + 2, L)
  float* o;        // (NX, Y, ZM)
  int Y, ZM, m;
  int skew;        // 0: keeps p1-p3's tap reads distinct loads
};

// row[z + dz m] for dz = -1, 0, +1 from one load per lane: lanes l >= m take
// the -m neighbour from lane l - m, lanes l < 32 - m the +m one from lane
// l + m, the rest load it. zc is the lane's position, clamped to zmax =
// ZM + m - 1 (below), and so is its +m edge read: every read lies in the row.
__device__ __forceinline__ void row_shifts(const float* row, int zc, int m,
                                           int zmax, int lane,
                                           float (&v)[3]) {
  const float c = __ldg(row + zc);
  const float up = __shfl_up_sync(0xffffffffu, c, m);
  const float dn = __shfl_down_sync(0xffffffffu, c, m);
  v[0] = lane >= m ? up : __ldg(row + zc - m);
  v[1] = c;
  v[2] = lane < 32 - m ? dn : __ldg(row + (zc + m < zmax ? zc + m : zmax));
}

template <int CASE>
__global__ void __launch_bounds__(1024)
shift_kernel(const ShiftParams p) {
  const int y = blockIdx.x;
  const int i = blockIdx.y;
  const int L = p.ZM + 2 * p.m;
  const int plane = (p.Y + 2) * L;
  const int m = p.m;
  const int lane = threadIdx.x & 31;
  // plane i + 1 (i for p3/p6, whose dx runs over i, i + 1, i + 2), row 1 + y,
  // lane m: the unshifted read of output (i, y, 0)
  const float* f1 = p.f + (i + 1) * plane + (1 + y) * L + m;
  const float* f0 = f1 - plane;
  float* o = p.o + (i * p.Y + y) * p.ZM;
  // whole warps walk the row: every lane takes part in the shuffles
  for (int z0 = 0; z0 < p.ZM; z0 += blockDim.x) {
    const int z = z0 + threadIdx.x;
    if (CASE < 5 && z >= p.ZM) break;
    if (CASE >= 5 && z - lane >= p.ZM) break;  // a warp past the row's end
    float acc = 0.f;
    if (CASE == 0) {
      const float v = __ldg(f1 + z);
#pragma unroll
      for (int t = 0; t < 33; ++t) acc = fmaf(1.f + t, v, acc);
    } else if (CASE == 1 || CASE == 2 || CASE == 4) {
#pragma unroll
      for (int t = 0; t < 33; ++t) {
        const int dz = CASE == 4 ? 0 : t % 3 - 1;
        const int dy = CASE == 1 ? 0 : CASE == 2 ? (t / 3) % 3 - 1 : t % 3 - 1;
        const int skew = CASE == 4 ? 0 : t * p.skew;
        acc = fmaf(1.f + t, __ldg(f1 + dy * L + dz * m + z + skew), acc);
      }
    } else if (CASE == 3) {
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int s = 0; s < 11; ++s) {
          const int dz = s % 3 - 1;
          const int dy = (s / 3) % 3 - 1;
          acc = fmaf(1.f + t + s,
                     __ldg(f0 + t * plane + dy * L + dz * m + z +
                           (11 * t + s) * p.skew),
                     acc);
        }
    } else {
      // lanes past the row's end load their true position where a valid
      // lane needs it as a neighbour (z < ZM + m), a clamped one beyond
      const int zmax = p.ZM + m - 1;
      const int zc = z < zmax ? z : zmax;
      if (CASE == 5) {
        float v[3];
        row_shifts(f1, zc, m, zmax, lane, v);
#pragma unroll
        for (int t = 0; t < 33; ++t) acc = fmaf(1.f + t, v[t % 3], acc);
      } else {
        float v[3][3][3];  // [plane][dy + 1][dz + 1]
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
            row_shifts(f0 + t * plane + (dy - 1) * L, zc, m, zmax, lane,
                       v[t][dy]);
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int s = 0; s < 11; ++s)
            acc = fmaf(1.f + t + s, v[t][(s / 3) % 3][s % 3], acc);
      }
    }
    if (z < p.ZM) o[z] = acc;
  }
}

template <int CASE>
int launch(const ShiftParams& p, int NX, cudaStream_t stream) {
  int threads = (p.ZM + 31) / 32 * 32;
  threads = threads < 1024 ? threads : 1024;
  shift_kernel<CASE><<<dim3((unsigned)p.Y, (unsigned)NX), threads, 0,
                       stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes): returns cudaGetLastError() after
// the launch, 0 on success; an unknown case returns -1. Shapes are checked by
// the Python wrapper (maxwell_tpu_torch/kernels/stencil_probes.py).
extern "C" int shift_probe_f32(const void* f, void* o, int64_t which,
                               int64_t NX, int64_t Y, int64_t ZM, int64_t m,
                               int64_t skew, void* stream) {
  ShiftParams p;
  p.f = static_cast<const float*>(f);
  p.o = static_cast<float*>(o);
  p.Y = (int)Y;
  p.ZM = (int)ZM;
  p.m = (int)m;
  p.skew = (int)skew;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (which) {
    case 0: return launch<0>(p, (int)NX, s);
    case 1: return launch<1>(p, (int)NX, s);
    case 2: return launch<2>(p, (int)NX, s);
    case 3: return launch<3>(p, (int)NX, s);
    case 4: return launch<4>(p, (int)NX, s);
    case 5: return launch<5>(p, (int)NX, s);
    case 6: return launch<6>(p, (int)NX, s);
    default: return -1;
  }
}
