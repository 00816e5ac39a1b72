// Level-scheduled sparse triangular solve for NVIDIA Hopper (sm_90a):
// X = T^-1 B for one triangular factor T of kernels/tri_solve.py, every row
// of the factor in one launch.
//
// Replaces no Pallas kernel: the reference solves with the factors in a jnp
// lax.fori_loop over the levels (maxwell_tpu/kernels/tri_solve.py:149-157,
// LevelSchedule.solve), which XLA compiles as one device loop. Eager PyTorch
// has no such loop: its plain version (kernels/tri_solve.py
// level_solve_plain) launches about seven operations a level, and the
// shift-invert factors are chains (the LDL^T factor of the 128^2 rectangle
// after RCM has 32,512 levels of one row each), so a loop of launches would
// set the pace of every shift-invert apply.
//
// Plan (LevelSchedule, built once on the host): the rows renumbered in
// solve order (level by level), so that position p is the p-th row solved.
// order (n,) int32, the row at each position; pdinv (n,), 1/diag in solve
// order; ptr (n + 1,) int32, each position's slots; dep (nnz,) int32 and
// dval (nnz,), each off-diagonal slot's dependency as a position and its
// value, ascending within a row; tail (n,) int32, the first slot of a row's
// tail, the slots whose dependency lies within kTail positions of the row
// (at most kTail of them). The window W is the largest p - dep. B and X
// are (n, m) row-major in row ids. Position p, row i = order[p], takes
//   X[i, j] = (B[i, j] - sum_s dval[s] x[dep[s]]) pdinv[p].
//
// Bound: the chain of levels. The 128^2 LDL^T L moves 44 MB (5.5 M live
// slots) in 0.0135 ms at the card's memory rate (f32, m 1; the byte
// bound), but each of its 32,512 levels needs the one before it, so what
// sets the pace is the hand-off from one row to the next: a tag published
// by one warp, seen by another, a value read and one written.
// level_chain_kernel below does only that, with the solve's ring and tags
// and no load from device memory: on an H100 80GB HBM3 at 700 W it takes
// 4.78 ms over 32,512 positions with the solve's 16 warps, 0.147 us a
// level, and 4.44 ms with 2: the floor of this tag hand-off, not of every
// chain (a trial build with an mbarrier hand-off ran the f32 solve faster
// and the f64 one slower). This kernel
// solves that factor in 6.67 ms (f32, 0.205 us a level, 1.39 times the
// floor; bench/profile_tri_solve.py); a walk with a block barrier a level
// and its loads on the chain took 78.4 ms in the same run.
//
// Design: one block of kWarps warps serves one right-hand-side column j;
// blocks of different columns never wait for each other. Warp w takes the
// positions w, w + kWarps, ... in order, one row at a time, and each row
// waits only on the rows it reads; there is no barrier a level. x lives in
// a window indexed by position, with a readiness tag per entry that holds
// the position last written there (-1 before), published with release and
// read with acquire at block scope (cuda::atomic_ref):
//   shared route: a ring of R = 2^r >= W + kWarps entries of x and tags in
//     shared memory (R (sizeof(T) + 4) bytes beside the tail stage, 227 KB
//     in all at most); entry p & (R - 1). The walk needs R >= W + kTail + 1
//     (kTail < kWarps). The 128^2 chains (W 256) take 512 entries.
//   global route: a factor whose ring does not fit keeps x and the tags in
//     a per-column scratch of n entries in device memory, entry p; the walk
//     is the same. The wrapper picks the route from W and the dtype.
// A row's old slots (dependency < p - kTail) are read once every row up to
// p - kTail - 1 is published; lanes 0..kWarps-1 each wait on one of the
// kWarps positions p - kTail - kWarps .. p - kTail - 1, one a warp, and
// since every warp publishes its rows in order that covers every earlier
// row. Before writing position p a warp has so seen every row up to
// p - kTail - 1 published, which holds every reader of p - R (all at or
// below p - R + W): a ring entry is never overwritten before it is read,
// and its tag only grows. Lane l sums its old slots l, l + 32, ... in
// order, the warp's partial sums are combined by shuffles in a fixed tree
// into lane 0, and lane 0 then adds the tail slots in order, waiting on
// each one's tag: on a chain the critical path of a level is one tag wait,
// one FMA, the multiply by 1/diag and the stores. kTail 15 leaves the old
// slots and the tree 15 levels; with a tail of 8 the warps waiting on their
// watermark tags crowd the shared memory pipe and the 128^2 chain took
// 1.85 times as long, with none (the tree on the chain) 3.9 times.
//
// Right after publishing a row the warp loads its next row: old slots at
// most kSlots a lane into registers (the rest read in order in the loop),
// the tail into the warp's stage in shared memory (lanes 0..kTail-1; lane
// 0 reads it after the tree, so its registers are not held beside the old
// slots'), B and 1/diag, whose offsets it loaded while the row waited:
// kWarps - 1 levels of the chain hide that latency. No atomics in the sums
// and an order fixed by the plan, not by timing: runs repeat bit for bit.
// Templated on the value type: f32, f64.

#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;     // rows in flight a block, one a warp
constexpr int kSlots = 8;      // old slots a lane keeps in registers
constexpr int kTail = 15;      // the tail width: slots within kTail rows
static_assert(kTail < kWarps, "the ring covers W + kWarps >= W + kTail + 1");
constexpr int kSmemMax = 232448;  // shared memory a block may use
constexpr unsigned kFull = 0xffffffffu;

constexpr long long kSpinMax = 1ll << 27;  // polls before a wait traps

using Tag = cuda::atomic_ref<int, cuda::thread_scope_block>;

// Waits until the tag at `at` holds q or more. A row waits only on earlier
// rows, each a few microseconds of work; a wait past kSpinMax polls (about
// a second) is a broken plan, and traps: the launch fails instead of
// holding the card.
__device__ __forceinline__ void wait_for(int* tags, int at, int q) {
  Tag t(tags[at]);
  for (long long i = 0; t.load(cuda::memory_order_acquire) < q; ++i) {
    if (i > kSpinMax) __trap();
  }
}

__device__ __forceinline__ void publish(int* tags, int at, int p) {
  Tag(tags[at]).store(p, cuda::memory_order_release);
}

// what a warp knows of one row before its slots arrive
template <typename T>
struct Meta {
  int base, tl, end, row;
  T dinv;
};

template <typename T>
struct Row {
  int base, nold, ntail, row;
  T b, dinv;
  int dep[kSlots];
  T val[kSlots];
};

// Each warp's tail slots wait in shared memory, in two buffers (rows of
// even and odd turns), until lane 0 reads them after the tree: lanes load
// the next row's tail while lane 0 still sums this one's.
template <typename T>
struct Stage {
  T val[2][kWarps][kTail];
  int dep[2][kWarps][kTail];
};

template <typename T>
__device__ __forceinline__ Meta<T> load_meta(
    const int32_t* __restrict__ order, const int32_t* __restrict__ ptr,
    const int32_t* __restrict__ tail, const T* __restrict__ pdinv, int q,
    int n) {
  Meta<T> a{0, 0, 0, 0, T(0)};
  if (q < n) {
    a.base = ptr[q];
    a.tl = tail[q];
    a.end = ptr[q + 1];
    a.row = order[q];
    a.dinv = pdinv[q];
  }
  return a;
}

template <typename T>
__device__ __forceinline__ void load_row(
    Row<T>& r, const Meta<T>& a, const int32_t* __restrict__ dep,
    const T* __restrict__ val, const T* __restrict__ B, Stage<T>* st,
    int buf, int warp, int lane, int j, int m) {
  r.base = a.base;
  r.nold = a.tl - a.base;
  r.ntail = a.end - a.tl;
  r.row = a.row;
  r.dinv = a.dinv;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int s = lane + 32 * i;
    if (s < r.nold) {
      r.dep[i] = dep[a.base + s];
      r.val[i] = val[a.base + s];
    }
  }
  if (lane < r.ntail) {
    st->dep[buf][warp][lane] = dep[a.tl + lane];
    st->val[buf][warp][lane] = val[a.tl + lane];
  }
  if (lane == 0) r.b = B[(int64_t)a.row * m + j];
}

// kShared: x's window and tags in a ring in shared memory; else in xs and
// tags_g, n entries a column.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kWarps * 32, 1)
level_solve_kernel(const int32_t* __restrict__ order,
                   const int32_t* __restrict__ ptr,
                   const int32_t* __restrict__ tail,
                   const int32_t* __restrict__ dep,
                   const T* __restrict__ val, const T* __restrict__ pdinv,
                   const T* __restrict__ B, T* __restrict__ X, T* xs,
                   int* tags_g, int n, int ring, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T* xw;
  int* tg;
  int mask, entries;
  auto* st = reinterpret_cast<Stage<T>*>(smem);
  if (kShared) {
    xw = reinterpret_cast<T*>(st + 1);
    tg = reinterpret_cast<int*>(xw + ring);
    mask = ring - 1;
    entries = ring;
  } else {
    xw = xs + (int64_t)j * n;
    tg = tags_g + (int64_t)j * n;
    mask = -1;
    entries = n;
  }
  for (int i = threadIdx.x; i < entries; i += blockDim.x) tg[i] = -1;
  __syncthreads();

  int p = warp, buf = 0;
  Row<T> r;
  load_row(r, load_meta(order, ptr, tail, pdinv, p, n), dep, val, B, st,
           buf, warp, lane, j, m);
  while (p < n) {
    const int pn = p + kWarps;
    // the next row's offsets, row id and 1/diag: in flight while this row
    // waits
    const Meta<T> next = load_meta(order, ptr, tail, pdinv, pn, n);
    // every row at or before p - kTail - 1 published: one position a warp
    if (lane < kWarps) {
      const int q = p - kTail - 1 - lane;
      if (q >= 0) wait_for(tg, q & mask, q);
    }
    __syncwarp();
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (lane + 32 * i < r.nold) acc += r.val[i] * xw[r.dep[i] & mask];
    }
    for (int s = lane + 32 * kSlots; s < r.nold; s += 32) {
      acc += val[r.base + s] * xw[dep[r.base + s] & mask];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(kFull, acc, off);
    }
    if (lane == 0) {
      int td[kTail];
      T tv[kTail];
#pragma unroll
      for (int t = 0; t < kTail; ++t) {
        if (t < r.ntail) {
          td[t] = st->dep[buf][warp][t];
          tv[t] = st->val[buf][warp][t];
        }
      }
#pragma unroll
      for (int t = 0; t < kTail; ++t) {
        if (t < r.ntail) {
          wait_for(tg, td[t] & mask, td[t]);
          acc += tv[t] * xw[td[t] & mask];
        }
      }
      const T x = (r.b - acc) * r.dinv;
      xw[p & mask] = x;
      publish(tg, p & mask, p);
      X[(int64_t)r.row * m + j] = x;
    }
    buf ^= 1;
    load_row(r, next, dep, val, B, st, buf, warp, lane, j, m);
    p = pn;
  }
}

// The tag hand-off floor: position p waits on p - 1's tag, reads its value
// and publishes value + 1, with the solve's ring and tags, `warps` warps
// taking positions in turn (the solve's kWarps, or fewer), and no load
// from device memory. out[0] = n.
__global__ void __launch_bounds__(kWarps * 32, 1)
level_chain_kernel(float* out, int n, int ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xw = reinterpret_cast<float*>(smem);
  int* tg = reinterpret_cast<int*>(xw + ring);
  const int mask = ring - 1;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < ring; i += blockDim.x) tg[i] = -1;
  __syncthreads();
  for (int p = warp; p < n; p += warps) {
    if (lane == 0) {
      float x = 1.0f;
      if (p > 0) {
        const int q = p - 1;
        wait_for(tg, q & mask, q);
        x += xw[q & mask];
      }
      xw[p & mask] = x;
      publish(tg, p & mask, p);
      if (p == n - 1) out[0] = x;
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* order, const void* ptr, const void* tail,
           const void* dep, const void* val, const void* pdinv,
           const void* b, void* x, void* xs, void* tags, int64_t n,
           int64_t ring, int64_t m, void* stream) {
  if (n < 0 || n > 0x7fffffff - kWarps || m < 0 || m > 0x7fffffff ||
      ring < 0 || (ring & (ring - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || m == 0) return 0;
  const auto* o = static_cast<const int32_t*>(order);
  const auto* pt = static_cast<const int32_t*>(ptr);
  const auto* tl = static_cast<const int32_t*>(tail);
  const auto* dp = static_cast<const int32_t*>(dep);
  const auto* v = static_cast<const T*>(val);
  const auto* d = static_cast<const T*>(pdinv);
  const auto* B = static_cast<const T*>(b);
  auto* X = static_cast<T*>(x);
  auto strm = (cudaStream_t)stream;
  const int64_t bytes = (int64_t)sizeof(Stage<T>) +
                        ring * (int64_t)(sizeof(T) + sizeof(int));
  if (bytes > kSmemMax || (ring > 0 && ring < kTail + 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (ring > 0) {
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          level_solve_kernel<T, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e != cudaSuccess) return (int)e;
    }
    level_solve_kernel<T, true><<<(unsigned)m, kWarps * 32, (size_t)bytes,
                                  strm>>>(o, pt, tl, dp, v, d, B, X, nullptr,
                                          nullptr, (int)n, (int)ring, (int)m);
  } else {
    if (xs == nullptr || tags == nullptr) return (int)cudaErrorInvalidValue;
    level_solve_kernel<T, false><<<(unsigned)m, kWarps * 32, (size_t)bytes,
                                   strm>>>(o, pt, tl, dp, v, d, B, X,
                                           static_cast<T*>(xs),
                                           static_cast<int*>(tags), (int)n,
                                           0, (int)m);
  }
  return (int)cudaGetLastError();
}

template <typename T>
cudaError_t attributes(bool shared, cudaFuncAttributes* a) {
  return shared ? cudaFuncGetAttributes(a, level_solve_kernel<T, true>)
                : cudaFuncGetAttributes(a, level_solve_kernel<T, false>);
}

}  // namespace

// order, ptr, tail, dep, dval, pdinv: the plan; b, x: (n, m); xs (m, n) and
// tags (m, n) int32: the global route's scratch (null on the shared route,
// ring > 0: x's ring entries in shared memory, a power of two).
extern "C" int level_solve_f32(const void* order, const void* ptr,
                               const void* tail, const void* dep,
                               const void* val, const void* pdinv,
                               const void* b, void* x, void* xs, void* tags,
                               int64_t n, int64_t ring, int64_t m,
                               void* stream) {
  return launch<float>(order, ptr, tail, dep, val, pdinv, b, x, xs, tags, n,
                       ring, m, stream);
}

extern "C" int level_solve_f64(const void* order, const void* ptr,
                               const void* tail, const void* dep,
                               const void* val, const void* pdinv,
                               const void* b, void* x, void* xs, void* tags,
                               int64_t n, int64_t ring, int64_t m,
                               void* stream) {
  return launch<double>(order, ptr, tail, dep, val, pdinv, b, x, xs, tags,
                        n, ring, m, stream);
}

// The hand-off floor probe over n positions with `warps` warps (1 to
// kWarps); out: one f32 on the card.
extern "C" int level_chain_f32(void* out, int64_t n, int64_t ring,
                               int64_t warps, void* stream) {
  if (n < 1 || n > 0x7fffffff - kWarps || ring < 2 ||
      (ring & (ring - 1)) != 0 || ring * 8 > 48 * 1024 || warps < 1 ||
      warps > kWarps || ring < warps) {
    return (int)cudaErrorInvalidValue;
  }
  level_chain_kernel<<<1, (unsigned)warps * 32, (size_t)(ring * 8),
                       (cudaStream_t)stream>>>(static_cast<float*>(out),
                                               (int)n, (int)ring);
  return (int)cudaGetLastError();
}

// The solve kernel's build for dtype_bytes (4 or 8) and route (shared 1,
// global 0): out (int64 x 2) = registers a thread, local bytes a thread.
extern "C" int level_solve_shape(int64_t dtype_bytes, int64_t shared,
                                 void* out) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (dtype_bytes == 4)
    e = attributes<float>(shared != 0, &a);
  else if (dtype_bytes == 8)
    e = attributes<double>(shared != 0, &a);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  int64_t* o = static_cast<int64_t*>(out);
  o[0] = a.numRegs;
  o[1] = (int64_t)a.localSizeBytes;
  return 0;
}
