// One-sweep normal product of a stack of dense blocks, for Hopper (sm_90a).
//
// Per block b of A (nblk, m, n) and vector X[b] (n):
//     q[b] = A[b] x[b]              (m)
//     u[b] = A[b]^T (A[b] x[b])     (n)
// from ONE read of A. This replaces the TPU kernels
// pylops_mpi_tpu/ops/pallas_kernels.py:_normal_kernel (f32 blocks) and
// _normal_kernel_stream (bf16/f16 storage, widened on chip), both reached
// through batched_normal_matvec. One source templated on the storage type
// covers float, __nv_bfloat16, __half (accumulating in float, with an f32
// x) and double (accumulating in double).
//
// Bound: device memory. The work is 4*m*n operations per block against
// m*n*sizeof(T) bytes of A, about 1 operation per byte for f32 — far below
// the ~20 (f32 CUDA cores) to ~300 (bf16 tensor cores) operations per byte
// where the H100 stops being memory bound. So the design goal is that A
// crosses device memory once per call, nblk*m*n*sizeof(T) bytes, and that
// enough bytes are in flight to keep the memory system busy.
//
// Design. On the TPU the grid runs in order and u is carried from one row
// tile to the next in VMEM. Hopper blocks (CTAs) run in parallel in no
// order, so the carry becomes a two-pass reduction:
//   Kernel 1, grid (splits, nblk): each CTA owns a contiguous range of row
//     tiles of one block. It stages x (widened to the accumulator type) and
//     its own partial u in shared memory, and for each tile of TM rows it
//     copies the tile into shared memory once (16-byte loads where aligned),
//     computes t = A_tile x (a warp per row, shuffle reduction), writes q,
//     and adds A_tile^T t into its partial u (a thread per column). The
//     ragged last tile is masked here. At the end it writes its partial u
//     to scratch (splits, nblk, n) in the accumulator type.
//   Kernel 2 sums the partials over splits in a fixed order into u, so the
//     result is deterministic from run to run.
// Scratch traffic is splits*nblk*n*sizeof(acc) written and read once: the
// wrapper picks splits so it stays well under 1% of the bytes of A at the
// main path's shapes. The wrapper sizes TM so two CTAs fit on an SM, letting
// one CTA's tile copy overlap the other's arithmetic. wgmma, TMA and a
// persistent, pipelined schedule are left for later work.
//
// Plain C interface (no torch headers), loaded with ctypes. The launch
// function returns cudaGetLastError() so the caller can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Copy `count` elements of T from global `src` to shared `dst`, with 16-byte
// transactions when both ends are 16-byte aligned.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* __restrict__ src,
                                          int64_t count) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  int64_t done = 0;
  if (aligned) {
    const int64_t nvec = count / kVec;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int64_t i = threadIdx.x; i < nvec; i += kThreads) d4[i] = __ldg(s4 + i);
    done = nvec * kVec;
  }
  for (int64_t i = done + threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(kThreads)
normal_partial_kernel(const T* __restrict__ A, const Acc* __restrict__ X,
                      Acc* __restrict__ Q, Acc* __restrict__ scratch,
                      int m, int n, int tm, int tiles_per_split,
                      int tile_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* xs = reinterpret_cast<Acc*>(smem);            // n
  Acc* us = xs + n;                                  // n
  Acc* ts = us + n;                                  // tm
  T* tile = reinterpret_cast<T*>(smem + tile_offset);  // tm * n

  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* Ab = A + static_cast<int64_t>(b) * m * n;

  for (int j = threadIdx.x; j < n; j += kThreads) {
    xs[j] = X[static_cast<int64_t>(b) * n + j];
    us[j] = Acc(0);
  }

  const int ntiles = (m + tm - 1) / tm;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  for (int t = t_begin; t < t_end; ++t) {
    const int r0 = t * tm;
    const int rows = min(tm, m - r0);  // ragged last tile
    __syncthreads();  // previous tile fully consumed (and xs/us ready)
    copy_tile(tile, Ab + static_cast<int64_t>(r0) * n,
              static_cast<int64_t>(rows) * n);
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      const T* row = tile + static_cast<int64_t>(r) * n;
      Acc acc = Acc(0);
      for (int j = lane; j < n; j += 32) acc += to_acc(row[j]) * xs[j];
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        ts[r] = acc;
        Q[static_cast<int64_t>(b) * m + r0 + r] = acc;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      Acc acc = Acc(0);
      for (int r = 0; r < rows; ++r)
        acc += ts[r] * to_acc(tile[static_cast<int64_t>(r) * n + j]);
      us[j] += acc;
    }
  }
  __syncthreads();
  Acc* out = scratch + (static_cast<int64_t>(split) * gridDim.y + b) * n;
  for (int j = threadIdx.x; j < n; j += kThreads) out[j] = us[j];
}

template <typename Acc>
__global__ void __launch_bounds__(kThreads)
normal_reduce_kernel(const Acc* __restrict__ scratch, Acc* __restrict__ U,
                     int64_t total, int splits) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  Acc acc = Acc(0);
  for (int s = 0; s < splits; ++s) acc += scratch[s * total + i];
  U[i] = acc;
}

template <typename T, typename Acc>
int launch(const void* A, const void* X, void* U, void* Q, void* scratch,
           int nblk, int m, int n, int tm, int splits, int tiles_per_split,
           int tile_offset, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      normal_partial_kernel<T, Acc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid1(splits, nblk);
  normal_partial_kernel<T, Acc><<<grid1, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(A), static_cast<const Acc*>(X),
      static_cast<Acc*>(Q), static_cast<Acc*>(scratch), m, n, tm,
      tiles_per_split, tile_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(nblk) * n;
  const unsigned grid2 = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  normal_reduce_kernel<Acc><<<grid2, kThreads, 0, stream>>>(
      static_cast<const Acc*>(scratch), static_cast<Acc*>(U), total, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* normal_matvec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16 (x, u, q float32),
// 3 float64 (x, u, q float64). Returns a cudaError_t value, 0 on success;
// -1 for an unknown dtype code.
extern "C" int normal_matvec_launch(int dtype_code, const void* A,
                                    const void* X, void* U, void* Q,
                                    void* scratch, int nblk, int m, int n,
                                    int tm, int splits, int tiles_per_split,
                                    int tile_offset, int smem_bytes,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return launch<float, float>(A, X, U, Q, scratch, nblk, m, n, tm, splits,
                                  tiles_per_split, tile_offset, smem_bytes, s);
    case 1:
      return launch<__nv_bfloat16, float>(A, X, U, Q, scratch, nblk, m, n, tm,
                                          splits, tiles_per_split, tile_offset,
                                          smem_bytes, s);
    case 2:
      return launch<__half, float>(A, X, U, Q, scratch, nblk, m, n, tm, splits,
                                   tiles_per_split, tile_offset, smem_bytes, s);
    case 3:
      return launch<double, double>(A, X, U, Q, scratch, nblk, m, n, tm,
                                    splits, tiles_per_split, tile_offset,
                                    smem_bytes, s);
    default:
      return -1;
  }
}
