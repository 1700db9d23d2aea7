// Tap stencil along axis 0 of a halo-extended slab, for Hopper (sm_90a).
//
//     y[pad_lo + j] = sum_d c_d * slab[w + j + d]     0 <= j < rows
//     y[0 : pad_lo] = y[pad_lo + rows : ] = 0
//
// over a slab of rows + 2w rows and `cols` independent columns (trailing
// dims flattened), with |d| <= w <= 2. This replaces the TPU kernel
// pylops_mpi_tpu/ops/pallas_kernels.py:_taps_kernel (reached through
// stencil_taps, and through _centered3 for the centered-3 derivative
// conveniences). The slab arrives in three pieces, [top; body; bottom]:
// `top` and `bottom` are ghost rows (a neighbour's boundary rows) or,
// when their pointer is null, that many rows of zeros. So a caller
// never builds a padded copy of its field to give the stencil its halo.
//
// Bound: device memory. Each output element costs at most 5 multiply-adds
// against sizeof(T) bytes read and sizeof(T) written, well under one
// operation per byte, where the H100 needs ~20 (f32 CUDA cores) before
// arithmetic limits it. The least time is one read of the slab plus one
// write of the output at 3.35 TB/s, so the design goal is that each input
// row crosses device memory once, in wide coalesced transactions, with
// enough loads in flight to cover the memory latency.
//
// Design. The TPU kernel loads a full-height column tile into VMEM and
// takes every tap as a shifted slice of it; that layout exists to fit
// VMEM and is not carried over. Here each thread owns one column, or a
// 16-byte vector of columns where every piece's rows start 16-byte
// aligned, and walks down a run of output rows keeping the last 2w+1
// input rows in registers (a sliding window), so each input row is read
// once by the thread that needs it. Neighbouring threads own neighbouring
// columns, so a warp's row load is one contiguous, coalesced segment. Rows
// are taken four at a time: the four loads are issued, as loaded, before
// any of them is widened or used, which keeps four loads in flight per
// thread.
// The grid is (column blocks, row runs); runs overlap by 2w rows, which
// are re-read through L2. The ragged column edge is masked; the last run
// is shorter. The first and last runs also write the out_pad zero rows.
// cp.async/TMA staging is left for later work.
//
// Storage: float, __nv_bfloat16, __half (accumulating in float) and double
// (accumulating in double); the output is rounded once to the storage
// type. Taps are passed by value as a dense coefficient array indexed by
// offset + w with a bitmask of the offsets present.
//
// Plain C interface (no torch headers), loaded with ctypes. The launch
// function returns cudaGetLastError() so the caller can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxW = 2;
constexpr int kThreads = 128;
constexpr int kUnroll = 4;

struct Taps {
  double coeff[2 * kMaxW + 1];  // coefficient of offset d at index d + w
  int present;                  // bit d + w set where a tap sits at offset d
};

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename T> __device__ __forceinline__ T from_acc(typename AccOf<T>::type v);
template <> __device__ __forceinline__ float from_acc<float>(float v) { return v; }
template <> __device__ __forceinline__ double from_acc<double>(double v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_acc<__half>(float v) {
  return __float2half(v);
}

// A row segment as loaded: one element, or a 16-byte vector of them.
template <typename T, int VEC>
using Raw = typename std::conditional<VEC == 1, T, uint4>::type;

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> raw_zero() {
  if constexpr (VEC == 1) {
    return from_acc<T>(0);
  } else {
    return make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void widen(const Raw<T, VEC>& raw,
                                      typename AccOf<T>::type (&dst)[VEC]) {
  if constexpr (VEC == 1) {
    dst[0] = to_acc(raw);
  } else {
    static_assert(VEC * sizeof(T) == 16, "vector of 16 bytes");
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = to_acc(v[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const typename AccOf<T>::type (&src)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_acc<T>(src[0]);
  } else {
    alignas(16) T v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = from_acc<T>(src[i]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_zero(T* __restrict__ p) {
  typename AccOf<T>::type z[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) z[i] = 0;
  store_vec<T, VEC>(p, z);
}

template <typename T>
struct Pieces {
  const T* top;     // ntop rows, or null for zeros
  const T* body;    // nbody rows
  const T* bottom;  // nbot rows, or null for zeros
  int64_t ntop, nbody, nbot;
};

// Row r of the logical slab [top; body; bottom] at column c0, as loaded;
// zeros for an absent piece or when `live` is false. The caller widens
// only after issuing all of a chunk's loads, so they are in flight
// together.
template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> load_row(const Pieces<T>& pc, int64_t r,
                                                int64_t cols, int64_t c0,
                                                bool live) {
  const T* base;
  int64_t off;
  if (r < pc.ntop) {
    base = pc.top;
    off = r;
  } else if (r < pc.ntop + pc.nbody) {
    base = pc.body;
    off = r - pc.ntop;
  } else {
    base = pc.bottom;
    off = r - pc.ntop - pc.nbody;
  }
  Raw<T, VEC> v = raw_zero<T, VEC>();
  if (live && base != nullptr) {
    const T* p = base + off * cols + c0;
    if constexpr (VEC == 1) {
      v = *p;
    } else {
      v = __ldg(reinterpret_cast<const uint4*>(p));
    }
  }
  return v;
}

template <typename T, int W, int VEC>
__global__ void __launch_bounds__(kThreads)
taps_kernel(Pieces<T> pc, T* __restrict__ out, int64_t cols, int64_t rows,
            int64_t pad_lo, int64_t pad_hi, Taps taps, int64_t run) {
  using Acc = typename AccOf<T>::type;
  constexpr int kSpan = 2 * W + 1;
  constexpr int kWin = 2 * W + kUnroll;

  const int64_t cv = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (cv * VEC >= cols) return;  // ragged column edge
  const int64_t c0 = cv * VEC;

  if (blockIdx.y == 0)
    for (int64_t r = 0; r < pad_lo; ++r) store_zero<T, VEC>(out + r * cols + c0);
  if (blockIdx.y == gridDim.y - 1)
    for (int64_t r = 0; r < pad_hi; ++r)
      store_zero<T, VEC>(out + (pad_lo + rows + r) * cols + c0);

  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * run;
  const int64_t j1 = min(rows, j0 + run);
  if (j0 >= j1) return;

  Acc cf[kSpan];
#pragma unroll
  for (int k = 0; k < kSpan; ++k) cf[k] = static_cast<Acc>(taps.coeff[k]);

  // win[k] holds slab row j + k for the next output row j
  Acc win[kWin][VEC];
  {
    Raw<T, VEC> raw[2 * W];
#pragma unroll
    for (int k = 0; k < 2 * W; ++k) raw[k] = load_row<T, VEC>(pc, j0 + k, cols, c0, true);
#pragma unroll
    for (int k = 0; k < 2 * W; ++k) widen<T, VEC>(raw[k], win[k]);
  }

  for (int64_t j = j0; j < j1; j += kUnroll) {
    Raw<T, VEC> raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      raw[u] = load_row<T, VEC>(pc, j + 2 * W + u, cols, c0, j + u < j1);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) widen<T, VEC>(raw[u], win[2 * W + u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j + u < j1) {
        Acc acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = 0;
#pragma unroll
        for (int k = 0; k < kSpan; ++k) {
          if (taps.present & (1 << k)) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] = fma(cf[k], win[u + k][i], acc[i]);
          }
        }
        store_vec<T, VEC>(out + (pad_lo + j + u) * cols + c0, acc);
      }
    }
#pragma unroll
    for (int k = 0; k < 2 * W; ++k) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) win[k][i] = win[k + kUnroll][i];
    }
  }
}

template <typename T, int W, int VEC>
int launch_wv(const Pieces<T>& pc, void* out, int64_t cols, int64_t rows,
              int64_t pad_lo, int64_t pad_hi, const Taps& taps, int64_t run,
              cudaStream_t stream) {
  const int64_t vcols = (cols + VEC - 1) / VEC;
  const int64_t nruns = rows > 0 ? (rows + run - 1) / run : 1;
  dim3 grid(static_cast<unsigned>((vcols + kThreads - 1) / kThreads),
            static_cast<unsigned>(nruns));
  taps_kernel<T, W, VEC><<<grid, kThreads, 0, stream>>>(
      pc, static_cast<T*>(out), cols, rows, pad_lo, pad_hi, taps, run);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int w, int vec, const void* top, int64_t ntop, const void* body,
           int64_t nbody, const void* bottom, int64_t nbot, void* out,
           int64_t cols, int64_t rows, int64_t pad_lo, int64_t pad_hi,
           const double* coeff, int present, int64_t run,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  Pieces<T> pc{static_cast<const T*>(top), static_cast<const T*>(body),
               static_cast<const T*>(bottom), ntop, nbody, nbot};
  Taps taps{};
  for (int k = 0; k < 2 * w + 1; ++k) taps.coeff[k] = coeff[k];
  taps.present = present;
  if (w == 1 && vec == 1)
    return launch_wv<T, 1, 1>(pc, out, cols, rows, pad_lo, pad_hi, taps, run, stream);
  if (w == 1 && vec == kVec)
    return launch_wv<T, 1, kVec>(pc, out, cols, rows, pad_lo, pad_hi, taps, run, stream);
  if (w == 2 && vec == 1)
    return launch_wv<T, 2, 1>(pc, out, cols, rows, pad_lo, pad_hi, taps, run, stream);
  if (w == 2 && vec == kVec)
    return launch_wv<T, 2, kVec>(pc, out, cols, rows, pad_lo, pad_hi, taps, run, stream);
  return -2;
}

}  // namespace

extern "C" const char* stencil_taps_error_string(int err) {
  if (err == -1) return "unknown dtype code";
  if (err == -2) return "unsupported halo width or vector width";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16, 3 float64. `vec` is 1 or
// 16 / sizeof(element); with 16, cols is a multiple of it and every piece
// and the output are 16-byte aligned. Returns a cudaError_t value, 0 on
// success; -1 for an unknown dtype code, -2 for an unsupported w or vec.
extern "C" int stencil_taps_launch(int dtype_code, int w, int vec,
                                   const void* top, int64_t ntop,
                                   const void* body, int64_t nbody,
                                   const void* bottom, int64_t nbot,
                                   void* out, int64_t cols, int64_t rows,
                                   int64_t pad_lo, int64_t pad_hi,
                                   const double* coeff, int present,
                                   int run, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return launch<float>(w, vec, top, ntop, body, nbody, bottom, nbot, out,
                           cols, rows, pad_lo, pad_hi, coeff, present, run, s);
    case 1:
      return launch<__nv_bfloat16>(w, vec, top, ntop, body, nbody, bottom,
                                   nbot, out, cols, rows, pad_lo, pad_hi,
                                   coeff, present, run, s);
    case 2:
      return launch<__half>(w, vec, top, ntop, body, nbody, bottom, nbot, out,
                            cols, rows, pad_lo, pad_hi, coeff, present, run, s);
    case 3:
      return launch<double>(w, vec, top, ntop, body, nbody, bottom, nbot, out,
                            cols, rows, pad_lo, pad_hi, coeff, present, run, s);
    default:
      return -1;
  }
}
