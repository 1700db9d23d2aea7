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
// x) and double (accumulating in double; a correctness path).
//
// Bound: device memory. The work is 4*m*n operations per block against
// m*n*sizeof(T) bytes of A, 1-2 operations per byte, far below the ~20
// (f32 CUDA cores) to ~295 (bf16 tensor cores) operations per byte where
// the H100 stops being memory bound; tensor cores would not help. The
// goal is one read of A at the memory rate: every SM streaming its share
// with enough bytes in flight, and no SM idle at the end.
//
// Design.
//  * Persistent, balanced grid. The wrapper's plan (ops/normal_kernels.py)
//    launches two CTAs per SM where the runtime says two fit (else one),
//    and CTA i owns the flattened rows [i*G/C, (i+1)*G/C) of all
//    G = nblk*m rows. Ranges may cross block boundaries; every CTA gets the
//    same number of rows (+-1) at any nblk, so there is no wave tail.
//  * A ring of stages in shared memory, filled asynchronously. Warp 8 is
//    the producer. For each stage (up to rows_per_stage rows of one block,
//    ~32 KB) it waits for the stage's "empty" mbarrier, then lane 0 issues
//    one 1-D cp.async.bulk global->shared copy that completes on the
//    stage's "full" mbarrier; a block's rows are contiguous, so no tensor
//    map is needed. At the main path's shape each CTA rings 3 stages, so an
//    SM has up to ~200 KB requested ahead of its consumers, far above the
//    ~32 KB that Little's law asks for at 3.35 TB/s over 132 SMs. Bulk
//    copies need 16-byte aligned addresses and sizes: a stage's bytes keep
//    their address modulo 16 in shared memory, the bulk copy moves the
//    aligned interior, and lanes 1-31 copy the ragged head and tail (fewer
//    than 16 bytes each) with plain loads. Nothing outside the tensor is
//    read. Where one row fills the ring, the plan runs one stage: the same
//    kernel.
//  * Consumers with no idle warps: warps 0-7 (256 threads). Thread t owns
//    the 16-byte column chunks t, t+256, ... (kc of them, a compile-time
//    bucket), keeps their slice of x and its partial u in registers, and
//    reads its chunks of each row from shared memory with conflict-free
//    16-byte loads (scalar loads for ragged widths). The mapping was chosen
//    over whole rows per warp because x is then never re-read from shared
//    memory and u never round-trips through it: shared-memory traffic is 3x
//    the bytes of A (the copy in, two reads). Row dots are finished two rows
//    at a time by five warp shuffles into a slot per warp, and for groups of
//    up to 16 rows by one named barrier and a fixed-order sum of the 8
//    slots; each thread then adds t_r * A[r, its columns] into its u. The
//    register budget (96 at two CTAs per SM) holds x, u and two rows' chunks
//    without spilling for kc <= 4; spills reach L2, since the ring leaves
//    the L1 little room, and cost more than a second CTA gains.
//  * Deterministic reduction. A CTA keeps one partial u per block segment
//    it touches. A block held by one CTA is written straight to U.
//    Otherwise the partial goes to scratch row cta + b (a slot unique to
//    the pair), and a second, small kernel sums each such block's segments
//    in a fixed order, parallel over columns and over segments. (Letting
//    the last CTA to finish a block sum its segments, found with an atomic
//    counter, saves that launch, but one SM then reads every partial of
//    the block: 264 rows of scratch at nblk = 1, which left small stacks
//    far from their bound.) The order of every sum is fixed by the shape,
//    so two calls give bitwise-equal u and q. Scratch is
//    (ctas + nblk - 1) rows of n, under 0.5% of A's bytes at the main
//    path's shape.
//
// Plain C interface (no torch headers), loaded with ctypes. The launch
// function returns cudaGetLastError() after each of its two launches so
// the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kMaxStages = 16;
constexpr int kGroup = 16;  // rows whose dots one barrier finishes
constexpr int kRedOffset = 2 * kMaxStages * 8;
constexpr int kHeaderBytes = 2304;  // must match ops/normal_kernels.py
static_assert(kRedOffset + 2 * kGroup * kConsumerWarps * 8 <= kHeaderBytes,
              "header overflow");

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

// Element e of a 16-byte chunk held as four 32-bit words, widened.
template <typename T> struct Widen;
template <> struct Widen<float> {
  static __device__ __forceinline__ float at(const uint32_t (&w)[4], int e) {
    return __uint_as_float(w[e]);
  }
};
template <> struct Widen<__nv_bfloat16> {
  static __device__ __forceinline__ float at(const uint32_t (&w)[4], int e) {
    return __uint_as_float((e & 1) ? (w[e >> 1] & 0xffff0000u) : (w[e >> 1] << 16));
  }
};
template <> struct Widen<__half> {
  static __device__ __forceinline__ float at(const uint32_t (&w)[4], int e) {
    return __half2float(__ushort_as_half(
        static_cast<unsigned short>((w[e >> 1] >> (16 * (e & 1))) & 0xffffu)));
  }
};
template <> struct Widen<double> {
  static __device__ __forceinline__ double at(const uint32_t (&w)[4], int e) {
    return __hiloint2double(static_cast<int>(w[2 * e + 1]), static_cast<int>(w[2 * e]));
  }
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}
// Barrier among the consumer warps only (the producer never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// CTA i's first flattened row, and the CTA that holds row r.
__device__ __forceinline__ int64_t range_start(int64_t i, int64_t rows, int ctas) {
  return i * rows / ctas;
}
__device__ __forceinline__ int owner(int64_t r, int64_t rows, int ctas) {
  return static_cast<int>(((r + 1) * ctas - 1) / rows);
}

struct Params {
  const void* A;
  const void* X;
  void* U;
  void* Q;
  void* scratch;
  int64_t rows;  // nblk * m
  int m, n, ctas, rows_per_stage, stages, stage_bytes;
};

// The eight warps' slots of one row, summed in warp order (16-byte loads).
__device__ __forceinline__ float sum_slots(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return ((((((a.x + a.y) + a.z) + a.w) + b.x) + b.y) + b.z) + b.w;
}
__device__ __forceinline__ double sum_slots(const double* p) {
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < kConsumerWarps / 2; ++i) {
    const double2 v = reinterpret_cast<const double2*>(p)[i];
    s = (s + v.x) + v.y;
  }
  return s;
}
static_assert(kConsumerWarps == 8, "sum_slots reads eight slots");

// Chunk c (columns c*V .. c*V+V-1) of one staged row, widened; zero past n.
template <typename T, typename Acc, int V>
__device__ __forceinline__ void load_chunk(const T* row, int c, int n, bool vec,
                                           Acc (&a)[V]) {
  if (vec) {
    if ((c + 1) * V <= n) {
      const uint4 q = *reinterpret_cast<const uint4*>(row + static_cast<int64_t>(c) * V);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < V; ++e) a[e] = Widen<T>::at(w, e);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) a[e] = Acc(0);
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int j = c * V + e;
      a[e] = j < n ? to_acc(row[j]) : Acc(0);
    }
  }
}

template <typename T, typename Acc, int KC>
__global__ void __launch_bounds__(kThreads, KC <= 4 ? 2 : 1)
normal_kernel(const Params p) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  Acc* red = reinterpret_cast<Acc*>(smem + kRedOffset);  // [2][kGroup][warps]
  unsigned char* ring = smem + kHeaderBytes;

  const int cta = blockIdx.x;
  const int64_t G = p.rows;
  const int64_t r0 = range_start(cta, G, p.ctas);
  const int64_t r1 = range_start(cta + 1, G, p.ctas);
  const int m = p.m, n = p.n;
  const T* A = static_cast<const T*>(p.A);
  const uintptr_t abase = reinterpret_cast<uintptr_t>(A);
  const int64_t row_bytes = static_cast<int64_t>(n) * sizeof(T);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == kConsumerWarps) {
    // Producer: walk the CTA's rows stage by stage, never across a block.
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t g = r0; g < r1;) {
      const int64_t seg_end = min64(r1, (g / m + 1) * m);
      const int rows = static_cast<int>(min64(p.rows_per_stage, seg_end - g));
      mbar_wait(&empty[stage], phase ^ 1);
      const uintptr_t src = abase + g * row_bytes;
      const uintptr_t end = src + rows * row_bytes;
      const uintptr_t a0 = (src + 15) & ~uintptr_t(15);
      const uintptr_t a1 = end & ~uintptr_t(15);
      // byte e of the stage lives at dst + e, 16-byte aligned where src is
      unsigned char* dst = ring + static_cast<int64_t>(stage) * p.stage_bytes + (src & 15);
      const bool bulk = a1 > a0;
      if (bulk && lane == 0) {
        mbar_arrive_expect_tx(&full[stage], static_cast<uint32_t>(a1 - a0));
        bulk_copy_g2s(dst + (a0 - src), reinterpret_cast<const void*>(a0),
                      static_cast<uint32_t>(a1 - a0), &full[stage]);
      } else {
        // what the bulk copy leaves out: whole elements before a0, from a1
        const T* s = reinterpret_cast<const T*>(src);
        T* d = reinterpret_cast<T*>(dst);
        const int64_t total = static_cast<int64_t>(rows) * n;
        const int64_t head = bulk ? static_cast<int64_t>((a0 - src) / sizeof(T)) : total;
        const int64_t tail = bulk ? static_cast<int64_t>((a1 - src) / sizeof(T)) : total;
        const int worker = bulk ? lane - 1 : lane;
        const int workers = bulk ? 31 : 32;
        bool wrote = false;
        for (int64_t e = worker; e < head; e += workers, wrote = true) d[e] = s[e];
        for (int64_t e = tail + worker; e < total; e += workers, wrote = true) d[e] = s[e];
        // order these generic-proxy writes before later bulk copies into
        // the stage (only a lane that wrote pays for the fence)
        if (wrote) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(&full[stage]);
      }
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
      g += rows;
    }
    return;
  }

  // Consumers.
  const int t = threadIdx.x;
  const Acc* X = static_cast<const Acc*>(p.X);
  Acc* U = static_cast<Acc*>(p.U);
  Acc* Q = static_cast<Acc*>(p.Q);
  Acc* scratch = static_cast<Acc*>(p.scratch);
  const bool vec = ((abase | static_cast<uintptr_t>(row_bytes)) & 15) == 0;
  Acc xr[KC][V], ur[KC][V];
  int stage = 0, par = 0;
  uint32_t phase = 0;

  for (int64_t g = r0; g < r1;) {
    const int b = static_cast<int>(g / m);
    const int64_t seg_end = min64(r1, static_cast<int64_t>(b + 1) * m);
    const Acc* xb = X + static_cast<int64_t>(b) * n;
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = (t + k * kConsumers) * V + e;
        xr[k][e] = j < n ? xb[j] : Acc(0);
        ur[k][e] = Acc(0);
      }

    while (g < seg_end) {
      const int rows = static_cast<int>(min64(p.rows_per_stage, seg_end - g));
      mbar_wait(&full[stage], phase);
      const T* tile = reinterpret_cast<const T*>(
          ring + static_cast<int64_t>(stage) * p.stage_bytes + ((abase + g * row_bytes) & 15));
      for (int gr = 0; gr < rows; gr += kGroup) {
        const int rr = min(kGroup, rows - gr);
        const T* grp = tile + static_cast<int64_t>(gr) * n;
        Acc* slots = red + par * kGroup * kConsumerWarps;
        // Row dots, two rows at a time: each warp sums its columns' share
        // of both rows over its lanes (lanes 0-15 finish the first row,
        // 16-31 the second: five shuffles for the pair) and leaves each in
        // the row's slot for that warp.
        for (int r = 0; r < rr; r += 2) {
          Acc d[2] = {Acc(0), Acc(0)};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (r + h < rr) {
#pragma unroll
              for (int k = 0; k < KC; ++k) {
                Acc a[V];
                load_chunk<T, Acc, V>(grp + static_cast<int64_t>(r + h) * n,
                                      t + k * kConsumers, n, vec, a);
#pragma unroll
                for (int e = 0; e < V; ++e) d[h] += a[e] * xr[k][e];
              }
            }
          }
          const bool second = lane & 16;
          Acc v = second ? d[1] : d[0];
          v += __shfl_xor_sync(0xffffffffu, second ? d[0] : d[1], 16);
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
          if ((lane & 15) == 0 && r + (lane >> 4) < rr)
            slots[(r + (lane >> 4)) * kConsumerWarps + warp] = v;
        }
        consumers_sync();
        // u += t_r * A[r, own columns], t_r summed over the warps in order.
#pragma unroll 2
        for (int r = 0; r < rr; ++r) {
          const Acc s = sum_slots(slots + r * kConsumerWarps);
          if (t == r) Q[g + gr + r] = s;
#pragma unroll
          for (int k = 0; k < KC; ++k) {
            Acc a[V];
            load_chunk<T, Acc, V>(grp + static_cast<int64_t>(r) * n, t + k * kConsumers, n, vec, a);
#pragma unroll
            for (int e = 0; e < V; ++e) ur[k][e] += s * a[e];
          }
        }
        par ^= 1;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
      g += rows;
    }

    // The segment of block b is done. A block held by this CTA alone is
    // finished; otherwise the partial goes to the segment's scratch slot
    // for normal_reduce_kernel.
    const bool alone = owner(static_cast<int64_t>(b) * m, G, p.ctas) ==
                       owner(static_cast<int64_t>(b + 1) * m - 1, G, p.ctas);
    Acc* out = (alone ? U : scratch + static_cast<int64_t>(cta) * n) +
               static_cast<int64_t>(b) * n;
#pragma unroll
    for (int k = 0; k < KC; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = (t + k * kConsumers) * V + e;
        if (j < n) out[j] = ur[k][e];
      }
  }
}

// u[b] = the sum of block b's segment partials, in segment order, for the
// blocks that span more than one CTA. A CTA takes 128 columns of one
// block, four per lane of a warp; its 8 warps each sum every 8th segment,
// then 128 threads add the 8 in order. The split is fixed by the shape,
// so the bits are too.
constexpr int kReduceCols = 128;
constexpr int kReduceLanes = 8;

template <typename Acc>
__global__ void __launch_bounds__(32 * kReduceLanes)
normal_reduce_kernel(const Acc* __restrict__ scratch, Acc* __restrict__ U,
                     int64_t rows, int m, int n, int ctas) {
  __shared__ Acc part[kReduceLanes][kReduceCols];
  const int col_tiles = (n + kReduceCols - 1) / kReduceCols;
  const int b = static_cast<int>(blockIdx.x / col_tiles);
  const int first = owner(static_cast<int64_t>(b) * m, rows, ctas);
  const int last = owner(static_cast<int64_t>(b + 1) * m - 1, rows, ctas);
  if (first == last) return;  // the main kernel wrote u[b]
  const int lane = threadIdx.x % 32;
  const int sl = threadIdx.x / 32;
  const int j0 = static_cast<int>(blockIdx.x % col_tiles) * kReduceCols + lane;
  Acc s[kReduceCols / 32] = {};
  for (int i = first + sl; i <= last; i += kReduceLanes) {
    const Acc* row = scratch + static_cast<int64_t>(i + b) * n;
#pragma unroll
    for (int c = 0; c < kReduceCols / 32; ++c)
      if (j0 + 32 * c < n) s[c] += row[j0 + 32 * c];
  }
#pragma unroll
  for (int c = 0; c < kReduceCols / 32; ++c) part[sl][lane + 32 * c] = s[c];
  __syncthreads();
  const int col = threadIdx.x;
  const int j = j0 - lane + col;
  if (col < kReduceCols && j < n) {
    Acc u = part[0][col];
#pragma unroll
    for (int l = 1; l < kReduceLanes; ++l) u += part[l][col];
    U[static_cast<int64_t>(b) * n + j] = u;
  }
}

template <typename T, typename Acc, int KC>
int launch_kc(const Params& p, int smem_bytes, cudaStream_t stream) {
  auto kernel = normal_kernel<T, Acc, KC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.ctas, kThreads, smem_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (p.rows / p.m) * ((p.n + kReduceCols - 1) / kReduceCols);
  normal_reduce_kernel<Acc><<<static_cast<unsigned>(tiles), 32 * kReduceLanes, 0,
                              stream>>>(static_cast<const Acc*>(p.scratch),
                                        static_cast<Acc*>(p.U), p.rows, p.m, p.n, p.ctas);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc, int KC>
int info_kc(int smem_bytes, int* regs, int* local_bytes, int* ctas_per_sm) {
  auto kernel = normal_kernel<T, Acc, KC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kernel, kThreads, smem_bytes));
}

// Calls F<KC>() for the instantiated chunk buckets; -2 for any other kc.
template <typename F>
int by_kc(int kc, F&& f) {
  switch (kc) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 24: return f(std::integral_constant<int, 24>{});
    default: return -2;
  }
}

// Calls F<T, Acc>() for a dtype code; -1 for an unknown code.
template <typename F>
int by_dtype(int dtype_code, F&& f) {
  switch (dtype_code) {
    case 0: return f(float{}, float{});
    case 1: return f(__nv_bfloat16{}, float{});
    case 2: return f(__half{}, float{});
    case 3: return f(double{}, double{});
    default: return -1;
  }
}

}  // namespace

extern "C" const char* normal_matvec_error_string(int err) {
  if (err == -1) return "unknown dtype code";
  if (err == -2) return "no kernel instantiated for this chunk count";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16 (x, u, q float32),
// 3 float64 (x, u, q float64). kc: 16-byte column chunks per consumer
// thread (1, 2, 4, 8 or 24). scratch: (ctas + nblk - 1) x n of the
// accumulator type. Returns a cudaError_t value, 0 on success; -1 for an unknown
// dtype code, -2 for an unknown kc.
extern "C" int normal_matvec_launch(int dtype_code, int kc, const void* A,
                                    const void* X, void* U, void* Q,
                                    void* scratch, int nblk,
                                    int m, int n, int ctas, int rows_per_stage,
                                    int stages, int stage_bytes, int smem_bytes,
                                    void* stream) {
  if (stages < 1 || stages > kMaxStages) return static_cast<int>(cudaErrorInvalidValue);
  Params p{A, X, U, Q, scratch, static_cast<int64_t>(nblk) * m, m, n, ctas, rows_per_stage, stages,
           stage_bytes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_dtype(dtype_code, [&](auto tv, auto av) {
    using T = decltype(tv);
    using Acc = decltype(av);
    return by_kc(kc, [&](auto kv) {
      return launch_kc<T, Acc, decltype(kv)::value>(p, smem_bytes, s);
    });
  });
}

// Registers and local (spill) bytes per thread of one instantiation, and
// how many of its CTAs fit on an SM at smem_bytes of dynamic shared memory.
extern "C" int normal_matvec_kernel_info(int dtype_code, int kc, int smem_bytes,
                                         int* regs, int* local_bytes,
                                         int* ctas_per_sm) {
  return by_dtype(dtype_code, [&](auto tv, auto av) {
    using T = decltype(tv);
    using Acc = decltype(av);
    return by_kc(kc, [&](auto kv) {
      return info_kc<T, Acc, decltype(kv)::value>(smem_bytes, regs, local_bytes,
                                                   ctas_per_sm);
    });
  });
}
