// Fused ring allreduce over W virtual ranks on one Hopper card.
//
// Replaces the Pallas TPU kernels of accl_tpu/ops/ring_allreduce.py:
//   DIRS == 2: ring_allreduce_pallas_bidir (_kernel_bidir), the default
//              on-chip body of ACCL.allreduce;
//   DIRS == 1: ring_allreduce_pallas (_kernel), its unidirectional twin.
//
// What it computes, for each rank r of the stacked (W, n) operand, is
// exactly what the TPU kernel computes on chip r, fold order included,
// so SUM is bitwise equal to the plain PyTorch version
// (accl_tpu_torch/ops/ring_allreduce.py::_ring_ref):
//   - each rank's n elements are cut into DIRS*W chunks of `chunk`
//     elements (the TPU tile rounding is kept: it decides which rank
//     starts each element's fold); direction 0 owns chunks [0, W),
//     direction 1 chunks [W, 2W);
//   - forward: the accumulator starts as rank r's chunk r-1; the hop-s
//     arrival from rank r-1 is combined as combine(arrival, local chunk
//     r-2-s); after W-1 hops rank r holds reduced chunk r, which then
//     relays W-1 times, the hop-s arrival filed at chunk r-1-s;
//   - backward mirrors it (start r+1, combine r+2+s, file r+1+s, the
//     neighbour is r-1);
//   - elements past n (the padding) are never read or written: padding
//     only ever folds with padding at the same position.
//
// Design. The TPU kernel moves a chunk per hop with a remote DMA into the
// neighbour's VMEM comm slot, guarded by DMA/credit semaphores and a
// neighbour barrier. Here all W ranks live on one card: a hop is a store
// into the neighbour's comm slot in device memory, and one grid-wide
// barrier (cooperative launch, every block co-resident) between a hop's
// stores and its loads stands in for the receive wait, the entry barrier
// and the credits. The comm buffer keeps the TPU's two slots (hop t uses
// slot t%2), so the store of hop t+1 can follow the loads of hop t
// without a second barrier: the barrier of hop t already ordered every
// reader of slot (t+1)%2 from hop t-1. The accumulator stays in a
// register between a hop's combine and the next hop's store.
//
// Bound: bytes. The function must read every rank's n input elements
// once and write every rank's n output elements once, 2*W*n*sizeof(T)
// bytes over 3.35 TB/s. This simple form moves about three times that
// (each hop reads the slot and the local chunk and writes the next slot)
// and pays 2(W-1) grid barriers per launch; narrowing that gap (keeping a
// chunk's whole fold in registers, vector loads) is later work.
//
// Numerics, the lanes' contract (accl_tpu_torch/ops/lane_kernels.py), as
// XLA computes the TPU kernel's combine: signed integer SUM wraps (added
// as unsigned); in f32, f64 and bf16 every operand and every result
// smaller in magnitude than FLT_MIN (DBL_MIN) is flushed to a zero of its
// own sign, written out in code (flush()) with the source built without
// -ftz; fp16/bf16 combine in float and round once; MAX is the IEEE
// maximum: NaN propagates and +0 is above -0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

enum : int { kSum = 0, kMax = 1 };

// DataType codes of accl_tpu_torch/constants.py
enum : int {
  kFloat16 = 2,
  kFloat32 = 3,
  kFloat64 = 4,
  kInt32 = 5,
  kInt64 = 6,
  kBFloat16 = 7,
};

constexpr float kFltMin = 0x1.0p-126f;
constexpr double kDblMin = 0x1.0p-1022;

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < kFltMin ? copysignf(0.0f, v) : v;
}

__device__ __forceinline__ double flush(double v) {
  return fabs(v) < kDblMin ? copysign(0.0, v) : v;
}

template <typename T>
__device__ __forceinline__ T max_ieee(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == T(0) && b == T(0)) return a + b;  // -0 only if both are -0
  return a > b ? a : b;
}

template <typename T>
struct Combine;

template <>
struct Combine<float> {
  __device__ static float sum(float a, float b) {
    return flush(__fadd_rn(flush(a), flush(b)));
  }
  __device__ static float max(float a, float b) {
    return max_ieee(flush(a), flush(b));
  }
};

template <>
struct Combine<double> {
  __device__ static double sum(double a, double b) {
    return flush(__dadd_rn(flush(a), flush(b)));
  }
  __device__ static double max(double a, double b) {
    return max_ieee(flush(a), flush(b));
  }
};

template <>
struct Combine<int32_t> {
  __device__ static int32_t sum(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                static_cast<uint32_t>(b));
  }
  __device__ static int32_t max(int32_t a, int32_t b) { return a > b ? a : b; }
};

template <>
struct Combine<int64_t> {
  __device__ static int64_t sum(int64_t a, int64_t b) {
    return static_cast<int64_t>(static_cast<uint64_t>(a) +
                                static_cast<uint64_t>(b));
  }
  __device__ static int64_t max(int64_t a, int64_t b) { return a > b ? a : b; }
};

// fp16 values widen to normal floats and their sum is 0 or at least
// 2^-24, so the float combine's flush never touches them.
template <>
struct Combine<__half> {
  __device__ static __half sum(__half a, __half b) {
    return __float2half_rn(
        Combine<float>::sum(__half2float(a), __half2float(b)));
  }
  __device__ static __half max(__half a, __half b) {
    return __float2half_rn(
        Combine<float>::max(__half2float(a), __half2float(b)));
  }
};

template <>
struct Combine<__nv_bfloat16> {
  __device__ static __nv_bfloat16 sum(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        Combine<float>::sum(__bfloat162float(a), __bfloat162float(b)));
  }
  __device__ static __nv_bfloat16 max(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        Combine<float>::max(__bfloat162float(a), __bfloat162float(b)));
  }
};

template <typename T, int OP>
__device__ __forceinline__ T combine(T arriving, T local) {
  if constexpr (OP == kSum) {
    return Combine<T>::sum(arriving, local);
  } else {
    return Combine<T>::max(arriving, local);
  }
}

__device__ __forceinline__ int wrap(int k, int w) {
  k %= w;
  return k < 0 ? k + w : k;
}

// One work item per (direction d, rank r, offset j in the chunk) and hop.
// comm is (2 slots, DIRS, W, chunk); item e = (d*W + r)*chunk + j names
// the comm entry rank r reads at a hop, in either slot.
template <typename T, int OP, int DIRS>
__global__ void __launch_bounds__(kThreads)
    ring_allreduce_kernel(const T* __restrict__ x, T* __restrict__ out,
                          T* __restrict__ comm, long long ld_in,
                          long long ld_out, long long n, int world,
                          long long chunk) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;

  if (world == 1) {  // no hops: the allreduce of one rank is its input
    for (long long p = first; p < n; p += stride) out[p] = x[p];
    return;
  }

  cg::grid_group grid = cg::this_grid();
  const long long per_dir = static_cast<long long>(world) * chunk;
  const long long items = DIRS * per_dir;  // entries of one comm slot

  // Chunk rank r touches at a phase, as an offset from r along its
  // direction: forward counts down from r, backward counts up.
  auto chunk_at = [&](int d, int r, int back) {
    return d == 0 ? wrap(r - back, world) : wrap(r + back, world);
  };
  auto neighbour = [&](int d, int r) {
    return d == 0 ? wrap(r + 1, world) : wrap(r - 1, world);
  };

  // Entry: every rank stores its chunk r-1 (forward) / r+1 (backward)
  // into the neighbour's slot 0.
  for (long long e = first; e < items; e += stride) {
    const int d = static_cast<int>(e / per_dir);
    const long long rem = e - d * per_dir;
    const int r = static_cast<int>(rem / chunk);
    const long long j = rem - r * chunk;
    const long long pos = d * per_dir + chunk_at(d, r, 1) * chunk + j;
    if (pos >= n) continue;
    comm[(d * world + neighbour(d, r)) * chunk + j] = x[r * ld_in + pos];
  }
  grid.sync();

  // Reduce-scatter: hop s reads slot s%2, combines with local chunk
  // r-2-s (backward r+2+s) and stores into the neighbour's other slot.
  // After the last hop the reduced chunk r is also filed into the output
  // and its store is the first allgather send.
  for (int s = 0; s < world - 1; ++s) {
    const T* in_slot = comm + (s & 1) * items;
    T* next_slot = comm + ((s + 1) & 1) * items;
    for (long long e = first; e < items; e += stride) {
      const int d = static_cast<int>(e / per_dir);
      const long long rem = e - d * per_dir;
      const int r = static_cast<int>(rem / chunk);
      const long long j = rem - r * chunk;
      const long long pos = d * per_dir + chunk_at(d, r, 2 + s) * chunk + j;
      if (pos >= n) continue;
      const T v = combine<T, OP>(in_slot[e], x[r * ld_in + pos]);
      if (s == world - 2) out[r * ld_out + pos] = v;
      next_slot[(d * world + neighbour(d, r)) * chunk + j] = v;
    }
    grid.sync();
  }

  // Allgather: hop s files the arrival at chunk r-1-s (backward r+1+s)
  // and relays it on.
  for (int s = 0; s < world - 1; ++s) {
    const int t = world - 1 + s;
    const T* in_slot = comm + (t & 1) * items;
    T* next_slot = comm + ((t + 1) & 1) * items;
    const bool relay = s < world - 2;
    for (long long e = first; e < items; e += stride) {
      const int d = static_cast<int>(e / per_dir);
      const long long rem = e - d * per_dir;
      const int r = static_cast<int>(rem / chunk);
      const long long j = rem - r * chunk;
      const long long pos = d * per_dir + chunk_at(d, r, 1 + s) * chunk + j;
      if (pos >= n) continue;
      const T v = in_slot[e];
      out[r * ld_out + pos] = v;
      if (relay) next_slot[(d * world + neighbour(d, r)) * chunk + j] = v;
    }
    if (relay) grid.sync();
  }
}

template <typename T, int OP, int DIRS>
cudaError_t launch(const void* x, void* out, void* comm, long long ld_in,
                   long long ld_out, long long n, int world, long long chunk,
                   cudaStream_t stream) {
  auto kernel = ring_allreduce_kernel<T, OP, DIRS>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  // every block must be co-resident for the grid barrier; a grid larger
  // than that is refused by the cooperative launch, never hung
  const long long work = world == 1 ? n : DIRS * world * chunk;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;

  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  T* cp = static_cast<T*>(comm);
  void* args[] = {&xp, &op, &cp, &ld_in, &ld_out, &n, &world, &chunk};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(static_cast<unsigned>(blocks)),
                                    dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_op(int op, int dirs, const void* x, void* out,
                        void* comm, long long ld_in, long long ld_out,
                        long long n, int world, long long chunk,
                        cudaStream_t s) {
  if (op == kSum && dirs == 2)
    return launch<T, kSum, 2>(x, out, comm, ld_in, ld_out, n, world, chunk, s);
  if (op == kSum && dirs == 1)
    return launch<T, kSum, 1>(x, out, comm, ld_in, ld_out, n, world, chunk, s);
  if (op == kMax && dirs == 2)
    return launch<T, kMax, 2>(x, out, comm, ld_in, ld_out, n, world, chunk, s);
  if (op == kMax && dirs == 1)
    return launch<T, kMax, 1>(x, out, comm, ld_in, ld_out, n, world, chunk, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int accl_ring_allreduce(int dtype, int op, int dirs, const void* x,
                                   void* out, void* comm, long long ld_in,
                                   long long ld_out, long long n, int world,
                                   long long chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_op<float>(op, dirs, x, out, comm, ld_in, ld_out, n,
                                world, chunk, s);
    case kFloat64:
      return dispatch_op<double>(op, dirs, x, out, comm, ld_in, ld_out, n,
                                 world, chunk, s);
    case kInt32:
      return dispatch_op<int32_t>(op, dirs, x, out, comm, ld_in, ld_out, n,
                                  world, chunk, s);
    case kInt64:
      return dispatch_op<int64_t>(op, dirs, x, out, comm, ld_in, ld_out, n,
                                  world, chunk, s);
    case kFloat16:
      return dispatch_op<__half>(op, dirs, x, out, comm, ld_in, ld_out, n,
                                 world, chunk, s);
    case kBFloat16:
      return dispatch_op<__nv_bfloat16>(op, dirs, x, out, comm, ld_in, ld_out,
                                        n, world, chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* accl_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
