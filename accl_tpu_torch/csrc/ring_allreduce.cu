// Ring allreduce over W virtual ranks on one Hopper card, as a
// closed-form fold.
//
// Replaces the Pallas TPU kernels of accl_tpu/ops/ring_allreduce.py:
//   DIRS == 2: ring_allreduce_pallas_bidir (_kernel_bidir), the default
//              on-chip body of ACCL.allreduce;
//   DIRS == 1: ring_allreduce_pallas (_kernel), its unidirectional twin.
//
// What it computes, for each rank r of the stacked (W, n) operand, is
// exactly what the TPU kernel computes on chip r, fold order included,
// so every result is bitwise equal to the plain PyTorch version
// (accl_tpu_torch/ops/ring_allreduce.py::_ring_ref), which plays the
// TPU's ring hop by hop:
//   - each rank's n elements are cut into DIRS*W chunks of `chunk`
//     elements (the TPU tile rounding is kept: it decides which rank
//     starts each element's fold); direction 0 owns chunks [0, W),
//     direction 1 chunks [W, 2W);
//   - the reduce-scatter carries forward chunk c through ranks c+1, c+2,
//     ..., c+W-1 and ends on rank c, each hop computing combine(arrival,
//     local); backward chunk c goes through c-1, c-2, ..., c-W+1, c;
//   - the allgather relays the reduced chunk unchanged, so every rank's
//     output at a position of chunk c is the one fold
//       acc = x[c+1]; acc = combine(acc, x[c+k]) for k = 2..W  (forward)
//       acc = x[c-1]; acc = combine(acc, x[c-k]) for k = 2..W  (backward)
//     over ranks mod W;
//   - elements past n (the padding) are never read or written: padding
//     only ever folds with padding at the same position.
//
// Design. The TPU kernel moves a chunk per hop with a remote DMA into the
// neighbour's VMEM comm slot. On one card the ranks share one memory, so
// a hop only moves data and the fold order is all that is left of the
// ring. Each thread owns one vector of VEC positions (16 bytes; a chunk
// is a multiple of 1024 elements, so a vector never straddles two
// chunks), finds its direction and chunk with one division, loads that
// vector from the W rank rows in fold order through the read-only path
// (in batches of kBatch, every load of a batch issued before the fold
// consumes it), folds in registers, and stores the result to all W
// output rows. There is no comm buffer, no grid barrier and no
// cooperative launch: a plain launch sized from n. VEC is 16/sizeof(T)
// when both base pointers and both row strides are 16-byte multiples,
// else 1 (the scalar instantiation, chosen by the wrapper); in the
// vector instantiation the ragged tail past the last whole vector runs
// element by element in the thread that owns it.
//
// Two entries share that fold (ring_fold): the direct one
// (accl_ring_allreduce) takes x and out as kernel arguments, as every
// eager call does; the indirect one (accl_ring_allreduce_indirect) reads
// them from a {x, out} entry of a device table, which a recorded call
// sequence's CUDA graph uses to read bound operands in place and write
// fresh results at every replay (accl_tpu_torch/sequencer/lowering.py,
// SequenceGraph). Strides, n, chunk and the instantiations are the same,
// and so is every result, bit for bit.
//
// Bound: bytes. The function must read every rank's n input elements
// once and write every rank's n output elements once, 2*W*n*sizeof(T)
// bytes over 3.35 TB/s; this kernel moves exactly that.
//
// Numerics, the lanes' contract (accl_tpu_torch/ops/lane_kernels.py), as
// XLA computes the TPU kernel's combine: signed integer SUM wraps (added
// as unsigned); in f32, f64 and bf16 every operand and every result
// smaller in magnitude than FLT_MIN (DBL_MIN) is flushed to a zero of its
// own sign, written out in code (flush()) with the source built without
// -ftz; fp16/bf16 combine in float and round to T after every combine
// (the TPU's comm slot holds T); MAX is the IEEE maximum: NaN propagates
// (the first operand's, so the order combine(acc, x[rank]) is kept) and
// +0 is above -0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // rank rows loaded ahead of the fold
constexpr long long kMaxBlocks = 1LL << 24;  // beyond: grid-stride
constexpr long long kChunkAlign = 1024;  // chunk_elems rounds to this

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

// One vector of VEC elements of one rank row, moved as one load or store
// of its raw bits.
template <int BYTES>
struct Raw;
template <>
struct Raw<2> {
  using type = unsigned short;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<8> {
  using type = unsigned long long;
};
template <>
struct Raw<16> {
  using type = uint4;
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  const R raw = __ldg(reinterpret_cast<const R*>(p));
  Pack<T, VEC> out;
  memcpy(&out, &raw, sizeof(R));
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& v) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  R raw;
  memcpy(&raw, &v, sizeof(R));
  *reinterpret_cast<R*>(p) = raw;
}

// The fold of one vector over the W rank rows, starting at rank `first`
// and stepping by `step` (+1 forward, -1 backward) around the ring, then
// its store to every output row.
template <typename T, int OP, int VEC>
__device__ __forceinline__ void fold_store(const T* x, T* out,
                                           long long ld_in, long long ld_out,
                                           int world, int first, int step) {
  Pack<T, VEC> acc;
  int rank = first;
  for (int base = 0; base < world; base += kBatch) {
    Pack<T, VEC> v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (base + k < world) v[k] = load<T, VEC>(x + rank * ld_in);
      rank += step;
      rank = rank == world ? 0 : (rank < 0 ? world - 1 : rank);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (base + k >= world) break;
      if (base + k == 0) {
        acc = v[0];
        continue;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc.v[e] = combine<T, OP>(acc.v[e], v[k].v[e]);
    }
  }
  for (int r = 0; r < world; ++r) store<T, VEC>(out + r * ld_out, acc);
}

// The whole fold of one launch: every vector of the n columns, over the
// W rank rows of x, stored to the W rows of out.
template <typename T, int OP, int DIRS, int VEC>
__device__ __forceinline__ void ring_fold(const T* __restrict__ x,
                                          T* __restrict__ out,
                                          long long ld_in, long long ld_out,
                                          long long n, int world,
                                          long long chunk) {
  const long long vecs = (n + VEC - 1) / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i =
           static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < vecs; i += stride) {
    const long long p = i * VEC;
    // chunk index along the padded row: direction q / W, chunk q % W
    const int q = static_cast<int>(p / chunk);
    const int d = DIRS == 1 ? 0 : q / world;
    const int c = q - d * world;
    const int step = d == 0 ? 1 : -1;
    int first = c + step;
    first = first == world ? 0 : (first < 0 ? world - 1 : first);
    if (VEC == 1 || p + VEC <= n) {
      fold_store<T, OP, VEC>(x + p, out + p, ld_in, ld_out, world, first,
                             step);
    } else {  // the ragged tail of the vector instantiation
      for (long long e = p; e < n; ++e)
        fold_store<T, OP, 1>(x + e, out + e, ld_in, ld_out, world, first,
                             step);
    }
  }
}

// The direct entry: base pointers as kernel arguments.
template <typename T, int OP, int DIRS, int VEC>
__global__ void __launch_bounds__(kThreads)
    ring_allreduce_kernel(const T* __restrict__ x, T* __restrict__ out,
                          long long ld_in, long long ld_out, long long n,
                          int world, long long chunk) {
  ring_fold<T, OP, DIRS, VEC>(x, out, ld_in, ld_out, n, world, chunk);
}

// One launch's base pointers in a device table (the indirect entry).
template <typename T>
struct RingEntry {
  const T* x;
  T* out;
};

// The indirect entry: the same fold, its two base pointers read from a
// table entry when the launch runs, once a block. A launch captured into a
// CUDA graph keeps its entry's address, so the host points a replay at
// other tensors by rewriting the entry before it, without a re-capture.
template <typename T, int OP, int DIRS, int VEC>
__global__ void __launch_bounds__(kThreads)
    ring_allreduce_kernel_indirect(const RingEntry<T>* __restrict__ entry,
                                   long long ld_in, long long ld_out,
                                   long long n, int world, long long chunk) {
  __shared__ RingEntry<T> e;
  if (threadIdx.x == 0) e = *entry;
  __syncthreads();
  ring_fold<T, OP, DIRS, VEC>(e.x, e.out, ld_in, ld_out, n, world, chunk);
}

// entry != nullptr takes the indirect entry (x and out unused).
template <typename T, int OP, int DIRS, int VEC>
cudaError_t launch(const T* x, T* out, const RingEntry<T>* entry,
                   long long ld_in, long long ld_out, long long n, int world,
                   long long chunk, cudaStream_t stream) {
  long long blocks = ((n + VEC - 1) / VEC + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  if (entry)
    ring_allreduce_kernel_indirect<T, OP, DIRS, VEC>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            entry, ld_in, ld_out, n, world, chunk);
  else
    ring_allreduce_kernel<T, OP, DIRS, VEC>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            x, out, ld_in, ld_out, n, world, chunk);
  return cudaGetLastError();
}

__host__ bool aligned16(const void* p, long long row_stride, int itemsize) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (row_stride * itemsize) % 16 == 0;
}

// entryv != nullptr: the indirect entry, whose pointers the host cannot
// see; its caller vouches for their alignment.
template <typename T>
cudaError_t dispatch(int op, int dirs, int vec, const void* xv, void* outv,
                     const void* entryv, long long ld_in, long long ld_out,
                     long long n, int world, long long chunk,
                     cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  const RingEntry<T>* entry = static_cast<const RingEntry<T>*>(entryv);
  if (world < 1 || n < 0 || (n > 0 && (chunk < 1 || chunk % kChunkAlign ||
                                       chunk * dirs * world < n)))
    return cudaErrorInvalidValue;
  if (vec && !entry &&
      !(aligned16(x, ld_in, sizeof(T)) && aligned16(out, ld_out, sizeof(T))))
    return cudaErrorMisalignedAddress;
#define ACCL_RING_LAUNCH(OP, DIRS)                                           \
  return vec ? launch<T, OP, DIRS, kVec>(x, out, entry, ld_in, ld_out, n,  \
                                         world, chunk, s)                    \
             : launch<T, OP, DIRS, 1>(x, out, entry, ld_in, ld_out, n,      \
                                      world, chunk, s)
  if (op == kSum && dirs == 2) ACCL_RING_LAUNCH(kSum, 2);
  if (op == kSum && dirs == 1) ACCL_RING_LAUNCH(kSum, 1);
  if (op == kMax && dirs == 2) ACCL_RING_LAUNCH(kMax, 2);
  if (op == kMax && dirs == 1) ACCL_RING_LAUNCH(kMax, 1);
#undef ACCL_RING_LAUNCH
  return cudaErrorInvalidValue;
}

int by_dtype(int dtype, int op, int dirs, int vec, const void* x, void* out,
             const void* entry, long long ld_in, long long ld_out,
             long long n, int world, long long chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch<float>(op, dirs, vec, x, out, entry, ld_in, ld_out, n,
                             world, chunk, s);
    case kFloat64:
      return dispatch<double>(op, dirs, vec, x, out, entry, ld_in, ld_out, n,
                              world, chunk, s);
    case kInt32:
      return dispatch<int32_t>(op, dirs, vec, x, out, entry, ld_in, ld_out,
                               n, world, chunk, s);
    case kInt64:
      return dispatch<int64_t>(op, dirs, vec, x, out, entry, ld_in, ld_out,
                               n, world, chunk, s);
    case kFloat16:
      return dispatch<__half>(op, dirs, vec, x, out, entry, ld_in, ld_out, n,
                              world, chunk, s);
    case kBFloat16:
      return dispatch<__nv_bfloat16>(op, dirs, vec, x, out, entry, ld_in,
                                     ld_out, n, world, chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// vec != 0 takes the 16-byte vector instantiation (the wrapper chooses it
// when both base pointers and both row strides are 16-byte multiples; a
// misaligned operand is refused); 0 the scalar one.
extern "C" int accl_ring_allreduce(int dtype, int op, int dirs, int vec,
                                   const void* x, void* out, long long ld_in,
                                   long long ld_out, long long n, int world,
                                   long long chunk, void* stream) {
  return by_dtype(dtype, op, dirs, vec, x, out, nullptr, ld_in, ld_out, n,
                  world, chunk, stream);
}

// The indirect entry: `entry` is the device address of one {x, out} pair
// of 64-bit pointers, read when the launch runs. vec != 0 takes the vector
// instantiation without a check: the caller makes sure both base pointers
// the entry will hold are 16-byte multiples, as are both row strides.
// n == 0 launches one block that reads the entry and stores nothing.
extern "C" int accl_ring_allreduce_indirect(int dtype, int op, int dirs,
                                            int vec, const void* entry,
                                            long long ld_in, long long ld_out,
                                            long long n, int world,
                                            long long chunk, void* stream) {
  if (!entry) return cudaErrorInvalidValue;
  return by_dtype(dtype, op, dirs, vec, nullptr, nullptr, entry, ld_in,
                  ld_out, n, world, chunk, stream);
}

extern "C" const char* accl_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
