// The arith and cast lanes for Hopper: elementwise kernels over stacked
// rank rows.
//
// Replace the Pallas TPU kernels of accl_tpu/ops/pallas_kernels.py:
//   combine_kernel       combine_pallas (_combine_kernel): SUM/MAX of two
//                        buffers of one dtype (f32, f64, i32, i64)
//   combine_cast_kernel  fused_combine_cast_pallas (_fused_kernel): both
//                        operands widened to the f32 accumulator, combined,
//                        rounded once to the output dtype (the half lanes)
//   cast_kernel          cast_pallas (_cast_kernel): the streaming dtype
//                        cast of the compression lanes, f32 <-> f16/bf16
//
// Every kernel takes stacked (rows, n) operands with row strides (one
// virtual rank per row, unit stride within a row) and computes per
// element, so one launch serves every rank a schedule step touches.
//
// Numerics (the plain versions in accl_tpu_torch/ops/lane_kernels.py are
// the contract, bitwise), as XLA computes them on the CPU and a TPU:
//   - subnormals flush (FTZ/DAZ) in f32, f64 and bf16 arithmetic: each
//     operand and each result smaller in magnitude than FLT_MIN (DBL_MIN
//     for f64; a bf16 value is checked as the f32 it widens to) is a zero
//     of its own sign. The rule is written out in code (flush()); the
//     source is built without -ftz, so nothing else flushes. f16 operands
//     widen to normal f32 values and a sum of two of them is 0 or at
//     least 2^-24, so the same flush leaves f16 lanes untouched;
//   - MAX is the IEEE maximum: NaN propagates and +0 is above -0;
//   - integer SUM wraps (added as unsigned);
//   - the cast rounds to nearest even and never flushes: f32 1e-39 casts
//     to a bf16 subnormal, f16 overflow gives Inf.
//
// Design. A plain grid-stride loop: blockIdx.y walks the rows, the x
// dimension of the grid strides over a row's n elements, one element per
// thread per step, neighbouring threads on neighbouring addresses. The
// TPU kernels tiled each buffer into (512, 128) VMEM blocks on a
// sequential grid; here nothing carries between blocks, so the tiling
// has nothing to keep and is dropped.
//
// Bound: bytes. Each kernel reads every input element once and writes
// every output element once: combine 3*rows*n*sizeof(T), combine_cast
// rows*n*(2*sizeof(in) + sizeof(out)), cast rows*n*(sizeof(in) +
// sizeof(out)), over 3.35 TB/s. Vector loads (16 bytes a thread) are
// later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;  // over all rows: ~31 per SM on 132 SMs
constexpr float kFltMin = 0x1.0p-126f;
constexpr double kDblMin = 0x1.0p-1022;

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

template <typename T, int OP>
struct Lane;

template <int OP>
struct Lane<float, OP> {
  __device__ static float apply(float a, float b) {
    a = flush(a);
    b = flush(b);
    if constexpr (OP == kSum) return flush(__fadd_rn(a, b));
    return max_ieee(a, b);
  }
};

template <int OP>
struct Lane<double, OP> {
  __device__ static double apply(double a, double b) {
    a = flush(a);
    b = flush(b);
    if constexpr (OP == kSum) return flush(__dadd_rn(a, b));
    return max_ieee(a, b);
  }
};

template <int OP>
struct Lane<int32_t, OP> {
  __device__ static int32_t apply(int32_t a, int32_t b) {
    if constexpr (OP == kSum)
      return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                  static_cast<uint32_t>(b));
    return a > b ? a : b;
  }
};

template <int OP>
struct Lane<int64_t, OP> {
  __device__ static int64_t apply(int64_t a, int64_t b) {
    if constexpr (OP == kSum)
      return static_cast<int64_t>(static_cast<uint64_t>(a) +
                                  static_cast<uint64_t>(b));
    return a > b ? a : b;
  }
};

// Exact widening to the f32 accumulator and the one rounding back.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The (row, column) walk every kernel shares.
#define FOR_EACH_ELEMENT(rows, n)                                        \
  for (long long r = blockIdx.y; r < (rows); r += gridDim.y)             \
    for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + \
                       threadIdx.x;                                      \
         j < (n); j += static_cast<long long>(gridDim.x) * blockDim.x)

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const T* __restrict__ a, long long lda,
                   const T* __restrict__ b, long long ldb, T* __restrict__ out,
                   long long ldo, long long rows, long long n) {
  FOR_EACH_ELEMENT(rows, n) {
    out[r * ldo + j] = Lane<T, OP>::apply(a[r * lda + j], b[r * ldb + j]);
  }
}

template <typename TI, typename TO, int OP>
__global__ void __launch_bounds__(kThreads)
    combine_cast_kernel(const TI* __restrict__ a, long long lda,
                        const TI* __restrict__ b, long long ldb,
                        TO* __restrict__ out, long long ldo, long long rows,
                        long long n) {
  FOR_EACH_ELEMENT(rows, n) {
    const float v =
        Lane<float, OP>::apply(widen(a[r * lda + j]), widen(b[r * ldb + j]));
    out[r * ldo + j] = narrow<TO>(v);
  }
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
    cast_kernel(const TI* __restrict__ x, long long ldx, TO* __restrict__ out,
                long long ldo, long long rows, long long n) {
  FOR_EACH_ELEMENT(rows, n) {
    out[r * ldo + j] = narrow<TO>(widen(x[r * ldx + j]));
  }
}

dim3 grid_for(long long rows, long long n) {
  const long long y = rows < 65535 ? rows : 65535;
  long long x = (n + kThreads - 1) / kThreads;
  long long cap = kMaxBlocks / y;
  if (cap < 1) cap = 1;
  if (x > cap) x = cap;
  return dim3(static_cast<unsigned>(x), static_cast<unsigned>(y));
}

template <typename T>
cudaError_t launch_combine(int op, const void* a, long long lda, const void* b,
                           long long ldb, void* out, long long ldo,
                           long long rows, long long n, cudaStream_t s) {
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* op_ = static_cast<T*>(out);
  if (op == kSum)
    combine_kernel<T, kSum><<<grid_for(rows, n), kThreads, 0, s>>>(
        ap, lda, bp, ldb, op_, ldo, rows, n);
  else if (op == kMax)
    combine_kernel<T, kMax><<<grid_for(rows, n), kThreads, 0, s>>>(
        ap, lda, bp, ldb, op_, ldo, rows, n);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t launch_combine_cast(int op, const void* a, long long lda,
                                const void* b, long long ldb, void* out,
                                long long ldo, long long rows, long long n,
                                cudaStream_t s) {
  const TI* ap = static_cast<const TI*>(a);
  const TI* bp = static_cast<const TI*>(b);
  TO* op_ = static_cast<TO*>(out);
  if (op == kSum)
    combine_cast_kernel<TI, TO, kSum><<<grid_for(rows, n), kThreads, 0, s>>>(
        ap, lda, bp, ldb, op_, ldo, rows, n);
  else if (op == kMax)
    combine_cast_kernel<TI, TO, kMax><<<grid_for(rows, n), kThreads, 0, s>>>(
        ap, lda, bp, ldb, op_, ldo, rows, n);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename TI>
cudaError_t combine_cast_to(int out_dtype, int op, const void* a,
                            long long lda, const void* b, long long ldb,
                            void* out, long long ldo, long long rows,
                            long long n, cudaStream_t s) {
  switch (out_dtype) {
    case kFloat32:
      return launch_combine_cast<TI, float>(op, a, lda, b, ldb, out, ldo,
                                            rows, n, s);
    case kFloat16:
      return launch_combine_cast<TI, __half>(op, a, lda, b, ldb, out, ldo,
                                             rows, n, s);
    case kBFloat16:
      return launch_combine_cast<TI, __nv_bfloat16>(op, a, lda, b, ldb, out,
                                                    ldo, rows, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TI, typename TO>
cudaError_t launch_cast(const void* x, long long ldx, void* out, long long ldo,
                        long long rows, long long n, cudaStream_t s) {
  cast_kernel<TI, TO><<<grid_for(rows, n), kThreads, 0, s>>>(
      static_cast<const TI*>(x), ldx, static_cast<TO*>(out), ldo, rows, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int accl_lane_combine(int dtype, int op, const void* a,
                                 long long lda, const void* b, long long ldb,
                                 void* out, long long ldo, long long rows,
                                 long long n, void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_combine<float>(op, a, lda, b, ldb, out, ldo, rows, n, s);
    case kFloat64:
      return launch_combine<double>(op, a, lda, b, ldb, out, ldo, rows, n, s);
    case kInt32:
      return launch_combine<int32_t>(op, a, lda, b, ldb, out, ldo, rows, n, s);
    case kInt64:
      return launch_combine<int64_t>(op, a, lda, b, ldb, out, ldo, rows, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int accl_lane_combine_cast(int in_dtype, int out_dtype, int op,
                                      const void* a, long long lda,
                                      const void* b, long long ldb, void* out,
                                      long long ldo, long long rows,
                                      long long n, void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kFloat32:
      return combine_cast_to<float>(out_dtype, op, a, lda, b, ldb, out, ldo,
                                    rows, n, s);
    case kFloat16:
      return combine_cast_to<__half>(out_dtype, op, a, lda, b, ldb, out, ldo,
                                     rows, n, s);
    case kBFloat16:
      return combine_cast_to<__nv_bfloat16>(out_dtype, op, a, lda, b, ldb,
                                            out, ldo, rows, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int accl_lane_cast(int in_dtype, int out_dtype, const void* x,
                              long long ldx, void* out, long long ldo,
                              long long rows, long long n, void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kFloat32 && out_dtype == kFloat16)
    return launch_cast<float, __half>(x, ldx, out, ldo, rows, n, s);
  if (in_dtype == kFloat32 && out_dtype == kBFloat16)
    return launch_cast<float, __nv_bfloat16>(x, ldx, out, ldo, rows, n, s);
  if (in_dtype == kFloat16 && out_dtype == kFloat32)
    return launch_cast<__half, float>(x, ldx, out, ldo, rows, n, s);
  if (in_dtype == kBFloat16 && out_dtype == kFloat32)
    return launch_cast<__nv_bfloat16, float>(x, ldx, out, ldo, rows, n, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* accl_lane_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
