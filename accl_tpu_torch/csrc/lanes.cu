// The arith and cast lanes for Hopper: elementwise kernels over stacked
// rank rows.
//
// Replace the Pallas TPU kernels of accl_tpu/ops/pallas_kernels.py:
//   lane_walk<Combine<T, OP>, I, VEC>
//       combine_pallas (_combine_kernel): SUM/MAX of two buffers of one
//       dtype (f32, f64, i32, i64)
//   lane_walk<CombineCast<TI, TO, OP>, I, VEC>
//       fused_combine_cast_pallas (_fused_kernel): both operands widened
//       to the f32 accumulator, combined, rounded once to the output
//       dtype (the half lanes); in and out f32, f16 or bf16
//   lane_walk<Cast<TI, TO>, I, VEC>
//       cast_pallas (_cast_kernel): the streaming dtype cast of the
//       compression lanes, f32 <-> f16/bf16
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
// Bound: bytes. Each kernel reads every input element once and writes
// every output element once: combine 3*rows*n*sizeof(T), combine_cast
// rows*n*(2*sizeof(in) + sizeof(out)), cast rows*n*(sizeof(in) +
// sizeof(out)), over 3.35 TB/s. They do a few operations a byte, so the
// card's memory system is the limit, and what a design controls is how
// many bytes each SM keeps in flight and how few instructions a byte
// costs.
//
// Design (lane_walk, all three lanes). The TPU kernels tiled each buffer
// into (512, 128) VMEM blocks on a sequential grid; here nothing carries
// between blocks, so the tiling has nothing to keep.
//   - A unit is VEC consecutive elements of a row, 1 in the scalar
//     instantiation. In the vector one: 8 for combine_cast and cast (one
//     16-byte access of a f16/bf16 operand, two of a f32 one), and one
//     16-byte access of each operand for combine (4 f32/i32, 2 f64/i64).
//     A thread's accesses of a unit lie back to back, so a warp's access
//     is dense only when it is the unit's one: combine with 8-element
//     units (two or four accesses, each warp access touching every
//     second or fourth 16 bytes) ran at 1.2 and 1.5 TB/s, 2.4x and 1.9x
//     torch.add (lane_ab.py --ab unit). The cast's f32 loads take the
//     same two accesses and it still runs at 3.1 TB/s, so the loss is in
//     the stores (inferred, not profiled); combine_cast's f32 results,
//     off the timed shapes, are stored that way too.
//   - A thread takes one unit at a time (neighbouring threads on
//     neighbouring units), issues every load of it through the read-only
//     path before it converts or combines any, then stores the unit's
//     results in 16-byte stores, and strides by the grid.
//   - Each element is computed by the lane's functor: Lane<T, OP>::apply
//     (combine), narrow<TO>(Lane<float, OP>::apply(widen(a), widen(b)))
//     (combine_cast), narrow<TO>(widen(x)) (cast), element by element:
//     the one rounding and the flush of the rules above.
//   - The wrapper folds rows that lie back to back (every row stride
//     equal to n) into one row, so the kernel mostly sees one long row;
//     blockIdx.y walks the rows of true column views.
//   - Index arithmetic inside a row is 32-bit (I = int) when no index of
//     the walk can pass INT_MAX (fits_int), else 64-bit; a row's base is
//     computed once, in 64 bits. The 32-bit walk was measured faster for
//     combine_cast at the path's shape (lane_ab.py --ab index).
//   - The vector instantiation needs every base pointer, and every row
//     stride in bytes when there is more than one row, to be a 16-byte
//     multiple: the wrapper chooses it, and the entry points refuse a
//     misaligned vector request. The n % VEC elements past a row's last
//     whole unit are done one by one by block 0 of that row, in the same
//     launch.
//   - The grid is sized from the unit count, capped at kWalkMaxBlocks
//     (beyond it the loop strides over the grid).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
// lane_walk: elements of a half lane's unit in the vector instantiation
// and the grid's cap (beyond it: grid-stride)
constexpr int kUnit = 8;
constexpr long long kWalkMaxBlocks = 1LL << 24;
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

// Raw bits of one access of 2, 4, 8 or 16 bytes.
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

// One unit: VEC elements of one row.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC < 16 ? sizeof(T) * VEC : 16) Pack {
  T v[VEC];
};

// A unit's load through the read-only path, in 16-byte accesses (or one
// scalar access), and its store.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_nc(const T* p) {
  Pack<T, VEC> out;
  constexpr int kBytes = sizeof(T) * VEC;
  using R = typename Raw<(kBytes < 16 ? kBytes : 16)>::type;
#pragma unroll
  for (int w = 0; w < (kBytes + 15) / 16; ++w) {
    const R raw = __ldg(reinterpret_cast<const R*>(p) + w);
    memcpy(reinterpret_cast<char*>(&out) + sizeof(R) * w, &raw, sizeof(R));
  }
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& v) {
  constexpr int kBytes = sizeof(T) * VEC;
  using R = typename Raw<(kBytes < 16 ? kBytes : 16)>::type;
#pragma unroll
  for (int w = 0; w < (kBytes + 15) / 16; ++w) {
    R raw;
    memcpy(&raw, reinterpret_cast<const char*>(&v) + sizeof(R) * w,
           sizeof(R));
    reinterpret_cast<R*>(p)[w] = raw;
  }
}

// The per-element functions of the walk's three lanes, each with the
// elements of its vector unit (kVec).
template <typename T, int OP>
struct Combine {
  using In = T;
  using Out = T;
  static constexpr int kInputs = 2;
  static constexpr int kVec = 16 / sizeof(T);  // one 16-byte access
  __device__ static T apply(T a, T b) { return Lane<T, OP>::apply(a, b); }
};

template <typename TI, typename TO, int OP>
struct CombineCast {
  using In = TI;
  using Out = TO;
  static constexpr int kInputs = 2;
  static constexpr int kVec = kUnit;
  __device__ static TO apply(TI a, TI b) {
    return narrow<TO>(Lane<float, OP>::apply(widen(a), widen(b)));
  }
};

template <typename TI, typename TO>
struct Cast {
  using In = TI;
  using Out = TO;
  static constexpr int kInputs = 1;
  static constexpr int kVec = kUnit;
  __device__ static TO apply(TI x, TI) { return narrow<TO>(widen(x)); }
};

// A walk's operands: one or two input row sets (in[1] unused by a
// one-input lane) and the output rows, each with its row stride.
template <typename TI, typename TO>
struct Rows {
  const TI* in[2];
  long long ld_in[2];
  TO* out;
  long long ld_out;
};

template <typename F, typename I, int VEC>
__global__ void __launch_bounds__(kThreads)
    lane_walk(Rows<typename F::In, typename F::Out> ops, long long rows,
              I n) {
  using TI = typename F::In;
  using TO = typename F::Out;
  constexpr int kIn = F::kInputs;
  const I units = n / VEC;
  const I first =
      static_cast<I>(blockIdx.x) * kThreads + static_cast<I>(threadIdx.x);
  const I step = static_cast<I>(gridDim.x) * kThreads;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const TI* in[kIn];
#pragma unroll
    for (int i = 0; i < kIn; ++i) in[i] = ops.in[i] + r * ops.ld_in[i];
    TO* out = ops.out + r * ops.ld_out;
    for (I u = first; u < units; u += step) {
      Pack<TI, VEC> v[kIn];
#pragma unroll
      for (int i = 0; i < kIn; ++i) v[i] = load_nc<TI, VEC>(in[i] + u * VEC);
      Pack<TO, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = F::apply(v[0].v[e], v[kIn - 1].v[e]);
      store<TO, VEC>(out + u * VEC, o);
    }
    if (VEC > 1 && blockIdx.x == 0) {  // the row's ragged tail
      const I j = units * VEC + static_cast<I>(threadIdx.x);
      if (j < n) out[j] = F::apply(in[0][j], in[kIn - 1][j]);
    }
  }
}

// Whether every index of a walk over rows of n elements, `units` units,
// on x blocks a row, fits an int: the last unit a thread reaches plus
// one grid step, and the last element of the tail.
bool fits_int(long long units, long long x, long long n) {
  return units + x * kThreads <= INT_MAX && n + kThreads <= INT_MAX;
}

template <typename F, typename I>
cudaError_t walk_as(dim3 grid,
                    const Rows<typename F::In, typename F::Out>& ops,
                    long long rows, I n, int vec, cudaStream_t s) {
  if (vec)
    lane_walk<F, I, F::kVec><<<grid, kThreads, 0, s>>>(ops, rows, n);
  else
    lane_walk<F, I, 1><<<grid, kThreads, 0, s>>>(ops, rows, n);
  return cudaGetLastError();
}

// Launch one lane_walk: rows over grid.y (at most 65535, then the loop
// strides), units over grid.x, kWalkMaxBlocks blocks in all.
template <typename F>
cudaError_t launch_walk(const Rows<typename F::In, typename F::Out>& ops,
                        long long rows, long long n, int vec,
                        cudaStream_t s) {
  const long long units = n / (vec ? F::kVec : 1);
  const long long y = rows < 65535 ? rows : 65535;
  long long x = (units + kThreads - 1) / kThreads;
  long long cap = kWalkMaxBlocks / y;
  if (cap < 1) cap = 1;
  if (x < 1) x = 1;  // a row shorter than one unit: its tail alone
  if (x > cap) x = cap;
  const dim3 grid(static_cast<unsigned>(x), static_cast<unsigned>(y));
  if (fits_int(units, x, n))
    return walk_as<F, int>(grid, ops, rows, static_cast<int>(n), vec, s);
  return walk_as<F, long long>(grid, ops, rows, n, vec, s);
}

template <typename TI, typename TO>
Rows<TI, TO> rows_of(const void* a, long long lda, const void* b,
                     long long ldb, void* out, long long ldo) {
  return {{static_cast<const TI*>(a), static_cast<const TI*>(b)},
          {lda, ldb},
          static_cast<TO*>(out),
          ldo};
}

template <typename T>
cudaError_t launch_combine(int op, const void* a, long long lda, const void* b,
                           long long ldb, void* out, long long ldo,
                           long long rows, long long n, int vec,
                           cudaStream_t s) {
  const Rows<T, T> ops = rows_of<T, T>(a, lda, b, ldb, out, ldo);
  if (op == kSum) return launch_walk<Combine<T, kSum>>(ops, rows, n, vec, s);
  if (op == kMax) return launch_walk<Combine<T, kMax>>(ops, rows, n, vec, s);
  return cudaErrorInvalidValue;
}

template <typename TI, typename TO>
cudaError_t launch_combine_cast(int op, const void* a, long long lda,
                                const void* b, long long ldb, void* out,
                                long long ldo, long long rows, long long n,
                                int vec, cudaStream_t s) {
  const Rows<TI, TO> ops = rows_of<TI, TO>(a, lda, b, ldb, out, ldo);
  if (op == kSum)
    return launch_walk<CombineCast<TI, TO, kSum>>(ops, rows, n, vec, s);
  if (op == kMax)
    return launch_walk<CombineCast<TI, TO, kMax>>(ops, rows, n, vec, s);
  return cudaErrorInvalidValue;
}

template <typename TI>
cudaError_t combine_cast_to(int out_dtype, int op, const void* a,
                            long long lda, const void* b, long long ldb,
                            void* out, long long ldo, long long rows,
                            long long n, int vec, cudaStream_t s) {
  switch (out_dtype) {
    case kFloat32:
      return launch_combine_cast<TI, float>(op, a, lda, b, ldb, out, ldo,
                                            rows, n, vec, s);
    case kFloat16:
      return launch_combine_cast<TI, __half>(op, a, lda, b, ldb, out, ldo,
                                             rows, n, vec, s);
    case kBFloat16:
      return launch_combine_cast<TI, __nv_bfloat16>(op, a, lda, b, ldb, out,
                                                    ldo, rows, n, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TI, typename TO>
cudaError_t launch_cast(const void* x, long long ldx, void* out, long long ldo,
                        long long rows, long long n, int vec,
                        cudaStream_t s) {
  return launch_walk<Cast<TI, TO>>(
      rows_of<TI, TO>(x, ldx, nullptr, 0, out, ldo), rows, n, vec, s);
}

// Bytes of an element of a lane dtype code; 0 for any other code.
int lane_bytes(int dtype) {
  switch (dtype) {
    case kFloat64:
    case kInt64:
      return 8;
    case kFloat32:
    case kInt32:
      return 4;
    case kFloat16:
    case kBFloat16:
      return 2;
    default:
      return 0;
  }
}

// What the vector instantiation needs of one operand: a 16-byte-aligned
// base and, when there is more than one row, a row stride of a 16-byte
// multiple.
bool aligned16(const void* p, long long ld, int itemsize, long long rows) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (rows == 1 || (ld * itemsize) % 16 == 0);
}

}  // namespace

// vec != 0 takes the 16-byte vector instantiation (the wrapper chooses it
// when the operands allow it; a misaligned request is refused), 0 the
// scalar one.
extern "C" int accl_lane_combine(int dtype, int op, const void* a,
                                 long long lda, const void* b, long long ldb,
                                 void* out, long long ldo, long long rows,
                                 long long n, int vec, void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  const int bytes = lane_bytes(dtype);
  if (vec && !(aligned16(a, lda, bytes, rows) &&
               aligned16(b, ldb, bytes, rows) &&
               aligned16(out, ldo, bytes, rows)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_combine<float>(op, a, lda, b, ldb, out, ldo, rows, n, vec,
                                   s);
    case kFloat64:
      return launch_combine<double>(op, a, lda, b, ldb, out, ldo, rows, n,
                                    vec, s);
    case kInt32:
      return launch_combine<int32_t>(op, a, lda, b, ldb, out, ldo, rows, n,
                                     vec, s);
    case kInt64:
      return launch_combine<int64_t>(op, a, lda, b, ldb, out, ldo, rows, n,
                                     vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The same vec rule for the two half lanes.
extern "C" int accl_lane_combine_cast(int in_dtype, int out_dtype, int op,
                                      const void* a, long long lda,
                                      const void* b, long long ldb, void* out,
                                      long long ldo, long long rows,
                                      long long n, int vec, void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  const int bi = lane_bytes(in_dtype), bo = lane_bytes(out_dtype);
  if (vec && !(aligned16(a, lda, bi, rows) && aligned16(b, ldb, bi, rows) &&
               aligned16(out, ldo, bo, rows)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kFloat32:
      return combine_cast_to<float>(out_dtype, op, a, lda, b, ldb, out, ldo,
                                    rows, n, vec, s);
    case kFloat16:
      return combine_cast_to<__half>(out_dtype, op, a, lda, b, ldb, out, ldo,
                                     rows, n, vec, s);
    case kBFloat16:
      return combine_cast_to<__nv_bfloat16>(out_dtype, op, a, lda, b, ldb,
                                            out, ldo, rows, n, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int accl_lane_cast(int in_dtype, int out_dtype, const void* x,
                              long long ldx, void* out, long long ldo,
                              long long rows, long long n, int vec,
                              void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  if (vec && !(aligned16(x, ldx, lane_bytes(in_dtype), rows) &&
               aligned16(out, ldo, lane_bytes(out_dtype), rows)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kFloat32 && out_dtype == kFloat16)
    return launch_cast<float, __half>(x, ldx, out, ldo, rows, n, vec, s);
  if (in_dtype == kFloat32 && out_dtype == kBFloat16)
    return launch_cast<float, __nv_bfloat16>(x, ldx, out, ldo, rows, n, vec,
                                             s);
  if (in_dtype == kFloat16 && out_dtype == kFloat32)
    return launch_cast<__half, float>(x, ldx, out, ldo, rows, n, vec, s);
  if (in_dtype == kBFloat16 && out_dtype == kFloat32)
    return launch_cast<__nv_bfloat16, float>(x, ldx, out, ldo, rows, n, vec,
                                             s);
  return cudaErrorInvalidValue;
}

extern "C" const char* accl_lane_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
