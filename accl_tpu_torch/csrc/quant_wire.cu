// Blockwise int8 wire kernels (compressor lanes 4/5) for Hopper.
//
// Replace the Pallas TPU kernels of accl_tpu/ops/pallas_kernels.py:
//   quantize_kernel           quantize_pallas (_quantize_kernel)
//   dequantize_kernel         dequantize_pallas (_dequantize_kernel)
//   dequant_combine_kernel    fused_dequant_combine_pallas
//                             (_fused_dq_combine_kernel, requant=False)
//   dequant_combine_kernel    fused_dequant_combine_quant_pallas
//     <REQUANT=true>          (_fused_dq_combine_kernel, requant=True)
//
// Every kernel takes a stacked (rows, n) operand with row strides (one
// virtual rank per row) and computes per row. A row's n elements are cut
// into 256-element scale blocks (the last one ragged); codes keep the
// row's length, scales are ceil(n/256) per row.
//
// Numerics (the plain versions in accl_tpu_torch/ops/compression.py are
// the contract, bitwise):
//   - subnormals flush: each fp32 input (payload, scale, local operand)
//     and each fp32 result below FLT_MIN in magnitude becomes a zero of
//     its own sign, written out in code (flush()), as XLA on the CPU and
//     a TPU do; the source is built without -ftz so nothing else flushes;
//   - scale = flush(amax * fp32(1/127)), amax NaN-propagating (fmaxf
//     alone would drop a NaN); q = rint(x / scale) with a correctly
//     rounded divide, clamped to +-127; a block whose scale is not > 0
//     encodes as zeros; a NaN quotient (Inf / Inf) encodes as 0 (a C++
//     cast of NaN to an integer is undefined);
//   - decode is one multiply, (float)q * scale;
//   - SUM decode+combine rounds once: fmaf(q, scale, local), the fused
//     multiply-add XLA contracts the JAX reference into under jit;
//   - MAX is the IEEE maximum of the decoded value and the local operand:
//     NaN propagates, +0 is above -0 (jnp.maximum).
//
// Design. One warp per scale block: each lane holds 8 of the block's 256
// elements (lane + 32k, so each warp load is 32 neighbouring elements),
// the block's max-abs is a 5-step shuffle reduction, and lane 0 writes
// the scale. The TPU kernel held 256 blocks per grid step in VMEM; here a
// 256-thread CTA holds 8 blocks and there are ceil(rows*nb/8) CTAs, so a
// (8, 131072) ring chunk fills the card with 512 CTAs. The fused ring
// step keeps the decoded, combined block in registers between the
// combine and the re-encode: one read of each input, one write of each
// output.
//
// Bound: bytes. Per row, quantize reads 4n and writes n + 4*nb bytes;
// dequantize reads n + 4*nb and writes 4n; the fused combine reads
// n + 4*nb + 4n and writes 4n; the fused requantize reads n + 4*nb + 4n
// and writes n + 4*nb. At the main path's (8, 131072) shape each moves
// 5-9 MB, a few microseconds at 3.35 TB/s, so a launch is dominated by
// its fixed cost; vector loads and fusing launches are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;           // QUANT_BLOCK_ELEMS
constexpr int kPerLane = kBlock / 32;  // elements of a block per lane
constexpr int kWarps = 8;             // scale blocks per CTA
constexpr int kThreads = 32 * kWarps;
constexpr float kQmax = 127.0f;
constexpr float kInvQmax = 0x1.020408p-7f;  // fp32(1) / fp32(127)
constexpr float kFltMin = 0x1.0p-126f;
constexpr unsigned kFull = 0xffffffffu;

enum : int { kSum = 0, kMax = 1 };

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < kFltMin ? copysignf(0.0f, v) : v;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float max_ieee(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  if (a == 0.0f && b == 0.0f) return __fadd_rn(a, b);  // -0 only if both
  return a > b ? a : b;
}

// The block's scale from every lane's values (padding lanes hold 0).
__device__ __forceinline__ float block_scale(const float (&v)[kPerLane]) {
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) m = nan_max(m, fabsf(v[k]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(kFull, m, off));
  return flush(__fmul_rn(m, kInvQmax));
}

__device__ __forceinline__ int8_t encode(float v, float scale) {
  if (!(scale > 0.0f)) return 0;  // zero or NaN scale
  float r = rintf(__fdiv_rn(v, scale));
  if (r != r) return 0;
  r = fminf(fmaxf(r, -kQmax), kQmax);
  return static_cast<int8_t>(static_cast<int>(r));
}

// Where warp `warp` of the grid works: its row, its block, and whether it
// has one (trailing warps of the last CTA do not).
struct Block {
  long long row, base;
  bool live;
};

__device__ __forceinline__ Block my_block(long long rows, long long nb) {
  const long long g = static_cast<long long>(blockIdx.x) * kWarps +
                      threadIdx.x / 32;
  Block b;
  b.live = g < rows * nb;
  b.row = b.live ? g / nb : 0;
  b.base = b.live ? (g - b.row * nb) * kBlock : 0;
  return b;
}

__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x, long long ld_x,
                    int8_t* __restrict__ q, long long ld_q,
                    float* __restrict__ s, long long ld_s, long long rows,
                    long long n, long long nb) {
  const Block b = my_block(rows, nb);
  if (!b.live) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  float v[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const long long j = b.base + k * 32 + lane;
    v[k] = j < n ? flush(x[b.row * ld_x + j]) : 0.0f;
  }
  const float scale = block_scale(v);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const long long j = b.base + k * 32 + lane;
    if (j < n) q[b.row * ld_q + j] = encode(v[k], scale);
  }
  if (lane == 0) s[b.row * ld_s + b.base / kBlock] = scale;
}

__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int8_t* __restrict__ q, long long ld_q,
                      const float* __restrict__ s, long long ld_s,
                      float* __restrict__ out, long long ld_out,
                      long long rows, long long n, long long nb) {
  const Block b = my_block(rows, nb);
  if (!b.live) return;
  const int lane = threadIdx.x & 31;
  const float scale = flush(s[b.row * ld_s + b.base / kBlock]);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const long long j = b.base + k * 32 + lane;
    if (j < n)
      out[b.row * ld_out + j] =
          __fmul_rn(static_cast<float>(q[b.row * ld_q + j]), scale);
  }
}

// Decode the arriving (codes, scales), combine with the local operand;
// REQUANT re-encodes the combined block (the interior ring step), else
// the fp32 result is stored (the terminal hop).
template <int OP, bool REQUANT>
__global__ void __launch_bounds__(kThreads)
    dequant_combine_kernel(const int8_t* __restrict__ q, long long ld_q,
                           const float* __restrict__ s, long long ld_s,
                           const float* __restrict__ local, long long ld_l,
                           float* __restrict__ out, long long ld_out,
                           int8_t* __restrict__ q_out, long long ld_qo,
                           float* __restrict__ s_out, long long ld_so,
                           long long rows, long long n, long long nb) {
  const Block b = my_block(rows, nb);
  if (!b.live) return;
  const int lane = threadIdx.x & 31;
  const float scale = flush(s[b.row * ld_s + b.base / kBlock]);
  float v[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const long long j = b.base + k * 32 + lane;
    v[k] = 0.0f;
    if (j < n) {
      const float code = static_cast<float>(q[b.row * ld_q + j]);
      const float loc = flush(local[b.row * ld_l + j]);
      if constexpr (OP == kSum) {
        v[k] = flush(__fmaf_rn(code, scale, loc));
      } else {
        v[k] = max_ieee(__fmul_rn(code, scale), loc);
      }
    }
  }
  if constexpr (!REQUANT) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const long long j = b.base + k * 32 + lane;
      if (j < n) out[b.row * ld_out + j] = v[k];
    }
  } else {
    const float scale_out = block_scale(v);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const long long j = b.base + k * 32 + lane;
      if (j < n) q_out[b.row * ld_qo + j] = encode(v[k], scale_out);
    }
    if (lane == 0) s_out[b.row * ld_so + b.base / kBlock] = scale_out;
  }
}

inline unsigned grid_for(long long rows, long long nb) {
  return static_cast<unsigned>((rows * nb + kWarps - 1) / kWarps);
}

inline long long blocks_of(long long n) { return (n + kBlock - 1) / kBlock; }

template <int OP, bool REQUANT>
cudaError_t launch_combine(const int8_t* q, long long ld_q, const float* s,
                           long long ld_s, const float* local, long long ld_l,
                           float* out, long long ld_out, int8_t* q_out,
                           long long ld_qo, float* s_out, long long ld_so,
                           long long rows, long long n, cudaStream_t stream) {
  const long long nb = blocks_of(n);
  dequant_combine_kernel<OP, REQUANT><<<grid_for(rows, nb), kThreads, 0,
                                        stream>>>(
      q, ld_q, s, ld_s, local, ld_l, out, ld_out, q_out, ld_qo, s_out, ld_so,
      rows, n, nb);
  return cudaGetLastError();
}

template <bool REQUANT>
cudaError_t dispatch_combine(int op, const int8_t* q, long long ld_q,
                             const float* s, long long ld_s,
                             const float* local, long long ld_l, float* out,
                             long long ld_out, int8_t* q_out, long long ld_qo,
                             float* s_out, long long ld_so, long long rows,
                             long long n, cudaStream_t stream) {
  if (op == kSum)
    return launch_combine<kSum, REQUANT>(q, ld_q, s, ld_s, local, ld_l, out,
                                         ld_out, q_out, ld_qo, s_out, ld_so,
                                         rows, n, stream);
  if (op == kMax)
    return launch_combine<kMax, REQUANT>(q, ld_q, s, ld_s, local, ld_l, out,
                                         ld_out, q_out, ld_qo, s_out, ld_so,
                                         rows, n, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int accl_quantize(const void* x, long long ld_x, void* q,
                             long long ld_q, void* s, long long ld_s,
                             long long rows, long long n, void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  const long long nb = blocks_of(n);
  quantize_kernel<<<grid_for(rows, nb), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ld_x, static_cast<int8_t*>(q), ld_q,
      static_cast<float*>(s), ld_s, rows, n, nb);
  return cudaGetLastError();
}

extern "C" int accl_dequantize(const void* q, long long ld_q, const void* s,
                               long long ld_s, void* out, long long ld_out,
                               long long rows, long long n, void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  const long long nb = blocks_of(n);
  dequantize_kernel<<<grid_for(rows, nb), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), ld_q, static_cast<const float*>(s), ld_s,
      static_cast<float*>(out), ld_out, rows, n, nb);
  return cudaGetLastError();
}

extern "C" int accl_dequant_combine(int op, const void* q, long long ld_q,
                                    const void* s, long long ld_s,
                                    const void* local, long long ld_l,
                                    void* out, long long ld_out,
                                    long long rows, long long n,
                                    void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  return dispatch_combine<false>(
      op, static_cast<const int8_t*>(q), ld_q, static_cast<const float*>(s),
      ld_s, static_cast<const float*>(local), ld_l, static_cast<float*>(out),
      ld_out, nullptr, 0, nullptr, 0, rows, n,
      static_cast<cudaStream_t>(stream));
}

extern "C" int accl_dequant_combine_requant(
    int op, const void* q, long long ld_q, const void* s, long long ld_s,
    const void* local, long long ld_l, void* q_out, long long ld_qo,
    void* s_out, long long ld_so, long long rows, long long n, void* stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  return dispatch_combine<true>(
      op, static_cast<const int8_t*>(q), ld_q, static_cast<const float*>(s),
      ld_s, static_cast<const float*>(local), ld_l, nullptr, 0,
      static_cast<int8_t*>(q_out), ld_qo, static_cast<float*>(s_out), ld_so,
      rows, n, static_cast<cudaStream_t>(stream));
}

extern "C" const char* accl_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
