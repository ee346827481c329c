// The expert-parallel MoE layer's two kernels for Hopper: the grouped
// SwiGLU expert product and the count-driven row exchange of its dispatch
// and combine.
//
// Neither replaces a Pallas kernel: the JAX package routes its MoE with
// capacity slots of a fixed shape and lets XLA contract every slot, full
// or empty. A dropless layer sizes its buffers for the worst case that
// routing allows (every token of every rank to one held expert) and lets
// the router's counts, written on the card inside the same graph replay,
// decide how many rows each expert computes and which rows move. A
// fixed-shape torch op over those buffers would compute and move the
// worst case, 32x the mean rows at 128 tokens a rank over 32 held
// experts; these kernels read the counts and touch only counted rows.
//
// moe_expert_gemm_kernel<DUAL> (accl_moe_expert_gemm)
//   C[r, n] = sum_k A[r, k] * B_e[n, k] over the rows r of each expert e
//   (starts[e] .. starts[e] + rows[e], device ints), B_e = B + e*wstride
//   in the (out, in) layout of a linear layer's weight. DUAL takes a
//   second weight B2 and writes silu(A B^T) * (A B2^T), the SwiGLU's
//   gate and up projections in one pass over A; the down projection is
//   the plain form. Products and sums are float32 FMAs, no TF32 (TF32
//   products would put the result some 2^13 float32 half-ulps off, past
//   the check's limit). SiLU is g / (1 + expf(-g)).
//   Bound: at the mean load (32 rows an expert) the weights: every
//   expert with rows streams its 3 * D * F floats once, 176 MB an expert
//   at DeepSeek-V3's widths, over 3.35 TB/s; a hot expert (128 rows and
//   more) is bound by its 6 * rows * D * F flops over the 67 TFLOP/s of
//   the card's float32 FMA units.
//   Design: 32-row by 128-column output tiles, 128 threads, each thread a
//   4 x 8 block of outputs (4 x 8 twice for DUAL) kept in registers; the
//   K loop walks 16 columns at a time through shared memory, double
//   buffered, the next tile's global loads issued before the current
//   tile's FMAs. 32 rows is about where the card's FMA rate and memory
//   rate balance for a weight-streaming product (32 FMAs per weight
//   float), so a typical expert streams its weights once and a hot one
//   re-reads them per 32-row tile, from L2 where the tiles of one
//   column tile run together (the row tile is blockIdx.x, the fastest
//   index of the launch order). The grid is sized for the worst case
//   (max_rows / 32 row tiles an expert); a block past its expert's count
//   returns at once, which a graph replay cannot avoid without a host
//   read of the counts.
//
// moe_dispatch_rows_kernel (accl_moe_dispatch_rows)
//   out[slot_row[s, t, k]] = x[s, t] for every routing slot whose row is
//   not negative: each token row goes to the rows of its held experts.
// moe_combine_rows_kernel (accl_moe_combine_rows)
//   out[s, t] = sum over k of gate[s, t, k] * eo[slot_row[s, t, k]], in
//   slot order, one fmaf each, over the slots whose row is not negative;
//   a token with none gets zeros.
//   Bound: bytes, each counted row read once and written once (the
//   combine writes every token row, counted or not).
//   Design: one block a slot (dispatch) or a token (combine), 256
//   threads walking the row in 16-byte accesses; a slot whose row is
//   negative returns at once.
//
// Every entry point returns the launch's cudaError (0 on success) and
// refuses shapes and alignments the kernels do not take. The counts and
// rows come from the card, so each kernel clamps them to the rows its
// buffers hold: a wrong count gives wrong rows, never a wild access.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;
constexpr int kBN = 128;
constexpr int kBK = 16;
constexpr int kThreads = 128;
constexpr int kApad = kBM + 4;
constexpr int kBpad = kBN + 4;

__device__ __forceinline__ float silu(float g) {
  return g / (1.0f + expf(-g));
}

template <bool DUAL>
__global__ void __launch_bounds__(kThreads)
    moe_expert_gemm_kernel(const float* __restrict__ A, long long lda,
                           const float* __restrict__ B,
                           const float* __restrict__ B2, long long wstride,
                           float* __restrict__ C, long long ldc,
                           const int* __restrict__ starts,
                           const int* __restrict__ rows, long long R, int N,
                           int K) {
  const int e = blockIdx.z;
  // counts written on the card never take a block past the R rows
  const long long first = starts[e];
  const long long want = rows[e], room = R - first;
  const int cnt = first < 0 || first >= R
                      ? 0
                      : static_cast<int>(want < room ? want : room);
  const int m0 = blockIdx.x * kBM;
  if (m0 >= cnt) return;
  const int n0 = blockIdx.y * kBN;
  const int mvalid = min(kBM, cnt - m0);
  const long long row0 = first + m0;
  const float* Bg = B + static_cast<long long>(e) * wstride;
  const float* Bu = DUAL ? B2 + static_cast<long long>(e) * wstride : Bg;

  __shared__ __align__(16) float As[2][kBK][kApad];
  __shared__ __align__(16) float Bs[2][kBK][kBpad];
  __shared__ __align__(16) float Us[DUAL ? 2 : 1][kBK][DUAL ? kBpad : 4];

  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  // global loads: A one float4 a thread, each B four
  const int lr = tid / 4, lk = (tid % 4) * 4;
  const bool a_ok = lr < mvalid;
  const float* a_src = A + (row0 + (a_ok ? lr : 0)) * lda + lk;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 ra, rb[4], ru[4];
  auto load = [&](int k0) {
    ra = a_ok ? *reinterpret_cast<const float4*>(a_src + k0) : zero;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + lr + 32 * j;
      const long long off = static_cast<long long>(n) * K + k0 + lk;
      rb[j] = n < N ? *reinterpret_cast<const float4*>(Bg + off) : zero;
      if constexpr (DUAL)
        ru[j] = n < N ? *reinterpret_cast<const float4*>(Bu + off) : zero;
    }
  };
  auto store = [&](int buf) {
    const float4 a = ra;
    As[buf][lk + 0][lr] = a.x;
    As[buf][lk + 1][lr] = a.y;
    As[buf][lk + 2][lr] = a.z;
    As[buf][lk + 3][lr] = a.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = lr + 32 * j;
      const float4 b = rb[j];
      Bs[buf][lk + 0][n] = b.x;
      Bs[buf][lk + 1][n] = b.y;
      Bs[buf][lk + 2][n] = b.z;
      Bs[buf][lk + 3][n] = b.w;
      if constexpr (DUAL) {
        const float4 u = ru[j];
        Us[buf][lk + 0][n] = u.x;
        Us[buf][lk + 1][n] = u.y;
        Us[buf][lk + 2][n] = u.z;
        Us[buf][lk + 3][n] = u.w;
      }
    }
  };

  float acc[4][8], acc2[4][8];  // acc2: the up projection (DUAL)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = acc2[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int cur = (k0 / kBK) & 1;
    const bool more = k0 + kBK < K;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[cur][kk][tm * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tn * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tn * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      if constexpr (DUAL) {
        const float4 u0 =
            *reinterpret_cast<const float4*>(&Us[cur][kk][tn * 4]);
        const float4 u1 =
            *reinterpret_cast<const float4*>(&Us[cur][kk][64 + tn * 4]);
        const float uv[8] = {u0.x, u0.y, u0.z, u0.w,
                             u1.x, u1.y, u1.z, u1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc2[i][j] = fmaf(av[i], uv[j], acc2[i][j]);
      }
    }
    if (more) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tm * 4 + i;
    if (r >= mvalid) continue;
    float* out = C + (row0 + r) * ldc + n0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * 64 + tn * 4;
      if (n0 + c >= N) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float g = acc[i][h * 4 + j];
        v[j] = DUAL ? silu(g) * acc2[i][h * 4 + j] : g;
      }
      *reinterpret_cast<float4*>(out + c) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

constexpr int kRowThreads = 256;

__global__ void __launch_bounds__(kRowThreads)
    moe_dispatch_rows_kernel(const float* __restrict__ x, long long ldx,
                             float* __restrict__ out,
                             const int* __restrict__ slot_row,
                             long long out_rows, int T, int topk, int D) {
  const long long slot = blockIdx.x;
  const int r = slot_row[slot];
  if (r < 0 || r >= out_rows) return;
  const long long tok = slot / topk;
  const long long s = tok / T, t = tok % T;
  const float4* src = reinterpret_cast<const float4*>(x + s * ldx + t * D);
  float4* dst = reinterpret_cast<float4*>(out + static_cast<long long>(r) * D);
  for (int i = threadIdx.x; i < D / 4; i += kRowThreads) dst[i] = src[i];
}

constexpr int kMaxTopk = 32;

__global__ void __launch_bounds__(kRowThreads)
    moe_combine_rows_kernel(const float* __restrict__ eo,
                            const int* __restrict__ slot_row,
                            const float* __restrict__ gate,
                            float* __restrict__ out, long long ldo,
                            long long eo_rows, int T, int topk, int D) {
  const long long tok = blockIdx.x;
  const long long s = tok / T, t = tok % T;
  __shared__ int rows[kMaxTopk];
  __shared__ float gates[kMaxTopk];
  if (threadIdx.x < topk) {
    const int r = slot_row[tok * topk + threadIdx.x];
    rows[threadIdx.x] = r < eo_rows ? r : -1;
    gates[threadIdx.x] = gate[tok * topk + threadIdx.x];
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(out + s * ldo + t * D);
  for (int i = threadIdx.x; i < D / 4; i += kRowThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < topk; ++k) {
      const int r = rows[k];
      if (r < 0) continue;
      const float g = gates[k];
      const float4 v = reinterpret_cast<const float4*>(
          eo + static_cast<long long>(r) * D)[i];
      acc.x = fmaf(g, v.x, acc.x);
      acc.y = fmaf(g, v.y, acc.y);
      acc.z = fmaf(g, v.z, acc.z);
      acc.w = fmaf(g, v.w, acc.w);
    }
    dst[i] = acc;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool DUAL>
int launch_gemm(const float* A, long long lda, const float* B,
                const float* B2, long long wstride, float* C, long long ldc,
                const int* starts, const int* rows, long long R, int experts,
                int max_rows, int N, int K, cudaStream_t s) {
  dim3 grid((max_rows + kBM - 1) / kBM, (N + kBN - 1) / kBN, experts);
  moe_expert_gemm_kernel<DUAL><<<grid, kThreads, 0, s>>>(
      A, lda, B, B2, wstride, C, ldc, starts, rows, R, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int accl_moe_expert_gemm(int dual, const void* A,
                                    long long lda, const void* B,
                                    const void* B2, long long wstride,
                                    void* C, long long ldc, const void* starts,
                                    const void* rows, long long R,
                                    int experts, int max_rows, int N, int K,
                                    void* stream) {
  if (R < 1 || experts < 1 || max_rows < 1 || N < 1 || K < kBK || K % kBK ||
      N % 4 || lda % 4 || ldc % 4 || wstride % 4 || experts > 65535)
    return cudaErrorInvalidValue;
  if (!aligned16(A) || !aligned16(B) || !aligned16(C) ||
      (dual && !aligned16(B2)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  const float* b2 = static_cast<const float*>(B2);
  float* c = static_cast<float*>(C);
  const int* st = static_cast<const int*>(starts);
  const int* rw = static_cast<const int*>(rows);
  if (dual)
    return launch_gemm<true>(a, lda, b, b2, wstride, c, ldc, st, rw, R,
                             experts, max_rows, N, K, s);
  return launch_gemm<false>(a, lda, b, b, wstride, c, ldc, st, rw, R,
                            experts, max_rows, N, K, s);
}

extern "C" int accl_moe_dispatch_rows(const void* x, long long ldx, void* out,
                                      long long out_rows,
                                      const void* slot_row, long long slots,
                                      int T, int topk, int D, void* stream) {
  if (out_rows < 1 || slots < 1 || T < 1 || topk < 1 || D < 4 || D % 4 || ldx % 4 ||
      slots % (static_cast<long long>(T) * topk) || slots > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(out)) return cudaErrorInvalidValue;
  moe_dispatch_rows_kernel<<<static_cast<unsigned>(slots), kRowThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ldx, static_cast<float*>(out),
      static_cast<const int*>(slot_row), out_rows, T, topk, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int accl_moe_combine_rows(const void* eo, long long eo_rows,
                                     const void* slot_row, const void* gate,
                                     void* out, long long ldo,
                                     long long tokens, int T, int topk, int D,
                                     void* stream) {
  if (eo_rows < 1 || tokens < 1 || T < 1 || topk < 1 || topk > kMaxTopk || D < 4 ||
      D % 4 || ldo % 4 || tokens % T || tokens > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (!aligned16(eo) || !aligned16(out)) return cudaErrorInvalidValue;
  moe_combine_rows_kernel<<<static_cast<unsigned>(tokens), kRowThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(eo), static_cast<const int*>(slot_row),
      static_cast<const float*>(gate), static_cast<float*>(out), ldo, eo_rows,
      T, topk, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* accl_moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
