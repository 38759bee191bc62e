// Paged decode attention over int8 K/V pages for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::paged_attention_quant_bjgn
// (body _paged_quant_kernel): single-token attention for each (row b, KV
// head j) over int8 K/V that live in a shared physical page pool, addressed
// through the row's block table, with one f32 scale per (entry, KV head)
// dequantized inside the kernel.
//
//   q        (B, J, G, N)     pre-scaled queries, f32 or bf16
//   kp, vp   (P, page, J, N)  int8 page pool
//   ksc, vsc (P, page, J)     f32 scales: k = kp * ksc, v = vp * vsc
//   table    (B, M) int32     logical page -> physical page
//   lengths  (B,)   int32     live entries per row
//   out      (B, J, G, N)     q's dtype
//
// Bound: bytes.  Per layer the kernel must read
// sum_b lengths_b * J * (N + 4) * 2 (K and V with their scales) bytes of
// the pool, once, at 3.35 TB/s: about half the bytes of the bf16 kernel
// (paged_attention.cu).  It does G multiply-adds per byte, far below the
// card's ~295 operations per byte, so the operations never bound it.
//
// What the design does about it: it is the bf16 kernel's design reading
// int8 values.
//   * each live K/V byte and each live scale is read exactly once, straight
//     from its physical page through the block table, which the block
//     reads itself; no gathered or dequantized page is ever written, and
//     pages at or past a row's length are never read;
//   * dequantization happens in registers: the score of a token is
//     ksc * (q . k_int8) and its value contribution p * vsc * v_int8, one
//     scale multiply per token and head instead of one per element;
//   * one block per (b, j) holds the G queries of the GQA group in f32 and
//     shares every K/V load between them;
//   * the online softmax (running max, denominator, accumulator) stays in
//     registers in f32, as the TPU kernel keeps it in VMEM scratch.
//
// Layout of the work: blockIdx = (j, b); kWarps warps split the row's live
// tokens round-robin; per token each warp computes the G dot products over
// N with a warp reduction (each lane holds NPL = N/32 elements) and updates
// its own online-softmax state; the warps' states are merged through
// shared memory at the end.  The same NEG_INF (-1e30) start and the
// acc / max(l, 1e-30) finalize as the TPU kernel.  A released row (table
// row at the scratch page, length running past the table) has its page
// count clamped to M.
//
// Known limit: the same as the bf16 kernel's.  The grid is B x J blocks
// (40 at B = 8, J = 5) on 132 SMs, and the longest row's tokens form a
// serial chain per warp; the int8 loads are 1 byte a lane.  Splitting a
// row's pages across blocks and vectorised loads are later changes.
//
// The block-table entries are trusted: the host-side allocator
// (serve/kvpool.py) only hands out pages in [0, P).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxG = 8;       // mirrored as MAX_G in kernel.py
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int NPL>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_quant_kernel(const T* __restrict__ q,
                             const int8_t* __restrict__ kp,
                             const int8_t* __restrict__ vp,
                             const float* __restrict__ ksc,
                             const float* __restrict__ vsc,
                             const int* __restrict__ table,
                             const int* __restrict__ lengths,
                             T* __restrict__ out, int J, int G, int N,
                             int page, int M) {
  extern __shared__ float smem[];
  float* q_s = smem;                       // [G][N]
  float* m_s = q_s + G * N;                // [kWarps][G]
  float* l_s = m_s + kWarps * G;           // [kWarps][G]
  float* acc_s = l_s + kWarps * G;         // [kWarps][G][N]

  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t head = (static_cast<size_t>(b) * J + j) * G * N;

  for (int e = threadIdx.x; e < G * N; e += blockDim.x)
    q_s[e] = to_float(q[head + e]);
  __syncthreads();

  float qr[kMaxG][NPL];
  float acc[kMaxG][NPL];
  float m_run[kMaxG];
  float l_run[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = (g < G && d < N) ? q_s[g * N + d] : 0.f;
      acc[g][i] = 0.f;
    }
  }

  const int length = lengths[b];
  int n_pages = length > 0 ? (length + page - 1) / page : 0;
  if (n_pages > M) n_pages = M;
  const size_t entry = static_cast<size_t>(J) * N;   // values per entry
  for (int m = 0; m < n_pages; ++m) {
    const size_t phys = static_cast<size_t>(table[static_cast<size_t>(b) * M + m]);
    const int live = min(page, length - m * page);
    const int8_t* kpage = kp + phys * page * entry + static_cast<size_t>(j) * N;
    const int8_t* vpage = vp + phys * page * entry + static_cast<size_t>(j) * N;
    const float* kspage = ksc + phys * page * J + j;
    const float* vspage = vsc + phys * page * J + j;
    for (int o = warp; o < live; o += kWarps) {
      const int8_t* kr = kpage + o * entry;
      const int8_t* vr = vpage + o * entry;
      const float ks = kspage[static_cast<size_t>(o) * J];
      const float vs = vspage[static_cast<size_t>(o) * J];
      float kv[NPL];
      float vv[NPL];
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int d = lane + 32 * i;
        kv[i] = d < N ? static_cast<float>(kr[d]) : 0.f;
        vv[i] = d < N ? static_cast<float>(vr[d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {                       // uniform across the warp
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < NPL; ++i) s += qr[g][i] * kv[i];
          s = warp_sum(s) * ks;
          const float m_new = fmaxf(m_run[g], s);
          const float corr = expf(m_run[g] - m_new);
          const float p = expf(s - m_new);
          const float pv = p * vs;
          l_run[g] = l_run[g] * corr + p;
#pragma unroll
          for (int i = 0; i < NPL; ++i) acc[g][i] = acc[g][i] * corr + pv * vv[i];
          m_run[g] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      if (lane == 0) {
        m_s[warp * G + g] = m_run[g];
        l_s[warp * G + g] = l_run[g];
      }
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const int d = lane + 32 * i;
        if (d < N) acc_s[(warp * G + g) * N + d] = acc[g][i];
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < G * N; e += blockDim.x) {
    const int g = e / N;
    const int d = e % N;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + g]);
    float l = 0.f;
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w * G + g] - mx);
      l += l_s[w * G + g] * c;
      a += acc_s[(w * G + g) * N + d] * c;
    }
    store(out + head + e, a / fmaxf(l, 1e-30f));
  }
}

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const void* ksc;
  const void* vsc;
  const void* table;
  const void* lengths;
  void* out;
  int B, J, G, N, page, M;
};

template <typename T, int NPL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(a.G) * a.N + 2 * kWarps * a.G +
       static_cast<size_t>(kWarps) * a.G * a.N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_quant_kernel<T, NPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  paged_attention_quant_kernel<T, NPL>
      <<<dim3(a.J, a.B), kWarps * 32, smem, stream>>>(
          static_cast<const T*>(a.q), static_cast<const int8_t*>(a.kp),
          static_cast<const int8_t*>(a.vp), static_cast<const float*>(a.ksc),
          static_cast<const float*>(a.vsc), static_cast<const int*>(a.table),
          static_cast<const int*>(a.lengths), static_cast<T*>(a.out), a.J,
          a.G, a.N, a.page, a.M);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.N <= 32) return launch<T, 1>(a, s);
  if (a.N <= 64) return launch<T, 2>(a, s);
  if (a.N <= 128) return launch<T, 4>(a, s);
  return launch<T, 8>(a, s);
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16.  Returns the CUDA error
// code of the launch (0 on success); the caller raises on anything else.
extern "C" int repro_paged_attention_quant(
    int dtype, const void* q, const void* kp, const void* vp, const void* ksc,
    const void* vsc, const void* table, const void* lengths, void* out, int B,
    int J, int G, int N, int page, int M, void* stream) {
  if (B <= 0 || J <= 0) return static_cast<int>(cudaSuccess);
  if (G < 1 || G > kMaxG || N < 1 || N > 256 || page < 1 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, kp, vp, ksc, vsc, table, lengths, out, B, J, G, N, page, M};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(a, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(a, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
