// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash/kernel.py:_flash_kernel
// (launched by flash_attention_pallas):
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[b, h / group, j]
// with the queries at the end of the keys (query i sits at key position
// i + Sk - Sq), keys after a query's position masked when causal, the scores,
// the running max and normaliser and the accumulator in float32, and one
// division at the end.  A row with every key masked gives zeros, as the TPU
// kernel's guard does.  Inputs are float32 or bfloat16; the output has q's
// type.  P stays float32 for the P @ V product, as in the TPU kernel.
//
// Bound on the H100: operations.  A causal prefill does about
// 2 Sq Sk (D + Dv) / 2 flops per (batch, head) against (Sq D + Sk (D + Dv) +
// Sq Dv) elements moved, far above the card's operations-per-byte balance at
// the path's lengths (2048 tokens, D = Dv = 112).
//
// Design (a first, simple kernel: float32 FMA on the CUDA cores, no tensor
// cores).  One block of 256 threads per (q tile of 64 rows, q head, batch);
// the TPU's sequential key-block grid axis becomes a loop inside the block
// that stops at the diagonal.  The Q tile, one K and one V tile and the
// probabilities P sit in shared memory as float32, rows padded to an odd
// stride so that the 16 threads reading 16 rows hit 16 banks.  Each thread
// owns a 4 x 4 block of scores (rows 4 tr .. 4 tr + 3, columns tc + 16 j)
// and the same 4 rows of the output accumulator (columns tc + 16 j, j < NJ),
// so every shared-memory load feeds 2 to 4 FMAs.  The online softmax state
// of a row lives in the registers of the 16 threads that share the row and
// is reduced with shuffles inside a half warp.  The ragged edges (Sq, Sk not
// multiples of 64, D and Dv up to 256 and not powers of two) are masked in
// the kernel: rows past Sq are zero and never stored, keys past Sk score
// -inf, V's pad columns are zero.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define FL_THREADS 256
#define FL_BQ 64
#define FL_BK 64
#define FL_MAX_D 256
#define FL_FULL_MASK 0xffffffffu

__device__ __forceinline__ float fl_load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float fl_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void fl_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fl_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// max / sum over the 16 lanes that share a row (lanes tc = 0..15 of a half warp)
__device__ __forceinline__ float fl_row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FL_FULL_MASK, v, o));
  return v;
}
__device__ __forceinline__ float fl_row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FL_FULL_MASK, v, o);
  return v;
}

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sqb, sqh, sqs;  // element strides of q over batch, head, sequence
  long long skb, skh, sks;
  long long svb, svh, svs;
  long long sob, soh, sos;
  int Hq, Hkv, Sq, Sk, D, Dv, causal;
  float scale;
};

template <int NJ>
__host__ __device__ constexpr int fl_ldv() { return 16 * NJ; }

// at most 213,760 bytes (D = Dv = 256): every head dim the kernel takes fits
static size_t fl_smem_bytes(int D, int ldv) {
  return sizeof(float) * ((size_t)FL_BQ * (D + 1) + (size_t)FL_BK * (D + 1) +
                          (size_t)FL_BK * ldv + (size_t)FL_BQ * (FL_BK + 1));
}

template <class T, int NJ>
__global__ void __launch_bounds__(FL_THREADS) flash_fwd_kernel(FlashParams p) {
  extern __shared__ float smem[];
  constexpr int LDV = fl_ldv<NJ>();
  constexpr int LDP = FL_BK + 1;
  const int D = p.D, Dv = p.Dv, LDQ = p.D + 1;
  float* Qs = smem;                 // FL_BQ x LDQ
  float* Ks = Qs + FL_BQ * LDQ;     // FL_BK x LDQ
  float* Vs = Ks + FL_BK * LDQ;     // FL_BK x LDV, columns >= Dv zero
  float* Ps = Vs + FL_BK * LDV;     // FL_BQ x LDP

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = blockIdx.x * FL_BQ;
  const int off = p.Sk - p.Sq;  // query i sits at key position i + off
  const T* q = (const T*)p.q + b * p.sqb + h * p.sqh;
  const T* k = (const T*)p.k + b * p.skb + hk * p.skh;
  const T* v = (const T*)p.v + b * p.svb + hk * p.svh;
  T* o = (T*)p.o + b * p.sob + h * p.soh;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int r0 = tr * 4;  // this thread's 4 rows of the tile

  for (int idx = tid; idx < FL_BQ * D; idx += FL_THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r;
    Qs[r * LDQ + d] = qi < p.Sq ? fl_load(q + qi * p.sqs + d) : 0.0f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  // keys this tile needs: all of them, or (causal) up to its last row's position
  int kend = p.Sk;
  if (p.causal) kend = min(p.Sk, min(q0 + FL_BQ, p.Sq) + off);
  const int ntiles = (kend + FL_BK - 1) / FL_BK;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * FL_BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < FL_BK * D; idx += FL_THREADS) {
      const int r = idx / D, d = idx - r * D;
      const int kj = k0 + r;
      Ks[r * LDQ + d] = kj < p.Sk ? fl_load(k + kj * p.sks + d) : 0.0f;
    }
    for (int idx = tid; idx < FL_BK * LDV; idx += FL_THREADS) {
      const int r = idx / LDV, d = idx - r * LDV;
      const int kj = k0 + r;
      Vs[idx] = (kj < p.Sk && d < Dv) ? fl_load(v + kj * p.svs + d) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(r0 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc + 16 * j;
        const bool keep = col < p.Sk && (!p.causal || col <= qpos);
        s[i][j] = keep ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fl_row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float shift = isfinite(m_new) ? m_new : 0.0f;  // a row masked so far
      const float alpha = isfinite(m[i]) ? expf(m[i] - shift) : 0.0f;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[i][j] - shift);
        Ps[(r0 + i) * LDP + tc + 16 * j] = pj;
        rs += pj;
      }
      l[i] = l[i] * alpha + fl_row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P complete

    const int kn = min(FL_BK, p.Sk - k0);
    for (int c = 0; c < kn; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(r0 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * LDV + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= p.Sq) continue;
    const float denom = l[i] > 0.0f ? l[i] : 1.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tc + 16 * j;
      if (col < Dv) fl_store(o + qi * p.sos + col, acc[i][j] / denom);
    }
  }
}

template <class T, int NJ>
static int fl_launch(const FlashParams& p, int B, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = fl_smem_bytes(p.D, fl_ldv<NJ>());
  e = cudaFuncSetAttribute(flash_fwd_kernel<T, NJ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + FL_BQ - 1) / FL_BQ, p.Hq, B);
  flash_fwd_kernel<T, NJ><<<grid, FL_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <class T>
static int fl_dispatch(const FlashParams& p, int B, int device, void* stream) {
  if (p.Dv <= 64) return fl_launch<T, 4>(p, B, device, stream);
  if (p.Dv <= 112) return fl_launch<T, 7>(p, B, device, stream);
  if (p.Dv <= 128) return fl_launch<T, 8>(p, B, device, stream);
  return fl_launch<T, 16>(p, B, device, stream);
}

// q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv), o (B, Hq, Sq, Dv),
// each with its innermost dimension contiguous; strides holds the element
// strides over (batch, head, sequence) of q, k, v and o, in that order.
// Launches on the given stream; returns cudaGetLastError() (0 on success).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                const long long* strides, int B, int Hq, int Hkv, int Sq,
                                int Sk, int D, int Dv, int causal, float scale, int is_bf16,
                                int device, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || Sq > Sk ||
      D <= 0 || D > FL_MAX_D || Dv <= 0 || Dv > FL_MAX_D)
    return (int)cudaErrorInvalidValue;
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.sqb = strides[0], p.sqh = strides[1], p.sqs = strides[2];
  p.skb = strides[3], p.skh = strides[4], p.sks = strides[5];
  p.svb = strides[6], p.svh = strides[7], p.svs = strides[8];
  p.sob = strides[9], p.soh = strides[10], p.sos = strides[11];
  p.Hq = Hq, p.Hkv = Hkv, p.Sq = Sq, p.Sk = Sk, p.D = D, p.Dv = Dv, p.causal = causal;
  p.scale = scale;
  return is_bf16 ? fl_dispatch<__nv_bfloat16>(p, B, device, stream)
                 : fl_dispatch<float>(p, B, device, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
