// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/ssd/kernel.py:_ssd_kernel
// (launched by ssd_scan_pallas).  Per (batch, head) it runs the chunkwise
// form of the scalar-decay state-space recurrence
//   h_t = exp(-A dt_t) h_{t-1} + in_scale_t B_t x_t^T,   y_t = C_t^T h_t,
// chunk by chunk, with the (N, P) state carried between chunks.  Per chunk of
// Q steps, in float32:
//   la = cumsum(-A dt)                        (inclusive)
//   L[i, j] = exp(la_i - la_j) for i >= j, else 0
//   y = (C B^T o L)(in_scale x) + exp(la) o (C h)
//   h' = exp(la_Q) h + (B o w)^T (in_scale x),   w = exp(la_Q - la).
// Head h reads B/C group h / (H / G).  y has x's type; the final state is
// float32.
//
// Bound on the H100: operations.  Per chunk the four products do
// 2 Q (Q N + Q P + N P + N P) flops against Q (P + 2 N + 2) input elements
// and Q P outputs: about 64 flops per element moved at Q = N = P = 64.
//
// Design (a first, simple kernel: float32 FMA on the CUDA cores, no tensor
// cores).  One block of 256 threads per (head, batch): the TPU's sequential
// chunk grid axis and its VMEM state scratch become a loop inside the block
// with the state in shared memory (16 KB at N = P = 64), so the state never
// touches device memory between chunks.  Each chunk's x (scaled by
// in_scale), B, C and the masked decay-weighted scores C B^T o L also sit in
// shared memory, rows padded to odd strides.  All four products go through
// one register-tiled loop: thread (ty, tx) owns rows ty + 16 a and columns
// tx + 16 c of the product (a, c < T, T = ceil(max(Q, N, P) / 16)), so each
// shared load feeds T FMAs; the (C B^T o L)(x) product stops at the thread's
// last row, since L is lower triangular.  At the path's shapes (Bt = 2,
// H = 112) the grid is 224 blocks on 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define SSD_THREADS 256
#define SSD_MAX_DIM 128

__device__ __forceinline__ float ssd_load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ssd_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void ssd_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void ssd_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct SsdParams {
  const void* x;
  const float* dt;
  const float* sc;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* hout;
  long long sxb, sxs, sxh;  // element strides over (batch, seq, head|group)
  long long sdb, sds, sdh;
  long long ssb, sss, ssh;
  long long sBb, sBs, sBg;
  long long sCb, sCs, sCg;
  long long syb, sys, syh;
  int S, H, G, N, P, Q;
};

static size_t ssd_smem_floats(int Q, int N, int P) {
  return (size_t)N * (P + 1) + (size_t)Q * (P + 1) + 2 * (size_t)Q * (N + 1) +
         (size_t)Q * (Q + 1) + 2 * (size_t)Q;
}

// acc[a][c] += sum_{k < K} fa(i, k) fb(k, j) for i = ty + 16 a < M and
// j = tx + 16 c < Nn.  Out-of-range rows and columns read zeros.
template <int T, class FA, class FB>
__device__ __forceinline__ void ssd_mm(float (&acc)[T][T], int M, int Nn, int K, FA fa, FB fb) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int k = 0; k < K; ++k) {
    float av[T], bv[T];
#pragma unroll
    for (int a = 0; a < T; ++a) {
      const int i = ty + 16 * a;
      av[a] = i < M ? fa(i, k) : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < T; ++c) {
      const int j = tx + 16 * c;
      bv[c] = j < Nn ? fb(k, j) : 0.0f;
    }
#pragma unroll
    for (int a = 0; a < T; ++a)
#pragma unroll
      for (int c = 0; c < T; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
  }
}

template <int T>
__device__ __forceinline__ void ssd_zero(float (&acc)[T][T]) {
#pragma unroll
  for (int a = 0; a < T; ++a)
#pragma unroll
    for (int c = 0; c < T; ++c) acc[a][c] = 0.0f;
}

template <class E, int T>
__global__ void __launch_bounds__(SSD_THREADS) ssd_scan_kernel(SsdParams p) {
  extern __shared__ float smem[];
  const int Q = p.Q, N = p.N, P = p.P;
  const int LDP = P + 1, LDN = N + 1, LDG = Q + 1;
  float* Hs = smem;              // N x LDP  state
  float* Xs = Hs + N * LDP;      // Q x LDP  in_scale * x
  float* Bs = Xs + Q * LDP;      // Q x LDN
  float* Cs = Bs + Q * LDN;      // Q x LDN
  float* Gs = Cs + Q * LDN;      // Q x LDG  (C B^T) o L
  float* la = Gs + Q * LDG;      // Q        cumulative log decay
  float* Ws = la + Q;            // Q        exp(la_Q - la)

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float A = __ldg(p.A + h);
  const E* x = (const E*)p.x + b * p.sxb + h * p.sxh;
  const float* dt = p.dt + b * p.sdb + h * p.sdh;
  const float* sc = p.sc + b * p.ssb + h * p.ssh;
  const E* Bg = (const E*)p.B + b * p.sBb + g * p.sBg;
  const E* Cg = (const E*)p.C + b * p.sCb + g * p.sCg;
  E* y = (E*)p.y + b * p.syb + h * p.syh;

  for (int idx = tid; idx < N * LDP; idx += SSD_THREADS) Hs[idx] = 0.0f;

  float acc[T][T];
  const int nchunks = p.S / Q;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int s0 = ch * Q;
    // the previous chunk's readers of Xs, Bs, Cs, la and Ws are done (and Hs is zeroed)
    __syncthreads();
    for (int i = tid; i < Q; i += SSD_THREADS) la[i] = -A * __ldg(dt + (s0 + i) * p.sds);
    for (int idx = tid; idx < Q * P; idx += SSD_THREADS) {
      const int i = idx / P, j = idx - i * P;
      Xs[i * LDP + j] = __ldg(sc + (s0 + i) * p.sss) * ssd_load(x + (s0 + i) * p.sxs + j);
    }
    for (int idx = tid; idx < Q * N; idx += SSD_THREADS) {
      const int i = idx / N, n = idx - i * N;
      Bs[i * LDN + n] = ssd_load(Bg + (s0 + i) * p.sBs + n);
      Cs[i * LDN + n] = ssd_load(Cg + (s0 + i) * p.sCs + n);
    }
    __syncthreads();
    if (tid < 32) {  // inclusive scan of la: a run per lane, then across the warp
      const int per = (Q + 31) / 32, i0 = tid * per, i1 = min(Q, i0 + per);
      float run = 0.0f;
      for (int i = i0; i < i1; ++i) {
        run += la[i];
        la[i] = run;
      }
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += t;
      }
      for (int i = i0; i < i1; ++i) la[i] += incl - run;
    }
    __syncthreads();
    const float la_last = la[Q - 1];
    for (int i = tid; i < Q; i += SSD_THREADS) Ws[i] = expf(la_last - la[i]);

    // Gs = (C B^T) o L
    ssd_zero(acc);
    ssd_mm<T>(acc, Q, Q, N, [&](int i, int k) { return Cs[i * LDN + k]; },
              [&](int k, int j) { return Bs[j * LDN + k]; });
#pragma unroll
    for (int a = 0; a < T; ++a)
#pragma unroll
      for (int c = 0; c < T; ++c) {
        const int i = ty + 16 * a, j = tx + 16 * c;
        if (i < Q && j < Q) Gs[i * LDG + j] = j <= i ? acc[a][c] * expf(la[i] - la[j]) : 0.0f;
      }

    // y = exp(la) o (C h) + Gs (in_scale x)
    ssd_zero(acc);
    ssd_mm<T>(acc, Q, P, N, [&](int i, int k) { return Cs[i * LDN + k]; },
              [&](int k, int j) { return Hs[k * LDP + j]; });
#pragma unroll
    for (int a = 0; a < T; ++a) {
      const int i = ty + 16 * a;
      const float e = i < Q ? expf(la[i]) : 0.0f;
#pragma unroll
      for (int c = 0; c < T; ++c) acc[a][c] *= e;
    }
    __syncthreads();  // Gs and Ws complete; every read of Hs for C h is done
    const int kmax = min(Q, ty + 16 * (T - 1) + 1);  // L is lower triangular
    ssd_mm<T>(acc, Q, P, kmax, [&](int i, int k) { return Gs[i * LDG + k]; },
              [&](int k, int j) { return Xs[k * LDP + j]; });
#pragma unroll
    for (int a = 0; a < T; ++a)
#pragma unroll
      for (int c = 0; c < T; ++c) {
        const int i = ty + 16 * a, j = tx + 16 * c;
        if (i < Q && j < P) ssd_store(y + (s0 + i) * p.sys + j, acc[a][c]);
      }

    // h' = exp(la_Q) h + (B o w)^T (in_scale x); each thread updates its own entries
    ssd_zero(acc);
    ssd_mm<T>(acc, N, P, Q, [&](int i, int k) { return Bs[k * LDN + i] * Ws[k]; },
              [&](int k, int j) { return Xs[k * LDP + j]; });
    const float decay = expf(la_last);
#pragma unroll
    for (int a = 0; a < T; ++a)
#pragma unroll
      for (int c = 0; c < T; ++c) {
        const int n = ty + 16 * a, j = tx + 16 * c;
        if (n < N && j < P) Hs[n * LDP + j] = decay * Hs[n * LDP + j] + acc[a][c];
      }
  }
  __syncthreads();
  float* hout = p.hout + ((size_t)b * p.H + h) * N * P;
  for (int idx = tid; idx < N * P; idx += SSD_THREADS) {
    const int n = idx / P, j = idx - n * P;
    hout[idx] = Hs[n * LDP + j];
  }
}

template <class E, int T>
static int ssd_launch_t(const SsdParams& p, int Bt, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sizeof(float) * ssd_smem_floats(p.Q, p.N, p.P);
  e = cudaFuncSetAttribute(ssd_scan_kernel<E, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.H, Bt);
  ssd_scan_kernel<E, T><<<grid, SSD_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <class E>
static int ssd_dispatch(const SsdParams& p, int Bt, int device, void* stream) {
  const int m = max(p.Q, max(p.N, p.P));
  if (m <= 16) return ssd_launch_t<E, 1>(p, Bt, device, stream);
  if (m <= 32) return ssd_launch_t<E, 2>(p, Bt, device, stream);
  if (m <= 64) return ssd_launch_t<E, 4>(p, Bt, device, stream);
  return ssd_launch_t<E, 8>(p, Bt, device, stream);
}

// x (Bt, S, H, P), B and C (Bt, S, G, N) of one type (float32 or bfloat16,
// is_bf16), dt and in_scale (Bt, S, H) float32, A (H,) float32; y (Bt, S, H, P)
// of x's type, hout (Bt, H, N, P) float32 contiguous.  strides holds the
// element strides over (batch, seq, head or group) of x, dt, in_scale, B, C
// and y, in that order; each innermost dimension is contiguous.  S must be a
// multiple of the chunk Q.  Launches on the given stream; returns
// cudaGetLastError() (0 on success).
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* sc, const float* A,
                               const void* B, const void* C, void* y, float* hout,
                               const long long* strides, int Bt, int S, int H, int G, int N,
                               int P, int Q, int is_bf16, int device, void* stream) {
  if (Bt <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 || P <= 0 || Q <= 0 ||
      S % Q != 0 || N > SSD_MAX_DIM || P > SSD_MAX_DIM || Q > SSD_MAX_DIM)
    return (int)cudaErrorInvalidValue;
  SsdParams p;
  p.x = x, p.dt = dt, p.sc = sc, p.A = A, p.B = B, p.C = C, p.y = y, p.hout = hout;
  p.sxb = strides[0], p.sxs = strides[1], p.sxh = strides[2];
  p.sdb = strides[3], p.sds = strides[4], p.sdh = strides[5];
  p.ssb = strides[6], p.sss = strides[7], p.ssh = strides[8];
  p.sBb = strides[9], p.sBs = strides[10], p.sBg = strides[11];
  p.sCb = strides[12], p.sCs = strides[13], p.sCg = strides[14];
  p.syb = strides[15], p.sys = strides[16], p.syh = strides[17];
  p.S = S, p.H = H, p.G = G, p.N = N, p.P = P, p.Q = Q;
  return is_bf16 ? ssd_dispatch<__nv_bfloat16>(p, Bt, device, stream)
                 : ssd_dispatch<float>(p, Bt, device, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
