// Block-level building blocks shared by the pointer kernels (ptr_step.cu,
// ptr_decode.cu).  Every kernel runs thread blocks of PTR_THREADS threads;
// all helpers below are called by every thread of the block.
// The helpers that read global memory take it stored as float or as
// __nv_bfloat16 (T); they widen each element to float on read, so every
// product and sum is float32 either way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define PTR_THREADS 512
#define PTR_WARPS (PTR_THREADS / 32)
#define PTR_NEG_INF (-1.0e9f)
#define PTR_FULL_MASK 0xffffffffu

__device__ __forceinline__ float ptr_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(PTR_FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float ptr_warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(PTR_FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float ptr_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// A stored element as float: float as it is, bfloat16 widened (exactly).
__device__ __forceinline__ float ptr_f(float v) { return v; }
__device__ __forceinline__ float ptr_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// A read-only global element as float, through the non-coherent cache.
template <class T>
__device__ __forceinline__ float ptr_ld(const T* p) { return ptr_f(__ldg(p)); }

// Sum of v over the block, returned to every thread.  red holds PTR_WARPS
// floats.  The warp partials are added in warp order by every thread, so
// all threads get the same bits.
__device__ __forceinline__ float ptr_block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = ptr_warp_sum(v);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = 0.0f;
  for (int w = 0; w < PTR_WARPS; ++w) r += red[w];
  return r;
}

__device__ __forceinline__ float ptr_block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = ptr_warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < PTR_WARPS; ++w) r = fmaxf(r, red[w]);
  return r;
}

// Writes every i in [0, n) with pred(i) true to list, in ascending order,
// and returns their count to every thread.  cnt holds PTR_WARPS ints.
// Ends with a barrier, so list is readable on return.
template <class Pred>
__device__ int ptr_compact(int n, Pred pred, int* list, int* cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int start = 0; start < n; start += PTR_THREADS) {
    const int i = start + threadIdx.x;
    const bool p = i < n && pred(i);
    const unsigned bal = __ballot_sync(PTR_FULL_MASK, p);
    __syncthreads();  // cnt of the previous chunk has been read
    if (lane == 0) cnt[warp] = __popc(bal);
    __syncthreads();
    int off = base, tot = 0;
    for (int w = 0; w < PTR_WARPS; ++w) {
      const int c = cnt[w];
      off += (w < warp) ? c : 0;
      tot += c;
    }
    if (p) list[off + __popc(bal & ((1u << lane) - 1u))] = i;
    base += tot;
  }
  __syncthreads();
  return base;
}

// Thread groups of the H-wide products below: PTR_THREADS / H groups of H
// threads when H <= PTR_THREADS / 2, else one group whose threads loop over
// the columns.  For an H that divides PTR_THREADS every thread is in a group.
__device__ __forceinline__ int ptr_groups(int H) {
  return H <= PTR_THREADS / 2 ? PTR_THREADS / H : 1;
}

// y = x @ W for x (H) in shared memory and W (H, H) row-major in global
// memory.  ptr_groups(H) thread groups each sum a slice of the rows, in
// ascending order, into part (PTR_THREADS floats); the slices are then
// added in order, starting from 0.  Any H.
template <class T>
__device__ __forceinline__ void ptr_matvec(const float* x, const T* __restrict__ W, int H,
                                           float* part, float* y) {
  const int G = ptr_groups(H);
  if (G == 1) {   // one slice: all the rows
    for (int j = threadIdx.x; j < H; j += PTR_THREADS) {
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) acc = fmaf(x[k], ptr_ld(&W[(size_t)k * H + j]), acc);
      y[j] = 0.0f + acc;
    }
    __syncthreads();
    return;
  }
  const int kc = (H + G - 1) / G;
  if (threadIdx.x < G * H) {
    const int j = threadIdx.x % H, g = threadIdx.x / H;
    const int k0 = g * kc, k1 = min(H, k0 + kc);
    float acc = 0.0f;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) acc = fmaf(x[k], ptr_ld(&W[(size_t)k * H + j]), acc);
    part[threadIdx.x] = acc;
  }
  __syncthreads();
  if (threadIdx.x < H) {
    float s = 0.0f;
    for (int q = 0; q < G; ++q) s += part[q * H + threadIdx.x];
    y[threadIdx.x] = s;
  }
  __syncthreads();
}

// s[p] = sum_j tanh(R[list[p], j] + q[j]) * v[j] for p < m: one warp per
// row, lanes striding over the H columns (coalesced row reads).
template <class T>
__device__ __forceinline__ void ptr_row_scores(const T* __restrict__ R, const int* list, int m,
                                               const float* q, const float* v, int H, float* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < m; p += PTR_WARPS) {
    const T* row = R + (size_t)list[p] * H;
    float acc = 0.0f;
    for (int j = lane; j < H; j += 32) acc = fmaf(tanhf(ptr_ld(&row[j]) + q[j]), v[j], acc);
    acc = ptr_warp_sum(acc);
    if (lane == 0) s[p] = acc;
  }
  __syncthreads();
}

// In place: s[p] <- softmax over p < m of s[p] (the masked rows of the
// reference carry exp(-1e9 - max) == 0 and are left out).
__device__ __forceinline__ void ptr_softmax(float* s, int m, float* red) {
  float mx = -INFINITY;
  for (int p = threadIdx.x; p < m; p += PTR_THREADS) mx = fmaxf(mx, s[p]);
  mx = ptr_block_max(mx, red);
  float sum = 0.0f;
  for (int p = threadIdx.x; p < m; p += PTR_THREADS) {
    const float e = expf(s[p] - mx);
    s[p] = e;
    sum += e;
  }
  sum = ptr_block_sum(sum, red);
  for (int p = threadIdx.x; p < m; p += PTR_THREADS) s[p] = s[p] / sum;
  __syncthreads();
}

// y[j] = sum_p a[p] * C[list[p], j]: ptr_groups(H) thread groups each take
// every G-th row, then the group partials are added in order.  Any H.
template <class T>
__device__ __forceinline__ void ptr_weighted_rows(const T* __restrict__ C, const int* list,
                                                  const float* a, int m, int H, float* part,
                                                  float* y) {
  const int G = ptr_groups(H);
  if (G == 1) {
    for (int j = threadIdx.x; j < H; j += PTR_THREADS) {
      float acc = 0.0f;
      for (int p = 0; p < m; ++p) acc = fmaf(a[p], ptr_ld(&C[(size_t)list[p] * H + j]), acc);
      y[j] = 0.0f + acc;
    }
    __syncthreads();
    return;
  }
  if (threadIdx.x < G * H) {
    const int j = threadIdx.x % H, g = threadIdx.x / H;
    float acc = 0.0f;
    for (int p = g; p < m; p += G) acc = fmaf(a[p], ptr_ld(&C[(size_t)list[p] * H + j]), acc);
    part[threadIdx.x] = acc;
  }
  __syncthreads();
  if (threadIdx.x < H) {
    float s = 0.0f;
    for (int q = 0; q < G; ++q) s += part[q * H + threadIdx.x];
    y[threadIdx.x] = s;
  }
  __syncthreads();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
