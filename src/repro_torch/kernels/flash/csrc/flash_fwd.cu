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
// type.
//
// For training, both templates also write each row's log-sum-exp
// lse = m + log(l) (natural log, float32, (B, Hq, Sq) contiguous) when the
// caller passes a buffer: the residual the backward recomputes the
// probabilities from (repro/kernels/flash/vjp.py:_fwd_chunked).  A row with
// every key masked gets m = -inf, as there.  Serving passes none, and the
// kernels then do the same work as without it.
//
// Bound on the H100: operations.  A causal prefill does about
// 2 Sq Sk (D + Dv) / 2 flops per (batch, head) against (Sq D + Sk (D + Dv) +
// Sq Dv) elements moved, far above the card's operations-per-byte balance at
// the path's lengths (2048 tokens, D = Dv = 112): 0.061 ms at 989 TFLOP/s.
//
// Two templates, chosen by dtype in flash_fwd_launch:
//
// * bfloat16 (flash_fwd_bf16_kernel, the served model's path): tensor cores
//   and asynchronous copies.  One block per (q tile of 64 rows, q head,
//   batch), 160 threads: one consumer warpgroup and one producer warp.  The
//   producer's single thread issues TMA loads (4-D tensor maps built on the
//   host from the (B, S, H, D) strides, 128-byte swizzle) completed on
//   mbarriers: Q once, then K and V tiles of 64 keys, as bf16, into a ring of
//   2 stages.  A row of D = 112 is 224 bytes, not a multiple of the 128-byte
//   swizzle span, so every operand is cut into boxes of 64 columns; columns
//   past D (or Dv) read as zeros (TMA's out-of-bounds fill), as do keys past
//   Sk and rows past Sq.  S = Q K^T is wgmma m64n64k16 with both operands in
//   shared memory (K-major, 7 steps of 16 at D = 112); the online softmax
//   runs on the accumulator fragments in registers (exp2, scale folded in);
//   P V is wgmma m64n64k16 per 64 columns of Dv with P as the register A
//   operand and V read MN-major (transposed) from shared memory.  P is not
//   rounded once to bf16: it is split into hi = bf16(P) and lo = bf16(P - hi)
//   and both go through the tensor cores (two P V products; V is exact in
//   bf16), so P keeps about 16 bits as in the TPU kernel's float32 P.  Only
//   tiles that straddle the diagonal or Sk are masked.  q tiles are issued
//   longest-first (the slowest grid axis, reversed), so the long causal rows
//   do not form the tail.  The consumer frees a stage by an mbarrier arrive
//   after its P V products complete; nothing else synchronises the block.
//
// * float32 (flash_fwd_f32_kernel): the first, CUDA-core design, kept for
//   float32 inputs (tensor cores would need TF32).  One block of 256 threads
//   per (q tile of 64 rows, q head, batch); the TPU's sequential key-block
//   grid axis becomes a loop inside the block that stops at the diagonal.  The
//   Q tile, one K and one V tile and the probabilities P sit in shared memory,
//   rows padded to an odd stride so that the 16 threads reading 16 rows hit 16
//   banks.  Each thread owns a 4 x 4 block of scores (rows 4 tr .. 4 tr + 3,
//   columns tc + 16 j) and the same 4 rows of the output accumulator (columns
//   tc + 16 j, j < NJ), so every shared-memory load feeds 2 to 4 FMAs.  The
//   online softmax state of a row lives in the registers of the 16 threads
//   that share the row and is reduced with shuffles inside a half warp.  Rows
//   past Sq are zero and never stored, keys past Sk score -inf, V's pad
//   columns are zero.
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FL_THREADS 256
#define FL_BQ 64
#define FL_BK 64
#define FL_MAX_D 256
#define FL_FULL_MASK 0xffffffffu

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
  float* lse;  // (B, Hq, Sq) or null
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

template <int NJ>
__global__ void __launch_bounds__(FL_THREADS) flash_fwd_f32_kernel(FlashParams p) {
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
  float* lse = p.lse ? p.lse + ((long long)b * p.Hq + h) * p.Sq : nullptr;
  const int off = p.Sk - p.Sq;  // query i sits at key position i + off
  const float* q = (const float*)p.q + b * p.sqb + h * p.sqh;
  const float* k = (const float*)p.k + b * p.skb + hk * p.skh;
  const float* v = (const float*)p.v + b * p.svb + hk * p.svh;
  float* o = (float*)p.o + b * p.sob + h * p.soh;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int r0 = tr * 4;  // this thread's 4 rows of the tile

  for (int idx = tid; idx < FL_BQ * D; idx += FL_THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r;
    Qs[r * LDQ + d] = qi < p.Sq ? __ldg(q + qi * p.sqs + d) : 0.0f;
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
      Ks[r * LDQ + d] = kj < p.Sk ? __ldg(k + kj * p.sks + d) : 0.0f;
    }
    for (int idx = tid; idx < FL_BK * LDV; idx += FL_THREADS) {
      const int r = idx / LDV, d = idx - r * LDV;
      const int kj = k0 + r;
      Vs[idx] = (kj < p.Sk && d < Dv) ? __ldg(v + kj * p.svs + d) : 0.0f;
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
    if (lse != nullptr && tc == 0) lse[qi] = m[i] + logf(denom);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tc + 16 * j;
      if (col < Dv) o[qi * p.sos + col] = acc[i][j] / denom;
    }
  }
}

template <int NJ>
static int fl_launch(const FlashParams& p, int B, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = fl_smem_bytes(p.D, fl_ldv<NJ>());
  e = cudaFuncSetAttribute(flash_fwd_f32_kernel<NJ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.Sq + FL_BQ - 1) / FL_BQ, p.Hq, B);
  flash_fwd_f32_kernel<NJ><<<grid, FL_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

static int fl_dispatch_f32(const FlashParams& p, int B, int device, void* stream) {
  if (p.Dv <= 64) return fl_launch<4>(p, B, device, stream);
  if (p.Dv <= 112) return fl_launch<7>(p, B, device, stream);
  if (p.Dv <= 128) return fl_launch<8>(p, B, device, stream);
  return fl_launch<16>(p, B, device, stream);
}

// ---------------------------------------------------------------------------
// bfloat16 template: TMA + mbarrier ring, wgmma on the tensor cores
// ---------------------------------------------------------------------------
#define FB_BQ 64
#define FB_BK 64
#define FB_STAGES 2
#define FB_THREADS 160                   // consumer warpgroup (128) + producer warp
#define FB_BOX_BYTES (64 * 64 * 2)       // one box: 64 rows x 64 bf16 columns, 8 KB
#define FB_SMEM_ALIGN 1024               // the 128-byte swizzle repeats every 1024 bytes

struct FlashBf16Params {
  void* o;
  float* lse;          // (B, Hq, Sq) or null
  long long sob, soh, sos;
  int Hq, Hkv, Sq, Sk, D, Dv, causal;
  float scale_log2;    // scale * log2(e): the softmax runs on exp2
  int pos[3][3];       // tensor-map dimension of (seq, head, batch) for q, k, v
};

__device__ __forceinline__ uint32_t fb_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void fb_mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fb_mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void fb_mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// waits for the phase of the given parity to complete; a wait of more than
// about 10 s traps (the launch then fails) instead of hanging the card
__device__ __forceinline__ void fb_mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = -1;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 < 0) t0 = clock64();
    else if (clock64() - t0 > 20000000000ll) __trap();
  }
}

// one 64 x 64 box of a 4-D tensor map: coordinates (column, seq, head, batch)
// placed at the map's dimensions pos[0..2] (dimension 0 is always the column)
__device__ __forceinline__ void fb_tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                           const int (&pos)[3], int col, int seq, int head,
                                           int batch) {
  const int c1 = pos[0] == 1 ? seq : pos[1] == 1 ? head : batch;
  const int c2 = pos[0] == 2 ? seq : pos[1] == 2 ? head : batch;
  const int c3 = pos[0] == 3 ? seq : pos[1] == 3 ? head : batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"((unsigned long long)map), "r"(bar), "r"(col), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t fb_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major box (rows of 64 columns along the reduction): 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t fb_desc_k(uint32_t addr) { return fb_desc(addr, 16, 1024); }
// MN-major box (V: keys are rows, the N columns contiguous): 8-key groups 1024
// bytes apart; N = 64 spans exactly one swizzle row, so the other offset is unused
__device__ __forceinline__ uint64_t fb_desc_mn(uint32_t addr) { return fb_desc(addr, 1024, 1024); }

__device__ __forceinline__ void fb_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void fb_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void fb_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the async products
__device__ __forceinline__ void fb_fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), both from shared memory, K-major
__device__ __forceinline__ void fb_wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}
// d (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, shared memory, MN-major)
__device__ __forceinline__ void fb_wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t fb_pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
// (a, b) as hi = bf16 and lo = bf16 of the remainder, each packed in one register
__device__ __forceinline__ void fb_split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 ah = __float2bfloat16_rn(a), bh = __float2bfloat16_rn(b);
  hi = fb_pack(ah, bh);
  lo = fb_pack(__float2bfloat16_rn(a - __bfloat162float(ah)),
               __float2bfloat16_rn(b - __bfloat162float(bh)));
}

__device__ __forceinline__ float fb_quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FL_FULL_MASK, v, 1));
  return fmaxf(v, __shfl_xor_sync(FL_FULL_MASK, v, 2));
}
__device__ __forceinline__ float fb_quad_sum(float v) {
  v += __shfl_xor_sync(FL_FULL_MASK, v, 1);
  return v + __shfl_xor_sync(FL_FULL_MASK, v, 2);
}

static size_t fb_smem_bytes(int D, int Dv) {
  const int dc = (D + 63) / 64, vc = (Dv + 63) / 64;
  return FB_SMEM_ALIGN + (size_t)FB_BOX_BYTES * (dc + FB_STAGES * (dc + vc));
}

// VC: boxes of 64 columns that cover Dv (the accumulator is VC x 32 floats a thread)
template <int VC>
__global__ void __launch_bounds__(FB_THREADS, VC <= 2 ? 2 : 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, const FlashBf16Params p) {
  extern __shared__ unsigned char fb_smem[];
  __shared__ __align__(8) unsigned long long bars[2 * FB_STAGES + 1];
  const int DC = (p.D + 63) >> 6;
  const uint32_t sQ = (fb_smem_addr(fb_smem) + FB_SMEM_ALIGN - 1) & ~(uint32_t)(FB_SMEM_ALIGN - 1);
  const uint32_t sK = sQ + DC * FB_BOX_BYTES;                  // [stage][DC boxes]
  const uint32_t sV = sK + FB_STAGES * DC * FB_BOX_BYTES;      // [stage][VC boxes]
  const uint32_t full0 = fb_smem_addr(&bars[0]);               // full[s] = full0 + 8 s
  const uint32_t empty0 = fb_smem_addr(&bars[FB_STAGES]);
  const uint32_t qbar = fb_smem_addr(&bars[2 * FB_STAGES]);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * FB_BQ;         // longest causal rows first
  const int hk = h / (p.Hq / p.Hkv);
  const int off = p.Sk - p.Sq;                                 // query i sits at key i + off
  int kend = p.Sk;
  if (p.causal) kend = min(p.Sk, min(q0 + FB_BQ, p.Sq) + off);
  const int ntiles = (kend + FB_BK - 1) / FB_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < FB_STAGES; ++s) {
      fb_mbar_init(full0 + 8 * s, 1);
      fb_mbar_init(empty0 + 8 * s, 128);
    }
    fb_mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp: one thread issues every copy
    if (threadIdx.x == 128) {
      fb_mbar_expect_tx(qbar, DC * FB_BOX_BYTES);
      for (int dc = 0; dc < DC; ++dc)
        fb_tma_box(sQ + dc * FB_BOX_BYTES, &map_q, qbar, p.pos[0], 64 * dc, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % FB_STAGES;
        if (t >= FB_STAGES) fb_mbar_wait(empty0 + 8 * st, ((t / FB_STAGES) - 1) & 1);
        const uint32_t full = full0 + 8 * st;
        fb_mbar_expect_tx(full, (DC + VC) * FB_BOX_BYTES);
        for (int dc = 0; dc < DC; ++dc)
          fb_tma_box(sK + (st * DC + dc) * FB_BOX_BYTES, &map_k, full, p.pos[1], 64 * dc,
                     t * FB_BK, hk, b);
        for (int vc = 0; vc < VC; ++vc)
          fb_tma_box(sV + (st * VC + vc) * FB_BOX_BYTES, &map_v, full, p.pos[2], 64 * vc,
                     t * FB_BK, hk, b);
      }
    }
    return;
  }

  // consumer warpgroup: thread owns rows r0 and r0 + 8 of the tile and, per
  // 8-column block j of an accumulator, columns 8 j + 2 tq and 8 j + 2 tq + 1
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2), tq = lane & 3;
  const int KS = (p.D + 15) >> 4;        // k-steps of 16 in Q K^T
  float o[VC][32];
#pragma unroll
  for (int vc = 0; vc < VC; ++vc)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[vc][i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  const int qp0 = q0 + r0 + off, qp1 = qp0 + 8;   // key positions of the two rows

  fb_mbar_wait(qbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % FB_STAGES, k0 = t * FB_BK;
    fb_mbar_wait(full0 + 8 * st, (t / FB_STAGES) & 1);

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fb_fence_regs(s);
    fb_wgmma_fence();
    const uint32_t kbase = sK + st * DC * FB_BOX_BYTES;
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t at = (ks >> 2) * FB_BOX_BYTES + (ks & 3) * 32;   // 16 columns = 32 bytes
      fb_wgmma_ss(s, fb_desc_k(sQ + at), fb_desc_k(kbase + at), ks > 0);
    }
    fb_wgmma_commit();
    fb_wgmma_wait();
    fb_fence_regs(s);

    // scores in log2 units; mask only a tile that straddles the diagonal or Sk
    const bool edge = k0 + FB_BK > p.Sk || (p.causal && k0 + FB_BK - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& a = s[4 * j + e];
        float& c = s[4 * j + 2 + e];
        a *= p.scale_log2;
        c *= p.scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * tq + e;
          const bool out = col >= p.Sk;
          if (out || (p.causal && col > qp0)) a = -INFINITY;
          if (out || (p.causal && col > qp1)) c = -INFINITY;
        }
      }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fb_quad_max(mx0);
    mx1 = fb_quad_max(mx1);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float sh0 = mn0 == -INFINITY ? 0.0f : mn0;   // a row masked so far
    const float sh1 = mn1 == -INFINITY ? 0.0f : mn1;
    const float al0 = m0 == -INFINITY ? 0.0f : exp2f(m0 - sh0);
    const float al1 = m1 == -INFINITY ? 0.0f : exp2f(m1 - sh1);
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = exp2f(s[4 * j] - sh0);
      s[4 * j + 1] = exp2f(s[4 * j + 1] - sh0);
      s[4 * j + 2] = exp2f(s[4 * j + 2] - sh1);
      s[4 * j + 3] = exp2f(s[4 * j + 3] - sh1);
      rs0 += s[4 * j] + s[4 * j + 1];
      rs1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * al0 + fb_quad_sum(rs0);
    l1 = l1 * al1 + fb_quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int vc = 0; vc < VC; ++vc)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[vc][4 * j] *= al0;
        o[vc][4 * j + 1] *= al0;
        o[vc][4 * j + 2] *= al1;
        o[vc][4 * j + 3] *= al1;
      }

    // P as the A operand: k-step kk takes accumulator blocks 2 kk and 2 kk + 1
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fb_split(s[8 * kk], s[8 * kk + 1], ph[kk][0], pl[kk][0]);
      fb_split(s[8 * kk + 2], s[8 * kk + 3], ph[kk][1], pl[kk][1]);
      fb_split(s[8 * kk + 4], s[8 * kk + 5], ph[kk][2], pl[kk][2]);
      fb_split(s[8 * kk + 6], s[8 * kk + 7], ph[kk][3], pl[kk][3]);
    }
#pragma unroll
    for (int vc = 0; vc < VC; ++vc) fb_fence_regs(o[vc]);
    fb_wgmma_fence();
    const uint32_t vbase = sV + st * VC * FB_BOX_BYTES;
#pragma unroll
    for (int vc = 0; vc < VC; ++vc)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = fb_desc_mn(vbase + vc * FB_BOX_BYTES + kk * 16 * 128);
        fb_wgmma_rs(o[vc], ph[kk], dv);
        fb_wgmma_rs(o[vc], pl[kk], dv);
      }
    fb_wgmma_commit();
    fb_wgmma_wait();
#pragma unroll
    for (int vc = 0; vc < VC; ++vc) fb_fence_regs(o[vc]);
    fb_mbar_arrive(empty0 + 8 * st);   // this thread is done with the stage
  }

  __nv_bfloat16* out = (__nv_bfloat16*)p.o + b * p.sob + h * p.soh;
  const float den0 = l0 > 0.0f ? l0 : 1.0f, den1 = l1 > 0.0f ? l1 : 1.0f;
  const float inv0 = 1.0f / den0, inv1 = 1.0f / den1;
  const bool pairs = (p.Dv & 1) == 0;   // the wrapper's output: 4-byte aligned pairs
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + r0 + 8 * half;
    if (qi >= p.Sq) continue;
    const float inv = half ? inv1 : inv0;
    if (p.lse != nullptr && tq == 0)   // m is in log2 units: back to natural ones
      p.lse[((long long)b * p.Hq + h) * p.Sq + qi] =
          (half ? m1 : m0) * 0.6931471805599453f + logf(half ? den1 : den0);
    __nv_bfloat16* row = out + qi * p.sos;
#pragma unroll
    for (int vc = 0; vc < VC; ++vc)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * vc + 8 * j + 2 * tq;
        const float a = o[vc][4 * j + 2 * half] * inv, c = o[vc][4 * j + 2 * half + 1] * inv;
        if (pairs && col + 1 < p.Dv) {
          *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(a, c);
        } else {
          if (col < p.Dv) row[col] = __float2bfloat16_rn(a);
          if (col + 1 < p.Dv) row[col + 1] = __float2bfloat16_rn(c);
        }
      }
  }
}

typedef CUresult (*FbEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (no -lcuda)
static FbEncodeTiled fb_encoder() {
  static FbEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = (FbEncodeTiled)ptr;
  }
  return fn;
}

// A 4-D bf16 tensor map over (column, seq, head, batch) with 64 x 64 boxes
// (64 columns, 64 rows of seq), 128-byte swizzle, zero fill out of bounds.
// Dimensions 1..3 are ordered by stride; pos receives where seq, head and
// batch went.  Every stride of a dimension longer than 1 must be a multiple of
// 16 bytes and the base 16-byte aligned (the wrapper copies what is not).
static int fb_tensor_map(CUtensorMap* map, const void* base, int cols, int S, int H, int B,
                         long long ss, long long sh, long long sb, int (&pos)[3]) {
  FbEncodeTiled enc = fb_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t n[3] = {(cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  cuuint64_t st[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  cuuint64_t span = 16;
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1 && st[i] * n[i] > span) span = st[i] * n[i];
  for (int i = 0; i < 3; ++i) {
    if (n[i] == 1) st[i] = (span + 15) / 16 * 16;   // never stepped: order it last
    if (st[i] % 16 != 0) return (int)cudaErrorInvalidPitchValue;
  }
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (st[order[j]] < st[order[i]]) {
        const int tmp = order[i];
        order[i] = order[j];
        order[j] = tmp;
      }
  cuuint64_t dims[4] = {(cuuint64_t)cols, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = n[order[i]];
    strides[i] = st[order[i]];
    box[i + 1] = order[i] == 0 ? 64 : 1;
    pos[order[i]] = i + 1;
  }
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidPitchValue;
}

template <int VC>
static int fb_launch(const CUtensorMap (&maps)[3], const FlashBf16Params& p, int B,
                     void* stream) {
  const size_t smem = fb_smem_bytes(p.D, p.Dv);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16_kernel<VC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.Hq, B, (p.Sq + FB_BQ - 1) / FB_BQ);
  flash_fwd_bf16_kernel<VC><<<grid, FB_THREADS, smem, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], p);
  return (int)cudaGetLastError();
}

static int fb_dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
                       const long long* s, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                       int Dv, int causal, float scale, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  FlashBf16Params p;
  p.o = o;
  p.lse = lse;
  p.sob = s[9], p.soh = s[10], p.sos = s[11];
  p.Hq = Hq, p.Hkv = Hkv, p.Sq = Sq, p.Sk = Sk, p.D = D, p.Dv = Dv, p.causal = causal;
  p.scale_log2 = scale * 1.4426950408889634f;
  CUtensorMap maps[3];
  int rc = fb_tensor_map(&maps[0], q, D, Sq, Hq, B, s[2], s[1], s[0], p.pos[0]);
  if (rc == 0) rc = fb_tensor_map(&maps[1], k, D, Sk, Hkv, B, s[5], s[4], s[3], p.pos[1]);
  if (rc == 0) rc = fb_tensor_map(&maps[2], v, Dv, Sk, Hkv, B, s[8], s[7], s[6], p.pos[2]);
  if (rc != 0) return rc;
  switch ((Dv + 63) / 64) {
    case 1: return fb_launch<1>(maps, p, B, stream);
    case 2: return fb_launch<2>(maps, p, B, stream);
    case 3: return fb_launch<3>(maps, p, B, stream);
    default: return fb_launch<4>(maps, p, B, stream);
  }
}

// q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv), o (B, Hq, Sq, Dv),
// each with its innermost dimension contiguous; lse (B, Hq, Sq) float32
// contiguous, or null for no log-sum-exp output; strides holds the element
// strides over (batch, head, sequence) of q, k, v and o, in that order.
// bfloat16 inputs (is_bf16) take the tensor-core template and need 16-byte
// aligned bases and strides that are multiples of 8 elements; float32 inputs
// take the CUDA-core template.  Launches on the given stream; returns a CUDA
// error code (0 on success).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                float* lse, const long long* strides, int B, int Hq, int Hkv,
                                int Sq, int Sk, int D, int Dv, int causal, float scale,
                                int is_bf16, int device, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || Sq > Sk ||
      D <= 0 || D > FL_MAX_D || Dv <= 0 || Dv > FL_MAX_D)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return fb_dispatch(q, k, v, o, lse, strides, B, Hq, Hkv, Sq, Sk, D, Dv, causal, scale, device,
                       stream);
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.sqb = strides[0], p.sqh = strides[1], p.sqs = strides[2];
  p.skb = strides[3], p.skh = strides[4], p.sks = strides[5];
  p.svb = strides[6], p.svh = strides[7], p.svs = strides[8];
  p.sob = strides[9], p.soh = strides[10], p.sos = strides[11];
  p.Hq = Hq, p.Hkv = Hkv, p.Sq = Sq, p.Sk = Sk, p.D = D, p.Dv = Dv, p.causal = causal;
  p.scale = scale;
  return fl_dispatch_f32(p, B, device, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
