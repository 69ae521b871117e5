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
// Bound on the H100: bytes at the path's shapes (Bt = 2, S = 2048, H = 112,
// P = N = 64, G = 2, chunk 64, bf16): x, B, C, dt read once and y and the
// final state written once take 0.037 ms at 3.35 TB/s, against 0.011 ms for
// the four products' lower-triangle work at 989 TFLOP/s.
//
// For N and P up to 128, two templates, chosen by dtype in ssd_scan_launch:
//
// * bfloat16 (ssd_scan_bf16_kernel, the served model's path): tensor cores
//   and asynchronous copies.  The state's P columns evolve independently
//   (column p of h and y needs only column p of x), so P is split into
//   slices of 32 and each block owns one (slice, head, batch): 448 blocks of
//   4 warps at the path's shapes, four resident per SM (54 KB of shared
//   memory, at most 128 registers), so all run in one wave, each walking the
//   chunks in order with its (N, 32) float32 state slice in registers.  This
//   keeps the state on chip; the three-pass chunk-parallel form would move
//   about 470 MB of float32 chunk states through device memory.  Each block
//   recomputes its chunk's masked scores C B^T o L (Q^2 N MACs; no cluster
//   exchange).  Chunk c + 1's B, C, x slice, dt and in_scale arrive by
//   cp.async (16-byte copies; 4-byte for dt and in_scale; plain loads when a
//   base or stride is not 16-byte aligned) into the other half of a double
//   buffer while chunk c computes; two barriers a chunk.  The cumulative
//   log-decay la (in log2 units, for exp2) is a warp-level inclusive scan,
//   done by every warp for itself.  All four products are
//   mma.sync.m16n8k16 bf16 with float32 accumulation.  Warp w owns rows
//   16 w .. 16 w + 15 of the chunk's y and the state's column tile w (all
//   its rows).  C B^T has both operands exact in bf16; every other product
//   has one exact operand (x, B or C) and folds each float32 factor into the
//   other one, y_intra = (S o L o sc_j) x, y_inter = exp(la) o (C h),
//   dh = B^T (w o sc o x), which is then split into hi = bf16(v) and
//   lo = bf16(v - hi) and issued as two products, so the result keeps about
//   2^-17 relative error (one bf16 rounding, 2^-9, would miss the float32
//   state's 1e-4).  B and C tiles are XOR-swizzled by 16-byte chunk, x and
//   the state's bf16 halves padded, so fragment loads (ldmatrix.trans for
//   the transposed operands B^T and x) hit distinct banks.
//
// * float32 (ssd_scan_f32_kernel): the first, CUDA-core design, kept for
//   float32 inputs (tensor cores would need TF32).  One block of 256 threads
//   per (head, batch): the TPU's sequential chunk grid axis and its VMEM state
//   scratch become a loop inside the block with the state in shared memory (16
//   KB at N = P = 64), so the state never touches device memory between
//   chunks. Each chunk's x (scaled by in_scale), B, C and the masked
//   decay-weighted scores C B^T o L also sit in shared memory, rows padded to
//   odd strides. All four products go through one register-tiled loop: thread
//   (ty, tx) owns rows ty + 16 a and columns tx + 16 c of the product (a, c <
//   T, T = ceil(max(Q, N, P) / 16)), so each shared load feeds T FMAs; the (C
//   B^T o L)(x) product stops at the thread's last row, since L is lower
//   triangular.
//
// N or P above 128 (xLSTM's mLSTM: chunk 64, N = P = 512 for the numerator
// and P = 1 for the normalizer) takes a tiled template: the two above keep a
// chunk x N tile of B and C, and the whole (N, P) state, on chip; at N = 512
// that does not fit in 227 KB.
//
// * bfloat16 (ssd_scan_tiled_bf16_kernel): all four products on the tensor
//   cores (mma.sync m16n8k16, float32 accumulation, every float32 factor
//   folded into the operand that is not exact and split hi + lo, as above),
//   and a thread-block cluster of the blocks that share a (head, batch), so
//   each chunk's scores C B^T are computed once a cluster and exchanged
//   through distributed shared memory.  The chunk tile is 64: a longer chunk
//   runs as its largest divisor up to 64, since the chunked scan is the same
//   function at any chunk that divides S.  Two layouts, chosen by shape in
//   ssd_dispatch_tiled_bf16:
//   - P above 8 (the numerator): a block of 8 warps owns a slice of 32
//     state columns and keeps its (N, 32) float32 state in registers for the
//     whole scan, 64 a thread, transposed (rows p, columns n), so that the
//     update product's accumulators, split hi/lo in registers, are the B
//     operand of C h as they stand.  The slices of a (head, batch) go in
//     pairs (an odd count of slices pads the last pair with an empty block):
//     clusters of 4, 8 or 16 blocks at one block an SM fit on only 120 of
//     the H100's 132 SMs (cudaOccupancyMaxActiveClusters: 30, 15, 7), so the
//     served numerator's 128 blocks would run in two waves; 66 pairs fit.  N
//     streams through a two-stage ring of (chunk x 256) B and C tiles brought
//     by TMA (128-byte swizzle, zeros past N) from one thread, with chunk
//     c + 1's first tile, and its x slice, dt and in_scale (cp.async, three
//     chunk buffers), in flight while chunk c computes; one barrier a tile.
//     On a tile, warp w (p rows 16 (w & 1), n columns 64 (w >> 1) of the
//     tile) adds its part of C h (A = C, exact) and updates its state entries
//     (A = (w o sc o x)^T split hi/lo, built at the end of the chunk before,
//     B = B's tile, exact).  Each block of a pair owns 5 of the chunk's 10
//     lower-triangle 16 x 16 score tiles; a warp adds its columns of N to one
//     half of each, from the C fragments its C h step has just loaded, and
//     the four partials of a half-tile meet in the finished ring slot.  The
//     block then forms M = S o L o sc_j, splits it hi/lo, and writes it as
//     bf16 into both blocks' shared memory (two buffers by chunk parity, so
//     one cluster barrier a chunk); the warps' C h parts, scaled by exp(la),
//     go to four partial slabs.  Chunk c's y = slabs + M x (tensor cores) is
//     formed after chunk c + 1's first tile, so that barrier's wait sits
//     behind a tile of work.  Shared loads take addresses precomputed a
//     thread; independent products are issued together.
//   - P up to 8 (the normalizer): N is split instead.  A cluster of K = 4 or
//     8 blocks (a power of two of 64-row slices) owns a (head, batch); block
//     r owns state rows 64 r .. 64 r + 63, loads only those columns of B and
//     C (double buffered, cp.async; x, which may be one column, through
//     registers a chunk ahead) and, as the untiled bf16 template does, keeps
//     its (64, 8) state tile in registers and its bf16 hi/lo copy in shared
//     memory for C h.  It writes its partial scores and C h over its 64 rows
//     into its own shared memory (two buffers by chunk parity); after a
//     cluster barrier block r sums the K partials of rows r ceil(Q / K) .. in
//     rank order over distributed shared memory and forms its rows of y in
//     float32 on the CUDA cores.  The state update is separable in N and
//     stays in the block.  At the served normalizer this puts 64 blocks on
//     the card instead of 8.
//   Bound: bytes (42 MB at the numerator's served shapes, Bt = 2, S = 1024,
//   H = 4: 0.013 ms); the numerator's products with the hi/lo split are 19
//   GFLOP of mma, 0.02 ms at the bf16 peak.  Both layouts are latency-bound:
//   a chunk is a chain of dependent products and exchanges at 8 warps an SM.
//
// * float32 (ssd_scan_tiled_kernel): the first tiled design, on the CUDA
//   cores (tensor cores would need TF32).  A block owns a slice of 32 state
//   columns (one (slice, head, batch) each), keeps its (N, 32) float32 state
//   slice in shared memory (66 KB at N = 512), and walks N in tiles of 64:
//   C B^T and C h are sums over N, accumulated tile by tile in registers, and
//   the state update is separable in N, so each tile of 64 state rows is
//   updated as soon as C h has read it.  Every block recomputes its chunk's
//   C B^T.
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SSD_THREADS 256
#define SSD_MAX_DIM 128

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
  int tpos[2][3];  // the tiled bf16 template's tensor maps of B, C: dimension of (seq, group, batch)
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

template <int T>
__global__ void __launch_bounds__(SSD_THREADS) ssd_scan_f32_kernel(SsdParams p) {
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
  const float* x = (const float*)p.x + b * p.sxb + h * p.sxh;
  const float* dt = p.dt + b * p.sdb + h * p.sdh;
  const float* sc = p.sc + b * p.ssb + h * p.ssh;
  const float* Bg = (const float*)p.B + b * p.sBb + g * p.sBg;
  const float* Cg = (const float*)p.C + b * p.sCb + g * p.sCg;
  float* y = (float*)p.y + b * p.syb + h * p.syh;

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
      Xs[i * LDP + j] = __ldg(sc + (s0 + i) * p.sss) * __ldg(x + (s0 + i) * p.sxs + j);
    }
    for (int idx = tid; idx < Q * N; idx += SSD_THREADS) {
      const int i = idx / N, n = idx - i * N;
      Bs[i * LDN + n] = __ldg(Bg + (s0 + i) * p.sBs + n);
      Cs[i * LDN + n] = __ldg(Cg + (s0 + i) * p.sCs + n);
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
        if (i < Q && j < P) y[(s0 + i) * p.sys + j] = acc[a][c];
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


template <int T>
static int ssd_launch_f32(const SsdParams& p, int Bt, void* stream) {
  const size_t smem = sizeof(float) * ssd_smem_floats(p.Q, p.N, p.P);
  cudaError_t e = cudaFuncSetAttribute(ssd_scan_f32_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.H, Bt);
  ssd_scan_f32_kernel<T><<<grid, SSD_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

static int ssd_dispatch_f32(const SsdParams& p, int Bt, void* stream) {
  const int m = max(p.Q, max(p.N, p.P));
  if (m <= 16) return ssd_launch_f32<1>(p, Bt, stream);
  if (m <= 32) return ssd_launch_f32<2>(p, Bt, stream);
  if (m <= 64) return ssd_launch_f32<4>(p, Bt, stream);
  return ssd_launch_f32<8>(p, Bt, stream);
}

// ---------------------------------------------------------------------------
// bfloat16 template: P split across blocks, cp.async double buffer, mma.sync
// ---------------------------------------------------------------------------
#define SB_PB 32        // state columns (of P) a block owns
#define SB_LDX (SB_PB + 8)

// byte offsets of the dynamic shared memory (ssd/kernel.py smem_bytes mirrors BYTES)
template <int QT, int NT>
struct SbLayout {
  static constexpr int NW = QT / 16;                 // warps: one per 16 rows of a chunk
  static constexpr int LDH = NT + 8;                 // state row (bf16), padded
  static constexpr int TILE = QT * NT * 2;           // one B or C tile, bf16, swizzled
  static constexpr int XT = QT * SB_LDX * 2;         // one x slice, bf16
  static constexpr int C0 = 0;                       // C[2]
  static constexpr int B0 = C0 + 2 * TILE;           // B[2]
  static constexpr int X0 = B0 + 2 * TILE;           // x[2]
  static constexpr int DT0 = X0 + 2 * XT;            // dt[2], float
  static constexpr int SC0 = DT0 + 2 * QT * 4;       // in_scale[2], float
  static constexpr int HH0 = SC0 + 2 * QT * 4;       // state hi, bf16 [SB_PB][LDH], transposed
  static constexpr int HL0 = HH0 + SB_PB * LDH * 2;  // state lo
  static constexpr int LA0 = HL0 + SB_PB * LDH * 2;  // per warp: la [QT], w o sc [QT]
  static constexpr int BYTES = LA0 + NW * 2 * QT * 4;
};

__device__ __forceinline__ void sb_cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void sb_cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void sb_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void sb_wait_prev() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void sb_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix, transposed: lane l gives the address of row l & 7 of matrix l / 8 (x4)
// or (l & 15) / 8 (x2); each row is 8 contiguous bf16 (16 bytes)
__device__ __forceinline__ void sb_ldsm_t4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((uint32_t)__cvta_generic_to_shared(row)));
}
__device__ __forceinline__ void sb_ldsm_t2(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"((uint32_t)__cvta_generic_to_shared(row)));
}

__device__ __forceinline__ uint32_t sb_pair(unsigned short lo, unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}
__device__ __forceinline__ float sb_lo(uint32_t pair) { return __uint_as_float(pair << 16); }
__device__ __forceinline__ float sb_hi(uint32_t pair) { return __uint_as_float(pair & 0xffff0000u); }
// (a, b) as hi = bf16 and lo = bf16 of the remainder, each pair packed in one register
__device__ __forceinline__ void sb_split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 ah = __float2bfloat16_rn(a), bh = __float2bfloat16_rn(b);
  hi = sb_pair(__bfloat16_as_ushort(ah), __bfloat16_as_ushort(bh));
  lo = sb_pair(__bfloat16_as_ushort(__float2bfloat16_rn(a - __bfloat162float(ah))),
               __bfloat16_as_ushort(__float2bfloat16_rn(b - __bfloat162float(bh))));
}

// element (i, n) of a swizzled B or C tile: 16-byte chunk n / 8 XOR (i mod 8)
template <int NT>
__device__ __forceinline__ int sb_sw(int i, int n) {
  return i * NT + ((((n >> 3) ^ (i & 7))) << 3) + (n & 7);
}
template <int NT>
__device__ __forceinline__ uint32_t sb_ld2(const unsigned short* t, int i, int n) {
  return *reinterpret_cast<const uint32_t*>(t + sb_sw<NT>(i, n));   // n even: one 4-byte word
}

// QT, NT: the chunk and N rounded up to 64 or 128 (padding reads as zeros).
// flags bit 0: x, B and C take 16-byte copies; bit 1: y takes bf16 pairs.
template <int QT, int NT>
__global__ void __launch_bounds__(QT * 2, (QT == 64 && NT == 64) ? 4 : 1)
    ssd_scan_bf16_kernel(SsdParams p, int flags) {
  using L = SbLayout<QT, NT>;
  constexpr int NW = L::NW, THREADS = NW * 32, LDH = L::LDH;
  constexpr int NJT = QT / 8, NKQ = QT / 16, NKN = NT / 16, NPT = SB_PB / 8;
  // warp w owns the state's column tile w % NPT and its row tiles w / NPT + MSTEP mi
  constexpr int NMT = NT / 16, MSTEP = NW / NPT, MTW = NMT / MSTEP;
  static_assert(NW % NPT == 0 && NMT % MSTEP == 0, "state tiles must split evenly");
  extern __shared__ __align__(16) unsigned char sb_smem[];
  unsigned short* Cs = reinterpret_cast<unsigned short*>(sb_smem + L::C0);
  unsigned short* Bs = reinterpret_cast<unsigned short*>(sb_smem + L::B0);
  unsigned short* Xs = reinterpret_cast<unsigned short*>(sb_smem + L::X0);
  float* DTs = reinterpret_cast<float*>(sb_smem + L::DT0);
  float* SCs = reinterpret_cast<float*>(sb_smem + L::SC0);
  unsigned short* Hh = reinterpret_cast<unsigned short*>(sb_smem + L::HH0);
  unsigned short* Hl = reinterpret_cast<unsigned short*>(sb_smem + L::HL0);

  const int Q = p.Q, N = p.N, P = p.P;
  const int p0 = blockIdx.x * SB_PB, h = blockIdx.y, b = blockIdx.z;
  const int pw = min(SB_PB, P - p0);
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const bool vec = flags & 1, pairs = flags & 2;
  const int pt_w = warp % NPT, mt_w = warp / NPT;   // this warp's state tiles
  const float A2 = __ldg(p.A + h) * 1.4426950408889634f;   // decay in log2 units
  const unsigned short* x = (const unsigned short*)p.x + b * p.sxb + h * p.sxh + p0;
  const float* dt = p.dt + b * p.sdb + h * p.sdh;
  const float* sc = p.sc + b * p.ssb + h * p.ssh;
  const unsigned short* Bg = (const unsigned short*)p.B + b * p.sBb + g * p.sBg;
  const unsigned short* Cg = (const unsigned short*)p.C + b * p.sCb + g * p.sCg;
  __nv_bfloat16* y = (__nv_bfloat16*)p.y + b * p.syb + h * p.syh + p0;

  // zero both buffers once: rows past Q and columns past N or the slice stay zero
  for (int i = tid; i < L::HH0 / 16; i += THREADS)
    reinterpret_cast<uint4*>(sb_smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto load_chunk = [&](int c, int bf) {
    const int s0 = c * Q;
    unsigned short* cs = Cs + bf * QT * NT;
    unsigned short* bs = Bs + bf * QT * NT;
    unsigned short* xs = Xs + bf * QT * SB_LDX;
    for (int i = tid; i < Q; i += THREADS) {
      sb_cp4(DTs + bf * QT + i, dt + (s0 + i) * p.sds);
      sb_cp4(SCs + bf * QT + i, sc + (s0 + i) * p.sss);
    }
    if (vec) {
      const int nch = N >> 3, xch = pw >> 3;
      for (int idx = tid; idx < Q * nch; idx += THREADS) {
        const int i = idx / nch, ch = idx - i * nch;
        const int d = i * NT + ((ch ^ (i & 7)) << 3);
        sb_cp16(cs + d, Cg + (s0 + i) * p.sCs + ch * 8);
        sb_cp16(bs + d, Bg + (s0 + i) * p.sBs + ch * 8);
      }
      for (int idx = tid; idx < Q * xch; idx += THREADS) {
        const int i = idx / xch, ch = idx - i * xch;
        sb_cp16(xs + i * SB_LDX + ch * 8, x + (s0 + i) * p.sxs + ch * 8);
      }
    } else {
      for (int idx = tid; idx < Q * N; idx += THREADS) {
        const int i = idx / N, n = idx - i * N;
        cs[sb_sw<NT>(i, n)] = Cg[(s0 + i) * p.sCs + n];
        bs[sb_sw<NT>(i, n)] = Bg[(s0 + i) * p.sBs + n];
      }
      for (int idx = tid; idx < Q * pw; idx += THREADS) {
        const int i = idx / pw, j = idx - i * pw;
        xs[i * SB_LDX + j] = x[(s0 + i) * p.sxs + j];
      }
    }
  };

  // the state slice, in the accumulator layout of the warp's tiles mt = mt_w + MSTEP mi:
  // rows n = 16 mt + gq (+ 8 for e >= 2), columns 8 pt_w + 2 tq + (e & 1)
  float hr[MTW][4];
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) hr[mi][e] = 0.0f;

  const int nchunks = p.S / Q;
  load_chunk(0, 0);
  sb_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int bf = c & 1, s0 = c * Q;
    __syncthreads();  // chunk c - 1 no longer reads buffer bf ^ 1 or the state halves
    if (c + 1 < nchunks) load_chunk(c + 1, bf ^ 1);
    sb_commit();
    // the state entering chunk c, as bf16 hi and lo, transposed (column-major B operand)
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * (mt_w + MSTEP * mi) + gq + 8 * (e >> 1);
        const int pc = 8 * pt_w + 2 * tq + (e & 1);
        const float v = hr[mi][e];
        const __nv_bfloat16 hi = __float2bfloat16_rn(v);
        Hh[pc * LDH + n] = __bfloat16_as_ushort(hi);
        Hl[pc * LDH + n] = __bfloat16_as_ushort(__float2bfloat16_rn(v - __bfloat162float(hi)));
      }
    sb_wait_prev();
    __syncthreads();  // chunk c's copies and the state halves are visible

    const unsigned short* cs = Cs + bf * QT * NT;
    const unsigned short* bs = Bs + bf * QT * NT;
    const unsigned short* xs = Xs + bf * QT * SB_LDX;
    const float* scs = SCs + bf * QT;
    float* la = reinterpret_cast<float*>(sb_smem + L::LA0) + warp * 2 * QT;
    float* ws = la + QT;
    {  // la (log2 units): inclusive scan of -A dt / ln 2, a run of E steps per lane,
       // then across the warp
      constexpr int E = QT / 32;
      const float* dts = DTs + bf * QT;
      float v[E], run = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = lane * E + e;
        run += i < Q ? -A2 * dts[i] : 0.0f;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) la[lane * E + e] = incl - run + v[e];
      __syncwarp();
      const float last = la[Q - 1];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = lane * E + e;
        ws[i] = i < Q ? exp2f(last - la[i]) * scs[i] : 0.0f;
      }
      __syncwarp();
    }
    const float la_last = la[Q - 1];
    const int i0 = warp * 16 + gq, i1 = i0 + 8;   // this thread's rows of the chunk
    const float la0 = la[i0], la1 = la[i1];

    uint32_t cf[NKN][4];   // C, rows i0 / i1, as the A operand over N
#pragma unroll
    for (int kn = 0; kn < NKN; ++kn) {
      const int n = 16 * kn + 2 * tq;
      cf[kn][0] = sb_ld2<NT>(cs, i0, n);
      cf[kn][1] = sb_ld2<NT>(cs, i1, n);
      cf[kn][2] = sb_ld2<NT>(cs, i0, n + 8);
      cf[kn][3] = sb_ld2<NT>(cs, i1, n + 8);
    }

    // M = (C B^T) o L o sc_j, on the 8-column tiles that reach the lower triangle
    float sm[NJT][4];
#pragma unroll
    for (int jt = 0; jt < NJT; ++jt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sm[jt][e] = 0.0f;
      if (jt > 2 * warp + 1) continue;
      const int j = 8 * jt + gq;
#pragma unroll
      for (int kn = 0; kn < NKN; ++kn)
        sb_mma(sm[jt], cf[kn], sb_ld2<NT>(bs, j, 16 * kn + 2 * tq),
               sb_ld2<NT>(bs, j, 16 * kn + 2 * tq + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? i0 : i1, jj = 8 * jt + 2 * tq + (e & 1);
        sm[jt][e] = (jj <= i && jj < Q)
                        ? sm[jt][e] * exp2f((e < 2 ? la0 : la1) - la[jj]) * scs[jj]
                        : 0.0f;
      }
    }

    // y = exp(la) o (C h) + M x
    float yv[NPT][4];
#pragma unroll
    for (int pt = 0; pt < NPT; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yv[pt][e] = 0.0f;
#pragma unroll
    for (int kn = 0; kn < NKN; ++kn)
#pragma unroll
      for (int pt = 0; pt < NPT; ++pt) {
        const int at = (8 * pt + gq) * LDH + 16 * kn + 2 * tq;
        sb_mma(yv[pt], cf[kn], *reinterpret_cast<const uint32_t*>(Hh + at),
               *reinterpret_cast<const uint32_t*>(Hh + at + 8));
        sb_mma(yv[pt], cf[kn], *reinterpret_cast<const uint32_t*>(Hl + at),
               *reinterpret_cast<const uint32_t*>(Hl + at + 8));
      }
    const float e0 = exp2f(la0), e1 = exp2f(la1);
#pragma unroll
    for (int pt = 0; pt < NPT; ++pt) {
      yv[pt][0] *= e0;
      yv[pt][1] *= e0;
      yv[pt][2] *= e1;
      yv[pt][3] *= e1;
    }
#pragma unroll
    for (int kk = 0; kk < NKQ; ++kk) {
      if (kk > warp) continue;   // M is lower triangular
      uint32_t ah[4], al[4];
      sb_split(sm[2 * kk][0], sm[2 * kk][1], ah[0], al[0]);
      sb_split(sm[2 * kk][2], sm[2 * kk][3], ah[1], al[1]);
      sb_split(sm[2 * kk + 1][0], sm[2 * kk + 1][1], ah[2], al[2]);
      sb_split(sm[2 * kk + 1][2], sm[2 * kk + 1][3], ah[3], al[3]);
      // x as the B operand, two column tiles a load: rows 16 kk + (0..15), columns 8 pt (+ 8)
      const unsigned short* xrow =
          xs + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * SB_LDX + ((lane >> 4) << 3);
#pragma unroll
      for (int pt = 0; pt < NPT; pt += 2) {
        uint32_t xb[4];
        sb_ldsm_t4(xb, xrow + 8 * pt);
        sb_mma(yv[pt], ah, xb[0], xb[1]);
        sb_mma(yv[pt], al, xb[0], xb[1]);
        sb_mma(yv[pt + 1], ah, xb[2], xb[3]);
        sb_mma(yv[pt + 1], al, xb[2], xb[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = half ? i1 : i0;
      if (i >= Q) continue;
      __nv_bfloat16* row = y + (s0 + i) * p.sys;
#pragma unroll
      for (int pt = 0; pt < NPT; ++pt) {
        const int pc = 8 * pt + 2 * tq;
        const float a = yv[pt][2 * half], v = yv[pt][2 * half + 1];
        if (pairs && pc + 1 < pw) {
          *reinterpret_cast<__nv_bfloat162*>(row + pc) = __floats2bfloat162_rn(a, v);
        } else {
          if (pc < pw) row[pc] = __float2bfloat16_rn(a);
          if (pc + 1 < pw) row[pc + 1] = __float2bfloat16_rn(v);
        }
      }
    }

    // h = exp(la_Q) h + B^T (w o sc o x) on the warp's tiles: A = B^T (exact), the
    // x side (its column tile only) split hi + lo
    const float decay = exp2f(la_last);
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) hr[mi][e] *= decay;
#pragma unroll
    for (int kk = 0; kk < NKQ; ++kk) {
      if (16 * kk >= Q) continue;
      const int j = 16 * kk + 2 * tq;
      uint32_t xr[2];
      sb_ldsm_t2(xr, xs + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * SB_LDX + 8 * pt_w);
      uint32_t uh0, ul0, uh1, ul1;
      sb_split(sb_lo(xr[0]) * ws[j], sb_hi(xr[0]) * ws[j + 1], uh0, ul0);
      sb_split(sb_lo(xr[1]) * ws[j + 8], sb_hi(xr[1]) * ws[j + 9], uh1, ul1);
      // B^T as the A operand: matrices (rows j, columns n) of B, transposed
      const int brow = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
      const int bcol = ((lane >> 3) & 1) << 3;
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi) {
        uint32_t a[4];
        sb_ldsm_t4(a, bs + sb_sw<NT>(brow, 16 * (mt_w + MSTEP * mi) + bcol));
        sb_mma(hr[mi], a, uh0, uh1);
        sb_mma(hr[mi], a, ul0, ul1);
      }
    }
  }

  float* hout = p.hout + ((size_t)b * p.H + h) * N * P + p0;
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 16 * (mt_w + MSTEP * mi) + gq + 8 * (e >> 1);
      const int pc = 8 * pt_w + 2 * tq + (e & 1);
      if (n < N && pc < pw) hout[n * P + pc] = hr[mi][e];
    }
}

template <int QT, int NT>
static int ssd_launch_bf16(const SsdParams& p, int flags, int Bt, void* stream) {
  const int smem = SbLayout<QT, NT>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(ssd_scan_bf16_kernel<QT, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.P + SB_PB - 1) / SB_PB, p.H, Bt);
  ssd_scan_bf16_kernel<QT, NT><<<grid, QT * 2, smem, (cudaStream_t)stream>>>(p, flags);
  return (int)cudaGetLastError();
}

static bool ssd_aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

static int ssd_dispatch_bf16(const SsdParams& p, int Bt, void* stream) {
  const long long s8[] = {p.sxb, p.sxs, p.sxh, p.sBb, p.sBs, p.sBg, p.sCb, p.sCs, p.sCg};
  bool vec = p.N % 8 == 0 && p.P % 8 == 0 && ssd_aligned(p.x, 16) && ssd_aligned(p.B, 16) &&
             ssd_aligned(p.C, 16);
  for (long long s : s8) vec = vec && s % 8 == 0;
  const bool pairs = p.P % 2 == 0 && p.syb % 2 == 0 && p.sys % 2 == 0 && p.syh % 2 == 0 &&
                     ssd_aligned(p.y, 4);
  const int flags = (vec ? 1 : 0) | (pairs ? 2 : 0);
  if (p.Q <= 64)
    return p.N <= 64 ? ssd_launch_bf16<64, 64>(p, flags, Bt, stream)
                     : ssd_launch_bf16<64, 128>(p, flags, Bt, stream);
  return p.N <= 64 ? ssd_launch_bf16<128, 64>(p, flags, Bt, stream)
                   : ssd_launch_bf16<128, 128>(p, flags, Bt, stream);
}

// ---------------------------------------------------------------------------
// tiled float32 template: N or P above SSD_MAX_DIM, on the CUDA cores
// ---------------------------------------------------------------------------
#define ST_PB 32            // state columns (of P) a block owns
#define ST_NT 64            // rows of N in one tile of B and C
#define ST_MAX_DIM 512      // N and P the tiled template takes

static size_t st_smem_floats(int Q, int N) {
  return (size_t)N * (ST_PB + 1) + (size_t)Q * (ST_PB + 1) + 2 * (size_t)Q * (ST_NT + 1) +
         (size_t)Q * (Q + 1) + 2 * (size_t)Q;
}

__device__ __forceinline__ float st_load(const float* p) { return __ldg(p); }
__device__ __forceinline__ void st_store(float* p, float v) { *p = v; }

// acc[a][c] += sum_{k < K} fa(i, k) fb(k, j) for i = ty + 16 a < M (a < TA) and
// j = tx + 16 c < Nn (c < TB).  Out-of-range rows and columns read zeros.
template <int TA, int TB, class FA, class FB>
__device__ __forceinline__ void st_mm(float (&acc)[TA][TB], int M, int Nn, int K, FA fa, FB fb) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int k = 0; k < K; ++k) {
    float av[TA], bv[TB];
#pragma unroll
    for (int a = 0; a < TA; ++a) {
      const int i = ty + 16 * a;
      av[a] = i < M ? fa(i, k) : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < TB; ++c) {
      const int j = tx + 16 * c;
      bv[c] = j < Nn ? fb(k, j) : 0.0f;
    }
#pragma unroll
    for (int a = 0; a < TA; ++a)
#pragma unroll
      for (int c = 0; c < TB; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
  }
}

// TQ: ceil(Q / 16) rows of the chunk a thread row covers
template <class T, int TQ>
__global__ void __launch_bounds__(SSD_THREADS) ssd_scan_tiled_kernel(SsdParams p) {
  extern __shared__ float smem[];
  constexpr int LDP = ST_PB + 1, LDT = ST_NT + 1;
  const int Q = p.Q, N = p.N, P = p.P, LDG = Q + 1;
  float* Hs = smem;              // N x LDP  the state slice
  float* Xs = Hs + N * LDP;      // Q x LDP  in_scale * x, the slice's columns
  float* Ct = Xs + Q * LDP;      // Q x LDT  a tile of C
  float* Bt = Ct + Q * LDT;      // Q x LDT  the same tile of B
  float* Gs = Bt + Q * LDT;      // Q x LDG  (C B^T) o L
  float* la = Gs + Q * LDG;      // Q        cumulative log decay
  float* Ws = la + Q;            // Q        exp(la_Q - la)

  const int p0 = blockIdx.x * ST_PB, h = blockIdx.y, b = blockIdx.z;
  const int pw = min(ST_PB, P - p0);
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float A = __ldg(p.A + h);
  const T* x = (const T*)p.x + b * p.sxb + h * p.sxh + p0;
  const float* dt = p.dt + b * p.sdb + h * p.sdh;
  const float* sc = p.sc + b * p.ssb + h * p.ssh;
  const T* Bg = (const T*)p.B + b * p.sBb + g * p.sBg;
  const T* Cg = (const T*)p.C + b * p.sCb + g * p.sCg;
  T* y = (T*)p.y + b * p.syb + h * p.syh + p0;

  for (int idx = tid; idx < N * LDP; idx += SSD_THREADS) Hs[idx] = 0.0f;

  float gacc[TQ][TQ], yacc[TQ][2], uacc[4][2];
  const int nchunks = p.S / Q;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int s0 = ch * Q;
    // the previous chunk's readers of Xs, Gs, la and Ws are done (and Hs is zeroed)
    __syncthreads();
    for (int i = tid; i < Q; i += SSD_THREADS) la[i] = -A * __ldg(dt + (s0 + i) * p.sds);
    for (int idx = tid; idx < Q * ST_PB; idx += SSD_THREADS) {
      const int i = idx / ST_PB, j = idx - i * ST_PB;
      Xs[i * LDP + j] =
          j < pw ? __ldg(sc + (s0 + i) * p.sss) * st_load(x + (s0 + i) * p.sxs + j) : 0.0f;
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
    const float la_last = la[Q - 1], decay = expf(la_last);
    for (int i = tid; i < Q; i += SSD_THREADS) Ws[i] = expf(la_last - la[i]);  // read after a barrier

#pragma unroll
    for (int a = 0; a < TQ; ++a) {
#pragma unroll
      for (int c = 0; c < TQ; ++c) gacc[a][c] = 0.0f;
      yacc[a][0] = yacc[a][1] = 0.0f;
    }
    for (int n0 = 0; n0 < N; n0 += ST_NT) {
      const int nt = min(ST_NT, N - n0);
      __syncthreads();  // the previous tile's readers of Ct and Bt are done
      for (int idx = tid; idx < Q * ST_NT; idx += SSD_THREADS) {
        const int i = idx / ST_NT, k = idx - i * ST_NT;
        const bool in = k < nt;
        Ct[i * LDT + k] = in ? st_load(Cg + (s0 + i) * p.sCs + n0 + k) : 0.0f;
        Bt[i * LDT + k] = in ? st_load(Bg + (s0 + i) * p.sBs + n0 + k) : 0.0f;
      }
      __syncthreads();
      // C B^T and C h, summed over this tile of N (h: the state entering the chunk)
      st_mm<TQ, TQ>(gacc, Q, Q, nt, [&](int i, int k) { return Ct[i * LDT + k]; },
                    [&](int k, int j) { return Bt[j * LDT + k]; });
      st_mm<TQ, 2>(yacc, Q, pw, nt, [&](int i, int k) { return Ct[i * LDT + k]; },
                   [&](int k, int j) { return Hs[(n0 + k) * LDP + j]; });
      __syncthreads();  // every read of this tile's state rows is done
      // the tile's state rows: h' = exp(la_Q) h + (B o w)^T (in_scale x)
#pragma unroll
      for (int a = 0; a < 4; ++a) uacc[a][0] = uacc[a][1] = 0.0f;
      st_mm<4, 2>(uacc, nt, pw, Q, [&](int i, int k) { return Bt[k * LDT + i] * Ws[k]; },
                  [&](int k, int j) { return Xs[k * LDP + j]; });
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = ty + 16 * a, j = tx + 16 * c;
          if (n < nt && j < pw) {
            float* hv = Hs + (n0 + n) * LDP + j;
            *hv = decay * *hv + uacc[a][c];
          }
        }
    }
    // Gs = (C B^T) o L; y = exp(la) o (C h) + Gs (in_scale x)
#pragma unroll
    for (int a = 0; a < TQ; ++a) {
      const int i = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < TQ; ++c) {
        const int j = tx + 16 * c;
        if (i < Q && j < Q) Gs[i * LDG + j] = j <= i ? gacc[a][c] * expf(la[i] - la[j]) : 0.0f;
      }
      const float e = i < Q ? expf(la[i]) : 0.0f;
      yacc[a][0] *= e;
      yacc[a][1] *= e;
    }
    __syncthreads();  // Gs is complete
    const int kmax = min(Q, ty + 16 * (TQ - 1) + 1);  // L is lower triangular
    st_mm<TQ, 2>(yacc, Q, pw, kmax, [&](int i, int k) { return Gs[i * LDG + k]; },
                 [&](int k, int j) { return Xs[k * LDP + j]; });
#pragma unroll
    for (int a = 0; a < TQ; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = ty + 16 * a, j = tx + 16 * c;
        if (i < Q && j < pw) st_store(y + (s0 + i) * p.sys + j, yacc[a][c]);
      }
  }
  __syncthreads();
  float* hout = p.hout + ((size_t)b * p.H + h) * N * P + p0;
  for (int idx = tid; idx < N * pw; idx += SSD_THREADS) {
    const int n = idx / pw, j = idx - n * pw;
    hout[(size_t)n * P + j] = Hs[n * LDP + j];
  }
}

template <class T, int TQ>
static int ssd_launch_tiled(const SsdParams& p, int Bt, void* stream) {
  const size_t smem = sizeof(float) * st_smem_floats(p.Q, p.N);
  cudaError_t e = cudaFuncSetAttribute(ssd_scan_tiled_kernel<T, TQ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.P + ST_PB - 1) / ST_PB, p.H, Bt);
  ssd_scan_tiled_kernel<T, TQ><<<grid, SSD_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <class T>
static int ssd_dispatch_tiled(const SsdParams& p, int Bt, void* stream) {
  if (p.Q <= 16) return ssd_launch_tiled<T, 1>(p, Bt, stream);
  if (p.Q <= 32) return ssd_launch_tiled<T, 2>(p, Bt, stream);
  if (p.Q <= 64) return ssd_launch_tiled<T, 4>(p, Bt, stream);
  return ssd_launch_tiled<T, 8>(p, Bt, stream);
}

// ---------------------------------------------------------------------------
// tiled bfloat16 template: N or P above SSD_MAX_DIM, tensor cores, a cluster
// of the blocks of a (head, batch)
// ---------------------------------------------------------------------------
namespace cg = cooperative_groups;

#define TB_QT 64            // the chunk tile; a longer chunk runs as its largest divisor up to it
#define TB_WARPS 8          // warps of a P-split block
#define TB_THREADS (TB_WARPS * 32)
#define TB_PB 32            // P-split: state columns a block owns
#define TB_NB 64            // N-split: state rows a block owns
#define TB_NSPLIT_MAX_P 8   // P up to this splits N (one 8-column tile)
#define TB_CLUSTER 2        // P-split cluster: a pair (see the notes at the top)

// byte offsets of the P-split layout, from a 1024-byte aligned base (ssd/kernel.py
// smem_bytes mirrors BYTES)
struct TpLayout {
  static constexpr int QT = TB_QT;
  static constexpr int NTL = 256;                         // rows of N in a ring tile
  static constexpr int NTILES = ST_MAX_DIM / NTL;         // ring tiles over N = 512
  static constexpr int HALVES = NTL / 64;                 // 64-column TMA boxes a tile
  static constexpr int STAGES = 2;
  static constexpr int CB = STAGES + 1;                   // chunk buffers of x, dt, in_scale
  static constexpr int NQT = QT / 16;
  static constexpr int STILES = NQT * (NQT + 1) / 2;      // 16 x 16 tiles of the lower triangle
  static constexpr int MAXOWN = (STILES + TB_CLUSTER - 1) / TB_CLUSTER;  // a block's score tiles
  static constexpr int LDX = TB_PB + 8, LDU = QT + 8, LDY = TB_PB + 2;
  static constexpr int TILE = QT * NTL * 2;               // one B or C tile: HALVES 128B-swizzled boxes
  static constexpr int RING0 = 0;                         // [STAGES] {C tile, B tile}
  static constexpr int X0 = RING0 + STAGES * 2 * TILE;    // [CB] x slice, bf16
  static constexpr int DT0 = X0 + CB * QT * LDX * 2;      // [CB] dt
  static constexpr int SC0 = DT0 + CB * QT * 4;           // [CB] in_scale
  static constexpr int UH0 = SC0 + CB * QT * 4;           // (w o sc o x)^T hi, [TB_PB][LDU]
  static constexpr int UL0 = UH0 + TB_PB * LDU * 2;       // ... lo
  static constexpr int LA0 = UL0 + TB_PB * LDU * 2;       // per warp: la [QT]
  static constexpr int SY0 = LA0 + TB_WARPS * QT * 4;     // M hi, lo, [2][STILES][2][16][16] bf16
  static constexpr int YP0 = SY0 + 2 * STILES * 256 * 4;  // e o (C h) partials [4][QT][LDY]
  static constexpr int BYTES = YP0 + 4 * QT * LDY * 4;
  static constexpr int ALLOC = BYTES + 1024;              // with the base's alignment
  // a warp adds its columns of N to half of each of the block's 5 score tiles, and the
  // partials, [unit][4][16][8] floats, meet in the last tile's ring slot
  static_assert(MAXOWN == 5 && NQT == 4 && 2 * MAXOWN * 4 * 128 * 4 <= 2 * TILE, "the partials fit");
};

// byte offsets of the N-split layout (P up to 8: one 8-column tile; kernel.py mirrors BYTES)
struct TnLayout {
  static constexpr int QT = TB_QT, NW = QT / 16, PX = 8;
  static constexpr int LDX = PX + 8, LDH = TB_NB + 8, LDS = QT + 4, RBMAX = QT / 4;
  static constexpr int TILE = QT * TB_NB * 2;             // B or C columns of the block, swizzled
  static constexpr int C0 = 0;                            // C[2]
  static constexpr int B0 = C0 + 2 * TILE;                // B[2]
  static constexpr int X0 = B0 + 2 * TILE;                // x[2], bf16
  static constexpr int DT0 = X0 + 2 * QT * LDX * 2;       // dt[2]
  static constexpr int SC0 = DT0 + 2 * QT * 4;            // in_scale[2]
  static constexpr int HH0 = SC0 + 2 * QT * 4;            // state hi, bf16 [PX][LDH], transposed
  static constexpr int HL0 = HH0 + PX * LDH * 2;          // state lo
  static constexpr int LA0 = HL0 + PX * LDH * 2;          // per warp: la [QT], w o sc [QT]
  static constexpr int SP0 = LA0 + NW * 2 * QT * 4;       // this block's partial scores [2][QT][LDS]
  static constexpr int YP0 = SP0 + 2 * QT * LDS * 4;      // its partial C h [2][QT][PX]
  static constexpr int MR0 = YP0 + 2 * QT * PX * 4;       // its rows of M = S o L o sc [RBMAX][LDS]
  static constexpr int YC0 = MR0 + RBMAX * LDS * 4;       // its rows of C h [RBMAX][PX]
  static constexpr int BYTES = YC0 + RBMAX * PX * 4;
};

// d (16 x 8, f32) += a (16 x 16, bf16) b (16 x 8, bf16); not volatile, so the compiler may
// interleave independent products between the (ordered) shared-memory loads
__device__ __forceinline__ void tb_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t tb_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// ldmatrix at a shared-memory address: lane l gives the address of row l & 7 of matrix l / 8
// (x4) or (l & 15) / 8 (x2); .trans transposes each 8 x 8 matrix
__device__ __forceinline__ void tb_ldsm2(uint32_t (&r)[2], uint32_t row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(row));
}
__device__ __forceinline__ void tb_ldsm4(uint32_t (&r)[4], uint32_t row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(row));
}
__device__ __forceinline__ void tb_ldsm4_t(uint32_t (&r)[4], uint32_t row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(row));
}
// 16-byte copy of `bytes` (16 or 0) bytes, the rest zero-filled
__device__ __forceinline__ void tb_cp16z(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes) : "memory");
}
template <int NG>
__device__ __forceinline__ void tb_wait_groups() {
  asm volatile("cp.async.wait_group %0;" ::"n"(NG) : "memory");
}
// mbarriers and TMA, as flash_fwd.cu uses them
__device__ __forceinline__ void tb_mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void tb_mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// waits for the phase of the given parity to complete; a wait of more than about 10 s traps
// (the launch then fails) instead of hanging the card
__device__ __forceinline__ void tb_mbar_wait(uint32_t bar, uint32_t parity) {
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
// one box of a 4-D tensor map: coordinates (column, seq, group, batch) placed at the map's
// dimensions pos[0..2] (dimension 0 is always the column)
__device__ __forceinline__ void tb_tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                           const int (&pos)[3], int col, int seq, int grp,
                                           int batch) {
  const int c1 = pos[0] == 1 ? seq : pos[1] == 1 ? grp : batch;
  const int c2 = pos[0] == 2 ? seq : pos[1] == 2 ? grp : batch;
  const int c3 = pos[0] == 3 ? seq : pos[1] == 3 ? grp : batch;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"((unsigned long long)map), "r"(bar), "r"(col), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// split arrive (release) / wait (acquire) of the cluster barrier
__device__ __forceinline__ void tb_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" : : : "memory");
}
__device__ __forceinline__ void tb_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}

// la (log2 units) of the chunk into la[0, QT): the inclusive scan of -A2 dt over
// the Q steps, one warp (the rows past Q repeat la[Q - 1])
template <int QT>
__device__ __forceinline__ void tb_scan(float* la, const float* dts, float A2, int Q, int lane) {
  constexpr int E = QT / 32;
  float v[E], run = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    run += i < Q ? -A2 * dts[i] : 0.0f;
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) la[lane * E + e] = incl - run + v[e];
  __syncwarp();
}

// element (i, n) of a ring tile: 64-column boxes of QT rows, each 128-byte swizzled (the
// 16-byte chunk (n mod 64) / 8 XOR (i mod 8)), as TMA writes them
template <int QT>
__device__ __forceinline__ int tb_at(int i, int n) {
  return ((n >> 6) * QT + i) * 64 + ((((n >> 3) & 7) ^ (i & 7)) << 3) + (n & 7);
}

// element (r, c) of a packed 16 x 16 bf16 tile: 32-byte rows, the 16-byte chunk c / 8 XOR
// (r / 4) mod 2, so the eight rows of an ldmatrix matrix hit distinct banks
__device__ __forceinline__ int tb_mt(int r, int c) {
  return r * 16 + ((((c >> 3) ^ (r >> 2)) & 1) << 3) + (c & 7);
}

// row tile of lower-triangle tile id (< 10), by arithmetic so that it folds
__device__ __forceinline__ constexpr int tb_ti(int id) {
  return id < 1 ? 0 : id < 3 ? 1 : id < 6 ? 2 : 3;
}
// one 16-wide k-step of the score units of block RANK of a pair (tiles RANK, RANK + 2,
// .., columns 8 pm ..), A the C fragments a[ti] that C h loaded for the same k-step
// (the B rows' address: bs, the tile of B, plus this thread's row 8 pm + lane & 7 at the k-step)
template <int RANK>
__device__ __forceinline__ void tb_s_reuse(float (&so)[5][4], const uint32_t (&a)[4][4],
                                           uint32_t brow) {
#pragma unroll
  for (int o = 0; o < 5; ++o) {
    const int id = RANK + 2 * o, ti = tb_ti(id), tj = id - ti * (ti + 1) / 2;
    uint32_t b[2];
    tb_ldsm2(b, brow + 2048 * tj);   // 16 rows of 64 bf16 a row tile
    tb_mma(so[o], a[ti], b[0], b[1]);
  }
}

// P split over the cluster: block r of a (head, batch)'s cluster owns state columns 32 x
// blockIdx.x ..; flags bit 0: B and C through TMA (16-byte aligned bases and strides, N a
// multiple of 8), bit 1: y takes bf16 pairs, bit 2: x takes 16-byte copies
__device__ __forceinline__ void tb_split_p(const SsdParams& p, int flags, unsigned char* smem_raw,
                                           const CUtensorMap* map_b, const CUtensorMap* map_c,
                                           unsigned long long* bars) {
  using L = TpLayout;
  constexpr int QT = L::QT, NTL = L::NTL, NQT = L::NQT, STAGES = L::STAGES, CB = L::CB;
  constexpr int LDX = L::LDX, LDU = L::LDU, LDY = L::LDY;
  constexpr int NSW = NTL / 4, NN8 = NSW / 8, NKW = NSW / 16;  // a warp's n columns of a tile
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int K = TB_CLUSTER;
  const int r = (int)cluster.block_rank();
  unsigned char* smem = smem_raw + ((1024 - (tb_smem_addr(smem_raw) & 1023)) & 1023);
  unsigned short* ring = reinterpret_cast<unsigned short*>(smem + L::RING0);
  unsigned short* Xs = reinterpret_cast<unsigned short*>(smem + L::X0);
  float* DTs = reinterpret_cast<float*>(smem + L::DT0);
  float* SCs = reinterpret_cast<float*>(smem + L::SC0);
  unsigned short* UH = reinterpret_cast<unsigned short*>(smem + L::UH0);
  unsigned short* UL = reinterpret_cast<unsigned short*>(smem + L::UL0);
  unsigned short* SM = reinterpret_cast<unsigned short*>(smem + L::SY0);
  float* YP = reinterpret_cast<float*>(smem + L::YP0);

  const int Q = p.Q, N = p.N, P = p.P;
  const int p0 = blockIdx.x * TB_PB, h = blockIdx.y, b = blockIdx.z;
  const int pw = min(TB_PB, P - p0);   // <= 0 in a block that pads the cluster
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int pm = warp & 1, ns = warp >> 1;   // the warp's p rows 16 pm and n columns NSW ns
  const bool tma = flags & 1, pairs = flags & 2, xvec = flags & 4;
  const float A2 = __ldg(p.A + h) * 1.4426950408889634f;
  const unsigned short* x = (const unsigned short*)p.x + b * p.sxb + h * p.sxh + p0;
  const float* dt = p.dt + b * p.sdb + h * p.sdh;
  const float* sc = p.sc + b * p.ssb + h * p.ssh;
  const unsigned short* Bg = (const unsigned short*)p.B + b * p.sBb + g * p.sBg;
  const unsigned short* Cg = (const unsigned short*)p.C + b * p.sCb + g * p.sCg;
  __nv_bfloat16* y = (__nv_bfloat16*)p.y + b * p.syb + h * p.syh + p0;
  float* la = reinterpret_cast<float*>(smem + L::LA0) + warp * QT;
  const uint32_t bar0 = tb_smem_addr(bars);   // full[s] = bar0 + 8 s
  const uint32_t ring_s = tb_smem_addr(ring);
  // byte offsets in a ring tile of this thread's ldmatrix rows at the warp's k-step kq: row
  // lane & 15 (C h's A = C; the update's B = B, rows 16 kk + .. a step of 2048 bytes) and row
  // 8 pm + lane & 7 (the score units' B); the swizzle depends only on lane and k-step
  uint32_t off_a[NKW], off_s[NKW];
#pragma unroll
  for (int kq = 0; kq < NKW; ++kq) {
    off_a[kq] = 2 * tb_at<QT>(lane & 15, ns * NSW + 16 * kq + ((lane >> 4) << 3));
    off_s[kq] = 2 * tb_at<QT>(8 * pm + (lane & 7), ns * NSW + 16 * kq + (((lane >> 3) & 1) << 3));
  }
  // this thread's row of the U operand (p 16 pm + lane & 15, steps 8 (lane >> 4) ..), hi
  const uint32_t u_s = tb_smem_addr(UH + (16 * pm + (lane & 15)) * LDU + ((lane >> 4) << 3));

  // rows past Q and columns past the slice are never written: zero them once
  for (int i = tid; i < L::BYTES / 16; i += TB_THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) tb_mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // the zeros, before TMA writes
  __syncthreads();

  const int ntiles = (N + NTL - 1) / NTL, nchunks = p.S / Q, total = nchunks * ntiles;
  // ring tile k: chunk k / ntiles, N rows NTL (k % ntiles) on (B and C by TMA from warp 7's
  // first thread, or plain loads); the chunk's x, dt and in_scale come with its first tile,
  // by cp.async
  auto load_tile = [&](int k) {
    const int c = k / ntiles, t = k - c * ntiles, cb = c % CB, slot = k % STAGES;
    const int s0 = c * Q, n0 = t * NTL;
    unsigned short* cs = ring + slot * 2 * QT * NTL;
    unsigned short* bs = cs + QT * NTL;
    if (tma) {
      if (tid == TB_THREADS - 32) {
        const uint32_t bar = bar0 + 8 * slot;
        // the slot last held the chunk's score partials (generic writes), before this async write
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        tb_mbar_expect_tx(bar, 2 * L::HALVES * Q * 128);
#pragma unroll
        for (int hf = 0; hf < L::HALVES; ++hf) {
          tb_tma_box(tb_smem_addr(cs + hf * QT * 64), map_c, bar, p.tpos[1], n0 + 64 * hf, s0, g, b);
          tb_tma_box(tb_smem_addr(bs + hf * QT * 64), map_b, bar, p.tpos[0], n0 + 64 * hf, s0, g, b);
        }
      }
    } else {
      for (int idx = tid; idx < Q * NTL; idx += TB_THREADS) {
        const int i = idx / NTL, nl = idx - i * NTL, n = n0 + nl;
        cs[tb_at<QT>(i, nl)] = n < N ? Cg[(s0 + i) * p.sCs + n] : (unsigned short)0;
        bs[tb_at<QT>(i, nl)] = n < N ? Bg[(s0 + i) * p.sBs + n] : (unsigned short)0;
      }
    }
    if (t == 0) {
      for (int i = tid; i < Q; i += TB_THREADS) {
        sb_cp4(DTs + cb * QT + i, dt + (s0 + i) * p.sds);
        sb_cp4(SCs + cb * QT + i, sc + (s0 + i) * p.sss);
      }
      unsigned short* xs = Xs + cb * QT * LDX;
      const int w = max(pw, 0);
      if (xvec) {
        for (int idx = tid; idx < Q * (w >> 3); idx += TB_THREADS) {
          const int i = idx / (w >> 3), ch = idx - i * (w >> 3);
          sb_cp16(xs + i * LDX + ch * 8, x + (s0 + i) * p.sxs + ch * 8);
        }
      } else {
        for (int idx = tid; idx < Q * w; idx += TB_THREADS) {
          const int i = idx / w, j = idx - i * w;
          xs[i * LDX + j] = x[(s0 + i) * p.sxs + j];
        }
      }
    }
  };

  // M = S o L o sc_j of chunk c at (i, j), zero above the diagonal and past Q
  auto mval = [&](float s_ij, int i, int j, const float* scs) {
    return (j <= i && j < Q) ? s_ij * exp2f(la[i] - la[j]) * scs[j] : 0.0f;
  };
  // (hi, lo) bf16 pairs of M at (i, j), (i, j + 1) into every block's packed tile id of
  // buffer mb
  auto push_m = [&](int mb, int id, int rl, int cl, uint32_t hi, uint32_t lo) {
    unsigned short* dst = SM + (mb * L::STILES + id) * 512 + tb_mt(rl, cl);
    for (int q = 0; q < K; ++q) {
      unsigned short* rd = cluster.map_shared_rank(dst, q);
      *reinterpret_cast<uint32_t*>(rd) = hi;
      *reinterpret_cast<uint32_t*>(rd + 256) = lo;
    }
  };

  // the state slice, transposed: hs[t][q][e] = h[n][p] at p = 16 pm + gq + 8 (e >> 1),
  // n = NTL t + NSW ns + 8 q + 2 tq + (e & 1)
  float hs[L::NTILES][NN8][4];
#pragma unroll
  for (int t = 0; t < L::NTILES; ++t)
#pragma unroll
    for (int q = 0; q < NN8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) hs[t][q][e] = 0.0f;
  // y's partial over the warp's n columns: yp[mt][gp][e] at row 16 mt + gq + 8 (e >> 1),
  // column 16 pm + 8 gp + 2 tq + (e & 1)
  float yp[NQT][2][4];
  float so[L::MAXOWN][4];   // the warp's partials of its score units

  // y of chunk c: e o (C h) from the four partial slabs, plus M x on the tensor cores, M the
  // chunk's scores o L o sc_j split hi + lo; warp w takes the 16 x 16 output tiles w, w + 8, ...
  auto finish_y = [&](int c) {
    const int cb = c % CB, s0 = c * Q;
    const unsigned short* xs = Xs + cb * QT * LDX;
    tb_cluster_wait();   // every tile of chunk c's M is in every block
#pragma unroll
    for (int u = warp; u < 2 * NQT; u += TB_WARPS) {
      const int mt = u >> 1, pg = u & 1;
      if (16 * mt >= Q) continue;
      float acc[2][4] = {};
      const int ia = 16 * mt + gq;
      for (int kk = 0; kk <= mt; ++kk) {
        uint32_t xb[4], ah[4], al[4];
        tb_ldsm4_t(xb, tb_smem_addr(xs + (16 * kk + (((lane >> 3) & 1) << 3) + (lane & 7)) * LDX +
                                    16 * pg + ((lane >> 4) << 3)));
        const uint32_t mtile = tb_smem_addr(SM + ((c & 1) * L::STILES + mt * (mt + 1) / 2 + kk) * 512 +
                                            tb_mt(lane & 15, 8 * (lane >> 4)));
        tb_ldsm4(ah, mtile);
        tb_ldsm4(al, mtile + 512);
        tb_mma(acc[0], ah, xb[0], xb[1]);
        tb_mma(acc[1], ah, xb[2], xb[3]);
        tb_mma(acc[0], al, xb[0], xb[1]);
        tb_mma(acc[1], al, xb[2], xb[3]);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = ia + 8 * hf;
        if (i >= Q) continue;
        __nv_bfloat16* row = y + (s0 + i) * p.sys;
#pragma unroll
        for (int gp = 0; gp < 2; ++gp) {
          const int pc = 16 * pg + 8 * gp + 2 * tq;
          float v0 = acc[gp][2 * hf], v1 = acc[gp][2 * hf + 1];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const float2 t2 = *reinterpret_cast<const float2*>(YP + (w * QT + i) * LDY + pc);
            v0 += t2.x, v1 += t2.y;
          }
          if (pairs && pc + 1 < pw) {
            *reinterpret_cast<__nv_bfloat162*>(row + pc) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (pc < pw) row[pc] = __float2bfloat16_rn(v0);
            if (pc + 1 < pw) row[pc + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
    // chunk c + 2's pushes into this buffer come after the pushers' wait for chunk c + 1's
    // barrier, which this block reaches after these reads
  };

  // chunk c's la (the warp's copy), U = (w o sc o x)^T, w = exp2(la_Q - la), as bf16 hi and
  // lo (a warp takes 8 columns p by 4 step pairs j: conflict-free reads of x and writes of U),
  // and zeroed accumulators
  auto prepare = [&](int c) {
    const int cb = c % CB;
    const float* scs = SCs + cb * QT;
    const unsigned short* xs = Xs + cb * QT * LDX;
    tb_scan<QT>(la, DTs + cb * QT, A2, Q, lane);
    const float last = la[Q - 1];
#pragma unroll
    for (int e = tid; e < TB_PB * (QT / 2); e += TB_THREADS) {
      const int wi = e >> 5, pc = 8 * (wi & 3) + (e & 7), j = 2 * (4 * (wi >> 2) + ((e >> 3) & 3));
      const float w0 = j < Q ? exp2f(last - la[j]) * scs[j] : 0.0f;
      const float w1 = j + 1 < Q ? exp2f(last - la[j + 1]) * scs[j + 1] : 0.0f;
      uint32_t hi, lo;
      sb_split(__bfloat162float(__ushort_as_bfloat16(xs[j * LDX + pc])) * w0,
               __bfloat162float(__ushort_as_bfloat16(xs[(j + 1) * LDX + pc])) * w1, hi, lo);
      *reinterpret_cast<uint32_t*>(UH + pc * LDU + j) = hi;
      *reinterpret_cast<uint32_t*>(UL + pc * LDU + j) = lo;
    }
#pragma unroll
    for (int mt = 0; mt < NQT; ++mt)
#pragma unroll
      for (int e = 0; e < 8; ++e) yp[mt][e >> 2][e & 3] = 0.0f;
#pragma unroll
    for (int o = 0; o < L::MAXOWN; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) so[o][e] = 0.0f;
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_tile(s);
    sb_commit();
  }
  tb_cluster_arrive();   // started: the cluster's first pushes wait for this
  tb_wait_groups<0>();
  __syncthreads();       // chunk 0's x, dt and in_scale are in
  prepare(0);

  for (int c = 0; c < nchunks; ++c) {
    const float* scs = SCs + (c % CB) * QT;
#pragma unroll
    for (int t = 0; t < L::NTILES; ++t) {
      if (t >= ntiles) continue;
      const int k = c * ntiles + t, slot = k % STAGES;
      tb_wait_groups<STAGES - 2>();
      if (tma) tb_mbar_wait(bar0 + 8 * slot, (k / STAGES) & 1);
      __syncthreads();   // tile k has landed (and, at t == 0, U); tile k - 1's slot is free
      if (k + STAGES - 1 < total) load_tile(k + STAGES - 1);
      sb_commit();
      const uint32_t cs = ring_s + slot * 4 * QT * NTL, bs = cs + 2 * QT * NTL;   // bytes

      // y += C h over the warp's columns of the tile, h the state entering the chunk:
      // A = C (exact), B = the state's accumulators, split hi + lo
#pragma unroll
      for (int kq = 0; kq < NKW; ++kq) {
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int gp = 0; gp < 2; ++gp) {
          sb_split(hs[t][2 * kq][2 * gp], hs[t][2 * kq][2 * gp + 1], bh[gp][0], bl[gp][0]);
          sb_split(hs[t][2 * kq + 1][2 * gp], hs[t][2 * kq + 1][2 * gp + 1], bh[gp][1], bl[gp][1]);
        }
        uint32_t a[NQT][4];
#pragma unroll
        for (int mt = 0; mt < NQT; ++mt) tb_ldsm4(a[mt], cs + off_a[kq] + 2048 * mt);
#pragma unroll
        for (int mt = 0; mt < NQT; ++mt)
#pragma unroll
          for (int gp = 0; gp < 2; ++gp) tb_mma(yp[mt][gp], a[mt], bh[gp][0], bh[gp][1]);
        if (r == 0)   // this block's score units, from the same C fragments
          tb_s_reuse<0>(so, a, bs + off_s[kq]);
        else
          tb_s_reuse<1>(so, a, bs + off_s[kq]);
#pragma unroll
        for (int mt = 0; mt < NQT; ++mt)
#pragma unroll
          for (int gp = 0; gp < 2; ++gp) tb_mma(yp[mt][gp], a[mt], bl[gp][0], bl[gp][1]);
      }

      // the warp's state entries of the tile: h = exp2(la_Q) h + U B (A = U hi + lo, B exact)
      const float decay = exp2f(la[Q - 1]);
#pragma unroll
      for (int q = 0; q < NN8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) hs[t][q][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < NQT; ++kk) {   // (rows past Q are zeros in U and B)
        uint32_t ah[4], al[4];
        tb_ldsm4(ah, u_s + 32 * kk);
        tb_ldsm4(al, u_s + 2 * TB_PB * LDU + 32 * kk);
        uint32_t bt[NN8 / 2][4];
#pragma unroll
        for (int q2 = 0; q2 < NN8 / 2; ++q2) tb_ldsm4_t(bt[q2], bs + off_a[q2] + 2048 * kk);
#pragma unroll
        for (int q = 0; q < NN8; ++q) tb_mma(hs[t][q], ah, bt[q >> 1][2 * (q & 1)], bt[q >> 1][2 * (q & 1) + 1]);
#pragma unroll
        for (int q = 0; q < NN8; ++q) tb_mma(hs[t][q], al, bt[q >> 1][2 * (q & 1)], bt[q >> 1][2 * (q & 1) + 1]);
      }
      if (t == 0 && c > 0) {   // the last chunk's y, its scores' barrier hidden behind this tile
        finish_y(c - 1);
      }
    }

    // ---- the chunk's end: e o (C h) into the slabs, the score tiles out to the cluster ---
#pragma unroll
    for (int mt = 0; mt < NQT; ++mt) {
      const float e0 = exp2f(la[16 * mt + gq]), e1 = exp2f(la[16 * mt + gq + 8]);
#pragma unroll
      for (int gp = 0; gp < 2; ++gp) {
        yp[mt][gp][0] *= e0;
        yp[mt][gp][1] *= e0;
        yp[mt][gp][2] *= e1;
        yp[mt][gp][3] *= e1;
      }
    }
    __syncthreads();   // the chunk's tiles are done (the last ring slot takes the score
                       // partials); finish_y(c - 1) has read the slabs
#pragma unroll
    for (int mt = 0; mt < NQT; ++mt)
#pragma unroll
      for (int gp = 0; gp < 2; ++gp)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(YP + (ns * QT + 16 * mt + gq + 8 * hf) * LDY + 16 * pm +
                                     8 * gp + 2 * tq) =
              make_float2(yp[mt][gp][2 * hf], yp[mt][gp][2 * hf + 1]);
    // the score partials, [unit (o, pm)][ns][16][8], in the last tile's ring slot
    float* slots = reinterpret_cast<float*>(ring + ((c * ntiles + ntiles - 1) % STAGES) * 2 * QT * NTL);
#pragma unroll
    for (int o = 0; o < L::MAXOWN; ++o) {
      float* sl = slots + ((2 * o + pm) * 4 + ns) * 128 + gq * 8 + 2 * tq;
      *reinterpret_cast<float2*>(sl) = make_float2(so[o][0], so[o][1]);
      *reinterpret_cast<float2*>(sl + 64) = make_float2(so[o][2], so[o][3]);
    }
    if (c + 1 < nchunks) tb_wait_groups<0>();   // chunk c + 1's x, dt, in_scale (came with
                                                 // its first tile, issued in this chunk)
    __syncthreads();   // the partials are written; every warp is done with U; chunk c + 1's data
    if (c == 0) tb_cluster_wait();   // every block started
    for (int e = tid; e < L::MAXOWN * 2 * 64; e += TB_THREADS) {   // the units' four partials, summed
      const int o = e >> 7, jh = (e >> 6) & 1, el = e & 63, rl = el >> 2, cl = 2 * (el & 3);
      const int id = r + K * o;
      float v0 = 0.0f, v1 = 0.0f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 t2 = *reinterpret_cast<const float2*>(slots + ((2 * o + jh) * 4 + w) * 128 +
                                                           rl * 8 + cl);
        v0 += t2.x, v1 += t2.y;
      }
      const int ti = tb_ti(id), i = 16 * ti + rl, j = 16 * (id - ti * (ti + 1) / 2) + 8 * jh + cl;
      uint32_t hi, lo;
      sb_split(mval(v0, i, j, scs), mval(v1, i, j + 1, scs), hi, lo);
      push_m(c & 1, id, rl, 8 * jh + cl, hi, lo);
    }
    tb_cluster_arrive();   // this chunk's score tiles are pushed
    if (c + 1 < nchunks) prepare(c + 1);
  }
  if (nchunks > 0) finish_y(nchunks - 1);

  if (pw <= 0) return;
  float* hout = p.hout + ((size_t)b * p.H + h) * N * P + p0;
#pragma unroll
  for (int t = 0; t < L::NTILES; ++t)
#pragma unroll
    for (int q = 0; q < NN8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = NTL * t + NSW * ns + 8 * q + 2 * tq + (e & 1);
        const int pc = 16 * pm + gq + 8 * (e >> 1);
        if (n < N && pc < pw) hout[(size_t)n * P + pc] = hs[t][q][e];
      }
}

// N split over the cluster: block r owns state rows TB_NB r .. and all of P (<= 8: one tile)
__device__ __forceinline__ void tb_split_n(const SsdParams& p, int flags, unsigned char* smem) {
  using L = TnLayout;
  constexpr int QT = L::QT, NW = L::NW, THREADS = NW * 32, PX = L::PX, LDX = L::LDX;
  constexpr int LDH = L::LDH, LDS = L::LDS, NT = TB_NB;
  constexpr int NJT = QT / 8, NKQ = QT / 16, NKN = NT / 16;
  constexpr int XPT = (QT * PX + THREADS - 1) / THREADS;  // x entries a thread loads
  static_assert(NT / 16 == NW, "warp w owns the state's row tile w");
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  unsigned short* Cs = reinterpret_cast<unsigned short*>(smem + L::C0);
  unsigned short* Bs = reinterpret_cast<unsigned short*>(smem + L::B0);
  unsigned short* Xs = reinterpret_cast<unsigned short*>(smem + L::X0);
  float* DTs = reinterpret_cast<float*>(smem + L::DT0);
  float* SCs = reinterpret_cast<float*>(smem + L::SC0);
  unsigned short* Hh = reinterpret_cast<unsigned short*>(smem + L::HH0);
  unsigned short* Hl = reinterpret_cast<unsigned short*>(smem + L::HL0);
  float* SP0s = reinterpret_cast<float*>(smem + L::SP0);
  float* YP0s = reinterpret_cast<float*>(smem + L::YP0);
  float* MR = reinterpret_cast<float*>(smem + L::MR0);
  float* YC = reinterpret_cast<float*>(smem + L::YC0);

  const int Q = p.Q, N = p.N, P = p.P;
  const int n0 = r * NT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const bool vec = flags & 1;
  const float A2 = __ldg(p.A + h) * 1.4426950408889634f;
  const unsigned short* x = (const unsigned short*)p.x + b * p.sxb + h * p.sxh;
  const float* dt = p.dt + b * p.sdb + h * p.sdh;
  const float* sc = p.sc + b * p.ssb + h * p.ssh;
  const unsigned short* Bg = (const unsigned short*)p.B + b * p.sBb + g * p.sBg;
  const unsigned short* Cg = (const unsigned short*)p.C + b * p.sCb + g * p.sCg;
  __nv_bfloat16* y = (__nv_bfloat16*)p.y + b * p.syb + h * p.syh;
  const int RB = (Q + K - 1) / K, ilo = r * RB, nrows = min(Q, ilo + RB) - ilo;  // y rows

  for (int i = tid; i < L::BYTES / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto load_bc = [&](int c, int bf) {   // this block's columns of B and C, dt, in_scale
    const int s0 = c * Q;
    unsigned short* cs = Cs + bf * QT * NT;
    unsigned short* bs = Bs + bf * QT * NT;
    for (int i = tid; i < Q; i += THREADS) {
      sb_cp4(DTs + bf * QT + i, dt + (s0 + i) * p.sds);
      sb_cp4(SCs + bf * QT + i, sc + (s0 + i) * p.sss);
    }
    if (vec) {
      for (int idx = tid; idx < Q * (NT / 8); idx += THREADS) {
        const int i = idx / (NT / 8), ch = idx - i * (NT / 8), n = n0 + 8 * ch;
        const int d = i * NT + ((ch ^ (i & 7)) << 3);
        const bool in = n < N;
        tb_cp16z(cs + d, in ? Cg + (s0 + i) * p.sCs + n : Cg, in ? 16 : 0);
        tb_cp16z(bs + d, in ? Bg + (s0 + i) * p.sBs + n : Bg, in ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < Q * NT; idx += THREADS) {
        const int i = idx / NT, nl = idx - i * NT, n = n0 + nl;
        cs[sb_sw<NT>(i, nl)] = n < N ? Cg[(s0 + i) * p.sCs + n] : (unsigned short)0;
        bs[sb_sw<NT>(i, nl)] = n < N ? Bg[(s0 + i) * p.sBs + n] : (unsigned short)0;
      }
    }
  };
  // x (P may be 1: no 16-byte copies) goes through registers, loaded a chunk ahead
  auto load_x = [&](int c, unsigned short (&xr)[XPT]) {
#pragma unroll
    for (int m = 0; m < XPT; ++m) {
      const int idx = tid + THREADS * m, i = idx / PX, pc = idx - i * PX;
      xr[m] = (i < Q && pc < P) ? x[(c * Q + i) * p.sxs + pc] : (unsigned short)0;
    }
  };
  auto store_x = [&](const unsigned short (&xr)[XPT], int bf) {
#pragma unroll
    for (int m = 0; m < XPT; ++m) {
      const int idx = tid + THREADS * m, i = idx / PX, pc = idx - i * PX;
      if (i < QT) Xs[bf * QT * LDX + i * LDX + pc] = xr[m];
    }
  };

  // the warp's state tile: rows 16 warp + gq (+ 8 for e >= 2) of the block's, columns
  // 2 tq + (e & 1)
  float hr[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  const int nchunks = p.S / Q;
  load_bc(0, 0);
  sb_commit();
  {
    unsigned short xr[XPT];
    load_x(0, xr);
    store_x(xr, 0);
  }
  for (int c = 0; c < nchunks; ++c) {
    const int bf = c & 1, s0 = c * Q;
    __syncthreads();   // chunk c - 1 no longer reads buffer bf ^ 1, the state halves, MR or YC
    if (c + 1 < nchunks) load_bc(c + 1, bf ^ 1);
    sb_commit();
    unsigned short xr[XPT];
    if (c + 1 < nchunks) load_x(c + 1, xr);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int nl = 16 * warp + gq + 8 * (e >> 1), pc = 2 * tq + (e & 1);
      const __nv_bfloat16 hi = __float2bfloat16_rn(hr[e]);
      Hh[pc * LDH + nl] = __bfloat16_as_ushort(hi);
      Hl[pc * LDH + nl] = __bfloat16_as_ushort(__float2bfloat16_rn(hr[e] - __bfloat162float(hi)));
    }
    sb_wait_prev();
    __syncthreads();   // chunk c's copies and x, and the state halves, are visible

    const unsigned short* cs = Cs + bf * QT * NT;
    const unsigned short* bs = Bs + bf * QT * NT;
    const unsigned short* xs = Xs + bf * QT * LDX;
    const float* scs = SCs + bf * QT;
    float* la = reinterpret_cast<float*>(smem + L::LA0) + warp * 2 * QT;
    float* ws = la + QT;
    tb_scan<QT>(la, DTs + bf * QT, A2, Q, lane);
    const float la_last = la[Q - 1];
#pragma unroll
    for (int e = 0; e < QT / 32; ++e) {
      const int i = lane * (QT / 32) + e;
      ws[i] = i < Q ? exp2f(la_last - la[i]) * scs[i] : 0.0f;
    }
    __syncwarp();
    const int i0 = warp * 16 + gq, i1 = i0 + 8;

    uint32_t cf[NKN][4];   // C, rows i0 / i1, over the block's columns
#pragma unroll
    for (int kn = 0; kn < NKN; ++kn) {
      const int n = 16 * kn + 2 * tq;
      cf[kn][0] = sb_ld2<NT>(cs, i0, n);
      cf[kn][1] = sb_ld2<NT>(cs, i1, n);
      cf[kn][2] = sb_ld2<NT>(cs, i0, n + 8);
      cf[kn][3] = sb_ld2<NT>(cs, i1, n + 8);
    }
    // the partial scores C B^T over the block's columns, on the tiles that reach the
    // lower triangle
    float sm[NJT][4];
#pragma unroll
    for (int jt = 0; jt < NJT; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sm[jt][e] = 0.0f;
#pragma unroll
    for (int kn = 0; kn < NKN; ++kn)
#pragma unroll
      for (int jt = 0; jt < NJT; ++jt) {
        if (jt > 2 * warp + 1) continue;
        const int j = 8 * jt + gq;
        tb_mma(sm[jt], cf[kn], sb_ld2<NT>(bs, j, 16 * kn + 2 * tq),
               sb_ld2<NT>(bs, j, 16 * kn + 2 * tq + 8));
      }
    // the partial C h (h entering the chunk, split hi + lo)
    float yv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kn = 0; kn < NKN; ++kn) {
      const int at = gq * LDH + 16 * kn + 2 * tq;
      tb_mma(yv, cf[kn], *reinterpret_cast<const uint32_t*>(Hh + at),
             *reinterpret_cast<const uint32_t*>(Hh + at + 8));
      tb_mma(yv, cf[kn], *reinterpret_cast<const uint32_t*>(Hl + at),
             *reinterpret_cast<const uint32_t*>(Hl + at + 8));
    }

    // this chunk's partials, two buffers by chunk parity: chunk c - 2's were read before the
    // other blocks reached the last chunk's barrier, which this block has waited for
    float* SPs = SP0s + bf * QT * LDS;
    float* YPs = YP0s + bf * QT * PX;
#pragma unroll
    for (int jt = 0; jt < NJT; ++jt) {
      if (jt > 2 * warp + 1) continue;
      *reinterpret_cast<float2*>(SPs + i0 * LDS + 8 * jt + 2 * tq) = make_float2(sm[jt][0], sm[jt][1]);
      *reinterpret_cast<float2*>(SPs + i1 * LDS + 8 * jt + 2 * tq) = make_float2(sm[jt][2], sm[jt][3]);
    }
    *reinterpret_cast<float2*>(YPs + i0 * PX + 2 * tq) = make_float2(yv[0], yv[1]);
    *reinterpret_cast<float2*>(YPs + i1 * PX + 2 * tq) = make_float2(yv[2], yv[3]);
    tb_cluster_arrive();
    tb_cluster_wait();   // every block's partials are written
    // this block's rows of y: sum the cluster's partials in rank order
    for (int idx = tid; idx < nrows * (QT / 4); idx += THREADS) {
      const int il = idx / (QT / 4), j = 4 * (idx - il * (QT / 4)), i = ilo + il;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (j <= i) {
        float4 w[8];   // K <= 8: every remote load in flight at once, then summed in rank order
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (q < K) w[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(SPs, q) + i * LDS + j);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (q < K) v.x += w[q].x, v.y += w[q].y, v.z += w[q].z, v.w += w[q].w;
      }
      const float li = la[i];
      float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int d = 0; d < 4; ++d)
        o[d] = (j + d <= i) ? o[d] * exp2f(li - la[j + d]) * scs[j + d] : 0.0f;
      *reinterpret_cast<float4*>(MR + il * LDS + j) = make_float4(o[0], o[1], o[2], o[3]);
    }
    for (int idx = tid; idx < nrows * PX; idx += THREADS) {
      const int il = idx / PX, pc = idx - il * PX;
      float w[8], v = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q < K) w[q] = cluster.map_shared_rank(YPs, q)[(ilo + il) * PX + pc];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q < K) v += w[q];
      YC[il * PX + pc] = v;
    }
    __syncthreads();       // MR and YC complete
    // y: a warp an output, its lanes split the steps, then a warp sum
    for (int idx = warp; idx < nrows * P; idx += NW) {
      const int il = idx / P, pc = idx - il * P, i = ilo + il;
      float v = 0.0f;
#pragma unroll
      for (int j = lane; j < QT; j += 32)
        v = fmaf(MR[il * LDS + j], __bfloat162float(__ushort_as_bfloat16(xs[j * LDX + pc])), v);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) y[(s0 + i) * p.sys + pc] = __float2bfloat16_rn(exp2f(la[i]) * YC[il * PX + pc] + v);
    }

    // h = exp2(la_Q) h + B^T (w o sc o x) on the warp's tile: A = B^T (exact), the x side
    // split hi + lo
    const float decay = exp2f(la_last);
#pragma unroll
    for (int e = 0; e < 4; ++e) hr[e] *= decay;
#pragma unroll
    for (int kk = 0; kk < NKQ; ++kk) {
      if (16 * kk >= Q) continue;
      const int j = 16 * kk + 2 * tq;
      const int brow = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
      const int bcol = ((lane >> 3) & 1) << 3;
      uint32_t xr2[2];
      sb_ldsm_t2(xr2, xs + (16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * LDX);
      uint32_t uh0, ul0, uh1, ul1;
      sb_split(sb_lo(xr2[0]) * ws[j], sb_hi(xr2[0]) * ws[j + 1], uh0, ul0);
      sb_split(sb_lo(xr2[1]) * ws[j + 8], sb_hi(xr2[1]) * ws[j + 9], uh1, ul1);
      uint32_t a[4];
      sb_ldsm_t4(a, bs + sb_sw<NT>(brow, 16 * warp + bcol));
      tb_mma(hr, a, uh0, uh1);
      tb_mma(hr, a, ul0, ul1);
    }
    if (c + 1 < nchunks) store_x(xr, bf ^ 1);
  }
  tb_cluster_arrive();
  tb_cluster_wait();   // no block leaves while another may read its partials

  float* hout = p.hout + ((size_t)b * p.H + h) * N * P;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int n = n0 + 16 * warp + gq + 8 * (e >> 1), pc = 2 * tq + (e & 1);
    if (n < N && pc < P) hout[(size_t)n * P + pc] = hr[e];
  }
}

// SPLIT_N false: P split over the cluster (TpLayout; B and C through the tensor maps); true:
// N split, P <= 8 (TnLayout; the maps unused)
template <bool SPLIT_N>
__global__ void __launch_bounds__(SPLIT_N ? TnLayout::NW * 32 : TB_THREADS, 1)
    ssd_scan_tiled_bf16_kernel(SsdParams p, int flags, const __grid_constant__ CUtensorMap map_b,
                               const __grid_constant__ CUtensorMap map_c) {
  extern __shared__ __align__(16) unsigned char tb_smem[];
  if constexpr (SPLIT_N) {
    tb_split_n(p, flags, tb_smem);
  } else {
    __shared__ __align__(8) unsigned long long bars[TpLayout::STAGES];
    tb_split_p(p, flags, tb_smem, &map_b, &map_c, bars);
  }
}

typedef CUresult (*TbEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (no -lcuda)
static TbEncodeTiled tb_encoder() {
  static TbEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = (TbEncodeTiled)ptr;
  }
  return fn;
}

// A 4-D bf16 tensor map over (column, seq, group, batch) with boxes of 64 columns by `rows`
// rows of seq, 128-byte swizzle, zeros out of bounds (flash_fwd.cu's fb_tensor_map with the
// box's rows given).  Dimensions 1..3 are ordered by stride; pos receives where seq, group and
// batch went.  Every stride of a dimension longer than 1 must be a multiple of 16 bytes and
// the base 16-byte aligned.
static int tb_tensor_map(CUtensorMap* map, const void* base, int cols, int rows, int S, int G,
                         int B, long long ss, long long sg, long long sb, int (&pos)[3]) {
  TbEncodeTiled enc = tb_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t n[3] = {(cuuint64_t)S, (cuuint64_t)G, (cuuint64_t)B};
  cuuint64_t st[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sg * 2, (cuuint64_t)sb * 2};
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
    box[i + 1] = order[i] == 0 ? (cuuint32_t)rows : 1;
    pos[order[i]] = i + 1;
  }
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidPitchValue;
}

template <bool SPLIT_N>
static int tb_launch(SsdParams p, int flags, int Bt, void* stream) {
  const int smem = SPLIT_N ? TnLayout::BYTES : TpLayout::ALLOC;
  auto kern = ssd_scan_tiled_bf16_kernel<SPLIT_N>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap maps[2] = {};   // B, C
  if (!SPLIT_N && (flags & 1)) {
    const void* base[2] = {p.B, p.C};
    const long long st[2][3] = {{p.sBs, p.sBg, p.sBb}, {p.sCs, p.sCg, p.sCb}};
    for (int m = 0; m < 2; ++m) {
      const int rc = tb_tensor_map(&maps[m], base[m], p.N, p.Q, p.S, p.G, Bt, st[m][0], st[m][1],
                                   st[m][2], p.tpos[m]);
      if (rc != 0) return rc;
    }
  }
  int K, gx;
  if (SPLIT_N) {   // a power of two of 64-row slices of N, at least 4 (N > 128)
    K = 4;
    while (K * TB_NB < p.N) K <<= 1;
    gx = K;
  } else {         // pairs of the P slices of a (head, batch), padded with an empty slice
    K = TB_CLUSTER;
    gx = ((p.P + TB_PB - 1) / TB_PB + K - 1) / K * K;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, p.H, Bt);
  cfg.blockDim = dim3(SPLIT_N ? TnLayout::NW * 32 : TB_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, p, flags, maps[0], maps[1]);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

static int ssd_dispatch_tiled_bf16(SsdParams p, int Bt, void* stream) {
  const long long s8[] = {p.sBb, p.sBs, p.sBg, p.sCb, p.sCs, p.sCg};
  bool vec = p.N % 8 == 0 && ssd_aligned(p.B, 16) && ssd_aligned(p.C, 16);
  for (long long s : s8) vec = vec && s % 8 == 0;
  const bool xvec = p.P % 8 == 0 && ssd_aligned(p.x, 16) && p.sxb % 8 == 0 && p.sxs % 8 == 0 &&
                    p.sxh % 8 == 0;
  const bool pairs = p.P % 2 == 0 && p.syb % 2 == 0 && p.sys % 2 == 0 && p.syh % 2 == 0 &&
                     ssd_aligned(p.y, 4);
  const int flags = (vec ? 1 : 0) | (pairs ? 2 : 0) | (xvec ? 4 : 0);
  // the chunked scan is the same function at any chunk that divides S: a chunk above TB_QT
  // runs as its largest divisor up to TB_QT
  int q = p.Q < TB_QT ? p.Q : TB_QT;
  while (p.Q % q != 0) --q;
  p.Q = q;
  return p.P <= TB_NSPLIT_MAX_P ? tb_launch<true>(p, flags, Bt, stream)
                                : tb_launch<false>(p, flags, Bt, stream);
}

// x (Bt, S, H, P), B and C (Bt, S, G, N) of one type (float32 or bfloat16,
// is_bf16), dt and in_scale (Bt, S, H) float32, A (H,) float32; y (Bt, S, H, P)
// of x's type, hout (Bt, H, N, P) float32 contiguous.  strides holds the
// element strides over (batch, seq, head or group) of x, dt, in_scale, B, C
// and y, in that order; each innermost dimension is contiguous.  S must be a
// multiple of the chunk Q (at most SSD_MAX_DIM).  N and P up to SSD_MAX_DIM:
// bfloat16 inputs take the tensor-core template, float32 inputs the
// CUDA-core one; N or P above it (up to ST_MAX_DIM) take the tiled template,
// in either type.  Launches on the given stream; returns cudaGetLastError()
// (0 on success).
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* sc, const float* A,
                               const void* B, const void* C, void* y, float* hout,
                               const long long* strides, int Bt, int S, int H, int G, int N,
                               int P, int Q, int is_bf16, int device, void* stream) {
  if (Bt <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 || P <= 0 || Q <= 0 ||
      S % Q != 0 || N > ST_MAX_DIM || P > ST_MAX_DIM || Q > SSD_MAX_DIM)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  SsdParams p;
  p.x = x, p.dt = dt, p.sc = sc, p.A = A, p.B = B, p.C = C, p.y = y, p.hout = hout;
  p.sxb = strides[0], p.sxs = strides[1], p.sxh = strides[2];
  p.sdb = strides[3], p.sds = strides[4], p.sdh = strides[5];
  p.ssb = strides[6], p.sss = strides[7], p.ssh = strides[8];
  p.sBb = strides[9], p.sBs = strides[10], p.sBg = strides[11];
  p.sCb = strides[12], p.sCs = strides[13], p.sCg = strides[14];
  p.syb = strides[15], p.sys = strides[16], p.syh = strides[17];
  p.S = S, p.H = H, p.G = G, p.N = N, p.P = P, p.Q = Q;
  if (N > SSD_MAX_DIM || P > SSD_MAX_DIM)
    return is_bf16 ? ssd_dispatch_tiled_bf16(p, Bt, stream) : ssd_dispatch_tiled<float>(p, Bt, stream);
  return is_bf16 ? ssd_dispatch_bf16(p, Bt, stream) : ssd_dispatch_f32(p, Bt, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
