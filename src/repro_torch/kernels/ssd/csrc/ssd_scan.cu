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
// A third template, chosen by shape, takes N or P above 128 (xLSTM's mLSTM:
// chunk 64, N = P = 512 for the numerator and P = 1 for the normalizer; both
// dtypes): ssd_scan_tiled_kernel, on the CUDA cores in float32 whatever the
// input type.  The two templates above keep a chunk x N tile of B and C, and
// the whole (N, P) state, on chip; at N = 512 that does not fit in 227 KB.
// Here a block owns a slice of 32 state columns (one (slice, head, batch)
// each: 128 blocks at the mLSTM's numerator, 8 at its normalizer), keeps its
// (N, 32) float32 state slice in shared memory (66 KB at N = 512), and walks
// N in tiles of 64: C B^T and C h are sums over N, accumulated tile by tile
// in registers, and the state update is separable in N, so each tile of 64
// state rows is updated as soon as C h has read it.  Every block recomputes
// its chunk's C B^T (the slices do not share it).  Simple and correct, not
// fast: at the numerator's served shapes (Bt = 2, S = 1024, H = 4, bf16) the
// bound is 0.013 ms of bytes (42 MB), while the 9.1 GFLOP of the four
// products take 0.14 ms at the CUDA cores' float32 rate (67 TFLOP/s) before
// the recomputed C B^T (16 slices) adds its share.
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
// tiled template: N or P above SSD_MAX_DIM, float32 math on the CUDA cores
// ---------------------------------------------------------------------------
#define ST_PB 32            // state columns (of P) a block owns
#define ST_NT 64            // rows of N in one tile of B and C
#define ST_MAX_DIM 512      // N and P the tiled template takes

static size_t st_smem_floats(int Q, int N) {
  return (size_t)N * (ST_PB + 1) + (size_t)Q * (ST_PB + 1) + 2 * (size_t)Q * (ST_NT + 1) +
         (size_t)Q * (Q + 1) + 2 * (size_t)Q;
}

__device__ __forceinline__ float st_load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float st_load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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
    return is_bf16 ? ssd_dispatch_tiled<__nv_bfloat16>(p, Bt, stream)
                   : ssd_dispatch_tiled<float>(p, Bt, stream);
  return is_bf16 ? ssd_dispatch_bf16(p, Bt, stream) : ssd_dispatch_f32(p, Bt, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
