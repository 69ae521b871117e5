// Single-step pointer/glimpse kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/ptr/kernel.py:_ptr_kernel
// (launched by pointer_step_pallas): one fused glimpse + pointer step,
//   qg = h Wqg;  s_i = tanh(CWg_i + qg) . vg;  attn = softmax over mask;
//   glimpse = attn C;  qp = glimpse Wqp;  logit_i = tanh(CWp_i + qp) . vp,
// with every masked-out row at -1e9.  All sums in float32, any hidden width.
//
// Bound on the H100: memory by its bytes, latency in practice.  Per graph the
// step reads the selectable rows of three (n, H) row blocks and the two
// (H, H) query weights once and does O(n H) work; but a request batch holds a
// handful of graphs, so one block a graph would leave all but a few of the
// 132 SMs idle while it runs its phases one after another.
//
// Design: one graph a cluster of K blocks (ptr_step_cluster_size: K grows
// with the bucket, one block per 128 rows, at most 8 — a portable cluster).
// * Rows: block r owns rows [r n / K, (r + 1) n / K).  It writes -1e9 for its
//   masked rows and compacts its selectable ones into an ascending list; a
//   masked row contributes exactly zero to the reference's softmax
//   (exp(-1e9 - max) == 0), so only listed rows of CWg, C and CWp are read.
// * Query products by column: block r computes qg[j] (then qp[j]) for its
//   columns [r H / K, (r + 1) H / K) — H x H/K weights instead of H x H — and
//   writes them into every block's shared memory (distributed shared
//   memory), then one cluster barrier.
// * The glimpse softmax, flash-decoding style: each block keeps its local
//   max m_r, its sum s_r = sum exp(s - m_r) and its partial glimpse
//   g_r = sum exp(s - m_r) C_row, writes them to every block, and after one
//   cluster barrier every block combines the K partials in rank order:
//   M = max m_r, S = sum s_r e^(m_r - M), glimpse = sum g_r e^(m_r - M) / S —
//   the same bits in every block.
// * Pointer logits: each block writes those of its own rows.
// * Latency: at the path's own masks a step has a frontier of a row or a
//   few, so a launch is a chain of dependent phases, each waiting on a round
//   trip to L2 or device memory and a barrier.  The mask is read with h and
//   the attention vectors, in one round.  The loops are kept plain: versions
//   that unrolled them to issue each phase's loads together, or prefetched
//   rows and weights into L1, measured slower on the card at these masks.
//   With K = 1 the kernel is launched without the cluster attribute: a
//   cluster launch of one block measured slower than a plain launch of the
//   same one-block kernel.
// A block with no selectable row still owns its query columns and meets
// every cluster barrier; whether every row of the graph is masked is decided
// after the exchange, by every block alike.  All exchanges are pushes into
// other blocks' shared memory, each finished by a cluster barrier, and none
// follows the last one: no block writes into a block that may have exited.
#include <cooperative_groups.h>

#include "ptr_common.cuh"

namespace cg = cooperative_groups;

#define PTR_STEP_MAX_CLUSTER 8      // portable cluster size
#define PTR_STEP_ROWS_PER_BLOCK 128

// Blocks a graph of n rows runs on: ceil(n / 128), at most 8.
static int ptr_step_cluster_size(int n) {
  const int k = (n + PTR_STEP_ROWS_PER_BLOCK - 1) / PTR_STEP_ROWS_PER_BLOCK;
  return k < 1 ? 1 : (k > PTR_STEP_MAX_CLUSTER ? PTR_STEP_MAX_CLUSTER : k);
}

// Split arrive / wait of the cluster barrier (release / acquire): the
// kernel arrives when it starts and waits before its first remote store, so
// no block writes into one that has not started.
__device__ __forceinline__ void step_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" : : : "memory");
}
__device__ __forceinline__ void step_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}

// y[jl] = sum_k x[k] W[k][c0 + jl] for jl in [0, nc): x (H) in shared memory,
// W (H, H) row-major in global memory, any H and nc.  For nc <= PTR_THREADS
// the G = PTR_THREADS / nc thread groups each sum a slice of the k range and
// the group partials are added in order; wider slices take a column a
// thread.  nc is the same in every thread; ends with a barrier.
__device__ void step_matvec_cols(const float* x, const float* __restrict__ W, int H, int c0,
                                 int nc, float* part, float* y) {
  const int tid = threadIdx.x;
  if (nc > PTR_THREADS) {
    for (int jl = tid; jl < nc; jl += PTR_THREADS) {
      float acc = 0.0f;
      for (int k = 0; k < H; ++k) acc = fmaf(x[k], __ldg(&W[(size_t)k * H + c0 + jl]), acc);
      y[jl] = acc;
    }
  } else if (nc > 0) {
    const int G = PTR_THREADS / nc;
    const int kc = (H + G - 1) / G;
    const int jl = tid % nc, g = tid / nc;
    if (g < G) {
      const int k0 = g * kc, k1 = min(H, k0 + kc);
      float acc = 0.0f;
      for (int k = k0; k < k1; ++k) acc = fmaf(x[k], __ldg(&W[(size_t)k * H + c0 + jl]), acc);
      part[tid] = acc;
    }
    __syncthreads();
    if (tid < nc) {
      float s = 0.0f;
      for (int q = 0; q < G; ++q) s += part[q * nc + tid];
      y[tid] = s;
    }
  }
  __syncthreads();
}

// y[j] = sum_p a[p] R[list[p]][j] for j in [0, H), any H: for H <= PTR_THREADS
// the G = PTR_THREADS / H thread groups each take every G-th listed row and
// the group partials are added in order; wider rows take a column a thread.
// Ends with a barrier.
__device__ void step_weighted_rows(const float* __restrict__ R, const int* list, const float* a,
                                   int m, int H, float* part, float* y) {
  const int tid = threadIdx.x;
  if (H > PTR_THREADS) {
    for (int j = tid; j < H; j += PTR_THREADS) {
      float acc = 0.0f;
      for (int p = 0; p < m; ++p) acc = fmaf(a[p], __ldg(&R[(size_t)list[p] * H + j]), acc);
      y[j] = acc;
    }
  } else {
    const int G = PTR_THREADS / H;
    const int j = tid % H, g = tid / H;
    if (g < G) {
      float acc = 0.0f;
      for (int p = g; p < m; p += G) acc = fmaf(a[p], __ldg(&R[(size_t)list[p] * H + j]), acc);
      part[tid] = acc;
    }
    __syncthreads();
    if (tid < H) {
      float s = 0.0f;
      for (int q = 0; q < G; ++q) s += part[q * H + tid];
      y[tid] = s;
    }
  }
  __syncthreads();
}

// Copies buf[0, len) of this block's shared memory to the same place in
// every other block of the cluster.
__device__ __forceinline__ void step_push(cg::cluster_group& cluster, float* buf, int len, int K,
                                          int r) {
  for (int i = threadIdx.x; i < len; i += PTR_THREADS) {
    const float v = buf[i];
    for (int q = 0; q < K; ++q)
      if (q != r) cluster.map_shared_rank(buf, q)[i] = v;
  }
}

extern "C" __global__ void __launch_bounds__(PTR_THREADS)
ptr_step_cluster(const float* __restrict__ C, const float* __restrict__ CWg,
                 const float* __restrict__ CWp, const float* __restrict__ h,
                 const float* __restrict__ wqg, const float* __restrict__ vg,
                 const float* __restrict__ wqp, const float* __restrict__ vp,
                 const int* __restrict__ mask, float* __restrict__ out, int n, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  step_cluster_arrive();
  const int K = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int b = blockIdx.x / K;
  const int lo = (int)((long long)r * n / K), hi = (int)((long long)(r + 1) * n / K);
  const int c0 = r * H / K, nc = (r + 1) * H / K - c0;
  const int rows = (n + K - 1) / K;  // the most rows a block owns
  const int W = H + 2;               // an exchange slot: g_r (H), m_r, s_r

  extern __shared__ float smem[];
  float* hs = smem;                  // H
  float* vgs = hs + H;               // H
  float* vps = vgs + H;              // H
  float* qg = vps + H;               // H, column slices from every block
  float* qp = qg + H;                // H, column slices from every block
  float* gl = qp + H;                // H
  float* part = gl + H;              // PTR_THREADS
  float* red = part + PTR_THREADS;   // PTR_WARPS
  float* xch = red + PTR_WARPS;      // K slots of W, slot q from block q
  float* s = xch + K * W;            // rows
  int* list = (int*)(s + rows);      // rows
  int* cnt = list + rows;            // PTR_WARPS

  const size_t off = (size_t)b * n * H + (size_t)lo * H;  // this block's first row
  mask += (size_t)b * n + lo;
  out += (size_t)b * n + lo;
  const int nr = hi - lo;

  // the first PTR_THREADS mask entries load with h and the vectors
  const int first = threadIdx.x < nr ? mask[threadIdx.x] : 0;
  for (int j = threadIdx.x; j < H; j += PTR_THREADS) {
    hs[j] = h[(size_t)b * H + j];
    vgs[j] = vg[j];
    vps[j] = vp[j];
  }
  const int m = ptr_compact(nr, [&](int i) {  // called once for each row i
    const bool sel = (i < PTR_THREADS ? first : mask[i]) != 0;
    if (!sel) out[i] = PTR_NEG_INF;
    return sel;
  }, list, cnt);

  // qg: this block's columns, then into every block
  step_matvec_cols(hs, wqg, H, c0, nc, part, qg + c0);
  step_cluster_wait();  // every block of the cluster has started
  step_push(cluster, qg + c0, nc, K, r);
  cluster.sync();

  // glimpse over this block's rows: local max, sum and weighted rows of C
  ptr_row_scores(CWg + off, list, m, qg, vgs, H, s);
  float mx = -INFINITY;
  for (int p = threadIdx.x; p < m; p += PTR_THREADS) mx = fmaxf(mx, s[p]);
  mx = ptr_block_max(mx, red);
  float sum = 0.0f;
  for (int p = threadIdx.x; p < m; p += PTR_THREADS) {
    const float e = expf(s[p] - mx);
    s[p] = e;
    sum += e;
  }
  sum = ptr_block_sum(sum, red);  // its barriers publish s
  float* mine = xch + r * W;
  step_weighted_rows(C + off, list, s, m, H, part, mine);
  if (threadIdx.x == 0) {
    mine[H] = mx;
    mine[H + 1] = sum;
  }
  __syncthreads();
  step_push(cluster, mine, W, K, r);
  cluster.sync();

  // combine the K partials in rank order, the same in every block
  float M = -INFINITY;
  for (int q = 0; q < K; ++q) M = fmaxf(M, xch[q * W + H]);
  if (M == -INFINITY) return;  // every row of the graph is masked: all written above
  float sc[PTR_STEP_MAX_CLUSTER];
  float S = 0.0f;
#pragma unroll
  for (int q = 0; q < PTR_STEP_MAX_CLUSTER; ++q) {
    sc[q] = q < K ? expf(xch[q * W + H] - M) : 0.0f;  // 0 for a block without rows
    if (q < K) S += xch[q * W + H + 1] * sc[q];
  }
  for (int j = threadIdx.x; j < H; j += PTR_THREADS) {
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < PTR_STEP_MAX_CLUSTER; ++q)
      if (q < K) acc = fmaf(xch[q * W + j], sc[q], acc);
    gl[j] = acc / S;
  }
  __syncthreads();

  // qp: this block's columns, then into every block
  step_matvec_cols(gl, wqp, H, c0, nc, part, qp + c0);
  step_push(cluster, qp + c0, nc, K, r);
  cluster.sync();  // the last remote store of the launch

  // pointer logits of this block's rows
  ptr_row_scores(CWp + off, list, m, qp, vps, H, s);
  for (int p = threadIdx.x; p < m; p += PTR_THREADS) out[list[p]] = s[p];
}

// Dynamic shared memory of one block (kernel.py's step_smem_bytes mirrors it).
static size_t ptr_step_smem_bytes(int n, int H, int K) {
  const size_t rows = ((size_t)n + K - 1) / K;
  return sizeof(float) * (6 * (size_t)H + PTR_THREADS + PTR_WARPS + (size_t)K * (H + 2) + rows) +
         sizeof(int) * (rows + PTR_WARPS);
}

// Launch on the given stream; returns cudaGetLastError() (0 on success) and
// writes the cluster size it launched to *cluster_out (0 when nothing ran).
extern "C" int ptr_step_launch(const float* C, const float* CWg, const float* CWp,
                               const float* h, const float* wqg, const float* vg,
                               const float* wqp, const float* vp, const int* mask, float* out,
                               int B, int n, int H, int device, void* stream, int* cluster_out) {
  *cluster_out = 0;
  if (H <= 0 || B <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int K = ptr_step_cluster_size(n);
  const size_t smem = ptr_step_smem_bytes(n, H, K);
  int max_smem = 0;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(ptr_step_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (K == 1) {  // one block a graph: the kernel's cluster is that block
    ptr_step_cluster<<<B, PTR_THREADS, smem, (cudaStream_t)stream>>>(C, CWg, CWp, h, wqg, vg, wqp,
                                                                     vp, mask, out, n, H);
    *cluster_out = 1;
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * K);
  cfg.blockDim = dim3(PTR_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ptr_step_cluster, C, CWg, CWp, h, wqg, vg, wqp, vp, mask, out, n,
                         H);
  if (e != cudaSuccess) return (int)e;
  *cluster_out = K;
  return (int)cudaGetLastError();
}
