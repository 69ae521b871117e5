// Single-step pointer/glimpse kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/ptr/kernel.py:_ptr_kernel
// (launched by pointer_step_pallas): one fused glimpse + pointer step,
//   qg = h Wqg;  s_i = tanh(CWg_i + qg) . vg;  attn = softmax over mask;
//   glimpse = attn C;  qp = glimpse Wqp;  logit_i = tanh(CWp_i + qp) . vp,
// with every masked-out row at -1e9.  All sums in float32.
//
// Bound on the H100: memory.  Per graph the step reads the three (n, H)
// row blocks and the two (H, H) query weights once and does O(n H) work, far
// below the card's operations-per-byte balance.
//
// Design: one thread block per graph (grid B).  A masked row contributes
// exactly zero to the reference's softmax (exp(-1e9 - max) == 0) and its
// logit is overwritten by -1e9, so the block first compacts the selectable
// rows into an ascending list in shared memory and reads only those rows of
// CWg, C and CWp: the bytes moved follow the mask, not n.  A warp scores one
// row at a time with coalesced 128-byte reads; the two (H, H) query
// products are split over the block's thread groups.
#include "ptr_common.cuh"

extern "C" __global__ void __launch_bounds__(PTR_THREADS)
ptr_step_kernel(const float* __restrict__ C, const float* __restrict__ CWg,
                const float* __restrict__ CWp, const float* __restrict__ h,
                const float* __restrict__ wqg, const float* __restrict__ vg,
                const float* __restrict__ wqp, const float* __restrict__ vp,
                const int* __restrict__ mask, float* __restrict__ out, int n, int H) {
  extern __shared__ float smem[];
  float* hs = smem;              // H
  float* qg = hs + H;            // H
  float* gl = qg + H;            // H
  float* qp = gl + H;            // H
  float* vgs = qp + H;           // H
  float* vps = vgs + H;          // H
  float* part = vps + H;         // PTR_THREADS
  float* red = part + PTR_THREADS;  // PTR_WARPS
  float* s = red + PTR_WARPS;    // n
  int* list = (int*)(s + n);     // n
  int* cnt = list + n;           // PTR_WARPS

  const int b = blockIdx.x;
  const size_t off = (size_t)b * n * H;
  C += off;
  CWg += off;
  CWp += off;
  mask += (size_t)b * n;
  out += (size_t)b * n;

  for (int j = threadIdx.x; j < H; j += PTR_THREADS) {
    hs[j] = h[(size_t)b * H + j];
    vgs[j] = vg[j];
    vps[j] = vp[j];
  }
  for (int i = threadIdx.x; i < n; i += PTR_THREADS)
    if (mask[i] == 0) out[i] = PTR_NEG_INF;
  const int m = ptr_compact(n, [&](int i) { return mask[i] != 0; }, list, cnt);
  if (m == 0) return;  // block-uniform: every logit is masked

  ptr_matvec(hs, wqg, H, part, qg);
  ptr_row_scores(CWg, list, m, qg, vgs, H, s);
  ptr_softmax(s, m, red);
  ptr_weighted_rows(C, list, s, m, H, part, gl);
  ptr_matvec(gl, wqp, H, part, qp);
  ptr_row_scores(CWp, list, m, qp, vps, H, s);
  for (int p = threadIdx.x; p < m; p += PTR_THREADS) out[list[p]] = s[p];
}

static size_t ptr_step_smem_bytes(int n, int H) {
  return sizeof(float) * (6 * (size_t)H + PTR_THREADS + PTR_WARPS + n) +
         sizeof(int) * ((size_t)n + PTR_WARPS);
}

// Launch on the given stream; returns cudaGetLastError() (0 on success).
extern "C" int ptr_step_launch(const float* C, const float* CWg, const float* CWp,
                               const float* h, const float* wqg, const float* vg,
                               const float* wqp, const float* vp, const int* mask, float* out,
                               int B, int n, int H, int device, void* stream) {
  if (H <= 0 || H > PTR_THREADS || PTR_THREADS % H != 0 || B <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = ptr_step_smem_bytes(n, H);
  e = cudaFuncSetAttribute(ptr_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  ptr_step_kernel<<<B, PTR_THREADS, smem, (cudaStream_t)stream>>>(C, CWg, CWp, h, wqg, vg, wqp,
                                                                  vp, mask, out, n, H);
  return (int)cudaGetLastError();
}
