// Persistent whole-decode pointer kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/ptr/decode.py:_decode_kernel
// (launched by decode_batch): the whole greedy or sampled pointing decode of
// paper Alg. 1 for one graph per block.  Each of the n steps runs the
// decoder LSTM cell, the unvisited / real / parents-visited mask, glimpse
// attention, pointer logits and log-softmax, then a first-occurrence argmax
// or an inverse-CDF pick from the step's given uniform.  Once every real
// node is visited the step drains the first unvisited padded slot at zero
// log-prob and entropy.  All arithmetic is float32.
//
// Bound on the H100: neither bytes nor operations.  The n steps of a graph
// are a dependent chain, each a few small matrix-vector products (d Wx and
// h Wh: H x 4H each, two H x H query products) separated by block-wide
// barriers, and the request batch puts one graph on each of a handful of the
// 132 SMs.  The kernel is latency-bound: per step, the 512 KB of Wx and Wh
// and 128 KB of query weights stream from L2 into one SM.
//
// Design:
// * one block per graph; h, c, the decoder input d, the gates and the
//   per-step vectors live in shared memory, and so do the visited flags and
//   the graph's (n, D) parent indices (feasibility gathers the <= D parents
//   of a row; the TPU kernel's dense (n, n) adjacency matvec is dropped);
// * C, CWg, CWp and emb stay in global memory and are read from L2: at
//   n = 1024, H = 128 they are 2 MiB a graph, some nine times what a
//   block's shared memory holds;
// * the gates are d Wx + h Wh + b, both halves in one column loop; d is
//   dec0 at step 0, then the emb row of the node just picked, copied into
//   shared memory at the end of the step that picked it;
// * masked rows contribute exact zeros to the reference's softmaxes and
//   sums, so each step compacts the selectable rows (unvisited, real, every
//   parent visited) into an ascending list and reads only those rows of CWg,
//   C and CWp — for DNN graphs a handful a step instead of n;
// * a drained step needs no LSTM or attention: it only marks the first
//   unvisited slot (nothing after a drain reads the decoder state).
#include "ptr_common.cuh"

extern "C" __global__ void __launch_bounds__(PTR_THREADS)
ptr_decode_kernel(const float* __restrict__ C, const float* __restrict__ CWg,
                  const float* __restrict__ CWp, const float* __restrict__ emb,
                  const float* __restrict__ dec0, const float* __restrict__ h0,
                  const float* __restrict__ c0, const float* __restrict__ wx,
                  const float* __restrict__ wh, const float* __restrict__ bias,
                  const float* __restrict__ wqg, const float* __restrict__ vg,
                  const float* __restrict__ wqp,
                  const float* __restrict__ vp, const int* __restrict__ parent_mat,
                  const int* __restrict__ n_valid, const float* __restrict__ unif,
                  int* __restrict__ order, float* __restrict__ logp, float* __restrict__ ent,
                  int n, int H, int D, int sampled) {
  extern __shared__ float smem[];
  const int H4 = 4 * H;
  float* hs = smem;                 // H
  float* cs = hs + H;               // H
  float* ds = cs + H;               // H: this step's decoder input
  float* gates = ds + H;            // 4H
  float* bs = gates + H4;           // 4H
  float* qg = bs + H4;              // H
  float* gl = qg + H;               // H
  float* qp = gl + H;               // H
  float* vgs = qp + H;              // H
  float* vps = vgs + H;             // H
  float* part = vps + H;            // PTR_THREADS
  float* red = part + PTR_THREADS;  // PTR_WARPS
  float* s = red + PTR_WARPS;       // n: scores, then attention, then logits
  float* pr = s + n;                // n: probabilities
  int* list = (int*)(pr + n);       // n: selectable rows, ascending
  int* cnt = list + n;              // PTR_WARPS
  int* pm = cnt + PTR_WARPS;        // n * D parent indices
  int* picked = pm + (size_t)n * D; // 1: this step's pick (list position)
  unsigned char* visited = (unsigned char*)(picked + 1);  // n

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t off = (size_t)b * n * H;
  C += off;
  CWg += off;
  CWp += off;
  emb += off;
  parent_mat += (size_t)b * n * D;
  order += (size_t)b * n;
  logp += (size_t)b * n;
  ent += (size_t)b * n;
  const float* u_row = sampled ? unif + (size_t)b * n : nullptr;
  const int nv = n_valid[b];

  for (int j = tid; j < H; j += PTR_THREADS) {
    hs[j] = h0[(size_t)b * H + j];
    cs[j] = c0[(size_t)b * H + j];
    ds[j] = dec0[j];
    vgs[j] = vg[j];
    vps[j] = vp[j];
  }
  for (int k = tid; k < H4; k += PTR_THREADS) bs[k] = bias[k];
  for (int i = tid; i < n * D; i += PTR_THREADS) pm[i] = parent_mat[i];
  for (int i = tid; i < n; i += PTR_THREADS) visited[i] = 0;
  __syncthreads();

  int drain_cursor = 0;  // used by thread 0 only
  for (int t = 0; t < n; ++t) {
    auto selectable = [&](int i) -> bool {
      if (visited[i] || i >= nv) return false;
      for (int q = 0; q < D; ++q) {
        const int u = pm[i * D + q];
        if (u >= 0 && !visited[u]) return false;
      }
      return true;
    };
    const int m = ptr_compact(n, selectable, list, cnt);
    if (m == 0) {  // drain: only padded slots remain
      if (tid == 0) {
        while (visited[drain_cursor]) ++drain_cursor;
        visited[drain_cursor] = 1;
        order[t] = drain_cursor;
        logp[t] = 0.0f;
        ent[t] = 0.0f;
      }
      __syncthreads();
      continue;
    }

    // decoder LSTM cell: gates = d Wx + h Wh + b, order i, f, g, o
    for (int k = tid; k < H4; k += PTR_THREADS) {
      float ax = 0.0f, ah = 0.0f;
#pragma unroll 8
      for (int j = 0; j < H; ++j) {
        ax = fmaf(ds[j], __ldg(&wx[(size_t)j * H4 + k]), ax);
        ah = fmaf(hs[j], __ldg(&wh[(size_t)j * H4 + k]), ah);
      }
      gates[k] = ax + ah + bs[k];
    }
    __syncthreads();
    for (int j = tid; j < H; j += PTR_THREADS) {
      const float c = ptr_sigmoid(gates[H + j] + 1.0f) * cs[j] +
                      ptr_sigmoid(gates[j]) * tanhf(gates[2 * H + j]);
      cs[j] = c;
      hs[j] = ptr_sigmoid(gates[3 * H + j]) * tanhf(c);
    }
    __syncthreads();

    // glimpse attention, then pointer logits, over the selectable rows
    ptr_matvec(hs, wqg, H, part, qg);
    ptr_row_scores(CWg, list, m, qg, vgs, H, s);
    ptr_softmax(s, m, red);
    ptr_weighted_rows(C, list, s, m, H, part, gl);
    ptr_matvec(gl, wqp, H, part, qp);
    ptr_row_scores(CWp, list, m, qp, vps, H, s);

    // log-softmax, entropy and the pick
    float lmax = -INFINITY;
    for (int p = tid; p < m; p += PTR_THREADS) lmax = fmaxf(lmax, s[p]);
    lmax = ptr_block_max(lmax, red);
    float sum = 0.0f;
    for (int p = tid; p < m; p += PTR_THREADS) sum += expf(s[p] - lmax);
    const float lse = lmax + logf(ptr_block_sum(sum, red));
    float plogp = 0.0f;
    for (int p = tid; p < m; p += PTR_THREADS) {
      const float lp = s[p] - lse;
      const float q = expf(lp);
      pr[p] = q;
      plogp += q > 0.0f ? q * lp : 0.0f;
    }
    const float entropy = -ptr_block_sum(plogp, red);  // its barriers publish pr
    if (!sampled) {
      // first-occurrence argmax: the largest logit, the smallest row on ties
      // (list is ascending, so the smallest list position)
      float bv = -INFINITY;
      int bp = m;
      for (int p = tid; p < m; p += PTR_THREADS)
        if (s[p] > bv) { bv = s[p]; bp = p; }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(PTR_FULL_MASK, bv, o);
        const int op = __shfl_xor_sync(PTR_FULL_MASK, bp, o);
        if (ov > bv || (ov == bv && op < bp)) { bv = ov; bp = op; }
      }
      if ((tid & 31) == 0) {
        part[tid >> 5] = bv;
        cnt[tid >> 5] = bp;
      }
      __syncthreads();
      if (tid == 0) {
        float v = part[0];
        int p = cnt[0];
        for (int w = 1; w < PTR_WARPS; ++w)
          if (part[w] > v || (part[w] == v && cnt[w] < p)) { v = part[w]; p = cnt[w]; }
        *picked = p;
      }
    } else if (tid == 0) {
      // inverse CDF over node order: first row whose running sum exceeds
      // u * total, else the last row with non-zero probability
      float total = 0.0f;
      for (int p = 0; p < m; ++p) total += pr[p];
      const float draw = u_row[t] * total;
      float cdf = 0.0f;
      int pick = -1, last_live = 0;
      for (int p = 0; p < m; ++p) {
        cdf += pr[p];
        if (pick < 0 && cdf > draw) pick = p;
        if (pr[p] > 0.0f) last_live = p;
      }
      *picked = (total > draw && pick >= 0) ? pick : last_live;
    }
    __syncthreads();
    const int p = *picked;
    const int row = list[p];
    if (tid == 0) {
      order[t] = row;
      logp[t] = s[p] - lse;
      ent[t] = entropy;
      visited[row] = 1;
    }
    // the next step's decoder input; the gate loop that read ds is behind
    // this step's barriers, and the next one is behind ptr_compact's
    for (int j = tid; j < H; j += PTR_THREADS) ds[j] = __ldg(&emb[(size_t)row * H + j]);
    __syncthreads();
  }
}

static size_t ptr_decode_smem_bytes(int n, int H, int D) {
  return sizeof(float) * (16 * (size_t)H + PTR_THREADS + PTR_WARPS + 2 * (size_t)n) +
         sizeof(int) * ((size_t)n + PTR_WARPS + (size_t)n * D + 1) + (size_t)n;
}

// Launch on the given stream; returns cudaGetLastError() (0 on success).
extern "C" int ptr_decode_launch(const float* C, const float* CWg, const float* CWp,
                                 const float* emb, const float* dec0, const float* h0,
                                 const float* c0, const float* wx, const float* wh,
                                 const float* bias,
                                 const float* wqg, const float* vg, const float* wqp,
                                 const float* vp, const int* parent_mat, const int* n_valid,
                                 const float* unif, int* order, float* logp, float* ent, int B,
                                 int n, int H, int D, int sampled, int device,
                                 void* stream) {
  if (H <= 0 || H > PTR_THREADS || PTR_THREADS % H != 0 || B <= 0 || n <= 0 || D <= 0 ||
      (sampled && unif == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = ptr_decode_smem_bytes(n, H, D);
  e = cudaFuncSetAttribute(ptr_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  ptr_decode_kernel<<<B, PTR_THREADS, smem, (cudaStream_t)stream>>>(
      C, CWg, CWp, emb, dec0, h0, c0, wx, wh, bias, wqg, vg, wqp, vp, parent_mat, n_valid,
      unif, order, logp, ent, n, H, D, sampled);
  return (int)cudaGetLastError();
}
