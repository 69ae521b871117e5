// Persistent whole-decode pointer kernel for Hopper (sm_90a), two templates.
//
// Replaces the Pallas kernel repro/kernels/ptr/decode.py:_decode_kernel
// (launched by decode_batch): the whole greedy or sampled pointing decode of
// paper Alg. 1 for one graph.  Each of the n steps runs the decoder LSTM
// cell, the unvisited / real / parents-visited mask, glimpse attention,
// pointer logits and log-softmax, then a first-occurrence argmax or an
// inverse-CDF pick from the step's given uniform.  Once every real node is
// visited the step drains the first unvisited padded slot at zero log-prob
// and entropy.  All arithmetic is float32.
//
// Each template comes in two storage types, as the reference's
// decode_batch(bf16=): float32 (ptr_decode_cluster, ptr_decode_block) and
// bfloat16 (ptr_decode_cluster_bf16, ptr_decode_block_bf16).  The bf16 ones
// take C, CWg, CWp, emb, dec0, Wx, Wh, Wqg, vg, Wqp and vp in bfloat16 (the
// wrapper rounds CWg and CWp from the float32 products) and widen every
// element to float32 on read; the bias, h0, c0 and all state in shared memory
// stay float32, and every sum runs in float32 in the float32 template's
// order.  So a bf16 template gives the bits its float32 twin gives on the
// same operands rounded to bfloat16.  It reads half the bytes of the
// frontier rows and the query weights a step, and the cluster template keeps
// Wx and Wh in shared memory as bfloat16 (64 KB at H = 128).
//
// Bound on the H100: neither bytes nor operations.  The n steps of a graph
// are a dependent chain, each a few small matrix-vector products (d Wx and
// h Wh: H x 4H each, two H x H query products) separated by barriers, and a
// request batch puts one graph on each of a handful of the 132 SMs.  The
// kernel is latency-bound.
//
// Two templates; ptr_decode_launch picks one by shape and reports which:
// * ptr_decode_cluster (H % 4 == 0 and 8 H^2 bytes of gate weights plus the
//   per-graph state fit one block's shared memory: H <= 128 at the release's
//   buckets): a graph runs on a cluster of four blocks.  Block r owns hidden
//   units [r H/4, (r+1) H/4) and keeps the Wx and Wh columns of all four
//   gates of those units in its shared memory for the whole decode (128 KB
//   at H = 128), so the gate products read shared memory instead of
//   streaming 512 KB from L2 into one SM every step.  It runs the cell for
//   its units, writes its H/4 new h values into every block's h buffer
//   through distributed shared memory and meets the others at one cluster
//   barrier a step; h is double-buffered by step parity, so no block
//   overwrites an h another block may still be reading.  Everything after
//   the cell runs redundantly in all four blocks on the same data in the
//   same order, so all four pick the same row with no further exchange;
//   rank 0 alone writes the outputs.
// * ptr_decode_block (every other shape the 227 KB take, e.g. H = 256): one
//   block per graph, Wx and Wh read from L2 every step.
//
// Both keep each gate element's sums in one order — d Wx and h Wh each over
// j ascending by fmaf, then (ax + ah) + b — so the two give the same bits.
//
// Shared by both:
// * h, the decoder input d, the per-step vectors, the visited flags and the
//   graph's (n, D) parent indices live in shared memory (feasibility gathers
//   the <= D parents of a row; the TPU kernel's dense (n, n) adjacency
//   matvec is dropped);
// * C, CWg, CWp and emb stay in global memory and are read from L2: at
//   n = 1024, H = 128 they are 2 MiB a graph;
// * d is dec0 at step 0, then the emb row of the node just picked;
// * masked rows contribute exact zeros to the reference's softmaxes and
//   sums, so each step compacts the selectable rows (unvisited, real, every
//   parent visited) into an ascending list and reads only those rows of CWg,
//   C and CWp — for DNN graphs a handful a step instead of n;
// * a drained step needs no LSTM or attention: it only marks the first
//   unvisited slot (nothing after a drain reads the decoder state).
#include <cooperative_groups.h>

#include "ptr_common.cuh"

namespace cg = cooperative_groups;

#define PTR_CLUSTER 4  // blocks a graph of the cluster template runs on

// Phase clocks, compiled in only with -DPTR_DECODE_PHASES (an instrumented
// build that scripts/ptr_decode_phases.py makes; the kernels' own build has
// none): thread 0 of each graph's writing block adds the SM clock cycles
// (clock64) it spent in each phase of the decode, and how often it entered
// it, to ptr_decode_phase_cycles, which ptr_decode_phases_read returns.
enum {
  PH_SETUP,     // shared-memory loads before the first step
  PH_COMPACT,   // the selectable rows
  PH_DRAIN,     // a drained step
  PH_GATES,     // the gate products
  PH_CELL,      // the cell update (and, in the cluster, the exchange of h)
  PH_GLIMPSE,   // h Wqg, glimpse scores, softmax, weighted rows of C
  PH_POINTER,   // gl Wqp, pointer scores
  PH_PICK,      // log-softmax, entropy, the pick
  PH_INPUT,     // the next decoder input
  PTR_PHASES
};

#ifdef PTR_DECODE_PHASES
__device__ unsigned long long ptr_decode_phase_cycles[2][PTR_PHASES];  // cycles, entries

struct PhaseClock {
  long long last;
  unsigned long long cycles[PTR_PHASES], entries[PTR_PHASES];
  bool on;
  __device__ explicit PhaseClock(bool on_) : on(on_) {
    for (int k = 0; k < PTR_PHASES; ++k) cycles[k] = entries[k] = 0;
    last = clock64();
  }
  __device__ __forceinline__ void mark(int k) {
    if (!on) return;
    const long long now = clock64();
    cycles[k] += now - last;
    entries[k] += 1;
    last = now;
  }
  __device__ void flush() {
    if (!on) return;
    for (int k = 0; k < PTR_PHASES; ++k) {
      atomicAdd(&ptr_decode_phase_cycles[0][k], cycles[k]);
      atomicAdd(&ptr_decode_phase_cycles[1][k], entries[k]);
    }
  }
};

// Copies the summed cycles and entries (2 x PTR_PHASES) to out and clears
// them; returns a CUDA error code.
extern "C" int ptr_decode_phases_read(unsigned long long* out) {
  const size_t bytes = sizeof(ptr_decode_phase_cycles);
  cudaError_t e = cudaMemcpyFromSymbol(out, ptr_decode_phase_cycles, bytes);
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zeros[2][PTR_PHASES] = {};
  return (int)cudaMemcpyToSymbol(ptr_decode_phase_cycles, zeros, bytes);
}
#else
struct PhaseClock {
  __device__ explicit PhaseClock(bool) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush() {}
};
#endif

// The per-graph state both templates keep in shared memory.
struct DecodeState {
  float *ds, *qg, *gl, *qp, *vgs, *vps, *part, *red, *s, *pr;
  int *list, *cnt, *pm, *picked;
  unsigned char* visited;
};

// Lays the state out from p (16-byte aligned: ds is read as float4).
__device__ __forceinline__ DecodeState ptr_decode_state(float* p, int n, int H, int D) {
  DecodeState st;
  st.ds = p;                        // H: this step's decoder input
  st.qg = st.ds + H;                // H
  st.gl = st.qg + H;                // H
  st.qp = st.gl + H;                // H
  st.vgs = st.qp + H;               // H
  st.vps = st.vgs + H;              // H
  st.part = st.vps + H;             // PTR_THREADS
  st.red = st.part + PTR_THREADS;   // PTR_WARPS
  st.s = st.red + PTR_WARPS;        // n: scores, then attention, then logits
  st.pr = st.s + n;                 // n: probabilities
  st.list = (int*)(st.pr + n);      // n: selectable rows, ascending
  st.cnt = st.list + n;             // PTR_WARPS
  st.pm = st.cnt + PTR_WARPS;       // n * D parent indices
  st.picked = st.pm + (size_t)n * D;                    // 1: the pick (list position)
  st.visited = (unsigned char*)(st.picked + 1);         // n
  return st;
}

static size_t ptr_decode_state_bytes(int n, int H, int D) {
  return sizeof(float) * (6 * (size_t)H + PTR_THREADS + PTR_WARPS + 2 * (size_t)n) +
         sizeof(int) * ((size_t)n + PTR_WARPS + (size_t)n * D + 1) + (size_t)n;
}

// ptr_decode_block: h, c, gates (4H), bias (4H), then the state.
static size_t ptr_decode_block_smem_bytes(int n, int H, int D) {
  return sizeof(float) * 10 * (size_t)H + ptr_decode_state_bytes(n, H, D);
}

// ptr_decode_cluster: Wx and Wh columns (H x H each, elem bytes an
// element: the storage type's), h by parity (2H), bias (H), c (H/4, padded
// to H), then the state.
static size_t ptr_decode_cluster_smem_bytes(int n, int H, int D, size_t elem) {
  return elem * 2 * (size_t)H * H + sizeof(float) * 4 * (size_t)H +
         ptr_decode_state_bytes(n, H, D);
}

// The arguments of every template; T is the storage type of the operands
// the bf16 templates store in bfloat16.
template <class T>
struct DecodeArgs {
  const T *C, *CWg, *CWp, *emb, *dec0;
  const float *h0, *c0;
  const T *wx, *wh;
  const float* bias;
  const T *wqg, *vg, *wqp, *vp;
  const int *parent_mat, *n_valid;
  const float* unif;
  int* order;
  float *logp, *ent;
  int n, H, D;
};

// Loads what the state holds at the start: d = dec0, the score vectors, the
// parent indices; clears the visited flags.  No barrier.
template <class T>
__device__ __forceinline__ void ptr_decode_state_init(const DecodeState& st,
                                                      const T* __restrict__ dec0,
                                                      const T* __restrict__ vg,
                                                      const T* __restrict__ vp,
                                                      const int* __restrict__ parent_mat, int n,
                                                      int H, int D) {
  const int tid = threadIdx.x;
  for (int j = tid; j < H; j += PTR_THREADS) {
    st.ds[j] = ptr_ld(&dec0[j]);
    st.vgs[j] = ptr_ld(&vg[j]);
    st.vps[j] = ptr_ld(&vp[j]);
  }
  for (int i = tid; i < n * D; i += PTR_THREADS) st.pm[i] = parent_mat[i];
  for (int i = tid; i < n; i += PTR_THREADS) st.visited[i] = 0;
}

// The step loop both templates run.  cell() is called by every thread on
// the steps that pick a real node: it runs the decoder LSTM cell on st.ds
// and the current h and returns the new h (H floats in this block's shared
// memory, published to every thread).  emit: this block writes order, logp
// and ent.  clk marks the phases.
template <class T, class Cell>
__device__ __forceinline__ void ptr_decode_steps(
    const DecodeState& st, Cell&& cell, PhaseClock& clk, const T* __restrict__ C,
    const T* __restrict__ CWg, const T* __restrict__ CWp, const T* __restrict__ emb,
    const T* __restrict__ wqg, const T* __restrict__ wqp, const float* u_row,
    int* __restrict__ order, float* __restrict__ logp, float* __restrict__ ent, int n, int nv,
    int H, int D, bool emit) {
  const int tid = threadIdx.x;
  int drain_cursor = 0;  // used by thread 0 only
  for (int t = 0; t < n; ++t) {
    auto selectable = [&](int i) -> bool {
      if (st.visited[i] || i >= nv) return false;
      for (int q = 0; q < D; ++q) {
        const int u = st.pm[i * D + q];
        if (u >= 0 && !st.visited[u]) return false;
      }
      return true;
    };
    const int m = ptr_compact(n, selectable, st.list, st.cnt);
    clk.mark(PH_COMPACT);
    if (m == 0) {  // drain: only padded slots remain
      if (tid == 0) {
        while (st.visited[drain_cursor]) ++drain_cursor;
        st.visited[drain_cursor] = 1;
        if (emit) {
          order[t] = drain_cursor;
          logp[t] = 0.0f;
          ent[t] = 0.0f;
        }
      }
      __syncthreads();
      clk.mark(PH_DRAIN);
      continue;
    }

    const float* hs = cell();   // marks PH_GATES, PH_CELL

    // glimpse attention, then pointer logits, over the selectable rows
    float* s = st.s;
    ptr_matvec(hs, wqg, H, st.part, st.qg);
    ptr_row_scores(CWg, st.list, m, st.qg, st.vgs, H, s);
    ptr_softmax(s, m, st.red);
    ptr_weighted_rows(C, st.list, s, m, H, st.part, st.gl);
    clk.mark(PH_GLIMPSE);
    ptr_matvec(st.gl, wqp, H, st.part, st.qp);
    ptr_row_scores(CWp, st.list, m, st.qp, st.vps, H, s);
    clk.mark(PH_POINTER);

    // log-softmax, entropy and the pick
    float lmax = -INFINITY;
    for (int p = tid; p < m; p += PTR_THREADS) lmax = fmaxf(lmax, s[p]);
    lmax = ptr_block_max(lmax, st.red);
    float sum = 0.0f;
    for (int p = tid; p < m; p += PTR_THREADS) sum += expf(s[p] - lmax);
    const float lse = lmax + logf(ptr_block_sum(sum, st.red));
    float plogp = 0.0f;
    for (int p = tid; p < m; p += PTR_THREADS) {
      const float lp = s[p] - lse;
      const float q = expf(lp);
      st.pr[p] = q;
      plogp += q > 0.0f ? q * lp : 0.0f;
    }
    const float entropy = -ptr_block_sum(plogp, st.red);  // its barriers publish pr
    if (u_row == nullptr) {
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
        st.part[tid >> 5] = bv;
        st.cnt[tid >> 5] = bp;
      }
      __syncthreads();
      if (tid == 0) {
        float v = st.part[0];
        int p = st.cnt[0];
        for (int w = 1; w < PTR_WARPS; ++w)
          if (st.part[w] > v || (st.part[w] == v && st.cnt[w] < p)) { v = st.part[w]; p = st.cnt[w]; }
        *st.picked = p;
      }
    } else if (tid == 0) {
      // inverse CDF over node order: first row whose running sum exceeds
      // u * total, else the last row with non-zero probability
      float total = 0.0f;
      for (int p = 0; p < m; ++p) total += st.pr[p];
      const float draw = u_row[t] * total;
      float cdf = 0.0f;
      int pick = -1, last_live = 0;
      for (int p = 0; p < m; ++p) {
        cdf += st.pr[p];
        if (pick < 0 && cdf > draw) pick = p;
        if (st.pr[p] > 0.0f) last_live = p;
      }
      *st.picked = (total > draw && pick >= 0) ? pick : last_live;
    }
    __syncthreads();
    clk.mark(PH_PICK);
    const int p = *st.picked;
    const int row = st.list[p];
    if (tid == 0) {
      if (emit) {
        order[t] = row;
        logp[t] = s[p] - lse;
        ent[t] = entropy;
      }
      st.visited[row] = 1;
    }
    // the next step's decoder input; the gate loop that read ds is behind
    // this step's barriers, and the next one is behind ptr_compact's
    for (int j = tid; j < H; j += PTR_THREADS) st.ds[j] = ptr_ld(&emb[(size_t)row * H + j]);
    __syncthreads();
    clk.mark(PH_INPUT);
  }
}

// ptr_decode_block's body: one block a graph.
template <class T>
__device__ __forceinline__ void ptr_decode_block_body(const DecodeArgs<T>& a, float* smem) {
  const int n = a.n, H = a.H, D = a.D;
  const int H4 = 4 * H;
  float* hs = smem;                 // H
  float* cs = hs + H;               // H
  float* gates = cs + H;            // 4H
  float* bs = gates + H4;           // 4H
  const DecodeState st = ptr_decode_state(bs + H4, n, H, D);
  PhaseClock clk(threadIdx.x == 0);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t off = (size_t)b * n * H;
  for (int j = tid; j < H; j += PTR_THREADS) {
    hs[j] = a.h0[(size_t)b * H + j];
    cs[j] = a.c0[(size_t)b * H + j];
  }
  for (int k = tid; k < H4; k += PTR_THREADS) bs[k] = a.bias[k];
  ptr_decode_state_init(st, a.dec0, a.vg, a.vp, a.parent_mat + (size_t)b * n * D, n, H, D);
  __syncthreads();
  clk.mark(PH_SETUP);

  // decoder LSTM cell: gates = d Wx + h Wh + b, order i, f, g, o; the
  // weights stream from L2 every step
  const T* __restrict__ wx = a.wx;
  const T* __restrict__ wh = a.wh;
  auto cell = [&]() -> const float* {
    for (int k = tid; k < H4; k += PTR_THREADS) {
      float ax = 0.0f, ah = 0.0f;
#pragma unroll 8
      for (int j = 0; j < H; ++j) {
        ax = fmaf(st.ds[j], ptr_ld(&wx[(size_t)j * H4 + k]), ax);
        ah = fmaf(hs[j], ptr_ld(&wh[(size_t)j * H4 + k]), ah);
      }
      gates[k] = ax + ah + bs[k];
    }
    __syncthreads();
    clk.mark(PH_GATES);
    for (int j = tid; j < H; j += PTR_THREADS) {
      const float c = ptr_sigmoid(gates[H + j] + 1.0f) * cs[j] +
                      ptr_sigmoid(gates[j]) * tanhf(gates[2 * H + j]);
      cs[j] = c;
      hs[j] = ptr_sigmoid(gates[3 * H + j]) * tanhf(c);
    }
    __syncthreads();
    clk.mark(PH_CELL);
    return hs;
  };
  ptr_decode_steps(st, cell, clk, a.C + off, a.CWg + off, a.CWp + off, a.emb + off, a.wqg, a.wqp,
                   a.unif ? a.unif + (size_t)b * n : nullptr, a.order + (size_t)b * n,
                   a.logp + (size_t)b * n, a.ent + (size_t)b * n, n, a.n_valid[b], H, D, true);
  clk.flush();
}

// ptr_decode_cluster's body: one graph a cluster of PTR_CLUSTER blocks
// (launched with the cluster dimension by ptr_decode_launch); needs
// H % PTR_CLUSTER == 0.
template <class T>
__device__ __forceinline__ void ptr_decode_cluster_body(const DecodeArgs<T>& a, float* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.n, H = a.H, D = a.D;
  const int r = (int)cluster.block_rank();
  const int Hq = H / PTR_CLUSTER;   // hidden units this block owns
  const int H4 = 4 * H;
  // local gate column k (0..H-1) is gate k / Hq of unit r Hq + k % Hq:
  // global column (k / Hq) H + r Hq + k % Hq of Wx, Wh and the bias
  T* wxs = reinterpret_cast<T*>(smem);      // H x H, row j, local column k
  T* whs = wxs + (size_t)H * H;             // H x H
  float* hb = reinterpret_cast<float*>(whs + (size_t)H * H);  // 2 x H: h of even, odd steps
  float* bs = hb + 2 * H;                   // H
  float* cs = bs + H;                       // H/4 used: c of this block's units
  const DecodeState st = ptr_decode_state(cs + H, n, H, D);
  PhaseClock clk(threadIdx.x == 0 && r == 0);

  const int b = blockIdx.x / PTR_CLUSTER;   // the graph
  const int tid = threadIdx.x;
  const size_t off = (size_t)b * n * H;
#pragma unroll 4
  for (int i = tid; i < H * H; i += PTR_THREADS) {
    const int j = i / H, k = i - j * H;
    const size_t g = (size_t)j * H4 + (size_t)(k / Hq) * H + r * Hq + k % Hq;
    wxs[i] = __ldg(&a.wx[g]);
    whs[i] = __ldg(&a.wh[g]);
  }
  for (int k = tid; k < H; k += PTR_THREADS) {
    bs[k] = a.bias[(k / Hq) * H + r * Hq + k % Hq];
    hb[k] = a.h0[(size_t)b * H + k];
  }
  for (int u = tid; u < Hq; u += PTR_THREADS) cs[u] = a.c0[(size_t)b * H + r * Hq + u];
  ptr_decode_state_init(st, a.dec0, a.vg, a.vp, a.parent_mat + (size_t)b * n * D, n, H, D);
  // every block of the cluster has started (its shared memory may be
  // written) and has its own state loaded
  cluster.sync();
  clk.mark(PH_SETUP);

  // decoder LSTM cell for this block's units, then the exchange of h:
  // threads [0, H) sum d Wx of local column tid, threads [H, 2H) h Wh of
  // column tid - H, each over j ascending (the block template's order)
  int parity = 0;
  auto cell = [&]() -> const float* {
    const float* h = hb + parity * H;
    float* h_next = hb + (parity ^ 1) * H;
    if (tid < 2 * H) {
      const bool hh = tid >= H;
      const int k = hh ? tid - H : tid;
      const float* x = hh ? h : st.ds;
      const T* w = (hh ? whs : wxs) + k;
      float acc = 0.0f;
#pragma unroll 4
      for (int j = 0; j < H; j += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(x + j);
        acc = fmaf(xv.x, ptr_f(w[(size_t)j * H]), acc);
        acc = fmaf(xv.y, ptr_f(w[(size_t)(j + 1) * H]), acc);
        acc = fmaf(xv.z, ptr_f(w[(size_t)(j + 2) * H]), acc);
        acc = fmaf(xv.w, ptr_f(w[(size_t)(j + 3) * H]), acc);
      }
      st.part[tid] = acc;
    }
    __syncthreads();
    clk.mark(PH_GATES);
    if (tid < Hq) {
      float gt[4];  // i, f, g, o of unit r Hq + tid
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = q * Hq + tid;
        gt[q] = st.part[k] + st.part[H + k] + bs[k];
      }
      const float c = ptr_sigmoid(gt[1] + 1.0f) * cs[tid] + ptr_sigmoid(gt[0]) * tanhf(gt[2]);
      cs[tid] = c;
      const float hv = ptr_sigmoid(gt[3]) * tanhf(c);
#pragma unroll
      for (int q = 0; q < PTR_CLUSTER; ++q) cluster.map_shared_rank(h_next, q)[r * Hq + tid] = hv;
    }
    // release the stores into the other blocks, acquire theirs into ours
    cluster.sync();
    clk.mark(PH_CELL);
    parity ^= 1;
    return h_next;
  };
  ptr_decode_steps(st, cell, clk, a.C + off, a.CWg + off, a.CWp + off, a.emb + off, a.wqg, a.wqp,
                   a.unif ? a.unif + (size_t)b * n : nullptr, a.order + (size_t)b * n,
                   a.logp + (size_t)b * n, a.ent + (size_t)b * n, n, a.n_valid[b], H, D, r == 0);
  // no block leaves while another may still write into its shared memory
  cluster.sync();
  clk.flush();
}

// The four kernels: each template in each storage type, under its own name
// (the launch counters and the profiler tell them apart by it).
#define PTR_DECODE_KERNEL(name, body, T)                                      \
  extern "C" __global__ void __launch_bounds__(PTR_THREADS) name(DecodeArgs<T> a) { \
    extern __shared__ __align__(16) float smem[];                             \
    body(a, smem);                                                            \
  }
PTR_DECODE_KERNEL(ptr_decode_block, ptr_decode_block_body, float)
PTR_DECODE_KERNEL(ptr_decode_cluster, ptr_decode_cluster_body, float)
PTR_DECODE_KERNEL(ptr_decode_block_bf16, ptr_decode_block_body, __nv_bfloat16)
PTR_DECODE_KERNEL(ptr_decode_cluster_bf16, ptr_decode_cluster_body, __nv_bfloat16)

// The launch of one storage type; see ptr_decode_launch.  tag is the value
// *template_out takes for the block kernel, tag + 1 for the cluster kernel.
template <class T>
static int ptr_decode_run(const DecodeArgs<T>& a, void (*cluster_k)(DecodeArgs<T>),
                          void (*block_k)(DecodeArgs<T>), int tag, int B, int max_smem,
                          cudaStream_t st, int* template_out) {
  cudaError_t e;
  const size_t smem_c = ptr_decode_cluster_smem_bytes(a.n, a.H, a.D, sizeof(T));
#ifndef PTR_DECODE_FORCE_BLOCK  // defined only in a build that compares the templates
  if (a.H % PTR_CLUSTER == 0 && smem_c <= (size_t)max_smem) {
    e = cudaFuncSetAttribute((const void*)cluster_k,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = PTR_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)B * PTR_CLUSTER);
    cfg.blockDim = dim3(PTR_THREADS);
    cfg.dynamicSmemBytes = smem_c;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, (void*)cluster_k, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters > 0) {
      e = cudaLaunchKernelEx(&cfg, cluster_k, a);
      if (e != cudaSuccess) return (int)e;
      *template_out = tag + 1;
      return (int)cudaGetLastError();
    }
  }
#endif

  const size_t smem_b = ptr_decode_block_smem_bytes(a.n, a.H, a.D);
  if (smem_b > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute((const void*)block_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_b);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B);
  cfg.blockDim = dim3(PTR_THREADS);
  cfg.dynamicSmemBytes = smem_b;
  cfg.stream = st;
  e = cudaLaunchKernelEx(&cfg, block_k, a);
  if (e != cudaSuccess) return (int)e;
  *template_out = tag;
  return (int)cudaGetLastError();
}

// Launch on the given stream; returns cudaGetLastError() (0 on success) and
// writes the template it launched to *template_out: 1 ptr_decode_cluster,
// 0 ptr_decode_block, 3 ptr_decode_cluster_bf16, 2 ptr_decode_block_bf16.
// bf16 != 0: C, CWg, CWp, emb, dec0, wx, wh, wqg, vg, wqp and vp point to
// __nv_bfloat16, else to float; the rest is float (int for the indices).
// The cluster template runs when H % PTR_CLUSTER == 0, its shared memory
// fits a block and the card can hold one such cluster; else the block
// template, if its shared memory fits; else nothing runs.
extern "C" int ptr_decode_launch(const void* C, const void* CWg, const void* CWp,
                                 const void* emb, const void* dec0, const float* h0,
                                 const float* c0, const void* wx, const void* wh,
                                 const float* bias, const void* wqg, const void* vg,
                                 const void* wqp, const void* vp, const int* parent_mat,
                                 const int* n_valid, const float* unif, int* order, float* logp,
                                 float* ent, int B, int n, int H, int D, int sampled, int bf16,
                                 int device, void* stream, int* template_out) {
  *template_out = -1;
  if (H <= 0 || H > PTR_THREADS || PTR_THREADS % H != 0 || B <= 0 || n <= 0 || D <= 0 ||
      (sampled && unif == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int max_smem = 0;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  // the arguments in the storage type of the tag's type
  const auto args = [&](auto tag) {
    using T = decltype(tag);
    return DecodeArgs<T>{(const T*)C,   (const T*)CWg,  (const T*)CWp, (const T*)emb,
                         (const T*)dec0, h0,            c0,            (const T*)wx,
                         (const T*)wh,  bias,           (const T*)wqg, (const T*)vg,
                         (const T*)wqp, (const T*)vp,   parent_mat,    n_valid,
                         sampled ? unif : nullptr,      order,         logp,
                         ent,           n,              H,             D};
  };
  if (bf16)
    return ptr_decode_run(args(__nv_bfloat16()), ptr_decode_cluster_bf16, ptr_decode_block_bf16,
                          2, B, max_smem, st, template_out);
  return ptr_decode_run(args(0.0f), ptr_decode_cluster, ptr_decode_block, 0, B, max_smem, st,
                        template_out);
}

// The occupancy probes scripts/ptr_decode_phases.py reads, from the plain
// build (the phase clocks' registers would change their answer).

// How many clusters of the cluster template the card holds at once for an
// (n, H, D) batch, into *out (bf16 != 0: the bf16 template); returns a CUDA
// error code.
extern "C" int ptr_decode_max_clusters(int n, int H, int D, int bf16, int* out) {
  const void* k = bf16 ? (const void*)ptr_decode_cluster_bf16 : (const void*)ptr_decode_cluster;
  const size_t smem =
      ptr_decode_cluster_smem_bytes(n, H, D, bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = PTR_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(PTR_CLUSTER);
  cfg.blockDim = dim3(PTR_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, k, &cfg);
}

// How many blocks of the cluster template one SM holds at once, clusters
// aside, for an (n, H, D) batch, into *out (bf16 != 0: the bf16 template);
// returns a CUDA error code.
extern "C" int ptr_decode_max_blocks(int n, int H, int D, int bf16, int* out) {
  const void* k = bf16 ? (const void*)ptr_decode_cluster_bf16 : (const void*)ptr_decode_cluster;
  const size_t smem =
      ptr_decode_cluster_smem_bytes(n, H, D, bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, PTR_THREADS, smem);
}
