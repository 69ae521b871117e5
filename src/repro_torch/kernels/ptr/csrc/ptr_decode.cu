// Persistent whole-decode pointer kernel for Hopper (sm_90a), three templates.
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
// decode_batch(bf16=): float32 (ptr_decode_cluster, ptr_decode_block,
// ptr_decode_wide_f32) and bfloat16 (ptr_decode_cluster_bf16,
// ptr_decode_block_bf16, ptr_decode_wide_bf16).  The bf16 ones take C, CWg,
// CWp, emb, dec0, Wx, Wh, Wqg, vg, Wqp and vp in bfloat16 (the wrapper
// rounds CWg and CWp from the float32 products) and widen every element to
// float32 on read; the bias, h0, c0 and all state in shared memory stay
// float32, and every sum runs in float32 in the float32 template's order.
// So a bf16 template gives the bits its float32 twin gives on the same
// operands rounded to bfloat16.  It reads half the bytes of the frontier
// rows and the query weights a step, and the cluster templates keep their
// weights in shared memory as bfloat16.
//
// Bound on the H100: neither bytes nor operations.  The n steps of a graph
// are a dependent chain, each a few small matrix-vector products (d Wx and
// h Wh: H x 4H each, two H x H query products) separated by barriers, and a
// request batch puts one graph on each of a handful of the 132 SMs.  The
// kernel is latency-bound.
//
// Three templates; ptr_decode_launch picks one by shape and batch and
// reports which:
// * ptr_decode_cluster (H % 4 == 0, H divides PTR_THREADS, and 8 H^2 bytes
//   of gate weights plus the per-graph state fit one block's shared memory:
//   H <= 128 at the release's buckets): a graph runs on a cluster of four
//   blocks.  Block r owns hidden units [r H/4, (r+1) H/4) and keeps the Wx
//   and Wh columns of all four gates of those units in its shared memory for
//   the whole decode (128 KB at H = 128), so the gate products read shared
//   memory instead of streaming 512 KB from L2 into one SM every step.  It
//   runs the cell for its units, writes its H/4 new h values into every
//   block's h buffer through distributed shared memory and meets the others
//   at one cluster barrier a step; h is double-buffered by step parity, so
//   no block overwrites an h another block may still be reading.
//   Everything after the cell runs redundantly in all four blocks on the
//   same data in the same order, so all four pick the same row with no
//   further exchange; rank 0 alone writes the outputs.
// * ptr_decode_wide_f32 / _bf16 (128 < H <= PTR_THREADS, H % 16 == 0, its
//   shared memory fits, and the batch takes at most PTR_WIDE_MAX_WAVES waves
//   of the clusters the card holds): the same design on a non-portable
//   cluster of PTR_WIDE = 16 blocks, for the widths whose gate weights four
//   blocks cannot hold (8 H^2 floats = 2 MiB at H = 256).  Block r owns
//   units [r H/16, (r+1) H/16) and keeps, for the whole decode, their Wx and
//   Wh columns (128 KB at H = 256 in float32) and the columns of Wqg and Wqp
//   that produce them (32 KB).  A real step exchanges three vectors, each
//   written by its owners into every block through distributed shared
//   memory and followed by one cluster barrier: h after the cell, then
//   qg = h Wqg, then qp = gl Wqp.  Everything else (the compaction, the
//   frontier rows' scores read from L2, the softmaxes, the pick, the next
//   input) runs redundantly in all 16 blocks.  A batch of B graphs takes
//   ceil(B / clusters) waves, against one for the block template, so a
//   large batch of small graphs stays on the block template (the rule's
//   numbers are in decode.py:decode_template).  Both cluster templates are
//   one body, ptr_decode_cluster_body<K>: the cluster size and whether the
//   query columns are resident are all that set them apart.
// * ptr_decode_block (every other shape the 227 KB take, any H): one block
//   per graph, Wx, Wh, Wqg and Wqp read from L2 every step.
//
// All three keep each sum in one order — d Wx and h Wh each over j
// ascending by fmaf, then (ax + ah) + b; each query column over the row
// slices of ptr_matvec, each ascending, added in order from 0 — so the three
// give the same bits.
//
// Shared by all:
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
#define PTR_WIDE 16    // blocks a graph of the wide template runs on (non-portable)
#define PTR_WIDE_MIN_HIDDEN 129  // the wide template takes widths above the cluster's
#define PTR_WIDE_MAX_WAVES 2    // the most waves of wide clusters a launch may take

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
  PH_CELL,      // the cell update (and, in the clusters, the exchange of h)
  PH_GLIMPSE,   // h Wqg (and its exchange), glimpse scores, softmax, weighted rows
  PH_POINTER,   // gl Wqp (and its exchange), pointer scores
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

// The per-graph state every template keeps in shared memory.
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

// Whether a cluster of K blocks keeps the query columns its units produce
// in shared memory (the wide template) or reads Wqg and Wqp from L2 (the
// four-block one, the design its A/B against the block template measured).
__host__ __device__ constexpr bool ptr_query_resident(int K) { return K == PTR_WIDE; }

// The cluster templates, K blocks a graph: the block's Wx and Wh columns
// (H x 4H/K each) and, if resident, its Wqg and Wqp columns (H x H/K each),
// in the storage type (elem bytes an element); h by parity (2H), bias
// (4H/K); then the state (16-byte aligned: every piece is a multiple of 16
// bytes).
static size_t ptr_decode_cluster_smem_bytes(int K, int n, int H, int D, size_t elem) {
  const size_t Hq = (size_t)H / K;
  const size_t cols = 4 * Hq + (ptr_query_resident(K) ? Hq : 0);
  return elem * 2 * (size_t)H * cols + sizeof(float) * (2 * (size_t)H + 4 * Hq) +
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

// The step loop every template runs.  cell() is called by every thread on
// the steps that pick a real node: it runs the decoder LSTM cell on st.ds
// and the current h and returns the new h (H floats in this block's shared
// memory, published to every thread).  query(x, which, y) is called by
// every thread: y (H floats in shared memory, published to every thread on
// return) = x Wqg (which 0) or x Wqp (which 1), each column summed in
// ptr_matvec's order.  emit: this block writes order, logp and ent.  clk
// marks the phases.
template <class T, class Cell, class Query>
__device__ __forceinline__ void ptr_decode_steps(
    const DecodeState& st, Cell&& cell, Query&& query, PhaseClock& clk, const T* __restrict__ C,
    const T* __restrict__ CWg, const T* __restrict__ CWp, const T* __restrict__ emb,
    const float* u_row, int* __restrict__ order, float* __restrict__ logp,
    float* __restrict__ ent, int n, int nv, int H, int D, bool emit) {
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
    query(hs, 0, st.qg);
    ptr_row_scores(CWg, st.list, m, st.qg, st.vgs, H, s);
    ptr_softmax(s, m, st.red);
    ptr_weighted_rows(C, st.list, s, m, H, st.part, st.gl);
    clk.mark(PH_GLIMPSE);
    query(st.gl, 1, st.qp);
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
  // the query weights stream from L2 every step as well
  auto query = [&](const float* x, int which, float* y) {
    ptr_matvec(x, which ? a.wqp : a.wqg, H, st.part, y);
  };
  ptr_decode_steps(st, cell, query, clk, a.C + off, a.CWg + off, a.CWp + off, a.emb + off,
                   a.unif ? a.unif + (size_t)b * n : nullptr, a.order + (size_t)b * n,
                   a.logp + (size_t)b * n, a.ent + (size_t)b * n, n, a.n_valid[b], H, D, true);
  clk.flush();
}

// The cluster templates' body: one graph a cluster of K blocks, K =
// PTR_CLUSTER (ptr_decode_cluster) or PTR_WIDE (ptr_decode_wide_*), launched
// with the cluster dimension (and, above 8, the non-portable cluster size) by
// ptr_decode_launch; needs what ptr_cluster_takes asks.  Block r owns hidden
// units [r H/K, (r+1) H/K) and keeps their gate columns of Wx and Wh in its
// shared memory; with resident query columns (ptr_query_resident(K)) also
// the columns of Wqg and Wqp that produce them, else the query products read
// Wqg and Wqp from L2 as the block template does.
template <int K, class T>
__device__ __forceinline__ void ptr_decode_cluster_body(const DecodeArgs<T>& a, float* smem) {
  constexpr bool resident_q = ptr_query_resident(K);
  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.n, H = a.H, D = a.D;
  const int r = (int)cluster.block_rank();
  const int Hq = H / K;             // hidden units (and query columns) this block owns
  const int G4 = 4 * Hq;            // its gate columns
  const int H4 = 4 * H;
  // local gate column k (0..G4-1) is gate k / Hq of unit r Hq + k % Hq:
  // global column (k / Hq) H + r Hq + k % Hq of Wx, Wh and the bias; local
  // query column c is global column r Hq + c of Wqg and Wqp
  T* wxs = reinterpret_cast<T*>(smem);      // H x G4, row j, local column k
  T* whs = wxs + (size_t)H * G4;            // H x G4
  T* wqgs = whs + (size_t)H * G4;           // H x Hq, row k, local column c (if resident)
  T* wqps = wqgs + (size_t)H * Hq;          // H x Hq (if resident)
  float* hb = reinterpret_cast<float*>(resident_q ? wqps + (size_t)H * Hq : wqgs);  // 2 x H
  float* bs = hb + 2 * H;                   // G4
  const DecodeState st = ptr_decode_state(bs + G4, n, H, D);
  PhaseClock clk(threadIdx.x == 0 && r == 0);

  const int b = blockIdx.x / K;             // the graph
  const int tid = threadIdx.x;
  const size_t off = (size_t)b * n * H;
#pragma unroll 4
  for (int i = tid; i < H * G4; i += PTR_THREADS) {
    const int j = i / G4, k = i - j * G4;
    const size_t g = (size_t)j * H4 + (size_t)(k / Hq) * H + r * Hq + k % Hq;
    wxs[i] = __ldg(&a.wx[g]);
    whs[i] = __ldg(&a.wh[g]);
  }
  if constexpr (resident_q) {
    for (int i = tid; i < H * Hq; i += PTR_THREADS) {
      const int k = i / Hq, c = i - k * Hq;
      wqgs[i] = __ldg(&a.wqg[(size_t)k * H + r * Hq + c]);
      wqps[i] = __ldg(&a.wqp[(size_t)k * H + r * Hq + c]);
    }
  }
  for (int k = tid; k < G4; k += PTR_THREADS) bs[k] = a.bias[(k / Hq) * H + r * Hq + k % Hq];
  for (int k = tid; k < H; k += PTR_THREADS) hb[k] = a.h0[(size_t)b * H + k];
  ptr_decode_state_init(st, a.dec0, a.vg, a.vp, a.parent_mat + (size_t)b * n * D, n, H, D);
  // thread tid < H runs the cell of unit r Hq + tid % Hq and sends its h to
  // block tid / Hq: K copies of each unit's cell, each keeping c in a
  // register (they compute the same bits)
  const int u = tid % Hq, dst = tid / Hq;
  float c_reg = tid < H ? a.c0[(size_t)b * H + r * Hq + u] : 0.0f;
  // every block of the cluster has started (its shared memory may be
  // written) and has its own state loaded
  cluster.sync();
  clk.mark(PH_SETUP);

  // decoder LSTM cell for this block's units, then the exchange of h:
  // threads [0, G4) sum d Wx of local column tid, threads [G4, 2 G4) h Wh of
  // column tid - G4, each over j ascending (the block template's order)
  int parity = 0;
  auto cell = [&]() -> const float* {
    const float* h = hb + parity * H;
    float* h_next = hb + (parity ^ 1) * H;
    if (tid < 2 * G4) {
      const bool hh = tid >= G4;
      const int k = hh ? tid - G4 : tid;
      const float* x = hh ? h : st.ds;
      const T* w = (hh ? whs : wxs) + k;
      float acc = 0.0f;
#pragma unroll 4
      for (int j = 0; j < H; j += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(x + j);
        acc = fmaf(xv.x, ptr_f(w[(size_t)j * G4]), acc);
        acc = fmaf(xv.y, ptr_f(w[(size_t)(j + 1) * G4]), acc);
        acc = fmaf(xv.z, ptr_f(w[(size_t)(j + 2) * G4]), acc);
        acc = fmaf(xv.w, ptr_f(w[(size_t)(j + 3) * G4]), acc);
      }
      st.part[tid] = acc;
    }
    __syncthreads();
    clk.mark(PH_GATES);
    if (tid < H) {
      float gt[4];  // i, f, g, o of unit r Hq + u
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = q * Hq + u;
        gt[q] = st.part[k] + st.part[G4 + k] + bs[k];
      }
      const float c = ptr_sigmoid(gt[1] + 1.0f) * c_reg + ptr_sigmoid(gt[0]) * tanhf(gt[2]);
      c_reg = c;
      cluster.map_shared_rank(h_next, dst)[r * Hq + u] = ptr_sigmoid(gt[3]) * tanhf(c);
    }
    // release the stores into the other blocks, acquire theirs into ours
    cluster.sync();
    clk.mark(PH_CELL);
    parity ^= 1;
    return h_next;
  };
  // resident: this block's Hq columns of x Wqg or x Wqp from its own
  // columns, in ptr_matvec's order (its row slices, each ascending, added in
  // order from 0), sent to every block; then one cluster barrier.  A block's
  // y is read only after the barrier; the next step's stores into it come
  // after that step's exchange of h, which no block passes before every
  // block is done with this step, so y needs no second buffer.
  auto query = [&](const float* x, int which, float* y) {
    if constexpr (resident_q) {
      const T* w = which ? wqps : wqgs;
      const int G = ptr_groups(H);
      const int kc = (H + G - 1) / G;
      if (tid < G * Hq) {
        const int c = tid % Hq, g = tid / Hq;
        const int k0 = g * kc, k1 = min(H, k0 + kc);
        float acc = 0.0f;
#pragma unroll 8
        for (int k = k0; k < k1; ++k) acc = fmaf(x[k], ptr_f(w[(size_t)k * Hq + c]), acc);
        st.part[tid] = acc;
      }
      __syncthreads();
      if (tid < H) {
        float v = 0.0f;
        for (int q = 0; q < G; ++q) v += st.part[q * Hq + u];
        cluster.map_shared_rank(y, dst)[r * Hq + u] = v;
      }
      cluster.sync();
    } else {
      ptr_matvec(x, which ? a.wqp : a.wqg, H, st.part, y);
    }
  };
  ptr_decode_steps(st, cell, query, clk, a.C + off, a.CWg + off, a.CWp + off, a.emb + off,
                   a.unif ? a.unif + (size_t)b * n : nullptr, a.order + (size_t)b * n,
                   a.logp + (size_t)b * n, a.ent + (size_t)b * n, n, a.n_valid[b], H, D, r == 0);
  // no block leaves while another may still write into its shared memory
  cluster.sync();
  clk.flush();
}

// The six kernels: each template in each storage type, under its own name
// (the launch counters and the profiler tell them apart by it; no name is a
// prefix of another's but the block's and the cluster's float32 ones).
//
// Their register budgets: under __launch_bounds__(PTR_THREADS) alone ptxas
// gave ptr_decode_block 32 registers (with spills), enough for four blocks
// an SM, and its gate loop then kept few L2 loads in flight; allowed one
// block an SM it takes 63 and runs 1.9x faster at hidden 256, bit for bit
// the same (scripts/ptr_decode_phases.py --wide; the phase clocks' 128
// registers had made the instrumented build the faster one).  The cluster
// templates take up to 64 (two blocks an SM: the bf16 ones fit two where
// their shared memory does): the wide one ran 1.1x faster at 64 than at the
// default's 56, the four-block one 2-4 % faster at 64 (no spills) than
// under the default budget.
#define PTR_DECODE_KERNEL(name, body, T, bounds)                              \
  extern "C" __global__ void bounds name(DecodeArgs<T> a) {                   \
    extern __shared__ __align__(16) float smem[];                             \
    body(a, smem);                                                            \
  }
#ifdef PTR_DECODE_PHASES   // room for the clocks: 64 registers spill them
#define PTR_BOUNDS_CLUSTER __launch_bounds__(PTR_THREADS, 1)
#else
#define PTR_BOUNDS_CLUSTER __launch_bounds__(PTR_THREADS, 2)
#endif
#define PTR_BOUNDS_BLOCK __launch_bounds__(PTR_THREADS, 1)
PTR_DECODE_KERNEL(ptr_decode_block, ptr_decode_block_body, float, PTR_BOUNDS_BLOCK)
PTR_DECODE_KERNEL(ptr_decode_cluster, ptr_decode_cluster_body<PTR_CLUSTER>, float,
                  PTR_BOUNDS_CLUSTER)
PTR_DECODE_KERNEL(ptr_decode_block_bf16, ptr_decode_block_body, __nv_bfloat16, PTR_BOUNDS_BLOCK)
PTR_DECODE_KERNEL(ptr_decode_cluster_bf16, ptr_decode_cluster_body<PTR_CLUSTER>, __nv_bfloat16,
                  PTR_BOUNDS_CLUSTER)
PTR_DECODE_KERNEL(ptr_decode_wide_f32, ptr_decode_cluster_body<PTR_WIDE>, float,
                  PTR_BOUNDS_CLUSTER)
PTR_DECODE_KERNEL(ptr_decode_wide_bf16, ptr_decode_cluster_body<PTR_WIDE>, __nv_bfloat16,
                  PTR_BOUNDS_CLUSTER)

// The templates of one storage type.
template <class T>
struct DecodeKernels {
  using Fn = void (*)(DecodeArgs<T>);
  Fn block, cluster, wide;
  Fn of_size(int K) const { return K == PTR_WIDE ? wide : cluster; }  // a cluster template
};
static const DecodeKernels<float> kF32 = {ptr_decode_block, ptr_decode_cluster,
                                          ptr_decode_wide_f32};
static const DecodeKernels<__nv_bfloat16> kBf16 = {ptr_decode_block_bf16, ptr_decode_cluster_bf16,
                                                   ptr_decode_wide_bf16};

// Sets cfg (and its one attribute, attr) up for B clusters of `size` blocks
// of kernel k with smem bytes of shared memory each, on stream st, and
// writes how many such clusters the card holds at once to *clusters.
template <class T>
static cudaError_t ptr_cluster_setup(void (*k)(DecodeArgs<T>), int size, int B, size_t smem,
                                     cudaStream_t st, cudaLaunchConfig_t* cfg,
                                     cudaLaunchAttribute* attr, int* clusters) {
  cudaError_t e = cudaFuncSetAttribute((const void*)k,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (size > 8) {   // above the portable cluster size
    e = cudaFuncSetAttribute((const void*)k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)B * size);
  cfg->blockDim = dim3(PTR_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, (void*)k, cfg);
}

// The shape gate of the cluster template of K blocks a graph (the wide
// one's batch rule aside): the four-block one takes the widths that divide
// the block (those of its A/B), the wide one the widths above them up to
// one unit a thread; both need whole units a block, float4 rows and their
// shared memory to fit.
static bool ptr_cluster_takes(int K, int n, int H, int D, size_t elem, int max_smem) {
  const bool width = K == PTR_WIDE ? H >= PTR_WIDE_MIN_HIDDEN && H <= PTR_THREADS
                                   : PTR_THREADS % H == 0;
  return width && H % K == 0 && H % 4 == 0 &&
         ptr_decode_cluster_smem_bytes(K, n, H, D, elem) <= (size_t)max_smem;
}

// The launch of one storage type; see ptr_decode_launch.  tag is the value
// *template_out takes for the block kernel, tag + 1 for the cluster kernel;
// wide_tag the wide kernel's.
template <class T>
static int ptr_decode_run(const DecodeArgs<T>& a, const DecodeKernels<T>& k, int tag,
                          int wide_tag, int B, int max_smem, cudaStream_t st,
                          int* template_out) {
  cudaError_t e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  // PTR_DECODE_FORCE_BLOCK (the block template only) and
  // PTR_DECODE_FORCE_WIDE (the wide template at any batch) are defined only
  // in the builds that compare the templates
#ifndef PTR_DECODE_FORCE_BLOCK
#ifdef PTR_DECODE_FORCE_WIDE
  const int sizes[] = {PTR_WIDE};
#else
  const int sizes[] = {PTR_CLUSTER, PTR_WIDE};
#endif
  for (const int K : sizes) {
    if (!ptr_cluster_takes(K, a.n, a.H, a.D, sizeof(T), max_smem)) continue;
    int clusters = 0;
    e = ptr_cluster_setup(k.of_size(K), K, B,
                          ptr_decode_cluster_smem_bytes(K, a.n, a.H, a.D, sizeof(T)), st, &cfg,
                          attr, &clusters);
    if (e != cudaSuccess) return (int)e;
    bool runs = clusters > 0;
#ifndef PTR_DECODE_FORCE_WIDE
    if (K == PTR_WIDE) runs = runs && (B + clusters - 1) / clusters <= PTR_WIDE_MAX_WAVES;
#endif
    if (runs) {
      e = cudaLaunchKernelEx(&cfg, k.of_size(K), a);
      if (e != cudaSuccess) return (int)e;
      *template_out = K == PTR_WIDE ? wide_tag : tag + 1;
      return (int)cudaGetLastError();
    }
  }
#endif

  const size_t smem_b = ptr_decode_block_smem_bytes(a.n, a.H, a.D);
  if (smem_b > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute((const void*)k.block, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_b);
  if (e != cudaSuccess) return (int)e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)B);
  cfg.blockDim = dim3(PTR_THREADS);
  cfg.dynamicSmemBytes = smem_b;
  cfg.stream = st;
  e = cudaLaunchKernelEx(&cfg, k.block, a);
  if (e != cudaSuccess) return (int)e;
  *template_out = tag;
  return (int)cudaGetLastError();
}

// Launch on the given stream; returns cudaGetLastError() (0 on success) and
// writes the template it launched to *template_out: 1 ptr_decode_cluster,
// 0 ptr_decode_block, 3 ptr_decode_cluster_bf16, 2 ptr_decode_block_bf16,
// 4 ptr_decode_wide_f32, 5 ptr_decode_wide_bf16.  bf16 != 0: C, CWg, CWp,
// emb, dec0, wx, wh, wqg, vg, wqp and vp point to __nv_bfloat16, else to
// float; the rest is float (int for the indices).  The four-block cluster
// template runs when ptr_cluster_takes the shape and the card can hold one
// such cluster; else the wide template when ptr_cluster_takes the shape at
// 16 blocks, the card holds such a cluster and B graphs take at most
// PTR_WIDE_MAX_WAVES waves of the clusters it holds; else the block
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
  if (H <= 0 || B <= 0 || n <= 0 || D <= 0 || (sampled && unif == nullptr))
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
    return ptr_decode_run(args(__nv_bfloat16()), kBf16, 2, 5, B, max_smem, st, template_out);
  return ptr_decode_run(args(0.0f), kF32, 0, 4, B, max_smem, st, template_out);
}

// The occupancy probes scripts/ptr_decode_phases.py reads, from the plain
// build (the phase clocks' registers would change their answer), for the
// cluster template of `size` blocks a graph: PTR_CLUSTER or PTR_WIDE (else
// cudaErrorInvalidValue), at an (n, H, D) batch (bf16 != 0: the bf16
// template).  Each returns a CUDA error code.

// How many such clusters the card holds at once, into *out.
extern "C" int ptr_decode_max_clusters(int n, int H, int D, int bf16, int size, int* out) {
  if (size != PTR_CLUSTER && size != PTR_WIDE) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const size_t smem = ptr_decode_cluster_smem_bytes(
      size, n, H, D, bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
  return (int)(bf16 ? ptr_cluster_setup(kBf16.of_size(size), size, 1, smem, 0, &cfg, attr, out)
                    : ptr_cluster_setup(kF32.of_size(size), size, 1, smem, 0, &cfg, attr, out));
}

// How many of its blocks one SM holds at once, clusters aside, into *out.
extern "C" int ptr_decode_max_blocks(int n, int H, int D, int bf16, int size, int* out) {
  if (size != PTR_CLUSTER && size != PTR_WIDE) return (int)cudaErrorInvalidValue;
  const void* k = bf16 ? (const void*)kBf16.of_size(size) : (const void*)kF32.of_size(size);
  const size_t smem = ptr_decode_cluster_smem_bytes(
      size, n, H, D, bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, PTR_THREADS, smem);
}
