// Dense full-view tick kernels for Hopper (sm_90a): the CUDA port of the
// two TPU kernels on the dense model's main path.
//
//   gp_masked_max3     the three gossip merge maxima of one tick.  Replaces
//                      the MXU level-descent merge (gossip_protocol_tpu/
//                      ops/merge.py gossip_reductions_mxu) that feeds K1, and
//                      the in-kernel masked_max of K2 (ops/pallas/
//                      dense_mega.py:114).
//   gp_tick_epilogue   K1, ops/pallas/tickfused.py fused_tick_update: the
//                      post-merge cell rules, detection, dissemination and
//                      the per-row sent/recv counts of one tick.
//   gp_dense_mega_ticks  K2, ops/pallas/dense_mega.py dense_mega_ticks: S
//                      whole ticks per call, as a loop of launches on one
//                      stream (vector step, churn wipe, masked_max3,
//                      epilogue) with no host sync inside the loop.
//
// Every value is an integer or a 0/1 byte, so each kernel agrees with its
// plain PyTorch version bit for bit.
//
// Bounds on an H100 (3.35 TB/s; 16.7 T int32 operations/s without tensor
// cores: 132 SMs x 64 INT32 lanes x 1.98 GHz):
// * masked_max3 needs 3 maxima per (delivery, column) pair, 3 D N for D
//   deliveries (D <= N^2): it is bound by integer operations (N=2816 at
//   a steady-state tick: D = 6.6e5, 5.6e9 maxima), not by its 22 N^2
//   bytes.  Design: 64x64 output tiles, 32-sender slabs of the delivery
//   mask and the three payload planes staged in shared memory, 4x4
//   outputs per thread per plane in registers, each product an AND with
//   the 0/-1 delivery word and a MAX.  A slab whose delivery tile is empty
//   is skipped before its payloads are loaded, so dead and not-yet-started
//   peers cost only the mask read.  The int8 tensor-core level descent that
//   the TPU used (one 0/1 matmul per distinct value) is later work.
// * the epilogue is elementwise over ~36 bytes per cell (three i32 maxima,
//   hb/ts in and out, six byte planes): bound by bytes.  Design: a block
//   owns 32 whole rows, so every cell rule, including the JOINREQ row 0
//   and the JOINREP column 0, is cell-local and the row sums need no
//   atomics; the transposed read of the gossip plane (receiver r consumes
//   gossip[s, r]) goes through a shared-memory tile so all global reads
//   stay coalesced.
// * K2 on the TPU kept the whole state in 110 MB of VMEM.  An SM has
//   227 KB of shared memory, so here the state stays in HBM/L2 and each
//   tick is three or four launches.  A persistent kernel with a grid
//   barrier per tick, or a CUDA graph, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MM_TILE = 64;   // masked_max3 output tile (rows x cols)
constexpr int MM_SLAB = 32;   // senders staged per shared-memory slab
constexpr int EP_ROWS = 32;   // epilogue rows per block
constexpr int EP_COLS = 32;   // epilogue column tile
constexpr int VEC_THREADS = 1024;

// per-tick vector lanes written by the K2 vector step (u8[VEC_LANES, N])
enum { V_PROC = 0, V_OPS, V_JREP, V_JREQ, V_HOLD, V_REJOIN, VEC_LANES };
// aux lanes (ops/pallas/dense_mega.py)
enum { A_IN_GROUP = 0, A_OWN_HB, A_JOINREQ, A_JOINREP, A_START, A_FAIL,
       A_REJOIN, AUX_LANES = 8 };

// m[r, j] = max over senders s with gossip[s, r] & proc[r] of payload[s, j],
// for payloads a1 = known ? hb + 1 : 0, f1 = fresh ? hb + 1 : 0,
// t1 = fresh ? ts + 1 : 0 (fresh = known & now - ts < t_remove); written
// shifted back down (FILL = -1 means no contributing sender).
__global__ void __launch_bounds__(256)
masked_max3_kernel(const uint8_t* __restrict__ gossip,
                   const uint8_t* __restrict__ proc,
                   const uint8_t* __restrict__ known,
                   const int32_t* __restrict__ hb,
                   const int32_t* __restrict__ ts,
                   int32_t* __restrict__ m_all, int32_t* __restrict__ m_fresh,
                   int32_t* __restrict__ t_fresh,
                   int n, int now, int t_remove) {
  __shared__ int32_t d_s[MM_SLAB][MM_TILE];   // 0 / -1 delivery mask [s][r]
  __shared__ int32_t a_s[MM_SLAB][MM_TILE];   // payload planes [s][j]
  __shared__ int32_t f_s[MM_SLAB][MM_TILE];
  __shared__ int32_t t_s[MM_SLAB][MM_TILE];
  const int tx = threadIdx.x, ty = threadIdx.y;      // 16 x 16
  const int tid = ty * 16 + tx;
  const int r0 = blockIdx.y * MM_TILE, j0 = blockIdx.x * MM_TILE;
  int acc_a[4][4], acc_f[4][4], acc_t[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc_a[i][k] = acc_f[i][k] = acc_t[i][k] = 0;

  for (int s0 = 0; s0 < n; s0 += MM_SLAB) {
    // stage the slab: 32 x 64 cells of each plane, 8 per thread, read
    // along the contiguous axis (r for the mask, j for the payloads).
    // The delivery tile goes first: a slab that delivers nothing to this
    // block's receivers (dead or silent senders, receivers not yet
    // started) contributes nothing, so the block skips its payload loads
    // and its products.  The test is uniform across the block.
    int any = 0;
#pragma unroll
    for (int e = 0; e < (MM_SLAB * MM_TILE) / 256; ++e) {
      const int idx = e * 256 + tid;
      const int ss = idx / MM_TILE, cc = idx % MM_TILE;
      const int s = s0 + ss, r = r0 + cc;
      const int32_t d = (s < n && r < n && gossip[(size_t)s * n + r] &&
                         proc[r]) ? -1 : 0;
      d_s[ss][cc] = d;
      any |= d;
    }
    if (!__syncthreads_or(any)) continue;
#pragma unroll
    for (int e = 0; e < (MM_SLAB * MM_TILE) / 256; ++e) {
      const int idx = e * 256 + tid;
      const int ss = idx / MM_TILE, cc = idx % MM_TILE;
      const int s = s0 + ss, j = j0 + cc;
      int32_t a = 0, f = 0, tv = 0;
      if (s < n && j < n) {
        const size_t o = (size_t)s * n + j;
        if (known[o]) {
          const int32_t h = hb[o], st = ts[o];
          a = h + 1;
          if (now - st < t_remove) { f = h + 1; tv = st + 1; }
        }
      }
      a_s[ss][cc] = a; f_s[ss][cc] = f; t_s[ss][cc] = tv;
    }
    __syncthreads();
#pragma unroll 4
    for (int ss = 0; ss < MM_SLAB; ++ss) {
      int32_t dm[4], av[4], fv[4], tv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dm[i] = d_s[ss][ty + 16 * i];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        av[k] = a_s[ss][tx + 16 * k];
        fv[k] = f_s[ss][tx + 16 * k];
        tv[k] = t_s[ss][tx + 16 * k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc_a[i][k] = max(acc_a[i][k], dm[i] & av[k]);
          acc_f[i][k] = max(acc_f[i][k], dm[i] & fv[k]);
          acc_t[i][k] = max(acc_t[i][k], dm[i] & tv[k]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + tx + 16 * k;
      if (j >= n) continue;
      const size_t o = (size_t)r * n + j;
      m_all[o] = acc_a[i][k] - 1;
      m_fresh[o] = acc_f[i][k] - 1;
      t_fresh[o] = acc_t[i][k] - 1;
    }
  }
}

struct CellOut {
  uint8_t known, gossip, added, removed, gsent;
  int32_t hb, ts;
};

// The post-merge rules of one (receiver r, column j) cell: the TPU K1
// kernel's body (ops/pallas/tickfused.py:67-132), in the same order.
__device__ __forceinline__ CellOut cell_rule(
    int r, int j, int t, int t_remove, int32_t m_all, int32_t m_fr,
    int32_t t_fr, bool dfull, bool exists, int32_t hb0, int32_t ts0,
    bool gossip_rj, bool gdrop_rj, bool ops_r, bool jrep_r, bool jreq_j,
    bool hold_j) {
  const bool self = r == j;
  const bool anyf = t_fr >= 0;
  // merge into existing entries (MP1Node.cpp:248-251)
  const bool inc = exists && m_all > hb0;
  int32_t hb1 = inc ? m_all : hb0;
  int32_t ts1 = inc ? t : ts0;
  // piggyback add (MP1Node.cpp:282-301)
  const bool padd = !exists && anyf && !self;
  if (padd) { hb1 = m_all; ts1 = m_all > m_fr ? t : t_fr; }
  const bool known_pb = exists || padd;
  // direct-sender handling (MP1Node.cpp:236-242)
  if (dfull && known_pb) { hb1 = hb1 + 1; ts1 = t; }
  const bool dadd = dfull && !known_pb && !self;
  if (dadd) { hb1 = 1; ts1 = t; }
  const bool known2 = exists || padd || dadd;
  // JOINREQ at the introducer (row 0; MP1Node.cpp:221-230)
  const bool q_cell = r == 0 && jreq_j && !known2 && j != 0;
  if (q_cell) { hb1 = 1; ts1 = t; }
  const bool known3 = known2 || q_cell;
  // JOINREP at the joiner (column 0; MP1Node.cpp:231-233)
  const bool r_cell = j == 0 && jrep_r && !known3;
  if (r_cell) { hb1 = 1; ts1 = t; }
  const bool known4 = known3 || r_cell;
  // staleness detection (MP1Node.cpp:339-348)
  const bool stale = ops_r && known4 && (t - ts1 >= t_remove);
  const bool known5 = known4 && !stale;
  // dissemination + drop + in-flight hold
  const bool gsent = ops_r && known5 && !gdrop_rj;
  CellOut o;
  o.known = known5;
  o.gossip = gsent || (gossip_rj && hold_j);
  o.added = known4 && !exists;
  o.removed = stale;
  o.gsent = gsent;
  o.hb = hb1;
  o.ts = ts1;
  return o;
}

// One block owns rows [r0, r0 + 32) and walks the columns in 32-wide tiles.
// known/hb/ts may alias their outputs (each cell reads only itself); gossip
// must not (the transposed read looks at other rows).
__global__ void __launch_bounds__(256)
tick_epilogue_kernel(const int32_t* __restrict__ m_all,
                     const int32_t* __restrict__ m_fresh,
                     const int32_t* __restrict__ t_fresh,
                     const uint8_t* __restrict__ gossip,
                     const uint8_t* __restrict__ proc,
                     const uint8_t* known, const int32_t* hb,
                     const int32_t* ts,
                     const uint8_t* __restrict__ gdrop,
                     const uint8_t* __restrict__ ops,
                     const uint8_t* __restrict__ jrep,
                     const uint8_t* __restrict__ jreq,
                     const uint8_t* __restrict__ hold,
                     uint8_t* known_o, int32_t* hb_o, int32_t* ts_o,
                     uint8_t* __restrict__ gossip_o,
                     int32_t* __restrict__ sent_row,
                     int32_t* __restrict__ recv_row,
                     uint8_t* __restrict__ added_o,
                     uint8_t* __restrict__ removed_o,
                     int n, int t, int t_remove, int accumulate) {
  __shared__ uint8_t gT[EP_COLS][EP_ROWS + 4];   // gT[jj][rr] = gossip[j, r]
  const int tx = threadIdx.x, ty = threadIdx.y;  // 32 x 8
  const int r0 = blockIdx.x * EP_ROWS;
  int sent[4] = {0, 0, 0, 0}, recv[4] = {0, 0, 0, 0};
  bool ops_r[4], jrep_r[4], proc_r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = r0 + ty + 8 * k;
    ops_r[k] = r < n && ops[r];
    jrep_r[k] = r < n && jrep[r];
    proc_r[k] = r < n && proc[r];
  }
  for (int j0 = 0; j0 < n; j0 += EP_COLS) {
    // stage gossip[j0 + jj, r0 + rr] (rows of senders, read along r)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int jj = ty + 8 * k, s = j0 + jj, r = r0 + tx;
      gT[jj][tx] = (s < n && r < n) ? gossip[(size_t)s * n + r] : 0;
    }
    __syncthreads();
    const int j = j0 + tx;
    if (j < n) {
      const bool jreq_j = jreq[j], hold_j = hold[j];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int rr = ty + 8 * k, r = r0 + rr;
        if (r >= n) continue;
        const size_t o = (size_t)r * n + j;
        const bool dfull = gT[tx][rr] && proc_r[k];
        const CellOut c = cell_rule(
            r, j, t, t_remove, m_all[o], m_fresh[o], t_fresh[o], dfull,
            known[o] != 0, hb[o], ts[o], gossip[o] != 0, gdrop[o] != 0,
            ops_r[k], jrep_r[k], jreq_j, hold_j);
        known_o[o] = c.known;
        hb_o[o] = c.hb;
        ts_o[o] = c.ts;
        gossip_o[o] = c.gossip;
        if (added_o) { added_o[o] = c.added; removed_o[o] = c.removed; }
        sent[k] += c.gsent;
        recv[k] += dfull;
      }
    }
    __syncthreads();
  }
  // a warp is one ty: reduce its 32 column lanes per row
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int sv = sent[k], rv = recv[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sv += __shfl_down_sync(0xffffffffu, sv, off);
      rv += __shfl_down_sync(0xffffffffu, rv, off);
    }
    const int r = r0 + ty + 8 * k;
    if (tx == 0 && r < n) {
      if (accumulate) { sent_row[r] += sv; recv_row[r] += rv; }
      else { sent_row[r] = sv; recv_row[r] = rv; }
    }
  }
}

// K2's per-tick vector step (ops/pallas/dense_mega.py:146-207 and the
// accounting of :267-282) in one block: updates aux in place, writes the
// lanes the matrix kernels read, and seeds this tick's sent/recv rows
// with the join traffic (the epilogue adds the gossip counts).
__global__ void __launch_bounds__(VEC_THREADS)
mega_vec_kernel(int32_t* __restrict__ aux, const uint8_t* __restrict__ qdrop,
                const uint8_t* __restrict__ pdrop, uint8_t* __restrict__ vec,
                int32_t* __restrict__ sent_s, int32_t* __restrict__ recv_s,
                int n, int t, int can_rejoin) {
  __shared__ int rep_total, req_total;
  if (threadIdx.x == 0) { rep_total = 0; req_total = 0; }
  __syncthreads();
  // introducer gates (its start/fail/rejoin lanes are never written)
  const bool failed0 = t > aux[A_FAIL] && t <= aux[A_REJOIN];
  const bool proc0 = t > aux[A_START] && !failed0;
  int my_rep = 0, my_req = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int32_t* a = aux + (size_t)i * AUX_LANES;
    bool in_group0 = a[A_IN_GROUP] > 0;
    int32_t own_hb0 = a[A_OWN_HB];
    const bool joinreq0 = a[A_JOINREQ] > 0, joinrep0 = a[A_JOINREP] > 0;
    const int32_t start = a[A_START], fail = a[A_FAIL], rejoin = a[A_REJOIN];
    const bool failed = t > fail && t <= rejoin;
    const bool proc = t > start && !failed;
    const bool rejoining = can_rejoin && t == rejoin;
    if (rejoining) { in_group0 = false; own_hb0 = 0; }
    const bool jreq = joinreq0 && proc0;
    const bool jrep = joinrep0 && proc;
    const bool starting = t == start || rejoining;
    const bool joinreq_new = starting && i != 0;
    const bool in_group = in_group0 || jrep || (starting && i == 0);
    const bool ops = proc && in_group;
    const bool joinreq_sent = joinreq_new && !qdrop[i];
    const bool joinrep_sent = jreq && !pdrop[i];
    const bool hold = !proc && !failed;
    const bool joinreq_next = joinreq_sent || (joinreq0 && !proc0 && !failed0);
    const bool joinrep_next = joinrep_sent || (joinrep0 && hold);
    a[A_IN_GROUP] = in_group;
    a[A_OWN_HB] = own_hb0 + ops;
    a[A_JOINREQ] = joinreq_next;
    a[A_JOINREP] = joinrep_next;
    vec[V_PROC * n + i] = proc;
    vec[V_OPS * n + i] = ops;
    vec[V_JREP * n + i] = jrep;
    vec[V_JREQ * n + i] = jreq;
    vec[V_HOLD * n + i] = hold;
    vec[V_REJOIN * n + i] = rejoining;
    sent_s[i] = joinreq_sent;
    recv_s[i] = jrep;
    my_rep += joinrep_sent;
    my_req += jreq;
  }
  atomicAdd(&rep_total, my_rep);
  atomicAdd(&req_total, my_req);
  __syncthreads();
  if (threadIdx.x == 0) { sent_s[0] += rep_total; recv_s[0] += req_total; }
}

// churn: a rejoining peer's row is wiped before anyone merges it
__global__ void wipe_rows_kernel(const uint8_t* __restrict__ vec,
                                 uint8_t* known, int32_t* hb, int32_t* ts,
                                 int n) {
  const int r = blockIdx.x;
  if (!vec[V_REJOIN * n + r]) return;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const size_t o = (size_t)r * n + j;
    known[o] = 0; hb[o] = 0; ts[o] = 0;
  }
}

void launch_masked_max3(const uint8_t* gossip, const uint8_t* proc,
                        const uint8_t* known, const int32_t* hb,
                        const int32_t* ts, int32_t* m_all, int32_t* m_fresh,
                        int32_t* t_fresh, int n, int t, int t_remove,
                        cudaStream_t stream) {
  const int tiles = (n + MM_TILE - 1) / MM_TILE;
  masked_max3_kernel<<<dim3(tiles, tiles), dim3(16, 16), 0, stream>>>(
      gossip, proc, known, hb, ts, m_all, m_fresh, t_fresh, n, t, t_remove);
}

void launch_epilogue(const int32_t* m_all, const int32_t* m_fresh,
                     const int32_t* t_fresh, const uint8_t* gossip,
                     const uint8_t* proc, const uint8_t* known,
                     const int32_t* hb, const int32_t* ts,
                     const uint8_t* gdrop, const uint8_t* ops,
                     const uint8_t* jrep, const uint8_t* jreq,
                     const uint8_t* hold, uint8_t* known_o, int32_t* hb_o,
                     int32_t* ts_o, uint8_t* gossip_o, int32_t* sent_row,
                     int32_t* recv_row, uint8_t* added_o, uint8_t* removed_o,
                     int n, int t, int t_remove, int accumulate,
                     cudaStream_t stream) {
  const int blocks = (n + EP_ROWS - 1) / EP_ROWS;
  tick_epilogue_kernel<<<blocks, dim3(EP_COLS, 8), 0, stream>>>(
      m_all, m_fresh, t_fresh, gossip, proc, known, hb, ts, gdrop, ops, jrep,
      jreq, hold, known_o, hb_o, ts_o, gossip_o, sent_row, recv_row, added_o,
      removed_o, n, t, t_remove, accumulate);
}

}  // namespace

extern "C" {

const char* gp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gp_masked_max3(const uint8_t* gossip, const uint8_t* proc,
                   const uint8_t* known, const int32_t* hb, const int32_t* ts,
                   int32_t* m_all, int32_t* m_fresh, int32_t* t_fresh, int n,
                   int t, int t_remove, void* stream) {
  launch_masked_max3(gossip, proc, known, hb, ts, m_all, m_fresh, t_fresh, n,
                     t, t_remove, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

int gp_tick_epilogue(const int32_t* m_all, const int32_t* m_fresh,
                     const int32_t* t_fresh, const uint8_t* gossip,
                     const uint8_t* proc, const uint8_t* known,
                     const int32_t* hb, const int32_t* ts,
                     const uint8_t* gdrop, const uint8_t* ops,
                     const uint8_t* jrep, const uint8_t* jreq,
                     const uint8_t* hold, uint8_t* known_o, int32_t* hb_o,
                     int32_t* ts_o, uint8_t* gossip_o, int32_t* sent_row,
                     int32_t* recv_row, uint8_t* added_o, uint8_t* removed_o,
                     int n, int t, int t_remove, void* stream) {
  launch_epilogue(m_all, m_fresh, t_fresh, gossip, proc, known, hb, ts, gdrop,
                  ops, jrep, jreq, hold, known_o, hb_o, ts_o, gossip_o,
                  sent_row, recv_row, added_o, removed_o, n, t, t_remove, 0,
                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// K2: s_ticks whole ticks from t0.  known/gossip are u8 planes, hb/ts i32,
// all updated in place (gossip ping-pongs with gossip_tmp; the final plane
// is copied back into gossip).  m_scratch holds 3 N^2 i32, vec_scratch
// VEC_LANES * N bytes.  added/removed (u8[S, N, N]) may be null.
int gp_dense_mega_ticks(uint8_t* known, int32_t* hb, int32_t* ts,
                        uint8_t* gossip, uint8_t* gossip_tmp, int32_t* aux,
                        const uint8_t* gdrop, const uint8_t* qdrop,
                        const uint8_t* pdrop, int32_t* sent, int32_t* recv,
                        uint8_t* added, uint8_t* removed, int32_t* m_scratch,
                        uint8_t* vec_scratch, int n, int s_ticks, int t0,
                        int t_remove, int can_rejoin, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t nn = (size_t)n * n;
  int32_t *m_all = m_scratch, *m_fresh = m_scratch + nn,
          *t_fresh = m_scratch + 2 * nn;
  uint8_t* vec = vec_scratch;
  uint8_t *cur = gossip, *nxt = gossip_tmp;
  for (int s = 0; s < s_ticks; ++s) {
    const int t = t0 + s;
    mega_vec_kernel<<<1, VEC_THREADS, 0, stream>>>(
        aux, qdrop + (size_t)s * n, pdrop + (size_t)s * n, vec,
        sent + (size_t)s * n, recv + (size_t)s * n, n, t, can_rejoin);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (can_rejoin) {
      wipe_rows_kernel<<<n, 256, 0, stream>>>(vec, known, hb, ts, n);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    launch_masked_max3(cur, vec + V_PROC * n, known, hb, ts, m_all, m_fresh,
                       t_fresh, n, t, t_remove, stream);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    launch_epilogue(m_all, m_fresh, t_fresh, cur, vec + V_PROC * n, known, hb,
                    ts, gdrop + (size_t)s * nn, vec + V_OPS * n,
                    vec + V_JREP * n, vec + V_JREQ * n, vec + V_HOLD * n,
                    known, hb, ts, nxt, sent + (size_t)s * n,
                    recv + (size_t)s * n, added ? added + (size_t)s * nn : 0,
                    removed ? removed + (size_t)s * nn : 0, n, t, t_remove, 1,
                    stream);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    uint8_t* sw = cur; cur = nxt; nxt = sw;
  }
  if (cur != gossip) {
    cudaError_t err = cudaMemcpyAsync(gossip, cur, nn, cudaMemcpyDeviceToDevice,
                                      stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
