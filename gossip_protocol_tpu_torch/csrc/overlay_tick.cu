// Overlay tick kernels for Hopper (sm_90a): the CUDA port of the three TPU
// kernels on the bounded partial-view overlay's path.
//
//   gp_fused_overlay_tick  K3, gossip_protocol_tpu/ops/pallas/
//                          overlay_exchange.py fused_overlay_tick: one
//                          tick's whole (N, K) phase (F XOR-partner merge
//                          rounds, JOINREP, JOINREQ, extraction, TREMOVE
//                          detection, per-row counters).
//   gp_mega_overlay_ticks  K4, gossip_protocol_tpu/ops/pallas/
//                          overlay_mega.py mega_overlay_ticks: S whole
//                          ticks on one (N, 2K+16) state plane, as two
//                          launches a tick on one stream with no host sync.
//   gp_grid_overlay_ticks  K5, gossip_protocol_tpu/ops/pallas/
//                          overlay_grid.py grid_overlay_ticks: S whole
//                          ticks at any power-of-two N up to 2^20 on a
//                          ping-pong (B, 2, N, 128) plane, for B fleet
//                          lanes, one launch a tick.
//
// All three call the same __device__ routines (mix32, the key and
// payload packing, the slot map, the lexicographic merge, the subject
// fail schedule, the per-row merge -> JOINREP -> JOINREQ -> extract ->
// detect pipeline), so they cannot drift apart.  Every value is an
// integer: each kernel agrees with its plain PyTorch version bit for bit.
//
// Bounds on an H100 (3.35 TB/s):
// * K3 is bound by bytes: at N=65,536, K=64, F=3 its inputs and outputs
//   are 87 MB a tick (0.026 ms) and its merges about 3.0e8 operations
//   (0.018 ms), but each row reads its own and F partner rows of idsaux
//   (K+2+F words) and pw (K words), about 140 MB a tick, since a partner
//   row is not reused on chip.  The
//   TPU folded the high mask bits into its block index map and ran a
//   butterfly in VMEM for the low ones; here a partner row r ^ m is one
//   direct, coalesced global load.  Design: one warp a row, each lane
//   owning slots lane, lane+32, ...; the partner's self-entry lands in
//   the lane that owns its slot; the counters are warp reductions, no
//   atomics.
// * K4 on the TPU held the whole plane in VMEM for 16 ticks.  At N=4096
//   the plane is 1.8 MB, above one SM's 227 KB of shared memory, so it
//   stays in HBM/L2 (where it fits whole) and each tick is (a) a
//   whole-plane pass (churn wipe into a second plane, the JOINREQ per-
//   slot atomicMax aggregate) and (b) a per-row pass (one warp a row:
//   decisions, the shared row pipeline against the wiped plane, send
//   flags, block-reduced integer metric atomics, and the row-local
//   re-slot on the last tick of a slot epoch).  At N=4096 a tick is
//   launch- and latency-bound, not bytes-bound; a persistent cluster
//   kernel with the plane in distributed shared memory is later work.
// * K5 on the TPU relied on its sequential grid order: every block of tick
//   s was committed before tick s+1 read, the next tick's JOINREQ aggregate
//   and the introducer's broadcast row revolved through scratch.  Here each
//   tick is one launch on one stream (the stream order is the barrier),
//   reading one phase of the plane and writing the other; the broadcast
//   row is the input phase's introducer row (the boot row at s = 0), and
//   tick s+1's aggregate is an atomicMax into a per-lane (S+1, K) buffer.
//   A row fetches its F partners' flag words in one round trip (lane f
//   loads partner f's), then reads a partner row r ^ m directly, and only
//   when that partner's send flag for the round is on (most power-law
//   rows have degree 1).
//   Per tick it reads and writes the 512-byte row of every peer, so at
//   N=2^20 bytes bound it (1.07 GB a tick); the four phase flags are
//   template parameters, so a steady-state launch carries none of the
//   ramp, churn, join or drop work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ID_BITS = 20;
constexpr uint32_t ID_MASK = (1u << ID_BITS) - 1u;
constexpr int SLOT_EPOCH = 16;
constexpr int32_t NEVER = 0x7FFFFFFF;
constexpr int INTRODUCER = 0;
constexpr uint32_t SALT_GOSSIP_DROP = 2, SALT_JOINREQ_DROP = 3,
                   SALT_JOINREP_DROP = 4, SALT_CHURN = 5, SALT_CHURN_TICK = 6,
                   SALT_SLOT = 7;
constexpr int MAX_K = 128;             // view slots a row
constexpr int SPL = MAX_K / 32;        // slots a lane
constexpr int MAX_F = 16;              // exchange rounds
constexpr int WARPS = 8;               // rows per block
constexpr int N_COUNTERS = 6;
// K4 plane: aux lanes relative to 2K (ops/cuda/overlay_mega.py)
enum { L_IN_GROUP = 0, L_OWN_HB = 1, L_JOINREQ = 2, L_JOINREP = 3, L_SF = 4,
       L_START = 12, L_FAIL = 13, L_REJOIN = 14, L_DEG = 15, AUX_LANES = 16 };
enum { SP_T0 = 0, SP_SEED, SP_VLO, SP_VHI, SP_FTICK, SP_RAFTER, SP_CTHR,
       SP_CAFTER, SP_DROP_ON, SP_DROP_OPEN, SP_DROP_CLOSE, SP_DROP_THR,
       SP_FAIL0, SP_REJOIN0, SP_NSCALARS };
enum { MET_IN_GROUP = 0, MET_VIEW, MET_ADDS, MET_REMOVALS,
       MET_FALSE_REMOVALS, MET_VICTIM, MET_SENT, MET_RECV, MET_USED,
       MET_COLS = 128 };

// ---- counter hash (utils/hash32.py mix32) ---------------------------------
constexpr uint32_t G0 = 0x9E3779B1u, G1 = 0x85EBCA6Bu, G2 = 0xC2B2AE35u,
                   G3 = 0x27D4EB2Fu;

__device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}
__device__ __forceinline__ uint32_t mix32(uint32_t s, uint32_t a, uint32_t b) {
  return fmix(s + (a + 1u) * G0 + (b + 1u) * G1);
}
__device__ __forceinline__ uint32_t mix32(uint32_t s, uint32_t a, uint32_t b,
                                          uint32_t c) {
  return fmix(s + (a + 1u) * G0 + (b + 1u) * G1 + (c + 1u) * G2);
}
__device__ __forceinline__ uint32_t mix32(uint32_t s, uint32_t a, uint32_t b,
                                          uint32_t c, uint32_t d) {
  return fmix(s + (a + 1u) * G0 + (b + 1u) * G1 + (c + 1u) * G2 +
              (d + 1u) * G3);
}

// ---- entry packing (models/overlay.py) ------------------------------------
__device__ __forceinline__ uint32_t pack_key(int32_t id, int32_t ts) {
  return ((uint32_t)(ts + 1) << ID_BITS) | (uint32_t)id;
}
__device__ __forceinline__ int32_t pack_th(int32_t ts, int32_t hb) {
  return ((ts + 1) << 12) | (hb + 1);
}
__device__ __forceinline__ int slot_of(uint32_t seed, uint32_t ep, int32_t id,
                                       int k) {
  return (int)(mix32(seed, ep, (uint32_t)id, SALT_SLOT) % (uint32_t)k);
}
// lexicographic (key, payload) max: associative and commutative
__device__ __forceinline__ void lex(uint32_t& km, int32_t& pa, uint32_t kc,
                                    int32_t pc) {
  if (kc > km || (kc == km && pc > pa)) { km = kc; pa = pc; }
}

// The closed-form schedule a subject's removal is judged against.
struct Sched {
  uint32_t seed, churn_thr;
  int32_t victim_lo, victim_hi, fail_tick, rejoin_after, churn_after,
      churn_lo, churn_span, t_remove;
};

// (fail, rejoin) ticks of one subject id, closed form.
__device__ __forceinline__ void fail_rejoin_of(const Sched& s, int32_t subj,
                                               int32_t& fail,
                                               int32_t& rejoin) {
  const uint32_t su = (uint32_t)subj;
  if (s.churn_thr > 0u) {
    const bool churned =
        mix32(s.seed, su, SALT_CHURN) < s.churn_thr && subj != INTRODUCER;
    fail = churned ? s.churn_lo + (int32_t)(mix32(s.seed, su, SALT_CHURN_TICK) %
                                            (uint32_t)s.churn_span)
                   : NEVER;
  } else {
    fail = (subj >= s.victim_lo && subj < s.victim_hi) ? s.fail_tick : NEVER;
  }
  const int32_t after = s.churn_thr > 0u ? s.churn_after : s.rejoin_after;
  rejoin = (fail != NEVER && after != NEVER) ? fail + after : NEVER;
}

__device__ __forceinline__ bool subject_failed(const Sched& s, int32_t subj,
                                               int32_t t) {
  int32_t fail, rejoin;
  fail_rejoin_of(s, subj, fail, rejoin);
  return t > fail && t <= rejoin;
}

// ---- the per-row pipeline (one warp, lane owns slots lane + 32 jj) --------
struct RowAcc {
  uint32_t km[SPL];
  int32_t pa[SPL];
  int32_t id0[SPL];
};

// A view row in registers: this lane's slots of ids and payload words.
struct ViewRegs {
  int32_t ids[SPL];
  int32_t pw[SPL];
};

// Load a view row (ids at ids[j], payload words at pw[j]); ``pw_mask``
// strips K5's aux bytes from its payload lanes.
__device__ __forceinline__ void load_view(ViewRegs& v, const int32_t* ids,
                                          const int32_t* pw, int k, int lane,
                                          int32_t pw_mask = -1) {
#pragma unroll
  for (int jj = 0; jj < SPL; ++jj) {
    const int j = lane + 32 * jj;
    v.ids[jj] = j < k ? ids[j] : -1;
    v.pw[jj] = j < k ? pw[j] & pw_mask : 0;
  }
}

__device__ __forceinline__ void acc_init(RowAcc& r, const ViewRegs& v) {
#pragma unroll
  for (int jj = 0; jj < SPL; ++jj) {
    const int32_t id = v.ids[jj];
    const int32_t p = id >= 0 ? v.pw[jj] : 0;
    r.id0[jj] = id;
    r.km[jj] = id >= 0 ? pack_key(id, (p >> 12) - 1) : 0u;
    r.pa[jj] = p;
  }
}

// Merge an identically-slotted incoming view (a partner's table or the
// introducer's JOINREP broadcast); an invalid candidate is (0, 0).
__device__ __forceinline__ void merge_view(RowAcc& r, const ViewRegs& v,
                                           bool ok, int32_t row, int32_t t,
                                           int32_t t_remove, int k, int lane) {
#pragma unroll
  for (int jj = 0; jj < SPL; ++jj) {
    const int j = lane + 32 * jj;
    if (j >= k) continue;
    uint32_t key = 0u;
    int32_t p = 0;
    if (ok) {
      const int32_t id = v.ids[jj], pv = v.pw[jj];
      const int32_t ts = (pv >> 12) - 1;
      if (id >= 0 && t - ts < t_remove && id != row) {
        key = pack_key(id, ts);
        p = pv;
      }
    }
    lex(r.km[jj], r.pa[jj], key, p);
  }
}

// Merge one direct entry (subj, t-1, hb) at its slot; (0, 0) elsewhere.
__device__ __forceinline__ void merge_entry(RowAcc& r, int32_t subj,
                                            int32_t e_ts, int32_t e_hb, bool ok,
                                            uint32_t seed, uint32_t ep, int k,
                                            int lane) {
  const int sl = slot_of(seed, ep, subj, k);
  const uint32_t key = ok ? pack_key(subj, e_ts) : 0u;
  const int32_t p = ok ? pack_th(e_ts, e_hb) : 0;
#pragma unroll
  for (int jj = 0; jj < SPL; ++jj) {
    const int j = lane + 32 * jj;
    if (j >= k) continue;
    const bool m = j == sl;
    lex(r.km[jj], r.pa[jj], m ? key : 0u, m ? p : 0);
  }
}

// JOINREQ aggregate (per-slot key and payload) into the introducer's row.
__device__ __forceinline__ void merge_joinreq(RowAcc& r, bool is_r0,
                                              const uint32_t* q_kf,
                                              const int32_t* q_pf, int32_t t,
                                              int k, int lane) {
#pragma unroll
  for (int jj = 0; jj < SPL; ++jj) {
    const int j = lane + 32 * jj;
    if (j >= k) continue;
    uint32_t key = 0u;
    int32_t p = 0;
    if (is_r0) {
      key = q_kf[j];
      p = q_pf ? q_pf[j] : (key > 0u ? pack_th(t, 1) : 0);
    }
    lex(r.km[jj], r.pa[jj], key, p);
  }
}

struct RowOut {
  int32_t ids[SPL], hb[SPL], ts[SPL];
  int removals, false_removals, victims, adds, view;
};

// Winner extraction, TREMOVE staleness detection, and this lane's share of
// the per-row counters.  ``kSubjects`` false: no subject is inside its fail
// window (K5's churn-dead launches), so the subject schedule is skipped.
template <bool kSubjects = true>
__device__ __forceinline__ void extract_detect(const RowAcc& r, bool ops,
                                               int32_t t, const Sched& s,
                                               int k, int lane, RowOut& o) {
  o.removals = o.false_removals = o.victims = o.adds = o.view = 0;
#pragma unroll
  for (int jj = 0; jj < SPL; ++jj) {
    const int j = lane + 32 * jj;
    o.ids[jj] = -1;
    o.hb[jj] = 0;
    o.ts[jj] = 0;
    if (j >= k) continue;
    const bool occ = r.km[jj] > 0u;
    const int32_t ids1 = occ ? (int32_t)(r.km[jj] & ID_MASK) : -1;
    const int32_t ts1 = occ ? (r.pa[jj] >> 12) - 1 : 0;
    const int32_t hb1 = occ ? (r.pa[jj] & 0xFFF) - 1 : 0;
    const bool stale = ids1 >= 0 && t - ts1 >= s.t_remove && ops;
    const bool sfail = kSubjects && subject_failed(s, ids1 > 0 ? ids1 : 0, t);
    o.ids[jj] = stale ? -1 : ids1;
    o.hb[jj] = stale ? 0 : hb1;
    o.ts[jj] = stale ? 0 : ts1;
    o.removals += stale;
    o.false_removals += stale && !sfail;
    o.victims += o.ids[jj] >= 0 && sfail && !stale;
    o.adds += ids1 != r.id0[jj] && ids1 >= 0;
    o.view += o.ids[jj] >= 0;
  }
}

__device__ __forceinline__ int warp_sum(int v) {
  return (int)__reduce_add_sync(0xffffffffu, (unsigned)v);
}

// ---- K3 -------------------------------------------------------------------
struct K3Args {
  Sched s;
  int32_t t;
  int32_t masks[MAX_F];
};

__global__ void __launch_bounds__(WARPS * 32)
fused_overlay_tick_kernel(const int32_t* __restrict__ idsaux,
                          const int32_t* __restrict__ pw,
                          const int32_t* __restrict__ intro, K3Args a,
                          int32_t* __restrict__ ids_o,
                          int32_t* __restrict__ hb_o,
                          int32_t* __restrict__ ts_o,
                          int32_t* __restrict__ ctr, int n, int k, int f) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;   // uniform across the warp
  const int w = k + 2 + f;
  const int32_t t = a.t;
  const uint32_t ep = (uint32_t)(t / SLOT_EPOCH);
  const int32_t* my = idsaux + (size_t)row * w;
  const int32_t bits = my[k + 1];
  const bool proc = bits & 1, ops = bits & 2, jrep = bits & 4;
  RowAcc r;
  ViewRegs own;
  load_view(own, my, pw + (size_t)row * k, k, lane);
  acc_init(r, own);
  int recv = 0;
  for (int fi = 0; fi < f; ++fi) {
    const int32_t partner = row ^ a.masks[fi];
    const int32_t* pr = idsaux + (size_t)partner * w;
    const bool ok = pr[k + 2 + fi] > 0 && proc;
    ViewRegs pv;
    if (ok) load_view(pv, pr, pw + (size_t)partner * k, k, lane);
    merge_view(r, pv, ok, row, t, a.s.t_remove, k, lane);
    if (a.s.t_remove > 1)
      merge_entry(r, partner, t - 1, ok ? pr[k] : 0, ok, a.s.seed, ep, k,
                  lane);
    recv += ok;
  }
  ViewRegs iv;
  if (jrep) load_view(iv, intro, intro + k, k, lane);
  merge_view(r, iv, jrep, row, t, a.s.t_remove, k, lane);
  if (a.s.t_remove > 1)
    merge_entry(r, INTRODUCER, t - 1, intro[2 * k], jrep && row != INTRODUCER,
                a.s.seed, ep, k, lane);
  merge_joinreq(r, row == INTRODUCER,
                reinterpret_cast<const uint32_t*>(intro + 3 * k), intro + 4 * k,
                t, k, lane);
  RowOut o;
  extract_detect(r, ops, t, a.s, k, lane, o);
#pragma unroll
  for (int jj = 0; jj < SPL; ++jj) {
    const int j = lane + 32 * jj;
    if (j >= k) continue;
    const size_t off = (size_t)row * k + j;
    ids_o[off] = o.ids[jj];
    hb_o[off] = o.hb[jj];
    ts_o[off] = o.ts[jj];
  }
  const int c[N_COUNTERS] = {recv, warp_sum(o.removals),
                             warp_sum(o.false_removals), warp_sum(o.victims),
                             warp_sum(o.adds), warp_sum(o.view)};
  if (lane < N_COUNTERS) {
    int v = c[0];
#pragma unroll
    for (int i = 1; i < N_COUNTERS; ++i)
      if (lane == i) v = c[i];
    ctr[(size_t)row * N_COUNTERS + lane] = v;
  }
}

// ---- K4 -------------------------------------------------------------------
struct K4Args {
  Sched s;
  int32_t t, fail0, rejoin0, drop_open, drop_close;
  uint32_t drop_thr;
  int drop_on, can_rejoin, powerlaw;
  int32_t masks[MAX_F];
};

// Sum WARPS per-warp values of each metric across the block and add the
// block's totals to met (integer atomics: exact in any order).
__device__ __forceinline__ void block_metrics(const int (&v)[MET_USED],
                                              int32_t* met) {
  __shared__ int part[WARPS][MET_USED];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < MET_USED; ++i) part[warp][i] = v[i];
  __syncthreads();
  if (threadIdx.x < MET_USED) {
    int sum = 0;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) sum += part[wi][threadIdx.x];
    if (sum) atomicAdd(met + threadIdx.x, sum);
  }
}

// (a) whole plane: the churn wipe into `wiped` (the tick's frozen send
// payload) and the JOINREQ per-slot aggregate at the introducer.
__global__ void __launch_bounds__(WARPS * 32)
mega_prep_kernel(const int32_t* __restrict__ st, int32_t* __restrict__ wiped,
                 uint32_t* __restrict__ q_kf, int32_t* __restrict__ met,
                 K4Args a, int n, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int aa = 2 * k, w = aa + AUX_LANES;
  int jreq = 0;
  if (row < n) {
    const int32_t* src = st + (size_t)row * w;
    int32_t* dst = wiped + (size_t)row * w;
    const bool rejoining = a.can_rejoin && a.t == src[aa + L_REJOIN];
    for (int j = lane; j < w; j += 32) {
      int32_t v = src[j];
      if (rejoining && j < aa + L_JOINREQ) v = j < k ? -1 : 0;
      dst[j] = v;
    }
    const bool failed0 = a.t > a.fail0 && a.t <= a.rejoin0;
    const bool proc0 = a.t > 0 && !failed0;
    jreq = src[aa + L_JOINREQ] > 0 && proc0;
    if (lane == 0 && jreq && row != INTRODUCER) {
      const uint32_t ep = (uint32_t)(a.t / SLOT_EPOCH);
      atomicMax(q_kf + slot_of(a.s.seed, ep, row, k), pack_key(row, a.t));
    }
  }
  int v[MET_USED] = {0, 0, 0, 0, 0, 0, 0, 0};
  v[MET_RECV] = jreq;   // JOINREQs consumed by the introducer
  block_metrics(v, met);
}

// Re-slot one row into the next epoch's slot map (lexicographic max over
// the entries that land in each slot), in registers.
__device__ __forceinline__ void reslot_row(int32_t (&ids)[SPL],
                                           int32_t (&pwv)[SPL], uint32_t seed,
                                           uint32_t ep, int k, int lane) {
  int tgt[SPL];
  uint32_t key[SPL];
  int32_t p[SPL];
#pragma unroll
  for (int jj = 0; jj < SPL; ++jj) {
    const int j = lane + 32 * jj;
    tgt[jj] = j < k ? slot_of(seed, ep, ids[jj], k) : -1;
    key[jj] = (j < k && ids[jj] >= 0) ? pack_key(ids[jj], (pwv[jj] >> 12) - 1)
                                      : 0u;
    p[jj] = (j < k && ids[jj] >= 0) ? pwv[jj] : 0;
  }
  uint32_t kf[SPL];
  int32_t pf[SPL];
#pragma unroll
  for (int jj = 0; jj < SPL; ++jj) { kf[jj] = 0u; pf[jj] = 0; }
#pragma unroll
  for (int sj = 0; sj < SPL; ++sj) {
    if (32 * sj >= k) break;
    for (int src = 0; src < 32; ++src) {
      const int tg = __shfl_sync(0xffffffffu, tgt[sj], src);
      const uint32_t ky = __shfl_sync(0xffffffffu, key[sj], src);
      const int32_t pv = __shfl_sync(0xffffffffu, p[sj], src);
      if (ky == 0u) continue;
#pragma unroll
      for (int jj = 0; jj < SPL; ++jj)
        if (tg == lane + 32 * jj) lex(kf[jj], pf[jj], ky, pv);
    }
  }
#pragma unroll
  for (int jj = 0; jj < SPL; ++jj) {
    ids[jj] = kf[jj] > 0u ? (int32_t)(kf[jj] & ID_MASK) : -1;
    pwv[jj] = kf[jj] > 0u ? max(pf[jj], 0) : 0;
  }
}

// (b) per row: the whole tick of one row against the wiped plane.
__global__ void __launch_bounds__(WARPS * 32)
mega_row_kernel(int32_t* __restrict__ st, const int32_t* __restrict__ wiped,
                const uint32_t* __restrict__ q_kf, int32_t* __restrict__ met,
                K4Args a, int n, int k, int f) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int aa = 2 * k, w = aa + AUX_LANES;
  const int32_t t = a.t;
  int v[MET_USED] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (row < n) {
    const uint32_t ep = (uint32_t)(t / SLOT_EPOCH);
    const int32_t* W = wiped + (size_t)row * w;
    const bool in_group0 = W[aa + L_IN_GROUP] > 0;
    const int32_t own_hb0 = W[aa + L_OWN_HB];
    const bool joinreq_c = W[aa + L_JOINREQ] > 0;
    const bool joinrep_c = W[aa + L_JOINREP] > 0;
    const int32_t start = W[aa + L_START], fail = W[aa + L_FAIL],
                  rejoin = W[aa + L_REJOIN], deg = W[aa + L_DEG];
    const bool failed = t > fail && t <= rejoin;
    const bool proc = t > start && !failed;
    const bool rejoining = a.can_rejoin && t == rejoin;
    const bool failed0 = t > a.fail0 && t <= a.rejoin0;
    const bool proc0 = t > 0 && !failed0;
    // vector decisions
    const bool jrep = joinrep_c && proc;
    const bool starting = t == start || rejoining;
    const bool in_group =
        in_group0 || jrep || (starting && row == INTRODUCER);
    const bool ops = proc && in_group;
    const int32_t own_hb = own_hb0 + ops;
    // merges
    RowAcc r;
    ViewRegs own;
    load_view(own, W, W + k, k, lane);
    acc_init(r, own);
    int recv = 0;
    for (int fi = 0; fi < f; ++fi) {
      const int32_t partner = row ^ a.masks[fi];
      const int32_t* P = wiped + (size_t)partner * w;
      const bool ok = P[aa + L_SF + fi] > 0 && proc;
      ViewRegs pv;
      if (ok) load_view(pv, P, P + k, k, lane);
      merge_view(r, pv, ok, row, t, a.s.t_remove, k, lane);
      if (a.s.t_remove > 1)
        merge_entry(r, partner, t - 1, ok ? P[aa + L_OWN_HB] : 0, ok,
                    a.s.seed, ep, k, lane);
      recv += ok;
    }
    const int32_t* B = wiped;   // the introducer's row (JOINREP source)
    ViewRegs bv;
    if (jrep) load_view(bv, B, B + k, k, lane);
    merge_view(r, bv, jrep, row, t, a.s.t_remove, k, lane);
    if (a.s.t_remove > 1)
      merge_entry(r, INTRODUCER, t - 1, B[aa + L_OWN_HB],
                  jrep && row != INTRODUCER, a.s.seed, ep, k, lane);
    merge_joinreq(r, row == INTRODUCER, q_kf, nullptr, t, k, lane);
    RowOut o;
    extract_detect(r, ops, t, a.s, k, lane, o);
    // dissemination: next tick's send flags and the join sends
    const bool active = a.drop_on && t > a.drop_open && t <= a.drop_close;
    int sf_bits = 0, n_sf = 0;
    for (int fi = 0; fi < f; ++fi) {
      const bool gdrop = mix32(a.s.seed, (uint32_t)t, (uint32_t)row,
                               (uint32_t)fi, SALT_GOSSIP_DROP) < a.drop_thr;
      bool sf = ops && !(active && gdrop);
      if (a.powerlaw) sf = sf && fi < deg;
      sf_bits |= sf << fi;
      n_sf += sf;
    }
    const bool joinreq_new = starting && row != INTRODUCER;
    const bool qdrop = mix32(a.s.seed, (uint32_t)t, (uint32_t)row,
                             SALT_JOINREQ_DROP) < a.drop_thr;
    const bool pdrop = mix32(a.s.seed, (uint32_t)t, (uint32_t)row,
                             SALT_JOINREP_DROP) < a.drop_thr;
    const bool joinreq_sent = joinreq_new && !(active && qdrop);
    const bool jreq = joinreq_c && proc0;
    const bool joinrep_sent = jreq && !(active && pdrop);
    const bool live_hold = !proc && !failed;
    const bool joinreq_next =
        joinreq_sent || (joinreq_c && !proc0 && !failed0);
    const bool joinrep_next = joinrep_sent || (joinrep_c && live_hold);
    // metrics (one warp: lane 0's totals count)
    const int view = warp_sum(o.view), adds = warp_sum(o.adds),
              rem = warp_sum(o.removals), frem = warp_sum(o.false_removals),
              vic = warp_sum(o.victims);
    if (lane == 0) {
      v[MET_IN_GROUP] = in_group;
      v[MET_VIEW] = view;
      v[MET_ADDS] = adds;
      v[MET_REMOVALS] = rem;
      v[MET_FALSE_REMOVALS] = frem;
      v[MET_VICTIM] = vic;
      v[MET_SENT] = n_sf + joinreq_sent + joinrep_sent;
      v[MET_RECV] = recv + jrep;
    }
    // the end-of-tick row, re-slotted on the last tick of an epoch
    int32_t pwv[SPL];
#pragma unroll
    for (int jj = 0; jj < SPL; ++jj)
      pwv[jj] = o.ids[jj] >= 0 ? pack_th(o.ts[jj], o.hb[jj]) : 0;
    if ((t + 1) % SLOT_EPOCH == 0)
      reslot_row(o.ids, pwv, a.s.seed, (uint32_t)((t + 1) / SLOT_EPOCH), k,
                 lane);
    int32_t* D = st + (size_t)row * w;
#pragma unroll
    for (int jj = 0; jj < SPL; ++jj) {
      const int j = lane + 32 * jj;
      if (j >= k) continue;
      D[j] = o.ids[jj];
      D[k + j] = pwv[jj];
    }
    if (lane < L_START) {
      int32_t x;
      if (lane == L_IN_GROUP) x = in_group;
      else if (lane == L_OWN_HB) x = own_hb;
      else if (lane == L_JOINREQ) x = joinreq_next;
      else if (lane == L_JOINREP) x = joinrep_next;
      else x = (sf_bits >> (lane - L_SF)) & 1;
      D[aa + lane] = x;
    }
  }
  block_metrics(v, met);
}


// ---- K5 -------------------------------------------------------------------
// The plane: row r of a lane is PLANE_W words: lanes [0, K) ids, [K, 2K) the
// 24-bit payload words with the aux bytes in the high byte of payload lanes
// 0-2 (own_hb low 8 bits; own_hb bits 8-11 | in_group << 4 | joinreq << 5 |
// joinrep << 6; the F send-flag bits), the rest zero.  The boot block holds
// 8 rows a lane: row 0 the introducer's row, row 1 lanes [0, K) the boot
// JOINREQ aggregate (ops/cuda/overlay_grid.py).
constexpr int PLANE_W = 128;
constexpr int32_t PW_MASK = 0x00FFFFFF;
enum { GSP_T0 = 0, GSP_SEED, GSP_VLO, GSP_VHI, GSP_FTICK, GSP_RAFTER,
       GSP_CTHR, GSP_CAFTER, GSP_DROP_ON, GSP_DROP_OPEN, GSP_DROP_CLOSE,
       GSP_DROP_THR, GSP_FAIL0, GSP_REJOIN0, GSP_STEP_NUM, GSP_STEP_DEN,
       GSP_NSCALARS };
enum { FL_RAMP = 1, FL_CHURN = 2, FL_JOIN = 4, FL_DROP = 8 };
constexpr uint32_t SALT_DEGREE = 8;

struct K5Args {
  int n, k, f, s_ticks, sp_len, t_remove, churn_lo, churn_span;
  int can_rejoin, churn_mode, powerlaw;
  int s;                  // this launch's tick within the call
  size_t in_lane, bc_lane, out_lane, q_lane;   // lane strides (words)
};

// One tick of every row of every lane: grid (N / WARPS, B), one warp a row.
// Reads `in` (the input plane at s = 0, else the previous tick's phase of
// plane2), writes `out` (the other phase); `bc` is the introducer's
// broadcast row; `q` holds the tick's JOINREQ aggregate (K words), and tick
// s+1's aggregate is atomicMax-ed into the K words after it.  The template
// flags elide the launch's dead phases (models/segments.py guarantees).
template <bool RAMP, bool CHURN, bool JOIN, bool DROP>
__global__ void __launch_bounds__(WARPS * 32)
grid_tick_kernel(const int32_t* __restrict__ in, const int32_t* __restrict__ bc,
                 uint32_t* __restrict__ q, int32_t* __restrict__ out,
                 int32_t* __restrict__ met, const int32_t* __restrict__ sp,
                 K5Args a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int b = blockIdx.y;               // fleet lane
  const int k = a.k, f = a.f;
  const int32_t* P = sp + (size_t)b * a.sp_len;
  const int32_t t = P[GSP_T0] + a.s;
  Sched sc;
  sc.seed = (uint32_t)P[GSP_SEED];
  // churn draws only in churn mode; with a zero threshold every subject
  // takes the victim interval, which gives NEVER where the TPU kernel's
  // churn branch would (no churned subject)
  sc.churn_thr = a.churn_mode ? (uint32_t)P[GSP_CTHR] : 0u;
  sc.victim_lo = P[GSP_VLO];
  sc.victim_hi = P[GSP_VHI];
  sc.fail_tick = P[GSP_FTICK];
  sc.rejoin_after = P[GSP_RAFTER];
  sc.churn_after = P[GSP_CAFTER];
  sc.churn_lo = a.churn_lo;
  sc.churn_span = a.churn_span;
  sc.t_remove = a.t_remove;
  const int32_t* masks = P + GSP_NSCALARS + max(f - 1, 0) + a.s * f;
  in += b * a.in_lane;
  bc += b * a.bc_lane;
  q += b * a.q_lane;
  out += b * a.out_lane;
  met += ((size_t)b * a.s_ticks + a.s) * MET_COLS;
  int v[MET_USED] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (row < a.n) {
    const uint32_t ep = (uint32_t)(t / SLOT_EPOCH);
    const int32_t fail0 = P[GSP_FAIL0], rejoin0 = P[GSP_REJOIN0];
    const bool failed0 = CHURN && t > fail0 && t <= rejoin0;
    const bool proc0 = t > 0 && !failed0;
    const bool wipe = CHURN && a.can_rejoin;
    // the F partners' send-flag bits in one round trip (lane fi loads
    // partner fi's flag word), issued before the own row's loads
    uint32_t flag_word = 0u;
    if (lane < f)
      flag_word = (uint32_t)in[(size_t)(row ^ masks[lane]) * PLANE_W + k + 2];
    const uint32_t sent_to_us = __ballot_sync(
        0xffffffffu, lane < f && ((flag_word >> (24 + lane)) & 1u));
    // own row: unpack, wipe, decisions
    const int32_t* R = in + (size_t)row * PLANE_W;
    ViewRegs own;
    load_view(own, R, R + k, k, lane, PW_MASK);
    const uint32_t a0 = (uint32_t)R[k] >> 24, a1 = (uint32_t)R[k + 1] >> 24;
    int32_t own_hb0 = (int32_t)(a0 | ((a1 & 0xFu) << 8));
    bool in_group0 = a1 & 0x10u;
    const bool joinreq0 = JOIN && (a1 & 0x20u);
    const bool joinrep0 = JOIN && (a1 & 0x40u);
    int32_t fail = NEVER, rejoin = NEVER;
    if (CHURN) fail_rejoin_of(sc, row, fail, rejoin);
    const bool failed = CHURN && t > fail && t <= rejoin;
    bool proc = !failed, at_start = false;
    if (RAMP) {   // division-free start ramp: t > i*num//den <=> i*num < t*den
      const int32_t ramp = (int32_t)((uint32_t)row * (uint32_t)P[GSP_STEP_NUM]);
      const int32_t lo = t * P[GSP_STEP_DEN];
      proc = ramp < lo && !failed;
      at_start = ramp >= lo && ramp < lo + P[GSP_STEP_DEN];
    }
    const bool rejoining = wipe && t == rejoin;
    if (rejoining) {
#pragma unroll
      for (int jj = 0; jj < SPL; ++jj) { own.ids[jj] = -1; own.pw[jj] = 0; }
      in_group0 = false;
      own_hb0 = 0;
    }
    const bool starting = at_start || rejoining;
    const bool jrep = joinrep0 && proc;
    const bool in_group =
        in_group0 || jrep || (starting && row == INTRODUCER);
    const bool ops = proc && in_group;
    const int32_t own_hb = own_hb0 + ops;
    // merges: F partner rounds (a partner whose send flag is off sends
    // nothing, so its row is not read)
    RowAcc r;
    acc_init(r, own);
    int recv = 0;
    for (int fi = 0; fi < f; ++fi) {
      if (!(proc && (sent_to_us >> fi & 1u))) continue;
      const int32_t partner = row ^ masks[fi];
      const int32_t* Q = in + (size_t)partner * PLANE_W;
      ViewRegs pv;
      load_view(pv, Q, Q + k, k, lane, PW_MASK);
      int32_t own_p = (int32_t)(((uint32_t)Q[k] >> 24) |
                                (((uint32_t)Q[k + 1] >> 24 & 0xFu) << 8));
      if (wipe) {   // wipe-on-load of a rejoining partner
        int32_t pf, pr;
        fail_rejoin_of(sc, partner, pf, pr);
        if (t == pr) {
#pragma unroll
          for (int jj = 0; jj < SPL; ++jj) { pv.ids[jj] = -1; pv.pw[jj] = 0; }
          own_p = 0;
        }
      }
      merge_view(r, pv, true, row, t, a.t_remove, k, lane);
      if (a.t_remove > 1)
        merge_entry(r, partner, t - 1, own_p, true, sc.seed, ep, k, lane);
      ++recv;
    }
    if (jrep) {   // JOINREP: the introducer's broadcast row
      ViewRegs bv;
      load_view(bv, bc, bc + k, k, lane, PW_MASK);
      int32_t bc_hb = (int32_t)(((uint32_t)bc[k] >> 24) |
                                (((uint32_t)bc[k + 1] >> 24 & 0xFu) << 8));
      if (wipe && t == rejoin0) {
#pragma unroll
        for (int jj = 0; jj < SPL; ++jj) { bv.ids[jj] = -1; bv.pw[jj] = 0; }
        bc_hb = 0;
      }
      merge_view(r, bv, true, row, t, a.t_remove, k, lane);
      if (a.t_remove > 1)
        merge_entry(r, INTRODUCER, t - 1, bc_hb, row != INTRODUCER, sc.seed,
                    ep, k, lane);
    }
    if (JOIN && row == INTRODUCER)
      merge_joinreq(r, true, q, nullptr, t, k, lane);
    RowOut o;
    extract_detect<CHURN>(r, ops, t, sc, k, lane, o);
    // dissemination: next tick's send flags and the join sends
    const bool active = DROP && P[GSP_DROP_ON] > 0 &&
                        t > P[GSP_DROP_OPEN] && t <= P[GSP_DROP_CLOSE];
    const uint32_t drop_thr = (uint32_t)P[GSP_DROP_THR];
    int deg = f;
    if (a.powerlaw) {
      const uint32_t du = mix32(sc.seed, (uint32_t)row, SALT_DEGREE);
      deg = 1;
      for (int j = 0; j + 1 < f; ++j)
        deg += du < (uint32_t)P[GSP_NSCALARS + j];
    }
    int sf_bits = 0, n_sf = 0;
    for (int fi = 0; fi < f; ++fi) {
      bool sf = ops && fi < deg;
      if (active)
        sf = sf && !(mix32(sc.seed, (uint32_t)t, (uint32_t)row, (uint32_t)fi,
                           SALT_GOSSIP_DROP) < drop_thr);
      sf_bits |= sf << fi;
      n_sf += sf;
    }
    bool joinreq_sent = false, joinrep_sent = false, jreq = false;
    bool joinreq_next = false, joinrep_next = false;
    if (JOIN) {
      jreq = joinreq0 && proc0;
      joinreq_sent = starting && row != INTRODUCER;
      joinrep_sent = jreq;
      if (active) {
        joinreq_sent = joinreq_sent &&
                       !(mix32(sc.seed, (uint32_t)t, (uint32_t)row,
                               SALT_JOINREQ_DROP) < drop_thr);
        joinrep_sent = joinrep_sent &&
                       !(mix32(sc.seed, (uint32_t)t, (uint32_t)row,
                               SALT_JOINREP_DROP) < drop_thr);
      }
      joinreq_next = joinreq_sent || (joinreq0 && !proc0 && !failed0);
      joinrep_next = joinrep_sent || (joinrep0 && !proc && !failed);
      // tick t+1's JOINREQ aggregate (the TPU's q_nxt scratch)
      const int32_t t1 = t + 1;
      const bool proc0_1 = t1 > 0 && !(CHURN && t1 > fail0 && t1 <= rejoin0);
      if (lane == 0 && joinreq_next && proc0_1 && row != INTRODUCER)
        atomicMax(q + k + slot_of(sc.seed, (uint32_t)(t1 / SLOT_EPOCH), row, k),
                  pack_key(row, t1));
    }
    // metrics (one warp: lane 0's totals count)
    const int view = warp_sum(o.view), adds = warp_sum(o.adds),
              rem = warp_sum(o.removals), frem = warp_sum(o.false_removals),
              vic = warp_sum(o.victims);
    if (lane == 0) {
      v[MET_IN_GROUP] = in_group;
      v[MET_VIEW] = view;
      v[MET_ADDS] = adds;
      v[MET_REMOVALS] = rem;
      v[MET_FALSE_REMOVALS] = frem;
      v[MET_VICTIM] = vic;
      v[MET_SENT] = n_sf + joinreq_sent + joinrep_sent;
      v[MET_RECV] = recv + jrep + jreq;
    }
    // the end-of-tick row, re-slotted on the last tick of an epoch, with
    // the aux bytes on payload lanes 0-2
    int32_t pwv[SPL];
#pragma unroll
    for (int jj = 0; jj < SPL; ++jj)
      pwv[jj] = o.ids[jj] >= 0 ? pack_th(o.ts[jj], o.hb[jj]) : 0;
    if ((t + 1) % SLOT_EPOCH == 0)
      reslot_row(o.ids, pwv, sc.seed, (uint32_t)((t + 1) / SLOT_EPOCH), k,
                 lane);
    const uint32_t aux[3] = {
        (uint32_t)own_hb & 0xFFu,
        (((uint32_t)own_hb >> 8) & 0xFu) | (uint32_t)in_group << 4 |
            (uint32_t)joinreq_next << 5 | (uint32_t)joinrep_next << 6,
        (uint32_t)sf_bits};
    int32_t* D = out + (size_t)row * PLANE_W;
#pragma unroll
    for (int jj = 0; jj < SPL; ++jj) {
      const int j = lane + 32 * jj;
      if (j >= k) continue;
      D[j] = o.ids[jj];
      D[k + j] = (int32_t)((uint32_t)pwv[jj] | (j < 3 ? aux[j] << 24 : 0u));
    }
    for (int j = 2 * k + lane; j < PLANE_W; j += 32) D[j] = 0;
  }
  block_metrics(v, met);
}

typedef void (*GridTickKernel)(const int32_t*, const int32_t*, uint32_t*,
                               int32_t*, int32_t*, const int32_t*, K5Args);

#define GP_GRID_KERNEL(fl)                                               \
  grid_tick_kernel<((fl) & FL_RAMP) != 0, ((fl) & FL_CHURN) != 0,        \
                   ((fl) & FL_JOIN) != 0, ((fl) & FL_DROP) != 0>
const GridTickKernel kGridKernels[16] = {
    GP_GRID_KERNEL(0),  GP_GRID_KERNEL(1),  GP_GRID_KERNEL(2),
    GP_GRID_KERNEL(3),  GP_GRID_KERNEL(4),  GP_GRID_KERNEL(5),
    GP_GRID_KERNEL(6),  GP_GRID_KERNEL(7),  GP_GRID_KERNEL(8),
    GP_GRID_KERNEL(9),  GP_GRID_KERNEL(10), GP_GRID_KERNEL(11),
    GP_GRID_KERNEL(12), GP_GRID_KERNEL(13), GP_GRID_KERNEL(14),
    GP_GRID_KERNEL(15)};
#undef GP_GRID_KERNEL

Sched make_sched(uint32_t seed, int32_t vlo, int32_t vhi, int32_t ftick,
                 int32_t rafter, uint32_t cthr, int32_t cafter,
                 int32_t churn_lo, int32_t churn_span, int32_t t_remove) {
  Sched s;
  s.seed = seed;
  s.churn_thr = cthr;
  s.victim_lo = vlo;
  s.victim_hi = vhi;
  s.fail_tick = ftick;
  s.rejoin_after = rafter;
  s.churn_after = cafter;
  s.churn_lo = churn_lo;
  s.churn_span = churn_span;
  s.t_remove = t_remove;
  return s;
}

}  // namespace

extern "C" {

const char* gp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K3.  host = [t, seed, victim_lo, victim_hi, fail_tick, rejoin_after,
// churn_thr, churn_after, mask_0 .. mask_{F-1}] (host memory, int32 bits).
int gp_fused_overlay_tick(const int32_t* idsaux, const int32_t* pw,
                          const int32_t* intro, const int32_t* host,
                          int32_t* ids_o, int32_t* hb_o, int32_t* ts_o,
                          int32_t* ctr, int n, int k, int f, int t_remove,
                          int churn_lo, int churn_span, void* stream) {
  if (k < 1 || k > MAX_K || f < 0 || f > MAX_F)
    return static_cast<int>(cudaErrorInvalidValue);
  K3Args a;
  a.t = host[0];
  a.s = make_sched((uint32_t)host[1], host[2], host[3], host[4], host[5],
                   (uint32_t)host[6], host[7], churn_lo, churn_span, t_remove);
  for (int i = 0; i < MAX_F; ++i) a.masks[i] = i < f ? host[8 + i] : 0;
  const int blocks = (n + WARPS - 1) / WARPS;
  fused_overlay_tick_kernel<<<blocks, WARPS * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      idsaux, pw, intro, a, ids_o, hb_o, ts_o, ctr, n, k, f);
  return static_cast<int>(cudaGetLastError());
}

// K4.  st (N, 2K+16) is updated in place over s_ticks ticks; wiped is a
// plane of the same shape (scratch), met i32[S, 128] and q (S*K words,
// scratch) are zeroed here.  sp is K4's scalar vector in host memory.
int gp_mega_overlay_ticks(int32_t* st, int32_t* wiped, int32_t* met,
                          int32_t* q, const int32_t* sp, int n, int k, int f,
                          int s_ticks, int t_remove, int churn_lo,
                          int churn_span, int can_rejoin, int powerlaw,
                          void* stream_ptr) {
  if (k < 1 || 2 * k + AUX_LANES > MAX_K || f < 1 || f > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int w = 2 * k + AUX_LANES;
  cudaError_t err = cudaMemsetAsync(
      met, 0, sizeof(int32_t) * (size_t)s_ticks * MET_COLS, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(q, 0, sizeof(int32_t) * (size_t)s_ticks * k, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  K4Args a;
  a.s = make_sched((uint32_t)sp[SP_SEED], sp[SP_VLO], sp[SP_VHI],
                   sp[SP_FTICK], sp[SP_RAFTER], (uint32_t)sp[SP_CTHR],
                   sp[SP_CAFTER], churn_lo, churn_span, t_remove);
  a.fail0 = sp[SP_FAIL0];
  a.rejoin0 = sp[SP_REJOIN0];
  a.drop_on = sp[SP_DROP_ON] > 0;
  a.drop_open = sp[SP_DROP_OPEN];
  a.drop_close = sp[SP_DROP_CLOSE];
  a.drop_thr = (uint32_t)sp[SP_DROP_THR];
  a.can_rejoin = can_rejoin;
  a.powerlaw = powerlaw;
  const int blocks = (n + WARPS - 1) / WARPS;
  for (int s = 0; s < s_ticks; ++s) {
    a.t = sp[SP_T0] + s;
    for (int i = 0; i < MAX_F; ++i)
      a.masks[i] = i < f ? sp[SP_NSCALARS + s * f + i] : 0;
    uint32_t* qs = reinterpret_cast<uint32_t*>(q) + (size_t)s * k;
    int32_t* ms = met + (size_t)s * MET_COLS;
    mega_prep_kernel<<<blocks, WARPS * 32, 0, stream>>>(st, wiped, qs, ms, a,
                                                        n, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    mega_row_kernel<<<blocks, WARPS * 32, 0, stream>>>(st, wiped, qs, ms, a,
                                                       n, k, f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  (void)w;
  return static_cast<int>(cudaGetLastError());
}

// K5.  plane (B, N, 128; lane l at plane + l * plane_lane words), boot (B, 8,
// 128) and sp (B, sp_len) on the device; plane2 (B, 2, N, 128), met (B, S,
// 128) and q (B, S+1, K; scratch) are written here (met zeroed, q zeroed
// with the boot aggregate in its slot 0).  One launch a tick on one
// stream: the stream order is the barrier between ticks.  flags: FL_RAMP |
// FL_CHURN | FL_JOIN | FL_DROP, the launch's live phases.
int gp_grid_overlay_ticks(const int32_t* plane, long long plane_lane,
                          const int32_t* boot, const int32_t* sp,
                          int32_t* plane2, int32_t* met, int32_t* q, int n,
                          int k, int f, int s_ticks, int batch, int sp_len,
                          int t_remove, int churn_lo, int churn_span,
                          int can_rejoin, int churn_mode, int powerlaw,
                          int flags, void* stream_ptr) {
  if (k < 1 || 2 * k > PLANE_W || f < 1 || f > 8 || n < WARPS ||
      n % WARPS != 0 || s_ticks < 1 || batch < 1 || batch > 65535 ||
      flags < 0 || flags > 15 ||
      (batch > 1 && plane_lane < (long long)n * PLANE_W))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaMemsetAsync(
      met, 0, sizeof(int32_t) * (size_t)batch * s_ticks * MET_COLS, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t q_lane = (size_t)(s_ticks + 1) * k;
  err = cudaMemsetAsync(q, 0, sizeof(int32_t) * batch * q_lane, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpy2DAsync(q, sizeof(int32_t) * q_lane, boot + PLANE_W,
                          sizeof(int32_t) * 8 * PLANE_W, sizeof(int32_t) * k,
                          batch, cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  K5Args a;
  a.n = n;
  a.k = k;
  a.f = f;
  a.s_ticks = s_ticks;
  a.sp_len = sp_len;
  a.t_remove = t_remove;
  a.churn_lo = churn_lo;
  a.churn_span = churn_span;
  a.can_rejoin = can_rejoin;
  a.churn_mode = churn_mode;
  a.powerlaw = powerlaw;
  a.out_lane = 2 * (size_t)n * PLANE_W;
  a.q_lane = q_lane;
  const size_t words = (size_t)n * PLANE_W;
  const dim3 grid(n / WARPS, batch);
  uint32_t* qu = reinterpret_cast<uint32_t*>(q);
  for (int s = 0; s < s_ticks; ++s) {
    a.s = s;
    // the input plane and the boot row at s = 0; after that phase s % 2,
    // whose introducer row is the broadcast row
    const int32_t* in = s == 0 ? plane : plane2 + (size_t)(s % 2) * words;
    a.in_lane = s == 0 ? (size_t)plane_lane : a.out_lane;
    const int32_t* bc = s == 0 ? boot : in + (size_t)INTRODUCER * PLANE_W;
    a.bc_lane = s == 0 ? (size_t)8 * PLANE_W : a.in_lane;
    kGridKernels[flags]<<<grid, WARPS * 32, 0, stream>>>(
        in, bc, qu + (size_t)s * k, plane2 + (size_t)(1 - s % 2) * words,
        met, sp, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
