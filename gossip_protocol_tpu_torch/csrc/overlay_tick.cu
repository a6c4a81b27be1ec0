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
//                          ticks on one (N, 2K+16) state plane, as one
//                          cooperative persistent launch.
//   gp_grid_overlay_ticks  K5, gossip_protocol_tpu/ops/pallas/
//                          overlay_grid.py grid_overlay_ticks: S whole
//                          ticks at any power-of-two N up to 2^20 on a
//                          ping-pong (B, 2, N, 128) plane, for B fleet
//                          lanes, one launch a tick.
//   gp_grid_boot           K5's boot pre-pass: the boot JOINREQ
//                          aggregate of a launch whose plane no K5
//                          launch of the run produced.
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
//   (0.018 ms).  The TPU folded the high mask bits into its block index
//   map and ran a butterfly in VMEM for the low ones; here a partner row
//   r ^ m is a direct, coalesced global load.  Design: one warp a row,
//   each lane owning slots lane, lane+32, ...; a row waits on two
//   dependent round trips, not 1 + 2F: its own words beside the F
//   partners' round flags (lane fi loads partner fi's), then every flagged
//   partner's view, four at a time, before any of them is merged; the
//   counters are warp reductions, no atomics.
// * K4 on the TPU held the whole plane in VMEM for 16 ticks.  At N=4096
//   the plane is 1.8 MB, above one SM's 227 KB of shared memory, and the
//   plane with its frozen wiped copy (3.7 MB) would take almost all of a
//   16-CTA cluster's 3.7 MB of distributed shared memory, so it stays in
//   HBM/L2 (where it fits whole).  A call is one cooperative launch of a
//   persistent grid (as many blocks as fit, capped by the 8-row groups),
//   one warp a row and one grid barrier a tick: the wiped copy (the tick's
//   frozen send payload, with its churn wipe) is kept twice, by tick
//   parity, and the warp that runs a row's tick s against one copy (the
//   shared row pipeline: its own view beside the F partners' send flags in
//   one round trip, then the flagged partners' views together, as K3; send
//   flags; the re-slot on the last tick of a slot epoch) writes the row
//   with tick s + 1's wipe into the other and adds its JOINREQ to tick
//   s + 1's per-slot atomicMax aggregate.  Metric sums stay in registers
//   and are added once a block and tick; met and the aggregates are zeroed
//   in the launch, and the S x F XOR masks ride in the argument struct.
//   At N=4096 a tick is latency-bound (a row's two dependent round trips
//   and the barrier), not bytes-bound.
// * K5 on the TPU relied on its sequential grid order: every block of tick
//   s was committed before tick s+1 read, the next tick's JOINREQ aggregate
//   and the introducer's broadcast row revolved through scratch.  Here each
//   tick is one launch on one stream (the stream order is the barrier),
//   reading one phase of the plane and writing the other; the broadcast
//   row is the input phase's introducer row, and tick s+1's aggregate is
//   an atomicMax into a per-lane (S+1, K) buffer, whose last slot (tick
//   t0+S's) the caller carries to the next launch.
//   Per tick it reads and writes the 512-byte row of every peer plus the
//   row of every partner that sends to it, so at N=2^20 bytes bound it
//   (1.07 GB a tick, about 2 GB with the partner rows of the power-law
//   run).  Measured on an H100, though, the instructions a row costs
//   bound it: a persistent grid whose warps each run a three-stage
//   cp.async pipeline over their rows (own row and partner flags, then the
//   flagged partners' rows, then the merge from shared memory) keeps the
//   loads in flight (the loads alone take under half of a call at 2^20:
//   the K5_VARIANT builds below), so the design spends its effort on the
//   row's instructions: decisions carried between stages, the degree as one
//   ballot, remainders by multiply (FastMod), the epoch re-slot by 64-bit
//   shared-memory atomicMax, and the metric sums in registers, added to
//   `met` once a block and tick.  The four phase flags are template
//   parameters, so a steady-state launch carries none of the ramp, churn,
//   join or drop work.  A run's first launch at t0 > 0, which has no
//   carried aggregate, takes it from a pre-pass kernel, gp_grid_boot: one
//   word read from every 512-byte row, so its 32-byte sector loads bound
//   it.

#include <cooperative_groups.h>
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

// x % d for a divisor fixed per launch by one 64-bit multiply instead of an
// integer division (Lemire, Kaser and Kurz, "Faster remainder by direct
// computation", 2019): exact for every 32-bit x and every d >= 1.
struct FastMod {
  uint32_t d;
  uint64_t m;
};
__host__ __device__ inline FastMod make_fastmod(uint32_t d) {
  FastMod f;
  f.d = d;
  f.m = ~(uint64_t)0 / d + 1;
  return f;
}
__device__ __forceinline__ uint32_t fastmod(uint32_t x, const FastMod& f) {
  return (uint32_t)__umul64hi(f.m * x, f.d);
}
__device__ __forceinline__ int slot_of(uint32_t seed, uint32_t ep, int32_t id,
                                       const FastMod& km) {
  return (int)fastmod(mix32(seed, ep, (uint32_t)id, SALT_SLOT), km);
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
      churn_lo, t_remove;
  FastMod churn_span;
};

// (fail, rejoin) ticks of one subject id, closed form.
__device__ __forceinline__ void fail_rejoin_of(const Sched& s, int32_t subj,
                                               int32_t& fail,
                                               int32_t& rejoin) {
  const uint32_t su = (uint32_t)subj;
  if (s.churn_thr > 0u) {
    const bool churned =
        mix32(s.seed, su, SALT_CHURN) < s.churn_thr && subj != INTRODUCER;
    fail = churned ? s.churn_lo + (int32_t)fastmod(
                                      mix32(s.seed, su, SALT_CHURN_TICK),
                                      s.churn_span)
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
// NS is the number of slots a lane owns (K <= 32 NS): K5 (2K <= 128) and K3
// at K <= 64 take NS = 2, which halves the registers of every array below.
template <int NS = SPL>
struct RowAcc {
  uint32_t km[NS];
  int32_t pa[NS];
  int32_t id0[NS];
};

// A view row in registers: this lane's slots of ids and payload words.
template <int NS = SPL>
struct ViewRegs {
  int32_t ids[NS];
  int32_t pw[NS];
};

// Load a view row (ids at ids[j], payload words at pw[j]); ``pw_mask``
// strips K5's aux bytes from its payload lanes.
template <int NS>
__device__ __forceinline__ void load_view(ViewRegs<NS>& v, const int32_t* ids,
                                          const int32_t* pw, int k, int lane,
                                          int32_t pw_mask = -1) {
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) {
    const int j = lane + 32 * jj;
    v.ids[jj] = j < k ? ids[j] : -1;
    v.pw[jj] = j < k ? pw[j] & pw_mask : 0;
  }
}

template <int NS>
__device__ __forceinline__ void clear_view(ViewRegs<NS>& v) {
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) { v.ids[jj] = -1; v.pw[jj] = 0; }
}

template <int NS>
__device__ __forceinline__ void acc_init(RowAcc<NS>& r, const ViewRegs<NS>& v) {
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) {
    const int32_t id = v.ids[jj];
    const int32_t p = id >= 0 ? v.pw[jj] : 0;
    r.id0[jj] = id;
    r.km[jj] = id >= 0 ? pack_key(id, (p >> 12) - 1) : 0u;
    r.pa[jj] = p;
  }
}

// Merge an identically-slotted incoming view (a partner's table or the
// introducer's JOINREP broadcast); an invalid candidate is (0, 0).
template <int NS>
__device__ __forceinline__ void merge_view(RowAcc<NS>& r,
                                           const ViewRegs<NS>& v, bool ok,
                                           int32_t row, int32_t t,
                                           int32_t t_remove, int k, int lane) {
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) {
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
template <int NS>
__device__ __forceinline__ void merge_entry_at(RowAcc<NS>& r, int sl,
                                               int32_t subj, int32_t e_ts,
                                               int32_t e_hb, bool ok, int k,
                                               int lane) {
  const uint32_t key = ok ? pack_key(subj, e_ts) : 0u;
  const int32_t p = ok ? pack_th(e_ts, e_hb) : 0;
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) {
    const int j = lane + 32 * jj;
    if (j >= k) continue;
    const bool m = j == sl;
    lex(r.km[jj], r.pa[jj], m ? key : 0u, m ? p : 0);
  }
}
template <int NS>
__device__ __forceinline__ void merge_entry(RowAcc<NS>& r, int32_t subj,
                                            int32_t e_ts, int32_t e_hb, bool ok,
                                            uint32_t seed, uint32_t ep, int k,
                                            int lane) {
  merge_entry_at(r, slot_of(seed, ep, subj, k), subj, e_ts, e_hb, ok, k,
                 lane);
}
template <int NS>
__device__ __forceinline__ void merge_entry(RowAcc<NS>& r, int32_t subj,
                                            int32_t e_ts, int32_t e_hb, bool ok,
                                            uint32_t seed, uint32_t ep,
                                            const FastMod& km, int lane) {
  merge_entry_at(r, slot_of(seed, ep, subj, km), subj, e_ts, e_hb, ok,
                 (int)km.d, lane);
}

// JOINREQ aggregate (per-slot key and payload) into the introducer's row.
template <int NS>
__device__ __forceinline__ void merge_joinreq(RowAcc<NS>& r, bool is_r0,
                                              const uint32_t* q_kf,
                                              const int32_t* q_pf, int32_t t,
                                              int k, int lane) {
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) {
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

template <int NS = SPL>
struct RowOut {
  int32_t ids[NS], hb[NS], ts[NS];
  int removals, false_removals, victims, adds, view;
};

// Winner extraction, TREMOVE staleness detection, and this lane's share of
// the per-row counters.  ``kSubjects`` false: no subject is inside its fail
// window (K5's churn-dead launches), so the subject schedule is skipped.
template <bool kSubjects = true, int NS>
__device__ __forceinline__ void extract_detect(const RowAcc<NS>& r, bool ops,
                                               int32_t t, const Sched& s,
                                               int k, int lane,
                                               RowOut<NS>& o) {
  o.removals = o.false_removals = o.victims = o.adds = o.view = 0;
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) {
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
// The sharded contract (one shard of a peer-sharded run, n = Nl rows): the
// global masks name the partners, the local masks m % Nl index the round
// planes aux[f] / pwr[f] (the planes of shard s ^ (m / Nl), routed by the
// comm), and row_start is the global id of local row 0.
struct K3Args {
  Sched s;
  int32_t t;
  int32_t masks[MAX_F];
  int32_t masks_local[MAX_F];
  int32_t row_start;
  const int32_t* aux[MAX_F];
  const int32_t* pwr[MAX_F];
};

// Partner rows a K3 row loads before it merges them (bounds the registers
// of the views in flight: 4 x 2 NS words a lane).
constexpr int K3_CHUNK = 4;

// One warp a row.  The row waits on two dependent round trips, not 1 + 2F:
// (1) its own ids, pw and bits beside the F partners' round flags (lane fi
// loads partner fi's), then (2) the views of every flagged partner, up to
// K3_CHUNK at once, before any of them is merged.  Rounds merge in their
// order, and a round whose flag is off merges nothing, as before.  SH:
// the sharded contract (K3Args); without it the partners are rows of
// idsaux / pw and the global id is the row.
template <int NS, bool SH>
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
  const int32_t grow = SH ? a.row_start + row : row;   // global id
  const int w = k + 2 + f;
  const int32_t t = a.t;
  const uint32_t ep = (uint32_t)(t / SLOT_EPOCH);
  const FastMod km = make_fastmod((uint32_t)k);
  const int32_t* my = idsaux + (size_t)row * w;
  // lane fi holds round fi's mask: static indices keep the argument struct
  // in the parameter bank (a dynamic index copies it to local memory)
  int32_t my_mask = 0, my_lo = 0;
  const int32_t* my_aux = idsaux;
  const int32_t* my_pw = pw;
#pragma unroll
  for (int i = 0; i < MAX_F; ++i)
    if (lane == i) {
      my_mask = a.masks[i];
      if (SH) {
        my_lo = a.masks_local[i];
        my_aux = a.aux[i];
        my_pw = a.pwr[i];
      }
    }
  if (!SH) my_lo = my_mask;
  int32_t flag = 0;
  if (lane < f) flag = my_aux[(size_t)(row ^ my_lo) * w + k + 2 + lane];
  const int32_t bits = my[k + 1];
  ViewRegs<NS> own;
  load_view(own, my, pw + (size_t)row * k, k, lane);
  const bool proc = bits & 1, ops = bits & 2, jrep = bits & 4;
  const uint32_t sent =
      proc ? __ballot_sync(0xffffffffu, lane < f && flag > 0) : 0u;
  RowAcc<NS> r;
  acc_init(r, own);
  for (int base = 0; base < f; base += K3_CHUNK) {
    ViewRegs<NS> pv[K3_CHUNK];
    int32_t phb[K3_CHUNK];
#pragma unroll
    for (int c = 0; c < K3_CHUNK; ++c) {
      const int fi = base + c;
      const int32_t lo = __shfl_sync(0xffffffffu, my_lo, fi & 31);
      const int32_t* src = idsaux;
      const int32_t* srcp = pw;
      if (SH) {
        src = reinterpret_cast<const int32_t*>(__shfl_sync(
            0xffffffffu, reinterpret_cast<unsigned long long>(my_aux),
            fi & 31));
        srcp = reinterpret_cast<const int32_t*>(__shfl_sync(
            0xffffffffu, reinterpret_cast<unsigned long long>(my_pw),
            fi & 31));
      }
      if (fi < f && (sent >> fi & 1u)) {
        const size_t partner = (size_t)(row ^ lo);
        load_view(pv[c], src + partner * w, srcp + partner * k, k, lane);
        phb[c] = src[partner * w + k];
      }
    }
#pragma unroll
    for (int c = 0; c < K3_CHUNK; ++c) {
      const int fi = base + c;
      if (!(fi < f && (sent >> fi & 1u))) continue;
      merge_view(r, pv[c], true, grow, t, a.s.t_remove, k, lane);
      if (a.s.t_remove > 1)
        merge_entry(r, grow ^ __shfl_sync(0xffffffffu, my_mask, fi), t - 1,
                    phb[c], true, a.s.seed, ep, km, lane);
    }
  }
  const int recv = __popc(sent);
  ViewRegs<NS> iv;
  if (jrep) load_view(iv, intro, intro + k, k, lane);
  merge_view(r, iv, jrep, grow, t, a.s.t_remove, k, lane);
  if (a.s.t_remove > 1)
    merge_entry(r, INTRODUCER, t - 1, intro[2 * k],
                jrep && grow != INTRODUCER, a.s.seed, ep, km, lane);
  merge_joinreq(r, grow == INTRODUCER,
                reinterpret_cast<const uint32_t*>(intro + 3 * k), intro + 4 * k,
                t, k, lane);
  RowOut<NS> o;
  extract_detect(r, ops, t, a.s, k, lane, o);
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) {
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
constexpr int K4_MAX_TICKS = 16;   // ticks a launch (one slot epoch)
constexpr int K4_MAX_F = 8;
constexpr int K4_NS = 2;           // slots a lane (K <= 56: 2K + 16 <= 128)

struct K4Args {
  Sched s;
  int32_t t0, fail0, rejoin0, drop_open, drop_close;
  uint32_t drop_thr;
  int drop_on, can_rejoin, powerlaw, n, k, f, s_ticks;
  int32_t* st;       // (N, 2K+16) plane, in and out
  int32_t* wiped;    // two planes: tick s reads plane s % 2, writes the other
  int32_t* met;      // (S, MET_COLS), zeroed in the launch
  uint32_t* q;       // (S, K) JOINREQ aggregates, zeroed in the launch
  int32_t masks[K4_MAX_TICKS * K4_MAX_F];   // tick s, round fi: s F + fi
};

// Sum NW per-warp values of each metric across the block and add the
// block's totals to met (integer atomics: exact in any order).
template <int NW = WARPS>
__device__ __forceinline__ void block_metrics(const int (&v)[MET_USED],
                                              int32_t* met) {
  __shared__ int part[NW][MET_USED];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < MET_USED; ++i) part[warp][i] = v[i];
  __syncthreads();
  if (threadIdx.x < MET_USED) {
    int sum = 0;
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) sum += part[wi][threadIdx.x];
    if (sum) atomicAdd(met + threadIdx.x, sum);
  }
}

// Row `row`'s JOINREQ at tick t: whether the introducer consumes it, and
// its key at its slot of the introducer's aggregate q_kf.
__device__ __forceinline__ int joinreq_at(const K4Args& a, int32_t t,
                                          bool joinreq, uint32_t* q_kf,
                                          int row, int lane) {
  const bool failed0 = t > a.fail0 && t <= a.rejoin0;
  const int jreq = joinreq && t > 0 && !failed0;
  if (lane == 0 && jreq && row != INTRODUCER)
    atomicMax(q_kf + slot_of(a.s.seed, (uint32_t)(t / SLOT_EPOCH), row, a.k),
              pack_key(row, t));
  return jreq;
}

// The launch's first tick t0, one row: the plane's row with the churn wipe
// of t0 (a row rejoining then loses its view, in_group and own_hb) into
// wiped plane 0, its schedule lanes into plane 1, and its JOINREQ.
__device__ __forceinline__ int mega_boot_row(const K4Args& a, int row,
                                             int lane) {
  const int k = a.k, aa = 2 * k, w = aa + AUX_LANES;
  const int32_t t = a.t0;
  const int32_t* src = a.st + (size_t)row * w;
  int32_t* dst = a.wiped + (size_t)row * w;
  const bool rejoining = a.can_rejoin && t == src[aa + L_REJOIN];
  for (int j = lane; j < w; j += 32) {
    int32_t v = src[j];
    if (rejoining && j < aa + L_JOINREQ) v = j < k ? -1 : 0;
    dst[j] = v;
    if (j >= aa + L_START) dst[(size_t)a.n * w + j] = v;
  }
  return joinreq_at(a, t, src[aa + L_JOINREQ] > 0, a.q, row, lane);
}

// Re-slot one row into the next epoch's slot map (lexicographic max over
// the entries that land in each slot), in registers.
template <int NS>
__device__ __forceinline__ void reslot_row(int32_t (&ids)[NS],
                                           int32_t (&pwv)[NS], uint32_t seed,
                                           uint32_t ep, int k, int lane) {
  int tgt[NS];
  uint32_t key[NS];
  int32_t p[NS];
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) {
    const int j = lane + 32 * jj;
    tgt[jj] = j < k ? slot_of(seed, ep, ids[jj], k) : -1;
    key[jj] = (j < k && ids[jj] >= 0) ? pack_key(ids[jj], (pwv[jj] >> 12) - 1)
                                      : 0u;
    p[jj] = (j < k && ids[jj] >= 0) ? pwv[jj] : 0;
  }
  uint32_t kf[NS];
  int32_t pf[NS];
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) { kf[jj] = 0u; pf[jj] = 0; }
#pragma unroll
  for (int sj = 0; sj < NS; ++sj) {
    if (32 * sj >= k) break;
    for (int src = 0; src < 32; ++src) {
      const int tg = __shfl_sync(0xffffffffu, tgt[sj], src);
      const uint32_t ky = __shfl_sync(0xffffffffu, key[sj], src);
      const int32_t pv = __shfl_sync(0xffffffffu, p[sj], src);
      if (ky == 0u) continue;
#pragma unroll
      for (int jj = 0; jj < NS; ++jj)
        if (tg == lane + 32 * jj) lex(kf[jj], pf[jj], ky, pv);
    }
  }
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) {
    ids[jj] = kf[jj] > 0u ? (int32_t)(kf[jj] & ID_MASK) : -1;
    pwv[jj] = kf[jj] > 0u ? max(pf[jj], 0) : 0;
  }
}

// reslot_row through a warp's 64-entry scratch in shared memory (K <= 64):
// each entry lands by one 64-bit atomicMax of (key << 32 | payload), the
// same lexicographic maximum (payloads are non-negative), instead of 32 K
// shuffle rounds.  `scr` is 16-byte aligned and not read by other warps.
template <int NS>
__device__ __forceinline__ void reslot_row_smem(int32_t (&ids)[NS],
                                                int32_t (&pwv)[NS],
                                                unsigned long long* scr,
                                                uint32_t seed, uint32_t ep,
                                                const FastMod& km, int lane) {
  const int k = (int)km.d;
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) scr[lane + 32 * jj] = 0ull;
  __syncwarp();
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) {
    const int j = lane + 32 * jj;
    if (j < k && ids[jj] >= 0)
      atomicMax(scr + slot_of(seed, ep, ids[jj], km),
                (unsigned long long)pack_key(ids[jj], (pwv[jj] >> 12) - 1)
                        << 32 |
                    (uint32_t)pwv[jj]);
  }
  __syncwarp();
#pragma unroll
  for (int jj = 0; jj < NS; ++jj) {
    const unsigned long long e = scr[lane + 32 * jj];
    const uint32_t kf = (uint32_t)(e >> 32);
    ids[jj] = kf > 0u ? (int32_t)(kf & ID_MASK) : -1;
    pwv[jj] = kf > 0u ? max((int32_t)(uint32_t)e, 0) : 0;
  }
}

// Tick s of one row against wiped plane s % 2 (the plane after tick s - 1
// with tick s's churn wipe); adds the row's metrics to v (lane 0's count).
// The new row goes, with tick s + 1's wipe, into the other wiped plane,
// and its JOINREQ into tick s + 1's aggregate and count (vn); after the
// last tick it goes to st.  masks: the tick's F masks.
__device__ __forceinline__ void mega_row(const K4Args& a, int s,
                                         const int32_t* masks, int row,
                                         int lane, int (&v)[MET_USED],
                                         int (&vn)[MET_USED]) {
  const int k = a.k, f = a.f, aa = 2 * k, w = aa + AUX_LANES;
  const int32_t t = a.t0 + s;
  const size_t plane = (size_t)a.n * w;
  const int32_t* wiped = a.wiped + (s & 1) * plane;
  const uint32_t* q_kf = a.q + (size_t)s * k;
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
  // merges, in two dependent round trips as K3's: the row's own view
  // beside the F partners' send flags (lane fi loads partner fi's), then
  // every flagged partner's view, K3_CHUNK at once, and the introducer's
  const int32_t my_mask = lane < f ? masks[lane] : 0;
  int32_t flag = 0;
  if (lane < f) flag = wiped[(size_t)(row ^ my_mask) * w + aa + L_SF + lane];
  RowAcc<K4_NS> r;
  ViewRegs<K4_NS> own;
  load_view(own, W, W + k, k, lane);
  const uint32_t sent =
      proc ? __ballot_sync(0xffffffffu, lane < f && flag > 0) : 0u;
  const int32_t* B = wiped;   // the introducer's row (JOINREP source)
  ViewRegs<K4_NS> bv;
  if (jrep) load_view(bv, B, B + k, k, lane);
  acc_init(r, own);
  for (int base = 0; base < f; base += K3_CHUNK) {
    ViewRegs<K4_NS> pv[K3_CHUNK];
    int32_t phb[K3_CHUNK];
#pragma unroll
    for (int c = 0; c < K3_CHUNK; ++c) {
      const int fi = base + c;
      const int32_t mask = __shfl_sync(0xffffffffu, my_mask, fi & 31);
      if (fi < f && (sent >> fi & 1u)) {
        const int32_t* P = wiped + (size_t)(row ^ mask) * w;
        load_view(pv[c], P, P + k, k, lane);
        phb[c] = P[aa + L_OWN_HB];
      }
    }
#pragma unroll
    for (int c = 0; c < K3_CHUNK; ++c) {
      const int fi = base + c;
      if (!(fi < f && (sent >> fi & 1u))) continue;
      merge_view(r, pv[c], true, row, t, a.s.t_remove, k, lane);
      if (a.s.t_remove > 1)
        merge_entry(r, row ^ __shfl_sync(0xffffffffu, my_mask, fi), t - 1,
                    phb[c], true, a.s.seed, ep, k, lane);
    }
  }
  const int recv = __popc(sent);
  merge_view(r, bv, jrep, row, t, a.s.t_remove, k, lane);
  if (a.s.t_remove > 1)
    merge_entry(r, INTRODUCER, t - 1, B[aa + L_OWN_HB],
                jrep && row != INTRODUCER, a.s.seed, ep, k, lane);
  merge_joinreq(r, row == INTRODUCER, q_kf, nullptr, t, k, lane);
  RowOut<K4_NS> o;
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
    v[MET_IN_GROUP] += in_group;
    v[MET_VIEW] += view;
    v[MET_ADDS] += adds;
    v[MET_REMOVALS] += rem;
    v[MET_FALSE_REMOVALS] += frem;
    v[MET_VICTIM] += vic;
    v[MET_SENT] += n_sf + joinreq_sent + joinrep_sent;
    v[MET_RECV] += recv + jrep;
  }
  // the end-of-tick row, re-slotted on the last tick of an epoch
  int32_t pwv[K4_NS];
#pragma unroll
  for (int jj = 0; jj < K4_NS; ++jj)
    pwv[jj] = o.ids[jj] >= 0 ? pack_th(o.ts[jj], o.hb[jj]) : 0;
  if ((t + 1) % SLOT_EPOCH == 0)
    reslot_row(o.ids, pwv, a.s.seed, (uint32_t)((t + 1) / SLOT_EPOCH), k,
               lane);
  // the next tick's wipe (a row rejoining at t + 1 loses its view,
  // in_group and own_hb)
  const bool last = s + 1 == a.s_ticks;
  const bool wipe = !last && a.can_rejoin && t + 1 == rejoin;
  int32_t* D = last ? a.st + (size_t)row * w
                    : a.wiped + ((s + 1) & 1) * plane + (size_t)row * w;
#pragma unroll
  for (int jj = 0; jj < K4_NS; ++jj) {
    const int j = lane + 32 * jj;
    if (j >= k) continue;
    D[j] = wipe ? -1 : o.ids[jj];
    D[k + j] = wipe ? 0 : pwv[jj];
  }
  if (lane < L_START) {
    int32_t x;
    if (lane == L_IN_GROUP) x = wipe ? 0 : in_group;
    else if (lane == L_OWN_HB) x = wipe ? 0 : own_hb;
    else if (lane == L_JOINREQ) x = joinreq_next;
    else if (lane == L_JOINREP) x = joinrep_next;
    else x = (sf_bits >> (lane - L_SF)) & 1;
    D[aa + lane] = x;
  }
  if (!last) {
    const int jreq1 = joinreq_at(a, t + 1, joinreq_next,
                                 a.q + (size_t)(s + 1) * k, row, lane);
    if (lane == 0) vn[MET_RECV] += jreq1;   // JOINREQs consumed at t + 1
  }
}

// K4: S whole ticks, one persistent grid; each phase strides its 8-row
// groups (a warp a row) over the blocks, metric sums kept in registers
// and added once a block and phase.  A row's next-tick wipe and JOINREQ are
// its own, so the warp that computes tick s of a row also prepares its
// tick s + 1 (two wiped planes, by tick parity): one grid barrier a tick,
// plus one after the zeroing and one after the first tick's wipe.
__global__ void __launch_bounds__(WARPS * 32)
mega_overlay_kernel(const __grid_constant__ K4Args a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ int32_t masks_s[K4_MAX_TICKS * K4_MAX_F];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (a.n + WARPS - 1) / WARPS;
  // constant indices only: a dynamic index into the argument struct would
  // copy it to local memory
  if (threadIdx.x == 0)
#pragma unroll
    for (int i = 0; i < K4_MAX_TICKS * K4_MAX_F; ++i) masks_s[i] = a.masks[i];
  const int zero = a.s_ticks * (MET_COLS + a.k);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < zero;
       i += gridDim.x * blockDim.x) {
    if (i < a.s_ticks * MET_COLS) a.met[i] = 0;
    else a.q[i - a.s_ticks * MET_COLS] = 0u;
  }
  grid.sync();
  int v[MET_USED] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int row = g * WARPS + warp;
    if (row < a.n) {
      const int jreq = mega_boot_row(a, row, lane);
      if (lane == 0) v[MET_RECV] += jreq;   // JOINREQs consumed at t0
    }
  }
  block_metrics(v, a.met);
  grid.sync();
  for (int s = 0; s < a.s_ticks; ++s) {
    int vn[MET_USED] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < MET_USED; ++i) v[i] = 0;
    for (int g = blockIdx.x; g < groups; g += gridDim.x) {
      const int row = g * WARPS + warp;
      if (row < a.n) mega_row(a, s, masks_s + s * a.f, row, lane, v, vn);
    }
    block_metrics(v, a.met + (size_t)s * MET_COLS);
    if (s + 1 == a.s_ticks) break;
    __syncthreads();   // block_metrics' partial sums are read
    block_metrics(vn, a.met + (size_t)(s + 1) * MET_COLS);
    grid.sync();
  }
}

// ---- K5 -------------------------------------------------------------------
// The plane: row r of a lane is PLANE_W words: lanes [0, K) ids, [K, 2K) the
// 24-bit payload words with the aux bytes in the high byte of payload lanes
// 0-2 (own_hb low 8 bits; own_hb bits 8-11 | in_group << 4 | joinreq << 5 |
// joinrep << 6; the F send-flag bits), the rest zero.  The boot JOINREQ
// aggregate is K words a lane (ops/cuda/overlay_grid.py).
constexpr int PLANE_W = 128;
constexpr int32_t PW_MASK = 0x00FFFFFF;
enum { GSP_T0 = 0, GSP_SEED, GSP_VLO, GSP_VHI, GSP_FTICK, GSP_RAFTER,
       GSP_CTHR, GSP_CAFTER, GSP_DROP_ON, GSP_DROP_OPEN, GSP_DROP_CLOSE,
       GSP_DROP_THR, GSP_FAIL0, GSP_REJOIN0, GSP_STEP_NUM, GSP_STEP_DEN,
       GSP_NSCALARS };
enum { FL_RAMP = 1, FL_CHURN = 2, FL_JOIN = 4, FL_DROP = 8 };
constexpr uint32_t SALT_DEGREE = 8;
// K5_VARIANT (a -D define; 0, the kernel as used) builds a measurement
// variant that chip_smoke.py times beside it and nothing else calls (both
// compute wrong results by design):
//   1  no partner row loaded: stage C merges what its partner stage holds
//      (the cost of the partner loads);
//   2  the loads alone: stage C neither merges nor writes.
#ifndef K5_VARIANT
#define K5_VARIANT 0
#endif
constexpr int K5_NS = 2;        // slots a lane (2K <= PLANE_W)
constexpr int K5_WARPS = 4;     // warps a block
constexpr int K5_MAX_F = 8;
// a warp's shared memory: 3 own-row stages, 3 stages of F flag words, 2
// stages of F partner rows (PLANE_W words a row)
constexpr int K5_OWN = 3, K5_PART = 2;
__host__ __device__ constexpr int k5_warp_words(int f) {
  return K5_OWN * PLANE_W + K5_OWN * K5_MAX_F + K5_PART * f * PLANE_W;
}

struct K5Args {
  int n, k, f, s_ticks, sp_len, t_remove, churn_lo, churn_span;
  int can_rejoin, churn_mode, powerlaw;
  int s;                  // this launch's tick within the call
  size_t in_lane, out_lane, q_lane;   // lane strides (words)
};

// ---- cp.async (sm_80+): global -> shared without registers ---------------
__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are pending, then make every
// lane's landed copies visible to the warp
template <int N>
__device__ __forceinline__ void cp_wait_warp() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  __syncwarp();
}
// words [0, 2K) of a plane row (16-byte chunks; rows are 512-byte aligned)
__device__ __forceinline__ void cp_row(int32_t* dst, const int32_t* src, int k,
                                       int lane) {
  for (int c = lane; c < (2 * k + 3) / 4; c += 32)
    cp_async16(dst + 4 * c, src + 4 * c);
}

// Whether `row` processes at tick t (its start ramp and fail window): a
// function of the row index and the schedule, no plane word.
template <bool RAMP, bool CHURN>
__device__ __forceinline__ bool k5_proc(const Sched& sc, const int32_t* P,
                                        int32_t row, int32_t t,
                                        bool& failed, bool& at_start,
                                        int32_t& rejoin) {
  int32_t fail = NEVER;
  rejoin = NEVER;
  if (CHURN) fail_rejoin_of(sc, row, fail, rejoin);
  failed = CHURN && t > fail && t <= rejoin;
  bool proc = !failed;
  at_start = false;
  if (RAMP) {   // division-free start ramp: t > i*num//den <=> i*num < t*den
    const int32_t ramp = (int32_t)((uint32_t)row * (uint32_t)P[GSP_STEP_NUM]);
    const int32_t lo = t * P[GSP_STEP_DEN];
    proc = ramp < lo && !failed;
    at_start = ramp >= lo && ramp < lo + P[GSP_STEP_DEN];
  }
  return proc;
}

// One tick of every row of every lane.  Reads `in` (the input plane at s =
// 0, else the previous tick's phase of plane2), writes `out` (the other
// phase), whose row INTRODUCER is the broadcast row; `q` holds the tick's
// JOINREQ aggregate (K words), and tick s+1's aggregate is atomicMax-ed into
// the K words after it.  The template flags elide the launch's dead phases
// (models/segments.py guarantees).
//
// A persistent grid (about as many blocks as fit on the card at once, per
// fleet lane blockIdx.y) whose warps loop over rows row0, row0 + stride, ...
// Each warp runs a three-stage pipeline over its rows through shared
// memory, so a row's dependent loads overlap the merges of the rows before
// it: at step i the warp
//   A issues row i+2's own words [0, 2K) and its F partners' send-flag
//     words (payload lane 2 of each partner row);
//   B reads row i+1's flags (landed) and issues the rows of the partners
//     whose send flag for the round is on (a degree-1 power-law row sends
//     one), compacted into its partner stage;
//   C merges row i from shared memory and writes it.
// The metric sums stay in lane 0's registers across all of a warp's rows;
// the block adds them to `met` once a tick (one set of atomics a block).
template <bool RAMP, bool CHURN, bool JOIN, bool DROP>
__global__ void __launch_bounds__(K5_WARPS * 32)
grid_tick_kernel(const int32_t* __restrict__ in, uint32_t* __restrict__ q,
                 int32_t* __restrict__ out,
                 int32_t* __restrict__ met,
                 const int32_t* __restrict__ sp, K5Args a) {
  extern __shared__ __align__(16) int32_t k5_smem[];
  constexpr int NS = K5_NS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
  sc.churn_span = make_fastmod((uint32_t)a.churn_span);
  sc.t_remove = a.t_remove;
  const int32_t* masks = P + GSP_NSCALARS + max(f - 1, 0) + a.s * f;
  const int32_t my_mask = lane < f ? masks[lane] : 0;   // lane fi: round fi
  in += b * a.in_lane;
  const int32_t* __restrict__ bc = in + (size_t)INTRODUCER * PLANE_W;
  q += b * a.q_lane;
  out += b * a.out_lane;
  met += ((size_t)b * a.s_ticks + a.s) * MET_COLS;
  const uint32_t ep = (uint32_t)(t / SLOT_EPOCH);
  const FastMod km = make_fastmod((uint32_t)k);
  const int32_t fail0 = P[GSP_FAIL0], rejoin0 = P[GSP_REJOIN0];
  const bool failed0 = CHURN && t > fail0 && t <= rejoin0;
  const bool proc0 = t > 0 && !failed0;
  const bool wipe = CHURN && a.can_rejoin;
  const bool active = DROP && P[GSP_DROP_ON] > 0 && t > P[GSP_DROP_OPEN] &&
                      t <= P[GSP_DROP_CLOSE];
  const uint32_t drop_thr = (uint32_t)P[GSP_DROP_THR];

  int32_t* ws = k5_smem + (size_t)warp * k5_warp_words(f);
  int32_t* own_st = ws;                                 // [3][PLANE_W]
  int32_t* flag_st = ws + K5_OWN * PLANE_W;             // [3][K5_MAX_F]
  int32_t* part_st = flag_st + K5_OWN * K5_MAX_F;       // [2][f][PLANE_W]
  const int stride = gridDim.x * K5_WARPS;
  const int row0 = blockIdx.x * K5_WARPS + warp;
  const int nrows = row0 < a.n ? (a.n - 1 - row0) / stride + 1 : 0;
  int v[MET_USED] = {0, 0, 0, 0, 0, 0, 0, 0};

  // round j's power-law degree threshold on lane j (a row's degree is one
  // ballot of its degree draw against them)
  const uint32_t my_thr =
      lane + 1 < f ? (uint32_t)P[GSP_NSCALARS + lane] : 0u;

  auto stage_a = [&](int i, int so) {   // own row + partner flag words
    if (i < nrows) {
      const int32_t row = row0 + i * stride;
      if (lane < f)
        cp_async4(flag_st + so * K5_MAX_F + lane,
                  in + (size_t)(row ^ my_mask) * PLANE_W + k + 2);
      cp_row(own_st + so * PLANE_W, in + (size_t)row * PLANE_W, k, lane);
    }
    cp_commit();
  };
  // flagged partner rows; the row's decisions (proc, failed, at_start and
  // its rejoin tick) are kept for stage C
  auto stage_b = [&](int i, int so, int sp_, uint32_t& dec,
                     int32_t& rejoin) -> uint32_t {
    uint32_t sent = 0u;
    if (i < nrows) {
      const int32_t row = row0 + i * stride;
      const uint32_t fw =
          lane < f ? (uint32_t)flag_st[so * K5_MAX_F + lane] >> 24 : 0u;
      sent = __ballot_sync(0xffffffffu, lane < f && ((fw >> lane) & 1u));
      bool failed, at_start;
      const bool proc =
          k5_proc<RAMP, CHURN>(sc, P, row, t, failed, at_start, rejoin);
      dec = (uint32_t)proc | (uint32_t)failed << 1 | (uint32_t)at_start << 2;
      if (!proc) sent = 0u;
      int32_t* dst = part_st + (size_t)sp_ * f * PLANE_W;
      for (uint32_t m = sent; m; m &= m - 1, dst += PLANE_W) {
        const int fi = __ffs(m) - 1;
        const int32_t partner = row ^ __shfl_sync(0xffffffffu, my_mask, fi);
        if (K5_VARIANT != 1)
          cp_row(dst, in + (size_t)partner * PLANE_W, k, lane);
      }
    }
    cp_commit();
    return sent;
  };

  // stage slots: own rows i, i+1, i+2 in s0, s1, s2; partner rows of i, i+1
  // in p0, 1 - p0
  int s0 = 0, s1 = 1, s2 = 2, p0 = 0;
  uint32_t sent_cur = 0u, dec_cur = 0u;
  int32_t rejoin_cur = NEVER;
  if (nrows > 0) {
    stage_a(0, s0);
    stage_a(1, s1);
    cp_wait_warp<1>();
    sent_cur = stage_b(0, s0, p0, dec_cur, rejoin_cur);
  }
  for (int i = 0; i < nrows; ++i) {
    stage_a(i + 2, s2);
    cp_wait_warp<2>();                  // row i+1's own words and flags
    uint32_t dec_next = 0u;
    int32_t rejoin_next = NEVER;
    const uint32_t sent_next =
        stage_b(i + 1, s1, 1 - p0, dec_next, rejoin_next);
    cp_wait_warp<2>();                  // row i's partner rows
    // ---- C: row i, from shared memory
    const int32_t row = row0 + i * stride;
    const int32_t* R = own_st + s0 * PLANE_W;
    if (K5_VARIANT == 2) v[MET_VIEW] += R[lane] + part_st[p0 * f * PLANE_W];
    if (K5_VARIANT != 2) {
    ViewRegs<NS> own;
    load_view(own, R, R + k, k, lane, PW_MASK);
    const uint32_t a0 = (uint32_t)R[k] >> 24, a1 = (uint32_t)R[k + 1] >> 24;
    int32_t own_hb0 = (int32_t)(a0 | ((a1 & 0xFu) << 8));
    bool in_group0 = a1 & 0x10u;
    const bool joinreq0 = JOIN && (a1 & 0x20u);
    const bool joinrep0 = JOIN && (a1 & 0x40u);
    const bool proc = dec_cur & 1u, failed = dec_cur & 2u,
               at_start = dec_cur & 4u;
    const int32_t rejoin = rejoin_cur;
    const bool rejoining = wipe && t == rejoin;
    if (rejoining) {
      clear_view(own);
      in_group0 = false;
      own_hb0 = 0;
    }
    const bool starting = at_start || rejoining;
    const bool jrep = joinrep0 && proc;
    const bool in_group =
        in_group0 || jrep || (starting && row == INTRODUCER);
    const bool ops = proc && in_group;
    const int32_t own_hb = own_hb0 + ops;
    // merges: the flagged partners in round order (a partner whose send
    // flag is off sends nothing, so its row was not read)
    RowAcc<NS> r;
    acc_init(r, own);
    const int32_t* Q = part_st + (size_t)p0 * f * PLANE_W;
    for (uint32_t m = sent_cur; m; m &= m - 1, Q += PLANE_W) {
      const int fi = __ffs(m) - 1;
      const int32_t partner = row ^ __shfl_sync(0xffffffffu, my_mask, fi);
      ViewRegs<NS> pv;
      load_view(pv, Q, Q + k, k, lane, PW_MASK);
      int32_t own_p = (int32_t)(((uint32_t)Q[k] >> 24) |
                                (((uint32_t)Q[k + 1] >> 24 & 0xFu) << 8));
      if (wipe) {   // wipe-on-load of a rejoining partner
        int32_t pf, pr;
        fail_rejoin_of(sc, partner, pf, pr);
        if (t == pr) {
          clear_view(pv);
          own_p = 0;
        }
      }
      merge_view(r, pv, true, row, t, a.t_remove, k, lane);
      if (a.t_remove > 1)
        merge_entry(r, partner, t - 1, own_p, true, sc.seed, ep, km, lane);
    }
    const int recv = __popc(sent_cur);
    if (jrep) {   // JOINREP: the introducer's broadcast row
      ViewRegs<NS> bv;
      load_view(bv, bc, bc + k, k, lane, PW_MASK);
      int32_t bc_hb = (int32_t)(((uint32_t)bc[k] >> 24) |
                                (((uint32_t)bc[k + 1] >> 24 & 0xFu) << 8));
      if (wipe && t == rejoin0) {
        clear_view(bv);
        bc_hb = 0;
      }
      merge_view(r, bv, true, row, t, a.t_remove, k, lane);
      if (a.t_remove > 1)
        merge_entry(r, INTRODUCER, t - 1, bc_hb, row != INTRODUCER, sc.seed,
                    ep, km, lane);
    }
    if (JOIN && row == INTRODUCER)
      merge_joinreq(r, true, q, nullptr, t, k, lane);
    RowOut<NS> o;
    extract_detect<CHURN>(r, ops, t, sc, k, lane, o);
    // dissemination: next tick's send flags and the join sends
    int deg = f;
    if (a.powerlaw) {
      const uint32_t du = mix32(sc.seed, (uint32_t)row, SALT_DEGREE);
      deg = 1 + __popc(__ballot_sync(0xffffffffu, lane + 1 < f && du < my_thr));
    }
    int sf_bits = ops ? (1 << deg) - 1 : 0;
    if (active && ops)
      for (int fi = 0; fi < deg; ++fi)
        if (mix32(sc.seed, (uint32_t)t, (uint32_t)row, (uint32_t)fi,
                  SALT_GOSSIP_DROP) < drop_thr)
          sf_bits &= ~(1 << fi);
    const int n_sf = __popc(sf_bits);
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
    // metrics: lane 0 keeps the warp's running totals
    const int view = warp_sum(o.view), adds = warp_sum(o.adds),
              rem = warp_sum(o.removals), frem = warp_sum(o.false_removals),
              vic = warp_sum(o.victims);
    v[MET_IN_GROUP] += in_group;
    v[MET_VIEW] += view;
    v[MET_ADDS] += adds;
    v[MET_REMOVALS] += rem;
    v[MET_FALSE_REMOVALS] += frem;
    v[MET_VICTIM] += vic;
    v[MET_SENT] += n_sf + joinreq_sent + joinrep_sent;
    v[MET_RECV] += recv + jrep + jreq;
    // the end-of-tick row, re-slotted on the last tick of an epoch, with
    // the aux bytes on payload lanes 0-2
    int32_t pwv[NS];
#pragma unroll
    for (int jj = 0; jj < NS; ++jj)
      pwv[jj] = o.ids[jj] >= 0 ? pack_th(o.ts[jj], o.hb[jj]) : 0;
    if ((t + 1) % SLOT_EPOCH == 0) {   // row i's own-row stage is free now
      __syncwarp();
      reslot_row_smem(o.ids, pwv,
                      reinterpret_cast<unsigned long long*>(own_st +
                                                            s0 * PLANE_W),
                      sc.seed, (uint32_t)((t + 1) / SLOT_EPOCH), km, lane);
    }
    const uint32_t aux[3] = {
        (uint32_t)own_hb & 0xFFu,
        (((uint32_t)own_hb >> 8) & 0xFu) | (uint32_t)in_group << 4 |
            (uint32_t)joinreq_next << 5 | (uint32_t)joinrep_next << 6,
        (uint32_t)sf_bits};
    int32_t* D = out + (size_t)row * PLANE_W;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      const int j = lane + 32 * jj;
      if (j >= k) continue;
      D[j] = o.ids[jj];
      D[k + j] = (int32_t)((uint32_t)pwv[jj] | (j < 3 ? aux[j] << 24 : 0u));
    }
    for (int j = 2 * k + lane; j < PLANE_W; j += 32) D[j] = 0;
    }
    sent_cur = sent_next;
    dec_cur = dec_next;
    rejoin_cur = rejoin_next;
    const int s_done = s0;
    s0 = s1;
    s1 = s2;
    s2 = s_done;
    p0 = 1 - p0;
    __syncwarp();   // row i's stages are read before i+3 / i+2 refill them
  }
  block_metrics<K5_WARPS>(v, met);
}

// The boot JOINREQ aggregate of a launch at tick t0 = sp[GSP_T0], one
// thread a row: every peer but the introducer whose joinreq bit is set
// adds its key at its slot of the epoch, when the introducer processes at
// t0 (models/overlay_grid.py _boot_rows, the plain version).  `agg` (K
// words a lane, zeroed) receives it.
__global__ void __launch_bounds__(256)
grid_boot_kernel(const int32_t* __restrict__ plane, size_t plane_lane,
                 const int32_t* __restrict__ sp, int sp_len,
                 uint32_t* __restrict__ agg, size_t agg_lane, int n, int k) {
  const int b = blockIdx.y;
  const int32_t* P = sp + (size_t)b * sp_len;
  const int32_t t0 = P[GSP_T0];
  if (!(t0 > 0 && !(t0 > P[GSP_FAIL0] && t0 <= P[GSP_REJOIN0]))) return;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n || row == INTRODUCER) return;
  const uint32_t a1 =
      (uint32_t)plane[b * plane_lane + (size_t)row * PLANE_W + k + 1] >> 24;
  if (a1 & 0x20u)
    atomicMax(agg + b * agg_lane +
                  slot_of((uint32_t)P[GSP_SEED], (uint32_t)(t0 / SLOT_EPOCH),
                          row, k),
              pack_key(row, t0));
}

typedef void (*GridTickKernel)(const int32_t*, uint32_t*, int32_t*, int32_t*,
                               const int32_t*, K5Args);

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
  s.churn_span = make_fastmod((uint32_t)churn_span);
  s.t_remove = t_remove;
  return s;
}

// K5's persistent grid: as many blocks as fit on the card at once (`per_sm`
// of them on each SM), shared out among the fleet lanes, and never more
// than the rows need.
int k5_grid_blocks(GridTickKernel kernel, size_t smem, int n, int batch,
                   int& per_sm, cudaError_t& err) {
  int dev = 0, sms = 0;
  per_sm = 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, K5_WARPS * 32, smem);
  const int need = (n + K5_WARPS - 1) / K5_WARPS;
  return max(1, min(need, per_sm * sms / batch));
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
                          int churn_lo, int churn_span, void* stream_ptr) {
  if (k < 1 || k > MAX_K || f < 0 || f > MAX_F)
    return static_cast<int>(cudaErrorInvalidValue);
  K3Args a;
  a.t = host[0];
  a.s = make_sched((uint32_t)host[1], host[2], host[3], host[4], host[5],
                   (uint32_t)host[6], host[7], churn_lo, churn_span, t_remove);
  for (int i = 0; i < MAX_F; ++i) a.masks[i] = i < f ? host[8 + i] : 0;
  const int blocks = (n + WARPS - 1) / WARPS;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k <= 64)
    fused_overlay_tick_kernel<2, false><<<blocks, WARPS * 32, 0, stream>>>(
        idsaux, pw, intro, a, ids_o, hb_o, ts_o, ctr, n, k, f);
  else
    fused_overlay_tick_kernel<SPL, false><<<blocks, WARPS * 32, 0, stream>>>(
        idsaux, pw, intro, a, ids_o, hb_o, ts_o, ctr, n, k, f);
  return static_cast<int>(cudaGetLastError());
}

// K3's sharded contract: n = Nl local rows; host = [the 8 scalars, the F
// global masks, the F local masks]; planes = F round idsaux pointers then
// F round pw pointers (host memory); row_start the global id of row 0.
int gp_fused_overlay_tick_sharded(const int32_t* idsaux, const int32_t* pw,
                                  const int32_t* intro, const int32_t* host,
                                  const uint64_t* planes, int32_t* ids_o,
                                  int32_t* hb_o, int32_t* ts_o, int32_t* ctr,
                                  int n, int k, int f, int t_remove,
                                  int churn_lo, int churn_span, int row_start,
                                  void* stream_ptr) {
  if (k < 1 || k > MAX_K || f < 0 || f > MAX_F || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  K3Args a;
  a.t = host[0];
  a.s = make_sched((uint32_t)host[1], host[2], host[3], host[4], host[5],
                   (uint32_t)host[6], host[7], churn_lo, churn_span, t_remove);
  a.row_start = row_start;
  for (int i = 0; i < MAX_F; ++i) {
    a.masks[i] = i < f ? host[8 + i] : 0;
    a.masks_local[i] = i < f ? host[8 + f + i] : 0;
    a.aux[i] = i < f ? reinterpret_cast<const int32_t*>(planes[i]) : idsaux;
    a.pwr[i] = i < f ? reinterpret_cast<const int32_t*>(planes[f + i]) : pw;
  }
  const int blocks = (n + WARPS - 1) / WARPS;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k <= 64)
    fused_overlay_tick_kernel<2, true><<<blocks, WARPS * 32, 0, stream>>>(
        idsaux, pw, intro, a, ids_o, hb_o, ts_o, ctr, n, k, f);
  else
    fused_overlay_tick_kernel<SPL, true><<<blocks, WARPS * 32, 0, stream>>>(
        idsaux, pw, intro, a, ids_o, hb_o, ts_o, ctr, n, k, f);
  return static_cast<int>(cudaGetLastError());
}

// K4.  st (N, 2K+16) is updated in place over s_ticks <= 16 ticks in one
// cooperative launch; wiped is two planes of its shape (scratch), met
// i32[S, 128] and q (S*K words, scratch) are zeroed in the launch.  sp is
// K4's scalar vector in host memory.  blocks: the persistent grid's size,
// 0 for as many blocks as fit on the card (capped by the rows); a grid
// that cannot be co-resident is refused with an error.
int gp_mega_overlay_ticks(int32_t* st, int32_t* wiped, int32_t* met,
                          int32_t* q, const int32_t* sp, int n, int k, int f,
                          int s_ticks, int t_remove, int churn_lo,
                          int churn_span, int can_rejoin, int powerlaw,
                          int blocks, void* stream_ptr) {
  if (k < 1 || 2 * k + AUX_LANES > MAX_K || f < 1 || f > K4_MAX_F ||
      n < 1 || s_ticks < 1 || s_ticks > K4_MAX_TICKS)
    return static_cast<int>(cudaErrorInvalidValue);
  K4Args a;
  a.s = make_sched((uint32_t)sp[SP_SEED], sp[SP_VLO], sp[SP_VHI],
                   sp[SP_FTICK], sp[SP_RAFTER], (uint32_t)sp[SP_CTHR],
                   sp[SP_CAFTER], churn_lo, churn_span, t_remove);
  a.t0 = sp[SP_T0];
  a.fail0 = sp[SP_FAIL0];
  a.rejoin0 = sp[SP_REJOIN0];
  a.drop_on = sp[SP_DROP_ON] > 0;
  a.drop_open = sp[SP_DROP_OPEN];
  a.drop_close = sp[SP_DROP_CLOSE];
  a.drop_thr = (uint32_t)sp[SP_DROP_THR];
  a.can_rejoin = can_rejoin;
  a.powerlaw = powerlaw;
  a.n = n;
  a.k = k;
  a.f = f;
  a.s_ticks = s_ticks;
  a.st = st;
  a.wiped = wiped;
  a.met = met;
  a.q = reinterpret_cast<uint32_t*>(q);
  for (int i = 0; i < K4_MAX_TICKS * K4_MAX_F; ++i) a.masks[i] = 0;
  for (int s = 0; s < s_ticks; ++s)
    for (int fi = 0; fi < f; ++fi)
      a.masks[s * f + fi] = sp[SP_NSCALARS + s * f + fi];
  if (blocks <= 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mega_overlay_kernel, WARPS * 32, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    blocks = min(per_sm * sms, (n + WARPS - 1) / WARPS);
  }
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(mega_overlay_kernel), dim3(blocks),
      dim3(WARPS * 32), args, 0, static_cast<cudaStream_t>(stream_ptr));
  const cudaError_t last = cudaGetLastError();   // clears a refused launch
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// K5.  plane (B, N, 128; lane l at plane + l * plane_lane words, 16-byte
// aligned) and sp (B, sp_len) on the device; agg (B, K; lane l at agg +
// l * agg_lane words) the launch's boot JOINREQ aggregate, or null where
// it is zero; plane2 (B, 2, N, 128), met (B, S, 128) and q (B (S+1) K
// words) are written here: met zeroed, q's slot 0 the boot aggregate, its
// slots 1..S zeroed.  On a join-live launch the last tick leaves the next
// launch's boot aggregate (tick t0 + S's) in slot S, which the caller
// hands to that launch as its agg (the carry: no launch reads the plane
// again for it).  One launch a tick on one stream: the stream order is
// the barrier between ticks.  flags: FL_RAMP | FL_CHURN | FL_JOIN |
// FL_DROP, the launch's live phases.
int gp_grid_overlay_ticks(const int32_t* plane, long long plane_lane,
                          const int32_t* agg, long long agg_lane,
                          const int32_t* sp, int32_t* plane2, int32_t* met,
                          int32_t* q, int n, int k, int f, int s_ticks,
                          int batch, int sp_len, int t_remove, int churn_lo,
                          int churn_span, int can_rejoin, int churn_mode,
                          int powerlaw, int flags, void* stream_ptr) {
  if (k < 1 || 2 * k > PLANE_W || f < 1 || f > K5_MAX_F || n < 8 ||
      s_ticks < 1 || batch < 1 || batch > 65535 || flags < 0 || flags > 15 ||
      plane_lane % 4 != 0 || reinterpret_cast<uintptr_t>(plane) % 16 != 0 ||
      (batch > 1 && plane_lane < (long long)n * PLANE_W) ||
      (agg && agg_lane < k))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaMemsetAsync(
      met, 0, sizeof(int32_t) * (size_t)batch * s_ticks * MET_COLS, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t q_lane = (size_t)(s_ticks + 1) * k;
  if (agg) {
    err = cudaMemset2DAsync(q + k, sizeof(int32_t) * q_lane, 0,
                            sizeof(int32_t) * s_ticks * k, batch, stream);
    if (err == cudaSuccess)
      err = cudaMemcpy2DAsync(q, sizeof(int32_t) * q_lane, agg,
                              sizeof(int32_t) * agg_lane, sizeof(int32_t) * k,
                              batch, cudaMemcpyDeviceToDevice, stream);
  } else {
    err = cudaMemsetAsync(q, 0, sizeof(int32_t) * batch * q_lane, stream);
  }
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
  const GridTickKernel kernel = kGridKernels[flags];
  const size_t smem = sizeof(int32_t) * K5_WARPS * k5_warp_words(f);
  int per_sm = 0;
  const int blocks = k5_grid_blocks(kernel, smem, n, batch, per_sm, err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks, batch);
  for (int s = 0; s < s_ticks; ++s) {
    a.s = s;
    // the input plane at s = 0, after that phase s % 2
    const int32_t* in = s == 0 ? plane : plane2 + (size_t)(s % 2) * words;
    a.in_lane = s == 0 ? (size_t)plane_lane : a.out_lane;
    kernel<<<grid, K5_WARPS * 32, smem, stream>>>(
        in, reinterpret_cast<uint32_t*>(q) + (size_t)s * k,
        plane2 + (size_t)(1 - s % 2) * words, met, sp, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5's boot pre-pass: the boot JOINREQ aggregate agg (B, K), zeroed, then
// filled at sp's t0 by grid_boot_kernel.  The route runs it only where no
// K5 launch of the run produced the plane (gp_grid_overlay_ticks carries
// it from there).
int gp_grid_boot(const int32_t* plane, long long plane_lane, const int32_t* sp,
                 int32_t* agg, int n, int k, int batch, int sp_len,
                 void* stream_ptr) {
  if (k < 1 || 2 * k > PLANE_W || n < 1 || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err =
      cudaMemsetAsync(agg, 0, sizeof(int32_t) * (size_t)batch * k, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  grid_boot_kernel<<<dim3((n + 255) / 256, batch), 256, 0, stream>>>(
      plane, (size_t)plane_lane, sp, sp_len, reinterpret_cast<uint32_t*>(agg),
      (size_t)k, n, k);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks a streaming multiprocessor holds of K5's variant `flags`
// at F, as gp_grid_overlay_ticks sizes its persistent grid; a negative CUDA
// error code on failure.
int gp_grid_blocks_per_sm(int f, int flags) {
  if (f < 1 || f > K5_MAX_F || flags < 0 || flags > 15)
    return -static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  cudaError_t err;
  k5_grid_blocks(kGridKernels[flags],
                 sizeof(int32_t) * K5_WARPS * k5_warp_words(f), 1, 1, per_sm,
                 err);
  return err != cudaSuccess ? -static_cast<int>(err) : per_sm;
}

}  // extern "C"
