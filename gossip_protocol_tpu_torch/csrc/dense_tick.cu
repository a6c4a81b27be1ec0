// Dense full-view tick kernels for Hopper (sm_90a): the CUDA port of the
// two TPU kernels on the dense model's main path.
//
//   gp_masked_max3     the three gossip merge maxima of one tick (a prep
//                      launch and a descent launch).  Replaces the TPU's
//                      int8 MXU level descent (gossip_protocol_tpu/ops/
//                      merge.py gossip_reductions_mxu / _masked_max_mxu)
//                      that feeds K1, and the in-kernel masked_max of K2
//                      (ops/pallas/dense_mega.py:114).
//   gp_tick_epilogue   K1, ops/pallas/tickfused.py fused_tick_update: the
//                      post-merge cell rules, detection, dissemination and
//                      the per-row sent/recv counts of one tick.
//   gp_merge_epilogue  the two above in one descent launch (after the
//                      prep) where the merge builds a witness ladder
//                      (N > 1024): each tile applies the cell rules to the
//                      maxima it just found, so they never reach HBM.
//   gp_dense_mega_ticks  K2, ops/pallas/dense_mega.py dense_mega_ticks: S
//                      whole ticks per call as one cooperative persistent
//                      launch (vector step, churn wipe, masked_max3,
//                      epilogue), its phases separated by grid barriers.
//   gp_vector_step     the per-peer vector step of a K1 tick (ops/vector.py
//                      vector_step).  It replaces no Pallas kernel: the JAX
//                      package's vector step is XLA (core/tick.py
//                      make_tick).  It exists for the host's launch budget:
//                      in plain torch the step is ~50 elementwise launches
//                      and two sums a tick, which the host issues slower
//                      than the card runs them.
//
// The K1 pair also takes a leading lane axis: B independent N x N
// simulations of a fleet at one shared clock (gossip_protocol_tpu_torch/
// core/fleet.py) in one launch each, the lane one more grid coordinate
// (the merge's z = 3 lane + plane, the epilogue's z = lane) and every
// plane, vector, row and merge scratch offset by its lane.  The JAX
// package's fleet runs its XLA tick under vmap here instead.
//
// gp_masked_max3 also takes a rectangular block: S senders x R receivers
// against S payload rows of C columns, the ring merge of a peer-sharded run
// (gossip_protocol_tpu/parallel/comm.py RingComm.merge_reduce: an Nl x Nl
// delivery block against Nl x N rows, each of the P ring steps a launch);
// the tiling is the square one's over (R, C), the live-word lists over S.
// The square block of a tick keeps a template instance of its own, so its
// code is the one extent's.
//
// Every value is an integer or a 0/1 byte, so each kernel agrees with its
// plain PyTorch version bit for bit.
//
// Bounds on an H100 (3.35 TB/s; 16.7 T int32 operations/s on the INT32
// lanes: 132 SMs x 64 lanes x 1.98 GHz; 1,979 T int8 operations/s on the
// tensor cores):
// * masked_max3: m[r, j] = max over the senders s that deliver to r of
//   payload[s, j], for three payload planes.  As a product-max on the
//   INT32 lanes it needs 3 maxima per (delivery, column) pair, 3 D N.  The
//   design is the TPU's level descent (level 0, the pre-resolve d @ (v >
//   0), closes the cells it misses as FILL; level k, the witness product
//   d @ (v == cur), closes those it hits with cur) on the tensor cores,
//   its levels taken from a witness ladder built once a lane-tick.  Two
//   launches: the prep packs the delivery d[r, s] = gossip[s, r] &
//   proc[r] as bits (one 32-sender word per receiver) and marks which
//   words reach each 32-receiver tile; its second block role, a 32-column
//   strip a block, reads the payload of every sender row twice (a cell
//   nobody knows only its known byte): once for each column's LADDER
//   largest distinct values per plane, once for the witness bit-planes
//   (v > 0 and v == rung k, per plane) as 32-sender words, with the words
//   that hold a witness in each strip.  The rungs come from every sender,
//   a superset of those that deliver, so for a cell no rung above its
//   maximum has a witness among its senders, and its maximum is a rung or
//   lies below the last: the descent stays exact for any data.  The
//   descent launch runs one block a 256-receiver x 64-column tile for all
//   three planes: a receiver that does not consume the tick is FILL at
//   once; per plane, the rung products (a cell hit first takes rung - 1)
//   over the tile's live words that hold a witness in its columns (none:
//   no product), FILL for the columns whose ladder holds every value,
//   level 0 if cells are still open, and past the ladder the per-tile
//   level loop (descent_levels, whose witnesses come from known/hb/ts)
//   from below the last rung.  A product is one mma.sync m16n8k256 b1
//   (AND, popcount; counts are at most N, so exact) a 256-sender chunk,
//   both operands the stored bits, the next chunk's loads in flight while
//   one multiplies; a plane's cells keep a 2-bit code until one store pass
//   through shared memory writes them row by row.  Nothing in a tile
//   reads known/hb/ts while the ladder suffices: the payload crosses the
//   chip twice a lane-tick, not once per row tile, plane and level.
//   Bounded now by those two reads (9 bytes a known cell each), the three
//   maxima written (12 bytes a cell) and the prep's tiles; at the bench's
//   ticks the descent runs about one product a tile (PERF.md).  A launch
//   of at most four row tiles (R <= 1024) re-reads its payload too few
//   times to pay for a ladder (use_ladder): it runs
//   masked_max3_plane_kernel, the per-tile descent from level 0 with s8
//   products (mma.sync m16n8k32), a plane a block.  K2 has no phase for a ladder pass and keeps that per-tile
//   descent (descent_tile): K2 and the K1 merge no longer share the
//   descent, only its level loop.
// * merge_epilogue: a ladder tile's three planes of codes (2 bits a cell)
//   stay in registers, cross shared memory as one byte a cell and are
//   decoded against the tile's rungs where the epilogue's rules read them;
//   dfull is a bit of the prep's delivery words, which the tile's products
//   already read.  A cell moves 21 bytes past the descent's (hb/ts in and
//   out, known and gossip in and out, gdrop in) against the pair's 46
//   (the maxima written and read back, the transposed gossip read).  A
//   tile that falls back past the ladder writes those cells' values into a
//   scratch plane its own epilogue reads back after a barrier.
// * the epilogue is elementwise over ~36 bytes per cell (three i32 maxima,
//   hb/ts in and out, six byte planes): bound by bytes.  Design: a 2-D
//   grid of 32-row x 128-column tiles (N=2816: 1936 blocks), 4 columns a
//   thread as int4 / 32-bit byte quads where N % 4 == 0 (scalar otherwise,
//   the ragged tail masked); the transposed read of the gossip plane
//   (receiver r consumes gossip[s, r]) goes through a shared-memory tile so
//   every global read stays coalesced; the row sums are a warp reduction
//   and one atomicAdd per row and block, onto rows the vector step seeded
//   with the join traffic (K1's vector_step_kernel, K2's vec_rows), so a
//   tick issues no memset.
// * the K1 vector step moves ~43 bytes a peer (nine [B, N] inputs of 21
//   bytes, 10 output bytes and three output words): 0.97 MB a fleet tick at
//   B=8, N=2816, under a microsecond at 3.35 TB/s, so a launch's latency
//   bounds it.  Design: one block a lane, its threads striding over the
//   peers; the introducer's two sums (JOINREP sent, JOINREQ consumed) are a
//   block reduction added onto peer 0's rows by the thread that wrote them.
//   It writes the join share of the tick's sent / recv rows, and the
//   epilogue adds the gossip counts onto them.  Churn and flap are
//   template flags, so a launch without them reads neither.
// * K2 on the TPU kept the whole state in 110 MB of VMEM.  An SM has
//   227 KB of shared memory, so here the state stays in HBM/L2 (the N=896
//   planes are 9 MB) and a call is one cooperative launch of a persistent
//   grid (as many blocks as fit on the card, capped by the work) that runs
//   the S ticks with three grid barriers a tick: (1) the churn wipe and the
//   merge prep, (2) the descent tiles, (3) the epilogue tiles beside the
//   next tick's vector step (one block; its lanes are double-buffered by
//   tick parity, so the epilogue still reads this tick's).  The K1 pair
//   and K2 call the same __device__ prep and epilogue tile functions, so
//   the cell rules cannot drift apart.  A phase with fewer tiles than
//   blocks deals them out across the whole grid, since the runtime packs
//   consecutive blocks onto one SM.  Buffers written inside the launch are read through plain
//   pointers (never const __restrict__), so no load takes the
//   non-coherent read-only path.  At N=512 and 896 the descent takes
//   most of a tick: a tile's levels and word chunks run one after
//   another, latency-bound (PERF.md).  K2's tiles run the per-tile level
//   descent (descent_tile), not the K1 merge's ladder.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORD = 32;        // senders per delivery word (one bit each)
constexpr int MM_ROWS = 256;    // descent tile: receivers (8 warps x 32)
constexpr int MM_COLS = 64;     // descent tile: columns
constexpr int MM_THREADS = 256;
constexpr int MM_KW = 4;        // delivery words staged per chunk
// witness row stride in bytes: 36 words, so the B-fragment reads of rows
// g = 0..7 and quads t = 0..3 hit 32 distinct banks
constexpr int MM_WSTRIDE = MM_KW * WORD + 16;
constexpr int EP_ROWS = 32;     // epilogue tile rows (8 warps x 4)
constexpr int EP_COLS = 128;    // epilogue tile columns (32 lanes x 4)
constexpr int EP_THREADS = 256;
constexpr int K2_THREADS = 256;   // = MM_THREADS = EP_THREADS
constexpr int VS_THREADS = 1024;  // the K1 vector step: a lane's block

// per-tick vector lanes written by the K2 vector step (u8[VEC_LANES, N])
enum { V_PROC = 0, V_OPS, V_JREP, V_JREQ, V_HOLD, V_REJOIN, VEC_LANES };
// outputs of the K1 route's vector step: bytes u8[S_LANES, B, N] and
// words i32[I_LANES, B, N] (ops/vector.py fused_vector_step)
enum { S_PROC = 0, S_FAILED, S_REJOIN, S_JREQ, S_JREP, S_HOLD, S_OPS,
       S_IN_GROUP, S_JOINREQ, S_JOINREP, S_LANES };
enum { I_OWN_HB = 0, I_SENT, I_RECV, I_LANES };
// aux lanes (ops/pallas/dense_mega.py)
enum { A_IN_GROUP = 0, A_OWN_HB, A_JOINREQ, A_JOINREP, A_START, A_FAIL,
       A_REJOIN, AUX_LANES = 8 };

// The merge takes a delivery block of S senders x R receivers
// (gossip[s, r], sender-major as the state holds it) against S payload
// rows of C columns: a tick merges the square N x N block, the ring merge
// of a peer-sharded run (parallel/comm.py RingComm.merge_reduce) an
// Nl x Nl block against Nl x N payload rows.  rn, sn and cn below are R,
// S and C; words is the sender words, words_for(S).
//
// Prep: dbits[w * R + r] has bit b set iff gossip[32 w + b, r] & proc[r];
// tany[(r / 32) * words + w] says whether word w reaches any receiver of
// r's 32-receiver tile.  A prep block takes the tiles (w0 + i, rt), i <
// PREP_WORDS, each 32 senders x 32 receivers, with 256 threads as (tx, ty)
// = (32, 8), their gossip bytes all loaded before any is used, so its
// tiles cost one round trip.  SQ: the square block of a tick (S = R),
// compiled as it was before the rectangular form.
constexpr int PREP_WORDS = 4;
template <bool SQ>
__device__ __forceinline__ void merge_prep_tiles(const uint8_t* gossip,
                                                 const uint8_t* proc,
                                                 uint32_t* dbits,
                                                 uint32_t* tany, int rn,
                                                 int sn, int words, int w0,
                                                 int rt, int tx, int ty) {
  if (SQ) sn = rn;
  __shared__ uint8_t g_s[PREP_WORDS][WORD][WORD + 4];
  const int c0 = rt * WORD, r = c0 + tx;
#pragma unroll
  for (int i = 0; i < PREP_WORDS; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ss = ty + 8 * k, s = (w0 + i) * WORD + ss;
      g_s[i][ss][tx] = (s < sn && r < rn) ? gossip[(size_t)s * rn + r] : 0;
    }
  __syncthreads();
  uint32_t any[PREP_WORDS] = {};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int rr = ty + 8 * k, rk = c0 + rr;   // uniform across the warp
    if (rk >= rn) continue;
    const bool on = proc[rk] != 0;
#pragma unroll
    for (int i = 0; i < PREP_WORDS; ++i) {
      if (w0 + i >= words) continue;
      const uint32_t bits =
          __ballot_sync(0xffffffffu, g_s[i][tx][rr] != 0 && on);
      if (tx == 0) dbits[(size_t)(w0 + i) * rn + rk] = bits;
      any[i] |= bits;
    }
  }
#pragma unroll
  for (int i = 0; i < PREP_WORDS; ++i) {
    const uint32_t a = __syncthreads_or(any[i] != 0);
    if (tx == 0 && ty == 0 && w0 + i < words)
      tany[(size_t)rt * words + w0 + i] = a;
  }
}

__host__ __device__ inline int words_for(int n) {
  return (n + WORD - 1) / WORD;
}

// the prep's part of a lane's merge scratch: dbits u32[words_for(S), R],
// then tany u32[words_for(R), words_for(S)] (a row per 32-receiver tile)
__host__ __device__ inline size_t merge_scratch_words(int rn, int sn) {
  const size_t words = words_for(sn);
  return words * rn + (size_t)words_for(rn) * words;
}

// The witness ladder (K1's merge only).  Per lane, plane p and column j,
// lad[p][k][j] (k < LADDER) are the LADDER largest distinct positive
// values of the plane's shift-encoded payload over every sender row, 0
// past the last; one witness bit a (sender, column) per bit-plane:
// level 0 of plane p (v > 0) and rung k of plane p (v == lad[p][k][j],
// lad > 0), as u32 sender words wbits[bp][w][j]; wany[bp][ls][w / 32]
// marks the words with a witness in column strip ls (LD_COLS columns).
// LADDER: at the bench's ticks 300 and 699 two rungs leave no tile to
// fall back and one leaves some (PERF.md); a rung more costs a bit-plane
// a plane.
constexpr int LADDER = 2;
constexpr int NBP = 3 + 3 * LADDER;   // witness bit-planes
constexpr int WANY_MAX = 64;          // wany words a strip: S <= 65536
// a ladder block: LD_COLS columns x LD_GROUPS sender groups, LD_U rows
// a batch in flight a thread (a batch's rows: two sender words)
constexpr int LD_COLS = 32;
constexpr int LD_GROUPS = MM_THREADS / LD_COLS;
constexpr int LD_U = 8;
constexpr int LD_PER_TILE = MM_COLS / LD_COLS;   // strips a column tile
static_assert(LD_COLS % WORD == 0 && MM_COLS % LD_COLS == 0,
              "a warp's lanes share a sender group");
__host__ __device__ inline int bp_level0(int p) { return p; }
__host__ __device__ inline int bp_rung(int p, int k) {
  return 3 + p * LADDER + k;
}

// A launch builds the ladder when its grid has more than LADDER_MIN_RT
// row tiles, the sender words fit the word masks and the descent's word
// lists (1 + NBP ints a sender word) fit 48 KB, which beside the
// kernel's static LadderSmem takes an opt-in past S = 8,160.  The per-tile
// descent reads the live senders' payload once a row tile and level, the
// ladder all of it twice: with a few row tiles the two cost about the
// same (the ring's 1024 x 1024 x 4096 blocks, four row tiles, ran 0.061
// ms per-tile against 0.074 on the ladder; PERF.md).
constexpr int LADDER_MIN_RT = 4;
__host__ __device__ inline bool use_ladder(int rn, int sn) {
  return rn > LADDER_MIN_RT * MM_ROWS &&
         words_for(words_for(sn)) <= WANY_MAX &&
         (1 + NBP) * words_for(sn) * sizeof(int) <= 48 * 1024;
}

// the ladder's part of a lane's scratch: lad i32[3, LADDER, C], wbits
// u32[NBP, words, C], wany u32[NBP, strips, words_for(words)]
__host__ __device__ inline size_t ladder_scratch_words(int sn, int cn) {
  const size_t words = words_for(sn), ls = (cn + LD_COLS - 1) / LD_COLS;
  return 3 * LADDER * (size_t)cn + NBP * words * cn +
         NBP * ls * words_for((int)words);
}

// a lane's whole merge scratch (the lanes of a fleet follow one another)
__host__ __device__ inline size_t lane_scratch_words(int rn, int sn, int cn) {
  return merge_scratch_words(rn, sn) +
         (use_ladder(rn, sn) ? ladder_scratch_words(sn, cn) : 0);
}

struct LadderPtrs {
  int32_t* lad;
  uint32_t* wbits;
  uint32_t* wany;
};

__device__ __forceinline__ LadderPtrs ladder_ptrs(uint32_t* lane_scratch,
                                                  int rn, int sn, int cn) {
  LadderPtrs l;
  l.lad = reinterpret_cast<int32_t*>(lane_scratch +
                                     merge_scratch_words(rn, sn));
  l.wbits = reinterpret_cast<uint32_t*>(l.lad + 3 * LADDER * (size_t)cn);
  l.wany = l.wbits + NBP * (size_t)words_for(sn) * cn;
  return l;
}

// the three shift-encoded payloads of one sender cell (merge_payloads):
// a1 = known ? hb + 1 : 0, f1 = fresh ? hb + 1 : 0, t1 = fresh ? ts + 1 :
// 0, fresh = known & now - ts < t_remove
__device__ __forceinline__ void payload3(uint8_t kn, int32_t h, int32_t st,
                                         int now, int t_remove,
                                         int32_t (&v)[3]) {
  const bool fresh = kn && now - st < t_remove;
  v[0] = kn ? h + 1 : 0;
  v[1] = fresh ? h + 1 : 0;
  v[2] = fresh ? st + 1 : 0;
}

// insert v into a descending list of distinct positive values (0 past
// the last): a duplicate or a value <= 0 leaves it as it was
__device__ __forceinline__ void ladder_insert(int32_t (&t)[LADDER],
                                              int32_t v) {
#pragma unroll
  for (int k = 0; k < LADDER; ++k) {
    if (v == t[k]) v = 0;
    const int32_t hi = max(t[k], v);
    v = min(t[k], v);
    t[k] = hi;
  }
}

// The rows s = q, q + LD_GROUPS, ... of one column of a ladder strip, U
// rows a batch: row(kn, h, st, s, u) for each (kn: known, h / st: hb / ts,
// 0 where unknown, so an unknown cell's words stay unread; s the row; u
// its place in the batch), after batch(base) at each batch's start (base:
// the batch's first row of group 0, the same in every group).  A batch
// for which skip(base) holds reads nothing: its rows count as unknown.
// The next batch's known bytes are in flight while this one's words
// load, so a batch costs one round trip.
template <int U, class Skip, class Batch, class Row>
__device__ __forceinline__ void ladder_rows(const uint8_t* known,
                                            const int32_t* hb,
                                            const int32_t* ts, int sn,
                                            int cn, size_t jc, int q,
                                            bool col, Skip skip, Batch batch,
                                            Row row) {
  constexpr int STEP = LD_GROUPS * U;
  const size_t stride = (size_t)LD_GROUPS * cn;   // a group's next row
  uint32_t kq[U / 4];                             // known bytes, packed
  auto load_known = [&](int base) {
#pragma unroll
    for (int i = 0; i < U / 4; ++i) kq[i] = 0;
    if (skip(base)) return;
    const uint8_t* kp = known + (size_t)(base + q) * cn + jc;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (col && base + q + LD_GROUPS * u < sn)
        kq[u / 4] |= (uint32_t)kp[u * stride] << (8 * (u % 4));
  };
  load_known(0);
  // every group runs the same batches (base is uniform); a row past S is
  // unknown
  for (int base = 0; base < sn; base += STEP) {
    if (skip(base)) {   // nothing read: every row unknown, nothing to do
      if (base + STEP < sn) load_known(base + STEP);
      batch(base);
      continue;
    }
    const int s0 = base + q;
    const size_t o = (size_t)s0 * cn + jc;
    uint32_t kn[U / 4];
    int32_t h[U], st[U];
#pragma unroll
    for (int i = 0; i < U / 4; ++i) kn[i] = kq[i];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool k = (kn[u / 4] >> (8 * (u % 4))) & 0xFFu;
      h[u] = k ? hb[o + u * stride] : 0;
      st[u] = k ? ts[o + u * stride] : 0;
    }
    if (base + STEP < sn) load_known(base + STEP);
    batch(base);
#pragma unroll
    for (int u = 0; u < U; ++u)
      row((kn[u / 4] >> (8 * (u % 4))) & 0xFFu, h[u], st[u],
          s0 + LD_GROUPS * u, u);
  }
}

// The ladder of column strip ls (LD_COLS columns) of one lane: 256
// threads as (column c, sender group q) = (LD_COLS, LD_GROUPS), group q
// taking the rows s = q mod LD_GROUPS (ladder_rows).  Sweep 1 finds each
// column's ladder over every sender row (each group's, then the groups'
// merged); sweep 2 reads the strip again and writes the witness words:
// a batch's rows fall in two sender words, whose bits the groups OR into
// shared memory, and every LD_CHUNK words the block writes them out with
// the strip's word masks.
constexpr int LD_CHUNK = 8;
__device__ __forceinline__ void ladder_strip(const uint8_t* known,
                                             const int32_t* hb,
                                             const int32_t* ts, LadderPtrs l,
                                             int sn, int cn, int now,
                                             int t_remove, int ls) {
  static_assert(LD_GROUPS * LD_U == 2 * WORD && LD_GROUPS * 4 == WORD,
                "a batch of a group's rows: four in each of two words");
  __shared__ int32_t part_s[LD_GROUPS][3 * LADDER][LD_COLS];
  __shared__ uint32_t any_s[NBP][WANY_MAX];
  __shared__ uint32_t wsm[LD_CHUNK][NBP][LD_COLS];
  __shared__ uint32_t kw_s[WANY_MAX];   // the words holding a known cell
  const int tid = threadIdx.y * WORD + threadIdx.x;
  const int c = tid % LD_COLS, q = tid / LD_COLS;
  const int lane = tid & 31, warp = tid >> 5;
  const int j = ls * LD_COLS + c;
  const bool col = j < cn;
  const size_t jc = min(j, cn - 1);
  const int words = words_for(sn), wwords = words_for(words);
  const int strips = (cn + LD_COLS - 1) / LD_COLS;
  for (int i = tid; i < NBP * WANY_MAX; i += MM_THREADS)
    any_s[i / WANY_MAX][i % WANY_MAX] = 0;
  for (int i = tid; i < LD_CHUNK * NBP * LD_COLS; i += MM_THREADS)
    (&wsm[0][0][0])[i] = 0;
  for (int i = tid; i < WANY_MAX; i += MM_THREADS) kw_s[i] = 0;
  int32_t t[3][LADDER];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int k = 0; k < LADDER; ++k) t[p][k] = 0;
  // sweep 1, noting the words that hold a known cell of the strip (this
  // thread's flags of a batch's words, ORed in at the next batch)
  constexpr int WB1 = LD_GROUPS * LD_U / WORD;   // words a batch
  uint32_t kw = 0;
  int kbase = 0;
  auto known_words = [&]() {
#pragma unroll
    for (int i = 0; i < WB1; ++i) {
      const bool any = __any_sync(0xffffffffu, (kw >> i) & 1u);
      const int w = kbase / WORD + i;
      if (any && lane == 0 && w < words)
        atomicOr(&kw_s[w / WORD], 1u << (w % WORD));
    }
    kw = 0;
  };
  ladder_rows<LD_U>(known, hb, ts, sn, cn, jc, q, col,
                    [](int) { return false; },
                    [&](int base) { known_words(); kbase = base; },
                    [&](uint32_t kn, int32_t h, int32_t st, int, int u) {
    if (!kn) return;
    kw |= 1u << (u * LD_GROUPS / WORD);
    int32_t v[3];
    payload3(kn, h, st, now, t_remove, v);
    // a value at or below the last rung changes nothing
#pragma unroll
    for (int p = 0; p < 3; ++p)
      if (v[p] > t[p][LADDER - 1]) ladder_insert(t[p], v[p]);
  });
  known_words();
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int k = 0; k < LADDER; ++k) part_s[q][p * LADDER + k][c] = t[p][k];
  __syncthreads();
  if (q == 0) {
    for (int g = 1; g < LD_GROUPS; ++g)
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int k = 0; k < LADDER; ++k)
          ladder_insert(t[p], part_s[g][p * LADDER + k][c]);
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int k = 0; k < LADDER; ++k) {
        part_s[0][p * LADDER + k][c] = t[p][k];
        if (col) l.lad[(size_t)(p * LADDER + k) * cn + j] = t[p][k];
      }
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int k = 0; k < LADDER; ++k) t[p][k] = part_s[0][p * LADDER + k][c];
  // sweep 2: the chunk's words out, their masks, the buffer zeroed
  auto flush = [&](int w0) {
    __syncthreads();
    for (int i = warp; i < LD_CHUNK * NBP; i += MM_THREADS / WORD) {
      const int wl = i / NBP, b = i % NBP, w = w0 + wl;
      uint32_t* at = &wsm[wl][b][0];
      for (int cc = lane; cc < LD_COLS; cc += WORD) {
        const uint32_t x = at[cc];
        at[cc] = 0;
        const int jj = ls * LD_COLS + cc;
        if (w < words && jj < cn)
          l.wbits[((size_t)b * words + w) * cn + jj] = x;
        if (__any_sync(0xffffffffu, x != 0) && lane == 0 && w < words)
          atomicOr(&any_s[b][w / WORD], 1u << (w % WORD));
      }
    }
    __syncthreads();
  };
  // a batch's rows fall in two words: this thread's bits of them, ORed
  // into the buffer at the next batch's start
  uint32_t bits[2][NBP];
  int w0 = 0, wb = 0;
  auto commit = [&]() {
#pragma unroll
    for (int wi = 0; wi < 2; ++wi)
#pragma unroll
      for (int b = 0; b < NBP; ++b) {
        if (bits[wi][b]) atomicOr(&wsm[wb + wi - w0][b][c], bits[wi][b]);
        bits[wi][b] = 0;
      }
  };
#pragma unroll
  for (int wi = 0; wi < 2; ++wi)
#pragma unroll
    for (int b = 0; b < NBP; ++b) bits[wi][b] = 0;
  // sweep 2 reads no batch whose two words hold no known cell of the strip
  auto unknown = [&](int base) {
    const int w = base / WORD;
    auto has = [&](int x) {
      return x < words && ((kw_s[x / WORD] >> (x % WORD)) & 1u);
    };
    return !has(w) && !has(w + 1);
  };
  ladder_rows<LD_U>(known, hb, ts, sn, cn, jc, q, col, unknown,
              [&](int base) {
                commit();
                if (base / WORD - w0 >= LD_CHUNK) {   // base is uniform
                  flush(w0);
                  w0 += LD_CHUNK;
                }
                wb = base / WORD;
              },
              [&](uint32_t kn, int32_t h, int32_t st, int s, int u) {
    int32_t v[3];
    payload3(kn, h, st, now, t_remove, v);
    const uint32_t bit = 1u << (s % WORD);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if (v[p] > 0) bits[u / 4][bp_level0(p)] |= bit;
#pragma unroll
      for (int k = 0; k < LADDER; ++k)
        if (t[p][k] > 0 && v[p] == t[p][k]) bits[u / 4][bp_rung(p, k)] |= bit;
    }
  });
  commit();
  flush(w0);
  for (int i = tid; i < NBP * wwords; i += MM_THREADS) {
    const int b = i / wwords, ww = i % wwords;
    l.wany[((size_t)b * strips + ls) * wwords + ww] = any_s[b][ww];
  }
}

// the prep blocks of one lane
__host__ __device__ inline long long prep_blocks(int rn, int words) {
  return (long long)words_for(rn) * ((words + PREP_WORDS - 1) / PREP_WORDS);
}

// grid (B (ladder strips + prep blocks)) of (32, 8) threads, B lanes (1
// solo).  With a ladder, blocks i < B * nl (nl: column strips) build it,
// strip i % nl of lane i / nl, and come first, so the long ladder blocks
// of every lane start early; each remaining block k is the prep tiles (w,
// rt) of PREP_WORDS words w of one receiver tile rt of lane k /
// prep_blocks.  lane_words: lane_scratch_words(R, S, C).
// (four blocks an SM: the ladder role's registers set the prep tiles'
// occupancy too)
template <bool SQ>
__global__ void __launch_bounds__(256, 4)
merge_prep_kernel(const uint8_t* __restrict__ gossip,
                  const uint8_t* __restrict__ proc,
                  const uint8_t* __restrict__ known,
                  const int32_t* __restrict__ hb,
                  const int32_t* __restrict__ ts,
                  uint32_t* __restrict__ scratch, size_t lane_words, int rn,
                  int sn, int cn, int words, int ladder_tiles, int now,
                  int t_remove) {
  if (SQ) { sn = rn; cn = rn; }
  const long long i = blockIdx.x, nl = ladder_tiles;
  const long long prep = prep_blocks(rn, words);
  const long long ladder_blocks = nl * (gridDim.x / (nl + prep));
  if (i < ladder_blocks) {
    const size_t lane = i / nl, o = lane * (size_t)sn * cn;
    ladder_strip(known + o, hb + o, ts + o,
                 ladder_ptrs(scratch + lane * lane_words, rn, sn, cn), sn,
                 cn, now, t_remove, (int)(i % nl));
    return;
  }
  const long long k = i - ladder_blocks;
  const size_t lane = k / prep;
  const int wq = (words + PREP_WORDS - 1) / PREP_WORDS;
  const int unit = (int)(k % prep), rt = unit / wq;
  uint32_t* dbits = scratch + lane * lane_words;
  merge_prep_tiles<SQ>(gossip + lane * (size_t)sn * rn, proc + lane * rn,
                       dbits, dbits + (size_t)words * rn, rn, sn, words,
                       (unit % wq) * PREP_WORDS, rt, threadIdx.x,
                       threadIdx.y);
}

// 4 delivery bits -> 4 bytes of 0/1 (bit e -> byte e)
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

// c += a (16 x 32, s8, row) * b (32 x 8, s8, col), s32 accumulators
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the shift-encoded payload of plane p from one sender cell: a1 = known
// ? hb + 1 : 0, f1 = fresh ? hb + 1 : 0, t1 = fresh ? ts + 1 : 0 (fresh =
// known & now - ts < t_remove); 0 means nothing.  Branch-free, so a
// thread's loads of a word can all be in flight together.
__device__ __forceinline__ int32_t payload(int p, uint8_t kn, int32_t h,
                                           int32_t st, int now,
                                           int t_remove) {
  const bool fresh = kn && now - st < t_remove;
  const int32_t v = p == 2 ? st + 1 : h + 1;
  return (p == 0 ? kn != 0 : fresh) ? v : 0;
}

// a descent block's shared buffers: the delivery bits of MM_KW words
// [kw][r], their witness bytes [j][s], each column's level and the next,
// a count handed to every thread
struct DescentSmem {
  uint32_t a_s[MM_KW][MM_ROWS];
  __align__(16) uint8_t w_s[MM_COLS][MM_WSTRIDE];
  int cur_s[MM_COLS], nxt_s[MM_COLS];
  int n_s;
};

// The tile's live words: those that reach one of its 32-receiver tiles,
// compacted into live[] (returns their number)
__device__ __forceinline__ int tile_live_words(DescentSmem& sm, int* live,
                                               const uint32_t* tany,
                                               int words, int nrt, int r0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rt0 = r0 / WORD, rt1 = min(nrt, rt0 + MM_ROWS / WORD);
  for (int w = tid; w < words; w += MM_THREADS) {
    uint32_t any = 0;
#pragma unroll
    for (int k = 0; k < MM_ROWS / WORD; ++k)   // all loads in flight
      if (rt0 + k < rt1) any |= tany[(size_t)(rt0 + k) * words + w];
    live[w] = any != 0;
  }
  __syncthreads();
  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < words; base += WORD) {
      const int w = base + lane;
      const bool f = w < words && live[w];
      const uint32_t bal = __ballot_sync(0xffffffffu, f);
      __syncwarp();
      if (f) live[cnt + __popc(bal & ((1u << lane) - 1u))] = w;
      cnt += __popc(bal);
      __syncwarp();
    }
    if (lane == 0) sm.n_s = cnt;
  }
  __syncthreads();
  return sm.n_s;
}

__device__ __forceinline__ void zero_acc(int (&acc)[2][8][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0;
}

// acc += the staged delivery bits (a_s) of kws words x their witness
// bytes (w_s): warp w's rows w * 32.., all 64 columns
__device__ __forceinline__ void mma_chunk(const DescentSmem& sm, int kws,
                                          int (&acc)[2][8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, rw = warp * 32;
  for (int kw = 0; kw < kws; ++kw) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint32_t lo = sm.a_s[kw][rw + 16 * mi + g];
      const uint32_t hi = sm.a_s[kw][rw + 16 * mi + g + 8];
      a[mi][0] = nibble_bytes(lo >> (4 * t4));
      a[mi][1] = nibble_bytes(hi >> (4 * t4));
      a[mi][2] = nibble_bytes(lo >> (16 + 4 * t4));
      a[mi][3] = nibble_bytes(hi >> (16 + 4 * t4));
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const uint8_t* wr = &sm.w_s[8 * ni + g][kw * WORD + 4 * t4];
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wr);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wr + 16);
      mma_s8(acc[0][ni], a[0], b0, b1);
      mma_s8(acc[1][ni], a[1], b0, b1);
    }
  }
}

// c += a (16 x 256, b1, row) * b (256 x 8, b1, col): the bits ANDed and
// counted, s32 accumulators
__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the ladder descent's product buffers: BK sender words of delivery bits
// [kw][r] and witness bits [kw][j], rows padded so that a fragment's 32
// reads fall in 32 banks
constexpr int BK = 8;
struct BitsSmem {
  uint32_t a[BK][MM_ROWS + 8];
  uint32_t w[BK][MM_COLS + 8];
};

// acc = d @ witness over the n words of list[], both as bits: per chunk of
// BK words thread tid stages the delivery words of its row (tid) and two
// witness words (column tid % 64, words tid / 64 and tid / 64 + 4); the
// next chunk's loads are in flight while this one multiplies.  One
// m16n8k256 b1 product (AND, popcount) takes the chunk's 256 senders.
__device__ __forceinline__ void bits_product(BitsSmem& sb, const int* list,
                                             int n, const uint32_t* dbits,
                                             const uint32_t* wb, int rn,
                                             int cn, int r0, int j0,
                                             int (&acc)[2][8][4]) {
  static_assert(BK * MM_COLS == 2 * MM_THREADS && MM_ROWS == MM_THREADS,
                "a row and two witness words a thread");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, rw = warp * 32;
  const int bj = tid % MM_COLS, bk = tid / MM_COLS;
  const bool row = r0 + tid < rn, col = j0 + bj < cn;
  uint32_t d[BK], x[2];
  auto load = [&](int c0) {
#pragma unroll
    for (int kw = 0; kw < BK; ++kw)
      d[kw] = c0 + kw < n && row
                  ? dbits[(size_t)list[c0 + kw] * rn + r0 + tid] : 0u;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kw = bk + 4 * e;
      x[e] = c0 + kw < n && col
                 ? wb[(size_t)list[c0 + kw] * cn + j0 + bj] : 0u;
    }
  };
  zero_acc(acc);
  load(0);
  for (int c0 = 0; c0 < n; c0 += BK) {
#pragma unroll
    for (int kw = 0; kw < BK; ++kw) sb.a[kw][tid] = d[kw];
    sb.w[bk][bj] = x[0];
    sb.w[bk + 4][bj] = x[1];
    __syncthreads();
    if (c0 + BK < n) load(c0 + BK);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = rw + 16 * mi + g;
      const uint32_t a0 = sb.a[t4][r], a1 = sb.a[t4][r + 8];
      const uint32_t a2 = sb.a[t4 + 4][r], a3 = sb.a[t4 + 4][r + 8];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        mma_b1(acc[mi][ni], a0, a1, a2, a3, sb.w[t4][8 * ni + g],
               sb.w[t4 + 4][8 * ni + g]);
    }
    __syncthreads();
  }
}

// this thread's cells of tile (r0, j0): rows rw + 16 mi + g + 8 h,
// columns 8 ni + 2 t4 + e, bit (mi * 8 + ni) * 4 + c of an open mask (c =
// 2 h + e), the layout of an mma accumulator; at(mi, ni, c) reaches the
// cell in an output plane through one row pointer a (mi, h), so a store
// takes its column offset as an immediate
__device__ __forceinline__ int cell_row(int c, int mi) {
  const int lane = threadIdx.x & 31;
  return (threadIdx.x >> 5) * 32 + 16 * mi + (lane >> 2) + 8 * (c >> 1);
}
__device__ __forceinline__ int cell_col(int c, int ni) {
  return 8 * ni + 2 * (threadIdx.x & 3) + (c & 1);
}

struct CellRows {
  int32_t* row[2][2];
  __device__ __forceinline__ CellRows(int32_t* plane, int r0, int j0, int rn,
                                      int cn) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        row[mi][h] = plane + (size_t)min(r0 + cell_row(2 * h, mi), rn - 1) *
                                 cn + j0 + cell_col(0, 0);
  }
  __device__ __forceinline__ int32_t& at(int mi, int ni, int c) const {
    return row[mi][c >> 1][8 * ni + (c & 1)];
  }
};

// for each open cell of this thread: if close(mi, ni, c, v) the cell takes
// v and is closed
template <class Close>
__device__ __forceinline__ void close_cells(uint64_t& open,
                                            const CellRows& out,
                                            Close close) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = (mi * 8 + ni) * 4 + c;
        int32_t v;
        if (((open >> i) & 1) && close(mi, ni, c, v)) {
          out.at(mi, ni, c) = v;
          open &= ~(1ull << i);
        }
      }
}

// the bits of an open mask in rows of half mi (mi * 8 + ni) * 4 + c
__device__ __forceinline__ uint64_t row_half(int mi) {
  return mi ? 0xffffffff00000000ull : 0xffffffffull;
}

// the cells whose accumulator is positive
__device__ __forceinline__ uint64_t hit_mask(const int (&acc)[2][8][4]) {
  uint32_t m[2] = {0u, 0u};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        m[mi] |= (uint32_t)(acc[mi][ni][c] > 0) << (ni * 4 + c);
  return (uint64_t)m[1] << 32 | m[0];
}

// the cells of the columns where v (this thread's column 0 of a row of
// 64, as &row[cell_col(0, 0)]) is 0
__device__ __forceinline__ uint64_t col_mask(const int32_t* v) {
  uint32_t m = 0;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (v[8 * ni + e] == 0) m |= 0x5u << (ni * 4 + e);
  return (uint64_t)m << 32 | m;
}

// a warp's staging of 16 rows x 64 columns of an output plane (one half
// mi of its rows), padded so that the 8-byte stores of a fragment and the
// 16-byte reads of a row spread over the banks
constexpr int ST_STRIDE = MM_COLS + 4;
struct StageSmem {
  int32_t v[MM_THREADS / WORD][16][ST_STRIDE];
};

// Store the tile of one plane: each cell by its code (2 bits, code[0] the
// low): 0 is FILL, k + 1 rung k's value less 1 (lad: this thread's column
// 0 of the plane's rungs, as &lad_s[p * LADDER][cell_col(0, 0)]), 3 a
// placeholder the fallback overwrites.  A warp stages half of its rows at
// a time in shared memory and writes them row by row, 16 bytes a lane
// where C % 4 == 0 (vec).
__device__ __forceinline__ void store_codes(StageSmem& stage, int32_t* plane,
                                            int r0, int j0, int rn, int cn,
                                            const uint64_t (&code)[2],
                                            const int32_t* lad, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  int32_t (*st)[ST_STRIDE] = stage.v[warp];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      int32_t val[2][3];   // [e][code], code 3 as FILL
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        val[e][0] = -1;
#pragma unroll
        for (int k = 0; k < LADDER; ++k)
          val[e][k + 1] = lad[k * MM_COLS + 8 * ni + e] - 1;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = (mi * 8 + ni) * 4 + 2 * h;
        int32_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cd = (int)((code[0] >> (i + e)) & 1) |
                         (int)((code[1] >> (i + e)) & 1) << 1;
          v[e] = cd == 1 ? val[e][1] : (cd == 2 ? val[e][2] : -1);
        }
        *reinterpret_cast<int2*>(&st[g + 8 * h][8 * ni + 2 * t4]) =
            make_int2(v[0], v[1]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int idx = it * WORD + lane, rr = idx / 16, cq = idx % 16;
      const int r = r0 + warp * 32 + 16 * mi + rr, j = j0 + 4 * cq;
      if (r >= rn || j >= cn) continue;
      int32_t* o = plane + (size_t)r * cn + j;
      const int4 x = *reinterpret_cast<const int4*>(&st[rr][4 * cq]);
      if (vec && j + 3 < cn) {
        *reinterpret_cast<int4*>(o) = x;
      } else {
        const int32_t xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < cn) o[e] = xs[e];
      }
    }
    __syncwarp();
  }
}

// the tile's cells inside the block (rn x cn)
__device__ __forceinline__ uint64_t tile_cells(int r0, int j0, int rn,
                                               int cn) {
  uint64_t open = 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (r0 + cell_row(c, mi) < rn && j0 + cell_col(c, ni) < cn)
          open |= 1ull << ((mi * 8 + ni) * 4 + c);
  return open;
}

// The per-tile level descent of plane p over the tile's nlive live words
// (K2's, and K1's past the ladder), output shifted back down.  From level
// 0 (resume false): the pre-resolve d @ (v > 0) closes the cells it
// misses as FILL = -1.  Resume: the open cells all have a contributing
// sender below cur_s[j], which the caller set; a probe pass finds the
// next value below it.  Level k: the witness product d @ (v == cur), cur
// being each column's next distinct value below the last among the live
// senders, found in the same pass; the cells it hits first take cur - 1.
// The block stops when none of its cells is open.  SQ: the square block.
template <bool SQ>
__device__ __forceinline__ void descent_levels(
    DescentSmem& sm, const int* live, int nlive, const uint32_t* dbits,
    const uint8_t* known, const int32_t* hb, const int32_t* ts, int32_t* out,
    int rn, int sn, int cn, int now, int t_remove, int r0, int j0, int p,
    uint64_t open, bool resume) {
  if (SQ) { sn = rn; cn = rn; }
  const int tid = threadIdx.x;
  // witness builder: column bj, sender quads bq and bq + 4 of each word
  const int bj = tid & (MM_COLS - 1), bq = tid / MM_COLS;
  const int jb = j0 + bj;
  bool first = !resume, probe = resume;
  const CellRows cells(out, r0, j0, rn, cn);
  for (;;) {
    int acc[2][8][4];
    const int cur = sm.cur_s[bj];
    int nxt = 0;
    // acc = d @ witness over the live words, MM_KW at a time (a probe
    // pass stages them without multiplying)
    zero_acc(acc);
    for (int c0 = 0; c0 < nlive; c0 += MM_KW) {
      for (int i = tid; i < MM_KW * MM_ROWS; i += MM_THREADS) {
        const int kw = i / MM_ROWS, rr = i % MM_ROWS, r = r0 + rr;
        sm.a_s[kw][rr] = (c0 + kw < nlive && r < rn)
                             ? dbits[(size_t)live[c0 + kw] * rn + r] : 0u;
      }
#pragma unroll
      for (int kw = 0; kw < MM_KW; ++kw) {
        // senders 4 bq .. 4 bq + 3 and 4 bq + 16 .. 4 bq + 19 of the word
        // (8 cells, all loads issued before any is used; an index past
        // the plane is clamped and its value masked to 0)
        const bool ok = c0 + kw < nlive && jb < cn;
        const int sw = (ok ? live[c0 + kw] : 0) * WORD + 4 * bq;
        const size_t jc = min(jb, cn - 1);
        uint8_t kn[8];
        int32_t h[8], st[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const size_t o =
              (size_t)min(sw + e + (e & 4) * 3, sn - 1) * cn + jc;
          kn[e] = known[o];
          h[e] = p != 2 ? hb[o] : 0;     // each plane loads what it reads
          st[e] = p != 0 ? ts[o] : 0;
        }
        uint32_t bytes[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int32_t v = (ok && sw + e + (e & 4) * 3 < sn)
              ? payload(p, kn[e], h[e], st[e], now, t_remove) : 0;
          const bool wit = first ? v > 0 : (cur > 0 && v == cur);
          nxt = max(nxt, first ? v : (v < cur ? v : 0));
          bytes[e >> 2] |= (uint32_t)wit << (8 * (e & 3));
        }
        uint8_t* wq = &sm.w_s[bj][kw * WORD + 4 * bq];
        *reinterpret_cast<uint32_t*>(wq) = bytes[0];
        *reinterpret_cast<uint32_t*>(wq + 16) = bytes[1];
      }
      __syncthreads();
      if (!probe) mma_chunk(sm, min(MM_KW, nlive - c0), acc);
      __syncthreads();
    }
    // resolve: level 0 closes the cells it missed (FILL), level k the
    // cells its witnesses hit (cur - 1)
    if (!probe) {
      const int* cur_t = &sm.cur_s[cell_col(0, 0)];
      close_cells(open, cells, [&](int mi, int ni, int c, int32_t& v) {
        const bool hit = acc[mi][ni][c] > 0;
        v = first ? -1 : cur_t[8 * ni + (c & 1)] - 1;
        return first ? !hit : hit;
      });
    }
    atomicMax(&sm.nxt_s[bj], nxt);
    __syncthreads();
    if (tid < MM_COLS) { sm.cur_s[tid] = sm.nxt_s[tid]; sm.nxt_s[tid] = 0; }
    first = probe = false;
    // stop when no cell of the tile is open (or no column has a level
    // left, which cannot happen while a cell is open)
    if (!__syncthreads_or(open != 0)) break;
    if (!__syncthreads_or(tid < MM_COLS && sm.cur_s[tid] > 0)) break;
  }
}

// The per-tile descent of tile (bx, by) (rows 256 bx.., columns 64 by..)
// of plane p from level 0: K2's merge, and K1's for a launch without a
// ladder (use_ladder).  SQ: the square block (S = C = R).
template <bool SQ>
__device__ __forceinline__ void descent_tile(
    const uint32_t* dbits, const uint32_t* tany, const uint8_t* known,
    const int32_t* hb, const int32_t* ts, int32_t* m_all, int32_t* m_fresh,
    int32_t* t_fresh, int rn, int sn, int cn, int words, int now,
    int t_remove, int bx, int by, int p) {
  if (SQ) { sn = rn; cn = rn; }
  extern __shared__ int live[];                   // the tile's live words
  __shared__ DescentSmem sm;
  const int r0 = bx * MM_ROWS, j0 = by * MM_COLS;
  __syncthreads();   // the block's previous tile is done with its buffers
  const int nlive = tile_live_words(sm, live, tany, words, words_for(rn),
                                    r0);
  if (threadIdx.x < MM_COLS) { sm.cur_s[threadIdx.x] = 0;
                               sm.nxt_s[threadIdx.x] = 0; }
  __syncthreads();
  descent_levels<SQ>(sm, live, nlive, dbits, known, hb, ts,
                     p == 0 ? m_all : (p == 1 ? m_fresh : t_fresh), rn, sn,
                     cn, now, t_remove, r0, j0, p,
                     tile_cells(r0, j0, rn, cn), false);
}

// grid (row tiles, column tiles, 3 B): plane blockIdx.z % 3 of lane
// blockIdx.z / 3 (B = 1 solo), for a launch without a ladder; every lane
// reads its own scratch
template <bool SQ>
__global__ void __launch_bounds__(MM_THREADS, 2)
masked_max3_plane_kernel(const uint32_t* __restrict__ scratch,
                   const uint8_t* __restrict__ known,
                   const int32_t* __restrict__ hb,
                   const int32_t* __restrict__ ts,
                   int32_t* __restrict__ m_all, int32_t* __restrict__ m_fresh,
                   int32_t* __restrict__ t_fresh, size_t lane_words, int rn,
                   int sn, int cn, int words, int now, int t_remove) {
  if (SQ) { sn = rn; cn = rn; }
  const size_t lane = blockIdx.z / 3;
  const size_t o = lane * (size_t)sn * cn, q = lane * (size_t)rn * cn;
  const uint32_t* dbits = scratch + lane * lane_words;
  descent_tile<SQ>(dbits, dbits + (size_t)words * rn, known + o, hb + o,
                   ts + o, m_all + q, m_fresh + q, t_fresh + q, rn, sn, cn,
                   words, now, t_remove, blockIdx.x, blockIdx.y,
                   blockIdx.z % 3);
}

// the fallback of masked_max3_kernel, out of line: it runs rarely, and
// its registers stay off the kernel's main path
template <bool SQ>
__device__ __noinline__ void descent_fallback(
    DescentSmem& sm, const int* live, int nlive, const uint32_t* dbits,
    const uint8_t* known, const int32_t* hb, const int32_t* ts, int32_t* out,
    int rn, int sn, int cn, int now, int t_remove, int r0, int j0, int p,
    uint64_t open) {
  descent_levels<SQ>(sm, live, nlive, dbits, known, hb, ts, out, rn, sn, cn,
                     now, t_remove, r0, j0, p, open, true);
}

// The static shared memory of a ladder tile (masked_max3_kernel,
// merge_epilogue_kernel): the products, the fallback and the kernel's own
// output pass (Out) take turns in u; the tile's rungs, word masks, list
// lengths and rows' proc stay
template <class Out>
struct LadderSmem {
  union {
    BitsSmem bits;
    Out out;
    DescentSmem descent;
  } u;
  int32_t lad_s[3 * LADDER][MM_COLS];
  uint32_t any_s[NBP][WANY_MAX];
  int np_s[NBP];
  uint8_t row_s[MM_ROWS];
};

// The ladder descent of one tile (rows r0.., columns j0..) of one lane,
// its three planes in order.  A receiver that does not consume this tick
// (proc 0) has no delivery: its row is FILL at once.  Per plane: the rung
// products d @ (v == lad[k]) in order (a cell hit first takes lad[k] - 1),
// each over the live words with a witness in the tile's columns (none:
// skipped); the open cells of a column whose last rung is 0 (its ladder
// holds every value) are FILL; level 0 d @ (v > 0) closes the cells it
// misses as FILL; a tile with cells still open falls back to
// descent_levels from below the last rung.  Every load the setup needs
// (the tile's live words, the rows' proc, the rungs and the word masks) is
// in flight at once, and each bit-plane's word list is built once.
// codes(p, code) takes each plane's cell codes (2 bits, code[0] the low: 0
// FILL, k + 1 rung k, 3 left to the fallback) before the fallback writes
// the value of each code-3 cell into fb[p] (an R x C plane).  dbits is the
// lane's merge scratch; proc, known, hb and ts are the lane's.  Returns
// the plane descents that fell back.
template <bool SQ, class Out, class Codes>
__device__ __forceinline__ int ladder_tile(
    LadderSmem<Out>& ls, int* live, const uint32_t* dbits,
    const uint8_t* proc, const uint8_t* known, const int32_t* hb,
    const int32_t* ts, int32_t* const (&fb)[3], int rn, int sn, int cn,
    int words, int now, int t_remove, int r0, int j0, Codes codes) {
  if (SQ) { sn = rn; cn = rn; }
  DescentSmem& sm = ls.u.descent;
  BitsSmem& sb = ls.u.bits;
  auto& lad_s = ls.lad_s;
  auto& any_s = ls.any_s;
  auto& np_s = ls.np_s;
  auto& row_s = ls.row_s;
  const LadderPtrs l = ladder_ptrs(const_cast<uint32_t*>(dbits), rn, sn, cn);
  const int tid = threadIdx.x, lane_id = tid & 31, warp = tid >> 5;
  const int strips = (cn + LD_COLS - 1) / LD_COLS, wwords = words_for(words);
  const int ls0 = j0 / MM_COLS * LD_PER_TILE;
  const int nls = min(strips - ls0, LD_PER_TILE);
  // the rows' proc, the tile's rungs and word masks (the strips' OR)
  row_s[tid] = r0 + tid < rn && proc[r0 + tid];
  for (int i = tid; i < 3 * LADDER * MM_COLS; i += MM_THREADS) {
    const int pk = i / MM_COLS, c = i % MM_COLS, j = j0 + c;
    lad_s[pk][c] = j < cn ? l.lad[(size_t)pk * cn + j] : 0;
  }
  for (int i = tid; i < NBP * wwords; i += MM_THREADS) {
    const int bp = i / wwords, ww = i % wwords;
    uint32_t any = 0;
#pragma unroll
    for (int k = 0; k < LD_PER_TILE; ++k)
      if (k < nls)
        any |= l.wany[((size_t)bp * strips + ls0 + k) * wwords + ww];
    any_s[bp][ww] = any;
  }
  const int nlive = tile_live_words(sm, live, dbits + (size_t)words * rn,
                                    words, words_for(rn), r0);
  // each bit-plane's list: the live words with a witness in the tile
  for (int bp = warp; bp < NBP; bp += MM_THREADS / WORD) {
    int* list = live + (1 + bp) * words;
    int cnt = 0;
    for (int base = 0; base < nlive; base += WORD) {
      const int k = base + lane_id;
      const int w = k < nlive ? live[k] : 0;
      const bool f = k < nlive && ((any_s[bp][w / WORD] >> (w % WORD)) & 1u);
      const uint32_t bal = __ballot_sync(0xffffffffu, f);
      if (f) list[cnt + __popc(bal & ((1u << lane_id) - 1u))] = w;
      cnt += __popc(bal);
    }
    if (lane_id == 0) np_s[bp] = cnt;
  }
  __syncthreads();
  // the cells of rows that consume this tick are open; the others FILL
  const uint64_t cells = tile_cells(r0, j0, rn, cn);
  uint64_t open0 = cells;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (!row_s[cell_row(2 * h, mi)])
        open0 &= ~(0x3333333333333333ull << (2 * h) & row_half(mi));
  // acc = the product of bit-plane bp over its list (false, acc untouched:
  // the list is empty)
  auto product = [&](int bp, int (&acc)[2][8][4]) -> bool {
    if (np_s[bp] == 0) return false;
    bits_product(sb, live + (1 + bp) * words, np_s[bp], dbits,
                 l.wbits + (size_t)bp * words * cn, rn, cn, r0, j0, acc);
    return true;
  };
  int fallbacks = 0;
  for (int p = 0; p < 3; ++p) {
    static_assert(LADDER + 2 <= 4, "two code bits a cell");
    uint64_t open = open0, code[2] = {0, 0};
    int acc[2][8][4];
    for (int k = 0; k < LADDER; ++k) {
      if (!__syncthreads_or(open != 0)) break;
      if (!product(bp_rung(p, k), acc)) continue;
      const uint64_t hit = hit_mask(acc) & open;
      if ((k + 1) & 1) code[0] |= hit;
      if ((k + 1) & 2) code[1] |= hit;
      open &= ~hit;
    }
    // FILL: the open cells of a column whose ladder holds every value
    // (no contributor can be left), then those level 0 misses
    open &= ~col_mask(&lad_s[p * LADDER + LADDER - 1][cell_col(0, 0)]);
    if (__syncthreads_or(open != 0))
      open &= product(bp_level0(p), acc) ? hit_mask(acc) : 0;
    const bool fall = __syncthreads_or(open != 0);
    code[0] |= open;
    code[1] |= open;
    codes(p, code);
    if (fall) {
      ++fallbacks;
      __syncthreads();   // cur_s / nxt_s overlay what codes() may have read
      if (tid < MM_COLS) {
        sm.cur_s[tid] = lad_s[p * LADDER + LADDER - 1][tid];
        sm.nxt_s[tid] = 0;
      }
      __syncthreads();
      descent_fallback<SQ>(sm, live, nlive, dbits, known, hb, ts, fb[p], rn,
                           sn, cn, now, t_remove, r0, j0, p, open);
    }
    __syncthreads();   // the next plane's products reuse the buffers
  }
  return fallbacks;
}

// K1's descent on the ladder, the maxima written out: grid (row tiles,
// column tiles, B), one block a tile of lane blockIdx.z running its three
// planes (ladder_tile), each plane's codes stored as values (store_codes,
// the fallback's placeholders as FILL) before the fallback overwrites its
// cells.  counts (may be null): per lane counts[lane * cstride] += 3 (the
// plane descents) and counts[lane * cstride + 1] += the plane descents
// that fell back.
template <bool SQ>
__global__ void __launch_bounds__(MM_THREADS, 2)
masked_max3_kernel(uint32_t* __restrict__ scratch,
                   const uint8_t* __restrict__ proc,
                   const uint8_t* __restrict__ known,
                   const int32_t* __restrict__ hb,
                   const int32_t* __restrict__ ts,
                   int32_t* __restrict__ m_all, int32_t* __restrict__ m_fresh,
                   int32_t* __restrict__ t_fresh, size_t lane_words, int rn,
                   int sn, int cn, int words, int now, int t_remove,
                   unsigned long long* __restrict__ counts, int cstride) {
  if (SQ) { sn = rn; cn = rn; }
  // live words, then each bit-plane's word list
  extern __shared__ int live[];
  __shared__ LadderSmem<StageSmem> ls;
  const size_t lane = blockIdx.z;
  const size_t o = lane * (size_t)sn * cn, q = lane * (size_t)rn * cn;
  const int r0 = blockIdx.x * MM_ROWS, j0 = blockIdx.y * MM_COLS;
  int32_t* const out[3] = {m_all + q, m_fresh + q, t_fresh + q};
  const int fallbacks = ladder_tile<SQ>(
      ls, live, scratch + lane * lane_words, proc + lane * rn, known + o,
      hb + o, ts + o, out, rn, sn, cn, words, now, t_remove, r0, j0,
      [&](int p, const uint64_t (&code)[2]) {
        store_codes(ls.u.out, out[p], r0, j0, rn, cn, code,
                    &ls.lad_s[p * LADDER][cell_col(0, 0)], cn % 4 == 0);
      });
  if (counts && threadIdx.x == 0) {
    atomicAdd(&counts[lane * cstride], 3ull);
    if (fallbacks) atomicAdd(&counts[lane * cstride + 1],
                             (unsigned long long)fallbacks);
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

// four consecutive cells from column j (lim = n - j of them exist): one
// 16-byte / 4-byte access when VEC (N % 4 == 0), else masked scalars
template <bool VEC>
__device__ __forceinline__ void ld4(const int32_t* p, size_t o, int lim,
                                    int32_t (&v)[4]) {
  if (VEC) {
    const int4 x = *reinterpret_cast<const int4*>(p + o);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < lim ? p[o + e] : 0;
  }
}

template <bool VEC>
__device__ __forceinline__ uint32_t ld4b(const uint8_t* p, size_t o,
                                         int lim) {
  if (VEC) return *reinterpret_cast<const uint32_t*>(p + o);
  uint32_t v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < lim) v |= (uint32_t)p[o + e] << (8 * e);
  return v;
}

template <bool VEC>
__device__ __forceinline__ void st4(int32_t* p, size_t o, int lim,
                                    const int32_t (&v)[4]) {
  if (VEC) {
    *reinterpret_cast<int4*>(p + o) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < lim) p[o + e] = v[e];
  }
}

template <bool VEC>
__device__ __forceinline__ void st4b(uint8_t* p, size_t o, int lim,
                                     uint32_t v) {
  if (VEC) {
    *reinterpret_cast<uint32_t*>(p + o) = v;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < lim) p[o + e] = (v >> (8 * e)) & 0xFFu;
  }
}

__device__ __forceinline__ bool byte_of(uint32_t v, int e) {
  return (v >> (8 * e)) & 0xFFu;
}

// One block owns a 32-row x 128-column tile: warp w takes rows w, w + 8,
// w + 16, w + 24, lane l columns 4 l .. 4 l + 3.  known/hb/ts may alias
// their outputs (each cell reads only itself); gossip must not (the
// transposed read looks at other rows).  The tile's counts are added
// onto sent_row/recv_row.
template <bool VEC>
__device__ __forceinline__ void epilogue_tile(
    const int32_t* m_all, const int32_t* m_fresh, const int32_t* t_fresh,
    const uint8_t* gossip, const uint8_t* proc, const uint8_t* known,
    const int32_t* hb, const int32_t* ts, const uint8_t* gdrop,
    const uint8_t* ops, const uint8_t* jrep, const uint8_t* jreq,
    const uint8_t* hold, uint8_t* known_o, int32_t* hb_o, int32_t* ts_o,
    uint8_t* gossip_o, int32_t* sent_row, int32_t* recv_row,
    uint8_t* added_o, uint8_t* removed_o, int n, int t, int t_remove,
    int bx, int by) {
  __shared__ __align__(16) uint8_t gT[EP_ROWS][EP_COLS];  // gossip[j, r]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = bx * EP_COLS, r0 = by * EP_ROWS;
  __syncthreads();   // the block's previous tile is done with gT
  // stage gossip[j0 + jj, r0 .. r0 + 31]: 8 threads a sender row, 4 bytes
  // each, transposed into gT[r][j]
  for (int i = tid; i < EP_COLS * (EP_ROWS / 4); i += EP_THREADS) {
    const int jj = i >> 3, q = i & 7, j = j0 + jj, r = r0 + 4 * q;
    const uint32_t v =
        (j < n && r < n) ? ld4b<VEC>(gossip, (size_t)j * n + r, n - r) : 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) gT[4 * q + e][jj] = (v >> (8 * e)) & 0xFFu;
  }
  __syncthreads();
  const int jl = 4 * lane, j = j0 + jl, lim = n - j;
  uint32_t jreq_c = 0, hold_c = 0;
  if (j < n) {
    jreq_c = ld4b<VEC>(jreq, j, lim);
    hold_c = ld4b<VEC>(hold, j, lim);
  }
#pragma unroll
  for (int k = 0; k < EP_ROWS / 8; ++k) {
    const int rr = warp + 8 * k, r = r0 + rr;      // uniform in the warp
    if (r >= n) break;
    int sent = 0, recv = 0;
    if (j < n) {
      const bool ops_r = ops[r], jrep_r = jrep[r], proc_r = proc[r];
      const size_t o = (size_t)r * n + j;
      int32_t ma[4], mf[4], tf[4], h0[4], s0[4], h1[4], s1[4];
      ld4<VEC>(m_all, o, lim, ma);
      ld4<VEC>(m_fresh, o, lim, mf);
      ld4<VEC>(t_fresh, o, lim, tf);
      ld4<VEC>(hb, o, lim, h0);
      ld4<VEC>(ts, o, lim, s0);
      const uint32_t kn = ld4b<VEC>(known, o, lim);
      const uint32_t gs = ld4b<VEC>(gossip, o, lim);
      const uint32_t gd = ld4b<VEC>(gdrop, o, lim);
      const uint32_t gt = *reinterpret_cast<const uint32_t*>(&gT[rr][jl]);
      uint32_t ko = 0, go = 0, ao = 0, ro = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool dfull = byte_of(gt, e) && proc_r;
        const CellOut c = cell_rule(
            r, j + e, t, t_remove, ma[e], mf[e], tf[e], dfull, byte_of(kn, e),
            h0[e], s0[e], byte_of(gs, e), byte_of(gd, e), ops_r, jrep_r,
            byte_of(jreq_c, e), byte_of(hold_c, e));
        h1[e] = c.hb;
        s1[e] = c.ts;
        ko |= (uint32_t)c.known << (8 * e);
        go |= (uint32_t)c.gossip << (8 * e);
        ao |= (uint32_t)c.added << (8 * e);
        ro |= (uint32_t)c.removed << (8 * e);
        if (e < lim) { sent += c.gsent; recv += dfull; }
      }
      st4<VEC>(hb_o, o, lim, h1);
      st4<VEC>(ts_o, o, lim, s1);
      st4b<VEC>(known_o, o, lim, ko);
      st4b<VEC>(gossip_o, o, lim, go);
      if (added_o) {
        st4b<VEC>(added_o, o, lim, ao);
        st4b<VEC>(removed_o, o, lim, ro);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sent += __shfl_down_sync(0xffffffffu, sent, off);
      recv += __shfl_down_sync(0xffffffffu, recv, off);
    }
    if (lane == 0) {
      if (sent) atomicAdd(&sent_row[r], sent);
      if (recv) atomicAdd(&recv_row[r], recv);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(EP_THREADS)
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
                     int n, int t, int t_remove) {
  // lane blockIdx.z of a fleet (B = 1 solo): its planes, vectors and rows
  const size_t lane = blockIdx.z, o = lane * n * (size_t)n, v = lane * n;
  epilogue_tile<VEC>(m_all + o, m_fresh + o, t_fresh + o, gossip + o,
                     proc + v, known + o, hb + o, ts + o, gdrop + o, ops + v,
                     jrep + v, jreq + v, hold + v, known_o + o, hb_o + o,
                     ts_o + o, gossip_o + o, sent_row + v, recv_row + v,
                     added_o ? added_o + o : nullptr,
                     removed_o ? removed_o + o : nullptr, n, t, t_remove,
                     blockIdx.x, blockIdx.y);
}

// merge_epilogue_kernel's output pass: each cell's three 2-bit codes as
// one byte (plane p at bits 2p, 2p + 1), the tile's two delivery words of
// each row (dw[k][rr]: bit i is d[r0 + rr, j0 + 32 k + i]) and the rows'
// ops / jrep.  A row of codes takes 68 bytes (17 words), so the 2-byte
// writes of a fragment fall in 32 banks; dw's second row starts 8 banks
// on, so that the four words two neighbouring rows read do too.
constexpr int CS_STRIDE = MM_COLS + 4;
struct EpiSmem {
  __align__(16) uint8_t code[MM_ROWS][CS_STRIDE];
  uint32_t dw[MM_COLS / WORD][MM_ROWS + 8];
  uint8_t ops[MM_ROWS], jrep[MM_ROWS];
};

// The epilogue's inputs of EPC rows of a tile (hb, ts: 16 bytes a 4-column
// quad; known, gossip, gdrop: 4), copied in by cp.async without registers:
// EP_STAGES chunks in flight, the first ones issued before the descent so
// that they land while it runs.  On the bench's B=8 ticks two 32-row
// stages beat loads into registers (0.73 against 0.78 ms a launch); three
// stages or 16-row chunks read no better, and four 32-row stages leave
// one block an SM (PERF.md).
constexpr int EPC = 32;
constexpr int EP_STAGES = 2;
constexpr int EP_QUADS = MM_COLS / 4;
struct EpiStage {
  int4 hb[EPC][EP_QUADS], ts[EPC][EP_QUADS];
  uint32_t kn[EPC][EP_QUADS], gs[EPC][EP_QUADS], gd[EPC][EP_QUADS];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the dynamic shared memory of merge_epilogue_kernel: the word lists, then
// (VEC) the epilogue's stages, 16-byte aligned
__host__ __device__ inline size_t fused_lists_bytes(int words) {
  return ((size_t)words * sizeof(int) * (1 + NBP) + 15) / 16 * 16;
}
__host__ __device__ inline size_t fused_smem(int words, bool vec) {
  return fused_lists_bytes(words) + (vec ? EP_STAGES * sizeof(EpiStage) : 0);
}

// K1 on the ladder: the merge's descent and the tick's cell rules in one
// launch, grid (row tiles, column tiles, B), one block a 256 x 64 tile of
// lane blockIdx.z.  The tile's descent (ladder_tile) keeps each plane's
// codes in registers, and a tile that falls back past the ladder writes
// those cells' values into the lane's fallback planes (3 [N, N] i32, read
// back by this block alone).  The codes then cross shared memory as one
// byte a cell, and each half-warp takes a row of the tile, 4 columns a
// lane: the maxima decoded against the tile's rungs, dfull read from the
// prep's delivery bits (no transposed gossip read), cell_rule, the
// outputs written, the row's sent / recv counts added with one atomic a
// row and block onto the seeded rows.  A cell moves 21 bytes (hb / ts,
// known and gossip in and out, gdrop in) where the masked_max3 and
// tick_epilogue pair moves 46: the three maxima never reach HBM.  Where N
// % 4 == 0 (VEC) the inputs come in by cp.async, 32-row chunks, the first
// EP_STAGES issued before the descent: the descent keeps this block's
// registers busy (two blocks an SM), so its loads could not be many in
// flight.  counts as masked_max3_kernel's.
template <bool VEC>
__global__ void __launch_bounds__(MM_THREADS, 2)
merge_epilogue_kernel(
    uint32_t* __restrict__ scratch, const uint8_t* __restrict__ gossip,
    const uint8_t* __restrict__ proc, const uint8_t* __restrict__ known,
    const int32_t* __restrict__ hb, const int32_t* __restrict__ ts,
    const uint8_t* __restrict__ gdrop, const uint8_t* __restrict__ ops,
    const uint8_t* __restrict__ jrep, const uint8_t* __restrict__ jreq,
    const uint8_t* __restrict__ hold, uint8_t* __restrict__ known_o,
    int32_t* __restrict__ hb_o, int32_t* __restrict__ ts_o,
    uint8_t* __restrict__ gossip_o, int32_t* __restrict__ sent_row,
    int32_t* __restrict__ recv_row, uint8_t* __restrict__ added_o,
    uint8_t* __restrict__ removed_o, int32_t* fallback, size_t lane_words,
    int n, int words, int t, int t_remove,
    unsigned long long* __restrict__ counts, int cstride) {
  // live words, then each bit-plane's word list, then the stages
  extern __shared__ __align__(16) uint8_t fused_dyn[];
  int* live = reinterpret_cast<int*>(fused_dyn);
  __shared__ LadderSmem<EpiSmem> ls;
  EpiSmem& es = ls.u.out;
  EpiStage* stage =
      reinterpret_cast<EpiStage*>(fused_dyn + fused_lists_bytes(words));
  const size_t lane = blockIdx.z, nn = (size_t)n * n;
  const size_t o = lane * nn, v = lane * n;
  const uint32_t* dbits = scratch + lane * lane_words;
  // written by descent_fallback and read after a barrier: plain pointers
  int32_t* const fb[3] = {fallback + 3 * o, fallback + 3 * o + nn,
                          fallback + 3 * o + 2 * nn};
  const int tid = threadIdx.x, lane_id = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * MM_ROWS, j0 = blockIdx.y * MM_COLS;
  constexpr int NCH = MM_ROWS / EPC;
  // chunk c's inputs into stage s, a 4-column quad inside the block at a
  // time (N % 4 == 0)
  auto stage_in = [&](int c, int s) {
#pragma unroll
    for (int i = tid; i < EPC * EP_QUADS; i += MM_THREADS) {
      const int rl = i / EP_QUADS, qd = i % EP_QUADS;
      const int r = r0 + c * EPC + rl, j = j0 + 4 * qd;
      if (r >= n || j >= n) continue;
      const size_t a = o + (size_t)r * n + j;
      EpiStage& st = stage[s];
      cp_async16(&st.hb[rl][qd], hb + a);
      cp_async16(&st.ts[rl][qd], ts + a);
      cp_async4(&st.kn[rl][qd], known + a);
      cp_async4(&st.gs[rl][qd], gossip + a);
      cp_async4(&st.gd[rl][qd], gdrop + a);
    }
  };
  if (VEC) {
#pragma unroll
    for (int c = 0; c < EP_STAGES; ++c) {
      stage_in(c, c);
      cp_commit();
    }
  }
  uint64_t cd[3][2] = {};
  const int fallbacks = ladder_tile<true>(
      ls, live, dbits, proc + v, known + o, hb + o, ts + o, fb, n, n, n,
      words, t, t_remove, r0, j0, [&](int p, const uint64_t (&code)[2]) {
#pragma unroll
        for (int k = 0; k < 3; ++k)   // constant indices: cd stays in regs
          if (k == p) { cd[k][0] = code[0]; cd[k][1] = code[1]; }
      });
  if (counts && tid == 0) {
    atomicAdd(&counts[lane * cstride], 3ull);
    if (fallbacks) atomicAdd(&counts[lane * cstride + 1],
                             (unsigned long long)fallbacks);
  }
  // ladder_tile ended on a barrier: the union is free for the codes
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = (mi * 8 + ni) * 4 + 2 * h;
        uint32_t b2 = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int p = 0; p < 3; ++p)
            b2 |= (uint32_t)(((cd[p][0] >> (i + e)) & 1u) |
                             ((cd[p][1] >> (i + e)) & 1u) << 1)
                  << (8 * e + 2 * p);
        *reinterpret_cast<uint16_t*>(
            &es.code[cell_row(2 * h, mi)][cell_col(0, ni)]) = (uint16_t)b2;
      }
  for (int i = tid; i < (MM_COLS / WORD) * MM_ROWS; i += MM_THREADS) {
    const int k = i / MM_ROWS, rr = i % MM_ROWS, r = r0 + rr;
    const int w = j0 / WORD + k;
    es.dw[k][rr] = r < n && w < words ? dbits[(size_t)w * n + r] : 0u;
  }
  static_assert(MM_ROWS == MM_THREADS, "a row's lanes a thread");
  es.ops[tid] = r0 + tid < n && ops[v + r0 + tid];
  es.jrep[tid] = r0 + tid < n && jrep[v + r0 + tid];
  __syncthreads();
  // each half-warp a row, lane qc of the half columns 4 qc .. 4 qc + 3
  const int half = lane_id >> 4, qc = lane_id & 15;
  const int jl = 4 * qc, j = j0 + jl, lim = n - j;
  uint32_t jreq_c = 0, hold_c = 0;
  if (j < n) {
    jreq_c = ld4b<VEC>(jreq + v, j, lim);
    hold_c = ld4b<VEC>(hold + v, j, lim);
  }
  // row rr of the tile from its inputs: the cell rules, the outputs, and
  // the row's counts onto the seeded rows
  auto row = [&](int rr, const int32_t (&h0)[4], const int32_t (&s0)[4],
                 uint32_t kn, uint32_t gs, uint32_t gd) {
    const int r = r0 + rr;
    int sent = 0, recv = 0;
    if (r < n && j < n) {
      const size_t oc = o + (size_t)r * n + j;
      const uint32_t cw =
          *reinterpret_cast<const uint32_t*>(&es.code[rr][jl]);
      const uint32_t dw = es.dw[qc >> 3][rr] >> (jl % WORD);
      const bool ops_r = es.ops[rr], jrep_r = es.jrep[rr];
      int32_t h1[4], s1[4];
      uint32_t ko = 0, go = 0, ao = 0, ro = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int32_t m[3];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const int k = (cw >> (8 * e + 2 * p)) & 3u;
          m[p] = k == 0 ? -1
                        : (k == 3 ? fb[p][(size_t)r * n + j + e]
                                  : ls.lad_s[p * LADDER + k - 1][jl + e] - 1);
        }
        const bool dfull = (dw >> e) & 1u;
        const CellOut c = cell_rule(
            r, j + e, t, t_remove, m[0], m[1], m[2], dfull, byte_of(kn, e),
            h0[e], s0[e], byte_of(gs, e), byte_of(gd, e), ops_r, jrep_r,
            byte_of(jreq_c, e), byte_of(hold_c, e));
        h1[e] = c.hb;
        s1[e] = c.ts;
        ko |= (uint32_t)c.known << (8 * e);
        go |= (uint32_t)c.gossip << (8 * e);
        ao |= (uint32_t)c.added << (8 * e);
        ro |= (uint32_t)c.removed << (8 * e);
        if (e < lim) { sent += c.gsent; recv += dfull; }
      }
      st4<VEC>(hb_o, oc, lim, h1);
      st4<VEC>(ts_o, oc, lim, s1);
      st4b<VEC>(known_o, oc, lim, ko);
      st4b<VEC>(gossip_o, oc, lim, go);
      if (added_o) {
        st4b<VEC>(added_o, oc, lim, ao);
        st4b<VEC>(removed_o, oc, lim, ro);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      sent += __shfl_down_sync(0xffffffffu, sent, off, 16);
      recv += __shfl_down_sync(0xffffffffu, recv, off, 16);
    }
    if (qc == 0 && r < n) {
      if (sent) atomicAdd(&sent_row[v + r], sent);
      if (recv) atomicAdd(&recv_row[v + r], recv);
    }
  };
  if (VEC) {
    // chunk c: wait for its copies (one group a chunk, committed in
    // order, empty past the last), take its rows from the stage, then
    // refill the stage with chunk c + EP_STAGES
    for (int c = 0; c < NCH; ++c) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(EP_STAGES - 1)
                   : "memory");
      __syncthreads();
      const EpiStage& st = stage[c % EP_STAGES];
#pragma unroll
      for (int k = 0; k < EPC / 16; ++k) {
        // a warp's halves on neighbouring rows: the byte planes' reads of
        // the two rows fall in 32 banks
        const int rl = 16 * k + 2 * warp + half;
        const int4 hq = st.hb[rl][qc], sq = st.ts[rl][qc];
        const int32_t h0[4] = {hq.x, hq.y, hq.z, hq.w};
        const int32_t s0[4] = {sq.x, sq.y, sq.z, sq.w};
        row(c * EPC + rl, h0, s0, st.kn[rl][qc], st.gs[rl][qc],
            st.gd[rl][qc]);
      }
      __syncthreads();
      if (c + EP_STAGES < NCH) stage_in(c + EP_STAGES, c % EP_STAGES);
      cp_commit();
    }
  } else {
    // N % 4 != 0: no aligned quads; each half-warp loads its row
#pragma unroll 2
    for (int it = 0; it < MM_ROWS / 16; ++it) {
      const int rr = 16 * it + 2 * warp + half;
      int32_t h0[4] = {}, s0[4] = {};
      uint32_t kn = 0, gs = 0, gd = 0;
      if (r0 + rr < n && j < n) {
        const size_t oc = o + (size_t)(r0 + rr) * n + j;
        ld4<VEC>(hb, oc, lim, h0);
        ld4<VEC>(ts, oc, lim, s0);
        kn = ld4b<VEC>(known, oc, lim);
        gs = ld4b<VEC>(gossip, oc, lim);
        gd = ld4b<VEC>(gdrop, oc, lim);
      }
      row(rr, h0, s0, kn, gs, gd);
    }
  }
}

// One peer's decisions at tick t (ops/vector.py vector_step, in its
// order): peer i with its schedule column start, its fail and restart
// flags this tick, its state lanes, its JOINREQ / JOINREP drop draws and
// the introducer's gates proc0 / failed0.  K2's vector step and the K1
// route's vector_step_kernel both apply it, so the rules cannot drift apart.
struct PeerStep {
  bool proc, hold, jreq, jrep, ops, in_group, joinreq, joinrep;
  bool joinreq_sent, joinrep_sent;
  int32_t own_hb;
};

__device__ __forceinline__ PeerStep peer_step(int i, int t, int32_t start,
                                              bool failed, bool rejoining,
                                              bool in_group, int32_t own_hb,
                                              bool joinreq, bool joinrep,
                                              bool qdrop, bool pdrop,
                                              bool proc0, bool failed0) {
  PeerStep s;
  // recvLoop/nodeLoop gate; a rejoining peer restarts from a fresh nodeStart
  s.proc = t > start && !failed;
  const bool in_group0 = in_group && !rejoining;
  const int32_t own_hb0 = rejoining ? 0 : own_hb;
  // the join traffic consumed this tick
  s.jreq = joinreq && proc0;
  s.jrep = joinrep && s.proc;
  const bool starting = t == start || rejoining;
  s.in_group = in_group0 || s.jrep || (starting && i == 0);
  s.ops = s.proc && s.in_group;
  s.own_hb = own_hb0 + s.ops;
  // ENsend drop injection; undelivered messages stay in flight while
  // their receiver is not processing
  s.joinreq_sent = starting && i != 0 && !qdrop;
  s.joinrep_sent = s.jreq && !pdrop;
  s.hold = !s.proc && !failed;
  s.joinreq = s.joinreq_sent || (joinreq && !proc0 && !failed0);
  s.joinrep = s.joinrep_sent || (joinrep && s.hold);
  return s;
}

// K2's per-tick vector step (ops/pallas/dense_mega.py:146-207 and the
// accounting of :267-282), run by one block: updates aux in place, writes
// the lanes the matrix phases read, and seeds this tick's sent/recv rows
// with the join traffic (the epilogue adds the gossip counts).
__device__ __forceinline__ void vec_rows(int32_t* aux, const uint8_t* qdrop,
                                         const uint8_t* pdrop, uint8_t* vec,
                                         int32_t* sent_s, int32_t* recv_s,
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
    const int32_t rejoin = a[A_REJOIN];
    const bool failed = t > a[A_FAIL] && t <= rejoin;
    const bool rejoining = can_rejoin && t == rejoin;
    const PeerStep p = peer_step(i, t, a[A_START], failed, rejoining,
                                 a[A_IN_GROUP] > 0, a[A_OWN_HB],
                                 a[A_JOINREQ] > 0, a[A_JOINREP] > 0,
                                 qdrop[i], pdrop[i], proc0, failed0);
    a[A_IN_GROUP] = p.in_group;
    a[A_OWN_HB] = p.own_hb;
    a[A_JOINREQ] = p.joinreq;
    a[A_JOINREP] = p.joinrep;
    vec[V_PROC * n + i] = p.proc;
    vec[V_OPS * n + i] = p.ops;
    vec[V_JREP * n + i] = p.jrep;
    vec[V_JREQ * n + i] = p.jreq;
    vec[V_HOLD * n + i] = p.hold;
    vec[V_REJOIN * n + i] = rejoining;
    sent_s[i] = p.joinreq_sent;
    recv_s[i] = p.jrep;
    my_rep += p.joinrep_sent;
    my_req += p.jreq;
  }
  atomicAdd(&rep_total, my_rep);
  atomicAdd(&req_total, my_req);
  __syncthreads();
  if (threadIdx.x == 0) { sent_s[0] += rep_total; recv_s[0] += req_total; }
}

// The K1 route's vector step (ops/vector.py fused_vector_step): one block a
// lane (blockIdx.x), its threads striding over the N peers.  The schedule
// columns, state lanes and draws are [B, N]; the outputs are the bytes
// out[S_*][B][N] and the words iout[I_*][B][N].  The rows sent / recv get
// the join traffic, the introducer's two sums added by a block reduction;
// the epilogue then adds the gossip counts onto them.  CHURN: a peer
// rejoins at its rejoin tick; FLAP: flap_down / flap_up ([B, N], the flap
// world's down phase and up-edge at t) add to the failures and rejoins.
template <bool CHURN, bool FLAP>
__global__ void __launch_bounds__(VS_THREADS)
vector_step_kernel(const int32_t* __restrict__ start,
                   const int32_t* __restrict__ fail,
                   const int32_t* __restrict__ rejoin,
                   const uint8_t* __restrict__ in_group,
                   const int32_t* __restrict__ own_hb,
                   const uint8_t* __restrict__ joinreq,
                   const uint8_t* __restrict__ joinrep,
                   const uint8_t* __restrict__ qdrop,
                   const uint8_t* __restrict__ pdrop,
                   const uint8_t* __restrict__ flap_down,
                   const uint8_t* __restrict__ flap_up,
                   uint8_t* __restrict__ out, int32_t* __restrict__ iout,
                   int n, int t) {
  __shared__ int rep_s[VS_THREADS / 32], req_s[VS_THREADS / 32];
  const size_t v = (size_t)blockIdx.x * n, plane = (size_t)gridDim.x * n;
  // the introducer's gates
  bool failed0 = t > fail[v] && t <= rejoin[v];
  if (FLAP) failed0 = failed0 || flap_down[v];
  const bool proc0 = t > start[v] && !failed0;
  int my_rep = 0, my_req = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t o = v + i;
    bool failed = t > fail[o] && t <= rejoin[o];
    if (FLAP) failed = failed || flap_down[o];
    bool rejoining = CHURN && rejoin[o] == t;
    if (FLAP) rejoining = rejoining || flap_up[o];
    const PeerStep p = peer_step(i, t, start[o], failed, rejoining,
                                 in_group[o], own_hb[o], joinreq[o],
                                 joinrep[o], qdrop[o], pdrop[o], proc0,
                                 failed0);
    out[S_PROC * plane + o] = p.proc;
    out[S_FAILED * plane + o] = failed;
    out[S_REJOIN * plane + o] = rejoining;
    out[S_JREQ * plane + o] = p.jreq;
    out[S_JREP * plane + o] = p.jrep;
    out[S_HOLD * plane + o] = p.hold;
    out[S_OPS * plane + o] = p.ops;
    out[S_IN_GROUP * plane + o] = p.in_group;
    out[S_JOINREQ * plane + o] = p.joinreq;
    out[S_JOINREP * plane + o] = p.joinrep;
    iout[I_OWN_HB * plane + o] = p.own_hb;
    iout[I_SENT * plane + o] = p.joinreq_sent;
    iout[I_RECV * plane + o] = p.jrep;
    my_rep += p.joinrep_sent;
    my_req += p.jreq;
  }
  // the introducer's sums: a warp reduction, then one word a warp
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    my_rep += __shfl_down_sync(0xffffffffu, my_rep, off);
    my_req += __shfl_down_sync(0xffffffffu, my_req, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { rep_s[warp] = my_rep; req_s[warp] = my_req; }
  __syncthreads();
  if (threadIdx.x == 0) {   // the thread that wrote peer 0's rows
    int rep = 0, req = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      rep += rep_s[w];
      req += req_s[w];
    }
    iout[I_SENT * plane + v] += rep;
    iout[I_RECV * plane + v] += req;
  }
}

// K2's launch: state planes updated in place (gossip ping-pongs with
// gossip_tmp), the three maxima (3 N^2 i32), the merge scratch and two
// tick parities of the vector lanes (2 VEC_LANES N bytes).  Every fixed
// address and tile count the phases use is computed on the host and read
// from the parameter bank.
struct K2Args {
  uint8_t* known;
  int32_t* hb;
  int32_t* ts;
  uint8_t* gossip;
  uint8_t* gossip_tmp;
  int32_t* aux;
  const uint8_t* gdrop;
  const uint8_t* qdrop;
  const uint8_t* pdrop;
  int32_t* sent;
  int32_t* recv;
  uint8_t* added;
  uint8_t* removed;
  int32_t* m_all;
  int32_t* m_fresh;
  int32_t* t_fresh;
  uint32_t* dbits;
  uint32_t* tany;
  uint8_t* vec;
  int n, words, s_ticks, t0, t_remove, can_rejoin;
  int rt, ct, ex, ey;   // descent row / column tiles, epilogue tiles
};

// A phase's tiles over the persistent grid: with fewer tiles than blocks,
// tile i goes to block i * blocks / tiles, spread over the whole grid (and
// so over the SMs) rather than packed into its first blocks; else block b
// takes tiles b, b + blocks, ...  Loop: for (i = first; i < tiles; i +=
// step).
__device__ __forceinline__ int tile_first(int tiles) {
  const int nb = gridDim.x, b = blockIdx.x;
  if (tiles >= nb) return b;
  const int i = (int)(((long long)b * tiles + nb - 1) / nb);
  return (long long)i * nb < (long long)(b + 1) * tiles ? i : tiles;
}
__device__ __forceinline__ int tile_step(int tiles) {
  return tiles >= (int)gridDim.x ? gridDim.x : tiles;
}

// A grid barrier, or a block barrier where the grid is one block.  On a
// grid of many blocks the branch changes nothing K2 computes, yet K2
// built without it read 15-30% slower at N=512 and 896 on an H100, with
// fewer register spills (PERF.md); why is not known (no ncu).
__device__ __forceinline__ void phase_sync(cooperative_groups::grid_group& g) {
  if (gridDim.x == 1)
    __syncthreads();
  else
    g.sync();
}

// K2: S whole ticks, one persistent grid; every phase deals its tiles out
// over the blocks (tile_first / tile_step).  The vector step runs in the
// last block, which holds no tile of a phase with fewer tiles than blocks.
template <bool VEC>
__global__ void __launch_bounds__(K2_THREADS, 2)
dense_mega_kernel(const __grid_constant__ K2Args a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int n = a.n, tid = threadIdx.x;
  const size_t nn = (size_t)n * n, vl = (size_t)VEC_LANES * n;
  const int vb = gridDim.x - 1;
  if (blockIdx.x == vb)
    vec_rows(a.aux, a.qdrop, a.pdrop, a.vec, a.sent, a.recv, n, a.t0,
             a.can_rejoin);
  phase_sync(grid);
  for (int s = 0; s < a.s_ticks; ++s) {
    const uint8_t* cur = s & 1 ? a.gossip_tmp : a.gossip;
    const uint8_t* vec = a.vec + (s & 1) * vl;
    // (1) churn: a rejoining peer's row is wiped before anyone merges it;
    // the merge prep reads only gossip and proc
    if (a.can_rejoin)
      for (int r = blockIdx.x; r < n; r += gridDim.x)
        if (vec[V_REJOIN * n + r])
          for (int j = tid; j < n; j += K2_THREADS) {
            const size_t o = (size_t)r * n + j;
            a.known[o] = 0; a.hb[o] = 0; a.ts[o] = 0;
          }
    const int wq = (a.words + PREP_WORDS - 1) / PREP_WORDS;
    const int prep = (int)prep_blocks(n, a.words);
    for (int i = tile_first(prep); i < prep; i += tile_step(prep))
      merge_prep_tiles<true>(cur, vec + V_PROC * n, a.dbits, a.tany, n, n,
                             a.words, (i % wq) * PREP_WORDS, i / wq,
                             tid & 31, tid >> 5);
    phase_sync(grid);
    // (2) the descent tiles of the three planes
    const int descent = a.rt * a.ct * 3;
    for (int i = tile_first(descent); i < descent; i += tile_step(descent))
      descent_tile<true>(a.dbits, a.tany, a.known, a.hb, a.ts, a.m_all,
                         a.m_fresh, a.t_fresh, n, n, n, a.words, a.t0 + s,
                         a.t_remove, i % a.rt, (i / a.rt) % a.ct,
                         i / (a.rt * a.ct));
    phase_sync(grid);
    // (3) the epilogue, adding onto the rows the vector step seeded, and
    // the next tick's vector step into the other parity of the lanes
    if (s + 1 < a.s_ticks && blockIdx.x == vb)
      vec_rows(a.aux, a.qdrop + (size_t)(s + 1) * n,
               a.pdrop + (size_t)(s + 1) * n, a.vec + ((s + 1) & 1) * vl,
               a.sent + (size_t)(s + 1) * n, a.recv + (size_t)(s + 1) * n, n,
               a.t0 + s + 1, a.can_rejoin);
    uint8_t* nxt = s & 1 ? a.gossip : a.gossip_tmp;
    const int epilogue = a.ex * a.ey;
    for (int i = tile_first(epilogue); i < epilogue;
         i += tile_step(epilogue))
      epilogue_tile<VEC>(
          a.m_all, a.m_fresh, a.t_fresh, cur, vec + V_PROC * n, a.known,
          a.hb, a.ts, a.gdrop + s * nn, vec + V_OPS * n, vec + V_JREP * n,
          vec + V_JREQ * n, vec + V_HOLD * n, a.known, a.hb, a.ts, nxt,
          a.sent + (size_t)s * n, a.recv + (size_t)s * n,
          a.added ? a.added + s * nn : nullptr,
          a.removed ? a.removed + s * nn : nullptr, n, a.t0 + s, a.t_remove,
          i % a.ex, i / a.ex);
    phase_sync(grid);
  }
  if (a.s_ticks & 1)   // an odd S leaves the last plane in gossip_tmp
    for (size_t i = (size_t)blockIdx.x * K2_THREADS + tid; i < nn;
         i += (size_t)gridDim.x * K2_THREADS)
      a.gossip[i] = a.gossip_tmp[i];
}

// The tiles of K2's widest phase: no block beyond them has work.
int k2_work_tiles(const K2Args& a) {
  return max((int)prep_blocks(a.n, a.words),
             max(a.rt * a.ct * 3, a.ex * a.ey));
}

// One cooperative launch of K2: `blocks` > 0 sets the grid (refused by the
// runtime when it cannot be co-resident), else as many blocks as fit on
// the card at once, capped by k2_work_tiles.
template <bool VEC>
cudaError_t launch_dense_mega(K2Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = (size_t)words_for(a.n) * sizeof(int);
  if (blocks <= 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dense_mega_kernel<VEC>, K2_THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    blocks = min(per_sm * sms, k2_work_tiles(a));
  }
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(dense_mega_kernel<VEC>), dim3(blocks),
      dim3(K2_THREADS), args, smem, stream);
  const cudaError_t last = cudaGetLastError();   // clears a refused launch
  return err != cudaSuccess ? err : last;
}


// b lanes, each an independent merge of an S x R delivery block against
// S x C payload rows: the lane is one more grid coordinate of both
// launches.  With a ladder (use_ladder) the prep launch also builds it and
// the descent is masked_max3_kernel; else masked_max3_plane_kernel.
cudaError_t launch_masked_max3(const uint8_t* gossip, const uint8_t* proc,
                               const uint8_t* known, const int32_t* hb,
                               const int32_t* ts, int32_t* m_all,
                               int32_t* m_fresh, int32_t* t_fresh,
                               uint32_t* scratch, int rn, int sn, int cn,
                               int b, int t, int t_remove,
                               unsigned long long* counts, int cstride,
                               cudaStream_t stream) {
  const int words = words_for(sn);
  const bool ladder = use_ladder(rn, sn);
  const size_t smem = (size_t)words * sizeof(int) * (ladder ? 1 + NBP : 1);
  const long long prep = prep_blocks(rn, words);
  const int ct = (cn + MM_COLS - 1) / MM_COLS;
  const int nl = ladder ? (cn + LD_COLS - 1) / LD_COLS : 0;
  if (rn < 1 || sn < 1 || cn < 1 || b < 1 || b > 65535 / 3 ||
      smem > 48 * 1024 || b * (prep + nl) > 0x7fffffffLL || ct > 65535)
    return cudaErrorInvalidValue;
  const size_t lane_words = lane_scratch_words(rn, sn, cn);
  // the square block of a tick keeps its own instance (one extent)
  const bool sq = rn == sn && sn == cn;
  const dim3 pgrid((unsigned)(b * (prep + nl))), pblock(WORD, 8);
  if (sq)
    merge_prep_kernel<true><<<pgrid, pblock, 0, stream>>>(
        gossip, proc, known, hb, ts, scratch, lane_words, rn, sn, cn, words,
        nl, t, t_remove);
  else
    merge_prep_kernel<false><<<pgrid, pblock, 0, stream>>>(
        gossip, proc, known, hb, ts, scratch, lane_words, rn, sn, cn, words,
        nl, t, t_remove);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rt = (rn + MM_ROWS - 1) / MM_ROWS;
  if (ladder) {
    const dim3 grid(rt, ct, b);
    // word lists past the 48 KB a block gets by default, beside the
    // kernel's static part (S above 8,160), take an opt-in
    const bool big = sizeof(LadderSmem<StageSmem>) + smem > 48 * 1024;
#define GP_MERGE(SQ_)                                                    \
  if (big)                                                               \
    err = cudaFuncSetAttribute(masked_max3_kernel<SQ_>,                 \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               (int)smem);                               \
  if (err != cudaSuccess) return err;                                    \
  masked_max3_kernel<SQ_><<<grid, MM_THREADS, smem, stream>>>(         \
      scratch, proc, known, hb, ts, m_all, m_fresh, t_fresh, lane_words,  \
      rn, sn, cn, words, t, t_remove, counts, cstride)
    if (sq) {
      GP_MERGE(true);
    } else {
      GP_MERGE(false);
    }
#undef GP_MERGE
    return cudaGetLastError();
  }
  const dim3 grid(rt, ct, 3 * b);
  if (sq)
    masked_max3_plane_kernel<true><<<grid, MM_THREADS, smem, stream>>>(
        scratch, known, hb, ts, m_all, m_fresh, t_fresh, lane_words, rn, sn,
        cn, words, t, t_remove);
  else
    masked_max3_plane_kernel<false><<<grid, MM_THREADS, smem, stream>>>(
        scratch, known, hb, ts, m_all, m_fresh, t_fresh, lane_words, rn, sn,
        cn, words, t, t_remove);
  return cudaGetLastError();
}

// b lanes (1 solo) of an N x N tick on the ladder: the prep launch (with
// the ladder) and merge_epilogue_kernel.  A block without a ladder
// (use_ladder) is refused: its tick keeps the masked_max3 / tick_epilogue
// pair.
cudaError_t launch_merge_epilogue(
    const uint8_t* gossip, const uint8_t* proc, const uint8_t* known,
    const int32_t* hb, const int32_t* ts, const uint8_t* gdrop,
    const uint8_t* ops, const uint8_t* jrep, const uint8_t* jreq,
    const uint8_t* hold, uint8_t* known_o, int32_t* hb_o, int32_t* ts_o,
    uint8_t* gossip_o, int32_t* sent_row, int32_t* recv_row,
    uint8_t* added_o, uint8_t* removed_o, uint32_t* scratch,
    int32_t* fallback, int n, int b, int t, int t_remove,
    unsigned long long* counts, int cstride, cudaStream_t stream) {
  const int words = words_for(n);
  if (n < 1 || b < 1 || b > 65535 || !use_ladder(n, n))
    return cudaErrorInvalidValue;
  const bool vec = n % 4 == 0;
  const size_t smem = fused_smem(words, vec);
  const long long prep = prep_blocks(n, words);
  const int nl = (n + LD_COLS - 1) / LD_COLS;
  const int rt = (n + MM_ROWS - 1) / MM_ROWS, ct = (n + MM_COLS - 1) / MM_COLS;
  if (b * (prep + nl) > 0x7fffffffLL || ct > 65535)
    return cudaErrorInvalidValue;
  const size_t lane_words = lane_scratch_words(n, n, n);
  merge_prep_kernel<true><<<dim3((unsigned)(b * (prep + nl))),
                            dim3(WORD, 8), 0, stream>>>(
      gossip, proc, known, hb, ts, scratch, lane_words, n, n, n, words, nl,
      t, t_remove);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(rt, ct, b);
  // the stages (and word lists) past the 48 KB a block gets by default
  // take an opt-in
  const bool big = sizeof(LadderSmem<EpiSmem>) + smem > 48 * 1024;
#define GP_FUSED(VEC_)                                                     \
  if (big)                                                                 \
    err = cudaFuncSetAttribute(merge_epilogue_kernel<VEC_>,               \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               (int)smem);                                 \
  if (err != cudaSuccess) return err;                                      \
  merge_epilogue_kernel<VEC_><<<grid, MM_THREADS, smem, stream>>>(         \
      scratch, gossip, proc, known, hb, ts, gdrop, ops, jrep, jreq, hold,  \
      known_o, hb_o, ts_o, gossip_o, sent_row, recv_row, added_o,          \
      removed_o, fallback, lane_words, n, words, t, t_remove, counts,      \
      cstride)
  if (vec) {
    GP_FUSED(true);
  } else {
    GP_FUSED(false);
  }
#undef GP_FUSED
  return cudaGetLastError();
}

cudaError_t launch_epilogue(const int32_t* m_all, const int32_t* m_fresh,
                            const int32_t* t_fresh, const uint8_t* gossip,
                            const uint8_t* proc, const uint8_t* known,
                            const int32_t* hb, const int32_t* ts,
                            const uint8_t* gdrop, const uint8_t* ops,
                            const uint8_t* jrep, const uint8_t* jreq,
                            const uint8_t* hold, uint8_t* known_o,
                            int32_t* hb_o, int32_t* ts_o, uint8_t* gossip_o,
                            int32_t* sent_row, int32_t* recv_row,
                            uint8_t* added_o, uint8_t* removed_o, int n,
                            int b, int t, int t_remove,
                            cudaStream_t stream) {
  if (b < 1 || b > 65535) return cudaErrorInvalidValue;
  const dim3 grid((n + EP_COLS - 1) / EP_COLS, (n + EP_ROWS - 1) / EP_ROWS,
                  b);
  if (n % 4 == 0)
    tick_epilogue_kernel<true><<<grid, EP_THREADS, 0, stream>>>(
        m_all, m_fresh, t_fresh, gossip, proc, known, hb, ts, gdrop, ops,
        jrep, jreq, hold, known_o, hb_o, ts_o, gossip_o, sent_row, recv_row,
        added_o, removed_o, n, t, t_remove);
  else
    tick_epilogue_kernel<false><<<grid, EP_THREADS, 0, stream>>>(
        m_all, m_fresh, t_fresh, gossip, proc, known, hb, ts, gdrop, ops,
        jrep, jreq, hold, known_o, hb_o, ts_o, gossip_o, sent_row, recv_row,
        added_o, removed_o, n, t, t_remove);
  return cudaGetLastError();
}

// b lanes of n peers, one block a lane; FLAP when flap_down is given
cudaError_t launch_vector_step(const int32_t* start, const int32_t* fail,
                               const int32_t* rejoin, const uint8_t* in_group,
                               const int32_t* own_hb, const uint8_t* joinreq,
                               const uint8_t* joinrep, const uint8_t* qdrop,
                               const uint8_t* pdrop, const uint8_t* flap_down,
                               const uint8_t* flap_up, uint8_t* out,
                               int32_t* iout, int n, int b, int t, int churn,
                               cudaStream_t stream) {
  if (n < 1 || b < 1 || (flap_down == nullptr) != (flap_up == nullptr))
    return cudaErrorInvalidValue;
  const int threads = min(VS_THREADS, (n + 31) / 32 * 32);
#define GP_VECTOR_STEP(C, F)                                              \
  vector_step_kernel<C, F><<<b, threads, 0, stream>>>(                    \
      start, fail, rejoin, in_group, own_hb, joinreq, joinrep, qdrop,     \
      pdrop, flap_down, flap_up, out, iout, n, t)
  if (flap_down)
    GP_VECTOR_STEP(true, true);   // the flap world compiles churn in
  else if (churn)
    GP_VECTOR_STEP(true, false);
  else
    GP_VECTOR_STEP(false, false);
#undef GP_VECTOR_STEP
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// i32 words of K2's merge scratch (the prep's dbits and tany) for n
// peers: gp_merge_scratch_words(n, n)
int gp_merge_scratch_words(int r, int s) {
  return static_cast<int>(merge_scratch_words(r, s));
}

// i32 words of the scratch gp_masked_max3 takes for one lane of r
// receivers, s senders and c columns (the ladder's included); -1 past
// what an int holds
int gp_masked_max3_scratch_words(int r, int s, int c) {
  const size_t w = lane_scratch_words(r, s, c);
  return w > 0x7fffffff ? -1 : static_cast<int>(w);
}

// b lanes (1 solo): gossip u8[b, s, r] (sender, receiver), proc u8[b, r],
// known u8 / hb, ts i32 [b, s, c], the three outputs i32[b, r, c]; scratch
// b * gp_masked_max3_scratch_words(r, s, c) i32 words.  now and t_remove
// are shared by the lanes.  A tick's merge is the square r = s = c = N.
// counts (i64, may be null): with a ladder, lane i adds its plane
// descents (3 a tile) onto counts[i * cstride] and those that fell back
// past the ladder onto counts[i * cstride + 1] (cstride 0: every lane
// onto the same two).
int gp_masked_max3(const uint8_t* gossip, const uint8_t* proc,
                   const uint8_t* known, const int32_t* hb, const int32_t* ts,
                   int32_t* m_all, int32_t* m_fresh, int32_t* t_fresh,
                   int32_t* scratch, int r, int s, int c, int b, int t,
                   int t_remove, long long* counts, int cstride,
                   void* stream) {
  return static_cast<int>(launch_masked_max3(
      gossip, proc, known, hb, ts, m_all, m_fresh, t_fresh,
      reinterpret_cast<uint32_t*>(scratch), r, s, c, b, t, t_remove,
      reinterpret_cast<unsigned long long*>(counts), cstride,
      static_cast<cudaStream_t>(stream)));
}

// b lanes (1 solo), every plane [b, n, n] and vector [b, n]; the gossip
// counts are added onto sent_row and recv_row i32[b, n], which hold the
// tick's join traffic (gp_vector_step's rows) or zeros
int gp_tick_epilogue(const int32_t* m_all, const int32_t* m_fresh,
                     const int32_t* t_fresh, const uint8_t* gossip,
                     const uint8_t* proc, const uint8_t* known,
                     const int32_t* hb, const int32_t* ts,
                     const uint8_t* gdrop, const uint8_t* ops,
                     const uint8_t* jrep, const uint8_t* jreq,
                     const uint8_t* hold, uint8_t* known_o, int32_t* hb_o,
                     int32_t* ts_o, uint8_t* gossip_o, int32_t* sent_row,
                     int32_t* recv_row, uint8_t* added_o, uint8_t* removed_o,
                     int n, int b, int t, int t_remove, void* stream) {
  return static_cast<int>(launch_epilogue(
      m_all, m_fresh, t_fresh, gossip, proc, known, hb, ts, gdrop, ops, jrep,
      jreq, hold, known_o, hb_o, ts_o, gossip_o, sent_row, recv_row, added_o,
      removed_o, n, b, t, t_remove, static_cast<cudaStream_t>(stream)));
}

// K1 on the ladder (use_ladder(n, n), else cudaErrorInvalidValue) for b
// lanes (1 solo): gp_masked_max3's merge and gp_tick_epilogue's cell rules
// in one descent launch after the prep; the maxima are never written.
// Inputs and outputs as gp_tick_epilogue's, without the maxima; scratch
// b * gp_masked_max3_scratch_words(n, n, n) i32 words; fallback 3 b n^2
// i32, written only where a tile falls back past the ladder; counts and
// cstride as gp_masked_max3's.
int gp_merge_epilogue(const uint8_t* gossip, const uint8_t* proc,
                      const uint8_t* known, const int32_t* hb,
                      const int32_t* ts, const uint8_t* gdrop,
                      const uint8_t* ops, const uint8_t* jrep,
                      const uint8_t* jreq, const uint8_t* hold,
                      uint8_t* known_o, int32_t* hb_o, int32_t* ts_o,
                      uint8_t* gossip_o, int32_t* sent_row, int32_t* recv_row,
                      uint8_t* added_o, uint8_t* removed_o, int32_t* scratch,
                      int32_t* fallback, int n, int b, int t, int t_remove,
                      long long* counts, int cstride, void* stream) {
  return static_cast<int>(launch_merge_epilogue(
      gossip, proc, known, hb, ts, gdrop, ops, jrep, jreq, hold, known_o,
      hb_o, ts_o, gossip_o, sent_row, recv_row, added_o, removed_o,
      reinterpret_cast<uint32_t*>(scratch), fallback, n, b, t, t_remove,
      reinterpret_cast<unsigned long long*>(counts), cstride,
      static_cast<cudaStream_t>(stream)));
}

// The K1 route's vector step of tick t for b lanes (1 solo) of n peers:
// start / fail / rejoin i32, in_group / joinreq / joinrep u8 and own_hb
// i32, qdrop / pdrop u8, each [b, n]; flap_down / flap_up u8[b, n] or both
// null; out u8[10, b, n] and iout i32[3, b, n] (the S_* and I_* lanes).
int gp_vector_step(const int32_t* start, const int32_t* fail,
                   const int32_t* rejoin, const uint8_t* in_group,
                   const int32_t* own_hb, const uint8_t* joinreq,
                   const uint8_t* joinrep, const uint8_t* qdrop,
                   const uint8_t* pdrop, const uint8_t* flap_down,
                   const uint8_t* flap_up, uint8_t* out, int32_t* iout, int n,
                   int b, int t, int churn, void* stream) {
  return static_cast<int>(launch_vector_step(
      start, fail, rejoin, in_group, own_hb, joinreq, joinrep, qdrop, pdrop,
      flap_down, flap_up, out, iout, n, b, t, churn,
      static_cast<cudaStream_t>(stream)));
}

// K2: s_ticks whole ticks from t0 in one cooperative launch.  known/gossip
// are u8 planes, hb/ts i32, all updated in place (gossip ping-pongs with
// gossip_tmp; the final plane is back in gossip).  m_scratch holds 3 N^2
// i32 and then gp_merge_scratch_words(n, n) more, vec_scratch 2 VEC_LANES N
// bytes.  added/removed (u8[S, N, N]) may be null.  blocks: the persistent
// grid's size, 0 for as many blocks as fit on the card (capped by the
// work); a grid that cannot be co-resident is refused with an error.
int gp_dense_mega_ticks(uint8_t* known, int32_t* hb, int32_t* ts,
                        uint8_t* gossip, uint8_t* gossip_tmp, int32_t* aux,
                        const uint8_t* gdrop, const uint8_t* qdrop,
                        const uint8_t* pdrop, int32_t* sent, int32_t* recv,
                        uint8_t* added, uint8_t* removed, int32_t* m_scratch,
                        uint8_t* vec_scratch, int n, int s_ticks, int t0,
                        int t_remove, int can_rejoin, int blocks,
                        void* stream_ptr) {
  if (n < 1 || s_ticks < 1 || (size_t)words_for(n) * sizeof(int) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  K2Args a;
  a.known = known;
  a.hb = hb;
  a.ts = ts;
  a.gossip = gossip;
  a.gossip_tmp = gossip_tmp;
  a.aux = aux;
  a.gdrop = gdrop;
  a.qdrop = qdrop;
  a.pdrop = pdrop;
  a.sent = sent;
  a.recv = recv;
  a.added = added;
  a.removed = removed;
  const size_t nn = (size_t)n * n;
  a.m_all = m_scratch;
  a.m_fresh = m_scratch + nn;
  a.t_fresh = m_scratch + 2 * nn;
  a.words = words_for(n);
  a.dbits = reinterpret_cast<uint32_t*>(m_scratch + 3 * nn);
  a.tany = a.dbits + (size_t)a.words * n;   // merge_scratch_words(n, n)
  a.vec = vec_scratch;
  a.rt = (n + MM_ROWS - 1) / MM_ROWS;
  a.ct = (n + MM_COLS - 1) / MM_COLS;
  a.ex = (n + EP_COLS - 1) / EP_COLS;
  a.ey = (n + EP_ROWS - 1) / EP_ROWS;
  a.n = n;
  a.s_ticks = s_ticks;
  a.t0 = t0;
  a.t_remove = t_remove;
  a.can_rejoin = can_rejoin;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = n % 4 == 0
                              ? launch_dense_mega<true>(a, blocks, stream)
                              : launch_dense_mega<false>(a, blocks, stream);
  return static_cast<int>(err);
}

}  // extern "C"
