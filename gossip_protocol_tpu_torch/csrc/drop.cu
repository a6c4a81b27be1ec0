// The dense model's message-drop draw for Hopper (sm_90a).
//
//   gp_drop_masks  the drop decisions of S consecutive ticks in one launch.
//                  Tick t's draw is uniform(fold_in(key, t), (na+2, na)) <
//                  prob, jax.random's partitionable threefry-2x32 stream
//                  bit for bit (utils/threefry.py is the plain version),
//                  split into the gossip plane (sender-major: the na x na
//                  draw embedded at [:na, :na] of an N x N plane), the
//                  JOINREQ vector (draw row na) and the JOINREP vector (draw
//                  row na + 1), all zero past na.  A tick whose drop window
//                  is closed draws nothing, as the JAX package's lax.cond
//                  skips the draw.
//
// Two optional inputs carry the adversarial worlds (worlds.py), at any
// draw width na <= N:
//   thr    f32[N, N] sender-major per-link probabilities (asym drop), read
//          at the na x na corner at row stride N (the JAX draw's
//          link_prob[:na, :na], gossip_protocol_tpu/core/tick.py:219-221):
//          the gossip cell (r, c) compares against thr[r N + c], JOINREQ
//          cell c against thr[c N + INTRODUCER] (c's link to the
//          introducer), JOINREP cell c against thr[INTRODUCER N + c]
//          (gossip_protocol_tpu/ops/drop.py:49-57);
//   group  i32[N] partition groups, with bit s of part_active set when the
//          partition is open at tick t0 + s, applied over the whole N x N
//          plane whatever na is: the gossip cell (r, c) ORs in group[r] !=
//          group[c], cell c of both join rows group[c] != group[INTRODUCER]
//          (gossip_protocol_tpu/core/tick.py:238-247).  The gate is
//          deterministic and sits outside the drop window: a tick whose
//          window is closed but whose partition is open writes the
//          partition mask and draws nothing.
// A canonical fleet bucket (service/canonical.py) pads its lanes' peers to
// a power-of-two rung N and draws at the lanes' real width na < N, which
// is what the corner read and the full-width gate serve.
//
//   gp_drop_masks_lanes  one tick of a fleet of B runs in one launch (the
//                  lane is the grid's second coordinate): lane b draws with
//                  its own key, probability, window, thresholds and groups
//                  at the shared clock, as each lane of the JAX package's
//                  vmapped fleet tick draws (gossip_protocol_tpu/core/
//                  fleet.py).  Its bound is B times one tick's.
//
// The JAX package leaves this draw to XLA (gossip_protocol_tpu/ops/drop.py
// tick_drop_masks: jax.random.uniform under a lax.cond), not to a Pallas
// kernel; in the port's torch form it is about 100 elementwise int64
// launches a tick.
//
// Bound on an H100: every drawn element is one threefry-2x32 hash of its
// row-major flat index in the (na+2, na) draw (20 rounds of add, rotate and
// xor, and 5 key injections of two adds: 70 int32 operations), so at
// na = 2816 a tick is 7.9M hashes, 0.033 ms at 16.7 T int32 operations/s,
// against 0.0024 ms for its 7.9 MB of bytes: operations bound it.  The
// thresholds add 4 bytes a link read.
// Design: one thread per 4 consecutive output bytes of a row (one 32-bit
// store where N % 4 == 0), four independent hashes in flight a thread;
// rotates by __funnelshift_l; each block derives its tick's key (fold_in,
// one hash) once into shared memory, so the host passes only the run's
// key.  The float compare is exact: (bits >> 9) | 0x3F800000 read as a
// float, minus 1.0f, is m * 2^-23 with no rounding.
// A z-slice with nothing to draw and no partition gate (a closed window,
// most of a run's ticks) only writes zeros, which its bytes bound (7.9 MB
// at N=2816, 0.0024 ms): its threads store 16 zero bytes each over the
// slice's flat N x N plane and its two vectors (zero_slice), with no
// division by the row, and a launch whose slices are all such takes a
// grid a quarter of the drawing one's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TICKS = 32;   // ticks a launch: one bit each of `active`
constexpr uint32_t PARITY = 0x1BD11BDAu;
constexpr int INTRODUCER = 0;   // config.py INTRODUCER

struct DropArgs {
  uint32_t k0, k1;      // the run's key (PRNGKey(seed))
  int32_t t0;           // tick of z-slice 0
  uint32_t active;      // bit s: the drop window is open for tick t0 + s
  uint32_t part_active; // bit s: the partition is open for tick t0 + s
  float prob;           // float32 MSG_DROP_PROB (unless thr)
  int n, na;            // output width, draw width (na <= n)
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry-2x32, 20 rounds (jax._src.prng's lowering), in place on (x0, x1)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  constexpr int R[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ PARITY};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, R[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// Thread i of one tick's draw: output row r = i / ceil(N / 4) (N gossip
// rows, then JOINREQ, then JOINREP) and its columns 4 (i % ceil(N / 4))
// .. + 3.  g/q/p are that tick's planes, (k0, k1) its folded key (read
// only when `on`), thr and group null without the asym / partition world.
template <bool VEC>
__device__ __forceinline__ void draw_quad(
    uint8_t* g, uint8_t* q, uint8_t* p, const float* __restrict__ thr,
    const int32_t* __restrict__ group, bool on, bool part, uint32_t k0,
    uint32_t k1, float prob, int n, int na) {
  const int qpr = (n + 3) / 4;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)(n + 2) * qpr) return;
  const int r = (int)(i / qpr), c = 4 * (int)(i % qpr);
  // the draw's row of output row r, or -1 where the row is not drawn
  const int dr = r < n ? (r < na ? r : -1) : na + (r - n);
  uint32_t out = 0u;
  if (on && dr >= 0) {
    const uint64_t base = (uint64_t)dr * (uint64_t)na;
    uint32_t x0[4], x1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint64_t idx = base + (uint64_t)(c + e);
      x0[e] = (uint32_t)(idx >> 32);
      x1[e] = (uint32_t)idx;
      threefry2x32(k0, k1, x0[e], x1[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c + e;
      float pr = prob;
      if (thr != nullptr && col < na)   // the na x na corner, stride n
        pr = r < n ? thr[(size_t)r * n + col]
                   : (r == n ? thr[(size_t)col * n + INTRODUCER]
                             : thr[(size_t)INTRODUCER * n + col]);
      const uint32_t bits = x0[e] ^ x1[e];
      const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      out |= (uint32_t)(col < na && u < pr) << (8 * e);
    }
  }
  if (part) {      // the partition gate covers all n rows and columns
    const int gr = group[r < n ? r : INTRODUCER];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < n) out |= (uint32_t)(group[c + e] != gr) << (8 * e);
  }
  uint8_t* dst = r < n ? g + (size_t)r * n : (r == n ? q : p);
  if (VEC) {
    *reinterpret_cast<uint32_t*>(dst + c) = out;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < n) dst[c + e] = (out >> (8 * e)) & 0xFFu;
  }
}

// Chunk j of the 16-byte-aligned cover of the bytes [dst, dst + len): one
// 16-byte store where the chunk lies inside them, else its bytes one by one
// (a plane or vector that does not start or end on 16 bytes).
__device__ __forceinline__ void zero_chunk(uint8_t* dst, size_t len,
                                           size_t j) {
  const size_t head = reinterpret_cast<uintptr_t>(dst) & 15u;
  uint8_t* c = dst - head + 16 * j;
  if (16 * j >= head && 16 * j + 16 <= head + len) {
    *reinterpret_cast<uint4*>(c) = make_uint4(0u, 0u, 0u, 0u);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (c + e >= dst && c + e < dst + len) c[e] = 0;
  }
}

__device__ __forceinline__ size_t zero_chunks(const uint8_t* dst, size_t len) {
  return ((reinterpret_cast<uintptr_t>(dst) & 15u) + len + 15) / 16;
}

// One z-slice's outputs all zero (a tick with nothing drawn and no gate):
// the gossip plane's N^2 bytes, then JOINREQ's and JOINREP's N, 16 bytes a
// thread over the slice's blocks.
__device__ __forceinline__ void zero_slice(uint8_t* g, uint8_t* q, uint8_t* p,
                                           int n) {
  const size_t nn = (size_t)n * n;
  const size_t cg = zero_chunks(g, nn), cq = zero_chunks(q, n),
               cp = zero_chunks(p, n);
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
       i < cg + cq + cp; i += (size_t)gridDim.x * THREADS) {
    if (i < cg)
      zero_chunk(g, nn, i);
    else if (i < cg + cq)
      zero_chunk(q, n, i - cg);
    else
      zero_chunk(p, n, i - cg - cq);
  }
}

// fold_in(key, t) = threefry(key, (0, t)), by thread 0 into key_s
__device__ __forceinline__ void fold_key(uint32_t k0, uint32_t k1, int t,
                                         uint32_t* key_s) {
  if (threadIdx.x == 0) {
    uint32_t x0 = 0u, x1 = (uint32_t)t;
    threefry2x32(k0, k1, x0, x1);
    key_s[0] = x0;
    key_s[1] = x1;
  }
  __syncthreads();
}

// grid (ceil((N + 2) * ceil(N / 4) / THREADS), S), or the zeroing grid
// where no slice draws or gates: z-slice s draws tick t0 + s of one run.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
drop_masks_kernel(uint8_t* __restrict__ g, uint8_t* __restrict__ q,
                  uint8_t* __restrict__ p, const float* __restrict__ thr,
                  const int32_t* __restrict__ group, DropArgs a) {
  __shared__ uint32_t key_s[2];
  const int s = blockIdx.y, n = a.n;
  const bool on = (a.active >> s) & 1u;
  const bool part = group != nullptr && ((a.part_active >> s) & 1u);
  const size_t nn = (size_t)n * n;
  if (!on && !part) {
    zero_slice(g + s * nn, q + (size_t)s * n, p + (size_t)s * n, n);
    return;
  }
  if (on) fold_key(a.k0, a.k1, a.t0 + s, key_s);
  draw_quad<VEC>(g + s * nn, q + (size_t)s * n, p + (size_t)s * n, thr,
                 group, on, part, key_s[0], key_s[1], a.prob, n, a.na);
}

// A fleet's tick: lane b's run key, probability and window flags come
// from device tables the fleet uploads once a run, so a tick passes only
// its clock.
struct LaneArgs {
  const uint32_t* keys;     // u32[B, 2] each lane's PRNGKey(seed)
  const float* prob;        // f32[B] each lane's MSG_DROP_PROB
  const uint8_t* active;    // drop window of lane b: active[b * stride + ti]
  const uint8_t* part;      // partition window, same layout (or null)
  int t, ti, stride;        // the clock, its table column, the lane stride
  int n, na;                // output width, draw width (na <= n)
};

// grid (ceil((N + 2) * ceil(N / 4) / THREADS), B): z-slice b draws lane b
// at the shared clock t; thr (f32[B, N, N]) and group (i32[B, N]) per lane.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
drop_lanes_kernel(uint8_t* __restrict__ g, uint8_t* __restrict__ q,
                  uint8_t* __restrict__ p, const float* __restrict__ thr,
                  const int32_t* __restrict__ group, LaneArgs a) {
  __shared__ uint32_t key_s[2];
  const int b = blockIdx.y, n = a.n;
  const size_t row = (size_t)b * a.stride + a.ti, nn = (size_t)n * n;
  const bool on = a.active[row] != 0;
  const bool part = group != nullptr && a.part[row] != 0;
  if (!on && !part) {
    zero_slice(g + b * nn, q + (size_t)b * n, p + (size_t)b * n, n);
    return;
  }
  if (on) fold_key(a.keys[2 * b], a.keys[2 * b + 1], a.t, key_s);
  draw_quad<VEC>(g + b * nn, q + (size_t)b * n, p + (size_t)b * n,
                 thr ? thr + b * nn : nullptr,
                 group ? group + (size_t)b * n : nullptr, on, part, key_s[0],
                 key_s[1], a.prob[b], n, a.na);
}

}  // namespace

extern "C" {

const char* gp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g u8[S, N, N], q/p u8[S, N] (written whole); (k0, k1) the run's key, tick
// t0 + s drawn where bit s of `active` is set, at width na <= n; thr
// (f32[N, N], read at its na x na corner) and group (i32[N], over all n)
// optional, the partition applied where bit s of `part_active` is set.
int gp_drop_masks(uint8_t* g, uint8_t* q, uint8_t* p, const float* thr,
                  const int32_t* group, unsigned int k0, unsigned int k1,
                  int t0, unsigned int active, unsigned int part_active,
                  float prob, int n, int na, int s_ticks, void* stream_ptr) {
  if (n < 1 || na < 1 || na > n || s_ticks < 1 || s_ticks > MAX_TICKS)
    return static_cast<int>(cudaErrorInvalidValue);
  DropArgs a;
  a.k0 = k0;
  a.k1 = k1;
  a.t0 = t0;
  a.active = active;
  a.part_active = part_active;
  a.prob = prob;
  a.n = n;
  a.na = na;
  // a launch that draws or gates no slice only zeroes: 16 bytes a thread
  const unsigned long long live = (active | (group ? part_active : 0u)) &
                                  ((1ull << s_ticks) - 1ull);
  const long long work =
      live ? (long long)(n + 2) * ((n + 3) / 4)
           : ((long long)n * n + 15) / 16 + 2 * ((n + 15) / 16) + 3;
  const dim3 grid((unsigned)((work + THREADS - 1) / THREADS), s_ticks);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n % 4 == 0)
    drop_masks_kernel<true><<<grid, THREADS, 0, stream>>>(g, q, p, thr,
                                                          group, a);
  else
    drop_masks_kernel<false><<<grid, THREADS, 0, stream>>>(g, q, p, thr,
                                                           group, a);
  return static_cast<int>(cudaGetLastError());
}

// One tick t of b lanes in one launch: g u8[b, N, N], q/p u8[b, N]
// (written whole); keys u32[b, 2], prob f32[b]; lane l's drop window is
// open where active[l * stride + ti] (ti = t clamped to the table, stride
// 0 when the lanes share one window), its partition where part[...] (same
// layout; null without the partition world).  thr (f32[b, N, N], each
// lane's read at its na x na corner) and group (i32[b, N], over all n)
// optional.
int gp_drop_masks_lanes(uint8_t* g, uint8_t* q, uint8_t* p, const float* thr,
                        const int32_t* group, const uint32_t* keys,
                        const float* prob, const uint8_t* active,
                        const uint8_t* part, int t, int ti, int stride,
                        int n, int na, int b, void* stream_ptr) {
  if (n < 1 || na < 1 || na > n || b < 1 || b > 65535 || ti < 0 ||
      stride < 0 || keys == nullptr || prob == nullptr || active == nullptr ||
      (group != nullptr && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  LaneArgs a;
  a.keys = keys;
  a.prob = prob;
  a.active = active;
  a.part = part;
  a.t = t;
  a.ti = ti;
  a.stride = stride;
  a.n = n;
  a.na = na;
  const long long quads = (long long)(n + 2) * ((n + 3) / 4);
  const dim3 grid((unsigned)((quads + THREADS - 1) / THREADS), b);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n % 4 == 0)
    drop_lanes_kernel<true><<<grid, THREADS, 0, stream>>>(g, q, p, thr, group,
                                                          a);
  else
    drop_lanes_kernel<false><<<grid, THREADS, 0, stream>>>(g, q, p, thr,
                                                           group, a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
