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
//                  is closed draws nothing and is all zeros, as the JAX
//                  package's lax.cond skips the draw.
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
// against 0.0024 ms for its 7.9 MB of bytes: operations bound it.
// Design: one thread per 4 consecutive output bytes of a row (one 32-bit
// store where N % 4 == 0), four independent hashes in flight a thread;
// rotates by __funnelshift_l; each block derives its tick's key (fold_in,
// one hash) once into shared memory, so the host passes only the run's
// key.  The float compare is exact: (bits >> 9) | 0x3F800000 read as a
// float, minus 1.0f, is m * 2^-23 with no rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TICKS = 32;   // ticks a launch: one bit each of `active`
constexpr uint32_t PARITY = 0x1BD11BDAu;

struct DropArgs {
  uint32_t k0, k1;      // the run's key (PRNGKey(seed))
  int32_t t0;           // tick of z-slice 0
  uint32_t active;      // bit s: the drop window is open for tick t0 + s
  float prob;           // float32 MSG_DROP_PROB
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

// grid (ceil((N + 2) * ceil(N / 4) / THREADS), S): thread i of z-slice s
// owns output row r = i / ceil(N / 4) (N gossip rows, then JOINREQ, then
// JOINREP) and its columns 4 (i % ceil(N / 4)) .. + 3.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
drop_masks_kernel(uint8_t* __restrict__ g, uint8_t* __restrict__ q,
                  uint8_t* __restrict__ p, DropArgs a) {
  __shared__ uint32_t key_s[2];
  const int s = blockIdx.y, n = a.n, na = a.na;
  const bool on = (a.active >> s) & 1u;
  if (on && threadIdx.x == 0) {    // fold_in(key, t) = threefry(key, (0, t))
    uint32_t x0 = 0u, x1 = (uint32_t)(a.t0 + s);
    threefry2x32(a.k0, a.k1, x0, x1);
    key_s[0] = x0;
    key_s[1] = x1;
  }
  __syncthreads();
  const int qpr = (n + 3) / 4;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)(n + 2) * qpr) return;
  const int r = (int)(i / qpr), c = 4 * (int)(i % qpr);
  // the draw's row of output row r, or -1 where the row is not drawn
  const int dr = r < n ? (r < na ? r : -1) : na + (r - n);
  uint32_t out = 0u;
  if (on && dr >= 0) {
    const uint32_t k0 = key_s[0], k1 = key_s[1];
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
      const uint32_t bits = x0[e] ^ x1[e];
      const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      out |= (uint32_t)(c + e < na && u < a.prob) << (8 * e);
    }
  }
  uint8_t* dst = r < n ? g + ((size_t)s * n + r) * n
                       : (r == n ? q : p) + (size_t)s * n;
  if (VEC) {
    *reinterpret_cast<uint32_t*>(dst + c) = out;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < n) dst[c + e] = (out >> (8 * e)) & 0xFFu;
  }
}

}  // namespace

extern "C" {

const char* gp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g u8[S, N, N], q/p u8[S, N] (written whole); (k0, k1) the run's key, tick
// t0 + s drawn where bit s of `active` is set, at width na <= n.
int gp_drop_masks(uint8_t* g, uint8_t* q, uint8_t* p, unsigned int k0,
                  unsigned int k1, int t0, unsigned int active, float prob,
                  int n, int na, int s_ticks, void* stream_ptr) {
  if (n < 1 || na < 1 || na > n || s_ticks < 1 || s_ticks > MAX_TICKS)
    return static_cast<int>(cudaErrorInvalidValue);
  DropArgs a;
  a.k0 = k0;
  a.k1 = k1;
  a.t0 = t0;
  a.active = active;
  a.prob = prob;
  a.n = n;
  a.na = na;
  const long long quads = (long long)(n + 2) * ((n + 3) / 4);
  const dim3 grid((unsigned)((quads + THREADS - 1) / THREADS), s_ticks);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n % 4 == 0)
    drop_masks_kernel<true><<<grid, THREADS, 0, stream>>>(g, q, p, a);
  else
    drop_masks_kernel<false><<<grid, THREADS, 0, stream>>>(g, q, p, a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
