// Check-node Forward-Backward Propagation (paper §3.2.2).
//
// Replaces src/repro/kernels/fbp.py: fbp_cn_pallas. Input m (N, dc, p)
// float32, each row one check node's dc slot messages in contribution
// space (padded slots hold the max-plus identity). Output: for every slot t,
// the extrinsic conv(fm[t-1], bm[t+1]) reflected k -> -k, where fm/bm are
// the forward/backward chains of cyclic max-plus convolutions
// conv(a, b)[k] = max_j a[(k - j) mod p] + b[j].
//
// Bound on the card: bytes. Each row moves 2 * dc * p * 4 bytes and does
// about 3 * dc * p^2 adds and maxes, a few operations per byte.
//
// Design (Hopper, sm_90a). Persistent CTAs of 128 threads walk blocks of
// RB rows, RB a multiple of 4. A block is one contiguous range of
// RB * dc * p floats, 16-byte aligned, so it arrives by one 1-D bulk copy
// (cp.async.bulk, no tensor map to encode on the host) on its mbarrier, in
// a ring of two slots, a block ahead; the ragged last block's words past
// its last whole 16 bytes (fewer than 4) come straight from device memory.
// The threads then repack the block to the odd row stride S = dc p | 1,
// so that a warp's 32 rows, one a thread, fall on 32 different banks (at
// the copy's own stride of dc p = 48 words a warp's reads collide 16
// ways). One thread runs one row, with its chains in the plain version's
// order: the backward pass writes bm[t] (the conv of slots t..dc-1) into
// slot t of the row's output, the forward pass reads bm[t+1] from slot
// t+1 before it overwrites slot t with the extrinsic, so a thread holds
// O(p) registers whatever dc is, and one instantiation per p serves every
// dc. Every term is one float add and the max is exact, so the output is
// bitwise equal to the plain version and to the JAX oracle. The output
// lives in the block's own slot, free once repacked, and leaves by
// coalesced stores while the next blocks land. Shared memory is sized so
// that three CTAs fit an SM. The copies between shared buffers and out to
// device memory take UNROLL rows a warp at once, loads first: a load after
// a store waits for it, as the compiler cannot tell the buffers apart.
//
// Why three CTAs an SM and the unrolled copies: at 8 warps an SM these
// copy loops and the chains, each load waiting behind a store, ran slower
// than the kernel this one replaced (PERF.md).
#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e9f;
constexpr int THREADS = 128;               // a thread a row
constexpr int NBUF = 2;                    // row blocks in flight
constexpr int SMEM_BUDGET = 75 * 1024;     // a CTA's share: three an SM
constexpr int UNROLL = 4;                  // rows a warp copies at once

template <int P>
__device__ __forceinline__ void load(float (&v)[P], const float* src) {
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = src[k];
}

template <int P>
__device__ __forceinline__ void store(float* dst, const float (&v)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) dst[k] = v[k];
}

template <int P>
__device__ __forceinline__ void conv(const float (&a)[P], const float (&b)[P],
                                     float (&out)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    float m = a[k] + b[0];
#pragma unroll
    for (int j = 1; j < P; ++j) m = fmaxf(m, a[(k - j + P) % P] + b[j]);
    out[k] = m;
  }
}

// out[k] = ext[(-k) mod p]
template <int P>
__device__ __forceinline__ void store_reflected(float* dst,
                                                const float (&ext)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) dst[k] = ext[(P - k) % P];
}

// one row: `in` its dc slot messages, `o` its extrinsics (both P words a
// slot, in shared memory). Each slot's words are loaded a step before they
// are used, so no load waits behind the step's stores.
template <int P>
__device__ __forceinline__ void row_fbp(const float* in, float* o, int dc) {
  if (dc == 1) {                             // the identity, reflected
#pragma unroll
    for (int k = 0; k < P; ++k) o[k] = k == 0 ? 0.0f : NEG_INF;
    return;
  }
  float b[P], a[P];                          // bm[t + 1], slot t
  load<P>(b, in + (dc - 1) * P);
  store<P>(o + (dc - 1) * P, b);
  if (dc > 2) load<P>(a, in + (dc - 2) * P);
  for (int t = dc - 2; t >= 1; --t) {        // bm[t] = conv of slots t..dc-1
    float an[P], nb[P];
    if (t > 1) load<P>(an, in + (t - 1) * P);
    conv<P>(a, b, nb);
    store<P>(o + t * P, nb);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      b[k] = nb[k];
      a[k] = an[k];
    }
  }
  store_reflected<P>(o, b);                  // slot 0: bm[1]
  float fm[P], bn[P];                        // conv of slots 0..t-1, bm[t+1]
  load<P>(fm, in);
  if (dc > 2) {
    load<P>(bn, o + 2 * P);
    load<P>(a, in + P);
  }
  for (int t = 1; t < dc - 1; ++t) {
    float bn2[P], a2[P], ext[P], nxt[P];
    if (t + 1 < dc - 1) {                    // bm[t+2] is not yet overwritten
      load<P>(bn2, o + (t + 2) * P);
      load<P>(a2, in + (t + 1) * P);
    }
    conv<P>(fm, bn, ext);
    conv<P>(fm, a, nxt);
    store_reflected<P>(o + t * P, ext);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      fm[k] = nxt[k];
      bn[k] = bn2[k];
      a[k] = a2[k];
    }
  }
  store_reflected<P>(o + (dc - 1) * P, fm);  // slot dc-1: fm[dc-2]
}

// rows r, r + 4, ..., r + 4 (UNROLL - 1) of a block from `src` (stride
// sw, the first `limit` words of it) to `dst` (stride dw), by one warp:
// all loads, then all stores
__device__ __forceinline__ void copy_rows(const float* src, int sw,
                                          float* dst, int dw, int r, int rows,
                                          int W, int limit) {
  for (int c = threadIdx.x % 32; c < W; c += 32) {
    float v[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int rj = r + 4 * j;
      v[j] = rj < rows && rj * sw + c < limit ? src[rj * sw + c] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int rj = r + 4 * j;
      if (rj < rows && rj * sw + c < limit) dst[rj * dw + c] = v[j];
    }
  }
}

// Shared memory: NBUF slots of `slot` floats (a multiple of 32, at least
// RB S), each a block as copied (stride dc p) and then, once repacked, its
// output at stride S; the repacked input (RB x S); an mbarrier a slot.
// Block b of the grid's walk holds rows [b RB, b RB + RB).
template <int P>
__global__ void __launch_bounds__(THREADS)
fbp_cn_kernel(const float* __restrict__ m, float* __restrict__ out, int N,
              int dc, int S, int RB, int slot, int nblocks) {
  using namespace sm90;
  extern __shared__ __align__(128) float sm[];
  const int W = dc * P;
  float* raw = sm;
  float* pin = raw + NBUF * slot;
  const uint32_t bars = smem_u32(pin + (RB * S + 1) / 2 * 2);
  const int warp = threadIdx.x / 32;
  const int nb = (nblocks - (int)blockIdx.x + (int)gridDim.x - 1) /
                 (int)gridDim.x;             // this CTA's blocks
  // the whole 16-byte words of block i of this CTA, as floats
  auto copied = [&](int i) {
    const long row0 = (blockIdx.x + (long)i * gridDim.x) * RB;
    const int rows = (int)(N - row0 < RB ? N - row0 : RB);
    return rows * W / 4 * 4;
  };
  // block i of this CTA into slot i % NBUF, by thread 0
  auto issue = [&](int i) {
    const long row0 = (blockIdx.x + (long)i * gridDim.x) * RB;
    const uint32_t bar = bars + 8 * (i % NBUF);
    const uint32_t bytes = 4u * copied(i);
    mbar_expect(bar, bytes);
    if (bytes)
      bulk_load(smem_u32(raw + (i % NBUF) * slot), m + row0 * W, bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NBUF; ++s) mbar_init(bars + 8 * s);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < NBUF - 1 && i < nb; ++i) issue(i);

  for (int i = 0; i < nb; ++i) {
    const long row0 = (blockIdx.x + (long)i * gridDim.x) * RB;
    const int rows = (int)(N - row0 < RB ? N - row0 : RB);
    const int held = copied(i);
    float* src = raw + (i % NBUF) * slot;
    mbar_wait(bars + 8 * (i % NBUF), (i / NBUF) & 1);
    for (int r = warp; r < rows; r += 4 * UNROLL)
      copy_rows(src, W, pin, S, r, rows, W, held);
    // the block's words past its last whole 16 bytes, from device memory
    for (int w = held + threadIdx.x; w < rows * W; w += THREADS)
      pin[w / W * S + w % W] = m[row0 * W + w];
    // every thread is past its repack of block i (so its slot takes the
    // output) and past its stores of block i - 1 (whose slot, free now,
    // the next copy takes)
    __syncthreads();
    if (threadIdx.x == 0 && i + NBUF - 1 < nb) {
      fence_async_smem();
      issue(i + NBUF - 1);
    }
    if ((int)threadIdx.x < rows)
      row_fbp<P>(pin + threadIdx.x * S, src + threadIdx.x * S, dc);
    __syncthreads();
    for (int r = warp; r < rows; r += 4 * UNROLL)
      copy_rows(src, S, out + row0 * W, W, r, rows, W, RB * S);
  }
}

// rows a block: as many as SMEM_BUDGET holds (NBUF + 1 buffers of RB S
// floats, each slot rounded up by up to 31 floats), at most one a thread,
// a multiple of 4 so that every block starts 16-byte aligned
int block_rows(int S) {
  int rows = (SMEM_BUDGET - 8 * NBUF - 8 - 4 * 32 * NBUF) /
             (4 * (NBUF + 1) * S);
  rows = rows < THREADS ? rows : THREADS;
  return rows / 4 * 4;
}

template <int P>
int launch(const float* m, float* out, int N, int dc, int sms,
           cudaStream_t stream) {
  const int W = dc * P, S = W | 1;
  const int RB = block_rows(S);
  if (RB < 4 || sms < 1) return (int)cudaErrorInvalidValue;
  const int slot = (RB * S + 31) / 32 * 32;
  const size_t smem =
      (size_t)4 * (NBUF * slot + (RB * S + 1) / 2 * 2) + 8 * NBUF;
  cudaError_t e = sm90::smem_attr_once<fbp_cn_kernel<P>>(SMEM_BUDGET);
  if (e != cudaSuccess) return (int)e;
  const int nblocks = (N + RB - 1) / RB, slots = 3 * sms;
  const int grid = nblocks < slots ? nblocks : slots;
  fbp_cn_kernel<P><<<grid, THREADS, smem, stream>>>(m, out, N, dc, S, RB,
                                                     slot, nblocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// m and out (N, dc, p) float32, contiguous, 16-byte aligned; sms the
// device's SMs (three CTAs an SM at most)
int rt_fbp_cn(const void* m, void* out, int N, int dc, int p, int sms,
              void* stream) {
  if (N == 0) return 0;
  if (dc < 1 || (uintptr_t)m % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const float* mi = (const float*)m;
  float* mo = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (p) {
    case 2: return launch<2>(mi, mo, N, dc, sms, s);
    case 3: return launch<3>(mi, mo, N, dc, sms, s);
    case 5: return launch<5>(mi, mo, N, dc, sms, s);
    case 7: return launch<7>(mi, mo, N, dc, sms, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
