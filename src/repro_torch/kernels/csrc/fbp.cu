// Check-node Forward-Backward Propagation (paper §3.2.2).
//
// Replaces src/repro/kernels/fbp.py: fbp_cn_pallas. Input m (N, dc, p)
// float32, each row one check node's dc slot messages in contribution
// space (padded slots hold the max-plus identity). Output: for every slot t,
// the extrinsic conv(fm[t-1], bm[t+1]) reflected k -> -k, where fm/bm are
// the forward/backward chains of cyclic max-plus convolutions
// conv(a, b)[k] = max_j a[(k - j) mod p] + b[j].
//
// One thread runs one row. The backward chain is kept in registers
// (template MAXDC, with P a template constant so every index is static
// after unrolling); the forward chain is a running (p,) vector. Every term
// is one float add and the max is exact, and the chains run in the same
// order and with the same argument order as the plain version, so the
// output is bitwise equal to it and to the JAX oracle.
//
// Bound on the card: bytes. Each row moves 2 * dc * p * 4 bytes and does
// about 3 * dc * p^2 adds and maxes, a few operations per byte. A thread's
// row is 192 contiguous bytes (dc = 16, p = 3), so direct loads from a warp
// would touch 32 rows at once; the block instead stages its rows through
// shared memory with coalesced copies in and out (row stride padded to an
// odd number of words, so the per-thread reads do not collide on banks).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e9f;

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

template <int P, int MAXDC>
__global__ void fbp_cn_kernel(const float* __restrict__ m,
                              float* __restrict__ out, int N, int dc) {
  extern __shared__ float sm[];
  const int W = dc * P;
  const int S = W | 1;                       // odd row stride in shared
  const long base = (long)blockIdx.x * blockDim.x;
  const long left = N - base;
  const int rows = left < (long)blockDim.x ? (int)left : (int)blockDim.x;
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x)
    sm[(i / W) * S + i % W] = m[base * W + i];
  __syncthreads();

  if (threadIdx.x < rows) {
    float* row = sm + threadIdx.x * S;
    float bm[MAXDC][P];                      // bm[t] = conv of slots t..dc-1
#pragma unroll
    for (int t = MAXDC - 1; t >= 0; --t) {
      if (t < dc) {
        float a[P];
#pragma unroll
        for (int k = 0; k < P; ++k) a[k] = row[t * P + k];
        if (t == dc - 1) {
#pragma unroll
          for (int k = 0; k < P; ++k) bm[t][k] = a[k];
        } else if (t + 1 < MAXDC) {
          conv<P>(a, bm[t + 1], bm[t]);
        }
      }
    }
    if (dc == 1) {
      float ident[P];
#pragma unroll
      for (int k = 0; k < P; ++k) ident[k] = k == 0 ? 0.0f : NEG_INF;
      store_reflected<P>(row, ident);
    } else {
      float fm[P];                           // conv of slots 0..t-1
#pragma unroll
      for (int k = 0; k < P; ++k) fm[k] = row[k];
      store_reflected<P>(row, bm[1]);        // slot 0
#pragma unroll
      for (int t = 1; t < MAXDC; ++t) {
        if (t < dc - 1) {
          float ext[P], a[P], nxt[P];
          conv<P>(fm, bm[t + 1 < MAXDC ? t + 1 : MAXDC - 1], ext);
#pragma unroll
          for (int k = 0; k < P; ++k) a[k] = row[t * P + k];
          conv<P>(fm, a, nxt);
          store_reflected<P>(row + t * P, ext);
#pragma unroll
          for (int k = 0; k < P; ++k) fm[k] = nxt[k];
        } else if (t == dc - 1) {
          store_reflected<P>(row + t * P, fm);   // slot dc-1: fm[dc-2]
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x)
    out[base * W + i] = sm[(i / W) * S + i % W];
}

template <int P, int MAXDC>
int launch(const float* m, float* out, int N, int dc, cudaStream_t stream) {
  const int S = (dc * P) | 1;
  // rows per block: as many as fit 48 KB of shared memory, a multiple of 32,
  // at most 128
  int rows = (48 * 1024) / (S * (int)sizeof(float));
  rows = rows >= 128 ? 128 : (rows / 32) * 32;
  if (rows < 32) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((N + rows - 1) / rows);
  fbp_cn_kernel<P, MAXDC><<<blocks, rows, rows * S * sizeof(float), stream>>>(
      m, out, N, dc);
  return (int)cudaGetLastError();
}

template <int P>
int launch_p(const float* m, float* out, int N, int dc, cudaStream_t stream) {
  if (dc <= 16) return launch<P, 16>(m, out, N, dc, stream);
  if (dc <= 32) return launch<P, 32>(m, out, N, dc, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int rt_fbp_cn(const void* m, void* out, int N, int dc, int p, void* stream) {
  if (N == 0) return 0;
  if (dc < 1) return (int)cudaErrorInvalidValue;
  const float* mi = (const float*)m;
  float* mo = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (p) {
    case 2: return launch_p<2>(mi, mo, N, dc, s);
    case 3: return launch_p<3>(mi, mo, N, dc, s);
    case 5: return launch_p<5>(mi, mo, N, dc, s);
    case 7: return launch_p<7>(mi, mo, N, dc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
