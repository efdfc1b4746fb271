// Flash attention, forward and backward: three kernels for GQA attention
// with causal, sliding-window and softcap masks.
//
// Replaces src/repro/kernels/flash_attention.py: flash_fwd (body
// _fwd_kernel) with flash_fwd_kernel, and flash_bwd (bodies _bwd_dq_kernel
// and _bwd_dkv_kernel) with flash_bwd_dq_kernel and flash_bwd_dkv_kernel.
// Operands are folded over heads and contiguous: q, do, o (BH, Sq, D);
// k, v (BHkv, Skv, D); lse, delta (BH, Sq) f32; q row b reads kv row b / g.
// q/k/v/do/o and the gradients are bf16 (the model's compute type); D is
// 1..128.
//
// What each computes (the TPU kernels' arithmetic): scores s = (q . k) *
// scale in fp32, then cap * tanh(s / cap) under a softcap; masked scores
// (causal kpos <= qpos with no diagonal offset, window kpos > qpos -
// window, and the ragged edges qpos < Sq, kpos < Skv, which play the TPU
// kernel's kv_len tail) are NEG_INF = -1e30.
//   flash_fwd: online softmax over KV tiles, m starting at NEG_INF, rows
//     that see no key yet kept at p = 0 by the `alive` guard; o = acc /
//     max(l, 1e-30) in bf16, lse = m + log(max(l, 1e-30)).
//   flash_bwd_dq: p = exp(s - lse) masked, ds = p * (dp - delta) with dp
//     = do . v, times 1 - (s/cap)^2 under a softcap, times scale; dq =
//     sum over KV of ds . k.
//   flash_bwd_dkv: for one KV tile, over the g query heads of its group
//     and every q tile: dv += p^T . do, dk += ds^T . q. The group sum is
//     taken in fp32 and dk/dv are written once per KV row, in bf16: no
//     atomics, deterministic.
//
// Design. One CTA of 256 threads per (row, 64-row tile): a q tile for the
// forward and dq kernels, a KV tile for dk/dv. The tile's operands are
// converted to fp32 in shared memory (rows padded to D + 1 floats so that
// the 16 column threads of a 4 x 4 register tile hit 16 banks), and each
// thread owns a 4 x 4 block of the 64 x 64 score tile and a 4 x D/16
// block of the output. Scores, p and every product accumulate in fp32 on
// the CUDA cores, as the TPU kernel keeps them in fp32; rounding p to
// bf16 for the tensor cores would move outputs past the tolerance the
// port holds these kernels to. KV tiles (or, for dk/dv, q tiles) that the
// causal/window mask excludes entirely are skipped, as _fwd_kernel does;
// in the backward kernels a skipped tile has p = 0, so the sums are
// unchanged. Ragged edges (Sq, Skv not multiples of 64) load as zeros and
// are masked; nothing is padded in device memory.
//
// Bound on the card: operations. At the training shape (BH 64, S 4096,
// D 64, causal) the forward does 137 GFLOP against 64 MB of operands,
// some 2,000 flops per byte, far past the ridge; the least time is the
// FLOPs over the bf16 tensor-core peak. These kernels run the products
// on the fp32 CUDA cores (67 TFLOP/s peak) with scalar shared-memory
// loads, so they sit well above that bound; wgmma on bf16 q/k/do/v for
// QK^T and dO V^T (exact products, fp32 sums) and a bf16 p under a
// stated tolerance are the speed work for a later change.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64, BK = 64;          // q rows, KV rows per tile
constexpr int TX = 16, TY = 16, THREADS = TX * TY;
constexpr int LDS = BK + 1;              // row stride of a 64 x 64 tile
constexpr int WARPS = THREADS / 32;

using bf16 = __nv_bfloat16;

struct Params {
  float scale, softcap;
  int Sq, Skv, D, g, causal, window;
};

// rows [row0, row0 + R) of a (S, D) matrix into an fp32 tile of row
// stride ld; rows past S load as 0
__device__ __forceinline__ void load_tile(float* dst,
                                          const bf16* __restrict__ src,
                                          int row0, int R, int S, int D,
                                          int ld) {
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int gr = row0 + r;
    dst[r * ld + d] = gr < S ? __bfloat162float(src[(long)gr * D + d]) : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int S) {
  for (int r = threadIdx.x; r < BQ; r += THREADS)
    dst[r] = row0 + r < S ? src[row0 + r] : 0.f;
}

__device__ __forceinline__ bool visible(int qp, int kp, const Params& a) {
  if (qp >= a.Sq || kp >= a.Skv) return false;
  if (a.causal && kp > qp) return false;
  if (a.window && kp <= qp - a.window) return false;
  return true;
}

// whether the KV tile at k0 can hold a visible key for the q tile at q0
// (the TPU kernel's `run` predicate)
__device__ __forceinline__ bool tile_runs(int q0, int k0, const Params& a) {
  if (a.causal && k0 > q0 + BQ - 1) return false;
  if (a.window && k0 + BK - 1 <= q0 - a.window) return false;
  return true;
}

// s[i][j] = A[ty + 16 i] . B[tx + 16 j] over D, both fp32 tiles of stride ld
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         int D, int ld, float s[4][4]) {
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + TY * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + TX * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

__device__ __forceinline__ float score(float dot, const Params& a) {
  float s = dot * a.scale;
  if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
  return s;
}

// p and ds of one (q tile, KV tile) pair from the score and dp tiles
__device__ __forceinline__ void grad_terms(const float s[4][4],
                                           const float dp[4][4],
                                           const float* Lr, const float* Dr,
                                           int q0, int k0, const Params& a,
                                           float* Ps, float* dSs) {
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + TY * i, c = tx + TX * j;
      const float x = score(s[i][j], a);
      const float p = visible(q0 + r, k0 + c, a) ? expf(x - Lr[r]) : 0.f;
      float ds = p * (dp[i][j] - Dr[r]);
      if (a.softcap > 0.f) {
        const float t = x / a.softcap;
        ds = ds * (1.f - t * t);
      }
      if (Ps) Ps[r * LDS + c] = p;
      dSs[r * LDS + c] = ds * a.scale;
    }
}

template <int DM>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, Params a) {
  extern __shared__ float sm[];
  constexpr int NC = DM / TX;
  const int D = a.D, ld = D + 1;
  float* Qs = sm;                   // BQ x ld
  float* Ks = Qs + BQ * ld;         // BK x ld
  float* Vs = Ks + BK * ld;         // BK x ld
  float* Ss = Vs + BK * ld;         // BQ x LDS scores, then p
  float* mrow = Ss + BQ * LDS;
  float* lrow = mrow + BQ;
  float* crow = lrow + BQ;
  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const long kvb = b / a.g;
  const bf16* kb = k + kvb * a.Skv * D;
  const bf16* vb = v + kvb * a.Skv * D;
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  load_tile(Qs, q + (long)b * a.Sq * D, q0, BQ, a.Sq, D, ld);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    mrow[r] = NEG_INF;
    lrow[r] = 0.f;
  }

  for (int k0 = 0; k0 < a.Skv; k0 += BK) {
    if (!tile_runs(q0, k0, a)) continue;        // uniform over the CTA
    __syncthreads();               // the previous tile's readers are done
    load_tile(Ks, kb, k0, BK, a.Skv, D, ld);
    load_tile(Vs, vb, k0, BK, a.Skv, D, ld);
    __syncthreads();
    float s[4][4];
    dot_tile(Qs, Ks, D, ld, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + TY * i, c = tx + TX * j;
        Ss[r * LDS + c] =
            visible(q0 + r, k0 + c, a) ? score(s[i][j], a) : NEG_INF;
      }
    __syncthreads();
    // online softmax: each warp owns BQ / WARPS rows, two columns a lane
    for (int rr = 0; rr < BQ / WARPS; ++rr) {
      const int r = warp * (BQ / WARPS) + rr;
      float* Sr = Ss + r * LDS;
      const float x0 = Sr[lane], x1 = Sr[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mo = mrow[r], mn = fmaxf(mo, mx);
      const bool alive = mn > NEG_INF / 2;
      const float p0 = alive ? expf(x0 - mn) : 0.f;
      const float p1 = alive ? expf(x1 - mn) : 0.f;
      Sr[lane] = p0;
      Sr[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float c = alive ? expf(mo - mn) : 1.f;
        crow[r] = c;
        lrow[r] = lrow[r] * c + sum;
        mrow[r] = mn;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = crow[ty + TY * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= c;
    }
    for (int t = 0; t < BK; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + TY * i) * LDS + t];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = tx + TX * j;
        const float vv = col < D ? Vs[t * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + TY * i, gq = q0 + r;
    if (gq >= a.Sq) continue;
    const float L = fmaxf(lrow[r], 1e-30f);
    bf16* orow = o + ((long)b * a.Sq + gq) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + TX * j;
      if (col < D) orow[col] = __float2bfloat16(acc[i][j] / L);
    }
    if (tx == 0) lse[(long)b * a.Sq + gq] = mrow[r] + logf(L);
  }
}

template <int DM>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    Params a) {
  extern __shared__ float sm[];
  constexpr int NC = DM / TX;
  const int D = a.D, ld = D + 1;
  float* Qs = sm;                   // BQ x ld
  float* dOs = Qs + BQ * ld;        // BQ x ld
  float* Ks = dOs + BQ * ld;        // BK x ld
  float* Vs = Ks + BK * ld;         // BK x ld
  float* dSs = Vs + BK * ld;        // BQ x LDS
  float* Lr = dSs + BQ * LDS;
  float* Dr = Lr + BQ;
  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const long kvb = b / a.g;
  const bf16* kb = k + kvb * a.Skv * D;
  const bf16* vb = v + kvb * a.Skv * D;
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  load_tile(Qs, q + (long)b * a.Sq * D, q0, BQ, a.Sq, D, ld);
  load_tile(dOs, dout + (long)b * a.Sq * D, q0, BQ, a.Sq, D, ld);
  load_rows(Lr, lse + (long)b * a.Sq, q0, a.Sq);
  load_rows(Dr, delta + (long)b * a.Sq, q0, a.Sq);

  for (int k0 = 0; k0 < a.Skv; k0 += BK) {
    if (!tile_runs(q0, k0, a)) continue;
    __syncthreads();
    load_tile(Ks, kb, k0, BK, a.Skv, D, ld);
    load_tile(Vs, vb, k0, BK, a.Skv, D, ld);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile(Qs, Ks, D, ld, s);
    dot_tile(dOs, Vs, D, ld, dp);
    grad_terms(s, dp, Lr, Dr, q0, k0, a, nullptr, dSs);
    __syncthreads();
    for (int t = 0; t < BK; ++t) {
      float dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = dSs[(ty + TY * i) * LDS + t];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = tx + TX * j;
        const float kv = col < D ? Ks[t * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dv[i], kv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + ty + TY * i;
    if (gq >= a.Sq) continue;
    bf16* row = dq + ((long)b * a.Sq + gq) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + TX * j;
      if (col < D) row[col] = __float2bfloat16(acc[i][j]);
    }
  }
}

template <int DM>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Params a) {
  extern __shared__ float sm[];
  constexpr int NC = DM / TX;
  const int D = a.D, ld = D + 1;
  float* Ks = sm;                   // BK x ld
  float* Vs = Ks + BK * ld;         // BK x ld
  float* Qs = Vs + BK * ld;         // BQ x ld
  float* dOs = Qs + BQ * ld;        // BQ x ld
  float* Ps = dOs + BQ * ld;        // BQ x LDS
  float* dSs = Ps + BQ * LDS;       // BQ x LDS
  float* Lr = dSs + BQ * LDS;
  float* Dr = Lr + BQ;
  const int kvb = blockIdx.y, k0 = blockIdx.x * BK;
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;

  float acck[4][NC], accv[4][NC];   // KV rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acck[i][j] = accv[i][j] = 0.f;
  load_tile(Ks, k + (long)kvb * a.Skv * D, k0, BK, a.Skv, D, ld);
  load_tile(Vs, v + (long)kvb * a.Skv * D, k0, BK, a.Skv, D, ld);

  for (int h = 0; h < a.g; ++h) {
    const long b = (long)kvb * a.g + h;
    for (int q0 = 0; q0 < a.Sq; q0 += BQ) {
      if (!tile_runs(q0, k0, a)) continue;
      __syncthreads();
      load_tile(Qs, q + b * a.Sq * D, q0, BQ, a.Sq, D, ld);
      load_tile(dOs, dout + b * a.Sq * D, q0, BQ, a.Sq, D, ld);
      load_rows(Lr, lse + b * a.Sq, q0, a.Sq);
      load_rows(Dr, delta + b * a.Sq, q0, a.Sq);
      __syncthreads();
      float s[4][4], dp[4][4];      // q rows ty + 16 i, KV columns tx + 16 j
      dot_tile(Qs, Ks, D, ld, s);
      dot_tile(dOs, Vs, D, ld, dp);
      grad_terms(s, dp, Lr, Dr, q0, k0, a, Ps, dSs);
      __syncthreads();
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[r * LDS + ty + TY * i];
          dsv[i] = dSs[r * LDS + ty + TY * i];
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int col = tx + TX * j;
          const float qv = col < D ? Qs[r * ld + col] : 0.f;
          const float dov = col < D ? dOs[r * ld + col] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            accv[i][j] = fmaf(pv[i], dov, accv[i][j]);
            acck[i][j] = fmaf(dsv[i], qv, acck[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gk = k0 + ty + TY * i;
    if (gk >= a.Skv) continue;
    const long off = ((long)kvb * a.Skv + gk) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = tx + TX * j;
      if (col < D) {
        dk[off + col] = __float2bfloat16(acck[i][j]);
        dv[off + col] = __float2bfloat16(accv[i][j]);
      }
    }
  }
}

size_t fwd_smem(int D) {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + BQ * LDS + 3 * BQ);
}
size_t dq_smem(int D) {
  return sizeof(float) *
         ((size_t)(2 * BQ + 2 * BK) * (D + 1) + BQ * LDS + 2 * BQ);
}
size_t dkv_smem(int D) {
  return sizeof(float) *
         ((size_t)(2 * BQ + 2 * BK) * (D + 1) + 2 * BQ * LDS + 2 * BQ);
}

template <class K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

template <int DM>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int BH, const Params& a, cudaStream_t st) {
  const size_t smem = fwd_smem(a.D);
  cudaError_t e = prepare(flash_fwd_kernel<DM>, smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_kernel<DM><<<dim3((a.Sq + BQ - 1) / BQ, BH), THREADS, smem,
                         st>>>((const bf16*)q, (const bf16*)k,
                               (const bf16*)v, (bf16*)o, (float*)lse, a);
  return (int)cudaGetLastError();
}

template <int DM>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int BH,
           const Params& a, cudaStream_t st) {
  const size_t smem = dq_smem(a.D);
  cudaError_t e = prepare(flash_bwd_dq_kernel<DM>, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<DM><<<dim3((a.Sq + BQ - 1) / BQ, BH), THREADS, smem,
                            st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, a);
  return (int)cudaGetLastError();
}

template <int DM>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv,
            int BHkv, const Params& a, cudaStream_t st) {
  const size_t smem = dkv_smem(a.D);
  cudaError_t e = prepare(flash_bwd_dkv_kernel<DM>, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_kernel<DM><<<dim3((a.Skv + BK - 1) / BK, BHkv), THREADS,
                             smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, a);
  return (int)cudaGetLastError();
}

// checks shared by the entry points; fills `a`
int setup(Params& a, int BH, int Sq, int Skv, int D, int g, int causal,
          int window, float scale, float softcap) {
  if (D < 1 || D > 128 || g < 1 || BH % g || BH > 65535 || Sq < 0 ||
      Skv < 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  a = Params{scale, softcap, Sq, Skv, D, g, causal, window};
  return 0;
}

}  // namespace

// Each entry point instantiates its kernel for a head dim of at most 64 or
// at most 128 output columns per row.
extern "C" {

int rt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int BH, int Sq, int Skv, int D, int g, int causal,
                 int window, float scale, float softcap, void* stream) {
  Params a;
  const int err =
      setup(a, BH, Sq, Skv, D, g, causal, window, scale, softcap);
  if (err) return err;
  if (BH == 0 || Sq == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return D <= 64 ? fwd<64>(q, k, v, o, lse, BH, a, st)
                 : fwd<128>(q, k, v, o, lse, BH, a, st);
}

int rt_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int BH, int Sq, int Skv, int D, int g,
                    int causal, int window, float scale, float softcap,
                    void* stream) {
  Params a;
  const int err =
      setup(a, BH, Sq, Skv, D, g, causal, window, scale, softcap);
  if (err) return err;
  if (BH == 0 || Sq == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return D <= 64 ? bwd_dq<64>(q, k, v, dout, lse, delta, dq, BH, a, st)
                 : bwd_dq<128>(q, k, v, dout, lse, delta, dq, BH, a, st);
}

int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int BH, int Sq, int Skv, int D,
                     int g, int causal, int window, float scale,
                     float softcap, void* stream) {
  Params a;
  const int err =
      setup(a, BH, Sq, Skv, D, g, causal, window, scale, softcap);
  if (err) return err;
  if (BH == 0 || Skv == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return D <= 64
             ? bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH / g, a, st)
             : bwd_dkv<128>(q, k, v, dout, lse, delta, dk, dv, BH / g, a,
                            st);
}

}  // extern "C"
