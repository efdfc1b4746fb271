// Flash attention, forward and backward: three kernels for GQA attention
// with causal, sliding-window and softcap masks.
//
// Replaces src/repro/kernels/flash_attention.py: flash_fwd (:116, body
// _fwd_kernel) with flash_fwd_kernel, and flash_bwd (:236, bodies
// _bwd_dq_kernel and _bwd_dkv_kernel) with flash_bwd_dq_kernel and
// flash_bwd_dkv_kernel.
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
// Design (Hopper, sm_90a; helpers in sm90.cuh). One warpgroup of 128
// threads per (row, 64-row tile): a q tile for the forward and dq, a KV
// tile for dk/dv. Operands stay bf16 in 128-byte-swizzled shared memory
// (tiles padded with zero columns to DM = 64 or 128; ragged rows copied as
// zeros), filled in two stages so the next tile is in flight while this
// one is multiplied: by cp.async in the forward and dk/dv, by TMA tensor
// copies in dq (one thread issues them; they complete on the stage's
// mbarrier). Every product runs on wgmma with fp32 accumulators in
// registers:
//   forward  S = Q.K^T (both K-major), O += P.V (P in registers, V MN-major);
//   dq       S = Q.K^T, dP = dO.V^T (K-major), dQ += dS.K (dS in
//            registers, K MN-major from the same swizzled tile);
//   dk/dv    S^T = K.Q^T, dP^T = V.dO^T (K-major), dV += P^T.dO and
//            dK += dS^T.Q (P^T, dS^T in registers; dO, Q MN-major).
// The accumulator of S (S^T, dP, dP^T) has the register layout of the A
// fragment of the next wgmma, so P and dS never leave registers.
//
// Split-bf16 P and dS. Q, K, V and dO are bf16, so their products are
// exact in fp32 and Q.K^T, V.dO^T on the tensor cores equal the fp32
// CUDA-core products up to the order of the sums. P and dS are fp32, as
// the TPU kernel keeps them; rounding them to bf16 would cost the outputs
// several bf16 ulps. Each is split into hi = bf16(x) and lo = bf16(x - hi)
// and multiplied twice into the same accumulator: |hi + lo - x| <=
// 2^-16 |x|, far under o's half-ulp of 2^-9. The price is 1.5x the tensor-
// core work of a bf16 P.
//
// Softmax runs in log2 units (ex2 on the MUFU unit, log2 e folded into
// the scale, or applied after the softcap); the per-element mask is
// applied only on tiles that straddle the diagonal, the window's edge or a
// ragged edge (tile_full); tiles that tile_runs excludes are not visited.
// Under a causal mask the grid launches the heaviest tiles first: the last
// q tiles in the forward and dq, the first KV tiles in dk/dv. dq holds lse
// and delta per accumulator row in registers. dk/dv sum the group's g q
// heads and every visible q tile in fp32 registers and write once, without
// atomics: two calls agree bit for bit, as dq's do (one CTA per q tile).
//
// Bounds on the card (training shape, BH 64, BHkv 16, S 4096, D 64,
// causal): the forward does 137 GFLOP of products, 0.139 ms at the bf16
// tensor-core peak of 989 TFLOP/s, and 537 M exponentials, about 0.14 ms
// at 16 a clock on each of 132 SMs: the softmax is as heavy as the
// products. dq does 206 GFLOP, 0.209 ms; dk/dv 275 GFLOP, 0.278 ms.
//
// What sets the pace is latency: each warpgroup waits on its own products
// between the softmax and the next wgmma, so the kernels are tuned for
// warpgroups in flight; and the copies: with cp.async, dq moved its K/V
// tiles at about 20 GB/s an SM and ran much faster when they were skipped,
// so dq now copies by TMA. The forward is held to 96 registers (five CTAs an
// SM at DM = 64) and dq to 128 (four CTAs; three, at 132 registers, took
// 8% longer); dq and dk/dv take p while dP (dP^T) is still on the tensor
// cores; dk/dv keep 185 registers, two CTAs an SM, without spills (three
// would spill). Every register A fragment lives within one loop
// iteration: Q, K or V held as A fragments across the KV loop came out
// wrong, ptxas giving their registers to the P fragments.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <initializer_list>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64, BK = 64;          // q rows, KV rows per tile

using bf16 = __nv_bfloat16;

struct Params {
  float scale, softcap;
  int Sq, Skv, D, g, causal, window;
};

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

__device__ __forceinline__ float score(float dot, const Params& a) {
  float s = dot * a.scale;
  if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
  return s;
}

// ---------------------------------------------------------------------------
// the kernels: one warpgroup, every product on wgmma
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// whether every (q, kv) pair of the tiles at q0 and k0 is visible, so that
// no per-element mask is needed
__device__ __forceinline__ bool tile_full(int q0, int k0, const Params& a) {
  if (q0 + BQ > a.Sq || k0 + BK > a.Skv) return false;
  if (a.causal && k0 + BK - 1 > q0) return false;
  if (a.window && k0 <= q0 + BQ - 1 - a.window) return false;
  return true;
}

// [*lo, *hi] = the tiles t of n along one axis for which `runs(t)` holds
// (a contiguous range, since tile_runs bounds it from each side)
template <class F>
__device__ __forceinline__ void run_range(int n, F runs, int* lo, int* hi) {
  int t0 = 0, t1 = n - 1;
  while (t0 < n && !runs(t0)) ++t0;
  while (t1 >= t0 && !runs(t1)) --t1;
  *lo = t0;
  *hi = t1;
}

// d (64 x DM) += A (64 x 16, registers) . B (16 x DM, smem, MN-major)
template <int DM>
__device__ __forceinline__ void wgmma_pv(float (&d)[DM / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DM == 64)
    sm90::wgmma_rs_n64<1>(d, a, db);
  else
    sm90::wgmma_rs_n128<1>(d, a, db);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// this thread's accumulator rows r0 and r0 + 8 (columns c0 + 8 j + {0, 1}),
// times inv0 and inv1, rounded to bf16 into rows row0 + r0 (+ 8) of the
// (S, D) matrix `dst`; rows past S and columns past D are not written
template <int N>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&d)[N],
                                           int row0, int S, int D,
                                           float inv0, float inv1) {
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + r0 + 8 * h;
    if (gr >= S) continue;
    const float inv = h ? inv1 : inv0;
    bf16* row = dst + (long)gr * D;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const int col = 8 * j + c0;
      const float x0 = d[4 * j + 2 * h] * inv, x1 = d[4 * j + 2 * h + 1] * inv;
      if (col + 1 < D && !(D & 1)) {
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < D) row[col] = __float2bfloat16(x0);
        if (col + 1 < D) row[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// One CTA (one warpgroup) per q head and 64-row q tile; at most 96
// registers at DM = 64, five CTAs an SM. Q stays in shared memory; K/V
// tiles run through two stages of cp.async copies, the next in flight
// while the current one is multiplied. S = Q.K^T (wgmma, both
// operands K-major), the online softmax on S's registers, then O += P.V
// with P split into bf16 hi and lo A fragments (registers) and V MN-major.
template <int DM>
__global__ void __launch_bounds__(sm90::WG, DM == 64 ? 5 : 3)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, Params a, bool vec) {
  using namespace sm90;
  constexpr int TILE = BQ * DM * 2;        // bytes of a 64 x DM tile
  constexpr int NO = DM / 2;               // O accumulator registers
  extern __shared__ uint8_t smem[];
  const uint32_t Qs = (smem_u32(smem) + 1023) & ~1023u;
  const int b = blockIdx.x, D = a.D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const long kvb = b / a.g;
  const bf16* kb = k + kvb * a.Skv * D;
  const bf16* vb = v + kvb * a.Skv * D;
  int t0, t1;
  run_range((a.Skv + BK - 1) / BK,
            [&](int t) { return tile_runs(q0, t * BK, a); }, &t0, &t1);

  load_tile_async<BQ, DM>(Qs, q + (long)b * a.Sq * D, q0, a.Sq, D, vec);
  cp_async_commit();
  if (t0 <= t1) {
    load_tile_async<BK, DM>(Qs + TILE, kb, t0 * BK, a.Skv, D, vec);
    load_tile_async<BK, DM>(Qs + 2 * TILE, vb, t0 * BK, a.Skv, D, vec);
  }
  cp_async_commit();

  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4, c0 = 2 * (lane % 4);
  float acc[NO];
  zero(acc);
  // per row r0 + 8 h: running max (log2 units) and this thread's part of l
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * LOG2E;

  for (int t = t0; t <= t1; ++t) {
    const uint32_t Ks = Qs + TILE * (1 + 2 * ((t - t0) & 1)), Vs = Ks + TILE;
    __syncthreads();                 // the stage refilled next is not read
    if (t < t1) {
      const uint32_t nK = Qs + TILE * (1 + 2 * ((t + 1 - t0) & 1));
      load_tile_async<BK, DM>(nK, kb, (t + 1) * BK, a.Skv, D, vec);
      load_tile_async<BK, DM>(nK + TILE, vb, (t + 1) * BK, a.Skv, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();              // tile t has landed
    fence_async_smem();
    __syncthreads();

    float s[32];
    zero(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk)
      wgmma_ss_n64<0>(s, desc_k<BQ>(Qs, kk), desc_k<BK>(Ks, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scores in log2 units: exp2(x - m) = exp(s - m / log2 e)
    const int k0 = t * BK;
    const bool edge = !tile_full(q0, k0, a);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float x = a.softcap > 0.f ? score(s[i], a) * LOG2E : s[i] * sl2;
      if (edge && !visible(q0 + r0 + 8 * h, k0 + 8 * (i >> 2) + c0 + (i & 1),
                           a))
        x = NEG_INF;
      s[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float corr[2];
    bool alive[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      alive[h] = mn > NEG_INF / 2;
      corr[h] = alive[h] ? ex2(m[h] - mn) : 1.f;
      m[h] = mn;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float p = alive[h] ? ex2(s[i] - m[h]) : 0.f;
      s[i] = p;
      l[h] += p;
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= corr[(i >> 1) & 1];

    uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) split_a(s, kk, hi[kk], lo[kk]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_pv<DM>(acc, hi[kk], desc_mn<BK>(Vs, kk));
      wgmma_pv<DM>(acc, lo[kk], desc_mn<BK>(Vs, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float L = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / L;
    const int gq = q0 + r0 + 8 * h;
    if (gq < a.Sq && lane % 4 == 0)
      lse[(long)b * a.Sq + gq] =
          (m[h] > NEG_INF / 2 ? m[h] * LN2 : NEG_INF) + logf(L);
  }
  store_rows(o + (long)b * a.Sq * D, acc, q0, a.Sq, D, inv[0], inv[1]);
}

// TMA tensor maps of dq's operands, (D, S, heads) in bf16, read in boxes
// of 64 columns x 64 rows x 1 head (128-byte swizzle)
struct DqMaps {
  CUtensorMap q, dout, k, v;
};

// One CTA (one warpgroup) per q head and 64-row q tile, the heaviest
// tiles first. Q and dO stay in shared memory; K/V tiles run through two
// stages. With `tma` (D a multiple of 8, 16-byte aligned operands) thread
// 0 fills each tile by TMA tensor copies that complete on its stage's
// mbarrier, zero-filled past S and D; otherwise every thread gathers the
// tiles element by element. S = Q.K^T and dP = dO.V^T (wgmma, K-major), p
// on S's registers while dP is in flight (lse and delta are per row, held
// in registers), then ds; then dQ += dS.K with dS split into bf16 hi and
// lo A fragments and K read MN-major from the tile that served Q.K^T.
template <int DM>
__global__ void __launch_bounds__(sm90::WG, DM == 64 ? 4 : 2)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    const __grid_constant__ DqMaps maps, Params a,
                    bool tma) {
  using namespace sm90;
  constexpr int TILE = BQ * DM * 2;
  constexpr int NO = DM / 2;
  extern __shared__ uint8_t smem[];
  const uint32_t Qs = (smem_u32(smem) + 1023) & ~1023u, dOs = Qs + TILE;
  const uint32_t bars = Qs + 6 * TILE;   // Q and dO, then the two stages
  const int b = blockIdx.x, D = a.D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int kvb = b / a.g;
  const bf16* kb = k + (long)kvb * a.Skv * D;
  const bf16* vb = v + (long)kvb * a.Skv * D;
  int t0, t1;
  run_range((a.Skv + BK - 1) / BK,
            [&](int t) { return tile_runs(q0, t * BK, a); }, &t0, &t1);

  // the 64-row tile at row0 of head `head` of `map`, one box per 64
  // columns
  auto copy = [&](uint32_t dst, const CUtensorMap* map, int row0, int head,
                  uint32_t bar) {
#pragma unroll
    for (int cb = 0; cb < DM / 64; ++cb)
      tma_load(dst + cb * BQ * 128, map, bar, 64 * cb, row0, head);
  };
  // K and V tile t into stage st
  auto load_kv = [&](int t, int st) {
    const uint32_t Kd = Qs + TILE * (2 + 2 * st);
    if (tma) {
      if (threadIdx.x == 0) {
        mbar_expect(bars + 8 * (1 + st), 2 * TILE);
        copy(Kd, &maps.k, t * BK, kvb, bars + 8 * (1 + st));
        copy(Kd + TILE, &maps.v, t * BK, kvb, bars + 8 * (1 + st));
      }
    } else {
      load_tile_async<BK, DM>(Kd, kb, t * BK, a.Skv, D, false);
      load_tile_async<BK, DM>(Kd + TILE, vb, t * BK, a.Skv, D, false);
      fence_async_smem();
    }
  };
  if (tma) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i);
      fence_mbar_init();
    }
    __syncthreads();                 // no thread waits on an unset barrier
    if (threadIdx.x == 0) {
      mbar_expect(bars, 2 * TILE);
      copy(Qs, &maps.q, q0, b, bars);
      copy(dOs, &maps.dout, q0, b, bars);
    }
  } else {
    load_tile_async<BQ, DM>(Qs, q + (long)b * a.Sq * D, q0, a.Sq, D, false);
    load_tile_async<BQ, DM>(dOs, dout + (long)b * a.Sq * D, q0, a.Sq, D,
                            false);
  }
  if (t0 <= t1) load_kv(t0, 0);

  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4, c0 = 2 * (lane % 4);
  // rows r0 + 8 h: -lse in log2 units, and delta
  float nl[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gq = q0 + r0 + 8 * h;
    nl[h] = gq < a.Sq ? -lse[(long)b * a.Sq + gq] * LOG2E : 0.f;
    dl[h] = gq < a.Sq ? delta[(long)b * a.Sq + gq] : 0.f;
  }
  float acc[NO];
  zero(acc);
  if (tma) mbar_wait(bars, 0);       // Q and dO have landed

  for (int t = t0; t <= t1; ++t) {
    const int st = (t - t0) & 1;
    const uint32_t Ks = Qs + TILE * (2 + 2 * st), Vs = Ks + TILE;
    // the last iteration's products are done (and, gathering, this tile's
    // stores are published), so the stage refilled next is not read
    __syncthreads();
    if (t < t1) {
      if (tma && threadIdx.x == 0) fence_async_smem();
      load_kv(t + 1, st ^ 1);
    }
    if (tma) mbar_wait(bars + 8 * (1 + st), ((t - t0) >> 1) & 1);

    float s[32], dp[32];             // q rows r0 + 8 h, KV columns
    zero(s);
    zero(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk)
      wgmma_ss_n64<0>(s, desc_k<BQ>(Qs, kk), desc_k<BK>(Ks, kk), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk)
      wgmma_ss_n64<0>(dp, desc_k<BQ>(dOs, kk), desc_k<BK>(Vs, kk), 1);
    wgmma_commit();

    // p = exp(s - lse), masked; ds = p (dp - delta) scale, times
    // 1 - (s / cap)^2 under a softcap
    const int k0 = t * BK;
    const bool edge = !tile_full(q0, k0, a);
    auto prob = [&](int j, float x) {
      const int h = (j >> 1) & 1;
      return !edge || visible(q0 + r0 + 8 * h,
                              k0 + 8 * (j >> 2) + c0 + (j & 1), a)
                 ? ex2(fmaf(x, LOG2E, nl[h]))
                 : 0.f;
    };
    if (a.softcap > 0.f) {
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float x = score(s[j], a), u = x / a.softcap;
        dp[j] = prob(j, x) * (dp[j] - dl[(j >> 1) & 1]) * (1.f - u * u) *
                a.scale;
      }
    } else {                         // p while dP is still in flight
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = prob(j, s[j] * a.scale);
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        dp[j] = s[j] * (dp[j] - dl[(j >> 1) & 1]) * a.scale;
    }
    uint32_t dh[BK / 16][4], dlo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) split_a(dp, kk, dh[kk], dlo[kk]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_pv<DM>(acc, dh[kk], desc_mn<BK>(Ks, kk));
      wgmma_pv<DM>(acc, dlo[kk], desc_mn<BK>(Ks, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  store_rows(dq + (long)b * a.Sq * D, acc, q0, a.Sq, D, 1.f, 1.f);
}

// One CTA (one warpgroup) per KV head and 64-row KV tile; the warpgroup's
// rows are KV rows. K and V stay in shared memory; the (q, dO, lse, delta)
// tiles of the group's g q heads and of every q tile that can see this KV
// tile run through two stages of cp.async copies. S^T = K.Q^T and dP^T =
// V.dO^T (wgmma, K-major), p on its registers while dP^T is in flight
// (lse and delta are per column), then ds; then dV += P^T.dO and dK +=
// dS^T.Q with P^T and dS^T split into bf16 hi and lo A fragments and dO,
// Q MN-major. The sums stay in registers over the whole group; dk and dv
// are written once, in bf16.
template <int DM>
__global__ void __launch_bounds__(sm90::WG, DM == 64 ? 2 : 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Params a, bool vec) {
  using namespace sm90;
  constexpr int TILE = BK * DM * 2;
  constexpr int NO = DM / 2;
  extern __shared__ uint8_t smem[];
  const uint32_t Ks = (smem_u32(smem) + 1023) & ~1023u, Vs = Ks + TILE;
  // stage st: Q at Ks + TILE (2 + 2 st), dO after it; lse, delta rows
  // after both stages
  const uint32_t rows = Ks + 6 * TILE;
  const float* rows_p =
      reinterpret_cast<const float*>(smem + (rows - smem_u32(smem)));
  const int kvb = blockIdx.x, k0 = blockIdx.y * BK, D = a.D;
  int t0, t1;
  run_range((a.Sq + BQ - 1) / BQ,
            [&](int t) { return tile_runs(t * BQ, k0, a); }, &t0, &t1);
  const int nrun = t1 - t0 + 1, items = a.g * max(nrun, 0);

  // item i: q head kvb g + i / nrun, q tile t0 + i % nrun
  auto issue = [&](int i) {
    const int st = i & 1, q0 = (t0 + i % nrun) * BQ;
    const long b = (long)kvb * a.g + i / nrun;
    const uint32_t Qd = Ks + TILE * (2 + 2 * st);
    load_tile_async<BQ, DM>(Qd, q + b * a.Sq * D, q0, a.Sq, D, vec);
    load_tile_async<BQ, DM>(Qd + TILE, dout + b * a.Sq * D, q0, a.Sq, D,
                            vec);
    const int r = threadIdx.x % BQ, gq = q0 + r;
    const float* src = (threadIdx.x < BQ ? lse : delta) + b * a.Sq;
    cp_async4(rows + 4 * (st * 2 * BQ + threadIdx.x), gq < a.Sq ? src + gq
                                                                : src,
              gq < a.Sq ? 4 : 0);
  };
  load_tile_async<BK, DM>(Ks, k + (long)kvb * a.Skv * D, k0, a.Skv, D, vec);
  load_tile_async<BK, DM>(Vs, v + (long)kvb * a.Skv * D, k0, a.Skv, D, vec);
  cp_async_commit();
  if (items) issue(0);
  cp_async_commit();

  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4, c0 = 2 * (lane % 4);
  float acck[NO], accv[NO];
  zero(acck);
  zero(accv);

  for (int i = 0; i < items; ++i) {
    const int st = i & 1, q0 = (t0 + i % nrun) * BQ;
    const uint32_t Qs = Ks + TILE * (2 + 2 * st), dOs = Qs + TILE;
    const float* Lr = rows_p + st * 2 * BQ;
    const float* Dr = Lr + BQ;
    __syncthreads();                 // the stage refilled next is not read
    if (i + 1 < items) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();              // item i has landed
    fence_async_smem();
    __syncthreads();

    float s[32], dp[32];             // KV rows r0 + 8 h, q columns
    zero(s);
    zero(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk)
      wgmma_ss_n64<0>(s, desc_k<BK>(Ks, kk), desc_k<BQ>(Qs, kk), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk)
      wgmma_ss_n64<0>(dp, desc_k<BK>(Vs, kk), desc_k<BQ>(dOs, kk), 1);
    wgmma_commit();

    // p = exp(s - lse), masked; ds = p (dp - delta) scale, times
    // 1 - (s / cap)^2 under a softcap
    const bool edge = !tile_full(q0, k0, a);
    auto prob = [&](int j, float x) {
      const int c = 8 * (j >> 2) + c0 + (j & 1), r = r0 + 8 * ((j >> 1) & 1);
      return !edge || visible(q0 + c, k0 + r, a)
                 ? ex2(fmaf(x, LOG2E, -Lr[c] * LOG2E))
                 : 0.f;
    };
    auto delta_of = [&](int j) { return Dr[8 * (j >> 2) + c0 + (j & 1)]; };
    if (a.softcap > 0.f) {
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float x = score(s[j], a), u = x / a.softcap;
        s[j] = prob(j, x);
        dp[j] = s[j] * (dp[j] - delta_of(j)) * (1.f - u * u) * a.scale;
      }
    } else {                         // p while dP^T is still in flight
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = prob(j, s[j] * a.scale);
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        dp[j] = s[j] * (dp[j] - delta_of(j)) * a.scale;
    }
    uint32_t ph[BQ / 16][4], pl[BQ / 16][4], dh[BQ / 16][4], dl[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      split_a(s, kk, ph[kk], pl[kk]);
      split_a(dp, kk, dh[kk], dl[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_pv<DM>(accv, ph[kk], desc_mn<BQ>(dOs, kk));
      wgmma_pv<DM>(accv, pl[kk], desc_mn<BQ>(dOs, kk));
      wgmma_pv<DM>(acck, dh[kk], desc_mn<BQ>(Qs, kk));
      wgmma_pv<DM>(acck, dl[kk], desc_mn<BQ>(Qs, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acck);
    fence_regs(accv);
  }
  cp_async_wait<0>();
  const long off = (long)kvb * a.Skv * D;
  store_rows(dk + off, acck, k0, a.Skv, D, 1.f, 1.f);
  store_rows(dv + off, accv, k0, a.Skv, D, 1.f, 1.f);
}

// a 1024-byte alignment margin, then the swizzled bf16 tiles: Q and two
// stages of K and V (forward); Q, dO and two stages of K and V, then three
// mbarriers (dq); K, V and two stages of Q and dO, then two stages of the
// lse and delta rows (dk/dv)
template <int DM>
constexpr size_t fwd_smem() {
  return 1024 + 5 * (size_t)BQ * DM * 2;
}
template <int DM>
constexpr size_t dkv_smem() {
  return 1024 + 6 * (size_t)BK * DM * 2 + 2 * 2 * BQ * sizeof(float);
}
template <int DM>
constexpr size_t dq_smem() {
  return 1024 + 6 * (size_t)BQ * DM * 2 + 3 * 8;
}

template <class K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

// whether every bf16 operand can be copied in 16-byte chunks
bool vec_ok(int D, std::initializer_list<const void*> ptrs) {
  if (D % 8) return false;
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return false;
  return true;
}

template <int DM>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int BH, const Params& a, cudaStream_t st) {
  const int nq = (a.Sq + BQ - 1) / BQ;
  if (nq > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare(flash_fwd_kernel<DM>, fwd_smem<DM>());
  if (e != cudaSuccess) return (int)e;
  flash_fwd_kernel<DM><<<dim3(BH, nq), sm90::WG, fwd_smem<DM>(), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      a, vec_ok(a.D, {q, k, v}));
  return (int)cudaGetLastError();
}

// a TMA tensor map of the (heads, S, D) bf16 operand at `base`, in boxes
// of 64 x 64 x 1
bool dq_map(CUtensorMap* map, const void* base, int heads, int S, int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)BQ, 1};
  return sm90::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base,
                          dims, strides, box, true);
}

template <int DM>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int BH,
           const Params& a, cudaStream_t st) {
  const int nq = (a.Sq + BQ - 1) / BQ;
  if (nq > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare(flash_bwd_dq_kernel<DM>, dq_smem<DM>());
  if (e != cudaSuccess) return (int)e;
  DqMaps maps{};
  const bool tma = vec_ok(a.D, {q, k, v, dout}) && a.Skv > 0;
  if (tma && !(dq_map(&maps.q, q, BH, a.Sq, a.D) &&
               dq_map(&maps.dout, dout, BH, a.Sq, a.D) &&
               dq_map(&maps.k, k, BH / a.g, a.Skv, a.D) &&
               dq_map(&maps.v, v, BH / a.g, a.Skv, a.D)))
    return (int)cudaErrorInvalidValue;
  flash_bwd_dq_kernel<DM><<<dim3(BH, nq), sm90::WG, dq_smem<DM>(), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, maps, a, tma);
  return (int)cudaGetLastError();
}

template <int DM>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv,
            int BHkv, const Params& a, cudaStream_t st) {
  const int nkv = (a.Skv + BK - 1) / BK;
  if (nkv > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare(flash_bwd_dkv_kernel<DM>, dkv_smem<DM>());
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_kernel<DM><<<dim3(BHkv, nkv), sm90::WG, dkv_smem<DM>(),
                             st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, a,
      vec_ok(a.D, {q, k, v, dout}));
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
