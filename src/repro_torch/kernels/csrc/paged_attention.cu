// Protected paged attention: attention straight from corrected GF(p) pages.
//
// Replaces src/repro/kernels/paged_attention.py: attend_protected_pallas
// (body _kernel, _dequant_block, _update). Inputs: q (B, Sq, Hq, D) bf16;
// K and V pages (NP, S, W, n) int8 GF(p) codeword cells, page step j being
// S sub-pages of (Bsub, T, Hkv, D) stacked along the batch (S * Bsub = B);
// absmax scales (NP, S) f32; valid tokens (NP, B) i32; the dense hot page
// (B, T, Hkv, D) bf16 with fill levels (B,) i32, applied last when with_hot.
// Output (B, Sq, Hq, D) bf16 = acc / l of the online softmax.
//
// Split-page decode attention (flash-decoding), two kernels:
// - attend_split_kernel, a CTA per (batch row b, KV head h, page range):
//   the NP pages are cut into nsplit contiguous ranges of RP pages (the
//   wrapper's RP, from B * Hkv, T, the SMs and a page count the caller
//   may fix, such as its max_seq in pages: then a row's ranges, and the
//   bits of its output, do not depend on how many pages the other rows
//   hold, since a row's pages past its own are masked (valid 0) and only
//   add empty ranges, which the merge weighs by 0; nsplit never passes
//   one wave of CTAs, so the merge's shared memory is bounded whatever
//   NP), and each CTA runs the online
//   softmax of its (b, h) query rows over its range, PG pages a step (PG T
//   tokens: 2 pages of 16 at the serving shape, so a step has a thread
//   per q.k dot and a lane per token, and half the barriers of a step per
//   page), and writes the partial (m, l, acc) in fp32 to a scratch;
// - attend_combine_kernel, a CTA per (b, h): merges the ranges in their
//   order (m = max of the m_s, l and acc summed with the scales
//   exp(m_s - m), which are 0 for a range whose row had no valid token
//   against a valid one and 1 when no range had one, as the sequential walk
//   gives), applies the hot page last, and writes acc / max(l, 1e-30).
// No atomics: the same inputs give the same bits.
//
// Loads. Element e = ((b_sub * T + t) * Hkv + h) * D + d of a sub-page has
// its Dg base-p digits at info positions e * Dg .. e * Dg + Dg - 1 (word
// pos / k_info, column pos % k_info), so the D elements of one (b, h, t)
// are one run of D * Dg positions. A CTA computes once where each of its
// T runs starts (word w0, offset off) and copies the covering words' info
// columns into shared memory, each run's words side by side, so digit i of
// element d lies at byte off + d * Dg + i of its run: no division per
// digit. With n and k_info multiples of 16 the copies are 16-byte cp.async
// chunks (from a table of the runs' chunks built once a CTA), step i + 1's
// in flight while step i is dequantized and used; otherwise bytes. A byte
// is its Dg digits gathered by two funnel shifts and weighed by p^i with
// two dp4a; digits outside [0, p-1] (raw uncorrected cells) are clipped
// first, so they degrade and never index out of range. The byte is taken
// mod 256, recentred by 128, scaled and rounded to bf16.
//
// Math, on the CUDA cores (G * Sq query rows against PG T tokens is too
// small for the tensor cores): a thread per q.k dot (16-byte loads from
// rows padded so that a load phase's lanes hit different banks); each
// row's max and sum a warp each, by shuffles; p.V a thread per (row, d).
// Logits are fp32, masked to -1e30 past each page's valid count, m starts
// at -inf, as the reference; a step over PG pages gives the sequential
// walk's weights (a masked token weighs exp(-1e30 - m), 0 against a valid
// one and 1 while none is). The dequantized K/V values and each q.k dot
// are rounded to bf16 where the JAX package's oracle rounds them
// (its pages are dequantized to bf16 and its QK^T on bf16 operands is
// bf16), so the kernel agrees with the plain version up to the order of
// the fp32 sums; the TPU kernel skips those roundings.
//
// Bound on the card: bytes. A call reads Dg bytes of info digits per K and
// V element (6 for p = 3) and does 4 flops per element and query row, far
// below the ridge: at the serving shape (B 4, Hkv 8, D 64, T 16, NP 32,
// wl160_r08) 12.7 MB, 3.8 us at 3.35 TB/s.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr int THREADS = 256, WARPS = THREADS / 32;

struct Args {
  const __nv_bfloat16* q;
  const int8_t* kp;
  const int8_t* vp;
  const float* ks;
  const float* vs;
  const int* valid;
  const __nv_bfloat16* hk;
  const __nv_bfloat16* hv;
  const int* hvalid;
  __nv_bfloat16* out;
  float* part;              // (B * Hkv, nsplit, R, D + 2): acc, m, l
  int B, Sq, Hq, Hkv, D, T, Bsub, S, NP, W, n, k_info, p, Dg, with_hot;
  int nsplit, RP, PG;       // page ranges; pages a range; pages a step
  int NWM, span;            // words a run spans at most; a run's stride
  bool vec;                 // 16-byte copies
  // a byte's digits as dp4a operands: weights p^i of digits 0-3 and 4-7
  // (0 past Dg), masks of the Dg digit bytes, (0x80 - p) in every byte
  uint32_t wlo, whi, mlo, mhi, addc;
  float softcap;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// row stride of the Q, K and V tiles: 16-byte rows whose starts fall on
// different banks for the 8 lanes of a 16-byte load phase
__host__ __device__ __forceinline__ int row_stride(int D) {
  return (D + 3) / 4 * 4 + 4;
}

// The softmax state of a CTA's R query rows over steps of TT tokens, in
// shared memory (floats; Q, K and V 16-byte aligned).
struct Rows {
  float* Q;                 // R x DP, row r = g * Sq + sq
  float* K;                 // TT x DP
  float* V;                 // TT x DP
  float* acc;               // R x D
  float* L;                 // R x TT logits, then weights
  float* m;                 // R
  float* l;                 // R
  float* corr;              // R
};

__host__ __device__ __forceinline__ size_t rows_floats(int R, int TT, int D) {
  const size_t DP = row_stride(D);
  return (R + 2 * (size_t)TT) * DP + (size_t)R * D + (size_t)R * TT +
         3 * (size_t)R;
}

__device__ __forceinline__ Rows carve(float* sm, int R, int TT, int D) {
  const int DP = row_stride(D);
  Rows s;
  s.Q = sm;
  s.K = s.Q + R * DP;
  s.V = s.K + TT * DP;
  s.acc = s.V + TT * DP;
  s.L = s.acc + R * D;
  s.m = s.L + R * TT;
  s.l = s.m + R;
  s.corr = s.l + R;
  return s;
}

// The split kernel's shared memory past the rows' state: the runs' starts
// (3 T ints), two stages of the step's valid counts (2 PG ints) and scales
// (4 PG floats); the copies' chunk table (8-byte aligned int2s); the runs
// (16-byte aligned, in bytes).
__host__ __device__ __forceinline__ size_t table_at(int R, int TT, int D,
                                                    int T, int PG) {
  const size_t at = rows_floats(R, TT, D) + 3 * (size_t)T + 6 * (size_t)PG;
  return at + (at & 1);
}

__host__ __device__ __forceinline__ size_t runs_at(int R, int TT, int D,
                                                   int T, int PG,
                                                   size_t chunks) {
  return (4 * table_at(R, TT, D, T, PG) + 8 * chunks + 15) & ~(size_t)15;
}

// the (b, h) query rows into s.Q (the head group's G heads, Sq each)
__device__ __forceinline__ void load_q(const Rows& s, const Args& a, int b,
                                       int h, int R) {
  const int G = a.Hq / a.Hkv, D = a.D, DP = row_stride(D);
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int g = r / a.Sq, sq = r - g * a.Sq;
    s.Q[r * DP + d] = __bfloat162float(
        a.q[((long)(b * a.Sq + sq) * a.Hq + h * G + g) * D + d]);
  }
}

// One online-softmax step of the R rows over the TT tokens in s.K / s.V:
// token u belongs to page u / T of the step, whose first lim[u / T] tokens
// are real. A thread per q.k dot (16-byte loads), a warp per row's max and
// sum, a thread per (row, d) of p.V. Ends with a barrier.
__device__ void softmax_step(const Rows& s, int R, int TT, int D, int T,
                             const int* lim, float softcap) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int DP = row_stride(D), D4 = D / 4;
  const float sqrt_d = sqrtf((float)D);
  for (int pr = threadIdx.x; pr < R * TT; pr += THREADS) {
    const int r = pr / TT, u = pr - r * TT;
    const float4* q4 = reinterpret_cast<const float4*>(s.Q + r * DP);
    const float4* k4 = reinterpret_cast<const float4*>(s.K + u * DP);
    float dot = 0.f;
#pragma unroll 4
    for (int i = 0; i < D4; ++i) {
      const float4 x = q4[i], y = k4[i];
      dot = fmaf(x.x, y.x, dot);
      dot = fmaf(x.y, y.y, dot);
      dot = fmaf(x.z, y.z, dot);
      dot = fmaf(x.w, y.w, dot);
    }
    for (int d = 4 * D4; d < D; ++d)
      dot = fmaf(s.Q[r * DP + d], s.K[u * DP + d], dot);
    float x = round_bf16(dot) / sqrt_d;
    if (softcap > 0.f) x = softcap * tanhf(x / softcap);
    const int pg = u / T;
    s.L[pr] = u - pg * T < lim[pg] ? x : NEG_BIG;
  }
  __syncthreads();
  for (int r = warp; r < R; r += WARPS) {
    float* Lr = s.L + r * TT;
    float pm = -INFINITY;
    for (int u = lane; u < TT; u += 32) pm = fmaxf(pm, Lr[u]);
    pm = warp_max(pm);
    const float mo = s.m[r], mn = fmaxf(mo, pm);
    float sum = 0.f;
    for (int u = lane; u < TT; u += 32) {
      const float w = expf(Lr[u] - mn);
      Lr[u] = w;
      sum += w;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float c = expf(mo - mn);
      s.corr[r] = c;
      s.l[r] = c * s.l[r] + sum;
      s.m[r] = mn;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const float* wr = s.L + r * TT;
    float pv = 0.f;
#pragma unroll 4
    for (int u = 0; u < TT; ++u) pv = fmaf(wr[u], s.V[u * DP + d], pv);
    s.acc[idx] = s.corr[r] * s.acc[idx] + pv;
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// The info columns of the words covering the T runs of one sub-page into
// raw (run t at t * span, its word i at i * k_info): with 16-byte copies,
// chunk c of the table `chunks` (source offset in the page, destination
// offset in raw); otherwise byte by byte.
__device__ __forceinline__ void copy_runs(uint8_t* raw,
                                          const int8_t* __restrict__ page,
                                          const int2* chunks, int nchunks,
                                          const int* w0, const int* nw,
                                          const Args& a) {
  if (a.vec) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
    for (int c = threadIdx.x; c < nchunks; c += THREADS)
      cp_async16(dst + chunks[c].y, page + chunks[c].x);
    return;
  }
  const int KI = a.k_info, per_t = a.NWM * KI;
  for (int idx = threadIdx.x; idx < a.T * per_t; idx += THREADS) {
    const int t = idx / per_t, rem = idx - t * per_t;
    const int i = rem / KI, c = rem - i * KI;
    if (i < nw[t]) raw[t * a.span + rem] = page[(w0[t] + i) * a.n + c];
  }
}

// bytes of x past p - 1 or negative (as int8) clipped into [0, p - 1]
__device__ __noinline__ uint32_t clip_digits(uint32_t x, int p) {
  uint32_t y = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = (int8_t)(x >> (8 * i));
    y |= (uint32_t)(v < 0 ? 0 : (v > p - 1 ? p - 1 : v)) << (8 * i);
  }
  return y;
}

// The byte whose Dg digits start at `at` (any alignment) in shared memory:
// two funnel shifts gather digits 0-3 and 4-7 from three aligned words,
// and two dp4a weigh them by p^i. Digits outside [0, p - 1] (raw,
// uncorrected cells) are clipped first, as the reference clips them.
__device__ __forceinline__ int desym(const uint8_t* at, const Args& a) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<uintptr_t>(at) & ~(uintptr_t)3);
  const uint32_t sh = 8 * (uint32_t)(reinterpret_cast<uintptr_t>(at) & 3);
  uint32_t lo = __funnelshift_r(w[0], w[1], sh) & a.mlo;
  uint32_t hi = __funnelshift_r(w[1], w[2], sh) & a.mhi;
  const uint32_t bad = ((((lo & 0x7f7f7f7fu) + a.addc) | lo) |
                        (((hi & 0x7f7f7f7fu) + a.addc) | hi)) &
                       0x80808080u;
  if (bad) {
    lo = clip_digits(lo, a.p) & a.mlo;
    hi = clip_digits(hi, a.p) & a.mhi;
  }
  return (int)__dp4a(lo, a.wlo, __dp4a(hi, a.whi, 0u));
}

// The K and V runs of np pages (page g's at raw + 2 g run and + (2 g + 1)
// run), dequantized into token rows g T + t of s.K and s.V with page g's
// scales sc[2 g], sc[2 g + 1]: a thread walks (token, d) without
// divisions.
__device__ __forceinline__ void dequant_pages(const Rows& s,
                                              const uint8_t* raw, int run,
                                              int np, const int* off,
                                              const float* sc,
                                              const Args& a) {
  const int D = a.D, DP = row_stride(D), T = a.T;
  const int step_u = THREADS / D, step_d = THREADS % D;
  int u = threadIdx.x / D, d = threadIdx.x % D;
  int g = u / T, t = u - g * T;
  while (g < np) {
    const uint8_t* at = raw + 2 * g * run + t * a.span + off[t] + d * a.Dg;
    const int kv = desym(at, a), vv = desym(at + run, a);
    s.K[u * DP + d] = round_bf16((float)((kv & 255) - 128) * sc[2 * g]);
    s.V[u * DP + d] = round_bf16((float)((vv & 255) - 128) * sc[2 * g + 1]);
    u += step_u;
    t += step_u;
    d += step_d;
    if (d >= D) {
      d -= D;
      ++u;
      ++t;
    }
    while (t >= T) {
      t -= T;
      ++g;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
attend_split_kernel(Args a) {
  extern __shared__ float sm[];
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int R = (a.Hq / a.Hkv) * a.Sq, T = a.T, D = a.D, PG = a.PG;
  const int TT = PG * T;
  const int s_idx = b / a.Bsub, bl = b - s_idx * a.Bsub;
  const Rows s = carve(sm, R, TT, D);
  int* w0 = reinterpret_cast<int*>(s.corr + R);
  int* nw = w0 + T;
  int* off = nw + T;
  int* lims = off + T;                           // 2 stages x PG
  float* scs = reinterpret_cast<float*>(lims + 2 * PG);   // 2 x 2 PG
  int2* chunks = reinterpret_cast<int2*>(sm + table_at(R, TT, D, T, PG));
  const int cpw = a.k_info / 16;
  uint8_t* raw0 = reinterpret_cast<uint8_t*>(sm) +
                  runs_at(R, TT, D, T, PG, a.vec ? T * a.NWM * cpw : 0);
  const int run = T * a.span;          // one sub-page's K (or V) runs

  const int DDg = D * a.Dg;
  for (int t = threadIdx.x; t < T; t += THREADS) {
    // 32-bit positions within a page (the wrapper checks W * n < 2^31)
    const int pos = ((bl * T + t) * a.Hkv + h) * DDg;
    w0[t] = pos / a.k_info;
    nw[t] = (pos + DDg - 1) / a.k_info - w0[t] + 1;
    off[t] = pos - w0[t] * a.k_info;
  }
  __syncthreads();
  // the 16-byte chunks of the runs' words, in run order
  int nchunks = 0;
  for (int t = 0; t < T && a.vec; ++t) {
    const int nc = nw[t] * cpw;
    for (int c = threadIdx.x; c < nc; c += THREADS) {
      const int i = c / cpw, k = c - i * cpw;
      chunks[nchunks + c] = make_int2((w0[t] + i) * a.n + 16 * k,
                                      t * a.span + i * a.k_info + 16 * k);
    }
    nchunks += nc;
  }
  __syncthreads();

  // this CTA's pages: its range of RP pages, walked PG pages a step
  const int j0 = sp * a.RP;
  const int j1 = min(a.NP, j0 + a.RP);
  const long cells = (long)a.W * a.n;
  // the step at page j into stage st: its copies, valid counts and scales
  auto prefetch = [&](int j, int st) {
    const int np = min(PG, j1 - j);
    uint8_t* raw = raw0 + st * 2 * PG * run;
    for (int g = 0; g < np; ++g) {
      const long sub = (long)(j + g) * a.S + s_idx;
      copy_runs(raw + 2 * g * run, a.kp + sub * cells, chunks, nchunks, w0,
                nw, a);
      copy_runs(raw + (2 * g + 1) * run, a.vp + sub * cells, chunks,
                nchunks, w0, nw, a);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int g = threadIdx.x; g < np; g += THREADS) {
      const long sub = (long)(j + g) * a.S + s_idx;
      lims[st * PG + g] = a.valid[(long)(j + g) * a.B + b];
      scs[st * 2 * PG + 2 * g] = a.ks[sub];
      scs[st * 2 * PG + 2 * g + 1] = a.vs[sub];
    }
  };
  if (j0 < j1) prefetch(j0, 0);
  load_q(s, a, b, h, R);
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) s.acc[idx] = 0.f;
  for (int r = threadIdx.x; r < R; r += THREADS) {
    s.m[r] = -INFINITY;
    s.l[r] = 0.f;
  }
  for (int j = j0, st = 0; j < j1; j += PG, st ^= 1) {
    if (j + PG < j1) {
      prefetch(j + PG, st ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();                  // the step's runs are in shared memory
    const int np = min(PG, j1 - j);
    dequant_pages(s, raw0 + st * 2 * PG * run, run, np, off,
                  scs + st * 2 * PG, a);
    __syncthreads();
    softmax_step(s, R, np * T, D, T, lims + st * PG, a.softcap);
  }

  float* part = a.part +
      (((long)b * a.Hkv + h) * a.nsplit + sp) * (long)R * (D + 2);
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS)
    part[idx] = s.acc[idx];
  for (int r = threadIdx.x; r < R; r += THREADS) {
    part[R * D + r] = s.m[r];
    part[R * D + R + r] = s.l[r];
  }
}

__global__ void __launch_bounds__(THREADS)
attend_combine_kernel(Args a) {
  extern __shared__ float sm[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int R = (a.Hq / a.Hkv) * a.Sq, T = a.T, D = a.D, NS = a.nsplit;
  const int DP = row_stride(D);
  const Rows s = carve(sm, R, T, D);
  float* sc = s.corr + R;              // NS x R: m_s, then exp(m_s - m)
  float* ls = sc + NS * R;             // NS x R: l_s
  int* lim = reinterpret_cast<int*>(ls + NS * R);
  const long stride = (long)R * (D + 2);
  const float* part = a.part + ((long)b * a.Hkv + h) * NS * stride;

  // every load at once: the ranges' m and l, and the query rows and the
  // hot page's (b, h) slice
  for (int idx = threadIdx.x; idx < NS * R; idx += THREADS) {
    const int k = idx / R, r = idx - k * R;
    sc[idx] = part[k * stride + R * D + r];
    ls[idx] = part[k * stride + R * D + R + r];
  }
  if (a.with_hot) {
    load_q(s, a, b, h, R);
    for (int idx = threadIdx.x; idx < T * D; idx += THREADS) {
      const int t = idx / D, d = idx - t * D;
      const long at = ((long)(b * T + t) * a.Hkv + h) * D + d;
      s.K[t * DP + d] = __bfloat162float(a.hk[at]);
      s.V[t * DP + d] = __bfloat162float(a.hv[at]);
    }
    if (threadIdx.x == 0) lim[0] = a.hvalid[b];
  }
  __syncthreads();
  // m = the largest m_s; l = sum of exp(m_s - m) l_s, in range order
  for (int r = threadIdx.x; r < R; r += THREADS) {
    float mx = -INFINITY;
    for (int k = 0; k < NS; ++k) mx = fmaxf(mx, sc[k * R + r]);
    float l = 0.f;
    for (int k = 0; k < NS; ++k) {
      const float e = expf(sc[k * R + r] - mx);
      sc[k * R + r] = e;
      l += e * ls[k * R + r];
    }
    s.m[r] = mx;
    s.l[r] = l;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D;
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < NS; ++k)
      acc = fmaf(sc[k * R + r], part[k * stride + idx], acc);
    s.acc[idx] = acc;
  }
  __syncthreads();
  if (a.with_hot) softmax_step(s, R, T, D, T, lim, a.softcap);

  const int G = a.Hq / a.Hkv;
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const int g = r / a.Sq, sq = r - g * a.Sq;
    a.out[((long)(b * a.Sq + sq) * a.Hq + h * G + g) * D + d] =
        __float2bfloat16(s.acc[idx] / fmaxf(s.l[r], 1e-30f));
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// part: (B * Hkv, nsplit, R, D + 2) fp32 scratch, R = (Hq / Hkv) Sq;
// nsplit = ceil(NP / rp) ranges of rp pages (0 when NP is 0); pg pages a
// softmax step (fewer when the step's shared memory would pass 227 KB).
int rt_attend_protected(const void* q, const void* kp, const void* vp,
                        const void* ks, const void* vs, const void* valid,
                        const void* hk, const void* hv, const void* hvalid,
                        void* out, void* part, int B, int Sq, int Hq, int Hkv,
                        int D, int T, int Bsub, int S, int NP, int W, int n,
                        int k_info, int p, int with_hot, int nsplit, int rp,
                        int pg, float softcap, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  if (Hkv < 1 || Hq % Hkv || T < 1 || D < 1 || k_info < 1 || p < 2 ||
      pg < 1 || rp < 1 || (NP == 0 && !with_hot) ||
      nsplit != (NP + rp - 1) / rp)
    return (int)cudaErrorInvalidValue;
  int Dg = 0;
  for (long v = 1; v < 256; v *= p) ++Dg;       // ceil(log_p 256)
  // words a run of D * Dg digits spans at most (runs start at multiples of
  // D * Dg, so at offsets in a word that are multiples of g), and a run's
  // stride: 16-byte aligned, with room for desym's reads of up to 11 bytes
  // past a digit
  int g = D * Dg;
  for (int r = k_info; r;) {
    const int t = g % r;
    g = r;
    r = t;
  }
  const int NWM = (k_info - g + D * Dg + k_info - 1) / k_info;
  const int span = (NWM * k_info + 12 + 15) / 16 * 16;
  const bool vec = n % 16 == 0 && k_info % 16 == 0 &&
                   (uintptr_t)kp % 16 == 0 && (uintptr_t)vp % 16 == 0;
  uint32_t w[2] = {0, 0}, m[2] = {0, 0};
  for (int i = 0, pw = 1; i < Dg; ++i, pw *= p) {
    w[i / 4] |= (uint32_t)pw << (8 * (i % 4));    // p^i < 256 for i < Dg
    m[i / 4] |= 0xffu << (8 * (i % 4));
  }
  const int R = (Hq / Hkv) * Sq;
  // the split kernel's shared memory with PG pages a step: the rows' state
  // over PG T tokens, the runs' starts, the chunk table and two stages of
  // PG pages' K and V runs; the merge's, the rows' state over the hot page
  // and the ranges' m and l. Past the SM's 227 KB a call is refused.
  const size_t chunks = vec ? (size_t)T * NWM * (k_info / 16) : 0;
  auto split_smem = [&](int PG) {
    return runs_at(R, PG * T, D, T, PG, chunks) +
           (size_t)4 * PG * T * span;
  };
  int PG = pg;
  while (PG > 1 && split_smem(PG) > 227 * 1024) --PG;
  const size_t merge_smem = sizeof(float) * (rows_floats(R, T, D) +
                                             2 * (size_t)nsplit * R) + 4;
  if (split_smem(PG) > 227 * 1024 || merge_smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  Args a{(const __nv_bfloat16*)q, (const int8_t*)kp, (const int8_t*)vp,
         (const float*)ks, (const float*)vs, (const int*)valid,
         (const __nv_bfloat16*)hk, (const __nv_bfloat16*)hv,
         (const int*)hvalid, (__nv_bfloat16*)out, (float*)part,
         B, Sq, Hq, Hkv, D, T, Bsub, S, NP, W, n, k_info, p, Dg, with_hot,
         nsplit, rp, PG, NWM, span, vec, w[0], w[1], m[0], m[1],
         (uint32_t)(0x80 - p) * 0x01010101u, softcap};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = allow_smem((const void*)attend_split_kernel,
                             split_smem(PG));
  if (e == cudaSuccess)
    e = allow_smem((const void*)attend_combine_kernel, merge_smem);
  if (e != cudaSuccess) return (int)e;
  if (NP > 0) {
    attend_split_kernel<<<dim3(nsplit, Hkv, B), THREADS, split_smem(PG),
                          st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  attend_combine_kernel<<<dim3(Hkv, B), THREADS, merge_smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
