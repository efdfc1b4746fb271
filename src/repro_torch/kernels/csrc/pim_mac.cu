// Bit-line PIM MAC with a per-row-group ADC clip, on the int8 tensor cores.
//
// Replaces src/repro/kernels/pim_mac.py: pim_mac_pallas,
// Y = sum over groups g of clip(x_g . w_g, -half, half), where a group is
// R consecutive rows of K (the array's row parallelism) and half is
// adc_levels // 2. With adc_levels = 0 the groups are not tracked and the
// kernel is an exact integer product.
//
// Design (Hopper, sm_90a; helpers in sm90.cuh). A CTA of two warpgroups
// owns a 128 x 128 output tile, each warpgroup 64 of its rows, and a range
// of K. X (M, K) and W (K, N), both row-major, stream through six stages
// of 128 K bytes, each filled by two TMA tensor copies that complete on the
// stage's mbarrier: X straight into a 128-byte-swizzled 128 x 128 tile (the
// copy applies the swizzle), W into a plain 128 x 128 staging tile; the
// copies zero-fill past M, N and K. 8-bit wgmma takes only K-major
// operands, so each W tile is transposed in shared memory into a swizzled
// tile of 128 n rows of 128 k bytes (transpose_w: 4 x 4 byte transposes by
// byte_perm, bank-conflict free), which both warpgroups read; two such
// tiles alternate, so that one is written while the other is multiplied.
// Each stage is four k32 steps of wgmma m64n128k32 s32.s8.s8 into int32
// registers. The products are exact: |x w| <= 2^14, and K <= INT8_K_MAX
// keeps every sum in int32.
//
// The copies set the pace of the first design: 16-byte cp.async chunks
// (eight a thread a stage) moved about 20 GB/s an SM whatever the stages
// in flight, and removing the wgmmas left its time unchanged. One thread
// now issues two TMA copies a stage, four stages ahead.
//
// The clip: a group is R / 32 k32 steps (the wrapper zero-pads each group
// to a multiple of 32 rows; zero rows add 0 to a partial). A group's first
// step starts its accumulator from 0 (scale-d 0); after its last step the
// warpgroup waits for its products, clamps the accumulator to
// [-half, half] and adds it to the int32 total, while the other warpgroup's
// products keep the tensor cores busy. (Two group accumulators that
// alternate within a warpgroup timed slower: at 128 columns they spill,
// and at 64 columns the CTAs double.) Without a clip one accumulator takes
// every step.
//
// K split: at the PIM shape (256 x 8192 x 2560) there are only 40 output
// tiles for 132 SMs, so grid z splits K into ranges of whole groups and
// whole stages (the wrapper's kper). The partials are integers, so the
// int32 atomic adds into the output (zeroed on the stream first) give the
// same bits in any order; with one range the tile is stored directly.
//
// Bound on the card: bytes (X, W once, Y once), at the PIM shape 25.8 MB,
// 7.7 us at 3.35 TB/s, against 10.7 G integer operations, 5.4 us at the
// int8 tensor cores' 1,979 TOP/s. The clamp adds three int32 operations
// per output and group on the CUDA cores (84 M clamps at R = 64).
#include <cstdint>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int WGS = 2, THREADS = WGS * sm90::WG;   // warpgroups of a CTA
constexpr int BM = 64 * WGS, BN = 128;     // output rows, columns of a CTA
constexpr int BKB = 128;                   // K bytes per stage
constexpr int NS = 6;                      // stages
constexpr int XT = BM * BKB, WT = BKB * BN, STAGE = XT + WT;
// alignment margin, the stages (X tile, staged W tile), two transposed W
// tiles, an mbarrier a stage
constexpr size_t SMEM = 1024 + (size_t)NS * STAGE + 2 * WT + 8 * NS;

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// The staged BKB x BN tile at `raw` (k rows of n bytes) into the swizzled
// K-major BN x BKB tile at `wt` (n rows of k bytes). Thread j of the CTA
// takes the n quad 4 (j % 32) and the 16-byte chunk j / 32 of k: 16 words
// (4 n bytes of 16 k rows; a warp's reads cover whole rows) become the 4
// chunks of those n rows by four 4 x 4 byte transposes. Each lane writes
// its four rows starting at a rotation (lane / 2) % 4, folded into the
// byte_perm selectors, so the eight lanes that store together land on
// eight different chunks of the swizzle.
__device__ __forceinline__ void transpose_w(uint32_t raw, uint32_t wt) {
  static_assert(THREADS == (BN / 4) * (BKB / 16), "one job a thread");
  const int nq = threadIdx.x % 32, kc = threadIdx.x / 32;
  const int r0 = (nq >> 1) & 3, r1 = (r0 + 1) & 3, r2 = (r0 + 2) & 3,
            r3 = (r0 + 3) & 3;
  // bytes (r, r + 1) of two k rows, interleaved
  const uint32_t s01 = r0 | (4 + r0) << 4 | r1 << 8 | (4 + r1) << 12;
  const uint32_t s23 = r2 | (4 + r2) << 4 | r3 << 8 | (4 + r3) << 12;
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i] = lds32(raw + (16 * kc + i) * BN + 4 * nq);
  uint32_t o[4][4];                  // o[q][j]: k rows 4q.., n = 4 nq + rj
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t t0 = __byte_perm(w[4 * q], w[4 * q + 1], s01);
    const uint32_t t1 = __byte_perm(w[4 * q], w[4 * q + 1], s23);
    const uint32_t t2 = __byte_perm(w[4 * q + 2], w[4 * q + 3], s01);
    const uint32_t t3 = __byte_perm(w[4 * q + 2], w[4 * q + 3], s23);
    o[q][0] = __byte_perm(t0, t2, 0x5410);
    o[q][1] = __byte_perm(t0, t2, 0x7632);
    o[q][2] = __byte_perm(t1, t3, 0x5410);
    o[q][3] = __byte_perm(t1, t3, 0x7632);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    sts128(wt + sm90::sw128<BN>(4 * nq + ((r0 + j) & 3), kc), o[0][j],
           o[1][j], o[2][j], o[3][j]);
}

template <int N>
__device__ __forceinline__ void clip_add(int (&tot)[N], const int (&g)[N],
                                         int half) {
#pragma unroll
  for (int i = 0; i < N; ++i) tot[i] += min(max(g[i], -half), half);
}

// x is the (M, K) and w the (K, N) int8 tensor map: boxes of 128 x 128
// bytes of X (128-byte swizzle) and of W (none).
template <bool CLIP>
__global__ void __launch_bounds__(THREADS, 1)
pim_mac_kernel(const __grid_constant__ CUtensorMap x,
               const __grid_constant__ CUtensorMap w,
               int32_t* __restrict__ out, int M, int N, int K, int kper,
               int RS, int half, bool atomic) {
  using namespace sm90;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t wts = base + NS * STAGE;       // the two transposed tiles
  const uint32_t bars = wts + 2 * WT;           // an mbarrier a stage
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wg = threadIdx.x / WG;
  const int kb = blockIdx.z * kper, ke = min(K, kb + kper);
  const int nt = (ke - kb + BKB - 1) / BKB;
  // tile t of this CTA's range into stage t % NS (by thread 0); a range
  // ends at a multiple of BKB or at K, past which the copy reads zeros
  auto issue = [&](int t) {
    const uint32_t st = base + (t % NS) * STAGE, bar = bars + 8 * (t % NS);
    mbar_expect(bar, STAGE);
    tma_load(st, &x, bar, kb + t * BKB, m0);
    tma_load(st + XT, &w, bar, n0, kb + t * BKB);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(bars + 8 * s);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < NS - 2 && t < nt; ++t) issue(t);

  int tot[BN / 2], g[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) tot[i] = g[i] = 0;
  int pos = 0;                 // k32 step within the current group

  for (int t = 0; t < nt; ++t) {
    mbar_wait(bars + 8 * (t % NS), (t / NS) & 1);   // tile t has landed
    // every warp is past its wait on tile t - 1's products, so tile t - 2's
    // stage and transposed tile are free (the proxy fence orders this
    // CTA's reads of the stage before the copy's writes)
    __syncthreads();
    if (threadIdx.x == 0 && t + NS - 2 < nt) {
      fence_async_smem();
      issue(t + NS - 2);
    }
    const uint32_t xs = base + (t % NS) * STAGE;
    const uint32_t ws = wts + (t & 1) * WT;
    transpose_w(xs + XT, ws);
    fence_async_smem();
    __syncthreads();

    const uint32_t xw = xs + wg * 64 * BKB;     // this warpgroup's X rows
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BKB / 32; ++j) {
      const uint64_t da = desc_k<64>(xw, j), db = desc_k<BN>(ws, j);
      if (!CLIP) {
        wgmma_s8_n128(tot, da, db, 1);
        continue;
      }
      wgmma_s8_n128(g, da, db, pos != 0);
      if (++pos == RS) {                    // the group's last step
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(g);
        clip_add(tot, g, half);
        wgmma_fence();
        pos = 0;
      }
    }
    wgmma_commit();
    wgmma_wait<1>();                        // tile t - 1's products are done
  }
  wgmma_wait<0>();
  fence_regs(tot);

  // tot[4 j + e] is row r0 + 8 (e / 2), column 8 j + c0 + e % 2
  const int lane = threadIdx.x % 32;
  const int r0 = 64 * wg + 16 * (threadIdx.x % WG / 32) + lane / 4;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = m0 + r0 + 8 * h;
    if (gr >= M) continue;
    int32_t* row = out + (long)gr * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + c0;
      const int v0 = tot[4 * j + 2 * h], v1 = tot[4 * j + 2 * h + 1];
      if (atomic) {
        if (col < N) atomicAdd(row + col, v0);
        if (col + 1 < N) atomicAdd(row + col + 1, v1);
      } else if (col + 1 < N && !(N & 1)) {
        *reinterpret_cast<int2*>(row + col) = make_int2(v0, v1);
      } else {
        if (col < N) row[col] = v0;
        if (col + 1 < N) row[col + 1] = v1;
      }
    }
  }
}

// a 2D tensor map of a row-major (rows, cols) int8 matrix with row stride
// ld bytes, read in boxes of 128 x 128 bytes
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                int ld, bool swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {128, 128};
  return sm90::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims,
                          strides, box, swizzle);
}

template <bool CLIP>
int launch(const void* x, const void* w, void* out, int M, int N, int K,
           int ldw, int kper, int RS, int half, cudaStream_t st) {
  const int nz = (K + kper - 1) / kper;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, nz);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!tensor_map(&tx, x, M, K, K, true) ||
      !tensor_map(&tw, w, K, N, ldw, false))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      pim_mac_kernel<CLIP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e == cudaSuccess && nz > 1)     // the ranges add into a zeroed out
    e = cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  pim_mac_kernel<CLIP><<<grid, THREADS, SMEM, st>>>(
      tx, tw, (int32_t*)out, M, N, K, kper, RS, half, nz > 1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) and w (K, N) int8, row-major (w's row stride ldw >= N); out
// (M, N) int32. The tensor copies need K and ldw multiples of 16 and
// 16-byte aligned x and w. K is cut into ranges of kper bytes, one per
// grid z; kper is a multiple of the 128-byte stage and, with a clip, of R
// (a multiple of 32). With more than one range `out` is zeroed on the
// stream first and the CTAs add into it.
int rt_pim_mac(const void* x, const void* w, void* out, int M, int N, int K,
               int ldw, int R, int adc_levels, int kper, void* stream) {
  if (M == 0 || N == 0) return 0;
  const bool clip = adc_levels > 0;
  if (K < 0 || K % 16 || ldw < N || ldw % 16 || (uintptr_t)x % 16 ||
      (uintptr_t)w % 16 || kper <= 0 || kper % BKB)
    return (int)cudaErrorInvalidValue;
  if (clip && (R <= 0 || R % 32 || K % R || kper % R))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (K == 0)                         // no products: Y is 0
    return (int)cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(int32_t), st);
  return clip ? launch<true>(x, w, out, M, N, K, ldw, kper, R / 32,
                             adc_levels / 2, st)
              : launch<false>(x, w, out, M, N, K, ldw, kper, 1, 0, st);
}

}  // extern "C"
