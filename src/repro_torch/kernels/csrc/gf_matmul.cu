// GF(p) matrix product (encode) and the fused syndrome scan.
//
// Replaces src/repro/kernels/gf_matmul.py: gf_matmul_pallas ((a @ b) mod p)
// and scan_syndromes_pallas (flags[i] = any((y[i] @ Ht) mod p != 0)).
// Inputs are int8, the accumulators int32; K * 128 * 128 < 2^31 (the
// wrapper's check) keeps every sum exact.
//
// gf_matmul: the dp4a tile skeleton of tile.cuh (64 x 64 outputs a block,
// four int8 multiply-adds an instruction on the CUDA cores).
//
// scan_syndromes, on the int8 tensor cores (Hopper, sm_90a; helpers in
// sm90.cuh). The scan is S = Y . H^T with Y (M, K) the words and H (C, K)
// the parity matrix, both row-major, so both are K-major as stored, the
// only layout 8-bit wgmma reads: Y is the A operand (64 words a
// warpgroup), H the B operand (BN check rows, BN in {32, 64, 128, 208,
// 256}). A CTA of two warpgroups owns a tile of 128 words by BN checks and
// walks K in stages of 128 bytes; each stage is two TMA tensor copies (Y's
// 128 x 128 box and H's BN x 128 box, 128-byte swizzle, zero-filled past M,
// C and K) that complete on the stage's mbarrier, NS - 2 stages ahead, and
// four k32 steps of wgmma m64nBNk32 s32.s8.s8 into int32 registers. The
// CTAs are persistent: each walks the tiles blockIdx.x, + gridDim.x, ...
// as one stream of stages, so one tile's epilogue runs while the next
// tile's copies land. The epilogue, after a tile's last stage: each sum's
// divisibility by p (for odd p a multiply by p^-1 mod 2^32 and a compare,
// exact for any int32; C++'s % otherwise), OR-ed over the thread's
// columns and then over the quad of lanes that shares a row (shuffles), so
// only the (M,) flags reach device memory. Check rows past C are zero-
// filled by the copy and add no flag.
//
// Tiles: the wrapper picks the narrowest BN >= C (gf_matmul.scan_plan), so
// one tile covers every check of its words; C > 256 (wl512_r033's 343
// checks) takes chunks of 256, as does any BN < C. With more than one
// chunk the flags are zeroed on the stream first and each CTA stores only
// its ones, which gives the same bytes in any order.
//
// Bound on the card: bytes. The scan does 2 M K C integer operations on
// M K bytes, about 410 a byte at C = 205, below the ~590 the int8 tensor
// cores do per byte of HBM (1,979 TOP/s over 3.35 TB/s); the products on
// padded columns (208 for 205) stay under it. H (C x K, 210 KB at
// wl1024_r08) is read from L2 once per 128-word tile.
#include "sm90.cuh"
#include "tile.cuh"

namespace {

__global__ void __launch_bounds__(rt::THREADS)
gf_matmul_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 int32_t* __restrict__ out, int M, int N, int K, int p) {
  __shared__ rt::Tiles s;
  const long row0 = (long)blockIdx.x * rt::BM;
  const int col0 = blockIdx.y * rt::BN;
  int acc[rt::TM][rt::TN];
  rt::tile_product(s, acc, A, B, M, N, K, row0, col0);
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const long r = row0 + threadIdx.y + rt::TY * i;
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int c = col0 + threadIdx.x + rt::TX * j;
      if (r < M && c < N) out[r * N + c] = rt::mod_floor(acc[i][j], p);
    }
  }
}

constexpr int SCAN_WGS = 2, SCAN_THREADS = SCAN_WGS * sm90::WG;
constexpr int SCAN_BM = 64 * SCAN_WGS;     // words of a tile
constexpr int SCAN_BKB = 128;              // K bytes of a stage
constexpr int SCAN_YT = SCAN_BM * SCAN_BKB;

// stages of a BN-wide tile: as many as ~220 KB of shared memory holds, up
// to 8
template <int BN>
struct ScanCfg {
  static constexpr int HT = BN * SCAN_BKB, STAGE = SCAN_YT + HT;
  static constexpr int NS = (220 * 1024) / STAGE < 8
                                ? (220 * 1024) / STAGE : 8;
  // alignment margin, the stages, an mbarrier a stage
  static constexpr size_t SMEM = 1024 + (size_t)NS * STAGE + 8 * NS;
  static_assert(NS >= 3, "the copies run NS - 2 stages ahead");
};

// x == 0 mod p. For odd p: x = p q with |q| <= lim = (2^31 - 1) / p exactly
// when x * inv (inv = p^-1 mod 2^32) lies in [-lim, lim] as a signed int.
__device__ __forceinline__ bool divisible(int x, int p, uint32_t inv,
                                          uint32_t lim) {
  return inv ? (uint32_t)x * inv + lim <= 2 * lim : x % p == 0;
}

// y is the (M, K) and h the (C, K) int8 tensor map, boxes of 128 K bytes
// by 128 words and by BN checks, 128-byte swizzle. Tile t is row tile
// t / chunks, check chunk t % chunks.
template <int BN>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
scan_syndromes_kernel(const __grid_constant__ CUtensorMap y,
                      const __grid_constant__ CUtensorMap h,
                      uint8_t* __restrict__ flags, int M, int KT, int chunks,
                      int tiles, int p, uint32_t inv, uint32_t lim,
                      bool ones_only) {
  using namespace sm90;
  using Cfg = ScanCfg<BN>;
  constexpr int NS = Cfg::NS, STAGE = Cfg::STAGE;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t bars = base + NS * STAGE;
  const int wg = threadIdx.x / WG;
  const int units = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * KT;
  // stage u of this CTA's stream (tile blockIdx.x + (u / KT) gridDim.x, K
  // stage u % KT) into slot u % NS, by thread 0
  auto issue = [&](int u) {
    const int t = blockIdx.x + (u / KT) * gridDim.x, k = u % KT;
    const uint32_t st = base + (u % NS) * STAGE, bar = bars + 8 * (u % NS);
    mbar_expect(bar, STAGE);
    tma_load(st, &y, bar, k * SCAN_BKB, (t / chunks) * SCAN_BM);
    tma_load(st + SCAN_YT, &h, bar, k * SCAN_BKB, (t % chunks) * BN);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(bars + 8 * s);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int u = 0; u < NS - 2 && u < units; ++u) issue(u);

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const int lane = threadIdx.x % 32;
  // this thread's two rows of a tile: r, r + 8
  const int r0 = 64 * wg + 16 * (threadIdx.x % WG / 32) + lane / 4;

  for (int u = 0; u < units; ++u) {
    mbar_wait(bars + 8 * (u % NS), (u / NS) & 1);    // stage u has landed
    // every warp is past its wait on stage u - 1's products, so stage
    // u - 2's slot is free
    __syncthreads();
    if (threadIdx.x == 0 && u + NS - 2 < units) {
      fence_async_smem();
      issue(u + NS - 2);
    }
    const int k = u % KT;
    const uint32_t ys = base + (u % NS) * STAGE;
    const uint32_t yw = ys + wg * 64 * SCAN_BKB;    // this warpgroup's words
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < SCAN_BKB / 32; ++j)
      wgmma_s8(acc, desc_k<64>(yw, j), desc_k<BN>(ys + SCAN_YT, j),
               k != 0 || j != 0);
    wgmma_commit();
    if (k != KT - 1) {
      wgmma_wait<1>();                 // stage u - 1's products are done
      continue;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // acc[4 j + e] is row r0 + 8 (e / 2), check 8 j + 2 (lane % 4) + e % 2
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bits |= (uint32_t)!divisible(acc[4 * j + e], p, inv, lim) << (e / 2);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
    if (lane % 4 == 0) {
      const int t = blockIdx.x + (u / KT) * gridDim.x;
      const long row = (long)(t / chunks) * SCAN_BM + r0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool nz = (bits >> e) & 1;
        if (row + 8 * e < M && (nz || !ones_only)) flags[row + 8 * e] = nz;
      }
    }
  }
}

// a 2D tensor map of a row-major (rows, K) int8 matrix, read in boxes of
// 128 K bytes by `box_rows` rows, 128-byte swizzle
bool scan_map(CUtensorMap* map, const void* base, int rows, int K,
              int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {SCAN_BKB, (cuuint32_t)box_rows};
  return sm90::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims,
                          strides, box, true);
}

template <int BN>
int scan_launch(const void* y, const void* h, void* flags, int M, int C,
                int K, int p, int grid, cudaStream_t st) {
  using Cfg = ScanCfg<BN>;
  const int chunks = (C + BN - 1) / BN;
  const int tiles = (M + SCAN_BM - 1) / SCAN_BM * chunks;
  if (grid < 1 || grid > tiles) grid = tiles;
  CUtensorMap ty, th;
  if (!scan_map(&ty, y, M, K, SCAN_BM) || !scan_map(&th, h, C, K, BN))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      scan_syndromes_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Cfg::SMEM);
  if (e == cudaSuccess && chunks > 1)    // the chunks store only their ones
    e = cudaMemsetAsync(flags, 0, (size_t)M, st);
  if (e != cudaSuccess) return (int)e;
  // p^-1 mod 2^32 by Newton's iteration (each step doubles the good bits)
  uint32_t inv = 0, lim = 0;
  if (p & 1) {
    inv = (uint32_t)p;
    for (int i = 0; i < 5; ++i) inv *= 2u - (uint32_t)p * inv;
    lim = 0x7fffffffu / (uint32_t)p;
  }
  scan_syndromes_kernel<BN><<<grid, SCAN_THREADS, Cfg::SMEM, st>>>(
      ty, th, (uint8_t*)flags, M, (K + SCAN_BKB - 1) / SCAN_BKB,
      chunks, tiles, p, inv, lim, chunks > 1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rt_gf_matmul(const void* a, const void* b, void* out, int M, int N, int K,
                 int p, void* stream) {
  if (M == 0 || N == 0) return 0;
  dim3 grid((M + rt::BM - 1) / rt::BM, (N + rt::BN - 1) / rt::BN);
  gf_matmul_kernel<<<grid, dim3(rt::TX, rt::TY), 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (int32_t*)out, M, N, K, p);
  return (int)cudaGetLastError();
}

// y (M, K) and h (C, K) int8, row-major, 16-byte aligned, K a multiple of
// 16 (the tensor copies' rule; the wrapper zero-pads K); flags (M,) bool.
// bn is the check tile (32, 64, 128, 208 or 256), grid the number of
// persistent CTAs (at most the tiles).
int rt_scan_syndromes(const void* y, const void* h, void* flags, int M, int C,
                      int K, int p, int bn, int grid, void* stream) {
  if (M == 0) return 0;
  if (C < 1 || K < 16 || K % 16 || p < 2 || (uintptr_t)y % 16 ||
      (uintptr_t)h % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bn) {
    case 32: return scan_launch<32>(y, h, flags, M, C, K, p, grid, st);
    case 64: return scan_launch<64>(y, h, flags, M, C, K, p, grid, st);
    case 128: return scan_launch<128>(y, h, flags, M, C, K, p, grid, st);
    case 208: return scan_launch<208>(y, h, flags, M, C, K, p, grid, st);
    case 256: return scan_launch<256>(y, h, flags, M, C, K, p, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
