// GF(p) matrix product (encode) and the fused syndrome scan, on the int8
// tensor cores (Hopper, sm_90a; helpers in sm90.cuh).
//
// Replaces src/repro/kernels/gf_matmul.py: gf_matmul_pallas ((a @ b) mod p)
// and scan_syndromes_pallas (flags[i] = any((y[i] @ Ht) mod p != 0)).
// Inputs are int8, the accumulators int32; K * 128 * 128 < 2^31 (the
// wrapper's check) keeps every sum exact.
//
// Both are S = A . B^T with A (M, K) the words and B (C, K) the right
// operand K-major (H for the scan; P^T for the encode, which the wrapper
// keeps per P tensor), the only layout 8-bit wgmma reads: A is the wgmma's
// A operand (64 words a warpgroup), B its B operand (BN columns, BN in
// {32, 64, 128, 208, 256}). One main loop serves both (s8_stream): a CTA
// of two warpgroups owns a tile of 128 words by BN columns and walks K in
// stages of 128 bytes; each stage's copies complete on the stage's
// mbarrier, NS - 2 stages ahead, and each stage is four k32 steps of wgmma
// m64nBNk32 s32.s8.s8 into int32 registers. The CTAs are persistent: each
// walks the tiles blockIdx.x, + gridDim.x, ... as one stream of stages, so
// one tile's epilogue runs while the next tile's copies land. Tile t is
// row tile t / chunks, column chunk t % chunks. The two kernels differ in
// how A arrives and in the epilogue:
//
// - scan_syndromes: A and B by TMA tensor copies (128-byte swizzle, zero-
//   filled past M, C and K; the wrapper zero-pads K to a multiple of 16).
//   Epilogue: each sum's divisibility by p (for odd p a multiply by p^-1
//   mod 2^32 and a compare, exact for any int32; C++'s % otherwise), OR-ed
//   over the thread's columns and then over the quad of lanes that shares
//   a row (shuffles), so only the (M,) flags reach device memory. With
//   more than one chunk (C > 256) the flags are zeroed on the stream first
//   and each CTA stores only its ones, which gives the same bytes in any
//   order.
// - gf_matmul: A's rows are K bytes apart, for most codes no multiple of
//   16 (k = 819 at wl1024_r08), which no tensor map can stride and no
//   16-byte copy can start. So the threads load A themselves: the aligned
//   16-byte words that cover each chunk of a stage, two stages ahead into
//   registers, shifted (byte_perm) into the swizzled A tile; two A tiles
//   alternate, so that one is written while the other is multiplied. B
//   by TMA as in the scan. Epilogue: each sum's floored residue mod p,
//   exact for any int32 (a bias that is a multiple of p makes it
//   non-negative, then a 32-bit multiply-high divide), stored as int32.
//   When a tile covers every column (one chunk) its 128 rows are one
//   contiguous range: each warp stages 4 rows at a time in its
//   warpgroup's A tiles, free once its products are done, and writes them
//   with 16-byte stores (rows of N int32 are 4 N bytes apart, which
//   16-byte stores cannot address straight from registers when N is odd).
//   Narrower column chunks store each residue directly.
//
//   Copying A by TMA instead measured slower on an H100 (`chip_smoke.py`
//   phase 2 at 4096 x 819 x 205, 7 stages a CTA; PERF.md): 0.041 ms of
//   device time with one 1-D bulk copy a row (128 a stage), 0.027 with
//   tensor copies of groups of G = 16 / gcd(K, 16) rows (whose stride is a
//   multiple of 16; a box must also start on a 16-byte boundary, so 16
//   boxes of 144 bytes a stage) shifted in shared memory, 0.0155 with the
//   threads' own loads.
//
// Bound on the card: bytes. The scan does 2 M K C integer operations on
// M K bytes, about 410 a byte at C = 205, below the ~590 the int8 tensor
// cores do per byte of HBM (1,979 TOP/s over 3.35 TB/s); the encode reads
// M K bytes and writes 4 M N, about 200 operations a byte. B (C x K, 210
// KB at wl1024_r08) is read from L2 once per 128-word tile. For few words
// `gf_plan` splits the encode's columns over more CTAs (residues of
// different chunks are disjoint, so nothing is zeroed first).
#include "sm90.cuh"

namespace {

using sm90::WG;

constexpr int WGS = 2, THREADS = WGS * WG;
constexpr int BM = 64 * WGS;               // words of a tile
constexpr int BKB = 128;                   // K bytes of a stage
constexpr int SMEM_MAX = 227 * 1024;       // a CTA's shared memory

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// A stage of a CTA's stream: the u-th (slot u % NS), K stage k of tile t,
// which is row tile rt = t / chunks and column chunk ch = t % chunks;
// next() steps to the following stage without a division but at a tile's
// end.
struct Stage {
  int u, k, t, rt, ch;
  __device__ Stage(int chunks) : u(0), k(0), t(blockIdx.x) {
    rt = t / chunks;
    ch = t - rt * chunks;
  }
  __device__ void next(int KT, int chunks) {
    ++u;
    if (++k < KT) return;
    k = 0;
    t += gridDim.x;
    rt = t / chunks;
    ch = t - rt * chunks;
  }
};

// The main loop of both kernels. Op says where a stage's operands land and
// what a tile's epilogue does:
//   Op::NS                  stages of the ring (copies run NS - 2 ahead)
//   Op::REALIGN             whether A's tiles are written by the threads
//                           from words they load themselves (then a second
//                           barrier a stage)
//   op.bars                 the stages' mbarriers, 8 bytes each
//   op.issue(s)             by warp 0's 32 lanes: stage s's copies
//   op.load(s, w)           (REALIGN) by every thread: its words of stage s
//                           into registers w, two stages ahead
//   op.realign(s, w)        (REALIGN) stage s's A tile from its words w
//   op.a(s, wg), op.b(s)    warpgroup wg's 64 x 128-byte swizzled A tile
//                           and the BN x 128-byte swizzled B tile of s
//   op.epilogue(acc, s)     the int32 sums of stage s's tile, after its
//                           last stage
template <int BN, class Op>
__device__ __forceinline__ void s8_stream(Op& op, int KT, int chunks,
                                          int tiles) {
  using namespace sm90;
  constexpr int NS = Op::NS;
  const int wg = threadIdx.x / WG;
  const int units =
      (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * KT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(op.bars + 8 * s);
    fence_mbar_init();
  }
  __syncthreads();
  Stage cur(chunks), in(chunks), ld(chunks);  // multiplied, copied, loaded
  for (; in.u < NS - 2 && in.u < units; in.next(KT, chunks))
    if (threadIdx.x < 32) op.issue(in);
  typename Op::Words w0{}, w1{};              // stage cur's and the next's
  if constexpr (Op::REALIGN) {
    if (ld.u < units) {
      op.load(ld, w0);
      ld.next(KT, chunks);
    }
    if (ld.u < units) {
      op.load(ld, w1);
      ld.next(KT, chunks);
    }
  }

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  for (; cur.u < units; cur.next(KT, chunks)) {
    const int u = cur.u;
    mbar_wait(op.bars + 8 * (u % NS), (u / NS) & 1);  // stage u has landed
    // every warp is past its wait on stage u - 1's products, so stage
    // u - 2's slot (and, with REALIGN, the A tile it was multiplied from)
    // is free
    __syncthreads();
    if (in.u < units) {
      if (threadIdx.x < 32) {
        fence_async_smem();
        op.issue(in);
      }
      in.next(KT, chunks);
    }
    if constexpr (Op::REALIGN) {
      op.realign(cur, w0);             // stage u's A tile
      w0 = w1;
      fence_async_smem();
      __syncthreads();
    }
    const uint32_t a = op.a(cur, wg), b = op.b(cur);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BKB / 32; ++j)
      wgmma_s8(acc, desc_k<64>(a, j), desc_k<BN>(b, j),
               cur.k != 0 || j != 0);
    wgmma_commit();
    // stage u + 2's words into w1 while the tensor cores work, with no
    // fence or barrier after them within the stage
    if constexpr (Op::REALIGN) {
      if (ld.u < units) {
        op.load(ld, w1);
        ld.next(KT, chunks);
      }
    }
    if (cur.k != KT - 1) {
      wgmma_wait<1>();                 // stage u - 1's products are done
      continue;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    op.epilogue(acc, cur);
  }
}

// ---------------------------------------------------------------------------
// scan_syndromes
// ---------------------------------------------------------------------------

// stages of a BN-wide tile: as many as ~220 KB of shared memory holds, up
// to 8
template <int BN>
struct ScanOp {
  static constexpr int YT = BM * BKB, HT = BN * BKB, STAGE = YT + HT;
  static constexpr int NS = (220 * 1024) / STAGE < 8
                                ? (220 * 1024) / STAGE : 8;
  static constexpr bool REALIGN = false;
  // alignment margin, the stages, an mbarrier a stage
  static constexpr size_t SMEM = 1024 + (size_t)NS * STAGE + 8 * NS;
  static_assert(NS >= 3, "the copies run NS - 2 stages ahead");

  struct Words {};
  uint32_t base, bars;
  const CUtensorMap *y, *h;
  uint8_t* flags;
  int M, p;
  uint32_t inv, lim;
  bool ones_only;

  __device__ uint32_t slot(const Stage& s) const {
    return base + (s.u % NS) * STAGE;
  }
  __device__ uint32_t a(const Stage& s, int wg) const {
    return slot(s) + wg * 64 * BKB;
  }
  __device__ uint32_t b(const Stage& s) const { return slot(s) + YT; }

  __device__ void issue(const Stage& s) const {
    if (threadIdx.x != 0) return;
    const uint32_t bar = bars + 8 * (s.u % NS);
    sm90::mbar_expect(bar, STAGE);
    sm90::tma_load(slot(s), y, bar, s.k * BKB, s.rt * BM);
    sm90::tma_load(slot(s) + YT, h, bar, s.k * BKB, s.ch * BN);
  }

  // x == 0 mod p. For odd p: x = p q with |q| <= lim = (2^31 - 1) / p
  // exactly when x * inv (inv = p^-1 mod 2^32) lies in [-lim, lim] as a
  // signed int.
  __device__ bool divisible(int x) const {
    return inv ? (uint32_t)x * inv + lim <= 2 * lim : x % p == 0;
  }

  // acc[4 j + e] is row r0 + 8 (e / 2), check 8 j + 2 (lane % 4) + e % 2;
  // check rows past C are zero-filled by the copy and add no flag
  __device__ void epilogue(const int (&acc)[BN / 2], const Stage& s) const {
    const int lane = threadIdx.x % 32, wg = threadIdx.x / WG;
    const int r0 = 64 * wg + 16 * (threadIdx.x % WG / 32) + lane / 4;
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bits |= (uint32_t)!divisible(acc[4 * j + e]) << (e / 2);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
    bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
    if (lane % 4 == 0) {
      const long row = (long)s.rt * BM + r0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool nz = (bits >> e) & 1;
        if (row + 8 * e < M && (nz || !ones_only)) flags[row + 8 * e] = nz;
      }
    }
  }
};

// y is the (M, K) and h the (C, K) int8 tensor map, boxes of 128 K bytes
// by 128 words and by BN checks, 128-byte swizzle.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
scan_syndromes_kernel(const __grid_constant__ CUtensorMap y,
                      const __grid_constant__ CUtensorMap h,
                      uint8_t* __restrict__ flags, int M, int KT, int chunks,
                      int tiles, int p, uint32_t inv, uint32_t lim,
                      bool ones_only) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (sm90::smem_u32(smem) + 1023) & ~1023u;
  ScanOp<BN> op{base, base + ScanOp<BN>::NS * ScanOp<BN>::STAGE, &y,
                &h, flags, M, p, inv, lim, ones_only};
  s8_stream<BN>(op, KT, chunks, tiles);
}

// ---------------------------------------------------------------------------
// gf_matmul
// ---------------------------------------------------------------------------

// Shared memory, from a 1024-byte-aligned base: NS B tiles (BN x 128
// bytes, swizzled), two swizzled 64 x 128-byte A tiles a warpgroup
// (adjacent, so that a warpgroup's 16 KB also stage its epilogue's
// stores), an mbarrier a stage; as many stages as 227 KB holds, up to 8.
//
// A: thread j writes 16-byte chunks 4 (j % 2) .. 4 (j % 2) + 3 of row j / 2
// of each stage's tile (so a warpgroup writes its own 64 rows). It loads
// the five aligned 16-byte words that cover them two stages ahead into
// registers, shifts each chunk out of two of them (byte_perm) and stores
// it swizzled. Words wholly past the row's K bytes, rows past M and words
// past A's last are zeros without a load; bytes past K within a word (the
// next row's) meet B's zero columns and add 0.
template <int BN>
struct GfOp {
  static constexpr int BT = BN * BKB, AT = 64 * BKB;
  static constexpr int FIXED = 1024 + 2 * WGS * AT;
  static constexpr int NS = (SMEM_MAX - FIXED) / (BT + 8) < 8
                                ? (SMEM_MAX - FIXED) / (BT + 8) : 8;
  static constexpr size_t SMEM = FIXED + (size_t)NS * (BT + 8);
  static constexpr bool REALIGN = true;
  static_assert(NS >= 3, "the copies run NS - 2 stages ahead");

  struct Words {
    uint4 w[5];
  };
  uint32_t base, bars;
  const CUtensorMap* bmap;
  const int8_t* A;
  uintptr_t aend;                // A's end rounded up to 16 bytes
  int32_t* out;
  int M, N, K;
  uint32_t p, bias, magic, shift;

  __device__ uint32_t btile(int slot) const { return base + slot * BT; }
  __device__ uint32_t atile(int wg, int buf) const {
    return base + NS * BT + (2 * wg + buf) * AT;
  }
  __device__ uint32_t a(const Stage& s, int wg) const {
    return atile(wg, s.u & 1);
  }
  __device__ uint32_t b(const Stage& s) const { return btile(s.u % NS); }
  // the address of this thread's first chunk at stage s
  __device__ uintptr_t first(const Stage& s) const {
    return (uintptr_t)A + (uintptr_t)((long)s.rt * BM + threadIdx.x / 2) * K +
           s.k * BKB + 64 * (threadIdx.x % 2);
  }

  // by thread 0: B's box
  __device__ void issue(const Stage& s) const {
    if (threadIdx.x != 0) return;
    const uint32_t bar = bars + 8 * (s.u % NS);
    sm90::mbar_expect(bar, BT);
    sm90::tma_load(btile(s.u % NS), bmap, bar, s.k * BKB, s.ch * BN);
  }

  __device__ void load(const Stage& s, Words& w) const {
    const uint4 zero = {0u, 0u, 0u, 0u};
    const uintptr_t g = first(s), al = g & ~(uintptr_t)15;
    // bytes of the row's stage from g on, and whether the row exists
    const int left = K - s.k * BKB - 64 * (int)(threadIdx.x % 2);
    const bool row = (long)s.rt * BM + threadIdx.x / 2 < M;
#pragma unroll
    for (int e = 0; e < 5; ++e) {
      const uintptr_t at = al + 16 * e;
      w.w[e] = row && 16 * e < (int)(g & 15) + left && at < aend
                   ? __ldg((const uint4*)at) : zero;
    }
  }

  // the 16 bytes from byte off (< 16) of the 32 bytes lo, hi
  __device__ static uint4 shift16(uint4 lo, uint4 hi, uint32_t off) {
    const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const uint32_t q = off >> 2, sel = 0x3210u + 0x1111u * (off & 3);
    uint32_t v[5];
#pragma unroll
    for (int e = 0; e < 5; ++e)
      v[e] = q & 2 ? (q & 1 ? w[e + 3] : w[e + 2])
                   : (q & 1 ? w[e + 1] : w[e]);
    return {__byte_perm(v[0], v[1], sel), __byte_perm(v[1], v[2], sel),
            __byte_perm(v[2], v[3], sel), __byte_perm(v[3], v[4], sel)};
  }

  __device__ void realign(const Stage& s, const Words& w) const {
    const int r = threadIdx.x / 2, c0 = 4 * (threadIdx.x % 2);
    const uint32_t off = (uint32_t)first(s) & 15;
    const uint32_t tile = atile(r / 64, s.u & 1);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sts128(tile + sm90::sw128<64>(r % 64, c0 + e),
             shift16(w.w[e], w.w[e + 1], off));
  }

  // x mod p in [0, p) for any int32 x: n = x + bias (a multiple of p, so
  // that n lies in [0, 2^32)), then n - p floor(n / p) with the quotient
  // by Granlund and Montgomery's multiply for a run-time divisor, exact
  // for every 32-bit n: t = hi32(magic n), q = (t + (n - t) / 2) >> shift
  __device__ uint32_t residue(int x) const {
    const uint32_t n = (uint32_t)x + bias, t = __umulhi(magic, n);
    return n - ((t + ((n - t) >> 1)) >> shift) * p;
  }

  __device__ void epilogue(int (&acc)[BN / 2], const Stage& s) const {
    const int lane = threadIdx.x % 32, wg = threadIdx.x / WG,
              wi = threadIdx.x % WG / 32;
    const long rw = (long)s.rt * BM + 64 * wg + 16 * wi;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = (int)residue(acc[i]);
    if (N > BN) {
      // acc[4 j + e] is row rw + lane / 4 + 8 (e / 2), column n0 + 8 j +
      // 2 (lane % 4) + e % 2
      const int n0 = s.ch * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long row = rw + lane / 4 + 8 * (e / 2);
          const int col = n0 + 8 * j + 2 * (lane % 4) + e % 2;
          if (row < M && col < N) out[row * N + col] = acc[4 * j + e];
        }
      return;
    }
    // every warp of this warpgroup is past its products, so the
    // warpgroup's A tiles are free: warp wi stages 4 of its 16 rows at a
    // time in 4 KB of them (4 N int32, N <= BN <= 256), then the warp
    // copies the 4 rows, one contiguous range, out in 16-byte words
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
    const uint32_t stage = atile(wg, 0) + wi * 4096;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      // rows 4 g .. 4 g + 3: lanes 16 (g % 2) .. + 15, their acc rows
      // e / 2 == g / 2
      if (lane / 16 == g % 2) {
        const int rr = lane / 4 % 4;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * (lane % 4) + e;
            if (col < N)
              sts32(stage + 4 * (rr * N + col),
                    (uint32_t)acc[4 * j + 2 * (g / 2) + e]);
          }
      }
      __syncwarp();
      const long first = rw + 4 * g;
      const long rows = M - first < 4 ? (M - first > 0 ? M - first : 0) : 4;
      const int words = (int)rows * N;
      int32_t* dst = out + first * N;
      for (int i = lane; i < words / 4; i += 32)
        *reinterpret_cast<uint4*>(dst + 4 * i) = lds128(stage + 16 * i);
      for (int i = words / 4 * 4 + lane; i < words; i += 32)
        dst[i] = (int32_t)lds32(stage + 4 * i);
      __syncwarp();
    }
  }
};

// b is the (N, K16) int8 tensor map of B, boxes of 128 K bytes by BN
// columns, 128-byte swizzle; a the (M, K) int8 words, any alignment.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
gf_matmul_kernel(const __grid_constant__ CUtensorMap b,
                 const int8_t* __restrict__ a, uintptr_t aend,
                 int32_t* __restrict__ out, int M, int N, int K, int KT,
                 int chunks, int tiles, uint32_t p, uint32_t bias,
                 uint32_t magic, uint32_t shift) {
  extern __shared__ uint8_t smem[];
  using Op = GfOp<BN>;
  const uint32_t base = (sm90::smem_u32(smem) + 1023) & ~1023u;
  Op op{base, base + Op::FIXED - 1024 + Op::NS * Op::BT, &b, a, aend, out,
        M, N, K, p, bias, magic, shift};
  s8_stream<BN>(op, KT, chunks, tiles);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// a 2D tensor map of a row-major (rows, K) int8 matrix, read in boxes of
// 128 K bytes by `box_rows` rows, 128-byte swizzle
bool s8_map(CUtensorMap* map, const void* base, int rows, int K,
            int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {BKB, (cuuint32_t)box_rows};
  return sm90::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims,
                          strides, box, true);
}

template <int BN>
int scan_launch(const void* y, const void* h, void* flags, int M, int C,
                int K, int p, int grid, cudaStream_t st) {
  using Op = ScanOp<BN>;
  const int chunks = (C + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * chunks;
  if (grid < 1 || grid > tiles) grid = tiles;
  CUtensorMap ty, th;
  if (!s8_map(&ty, y, M, K, BM) || !s8_map(&th, h, C, K, BN))
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      sm90::smem_attr_once<scan_syndromes_kernel<BN>>((int)Op::SMEM);
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
  scan_syndromes_kernel<BN><<<grid, THREADS, Op::SMEM, st>>>(
      ty, th, (uint8_t*)flags, M, (K + BKB - 1) / BKB, chunks, tiles, p, inv,
      lim, chunks > 1);
  return (int)cudaGetLastError();
}

template <int BN>
int gf_launch(const void* a, const void* b, void* out, int M, int N, int K,
              int K16, int p, int grid, cudaStream_t st) {
  using Op = GfOp<BN>;
  const int chunks = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * chunks;
  if (grid < 1 || grid > tiles) grid = tiles;
  CUtensorMap tb;
  if (!s8_map(&tb, b, N, K16, BN)) return (int)cudaErrorInvalidValue;
  cudaError_t e = sm90::smem_attr_once<gf_matmul_kernel<BN>>((int)Op::SMEM);
  if (e != cudaSuccess) return (int)e;
  // p ceil(2^31 / p): any int32 plus it lies in [0, 2^32) while |sum| <
  // 2^31 - 2^14 (K <= INT8_K_MAX) and p <= 2^14; and the divide's magic
  // 2^32 (2^l - p) / p + 1 and shift l - 1, l = ceil(log2 p)
  const uint32_t bias = (uint32_t)p * ((0x80000000u + p - 1) / (uint32_t)p);
  int l = 0;
  while ((1 << l) < p) ++l;
  const uint32_t magic =
      (uint32_t)((((uint64_t)1 << 32) * ((1u << l) - (uint32_t)p)) / p + 1);
  const uintptr_t aend =
      ((uintptr_t)a + (size_t)M * K + 15) & ~(uintptr_t)15;
  gf_matmul_kernel<BN><<<grid, THREADS, Op::SMEM, st>>>(
      tb, (const int8_t*)a, aend, (int32_t*)out, M, N, K,
      (K + BKB - 1) / BKB, chunks, tiles, (uint32_t)p, bias, magic,
      (uint32_t)(l - 1));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a (M, K) int8, row-major, any alignment; b (N, K16) int8 (B = the
// right operand's transpose, K zero-padded to K16, a multiple of 16),
// row-major, 16-byte aligned; out (M, N) int32, 16-byte aligned. bn is
// the column tile (32, 64, 128, 208 or 256), grid the number of
// persistent CTAs (at most the tiles); 2 <= p <= 2^14.
int rt_gf_matmul(const void* a, const void* b, void* out, int M, int N, int K,
                 int K16, int p, int bn, int grid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M == 0 || N == 0) return 0;
  if (K == 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(int32_t), st);
  if (p < 2 || p > (1 << 14) || K16 < K || K16 % 16 || (uintptr_t)b % 16 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  switch (bn) {
    case 32: return gf_launch<32>(a, b, out, M, N, K, K16, p, grid, st);
    case 64: return gf_launch<64>(a, b, out, M, N, K, K16, p, grid, st);
    case 128: return gf_launch<128>(a, b, out, M, N, K, K16, p, grid, st);
    case 208: return gf_launch<208>(a, b, out, M, N, K, K16, p, grid, st);
    case 256: return gf_launch<256>(a, b, out, M, N, K, K16, p, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
