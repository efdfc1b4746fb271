// Shared tile skeleton of the integer GEMM kernels (gf_matmul and
// scan_syndromes): C(M,N) = A(M,K) . B(K,N) with A and B int8, row-major,
// and an int32 accumulator.
//
// A block of TY x TX = 16 x 16 threads owns a BM x BN = 64 x 64 output tile;
// each thread keeps a 4 x 4 register tile, on rows ty + 16 i and columns
// tx + 16 j. K advances in steps of 4 * BKW bytes: each step packs four
// consecutive K values of an A row, and of a B column, into one 32-bit word
// in shared memory, so one __dp4a does four multiply-adds. Rows, columns and
// K past the edge load as 0, which adds nothing to a sum.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr int TX = 16, TY = 16;
constexpr int THREADS = TX * TY;
constexpr int BM = 64, BN = 64;
constexpr int TM = BM / TY, TN = BN / TX;
constexpr int BKW = 16;            // packed words per K step
constexpr int BK = 4 * BKW;        // K values per step

struct Tiles {
  int a[BKW][BM];                  // a[w][r] = A[row0 + r][k0 + 4w .. + 3]
  int b[BKW][BN];                  // b[w][c] = B[k0 + 4w .. + 3][col0 + c]
};

__device__ __forceinline__ int pack4(int8_t x0, int8_t x1, int8_t x2,
                                     int8_t x3) {
  return (int)(uint8_t)x0 | ((int)(uint8_t)x1 << 8) |
         ((int)(uint8_t)x2 << 16) | ((int)(uint8_t)x3 << 24);
}

// Fill the shared tiles for the K step starting at k0. Consecutive threads
// read consecutive bytes of an A row, and consecutive columns of B rows.
__device__ __forceinline__ void load_step(Tiles& s,
                                          const int8_t* __restrict__ A,
                                          const int8_t* __restrict__ B,
                                          int M, int N, int K, long row0,
                                          int col0, int k0) {
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int w = tid; w < BM * BKW; w += THREADS) {
    const int r = w / BKW, kw = w % BKW;
    const long gr = row0 + r;
    const int gk = k0 + 4 * kw;
    int8_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = (gr < M && gk + i < K) ? A[gr * K + gk + i] : (int8_t)0;
    s.a[kw][r] = pack4(v[0], v[1], v[2], v[3]);
  }
  for (int w = tid; w < BN * BKW; w += THREADS) {
    const int c = w % BN, kw = w / BN;
    const int gc = col0 + c;
    const int gk = k0 + 4 * kw;
    int8_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = (gc < N && gk + i < K) ? B[(long)(gk + i) * N + gc] : (int8_t)0;
    s.b[kw][c] = pack4(v[0], v[1], v[2], v[3]);
  }
}

// acc[i][j] = sum over K of A[row][k] * B[k][col] for this thread's 4 x 4
// outputs of the tile at (row0, col0).
__device__ __forceinline__ void tile_product(Tiles& s, int acc[TM][TN],
                                             const int8_t* __restrict__ A,
                                             const int8_t* __restrict__ B,
                                             int M, int N, int K, long row0,
                                             int col0) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  const int ty = threadIdx.y, tx = threadIdx.x;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();               // the previous step's reads are done
    load_step(s, A, B, M, N, K, row0, col0, k0);
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < BKW; ++kw) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = s.a[kw][ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = s.b[kw][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
  }
}

// x mod p in [0, p) for any sign of x: C++ `%` truncates toward zero, the
// reference's `%` floors.
__device__ __forceinline__ int mod_floor(int x, int p) {
  return ((x % p) + p) % p;
}

}  // namespace rt
