// GF(p) matrix product and the fused syndrome scan, on one tile skeleton
// (tile.cuh).
//
// Replaces src/repro/kernels/gf_matmul.py: gf_matmul_pallas (encode,
// (a @ b) mod p) and scan_syndromes_pallas (flags[i] = any((y[i] @ Ht) mod
// p != 0)). Inputs are int8 (stored cell levels are int8 in [0, p)), the
// accumulator int32. Each block owns 64 rows; the scan walks every 64-wide
// slice of the check columns for its rows and folds the nonzero test into a
// per-row flag in shared memory, so only the (M,) flags reach device memory,
// never the syndrome matrix.
//
// Bound on the card: bytes. The scan does 2*M*K*N integer operations on
// M*K bytes, about 400 per byte at its shape (4096 x 1024 x 205), below the
// ~590 the int8 tensor cores need per byte of HBM, so its least time is the
// time to read the words. This kernel uses dp4a (four int8 multiply-adds
// per instruction) on the CUDA cores instead, so its multiply-adds, not
// memory, set its time; the s8 tensor-core path (wgmma) is what would
// bring it to the bytes bound.
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

__global__ void __launch_bounds__(rt::THREADS)
scan_syndromes_kernel(const int8_t* __restrict__ Y,
                      const int8_t* __restrict__ Ht, bool* __restrict__ flags,
                      int M, int C, int K, int p) {
  __shared__ rt::Tiles s;
  __shared__ int flag[rt::BM];
  const int tid = threadIdx.y * rt::TX + threadIdx.x;
  if (tid < rt::BM) flag[tid] = 0;
  const long row0 = (long)blockIdx.x * rt::BM;
  int acc[rt::TM][rt::TN];
  for (int col0 = 0; col0 < C; col0 += rt::BN) {
    rt::tile_product(s, acc, Y, Ht, M, C, K, row0, col0);
#pragma unroll
    for (int i = 0; i < rt::TM; ++i) {
      const int lr = threadIdx.y + rt::TY * i;
      bool nz = false;
#pragma unroll
      for (int j = 0; j < rt::TN; ++j) {
        const int c = col0 + threadIdx.x + rt::TX * j;
        nz |= c < C && rt::mod_floor(acc[i][j], p) != 0;
      }
      if (nz) flag[lr] = 1;        // every writer stores the same 1
    }
  }
  __syncthreads();
  if (tid < rt::BM && row0 + tid < M) flags[row0 + tid] = flag[tid] != 0;
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

int rt_scan_syndromes(const void* y, const void* ht, void* flags, int M, int C,
                      int K, int p, void* stream) {
  if (M == 0) return 0;
  dim3 grid((M + rt::BM - 1) / rt::BM);
  scan_syndromes_kernel<<<grid, dim3(rt::TX, rt::TY), 0,
                          (cudaStream_t)stream>>>(
      (const int8_t*)y, (const int8_t*)ht, (bool*)flags, M, C, K, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
