// Bit-line PIM MAC with a per-row-group ADC clip, on the tile skeleton of
// tile.cuh.
//
// Replaces src/repro/kernels/pim_mac.py: pim_mac_pallas,
// Y = sum over groups g of clip(x_g . w_g, -half, half), where a group is
// R consecutive rows of K (the array's row parallelism) and half is
// adc_levels // 2. Each thread keeps a group's partial sums in registers and
// clips them into its int32 accumulator where the next group starts, so the
// partials never leave the SM. With adc_levels = 0 the groups are not
// tracked and the kernel is an exact integer product.
//
// Operands are int8 (activations and centered-lift cell values), K a
// multiple of R and R a multiple of 4 (the wrapper zero-pads each group to
// that), so no packed dp4a word straddles two groups.
//
// Bound on the card: bytes, narrowly. At the PIM shape (256 x 8192 x 2560)
// the MAC does about 420 integer operations per byte moved, below the ~590
// the int8 tensor cores need per byte of HBM. This kernel's dp4a on the CUDA
// cores sets its time instead; the s8 tensor cores would do the group
// products, with the clip in the epilogue of each R-deep K step.
#include "tile.cuh"

namespace {

template <bool CLIP>
__global__ void __launch_bounds__(rt::THREADS)
pim_mac_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
               int32_t* __restrict__ out, int M, int N, int K, int R,
               int half) {
  __shared__ rt::Tiles s;
  const long row0 = (long)blockIdx.x * rt::BM;
  const int col0 = blockIdx.y * rt::BN;
  int acc[rt::TM][rt::TN];
  rt::tile_product<CLIP>(s, acc, X, W, M, N, K, row0, col0, R, half);
#pragma unroll
  for (int i = 0; i < rt::TM; ++i) {
    const long r = row0 + threadIdx.y + rt::TY * i;
#pragma unroll
    for (int j = 0; j < rt::TN; ++j) {
      const int c = col0 + threadIdx.x + rt::TX * j;
      if (r < M && c < N) out[r * N + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

int rt_pim_mac(const void* x, const void* w, void* out, int M, int N, int K,
               int R, int adc_levels, void* stream) {
  if (M == 0 || N == 0) return 0;
  const bool clip = adc_levels > 0;
  const int half = adc_levels / 2;
  if (clip && (R <= 0 || R % 4 != 0 || K % R != 0))
    return (int)cudaErrorInvalidValue;
  dim3 grid((M + rt::BM - 1) / rt::BM, (N + rt::BN - 1) / rt::BN);
  dim3 block(rt::TX, rt::TY);
  if (clip)
    pim_mac_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x, (const int8_t*)w, (int32_t*)out, M, N, K, R, half);
  else
    pim_mac_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x, (const int8_t*)w, (int32_t*)out, M, N, K, R, half);
  return (int)cudaGetLastError();
}

}  // extern "C"
