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
// One CTA per (batch row b, KV head h) walks the NP pages and then the hot
// page, as the TPU kernel's sequential grid does. Per page it dequantizes
// its (b, h) slice of K and V into shared memory: element
// e = ((b_sub * T + t) * Hkv + h) * D + d of the sub-page has its Dg base-p
// digits at info positions e*Dg .. e*Dg+Dg-1, i.e. word pos / k_info,
// column pos % k_info; digits are clipped into [0, p-1], the byte is taken
// mod 256, recentred by 128 and scaled. Then the G * Sq query rows of the
// head group take one online-softmax step (logits in fp32, masked to -1e30
// past the row's valid count, m starting at -inf, the same constants and
// order as the reference so that empty rows and hot-only calls agree), and
// acc += w . V. m, l and acc stay in shared memory across pages. Sums and
// the softmax are fp32. The dequantized K/V values and each q.k dot product
// are rounded to bf16 where the JAX package's oracle rounds them (its pages
// are dequantized to bf16 and its QK^T product on bf16 operands is bf16),
// so the kernel agrees with the plain version up to the order of the fp32
// sums; the TPU kernel skips those roundings, which at D = 64 moves a logit
// of magnitude 4 by up to half a bf16 ulp (0.016) and the output by a few
// hundredths.
//
// Bound on the card: bytes. A call reads Dg bytes of info digits per K and
// V element (6 for p = 3) and does 4 flops per element and query row, far
// below the ridge. This first kernel runs B * Hkv CTAs (32 at the serving
// shape, a quarter of the SMs) and loads digit by digit; splitting pages
// across CTAs (flash-decoding) and 16-byte loads of the info columns are
// the next steps.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr int THREADS = 128;

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
  int Sq, Hq, Hkv, D, T, Bsub, S, NP, W, n, k_info, p, Dg, with_hot;
  float softcap;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the (b, h) slice of one GF sub-page -> T x D values in shared memory
__device__ __forceinline__ void dequant_slice(const int8_t* __restrict__ page,
                                              float scale, float* dst,
                                              const Args& a, int bl, int h) {
  const int TD = a.T * a.D;
  for (int idx = threadIdx.x; idx < TD; idx += blockDim.x) {
    const int t = idx / a.D, d = idx - t * a.D;
    // 32-bit offsets within a page (the wrapper checks W * n < 2^31)
    const int e = ((bl * a.T + t) * a.Hkv + h) * a.D + d;
    int pos = e * a.Dg;
    int val = 0, pw = 1;
    for (int i = 0; i < a.Dg; ++i, ++pos) {
      const int w = pos / a.k_info;
      int dig = page[w * a.n + (pos - w * a.k_info)];
      dig = dig < 0 ? 0 : (dig > a.p - 1 ? a.p - 1 : dig);
      val += dig * pw;
      pw *= a.p;
    }
    dst[idx] = round_bf16((float)((val & 255) - 128) * scale);
  }
}

__device__ __forceinline__ void load_hot(const __nv_bfloat16* __restrict__ hot,
                                         float* dst, const Args& a, int b,
                                         int h) {
  const int TD = a.T * a.D;
  for (int idx = threadIdx.x; idx < TD; idx += blockDim.x) {
    const int t = idx / a.D, d = idx - t * a.D;
    dst[idx] = __bfloat162float(
        hot[((long)(b * a.T + t) * a.Hkv + h) * a.D + d]);
  }
}

__global__ void __launch_bounds__(THREADS)
attend_protected_kernel(Args a) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, h = blockIdx.y, B = gridDim.x;
  const int G = a.Hq / a.Hkv, R = G * a.Sq, T = a.T, D = a.D;
  const int s = b / a.Bsub, bl = b - s * a.Bsub;
  float* Ks = sm;                 // T x D
  float* Vs = Ks + T * D;         // T x D
  float* Qs = Vs + T * D;         // R x D, row r = g * Sq + sq
  float* acc = Qs + R * D;        // R x D
  float* L = acc + R * D;         // R x T logits, then weights
  float* m = L + R * T;           // R
  float* l = m + R;               // R
  float* corr = l + R;            // R

  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    const int g = r / a.Sq, sq = r - g * a.Sq;
    Qs[idx] = __bfloat162float(
        a.q[((long)(b * a.Sq + sq) * a.Hq + h * G + g) * D + d]);
    acc[idx] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  const float sqrt_d = sqrtf((float)D);
  const long page_cells = (long)a.W * a.n;
  const int steps = a.NP + (a.with_hot ? 1 : 0);

  for (int j = 0; j < steps; ++j) {
    int nvalid;
    if (j < a.NP) {
      const long sub = (long)j * a.S + s;
      dequant_slice(a.kp + sub * page_cells, a.ks[sub], Ks, a, bl, h);
      dequant_slice(a.vp + sub * page_cells, a.vs[sub], Vs, a, bl, h);
      nvalid = a.valid[(long)j * B + b];
    } else {
      load_hot(a.hk, Ks, a, b, h);
      load_hot(a.hv, Vs, a, b, h);
      nvalid = a.hvalid[b];
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < R * T; idx += blockDim.x) {
      const int r = idx / T, t = idx - r * T;
      const float* qr = Qs + r * D;
      const float* kt = Ks + t * D;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kt[d], dot);
      float x = round_bf16(dot) / sqrt_d;
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      L[idx] = t < nvalid ? x : NEG_BIG;
    }
    __syncthreads();

    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      float* Lr = L + r * T;
      float pm = Lr[0];
      for (int t = 1; t < T; ++t) pm = fmaxf(pm, Lr[t]);
      const float mo = m[r], mn = fmaxf(mo, pm);
      float sum = 0.f;
      for (int t = 0; t < T; ++t) {
        const float w = expf(Lr[t] - mn);
        Lr[t] = w;
        sum += w;
      }
      const float c = expf(mo - mn);
      corr[r] = c;
      l[r] = c * l[r] + sum;
      m[r] = mn;
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
      const int r = idx / D, d = idx - r * D;
      const float* wr = L + r * T;
      float pv = 0.f;
      for (int t = 0; t < T; ++t) pv = fmaf(wr[t], Vs[t * D + d], pv);
      acc[idx] = corr[r] * acc[idx] + pv;
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    const int g = r / a.Sq, sq = r - g * a.Sq;
    a.out[((long)(b * a.Sq + sq) * a.Hq + h * G + g) * D + d] =
        __float2bfloat16(acc[idx] / fmaxf(l[r], 1e-30f));
  }
}

}  // namespace

extern "C" {

int rt_attend_protected(const void* q, const void* kp, const void* vp,
                        const void* ks, const void* vs, const void* valid,
                        const void* hk, const void* hv, const void* hvalid,
                        void* out, int B, int Sq, int Hq, int Hkv, int D,
                        int T, int Bsub, int S, int NP, int W, int n,
                        int k_info, int p, int with_hot, float softcap,
                        void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  if (Hkv < 1 || Hq % Hkv || T < 1 || D < 1 || k_info < 1 || p < 2 ||
      (NP == 0 && !with_hot))
    return (int)cudaErrorInvalidValue;
  int Dg = 0;
  for (long v = 1; v < 256; v *= p) ++Dg;       // ceil(log_p 256)
  Args a{(const __nv_bfloat16*)q, (const int8_t*)kp, (const int8_t*)vp,
         (const float*)ks, (const float*)vs, (const int*)valid,
         (const __nv_bfloat16*)hk, (const __nv_bfloat16*)hv,
         (const int*)hvalid, (__nv_bfloat16*)out,
         Sq, Hq, Hkv, D, T, Bsub, S, NP, W, n, k_info, p, Dg, with_hot,
         softcap};
  const int R = (Hq / Hkv) * Sq;
  const size_t smem = sizeof(float) *
      ((size_t)2 * T * D + (size_t)2 * R * D + (size_t)R * T + 3 * R);
  // K and V tiles, query rows, acc, logits and three per-row carries; a
  // query block past the SM's 227 KB is refused here
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attend_protected_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  attend_protected_kernel<<<dim3(B, Hkv), THREADS, smem,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
