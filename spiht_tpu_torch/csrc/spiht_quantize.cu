// Fused quantize / int16 compaction / element level map (kernel B6).
//
// Replaces spiht_tpu/ops/pallas_kernels.py:_kernel (run by _run and
// quantize_compact_m), which jax_transform._forward_compact_jit uses when
// the working dtype is float32. One pass over n float32 coefficients x
// (already multiplied by the per-channel scales) and the scalar scale:
//
//   q   = trunc(x * scale)                  int32   (round toward zero)
//   a16 = clip(q, -32767, 32767)            int16
//   m   = floor(log2 |q|), -1 for q == 0    int8    (31 - clz |q|: the same
//         integer as the Pallas kernel's sum of 31 thresholds |q| >= 2^k)
//   ofl = any |q| > 32767                   int32, OR-ed into *ofl
//
// |q| is taken in int32 arithmetic as the Pallas kernel takes it, so
// q = INT32_MIN (|q| wraps to itself) gives m = -1 and no overflow there.
//
// What bounds it on an H100: bytes. Each element reads 4 and writes
// 4 + 2 + 1 bytes, with a few integer operations, far below the card's
// operations-per-byte balance. The design is one grid-stride pass: every
// thread walks the array at the grid's stride (neighbouring threads on
// neighbouring elements, so loads and stores coalesce), the block ORs its
// overflow with one __syncthreads_or, and one thread per block does the
// single atomicOr. The Pallas kernel's 256-row blocks and its grid-ordered
// scratch flag have no counterpart: blocks run in any order here.

#include "spiht_common.cuh"

#ifdef __CUDACC__
#define F32_MUL(a, b) __fmul_rn((a), (b))  // no contraction into an FMA
#define F32_TO_I32_RZ(x) __float2int_rz(x)
#define CLZ(x) __clz(x)
#else
#define F32_MUL(a, b) ((a) * (b))
#define F32_TO_I32_RZ(x) ((int32_t)(x))
#define CLZ(x) __builtin_clz(x)
#endif

// Element i's four outputs; returns its overflow bit.
SPIHT_HD bool quantize_at(const float* x, float scale, int64_t i,
                          int32_t* arr, int16_t* a16, int8_t* m) {
  const int32_t q = F32_TO_I32_RZ(F32_MUL(x[i], scale));
  arr[i] = q;
  const int32_t a = (int32_t)(q < 0 ? 0u - (uint32_t)q : (uint32_t)q);
  a16[i] = (int16_t)(q < -32767 ? -32767 : q > 32767 ? 32767 : q);
  m[i] = (int8_t)(a > 0 ? 31 - CLZ((uint32_t)a) : -1);
  return a > 32767;
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

__global__ void __launch_bounds__(SPIHT_THREADS)
spiht_quantize_compact_kernel(const float* __restrict__ x, int64_t n,
                              float scale, int32_t* __restrict__ arr,
                              int16_t* __restrict__ a16,
                              int8_t* __restrict__ m, int32_t* ofl) {
  bool over = false;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    over |= quantize_at(x, scale, i, arr, a16, m);
  if (__syncthreads_or(over) && threadIdx.x == 0) atomicOr(ofl, 1);
}

// x: n float32; arr, a16, m: n each; ofl: one int32, zeroed by the caller.
extern "C" int spiht_quantize_compact_launch(
    const float* x, int64_t n, float scale, int32_t* arr, int16_t* a16,
    int8_t* m, int32_t* ofl, void* stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n + SPIHT_THREADS - 1) / SPIHT_THREADS;
  const int64_t most = (int64_t)sms * (2048 / SPIHT_THREADS);  // one wave
  const int blocks = (int)(want < most ? want : most);
  spiht_quantize_compact_kernel<<<blocks, SPIHT_THREADS, 0,
                                  (cudaStream_t)stream>>>(
      x, n, scale, arr, a16, m, ofl);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
