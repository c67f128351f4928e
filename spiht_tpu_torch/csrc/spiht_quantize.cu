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
// operations-per-byte balance. The design moves whole 16-byte vectors: a
// thread takes 8 consecutive elements (quantize_vec8), two 16-byte loads of
// x through the read-only path, two 16-byte stores of q, one 16-byte store
// of the eight int16 and one 8-byte store of the eight int8, so every warp
// access covers whole 128-byte lines with a quarter to an eighth of the
// scalar loop's memory instructions. The outputs are fresh allocations,
// aligned at element 0; x may be an offset view. Where x is not 16-byte
// aligned, a scalar head that aligned x would leave all three outputs
// misaligned by the same elements, and they carry 7 of the 11 bytes, so
// the vectors keep aligned stores and load x as eight 4-byte loads instead
// (chip_smoke.py times such a view, PERF.md). The n % 8 elements past the
// last whole vector run quantize_at, the element body, in the thread after
// the last vector. The grid is one vector a thread: on the card it beat
// one wave of blocks striding over the vectors (PERF.md). Each warp ORs
// its overflow with one __any_sync, and a block that saw one makes the
// single atomicOr. The Pallas kernel's 256-row blocks and its
// grid-ordered scratch flag have no counterpart: blocks run in any order
// here.

#include "spiht_common.cuh"

#ifdef __CUDACC__
#define F32_MUL(a, b) __fmul_rn((a), (b))  // no contraction into an FMA
#define F32_TO_I32_RZ(x) __float2int_rz(x)
#define CLZ(x) __clz(x)
#define LDG_F32(p) __ldg(p)
#else
#include <string.h>
#define F32_MUL(a, b) ((a) * (b))
#define F32_TO_I32_RZ(x) ((int32_t)(x))
#define CLZ(x) __builtin_clz(x)
#define LDG_F32(p) (*(p))
#endif

// One element's four outputs from its input; returns its overflow bit.
SPIHT_HD bool quantize_one(float v, float scale, int32_t& q, int16_t& c,
                           int8_t& l) {
  q = F32_TO_I32_RZ(F32_MUL(v, scale));
  const int32_t a = (int32_t)(q < 0 ? 0u - (uint32_t)q : (uint32_t)q);
  c = (int16_t)(q < -32767 ? -32767 : q > 32767 ? 32767 : q);
  l = (int8_t)(a > 0 ? 31 - CLZ((uint32_t)a) : -1);
  return a > 32767;
}

// Element i's four outputs (the element body); returns its overflow bit.
SPIHT_HD bool quantize_at(const float* x, float scale, int64_t i,
                          int32_t* arr, int16_t* a16, int8_t* m) {
  int32_t q;
  int16_t c;
  int8_t l;
  const bool over = quantize_one(x[i], scale, q, c, l);
  arr[i] = q;
  a16[i] = c;
  m[i] = l;
  return over;
}

#define QV 8  // elements a vector

// Elements [i, i + 8) (i a multiple of 8): X16 says x + i is 16-byte
// aligned, so x comes as two 16-byte loads, else as eight 4-byte ones;
// arr + i, a16 + i (16 bytes) and m + i (8 bytes) are aligned stores.
// Returns the vector's overflow bit.
template <bool X16>
SPIHT_HD bool quantize_vec8(const float* x, float scale, int64_t i,
                            int32_t* arr, int16_t* a16, int8_t* m) {
  float v[QV];
#ifdef __CUDACC__
  if (X16) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(x + i));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(x + i) + 1);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int k = 0; k < QV; ++k) v[k] = LDG_F32(x + i + k);
  }
#else
  for (int k = 0; k < QV; ++k) v[k] = LDG_F32(x + i + k);
#endif
  int32_t q[QV];
  uint32_t c[QV / 2] = {0, 0, 0, 0}, l[QV / 4] = {0, 0};
  bool over = false;
#pragma unroll
  for (int k = 0; k < QV; ++k) {
    int16_t ck;
    int8_t lk;
    over |= quantize_one(v[k], scale, q[k], ck, lk);
    c[k / 2] |= (uint32_t)(uint16_t)ck << (16 * (k % 2));
    l[k / 4] |= (uint32_t)(uint8_t)lk << (8 * (k % 4));
  }
#ifdef __CUDACC__
  int4* qa = reinterpret_cast<int4*>(arr + i);
  qa[0] = make_int4(q[0], q[1], q[2], q[3]);
  qa[1] = make_int4(q[4], q[5], q[6], q[7]);
  *reinterpret_cast<uint4*>(a16 + i) = make_uint4(c[0], c[1], c[2], c[3]);
  *reinterpret_cast<uint2*>(m + i) = make_uint2(l[0], l[1]);
#else
  memcpy(arr + i, q, sizeof(q));
  memcpy(a16 + i, c, sizeof(c));
  memcpy(m + i, l, sizeof(l));
#endif
  return over;
}

// The vector indices of n elements: the whole vectors, and one more for
// the n % 8 elements past the last whole one.
SPIHT_HD int64_t quantize_items(int64_t n) { return (n + QV - 1) / QV; }

// The work of vector index v < quantize_items(n): a whole vector, or the
// elements past the last one, one by one. Returns its overflow bit.
template <bool X16>
SPIHT_HD bool quantize_item(const float* x, int64_t n, float scale, int64_t v,
                            int32_t* arr, int16_t* a16, int8_t* m) {
  if ((v + 1) * QV <= n)
    return quantize_vec8<X16>(x, scale, v * QV, arr, a16, m);
  bool over = false;
  for (int64_t i = v * QV; i < n; ++i)
    over |= quantize_at(x, scale, i, arr, a16, m);
  return over;
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

template <bool X16>
__global__ void __launch_bounds__(SPIHT_THREADS)
spiht_quantize_compact_kernel(const float* __restrict__ x, int64_t n,
                              float scale, int32_t* __restrict__ arr,
                              int16_t* __restrict__ a16,
                              int8_t* __restrict__ m, int32_t* ofl) {
  __shared__ int32_t block_over;
  if (threadIdx.x == 0) block_over = 0;
  __syncthreads();
  // The grid gives each thread one vector, so the loop runs once; in this
  // form the kernel took 16% less time on the card than as one guarded
  // call (PERF.md).
  bool over = false;
  const int64_t items = quantize_items(n);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < items;
       v += stride)
    over |= quantize_item<X16>(x, n, scale, v, arr, a16, m);
  if (__any_sync(0xFFFFFFFFu, over) && (threadIdx.x & 31) == 0)
    block_over = 1;
  __syncthreads();
  if (threadIdx.x == 0 && block_over) atomicOr(ofl, 1);
}

// x: n float32 (any 4-byte alignment); arr, a16, m: n each, fresh
// allocations (16-byte aligned); ofl: one int32, zeroed by the caller.
extern "C" int spiht_quantize_compact_launch(
    const float* x, int64_t n, float scale, int32_t* arr, int16_t* a16,
    int8_t* m, int32_t* ofl, void* stream) {
  if (n <= 0) return 0;
  if ((((uintptr_t)arr | (uintptr_t)a16) & 15) || ((uintptr_t)m & 7))
    return (int)cudaErrorMisalignedAddress;
  const int64_t items = (n + QV - 1) / QV;  // quantize_items, on the host
  const int64_t blocks = (items + SPIHT_THREADS - 1) / SPIHT_THREADS;
  if ((uintptr_t)x & 15)
    spiht_quantize_compact_kernel<false><<<(unsigned)blocks, SPIHT_THREADS, 0,
                                           (cudaStream_t)stream>>>(
        x, n, scale, arr, a16, m, ofl);
  else
    spiht_quantize_compact_kernel<true><<<(unsigned)blocks, SPIHT_THREADS, 0,
                                          (cudaStream_t)stream>>>(
        x, n, scale, arr, a16, m, ofl);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
