// Dependent-chain microbenchmarks: the port of the two TPU spikes that
// measure one chain of dependent accesses, each chain one thread.
//
//   spike_seq      replaces tools/spike_pallas_seq.py:make_onehot_kernel's
//                  kernel (:66, pallas_call :105): K steps of _chain_step,
//                  each reading the word at a data-dependent cursor, doing
//                  scalar ALU work and (rw) writing the cursor to a scratch
//                  array at a data-dependent index. The TPU kernel reads a
//                  (1, 128) row and extracts the lane with a one-hot sum,
//                  and writes by a masked row read-modify-write; here one
//                  thread indexes the word directly. The array lies in
//                  global memory, or (shared = 1) in shared memory at 2^15
//                  words, with the rw scratch there as 16-bit words (the
//                  cursor is below 2^15) and copied out at the end.
//   spike_table    replaces tools/spike_hbm_table.py:_vmem_kernel (:53),
//                  _hbm_kernel (:63) and _hbm_ilv_kernel (:84) (pallas_call
//                  :210 in build): x <- T[x] over a permutation, K steps, in
//                  B chains (B = 1: one chain), the B loads of a step issued
//                  back to back so they are in flight together. The TPU
//                  kernels DMA a row from HBM per access (or slice VMEM);
//                  here the table lies in global memory (L2 or HBM by its
//                  size) or, for one chain, in shared memory at 2^15 words.
//   spike_fire     replaces tools/spike_hbm_table.py:_hbm_fire_kernel
//                  (:128): the fire body, four loads {x, x+1, x+W, x+W+1}
//                  (clamped to the table) a chain a step, 4B in flight; the
//                  chain goes on through T[x], the other three fold into a
//                  checksum so no load is dead.
//
// What bounds them on an H100: by design, the latency of each dependent
// access (shared memory, L1, L2 or HBM by where the array lies), not bytes
// or operations; a chain's step cannot start before its load returns. The
// design keeps that one load on the chain's path and nothing else: direct
// indexing, no extraction, the B chains' loads independent of each other.
// The outputs are those of the TPU kernels: (1, 2) int32 (pos, acc) for
// spike_seq, (1, 128) int32 for the table spikes (lane b chain b's head,
// the other lanes x for one chain, 0 for B chains, the checksum for fire).
//
// The chains are plain functions (SPIKE_HD) that the kernels call and that
// also compile as host C++ (tests/test_torch_spikes.py holds them to the
// numpy loops).

#include <stdint.h>

#ifdef __CUDACC__
#define SPIKE_HD __device__ __forceinline__
#else
#define SPIKE_HD inline
#endif

#define SPIKE_LANES 128
#define SPIKE_SMEM_WORDS (1 << 15)

// K steps of spike_pallas_seq's _chain_step (int32 wrap-around) over
// `words` (size words, a power of two) from pos = acc = 0: the fetched word
// moves the cursor a data-dependent distance and folds into acc; rw writes
// the cursor to scratch at a data-dependent index. out = (pos, acc).
template <bool RW, class S>
SPIKE_HD void seq_chain(const int32_t* __restrict__ words, int32_t size,
                        int32_t k, S* __restrict__ scratch, int32_t* out) {
  int32_t pos = 0, acc = 0;
  for (int32_t t = 0; t < k; ++t) {
    const int32_t word = words[pos];
    const int32_t step = (word >> (pos & 7)) & 7;
    acc ^= (int32_t)((uint32_t)word + (uint32_t)pos);
    pos = (pos + 1 + step) & (size - 1);
    if (RW) scratch[acc & (size - 1)] = (S)pos;
  }
  out[0] = pos;
  out[1] = acc;
}

// B chains x_b <- T[x_b] from x_b = b, K steps, the B loads of a step
// independent. out (128 lanes): lane b chain b, the rest x_0 (B = 1) or 0.
template <int B>
SPIKE_HD void table_chain(const int32_t* table, int32_t k, int32_t* out) {
  int32_t x[B];
#pragma unroll
  for (int b = 0; b < B; ++b) x[b] = b;
  for (int32_t t = 0; t < k; ++t) {
#pragma unroll
    for (int b = 0; b < B; ++b) x[b] = table[x[b]];
  }
  // static indices only: x stays in registers
#pragma unroll
  for (int b = 0; b < B; ++b) out[b] = x[b];
  for (int i = B; i < SPIKE_LANES; ++i) out[i] = B == 1 ? x[0] : 0;
}

// The index x + off clamped to a table of n words.
SPIKE_HD int32_t clamp_index(int32_t x, int32_t off, int32_t n) {
  const int64_t i = (int64_t)x + off;
  return (int32_t)(i < 0 ? 0 : i > n - 1 ? n - 1 : i);
}

// The fire body: B chains, each step four loads a chain {x, x+1, x+W,
// x+W+1} (clamped), all 4B issued before any is used; x goes on through
// T[x], the other three fold into one int32 checksum. out (128 lanes):
// lane b chain b, the rest the checksum.
template <int B>
SPIKE_HD void fire_chain(const int32_t* table, int32_t n, int32_t k,
                         int32_t w_off, int32_t* out) {
  int32_t x[B];
  uint32_t acc = 0;
#pragma unroll
  for (int b = 0; b < B; ++b) x[b] = b;
  for (int32_t t = 0; t < k; ++t) {
    int32_t v[B][4];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      v[b][0] = table[x[b]];
      v[b][1] = table[clamp_index(x[b], 1, n)];
      v[b][2] = table[clamp_index(x[b], w_off, n)];
      v[b][3] = table[clamp_index(x[b], w_off + 1, n)];
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      x[b] = v[b][0];
      acc += (uint32_t)v[b][1] + (uint32_t)v[b][2] + (uint32_t)v[b][3];
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) out[b] = x[b];
  for (int i = B; i < SPIKE_LANES; ++i) out[i] = (int32_t)acc;
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

// spike_seq over an array in global memory; the rw scratch is zeroed by
// the caller.
template <bool RW>
__global__ void spike_seq_kernel(const int32_t* __restrict__ words,
                                 int32_t size, int32_t k,
                                 int32_t* __restrict__ scratch,
                                 int32_t* __restrict__ out) {
  seq_chain<RW>(words, size, k, scratch, out);
}

// spike_seq over 2^15 words in shared memory (the block stages them, one
// thread runs the chain); the rw scratch is shared too, 16-bit words,
// copied out after.
template <bool RW>
__global__ void spike_seq_smem_kernel(const int32_t* __restrict__ words,
                                      int32_t k,
                                      int32_t* __restrict__ scratch,
                                      int32_t* __restrict__ out) {
  extern __shared__ int32_t sm[];
  uint16_t* sc = (uint16_t*)(sm + SPIKE_SMEM_WORDS);
  for (int32_t i = threadIdx.x; i < SPIKE_SMEM_WORDS; i += blockDim.x) {
    sm[i] = words[i];
    if (RW) sc[i] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) seq_chain<RW>(sm, SPIKE_SMEM_WORDS, k, sc, out);
  if (!RW) return;
  __syncthreads();
  for (int32_t i = threadIdx.x; i < SPIKE_SMEM_WORDS; i += blockDim.x)
    scratch[i] = sc[i];
}

template <int B>
__global__ void spike_table_kernel(const int32_t* __restrict__ table,
                                   int32_t k, int32_t* __restrict__ out) {
  table_chain<B>(table, k, out);
}

// One chain over 2^15 words in shared memory.
__global__ void spike_table_smem_kernel(const int32_t* __restrict__ table,
                                        int32_t k, int32_t* __restrict__ out) {
  extern __shared__ int32_t sm[];
  for (int32_t i = threadIdx.x; i < SPIKE_SMEM_WORDS; i += blockDim.x)
    sm[i] = table[i];
  __syncthreads();
  if (threadIdx.x == 0) table_chain<1>(sm, k, out);
}

template <int B>
__global__ void spike_fire_kernel(const int32_t* __restrict__ table,
                                  int32_t n, int32_t k, int32_t w_off,
                                  int32_t* __restrict__ out) {
  fire_chain<B>(table, n, k, w_off, out);
}

// spike_seq: size words (a power of two; shared: 2^15), rw writes the
// scratch (size words, zeroed by the caller).
extern "C" int spike_seq_launch(const int32_t* words, int32_t size,
                                int32_t k, int32_t rw, int32_t shared,
                                int32_t* scratch, int32_t* out,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (shared) {
    if (size != SPIKE_SMEM_WORDS) return (int)cudaErrorInvalidValue;
    const int bytes = SPIKE_SMEM_WORDS * (4 + (rw ? 2 : 0));
    if (rw) {
      cudaFuncSetAttribute(spike_seq_smem_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      spike_seq_smem_kernel<true><<<1, 256, bytes, s>>>(words, k, scratch, out);
    } else {
      cudaFuncSetAttribute(spike_seq_smem_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      spike_seq_smem_kernel<false><<<1, 256, bytes, s>>>(words, k, scratch, out);
    }
  } else if (rw) {
    spike_seq_kernel<true><<<1, 1, 0, s>>>(words, size, k, scratch, out);
  } else {
    spike_seq_kernel<false><<<1, 1, 0, s>>>(words, size, k, scratch, out);
  }
  return (int)cudaGetLastError();
}

// spike_table: `chains` in {1, 8, 16} over n words in global memory, or
// one chain over 2^15 words in shared memory.
extern "C" int spike_table_launch(const int32_t* table, int32_t n, int32_t k,
                                  int32_t chains, int32_t shared,
                                  int32_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (shared) {
    if (chains != 1 || n != SPIKE_SMEM_WORDS) return (int)cudaErrorInvalidValue;
    const int bytes = SPIKE_SMEM_WORDS * 4;
    cudaFuncSetAttribute(spike_table_smem_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    spike_table_smem_kernel<<<1, 256, bytes, s>>>(table, k, out);
  } else if (chains == 1) {
    spike_table_kernel<1><<<1, 1, 0, s>>>(table, k, out);
  } else if (chains == 8) {
    spike_table_kernel<8><<<1, 1, 0, s>>>(table, k, out);
  } else if (chains == 16) {
    spike_table_kernel<16><<<1, 1, 0, s>>>(table, k, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// spike_fire: `chains` in {4, 8, 16} over n words in global memory.
extern "C" int spike_fire_launch(const int32_t* table, int32_t n, int32_t k,
                                 int32_t chains, int32_t w_off, int32_t* out,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chains == 4) {
    spike_fire_kernel<4><<<1, 1, 0, s>>>(table, n, k, w_off, out);
  } else if (chains == 8) {
    spike_fire_kernel<8><<<1, 1, 0, s>>>(table, n, k, w_off, out);
  } else if (chains == 16) {
    spike_fire_kernel<16><<<1, 1, 0, s>>>(table, n, k, w_off, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
