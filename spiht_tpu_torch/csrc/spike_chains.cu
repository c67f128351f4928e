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
//   spike_machine  replaces tools/spike_pallas_machine.py:build's kernel
//                  (:37, pallas_call :92) and tools/spike_pallas_ilp.py:
//                  build's kernel (:40, pallas_call :102): K steps of the
//                  sequential decoder's per-bit body (machine_step) over
//                  four state arrays (rec, lip, lsp, lis) of `size` words a
//                  chain and the stream words, in B chains. Layout ilp: one
//                  thread steps the B chains, the B chains' loads of a step
//                  issued together (the TPU spike's design); layout warp: B
//                  lanes of one warp, one chain a lane. The TPU kernels
//                  extract each word from a (1, 128) row by a one-hot sum
//                  and write by masked row read-modify-writes; here a thread
//                  indexes the word.
//
// What bounds them on an H100: by design, the latency of each dependent
// access (shared memory, L1, L2 or HBM by where the array lies), not bytes
// or operations; a chain's step cannot start before its load returns. The
// design keeps that one load on the chain's path and nothing else: direct
// indexing, no extraction, the B chains' loads independent of each other.
// The outputs are those of the TPU kernels: (1, 2) int32 (pos, acc) for
// spike_seq, (1, 128) int32 for the table spikes (lane b chain b's head,
// the other lanes x for one chain, 0 for B chains, the checksum for fire),
// (1, 3B + 1) int32 for spike_machine (chain b's pos, acc, cnt at 3b..3b+2;
// the last entry, which the TPU kernel never writes, INT32_MIN as the
// interpreter leaves it). spike_machine's state starts at INT32_MIN too
// (the caller fills it): the TPU kernels never initialise their scratch,
// and never write lip or lis, so the chain reads what the interpreter
// fills scratch with.
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
// lip and lis are never written by spike_machine: read them on the
// read-only path, so their loads need not wait for the rec and lsp stores
#define SPIKE_LDG(p) __ldg(p)
#else
#define SPIKE_LDG(p) (*(p))
#endif

// v mod n in [0, n) (Python's %: the spike's int32 arithmetic floors; C's
// % truncates toward zero, and acc or lip ^ word may be negative).
SPIKE_HD int32_t floormod(int32_t v, int32_t n) {
  const int32_t r = v % n;
  return r < 0 ? r + n : r;
}

// One chain's state arrays, `size` int32 words each.
struct MachineArrays {
  int32_t* rec;
  const int32_t* lip;
  int32_t* lsp;
  const int32_t* lis;
};

// K steps of spike_pallas_machine's body (:41-82) in B chains, the B
// chains' loads of each step issued before any of its stores (the chains
// share no array, so this is the order of the spike's body). One step:
//   word = words[pos], bit = (word >> (pos & 31)) & 1
//   node = floormod(lip[floormod(acc)] ^ word); rec[node] += bit + 1
//   lsp[cnt mod size] = node; lval = lis[floormod(node * 7)]
//   acc ^= word + pos + lval; pos = (pos + 1 + ((word >> (pos & 7)) & 7))
//   mod nwords; cnt += bit
// in int32 arithmetic that wraps (done in uint32). st holds each chain's
// (pos, acc, cnt), updated in place.
template <int B>
SPIKE_HD void machine_chain(const int32_t* __restrict__ words, int32_t nwords,
                            int32_t size, int32_t k, const MachineArrays* arr,
                            int32_t* st) {
  int32_t pos[B], acc[B], cnt[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    pos[b] = st[3 * b];
    acc[b] = st[3 * b + 1];
    cnt[b] = st[3 * b + 2];
  }
  for (int32_t t = 0; t < k; ++t) {
    int32_t word[B], ent[B], node[B], r[B], lval[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      word[b] = words[pos[b]];
      ent[b] = SPIKE_LDG(arr[b].lip + floormod(acc[b], size));
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      node[b] = floormod(ent[b] ^ word[b], size);
      r[b] = arr[b].rec[node[b]];
      lval[b] = SPIKE_LDG(
          arr[b].lis + floormod((int32_t)((uint32_t)node[b] * 7u), size));
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int32_t bit = (word[b] >> (pos[b] & 31)) & 1;
      arr[b].rec[node[b]] = (int32_t)((uint32_t)r[b] + (uint32_t)(bit + 1));
      arr[b].lsp[cnt[b] % size] = node[b];  // cnt >= 0
      acc[b] ^= (int32_t)((uint32_t)word[b] + (uint32_t)pos[b] +
                          (uint32_t)lval[b]);
      pos[b] = (pos[b] + 1 + ((word[b] >> (pos[b] & 7)) & 7)) % nwords;
      cnt[b] += bit;
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    st[3 * b] = pos[b];
    st[3 * b + 1] = acc[b];
    st[3 * b + 2] = cnt[b];
  }
}

// Chain b of a spike_machine launch: its arrays in the (B, 4, size) state
// (rec, lip, lsp, lis) and its start (37b, 101b, 0), as the ILP spike's.
SPIKE_HD MachineArrays machine_arrays(int32_t* state, int32_t size, int b) {
  int32_t* s = state + (int64_t)4 * b * size;
  return MachineArrays{s, s + size, s + 2 * (int64_t)size,
                       s + 3 * (int64_t)size};
}

SPIKE_HD void machine_start(int b, int32_t* st) {
  st[0] = 37 * b;
  st[1] = 101 * b;
  st[2] = 0;
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

// spike_machine, layout ilp: one thread steps the B chains.
template <int B>
__global__ void spike_machine_ilp_kernel(const int32_t* __restrict__ words,
                                         int32_t nwords, int32_t* state,
                                         int32_t size, int32_t k,
                                         int32_t* __restrict__ out) {
  MachineArrays arr[B];
  int32_t st[3 * B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    arr[b] = machine_arrays(state, size, b);
    machine_start(b, st + 3 * b);
  }
  machine_chain<B>(words, nwords, size, k, arr, st);
#pragma unroll
  for (int i = 0; i < 3 * B; ++i) out[i] = st[i];
  out[3 * B] = INT32_MIN;
}

// spike_machine, layout warp: lane b of one warp steps chain b.
__global__ void spike_machine_warp_kernel(const int32_t* __restrict__ words,
                                          int32_t nwords, int32_t* state,
                                          int32_t size, int32_t k,
                                          int32_t chains,
                                          int32_t* __restrict__ out) {
  const int b = threadIdx.x;
  if (b == 0) out[3 * chains] = INT32_MIN;
  if (b >= chains) return;
  const MachineArrays arr = machine_arrays(state, size, b);
  int32_t st[3];
  machine_start(b, st);
  machine_chain<1>(words, nwords, size, k, &arr, st);
  out[3 * b] = st[0];
  out[3 * b + 1] = st[1];
  out[3 * b + 2] = st[2];
}

// spike_machine: `chains` in {1, 2, 4, 8} over nwords stream words and the
// (chains, 4, size) state (INT32_MIN-filled by the caller); warp = 0 the
// ilp layout, 1 the warp layout. out: 3 chains + 1 int32.
extern "C" int spike_machine_launch(const int32_t* words, int32_t nwords,
                                    int32_t* state, int32_t size, int32_t k,
                                    int32_t chains, int32_t warp,
                                    int32_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (warp) {
    if (chains != 1 && chains != 2 && chains != 4 && chains != 8)
      return (int)cudaErrorInvalidValue;
    spike_machine_warp_kernel<<<1, 32, 0, s>>>(words, nwords, state, size, k,
                                               chains, out);
  } else if (chains == 1) {
    spike_machine_ilp_kernel<1><<<1, 1, 0, s>>>(words, nwords, state, size,
                                                k, out);
  } else if (chains == 2) {
    spike_machine_ilp_kernel<2><<<1, 1, 0, s>>>(words, nwords, state, size,
                                                k, out);
  } else if (chains == 4) {
    spike_machine_ilp_kernel<4><<<1, 1, 0, s>>>(words, nwords, state, size,
                                                k, out);
  } else if (chains == 8) {
    spike_machine_ilp_kernel<8><<<1, 1, 0, s>>>(words, nwords, state, size,
                                                k, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
