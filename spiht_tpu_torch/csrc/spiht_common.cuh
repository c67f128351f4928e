// Shared pieces of the SPIHT bit machines (spiht_encode.cu, spiht_decode.cu).
//
// Each kernel is one thread block per stream (the batched kernels B4, B5 and
// batched B3 launch one block per stream of the batch, blockIdx.x being the
// stream). What bounds every machine on an H100 is the dependent chain of
// bit decisions, paid in instruction and memory latency, not bytes. The
// decoders decide in warp 0, 32 queue entries (or, in the LIP pass, 32
// stream bits) a warp step: ballots, shuffles and one warp scan give every
// lane its entry's bits and write positions, after all threads of the block
// have gathered what the chunk of entries will need into shared memory and
// staged the stream words it can reach. The encoder (B1, B4) decides a
// whole chunk with the whole block: one block scan (warp scans, then the
// warp totals in shared memory) places every entry; in B7, the sequential
// encoder, one thread decides every entry while loader warps fill a ring of
// its entries' table words in shared memory. Control flow around every barrier and every warp
// collective is uniform: the values it depends on are read from shared
// memory after a barrier, or are the same in every lane.
//
// The machines are plain functions of (tid, nthreads) (SPIHT_HD is
// __device__ under nvcc and inline otherwise), so the same source also
// compiles as host C++: the host build supplies the block barrier and each
// warp's collectives (spiht_host_*) and runs host threads as the block
// (tests/test_torch_kernel_source.py).
//
// Bit order is the wire format of the reference codec: bits are packed
// LSB-first into 32-bit little-endian words.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SPIHT_HD __device__ __forceinline__
#define SPIHT_SYNC() __syncthreads()
// warp-level collectives of the calling thread's warp (lane = its lane id)
#define WARP_BALLOT(lane, p) __ballot_sync(0xFFFFFFFFu, (p))
#define WARP_SHFL(lane, v, src) __shfl_sync(0xFFFFFFFFu, (v), (src))
#define WARP_SHFL_UP(lane, v, d) __shfl_up_sync(0xFFFFFFFFu, (v), (d))
#define WARP_SYNC(lane) __syncwarp()
#define POPC(x) __popc(x)
#define CTZ(x) (__ffs(x) - 1)
#define ATOMIC_OR(p, v) atomicOr((p), (v))
#else
#define SPIHT_HD inline
// the host build's block barrier and warp collectives
void spiht_host_sync();
uint32_t spiht_host_ballot(int lane, bool p);
int32_t spiht_host_shfl(int lane, int32_t v, int src);
int32_t spiht_host_shfl_up(int lane, int32_t v, int d);
void spiht_host_syncwarp(int lane);
#define SPIHT_SYNC() spiht_host_sync()
#define WARP_BALLOT(lane, p) spiht_host_ballot((lane), (p))
#define WARP_SHFL(lane, v, src) spiht_host_shfl((lane), (v), (src))
#define WARP_SHFL_UP(lane, v, d) spiht_host_shfl_up((lane), (v), (d))
#define WARP_SYNC(lane) spiht_host_syncwarp(lane)
#define POPC(x) __builtin_popcount(x)
#define CTZ(x) __builtin_ctz(x)
#define ATOMIC_OR(p, v) __atomic_fetch_or((p), (v), __ATOMIC_RELAXED)
#endif

// stat[1] error codes (0 = none). Every one is a fault the wrapper raises.
enum SpihtError : int32_t {
  SPIHT_OK = 0,
  SPIHT_ERR_STREAM_CAP = 1,  // encoder: the stream needed more than the word buffer
  SPIHT_ERR_LIP_CAP = 2,     // a queue outgrew its capacity
  SPIHT_ERR_LIS_CAP = 3,
  SPIHT_ERR_LSP_CAP = 4,
};

// stat layout written by every machine (int32[SPIHT_STAT_LEN]):
//   [0] encoder: bits emitted; decoders: LSP entries committed
//   [1] error code
//   [2] final LIP length  [3] final LIS length  [4] final LSP length
//   [5] decoders: bits consumed; encoder: 0
#define SPIHT_STAT_LEN 6

// The decoders' queue entries gathered per chunk, and the block size of
// every kernel but B1 and B7 (spiht_encode.cu sets theirs).
#define SPIHT_CHUNK 512
#define SPIHT_THREADS 256
#define SPIHT_WARP 32

// Values thread 0 publishes to the block (read by all after a barrier).
struct Published {
  int32_t lip_n, lis_n, lsp_n, stop;
};

// OR the low `len` bits of v (len <= 32) into zeroed words at bit `pos`
// (B1's staged words: threads OR disjoint bit ranges of one word at once).
SPIHT_HD void or_bits(uint32_t* words, int32_t pos, uint32_t v, int len) {
  if (!v) return;
  const int sh = pos & 31;
  ATOMIC_OR(&words[pos >> 5], v << sh);
  if (sh && sh + len > 32) ATOMIC_OR(&words[(pos >> 5) + 1], v >> (32 - sh));
}

// Inclusive sum over lanes 0..lane of warp 0.
SPIHT_HD int32_t warp_scan(int lane, int32_t v) {
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t u = WARP_SHFL_UP(lane, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Bit `i` of the stream (the caller knows i < nbits).
SPIHT_HD int stream_bit(const uint32_t* words, int32_t i) {
  return (words[i >> 5] >> (i & 31)) & 1;
}

// The next min(32, nbits - cur) stream bits from bit `cur`, zero above.
SPIHT_HD uint32_t stream_window(const uint32_t* words, int32_t cur,
                                int32_t nbits) {
  const int32_t i = cur >> 5, sh = cur & 31, avail = nbits - cur;
  uint32_t w = words[i] >> sh;
  if (sh && cur - sh + 32 < nbits) w |= words[i + 1] << (32 - sh);
  return avail < 32 ? w & ((1u << avail) - 1) : w;
}

// Magnitude a decoder commits for a coefficient found significant at plane
// n: 1.5 * 2^n (1 at n = 0), as in the reference decoder.
SPIHT_HD int32_t commit_mag(int n) {
  return n == 0 ? 1 : ((1 << (n - 1)) + (1 << n));
}

SPIHT_HD int32_t min32(int32_t a, int32_t b) { return a < b ? a : b; }

// Row stride of a per-stream queue of capacity `cap` in a batched launch
// (every row holds at least one entry; the wrappers allocate the same).
SPIHT_HD int64_t queue_stride(int32_t cap) { return cap > 0 ? cap : 1; }
