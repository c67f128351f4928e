// Block microbenchmarks: the port of the two TPU spikes that measure a
// whole 128-lane row an iteration.
//
//   spike_block    replaces tools/spike_pallas_block.py:build's kernel (:42,
//                  pallas_call :181; numpy model ref_model :205): the hybrid
//                  encoder's block primitives. Each iteration takes a row of
//                  128 magnitudes, decides each lane's significance at plane
//                  it % 8, emits each lane's 2-bit group at its prefix
//                  offset into the words buffer, and appends the lane's
//                  magnitude to the LSP (significant) or the LIP (not), in
//                  lane order. The TPU kernel computes the prefix with a
//                  triangular matmul, the compaction with one-hot permute
//                  matmuls and the emission with masked lane reductions
//                  over a word window (Mosaic has no scalar VMEM indexing);
//                  here one block of 128 threads, thread j lane j, takes
//                  the significance ranks from a ballot and popc a warp plus
//                  the four warp totals (kk = 1 + sig, so the exclusive
//                  prefix of kk is j plus the lane's rank), ORs its group
//                  into the words with atomicOr, and stores its magnitude at
//                  its rank. The three (rows, 128) arrays lie in global
//                  memory (768 KB at 512 rows: more than a block's shared
//                  memory), L2-resident.
//   spike_token    replaces tools/spike_token_matmul.py:build's kernel (:48,
//                  pallas_call :133): the token heads of K 128-bit windows
//                  (the lanes reachable from lane 0 under succ(p) = p + 1 +
//                  b[p], the LIP grammar's {0, 1s} token starts), each
//                  window's head count folded into the next window's bits.
//                  Kinds: scan, B2's carry arithmetic (spiht_decode.cu,
//                  dec_lip_chunk) over two 64-bit halves, one thread (the
//                  TPU's VPU pointer doubling is not carried over);
//                  mma_tf32 and mma_bf16, seven squarings of the 0/1 matrix
//                  I + S thresholded at > 0 (row 0 is the heads), written
//                  as mma.sync (m16n8k8 tf32, m16n8k16 bf16, f32
//                  accumulate) over the matrix in shared memory, one block
//                  of four warps; both, all three, the heads' differences
//                  times 1,000,000 added to the output, as the spike's body
//                  (:117-124) does.
//
// What bounds them on an H100: spike_block, the block's barrier and its
// atomics an iteration (its bytes, ~1 KB an iteration, are far below a
// microsecond of HBM); spike_token's scan kind, its dependent chain of 64-bit
// ALU operations a window; its mma kinds, the tensor cores' rate for one
// block (one SM's share, 1/132 of the card's) and the barriers between
// squarings. The outputs are the TPU kernels': (1, 4) int32 [pos, lsp_cnt,
// lip_w, acc] and the (rows, 128) lsp, lip and words for spike_block;
// (1, 1) int32 acc for spike_token.
//
// block_spike is written on spiht_common.cuh's warp macros, so the host
// build runs it in the fiber harness (tests/test_torch_kernel_source.py);
// token_scan_acc, the scan kind, compiles as host C++ too
// (tests/test_torch_spikes.py).

#include <stdint.h>

#include "spiht_common.cuh"

#define BLOCK_LANES 128

// The block's per-iteration warp totals (significant | sign << 16),
// double-buffered by the iteration's parity: one barrier an iteration.
struct BlockShared {
  uint32_t cnt[2][BLOCK_LANES / SPIHT_WARP];
};

// spike_block on thread `tid` of a 128-thread block: zero lsp, lip and
// words (rows x 128 each), then niter iterations of ref_model; thread 0
// writes out = [pos, lsp_cnt, lip_w, acc].
SPIHT_HD void block_spike(const int32_t* mag, int32_t rows, int32_t niter,
                          int32_t* out, int32_t* lsp, int32_t* lip,
                          uint32_t* words, BlockShared& sh, int tid) {
  const int32_t size = rows * BLOCK_LANES;
  for (int32_t i = tid; i < size; i += BLOCK_LANES) {
    lsp[i] = 0;
    lip[i] = 0;
    words[i] = 0;
  }
  SPIHT_SYNC();
  const int lane = tid & (SPIHT_WARP - 1), warp = tid / SPIHT_WARP;
  const uint32_t below = (1u << lane) - 1;
  int32_t pos = 0, lsp_cnt = 0, lip_w = 0;
  uint32_t acc = 0;
  for (int32_t it = 0; it < niter; ++it) {
    const int32_t m = mag[(int64_t)(it % rows) * BLOCK_LANES + tid];
    // a logical shift: bit 31 (the sign) counts as magnitude
    const uint32_t sig = ((uint32_t)m >> (it & 7)) != 0;
    const uint32_t sgn = (uint32_t)m >> 31;
    const uint32_t bs = WARP_BALLOT(lane, sig), bg = WARP_BALLOT(lane, sgn);
    if (lane == 0) sh.cnt[it & 1][warp] = POPC(bs) | (uint32_t)POPC(bg) << 16;
    SPIHT_SYNC();
    int32_t rank = POPC(bs & below), nsig = 0, nsgn = 0;
    for (int w = 0; w < BLOCK_LANES / SPIHT_WARP; ++w) {
      const uint32_t c = sh.cnt[it & 1][w];
      if (w < warp) rank += c & 0xFFFF;
      nsig += c & 0xFFFF;
      nsgn += c >> 16;
    }
    // the group goes out whole (2 bits) at pos + prefix(kk), kk = 1 + sig,
    // and its bit above the word's top spills into the next word
    const uint32_t grp = sig | sgn << 1;
    const int32_t off = pos + tid + rank, w0 = off >> 5;
    const int s = off & 31;
    if (grp) ATOMIC_OR(&words[w0 % size], grp << s);
    if (s && (grp >> (32 - s))) ATOMIC_OR(&words[(w0 + 1) % size], grp >> (32 - s));
    if (sig) lsp[(lsp_cnt + rank) % size] = m;
    else lip[(lip_w + tid - rank) % size] = m;
    pos += BLOCK_LANES + nsig;
    acc ^= (uint32_t)(nsig + 2 * nsgn);
    lsp_cnt += nsig;
    lip_w += BLOCK_LANES - nsig;
  }
  if (tid == 0) {
    out[0] = pos;
    out[1] = lsp_cnt;
    out[2] = lip_w;
    out[3] = (int32_t)acc;
  }
}

// ---- spike_token ----
#define TOKEN_ROWS 64
#define TOKEN_EVEN 0x5555555555555555ull

#ifdef __CUDACC__
#define POPC64(x) __popcll(x)
#else
#define POPC64(x) __builtin_popcountll(x)
#endif

// Bit 0 of each of x's 64 x 128 words, four 32-bit words a row; thread
// `tid` of `nt` packs words tid, tid + nt, ...
SPIHT_HD void token_bits(const int32_t* x, uint32_t (*xb)[4], int tid = 0,
                         int nt = 1) {
  for (int i = tid; i < TOKEN_ROWS * 4; i += nt) {
    uint32_t v = 0;
    for (int j = 0; j < 32; ++j) v |= (uint32_t)(x[i * 32 + j] & 1) << j;
    xb[i >> 2][i & 3] = v;
  }
}

// Window i's 128 bits b = (x[i % 64] ^ seed) & 1 as two 64-bit halves.
SPIHT_HD void token_window(const uint32_t (*xb)[4], int32_t i, uint32_t seed,
                           uint64_t& lo, uint64_t& hi) {
  const uint32_t* r = xb[i % TOKEN_ROWS];
  const uint32_t f = seed ? ~0u : 0u;
  lo = (uint64_t)(r[1] ^ f) << 32 | (r[0] ^ f);
  hi = (uint64_t)(r[3] ^ f) << 32 | (r[2] ^ f);
}

// The significance bits of 64 bits whose bit 0 starts a token: in each run
// of ones, the ones an even distance from its first bit (the first bit of
// a run always starts a token), as in dec_lip_chunk.
SPIHT_HD uint64_t token_sig(uint64_t x) {
  const uint64_t first = x & ~(x << 1);
  const uint64_t even = x & ~(x + (first & TOKEN_EVEN));  // runs from even bits
  return (even & TOKEN_EVEN) | (x & ~even & ~TOKEN_EVEN);
}

// The token heads of a 128-bit window: a bit starts a token unless the bit
// before it is a significance bit (then it is that token's sign). The
// high half starts at bit 64 unless bit 63 is a significance bit: then
// bit 64 is a sign, and the half is read as from a 0 there.
SPIHT_HD void token_heads_scan(uint64_t lo, uint64_t hi, uint64_t& hlo,
                               uint64_t& hhi) {
  const uint64_t slo = token_sig(lo), carry = slo >> 63;
  hlo = ~(slo << 1);
  hhi = ~(token_sig(hi & ~carry) << 1) & ~carry;
}

SPIHT_HD void token_fold(uint32_t& acc, uint32_t& seed, uint32_t s) {
  acc += s;
  seed = (seed + s) & 1;
}

// The scan kind's K windows (one thread). Returns acc.
SPIHT_HD int32_t token_scan_acc(const uint32_t (*xb)[4], int32_t k) {
  uint32_t acc = 0, seed = 0;
  for (int32_t i = 0; i < k; ++i) {
    uint64_t lo, hi, h0, h1;
    token_window(xb, i, seed, lo, hi);
    token_heads_scan(lo, hi, h0, h1);
    token_fold(acc, seed, POPC64(h0) + POPC64(h1));
  }
  return (int32_t)acc;
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

#include <type_traits>

enum TokenKind : int32_t {
  TOKEN_SCAN = 0,
  TOKEN_TF32 = 1,
  TOKEN_BF16 = 2,
  TOKEN_BOTH = 3,
};

// The closure's 128 x 128 matrix M and its transpose MT in shared memory,
// rows padded to a stride of 4 mod 32 words, so the eight rows of a
// fragment load fall in distinct banks. TF32 elements are floats, bf16
// elements raw 16-bit words (1.0 is 0x3F80). 0 and 1 are exact in both
// formats and every dot product is a count of at most 128 ones, exact in
// the f32 accumulator: the TF32 hazard (three decimal digits) cannot bite.
template <bool BF16>
struct TokenMat {
  using E = typename std::conditional<BF16, uint16_t, float>::type;
  static constexpr int STRIDE = BF16 ? 136 : 132;  // elements
  static constexpr int KSTEP = BF16 ? 16 : 8;
  static constexpr int BYTES = 2 * 128 * STRIDE * (int)sizeof(E);
  __device__ static E one() {
    if constexpr (BF16) return (E)0x3F80;
    else return 1.0f;
  }
  __device__ static uint32_t word(const E* p) {  // 32 bits at p
    if constexpr (BF16) return *(const uint32_t*)p;
    else return __float_as_uint(*p);
  }
};

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// M <- (M M > 0), MT with it. Warp w computes rows 32w..32w+31 (two
// m-tiles) against all 128 columns (two groups of eight n-tiles), keeps
// each entry as one bit, and writes back after the block's barrier.
template <bool BF16>
__device__ void token_square(typename TokenMat<BF16>::E* M,
                             typename TokenMat<BF16>::E* MT, int tid) {
  using T = TokenMat<BF16>;
  constexpr int S = T::STRIDE;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  uint32_t bits[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = 32 * warp + 16 * mt + g;
#pragma unroll
    for (int ng = 0; ng < 2; ++ng) {
      float c[8][4] = {};
      // two k-steps a pass: unrolled whole, the loads of all 16 steps are
      // hoisted and the kernel spills past 255 registers
#pragma unroll 2
      for (int k0 = 0; k0 < 128; k0 += T::KSTEP) {
        uint32_t a[4];
        if constexpr (BF16) {  // pairs along k: (2t, 2t+1), (2t+8, 2t+9)
          a[0] = T::word(M + r * S + k0 + 2 * t);
          a[1] = T::word(M + (r + 8) * S + k0 + 2 * t);
          a[2] = T::word(M + r * S + k0 + 2 * t + 8);
          a[3] = T::word(M + (r + 8) * S + k0 + 2 * t + 8);
        } else {
          a[0] = T::word(M + r * S + k0 + t);
          a[1] = T::word(M + (r + 8) * S + k0 + t);
          a[2] = T::word(M + r * S + k0 + t + 4);
          a[3] = T::word(M + (r + 8) * S + k0 + t + 4);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const typename T::E* col = MT + (64 * ng + 8 * nt + g) * S + k0;
          if constexpr (BF16) {
            mma_bf16(c[nt], a, T::word(col + 2 * t), T::word(col + 2 * t + 8));
          } else {
            mma_tf32(c[nt], a, T::word(col + t), T::word(col + t + 4));
          }
        }
      }
      uint32_t v = 0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) v |= (uint32_t)(c[nt][j] > 0.f) << (4 * nt + j);
      bits[mt][ng] = v;
    }
  }
  __syncthreads();  // every warp has read M and MT
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ng = 0; ng < 2; ++ng)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = 32 * warp + 16 * mt + g + (j >> 1) * 8;
          const int col = 64 * ng + 8 * nt + 2 * t + (j & 1);
          const typename T::E e =
              ((bits[mt][ng] >> (4 * nt + j)) & 1) ? T::one() : (typename T::E)0;
          M[row * S + col] = e;
          MT[col * S + row] = e;
        }
  __syncthreads();
}

// The heads of one window by the closure (I + S)^128, seven squarings;
// row 0 of the result, as two 64-bit halves, in every thread.
template <bool BF16>
__device__ void token_heads_mma(uint64_t lo, uint64_t hi, void* smem,
                                uint32_t* hw, int tid, uint64_t& hlo,
                                uint64_t& hhi) {
  using T = TokenMat<BF16>;
  using E = typename T::E;
  constexpr int S = T::STRIDE;
  E* M = (E*)smem;
  E* MT = M + 128 * S;
  for (int i = tid; i < 2 * 128 * S; i += 128) M[i] = (E)0;
  __syncthreads();
  const int p = tid;
  const int bp = (int)(((p < 64 ? lo >> p : hi >> (p - 64))) & 1);
  const int q = p + 1 + bp;
  M[p * S + p] = T::one();
  MT[p * S + p] = T::one();
  if (q < 128) {
    M[p * S + q] = T::one();
    MT[q * S + p] = T::one();
  }
  __syncthreads();
  for (int it = 0; it < 7; ++it) token_square<BF16>(M, MT, tid);
  const uint32_t b = __ballot_sync(0xFFFFFFFFu, M[tid] != (E)0);
  if ((tid & 31) == 0) hw[tid >> 5] = b;
  __syncthreads();
  hlo = (uint64_t)hw[1] << 32 | hw[0];
  hhi = (uint64_t)hw[3] << 32 | hw[2];
}

// spike_token's mma kinds and both: one block of 128 threads.
template <int KIND>
__global__ void __launch_bounds__(128)
    spike_token_kernel(const int32_t* __restrict__ x, int32_t k,
                       int32_t* __restrict__ out) {
  __shared__ uint32_t xb[TOKEN_ROWS][4];
  __shared__ uint32_t hw[4];
  extern __shared__ float4 token_smem[];
  const int tid = threadIdx.x;
  token_bits(x, xb, tid, blockDim.x);
  __syncthreads();
  if (KIND == TOKEN_SCAN) {
    if (tid == 0) out[0] = token_scan_acc(xb, k);
    return;
  }
  uint32_t acc = 0, seed = 0;
  for (int32_t i = 0; i < k; ++i) {
    uint64_t lo, hi, h0, h1;
    token_window(xb, i, seed, lo, hi);
    if (KIND == TOKEN_TF32) {
      token_heads_mma<false>(lo, hi, token_smem, hw, tid, h0, h1);
    } else if (KIND == TOKEN_BF16) {
      token_heads_mma<true>(lo, hi, token_smem, hw, tid, h0, h1);
    } else {
      uint64_t t0, t1, u0, u1;
      token_heads_scan(lo, hi, h0, h1);
      token_heads_mma<false>(lo, hi, token_smem, hw, tid, t0, t1);
      token_heads_mma<true>(lo, hi, token_smem, hw, tid, u0, u1);
      acc += (uint32_t)(POPC64(h0 ^ t0) + POPC64(h1 ^ t1) + POPC64(h0 ^ u0) +
                        POPC64(h1 ^ u1)) * 1000000u;
    }
    token_fold(acc, seed, POPC64(h0) + POPC64(h1));
  }
  if (tid == 0) out[0] = (int32_t)acc;
}

__global__ void __launch_bounds__(BLOCK_LANES)
    spike_block_kernel(const int32_t* __restrict__ mag, int32_t rows,
                       int32_t niter, int32_t* __restrict__ out,
                       int32_t* lsp, int32_t* lip, int32_t* words) {
  __shared__ BlockShared sh;
  block_spike(mag, rows, niter, out, lsp, lip, (uint32_t*)words, sh,
              threadIdx.x);
}

// spike_block: mag and the three outputs are (rows, 128) int32.
extern "C" int spike_block_launch(const int32_t* mag, int32_t rows,
                                  int32_t niter, int32_t* out, int32_t* lsp,
                                  int32_t* lip, int32_t* words, void* stream) {
  spike_block_kernel<<<1, BLOCK_LANES, 0, (cudaStream_t)stream>>>(
      mag, rows, niter, out, lsp, lip, words);
  return (int)cudaGetLastError();
}

// both overlays the bf16 matrices on the tf32 ones' shared memory
static_assert(TokenMat<true>::BYTES <= TokenMat<false>::BYTES,
              "both sizes its shared memory for the tf32 matrices");

template <int KIND>
static int token_launch(const int32_t* x, int32_t k, int32_t* out,
                        cudaStream_t s) {
  const int bytes = KIND == TOKEN_SCAN ? 0
                    : KIND == TOKEN_BF16 ? TokenMat<true>::BYTES
                                         : TokenMat<false>::BYTES;
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(spike_token_kernel<KIND>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  spike_token_kernel<KIND><<<1, KIND == TOKEN_SCAN ? 1 : 128, bytes, s>>>(
      x, k, out);
  return (int)cudaGetLastError();
}

// spike_token: x is (64, 128) int32; kind a TokenKind.
extern "C" int spike_token_launch(const int32_t* x, int32_t k, int32_t kind,
                                  int32_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case TOKEN_SCAN: return token_launch<TOKEN_SCAN>(x, k, out, s);
    case TOKEN_TF32: return token_launch<TOKEN_TF32>(x, k, out, s);
    case TOKEN_BF16: return token_launch<TOKEN_BF16>(x, k, out, s);
    case TOKEN_BOTH: return token_launch<TOKEN_BOTH>(x, k, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#endif  // __CUDACC__
