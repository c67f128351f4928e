// SPIHT decode machines (kernels B2 and B3; at the end, kernel B5 and the
// batched launch of B3 run them over a batch of streams).
//
//   spiht_decode_lsp  replaces spiht_tpu/codec/pallas_decoder.py:_hybrid_fn,
//                     the decoder of duplicate-free geometries. It writes
//                     the LSP queues (node, sgn<<31 | magnitude) and a count;
//                     rec is one scatter after the kernel (codec/decoder.py).
//   spiht_decode_lsp_log  replaces the with_log variant of the same _hybrid_fn
//                     (pallas_decoder.py:571-579): B2's machine with the LOG
//                     flag, which also writes the compact event log of the
//                     metadata trace (below).
//   spiht_decode_seq  replaces spiht_tpu/codec/pallas_decoder.py:_seq_fn,
//                     the decoder every odd-LL (duplicate-parent) geometry
//                     goes to. It keeps rec in the kernel: a node may be
//                     committed by several parents, and every LSP instance
//                     refines the one shared rec value in place.
//   spiht_decode_seq_log  B3's machine with the LOG flag: the event log of
//                     the metadata trace for odd-LL geometries (the JAX
//                     package traces them on the host; the TPU kernel
//                     _seq_fn has no log).
//
// All honour byte-prefix truncation exactly: the machine stops at the
// first bit it cannot read, and a symbol cut short has no effect (a
// significance bit whose sign bit is missing commits nothing).
//
// State layout (identical in the plain versions, codec/decoder.py):
//   geo[N] = child0<<2 | has_child<<1 | has_grandchildren
//   lip[] holds node indices, lis[] node<<1 | type_A; in-place FIFOs as in
//   the encoder. The commit magnitude is 1.5 * 2^n; refinement sets or
//   clears bit n of the magnitude and keeps the sign.
//   B3-log (SEQ and LOG) packs the filter of each entry's instance into
//   the entry's free bits (nodes are below 2^29): bits 29-30 of a LIP or
//   LSP word, bits 30-31 of a LIS word. With duplicate parents one node is
//   reached through up to three LL parents of different parity, and each
//   instance, with its whole subtree, carries its own filter. The other
//   instantiations keep the layout above.
//
// The event log (LOG = true: B2-log and B3-log): one 64-bit word per
// attempted bit at that bit's stream offset: node in bits 0-31, action in
// bits 32-34 (the reference's action ids, EV_* below), n+1 in bits 35-39,
// and (B3-log; 0 in B2-log) the instance's filter in bits 40-41. The
// reference trace writes its row before each read, so the read that finds
// the stream empty gets a row too, at offset nbits, and nothing follows it:
// the log holds nbits + 1 words, zeroed by the caller (an unwritten word is
// 0; a written one is not, as n+1 >= 1). Each word is written by the lane
// (or, in refinement, the thread) that decides its bit.
//
// What bounds them on an H100: neither bytes nor arithmetic but the chain
// of bit decisions in the LIP and LIS passes (each bit's meaning depends on
// every earlier one), paid in instruction latency (the kernels' times are
// thousands of times their byte bounds; PERF.md, chip_smoke.py). The TPU
// kernel tokenizes the LIP 128 bits at a time with a log-depth scan of the
// grammar {0, 1s} (pallas_decoder.py token_heads) and parses two LIS fires
// per 64-bit window; this design does the same work with a warp's ballots,
// shuffles and scans:
//   - the block gathers each chunk of 512 queue entries, their geometry
//     words and the stream words the chunk can reach into shared memory,
//     so warp 0 never waits on global memory inside a chunk;
//   - the LIP pass takes 32 stream bits a warp step: the tokens' starts
//     follow from the bits with carry arithmetic (dec_lip_chunk), and one
//     popc of the lanes below gives each token its entry and its place in
//     the LSP or the retained LIP;
//   - the LIS pass takes 32 entries a warp step: a table of what a fire
//     adds at each offset, one chain over the step's type-A entries (one
//     shared load and one add each, the only serial part left), and one
//     warp scan of four packed counts (dec_lis_chunk);
//   - the step that meets the stream's end or a full queue runs bit by bit
//     (at most once a stream), which keeps every edge exact;
//   - refinement has no chain at all: entry i of the snapshot reads stream
//     bit cur+i, so the whole block refines in parallel.
// In B3 a node may be committed or refined by several LSP instances, and
// the last one in queue order wins. The passes append node | sgn<<31 to the
// LSP queue and the block sets rec from them after the passes; there, and
// in refinement, each instance claims its node with an atomic max of
// (plane tag, index) and only the winner writes (dec_commit_rec,
// dec_refine).
//
// What holds them back now (PERF.md): at configuration A about a third of
// a LIS step is the chain over its type-A entries (~48 cycles each), a
// quarter the table and a third the scan and the scattered stores; the
// per-chunk gathers and barriers are ~4% of the time.

#include "spiht_common.cuh"

struct DecArgs {
  const uint32_t* __restrict__ words;
  int32_t nbits;
  int32_t max_n;
  const int32_t* __restrict__ geo;
  int32_t n_lip0;
  int32_t n_lis0;
  int32_t w;
  int32_t* __restrict__ lip;
  int32_t lip_cap;
  int32_t* __restrict__ lis;
  int32_t lis_cap;
  int32_t* __restrict__ lsp;       // node of each LSP entry
  int32_t lsp_cap;
  int32_t* __restrict__ lsp_val;   // B2: sgn<<31 | magnitude; B3: unused
  int32_t* __restrict__ rec;       // B3: (N) coefficients, zeroed; B2: unused
  uint64_t* __restrict__ last;     // B3: (N) refinement claims, zeroed
  int32_t* __restrict__ stat;
  uint64_t* __restrict__ log;      // LOG: (nbits + 1) event words, zeroed
};

// Action ids of the event log (the reference metadata taxonomy).
enum SpihtEvent : int32_t {
  EV_LIP = 0,       // a LIP entry's significance bit
  EV_LIP_SIGN = 1,  // its sign bit
  EV_DESC = 2,      // a type-A LIS entry's descendant-significance bit
  EV_OFF = 3,       // an offspring's significance bit after a type-A fire
  EV_OFF_SIGN = 4,  // its sign bit
  EV_LSIG = 5,      // a type-B LIS entry's grandchild-significance bit
  EV_REF = 6,       // a refinement bit
};

// Filter ids of the trace (the subband of a node's instance).
enum SpihtFilter : int32_t { F_LL = 0, F_DA = 1, F_AD = 2, F_DD = 3 };

// The plane field of an event word at plane n (n <= 30).
SPIHT_HD uint64_t plane_event(int n) { return (uint64_t)(n + 1) << 35; }

// The filter field of an event word.
SPIHT_HD uint64_t filt_event(int32_t f) { return (uint64_t)f << 40; }

// The log word of an event; ev = plane_event(n) | filt_event(f).
SPIHT_HD uint64_t event(int32_t node, int32_t action, uint64_t ev) {
  return (uint64_t)(uint32_t)node | ((uint64_t)action << 32) | ev;
}

// B3-log's entries: the node and the filter of a LIP or LSP entry (node |
// f << 29, B3's sign in bit 31) and of a LIS entry (node << 1 | type |
// f << 30); with FILT false the entry is the bare layout and the filter 0.
#define NODE_MASK 0x1FFFFFFF
template <bool FILT> SPIHT_HD int32_t ent_node(int32_t x) {
  return FILT ? x & NODE_MASK : x;
}
template <bool FILT> SPIHT_HD int32_t ent_filt(int32_t x) {
  return FILT ? (x >> 29) & 3 : 0;
}
template <bool FILT> SPIHT_HD int32_t lis_node(int32_t e) {
  return FILT ? (e >> 1) & NODE_MASK : e >> 1;
}
template <bool FILT> SPIHT_HD int32_t lis_filt(int32_t e) {
  return FILT ? (int32_t)((uint32_t)e >> 30) : 0;
}
// The filter bits of a LIP or LSP entry and of a LIS entry.
template <bool FILT> SPIHT_HD int32_t ent_bits(int32_t f) {
  return FILT ? f << 29 : 0;
}
template <bool FILT> SPIHT_HD int32_t lis_bits(int32_t f) {
  return FILT ? (int32_t)((uint32_t)f << 30) : 0;
}

// The filter an entry of filter f at `node` gives its children, the first
// at c0 (the reference's _offspring_filter): its own, or an LL parent's by
// the parity of (i, j). An LL parent's first child lies (i odd) (ll_h - 1)
// rows and (j odd) (ll_w - 1) columns past it, with 1 <= ll_w - 1 < w, so
// the parity follows from c0 - node.
SPIHT_HD int32_t child_filt(int32_t f, int32_t node, int32_t c0, int32_t w) {
  if (f != F_LL) return f;
  const int32_t d = c0 - node;
  const bool i_odd = d >= w, j_odd = d % w != 0;
  return j_odd ? (i_odd ? F_DD : F_AD) : F_DA;
}

// The log word of a LIS entry's first bit (by its type).
template <bool FILT>
SPIHT_HD uint64_t lis_event(int32_t e, uint64_t ev) {
  return event(lis_node<FILT>(e), (e & 1) ? EV_DESC : EV_LSIG,
               ev | filt_event(lis_filt<FILT>(e)));
}

// Stream words staged a chunk: an LIS entry reads at most 9 bits, a LIP
// entry 2, and an LIS step loads the 11 words from its first bit on.
#define SPIHT_STAGE (9 * SPIHT_CHUNK / 32 + 16)
// Offsets of an LIS step's bits: 32 entries of at most 9 bits.
#define SPIHT_SPAN (9 * SPIHT_WARP)

// 6,780 bytes a block.
struct DecShared {
  int32_t e[SPIHT_CHUNK];      // the queue entry
  int32_t g[SPIHT_CHUNK];      // geo of its node (LIS)
  uint32_t sw[SPIHT_STAGE];    // stream words sw0.. (zero past nbits)
  int32_t kids[256];           // child_code of every 8-bit stream window
  uint8_t inc[SPIHT_SPAN];     // LIS step, by offset: the bits a type-A
  uint16_t tab[SPIHT_SPAN];    //   fire adds there; bit | child_code << 1
  int32_t va[SPIHT_WARP + 1];  // LIS step: the lanes of its type-A entries
  Published pub;
  int32_t cur;                 // bits consumed, published after each chunk
  int32_t sw0;
};

// What the 8 stream bits after a type-A fire say about its 4 offspring:
// bit q = child q significant, bit 4+q = its sign bit, bits 8.. = the bits
// they take (4..8): a child reads its significance bit, then its sign bit
// if significant.
SPIHT_HD int32_t child_code(uint32_t bits) {
  int32_t p = 0, sig = 0, sgn = 0;
  for (int q = 0; q < 4; ++q) {
    if ((bits >> p++) & 1) {
      sig |= 1 << q;
      sgn |= ((bits >> p++) & 1) << q;
    }
  }
  return sig | (sgn << 4) | (p << 8);
}

// The machine state, held identically by every lane of warp 0.
struct DecState {
  int32_t cur;   // bits consumed
  int32_t err;
  int32_t lip_n, lis_n, lsp_n;
  int32_t keep;  // retain cursor of the pass in progress
};

// Stage the stream words that `reach` bits from bit `cur` can touch, with
// a 64-bit window's slack, by every thread. Bits past nbits read as 0; the
// machines never take them for stream bits (they check nbits).
SPIHT_HD void stage_stream(const DecArgs& a, DecShared& sh, int32_t cur,
                           int32_t reach, int tid, int nt) {
  const int32_t w0 = cur >> 5;
  const int32_t nw = min32(((cur + reach + 63) >> 5) - w0 + 1, SPIHT_STAGE);
  for (int32_t i = tid; i < nw; i += nt) {
    const int32_t bit0 = (w0 + i) * 32, left = a.nbits - bit0;
    const uint32_t v = left > 0 ? a.words[w0 + i] : 0;
    sh.sw[i] = left >= 32 ? v : v & ((1u << (left > 0 ? left : 0)) - 1);
  }
  if (tid == 0) sh.sw0 = w0;
}

// Bits s .. s+31 of the 64 bits hi:lo (s < 32).
SPIHT_HD uint32_t funnel(uint32_t lo, uint32_t hi, int s) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> s);
}

// Staged stream bits pos .. pos+63 (sw0 = sh.sw0).
SPIHT_HD uint64_t staged64(const DecShared& sh, int32_t sw0, int32_t pos) {
  const int32_t i = (pos >> 5) - sw0, s = pos & 31;
  const uint64_t lo = ((uint64_t)sh.sw[i + 1] << 32) | sh.sw[i];
  return s ? (lo >> s) | ((uint64_t)sh.sw[i + 2] << (64 - s)) : lo;
}

// Next bit (0/1), or -1 once the stream is exhausted.
SPIHT_HD int next_bit(const DecArgs& a, const DecShared& sh, DecState& st) {
  if (st.cur >= a.nbits) return -1;
  const int32_t c = st.cur++;
  return (int)(sh.sw[(c >> 5) - sh.sw0] >> (c & 31)) & 1;
}

// B3's LSP entries carry the commit's sign bit above the node.
#define NODE_BITS 0x7FFFFFFF

// The node of an LSP entry: B2's entries are nodes; B3's carry the sign
// in bit 31 and, in B3-log, the filter in bits 29-30.
template <bool SEQ, bool LOG> SPIHT_HD int32_t lsp_node(int32_t x) {
  return !SEQ ? x : x & (LOG ? NODE_MASK : NODE_BITS);
}
// Set in a claim (claim_tag below) when an instance refined in this plane
// read a 0 bit (LSP indices are below 2^29).
#define CLEARED (1ull << 31)
#ifdef __CUDACC__
__device__ __forceinline__ void claim(uint64_t* p, uint64_t v) {
  atomicMax((unsigned long long*)p, (unsigned long long)v);
}
__device__ __forceinline__ void mark_cleared(uint64_t* p) {
  atomicOr((unsigned long long*)p, (unsigned long long)CLEARED);
}
#else
inline void claim(uint64_t* p, uint64_t v) {
  uint64_t old = __atomic_load_n(p, __ATOMIC_RELAXED);
  while (old < v && !__atomic_compare_exchange_n(
                        p, &old, v, true, __ATOMIC_RELAXED, __ATOMIC_RELAXED)) {
  }
}
inline void mark_cleared(uint64_t* p) {
  __atomic_fetch_or(p, (uint64_t)CLEARED, __ATOMIC_RELAXED);
}
#endif

// A commit at LSP index `at` of entry x (the node; in B3-log node | filter
// << 29): B2 writes the node and sgn<<31 | mag; B3 writes x | sgn<<31, and
// sets rec from it after the passes (dec_commit_rec).
template <bool SEQ>
SPIHT_HD void commit_at(const DecArgs& a, int32_t at, int32_t x, int s,
                        int32_t mag) {
  const int32_t sgn = (int32_t)((uint32_t)s << 31);
  a.lsp[at] = SEQ ? x | sgn : x;
  if (!SEQ) a.lsp_val[at] = sgn | mag;
}

// Commit entry x with sign bit s, from lane 0 (the bit-by-bit path).
template <bool SEQ>
SPIHT_HD bool commit(const DecArgs& a, DecState& st, int32_t x, int s,
                     int32_t mag, int lane) {
  if (st.lsp_n >= a.lsp_cap) { st.err = SPIHT_ERR_LSP_CAP; return false; }
  if (lane == 0) commit_at<SEQ>(a, st.lsp_n, x, s, mag);
  ++st.lsp_n;
  return true;
}

// The LIP and LIS passes run in warp 0, all lanes holding the same state.
// A step decides 32 tokens (LIP) or 32 entries (LIS) at once and runs in
// parallel when every bit it reads lies before nbits and no queue would
// overflow; otherwise that step runs bit by bit (the *_serial functions),
// which stops the machine exactly where the plain version stops (this
// happens at most once a stream). Each chunk function returns false when
// the machine stops (stream exhausted, or a queue would overflow: st.err
// says which).

// Entries k.. of a LIP chunk, bit by bit, lane 0 storing.
template <bool SEQ, bool LOG>
SPIHT_HD bool dec_lip_serial(const DecArgs& a, const DecShared& sh,
                             int32_t k, int32_t m, int32_t mag, uint64_t ev,
                             DecState& st, int lane) {
  constexpr bool FILT = SEQ && LOG;
  for (; k < m; ++k) {
    const int32_t x = sh.e[k], node = ent_node<FILT>(x);
    const uint64_t evx = ev | filt_event(ent_filt<FILT>(x));
    // the read that finds the stream empty is logged too, at nbits
    if (LOG && lane == 0) a.log[st.cur] = event(node, EV_LIP, evx);
    const int b = next_bit(a, sh, st);
    if (b < 0) return false;
    if (!b) {
      if (lane == 0) a.lip[st.keep] = x;
      ++st.keep;
      continue;
    }
    if (LOG && lane == 0) a.log[st.cur] = event(node, EV_LIP_SIGN, evx);
    const int s = next_bit(a, sh, st);
    if (s < 0 || !commit<SEQ>(a, st, x, s, mag, lane)) return false;
  }
  return true;
}

// The 64-bit mask of even bit positions.
#define EVEN64 0x5555555555555555ull

// The LIP pass, 32 stream bits a step. Every LIP token is `0` or `1s`, so
// the tokens' starts follow from the bits alone: in a run of ones, the
// ones an even distance from the run's first bit are significance bits
// (the others, and the zero after an odd-length run, are sign bits).
// Lane p owns the token starting at bit p of the window, if any.
template <bool SEQ, bool LOG>
SPIHT_HD bool dec_lip_chunk(const DecArgs& a, const DecShared& sh, int32_t m,
                            int32_t mag, uint64_t ev, DecState& st, int lane) {
  constexpr bool FILT = SEQ && LOG;
  const uint32_t below = (1u << lane) - 1;
  const int32_t sw0 = sh.sw0;
  for (int32_t k = 0; k < m;) {
    const uint64_t x = staged64(sh, sw0, st.cur);
    const uint64_t first = x & ~(x << 1);  // the first bit of each run
    const uint64_t even = x & ~(x + (first & EVEN64));  // runs from even bits
    const uint64_t sig64 = (even & EVEN64) | (x & ~even & ~EVEN64);
    const uint32_t starts = ~(uint32_t)(sig64 << 1);
    int32_t take = POPC(starts), used;  // tokens, bits
    if (take <= m - k) {
      used = 32 + (int32_t)((sig64 >> 31) & 1);
    } else {  // the chunk ends inside the window, at token m - k
      take = m - k;
      const bool end = ((starts >> lane) & 1) && POPC(starts & below) == take;
      used = CTZ(WARP_BALLOT(lane, end));
    }
    const uint32_t tok = used >= 32 ? starts : starts & ((1u << used) - 1);
    const uint32_t sig = (uint32_t)sig64 & tok;
    const int32_t nsig = POPC(sig);
    if (used > a.nbits - st.cur || st.lsp_n + nsig > a.lsp_cap)
      return dec_lip_serial<SEQ, LOG>(a, sh, k, m, mag, ev, st, lane);
    const bool mine = (tok >> lane) & 1, s = (sig >> lane) & 1;
    const int32_t r = POPC(tok & below), rs = POPC(sig & below);
    if (mine) {
      const int32_t e = sh.e[k + r];
      const int sgn = (int)(x >> (lane + 1)) & 1;
      if (LOG) {
        const int32_t node = ent_node<FILT>(e);
        const uint64_t evx = ev | filt_event(ent_filt<FILT>(e));
        a.log[st.cur + lane] = event(node, EV_LIP, evx);
        if (s) a.log[st.cur + lane + 1] = event(node, EV_LIP_SIGN, evx);
      }
      if (s) {
        commit_at<SEQ>(a, st.lsp_n + rs, e, sgn, mag);
      } else {
        a.lip[st.keep + r - rs] = e;
      }
    }
    st.lsp_n += nsig;
    st.keep += take - nsig;
    st.cur += used;
    k += take;
  }
  return true;
}

// Entries k.. of a LIS chunk, bit by bit, lane 0 storing.
template <bool SEQ, bool LOG>
SPIHT_HD bool dec_lis_serial(const DecArgs& a, const DecShared& sh,
                             int32_t k, int32_t m, int32_t mag, uint64_t ev,
                             DecState& st, int lane) {
  constexpr bool FILT = SEQ && LOG;
  for (; k < m; ++k) {
    const int32_t e = sh.e[k], g = sh.g[k];
    if (LOG && lane == 0) a.log[st.cur] = lis_event<FILT>(e, ev);
    const int b = next_bit(a, sh, st);
    if (b < 0) return false;
    if (!b) {
      if (lane == 0) a.lis[st.keep] = e;
      ++st.keep;
      continue;
    }
    // the filter of the children (B3-log)
    const int32_t cf = FILT ? child_filt(lis_filt<FILT>(e), lis_node<FILT>(e),
                                         g >> 2, a.w) : 0;
    if (e & 1) {  // type A: code the 4 offspring
      if ((g >> 1) & 1) {
        const uint64_t evc = ev | filt_event(cf);
        for (int q = 0; q < 4; ++q) {
          const int32_t ch = (g >> 2) + (q & 1) + (q >> 1) * a.w;
          const int32_t x = ch | ent_bits<FILT>(cf);
          if (LOG && lane == 0) a.log[st.cur] = event(ch, EV_OFF, evc);
          const int c = next_bit(a, sh, st);
          if (c < 0) return false;
          if (c) {
            if (LOG && lane == 0) a.log[st.cur] = event(ch, EV_OFF_SIGN, evc);
            const int s = next_bit(a, sh, st);
            if (s < 0 || !commit<SEQ>(a, st, x, s, mag, lane)) return false;
          } else {
            if (st.lip_n >= a.lip_cap) { st.err = SPIHT_ERR_LIP_CAP; return false; }
            if (lane == 0) a.lip[st.lip_n] = x;
            ++st.lip_n;
          }
        }
      }
      if (g & 1) {  // has grandchildren: re-append as type B
        if (st.lis_n >= a.lis_cap) { st.err = SPIHT_ERR_LIS_CAP; return false; }
        if (lane == 0) a.lis[st.lis_n] = e & ~1;
        ++st.lis_n;
      }
    } else if ((g >> 1) & 1) {  // type B: 4 type-A children
      if (st.lis_n + 4 > a.lis_cap) { st.err = SPIHT_ERR_LIS_CAP; return false; }
      if (lane < 4) {
        a.lis[st.lis_n + lane] = (((g >> 2) + (lane & 1) + (lane >> 1) * a.w) << 1) |
                                 1 | lis_bits<FILT>(cf);
      }
      st.lis_n += 4;
    }
  }
  return true;
}

// The LIS pass, 32 entries a step, lane j taking entry k+j. Only a type-A
// entry with children has a variable length (1 bit, or 1 + 4..8 when it
// fires); every other entry reads 1 bit. The lanes tabulate, for every
// offset the step can reach, what a fire there adds and what its bits
// say; one chain over the type-A entries (a shared load and an add each)
// gives every lane its first bit; one scan of four packed counts gives
// every lane its write positions in the sequential order (entry order,
// then child order). Entries appended to the LIS land past the chunk, so
// they are visited later in the same pass, as in the plain version.
template <bool SEQ, bool LOG>
SPIHT_HD bool dec_lis_chunk(const DecArgs& a, DecShared& sh, int32_t m,
                            int32_t mag, uint64_t ev, DecState& st, int lane) {
  constexpr bool FILT = SEQ && LOG;
  const uint32_t below = (1u << lane) - 1;
  const int32_t sw0 = sh.sw0;
  for (int32_t k = 0; k < m; k += SPIHT_WARP) {
    const int32_t n = min32(SPIHT_WARP, m - k);
    const bool valid = lane < n;
    const int32_t e = valid ? sh.e[k + lane] : 0;
    const int32_t g = valid ? sh.g[k + lane] : 0;
    const bool type_a = e & 1, hc = (g >> 1) & 1, hg = g & 1;
    const uint32_t var = WARP_BALLOT(lane, type_a && hc);
    const int32_t n_var = POPC(var), reach = n + 8 * n_var;  // <= SPIHT_SPAN
    if (type_a && hc) sh.va[POPC(var & below)] = lane;

    // the table: lane j fills offsets 32r + j, from the words at st.cur
    {
      const int32_t i0 = (st.cur >> 5) - sw0, s0 = st.cur & 31;
      uint32_t w[10], x[9];
      int32_t code[9];  // all loads first: they do not wait on the stores
      for (int r = 0; r < 10; ++r) w[r] = funnel(sh.sw[i0 + r], sh.sw[i0 + r + 1], s0);
      for (int r = 0; r < 9; ++r) {
        x[r] = funnel(w[r], w[r + 1], lane);
        code[r] = sh.kids[(x[r] >> 1) & 255];
      }
      for (int r = 0; r < 9; ++r) {
        const int32_t p = 32 * r + lane;
        if (p < reach) {
          sh.inc[p] = (x[r] & 1) ? (uint8_t)(code[r] >> 8) : 0;
          sh.tab[p] = (uint16_t)((x[r] & 1) | (code[r] & 255) << 1);
        }
      }
    }
    WARP_SYNC(lane);

    // the chain: type-A entry j starts at offset p = j + d, d the bits the
    // fires before it added; the next one, jn, at p + inc[p] + (jn - j)
    int32_t d = 0, my_d = 0;  // all the fires' bits; those before my entry
    if (n_var) {
      int32_t j = sh.va[0], p = j;
      for (int32_t i = 1;; ++i) {
        const int32_t jn = sh.va[i];  // off the chain: load it first
        const int32_t add = sh.inc[p];
        if (lane > j) my_d = p - j + add;
        if (i == n_var) {
          d = p - j + add;
          break;
        }
        p += add + (jn - j);
        j = jn;
      }
    }
    const int32_t used = n + d;  // the step's bits
    const int32_t at = st.cur + lane + my_d;  // my first bit
    const int32_t t = valid ? sh.tab[lane + my_d] : 0;
    const bool fired = t & 1, vf = fired && type_a && hc;
    const int32_t code = t >> 1;  // of a type-A fire
    const int32_t sig = vf ? code & 15 : 0, nsig = POPC(sig);
    const int32_t n_lis = !fired ? 0 : type_a ? (int32_t)hg : hc ? 4 : 0;
    // LSP commits | LIP appends << 8 | LIS appends << 16 | retained << 24
    const int32_t cnt = (vf ? nsig | (4 - nsig) << 8 : 0) | n_lis << 16 |
                        (int32_t)(valid && !fired) << 24;
    const int32_t incl = warp_scan(lane, cnt), pre = incl - cnt;
    const int32_t tot = WARP_SHFL(lane, incl, SPIHT_WARP - 1);
    const int32_t n_c = tot & 255, n_lip = (tot >> 8) & 255;
    const int32_t n_app = (tot >> 16) & 255;
    if (used > a.nbits - st.cur || st.lsp_n + n_c > a.lsp_cap ||
        st.lip_n + n_lip > a.lip_cap || st.lis_n + n_app > a.lis_cap)
      return dec_lis_serial<SEQ, LOG>(a, sh, k, m, mag, ev, st, lane);
    if (valid) {
      if (LOG) a.log[at] = lis_event<FILT>(e, ev);
      const int32_t c0 = g >> 2;
      // the filter of the children (B3-log)
      const int32_t cf = FILT && fired
          ? child_filt(lis_filt<FILT>(e), lis_node<FILT>(e), c0, a.w) : 0;
      if (!fired) {
        a.lis[st.keep + (pre >> 24)] = e;
      } else if (vf) {  // a type-A fire: its 4 offspring, then type B
        int32_t bit = at + 1, ci = st.lsp_n + (pre & 255);
        int32_t li = st.lip_n + ((pre >> 8) & 255);
        const uint64_t evc = ev | filt_event(cf);
        for (int q = 0; q < 4; ++q) {
          const int32_t ch = c0 + (q & 1) + (q >> 1) * a.w;
          const int32_t x = ch | ent_bits<FILT>(cf);
          if (LOG) a.log[bit] = event(ch, EV_OFF, evc);
          ++bit;
          if ((sig >> q) & 1) {
            if (LOG) a.log[bit] = event(ch, EV_OFF_SIGN, evc);
            ++bit;
            commit_at<SEQ>(a, ci++, x, (code >> (4 + q)) & 1, mag);
          } else {
            a.lip[li++] = x;
          }
        }
      }
      if (n_lis) {  // a type-A fire's re-append as type B, or a type-B
        const int32_t li = st.lis_n + ((pre >> 16) & 255);  // fire's children
        if (type_a) {
          a.lis[li] = e & ~1;
        } else {
          for (int q = 0; q < 4; ++q)
            a.lis[li + q] = ((c0 + (q & 1) + (q >> 1) * a.w) << 1) | 1 |
                            lis_bits<FILT>(cf);
        }
      }
    }
    st.cur += used;
    st.keep += tot >> 24;
    st.lsp_n += n_c;
    st.lip_n += n_lip;
    st.lis_n += n_app;
  }
  return true;
}

// B3's claims on a node: last[node] = tag << 32 | the LSP index of its
// latest commit (dec_commit_rec) or refined instance (dec_refine), the
// tag growing with each: commits of plane n, then its refinement.
SPIHT_HD uint64_t claim_tag(const DecArgs& a, int n, int refine) {
  return (uint64_t)(2 * (a.max_n - n) + 1 + refine) << 32;
}

// B3: rec from the commits at LSP indices [lo, hi) of plane n (node |
// sgn<<31), by every thread. Where one node was committed more than once
// (a node with two parents), the latest commit in queue order sets it, as
// in the plain version.
template <bool LOG>
SPIHT_HD void dec_commit_rec(const DecArgs& a, int32_t lo, int32_t hi, int n,
                             int tid, int nt) {
  const uint64_t tag = claim_tag(a, n, 0);
  for (int32_t i = lo + tid; i < hi; i += nt)
    claim(&a.last[lsp_node<true, LOG>(a.lsp[i])], tag | (uint32_t)i);
  SPIHT_SYNC();
  const int32_t mag = commit_mag(n);
  for (int32_t i = lo + tid; i < hi; i += nt) {
    const int32_t e = a.lsp[i], node = lsp_node<true, LOG>(e);
    if (a.last[node] == (tag | (uint32_t)i)) a.rec[node] = e < 0 ? mag : -mag;
  }
  SPIHT_SYNC();
}

// The log word of the refinement bit of LSP entry x at plane event ev.
template <bool SEQ, bool LOG>
SPIHT_HD uint64_t ref_event(int32_t x, uint64_t ev) {
  return event(lsp_node<SEQ, LOG>(x), EV_REF,
               ev | filt_event(ent_filt<SEQ && LOG>(x)));
}

// Refinement of snapshot entries [0, avail) of plane n, whose bits are
// stream bits cur .. cur+avail-1; run by every thread. With LOG, entry
// `avail` < snap, whose read found the stream empty, is logged at nbits.
template <bool SEQ, bool LOG>
SPIHT_HD void dec_refine(const DecArgs& a, int32_t avail, int32_t snap,
                         int32_t cur, int n, int tid, int nt) {
  const int32_t bit = 1 << n;
  if (LOG) {
    const uint64_t ev = plane_event(n);
    for (int32_t i = tid; i < avail; i += nt)
      a.log[cur + i] = ref_event<SEQ, LOG>(a.lsp[i], ev);
    if (tid == 0 && avail < snap)
      a.log[cur + avail] = ref_event<SEQ, LOG>(a.lsp[avail], ev);
  }
  if (!SEQ) {
    for (int32_t i = tid; i < avail; i += nt) {
      const int32_t v = a.lsp_val[i];
      a.lsp_val[i] = stream_bit(a.words, cur + i) ? (v | bit) : (v & ~bit);
    }
    return;
  }
  // Several instances of one node refine it in queue order. The last one
  // sets bit n, and the sign is lost where an earlier one cleared the only
  // bit left (0 has no sign): the claims say which is last, and whether
  // any instance cleared the bit.
  const uint64_t tag = claim_tag(a, n, 1);
  for (int32_t i = tid; i < avail; i += nt)
    claim(&a.last[lsp_node<SEQ, LOG>(a.lsp[i])], tag | (uint32_t)i);
  SPIHT_SYNC();
  for (int32_t i = tid; i < avail; i += nt)
    if (!stream_bit(a.words, cur + i))
      mark_cleared(&a.last[lsp_node<SEQ, LOG>(a.lsp[i])]);
  SPIHT_SYNC();
  for (int32_t i = tid; i < avail; i += nt) {
    const int32_t node = lsp_node<SEQ, LOG>(a.lsp[i]);
    const uint64_t last = a.last[node];
    if ((last & ~CLEARED) != (tag | (uint32_t)i)) continue;  // not the last
    const int32_t x = a.rec[node];
    const int32_t mag = x >= 0 ? x : -x;
    const bool set = stream_bit(a.words, cur + i);
    const bool neg = x < 0 && !(set && (last & CLEARED) && (mag & ~bit) == 0);
    const int32_t v = set ? (mag | bit) : (mag & ~bit);
    a.rec[node] = neg ? -v : v;
  }
}

// One machine for all the kernels, run by every thread of the block (tid in
// [0, nt)): SEQ selects where a commit and a refinement land (the LSP value
// queue for B2, the shared rec array for B3); LOG adds the event log (and,
// with SEQ, the filter in each queue entry).
// Every thread keeps `cur`, the bits consumed, from sh.cur after each
// chunk's barrier, so the whole block stages the next chunk's stream.
// Thread 0 publishes the LSP length with it (B3 sets rec from the commits
// after the passes, and where the machine stops).
template <bool SEQ, bool LOG>
SPIHT_HD void decode_machine(const DecArgs& a, DecShared& sh, int tid,
                             int nt) {
  DecState st{0, SPIHT_OK, a.n_lip0, a.n_lis0, 0, 0};
  const bool warp0 = tid < SPIHT_WARP;
  int32_t cur = 0, in_rec = 0;  // B3: the LSP entries rec holds
  int n = a.max_n;
  for (int32_t i = tid; i < 256; i += nt) sh.kids[i] = child_code(i);
  if (tid == 0) sh.pub = Published{st.lip_n, st.lis_n, 0, 0};
  SPIHT_SYNC();

  for (; n >= 0; --n) {
    const int32_t lip_len = sh.pub.lip_n, lsp_snap = sh.pub.lsp_n;
    const int32_t mag = commit_mag(n);
    const uint64_t ev = plane_event(n);

    // ---- LIP pass ----
    st.keep = 0;
    for (int32_t r0 = 0; r0 < lip_len; r0 += SPIHT_CHUNK) {
      const int32_t m = min32(SPIHT_CHUNK, lip_len - r0);
      for (int32_t i = tid; i < m; i += nt) sh.e[i] = a.lip[r0 + i];
      stage_stream(a, sh, cur, 2 * m, tid, nt);
      SPIHT_SYNC();
      if (warp0) {
        st.cur = cur;
        const bool ok = dec_lip_chunk<SEQ, LOG>(a, sh, m, mag, ev, st, tid);
        if (tid == 0) {
          if (!ok) sh.pub.stop = 1;
          sh.pub.lsp_n = st.lsp_n;
          sh.cur = st.cur;
        }
      }
      SPIHT_SYNC();
      cur = sh.cur;
      if (sh.pub.stop) goto out;
    }
    st.lip_n = st.keep;

    // ---- LIS pass (worklist: entries appended now are visited now) ----
    st.keep = 0;
    for (int32_t r0 = 0;;) {
      const int32_t lis_len = sh.pub.lis_n;
      if (r0 >= lis_len) break;
      const int32_t m = min32(SPIHT_CHUNK, lis_len - r0);
      for (int32_t i = tid; i < m; i += nt) {
        const int32_t e = a.lis[r0 + i];
        sh.e[i] = e;
        sh.g[i] = a.geo[lis_node<SEQ && LOG>(e)];
      }
      stage_stream(a, sh, cur, 9 * m, tid, nt);
      SPIHT_SYNC();
      if (warp0) {
        st.cur = cur;
        const bool ok = dec_lis_chunk<SEQ, LOG>(a, sh, m, mag, ev, st, tid);
        if (tid == 0) {
          if (!ok) sh.pub.stop = 1;
          sh.pub.lis_n = st.lis_n;
          sh.pub.lsp_n = st.lsp_n;
          sh.cur = st.cur;
        }
      }
      SPIHT_SYNC();
      cur = sh.cur;
      if (sh.pub.stop) goto out;
      r0 += m;
    }
    SPIHT_SYNC();  // every thread has read pub.lis_n for the last time
    st.lis_n = st.keep;
    if (tid == 0) sh.pub.lis_n = st.lis_n;
    if (SEQ) {
      dec_commit_rec<LOG>(a, in_rec, sh.pub.lsp_n, n, tid, nt);
      in_rec = sh.pub.lsp_n;
    }

    // ---- refinement of the entries significant before this plane ----
    {
      const int32_t avail = min32(lsp_snap, a.nbits - cur);
      dec_refine<SEQ, LOG>(a, avail, lsp_snap, cur, n, tid, nt);
      cur += avail;
      if (tid == 0) {
        st.cur = cur;
        if (avail < lsp_snap) sh.pub.stop = 1;  // the stream ended inside
        sh.pub.lip_n = st.lip_n;
        sh.pub.lsp_n = st.lsp_n;
      }
    }
    SPIHT_SYNC();
    if (sh.pub.stop) goto out;
  }

out:
  if (SEQ) dec_commit_rec<LOG>(a, in_rec, sh.pub.lsp_n, n, tid, nt);
  if (tid != 0) return;
  a.stat[0] = st.lsp_n;
  a.stat[1] = st.err;
  a.stat[2] = st.lip_n;
  a.stat[3] = st.lis_n;
  a.stat[4] = st.lsp_n;
  a.stat[5] = st.cur;
}

// Load the initial queues (B3: zero rec and the claims), by every thread
// of the block; a barrier must follow before the machine starts.
template <bool SEQ>
SPIHT_HD void dec_prologue(const DecArgs& a, const int32_t* lip0,
                           const int32_t* lis0, int32_t n_rec, int tid,
                           int nt) {
  for (int32_t i = tid; i < a.n_lip0; i += nt) a.lip[i] = lip0[i];
  for (int32_t i = tid; i < a.n_lis0; i += nt) a.lis[i] = lis0[i];
  if (SEQ) {
    for (int32_t i = tid; i < n_rec; i += nt) {
      a.rec[i] = 0;
      a.last[i] = 0;
    }
  }
}

// ---- kernel B5 and batched B3: B streams in one launch ----
//
// B5 replaces spiht_tpu/codec/pallas_decoder.py:_interleaved_fn, which
// stepped B chains of the B2 machine in lockstep on one TPU core. Odd-LL
// batches, which that kernel refuses, went through a lax.map of
// pallas_decoder.py:_seq_fn one stream after another; the batched B3
// launch runs them all at once. Each block is one stream: block b builds
// stream b's DecArgs (dec_stream_args) and runs decode_machine<SEQ, false>, so
// every stream decodes exactly as B2 or B3 decodes it alone. Each stream
// stops at its own nbits: the word rows are zero-padded to the longest
// stream, and nothing past a stream's length is read.
//
// What bounds them on an H100: per stream the same dependent chain of bit
// decisions as B2/B3; across streams, how many blocks the SMs hold at once
// (48 registers a thread and 6.8 KB of DecShared a block: five 256-thread
// blocks an SM, ~660 streams in one wave). The design spreads the streams
// over the SMs and shares the geometry tables through L2.
struct DecBatch {
  const uint32_t* words;  // (B, cap_words), zero-padded rows
  int32_t cap_words;
  const int32_t* nbits;   // (B) each stream's length in bits
  const int32_t* max_n;   // (B)
  const int32_t* geo;     // (n_cells), shared by every stream
  const int32_t* lip0;    // shared initial queues
  int32_t n_lip0;
  const int32_t* lis0;
  int32_t n_lis0;
  int32_t n_cells;
  int32_t w;
  int32_t* lip;           // (B, queue_stride(lip_cap))
  int32_t lip_cap;
  int32_t* lis;           // (B, queue_stride(lis_cap))
  int32_t lis_cap;
  int32_t* lsp;           // (B, queue_stride(lsp_cap))
  int32_t lsp_cap;
  int32_t* lsp_val;       // B5: (B, queue_stride(lsp_cap)); B3: null
  int32_t* rec;           // B3: (B, n_cells); B5: null
  uint64_t* last;         // B3: (B, n_cells); B5: null
  int32_t* stat;          // (B, SPIHT_STAT_LEN)
};

// Stream b's arguments. Offsets are 64-bit (B * n_cells passes 2^31 at
// large batches); nbits is held to [0, the row's bits], so a stream never
// reads past its own row.
SPIHT_HD DecArgs dec_stream_args(const DecBatch& g, int32_t b) {
  const int64_t cells = (int64_t)b * g.n_cells;
  const int64_t lsp_row = b * queue_stride(g.lsp_cap);
  const int64_t cap_bits = (int64_t)g.cap_words * 32, nb = g.nbits[b];
  return DecArgs{
      g.words + (int64_t)b * g.cap_words,
      (int32_t)(nb < 0 ? 0 : nb < cap_bits ? nb : cap_bits),
      g.max_n[b], g.geo, g.n_lip0, g.n_lis0, g.w,
      g.lip + b * queue_stride(g.lip_cap), g.lip_cap,
      g.lis + b * queue_stride(g.lis_cap), g.lis_cap,
      g.lsp + lsp_row, g.lsp_cap,
      g.lsp_val ? g.lsp_val + lsp_row : nullptr,
      g.rec ? g.rec + cells : nullptr,
      g.last ? g.last + cells : nullptr,
      g.stat + (int64_t)b * SPIHT_STAT_LEN, nullptr};
}

// Stream b's whole block: prologue, barrier, machine (run by the kernel
// with b = blockIdx.x, and by the host build once per stream).
template <bool SEQ>
SPIHT_HD void decode_stream(const DecBatch& g, int32_t b, DecShared& sh,
                            int tid, int nt) {
  const DecArgs a = dec_stream_args(g, b);
  dec_prologue<SEQ>(a, g.lip0, g.lis0, g.n_cells, tid, nt);
  SPIHT_SYNC();
  decode_machine<SEQ, false>(a, sh, tid, nt);
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

// The per-call scalars (the stream's length in bits and max_n) come from
// device memory, read once at the start into the DecArgs fields the machine
// takes by value, as the batched kernels read theirs: a replayed CUDA graph
// can take new values where a by-value argument is frozen at capture. The
// caller holds nbits to the word buffer.
template <bool SEQ, bool LOG>
__global__ void __launch_bounds__(SPIHT_THREADS)
spiht_decode_kernel(DecArgs a, const int32_t* __restrict__ nbits,
                    const int32_t* __restrict__ max_n,
                    const int32_t* __restrict__ lip0,
                    const int32_t* __restrict__ lis0, int32_t n_rec) {
  __shared__ DecShared sh;
  a.nbits = *nbits;
  a.max_n = *max_n;
  dec_prologue<SEQ>(a, lip0, lis0, n_rec, threadIdx.x, blockDim.x);
  __syncthreads();
  decode_machine<SEQ, LOG>(a, sh, threadIdx.x, blockDim.x);
}

template <bool SEQ>
__global__ void __launch_bounds__(SPIHT_THREADS)
spiht_decode_batch_kernel(DecBatch g) {
  __shared__ DecShared sh;
  decode_stream<SEQ>(g, blockIdx.x, sh, threadIdx.x, blockDim.x);
}

extern "C" int spiht_decode_lsp_launch(
    const uint32_t* words, const int32_t* nbits, const int32_t* max_n,
    const int32_t* geo,
    const int32_t* lip0, int32_t n_lip0, const int32_t* lis0, int32_t n_lis0,
    int32_t w, int32_t* lip, int32_t lip_cap, int32_t* lis, int32_t lis_cap,
    int32_t* lsp, int32_t* lsp_val, int32_t lsp_cap, int32_t* stat,
    void* stream) {
  DecArgs a{words, 0, 0, geo, n_lip0, n_lis0, w, lip, lip_cap,
            lis, lis_cap, lsp, lsp_cap, lsp_val, nullptr, nullptr, stat,
            nullptr};
  spiht_decode_kernel<false, false>
      <<<1, SPIHT_THREADS, 0, (cudaStream_t)stream>>>(a, nbits, max_n, lip0,
                                                      lis0, 0);
  return (int)cudaGetLastError();
}

// B2 with the event log: `log` holds nbits + 1 zeroed words.
extern "C" int spiht_decode_lsp_log_launch(
    const uint32_t* words, const int32_t* nbits, const int32_t* max_n,
    const int32_t* geo,
    const int32_t* lip0, int32_t n_lip0, const int32_t* lis0, int32_t n_lis0,
    int32_t w, int32_t* lip, int32_t lip_cap, int32_t* lis, int32_t lis_cap,
    int32_t* lsp, int32_t* lsp_val, int32_t lsp_cap, int32_t* stat,
    uint64_t* log, void* stream) {
  DecArgs a{words, 0, 0, geo, n_lip0, n_lis0, w, lip, lip_cap,
            lis, lis_cap, lsp, lsp_cap, lsp_val, nullptr, nullptr, stat, log};
  spiht_decode_kernel<false, true>
      <<<1, SPIHT_THREADS, 0, (cudaStream_t)stream>>>(a, nbits, max_n, lip0,
                                                      lis0, 0);
  return (int)cudaGetLastError();
}

extern "C" int spiht_decode_seq_launch(
    const uint32_t* words, const int32_t* nbits, const int32_t* max_n,
    const int32_t* geo,
    const int32_t* lip0, int32_t n_lip0, const int32_t* lis0, int32_t n_lis0,
    int32_t w, int32_t* lip, int32_t lip_cap, int32_t* lis, int32_t lis_cap,
    int32_t* lsp, int32_t lsp_cap, int32_t* rec, uint64_t* last,
    int32_t n_rec, int32_t* stat, void* stream) {
  DecArgs a{words, 0, 0, geo, n_lip0, n_lis0, w, lip, lip_cap,
            lis, lis_cap, lsp, lsp_cap, nullptr, rec, last, stat, nullptr};
  spiht_decode_kernel<true, false>
      <<<1, SPIHT_THREADS, 0, (cudaStream_t)stream>>>(a, nbits, max_n, lip0,
                                                      lis0, n_rec);
  return (int)cudaGetLastError();
}

// B3 with the event log (B3-log): `log` holds nbits + 1 zeroed words.
extern "C" int spiht_decode_seq_log_launch(
    const uint32_t* words, const int32_t* nbits, const int32_t* max_n,
    const int32_t* geo,
    const int32_t* lip0, int32_t n_lip0, const int32_t* lis0, int32_t n_lis0,
    int32_t w, int32_t* lip, int32_t lip_cap, int32_t* lis, int32_t lis_cap,
    int32_t* lsp, int32_t lsp_cap, int32_t* rec, uint64_t* last,
    int32_t n_rec, int32_t* stat, uint64_t* log, void* stream) {
  DecArgs a{words, 0, 0, geo, n_lip0, n_lis0, w, lip, lip_cap,
            lis, lis_cap, lsp, lsp_cap, nullptr, rec, last, stat, log};
  spiht_decode_kernel<true, true>
      <<<1, SPIHT_THREADS, 0, (cudaStream_t)stream>>>(a, nbits, max_n, lip0,
                                                      lis0, n_rec);
  return (int)cudaGetLastError();
}

// B5 (seq = 0: lsp_val set, rec and last null) or batched B3 (seq = 1:
// rec and last set, lsp_val null), one block per stream.
extern "C" int spiht_decode_batch_launch(
    int32_t seq, int32_t n_streams, const uint32_t* words, int32_t cap_words,
    const int32_t* nbits, const int32_t* max_n, const int32_t* geo,
    const int32_t* lip0, int32_t n_lip0, const int32_t* lis0, int32_t n_lis0,
    int32_t n_cells, int32_t w, int32_t* lip, int32_t lip_cap, int32_t* lis,
    int32_t lis_cap, int32_t* lsp, int32_t lsp_cap, int32_t* lsp_val,
    int32_t* rec, uint64_t* last, int32_t* stat, void* stream) {
  DecBatch g{words, cap_words, nbits, max_n, geo, lip0, n_lip0, lis0,
             n_lis0, n_cells, w, lip, lip_cap, lis, lis_cap, lsp, lsp_cap,
             lsp_val, rec, last, stat};
  if (seq) {
    spiht_decode_batch_kernel<true><<<n_streams, SPIHT_THREADS, 0,
                                      (cudaStream_t)stream>>>(g);
  } else {
    spiht_decode_batch_kernel<false><<<n_streams, SPIHT_THREADS, 0,
                                       (cudaStream_t)stream>>>(g);
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
