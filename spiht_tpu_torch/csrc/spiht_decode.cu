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
//
// Both honour byte-prefix truncation exactly: the machine stops at the
// first bit it cannot read, and a symbol cut short has no effect (a
// significance bit whose sign bit is missing commits nothing).
//
// State layout (identical in the plain versions, codec/decoder.py):
//   geo[N] = child0<<2 | has_child<<1 | has_grandchildren
//   lip[] holds node indices, lis[] node<<1 | type_A; in-place FIFOs as in
//   the encoder. The commit magnitude is 1.5 * 2^n; refinement sets or
//   clears bit n of the magnitude and keeps the sign.
//
// The event log (LOG = true, B2 only): one int32 word per attempted bit at
// that bit's stream offset, node | action << 24 | (n+1) << 27, with the
// reference's action ids (EV_* below). The reference trace writes its row
// before each read, so the read that finds the stream empty gets a row too,
// at offset nbits, and nothing follows it: the log holds nbits + 1 words,
// zeroed by the caller (an unwritten word is 0; a written one is not, as
// n+1 >= 1). The log keeps B2's structure: a zero run's entries are logged
// across the lanes, the 8 bits after a type-A fire by lanes 0-3, and the
// refinement by the whole block, each word at the offset of its bit.
//
// What bounds them on an H100: neither bytes nor arithmetic but the chain
// of bit decisions in the LIP and LIS passes (each bit's meaning depends on
// every earlier one), paid in one thread's instruction latency and
// branches (the kernels' times are over a thousand times their byte
// bounds; PERF.md, chip_smoke.py). The design shortens the chain. The
// block gathers each chunk's queue entries and their geometry words into
// shared memory; warp
// 0 then walks the chunk, all lanes computing the same state, and skips a
// run of zero bits (insignificant LIP entries, unfired LIS entries: one
// zero bit each) with one look at a 32-bit stream window, copying the
// retained run across the lanes. Only significant and fired entries take
// the bit-by-bit path. Refinement has no chain at all: entry i of the
// snapshot reads stream bit cur+i, so the whole block refines in parallel.
// In B3 several LSP instances of one node refine the same value and the
// last one in queue order sets the bit, so each instance first claims its
// node with an atomic max of (plane tag, index) and only the winner writes.

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
  int32_t* __restrict__ log;       // LOG: (nbits + 1) event words, zeroed
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

// The plane field of an event word at plane n (n <= 30).
SPIHT_HD int32_t plane_event(int n) { return (int32_t)((uint32_t)(n + 1) << 27); }

// The log word of an event; ev = plane_event(n).
SPIHT_HD int32_t event(int32_t node, int32_t action, int32_t ev) {
  return node | (action << 24) | ev;
}

// The log word of a LIS entry's first bit (by its type).
SPIHT_HD int32_t lis_event(int32_t e, int32_t ev) {
  return event(e >> 1, (e & 1) ? EV_DESC : EV_LSIG, ev);
}

struct DecShared {
  int32_t e[SPIHT_CHUNK];  // the queue entry
  int32_t g[SPIHT_CHUNK];  // geo of its node (LIS)
  int32_t kids[256];       // child_code of every 8-bit stream window
  Published pub;
  int32_t cur;             // bits consumed, published for refinement
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
  int32_t cur;    // bits consumed
  uint64_t win;   // stream bits cur .. cur+have-1, LSB first
  int32_t have;
  int32_t err;
  int32_t lip_n, lis_n, lsp_n;
  int32_t keep;  // retain cursor of the pass in progress
  int32_t off[4];
};

// Top the window up to at least 32 bits (fewer only at the stream's end).
SPIHT_HD void refill(const DecArgs& a, DecState& st) {
  const int32_t at = st.cur + st.have;
  if (st.have < 32 && at < a.nbits) {
    st.win |= (uint64_t)stream_window(a.words, at, a.nbits) << st.have;
    st.have += min32(32, a.nbits - at);
  }
}

// Next bit (0/1), or -1 once the stream is exhausted.
SPIHT_HD int next_bit(const DecArgs& a, DecState& st) {
  if (st.have == 0) refill(a, st);
  if (st.have == 0) return -1;
  const int b = (int)(st.win & 1);
  st.win >>= 1;
  --st.have;
  ++st.cur;
  return b;
}

// Consume `n` bits known to be in the window.
SPIHT_HD void skip_bits(DecState& st, int32_t n) {
  st.win = n < 64 ? st.win >> n : 0;
  st.have -= n;
  st.cur += n;
}

// Jump the cursor to `cur` (after the block consumed bits in parallel).
SPIHT_HD void seek(DecState& st, int32_t cur) {
  st.cur = cur;
  st.win = 0;
  st.have = 0;
}

#ifdef __CUDACC__
__device__ __forceinline__ void claim(uint64_t* p, uint64_t v) {
  atomicMax((unsigned long long*)p, (unsigned long long)v);
}
#else
inline void claim(uint64_t* p, uint64_t v) {
  uint64_t old = __atomic_load_n(p, __ATOMIC_RELAXED);
  while (old < v && !__atomic_compare_exchange_n(
                        p, &old, v, true, __ATOMIC_RELAXED, __ATOMIC_RELAXED)) {
  }
}
#endif

// The LIP and LIS passes run in warp 0, every lane computing the same state
// from the same data (so every branch is uniform); single stores are lane
// 0's, and a run of retained entries is copied across the lanes. Each chunk
// function returns false when the machine stops (stream exhausted, or a
// queue would overflow: st.err says which).

// Commit node as significant with sign bit s at plane magnitude mag.
template <bool SEQ>
SPIHT_HD bool commit(const DecArgs& a, DecState& st, int32_t node, int s,
                     int32_t mag, int lane) {
  if (st.lsp_n >= a.lsp_cap) { st.err = SPIHT_ERR_LSP_CAP; return false; }
  if (lane == 0) {
    if (SEQ) {
      a.rec[node] = s ? mag : -mag;
    } else {
      a.lsp_val[st.lsp_n] = (int32_t)((uint32_t)s << 31) | mag;
    }
    a.lsp[st.lsp_n] = node;
  }
  ++st.lsp_n;
  return true;
}

// Commit node at LSP index `at` (the caller has checked the capacity).
template <bool SEQ>
SPIHT_HD void commit_at(const DecArgs& a, int32_t at, int32_t node, int s,
                        int32_t mag) {
  if (SEQ) {
    a.rec[node] = s ? mag : -mag;
  } else {
    a.lsp_val[at] = (int32_t)((uint32_t)s << 31) | mag;
  }
  a.lsp[at] = node;
}

// Zero bits at the front of the window (an insignificant LIP entry or an
// unfired LIS entry reads one zero bit; a run of them is skipped at once).
// 0 means the next bit is a 1, or the stream has ended (have == 0).
SPIHT_HD int32_t zero_run(const DecArgs& a, DecState& st) {
  refill(a, st);
  if (st.win == 0) return st.have;
  const uint32_t lo = (uint32_t)st.win;
  const int32_t z = lo ? CTZ(lo) : 32 + CTZ((uint32_t)(st.win >> 32));
  return min32(z, st.have);
}

// Retain entries sh.e[k .. k+run) into q[keep ..], across the lanes.
SPIHT_HD void retain_run(int32_t* q, int32_t keep, const int32_t* e,
                         int32_t run, int lane) {
  for (int32_t j = lane; j < run; j += SPIHT_WARP) q[keep + j] = e[j];
}

template <bool SEQ, bool LOG>
SPIHT_HD bool dec_lip_chunk(const DecArgs& a, const DecShared& sh, int32_t m,
                            int32_t mag, int32_t ev, DecState& st, int lane) {
  for (int32_t k = 0; k < m;) {
    const int32_t run = min32(zero_run(a, st), m - k);
    if (run > 0) {  // insignificant entries: retained
      if (LOG) {
        for (int32_t j = lane; j < run; j += SPIHT_WARP)
          a.log[st.cur + j] = event(sh.e[k + j], EV_LIP, ev);
      }
      retain_run(a.lip, st.keep, sh.e + k, run, lane);
      st.keep += run;
      skip_bits(st, run);
      k += run;
      continue;
    }
    if (LOG && lane == 0) {  // entry k's significance bit and its sign bit
      // (the first attempt past the stream's end is logged, at nbits)
      a.log[st.cur] = event(sh.e[k], EV_LIP, ev);
      if (st.have >= 1) a.log[st.cur + 1] = event(sh.e[k], EV_LIP_SIGN, ev);
    }
    if (st.have < 2) {  // the sign bit is missing: nothing is committed
      next_bit(a, st);
      return false;
    }
    const int s = (int)(st.win >> 1) & 1;  // entry k is significant
    skip_bits(st, 2);
    if (!commit<SEQ>(a, st, sh.e[k], s, mag, lane)) return false;
    ++k;
  }
  return true;
}

template <bool SEQ, bool LOG>
SPIHT_HD bool dec_lis_chunk(const DecArgs& a, const DecShared& sh, int32_t m,
                            int32_t mag, int32_t ev, DecState& st, int lane) {
  for (int32_t k = 0; k < m;) {
    const int32_t run = min32(zero_run(a, st), m - k);
    if (run > 0) {  // unfired entries: retained
      if (LOG) {
        for (int32_t j = lane; j < run; j += SPIHT_WARP)
          a.log[st.cur + j] = lis_event(sh.e[k + j], ev);
      }
      retain_run(a.lis, st.keep, sh.e + k, run, lane);
      st.keep += run;
      skip_bits(st, run);
      k += run;
      continue;
    }
    const int32_t e = sh.e[k], g = sh.g[k];
    if (LOG && lane == 0) a.log[st.cur] = lis_event(e, ev);
    if (next_bit(a, st) < 0) return false;  // else entry k fired
    ++k;
    if (e & 1) {  // type A: code the 4 offspring
      if ((g >> 1) & 1) {
        const int32_t c0 = g >> 2;
        refill(a, st);
        const int32_t code = sh.kids[st.win & 255];
        const int32_t sig = code & 15, nsig = POPC(sig);
        if (st.have >= 8 && st.lsp_n + nsig <= a.lsp_cap &&
            st.lip_n + 4 - nsig <= a.lip_cap) {
          // all 4 children at once, lane q placing child q
          if (lane < 4) {
            const int32_t ch = c0 + (lane & 1) + (lane >> 1) * a.w;
            const int32_t below = (1 << lane) - 1;
            if (LOG) {  // child q's bits start after those of children < q
              const int32_t at = st.cur + lane + POPC(sig & below);
              a.log[at] = event(ch, EV_OFF, ev);
              if ((sig >> lane) & 1) a.log[at + 1] = event(ch, EV_OFF_SIGN, ev);
            }
            if ((sig >> lane) & 1) {
              commit_at<SEQ>(a, st.lsp_n + POPC(sig & below), ch,
                             (code >> (4 + lane)) & 1, mag);
            } else {
              a.lip[st.lip_n + POPC(~sig & below)] = ch;
            }
          }
          st.lsp_n += nsig;
          st.lip_n += 4 - nsig;
          skip_bits(st, code >> 8);
        } else {  // bit by bit: near the stream's end, or a queue is full
          for (int q = 0; q < 4; ++q) {
            const int32_t ch = c0 + st.off[q];
            if (LOG && lane == 0) a.log[st.cur] = event(ch, EV_OFF, ev);
            const int b = next_bit(a, st);
            if (b < 0) return false;
            if (b) {
              if (LOG && lane == 0) a.log[st.cur] = event(ch, EV_OFF_SIGN, ev);
              const int s = next_bit(a, st);
              if (s < 0 || !commit<SEQ>(a, st, ch, s, mag, lane)) return false;
            } else {
              if (st.lip_n >= a.lip_cap) { st.err = SPIHT_ERR_LIP_CAP; return false; }
              if (lane == 0) a.lip[st.lip_n] = ch;
              ++st.lip_n;
            }
          }
        }
      }
      if (g & 1) {  // has grandchildren: re-append as type B
        if (st.lis_n >= a.lis_cap) { st.err = SPIHT_ERR_LIS_CAP; return false; }
        if (lane == 0) a.lis[st.lis_n] = e & ~1;
        ++st.lis_n;
      }
    } else if ((g >> 1) & 1) {  // type B: 4 type-A children
      const int32_t c0 = g >> 2;
      if (st.lis_n + 4 > a.lis_cap) { st.err = SPIHT_ERR_LIS_CAP; return false; }
      if (lane < 4) {
        a.lis[st.lis_n + lane] = ((c0 + (lane & 1) + (lane >> 1) * a.w) << 1) | 1;
      }
      st.lis_n += 4;
    }
  }
  return true;
}

// Refinement of snapshot entries [0, avail) of plane n, whose bits are
// stream bits cur .. cur+avail-1; run by every thread. With LOG, entry
// `avail` < snap, whose read found the stream empty, is logged at nbits.
template <bool SEQ, bool LOG>
SPIHT_HD void dec_refine(const DecArgs& a, int32_t avail, int32_t snap,
                         int32_t cur, int n, int tid, int nt) {
  const int32_t bit = 1 << n;
  if (LOG) {
    const int32_t ev = plane_event(n);
    for (int32_t i = tid; i < avail; i += nt)
      a.log[cur + i] = event(a.lsp[i], EV_REF, ev);
    if (tid == 0 && avail < snap) a.log[cur + avail] = event(a.lsp[avail], EV_REF, ev);
  }
  if (!SEQ) {
    for (int32_t i = tid; i < avail; i += nt) {
      const int32_t v = a.lsp_val[i];
      a.lsp_val[i] = stream_bit(a.words, cur + i) ? (v | bit) : (v & ~bit);
    }
    return;
  }
  const uint64_t tag = (uint64_t)(a.max_n - n + 1) << 32;  // grows per plane
  for (int32_t i = tid; i < avail; i += nt) claim(&a.last[a.lsp[i]], tag | (uint32_t)i);
  SPIHT_SYNC();
  for (int32_t i = tid; i < avail; i += nt) {
    const int32_t node = a.lsp[i];
    if (a.last[node] != (tag | (uint32_t)i)) continue;  // a later instance sets it
    const int32_t x = a.rec[node];
    int32_t mag = x >= 0 ? x : -x;
    mag = stream_bit(a.words, cur + i) ? (mag | bit) : (mag & ~bit);
    a.rec[node] = x >= 0 ? mag : -mag;
  }
}

// One machine for both kernels, run by every thread of the block (tid in
// [0, nt)): SEQ selects where a commit and a refinement land (the LSP value
// queue for B2, the shared rec array for B3); LOG adds the event log.
template <bool SEQ, bool LOG>
SPIHT_HD void decode_machine(const DecArgs& a, DecShared& sh, int tid,
                             int nt) {
  DecState st{0, 0, 0, SPIHT_OK, a.n_lip0, a.n_lis0, 0, 0,
              {0, 1, a.w, a.w + 1}};
  const bool warp0 = tid < SPIHT_WARP;
  for (int32_t i = tid; i < 256; i += nt) sh.kids[i] = child_code(i);
  if (tid == 0) sh.pub = Published{st.lip_n, st.lis_n, 0, 0};
  SPIHT_SYNC();

  for (int n = a.max_n; n >= 0; --n) {
    const int32_t lip_len = sh.pub.lip_n, lsp_snap = sh.pub.lsp_n;
    const int32_t mag = commit_mag(n), ev = plane_event(n);

    // ---- LIP pass ----
    st.keep = 0;
    for (int32_t r0 = 0; r0 < lip_len; r0 += SPIHT_CHUNK) {
      const int32_t m = min32(SPIHT_CHUNK, lip_len - r0);
      for (int32_t i = tid; i < m; i += nt) sh.e[i] = a.lip[r0 + i];
      SPIHT_SYNC();
      if (warp0 && !dec_lip_chunk<SEQ, LOG>(a, sh, m, mag, ev, st, tid) &&
          tid == 0)
        sh.pub.stop = 1;
      SPIHT_SYNC();
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
        sh.g[i] = a.geo[e >> 1];
      }
      SPIHT_SYNC();
      if (warp0) {
        const bool ok = dec_lis_chunk<SEQ, LOG>(a, sh, m, mag, ev, st, tid);
        if (tid == 0) {
          if (!ok) sh.pub.stop = 1;
          sh.pub.lis_n = st.lis_n;
        }
      }
      SPIHT_SYNC();
      if (sh.pub.stop) goto out;
      r0 += m;
    }
    SPIHT_SYNC();  // every thread has read pub.lis_n for the last time
    st.lis_n = st.keep;
    if (tid == 0) {
      sh.pub.lis_n = st.lis_n;
      sh.cur = st.cur;
    }
    SPIHT_SYNC();

    // ---- refinement of the entries significant before this plane ----
    {
      const int32_t cur = sh.cur;
      const int32_t avail = min32(lsp_snap, a.nbits - cur);
      dec_refine<SEQ, LOG>(a, avail, lsp_snap, cur, n, tid, nt);
      seek(st, cur + avail);
      if (tid == 0) {
        if (avail < lsp_snap) sh.pub.stop = 1;  // the stream ended inside
        sh.pub.lip_n = st.lip_n;
        sh.pub.lsp_n = st.lsp_n;
      }
    }
    SPIHT_SYNC();
    if (sh.pub.stop) goto out;
  }

out:
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
// (DecShared is about 5 KB, so the 256-thread block size, eight blocks an
// SM, is the limit: up to ~1000 streams in one wave). The design spreads
// the streams over the SMs and shares the geometry tables through L2.
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

template <bool SEQ, bool LOG>
__global__ void __launch_bounds__(SPIHT_THREADS)
spiht_decode_kernel(DecArgs a, const int32_t* __restrict__ lip0,
                    const int32_t* __restrict__ lis0, int32_t n_rec) {
  __shared__ DecShared sh;
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
    const uint32_t* words, int32_t nbits, int32_t max_n, const int32_t* geo,
    const int32_t* lip0, int32_t n_lip0, const int32_t* lis0, int32_t n_lis0,
    int32_t w, int32_t* lip, int32_t lip_cap, int32_t* lis, int32_t lis_cap,
    int32_t* lsp, int32_t* lsp_val, int32_t lsp_cap, int32_t* stat,
    void* stream) {
  DecArgs a{words, nbits, max_n, geo, n_lip0, n_lis0, w, lip, lip_cap,
            lis, lis_cap, lsp, lsp_cap, lsp_val, nullptr, nullptr, stat,
            nullptr};
  spiht_decode_kernel<false, false>
      <<<1, SPIHT_THREADS, 0, (cudaStream_t)stream>>>(a, lip0, lis0, 0);
  return (int)cudaGetLastError();
}

// B2 with the event log: `log` holds nbits + 1 zeroed words.
extern "C" int spiht_decode_lsp_log_launch(
    const uint32_t* words, int32_t nbits, int32_t max_n, const int32_t* geo,
    const int32_t* lip0, int32_t n_lip0, const int32_t* lis0, int32_t n_lis0,
    int32_t w, int32_t* lip, int32_t lip_cap, int32_t* lis, int32_t lis_cap,
    int32_t* lsp, int32_t* lsp_val, int32_t lsp_cap, int32_t* stat,
    int32_t* log, void* stream) {
  DecArgs a{words, nbits, max_n, geo, n_lip0, n_lis0, w, lip, lip_cap,
            lis, lis_cap, lsp, lsp_cap, lsp_val, nullptr, nullptr, stat, log};
  spiht_decode_kernel<false, true>
      <<<1, SPIHT_THREADS, 0, (cudaStream_t)stream>>>(a, lip0, lis0, 0);
  return (int)cudaGetLastError();
}

extern "C" int spiht_decode_seq_launch(
    const uint32_t* words, int32_t nbits, int32_t max_n, const int32_t* geo,
    const int32_t* lip0, int32_t n_lip0, const int32_t* lis0, int32_t n_lis0,
    int32_t w, int32_t* lip, int32_t lip_cap, int32_t* lis, int32_t lis_cap,
    int32_t* lsp, int32_t lsp_cap, int32_t* rec, uint64_t* last,
    int32_t n_rec, int32_t* stat, void* stream) {
  DecArgs a{words, nbits, max_n, geo, n_lip0, n_lis0, w, lip, lip_cap,
            lis, lis_cap, lsp, lsp_cap, nullptr, rec, last, stat, nullptr};
  spiht_decode_kernel<true, false>
      <<<1, SPIHT_THREADS, 0, (cudaStream_t)stream>>>(a, lip0, lis0, n_rec);
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
