// SPIHT encode machine (kernel B1; kernel B4 at the end runs it over a batch;
// kernel B7, the sequential machine, after it).
//
// B1 replaces spiht_tpu/codec/pallas_encoder.py:_hybrid_fn (all three of its
// layouts: standard, compact, compact_hbm, which were VMEM economies; one
// kernel computes their common function here).
//
// Function: runs bit planes max_n -> 0. Each plane is a LIP pass, the LIS
// worklist (same-pass appends, 4-child cascade, type A -> B re-append when
// the node has grandchildren) and refinement of the LSP entries that existed
// before the plane (the lsp_len snapshot). It stops exactly, mid-symbol if
// need be, at max_bits. Bits are written LSB-first into u32 words. Only the
// words and stat are the function's outputs: the queues are scratch.
//
// Tables (codec/encoder.py encode_tables; B7 and the plain version read the
// same ones):
//   t1[N]     = (M+1) | (D+1)<<6 | (G+1)<<12 | sgn<<18 | hc<<19 | hg<<20
//   t3s[N]    = sgn<<31 | |x|          (sgn = x >= 0)
// |x| is the native scheduler's uint32 magnitude: a coefficient of -2^31
// has M = 31 (so six bits a field) and the t3s word 0, sign 0 and low bits
// 0, which no other coefficient gives (0 has sign 1): its bit 31 of
// magnitude is read from that word (sig_at).
//   child0[N] = flat index of the first child (children at +0, +1, +w, +w+1)
// B1's queues carry payloads, as the TPU kernel's did (the plain version and
// B7 keep lists of node indices instead):
//   LIP, LSP: the node's t3s word. M = floor(log2 |x|), so M >= n iff
//     |x| >> n != 0: a LIP test, its sign and a refinement bit read nothing
//     but the entry.
//   LIS: two words (LisEntry), child0<<1 | type_A and the node's t1. The t1
//     word decides the entry; only a fire reads further: its 4 children's
//     t3s after a type-A fire (their bits, and the LSP/LIP words it
//     appends), their t1 and the first child's child0 after a type-B fire
//     (the LIS entries it appends). Children lie outside the LL band, where
//     a node's child0 is 2 * node - its channel's base, so child q's child0
//     is the first child's + 2 * off[q] (where it has children: a fired
//     type-B node's first child always has). The node index itself is
//     never needed.
//   LIP and LIS are in-place FIFOs: within a pass the retain cursor trails
//   the read cursor, and same-pass appends land at the live tail.
//
// What bounds it on an H100: neither bytes nor arithmetic but the chain of
// decisions, if it is run one entry at a time: one thread's dependent
// loads, ALU latency and branches for every entry (the kernel's time is
// over a thousand times its byte bound; PERF.md, chip_smoke.py).
// The design breaks the chain where the wire format allows. Every bit the
// encoder writes is a function of the maps, so an entry's bits and queue
// appends depend on earlier entries only through offsets. The whole block
// decides a chunk of up to NT*E queue entries, E consecutive ones a thread:
// each thread loads its entries (one coalesced load; a LIS fire then loads
// its children, the second and last level), counts its bits and appends,
// and one block scan (warp scans, then the warp totals in shared memory)
// gives every entry its offsets, so all are placed at once: the bits ORed
// into the chunk's words staged in shared memory, the queue words stored.
// The inclusive sums only grow, so the first entry whose bits pass the
// budget or whose appends pass a queue's capacity is the one whose
// exclusive sums fit and whose inclusive sums do not; the entries before it
// are placed, it runs bit by bit in its thread (enc_lip_seq / enc_lis_seq),
// which stops exactly where the sequential machine stops, and the machine
// ends. After each chunk the block writes the whole staged words to global
// memory with plain stores and carries the partial last word into the next
// chunk. A chunk of the LIS worklist is the entries present when it starts;
// entries appended while it runs start a later chunk, as in the sequential
// order. Each thread loads its entries of the next chunk while a chunk is
// decided, where they exist already (always in the LIP and refinement
// passes), so a LIS chunk waits on its fires' children alone. Per chunk
// there remain that gather, two barriers and the placement (PERF.md has
// the cycles).

#include "spiht_common.cuh"

// B1's block: 512 threads, two entries each (it is alone on its SM; the
// wider chunk means fewer chunks); B4's: 256 threads, two entries each, at
// most 48 registers, so that five blocks fit on an SM (660 streams a wave).
#define ENC_B1_THREADS 512
#define ENC_B1_PER_THREAD 2
#define ENC_B4_THREADS SPIHT_THREADS
#define ENC_B4_PER_THREAD 2
#define ENC_B4_BLOCKS_PER_SM 5

struct EncArgs {
  const int32_t* __restrict__ t1;
  const int32_t* __restrict__ t3s;
  const int32_t* __restrict__ child0;
  int32_t n_lip0;
  int32_t n_lis0;
  int32_t w;         // row length: the 2x2 child block is c0 + {0, 1, w, w+1}
  int32_t max_n;
  int32_t max_bits;  // already clamped to the word buffer's capacity
  int32_t capped;    // 1 if the caller's max_bits exceeded that capacity
  int32_t* __restrict__ lip;  // B1: t3s words; B7: node indices
  int32_t lip_cap;
  int32_t* __restrict__ lis;  // B1: lis_cap LisEntry pairs; B7: node<<1 | type_A
  int32_t lis_cap;
  int32_t* __restrict__ lsp;  // B1: t3s words; B7: node indices
  int32_t lsp_cap;
  uint32_t* __restrict__ words;  // zeroed
  int32_t* __restrict__ stat;
};

SPIHT_HD int32_t level_m(int32_t t) { return (t & 63) - 1; }
SPIHT_HD int32_t level_d(int32_t t) { return ((t >> 6) & 63) - 1; }
SPIHT_HD int32_t level_g(int32_t t) { return ((t >> 12) & 63) - 1; }
// t1's has-grandchildren bit
SPIHT_HD uint32_t has_gc(int32_t t) { return (t >> 20) & 1; }

SPIHT_HD void write_stat(const EncArgs& a, int32_t bits, int32_t err,
                         int32_t lip_n, int32_t lis_n, int32_t lsp_n) {
  a.stat[0] = bits;
  a.stat[1] = err;
  a.stat[2] = lip_n;
  a.stat[3] = lis_n;
  a.stat[4] = lsp_n;
  a.stat[5] = 0;
}

// ---- B1: the block-wide machine ----

// A LIS entry as B1 queues it.
struct alignas(8) LisEntry {
  int32_t e;  // child0 << 1 | type_A
  int32_t t;  // t1 of the node
};

// The t3s word of a 0 coefficient, never significant: a LIP chunk's
// entries past the queue's end read as it.
#define T3S_ZERO ((int32_t)0x80000000u)

// A t3s payload's significance at plane n: M >= n, on the uint32
// magnitude (the word 0 is -2^31's, magnitude 2^31).
SPIHT_HD uint32_t sig_at(int32_t x, int n) {
  return (((uint32_t)x & 0x7FFFFFFFu) | (uint32_t)(x == 0) << 31) >> n != 0;
}

// Counts of an entry, or of a run of entries, packed into one word so that
// one scan places them all: stream bits [0, 14), LSP appends [14, 27), LIP
// appends [27, 40), LIS appends [40, 53), entries retained [53, 64). A chunk
// of up to 1024 entries fits every field (9, 4, 4, 4 and 1 an entry).
#define ENC_F_LSP 14
#define ENC_F_LIP 27
#define ENC_F_LIS 40
#define ENC_F_KEEP 53
SPIHT_HD uint64_t enc_counts(uint32_t bits, uint32_t lsp, uint32_t lip,
                             uint32_t lis, uint32_t keep) {
  return bits | (uint64_t)lsp << ENC_F_LSP | (uint64_t)lip << ENC_F_LIP |
         (uint64_t)lis << ENC_F_LIS | (uint64_t)keep << ENC_F_KEEP;
}
SPIHT_HD int32_t cnt_bits(uint64_t c) { return (int32_t)(c & 0x3FFF); }
SPIHT_HD int32_t cnt_lsp(uint64_t c) { return (int32_t)(c >> ENC_F_LSP) & 0x1FFF; }
SPIHT_HD int32_t cnt_lip(uint64_t c) { return (int32_t)(c >> ENC_F_LIP) & 0x1FFF; }
SPIHT_HD int32_t cnt_lis(uint64_t c) { return (int32_t)(c >> ENC_F_LIS) & 0x1FFF; }
SPIHT_HD int32_t cnt_keep(uint64_t c) { return (int32_t)(c >> ENC_F_KEEP); }

// The first k entries of a LIP chunk, s of them significant.
SPIHT_HD uint64_t lip_counts(int32_t k, int32_t s) {
  return enc_counts(k + s, s, 0, 0, k - s);
}

// Stream words a chunk of ch entries can touch: 9 bits an entry, after the
// partial word carried in.
#define ENC_STAGE(ch) (9 * (ch) / 32 + 2)

template <int CH>
struct EncShared {
  static_assert(CH <= 1024, "the packed counts hold chunks of <= 1024");
  uint64_t wsum[32];                  // warp totals of a block scan
  uint32_t stage[2][ENC_STAGE(CH)];   // a chunk's words, by chunk parity
  int32_t end;                        // stream bits where the machine stopped
};

// The machine state. Every thread of the block holds the same copy and
// advances it by each chunk's totals.
struct EncBlock {
  int32_t pos;                  // stream bits out
  int32_t lip_n, lis_n, lsp_n;  // live queue lengths (tails)
  int32_t keep;                 // retain cursor of the pass in progress
  int32_t base;                 // stream word held in stage[par][0]
  int32_t par;
};

// Whether entries with counts c, placed from state s, stay inside the budget
// and the queues' capacities.
SPIHT_HD bool enc_fits(const EncArgs& a, const EncBlock& s, uint64_t c) {
  return cnt_bits(c) <= a.max_bits - s.pos &&
         cnt_lsp(c) <= a.lsp_cap - s.lsp_n &&
         cnt_lip(c) <= a.lip_cap - s.lip_n &&
         cnt_lis(c) <= a.lis_cap - s.lis_n;
}

// WARP_SHFL_UP of a 32- or 64-bit value.
template <class T>
SPIHT_HD T shfl_up(int lane, T v, int d) {
  if constexpr (sizeof(T) == 8) {
    const uint32_t lo = WARP_SHFL_UP(lane, (int32_t)(uint32_t)v, d);
    const uint32_t hi = WARP_SHFL_UP(lane, (int32_t)(uint32_t)(v >> 32), d);
    return (T)hi << 32 | lo;
  } else {
    return (T)(uint32_t)WARP_SHFL_UP(lane, (int32_t)v, d);
  }
}

// The sum of v over threads 0..tid-1 of an NT-thread block, and the
// block's total: a warp scan, then each thread adds the totals of the warps
// before its own from shared memory (one barrier).
template <int NT, class T>
SPIHT_HD T block_scan(uint64_t* wsum, T v, int tid, T& total) {
  const int lane = tid & 31, warp = tid >> 5;
  T x = v;
  for (int d = 1; d < SPIHT_WARP; d <<= 1) {
    const T u = shfl_up(lane, x, d);
    if (lane >= d) x += u;
  }
  if (lane == SPIHT_WARP - 1) wsum[warp] = x;
  SPIHT_SYNC();
  T before = 0, tot = 0;
  for (int i = 0; i < NT / SPIHT_WARP; ++i) {
    const T s = (T)wsum[i];
    if (i < warp) before += s;
    tot += s;
  }
  total = tot;
  return before + x - v;
}

// The stopping entry's machine: the state at its start, bit by bit, its
// bits into the chunk's staged words.
struct EncSeq {
  uint32_t* stage;
  int32_t bit0;  // stream bit of stage[0]'s bit 0
  int32_t pos, limit, err, lip_n, lis_n, lsp_n, keep;
};

template <int CH>
SPIHT_HD EncSeq enc_seq_at(const EncArgs& a, EncShared<CH>& sh,
                           const EncBlock& s, uint64_t ex) {
  return EncSeq{sh.stage[s.par], s.base * 32, s.pos + cnt_bits(ex),
                a.max_bits, SPIHT_OK, s.lip_n + cnt_lip(ex),
                s.lis_n + cnt_lis(ex), s.lsp_n + cnt_lsp(ex),
                s.keep + cnt_keep(ex)};
}

// Append one bit. Returns false (and writes nothing) once `limit` bits are
// out: the caller stops exactly there, mid-symbol if need be.
SPIHT_HD bool put_staged(EncSeq& q, uint32_t bit) {
  if (q.pos >= q.limit) return false;
  if (bit) ATOMIC_OR(&q.stage[(q.pos - q.bit0) >> 5], 1u << (q.pos & 31));
  ++q.pos;
  return true;
}

// ---- one entry, as the sequential machine runs it ----
// Each returns false when the machine stops (budget spent, or a queue would
// overflow: q.err says which).

SPIHT_HD bool enc_lip_seq(const EncArgs& a, int32_t x, int n, EncSeq& q) {
  const uint32_t sig = sig_at(x, n);
  if (!put_staged(q, sig)) return false;
  if (!sig) {
    a.lip[q.keep++] = x;
    return true;
  }
  if (!put_staged(q, (uint32_t)x >> 31)) return false;
  if (q.lsp_n >= a.lsp_cap) { q.err = SPIHT_ERR_LSP_CAP; return false; }
  a.lsp[q.lsp_n++] = x;
  return true;
}

// kid: the children's t3s (type A) or t1 (type B); kc: the first child's
// child0 (B).
SPIHT_HD bool enc_lis_seq(const EncArgs& a, LisEntry le, const int32_t* kid,
                          int32_t kc, int n, EncSeq& q) {
  LisEntry* lis = reinterpret_cast<LisEntry*>(a.lis);
  if (le.e & 1) {  // type A: any descendant significant?
    const uint32_t dsig = level_d(le.t) >= n;
    if (!put_staged(q, dsig)) return false;
    if (!dsig) {
      lis[q.keep++] = le;
      return true;
    }
    for (int i = 0; i < 4; ++i) {
      const uint32_t sig = sig_at(kid[i], n);
      if (!put_staged(q, sig)) return false;
      if (sig) {
        if (!put_staged(q, (uint32_t)kid[i] >> 31)) return false;
        if (q.lsp_n >= a.lsp_cap) { q.err = SPIHT_ERR_LSP_CAP; return false; }
        a.lsp[q.lsp_n++] = kid[i];
      } else {
        if (q.lip_n >= a.lip_cap) { q.err = SPIHT_ERR_LIP_CAP; return false; }
        a.lip[q.lip_n++] = kid[i];
      }
    }
    if (has_gc(le.t)) {  // has grandchildren: re-append as type B
      if (q.lis_n >= a.lis_cap) { q.err = SPIHT_ERR_LIS_CAP; return false; }
      lis[q.lis_n++] = LisEntry{le.e & ~1, le.t};
    }
    return true;
  }
  const uint32_t lsig = level_g(le.t) >= n;  // type B: any grandchild subtree?
  if (!put_staged(q, lsig)) return false;
  if (!lsig) {
    lis[q.keep++] = le;
    return true;
  }
  if (q.lis_n + 4 > a.lis_cap) { q.err = SPIHT_ERR_LIS_CAP; return false; }
  const int32_t off[4] = {0, 1, a.w, a.w + 1};
  for (int i = 0; i < 4; ++i)
    lis[q.lis_n++] = LisEntry{(kc + 2 * off[i]) << 1 | 1, kid[i]};
  return true;
}

// The stopping entry has run: its thread reports where the machine ended.
template <int CH>
SPIHT_HD void enc_stop(const EncArgs& a, EncShared<CH>& sh, EncSeq& q) {
  // a put refused: the budget is spent (or a queue overflowed)
  if (q.err == SPIHT_OK && a.capped) q.err = SPIHT_ERR_STREAM_CAP;
  sh.end = q.pos;
  write_stat(a, q.pos, q.err, q.lip_n, q.lis_n, q.lsp_n);
}

// ---- a LIS entry's bits and counts ----

SPIHT_HD bool lis_fires(LisEntry le, int n) {
  return (le.e & 1) ? level_d(le.t) >= n : level_g(le.t) >= n;
}

// The bits a LIS entry writes at plane n (its first at bit 0) and its
// counts; kid as in enc_lis_seq.
SPIHT_HD uint64_t lis_entry(LisEntry le, const int32_t* kid, int n,
                            uint32_t& bits) {
  if (!lis_fires(le, n)) {
    bits = 0;
    return enc_counts(1, 0, 0, 0, 1);
  }
  bits = 1;
  if (!(le.e & 1)) return enc_counts(1, 0, 0, 4, 0);
  uint32_t nb = 1, nsig = 0;
  for (int i = 0; i < 4; ++i) {
    const uint32_t sig = sig_at(kid[i], n);
    bits |= sig << nb++;
    if (sig) {
      bits |= ((uint32_t)kid[i] >> 31) << nb++;
      ++nsig;
    }
  }
  return enc_counts(nb, nsig, 4 - nsig, has_gc(le.t), 0);
}

// ---- chunk ends ----

// After a chunk's barrier: its whole words go to global memory and the
// partial last word is carried into the other stage buffer, zeroed for the
// next chunk; at the machine's end (`last`) the partial word goes out too.
template <int NT, int CH>
SPIHT_HD void enc_flush(const EncArgs& a, EncShared<CH>& sh, EncBlock& s,
                        int32_t end, bool last, int tid) {
  const uint32_t* st = sh.stage[s.par];
  const int32_t full = (end >> 5) - s.base;
  const int32_t n_out = last ? ((end + 31) >> 5) - s.base : full;
  for (int32_t i = tid; i < n_out; i += NT) a.words[s.base + i] = st[i];
  if (last) return;
  uint32_t* nx = sh.stage[s.par ^ 1];
  for (int32_t i = tid; i < ENC_STAGE(CH); i += NT) nx[i] = i ? 0u : st[full];
  s.base += full;
  s.par ^= 1;
}

// The end of a chunk whose entries have counts `tot` in all: the barrier
// after its placement, then its words out. True if the machine stopped in
// it (the totals do not fit: an entry ran bit by bit and stopped); else the
// state advances by the totals.
template <int NT, int CH>
SPIHT_HD bool enc_chunk_end(const EncArgs& a, EncShared<CH>& sh, EncBlock& s,
                            uint64_t tot, int tid) {
  const bool stop = !enc_fits(a, s, tot);
  SPIHT_SYNC();
  if (stop) {
    enc_flush<NT>(a, sh, s, sh.end, true, tid);
    return true;
  }
  s.pos += cnt_bits(tot);
  s.lsp_n += cnt_lsp(tot);
  s.lip_n += cnt_lip(tot);
  s.lis_n += cnt_lis(tot);
  s.keep += cnt_keep(tot);
  enc_flush<NT>(a, sh, s, s.pos, false, tid);
  return false;
}

// The machine, run by every thread of an NT-thread block (tid in [0, NT));
// lip/lis hold their initial entries and the words are zeroed on entry.
template <int NT, int E>
SPIHT_HD void encode_machine(const EncArgs& a, EncShared<NT * E>& sh,
                             int tid) {
  constexpr int CH = NT * E;
  const int32_t off[4] = {0, 1, a.w, a.w + 1};
  LisEntry* lis = reinterpret_cast<LisEntry*>(a.lis);
  EncBlock s{0, a.n_lip0, a.n_lis0, 0, 0, 0, 0};
  const int32_t k0 = tid * E;  // this thread's first entry of a chunk
  for (int32_t i = tid; i < 2 * ENC_STAGE(CH); i += NT)
    sh.stage[i / ENC_STAGE(CH)][i % ENC_STAGE(CH)] = 0u;
  SPIHT_SYNC();

  for (int n = a.max_n; n >= 0; --n) {
    const int32_t lip_len = s.lip_n, lsp_snap = s.lsp_n;

    // ---- LIP pass ----
    // Each pass loads the next chunk's entries while a chunk is decided
    // (xn, ln, yn): the entries a chunk writes (retained ones, below its
    // end; appends, at the tails) never lie in the next chunk's range.
    s.keep = 0;
    int32_t xn[E];
    for (int j = 0; j < E; ++j)
      xn[j] = k0 + j < lip_len ? a.lip[k0 + j] : T3S_ZERO;
    for (int32_t r0 = 0; r0 < lip_len; r0 += CH) {
      const int32_t m = min32(CH, lip_len - r0);
      int32_t x[E];
      uint32_t nsig = 0;
      for (int j = 0; j < E; ++j) {
        x[j] = xn[j];
        nsig += sig_at(x[j], n);
        const int32_t k = r0 + CH + k0 + j;
        xn[j] = k < lip_len ? a.lip[k] : T3S_ZERO;
      }
      uint32_t tsig;
      uint32_t sg = block_scan<NT>(sh.wsum, nsig, tid, tsig);
      uint32_t* st = sh.stage[s.par];
      for (int j = 0, k = k0; j < E && k < m; ++j, ++k) {
        const uint32_t sig = sig_at(x[j], n);
        if (!enc_fits(a, s, lip_counts(k + 1, sg + sig))) {
          if (enc_fits(a, s, lip_counts(k, sg))) {  // the stopping entry
            EncSeq q = enc_seq_at(a, sh, s, lip_counts(k, sg));
            enc_lip_seq(a, x[j], n, q);
            enc_stop(a, sh, q);
          }
          break;
        }
        if (sig) {
          or_bits(st, (s.pos & 31) + k + sg, 1u | ((uint32_t)x[j] >> 31) << 1, 2);
          a.lsp[s.lsp_n + sg] = x[j];
        } else {
          a.lip[s.keep + k - sg] = x[j];
        }
        sg += sig;
      }
      if (enc_chunk_end<NT>(a, sh, s, lip_counts(m, tsig), tid)) return;
    }
    s.lip_n = s.keep;

    // ---- LIS pass (worklist: entries appended now are visited now) ----
    s.keep = 0;
    int32_t have = s.lis_n;  // ln holds the entries below `have`
    LisEntry ln[E];
    for (int j = 0; j < E; ++j)
      ln[j] = k0 + j < have ? lis[k0 + j] : LisEntry{0, 0};
    for (int32_t r0 = 0; r0 < s.lis_n;) {
      const int32_t m = min32(CH, s.lis_n - r0);
      LisEntry le[E];
      for (int j = 0; j < E; ++j) {
        const int32_t k = r0 + k0 + j;
        le[j] = k0 + j >= m ? LisEntry{0, 0} : k < have ? ln[j] : lis[k];
      }
      have = s.lis_n;  // the next chunk's entries that exist before this one
      for (int j = 0; j < E; ++j) {
        const int32_t k = r0 + m + k0 + j;
        ln[j] = k < have ? lis[k] : LisEntry{0, 0};
      }
      // a fire's children: t3s (type A) or t1 and the first's child0 (B)
      int32_t kid[E][4], kc[E];
      uint64_t v = 0;
      for (int j = 0; j < E; ++j) {
        if (k0 + j >= m) continue;
        if (lis_fires(le[j], n)) {
          const int32_t c0 = le[j].e >> 1;
          for (int i = 0; i < 4; ++i) {
            kid[j][i] = (le[j].e & 1) ? a.t3s[c0 + off[i]] : a.t1[c0 + off[i]];
          }
          if (!(le[j].e & 1)) kc[j] = a.child0[c0];
        }
        uint32_t bits;
        v += lis_entry(le[j], kid[j], n, bits);
      }
      uint64_t tot;
      uint64_t ex = block_scan<NT>(sh.wsum, v, tid, tot);
      uint32_t* st = sh.stage[s.par];
      for (int j = 0, k = k0; j < E && k < m; ++j, ++k) {
        uint32_t bits;
        const uint64_t c = lis_entry(le[j], kid[j], n, bits);
        if (!enc_fits(a, s, ex + c)) {
          if (enc_fits(a, s, ex)) {  // the stopping entry
            EncSeq q = enc_seq_at(a, sh, s, ex);
            enc_lis_seq(a, le[j], kid[j], kc[j], n, q);
            enc_stop(a, sh, q);
          }
          break;
        }
        or_bits(st, (s.pos & 31) + cnt_bits(ex), bits, cnt_bits(c));
        if (!lis_fires(le[j], n)) {
          lis[s.keep + cnt_keep(ex)] = le[j];
        } else if (le[j].e & 1) {
          int32_t ls = s.lsp_n + cnt_lsp(ex), li = s.lip_n + cnt_lip(ex);
          for (int i = 0; i < 4; ++i) {
            if (sig_at(kid[j][i], n)) {
              a.lsp[ls++] = kid[j][i];
            } else {
              a.lip[li++] = kid[j][i];
            }
          }
          if (cnt_lis(c)) lis[s.lis_n + cnt_lis(ex)] = LisEntry{le[j].e & ~1, le[j].t};
        } else {
          const int32_t at = s.lis_n + cnt_lis(ex);
          for (int i = 0; i < 4; ++i)
            lis[at + i] = LisEntry{(kc[j] + 2 * off[i]) << 1 | 1, kid[j][i]};
        }
        ex += c;
      }
      if (enc_chunk_end<NT>(a, sh, s, tot, tid)) return;
      r0 += m;
    }
    s.lis_n = s.keep;

    // ---- refinement of the entries significant before this plane ----
    int32_t yn[E];
    for (int j = 0; j < E; ++j) yn[j] = k0 + j < lsp_snap ? a.lsp[k0 + j] : 0;
    for (int32_t r0 = 0; r0 < lsp_snap; r0 += CH) {
      const int32_t m = min32(CH, lsp_snap - r0);
      const int32_t room = a.max_bits - s.pos;  // one bit an entry
      uint32_t bits = 0;
      for (int j = 0; j < E; ++j)
        if (k0 + j < min32(m, room))
          bits |= (uint32_t)((yn[j] & 0x7FFFFFFF) >> n & 1) << j;
      for (int j = 0; j < E; ++j) {
        const int32_t k = r0 + CH + k0 + j;
        yn[j] = k < lsp_snap ? a.lsp[k] : 0;
      }
      SPIHT_SYNC();  // the last chunk's flush has zeroed this stage buffer
      or_bits(sh.stage[s.par], (s.pos & 31) + k0, bits, E);
      const bool stop = m > room;
      if (stop && tid == 0) {  // the budget is spent
        sh.end = a.max_bits;
        write_stat(a, a.max_bits, a.capped ? SPIHT_ERR_STREAM_CAP : SPIHT_OK,
                   s.lip_n, s.lis_n, s.lsp_n);
      }
      SPIHT_SYNC();
      if (stop) {
        enc_flush<NT>(a, sh, s, a.max_bits, true, tid);
        return;
      }
      s.pos += m;
      enc_flush<NT>(a, sh, s, s.pos, false, tid);
    }
  }

  if (tid == 0) write_stat(a, s.pos, SPIHT_OK, s.lip_n, s.lis_n, s.lsp_n);
  enc_flush<NT>(a, sh, s, s.pos, true, tid);
}

// B1's queues at the start (LIP: each initial node's t3s; LIS: its child0
// and t1) and the zeroed stream, by every thread of the block; a barrier
// must follow before the machine starts.
template <int NT>
SPIHT_HD void enc_load(const EncArgs& a, const int32_t* lip0,
                       const int32_t* lis0, int32_t cap_words, int tid) {
  LisEntry* lis = reinterpret_cast<LisEntry*>(a.lis);
  for (int32_t i = tid; i < cap_words; i += NT) a.words[i] = 0u;
  for (int32_t i = tid; i < a.n_lip0; i += NT) a.lip[i] = a.t3s[lip0[i]];
  for (int32_t i = tid; i < a.n_lis0; i += NT) {
    const int32_t node = lis0[i] >> 1;
    lis[i] = LisEntry{a.child0[node] << 1 | (lis0[i] & 1), a.t1[node]};
  }
}

// B1's whole block: the queues loaded, a barrier, the machine (run by the
// kernel, and by the host build).
template <int NT, int E>
SPIHT_HD void encode_block(const EncArgs& a, const int32_t* lip0,
                           const int32_t* lis0, int32_t cap_words,
                           EncShared<NT * E>& sh, int tid) {
  enc_load<NT>(a, lip0, lis0, cap_words, tid);
  SPIHT_SYNC();
  encode_machine<NT, E>(a, sh, tid);
}

// ---- kernel B7: the sequential machine, fed by loader warps ----
//
// Replaces spiht_tpu/codec/pallas_encoder.py:_seq_fn (the encoder that
// pallas_encode_fn runs for machine="seq"). It computes B1's function on
// B1's tables (EncArgs), with the same exact mid-symbol max_bits cut and the
// same stat words. One thread, the decider, decides every queue entry, one
// at a time, in the wire order; its queues hold node indices, as the plain
// version's do: LIP and LSP nodes, LIS entries node << 1 | type_A, LIP and
// LIS in-place FIFOs with the retain cursor `keep` trailing the read cursor,
// LIS appends visited in the same pass, refinement of the lsp_len snapshot.
//
// What bounds it on an H100: the decider's chain. Run straight from global
// memory, each entry waited on one to three dependent L2 or HBM loads
// (entry -> t1 -> child0 -> the children's t1 and t3s), ~140 ns a stream
// bit; bytes and arithmetic are a thousandth of that. The design takes
// every load off that chain. Loader warps fill a ring of SEQ_RING slots in
// shared memory ahead of the decider (SeqSlot: an entry's queue word, its
// node's t1 and t3s; for a LIS entry that fires at this plane, its first
// child's index and, for type A, the four children's t1 and t3s: whether an
// entry fires is a function of its own t1 and the plane, so a loader knows
// what to fetch). The decider reads only the ring. What is left on its
// chain is one thread's instructions: with no other warp to hide their
// latency, each costs its full latency and a branch costs more, so the
// decider places its entries in branch-free runs (below). On the card the
// loaders wait on a full ring most of the time and the decider waits on
// them for under 1% of its cycles (encode_clocks.py); its time goes to the
// LIS entries, ~130 instructions each, and grows with the entries a stream
// bit (PERF.md has the cycles of each pass).
//
// The ring runs over one count of items (entries) for the whole machine:
// item A lies in slot A % SEQ_RING, and each pass starts at a multiple of 32,
// so 32 items make a group that one loader warp fills, a lane an item, and
// publishes with one release of the group's frontier (the items below it
// are filled). The decider acquires a group's frontier once, publishes the
// items it has consumed (the loaders reuse their slots) and, in the LIS
// pass, the queue's tail (the loaders read lis[r] only below it) whenever
// it comes to the end of what is filled. How far the loaders may run ahead:
// in the LIP pass the entries lip[0, lip_n) are known when it starts and
// it appends nothing to the LIP, in the refinement lsp[0, snap); in the LIS
// pass retained entries are written at keep <= r, never ahead of the read
// cursor, so an entry fetched ahead stays valid. Pass boundaries are block
// barriers, where the decider publishes the next pass (SeqPass: its kind,
// plane, first item and length); a stop (budget or queue cap) is a flag the
// loaders see in every wait. Loaders never read a queue past its published
// length, and the children only of entries that fire.
//
// Copies: each slot is gathered by ld.global and st.shared. The gathers are
// chains (queue entry -> t1 -> child0 -> the children), each level's
// addresses taken from the level before, so the values pass through the
// loader's registers in any case; cp.async could serve only the last level
// and a bulk (TMA) copy only the contiguous first one, the queue words of
// a group, which is one coalesced load already.
//
// The decision code (seq_pass, seq_run, the *_exact forms) is SPIHT_HD and
// takes slots; the host build runs it with a plain loop that fills the ring
// in the loaders' place (HostFeed): a ring of a few slots wraps in every
// pass, one of 64 gives the decider whole groups.

#define SEQ_LOADERS 7  // loader warps beside the decider's (PERF.md)
#define SEQ_THREADS (32 * (1 + SEQ_LOADERS))
#define SEQ_RING 1024  // slots (a power of two, at least 64)
#define SEQ_GROUPS (SEQ_RING / 32)

// What the decider reads of one entry.
struct alignas(16) SeqSlot {
  int32_t e;       // queue word: LIP or LSP node, LIS node << 1 | type_A
  int32_t t, x;    // t1 and t3s of the node
  int32_t c0;      // a fired LIS entry: its first child
  int32_t kt[4];   // a fired type-A entry: its children's t1
  int32_t kx[4];   // and t3s
};

enum SeqKind : int32_t { SEQ_LIP = 0, SEQ_LIS = 1, SEQ_REF = 2, SEQ_END = 3 };

// A pass as the decider publishes it: items [seq0, seq0 + len) of the
// ring's count (the LIS pass's len is its length at the start).
struct SeqPass {
  int32_t kind, n, len;
  uint32_t seq0;
  uint32_t id;  // passes so far
};

// The decider's state. The stream's current word is `cur` (bits below
// pos & 31), stored when full.
struct BitWriter {
  uint32_t* words;
  uint32_t cur;
  int32_t pos, limit;
};

struct SeqState {
  BitWriter bw;
  int32_t err;
  int32_t lip_n, lis_n, lsp_n;
  int32_t keep;  // retain cursor of the pass in progress
  int32_t snap;  // the LSP's length when the plane began
};

// Append one bit. Returns false (and writes nothing) once `limit` bits are
// out: the caller stops exactly there, mid-symbol if need be.
SPIHT_HD bool put_bit(BitWriter& bw, uint32_t bit) {
  if (bw.pos >= bw.limit) return false;
  bw.cur |= bit << (bw.pos & 31);
  if ((++bw.pos & 31) == 0) {
    bw.words[(bw.pos >> 5) - 1] = bw.cur;
    bw.cur = 0;
  }
  return true;
}

// One item's slot from the tables, as a loader fills it (r: the entry's
// index in its queue). Only the loaders read the tables.
SPIHT_HD void seq_load(const EncArgs& a, const SeqPass& p, int32_t r,
                       SeqSlot& sl) {
  if (p.kind == SEQ_REF) {
    sl.x = a.t3s[a.lsp[r]];
    return;
  }
  const int32_t e = p.kind == SEQ_LIP ? a.lip[r] : a.lis[r];
  const int32_t node = p.kind == SEQ_LIP ? e : e >> 1;
  sl.e = e;
  sl.t = a.t1[node];
  if (p.kind == SEQ_LIP) {
    sl.x = a.t3s[node];
    return;
  }
  if (!((e & 1) ? level_d(sl.t) >= p.n : level_g(sl.t) >= p.n)) return;
  sl.c0 = a.child0[node];
  if (!(e & 1)) return;
  const int32_t off[4] = {0, 1, a.w, a.w + 1};
  for (int q = 0; q < 4; ++q) {
    sl.kt[q] = a.t1[sl.c0 + off[q]];
    sl.kx[q] = a.t3s[sl.c0 + off[q]];
  }
}

// ---- the decider ----
// One thread's step is bound by instruction and branch latency (nothing
// hides it), so the decider places entries in runs without a branch: where
// K entries are filled (a whole group of 32, else 1) and the most they
// could write fits the budget and every queue (seq_fits), seq_run ORs each
// entry's bits into a 64-bit accumulator, whose current word is stored
// after every entry, and stores each possible append unconditionally at its
// queue's running count, the count advancing only where the append is
// real. A store that is not real lands where a later one overwrites it or
// past the queue's final length: at the next free position of a queue, or
// at the retain cursor (which never passes the entry being decided, whose
// slot the loaders have already read). In a run of 32, one entry's loads
// and tests overlap the last one's placement. Where a run might not fit
// (the approach to a stop) the entry goes bit by bit (the *_exact forms),
// checking the budget before every bit and each queue before its append,
// and stops exactly there, as B1's stopping entry does. Each *_exact form
// returns false when the machine stops (budget spent, or a queue would
// overflow: s.err says which).

SPIHT_HD bool seq_lip_exact(const EncArgs& a, const SeqSlot& sl, int n,
                            SeqState& s) {
  const uint32_t sig = level_m(sl.t) >= n;
  if (!put_bit(s.bw, sig)) return false;
  if (!sig) {
    a.lip[s.keep++] = sl.e;
    return true;
  }
  if (!put_bit(s.bw, (uint32_t)sl.x >> 31)) return false;
  if (s.lsp_n >= a.lsp_cap) { s.err = SPIHT_ERR_LSP_CAP; return false; }
  a.lsp[s.lsp_n++] = sl.e;
  return true;
}

SPIHT_HD bool seq_lis_exact(const EncArgs& a, const SeqSlot& sl, int n,
                            SeqState& s) {
  const int32_t e = sl.e, t = sl.t;
  if (e & 1) {  // type A: any descendant significant?
    const uint32_t dsig = level_d(t) >= n;
    if (!put_bit(s.bw, dsig)) return false;
    if (!dsig) {
      a.lis[s.keep++] = e;
      return true;
    }
    const int32_t off[4] = {0, 1, a.w, a.w + 1};
    for (int q = 0; q < 4; ++q) {
      const int32_t ch = sl.c0 + off[q];
      const uint32_t sig = level_m(sl.kt[q]) >= n;
      if (!put_bit(s.bw, sig)) return false;
      if (sig) {
        if (!put_bit(s.bw, (uint32_t)sl.kx[q] >> 31)) return false;
        if (s.lsp_n >= a.lsp_cap) { s.err = SPIHT_ERR_LSP_CAP; return false; }
        a.lsp[s.lsp_n++] = ch;
      } else {
        if (s.lip_n >= a.lip_cap) { s.err = SPIHT_ERR_LIP_CAP; return false; }
        a.lip[s.lip_n++] = ch;
      }
    }
    if (has_gc(t)) {  // has grandchildren: re-append as type B
      if (s.lis_n >= a.lis_cap) { s.err = SPIHT_ERR_LIS_CAP; return false; }
      a.lis[s.lis_n++] = e & ~1;
    }
    return true;
  }
  const uint32_t lsig = level_g(t) >= n;  // type B: any grandchild subtree?
  if (!put_bit(s.bw, lsig)) return false;
  if (!lsig) {
    a.lis[s.keep++] = e;
    return true;
  }
  if (s.lis_n + 4 > a.lis_cap) { s.err = SPIHT_ERR_LIS_CAP; return false; }
  const int32_t off[4] = {0, 1, a.w, a.w + 1};
  for (int q = 0; q < 4; ++q) a.lis[s.lis_n++] = ((sl.c0 + off[q]) << 1) | 1;
  return true;
}

SPIHT_HD bool seq_exact(const EncArgs& a, const SeqSlot& sl, const SeqPass& p,
                        SeqState& s) {
  if (p.kind == SEQ_LIP) return seq_lip_exact(a, sl, p.n, s);
  if (p.kind == SEQ_LIS) return seq_lis_exact(a, sl, p.n, s);
  return put_bit(s.bw, ((sl.x & 0x7FFFFFFF) >> p.n) & 1);
}

// The stream's bits from pos on, as a run places them.
struct BitAcc {
  uint64_t v;  // the bits from word w's bit 0 on
  int32_t fill;
  int32_t w;
};

// Append the low nb bits of `bits` (nb <= 32, zero above) and store the
// current word; a full word moves the accumulator on.
SPIHT_HD void acc_put(BitAcc& c, uint32_t* words, uint32_t bits, int32_t nb) {
  c.v |= (uint64_t)bits << c.fill;
  c.fill += nb;
  words[c.w] = (uint32_t)c.v;
  const int32_t full = c.fill >= 32;
  c.w += full;
  c.v >>= 32 * full;
  c.fill -= 32 * full;
}

#define SEQ_GROUP 32

// Whether k entries of pass p fit whatever they write: the LIP's 2 bits
// and one LSP append an entry, the LIS's 9 bits and 4 appends to each
// queue, the refinement's one bit.
SPIHT_HD bool seq_fits(const EncArgs& a, const SeqState& s, const SeqPass& p,
                       int32_t k) {
  if (p.kind == SEQ_REF) return s.bw.pos + k <= s.bw.limit;
  if (p.kind == SEQ_LIP)
    return s.bw.pos + 2 * k <= s.bw.limit && s.lsp_n + k <= a.lsp_cap;
  return s.bw.pos + 9 * k <= s.bw.limit && s.lsp_n + 4 * k <= a.lsp_cap &&
         s.lip_n + 4 * k <= a.lip_cap && s.lis_n + 4 * k <= a.lis_cap;
}

// Entries r .. r + K - 1 of pass p, filled, whose largest output fits,
// placed straight through.
template <int K, class Feed>
SPIHT_HD void seq_run(const EncArgs& a, Feed& f, const SeqPass& p, int32_t r,
                      SeqState& s) {
  const int n = p.n;
  BitAcc c{s.bw.cur, s.bw.pos & 31, s.bw.pos >> 5};
  int32_t kp = s.keep, ls = s.lsp_n, li = s.lip_n, lt = s.lis_n;
  if (p.kind == SEQ_REF) {  // one bit an entry
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      word |= ((uint32_t)(f.slot(p, r + k).x & 0x7FFFFFFF) >> n & 1u) << k;
    acc_put(c, s.bw.words, word, K);
  } else if (p.kind == SEQ_LIP) {  // 1 or 2 bits and one append an entry
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const SeqSlot& sl = f.slot(p, r + k);
      const int32_t e = sl.e;
      const uint32_t sig = level_m(sl.t) >= n;
      acc_put(c, s.bw.words, sig | (sig & ((uint32_t)sl.x >> 31)) << 1,
              1 + (int32_t)sig);
      a.lsp[ls] = e;  // real where significant
      a.lip[kp] = e;  // real where not: retained
      ls += sig;
      kp += 1 - sig;
    }
  } else {  // LIS: up to 9 bits and 4 appends an entry
    const int32_t off[4] = {0, 1, a.w, a.w + 1};
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const SeqSlot& sl = f.slot(p, r + k);
      const int32_t e = sl.e, t = sl.t, c0 = sl.c0;
      const uint32_t ta = e & 1;
      const uint32_t fires = (ta ? level_d(t) : level_g(t)) >= n;
      const uint32_t fa = fires & ta, fb = fires & (ta ^ 1);
      const uint32_t hg = fa & has_gc(t);  // re-append as type B
      a.lis[kp] = e;  // real where it does not fire: retained
      kp += 1 - fires;
      // a type-A fire: each child's bit and, if significant, its sign, and
      // the child to the LSP or the LIP; a type-B fire: the four children
      // to the LIS as type A (the first, or the re-appended entry, at lt)
      uint32_t bits = 1, nb = 1;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t sig = level_m(sl.kt[q]) >= n;
        bits |= (sig | (sig & ((uint32_t)sl.kx[q] >> 31)) << 1) << nb;
        nb += 1 + sig;
        const int32_t ch = c0 + off[q];
        a.lsp[ls] = ch;
        a.lip[li] = ch;
        ls += fa & sig;
        li += fa & (sig ^ 1);
        if (q) a.lis[lt + q] = (ch << 1) | 1;
      }
      a.lis[lt] = hg ? (e & ~1) : (c0 << 1) | 1;
      lt += 4 * fb + hg;
      acc_put(c, s.bw.words, fa ? bits : fires, fa ? (int32_t)nb : 1);
    }
  }
  s.bw.cur = (uint32_t)c.v;
  s.bw.pos = c.w * 32 + c.fill;
  s.keep = kp;
  s.lsp_n = ls;
  s.lip_n = li;
  s.lis_n = lt;
}

SPIHT_HD SeqState seq_state(const EncArgs& a) {
  return SeqState{BitWriter{a.words, 0u, 0, a.max_bits}, SPIHT_OK,
                  a.n_lip0, a.n_lis0, 0, 0, 0};
}

// The machine's first pass: the LIP at plane max_n.
SPIHT_HD SeqPass seq_first(const EncArgs& a) {
  return SeqPass{SEQ_LIP, a.max_n, a.n_lip0, 0u, 0u};
}

// The machine has ended (stopped: a put_bit refused, the budget spent or a
// queue overflowed): the last partial word out, then stat.
SPIHT_HD void seq_finish(const EncArgs& a, SeqState& s, bool stopped) {
  if (s.bw.pos & 31) s.bw.words[s.bw.pos >> 5] = s.bw.cur;
  if (stopped && s.err == SPIHT_OK && a.capped) s.err = SPIHT_ERR_STREAM_CAP;
  write_stat(a, s.bw.pos, s.err, s.lip_n, s.lis_n, s.lsp_n);
}

// One pass of the decider, its entries through `f` (f.ready: how many
// entries from r on are filled, waiting for one if need be, the pass
// having lim entries so far; f.slot: entry r's slot); returns the next
// pass (SEQ_END after the last, or a stop, with stat written).
template <class Feed>
SPIHT_HD SeqPass seq_pass(const EncArgs& a, Feed& f, SeqState& s,
                          const SeqPass& p) {
  f.begin(p);
  bool ok = true;
  int32_t r = 0;
  if (p.kind == SEQ_LIP) s.snap = s.lsp_n;
  s.keep = 0;
  for (;;) {
    // the LIS pass is a worklist: its appends are visited now
    const int32_t len = p.kind == SEQ_LIS ? s.lis_n : p.len;
    if (r >= len) break;
    if (f.ready(p, r, len) >= SEQ_GROUP && seq_fits(a, s, p, SEQ_GROUP)) {
      seq_run<SEQ_GROUP>(a, f, p, r, s);
      r += SEQ_GROUP;
    } else if (seq_fits(a, s, p, 1)) {
      seq_run<1>(a, f, p, r++, s);
    } else if (!(ok = seq_exact(a, f.slot(p, r++), p, s))) {
      break;
    }
  }
  if (ok && p.kind == SEQ_LIP) s.lip_n = s.keep;
  if (ok && p.kind == SEQ_LIS) s.lis_n = s.keep;
  f.end(p, r, ok);
  SeqPass nx{SEQ_END, p.n, 0, (p.seq0 + (uint32_t)r + 31u) & ~31u, p.id + 1};
  if (ok && p.kind == SEQ_LIP) {
    nx.kind = SEQ_LIS;
    nx.len = s.lis_n;
  } else if (ok && p.kind == SEQ_LIS) {
    nx.kind = SEQ_REF;
    nx.len = s.snap;
  } else if (ok && p.n > 0) {
    nx.kind = SEQ_LIP;
    nx.n = p.n - 1;
    nx.len = s.lip_n;
  }
  if (nx.kind == SEQ_END) seq_finish(a, s, !ok);
  return nx;
}

#ifndef __CUDACC__
// The host build's feed: a plain loop fills the ring (`size` slots) ahead
// of the decider, as far as the ring's free slots and the pass's length so
// far allow, in the loaders' place.
struct HostFeed {
  const EncArgs& a;
  SeqSlot* ring;
  uint32_t size;
  uint32_t filled;  // items of the ring's count filled so far
  void begin(const SeqPass& p) { filled = p.seq0; }
  int32_t ready(const SeqPass& p, int32_t r, int32_t lim) {
    const uint32_t at = p.seq0 + (uint32_t)r;
    // slot of item i + size is free once item i (< at) is decided
    for (; filled < p.seq0 + (uint32_t)lim && filled < at + size; ++filled)
      seq_load(a, p, (int32_t)(filled - p.seq0), ring[filled % size]);
    return (int32_t)(filled - at);
  }
  const SeqSlot& slot(const SeqPass& p, int32_t r) {
    return ring[(p.seq0 + (uint32_t)r) % size];
  }
  void end(const SeqPass&, int32_t, bool) {}
};

// B7 on the host: the decider fed by HostFeed through a ring of `size`
// slots; lip/lis hold their initial entries and the words are zeroed.
inline void encode_seq_host(const EncArgs& a, SeqSlot* ring, uint32_t size) {
  HostFeed f{a, ring, size, 0u};
  SeqState s = seq_state(a);
  for (SeqPass p = seq_first(a); p.kind != SEQ_END;) p = seq_pass(a, f, s, p);
}
#endif

// B7's start: zero the stream and copy the initial node lists, by every
// thread of the block; a barrier must follow.
SPIHT_HD void enc_prologue(const EncArgs& a, const int32_t* lip0,
                           const int32_t* lis0, int32_t cap_words, int tid,
                           int nt) {
  for (int32_t i = tid; i < cap_words; i += nt) a.words[i] = 0u;
  for (int32_t i = tid; i < a.n_lip0; i += nt) a.lip[i] = lip0[i];
  for (int32_t i = tid; i < a.n_lis0; i += nt) a.lis[i] = lis0[i];
}

// ---- kernel B4: B streams in one launch, one block per stream ----
//
// Replaces spiht_tpu/codec/pallas_encoder.py:_interleaved_fn, which stepped
// B chains in lockstep on one TPU core, finished chains inert. Here each
// chain is one block of the grid: block b builds stream b's EncArgs
// (enc_stream_args) and runs B1's machine, so every stream is
// byte-identical to B1's on the same coefficients.
//
// What bounds it on an H100: per stream the same chain of chunks as B1, but
// each stream reads its own tables (~110 MB at 16 streams of 3x537x537,
// past the 50 MB L2), so a gather level costs an HBM latency; across
// streams, how many blocks the SMs hold at once. The design is B1's: two
// levels of gathers a chunk instead of four, one block scan; the block is
// 256 threads (two entries each) so that five fit on an SM (~660 streams a
// wave on the 132 SMs); the geometry tables (child0, the initial queues)
// are shared and read through L2.
struct EncBatch {
  const int32_t* t1;      // (B, n_cells)
  const int32_t* t3s;     // (B, n_cells)
  const int32_t* child0;  // (n_cells), shared by every stream
  const int32_t* lip0;    // shared initial queues
  int32_t n_lip0;
  const int32_t* lis0;
  int32_t n_lis0;
  int32_t n_cells;
  int32_t w;
  const int32_t* max_n;     // (B), computed on the device
  const int32_t* max_bits;  // (B), the callers' budgets, >= 0
  int32_t* lip;             // (B, queue_stride(lip_cap))
  int32_t lip_cap;
  int32_t* lis;             // (B, 2 * queue_stride(lis_cap)): LisEntry pairs
  int32_t lis_cap;
  int32_t* lsp;             // (B, queue_stride(lsp_cap))
  int32_t lsp_cap;
  uint32_t* words;          // (B, cap_words), one buffer size for all
  int32_t cap_words;
  int32_t* stat;            // (B, SPIHT_STAT_LEN)
};

// Stream b's arguments. Offsets are 64-bit (B * n_cells passes 2^31 at
// large batches). The budget is clamped to the shared word buffer, and
// `capped` says whether the clamp cut it: the overflow rule is per stream,
// as it was per chain on the TPU.
SPIHT_HD EncArgs enc_stream_args(const EncBatch& g, int32_t b) {
  const int64_t cells = (int64_t)b * g.n_cells;
  const int64_t cap_bits = (int64_t)g.cap_words * 32;
  const int64_t mb = g.max_bits[b];
  return EncArgs{g.t1 + cells, g.t3s + cells, g.child0, g.n_lip0, g.n_lis0,
                 g.w, g.max_n[b], (int32_t)(mb < cap_bits ? mb : cap_bits),
                 (int32_t)(mb > cap_bits),
                 g.lip + b * queue_stride(g.lip_cap), g.lip_cap,
                 g.lis + 2 * b * queue_stride(g.lis_cap), g.lis_cap,
                 g.lsp + b * queue_stride(g.lsp_cap), g.lsp_cap,
                 g.words + (int64_t)b * g.cap_words,
                 g.stat + (int64_t)b * SPIHT_STAT_LEN};
}

// Stream b's whole block (run by the kernel with b = blockIdx.x, and by the
// host build once per stream).
template <int NT, int E>
SPIHT_HD void encode_stream(const EncBatch& g, int32_t b,
                            EncShared<NT * E>& sh, int tid) {
  encode_block<NT, E>(enc_stream_args(g, b), g.lip0, g.lis0, g.cap_words, sh,
                      tid);
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

// B1 reads its per-call scalars (max_n, the budget and its capped flag) from
// device memory, once at its start, into the EncArgs fields the machine
// takes by value: max_n is computed on the device (no host sync), and a
// replayed CUDA graph takes new values where a by-value argument is frozen
// at capture.
__global__ void __launch_bounds__(ENC_B1_THREADS)
spiht_encode_kernel(EncArgs a, const int32_t* __restrict__ max_n,
                    const int32_t* __restrict__ max_bits,
                    const int32_t* __restrict__ capped,
                    const int32_t* __restrict__ lip0,
                    const int32_t* __restrict__ lis0, int32_t cap_words) {
  __shared__ EncShared<ENC_B1_THREADS * ENC_B1_PER_THREAD> sh;
  a.max_n = *max_n;
  a.max_bits = *max_bits;  // already clamped to the word buffer
  a.capped = *capped;
  encode_block<ENC_B1_THREADS, ENC_B1_PER_THREAD>(a, lip0, lis0, cap_words,
                                                  sh, threadIdx.x);
}

// ---- B7's ring, loaders and decider on the card ----

// The ring in shared memory (dynamic: past the 48 KB of a static array).
struct SeqRing {
  SeqSlot slot[SEQ_RING];
  uint32_t front[SEQ_GROUPS];  // a group's frontier: its items below it are filled
  uint32_t consumed;           // the decider has read every item below it
  uint32_t tail;               // LIS pass: the queue's entries below it exist
  uint32_t closed;             // id of the last pass the decider finished
  uint32_t stop;               // the machine has stopped
  SeqPass pass[2];             // the next pass, by the parity of its id
};

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.cta.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.cta.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A wait that cannot end is a fault: trap (the launch fails) rather than
// hang the card. 2^35 cycles is over ten seconds.
__device__ __forceinline__ void seq_watchdog(long long t0) {
  if (clock64() - t0 > (1ll << 35)) __trap();
}

// The decider's feed: how many items from r on are filled (its group's
// frontier has passed them), and their slots. At the end of what is filled
// the decider publishes the items it has read (their slots go back to the
// loaders) and, in the LIS pass, the tail, then waits on the frontier.
struct DevFeed {
  SeqRing& q;
  uint32_t avail;  // items below it are filled
  __device__ void begin(const SeqPass& p) { avail = p.seq0; }
  __device__ int32_t ready(const SeqPass& p, int32_t r, int32_t lim) {
    const uint32_t at = p.seq0 + (uint32_t)r;
    if ((int32_t)(avail - at) <= 0) {
      st_release(&q.consumed, at);
      if (p.kind == SEQ_LIS) st_release(&q.tail, p.seq0 + (uint32_t)lim);
      const uint32_t* fr = &q.front[(at >> 5) & (SEQ_GROUPS - 1)];
      const long long t0 = clock64();
      uint32_t f;
      // the decider waits on the ring
      while ((int32_t)((f = ld_acquire(fr)) - at) <= 0) seq_watchdog(t0);
      avail = f;
    }
    return min32((int32_t)(avail - at), lim - r);
  }
  __device__ const SeqSlot& slot(const SeqPass& p, int32_t r) {
    return q.slot[(p.seq0 + (uint32_t)r) & (SEQ_RING - 1)];
  }
  __device__ void end(const SeqPass& p, int32_t r, bool ok) {
    st_release(&q.consumed, p.seq0 + (uint32_t)r);
    st_release(&q.closed, p.id);
    if (!ok) st_release(&q.stop, 1u);
  }
};

#define SEQ_MASK 0xFFFFFFFFu

// A loader warp waits until every lane has acquired `consumed` at or past
// `need` (the group's slots are free): true; false once pass p has closed
// (a LIS group past the queue's final tail: nothing is left to load) or the
// machine has stopped.
__device__ bool seq_wait_free(SeqRing& q, const SeqPass& p, uint32_t need) {
  const long long t0 = clock64();
  for (;;) {
    if (__all_sync(SEQ_MASK, (int32_t)(ld_acquire(&q.consumed) - need) >= 0))
      return true;
    if (__any_sync(SEQ_MASK, ld_acquire(&q.closed) == p.id ||
                                 ld_acquire(&q.stop) != 0))
      return false;
    __nanosleep(64);
    seq_watchdog(t0);
  }
}

// LIS pass: the least tail past `filled` that the warp's lanes have each
// acquired (the tail only grows, so every lane may read the entries below
// it), or `filled` once the pass has closed or the machine stopped (the
// decider had read every entry, so none is left past `filled`).
__device__ uint32_t seq_wait_tail(SeqRing& q, const SeqPass& p,
                                  uint32_t filled) {
  const long long t0 = clock64();
  for (;;) {
    const uint32_t ahead =
        __reduce_min_sync(SEQ_MASK, ld_acquire(&q.tail) - filled);
    if (ahead) return filled + ahead;
    if (__any_sync(SEQ_MASK, ld_acquire(&q.closed) == p.id ||
                                 ld_acquire(&q.stop) != 0))
      return filled;
    __nanosleep(32);
    seq_watchdog(t0);
  }
}

// Loader warp w's part of pass p: the groups w, w + SEQ_LOADERS, ... of its
// items, a lane an item. A group is filled as far as the items exist (the
// LIS's tail), its frontier released each time.
__device__ void seq_loader_pass(const EncArgs& a, SeqRing& q,
                                const SeqPass& p, int w, int lane) {
  const bool lis = p.kind == SEQ_LIS;
  const uint32_t end = p.seq0 + (uint32_t)p.len;  // LIP, refinement
  for (uint32_t g0 = p.seq0 + 32u * w;; g0 += 32u * SEQ_LOADERS) {
    if (!lis && (int32_t)(g0 - end) >= 0) return;
    if (!seq_wait_free(q, p, g0 + 32u - SEQ_RING)) return;
    for (uint32_t filled = g0; filled != g0 + 32u;) {
      const uint32_t lim = lis ? seq_wait_tail(q, p, filled) : end;
      if (lim == filled) return;
      const uint32_t hi = (int32_t)(lim - (g0 + 32u)) < 0 ? lim : g0 + 32u;
      const uint32_t at = g0 + (uint32_t)lane;
      if ((int32_t)(at - filled) >= 0 && (int32_t)(at - hi) < 0) {
        SeqSlot sl;
        seq_load(a, p, (int32_t)(at - p.seq0), sl);
        q.slot[at & (SEQ_RING - 1)] = sl;
      }
      __syncwarp();  // orders the lanes' slots before lane 0's release
      if (lane == 0) st_release(&q.front[(g0 >> 5) & (SEQ_GROUPS - 1)], hi);
      filled = hi;
    }
  }
}

// B7: the block zeroes the stream and loads the queues; then, pass by pass,
// thread 0 decides while warps 1..SEQ_LOADERS fill the ring, and the whole
// block meets at a barrier between passes.
__global__ void __launch_bounds__(SEQ_THREADS)
spiht_encode_seq_kernel(EncArgs a, const int32_t* __restrict__ max_n,
                        const int32_t* __restrict__ lip0,
                        const int32_t* __restrict__ lis0, int32_t cap_words) {
  extern __shared__ __align__(16) unsigned char seq_smem[];
  SeqRing& q = *reinterpret_cast<SeqRing*>(seq_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  enc_prologue(a, lip0, lis0, cap_words, tid, SEQ_THREADS);
  for (int i = tid; i < SEQ_GROUPS; i += SEQ_THREADS) q.front[i] = 0u;
  if (tid == 0) {
    q.consumed = 0u;
    q.tail = 0u;
    q.closed = ~0u;
    q.stop = 0u;
  }
  a.max_n = *max_n;
  __syncthreads();
  SeqPass p = seq_first(a);
  SeqState s = seq_state(a);  // thread 0's
  DevFeed f{q, 0u};
  while (p.kind != SEQ_END) {
    if (warp == 0) {
      if (lane == 0) {
        const SeqPass nx = seq_pass(a, f, s, p);
        if (nx.kind == SEQ_LIS) q.tail = nx.seq0 + (uint32_t)nx.len;
        q.pass[nx.id & 1] = nx;
      }
      __syncwarp();
    } else {
      seq_loader_pass(a, q, p, warp - 1, lane);
    }
    __syncthreads();
    p = q.pass[(p.id + 1) & 1];
  }
}

__global__ void __launch_bounds__(ENC_B4_THREADS, ENC_B4_BLOCKS_PER_SM)
spiht_encode_batch_kernel(EncBatch g) {
  __shared__ EncShared<ENC_B4_THREADS * ENC_B4_PER_THREAD> sh;
  encode_stream<ENC_B4_THREADS, ENC_B4_PER_THREAD>(g, blockIdx.x, sh,
                                                   threadIdx.x);
}

extern "C" int spiht_encode_launch(
    const int32_t* t1, const int32_t* t3s, const int32_t* child0,
    const int32_t* lip0, int32_t n_lip0, const int32_t* lis0, int32_t n_lis0,
    int32_t w, const int32_t* max_n, const int32_t* max_bits,
    const int32_t* capped, int32_t* lip, int32_t lip_cap, int32_t* lis,
    int32_t lis_cap, int32_t* lsp, int32_t lsp_cap, uint32_t* words,
    int32_t cap_words, int32_t* stat, void* stream) {
  EncArgs a{t1, t3s, child0, n_lip0, n_lis0, w, 0, 0, 0,
            lip, lip_cap, lis, lis_cap, lsp, lsp_cap, words, stat};
  spiht_encode_kernel<<<1, ENC_B1_THREADS, 0, (cudaStream_t)stream>>>(
      a, max_n, max_bits, capped, lip0, lis0, cap_words);
  return (int)cudaGetLastError();
}

// B7, with B1's arguments.
extern "C" int spiht_encode_seq_launch(
    const int32_t* t1, const int32_t* t3s, const int32_t* child0,
    const int32_t* lip0, int32_t n_lip0, const int32_t* lis0, int32_t n_lis0,
    int32_t w, const int32_t* max_n, int32_t max_bits, int32_t capped,
    int32_t* lip, int32_t lip_cap, int32_t* lis, int32_t lis_cap,
    int32_t* lsp, int32_t lsp_cap, uint32_t* words, int32_t cap_words,
    int32_t* stat, void* stream) {
  EncArgs a{t1, t3s, child0, n_lip0, n_lis0, w, 0, max_bits, capped,
            lip, lip_cap, lis, lis_cap, lsp, lsp_cap, words, stat};
  const int smem = (int)sizeof(SeqRing);
  const cudaError_t e = cudaFuncSetAttribute(
      spiht_encode_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  spiht_encode_seq_kernel<<<1, SEQ_THREADS, smem, (cudaStream_t)stream>>>(
      a, max_n, lip0, lis0, cap_words);
  return (int)cudaGetLastError();
}

extern "C" int spiht_encode_batch_launch(
    int32_t n_streams, const int32_t* t1, const int32_t* t3s,
    const int32_t* child0, const int32_t* lip0, int32_t n_lip0,
    const int32_t* lis0, int32_t n_lis0, int32_t n_cells, int32_t w,
    const int32_t* max_n, const int32_t* max_bits, int32_t* lip,
    int32_t lip_cap, int32_t* lis, int32_t lis_cap, int32_t* lsp,
    int32_t lsp_cap, uint32_t* words, int32_t cap_words, int32_t* stat,
    void* stream) {
  EncBatch g{t1, t3s, child0, lip0, n_lip0, lis0, n_lis0, n_cells, w,
             max_n, max_bits, lip, lip_cap, lis, lis_cap, lsp, lsp_cap,
             words, cap_words, stat};
  spiht_encode_batch_kernel<<<n_streams, ENC_B4_THREADS, 0,
                              (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
