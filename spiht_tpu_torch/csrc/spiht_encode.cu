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
// need be, at max_bits. Bits are written LSB-first into u32 words.
//
// State layout (identical in the plain version, codec/encoder.py):
//   t1[N]     = (M+1) | (D+1)<<5 | (G+1)<<10 | sgn<<15 | hc<<16 | hg<<17
//   t3s[N]    = sgn<<31 | |x|          (sgn = x >= 0)
//   child0[N] = flat index of the first child (children at +0, +1, +w, +w+1)
//   lip[], lsp[] hold node indices; lis[] holds node<<1 | type_A.
//   LIP and LIS are in-place FIFOs: within a pass the retain cursor trails
//   the read cursor, and same-pass appends land at the live tail.
//
// What bounds it on an H100: neither bytes nor arithmetic but the chain of
// decisions, if it is run one entry at a time: one thread's dependent
// loads, ALU latency and branches for every entry (the kernel's time is
// over a thousand times its byte bound; PERF.md, chip_smoke.py).
// The design breaks the chain where the wire format allows. Every bit the
// encoder writes is a function of the maps, so an entry's bits and queue
// appends depend on earlier entries only through offsets. For each chunk
// of up to SPIHT_CHUNK queue entries, the whole block first gathers what
// the entries can need into shared memory (each node's t1/t3s and, for a
// LIS entry, its child0 and its 4 children's t1/t3s); warp 0 then decides
// 32 entries at a time, one per lane, and places their bits and appends
// with warp scans. A group that would cross the bit budget or a queue
// capacity runs entry by entry in lane 0, which stops exactly where the
// sequential machine stops. A chunk of the LIS worklist is the entries
// present when it starts; entries appended while it runs start a later
// chunk, as in the sequential order.

#include "spiht_common.cuh"

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
  int32_t* __restrict__ lip;
  int32_t lip_cap;
  int32_t* __restrict__ lis;
  int32_t lis_cap;
  int32_t* __restrict__ lsp;
  int32_t lsp_cap;
  uint32_t* __restrict__ words;  // zeroed
  int32_t* __restrict__ stat;
};

// One chunk's gathered tables.
struct EncShared {
  int32_t e[SPIHT_CHUNK];      // the queue entry
  int32_t t1[SPIHT_CHUNK];     // t1 of its node
  int32_t t3[SPIHT_CHUNK];     // t3s of its node (LIP, refinement)
  int32_t c0[SPIHT_CHUNK];     // child0 of its node (LIS)
  int32_t ct[4][SPIHT_CHUNK];  // the 4 children's t1 (LIS)
  int32_t cs[4][SPIHT_CHUNK];  // the 4 children's t3s (LIS)
  Published pub;
};

// The machine state, held identically by every lane of warp 0.
struct EncState {
  BitWriter bw;
  int32_t err;
  int32_t lip_n, lis_n, lsp_n;
  int32_t keep;  // retain cursor of the pass in progress
  int32_t off[4];
};

SPIHT_HD int32_t level_m(int32_t t) { return (t & 31) - 1; }
SPIHT_HD int32_t level_d(int32_t t) { return ((t >> 5) & 31) - 1; }
SPIHT_HD int32_t level_g(int32_t t) { return ((t >> 10) & 31) - 1; }

// ---- entry by entry (lane 0): the exact sequential machine ----
// Each returns false when the machine stops (budget spent, or a queue would
// overflow: s.err says which).

SPIHT_HD bool enc_lip_seq(const EncArgs& a, const EncShared& sh, int32_t k0,
                          int32_t k1, int n, EncState& s) {
  for (int32_t k = k0; k < k1; ++k) {
    const uint32_t sig = level_m(sh.t1[k]) >= n;
    if (!put_bit(s.bw, sig)) return false;
    if (sig) {
      if (!put_bit(s.bw, (uint32_t)sh.t3[k] >> 31)) return false;
      if (s.lsp_n >= a.lsp_cap) { s.err = SPIHT_ERR_LSP_CAP; return false; }
      a.lsp[s.lsp_n++] = sh.e[k];
    } else {
      a.lip[s.keep++] = sh.e[k];
    }
  }
  return true;
}

SPIHT_HD bool enc_lis_seq(const EncArgs& a, const EncShared& sh, int32_t k0,
                          int32_t k1, int n, EncState& s) {
  for (int32_t k = k0; k < k1; ++k) {
    const int32_t e = sh.e[k], t = sh.t1[k];
    if (e & 1) {  // type A: any descendant significant?
      const uint32_t dsig = level_d(t) >= n;
      if (!put_bit(s.bw, dsig)) return false;
      if (!dsig) {
        a.lis[s.keep++] = e;
        continue;
      }
      const int32_t c0 = sh.c0[k];
      for (int q = 0; q < 4; ++q) {
        const uint32_t sig = level_m(sh.ct[q][k]) >= n;
        if (!put_bit(s.bw, sig)) return false;
        if (sig) {
          if (!put_bit(s.bw, (uint32_t)sh.cs[q][k] >> 31)) return false;
          if (s.lsp_n >= a.lsp_cap) { s.err = SPIHT_ERR_LSP_CAP; return false; }
          a.lsp[s.lsp_n++] = c0 + s.off[q];
        } else {
          if (s.lip_n >= a.lip_cap) { s.err = SPIHT_ERR_LIP_CAP; return false; }
          a.lip[s.lip_n++] = c0 + s.off[q];
        }
      }
      if ((t >> 17) & 1) {  // has grandchildren: re-append as type B
        if (s.lis_n >= a.lis_cap) { s.err = SPIHT_ERR_LIS_CAP; return false; }
        a.lis[s.lis_n++] = e & ~1;
      }
    } else {  // type B: any grandchild subtree significant?
      const uint32_t lsig = level_g(t) >= n;
      if (!put_bit(s.bw, lsig)) return false;
      if (!lsig) {
        a.lis[s.keep++] = e;
        continue;
      }
      const int32_t c0 = sh.c0[k];
      if (s.lis_n + 4 > a.lis_cap) { s.err = SPIHT_ERR_LIS_CAP; return false; }
      for (int q = 0; q < 4; ++q) a.lis[s.lis_n++] = ((c0 + s.off[q]) << 1) | 1;
    }
  }
  return true;
}

// Run [k0, k1) entry by entry in lane 0 and hand its state to the warp.
template <class F>
SPIHT_HD bool enc_seq_group(int lane, EncState& s, F run) {
  int ok = 1;
  if (lane == 0) ok = run();
  ok = WARP_SHFL(lane, ok, 0);
  s.bw.pos = WARP_SHFL(lane, s.bw.pos, 0);
  s.err = WARP_SHFL(lane, s.err, 0);
  s.lip_n = WARP_SHFL(lane, s.lip_n, 0);
  s.lis_n = WARP_SHFL(lane, s.lis_n, 0);
  s.lsp_n = WARP_SHFL(lane, s.lsp_n, 0);
  s.keep = WARP_SHFL(lane, s.keep, 0);
  return ok;
}

// ---- 32 entries at a time (warp 0, one entry per lane) ----

SPIHT_HD bool enc_lip_chunk(const EncArgs& a, const EncShared& sh, int32_t m,
                            int n, EncState& s, int lane) {
  const uint32_t lt = (1u << lane) - 1;
  for (int32_t g = 0; g < m; g += SPIHT_WARP) {
    const int32_t k = g + lane;
    const bool valid = k < m;
    const bool sig = valid && level_m(sh.t1[k]) >= n;
    const uint32_t vmask = WARP_BALLOT(lane, valid);
    const uint32_t smask = WARP_BALLOT(lane, sig);
    const int32_t nsig = POPC(smask), nbits = POPC(vmask) + nsig;
    if (s.bw.pos + nbits > s.bw.limit || s.lsp_n + nsig > a.lsp_cap) {
      const int32_t k1 = g + POPC(vmask);
      if (!enc_seq_group(lane, s, [&] { return enc_lip_seq(a, sh, g, k1, n, s); }))
        return false;
      continue;
    }
    if (sig) {  // bits 1, sign at lane + (significant lanes before it)
      const int32_t before = POPC(smask & lt);
      or_bits(s.bw.words, s.bw.pos + lane + before,
              1u | (((uint32_t)sh.t3[k] >> 31) << 1), 2);
      a.lsp[s.lsp_n + before] = sh.e[k];
    } else if (valid) {
      a.lip[s.keep + POPC(vmask & ~smask & lt)] = sh.e[k];
    }
    s.bw.pos += nbits;
    s.lsp_n += nsig;
    s.keep += POPC(vmask & ~smask);
  }
  return true;
}

SPIHT_HD bool enc_lis_chunk(const EncArgs& a, const EncShared& sh, int32_t m,
                            int n, EncState& s, int lane) {
  const uint32_t lt = (1u << lane) - 1;
  for (int32_t g = 0; g < m; g += SPIHT_WARP) {
    const int32_t k = g + lane;
    const bool valid = k < m;
    const int32_t e = valid ? sh.e[k] : 0, t = valid ? sh.t1[k] : 0;
    const bool is_a = e & 1;
    const bool fire = valid && (is_a ? level_d(t) >= n : level_g(t) >= n);
    const bool fire_a = fire && is_a;
    // this entry's bits, its appends, and whether it is retained
    uint32_t bits = fire;
    int32_t nb = valid ? 1 : 0, n_lsp = 0, n_lis = 0;
    uint32_t sigs = 0;  // bit q: child q significant (A fire)
    if (fire_a) {
      for (int q = 0; q < 4; ++q) {
        const uint32_t sig = level_m(sh.ct[q][k]) >= n;
        bits |= sig << nb++;
        if (sig) {
          bits |= ((uint32_t)sh.cs[q][k] >> 31) << nb++;
          sigs |= 1u << q;
        }
      }
      n_lsp = POPC(sigs);
      n_lis = (t >> 17) & 1;
    } else if (fire) {
      n_lis = 4;
    }
    // one scan of the packed counts: nb | n_lsp << 9 | n_lis << 17 | fire_a << 25
    // (warp totals fit their fields: 288 bits, 128 appends, 32 A fires)
    const int32_t v = nb | (n_lsp << 9) | (n_lis << 17) | ((int32_t)fire_a << 25);
    const int32_t incl = warp_scan(lane, v), excl = incl - v;
    const int32_t tot = WARP_SHFL(lane, incl, 31);
    const int32_t t_nb = tot & 511, t_lsp = (tot >> 9) & 255;
    const int32_t t_lis = (tot >> 17) & 255, t_lip = 4 * ((tot >> 25) & 127) - t_lsp;
    const uint32_t vmask = WARP_BALLOT(lane, valid);
    const uint32_t kmask = WARP_BALLOT(lane, valid && !fire);  // retained
    if (s.bw.pos + t_nb > s.bw.limit || s.lsp_n + t_lsp > a.lsp_cap ||
        s.lip_n + t_lip > a.lip_cap || s.lis_n + t_lis > a.lis_cap) {
      const int32_t k1 = g + POPC(vmask);
      if (!enc_seq_group(lane, s, [&] { return enc_lis_seq(a, sh, g, k1, n, s); }))
        return false;
      continue;
    }
    if (valid) {
      or_bits(s.bw.words, s.bw.pos + (excl & 511), bits, nb);
      if (!fire) {
        a.lis[s.keep + POPC(kmask & lt)] = e;
      } else if (fire_a) {
        const int32_t c0 = sh.c0[k];
        int32_t ls = s.lsp_n + ((excl >> 9) & 255);
        int32_t li = s.lip_n + 4 * ((excl >> 25) & 127) - ((excl >> 9) & 255);
        for (int q = 0; q < 4; ++q) {
          if ((sigs >> q) & 1) {
            a.lsp[ls++] = c0 + s.off[q];
          } else {
            a.lip[li++] = c0 + s.off[q];
          }
        }
        if (n_lis) a.lis[s.lis_n + ((excl >> 17) & 255)] = e & ~1;
      } else {
        const int32_t c0 = sh.c0[k], at = s.lis_n + ((excl >> 17) & 255);
        for (int q = 0; q < 4; ++q) a.lis[at + q] = ((c0 + s.off[q]) << 1) | 1;
      }
    }
    s.bw.pos += t_nb;
    s.lsp_n += t_lsp;
    s.lip_n += t_lip;
    s.lis_n += t_lis;
    s.keep += POPC(kmask);
  }
  return true;
}

SPIHT_HD bool enc_ref_chunk(const EncShared& sh, int32_t m, int n,
                            EncState& s, int lane) {
  for (int32_t g = 0; g < m; g += SPIHT_WARP) {
    const int32_t k = g + lane;
    const bool bit = k < m && (((sh.t3[k] & 0x7FFFFFFF) >> n) & 1);
    const uint32_t word = WARP_BALLOT(lane, bit);
    int32_t cnt = m - g < SPIHT_WARP ? m - g : SPIHT_WARP;
    const bool cut = s.bw.pos + cnt > s.bw.limit;
    if (cut) cnt = s.bw.limit - s.bw.pos;
    if (lane == 0 && cnt > 0) {
      or_bits(s.bw.words, s.bw.pos,
              cnt == 32 ? word : word & ((1u << cnt) - 1), cnt);
    }
    s.bw.pos += cnt;
    if (cut) return false;
  }
  return true;
}

// The machine, run by every thread of the block (tid in [0, nt), nt a
// multiple of 32); lip/lis hold their initial entries on entry.
SPIHT_HD void encode_machine(const EncArgs& a, EncShared& sh, int tid,
                             int nt) {
  EncState s{BitWriter{a.words, 0, a.max_bits}, SPIHT_OK,
             a.n_lip0, a.n_lis0, 0, 0, {0, 1, a.w, a.w + 1}};
  const bool warp0 = tid < SPIHT_WARP;
  if (tid == 0) sh.pub = Published{s.lip_n, s.lis_n, 0, 0};
  SPIHT_SYNC();

  for (int n = a.max_n; n >= 0; --n) {
    const int32_t lip_len = sh.pub.lip_n, lsp_snap = sh.pub.lsp_n;

    // ---- LIP pass ----
    s.keep = 0;
    for (int32_t r0 = 0; r0 < lip_len; r0 += SPIHT_CHUNK) {
      const int32_t m = min32(SPIHT_CHUNK, lip_len - r0);
      for (int32_t i = tid; i < m; i += nt) {
        const int32_t node = a.lip[r0 + i];
        sh.e[i] = node;
        sh.t1[i] = a.t1[node];
        sh.t3[i] = a.t3s[node];
      }
      SPIHT_SYNC();
      if (warp0 && !enc_lip_chunk(a, sh, m, n, s, tid) && tid == 0)
        sh.pub.stop = 1;
      SPIHT_SYNC();
      if (sh.pub.stop) goto out;
    }
    s.lip_n = s.keep;

    // ---- LIS pass (worklist: entries appended now are visited now) ----
    s.keep = 0;
    for (int32_t r0 = 0;;) {
      const int32_t lis_len = sh.pub.lis_n;
      if (r0 >= lis_len) break;
      const int32_t m = min32(SPIHT_CHUNK, lis_len - r0);
      for (int32_t i = tid; i < m; i += nt) {
        const int32_t e = a.lis[r0 + i], node = e >> 1, t = a.t1[node];
        sh.e[i] = e;
        sh.t1[i] = t;
        if ((t >> 16) & 1) {  // has children: fetch what a fire needs
          const int32_t c0 = a.child0[node];
          sh.c0[i] = c0;
          for (int q = 0; q < 4; ++q) {
            sh.ct[q][i] = a.t1[c0 + s.off[q]];
            sh.cs[q][i] = a.t3s[c0 + s.off[q]];
          }
        }
      }
      SPIHT_SYNC();
      if (warp0) {
        const bool ok = enc_lis_chunk(a, sh, m, n, s, tid);
        if (tid == 0) {
          if (!ok) sh.pub.stop = 1;
          sh.pub.lis_n = s.lis_n;
        }
      }
      SPIHT_SYNC();
      if (sh.pub.stop) goto out;
      r0 += m;
    }
    SPIHT_SYNC();  // every thread has read pub.lis_n for the last time
    s.lis_n = s.keep;
    if (tid == 0) sh.pub.lis_n = s.lis_n;

    // ---- refinement of the entries significant before this plane ----
    for (int32_t r0 = 0; r0 < lsp_snap; r0 += SPIHT_CHUNK) {
      const int32_t m = min32(SPIHT_CHUNK, lsp_snap - r0);
      for (int32_t i = tid; i < m; i += nt) sh.t3[i] = a.t3s[a.lsp[r0 + i]];
      SPIHT_SYNC();
      if (warp0 && !enc_ref_chunk(sh, m, n, s, tid) && tid == 0)
        sh.pub.stop = 1;
      SPIHT_SYNC();
      if (sh.pub.stop) goto out;
    }
    if (tid == 0) {
      sh.pub.lip_n = s.lip_n;
      sh.pub.lsp_n = s.lsp_n;
    }
    SPIHT_SYNC();
  }

out:
  if (tid != 0) return;
  // a put_bit refused: the budget is spent (or a queue overflowed)
  if (sh.pub.stop && s.err == SPIHT_OK && a.capped) s.err = SPIHT_ERR_STREAM_CAP;
  a.stat[0] = s.bw.pos;
  a.stat[1] = s.err;
  a.stat[2] = s.lip_n;
  a.stat[3] = s.lis_n;
  a.stat[4] = s.lsp_n;
  a.stat[5] = 0;
}

// Zero the stream and load the initial queues, by every thread of the
// block; a barrier must follow before the machine starts.
SPIHT_HD void enc_prologue(const EncArgs& a, const int32_t* lip0,
                           const int32_t* lis0, int32_t cap_words, int tid,
                           int nt) {
  for (int32_t i = tid; i < cap_words; i += nt) a.words[i] = 0u;
  for (int32_t i = tid; i < a.n_lip0; i += nt) a.lip[i] = lip0[i];
  for (int32_t i = tid; i < a.n_lis0; i += nt) a.lis[i] = lis0[i];
}

// ---- kernel B7: the sequential machine, one entry per iteration ----
//
// Replaces spiht_tpu/codec/pallas_encoder.py:_seq_fn (the encoder that
// pallas_encode_fn runs for machine="seq"). It computes B1's function on
// B1's own tables and queues (EncArgs), with the same exact mid-symbol
// max_bits cut and the same stat words, one queue entry at a time in one
// thread, straight from global memory.
//
// What bounds it on an H100: the one thread's chain of dependent loads
// (entry -> t1 -> child0 -> the children's t1/t3s) and branches, a few
// hundred cycles an entry; bytes and arithmetic are a thousandth of that.
// The design does nothing about it on purpose: it is the simple machine,
// kept as the reference point for B1's warp-parallel one.

// One LIS entry of plane n, as the sequential machine runs it (appends at
// the live tails, retention at s.keep). False when the machine stops.
SPIHT_HD bool enc_seq_lis_entry(const EncArgs& a, int32_t e, int n,
                                EncState& s) {
  const int32_t node = e >> 1, t = a.t1[node];
  if (e & 1) {  // type A: any descendant significant?
    const uint32_t dsig = level_d(t) >= n;
    if (!put_bit(s.bw, dsig)) return false;
    if (!dsig) {
      a.lis[s.keep++] = e;
      return true;
    }
    const int32_t c0 = a.child0[node];
    for (int q = 0; q < 4; ++q) {
      const int32_t ch = c0 + s.off[q];
      const uint32_t sig = level_m(a.t1[ch]) >= n;
      if (!put_bit(s.bw, sig)) return false;
      if (sig) {
        if (!put_bit(s.bw, (uint32_t)a.t3s[ch] >> 31)) return false;
        if (s.lsp_n >= a.lsp_cap) { s.err = SPIHT_ERR_LSP_CAP; return false; }
        a.lsp[s.lsp_n++] = ch;
      } else {
        if (s.lip_n >= a.lip_cap) { s.err = SPIHT_ERR_LIP_CAP; return false; }
        a.lip[s.lip_n++] = ch;
      }
    }
    if ((t >> 17) & 1) {  // has grandchildren: re-append as type B
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
  const int32_t c0 = a.child0[node];
  if (s.lis_n + 4 > a.lis_cap) { s.err = SPIHT_ERR_LIS_CAP; return false; }
  for (int q = 0; q < 4; ++q) a.lis[s.lis_n++] = ((c0 + s.off[q]) << 1) | 1;
  return true;
}

// Every plane from max_n down; false when the machine stops.
SPIHT_HD bool enc_seq_planes(const EncArgs& a, EncState& s) {
  for (int n = a.max_n; n >= 0; --n) {
    const int32_t lsp_snap = s.lsp_n;
    s.keep = 0;  // ---- LIP pass ----
    for (int32_t r = 0; r < s.lip_n; ++r) {
      const int32_t node = a.lip[r];
      const uint32_t sig = level_m(a.t1[node]) >= n;
      if (!put_bit(s.bw, sig)) return false;
      if (sig) {
        if (!put_bit(s.bw, (uint32_t)a.t3s[node] >> 31)) return false;
        if (s.lsp_n >= a.lsp_cap) { s.err = SPIHT_ERR_LSP_CAP; return false; }
        a.lsp[s.lsp_n++] = node;
      } else {
        a.lip[s.keep++] = node;
      }
    }
    s.lip_n = s.keep;
    s.keep = 0;  // ---- LIS pass (worklist: appends are visited now) ----
    for (int32_t r = 0; r < s.lis_n; ++r)
      if (!enc_seq_lis_entry(a, a.lis[r], n, s)) return false;
    s.lis_n = s.keep;
    for (int32_t r = 0; r < lsp_snap; ++r)  // ---- refinement ----
      if (!put_bit(s.bw, ((a.t3s[a.lsp[r]] & 0x7FFFFFFF) >> n) & 1)) return false;
  }
  return true;
}

// The sequential machine in one thread; lip/lis hold their initial entries
// and the word buffer is zeroed on entry.
SPIHT_HD void encode_seq_machine(const EncArgs& a) {
  EncState s{BitWriter{a.words, 0, a.max_bits}, SPIHT_OK,
             a.n_lip0, a.n_lis0, 0, 0, {0, 1, a.w, a.w + 1}};
  // a put_bit refused: the budget is spent (or a queue overflowed)
  if (!enc_seq_planes(a, s) && s.err == SPIHT_OK && a.capped)
    s.err = SPIHT_ERR_STREAM_CAP;
  a.stat[0] = s.bw.pos;
  a.stat[1] = s.err;
  a.stat[2] = s.lip_n;
  a.stat[3] = s.lis_n;
  a.stat[4] = s.lsp_n;
  a.stat[5] = 0;
}

// ---- kernel B4: B streams in one launch, one block per stream ----
//
// Replaces spiht_tpu/codec/pallas_encoder.py:_interleaved_fn, which stepped
// B chains in lockstep on one TPU core, finished chains inert. Here each
// chain is one block of the grid: block b builds stream b's EncArgs
// (enc_stream_args) and runs the machine above, so every stream is
// byte-identical to B1's on the same coefficients.
//
// What bounds it on an H100: per stream the same dependent chain as B1;
// across streams, how many blocks the SMs hold at once. EncShared is about
// 24 KB, so eight blocks of SPIHT_THREADS fit on an SM and up to ~1000
// streams run in one wave on the 132 SMs. The design adds nothing to the
// machine: it spreads the streams over the SMs, with the geometry tables
// (child0, the initial queues) shared and read through L2.
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
  int32_t* lis;             // (B, queue_stride(lis_cap))
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
                 g.lis + b * queue_stride(g.lis_cap), g.lis_cap,
                 g.lsp + b * queue_stride(g.lsp_cap), g.lsp_cap,
                 g.words + (int64_t)b * g.cap_words,
                 g.stat + (int64_t)b * SPIHT_STAT_LEN};
}

// Stream b's whole block: prologue, barrier, machine (run by the kernel
// with b = blockIdx.x, and by the host build once per stream).
SPIHT_HD void encode_stream(const EncBatch& g, int32_t b, EncShared& sh,
                            int tid, int nt) {
  const EncArgs a = enc_stream_args(g, b);
  enc_prologue(a, g.lip0, g.lis0, g.cap_words, tid, nt);
  SPIHT_SYNC();
  encode_machine(a, sh, tid, nt);
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

__global__ void __launch_bounds__(SPIHT_THREADS)
spiht_encode_kernel(EncArgs a, const int32_t* __restrict__ max_n,
                    const int32_t* __restrict__ lip0,
                    const int32_t* __restrict__ lis0, int32_t cap_words) {
  __shared__ EncShared sh;
  enc_prologue(a, lip0, lis0, cap_words, threadIdx.x, blockDim.x);
  a.max_n = *max_n;  // computed on the device: read here, no host sync
  __syncthreads();
  encode_machine(a, sh, threadIdx.x, blockDim.x);
}

// B7: the block zeroes the stream and loads the queues, thread 0 encodes.
__global__ void __launch_bounds__(SPIHT_THREADS)
spiht_encode_seq_kernel(EncArgs a, const int32_t* __restrict__ max_n,
                        const int32_t* __restrict__ lip0,
                        const int32_t* __restrict__ lis0, int32_t cap_words) {
  enc_prologue(a, lip0, lis0, cap_words, threadIdx.x, blockDim.x);
  a.max_n = *max_n;
  __syncthreads();
  if (threadIdx.x == 0) encode_seq_machine(a);
}

__global__ void __launch_bounds__(SPIHT_THREADS)
spiht_encode_batch_kernel(EncBatch g) {
  __shared__ EncShared sh;
  encode_stream(g, blockIdx.x, sh, threadIdx.x, blockDim.x);
}

extern "C" int spiht_encode_launch(
    const int32_t* t1, const int32_t* t3s, const int32_t* child0,
    const int32_t* lip0, int32_t n_lip0, const int32_t* lis0, int32_t n_lis0,
    int32_t w, const int32_t* max_n, int32_t max_bits, int32_t capped,
    int32_t* lip, int32_t lip_cap, int32_t* lis, int32_t lis_cap,
    int32_t* lsp, int32_t lsp_cap, uint32_t* words, int32_t cap_words,
    int32_t* stat, void* stream) {
  EncArgs a{t1, t3s, child0, n_lip0, n_lis0, w, 0, max_bits, capped,
            lip, lip_cap, lis, lis_cap, lsp, lsp_cap, words, stat};
  spiht_encode_kernel<<<1, SPIHT_THREADS, 0, (cudaStream_t)stream>>>(
      a, max_n, lip0, lis0, cap_words);
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
  spiht_encode_seq_kernel<<<1, SPIHT_THREADS, 0, (cudaStream_t)stream>>>(
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
  spiht_encode_batch_kernel<<<n_streams, SPIHT_THREADS, 0,
                              (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
