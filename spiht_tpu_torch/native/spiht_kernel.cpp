// spiht_kernel.cpp — native SPIHT bitstream scheduling kernel.
//
// The TPU framework splits SPIHT into (a) data-parallel significance
// analysis (descendant-max "level map" pyramids, computed either here in
// O(N) or on TPU via JAX for batched/huge inputs) and (b) the inherently
// serial bit-ordering pass, implemented here as a tight O(bits) loop with
// no tree recursion. A reference-style recursive encoder is also provided
// as the single-core baseline for benchmarking (same algorithmic shape as
// the reference core at src/encoder_decoder.rs:155-303, independently
// implemented).
//
// Bitstream semantics follow SURVEY.md §3 exactly: LIP/LIS/LSP scheduling,
// channel-innermost list init, same-pass LIS worklist, lsp_len snapshot,
// f32-truncated log2 max_n, exact max_bits cut, LSB-first byte packing,
// 1.5*2^n reconstruction and sign-preserving refinement on decode.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 (see build.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <thread>
#include <atomic>

extern "C" {

// ---------------------------------------------------------------------------
// Bit output (LSB-first within each byte), growable.
// ---------------------------------------------------------------------------
struct BitWriter {
    std::vector<uint8_t> buf;
    long long nbits = 0;
    inline void push(bool b) {
        const long long byte = nbits >> 3;
        if ((size_t)byte >= buf.size()) buf.push_back(0);
        if (b) buf[byte] |= (uint8_t)(1u << (nbits & 7));
        nbits++;
    }
};

struct BitReader {
    const uint8_t* data;
    long long nbits;
    long long pos = 0;
    inline bool done() const { return pos >= nbits; }
    inline bool pop() {
        const bool b = (data[pos >> 3] >> (pos & 7)) & 1u;
        pos++;
        return b;
    }
};

// ---------------------------------------------------------------------------
// Tree geometry (SURVEY.md §3.4)
// ---------------------------------------------------------------------------
struct Geo {
    int h, w, ll_h, ll_w;
};

// Returns number of offspring (0 or 4) and writes their (i,j) pairs.
static inline int offspring(const Geo& g, int i, int j, int out[8]) {
    if (i < g.ll_h && j < g.ll_w) {
        if ((i & 1) == 0 && (j & 1) == 0) return 0;
        const int bi = (i >> 1) << 1, bj = (j >> 1) << 1;
        const int oi = (i & 1) * g.ll_h + bi;
        const int oj = (j & 1) * g.ll_w + bj;
        out[0] = oi;     out[1] = oj;
        out[2] = oi;     out[3] = oj + 1;
        out[4] = oi + 1; out[5] = oj;
        out[6] = oi + 1; out[7] = oj + 1;
        return 4;
    }
    if (2 * i + 1 >= g.h || 2 * j + 1 >= g.w) return 0;
    out[0] = 2 * i;     out[1] = 2 * j;
    out[2] = 2 * i;     out[3] = 2 * j + 1;
    out[4] = 2 * i + 1; out[5] = 2 * j;
    out[6] = 2 * i + 1; out[7] = 2 * j + 1;
    return 4;
}

static inline bool has_grandchildren(const Geo& g, int i, int j) {
    return (i * 2 + 1) * 2 + 1 < g.h && (j * 2 + 1) * 2 + 1 < g.w;
}

// ---------------------------------------------------------------------------
// Significance level maps.
//   M[k,i,j] = floor(log2(|x|)) (or -1 if x == 0)       element level
//   D[k,i,j] = max over all strict descendants of M     desc-sig level
//   G[k,i,j] = max over children of D                   l-sig (grandchild) lvl
// D/G computed bottom-up in O(N): iterating i,j descending guarantees
// children (at 2i.., or the LL parity-mapped block) are already final.
// ---------------------------------------------------------------------------
static inline int8_t msb_level(int32_t x) {
    const uint32_t a = (uint32_t)(x < 0 ? -(int64_t)x : x);
    return a == 0 ? (int8_t)-1 : (int8_t)(31 - __builtin_clz(a));
}

void spiht_compute_maps(const int32_t* arr, int c, int h, int w,
                        int ll_h, int ll_w,
                        int8_t* M, int8_t* D, int8_t* G) {
    const Geo g{h, w, ll_h, ll_w};
    const long long plane = (long long)h * w;
    for (int k = 0; k < c; k++) {
        const int32_t* a = arr + k * plane;
        int8_t* m = M + k * plane;
        int8_t* d = D + k * plane;
        int8_t* gg = G + k * plane;
        for (long long t = 0; t < plane; t++) m[t] = msb_level(a[t]);
        int off[8];
        // Rows i >= ll_h use the generic child rule (2i, 2i+1) only, and
        // both child rows are strictly below in iteration order — so the
        // whole row reduces to pairwise-max downsampling of the child
        // rows, vectorizable. The LL-parity rows (i < ll_h) keep the
        // scalar descending-j walk (same-row references resolve in-order).
        for (int i = h - 1; i >= ll_h; i--) {
            int8_t* drow = d + (long long)i * w;
            int8_t* grow = gg + (long long)i * w;
            if (2 * i + 1 >= h) {
                std::memset(drow, 0xff, w);  // -1: no children
                std::memset(grow, 0xff, w);
                continue;
            }
            const int8_t* m0 = m + (long long)(2 * i) * w;
            const int8_t* d0 = d + (long long)(2 * i) * w;
            const int8_t* m1 = m0 + w;
            const int8_t* d1 = d0 + w;
            const int jmax = w / 2;  // cells with 2j+1 < w
            for (int j = 0; j < jmax; j++) {
                const int8_t a0 = std::max(std::max(m0[2 * j], d0[2 * j]),
                                           std::max(m0[2 * j + 1], d0[2 * j + 1]));
                const int8_t a1 = std::max(std::max(m1[2 * j], d1[2 * j]),
                                           std::max(m1[2 * j + 1], d1[2 * j + 1]));
                drow[j] = std::max(a0, a1);
                grow[j] = std::max(std::max(d0[2 * j], d0[2 * j + 1]),
                                   std::max(d1[2 * j], d1[2 * j + 1]));
            }
            for (int j = jmax; j < w; j++) {
                drow[j] = -1;
                grow[j] = -1;
            }
        }
        for (int i = (ll_h < h ? ll_h : h) - 1; i >= 0; i--) {
            for (int j = w - 1; j >= 0; j--) {
                const int n = offspring(g, i, j, off);
                int8_t dv = -1, gv = -1;
                for (int q = 0; q < n; q++) {
                    const long long ci = (long long)off[2 * q] * w + off[2 * q + 1];
                    const int8_t cm = m[ci] > d[ci] ? m[ci] : d[ci];
                    if (cm > dv) dv = cm;
                    if (d[ci] > gv) gv = d[ci];
                }
                d[(long long)i * w + j] = dv;
                gg[(long long)i * w + j] = gv;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// max_n: (max_abs as f32).log2() truncated (reference hazard #2)
// ---------------------------------------------------------------------------
static int compute_max_n(const int32_t* arr, long long n) {
    uint32_t umx = 0;
    for (long long t = 0; t < n; t++) {
        const int32_t x = arr[t];
        const uint32_t a = x < 0 ? 0u - (uint32_t)x : (uint32_t)x;
        umx = a > umx ? a : umx;
    }
    const int64_t mx = (int64_t)umx;
    if (mx <= 0) return 0;
    const float lg = std::log2f((float)mx);
    if (lg < 0.f) return 0;
    int v = (int)lg;
    return v > 255 ? 255 : v;
}

// ---------------------------------------------------------------------------
// List entries. (k,i,j) packed into 64 bits; filter/depth carried for the
// metadata decoder.
// ---------------------------------------------------------------------------
struct Entry {
    int32_t i, j;
    int16_t k;
    int8_t filter;  // 0 ll, 1 da, 2 ad, 3 dd
    int8_t depth;
};

static inline int8_t offspring_filter(int8_t filt, int i, int j) {
    if (filt != 0) return filt;
    if ((i & 1) == 1 && (j & 1) == 1) return 3;  // dd
    if ((i & 1) == 0 && (j & 1) != 0) return 2;  // ad
    return 1;                                     // da
}

// ---------------------------------------------------------------------------
// Recursive significance tests (baseline encoder only) — explicit stack DFS.
// ---------------------------------------------------------------------------
static bool set_sig_recursive(const int32_t* a, const Geo& g, int w, int i0,
                              int j0, int32_t thresh) {
    int stack[4096];
    int sp = 0;
    stack[sp++] = i0;
    stack[sp++] = j0;
    int off[8];
    while (sp) {
        const int j = stack[--sp];
        const int i = stack[--sp];
        int64_t v = a[(long long)i * w + j];
        if (v < 0) v = -v;
        if (v >= thresh) return true;
        const int n = offspring(g, i, j, off);
        for (int q = 0; q < n; q++) {
            stack[sp++] = off[2 * q];
            stack[sp++] = off[2 * q + 1];
        }
    }
    return false;
}

// ---------------------------------------------------------------------------
// Word-based bit output (LSB-first): bit t of the stream is bit t%64 of
// words[t/64]; little-endian byte copy yields exactly the reference's
// LSB-first-per-byte wire format.
// ---------------------------------------------------------------------------
struct BitWriter64 {
    std::vector<uint64_t> words;
    uint64_t cur = 0;
    long long nbits = 0;
    inline void push(bool b) {
        cur |= (uint64_t)b << (nbits & 63);
        if (((++nbits) & 63) == 0) {
            words.push_back(cur);
            cur = 0;
        }
    }
    void copy_out(uint8_t* dst) const {
        const long long nbytes = (nbits + 7) / 8;
        const long long full = (long long)words.size() * 8;
        const long long head = nbytes < full ? nbytes : full;
        std::memcpy(dst, words.data(), head);
        if (nbytes > full) std::memcpy(dst + full, &cur, nbytes - full);
    }
};

// ---------------------------------------------------------------------------
// Map-driven scheduling fast path. Identical wire format/list semantics to
// the generic loop below (fuzzed against it and the oracle); the layout
// insight is that the encoder never needs a LIP entry's POSITION — only
// its value (sig test, sign, refinement magnitude) — so LIP is a flat
// int32 value stream and LSP a flat magnitude stream, making the LIP and
// refinement passes branch-light sequential scans with no random memory
// access. Only the LIS worklist still gathers (D/G maps, child values).
// ---------------------------------------------------------------------------
static int encode_fast(const int32_t* arr, int c, int h, int w, int ll_h,
                       int ll_w, long long max_bits, const int8_t* M,
                       const int8_t* D, const int8_t* G, int max_n,
                       uint8_t** out_data, long long* out_nbits) {
    const Geo g{h, w, ll_h, ll_w};
    const long long plane = (long long)h * w;

    BitWriter64 bw;
    bw.words.reserve(1 << 12);

    std::vector<int32_t> lip, lip_next;        // coefficient values
    std::vector<uint32_t> lsp;                 // magnitudes
    std::vector<Entry> lis, lis_next;
    std::vector<uint8_t> lis_type, lis_type_next;  // 1 = A, 0 = B
    lip.reserve(2 * (size_t)c * ll_h * ll_w);
    for (int i = 0; i < ll_h; i++)
        for (int j = 0; j < ll_w; j++)
            for (int k = 0; k < c; k++)
                lip.push_back(arr[(long long)k * plane + (long long)i * w + j]);
    for (int i = 0; i < ll_h; i++)
        for (int j = 0; j < ll_w; j++) {
            if ((i & 1) == 0 && (j & 1) == 0) continue;
            for (int k = 0; k < c; k++) {
                lis.push_back({i, j, (int16_t)k, 0, 0});
                lis_type.push_back(1);
            }
        }

    #define PUSH_BIT(b)                                                     \
        do {                                                                \
            bw.push(b);                                                     \
            if (bw.nbits == max_bits) goto finish;                          \
        } while (0)

    {
        int n = max_n;
        int off[8];
        for (;;) {
            const size_t lsp_len = lsp.size();
            const uint32_t thresh = 1u << n;

            // --- LIP pass: sequential scan over values ---
            lip_next.clear();
            for (const int32_t x : lip) {
                const uint32_t mag = (uint32_t)(x < 0 ? -(int64_t)x : x);
                const bool sig = mag >= thresh;
                PUSH_BIT(sig);
                if (sig) {
                    lsp.push_back(mag);
                    PUSH_BIT(x >= 0);
                } else {
                    lip_next.push_back(x);
                }
            }
            std::swap(lip, lip_next);

            // --- LIS worklist pass ---
            lis_next.clear();
            lis_type_next.clear();
            for (size_t qi = 0; qi < lis.size(); qi++) {
                const Entry e = lis[qi];
                const long long idx =
                    (long long)e.k * plane + (long long)e.i * w + e.j;
                if (lis_type[qi]) {
                    const bool desc_sig = D[idx] >= n;
                    PUSH_BIT(desc_sig);
                    if (desc_sig) {
                        const int nn = offspring(g, e.i, e.j, off);
                        for (int q = 0; q < nn; q++) {
                            const long long cidx = (long long)e.k * plane +
                                (long long)off[2 * q] * w + off[2 * q + 1];
                            const int32_t x = arr[cidx];
                            const uint32_t mag =
                                (uint32_t)(x < 0 ? -(int64_t)x : x);
                            const bool sig = mag >= thresh;
                            PUSH_BIT(sig);
                            if (sig) {
                                lsp.push_back(mag);
                                PUSH_BIT(x >= 0);
                            } else {
                                lip.push_back(x);
                            }
                        }
                        if (has_grandchildren(g, e.i, e.j)) {
                            lis.push_back(e);
                            lis_type.push_back(0);
                        }
                    } else {
                        lis_next.push_back(e);
                        lis_type_next.push_back(1);
                    }
                } else {
                    const bool l_sig = G[idx] >= n;
                    PUSH_BIT(l_sig);
                    if (l_sig) {
                        const int nn = offspring(g, e.i, e.j, off);
                        for (int q = 0; q < nn; q++) {
                            lis.push_back({off[2 * q], off[2 * q + 1], e.k, 0, 0});
                            lis_type.push_back(1);
                        }
                    } else {
                        lis_next.push_back(e);
                        lis_type_next.push_back(0);
                    }
                }
            }
            std::swap(lis, lis_next);
            std::swap(lis_type, lis_type_next);

            // --- refinement: sequential scan over magnitudes ---
            for (size_t t = 0; t < lsp_len; t++)
                PUSH_BIT((lsp[t] >> n) & 1);

            if (n == 0) break;
            n--;
        }
    }

finish:
    *out_nbits = bw.nbits;
    const long long nbytes = (bw.nbits + 7) / 8;
    uint8_t* out = (uint8_t*)std::malloc(nbytes > 0 ? nbytes : 1);
    bw.copy_out(out);
    *out_data = out;
    return 0;
    #undef PUSH_BIT
}

// ---------------------------------------------------------------------------
// Encoder. use_maps: 0 = reference-style recursion (baseline),
//                    1 = level-map driven (fast path).
// Maps may be passed in (e.g. computed on TPU); pass null to compute here.
// ---------------------------------------------------------------------------
// forced_max_n: -1 = compute from the array (reference f32-log2 rule);
// >= 0 = use the given starting plane (callers that narrowed the array to
// its live magnitude bits must pass the original max_n, since the f32
// rule can differ on the masked values).
int spiht_encode(const int32_t* arr, int c, int h, int w, int ll_h, int ll_w,
                 long long max_bits, int use_maps,
                 const int8_t* M_in, const int8_t* D_in, const int8_t* G_in,
                 int forced_max_n,
                 uint8_t** out_data, long long* out_nbits, int* out_max_n) {
    if (ll_h <= 1 || ll_w <= 1) return -1;
    // LL parity children live at rows/cols up to 2*ll-1; reject geometries
    // (e.g. level-0 "pyramids") where that exceeds the array — the
    // reference would panic on the same out-of-bounds index
    if (2 * ll_h > h || 2 * ll_w > w) return -1;
    const Geo g{h, w, ll_h, ll_w};
    const long long plane = (long long)h * w;
    const long long total = (long long)c * plane;

    std::vector<int8_t> Ms, Ds, Gs;
    const int8_t *M = M_in, *D = D_in, *G = G_in;
    if (use_maps && (!M || !D || !G)) {
        Ms.resize(total);
        Ds.resize(total);
        Gs.resize(total);
        spiht_compute_maps(arr, c, h, w, ll_h, ll_w, Ms.data(), Ds.data(), Gs.data());
        M = Ms.data();
        D = Ds.data();
        G = Gs.data();
    }

    const int max_n =
        forced_max_n >= 0 ? forced_max_n : compute_max_n(arr, total);
    *out_max_n = max_n;

    if (use_maps)
        return encode_fast(arr, c, h, w, ll_h, ll_w, max_bits, M, D, G,
                           max_n, out_data, out_nbits);

    BitWriter bw;
    bw.buf.reserve(1 << 16);

    // LIP / LIS / LSP (channel-innermost init, hazard #3)
    std::vector<Entry> lip, lip_next, lsp, lis, lis_next;
    std::vector<uint8_t> lis_type, lis_type_next;  // 1 = A, 0 = B
    lip.reserve(2 * c * ll_h * ll_w);
    for (int i = 0; i < ll_h; i++)
        for (int j = 0; j < ll_w; j++)
            for (int k = 0; k < c; k++) lip.push_back({i, j, (int16_t)k, 0, 0});
    for (int i = 0; i < ll_h; i++)
        for (int j = 0; j < ll_w; j++) {
            if ((i & 1) == 0 && (j & 1) == 0) continue;
            for (int k = 0; k < c; k++) {
                lis.push_back({i, j, (int16_t)k, 0, 0});
                lis_type.push_back(1);
            }
        }

    #define PUSH_BIT(b)                                                     \
        do {                                                                \
            bw.push(b);                                                     \
            if (bw.nbits == max_bits) goto finish;                          \
        } while (0)

    {
        int n = max_n;
        int off[8];
        for (;;) {
            const size_t lsp_len = lsp.size();
            const int32_t thresh = (int32_t)(1u << n);

            // --- LIP pass ---
            lip_next.clear();
            for (const Entry& e : lip) {
                const long long idx = (long long)e.k * plane + (long long)e.i * w + e.j;
                const int32_t x = arr[idx];
                const bool sig = use_maps ? (M[idx] >= n)
                                          : ((x < 0 ? -(int64_t)x : x) >= thresh);
                PUSH_BIT(sig);
                if (sig) {
                    lsp.push_back(e);
                    PUSH_BIT(x >= 0);
                } else {
                    lip_next.push_back(e);
                }
            }
            std::swap(lip, lip_next);

            // --- LIS worklist pass ---
            lis_next.clear();
            lis_type_next.clear();
            for (size_t qi = 0; qi < lis.size(); qi++) {
                const Entry e = lis[qi];
                const uint8_t tA = lis_type[qi];
                const long long idx = (long long)e.k * plane + (long long)e.i * w + e.j;
                if (tA) {
                    bool desc_sig;
                    if (use_maps) {
                        desc_sig = D[idx] >= n;
                    } else {
                        desc_sig = false;
                        const int nn = offspring(g, e.i, e.j, off);
                        for (int q = 0; q < nn && !desc_sig; q++)
                            desc_sig = set_sig_recursive(
                                arr + (long long)e.k * plane, g, w, off[2 * q],
                                off[2 * q + 1], thresh);
                    }
                    PUSH_BIT(desc_sig);
                    if (desc_sig) {
                        const int nn = offspring(g, e.i, e.j, off);
                        for (int q = 0; q < nn; q++) {
                            const int ci = off[2 * q], cj = off[2 * q + 1];
                            const long long cidx =
                                (long long)e.k * plane + (long long)ci * w + cj;
                            const int32_t x = arr[cidx];
                            const bool sig =
                                use_maps ? (M[cidx] >= n)
                                         : ((x < 0 ? -(int64_t)x : x) >= thresh);
                            PUSH_BIT(sig);
                            if (sig) {
                                lsp.push_back({ci, cj, e.k, 0, 0});
                                PUSH_BIT(x >= 0);
                            } else {
                                lip.push_back({ci, cj, e.k, 0, 0});
                            }
                        }
                        if (has_grandchildren(g, e.i, e.j)) {
                            lis.push_back(e);
                            lis_type.push_back(0);
                        }
                    } else {
                        lis_next.push_back(e);
                        lis_type_next.push_back(1);
                    }
                } else {
                    bool l_sig;
                    if (use_maps) {
                        l_sig = G[idx] >= n;
                    } else {
                        l_sig = false;
                        const int nn = offspring(g, e.i, e.j, off);
                        int off2[8];
                        for (int q = 0; q < nn && !l_sig; q++) {
                            const int nn2 =
                                offspring(g, off[2 * q], off[2 * q + 1], off2);
                            for (int q2 = 0; q2 < nn2 && !l_sig; q2++)
                                l_sig = set_sig_recursive(
                                    arr + (long long)e.k * plane, g, w,
                                    off2[2 * q2], off2[2 * q2 + 1], thresh);
                        }
                    }
                    PUSH_BIT(l_sig);
                    if (l_sig) {
                        const int nn = offspring(g, e.i, e.j, off);
                        for (int q = 0; q < nn; q++) {
                            lis.push_back({off[2 * q], off[2 * q + 1], e.k, 0, 0});
                            lis_type.push_back(1);
                        }
                    } else {
                        lis_next.push_back(e);
                        lis_type_next.push_back(0);
                    }
                }
            }
            std::swap(lis, lis_next);
            std::swap(lis_type, lis_type_next);

            // --- refinement pass (lsp_len snapshot, hazard #5) ---
            for (size_t t = 0; t < lsp_len; t++) {
                const Entry& e = lsp[t];
                const long long idx = (long long)e.k * plane + (long long)e.i * w + e.j;
                int64_t a = arr[idx];
                if (a < 0) a = -a;
                PUSH_BIT((a >> n) & 1);
            }

            if (n == 0) break;
            n--;
        }
    }

finish:
    *out_nbits = bw.nbits;
    const long long nbytes = (bw.nbits + 7) / 8;
    uint8_t* out = (uint8_t*)std::malloc(nbytes > 0 ? nbytes : 1);
    std::memcpy(out, bw.buf.data(), nbytes);
    *out_data = out;
    return 0;
    #undef PUSH_BIT
}

void spiht_free(uint8_t* p) { std::free(p); }

// ---------------------------------------------------------------------------
// Decoder (+ optional metadata trace).
// slices wire format: top = [i_stop, j_stop]; other = flat
// [level][3 filters: da, ad, dd][2 dims][start, stop] int32.
// ---------------------------------------------------------------------------
static inline int32_t set_bit_keep_sign(int32_t x, int n, bool bit) {
    const bool nonneg = x >= 0;
    uint32_t mag = (uint32_t)(nonneg ? x : -(int64_t)x);
    if (bit) mag |= (1u << n); else mag &= ~(1u << n);
    return nonneg ? (int32_t)mag : -(int32_t)mag;
}

struct MetaCtx {
    int32_t* meta;          // (nbits+1) x 8
    long long rows;
    const int32_t* top;     // [2]
    const int32_t* other;   // [level][3][2][2]
    int level;
};

static inline void local_position(const MetaCtx& mc, const Entry& e, int* lh,
                                  int* lw) {
    float fh, fw;
    if (e.depth == mc.level) {
        fh = (float)e.i / (float)mc.top[0];
        fw = (float)e.j / (float)mc.top[1];
    } else {
        const int depth_i = mc.level - 1 - e.depth;
        const int32_t* r = mc.other + ((long long)depth_i * 3 + (e.filter - 1)) * 4;
        fh = ((float)e.i - (float)r[0]) / (float)(r[1] - r[0]);
        fw = ((float)e.j - (float)r[2]) / (float)(r[3] - r[2]);
    }
    *lh = (int)(fh * 200000.f - 100000.f);
    *lw = (int)(fw * 200000.f - 100000.f);
}

// Plain-decode fast path (no metadata trace). Mirrors the generic loop's
// wire semantics exactly, with the same layout insight as encode_fast:
// entries reduce to flat indices (LIP/LSP never need (i,j,filter,depth)
// once metadata is off), halving queue traffic. Values are written to the
// shared rec array in place — NOT per-LSP-entry running values: in
// non-dyadic geometries two LIS parents can own the same child
// (overlapping offspring), so a cell can enter LSP twice, and the oracle
// semantics (encoder_decoder.rs-style in-place refinement) make every
// duplicate's refinement bit land on the one shared cell. Truncation at
// any bit returns the partial reconstruction (reference pop_bit
// semantics).
static int decode_fast(const uint8_t* data, long long nbits, int n_start,
                       int c, int h, int w, int ll_h, int ll_w,
                       int32_t* rec) {
    const Geo g{h, w, ll_h, ll_w};
    const long long plane = (long long)h * w;
    std::memset(rec, 0, sizeof(int32_t) * (long long)c * plane);
    BitReader br{data, nbits};

    std::vector<long long> lip, lip_next;
    std::vector<long long> lsp_idx;
    std::vector<Entry> lis, lis_next;
    std::vector<uint8_t> lis_type, lis_type_next;
    lip.reserve(2 * (size_t)c * ll_h * ll_w);
    for (int i = 0; i < ll_h; i++)
        for (int j = 0; j < ll_w; j++)
            for (int k = 0; k < c; k++)
                lip.push_back((long long)k * plane + (long long)i * w + j);
    for (int i = 0; i < ll_h; i++)
        for (int j = 0; j < ll_w; j++) {
            if ((i & 1) == 0 && (j & 1) == 0) continue;
            for (int k = 0; k < c; k++) {
                lis.push_back({i, j, (int16_t)k, 0, 0});
                lis_type.push_back(1);
            }
        }

    {
        int n = n_start;
        int off[8];
        #define POP_BIT_F(var)                                               \
            bool var;                                                        \
            do {                                                             \
                if (br.done()) return 0;                                     \
                var = br.pop();                                              \
            } while (0)
        for (;;) {
            const size_t lsp_len = lsp_idx.size();
            const int32_t base =
                n == 0 ? 1 : (int32_t)((1u << (n - 1)) + (1u << n));

            lip_next.clear();
            for (const long long idx : lip) {
                POP_BIT_F(sig);
                if (sig) {
                    POP_BIT_F(sbit);
                    rec[idx] = sbit ? base : -base;
                    lsp_idx.push_back(idx);
                } else {
                    lip_next.push_back(idx);
                }
            }
            std::swap(lip, lip_next);

            lis_next.clear();
            lis_type_next.clear();
            for (size_t qi = 0; qi < lis.size(); qi++) {
                const Entry e = lis[qi];
                if (lis_type[qi]) {
                    POP_BIT_F(desc_sig);
                    if (desc_sig) {
                        const int nn = offspring(g, e.i, e.j, off);
                        for (int q = 0; q < nn; q++) {
                            const long long cidx = (long long)e.k * plane +
                                (long long)off[2 * q] * w + off[2 * q + 1];
                            POP_BIT_F(sig);
                            if (sig) {
                                POP_BIT_F(sbit);
                                rec[cidx] = sbit ? base : -base;
                                lsp_idx.push_back(cidx);
                            } else {
                                lip.push_back(cidx);
                            }
                        }
                        if (has_grandchildren(g, e.i, e.j)) {
                            lis.push_back(e);
                            lis_type.push_back(0);
                        }
                    } else {
                        lis_next.push_back(e);
                        lis_type_next.push_back(1);
                    }
                } else {
                    POP_BIT_F(l_sig);
                    if (l_sig) {
                        const int nn = offspring(g, e.i, e.j, off);
                        for (int q = 0; q < nn; q++) {
                            lis.push_back({off[2 * q], off[2 * q + 1], e.k, 0, 0});
                            lis_type.push_back(1);
                        }
                    } else {
                        lis_next.push_back(e);
                        lis_type_next.push_back(0);
                    }
                }
            }
            std::swap(lis, lis_next);
            std::swap(lis_type, lis_type_next);

            for (size_t t = 0; t < lsp_len; t++) {
                POP_BIT_F(bit);
                rec[lsp_idx[t]] = set_bit_keep_sign(rec[lsp_idx[t]], n, bit);
            }

            if (n == 0) break;
            n--;
        }
        #undef POP_BIT_F
    }
    return 0;
}

int spiht_decode(const uint8_t* data, long long nbits, int n_start, int c,
                 int h, int w, int ll_h, int ll_w, int32_t* rec,
                 int with_meta, int32_t* meta, const int32_t* top_slice,
                 const int32_t* other_slices, int level) {
    if (ll_h <= 1 || ll_w <= 1) return -1;
    // LL parity children live at rows/cols up to 2*ll-1; reject geometries
    // (e.g. level-0 "pyramids") where that exceeds the array — the
    // reference would panic on the same out-of-bounds index
    if (2 * ll_h > h || 2 * ll_w > w) return -1;
    if (!with_meta)
        return decode_fast(data, nbits, n_start, c, h, w, ll_h, ll_w, rec);
    const Geo g{h, w, ll_h, ll_w};
    const long long plane = (long long)h * w;
    std::memset(rec, 0, sizeof(int32_t) * (long long)c * plane);

    MetaCtx mc{meta, nbits + 1, top_slice, other_slices, level};
    if (with_meta) std::memset(meta, 0, sizeof(int32_t) * mc.rows * 8);

    BitReader br{data, nbits};

    std::vector<Entry> lip, lip_next, lsp, lis, lis_next;
    std::vector<uint8_t> lis_type, lis_type_next;
    const int8_t top_depth = (int8_t)level;
    for (int i = 0; i < ll_h; i++)
        for (int j = 0; j < ll_w; j++)
            for (int k = 0; k < c; k++)
                lip.push_back({i, j, (int16_t)k, 0, top_depth});
    for (int i = 0; i < ll_h; i++)
        for (int j = 0; j < ll_w; j++) {
            if ((i & 1) == 0 && (j & 1) == 0) continue;
            for (int k = 0; k < c; k++) {
                lis.push_back({i, j, (int16_t)k, 0, top_depth});
                lis_type.push_back(1);
            }
        }

    int n = n_start;

    // Writes one metadata row at the index of the bit about to be consumed
    // (the trace has nbits+1 rows; the final row describes the bit that was
    // never read — reference behavior, encoder_decoder.rs:643,665-684).
    #define NOTE(action, e)                                                  \
        do {                                                                 \
            if (with_meta) {                                                 \
                if (br.pos >= mc.rows) return 0;                             \
                int lh_, lw_;                                                \
                local_position(mc, (e), &lh_, &lw_);                         \
                int32_t* row = meta + br.pos * 8;                            \
                row[0] = (action);                                           \
                row[1] = lh_;                                                \
                row[2] = lw_;                                                \
                row[3] = (e).k;                                              \
                row[4] = (e).filter;                                         \
                row[5] = (e).depth;                                          \
                row[6] = n;                                                  \
                row[7] = rec[(long long)(e).k * plane +                      \
                             (long long)(e).i * w + (e).j];                  \
            }                                                                \
        } while (0)

    #define POP_BIT(var)                                                     \
        bool var;                                                            \
        do {                                                                 \
            if (br.done()) return 0;                                         \
            var = br.pop();                                                  \
        } while (0)

    for (;;) {
        const size_t lsp_len = lsp.size();
        const int32_t base =
            n == 0 ? 1 : (int32_t)((1u << (n - 1)) + (1u << n));
        int off[8];

        lip_next.clear();
        for (const Entry& e : lip) {
            NOTE(0, e);
            POP_BIT(sig);
            if (sig) {
                NOTE(1, e);
                POP_BIT(sbit);
                rec[(long long)e.k * plane + (long long)e.i * w + e.j] =
                    sbit ? base : -base;
                lsp.push_back(e);
            } else {
                lip_next.push_back(e);
            }
        }
        std::swap(lip, lip_next);

        lis_next.clear();
        lis_type_next.clear();
        for (size_t qi = 0; qi < lis.size(); qi++) {
            const Entry e = lis[qi];
            const uint8_t tA = lis_type[qi];
            if (tA) {
                NOTE(2, e);
                POP_BIT(desc_sig);
                if (desc_sig) {
                    const int nn = offspring(g, e.i, e.j, off);
                    const int8_t cf = offspring_filter(e.filter, e.i, e.j);
                    // child depth clamps at 0: odd-LL overlap chains can
                    // be longer than the nominal level (the reference
                    // would panic indexing slices[level-1-depth] there;
                    // we define clamped metadata semantics, same as the
                    // oracle and the device decoder)
                    for (int q = 0; q < nn; q++) {
                        Entry ce{off[2 * q], off[2 * q + 1], e.k, cf,
                                 (int8_t)(e.depth > 0 ? e.depth - 1 : 0)};
                        NOTE(3, ce);
                        POP_BIT(sig);
                        if (sig) {
                            NOTE(4, ce);
                            POP_BIT(sbit);
                            rec[(long long)ce.k * plane +
                                (long long)ce.i * w + ce.j] =
                                sbit ? base : -base;
                            lsp.push_back(ce);
                        } else {
                            lip.push_back(ce);
                        }
                    }
                    if (has_grandchildren(g, e.i, e.j)) {
                        lis.push_back(e);
                        lis_type.push_back(0);
                    }
                } else {
                    lis_next.push_back(e);
                    lis_type_next.push_back(1);
                }
            } else {
                NOTE(5, e);
                POP_BIT(l_sig);
                if (l_sig) {
                    const int nn = offspring(g, e.i, e.j, off);
                    const int8_t cf = offspring_filter(e.filter, e.i, e.j);
                    for (int q = 0; q < nn; q++) {
                        lis.push_back({off[2 * q], off[2 * q + 1], e.k, cf,
                                       (int8_t)(e.depth > 0 ? e.depth - 1 : 0)});
                        lis_type.push_back(1);
                    }
                } else {
                    lis_next.push_back(e);
                    lis_type_next.push_back(0);
                }
            }
        }
        std::swap(lis, lis_next);
        std::swap(lis_type, lis_type_next);

        for (size_t t = 0; t < lsp_len; t++) {
            const Entry& e = lsp[t];
            NOTE(6, e);
            POP_BIT(bit);
            int32_t* px =
                rec + (long long)e.k * plane + (long long)e.i * w + e.j;
            *px = set_bit_keep_sign(*px, n, bit);
        }

        if (n == 0) break;
        n--;
    }
    return 0;
    #undef NOTE
    #undef POP_BIT
}

// ---------------------------------------------------------------------------
// Batched encode: one thread per image (embarrassingly parallel host stage,
// pairs with batched TPU transform). All images share (c,h,w) geometry or
// pass per-image dims via the arrays.
// ---------------------------------------------------------------------------
int spiht_encode_batch(const int32_t* const* arrs, int batch, const int* cs,
                       const int* hs, const int* ws, const int* ll_hs,
                       const int* ll_ws, const long long* max_bits,
                       int use_maps, int nthreads,
                       const int8_t* const* Ms, const int8_t* const* Ds,
                       const int8_t* const* Gs, const int* forced_max_ns,
                       uint8_t** out_datas,
                       long long* out_nbits, int* out_max_ns) {
    if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads > batch) nthreads = batch;
    std::atomic<int> next(0);
    std::atomic<int> err(0);
    auto worker = [&]() {
        for (;;) {
            const int t = next.fetch_add(1);
            if (t >= batch) return;
            const int rc = spiht_encode(
                arrs[t], cs[t], hs[t], ws[t], ll_hs[t], ll_ws[t], max_bits[t],
                use_maps, Ms ? Ms[t] : nullptr, Ds ? Ds[t] : nullptr,
                Gs ? Gs[t] : nullptr,
                forced_max_ns ? forced_max_ns[t] : -1,
                &out_datas[t], &out_nbits[t], &out_max_ns[t]);
            if (rc != 0) err.store(rc);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return err.load();
}

// Batched decode: one thread per stream.
int spiht_decode_batch(const uint8_t* const* datas, int batch,
                       const long long* nbits, const int* n_starts,
                       const int* cs, const int* hs, const int* ws,
                       const int* ll_hs, const int* ll_ws, int nthreads,
                       int32_t** recs) {
    if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads > batch) nthreads = batch;
    std::atomic<int> next(0);
    std::atomic<int> err(0);
    auto worker = [&]() {
        for (;;) {
            const int t = next.fetch_add(1);
            if (t >= batch) return;
            const int rc = spiht_decode(datas[t], nbits[t], n_starts[t], cs[t],
                                        hs[t], ws[t], ll_hs[t], ll_ws[t],
                                        recs[t], 0, nullptr, nullptr, nullptr,
                                        0);
            if (rc != 0) err.store(rc);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return err.load();
}

}  // extern "C"
