// dwt_kernel.cpp — native multilevel 2D DWT + quantization (host runtime).
//
// The TPU framework computes transforms on-device (JAX, spiht_tpu/wavelets/
// dwt.py); this native implementation is the host-side production path for
// single images / tunneled dev setups where device<->host bandwidth, not
// compute, bounds the pipeline, and the trusted f64 companion to the C++
// SPIHT scheduler in spiht_kernel.cpp. Same transform semantics as the
// PyWavelets-compatible reference (spiht_tpu/wavelets/ref_dwt.py:
//   cX[o] = sum_j filt[j] * ext[2o + 1 + (F-1) - j],
//   out_len = (n + F - 1) / 2, extension modes by index map), with filters
// passed in from Python so the filter-bank derivation stays in one place.
//
// Layout: packed coeffs_to_array layout (SURVEY.md §3.1), quantization is
// coeff * chan_scale * q_scale truncated toward zero (hazard #1).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

// extension modes (match spiht_tpu.wavelets.ref_dwt.extend)
enum ExtMode {
    EXT_ZERO = 0,
    EXT_CONSTANT = 1,
    EXT_SYMMETRIC = 2,
    EXT_REFLECT = 3,
    EXT_PERIODIC = 4,
    EXT_SMOOTH = 5,
    EXT_ANTISYMMETRIC = 6,
    EXT_ANTIREFLECT = 7,
};

// index map for sample i in [-pad, n+pad) plus a sign/affine rule.
// ``s`` strides the signal (s=1: contiguous row; s=row_width: a column),
// so the same rule serves both axes without transposing.
template <typename T>
static inline T ext_sample(const T* x, long long n, long long i,
                           int mode, long long s = 1) {
    if (i >= 0 && i < n) return x[i * s];
    switch (mode) {
        case EXT_ZERO:
            return 0.0;
        case EXT_CONSTANT:
            return x[(i < 0 ? 0 : n - 1) * s];
        case EXT_SYMMETRIC: {
            long long p = 2 * n;
            long long m = ((i % p) + p) % p;
            return m < n ? x[m * s] : x[(p - 1 - m) * s];
        }
        case EXT_REFLECT: {
            if (n == 1) return x[0];
            long long p = 2 * n - 2;
            long long m = ((i % p) + p) % p;
            return m < n ? x[m * s] : x[(p - m) * s];
        }
        case EXT_PERIODIC: {
            long long m = ((i % n) + n) % n;
            return x[m * s];
        }
        case EXT_SMOOTH: {
            if (n == 1) return x[0];
            if (i < 0) return x[0] + (x[0] - x[s]) * (T)(-i);
            return x[(n - 1) * s] + (x[(n - 1) * s] - x[(n - 2) * s]) * (T)(i - n + 1);
        }
        case EXT_ANTISYMMETRIC: {
            long long p = 2 * n;
            long long m = ((i % p) + p) % p;
            return m < n ? x[m * s] : -x[(p - 1 - m) * s];
        }
        case EXT_ANTIREFLECT: {
            // odd (point) reflection about the edge VALUES; for |offset|
            // beyond n-1 the underlying reflect index wraps (rare; matches
            // ref_dwt._take_refl on the same index arithmetic)
            if (n == 1) return x[0];
            long long p = 2 * n - 2;
            if (i < 0) {
                long long m = ((-i) % p + p) % p;
                T v = m < n ? x[m * s] : x[(p - m) * s];
                return (T)2.0 * x[0] - v;
            }
            long long j = 2 * (n - 1) - i;  // n-2 - (i - n)
            long long m = ((j % p) + p) % p;
            T v = m < n ? x[m * s] : x[(p - m) * s];
            return (T)2.0 * x[(n - 1) * s] - v;
        }
    }
    return 0.0;
}

// single-level 1D analysis along a contiguous row of length n.
//   out[o] = sum_t filt_rev[t] * ext2[2o + t],  filt_rev[t] = filt[F-1-t],
//   ext2[i] = x_ext[i - (F-2)]  (signal extended F-1 both sides, then [1:]).
// The extension is materialized once and deinterleaved into even/odd
// phases (ext2[2k] / ext2[2k+1]), so each tap pass is a contiguous
// axpy vectorizable across outputs. Per-ELEMENT accumulation stays in
// ascending-t order — bit-identical to the scalar reference loop (the
// f64 path's golden-stream contract; -ffp-contract=off blocks FMA fusion).
// ``scratch`` needs >= 2*n + 8*F elements.
template <typename T>
static void dwt_row(const T* x, long long n, const T* lo_rev,
                    const T* hi_rev, int F, int mode, T* __restrict cA,
                    T* __restrict cD, long long out_len, T* scratch) {
    const int pad = F - 1;
    T* extbuf = scratch;
    for (int i = 0; i < pad; i++)
        extbuf[i] = ext_sample(x, n, (long long)i - pad, mode);
    std::memcpy(extbuf + pad, x, sizeof(T) * n);
    for (int i = 0; i < pad; i++)
        extbuf[pad + n + i] = ext_sample(x, n, n + i, mode);
    const T* e2 = extbuf + 1;  // ext2[0] = x_ext[-(F-2)]
    const long long e2len = n + 2 * pad - 1;
    const long long half = e2len / 2 + 2;
    T* __restrict ebuf = extbuf + n + 2 * F;
    T* __restrict obuf = ebuf + half;
    for (long long k = 0; 2 * k < e2len; k++) ebuf[k] = e2[2 * k];
    for (long long k = 0; 2 * k + 1 < e2len; k++) obuf[k] = e2[2 * k + 1];
    {
        const T l0 = lo_rev[0], h0 = hi_rev[0];
        for (long long o = 0; o < out_len; o++) {
            cA[o] = l0 * ebuf[o];
            cD[o] = h0 * ebuf[o];
        }
    }
    for (int t = 1; t < F; t++) {
        // ext2[2o + t]: even t reads ebuf[o + t/2], odd t obuf[o + t/2]
        const T* __restrict src = ((t & 1) ? obuf : ebuf) + (t >> 1);
        const T lt = lo_rev[t], ht = hi_rev[t];
        for (long long o = 0; o < out_len; o++) {
            cA[o] += lt * src[o];
            cD[o] += ht * src[o];
        }
    }
}

static inline long long coeff_len(long long n, int F) {
    return (n + F - 1) / 2;
}

// Column-pass analysis over a (ah x ow) plane, row-wise (no transposes):
// output row o accumulates F tap passes of contiguous axpys over source
// rows; source row index for (o, t) is v = 2o + t + 1 - pad, out-of-range
// rows materialized per the extension rule applied down each column.
// Per-element accumulation order matches dwt_row (f64 bit-compat). Detail
// outputs can stream straight into the packed array via sA/sD strides.
template <typename T>
static void dwt_cols(const T* x, long long ah, long long ow,
                     const T* lo_rev, const T* hi_rev, int F, int mode,
                     T* cA, long long sA, T* cD, long long sD,
                     long long oh, std::vector<const T*>& vrow,
                     std::vector<T>& padrows) {
    const int pad = F - 1;
    const long long vlo = 1 - pad;
    const long long vhi = 2 * (oh - 1) + F - pad;  // inclusive
    const long long nv = vhi - vlo + 1;
    vrow.resize((size_t)nv);
    long long npad = 0;
    for (long long v = vlo; v <= vhi; v++)
        if (v < 0 || v >= ah) npad++;
    padrows.resize((size_t)std::max(npad, 1LL) * ow);
    long long pi = 0;
    for (long long v = vlo; v <= vhi; v++) {
        if (v >= 0 && v < ah) {
            vrow[v - vlo] = x + v * ow;
            continue;
        }
        T* dst = padrows.data() + (pi++) * ow;
        for (long long c = 0; c < ow; c++)
            dst[c] = ext_sample(x + c, ah, v, mode, ow);
        vrow[v - vlo] = dst;
    }
    for (long long o = 0; o < oh; o++) {
        T* __restrict a = cA + o * sA;
        T* __restrict d = cD + o * sD;
        const T* __restrict r0 = vrow[2 * o];  // v - vlo = 2o + t
        const T l0 = lo_rev[0], h0 = hi_rev[0];
        for (long long c = 0; c < ow; c++) {
            a[c] = l0 * r0[c];
            d[c] = h0 * r0[c];
        }
        for (int t = 1; t < F; t++) {
            const T* __restrict r = vrow[2 * o + t];
            const T lt = lo_rev[t], ht = hi_rev[t];
            for (long long c = 0; c < ow; c++) {
                a[c] += lt * r[c];
                d[c] += ht * r[c];
            }
        }
    }
}

// Multilevel 2D DWT of one channel (h x w f64) into the packed layout.
// work buffers provided by caller (size >= h*w each, x4).
// Writes per-level subband dims into dims[2*levels] (coarse->fine h,w...).
template <typename T>
static void wavedec2_channel(const T* img, long long h, long long w,
                             const T* lo_rev, const T* hi_rev,
                             int F, int mode, int levels, T* packed,
                             long long packed_h, long long packed_w,
                             long long* lvl_h, long long* lvl_w,
                             T* a_buf, T* tmp1, T* tmp2) {
    // a_buf holds the current approximation (ah x aw)
    std::memcpy(a_buf, img, sizeof(T) * h * w);
    long long ah = h, aw = w;

    // per-step output dims, fine->coarse: hs[0] = dims after the first
    // decomposition (finest details), hs[levels-1] = LL dims
    std::vector<long long> hs(levels), ws(levels);
    {
        long long th = h, tw = w;
        for (int l = 0; l < levels; l++) {
            th = coeff_len(th, F);
            tw = coeff_len(tw, F);
            hs[l] = th;
            ws[l] = tw;
        }
    }
    // coeffs_to_array placement (ref_dwt.coeffs_to_array): start offsets
    // accumulate coarse->fine from the LL dims; for fine->coarse step l the
    // detail blocks start at  start_l = ll + sum_{m=l+1..levels-1} dims_m
    // (boundary growth makes this != the step's own output dims).
    std::vector<long long> start_h(levels), start_w(levels);
    for (int l = 0; l < levels; l++) {
        long long sh = hs[levels - 1], sw = ws[levels - 1];  // LL block
        for (int m = l + 1; m <= levels - 1; m++) {
            sh += hs[m];
            sw += ws[m];
        }
        start_h[l] = sh;
        start_w[l] = sw;
    }
    for (int l = 0; l < levels; l++) {
        // decompose a_buf (ah x aw) -> aa, ad, da, dd with dims oh x ow
        const long long oh = coeff_len(ah, F), ow = coeff_len(aw, F);
        // rows pass: for each of ah rows, conv width aw -> tmp1 rows of
        // [cA | cD] each ow... store cA rows into tmp1 (ah x ow) and cD
        // rows into tmp2 (ah x ow)
        static thread_local std::vector<T> extbuf;
        extbuf.resize(2 * (size_t)std::max(ah, aw) + 8 * F);
        for (long long r = 0; r < ah; r++) {
            dwt_row(a_buf + r * aw, aw, lo_rev, hi_rev, F, mode,
                    tmp1 + r * ow, tmp2 + r * ow, ow, extbuf.data());
        }
        // column pass, row-wise: a-branch (tmp1) -> (aa, da), d-branch
        // (tmp2) -> (ad, dd). aa lands in a_buf (the next approximation);
        // details stream straight into the packed layout:
        //   ad: rows [0, oh), cols [start_w_l, +ow);
        //   da: rows [start_h_l, +oh), cols [0, ow);
        //   dd: rows [start_h_l, +oh), cols [start_w_l, +ow)
        static thread_local std::vector<const T*> vrow;
        static thread_local std::vector<T> padrows;
        const long long sh = start_h[l], sw = start_w[l];
        dwt_cols(tmp1, ah, ow, lo_rev, hi_rev, F, mode,
                 a_buf, ow,
                 packed + sh * packed_w, packed_w,
                 oh, vrow, padrows);
        dwt_cols(tmp2, ah, ow, lo_rev, hi_rev, F, mode,
                 packed + sw, packed_w,
                 packed + sh * packed_w + sw, packed_w,
                 oh, vrow, padrows);
        ah = oh;
        aw = ow;
        lvl_h[l] = oh;
        lvl_w[l] = ow;
    }
    // place final LL at top-left
    for (long long r = 0; r < ah; r++)
        std::memcpy(packed + r * packed_w, a_buf + r * aw,
                    sizeof(T) * aw);
}

// Full forward transform: (C,H,W) f64 image -> packed (C, ph, pw) i32.
// filters: dec_lo/dec_hi length F (NOT reversed). chan_scales may be null.
// Returns 0 on success; *out_ll_h/w get the LL dims.
template <typename T>
static int dwt_forward_impl(const T* img, int C, long long h, long long w,
                            const double* dec_lo, const double* dec_hi,
                            int F, int mode, int levels,
                            const double* chan_scales, double q_scale,
                            int32_t* out_arr, long long ph, long long pw,
                            long long* out_ll_h, long long* out_ll_w) {
    if (levels < 1) return -1;
    std::vector<T> lo_rev(F), hi_rev(F);
    for (int t = 0; t < F; t++) {
        lo_rev[t] = (T)dec_lo[F - 1 - t];
        hi_rev[t] = (T)dec_hi[F - 1 - t];
    }
    // thread_local scratch: fresh multi-MB allocations per call cost more
    // in page faults than the transform itself under the batch thread pool.
    // Size to the max intermediate across levels, not just h*w: when a dim
    // is below F-1, coeff_len grows it ((n+F-1)/2 > n), so level outputs
    // can exceed the input plane.
    size_t scratch = (size_t)(h * w);
    {
        long long ah = h, aw = w;
        for (int l = 0; l < levels; l++) {
            const long long oh = coeff_len(ah, F), ow = coeff_len(aw, F);
            scratch = std::max(scratch, (size_t)(ah * aw));
            scratch = std::max(scratch, (size_t)(ah * ow));
            scratch = std::max(scratch, (size_t)(oh * ow));
            ah = oh;
            aw = ow;
        }
    }
    static thread_local std::vector<T> packed, a_buf, tmp1, tmp2;
    packed.resize((size_t)ph * pw);
    a_buf.resize(scratch);
    tmp1.resize(scratch);
    tmp2.resize(scratch);
    std::vector<long long> lvl_h(levels), lvl_w(levels);
    for (int c = 0; c < C; c++) {
        std::fill(packed.begin(), packed.end(), (T)0);
        wavedec2_channel<T>(img + (size_t)c * h * w, h, w, lo_rev.data(),
                            hi_rev.data(), F, mode, levels, packed.data(),
                            ph, pw, lvl_h.data(), lvl_w.data(), a_buf.data(),
                            tmp1.data(), tmp2.data());
        const T s = (T)((chan_scales ? chan_scales[c] : 1.0) * q_scale);
        int32_t* dst = out_arr + (size_t)c * ph * pw;
        for (size_t t = 0; t < (size_t)ph * pw; t++) {
            dst[t] = (int32_t)(packed[t] * s);  // trunc toward zero
        }
    }
    *out_ll_h = lvl_h[levels - 1];
    *out_ll_w = lvl_w[levels - 1];
    return 0;
}

extern "C" int spiht_dwt_forward(const double* img, int C, long long h, long long w,
                      const double* dec_lo, const double* dec_hi, int F,
                      int mode, int levels, const double* chan_scales,
                      double q_scale, int32_t* out_arr, long long ph,
                      long long pw, long long* out_ll_h, long long* out_ll_w) {
    return dwt_forward_impl<double>(img, C, h, w, dec_lo, dec_hi, F, mode,
                                    levels, chan_scales, q_scale, out_arr,
                                    ph, pw, out_ll_h, out_ll_w);
}

// f32 speed mode: ~2x the f64 throughput on bandwidth-bound hosts. NOT
// bit-compatible with the f64 reference path — borderline quantization
// truncations can differ (PSNR impact is nil: f32 DWT error is orders of
// magnitude below quantization error).
extern "C" int spiht_dwt_forward_f32(const float* img, int C, long long h, long long w,
                          const double* dec_lo, const double* dec_hi, int F,
                          int mode, int levels, const double* chan_scales,
                          double q_scale, int32_t* out_arr, long long ph,
                          long long pw, long long* out_ll_h,
                          long long* out_ll_w) {
    return dwt_forward_impl<float>(img, C, h, w, dec_lo, dec_hi, F, mode,
                                   levels, chan_scales, q_scale, out_arr,
                                   ph, pw, out_ll_h, out_ll_w);
}

// ---------------------------------------------------------------------------
// Inverse: multilevel 2D IDWT (pywt.waverec2 semantics incl. odd-dim crops).
// Polyphase synthesis (see spiht_tpu/wavelets/dwt.py idwt1d):
//   out[2m]   = sum_u c[m+u] * filt[F-2-2u]   (t = 2u+1 odd taps)
//   out[2m+1] = sum_v c[m+v] * filt[F-1-2v]   (t = 2v   even taps)
//   out_len = 2n - F + 2, summed over the (cA, rec_lo), (cD, rec_hi) pair.
// ---------------------------------------------------------------------------

// Even/odd output phases accumulate per-tap contiguous two-term axpys
// (vectorizable across m), then interleave into out. Per-element op order
// is identical to the scalar u-ascending loop (f64 bit-compat). ebuf/obuf
// scratch each needs >= (out_len + 1) / 2 + 1 elements.
template <typename T>
static void idwt_row(const T* a, const T* d, long long n,
                     const T* lo, const T* hi, int F, T* out,
                     long long out_len, T* __restrict ebuf,
                     T* __restrict obuf) {
    const long long n_even = (out_len + 1) / 2;
    const long long n_odd = out_len / 2;
    for (long long m = 0; m < n_even; m++) ebuf[m] = (T)0;
    for (long long m = 0; m < n_odd; m++) obuf[m] = (T)0;
    for (int u = 0; 2 * u + 1 < F; u++) {
        const T flo = lo[F - 2 - 2 * u], fhi = hi[F - 2 - 2 * u];
        const long long mmax = std::min(n_even, n - u);
        const T* __restrict ar = a + u;
        const T* __restrict dr = d + u;
        for (long long m = 0; m < mmax; m++)
            ebuf[m] += flo * ar[m] + fhi * dr[m];
    }
    for (int v = 0; 2 * v < F; v++) {
        const T flo = lo[F - 1 - 2 * v], fhi = hi[F - 1 - 2 * v];
        const long long mmax = std::min(n_odd, n - v);
        const T* __restrict ar = a + v;
        const T* __restrict dr = d + v;
        for (long long m = 0; m < mmax; m++)
            obuf[m] += flo * ar[m] + fhi * dr[m];
    }
    for (long long m = 0; m < n_odd; m++) {
        out[2 * m] = ebuf[m];
        out[2 * m + 1] = obuf[m];
    }
    if (n_even > n_odd) out[2 * (n_even - 1)] = ebuf[n_even - 1];
}

// H-axis synthesis, row-wise (no transposes): even/odd output rows
// accumulate per-tap contiguous two-term axpys over the (dh x ow) branch
// planes. Per-element op order matches idwt_row (f64 bit-compat).
template <typename T>
static void idwt_cols(const T* a, const T* d, long long dh, long long ow,
                      const T* lo, const T* hi, int F, T* out,
                      long long oh) {
    const long long n_even = (oh + 1) / 2;
    const long long n_odd = oh / 2;
    std::memset(out, 0, sizeof(T) * (size_t)oh * ow);
    for (int u = 0; 2 * u + 1 < F; u++) {
        const T flo = lo[F - 2 - 2 * u], fhi = hi[F - 2 - 2 * u];
        const long long mmax = std::min(n_even, dh - u);
        for (long long m = 0; m < mmax; m++) {
            T* __restrict o_ = out + 2 * m * ow;
            const T* __restrict ar = a + (m + u) * ow;
            const T* __restrict dr = d + (m + u) * ow;
            for (long long c = 0; c < ow; c++)
                o_[c] += flo * ar[c] + fhi * dr[c];
        }
    }
    for (int v = 0; 2 * v < F; v++) {
        const T flo = lo[F - 1 - 2 * v], fhi = hi[F - 1 - 2 * v];
        const long long mmax = std::min(n_odd, dh - v);
        for (long long m = 0; m < mmax; m++) {
            T* __restrict o_ = out + (2 * m + 1) * ow;
            const T* __restrict ar = a + (m + v) * ow;
            const T* __restrict dr = d + (m + v) * ow;
            for (long long c = 0; c < ow; c++)
                o_[c] += flo * ar[c] + fhi * dr[c];
        }
    }
}

// Inverse transform of one packed channel back to the image plane.
// lvl arrays are coarse->fine per level: detail block start offsets and
// dims in the packed array (from the Python geometry module).
// a_buf/b_buf/t_buf: scratch >= out_h*out_w each.
template <typename T>
static void waverec2_channel(const T* packed, long long pw_row,
                             const T* rec_lo, const T* rec_hi,
                             int F, int levels, long long ll_h, long long ll_w,
                             const long long* lvl_sh, const long long* lvl_sw,
                             const long long* lvl_dh, const long long* lvl_dw,
                             T* a_buf, T* b_buf, T* t_buf,
                             long long* fin_h, long long* fin_w) {
    // current approximation in a_buf (ah x aw)
    long long ah = ll_h, aw = ll_w;
    for (long long r = 0; r < ah; r++)
        std::memcpy(a_buf + r * aw, packed + r * pw_row,
                    sizeof(T) * aw);

    for (int l = 0; l < levels; l++) {
        const long long sh = lvl_sh[l], sw = lvl_sw[l];
        const long long dh = lvl_dh[l], dw = lvl_dw[l];
        // pywt crop: if approximation outgrew the details by 1, trim
        long long ch = ah, cw = aw;
        if (ch == dh + 1) ch = dh;
        if (cw == dw + 1) cw = dw;
        // (if cw < aw the a_buf rows are strided by aw; compact first)
        if (cw != aw) {
            for (long long r = 0; r < ch; r++)
                std::memmove(a_buf + r * cw, a_buf + r * aw,
                             sizeof(T) * cw);
        }
        const long long ow = 2 * dw - F + 2;   // width after W-axis idwt
        const long long oh = 2 * dh - F + 2;   // height after H-axis idwt
        // W-axis pass: rows of (aa, ad) -> b_buf (ch x ow);
        //              rows of (da, dd) -> t_buf (dh x ow)
        // aa = a_buf (ch x cw), ad = packed[0:dh, sw:sw+dw] (row r < ch)
        static thread_local std::vector<T> phbuf;
        phbuf.resize((size_t)ow + 2 * F + 4);
        T* ebuf = phbuf.data();
        T* obuf = ebuf + ow / 2 + F + 2;
        for (long long r = 0; r < ch; r++) {
            idwt_row(a_buf + r * cw, packed + r * pw_row + sw, dw, rec_lo,
                     rec_hi, F, b_buf + r * ow, ow, ebuf, obuf);
        }
        for (long long r = 0; r < dh; r++) {
            idwt_row(packed + (sh + r) * pw_row,
                     packed + (sh + r) * pw_row + sw, dw, rec_lo, rec_hi, F,
                     t_buf + r * ow, ow, ebuf, obuf);
        }
        // H-axis pass, row-wise into a_buf (oh x ow).
        // b_buf has ch (== dh after crop) rows; zero-fill any gap
        if (ch < dh) {
            std::memset(b_buf + ch * ow, 0, sizeof(T) * (dh - ch) * ow);
        }
        idwt_cols(b_buf, t_buf, dh, ow, rec_lo, rec_hi, F, a_buf, oh);
        ah = oh;
        aw = ow;
    }
    *fin_h = ah;
    *fin_w = aw;
}

// Full inverse: packed (C, ph, pw) i32 -> (C, out_h, out_w) f64 image
// plane stack (before inverse color conversion, which stays in Python).
// lvl_* arrays are per level coarse->fine, length `levels`.
template <typename T>
static int dwt_inverse_impl(const int32_t* arr, int C, long long ph,
                            long long pw, const double* rec_lo,
                            const double* rec_hi, int F, int levels,
                            long long ll_h, long long ll_w,
                            const long long* lvl_sh, const long long* lvl_sw,
                            const long long* lvl_dh, const long long* lvl_dw,
                            const double* chan_scales, double q_scale,
                            T* out, long long out_h, long long out_w) {
    if (levels < 1) return -1;
    std::vector<T> lo(F), hi(F);
    for (int t = 0; t < F; t++) {
        lo[t] = (T)rec_lo[t];
        hi[t] = (T)rec_hi[t];
    }
    // thread_local scratch sized to the max intermediate plane across
    // levels (degenerate geometries can make an intermediate exceed the
    // final plane; see the forward path's sizing note)
    size_t scratch = (size_t)(out_h * out_w);
    scratch = std::max(scratch, (size_t)(ll_h * ll_w));
    for (int l = 0; l < levels; l++) {
        const long long dh = lvl_dh[l], dw = lvl_dw[l];
        long long ow = 2 * dw - F + 2, oh = 2 * dh - F + 2;
        if (ow < 0) ow = 0;
        if (oh < 0) oh = 0;
        scratch = std::max(scratch, (size_t)(dh * ow));
        scratch = std::max(scratch, (size_t)(oh * ow));
    }
    static thread_local std::vector<T> packed, a_buf, b_buf, t_buf;
    packed.resize((size_t)ph * pw);
    a_buf.resize(scratch);
    b_buf.resize(scratch);
    t_buf.resize(scratch);
    for (int c = 0; c < C; c++) {
        const T s = (T)(1.0 / ((chan_scales ? chan_scales[c] : 1.0) * q_scale));
        const int32_t* src = arr + (size_t)c * ph * pw;
        for (size_t t = 0; t < (size_t)ph * pw; t++)
            packed[t] = (T)src[t] * s;
        long long fh = 0, fw = 0;
        waverec2_channel<T>(packed.data(), pw, lo.data(), hi.data(), F,
                            levels, ll_h, ll_w, lvl_sh, lvl_sw, lvl_dh,
                            lvl_dw, a_buf.data(), b_buf.data(), t_buf.data(),
                            &fh, &fw);
        if (fh != out_h || fw != out_w) return -2;
        std::memcpy(out + (size_t)c * out_h * out_w, a_buf.data(),
                    sizeof(T) * out_h * out_w);
    }
    return 0;
}

extern "C" int spiht_dwt_inverse(const int32_t* arr, int C, long long ph, long long pw,
                      const double* rec_lo, const double* rec_hi, int F,
                      int levels, long long ll_h, long long ll_w,
                      const long long* lvl_sh, const long long* lvl_sw,
                      const long long* lvl_dh, const long long* lvl_dw,
                      const double* chan_scales, double q_scale,
                      double* out, long long out_h, long long out_w) {
    return dwt_inverse_impl<double>(arr, C, ph, pw, rec_lo, rec_hi, F,
                                    levels, ll_h, ll_w, lvl_sh, lvl_sw,
                                    lvl_dh, lvl_dw, chan_scales, q_scale,
                                    out, out_h, out_w);
}

// f32 speed mode (see spiht_dwt_forward_f32)
extern "C" int spiht_dwt_inverse_f32(const int32_t* arr, int C, long long ph,
                      long long pw, const double* rec_lo,
                      const double* rec_hi, int F, int levels,
                      long long ll_h, long long ll_w,
                      const long long* lvl_sh, const long long* lvl_sw,
                      const long long* lvl_dh, const long long* lvl_dw,
                      const double* chan_scales, double q_scale,
                      float* out, long long out_h, long long out_w) {
    return dwt_inverse_impl<float>(arr, C, ph, pw, rec_lo, rec_hi, F,
                                   levels, ll_h, ll_w, lvl_sh, lvl_sw,
                                   lvl_dh, lvl_dw, chan_scales, q_scale,
                                   out, out_h, out_w);
}

