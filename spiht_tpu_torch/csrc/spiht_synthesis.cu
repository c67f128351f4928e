// The decode's synthesis on the card: one level of the inverse 2D DWT
// (waverec2's idwt2) in one launch, kernel spiht_idwt_level; and IPT's
// inverse colour model in one pass over the image, kernel spiht_ipt_inverse
// (below the level's launch).
//
// It replaces no Pallas kernel: the JAX package leaves the inverse DWT of
// jax_transform._inverse_jit (spiht_tpu/jax_transform.py:150-193) to XLA,
// whose fusions have no counterpart here. Written op by op in torch
// (wavelets/dwt.py waverec2), a level is ~90 elementwise kernels, each
// reading and writing a whole plane; this kernel computes the same values.
//
// What it computes, for every plane of the leading dims (B, C) at once:
// the level's four subbands aa, ad, da, dd (each h x w) -> its output
// plane (out_h x out_w). ad, da and dd, and aa at the coarsest level, are
// read from the packed coefficient array (int16, int32, or already in the
// working dtype T) and dequantized on read: v = T(q), then v / the plane's
// channel scale (where the settings have them), then v / quantization_scale,
// two correctly rounded divisions as torch_transform's ``rec / scales`` and
// ``rec / q`` on the CPU. A finer level's aa is the previous launch's
// output, read through its own row stride, so pywt's crop of an
// approximation one longer than the level's subbands is an index.
//
// The arithmetic is dwt.idwt1d's, operation for operation: W before H
// (a from aa/ad and d from da/dd along the rows, then the output from a/d
// along the columns); each branch a left-to-right sum of products in tap
// order, even output samples from taps F-2, F-4, ..., odd ones from
// F-1, F-3, ...; the A branch added to zero before the D branch is added.
// Products and sums go through the _rn intrinsics, so nvcc contracts
// nothing into an FMA (NVCC_FLAGS keep --fmad at its default). The two
// synthesis forms: "periodization" reads its coefficients at a periodic
// index; every other mode is idwt1d's zero-padded form, which reads zero
// past the subband's end (for the even filters that every wavelet of
// filters.py has, no output sample reaches there).
//
// What bounds it on an H100: bytes, at the bench's bior2.2 (F = 6). A
// level reads each coefficient once (2-4 bytes) and writes each output
// sample once (8 bytes in float64), for ~2F multiplies and adds an output
// sample: below the float64 ridge of the card. The design keeps every
// intermediate out of device memory: a block of 128 threads computes a
// 32 x 32 tile of one plane, loads the four subband windows it needs
// (16 + F/2 - 1 coefficients square, the halo from the filter length) into
// shared memory, dequantized, computes the W pass's a and d rows for the
// tile there, and the H pass writes each output sample once, a warp's
// stores to consecutive addresses. A thread computes an even and an odd
// sample together, which read the same coefficients. The tile's shared
// memory grows with F (20 KB at F = 6 in float64; 175 KB at dmey's
// F = 102, past the default 48 KB, so the launch raises the kernel's limit
// where it needs more). The taps are read from shared memory, for any F.
// What stays between it and its bound is instructions: the division a
// coefficient and the index arithmetic of the windows (PERF.md's kernel
// table).
//
// The block's work is a plain function of (tid, nthreads) (SPIHT_HD), so
// the same source compiles as host C++ (tests/test_torch_kernel_source.py
// runs it on host fibers against the op-by-op inverse).

#include "spiht_common.cuh"

#include <math.h>

#include <type_traits>

#define SYN_TH 32  // output rows of a block's tile
#define SYN_TW 32  // output columns of a block's tile
#define SYN_THREADS 128

// the geometry below is computed by the launch on the host too
#ifdef __CUDACC__
#define SYN_HHD __host__ __device__ __forceinline__
#else
#define SYN_HHD inline
#endif

#ifdef __CUDACC__
SPIHT_HD double syn_mul(double a, double b) { return __dmul_rn(a, b); }
SPIHT_HD float syn_mul(float a, float b) { return __fmul_rn(a, b); }
SPIHT_HD double syn_add(double a, double b) { return __dadd_rn(a, b); }
SPIHT_HD float syn_add(float a, float b) { return __fadd_rn(a, b); }
SPIHT_HD double syn_div(double a, double b) { return __ddiv_rn(a, b); }
SPIHT_HD float syn_div(float a, float b) { return __fdiv_rn(a, b); }
SPIHT_HD double syn_from_int(int32_t v, double*) { return __int2double_rn(v); }
SPIHT_HD float syn_from_int(int32_t v, float*) { return __int2float_rn(v); }
#define SYN_LDG(p) __ldg(p)
#else
// the host build (compiled with -ffp-contract=off)
template <class T> inline T syn_mul(T a, T b) { return a * b; }
template <class T> inline T syn_add(T a, T b) { return a + b; }
template <class T> inline T syn_div(T a, T b) { return a / b; }
template <class T> inline T syn_from_int(int32_t v, T*) { return (T)v; }
#define SYN_LDG(p) (*(p))
#endif

// One level's launch: every pointer is device memory (host memory in the
// host build). rec is (planes, enc_h, enc_w); band b's subband starts at
// (r0[b], c0[b]) there (b = 0 aa, 1 ad, 2 da, 3 dd); with prev set, aa is
// prev's top-left h x w instead, not dequantized. consts holds, in T, the
// reconstruction filters rec_lo[F] and rec_hi[F], quantization_scale, and
// n_scales per-channel scales (plane p's channel is p % n_scales).
struct SynLevel {
  const void* rec;
  int32_t enc_h, enc_w;
  const void* prev;
  int32_t prev_h, prev_w;
  int32_t r0[4], c0[4];
  int32_t h, w;
  int64_t planes;
  const void* consts;
  int32_t F, n_scales, periodic;
  void* out;
  int32_t out_h, out_w;
};

// The coefficient rows (and columns) a tile reads: its 16 + the filter's
// halo of F/2 - 1.
SYN_HHD int32_t syn_rows(int32_t F) { return SYN_TH / 2 + F / 2 - 1; }
SYN_HHD int32_t syn_cols(int32_t F) { return SYN_TW / 2 + F / 2 - 1; }

// Shared memory of a block, in elements of T: the filters, the four
// subband windows, the W pass's a and d rows.
SYN_HHD int64_t syn_shared(int32_t F) {
  return 2 * (int64_t)F + 4 * (int64_t)syn_rows(F) * syn_cols(F) +
         2 * (int64_t)syn_rows(F) * SYN_TW;
}

SYN_HHD int32_t syn_tiles_x(const SynLevel& g) {
  return (g.out_w + SYN_TW - 1) / SYN_TW;
}
SYN_HHD int32_t syn_tiles_y(const SynLevel& g) {
  return (g.out_h + SYN_TH - 1) / SYN_TH;
}
SYN_HHD int64_t syn_blocks(const SynLevel& g) {
  return g.planes * syn_tiles_y(g) * syn_tiles_x(g);
}

// A packed coefficient, dequantized: T(q) / scale / qscale (scale only
// where the settings have per-channel scales). A division by 1 is left
// out: it returns its dividend exactly.
template <class T, class IN>
SPIHT_HD T syn_dequant(IN q, bool scaled, T scale, T qscale) {
  T v;
  if constexpr (std::is_same<IN, T>::value)
    v = q;
  else
    v = syn_from_int((int32_t)q, (T*)nullptr);
  if (scaled && scale != (T)1) v = syn_div(v, scale);
  return qscale != (T)1 ? syn_div(v, qscale) : v;
}

// One subband's window: win[r * cols + c] = the subband's sample
// (kr0 + r, kc0 + c) (src its plane's sample (0, 0), pitch its row
// stride), dequantized where `deq`; zero past the subband's h x w, or at
// the index mod (h, w) where `periodic`. The threads take the window's
// elements in order, so a warp reads consecutive addresses along a row.
template <class T, class IN>
SPIHT_HD void syn_window(T* win, const IN* src, int64_t pitch, bool deq,
                         int32_t kr0, int32_t kc0, int32_t h, int32_t w,
                         bool periodic, int32_t rows, int32_t cols,
                         bool scaled, T scale, T qscale, int tid, int nt) {
  const int32_t dr = nt / cols, dc = nt - dr * cols;
  int32_t r = tid / cols, c = tid - r * cols;
  for (int32_t i = tid; i < rows * cols; i += nt) {
    int32_t kr = kr0 + r, kc = kc0 + c;
    if (periodic) {
      kr %= h;
      kc %= w;
    }
    T v = (T)0;
    if (kr < h && kc < w) {
      const IN q = SYN_LDG(src + kr * pitch + kc);
      if (deq)
        v = syn_dequant<T, IN>(q, scaled, scale, qscale);
      else
        v = (T)q;
    }
    win[i] = v;
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// The even and the odd output sample of idwt1d that read coefficients
// ca[j * stride] (the A branch) and cd[j * stride] (the D branch), j < F/2:
// each (0 + sum_j ca * lo) + sum_j cd * hi, each sum from left to right.
// f holds rec_lo then rec_hi; a sum takes, for the even sample,
// rec_lo[F-2-2j] and rec_hi[F-2-2j], for the odd one rec_lo[F-1-2j] and
// rec_hi[F-1-2j].
template <class T>
SPIHT_HD void syn_pair(const T* ca, const T* cd, int32_t stride,
                       const T* f, int32_t F, T& even, T& odd) {
  const T* lo = f + F - 2;  // lo[-2j] the even tap j, lo[1 - 2j] the odd
  const T* hi = f + 2 * F - 2;
  T ae = syn_mul(ca[0], lo[0]), ao = syn_mul(ca[0], lo[1]);
  T de = syn_mul(cd[0], hi[0]), dd = syn_mul(cd[0], hi[1]);
  for (int32_t j = 1; j < F / 2; ++j) {
    const T a = ca[j * stride], d = cd[j * stride];
    ae = syn_add(ae, syn_mul(a, lo[-2 * j]));
    ao = syn_add(ao, syn_mul(a, lo[1 - 2 * j]));
    de = syn_add(de, syn_mul(d, hi[-2 * j]));
    dd = syn_add(dd, syn_mul(d, hi[1 - 2 * j]));
  }
  even = syn_add(syn_add((T)0, ae), de);
  odd = syn_add(syn_add((T)0, ao), dd);
}

// Block `block` of the level: one SYN_TH x SYN_TW tile of one plane, on
// threads tid of nt, with `sh` its shared memory (syn_shared(F) elements).
// The level comes by value: a reference to the kernel's parameter would
// copy it to the stack.
template <class T, class IN>
SPIHT_HD void idwt_level_block(const SynLevel g, T* sh, int64_t block,
                               int tid, int nt) {
  const int32_t F = g.F;
  const int32_t rows = syn_rows(F), cols = syn_cols(F);
  const int32_t tx = syn_tiles_x(g), ty = syn_tiles_y(g);
  const int64_t plane = block / ((int64_t)tx * ty);
  const int32_t tile = (int32_t)(block - plane * tx * ty);
  const int32_t y0 = tile / tx * SYN_TH, x0 = tile % tx * SYN_TW;
  const T* consts = (const T*)g.consts;
  const T qscale = consts[2 * F];
  const bool scaled = g.n_scales > 0;
  const T scale = scaled ? consts[2 * F + 1 + plane % g.n_scales] : (T)1;
  T* filt = sh;  // rec_lo, rec_hi
  T* win = sh + 2 * F;  // the windows of aa, ad, da, dd: rows x cols each
  T* ad_rows = win + 4 * rows * cols;  // a, then d: rows x SYN_TW each
  const int32_t n_win = rows * cols;
  for (int32_t i = tid; i < 2 * F; i += nt) filt[i] = consts[i];

  // the windows: coefficient (y0 / 2 + r, x0 / 2 + c) of each subband
  const IN* rec = (const IN*)g.rec + plane * g.enc_h * g.enc_w;
  const int64_t pitch = g.enc_w;
#define SYN_WINDOW(k, ty_, src, pitch_, deq)                                 \
  syn_window<T, ty_>(win + (k) * n_win, src, pitch_, deq, y0 / 2, x0 / 2,    \
                     g.h, g.w, g.periodic != 0, rows, cols, scaled, scale,  \
                     qscale, tid, nt)
  if (g.prev)
    SYN_WINDOW(0, T, (const T*)g.prev + plane * g.prev_h * g.prev_w,
               (int64_t)g.prev_w, false);
  else
    SYN_WINDOW(0, IN, rec + g.r0[0] * pitch + g.c0[0], pitch, true);
  SYN_WINDOW(1, IN, rec + g.r0[1] * pitch + g.c0[1], pitch, true);
  SYN_WINDOW(2, IN, rec + g.r0[2] * pitch + g.c0[2], pitch, true);
  SYN_WINDOW(3, IN, rec + g.r0[3] * pitch + g.c0[3], pitch, true);
#undef SYN_WINDOW
  SPIHT_SYNC();

  // W pass: a (from aa, ad) and d (from da, dd), two columns an item
  for (int32_t i = tid; i < rows * SYN_TW; i += nt) {
    const int32_t pair = i / (rows * SYN_TW / 2);
    const int32_t j = i - pair * (rows * SYN_TW / 2);
    const int32_t r = j / (SYN_TW / 2), xp = j % (SYN_TW / 2);
    if (x0 + 2 * xp >= g.out_w) continue;
    const T* ca = win + 2 * pair * n_win + r * cols + xp;
    T* dst = ad_rows + (pair * rows + r) * SYN_TW + 2 * xp;
    syn_pair(ca, ca + n_win, 1, filt, F, dst[0], dst[1]);
  }
  SPIHT_SYNC();

  // H pass: the tile's output samples, two rows an item, from a and d
  // along the columns
  T* out = (T*)g.out + plane * g.out_h * g.out_w;
  for (int32_t i = tid; i < SYN_TH * SYN_TW / 2; i += nt) {
    const int32_t yp = i / SYN_TW, x = i % SYN_TW;
    const int32_t y = y0 + 2 * yp;
    if (y >= g.out_h || x0 + x >= g.out_w) continue;
    const T* ca = ad_rows + yp * SYN_TW + x;
    T even, odd;
    syn_pair(ca, ca + rows * SYN_TW, SYN_TW, filt, F, even, odd);
    T* dst = out + (int64_t)y * g.out_w + x0 + x;
    dst[0] = even;
    if (y + 1 < g.out_h) dst[g.out_w] = odd;
  }
}

// The launch's arguments as the level's struct.
inline SynLevel syn_level(const void* rec, int32_t enc_h, int32_t enc_w,
                          const void* prev, int32_t prev_h, int32_t prev_w,
                          int32_t ll_r, int32_t ll_c, int32_t ad_r,
                          int32_t ad_c, int32_t da_r, int32_t da_c,
                          int32_t dd_r, int32_t dd_c, int32_t h, int32_t w,
                          int64_t planes, const void* consts, int32_t F,
                          int32_t n_scales, int32_t periodic, void* out,
                          int32_t out_h, int32_t out_w) {
  return SynLevel{rec, enc_h, enc_w, prev, prev_h, prev_w,
                  {ll_r, ad_r, da_r, dd_r}, {ll_c, ad_c, da_c, dd_c},
                  h, w, planes, consts, F, n_scales, periodic, out,
                  out_h, out_w};
}

// fn((T*)0, (IN*)0) for the working dtype (0 float32, 1 float64) and the
// coefficients' (0 int16, 1 int32, 2 the working dtype); false if either
// is none of these.
template <class Fn>
bool syn_dispatch(int32_t dtype, int32_t in_kind, Fn fn) {
  if (dtype == 1) {
    if (in_kind == 0) return fn((double*)0, (int16_t*)0), true;
    if (in_kind == 1) return fn((double*)0, (int32_t*)0), true;
    if (in_kind == 2) return fn((double*)0, (double*)0), true;
  } else if (dtype == 0) {
    if (in_kind == 0) return fn((float*)0, (int16_t*)0), true;
    if (in_kind == 1) return fn((float*)0, (int32_t*)0), true;
    if (in_kind == 2) return fn((float*)0, (float*)0), true;
  }
  return false;
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

template <class T, class IN>
__global__ void __launch_bounds__(SYN_THREADS)
spiht_idwt_level_kernel(const SynLevel g) {
  extern __shared__ __align__(16) unsigned char syn_smem[];
  idwt_level_block<T, IN>(g, reinterpret_cast<T*>(syn_smem), blockIdx.x,
                          threadIdx.x, blockDim.x);
}

// The level's launch.
template <class T, class IN>
int syn_launch(const SynLevel& g, int64_t blocks, cudaStream_t stream) {
  const size_t bytes = (size_t)syn_shared(g.F) * sizeof(T);
  // past the default 48 KB a block needs the kernel's limit raised, on the
  // current device, at every such launch (the eager warm-up of a program
  // makes it before its capture)
  if (bytes > (48 << 10)) {
    const int rc = (int)cudaFuncSetAttribute(
        spiht_idwt_level_kernel<T, IN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc) return rc;
  }
  spiht_idwt_level_kernel<T, IN><<<(unsigned)blocks, SYN_THREADS, bytes,
                                   stream>>>(g);
  return (int)cudaGetLastError();
}

// One level (see SynLevel). dtype: 0 float32, 1 float64; in_kind: the
// packed coefficients' type, 0 int16, 1 int32, 2 the working dtype. rec,
// prev and out are contiguous; out is fresh (planes, out_h, out_w).
extern "C" int spiht_idwt_level_launch(
    int32_t dtype, int32_t in_kind, const void* rec, int32_t enc_h,
    int32_t enc_w, const void* prev, int32_t prev_h, int32_t prev_w,
    int32_t ll_r, int32_t ll_c, int32_t ad_r, int32_t ad_c, int32_t da_r,
    int32_t da_c, int32_t dd_r, int32_t dd_c, int32_t h, int32_t w,
    int64_t planes, const void* consts, int32_t F, int32_t n_scales,
    int32_t periodic, void* out, int32_t out_h, int32_t out_w,
    void* stream) {
  const SynLevel g = syn_level(rec, enc_h, enc_w, prev, prev_h, prev_w, ll_r,
                               ll_c, ad_r, ad_c, da_r, da_c, dd_r, dd_c, h, w,
                               planes, consts, F, n_scales, periodic, out,
                               out_h, out_w);
  if (F < 2 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = syn_blocks(g);
  if (blocks <= 0) return 0;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  int rc = 0;
  const bool known = syn_dispatch(dtype, in_kind, [&](auto t, auto in) {
    using T = std::remove_pointer_t<decltype(t)>;
    using IN = std::remove_pointer_t<decltype(in)>;
    rc = syn_launch<T, IN>(g, blocks, (cudaStream_t)stream);
  });
  return known ? rc : (int)cudaErrorInvalidValue;
}

#endif  // __CUDACC__

// ---------------------------------------------------------------------------
// IPT's inverse colour model: kernel spiht_ipt_inverse.
//
// It replaces no Pallas kernel: the JAX package leaves the colour model of
// its inverse (color/jax_models.convert) to XLA. Written op by op in torch
// (color/torch_models.py _rgb_from_ipt), it is ~50 elementwise kernels,
// each reading and writing whole planes; this kernel computes the same
// values, reading the image once and writing the result once.
//
// What it computes, for each pixel of a (N, 3, H, W) image (N the product
// of the leading dims, any strides): LMS' = LMS_FROM_IPT x, LMS =
// sign(LMS') * |LMS'| ** (1 / IPT_EXP), XYZ = XYZ_FROM_LMS_IPT LMS, RGB =
// XYZ_TO_RGB XYZ, written to a fresh contiguous (N, 3, H, W) tensor. Each
// row of a 3x3 product is (x0 * m0 + x1 * m1) + x2 * m2, as torch's ops
// evaluate it, through the _rn intrinsics, so nothing is contracted into
// an FMA; the signed power is s * pow(|x|, p) with s = (0 < x) - (x < 0),
// the device's own pow (powf in float32), as torch.sign, torch.abs and
// torch.pow compute it on the card. The three matrices (row-major) and p
// come from a constant tensor in the working dtype (the wrapper builds it
// from color/models.py), so the source holds no IPT number.
//
// What bounds it on an H100: 48 bytes a pixel in float64 (0.135 ms for a
// Kodak batch of 24 768x512 images at 3.35 TB/s) would, but the three
// float64 pows a pixel (the device's accurate pow, a called function of
// a few hundred instructions; 45 multiplies and adds besides) take longer:
// the float64 kernel runs at ~2.2x its byte bound, the float32 one at
// ~1.8x (PERF.md's kernel table). Each item is 16 bytes of one row of each
// channel (2 pixels in float64, 4 in float32): loaded and stored as one
// vector access a channel where the addresses are 16-byte aligned and the
// row holds the whole item, element by element elsewhere (a row's ragged
// end, an unaligned view, a column stride). The threads take consecutive
// items, so a warp's accesses are consecutive along W, in a grid-stride
// loop over a grid of 16 blocks an SM. Capped at 64 registers (4 blocks of
// 256 threads resident an SM, against 2 at the 116 it takes uncapped), the
// float64 kernel ran 13% faster on an H100 and the float32 one 1% slower.

#define IPT_THREADS 256
#define IPT_BLOCKS_RESIDENT 4  // an SM, at most 64 registers a thread
#define IPT_BLOCKS_AN_SM 16
#define IPT_CONSTS 28  // three 3x3 matrices, then the exponent

// the device's pow and fabs under nvcc (libm's in the host build)
SPIHT_HD double ipt_pow(double x, double p) { return pow(x, p); }
SPIHT_HD float ipt_pow(float x, float p) { return powf(x, p); }
SPIHT_HD double ipt_abs(double x) { return fabs(x); }
SPIHT_HD float ipt_abs(float x) { return fabsf(x); }

// The image's geometry: in[i * sn + c * sc + y * sh + x * sw] is channel c
// of pixel (y, x) of image i < n; out is contiguous (n, 3, h, w). consts
// holds, in T, LMS_FROM_IPT, XYZ_FROM_LMS_IPT and XYZ_TO_RGB row by row,
// then 1 / IPT_EXP.
struct IptImage {
  const void* in;
  int64_t n, h, w;
  int64_t sn, sc, sh, sw;
  const void* consts;
  void* out;
};

// Elements of T in an item: 16 bytes.
template <class T>
SYN_HHD constexpr int ipt_vec() { return 16 / (int)sizeof(T); }

template <class T>
SYN_HHD int64_t ipt_items(const IptImage& g) {
  return g.n * g.h * ((g.w + ipt_vec<T>() - 1) / ipt_vec<T>());
}

// One row of a 3x3 product: (x0 * m[0] + x1 * m[1]) + x2 * m[2].
template <class T>
SPIHT_HD T ipt_row(const T* m, T x0, T x1, T x2) {
  return syn_add(syn_add(syn_mul(x0, m[0]), syn_mul(x1, m[1])),
                 syn_mul(x2, m[2]));
}

// sign(x) * |x| ** p, as torch.sign(x) * torch.abs(x) ** p.
template <class T>
SPIHT_HD T ipt_signed_pow(T x, T p) {
  const T s = (T)((int)((T)0 < x) - (int)(x < (T)0));
  return syn_mul(s, ipt_pow(ipt_abs(x), p));
}

// One pixel: (I, P, T) in v[0..2] -> (R, G, B) in place; k the consts.
template <class T>
SPIHT_HD void ipt_pixel(const T* k, T* v) {
  T a[3], b[3];
#pragma unroll
  for (int o = 0; o < 3; ++o) a[o] = ipt_row(k + 3 * o, v[0], v[1], v[2]);
#pragma unroll
  for (int o = 0; o < 3; ++o) a[o] = ipt_signed_pow(a[o], k[27]);
#pragma unroll
  for (int o = 0; o < 3; ++o) b[o] = ipt_row(k + 9 + 3 * o, a[0], a[1], a[2]);
#pragma unroll
  for (int o = 0; o < 3; ++o) v[o] = ipt_row(k + 18 + 3 * o, b[0], b[1], b[2]);
}

SPIHT_HD bool ipt_aligned(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// 16 bytes at p (16-byte aligned) into v, and back.
SPIHT_HD void ipt_load(const double* p, double* v) {
#ifdef __CUDACC__
  const double2 d = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = d.x;
  v[1] = d.y;
#else
  v[0] = p[0];
  v[1] = p[1];
#endif
}
SPIHT_HD void ipt_load(const float* p, float* v) {
#ifdef __CUDACC__
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
#else
  for (int j = 0; j < 4; ++j) v[j] = p[j];
#endif
}
SPIHT_HD void ipt_store(double* p, const double* v) {
#ifdef __CUDACC__
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
#else
  p[0] = v[0];
  p[1] = v[1];
#endif
}
SPIHT_HD void ipt_store(float* p, const float* v) {
#ifdef __CUDACC__
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
#else
  for (int j = 0; j < 4; ++j) p[j] = v[j];
#endif
}

// Block `block` of `blocks`, on threads tid of nt: items block * nt + tid,
// then every blocks * nt items on. An item is ipt_vec<T>() pixels of one
// row, item j of a row starting at column j * ipt_vec<T>().
template <class T>
SPIHT_HD void ipt_inverse_block(const IptImage g, int64_t block,
                                int64_t blocks, int tid, int nt) {
  constexpr int V = ipt_vec<T>();
  T k[IPT_CONSTS];
  for (int i = 0; i < IPT_CONSTS; ++i) k[i] = SYN_LDG((const T*)g.consts + i);
  const int64_t per_row = (g.w + V - 1) / V;
  const int64_t items = ipt_items<T>(g);
  const int64_t plane = g.h * g.w;
  for (int64_t i = block * nt + tid; i < items; i += blocks * nt) {
    const int64_t row = i / per_row;  // image * h + y
    const int64_t x0 = (i - row * per_row) * V;
    const int64_t img = row / g.h, y = row - img * g.h;
    const T* src = (const T*)g.in + img * g.sn + y * g.sh + x0 * g.sw;
    T* dst = (T*)g.out + img * 3 * plane + y * g.w + x0;
    const int64_t left = g.w - x0;
    const bool vec = left >= V && g.sw == 1 && ipt_aligned(src) &&
                     ipt_aligned(src + g.sc) && ipt_aligned(dst) &&
                     ipt_aligned(dst + plane);
    T v[3][V];
    if (vec) {
#pragma unroll
      for (int c = 0; c < 3; ++c) ipt_load(src + c * g.sc, v[c]);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int j = 0; j < V; ++j)
          v[c][j] = j < left ? SYN_LDG(src + c * g.sc + j * g.sw) : (T)0;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      T p[3] = {v[0][j], v[1][j], v[2][j]};
      ipt_pixel(k, p);
      v[0][j] = p[0];
      v[1][j] = p[1];
      v[2][j] = p[2];
    }
    if (vec) {
#pragma unroll
      for (int c = 0; c < 3; ++c) ipt_store(dst + c * plane, v[c]);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (j < left) dst[c * plane + j] = v[c][j];
    }
  }
}

// fn((T*)0) for the working dtype (0 float32, 1 float64); false if none.
template <class Fn>
bool ipt_dispatch(int32_t dtype, Fn fn) {
  if (dtype == 1) return fn((double*)0), true;
  if (dtype == 0) return fn((float*)0), true;
  return false;
}

#ifdef __CUDACC__

template <class T>
__global__ void __launch_bounds__(IPT_THREADS, IPT_BLOCKS_RESIDENT)
spiht_ipt_inverse_kernel(const IptImage g) {
  ipt_inverse_block<T>(g, blockIdx.x, gridDim.x, threadIdx.x, blockDim.x);
}

// IPT -> RGB over the image (see IptImage). dtype: 0 float32, 1 float64;
// strides in elements; out is fresh, contiguous and does not overlap in.
extern "C" int spiht_ipt_inverse_launch(
    int32_t dtype, const void* in, int64_t n, int64_t h, int64_t w,
    int64_t sn, int64_t sc, int64_t sh, int64_t sw, const void* consts,
    void* out, void* stream) {
  const IptImage g{in, n, h, w, sn, sc, sh, sw, consts, out};
  if (n < 0 || h < 0 || w < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (!rc)
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc) return rc;
  const bool known = ipt_dispatch(dtype, [&](auto t) {
    using T = std::remove_pointer_t<decltype(t)>;
    const int64_t items = ipt_items<T>(g);
    if (items == 0) return;
    const int64_t want = (items + IPT_THREADS - 1) / IPT_THREADS;
    const int64_t fill = (int64_t)sms * IPT_BLOCKS_AN_SM;
    const unsigned blocks = (unsigned)(want < fill ? want : fill);
    spiht_ipt_inverse_kernel<T><<<blocks, IPT_THREADS, 0,
                                  (cudaStream_t)stream>>>(g);
    rc = (int)cudaGetLastError();
  });
  return known ? rc : (int)cudaErrorInvalidValue;
}

#endif  // __CUDACC__
