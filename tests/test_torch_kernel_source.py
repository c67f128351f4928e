"""The CUDA kernels' sources, built as host C++, against their plain
versions.

There is no nvcc here, but the machines in ``spiht_tpu_torch/csrc/*.cu``
are plain functions of (thread id, thread count) with the kernel and its
launch behind ``#ifdef __CUDACC__``. This test compiles them with g++, runs
each machine with a block of 64 threads, fibers on one host thread (the
block barrier, and each warp's ballot, shuffles and ``__syncwarp``,
emulated across its 32 threads; the fibers between two barriers run in a
seeded random order) and holds words, LSP queues, rec and stat equal to
the plain versions'. The decode machines are also held to them on
every byte prefix of small streams, across chunk boundaries, at narrowed
queue capacities and, for B3, on random words; B1's block-wide machine
(also on 256 and 512 threads) at every budget edge of small streams,
across chunk boundaries and with every error code.
The batched kernels' per-stream setup (``encode_stream``,
``decode_stream``: stream offsets, per-stream scalars, the capacity rule)
runs the same way, one host block per stream, against the batched plain
versions. B2-log's and B3-log's machines (``decode_machine<false, true>``,
``<true, true>``) are held to the plain version's event log, B7's
one-thread machine to B1's plain version,
B7's decider fed through a ring of a few slots (``encode_seq_host``) to
B1's plain version and the JAX package at every budget edge and queue
stop, and B6's element body (``quantize_at``) and vector body
(``quantize_item``, at sizes and offsets that put the ragged ends and the
unaligned loads everywhere) to its plain torch version and the Pallas
kernel in interpret mode.
The block spike's iterations (``block_spike``, ``csrc/spike_blocks.cu``)
run on a host block of 128 threads against the spike's numpy model.
The decode's inverse DWT (``idwt_level_block``, ``csrc/spiht_synthesis.cu``,
built with ``-ffp-contract=off``) runs a level a launch through the
wrapper's own level loop, every block on host fibers, bit for bit against
the op-by-op ``inverse`` on the CPU. IPT's inverse colour model
(``ipt_inverse_block``, the same file) runs through its wrapper's launch on
a few host blocks, bit for bit against ``torch_models.convert``'s torch ops
with their power taken by the kernel's own ``pow``: torch's CPU ``pow`` is a
vectorized approximation that differs from libm's in the last bit on ~6% of
inputs, while on the card the kernel and ``torch.pow`` call the same
device ``pow`` (``chip_smoke.py`` phase 29 holds them there unpatched).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from spiht_tpu.codec import api as japi

from spiht_tpu_torch.codec import decoder, encoder

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "spiht_tpu_torch" / "csrc"
THREADS = 64
SEQ_RING = 4  # B7's host ring: a few slots, so it wraps in every pass

HARNESS = r"""
#include <string.h>
#include <ucontext.h>
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <memory>
#include <random>
#include <vector>
#include <cmath>
// The block's threads are fibers on one host thread: each runs until it
// reaches a barrier (the block's, or its warp's, which every warp
// collective passes twice) and parks; a barrier opens when all the threads
// it joins have parked at it. Between barriers the runnable fibers run one
// after another, in an order drawn afresh each round from a seeded
// generator, so a write that races a read of another thread shows in one
// order or the other. A barrier that can never open aborts.
enum { RUN = 0, AT_BLOCK = 1, AT_WARP = 2, DONE = 3 };
struct Fiber {
  ucontext_t ctx;
  std::vector<char> stack;
  int state;
};
static std::vector<Fiber> g_f;
static ucontext_t g_main;
static int t_tid;  // the running fiber
static std::function<void(int)> g_body;
static std::mt19937 g_rng(12345);
static void park(int state) {
  g_f[t_tid].state = state;
  swapcontext(&g_f[t_tid].ctx, &g_main);
}
static void fiber_entry() {
  g_body(t_tid);
  g_f[t_tid].state = DONE;  // uc_link returns to the scheduler
}
static int64_t g_x[32][32];  // each warp's exchange buffer
void spiht_host_sync() { park(AT_BLOCK); }
void spiht_host_syncwarp(int) { park(AT_WARP); }
uint32_t spiht_host_ballot(int lane, bool p) {
  const int w = t_tid >> 5;
  g_x[w][lane] = p;
  park(AT_WARP);
  uint32_t m = 0;
  for (int i = 0; i < 32; ++i) m |= (uint32_t)(g_x[w][i] != 0) << i;
  park(AT_WARP);
  return m;
}
int32_t spiht_host_shfl(int lane, int32_t v, int src) {
  const int w = t_tid >> 5;
  g_x[w][lane] = v;
  park(AT_WARP);
  const int32_t r = (int32_t)g_x[w][src];
  park(AT_WARP);
  return r;
}
int32_t spiht_host_shfl_up(int lane, int32_t v, int d) {
  const int w = t_tid >> 5;
  g_x[w][lane] = v;
  park(AT_WARP);
  const int32_t r = lane >= d ? (int32_t)g_x[w][lane - d] : v;
  park(AT_WARP);
  return r;
}
#include "spiht_encode.cu"
#include "spiht_decode.cu"
#include "spiht_quantize.cu"
#include "spike_blocks.cu"
#include "spiht_synthesis.cu"
template <class F> static void run_block(int nt, F f) {
  g_body = [&](int t) { f(t, nt); };
  g_f.resize(nt);
  std::vector<int> order(nt);
  for (int t = 0; t < nt; ++t) {
    Fiber& fb = g_f[t];
    fb.stack.resize(1 << 16);
    fb.state = RUN;
    getcontext(&fb.ctx);
    fb.ctx.uc_stack.ss_sp = fb.stack.data();
    fb.ctx.uc_stack.ss_size = fb.stack.size();
    fb.ctx.uc_link = &g_main;
    makecontext(&fb.ctx, fiber_entry, 0);
    order[t] = t;
  }
  for (;;) {
    std::shuffle(order.begin(), order.end(), g_rng);
    for (int t : order) {
      if (g_f[t].state != RUN) continue;
      t_tid = t;
      swapcontext(&g_main, &g_f[t].ctx);
    }
    // every fiber has parked or finished: open the barriers that are full
    int done = 0, at_block = 0;
    bool opened = false;
    for (int t = 0; t < nt; ++t) {
      done += g_f[t].state == DONE;
      at_block += g_f[t].state == AT_BLOCK;
    }
    if (done == nt) return;
    if (at_block == nt) {
      for (auto& fb : g_f) fb.state = RUN;
      continue;
    }
    for (int w0 = 0; w0 < nt; w0 += 32) {
      const int w1 = std::min(nt, w0 + 32);
      bool full = true;
      for (int t = w0; t < w1; ++t) full &= g_f[t].state == AT_WARP;
      if (!full) continue;
      for (int t = w0; t < w1; ++t) g_f[t].state = RUN;
      opened = true;
    }
    if (!opened) {
      fprintf(stderr, "host block: a barrier can never open\n");
      abort();
    }
  }
}
// B1's block of NT threads, E entries a thread (the kernels' shapes
// are 512 x 2 for B1 and 256 x 2 for B4)
template <int NT, int E> static void run_encoder(const EncArgs& a,
    const int32_t* lip0, const int32_t* lis0, int32_t cw) {
  auto sh = std::make_unique<EncShared<NT * E>>();
  run_block(NT, [&](int tid, int) {
    encode_block<NT, E>(a, lip0, lis0, cw, *sh, tid);
  });
}
template <int NT, int E> static void run_encoder_batch(const EncBatch& g,
    int32_t n_streams) {
  auto sh = std::make_unique<EncShared<NT * E>>();
  for (int32_t b = 0; b < n_streams; ++b)
    run_block(NT, [&](int tid, int) { encode_stream<NT, E>(g, b, *sh, tid); });
}
extern "C" void host_encode(int nt, const int32_t* t1, const int32_t* t3s,
    const int32_t* child0, const int32_t* lip0, int32_t n_lip0,
    const int32_t* lis0, int32_t n_lis0, int32_t w, int32_t max_n,
    int32_t max_bits, int32_t capped, int32_t* lip, int32_t lip_cap,
    int32_t* lis, int32_t lis_cap, int32_t* lsp, int32_t lsp_cap,
    uint32_t* words, int32_t cap_words, int32_t* stat, int32_t ring) {
  EncArgs a{t1, t3s, child0, n_lip0, n_lis0, w, max_n, max_bits, capped,
            lip, lip_cap, lis, lis_cap, lsp, lsp_cap, words, stat};
  if (nt == 1) {  // B7: the decider, fed through a ring of `ring` slots
    memset(words, 0, 4 * (size_t)cap_words);
    memcpy(lip, lip0, 4 * (size_t)n_lip0);
    memcpy(lis, lis0, 4 * (size_t)n_lis0);
    std::vector<SeqSlot> slots(ring);
    encode_seq_host(a, slots.data(), (uint32_t)ring);
  } else if (nt == 64) {
    run_encoder<64, 8>(a, lip0, lis0, cap_words);
  } else if (nt == 256) {
    run_encoder<256, 2>(a, lip0, lis0, cap_words);
  } else if (nt == 512) {
    run_encoder<512, 2>(a, lip0, lis0, cap_words);
  } else {
    stat[1] = -1;  // no such block in the host build
  }
}
extern "C" void host_decode(int nt, int seq, const uint32_t* words,
    int32_t nbits, int32_t max_n, const int32_t* geo, const int32_t* lip0,
    int32_t n_lip0, const int32_t* lis0, int32_t n_lis0, int32_t w,
    int32_t* lip, int32_t lip_cap, int32_t* lis, int32_t lis_cap,
    int32_t* lsp, int32_t* lsp_val, int32_t lsp_cap, int32_t* rec,
    int32_t n_rec, int32_t* stat, uint64_t* log) {
  memcpy(lip, lip0, 4 * (size_t)n_lip0);
  memcpy(lis, lis0, 4 * (size_t)n_lis0);
  std::vector<uint64_t> last(n_rec, 0);
  if (seq) memset(rec, 0, 4 * (size_t)n_rec);
  if (log) memset(log, 0, 8 * (size_t)(nbits + 1));
  DecArgs a{words, nbits, max_n, geo, n_lip0, n_lis0, w, lip, lip_cap,
            lis, lis_cap, lsp, lsp_cap, lsp_val, rec, last.data(), stat,
            log};
  auto sh = std::make_unique<DecShared>();
  run_block(nt, [&](int tid, int n) {
    if (seq && log) decode_machine<true, true>(a, *sh, tid, n);
    else if (seq) decode_machine<true, false>(a, *sh, tid, n);
    else if (log) decode_machine<false, true>(a, *sh, tid, n);
    else decode_machine<false, false>(a, *sh, tid, n);
  });
}
extern "C" int32_t host_quantize(const float* x, int64_t n, float scale,
    int32_t* arr, int16_t* a16, int8_t* m) {
  bool over = false;
  for (int64_t i = 0; i < n; ++i) over |= quantize_at(x, scale, i, arr, a16, m);
  return over;
}
// B6's kernel body over every vector index, as its threads take them (x's
// 16-byte alignment chooses the vector loads, as the launch does)
extern "C" int32_t host_quantize_vec(const float* x, int64_t n, float scale,
    int32_t* arr, int16_t* a16, int8_t* m) {
  bool over = false;
  const bool x16 = ((uintptr_t)x & 15) == 0;
  for (int64_t v = 0; v < quantize_items(n); ++v)
    over |= x16 ? quantize_item<true>(x, n, scale, v, arr, a16, m)
                : quantize_item<false>(x, n, scale, v, arr, a16, m);
  return over;
}
// spike_block's iterations on a host block of 128 threads
extern "C" void host_spike_block(const int32_t* mag, int32_t rows,
    int32_t niter, int32_t* out, int32_t* lsp, int32_t* lip,
    uint32_t* words) {
  BlockShared sh{};
  run_block(BLOCK_LANES, [&](int tid, int) {
    block_spike(mag, rows, niter, out, lsp, lip, words, sh, tid);
  });
}
// one level of spiht_idwt_level: its launch's arguments, but the block's
// host threads in place of the stream; every block on host fibers, its
// shared memory NaN at the start, so a read of an unwritten element shows
extern "C" int host_idwt_level(int32_t dtype, int32_t in_kind,
    const void* rec, int32_t enc_h, int32_t enc_w, const void* prev,
    int32_t prev_h, int32_t prev_w, int32_t ll_r, int32_t ll_c, int32_t ad_r,
    int32_t ad_c, int32_t da_r, int32_t da_c, int32_t dd_r, int32_t dd_c,
    int32_t h, int32_t w, int64_t planes, const void* consts, int32_t F,
    int32_t n_scales, int32_t periodic, void* out, int32_t out_h,
    int32_t out_w, int nt) {
  const SynLevel g = syn_level(rec, enc_h, enc_w, prev, prev_h, prev_w, ll_r,
                               ll_c, ad_r, ad_c, da_r, da_c, dd_r, dd_c, h, w,
                               planes, consts, F, n_scales, periodic, out,
                               out_h, out_w);
  const bool known = syn_dispatch(dtype, in_kind, [&](auto t, auto in) {
    using T = std::remove_pointer_t<decltype(t)>;
    using IN = std::remove_pointer_t<decltype(in)>;
    std::vector<T> sh(syn_shared(F));
    for (int64_t b = 0; b < syn_blocks(g); ++b) {
      std::fill(sh.begin(), sh.end(), (T)NAN);
      run_block(nt, [&](int tid, int n) {
        idwt_level_block<T, IN>(g, sh.data(), b, tid, n);
      });
    }
  });
  return known ? 0 : -1;
}
// spiht_ipt_inverse: its launch's arguments, but `blocks` blocks of nt
// threads on host fibers in place of the stream's grid, the last block
// first where `reverse` (with one item a block, a write past an item's
// pixels then lands on pixels already written)
extern "C" int host_ipt_inverse(int32_t dtype, const void* in, int64_t n,
    int64_t h, int64_t w, int64_t sn, int64_t sc, int64_t sh, int64_t sw,
    const void* consts, void* out, int64_t blocks, int nt, int reverse) {
  const IptImage g{in, n, h, w, sn, sc, sh, sw, consts, out};
  const bool known = ipt_dispatch(dtype, [&](auto t) {
    using T = std::remove_pointer_t<decltype(t)>;
    for (int64_t i = 0; i < blocks; ++i) {
      const int64_t b = reverse ? blocks - 1 - i : i;
      run_block(nt, [&](int tid, int n_t) {
        ipt_inverse_block<T>(g, b, blocks, tid, n_t);
      });
    }
  });
  return known ? 0 : -1;
}
// the kernel's pow (ipt_pow) over n elements, at p rounded to the working
// dtype as the kernel's constants round it
extern "C" int host_ipt_pow(int32_t dtype, const void* x, int64_t n,
    double p, void* out) {
  const bool known = ipt_dispatch(dtype, [&](auto t) {
    using T = std::remove_pointer_t<decltype(t)>;
    for (int64_t i = 0; i < n; ++i)
      ((T*)out)[i] = ipt_pow(((const T*)x)[i], (T)p);
  });
  return known ? 0 : -1;
}
extern "C" void host_encode_batch(int nt, int32_t n_streams,
    const int32_t* t1, const int32_t* t3s, const int32_t* child0,
    const int32_t* lip0, int32_t n_lip0, const int32_t* lis0, int32_t n_lis0,
    int32_t n_cells, int32_t w, const int32_t* max_n, const int32_t* max_bits,
    int32_t* lip, int32_t lip_cap, int32_t* lis, int32_t lis_cap,
    int32_t* lsp, int32_t lsp_cap, uint32_t* words, int32_t cap_words,
    int32_t* stat) {
  EncBatch g{t1, t3s, child0, lip0, n_lip0, lis0, n_lis0, n_cells, w,
             max_n, max_bits, lip, lip_cap, lis, lis_cap, lsp, lsp_cap,
             words, cap_words, stat};
  if (nt == 64) run_encoder_batch<64, 8>(g, n_streams);
  else if (nt == 256) run_encoder_batch<256, 2>(g, n_streams);
  else for (int32_t b = 0; b < n_streams; ++b) stat[b * SPIHT_STAT_LEN + 1] = -1;
}
extern "C" void host_decode_batch(int nt, int seq, int32_t n_streams,
    const uint32_t* words, int32_t cap_words, const int32_t* nbits,
    const int32_t* max_n, const int32_t* geo, const int32_t* lip0,
    int32_t n_lip0, const int32_t* lis0, int32_t n_lis0, int32_t n_cells,
    int32_t w, int32_t* lip, int32_t lip_cap, int32_t* lis, int32_t lis_cap,
    int32_t* lsp, int32_t lsp_cap, int32_t* lsp_val, int32_t* rec,
    int32_t* stat) {
  std::vector<uint64_t> last(seq ? (size_t)n_streams * n_cells : 0);
  DecBatch g{words, cap_words, nbits, max_n, geo, lip0, n_lip0, lis0,
             n_lis0, n_cells, w, lip, lip_cap, lis, lis_cap, lsp, lsp_cap,
             seq ? nullptr : lsp_val, seq ? rec : nullptr,
             seq ? last.data() : nullptr, stat};
  auto sh = std::make_unique<DecShared>();
  for (int32_t b = 0; b < n_streams; ++b)
    run_block(nt, [&](int tid, int n) {
      if (seq) decode_stream<true>(g, b, *sh, tid, n);
      else decode_stream<false>(g, b, *sh, tid, n);
    });
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources as host C++")
    d = tmp_path_factory.mktemp("host_kernels")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libhost_kernels.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-ffp-contract=off",
         "-Wno-unknown-pragmas", "-I", str(CSRC), "-o", str(so),
         str(d / "harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(so))


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _i(v):
    return ctypes.c_int32(int(v))


def _host_encode_args(lib, args, threads=THREADS, ring=SEQ_RING):
    """B1's machine on ``threads`` host threads (B7's decider with one, fed
    through a ring of ``ring`` slots) on ``encoder.encode_machine``'s
    arguments, held to the plain version: words and stat. Returns (words,
    stat list)."""
    t1, t3s, child0, lip0, lis0, w, max_n, mb, capped, caps, cw = args
    lip, lis, lsp = encoder.scratch_queues(caps)
    words = torch.empty(cw, dtype=torch.int32)
    stat = torch.empty(encoder.STAT_LEN, dtype=torch.int32)
    lib.host_encode(
        ctypes.c_int(threads), _p(t1), _p(t3s), _p(child0), _p(lip0),
        _i(lip0.numel()), _p(lis0), _i(lis0.numel()), _i(w), _i(max_n),
        _i(mb), _i(capped), _p(lip), _i(caps[0]), _p(lis), _i(caps[1]),
        _p(lsp), _i(caps[2]), _p(words), _i(cw), _p(stat), _i(ring),
    )
    pw, ps = encoder.encode_machine(*args)
    assert stat.tolist() == ps.tolist()
    assert torch.equal(words, pw)
    return pw, ps.tolist()


def _host_encode(lib, arr, ll_h, ll_w, max_bits, threads=THREADS):
    """B1's machine on ``threads`` host threads, or B7's with one."""
    args = encoder.machine_args(torch.as_tensor(arr), ll_h, ll_w, max_bits)
    pw, ps = _host_encode_args(lib, args, threads)
    return encoder.stream_bytes(pw, ps[0]), int(args[6])


def _host_encode_batch(lib, args, threads=THREADS):
    """B4's per-stream setup and B1's machine, one host block per stream,
    on ``encoder.encode_machine_batch``'s arguments, held to the plain
    version: words and stat. Returns (words, stat rows)."""
    t1, t3s, child0, lip0, lis0, w, max_n, max_bits, caps, cw = args
    B, N = t1.shape
    lip, lis, lsp = encoder.scratch_queues(caps, B)
    words = torch.empty(B, cw, dtype=torch.int32)
    stat = torch.empty(B, encoder.STAT_LEN, dtype=torch.int32)
    lib.host_encode_batch(
        ctypes.c_int(threads), _i(B), _p(t1), _p(t3s), _p(child0), _p(lip0),
        _i(lip0.numel()), _p(lis0), _i(lis0.numel()), _i(N), _i(w),
        _p(max_n), _p(max_bits), _p(lip), _i(caps[0]), _p(lis), _i(caps[1]),
        _p(lsp), _i(caps[2]), _p(words), _i(cw), _p(stat),
    )
    pw, ps = encoder.encode_machine_batch(*args)
    assert stat.tolist() == ps.tolist()
    assert torch.equal(words, pw)
    return pw, ps.tolist()


def _host_decode(lib, data, max_n, c, h, w, ll_h, ll_w, log=False,
                 caps=None, threads=THREADS):
    """B2's or B3's machine (B2-log's or B3-log's with ``log``) on host
    threads, held to the plain version; ``caps`` narrows the queue
    capacities. Returns the stat list."""
    words, nbits = decoder.words_tensor(data, "cpu")
    args = decoder.machine_args(words, nbits, max_n, c, h, w, ll_h, ll_w)
    if caps is not None:
        args = args[:-1] + (tuple(caps),)
    _, _, _, geo, lip0, lis0, _, caps = args
    seq = decoder.has_duplicate_parents(h, w, ll_h, ll_w)
    events = torch.empty(nbits + 1, dtype=torch.int64) if log else None
    lip, lis, lsp, lsp_val = (
        torch.empty(max(n, 1), dtype=torch.int32)
        for n in (caps[0], caps[1], caps[2], caps[2])
    )
    rec = torch.empty(geo.numel(), dtype=torch.int32)
    stat = torch.empty(encoder.STAT_LEN, dtype=torch.int32)
    lib.host_decode(
        ctypes.c_int(threads), ctypes.c_int(int(seq)), _p(words), _i(nbits),
        _i(max_n), _p(geo), _p(lip0), _i(lip0.numel()), _p(lis0),
        _i(lis0.numel()), _i(w), _p(lip), _i(caps[0]), _p(lis), _i(caps[1]),
        _p(lsp), _p(lsp_val), _i(caps[2]), _p(rec), _i(geo.numel()),
        _p(stat), ctypes.c_void_p(events.data_ptr() if log else None),
    )
    if seq:
        if log:
            prec, ps, plog = decoder.decode_seq_log(*args)
            assert torch.equal(events, plog)
        else:
            prec, ps = decoder.decode_seq(*args)
        assert stat.tolist() == ps.tolist()
        assert torch.equal(rec, prec)
        return ps.tolist()
    if log:
        pl, pv, ps, plog = decoder.decode_lsp_log(*args)
        assert torch.equal(events, plog)
    else:
        pl, pv, ps = decoder.decode_lsp(*args)
    assert stat.tolist() == ps.tolist()
    live = int(ps[0])
    assert torch.equal(lsp[:live], pl[:live])
    assert torch.equal(lsp_val[:live], pv[:live])
    return ps.tolist()


@pytest.mark.parametrize(
    "shape,ll",
    [
        ((3, 24, 32), (6, 8)),
        ((2, 34, 18), (4, 2)),
        ((3, 19, 19), (5, 5)),  # odd LL: duplicate parents, seq decoder
        ((1, 70, 70), (12, 12)),
    ],
)
def test_kernel_sources_equal_plain_versions(host_lib, shape, ll):
    rng = np.random.default_rng(sum(shape))
    arr = (rng.standard_normal(shape) * 900).astype(np.int32)
    full, max_n = _host_encode(host_lib, arr, *ll, 2**31 - 2)
    assert (full, max_n) == japi.encode(arr, *ll, 2**31 - 2)
    for mb in (1, 2, 3, 333, 1001, len(full) * 8 - 5):
        _host_encode(host_lib, arr, *ll, mb)
    for nbytes in sorted({0, 1, 7, len(full) // 3, len(full) - 1, len(full)}):
        _host_decode(host_lib, full[:nbytes], max_n, *shape, *ll)


@pytest.mark.parametrize(
    "shape,ll",
    [
        ((3, 24, 32), (6, 8)),
        ((2, 34, 18), (4, 2)),
        ((1, 70, 70), (12, 12)),
        ((3, 19, 19), (5, 5)),  # odd LL: B3-log
        ((1, 70, 70), (9, 9)),
    ],
)
def test_log_machine_equals_plain_event_log(host_lib, shape, ll):
    """B2-log's and B3-log's machines: the LSP queues (B2-log) or rec
    (B3-log), stat and every event word, filters included, equal the plain
    version's, on full streams, byte prefixes and prefixes cut inside a
    symbol (the log's row at nbits)."""
    rng = np.random.default_rng(sum(shape) + 2)
    arr = (rng.standard_normal(shape) * 900).astype(np.int32)
    full, max_n = japi.encode(arr, *ll, 2**31 - 2)
    for nbytes in sorted({0, 1, 2, 7, 13, len(full) // 3, len(full) // 2,
                          len(full) - 1, len(full)}):
        _host_decode(host_lib, full[:nbytes], max_n, *shape, *ll, log=True)


@pytest.mark.parametrize(
    "shape,ll",
    [
        ((3, 24, 32), (6, 8)),
        ((3, 19, 19), (5, 5)),
    ],
)
def test_seq_encoder_source_equals_plain_version(host_lib, shape, ll):
    """B7's one-thread machine: words and stat equal B1's plain version,
    full and cut inside a symbol, and the budget-capped error."""
    rng = np.random.default_rng(sum(shape) + 3)
    arr = (rng.standard_normal(shape) * 900).astype(np.int32)
    full, max_n = _host_encode(host_lib, arr, *ll, 2**31 - 2, threads=1)
    assert (full, max_n) == japi.encode(arr, *ll, 2**31 - 2)
    for mb in (1, 2, 3, 333, 1001, len(full) * 8 - 5):
        _host_encode(host_lib, arr, *ll, mb, threads=1)


# B7's decider reads every entry from a ring of slots that loader warps
# fill ahead of it; the host build fills the ring with a plain loop instead
# (HostFeed). A ring of a few slots wraps several times in every pass, and
# an entry fetched ahead of the decider's retains and appends is read from
# its slot; a ring of 37 or 64 lets the decider take 32 filled entries at
# once (seq_group) wherever their largest output fits. The cases below
# hold it to the plain version and to the JAX package at every budget edge
# and queue-capacity stop.


@pytest.mark.parametrize("ring", [3, 5, 37, 64])
@pytest.mark.parametrize(
    "shape,ll",
    [((3, 24, 32), (6, 8)), ((3, 19, 19), (5, 5))],
    ids=["even_ll", "odd_ll"],
)
def test_seq_encoder_ring_at_every_budget(host_lib, shape, ll, ring):
    """The full stream, every budget of 1-200 bits and each of the last 40
    bits: words and stat equal the plain version's, the stream
    ``spiht_tpu.codec.api.encode``'s."""
    rng = np.random.default_rng(sum(shape) + ring)
    arr = (rng.standard_normal(shape) * 900).astype(np.int32)
    args = encoder.machine_args(torch.as_tensor(arr), *ll, 2**31 - 2)
    words, stat = _host_encode_args(host_lib, args, 1, ring)
    full, max_n = japi.encode(arr, *ll, 2**31 - 2)
    assert encoder.stream_bytes(words, stat[0]) == full and stat[1] == 0
    nbits = stat[0]
    assert nbits > 2000
    for mb in list(range(1, 201)) + list(range(nbits - 40, nbits)):
        cut = args[:7] + (mb, False) + args[9:]
        words, st = _host_encode_args(host_lib, cut, 1, ring)
        assert st[0] == mb
        assert (encoder.stream_bytes(words, mb), max_n) == japi.encode(
            arr, *ll, mb)


@pytest.mark.parametrize(
    "shape,ll",
    [((3, 24, 32), (6, 8)), ((3, 19, 19), (5, 5))],
    ids=["even_ll", "odd_ll"],
)
def test_seq_encoder_ring_at_narrowed_capacities(host_lib, shape, ll):
    """LIP, LIS and LSP capacities below the stream's need stop the
    decider where the plain version stops, with its code in stat (2 LIP,
    3 LIS, 4 LSP), through rings of 3, 5 and 64 slots."""
    rng = np.random.default_rng(sum(shape) + 8)
    arr = torch.as_tensor((rng.standard_normal(shape) * 900).astype(np.int32))
    args = list(encoder.machine_args(arr, *ll, 2**31 - 2))
    _, full = _host_encode_args(host_lib, args, 1)
    init = (args[3].numel(), args[4].numel(), 0)
    for which in range(3):
        errs = set()
        for frac in (0.3, 0.6, 0.9):
            caps = list(args[9])
            caps[which] = max(init[which], int(full[2 + which] * frac))
            cut = args[:9] + [tuple(caps)] + args[10:]
            for ring in (3, 5, 64):
                errs.add(_host_encode_args(host_lib, cut, 1, ring)[1][1])
        assert 2 + which in errs


@pytest.mark.parametrize("scale", [1.0, 1.7])
def test_quantize_vector_body_equals_plain_and_pallas(host_lib, scale):
    """B6's kernel body (8-element vectors, 16-byte loads where x is
    aligned, the elements past the last vector one by one) at sizes 0-17,
    4099 and 65,537, at element offsets 0-7 into a buffer: all four
    outputs equal the plain version's, and the plain version equals the
    JAX package's Pallas kernel in interpret mode on the same values."""
    import jax.numpy as jnp

    from chip_smoke import quantize_cases  # the card's phase 11 runs them too
    from spiht_tpu.ops import pallas_kernels as jpk
    from spiht_tpu_torch.ops import quantize_kernels

    cases = quantize_cases()
    # the Pallas kernel once, on every buffer laid end to end
    flat = np.concatenate([b for _, b in cases])
    pad = (-flat.size) % 512
    ref = jpk.quantize_compact_m(
        jnp.asarray(np.pad(flat, (0, pad)).reshape(-1, 512)), scale,
        interpret=True)
    ref = [np.asarray(r).reshape(-1)[: flat.size] for r in ref[:3]]
    host_lib.host_quantize_vec.restype = ctypes.c_int32
    start = 0
    for n, buf in cases:
        tbuf = torch.as_tensor(buf)
        for off in range(8):
            x = tbuf[off: off + n]
            arr = torch.empty(n, dtype=torch.int32)
            a16 = torch.empty(n, dtype=torch.int16)
            m = torch.empty(n, dtype=torch.int8)
            over = host_lib.host_quantize_vec(
                _p(x), ctypes.c_int64(n), ctypes.c_float(scale), _p(arr),
                _p(a16), _p(m))
            q, p16, pm, pover = quantize_kernels.quantize_compact(x, scale)
            assert torch.equal(arr, q) and torch.equal(a16, p16)
            assert torch.equal(m, pm) and bool(over) == bool(pover)
            lo = start + off
            for got, want in zip((q, p16, pm), ref):
                np.testing.assert_array_equal(got.numpy(), want[lo: lo + n])
            assert bool(pover) == bool(
                (np.abs(ref[0][lo: lo + n].astype(np.int64)) > 32767).any())
        start += buf.size


@pytest.mark.parametrize("spread", [3.0, 900.0, 40000.0])
def test_quantize_source_equals_plain_version(host_lib, spread):
    """B6's element body: all four outputs equal the plain version's, the
    overflow flag set (spread 40000) and clear."""
    from spiht_tpu_torch.ops import quantize_kernels

    rng = np.random.default_rng(int(spread))
    x = torch.as_tensor((rng.standard_normal((3, 37, 29)) * spread)
                        .astype(np.float32))
    x[0, 0, :3] = torch.tensor([0.0, -0.99, 0.99])
    n = x.numel()
    arr = torch.empty(x.shape, dtype=torch.int32)
    a16 = torch.empty(x.shape, dtype=torch.int16)
    m = torch.empty(x.shape, dtype=torch.int8)
    host_lib.host_quantize.restype = ctypes.c_int32
    over = host_lib.host_quantize(_p(x), ctypes.c_int64(n),
                                  ctypes.c_float(1.7), _p(arr), _p(a16),
                                  _p(m))
    q, p16, pm, pover = quantize_kernels.quantize_compact(x, 1.7)
    assert torch.equal(arr, q) and torch.equal(a16, p16)
    assert torch.equal(m, pm)
    assert bool(over) == bool(pover) == (spread > 10000)


@pytest.mark.parametrize(
    "shape,ll",
    [
        ((3, 24, 32), (6, 8)),  # B5
        ((3, 19, 19), (5, 5)),  # odd LL: batched B3
    ],
)
def test_batched_setup_equals_plain_versions(host_lib, shape, ll):
    """Three streams of different budgets (one cut by the shared buffer,
    which sets its capacity error) and different lengths in one batch."""
    rng = np.random.default_rng(sum(shape) + 1)
    arrs = torch.as_tensor(np.stack([
        (rng.standard_normal(shape) * s).astype(np.int32)
        for s in (900, 3, 40000)
    ]))
    args = list(encoder.batch_machine_args(arrs, *ll, [333, 7, 2100]))
    args[7] = torch.tensor([333, 7, 2**31 - 2], dtype=torch.int32)
    _, ps = _host_encode_batch(host_lib, args)
    assert [row[1] for row in ps] == [0, 0, 1]  # the third exceeds cw*32
    (B, N), w = args[0].shape, args[5]

    full = [
        japi.encode(a, *ll, 2**31 - 2) for a in arrs.numpy()
    ]
    datas = [full[0][0][:7], full[1][0], full[2][0][: len(full[2][0]) // 2]]
    dw, nbits = decoder.words_batch(datas, "cpu")
    dargs = decoder.batch_machine_args(dw, nbits, [m for _, m in full],
                                       *shape, *ll)
    _, nb_t, mn_t, geo, lip0, lis0, _, caps = dargs
    seq = decoder.has_duplicate_parents(*shape[1:], *ll)
    lip, lis, lsp, lsp_val = (
        torch.empty(B, max(c, 1), dtype=torch.int32)
        for c in (caps[0], caps[1], caps[2], caps[2])
    )
    rec = torch.empty(B, N, dtype=torch.int32)
    stat = torch.empty(B, encoder.STAT_LEN, dtype=torch.int32)
    host_lib.host_decode_batch(
        ctypes.c_int(THREADS), ctypes.c_int(int(seq)), _i(B), _p(dw),
        _i(dw.shape[1]), _p(nb_t), _p(mn_t), _p(geo), _p(lip0),
        _i(lip0.numel()), _p(lis0), _i(lis0.numel()), _i(N), _i(w), _p(lip),
        _i(caps[0]), _p(lis), _i(caps[1]), _p(lsp), _i(caps[2]),
        _p(lsp_val), _p(rec), _p(stat),
    )
    if seq:
        prec, ps = decoder.decode_seq_batch(*dargs)
        assert stat.tolist() == ps.tolist()
        assert torch.equal(rec, prec)
        return
    pl, pv, ps = decoder.decode_lsp_batch(*dargs)
    assert stat.tolist() == ps.tolist()
    for b in range(B):
        live = int(ps[b, 0])
        assert torch.equal(lsp[b, :live], pl[b, :live])
        assert torch.equal(lsp_val[b, :live], pv[b, :live])


# The decode machines decide 32 LIP tokens or LIS entries a warp step and
# fall back to the bit-by-bit path for the step that meets the stream's end
# or a full queue; the cases below put that step everywhere.

SWEEP_THREADS = 32  # warp 0 alone is the block: half the host barriers


@pytest.mark.parametrize(
    "shape,ll,log",
    [
        ((3, 24, 32), (6, 8), False),  # B2
        ((3, 24, 32), (6, 8), True),   # B2-log
        ((3, 19, 19), (5, 5), False),  # B3 (odd LL)
        ((3, 19, 19), (5, 5), True),   # B3-log
    ],
    ids=["b2", "b2_log", "b3", "b3_log"],
)
def test_decode_machines_on_every_byte_prefix(host_lib, shape, ll, log):
    """Every byte prefix of a ~300-byte stream: the cut falls at every
    position of a warp step, in the LIP, inside a type-A fire's children
    and at a type-B fire, and the log's row at nbits with it."""
    rng = np.random.default_rng(sum(shape) + 5)
    arr = (rng.standard_normal(shape) * 900).astype(np.int32)
    data, max_n = japi.encode(arr, *ll, 2400)
    assert 290 <= len(data) <= 300
    for nbytes in range(len(data) + 1):
        _host_decode(host_lib, data[:nbytes], max_n, *shape, *ll, log=log,
                     threads=SWEEP_THREADS)


def _spikes(shape, rng, n, scale):
    arr = np.zeros(shape, np.int32)
    idx = rng.choice(arr.size, n, replace=False)
    arr.flat[idx] = (rng.standard_normal(n) * scale).astype(np.int32)
    return arr


@pytest.mark.parametrize(
    "shape,ll",
    [((3, 64, 64), (8, 8)), ((3, 67, 67), (9, 9))],
    ids=["b2", "b3"],
)
@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_decode_machines_across_chunks(host_lib, shape, ll, kind):
    """Passes longer than SPIHT_CHUNK (512) entries: a sparse array (a few
    spikes: long runs of unfired entries across chunk boundaries) and a
    dense one (steps of 32 fires), full and cut in the middle; B2 with
    its event log."""
    rng = np.random.default_rng(len(kind) + shape[1])
    arr = (_spikes(shape, rng, 40, 3000) if kind == "sparse" else
           (rng.standard_normal(shape) * 4000).astype(np.int32))
    data, max_n = japi.encode(arr, *ll, 2**31 - 2)
    lens = []
    for nbytes in (len(data) // 8, len(data) // 2 + 3, len(data)):
        stat = _host_decode(host_lib, data[:nbytes], max_n, *shape, *ll,
                            log=True)
        lens += stat[2:4]
    assert max(lens) > 512


@pytest.mark.parametrize(
    "shape,ll",
    [((3, 24, 32), (6, 8)), ((3, 19, 19), (5, 5))],
    ids=["b2", "b3"],
)
@pytest.mark.parametrize("which,err", [(0, 2), (1, 3), (2, 4)],
                         ids=["lip", "lis", "lsp"])
def test_decode_machines_at_narrowed_capacities(host_lib, shape, ll, which,
                                                err):
    """A queue capacity below the stream's need: the machine stops where
    the plain version stops, with its error code (2 LIP, 3 LIS, 4 LSP)."""
    rng = np.random.default_rng(sum(shape) + 6)
    arr = (rng.standard_normal(shape) * 900).astype(np.int32)
    data, max_n = japi.encode(arr, *ll, 2**31 - 2)
    words, nbits = decoder.words_tensor(data, "cpu")
    args = decoder.machine_args(words, nbits, max_n, *shape, *ll)
    init = (args[4].numel(), args[5].numel(), 0)
    full = _host_decode(host_lib, data, max_n, *shape, *ll)
    final = (full[2], full[3], full[4])  # the queues' final lengths
    errs = set()
    for frac in (0.3, 0.6, 0.9):
        caps = list(args[-1])
        caps[which] = max(init[which], int(final[which] * frac))
        for log in (False, True):
            errs.add(_host_decode(host_lib, data, max_n, *shape, *ll,
                                  log=log, caps=caps)[1])
    assert err in errs


@pytest.mark.parametrize("max_n", [4, 7, 11])
def test_seq_machine_on_random_words(host_lib, max_n):
    """Random words (not an encoder's stream) through B3's machine, whole
    and on every 7th byte prefix: where one node is committed twice close
    together (a node with two parents), or refined by two instances that
    read different bits, rec keeps what the sequential order leaves."""
    shape, ll = (3, 19, 19), (5, 5)
    rng = np.random.default_rng(max_n)
    data = rng.integers(0, 256, 400, dtype=np.uint8).tobytes()
    for nbytes in range(0, len(data) + 1, 7):
        _host_decode(host_lib, data[:nbytes], max_n, *shape, *ll)
    # the same words commit some node twice within one warp step's reach
    words, nbits = decoder.words_tensor(data, "cpu")
    args = decoder.machine_args(words, nbits, max_n, *shape, *ll)
    lsp, _, stat = decoder._decode_machine_plain(
        *args[:7], *args[7], False, 0)
    nodes = lsp[: int(stat[0])].tolist()
    assert any(nodes[i] in nodes[i + 1 : i + 33] for i in range(len(nodes)))


# B1's machine decides a chunk with the whole block and runs the first entry
# that meets the budget or a full queue bit by bit; the cases below put
# that entry everywhere, on blocks of two warps (64 threads, eight entries
# a thread: the cross-warp scan runs), of 256 (B4's shape) and of 512 (B1's).


def _bits(words, n):
    """The first n bits of an int32 word buffer, LSB-first."""
    raw = words.numpy().view(np.uint8)
    return np.unpackbits(raw, bitorder="little")[:n]


def _assert_prefix(words, full, nbits):
    """words hold the first nbits of the stream in full, then zeros."""
    assert np.array_equal(_bits(words, nbits), _bits(full, nbits))
    assert not _bits(words, words.numel() * 32)[nbits:].any()


@pytest.mark.parametrize(
    "shape,ll,scale",
    [((2, 16, 16), (4, 4), 6), ((2, 19, 19), (5, 5), 3)],
    ids=["even_ll", "odd_ll"],
)
def test_encoder_on_every_budget_edge(host_lib, shape, ll, scale):
    """A ~300-byte stream cut at every budget in 0-64, every 7th bit
    through it and each of its last 64 bits: B1's machine and B4's (the
    budgets as one batch) equal the plain version, words and stat, and
    the words are a prefix of the full stream's."""
    rng = np.random.default_rng(sum(shape) + 7)
    arr = torch.as_tensor((rng.standard_normal(shape) * scale).astype(np.int32))
    full, stat = _host_encode_args(
        host_lib, encoder.machine_args(arr, *ll, 2**31 - 2))
    nbits = stat[0]
    assert 2100 <= nbits <= 2700 and stat[1] == 0
    budgets = sorted(set(range(65)) | set(range(0, nbits, 7))
                     | set(range(nbits - 64, nbits + 1)))
    for mb in budgets:
        words, st = _host_encode_args(host_lib,
                                      encoder.machine_args(arr, *ll, mb))
        assert st[0] == mb
        _assert_prefix(words, full, mb)
    bargs = encoder.batch_machine_args(
        arr.expand(len(budgets), *shape).contiguous(), *ll, budgets)
    words, rows = _host_encode_batch(host_lib, bargs)
    assert [r[0] for r in rows] == budgets
    for b, mb in enumerate(budgets):
        _assert_prefix(words[b], full, mb)


@pytest.mark.parametrize("threads", [64, 256, 512])
def test_encoder_across_chunks(host_lib, threads):
    """Passes longer than a chunk: a dense 3x64x64 array whose LIP, LIS
    and LSP each pass 512 entries, whole and cut at an eighth and a half
    of its stream, alone and as one batch."""
    shape, ll = (3, 64, 64), (8, 8)
    rng = np.random.default_rng(3)
    arr = torch.as_tensor(
        (rng.standard_normal(shape) * 4000).astype(np.int32))
    full, stat = _host_encode_args(
        host_lib, encoder.machine_args(arr, *ll, 2**31 - 2), threads)
    budgets = [stat[0] // 8, stat[0] // 2 + 3, 2**31 - 2]
    seen = [stat]
    for mb in budgets[:2]:
        words, st = _host_encode_args(
            host_lib, encoder.machine_args(arr, *ll, mb), threads)
        _assert_prefix(words, full, mb)
        seen.append(st)
    assert all(max(st[i] for st in seen) > 512 for i in (2, 3, 4))
    if threads != 512:  # B4 runs 256-thread blocks
        bargs = encoder.batch_machine_args(
            arr.expand(3, *shape).contiguous(), *ll, budgets)
        _, rows = _host_encode_batch(host_lib, bargs, threads)
        assert rows == seen[1:] + seen[:1]


@pytest.mark.parametrize(
    "shape,ll",
    [((3, 24, 32), (6, 8)), ((3, 19, 19), (5, 5))],
    ids=["even_ll", "odd_ll"],
)
def test_encoder_at_narrowed_capacities(host_lib, shape, ll):
    """Every error code: a queue capacity below the stream's need stops
    the machine where the plain version stops, with its code (2 LIP, 3
    LIS, 4 LSP), and a budget cut by a small word buffer gives the
    capped code 1; alone and as one batch, on 64 and 256 threads."""
    rng = np.random.default_rng(sum(shape) + 6)
    arr = torch.as_tensor((rng.standard_normal(shape) * 900).astype(np.int32))
    args = list(encoder.machine_args(arr, *ll, 2**31 - 2))
    _, full = _host_encode_args(host_lib, args)
    init = (args[3].numel(), args[4].numel(), 0)
    errs = {}
    for which in range(3):
        for frac in (0.3, 0.6, 0.9):
            cut = list(args)
            caps = list(args[9])
            caps[which] = max(init[which], int(full[2 + which] * frac))
            cut[9] = tuple(caps)
            for threads in (64, 256):
                _, st = _host_encode_args(host_lib, cut, threads)
                errs.setdefault(which, set()).add(st[1])
            bargs = encoder.batch_machine_args(arr[None], *ll, [2**31 - 2])
            bargs = bargs[:8] + (tuple(caps),) + bargs[9:]
            _, rows = _host_encode_batch(host_lib, bargs)
            assert rows == [st]
    assert all(2 + which in errs[which] for which in range(3))
    # a budget of 21 words' bits clamped from a larger one: code 1
    capped = args[:7] + [21 * 32, True] + args[9:10] + [21]
    for threads in (64, 256):
        _, st = _host_encode_args(host_lib, capped, threads)
        assert st[:2] == [21 * 32, 1]
    bargs = encoder.batch_machine_args(arr[None], *ll, [10**6])
    bargs = bargs[:9] + (21,)
    _, rows = _host_encode_batch(host_lib, bargs)
    assert rows == [st]


@pytest.mark.parametrize("rows,niter", [(8, 24), (1, 9), (3, 50)])
def test_block_spike_source_equals_plain_version(host_lib, rows, niter):
    """``block_spike`` on 128 fibers: out, LSP, LIP and the words whole
    equal ``ref_model``'s, across wraps of every array (one row wraps each
    iteration) and the boundary words two iterations share."""
    from spiht_tpu_torch.tools import spike_pallas_block as tblock

    mag = torch.as_tensor(tblock.mag_of(rows))
    got = [torch.full((1, 4), -1, dtype=torch.int32)] + [
        torch.full((rows, tblock.LANES), -1, dtype=torch.int32)
        for _ in range(3)]
    host_lib.host_spike_block(_p(mag), _i(rows), _i(niter),
                              *(_p(t) for t in got))
    want = tblock.block(mag, niter)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# stand-ins of the cells' geometries: leading dims, (h, w), and the
# settings' scales; bior2.2's LL at level 2 is the cell's kind of LL
SYNTHESIS_GEOMETRIES = {
    # even LL 12x16 (Kodak), no crop; the bench's scales
    "kodak": ((2, 3), 36, 52, [100.0, 20.0, 20.0], 1.0),
    # odd LL 13x19 (UHD), pywt's crop on both axes; no per-channel scales
    "uhd": ((3,), 38, 61, None, 50.0),
    # benchmark/conftest.py's nuScenes 3x45x80, LL 15x23, a crop on H
    "nuscenes": ((2, 3), 45, 80, [100.0, 20.0, 20.0], 7.0),
}


def _host_synthesis(lib, rec, slices, settings, dtype, threads):
    """``synthesis_kernels``'s levels with each launch run on the host:
    every block of ``spiht_idwt_level`` on ``threads`` fibers."""
    from spiht_tpu_torch import _build
    from spiht_tpu_torch.ops import synthesis_kernels

    fn = lib.host_idwt_level
    fn.argtypes = (_build.SIGNATURES["spiht_synthesis"]
                   ["spiht_idwt_level_launch"][:-1] + [ctypes.c_int])
    fn.restype = ctypes.c_int

    def launch(*args):
        assert fn(*args, threads) == 0

    return synthesis_kernels._levels(rec, slices, settings, dtype, launch)


def _packed(rng, shape, in_dtype):
    """Packed coefficients: a spread of small values, zeros, and the
    dtype's extremes (past float32's 2^24 in int32)."""
    top = {torch.int16: 2**15 - 1, torch.int32: 2**31 - 1}.get(in_dtype,
                                                               2**40)
    q = rng.integers(-3000, 3000, shape)
    q[rng.random(shape) < 0.4] = 0
    edge = rng.random(shape) < 0.02
    q[edge] = rng.choice([-top, top, top - 1, -(top - 3)], int(edge.sum()))
    return torch.as_tensor(q).to(in_dtype)


def _float_bits(x):
    return x.view(torch.int64 if x.dtype == torch.float64 else
                  torch.int32).numpy()


@pytest.mark.parametrize("geometry", list(SYNTHESIS_GEOMETRIES))
@pytest.mark.parametrize("in_dtype", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["reflect", "periodization"])
@pytest.mark.parametrize("wavelet", ["bior2.2", "bior4.4", "db1", "coif4"])
def test_synthesis_source_equals_op_by_op_inverse(host_lib, wavelet, mode,
                                                  dtype, in_dtype, geometry):
    """``spiht_idwt_level`` a level, as host C++ on host fibers, through
    the wrapper's level loop: bit for bit the op-by-op ``inverse`` on the
    CPU (dequantize, ``dwt.waverec2``)."""
    from spiht_tpu_torch import SpihtSettings
    from spiht_tpu_torch.torch_transform import inverse
    from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w

    lead, h, w, pcs, q = SYNTHESIS_GEOMETRIES[geometry]
    settings = SpihtSettings(wavelet=wavelet, mode=mode, quantization_scale=q,
                             per_channel_quant_scales=pcs)
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, 2)
    rng = np.random.default_rng([len(lead), h, w, len(wavelet)])
    rec = _packed(rng, lead + (enc_h, enc_w), in_dtype)
    want = inverse(rec, h, w, 2, settings, dtype)
    got = _host_synthesis(host_lib, rec, slices, settings, dtype,
                          256 if geometry == "kodak" else 64)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_float_bits(got), _float_bits(want))


@pytest.mark.parametrize("level", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("wavelet", ["bior4.4", "db2", "db4"])
def test_synthesis_source_at_other_levels_and_cast_inputs(host_lib, wavelet,
                                                          level, dtype):
    """Levels 0 (the dequantized LL, no launch), 1 and 3, a 2-D array under
    per-channel scales (their broadcast makes the channels), and int64
    coefficients, which the wrapper casts to the working dtype first, for
    filters of 10, 4 and 8 taps: bit for bit the op-by-op ``inverse``."""
    from spiht_tpu_torch import SpihtSettings
    from spiht_tpu_torch.torch_transform import inverse
    from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w

    settings = SpihtSettings(wavelet=wavelet, mode="symmetric",
                             quantization_scale=3.0,
                             per_channel_quant_scales=[100, 20, 20])
    slices, enc_h, enc_w = get_slices_and_h_w(57, 70, settings, level)
    rng = np.random.default_rng(level)
    for shape, in_dtype in (((enc_h, enc_w), torch.int32),
                            ((2, 3, enc_h, enc_w), torch.int64)):
        rec = _packed(rng, shape, in_dtype)
        want = inverse(rec, 57, 70, level, settings, dtype)
        got = _host_synthesis(host_lib, rec, slices, settings, dtype, 64)
        assert got.shape == want.shape
        np.testing.assert_array_equal(_float_bits(got.contiguous()),
                                      _float_bits(want.contiguous()))


def test_synthesis_levels_refuse_a_short_packed_array():
    """A packed array smaller than the subbands is refused before any
    launch: the kernel would read past it."""
    from spiht_tpu_torch import SpihtSettings
    from spiht_tpu_torch.ops import synthesis_kernels
    from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w

    s = SpihtSettings()
    slices, enc_h, enc_w = get_slices_and_h_w(36, 52, s, 2)

    def launch(*args):
        raise AssertionError("launched")

    for shape in ((3, enc_h - 1, enc_w), (3, enc_h, enc_w - 1)):
        with pytest.raises(ValueError, match="do not hold"):
            synthesis_kernels._levels(torch.zeros(shape, dtype=torch.int32),
                                      slices, s, torch.float64, launch)


def test_inverse_on_the_cpu_launches_no_synthesis_kernel():
    """A CPU tensor takes the plain version: the kernel's launch counter
    does not move."""
    from spiht_tpu_torch import SpihtSettings
    from spiht_tpu_torch.ops import synthesis_kernels
    from spiht_tpu_torch.torch_transform import inverse

    n0 = synthesis_kernels.waverec2_packed.launches
    rec = torch.zeros((3, 40, 40), dtype=torch.int32)
    rec[0, 1, 2] = 500
    image = inverse(rec, 32, 32, 2, SpihtSettings(color_model="ipt"))
    assert image.device.type == "cpu" and bool(torch.isfinite(image).all())
    assert synthesis_kernels.waverec2_packed.launches == n0 == 0


def _ipt_image(case, dtype):
    """An IPT image of each kind the kernel reads: a contiguous batch (16-byte
    accesses throughout), a crop with its own row stride and a base off 16
    bytes, odd W (each row's ragged end, rows that alternate alignment),
    channels last (a column stride), leading dims that do not flatten into
    one stride (the wrapper's copy), and the edges: zeros, signed zeros,
    negative LMS', values far outside [0, 1] and subnormals."""
    rng = np.random.default_rng(sum(map(ord, case)))

    def draw(*shape):
        return torch.as_tensor(rng.uniform(-1.0, 2.0, shape)).to(dtype)

    if case == "batch":
        return draw(2, 3, 6, 16)
    if case == "crop":
        return draw(2, 3, 11, 29)[:, :, 2:9, 3:20]
    if case == "odd_w":  # rows 16 apart in, 13 out: every 4th row aligned
        return draw(3, 3, 4, 16)[..., :13]
    if case == "channels_last":
        return draw(2, 7, 9, 3).permute(0, 3, 1, 2)
    if case == "leading":
        return draw(2, 2, 3, 5, 8).transpose(0, 1)
    tiny = torch.finfo(dtype).smallest_normal
    edge = torch.tensor([0.0, -0.0, tiny / 4, -tiny / 4, tiny * 1e-3, tiny,
                         -3.5, 1e3, -1e3, 7.0, 0.5, -0.25], dtype=dtype)
    x = draw(3, 3, 4, 12)
    x[:, 0] = edge  # every row of I: each value against each P and T below
    x[1, 1:] = edge.flip(0)
    x[2, 1] = 0.0
    return x


def _host_ipt_pow(lib, x, p):
    x = x.contiguous()
    out = torch.empty_like(x)
    assert lib.host_ipt_pow(_i(x.dtype == torch.float64), _p(x),
                            ctypes.c_int64(x.numel()), ctypes.c_double(p),
                            _p(out)) == 0
    return out


@pytest.mark.parametrize("grid", ["3x64", "one_item_reversed"])
@pytest.mark.parametrize("case", ["batch", "crop", "odd_w", "channels_last",
                                  "leading", "edges"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_ipt_inverse_source_equals_op_by_op_model(host_lib, monkeypatch,
                                                  dtype, case, grid):
    """``spiht_ipt_inverse`` as host C++, through ``rgb_from_ipt``'s launch,
    on 3 host blocks of 64 fibers (a grid-stride loop of several rounds),
    or on one fiber a block and an item a block, the last block first:
    bit for bit ``torch_models.convert(x, "ipt", "RGB")``, its power taken
    by the kernel's own ``pow``, into a fresh contiguous tensor."""
    from spiht_tpu_torch import _build
    from spiht_tpu_torch.color import torch_models
    from spiht_tpu_torch.ops import synthesis_kernels

    fn = host_lib.host_ipt_inverse
    fn.argtypes = (_build.SIGNATURES["spiht_synthesis"]
                   ["spiht_ipt_inverse_launch"][:-1]
                   + [ctypes.c_int64, ctypes.c_int, ctypes.c_int])
    fn.restype = ctypes.c_int

    def launch(*args):
        if grid == "3x64":
            assert fn(*args, 3, 64, 0) == 0
        else:
            n, h, w = args[2:5]
            v = 16 // x.element_size()
            assert fn(*args, n * h * -(-w // v), 1, 1) == 0

    x = _ipt_image(case, dtype)
    got = synthesis_kernels._ipt_inverse(x, launch)
    lms_p = torch_models._apply_mat(x, torch_models._nm.LMS_FROM_IPT)
    if case == "edges":
        assert bool((lms_p < 0).any()) and bool((lms_p.abs() > 1).any())
        assert bool(((x != 0) & (x.abs() < torch.finfo(dtype)
                                 .smallest_normal)).any())
    monkeypatch.setattr(torch_models, "_signed_pow", lambda t, p: (
        torch.sign(t) * _host_ipt_pow(host_lib, torch.abs(t), p)))
    want = torch_models.convert(x, "ipt", "RGB")
    assert got.is_contiguous() and got.dtype == dtype
    assert got.shape == want.shape == x.shape
    assert torch.equal(got, want)
    np.testing.assert_array_equal(_float_bits(got), _float_bits(want))


@pytest.mark.parametrize("image,why", [
    (torch.zeros((2, 4, 5, 5)), "3, H, W"),
    (torch.zeros((3, 5)), "3, H, W"),
    (torch.zeros((3, 5, 5), dtype=torch.int32), "float32 or float64"),
    (torch.zeros((3, 5, 5), dtype=torch.float16), "float32 or float64"),
    (torch.zeros((3, 5, 5), device="meta"), "unsupported device"),
], ids=["c4", "2d", "int32", "float16", "meta"])
def test_rgb_from_ipt_refuses_what_the_kernel_cannot_take(image, why):
    """Four channels, a 2-D array, an integer or half dtype and a device
    that is neither the CPU nor CUDA: a ValueError, no launch."""
    from spiht_tpu_torch.ops import synthesis_kernels

    n0 = synthesis_kernels.rgb_from_ipt.launches
    with pytest.raises(ValueError, match=why):
        synthesis_kernels.rgb_from_ipt(image)
    assert synthesis_kernels.rgb_from_ipt.launches == n0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_rgb_from_ipt_on_the_cpu_runs_the_torch_ops(monkeypatch, dtype):
    """A CPU tensor goes through ``torch_models.convert`` itself, as it is:
    its output, no launch."""
    from spiht_tpu_torch.color import torch_models
    from spiht_tpu_torch.ops import synthesis_kernels

    calls = []
    real = torch_models.convert

    def spy(*args):
        calls.append(args[1:])
        return real(*args)

    monkeypatch.setattr(torch_models, "convert", spy)
    x = _ipt_image("crop", dtype)
    n0 = synthesis_kernels.rgb_from_ipt.launches
    got = synthesis_kernels.rgb_from_ipt(x)
    assert calls == [("ipt", "RGB")]
    assert torch.equal(got, real(x, "ipt", "RGB"))
    assert synthesis_kernels.rgb_from_ipt.launches == n0 == 0


@pytest.mark.parametrize("model", ["ipt", "IPT", "oklab"])
def test_inverse_on_the_cpu_keeps_the_op_by_op_model(model):
    """``inverse`` on the CPU, for IPT in either case and for another model:
    the plain DWT's plane through ``torch_models.convert``, bit for bit, and
    neither kernel's launch counter moves."""
    from spiht_tpu_torch import SpihtSettings
    from spiht_tpu_torch.color import torch_models
    from spiht_tpu_torch.ops import synthesis_kernels
    from spiht_tpu_torch.torch_transform import inverse
    from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w

    s = SpihtSettings(color_model=model, per_channel_quant_scales=[100, 20,
                                                                   20])
    slices, enc_h, enc_w = get_slices_and_h_w(36, 52, s, 2)
    rec = _packed(np.random.default_rng(5), (2, 3, enc_h, enc_w),
                  torch.int32)
    n0 = (synthesis_kernels.rgb_from_ipt.launches,
          synthesis_kernels.waverec2_packed.launches)
    got = inverse(rec, 36, 52, 2, s)
    plane = synthesis_kernels.waverec2_packed_plain(rec, slices, s,
                                                    torch.float64)
    want = torch_models.convert(plane, model, "RGB")
    assert torch.equal(got, want)
    assert (synthesis_kernels.rgb_from_ipt.launches,
            synthesis_kernels.waverec2_packed.launches) == n0 == (0, 0)
