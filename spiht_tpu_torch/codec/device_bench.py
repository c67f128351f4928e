"""On-device codec benchmark: the port's lanes, timed and held exact, as
one JSON line. The port of ``spiht_tpu/codec/device_bench.py``.

Run as::

    python -m spiht_tpu_torch.codec.device_bench [HxW [level [bpp]]] \\
        [fast=1] [batch=B] [ebatch=B] [device=cpu]

with ``SPIHT_TPU_BENCH_ILV`` (default 16; 0 or empty skips the lane) as
the batch of the interleaved lane. The defaults are the reference's:
512x512, level 6, 1.0 bpp, ``SpihtSettings()``, on its synthetic image
(sin/cos plus noise, ``default_rng(1234)``). It runs on the card;
``device=cpu`` runs the kernels' plain versions on the CPU instead (the
tests). Without a card and without ``device=cpu`` it exits 2. Progress
goes to stderr, exactly one JSON line to stdout.

Lanes, each at ``full`` (no budget) and at ``{bpp}bpp`` where the
reference has both:

* encode: ``""``, ``pallas_encode_fn`` (kernel B1); ``enc_sorted``, the
  sorted-space machine (``device_encoder.encode_device_fn``);
* decode: ``dec``, ``pallas_decode_fn`` (B2 and the rec scatter, B3 at
  odd LL; int16 rec for max_n <= 13); ``dec_hybrid``, the hybrid machine
  (``device_decoder.decode_device_fn``);
* ``enc_pipeline`` / ``pipeline`` (``dec_pipeline`` in the rate keys):
  ``torch_transform.encode_pipeline_fn`` (image -> stream) and
  ``decode_pipeline_fn`` (stream -> uint8 image), float64;
* ``batch=B`` / ``ebatch=B``: ``decode_device_batch`` and
  ``encode_device_batch`` over B noisy copies of the image (routed by the
  ``SPIHT_TPU_PALLAS_*`` flags: B5 and B4 on the card);
* ``ilv{B}``: ``pallas_encode_batch_fn`` (B4) and
  ``pallas_decode_batch_fn`` (B5, or batched B3 at odd LL) at
  B = ``SPIHT_TPU_BENCH_ILV``.

``fast=1`` drops ``enc_sorted`` and ``dec_hybrid``. Every lane holds its
output against the port's copy of the native scheduler
(``native/runtime.py``): ``exact_*``.

Timing: ``ms_*`` and ``mpps_*`` are the median of 3 calls after one warm
call, by the host clock up to the result on the host (a real copy over
PCIe; the reference's ``_materialized``). ``mpps_*_kernel`` times the
same function, with nothing copied to the host, by its kernels' time on
the device: the sum of the kernel durations in torch.profiler's trace of
3 calls after a warm call, over 3. Host gaps between launches, the
copies and a host sync inside the function are not counted, so it is at
most the host time (on the CPU, where there is no device, it is the
host clock). CUPTI now and then delivers no kernel record for a whole
trace: an empty trace is taken again, up to 3 traces, and after the third
the time of the 3 calls comes from CUDA events around them (host gaps
between launches included). ``kernel_clock_<lane>`` says which clock gave
the lane's ``mpps_*_kernel``: ``profiler``, ``events`` or ``host``.

Keys: the reference's, less ``*_modeled_host`` (a TPU host's modelled
link, no measurement here) and the cache file's ``commit``, plus
``card`` and ``power_limit_w`` (``nvidia-smi``; null on the CPU),
``launches_<lane>`` (each lane's kernel launches, by the wrappers'
counters, warm and kernel-timing calls included; empty on the CPU),
``kernel_clock_<lane>`` (above) and
``exact_pipeline_{bpp}bpp`` (the decode pipeline's image equal to the
inverse of the native decode). Nothing is cached and no failure is
swallowed: a lane that raises ends the run with the exception and no
line; a false ``exact_*`` prints the line and exits 1.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

FULL = 2**31 - 2
# torch.profiler traces a lane takes before its kernel time falls back to
# CUDA events
PROFILE_TRIES = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _native():
    """The port's copy of the native scheduler, the lanes' reference."""
    from ..native import runtime

    return runtime.load()


def _wrappers() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from ..ops.quantize_kernels import quantize_compact
    from . import decoder, encoder

    return {
        "spiht_encode": encoder.encode_machine,
        "spiht_encode_seq": encoder.encode_machine_seq,
        "spiht_encode_batch": encoder.encode_machine_batch,
        "spiht_decode_lsp": decoder.decode_lsp,
        "spiht_decode_seq": decoder.decode_seq,
        "spiht_decode_lsp_batch": decoder.decode_lsp_batch,
        "spiht_decode_seq_batch": decoder.decode_seq_batch,
        "spiht_decode_lsp_log": decoder.decode_lsp_log,
        "spiht_decode_seq_log": decoder.decode_seq_log,
        "spiht_quantize_compact": quantize_compact,
    }


def _card():
    """(name, power limit in W) from nvidia-smi, as the tools print it."""
    from ..tools import card

    name, limit = (s.strip() for s in card().split(",", 1))
    return name, float(limit.split()[0])


def _parse(argv):
    pos = [a for a in argv if "=" not in a]
    kw = dict(a.split("=", 1) for a in argv if "=" in a)
    unknown = set(kw) - {"fast", "batch", "ebatch", "device"}
    if unknown or len(pos) > 3:
        raise SystemExit(f"device_bench: unknown arguments {argv}")
    h, w = (int(v) for v in (pos[0] if pos else "512x512").split("x"))
    level = int(pos[1]) if len(pos) > 1 else 6
    bpp = float(pos[2]) if len(pos) > 2 else 1.0
    return (h, w, level, bpp, kw.get("fast") == "1",
            int(kw.get("batch", 0)), int(kw.get("ebatch", 0)),
            kw.get("device"))


def synthetic_image(h: int, w: int) -> np.ndarray:
    """The reference bench's 3xHxW image in [0, 1]."""
    rng = np.random.default_rng(1234)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    im = np.stack([
        0.5 + 0.25 * np.sin(xx / 37.0 + c) * np.cos(yy / 53.0)
        + 0.15 * (xx / w > 0.4)
        for c in range(3)
    ])
    return np.clip(im + 0.05 * rng.standard_normal(im.shape), 0, 1)


def _noisy(im, b):
    """The reference's batch member b: the image plus seeded noise."""
    return np.clip(
        im + 0.03 * np.random.default_rng(b).standard_normal(im.shape), 0, 1)


class _Bench:
    def __init__(self, dev: torch.device):
        self.dev = dev
        self.wrappers = _wrappers()
        self.out = {}

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def host(self, fn, *args):
        """(first call s, median of 3 s, last host result): each call up
        to its result on the host (``fn`` returns it there)."""
        t0 = time.perf_counter()
        res = fn(*args)
        first = time.perf_counter() - t0
        ts = []
        for _ in range(3):
            t1 = time.perf_counter()
            res = fn(*args)
            ts.append(time.perf_counter() - t1)
        return first, sorted(ts)[1], res

    def device(self, fn, *args) -> tuple[float, str]:
        """(the device's kernel time (s) of one call of ``fn`` after a warm
        call, the clock that gave it): on the card, the sum of the
        kernels' durations in torch.profiler's trace of 3 calls, over 3
        (host gaps between launches and copies are not counted), or CUDA
        events around the 3 calls if ``PROFILE_TRIES`` traces held no
        kernel; on the CPU, the median of 3 by the host clock."""
        fn(*args)
        self.sync()
        if self.dev.type != "cuda":
            return self.host(fn, *args)[1], "host"
        for n in range(PROFILE_TRIES):
            s = self.profiled(fn, *args)
            if s > 0:
                return s, "profiler"
            log(f"  torch.profiler recorded no kernel time (trace {n + 1} "
                f"of {PROFILE_TRIES})")
        return self.events(fn, *args), "events"

    def profiled(self, fn, *args) -> float:
        """torch.profiler's kernel time (s) of one of 3 calls; 0 if the
        trace holds no kernel."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn(*args)
            self.sync()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not e.key.startswith(("Memcpy", "Memset")))
        return us / 3 / 1e6

    def events(self, fn, *args) -> float:
        """CUDA events' time (s) of one of 3 calls, host gaps included."""
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(3):
            fn(*args)
        e1.record()
        self.sync()
        return e0.elapsed_time(e1) / 3 / 1e3

    def lane(self, key, run):
        """Run ``run()`` and record the kernel launches it made."""
        before = {n: f.launches for n, f in self.wrappers.items()}
        run()
        self.out[f"launches_{key}"] = {
            n: f.launches - before[n] for n, f in self.wrappers.items()
            if f.launches != before[n]
        }

    def rates(self, key, px, med, timed):
        kernel_s, clock = timed
        self.out[f"mpps_{key}_kernel"] = px / 1e6 / kernel_s
        self.out[f"mpps_{key}_materialized"] = px / 1e6 / med
        self.out[f"kernel_clock_{key}"] = clock
        log(f"  {key}: kernel ({clock}) {kernel_s * 1e3:.2f} ms = "
            f"{px / 1e6 / kernel_s:.2f} MP/s; to the host "
            f"{med * 1e3:.2f} ms")


def main(argv=None) -> int:
    from .. import transform
    from ..settings import SpihtSettings

    h_in, w_in, level, bpp, fast, batch, ebatch, device = _parse(
        sys.argv[1:] if argv is None else argv)
    if device is None and not torch.cuda.is_available():
        log("device_bench: no CUDA device (device=cpu runs the plain "
            "versions on the CPU)")
        return 2
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ilv = os.environ.get("SPIHT_TPU_BENCH_ILV", "16")
    ilv = int(ilv) if ilv not in ("0", "") else 0

    im = synthetic_image(h_in, w_in)
    settings = SpihtSettings()
    arr, llh, llw = transform.forward_numpy(im, settings, level)
    arr = arr.astype(np.int32)
    c, h, w = arr.shape
    nat = _native()
    mb_bpp = int(round(bpp * h_in * w_in))
    tags = (("full", FULL), (f"{bpp}bpp", mb_bpp))
    bench = _Bench(dev)
    out = bench.out
    out.update(geom=f"{c}x{h}x{w}", level=level, backend=dev.type)
    out["card"], out["power_limit_w"] = (
        _card() if dev.type == "cuda" else (None, None))
    log(f"device bench: device={dev} card={out['card']} "
        f"power_limit_w={out['power_limit_w']} geom={arr.shape} "
        f"ll=({llh},{llw})")
    args = (bench, nat, arr, llh, llw, tags)
    _encode_lanes(*args, fast)
    _decode_lanes(*args, fast)
    pargs = (bench, nat, im, settings, level, arr, llh, llw, mb_bpp, bpp)
    _pipeline_lanes(*pargs)
    if batch:
        _batch_lane(*pargs, batch)
    if ebatch:
        _encode_batch_lane(*pargs, ebatch)
    if ilv:
        _ilv_lane(*pargs, ilv)
    print(json.dumps(out), flush=True)
    bad = sorted(k for k, v in out.items() if k.startswith("exact_") and not v)
    if bad:
        log(f"device bench: not exact: {bad}")
        return 1
    return 0


def _encode_lanes(bench, nat, arr, llh, llw, tags, fast):
    """B1 (lane ""), and the sorted-space machine unless ``fast``."""
    from .device_encoder import encode_device_fn
    from .encoder import cap_words_for, pallas_encode_fn, stream_bytes
    from .maxn import device_max_n

    dev, out = bench.dev, bench.out
    c, h, w = arr.shape
    mn = int(device_max_n(torch.as_tensor(arr)))
    ja = torch.as_tensor(arr).to(dev)
    lanes = [("", lambda mb: pallas_encode_fn(
        c, h, w, llh, llw, cap_words_for(c, h, w, mb), device=dev))]
    if not fast:
        lanes.append(("enc_sorted",
                      lambda mb: encode_device_fn(c, h, w, llh, llw)))
    for tag, mb in tags:
        want, wmn = nat.encode(arr, llh, llw, mb)
        for lane, make in lanes:
            key = f"{lane}_{tag}" if lane else tag
            fn = make(mb)

            def run():
                def call():
                    words, total, ovf = fn(ja, mn, mb)
                    return words.cpu(), int(total), bool(ovf)

                first, med, (words, total, ovf) = bench.host(call)
                exact = (not ovf and wmn == mn
                         and stream_bytes(words, total) == want)
                px = c * h * w
                out[f"mpps_{key}"] = px / 1e6 / med
                out[f"ms_{key}"] = med * 1e3
                out[f"exact_{key}"] = exact
                log(f"encode[{lane or 'enc'}] {tag}: first {first:.2f} s, "
                    f"median {med * 1e3:.2f} ms = {px / 1e6 / med:.2f} "
                    f"MP/s, bits={total}, exact={exact}")

            bench.lane(key, run)


def _decode_lanes(bench, nat, arr, llh, llw, tags, fast):
    """B2/B3 (lane "dec", with device time), and the hybrid machine
    unless ``fast``."""
    from .decoder import pallas_decode_fn, words_tensor
    from .device_decoder import decode_device_fn

    dev, out = bench.dev, bench.out
    c, h, w = arr.shape
    for tag, mb in tags:
        data, dmn = nat.encode(arr, llh, llw, mb)
        want = nat.decode(data, dmn, c, h, w, llh, llw)
        jw, nbits = words_tensor(data, dev)
        cw = jw.numel()
        od = "int16" if dmn <= 13 else "int32"
        lanes = [("dec", pallas_decode_fn(c, h, w, llh, llw, cw,
                                          out_dtype=od, device=dev))]
        if not fast:
            lanes.append(("dec_hybrid",
                          decode_device_fn(c, h, w, llh, llw, cw)))
        for lane, fn in lanes:
            key = f"{lane}_{tag}"

            def run():
                first, med, rec = bench.host(
                    lambda: fn(jw, nbits, dmn).cpu())
                exact = bool(np.array_equal(rec.numpy(), want))
                px = c * h * w
                out[f"mpps_{key}"] = px / 1e6 / med
                out[f"ms_{key}"] = med * 1e3
                out[f"exact_{key}"] = exact
                log(f"decode[{lane}] {tag}: first {first:.2f} s, median "
                    f"{med * 1e3:.2f} ms = {px / 1e6 / med:.2f} MP/s, "
                    f"exact={exact}")
                if lane == "dec":
                    bench.rates(key, px, med,
                                bench.device(fn, jw, nbits, dmn))

            bench.lane(key, run)


def _pipeline_lanes(bench, nat, im, settings, level, arr, llh, llw, mb,
                    bpp):
    """image -> stream and stream -> uint8 image, one pipeline each."""
    from ..torch_transform import (
        analysis_fn, decode_pipeline_fn, encode_pipeline_fn, inverse,
    )
    from .decoder import words_tensor
    from .encoder import check_stat, stream_bytes

    dev, out = bench.dev, bench.out
    c, h, w = arr.shape
    h_in, w_in = im.shape[1:]
    jim = torch.as_tensor(im).to(dev)
    efn = encode_pipeline_fn(settings, level)
    key = f"enc_pipeline_{bpp}bpp"

    def run_enc():
        def call():
            words, stat, mn = efn(jim, mb)
            return words.cpu(), stat.cpu(), int(mn)

        first, med, (words, stat, emn) = bench.host(call)
        # ground truth: the native encode of the same device coefficients
        arr_dev = analysis_fn(settings, level, False)(jim).cpu().numpy()
        want, wmn = nat.encode(arr_dev, llh, llw, mb)
        total = check_stat(stat, "spiht_encode")[0]
        exact = emn == wmn and stream_bytes(words, total) == want
        out[f"ms_{key}"] = med * 1e3
        out[f"exact_{key}"] = exact
        log(f"encode pipeline {bpp}bpp image->stream: first {first:.2f} s, "
            f"median {med * 1e3:.2f} ms, exact={exact}")
        bench.rates(key, c * h * w, med, bench.device(efn, jim, mb))

    bench.lane(key, run_enc)

    data, dmn = nat.encode(arr, llh, llw, mb)
    jw, nbits = words_tensor(data, dev)
    pfn = decode_pipeline_fn(settings, h_in, w_in, level, c, as_uint8=True)
    key = f"dec_pipeline_{bpp}bpp"

    def run_dec():
        first, med, img = bench.host(lambda: pfn(jw, nbits, dmn).cpu())
        rec = torch.as_tensor(nat.decode(data, dmn, c, h, w, llh, llw))
        want = inverse(rec.to(dev), h_in, w_in, level, settings,
                       as_uint8=True).cpu()
        exact = bool(torch.equal(img, want))
        out[f"ms_pipeline_{bpp}bpp"] = med * 1e3
        out[f"exact_pipeline_{bpp}bpp"] = exact
        log(f"decode pipeline {bpp}bpp -> uint8 image: first {first:.2f} "
            f"s, median {med * 1e3:.2f} ms, exact={exact}")
        bench.rates(key, c * h * w, med, bench.device(pfn, jw, nbits, dmn))

    bench.lane(key, run_dec)


def _streams(nat, im, settings, level, llh, llw, mb, B):
    """B noisy copies' coefficients and their native streams."""
    from .. import transform

    arrs, wants = [], []
    for b in range(B):
        a, _, _ = transform.forward_numpy(_noisy(im, b), settings, level)
        arrs.append(a.astype(np.int32))
        wants.append(nat.encode(arrs[-1], llh, llw, mb))
    return np.stack(arrs), wants


def _batch_lane(bench, nat, im, settings, level, arr, llh, llw, mb, bpp,
                B):
    """``decode_device_batch`` over B streams, to the host."""
    from .device_decoder import decode_device_batch

    c, h, w = arr.shape
    _, wants = _streams(nat, im, settings, level, llh, llw, mb, B)
    datas = [d for d, _ in wants]
    ns = [n for _, n in wants]
    key = f"dec_batch{B}"

    def run():
        first, med, recs = bench.host(
            decode_device_batch, datas, ns, c, h, w, llh, llw, bench.dev)
        exact = all(np.array_equal(recs[b], nat.decode(
            datas[b], ns[b], c, h, w, llh, llw)) for b in range(B))
        mpps = B * c * h * w / 1e6 / med
        bench.out["batch"] = B
        bench.out[f"mpps_{key}"] = mpps
        bench.out[f"exact_{key}"] = exact
        log(f"decode batch={B} @{bpp}bpp: first {first:.2f} s, median "
            f"{med * 1e3:.2f} ms = {mpps:.2f} MP/s aggregate, "
            f"exact={exact}")

    bench.lane(key, run)


def _encode_batch_lane(bench, nat, im, settings, level, arr, llh, llw, mb,
                       bpp, B):
    """``encode_device_batch`` over B images' coefficients, to bytes."""
    from .device_encoder import encode_device_batch

    c, h, w = arr.shape
    arrs, wants = _streams(nat, im, settings, level, llh, llw, mb, B)
    key = f"enc_batch{B}"

    def run():
        first, med, got = bench.host(
            encode_device_batch, arrs, llh, llw, [mb] * B, bench.dev)
        exact = [tuple(g) for g in got] == [tuple(x) for x in wants]
        mpps = B * c * h * w / 1e6 / med
        bench.out["ebatch"] = B
        bench.out[f"mpps_{key}"] = mpps
        bench.out[f"exact_{key}"] = exact
        log(f"encode batch={B} @{bpp}bpp: first {first:.2f} s, median "
            f"{med * 1e3:.2f} ms = {mpps:.2f} MP/s aggregate, "
            f"exact={exact}")

    bench.lane(key, run)


def _ilv_lane(bench, nat, im, settings, level, arr, llh, llw, mb, bpp, B):
    """B streams in one launch each way: B4, and B5 (batched B3 at odd
    LL), with device times."""
    from .decoder import pallas_decode_batch_fn, words_batch
    from .encoder import batch_stream_bytes, cap_words_for
    from .encoder import pallas_encode_batch_fn

    dev, out = bench.dev, bench.out
    c, h, w = arr.shape
    px = B * c * h * w
    arrs, wants = _streams(nat, im, settings, level, llh, llw, mb, B)
    mns = [n for _, n in wants]
    ja = torch.as_tensor(arrs).to(dev)
    jmn = torch.tensor(mns, dtype=torch.int32).to(dev)
    efn = pallas_encode_batch_fn(c, h, w, llh, llw,
                                 cap_words_for(c, h, w, mb), device=dev)
    key = f"enc_ilv{B}"

    def run_enc():
        def call():
            words, totals, ovf = efn(ja, jmn, [mb] * B)
            return words.cpu(), totals.tolist(), bool(ovf.any())

        first, med, (words, totals, ovf) = bench.host(call)
        exact = not ovf and batch_stream_bytes(words, totals) == [
            d for d, _ in wants]
        out[f"mpps_{key}"] = px / 1e6 / med
        out[f"exact_{key}"] = exact
        log(f"encode ilv B={B} @{bpp}bpp: first {first:.2f} s, median "
            f"{med * 1e3:.2f} ms = {px / 1e6 / med:.2f} MP/s aggregate, "
            f"exact={exact}")
        bench.rates(key, px, med, bench.device(efn, ja, jmn, [mb] * B))

    bench.lane(key, run_enc)

    datas = [d for d, _ in wants]
    jw, nbits = words_batch(datas, dev)
    od = "int16" if max(mns) <= 13 else "int32"
    dfn = pallas_decode_batch_fn(c, h, w, llh, llw, jw.shape[1],
                                 out_dtype=od, device=dev)
    key = f"dec_ilv{B}"

    def run_dec():
        first, med, rec = bench.host(lambda: dfn(jw, nbits, mns).cpu())
        exact = all(np.array_equal(rec[b].numpy(), nat.decode(
            datas[b], mns[b], c, h, w, llh, llw)) for b in range(B))
        out[f"mpps_{key}"] = px / 1e6 / med
        out[f"exact_{key}"] = exact
        log(f"decode ilv B={B} @{bpp}bpp: first {first:.2f} s, median "
            f"{med * 1e3:.2f} ms = {px / 1e6 / med:.2f} MP/s aggregate, "
            f"exact={exact}")
        bench.rates(key, px, med, bench.device(dfn, jw, nbits, mns))

    bench.lane(key, run_dec)


if __name__ == "__main__":
    sys.exit(main())
