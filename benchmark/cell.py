"""One run of one cell: set-up, the measured window, the check.

Set-up makes the cell's pool of images from the seed, then warms every
key the window will use with two round trips of its first request (a key's
first call builds the kernels, the host tables and the constants and
captures the program). The process runs with the configuration's
``host_threads`` intra-op threads, where it states them (a deployment's
setting, with its source under ``assumed``), and torch's default
otherwise. The window is the mix's loop
(``benchmark/loops/``): each round encodes one request (one image, or one
batch) from the host through the mix's entry point
(``benchmark/entries/``), decodes the streams it got back, and syncs; the
rounds cycle through the pool until ``seconds`` have passed. Every call is
timed on the host's clock and, in a traced run, wrapped in a
``record_function`` span; the first ``trace_rounds`` rounds run under
torch.profiler. Once the window has closed the peak memory is read, the
program's cached programs are dropped, and the plain reference checks a
seeded sample of the window's answers and every answer of its last round
(``check.py``).
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
import traceback

import numpy as np
import torch

from . import check, images, spec, trace

# traces of ``trace_rounds`` rounds taken before a trace without a kernel
# record fails the run (CUPTI now and then delivers none)
TRACE_TRIES = 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def budget(bpp: float, h: int, w: int) -> int:
    """The stream budget in bits: bpp x pixels, down to a whole byte."""
    return int(bpp * h * w) // 8 * 8


def requests(mix: dict, h: int, w: int) -> list:
    """The pool's requests, each (image indices, their budgets in bits):
    ``pool`` requests of ``batch`` images (1 by default), image i at
    ``bpp``, or at ``bpp[i % len(bpp)]`` where the mix gives a list."""
    b = int(mix.get("batch", 1))
    bpp = mix["bpp"] if isinstance(mix["bpp"], list) else [mix["bpp"]]
    out = []
    for r in range(int(mix["pool"])):
        idx = list(range(r * b, (r + 1) * b))
        out.append((idx, [budget(bpp[i % len(bpp)], h, w) for i in idx]))
    return out


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        dtype=torch.float64, t0: float = None) -> dict:
    """One run of ``cell`` (``spec.cell``'s dict); the result line's
    object, with the compared numbers under ``checks``."""
    t0 = time.perf_counter() if t0 is None else t0
    cfg, mix = cell["config"], cell["traffic"]
    entry = spec.entry(mix["entry"])
    drive = spec.loop(mix["loop"]).drive
    enc_dir, dec_dir = entry.DIRECTIONS
    if cfg.get("host_threads"):
        torch.set_num_threads(int(cfg["host_threads"]))
    dev = torch.device(device)
    c, h, w = cfg["shape"]
    reqs = requests(mix, h, w)
    tp = time.perf_counter()
    pool = images.make(sum(len(i) for i, _ in reqs), h, w, seed, dev)
    import spiht_tpu_torch

    sut = entry.Entry(spiht_tpu_torch.SpihtSettings(**cfg["settings"]),
                      cfg.get("level"), dev, dtype)

    def encode(req):
        idx, budgets = req
        return sut.encode([pool[i] for i in idx], budgets)

    warm = [time.perf_counter()]
    for _ in range(2):  # warm every key the window uses
        sut.decode(encode(reqs[0]))
        warm.append(time.perf_counter())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s: to the pool {tp - t0:.3f}, pool "
        f"{warm[0] - tp:.3f}, warm round trips {warm[1] - warm[0]:.3f} and "
        f"{warm[2] - warm[1]:.3f}; window {seconds} s; "
        f"{torch.get_num_threads()} host threads")

    calls, counts = [], {"attempted": 0, "failed": 0}
    sample = check.Sample(mix["check_sample"], seed)
    last = []  # every answer of the last round
    tr = {"prof": _profiler() if traced else None, "tries": 0, "ops": [],
          "spans": {}}

    def one_round(r):
        req = reqs[r % len(reqs)]
        idx, budgets = req
        counts["attempted"] += 2
        ers, t = _call(tr["prof"], enc_dir, r, encode, req)
        calls.append(_record(entry, enc_dir, r, t, idx, h, w, ers,
                             sut.stage_s()))
        out = None
        if ers is not None:
            out, t = _call(tr["prof"], dec_dir, r, sut.decode, ers)
            calls.append(_record(entry, dec_dir, r, t, idx, h, w, ers))
        counts["failed"] += (ers is None) + (out is None)
        last.clear()
        if out is not None:
            for k, i in enumerate(idx):
                answer = (i, budgets[k], ers[k].encoded_bytes, ers[k].max_n,
                          out[k])
                last.append(answer)
                sample.offer(lambda a=answer: a[:4] + (a[4].clone(),))
        if tr["prof"] is not None and (r + 1) % int(mix["trace_rounds"]) == 0:
            tr["prof"].__exit__(None, None, None)
            ops, spans = trace.read_trace(tr["prof"])
            tr["prof"], tr["tries"] = None, tr["tries"] + 1
            if any(o[1] == "kernel" for o in ops):
                tr["ops"], tr["spans"] = ops, spans
            elif tr["tries"] < TRACE_TRIES:
                log(f"trace {tr['tries']}: no kernel record; tracing again")
                tr["prof"] = _profiler()
            else:
                raise RuntimeError(
                    f"{tr['tries']} traces held no kernel record")

    tw = time.perf_counter()
    rounds = drive(one_round, mix, seconds)
    window_s = time.perf_counter() - tw
    if tr["prof"] is not None:  # the window ended before the traced rounds
        tr["prof"].__exit__(None, None, None)
        tr["ops"], tr["spans"] = trace.read_trace(tr["prof"])
        if not any(o[1] == "kernel" for o in tr["ops"]):
            raise RuntimeError("the trace held no kernel record")
    attempted, failed = counts["attempted"], counts["failed"]
    log(f"window {window_s:.3f} s: {rounds} rounds, {attempted} calls, "
        f"{failed} failed")
    for d in (enc_dir, dec_dir):
        ms = np.array([1e3 * c["seconds"] for c in calls
                       if c["direction"] == d])
        if ms.size:
            q = np.percentile(ms, [50, 90, 95, 99])
            log(f"{d}: {ms.size} calls, ms p50 {q[0]:.4f} p90 {q[1]:.4f} "
                f"p95 {q[2]:.4f} p99 {q[3]:.4f} max {ms.max():.4f}")

    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else "cpu"),
                "count": int(cell["chips"]),
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                      if dev.type == "cuda" else 0)}
    metrics = {}
    result_extra = {}
    if traced:
        spans = tr["spans"]
        rec = trace.Records(
            ops=tr["ops"],
            spans=[dict(c, start_us=spans[(c["direction"], c["call"])][0],
                        end_us=spans[(c["direction"], c["call"])][1])
                   for c in calls if (c["direction"], c["call"]) in spans],
            geometry=_geometry(cfg, dtype), calls=calls)
        busy_s, traced_s = trace.busy_and_window(rec)
        dev_info["busy_s"], dev_info["window_s"] = busy_s, traced_s
        for m in cell["per_layer"]:
            read, direction = spec.layer_reader(m["name"])
            v = read(rec, direction)
            if v is None:  # a metric the cell lists never goes silent
                raise RuntimeError(f"{m['name']}: the trace held nothing "
                                   f"for it to read")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result_extra["breakdown"] = trace.breakdown(rec)
    else:
        window = {"calls": calls}
        for m in cell["end_to_end"]:
            v = setup_s if m["name"] == "setup_s" else spec.e2e_reader(
                m["name"])(window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the program's state goes before the reference runs on the device
    del sut
    from spiht_tpu_torch import torch_transform
    torch_transform.clear_programs()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    checks = check.compare(sample.kept + last, pool, cfg, failed, dev)
    log(f"check of {len(sample.kept)} sampled of {sample.seen} answers and "
        f"the last round's {len(last)}: {time.perf_counter() - tc:.3f} s")
    return {"correct": check.passed(checks), "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": dev_info,
            **result_extra, "checks": checks}


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def _call(prof, direction: str, r: int, fn, arg):
    """(fn(arg) or None if it raised, host seconds), in a span when
    traced."""
    span = (torch.profiler.record_function(f"bench/{direction}/{r}")
            if prof is not None else contextlib.nullcontext())
    with span:
        t1 = time.perf_counter()
        try:
            out = fn(arg)
        except Exception:  # a failed call is counted, and the loop goes on
            log(traceback.format_exc())
            out = None
        t = time.perf_counter() - t1
    return out, t


def _record(entry, direction, r, t, idx, h, w, ers, stage_s=None) -> dict:
    rec = {"direction": direction, "api": entry.API[direction], "call": r,
           "seconds": t, "images": len(idx), "pixels": len(idx) * h * w,
           "bits": (sum(8 * len(e.encoded_bytes) for e in ers)
                    if ers is not None else 0)}
    if stage_s is not None:
        rec["stage_s"] = stage_s
    return rec


def _geometry(cfg: dict, dtype) -> dict:
    from .reference import transform as ref

    c, h, w = cfg["shape"]
    geo = ref.geometry(h, w, cfg.get("level"))
    item = torch.tensor([], dtype=dtype).element_size()
    return {"c": c, "h": h, "w": w, "enc_h": geo["enc_h"],
            "enc_w": geo["enc_w"], "image_in_bytes": c * h * w * 4,
            "image_out_bytes": c * h * w * item,
            "coeff_bytes": c * geo["enc_h"] * geo["enc_w"] * 4}
