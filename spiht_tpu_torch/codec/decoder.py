"""SPIHT decode machines: routing, the CUDA kernels' wrappers and their
plain versions. The port of ``spiht_tpu/codec/pallas_decoder.py``
(``_has_duplicate_parents`` :138-146, ``pallas_decode_fn`` :149-182, the
rec scatter :1339-1368 and its batched form :2086-2099, ``pallas_decode``
:2104, ``pallas_decode_batch`` :2160).

* ``decode_lsp`` (kernel B2, ``csrc/spiht_decode.cu``) decodes geometries
  without duplicate parents. It writes the LSP queues (node, and
  sgn<<31 | magnitude) and a count; ``scatter_rec`` then builds rec.
  ``decode_lsp_log`` (B2-log, the port of the ``with_log`` variant
  :571-579) also writes the metadata trace's compact event log
  (``meta_expand.py`` expands it).
* ``decode_seq`` (kernel B3) decodes odd-LL geometries, whose parity
  offspring map has duplicate parents: a node may be committed several
  times and every LSP instance refines one shared rec value, so rec lives
  in the kernel. ``decode_seq_log`` (B3-log) also writes the event log,
  each word with the filter of the node's instance.

* ``decode_lsp_batch`` (kernel B5) and ``decode_seq_batch`` (B3 over a
  grid) decode B streams of one geometry in one launch, one block per
  stream, each stopping at its own length; ``decode_coeffs_batch`` routes
  a batch as ``decode_coeffs`` routes one stream.

Each wrapper takes its plain version (``_decode_machine_plain``, the same
state layout, stream by stream for a batch) for CPU tensors only; for
CUDA tensors it launches the kernel or raises. All honour byte-prefix
truncation exactly.

The JAX package's ``pallas_decode``, ``pallas_decode_fn``,
``pallas_decode_batch`` and ``pallas_decode_batch_fn`` are thin functions
over B2, B3 and B5, with the reference's signatures less the TPU-only
``interpret``; ``machine_fits``, ``interleaved_fits`` and
``MachineResourceLimit`` answer the port's limits (``encoder.py``), B5
taking only duplicate-free geometries, as the reference's interleaved
machine does. For a ``machine`` of None the four read the reference's
switch ``SPIHT_TPU_PALLAS_DEC_MACHINE`` (``seq``: B3 in every geometry).
``pallas_decode_batch`` and ``pallas_decode_batch_fn`` read
``SPIHT_TPU_PALLAS_DEC_BATCH`` (``pallas_decoder.py:2181-2189``, through
``encoder.batch_mode``): ``ilv`` forces B5 and raises
``MachineResourceLimit`` before any launch where B5 does not take the
batch (duplicate parents, or a machine other than ``hybrid``); ``map``
loops single launches of B2 and the scatter, or B3 at odd LL or for
``machine="seq"``; ``auto`` or unset keeps B5 or batched B3. Every batch
launch (``decode_coeffs_batch`` too) takes at most
``encoder.ilv_chunk(B)`` streams (``SPIHT_TPU_PALLAS_ILV_B``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .encoder import (
    MAX_CELLS, STAT_LEN, MachineResourceLimit, _Stop, _check_i32,
    _env_machine, _fits_or_raise, batch_mode, check_geometry, check_stat,
    device_scalar, ilv_chunk, machine_caps, machine_fits,
)
from .geom import (
    A_DESC, A_LIP, A_LIPSIGN, A_LSIG, A_OFF, A_OFFSIGN, A_REF, _F_AD, _F_DA,
    _F_DD, _F_LL, machine_tables, words_of,
)
from .tree_bounds import queue_bounds

__all__ = [
    "has_duplicate_parents",
    "decode_lsp",
    "decode_lsp_log",
    "decode_seq",
    "decode_seq_log",
    "decode_lsp_batch",
    "decode_seq_batch",
    "scatter_rec",
    "machine_args",
    "batch_machine_args",
    "decode_coeffs",
    "decode_coeffs_batch",
    "decode",
    "decode_batch",
    "words_batch",
    "MachineResourceLimit",
    "machine_fits",
    "interleaved_fits",
    "pallas_decode",
    "pallas_decode_fn",
    "pallas_decode_batch",
    "pallas_decode_batch_fn",
]


# the node field of a queue entry in B3-log, which keeps its filter above
NODE_MASK = (1 << 29) - 1


@lru_cache(maxsize=None)
def has_duplicate_parents(h: int, w: int, ll_h: int, ll_w: int) -> bool:
    """Odd LL dims make the parity offspring map overlap (closed form,
    ``tree_bounds``); such geometries go to the seq machine."""
    return queue_bounds(1, h, w, ll_h, ll_w).has_duplicate_parents


def _child_filt(f, node, c0, w):
    """The filter an entry of filter f at ``node`` gives its children, the
    first at c0 (the reference's ``_offspring_filter``): its own, or an LL
    parent's by its parity, as ``child_filt`` in the kernel finds it."""
    if f != _F_LL:
        return f
    d = c0 - node  # (i odd) (ll_h - 1) w + (j odd) (ll_w - 1)
    i_odd, j_odd = d >= w, d % w != 0
    return (_F_DD if i_odd else _F_AD) if j_odd else _F_DA


def _decode_machine_plain(
    words, nbits, max_n, geo, lip0, lis0, w, lip_cap, lis_cap, lsp_cap,
    seq, n_rec, log=False, log_len=None,
):
    """The plain version of kernels B2 (seq=False), B2-log (log=True), B3
    (seq=True) and B3-log (both) on CPU tensors (Python ints inside). With
    ``log`` it also returns the event log: ``log_len`` (None: nbits + 1)
    int64 words, word t the event of the bit attempted at offset t
    (``node | action << 32 | (n+1) << 35 | filter << 40``; the row at
    nbits is the first read that found the stream empty, rows past it 0).
    B3-log's queue entries carry their instance's
    filter as the kernel's do (bits 29-30 of a LIP or LSP entry, 30-31 of
    a LIS entry); B2-log's filter field is 0."""
    filt = seq and log
    nbits, max_n = int(nbits), int(max_n)  # ints or 0-d tensors
    raw = words.numpy().view(np.uint8)
    bits = np.unpackbits(raw, bitorder="little")[:nbits].tolist()
    geo = memoryview(geo.numpy())  # int reads without a list of N ints
    lip = lip0.tolist()
    lis = lis0.tolist()
    lsp, lsp_val = [], []
    rec_np = np.zeros(n_rec if seq else 0, np.int32)
    rec = memoryview(rec_np)
    if log:
        log_len = nbits + 1 if log_len is None else int(log_len)
        if log_len < nbits + 1:
            raise ValueError(f"log_len {log_len} < nbits + 1 = {nbits + 1}")
    events = [0] * log_len if log else None
    off = (0, 1, w, w + 1)
    err = 0
    cur = 0

    def get(node, action, f):
        # the event is logged before the read, as the reference trace's row
        nonlocal cur
        if log:
            events[cur] = node | (action << 32) | ((n + 1) << 35) | (f << 40)
        if cur >= nbits:
            raise _Stop
        cur += 1
        return bits[cur - 1]

    def commit(x, s, mag):
        # x: the entry, node | filter << 29
        nonlocal err
        if len(lsp) >= lsp_cap:
            err = 4
            raise _Stop
        if seq:
            rec[x & NODE_MASK] = mag if s else -mag
        else:
            lsp_val.append((s << 31) | mag)
        lsp.append(x)

    try:
        for n in range(max_n, -1, -1):
            lsp_snap = len(lsp)
            mag0 = 1 if n == 0 else (1 << (n - 1)) + (1 << n)
            keep = []
            for x in lip:
                node, f = x & NODE_MASK, x >> 29
                if get(node, A_LIP, f):
                    commit(x, get(node, A_LIPSIGN, f), mag0)
                else:
                    keep.append(x)
            lip = keep

            keep = []
            r = 0
            while r < len(lis):
                e = lis[r]
                r += 1
                node, f = (e >> 1) & NODE_MASK, e >> 30
                g = geo[node]
                if not get(node, A_DESC if e & 1 else A_LSIG, f):
                    keep.append(e)
                    continue
                c0 = g >> 2
                cf = _child_filt(f, node, c0, w) if filt else 0
                if e & 1:
                    if (g >> 1) & 1:
                        for o in off:
                            x = (c0 + o) | (cf << 29)
                            if get(c0 + o, A_OFF, cf):
                                commit(x, get(c0 + o, A_OFFSIGN, cf), mag0)
                            else:
                                if len(lip) >= lip_cap:
                                    err = 2
                                    raise _Stop
                                lip.append(x)
                    if g & 1:
                        if len(lis) >= lis_cap:
                            err = 3
                            raise _Stop
                        lis.append(e & ~1)
                elif (g >> 1) & 1:
                    if len(lis) + 4 > lis_cap:
                        err = 3
                        raise _Stop
                    lis.extend(((c0 + o) << 1) | 1 | (cf << 30) for o in off)
            lis = keep

            bit = 1 << n
            for r in range(lsp_snap):
                node = lsp[r] & NODE_MASK
                b = get(node, A_REF, lsp[r] >> 29)
                if seq:
                    x = rec[node]
                    mag = (abs(x) | bit) if b else (abs(x) & ~bit)
                    rec[node] = mag if x >= 0 else -mag
                else:
                    v = lsp_val[r]
                    lsp_val[r] = (v | bit) if b else (v & ~bit)
    except _Stop:
        pass
    stat = torch.tensor(
        [len(lsp), err, len(lip), len(lis), len(lsp), cur], dtype=torch.int32
    )
    ev = torch.tensor(events, dtype=torch.int64) if log else None
    if seq:
        rec_t = torch.from_numpy(rec_np)
        return (rec_t, stat, ev) if log else (rec_t, stat)
    cap = max(lsp_cap, 1)
    node_q = torch.zeros(cap, dtype=torch.int32)
    val_q = torch.zeros(cap, dtype=torch.int32)
    node_q[: len(lsp)] = torch.tensor(lsp, dtype=torch.int32)
    val_q[: len(lsp)] = torch.tensor(
        np.asarray(lsp_val, np.int64).astype(np.uint32).view(np.int32)
    )
    return (node_q, val_q, stat, ev) if log else (node_q, val_q, stat)


def _decode_machine_batch_plain(
    words, nbits, max_n, geo, lip0, lis0, w, caps, seq,
):
    """The plain version of kernel B5 (seq=False) and of batched B3
    (seq=True) on CPU tensors: the plain machine stream by stream, each
    held to its own length within its row, as ``dec_stream_args`` does.
    Returns the per-stream outputs stacked along a new first dim."""
    cap_bits = words.shape[1] * 32
    outs = [
        _decode_machine_plain(
            words[b], min(max(nb, 0), cap_bits), mn, geo, lip0, lis0, w,
            *caps, seq, geo.numel() if seq else 0,
        )
        for b, (nb, mn) in enumerate(zip(nbits.tolist(), max_n.tolist()))
    ]
    return tuple(torch.stack(x) for x in zip(*outs))


def _check_inputs(words, nbits, geo, lip0, lis0, caps):
    dev = words.device
    for name, x in (("words", words), ("geo", geo), ("lip0", lip0),
                    ("lis0", lis0)):
        _check_i32(name, x, dev)
    # a tensor nbits is the caller's to hold to the words: reading it here
    # would sync
    if (not isinstance(nbits, torch.Tensor)
            and not 0 <= nbits <= words.numel() * 32):
        raise ValueError("nbits must lie in [0, 32 * len(words)]")
    if geo.numel() >= MAX_CELLS:
        raise ValueError("geometry beyond the machines' packing (2^29 cells)")
    lip_cap, lis_cap, _ = caps
    if lip0.numel() > lip_cap or lis0.numel() > lis_cap:
        raise ValueError("initial queues exceed their capacities")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_log(max_n, nbits, log_len):
    """The log's limits: max_n <= 30 (the 5-bit plane field) and a log of
    at least nbits + 1 words, checked on the host where they are ints (a
    tensor max_n or nbits beside a ``log_len`` is the caller's to check,
    as a program does in ``start``: reading it here would sync). Returns
    the log's length: ``log_len``, or nbits + 1, read on the host."""
    if not isinstance(max_n, torch.Tensor) and not 0 <= int(max_n) <= 30:
        raise ValueError("the event log's plane field takes max_n <= 30")
    if log_len is None:
        return int(nbits) + 1
    if not isinstance(nbits, torch.Tensor) and log_len < int(nbits) + 1:
        raise ValueError(f"log_len {log_len} < nbits + 1")
    return int(log_len)


def _scalars(nbits, max_n, dev):
    """nbits and max_n as the kernels read them, from device memory."""
    return (device_scalar("nbits", nbits, dev),
            device_scalar("max_n", max_n, dev))


def _decode_lsp(log, words, nbits, max_n, geo, lip0, lis0, w, caps,
                log_len=None):
    """B2 (log=False) or B2-log (log=True); see ``decode_lsp``."""
    dev = _check_inputs(words, nbits, geo, lip0, lis0, caps)
    if log:
        log_len = _check_log(max_n, nbits, log_len)
    lip_cap, lis_cap, lsp_cap = caps
    if dev.type == "cpu":
        return _decode_machine_plain(
            words, nbits, max_n, geo, lip0, lis0, w, lip_cap, lis_cap,
            lsp_cap, False, 0, log=log, log_len=log_len,
        )
    from .. import _build

    lib = _build.load("spiht_decode")
    lip = torch.empty(lip_cap, dtype=torch.int32, device=dev)
    lis = torch.empty(lis_cap, dtype=torch.int32, device=dev)
    lsp = torch.empty(max(lsp_cap, 1), dtype=torch.int32, device=dev)
    lsp_val = torch.empty(max(lsp_cap, 1), dtype=torch.int32, device=dev)
    stat = torch.empty(STAT_LEN, dtype=torch.int32, device=dev)
    nb, mn = _scalars(nbits, max_n, dev)
    args = [
        words.data_ptr(), nb.data_ptr(), mn.data_ptr(), geo.data_ptr(),
        lip0.data_ptr(), lip0.numel(), lis0.data_ptr(), lis0.numel(), w,
        lip.data_ptr(), lip_cap, lis.data_ptr(), lis_cap,
        lsp.data_ptr(), lsp_val.data_ptr(), lsp_cap, stat.data_ptr(),
    ]
    if log:  # the kernel writes rows 0..nbits; the rest stay 0
        events = torch.zeros(log_len, dtype=torch.int64, device=dev)
        args.append(events.data_ptr())
    launch = (lib.spiht_decode_lsp_log_launch if log
              else lib.spiht_decode_lsp_launch)
    rc = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        what = "spiht_decode_lsp_log" if log else "spiht_decode_lsp"
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
    (decode_lsp_log if log else decode_lsp).launches += 1
    return (lsp, lsp_val, stat, events) if log else (lsp, lsp_val, stat)


def decode_lsp(
    words: torch.Tensor,
    nbits: int,
    max_n: int,
    geo: torch.Tensor,
    lip0: torch.Tensor,
    lis0: torch.Tensor,
    w: int,
    caps: Tuple[int, int, int],
):
    """Kernel B2 (or, for CPU tensors, its plain version).

    words: int32 stream words (LSB-first bits); nbits, max_n: ints or 0-d
    int32 tensors on the words' device, which the kernel reads from device
    memory, so a CUDA graph can replay the launch with new values (a
    tensor nbits is not checked against the words); geo: int32[N]
    ``child0<<2 | hc<<1 | hg``; lip0/lis0: initial entries; caps: (lip,
    lis, lsp) capacities. Returns (lsp nodes int32[cap], lsp values int32
    [cap] as sgn<<31 | magnitude, stat int32[STAT_LEN]); stat[0] counts
    the live LSP entries.
    """
    return _decode_lsp(False, words, nbits, max_n, geo, lip0, lis0, w, caps)


decode_lsp.launches = 0


def decode_lsp_log(
    words: torch.Tensor,
    nbits: int,
    max_n: int,
    geo: torch.Tensor,
    lip0: torch.Tensor,
    lis0: torch.Tensor,
    w: int,
    caps: Tuple[int, int, int],
    log_len: Optional[int] = None,
):
    """Kernel B2-log (or, for CPU tensors, its plain version): B2 that also
    writes the metadata trace's compact event log.

    The same inputs as ``decode_lsp``, and the log's length ``log_len``
    (None: nbits + 1, read on the host; a program passes its bucket's 32
    * words + 1, which needs no read);
    returns (lsp nodes, lsp values, stat, log int64[log_len]): log[t] is
    the event of the bit attempted at stream offset t, ``node | action <<
    32 | (n+1) << 35`` (0 where no bit was attempted; the filter field,
    bits 40-41, is 0), the row at nbits the read that found the stream
    empty, the rows past it 0. The geometry takes what the machines take,
    c*h*w < 2^29; the 5-bit plane field bounds max_n to <= 30 (checked
    here for an int).
    """
    return _decode_lsp(True, words, nbits, max_n, geo, lip0, lis0, w, caps,
                       log_len)


decode_lsp_log.launches = 0


def _decode_seq(log, words, nbits, max_n, geo, lip0, lis0, w, caps,
                log_len=None):
    """B3 (log=False) or B3-log (log=True); see ``decode_seq``."""
    dev = _check_inputs(words, nbits, geo, lip0, lis0, caps)
    if log:
        log_len = _check_log(max_n, nbits, log_len)
    lip_cap, lis_cap, lsp_cap = caps
    n_rec = geo.numel()
    if dev.type == "cpu":
        return _decode_machine_plain(
            words, nbits, max_n, geo, lip0, lis0, w, lip_cap, lis_cap,
            lsp_cap, True, n_rec, log=log, log_len=log_len,
        )
    from .. import _build

    lib = _build.load("spiht_decode")
    lip = torch.empty(lip_cap, dtype=torch.int32, device=dev)
    lis = torch.empty(lis_cap, dtype=torch.int32, device=dev)
    lsp = torch.empty(max(lsp_cap, 1), dtype=torch.int32, device=dev)
    rec = torch.empty(n_rec, dtype=torch.int32, device=dev)
    # per-node refinement claims (plane tag << 32 | LSP index)
    last = torch.empty(n_rec, dtype=torch.int64, device=dev)
    stat = torch.empty(STAT_LEN, dtype=torch.int32, device=dev)
    nb, mn = _scalars(nbits, max_n, dev)
    args = [
        words.data_ptr(), nb.data_ptr(), mn.data_ptr(), geo.data_ptr(),
        lip0.data_ptr(), lip0.numel(), lis0.data_ptr(), lis0.numel(), w,
        lip.data_ptr(), lip_cap, lis.data_ptr(), lis_cap,
        lsp.data_ptr(), lsp_cap, rec.data_ptr(), last.data_ptr(), n_rec,
        stat.data_ptr(),
    ]
    if log:  # the kernel writes rows 0..nbits; the rest stay 0
        events = torch.zeros(log_len, dtype=torch.int64, device=dev)
        args.append(events.data_ptr())
    launch = (lib.spiht_decode_seq_log_launch if log
              else lib.spiht_decode_seq_launch)
    rc = launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        what = "spiht_decode_seq_log" if log else "spiht_decode_seq"
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
    (decode_seq_log if log else decode_seq).launches += 1
    return (rec, stat, events) if log else (rec, stat)


def decode_seq(
    words: torch.Tensor,
    nbits: int,
    max_n: int,
    geo: torch.Tensor,
    lip0: torch.Tensor,
    lis0: torch.Tensor,
    w: int,
    caps: Tuple[int, int, int],
):
    """Kernel B3 (or, for CPU tensors, its plain version): the same
    inputs as ``decode_lsp``; returns (rec int32[N], stat)."""
    return _decode_seq(False, words, nbits, max_n, geo, lip0, lis0, w, caps)


decode_seq.launches = 0


def decode_seq_log(
    words: torch.Tensor,
    nbits: int,
    max_n: int,
    geo: torch.Tensor,
    lip0: torch.Tensor,
    lis0: torch.Tensor,
    w: int,
    caps: Tuple[int, int, int],
    log_len: Optional[int] = None,
):
    """Kernel B3-log (or, for CPU tensors, its plain version): B3 that also
    writes the metadata trace's event log, for odd-LL geometries.

    The same inputs as ``decode_lsp_log``; returns (rec int32[N], stat,
    log int64[log_len]), the log as ``decode_lsp_log``'s with the filter of
    each event's instance in bits 40-41: a node with several LL parents is
    reached through each of them, and each instance and its subtree carry
    the filter that parent gives. max_n <= 30.
    """
    return _decode_seq(True, words, nbits, max_n, geo, lip0, lis0, w, caps,
                       log_len)


decode_seq_log.launches = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def _decode_batch(
    seq, words, nbits, max_n, geo, lip0, lis0, w, caps,
):
    """B5 (seq=False) or batched B3 (seq=True); see ``decode_lsp_batch``."""
    dev = words.device
    for name, x, nd in (("words", words, 2), ("nbits", nbits, 1),
                        ("max_n", max_n, 1), ("geo", geo, 1),
                        ("lip0", lip0, 1), ("lis0", lis0, 1)):
        _check_i32(name, x, dev, nd)
    B, cap_words = words.shape
    if B < 1 or nbits.numel() != B or max_n.numel() != B:
        raise ValueError("need B >= 1 word rows and one nbits, max_n each")
    if geo.numel() >= MAX_CELLS:
        raise ValueError("geometry beyond the machines' packing (2^29 cells)")
    lip_cap, lis_cap, lsp_cap = caps
    if lip0.numel() > lip_cap or lis0.numel() > lis_cap:
        raise ValueError("initial queues exceed their capacities")
    if dev.type == "cpu":
        return _decode_machine_batch_plain(
            words, nbits, max_n, geo, lip0, lis0, w, caps, seq,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .. import _build

    lib = _build.load("spiht_decode")
    n = geo.numel()
    lip, lis, lsp = (
        torch.empty(B, max(cap, 1), dtype=torch.int32, device=dev)
        for cap in caps
    )
    stat = torch.empty(B, STAT_LEN, dtype=torch.int32, device=dev)
    if seq:
        lsp_val = None
        rec = torch.empty(B, n, dtype=torch.int32, device=dev)
        # per-node refinement claims (plane tag << 32 | LSP index)
        last = torch.empty(B, n, dtype=torch.int64, device=dev)
    else:
        lsp_val = torch.empty_like(lsp)
        rec = last = None
    rc = lib.spiht_decode_batch_launch(
        int(seq), B, words.data_ptr(), cap_words, nbits.data_ptr(),
        max_n.data_ptr(), geo.data_ptr(), lip0.data_ptr(), lip0.numel(),
        lis0.data_ptr(), lis0.numel(), n, w, lip.data_ptr(), lip_cap,
        lis.data_ptr(), lis_cap, lsp.data_ptr(), lsp_cap, _ptr(lsp_val),
        _ptr(rec), _ptr(last), stat.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        what = "spiht_decode_seq_batch" if seq else "spiht_decode_lsp_batch"
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
    (decode_seq_batch if seq else decode_lsp_batch).launches += 1
    return (rec, stat) if seq else (lsp, lsp_val, stat)


def decode_lsp_batch(
    words: torch.Tensor,
    nbits: torch.Tensor,
    max_n: torch.Tensor,
    geo: torch.Tensor,
    lip0: torch.Tensor,
    lis0: torch.Tensor,
    w: int,
    caps: Tuple[int, int, int],
):
    """Kernel B5 (or, for CPU tensors, its plain version): B streams of a
    duplicate-free geometry in one launch, one block per stream.

    words: int32 (B, cap_words), each row a stream zero-padded to the
    longest; nbits, max_n: int32 (B,) on the same device (each stream
    stops at its own nbits, held to its row); geo, lip0, lis0: shared, as
    for ``decode_lsp``. Returns (lsp nodes, lsp values, both int32
    (B, cap), stat (B, STAT_LEN)), row b as ``decode_lsp`` returns it.
    """
    return _decode_batch(False, words, nbits, max_n, geo, lip0, lis0, w, caps)


decode_lsp_batch.launches = 0


def decode_seq_batch(
    words: torch.Tensor,
    nbits: torch.Tensor,
    max_n: torch.Tensor,
    geo: torch.Tensor,
    lip0: torch.Tensor,
    lis0: torch.Tensor,
    w: int,
    caps: Tuple[int, int, int],
):
    """Kernel B3 over a grid (or, for CPU tensors, its plain version): B
    streams of an odd-LL geometry in one launch, one block per stream, each
    with its own rec and claims rows. The same inputs as
    ``decode_lsp_batch``; returns (rec int32 (B, N), stat (B, STAT_LEN))."""
    return _decode_batch(True, words, nbits, max_n, geo, lip0, lis0, w, caps)


decode_seq_batch.launches = 0


def scatter_rec(
    lsp: torch.Tensor, lsp_val: torch.Tensor, stat: torch.Tensor, n: int
) -> torch.Tensor:
    """rec int32 (..., n) from B2's or B5's LSP queues (..., cap) and stat
    (..., STAT_LEN): one scatter of each stream's first stat[0] entries,
    with no host sync (entries past the count go to a dropped slot)."""
    live = torch.arange(lsp.shape[-1], device=lsp.device) < stat[..., :1]
    mag = lsp_val & 0x7FFFFFFF
    vals = torch.where(lsp_val < 0, mag, -mag)
    tgt = torch.where(live, lsp.long(), n)
    rec = torch.zeros(
        tuple(lsp.shape[:-1]) + (n + 1,), dtype=torch.int32, device=lsp.device
    )
    rec.scatter_(-1, tgt, torch.where(live, vals, 0))
    return rec[..., :n]


def decode_coeffs(
    words: torch.Tensor,
    nbits: int,
    max_n: int,
    c: int,
    h: int,
    w: int,
    ll_h: int,
    ll_w: int,
    out_dtype: torch.dtype = torch.int32,
    machine=None,
) -> torch.Tensor:
    """Decode stream words on their device -> rec (c, h, w), routed as
    ``pallas_decode_fn``: B3 for duplicate-parent geometries or
    ``machine="seq"``, else B2 plus the scatter; raises on a machine error
    (syncs the device). ``out_dtype=torch.int16`` is value-identical for
    max_n <= 13 (|rec| < 2^(max_n+1)) and halves the bytes."""
    od = _checked_out_dtype(out_dtype, [max_n])
    core = _dec_core(c, h, w, ll_h, ll_w, words.numel(), machine,
                     words.device)
    rec, stat, name = core(words.reshape(-1), nbits, int(max_n))
    check_stat(stat, name)
    return rec.reshape(c, h, w).to(od)


def decode_coeffs_batch(
    words: torch.Tensor,
    nbits,
    max_ns,
    c: int,
    h: int,
    w: int,
    ll_h: int,
    ll_w: int,
    out_dtype: torch.dtype = torch.int32,
    machine=None,
) -> torch.Tensor:
    """Decode B streams of one geometry on their device -> rec (B, c, h, w)
    in one launch (launches of ``ilv_chunk(B)`` streams), routed as
    ``decode_coeffs``: batched B3 for
    duplicate-parent geometries or ``machine="seq"``, else B5 plus one
    scatter; raises on a machine error in any stream. words: int32
    (B, cap_words); nbits, max_ns: B host ints. ``out_dtype=torch.int16``
    needs every max_n <= 13."""
    od = _checked_out_dtype(out_dtype, max_ns)
    rec, stat, name = decode_batch_body(c, h, w, ll_h, ll_w, words.shape[-1],
                                        words.device, machine)(
        words, batch_scalars(words, nbits, max_ns))
    check_stat(stat, name)
    return rec.reshape(-1, c, h, w).to(od)


def decode_batch_body(c, h, w, ll_h, ll_w, cap_words, dev, machine=None,
                      route="ilv", chunk=None):
    """The batch decode with no host read: body(words int32 (B,
    cap_words), scalars int32 (2, B): nbits and max_n) -> (rec int32 (B,
    c*h*w), stat (B, STAT_LEN), kernel name), all on ``dev``. Route "ilv":
    B5 and one scatter or batched B3 (``decode_coeffs``' routing) in
    launches of ``chunk`` streams (None: ``ilv_chunk(B)``); route "map":
    B2 and its scatter, or B3, a stream each (the JAX package's
    ``lax.map``), each launch reading row b of the scalars. The caller
    checks the stat (``check_stat``) after it, as ``decode_coeffs_batch``
    does; a program does after its replay."""
    core = _dec_core(c, h, w, ll_h, ll_w, cap_words, machine, dev, chunk)

    def body(words, scalars):
        if route != "map":
            return core(words, scalars[0], scalars[1])
        outs = [core(words[b], scalars[0, b], scalars[1, b])
                for b in range(words.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]), outs[0][2] + "_batch")

    return body


def batch_scalar_rows(nbits, max_ns, B: int, cap_words: int) -> np.ndarray:
    """B host ints each of nbits and max_n, checked against B streams of
    cap_words words, as an int32 (2, B) array."""
    nbits, max_ns = [int(v) for v in nbits], [int(v) for v in max_ns]
    if len(nbits) != B or len(max_ns) != B:
        raise ValueError(f"need {B} nbits and max_n values")
    if not all(0 <= nb <= cap_words * 32 for nb in nbits):
        raise ValueError("nbits must lie in [0, 32 * cap_words]")
    return np.array([nbits, max_ns], dtype=np.int32).reshape(2, B)


def batch_scalars(words: torch.Tensor, nbits, max_ns) -> torch.Tensor:
    """``batch_scalar_rows`` for (B, cap_words) words, as an int32 (2, B)
    tensor on the words' device (one copy)."""
    if words.dim() != 2:
        raise ValueError("words must be (B, cap_words)")
    rows = batch_scalar_rows(nbits, max_ns, *words.shape)
    return torch.from_numpy(rows).to(words.device)


def _machine_tail(c, h, w, ll_h, ll_w, cap_words, dev):
    """The machines' arguments after the stream's: the geometry tables on
    ``dev``, w, and the queue capacities narrowed to cap_words."""
    tabs = machine_tables(c, h, w, ll_h, ll_w, dev)
    return (tabs["geo"], tabs["lip0"], tabs["lis0"], w,
            machine_caps(c, h, w, ll_h, ll_w, cap_words))


def batch_machine_args(
    words: torch.Tensor, nbits, max_ns,
    c: int, h: int, w: int, ll_h: int, ll_w: int,
):
    """``decode_lsp_batch``/``decode_seq_batch``'s arguments for B word
    rows on their device and B host ints each of nbits and max_n: those
    two as int32 (B,) tensors (one copy), the geometry tables, and queue
    capacities narrowed to the row length."""
    check_geometry(c, h, w, ll_h, ll_w)
    nb, mn = batch_scalars(words, nbits, max_ns)
    return (words, nb, mn) + _machine_tail(c, h, w, ll_h, ll_w,
                                           words.shape[1], words.device)


def machine_args(
    words: torch.Tensor, nbits: int, max_n: int,
    c: int, h: int, w: int, ll_h: int, ll_w: int,
):
    """``decode_lsp``/``decode_seq``'s arguments for stream words on their
    device: the geometry tables and the queue capacities narrowed to the
    stream's length."""
    check_geometry(c, h, w, ll_h, ll_w)
    return (words, nbits, int(max_n)) + _machine_tail(
        c, h, w, ll_h, ll_w, words.numel(), words.device)


def words_tensor(data: bytes, device) -> Tuple[torch.Tensor, int]:
    """(int32 word tensor on ``device``, nbits) of stream bytes; nbits is
    the byte-padded length, as the wire format reads it."""
    nbits = len(data) * 8
    cap_words = max((nbits + 31) // 32, 1)
    words = words_of(data, cap_words).view(np.int32).copy()
    return torch.from_numpy(words).to(device), nbits


def words_batch(datas, device) -> Tuple[torch.Tensor, list]:
    """(int32 (B, cap_words) tensor on ``device``, B nbits) of B streams'
    bytes: rows zero-padded to the longest stream, each nbits the
    byte-padded length of its own stream."""
    nbits = [len(d) * 8 for d in datas]
    cap_words = max(max((nb + 31) // 32 for nb in nbits), 1)
    words = np.stack([words_of(d, cap_words) for d in datas]).view(np.int32)
    return torch.from_numpy(words).to(device), nbits


def decode(
    data: bytes, max_n: int, c: int, h: int, w: int, ll_h: int, ll_w: int,
    device=None,
) -> torch.Tensor:
    """Decode stream bytes -> (c, h, w) int32 rec on the device.
    Prefix-tolerant."""
    words, nbits = words_tensor(data, resolve_device(device))
    return decode_coeffs(words, nbits, int(max_n), c, h, w, ll_h, ll_w)


def decode_batch(
    datas, max_ns, c: int, h: int, w: int, ll_h: int, ll_w: int,
    device=None, out_dtype: torch.dtype = torch.int32, machine=None,
) -> torch.Tensor:
    """Decode B streams' bytes of one geometry -> (B, c, h, w) rec on the
    device, in one launch (``machine="seq"``: batched B3 in every
    geometry). ``max_ns`` is one int for every stream or a list of B.
    Prefix-tolerant, each stream on its own length."""
    datas = list(datas)
    words, nbits = words_batch(datas, resolve_device(device))
    if np.isscalar(max_ns):
        max_ns = [max_ns] * len(datas)
    return decode_coeffs_batch(words, nbits, max_ns, c, h, w, ll_h, ll_w,
                               out_dtype, machine)


# pallas_decode_fn's machine names: "seq" is B3 in every geometry; the
# others run B2 (B5 for a batch) where the geometry has no duplicate
# parents, else B3, whose one kernel computes what each layout computes
DEC_MACHINES = (None, "hybrid", "hybrid_hbm", "seq")
# the reference's switch for the machine of the pallas_* functions
# (pallas_decoder.py:176, :2132, :2182-2183), read for a machine of None
_DEC_MACHINE_ENV = "SPIHT_TPU_PALLAS_DEC_MACHINE"
_OUT_DTYPES = {"int32": torch.int32, "int16": torch.int16,
               torch.int32: torch.int32, torch.int16: torch.int16}


def _dec_machine(machine):
    """``machine``, or for None ``SPIHT_TPU_PALLAS_DEC_MACHINE``."""
    return _env_machine(machine, _DEC_MACHINE_ENV, DEC_MACHINES)


def interleaved_fits(
    B: int, c: int, h: int, w: int, ll_h: int, ll_w: int, cap_words: int = 1,
) -> bool:
    """Whether B5 takes B streams of this geometry: ``machine_fits``,
    B >= 1, and no duplicate parents (odd-LL batches run batched B3)."""
    return (B >= 1 and machine_fits(c, h, w, ll_h, ll_w, cap_words)
            and not has_duplicate_parents(h, w, ll_h, ll_w))


def _as_words(words, dev: torch.device) -> torch.Tensor:
    """Stream words (a tensor, or a numpy uint32 or int32 array) as a
    contiguous int32 tensor on ``dev``."""
    if not isinstance(words, torch.Tensor):
        words = torch.from_numpy(np.ascontiguousarray(words).view(np.int32))
    return words.to(dev).contiguous()


def _dec_core(c, h, w, ll_h, ll_w, cap_words, machine, dev, chunk=None):
    """The one decode route. core(words, nbits, max_n) -> (rec int32
    (..., c*h*w), stat, kernel name), no host sync: one stream (1-D words,
    ints or 0-d int32 tensors) through B2 + the scatter or B3, or a batch
    ((B, cap_words) words, int32 (B,) tensors) through B5 + the scatter or
    batched B3, in launches of at most ``chunk`` streams (None:
    ``ilv_chunk(B)``). The geometry and the machine name are refused
    before the device."""
    if machine not in DEC_MACHINES:
        raise ValueError(
            f"machine must be one of {DEC_MACHINES}, got {machine!r}")
    check_geometry(c, h, w, ll_h, ll_w)
    tail = _machine_tail(c, h, w, ll_h, ll_w, cap_words, dev)
    seq = machine == "seq" or has_duplicate_parents(h, w, ll_h, ll_w)

    def launch(words, nbits, max_n):
        batch = words.dim() == 2
        if seq:
            run = decode_seq_batch if batch else decode_seq
            return run(words, nbits, max_n, *tail)
        run = decode_lsp_batch if batch else decode_lsp
        lsp, lsp_val, stat = run(words, nbits, max_n, *tail)
        return scatter_rec(lsp, lsp_val, stat, c * h * w), stat

    def core(words, nbits, max_n):
        batch = words.dim() == 2
        if words.shape[-1] != cap_words:
            raise ValueError(f"words must hold {cap_words} words a stream")
        name = "spiht_decode_" + ("seq" if seq else "lsp")
        if not batch:
            return launch(words, nbits, max_n) + (name,)
        B = words.shape[0]
        k = ilv_chunk(B) if chunk is None else chunk
        # an empty batch reaches the wrapper, which refuses it
        outs = [launch(words[s:s + k], nbits[s:s + k], max_n[s:s + k])
                for s in range(0, max(B, 1), k)]
        rec, stat = (outs[0] if len(outs) == 1
                     else tuple(torch.cat(x) for x in zip(*outs)))
        return rec, stat, name + "_batch"

    return core


def _dec_batch_loops(machine, B, c, h, w, ll_h, ll_w, cap_words) -> bool:
    """Whether a batch is decoded by single launches (B2 and the scatter,
    or B3) rather than B5 or batched B3: ``SPIHT_TPU_PALLAS_DEC_BATCH``
    (``encoder.batch_mode``), B5 taking duplicate-free geometries under
    the machines None and "hybrid", as the reference's ``use_ilv``."""
    ilv_ok = machine in (None, "hybrid") and interleaved_fits(
        B, c, h, w, ll_h, ll_w, cap_words)
    mode = batch_mode("SPIHT_TPU_PALLAS_DEC_BATCH", ilv_ok,
                      f"B={B} {c}x{h}x{w} LL {ll_h}x{ll_w} "
                      f"machine={machine}")
    return mode == "map"


def _checked_out_dtype(out_dtype, max_ns) -> torch.dtype:
    """``out_dtype`` (a name or a torch dtype) as a torch dtype; int16
    needs every max_n <= 13 (|rec| < 2^14)."""
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be int32 or int16, got "
                         f"{out_dtype!r}")
    od = _OUT_DTYPES[out_dtype]
    if od == torch.int16 and max((int(m) for m in max_ns), default=0) > 13:
        raise ValueError("int16 rec needs max_n <= 13")
    return od


def pallas_decode_fn(
    c: int, h: int, w: int, ll_h: int, ll_w: int, cap_words: int,
    machine=None, out_dtype="int32", device=None,
):
    """fn(words int32[cap_words] (or a numpy uint32 array), nbits, max_n)
    -> rec (c, h, w) on ``device`` (None: the card): kernel B2 and the
    rec scatter, or B3 at odd LL or for ``machine="seq"``. No host sync
    beyond reading an int. ``out_dtype="int16"`` (max_n <= 13) is
    value-identical. As the JAX package's, it reports no machine error
    (a queue overflow, a corrupt stream): ``decode_coeffs`` and
    ``pallas_decode`` check the machine's status and raise. A ``machine``
    of None reads ``SPIHT_TPU_PALLAS_DEC_MACHINE``."""
    _fits_or_raise(c, h, w, ll_h, ll_w, cap_words, None)
    _checked_out_dtype(out_dtype, [])
    dev = resolve_device(device)
    core = _dec_core(c, h, w, ll_h, ll_w, cap_words, _dec_machine(machine),
                     dev)

    def fn(words, nbits, max_n):
        od = _checked_out_dtype(out_dtype, [max_n])
        rec, _, _ = core(_as_words(words, dev).reshape(-1), int(nbits),
                         int(max_n))
        return rec.reshape(c, h, w).to(od)

    return fn


def pallas_decode_batch_fn(
    c: int, h: int, w: int, ll_h: int, ll_w: int, cap_words: int,
    machine=None, out_dtype="int32", device=None,
):
    """fn(words int32 (B, cap_words), nbits (B,), max_ns (B,)) -> rec
    (B, c, h, w) on ``device`` (None: the card), in one launch: kernel B5
    and one rec scatter, or batched B3 at odd LL or for
    ``machine="seq"`` (launches of ``ilv_chunk(B)`` streams); each stream
    stops at its own nbits. Like ``pallas_decode_fn``, it reports no
    machine error (``decode_coeffs_batch`` and ``pallas_decode_batch``
    do). A ``machine`` of None reads ``SPIHT_TPU_PALLAS_DEC_MACHINE``;
    ``SPIHT_TPU_PALLAS_DEC_BATCH`` is read when fn is made (``map``: B2
    or B3 stream by stream; ``ilv``: B5, or ``MachineResourceLimit``)."""
    _fits_or_raise(c, h, w, ll_h, ll_w, cap_words, None)
    _checked_out_dtype(out_dtype, [])
    machine = _dec_machine(machine)
    loops = _dec_batch_loops(machine, 1, c, h, w, ll_h, ll_w, cap_words)
    dev = resolve_device(device)
    core = _dec_core(c, h, w, ll_h, ll_w, cap_words, machine, dev)

    def fn(words, nbits, max_ns):
        words = _as_words(words, dev)
        B = words.shape[0]
        # host lists need no sync for the check
        od = _checked_out_dtype(out_dtype, max_ns)
        if loops:
            rec = torch.stack([
                core(words[b], int(nb), int(mn))[0]
                for b, (nb, mn) in enumerate(zip(nbits, max_ns))
            ])
            return rec.reshape(B, c, h, w).to(od)
        nb = torch.as_tensor(nbits).to(device=dev, dtype=torch.int32)
        mn = torch.as_tensor(max_ns).to(device=dev, dtype=torch.int32)
        rec, _, _ = core(words, nb.reshape(B), mn.reshape(B))
        return rec.reshape(B, c, h, w).to(od)

    return fn


def pallas_decode(
    data: bytes, max_n: int, c: int, h: int, w: int, ll_h: int, ll_w: int,
    device=None,
) -> np.ndarray:
    """Decode stream bytes on ``device`` (None: the card) -> (c, h, w)
    int32 numpy array: kernel B2 and the rec scatter, B3 at odd LL or
    where ``SPIHT_TPU_PALLAS_DEC_MACHINE`` is ``seq``. ``ValueError`` for a
    refused LL, ``MachineResourceLimit`` where ``machine_fits`` is false.
    Prefix-tolerant."""
    _fits_or_raise(c, h, w, ll_h, ll_w, max((len(data) * 8 + 31) // 32, 1),
                   None)
    words, nbits = words_tensor(data, resolve_device(device))
    return decode_coeffs(words, nbits, int(max_n), c, h, w, ll_h, ll_w,
                         machine=_dec_machine(None)).cpu().numpy()


def pallas_decode_batch(
    datas, max_ns, c: int, h: int, w: int, ll_h: int, ll_w: int,
    machine=None, device=None,
) -> np.ndarray:
    """Decode B streams' bytes of one geometry on ``device`` (None: the
    card) -> (B, c, h, w) int32 numpy array: ``decode_batch``, one launch
    of kernel B5 (batched B3 at odd LL or for ``machine="seq"``; None
    reads ``SPIHT_TPU_PALLAS_DEC_MACHINE``; launches of ``ilv_chunk(B)``
    streams), or under ``SPIHT_TPU_PALLAS_DEC_BATCH=map`` B2 (B3) stream
    by stream. ``max_ns`` is one int or one per stream. The refusals are
    ``pallas_decode``'s, and ``MachineResourceLimit`` for
    ``SPIHT_TPU_PALLAS_DEC_BATCH=ilv`` where B5 does not take the
    batch."""
    datas = list(datas)
    cap_words = max([(len(d) * 8 + 31) // 32 for d in datas] + [1])
    _fits_or_raise(c, h, w, ll_h, ll_w, cap_words, None)
    machine = _dec_machine(machine)
    if not _dec_batch_loops(machine, len(datas), c, h, w, ll_h, ll_w,
                            cap_words):
        return decode_batch(datas, max_ns, c, h, w, ll_h, ll_w, device,
                            machine=machine).cpu().numpy()
    words, nbits = words_batch(datas, resolve_device(device))
    if np.isscalar(max_ns):
        max_ns = [max_ns] * len(datas)
    return np.stack([
        decode_coeffs(wd, nb, int(mn), c, h, w, ll_h, ll_w,
                      machine=machine).cpu().numpy()
        for wd, nb, mn in zip(words, nbits, max_ns)
    ])
