"""SPIHT encode machine: host glue, the CUDA kernels' wrappers and their
plain versions. The port of ``spiht_tpu/codec/pallas_encoder.py``
(``_hybrid_fn`` and its wrapper :1214-1260, ``_cap_words_for`` :1265,
``_narrowed_caps`` :1272, ``pallas_encode`` :2349; the batched
``_interleaved_fn`` and its wrapper :2089-2144, ``pallas_encode_batch``
:2192).

The kernel (``csrc/spiht_encode.cu``, B1) and ``_encode_machine_plain``
compute the same function of the same tables ``t1``, ``t3s``, ``child0``:
the words and the stat row. The plain version keeps its queues LIP, LIS,
LSP as lists of node indices, B1 as payloads (the entries' table words);
no caller reads them. Kernel B7
(``encode_machine_seq``, the port of ``_seq_fn`` :221, which
``pallas_encode_fn`` :185-217 runs for ``machine="seq"``) computes it one
entry per iteration, with the same plain version. Kernel B4 runs that
machine over a batch, one block per stream; its plain version runs
``_encode_machine_plain`` stream by stream. The wrappers
``encode_machine`` and ``encode_machine_batch`` take the plain versions
for CPU tensors only; for CUDA tensors they launch the kernel or raise.

The word buffer is sized from the real budget, ``cap_words_for(c, h, w,
max_bits)``, so the stream cannot outgrow it; the stream-capacity error is
kept as a check and raises ``EncCapacityOverflow``.

``check_geometry`` refuses what the reference's native scheduler refuses
(``spiht_tpu/native/spiht_kernel.cpp:398-402``): LL dims of 1, and LL
children past the array (a level-0 "pyramid"), both with ``ValueError``,
before any table is built. Every machine entry of the port calls it.

The JAX package's names ``pallas_encode``, ``pallas_encode_fn``,
``pallas_encode_batch`` and ``pallas_encode_batch_fn`` are thin functions
over B1 and B4 (B7 for ``machine="seq"``), with the reference's
signatures less the TPU-only ``interpret``. ``machine_fits`` and
``interleaved_fits`` answer the port's real limits, c*h*w < 2^29 and the
LL rule: the card has no VMEM budget, so no geometry the machines take is
refused for its state's size. Where the reference reads
``SPIHT_TPU_PALLAS_ENC_MACHINE`` (``pallas_encoder.py:205``, :2165,
:2217-2218, :2368-2378), the four ``pallas_*`` functions read it for a
``machine`` of None: ``seq`` runs B7; ``pallas_encode`` (and
``pallas_encode_batch``) refuse ``compact``/``compact_hbm`` for max_n > 15
with ``MachineResourceLimit``, as the reference does, for an explicit
machine too. A value the switch does not name runs B7, as the reference
runs its sequential machine for any name it does not know.

The reference's batch switches (``pallas_encoder.py:2185-2189``, :2216,
:2296; ``pallas_decoder.py:2153-2157``, :2181-2189) are read here, in one
place for both directions: ``batch_mode`` reads
``SPIHT_TPU_PALLAS_ENC_BATCH`` for ``pallas_encode_batch`` and
``pallas_encode_batch_fn`` (``ilv`` forces B4 and raises
``MachineResourceLimit`` before any launch where B4 does not take the
batch, as for ``machine="seq"``; ``map`` loops single launches of B1, or
B7 for ``machine="seq"``; ``auto`` or unset keeps B4), and
``SPIHT_TPU_PALLAS_DEC_BATCH`` for their decode counterparts
(``decoder.py``). ``ilv_chunk`` reads ``SPIHT_TPU_PALLAS_ILV_B``, the
most streams a launch of B4, B5 or batched B3 takes, wherever a batch is
launched (the pipelines of ``torch_transform.py`` too, as the reference's
read it): unset, or a value that does not parse, one launch takes the
whole batch (the reference's defaults, 16 to encode and 8 to decode, are
its VMEM budget's); set, ``max(int(value), 1)``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from .geom import machine_tables
from .maps import significance_maps
from .maxn import device_max_n
from .tree_bounds import narrowed_caps, queue_bounds

__all__ = [
    "MAX_CELLS",
    "STAT_LEN",
    "EncCapacityOverflow",
    "MachineResourceLimit",
    "check_geometry",
    "machine_fits",
    "interleaved_fits",
    "cap_words_for",
    "machine_caps",
    "encode_tables",
    "MACHINES",
    "encode_machine",
    "encode_machine_seq",
    "encode_machine_batch",
    "machine_args",
    "batch_machine_args",
    "device_scalar",
    "encode_coeffs",
    "encode_coeffs_batch",
    "row_tables",
    "encode_rows_batch",
    "encode",
    "encode_batch",
    "check_stat",
    "stream_bytes",
    "batch_stream_bytes",
    "pallas_encode",
    "pallas_encode_fn",
    "pallas_encode_batch",
    "pallas_encode_batch_fn",
]

# bits per coefficient cell that provably cover any stream
_CAP_BITS_PER_CELL = 40
# c*h*w bound of the port's machines: the decoders' geometry word packs
# child0 << 2 into an int32 and LIS entries are node << 1 | type
MAX_CELLS = 1 << 29
STAT_LEN = 6  # csrc/spiht_common.cuh SPIHT_STAT_LEN

_ERRORS = {
    1: "the stream outgrew the word buffer",
    2: "the LIP outgrew its capacity",
    3: "the LIS outgrew its capacity",
    4: "the LSP outgrew its capacity",
}


class EncCapacityOverflow(RuntimeError):
    """The stream hit the word buffer's capacity before its budget."""


class MachineResourceLimit(RuntimeError):
    """The geometry lies beyond what the machines take (``machine_fits``)."""


class _Stop(Exception):
    """The plain machines' way out: budget spent or stream exhausted."""


def check_stat(stat, what: str) -> list:
    """stat (a tensor, or a list already read) as a host list, a list of
    rows for a (B, STAT_LEN) batch; raises on a machine error in any
    stream (syncs the device): ``EncCapacityOverflow`` for error 1, else
    ``RuntimeError``."""
    if isinstance(stat, torch.Tensor):
        s, batch = stat.tolist(), stat.dim() == 2
    else:
        s = list(stat)
        batch = bool(s) and isinstance(s[0], list)
    rows = s if batch else [s]
    for b, row in enumerate(rows):
        if row[1] != 0:
            at = f" stream {b}" if batch else ""
            err = EncCapacityOverflow if row[1] == 1 else RuntimeError
            raise err(
                f"{what}{at}: {_ERRORS.get(row[1], row[1])} (stat {row})"
            )
    return s


def cap_words_for(c: int, h: int, w: int, max_bits: int) -> int:
    cap_bits = min(int(max_bits), c * h * w * _CAP_BITS_PER_CELL + 1024)
    return max((cap_bits + 31) // 32, 1)


def machine_caps(
    c: int, h: int, w: int, ll_h: int, ll_w: int, cap_words: int
) -> Tuple[int, int, int]:
    """Budget-narrowed (lip, lis, lsp) queue capacities: safe for any
    stream of <= cap_words*32 bits, because every queue append is charged
    to a bit (``tree_bounds.narrowed_caps``)."""
    return narrowed_caps(queue_bounds(c, h, w, ll_h, ll_w), cap_words)


def _ll_refused(h: int, w: int, ll_h: int, ll_w: int) -> str:
    """Why the native scheduler refuses this LL, or "" if it does not."""
    if ll_h <= 1 or ll_w <= 1:
        return "ll dims must be > 1"
    if 2 * ll_h > h or 2 * ll_w > w:
        # the LL parity children live at rows/cols up to 2*ll - 1
        return "ll dims must be > 1 and 2*ll within the array"
    return ""


def check_geometry(c: int, h: int, w: int, ll_h: int, ll_w: int) -> None:
    """Raise ``ValueError`` for a geometry the machines do not take:
    c*h*w >= 2^29, or an LL the reference's native scheduler refuses."""
    if c * h * w >= MAX_CELLS:
        raise ValueError(
            f"{c}x{h}x{w} has c*h*w >= 2^29, beyond the machines' packing"
        )
    why = _ll_refused(h, w, ll_h, ll_w)
    if why:
        raise ValueError(f"{c}x{h}x{w} with LL {ll_h}x{ll_w}: {why}")


def machine_fits(
    c: int, h: int, w: int, ll_h: int, ll_w: int, cap_words: int = 1,
) -> bool:
    """Whether B1, B2 and B3 take this geometry: c*h*w < 2^29 and the LL
    rule of ``check_geometry``. ``cap_words`` is the reference's argument;
    a word buffer of any size fits the card's memory budget here."""
    return c * h * w < MAX_CELLS and not _ll_refused(h, w, ll_h, ll_w)


def interleaved_fits(
    B: int, c: int, h: int, w: int, ll_h: int, ll_w: int, cap_words: int = 1,
) -> bool:
    """Whether B4 takes B streams of this geometry: ``machine_fits``, and
    B >= 1 (B4 runs one block a stream)."""
    return B >= 1 and machine_fits(c, h, w, ll_h, ll_w, cap_words)


def encode_tables(
    arr: torch.Tensor, ll_h: int, ll_w: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t1, t3s) of an int32 (..., c, h, w) array, int32 on its device and
    flat per array: (N,) for one (c, h, w) array, (B, N) for a batch.
    t1 = (M+1) | (D+1)<<6 | (G+1)<<12 | sgn<<18 | hc<<19 | hg<<20 and
    t3s = sgn<<31 | |x|; the geometry bits hc, hg are shared by every
    array of a batch. |x| is the native scheduler's uint32 magnitude: a
    coefficient of -2^31 has M = 31 (six bits a field) and t3s 0, sign 0
    and low bits 0, a word no other coefficient gives (0 has sign 1)."""
    c, h, w = arr.shape[-3:]
    lead = tuple(arr.shape[:-3])
    m, d, g = significance_maps(arr, ll_h, ll_w)
    flat = arr.reshape(lead + (-1,))
    sgn = (flat >= 0).to(torch.int32)
    absx = torch.abs(flat)
    hc_flags = machine_tables(c, h, w, ll_h, ll_w, arr.device)["hc_flags"]
    t1 = (
        (m.reshape(lead + (-1,)).to(torch.int32) + 1)
        | ((d.reshape(lead + (-1,)).to(torch.int32) + 1) << 6)
        | ((g.reshape(lead + (-1,)).to(torch.int32) + 1) << 12)
        | (sgn << 18)
        | hc_flags
    )
    # abs leaves -2^31 as itself: its low bits are 0, and sign 0 makes the
    # word 0
    t3s = torch.where(sgn.bool(), absx | -(2**31),
                      absx & 0x7FFFFFFF).to(torch.int32)
    return t1, t3s


def _encode_machine_plain(
    t1, t3s, child0, lip0, lis0, w, max_n, max_bits, capped,
    lip_cap, lis_cap, lsp_cap, cap_words,
):
    """The plain version of kernel B1 on CPU tensors (lists inside); the
    scalars max_n, max_bits and capped are ints or 0-d tensors."""
    t1 = t1.tolist()
    t3s = t3s.tolist()
    child0 = child0.tolist()
    max_n, max_bits, capped = int(max_n), int(max_bits), bool(int(capped))
    lip = lip0.tolist()
    lis = lis0.tolist()
    lsp = []
    bits = []
    off = (0, 1, w, w + 1)
    err = 0

    def put(b):
        if len(bits) >= max_bits:
            raise _Stop
        bits.append(b)

    try:
        for n in range(max_n, -1, -1):
            lsp_snap = len(lsp)
            keep = []
            for node in lip:
                sig = (t1[node] & 63) - 1 >= n
                put(sig)
                if sig:
                    put((t3s[node] >> 31) & 1)
                    if len(lsp) >= lsp_cap:
                        err = 4
                        raise _Stop
                    lsp.append(node)
                else:
                    keep.append(node)
            lip = keep

            keep = []
            r = 0
            while r < len(lis):
                e = lis[r]
                r += 1
                node = e >> 1
                t = t1[node]
                if e & 1:
                    dsig = ((t >> 6) & 63) - 1 >= n
                    put(dsig)
                    if not dsig:
                        keep.append(e)
                        continue
                    c0 = child0[node]
                    for o in off:
                        ch = c0 + o
                        sig = (t1[ch] & 63) - 1 >= n
                        put(sig)
                        if sig:
                            put((t3s[ch] >> 31) & 1)
                            if len(lsp) >= lsp_cap:
                                err = 4
                                raise _Stop
                            lsp.append(ch)
                        else:
                            if len(lip) >= lip_cap:
                                err = 2
                                raise _Stop
                            lip.append(ch)
                    if (t >> 20) & 1:
                        if len(lis) >= lis_cap:
                            err = 3
                            raise _Stop
                        lis.append(node << 1)
                else:
                    lsig = ((t >> 12) & 63) - 1 >= n
                    put(lsig)
                    if not lsig:
                        keep.append(e)
                        continue
                    c0 = child0[node]
                    if len(lis) + 4 > lis_cap:
                        err = 3
                        raise _Stop
                    lis.extend(((c0 + o) << 1) | 1 for o in off)
            lis = keep

            for node in lsp[:lsp_snap]:
                put(((t3s[node] & 0x7FFFFFFF) >> n) & 1)
    except _Stop:
        if err == 0 and capped:
            err = 1
    packed = np.packbits(np.asarray(bits, np.uint8), bitorder="little")
    buf = np.zeros(cap_words * 4, np.uint8)
    buf[: packed.size] = packed
    words = torch.from_numpy(buf.view(np.int32).copy())
    stat = torch.tensor(
        [len(bits), err, len(lip), len(lis), len(lsp), 0], dtype=torch.int32
    )
    return words, stat


def ilv_chunk(B: int) -> int:
    """The most streams one launch of B4, B5 or batched B3 takes for a
    batch of B: B, or ``SPIHT_TPU_PALLAS_ILV_B`` where it is set (module
    docstring)."""
    try:
        k = max(int(os.environ.get("SPIHT_TPU_PALLAS_ILV_B", B)), 1)
    except ValueError:
        return B
    return min(k, max(B, 1))


def batch_mode(var: str, ilv_ok: bool, what: str) -> str:
    """The batch switch ``var`` (``SPIHT_TPU_PALLAS_ENC_BATCH`` or
    ``_DEC_BATCH``): "map", "ilv", or "auto" for any other value or none.
    "ilv" raises ``MachineResourceLimit`` where the batched kernel does
    not take the batch (``ilv_ok`` false), before any launch."""
    mode = os.environ.get(var, "auto")
    if mode == "ilv" and not ilv_ok:
        raise MachineResourceLimit(f"ilv {what}")
    return mode if mode in ("map", "ilv") else "auto"


def _encode_machine_batch_plain(
    t1, t3s, child0, lip0, lis0, w, max_n, max_bits, caps, cap_words,
):
    """The plain version of kernel B4 on CPU tensors: the plain B1 machine
    stream by stream, each with its budget clamped to the shared buffer
    (``capped`` where the clamp cut it), as ``enc_stream_args`` does."""
    cap_bits = cap_words * 32
    outs = [
        _encode_machine_plain(
            t1[b], t3s[b], child0, lip0, lis0, w, mn, min(mb, cap_bits),
            mb > cap_bits, *caps, cap_words,
        )
        for b, (mn, mb) in enumerate(zip(max_n.tolist(), max_bits.tolist()))
    ]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _check_i32(name: str, x: torch.Tensor, device: torch.device, ndim=1):
    if x.dtype != torch.int32 or x.device != device or x.dim() != ndim:
        raise ValueError(
            f"{name}: want int32, {ndim}-D, on {device}; got {x.dtype}, "
            f"{x.dim()}-D, on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_scalar(name: str, v, dev: torch.device) -> torch.Tensor:
    """A per-call scalar of a kernel as the kernel reads it, from device
    memory: a 0-d (or one-element) int32 tensor on ``dev`` as it is, or an
    int written there by a fill kernel (no copy from the host, no
    sync)."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise ValueError(f"{name}: want one element, got {v.numel()}")
        _check_i32(name, v.reshape(1), dev)
        return v
    return torch.full((), int(v), dtype=torch.int32, device=dev)


def scratch_queues(caps: Tuple[int, int, int], B: int = 1, device="cpu"):
    """The machines' scratch queues (lip, lis, lsp) for B streams at the
    capacities ``caps``: int32 (B, k * cap). B1 and B4 keep t3s words in
    the LIP and LSP and two words an entry in the LIS (k = 2); B7 uses one
    word an entry of each. No caller reads them."""
    return tuple(
        torch.empty(B, k * max(cap, 1), dtype=torch.int32, device=device)
        for k, cap in zip((1, 2, 1), caps)
    )


def _encode_machine(
    seq, t1, t3s, child0, lip0, lis0, w, max_n, max_bits, capped, caps,
    cap_words,
):
    """B1 (seq=False) or B7 (seq=True); see ``encode_machine``."""
    dev = t1.device
    N = t1.numel()
    for name, x in (("t1", t1), ("t3s", t3s), ("child0", child0),
                    ("lip0", lip0), ("lis0", lis0)):
        _check_i32(name, x, dev)
    if t3s.numel() != N or child0.numel() != N:
        raise ValueError("t1, t3s and child0 must have one entry per cell")
    if N >= MAX_CELLS:
        raise ValueError("geometry beyond the machines' packing (2^29 cells)")
    # a tensor budget is the caller's to hold to the buffer (``_budget``):
    # reading it here would sync
    if (not isinstance(max_bits, torch.Tensor)
            and not 0 <= max_bits <= cap_words * 32):
        raise ValueError("max_bits must lie in [0, cap_words*32]")
    lip_cap, lis_cap, lsp_cap = caps
    if lip0.numel() > lip_cap or lis0.numel() > lis_cap:
        raise ValueError("initial queues exceed their capacities")
    if dev.type == "cpu":
        return _encode_machine_plain(
            t1, t3s, child0, lip0, lis0, w, max_n, max_bits, capped,
            lip_cap, lis_cap, lsp_cap, cap_words,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    max_n = device_scalar("max_n", max_n, dev)
    if seq:  # B7 takes the budget and its flag by value
        budget = (int(max_bits), int(bool(int(capped))))
    else:  # held until the launch
        held = (device_scalar("max_bits", max_bits, dev),
                device_scalar("capped", capped, dev))
        budget = tuple(t.data_ptr() for t in held)
    from .. import _build

    lib = _build.load("spiht_encode")
    lip, lis, lsp = scratch_queues(caps, 1, dev)
    words = torch.empty(cap_words, dtype=torch.int32, device=dev)
    stat = torch.empty(STAT_LEN, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = lib.spiht_encode_seq_launch if seq else lib.spiht_encode_launch
    rc = launch(
        t1.data_ptr(), t3s.data_ptr(), child0.data_ptr(),
        lip0.data_ptr(), lip0.numel(), lis0.data_ptr(), lis0.numel(),
        w, max_n.data_ptr(), *budget,
        lip.data_ptr(), lip_cap, lis.data_ptr(), lis_cap,
        lsp.data_ptr(), lsp_cap, words.data_ptr(), cap_words,
        stat.data_ptr(), stream,
    )
    if rc != 0:
        what = "spiht_encode_seq" if seq else "spiht_encode"
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
    (encode_machine_seq if seq else encode_machine).launches += 1
    return words, stat


def encode_machine(
    t1: torch.Tensor,
    t3s: torch.Tensor,
    child0: torch.Tensor,
    lip0: torch.Tensor,
    lis0: torch.Tensor,
    w: int,
    max_n,
    max_bits: int,
    capped: bool,
    caps: Tuple[int, int, int],
    cap_words: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 (or, for CPU tensors, its plain version).

    t1/t3s/child0: int32[N]; lip0: int32 initial LIP nodes; lis0: int32
    initial LIS entries (node << 1 | 1); w: row length; max_n: the start
    plane; max_bits: budget, already <= cap_words*32; capped: whether the
    caller's budget was clamped to the buffer. Each of the three is an int
    (a bool for capped) or a 0-d int32 tensor on the tables' device, which
    the kernel reads from device memory, so a CUDA graph can replay the
    launch with new values (a tensor budget is not checked here); caps:
    (lip, lis, lsp) queue capacities. Returns (words int32[cap_words],
    stat int32[STAT_LEN]), stat = [bits, error, lip, lis, lsp, 0].
    """
    return _encode_machine(False, t1, t3s, child0, lip0, lis0, w, max_n,
                           max_bits, capped, caps, cap_words)


encode_machine.launches = 0


def encode_machine_seq(
    t1: torch.Tensor,
    t3s: torch.Tensor,
    child0: torch.Tensor,
    lip0: torch.Tensor,
    lis0: torch.Tensor,
    w: int,
    max_n,
    max_bits: int,
    capped: bool,
    caps: Tuple[int, int, int],
    cap_words: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B7, the sequential machine (or, for CPU tensors, its plain
    version, which is B1's): one entry per iteration in one thread. The
    same arguments and results as ``encode_machine``, the same bytes; B7
    takes max_bits and capped by value (a 0-d tensor is read on the
    host), max_n from device memory."""
    return _encode_machine(True, t1, t3s, child0, lip0, lis0, w, max_n,
                           max_bits, capped, caps, cap_words)


encode_machine_seq.launches = 0

# pallas_encode_fn's machine names: "seq" is B7; every other layout is B1,
# whose one kernel computes the function of all of them
MACHINES = (None, "hybrid", "compact", "compact_hbm", "seq")
# the reference's switch for the machine of the pallas_* functions
_ENC_MACHINE_ENV = "SPIHT_TPU_PALLAS_ENC_MACHINE"
# layouts that pack magnitudes into 16 bits on the TPU: max_n <= 15 only
_COMPACT = ("compact", "compact_hbm")


def _env_machine(machine, var: str = _ENC_MACHINE_ENV, names=MACHINES):
    """``machine``, or for None the switch ``var`` where it is set: a
    value in ``names``, else ``"seq"``, as the reference runs its
    sequential machine for any name it does not know."""
    if machine is not None or var not in os.environ:
        return machine
    return os.environ[var] if os.environ[var] in names else "seq"


def encode_machine_batch(
    t1: torch.Tensor,
    t3s: torch.Tensor,
    child0: torch.Tensor,
    lip0: torch.Tensor,
    lis0: torch.Tensor,
    w: int,
    max_n: torch.Tensor,
    max_bits: torch.Tensor,
    caps: Tuple[int, int, int],
    cap_words: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B4 (or, for CPU tensors, its plain version): B streams in one
    launch, one block per stream.

    t1/t3s: int32 (B, N); child0: int32[N] and the initial queues lip0,
    lis0, shared by the streams; max_n, max_bits: int32 (B,) on the same
    device (the budgets >= 0, each clamped in the kernel to cap_words*32,
    with the stream-capacity error where that cut it); caps: (lip, lis,
    lsp) capacities of every stream's queues. Returns (words int32
    (B, cap_words), stat int32 (B, STAT_LEN)), row b as ``encode_machine``
    returns it for stream b.
    """
    dev = t1.device
    for name, x, nd in (("t1", t1, 2), ("t3s", t3s, 2), ("child0", child0, 1),
                        ("lip0", lip0, 1), ("lis0", lis0, 1),
                        ("max_n", max_n, 1), ("max_bits", max_bits, 1)):
        _check_i32(name, x, dev, nd)
    B, N = t1.shape
    if B < 1 or t3s.shape != (B, N) or child0.numel() != N:
        raise ValueError("t1 and t3s must be (B, N), B >= 1, child0 (N,)")
    if max_n.numel() != B or max_bits.numel() != B:
        raise ValueError("max_n and max_bits need one entry per stream")
    if N >= MAX_CELLS:
        raise ValueError("geometry beyond the machines' packing (2^29 cells)")
    lip_cap, lis_cap, lsp_cap = caps
    if lip0.numel() > lip_cap or lis0.numel() > lis_cap:
        raise ValueError("initial queues exceed their capacities")
    if dev.type == "cpu":
        return _encode_machine_batch_plain(
            t1, t3s, child0, lip0, lis0, w, max_n, max_bits, caps, cap_words,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .. import _build

    lib = _build.load("spiht_encode")
    lip, lis, lsp = scratch_queues(caps, B, dev)
    words = torch.empty(B, cap_words, dtype=torch.int32, device=dev)
    stat = torch.empty(B, STAT_LEN, dtype=torch.int32, device=dev)
    rc = lib.spiht_encode_batch_launch(
        B, t1.data_ptr(), t3s.data_ptr(), child0.data_ptr(),
        lip0.data_ptr(), lip0.numel(), lis0.data_ptr(), lis0.numel(), N, w,
        max_n.data_ptr(), max_bits.data_ptr(), lip.data_ptr(), lip_cap,
        lis.data_ptr(), lis_cap, lsp.data_ptr(), lsp_cap, words.data_ptr(),
        cap_words, stat.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"spiht_encode_batch launch failed: CUDA error {rc}")
    encode_machine_batch.launches += 1
    return words, stat


encode_machine_batch.launches = 0


def _encode_batch_launches(t1, t3s, child0, lip0, lis0, w, max_n, max_bits,
                           caps, cap_words, route="ilv", chunk=None):
    """The B streams' (words (B, cap_words), stat (B, STAT_LEN)), rows in
    order. Route "ilv": ``encode_machine_batch`` in launches of at most
    ``chunk`` streams (None: ``ilv_chunk(B)``). Route "map": B1 a stream,
    each launch reading its max_n, budget and capped flag from row b of
    device tensors (the budgets clamped to the buffer on the device), so
    a CUDA graph can replay it. (An empty batch reaches the wrapper, which
    refuses it.)"""
    B = t1.shape[0]
    if route == "map":
        cap_bits = cap_words * 32
        budget = torch.clamp(max_bits, max=cap_bits)
        capped = (max_bits > cap_bits).to(torch.int32)
        outs = [encode_machine(t1[b], t3s[b], child0, lip0, lis0, w,
                               max_n[b], budget[b], capped[b], caps,
                               cap_words)
                for b in range(B)]
        return tuple(torch.stack(x) for x in zip(*outs))
    k = ilv_chunk(B) if chunk is None else chunk
    outs = [
        encode_machine_batch(t1[s:s + k], t3s[s:s + k], child0, lip0, lis0,
                             w, max_n[s:s + k], max_bits[s:s + k], caps,
                             cap_words)
        for s in range(0, max(B, 1), k)
    ]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(x) for x in zip(*outs))


def _budget(max_bits, cap_words: int) -> Tuple[int, bool]:
    """(the budget clamped to an int32 bit count and to the word buffer,
    whether the buffer cut it: the stream is then invalid)."""
    max_bits = min(int(max_bits), 2**31 - 2)
    mb = min(max_bits, cap_words * 32)
    return mb, max_bits > mb


def _geometry_args(c: int, h: int, w: int, ll_h: int, ll_w: int,
                   device) -> tuple:
    """The machines' arguments 3-6, which the geometry alone fixes:
    (child0, lip0, lis0, w)."""
    tabs = machine_tables(c, h, w, ll_h, ll_w, device)
    return (tabs["child0"], tabs["lip0"], tabs["lis0"], w)


def _lead_args(arr: torch.Tensor, ll_h: int, ll_w: int) -> tuple:
    """The machines' first six arguments for an int32 (..., c, h, w) array
    on its device: (t1, t3s, child0, lip0, lis0, w)."""
    return encode_tables(arr, ll_h, ll_w) + _geometry_args(
        *arr.shape[-3:], ll_h, ll_w, arr.device)


def machine_args(
    arr: torch.Tensor, ll_h: int, ll_w: int, max_bits, cap_words=None,
):
    """``encode_machine``'s arguments for an int32 (c, h, w) array on its
    device: the tables, max_n, the budget clamped to the word buffer, and
    the queue capacities narrowed to it.

    ``max_bits`` is an int, clamped here (``_budget``), or the pair
    (budget, capped) that ``_budget`` gives, as 0-d int32 tensors on the
    array's device (a program's scalars, which the kernel reads from
    device memory). ``cap_words`` is the buffer, sized from an int budget
    where None (``cap_words_for``). A larger buffer, as a program's bucket
    is, gives every budget the same (budget, capped) pair and so the same
    stream, with wider queues."""
    if arr.dtype != torch.int32 or arr.dim() != 3:
        raise ValueError("arr must be an int32 (c, h, w) tensor")
    c, h, w = arr.shape
    check_geometry(c, h, w, ll_h, ll_w)
    arr = arr.contiguous()
    if isinstance(max_bits, tuple):
        if cap_words is None:
            raise ValueError("a (budget, capped) pair needs its cap_words")
        budget = max_bits
    else:
        if cap_words is None:
            cap_words = cap_words_for(c, h, w, min(int(max_bits), 2**31 - 2))
        budget = _budget(max_bits, cap_words)
    return (_lead_args(arr, ll_h, ll_w) + (device_max_n(arr),) + budget
            + (machine_caps(c, h, w, ll_h, ll_w, cap_words), cap_words))


def batch_budgets(max_bits, B: int) -> list:
    """B budgets (host ints) as the batch machines take them: each clamped
    to what an int32 bit count holds, a negative one to 0 (an empty
    stream, as the JAX package's device machines read it)."""
    mbs = [max(min(int(m), 2**31 - 2), 0) for m in max_bits]
    if len(mbs) != B:
        raise ValueError(f"need {B} budgets, got {list(max_bits)}")
    return mbs


def batch_machine_args(arrs: torch.Tensor, ll_h: int, ll_w: int, max_bits,
                       cap_words=None):
    """``encode_machine_batch``'s arguments for an int32 (B, c, h, w) batch
    on its device and B budgets: the tables, the per-stream max_n, the
    budgets as an int32 tensor, the queue capacities, and one word buffer
    size for every stream.

    ``max_bits`` is B host ints (``batch_budgets``), the buffer then sized
    from the largest (as ``pallas_encode_batch`` sizes it) where
    ``cap_words`` is None; or an int32 (B,) tensor on the batch's device
    already so clamped, with its ``cap_words`` (a program's static
    budgets, which the kernels read from device memory). A larger buffer,
    as a program's bucket is, gives every budget the same stream."""
    arrs, budgets, cap_words = _batch_inputs(arrs, ll_h, ll_w, max_bits,
                                             cap_words)
    c, h, w = arrs.shape[1:]
    return _lead_args(arrs, ll_h, ll_w) + (
        device_max_n(arrs), budgets,
        machine_caps(c, h, w, ll_h, ll_w, cap_words), cap_words)


def _batch_inputs(arrs: torch.Tensor, ll_h: int, ll_w: int, max_bits,
                  cap_words=None) -> tuple:
    """(the batch contiguous, its budgets as an int32 (B,) tensor on its
    device, the word buffer) as ``batch_machine_args`` takes them, the
    batch and its geometry checked."""
    if arrs.dtype != torch.int32 or arrs.dim() != 4:
        raise ValueError("arrs must be an int32 (B, c, h, w) tensor")
    B, c, h, w = arrs.shape
    check_geometry(c, h, w, ll_h, ll_w)
    arrs = arrs.contiguous()
    if isinstance(max_bits, torch.Tensor):
        if cap_words is None:
            raise ValueError("a budget tensor needs its cap_words")
        return arrs, max_bits, cap_words
    mbs = batch_budgets(max_bits, B)
    if cap_words is None:
        cap_words = cap_words_for(c, h, w, max(mbs, default=0))
    return (arrs, torch.tensor(mbs, dtype=torch.int32).to(arrs.device),
            cap_words)


def encode_coeffs(
    arr: torch.Tensor, ll_h: int, ll_w: int, max_bits=2**31 - 2,
    machine=None, cap_words=None,
):
    """Encode an int32 (c, h, w) coefficient array on its device, with B1
    or, for ``machine="seq"``, B7 (routed as ``pallas_encode_fn``).
    ``max_bits`` and ``cap_words`` as ``machine_args`` takes them.

    Returns (words int32[cap_words], stat, max_n 0-d int32), all on the
    array's device; nothing is read back, so no host sync happens here.
    """
    if machine not in MACHINES:
        raise ValueError(f"machine must be one of {MACHINES}, got {machine!r}")
    args = machine_args(arr, ll_h, ll_w, max_bits, cap_words)
    run = encode_machine_seq if machine == "seq" else encode_machine
    words, stat = run(*args)
    return words, stat, args[6]


def encode_coeffs_batch(arrs: torch.Tensor, ll_h: int, ll_w: int, max_bits,
                        cap_words=None, route="ilv", chunk=None):
    """Encode an int32 (B, c, h, w) batch on its device in one launch of
    kernel B4 (launches of ``chunk`` streams, None: ``ilv_chunk(B)``), or
    for ``route="map"`` in single launches of B1, with one budget per
    stream: a list of B ints, or a device tensor with its ``cap_words``
    (``batch_machine_args``).

    Returns (words int32 (B, cap_words), stat (B, STAT_LEN), max_n (B,)),
    all on the batch's device; nothing is read back.
    """
    arrs, budgets, cap_words = _batch_inputs(arrs, ll_h, ll_w, max_bits,
                                             cap_words)
    t1, t3s, max_n = row_tables(arrs, ll_h, ll_w)
    words, stat = encode_rows_batch(t1, t3s, max_n, arrs.shape[1:], ll_h,
                                    ll_w, budgets, cap_words, route, chunk)
    return words, stat, max_n


def row_tables(arrs: torch.Tensor, ll_h: int, ll_w: int) -> tuple:
    """(t1, t3s, max_n) of an int32 (..., c, h, w) array, as
    ``encode_tables`` and ``device_max_n`` give them: each array's from
    that array alone, so a batch's may be computed a chunk of rows at a
    time."""
    return encode_tables(arrs, ll_h, ll_w) + (device_max_n(arrs),)


def encode_rows_batch(t1, t3s, max_n, shape, ll_h: int, ll_w: int, budgets,
                      cap_words: int, route="ilv", chunk=None):
    """``encode_coeffs_batch``'s (words, stat) from a batch's
    ``row_tables`` of (c, h, w) arrays, its budgets an int32 (B,) tensor
    on their device with its ``cap_words``."""
    c, h, w = shape
    return _encode_batch_launches(
        t1, t3s, *_geometry_args(c, h, w, ll_h, ll_w, t1.device), max_n,
        budgets, machine_caps(c, h, w, ll_h, ll_w, cap_words), cap_words,
        route, chunk)


def stream_bytes(words: torch.Tensor, total: int) -> bytes:
    """The first ``total`` bits of an int32 word buffer, as bytes."""
    nw = (total + 31) // 32
    raw = words[:nw].cpu().numpy().view(np.uint8)
    return raw[: (total + 7) // 8].tobytes()


def batch_stream_bytes(words: torch.Tensor, totals) -> list:
    """Stream b's first ``totals[b]`` bits of a (B, cap_words) int32 word
    buffer, as bytes, for every b (one copy to the host)."""
    nw = (max(totals, default=0) + 31) // 32
    raw = words[:, :nw].cpu().numpy().view(np.uint8)
    return [raw[b, : (t + 7) // 8].tobytes() for b, t in enumerate(totals)]


def _as_coeffs(arr, dev: torch.device) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.to(device=dev, dtype=torch.int32)
    return torch.as_tensor(np.asarray(arr, dtype=np.int32), device=dev)


def encode(
    arr, ll_h: int, ll_w: int, max_bits: int = 2**31 - 2, device=None,
    machine=None,
) -> Tuple[bytes, int]:
    """(bytes, max_n) of a (c, h, w) int32 coefficient array (numpy or
    tensor): the port's counterpart of ``pallas_encode``; ``machine="seq"``
    runs B7, any other machine name B1."""
    arr = _as_coeffs(arr, resolve_device(device))
    words, stat, max_n = encode_coeffs(arr, ll_h, ll_w, max_bits, machine)
    total = check_stat(stat, "spiht_encode")[0]
    return stream_bytes(words, total), int(max_n)


def encode_batch(
    arrs, ll_h: int, ll_w: int, max_bits=2**31 - 2, device=None,
) -> list:
    """[(bytes, max_n)] of a (B, c, h, w) int32 coefficient batch (numpy
    or tensor), in one launch of kernel B4: the port's counterpart of
    ``pallas_encode_batch``. ``max_bits`` is one budget for every stream
    or a list of B."""
    arrs = _as_coeffs(arrs, resolve_device(device))
    B = arrs.shape[0] if arrs.dim() == 4 else 0
    mbs = [max_bits] * B if np.isscalar(max_bits) else list(max_bits)
    words, stat, max_ns = encode_coeffs_batch(arrs, ll_h, ll_w, mbs)
    totals = [row[0] for row in check_stat(stat, "spiht_encode_batch")]
    return list(zip(batch_stream_bytes(words, totals), max_ns.tolist()))


def _enc_batch_loops(machine, B, c, h, w, ll_h, ll_w, cap_words) -> bool:
    """Whether a batch is encoded by single launches (B1, or B7 for
    ``machine="seq"``) rather than B4: ``SPIHT_TPU_PALLAS_ENC_BATCH``
    (``batch_mode``), B4 taking every machine but "seq"."""
    ilv_ok = machine != "seq" and interleaved_fits(B, c, h, w, ll_h, ll_w,
                                                   cap_words)
    mode = batch_mode("SPIHT_TPU_PALLAS_ENC_BATCH", ilv_ok,
                      f"B={B} {c}x{h}x{w} machine={machine}")
    return mode == "map" or machine == "seq"


def _fits_or_raise(c, h, w, ll_h, ll_w, cap_words, machine) -> None:
    """The reference's refusals, in its order of meaning: ``ValueError``
    for a geometry the native scheduler refuses, ``MachineResourceLimit``
    for one the machines cannot hold, ``ValueError`` for a machine name."""
    why = _ll_refused(h, w, ll_h, ll_w)
    if why:
        raise ValueError(f"{c}x{h}x{w} with LL {ll_h}x{ll_w}: {why}")
    if not machine_fits(c, h, w, ll_h, ll_w, cap_words):
        raise MachineResourceLimit(f"{c}x{h}x{w}")
    if machine not in MACHINES:
        raise ValueError(f"machine must be one of {MACHINES}, got {machine!r}")


def pallas_encode_fn(
    c: int, h: int, w: int, ll_h: int, ll_w: int, cap_words: int,
    machine=None, device=None,
):
    """fn(arr int32 (c, h, w), max_n, max_bits) -> (words int32
    [cap_words], total_bits, overflow), 0-d tensors on ``device`` (None:
    the card), with no host sync: kernel B1, or B7 for ``machine="seq"``.
    The budget is clamped to the buffer; ``overflow`` is true where that
    clamp cut the stream (the stream is then invalid). A ``machine`` of
    None reads ``SPIHT_TPU_PALLAS_ENC_MACHINE``."""
    machine = _env_machine(machine)
    _fits_or_raise(c, h, w, ll_h, ll_w, cap_words, machine)
    dev = resolve_device(device)
    caps = machine_caps(c, h, w, ll_h, ll_w, cap_words)
    run = encode_machine_seq if machine == "seq" else encode_machine

    def fn(arr, max_n, max_bits):
        arr = _as_coeffs(arr, dev).contiguous()
        if tuple(arr.shape) != (c, h, w):
            raise ValueError(f"arr must be ({c}, {h}, {w}), got {arr.shape}")
        if isinstance(max_n, torch.Tensor):
            max_n = max_n.to(device=dev, dtype=torch.int32).reshape(())
        words, stat = run(*_lead_args(arr, ll_h, ll_w), max_n,
                          *_budget(max_bits, cap_words), caps, cap_words)
        return words, stat[0], stat[1] != 0

    return fn


def pallas_encode_batch_fn(
    c: int, h: int, w: int, ll_h: int, ll_w: int, cap_words: int,
    machine=None, device=None,
):
    """fn(arrs int32 (B, c, h, w), max_ns (B,), max_bits (B,)) -> (words
    int32 (B, cap_words), totals (B,), overflows (B,)) on ``device``
    (None: the card), with no host sync: one launch of kernel B4
    (launches of ``ilv_chunk(B)`` streams), or B7 stream by stream for
    ``machine="seq"`` (None reads ``SPIHT_TPU_PALLAS_ENC_MACHINE``).
    ``SPIHT_TPU_PALLAS_ENC_BATCH`` is read when fn is made: ``map``
    launches B1 (B7) stream by stream, ``ilv`` raises
    ``MachineResourceLimit`` for ``machine="seq"``."""
    machine = _env_machine(machine)
    _fits_or_raise(c, h, w, ll_h, ll_w, cap_words, machine)
    loops = _enc_batch_loops(machine, 1, c, h, w, ll_h, ll_w, cap_words)
    dev = resolve_device(device)
    caps = machine_caps(c, h, w, ll_h, ll_w, cap_words)
    single = pallas_encode_fn(c, h, w, ll_h, ll_w, cap_words, machine, dev)

    def fn(arrs, max_ns, max_bits):
        arrs = _as_coeffs(arrs, dev).contiguous()
        B = arrs.shape[0]
        if arrs.dim() != 4 or tuple(arrs.shape[1:]) != (c, h, w) or B < 1:
            raise ValueError(f"arrs must be (B, {c}, {h}, {w}), B >= 1")
        mns = torch.as_tensor(max_ns).to(device=dev, dtype=torch.int32)
        mbs = [min(int(m), 2**31 - 2) for m in max_bits]
        if loops:
            outs = [single(arrs[b], mns[b], mbs[b]) for b in range(B)]
            return tuple(torch.stack(x) for x in zip(*outs))
        words, stat = _encode_batch_launches(
            *_lead_args(arrs, ll_h, ll_w), mns.reshape(B),
            torch.tensor(mbs, dtype=torch.int32).to(dev), caps, cap_words,
        )
        return words, stat[:, 0], stat[:, 1] != 0

    return fn


def _compact_refused(machine, arrs, dev) -> None:
    """The reference's refusal of the compact layouts past max_n 15
    (``pallas_encoder.py:2372``, :2318) for an array or a batch; max_n is
    computed (a host sync) only for a compact machine."""
    if machine in _COMPACT:
        mns = device_max_n(_as_coeffs(arrs, dev))
        mn = int(mns.max()) if mns.numel() else 0
        if mn > 15:
            raise MachineResourceLimit(f"max_n={mn} > 15 (compact)")


def pallas_encode(
    arr, ll_h: int, ll_w: int, max_bits: int = 2**31 - 2, machine=None,
    device=None,
) -> Tuple[bytes, int]:
    """(bytes, max_n) of a (c, h, w) int32 array on ``device`` (None: the
    card): kernel B1, or B7 for ``machine="seq"`` (None reads
    ``SPIHT_TPU_PALLAS_ENC_MACHINE``). Raises ``ValueError`` for a refused
    LL, ``MachineResourceLimit`` where ``machine_fits`` is false or a
    compact machine meets max_n > 15, ``EncCapacityOverflow`` if the
    stream outgrew its buffer."""
    c, h, w = np.shape(arr)
    max_bits = min(int(max_bits), 2**31 - 2)
    machine = _env_machine(machine)
    _fits_or_raise(c, h, w, ll_h, ll_w, cap_words_for(c, h, w, max_bits),
                   machine)
    dev = resolve_device(device)
    _compact_refused(machine, arr, dev)
    return encode(arr, ll_h, ll_w, max_bits, dev, machine)


def pallas_encode_batch(
    arrs, ll_h: int, ll_w: int, max_bits, machine=None, device=None,
) -> list:
    """[(bytes, max_n)] of a (B, c, h, w) int32 batch on ``device`` (None:
    the card), in one launch of kernel B4 (launches of ``ilv_chunk(B)``
    streams; B7 stream by stream for ``machine="seq"``; None reads
    ``SPIHT_TPU_PALLAS_ENC_MACHINE``), or under
    ``SPIHT_TPU_PALLAS_ENC_BATCH=map`` B1 (B7) stream by stream.
    ``max_bits`` is one budget or one per stream. The refusals are
    ``pallas_encode``'s, and ``MachineResourceLimit`` for
    ``SPIHT_TPU_PALLAS_ENC_BATCH=ilv`` with ``machine="seq"``."""
    B, c, h, w = np.shape(arrs)
    mbs = [max_bits] * B if np.isscalar(max_bits) else list(max_bits)
    cap_words = cap_words_for(
        c, h, w, max((min(int(m), 2**31 - 2) for m in mbs), default=0))
    machine = _env_machine(machine)
    _fits_or_raise(c, h, w, ll_h, ll_w, cap_words, machine)
    loops = _enc_batch_loops(machine, B, c, h, w, ll_h, ll_w, cap_words)
    _compact_refused(machine, arrs, resolve_device(device))
    if not loops:
        return encode_batch(arrs, ll_h, ll_w, mbs, device)
    return [encode(a, ll_h, ll_w, mb, device, machine)
            for a, mb in zip(arrs, mbs)]
