"""Transform pipelines in PyTorch, the port of ``spiht_tpu/jax_transform.py``.

* ``forward`` (``_forward_jit`` :66-85): colour model -> packed multilevel
  DWT -> per-channel scales -> ``* quantization_scale`` -> truncating int32
  cast (-2^31 out of range, as numpy's cast of the host path gives it).
* ``inverse`` (``_inverse_jit`` :149-193): ``/ per-channel scales``,
  ``/ quantization_scale``, ``waverec2``, inverse colour, optional uint8;
  on the card the first three are one launch a level of kernel
  ``spiht_idwt_level``, and IPT's inverse colour model one launch of
  ``spiht_ipt_inverse`` (``ops/synthesis_kernels.py``).
  No crop to (h, w): like the reference, the output can exceed the
  original dims for odd sizes.
* ``encode_pipeline_batch_fn`` / ``decode_pipeline_batch_fn`` (:535-662,
  :393-500): the whole encode (images -> stream words) and decode (stream
  words -> images) of a (B, C, H, W) batch of one shape on one device,
  through the batched kernels (B4; B5 or batched B3), one launch per
  direction, as cached programs a key (``encode_batch_program`` /
  ``decode_batch_program``: a CUDA graph on the card, the jitted programs
  there; at most ``batch_bound`` images each). Where a launch would take
  fewer than two streams (``ilv_chunk(B)`` of 1, as at B = 1), they
  launch B1, and B2 or B3, a stream each, as the JAX package runs its
  ``lax.map`` of the single-stream machine there (``batch_route``). Their
  op-by-op bodies are ``encode_pipeline_batch_eager`` /
  ``decode_pipeline_batch_eager``.
* ``encode_pipeline_fn`` / ``decode_pipeline_fn`` (:343-389, :242-293):
  the single-image pipelines, the batch programs' batch of one. Their
  op-by-op bodies are ``encode_pipeline_eager`` /
  ``decode_pipeline_eager``, through the single-stream machines alone.

* ``forward_compact`` (``_forward_compact_jit`` :103-146): the forward
  transform to int16 coefficients and an overflow flag, for the
  host-scheduled batch codec; with the float32 working dtype the quantize
  step is kernel B6 (``ops/quantize_kernels.py``).
* ``forward_plan`` and ``narrow`` (``_forward_plan_jit`` :701-733,
  ``_narrow_jit`` :736-746): the two device phases of the budget-narrowed
  batch encode.
* ``trace_program`` (``codec/meta_expand.py`` ``_expand_fn`` :111, and
  the ``with_log`` machine it follows): the metadata trace, kernel
  B2-log or B3-log and the log's expansion, as a cached program a key.
* ``compact_program``, ``plan_program`` + ``narrow_program``,
  ``forward_program`` and ``inverse_program``: ``forward_compact``,
  ``forward_plan`` / ``narrow``, ``forward`` and ``inverse`` as cached
  programs a key (``TransformProgram``), which the host-scheduled batch
  codec and the factories below run; the functions above stay the eager
  bodies they capture.

* ``analysis_fn``, ``synthesis_fn``, ``forward_with_maps`` and
  ``default_dtype`` (:196, :214, :681, :48): the JAX package's factories
  and host step, through ``forward_program`` and ``inverse_program``.
  ``default_dtype`` is float64, the port's working default on every
  device (the JAX package picks float32 without x64).

``forward`` and ``inverse`` take leading batch dims: every step is
elementwise or works along H and W, so no value depends on the batch and
each image of a batch gets exactly what it gets alone.

The working dtype defaults to float64 on every device, so streams equal
the host float64 path. float32 is accepted with the JAX float32 path's
caveat: borderline truncations may flip.
"""

from __future__ import annotations

import functools
import gc
import os
import threading
import time
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from . import metrics
from .device import constant, holding, resolve_device
from .codec import decoder as _decoder, encoder as _encoder
from .codec import meta_expand as _meta
from .codec.decoder import decode_coeffs
from .codec.encoder import (
    batch_stream_bytes, check_stat, encode_coeffs, encode_coeffs_batch,
)
from .codec.maps import significance_maps
from .codec.maxn import device_max_n
from .codec.planning import bits_per_plane_from_maps
from .ops.quantize_kernels import quantize_compact
from .ops.synthesis_kernels import rgb_from_ipt, waverec2_packed
from .color import torch_models
from .settings import SpihtSettings
from .wavelets import dwt
from .wavelets.geometry import get_slices_and_h_w

__all__ = [
    "forward",
    "forward_with_maps",
    "forward_compact",
    "compact_route",
    "forward_plan",
    "narrow",
    "inverse",
    "encode_pipeline_fn",
    "decode_pipeline_fn",
    "encode_pipeline_eager",
    "decode_pipeline_eager",
    "trace_program",
    "TraceProgram",
    "programs",
    "clear_programs",
    "encode_pipeline_batch_fn",
    "decode_pipeline_batch_fn",
    "encode_pipeline_batch_eager",
    "decode_pipeline_batch_eager",
    "encode_batch_program",
    "decode_batch_program",
    "EncodeBatchProgram",
    "DecodeBatchProgram",
    "encode_batch",
    "decode_batch",
    "batch_bound",
    "batch_route",
    "TransformProgram",
    "forward_program",
    "inverse_program",
    "compact_program",
    "plan_program",
    "narrow_program",
    "analysis_fn",
    "synthesis_fn",
    "default_dtype",
]


def default_dtype() -> torch.dtype:
    """The working dtype: float64 on every device, so that streams equal
    the host float64 path."""
    return torch.float64


def _as_dtype(dtype: Optional[str]) -> torch.dtype:
    """The factories' dtype, as the JAX package takes it: None
    (``default_dtype``) or a name such as "float32"."""
    if dtype is None:
        return default_dtype()
    return getattr(torch, np.dtype(dtype).name)


@constant
def _const_mults(pcs: tuple, dtype, device) -> torch.Tensor:
    return torch.tensor(pcs, dtype=dtype, device=device)[:, None, None]


def _mults(pcs, x: torch.Tensor) -> torch.Tensor:
    """The per-channel scales as a (C, 1, 1) tensor in ``x``'s dtype and
    device, copied there once (``device.constant``)."""
    return _const_mults(tuple(float(v) for v in pcs), x.dtype, x.device)


def _scaled_coeffs(image, settings, level, dtype):
    """Colour model -> packed DWT -> per-channel scales, in ``dtype``."""
    image = image.to(dtype)
    if settings.color_model is not None:
        image = torch_models.convert(image, "RGB", settings.color_model)
    arr, ll_h, ll_w = dwt.wavedec2_packed(
        image, settings.wavelet, settings.mode, level
    )
    if settings.per_channel_quant_scales is not None:
        arr = arr * _mults(settings.per_channel_quant_scales, arr)
    return arr, ll_h, ll_w


def forward(
    image: torch.Tensor,
    settings: SpihtSettings,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
) -> Tuple[torch.Tensor, int, int]:
    """(..., C, H, W) image(s) -> (int32 packed coefficients (..., C,
    enc_h, enc_w), ll_h, ll_w), on the images' device."""
    arr, ll_h, ll_w = _scaled_coeffs(image, settings, level, dtype)
    return _quantize(arr * float(settings.quantization_scale)), ll_h, ll_w


def _quantize(x: torch.Tensor) -> torch.Tensor:
    """Truncate toward zero to int32, as the reference's integer cast;
    a value out of int32's range (or NaN) gives -2^31, as numpy's cast of
    the host path does, on every device (CUDA's cast saturates)."""
    inside = (x > -2.0**31 - 1) & (x < 2.0**31)
    return torch.where(inside, x.to(torch.int32), -(2**31))


def forward_with_maps(
    image: torch.Tensor,
    settings: SpihtSettings,
    level: Optional[int] = None,
):
    """``forward`` in ``default_dtype`` plus the significance maps: (arr
    int32, (M, D, G) int8, ll_h, ll_w), fresh tensors on the image's
    device, through the cached forward program of the image's shape
    (``forward_program``, with the maps; the JAX package's
    ``_forward_jit``)."""
    prog = forward_program(settings, image.shape, level, default_dtype(),
                           True, image.dtype, image.device)
    arr, m, d, g = prog(image)
    return arr, (m, d, g), prog.ll[0], prog.ll[1]


def analysis_fn(
    settings: SpihtSettings,
    level: Optional[int] = None,
    with_maps: bool = True,
    dtype: Optional[str] = None,
):
    """fn(image(s) (..., C, H, W) tensor) -> arr int32, or (arr, M, D, G)
    with ``with_maps``: colour, DWT, scales and quantization
    (``forward``), then the maps, on the image's device, as the cached
    program of the image's shape (``forward_program``: a CUDA graph on
    the card, as the JAX factory returns a jitted function); fresh
    tensors. ``dtype``: None (``default_dtype``) or a name such as
    "float32"."""
    dt = _as_dtype(dtype)

    def fn(image: torch.Tensor):
        out = forward_program(settings, image.shape, level, dt, with_maps,
                              image.dtype, image.device)(image)
        return out if with_maps else out[0]

    return fn


def synthesis_fn(
    settings: SpihtSettings,
    h: int,
    w: int,
    level: Optional[int] = None,
    dtype: Optional[str] = None,
    as_uint8: bool = False,
):
    """fn(rec_arr int32 (..., C, enc_h, enc_w) tensor) -> image(s) on the
    array's device, a fresh tensor: ``inverse`` in ``dtype`` (as
    ``analysis_fn`` takes it), as the cached program of the array's shape
    (``inverse_program``)."""
    dt = _as_dtype(dtype)

    def fn(rec_arr: torch.Tensor):
        return inverse_program(settings, rec_arr.shape, h, w, level, dt,
                               as_uint8, rec_arr.dtype, rec_arr.device)(
            rec_arr)[0]

    return fn


def compact_route(dtype: torch.dtype) -> str:
    """``forward_compact``'s route for a working dtype: "b6" (kernel B6)
    where it is float32 and ``SPIHT_TPU_PALLAS`` is unset or "1", else
    "torch" (the JAX package's ``_use_pallas`` :88-101, read where a
    program's key is made, as it is read at trace time)."""
    flag = os.environ.get("SPIHT_TPU_PALLAS")
    return ("b6" if dtype == torch.float32 and (flag is None or flag == "1")
            else "torch")


def forward_compact(
    image: torch.Tensor,
    settings: SpihtSettings,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """(..., C, H, W) image(s) -> (int16 coefficients clipped to +-32767,
    overflow 0-d bool: whether any |coefficient| > 32767, ll_h, ll_w), on
    the images' device; no host sync.

    With the float32 working dtype the quantize, the clip and the
    overflow check are one pass of kernel B6 over the scaled float32
    coefficients, as the JAX package's TPU path runs them; otherwise they
    are torch ops on ``forward``'s int32 array (B6 quantizes in float32,
    which could flip a borderline truncation of the float64 path).
    ``route`` (None: ``compact_route(dtype)``, which reads
    ``SPIHT_TPU_PALLAS`` as the JAX package does: set, "1" runs B6
    (float32 only) and any other value the torch ops; unset, B6 runs on
    float32)."""
    if (route or compact_route(dtype)) == "b6":
        coeffs, ll_h, ll_w = _scaled_coeffs(image, settings, level, dtype)
        _, arr16, _, overflow = quantize_compact(
            coeffs.to(torch.float32), settings.quantization_scale
        )
        return arr16, overflow, ll_h, ll_w
    arr, ll_h, ll_w = forward(image, settings, level, dtype)
    overflow = (torch.abs(arr) > 32767).any()
    return torch.clamp(arr, -32767, 32767).to(torch.int16), overflow, ll_h, ll_w


def forward_plan(
    images: torch.Tensor,
    settings: SpihtSettings,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
):
    """Device phase 1 of the budget-narrowed batch encode: (B, C, H, W)
    images -> (arr int32 (B, C, enc_h, enc_w), mx (B,) max |x| per image,
    counts (B, 32) exact full-stream bits per plane, max_n_dev (B,),
    ll_h, ll_w), all on the images' device. The counts are computed at
    the exact per-image max(M) (max_n_dev); the caller extends them to
    the reference's f32-rule max_n (the planes in between emit one
    all-zero test per initial LIP/LIS entity). Even LL dims only."""
    arr, ll_h, ll_w = forward(images, settings, level, dtype)
    mx = torch.abs(arr).amax(dim=(-3, -2, -1))
    m, d, g = significance_maps(arr, ll_h, ll_w)
    max_n_dev = m.amax(dim=(-3, -2, -1)).to(torch.int32).clamp(min=0)
    counts = bits_per_plane_from_maps(m, d, g, ll_h, ll_w, max_n_dev)
    return arr, mx, counts, max_n_dev, ll_h, ll_w


def narrow(
    arr: torch.Tensor, shifts: torch.Tensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """Device phase 2: each image's magnitudes shifted right by its
    shift, sign kept, narrowed to ``out_dtype``. arr (B, C, H, W) int32;
    shifts (B,) int32 on arr's device."""
    mag = torch.abs(arr) >> shifts.reshape(-1, 1, 1, 1)
    return torch.where(arr >= 0, mag, -mag).to(out_dtype)


def inverse(
    rec_arr: torch.Tensor,
    h: int,
    w: int,
    level: Optional[int],
    settings: SpihtSettings,
    dtype: torch.dtype = torch.float64,
    as_uint8: bool = False,
) -> torch.Tensor:
    """Packed (..., C, enc_h, enc_w) coefficients -> image(s) on their
    device: dequantize and ``waverec2`` (``waverec2_packed``: one kernel
    launch a level on the card, its plain version's torch ops on the CPU),
    then the inverse colour model (IPT on the card: one launch of
    ``rgb_from_ipt``; every other model, and any model on the CPU: the
    torch ops of ``torch_models.convert``)."""
    slices, _, _ = get_slices_and_h_w(h, w, settings, level)
    image = waverec2_packed(rec_arr, slices, settings, dtype)
    model = settings.color_model
    if model is not None:
        if model.lower() == "ipt" and image.device.type == "cuda":
            image = rgb_from_ipt(image)
        else:
            image = torch_models.convert(image, model, "RGB")
    if as_uint8:
        image = torch.round(torch.clamp(image, 0.0, 1.0) * 255.0).to(
            torch.uint8
        )
    return image


def encode_pipeline_eager(
    settings: SpihtSettings,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
):
    """The encode pipeline's eager body: fn(image (C,H,W) tensor,
    max_bits) -> (words int32, stat, max_n), all on the image's device:
    colour -> DWT -> quantize -> max_n (exact float32-truncation
    semantics, no log2) -> maps -> kernel B1, op by op, the word buffer
    sized from the budget. Nothing is read back to the host.
    ``encode_pipeline_fn`` runs the same body as a program."""

    def fn(image: torch.Tensor, max_bits: int):
        arr, ll_h, ll_w = forward(image, settings, level, dtype)
        return encode_coeffs(arr, ll_h, ll_w, max_bits)

    return fn


def decode_pipeline_eager(
    settings: SpihtSettings,
    h: int,
    w: int,
    level: Optional[int],
    c: int,
    dtype: torch.dtype = torch.float64,
    as_uint8: bool = False,
):
    """The decode pipeline's eager body: fn(words int32 tensor, nbits,
    max_n) -> image on the words' device: kernel B2 (+ rec scatter) or B3
    -> dequantize -> ``waverec2`` -> inverse colour, op by op; raises on a
    machine error (a sync in the middle). ``decode_pipeline_fn`` runs the
    same body as a program."""
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
    ll_h, ll_w = slices[0][1].stop, slices[0][2].stop

    def fn(words: torch.Tensor, nbits: int, max_n: int):
        rec = decode_coeffs(words, nbits, max_n, c, enc_h, enc_w, ll_h, ll_w)
        return inverse(rec, h, w, level, settings, dtype, as_uint8)

    return fn


# ---------------------------------------------------------------------------
# The program cache: one CUDA graph a key
# ---------------------------------------------------------------------------

# the cache's bounds: the programs it holds, and the share of a card's
# memory that the programs on that card may hold together (their graphs'
# pools and static input buffers); the least recently used programs go
# before a new key is made and, when its capture took the programs past
# the share, after it
PROGRAM_LIMIT = 16
PROGRAM_MEMORY_SHARE = 0.25

_PROGRAMS: "OrderedDict[tuple, _Program]" = OrderedDict()
_LOCK = threading.Lock()  # the cache's; a program's calls hold its own


def _settings_key(s: SpihtSettings) -> tuple:
    pcs = s.per_channel_quant_scales
    return (s.wavelet, float(s.quantization_scale), s.mode, s.color_model,
            None if pcs is None else tuple(float(v) for v in pcs))


def _settings_of(key: tuple) -> SpihtSettings:
    wavelet, qscale, mode, color_model, pcs = key
    return SpihtSettings(wavelet=wavelet, quantization_scale=qscale,
                         mode=mode, color_model=color_model,
                         per_channel_quant_scales=(None if pcs is None
                                                   else list(pcs)))


@functools.lru_cache(maxsize=256)
def _geometry(skey: tuple, h: int, w: int, level) -> tuple:
    """(enc_h, enc_w, whether the LL is odd: duplicate parents) of an (h,
    w) image at ``level`` under the settings of ``skey``, computed once a
    key: the program factories run on every call."""
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, _settings_of(skey),
                                              level)
    ll_h, ll_w = slices[0][1].stop, slices[0][2].stop
    return enc_h, enc_w, _decoder.has_duplicate_parents(enc_h, enc_w, ll_h,
                                                        ll_w)


def _pow2(n: int) -> int:
    """The least power of two >= n (1 for n <= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


class _Program:
    """One pipeline at one key on its static buffers (``statics``): the
    encode and decode (``EncodeBatchProgram``, ``DecodeBatchProgram``; a
    single image is a batch of one), the metadata trace
    (``TraceProgram``) and the transforms (``TransformProgram``).

    ``run()`` runs the body on the static buffers: eagerly on the CPU; on
    the card, the first run runs the body once eagerly as its warm-up
    (the geometry tables, the kernel modules, the constants), captures it
    into a ``torch.cuda.CUDAGraph`` (the cyclic collector off, as
    ``codec/device_decoder.py`` captures) and replays it, and every later
    run replays it. A capture or a replay that fails raises: there is no
    eager fallback. What ``run`` returns lives in the graph's pool and the
    next run overwrites it.

    The kernel wrappers count the launches they make, the warm-up's and
    the one the capture records, which every replay runs again; the
    program counts its runs (``replays``: its one graph's replays, or its
    back graph's, below). A call (``start`` and what reads its outputs)
    holds ``lock``: calls from several threads take their turns, and a
    call waits, on the device, for the last call's reads of the outputs
    (``_done``) before it overwrites the buffers.

    A program may run several graphs a call (``_replay``, a graph a part,
    each captured at the part's first run; all in one memory pool, since
    they replay in order on one stream), as the batch encode's fronts and
    back do (``EncodeBatchProgram``).

    A call's phases are spans (``metrics.span``, named
    ``spiht/<key[0]>/<phase>``; recorded while a profiler records):
    ``stage`` from ``_begin`` through the last ``_put*`` before ``run``
    (count ``bytes``: the host bytes copied), ``capture`` (a new part's
    warm-up and capture), ``replay`` (a graph's replay enqueued, or the
    eager body off the card), and, where ``finish`` reads the outputs
    back, ``wait`` (its one sync) and ``read`` (from the sync until it
    returns; count ``bytes``: the stream bytes, or the image bytes,
    returned). A front's ``replay`` cuts the stage: ``stage`` and
    ``replay`` spans alternate, siblings, each stage counting its own
    bytes. The replay of the graph that ``run`` runs counts ``launch``
    (a batch program's machine: ``streams`` and ``seq``). ``stage_s`` is
    the last call's time from ``_begin`` to its ``run``, the fronts'
    replays included, measured whether or not spans record.
    """

    PHASES = ("stage", "capture", "replay", "wait", "read")
    launch = {}  # the counts of the replay span of ``run``'s graph

    def __init__(self, key, dev, body, statics):
        self.key, self.dev, self.body, self.statics = key, dev, body, statics
        self.lock = threading.RLock()
        self.outputs = None
        self.replays = 0
        self.held = []  # the constants and tables the graphs read
        self.pool_bytes = 0  # reserved for the graphs' pool by the captures
        self.static_bytes = sum(t.numel() * t.element_size()
                                for t in statics.values())
        self.host_bytes = 0  # pinned staging
        self.capture_s = None  # the warm-ups and captures
        self.stage_s = 0.0  # the last call's stage: _begin to its run
        self._names = {p: f"spiht/{key[0]}/{p}" for p in self.PHASES}
        self._graphs = {}  # part -> (graph, its outputs)
        self._pool = None  # the graphs' one memory pool
        self._stage = None  # the open stage span
        self._stage_ns = 0  # the stage's start
        self._stage_bytes = 0
        self._pinned = {}
        self._staged = None  # the last upload from the pinned buffers
        self._done = None  # the last call's reads of the outputs

    @property
    def device_bytes(self) -> int:
        return self.pool_bytes + self.static_bytes

    def run(self, part: str = "body", body=None):
        """End the call's stage and run ``body`` (None: ``self.body``) as
        the graph ``part``, its replay span counting ``launch``; its
        outputs are the call's."""
        self.stage_s = (self._close_stage() - self._stage_ns) / 1e9
        self.outputs = self._replay(part, body or self.body, self.launch)
        if self.dev.type == "cuda":
            self.replays += 1
        return self.outputs

    def _close_stage(self) -> int:
        """Close the open stage span with its bytes; the time it closed."""
        end = (metrics.close_span(self._stage, bytes=self._stage_bytes)
               or time.perf_counter_ns())
        self._stage, self._stage_bytes = None, 0
        return end

    def _replay(self, part, body, counts=None):
        """``body`` on the static buffers: eagerly off the card; on the
        card the graph ``part`` (captured from ``body`` at its first run),
        replayed, with no sync; its replay span counts ``counts``. Returns
        its outputs."""
        counts = counts or {}
        if self.dev.type != "cuda":
            with metrics.span(self._names["replay"], **counts):
                return body(**self.statics)
        with torch.cuda.device(self.dev):
            if part not in self._graphs:
                with metrics.span(self._names["capture"]):
                    self._graphs[part] = self._capture(body)
            graph, outputs = self._graphs[part]
            with metrics.span(self._names["replay"], **counts):
                graph.replay()
        return outputs

    def _capture(self, body):
        """(graph, outputs) of ``body``: a warm-up, then a capture into
        the program's pool."""
        t0 = time.perf_counter()
        try:
            with holding() as held:
                body(**self.statics)  # the warm-up
                # the graph's own __enter__ empties the cache too: what the
                # capture reserves afterwards is the pool's growth
                torch.cuda.synchronize(self.dev)
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(self.dev)
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph()
                gc_on = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(graph, pool=self._pool):
                        outputs = body(**self.statics)
                finally:
                    if gc_on:
                        gc.enable()
        except BaseException:
            with _LOCK:
                if _PROGRAMS.get(self.key) is self:
                    del _PROGRAMS[self.key]
            raise
        self.pool_bytes += torch.cuda.memory_reserved(self.dev) - reserved
        self.held += held
        self.capture_s = (self.capture_s or 0.0) + time.perf_counter() - t0
        with _LOCK:
            _evict(self.dev, keep=self)
        return graph, outputs

    def _begin(self) -> None:
        """Open the call's stage; wait for the last call's copies from the
        pinned buffers (their event, on the host), so that the host may
        write them again, and, on the device, for its reads of the
        outputs."""
        if self._stage is not None:  # left open by a start that raised
            metrics.close_span(self._stage)
        self._stage = metrics.open_span(self._names["stage"])
        self._stage_ns = (time.perf_counter_ns() if self._stage is None
                          else self._stage.start_ns)
        self._stage_bytes = 0
        if self._staged is not None:
            self._staged.synchronize()
        if self._done is not None:
            torch.cuda.current_stream(self.dev).wait_event(self._done)

    def _wait(self, read, *args):
        """``read(*args)``, the call's one sync, in its ``wait`` span."""
        with metrics.span(self._names["wait"]):
            return read(*args)

    def _end(self) -> None:
        """Record the end of this call's reads of the outputs."""
        if self.dev.type == "cuda":
            if self._done is None:
                self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(self.dev))

    def _pin(self, name, like: torch.Tensor) -> torch.Tensor:
        """The pinned host buffer ``name``, shaped as ``like``."""
        if name not in self._pinned:
            self._pinned[name] = torch.empty(like.shape, dtype=like.dtype,
                                             pin_memory=True)
            self.host_bytes += like.numel() * like.element_size()
        return self._pinned[name]

    def _upload(self, static: torch.Tensor, pin: torch.Tensor) -> None:
        """An asynchronous copy of a pinned buffer to the card, recorded
        for ``_begin``."""
        static.copy_(pin, non_blocking=True)
        if self._staged is None:
            self._staged = torch.cuda.Event()
        self._staged.record()

    def _put(self, name, value) -> None:
        """Copy ``value`` (a tensor of the static's dtype anywhere, or a
        numpy array) into the static buffer ``name``: from the host
        through a pinned buffer on the card, without a sync."""
        static = self.statics[name]
        if isinstance(value, torch.Tensor) and value.device.type != "cpu":
            static.copy_(value)
            return
        host = (value if isinstance(value, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(value)))
        self._stage_bytes += host.numel() * host.element_size()
        if self.dev.type != "cuda":
            static.copy_(host)
            return
        pin = self._pin(name, static)
        pin.copy_(host)
        self._upload(static, pin)

    def _put_rows(self, images, name: str = "images") -> None:
        """Copy n images (an (n, ...) tensor or array, or a list of n
        tensors or arrays) into the first n rows of the static input
        ``name``: an image on the card device to device, a host image into
        its row of one pinned buffer and up from there, so that its upload
        runs while the host copies the next; rows past n repeat row n - 1.
        """
        static, n = self.statics[name], len(images)
        if _on_card(images):
            static[:n].copy_(images)
        else:
            self._stage_rows(images, 0, n, name)
        _pad_rows(static, n)

    def _stage_rows(self, images, start: int, stop: int,
                    name: str = "images") -> None:
        """Copy ``images[start:stop]`` into the same rows of the static
        input ``name``: a row on the card device to device, a host row into
        its row of one pinned buffer and up from there."""
        static = self.statics[name]
        cuda = self.dev.type == "cuda"
        buf = self._pin(name, static) if cuda else static
        for b in range(start, stop):
            row = images[b]
            if _on_card(row):
                static[b].copy_(row)
                continue
            row = (row if isinstance(row, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(row)))
            buf[b].copy_(row)
            self._stage_bytes += row.numel() * row.element_size()
            if cuda:
                self._upload(static[b], buf[b])

    def _put_words(self, streams, nwords) -> None:
        """Copy n streams into the first n rows of the static word buffer
        (a trace program's buffer is one row), each row zeroed past the
        stream's first ``nwords[b]`` words, so that what the buffer held
        before cannot change a result; rows past n repeat row n - 1
        (``_pad_rows``). ``streams``: an (n, width) int32 tensor on the
        card (a row's first min(width, bucket) words), or n host streams
        (bytes, or int32 words in a tensor or array), staged in one pinned
        buffer and uploaded in one copy."""
        static = self.statics["words"]
        static = static.view(-1, static.shape[-1])
        n = len(nwords)
        if isinstance(streams, torch.Tensor) and streams.device.type != "cpu":
            k = min(streams.shape[-1], static.shape[1])
            static[:n, :k].copy_(streams.reshape(n, -1)[:, :k])
            static[:n, k:].zero_()
        else:
            cuda = self.dev.type == "cuda"
            buf = self._pin("words", static) if cuda else static
            view = buf.numpy().view(np.uint8)
            for b in range(n):
                raw = _stream_raw(streams[b])[: nwords[b] * 4]
                view[b, : raw.size] = raw
                view[b, raw.size:] = 0
                self._stage_bytes += raw.size
            if cuda:
                self._upload(static[:n], buf[:n])
        _pad_rows(static, n)


def _on_card(x) -> bool:
    """Whether ``x`` is a tensor off the host."""
    return isinstance(x, torch.Tensor) and x.device.type != "cpu"


def _pad_rows(static: torch.Tensor, n: int) -> None:
    """Rows n and on of a static batch buffer repeat row n - 1: a batch's
    last, shorter part runs in its key's program on valid inputs, whose
    results are dropped."""
    if n < static.shape[0]:
        static[n:].copy_(static[n - 1].expand_as(static[n:]))


def _stream_raw(stream) -> np.ndarray:
    """A stream's bytes as uint8: from bytes, or from int32 (or uint32)
    words in a host tensor or array."""
    if isinstance(stream, (bytes, bytearray, memoryview)):
        return np.frombuffer(stream, np.uint8)
    if isinstance(stream, torch.Tensor):
        stream = stream.contiguous().numpy()
    return np.ascontiguousarray(stream).reshape(-1).view(np.uint8)


class TraceProgram(_Program):
    """The metadata trace of one key (``trace_program``), the counterpart
    of the JAX package's ``_expand_fn`` with the ``_hybrid_fn(...,
    with_log=True)`` it follows.

    ``start(words, nbits, max_n, log=None)`` copies the stream into the
    static word buffer of ``bucket`` words (``_put_words``; words past it
    zeroed) and nbits and max_n into a static device pair, checks max_n
    <= 30 on the host, and runs the program, with no sync: kernel B2-log
    and the rec scatter, or B3-log at odd LL, each writing a log of the
    bucket's ``rows`` = 32 * bucket + 1 words (rows past nbits stay 0),
    then, for the forms "trace" and "expand", the log's expansion over
    those rows (``meta_expand.trace_body``). The form "expand" takes a
    caller's ``log`` instead of decoding (copied into a static buffer of
    ``rows`` words where it lies, zeroed past nbits + 1). ``finish(host)``
    reads the stat row (the one sync), raises as ``check_stat`` does, and
    returns the outputs cut to nbits + 1 rows: fresh tensors on the
    program's device, or, with ``host``, numpy arrays read straight from
    the graph's outputs. A call holds ``lock`` from ``start`` to
    ``finish``; ``__call__`` does."""

    def __init__(self, key, geo, top_slice, other_slices, dev, bucket,
                 form):
        c, h, w, ll_h, ll_w = geo
        self.bucket, self.form, self.rows = bucket, form, 32 * bucket + 1
        self.kernel = "spiht_decode_" + (
            "seq_log" if _decoder.has_duplicate_parents(h, w, ll_h, ll_w)
            else "lsp_log")
        self._nbits = 0
        body = _meta.trace_body(c, h, w, ll_h, ll_w, top_slice,
                                other_slices, bucket, self.rows, dev, form)
        # the geometry, node and rect tables, the program's own: a cache
        # that lets them go frees nothing the graph reads
        self.tables = body.tables
        statics = {
            "words": torch.zeros(bucket, dtype=torch.int32, device=dev),
            "scalars": torch.zeros(2, dtype=torch.int32, device=dev),
        }
        if form == "expand":
            statics["log"] = torch.zeros(self.rows, dtype=torch.int64,
                                         device=dev)
        super().__init__(key, dev, body, statics)

    def start(self, words, nbits, max_n=0, log=None) -> None:
        nbits, max_n = int(nbits), int(max_n)
        n = max((nbits + 31) // 32, 1)
        if nbits < 0 or n > self.bucket:
            raise ValueError(f"nbits {nbits} does not fit the program's "
                             f"{self.bucket} words")
        if not 0 <= max_n <= 30:
            raise ValueError("the event log's plane field takes max_n <= 30")
        self._begin()
        if isinstance(words, torch.Tensor) and words.device.type != "cpu":
            words = words.reshape(1, -1)[:, :n]
        elif isinstance(words, (torch.Tensor, np.ndarray)):
            words = [words]
        self._put_words(words, [n])
        if self.form == "expand":
            self._put_log(log, nbits + 1)
        self._put("scalars", np.array([nbits, max_n], np.int32))
        self.run()
        self._nbits = nbits

    def _put_log(self, log, k: int) -> None:
        """The caller's log's first k words into the static log, zeroed
        past them: on the device where the log lies there, else through
        the pinned buffer."""
        static = self.statics["log"]
        if log.numel() < k:
            raise ValueError(f"the log holds {log.numel()} words, want {k}")
        if log.device.type != "cpu":
            static[:k].copy_(log.reshape(-1)[:k])
            static[k:].zero_()
            return
        host = np.zeros(self.rows, np.int64)
        host[:k] = log.reshape(-1)[:k].numpy()
        self._put("log", host)

    def __call__(self, words, nbits, max_n=0, log=None, host=False):
        with self.lock:
            self.start(words, nbits, max_n, log)
            return self.finish(host)

    def finish(self, host: bool = False):
        """(rec (c, h, w), log (nbits + 1,), words) for the form "log";
        (rec, trace (nbits + 1, 8)) for "trace"; (trace,) for
        "expand"."""
        rows = self._nbits + 1
        if self.form == "expand":
            out = (self.outputs[0][:rows],)
        else:
            rec, stat, x = self.outputs
            check_stat(stat, self.kernel)
            out = (rec, x[:rows])
            if self.form == "log":
                n = max((self._nbits + 31) // 32, 1)
                out += (self.statics["words"][:n],)
        if host:
            out = tuple(t.cpu().numpy() for t in out)
        else:
            out = tuple(t.clone() for t in out)
        self._end()
        return out


def _held_bytes(dev: torch.device) -> int:
    return sum(p.device_bytes for p in _PROGRAMS.values() if p.dev == dev)


def _memory_limit(dev: torch.device) -> Optional[float]:
    """The bytes the programs on ``dev`` may hold (None off the card)."""
    if dev.type != "cuda":
        return None
    return (torch.cuda.get_device_properties(dev).total_memory
            * PROGRAM_MEMORY_SHARE)


def _evict(dev: torch.device, keep: Optional[_Program] = None) -> None:
    """Under ``_LOCK``: the least recently used programs go, ``keep``
    never, while the programs on ``dev`` hold the memory share or more
    and, before a new program is made (``keep`` None), while the cache
    holds ``PROGRAM_LIMIT`` programs."""
    limit = _memory_limit(dev)
    for key, prog in list(_PROGRAMS.items()):
        full = keep is None and len(_PROGRAMS) >= PROGRAM_LIMIT
        over = limit is not None and _held_bytes(dev) >= limit
        if not (full or over):
            return
        if prog is not keep and (full or prog.dev == dev):
            del _PROGRAMS[key]


def _program(key, dev: torch.device, make) -> _Program:
    """The cached program of ``key``, or a new one from ``make()``, made
    after ``_evict`` (and so before its capture, which evicts again if it
    took the programs past the memory share)."""
    with _LOCK:
        prog = _PROGRAMS.get(key)
        if prog is not None:
            _PROGRAMS.move_to_end(key)
            return prog
        _evict(dev)
        prog = _PROGRAMS[key] = make()
        return prog


def programs() -> list:
    """The cached programs, least recently used first."""
    with _LOCK:
        return list(_PROGRAMS.values())


def clear_programs() -> None:
    """Drop every cached program (and so its graph and pool)."""
    with _LOCK:
        _PROGRAMS.clear()


def trace_program(
    c: int,
    h: int,
    w: int,
    ll_h: int,
    ll_w: int,
    top_slice,
    other_slices,
    nbits: int,
    device=None,
    form: str = "trace",
) -> TraceProgram:
    """The cached trace program of a (c, h, w) geometry with an LL of
    (ll_h, ll_w). Its key: the geometry and level, the rect table of the
    slices (``meta_expand.rect_key``, as ``_expand_fn``'s; none for the
    form "log"), the route (B2-log, or B3-log at odd LL), the word-buffer
    bucket (the least power of two of the words ``nbits`` needs, as
    ``decode_batch_program``'s), the device and the form: "log" (the decode and
    its raw log, as ``decode_event_log`` wants them), "trace" (the log
    expanded) or "expand" (a caller's log expanded)."""
    if form not in ("log", "trace", "expand"):
        raise ValueError(f"form must be log, trace or expand, got {form!r}")
    _encoder.check_geometry(c, h, w, ll_h, ll_w)
    dev = resolve_device(device)
    level = None if other_slices is None else len(other_slices)
    rkey = (None if form == "log" else
            _meta.rect_key(level, ll_h, ll_w, top_slice, other_slices))
    seq = _decoder.has_duplicate_parents(h, w, ll_h, ll_w)
    bucket = _pow2(max((int(nbits) + 31) // 32, 1))
    key = ("trace", c, h, w, ll_h, ll_w, level, rkey,
           "b3log" if seq else "b2log", bucket, dev, form)
    return _program(key, dev, lambda: TraceProgram(
        key, (c, h, w, ll_h, ll_w), top_slice, other_slices, dev, bucket,
        form))


def _image_of(image) -> torch.Tensor:
    """A (C, H, W) image, numpy or tensor, as a tensor where it lies."""
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.ascontiguousarray(image))
    if image.dim() != 3:
        raise ValueError("image ndim must be 3: c,h,w")
    return image


def _device_of(x, device) -> torch.device:
    """``device``, or None: where the tensor ``x`` lies (the card for
    anything else)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def encode_pipeline_fn(
    settings: SpihtSettings,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    device=None,
):
    """fn(image (C,H,W) tensor or numpy, max_bits) -> (words int32, stat,
    max_n), all on ``device`` (None: the image's, the card for a numpy
    image), as the eager body returns them: colour -> DWT -> quantize ->
    max_n (exact float32-truncation semantics, no log2) -> maps -> kernel
    B1, as the batch program of one image (``encode_pipeline_batch_fn``),
    its row. Nothing is read back to the host: the stream's words stay on
    the device for a consumer there."""

    def fn(image, max_bits: int):
        batch = encode_pipeline_batch_fn(settings, level, dtype,
                                         _device_of(image, device))
        return tuple(x[0] for x in batch(_image_of(image)[None],
                                         [max_bits]))

    return fn


def decode_pipeline_fn(
    settings: SpihtSettings,
    h: int,
    w: int,
    level: Optional[int],
    c: int,
    dtype: torch.dtype = torch.float64,
    as_uint8: bool = False,
    device=None,
):
    """fn(words, nbits, max_n) -> image on ``device`` (None: the words',
    the card for bytes or a numpy array), a fresh tensor: the whole decode
    as the batch program of one stream (``decode_batch``): kernel B2 (+
    rec scatter) or B3 -> dequantize -> ``waverec2`` -> inverse colour;
    raises on a machine error. ``words``: stream bytes, or int32 words (a
    tensor or a numpy array) holding at least ``nbits``."""

    def fn(words, nbits: int, max_n: int):
        dev = _device_of(words, device)
        if _on_card(words):
            words = words.reshape(1, -1)[:, : max((int(nbits) + 31) // 32, 1)]
        else:
            words = [words]
        return decode_batch(settings, h, w, level, c, words, [nbits],
                            [max_n], dtype, as_uint8, dev)[0]

    return fn


def encode_pipeline_batch_eager(
    settings: SpihtSettings,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
):
    """The batch encode pipeline's eager body: fn(images (B,C,H,W) tensor,
    max_bits: B ints) -> (words (B, cap_words), stat (B, STAT_LEN), max_n
    (B,)), all on the images' device: the batched transform -> per-image
    max_n -> maps -> kernel B4 (launches of ``ilv_chunk(B)`` streams), op
    by op, the word buffer sized from the largest budget. Nothing is read
    back. ``encode_pipeline_batch_fn`` runs the same body as programs."""

    def fn(images: torch.Tensor, max_bits):
        arr, ll_h, ll_w = forward(images, settings, level, dtype)
        return encode_coeffs_batch(arr, ll_h, ll_w, max_bits, None,
                                   *batch_route(images.shape[0]))

    return fn


def decode_pipeline_batch_eager(
    settings: SpihtSettings,
    h: int,
    w: int,
    level: Optional[int],
    c: int,
    dtype: torch.dtype = torch.float64,
    as_uint8: bool = False,
):
    """The batch decode pipeline's eager body: fn(words int32 (B,
    cap_words), nbits: B ints, max_n: B ints) -> images (B, ...) on the
    words' device: kernel B5 (+ one rec scatter) or batched B3 ->
    dequantize -> ``waverec2`` -> inverse colour, op by op; raises on a
    machine error (a sync in the middle). ``decode_pipeline_batch_fn``
    runs the same body as programs."""
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
    ll_h, ll_w = slices[0][1].stop, slices[0][2].stop

    def fn(words: torch.Tensor, nbits, max_ns):
        body = _decoder.decode_batch_body(
            c, enc_h, enc_w, ll_h, ll_w, words.shape[-1], words.device, None,
            *batch_route(words.shape[0]))
        rec, stat, name = body(words, _decoder.batch_scalars(words, nbits,
                                                             max_ns))
        check_stat(stat, name)
        return inverse(rec.reshape(-1, c, enc_h, enc_w), h, w, level,
                       settings, dtype, as_uint8)

    return fn


def batch_route(B: int):
    """(route, chunk) of a batch pipeline of B streams: B4, and B5 or
    batched B3, in launches of ``ilv_chunk(B)`` streams ("ilv"); where
    that is fewer than two, single launches of B1, and B2 or B3 ("map",
    chunk None), as the JAX package's pipelines run a ``lax.map`` of the
    single-stream machine where a chunk holds fewer than two streams
    (``jax_transform.py:437``, :587)."""
    chunk = _encoder.ilv_chunk(B)
    return ("ilv", chunk) if chunk >= 2 else ("map", None)


def _launch(B: int, route: str, chunk, seq: bool) -> dict:
    """The counts of a batch program's machine graph (``_Program.launch``):
    ``streams``, those of its last machine launch (one on the ``map``
    route, else the last launch's of ``chunk`` each), and ``seq``, 1 where
    the B streams go through batched B3, else 0."""
    if route == "map":
        return {"streams": 1, "seq": 0}
    return {"streams": B - (B - 1) // chunk * chunk, "seq": int(seq)}


# ---------------------------------------------------------------------------
# The batch programs: a batch of one shape, one CUDA graph a key
# ---------------------------------------------------------------------------

# the device bytes an image cell (of a c*h*w input) that a round trip's
# two batch programs, encode and decode at one batch size, hold together
# in their pools and static buffers: on an H100 (PERF.md §6, phase 26)
# 87 + 96 = 183 at 16 and 128 3x512x512 images (A), 62 + 84 = 146 at
# 8 (B); the rest is room for larger word buckets
BATCH_BYTES_PER_CELL = 200


def batch_bound(shape, dev: torch.device) -> Optional[int]:
    """The most images of a (C, H, W) ``shape`` that one batch program
    takes on ``dev``: the programs' memory share over an image's bytes
    in a round trip's encode and decode programs (``BATCH_BYTES_PER_CELL``
    a cell), at least 1, so that both programs of a round trip at the
    bound stay cached together; None (no bound) off the card."""
    limit = _memory_limit(dev)
    if limit is None:
        return None
    c, h, w = (int(v) for v in shape)
    return max(1, int(limit // (BATCH_BYTES_PER_CELL * c * h * w)))


def _batch_parts(n: int, shape, dev: torch.device):
    """(m, the (start, stop) ranges) of ``n`` images of a (C, H, W)
    ``shape`` on ``dev``: the fewest equal parts of at most ``batch_bound``
    images, m images each but the last, which may be shorter and is
    padded in the program of m (``_pad_rows``), so that one batch runs
    through one key a direction."""
    bound = batch_bound(shape, dev)
    m = n if bound is None else -(-n // -(-n // bound))
    return m, [(s, min(s + m, n)) for s in range(0, n, m)]


# the host bytes of input a front graph of the batch encode takes at
# least (``EncodeBatchProgram.rows_a_front``). On an H100 a front costs
# the host a graph launch (about 0.3 ms) and the card a fixed ~1.05 ms
# (the deep DWT levels and the maps' small kernels run once a front)
# beside ~0.97 ms a 768x512 image, and the last front is left exposed
# after the copy (0.95-1.5 ms a 4.7 MB float32 row on one host thread):
# few rows a front pay the fixed costs often, many leave a long tail. A
# batch of 24 such images, median ms of 15 calls, in three processes:
# one graph 53.0-58.0; rows a front 1: 53.3-53.6, 2: 38.5-38.6, 3:
# 34.9-36.5, 4: 34.9-40.9, 5: 35.1-38.9, 6: 35.8-38.6, 8: 37.5-44.3, 12:
# 42.3-46.4. Three to five rows are level within the spread; 16 MiB
# takes 4 rows of a 768x512 float32 image and 3 of a 512x512 float64 one.
FRONT_BYTES = 16 << 20


class EncodeBatchProgram(_Program):
    """The batch encode pipeline of one key (``encode_batch_program``), the
    counterpart of the JAX package's ``_encode_pipeline_batch_jit``.

    ``start(images, max_bits)`` copies n <= B images into the static (B,
    C, H, W) input (from the host through one pinned buffer, an image on
    the card device to device), writes their budgets
    (``encoder.batch_budgets``) into a static (B,) device tensor, which
    B4 (or each B1 launch of the ``map`` route) reads, and runs the
    program, with no sync; rows past n repeat the last image and budget.
    Then either ``on_device()`` returns fresh copies of the n streams'
    (words, stat, max_n) as the eager body returns them, or ``finish()``
    reads their stat rows and max_n (one read), raises as ``check_stat``
    does, and reads the streams. A call holds ``lock`` from ``start`` to
    its read.

    Two or more host images are staged a chunk of ``rows_a_front`` rows
    at a time, and each chunk's front graph (colour, DWT, scales,
    quantize, then each row's machine tables and max_n,
    ``encoder.row_tables``, into static (B, ...) buffers) is replayed as
    soon as the chunk is up, so the card transforms a chunk while the
    host copies the next; the rows past n take row n - 1's tables. Then
    the budgets go up and the back graph (B4, or B1 a stream, over the
    static tables) runs. ``rows_a_front`` is the fewest rows that hold
    ``FRONT_BYTES`` of the static input, at most B: chunks of a batch of
    24 768x512 float32 images hold four. Images on the card (no copy to
    hide), one image, or a batch that one front takes (nothing to
    overlap) run the front of all B rows and the back as one graph
    (``body``), one replay.

    Counters beside ``replays`` (calls: the back's replays, or the one
    graph's): ``staged_rows``, the images of every call;
    ``overlap_rows``, the rows whose front ran before the last chunk was
    staged, (B - rows_a_front) of B rows of a full host batch, none of
    images on the card, so ``overlap_rows / staged_rows`` is the share
    engaged; ``front_replays``, the fronts' replays on the card. The
    back's replay span counts ``launch`` (``_launch``; ``seq`` 0)."""

    def __init__(self, key, settings, level, dtype, shape, in_dtype, dev,
                 bucket, route, chunk):
        B, c, h, w = shape
        slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
        ll_h, ll_w = slices[0][1].stop, slices[0][2].stop
        _encoder.check_geometry(c, enc_h, enc_w, ll_h, ll_w)
        self.shape, self.cells, self.bucket = shape, (c, enc_h, enc_w), bucket
        self._words, self._n = bucket, B

        def front(s, e):
            def fn(images, t1, t3s, max_n, **_):
                arr, _, _ = forward(images[s:e], settings, level, dtype)
                for static, x in zip((t1, t3s, max_n),
                                     _encoder.row_tables(arr, ll_h, ll_w)):
                    static[s:e].copy_(x)
            return fn

        def back(t1, t3s, max_n, budgets, **_):
            words, stat = _encoder.encode_rows_batch(
                t1, t3s, max_n, self.cells, ll_h, ll_w, budgets, bucket,
                route, chunk)
            return words, torch.cat((stat, max_n[:, None]), 1)

        def body(**statics):  # the whole batch: one front, then the back
            front(0, B)(**statics)
            return back(**statics)

        tables = (B, c * enc_h * enc_w)
        super().__init__(key, dev, body, {
            "images": torch.empty(shape, dtype=in_dtype, device=dev),
            "budgets": torch.zeros(B, dtype=torch.int32, device=dev),
            "t1": torch.empty(tables, dtype=torch.int32, device=dev),
            "t3s": torch.empty(tables, dtype=torch.int32, device=dev),
            "max_n": torch.empty(B, dtype=torch.int32, device=dev),
        })
        row = self.statics["images"][0]
        k = min(B, -(-FRONT_BYTES // (row.numel() * row.element_size())))
        self.rows_a_front = k
        self._fronts = [(s, min(s + k, B)) for s in range(0, B, k)]
        self._front, self._back = front, back
        self._side = self._up = None  # the uploads' stream, its events
        self.staged_rows = self.overlap_rows = self.front_replays = 0
        self.launch = _launch(B, route, chunk, False)

    def start(self, images, max_bits) -> None:
        n, B = len(images), self.shape[0]
        if not 1 <= n <= B:
            raise ValueError(f"want 1 to {B} images, got {n}")
        mbs = _encoder.batch_budgets(max_bits, n)
        words = _encoder.cap_words_for(*self.cells, max(mbs))
        if words > self.bucket:
            raise ValueError(f"max_bits {max(mbs)} does not fit the "
                             f"program's {self.bucket} words")
        budgets = np.array(mbs + mbs[-1:] * (B - n), np.int32)
        self._begin()
        if (n < 2 or len(self._fronts) == 1
                or all(_on_card(im) for im in images)):
            self._put_rows(images)
            self._put("budgets", budgets)
            self.run()
        else:
            self._run_fronts(images, n)
            self._put("budgets", budgets)
            self.run("back", self._back)
        self.staged_rows += n
        self._words, self._n = words, n

    def _run_fronts(self, images, n: int) -> None:
        """Stage the n host images a chunk at a time, replaying each
        chunk's front graph once it is up, each replay cutting the stage
        span; then the rows past n take row n - 1's tables. On the card
        the uploads run on a side stream (after the stream's work so far),
        so a chunk goes up while the last one's front runs, and each front
        waits for its own chunk's (an event a front)."""
        if self._side is None and self.dev.type == "cuda":
            self._side = torch.cuda.Stream(self.dev)
            self._up = [torch.cuda.Event() for _ in self._fronts]
        if self._side is not None:
            main = torch.cuda.current_stream(self.dev)
            self._side.wait_stream(main)
        fronts = [(s, e) for s, e in self._fronts if s < n]
        for i, (s, e) in enumerate(fronts):
            with torch.cuda.stream(self._side):  # None: no-op
                self._stage_rows(images, s, min(e, n))
                _pad_rows(self.statics["images"][:e], n)
            if self._side is not None:
                self._up[i].record(self._side)
                main.wait_event(self._up[i])
                self.front_replays += 1
            if e < n:
                self.overlap_rows += e - s
            self._close_stage()
            self._replay(("front", s), self._front(s, e))
            self._stage = metrics.open_span(self._names["stage"])
        for name in ("t1", "t3s", "max_n"):
            _pad_rows(self.statics[name], fronts[-1][1])

    def on_device(self):
        """(words int32 (n, cap_words_for(largest budget)), stat (n,
        STAT_LEN), max_n (n,)) of the last start's n streams, fresh
        tensors on the program's device, equal to the eager body's."""
        words, head = self.outputs
        n = self._n
        out = (words[:n, : self._words].clone(),
               head[:n, : _encoder.STAT_LEN].clone(),
               head[:n, _encoder.STAT_LEN].clone())
        self._end()
        return out

    def finish(self) -> list:
        """[(stream bytes, max_n)] of the last start's n streams, read
        back to the host."""
        words, head = self.outputs
        rows = self._wait(head[: self._n].tolist)
        read = metrics.open_span(self._names["read"])
        stat = check_stat([r[: _encoder.STAT_LEN] for r in rows],
                          "spiht_encode_batch")
        data = batch_stream_bytes(words[: self._n], [r[0] for r in stat])
        out = list(zip(data, [r[_encoder.STAT_LEN] for r in rows]))
        if read is not None:
            metrics.close_span(read, bytes=sum(len(d) for d in data))
        return out

    def device_call(self, images, max_bits):
        with self.lock:
            self.start(images, max_bits)
            return self.on_device()

    def __call__(self, images, max_bits) -> list:
        with self.lock:
            self.start(images, max_bits)
            return self.finish()


class DecodeBatchProgram(_Program):
    """The batch decode pipeline of one key (``decode_batch_program``):
    B streams -> B images, the counterpart of the JAX package's
    ``_decode_pipeline_batch_jit``.

    ``start(streams, nbits, max_ns)`` copies n <= B streams (bytes, or
    int32 word rows on the host or the card) into the static (B, bucket)
    word buffer (``_put_words``: each row zeroed past its stream, rows
    past n repeating the last), writes nbits and max_n into a static (2,
    B) device tensor, which B5 or batched B3 (or each single launch of the
    ``map`` route) reads, and runs the program, with no sync. ``finish()``
    reads the n stat rows (the one sync), raises as ``check_stat`` does,
    and returns a fresh (n, ...) tensor of images. Its replay span counts
    ``launch`` (``_launch``: ``seq`` 1 where the B streams go through
    batched B3, at an odd LL on the ``ilv`` route)."""

    def __init__(self, key, settings, h, w, level, c, dtype, as_uint8, dev,
                 B, bucket, route, chunk):
        slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
        ll_h, ll_w = slices[0][1].stop, slices[0][2].stop
        dec = _decoder.decode_batch_body(c, enc_h, enc_w, ll_h, ll_w, bucket,
                                         dev, None, route, chunk)
        seq = _decoder.has_duplicate_parents(enc_h, enc_w, ll_h, ll_w)
        self.kernel = "spiht_decode_" + ("seq" if seq else "lsp") + "_batch"
        self.B, self.bucket, self._n = B, bucket, B
        self.launch = _launch(B, route, chunk, seq)

        def body(words, scalars):
            rec, stat, _ = dec(words, scalars)
            return inverse(rec.reshape(B, c, enc_h, enc_w), h, w, level,
                           settings, dtype, as_uint8), stat

        super().__init__(key, dev, body, {
            "words": torch.zeros(B, bucket, dtype=torch.int32, device=dev),
            "scalars": torch.zeros(2, B, dtype=torch.int32, device=dev),
        })

    def start(self, streams, nbits, max_ns) -> None:
        nbits, max_ns = [int(v) for v in nbits], [int(v) for v in max_ns]
        n, pad = len(nbits), self.B - len(nbits)
        if not 1 <= n <= self.B:
            raise ValueError(f"want 1 to {self.B} streams, got {n}")
        rows = _decoder.batch_scalar_rows(nbits + nbits[-1:] * pad,
                                          max_ns + max_ns[-1:] * pad,
                                          self.B, self.bucket)
        self._begin()
        self._put_words(streams, [(nb + 31) // 32 for nb in nbits])
        self._put("scalars", rows)
        self.run()
        self._n = n

    def finish(self) -> torch.Tensor:
        images, stat = self.outputs
        self._wait(check_stat, stat[: self._n], self.kernel)
        read = metrics.open_span(self._names["read"])
        images = images[: self._n].clone()
        self._end()
        if read is not None:
            metrics.close_span(read,
                               bytes=images.numel() * images.element_size())
        return images

    def __call__(self, streams, nbits, max_ns) -> torch.Tensor:
        with self.lock:
            self.start(streams, nbits, max_ns)
            return self.finish()


def encode_batch_program(
    settings: SpihtSettings,
    shape,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    in_dtype: torch.dtype = torch.float64,
    device=None,
    max_bits: int = 2**31 - 2,
) -> EncodeBatchProgram:
    """The cached encode program of a (B, C, H, W) batch of ``in_dtype``
    (a single image: B = 1). Its key: the settings, B, c, h, w, level, the
    working dtype and the images', the device, the route (``batch_route``,
    read here: B4 in launches of ``ilv_chunk(B)`` streams, or B1 a stream)
    and the word-buffer bucket: the least power of two of the words the
    largest budget ``max_bits`` needs, never past the full stream's
    buffer, ``cap_words_for(c, h, w, 2**31 - 2)``, so every budget a bucket
    takes gets the (budget, capped) pair and the stream it gets at its own
    buffer."""
    dev = resolve_device(device)
    B, c, h, w = (int(v) for v in shape)
    route, chunk = batch_route(B)
    skey = _settings_key(settings)
    enc_h, enc_w, _ = _geometry(skey, h, w, level)
    mb = max(min(int(max_bits), 2**31 - 2), 0)
    full = _encoder.cap_words_for(c, enc_h, enc_w, 2**31 - 2)
    bucket = min(_pow2(_encoder.cap_words_for(c, enc_h, enc_w, mb)), full)
    key = ("encode_batch", skey, B, c, h, w, level, dtype, in_dtype, dev,
           route, chunk, bucket)
    return _program(key, dev, lambda: EncodeBatchProgram(
        key, _settings_of(skey), level, dtype, (B, c, h, w), in_dtype, dev,
        bucket, route, chunk))


def decode_batch_program(
    settings: SpihtSettings,
    h: int,
    w: int,
    level: Optional[int],
    c: int,
    B: int,
    dtype: torch.dtype = torch.float64,
    as_uint8: bool = False,
    device=None,
    nbits: int = 0,
) -> DecodeBatchProgram:
    """The cached decode program of B streams of an (h, w, c) image (a
    single stream: B = 1). Its key: the settings, B, c, h, w, level,
    dtype, the device, the machine (B5, or batched B3 at odd LL, as the
    geometry routes it), the route (``batch_route``, read here: launches
    of ``ilv_chunk(B)`` streams, or B2 and its scatter, or B3, a stream),
    the word-buffer bucket (the least power of two of the words the
    longest stream's ``nbits`` needs) and ``as_uint8``."""
    dev = resolve_device(device)
    B = int(B)
    route, chunk = batch_route(B)
    skey = _settings_key(settings)
    seq = _geometry(skey, h, w, level)[2]
    bucket = _pow2(max((int(nbits) + 31) // 32, 1))
    key = ("decode_batch", skey, B, c, h, w, level, dtype, dev,
           "b3" if seq else "b5", route, chunk, bucket, bool(as_uint8))
    return _program(key, dev, lambda: DecodeBatchProgram(
        key, _settings_of(skey), h, w, level, c, dtype, as_uint8, dev, B,
        bucket, route, chunk))


def _rows_of(images):
    """Same-shape images as a (B, C, H, W) tensor (as it is), or a list of
    (C, H, W) tensors where they lie (numpy ones wrapped, no copy), with
    their shape and common dtype."""
    if isinstance(images, torch.Tensor) and images.dim() == 4:
        return images, tuple(images.shape[1:]), images.dtype
    rows = [_image_of(im) for im in images]
    if not rows:
        raise ValueError("an empty batch")
    shape = tuple(rows[0].shape)
    if any(tuple(r.shape) != shape for r in rows):
        raise ValueError("the images of a batch must share one shape")
    return rows, shape, functools.reduce(torch.promote_types,
                                         (r.dtype for r in rows))


def _encode_parts(settings, images, max_bits, level, dtype, dev):
    """(the program, [(images, budgets)] of its parts) of a same-shape
    batch: one key, the parts of ``_batch_parts``, the bucket of the
    largest budget."""
    rows, shape, in_dtype = _rows_of(images)
    mbs = _encoder.batch_budgets(max_bits, len(rows))
    m, parts = _batch_parts(len(rows), shape, dev)
    prog = encode_batch_program(settings, (m,) + shape, level, dtype,
                                in_dtype, dev, max(mbs))
    return prog, [(rows[s:e], mbs[s:e]) for s, e in parts]


def encode_batch(
    settings: SpihtSettings,
    images,
    max_bits,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    device=None,
) -> list:
    """[(stream bytes, max_n)] of same-shape images (a (B, C, H, W) tensor,
    or a list of (C, H, W) numpy arrays or tensors), in input order,
    through one ``encode_batch_program``, replayed for each of the equal
    parts of at most ``batch_bound`` images (``_batch_parts``).
    ``max_bits``: B ints."""
    prog, parts = _encode_parts(settings, images, max_bits, level, dtype,
                                resolve_device(device))
    return [r for part in parts for r in prog(*part)]


def decode_batch(
    settings: SpihtSettings,
    h: int,
    w: int,
    level: Optional[int],
    c: int,
    streams,
    nbits,
    max_ns,
    dtype: torch.dtype = torch.float64,
    as_uint8: bool = False,
    device=None,
) -> torch.Tensor:
    """Images (B, ...) of B streams of one (h, w, c) image, a fresh tensor
    on ``device``, in input order, through one ``decode_batch_program``
    (the bucket of the longest stream), replayed for each of the equal
    parts of at most ``batch_bound`` images (``_batch_parts``).
    ``streams``: B byte strings, or int32 word rows (a (B, n) tensor or
    array) holding each stream's ``nbits``."""
    dev = resolve_device(device)
    nbits = [int(v) for v in nbits]
    max_ns = [int(v) for v in max_ns]
    m, parts = _batch_parts(len(nbits), (c, h, w), dev)
    prog = decode_batch_program(settings, h, w, level, c, m, dtype, as_uint8,
                                dev, max(nbits))
    outs = [prog(streams[s:e], nbits[s:e], max_ns[s:e]) for s, e in parts]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def encode_pipeline_batch_fn(
    settings: SpihtSettings,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    device=None,
):
    """fn(images (B,C,H,W) tensor or numpy, max_bits: B ints) -> (words
    (B, cap_words), stat (B, STAT_LEN), max_n (B,)), all on ``device``
    (None: the images', the card for numpy), as the eager body returns
    them: the batched transform -> per-image max_n -> maps -> kernel B4
    (or B1 a stream, ``batch_route``), as one cached program a key
    (``encode_batch_program``), replayed for each part, as
    ``encode_batch`` splits a batch. Nothing is read back to the host."""

    def fn(images, max_bits):
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        if images.dim() != 4:
            raise ValueError("images ndim must be 4: b,c,h,w")
        prog, parts = _encode_parts(settings, images, max_bits, level, dtype,
                                    _device_of(images, device))
        width = _encoder.cap_words_for(*prog.cells,
                                       max(max(mbs) for _, mbs in parts))
        outs = []
        for part in parts:
            words, stat, max_n = prog.device_call(*part)
            outs.append((torch.nn.functional.pad(
                words, (0, width - words.shape[1])), stat, max_n))
        if len(outs) == 1:
            return outs[0]
        return tuple(torch.cat(x) for x in zip(*outs))

    return fn


def decode_pipeline_batch_fn(
    settings: SpihtSettings,
    h: int,
    w: int,
    level: Optional[int],
    c: int,
    dtype: torch.dtype = torch.float64,
    as_uint8: bool = False,
    device=None,
):
    """fn(words int32 (B, cap_words) tensor or numpy, nbits: B ints,
    max_n: B ints) -> images (B, ...) on ``device`` (None: the words', the
    card for numpy), a fresh tensor: kernel B5 (+ one rec scatter) or
    batched B3 (or single launches, ``batch_route``) -> dequantize ->
    ``waverec2`` -> inverse colour, as cached programs a key
    (``decode_batch_program``); raises on a machine error."""

    def fn(words, nbits, max_ns):
        return decode_batch(settings, h, w, level, c, words, nbits, max_ns,
                            dtype, as_uint8, _device_of(words, device))

    return fn


# ---------------------------------------------------------------------------
# The host-facing transforms: one CUDA graph a key
# ---------------------------------------------------------------------------


class TransformProgram(_Program):
    """One transform at one key, the counterpart of one of the JAX
    package's jitted transforms: ``forward_program`` (``_forward_jit``),
    ``inverse_program`` (``_inverse_jit``), ``compact_program``
    (``_forward_compact_jit``), ``plan_program`` (``_forward_plan_jit``)
    and ``narrow_program`` (``_narrow_jit``).

    ``start(x, **named)`` copies ``x`` into the static input "x": a
    tensor or array of its whole shape where it lies (from the host
    through a pinned buffer), or a list of n rows of a batch
    (``_put_rows``: rows past n repeat the last); and each named value
    into its static buffer (``_put``). Then it runs the program, with no
    sync. ``outputs`` holds the body's tuple until the next run;
    ``fresh()`` returns clones of it and ``host(n)`` numpy copies of the
    first n rows of each, read straight from the graph's outputs. A call
    holds ``lock`` from ``start`` to its read; ``__call__`` does."""

    def __init__(self, key, dev, body, shape, in_dtype, ll=None,
                 extra=None):
        self.shape, self.ll = tuple(shape), ll
        statics = {"x": torch.empty(shape, dtype=in_dtype, device=dev)}
        statics.update(extra or {})
        super().__init__(key, dev, body, statics)

    def start(self, x, **named) -> None:
        self._begin()
        if isinstance(x, (list, tuple)):
            self._put_rows(x, "x")
        else:
            self._put("x", x)
        for name, value in named.items():
            self._put(name, value)
        self.run()

    def fresh(self) -> tuple:
        out = tuple(t.clone() for t in self.outputs)
        self._end()
        return out

    def host(self, n: Optional[int] = None) -> tuple:
        out = tuple((t[:n] if t.dim() and n is not None else t).cpu().numpy()
                    for t in self.outputs)
        self._end()
        return out

    def __call__(self, x, **named) -> tuple:
        with self.lock:
            self.start(x, **named)
            return self.fresh()


def _ll_of(h, w, settings, level):
    slices, _, _ = get_slices_and_h_w(h, w, settings, level)
    return slices[0][1].stop, slices[0][2].stop


def forward_program(
    settings: SpihtSettings,
    shape,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    with_maps: bool = False,
    in_dtype: torch.dtype = torch.float64,
    device=None,
) -> TransformProgram:
    """The cached forward program of (..., C, H, W) images of
    ``in_dtype``: body ``forward`` (and the significance maps with
    ``with_maps``) -> (arr,) or (arr, M, D, G). Its key: the settings,
    the whole shape, level, the working dtype, ``with_maps``, the input
    dtype and the device."""
    dev = resolve_device(device)
    shape = tuple(int(v) for v in shape)
    skey = _settings_key(settings)
    key = ("forward", skey, shape, level, dtype, bool(with_maps), in_dtype,
           dev)

    def make():
        s = _settings_of(skey)

        def body(x):
            arr, ll_h, ll_w = forward(x, s, level, dtype)
            if with_maps:
                return (arr,) + significance_maps(arr, ll_h, ll_w)
            return (arr,)

        return TransformProgram(key, dev, body, shape, in_dtype,
                                _ll_of(shape[-2], shape[-1], s, level))

    return _program(key, dev, make)


def inverse_program(
    settings: SpihtSettings,
    shape,
    h: int,
    w: int,
    level: Optional[int],
    dtype: torch.dtype = torch.float64,
    as_uint8: bool = False,
    in_dtype: torch.dtype = torch.int32,
    device=None,
) -> TransformProgram:
    """The cached inverse program of (..., C, enc_h, enc_w) coefficients
    of ``in_dtype`` of (h, w) images: body ``inverse`` -> (image,). Its
    key: the settings, the whole shape, h, w, level, dtype, ``as_uint8``,
    the input dtype and the device."""
    dev = resolve_device(device)
    shape = tuple(int(v) for v in shape)
    skey = _settings_key(settings)
    key = ("inverse", skey, shape, int(h), int(w), level, dtype,
           bool(as_uint8), in_dtype, dev)

    def make():
        s = _settings_of(skey)

        def body(x):
            return (inverse(x, h, w, level, s, dtype, as_uint8),)

        return TransformProgram(key, dev, body, shape, in_dtype)

    return _program(key, dev, make)


def compact_program(
    settings: SpihtSettings,
    shape,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    in_dtype: torch.dtype = torch.float64,
    device=None,
) -> TransformProgram:
    """The cached ``forward_compact`` program of (B, C, H, W) images:
    body -> (int16 coefficients, overflow). Its key: the settings, the
    shape, level, the working and input dtypes, the route
    (``compact_route``: kernel B6, or the torch ops) and the device."""
    dev = resolve_device(device)
    shape = tuple(int(v) for v in shape)
    skey = _settings_key(settings)
    route = compact_route(dtype)
    key = ("forward_compact", skey, shape, level, dtype, in_dtype, route,
           dev)

    def make():
        s = _settings_of(skey)

        def body(x):
            return forward_compact(x, s, level, dtype, route)[:2]

        return TransformProgram(key, dev, body, shape, in_dtype,
                                _ll_of(shape[-2], shape[-1], s, level))

    return _program(key, dev, make)


# the columns of the plan program's head row a stream: max |x|, the exact
# max(M), the stream's max_n, then the bits of each plane
PLAN_HEAD = 3


def plan_program(
    settings: SpihtSettings,
    shape,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    in_dtype: torch.dtype = torch.float64,
    device=None,
) -> TransformProgram:
    """The cached ``forward_plan`` program of (B, C, H, W) images (even LL
    only): body -> (arr int32 (B, C, enc_h, enc_w), head int64 (B,
    PLAN_HEAD + 32)): a row an image of max |x|, the exact max(M), the
    stream's max_n (``device_max_n``, the reference's float32 rule on the
    uint32 magnitude) and the 32 per-plane bit counts, one read. Its key:
    the settings, the shape, level, the working and input dtypes and the
    device."""
    dev = resolve_device(device)
    shape = tuple(int(v) for v in shape)
    skey = _settings_key(settings)
    key = ("forward_plan", skey, shape, level, dtype, in_dtype, dev)

    def make():
        s = _settings_of(skey)

        def body(x):
            arr, mx, counts, max_n_dev, _, _ = forward_plan(x, s, level,
                                                            dtype)
            head = torch.stack([mx.long(), max_n_dev.long(),
                                device_max_n(arr).long()], 1)
            return arr, torch.cat((head, counts), 1)

        return TransformProgram(key, dev, body, shape, in_dtype,
                                _ll_of(shape[-2], shape[-1], s, level))

    return _program(key, dev, make)


def narrow_program(shape, out_dtype: torch.dtype,
                   device=None) -> TransformProgram:
    """The cached ``narrow`` program of (B, C, H, W) int32 coefficients
    to ``out_dtype`` (int8 or int16), its per-image shifts in a static
    (B,) device buffer ("shifts"). Its key: the shape, the out dtype and
    the device."""
    dev = resolve_device(device)
    shape = tuple(int(v) for v in shape)
    key = ("narrow", shape, out_dtype, dev)

    def make():
        def body(x, shifts):
            return (narrow(x, shifts, out_dtype),)

        return TransformProgram(key, dev, body, shape, torch.int32, extra={
            "shifts": torch.zeros(shape[0], dtype=torch.int32, device=dev)})

    return _program(key, dev, make)
