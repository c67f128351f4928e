"""Transform pipelines in PyTorch, the port of ``spiht_tpu/jax_transform.py``.

* ``forward`` (``_forward_jit`` :66-85): colour model -> packed multilevel
  DWT -> per-channel scales -> ``* quantization_scale`` -> truncating int32
  cast.
* ``inverse`` (``_inverse_jit`` :149-193): ``/ per-channel scales``,
  ``/ quantization_scale``, ``waverec2``, inverse colour, optional uint8.
  No crop to (h, w): like the reference, the output can exceed the
  original dims for odd sizes.
* ``encode_pipeline_fn`` / ``decode_pipeline_fn`` (:343-389, :242-293): the
  whole encode (image -> stream words) and decode (stream words -> image)
  on one device, through the bit-machine kernels, as one cached program
  a key (``encode_program`` / ``decode_program``: a CUDA graph on the
  card; the ``lru_cache``d jitted programs there). Their op-by-op bodies
  are ``encode_pipeline_eager`` / ``decode_pipeline_eager``.
* ``encode_pipeline_batch_fn`` / ``decode_pipeline_batch_fn`` (:535-662,
  :393-500): the same over a (B, C, H, W) batch of one shape, through the
  batched kernels (B4; B5 or batched B3), one launch per direction.

* ``forward_compact`` (``_forward_compact_jit`` :103-146): the forward
  transform to int16 coefficients and an overflow flag, for the
  host-scheduled batch codec; with the float32 working dtype the quantize
  step is kernel B6 (``ops/quantize_kernels.py``).
* ``forward_plan`` and ``narrow`` (``_forward_plan_jit`` :701-733,
  ``_narrow_jit`` :736-746): the two device phases of the budget-narrowed
  batch encode.

* ``analysis_fn``, ``synthesis_fn``, ``forward_with_maps`` and
  ``default_dtype`` (:196, :214, :681, :48): the JAX package's factories
  and host step, over ``forward`` and ``inverse``. ``default_dtype`` is
  float64, the port's working default on every device (the JAX package
  picks float32 without x64).

``forward`` and ``inverse`` take leading batch dims: every step is
elementwise or works along H and W, so no value depends on the batch and
each image of a batch gets exactly what it gets alone.

The working dtype defaults to float64 on every device, so streams equal
the host float64 path. float32 is accepted with the JAX float32 path's
caveat: borderline truncations may flip.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from .device import constant, holding, resolve_device
from .codec import decoder as _decoder, encoder as _encoder
from .codec.decoder import decode_coeffs, decode_coeffs_batch
from .codec.encoder import (
    check_stat, encode_coeffs, encode_coeffs_batch, stream_bytes,
)
from .codec.maps import significance_maps
from .codec.planning import bits_per_plane_from_maps
from .ops.quantize_kernels import quantize_compact
from .color import torch_models
from .settings import SpihtSettings
from .wavelets import dwt
from .wavelets.geometry import get_slices_and_h_w

__all__ = [
    "forward",
    "forward_with_maps",
    "forward_compact",
    "forward_plan",
    "narrow",
    "inverse",
    "encode_pipeline_fn",
    "decode_pipeline_fn",
    "encode_pipeline_eager",
    "decode_pipeline_eager",
    "encode_program",
    "decode_program",
    "EncodeProgram",
    "DecodeProgram",
    "programs",
    "clear_programs",
    "encode_pipeline_batch_fn",
    "decode_pipeline_batch_fn",
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
    # truncate toward zero, as the reference's integer cast
    arr = (arr * float(settings.quantization_scale)).to(torch.int32)
    return arr, ll_h, ll_w


def forward_with_maps(
    image: torch.Tensor,
    settings: SpihtSettings,
    level: Optional[int] = None,
):
    """``forward`` in ``default_dtype`` plus the significance maps: (arr
    int32, (M, D, G) int8, ll_h, ll_w), tensors on the image's device."""
    arr, ll_h, ll_w = forward(image, settings, level, default_dtype())
    return arr, significance_maps(arr, ll_h, ll_w), ll_h, ll_w


def analysis_fn(
    settings: SpihtSettings,
    level: Optional[int] = None,
    with_maps: bool = True,
    dtype: Optional[str] = None,
):
    """fn(image(s) (..., C, H, W) tensor) -> arr int32, or (arr, M, D, G)
    with ``with_maps``: colour, DWT, scales and quantization
    (``forward``), then the maps, on the image's device. ``dtype``: None
    (``default_dtype``) or a name such as "float32"."""
    dt = _as_dtype(dtype)

    def fn(image: torch.Tensor):
        arr, ll_h, ll_w = forward(image, settings, level, dt)
        if with_maps:
            return (arr,) + significance_maps(arr, ll_h, ll_w)
        return arr

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
    array's device: ``inverse`` in ``dtype`` (as ``analysis_fn`` takes
    it)."""
    dt = _as_dtype(dtype)

    def fn(rec_arr: torch.Tensor):
        return inverse(rec_arr, h, w, level, settings, dt, as_uint8)

    return fn


def forward_compact(
    image: torch.Tensor,
    settings: SpihtSettings,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """(..., C, H, W) image(s) -> (int16 coefficients clipped to +-32767,
    overflow 0-d bool: whether any |coefficient| > 32767, ll_h, ll_w), on
    the images' device; no host sync.

    With the float32 working dtype the quantize, the clip and the
    overflow check are one pass of kernel B6 over the scaled float32
    coefficients, as the JAX package's TPU path runs them; otherwise they
    are torch ops on ``forward``'s int32 array (B6 quantizes in float32,
    which could flip a borderline truncation of the float64 path).
    ``SPIHT_TPU_PALLAS`` routes as in the JAX package (``_use_pallas``
    :88-101): set, "1" runs B6 (float32 only) and any other value the
    torch ops; unset, B6 runs on float32."""
    flag = os.environ.get("SPIHT_TPU_PALLAS")
    if dtype == torch.float32 and (flag is None or flag == "1"):
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
    device."""
    slices, _, _ = get_slices_and_h_w(h, w, settings, level)
    rec = rec_arr.to(dtype)
    if settings.per_channel_quant_scales is not None:
        rec = rec / _mults(settings.per_channel_quant_scales, rec)
    rec = rec / float(settings.quantization_scale)
    coeffs = [rec[(...,) + slices[0][1:]]]
    for d in slices[1:]:
        coeffs.append({k: rec[(...,) + v[1:]] for k, v in d.items()})
    image = dwt.waverec2(coeffs, settings.wavelet, settings.mode)
    if settings.color_model is not None:
        image = torch_models.convert(image, settings.color_model, "RGB")
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
# The program cache: the single-image round trip, one CUDA graph a key
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


def _pow2(n: int) -> int:
    """The least power of two >= n (1 for n <= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


class _Program:
    """One pipeline at one key on its static buffers (``statics``).

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
    program counts its replays (``replays``). A call (``start`` and what
    reads its outputs) holds ``lock``: calls from several threads take
    their turns, and a call waits, on the device, for the last call's
    reads of the outputs (``_done``) before it overwrites the buffers.
    """

    def __init__(self, key, dev, body, statics):
        self.key, self.dev, self.body, self.statics = key, dev, body, statics
        self.lock = threading.RLock()
        self.graph = None
        self.outputs = None
        self.replays = 0
        self.held = []  # the constants and tables the graph reads
        self.pool_bytes = 0  # reserved for the graph's pool by its capture
        self.static_bytes = sum(t.numel() * t.element_size()
                                for t in statics.values())
        self.host_bytes = 0  # pinned staging
        self.capture_s = None  # the first run's warm-up and capture
        self._pinned = {}
        self._staged = None  # the last upload from the pinned buffers
        self._done = None  # the last call's reads of the outputs

    @property
    def device_bytes(self) -> int:
        return self.pool_bytes + self.static_bytes

    def run(self):
        if self.dev.type != "cuda":
            self.outputs = self.body(**self.statics)
            return self.outputs
        with torch.cuda.device(self.dev):
            if self.graph is None:
                self._capture()
            self.graph.replay()
        self.replays += 1
        return self.outputs

    def _capture(self):
        t0 = time.perf_counter()
        try:
            with holding() as held:
                self.body(**self.statics)  # the warm-up
                # the graph's own __enter__ empties the cache too: what the
                # capture reserves afterwards is the pool
                torch.cuda.synchronize(self.dev)
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(self.dev)
                graph = torch.cuda.CUDAGraph()
                gc_on = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(graph):
                        outputs = self.body(**self.statics)
                finally:
                    if gc_on:
                        gc.enable()
        except BaseException:
            with _LOCK:
                if _PROGRAMS.get(self.key) is self:
                    del _PROGRAMS[self.key]
            raise
        self.pool_bytes = torch.cuda.memory_reserved(self.dev) - reserved
        self.held, self.graph, self.outputs = held, graph, outputs
        self.capture_s = time.perf_counter() - t0
        with _LOCK:
            _evict(self.dev, keep=self)

    def _begin(self) -> None:
        """Wait for the last call's copies from the pinned buffers (their
        event, on the host), so that the host may write them again, and,
        on the device, for its reads of the outputs."""
        if self._staged is not None:
            self._staged.synchronize()
        if self._done is not None:
            torch.cuda.current_stream(self.dev).wait_event(self._done)

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
        if self.dev.type != "cuda":
            static.copy_(host)
            return
        pin = self._pin(name, static)
        pin.copy_(host)
        self._upload(static, pin)


class EncodeProgram(_Program):
    """The encode pipeline of one key (``encode_program``), the
    counterpart of the JAX package's ``_encode_pipeline_jit``.

    ``start(image, max_bits)`` copies the image into the static input
    buffer (through a pinned buffer from the host), writes the budget and
    its capped flag into two static device scalars (``encoder._budget``
    at the program's word buffer: every budget gives the pair it gives at
    its own buffer) and runs the program, with no sync. Then either
    ``on_device()`` returns fresh copies of (words, stat, max_n) on the
    card, as the eager body returns them, with no sync; or ``finish()``
    reads the stat row and max_n (one read, the one sync), raises as
    ``check_stat`` does, and reads the stream's bytes. A call holds
    ``lock`` from ``start`` to its read; ``__call__`` and
    ``device_call`` do."""

    def __init__(self, key, settings, level, dtype, shape, in_dtype, dev,
                 bucket):
        c, h, w = shape
        slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
        _encoder.check_geometry(c, enc_h, enc_w, slices[0][1].stop,
                                slices[0][2].stop)
        self.shape, self.cells, self.bucket = shape, (c, enc_h, enc_w), bucket
        self._words = bucket  # the words the last budget's buffer holds

        def body(image, scalars):
            arr, ll_h, ll_w = forward(image, settings, level, dtype)
            words, stat, max_n = encode_coeffs(
                arr, ll_h, ll_w, (scalars[0], scalars[1]), None, bucket)
            return words, torch.cat((stat, max_n.reshape(1)))

        super().__init__(key, dev, body, {
            "image": torch.empty(shape, dtype=in_dtype, device=dev),
            "scalars": torch.zeros(2, dtype=torch.int32, device=dev),
        })

    def start(self, image, max_bits) -> None:
        mb = min(int(max_bits), 2**31 - 2)
        words = _encoder.cap_words_for(*self.cells, max(mb, 0))
        if mb < 0 or words > self.bucket:
            raise ValueError(f"max_bits {max_bits} does not fit the "
                             f"program's {self.bucket} words")
        budget, capped = _encoder._budget(mb, self.bucket)
        self._begin()
        self._put("image", image)
        self._put("scalars", np.array([budget, int(capped)], np.int32))
        self.run()
        self._words = words

    def on_device(self):
        """(words int32[cap_words_for(budget)], stat, max_n 0-d), fresh
        tensors on the program's device, equal to the eager body's."""
        words, head = self.outputs
        out = (words[: self._words].clone(),
               head[: _encoder.STAT_LEN].clone(),
               head[_encoder.STAT_LEN].clone())
        self._end()
        return out

    def finish(self):
        """(stream bytes, total bits, max_n), read back to the host."""
        words, head = self.outputs
        head = head.tolist()
        stat = check_stat(head[: _encoder.STAT_LEN], "spiht_encode")
        return stream_bytes(words, stat[0]), stat[0], head[_encoder.STAT_LEN]

    def device_call(self, image, max_bits):
        with self.lock:
            self.start(image, max_bits)
            return self.on_device()

    def __call__(self, image, max_bits):
        with self.lock:
            self.start(image, max_bits)
            return self.finish()


class DecodeProgram(_Program):
    """The decode pipeline of one key (``decode_program``): stream ->
    image, the counterpart of the JAX package's ``_decode_pipeline_jit``.

    ``start(words, nbits, max_n)`` copies the stream's words into the
    static word buffer (from bytes or the host through a pinned buffer),
    zeroes the buffer past them, so that what it held before cannot
    change a result, writes nbits and max_n into two static device
    scalars, and runs the program, with no sync. ``finish()`` reads the
    stat row (the one sync), raises as ``check_stat`` does (no image
    comes back), and returns a fresh tensor: a clone of the graph's
    output, which the next run overwrites. A call holds ``lock`` from
    ``start`` to ``finish``; ``__call__`` does."""

    def __init__(self, key, settings, h, w, level, c, dtype, as_uint8, dev,
                 bucket):
        slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
        ll_h, ll_w = slices[0][1].stop, slices[0][2].stop
        core = _decoder._dec_core(c, enc_h, enc_w, ll_h, ll_w, bucket, None,
                                  dev)
        seq = _decoder.has_duplicate_parents(enc_h, enc_w, ll_h, ll_w)
        self.kernel = "spiht_decode_" + ("seq" if seq else "lsp")
        self.bucket = bucket

        def body(words, scalars):
            rec, stat, _ = core(words, scalars[0], scalars[1])
            return inverse(rec.reshape(c, enc_h, enc_w), h, w, level,
                           settings, dtype, as_uint8), stat

        super().__init__(key, dev, body, {
            "words": torch.zeros(bucket, dtype=torch.int32, device=dev),
            "scalars": torch.zeros(2, dtype=torch.int32, device=dev),
        })

    def start(self, words, nbits, max_n) -> None:
        nbits = int(nbits)
        n = max((nbits + 31) // 32, 1)
        if nbits < 0 or n > self.bucket:
            raise ValueError(f"nbits {nbits} does not fit the program's "
                             f"{self.bucket} words")
        static = self.statics["words"]
        self._begin()
        if isinstance(words, torch.Tensor) and words.device.type != "cpu":
            static[:n].copy_(words.reshape(-1)[:n])
        else:
            if isinstance(words, (bytes, bytearray, memoryview)):
                raw = np.frombuffer(words, np.uint8)
            elif isinstance(words, torch.Tensor):
                raw = words.reshape(-1).contiguous().numpy().view(np.uint8)
            else:
                raw = np.ascontiguousarray(words).reshape(-1).view(np.uint8)
            raw = raw[: n * 4]
            cuda = self.dev.type == "cuda"
            buf = self._pin("words", static) if cuda else static
            view = buf.numpy().view(np.uint8)
            view[: raw.size] = raw
            view[raw.size: n * 4] = 0
            if cuda:
                self._upload(static[:n], buf[:n])
        if n < self.bucket:
            static[n:].zero_()
        self._put("scalars", np.array([nbits, int(max_n)], np.int32))
        self.run()

    def finish(self) -> torch.Tensor:
        image, stat = self.outputs
        check_stat(stat, self.kernel)
        image = image.clone()
        self._end()
        return image

    def __call__(self, words, nbits, max_n) -> torch.Tensor:
        with self.lock:
            self.start(words, nbits, max_n)
            return self.finish()


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


def encode_program(
    settings: SpihtSettings,
    shape,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
    in_dtype: torch.dtype = torch.float64,
    device=None,
    max_bits: int = 2**31 - 2,
) -> EncodeProgram:
    """The cached encode program of a (C, H, W) image of ``in_dtype``.
    Its key: the settings, c, h, w, level, the working dtype and the
    image's, the device, the machine route (B1) and the word-buffer
    bucket: the least power of two of the words ``max_bits`` needs, never
    past the full stream's buffer, ``cap_words_for(c, h, w, 2**31 - 2)``,
    so every budget a bucket takes gets the (budget, capped) pair and the
    stream it gets at its own buffer."""
    dev = resolve_device(device)
    c, h, w = (int(v) for v in shape)
    _, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
    mb = min(int(max_bits), 2**31 - 2)
    full = _encoder.cap_words_for(c, enc_h, enc_w, 2**31 - 2)
    bucket = min(_pow2(_encoder.cap_words_for(c, enc_h, enc_w, max(mb, 0))),
                 full)
    skey = _settings_key(settings)
    key = ("encode", skey, c, h, w, level, dtype, in_dtype, dev, "b1", bucket)
    return _program(key, dev, lambda: EncodeProgram(
        key, _settings_of(skey), level, dtype, (c, h, w), in_dtype, dev,
        bucket))


def decode_program(
    settings: SpihtSettings,
    h: int,
    w: int,
    level: Optional[int],
    c: int,
    dtype: torch.dtype = torch.float64,
    as_uint8: bool = False,
    device=None,
    nbits: int = 0,
) -> DecodeProgram:
    """The cached decode program of an (h, w, c) image's streams. Its key:
    the settings, c, h, w, level, dtype, the device, the machine route
    (B2 and the scatter, or B3 at odd LL, as the geometry routes it), the
    word-buffer bucket (the least power of two of the words ``nbits``
    needs) and ``as_uint8``."""
    dev = resolve_device(device)
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
    seq = _decoder.has_duplicate_parents(enc_h, enc_w, slices[0][1].stop,
                                         slices[0][2].stop)
    bucket = _pow2(max((int(nbits) + 31) // 32, 1))
    skey = _settings_key(settings)
    key = ("decode", skey, c, h, w, level, dtype, dev,
           "b3" if seq else "b2", bucket, bool(as_uint8))
    return _program(key, dev, lambda: DecodeProgram(
        key, _settings_of(skey), h, w, level, c, dtype, as_uint8, dev,
        bucket))


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
    B1, as one cached program a key (``encode_program``). Nothing is read
    back to the host: the stream's words stay on the device for a
    consumer there."""

    def fn(image, max_bits: int):
        img = _image_of(image)
        return encode_program(
            settings, img.shape, level, dtype, img.dtype,
            _device_of(image, device), max_bits).device_call(img, max_bits)

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
    as one cached program a key (``decode_program``): kernel B2 (+ rec
    scatter) or B3 -> dequantize -> ``waverec2`` -> inverse colour; raises
    on a machine error. ``words``: stream bytes, or int32 words (a tensor
    or a numpy array) holding at least ``nbits``."""

    def fn(words, nbits: int, max_n: int):
        return decode_program(settings, h, w, level, c, dtype, as_uint8,
                              _device_of(words, device), nbits)(
            words, nbits, max_n)

    return fn


def encode_pipeline_batch_fn(
    settings: SpihtSettings,
    level: Optional[int] = None,
    dtype: torch.dtype = torch.float64,
):
    """fn(images (B,C,H,W) tensor, max_bits: B ints) -> (words (B,
    cap_words), stat (B, STAT_LEN), max_n (B,)), all on the images'
    device: the batched transform -> per-image max_n -> maps -> kernel B4.
    Nothing is read back to the host."""

    def fn(images: torch.Tensor, max_bits):
        arr, ll_h, ll_w = forward(images, settings, level, dtype)
        return encode_coeffs_batch(arr, ll_h, ll_w, max_bits)

    return fn


def decode_pipeline_batch_fn(
    settings: SpihtSettings,
    h: int,
    w: int,
    level: Optional[int],
    c: int,
    dtype: torch.dtype = torch.float64,
    as_uint8: bool = False,
):
    """fn(words int32 (B, cap_words), nbits: B ints, max_n: B ints) ->
    images (B, ...) on the words' device: kernel B5 (+ one rec scatter) or
    batched B3 -> dequantize -> ``waverec2`` -> inverse colour."""
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
    ll_h, ll_w = slices[0][1].stop, slices[0][2].stop

    def fn(words: torch.Tensor, nbits, max_ns):
        rec = decode_coeffs_batch(words, nbits, max_ns, c, enc_h, enc_w,
                                  ll_h, ll_w)
        return inverse(rec, h, w, level, settings, dtype, as_uint8)

    return fn
