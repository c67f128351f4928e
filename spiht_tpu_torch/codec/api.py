"""Public codec API, the port of ``spiht_tpu/codec/api.py``.

* The on-device codec: ``encode_image_device`` (:176-215),
  ``encode_images_device`` (:218-274), ``decode_image_device``
  (:635-678) and ``decode_images_device`` (:681-728). They return
  tensors on the device.
* The host-shaped surface, with the JAX signatures and results (numpy
  arrays, ``bytes``, ``EncodingResult``), so a caller can swap packages:
  the raw ``encode`` (:53; B1, or B7 for ``machine="seq"``), ``decode``
  (:82; B2 or B3) and ``decode_with_metadata`` (:105; B2-log, or B3-log
  at odd LL, and the log's expansion); ``encode_image`` (:153),
  ``decode_rec_array`` (:573), ``decode_from_rec_arr`` (:623) and
  ``decode_image`` (:731), whose transforms run under the backend of
  ``transform.py`` (``SPIHT_TPU_TRANSFORM``: the torch transform on the
  device, or the numpy or native C++ one on the host) around the bit
  machines on the device; and the host-scheduled batch codec
  ``encode_images`` (:351, with the budget-narrowed path :277-348) and
  ``decode_images`` (:497), whose serial bit scheduling runs in the native
  C++ scheduler's threads (``native/runtime.py``) around transforms on
  the device (kernel B6 in the float32 working dtype) or, under the
  'native' and 'numpy' backends, on the host.

The JAX package's API switches, read where it reads them:

* ``SPIHT_TPU_DEVICE_ENCODER=1``: the raw ``encode`` of an even-LL array
  goes through ``device_encoder.encode_device`` (kernel B1, or the
  sorted-space machine under ``SPIHT_TPU_PALLAS_ENCODER=0``); odd LL, and
  a ``CapacityOverflow`` of that machine, take the default route (:58-73).
* ``SPIHT_TPU_DEVICE_DECODER=1``: the raw ``decode`` goes through
  ``device_decoder.decode_device`` (B2 or B3, or the hybrid machine under
  ``SPIHT_TPU_PALLAS_DECODER=0``), a ``ValueError`` there taking the
  default route (:86-96); ``decode_with_metadata`` through
  ``decode_device_with_metadata`` (:117-127).
* ``SPIHT_TPU_NO_NATIVE`` (any non-empty value): ``encode_images`` and
  ``decode_images`` schedule the bits in the pure-Python oracle
  (``oracle.py``, :489, :533-550) and skip the budget-narrowed path,
  which needs the native scheduler (:392).

Everything runs on the CUDA card unless the caller passes
``device="cpu"`` (the plain versions, as the tests use them); without a
card every entry point raises, whatever the backend. There is no host
fallback: the word buffer is sized from the real budget, so the stream
cannot overflow it, a machine that reports an error raises, and the
native scheduler raises if it cannot be built. ``SPIHT_TPU_VALIDATE=1``
rejects images holding NaN or Inf (a pass over the input).
"""

from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .. import metrics, transform
from ..native import runtime as native
from ..device import resolve_device
from ..settings import ENCODER_DECODER_VERSION, EncodingResult, SpihtSettings
from ..torch_transform import (
    PLAN_HEAD,
    _batch_parts,
    _rows_of,
    compact_program,
    decode_batch,
    decode_program,
    encode_batch,
    encode_program,
    forward_program,
    inverse_program,
    narrow_program,
    plan_program,
)
from ..wavelets.geometry import get_slices_and_h_w, slices_to_wire
from ..ops.bitpack import bits_to_bytes, bytes_to_bits
from . import (
    decoder, device_decoder, device_encoder, encoder, meta_expand, oracle,
)
from .planning import cut_plane_np, plan_supported

__all__ = [
    "encode",
    "decode",
    "decode_with_metadata",
    "encode_image",
    "decode_image",
    "encode_images",
    "decode_images",
    "decode_rec_array",
    "decode_from_rec_arr",
    "encode_image_device",
    "decode_image_device",
    "encode_images_device",
    "decode_images_device",
    "get_slices_and_h_w",
]

_MAX_BITS = 2**31 - 2  # the most an int32 bit count holds
_MAX_BITS_DEFAULT = 99999999999999999  # the JAX API's "no budget"


def encode(
    arr: np.ndarray, ll_h: int, ll_w: int, max_bits: int = _MAX_BITS_DEFAULT,
    device=None, machine: Optional[str] = None,
) -> Tuple[bytes, int]:
    """SPIHT-encode a (C,H,W) int32 coefficient array -> (bytes, max_n),
    on the device: kernel B1, or B7 for ``machine="seq"``. A budget of 0
    or below is no budget, as in the native scheduler. With
    ``SPIHT_TPU_DEVICE_ENCODER=1`` and no ``machine``, an even-LL array
    goes through ``device_encoder.encode_device`` (module docstring)."""
    if (
        machine is None
        and os.environ.get("SPIHT_TPU_DEVICE_ENCODER") == "1"
        and ll_h % 2 == 0
        and ll_w % 2 == 0
    ):
        try:
            return device_encoder.encode_device(arr, ll_h, ll_w, max_bits,
                                                device)
        except device_encoder.CapacityOverflow:
            pass
    if int(max_bits) <= 0:
        # the native scheduler tests the budget only after a bit is
        # written (spiht_kernel.cpp:287, :449): 0 and below never cut
        max_bits = _MAX_BITS_DEFAULT
    return encoder.encode(arr, ll_h, ll_w, max_bits, device, machine)


def decode(
    data: bytes, n: int, c: int, h: int, w: int, ll_h: int, ll_w: int,
    device=None,
) -> np.ndarray:
    """Decode bytes -> (C,H,W) int32 coefficient array (prefix-tolerant),
    on the device: kernel B2, or B3 for odd-LL geometries. With
    ``SPIHT_TPU_DEVICE_DECODER=1`` it goes through
    ``device_decoder.decode_device`` first (module docstring)."""
    if os.environ.get("SPIHT_TPU_DEVICE_DECODER") == "1":
        try:
            return device_decoder.decode_device(data, n, c, h, w, ll_h, ll_w,
                                                device)
        except ValueError:
            pass
    return decoder.decode(data, n, c, h, w, ll_h, ll_w, device).cpu().numpy()


def decode_with_metadata(
    data: bytes,
    n: int,
    c: int,
    h: int,
    w: int,
    ll_h: int,
    ll_w: int,
    top_slice,
    other_slices,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode bytes and emit the per-bit decoder-state trace array, on the
    device (kernel B2-log, or B3-log for odd-LL geometries, then the log's
    expansion, as one cached program a key: ``torch_transform.
    trace_program``): (rec (C,H,W) int32, trace (len(data)*8 + 1, 8)
    int32), for every geometry the machines take (c*h*w < 2^29). With
    ``SPIHT_TPU_DEVICE_DECODER=1`` it runs
    ``device_decoder.decode_device_with_metadata``."""
    if os.environ.get("SPIHT_TPU_DEVICE_DECODER") == "1":
        return device_decoder.decode_device_with_metadata(
            data, n, c, h, w, ll_h, ll_w, top_slice, other_slices, device
        )
    return meta_expand.pallas_decode_with_metadata(
        data, n, c, h, w, ll_h, ll_w, top_slice, other_slices,
        resolve_device(device))


def _validate_image(image) -> None:
    if image.ndim != 3:
        raise ValueError("image ndim must be 3: c,h,w")
    if os.environ.get("SPIHT_TPU_VALIDATE") == "1":
        # NaN/Inf would silently corrupt quantization (NaN -> 0 via the
        # int cast, poisoning neighbouring DWT taps); opt-in, since the
        # check costs a full pass over the input
        finite = (bool(torch.isfinite(image).all())
                  if isinstance(image, torch.Tensor)
                  else bool(np.isfinite(image).all()))
        if not finite:
            raise ValueError("image contains NaN/Inf")


def encode_image(
    image,
    spiht_settings: SpihtSettings = SpihtSettings(),
    level: Optional[int] = None,
    max_bits: Optional[int] = None,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> EncodingResult:
    """DWT + quantize + SPIHT-encode a (C,H,W) image: ``transform.forward``
    under the backend (the torch transform on the device in the working
    ``dtype``, or the numpy or native one on the host), then ``encode``,
    kernel B1 on the device. Under 'torch' this is
    ``encode_image_device``'s pipeline."""
    dev = resolve_device(device)
    if not isinstance(image, torch.Tensor):
        image = np.asarray(image)
    _validate_image(image)
    c, h, w = image.shape
    arr, ll_h, ll_w = transform.forward(image, spiht_settings, level, dev,
                                        dtype)
    if max_bits is None:
        max_bits = _MAX_BITS_DEFAULT
    encoded_bytes, max_n = encode(arr, ll_h, ll_w, max_bits, dev)
    return EncodingResult(encoded_bytes, h, w, c, int(max_n), level)


def decode_rec_array(
    encoding_result: EncodingResult,
    spiht_settings: SpihtSettings,
    return_metadata: bool = False,
    device=None,
):
    """Decode to the packed coefficient array (reference CS2, first half):
    a dict of ``rec_arr`` (numpy int32), ``slices``, ``spiht_metadata``
    (the trace, or None), ``h``, ``w`` and ``level``."""
    if encoding_result._encoding_version != ENCODER_DECODER_VERSION:
        raise ValueError(encoding_result._encoding_version)
    h, w, c = encoding_result.h, encoding_result.w, encoding_result.c
    slices, enc_h, enc_w = get_slices_and_h_w(
        h, w, spiht_settings, encoding_result.level
    )
    ll_h, ll_w = slices[0][1].stop, slices[0][2].stop
    args = (encoding_result.encoded_bytes, encoding_result.max_n, c, enc_h,
            enc_w, ll_h, ll_w)
    if return_metadata:
        rec_arr, spiht_metadata = decode_with_metadata(
            *args, *slices_to_wire(slices), device=device
        )
    else:
        rec_arr, spiht_metadata = decode(*args, device=device), None
    return dict(
        rec_arr=rec_arr,
        slices=slices,
        spiht_metadata=spiht_metadata,
        h=h,
        w=w,
        level=encoding_result.level,
    )


def decode_from_rec_arr(
    rec_arr: np.ndarray,
    h: int,
    w: int,
    level,
    spiht_settings: SpihtSettings,
    slices=None,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> np.ndarray:
    """Un-quantize + inverse DWT + inverse colour (reference CS2, second
    half), as a numpy array: ``transform.inverse`` under the backend (the
    torch inverse on the device, or the numpy or native one on the
    host)."""
    dev = resolve_device(device)
    image = transform.inverse(rec_arr, h, w, level, spiht_settings, slices,
                              dev, dtype)
    if isinstance(image, torch.Tensor):
        image = image.cpu().numpy()
    return image


def decode_image(
    encoding_result: EncodingResult,
    spiht_settings: SpihtSettings,
    return_metadata: bool = False,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Decode an EncodingResult back to a (C,H,W) float image, with the
    metadata trace if ``return_metadata``."""
    d = decode_rec_array(encoding_result, spiht_settings, return_metadata,
                         device)
    spiht_metadata = d.pop("spiht_metadata", None)
    image = decode_from_rec_arr(
        **d, spiht_settings=spiht_settings, device=device, dtype=dtype
    )
    if return_metadata:
        return image, spiht_metadata
    return image


def _device_batch(ims, dev: torch.device) -> torch.Tensor:
    """One (B, C, H, W) tensor on ``dev`` of same-shape images (numpy or
    tensors), each copied straight in from pageable memory: no host-side
    stack of the batch. The eager upload that the programs' pinned
    staging replaced; ``chip_smoke.py`` times the eager paths with it."""
    ims = [
        im if isinstance(im, torch.Tensor)
        else torch.as_tensor(np.ascontiguousarray(im))
        for im in ims
    ]
    batch = torch.empty(
        (len(ims),) + tuple(ims[0].shape), device=dev,
        dtype=functools.reduce(torch.promote_types, (im.dtype for im in ims)),
    )
    for b, im in enumerate(ims):
        batch[b].copy_(im)
    return batch


def _ll(shape, settings, level):
    slices, _, _ = get_slices_and_h_w(shape[-2], shape[-1], settings, level)
    return slices[0][1].stop, slices[0][2].stop


def _encode_images_budget(images, groups, mb, settings, level, nat, dev,
                          dtype):
    """The budget-narrowed path of ``encode_images`` (api.py:277-348): the
    device plans each stream's cut plane from exact per-plane bit counts,
    then ships only the magnitude bits at or above it (int8 or int16),
    which the host shifts back and hands to the native scheduler with
    max_n forced to the full array's. Bits below the cut plane are never
    emitted within the budget, so the streams are the standard path's.
    Each group runs as equal parts (``_batch_parts``) through one plan
    program and one narrow program, the images staged through the plan
    program's pinned rows, the narrowing's input copied on the device
    from the plan's output, both under the plan program's lock. Returns
    None, and the standard path runs, for an odd-LL geometry or where the
    narrowed magnitudes pass int16."""
    results = [None] * len(images)
    for shape, idxs in groups.items():
        ll_h, ll_w = _ll(shape, settings, level)
        if not plan_supported(ll_h, ll_w):
            return None
        c = shape[0]
        # planes above the device's exact max(M) emit one all-zero test
        # per initial LIP/LIS entity
        n_ee = ((ll_h + 1) // 2) * ((ll_w + 1) // 2)
        n_init = c * ll_h * ll_w + c * (ll_h * ll_w - n_ee)
        rows, _, in_dtype = _rows_of([images[i] for i in idxs])
        m, parts = _batch_parts(len(rows), shape, dev)
        plan = plan_program(settings, (m,) + shape, level, dtype, in_dtype,
                            dev)
        arrs, max_ns = [], []
        for s, e in parts:
            k = e - s
            with plan.lock:
                plan.start(rows[s:e])
                arr_dev, head = plan.outputs
                head = head[:k].cpu().numpy()  # the one read of the plan
                mx, max_n_dev = head[:, 0], head[:, 1]
                mns = head[:, 2].astype(np.int32)
                counts = head[:, PLAN_HEAD:]
                shifts = np.zeros(m, dtype=np.int32)
                for bi in range(k):
                    i = idxs[len(arrs) + bi]
                    max_n = int(mns[bi])
                    ci = counts[bi].copy()
                    ci[max_n_dev[bi] + 1 : max_n + 1] = n_init
                    plane, _ = cut_plane_np(ci, max_n, int(mb[i]))
                    shifts[bi] = max(plane, 0)
                wmax = int(np.max(mx >> shifts[:k]))
                if wmax <= 127:
                    out_dtype = torch.int8
                elif wmax <= 32767:
                    out_dtype = torch.int16
                else:
                    plan._end()
                    return None  # narrowing doesn't pay; standard path
                nar = narrow_program(tuple(arr_dev.shape), out_dtype, dev)
                with nar.lock:
                    nar.start(arr_dev, shifts=shifts)
                    (hi,) = nar.host(k)
                plan._end()
            mag = np.abs(hi.astype(np.int32)) << shifts[:k, None, None, None]
            arrs.extend(np.where(hi >= 0, mag, -mag).astype(np.int32))
            max_ns.extend(mns)

        encoded = nat.encode_batch(
            arrs,
            [ll_h] * len(idxs),
            [ll_w] * len(idxs),
            [mb[i] for i in idxs],
            use_maps=True,
            forced_max_ns=np.asarray(max_ns, np.int32),
        )
        for bi, i in enumerate(idxs):
            ci_, h, w = images[i].shape
            results[i] = EncodingResult(
                encoded[bi][0], h, w, ci_, int(encoded[bi][1]), level
            )
    return results


def _compact_group(rows, shape, settings, level, dtype, dev) -> list:
    """The int32 coefficient arrays (numpy) of one shape's images: the
    int16-compacted transform (kernel B6 in the float32 working dtype) in
    equal parts (``_batch_parts``) through one ``compact_program``, the
    images staged through its pinned rows; a part whose coefficients pass
    int16 runs again through the ``forward_program`` of its shape (the
    full int32 transform)."""
    rows, _, in_dtype = _rows_of(rows)
    m, parts = _batch_parts(len(rows), shape, dev)
    prog = compact_program(settings, (m,) + shape, level, dtype, in_dtype,
                           dev)
    arrs = []
    for part in (rows[s:e] for s, e in parts):
        k = len(part)
        with prog.lock:
            prog.start(part)
            overflow = bool(prog.outputs[1])
            if not overflow:
                arrs.extend(prog.host(k)[0].astype(np.int32))
                continue
            prog._end()
        # rare: coefficients exceed int16; the full int32 transform
        fwd = forward_program(settings, (m,) + shape, level, dtype, False,
                              in_dtype, dev)
        with fwd.lock:
            fwd.start(part)
            arrs.extend(fwd.host(k)[0])
    return arrs


def encode_images(
    images,
    spiht_settings: SpihtSettings = SpihtSettings(),
    level: Optional[int] = None,
    max_bits=None,
    device=None,
    dtype: torch.dtype = torch.float64,
    backend: Optional[str] = None,
):
    """Batched encode: list of (C,H,W) float images -> list of
    EncodingResult, the host-scheduled throughput path; the serial bit
    scheduling runs in the native scheduler's threads. By backend
    (``backend``, for this call only, else ``transform.get_backend``):

    * 'torch': images are grouped by shape and each group's transform
      runs as one batch on the device. With every budget below 2^40, and
      unless ``SPIHT_TPU_BUDGET_TRANSFER=0``, the budget-narrowed path runs
      first; it hands back to the standard path (the int16-compacted
      transform, kernel B6 in the float32 working dtype, and the int32
      transform where a coefficient passes int16) only where the JAX
      package's does.
    * 'native': each image's native transform and scheduling run fused in
      a thread pool, with no barrier between the two stages.
    * 'numpy': each image's numpy transform, then one batch of the
      scheduler.

    Under ``SPIHT_TPU_NO_NATIVE`` the oracle schedules the bits, image by
    image; 'native' then transforms as 'numpy' does, and 'torch' skips the
    budget-narrowed path.

    ``max_bits``: None, a scalar applied to all, or a per-image sequence.
    """
    images = [np.asarray(im) for im in images]
    n = len(images)
    if max_bits is None:
        mb = [_MAX_BITS_DEFAULT] * n
    elif np.isscalar(max_bits):
        mb = [int(max_bits)] * n
    else:
        mb = [int(v) if v is not None else _MAX_BITS_DEFAULT for v in max_bits]
    if len(mb) != n:
        raise ValueError("max_bits sequence length != number of images")
    for im in images:
        _validate_image(im)
    for c, h, w in {im.shape for im in images}:
        slices, enc_h, enc_w = get_slices_and_h_w(h, w, spiht_settings,
                                                  level)
        encoder.check_geometry(c, enc_h, enc_w, slices[0][1].stop,
                               slices[0][2].stop)
    dev = resolve_device(device)
    nat = None if native.disabled() else native.load()
    backend = backend or transform.get_backend()

    if backend == "native" and nat is not None:
        def work(i):
            arr, ll_h, ll_w = transform.forward_native(
                images[i], spiht_settings, level
            )
            data, max_n = nat.encode(arr, ll_h, ll_w, mb[i])
            c, h, w = images[i].shape
            return EncodingResult(data, h, w, c, int(max_n), level)

        with ThreadPoolExecutor() as pool:
            return list(pool.map(work, range(n)))

    arrs = [None] * n
    lls = [None] * n
    if backend != "torch":  # 'numpy', or 'native' with the scheduler off
        fwd = (transform.forward_numpy if backend == "numpy"
               else transform.forward_native)
        for i, im in enumerate(images):
            arr, ll_h, ll_w = fwd(im, spiht_settings, level)
            arrs[i], lls[i] = arr, (ll_h, ll_w)
    else:
        groups = {}
        for idx, im in enumerate(images):
            groups.setdefault(im.shape, []).append(idx)
        if (nat is not None and all(m < 2**40 for m in mb)
                and os.environ.get("SPIHT_TPU_BUDGET_TRANSFER") != "0"):
            done = _encode_images_budget(
                images, groups, mb, spiht_settings, level, nat, dev, dtype
            )
            if done is not None:
                return done
        ll = {shape: _ll(shape, spiht_settings, level) for shape in groups}
        for shape, idxs in groups.items():
            arrs_g = _compact_group([images[i] for i in idxs], shape,
                                    spiht_settings, level, dtype, dev)
            for i, arr in zip(idxs, arrs_g):
                arrs[i], lls[i] = arr, ll[shape]

    if nat is None:
        encoded = [oracle.encode_bits(arrs[i], *lls[i], mb[i])
                   for i in range(n)]
        encoded = [(bits_to_bytes(bits), mn) for bits, mn in encoded]
    else:
        encoded = nat.encode_batch(
            arrs, [ll[0] for ll in lls], [ll[1] for ll in lls], mb,
            use_maps=True,
        )
    results = [None] * n
    for i, (data, max_n) in enumerate(encoded):
        c, h, w = images[i].shape
        results[i] = EncodingResult(data, h, w, c, int(max_n), level)
    return results


def decode_images(
    encoding_results,
    spiht_settings: SpihtSettings,
    device=None,
    dtype: torch.dtype = torch.float64,
):
    """Batched decode: list of EncodingResult -> list of (C,H,W) float
    images (numpy).

    Streams are decoded concurrently in the native scheduler's threads.
    Under the 'native' backend each stream's decode and native inverse run
    fused in a thread pool; under 'torch' the inverse transforms run as
    one batch on the device per (shape, h, w, level) group; under 'numpy'
    the numpy inverse runs image by image. Under ``SPIHT_TPU_NO_NATIVE``
    the oracle decodes the streams, and 'native' inverts as 'numpy'
    does.
    """
    n = len(encoding_results)
    geo = []
    for er in encoding_results:
        if er._encoding_version != ENCODER_DECODER_VERSION:
            raise ValueError(er._encoding_version)
        slices, enc_h, enc_w = get_slices_and_h_w(
            er.h, er.w, spiht_settings, er.level
        )
        geo.append((enc_h, enc_w, slices[0][1].stop, slices[0][2].stop))
        encoder.check_geometry(er.c, *geo[-1])
    dev = resolve_device(device)
    nat = None if native.disabled() else native.load()
    backend = transform.get_backend()
    if backend == "native" and nat is not None:
        def work(i):
            er = encoding_results[i]
            rec = nat.decode(er.encoded_bytes, er.max_n, er.c, *geo[i])
            return transform.inverse_native(
                rec, er.h, er.w, er.level, spiht_settings
            )

        with ThreadPoolExecutor() as pool:
            return list(pool.map(work, range(n)))
    if nat is None:
        recs = [
            oracle.decode_bits(bytes_to_bits(er.encoded_bytes), er.max_n,
                               er.c, *g)
            for er, g in zip(encoding_results, geo)
        ]
    else:
        recs = nat.decode_batch(
            [er.encoded_bytes for er in encoding_results],
            [er.max_n for er in encoding_results],
            [er.c for er in encoding_results],
            *([g[k] for g in geo] for k in range(4)),
        )
    if backend != "torch":  # 'numpy', or 'native' with the scheduler off
        inv = (transform.inverse_numpy if backend == "numpy"
               else transform.inverse_native)
        return [
            inv(rec, er.h, er.w, er.level, spiht_settings)
            for rec, er in zip(recs, encoding_results)
        ]
    groups = {}
    for i, er in enumerate(encoding_results):
        groups.setdefault((recs[i].shape, er.h, er.w, er.level), []).append(i)
    images = [None] * n
    for (shape, h, w, level), idxs in groups.items():
        # the recs staged through the inverse program's pinned rows, in
        # equal parts through one key
        rows, _, in_dtype = _rows_of([recs[i] for i in idxs])
        m, parts = _batch_parts(len(rows), (shape[0], h, w), dev)
        prog = inverse_program(spiht_settings, (m,) + tuple(shape), h, w,
                               level, dtype, False, in_dtype, dev)
        out = []
        for s, e in parts:
            with prog.lock:
                prog.start(rows[s:e])
                out.extend(prog.host(e - s)[0])
        for bi, i in enumerate(idxs):
            images[i] = out[bi]
    return images


def encode_image_device(
    image,
    spiht_settings: SpihtSettings = SpihtSettings(),
    level: Optional[int] = None,
    max_bits: Optional[int] = None,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> EncodingResult:
    """Encode a (C, H, W) image (numpy or tensor) on the device: colour ->
    DWT -> quantize -> max_n -> SPIHT bit emission (kernel B1), as one
    cached program a key (``torch_transform.encode_program``: on the card
    a CUDA graph, as the JAX package runs one XLA program). Only the
    finished stream comes back to the host. The call is the span
    ``spiht/api/encode_image_device`` (``metrics.span``)."""
    with metrics.span("spiht/api/encode_image_device", images=1):
        dev = resolve_device(device)
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.ascontiguousarray(image))
        if image.dim() != 3:
            raise ValueError("image ndim must be 3: c,h,w")
        c, h, w = image.shape
        # the program clamps the budget to what an int32 bit count holds
        mb = _MAX_BITS if max_bits is None else max_bits
        prog = encode_program(spiht_settings, image.shape, level, dtype,
                              image.dtype, dev, mb)
        data, _, max_n = prog(image, mb)
        return EncodingResult(data, h, w, c, max_n, level)


def decode_image_device(
    encoding_result: EncodingResult,
    spiht_settings: SpihtSettings,
    as_uint8: bool = False,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> torch.Tensor:
    """Decode an EncodingResult on the device: bit parse (kernel B2 and the
    rec scatter, or B3 for odd-LL geometries) -> dequantize -> inverse DWT
    -> inverse colour, as one cached program a key
    (``torch_transform.decode_program``). Returns the image as a fresh
    tensor on the device. The call is the span
    ``spiht/api/decode_image_device``."""
    with metrics.span("spiht/api/decode_image_device", images=1):
        if encoding_result._encoding_version != ENCODER_DECODER_VERSION:
            raise ValueError(encoding_result._encoding_version)
        dev = resolve_device(device)
        h, w, c = encoding_result.h, encoding_result.w, encoding_result.c
        data = encoding_result.encoded_bytes
        prog = decode_program(spiht_settings, h, w, encoding_result.level, c,
                              dtype, as_uint8, dev, len(data) * 8)
        return prog(data, len(data) * 8, int(encoding_result.max_n))


def _budgets(max_bits, n: int) -> list:
    """Per-image budgets from None, one number, or a list of n."""
    if max_bits is None:
        return [_MAX_BITS] * n
    if np.ndim(max_bits) == 0:
        return [int(max_bits)] * n
    mbs = [int(m) for m in max_bits]
    if len(mbs) != n:
        raise ValueError(f"max_bits has {len(mbs)} budgets for {n} images")
    return mbs


def encode_images_device(
    images,
    spiht_settings: SpihtSettings = SpihtSettings(),
    level: Optional[int] = None,
    max_bits=None,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> list:
    """Encode a list of (C, H, W) images (numpy or tensors) on the device.

    A batch of one shape is one pipeline, run as cached programs a key
    (``torch_transform.encode_batch``: on the card CUDA graphs, as the JAX
    package runs one jitted program; at most ``batch_bound`` images a
    program): the batched transform and per-image max_n, then kernel B4
    encodes every stream in one launch. ``max_bits`` is None (full
    streams), one budget, or one per image; a negative budget is 0, as in
    the JAX package. Images of mixed shapes go one by one through
    ``encode_image_device``. Every stream is encoded on the card (odd LL
    and max_n > 15 included) and equals the JAX API's; results come back
    in input order. The call is the span ``spiht/api/encode_images_device``
    (count ``images``).
    """
    images = list(images)
    with metrics.span("spiht/api/encode_images_device", images=len(images)):
        ims = [
            im if isinstance(im, torch.Tensor)
            else torch.as_tensor(np.ascontiguousarray(im))
            for im in images
        ]
        if not ims:
            return []
        mbs = _budgets(max_bits, len(ims))
        dev = resolve_device(device)
        if any(im.dim() != 3 for im in ims):
            raise ValueError("image ndim must be 3: c,h,w")
        if len({tuple(im.shape) for im in ims}) != 1:
            return [
                encode_image_device(im, spiht_settings, level, mb, dev, dtype)
                for im, mb in zip(ims, mbs)
            ]
        c, h, w = ims[0].shape
        return [
            EncodingResult(data, h, w, c, int(mn), level)
            for data, mn in encode_batch(spiht_settings, ims, mbs, level,
                                         dtype, dev)
        ]


def decode_images_device(
    encoding_results,
    spiht_settings: SpihtSettings,
    as_uint8: bool = False,
    device=None,
    dtype: torch.dtype = torch.float64,
) -> list:
    """Decode a list of EncodingResults on the device; returns a list of
    image tensors on the device, in input order.

    Streams of one (h, w, c, level) are one pipeline, run as cached
    programs a key (``torch_transform.decode_batch``): kernel B5 and one
    rec scatter (batched B3 for odd-LL geometries) decode every stream in
    one launch, each on its own length, then the batched inverse
    transform. Mixed geometries go one by one through
    ``decode_image_device``. The call is the span
    ``spiht/api/decode_images_device`` (count ``images``).
    """
    ers = list(encoding_results)
    with metrics.span("spiht/api/decode_images_device", images=len(ers)):
        if not ers:
            return []
        if len({(er.h, er.w, er.c, er.level) for er in ers}) != 1:
            return [
                decode_image_device(er, spiht_settings, as_uint8, device,
                                    dtype)
                for er in ers
            ]
        for er in ers:
            if er._encoding_version != ENCODER_DECODER_VERSION:
                raise ValueError(er._encoding_version)
        dev = resolve_device(device)
        er0 = ers[0]
        images = decode_batch(
            spiht_settings, er0.h, er0.w, er0.level, er0.c,
            [er.encoded_bytes for er in ers],
            [len(er.encoded_bytes) * 8 for er in ers],
            [int(er.max_n) for er in ers], dtype, as_uint8, dev)
        return list(images.unbind(0))
