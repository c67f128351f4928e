"""Failure detection + elastic recovery for long encoding jobs, the port
of ``spiht_tpu/parallel/health.py``.

Three small, composable pieces on the failure surface PyTorch exposes:

 * `probe_devices` — liveness/latency probe: one tiny addition is
   dispatched to each device with a deadline; a device that cannot
   return a scalar within it (a wedged runtime, a lost card) is reported
   unhealthy instead of hanging the job.
 * `run_with_failover` — retry harness around a step callable that
   treats accelerator runtime errors as recoverable events: re-probe,
   rebuild state via the caller's `on_retry`, run again.
 * `robust_encode_images` — the user-facing tie-in: chunked batch
   encoding that checkpoints an `encode_manifest` after every chunk,
   resumes from a previous manifest (id-keyed, idempotent), and, when
   the device path keeps failing, finishes the chunk on the host with a
   warning — the job completes degraded rather than dying, and the
   result and the manifest name the ids it encoded so.

Exercised with injected faults (tests/test_torch_health.py); on a card
the same paths fire on ``torch.AcceleratorError`` / deadline expiry.
"""

from __future__ import annotations

import concurrent.futures as _futures
import dataclasses
import json
import time
import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..device import cuda_devices

__all__ = [
    "DeviceHealth",
    "probe_devices",
    "healthy_devices",
    "run_with_failover",
    "robust_encode_images",
    "RobustEncodeResult",
]


@dataclasses.dataclass
class DeviceHealth:
    device: object
    ok: bool
    latency_s: float
    error: Optional[str] = None


def _default_probe(device) -> float:
    """Dispatch a trivial computation to `device`, return its result."""
    x = torch.ones((), dtype=torch.float32, device=device)
    return float(x + 1.0)


def probe_devices(
    devices: Optional[Sequence] = None,
    timeout_s: float = 30.0,
    probe_fn: Callable = _default_probe,
) -> List[DeviceHealth]:
    """Liveness-probe each device (default: every CUDA device; raises
    without one) with a hard deadline.

    Probes run in a thread pool so one wedged device cannot stall the
    check for the others; a probe that misses the deadline marks its
    device unhealthy (the thread is abandoned — there is no portable way
    to cancel a stuck call, but the caller's control flow stays live).
    """
    devs = cuda_devices() if devices is None else list(devices)
    out: List[DeviceHealth] = []
    # No `with` block: ThreadPoolExecutor.__exit__ calls shutdown(wait=True),
    # which would JOIN a wedged probe thread and void the deadline — the
    # exact hang this function exists to contain. One shared deadline via
    # futures.wait (not per-future result(timeout=...), which compounds to
    # k*timeout for k wedged devices); stuck threads are then abandoned
    # with shutdown(wait=False).
    ex = _futures.ThreadPoolExecutor(max_workers=max(len(devs), 1))
    try:
        futs = {ex.submit(_timed, probe_fn, d): d for d in devs}
        done, _ = _futures.wait(futs, timeout=timeout_s)
        for fut, d in futs.items():
            if fut not in done:
                out.append(
                    DeviceHealth(
                        d, False, timeout_s,
                        f"probe exceeded {timeout_s}s deadline",
                    )
                )
                continue
            try:
                out.append(DeviceHealth(d, True, fut.result()))
            except Exception as e:  # runtime error from the device
                out.append(
                    DeviceHealth(d, False, 0.0, f"{type(e).__name__}: {e}")
                )
    finally:
        ex.shutdown(wait=False)
    return out


def _timed(probe_fn, device) -> float:
    t0 = time.perf_counter()
    probe_fn(device)
    return time.perf_counter() - t0


def healthy_devices(
    devices: Optional[Sequence] = None,
    timeout_s: float = 30.0,
    probe_fn: Callable = _default_probe,
) -> List:
    """The subset of devices that pass `probe_devices` — the pool an
    elastic re-mesh should be built from after a failure."""
    return [h.device for h in probe_devices(devices, timeout_s, probe_fn)
            if h.ok]


# Message fragments of the bare RuntimeErrors of dead/wedged clients. A
# bare RuntimeError WITHOUT one of these is a program bug and must
# propagate, not be retried/degraded.
_RUNTIME_ERROR_PATTERNS = (
    "DEVICE_UNAVAILABLE",
    "UNAVAILABLE",
    "dead client",
    "client is dead",
    "device error",
    "DEADLINE_EXCEEDED",
    "INTERNAL: ",
    "CUDA error",
)


def _is_device_error(exc: BaseException) -> bool:
    """Accelerator runtime failures worth retrying (vs. program bugs).

    ====================================  =================================
    JAX package                           here
    ====================================  =================================
    ``XlaRuntimeError``,                  ``torch.AcceleratorError`` (a
    ``JaxRuntimeError``                   CUDA error at a launch or sync)
    the same, ``RESOURCE_EXHAUSTED``      ``torch.OutOfMemoryError``
    the same, a collective's failure      ``torch.distributed.
                                          DistBackendError`` (NCCL, gloo)
    bare ``RuntimeError`` whose message   the same patterns, and
    has a ``_RUNTIME_ERROR_PATTERNS``     "CUDA error" (older torch raises
    fragment                              CUDA errors as RuntimeError)
    ====================================  =================================

    A *bare* RuntimeError only counts when its message matches — otherwise
    retrying would mask real defects as 'device wedged'. ValueError /
    TypeError (shape bugs) are never retried.
    """
    import torch.distributed as dist

    kinds = (torch.AcceleratorError, torch.OutOfMemoryError)
    if dist.is_available():
        kinds += (dist.DistBackendError,)
    if isinstance(exc, kinds):
        return True
    if isinstance(exc, RuntimeError):
        msg = str(exc)
        return any(pat in msg for pat in _RUNTIME_ERROR_PATTERNS)
    return False


def run_with_failover(
    fn: Callable,
    *args,
    retries: int = 2,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    backoff_s: float = 1.0,
    **kwargs,
):
    """Run `fn(*args, **kwargs)`, retrying accelerator runtime failures.

    Between attempts the caller's `on_retry(attempt, exc)` runs — the
    hook for re-probing devices, rebuilding a mesh from the healthy
    subset, and re-sharding inputs. Non-device exceptions propagate
    immediately; the last device error propagates after `retries`
    exhausted.
    """
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except BaseException as exc:  # noqa: BLE001 — filtered below
            if not _is_device_error(exc) or attempt >= retries:
                raise
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, exc)
            time.sleep(backoff_s * attempt)


class RobustEncodeResult(dict):
    """id -> EncodingResult, as the JAX package's `robust_encode_images`
    returns, and ``degraded``: the ids encoded on the host after device
    errors, in this call or (read from the manifest) an earlier one."""

    def __init__(self, results=(), degraded=()):
        super().__init__(results)
        self.degraded = list(degraded)


def robust_encode_images(
    images: Sequence[np.ndarray],
    settings,
    *,
    ids: Optional[Sequence] = None,
    level: Optional[int] = None,
    max_bits: Optional[int] = None,
    chunk: int = 16,
    manifest_path: Optional[str] = None,
    retries: int = 2,
    encode_fn: Optional[Callable] = None,
) -> RobustEncodeResult:
    """Chunked, checkpointed, failure-tolerant batch encode.

    id -> EncodingResult for every image. After each chunk the manifest
    at `manifest_path` is rewritten (atomic rename), so a killed job
    resumes by re-running the same call: already-encoded ids are loaded,
    not re-encoded. A chunk that keeps failing with device errors after
    `retries` attempts is re-run on the host — the 'native' transform
    backend and the native scheduler, ``device="cpu"`` — with a warning
    that names its ids, so the job completes without the card and says
    so: those ids are also listed in the result's ``degraded`` and marked
    ``"degraded": true`` in the manifest (whose readers, the JAX
    package's too, ignore the mark). The streams are the same (float64 on
    both routes).

    `encode_fn(images, settings, level=, max_bits=)` defaults to
    `codec.api.encode_images`; injectable for tests and custom paths.
    """
    import os

    from ..codec import api as _api
    from .distributed import encode_manifest, load_manifest

    if ids is None:
        ids = list(range(len(images)))
    if len(ids) != len(images):
        raise ValueError("ids and images length mismatch")
    enc = encode_fn or _api.encode_images

    done = RobustEncodeResult()
    if manifest_path and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            text = f.read()
        done.update(load_manifest(text))
        done.degraded += [r["id"] for r in json.loads(text)
                          if r.get("degraded")]

    todo = [(i, im) for i, im in zip(ids, images) if i not in done]
    kw = {}
    if level is not None:
        kw["level"] = level
    if max_bits is not None:
        kw["max_bits"] = max_bits

    def _checkpoint():
        if not manifest_path:
            return
        keys = list(done.keys())
        records = json.loads(encode_manifest(keys, [done[k] for k in keys]))
        for k, rec in zip(keys, records):
            if k in done.degraded:
                rec["degraded"] = True
        tmp = f"{manifest_path}.tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(records))
        os.replace(tmp, manifest_path)

    for lo in range(0, len(todo), chunk):
        part = todo[lo:lo + chunk]
        part_imgs = [im for _, im in part]
        try:
            results = run_with_failover(
                enc, part_imgs, settings, retries=retries, **kw
            )
        except BaseException as exc:  # noqa: BLE001
            if not _is_device_error(exc):
                raise
            warnings.warn(
                f"device path failed after {retries} retries "
                f"({type(exc).__name__}: {exc}); encoding ids "
                f"{[i for i, _ in part]} on the host (native backend, CPU)",
                RuntimeWarning, stacklevel=2,
            )
            results = _api.encode_images(part_imgs, settings, device="cpu",
                                         backend="native", **kw)
            done.degraded += [i for i, _ in part]
        for (i, _), er in zip(part, results):
            done[i] = er
        _checkpoint()
    return done
