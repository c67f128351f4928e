"""Failure detection + elastic recovery (spiht_tpu_torch.parallel.health):
every case of tests/test_health.py with torch's errors, the device-error
table against the JAX package's, and the degraded route's warning.

Faults are injected (hung probes, raising encode paths) — the same
control flow that fires on a real ``torch.AcceleratorError`` / deadline
expiry."""

import json
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from spiht_tpu.parallel import health as jhealth

from spiht_tpu_torch import SpihtSettings
from spiht_tpu_torch.codec import api
from spiht_tpu_torch.parallel import health


def _images(n=5, c=3, h=32, w=32):
    rng = np.random.default_rng(0)
    return [np.clip(rng.random((c, h, w)), 0, 1) for _ in range(n)]


def _encode_cpu(imgs, s, **kw):
    return api.encode_images(imgs, s, device="cpu", **kw)


def test_probe_cpu_devices_healthy():
    res = health.probe_devices([torch.device("cpu")] * 8, timeout_s=60.0)
    assert len(res) == 8 and all(h.ok for h in res)
    assert all(h.latency_s >= 0 for h in res)


def test_probe_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        health.probe_devices()


def test_probe_detects_hang_via_deadline():
    def hang(device):
        time.sleep(1.0)

    res = health.probe_devices(devices=["d0"], timeout_s=0.1, probe_fn=hang)
    assert len(res) == 1 and not res[0].ok
    assert "deadline" in res[0].error


def test_probe_reports_device_error():
    def boom(device):
        raise torch.AcceleratorError("CUDA error: unspecified launch failure")

    res = health.probe_devices(devices=["d0"], timeout_s=5, probe_fn=boom)
    assert not res[0].ok and "AcceleratorError" in res[0].error


def test_healthy_devices_filters():
    def flaky(device):
        if device == "bad":
            raise RuntimeError("dead")

    devs = health.healthy_devices(["good", "bad"], timeout_s=5,
                                  probe_fn=flaky)
    assert devs == ["good"]


# (error, is a device error): the torch column of _is_device_error's
# table, and the bare RuntimeErrors both packages classify alike
DEVICE_ERRORS = [
    (torch.AcceleratorError("CUDA error: an illegal memory access"), True),
    (torch.OutOfMemoryError("CUDA out of memory"), True),
    (dist.DistBackendError("NCCL communicator was aborted"), True),
    (RuntimeError("CUDA error: device-side assert triggered"), True),
    (RuntimeError("UNAVAILABLE: xla runtime wedged"), True),
    (RuntimeError("DEVICE_UNAVAILABLE"), True),
    (RuntimeError("INTERNAL: stream did not block host"), True),
    (RuntimeError("dict changed size during iteration"), False),
    (ValueError("UNAVAILABLE shape bug"), False),
    (TypeError("bad argument"), False),
]


@pytest.mark.parametrize("exc,want", DEVICE_ERRORS,
                         ids=[f"{type(e).__name__}-{i}"
                              for i, (e, _) in enumerate(DEVICE_ERRORS)])
def test_is_device_error_table(exc, want):
    assert health._is_device_error(exc) is want
    if type(exc) in (RuntimeError, ValueError, TypeError) and (
            "CUDA error" not in str(exc)):
        # the JAX package classifies the bare errors alike
        assert jhealth._is_device_error(exc) is want


def test_failover_retries_device_errors_then_succeeds():
    calls = {"n": 0}
    retried = []

    def step():
        calls["n"] += 1
        if calls["n"] < 3:
            raise torch.AcceleratorError("CUDA error: launch timed out")
        return "ok"

    out = health.run_with_failover(
        step, retries=3, backoff_s=0.0,
        on_retry=lambda a, e: retried.append(a),
    )
    assert out == "ok" and calls["n"] == 3 and retried == [1, 2]


def test_failover_does_not_retry_program_bugs():
    calls = {"n": 0}

    def step():
        calls["n"] += 1
        raise ValueError("shape bug")

    with pytest.raises(ValueError):
        health.run_with_failover(step, retries=5, backoff_s=0.0)
    assert calls["n"] == 1


def test_failover_does_not_retry_bare_runtime_error():
    """A bare RuntimeError without a client-death message is a program
    bug, not a wedged device — it must propagate on the first attempt."""
    calls = {"n": 0}

    def step():
        calls["n"] += 1
        raise RuntimeError("dict changed size during iteration")

    with pytest.raises(RuntimeError):
        health.run_with_failover(step, retries=5, backoff_s=0.0)
    assert calls["n"] == 1


def test_failover_exhausts_retries():
    def step():
        raise torch.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(torch.OutOfMemoryError):
        health.run_with_failover(step, retries=2, backoff_s=0.0)


def test_robust_encode_completes_and_checkpoints(tmp_path):
    images = _images(5)
    settings = SpihtSettings()
    manifest = str(tmp_path / "m.json")
    out = health.robust_encode_images(
        images, settings, level=3, max_bits=2000, chunk=2,
        manifest_path=manifest, encode_fn=_encode_cpu,
    )
    assert sorted(out.keys()) == [0, 1, 2, 3, 4]
    want = api.encode_images(images, settings, level=3, max_bits=2000,
                             device="cpu")
    assert [out[i].encoded_bytes for i in range(5)] == [
        e.encoded_bytes for e in want]

    # manifest is a complete checkpoint: a rerun never re-encodes
    def poisoned(*a, **k):
        raise AssertionError("should not re-encode completed ids")

    again = health.robust_encode_images(
        images, settings, level=3, max_bits=2000, chunk=2,
        manifest_path=manifest, encode_fn=poisoned,
    )
    assert {k: v.encoded_bytes for k, v in again.items()} == {
        k: v.encoded_bytes for k, v in out.items()
    }


def test_robust_encode_resumes_after_mid_job_crash(tmp_path):
    images = _images(6)
    settings = SpihtSettings()
    manifest = str(tmp_path / "m.json")
    calls = {"n": 0}

    def crashy(imgs, s, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt  # simulated job kill on chunk 2
        return _encode_cpu(imgs, s, **kw)

    with pytest.raises(KeyboardInterrupt):
        health.robust_encode_images(
            images, settings, level=3, max_bits=2000, chunk=2,
            manifest_path=manifest, encode_fn=crashy, retries=0,
        )
    # chunk 1 survived in the manifest; resume finishes the rest
    out = health.robust_encode_images(
        images, settings, level=3, max_bits=2000, chunk=2,
        manifest_path=manifest, encode_fn=_encode_cpu,
    )
    want = _encode_cpu(images, settings, level=3, max_bits=2000)
    assert all(out[i].encoded_bytes == want[i].encoded_bytes
               for i in range(6))


def test_robust_encode_degrades_to_host_with_a_warning(tmp_path):
    """The chunk whose device path keeps failing is encoded on the host,
    with a warning, in the result's ``degraded`` and marked in the
    manifest (which the JAX package still reads); the module-wide backend
    is left alone, and a resumed call reports the same ids."""
    from spiht_tpu.parallel.distributed import load_manifest as jload

    from spiht_tpu_torch import transform

    images = _images(4)
    settings = SpihtSettings()
    manifest = tmp_path / "m.json"
    backend = transform._BACKEND

    def second_chunk_dead(imgs, s, **kw):
        if imgs[0] is images[2]:
            assert transform._BACKEND == backend
            raise torch.AcceleratorError(
                "CUDA error: unspecified launch failure")
        return _encode_cpu(imgs, s, **kw)

    with pytest.warns(RuntimeWarning, match=r"ids \[2, 3\] on the host"):
        out = health.robust_encode_images(
            images, settings, level=3, max_bits=2000, chunk=2,
            manifest_path=str(manifest), encode_fn=second_chunk_dead,
            retries=1,
        )
    assert transform._BACKEND == backend
    want = _encode_cpu(images, settings, level=3, max_bits=2000)
    assert all(out[i].encoded_bytes == want[i].encoded_bytes
               for i in range(4))
    assert out.degraded == [2, 3]
    records = json.loads(manifest.read_text())
    assert [r.get("degraded", False) for r in records] == [False, False,
                                                           True, True]
    assert {k: v.encoded_bytes for k, v in jload(manifest.read_text()).items()
            } == {i: want[i].encoded_bytes for i in range(4)}

    def poisoned(*a, **k):
        raise AssertionError("should not re-encode completed ids")

    again = health.robust_encode_images(
        images, settings, level=3, max_bits=2000, chunk=2,
        manifest_path=str(manifest), encode_fn=poisoned,
    )
    assert again.degraded == [2, 3] and dict(again) == dict(out)


def test_robust_encode_propagates_program_bugs():
    def buggy(imgs, s, **kw):
        raise TypeError("bad argument")

    with pytest.raises(TypeError):
        health.robust_encode_images(_images(2), SpihtSettings(),
                                    encode_fn=buggy, retries=3)
