"""On-device consumption of the SPIHT metadata event log, the port of
``examples/metadata_ml_consumer.py``.

The reference's `decode_with_metadata` exists so ML models can consume
SPIHT streams as supervised token sequences
(src/encoder_decoder.rs:616-630). Here the whole flow stays on the card:

    stream bytes --h2d (tiny)--> kernel B2-log (B3-log at odd LL) + the
        COMPACT event log --> featurization / expansion on the device
        --> model

The compact log is one 64-bit word per stream bit (4x smaller than the
expanded 8-column int32 trace), and `expand_event_log` reconstructs the
full reference trace on the device when a consumer wants the reference
layout — nothing large ever crosses the host link. The trace is then
held row for row against the native scheduler's on the host.

    python -m spiht_tpu_torch.examples.metadata_ml_consumer [--device DEV]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import SpihtSettings, encode_image
from ..codec.meta_expand import decode_event_log, expand_event_log
from ..device import resolve_device
from ..native import runtime as native
from ..wavelets.geometry import get_slices_and_h_w, slices_to_wire

ACTIONS = ["lip_sig", "lip_sign", "lisA_desc", "lisA_child_sig",
           "lisA_child_sign", "lisB_lsig", "refine"]


def featurize(log: torch.Tensor, words: torch.Tensor, nbits: int):
    """Per-action token counts, one-bits and the mean significance plane of
    the written events, on the log's device — the kind of summary a
    conditioning model ingests. ``log[t]`` is ``node | action << 32 |
    (n+1) << 35 | ...`` (0 = no event)."""
    t = torch.arange(log.shape[0], dtype=torch.int64, device=log.device)
    written = (log != 0) & (t < nbits)
    action = (log >> 32) & 7
    plane = ((log >> 35) & 31) - 1
    wi = words.to(torch.int64) & 0xFFFFFFFF
    bit = (wi[(t >> 5).clamp(max=words.numel() - 1)] >> (t & 31)) & 1
    counts = torch.zeros(len(ACTIONS), dtype=torch.int64,
                         device=log.device).index_add_(
        0, torch.where(written, action, 0), written.to(torch.int64))
    ones = (written & (bit == 1)).sum()
    mean_plane = torch.where(written, plane, 0).sum() / torch.clamp(
        written.sum(), min=1)
    return counts, ones, mean_plane


def main(argv=None) -> None:
    """Raises SystemExit("MISMATCH") if the device's trace or rec differs
    from the host's."""
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0].replace("\n", " "))
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    # --- encode one image ---------------------------------------------
    rng = np.random.default_rng(3)
    h_in = w_in = 128
    yy, xx = np.mgrid[0:h_in, 0:w_in] / 32.0
    im = np.stack(
        [0.5 + 0.3 * np.sin(xx + k) * np.cos(yy) for k in range(3)]
    )
    im = np.clip(im + 0.05 * rng.standard_normal(im.shape), 0, 1)
    settings = SpihtSettings()
    level = 4
    er = encode_image(im, settings, level=level, max_bits=h_in * w_in,
                      device=dev)
    slices, eh, ew = get_slices_and_h_w(er.h, er.w, settings, level)
    ll_h = slices[0][1].stop
    ll_w = slices[0][2].stop

    # --- decode + compact event log, all on the device ----------------
    rec, log, words, nbits = decode_event_log(
        er.encoded_bytes, er.max_n, er.c, eh, ew, ll_h, ll_w, dev,
    )
    print(f"stream bits={nbits}  compact log={log.nbytes / 1e3:.0f} KB "
          f"(expanded trace would be {(nbits + 1) * 8 * 4 / 1e3:.0f} KB)")

    # --- an ML consumer: featurize the token sequence ON DEVICE -------
    counts, ones, mean_plane = featurize(log, words, nbits)
    print("on-device token counts:",
          {n: int(v) for n, v in zip(ACTIONS, counts.tolist())})
    print(f"one-bits={int(ones)}  mean plane={float(mean_plane):.2f}")

    # --- reference 8-column trace, expanded on the device -------------
    top_slice, other_slices = slices_to_wire(slices)
    meta = expand_event_log(
        log, words, nbits, er.c, eh, ew, ll_h, ll_w,
        top_slice, other_slices,
    )
    print(f"expanded trace shape={tuple(meta.shape)} (still on "
          f"{meta.device})")
    # equality with the host's native scheduler
    rec2, meta_host = native.load().decode_with_metadata(
        er.encoded_bytes, er.max_n, er.c, eh, ew, ll_h, ll_w,
        top_slice, other_slices,
    )
    same = np.array_equal(meta.cpu().numpy(), meta_host)
    rec_same = np.array_equal(rec.cpu().numpy(), rec2)
    print(f"row-exact vs host metadata decoder: {same}; rec exact: "
          f"{rec_same}")
    if not (same and rec_same):
        raise SystemExit("MISMATCH")


if __name__ == "__main__":
    main()
