"""The comparison that decides ``correct``.

A run keeps a sample of the answers its window produced, drawn from the
seed over every answer of the window (``Sample``), and every answer of
its last round (each image of its last batch). Once the window has
closed, the plain reference (``benchmark/reference/``) recomputes each
kept answer from the image that was sent: the coefficients, the stream
at that answer's budget, and the image a decoder of that stream holds.

* ``enc_streams_off``: kept encode answers whose stream bytes or max_n
  differ from the reference's. An exact comparison: limit 0.
* ``dec_max_err``: the largest |program - reference| over the pixels of
  the kept decode answers, each the decode of the stream the window's
  own encode produced. Its limit is the configuration's
  (``limits.dec_max_err``), set between the program's readings and the
  float32 control's.
* ``failed_calls``: calls of the window that raised. Limit 0.
"""

from __future__ import annotations

import random

import torch

from .reference import spiht
from .reference import transform as ref


class Sample:
    """A uniform sample of ``k`` of the answers offered, drawn from
    ``seed`` (reservoir sampling): each kept answer is (image index,
    budget in bits, stream bytes, max_n, decoded image)."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.kept = int(k), 0, []
        self._rng = random.Random(int(seed))

    def offer(self, make):
        """Count one answer; keep ``make()`` if the draw takes it."""
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(make())
            return
        j = self._rng.randrange(self.seen)
        if j < self.k:
            self.kept[j] = make()


def reference_answer(image, cfg: dict, max_bits: int, device):
    """(stream bytes, max_n, decoded image) of the plain reference, for
    a configuration ``cfg``."""
    cfg = dict(cfg["settings"], level=cfg.get("level"))
    x = torch.as_tensor(image).to(device)
    arr = ref.forward(x, cfg)
    h, w = x.shape[-2:]
    ll_h, ll_w = ref.ll_size(h, w, cfg.get("level"))
    data, _, max_n, rec = spiht.encode(arr, ll_h, ll_w, max_bits)
    return data, max_n, ref.inverse(rec, cfg, h, w)


def compare(answers: list, pool: list, cfg: dict, failed: int,
            device) -> dict:
    """The compared numbers, each with its limit, over ``answers`` (as
    ``Sample`` keeps them)."""
    refs, off, err = {}, 0, 0.0
    for idx, max_bits, data, max_n, image in answers:
        if (idx, max_bits) not in refs:
            refs[idx, max_bits] = reference_answer(pool[idx], cfg, max_bits,
                                                   device)
        r_data, r_max_n, r_image = refs[idx, max_bits]
        off += int(data != r_data or int(max_n) != r_max_n)
        got = image.to(device=device, dtype=torch.float64)
        if got.shape != r_image.shape:
            err = float("inf")
            continue
        diff = torch.nan_to_num((got - r_image).abs(), nan=float("inf"))
        err = max(err, float(diff.max()))
    if not answers:  # no answer came: nothing is shown right
        off = err = float("inf")
    limits = cfg["limits"]
    return {
        "failed_calls": {"value": int(failed), "limit": 0},
        "enc_streams_off": {"value": off, "limit": 0},
        "dec_max_err": {"value": err, "limit": float(limits["dec_max_err"])},
    }


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
