"""One image a request: ``encode_image_device``, then
``decode_image_device`` on its stream (single-image programs: B1, and B2
or B3)."""

from __future__ import annotations

import torch

DIRECTIONS = ("enc_single", "dec_single")
API = {"enc_single": "encode_image_device",
       "dec_single": "decode_image_device"}


class Entry:
    def __init__(self, settings, level, dev, dtype):
        import spiht_tpu_torch

        self.sut = spiht_tpu_torch
        self.settings, self.level, self.dev, self.dtype = (
            settings, level, dev, dtype)

    def encode(self, images: list, budgets: list) -> list:
        if len(images) != 1:
            raise ValueError("the single entry takes one image a request")
        return [self.sut.encode_image_device(
            images[0], self.settings, self.level, budgets[0], self.dev,
            self.dtype)]

    def decode(self, results: list) -> list:
        out = [self.sut.decode_image_device(
            results[0], self.settings, device=self.dev, dtype=self.dtype)]
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return out

    def stage_s(self):
        return None
