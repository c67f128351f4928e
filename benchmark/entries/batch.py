"""A batch of images a request: ``encode_images_device`` with a budget an
image, then ``decode_images_device`` on the streams (the batch programs:
pinned staging, B4, and B5 or the batched B3)."""

from __future__ import annotations

import torch

DIRECTIONS = ("enc_batch", "dec_batch")
API = {"enc_batch": "encode_images_device",
       "dec_batch": "decode_images_device"}


class Entry:
    def __init__(self, settings, level, dev, dtype):
        import spiht_tpu_torch

        self.sut = spiht_tpu_torch
        self.settings, self.level, self.dev, self.dtype = (
            settings, level, dev, dtype)

    def encode(self, images: list, budgets: list) -> list:
        return self.sut.encode_images_device(
            images, self.settings, self.level, budgets, self.dev, self.dtype)

    def decode(self, results: list) -> list:
        out = self.sut.decode_images_device(
            results, self.settings, device=self.dev, dtype=self.dtype)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return out

    def stage_s(self):
        """The batch encode program's ``_Program.stage_s``: its last host
        copy of the images into its pinned buffer."""
        from spiht_tpu_torch import torch_transform

        progs = [p for p in torch_transform.programs()
                 if type(p).__name__ == "EncodeBatchProgram"]
        return progs[-1].stage_s if progs else None
