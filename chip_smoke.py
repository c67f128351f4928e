"""Chip smoke test of the PyTorch/CUDA port (spiht_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the kernels from spiht_tpu_torch/csrc with nvcc, holds each one
against its plain version on the card, drives the port's main paths (the
single-image and the batched on-device round trips) at full width in two
configurations, checks the outputs, and prints timings. Every phase must
pass; any failure exits nonzero. The last line of standard output is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits nonzero
before printing any result. ``python3 chip_smoke.py --ranks`` runs phase
24 alone, after the build and its 8K reference (on a machine with two or
more cards, its NCCL ranks too).

Phases:
  1. card, versions, kernel build time
  2. kernels vs plain versions at small shapes (full streams, budget cuts,
     odd-LL geometries routed to the seq decoder, byte-prefix decodes)
  3. configuration A: bior2.2 / reflect / IPT, 3x512x512, 1.0 bpp
  4. configuration B: bior4.4 / symmetric / RGB / level 3 (odd LL), 1.0 bpp
  5. embedded stream: a quarter of A's bytes
  6. timings: round trips end to end, each kernel alone, plain versions
  7. batched kernels (B4, B5, batched B3) vs plain versions and vs the
     single-stream kernels at small shapes
  8. configuration A batched: 16 images, budgets of 1, 1/2, 1/4 bpp and
     one bit short of 1 bpp, through the batch programs' first call (B4
     and B5 counted twice: the warm-up's launch and the capture's)
  9. configuration B batched (odd LL): 8 images at 1.0 bpp (B4 and
     batched B3, twice each)
  10. throughput at configuration A, batches of 16 and 128 images
  11. kernels B2-log and B3-log (the metadata trace's event logs), B6
      (fused quantize) and B7 (sequential encoder) vs their plain versions
      at small shapes, with budget cuts, byte prefixes and B7 stopped by
      each queue's capacity; B6 at sizes 0-17, 4099 and 65,537 at element
      offsets 0-7 with its edge values
  12. the metadata trace at A and at B (odd LL: B3-log), 1.0 bpp (262,145
      x 8 traces): equal to the plain version's and to the native
      scheduler's, its rec to the on-device decode's; decode_image with
      the trace at B; B7 encoding A at 1.0 bpp, equal to B1; B7 at A and
      B, full stream and 1.0 bpp, equal to B1 and the plain version, ms
      and ns a stream bit; SPIHT_TPU_PALLAS_ENC_MACHINE=seq sends
      pallas_encode to B7 and SPIHT_TPU_PALLAS_DEC_MACHINE=seq
      pallas_decode to B3, once each
  13. the host-scheduled batch codec at A, 16 images: encode_images on the
      B6 path (float32) and on the budget path, streams equal to
      encode_images_device's; decode_images equal to decode_images_device;
      images/s of both codecs; B6 alone on the batch's 13.9 M scaled
      coefficients, 21 launches cold (L2 flushed) and 21 warm, median,
      min and max, on the tensor and on a view of it 4 bytes off a
      16-byte boundary
  14. byte-prefix sweep of A's stream through B2, B2-log and B5, and of B's
      through B3 and batched B3 (64 cuts each: near the start, through the
      stream, in the last word), each equal to its plain version: the cut
      falls inside warp steps, so the decoders' bit-by-bit edge path runs;
      random words (no encoder's stream) through B3 and batched B3
  15. the encoder's budget edges: A's and B's coefficients through B1 at 64
      budgets each (the first 9 bits, the last 9 of the 1 bpp stream, the
      rest seeded) and as one B4 batch of those 64 budgets, each equal to
      its plain version and a prefix of the 1 bpp stream; at A, narrowed
      queue capacities that stop B1, B4 and B7 with each queue's error
      code, and a budget clamped by a small word buffer (the capped code)
  16. large geometries: configuration A's settings at 3x2048^2, 3x4096^2
      and 3x4243^2 (BASELINE.md round 5's geometry; odd LL), and B's at
      3x4096^2 (odd LL), 1.0 bpp, through B1, B2 or B3 and the matching log
      kernel (B2-log or B3-log) at the full stream and at a byte prefix,
      held against the native scheduler (streams, rec and traces); kernel
      ms and peak memory; B7 at 3x2048^2 (its ring wraps thousands of
      times) equal to B1 and the plain version; then an A batch of 800
      streams (more than one wave of B4 or B5 blocks) through
      encode_images_device and decode_images_device, stream by stream
      equal to B1 and B2: equal parts of at most batch_bound images
      through one program a direction (B4 and B5 twice, on its first
      call); a second call and a round trip's second call at the bound
      capture nothing; one B4 and one B5 launch of all 800 streams,
      outside the programs, equal to B1's streams and B2's rec
  17. the dependent-chain spikes (spiht_tpu_torch/tools): their entry
      points at small K, then each spike kernel vs its plain version
  18. the machine and block spikes (spiht_tpu_torch/tools): the entry
      points of spike_pallas_machine (S4, 4 x 3.4 MB of state),
      spike_pallas_ilp (S3, 2 MB an array, B = 1, 2, 4, 8 in both
      layouts), spike_pallas_block (S5, 512 rows) and spike_token_matmul
      (S6, both first) at small K, then every variant vs its plain version
  19. the host surface on the card: (a) all 32 colour models at 3x512x512,
      1.0 bpp, through encode_image_device / decode_image_device (B1, B2),
      the card's coefficients held to the CPU transform under the boundary
      rule, streams and rec to the plain machines, images to the CPU
      inverse; (b) encode_image / decode_image under the numpy, native and
      torch transform backends at A and B (B3), encode_images /
      decode_images on the A batch of 16 under native and torch, and the
      float32 host-scheduled path (B6) with Oklab; (c) the command line's
      array cores with --device cuda: encode-decode (device, native),
      encode and decode of a stream file, plan, sweep, batch (B4)
  20. the XLA fallback machines (codec/device_encoder.py, device_decoder.py;
      torch ops, no kernel of their own) on the card with the three
      SPIHT_TPU_PALLAS_* flags at 0: (a) at small geometries (even and odd
      LL) each machine equals its CPU run and B1, B2/B3 and B2-log/B3-log
      on full streams, a budget cut and three byte prefixes; (b) at full
      width the sorted-space encoder equals B1 at A and raises at B's odd
      LL, the hybrid decoder equals B2 at A and B3 at B, and the
      sequential machine's rec and trace equal B2-log's at A and B3-log's
      at B on a 2048-byte prefix; (c) phase 8's 16 A images through the
      lockstep batches equal B4's streams and B5's recs; no kernel
      launches, each machine's wall time and iterations printed
  21. parallel/ and the examples (meshes of cuda:0 repeated: n shards on
      the one card): (a) every geometry of tests/test_torch_parallel.py at
      2, 4 and 8 shards (2x4 with a placed batch) equal to the unsharded
      transform on the card and to the same sharded call on the CPU, plane
      statistics too; (b) configuration A's settings on an 8K image
      (3x4320x7680, 1.0 bpp) through encode_image_sharded on (1, 4): B1
      once, coefficients equal to forward's, stream equal to
      encode_image_device's and the native scheduler's, decoded by
      decode_image_device (B3 at its odd LL), whose coefficients equal the
      native decode's and whose image equals their inverse; (c) B's
      settings at 3x4320x7681 on (1, 8),
      stream equal to the unsharded one; (d) sharded plane statistics of
      the 8K coefficients, replication discrepancy (0, and > 0 one ulp
      off), checked_call on log(-1); (e) the 8K DWT at 1, 2, 4, 8 shards
      against unsharded, reported; (f) probe_devices, robust_encode_images
      on phase 8's images (checkpoint, resume, degraded route with its
      warning, the degraded ids), a one-process NCCL group's barrier;
      (g) the four examples in-process with their defaults (the card),
      each output held against the native scheduler: demonstrate's
      streams and reconstructions, on_device_codec's stream and preview,
      metadata_ml_consumer's trace (its own check), progressive_gif's GIF
      (of a 3x256x256 image) byte for byte against one built from the
      native decodes
  22. the port's closed surface: (a) every entry point on the card raises
      ValueError at LL 1x3 (1x8x23) and at level 0 (3x2x40), and the
      images that pack to them, with every kernel's launch count still 0;
      (b) the JAX package's names on the card (pallas_encode, its fn,
      batch and seq forms, pallas_decode, its fn, batch and int16 forms,
      pallas_decode_with_metadata, quantize_compact_m) equal the existing
      entry points' outputs at A and B, each launching its kernel once;
      (c) the bench, python -m spiht_tpu_torch.codec.device_bench, as a
      subprocess at its defaults with fast=1 batch=8 ebatch=8, and with
      every lane at 128x128 level 4: exit 0, every exact_* true, B1, B2,
      B4 and B5 launched, every lane's kernel rate (torch.profiler's
      kernel time) above its rate to the host; its JSON lines printed
  23. the JAX package's documented switches, each route with the counts
      set to 0 just before and read just after, its output equal to the
      unset route's, and its host-clock median of 3: (a) on the A batch
      of 16 through encode_device_batch, unset, ENC_BATCH=ilv, ILV_B=4,
      ILV_B=5 (B4 1, 1, 4, 4 times) and ENC_BATCH=map (B1 16 times); the
      pipelines' batch programs, each from its key's first call, under
      ILV_B=4 (B4, B5 8 times each: 4 chunks, warm-up and capture) and B5
      unset (twice); decode_device_batch
      unset, DEC_BATCH=ilv, ILV_B=4 (B5 1, 1, 4 times) and DEC_BATCH=map
      (B2 16 times); (b) on the B batch of 8 (odd LL): DEC_BATCH=ilv
      raises MachineResourceLimit with nothing launched, map launches B3
      8 times, ILV_B=4 batched B3 twice, unset once; (c) SPIHT_TPU_PALLAS
      on the A batch's float32 encode_images (budget path off): B6 once
      unset and at 1, never at 0; (d) the raw encode under
      DEVICE_ENCODER=1 at A (B1 once; the sorted-space machine with
      PALLAS_ENCODER=0) and at B (odd LL: B1, the default route); the raw
      decode and decode_with_metadata under DEVICE_DECODER=1 at A (B2,
      B2-log once), and the hybrid machine at 3x64x64 with
      PALLAS_DECODER=0; (e) encode_images / decode_images of 2 images at
      3x64x64 under NO_NATIVE=1 and 0 (the oracle, no native load);
      (f) SPIHT_TPU_CACHE in a subprocess: the library built there
  24. the mesh over the ranks of a process group: 4 processes of this
      script (``--rank``) share cuda:0 over a gloo group; each builds
      make_mesh((1, 4)) over the ranks and encodes phase 21's 8K image at
      A's settings through encode_image_sharded (its colour model and its
      shard's DWT on the card, halos and gathers over the group, B1 on
      the replicated coefficients): every rank's stream equal to phase
      21's (which equals the unsharded B1 stream and the native
      scheduler's), B1 once a call on every rank, rank 0's stream decoded
      here by B3 to phase 21's image; each rank's first-call and warm
      wall ms, DWT ms, device peak, and the calls and bytes of its
      collectives. With two or more cards, min(4, cards) ranks, one a
      card, over NCCL with the same checks; with one, "not run: 1 card"
  25. the single-image round trip as one program a key, the batch
      programs at B = 1 (run before 24, which needs the card's memory): at
      A and B, encode_image_device's and decode_image_device's first call
      (warm-up, capture, replay) and
      a replay equal to phases 3-4's streams and to the eager body's
      images; B1 and B2 (A) or B3 (B) counted twice by their wrappers on
      a key's first call (the warm-up's launch and the capture's) and not
      at all on a replay, which the program counts; in a profiled round
      trip of replays, B1 and the decoder once each in the profiler's
      kernel rows; one
      encode key through budgets of 1.0 bpp, 0.25 bpp, 1 bit and the full
      stream, each equal to the eager body's; one decode key through a
      longer stream, then a shorter one, the first image unchanged; a
      replay of each direction under torch.cuda.set_sync_debug_mode
      ("error") up to the stat read; phase 5's quarter stream equal to the
      eager body's and phase 5's; eager and program medians of 5 and one
      profiled round trip each; the 8K geometry of phase 21 through both
      programs, equal to phase 21's stream and image; each program's
      bucket, pool bytes, static bytes and first-run seconds
  26. the batch codec as one program a key (run before 24): the A batch
      at B = 16 and 128 (phase 8's images and budgets, tiled) and the B
      batch at B = 8, through encode_images_device and
      decode_images_device: a key's first call (B4 and B5 or batched B3
      twice each) and a replay (none), the programs' launch counts
      (streams B in each, seq 1 in the decode at B's odd LL, else 0),
      streams equal to phases 8-10's and
      to the eager bodies' (encode_pipeline_batch_eager,
      decode_pipeline_batch_eager), images equal to the eager body's; in
      a profiled round trip of replays, B4 and the batch decoder once
      each; a replay of each direction under
      torch.cuda.set_sync_debug_mode("error") up to the stat read; eager
      and program medians of 5, first calls, pools (the two programs'
      bytes an image cell at most BATCH_BYTES_PER_CELL, which sizes
      batch_bound), the host's copies
      into the pinned buffer against its upload and the eager path's
      pageable copies; the host rows in fronts of rows_a_front rows
      (every front's rows but the last's overlapped, a front graph
      replayed a front, one back graph a call) and the same images on
      the card in one graph (no row overlapped), streams equal; a
      Kodak-size batch of 24 768x512 float32 images at 1 bpp (budgets 0,
      -3 and 39,320 among them), fronts of 4, byte for byte the eager
      body's, host rows and card rows; the map route at A16
      (SPIHT_TPU_PALLAS_ILV_B=1: B1
      and B2 16 times each in a capture, so 32 on a key's first call, 0
      on a replay), streams and images equal; then the quantizer's
      overflow on the card (an
      image scaled by 1e9: coefficients equal to the CPU's, -2^31 where
      numpy's cast gives it; B1 and B4 streams equal to the CPU port's,
      max_n 31) and an int32 array holding -2^31 through B1 and B4, equal
      to the native scheduler's stream
  27. the trace, the host-scheduled codec's device steps and the
      standalone transforms as programs a key (run before 24): (a) the
      trace at A (B2-log) and B (B3-log) through decode_with_metadata: a
      key's first call (the log kernel twice: warm-up and capture) and a
      replay (none), rec and trace equal to the eager body's
      (meta_expand.decode_with_metadata_eager) and the native scheduler's
      (phase 12's); on a byte prefix the bucket-sized log's rows past
      nbits are 0 and the rows up to it equal the eager kernel's log;
      eager, program, log-only program and expansion-only program medians
      of 5, first calls, pools, the odd-LL replay's passes and its eager
      ms, and the program and eager ms at 2^17 bits and at 32 bits more
      (a bucket of twice the rows); (b) the host-scheduled codec at A16
      in float32 (B6) through
      encode_images (standard path: B6 twice on a first call, none on a
      replay; the budget path) and decode_images: streams equal to phase
      13's and to the parent's op-by-op steps (eager_host_codec), images
      equal to the eager inverse's, images/s eager and program, first
      calls and pools; (c) analysis_fn (with the maps) and synthesis_fn
      at A equal to the eager forward, maps and inverse, ms eager and
      program; (d) a replay of the trace, compact, forward and inverse
      programs under torch.cuda.set_sync_debug_mode("error") up to the
      reads
  28. the decode's inverse DWT, kernel spiht_idwt_level (one launch a
      level), at the cells' shapes: a Kodak batch of 24 3x512x768 images,
      a nuScenes sweep of 6 3x900x1600 frames and one 3x2160x3840 UHD
      frame at the bench's settings (A's), int32 coefficients of the
      forward transform, in float64 and float32: bit for bit its plain
      version's torch ops on the card, launches a call (counted from 0),
      the kernel's ms (CUDA events) beside its bound (coefficients read
      and image written once at the HBM rate) and the plain version's ms.
      Its row of the result line takes its launches from phase 8's main
      path (the A batch's first decode_images_device call: a launch a
      level in the program's warm-up and in its capture).
  29. IPT's inverse colour model, kernel spiht_ipt_inverse (one launch a
      call), at the cells' shapes of phase 28 in float64 and float32, on
      the IPT images of seeded RGB images and on a crop of each (its own
      row stride, the vector accesses' ragged ends): bit for bit
      torch_models.convert(image, "ipt", "RGB")'s torch ops on the card,
      one launch a call (counted from 0), the kernel's ms (CUDA events)
      beside its bound (the image read and written once at the HBM rate)
      and the torch ops' ms. Every decode with A's settings launches it
      once a run of the inverse (twice on a program's first call), so the
      launch checks of phases 3-27 count it beside spiht_idwt_level; its
      row of the result line takes its launches from phase 8's main path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import tempfile
import sys
import threading
import time
from unittest import mock

import numpy as np
import torch

import spiht_tpu_torch as pt
from spiht_tpu_torch import _build, cli, metrics, parallel
from spiht_tpu_torch import transform as host_transform
from spiht_tpu_torch.codec import decoder, encoder, meta_expand
from spiht_tpu_torch.codec.maps import significance_maps
from spiht_tpu_torch.codec.planning import plan_image
from spiht_tpu_torch.color import torch_models
from spiht_tpu_torch.native import runtime as native
from spiht_tpu_torch.ops.quantize_kernels import (
    quantize_compact, quantize_compact_m,
)
from spiht_tpu_torch.ops import synthesis_kernels
from spiht_tpu_torch.tools import (
    card, spike_hbm_table, spike_pallas_block, spike_pallas_ilp,
    spike_pallas_machine, spike_pallas_seq, spike_token_matmul,
)
from spiht_tpu_torch import torch_transform
from spiht_tpu_torch.torch_transform import _scaled_coeffs, forward, inverse
from spiht_tpu_torch.utils import imload, imsave
from spiht_tpu_torch.wavelets import dwt
from spiht_tpu_torch.wavelets.filters import build_wavelet, dwt_max_level
from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w, slices_to_wire

# H100 SXM peaks (NVIDIA data sheet, 700 W), the bound's denominators: the
# HBM rate, and the float32 rate outside the tensor cores, the nearest
# published rate to the machines' scalar integer operations
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# H100 SXM dense tensor-core rates (NVIDIA data sheet, 700 W): S6's mma
# kinds
BF16_FLOPS_PER_S = 989.4e12
TF32_FLOPS_PER_S = 494.7e12
# operations per stream bit: the test that decides it and the shift/or that
# writes (encoder) or reads (decoders) it; per dependent access of a spike:
# the load and the step's use of it
OPS_PER_BIT = 2
# S6's scan kind: the 64-bit operations of one 128-bit window's heads
# (token_sig twice, the carry, the starts, two popcounts, the fold)
SCAN_OPS_PER_WINDOW = 32
DEV = "cuda"  # every card-side call names it

CONFIG_A = pt.SpihtSettings(
    wavelet="bior2.2", mode="reflect", color_model="ipt",
    per_channel_quant_scales=[100, 20, 20], quantization_scale=1.0,
)
CONFIG_B = pt.SpihtSettings(wavelet="bior4.4", mode="symmetric")
GOLDEN = [  # tests/test_golden.py: (seed, settings, level, max_bits, digest)
    (1, pt.SpihtSettings(), 3, 5000,
     "a61cbfa506245869d3392bac4b79fe39f61b12ff9f2a4d6bcc1b2b501cce0d0f"),
    (2, pt.SpihtSettings(wavelet="bior4.4", mode="symmetric"), 2, 4000,
     "bdc2607aa590c1732f65dce9c5ba02782a52e0030f790d26b2dd8d71e7bc7bfb"),
    (3, CONFIG_A, 3, 6000,
     "b55146498451f72ee80b7977e3181f18fc9fb7131c699613bcd2ca80f924664c"),
]
KERNELS = {
    "spiht_encode": dict(
        wrapper=encoder.encode_machine,
        source="spiht_tpu_torch/csrc/spiht_encode.cu",
        replaces="spiht_tpu/codec/pallas_encoder.py:546",
    ),
    "spiht_decode_lsp": dict(
        wrapper=decoder.decode_lsp,
        source="spiht_tpu_torch/csrc/spiht_decode.cu",
        replaces="spiht_tpu/codec/pallas_decoder.py:531",
    ),
    "spiht_decode_seq": dict(
        wrapper=decoder.decode_seq,
        source="spiht_tpu_torch/csrc/spiht_decode.cu",
        replaces="spiht_tpu/codec/pallas_decoder.py:186",
    ),
    # B3 over a grid: odd-LL batches (the TPU ran _seq_fn in a lax.map)
    "spiht_decode_seq_batch": dict(
        wrapper=decoder.decode_seq_batch,
        source="spiht_tpu_torch/csrc/spiht_decode.cu",
        replaces="spiht_tpu/codec/pallas_decoder.py:186",
    ),
    "spiht_encode_batch": dict(
        wrapper=encoder.encode_machine_batch,
        source="spiht_tpu_torch/csrc/spiht_encode.cu",
        replaces="spiht_tpu/codec/pallas_encoder.py:1350",
    ),
    "spiht_decode_lsp_batch": dict(
        wrapper=decoder.decode_lsp_batch,
        source="spiht_tpu_torch/csrc/spiht_decode.cu",
        replaces="spiht_tpu/codec/pallas_decoder.py:1422",
    ),
    # B2's with_log variant (the metadata trace's event log)
    "spiht_decode_lsp_log": dict(
        wrapper=decoder.decode_lsp_log,
        source="spiht_tpu_torch/csrc/spiht_decode.cu",
        replaces="spiht_tpu/codec/pallas_decoder.py:571",
    ),
    # B3 with the event log (odd-LL traces; _seq_fn has no log variant)
    "spiht_decode_seq_log": dict(
        wrapper=decoder.decode_seq_log,
        source="spiht_tpu_torch/csrc/spiht_decode.cu",
        replaces="spiht_tpu/codec/pallas_decoder.py:186",
    ),
    "spiht_quantize_compact": dict(
        wrapper=quantize_compact,
        source="spiht_tpu_torch/csrc/spiht_quantize.cu",
        replaces="spiht_tpu/ops/pallas_kernels.py:36",
    ),
    "spiht_encode_seq": dict(
        wrapper=encoder.encode_machine_seq,
        source="spiht_tpu_torch/csrc/spiht_encode.cu",
        replaces="spiht_tpu/codec/pallas_encoder.py:221",
    ),
    # a level of the decode's inverse DWT (the JAX package leaves it to
    # XLA: no Pallas kernel)
    "spiht_idwt_level": dict(
        wrapper=synthesis_kernels.waverec2_packed,
        source="spiht_tpu_torch/csrc/spiht_synthesis.cu",
        replaces=None,
    ),
    # IPT's inverse colour model (the JAX package leaves it to XLA: no
    # Pallas kernel)
    "spiht_ipt_inverse": dict(
        wrapper=synthesis_kernels.rgb_from_ipt,
        source="spiht_tpu_torch/csrc/spiht_synthesis.cu",
        replaces=None,
    ),
    # the dependent-chain spikes of tools/
    "spike_seq": dict(
        wrapper=spike_pallas_seq.seq_chain,
        source="spiht_tpu_torch/csrc/spike_chains.cu",
        replaces="tools/spike_pallas_seq.py:66",
    ),
    "spike_table": dict(
        wrapper=spike_hbm_table.table_chain,
        source="spiht_tpu_torch/csrc/spike_chains.cu",
        replaces="tools/spike_hbm_table.py:63",
    ),
    "spike_fire": dict(
        wrapper=spike_hbm_table.table_fire,
        source="spiht_tpu_torch/csrc/spike_chains.cu",
        replaces="tools/spike_hbm_table.py:128",
    ),
    # the machine and block spikes of tools/
    "spike_machine": dict(
        wrapper=spike_pallas_machine.machine,
        source="spiht_tpu_torch/csrc/spike_chains.cu",
        replaces="tools/spike_pallas_machine.py:37",
    ),
    "spike_ilp": dict(
        wrapper=spike_pallas_ilp.chains,
        source="spiht_tpu_torch/csrc/spike_chains.cu",
        replaces="tools/spike_pallas_ilp.py:40",
    ),
    "spike_block": dict(
        wrapper=spike_pallas_block.block,
        source="spiht_tpu_torch/csrc/spike_blocks.cu",
        replaces="tools/spike_pallas_block.py:42",
    ),
    "spike_token": dict(
        wrapper=spike_token_matmul.token_heads,
        source="spiht_tpu_torch/csrc/spike_blocks.cu",
        replaces="tools/spike_token_matmul.py:48",
    ),
}
FULL = 2**31 - 2
# phase 8's budgets, cycled over the batch: 1, 1/2 and 1/4 bpp at 512^2,
# and one bit short of 1 bpp (a cut inside a symbol)
BUDGETS_A = (262144, 131072, 65536, 262143)


def image(seed, shape):
    """tests/test_golden.py's seeded synthetic image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : shape[1], 0 : shape[2]].astype(np.float64)
    base = 0.5 + 0.3 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    im = np.stack([base * (0.5 + 0.5 * c / shape[0]) for c in range(shape[0])])
    im += 0.1 * rng.standard_normal(shape)
    return np.clip(im, 0.0, 1.0)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def reset_counts():
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def counts():
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def levels_of(h, w, settings, level) -> int:
    """The DWT levels of an (h, w) image: the launches of spiht_idwt_level
    a decode makes."""
    return len(get_slices_and_h_w(h, w, settings, level)[0]) - 1


def inverse_launches(h, w, settings, level, runs=2) -> dict:
    """The launches of ``runs`` runs of the decode's inverse at (h, w):
    spiht_idwt_level a level, and spiht_ipt_inverse once where the
    settings' colour model is IPT, the kernels with none left out. A
    program's first call runs its inverse twice (warm-up and capture)."""
    n = {"spiht_idwt_level": runs * levels_of(h, w, settings, level)}
    if (settings.color_model or "").lower() == "ipt":
        n["spiht_ipt_inverse"] = runs
    return {k: v for k, v in n.items() if v}


# ---------------------------------------------------------------------------
# kernel vs plain, one call each, on the same inputs
# ---------------------------------------------------------------------------


def to_cpu(args):
    return tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)


def max_abs(a, b) -> int:
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max(initial=0))


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, (time.perf_counter() - t0) * 1e3


def cmp_encode(arr, ll_h, ll_w, max_bits, stats=None):
    """B1 on the card vs its plain version on the same array: words and
    stat exactly equal. Returns (bytes, max_n)."""
    args = encoder.machine_args(arr, ll_h, ll_w, max_bits)
    kw, ks = encoder.encode_machine(*args)
    torch.cuda.synchronize()
    (pw, ps), plain_ms = timed(encoder.encode_machine, *to_cpu(args))
    ks = encoder.check_stat(ks, "spiht_encode")
    check(ks == ps.tolist(), f"B1 stat {ks} != plain {ps.tolist()}")
    err = max_abs(kw.cpu().numpy().view(np.uint32), pw.numpy().view(np.uint32))
    check(err == 0, "B1 words != plain words")
    if stats is not None:
        stats.update(args=args, stat=ks, plain_ms=plain_ms, max_abs_err=err)
    return encoder.stream_bytes(kw, ks[0]), int(args[6])


def cmp_decode(data, max_n, c, h, w, ll_h, ll_w, stats=None):
    """The routed decode kernel on the card vs its plain version: stat,
    LSP queues (B2) and rec exactly equal. Returns (rec, kernel name)."""
    words, nbits = decoder.words_tensor(data, DEV)
    args = decoder.machine_args(words, nbits, max_n, c, h, w, ll_h, ll_w)
    if decoder.has_duplicate_parents(h, w, ll_h, ll_w):
        name, wrapper = "spiht_decode_seq", decoder.decode_seq
    else:
        name, wrapper = "spiht_decode_lsp", decoder.decode_lsp
    kout = wrapper(*args)
    torch.cuda.synchronize()
    pout, plain_ms = timed(wrapper, *to_cpu(args))
    ks = encoder.check_stat(kout[-1], name)
    check(ks == pout[-1].tolist(), f"{name} stat {ks} != plain")
    live = ks[0]
    if name == "spiht_decode_seq":
        krec, prec = kout[0].cpu(), pout[0]
    else:
        for kq, pq in zip(kout[:2], pout[:2]):
            check(torch.equal(kq[:live].cpu(), pq[:live]), f"{name} LSP queue")
        krec = decoder.scatter_rec(*kout, c * h * w).cpu()
        prec = decoder.scatter_rec(*pout, c * h * w)
    err = max_abs(krec.numpy(), prec.numpy())
    check(err == 0, f"{name} rec != plain rec")
    if stats is not None:
        stats.update(args=args, stat=ks, plain_ms=plain_ms, max_abs_err=err)
    return krec.reshape(c, h, w), name


def cmp_encode_batch(arrs, ll_h, ll_w, max_bits, stats=None):
    """B4 on the card vs its plain version on the same batch: words and
    stat exactly equal. Returns [(bytes, max_n)] per stream."""
    args = encoder.batch_machine_args(arrs, ll_h, ll_w, max_bits)
    kw, ks = encoder.encode_machine_batch(*args)
    torch.cuda.synchronize()
    (pw, ps), plain_ms = timed(encoder.encode_machine_batch, *to_cpu(args))
    ks = encoder.check_stat(ks, "spiht_encode_batch")
    check(ks == ps.tolist(), f"B4 stat {ks} != plain {ps.tolist()}")
    err = max_abs(kw.cpu().numpy().view(np.uint32), pw.numpy().view(np.uint32))
    check(err == 0, "B4 words != plain words")
    if stats is not None:
        stats.update(args=args, stat=ks, plain_ms=plain_ms, max_abs_err=err)
    datas = encoder.batch_stream_bytes(kw, [row[0] for row in ks])
    return list(zip(datas, args[6].tolist()))


def cmp_decode_batch(datas, max_ns, c, h, w, ll_h, ll_w, stats=None):
    """The routed batched decode kernel (B5, or batched B3 for odd LL) on
    the card vs its plain version: stat, LSP queues (B5) and rec exactly
    equal. Returns (rec (B, c, h, w) on the host, kernel name)."""
    words, nbits = decoder.words_batch(datas, DEV)
    args = decoder.batch_machine_args(words, nbits, max_ns, c, h, w,
                                      ll_h, ll_w)
    if decoder.has_duplicate_parents(h, w, ll_h, ll_w):
        name, wrapper = "spiht_decode_seq_batch", decoder.decode_seq_batch
    else:
        name, wrapper = "spiht_decode_lsp_batch", decoder.decode_lsp_batch
    kout = wrapper(*args)
    torch.cuda.synchronize()
    pout, plain_ms = timed(wrapper, *to_cpu(args))
    ks = encoder.check_stat(kout[-1], name)
    check(ks == pout[-1].tolist(), f"{name} stat {ks} != plain")
    if name == "spiht_decode_seq_batch":
        krec, prec = kout[0].cpu(), pout[0]
    else:
        for b, row in enumerate(ks):
            for kq, pq in zip(kout[:2], pout[:2]):
                check(torch.equal(kq[b, : row[0]].cpu(), pq[b, : row[0]]),
                      f"{name} stream {b} LSP queue")
        krec = decoder.scatter_rec(*kout, c * h * w).cpu()
        prec = decoder.scatter_rec(*pout, c * h * w)
    err = max_abs(krec.numpy(), prec.numpy())
    check(err == 0, f"{name} rec != plain rec")
    if stats is not None:
        stats.update(args=args, stat=ks, plain_ms=plain_ms, max_abs_err=err)
    return krec.reshape(-1, c, h, w), name


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_small():
    """Phase 2: every kernel vs its plain version at small shapes."""
    dev = DEV
    rng = np.random.default_rng(7)
    cases = []
    # 3x64x64 through the real transform (golden case 1's settings)
    arr, ll_h, ll_w = forward(
        torch.as_tensor(image(1, (3, 64, 64)), device=dev),
        pt.SpihtSettings(), 3,
    )
    cases.append(("3x64x64", arr, ll_h, ll_w))
    # odd LL: random 3x19x19 (LL 5x5), and bior2.2/reflect level 6 at 64^2
    cases.append(("3x19x19", torch.as_tensor(
        (rng.standard_normal((3, 19, 19)) * 2000).astype(np.int32),
        device=dev), 5, 5))
    arr, ll_h, ll_w = forward(
        torch.as_tensor(image(2, (3, 64, 64)), device=dev),
        pt.SpihtSettings(), 6,
    )
    check(tuple(arr.shape) == (3, 89, 89) and (ll_h, ll_w) == (5, 5),
          f"bior2.2 L6 at 64^2 geometry {tuple(arr.shape)} LL {(ll_h, ll_w)}")
    cases.append(("3x89x89", arr, ll_h, ll_w))
    routes = set()
    n_cmp = 0
    for label, arr, ll_h, ll_w in cases:
        c, h, w = arr.shape
        odd = decoder.has_duplicate_parents(h, w, ll_h, ll_w)
        check(odd == (label != "3x64x64"), f"{label} routing")
        full, max_n = cmp_encode(arr, ll_h, ll_w, 2**31 - 2)
        for mb in (1, 2, 3, 64, 333, 1001, 4999, len(full) * 8 - 1):
            data, _ = cmp_encode(arr, ll_h, ll_w, mb)
            check(data[: mb // 8] == full[: mb // 8],
                  f"{label} cut {mb} not a prefix")
            n_cmp += 1
        for cut in sorted({0, 1, 7, len(full) // 3, len(full) // 2, len(full)}):
            rec, name = cmp_decode(full[:cut], max_n, c, h, w, ll_h, ll_w)
            routes.add(name)
            n_cmp += 1
        print(f"  {label}: LL {ll_h}x{ll_w}, {len(full)} bytes, "
              f"decoder {'seq' if odd else 'lsp'}: kernels == plain")
    check(routes == {"spiht_decode_lsp", "spiht_decode_seq"}, "both decoders")
    print(f"phase 2 ok: {n_cmp} exact kernel-vs-plain comparisons")


def main_path(label, settings, level, im, max_bits, expect_dec):
    """Phases 3/4: encode_image_device + decode_image_device on the card
    with the launch counts set to 0 just before and read just after: the
    first call of each key (no program cached), whose warm-up launches B1
    and the decoder and whose capture records the launch its replay runs
    (two launches each; the decode's inverse, spiht_idwt_level, a launch a
    level, and spiht_ipt_inverse at A, in each)."""
    dev = DEV
    torch_transform.clear_programs()
    reset_counts()
    er = pt.encode_image_device(im, settings, level, max_bits, device=dev)
    out = pt.decode_image_device(er, settings, device=dev)
    torch.cuda.synchronize()
    n = counts()
    check(n["spiht_encode"] >= 1, f"{label}: B1 not launched on the path")
    check(n[expect_dec] >= 1, f"{label}: {expect_dec} not launched")
    c, h, w = im.shape
    inv = inverse_launches(h, w, settings, level)
    got_inv = {k: n[k] for k in ("spiht_idwt_level", "spiht_ipt_inverse")
               if n[k]}
    check(got_inv == inv,
          f"{label}: the inverse launched {got_inv}, want {inv} (the decode "
          "program's warm-up and capture)")
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
    ll_h, ll_w = slices[0][1].stop, slices[0][2].stop
    check(out.shape[0] == c and out.shape[1] >= h and out.shape[2] >= w,
          f"{label} image shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), f"{label} image not finite")
    # the card's coefficients; the plain encoder on them gives the bytes
    arr, _, _ = forward(torch.as_tensor(im, device=dev), settings, level)
    enc_stats, dec_stats = {}, {}
    data, max_n = cmp_encode(arr, ll_h, ll_w, max_bits, enc_stats)
    check(data == er.encoded_bytes and max_n == er.max_n,
          f"{label}: stream != plain encoder's on the card's coefficients")
    rec, name = cmp_decode(er.encoded_bytes, er.max_n, c, enc_h, enc_w,
                           ll_h, ll_w, dec_stats)
    check(name == expect_dec, f"{label}: routed to {name}")
    # against the port on the CPU
    arr_cpu, _, _ = forward(torch.as_tensor(im), settings, level)
    n_diff = int((arr_cpu != arr.cpu()).sum())
    er_cpu = pt.encode_image_device(im, settings, level, max_bits, device="cpu")
    out_cpu = pt.decode_image_device(er, settings, device="cpu")
    img_err = float((out.cpu() - out_cpu).abs().max())
    ref = torch.as_tensor(im)
    mse = float(((out.cpu()[:, :h, :w] - ref) ** 2).mean())
    psnr = 10 * np.log10(1.0 / mse)
    print(json.dumps({
        "phase": label, "geometry": [c, enc_h, enc_w], "ll": [ll_h, ll_w],
        "bytes": len(er.encoded_bytes), "max_n": er.max_n,
        "launches": n, "program_replays": [
            p.replays for p in torch_transform.programs()],
        "coeffs_differing_card_vs_cpu": n_diff,
        "stream_equals_cpu_port": er_cpu.encoded_bytes == er.encoded_bytes,
        "image_max_abs_diff_card_vs_cpu_decode": img_err,
        "psnr_db": psnr,
    }))
    return er, n, enc_stats, dec_stats, er_cpu


def bound_ms(name, stats):
    """(least ms for the kernel's work on this run's data, what bounds it):
    the larger of the bytes it must move (each input word it needs read
    once, each output written once) over the HBM rate, and its operations
    (OPS_PER_BIT for each stream bit) over the scalar rate. A batch's
    work is the sum of its streams'."""
    args = stats["args"]
    if "bytes" in stats:  # S5, S6: bytes and operations counted by phase 18
        t_bytes = stats["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = stats["ops"] / stats["ops_per_s"] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")
    if name.startswith("spike_"):
        # one int32 read a dependent access, the output row written
        t_bytes = (4 * stats["accesses"] + stats["out_bytes"]) / \
            HBM_BYTES_PER_S * 1e3
        t_ops = OPS_PER_BIT * stats["accesses"] / SCALAR_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")
    if name == "spiht_quantize_compact":
        # 4 bytes read, 4 + 2 + 1 written per element; a few integer
        # operations per element, far below the byte time
        t_bytes = args[0].numel() * 11 / HBM_BYTES_PER_S * 1e3
        return t_bytes, "bytes"
    rows = stats["stat"] if isinstance(stats["stat"][0], list) else [
        stats["stat"]]
    nbytes = nbits = 0
    for s in rows:
        if name.startswith("spiht_encode"):
            # t1 and t3s of every coefficient the run tested (each ends in
            # the LIP or the LSP), t1 of the sets left in the LIS, the
            # initial queues, the stream written
            n_init = 4 * (args[3].numel() + args[4].numel())
            nbytes += 8 * (s[2] + s[4]) + 4 * s[3] + n_init + (s[0] + 7) // 8
            nbits += s[0]
        else:
            n_init = 4 * (args[4].numel() + args[5].numel())
            # the stream bits read, the initial queues, and the output: two
            # LSP words per commit (B2, B5) or rec written whole (B3)
            lsp = name.startswith("spiht_decode_lsp")
            out = 8 * s[0] if lsp else 4 * args[3].numel()
            if name.endswith("_log"):  # and the nbits + 1 64-bit log words
                out += 8 * (args[1] + 1)
            nbytes += (s[5] + 7) // 8 + n_init + out
            nbits += s[5]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_BIT * nbits / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the wrappers whose kernels read their per-call scalars from device
# memory (argument positions): timed with the scalars there, as a
# program's replay launches them, so no fill kernel of the wrapper's is in
# the kernel's time (B7 takes its budget by value; the log variants size
# their log from nbits on the host and keep their ints)
SCALAR_ARGS = {encoder.encode_machine: (6, 7, 8),
               encoder.encode_machine_seq: (6,),
               decoder.decode_lsp: (1, 2), decoder.decode_seq: (1, 2)}


def time_kernel(wrapper, args, min_ms=50.0, max_reps=200):
    """ms per launch by CUDA events over at least 5 launches after a
    warm-up, more for a short kernel (enough for ~``min_ms`` in all, at
    most ``max_reps``)."""
    pos = SCALAR_ARGS.get(wrapper, ())
    args = tuple(encoder.device_scalar("scalar", a, args[0].device)
                 if i in pos else a for i, a in enumerate(args))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    wrapper(*args)
    e0.record()
    wrapper(*args)
    e1.record()
    torch.cuda.synchronize()
    reps = min(max(5, int(min_ms / max(e0.elapsed_time(e1), 1e-3))),
               max_reps)
    e0.record()
    for _ in range(reps):
        wrapper(*args)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def profile_round_trip(label, round_trip):
    """Where one round trip's time goes (``round_trip()`` encodes and
    decodes): torch.profiler's device time by kernel, and the device's
    idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        round_trip()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side entries only (kernels, copies): a CPU op's own entry
    # would count its kernels' time a second time
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    row = {
        "profile": f"{label} round trip (encode + decode) under "
                   "torch.profiler, whose overhead inflates wall_ms",
        "wall_ms": wall,
        "device_busy_ms": busy if rows else "not measured",
        "device_idle_share": 1 - busy / wall if rows else "not measured",
        "top_device_ms": [[k, ms, n] for k, ms, n in rows[:8]],
    }
    print(json.dumps(row))
    row["rows"] = rows  # every device row: (name, ms, count)
    return row


def median_ms(fn, reps=5):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def phase_batch_small():
    """Phase 7: the batched kernels vs their plain versions and, stream by
    stream, vs the single-stream kernels, at small shapes."""
    rng = np.random.default_rng(9)
    n_cmp = 0
    for shape, ll, scales, mbs, dec in (
        # B4 with a zero image and budgets cut mid-symbol; B5 on streams of
        # different lengths (whole, 1 and 7 byte prefixes, half)
        ((3, 24, 32), (6, 8), (400, 9000, 60, 0), [FULL, 1, 333, 2897],
         "spiht_decode_lsp_batch"),
        # odd LL: B4 and batched B3
        ((3, 19, 19), (5, 5), (3000, 7, 900), [13, 222, FULL],
         "spiht_decode_seq_batch"),
    ):
        arrs = torch.as_tensor(np.stack([
            (rng.standard_normal(shape) * s).astype(np.int32) for s in scales
        ]), device=DEV)
        got = cmp_encode_batch(arrs, *ll, mbs)
        for b, mb in enumerate(mbs):
            check(got[b] == cmp_encode(arrs[b], *ll, mb),
                  f"{shape} stream {b}: B4 != B1")
        full = cmp_encode_batch(arrs, *ll, [FULL] * len(mbs))
        cuts = (None, 1, 7, len(full[-1][0]) // 2)
        datas = [d[: cuts[b % 4]] for b, (d, _) in enumerate(full)]
        mns = [mn for _, mn in full]
        rec, name = cmp_decode_batch(datas, mns, *shape, *ll)
        check(name == dec, f"{shape} routed to {name}")
        for b in range(len(datas)):
            one, _ = cmp_decode(datas[b], mns[b], *shape, *ll)
            check(torch.equal(rec[b], one.cpu()),
                  f"{shape} stream {b}: {name} != the single-stream kernel")
        n_cmp += 3 + 2 * len(mbs)
        print(f"  {shape}: B={len(mbs)}, streams {[len(d) for d in datas]} "
              f"bytes: B4 and {name} == plain == single-stream kernels")
    print(f"phase 7 ok: {n_cmp} exact batched comparisons")


def batch_main_path(label, settings, level, ims, mbs, expect_dec):
    """Phases 8/9: encode_images_device + decode_images_device on the card,
    the launch counts set to 0 just before and read just after: the first
    call of each batch program's key (none cached), whose warm-up launches
    B4 and the batch decoder and whose capture records the launch its
    replay runs (two launches each; the decode's inverse, spiht_idwt_level,
    a launch a level, and spiht_ipt_inverse at A, in each). Then every
    stream held against the plain versions on the card's coefficients and
    against the single-image entry points."""
    dev = DEV
    torch_transform.clear_programs()
    reset_counts()
    ers = pt.encode_images_device(ims, settings, level, mbs, device=dev)
    outs = pt.decode_images_device(ers, settings, device=dev)
    torch.cuda.synchronize()
    n = counts()
    B = len(ims)
    c, h, w = ims[0].shape
    want = {k: 0 for k in n}
    want.update({"spiht_encode_batch": 2, expect_dec: 2,
                 **inverse_launches(h, w, settings, level)})
    check(n == want, f"{label}: launches {n}, want {want}")
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
    ll_h, ll_w = slices[0][1].stop, slices[0][2].stop
    check(len(outs) == B and all(
        o.shape[0] == c and o.shape[1] >= h and o.shape[2] >= w
        and bool(torch.isfinite(o).all()) for o in outs),
        f"{label}: images' shape or values")
    # the card's coefficients; the plain machines on them
    arrs, _, _ = forward(torch.as_tensor(np.stack(ims), device=dev),
                         settings, level)
    enc_stats, dec_stats = {}, {}
    got = cmp_encode_batch(arrs, ll_h, ll_w, mbs, enc_stats)
    check(got == [(er.encoded_bytes, er.max_n) for er in ers],
          f"{label}: streams != plain encoder's on the card's coefficients")
    _, name = cmp_decode_batch([er.encoded_bytes for er in ers],
                               [er.max_n for er in ers], c, enc_h, enc_w,
                               ll_h, ll_w, dec_stats)
    check(name == expect_dec, f"{label}: routed to {name}")
    # each stream and image as the single-image entry points give it
    psnr = []
    for b in range(B):
        one = pt.encode_image_device(ims[b], settings, level, mbs[b],
                                     device=dev)
        check(one.encoded_bytes == ers[b].encoded_bytes
              and one.max_n == ers[b].max_n,
              f"{label} stream {b}: batch != encode_image_device")
        img = pt.decode_image_device(ers[b], settings, device=dev)
        check(torch.equal(img, outs[b]),
              f"{label} image {b}: batch != decode_image_device")
        mse = float(((outs[b][:, :h, :w].cpu() - torch.as_tensor(ims[b]))
                     ** 2).mean())
        psnr.append(10 * np.log10(1.0 / mse))
    print(json.dumps({
        "phase": label, "batch": B, "geometry": [c, enc_h, enc_w],
        "ll": [ll_h, ll_w], "budgets": sorted(set(mbs)),
        "bytes": [len(er.encoded_bytes) for er in ers],
        "max_n": sorted({er.max_n for er in ers}), "launches": n,
        "streams_equal_plain_and_single": True,
        "images_equal_single": True,
        "psnr_db_min_max": [min(psnr), max(psnr)],
    }))
    return ers, n, enc_stats, dec_stats


def phase_throughput(ims16, mbs16, ers16, enc16, dec16):
    """Phase 10: images/s of the batched round trip at configuration A for
    B = 16 and B = 128 (phase 8's images and budgets tiled), each batched
    kernel alone, and the device's idle share of one profiled batch."""
    c, h, w = ims16[0].shape
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, CONFIG_A, None)
    ll = (slices[0][1].stop, slices[0][2].stop)
    for B in (16, 128):
        ims = ims16 * (B // 16)
        mbs = mbs16 * (B // 16)
        ers = pt.encode_images_device(ims, CONFIG_A, None, mbs, device=DEV)
        check(all(er.encoded_bytes == ers16[b % 16].encoded_bytes
                  for b, er in enumerate(ers)),
              f"B={B}: a stream differs from phase 8's of the same image")
        enc_ms = median_ms(lambda: pt.encode_images_device(
            ims, CONFIG_A, None, mbs, device=DEV))
        dec_ms = median_ms(lambda: pt.decode_images_device(
            ers, CONFIG_A, device=DEV))
        arrs, _, _ = forward(torch.as_tensor(np.stack(ims), device=DEV),
                             CONFIG_A, None)
        eargs = encoder.batch_machine_args(arrs, *ll, mbs)
        words, nbits = decoder.words_batch([er.encoded_bytes for er in ers],
                                           DEV)
        dargs = decoder.batch_machine_args(
            words, nbits, [er.max_n for er in ers], c, enc_h, enc_w, *ll)
        k_enc = time_kernel(encoder.encode_machine_batch, eargs)
        k_dec = time_kernel(decoder.decode_lsp_batch, dargs)
        bounds = {
            name: bound_ms(name, {"args": args, "stat": encoder.check_stat(
                wrapper(*args)[-1], name)})[0]
            for name, wrapper, args in (
                ("spiht_encode_batch", encoder.encode_machine_batch, eargs),
                ("spiht_decode_lsp_batch", decoder.decode_lsp_batch, dargs))
        }
        print(json.dumps({
            "throughput": "A batch, median of 5, host clock to sync",
            "batch": B, "encode_ms": enc_ms, "decode_ms": dec_ms,
            "encode_images_per_s": B / enc_ms * 1e3,
            "decode_images_per_s": B / dec_ms * 1e3,
            "per_image_encode_ms": enc_ms / B,
            "per_image_decode_ms": dec_ms / B,
            "kernel_ms": {"spiht_encode_batch": k_enc,
                          "spiht_decode_lsp_batch": k_dec},
            "bound_ms": bounds,
            "launches_per_batch": {"spiht_encode_batch": 1,
                                   "spiht_decode_lsp_batch": 1},
            "plain_ms_b16": {"spiht_encode_batch": enc16["plain_ms"],
                             "spiht_decode_lsp_batch": dec16["plain_ms"]},
        }))
        del arrs, eargs, words, dargs
        profile_round_trip(f"A batch of {B}", lambda: (
            pt.decode_images_device(pt.encode_images_device(
                ims, CONFIG_A, None, mbs, device=DEV), CONFIG_A,
                device=DEV)))
    # the batch programs of 128 images hold ~18 GB: free it for phase 16
    torch_transform.clear_programs()
    torch.cuda.empty_cache()


def cmp_decode_log(data, max_n, c, h, w, ll_h, ll_w, stats=None):
    """The routed log kernel (B2-log, or B3-log for odd LL) on the card vs
    its plain version on the same stream: stat, LSP queues (B2-log) or rec
    (B3-log), and every event word exactly equal."""
    words, nbits = decoder.words_tensor(data, DEV)
    args = decoder.machine_args(words, nbits, max_n, c, h, w, ll_h, ll_w)
    seq = decoder.has_duplicate_parents(h, w, ll_h, ll_w)
    name, wrapper = (("spiht_decode_seq_log", decoder.decode_seq_log) if seq
                     else ("spiht_decode_lsp_log", decoder.decode_lsp_log))
    kout = wrapper(*args)
    torch.cuda.synchronize()
    pout, plain_ms = timed(wrapper, *to_cpu(args))
    ks = encoder.check_stat(kout[-2], name)
    check(ks == pout[-2].tolist(), f"{name} stat {ks} != plain")
    if seq:
        check(torch.equal(kout[0].cpu(), pout[0]), f"{name} rec")
    else:
        for kq, pq in zip(kout[:2], pout[:2]):
            check(torch.equal(kq[: ks[0]].cpu(), pq[: ks[0]]),
                  f"{name} LSP queue")
    err = max_abs(kout[-1].cpu().numpy(), pout[-1].numpy())
    check(err == 0, f"{name} event log != plain event log")
    if stats is not None:
        stats.update(args=args, stat=ks, plain_ms=plain_ms, max_abs_err=err)
    return kout


def cmp_encode_seq_args(args, stats=None):
    """B7 on the card vs its plain version and vs B1 on ``encode_machine``'s
    arguments as given (narrowed capacities, a clamped budget): words and
    stat exactly equal, the error code included. Returns (words, stat
    list)."""
    kw, ks = encoder.encode_machine_seq(*args)
    bw, bs = encoder.encode_machine(*args)
    torch.cuda.synchronize()
    (pw, ps), plain_ms = timed(encoder.encode_machine_seq, *to_cpu(args))
    ks = ks.tolist()
    check(ks == ps.tolist() == bs.tolist(),
          f"B7 stat {ks} != plain {ps.tolist()} or B1 {bs.tolist()}")
    err = max_abs(kw.cpu().numpy().view(np.uint32), pw.numpy().view(np.uint32))
    check(err == 0 and torch.equal(kw, bw), "B7 words != plain or B1 words")
    if stats is not None:
        stats.update(args=args, stat=ks, plain_ms=plain_ms, max_abs_err=err)
    return kw, ks


def cmp_encode_seq(arr, ll_h, ll_w, max_bits, stats=None):
    """B7 on the card vs its plain version and vs B1 on the same array:
    words and stat exactly equal, no error. Returns (bytes, max_n)."""
    args = encoder.machine_args(arr, ll_h, ll_w, max_bits)
    kw, ks = cmp_encode_seq_args(args, stats)
    encoder.check_stat(torch.tensor(ks), "spiht_encode_seq")
    return encoder.stream_bytes(kw, ks[0]), int(args[6])


def seq_timing(label, stats):
    """B7's ms by CUDA events at ``stats``' arguments, and ns a stream
    bit."""
    ms = time_kernel(encoder.encode_machine_seq, stats["args"])
    bits = stats["stat"][0]
    return {"config": label, "bits": bits, "ms": ms,
            "ns_per_stream_bit": ms * 1e6 / max(bits, 1),
            "plain_ms": stats["plain_ms"]}


def cmp_quantize(x, scale, stats=None):
    """B6 on the card vs its plain version on the same float32 input: all
    four outputs exactly equal."""
    kout = quantize_compact(x, scale)
    torch.cuda.synchronize()
    pout, plain_ms = timed(quantize_compact, x.cpu(), scale)
    err = max(max_abs(k.cpu().numpy(), p.numpy()) for k, p in zip(kout, pout))
    check(err == 0, "B6 outputs != plain outputs")
    if stats is not None:
        stats.update(args=(x, scale), plain_ms=plain_ms, max_abs_err=err)
    return kout


def quantize_cases():
    """B6's edge inputs (tests/test_torch_kernel_source.py runs them on the
    host build): for each size n in 0-17, 4099 and 65,537, a seeded
    buffer of n + 8 float32 values
    with +-32767, +-32768, powers of two and their neighbours, 0 and
    +-0.99 spread through it; its views at element offsets 0-7 are the
    cases (x unaligned for 16-byte loads at offsets 1-3 and 5-7)."""
    edges = [0.0, 0.99, -0.99, 32767.0, -32767.0, 32768.0, -32768.0]
    for k in range(31):
        edges += [s * (2.0**k + d) for s in (1, -1) for d in (-1, 0, 1)]
    edges = np.asarray(edges, np.float32)
    rng = np.random.default_rng(12)
    out = []
    for n in list(range(18)) + [4099, 65537]:
        buf = (rng.standard_normal(n + 8) * rng.choice([3.0, 900.0, 4e4])
               ).astype(np.float32)
        at = rng.choice(n + 8, min(n + 8, len(edges)), replace=False)
        buf[at] = rng.permutation(edges)[: len(at)]
        out.append((n, buf))
    return out


def quantize_cold_warm(x, scale, lib=None, reps=21):
    """B6 alone on ``x`` (the launch of ``lib``, by default the build's),
    by CUDA events launch by launch: ``reps`` launches each after a 128 MB
    buffer is written (the 50 MB L2 holds none of x), then ``reps`` back
    to back (warm). The outputs are allocated once and held to the
    wrapper's. Returns {"cold": {median, min, max}, "warm": {...}} in
    ms."""
    lib = lib or _build.load("spiht_quantize")
    outs = [torch.empty(x.shape, dtype=t, device=DEV)
            for t in (torch.int32, torch.int16, torch.int8)]
    ofl = torch.zeros((), dtype=torch.int32, device=DEV)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.spiht_quantize_compact_launch(
            x.data_ptr(), x.numel(), float(np.float32(scale)),
            *(o.data_ptr() for o in outs), ofl.data_ptr(), stream)
        check(rc == 0, f"B6 launch: CUDA error {rc}")

    launch()
    want = quantize_compact(x, scale)
    torch.cuda.synchronize()
    check(all(torch.equal(o, w) for o, w in zip(outs, want))
          and bool(ofl != 0) == bool(want[3]), "B6 alone != its wrapper")
    res = {}
    for kind in ("cold", "warm"):
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(reps)]
        for e0, e1 in ev:
            if kind == "cold":
                flush.fill_(1)
            e0.record()
            launch()
            e1.record()
        torch.cuda.synchronize()
        t = sorted(e0.elapsed_time(e1) for e0, e1 in ev)
        res[kind] = {"median_ms": statistics.median(t), "min_ms": t[0],
                     "max_ms": t[-1], "launches": reps}
    del flush
    return res


def phase_new_kernels_small():
    """Phase 11: B2-log, B7 and B6 vs their plain versions at small
    shapes: B7 at budgets cut inside a symbol and at each queue's
    capacity stop (and equal to B1), B2-log on those streams and on byte
    prefixes of the full one, B6 with its overflow flag set and clear and
    at sizes 0-17, 4099 and 65,537 at element offsets 0-7 with its edge
    values (``quantize_cases``)."""
    rng = np.random.default_rng(11)
    arr, ll_h, ll_w = forward(
        torch.as_tensor(image(1, (3, 64, 64)), device=DEV),
        pt.SpihtSettings(), 3)
    c, h, w = arr.shape
    check(not decoder.has_duplicate_parents(h, w, ll_h, ll_w), "3x64x64 LL")
    full, max_n = cmp_encode_seq(arr, ll_h, ll_w, FULL)
    n_cmp = 1
    for mb in (1, 2, 3, 64, 333, 1001, 4999, len(full) * 8 - 1):
        data, _ = cmp_encode_seq(arr, ll_h, ll_w, mb)
        cmp_decode_log(data, max_n, c, h, w, ll_h, ll_w)
        n_cmp += 2
    for cut in sorted({0, 1, 7, len(full) // 3, len(full) // 2, len(full)}):
        cmp_decode_log(full[:cut], max_n, c, h, w, ll_h, ll_w)
        n_cmp += 1
    odd = torch.as_tensor(
        (rng.standard_normal((3, 19, 19)) * 2000).astype(np.int32), device=DEV)
    for mb in (FULL, 13, 222):
        data, mn = cmp_encode_seq(odd, 5, 5, mb)
        n_cmp += 1
        # B3-log on the odd-LL streams and byte prefixes of the full one
        for cut in ((None, 1, 7, len(data) // 2) if mb == FULL else (None,)):
            cmp_decode_log(data[:cut], mn, 3, 19, 19, 5, 5)
            n_cmp += 1
    # B7 stopped by each queue's capacity, half its length at the end
    for a, ll in ((arr, (ll_h, ll_w)), (odd, (5, 5))):
        args = encoder.machine_args(a, *ll, FULL)
        _, st = cmp_encode_seq_args(args)
        init = (args[3].numel(), args[4].numel(), 0)
        for which in range(3):
            caps = list(args[9])
            caps[which] = max(init[which], st[2 + which] // 2)
            _, cut = cmp_encode_seq_args(args[:9] + (tuple(caps),)
                                         + args[10:])
            check(cut[1] != 0, f"B7 at capacities {caps}: no stop")
            n_cmp += 1
    for spread, shape in ((3.0, (3, 64, 64)), (900.0, (3, 77, 77)),
                          (40000.0, (5, 333))):
        x = torch.as_tensor(
            (rng.standard_normal(shape) * spread).astype(np.float32),
            device=DEV)
        out = cmp_quantize(x, 1.7)
        check(bool(out[3]) == (spread > 10000), f"B6 overflow at {spread}")
        n_cmp += 1
    for n, buf in quantize_cases():
        tb = torch.as_tensor(buf, device=DEV)
        for off in range(8):
            for scale in (1.0, 1.7):
                cmp_quantize(tb[off: off + n], scale)
                n_cmp += 1
    print(f"phase 11 ok: {n_cmp} exact comparisons of B2-log, B3-log, B7 "
          "and B6 with their plain versions (B7 also with B1)")


def trace_at(label, er, settings, level, kernel):
    """The metadata trace of ``er`` through the API on the card, the counts
    set to 0 just before and read just after (a trace program's first
    call: two launches of ``kernel``);
    equal to the plain version's trace and to the native scheduler's, its
    rec to the on-device decode's. Returns (log kernel stats, launches)."""
    slices, enc_h, enc_w = get_slices_and_h_w(er.h, er.w, settings, level)
    geo = (er.c, enc_h, enc_w, slices[0][1].stop, slices[0][2].stop)
    wire = slices_to_wire(slices)
    data, mn = er.encoded_bytes, er.max_n
    # the trace runs as a program a key: its first call launches the log
    # kernel twice (the warm-up's launch and the capture's)
    torch_transform.clear_programs()
    reset_counts()
    rec, meta = pt.decode_with_metadata(data, mn, *geo, *wire, device=DEV)
    torch.cuda.synchronize()
    n = counts()
    want = {k: 0 for k in n}
    want[kernel] = 2
    check(n == want, f"trace at {label}: launches {n}, want {want}")
    check(meta.shape == (len(data) * 8 + 1, 8), f"trace shape {meta.shape}")
    (prec, pmeta), plain_trace_ms = timed(
        pt.decode_with_metadata, data, mn, *geo, *wire, "cpu")
    check(np.array_equal(rec, prec) and np.array_equal(meta, pmeta),
          f"trace at {label} on the card != the plain version's")
    nrec, nmeta = native.load().decode_with_metadata(data, mn, *geo, *wire)
    check(np.array_equal(rec, nrec) and np.array_equal(meta, nmeta),
          f"trace at {label} on the card != the native scheduler's")
    drec = decoder.decode(data, mn, *geo, device=DEV).cpu().numpy()
    check(np.array_equal(rec, drec), f"trace rec at {label} != decode's rec")
    log_stats = {}
    cmp_decode_log(data, mn, *geo, log_stats)
    trace_ms = median_ms(lambda: pt.decode_with_metadata(
        data, mn, *geo, *wire, device=DEV))
    rec_ms = median_ms(lambda: decoder.decode(data, mn, *geo, device=DEV))
    print(json.dumps({
        "phase": f"12 metadata trace at {label}", "bits": len(data) * 8,
        "trace_rows": meta.shape[0], "events": int((meta != 0).any(1).sum()),
        "launches": n, "equal_plain_native_and_rec": True,
        "trace_ms_median_of_5": trace_ms,
        "decode_rec_ms_median_of_5": rec_ms,
        "plain_trace_ms": plain_trace_ms,
    }))
    return log_stats, n[kernel], meta


def phase_metadata(im_a, im_b, er_a, er_b):
    """Phase 12: the metadata trace at A (B2-log) and at B (odd LL:
    B3-log), each through the API on the card (``trace_at``);
    decode_image with the trace at B. Then B7 encodes A through the API;
    B7 at A and B at the full stream and 1.0 bpp, equal to B1 and the
    plain version, timed (ms and ns a stream bit); and the reference's
    switches: SPIHT_TPU_PALLAS_ENC_MACHINE=seq sends pallas_encode to B7,
    SPIHT_TPU_PALLAS_DEC_MACHINE=seq pallas_decode at A's even LL to B3,
    once each."""
    log_a, n_log, _ = trace_at("A", er_a, CONFIG_A, None,
                               "spiht_decode_lsp_log")
    log_b, n_log_b, meta_b = trace_at("B", er_b, CONFIG_B, 3,
                                      "spiht_decode_seq_log")
    reset_counts()
    img, meta = pt.decode_image(er_b, CONFIG_B, return_metadata=True,
                                device=DEV)
    torch.cuda.synchronize()
    # trace_at B's key, and the inverse program's first call
    program_launch("spiht_decode_seq_log", "trace",
                   inverse_launches(er_b.h, er_b.w, CONFIG_B, 3))
    check(np.array_equal(meta, meta_b), "decode_image's trace at B")
    plain_img = pt.decode_image(er_b, CONFIG_B, device=DEV)
    check(np.array_equal(img, plain_img) and np.isfinite(img).all(),
          "decode_image with the trace at B != without")
    print(f"  B: decode_image(return_metadata=True) on the card: trace "
          f"{meta.shape}, image {img.shape} equal to decode_image's")
    # B7 at A's 1.0 bpp, through the raw encode entry point
    slices, enc_h, enc_w = get_slices_and_h_w(*im_a.shape[1:], CONFIG_A, None)
    ll = (slices[0][1].stop, slices[0][2].stop)
    arr, _, _ = forward(torch.as_tensor(im_a, device=DEV), CONFIG_A, None)
    reset_counts()
    data7, mn7 = pt.encode(arr, *ll, 512 * 512, device=DEV, machine="seq")
    torch.cuda.synchronize()
    n7 = counts()
    want = {k: 0 for k in n7}
    want["spiht_encode_seq"] = 1
    check(n7 == want, f"B7 at A: launches {n7}, want {want}")
    check((data7, mn7) == (er_a.encoded_bytes, er_a.max_n),
          "B7's stream at A != encode_image_device's")
    seq_stats = {}
    cmp_encode_seq(arr, *ll, 512 * 512, seq_stats)
    rows = [seq_timing("A 1.0 bpp", seq_stats)]
    arr_b, llb_h, llb_w = forward(torch.as_tensor(im_b, device=DEV),
                                  CONFIG_B, 3)
    for label, a, lh, lw, budgets in (
            ("A", arr, *ll, ("full",)),
            ("B", arr_b, llb_h, llb_w, ("full", "1.0 bpp"))):
        for what in budgets:
            st = {}
            cmp_encode_seq(a, lh, lw, FULL if what == "full" else 512 * 512,
                           st)
            rows.append(seq_timing(f"{label} {what}", st))
    # the reference's machine switches, each path with the counts set to
    # 0 just before and read just after
    with mock.patch.dict(os.environ,
                         {"SPIHT_TPU_PALLAS_ENC_MACHINE": "seq"}):
        reset_counts()
        got = encoder.pallas_encode(arr, *ll, 512 * 512, device=DEV)
        launched("spiht_encode_seq")
    check(got == (er_a.encoded_bytes, er_a.max_n),
          "pallas_encode under ENC_MACHINE=seq != encode_image_device")
    geo_a = (3, enc_h, enc_w, *ll)
    with mock.patch.dict(os.environ,
                         {"SPIHT_TPU_PALLAS_DEC_MACHINE": "seq"}):
        reset_counts()
        rec = decoder.pallas_decode(er_a.encoded_bytes, er_a.max_n, *geo_a,
                                    device=DEV)
        launched("spiht_decode_seq")
    check(np.array_equal(rec, decoder.decode(
        er_a.encoded_bytes, er_a.max_n, *geo_a, device=DEV).cpu().numpy()),
          "pallas_decode under DEC_MACHINE=seq != B2's rec")
    print(json.dumps({"phase": "12 B7 at A and B", "card": card(),
                      "launches": n7, "equals_b1_and_plain": True,
                      "switches": {"enc_seq": {"spiht_encode_seq": 1},
                                   "dec_seq": {"spiht_decode_seq": 1}},
                      "b7": rows}))
    return log_a, n_log, log_b, n_log_b, seq_stats, n7["spiht_encode_seq"]


def host_batch_stages(ims, mbs, ers):
    """Where encode_images / decode_images spend their time at A in the
    float32 working dtype: each stage alone, median of 5, host clock to a
    sync (the card's stages) or to the native call's return."""
    from spiht_tpu_torch.codec import api as tapi
    from spiht_tpu_torch.torch_transform import (
        forward_compact, forward_plan, inverse,
    )

    f32 = torch.float32
    nat = native.load()
    c, h, w = ims[0].shape
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, CONFIG_A, None)
    ll = (slices[0][1].stop, slices[0][2].stop)
    batch = tapi._device_batch(ims, DEV)
    arr16 = forward_compact(batch, CONFIG_A, None, f32)[0]
    arrs = list(arr16.cpu().numpy().astype(np.int32))
    recs = nat.decode_batch([e.encoded_bytes for e in ers],
                            [e.max_n for e in ers], [c] * len(ers),
                            [enc_h] * len(ers), [enc_w] * len(ers),
                            [ll[0]] * len(ers), [ll[1]] * len(ers))
    rec_batch = tapi._device_batch(recs, DEV)
    return {
        "upload_images_ms": median_ms(lambda: tapi._device_batch(ims, DEV)),
        "forward_compact_b6_ms": median_ms(
            lambda: forward_compact(batch, CONFIG_A, None, f32)),
        "int16_to_host_ms": median_ms(lambda: arr16.cpu()),
        "native_encode_batch_ms": median_ms(lambda: nat.encode_batch(
            arrs, [ll[0]] * len(arrs), [ll[1]] * len(arrs),
            [2**62] * len(arrs), use_maps=True)),
        "forward_plan_ms": median_ms(
            lambda: forward_plan(batch, CONFIG_A, None, f32)),
        "native_encode_batch_budgets_ms": median_ms(lambda: nat.encode_batch(
            arrs, [ll[0]] * len(arrs), [ll[1]] * len(arrs), mbs,
            use_maps=True)),
        "native_decode_batch_ms": median_ms(lambda: nat.decode_batch(
            [e.encoded_bytes for e in ers], [e.max_n for e in ers],
            [c] * len(ers), [enc_h] * len(ers), [enc_w] * len(ers),
            [ll[0]] * len(ers), [ll[1]] * len(ers))),
        "upload_rec_ms": median_ms(lambda: tapi._device_batch(recs, DEV)),
        "inverse_to_host_ms": median_ms(lambda: inverse(
            rec_batch, h, w, None, CONFIG_A).cpu()),
        "host_cores": len(__import__("os").sched_getaffinity(0)),
    }


def phase_host_batch(ims, mbs):
    """Phase 13: encode_images / decode_images at A, 16 images, float32
    working dtype: the B6 path (no budget) and the budget path (phase 8's
    budgets), each with the counts set to 0 just before and read just
    after; streams equal to encode_images_device's at the same budgets,
    images equal to decode_images_device's; images/s of both codecs."""
    from spiht_tpu_torch.codec import api as tapi

    f32 = torch.float32
    B = len(ims)
    # the compact transform runs as a program a key: its first call
    # launches B6 twice (the warm-up's launch and the capture's)
    torch_transform.clear_programs()
    reset_counts()
    ers = pt.encode_images(ims, CONFIG_A, None, None, device=DEV, dtype=f32)
    torch.cuda.synchronize()
    n6 = counts()
    want = {k: 0 for k in n6}
    want["spiht_quantize_compact"] = 2
    check(n6 == want, f"encode_images B6 path: launches {n6}, want {want}")
    dev_ers = pt.encode_images_device(ims, CONFIG_A, None, None, device=DEV,
                                      dtype=f32)
    check([(e.encoded_bytes, e.max_n) for e in ers]
          == [(e.encoded_bytes, e.max_n) for e in dev_ers],
          "encode_images (B6 path) != encode_images_device")
    # the budget path: the planner and the narrowing on the card, no
    # kernel of the port, then the native scheduler
    real, took = tapi._encode_images_budget, []

    def spy(*a):  # records whether the budget path returned the streams
        out = real(*a)
        took.append(out is not None)
        return out

    tapi._encode_images_budget = spy
    try:
        reset_counts()
        ers_b = pt.encode_images(ims, CONFIG_A, None, mbs, device=DEV,
                                 dtype=f32)
        torch.cuda.synchronize()
        nb = counts()
    finally:
        tapi._encode_images_budget = real
    check(took == [True], f"budget path returned nothing ({took})")
    check(all(v == 0 for v in nb.values()), f"budget path launches {nb}")
    dev_b = pt.encode_images_device(ims, CONFIG_A, None, mbs, device=DEV,
                                    dtype=f32)
    check([(e.encoded_bytes, e.max_n) for e in ers_b]
          == [(e.encoded_bytes, e.max_n) for e in dev_b],
          "encode_images (budget path) != encode_images_device")
    for streams in (ers, ers_b):
        imgs = pt.decode_images(streams, CONFIG_A, device=DEV)
        ref = pt.decode_images_device(streams, CONFIG_A, device=DEV)
        check(all(np.array_equal(a, b.cpu().numpy())
                  for a, b in zip(imgs, ref)),
              "decode_images != decode_images_device")
    # B6 alone on the batch's scaled float32 coefficients
    coeffs = _scaled_coeffs(tapi._device_batch(ims, DEV), CONFIG_A, None,
                            f32)[0].to(f32)
    q_stats = {}
    cmp_quantize(coeffs, CONFIG_A.quantization_scale, q_stats)
    # the same values one element into a buffer: x 4 bytes past a 16-byte
    # boundary, so the vectors load x 4 bytes at a time
    shifted = torch.empty(coeffs.numel() + 1, dtype=f32, device=DEV)
    shifted[1:] = coeffs.reshape(-1)
    print(json.dumps({
        "phase": "13 B6 alone on the A batch's scaled coefficients",
        "card": card(), "elements": coeffs.numel(),
        "bound_ms": coeffs.numel() * 11 / HBM_BYTES_PER_S * 1e3,
        **quantize_cold_warm(coeffs, CONFIG_A.quantization_scale),
        "offset_view": quantize_cold_warm(shifted[1:],
                                          CONFIG_A.quantization_scale),
    }))
    del coeffs, shifted
    t = {
        "encode_images_b6_path_ms": lambda: pt.encode_images(
            ims, CONFIG_A, None, None, device=DEV, dtype=f32),
        "encode_images_device_f32_ms": lambda: pt.encode_images_device(
            ims, CONFIG_A, None, None, device=DEV, dtype=f32),
        "encode_images_budget_path_ms": lambda: pt.encode_images(
            ims, CONFIG_A, None, mbs, device=DEV, dtype=f32),
        "encode_images_device_f32_budgets_ms": lambda: pt.encode_images_device(
            ims, CONFIG_A, None, mbs, device=DEV, dtype=f32),
        "decode_images_ms": lambda: pt.decode_images(
            ers_b, CONFIG_A, device=DEV),
        "decode_images_device_ms": lambda: pt.decode_images_device(
            ers_b, CONFIG_A, device=DEV),
    }
    ms = {k: median_ms(fn) for k, fn in t.items()}
    print(json.dumps({**host_batch_stages(ims, mbs, ers_b),
                      "phase": "13 stages of the host-scheduled batch"}))
    print(json.dumps({
        "phase": "13 host-scheduled batch at A", "batch": B,
        "timing": "median of 5, host clock to sync; decode_images returns "
                  "host arrays, decode_images_device device tensors",
        **ms,
        **{k.replace("_ms", "_images_per_s"): B / v * 1e3
           for k, v in ms.items()},
        "launches": {"b6_path": n6, "budget_path": nb},
        "streams_equal_encode_images_device": True,
        "images_equal_decode_images_device": True,
    }))
    return q_stats, n6["spiht_quantize_compact"], ers, ers_b


def sweep_cuts(nbytes, n=64):
    """n byte cuts of an nbytes stream: the first 9 and the last 9 (the
    last word among them), the rest spread between, seeded."""
    ends = set(range(9)) | set(range(nbytes - 8, nbytes + 1))
    rng = np.random.default_rng(14)
    mid = rng.choice(np.arange(9, nbytes - 8), n - len(ends), replace=False)
    return sorted(ends | {int(c) for c in mid})


def phase_prefix_sweep(er_a, er_b):
    """Phase 14: A's stream cut at 64 byte prefixes through B2, B2-log and
    B5 (the 64 prefixes as one batch), B's through B3 and batched B3, then
    random words through B3 and batched B3, each equal to its plain
    version (stat, LSP queues, rec, event log)."""
    n_cmp = 0
    for label, er, settings, level in (("A", er_a, CONFIG_A, None),
                                        ("B", er_b, CONFIG_B, 3)):
        c, h, w = er.c, er.h, er.w
        slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
        ll = (slices[0][1].stop, slices[0][2].stop)
        data = er.encoded_bytes
        cuts = sweep_cuts(len(data))
        check(len(cuts) == 64, f"{label}: {len(cuts)} cuts")
        for cut in cuts:
            cmp_decode(data[:cut], er.max_n, c, enc_h, enc_w, *ll)
            if label == "A":
                cmp_decode_log(data[:cut], er.max_n, c, enc_h, enc_w, *ll)
                n_cmp += 1
        _, name = cmp_decode_batch([data[:cut] for cut in cuts],
                                   [er.max_n] * len(cuts), c, enc_h, enc_w,
                                   *ll)
        n_cmp += len(cuts) + 1
        print(f"  {label}: {len(cuts)} prefixes of {len(data)} bytes "
              f"(cuts {cuts[:3]}..{cuts[-3:]}): "
              f"{'B2, B2-log' if label == 'A' else 'B3'} and {name} == plain")
    # random words at an odd LL: nodes committed or refined by several LSP
    # instances, with bits no encoder would write; stat (error included)
    # and rec equal the plain version's
    shape, ll, max_ns = (3, 19, 19), (5, 5), [4, 7, 11, 11]
    rng = np.random.default_rng(14)
    datas = [rng.integers(0, 256, 400, dtype=np.uint8).tobytes()
             for _ in max_ns]
    for data, mn in zip(datas, max_ns):
        words, nbits = decoder.words_tensor(data[: 100 * mn // 4], DEV)
        args = decoder.machine_args(words, nbits, mn, *shape, *ll)
        got, want = decoder.decode_seq(*args), decoder.decode_seq(*to_cpu(args))
        check(all(torch.equal(k.cpu(), p) for k, p in zip(got, want)),
              f"B3 on random words (max_n {mn}) != plain")
    words, nbits = decoder.words_batch(datas, DEV)
    args = decoder.batch_machine_args(words, nbits, max_ns, *shape, *ll)
    got = decoder.decode_seq_batch(*args)
    want = decoder.decode_seq_batch(*to_cpu(args))
    check(all(torch.equal(k.cpu(), p) for k, p in zip(got, want)),
          "batched B3 on random words != plain")
    n_cmp += len(max_ns) + 1
    print(f"  random words: {len(max_ns)} streams through B3 and batched B3 "
          "== plain")
    print(f"phase 14 ok: {n_cmp} exact comparisons")


def stream_bits(data: bytes):
    """A stream's bits, LSB-first."""
    return np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")


def cmp_encode_args(args):
    """B1 on the card vs its plain version on ``encode_machine``'s
    arguments as given (narrowed capacities, a clamped budget): words and
    stat exactly equal, the error code included. Returns the stat list."""
    kw, ks = encoder.encode_machine(*args)
    pw, ps = encoder.encode_machine(*to_cpu(args))
    check(ks.tolist() == ps.tolist(), f"B1 stat {ks.tolist()} != plain "
          f"{ps.tolist()}")
    check(torch.equal(kw.cpu(), pw), "B1 words != plain words")
    return ps.tolist()


def cmp_encode_batch_args(args):
    """B4 on the card vs its plain version on ``encode_machine_batch``'s
    arguments as given: words and stat rows exactly equal. Returns the
    stat rows."""
    kw, ks = encoder.encode_machine_batch(*args)
    pw, ps = encoder.encode_machine_batch(*to_cpu(args))
    check(ks.tolist() == ps.tolist(), "B4 stat != plain")
    check(torch.equal(kw.cpu(), pw), "B4 words != plain words")
    return ps.tolist()


def phase_encode_edges(im_a, im_b):
    """Phase 15: B1's and B4's stopping entry at full width. A's and B's
    coefficients at 64 budgets each (``sweep_cuts`` over the bits of the
    1 bpp stream), through B1 one by one and through B4 as one batch, each
    equal to its plain version and, as words, a prefix of the 1 bpp
    stream; then at A the queue capacities narrowed below the stream's
    need (error codes 2, 3, 4) and a budget clamped by a small word buffer
    (code 1), through B1 and B4, equal to the plain versions."""
    n_cmp = 0
    for label, im, settings, level in (("A", im_a, CONFIG_A, None),
                                        ("B", im_b, CONFIG_B, 3)):
        arr, ll_h, ll_w = forward(torch.as_tensor(im, device=DEV), settings,
                                  level)
        full_stats = {}
        full, _ = cmp_encode(arr, ll_h, ll_w, 512 * 512, full_stats)
        stat, nbits = full_stats["stat"], full_stats["stat"][0]
        ref = stream_bits(full)
        budgets = sweep_cuts(nbits)
        check(len(budgets) == 64, f"{label}: {len(budgets)} budgets")
        # cmp_encode holds the whole word buffer to the plain version's,
        # zeros past the stream included; the bits before are the stream's
        for mb in budgets:
            data, _ = cmp_encode(arr, ll_h, ll_w, mb)
            check(np.array_equal(stream_bits(data)[:mb], ref[:mb]),
                  f"{label} budget {mb}: not a prefix of the stream")
        got = cmp_encode_batch(
            arr.expand(len(budgets), *arr.shape).contiguous(), ll_h, ll_w,
            budgets)
        for (data, _), mb in zip(got, budgets):
            check(np.array_equal(stream_bits(data)[:mb], ref[:mb]),
                  f"{label} batch budget {mb}: not a prefix of the stream")
        n_cmp += len(budgets) + 2
        print(f"  {label}: {len(budgets)} budgets of {nbits} bits (cuts "
              f"{budgets[:3]}..{budgets[-3:]}): B1 and B4 == plain, each a "
              "prefix of the stream")
        if label != "A":
            continue
        # the queue errors: each capacity narrowed below its length at the
        # stop, alone (B1) and as a one-stream batch (B4)
        args = full_stats["args"]
        bargs = encoder.batch_machine_args(arr[None], ll_h, ll_w, [512 * 512])
        init = (args[3].numel(), args[4].numel(), 0)
        errs = []
        for which in range(3):
            caps = list(args[9])
            caps[which] = max(init[which], stat[2 + which] // 2)
            st = cmp_encode_args(args[:9] + (tuple(caps),) + args[10:])
            check(cmp_encode_batch_args(bargs[:8] + (tuple(caps),)
                                        + bargs[9:]) == [st],
                  "B4 at narrowed capacities != B1")
            check(cmp_encode_seq_args(args[:9] + (tuple(caps),)
                                      + args[10:])[1] == st,
                  "B7 at narrowed capacities != B1")
            errs.append(st[1])
        # a budget clamped to a 1000-word buffer
        clamped = args[:7] + (32000, True) + args[9:10] + (1000,)
        st = cmp_encode_args(clamped)
        check(cmp_encode_batch_args(bargs[:9] + (1000,)) == [st],
              "B4 with a clamped budget != B1")
        check(cmp_encode_seq_args(clamped)[1] == st,
              "B7 with a clamped budget != B1")
        errs.append(st[1])
        check(errs == [2, 3, 4, 1], f"A: error codes {errs}, want [2, 3, 4, 1]")
        n_cmp += 12
        print(f"  A: narrowed LIP, LIS, LSP and a clamped budget: error codes "
              f"{errs} on the card == plain, B4 == B7 == B1")
    print(f"phase 15 ok: {n_cmp} exact comparisons of B1, B4 and B7 with "
          "their plain versions")


# phase 16's geometries: (label, settings, level, input side), 1.0 bpp
LARGE = (
    ("A 3x2048^2", CONFIG_A, None, 2048),
    ("A 3x4096^2", CONFIG_A, None, 4096),
    # BASELINE.md round 5's geometry (enc 4284^2, LL 13x13: odd LL)
    ("A 3x4243^2", CONFIG_A, None, 4243),
    ("B 3x4096^2", CONFIG_B, 3, 4096),  # enc 4120^2, LL 519x519
)
# phase 16's batch: past one wave of either batched kernel, 660 streams
# of B4 (five 256-thread blocks an SM at 48 registers) and 792 of B5 (six,
# at 40)
WAVE = 800


def peak_gb(fn):
    """(fn(), the device memory peak it reached in GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30


def launched(name):
    """Check that the path just driven launched ``name`` once and no other
    kernel; the counts are set to 0 again."""
    n = counts()
    want = {k: 0 for k in n}
    want[name] = 1
    check(n == want, f"launches {n}, want {want}")
    reset_counts()


def program_launch(name, kind, inverse=None):
    """Check that the path just driven launched ``name`` as the program of
    ``kind`` (``key[0]``) it last used launches it, the inverse's
    ``inverse`` (kernel -> launches), and no other kernel: ``name`` twice
    on that key's first call (the warm-up's launch and the capture's), not
    at all on a replay; the counts are set to 0 again. Returns the
    program."""
    prog = [p for p in torch_transform.programs() if p.key[0] == kind][-1]
    n = counts()
    want = {k: 0 for k in n}
    want[name] = 2 if prog.replays == 1 else 0
    want.update(inverse or {})
    check(prog.replays >= 1 and n == want,
          f"launches {n}, want {want} ({prog.replays} replays of {kind})")
    reset_counts()
    return prog


def phase_large():
    """Phase 16: the large geometries (``LARGE``) at 1.0 bpp, each through
    encode_image_device (B1), then at the full stream and at a byte prefix
    through decode (B2, or B3 at odd LL) and decode_with_metadata (B2-log
    or B3-log), each path with the counts set to 0 just before and read
    just after; streams, rec and traces equal to the native scheduler's.
    Prints each geometry's kernel ms and device memory peaks."""
    nat = native.load()
    big = image(16, (3, 4243, 4243))
    for label, settings, level, side in LARGE:
        im = np.ascontiguousarray(big[:, :side, :side])
        slices, enc_h, enc_w = get_slices_and_h_w(side, side, settings, level)
        geo = (3, enc_h, enc_w, slices[0][1].stop, slices[0][2].stop)
        wire = slices_to_wire(slices)
        odd = decoder.has_duplicate_parents(*geo[1:])
        dec, log = (("spiht_decode_seq", "spiht_decode_seq_log") if odd else
                    ("spiht_decode_lsp", "spiht_decode_lsp_log"))
        budget = side * side
        t0 = time.perf_counter()
        reset_counts()
        er, enc_gb = peak_gb(lambda: pt.encode_image_device(
            im, settings, level, budget, device=DEV))
        program_launched("spiht_encode")
        arr, _, _ = forward(torch.as_tensor(im, device=DEV), settings, level)
        want = nat.encode(arr.cpu().numpy(), *geo[3:], budget)
        check((er.encoded_bytes, er.max_n) == want,
              f"{label}: B1's stream != the native scheduler's")
        data, mn = er.encoded_bytes, er.max_n
        cut = len(data) // 3 + 5
        gb = {"encode_image_device": enc_gb}
        for what, d in (("full", data), ("prefix", data[:cut])):
            rec, gb[f"decode_{what}"] = peak_gb(
                lambda: decoder.decode(d, mn, *geo, device=DEV))
            launched(dec)
            check(np.array_equal(rec.cpu().numpy(), nat.decode(d, mn, *geo)),
                  f"{label} {what}: {dec}'s rec != the native scheduler's")
            del rec
            (trec, meta), gb[f"trace_{what}"] = peak_gb(
                lambda: meta_expand.decode_with_metadata(
                    d, mn, *geo, *wire, DEV))
            program_launch(log, "trace")
            nrec, nmeta = nat.decode_with_metadata(d, mn, *geo, *wire)
            check(np.array_equal(trec.cpu().numpy(), nrec)
                  and np.array_equal(meta.cpu().numpy(), nmeta),
                  f"{label} {what}: the trace != the native scheduler's")
            del trec, meta, nrec, nmeta
        words, nbits = decoder.words_tensor(data, DEV)
        dargs = decoder.machine_args(words, nbits, mn, *geo)
        eargs = encoder.machine_args(arr, *geo[3:], budget)
        ms = {
            "spiht_encode": time_kernel(encoder.encode_machine, eargs),
            dec: time_kernel(KERNELS[dec]["wrapper"], dargs),
            log: time_kernel(KERNELS[log]["wrapper"], dargs),
        }
        b7 = None
        if side == 2048:  # B7, its ring wrapped thousands of times
            st = {}
            kw, _ = cmp_encode_seq_args(eargs, st)
            check(encoder.stream_bytes(kw, st["stat"][0]) == data,
                  f"{label}: B7's stream != B1's")
            b7 = seq_timing(label + " 1.0 bpp", st)
        trace_ms = median_ms(lambda: meta_expand.decode_with_metadata(
            data, mn, *geo, *wire, DEV), reps=3)
        reset_counts()
        print(json.dumps({
            "phase": f"16 {label}", "geometry": list(geo[:3]),
            "ll": list(geo[3:]), "cells": 3 * enc_h * enc_w,
            "odd_ll": odd, "bits": len(data) * 8, "prefix_bytes": cut,
            "max_n": mn, "kernel_ms": ms, "b7": b7,
            "trace_ms_median_of_3": trace_ms,
            "device_peak_gib": gb,
            "equal_native_stream_rec_trace": True,
            "phase_s": time.perf_counter() - t0,
        }))
        del arr, words, dargs, eargs
    torch.cuda.empty_cache()


def phase_wave(ims16):
    """Phase 16, batch: WAVE A streams (phase 8's 16 images, each stream
    its own budget) through encode_images_device (B4) and
    decode_images_device (B5), the counts set to 0 just before and read
    just after; stream by stream equal to B1 and, as rec, to B2. These run
    as equal parts of at most batch_bound images through one program a
    direction: a second call replays them with no capture, and so does a
    round trip's second call at the bound. One B4 launch and one B5
    launch of all WAVE streams, outside the programs, equal B1's streams
    and B2's rec. Prints B4 and B5 alone at this batch and the device
    memory peak."""
    c, h, w = ims16[0].shape
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, CONFIG_A, None)
    ll = (slices[0][1].stop, slices[0][2].stop)
    geo = (c, enc_h, enc_w, *ll)
    ims = [ims16[b % 16] for b in range(WAVE)]
    mbs = [262144 - 97 * b for b in range(WAVE)]  # 1.0 down to 0.74 bpp
    def round_trip():
        ers = pt.encode_images_device(ims, CONFIG_A, None, mbs, device=DEV)
        return ers, pt.decode_images_device(ers, CONFIG_A, device=DEV)

    torch_transform.clear_programs()
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    with Captures() as caps:
        (ers, outs), gb = peak_gb(round_trip)
    wall = (time.perf_counter() - t0) * 1e3
    n = counts()
    # equal parts of at most batch_bound images through one program a
    # direction: its first call launches B4 or B5 twice (warm-up and
    # capture), its replays not at all
    want = {k: 0 for k in n}
    want.update({"spiht_encode_batch": 2, "spiht_decode_lsp_batch": 2,
                 **inverse_launches(h, w, CONFIG_A, None)})
    wave_progs = [(p.key[0], p.key[2], p.replays)
                  for p in torch_transform.programs()]
    check(n == want and caps.kinds == ["encode_batch", "decode_batch"],
          f"wave batch: launches {n}, want {want}; captures {caps.kinds}")
    check(len(outs) == WAVE and all(bool(torch.isfinite(o).all())
                                    for o in outs), "wave batch images")
    # a second call of the split batch: replays of the same two programs
    reset_counts()
    with Captures() as again:
        ers2, outs2 = round_trip()
    n2 = nonzero()
    check(not again.kinds and not n2 and [e.encoded_bytes for e in ers2]
          == [e.encoded_bytes for e in ers]
          and all(torch.equal(a, b) for a, b in zip(outs, outs2)),
          f"wave batch, second call: captures {again.kinds}, launches {n2}, "
          "or results")
    del outs, outs2, ers2
    # a round trip at the bound, twice: both programs stay cached together
    bound = torch_transform.batch_bound((c, h, w), torch.device(DEV))
    at_bound = []
    for _ in range(2):
        with Captures() as caps_b:
            eb = pt.encode_images_device(ims[:bound], CONFIG_A, None,
                                         mbs[:bound], device=DEV)
            ob = pt.decode_images_device(eb, CONFIG_A, device=DEV)
        at_bound.append((caps_b.kinds, [e.encoded_bytes for e in eb], ob))
    (k1, d1, o1), (k2, d2, o2) = at_bound
    check(k1 == ["encode_batch", "decode_batch"] and not k2
          and d1 == d2 == [e.encoded_bytes for e in ers[:bound]]
          and all(torch.equal(a, b) for a, b in zip(o1, o2)),
          f"round trip at the bound {bound}: captures {k1}, then {k2}, or "
          "results")
    del at_bound, o1, o2, ob
    reset_counts()
    arrs16, _, _ = forward(torch.as_tensor(np.stack(ims16), device=DEV),
                           CONFIG_A, None)
    datas = [er.encoded_bytes for er in ers]
    mns = [er.max_n for er in ers]
    rec_b = decoder.decode_batch(datas, mns, *geo, device=DEV)
    for b in range(WAVE):
        args = encoder.machine_args(arrs16[b % 16], *ll, mbs[b])
        kw, ks = encoder.encode_machine(*args)
        ks = encoder.check_stat(ks, "spiht_encode")
        check((encoder.stream_bytes(kw, ks[0]), int(args[6]))
              == (datas[b], mns[b]), f"wave stream {b}: B4 != B1")
        one = decoder.decode(datas[b], mns[b], *geo, device=DEV)
        check(torch.equal(one, rec_b[b]), f"wave stream {b}: B5 != B2")
    # one B4 launch of all WAVE streams, past one wave, against B1's
    eargs = encoder.batch_machine_args(
        arrs16.repeat(WAVE // 16, 1, 1, 1), *ll, mbs)
    kw, ks = encoder.encode_machine_batch(*eargs)
    totals = [r[0] for r in encoder.check_stat(ks, "spiht_encode_batch")]
    check(encoder.batch_stream_bytes(kw, totals) == datas
          and eargs[6].tolist() == mns,
          f"wave: one B4 launch of {WAVE} streams != B1's")
    del kw, ks
    reset_counts()
    words, nbits = decoder.words_batch(datas, DEV)
    dargs = decoder.batch_machine_args(words, nbits, mns, *geo)
    print(json.dumps({
        "phase": "16 A batch past one wave", "batch": WAVE,
        "streams_per_wave": {"B4": 660, "B5": 792}, "bytes_min_max": [
            min(map(len, datas)), max(map(len, datas))],
        "launches": n, "round_trip_ms_host_clock": wall,
        "programs_captured": caps.kinds, "batch_bound": bound,
        "programs_batch_replays": wave_progs,
        "second_call_captures": again.kinds,
        "round_trip_at_bound_captures": [k1, k2],
        "b4_one_launch_of_wave_equal_b1": True,
        "device_peak_gib": gb,
        "kernel_ms": {
            "spiht_encode_batch": time_kernel(encoder.encode_machine_batch,
                                              eargs),
            "spiht_decode_lsp_batch": time_kernel(decoder.decode_lsp_batch,
                                                  dargs)},
        "streams_equal_b1_and_rec_equal_b2": True,
        "phase_s": time.perf_counter() - t0,
    }))
    reset_counts()
    del arrs16, rec_b, eargs, dargs, words
    torch_transform.clear_programs()
    torch.cuda.empty_cache()


SPIKE_K = 2000  # phases 17 and 18: steps (S5: block iterations, S6: windows)


def phase_spikes():
    """Phase 17: the dependent-chain spikes through their tools' entry
    points at small K (every variant and table size of the tools, K at
    most SPIKE_K), the counts set to 0 just before and read just after;
    then each spike kernel vs its plain version in every variant."""
    plan = [(kind, n, chains, min(k, SPIKE_K))
            for kind, n, chains, k in spike_hbm_table.PLAN]
    reset_counts()
    seq = spike_pallas_seq.run(SPIKE_K, check=False)
    hbm = spike_hbm_table.run(plan, check=False, reps=1)
    torch.cuda.synchronize()
    n = counts()
    check(all(n[k] > 0 for k in ("spike_seq", "spike_table", "spike_fire"))
          and not any(v for k, v in n.items() if not k.startswith("spike")),
          f"spikes: launches {n}")
    stats = {}
    tseq = spike_pallas_seq
    for rows, shared in ((tseq.ROWS, False),
                         (tseq.SMEM_WORDS // tseq.LANES, True)):
        words = torch.as_tensor(tseq.words_of(rows), device=DEV)
        for rw in (False, True):
            args = (words, SPIKE_K, rw, shared)
            out, sc = tseq.seq_chain(*args)
            (pout, psc), plain_ms = timed(tseq.seq_chain, *to_cpu(args))
            err = max_abs(out.cpu().numpy(), pout.numpy())
            check(err == 0 and (not rw or torch.equal(sc.cpu(), psc)),
                  f"spike_seq (rw {rw}, shared {shared}) != plain")
            if not (rw or shared):
                stats["spike_seq"] = dict(
                    args=args, plain_ms=plain_ms, max_abs_err=err,
                    accesses=SPIKE_K, out_bytes=8)
    tables = {}
    for kind, n_log2, chains, k in plan:
        if n_log2 not in tables:
            tables[n_log2] = torch.as_tensor(
                spike_hbm_table.permutation(n_log2), device=DEV)
        if kind == "fire":
            name, args = "spike_fire", (tables[n_log2], k, chains)
        else:
            name, args = "spike_table", (tables[n_log2], k, chains,
                                         kind == "shared")
        fn = KERNELS[name]["wrapper"]
        out = fn(*args)
        pout, plain_ms = timed(fn, *to_cpu(args))
        err = max_abs(out.cpu().numpy(), pout.numpy())
        check(err == 0, f"{name} ({kind} 2^{n_log2}, {chains}) != plain")
        if (kind, n_log2, chains) in (("global", 25, 1), ("fire", 25, 8)):
            stats[name] = dict(
                args=args, plain_ms=plain_ms, max_abs_err=err,
                accesses=k * chains * (4 if kind == "fire" else 1),
                out_bytes=4 * spike_hbm_table.LANES)
    print(json.dumps({
        "phase": "17 dependent-chain spikes at small K", "launches": n,
        "spike_pallas_seq": seq, "spike_hbm_table": hbm,
        "kernels_equal_plain": True,
    }))
    reset_counts()
    return stats, n


MACHINE_SPIKES = ("spike_machine", "spike_ilp", "spike_block", "spike_token")


def cmp_machine(fn, words, k, state, *args):
    """S3/S4 on the card vs the plain version from a fresh INT32_MIN state:
    the output row and the state after it. Returns the stats."""
    mach = spike_pallas_machine
    state.fill_(mach.INT32_MIN)
    out = fn(words, k, state, *args)
    cstate = mach.new_state(state.shape[0], state.shape[2])
    pout, plain_ms = timed(fn, words.cpu(), k, cstate, *args)
    err = max_abs(out.cpu().numpy(), pout.numpy())
    check(err == 0 and torch.equal(state.cpu(), cstate),
          f"{fn.__name__} (B {state.shape[0]} {args}) != plain")
    return dict(args=(words, k, state, *args), plain_ms=plain_ms,
                max_abs_err=err, accesses=6 * k * state.shape[0],
                out_bytes=4 * pout.numel())


def phase_machine_spikes():
    """Phase 18: the machine and block spikes through their tools' entry
    points at small K (S3 at every B in both layouts, S6 with both first),
    the counts set to 0 just before and read just after; then every
    variant vs its plain version: S3 at each B and layout, S4, S5, and
    each of S6's kinds."""
    mach, ilp = spike_pallas_machine, spike_pallas_ilp
    blk, tok = spike_pallas_block, spike_token_matmul
    reset_counts()
    runs = {
        "spike_pallas_machine": mach.run(SPIKE_K, check=False),
        "spike_pallas_ilp": ilp.run(SPIKE_K, check=False),
        "spike_pallas_block": blk.run(SPIKE_K, check=False),
        "spike_token_matmul": tok.run(SPIKE_K, check=False),
    }
    torch.cuda.synchronize()
    n = counts()
    check(all(n[k] > 0 for k in MACHINE_SPIKES)
          and not any(v for k, v in n.items() if k not in MACHINE_SPIKES),
          f"machine spikes: launches {n}")
    stats = {}
    words = torch.as_tensor(mach.words_of(), device=DEV)
    stats["spike_machine"] = cmp_machine(
        mach.machine, words, SPIKE_K,
        mach.new_state(1, mach.state_size(3.4), DEV))
    for b in mach.CHAINS:
        state = mach.new_state(b, mach.state_size(2.0), DEV)
        for layout in ilp.LAYOUTS:
            st = cmp_machine(ilp.chains, words, SPIKE_K, state, layout)
            if (b, layout) == (8, "ilp"):
                stats["spike_ilp"] = st
        del state
    mag = torch.as_tensor(blk.mag_of(), device=DEV)
    got = blk.block(mag, SPIKE_K)
    want, plain_ms = timed(blk.block, mag.cpu(), SPIKE_K)
    err = max(max_abs(g.cpu().numpy(), w.numpy()) for g, w in zip(got, want))
    check(err == 0, "spike_block != plain")
    pos = int(want[0][0, 0])
    stats["spike_block"] = dict(
        args=(mag, SPIKE_K), plain_ms=plain_ms, max_abs_err=err,
        # a mag row read, 128 queue appends an iteration; the words written
        bytes=SPIKE_K * 2 * 4 * blk.LANES + (pos + 7) // 8 + 16,
        ops=OPS_PER_BIT * blk.LANES * SPIKE_K, ops_per_s=SCALAR_OPS_PER_S)
    x = torch.as_tensor(tok.x_of(), device=DEV)
    tok_ms = {}
    for kind in tok.KINDS:
        out = tok.token_heads(x, SPIKE_K, kind)
        pout, plain_ms = timed(tok.token_heads, x.cpu(), SPIKE_K, kind)
        err = max_abs(out.cpu().numpy(), pout.numpy())
        check(err == 0, f"spike_token ({kind}) != plain")
        tok_ms[kind] = time_kernel(tok.token_heads, (x, SPIKE_K, kind))
        if kind == "mma_bf16":
            stats["spike_token"] = dict(
                args=(x, SPIKE_K, kind), plain_ms=plain_ms, max_abs_err=err,
                bytes=4 * x.numel() + 4,
                ops=7 * 2 * tok.LANES**3 * SPIKE_K,
                ops_per_s=BF16_FLOPS_PER_S)
    # each kind's bound: the mma kinds by their products at the dense
    # tensor-core rate, scan by its 64-bit operations at the scalar rate
    bounds = {
        "scan": SCAN_OPS_PER_WINDOW * SPIKE_K / SCALAR_OPS_PER_S * 1e3,
        "mma_tf32": 7 * 2 * tok.LANES**3 * SPIKE_K / TF32_FLOPS_PER_S * 1e3,
        "mma_bf16": 7 * 2 * tok.LANES**3 * SPIKE_K / BF16_FLOPS_PER_S * 1e3,
    }
    print(json.dumps({
        "phase": "18 machine and block spikes at small K", "launches": n,
        **runs, "spike_token_ms_by_kind": tok_ms,
        "spike_token_bound_ms_by_kind": bounds, "kernels_equal_plain": True,
    }))
    reset_counts()
    return stats, n


# ---------------------------------------------------------------------------
# phase 19: the host surface on the card
# ---------------------------------------------------------------------------

# the bit machines and the fused quantize pass that the host surface runs
HOST_SURFACE_KERNELS = (
    "spiht_encode", "spiht_decode_lsp", "spiht_decode_seq",
    "spiht_encode_batch", "spiht_decode_lsp_batch", "spiht_decode_seq_batch",
    "spiht_quantize_compact",
)
# configuration A as command-line flags (the CLI's auto level is 6 at
# 512^2, the same geometry as level=None)
A_FLAGS = ["--color-model", "ipt", "--per-channel-quant-scales",
           "100,20,20", "--quantization-scale", "1"]


def boundary_agreement(label, got, want, ref_float) -> int:
    """The boundary rule: two int32 coefficient arrays may differ only at
    an entry where the reference float lies within 1e-9 * max(1, |v|) of
    an integer (an ulp of pow, exp, log1p or sqrt moving a truncation).
    ``ref_float`` is the array or a callable that computes it (only if
    needed). Returns the count of such entries; fails on any other
    difference."""
    diff = np.asarray(got) != np.asarray(want)
    if not diff.any():
        return 0
    ref = np.asarray(ref_float() if callable(ref_float) else ref_float)
    near = np.abs(ref - np.round(ref)) <= 1e-9 * np.maximum(1.0, np.abs(ref))
    bad = int((diff & ~near).sum())
    check(bad == 0, f"{label}: {bad} coefficients differ off an integer "
                    "boundary")
    return int(diff.sum())


def cpu_scaled(im, settings, level):
    """The port's CPU transform before truncation: the reference floats
    (float64 coefficients times the quantization scale)."""
    ref, _, _ = _scaled_coeffs(torch.as_tensor(im), settings, level,
                               torch.float64)
    return ref * float(settings.quantization_scale)


def launches_since(before):
    now = counts()
    return {k: now[k] - before[k] for k in HOST_SURFACE_KERNELS}


def unconverged_pixels(settings, rec, diff, cpu_img, h, w):
    """Where the card's decoded image is more than 1e-9 from the CPU's:
    allowed only at pixels where the CPU's own colour inverse did not
    converge, i.e. converting its result back to the model misses the
    decoded model-space value by more than 1e-6 (an out-of-gamut value,
    where OSA UCS's fixed Newton steps land wherever an ulp sends them).
    Returns the pixel count, and how far a 1-ulp relative change of the
    model-space input moves the CPU's own result at those pixels."""
    name = settings.color_model
    model = inverse(rec, h, w, None,
                    dataclasses.replace(settings, color_model=None))
    resid = (torch_models.convert(cpu_img, "RGB", name) - model).abs()
    off = (diff > 1e-9).any(dim=0)
    converged = resid.amax(dim=0) <= 1e-6
    bad = int((off & converged).sum())
    check(bad == 0, f"{name}: {bad} converged pixels more than 1e-9 from "
                    "the CPU inverse")
    shifted = torch_models.convert(model * (1 + 2.0**-52), name, "RGB")
    return {
        "pixels_where_the_inverse_did_not_converge": int(off.sum()),
        "cpu_shift_there_by_one_ulp_of_input": float(
            (shifted - cpu_img).abs().amax(dim=0)[off].max()),
    }


def phase_colour_models(im, smi):
    """Phase 19a: every colour model at full width on the card."""
    c, h, w = im.shape
    mb = h * w
    n_boundary, rows = 0, []
    for name in sorted(torch_models.REFERENCE_MODELS):
        s = pt.SpihtSettings(color_model=name)
        slices, enc_h, enc_w = get_slices_and_h_w(h, w, s, None)
        ll = (slices[0][1].stop, slices[0][2].stop)
        er = pt.encode_image_device(im, s, None, mb, device=DEV)
        img = pt.decode_image_device(er, s, device=DEV)
        check(tuple(img.shape[:1]) == (c,) and bool(torch.isfinite(img).all()),
              f"{name}: decoded image not finite")
        # the card's coefficients against the CPU transform
        arr, _, _ = forward(torch.as_tensor(im, device=DEV), s, None)
        ref = cpu_scaled(im, s, None)
        nb = boundary_agreement(name, arr.cpu().numpy(),
                                ref.to(torch.int32).numpy(), ref.numpy())
        n_boundary += nb
        # stream and rec against the plain machines
        data, max_n = cmp_encode(arr, *ll, mb)
        check(data == er.encoded_bytes and max_n == er.max_n,
              f"{name}: stream != plain B1's on the card's coefficients")
        rec, _ = cmp_decode(er.encoded_bytes, er.max_n, c, enc_h, enc_w, *ll)
        cpu_img = inverse(rec, h, w, None, s)
        diff = (img.cpu() - cpu_img).abs()
        err = float(diff.max())
        unconverged = {}
        if err > 1e-9:
            unconverged = unconverged_pixels(s, rec, diff, cpu_img, h, w)
        # float32 working dtype: printed, not held (see PERF.md)
        arr32, _, _ = forward(torch.as_tensor(im, device=DEV), s, None,
                              torch.float32)
        er32 = pt.encode_image_device(im, s, None, mb, device=DEV,
                                      dtype=torch.float32)
        img32 = pt.decode_image_device(er32, s, device=DEV,
                                       dtype=torch.float32)
        row = {
            "model": name, "bytes": len(er.encoded_bytes),
            "max_n": er.max_n,
            "psnr_db": metrics.psnr(im, img.cpu().numpy()),
            "boundary_coeffs_card_vs_cpu": nb,
            "image_max_abs_diff_card_vs_cpu": err, **unconverged,
            "encode_ms": median_ms(lambda: pt.encode_image_device(
                im, s, None, mb, device=DEV), reps=3),
            "decode_ms": median_ms(lambda: pt.decode_image_device(
                er, s, device=DEV), reps=3),
            "f32_coeffs_differing_from_f64": int((arr32 != arr).sum()),
            "f32_image_finite": bool(torch.isfinite(img32).all()),
        }
        print(json.dumps({"phase": "19a", **row}))
        rows.append(row)
    print(json.dumps({
        "phase": f"19a colour models, {c}x{h}x{w}, 1.0 bpp, float64",
        "models": len(rows), "card": smi,
        "timing": "median of 3, host clock to sync",
        "psnr": "metrics.psnr, the reconstruction clipped to [0, 1]",
        "boundary_coeffs_total": n_boundary,
        "streams_equal_plain": True,
        "images_within_1e-9_of_cpu_where_the_inverse_converged": True,
    }))


def phase_backends(im_a, im_b, er_a, er_b, ims_a, mbs_a, ers_a, smi):
    """Phase 19b: the transform backends behind encode_image /
    decode_image at A and B, the host-scheduled batch under native and
    torch, and the float32 host-scheduled path (B6) with Oklab. Returns
    the A streams of each backend."""
    out = {}
    for label, im, s, level, er_dev in (
        ("A", im_a, CONFIG_A, None, er_a), ("B", im_b, CONFIG_B, 3, er_b),
    ):
        h, w = im.shape[1:]
        mb = h * w
        ll = _ll(h, w, s, level)
        arrs, ers, imgs, ms = {}, {}, {}, {}
        for b in ("numpy", "native", "torch"):
            host_transform._BACKEND = b
            arr = host_transform.forward(im, s, level, DEV)[0]
            arrs[b] = arr.cpu().numpy() if isinstance(arr, torch.Tensor) \
                else arr
            ers[b] = pt.encode_image(im, s, level, mb, device=DEV)
            imgs[b] = pt.decode_image(ers[b], s, device=DEV)
            ms[f"{b}_encode_ms"] = median_ms(lambda: pt.encode_image(
                im, s, level, mb, device=DEV), reps=3)
            ms[f"{b}_decode_ms"] = median_ms(lambda: pt.decode_image(
                ers[b], s, device=DEV), reps=3)
        check(ers["torch"].encoded_bytes == er_dev.encoded_bytes,
              f"{label}: encode_image under torch != encode_image_device")
        bound = {}
        for b in ("native", "torch"):
            bound[b] = boundary_agreement(
                f"{label} {b} vs numpy", arrs[b], arrs["numpy"],
                lambda: cpu_scaled(im, s, level).numpy())
            if bound[b] == 0:
                check(ers[b].encoded_bytes == ers["numpy"].encoded_bytes,
                      f"{label}: {b} stream != numpy stream")
                err = float(np.abs(imgs[b] - imgs["numpy"]).max())
                check(err <= 1e-9, f"{label}: {b} image {err} from numpy's")
            else:  # a flipped truncation: the stream of its own coefficients
                check(ers[b].encoded_bytes == pt.encode(
                    arrs[b], *ll, mb, device=DEV)[0],
                    f"{label}: {b} stream != B1 on its coefficients")
        out[label] = {b: er.encoded_bytes for b, er in ers.items()}
        print(json.dumps({
            "phase": f"19b transform backends at {label}", "card": smi,
            "timing": "median of 3, host clock to sync",
            "boundary_coeffs_vs_numpy": bound, **ms,
            "streams_equal": {b: ers[b].encoded_bytes
                              == ers["numpy"].encoded_bytes
                              for b in ("native", "torch")},
        }))

    # the host-scheduled batch at A (phase 8's images and budgets)
    h, w = ims_a[0].shape[1:]
    dev_imgs = [x.cpu().numpy() for x in pt.decode_images_device(
        ers_a, CONFIG_A, device=DEV)]
    batch = {}
    for b in ("native", "torch"):
        host_transform._BACKEND = b
        ers = pt.encode_images(ims_a, CONFIG_A, None, mbs_a, device=DEV)
        imgs = pt.decode_images(ers, CONFIG_A, device=DEV)
        n_bound = 0
        for i, (er, want) in enumerate(zip(ers, ers_a)):
            if er.encoded_bytes == want.encoded_bytes:
                err = float(np.abs(imgs[i] - dev_imgs[i]).max())
                check(err <= 1e-9, f"batch {b} image {i}: {err}")
                continue
            # only the host transform may flip a truncation: its
            # coefficients against the card's under the boundary rule, and
            # the stream that of its own coefficients
            check(b == "native", f"batch torch stream {i} != device's")
            arr = host_transform.forward_native(ims_a[i], CONFIG_A, None)[0]
            card, _, _ = forward(torch.as_tensor(ims_a[i], device=DEV),
                                 CONFIG_A, None)
            n_bound += boundary_agreement(
                f"batch {b} stream {i}", arr, card.cpu().numpy(),
                lambda: cpu_scaled(ims_a[i], CONFIG_A, None).numpy())
            check(er.encoded_bytes == pt.encode(
                arr, *_ll(h, w, CONFIG_A, None), mbs_a[i], device=DEV)[0],
                f"batch native stream {i} != B1 on its coefficients")
        batch[b] = {
            "boundary_coeffs": n_bound,
            "encode_images_ms": median_ms(lambda: pt.encode_images(
                ims_a, CONFIG_A, None, mbs_a, device=DEV), reps=3),
            "decode_images_ms": median_ms(lambda: pt.decode_images(
                ers, CONFIG_A, device=DEV), reps=3),
        }
    # B6: the float32 host-scheduled path with a new colour model
    host_transform._BACKEND = "torch"
    ok = dataclasses.replace(CONFIG_A, color_model="oklab")
    torch_transform.clear_programs()
    before = counts()
    ers6 = pt.encode_images(ims_a, ok, None, None, device=DEV,
                            dtype=torch.float32)
    torch.cuda.synchronize()
    n6 = launches_since(before)
    # a compact program's first call: the warm-up's launch and the capture's
    check(n6["spiht_quantize_compact"] == 2,
          f"Oklab B6 path launches: {n6}")
    dev6 = pt.encode_images_device(ims_a, ok, None, None, device=DEV,
                                   dtype=torch.float32)
    check([(e.encoded_bytes, e.max_n) for e in ers6]
          == [(e.encoded_bytes, e.max_n) for e in dev6],
          "Oklab float32 encode_images != encode_images_device")
    print(json.dumps({
        "phase": "19b host-scheduled batch at A, 16 images", "card": smi,
        "timing": "median of 3, host clock to sync", **batch,
        "oklab_f32_b6_path": {"launches": n6, "streams_equal_device": True,
                              "bytes": sum(len(e.encoded_bytes)
                                           for e in ers6)},
    }))
    return out["A"]


def _ll(h, w, settings, level):
    slices, _, _ = get_slices_and_h_w(h, w, settings, level)
    return slices[0][1].stop, slices[0][2].stop


def phase_cli(im_a, ims_a, streams_a, smi):
    """Phase 19c: the command line's array cores on the card at A."""
    h, w = im_a.shape[1:]
    mb = h * w
    level = cli._auto_level(h, w)

    def args(*argv):
        return cli.build_parser().parse_args(
            list(argv) + A_FLAGS + ["--device", DEV])

    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("device", "native"):
            er, rec = cli.run_encode_decode(
                im_a, args("encode-decode", "a.png", "--backend", backend))
            want = streams_a["torch" if backend == "device" else backend]
            check(er.encoded_bytes == want,
                  f"cli encode-decode --backend {backend}: stream differs")
            check(rec.shape == im_a.shape and np.isfinite(rec).all(),
                  f"cli encode-decode --backend {backend}: image")
        path = os.path.join(tmp, "a.spiht")
        er = cli.run_encode(im_a, args("encode", "a.png", path,
                                       "--backend", "torch"))
        check(er.encoded_bytes == streams_a["torch"], "cli encode: stream")
        back = cli._read_stream(path)
        check(back == er, "cli stream file round trip")
        rec, _ = cli.run_decode(back, args("decode", path, "a.png",
                                           "--backend", "torch"))
        want = pt.decode_image_device(er, CONFIG_A, device=DEV).cpu().numpy()
        check(np.array_equal(rec, want[:, :h, :w]),
              "cli decode != decode_image_device")
        plan = cli.run_plan(im_a, args("plan", "a.png", "--backend", "torch"))
        want = plan_image(im_a, CONFIG_A, level, mb, device=DEV)
        want["planned_bpp"] = want["total_bits"] / (h * w)
        check(plan == want, "cli plan != plan_image")
        full = pt.encode_image_device(im_a, CONFIG_A, level, None,
                                      device=DEV)
        check((len(full.encoded_bytes) - 1) * 8 < plan["total_bits"]
              <= len(full.encoded_bytes) * 8,
              f"plan total {plan['total_bits']} bits vs the full stream's "
              f"{len(full.encoded_bytes)} bytes")
        points = cli.run_sweep(im_a, args("sweep", "a.png", "--bpps",
                                          "0.25,0.5,1.0", "--backend",
                                          "torch"))
        top = points[-1][1].encoded_bytes
        check(top == streams_a["torch"], "cli sweep at 1.0 bpp: stream")
        for bpp, e, _ in points:
            check(top[: len(e.encoded_bytes)] == e.encoded_bytes,
                  f"cli sweep: {bpp} bpp stream not a prefix")
        before = counts()
        loaded = [(f"im{b}.png", ims_a[b]) for b in range(4)]
        ers = cli.run_batch(loaded, args("batch", "x.png", "--outdir", tmp,
                                         "--backend", "device"))
        torch.cuda.synchronize()
        nb = launches_since(before)
        # a batch program: B4 twice on its key's first call, else replayed
        first = [p for p in torch_transform.programs()
                 if p.key[0] == "encode_batch"][-1].replays == 1
        check(nb["spiht_encode_batch"] == (2 if first else 0)
              and nb["spiht_encode"] == 0,
              f"cli batch --backend device launches {nb}")
        for b, e in enumerate(ers):
            one = pt.encode_image_device(ims_a[b], CONFIG_A, level, mb,
                                         device=DEV)
            check(e.encoded_bytes == one.encoded_bytes
                  and cli._read_stream(os.path.join(tmp, f"im{b}.spiht"))
                  == e, f"cli batch stream {b} != B1's")
    print(json.dumps({
        "phase": "19c command line on the card at A", "card": smi,
        "subcommands": ["encode-decode (device, native)", "encode",
                        "decode", "plan", "sweep", "batch (device)"],
        "plan_total_bits": plan["total_bits"],
        "sweep_bytes": [len(e.encoded_bytes) for _, e, _ in points],
        "batch_launches": nb, "streams_equal": True,
    }))


def phase_host_surface(im_a, im_b, er_a, er_b, ims_a, mbs_a, ers_a):
    """Phase 19: (a), (b) and (c) above, with the counts set to 0 just
    before and read just after; the transform backend is put back."""
    smi = card()
    saved = host_transform._BACKEND
    t0 = time.perf_counter()
    reset_counts()
    try:
        phase_colour_models(im_a, smi)
        streams_a = phase_backends(im_a, im_b, er_a, er_b, ims_a, mbs_a,
                                   ers_a, smi)
        phase_cli(im_a, ims_a, streams_a, smi)
    finally:
        host_transform._BACKEND = saved
    torch.cuda.synchronize()
    n = {k: counts()[k] for k in HOST_SURFACE_KERNELS}
    for name in ("spiht_encode", "spiht_decode_lsp", "spiht_decode_seq",
                 "spiht_encode_batch", "spiht_quantize_compact"):
        check(n[name] >= 1, f"phase 19: {name} not launched")
    reset_counts()
    print(json.dumps({"phase": "19 host surface ok", "launches": n,
                      "seconds": time.perf_counter() - t0, "card": smi}))


# ---------------------------------------------------------------------------
# phase 20: the fallback machines on the card
# ---------------------------------------------------------------------------

# the three routing flags; "0" sends encode_device, decode_device(_batch)
# and decode_device_with_metadata to the fallback machines
FALLBACK_FLAGS = ("SPIHT_TPU_PALLAS_ENCODER", "SPIHT_TPU_PALLAS_DECODER",
                  "SPIHT_TPU_PALLAS_META")
# the byte prefix of A's and B's streams that the sequential machine (one
# list entry a step) decodes with the trace at full width
SEQ_PREFIX = 2048


def wall_ms(fn):
    """(fn(), host ms from a sync before to a sync after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def dyadic_wire(ll_h, ll_w, h, w, level):
    """(top_slice, other_slices) of a packing of ``level`` levels whose
    last level ends at (h, w)."""
    top = ((0, ll_h), (0, ll_w))
    other = []
    ah, aw = ll_h, ll_w
    for k in range(level):
        bh, bw = (h, w) if k == level - 1 else (2 * ah, 2 * aw)
        other.append((((0, ah), (aw, bw)), ((ah, bh), (0, aw)),
                      ((ah, bh), (aw, bw))))
        ah, aw = bh, bw
    return top, tuple(other)


def fallback_small_refs():
    """Phase 20 (a)'s cases with the kernels' outputs (B1; B2 or B3;
    B2-log or B3-log): an even-LL and an odd-LL geometry, each stream's
    full stream, a budget cut and three byte prefixes."""
    rng = np.random.default_rng(20)
    cases = []
    for shape, ll in (((2, 16, 16), (4, 4)), ((1, 19, 19), (5, 5))):
        arr = torch.as_tensor(
            (rng.standard_normal(shape) * 12).astype(np.int32), device=DEV)
        full, mn = encoder.encode(arr, *ll, FULL, device=DEV)
        cut, _ = encoder.encode(arr, *ll, 1001, device=DEV)
        wire = dyadic_wire(*ll, *shape[1:], 2)
        streams = [full, cut, full[:1], full[:7], full[: len(full) // 2]]
        recs = [decoder.decode(d, mn, *shape, *ll, device=DEV).cpu().numpy()
                for d in streams]
        traces = [tuple(x.cpu().numpy() for x in meta_expand.
                        decode_with_metadata(d, mn, *shape, *ll, *wire,
                                             torch.device(DEV)))
                  for d in streams]
        cases.append(dict(shape=shape, ll=ll, arr=arr, mn=mn, wire=wire,
                          streams=streams, recs=recs, traces=traces,
                          enc=[(full, mn), (cut, mn)]))
    return cases


def fallback_small(cases):
    """Phase 20 (a): each machine on the card equals its CPU run and the
    kernel's output. Returns the count of comparisons."""
    from spiht_tpu_torch.codec import device_decoder, device_encoder

    n_cmp = 0
    for case in cases:
        shape, ll, arr = case["shape"], case["ll"], case["arr"]
        if ll[0] % 2 == 0 and ll[1] % 2 == 0:
            for (want, mn), mb in zip(case["enc"], (FULL, 1001)):
                got = device_encoder.encode_device(arr, *ll, mb, device=DEV)
                cpu = device_encoder.encode_device(arr.cpu(), *ll, mb,
                                                   device="cpu")
                check(got == cpu == (want, mn),
                      f"{shape}: encode_device at {mb} != CPU or B1")
                n_cmp += 2
            got = device_encoder.encode_device_batch(
                torch.stack([arr, arr]), *ll, [FULL, 1001], device=DEV)
            check(got == case["enc"], f"{shape}: encode_device_batch != B1")
            n_cmp += 1
        else:
            try:
                device_encoder.encode_device(arr, *ll, FULL, device=DEV)
            except ValueError as e:
                check("even ll" in str(e), f"{shape}: {e}")
            else:
                raise AssertionError(f"{shape}: odd LL encoded")
        args = (*shape, *ll)
        for d, rec, (trec, tmeta) in zip(case["streams"], case["recs"],
                                         case["traces"]):
            got = device_decoder.decode_device(d, case["mn"], *args,
                                               device=DEV)
            cpu = device_decoder.decode_device(d, case["mn"], *args,
                                               device="cpu")
            check(np.array_equal(got, cpu) and np.array_equal(got, rec),
                  f"{shape} {len(d)} bytes: hybrid != CPU or kernel")
            got = device_decoder.decode_device_with_metadata(
                d, case["mn"], *args, *case["wire"], device=DEV)
            cpu = device_decoder.decode_device_with_metadata(
                d, case["mn"], *args, *case["wire"], device="cpu")
            check(all(np.array_equal(x, y) and np.array_equal(x, z)
                      for x, y, z in zip(got, cpu, (trec, tmeta))),
                  f"{shape} {len(d)} bytes: sequential != CPU or kernel")
            n_cmp += 4
        got = device_decoder.decode_device_batch(
            case["streams"], case["mn"], *args, device=DEV)
        check(np.array_equal(got, np.stack(case["recs"])),
              f"{shape}: decode_device_batch != kernel")
        n_cmp += 1
        print(f"  {shape} LL {ll}: {len(case['streams'])} streams "
              f"({[len(d) for d in case['streams']]} bytes): machines on "
              "the card == CPU == kernels")
    return n_cmp


def phase_fallback(im_a, im_b, er_a, er_b, ims_a, mbs_a, ers_a):
    """Phase 20: the XLA fallback machines (codec/device_encoder.py,
    codec/device_decoder.py) on the card under the flags set to 0, the
    counts set to 0 just before and read just after: (a) at small
    geometries, equal to their CPU runs and to the kernels; (b) at full
    width, the sorted-space encoder equal to B1 at A and raising at B's
    odd LL, the hybrid decoder equal to B2 at A and B3 at B, and the
    sequential machine's rec and trace equal to B2-log's at A and
    B3-log's at B on a SEQ_PREFIX-byte prefix; (c) phase 8's 16 A images
    through encode_device_batch (equal to B4's streams) and
    decode_device_batch (equal to B5's recs). No machine kernel launches;
    each machine's iterations are counted on CUDA tensors. Then the same
    calls with the flags at 1 (the kernels), timed beside."""
    from spiht_tpu_torch.codec import device_decoder, device_encoder

    t0 = time.perf_counter()
    smi = card()
    on = torch.device(DEV).type  # where the machines must have run
    mb = im_a.shape[1] * im_a.shape[2]  # phase 3's budget: 1.0 bpp
    # ---- the kernels' outputs, before the counts are reset ----
    cases = fallback_small_refs()
    full = {}
    for label, im, er, settings, level in (("A", im_a, er_a, CONFIG_A, None),
                                           ("B", im_b, er_b, CONFIG_B, 3)):
        arr, ll_h, ll_w = forward(torch.as_tensor(im, device=DEV), settings,
                                  level)
        geo = (*arr.shape, ll_h, ll_w)
        slices, _, _ = get_slices_and_h_w(er.h, er.w, settings, level)
        wire = slices_to_wire(slices)
        data = er.encoded_bytes
        trec, tmeta = meta_expand.decode_with_metadata(
            data[:SEQ_PREFIX], er.max_n, *geo, *wire, torch.device(DEV))
        full[label] = dict(
            arr=arr, geo=geo, wire=wire, data=data, max_n=er.max_n,
            rec=decoder.decode(data, er.max_n, *geo, device=DEV).cpu().numpy(),
            trace=(trec.cpu().numpy(), tmeta.cpu().numpy()))
    A, B = full["A"], full["B"]
    c, h, w, ll_h, ll_w = A["geo"]
    arrs_a, _, _ = forward(torch.as_tensor(np.stack(ims_a), device=DEV),
                           CONFIG_A, None)
    datas = [er.encoded_bytes for er in ers_a]
    mns = [er.max_n for er in ers_a]
    recs_b5 = decoder.decode_batch(datas, mns, c, h, w, ll_h, ll_w,
                                   device=DEV).cpu().numpy()

    def hybrid(X):
        return lambda: device_decoder.decode_device(
            X["data"], X["max_n"], *X["geo"], device=DEV)

    def sequential(X):
        return lambda: device_decoder.decode_device_with_metadata(
            X["data"][:SEQ_PREFIX], X["max_n"], *X["geo"], *X["wire"],
            device=DEV)

    # each run: the call as the flags route it, the kernels' output, how
    # many iterations the machine ran (and of what), whether to time a
    # second call (the first includes the CUDA graph's capture). The
    # machines are looked up after their call: the builds are cached
    def enc_info():
        enc = device_encoder.encode_device_fn(*A["geo"]).machine
        return dict(iterations=enc.planes, counted="plane-loop passes",
                    lanes=enc.lanes)

    def dec_info(counted, *args, **kw):
        def info():
            m = device_decoder.decode_device_fn(*args, **kw).machine
            out = dict(iterations=m.steps, counted=counted,
                       K=device_decoder.K_STEPS, on=m._key[0].type)
            if counted == "LIS steps":
                out["planes"] = m.planes
            return out
        return info

    runs = [dict(
        what="sorted-space encoder (B1's stream)", at="A", second=True,
        call=lambda: device_encoder.encode_device(A["arr"], ll_h, ll_w, mb,
                                                  device=DEV),
        want=(er_a.encoded_bytes, er_a.max_n), info=enc_info)]
    for label, kernel in (("A", "B2"), ("B", "B3")):
        X = full[label]
        cw = max((len(X["data"]) * 8 + 31) // 32, 1)
        runs.append(dict(what=f"hybrid decoder ({kernel}'s rec)", at=label,
                         second=True, call=hybrid(X), want=X["rec"],
                         info=dec_info("LIS steps", *X["geo"], cw)))
    for label, kernel in (("A", "B2-log"), ("B", "B3-log")):
        X = full[label]
        pre = X["data"][:SEQ_PREFIX]
        level = len(X["wire"][1])
        rect = tuple(map(tuple, device_decoder.rect_table(
            level, *X["geo"][3:], X["wire"]).reshape(-1, 4)))
        runs.append(dict(
            what=f"sequential decoder with the trace ({kernel}'s rec and "
                 f"trace, {len(pre)}-byte prefix)", at=label, second=False,
            call=sequential(X), want=X["trace"],
            info=dec_info("list-entry steps", *X["geo"],
                          (len(pre) * 8 + 31) // 32, level=level,
                          rect_tab=rect, meta_rows=len(pre) * 8 + 1)))
    cw = max((max(len(d) for d in datas) * 8 + 31) // 32, 1)
    runs += [
        dict(what=f"sorted-space encoder, batch of {len(datas)} (B4's "
                  "streams)", at="A",
             second=False, call=lambda: device_encoder.encode_device_batch(
                 arrs_a, ll_h, ll_w, mbs_a, device=DEV),
             want=[(er.encoded_bytes, er.max_n) for er in ers_a],
             info=enc_info),
        dict(what=f"hybrid decoder, batch of {len(datas)} (B5's recs)",
             at="A",
             second=False, call=lambda: device_decoder.decode_device_batch(
                 datas, mns, c, h, w, ll_h, ll_w, device=DEV),
             want=recs_b5,
             info=dec_info("LIS steps", c, h, w, ll_h, ll_w, cw)),
    ]

    def same(got, want):
        if isinstance(want, np.ndarray):
            return np.array_equal(got, want)
        if isinstance(want, tuple) and isinstance(want[0], np.ndarray):
            return all(np.array_equal(x, y) for x, y in zip(got, want))
        return got == want

    saved = {f: os.environ.get(f) for f in FALLBACK_FLAGS}
    os.environ.update({f: "0" for f in FALLBACK_FLAGS})
    reset_counts()
    rows = []
    try:
        n_cmp = fallback_small(cases)
        for run in runs:
            got, ms = wall_ms(run["call"])
            check(same(got, run["want"]),
                  f"{run['what']} at {run['at']} != the kernels'")
            row = dict(machine=run["what"], at=run["at"], ms=ms,
                       **run["info"]())
            check(row["iterations"] > 0 and row.get("on", on) == on,
                  f"{run['what']} at {run['at']}: no iterations on the card")
            if run["second"]:
                _, row["ms_second_call"] = wall_ms(run["call"])
            rows.append(row)
        try:
            device_encoder.encode_device(B["arr"], *B["geo"][3:], mb,
                                         device=DEV)
        except ValueError as e:
            check("even ll" in str(e), f"B: {e}")
        else:
            raise AssertionError("encode_device encoded B's odd LL")
        torch.cuda.synchronize()
        n = counts()
        # the same calls routed to the kernels (flags at 1), timed beside
        os.environ.update({f: "1" for f in FALLBACK_FLAGS})
        for row, run in zip(rows, runs):
            check(same(run["call"](), run["want"]),
                  f"{row['machine']}: the kernels' route")
            row["kernel_route_ms_median_of_3"] = median_ms(run["call"],
                                                           reps=3)
    finally:
        for f, v in saved.items():
            if v is None:
                os.environ.pop(f, None)
            else:
                os.environ[f] = v
    check(not any(n.values()), f"phase 20: machine kernels launched {n}")
    for row in rows:
        print(json.dumps({"phase": "20 fallback machine", **row,
                          "card": smi}))
    print(json.dumps({
        "phase": "20 fallback machines ok", "small_comparisons": n_cmp,
        "kernel_launches": sum(n.values()), "card": smi,
        "seconds": time.perf_counter() - t0,
        "timing": "host ms from sync to sync; the first call of a "
                  "machine includes its first eager chunk and the CUDA "
                  "graph's capture; ms_second_call repeats it",
    }))


# ---------------------------------------------------------------------------
# phase 21: parallel/ (the sharded DWT and encode, plane statistics,
# consistency tools, health and multi-process glue) and the four examples
# ---------------------------------------------------------------------------

# (a): tests/test_torch_parallel.py's geometries (shape, wavelet, mode,
# level); level 0 is the one-level sharded_dwt2_level1
SHARD_SMALL = (
    ((3, 40, 64), "bior2.2", "reflect", 0),
    ((3, 40, 160), "bior6.8", "symmetric", 0),
    ((3, 48, 96), "bior2.2", "reflect", 3),
    ((2, 3, 32, 64), "bior2.2", "reflect", 2),
    ((2, 1, 16, 60), "bior2.2", "reflect", 2),
    ((1, 32, 1024), "bior2.2", "reflect", 4),
    ((1, 16, 7900), "bior2.2", "reflect", 5),
    ((2, 12, 3001), "bior6.8", "symmetric", 4),
    ((2, 20, 77), "db3", "periodization", 2),
)
SIDE_8K = (4320, 7680)


def card_mesh(n, dp=1):
    """A (dp, n) mesh of cuda:0 repeated: n shards on the one card."""
    return parallel.make_mesh((dp, n), devices=[torch.device(DEV, 0)] * (dp * n))


def cpu_mesh(n, dp=1):
    return parallel.make_mesh((dp, n), devices=["cpu"] * (dp * n))


def plane_stats_plain(arr):
    """Unsharded max |x| and per-plane counts of an int32 array."""
    mag = torch.abs(arr).to(torch.int64)
    return mag.max(), torch.stack([(mag >= (1 << p)).sum() for p in range(32)])


def phase_parallel_small():
    """Phase 21 (a): every CPU test geometry on meshes of cuda:0 repeated
    2, 4 and 8 times (and 2x4 with a placed batch), each output equal to
    the unsharded transform on the card and to the same sharded call on
    the CPU; plane statistics at 2, 4, 8 shards and of a placed batch
    equal the unsharded ones."""
    n_cmp = 0
    for shape, wav, mode, level in SHARD_SMALL:
        x = np.random.default_rng(shape[-1]).standard_normal(shape)
        xc = torch.as_tensor(x, device=DEV)
        for n in (2, 4, 8):
            if level == 0:
                if (shape[-1] // n) % 2 or shape[-1] // n < 18:
                    continue  # rejected widths: the CPU tests hold those
                ref = dwt.dwt2(xc, wav, mode)
                got = parallel.sharded_dwt2_level1(xc, wav, mode, card_mesh(n))
                cpu = parallel.sharded_dwt2_level1(torch.as_tensor(x), wav,
                                                   mode, cpu_mesh(n))
                for k in ref:
                    check(torch.equal(got[k], ref[k])
                          and got[k].device == xc.device
                          and torch.equal(got[k].cpu(), cpu[k]),
                          f"21a dwt2 {shape} {wav} n={n} {k}")
                n_cmp += 1
                continue
            ref = dwt.wavedec2_packed(xc, wav, mode, level)
            meshes = [(card_mesh(n), cpu_mesh(n))]
            if len(shape) == 4 and n == 4:
                meshes.append((card_mesh(4, 2), cpu_mesh(4, 2)))
            for mc, mh in meshes:
                xin = xc
                if mc.shape["batch"] > 1:  # an input placed on the mesh
                    xin = parallel.place(xc, parallel.image_sharding(mc))
                got = parallel.sharded_wavedec2_packed(xin, wav, mode, level,
                                                       mc)
                cpu = parallel.sharded_wavedec2_packed(
                    torch.as_tensor(x), wav, mode, level, mh)
                check(got[1:] == ref[1:] == cpu[1:]
                      and torch.equal(got[0], ref[0])
                      and torch.equal(got[0].cpu(), cpu[0]),
                      f"21a wavedec2_packed {shape} {wav} n={n} {mc.shape}")
                n_cmp += 1
    arr = torch.as_tensor(
        (np.random.default_rng(5).standard_normal((3, 40, 64)) * 5000
         ).astype(np.int32), device=DEV)
    want = plane_stats_plain(arr)
    for n in (2, 4, 8):
        got = parallel.sharded_plane_stats(arr, card_mesh(n))
        check(int(got[0]) == int(want[0])
              and got[1].tolist() == want[1].tolist(),
              f"21a plane stats n={n}")
        n_cmp += 1
    # a batch placed over both axes: each row of shards tallies its half
    batch = torch.stack([arr, arr.flip(-1) // 3])
    want = plane_stats_plain(batch)
    mesh = card_mesh(4, 2)
    got = parallel.sharded_plane_stats(
        parallel.place(batch, parallel.image_sharding(mesh)), mesh)
    check(int(got[0]) == int(want[0]) and got[1].tolist() == want[1].tolist(),
          "21a plane stats of a batch placed on a (2, 4) mesh")
    return n_cmp + 1


def phase_parallel(ims16, smi):
    """Phase 21: parallel/ and the examples on the card (module docstring
    21 (a)-(g))."""
    from spiht_tpu_torch.parallel import codec as pcodec
    from spiht_tpu_torch.parallel.spatial import levels_plan

    t0 = time.perf_counter()
    secs = {}

    def lap(part):
        secs[part] = time.perf_counter() - t0 - sum(secs.values())

    out = {"phase": "21 parallel", "card": smi}
    out["small_comparisons"] = phase_parallel_small()
    lap("a")
    nat = native.load()

    # ---- (b) configuration A's settings on an 8K image, (1, 4) mesh ----
    h, w = SIDE_8K
    im = image(21, (3, h, w))
    lap("b_image")
    budget = h * w  # 1.0 bpp
    mesh4 = card_mesh(4)
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, CONFIG_A, None)
    geo = (3, enc_h, enc_w, slices[0][1].stop, slices[0][2].stop)
    reset_counts()
    er, gib = peak_gb(lambda: parallel.encode_image_sharded(
        im, CONFIG_A, mesh4, None, budget))
    launched("spiht_encode")
    lap("b_first_call")
    _, sharded_ms = wall_ms(lambda: parallel.encode_image_sharded(
        im, CONFIG_A, mesh4, None, budget))
    er_dev, single_ms = wall_ms(lambda: pt.encode_image_device(
        im, CONFIG_A, None, budget, device=DEV))
    check(er.encoded_bytes == er_dev.encoded_bytes and er.max_n == er_dev.max_n,
          "21b: the sharded stream != encode_image_device's")
    x = torch.as_tensor(im, device=DEV)
    f_a = build_wavelet(CONFIG_A.wavelet).dec_len
    lv = min(dwt_max_level(h, f_a), dwt_max_level(w, f_a))
    plan_a = levels_plan(w, 4, f_a, CONFIG_A.mode, lv)
    arr = pcodec._sharded_forward(x, CONFIG_A, lv, mesh4, "tile")
    arr_ref = forward(x, CONFIG_A, None)[0]
    check(torch.equal(arr, arr_ref),
          "21b: sharded coefficients != torch_transform.forward's")
    del arr_ref
    lap("b")
    want = nat.encode(arr.cpu().numpy(), *geo[3:], budget)
    check((er.encoded_bytes, er.max_n) == want,
          "21b: the sharded stream != the native scheduler's")
    lap("b_native")
    odd = decoder.has_duplicate_parents(*geo[1:])
    dec = "spiht_decode_seq" if odd else "spiht_decode_lsp"
    reset_counts()
    rec, dec_ms = wall_ms(lambda: pt.decode_image_device(er, CONFIG_A,
                                                         device=DEV))
    program_launched(dec, inverse_launches(h, w, CONFIG_A, None))
    # the decode held against the native scheduler's: its coefficients one
    # for one (a second call of the decode kernel, outside the count), and
    # the image against the same inverse of the native coefficients
    rec_nat = nat.decode(er.encoded_bytes, er.max_n, *geo)
    coef = decoder.decode(er.encoded_bytes, er.max_n, *geo, device=DEV)
    check(np.array_equal(coef.cpu().numpy(), rec_nat),
          f"21b: {dec}'s coefficients != the native scheduler's")
    del coef
    want_img = inverse(torch.as_tensor(rec_nat, device=DEV), h, w, None,
                       CONFIG_A, torch.float64)
    check(torch.equal(rec, want_img),
          "21b: decode_image_device != the inverse of the native decode")
    del want_img, rec_nat
    mse = float(((rec[:, :h, :w] - x) ** 2).mean())
    # phase 24 holds the ranks' streams and rank 0's decode to these
    ref8k = {"data": er.encoded_bytes, "max_n": er.max_n, "rec": rec,
             "dec": dec, "sharded_ms": sharded_ms, "single_ms": single_ms}
    del rec
    out["8k_A"] = {
        "geometry": list(geo[:3]), "ll": list(geo[3:]), "odd_ll": odd,
        "mesh": "(1, 4) of cuda:0", "bits": len(er.encoded_bytes) * 8,
        "max_n": er.max_n, "levels": lv, "levels_sharded": len(plan_a),
        "tail_fixups": sum(len(r[2]) for _, _, r in plan_a if r),
        "encode_image_sharded_ms": sharded_ms,
        "encode_image_device_ms": single_ms,
        "decode_image_device_ms": dec_ms, "decode_kernel": dec,
        "psnr_db": 10 * np.log10(1.0 / mse),
        "device_peak_gib_sharded_encode": gib,
        "launches_sharded_encode": {"spiht_encode": 1},
        "equal": "coefficients to forward's, stream to "
                 "encode_image_device's and the native scheduler's, the "
                 "decode's coefficients to the native decode's and its "
                 "image to their inverse",
    }

    lap("b_decode")

    # ---- (d) plane statistics and consistency on the 8K coefficients ----
    pad = (-arr.shape[-1]) % 4  # zero columns: no count, no larger max
    arr_p = torch.nn.functional.pad(arr, (0, pad))
    got = parallel.sharded_plane_stats(arr_p, mesh4)
    want = plane_stats_plain(arr)
    check(int(got[0]) == int(want[0]) and got[1].tolist() == want[1].tolist(),
          "21d: sharded plane stats != unsharded")
    del arr, arr_p
    d1 = parallel.sharded_dwt2_level1(x, "bior2.2", "reflect", mesh4)
    ref1 = dwt.dwt2(x, "bior2.2", "reflect")
    check(all(torch.equal(d1[k], ref1[k]) for k in ref1),
          "21d: sharded level 1 != dwt2")
    del ref1
    disc = float(parallel.replication_discrepancy(d1["dd"], mesh4, "tile"))
    copies = [d1["dd"].clone() for _ in range(4)]
    flat = copies[2].view(-1)
    k = flat.numel() // 3
    flat[k] = torch.nextafter(flat[k], flat[k] + 1)
    disc_ulp = float(parallel.replication_discrepancy(copies, mesh4, "tile"))
    check(disc == 0.0 and disc_ulp > 0.0,
          f"21d: replication discrepancy {disc}, one ulp off {disc_ulp}")
    del d1, copies, flat
    try:
        parallel.checked_call(lambda v: torch.log(v).sum(),
                              torch.tensor([-1.0, 2.0], device=DEV))
    except FloatingPointError as e:
        caught = str(e)
    else:
        raise AssertionError("21d: checked_call passed log(-1)")
    v = torch.tensor([1.0, 2.0], device=DEV)
    check(float(parallel.checked_call(lambda t: torch.log(t).sum(), v))
          == float(torch.log(v).sum()), "21d: checked_call changed a value")
    out["8k_A"].update(plane_max=int(got[0]), replication_discrepancy=disc,
                       one_ulp_off=disc_ulp, checked_call_log_neg=caught)

    lap("d")

    # ---- (e) strong scaling on one card (reported, not gated) ----
    xc = torch_models.convert(x, "RGB", "ipt")
    scaling = {"unsharded_ms": median_ms(
        lambda: dwt.wavedec2_packed(xc, "bior2.2", "reflect", lv))}
    for n in (1, 2, 4, 8):
        mesh = card_mesh(n)
        scaling[f"n{n}_ms"] = median_ms(
            lambda: parallel.sharded_wavedec2_packed(
                xc, "bior2.2", "reflect", lv, mesh))
    scaling["what"] = ("median of 5, host clock to a sync, the 8K packed "
                       "DWT (A's settings); one card runs the shards one "
                       "after another, so the ratio to unsharded is the "
                       "cost of halos, reshards and gathers, not "
                       "multi-GPU scaling")
    out["strong_scaling_one_card"] = scaling
    del x, xc
    torch.cuda.empty_cache()
    lap("e")

    # ---- (c) B's settings, odd width, (1, 8) mesh: reshard and tails ----
    wc = w + 1
    im_c = np.pad(im, ((0, 0), (0, 0), (0, 1)), mode="edge")
    del im
    plan = levels_plan(wc, 8, build_wavelet(CONFIG_B.wavelet).dec_len,
                       CONFIG_B.mode, 3)
    reset_counts()
    er_c, ms_c = wall_ms(lambda: parallel.encode_image_sharded(
        im_c, CONFIG_B, card_mesh(8), 3, h * wc))
    launched("spiht_encode")
    lap("c_first_call")
    er_c1, ms_c1 = wall_ms(lambda: pt.encode_image_device(
        im_c, CONFIG_B, 3, h * wc, device=DEV))
    check(er_c.encoded_bytes == er_c1.encoded_bytes
          and er_c.max_n == er_c1.max_n,
          "21c: the sharded stream != encode_image_device's")
    out["8k_B_odd_width"] = {
        "image": [3, h, wc], "mesh": "(1, 8) of cuda:0", "level": 3,
        "bits": len(er_c.encoded_bytes) * 8,
        "levels_sharded": len(plan),
        "tail_fixups": sum(len(r[2]) for _, _, r in plan if r),
        "encode_image_sharded_ms_first_call": ms_c,
        "encode_image_device_ms": ms_c1,
    }
    del im_c
    torch.cuda.empty_cache()
    lap("c")

    # ---- (f) health and multi-process glue ----
    probes = parallel.probe_devices()
    check(probes and all(p.ok for p in probes), f"21f: probes {probes}")
    calls = []

    def counting(imgs, s, **kw):
        calls.append(len(imgs))
        return pt.encode_images(imgs, s, device=DEV, **kw)

    mb = 512 * 512
    want16 = [e.encoded_bytes for e in
              pt.encode_images(ims16, CONFIG_A, max_bits=mb, device=DEV)]
    with tempfile.TemporaryDirectory() as tmp:
        manifest = os.path.join(tmp, "m.json")
        got16 = parallel.robust_encode_images(
            ims16, CONFIG_A, max_bits=mb, chunk=4, manifest_path=manifest,
            encode_fn=counting)
        first_calls = len(calls)
        again = parallel.robust_encode_images(
            ims16, CONFIG_A, max_bits=mb, chunk=4, manifest_path=manifest,
            encode_fn=counting)
        resumed_calls = len(calls) - first_calls

        def dead(imgs, s, **kw):
            raise torch.AcceleratorError("CUDA error: injected for phase 21")

        import warnings

        with warnings.catch_warnings(record=True) as caught_w:
            warnings.simplefilter("always")
            degraded = parallel.robust_encode_images(
                ims16, CONFIG_A, max_bits=mb, chunk=16,
                manifest_path=os.path.join(tmp, "d.json"), encode_fn=dead,
                retries=1)
        warned = [str(m.message) for m in caught_w
                  if "on the host" in str(m.message)]
    check([got16[i].encoded_bytes for i in range(16)] == want16
          and [again[i].encoded_bytes for i in range(16)] == want16
          and [degraded[i].encoded_bytes for i in range(16)] == want16,
          "21f: robust_encode_images' streams != encode_images'")
    check(first_calls == 4 and resumed_calls == 0,
          f"21f: encode calls {first_calls}, on resume {resumed_calls}")
    check(len(warned) == 1 and str(list(range(16))) in warned[0]
          and degraded.degraded == list(range(16))
          and got16.degraded == again.degraded == [],
          f"21f: degraded warnings {warned}, ids {degraded.degraded}")
    import socket
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    parallel.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "21f: not a one-process NCCL group")
        sl = parallel.host_batch_slice(16)
    finally:
        dist.destroy_process_group()
    out["health"] = {
        "probe_latency_s": [p.latency_s for p in probes],
        "robust_encode_calls": first_calls, "on_resume": resumed_calls,
        "degraded_warning": warned[0], "nccl_barrier": "ok",
        "host_batch_slice": [sl.start, sl.stop],
    }
    lap("f")

    # ---- (g) the four examples, in-process, with their defaults ----
    from spiht_tpu_torch.examples import (
        demonstrate, metadata_ml_consumer, on_device_codec, progressive_gif,
    )
    ex = {}
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "im.png")
        imsave(png, image(23, (3, 512, 512)))
        src = imload(png)
        prev = host_transform._BACKEND
        try:
            reset_counts()
            points = demonstrate.main([png, os.path.join(tmp, "demo")])
            ex["demonstrate"] = {"launches": nonzero()}
            ex["demonstrate"]["psnr_db"] = hold_demonstrate(src, points, nat)
            reset_counts()
            got = on_device_codec.main([png])
            ex["on_device_codec"] = {"launches": nonzero(),
                                     "psnr_db": got["psnr_db"]}
            hold_on_device_codec(src, got, nat)
            reset_counts()
            metadata_ml_consumer.main([])  # SystemExit("MISMATCH") if not
            ex["metadata_ml_consumer"] = {"launches": nonzero()}
            # 3x256x256: the GIF's 40 palette conversions, done twice here,
            # cost seconds a time at 512x512
            png_s = os.path.join(tmp, "small.png")
            imsave(png_s, image(24, (3, 256, 256)))
            reset_counts()
            gif = os.path.join(tmp, "p.gif")
            rc = progressive_gif.main([png_s, gif])
            ex["progressive_gif"] = {"launches": nonzero()}
            ref = os.path.join(tmp, "ref.gif")
            progressive_reference(png_s, ref, nat)
            with open(gif, "rb") as f, open(ref, "rb") as g:
                same = f.read() == g.read()
            check(rc == 0 and same,
                  f"21g progressive_gif: rc {rc}, GIF equal to the one "
                  f"built from the native decodes: {same}")
        finally:
            host_transform._BACKEND = prev
    reset_counts()
    lap("g")
    out["examples"] = ex
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = secs
    print(json.dumps(out))
    return ref8k


def nonzero():
    return {k: v for k, v in counts().items() if v}


def _geo(h, w, settings, level):
    slices, eh, ew = get_slices_and_h_w(h, w, settings, level)
    return slices, (3, eh, ew, slices[0][1].stop, slices[0][2].stop)


def hold_demonstrate(src, points, nat):
    """Phase 21 (g): each bpp point of the demonstrate example holds its
    stream against the native scheduler's on the card's coefficients, and
    its reconstruction against the inverse (on the card) of the native
    decode of that stream. Returns the PSNRs."""
    from spiht_tpu_torch.examples import demonstrate

    s = demonstrate.SETTINGS
    _, h, w = src.shape
    slices, geo = _geo(h, w, s, None)
    arr = forward(torch.as_tensor(src, device=DEV), s, None)[0].cpu().numpy()
    for (_, er, rec), bpp in zip(points, (0.1, 0.5, 1.0)):
        check((er.encoded_bytes, er.max_n)
              == nat.encode(arr, *geo[3:], round(bpp * h * w)),
              f"21g demonstrate {bpp} bpp: the stream != the native "
              "scheduler's")
        want = pt.decode_from_rec_arr(
            nat.decode(er.encoded_bytes, er.max_n, *geo), h, w, None, s,
            slices, DEV)[..., :h, :w]
        check(np.array_equal(rec, want),
              f"21g demonstrate {bpp} bpp: the reconstruction != the "
              "inverse of the native decode")
    return [st.psnr_db for st, _, _ in points]


def hold_on_device_codec(src, got, nat):
    """Phase 21 (g): the on-device example's stream (read from the card
    only here) against the native scheduler's on the float32 transform's
    coefficients, and its uint8 preview against the same inverse of the
    native decode."""
    from spiht_tpu_torch.examples import on_device_codec as odc

    _, h, w = src.shape
    _, geo = _geo(h, w, odc.SETTINGS, odc.LEVEL)
    arr = forward(torch.as_tensor(src, dtype=torch.float32, device=DEV),
                  odc.SETTINGS, odc.LEVEL, torch.float32)[0]
    data = encoder.stream_bytes(got["words"], got["bits"])
    check((data, got["max_n"]) == nat.encode(arr.cpu().numpy(), *geo[3:],
                                             h * w),
          "21g on_device_codec: the stream != the native scheduler's")
    want = inverse(torch.as_tensor(nat.decode(data, got["max_n"], *geo),
                                   device=DEV),
                   h, w, odc.LEVEL, odc.SETTINGS, torch.float32, True)
    check(torch.equal(got["rec"], want),
          "21g on_device_codec: the preview != the inverse of the native "
          "decode")


def progressive_reference(png, out, nat):
    """Phase 21 (g): the GIF of ``cli progressive`` at the example's
    arguments, built from the native scheduler's stream on the card's
    coefficients and its decodes of each prefix (inverted on the card)."""
    from PIL import Image

    args = cli.build_parser().parse_args(
        ["progressive", png, out, "--frames", "40", "--bpp", "2.0"])
    s = cli._settings_from_args(args)
    src = imload(png)
    _, h, w = src.shape
    level = cli._level(args, h, w)
    slices, geo = _geo(h, w, s, level)
    arr = forward(torch.as_tensor(src, device=DEV), s, level)[0]
    data, mn = nat.encode(arr.cpu().numpy(), *geo[3:],
                          round(args.bpp * h * w))
    frames = []
    for f in range(1, args.frames + 1):
        nb = max(1, round(len(data) * f / args.frames))
        rec = pt.decode_from_rec_arr(nat.decode(data[:nb], mn, *geo), h, w,
                                     level, s, slices, DEV)[..., :h, :w]
        a = (np.clip(rec, 0, 1) * 255).astype(np.uint8)
        frames.append(Image.fromarray(np.moveaxis(a, 0, -1)))
    frames[0].save(out, save_all=True, append_images=frames[1:],
                   duration=args.duration, loop=0)


# phase 22's refused geometries: (c, h, w), LL, and an image packing to it
REFUSED = [((1, 8, 23), (1, 3), (1, 8, 21),
            pt.SpihtSettings(wavelet="db1", mode="zero"), 3),
           ((3, 2, 40), (2, 40), (3, 2, 40), pt.SpihtSettings(), 0)]
BENCH_RUNS = (["fast=1", "batch=8", "ebatch=8"], ["128x128", "4"])


def refusals(c, h, w, ll_h, ll_w, shape, s, level):
    """Phase 22a's calls at one refused geometry, each on the card."""
    from spiht_tpu_torch.codec import device_decoder, device_encoder

    arr = torch.zeros((c, h, w), dtype=torch.int32, device=DEV)
    data = b"\xa5\x3c\xff\x00\x81\x7e\x11\xee"
    g = (c, h, w, ll_h, ll_w)
    wire = ([0, ll_h, ll_w], [[ll_h, ll_w, 0, h - ll_h, w - ll_w]])
    im = image(5, shape)
    er = pt.EncodingResult(data, shape[1], shape[2], shape[0], 6, level)
    return {
        "encode": lambda: pt.encode(arr, ll_h, ll_w, device=DEV),
        "decode": lambda: pt.decode(data, 6, *g, device=DEV),
        "decode_with_metadata": lambda: pt.decode_with_metadata(
            data, 6, *g, *wire, device=DEV),
        "pallas_encode": lambda: encoder.pallas_encode(arr, ll_h, ll_w,
                                                       device=DEV),
        "pallas_encode_fn": lambda: encoder.pallas_encode_fn(*g, 4,
                                                             device=DEV),
        "pallas_encode_batch": lambda: encoder.pallas_encode_batch(
            arr[None], ll_h, ll_w, 1000, device=DEV),
        "pallas_decode": lambda: decoder.pallas_decode(data, 6, *g,
                                                       device=DEV),
        "pallas_decode_batch_fn": lambda: decoder.pallas_decode_batch_fn(
            *g, 4, device=DEV),
        "pallas_decode_with_metadata":
            lambda: meta_expand.pallas_decode_with_metadata(
                data, 6, *g, *wire, device=DEV),
        "encode_device": lambda: device_encoder.encode_device(
            arr, ll_h, ll_w, 1000, device=DEV),
        "decode_device_batch": lambda: device_decoder.decode_device_batch(
            [data], 6, *g, device=DEV),
        "encode_image_device": lambda: pt.encode_image_device(
            im, s, level, device=DEV),
        "encode_images_device": lambda: pt.encode_images_device(
            [im, im], s, level, device=DEV),
        "decode_images_device": lambda: pt.decode_images_device(
            [er, er], s, device=DEV),
        "encode_image": lambda: pt.encode_image(im, s, level, device=DEV),
        "decode_image": lambda: pt.decode_image(er, s, device=DEV),
    }


def hold_names(label, im, er, settings, level):
    """Phase 22b at one configuration: each JAX package's name on the card
    equal to the existing entry point's output, one launch of its kernel
    (checked with ``launched``)."""
    arr, ll_h, ll_w = forward(torch.as_tensor(im, device=DEV), settings,
                              level)
    c, h, w = arr.shape
    g = (c, h, w, ll_h, ll_w)
    mb = im.shape[1] * im.shape[2]
    dup = decoder.has_duplicate_parents(h, w, ll_h, ll_w)
    dec = "spiht_decode_seq" if dup else "spiht_decode_lsp"
    want = (er.encoded_bytes, er.max_n)
    reset_counts()
    check(encoder.pallas_encode(arr, ll_h, ll_w, mb, device=DEV) == want,
          f"{label}: pallas_encode != encode_image_device's stream")
    launched("spiht_encode")
    check(encoder.pallas_encode(arr, ll_h, ll_w, mb, "seq", device=DEV)
          == want, f"{label}: pallas_encode(seq) != B1's stream")
    launched("spiht_encode_seq")
    fn = encoder.pallas_encode_fn(*g, encoder.cap_words_for(c, h, w, mb),
                                  device=DEV)
    words, total, ovf = fn(arr, er.max_n, mb)
    check(not bool(ovf) and encoder.stream_bytes(words, int(total))
          == want[0], f"{label}: pallas_encode_fn's stream")
    launched("spiht_encode")
    arrs = torch.stack([arr, arr])
    check(encoder.pallas_encode_batch(arrs, ll_h, ll_w, [mb, mb // 4],
                                      device=DEV)
          == [want, pt.encode(arr, ll_h, ll_w, mb // 4, device=DEV)],
          f"{label}: pallas_encode_batch's streams")
    counts_b = counts()
    check(counts_b["spiht_encode_batch"] == 1
          and counts_b["spiht_encode"] == 1, f"{label}: batch launches")
    reset_counts()
    rec = pt.decode(er.encoded_bytes, er.max_n, *g, device=DEV)
    reset_counts()
    check(np.array_equal(decoder.pallas_decode(
        er.encoded_bytes, er.max_n, *g, device=DEV), rec),
        f"{label}: pallas_decode != decode")
    launched(dec)
    words, nbits = decoder.words_tensor(er.encoded_bytes, DEV)
    od = "int16" if er.max_n <= 13 else "int32"
    fn = decoder.pallas_decode_fn(*g, words.numel(), out_dtype=od,
                                  device=DEV)
    check(np.array_equal(fn(words, nbits, er.max_n).cpu().numpy(), rec),
          f"{label}: pallas_decode_fn ({od}) != decode")
    launched(dec)
    half = er.encoded_bytes[: len(er.encoded_bytes) // 2]
    recb = decoder.pallas_decode_batch([er.encoded_bytes, half], er.max_n,
                                       *g, device=DEV)
    want_b = decoder.decode_batch([er.encoded_bytes, half], er.max_n, *g,
                                  device=DEV).cpu().numpy()
    check(np.array_equal(recb, want_b) and np.array_equal(recb[0], rec),
          f"{label}: pallas_decode_batch != decode_batch")
    n = counts()
    batch_dec = dec + "_batch"
    check(n[batch_dec] == 2, f"{label}: {batch_dec} launches {n}")
    reset_counts()
    slices, _, _ = get_slices_and_h_w(er.h, er.w, settings, level)
    wire = slices_to_wire(slices)
    got = meta_expand.pallas_decode_with_metadata(
        er.encoded_bytes, er.max_n, *g, *wire, device=DEV)
    program_launch(dec + "_log", "trace")
    trec, tmeta = meta_expand.decode_with_metadata(
        er.encoded_bytes, er.max_n, *g, *wire, DEV)
    reset_counts()
    check(np.array_equal(got[0], trec.cpu().numpy())
          and np.array_equal(got[1], tmeta.cpu().numpy()),
          f"{label}: pallas_decode_with_metadata != decode_with_metadata")
    coeffs, _, _ = _scaled_coeffs(torch.as_tensor(im, device=DEV), settings,
                                  level, torch.float32)
    q = quantize_compact_m(coeffs, settings.quantization_scale)
    launched("spiht_quantize_compact")
    q0 = quantize_compact(coeffs, settings.quantization_scale)
    reset_counts()
    check(all(torch.equal(a, b) for a, b in zip(q, q0)),
          f"{label}: quantize_compact_m != quantize_compact")
    print(f"phase 22b {label}: pallas_encode (B1, B7), its fn and batch "
          f"(B4), pallas_decode, its {od} fn and batch ({dec}, "
          f"{batch_dec}), pallas_decode_with_metadata ({dec}_log) and "
          "quantize_compact_m (B6) equal the entry points' outputs")


def run_bench(args, expect):
    """Phase 22c: the bench as a subprocess; its JSON line, checked."""
    cmd = [sys.executable, "-m", "spiht_tpu_torch.codec.device_bench", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=420)
    secs = time.perf_counter() - t0
    sys.stderr.write(proc.stderr)
    check(proc.returncode == 0, f"{' '.join(cmd)}: exit {proc.returncode}")
    lines = proc.stdout.splitlines()
    check(len(lines) == 1, f"device_bench printed {len(lines)} lines")
    out = json.loads(lines[0])
    bad = [k for k, v in out.items() if k.startswith("exact_") and not v]
    check(not bad, f"device_bench not exact: {bad}")
    for lane, kernel in expect.items():
        check(out.get(f"launches_{lane}", {}).get(kernel, 0) > 0,
              f"device_bench lane {lane} launched no {kernel}")
    # the kernels' device time of a call is part of its time to the host
    for k in [k for k in out if k.endswith("_kernel")]:
        host = out[k[: -len("kernel")] + "materialized"]
        check(out[k] > host, f"device_bench {k} {out[k]} <= to the host "
              f"{host}")
    print(f"device_bench {' '.join(args)} ({secs:.1f} s): {lines[0]}")
    return out


def phase_surface(im_a, im_b, er_a, er_b):
    """Phase 22: refusals before any launch, the reference's names on the
    card, and the bench."""
    t0 = time.perf_counter()
    reset_counts()
    n_calls = 0
    for (c, h, w), (ll_h, ll_w), shape, s, level in REFUSED:
        for name, call in refusals(c, h, w, ll_h, ll_w, shape, s,
                                   level).items():
            try:
                call()
            except ValueError as e:
                check("ll dims must be > 1" in str(e), f"{name}: {e}")
            else:
                raise AssertionError(f"{name} at {c}x{h}x{w} LL "
                                     f"{ll_h}x{ll_w} did not raise")
            n_calls += 1
    check(not any(counts().values()), f"refusals launched {counts()}")
    print(f"phase 22a: {n_calls} calls at LL 1x3 and level 0 raised "
          "ValueError, no kernel launched")
    hold_names("A", im_a, er_a, CONFIG_A, None)
    hold_names("B", im_b, er_b, CONFIG_B, 3)
    ilv = os.environ.get("SPIHT_TPU_BENCH_ILV", "16")
    fast = run_bench(BENCH_RUNS[0], {
        "full": "spiht_encode", "dec_full": "spiht_decode_lsp",
        "enc_batch8": "spiht_encode_batch",
        "dec_batch8": "spiht_decode_lsp_batch",
        f"enc_ilv{ilv}": "spiht_encode_batch",
        f"dec_ilv{ilv}": "spiht_decode_lsp_batch"})
    every = run_bench(BENCH_RUNS[1], {
        "full": "spiht_encode", "dec_full": "spiht_decode_lsp",
        f"enc_ilv{ilv}": "spiht_encode_batch",
        f"dec_ilv{ilv}": "spiht_decode_lsp_batch"})
    check(not every["launches_dec_hybrid_full"]
          and not every["launches_enc_sorted_full"],
          "the fallback lanes launched a kernel")
    print(json.dumps({"phase": 22, "phase_s": time.perf_counter() - t0,
                      "bench_fast_keys": len(fast),
                      "bench_all_keys": len(every)}))


# ---------------------------------------------------------------------------
# phase 23: the JAX package's documented switches on the card
# ---------------------------------------------------------------------------

# every switch phase 23 sets; each route runs with all the others unset
SWITCH_ENV = (
    "SPIHT_TPU_PALLAS_ENC_BATCH", "SPIHT_TPU_PALLAS_DEC_BATCH",
    "SPIHT_TPU_PALLAS_ILV_B", "SPIHT_TPU_DEVICE_ENCODER",
    "SPIHT_TPU_DEVICE_DECODER", "SPIHT_TPU_PALLAS", "SPIHT_TPU_NO_NATIVE",
    "SPIHT_TPU_CACHE", "SPIHT_TPU_PALLAS_ENCODER", "SPIHT_TPU_PALLAS_DECODER",
    "SPIHT_TPU_PALLAS_ENC_MACHINE", "SPIHT_TPU_PALLAS_DEC_MACHINE",
    "SPIHT_TPU_BUDGET_TRANSFER",
)


def switched(env):
    """os.environ with every switch of SWITCH_ENV unset but ``env``, put
    back on exit."""
    patch = mock.patch.dict(os.environ)
    patch.start()
    for k in SWITCH_ENV:
        os.environ.pop(k, None)
    os.environ.update(env)
    return patch


def switch_route(rows, label, env, fn, want, reps=3):
    """Phase 23: fn() under ``env``, the counts set to 0 just before its
    first call and read just after, which must launch ``want`` (kernel ->
    launches) and nothing else; then its host-clock median of ``reps``
    more calls to a sync. Appends the route's row; returns the first
    call's output."""
    patch = switched(env)
    try:
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        n = nonzero()
        check(n == want, f"phase 23 {label}: launches {n}, want {want}")
        ms = median_ms(fn, reps)
    finally:
        patch.stop()
    rows.append({"route": label, "env": env, "launches": n,
                 "ms_median_of_3": ms})
    return out


def switch_refused(rows, label, env, fn):
    """Phase 23: fn() under ``env`` raises ``MachineResourceLimit`` with
    no kernel launched."""
    patch = switched(env)
    try:
        reset_counts()
        try:
            fn()
        except encoder.MachineResourceLimit as e:
            why = str(e)
        else:
            raise AssertionError(f"phase 23 {label}: no MachineResourceLimit")
        check(not nonzero(), f"phase 23 {label}: launched {nonzero()}")
    finally:
        patch.stop()
    rows.append({"route": label, "env": env, "launches": {},
                 "refused": why})


class Spy:
    """Counts the calls of ``module.name`` while in a ``with``."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def spy(*a, **kw):
            self.calls += 1
            return real(*a, **kw)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def cache_subprocess(arr, ll, mb):
    """Phase 23: the native scheduler loaded in a subprocess under
    SPIHT_TPU_CACHE=<a new directory in the ignored build directory>:
    (where its library is, whether it exists, the stream of ``arr``)."""
    root = os.path.dirname(os.path.abspath(__file__))
    build = os.path.join(root, "spiht_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cache-", dir=build)
    try:
        np.save(os.path.join(tmp, "arr.npy"), arr)
        code = (
            "import json, sys, numpy as np\n"
            "from spiht_tpu_torch.native import runtime\n"
            "nat = runtime.load()\n"
            "so = runtime._so_path()\n"
            "data, mn = nat.encode(np.load(sys.argv[1]), int(sys.argv[2]),"
            " int(sys.argv[3]), int(sys.argv[4]))\n"
            "print(json.dumps({'so': str(so), 'exists': so.exists(),"
            " 'data': data.hex(), 'max_n': mn}))\n")
        env = {**os.environ, "SPIHT_TPU_CACHE": tmp}
        env.pop("SPIHT_TPU_NO_NATIVE", None)
        proc = subprocess.run(
            [sys.executable, "-c", code, os.path.join(tmp, "arr.npy"),
             str(ll[0]), str(ll[1]), str(mb)],
            capture_output=True, text=True, timeout=300, cwd=root, env=env)
        sys.stderr.write(proc.stderr)
        check(proc.returncode == 0, f"SPIHT_TPU_CACHE subprocess: exit "
              f"{proc.returncode}")
        out = json.loads(proc.stdout.splitlines()[-1])
        listed = sorted(os.listdir(tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return tmp, out, listed


def phase_switches(im_a, im_b, er_a, er_b, ims_a, mbs_a, ers_a, ers_b):
    """Phase 23: each documented switch of the JAX package on the card,
    every route with the counts set to 0 just before it and read just
    after, its output equal to the unset route's (streams byte for byte,
    rec, traces and images exactly): the batch routes on the A batch of
    16 (phase 8) and the B batch of 8 (phase 9), SPIHT_TPU_PALLAS on the
    A batch's float32 host-scheduled encode, the raw API's device codec
    at A and B (the hybrid machine at 3x64x64), SPIHT_TPU_NO_NATIVE on 2
    images at 3x64x64, SPIHT_TPU_CACHE in a subprocess."""
    from spiht_tpu_torch.codec import api as tapi
    from spiht_tpu_torch.codec import device_decoder, device_encoder, oracle

    t0 = time.perf_counter()
    smi = card()
    rows = []
    c, h, w = im_a.shape
    _, (_, eh, ew, *ll) = _geo(h, w, CONFIG_A, None)
    geo_a = (c, eh, ew, *ll)
    arrs_a = forward(torch.as_tensor(np.stack(ims_a), device=DEV), CONFIG_A,
                     None)[0]
    want_a = [(er.encoded_bytes, er.max_n) for er in ers_a]

    # ---- ENC_BATCH / ILV_B: encode_device_batch on the A batch ----
    def enc():
        return device_encoder.encode_device_batch(arrs_a, *ll, mbs_a,
                                                  device=DEV)

    for label, env, want in (
            ("enc unset", {}, {"spiht_encode_batch": 1}),
            ("enc ilv", {"SPIHT_TPU_PALLAS_ENC_BATCH": "ilv"},
             {"spiht_encode_batch": 1}),
            ("enc ILV_B=4", {"SPIHT_TPU_PALLAS_ILV_B": "4"},
             {"spiht_encode_batch": 4}),
            ("enc ILV_B=5", {"SPIHT_TPU_PALLAS_ILV_B": "5"},
             {"spiht_encode_batch": 4}),
            ("enc map", {"SPIHT_TPU_PALLAS_ENC_BATCH": "map"},
             {"spiht_encode": 16})):
        got = switch_route(rows, label, env, enc, want)
        check(got == want_a, f"phase 23 {label}: streams != phase 8's")
    # the pipelines read ILV_B too: the chunk is in the batch program's
    # key, and a key's first call launches each chunk twice (warm-up and
    # capture); the median's calls replay it
    torch_transform.clear_programs()
    ers = switch_route(rows, "encode_images_device ILV_B=4",
                       {"SPIHT_TPU_PALLAS_ILV_B": "4"},
                       lambda: pt.encode_images_device(
                           ims_a, CONFIG_A, None, mbs_a, device=DEV),
                       {"spiht_encode_batch": 8})
    check([(e.encoded_bytes, e.max_n) for e in ers] == want_a,
          "phase 23: encode_images_device under ILV_B=4 != phase 8's")
    imgs = {}
    # the program's inverse: a launch a level and the IPT model's, in its
    # warm-up and capture
    inv_a = inverse_launches(h, w, CONFIG_A, None)
    for label, env, n in (("decode_images_device unset", {}, 1),
                          ("decode_images_device ILV_B=4",
                           {"SPIHT_TPU_PALLAS_ILV_B": "4"}, 4)):
        torch_transform.clear_programs()
        imgs[n] = switch_route(rows, label, env, lambda: pt.
                               decode_images_device(ers_a, CONFIG_A,
                                                    device=DEV),
                               {"spiht_decode_lsp_batch": 2 * n,
                                **inv_a})
    check(all(torch.equal(x, y) for x, y in zip(imgs[1], imgs[4])),
          "phase 23: decode_images_device under ILV_B=4 != unset")

    # ---- DEC_BATCH / ILV_B: decode_device_batch, A batch and B batch ----
    for tag, ers_x, geo, routes in (
            ("A", ers_a, geo_a, (
                ("unset", {}, {"spiht_decode_lsp_batch": 1}),
                ("ilv", {"SPIHT_TPU_PALLAS_DEC_BATCH": "ilv"},
                 {"spiht_decode_lsp_batch": 1}),
                ("ILV_B=4", {"SPIHT_TPU_PALLAS_ILV_B": "4"},
                 {"spiht_decode_lsp_batch": 4}),
                ("map", {"SPIHT_TPU_PALLAS_DEC_BATCH": "map"},
                 {"spiht_decode_lsp": 16}))),
            ("B", ers_b, _geo(ers_b[0].h, ers_b[0].w, CONFIG_B, 3)[1],
             (("unset", {}, {"spiht_decode_seq_batch": 1}),
              ("ilv", {"SPIHT_TPU_PALLAS_DEC_BATCH": "ilv"}, None),
              ("ILV_B=4", {"SPIHT_TPU_PALLAS_ILV_B": "4"},
               {"spiht_decode_seq_batch": 2}),
              ("map", {"SPIHT_TPU_PALLAS_DEC_BATCH": "map"},
               {"spiht_decode_seq": 8})))):
        datas = [er.encoded_bytes for er in ers_x]
        mns = [er.max_n for er in ers_x]

        def dec(datas=datas, mns=mns, geo=geo):
            return device_decoder.decode_device_batch(datas, mns, *geo,
                                                      device=DEV)

        recs = None
        for label, env, want in routes:
            label = f"dec {tag} batch {label}"
            if want is None:
                switch_refused(rows, label, env, dec)
                continue
            rec = switch_route(rows, label, env, dec, want)
            recs = rec if recs is None else recs
            check(np.array_equal(rec, recs), f"phase 23 {label}: rec != "
                  "the unset route's")

    # ---- SPIHT_TPU_PALLAS: B6 on the host-scheduled float32 encode ----
    def host_f32():
        return [(e.encoded_bytes, e.max_n) for e in pt.encode_images(
            ims_a, CONFIG_A, None, mbs_a, device=DEV, dtype=torch.float32)]

    no_budget = {"SPIHT_TPU_BUDGET_TRANSFER": "0"}
    streams = None
    # the compact transform runs as a program a key, whose route is read
    # when the key is made: each route's first call is a key's first call
    # (B6 twice: the warm-up's launch and the capture's)
    for label, env, want in (
            ("encode_images f32 unset", {}, {"spiht_quantize_compact": 2}),
            ("encode_images f32 PALLAS=0", {"SPIHT_TPU_PALLAS": "0"}, {}),
            ("encode_images f32 PALLAS=1", {"SPIHT_TPU_PALLAS": "1"},
             {"spiht_quantize_compact": 2})):
        torch_transform.clear_programs()
        got = switch_route(rows, label, {**no_budget, **env}, host_f32, want)
        streams = got if streams is None else streams
        check(got == streams, f"phase 23 {label}: streams != unset")

    # ---- DEVICE_ENCODER: the raw encode through encode_device ----
    arr_a = forward(torch.as_tensor(im_a, device=DEV), CONFIG_A, None)[0]
    arr_b, *llb = forward(torch.as_tensor(im_b, device=DEV), CONFIG_B, 3)
    mb = h * w  # phases 3 and 4: 1.0 bpp
    for label, env, arr, lls, want, er in (
            ("encode DEVICE_ENCODER=1 A", {"SPIHT_TPU_DEVICE_ENCODER": "1"},
             arr_a, ll, {"spiht_encode": 1}, er_a),
            ("encode DEVICE_ENCODER=1 PALLAS_ENCODER=0 A",
             {"SPIHT_TPU_DEVICE_ENCODER": "1",
              "SPIHT_TPU_PALLAS_ENCODER": "0"}, arr_a, ll, {}, er_a),
            ("encode DEVICE_ENCODER=1 B (odd LL: the default route)",
             {"SPIHT_TPU_DEVICE_ENCODER": "1"}, arr_b, llb,
             {"spiht_encode": 1}, er_b)):
        with Spy(device_encoder, "encode_device") as spy:
            got = switch_route(rows, label, env, lambda arr=arr, lls=lls: (
                tapi.encode(arr, *lls, mb, device=DEV)), want)
        rows[-1]["encode_device_calls"] = spy.calls
        check(spy.calls == (0 if lls is llb else 4),
              f"phase 23 {label}: encode_device called {spy.calls} times")
        check(got == (er.encoded_bytes, er.max_n),
              f"phase 23 {label}: stream != phases 3-4's")

    # ---- DEVICE_DECODER: the raw decode through decode_device ----
    data, mn = er_a.encoded_bytes, er_a.max_n
    wire = slices_to_wire(_geo(h, w, CONFIG_A, None)[0])
    rec = switch_route(rows, "decode unset", {},
                       lambda: tapi.decode(data, mn, *geo_a, device=DEV),
                       {"spiht_decode_lsp": 1})
    got = switch_route(rows, "decode DEVICE_DECODER=1",
                       {"SPIHT_TPU_DEVICE_DECODER": "1"},
                       lambda: tapi.decode(data, mn, *geo_a, device=DEV),
                       {"spiht_decode_lsp": 1})
    check(np.array_equal(got, rec), "phase 23: DEVICE_DECODER rec != unset")
    torch_transform.clear_programs()  # the trace program's first call
    meta = switch_route(rows, "decode_with_metadata unset", {},
                        lambda: tapi.decode_with_metadata(
                            data, mn, *geo_a, *wire, device=DEV),
                        {"spiht_decode_lsp_log": 2})
    # decode_device_with_metadata's kernel route runs the same program
    torch_transform.clear_programs()
    got = switch_route(rows, "decode_with_metadata DEVICE_DECODER=1",
                       {"SPIHT_TPU_DEVICE_DECODER": "1"},
                       lambda: tapi.decode_with_metadata(
                           data, mn, *geo_a, *wire, device=DEV),
                       {"spiht_decode_lsp_log": 2})
    check(all(np.array_equal(x, y) for x, y in zip(got, meta)),
          "phase 23: DEVICE_DECODER trace != unset")
    small = image(301, (3, 64, 64))
    er_s = pt.encode_image_device(small, CONFIG_A, None, 64 * 64, device=DEV)
    _, geo_s = _geo(64, 64, CONFIG_A, None)
    rec = decoder.decode(er_s.encoded_bytes, er_s.max_n, *geo_s,
                         device=DEV).cpu().numpy()
    got = switch_route(rows, "decode DEVICE_DECODER=1 PALLAS_DECODER=0 "
                       "3x64x64", {"SPIHT_TPU_DEVICE_DECODER": "1",
                                   "SPIHT_TPU_PALLAS_DECODER": "0"},
                       lambda: tapi.decode(er_s.encoded_bytes, er_s.max_n,
                                           *geo_s, device=DEV), {})
    check(np.array_equal(got, rec), "phase 23: the hybrid machine's rec != "
          "B2's")

    # ---- NO_NATIVE: the host-scheduled codec in the oracle ----
    ims_s = [image(310 + b, (3, 64, 64)) for b in range(2)]

    def host_codec():
        ers = pt.encode_images(ims_s, CONFIG_A, None, 64 * 64, device=DEV)
        outs = pt.decode_images(ers, CONFIG_A, device=DEV)
        return [(e.encoded_bytes, e.max_n) for e in ers], outs

    # no kernel of the codec: the budget path encodes, the native
    # scheduler or the oracle decodes; the images come from the inverse
    # program, whose key's first call (each route starts with none)
    # launches spiht_idwt_level a level and spiht_ipt_inverse in its
    # warm-up and its capture
    inv_s = inverse_launches(64, 64, CONFIG_A, None)
    torch_transform.clear_programs()
    ref_streams, ref_ims = switch_route(rows, "host codec 3x64x64 native",
                                        {}, host_codec, inv_s)
    for value in ("1", "0"):
        label = f"host codec 3x64x64 NO_NATIVE={value}"
        torch_transform.clear_programs()
        with Spy(native, "load") as loads, \
                Spy(oracle, "encode_bits") as enc_bits, \
                Spy(oracle, "decode_bits") as dec_bits:
            got, outs = switch_route(rows, label,
                                     {"SPIHT_TPU_NO_NATIVE": value},
                                     host_codec, inv_s)
        rows[-1]["oracle_calls"] = [enc_bits.calls, dec_bits.calls]
        check(loads.calls == 0, f"phase 23 {label}: {loads.calls} native "
              "loads")
        check(enc_bits.calls == dec_bits.calls == 8,
              f"phase 23 {label}: oracle calls {rows[-1]['oracle_calls']}")
        check(got == ref_streams and all(
            np.array_equal(x, y) for x, y in zip(outs, ref_ims)),
              f"phase 23 {label}: streams or images != the native route's")

    # ---- SPIHT_TPU_CACHE: where the native library is built ----
    t1 = time.perf_counter()
    arr_np = arr_a.cpu().numpy()
    tmp, out, listed = cache_subprocess(arr_np, ll, mb)
    so = native._so_path()
    check(out["exists"] and os.path.dirname(out["so"]) == tmp
          and os.path.basename(out["so"]) == so.name
          and so.name in listed,
          f"phase 23: SPIHT_TPU_CACHE library {out['so']} (in {listed})")
    check((bytes.fromhex(out["data"]), out["max_n"])
          == native.load().encode(arr_np, *ll, mb)
          == (er_a.encoded_bytes, er_a.max_n),
          "phase 23: the stream under SPIHT_TPU_CACHE != the native one")
    rows.append({"route": "SPIHT_TPU_CACHE subprocess", "library":
                 so.name, "in_cache_dir": True,
                 "wall_s": time.perf_counter() - t1})
    print(json.dumps({"phase": 23, "card": smi, "routes": rows,
                      "phase_s": time.perf_counter() - t0}))


# ---------------------------------------------------------------------------
# phase 24: the mesh over the ranks of a process group
# ---------------------------------------------------------------------------

RANKS = 4
WARM = 3  # warm calls a rank times, of the encode and of the DWT


class Tally:
    """Counts, while in a ``with``, the calls of the four
    ``torch.distributed`` functions parallel/ moves data with and the bytes
    each call moves at this rank, as the collective defines them (not as
    its transport does): a batch of sends and receives (ppermute) the
    bytes of each; an all-gather sends its block and receives the others;
    a broadcast sends or receives one block; an all-reduce sends its
    value and receives the others. Under gloo every one of these bytes
    also crosses between the card and the host."""

    NAMES = ("batch_isend_irecv", "all_gather", "broadcast", "all_reduce")

    def __init__(self):
        import torch.distributed as dist

        self.dist = dist
        self.by = {n: {"calls": 0, "sent": 0, "received": 0}
                   for n in self.NAMES}

    def _add(self, name, sent, received):
        row = self.by[name]
        row["calls"] += 1
        row["sent"] += sent
        row["received"] += received

    def __enter__(self):
        dist = self.dist

        def nbytes(t):
            return t.numel() * t.element_size()

        def p2p(real):
            def f(ops):
                out = real(ops)
                self._add("batch_isend_irecv",
                          sum(nbytes(o.tensor) for o in ops
                              if o.op is dist.isend),
                          sum(nbytes(o.tensor) for o in ops
                              if o.op is not dist.isend))
                return out
            return f

        def gather(real):
            def f(got, x, group=None, **kw):
                self._add("all_gather", nbytes(x), nbytes(x) * (len(got) - 1))
                return real(got, x, group=group, **kw)
            return f

        def bcast(real):
            def f(t, src, group=None, **kw):
                mine = src == dist.get_rank()
                self._add("broadcast", nbytes(t) if mine else 0,
                          0 if mine else nbytes(t))
                return real(t, src, group=group, **kw)
            return f

        def reduce(real):
            def f(t, op=dist.ReduceOp.SUM, group=None, **kw):
                n = dist.get_world_size(group)
                self._add("all_reduce", nbytes(t), nbytes(t) * (n - 1))
                return real(t, op=op, group=group, **kw)
            return f

        wrap = {"batch_isend_irecv": p2p, "all_gather": gather,
                "broadcast": bcast, "all_reduce": reduce}
        self.patches = [mock.patch.object(dist, n, wrap[n](getattr(dist, n)))
                        for n in self.NAMES]
        for pt_ in self.patches:
            pt_.start()
        return self

    def __exit__(self, *exc):
        for pt_ in self.patches:
            pt_.stop()


def rank_main(coord, world, pid, backend, device, h, w, outdir) -> int:
    """One rank of phase 24 (``chip_smoke.py --rank ...``): join the group
    (gloo: several ranks may share a card; nccl through
    ``parallel.initialize``), build ``make_mesh((1, world))`` over the
    ranks, encode phase 21's seeded image at A's settings through
    ``encode_image_sharded`` once cold (the host tables) and WARM times
    warm, B1 counted a call, then one more warm call with its collectives
    tallied, and time the sharded DWT WARM times; every call starts at a
    barrier. Writes ``rank<pid>.bin`` (the stream) and ``rank<pid>.json``
    to ``outdir``."""
    import torch.distributed as dist

    from spiht_tpu_torch.parallel import distributed

    world, pid, h, w = int(world), int(pid), int(h), int(w)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        for name in _build.SIGNATURES:
            _build.load(name)
    if backend == "nccl":
        parallel.initialize(coord, world, pid)
        check(dist.get_backend() == "nccl", f"rank {pid}: not an nccl group")
    else:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}", world_size=world, rank=pid,
            timeout=distributed.TIMEOUT)
    try:
        mesh = parallel.make_mesh((1, world), devices=None if cuda else [dev])
        check(mesh.rank == pid and mesh.output_device("tile") == dev,
              f"rank {pid}: mesh position {mesh.position} on "
              f"{mesh.output_device('tile')}")
        im = image(21, (3, h, w))
        budget = h * w

        def call_ms(fn):
            dist.barrier()
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            if cuda:
                torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        def encode():
            reset_counts()
            er = parallel.encode_image_sharded(im, CONFIG_A, mesh, None,
                                               budget)
            if cuda:
                check(nonzero() == {"spiht_encode": 1},
                      f"rank {pid}: launches {nonzero()}")
            return er

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        er, first_ms = call_ms(encode)
        warm = [call_ms(encode)[1] for _ in range(WARM)]
        with Tally() as tally:
            er2, tallied_ms = call_ms(encode)
        check(er2.encoded_bytes == er.encoded_bytes,
              f"rank {pid}: a warm stream differs from the first")
        xc = torch_models.convert(torch.as_tensor(im, device=dev), "RGB",
                                  CONFIG_A.color_model)
        f_a = build_wavelet(CONFIG_A.wavelet).dec_len
        lv = min(dwt_max_level(h, f_a), dwt_max_level(w, f_a))
        dwt_ms = [call_ms(lambda: parallel.sharded_wavedec2_packed(
            xc, CONFIG_A.wavelet, CONFIG_A.mode, lv, mesh))[1]
            for _ in range(WARM)]
        with open(os.path.join(outdir, f"rank{pid}.bin"), "wb") as f:
            f.write(er.encoded_bytes)
        with open(os.path.join(outdir, f"rank{pid}.json"), "w") as f:
            json.dump({
                "rank": pid, "device": str(dev), "backend": backend,
                "max_n": er.max_n, "first_call_ms": first_ms,
                "warm_ms": warm, "tallied_call_ms": tallied_ms,
                "dwt_ms": dwt_ms, "collectives": tally.by,
                "device_peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                                    if cuda else None),
            }, f)
    finally:
        dist.destroy_process_group()
    return 0


def spawn_ranks(backend, devices, h, w, deadline_s=420):
    """Run ``len(devices)`` ranks of this script (``--rank``), rank k on
    ``devices[k]``; wait for all (every one killed by ``deadline_s``),
    fail unless each exits 0, and return their JSON rows and streams."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    world = len(devices)
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank",
             f"127.0.0.1:{port}", str(world), str(pid), backend,
             str(devices[pid]), str(h), str(w), tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for pid in range(world)]
        t_end = time.monotonic() + deadline_s
        try:
            outs = [p.communicate(timeout=max(1.0, t_end - time.monotonic()))
                    for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for pid, (p, (so, se)) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"phase 24 rank {pid} ({backend}) "
                  f"exited {p.returncode}:\n{so[-2000:]}\n{se[-4000:]}")
        rows, streams = [], []
        for pid in range(world):
            with open(os.path.join(tmp, f"rank{pid}.json")) as f:
                rows.append(json.load(f))
            with open(os.path.join(tmp, f"rank{pid}.bin"), "rb") as f:
                streams.append(f.read())
    return rows, streams


def ranks_reference():
    """Phase 21 (b)'s reference for phase 24 run alone (``--ranks``): the
    8K image at A's settings, 1.0 bpp, through encode_image_sharded on a
    (1, 4) mesh of cuda:0, its stream held to encode_image_device's and
    the native scheduler's, and its decode_image_device."""
    h, w = SIDE_8K
    im = image(21, (3, h, w))
    mesh4 = card_mesh(4)
    er = parallel.encode_image_sharded(im, CONFIG_A, mesh4, None, h * w)
    _, sharded_ms = wall_ms(lambda: parallel.encode_image_sharded(
        im, CONFIG_A, mesh4, None, h * w))
    er_dev, single_ms = wall_ms(lambda: pt.encode_image_device(
        im, CONFIG_A, None, h * w, device=DEV))
    arr, ll_h, ll_w = forward(torch.as_tensor(im, device=DEV), CONFIG_A, None)
    want = native.load().encode(arr.cpu().numpy(), ll_h, ll_w, h * w)
    check((er.encoded_bytes, er.max_n) == want
          and er_dev.encoded_bytes == er.encoded_bytes,
          "phase 24: the 8K reference stream != encode_image_device's or "
          "the native scheduler's")
    odd = decoder.has_duplicate_parents(*arr.shape[1:], ll_h, ll_w)
    del arr
    rec = pt.decode_image_device(er, CONFIG_A, device=DEV)
    return {"data": er.encoded_bytes, "max_n": er.max_n, "rec": rec,
            "dec": "spiht_decode_seq" if odd else "spiht_decode_lsp",
            "sharded_ms": sharded_ms, "single_ms": single_ms}


def hold_ranks(label, rows, streams, ref):
    """Every rank's stream and max_n equal to phase 21's."""
    for pid, (row, data) in enumerate(zip(rows, streams)):
        check(data == ref["data"] and row["max_n"] == ref["max_n"],
              f"phase 24 {label}: rank {pid}'s stream != phase 21's")


def phase_ranks(ref, smi, side=SIDE_8K):
    """Phase 24: RANKS ranks on the one card over gloo, and over NCCL where
    there are two or more cards (module docstring 24)."""
    t0 = time.perf_counter()
    h, w = side
    torch.cuda.empty_cache()  # room for the ranks' own allocators
    out = {"phase": "24 rank mesh", "card": smi, "image": [3, h, w],
           "settings": "A, 1.0 bpp", "mesh": f"(1, {RANKS}) over ranks"}
    rows, streams = spawn_ranks("gloo", [torch.device(DEV, 0)] * RANKS, h, w)
    hold_ranks("gloo", rows, streams, ref)
    reset_counts()
    rec = pt.decode_image_device(
        pt.EncodingResult(streams[0], h, w, 3, rows[0]["max_n"], None),
        CONFIG_A, device=DEV)
    program_launched(ref["dec"], inverse_launches(h, w, CONFIG_A, None))
    check(torch.equal(rec, ref["rec"]),
          "phase 24: B3's decode of rank 0's stream != phase 21's image")
    del rec
    out["gloo_on_one_card"] = {
        "ranks": rows, "bits": len(streams[0]) * 8,
        "launches_a_rank_a_call": {"spiht_encode": 1},
        "rank0_decode": {ref["dec"]: 1},
        "warm_ms_median_a_rank": [statistics.median(r["warm_ms"])
                                  for r in rows],
        "dwt_ms_median_a_rank": [statistics.median(r["dwt_ms"])
                                 for r in rows],
        "phase21_encode_image_sharded_ms": ref["sharded_ms"],
        "phase21_encode_image_device_ms": ref["single_ms"],
        "equal": "every rank's stream to phase 21's (= the unsharded B1 "
                 "stream = the native scheduler's); rank 0's stream "
                 "decoded by B3 to phase 21's image",
    }
    n = torch.cuda.device_count()
    if n >= 2:
        k = min(RANKS, n)
        rows, streams = spawn_ranks(
            "nccl", [torch.device(DEV, i) for i in range(k)], h, w)
        hold_ranks("nccl", rows, streams, ref)
        out["nccl"] = {"ranks": rows, "cards": k}
    else:
        out["nccl"] = "not run: 1 card"
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


# ---------------------------------------------------------------------------
# phase 25: the single-image round trip as one program a key (the batch
# programs of one image)
# ---------------------------------------------------------------------------


def program_rows(progs) -> list:
    """Each program's key fields, bucket, bytes, replays and first-run
    seconds."""
    return [{
        # a trace key's rect table as the word "rects"
        "key": [str(k) if len(str(k)) < 80 else "rects" for k in p.key[2:]],
        "bucket_words": getattr(p, "bucket", None),
        "pool_bytes": p.pool_bytes, "static_bytes": p.static_bytes,
        "pinned_host_bytes": p.host_bytes, "replays": p.replays,
        "warmup_and_capture_s": p.capture_s,
    } for p in progs]


def program_launched(name, inverse=None):
    """Check that the program call just made (``encode_image_device`` or
    ``decode_image_device``) launched ``name`` as a program launches it,
    and no other kernel but, in a decode, the inverse's ``inverse``
    (``inverse_launches``: a key's first call): its wrappers count the
    warm-up's launches and those the capture records on a key's first
    call, and nothing on a later call, which the program counts as a
    replay; the counts are set to 0 again. Returns the program."""
    prog = torch_transform.programs()[-1]
    n = counts()
    want = {k: 0 for k in n}
    first = prog.replays == 1
    want[name] = 2 if first else 0
    want.update(inverse if first and inverse else {})
    check(prog.replays >= 1 and n == want,
          f"launches {n}, want {want} ({prog.replays} replays)")
    reset_counts()
    return prog


# the kernels of a program's replay as torch.profiler names them
PROFILED = {"spiht_encode": "spiht_encode_kernel(",
            "spiht_decode_lsp": "spiht_decode_kernel<false, false>",
            "spiht_decode_seq": "spiht_decode_kernel<true, false>"}


def replayed_kernels(label, round_trip, progs, tries=3, names=PROFILED):
    """One profiled round trip of warm programs (``progs``, each replayed
    once in it, no wrapper launching anything): the machine kernels in
    its device rows, by the names in ``names``; a trace with no device
    row at all (CUPTI delivered none) is taken again, up to ``tries``
    times. Returns (the profile's row, kernel -> launches)."""
    for _ in range(tries):
        before = [p.replays for p in progs]
        reset_counts()
        prof = profile_round_trip(label, round_trip)
        check(not nonzero() and [p.replays for p in progs]
              == [r + 1 for r in before],
              f"{label}: launches {nonzero()}, not one replay a program")
        if prof["rows"]:
            break
    ran = {k: sum(n for row, _, n in prof["rows"] if stem in row)
           for k, stem in names.items()}
    return prof, {k: n for k, n in ran.items() if n}


class Captures:
    """The kinds (``key[0]``) of the programs captured while in a
    ``with``, in order (``kinds``): a program once, however many graphs
    it captures (the batch encode captures a front graph a chunk of rows,
    then its back graph)."""

    def __enter__(self):
        self.kinds = []
        real = self.real = torch_transform._Program._capture
        seen = []

        def capture(prog, body):
            if not any(p is prog for p in seen):
                seen.append(prog)
                self.kinds.append(prog.key[0])
            return real(prog, body)

        torch_transform._Program._capture = capture
        return self

    def __exit__(self, *exc):
        torch_transform._Program._capture = self.real


# the batch kernels of a batch program's replay as torch.profiler names them
PROFILED_BATCH = {
    "spiht_encode_batch": "spiht_encode_batch_kernel",
    "spiht_decode_lsp_batch": "spiht_decode_batch_kernel<false>",
    "spiht_decode_seq_batch": "spiht_decode_batch_kernel<true>",
}


def phase_batch_program(ims_a, mbs_a, ers_a, ims_b, ers_b, smi):
    """Phase 26 (module docstring): the batch programs against the eager
    bodies and phases 8-10 bit for bit; their launches and replays; a
    replay with no sync before the stat read; eager and program timings,
    first calls, pools and the staging; the quantizer's overflow on the
    card. Gated on equalities and counts only."""
    from spiht_tpu_torch.codec import api as tapi

    t0 = time.perf_counter()
    tt = torch_transform
    out = {"phase": "26 the batch codec as one program a key", "card": smi,
           "batch_bytes_per_cell": tt.BATCH_BYTES_PER_CELL,
           "batch_bound_3x512x512": tt.batch_bound(
               (3, 512, 512), torch.device(DEV))}
    cases = (
        ("A16", CONFIG_A, None, ims_a, mbs_a, ers_a, "spiht_decode_lsp_batch"),
        ("A128", CONFIG_A, None, ims_a * 8, mbs_a * 8, ers_a * 8,
         "spiht_decode_lsp_batch"),
        ("B8", CONFIG_B, 3, ims_b, [512 * 512] * len(ims_b), ers_b,
         "spiht_decode_seq_batch"),
    )
    for label, s, level, ims, mbs, ers, dec in cases:
        tt.clear_programs()
        torch.cuda.empty_cache()
        B = len(ims)
        c, h, w = ims[0].shape
        check(tt.batch_bound((c, h, w), torch.device(DEV)) >= B,
              f"26 {label}: the batch does not fit one program")
        want = [(e.encoded_bytes, e.max_n) for e in ers]
        datas = [d for d, _ in want]
        nbits = [len(d) * 8 for d in datas]
        mns = [m for _, m in want]
        body_enc = tt.encode_pipeline_batch_eager(s, level)
        body_dec = tt.decode_pipeline_batch_eager(s, h, w, level, c)

        def eager_encode():  # with the eager path's pageable upload
            words, stat, mn = body_enc(tapi._device_batch(ims, DEV), mbs)
            totals = [r[0] for r in encoder.check_stat(stat, "eager B4")]
            return list(zip(encoder.batch_stream_bytes(words, totals),
                            mn.tolist()))

        def eager_decode():
            words, nb = decoder.words_batch(datas, DEV)
            return body_dec(words, nb, mns)

        def enc():
            return pt.encode_images_device(ims, s, level, mbs, device=DEV)

        def dec_imgs():
            return pt.decode_images_device(ers, s, device=DEV)

        row = {"batch": B}
        for what in ("first", "replay"):
            reset_counts()
            got, row[f"encode_{what}_ms"] = timed(enc)
            n = nonzero()
            check(n == ({"spiht_encode_batch": 2} if what == "first" else {})
                  and [(e.encoded_bytes, e.max_n) for e in got] == want,
                  f"26 {label} encode {what}: launches {n} or streams")
            reset_counts()
            imgs, row[f"decode_{what}_ms"] = timed(dec_imgs)
            torch.cuda.synchronize()
            n = nonzero()
            check(n == ({dec: 2, **inverse_launches(h, w, s, level)}
                        if what == "first" else {}),
                  f"26 {label} decode {what}: launches {n}")
            if what == "first":
                first = imgs
        eprog, dprog = tt.programs()
        check(eprog.key[0] == "encode_batch" and dprog.key[0] ==
              "decode_batch" and eprog.replays == dprog.replays == 2,
              f"26 {label}: programs {[p.key[0] for p in tt.programs()]}, "
              f"replays {eprog.replays}, {dprog.replays}")
        # the machine route: one launch of the B streams in each, the
        # decode's through batched B3 at B's odd LL
        seq = int(dec == "spiht_decode_seq_batch")
        row["launch"] = [eprog.launch, dprog.launch]
        check(row["launch"] == [{"streams": B, "seq": 0},
                                {"streams": B, "seq": seq}],
              f"26 {label}: launches {row['launch']}")
        check(eager_encode() == want,
              f"26 {label}: the eager body's streams != phases 8-10's")
        eager_imgs = eager_decode()
        check(all(torch.equal(a, eager_imgs[b]) and torch.equal(
            imgs[b], eager_imgs[b]) for b, a in enumerate(first)),
            f"26 {label}: the programs' images != the eager body's")
        # the replays ran B4 and the batch decoder once each
        prof, ran = replayed_kernels(
            f"26 {label} program", lambda: (enc(), dec_imgs()),
            [eprog, dprog], names=PROFILED_BATCH)
        check(ran == {"spiht_encode_batch": 1, dec: 1},
              f"26 {label}: the replays' kernels {ran}")
        row["replay_kernels_profiled"] = ran
        # a replay with no sync before the stat read
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eprog.start(ims, mbs)
            dprog.start(datas, nbits, mns)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(eprog.finish() == want
              and torch.equal(dprog.finish(), eager_imgs),
              f"26 {label}: the replays without a sync")
        # timings: median of 5, eager body vs program
        row["encode_eager_ms"] = median_ms(eager_encode)
        row["encode_program_ms"] = median_ms(enc)
        row["decode_eager_ms"] = median_ms(eager_decode)
        row["decode_program_ms"] = median_ms(dec_imgs)
        # the staging: the host's copies into the pinned buffer (the last
        # call's), its upload, and the eager path's pageable copies
        pin, static = eprog._pinned["images"], eprog.statics["images"]
        row["stage_host_copy_ms"] = eprog.stage_s * 1e3
        row["upload_pinned_ms"] = median_ms(
            lambda: static.copy_(pin, non_blocking=True))
        row["upload_pageable_ms"] = median_ms(
            lambda: tapi._device_batch(ims, DEV))
        eager = profile_round_trip(f"26 {label} eager", lambda: (
            eager_encode(), eager_decode()))
        for route, p in (("eager", eager), ("program", prof)):
            row[f"profile_{route}"] = {k: p[k] for k in (
                "wall_ms", "device_busy_ms", "device_idle_share")}
        row["programs"] = program_rows([eprog, dprog])
        # what batch_bound assumes of a round trip's two programs
        per_cell = ((eprog.device_bytes + dprog.device_bytes)
                    / (B * c * h * w))
        row["round_trip_bytes_per_cell"] = per_cell
        check(per_cell <= tt.BATCH_BYTES_PER_CELL,
              f"26 {label}: the programs hold {per_cell} bytes an image "
              f"cell, over {tt.BATCH_BYTES_PER_CELL}")
        # the fronts: every call above staged host rows, a front's rows at
        # a time; the same images on the card run as one graph
        row["fronts"] = check_fronts(f"26 {label}", eprog, ims, s, level,
                                     mbs, want)
        out[label] = row
        if label == "A16":
            imgs_a16 = eager_imgs
        del first, imgs, eager_imgs
    out["K24"] = phase_kodak_batch()
    # the map route (SPIHT_TPU_PALLAS_ILV_B=1: a launch would take one
    # stream): B1, and B2 and its scatter, a stream each inside the
    # capture, each reading its scalars from a row of the static buffers
    want = [(e.encoded_bytes, e.max_n) for e in ers_a]
    patch = switched({"SPIHT_TPU_PALLAS_ILV_B": "1"})
    try:
        tt.clear_programs()
        row = {}
        for what, n_want in (("first", 2 * len(ims_a)), ("replay", 0)):
            reset_counts()
            (got, imgs), row[f"round_trip_{what}_ms"] = timed(lambda: (
                pt.encode_images_device(ims_a, CONFIG_A, None, mbs_a,
                                        device=DEV),
                pt.decode_images_device(ers_a, CONFIG_A, device=DEV)))
            torch.cuda.synchronize()
            n = nonzero()
            check(n == ({"spiht_encode": n_want, "spiht_decode_lsp": n_want,
                         **inverse_launches(512, 512, CONFIG_A, None)}
                        if n_want else {})
                  and [(e.encoded_bytes, e.max_n) for e in got] == want
                  and all(torch.equal(a, b) for a, b in zip(imgs, imgs_a16)),
                  f"26 map route {what}: launches {n}, or streams or images")
        row["routes"] = [list(p.key[10:12]) for p in tt.programs()]
        out["A16_map_route"] = row
    finally:
        patch.stop()
    del imgs_a16, imgs
    tt.clear_programs()
    torch.cuda.empty_cache()
    out["overflow"] = overflow_on_card()
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


def check_fronts(label, eprog, ims, s, level, mbs, want) -> dict:
    """Phase 26: a batch encode program that has run only host rows, all
    B a call: each call overlapped the rows of every front but the last
    and replayed each front graph and the back graph once; then the same
    images on the card run as one graph (the whole body), overlapping no
    row, with the same streams. Its counters."""
    B, k = eprog.shape[0], eprog.rows_a_front
    calls = eprog.staged_rows // B
    fronts = len(eprog._fronts) if k < B else 0
    last = (B - 1) // k * k if k < B else 0
    check(eprog.staged_rows == calls * B and eprog.replays == calls
          and eprog.overlap_rows == calls * last
          and eprog.front_replays == calls * fronts,
          f"{label} fronts of {k}: rows {eprog.staged_rows}, replays "
          f"{eprog.replays}, overlap {eprog.overlap_rows}, fronts "
          f"{eprog.front_replays} in {calls} calls")
    row = {"rows_a_front": k, "fronts": fronts,
           "staged_rows": eprog.staged_rows,
           "overlap_rows": eprog.overlap_rows,
           "overlap_share": eprog.overlap_rows / eprog.staged_rows,
           "front_replays": eprog.front_replays,
           "back_replays": eprog.replays, "pool_bytes": eprog.pool_bytes,
           "static_bytes": eprog.static_bytes,
           "warmup_and_capture_s": eprog.capture_s}
    rows = [torch.as_tensor(im, device=DEV) for im in ims]
    got = pt.encode_images_device(rows, s, level, mbs, device=DEV)
    check([(e.encoded_bytes, e.max_n) for e in got] == want
          and eprog.overlap_rows == row["overlap_rows"]
          and eprog.front_replays == row["front_replays"]
          and eprog.replays == calls + 1,
          f"{label}: rows on the card: streams, or overlap "
          f"{eprog.overlap_rows}, fronts {eprog.front_replays}")
    row["card_rows_pool_bytes"] = eprog.pool_bytes
    return row


def phase_kodak_batch() -> dict:
    """Phase 26: a Kodak-size batch (24 768x512 float32 images, budgets of
    1 bpp with 0, -3 and 0.1 bpp among them) through
    ``encode_images_device``: host rows in fronts of 4, a first call and a
    replay, byte for byte the eager body's; then the same images on the
    card as one graph (``check_fronts``)."""
    tt = torch_transform
    ims = [image(300 + b, (3, 512, 768)).astype(np.float32)
           for b in range(24)]
    mbs = [393216] * 24
    mbs[5], mbs[9], mbs[17] = 0, -3, 39320
    tt.clear_programs()
    torch.cuda.empty_cache()
    words, stat, mn = tt.encode_pipeline_batch_eager(CONFIG_A, None)(
        torch.as_tensor(np.stack(ims), device=DEV), [max(m, 0) for m in mbs])
    totals = [r[0] for r in encoder.check_stat(stat, "26 K24 eager B4")]
    want = list(zip(encoder.batch_stream_bytes(words, totals), mn.tolist()))
    del words, stat, mn
    row = {}

    def enc():
        return pt.encode_images_device(ims, CONFIG_A, None, mbs, device=DEV)

    for what in ("first", "replay"):
        got, row[f"encode_{what}_ms"] = timed(enc)
        check([(e.encoded_bytes, e.max_n) for e in got] == want,
              f"26 K24 encode {what}: streams != the eager body's")
    (prog,) = tt.programs()
    check(prog.rows_a_front == 4 and len(prog._fronts) == 6,
          f"26 K24: fronts of {prog.rows_a_front}, {len(prog._fronts)}")
    row["fronts"] = check_fronts("26 K24", prog, ims, CONFIG_A, None, mbs,
                                 want)
    row["encode_program_ms"] = median_ms(enc)
    tt.clear_programs()
    torch.cuda.empty_cache()
    return row


def overflow_on_card():
    """Phase 26, the quantizer's overflow on the card: an image scaled by
    1e9 quantizes to -2^31 where numpy's cast does (the CPU's arrays), and
    its streams (B1 through encode_image_device, B4 through
    encode_images_device) equal the CPU port's, max_n 31, and the plain
    version's on the card's coefficients; an int32 array holding one
    -2^31 through B1 and B4 equals the native scheduler's stream."""
    s = pt.SpihtSettings()
    im = np.random.default_rng(0).random((3, 64, 80)) * 1e9
    arr, ll_h, ll_w = forward(torch.as_tensor(im, device=DEV), s, None)
    arr_cpu, _, _ = forward(torch.as_tensor(im), s, None)
    check(torch.equal(arr.cpu(), arr_cpu),
          "26 overflow: the card's coefficients != the CPU's")
    er = pt.encode_image_device(im, s, None, device=DEV)
    er_cpu = pt.encode_image_device(im, s, None, device="cpu")
    check((er.encoded_bytes, er.max_n) == (er_cpu.encoded_bytes,
                                           er_cpu.max_n) and er.max_n == 31,
          f"26 overflow: stream or max_n {er.max_n} != the CPU port's")
    check(cmp_encode(arr, ll_h, ll_w, FULL) == (er.encoded_bytes, er.max_n),
          "26 overflow: B1 != the plain version")
    ers = pt.encode_images_device([im, im], s, None, device=DEV)
    check(all((e.encoded_bytes, e.max_n) == (er.encoded_bytes, er.max_n)
              for e in ers), "26 overflow: B4 != B1")
    one = np.random.default_rng(0).integers(-1000, 1000, (3, 32, 32),
                                            dtype=np.int32)
    one[0, 5, 7] = -(2**31)
    want = native.load().encode(one, 4, 4, FULL)
    x = torch.as_tensor(one, device=DEV)
    check(want[1] == 31 and cmp_encode(x, 4, 4, FULL) == want
          and cmp_encode_batch(torch.stack([x, x]), 4, 4, [FULL, FULL])
          == [want, want], "26 -2^31 array: B1 or B4 != the native stream")
    return {"image_min_int32_coeffs": int((arr_cpu == -(2**31)).sum()),
            "image_bytes": len(er.encoded_bytes), "image_max_n": er.max_n,
            "array_bytes": len(want[0]), "array_max_n": want[1],
            "equal": True}


def phase_program(im_a, im_b, er_a, er_b, prev_q, ref8k, smi):
    """Phase 25 (module docstring): programs against the eager body and
    against phases 3-5 and 21, bit for bit; their launches and replays; a
    replay with no sync before the stat read; eager and program timings,
    first calls and pools. Gated on equalities and counts only."""
    t0 = time.perf_counter()
    tt = torch_transform
    tt.clear_programs()
    torch.cuda.empty_cache()
    out = {"phase": "25 the round trip as one program", "card": smi,
           "program_limit": tt.PROGRAM_LIMIT,
           "program_memory_share": tt.PROGRAM_MEMORY_SHARE}
    cases = (("A", im_a, er_a, CONFIG_A, None, "spiht_decode_lsp"),
             ("B", im_b, er_b, CONFIG_B, 3, "spiht_decode_seq"))
    for label, im, er, s, level, dec in cases:
        c, h, w = im.shape
        mb = h * w  # phases 3-4's budget: 1.0 bpp
        x = torch.as_tensor(im, device=DEV)
        body_enc = tt.encode_pipeline_eager(s, level)
        body_dec = tt.decode_pipeline_eager(s, h, w, level, c)

        def eager_encode(budget):
            words, stat, mn = body_enc(x, budget)
            total = encoder.check_stat(stat, "spiht_encode")[0]
            return encoder.stream_bytes(words, total), int(mn)

        def eager_decode(data):
            words, nbits = decoder.words_tensor(data, DEV)
            return body_dec(words, nbits, er.max_n)

        def enc():
            return pt.encode_image_device(im, s, level, mb, device=DEV)

        def dec_img(e=er):
            return pt.decode_image_device(e, s, device=DEV)

        row = {}
        # the keys of phases 3-4: the first call (warm-up, capture, replay:
        # two launches of B1 or the decoder) and a replay (none)
        for what in ("first", "replay"):
            reset_counts()
            got, row[f"encode_{what}_ms"] = timed(enc)
            eprog = program_launched("spiht_encode")
            check((got.encoded_bytes, got.max_n) ==
                  (er.encoded_bytes, er.max_n),
                  f"25 {label} encode {what}: != phase 3-4's stream")
            img, row[f"decode_{what}_ms"] = timed(dec_img)
            torch.cuda.synchronize()
            dprog = program_launched(dec, inverse_launches(h, w, s, level))
            if what == "first":
                first_img = img
        check(eprog.replays == dprog.replays == 2,
              f"25 {label}: replays {eprog.replays}, {dprog.replays}")
        check(eager_encode(mb) == (er.encoded_bytes, er.max_n),
              f"25 {label}: the eager body's stream != phase 3-4's")
        want = eager_decode(er.encoded_bytes)
        check(torch.equal(first_img, want) and torch.equal(img, want),
              f"25 {label}: the program's image != the eager body's")
        # the replays ran B1 and the decoder: the profiler's kernel rows
        prof, ran = replayed_kernels(f"25 {label} program",
                                     lambda: (enc(), dec_img()),
                                     [eprog, dprog])
        check(ran == {"spiht_encode": 1, dec: 1},
              f"25 {label}: the replays' kernels {ran}")
        row["replay_kernels_profiled"] = ran
        # one encode key, every budget: the full stream's program
        prog = tt.encode_batch_program(s, (1,) + im.shape, level,
                                       torch.float64, torch.float64, DEV,
                                       FULL)
        budgets = {"1.0 bpp": mb, "0.25 bpp": mb // 4, "1 bit": 1,
                   "full": FULL}
        streams = {}
        for name, budget in budgets.items():
            ((data, mn),) = prog([im], [budget])
            check((data, mn) == eager_encode(budget),
                  f"25 {label} {name} through one key != the eager body")
            streams[name] = data
        check(streams["1.0 bpp"] == er.encoded_bytes
              and len(set(streams.values())) == len(streams),
              f"25 {label}: one key's streams")
        # one decode key: a longer stream, then a shorter one (stale tail);
        # the image returned first stays as it was
        data = er.encoded_bytes
        short = data[: len(data) * 3 // 4]
        dprog = tt.decode_batch_program(s, h, w, level, c, 1, torch.float64,
                                        False, DEV, len(data) * 8)
        (long_img,) = dprog([data], [len(data) * 8], [er.max_n])
        kept = long_img.clone()
        (short_img,) = dprog([short], [len(short) * 8], [er.max_n])
        check(torch.equal(long_img, want)
              and torch.equal(short_img, eager_decode(short))
              and torch.equal(long_img, kept),
              f"25 {label}: longer then shorter stream through one key")
        # a replay with no sync before the stat read
        eprog = tt.encode_batch_program(s, (1,) + im.shape, level,
                                        torch.float64, torch.float64, DEV, mb)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eprog.start([im], [mb])
            dprog.start([data], [len(data) * 8], [er.max_n])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(eprog.finish() == [(er.encoded_bytes, er.max_n)]
              and torch.equal(dprog.finish()[0], want),
              f"25 {label}: the replays without a sync")
        # timings: median of 5, eager body vs program
        row["encode_eager_ms"] = median_ms(lambda: eager_encode(mb))
        row["encode_program_ms"] = median_ms(enc)
        row["decode_eager_ms"] = median_ms(
            lambda: eager_decode(er.encoded_bytes))
        row["decode_program_ms"] = median_ms(dec_img)
        eager = profile_round_trip(f"25 {label} eager", lambda: (
            eager_encode(mb), eager_decode(er.encoded_bytes)))
        for route, p in (("eager", eager), ("program", prof)):
            row[f"profile_{route}"] = {k: p[k] for k in (
                "wall_ms", "device_busy_ms", "device_idle_share")}
        out[label] = row
    # phase 5's quarter stream through its own key
    c, h, w = im_a.shape
    quarter = er_a.encoded_bytes[: len(er_a.encoded_bytes) // 4]
    er_q = pt.EncodingResult(quarter, h, w, c, er_a.max_n, None)
    words, nbits = decoder.words_tensor(quarter, DEV)
    want_q = tt.decode_pipeline_eager(CONFIG_A, h, w, None, c)(
        words, nbits, er_a.max_n)
    for _ in range(2):
        reset_counts()
        img = pt.decode_image_device(er_q, CONFIG_A, device=DEV)
        torch.cuda.synchronize()
        program_launched("spiht_decode_lsp",
                         inverse_launches(h, w, CONFIG_A, None))
        check(torch.equal(img, want_q) and torch.equal(img, prev_q),
              "25 the quarter stream != the eager body's or phase 5's")
    out["programs_A_B"] = program_rows(tt.programs())
    # the 8K geometry of phase 21: its programs' pools
    tt.clear_programs()
    torch.cuda.empty_cache()
    h, w = SIDE_8K
    im8 = image(21, (3, h, w))
    reset_counts()
    er8, ms = timed(lambda: pt.encode_image_device(im8, CONFIG_A, None,
                                                   h * w, device=DEV))
    program_launched("spiht_encode")
    check((er8.encoded_bytes, er8.max_n) == (ref8k["data"], ref8k["max_n"]),
          "25 8K: the program's stream != phase 21's")
    rec8, dms = timed(lambda: pt.decode_image_device(er8, CONFIG_A,
                                                     device=DEV))
    torch.cuda.synchronize()
    program_launched(ref8k["dec"], inverse_launches(h, w, CONFIG_A, None))
    check(torch.equal(rec8, ref8k["rec"]),
          "25 8K: the program's image != phase 21's")
    del rec8, im8
    out["8k"] = {"encode_first_ms": ms, "decode_first_ms": dms,
                 "programs": program_rows(tt.programs())}
    tt.clear_programs()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


# ---------------------------------------------------------------------------
# phase 27: the trace, the host-scheduled steps and the transforms as
# programs a key
# ---------------------------------------------------------------------------


def synced(fn):
    """fn, then a sync: a timing of work that stays on the card."""
    def run():
        out = fn()
        torch.cuda.synchronize()
        return out
    return run


def eager_host_codec(ims, settings, level, dtype):
    """The host-scheduled codec's device steps op by op, as the tree
    before the programs ran them (one pageable upload of the batch, the
    eager bodies forward_compact, forward_plan with device_max_n, narrow
    and inverse), around the native scheduler: (encode(mbs or None) ->
    [(bytes, max_n)], decode(ers) -> [image])."""
    from spiht_tpu_torch.codec import api as tapi
    from spiht_tpu_torch.codec.maxn import device_max_n
    from spiht_tpu_torch.codec.planning import cut_plane_np

    nat = native.load()
    c, h, w = ims[0].shape
    ll_h, ll_w = _ll(h, w, settings, level)
    n = len(ims)
    n_ee = ((ll_h + 1) // 2) * ((ll_w + 1) // 2)
    n_init = c * ll_h * ll_w + c * (ll_h * ll_w - n_ee)

    def encode(mbs):
        batch = tapi._device_batch(ims, DEV)
        if mbs is None:
            arr16, ovf, _, _ = torch_transform.forward_compact(
                batch, settings, level, dtype)
            check(not bool(ovf), "27: the batch passes int16")
            arrs = list(arr16.cpu().numpy().astype(np.int32))
            return nat.encode_batch(arrs, [ll_h] * n, [ll_w] * n,
                                    [tapi._MAX_BITS_DEFAULT] * n,
                                    use_maps=True)
        arr, mx, cnt, mnd, _, _ = torch_transform.forward_plan(
            batch, settings, level, dtype)
        mns = device_max_n(arr).cpu().numpy()
        mx, mnd = mx.cpu().numpy(), mnd.cpu().numpy()
        cnt = cnt.cpu().numpy().astype(np.int64)
        shifts = np.zeros(n, np.int32)
        for b in range(n):
            ci = cnt[b].copy()
            ci[mnd[b] + 1: mns[b] + 1] = n_init
            shifts[b] = max(cut_plane_np(ci, int(mns[b]), int(mbs[b]))[0], 0)
        wmax = int(np.max(mx >> shifts))
        check(wmax <= 32767, "27: the narrowed batch passes int16")
        od = torch.int8 if wmax <= 127 else torch.int16
        hi = torch_transform.narrow(arr, torch.as_tensor(shifts, device=DEV),
                                    od).cpu().numpy()
        mag = np.abs(hi.astype(np.int32)) << shifts[:, None, None, None]
        return nat.encode_batch(list(np.where(hi >= 0, mag, -mag).astype(
            np.int32)), [ll_h] * n, [ll_w] * n, list(mbs), use_maps=True,
            forced_max_ns=mns.astype(np.int32))

    def decode(ers):
        _, eh, ew = get_slices_and_h_w(h, w, settings, level)
        recs = nat.decode_batch([e.encoded_bytes for e in ers],
                                [e.max_n for e in ers], [c] * len(ers),
                                [eh] * len(ers), [ew] * len(ers),
                                [ll_h] * len(ers), [ll_w] * len(ers))
        return list(inverse(tapi._device_batch(recs, DEV), h, w, level,
                            settings).cpu().numpy())

    return encode, decode


def trace_programs(label, er, settings, level, kernel, nat):
    """Phase 27 (a) at one configuration: the trace program's first call
    and a replay through decode_with_metadata, against the eager body and
    the native scheduler; the bucket-sized log past nbits on a byte
    prefix; timings and the programs' rows."""
    c, h, w = er.c, er.h, er.w
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, settings, level)
    geo = (c, enc_h, enc_w, slices[0][1].stop, slices[0][2].stop)
    wire = slices_to_wire(slices)
    data, mn = er.encoded_bytes, er.max_n
    nbits = len(data) * 8
    tt = torch_transform
    tt.clear_programs()
    torch.cuda.empty_cache()
    row = {"bits": nbits}
    want = nat.decode_with_metadata(data, mn, *geo, *wire)
    erec, emeta = meta_expand.decode_with_metadata_eager(data, mn, *geo,
                                                         *wire, DEV)
    check(np.array_equal(erec.cpu().numpy(), want[0])
          and np.array_equal(emeta.cpu().numpy(), want[1]),
          f"27 {label}: the eager trace != the native scheduler's")
    del erec, emeta
    for what in ("first", "replay"):
        reset_counts()
        (rec, meta), row[f"trace_{what}_ms"] = timed(synced(
            lambda: meta_expand.decode_with_metadata(data, mn, *geo, *wire,
                                                     DEV)))
        prog = program_launch(kernel, "trace")
        check(np.array_equal(rec.cpu().numpy(), want[0])
              and np.array_equal(meta.cpu().numpy(), want[1]),
              f"27 {label} {what}: the program's trace != the eager body's")
        row[f"launches_{what}"] = 2 if what == "first" else 0
    got = pt.decode_with_metadata(data, mn, *geo, *wire, device=DEV)
    check(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]),
          f"27 {label}: the API's trace (numpy) != the native scheduler's")
    program_launch(kernel, "trace")
    # a byte prefix: the bucket's log is 0 past nbits, and up to it the
    # eager kernel's log
    cut = data[: len(data) * 3 // 4]
    cbits = len(cut) * 8
    lprog = tt.trace_program(*geo, None, None, cbits, DEV, "log")
    with lprog.lock:
        lprog.start([cut], cbits, mn)
        log = lprog.outputs[2]
        tail_zero = not bool(log[cbits + 1:].any())
        words, nb = decoder.words_tensor(cut, DEV)
        elog = (decoder.decode_seq_log if "seq" in kernel
                else decoder.decode_lsp_log)(
            *decoder.machine_args(words, nb, mn, *geo))[-1]
        same = torch.equal(log[: cbits + 1], elog)
        lprog.finish()
    check(tail_zero and same and lprog.rows > cbits + 1,
          f"27 {label}: the bucket's log past nbits ({tail_zero}) or up to "
          f"it ({same})")
    reset_counts()
    row["prefix"] = {"bits": cbits, "log_rows": lprog.rows,
                     "rows_past_nbits_zero": True}
    # timings: eager body, program, its log-only form (the decode and the
    # log) and its expansion-only form, median of 5 to a sync
    crec, clog, cwords, _ = meta_expand.decode_event_log(data, mn, *geo, DEV)
    row["trace_eager_ms"] = median_ms(synced(
        lambda: meta_expand.decode_with_metadata_eager(data, mn, *geo,
                                                       *wire, DEV)))
    row["trace_program_ms"] = median_ms(synced(
        lambda: meta_expand.decode_with_metadata(data, mn, *geo, *wire,
                                                 DEV)))
    row["log_program_ms"] = median_ms(synced(
        lambda: meta_expand.decode_event_log(data, mn, *geo, DEV)))
    row["expand_program_ms"] = median_ms(synced(
        lambda: meta_expand.expand_event_log(clog, cwords, nbits, *geo,
                                             *wire)))
    row["expansion_share_program_ms"] = (row["trace_program_ms"]
                                         - row["log_program_ms"])
    row["decode_rec_eager_ms"] = median_ms(synced(
        lambda: decoder.decode(data, mn, *geo, device=DEV)))
    # what the bucket costs: 2^17 bits fill their bucket's log, 32 bits
    # more take the next bucket, with twice the rows
    for tag, cut in (("2^17 bits", data[: 1 << 14]),
                     ("2^17 + 32 bits", data[: (1 << 14) + 4])):
        row[f"bucket {tag}"] = {
            "rows": tt.trace_program(*geo, *wire, len(cut) * 8, DEV).rows,
            "program_ms": median_ms(synced(
                lambda: meta_expand.decode_with_metadata(cut, mn, *geo,
                                                         *wire, DEV))),
            "eager_ms": median_ms(synced(
                lambda: meta_expand.decode_with_metadata_eager(
                    cut, mn, *geo, *wire, DEV)))}
    if decoder.has_duplicate_parents(*geo[1:]):
        row["replay_passes"] = meta_expand.replay_passes(*geo[1:])
        # the in-order replay alone, eagerly, on this stream's sorted events
        lg = clog.to(torch.int64)
        t = torch.arange(lg.numel(), device=DEV)
        key = torch.where(lg != 0, lg & 0xFFFFFFFF, encoder.MAX_CELLS)
        order = torch.sort((key << 32) | t).indices
        ks = key[order]
        start = torch.ones_like(ks, dtype=torch.bool)
        start[1:] = ks[1:] != ks[:-1]
        sidx = torch.cummax(torch.where(start, t, 0), 0).values
        act, nv = (lg >> 32) & 7, ((lg >> 35) & 31) - 1
        live = (lg != 0) & (t < nbits)
        wi = cwords.to(torch.int64) & 0xFFFFFFFF
        bit = (wi[(t >> 5).clamp(max=cwords.numel() - 1)] >> (t & 31)) & 1
        args = (sidx, (live & ((act == 1) | (act == 4)))[order],
                (live & (act == 6))[order], bit[order], nv[order],
                row["replay_passes"])
        row["replay_eager_ms"] = median_ms(synced(
            lambda: meta_expand._replay_in_order(*args)))
        del lg, t, key, order, ks, start, sidx, args
    row["programs"] = program_rows(tt.programs())
    del crec, clog, cwords
    return row


def phase_host_programs(im_a, im_b, er_a, er_b, ims_a, mbs_a, host_ers,
                        host_ers_b, smi):
    """Phase 27 (module docstring): the trace, the host-scheduled codec's
    device steps and the standalone transforms as programs, against their
    eager bodies and phases 12-13 bit for bit; their launches on a first
    call and a replay; replays with no sync before their reads; eager and
    program timings, first calls and pools. Gated on equalities and
    counts only."""
    t0 = time.perf_counter()
    tt = torch_transform
    nat = native.load()
    f32 = torch.float32
    out = {"phase": "27 the trace, the host-scheduled steps and the "
           "transforms as programs", "card": smi}
    # ---- (a) the trace ----
    out["trace_A"] = trace_programs("A", er_a, CONFIG_A, None,
                                    "spiht_decode_lsp_log", nat)
    out["trace_B"] = trace_programs("B", er_b, CONFIG_B, 3,
                                    "spiht_decode_seq_log", nat)
    # ---- (b) the host-scheduled codec at A16, float32 ----
    tt.clear_programs()
    torch.cuda.empty_cache()
    want = [(e.encoded_bytes, e.max_n) for e in host_ers]
    want_b = [(e.encoded_bytes, e.max_n) for e in host_ers_b]
    eager_enc, eager_dec = eager_host_codec(ims_a, CONFIG_A, None, f32)
    check(eager_enc(None) == want and eager_enc(mbs_a) == want_b,
          "27: the eager host steps' streams != phase 13's")
    no_budget = switched({"SPIHT_TPU_BUDGET_TRANSFER": "0"})
    row = {"batch": len(ims_a)}
    try:
        for what in ("first", "replay"):
            reset_counts()
            got, row[f"encode_standard_{what}_ms"] = timed(
                lambda: pt.encode_images(ims_a, CONFIG_A, None, None,
                                         device=DEV, dtype=f32))
            program_launch("spiht_quantize_compact", "forward_compact")
            check([(e.encoded_bytes, e.max_n) for e in got] == want,
                  f"27 encode_images {what}: streams != phase 13's")
        row["encode_standard_program_ms"] = median_ms(
            lambda: pt.encode_images(ims_a, CONFIG_A, None, None,
                                     device=DEV, dtype=f32))
    finally:
        no_budget.stop()
    row["encode_standard_eager_ms"] = median_ms(lambda: eager_enc(None))
    for what in ("first", "replay"):
        reset_counts()
        got, row[f"encode_budget_{what}_ms"] = timed(
            lambda: pt.encode_images(ims_a, CONFIG_A, None, mbs_a,
                                     device=DEV, dtype=f32))
        check(not nonzero()
              and [(e.encoded_bytes, e.max_n) for e in got] == want_b,
              f"27 budget path {what}: launches {nonzero()} or streams")
    row["encode_budget_program_ms"] = median_ms(
        lambda: pt.encode_images(ims_a, CONFIG_A, None, mbs_a, device=DEV,
                                 dtype=f32))
    row["encode_budget_eager_ms"] = median_ms(lambda: eager_enc(mbs_a))
    ref = eager_dec(host_ers_b)
    h, w = ims_a[0].shape[1:]
    for what in ("first", "replay"):
        reset_counts()
        imgs, row[f"decode_{what}_ms"] = timed(
            lambda: pt.decode_images(host_ers_b, CONFIG_A, device=DEV))
        n = nonzero()
        check(n == (inverse_launches(h, w, CONFIG_A, None)
                    if what == "first" else {})
              and all(np.array_equal(a, b) for a, b in zip(imgs, ref)),
              f"27 decode_images {what}: launches {n}, or images != the "
              "eager inverse's")
    row["decode_program_ms"] = median_ms(
        lambda: pt.decode_images(host_ers_b, CONFIG_A, device=DEV))
    row["decode_eager_ms"] = median_ms(lambda: eager_dec(host_ers_b))
    for k in [k for k in row if k.endswith("_ms") and "first" not in k
              and "replay" not in k]:
        row[k.replace("_ms", "_images_per_s")] = len(ims_a) / row[k] * 1e3
    row["programs"] = program_rows(tt.programs())
    out["host_A16_f32"] = row
    # ---- (c) analysis_fn / synthesis_fn at A ----
    tt.clear_programs()
    torch.cuda.empty_cache()
    c, h, w = im_a.shape
    x = torch.as_tensor(im_a, device=DEV)
    ana = tt.analysis_fn(CONFIG_A, None)
    syn = tt.synthesis_fn(CONFIG_A, h, w, None)
    arr_e, ll_h, ll_w = tt.forward(x, CONFIG_A, None)
    maps_e = significance_maps(arr_e, ll_h, ll_w)
    img_e = inverse(arr_e, h, w, None, CONFIG_A)
    row = {}
    for what in ("first", "replay"):
        reset_counts()
        got, row[f"analysis_{what}_ms"] = timed(synced(lambda: ana(x)))
        img, row[f"synthesis_{what}_ms"] = timed(synced(
            lambda: syn(got[0])))
        # the inverse program: a launch a level and the IPT model's, in its
        # warm-up and capture
        n = nonzero()
        check(n == (inverse_launches(h, w, CONFIG_A, None)
                    if what == "first" else {})
              and all(torch.equal(a, b) for a, b in
                      zip(got, (arr_e,) + maps_e))
              and torch.equal(img, img_e),
              f"27 analysis_fn / synthesis_fn {what}: launches "
              f"{n} or != the eager forward, maps, inverse")
    row["analysis_eager_ms"] = median_ms(synced(lambda: (
        lambda a: significance_maps(a[0], a[1], a[2]))(
            tt.forward(x, CONFIG_A, None))))
    row["analysis_program_ms"] = median_ms(synced(lambda: ana(x)))
    row["synthesis_eager_ms"] = median_ms(synced(
        lambda: inverse(arr_e, h, w, None, CONFIG_A)))
    row["synthesis_program_ms"] = median_ms(synced(lambda: syn(arr_e)))
    row["programs"] = program_rows(tt.programs())
    out["transforms_A"] = row
    # ---- (d) replays with no sync before their reads ----
    slices, eh, ew = get_slices_and_h_w(h, w, CONFIG_A, None)
    geo = (c, eh, ew, slices[0][1].stop, slices[0][2].stop)
    wire = slices_to_wire(slices)
    data, mn = er_a.encoded_bytes, er_a.max_n
    tprog = tt.trace_program(*geo, *wire, len(data) * 8, DEV)
    with tprog.lock:
        tprog.start([data], len(data) * 8, mn)
        tprog.finish()
    cprog = tt.compact_program(CONFIG_A, (len(ims_a),) + ims_a[0].shape,
                               None, f32, torch.float64, DEV)
    fprog = tt.forward_program(CONFIG_A, x.shape, None, torch.float64, True,
                               x.dtype, DEV)
    iprog = tt.inverse_program(CONFIG_A, arr_e.shape, h, w, None,
                               torch.float64, False, arr_e.dtype, DEV)
    with cprog.lock:
        cprog.start(ims_a)
        cprog.host()
    torch.cuda.synchronize()
    with tprog.lock, cprog.lock, fprog.lock, iprog.lock:
        torch.cuda.set_sync_debug_mode("error")
        try:
            tprog.start([data], len(data) * 8, mn)
            cprog.start(ims_a)
            fprog.start(x)
            iprog.start(arr_e)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rec, meta = tprog.finish()
        a16 = cprog.host()[0]
        fa = fprog.fresh()
        fi = iprog.fresh()[0]
    want_t = nat.decode_with_metadata(data, mn, *geo, *wire)
    check(np.array_equal(rec.cpu().numpy(), want_t[0])
          and np.array_equal(meta.cpu().numpy(), want_t[1])
          and torch.equal(fa[0], arr_e) and torch.equal(fi, img_e)
          and a16.shape[0] == len(ims_a),
          "27: the replays without a sync")
    out["replays_without_sync"] = ["trace", "forward_compact", "forward",
                                   "inverse"]
    tt.clear_programs()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


def run_phases() -> list:
    """Phases 2-27; returns the kernels' rows of the result line."""
    phase_small()

    # golden digests through the card (the repo's own locked streams)
    for seed, s, lvl, mb, want in GOLDEN:
        er = pt.encode_image_device(image(seed, (3, 64, 64)), s, lvl, mb,
                                    device=DEV)
        h = hashlib.sha256(er.encoded_bytes + bytes([er.max_n])).hexdigest()
        if s.color_model is None:
            check(h == want, f"golden case {seed} digest on the card")
        print(f"golden case {seed}: {'match' if h == want else 'DIFFERS'}"
              f"{'' if s.color_model is None else ' (IPT: reported only)'}")

    # ---- phase 3: configuration A ----
    im_a = image(1, (3, 512, 512))
    er_a, n_a, enc_a, dec_a, _ = main_path(
        "A", CONFIG_A, None, im_a, 512 * 512, "spiht_decode_lsp")
    # ---- phase 4: configuration B (odd LL) ----
    im_b = image(2, (3, 512, 512))
    er_b, n_b, enc_b, dec_b, er_b_cpu = main_path(
        "B", CONFIG_B, 3, im_b, 512 * 512, "spiht_decode_seq")
    check(er_b_cpu.encoded_bytes == er_b.encoded_bytes,
          "B: card stream != CPU port stream (no colour model: must agree)")

    # ---- phase 5: embedded stream ----
    quarter = er_a.encoded_bytes[: len(er_a.encoded_bytes) // 4]
    c, h, w = im_a.shape
    slices, enc_h, enc_w = get_slices_and_h_w(h, w, CONFIG_A, None)
    ll = (slices[0][1].stop, slices[0][2].stop)
    cmp_decode(quarter, er_a.max_n, c, enc_h, enc_w, *ll)
    er_q = pt.EncodingResult(quarter, h, w, c, er_a.max_n, None)
    prev = pt.decode_image_device(er_q, CONFIG_A, device=DEV)
    check(bool(torch.isfinite(prev).all()), "embedded preview not finite")
    print(f"phase 5 ok: {len(quarter)}-byte prefix decodes equal on card "
          "and plain")

    # ---- phase 6: timings ----
    timing = {"timing": "round trip, median of 5, host clock to sync"}
    for label, im, er, settings, level in (
        ("A", im_a, er_a, CONFIG_A, None), ("B", im_b, er_b, CONFIG_B, 3),
    ):
        timing[f"{label}_encode_ms"] = median_ms(
            lambda: pt.encode_image_device(im, settings, level, 512 * 512,
                                           device=DEV))
        timing[f"{label}_decode_ms"] = median_ms(
            lambda: pt.decode_image_device(er, settings, device=DEV))
    print(json.dumps(timing))
    for label, im, er, settings, level in (
        ("A", im_a, er_a, CONFIG_A, None), ("B", im_b, er_b, CONFIG_B, 3),
    ):
        profile_round_trip(label, lambda: (
            pt.encode_image_device(im, settings, level, 512 * 512,
                                   device=DEV),
            pt.decode_image_device(er, settings, device=DEV)))

    # ---- phases 7-10: the batched codec ----
    phase_batch_small()
    ims_a = [image(100 + b, (3, 512, 512)) for b in range(16)]
    mbs_a = [BUDGETS_A[b % 4] for b in range(16)]
    ers_a, nb_a, encb_a, decb_a = batch_main_path(
        "A batch", CONFIG_A, None, ims_a, mbs_a, "spiht_decode_lsp_batch")
    ims_b = [image(200 + b, (3, 512, 512)) for b in range(8)]
    ers_b, nb_b, _, decb_b = batch_main_path(
        "B batch", CONFIG_B, 3, ims_b, [512 * 512] * 8,
        "spiht_decode_seq_batch")
    phase_throughput(ims_a, mbs_a, ers_a, encb_a, decb_a)

    # ---- phases 11-13: B2-log, B6, B7 and the paths that run them ----
    phase_new_kernels_small()
    log_a, n_log, log_b, n_log_b, seq_a, n_seq = phase_metadata(
        im_a, im_b, er_a, er_b)
    q_a, n_q, host_ers, host_ers_b = phase_host_batch(ims_a, mbs_a)

    # ---- phase 14: the decoders' step edges on the card ----
    phase_prefix_sweep(er_a, er_b)

    # ---- phase 15: the encoder's budget edges on the card ----
    phase_encode_edges(im_a, im_b)

    # ---- phase 16: large geometries, and a batch past one wave ----
    phase_large()
    phase_wave(ims_a)

    # ---- phase 17: the dependent-chain spikes ----
    spikes, n_spikes = phase_spikes()

    # ---- phase 18: the machine and block spikes ----
    blocks, n_blocks = phase_machine_spikes()

    # ---- phase 19: the host surface (colour models, backends, CLI) ----
    phase_host_surface(im_a, im_b, er_a, er_b, ims_a, mbs_a, ers_a)

    # ---- phase 20: the fallback machines (no kernel of theirs) ----
    phase_fallback(im_a, im_b, er_a, er_b, ims_a, mbs_a, ers_a)

    # ---- phase 21: parallel/ and the examples ----
    ref8k = phase_parallel(ims_a, card())

    # ---- phase 22: refusals, the reference's names, the bench ----
    phase_surface(im_a, im_b, er_a, er_b)

    # ---- phase 23: the JAX package's documented switches ----
    phase_switches(im_a, im_b, er_a, er_b, ims_a, mbs_a, ers_a, ers_b)

    # ---- phase 25: the round trip as one program a key ----
    phase_program(im_a, im_b, er_a, er_b, prev, ref8k, card())

    # ---- phase 26: the batch codec as one program a key ----
    phase_batch_program(ims_a, mbs_a, ers_a, ims_b, ers_b, card())

    # ---- phase 27: the trace, the host-scheduled steps, the transforms ----
    phase_host_programs(im_a, im_b, er_a, er_b, ims_a, mbs_a, host_ers,
                        host_ers_b, card())

    # ---- phase 24: the mesh over the ranks of a process group ----
    phase_ranks(ref8k, card())
    del ref8k

    # ---- phase 28: the decode's inverse DWT, one kernel a level ----
    syn = phase_synthesis()

    # ---- phase 29: IPT's inverse colour model, one kernel ----
    ipt = phase_ipt_inverse()

    runs = {
        "spiht_encode": (enc_a, n_a["spiht_encode"]),
        "spiht_decode_lsp": (dec_a, n_a["spiht_decode_lsp"]),
        "spiht_decode_seq": (dec_b, n_b["spiht_decode_seq"]),
        "spiht_decode_seq_batch": (decb_b, nb_b["spiht_decode_seq_batch"]),
        "spiht_encode_batch": (encb_a, nb_a["spiht_encode_batch"]),
        "spiht_decode_lsp_batch": (decb_a, nb_a["spiht_decode_lsp_batch"]),
        "spiht_decode_lsp_log": (log_a, n_log),
        "spiht_decode_seq_log": (log_b, n_log_b),
        "spiht_quantize_compact": (q_a, n_q),
        "spiht_encode_seq": (seq_a, n_seq),
        **{name: (st, n_spikes[name]) for name, st in spikes.items()},
        **{name: (st, n_blocks[name]) for name, st in blocks.items()},
    }
    rows = []
    for name, (stats, launches) in runs.items():
        k = KERNELS[name]
        ms = time_kernel(k["wrapper"], stats["args"])
        bound, bound_by = bound_ms(name, stats)
        rows.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": launches,
            "max_abs_err": stats["max_abs_err"], "ms": ms,
            "plain_ms": stats["plain_ms"],
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None,
        })
        print(json.dumps({"kernel_timing": name, "ms": ms,
                          "plain_ms": stats["plain_ms"],
                          "bound_ms": bound,
                          "launches_on_its_main_path": launches}))
    rows.append({
        "name": "spiht_idwt_level", "route": "cuda",
        "source": KERNELS["spiht_idwt_level"]["source"], "replaces": None,
        "launches": nb_a["spiht_idwt_level"], "max_abs_err": 0.0,
        "ms": syn["ms"], "plain_ms": syn["plain_ms"],
        "bound_ms": syn["bound_ms"], "bound_by": "bytes", "library_ms": None,
    })
    print(json.dumps({"kernel_timing": "spiht_idwt_level", "ms": syn["ms"],
                      "plain_ms": syn["plain_ms"],
                      "bound_ms": syn["bound_ms"],
                      "launches_on_its_main_path": nb_a["spiht_idwt_level"]}))
    rows.append({
        "name": "spiht_ipt_inverse", "route": "cuda",
        "source": KERNELS["spiht_ipt_inverse"]["source"], "replaces": None,
        "launches": nb_a["spiht_ipt_inverse"], "max_abs_err": 0.0,
        "ms": ipt["ms"], "plain_ms": ipt["plain_ms"],
        "bound_ms": ipt["bound_ms"], "bound_by": "bytes", "library_ms": None,
    })
    print(json.dumps({"kernel_timing": "spiht_ipt_inverse", "ms": ipt["ms"],
                      "plain_ms": ipt["plain_ms"],
                      "bound_ms": ipt["bound_ms"],
                      "launches_on_its_main_path":
                          nb_a["spiht_ipt_inverse"]}))
    return rows


# ---------------------------------------------------------------------------
# phase 28: the decode's inverse DWT as one kernel a level
# ---------------------------------------------------------------------------

# the cells' shapes: (label, images, (C, H, W))
SYNTHESIS_CELLS = (("kodak_batch_24", 24, (3, 512, 768)),
                   ("nuscenes_sweep_6", 6, (3, 900, 1600)),
                   ("uhd_single", 1, (3, 2160, 3840)))


def phase_synthesis() -> dict:
    """Phase 28: ``spiht_idwt_level`` at the cells' shapes, in float64 and
    float32, against its plain version on the card, the launches of a
    call counted from 0. Returns the kernel's timings at the Kodak batch
    in float64 (the bench's) for its row of the result line."""
    s = CONFIG_A
    kodak = None
    for label, n, shape in SYNTHESIS_CELLS:
        c, h, w = shape
        ims = torch.as_tensor(np.stack([image(300 + b, shape)
                                        for b in range(n)]), device=DEV)
        arr, _, _ = forward(ims, s, None)
        del ims
        slices, _, _ = get_slices_and_h_w(h, w, s, None)
        level = len(slices) - 1
        for dtype in (torch.float64, torch.float32):
            reset_counts()
            got = synthesis_kernels.waverec2_packed(arr, slices, s, dtype)
            torch.cuda.synchronize()
            n = nonzero()
            check(n == {"spiht_idwt_level": level},
                  f"28 {label}: launches {n}, want {level} of "
                  "spiht_idwt_level")
            want = synthesis_kernels.waverec2_packed_plain(arr, slices, s,
                                                           dtype)
            bits = torch.int64 if dtype == torch.float64 else torch.int32
            check(got.shape == want.shape
                  and torch.equal(got.view(bits), want.view(bits)),
                  f"28 {label} {dtype}: kernel != plain version")
            moved = arr.numel() * arr.element_size() + (
                got.numel() * got.element_size())
            del got, want
            args = (arr, slices, s, dtype)
            row = {
                "phase": "28 spiht_idwt_level", "shape": label,
                "dtype": str(dtype).split(".")[-1], "levels": level,
                "launches_a_call": level, "bit_equal_plain": True,
                "ms": time_kernel(synthesis_kernels.waverec2_packed, args),
                "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                "plain_ms": median_ms(
                    lambda: synthesis_kernels.waverec2_packed_plain(*args)),
                "card": card(),
            }
            print(json.dumps(row))
            if label == "kodak_batch_24" and dtype == torch.float64:
                kodak = row
        del arr
        torch.cuda.empty_cache()
    print("phase 28 ok: spiht_idwt_level == its plain version bit for bit "
          "at the Kodak batch, the nuScenes sweep and the UHD frame, "
          "float64 and float32")
    reset_counts()
    return kodak


# ---------------------------------------------------------------------------
# phase 29: IPT's inverse colour model as one kernel
# ---------------------------------------------------------------------------

# float64 operations a pixel besides its three pows: three 3x3 products (9
# multiplies and 6 adds each) and the signed power's three multiplies
IPT_OPS_A_PIXEL = 3 * (9 + 6) + 3
FP64_OPS_PER_S = 33.5e12  # H100 SXM float64 outside the tensor cores


def phase_ipt_inverse() -> dict:
    """Phase 29: ``spiht_ipt_inverse`` at the cells' shapes, in float64
    and float32, on the IPT image of seeded RGB images and on a crop of it:
    bit for bit ``torch_models.convert(x, "ipt", "RGB")`` on the card, one
    launch a call (counted from 0). Returns the plain version's and the
    kernel's timings at the Kodak batch in float64 (the bench's) for its
    row of the result line."""
    kodak = None
    for label, n, shape in SYNTHESIS_CELLS:
        rgb = torch.as_tensor(np.stack([image(400 + b, shape)
                                        for b in range(n)]), device=DEV)
        if n == 1:
            rgb = rgb[0]  # the single decode's (3, H, W)
        for dtype in (torch.float64, torch.float32):
            x = torch_models.convert(rgb.to(dtype), "RGB", "ipt")
            for view, im in (("whole", x), ("crop", x[..., 1:-2, 3:-4])):
                reset_counts()
                got = synthesis_kernels.rgb_from_ipt(im)
                torch.cuda.synchronize()
                n_l = nonzero()
                check(n_l == {"spiht_ipt_inverse": 1},
                      f"29 {label} {view}: launches {n_l}")
                want = torch_models.convert(im, "ipt", "RGB")
                bits = torch.int64 if dtype == torch.float64 else torch.int32
                check(got.shape == want.shape and got.is_contiguous()
                      and torch.equal(got.view(bits), want.view(bits)),
                      f"29 {label} {view} {dtype}: kernel != torch ops")
                del got, want
            pixels = x.numel() // 3
            moved = 2 * x.numel() * x.element_size()
            ms = time_kernel(synthesis_kernels.rgb_from_ipt, (x,))
            row = {
                "phase": "29 spiht_ipt_inverse", "shape": label,
                "dtype": str(dtype).split(".")[-1], "launches_a_call": 1,
                "bit_equal_torch_ops": True, "ms": ms,
                "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                "gb_s": moved / ms / 1e6,
                "pows_per_s": 3 * pixels / ms * 1e3,
                "plain_ms": time_kernel(
                    lambda im: torch_models.convert(im, "ipt", "RGB"), (x,)),
                "card": card(),
            }
            if dtype == torch.float64:
                # what each pow could take of the card's float64 rate, were
                # the kernel bound by it
                row["fp64_ops_a_pow_at_this_rate"] = (
                    FP64_OPS_PER_S * ms / 1e3 - IPT_OPS_A_PIXEL * pixels) / (
                    3 * pixels)
            print(json.dumps(row))
            if label == "kodak_batch_24" and dtype == torch.float64:
                kodak = row
            del x
        del rgb
        torch.cuda.empty_cache()
    print("phase 29 ok: spiht_ipt_inverse == torch_models.convert's torch ops "
          "bit for bit at the Kodak batch, the nuScenes sweep and the UHD "
          "frame, whole and cropped, float64 and float32")
    reset_counts()
    return kodak


def main(ranks_only=False) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # ---- phase 1 ----
    smi = card()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    # the native scheduler (g++) builds beside the kernels (nvcc)
    native_err = []

    def build_native():
        try:
            native.load()
        except Exception as e:  # re-raised below, in the main thread
            native_err.append(e)

    t0 = time.perf_counter()
    native_build = threading.Thread(target=build_native)
    native_build.start()
    secs, log = _build.build_all()
    for name in _build.SIGNATURES:
        _build.load(name)
    native_build.join()
    if native_err:
        raise native_err[0]
    print(f"kernel build: {secs:.2f} s (nvcc, all sources in parallel); "
          f"with the native scheduler (g++): "
          f"{time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if ("registers" in line or "spill" in line or "error" in line
                or "Compiling entry" in line):
            print("  " + line.strip())

    if ranks_only:
        phase_ranks(ranks_reference(), smi)
    else:
        print_kernels(run_phases())
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s from the build on")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def print_kernels(rows) -> None:
    """The result's kernel lines: why library_ms is null, and the rows."""
    print(json.dumps({"library_ms": None,
                      "why": "no PyTorch call computes a SPIHT bit machine "
                             "(B1-B5, B2-log, B3-log, B7), no single PyTorch "
                             "call computes B6's four outputs (int32 "
                             "quantize, int16 clip, level map, overflow "
                             "flag), none a dependent chain of K reads or "
                             "of K decoder steps (S1-S4), none S5's block "
                             "iteration (scan, compaction and emission "
                             "together), none S6's token closure: a "
                             "chain of K dependent windows, each seven "
                             "thresholded squarings, not one product, "
                             "none a level of the dequantizing "
                             "inverse DWT (spiht_idwt_level), and none "
                             "IPT's inverse colour model "
                             "(spiht_ipt_inverse)"}))
    print(json.dumps({"kernels": rows}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(*sys.argv[2:]))
    sys.exit(main(ranks_only=sys.argv[1:] == ["--ranks"]))
