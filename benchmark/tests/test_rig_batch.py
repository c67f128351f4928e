"""The batch path that the nuScenes cell and the mixed-budget cell drive,
against the plain reference on the CPU.

At a small frame with the rig's 16:9 aspect and an odd LL in both
dimensions (3x45x80 at level 2: LL 15x23, as the full 1600x900 frame's
11x17), a batch of six, one camera sweep, goes through the port's
``encode_images_device`` (B4 over duplicate-parent trees) and
``decode_images_device`` (batched B3) on the CPU, at one budget and at
the six budgets of ``batch-mixbpp``: the streams and max_n equal the
reference's byte for byte, the images its decoder's within 1e-12. The
two mixes give the budgets their cells state."""

import collections

import pytest
import torch

from benchmark import cell, images, spec
from benchmark.reference import spiht
from benchmark.reference import transform as ref

CFG = spec.cell("nuscenes-sweep-1bpp")["config"]
SHAPE, LEVEL = (3, 45, 80), 2
MIXED = spec.traffic("batch-mixbpp")["bpp"]


def test_the_small_frame_keeps_the_rigs_geometry():
    from spiht_tpu_torch.codec.decoder import has_duplicate_parents

    for (c, h, w), level in ((SHAPE, LEVEL), (CFG["shape"], CFG["level"])):
        geo = ref.geometry(h, w, level)
        assert geo["ll_h"] % 2 == 1 and geo["ll_w"] % 2 == 1
        assert has_duplicate_parents(geo["enc_h"], geo["enc_w"],
                                     geo["ll_h"], geo["ll_w"])
        assert w * 9 == h * 16


@pytest.mark.parametrize("bpp", [[1.0], MIXED], ids=["equal", "mixed"])
def test_sweep_equals_the_reference(bpp):
    import spiht_tpu_torch as pt

    c, h, w = SHAPE
    st = pt.SpihtSettings(**CFG["settings"])
    cfg = dict(CFG["settings"], level=LEVEL)
    ims = images.make(6, h, w, 2**31 + 23, "cpu")
    budgets = [cell.budget(bpp[i % len(bpp)], h, w) for i in range(6)]
    ers = pt.encode_images_device(ims, st, LEVEL, budgets, device="cpu")
    outs = pt.decode_images_device(ers, st, device="cpu")
    ll_h, ll_w = ref.ll_size(h, w, LEVEL)
    for im, mb, er, got in zip(ims, budgets, ers, outs):
        arr = ref.forward(torch.from_numpy(im), cfg)
        data, _, max_n, rec = spiht.encode(arr, ll_h, ll_w, mb)
        assert (er.encoded_bytes, er.max_n) == (data, max_n)
        want = ref.inverse(rec, cfg, h, w)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-12


@pytest.mark.parametrize("name, batch, each", [
    ("kodak-batch-mixbpp", 24,
     {39320: 4, 98304: 4, 196608: 4, 393216: 4, 589824: 4, 786432: 4}),
    ("nuscenes-sweep-1bpp", 6, {1440000: 6}),
])
def test_mix_budgets_a_batch(name, batch, each):
    """Each request of the cell's pool holds ``batch`` distinct images,
    with ``each`` of every budget: four of each of the six in a mixed
    batch of 24, six at 1.44 M bits in a sweep."""
    c = spec.cell(name)
    _, h, w = c["config"]["shape"]
    reqs = cell.requests(c["traffic"], h, w)
    assert len(reqs) == c["traffic"]["pool"] == 4
    assert sorted(i for idx, _ in reqs for i in idx) == list(
        range(4 * batch))
    for idx, budgets in reqs:
        assert len(idx) == batch
        assert collections.Counter(budgets) == each
