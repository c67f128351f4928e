"""Kernels on the card against their plain versions, at small shapes.

These need a CUDA device and nvcc; they skip without them. On a machine
with the card run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from spiht_tpu_torch.codec import decoder, encoder

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,ll", [((3, 24, 32), (6, 8)),
                                      ((3, 19, 19), (5, 5))])
def test_kernels_equal_plain_versions(cuda, shape, ll):
    arr = (np.random.default_rng(0).standard_normal(shape) * 400).astype(
        np.int32)
    for mb in (2**31 - 2, 1, 333, 1000):
        got = encoder.encode(arr, *ll, mb, device=cuda)
        assert got == encoder.encode(arr, *ll, mb, device="cpu")
    data, mn = got
    for cut in (len(data), len(data) // 2, 1):
        k = decoder.decode(data[:cut], mn, *shape, *ll, device=cuda)
        p = decoder.decode(data[:cut], mn, *shape, *ll, device="cpu")
        assert torch.equal(k.cpu(), p)


def test_wrappers_count_launches(cuda):
    arr = np.zeros((1, 16, 16), np.int32)
    arr[0, 2, 3] = 77
    n0 = encoder.encode_machine.launches
    data, mn = encoder.encode(arr, 4, 4, device=cuda)
    assert encoder.encode_machine.launches == n0 + 1
    n0 = decoder.decode_lsp.launches
    decoder.decode(data, mn, 1, 16, 16, 4, 4, device=cuda)
    assert decoder.decode_lsp.launches == n0 + 1


@pytest.mark.parametrize("shape,ll", [((3, 24, 32), (6, 8)),
                                      ((3, 19, 19), (5, 5))])
def test_batched_kernels_equal_plain_versions(cuda, shape, ll):
    """B4, then B5 (or batched B3 for the odd LL) on streams of different
    budgets and lengths: equal to the plain versions and, stream by
    stream, to the single-stream kernels."""
    rng = np.random.default_rng(1)
    arrs = np.stack([(rng.standard_normal(shape) * s).astype(np.int32)
                     for s in (400, 3, 9000, 60)])
    arrs[1] = 0
    mbs = [2**31 - 2, 1, 333, 2897]
    got = encoder.encode_batch(arrs, *ll, mbs, device=cuda)
    assert got == encoder.encode_batch(arrs, *ll, mbs, device="cpu")
    assert got == [encoder.encode(a, *ll, mb, device=cuda)
                   for a, mb in zip(arrs, mbs)]
    datas = [got[0][0], got[1][0], got[2][0][:7], got[3][0][:1]]
    mns = [mn for _, mn in got]
    k = decoder.decode_batch(datas, mns, *shape, *ll, device=cuda)
    p = decoder.decode_batch(datas, mns, *shape, *ll, device="cpu")
    assert torch.equal(k.cpu(), p)
    for b in range(4):
        one = decoder.decode(datas[b], mns[b], *shape, *ll, device=cuda)
        assert torch.equal(k[b], one)


def test_batched_wrappers_count_launches(cuda):
    arrs = np.zeros((3, 1, 16, 16), np.int32)
    arrs[:, 0, 2, 3] = [77, 5, 900]
    n0 = encoder.encode_machine_batch.launches
    got = encoder.encode_batch(arrs, 4, 4, device=cuda)
    assert encoder.encode_machine_batch.launches == n0 + 1
    n0 = decoder.decode_lsp_batch.launches
    decoder.decode_batch([d for d, _ in got], [m for _, m in got], 1, 16, 16,
                         4, 4, device=cuda)
    assert decoder.decode_lsp_batch.launches == n0 + 1


def _event_log_case(cuda, cut):
    arr = (np.random.default_rng(2).standard_normal((3, 24, 32)) * 900
           ).astype(np.int32)
    data, mn = encoder.encode(arr, 6, 8, device="cpu")
    data = data[:cut]
    out = []
    for dev in (cuda, torch.device("cpu")):
        words, nbits = decoder.words_tensor(data, dev)
        out.append(decoder.decode_lsp_log(
            *decoder.machine_args(words, nbits, mn, 3, 24, 32, 6, 8)))
    return out


@pytest.mark.parametrize("cut", [None, 0, 1, 7, 100])
def test_log_kernel_equals_plain_version(cuda, cut):
    """B2-log: stat, LSP queues and every event word, the row at nbits
    included, equal the plain version's."""
    (kl, kv, ks, klog), (pl, pv, ps, plog) = _event_log_case(cuda, cut)
    assert ks.tolist() == ps.tolist()
    live = int(ps[0])
    assert torch.equal(kl[:live].cpu(), pl[:live])
    assert torch.equal(kv[:live].cpu(), pv[:live])
    assert torch.equal(klog.cpu(), plog)


@pytest.mark.parametrize("shape,ll", [((3, 24, 32), (6, 8)),
                                      ((3, 19, 19), (5, 5))])
def test_seq_encoder_kernel_equals_plain_version(cuda, shape, ll):
    arr = (np.random.default_rng(3).standard_normal(shape) * 400).astype(
        np.int32)
    for mb in (2**31 - 2, 1, 333, 1000):
        got = encoder.encode(arr, *ll, mb, device=cuda, machine="seq")
        assert got == encoder.encode(arr, *ll, mb, device="cpu")
        assert got == encoder.encode(arr, *ll, mb, device=cuda)


@pytest.mark.parametrize("spread", [3.0, 900.0, 40000.0])
def test_quantize_kernel_equals_plain_version(cuda, spread):
    from spiht_tpu_torch.ops.quantize_kernels import quantize_compact

    x = torch.as_tensor((np.random.default_rng(4).standard_normal(
        (3, 61, 37)) * spread).astype(np.float32))
    k = quantize_compact(x.to(cuda), 1.7)
    p = quantize_compact(x, 1.7)
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b)
    assert bool(k[3]) == (spread > 10000)


def test_new_wrappers_count_launches(cuda):
    from spiht_tpu_torch.ops.quantize_kernels import quantize_compact

    n0 = decoder.decode_lsp_log.launches
    _event_log_case(cuda, None)
    assert decoder.decode_lsp_log.launches == n0 + 1
    n0 = encoder.encode_machine_seq.launches
    encoder.encode(np.ones((1, 16, 16), np.int32), 4, 4, device=cuda,
                   machine="seq")
    assert encoder.encode_machine_seq.launches == n0 + 1
    n0 = quantize_compact.launches
    quantize_compact(torch.ones(5, device=cuda), 3.0)
    assert quantize_compact.launches == n0 + 1


def test_host_scheduled_batch_codec_on_the_card(cuda):
    """encode_images / decode_images with the card's transforms (B6 in
    float32) equal the same functions on the CPU where the arithmetic is
    the same (float64), and decode the card's streams exactly as
    decode_images_device does."""
    import spiht_tpu_torch as pt

    rng = np.random.default_rng(5)
    ims = [rng.random((3, 40, 48)) for _ in range(3)]
    s = pt.SpihtSettings()
    for mb in (None, 900):
        got = pt.encode_images(ims, s, 2, mb, device=cuda)
        want = pt.encode_images(ims, s, 2, mb, device="cpu")
        assert [e.encoded_bytes for e in got] == [
            e.encoded_bytes for e in want]
    f32 = pt.encode_images(ims, s, 2, None, device=cuda, dtype=torch.float32)
    dev = pt.encode_images_device(ims, s, 2, None, device=cuda,
                                  dtype=torch.float32)
    assert [e.encoded_bytes for e in f32] == [e.encoded_bytes for e in dev]
    imgs = pt.decode_images(got, s, device=cuda)
    ref = pt.decode_images_device(got, s, device=cuda)
    for a, b in zip(imgs, ref):
        np.testing.assert_array_equal(a, b.cpu().numpy())


def test_metadata_trace_on_the_card(cuda):
    import spiht_tpu_torch as pt
    from spiht_tpu_torch.wavelets.geometry import (
        get_slices_and_h_w, slices_to_wire,
    )

    s = pt.SpihtSettings()
    im = np.random.default_rng(6).random((2, 64, 64))
    er = pt.encode_image(im, s, 3, 6000, device=cuda)
    slices, ph, pw = get_slices_and_h_w(64, 64, s, 3)
    ll = (slices[0][1].stop, slices[0][2].stop)
    wire = slices_to_wire(slices)
    for cut in (None, 1, 37):
        data = er.encoded_bytes[:cut]
        k = pt.decode_with_metadata(data, er.max_n, 2, ph, pw, *ll, *wire,
                                    device=cuda)
        p = pt.decode_with_metadata(data, er.max_n, 2, ph, pw, *ll, *wire,
                                    device="cpu")
        np.testing.assert_array_equal(k[0], p[0])
        np.testing.assert_array_equal(k[1], p[1])


@pytest.mark.parametrize("cut", [None, 0, 1, 7, 100])
def test_seq_log_kernel_equals_plain_version(cuda, cut):
    """B3-log at an odd LL: rec, stat and every event word (the filters
    of nodes with several LL parents included) equal the plain version's."""
    arr = (np.random.default_rng(7).standard_normal((3, 19, 19)) * 900
           ).astype(np.int32)
    data, mn = encoder.encode(arr, 5, 5, device="cpu")
    data = data[:cut]
    out = []
    for dev in (cuda, torch.device("cpu")):
        words, nbits = decoder.words_tensor(data, dev)
        out.append(decoder.decode_seq_log(
            *decoder.machine_args(words, nbits, mn, 3, 19, 19, 5, 5)))
    for k, p in zip(*out):
        assert torch.equal(k.cpu(), p)


def test_spike_kernels_equal_plain_versions(cuda):
    from spiht_tpu_torch.tools import spike_hbm_table as thbm
    from spiht_tpu_torch.tools import spike_pallas_seq as tseq

    for rows, shared in ((8, False), (256, True)):
        words = torch.as_tensor(tseq.words_of(rows))
        for rw in (False, True):
            k = tseq.seq_chain(words.to(cuda), 500, rw, shared)
            p = tseq.seq_chain(words, 500, rw, shared)
            assert torch.equal(k[0].cpu(), p[0])
            assert not rw or torch.equal(k[1].cpu(), p[1])
    perm = torch.as_tensor(thbm.permutation(15))
    for chains, shared in ((1, True), (1, False), (8, False), (16, False)):
        assert torch.equal(
            thbm.table_chain(perm.to(cuda), 300, chains, shared).cpu(),
            thbm.table_chain(perm, 300, chains, shared))
    for chains in (4, 8, 16):
        assert torch.equal(thbm.table_fire(perm.to(cuda), 300, chains).cpu(),
                           thbm.table_fire(perm, 300, chains))


def test_block_and_machine_spikes_equal_plain_versions(cuda):
    """S3 (each B, both layouts), S4, S5 and each of S6's kinds on the
    card equal their plain versions at small sizes; each wrapper counts
    its launches."""
    from spiht_tpu_torch.tools import spike_pallas_block as tblock
    from spiht_tpu_torch.tools import spike_pallas_ilp as tilp
    from spiht_tpu_torch.tools import spike_pallas_machine as tmach
    from spiht_tpu_torch.tools import spike_token_matmul as ttok

    words = torch.as_tensor(tmach.words_of(8))
    size = 891 * tmach.LANES  # not a power of two
    n0 = tmach.machine.launches
    assert tmach.equals_plain(tmach.machine, words.to(cuda), 700,
                              tmach.new_state(1, size, cuda))
    assert tmach.machine.launches == n0 + 1
    n0 = tilp.chains.launches
    for b in tmach.CHAINS:
        for layout in tilp.LAYOUTS:
            assert tilp.equals_plain(tilp.chains, words.to(cuda), 700,
                                     tmach.new_state(b, size, cuda), layout)
    assert tilp.chains.launches == n0 + 2 * len(tmach.CHAINS)
    mag = torch.as_tensor(tblock.mag_of(8))
    n0 = tblock.block.launches
    for niter in (0, 1, 24, 300):
        assert tblock.equals_plain(mag.to(cuda), niter)
    assert tblock.block.launches == n0 + 4
    x = torch.as_tensor(ttok.x_of())
    n0 = ttok.token_heads.launches
    for kind in ttok.KINDS:
        for k in (0, 16, 300):
            assert torch.equal(ttok.token_heads(x.to(cuda), k, kind).cpu(),
                               ttok.token_heads(x, k, kind))
    assert ttok.token_heads.launches == n0 + 3 * len(ttok.KINDS)


def test_chunked_batch_encode_on_the_card(cuda, monkeypatch):
    """The batch encode program on the card, host rows in fronts of 3
    (``FRONT_BYTES`` set to 3 rows) and card rows as one graph: byte for
    byte the eager body's on the card and the CPU program's, for 7, 4
    and 2 images; each call overlaps the rows of every front but the
    last, replays each front it staged and the back once."""
    import spiht_tpu_torch as pt
    from spiht_tpu_torch import torch_transform as tt

    s = pt.SpihtSettings(wavelet="bior2.2", mode="reflect",
                         color_model="ipt", quantization_scale=1.0,
                         per_channel_quant_scales=[100, 20, 20])
    rng = np.random.default_rng(2)
    ims = [rng.random((3, 64, 80)) for _ in range(7)]
    mbs = [3000, 0, -7, 1500, 777, 2500, 4000]
    monkeypatch.setattr(tt, "FRONT_BYTES", 3 * ims[0].nbytes)
    tt.clear_programs()
    want = tt.encode_batch(s, ims, mbs, device="cpu")
    words, stat, max_n = tt.encode_pipeline_batch_eager(s)(
        torch.as_tensor(np.stack(ims), device=cuda), [max(m, 0) for m in mbs])
    totals = [r[0] for r in encoder.check_stat(stat, "eager")]
    assert list(zip(encoder.batch_stream_bytes(words, totals),
                    max_n.tolist())) == want
    prog = tt.encode_batch_program(s, (7, 3, 64, 80), device=cuda,
                                   max_bits=4000)
    assert prog._fronts == [(0, 3), (3, 6), (6, 7)]
    for n in (7, 4, 2):
        assert prog(ims[:n], mbs[:n]) == want[:n]
    assert prog.overlap_rows == 6 + 3 + 0 and prog.staged_rows == 13
    assert prog.front_replays == 3 + 2 + 1 and prog.replays == 3
    assert prog(torch.as_tensor(np.stack(ims), device=cuda), mbs) == want
    assert prog.overlap_rows == 9 and prog.front_replays == 6
    assert prog.replays == 4
    tt.clear_programs()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("wavelet,mode", [("bior2.2", "reflect"),
                                          ("coif4", "periodization"),
                                          ("dmey", "symmetric")])
def test_synthesis_kernel_equals_plain_version(cuda, wavelet, mode, dtype):
    """``spiht_idwt_level`` (dmey's 102 taps past 48 KB of shared memory)
    against the plain version on the CPU, bit for bit, at a stand-in of the
    nuScenes geometry (int32, a crop) and of the UHD one (int16, odd LL),
    one launch a level."""
    from spiht_tpu_torch import SpihtSettings
    from spiht_tpu_torch.ops import synthesis_kernels as sk
    from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w

    rng = np.random.default_rng(7)
    for lead, h, w, in_dtype in (((2, 3), 45, 80, torch.int32),
                                 ((3,), 38, 61, torch.int16)):
        s = SpihtSettings(wavelet=wavelet, mode=mode,
                          per_channel_quant_scales=[100, 20, 20])
        slices, enc_h, enc_w = get_slices_and_h_w(h, w, s, 2)
        rec = torch.as_tensor(rng.integers(-3000, 3000, lead + (enc_h, enc_w))
                              ).to(in_dtype)
        n0 = sk.waverec2_packed.launches
        got = sk.waverec2_packed(rec.to(cuda), slices, s, dtype)
        torch.cuda.synchronize()
        assert sk.waverec2_packed.launches == n0 + 2
        want = sk.waverec2_packed_plain(rec, slices, s, dtype)
        bits = torch.int64 if dtype == torch.float64 else torch.int32
        assert torch.equal(got.cpu().view(bits), want.view(bits))


def test_batch_decode_launches_the_synthesis_kernel_a_level(cuda):
    """``decode_images_device`` at an even LL (B5) and an odd LL (batched
    B3): the key's first call counts ``level`` launches for its warm-up
    and ``level`` for its capture, as every kernel wrapper counts them, a
    replay none; ``inverse`` alone ``level``; the images equal the CPU's."""
    import spiht_tpu_torch as pt
    from spiht_tpu_torch import torch_transform
    from spiht_tpu_torch.ops import synthesis_kernels as sk
    from spiht_tpu_torch.wavelets.geometry import get_slices_and_h_w

    rng = np.random.default_rng(8)
    ims = [rng.random((3, 64, 64)) for _ in range(3)]
    for s, level in ((pt.SpihtSettings(), 3),
                     (pt.SpihtSettings(wavelet="bior4.4",
                                       mode="symmetric"), 3)):
        ers = pt.encode_images_device(ims, s, level, 20000, device=cuda)
        n0 = sk.waverec2_packed.launches
        got = pt.decode_images_device(ers, s, device=cuda)
        assert sk.waverec2_packed.launches == n0 + 2 * level
        again = pt.decode_images_device(ers, s, device=cuda)
        assert sk.waverec2_packed.launches == n0 + 2 * level
        want = pt.decode_images_device(ers, s, device="cpu")
        for a, b, c in zip(got, again, want):
            assert torch.equal(a.cpu(), c) and torch.equal(b, a)
        _, enc_h, enc_w = get_slices_and_h_w(64, 64, s, level)
        rec = torch.zeros((len(ims), 3, enc_h, enc_w), dtype=torch.int32,
                          device=cuda)
        n0 = sk.waverec2_packed.launches
        torch_transform.inverse(rec, 64, 64, level, s)
        assert sk.waverec2_packed.launches == n0 + level


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_ipt_inverse_kernel_equals_torch_ops(cuda, dtype):
    """``spiht_ipt_inverse`` against ``torch_models.convert``'s torch ops
    on the card, bit for bit, on a batch, a crop, channels last and odd W,
    one launch a call; a batch decode at IPT launches it on a key's first
    call twice (warm-up and capture), on a replay not at all."""
    import spiht_tpu_torch as pt
    from spiht_tpu_torch.color import torch_models
    from spiht_tpu_torch.ops import synthesis_kernels as sk

    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.uniform(-1.0, 2.0, (2, 3, 40, 72)),
                        device=cuda).to(dtype)
    for im in (x, x[..., 3:37, 5:66], x.permute(0, 2, 3, 1).contiguous()
               .permute(0, 3, 1, 2), x[1, :, :, :61]):
        n0 = sk.rgb_from_ipt.launches
        got = sk.rgb_from_ipt(im)
        assert sk.rgb_from_ipt.launches == n0 + 1
        assert got.is_contiguous()
        assert torch.equal(got, torch_models.convert(im, "ipt", "RGB"))
    s = pt.SpihtSettings(color_model="ipt")
    ims = [rng.random((3, 64, 64)) for _ in range(3)]
    ers = pt.encode_images_device(ims, s, 3, 20000, device=cuda)
    n0 = sk.rgb_from_ipt.launches
    got = pt.decode_images_device(ers, s, device=cuda, dtype=dtype)
    assert sk.rgb_from_ipt.launches == n0 + 2
    again = pt.decode_images_device(ers, s, device=cuda, dtype=dtype)
    assert sk.rgb_from_ipt.launches == n0 + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
