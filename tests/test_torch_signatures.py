"""The kernels' C entry points against their ctypes argtypes, and the
per-call scalars of B1, B7, B2 and B3 in both forms.

``_build.SIGNATURES`` is what ctypes passes: a pointer declared as
``c_int`` is cut to 32 bits on the card, and a scalar declared as a
pointer is read from a wild address. So every ``extern "C" int *_launch(``
parameter list in ``csrc/*.cu`` is held against its argtypes, type by
type, and every entry point has both.

The wrappers of B1 and B7 take max_n, max_bits and capped, those of B2
and B3 (and their log variants) nbits and max_n, as ints or as 0-d int32
tensors. B1, B2 and B3 read them from device memory (a CUDA graph replays
them with new values); B7 reads max_n there and takes the budget and its
flag by value. Their plain versions give the same output for either
form."""

import ctypes
import re

import pytest
import torch

from spiht_tpu_torch import _build
from spiht_tpu_torch.codec import decoder, encoder

from test_golden import _image

C_TYPES = {
    "int32_t": ctypes.c_int32,
    "int64_t": ctypes.c_int64,
    "float": ctypes.c_float,
}
LAUNCH = re.compile(r'extern "C" int (\w+_launch)\(([^)]*)\)\s*\{')


def _declared(name: str) -> dict:
    """Each entry point of ``csrc/<name>.cu``: its parameters' ctypes."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    out = {}
    for fn, params in LAUNCH.findall(src):
        types = []
        for p in params.split(","):
            decl = " ".join(p.split())
            if "*" in decl:
                types.append(ctypes.c_void_p)
            else:
                types.append(C_TYPES[decl.rsplit(" ", 1)[0].replace(
                    "const ", "")])
        out[fn] = types
    return out


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signatures_match_the_sources(name):
    declared = _declared(name)
    assert sorted(declared) == sorted(_build.SIGNATURES[name])
    for fn, argtypes in _build.SIGNATURES[name].items():
        assert len(argtypes) == len(declared[fn]), fn
        for i, (got, want) in enumerate(zip(argtypes, declared[fn])):
            assert got is want, f"{fn} argument {i}: {got} != {want}"


def test_every_source_has_signatures():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(
        _build.SIGNATURES)


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


def _coeffs(shape, level):
    from spiht_tpu_torch import SpihtSettings
    from spiht_tpu_torch.torch_transform import forward

    return forward(torch.as_tensor(_image(41, shape)), SpihtSettings(),
                   level)


@pytest.mark.parametrize("seq", [False, True], ids=["b1", "b7"])
@pytest.mark.parametrize("max_bits", [1, 777, 2**31 - 2])
def test_encode_scalars_int_or_tensor(seq, max_bits):
    arr, ll_h, ll_w = _coeffs((3, 36, 36), 2)
    args = encoder.machine_args(arr, ll_h, ll_w, max_bits)
    run = encoder.encode_machine_seq if seq else encoder.encode_machine
    want = run(*args[:6], int(args[6]), int(args[7]), bool(args[8]),
               *args[9:])
    got = run(*args[:6], args[6], _i32(args[7]), _i32(int(args[8])),
              *args[9:])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # the budget pair as tensors through machine_args, at a larger buffer
    cap = 2 * args[10]
    mb, capped = encoder._budget(max_bits, cap)
    pair = encoder.machine_args(arr, ll_h, ll_w, (_i32(mb), _i32(capped)),
                                cap)
    words, stat = run(*pair)
    assert stat.tolist() == want[1].tolist()
    total = stat[0].item()
    assert (encoder.stream_bytes(words, total)
            == encoder.stream_bytes(want[0], total))


@pytest.mark.parametrize("log", [False, True], ids=["rec", "log"])
@pytest.mark.parametrize("shape,level,seq", [((3, 36, 36), 2, False),
                                             ((3, 32, 40), 2, True)],
                         ids=["b2", "b3"])
def test_decode_scalars_int_or_tensor(shape, level, seq, log):
    arr, ll_h, ll_w = _coeffs(shape, level)
    c, h, w = arr.shape
    assert decoder.has_duplicate_parents(h, w, ll_h, ll_w) == seq
    data, max_n = encoder.encode(arr, ll_h, ll_w, 3000, device="cpu")
    for cut in (len(data), len(data) // 3):
        words, nbits = decoder.words_tensor(data[:cut], "cpu")
        args = decoder.machine_args(words, nbits, max_n, c, h, w, ll_h, ll_w)
        run = {(False, False): decoder.decode_lsp,
               (False, True): decoder.decode_lsp_log,
               (True, False): decoder.decode_seq,
               (True, True): decoder.decode_seq_log}[seq, log]
        want = run(*args)
        got = run(args[0], _i32(nbits), _i32(max_n), *args[3:])
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_device_scalar_refuses_what_the_kernels_do_not_take():
    dev = torch.device("cpu")
    assert encoder.device_scalar("x", 5, dev).tolist() == 5
    t = _i32(7)
    assert encoder.device_scalar("x", t, dev) is t
    with pytest.raises(ValueError, match="one element"):
        encoder.device_scalar("x", _i32([1, 2]), dev)
    with pytest.raises(ValueError, match="int32"):
        encoder.device_scalar("x", torch.tensor(5, dtype=torch.int64), dev)
    # an int budget is checked against the buffer; a tensor one is the
    # caller's to hold there (reading it would sync)
    arr, ll_h, ll_w = _coeffs((3, 32, 40), 2)
    args = list(encoder.machine_args(arr, ll_h, ll_w, 100))
    args[7] = args[10] * 32 + 1
    with pytest.raises(ValueError, match="max_bits"):
        encoder.encode_machine(*args)
