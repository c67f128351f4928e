"""The port of the dependent-chain TPU spikes (``spiht_tpu_torch/tools/
spike_pallas_seq.py``, ``spike_hbm_table.py``, ``spike_pallas_machine.py``,
``spike_pallas_ilp.py``) against the JAX spikes in ``tools/`` on the CPU,
at small K: each plain version (a numpy or Python loop) equals the spike's
Pallas kernel run in interpret mode, loaded by path with nothing in
``tools/`` edited (``spike_pallas_seq.build_pallas(..., interpret=True)``,
``spike_pallas_machine.build(..., True)``, ``spike_pallas_ilp.build(...,
True)``; ``spike_hbm_table.build``'s kernels through a ``pallas_call``
given ``interpret=True``, under which their DMA copies and semaphores run
on the CPU). The interpreter fills the machine spikes' scratch, and the
output entry they never write, with INT32_MIN; the plain versions start
from the same. The chain functions of the CUDA source
(``csrc/spike_chains.cu``, and the token heads of ``csrc/spike_blocks.cu``),
built as host C++, equal the plain versions too: the kernels call them as
they are."""

import ctypes
import functools
import importlib.util
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiht_tpu_torch.tools import spike_hbm_table as thbm
from spiht_tpu_torch.tools import spike_pallas_ilp as tilp
from spiht_tpu_torch.tools import spike_pallas_machine as tmach
from spiht_tpu_torch.tools import spike_pallas_seq as tseq
from spiht_tpu_torch.tools import spike_token_matmul as ttok

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "spiht_tpu_torch" / "csrc"


def _load_tool(name):
    """``tools/<name>.py`` loaded by path. The spikes point jax's persistent
    compilation cache at a directory of their own when imported; the
    config is put back as it was."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def jseq():
    return _load_tool("spike_pallas_seq")


@pytest.fixture(scope="module")
def jhbm():
    return _load_tool("spike_hbm_table")


@pytest.mark.parametrize("rw", [False, True], ids=["r", "rw"])
@pytest.mark.parametrize("rows,k", [(8, 0), (8, 1), (8, 700), (256, 300)])
def test_seq_chain_equals_pallas_interpret(jseq, rw, rows, k):
    """(pos, acc) after K steps over 1024 words, and over 2^15 (the
    shared-memory variant's array, in both plain paths)."""
    words = tseq.words_of(rows)
    with jax.enable_x64(False):  # int32 throughout, as on the TPU
        fn = jseq.build_pallas(rows, rw, True)
        want = np.asarray(fn(jnp.asarray(words),
                             jnp.asarray([k], jnp.int32)))
    out, scratch = tseq.seq_chain(torch.as_tensor(words), k, rw)
    np.testing.assert_array_equal(out.numpy(), want)
    assert (scratch is not None) == rw
    if rows * tseq.LANES == tseq.SMEM_WORDS:
        out_s, _ = tseq.seq_chain(torch.as_tensor(words), k, rw, shared=True)
        np.testing.assert_array_equal(out_s.numpy(), want)


@pytest.mark.parametrize(
    "kind,chains",
    [("vmem", 1), ("hbm", 1), ("hbm_ilv", 8), ("hbm_ilv", 16),
     ("hbm_fire", 4), ("hbm_fire", 8), ("hbm_fire", 16)],
)
def test_table_chains_equal_pallas_interpret(jhbm, kind, chains):
    """The (1, 128) output row after K steps over a 2^14-word permutation
    (x + W inside the table for most x, clamped for the rest)."""
    k = 25
    perm = thbm.permutation(14)
    orig = jhbm.pl.pallas_call
    jhbm.pl.pallas_call = functools.partial(orig, interpret=True)
    try:  # the spike is int32 throughout, as on the TPU (no x64)
        with jax.enable_x64(False):
            fn = jax.jit(jhbm.build(kind, perm.size // thbm.LANES, k, chains))
            want = np.asarray(fn(jnp.zeros((1,), jnp.int32),
                                 jnp.asarray(perm.reshape(-1, thbm.LANES))))
    finally:
        jhbm.pl.pallas_call = orig
    table = torch.as_tensor(perm)
    if kind == "hbm_fire":
        out = thbm.table_fire(table, k, chains)
    else:
        out = thbm.table_chain(table, k, chains)
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.fixture(scope="module")
def jmach():
    return _load_tool("spike_pallas_machine")


@pytest.fixture(scope="module")
def jilp():
    return _load_tool("spike_pallas_ilp")


ROWS = 8  # the machine spikes' state and stream rows in the tests


@pytest.mark.parametrize("k", [0, 1, 5, 300])
def test_machine_equals_pallas_interpret(jmach, k):
    """S4 at 8 state rows and 8 stream rows: all four output entries, the
    last one (never written) INT32_MIN."""
    words = tmach.words_of(ROWS)
    with jax.enable_x64(False):  # int32 throughout, as on the TPU
        fn = jmach.build(ROWS, ROWS, True)
        want = np.asarray(fn(jnp.asarray(words), jnp.asarray([k], jnp.int32)))
    state = tmach.new_state(1, ROWS * tmach.LANES)
    out = tmach.machine(torch.as_tensor(words), k, state)
    np.testing.assert_array_equal(out.numpy(), want)
    assert want[0, 3] == tmach.INT32_MIN


@pytest.mark.parametrize("b", [1, 2, 8])
def test_ilp_chains_equal_pallas_interpret(jilp, b):
    """S3 at 8 state rows a chain, K = 300: all 3B + 1 entries (chain b
    from (37b, 101b, 0); chain 0 is S4's)."""
    k = 300
    words = tmach.words_of(ROWS)
    with jax.enable_x64(False):
        fn = jilp.build(b, ROWS, ROWS, True)
        want = np.asarray(fn(jnp.asarray(words), jnp.asarray([k], jnp.int32)))
    state = tmach.new_state(b, ROWS * tmach.LANES)
    out = tilp.chains(torch.as_tensor(words), k, state)
    np.testing.assert_array_equal(out.numpy(), want)
    assert want[0, -1] == tmach.INT32_MIN
    if b > 1:
        np.testing.assert_array_equal(out.numpy()[0, :3], [289, 1231445959,
                                                           161])


HARNESS = r"""
#include "spike_chains.cu"
#include "spike_blocks.cu"
extern "C" void host_seq(const int32_t* w, int32_t size, int32_t k,
                         int32_t rw, int32_t* scratch, int32_t* out) {
  if (rw) seq_chain<true>(w, size, k, scratch, out);
  else seq_chain<false>(w, size, k, scratch, out);
}
// the shared-memory variant's 16-bit scratch
extern "C" void host_seq16(const int32_t* w, int32_t k, uint16_t* scratch,
                           int32_t* out) {
  seq_chain<true>(w, SPIKE_SMEM_WORDS, k, scratch, out);
}
extern "C" void host_table(const int32_t* t, int32_t k, int32_t chains,
                           int32_t* out) {
  if (chains == 1) table_chain<1>(t, k, out);
  else if (chains == 8) table_chain<8>(t, k, out);
  else table_chain<16>(t, k, out);
}
// spike_machine's B chains over the (B, 4, size) state, as the ilp kernel
extern "C" void host_machine(const int32_t* w, int32_t nwords, int32_t* state,
                             int32_t size, int32_t k, int32_t chains,
                             int32_t* out) {
  MachineArrays arr[8];
  int32_t st[24];
  for (int b = 0; b < chains; ++b) {
    arr[b] = machine_arrays(state, size, b);
    machine_start(b, st + 3 * b);
  }
  if (chains == 1) machine_chain<1>(w, nwords, size, k, arr, st);
  else if (chains == 2) machine_chain<2>(w, nwords, size, k, arr, st);
  else if (chains == 4) machine_chain<4>(w, nwords, size, k, arr, st);
  else machine_chain<8>(w, nwords, size, k, arr, st);
  for (int i = 0; i < 3 * chains; ++i) out[i] = st[i];
  out[3 * chains] = INT32_MIN;
}
// spike_token's heads of K windows, the scan kind (token_scan_acc)
extern "C" int32_t host_token_scan(const int32_t* x, int32_t k) {
  uint32_t xb[TOKEN_ROWS][4];
  token_bits(x, xb);
  return token_scan_acc(xb, k);
}
extern "C" void host_fire(const int32_t* t, int32_t n, int32_t k,
                          int32_t chains, int32_t w_off, int32_t* out) {
  if (chains == 4) fire_chain<4>(t, n, k, w_off, out);
  else if (chains == 8) fire_chain<8>(t, n, k, w_off, out);
  else fire_chain<16>(t, n, k, w_off, out);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source as host C++")
    d = tmp_path_factory.mktemp("spike_chains")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libspike_chains.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         "-I", str(CSRC), "-o", str(so), str(d / "harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(so))


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


def _i(v):
    return ctypes.c_int32(int(v))


@pytest.mark.parametrize("rw", [False, True], ids=["r", "rw"])
def test_seq_chain_source_equals_plain_version(host_lib, rw):
    """``seq_chain`` at 2^13 and 2^15 words (16-bit scratch there, as in
    shared memory): (pos, acc) and the scratch equal the numpy loop's."""
    k = 3000
    for rows in (64, 256):
        words = tseq.words_of(rows)
        out = np.zeros(2, np.int32)
        scratch = np.zeros(words.size, np.int32)
        host_lib.host_seq(_p(words), _i(words.size), _i(k), _i(rw),
                          _p(scratch), _p(out))
        pout, pscratch = tseq.seq_chain(torch.as_tensor(words), k, rw)
        np.testing.assert_array_equal(out, pout.numpy()[0])
        if rw:
            np.testing.assert_array_equal(scratch, pscratch.numpy())
        if rw and words.size == tseq.SMEM_WORDS:
            s16 = np.zeros(words.size, np.uint16)
            host_lib.host_seq16(_p(words), _i(k), _p(s16), _p(out))
            np.testing.assert_array_equal(out, pout.numpy()[0])
            np.testing.assert_array_equal(s16, pscratch.numpy())


@pytest.mark.parametrize("chains,fire", [(1, False), (8, False), (16, False),
                                         (4, True), (8, True), (16, True)])
def test_table_chain_sources_equal_plain_versions(host_lib, chains, fire):
    """``table_chain`` and ``fire_chain`` over a 2^14-word permutation."""
    k = 500
    perm = thbm.permutation(14)
    out = np.zeros(thbm.LANES, np.int32)
    if fire:
        host_lib.host_fire(_p(perm), _i(perm.size), _i(k), _i(chains),
                           _i(thbm.W_OFF), _p(out))
        want = thbm.table_fire(torch.as_tensor(perm), k, chains)
    else:
        host_lib.host_table(_p(perm), _i(k), _i(chains), _p(out))
        want = thbm.table_chain(torch.as_tensor(perm), k, chains)
    np.testing.assert_array_equal(out, want.numpy()[0])


@pytest.mark.parametrize("chains", [1, 2, 4, 8])
def test_machine_chain_source_equals_plain_version(host_lib, chains):
    """``machine_chain<B>`` at K = 3000 over a state of 2^13 words (a power
    of two) and of 891 x 128 (S4's 3.4 MB rows, cut; not one): the output
    row and the whole state equal the plain version's."""
    k = 3000
    words = tmach.words_of(64)
    for size in (1 << 13, 891 * tmach.LANES):
        state = tmach.new_state(chains, size)
        want = tilp.chains(torch.as_tensor(words), k, state)
        hstate = tmach.new_state(chains, size).numpy()
        out = np.zeros(3 * chains + 1, np.int32)
        host_lib.host_machine(_p(words), _i(words.size), _p(hstate),
                              _i(size), _i(k), _i(chains), _p(out))
        np.testing.assert_array_equal(out, want.numpy()[0])
        np.testing.assert_array_equal(hstate, state.numpy())


def test_token_scan_source_equals_plain_version(host_lib):
    """The carry-arithmetic heads (``token_scan_acc``) at K = 3000 on the
    spike's windows and on windows of long runs of ones (the carry across
    bit 63 in both parities)."""
    k = 3000
    rng = np.random.default_rng(11)
    runs = np.where(rng.random((ttok.ROWS, ttok.LANES)) < 0.9, 1, 0)
    for x in (ttok.x_of(), runs.astype(np.int32)):
        want = ttok.token_heads(torch.as_tensor(x), k, "scan")
        got = host_lib.host_token_scan(_p(x), _i(k))
        assert got == int(want[0, 0])


def test_wrappers_refuse_what_the_kernels_do_not_take():
    words = torch.as_tensor(tseq.words_of(8))
    with pytest.raises(ValueError, match="2\\^m"):
        tseq.seq_chain(words[:, :100], 10)
    with pytest.raises(ValueError, match="shared-memory"):
        tseq.seq_chain(words, 10, shared=True)
    perm = torch.as_tensor(thbm.permutation(10))
    with pytest.raises(ValueError, match="chains"):
        thbm.table_chain(perm, 10, chains=4)
    with pytest.raises(ValueError, match="chains"):
        thbm.table_fire(perm, 10, chains=1)
    with pytest.raises(ValueError, match="shared-memory"):
        thbm.table_chain(perm, 10, shared=True)
    w = torch.as_tensor(tmach.words_of(8))
    with pytest.raises(ValueError, match="one chain"):
        tmach.machine(w, 10, tmach.new_state(2, 1024))
    with pytest.raises(ValueError, match="chains"):
        tilp.chains(w, 10, tmach.new_state(3, 1024))
    with pytest.raises(ValueError, match="int32"):
        tilp.chains(w, 10, tmach.new_state(2, 1024).long())
    with pytest.raises(ValueError, match="contiguous"):
        tilp.chains(w, 10, tmach.new_state(2, 1024)[:, :, ::2])
    with pytest.raises(ValueError, match="too few words"):
        tilp.chains(w[:1, :64], 10, tmach.new_state(4, 1024))
    with pytest.raises(ValueError, match="layout"):
        tilp.chains(w, 10, tmach.new_state(2, 1024), "lanes")
