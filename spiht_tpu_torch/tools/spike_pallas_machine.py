"""The sequential decoder's per-bit body at the machine's footprint, on the
card: the port of ``tools/spike_pallas_machine.py`` (its Pallas kernel,
``build``'s ``kernel`` :37, ``pallas_call`` :92; the body :41-82).

Each step reads the stream word at a data-dependent cursor, takes its bit,
reads a LIP entry at the running accumulator, read-modify-writes rec at
the node that entry and the word give, appends the node to the LSP, and
reads a LIS entry at the node: the accesses of one bit of B3. The state
is four int32 arrays (rec, lip, lsp, lis) of ``mb`` MB each (3.4 MB: the
headline geometry's budget) beside 1024 x 128 stream words (512 KB).
``machine`` launches the CUDA kernel (``csrc/spike_chains.cu``,
``spike_machine_ilp_kernel<1>``: one thread, direct indexing) for a CUDA
tensor and runs its plain version, a Python loop, for a CPU one.

The TPU kernel never initialises its scratch arrays and never writes lip
or lis; its interpreter fills them with INT32_MIN, and so does
``new_state`` here, before every launch (outside the timed events). The
output row is (1, 4) int32: pos, acc, cnt and INT32_MIN, the entry the
TPU kernel never writes.

Run on the card: ``python -m spiht_tpu_torch.tools.spike_pallas_machine
[K] [--mb N]`` (K = 100000 by default). It prints one JSON line: the
marginal ns a step from K/4 and K steps (CUDA events, median of 3), where
the state lies (``tools.cache_setup``: L2 below 32 MB, else HBM with L2
flushed), each output and the state after it equal to the plain
version's, and the card's name and power limit.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..device import resolve_device
from . import cache_setup, card, event_ms

__all__ = ["LANES", "ROWS_WORDS", "INT32_MIN", "CHAINS", "words_of",
           "state_size", "new_state", "machine", "machine_plain", "launch",
           "timed_state", "equals_plain", "k_mb", "run"]

LANES = 128
ROWS_WORDS = 1024  # the stream: 1024 x 128 int32, 512 KB
INT32_MIN = -(2**31)
CHAINS = (1, 2, 4, 8)  # the chain counts the kernel is built for


def words_of(rows: int = ROWS_WORDS) -> np.ndarray:
    """The spike's seeded (rows, 128) int32 stream words."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 2**31 - 1, (rows, LANES), dtype=np.int32)


def state_size(mb: float) -> int:
    """Words in one state array of ``mb`` MB, as the spike sizes it
    (whole rows of 128)."""
    return int(mb * 1024 * 1024 / 4 / LANES) * LANES


def new_state(chains: int, size: int, device=None) -> torch.Tensor:
    """The (chains, 4, size) int32 state (rec, lip, lsp, lis a chain),
    filled with INT32_MIN as the TPU spike's interpreter fills scratch."""
    return torch.full((chains, 4, size), INT32_MIN, dtype=torch.int32,
                      device=device)


def _i32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def machine_plain(flat: np.ndarray, k: int, state: np.ndarray) -> np.ndarray:
    """The plain version: K steps of the body in each chain of ``state``
    ((B, 4, size) int32, updated in place), chain b from (37b, 101b, 0), as
    a Python loop over Python ints (the spike's int32 arithmetic: floor
    ``%``, wrapping sums). Returns the (1, 3B + 1) int32 output row."""
    chains, _, size = state.shape
    nwords = flat.size
    words = flat.tolist()
    out = []
    for b in range(chains):
        rec, lip, lsp, lis = state[b]
        pos, acc, cnt = 37 * b, 101 * b, 0
        for _ in range(k):
            word = words[pos]
            bit = (word >> (pos & 31)) & 1
            node = (int(lip[acc % size]) ^ word) % size
            rec[node] = _i32(int(rec[node]) + bit + 1)
            lsp[cnt % size] = node
            lval = int(lis[_i32(node * 7) % size])
            acc = _i32(acc ^ _i32(word + pos + lval))
            pos = (pos + 1 + ((word >> (pos & 7)) & 7)) % nwords
            cnt += bit
        out += [pos, acc, cnt]
    return np.array([out + [INT32_MIN]], np.int32)


def _check(words: torch.Tensor, state: torch.Tensor):
    if words.dtype != torch.int32 or state.dtype != torch.int32:
        raise ValueError("words and state must be int32")
    if state.dim() != 3 or state.shape[1] != 4 or not state.is_contiguous():
        raise ValueError("state must be a contiguous (chains, 4, size) tensor")
    if words.device != state.device:
        raise ValueError("words and state must lie on one device")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {words.device}")
    if state.shape[0] not in CHAINS or state.shape[2] < 1:
        raise ValueError(f"chains must be one of {CHAINS}, size at least 1")
    flat = words.contiguous().reshape(-1)
    if flat.numel() <= 37 * (state.shape[0] - 1):
        raise ValueError("chain b starts at pos 37b: too few words")
    return flat


def launch(fn, words, k, state, warp):
    """``fn``'s launch of spike_machine: the kernel for CUDA tensors (one
    launch counted on ``fn``), the plain version for CPU ones. Returns
    the (1, 3B + 1) int32 output row; ``state`` is updated in place."""
    flat = _check(words, state)
    chains, _, size = state.shape
    if flat.device.type == "cpu":
        return torch.from_numpy(machine_plain(flat.numpy(), int(k),
                                              state.numpy()))
    from .. import _build

    lib = _build.load("spike_chains")
    out = torch.empty(1, 3 * chains + 1, dtype=torch.int32,
                      device=flat.device)
    rc = lib.spike_machine_launch(
        flat.data_ptr(), flat.numel(), state.data_ptr(), size, int(k),
        chains, int(warp), out.data_ptr(),
        torch.cuda.current_stream(flat.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"spike_machine launch failed: CUDA error {rc}")
    fn.launches += 1
    return out


def machine(words: torch.Tensor, k: int, state: torch.Tensor) -> torch.Tensor:
    """K steps of one chain over ``words`` (int32) and ``state`` ((1, 4,
    size) int32, INT32_MIN-filled by ``new_state``; updated in place): the
    CUDA kernel for CUDA tensors, the plain version for CPU ones. Returns
    the (1, 4) int32 row [pos, acc, cnt, INT32_MIN]."""
    if state.dim() == 3 and state.shape[0] != 1:
        raise ValueError("S4 runs one chain: state is (1, 4, size)")
    return launch(machine, words, k, state, False)


machine.launches = 0


def timed_state(state: torch.Tensor):
    """(where a timed launch finds ``state``, the callable that refills it
    with INT32_MIN before each launch and, past 32 MB, flushes L2)."""
    cache, flush = cache_setup(state)
    if flush is None:
        cache = "L2 (filled just before the launch)"

    def before():
        state.fill_(INT32_MIN)
        if flush is not None:
            flush()

    return cache, before


def equals_plain(fn, words, k, state, *args) -> bool:
    """Whether ``fn`` on the card gives the plain version's output row and
    state from a fresh INT32_MIN state."""
    state.fill_(INT32_MIN)
    out = fn(words, k, state, *args)
    cstate = new_state(state.shape[0], state.shape[2])
    pout = fn(words.cpu(), k, cstate, *args)
    return torch.equal(out.cpu(), pout) and torch.equal(state.cpu(), cstate)


def run(k: int = 100_000, mb: float = 3.4, device=None, check=True):
    """The marginal ns a step from K/4 and K steps on the card, the state
    refilled (and, past 32 MB, L2 flushed) before each timed launch; with
    ``check`` each output and the state after it are held to the plain
    version's. Returns the result dict."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the spike measures the card")
    ks = [k // 4, k]
    words = torch.as_tensor(words_of(), device=dev)
    size = state_size(mb)
    state = new_state(1, size, dev)
    cache, before = timed_state(state)
    ms = [event_ms(lambda: machine(words, kk, state), before=before)
          for kk in ks]
    ok = all(equals_plain(machine, words, kk, state) for kk in ks) \
        if check else None
    return {
        "spike": "spike_pallas_machine", "K": ks, "state_words": size,
        "state_mb": 4 * state.numel() / 2**20, "cache": cache,
        "ms": dict(zip(map(str, ks), ms)),
        "ns_per_step": (ms[1] - ms[0]) * 1e6 / (ks[1] - ks[0]),
        "equals_plain": ok,
    }


def k_mb(argv, mb: float):
    """(K, --mb) from the command line ``[K] [--mb N]``; K 100000 and
    ``mb`` by default."""
    argv = list(argv)
    if "--mb" in argv:
        i = argv.index("--mb")
        mb = float(argv[i + 1])
        del argv[i:i + 2]
    nums = [a for a in argv if not a.startswith("--")]
    return (int(nums[0]) if nums else 100_000), mb


def main(argv=None) -> int:
    out = run(*k_mb(sys.argv[1:] if argv is None else argv, 3.4))
    out["card"] = card()
    print(json.dumps(out))
    return 0 if out["equals_plain"] else 1


if __name__ == "__main__":
    sys.exit(main())
