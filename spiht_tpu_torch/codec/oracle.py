"""Trusted pure-Python SPIHT codec (the in-repo bitstream oracle).

This is a direct, slow expression of the SPIHT zerotree bit-plane coding
contract documented in SURVEY.md §3 (reference semantics at
src/encoder_decoder.rs:155-454,631-841). It exists so that every fast path
(the JAX significance-map pipeline and the C++ scheduling kernel) can be
checked bit-for-bit against an independent implementation.

Everything here operates on plain Python ints over a numpy i32 array; no JAX.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "encode_bits",
    "decode_bits",
    "decode_bits_with_metadata",
    "compute_max_n",
    "coverage_mask",
    "Filter",
]


class Filter:
    """Subband/filter taxonomy ids (reference: encoder_decoder.rs:457-462)."""

    LL = 0
    DA = 1
    AD = 2
    DD = 3


def compute_max_n(arr: np.ndarray) -> int:
    """Initial bit-plane index: f32-truncated log2 of the abs max.

    Mirrors the reference's ``(max as f32).log2() as u8``
    (encoder_decoder.rs:165-167): the log2 is computed in float32 and cast
    with truncation; max == 0 saturates to 0.
    """
    m = int(np.abs(arr.astype(np.int64)).max()) if arr.size else 0
    if m <= 0:
        return 0
    v = float(np.log2(np.float32(m)))
    if v < 0:
        return 0
    return min(int(v), 255)


def _offspring(
    i: int, j: int, h: int, w: int, ll_h: int, ll_w: int
) -> Optional[Tuple[Tuple[int, int], ...]]:
    """Spatial-orientation-tree children (SURVEY.md §3.4).

    LL roots at (even, even) have no offspring; the other three of each LL
    2x2 group parent the level-1 subband block selected by their parity.
    Everywhere else children are the 2x2 block at (2i, 2j), all-or-nothing
    on the bounds check.
    """
    if i < ll_h and j < ll_w:
        if i % 2 == 0 and j % 2 == 0:
            return None
        bi = (i // 2) * 2
        bj = (j // 2) * 2
        oi = (i % 2) * ll_h + bi
        oj = (j % 2) * ll_w + bj
        return ((oi, oj), (oi, oj + 1), (oi + 1, oj), (oi + 1, oj + 1))
    if 2 * i + 1 >= h or 2 * j + 1 >= w:
        return None
    return ((2 * i, 2 * j), (2 * i, 2 * j + 1), (2 * i + 1, 2 * j), (2 * i + 1, 2 * j + 1))


def _has_grandchildren(i: int, j: int, h: int, w: int) -> bool:
    return (i * 2 + 1) * 2 + 1 < h and (j * 2 + 1) * 2 + 1 < w


def coverage_mask(h: int, w: int, ll_h: int, ll_w: int) -> np.ndarray:
    """Boolean (h, w) map of cells the codec can ever CODE.

    This models the LIS visit dynamics, not mere offspring reachability:
    a type-A entry codes its 4 offspring, but those offspring only become
    type-A entries themselves (allowing their own subtrees to be coded) if
    the parent re-enters as type B — gated by the raw-coordinate
    grandchild test `(2i+1)*2+1 < h` (reference encoder_decoder.rs:7-12),
    which for boundary-padded geometries can cut off grand-subtrees that
    the offspring relation alone would reach. Cells outside this mask are
    silently lost — a known artifact the reference shares (reference:
    spiht/tests/test_rust.py:52-55). Full-stream round-trip is exact
    exactly on this mask.
    """
    mask = np.zeros((h, w), dtype=bool)
    mask[:ll_h, :ll_w] = True
    # stack of type-A set entries (cells whose offspring get coded)
    stack = []
    for i in range(ll_h):
        for j in range(ll_w):
            if not (i % 2 == 0 and j % 2 == 0):
                stack.append((i, j))
    while stack:
        i, j = stack.pop()
        off = _offspring(i, j, h, w, ll_h, ll_w)
        if not off:
            continue
        for l, m in off:
            mask[l, m] = True
        if _has_grandchildren(i, j, h, w):
            stack.extend(off)
    return mask


def _is_sig(x: int, n: int) -> bool:
    return abs(x) >= (1 << n)


def _set_bit(x: int, n: int, bit: bool) -> int:
    """Set/clear magnitude bit n while preserving sign (SURVEY.md §3.7)."""
    nonneg = x >= 0
    mag = x if nonneg else -x
    mag = (mag | (1 << n)) if bit else (mag & ~(1 << n))
    return mag if nonneg else -mag


def _is_bit_set(x: int, n: int) -> bool:
    return (abs(x) & (1 << n)) != 0


def _set_sig(arr, k, i, j, n, h, w, ll_h, ll_w) -> bool:
    """Element-or-any-descendant significance (iterative DFS)."""
    stack = [(i, j)]
    t = 1 << n
    while stack:
        ii, jj = stack.pop()
        if abs(int(arr[k, ii, jj])) >= t:
            return True
        off = _offspring(ii, jj, h, w, ll_h, ll_w)
        if off:
            stack.extend(off)
    return False


def _l_sig(arr, k, i, j, n, h, w, ll_h, ll_w) -> bool:
    """Any grandchild-subtree significance (excludes self and offspring)."""
    off = _offspring(i, j, h, w, ll_h, ll_w)
    if not off:
        return False
    for l, m in off:
        off2 = _offspring(l, m, h, w, ll_h, ll_w)
        if not off2:
            continue
        for ll, mm in off2:
            if _set_sig(arr, k, ll, mm, n, h, w, ll_h, ll_w):
                return True
    return False


def _init_lists(c: int, ll_h: int, ll_w: int):
    """LIP/LIS initial ordering: i, j loops with channel innermost
    (SURVEY.md §3.5 / porting hazard #3)."""
    lip = deque()
    lis = deque()
    for i in range(ll_h):
        for j in range(ll_w):
            for k in range(c):
                lip.append((k, i, j))
    for i in range(ll_h):
        for j in range(ll_w):
            if i % 2 == 0 and j % 2 == 0:
                continue
            for k in range(c):
                lis.append((True, k, i, j))
    return lip, lis


def encode_bits(
    arr: np.ndarray,
    ll_h: int,
    ll_w: int,
    max_bits: int,
    plane_counts: Optional[dict] = None,
    events: Optional[list] = None,
) -> Tuple[List[bool], int]:
    """SPIHT-encode an i32 coefficient array into a list of bits.

    Returns (bits, max_n). The encoder stops mid-symbol exactly when the bit
    count reaches ``max_bits`` (SURVEY.md §3.6 bit budget). If a dict is
    passed as ``plane_counts`` it is filled with {plane n: bits emitted};
    if a list is passed as ``events`` it receives one
    (action, k, i, j, n) tuple per emitted bit (action ids follow the
    metadata taxonomy: 0 lip-test, 1 lip-sign, 2 A-test, 3 offspring-test,
    4 offspring-sign, 5 B-test, 6 refinement) — ground truth for the
    device-side stream planner and order prototype.
    """
    arr = np.ascontiguousarray(arr, dtype=np.int64)
    c, h, w = arr.shape
    assert ll_h > 1 and ll_w > 1

    bits: List[bool] = []
    max_n = compute_max_n(arr)
    n = max_n

    lip, lis = _init_lists(c, ll_h, ll_w)
    lsp: deque = deque()

    _ev = [None]

    def note(action, k, i, j):
        if events is not None:
            _ev[0] = (action, k, i, j)

    def push(b: bool) -> bool:
        bits.append(bool(b))
        if plane_counts is not None:
            plane_counts[n] = plane_counts.get(n, 0) + 1
        if events is not None:
            a, k, i, j = _ev[0]
            events.append((a, k, i, j, n))
        return len(bits) == max_bits

    while True:
        lsp_len = len(lsp)

        # --- sorting pass over LIP ---
        lip_retain: deque = deque()
        for k, i, j in lip:
            x = int(arr[k, i, j])
            sig = _is_sig(x, n)
            note(0, k, i, j)
            if push(sig):
                return bits, max_n
            if sig:
                lsp.append((k, i, j))
                note(1, k, i, j)
                if push(x >= 0):
                    return bits, max_n
            else:
                lip_retain.append((k, i, j))
        lip = lip_retain

        # --- sorting pass over LIS (worklist: same-pass processing) ---
        lis_retain: deque = deque()
        while lis:
            t, k, i, j = lis.popleft()
            if t:  # type A
                off = _offspring(i, j, h, w, ll_h, ll_w)
                desc_sig = False
                if off:
                    for l, m in off:
                        if _set_sig(arr, k, l, m, n, h, w, ll_h, ll_w):
                            desc_sig = True
                            break
                note(2, k, i, j)
                if push(desc_sig):
                    return bits, max_n
                if desc_sig:
                    for l, m in off:
                        x = int(arr[k, l, m])
                        sig = _is_sig(x, n)
                        note(3, k, l, m)
                        if push(sig):
                            return bits, max_n
                        if sig:
                            lsp.append((k, l, m))
                            note(4, k, l, m)
                            if push(x >= 0):
                                return bits, max_n
                        else:
                            lip.append((k, l, m))
                    if _has_grandchildren(i, j, h, w):
                        lis.append((False, k, i, j))
                else:
                    lis_retain.append((t, k, i, j))
            else:  # type B
                lsig = _l_sig(arr, k, i, j, n, h, w, ll_h, ll_w)
                note(5, k, i, j)
                if push(lsig):
                    return bits, max_n
                if lsig:
                    for l, m in _offspring(i, j, h, w, ll_h, ll_w):
                        lis.append((True, k, l, m))
                else:
                    lis_retain.append((t, k, i, j))
        lis = lis_retain

        # --- refinement pass (entries significant before this plane) ---
        for idx in range(lsp_len):
            k, i, j = lsp[idx]
            note(6, k, i, j)
            if push(_is_bit_set(int(arr[k, i, j]), n)):
                return bits, max_n

        if n == 0:
            break
        n -= 1

    return bits, max_n


def decode_bits(
    bits, n: int, c: int, h: int, w: int, ll_h: int, ll_w: int
) -> np.ndarray:
    """Mirror of encode_bits; tolerates truncation (embedded stream)."""
    rec, _ = _decode_impl(bits, n, c, h, w, ll_h, ll_w, None)
    return rec


def decode_bits_with_metadata(
    bits, n: int, c: int, h: int, w: int, ll_h: int, ll_w: int, slices
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode and also emit the per-bit decoder-state trace.

    ``slices`` is (top_slice, other_slices) in the reference wire format
    (spiht/spiht_wrapper.py:232-248): top = [(0, ll_h), (0, ll_w)]; other =
    per level (coarse->fine) a list of [da, ad, dd] each
    [(row_start, row_stop), (col_start, col_stop)].
    Trace row layout (8 cols): [action, local_h, local_w, channel, filter,
    depth, n, current value] (SURVEY.md §3.9).
    """
    rec, meta = _decode_impl(bits, n, c, h, w, ll_h, ll_w, slices)
    return rec, meta


def _offspring_filter(filt: int, i: int, j: int) -> int:
    """Filter id of a node's children (reference: encoder_decoder.rs:137-150)."""
    if filt == Filter.LL:
        if i % 2 == 1 and j % 2 == 1:
            return Filter.DD
        if i % 2 == 0 and j % 2 != 0:
            return Filter.AD
        return Filter.DA
    return filt


def _local_position(i, j, filt, depth, slices, level):
    """Normalize coords to [-100000, 100000] within the subband rectangle
    (reference: encoder_decoder.rs:593-613; f32 arithmetic replicated)."""
    top_slice, other_slices = slices
    if depth == level:
        lh = np.float32(i) / np.float32(top_slice[0][1])
        lw = np.float32(j) / np.float32(top_slice[1][1])
    else:
        depth_i = level - 1 - depth
        rect = other_slices[depth_i][filt - 1]
        lh = (np.float32(i) - np.float32(rect[0][0])) / np.float32(
            rect[0][1] - rect[0][0]
        )
        lw = (np.float32(j) - np.float32(rect[1][0])) / np.float32(
            rect[1][1] - rect[1][0]
        )
    return (
        int(np.float32(lh) * np.float32(200000.0) - np.float32(100000.0)),
        int(np.float32(lw) * np.float32(200000.0) - np.float32(100000.0)),
    )


def _decode_impl(bits, n, c, h, w, ll_h, ll_w, slices):
    assert ll_h > 1 and ll_w > 1
    rec = np.zeros((c, h, w), dtype=np.int64)
    nbits = len(bits)

    with_meta = slices is not None
    if with_meta:
        meta = np.zeros((nbits + 1, 8), dtype=np.int32)
        level = len(slices[1])
    else:
        meta = None
        level = 0

    cur = 0

    class _Out(Exception):
        pass

    def pop() -> bool:
        nonlocal cur
        if cur >= nbits:
            raise _Out
        v = bool(bits[cur])
        cur += 1
        return v

    def note(action, k, i, j, filt, depth):
        # one metadata row per about-to-be-consumed bit
        if not with_meta:
            return
        if cur >= meta.shape[0]:
            raise _Out
        lh, lw = _local_position(i, j, filt, depth, slices, level)
        meta[cur] = (action, lh, lw, k, filt, depth, n, int(rec[k, i, j]))

    # entries: (k, i, j, filter, depth)
    lip: deque = deque()
    lis: deque = deque()
    for i in range(ll_h):
        for j in range(ll_w):
            for k in range(c):
                lip.append((k, i, j, Filter.LL, level))
    for i in range(ll_h):
        for j in range(ll_w):
            if i % 2 == 0 and j % 2 == 0:
                continue
            for k in range(c):
                lis.append((True, k, i, j, Filter.LL, level))
    lsp: deque = deque()

    def base_val(sign_bit: bool) -> int:
        sign = 1 if sign_bit else -1
        if n == 0:
            return sign
        return sign * ((1 << (n - 1)) + (1 << n))

    try:
        while True:
            lsp_len = len(lsp)

            lip_retain: deque = deque()
            for e in lip:
                k, i, j, filt, depth = e
                note(0, k, i, j, filt, depth)
                if pop():
                    note(1, k, i, j, filt, depth)
                    rec[k, i, j] = base_val(pop())
                    lsp.append(e)
                else:
                    lip_retain.append(e)
            lip = lip_retain

            lis_retain: deque = deque()
            while lis:
                t, k, i, j, filt, depth = lis.popleft()
                if t:
                    note(2, k, i, j, filt, depth)
                    if pop():
                        off = _offspring(i, j, h, w, ll_h, ll_w)
                        cfilt = _offspring_filter(filt, i, j)
                        if off:
                            for l, m in off:
                                note(3, k, l, m, cfilt, max(depth - 1, 0))
                                if pop():
                                    note(4, k, l, m, cfilt, max(depth - 1, 0))
                                    rec[k, l, m] = base_val(pop())
                                    lsp.append((k, l, m, cfilt, max(depth - 1, 0)))
                                else:
                                    lip.append((k, l, m, cfilt, max(depth - 1, 0)))
                        if _has_grandchildren(i, j, h, w):
                            lis.append((False, k, i, j, filt, depth))
                    else:
                        lis_retain.append((t, k, i, j, filt, depth))
                else:
                    note(5, k, i, j, filt, depth)
                    if pop():
                        off = _offspring(i, j, h, w, ll_h, ll_w)
                        cfilt = _offspring_filter(filt, i, j)
                        if off:
                            for l, m in off:
                                lis.append((True, k, l, m, cfilt, max(depth - 1, 0)))
                    else:
                        lis_retain.append((t, k, i, j, filt, depth))
            lis = lis_retain

            for idx in range(lsp_len):
                k, i, j, filt, depth = lsp[idx]
                note(6, k, i, j, filt, depth)
                rec[k, i, j] = _set_bit(int(rec[k, i, j]), n, pop())

            if n == 0:
                break
            n -= 1
    except _Out:
        pass

    rec32 = rec.astype(np.int32)
    if with_meta:
        return rec32, meta
    return rec32, None
