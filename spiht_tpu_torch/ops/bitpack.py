"""Bit <-> byte packing, LSB-first within each byte.

Matches the reference wire format (src/lib.rs:15-31): bit i of the stream is
bit (i % 8) of byte (i // 8), and the final partial byte is zero padded.
The decoder deliberately consumes those pad zeros as insignificance bits.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bits_to_bytes", "bytes_to_bits"]


def bits_to_bytes(bits) -> bytes:
    """Pack a sequence of bools into bytes, LSB-first, zero padded."""
    arr = np.asarray(bits, dtype=np.uint8)
    return np.packbits(arr, bitorder="little").tobytes()


def bytes_to_bits(data: bytes) -> np.ndarray:
    """Expand bytes into a uint8 {0,1} array, LSB-first (all 8 bits/byte)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    return np.unpackbits(buf, bitorder="little")
