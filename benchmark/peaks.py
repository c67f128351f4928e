"""Published peaks of the card (NVIDIA H100 SXM5 data sheet, at the full
700 W power limit)."""

H100_SXM = {"hbm_bytes_per_s": 3.35e12}
