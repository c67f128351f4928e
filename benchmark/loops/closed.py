"""A closed loop: ``clients`` clients, each sending its next request as
soon as its last one has come back. One client is implemented; a mix
that asks for more is refused."""

from __future__ import annotations

import time


def drive(one_round, mix: dict, seconds: float) -> int:
    clients = int(mix.get("clients", 1))
    if clients != 1:
        raise ValueError(f"the closed loop runs one client, not {clients}")
    tw = time.perf_counter()
    r = 0
    while r == 0 or time.perf_counter() - tw < seconds:
        one_round(r)
        r += 1
    return r
