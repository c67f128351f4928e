"""A cell at a tiny size, for runs on the CPU, where the port runs its
plain versions (``device="cpu"``)."""

from benchmark import spec

# per configuration: a small shape at level 2 with the same LL parity as
# the configuration's own (kodak-ipt: LL 14x18, even; uhd-ipt: 15x19, odd)
SHAPES = {"kodak-ipt": [3, 44, 60], "uhd-ipt": [3, 48, 64]}


def tiny(name: str, **traffic) -> dict:
    c = spec.cell(name)
    mix = dict(c["traffic"], pool=2, check_sample=3, trace_rounds=2)
    if mix["entry"] == "batch":
        mix["batch"] = 3
    mix.update(traffic)
    c["config"] = dict(c["config"], shape=SHAPES[c["config"]["name"]],
                       level=2)
    c["traffic"] = mix
    return c
