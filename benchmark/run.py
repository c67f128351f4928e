"""Run one cell of ``BENCHMARK.json`` on the CUDA card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up is timed from this module's first
line. The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (API calls of the window), ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s``),
``breakdown`` (``--trace 1``) and, last, ``checks``: each number the
comparison with the reference compared, with its limit. The same numbers
are the last lines of standard error.

Exits 2 without enough CUDA cards, and 3 if the process holds a module
of JAX or of the JAX package ``spiht_tpu`` once the run is done (top-level
names compared whole), printing no result in either case.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "spiht_tpu")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _json_safe(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    from . import cell, spec

    c = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c["chips"]:
        print(f"{args.workload} needs {c['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    import spiht_tpu_torch  # noqa: F401  (fails here in a bare checkout)

    result = cell.run(c, args.seed, args.seconds, bool(args.trace), "cuda",
                      t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(_json_safe(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
