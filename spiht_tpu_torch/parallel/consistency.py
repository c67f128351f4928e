"""Shard-consistency and numerical sanitizer utilities (SURVEY §6), the
port of ``spiht_tpu/parallel/consistency.py``.

Two failure classes remain worth asserting in debug runs:

 * replication drift — a value that is SUPPOSED to be identical on every
   device (the per-device copies of a replicated value, psum-reduced
   statistics) diverging because of a wrong collective or a
   non-deterministic reduction order;
 * silent NaN or division by zero inside a pipeline.

`replication_discrepancy` measures the first (the copies are gathered and
compared with the first; exactly 0 for a truly replicated value).
`checked_call` runs any function under the checks of
``jax.experimental.checkify.float_checks`` and raises on the host. Both
are opt-in debug tools: the production paths stay assert-free (the
codec's cheap NaN guard lives in `codec.api._validate_image` under
SPIHT_TPU_VALIDATE=1).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .mesh import Mesh
from .spatial import all_gather

__all__ = [
    "replication_discrepancy",
    "assert_replicated",
    "checked_call",
]


def replication_discrepancy(
    x: Union[torch.Tensor, Sequence[torch.Tensor]], mesh: Mesh,
    axis_name: str,
) -> torch.Tensor:
    """Max |per-device value - device 0's value| for a replicated value.

    ``x`` is the value's per-device copies, one a shard of
    ``mesh[axis_name]``, or a plain tensor, which is first copied to every
    shard (the JAX version's replicated in-spec). On a mesh over ranks a
    plain tensor is this rank's copy, and a list holds this rank's copy at
    its index on the axis. The copies are gathered and compared with the
    first. Returns a float32 scalar on the axis's first device (over
    ranks, on every rank's; 0.0 iff bit-identically replicated, for floats
    without NaNs).
    """
    devs = mesh.axis_devices(axis_name)
    line = mesh.line(axis_name)
    if isinstance(x, torch.Tensor):
        copies = [x.to(d, copy=True) if line is None or s == line.me
                  else None for s, d in enumerate(devs)]
    else:
        copies = list(x)
        if len(copies) != len(devs):
            raise ValueError(f"{len(copies)} copies for the {len(devs)} "
                             f"shards of axis {axis_name!r}")
    g = torch.stack(all_gather(copies, mesh.output_device(axis_name),
                               line))  # (n, ...)
    return torch.abs(g - g[0]).to(torch.float32).max()


def assert_replicated(
    x: Union[torch.Tensor, Sequence[torch.Tensor]], mesh: Mesh,
    axis_name: str, atol: float = 0.0,
) -> None:
    """Host-raising form of `replication_discrepancy`."""
    d = float(replication_discrepancy(x, mesh, axis_name))
    if not (d <= atol):
        raise AssertionError(
            f"value is not replicated across '{axis_name}': "
            f"max deviation {d} > {atol}"
        )


# The ops whose JAX primitives checkify's NaN check covers
# (jax._src.checkify.nan_primitives: arithmetic, transcendental,
# cumulative, sum/prod reductions, dot, conv, pad, rem, ...), by ATen
# name, in-place forms included. Not max/min, selects, casts or indexing:
# JAX does not check those either.
_NAN_OPS = frozenset("""
    add sub rsub mul pow exp exp2 expm1 log log1p log2 log10 sqrt rsqrt
    sin cos tan sinh cosh tanh asin acos atan atan2 asinh acosh atanh
    erf erfc erfinv lgamma digamma sigmoid cumsum cumprod cummax cummin
    logcumsumexp sum nansum prod mean mm bmm addmm matmul dot mv
    convolution remainder fmod constant_pad_nd linalg_solve
    _fft_r2c _fft_c2c _fft_c2r
""".split())
# division, whose zero divisors checkify reports (its div check, for any
# dtype); the divisor is argument 1, or 0 for reciprocal (JAX's 1/x)
_DIV_OPS = {"div": 1, "floor_divide": 1, "true_divide": 1,
            "reciprocal": 0}


class _FloatChecks(TorchDispatchMode):
    """Records, op by op, a device flag for each check, and reads them back
    at the end: on the card no host sync per op. A division on the CPU
    reads them back first, since an integer division by zero raises inside
    the op there."""

    def __init__(self):
        super().__init__()
        self.flags = []  # (message, 0-d bool tensor)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__.rstrip("_")
        if name in _DIV_OPS:
            y = args[_DIV_OPS[name]]
            zero = (y == 0).any() if isinstance(y, torch.Tensor) else (
                torch.tensor(y == 0))
            self.flags.append(("division by zero", zero))
            # an integer division by zero raises inside the op on the CPU:
            # report it as checkify does, first
            if all(a.device.type == "cpu" for a in args
                   if isinstance(a, torch.Tensor)):
                self.throw()
        out = func(*args, **kwargs)
        if name in _NAN_OPS:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for o in outs:
                if isinstance(o, torch.Tensor) and o.is_floating_point():
                    self.flags.append(
                        (f"nan generated by op: {name}", torch.isnan(o).any()))
        return out

    def throw(self) -> None:
        if not self.flags:
            return
        hit = torch.stack([f.cpu() for _, f in self.flags])
        if bool(hit.any()):
            raise FloatingPointError(self.flags[int(hit.int().argmax())][0])
        self.flags = []


def checked_call(fn, *args, **kwargs):
    """Run ``fn`` under the checks of ``checkify.float_checks`` and raise
    ``FloatingPointError`` on the host for the first op that failed one.

    What ``float_checks`` reports (pinned against the JAX package's
    ``checked_call`` in tests/test_torch_parallel.py), despite the JAX
    docstring's "NaN/Inf":
      * a NaN in the output of an op that can make one (``_NAN_OPS``),
        whether or not its inputs held NaNs already;
      * a division whose divisor holds a zero, for any dtype, also when
        the result is a finite or infinite float (``1.0 / 0.0``).
    An Inf is not reported (``log(0)``, ``exp(1000)``), nor a NaN out of
    ``max``, a select or a cast. Use for debugging numerical faults inside
    pipelines (e.g. a colour model fed out-of-gamut data):

        out = checked_call(torch_transform.forward, batch, settings, 4)
    """
    mode = _FloatChecks()
    with mode:
        out = fn(*args, **kwargs)
    mode.throw()
    return out
