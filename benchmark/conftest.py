"""The CPU shapes of configurations that ``benchmark/tests/helpers.SHAPES``
does not list, so that ``helpers.tiny`` runs every cell of
``BENCHMARK.json`` at a tiny size on the CPU.

nuscenes-cam-ipt: 3x45x80 at level 2, the rig's 16:9 frame; LL 15x23,
odd in both dimensions as the full frame's 11x17 is, so its trees have
duplicate parents and a batch decodes through batched B3."""

from benchmark.tests import helpers

helpers.SHAPES.setdefault("nuscenes-cam-ipt", [3, 45, 80])
