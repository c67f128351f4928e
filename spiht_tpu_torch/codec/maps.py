"""Significance level maps in PyTorch, the port of
``spiht_tpu/codec/maps.py:45-117``.

  M[k,i,j] = floor(log2 |x|)   (-1 for 0)          element level
                                 |x| as uint32: 31 for -2^31
  D[k,i,j] = max over all strict descendants of M   set level
  G[k,i,j] = max over children of D                 L-set level

Every bit-plane test of the encoder is then one comparison:
``M >= n``, ``D >= n``, ``G >= n``. M comes from 31 integer thresholds;
D is the fixpoint of "child-max of max(M, D)" over ``tree_height``
rounds, each a 2x2 max-pool plus the LL parity gather.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import constant

__all__ = ["significance_maps", "tree_height", "max_n_from_maps"]


@constant
def _ll_child_index(ll_h: int, ll_w: int, device):
    """Child-block origins (oi, oj) and the no-child mask of LL roots, on
    ``device``."""
    i = np.arange(ll_h)[:, None]
    j = np.arange(ll_w)[None, :]
    oi = (i % 2) * ll_h + (i // 2) * 2
    oj = (j % 2) * ll_w + (j // 2) * 2
    oi, oj = np.broadcast_arrays(oi, oj)
    nochild = (i % 2 == 0) & (j % 2 == 0)
    return (
        torch.as_tensor(oi.copy(), dtype=torch.long, device=device),
        torch.as_tensor(oj.copy(), dtype=torch.long, device=device),
        torch.as_tensor(np.broadcast_to(nochild, (ll_h, ll_w)).copy(),
                        device=device),
    )


def tree_height(h: int, w: int, ll_h: int, ll_w: int) -> int:
    """Rounds needed for the descendant-max fixpoint (tree height + slack)."""
    r = max(h / max(ll_h, 1), w / max(ll_w, 1), 2.0)
    return int(np.ceil(np.log2(r))) + 2


def _child_max(X: torch.Tensor, ll_h: int, ll_w: int) -> torch.Tensor:
    """max over spatial-orientation-tree children of X, per cell (-1 if
    none). X: (..., H, W) integer tensor."""
    h, w = X.shape[-2], X.shape[-1]
    hh, ww = h // 2, w // 2
    out = torch.full_like(X, -1)
    if hh > 0 and ww > 0:
        blk = X[..., : 2 * hh, : 2 * ww].reshape(
            tuple(X.shape[:-2]) + (hh, 2, ww, 2)
        )
        out[..., :hh, :ww] = blk.amax(dim=(-3, -1))
    oi, oj, nochild = _ll_child_index(ll_h, ll_w, X.device)
    g = torch.maximum(
        torch.maximum(X[..., oi, oj], X[..., oi, oj + 1]),
        torch.maximum(X[..., oi + 1, oj], X[..., oi + 1, oj + 1]),
    )
    g = g.masked_fill(nochild, -1)
    out[..., :ll_h, :ll_w] = g
    return out


def significance_maps(
    arr: torch.Tensor, ll_h: int, ll_w: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(M, D, G) int8 level maps of an int32 packed coefficient array
    (..., H, W)."""
    h, w = arr.shape[-2], arr.shape[-1]
    absx = torch.abs(arr)
    # the magnitude as uint32, as the native scheduler takes it: abs leaves
    # -2^31 negative, and its M is 31
    m = (absx < 0).to(torch.int8) * 32 - 1
    for k in range(31):
        m += (absx >= (1 << k)).to(torch.int8)
    d = torch.full_like(m, -1)
    for _ in range(tree_height(h, w, ll_h, ll_w)):
        d = _child_max(torch.maximum(m, d), ll_h, ll_w)
    g = _child_max(d, ll_h, ll_w)
    return m, d, g


def max_n_from_maps(m: torch.Tensor) -> torch.Tensor:
    """The exact initial bit-plane index max(floor(log2 |x|), 0) per
    (..., H, W) map M, as int32. For planning and statistics: the stream's
    max_n follows the reference's float32 rule (``maxn.device_max_n``),
    which is one more for magnitudes >= 2^24 just below a power of two."""
    return torch.clamp(m.amax(dim=(-2, -1)), min=0).to(torch.int32)
