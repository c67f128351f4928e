"""Closed-form spatial-orientation-tree queue bounds.

A verbatim copy of ``spiht_tpu/codec/tree_bounds.py`` (the port imports
nothing of the JAX package); tests/test_torch_copies.py holds the two equal.
The port sizes its CUDA machines' queues with ``narrowed_caps``.

The Pallas bit machines gate routing on their VMEM state size, which
depends on exact queue-capacity bounds (``ent_bound``/``lis_bound`` =
total LIS/LSP arrival counts over the whole run, duplicate parents
included).  ``device_decoder._dec_geom`` computes those by materializing
N-sized tables and a diagonal-sweep topological DP — O((h+w)·h·w), which
took >100 s at 2048²-class geometries (round-3 verdict item 5).  This
module computes the SAME numbers in closed form, O(ll·levels) integer
arithmetic, so ``machine_fits`` answers in microseconds at any geometry.

Why a closed form exists (reference semantics:
the reference encoder_decoder.rs:43-75, SURVEY.md §3.4):

* LL roots (parity rule) produce children only inside the first block
  B1 = [0,2·ll_h)×[0,2·ll_w) \\ LL, and the per-axis child rows/cols of
  an LL parent depend only on that axis (``oi`` on i, ``oj`` on j); the
  parent bound check ``(oi+1<h) & (oj+1<w)`` is a conjunction of per-axis
  predicates.  So a B1 cell's parent count is ``m_r(r)·m_c(c) −
  m_r_even(r)·m_c_even(c)`` (the subtraction removes (even,even) LL
  cells, which have no offspring) — separable.
* Every cell outside LL∪B1 has exactly ONE parent, its dyadic parent
  (x//2, y//2): the parity rule only reaches B1, and the dyadic parent
  of a B1 cell lies inside LL (which doesn't use the dyadic rule), so
  instance counts flow unchanged down each B1 subtree.
* A generic-rule subtree's per-depth node count is a product of per-axis
  chain-interval sizes: the reachable row set at depth d under row r is
  an interval [a_d, b_d) with a_{d+1}=2·a_d, b_{d+1}=2·min(b_d, dim//2)
  (parent row u spawns iff 2u+1 < dim ⟺ u < dim//2), and existence of a
  descendant factors into (row chain ok) ∧ (col chain ok) because each
  ancestor's has_child is a conjunction of per-axis predicates.

Hence  arrivals_sum = Σ_x∉LL inst[x]
                    = Σ_d [ S_r(d)·S_c(d) − S_r_even(d)·S_c_even(d) ]
with S_r(d) = Σ_r m_r(r)·A_d(r) over B1 rows, A_d the chain-interval
sizes — a few hundred integer ops.  Property-tested exhaustively against
the diagonal-sweep ground truth in tests/test_vmem_guard.py.
"""

from __future__ import annotations

from functools import lru_cache

__all__ = ["queue_bounds", "QueueBounds", "narrowed_caps"]


def narrowed_caps(qb, cap_words: int):
    """Budget-narrowed queue capacities (lip, lis, lsp) — safe for any
    stream of <= cap_words*32 bits by the bit-charging argument in
    pallas_encoder._narrowed_caps; shared by the machine builders
    (table-built bounds) and the closed-form routing guards so both
    always agree.  ``qb`` needs .n_lip0/.n_lis0/.ent_bound/.lis_bound."""
    cap_bits = cap_words * 32
    n_lip0 = max(qb.n_lip0, 1)
    n_lis0 = max(qb.n_lis0, 1)
    lip_cap = min(qb.ent_bound + 1, n_lip0 + cap_bits + 2)
    lsp_cap = min(qb.ent_bound + 1, cap_bits // 2 + 2)
    lis_cap = min(2 * qb.lis_bound + 1, n_lis0 + cap_bits + 8)
    return lip_cap, lis_cap, lsp_cap


def _axis_parent_maps(ll: int, dim: int):
    """Per-B1-row parent multiplicities along one axis.

    Returns {row: (m_all, m_even)} where ``m_all`` counts LL indices i
    whose parity-rule child pair {oi, oi+1} covers ``row`` AND whose
    per-axis bound check ``oi+1 < dim`` passes; ``m_even`` counts only
    even i among those (for the (even,even)-pair exclusion).
    """
    m: dict[int, list[int]] = {}
    for i in range(ll):
        o = (i % 2) * ll + (i // 2) * 2
        if o + 1 >= dim:
            continue
        for r in (o, o + 1):
            cell = m.setdefault(r, [0, 0])
            cell[0] += 1
            if i % 2 == 0:
                cell[1] += 1
    return m


def _chain_sizes(r: int, dim: int, max_d: int):
    """Generic-rule reachable-set sizes per depth under row ``r``:
    [A_0=1, A_1, ...] until the chain dies (parent u spawns children
    {2u, 2u+1} iff 2u+1 < dim, i.e. u < dim//2; reachable sets stay
    intervals).  The r=0 chain never dies (row 0 is its own child), so
    depth is capped at ``max_d``: past every finite chain's death only
    the 0-chains remain, whose lone LL parent is i=0 (even), making the
    all/even products cancel exactly — zero contribution."""
    sizes = [1]
    a, b = r, r + 1
    cap = dim // 2
    while len(sizes) < max_d:
        bb = min(b, cap)
        if bb <= a:
            break
        a, b = 2 * a, 2 * bb
        sizes.append(b - a)
    return sizes


class QueueBounds:
    """Closed-form equivalents of ``_dec_geom``'s bound fields."""

    __slots__ = (
        "n_lip0", "n_lis0", "ent_bound", "lis_bound",
        "has_duplicate_parents",
    )

    def __init__(self, n_lip0, n_lis0, ent_bound, lis_bound, dup):
        self.n_lip0 = n_lip0
        self.n_lis0 = n_lis0
        self.ent_bound = ent_bound
        self.lis_bound = lis_bound
        self.has_duplicate_parents = dup


@lru_cache(maxsize=None)
def _axis_terms(ll: int, dim: int, max_d: int):
    """Per-depth axis sums (S_all[d], S_even[d]) and the distinct
    per-axis parent multiplicities (for duplicate detection)."""
    pm = _axis_parent_maps(ll, dim)
    if not pm:
        return (), ()
    chains = [
        (ma, me, _chain_sizes(r, dim, max_d)) for r, (ma, me) in pm.items()
    ]
    max_d = max(len(s) for _, _, s in chains)
    s_all = [0] * max_d
    s_even = [0] * max_d
    for ma, me, sizes in chains:
        for d, sz in enumerate(sizes):
            s_all[d] += ma * sz
            s_even[d] += me * sz
    # distinct (m_all, m_even) pairs for the duplicate max-product check
    pairs = tuple(sorted({tuple(v) for v in pm.values()}))
    return tuple(zip(s_all, s_even)), pairs


@lru_cache(maxsize=None)
def queue_bounds(
    c: int, h: int, w: int, ll_h: int, ll_w: int
) -> QueueBounds:
    """Exact (n_lip0, n_lis0, ent_bound, lis_bound, duplicate-parents)
    for the geometry — identical to the ``_dec_geom`` table DP, in
    closed form."""
    # depth cap: every finite chain dies within bit_length(dim) depths
    # (its interval start r·2^d reaches dim//2); past that only the
    # 0-chains survive and their all/even terms cancel (see
    # _chain_sizes), so truncation is exact.
    max_d = max(h, w).bit_length() + 2
    row_terms, row_pairs = _axis_terms(ll_h, h, max_d)
    col_terms, col_pairs = _axis_terms(ll_w, w, max_d)
    arrivals = 0
    for d in range(min(len(row_terms), len(col_terms))):
        ra, re = row_terms[d]
        ca, ce = col_terms[d]
        arrivals += ra * ca - re * ce
    dup = False
    for ra, re in row_pairs:
        for ca, ce in col_pairs:
            if ra * ca - re * ce > 1:
                dup = True
                break
        if dup:
            break
    n_ll = ll_h * ll_w
    n_ee = ((ll_h + 1) // 2) * ((ll_w + 1) // 2)
    return QueueBounds(
        n_lip0=c * n_ll,
        n_lis0=c * (n_ll - n_ee),
        ent_bound=c * (n_ll + arrivals),
        lis_bound=c * (n_ll - n_ee + arrivals),
        dup=dup,
    )
