"""Code construction: random regular codes, QC expansion and detection,
and a systematic generator solver.

A copy of the parts of :mod:`libldpc_tpu.models.construct` that the port
uses; with the same seeds they build the same codes, edge for edge, except
where :func:`make_regular_code`'s duplicate repair would break regularity
there (see its docstring).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from . import gf2
from .code import LDPCCode


def make_regular_code(nc: int, dv: int, dc: int, seed: int = 0, max_tries: int = 100) -> LDPCCode:
    """Random (dv, dc)-regular LDPC code with ``nc`` variable nodes, by the
    configuration model: variable sockets matched to check sockets by a
    random permutation, with duplicate edges swapped away.

    The swap partners are drawn as the JAX package draws them; where that
    draw repeats an edge or hits an edge being moved (the swap would then
    change a check's degree), the offending partners are drawn again among
    the edges not yet involved, so every check keeps exactly ``dc`` edges.
    With draws that need no repair the code is the JAX package's, edge for
    edge."""
    if (nc * dv) % dc != 0:
        raise ValueError(f"nc*dv ({nc * dv}) must be divisible by dc ({dc})")
    mc = nc * dv // dc
    rng = np.random.default_rng(seed)
    cols = np.repeat(np.arange(nc, dtype=np.int64), dv)
    rows = rng.permutation(nc * dv) // dc  # check socket owner per edge
    for _ in range(max_tries):
        key = rows.astype(np.int64) * nc + cols
        _, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
        dup_positions = np.nonzero(counts[inverse] > 1)[0]
        if dup_positions.size == 0:
            order = np.argsort(key, kind="stable")
            return LDPCCode(rows=rows[order].astype(np.int32), cols=cols[order].astype(np.int32),
                            nc=nc, mc=mc)
        # keep one edge of each duplicate group in place, swap the others'
        # check side with a random edge
        move = []
        seen = set()
        for p in dup_positions:
            g = inverse[p]
            if g in seen:
                move.append(p)
            else:
                seen.add(g)
        move = np.array(move, dtype=np.int64)
        partners = rng.integers(0, nc * dv, size=move.size)
        # a proper swap needs distinct partners outside `move`
        taken = np.zeros(nc * dv, dtype=bool)
        taken[move] = True
        for i, p in enumerate(partners):
            if taken[p]:
                free = np.nonzero(~taken)[0]
                partners[i] = p = free[rng.integers(0, free.size)]
            taken[p] = True
        rows[move], rows[partners] = rows[partners].copy(), rows[move].copy()
    raise RuntimeError(
        f"could not construct a simple (dv={dv}, dc={dc}) graph in {max_tries} tries")


def systematic_generator(code: LDPCCode, seed: int = 0) -> Optional[np.ndarray]:
    """A generator G with ``H @ G^T = 0`` and full rank, in the code's own
    column order, from bit-packed GF(2) elimination of H; None when H
    leaves no full-rank information set."""
    H = code.H_dense.astype(np.uint8)
    mc, nc = H.shape
    R = gf2.pack_rows(H)
    pivot_cols: list[int] = []
    r = 0
    for col in range(nc):
        if r >= mc:
            break
        w, bit = divmod(col, 64)
        mask = np.uint64(1) << np.uint64(bit)
        colbits = (R[r:, w] & mask) != 0
        if not colbits.any():
            continue
        p = r + int(np.argmax(colbits))
        if p != r:
            R[[r, p]] = R[[p, r]]
        sel = (R[:, w] & mask) != 0
        sel[r] = False
        R[sel] ^= R[r]
        pivot_cols.append(col)
        r += 1
    rank = r
    pivots = set(pivot_cols)
    free_cols = np.array([c for c in range(nc) if c not in pivots], dtype=np.int64)
    k = nc - rank
    if free_cols.size != k:
        return None
    Rd = gf2.unpack_rows(R[:rank], nc)
    # RREF rows: x[pivot_cols[i]] = sum_j Rd[i, free_j] x[free_j]
    G = np.zeros((k, nc), dtype=np.uint8)
    G[np.arange(k), free_cols] = 1
    G[:, np.array(pivot_cols, dtype=np.int64)] = Rd[:, free_cols].T
    # full H G^T = 0 check for small codes, a sampled one for large ones
    if nc <= 2048:
        assert not gf2.mat_mat(H, G.T).any()
    else:
        rng = np.random.default_rng(0)
        u = rng.integers(0, 2, size=(16, k)).astype(np.int64)
        cw = (u @ G.astype(np.int64)) % 2
        assert not ((H.astype(np.int64) @ cw.T) % 2).any()
    return G


def expand_qc(base_matrix: np.ndarray, Z: int) -> LDPCCode:
    """Expand a quasi-cyclic base matrix (``-1`` = zero block, ``s >= 0`` =
    identity right-shifted by ``s``): row ``i`` of block ``(bi, bj)``
    connects check ``bi*Z + i`` to variable ``bj*Z + (i + s) mod Z``."""
    B = np.asarray(base_matrix, dtype=np.int64)
    mb, nb = B.shape
    rows_list = []
    cols_list = []
    i_in_block = np.arange(Z, dtype=np.int64)
    for bi in range(mb):
        for bj in range(nb):
            s = B[bi, bj]
            if s < 0:
                continue
            rows_list.append(bi * Z + i_in_block)
            cols_list.append(bj * Z + (i_in_block + s) % Z)
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    order = np.lexsort((cols, rows))
    return LDPCCode(rows=rows[order].astype(np.int32), cols=cols[order].astype(np.int32),
                    nc=nb * Z, mc=mb * Z, qc=(Z, B.copy()))


def qc_natural_layers(code: LDPCCode) -> list:
    """Set and return ``code.layers`` to the natural layered schedule of a
    QC code: one layer per base row.  Requires ``code.qc``."""
    if code.qc is None:
        raise ValueError("qc_natural_layers requires QC metadata (expand_qc/detect_qc)")
    Z = code.qc[0]
    code.layers = [np.arange(r * Z, (r + 1) * Z, dtype=np.int32) for r in range(code.mc // Z)]
    return code.layers


def detect_qc(code: LDPCCode, Z=None) -> np.ndarray:
    """Verify that H is quasi-cyclic at lifting size ``Z`` (every ``ZxZ``
    block zero or a single shifted identity), stamp ``code.qc = (Z, base)``
    and return the base matrix.  ``Z`` of None, ``"auto"`` or 0 tries every
    divisor ``>= 2`` of ``gcd(nc, mc)``, largest first.  Raises
    ``ValueError`` when H is not QC."""
    if Z in (None, 0, "auto"):
        g = math.gcd(code.nc, code.mc)
        divisors = set()
        d = 1
        while d * d <= g:
            if g % d == 0:
                divisors.update((d, g // d))
            d += 1
        for cand in sorted(divisors, reverse=True):
            if cand < 2:
                continue
            try:
                return detect_qc(code, cand)
            except ValueError:
                continue
        raise ValueError(
            f"no QC structure found: H is not quasi-cyclic at any lifting size >= 2 "
            f"dividing gcd(nc={code.nc}, mc={code.mc}) = {g}")
    Z = int(Z)
    if Z < 1:
        raise ValueError(f"lifting size must be positive (got Z={Z})")
    if code.nc % Z or code.mc % Z:
        raise ValueError(f"nc={code.nc} / mc={code.mc} not multiples of Z={Z}")
    mb, nb = code.mc // Z, code.nc // Z
    rows = code.rows.astype(np.int64)
    cols = code.cols.astype(np.int64)
    base = np.full((mb, nb), -1, dtype=np.int64)
    be = (rows // Z) * nb + (cols // Z)
    order = np.argsort(be, kind="stable")
    pos = 0
    while pos < rows.size:
        b = be[order[pos]]
        end = pos
        while end < rows.size and be[order[end]] == b:
            end += 1
        grp = order[pos:end]
        if grp.size != Z:
            raise ValueError(f"base cell ({b // nb}, {b % nb}) has {grp.size} edges, "
                             f"not Z={Z}: H is not QC at this lifting size")
        k = rows[grp] % Z
        i = cols[grp] % Z
        if np.bincount(k, minlength=Z).max() != 1:
            raise ValueError(f"base cell ({b // nb}, {b % nb}) is not a permutation block")
        s = int((i[0] - k[0]) % Z)
        if not (((k + s) % Z) == i).all():
            raise ValueError(f"base cell ({b // nb}, {b % nb}) is not a single "
                             "cyclic-shift circulant")
        base[b // nb, b % nb] = s
        pos = end
    code.qc = (int(Z), base)
    return base


def make_qc_benchmark_code(nc: int, Z: int, dv: int = 3, dc: int = 6, seed: int = 0,
                           with_G: bool = False) -> LDPCCode:
    """A (dv, dc)-regular QC code: column ``j`` of the base has its ``dv``
    cells at rows ``(j*dv + t) % mb`` with random shifts, lifted by ``Z``."""
    if nc % Z:
        raise ValueError(f"nc={nc} not a multiple of Z={Z}")
    nb = nc // Z
    if nb * dv % dc:
        raise ValueError(f"(nc/Z)*dv = {nb * dv} not a multiple of dc={dc}")
    mb = nb * dv // dc
    if dv > mb:
        raise ValueError(f"dv={dv} > mb={mb}: base too small for distinct rows per column")
    rng = np.random.default_rng(seed)
    B = np.full((mb, nb), -1, dtype=np.int64)
    for j in range(nb):
        for t in range(dv):
            r = (j * dv + t) % mb
            if B[r, j] >= 0:
                raise ValueError("base construction collision; pick nb/mb with gcd(dv, mb) = 1")
            B[r, j] = int(rng.integers(0, Z))
    counts = (B >= 0).sum(axis=1)
    assert (counts == dc).all(), counts
    code = expand_qc(B, Z)
    if with_G:
        G = systematic_generator(code)
        if G is not None:
            code.G = G
    return code


def make_benchmark_code(nc: int, dv: int = 3, dc: int = 6, seed: int = 0,
                        with_G: bool = False) -> LDPCCode:
    """A (dv, dc)-regular benchmark code; with ``with_G``, the first seed
    (``seed + 1000 * attempt``) whose H gives a full-rank generator."""
    for attempt in range(20):
        code = make_regular_code(nc, dv, dc, seed=seed + 1000 * attempt)
        if not with_G:
            return code
        G = systematic_generator(code)
        if G is not None:
            code.G = G
            return code
    raise RuntimeError("failed to construct benchmark code with generator")


def make_peg_code(nc: int, dv, mc: Optional[int] = None, rate: Optional[float] = None,
                  seed: int = 0) -> LDPCCode:
    """Progressive edge-growth (PEG) construction (Hu, Eleftheriou, Arnold).

    Each variable's k-th edge goes to a lowest-degree check that the
    current graph cannot reach from the variable (no new cycle), or, when
    every check is reachable, to a lowest-degree check at the greatest BFS
    distance (the longest new cycle); ties are broken by
    ``np.random.default_rng(seed)``, drawn as the JAX package draws them, so
    the same arguments give the same H.  ``dv`` is an int (regular) or a
    length-``nc`` degree sequence, taken in nondecreasing order; give the
    check count as ``mc`` or as the design ``rate`` (``1 - mc/nc``).  One BFS
    per edge: O(E^2)."""
    if (mc is None) == (rate is None):
        raise ValueError("give exactly one of mc or rate")
    if mc is None:
        mc = int(round(nc * (1.0 - rate)))
    if np.ndim(dv) == 0:
        degs = np.full(nc, int(dv), np.int64)
    else:
        degs = np.asarray(dv, np.int64)
        if degs.shape != (nc,):
            raise ValueError(f"dv sequence must have length {nc}")
    if (degs < 1).any() or (degs > mc).any():
        raise ValueError("variable degrees must be in [1, mc]")
    rng = np.random.default_rng(seed)
    vn_adj: list = [[] for _ in range(nc)]  # checks per variable
    cn_adj: list = [[] for _ in range(mc)]  # variables per check
    cn_deg = np.zeros(mc, np.int64)

    def lowest_degree_pick(mask):
        cand = np.nonzero(mask)[0]
        d = cn_deg[cand]
        cand = cand[d == d.min()]
        return int(cand[rng.integers(cand.size)])

    def neighbours(adj, nodes):
        lists = [adj[n] for n in nodes]
        return np.unique(np.concatenate(lists)) if lists else np.empty(0, np.int64)

    for v in np.argsort(degs, kind="stable"):
        for k in range(degs[v]):
            if k == 0:
                c = lowest_degree_pick(np.ones(mc, bool))
            else:
                # BFS from v by check levels, until the coverage stops
                # growing (any check left unreached closes no cycle) or is
                # total (the last level's checks close the longest cycle)
                seen_c = np.zeros(mc, bool)
                seen_v = np.zeros(nc, bool)
                seen_v[v] = True
                frontier = np.asarray(vn_adj[v], np.int64)
                seen_c[frontier] = True
                while True:
                    vs = neighbours(cn_adj, frontier)
                    vs = vs[~seen_v[vs]]
                    seen_v[vs] = True
                    cs = neighbours(vn_adj, vs)
                    cs = cs[~seen_c[cs]]
                    if cs.size == 0:
                        break
                    prev = seen_c.copy()
                    seen_c[cs] = True
                    if seen_c.all():
                        seen_c = prev
                        break
                    frontier = cs
                c = lowest_degree_pick(~seen_c)
            vn_adj[v].append(c)
            cn_adj[c].append(v)
            cn_deg[c] += 1
    rows = np.concatenate([np.full(len(cn_adj[c]), c, np.int64) for c in range(mc)])
    cols = np.concatenate([np.asarray(cn_adj[c], np.int64) for c in range(mc)])
    order = np.lexsort((cols, rows))
    return LDPCCode(rows=rows[order].astype(np.int32), cols=cols[order].astype(np.int32),
                    nc=nc, mc=mc)


def count_4cycles(code: LDPCCode) -> int:
    """Number of length-4 cycles of the Tanner graph: over the check pairs
    that share ``s >= 2`` variables, the sum of ``C(s, 2)``.  Each variable
    of degree d gives its C(d, 2) check pairs one shared variable; O(sum of
    dv^2) on the edge list."""
    rows = code.rows.astype(np.int64)
    cols = code.cols.astype(np.int64)
    order = np.argsort(cols, kind="stable")
    r_sorted, c_sorted = rows[order], cols[order]
    starts = np.searchsorted(c_sorted, np.arange(code.nc))
    ends = np.searchsorted(c_sorted, np.arange(code.nc), side="right")
    pair_a, pair_b = [], []
    for s, e in zip(starts, ends):
        d = e - s
        if d < 2:
            continue
        chks = np.sort(r_sorted[s:e])
        ia, ib = np.triu_indices(d, k=1)
        pair_a.append(chks[ia])
        pair_b.append(chks[ib])
    if not pair_a:
        return 0
    keys = np.concatenate(pair_a) * np.int64(code.mc) + np.concatenate(pair_b)
    _, shared = np.unique(keys, return_counts=True)
    return int((shared * (shared - 1) // 2).sum())


def girth(code: LDPCCode, cap: int = 16) -> int:
    """Length of the Tanner graph's shortest cycle, by a BFS from every
    check that never walks back along its arrival edge; ``cap`` when no
    cycle is shorter than ``cap``.  O(V E): for small and medium codes."""
    n_nodes = code.nc + code.mc  # variables, then checks
    adj: list = [[] for _ in range(n_nodes)]
    for e, (r, c) in enumerate(zip(code.rows, code.cols)):
        adj[int(c)].append((e, code.nc + int(r)))
        adj[code.nc + int(r)].append((e, int(c)))
    best = cap
    for s in range(code.nc, n_nodes):
        dist = np.full(n_nodes, -1, np.int64)
        via = np.full(n_nodes, -1, np.int64)
        dist[s] = 0
        queue = [s]
        while queue:
            nxt = []
            for u in queue:
                if 2 * dist[u] + 1 >= best:
                    continue
                for e, w in adj[u]:
                    if e == via[u]:
                        continue
                    if dist[w] < 0:
                        dist[w] = dist[u] + 1
                        via[w] = e
                        nxt.append(w)
                    else:
                        best = min(best, int(dist[u] + dist[w] + 1))
            queue = nxt
    return int(best)
