"""Quasi-cyclic (dv, dc)-regular LDPC code construction — host side, cached.

An own NumPy copy of esn_ofdm_mimo_tpu/ldpc/code.py for the QC family (the
flagship's `LdpcConfig(family="qc")`): the same shift-table search, GF(2)
systematisation and index tensors, so the same seed gives the same H,
shifts, permutation and gather maps as the JAX package. The Gallager and
pyldpc families are not ported yet (`make_code` raises for them).

Construction (see make_qc_ldpc): H is a dv x dc grid of Z x Z shifted
identity circulants; GF(2) elimination row-trims it to full rank and moves
the pivot columns first, giving H' = [A | B] with encoder P = A^-1 B, so a
codeword is [P u | u] with the info bits in the LAST k positions. BP decodes
on the full lifted graph in natural column order (QcInfo).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np


class QcInfo(NamedTuple):
    """Quasi-cyclic structure of a QC code (see make_qc_ldpc).

    The decode graph in NATURAL column order is the full Z*n_rows-check
    lifted base graph (including the dv-1 redundant checks the row-trimmed
    encoder view drops — harmless for BP, and they preserve the perfect
    cyclic structure the BP kernel routes with).
    """
    Z: int                    # lift (circulant) size; n == dc * Z
    shifts: np.ndarray        # (dv, dc) int32 circulant shift table
    perm: np.ndarray          # (n,) natural column of pipeline position p
    inv_perm: np.ndarray      # (n,) pipeline position of natural column v
    ck_cols_nat: np.ndarray   # (dv*Z, dc) int32 full graph, natural order
    var_edge_nat: np.ndarray  # (n, dv) int32 full graph, natural order


class LdpcCode(NamedTuple):
    """Host-side immutable code description (NumPy; moved to a device by
    the functions that use it)."""
    n: int                  # codeword length
    k: int                  # info bits
    m: int                  # parity checks (rows of H)
    dv: int
    dc: int
    H: np.ndarray           # (m, n) int8 parity-check matrix (dense 0/1)
    P: np.ndarray           # (m, k) int8 encoder matrix: parity = P @ u mod 2
    ck_cols: np.ndarray     # (m, dc) int32: columns participating in check i
    var_edge: np.ndarray    # (n, dv) int32: flat indices into (m*dc) edge
    #                         array of the edges incident to variable v
    qc: QcInfo | None = None  # set for quasi-cyclic codes (make_qc_ldpc)


def _gf2_pivot_columns(H: np.ndarray):
    """Row-reduce a copy of H over GF(2); return (pivot_cols, rank)."""
    A = H.copy().astype(np.uint8)
    m, n = A.shape
    pivots = []
    r = 0
    for c in range(n):
        if r >= m:
            break
        rows = np.nonzero(A[r:, c])[0]
        if len(rows) == 0:
            continue
        pr = r + rows[0]
        if pr != r:
            A[[r, pr]] = A[[pr, r]]
        elim = np.nonzero(A[:, c])[0]
        elim = elim[elim != r]
        A[elim] ^= A[r]
        pivots.append(c)
        r += 1
    return pivots, r


def _gf2_inv_apply(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Solve A X = B over GF(2) for invertible A (m x m); returns X (m x k)."""
    m = A.shape[0]
    aug = np.concatenate([A, B], axis=1).astype(np.uint8)
    for col in range(m):
        rows = np.nonzero(aug[col:, col])[0]
        pr = col + rows[0]
        if pr != col:
            aug[[col, pr]] = aug[[pr, col]]
        elim = np.nonzero(aug[:, col])[0]
        elim = elim[elim != col]
        aug[elim] ^= aug[col]
    return aug[:, m:]


def _systematize(H_full: np.ndarray):
    """Row-trim to full rank, column-permute pivots first, build encoder.

    Returns (Hp, P, perm): Hp = H_trimmed[:, perm] = [A | B] with A
    invertible; P = A^-1 B; perm[p] is the original column at pipeline
    position p. Dropping linearly DEPENDENT rows leaves the row space (and
    hence the codebook) unchanged.
    """
    n = H_full.shape[1]
    keep, _ = _gf2_pivot_columns(H_full.T)
    H = H_full[np.asarray(keep)]
    m = H.shape[0]
    pivots, rank = _gf2_pivot_columns(H)
    assert rank == m, (rank, m)
    pivots = np.asarray(pivots[:m])
    rest = np.setdiff1d(np.arange(n), pivots)
    perm = np.concatenate([pivots, rest])
    Hp = np.ascontiguousarray(H[:, perm])
    A, B = Hp[:, :m], Hp[:, m:]
    P = _gf2_inv_apply(A, B).astype(np.int8)
    return Hp.astype(np.int8), P, perm


def _index_tensors(H: np.ndarray):
    """Dense decoder gather maps for an arbitrary 0/1 parity matrix.

    Rows may have unequal weight; each check's column list is padded to the
    max weight with a sentinel column n (an always-erased +inf-LLR edge).
    """
    m, n = H.shape
    row_weights = H.sum(axis=1)
    dc_max = int(row_weights.max())
    ck_cols = np.full((m, dc_max), n, dtype=np.int32)
    for i in range(m):
        cols = np.nonzero(H[i])[0]
        ck_cols[i, :len(cols)] = cols
    col_weights = H.sum(axis=0)
    dv_max = int(col_weights.max())
    var_edge = np.full((n, dv_max), m * dc_max, dtype=np.int32)
    fill = np.zeros(n, dtype=np.int64)
    for i in range(m):
        for j, c in enumerate(ck_cols[i]):
            if c < n:
                var_edge[c, fill[c]] = i * dc_max + j
                fill[c] += 1
    return ck_cols, var_edge


def _qc_shift_table(dv: int, dc: int, Z: int, seed: int) -> np.ndarray:
    """Pick a (dv, dc) circulant shift table: girth >= 6, few 6-cycles.

    4-cycle-free (Fossorier): for every row pair (i1,i2) and column pair
    (j1,j2), s[i1,j1]-s[i1,j2]+s[i2,j2]-s[i2,j1] != 0 (mod Z). Among
    candidate tables satisfying that, minimize the count of 6-cycle
    congruences — the short cycles that dominate the BP error floor.
    """
    rng = np.random.default_rng(seed + 7_777_777)
    rows = [(i1, i2) for i1 in range(dv) for i2 in range(i1 + 1, dv)]

    def four_cycle_count(s):
        cnt = 0
        for i1, i2 in rows:
            d = (s[i1] - s[i2]) % Z          # (dc,)
            # a repeated difference across two columns => 4-cycle
            cnt += dc - len(np.unique(d))
        return cnt

    def six_cycle_count(s):
        cnt = 0
        from itertools import combinations, permutations
        for ri in combinations(range(dv), 3):
            for cj in combinations(range(dc), 3):
                # each cyclic arrangement of the 3 columns over the 3 rows
                for p in permutations(cj):
                    j1, j2, j3 = p
                    i1, i2, i3 = ri
                    tot = (s[i1, j1] - s[i1, j2] + s[i2, j2] - s[i2, j3]
                           + s[i3, j3] - s[i3, j1]) % Z
                    cnt += int(tot == 0)
        return cnt

    # bounded search: prefer girth >= 6 (zero 4-cycles) with the fewest
    # 6-cycles; when Z is too small for any 4-cycle-free table (small toy
    # codes — a fresh difference set per row pair needs Z >= dc and gets
    # rapidly harder below Z ~ dc^2), fall back to the fewest-short-cycles
    # candidate instead of searching forever
    best, best_key = None, None
    tried = 0
    while tried < 400 or (best_key is not None and best_key[0] > 0
                          and tried < 20_000):
        s = rng.integers(0, Z, size=(dv, dc), dtype=np.int64)
        tried += 1
        c4 = four_cycle_count(s)
        key = (c4, six_cycle_count(s) if c4 == 0 else np.inf)
        if best_key is None or key < best_key:
            best, best_key = s, key
            if key == (0, 0):
                break
    return best.astype(np.int32)


def make_code(ldpc_cfg, n: int) -> LdpcCode:
    """Build the code an LdpcConfig describes (QC family, cached)."""
    if ldpc_cfg.family != "qc":
        raise NotImplementedError(
            f"LDPC family {ldpc_cfg.family!r} is not ported yet; the port "
            "builds the QC family")
    return make_qc_ldpc(n, ldpc_cfg.dv, ldpc_cfg.dc, ldpc_cfg.seed)


@functools.lru_cache(maxsize=None)
def make_qc_ldpc(n: int, dv: int = 4, dc: int = 8, seed: int = 0) -> LdpcCode:
    """Quasi-cyclic (dv, dc)-regular code: H is a dv x dc grid of Z x Z
    shifted identity circulants, Z = n/dc.

    Same ensemble profile as the Gallager draw (every variable degree dv,
    every check degree dc, rate (n-m)/n), but the bipartite graph is
    girth-conditioned (>= 6; random Gallager draws can carry 4-cycles) and
    BP message routing between the variable-major and check-major edge
    layouts is a static cyclic shift per base cell, which the CUDA decoder
    turns into per-thread edge indices (csrc/bp_decode.cu).

    Check (i, z') connects variable (j, z) iff z' == (z + shifts[i, j]) % Z.
    """
    assert n % dc == 0, (n, dc)
    Z = n // dc
    shifts = _qc_shift_table(dv, dc, Z, seed)

    # full lifted H in natural order: rows grouped by base row, (dv*Z, n)
    H_full = np.zeros((dv * Z, n), dtype=np.int8)
    z = np.arange(Z)
    for i in range(dv):
        for j in range(dc):
            H_full[i * Z + (z + shifts[i, j]) % Z, j * Z + z] = 1

    Hp, P, perm = _systematize(H_full)
    m = Hp.shape[0]
    ck_cols, var_edge = _index_tensors(Hp)
    ck_nat, var_nat = _index_tensors(H_full)
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[perm] = np.arange(n)
    qc = QcInfo(Z=Z, shifts=shifts, perm=perm.astype(np.int32),
                inv_perm=inv_perm.astype(np.int32),
                ck_cols_nat=ck_nat, var_edge_nat=var_nat)
    return LdpcCode(n=n, k=n - m, m=m, dv=dv, dc=dc, H=Hp, P=P,
                    ck_cols=ck_cols, var_edge=var_edge, qc=qc)
