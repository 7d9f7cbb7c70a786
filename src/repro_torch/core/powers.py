"""Power-set machinery for polynomial coded computation / coded MPC.

The paper's whole analysis lives in the combinatorics of *sets of
polynomial powers*:  a share polynomial ``F(x) = C(x) + S(x)`` has a
coded-term support ``P(C)`` and a secret-term support ``P(S)``; the
required number of workers equals ``|P(F_A) + P(F_B)|`` (Minkowski-sum
cardinality, eq. (23)); decodability requires the *important powers*
(the exponents that carry ``Y = A^T B`` blocks) to stay collision-free
from every *garbage* sumset (conditions C1-C3 / C4-C6).

Everything here is exact integer-set arithmetic (numpy-accelerated).
The greedy secret-power selection below is the algorithmic form of the
paper's Algorithm 1 (PolyDot-CMPC) and Algorithm 2 (AGE-CMPC); the
closed-form Theorems 2 and 8 are validated against it in the tests.

A copy of the JAX package's ``repro.core.powers`` (plain Python and numpy),
kept here so that the port imports nothing of that package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

BlockMap = Dict[Tuple[int, int], int]  # (block indices) -> polynomial power


# ----------------------------------------------------------------------
# sumset helpers
# ----------------------------------------------------------------------
def sumset(a, b) -> np.ndarray:
    """Sorted unique Minkowski sum A + B."""
    a = np.asarray(sorted(set(int(x) for x in a)), dtype=np.int64)
    b = np.asarray(sorted(set(int(x) for x in b)), dtype=np.int64)
    if a.size == 0 or b.size == 0:
        return np.zeros((0,), np.int64)
    return np.unique(a[:, None] + b[None, :])


def diffset(a, b) -> np.ndarray:
    """Sorted unique {x - y : x in A, y in B} intersected with naturals."""
    a = np.asarray(sorted(set(int(x) for x in a)), dtype=np.int64)
    b = np.asarray(sorted(set(int(x) for x in b)), dtype=np.int64)
    if a.size == 0 or b.size == 0:
        return np.zeros((0,), np.int64)
    d = np.unique(a[:, None] - b[None, :])
    return d[d >= 0]


def greedy_powers(z: int, forbidden: np.ndarray, start: int = 0) -> List[int]:
    """Pick the z smallest naturals >= start avoiding ``forbidden``.

    This is the generic greedy step of Algorithms 1 and 2: both pick
    secret powers "starting from the minimum possible element" subject
    to the non-collision conditions.
    """
    bad = set(int(x) for x in forbidden)
    out: List[int] = []
    x = start
    while len(out) < z:
        if x not in bad:
            out.append(x)
        x += 1
    return out


# ----------------------------------------------------------------------
# coded-term supports
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CodedSupport:
    """Support of the coded terms C_A, C_B and the important powers of
    C_A*C_B that carry the blocks of Y = A^T B."""

    s: int
    t: int
    # (i, j) -> power of A_{i,j} in C_A;  i in [t], j in [s]
    a_powers: Tuple[Tuple[int, int, int], ...]
    # (k, l) -> power of B_{k,l} in C_B;  k in [s], l in [t]
    b_powers: Tuple[Tuple[int, int, int], ...]
    # (i, l) -> important power carrying Y_{i,l}
    important: Tuple[Tuple[int, int, int], ...]

    @property
    def pa(self) -> List[int]:
        return [u for (_, _, u) in self.a_powers]

    @property
    def pb(self) -> List[int]:
        return [u for (_, _, u) in self.b_powers]

    @property
    def imp(self) -> List[int]:
        return [u for (_, _, u) in self.important]

    def a_power_map(self) -> BlockMap:
        return {(i, j): u for (i, j, u) in self.a_powers}

    def b_power_map(self) -> BlockMap:
        return {(k, l): u for (k, l, u) in self.b_powers}

    def important_map(self) -> BlockMap:
        return {(i, l): u for (i, l, u) in self.important}


def generalized_coded(s: int, t: int, alpha: int, beta: int, theta: int) -> CodedSupport:
    """Generalized polynomial-code family, eq. (24):

      C_A(x) = sum_{i,j} A_{i,j} x^{j*alpha + i*beta}
      C_B(x) = sum_{k,l} B_{k,l} x^{(s-1-k)*alpha + theta*l}

    PolyDot  = (alpha, beta, theta) = (t, 1, t(2s-1))   [note swapped roles below]
    Entangled/GPD = (1, s, ts)
    AGE      = (1, s, ts + lambda)
    """
    a_powers = tuple(
        (i, j, j * alpha + i * beta) for i in range(t) for j in range(s)
    )
    b_powers = tuple(
        (k, l, (s - 1 - k) * alpha + theta * l) for k in range(s) for l in range(t)
    )
    important = tuple(
        (i, l, (s - 1) * alpha + i * beta + theta * l) for i in range(t) for l in range(t)
    )
    return CodedSupport(s=s, t=t, a_powers=a_powers, b_powers=b_powers, important=important)


def polydot_coded(s: int, t: int) -> CodedSupport:
    """PolyDot codes [26], eqs. (7)-(8):

      P(C_A) = { i + t*j },  P(C_B) = { t(s-1-k) + theta'*l },
      theta' = t(2s-1); important powers { i + t(s-1) + t*l*(2s-1) }.
    """
    thetap = t * (2 * s - 1)
    a_powers = tuple((i, j, i + t * j) for i in range(t) for j in range(s))
    b_powers = tuple(
        (k, l, t * (s - 1 - k) + thetap * l) for k in range(s) for l in range(t)
    )
    important = tuple(
        (i, l, i + t * (s - 1) + thetap * l) for i in range(t) for l in range(t)
    )
    return CodedSupport(s=s, t=t, a_powers=a_powers, b_powers=b_powers, important=important)


def age_coded(s: int, t: int, lam: int) -> CodedSupport:
    """AGE codes: (alpha, beta, theta) = (1, s, ts + lambda), eq. (25)-(26)."""
    return generalized_coded(s, t, alpha=1, beta=s, theta=t * s + lam)


def entangled_coded(s: int, t: int) -> CodedSupport:
    """Entangled polynomial codes [22] == AGE with lambda = 0."""
    return age_coded(s, t, 0)


# ----------------------------------------------------------------------
# decodability checks (Theorem 6 invariants)
# ----------------------------------------------------------------------
def important_powers_distinct(c: CodedSupport) -> bool:
    imp = c.imp
    return len(set(imp)) == len(imp)


def coded_garbage_disjoint(c: CodedSupport) -> bool:
    """Important powers receive only j == k cross terms with matching (i, l)."""
    imp = set(c.imp)
    amap = c.a_power_map()
    bmap = c.b_power_map()
    impmap = {u: (i, l) for (i, l, u) in c.important}
    for (i, j), ua in amap.items():
        for (k, l), ub in bmap.items():
            u = ua + ub
            if u in imp:
                if j != k:
                    return False
                if impmap[u] != (i, l):
                    return False
    return True


def secret_conditions_hold(c: CodedSupport, sa: List[int], sb: List[int]) -> bool:
    """C1-C3 (PolyDot) / C4-C6 (AGE): no garbage sumset hits an important power."""
    imp = set(c.imp)
    for d in (sumset(sa, c.pb), sumset(sb, c.pa), sumset(sa, sb)):
        if imp & set(int(x) for x in d):
            return False
    return True


def h_support(c: CodedSupport, sa: List[int], sb: List[int]) -> np.ndarray:
    """Support of H(x) = (C_A + S_A)(C_B + S_B); |support| == N workers."""
    fa = sorted(set(c.pa) | set(sa))
    fb = sorted(set(c.pb) | set(sb))
    return sumset(fa, fb)
