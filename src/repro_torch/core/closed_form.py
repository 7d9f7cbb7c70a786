"""Closed-form worker counts and overhead formulas.

Transcriptions of:

* Theorem 2  — N_PolyDot-CMPC (psi_1..psi_6, region-wise)
* Theorem 8  — N_AGE-CMPC = min_lambda Gamma(lambda) (Upsilon_1..Upsilon_9)
* Theorem 1 of [15] — N_Entangled-CMPC (eq. 194)
* Theorem 1 of [16] — N_SSMM = (t+1)(ts+z) - 1
* Table 1 of [17]   — N_GCSA-NA = 2st^2 + 2z - 1 (one multiplication)
* Corollaries 10-12 — computation / storage / communication overheads

All functions take the paper's parameters: ``s`` row partitions, ``t``
column partitions, ``z`` colluding workers (and ``m`` for overheads).
The exact greedy constructions in ``constructions`` are the ground
truth; tests check these formulas against them over dense grids.

A copy of the JAX package's ``repro.core.closed_form`` (plain Python and numpy),
kept here so that the port imports nothing of that package.
"""
from __future__ import annotations

import math
from fractions import Fraction


# ----------------------------------------------------------------------
# Theorem 2: PolyDot-CMPC
# ----------------------------------------------------------------------
def _polydot_p(s: int, t: int, z: int) -> int:
    """p = min{floor((z-1)/(theta'-ts)), t-1}; theta' - ts = ts - t.

    For s = 1 the denominator vanishes and p = t - 1 by definition
    (Lemma 33); for t = 1, min(..., 0) = 0 (Lemma 32).
    """
    denom = t * s - t
    if denom <= 0:
        return t - 1 if t > 1 else 0
    return min((z - 1) // denom, t - 1)


def n_polydot(s: int, t: int, z: int) -> int:
    """Theorem 2."""
    if s == 1 and t == 1:
        raise ValueError("s = t = 1 excluded (BGW)")
    if z < 1:
        raise ValueError("z >= 1")
    thetap = t * (2 * s - 1)
    p = _polydot_p(s, t, z)
    psi1 = (p + 2) * t * s + thetap * (t - 1) + 2 * z - 1
    if t == 1:
        return psi1  # = 2s + 2z - 1
    if s == 1:
        return psi1 if z > t else t * t + 2 * t + t * z - 1  # Lemma 33
    if z > t * s:
        return psi1
    if t * s - t < z <= t * s:
        return 2 * t * s + thetap * (t - 1) + 3 * z - 1  # psi2
    if t * s - 2 * t < z <= t * s - t:
        return 2 * t * s + thetap * (t - 1) + 2 * z - 1  # psi3
    vprime = max(Fraction(t * s - 2 * t - s + 2), Fraction(t * s - 2 * t + 1, 2))
    if z > vprime:
        return (t + 1) * t * s + (t - 1) * (z + t - 1) + 2 * z - 1  # psi4
    return thetap * t + z  # psi5


# ----------------------------------------------------------------------
# Theorem 8: AGE-CMPC
# ----------------------------------------------------------------------
def age_gamma(s: int, t: int, z: int, lam: int) -> int:
    """Gamma(lambda) of eq. (31).  Requires t != 1."""
    if not (0 <= lam <= z):
        raise ValueError("0 <= lambda <= z")
    theta = t * s + lam
    if lam == 0:
        if z > t * s - s:
            return 2 * s * t * t + 2 * z - 1  # Upsilon_1
        return s * t * t + 3 * s * t - 2 * s + t * (z - 1) + 1  # Upsilon_2
    if lam == z:
        return 2 * t * s + (t * s + z) * (t - 1) + 2 * z - 1  # Upsilon_3
    q = min((z - 1) // lam, t - 1)
    if z > t * s:
        return (q + 2) * t * s + theta * (t - 1) + 2 * z - 1  # Upsilon_4
    if t * s < lam + s - 1:
        return 3 * t * s + theta * (t - 1) + 2 * z - 1  # Upsilon_5
    if lam + s - 1 < z:  # (and z <= ts)
        if q * lam >= s:
            return 2 * t * s + theta * (t - 1) + (q + 2) * z - q - 1  # Upsilon_6
        return (  # Upsilon_7
            theta * (t + q + 1)
            + q * (z - 1)
            - 2 * lam
            + z
            + t * s
            + min(0, z + s * (1 - t) - lam * q - 1)
        )
    # z <= lam + s - 1 <= ts
    if q * lam >= s:
        return (  # Upsilon_8
            2 * t * s + theta * (t - 1) + 3 * z + (lam + s - 1) * q - lam - s - 1
        )
    return (  # Upsilon_9
        theta * (t + 1)
        + q * (s - 1)
        - 3 * lam
        + 3 * z
        - 1
        + min(0, t * s - z + 1 + lam * q - s)
    )


def n_age(s: int, t: int, z: int) -> int:
    """Theorem 8: min over lambda in [0, z]."""
    if z < 1:
        raise ValueError("z >= 1")
    if t == 1:
        return 2 * s + 2 * z - 1
    return min(age_gamma(s, t, z, lam) for lam in range(0, z + 1))


def age_lambda_star(s: int, t: int, z: int) -> int:
    if t == 1:
        return 0
    return min(range(0, z + 1), key=lambda g: age_gamma(s, t, z, g))


# ----------------------------------------------------------------------
# baselines
# ----------------------------------------------------------------------
def n_entangled(s: int, t: int, z: int) -> int:
    """Theorem 1 of [15] (eq. 194)."""
    if z > t * s - s:
        return 2 * s * t * t + 2 * z - 1
    return s * t * t + 3 * s * t - 2 * s + t * z - t + 1


def n_ssmm(s: int, t: int, z: int) -> int:
    """Theorem 1 of [16]."""
    return (t + 1) * (t * s + z) - 1


def n_gcsa_na(s: int, t: int, z: int) -> int:
    """[17], one matrix multiplication (batch size 1)."""
    return 2 * s * t * t + 2 * z - 1


# ----------------------------------------------------------------------
# Exact worker counts (fast structured supports + indicator convolution)
# ----------------------------------------------------------------------
# The appendix closed forms above are transcriptions of the paper's
# Theorems 2/8.  Tests show they match the exact greedy constructions in
# most regions but overcount by small amounts in a few (Upsilon_5/7/9
# cells and PolyDot s=1 with z <= t, where the H-support has gaps the
# formulas do not discount).  Since eq. (23) *defines*
# N = |P(H(x))|, the exact counts below are authoritative; the
# transcribed formulas are kept for region-validated comparison.

import numpy as np


def n_from_supports(fa, fb) -> int:
    """|P(F_A) + P(F_B)| via indicator convolution (exact, O(D^2) bitops)."""
    fa = np.asarray(sorted(set(map(int, fa))), np.int64)
    fb = np.asarray(sorted(set(map(int, fb))), np.int64)
    ia = np.zeros(int(fa.max()) + 1, np.float64)
    ib = np.zeros(int(fb.max()) + 1, np.float64)
    ia[fa] = 1.0
    ib[fb] = 1.0
    conv = np.convolve(ia, ib)
    return int(np.count_nonzero(conv > 0.5))


def age_supports(s: int, t: int, z: int, lam: int):
    """Structured P(F_A), P(F_B) for AGE-CMPC (Theorem 7 / eqs. 28-29).

    S_A fills the lambda-length gaps [ts + theta*l, ts + theta*l + lam)
    for l = 0..t-2 and then runs past ts + theta*(t-1); S_B is z
    consecutive powers after the largest important power.  Validated
    against the greedy Algorithm 2 in tests.
    """
    theta = t * s + lam
    ca = list(range(0, t * s))  # {j + s*i}
    cb = [(s - 1 - k) + theta * l for k in range(s) for l in range(t)]
    max_imp = (s - 1) + s * (t - 1) + theta * (t - 1)
    sb = list(range(max_imp + 1, max_imp + 1 + z))
    sa = []
    if t == 1:
        sa = list(range(s, s + z))
    else:
        for l in range(t - 1):
            if len(sa) >= z:
                break
            lo = t * s + theta * l
            take = min(lam, z - len(sa))
            sa.extend(range(lo, lo + take))
        if len(sa) < z:
            lo = t * s + theta * (t - 1)
            sa.extend(range(lo, lo + z - len(sa)))
    return sorted(set(ca) | set(sa)), sorted(set(cb) | set(sb))


def n_age_exact_fixed(s: int, t: int, z: int, lam: int) -> int:
    fa, fb = age_supports(s, t, z, lam)
    return n_from_supports(fa, fb)


def n_age_exact(s: int, t: int, z: int):
    """Exact N_AGE-CMPC = min_lambda |P(H)| with the Algorithm-2 layout.

    Returns (n, lambda*).
    """
    if t == 1:
        return 2 * s + 2 * z - 1, 0
    best, best_lam = None, 0
    for lam in range(0, z + 1):
        n = n_age_exact_fixed(s, t, z, lam)
        if best is None or n < best:
            best, best_lam = n, lam
    return best, best_lam


N_FORMULAS = {
    "age": n_age,
    "polydot": n_polydot,
    "entangled": n_entangled,
    "ssmm": n_ssmm,
    "gcsa-na": n_gcsa_na,
}


def n_workers(method: str, s: int, t: int, z: int) -> int:
    return N_FORMULAS[method.lower()](s, t, z)


# ----------------------------------------------------------------------
# Corollaries 10-12: per-worker overheads (scalar counts)
# ----------------------------------------------------------------------
def computation_overhead(m: int, s: int, t: int, z: int, n: int) -> int:
    """Corollary 10: scalar multiplications per worker (eq. 32)."""
    return m**3 // (s * t * t) + m * m + n * (t * t + z - 1) * (m * m // (t * t))


def storage_overhead(m: int, s: int, t: int, z: int, n: int) -> int:
    """Corollary 11: scalars stored per worker (eq. 33)."""
    return (2 * n + z + 1) * (m * m // (t * t)) + 2 * m * m // (s * t) + t * t


def communication_overhead(m: int, t: int, n: int) -> int:
    """Corollary 12: scalars exchanged among workers in Phase 2 (eq. 34)."""
    return n * (n - 1) * (m * m // (t * t))


# ----------------------------------------------------------------------
# unified cost model: the closed-form prior behind plan selection
# ----------------------------------------------------------------------
import dataclasses as _dataclasses


@_dataclasses.dataclass(frozen=True)
class CostPrediction:
    """Closed-form resource prediction for one ``PlanConfig`` at size m.

    ``n_workers`` is the *exact* worker count (registry fast paths, not
    the occasionally-overcounting transcribed formulas); the per-worker
    overheads are Corollaries 10-12 evaluated at that count.  This is
    the data-independent prior an auto-planner scores candidates with
    before it has seen a single measured run.
    """

    n_workers: int
    n_total: int  # provisioned = workers + spares
    decode_threshold: int
    compute: int  # scalar mults per worker (Corollary 10)
    storage: int  # scalars stored per worker (Corollary 11)
    comm: int  # scalars exchanged among workers, Phase 2 (Corollary 12)
    # Adversarial accounting: with up to ``n_errors`` Byzantine workers
    # a Berlekamp-Welch decode needs ``decode_threshold + 2e`` responses
    # (Reed-Solomon distance), so the construction must provision
    # ``N + 2e`` workers to keep its straggler margin.  ``n_errors=0``
    # reproduces the fault-free prediction exactly.
    n_errors: int = 0

    @property
    def n_adversarial(self) -> int:
        """Workers needed with ``n_errors`` Byzantine among them: N + 2e."""
        return self.n_workers + 2 * self.n_errors

    @property
    def decode_responses(self) -> int:
        """Responses a correcting decode waits for: ``thr + 2e``."""
        return self.decode_threshold + 2 * self.n_errors

    def compute_factor(self, reference: "CostPrediction") -> float:
        """Per-worker compute relative to another prediction — the
        scale heterogeneous-compute scenarios multiply worker compute
        delays by when replaying one pool under several constructions."""
        return self.compute / max(reference.compute, 1)


def predict(config, m: int, pool_size: int = None, e: int = 0) -> CostPrediction:
    """Unified cost-model entry: ``PlanConfig``-shaped config -> costs.

    ``config`` needs attributes ``method, s, t, z, lam, n_spare``
    (a :class:`~repro_torch.core.constructions.PlanConfig`).  ``m`` is the
    square-matrix dimension of the Corollary 10-12 overheads.  With
    ``pool_size`` the spare count is re-accounted against that physical
    pool (``n_total = pool_size``) instead of ``config.n_spare`` —
    the elastic-pool form planners use.

    ``e`` is the Byzantine error budget: a correcting decode needs
    ``decode_threshold + 2e`` responses, so the adversarial worker
    count is ``N + 2e`` (``CostPrediction.n_adversarial``) — what the
    auto-planner prices error correction against confirm-and-retry
    with.  A pool too small to seat ``N + 2e`` raises, mirroring the
    fault-free seating check.
    """
    from .constructions import get_construction  # deferred: cycle-free

    ctor = get_construction(config.method)
    n = ctor.n_workers(config.s, config.t, config.z, config.lam)
    e = int(e)
    if e < 0:
        raise ValueError("error budget e must be >= 0")
    n_adv = n + 2 * e
    if pool_size is not None:
        if pool_size < n_adv:
            raise ValueError(
                f"pool of {pool_size} cannot seat {config.method} "
                f"(needs {n} workers + 2e = {n_adv} under e={e} errors)"
            )
        n_total = pool_size
    else:
        n_total = n_adv + config.n_spare
    s, t, z = config.s, config.t, config.z
    return CostPrediction(
        n_workers=n,
        n_total=n_total,
        decode_threshold=t * t + z,
        compute=computation_overhead(m, s, t, z, n),
        storage=storage_overhead(m, s, t, z, n),
        comm=communication_overhead(m, t, n),
        n_errors=e,
    )
