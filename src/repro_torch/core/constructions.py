"""Executable CMPC share-polynomial constructions.

Implements the *algorithmic* form of the paper's constructions:

* ``polydot_cmpc``  — Algorithm 1: PolyDot coded terms (eq. 7-8) plus
  greedy secret powers satisfying C1-C3 (eq. 9).
* ``age_cmpc``      — Algorithm 2: AGE coded terms (eq. 25-26) with gap
  parameter ``lambda``, S_B = z consecutive powers past the largest
  important power (eq. 29), S_A greedy under C5 (eq. 28), and the
  adaptive ``lambda*`` search of Algorithm 3 / Theorem 8.
* ``entangled_cmpc`` — the [15] baseline (lambda = 0 coded terms with
  the secret-term layout implied by Theorem 1 of [15]); used for
  worker-count comparisons and protocol cross-checks.

The greedy selections are provably identical to the closed forms of
Theorems 1/7 (the theorems enumerate exactly the greedy-feasible sets);
tests cross-validate ``n_workers`` against ``closed_form`` over grids.

A copy of the JAX package's ``repro.core.constructions`` (plain Python and numpy),
kept here so that the port imports nothing of that package.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from . import closed_form as cf
from .powers import (
    CodedSupport,
    age_coded,
    diffset,
    greedy_powers,
    h_support,
    polydot_coded,
    secret_conditions_hold,
    sumset,
)


@dataclasses.dataclass(frozen=True)
class Scheme:
    """A fully-specified CMPC share construction."""

    method: str
    s: int
    t: int
    z: int
    lam: Optional[int]  # AGE gap parameter (None for PolyDot)
    coded: CodedSupport
    sa: Tuple[int, ...]  # secret powers of F_A
    sb: Tuple[int, ...]  # secret powers of F_B
    h_powers: Tuple[int, ...]  # support of H(x) (sorted)

    @property
    def n_workers(self) -> int:
        return len(self.h_powers)

    @property
    def fa_powers(self) -> List[int]:
        return sorted(set(self.coded.pa) | set(self.sa))

    @property
    def fb_powers(self) -> List[int]:
        return sorted(set(self.coded.pb) | set(self.sb))

    @property
    def decode_threshold(self) -> int:
        """Workers needed by the master in Phase 3: deg I(x) + 1 = t^2 + z."""
        return self.t * self.t + self.z

    def validate(self) -> None:
        if len(self.sa) != self.z or len(self.sb) != self.z:
            raise ValueError("secret supports must have exactly z powers")
        if not secret_conditions_hold(self.coded, list(self.sa), list(self.sb)):
            raise ValueError("secret powers collide with important powers")


def _build(method: str, s: int, t: int, z: int, lam, coded, sa, sb) -> Scheme:
    scheme = Scheme(
        method=method,
        s=s,
        t=t,
        z=z,
        lam=lam,
        coded=coded,
        sa=tuple(int(x) for x in sa),
        sb=tuple(int(x) for x in sb),
        h_powers=tuple(int(x) for x in h_support(coded, sa, sb)),
    )
    scheme.validate()
    return scheme


# ----------------------------------------------------------------------
# PolyDot-CMPC (Algorithm 1)
# ----------------------------------------------------------------------
def polydot_cmpc(s: int, t: int, z: int) -> Scheme:
    if s == 1 and t == 1:
        raise ValueError("s = t = 1 is plain BGW; PolyDot-CMPC excludes it")
    if z < 1:
        raise ValueError("z >= 1 colluding workers required")
    coded = polydot_coded(s, t)
    # Step 1 (C1): S_A avoids Imp - P(C_B).
    sa = greedy_powers(z, diffset(coded.imp, coded.pb))
    # Step 2 (C2 + C3): S_B avoids (Imp - S_A) and (Imp - P(C_A)).
    bad_b = np.union1d(diffset(coded.imp, sa), diffset(coded.imp, coded.pa))
    sb = greedy_powers(z, bad_b)
    return _build("polydot", s, t, z, None, coded, sa, sb)


# ----------------------------------------------------------------------
# AGE-CMPC (Algorithm 2 + the lambda* search of Algorithm 3)
# ----------------------------------------------------------------------
def age_cmpc_fixed(s: int, t: int, z: int, lam: int) -> Scheme:
    if z < 1:
        raise ValueError("z >= 1 colluding workers required")
    if not (0 <= lam <= z):
        raise ValueError("0 <= lambda <= z required (Appendix H)")
    coded = age_coded(s, t, lam)
    # Step 1: S_B = z consecutive powers from max important power + 1.
    start = max(coded.imp) + 1
    sb = list(range(start, start + z))
    # Step 2 (C5): S_A avoids Imp - P(C_B).  C4/C6 hold by construction.
    sa = greedy_powers(z, diffset(coded.imp, coded.pb))
    return _build("age", s, t, z, lam, coded, sa, sb)


def age_cmpc(
    s: int, t: int, z: int, lam: Optional[int] = None, exact_search: bool = True
) -> Scheme:
    """AGE-CMPC with the adaptive-gap selection.

    ``exact_search=True`` minimises the *exact* worker count over
    ``lambda in [0, z]`` (this can only improve on Theorem 8's closed
    form and matches it in our validation grids for ``0 < lambda``).
    The minimisation runs on ``closed_form.n_age_exact`` — indicator
    convolutions over the structured Theorem-7 supports, O(D^2) bitops
    per lambda — so only the *winning* gap's greedy ``Scheme`` is ever
    constructed (the structured supports provably equal the greedy
    Algorithm-2 output; tests cross-check the selected scheme against
    the exhaustive build-them-all search over the validation grid).
    ``exact_search=False`` picks ``lambda*`` by Theorem 8's formulas
    (paper-faithful).
    """
    if lam is not None:
        return age_cmpc_fixed(s, t, z, lam)
    if t == 1:
        return age_cmpc_fixed(s, t, z, min(z, 0))
    if exact_search:
        _, lam_star = cf.n_age_exact(s, t, z)
        return age_cmpc_fixed(s, t, z, lam_star)
    lam_star = min(range(0, z + 1), key=lambda g: cf.age_gamma(s, t, z, g))
    return age_cmpc_fixed(s, t, z, lam_star)


# ----------------------------------------------------------------------
# Entangled-CMPC baseline [15]
# ----------------------------------------------------------------------
# Entangled-CMPC, SSMM and GCSA-NA are *worker-count / overhead*
# baselines, exactly as in the paper (Lemmas 3-5, 9 compare against the
# published formulas of [15]-[17], not re-derived constructions).  Their
# N formulas live in ``closed_form``.  Note a small beyond-paper
# observation validated in tests: running Algorithm 2's greedy secret
# selection on the lambda = 0 (entangled) coded terms yields N *below*
# [15]'s N_Entangled in some cells (e.g. s=t=z=2: 18 vs 19), i.e. the
# adaptive-gap machinery already improves the entangled layout itself.
# ``age_cmpc_fixed(s, t, z, 0)`` is that executable variant.


# ----------------------------------------------------------------------
# construction registry
# ----------------------------------------------------------------------
# One entry per construction family, carrying *capabilities* (does it
# take a gap parameter? does it self-tune lambda?) and a cheap exact
# worker-count oracle so planners can rank candidates without building
# schemes.  ``build_scheme`` stays as the thin string entry point, now
# dispatching through the registry; harnesses that iterate methods or
# auto-plan should consume ``Construction`` records instead of
# hard-coding name lists.


@dataclasses.dataclass(frozen=True)
class Construction:
    """Registry record for one CMPC construction family.

    ``build(s, t, z, lam)`` returns the executable :class:`Scheme`;
    ``n_workers(s, t, z, lam)`` is the *exact* worker count of that
    scheme without constructing it (closed-form / support-convolution
    fast paths), the quantity auto-planners rank candidates by.
    """

    name: str
    build: Callable[[int, int, int, Optional[int]], Scheme]
    n_workers: Callable[[int, int, int, Optional[int]], int]
    supports_lam: bool  # accepts an explicit gap parameter
    adaptive_gap: bool  # self-tunes lambda* when lam is None
    description: str = ""
    aliases: Tuple[str, ...] = ()


_REGISTRY: Dict[str, Construction] = {}
_ALIASES: Dict[str, str] = {}


def register_construction(ctor: Construction) -> Construction:
    """Add a construction family to the registry (idempotent per name)."""
    key = ctor.name.lower()
    _REGISTRY[key] = ctor
    for alias in ctor.aliases:
        _ALIASES[alias.lower()] = key
    return ctor


def get_construction(method: str) -> Construction:
    key = method.lower()
    key = _ALIASES.get(key, key)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"unknown CMPC method: {method} (known: {known_methods()})"
        ) from None


def known_methods() -> Tuple[str, ...]:
    """Canonical registered method names (one per family)."""
    return tuple(_REGISTRY)


def _n_polydot_exact(s: int, t: int, z: int, lam: Optional[int]) -> int:
    # Theorem 2 overcounts a few gapped s=1 cells; the (cached) greedy
    # construction is the exact oracle.
    return _cached_scheme("polydot", s, t, z, None).n_workers


def _n_age_exact(s: int, t: int, z: int, lam: Optional[int]) -> int:
    if lam is None:
        return cf.n_age_exact(s, t, z)[0]
    if t == 1:
        return 2 * s + 2 * z - 1
    return cf.n_age_exact_fixed(s, t, z, lam)


register_construction(Construction(
    name="polydot",
    build=lambda s, t, z, lam=None: polydot_cmpc(s, t, z),
    n_workers=_n_polydot_exact,
    supports_lam=False,
    adaptive_gap=False,
    description="PolyDot-CMPC (Algorithm 1, Theorem 2)",
    aliases=("polydot-cmpc",),
))
register_construction(Construction(
    name="age",
    build=lambda s, t, z, lam=None: age_cmpc(s, t, z, lam=lam),
    n_workers=_n_age_exact,
    supports_lam=True,
    adaptive_gap=True,
    description="AGE-CMPC with the exact adaptive-gap search (Algorithm 3)",
    aliases=("age-cmpc",),
))
register_construction(Construction(
    name="age-paper",
    build=lambda s, t, z, lam=None: age_cmpc(s, t, z, lam=lam, exact_search=False),
    n_workers=lambda s, t, z, lam=None: _n_age_exact(
        s, t, z, lam if lam is not None else cf.age_lambda_star(s, t, z)
    ),
    supports_lam=True,
    adaptive_gap=True,
    description="AGE-CMPC with Theorem 8's closed-form lambda* (paper-faithful)",
))
register_construction(Construction(
    name="entangled-greedy",
    build=lambda s, t, z, lam=None: age_cmpc_fixed(s, t, z, 0),
    n_workers=lambda s, t, z, lam=None: _n_age_exact(s, t, z, 0),
    supports_lam=False,
    adaptive_gap=False,
    description="lambda = 0 coded terms with Algorithm 2's greedy secrets "
    "(improves on [15]'s published N in some cells)",
))

# Back-compat iterable surface (now derived from the registry).
KNOWN_METHODS = known_methods()

# Schemes are pure functions of (method, s, t, z, lam) but the greedy
# builders cost combinatorial Python; planners re-resolve the same
# candidates every replay, so resolution is memoized process-wide.
_SCHEME_CACHE: Dict[Tuple, Scheme] = {}
_SCHEME_CACHE_MAX = 1024


def _cached_scheme(method: str, s: int, t: int, z: int, lam: Optional[int]) -> Scheme:
    key = (method, s, t, z, lam)
    sch = _SCHEME_CACHE.get(key)
    if sch is None:
        sch = get_construction(method).build(s, t, z, lam)
        _SCHEME_CACHE[key] = sch
        while len(_SCHEME_CACHE) > _SCHEME_CACHE_MAX:
            _SCHEME_CACHE.pop(next(iter(_SCHEME_CACHE)))
    return sch


def build_scheme(method: str, s: int, t: int, z: int, lam: Optional[int] = None) -> Scheme:
    """Resolve a method name to its (memoized) executable ``Scheme``."""
    ctor = get_construction(method)
    if lam is not None and not ctor.supports_lam:
        if lam != (0 if ctor.name == "entangled-greedy" else None):
            raise ValueError(f"construction {ctor.name!r} takes no gap parameter")
    return _cached_scheme(ctor.name, s, t, z, lam)


# ----------------------------------------------------------------------
# PlanConfig: the declarative selection surface
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Everything selectable about one protocol deployment.

    The single value object threaded from construction choice to
    runtime: which family (``method``), the partition/privacy point
    ``(s, t, z)``, the AGE gap (``lam``, ``None`` = adaptive), how many
    spare evaluation points to provision (``n_spare``), and how many
    decode confirmations the master demands (``verify_extras``,
    ``"auto"`` = one exactly when corruption is possible).  Hashable
    and immutable, so it keys plan caches and auto-planner score
    tables directly.
    """

    method: str = "age"
    s: int = 2
    t: int = 2
    z: int = 1
    lam: Optional[int] = None
    n_spare: int = 0
    verify_extras: Union[int, str] = "auto"

    def __post_init__(self):
        get_construction(self.method)  # fail fast on unknown families
        if self.z < 1:
            raise ValueError("z >= 1 colluding workers required")
        if self.n_spare < 0:
            raise ValueError("n_spare must be >= 0")
        if self.verify_extras != "auto" and int(self.verify_extras) < 0:
            raise ValueError('verify_extras must be >= 0 or "auto"')

    def scheme(self) -> Scheme:
        """The (memoized) executable construction this config selects."""
        return build_scheme(self.method, self.s, self.t, self.z, lam=self.lam)

    @property
    def n_workers(self) -> int:
        """Exact worker count, without building the scheme."""
        ctor = get_construction(self.method)
        return ctor.n_workers(self.s, self.t, self.z, self.lam)

    @property
    def n_total(self) -> int:
        return self.n_workers + self.n_spare

    @property
    def decode_threshold(self) -> int:
        return self.t * self.t + self.z

    def replace(self, **kw) -> "PlanConfig":
        return dataclasses.replace(self, **kw)

    def resolved(self) -> "PlanConfig":
        """Pin the adaptive gap to the lambda the scheme actually uses,
        so configs that resolve to the same construction compare equal
        (the canonical form plan caches key on)."""
        lam = self.scheme().lam
        return self if lam == self.lam else self.replace(lam=lam)

    def fit_to_pool(self, pool_size: int) -> "PlanConfig":
        """Re-account spares against a physical pool of ``pool_size``
        workers: ``n_spare = pool_size - n_workers``.  Raises when the
        pool cannot even seat the primary workers — the elastic-pool
        feasibility check planners run before proposing a config."""
        spare = pool_size - self.n_workers
        if spare < 0:
            raise ValueError(
                f"pool of {pool_size} cannot seat {self.method}"
                f"(s={self.s}, t={self.t}, z={self.z}): needs "
                f"{self.n_workers} workers"
            )
        return self.replace(n_spare=spare)

    def label(self) -> str:
        lam = "" if self.lam is None else f",lam={self.lam}"
        return f"{self.method}(s={self.s},t={self.t},z={self.z}{lam})"
