"""Suggestion algorithms; a copy of ``kubeflow_tpu/tuning/suggestions.py``
(numpy only), kept in this package so the port imports nothing of the JAX
one: the same seed and observations give the same proposals.

Parity with katib's four services
(kubeflow/katib/suggestion.libsonnet:3-10): random, grid, hyperband,
bayesianoptimization. Pure numpy; each algorithm sees completed trials
(assignments + objective) and proposes the next assignments.

Objective convention: algorithms always *maximize*; the controller negates
minimize objectives before feeding observations back.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import numpy as np


@dataclass
class Observation:
    assignments: dict[str, object]
    objective: float


@dataclass
class ParamDomain:
    name: str
    type: str  # double | int | categorical | discrete
    space: dict

    def sample(self, rng: np.random.Generator):
        if self.type == "double":
            lo, hi = float(self.space["min"]), float(self.space["max"])
            if self.space.get("logScale"):
                return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
            return float(rng.uniform(lo, hi))
        if self.type == "int":
            return int(rng.integers(int(self.space["min"]),
                                    int(self.space["max"]) + 1))
        return self.space["list"][rng.integers(len(self.space["list"]))]

    def grid(self, resolution: int):
        if self.type == "double":
            lo, hi = float(self.space["min"]), float(self.space["max"])
            if self.space.get("logScale"):
                return np.exp(
                    np.linspace(np.log(lo), np.log(hi), resolution)
                ).tolist()
            return np.linspace(lo, hi, resolution).tolist()
        if self.type == "int":
            lo, hi = int(self.space["min"]), int(self.space["max"])
            n = min(resolution, hi - lo + 1)
            return sorted({int(round(v)) for v in np.linspace(lo, hi, n)})
        return list(self.space["list"])

    def to_unit(self, value) -> float:
        """Map to [0,1] for the GP."""
        if self.type == "double":
            lo, hi = float(self.space["min"]), float(self.space["max"])
            if self.space.get("logScale"):
                return (math.log(value) - math.log(lo)) / (
                    math.log(hi) - math.log(lo) + 1e-12
                )
            return (value - lo) / (hi - lo + 1e-12)
        if self.type == "int":
            lo, hi = int(self.space["min"]), int(self.space["max"])
            return (value - lo) / max(hi - lo, 1)
        choices = self.space["list"]
        return choices.index(value) / max(len(choices) - 1, 1)

    def from_unit(self, u: float):
        u = float(np.clip(u, 0.0, 1.0))
        if self.type == "double":
            lo, hi = float(self.space["min"]), float(self.space["max"])
            if self.space.get("logScale"):
                return float(
                    math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
                )
            return lo + u * (hi - lo)
        if self.type == "int":
            lo, hi = int(self.space["min"]), int(self.space["max"])
            return int(round(lo + u * (hi - lo)))
        choices = self.space["list"]
        return choices[int(round(u * (len(choices) - 1)))]


def domains_from_spec(parameters: list[dict]) -> list[ParamDomain]:
    return [
        ParamDomain(p["name"], p["parameterType"], p.get("feasibleSpace", {}))
        for p in parameters
    ]


class Suggestion:
    def __init__(self, domains: list[ParamDomain], seed: int = 0):
        self.domains = domains
        self.rng = np.random.default_rng(seed)

    def next(self, observations: list[Observation]) -> dict | None:
        """Next assignments, or None when the space is exhausted."""
        raise NotImplementedError


class RandomSuggestion(Suggestion):
    def next(self, observations):
        return {d.name: d.sample(self.rng) for d in self.domains}


class GridSuggestion(Suggestion):
    def __init__(self, domains, seed=0, resolution: int = 4):
        super().__init__(domains, seed)
        self._grid = list(
            itertools.product(*(d.grid(resolution) for d in domains))
        )

    def next(self, observations):
        tried = {tuple(o.assignments[d.name] for d in self.domains)
                 for o in observations}
        for point in self._grid:
            if point not in tried:
                return dict(zip((d.name for d in self.domains), point))
        return None


class HyperbandSuggestion(Suggestion):
    """Successive-halving: random configs at a small budget, survivors
    promoted with more budget. Budget is surfaced as the reserved parameter
    ``trainingSteps`` the trial template may interpolate."""

    def __init__(self, domains, seed=0, min_budget: int = 10,
                 max_budget: int = 100, eta: int = 3):
        super().__init__(domains, seed)
        self.min_budget = min_budget
        self.max_budget = max_budget
        self.eta = eta

    def next(self, observations):
        # Group observations by budget rung.
        rungs: dict[int, list[Observation]] = {}
        for o in observations:
            rungs.setdefault(
                int(o.assignments.get("trainingSteps", self.min_budget)), []
            ).append(o)
        budget = self.min_budget
        while budget <= self.max_budget:
            at_rung = rungs.get(budget, [])
            # Rung capacity shrinks by eta as budget grows by eta.
            capacity = max(
                1,
                int(self.max_budget / budget / self.eta),
            )
            if len(at_rung) < capacity:
                # Promote the best not-yet-promoted config from the rung
                # below, else sample fresh at the base rung.
                if budget > self.min_budget:
                    below = sorted(
                        rungs.get(budget // self.eta, []),
                        key=lambda o: -o.objective,
                    )
                    promoted_here = {
                        tuple(sorted(
                            (k, v) for k, v in o.assignments.items()
                            if k != "trainingSteps"
                        ))
                        for o in at_rung
                    }
                    for cand in below:
                        key = tuple(sorted(
                            (k, v) for k, v in cand.assignments.items()
                            if k != "trainingSteps"
                        ))
                        if key not in promoted_here:
                            out = dict(cand.assignments)
                            out["trainingSteps"] = budget
                            return out
                if budget == self.min_budget:
                    out = {d.name: d.sample(self.rng) for d in self.domains}
                    out["trainingSteps"] = budget
                    return out
            budget *= self.eta
        # All rungs full: fresh random at base budget.
        out = {d.name: d.sample(self.rng) for d in self.domains}
        out["trainingSteps"] = self.min_budget
        return out


class BayesianSuggestion(Suggestion):
    """GP (RBF kernel) + expected improvement over the unit hypercube."""

    n_init = 3
    n_candidates = 256

    def next(self, observations):
        if len(observations) < self.n_init:
            return {d.name: d.sample(self.rng) for d in self.domains}
        x = np.array([
            [d.to_unit(o.assignments[d.name]) for d in self.domains]
            for o in observations
        ])
        y = np.array([o.objective for o in observations], np.float64)
        y_mean, y_std = y.mean(), y.std() + 1e-9
        yn = (y - y_mean) / y_std

        ls, noise = 0.3, 1e-6
        def kern(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / ls**2)

        k_xx = kern(x, x) + noise * np.eye(len(x))
        chol = np.linalg.cholesky(k_xx)
        alpha = np.linalg.solve(chol.T, np.linalg.solve(chol, yn))

        cand = self.rng.uniform(size=(self.n_candidates, len(self.domains)))
        k_sx = kern(cand, x)
        mu = k_sx @ alpha
        v = np.linalg.solve(chol, k_sx.T)
        var = np.clip(1.0 - (v**2).sum(0), 1e-12, None)
        sigma = np.sqrt(var)

        best = yn.max()
        z = (mu - best) / sigma
        ei = sigma * (z * _ncdf(z) + _npdf(z))
        u = cand[int(np.argmax(ei))]
        return {
            d.name: d.from_unit(u[i]) for i, d in enumerate(self.domains)
        }


def _ncdf(z):
    return 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))


def _npdf(z):
    return np.exp(-0.5 * z**2) / math.sqrt(2 * math.pi)


class TpeSuggestion(Suggestion):
    """Tree-structured Parzen estimator over the unit hypercube.

    Observations are split at the ``gamma`` quantile into good/bad sets;
    each set is modelled as a per-dimension Gaussian mixture (one kernel
    per observation, fixed bandwidth). Candidates are drawn from the good
    mixture and ranked by the density ratio l(x)/g(x) — cheaper than the
    GP (no Cholesky) and robust to non-smooth objectives.
    """

    n_init = 3
    n_candidates = 64
    gamma = 0.25
    bandwidth = 0.15

    def next(self, observations):
        if len(observations) < self.n_init:
            return {d.name: d.sample(self.rng) for d in self.domains}
        x = np.array([
            [d.to_unit(o.assignments[d.name]) for d in self.domains]
            for o in observations
        ])
        y = np.array([o.objective for o in observations], np.float64)
        n_good = max(1, int(math.ceil(self.gamma * len(y))))
        order = np.argsort(-y)
        good, bad = x[order[:n_good]], x[order[n_good:]]
        if not len(bad):
            bad = x

        def mix_logpdf(pts, centers):
            # Independent per-dim Gaussian KDE, mean over kernels.
            d2 = (pts[:, None, :] - centers[None, :, :]) ** 2
            logk = -0.5 * d2 / self.bandwidth**2 - math.log(
                self.bandwidth * math.sqrt(2 * math.pi))
            per_dim = _logmeanexp(logk, axis=1)  # (n_pts, n_dims)
            return per_dim.sum(-1)

        # Sample candidates from the good mixture: pick a kernel, jitter.
        idx = self.rng.integers(len(good), size=self.n_candidates)
        cand = np.clip(
            good[idx] + self.rng.normal(
                0, self.bandwidth, size=(self.n_candidates, x.shape[1])),
            0.0, 1.0)
        score = mix_logpdf(cand, good) - mix_logpdf(cand, bad)
        u = cand[int(np.argmax(score))]
        return {
            d.name: d.from_unit(u[i]) for i, d in enumerate(self.domains)
        }


def _logmeanexp(a, axis):
    m = a.max(axis=axis, keepdims=True)
    return (m + np.log(np.mean(np.exp(a - m), axis=axis, keepdims=True))
            ).squeeze(axis)


class MedianEarlyStop:
    """Early-stop policy in the spirit of Google Vizier's median rule:
    a running trial is stopped when its latest intermediate objective is
    strictly below the median of completed trials' objectives at the same
    (or nearest earlier) step. Maximization convention, like Suggestion.
    """

    def __init__(self, min_trials: int = 3, start_step: int = 1):
        self.min_trials = min_trials
        self.start_step = start_step

    @staticmethod
    def _value_at(curve: list[tuple[int, float]], step: int):
        best = None
        for s, v in curve:
            if s <= step and (best is None or s > best[0]):
                best = (s, v)
        return None if best is None else best[1]

    def should_stop(self, curve: list[tuple[int, float]],
                    completed: list[list[tuple[int, float]]]) -> bool:
        """``curve``/``completed`` are (step, objective) series."""
        if len(completed) < self.min_trials or not curve:
            return False
        step, value = max(curve, key=lambda sv: sv[0])
        if step < self.start_step:
            return False
        peers = [self._value_at(c, step) for c in completed]
        peers = [p for p in peers if p is not None]
        if len(peers) < self.min_trials:
            return False
        return value < float(np.median(peers))


_ALGORITHMS = {
    "random": RandomSuggestion,
    "grid": GridSuggestion,
    "hyperband": HyperbandSuggestion,
    "bayesianoptimization": BayesianSuggestion,
    "tpe": TpeSuggestion,
}


def get_algorithm(name: str, domains: list[ParamDomain],
                  seed: int = 0) -> Suggestion:
    try:
        cls = _ALGORITHMS[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; available {sorted(_ALGORITHMS)}"
        )
    return cls(domains, seed)
