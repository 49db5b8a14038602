"""DeepHyper-style asynchronous Bayesian hyperparameter search (paper §IV;
a copy of ``repro/core/hpo.py``).

Reproduces the paper's tuning of a 175B model over
  PP in {1,2,4,8,12,16}, TP in {1,2,4,8}, MBS in [4,20], GAS in {5,10},
  ZeRO stage in {0..3} (the paper searched the binary ZeRO-1 bit; the
  MemoryPlan axis widens it to the full stage ladder — arXiv 2501.04266
  shows stage choice dominates throughput on this hardware),
  NNODES in {12,16}
maximizing achieved FLOPS, with OOM failures penalized via the paper's
"F-objective" (failed configs get a value below every success, so the
surrogate learns to avoid them — the red-arrow frequency in Fig. 9 decays).

numpy-only Bayesian optimization: an RBF-kernel ridge surrogate (a GP
posterior-mean stand-in) + expected-improvement-flavoured acquisition over
random candidate draws, mirroring DeepHyper's centralized async search.
Each trial is a concrete ``runtime/train_loop.py:ParallelPlan``
(:func:`trial_plan`), which the port's executor runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Param:
    name: str
    values: tuple          # discrete choices (paper's space is all discrete)


SPACE_175B = (
    Param("pp", (1, 2, 4, 8, 12, 16)),
    Param("tp", (1, 2, 4, 8)),
    Param("mbs", tuple(range(4, 21))),
    Param("gas", (5, 10)),
    Param("zero", (0, 1, 2, 3)),   # ZeRO stage (was the binary "zero1" bit)
    Param("nnodes", (12, 16)),
)

# paper-faithful restriction: §IV searched only the binary ZeRO-1 bit, and
# Fig. 10's "memory axis matters least" ranking holds on that sub-axis —
# stages 2/3 add comm terms that dominate the sensitivity, so the Fig. 9/10
# reproduction scripts search this space to stay comparable to the paper
SPACE_175B_PAPER = tuple(
    Param("zero", (0, 1)) if p.name == "zero" else p for p in SPACE_175B)

# the compute-path axes (Duan et al. 2407.20018's third dimension of the
# search space): recompute policy x fused kernels, searched jointly with
# the (dp, tp, pp) decomposition
SPACE_COMPUTE = SPACE_175B + (
    Param("remat", ("full", "selective", "none")),
    Param("kernels", (0, 1)),
)

# Megatron-style interleaved virtual staging (bubble (p-1)/(v*m+p-1),
# shrinking with v) is searchable alongside the decomposition
SPACE_INTERLEAVED = SPACE_COMPUTE + (
    Param("vs", (1, 2, 4)),
)

# the CommPlan axes (core/commplan.py): int8 block-quantized zero=3
# collectives, a hierarchical node axis splitting data-parallel collectives
# into intra/inter-node phases, and gather/compute overlap.  qcomm/overlap
# only bind at zero=3 — trial_plan downgrades them elsewhere so the
# surrogate sees a smooth space instead of a wall of failures.
SPACE_COMM = SPACE_INTERLEAVED + (
    Param("qcomm", ("none", "gather", "both")),
    Param("node", (1, 2)),
    Param("overlap", (0, 1)),
)

# the ExpertPlan axis (core/expertplan.py): expert-parallel ways for MoE
# families.  ep only binds when it tiles the device count alongside
# (node, tp, pp) — trial_plan downgrades untileable draws to ep=1, the
# same smooth-space convention as qcomm/overlap.
SPACE_MOE = SPACE_COMM + (
    Param("ep", (1, 2, 4)),
)


def trial_plan(config: dict, *, gpus_per_node: int = 8,
               rules: str = "megatron_tp", precision: str = "bf16"):
    """Concretize one search-space config into a real 3D ``ParallelPlan``.

    The search enumerates (pp, tp, gas, zero, nnodes) plus the compute-path
    knobs (remat, kernels) and the CommPlan knobs (qcomm, node, overlap);
    dp is whatever tiles the remaining devices
    (``nnodes * gpus_per_node / (node * tp * pp)``): the paper's
    decomposition.  qcomm/overlap only exist at zero=3 and overlap only at
    pp=1, so other draws are downgraded to their no-op values rather than
    failed; an ``ep`` that does not tile the devices downgrades to 1.
    Returns ``None`` when the config cannot tile the device count (the
    F-objective failure case).  ``mbs`` stays a
    cost-model knob: the executor derives the microbatch size from
    global_batch / gas.
    """
    from repro_torch.runtime.train_loop import ParallelPlan  # lazy: hpo stays numpy-only

    if "zero1" in config:
        raise ValueError(
            "the zero1 search key has been removed; pass zero=0|1|2|3 "
            "(zero1=True was zero=1, zero1=False was zero=0)")
    world = int(config.get("nnodes", 1)) * gpus_per_node
    tp, pp = int(config.get("tp", 1)), int(config.get("pp", 1))
    node = int(config.get("node", 1))
    if tp < 1 or pp < 1 or node < 1 or world % (node * tp * pp) != 0:
        return None
    zero = int(config.get("zero", 1))
    qcomm = str(config.get("qcomm", "none"))
    overlap = bool(config.get("overlap", 0))
    if zero != 3:
        qcomm, overlap = "none", False
    if pp > 1:
        overlap = False
    ep = int(config.get("ep", 1))
    if ep < 1 or world % (node * tp * pp * ep) != 0:
        ep = 1  # downgrade, not F-objective failure: keep the axis smooth
    return ParallelPlan(
        dp=world // (node * tp * pp * ep), tp=tp, pp=pp, ep=ep, node=node,
        virtual_stages=int(config.get("vs", 1)),
        gas=int(config.get("gas", 1)), zero=zero,
        qcomm=qcomm, overlap=overlap,
        rules=rules, precision=precision,
        remat=str(config.get("remat", "full")),
        kernels=bool(config.get("kernels", 0)))


def plan_objective(plan_fn, *, gpus_per_node: int = 8, fail_value: float = -1.0):
    """Adapt an objective over ``ParallelPlan``s to the config-dict interface
    of :func:`bayesian_search`, penalizing untileable configs as failures."""
    def objective(config: dict) -> float:
        plan = trial_plan(config, gpus_per_node=gpus_per_node)
        if plan is None:
            return fail_value
        return plan_fn(plan, config)
    return objective


@dataclasses.dataclass
class Trial:
    config: dict
    objective: float       # achieved TFLOPS/GPU; failures -> penalized
    failed: bool


@dataclasses.dataclass
class SearchResult:
    trials: list[Trial]

    @property
    def best(self) -> Trial:
        ok = [t for t in self.trials if not t.failed]
        return max(ok, key=lambda t: t.objective) if ok else self.trials[0]

    def best_so_far(self) -> list[float]:
        out, cur = [], -np.inf
        for t in self.trials:
            if not t.failed:
                cur = max(cur, t.objective)
            out.append(cur)
        return out

    def failure_rate(self, window: int = 16) -> list[float]:
        fails = [float(t.failed) for t in self.trials]
        return [float(np.mean(fails[max(0, i - window):i + 1]))
                for i in range(len(fails))]


def _encode(space: Sequence[Param], config: dict) -> np.ndarray:
    x = []
    for p in space:
        v = config[p.name]
        try:
            vals = np.asarray(p.values, dtype=float)
            x.append((float(v) - vals.min()) / max(vals.max() - vals.min(), 1e-9))
        except (TypeError, ValueError):
            # categorical axis (e.g. remat mode): encode by choice index
            x.append(p.values.index(v) / max(len(p.values) - 1, 1))
    return np.asarray(x)


def _sample(space: Sequence[Param], rng: np.random.Generator) -> dict:
    return {p.name: p.values[rng.integers(len(p.values))] for p in space}


class RBFSurrogate:
    """Kernel ridge regression with an RBF kernel — the GP posterior mean."""

    def __init__(self, lengthscale: float = 0.35, reg: float = 1e-3):
        self.ls = lengthscale
        self.reg = reg
        self.X: np.ndarray | None = None
        self.alpha: np.ndarray | None = None
        self.y_mean = 0.0
        self.y_std = 1.0

    def _k(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-d2 / (2 * self.ls ** 2))

    def fit(self, X: np.ndarray, y: np.ndarray) -> None:
        self.y_mean, self.y_std = float(y.mean()), float(y.std() + 1e-9)
        yn = (y - self.y_mean) / self.y_std
        K = self._k(X, X) + self.reg * np.eye(len(X))
        self.alpha = np.linalg.solve(K, yn)
        self.X = X

    def predict(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        K = self._k(X, self.X)
        mu = K @ self.alpha * self.y_std + self.y_mean
        # distance-based uncertainty proxy (max kernel similarity)
        sigma = self.y_std * np.sqrt(np.clip(1.0 - K.max(axis=1), 1e-6, 1.0))
        return mu, sigma


def bayesian_search(
    objective: Callable[[dict], float],
    space: Sequence[Param] = SPACE_175B,
    *,
    n_trials: int = 128,
    n_random: int = 16,
    n_candidates: int = 256,
    seed: int = 0,
    fail_value: float | None = None,
) -> SearchResult:
    """objective returns TFLOPS/GPU, or a negative value for failure (OOM)."""
    rng = np.random.default_rng(seed)
    trials: list[Trial] = []
    seen: set[tuple] = set()

    def evaluate(cfg: dict) -> None:
        val = objective(cfg)
        failed = val < 0
        trials.append(Trial(cfg, val, failed))

    while len(trials) < n_trials:
        if len(trials) < n_random:
            cfg = _sample(space, rng)
        else:
            X = np.stack([_encode(space, t.config) for t in trials])
            ok_vals = [t.objective for t in trials if not t.failed]
            floor = (min(ok_vals) - 1.0) if ok_vals else 0.0
            y = np.asarray([t.objective if not t.failed
                            else (fail_value if fail_value is not None else floor)
                            for t in trials])
            surr = RBFSurrogate()
            surr.fit(X, y)
            cands = [_sample(space, rng) for _ in range(n_candidates)]
            Xc = np.stack([_encode(space, c) for c in cands])
            mu, sigma = surr.predict(Xc)
            best = y.max()
            ei = (mu - best) + 1.2 * sigma       # UCB-flavoured EI
            cfg = cands[int(np.argmax(ei))]
        key = tuple(cfg.values())
        if key in seen and rng.random() < 0.8:
            cfg = _sample(space, rng)
            key = tuple(cfg.values())
        seen.add(key)
        evaluate(cfg)
    return SearchResult(trials)
