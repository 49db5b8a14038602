"""SHAP-style sensitivity analysis (paper §IV, Fig. 10) without the shap
package: Monte-Carlo Shapley values over a fitted surrogate (a copy of
``repro/core/sensitivity.py``).

For each evaluated configuration x and each hyperparameter j, we estimate
phi_j = E_pi [ f(x with features before j in pi from x, rest from a random
background sample) - f(same without j) ] over random permutations pi and
background draws — the classic sampling estimator of Shapley values.  The
reported importance is mean(|phi_j|) across configurations, exactly the
bar-chart quantity in the paper's Fig. 10.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from repro_torch.core.hpo import Param, RBFSurrogate, SearchResult, _encode


def shapley_importance(
    result: SearchResult,
    space: Sequence[Param],
    *,
    n_permutations: int = 64,
    n_explain: int = 48,
    seed: int = 0,
) -> dict[str, float]:
    rng = np.random.default_rng(seed)
    # fit on ALL evaluations with failures at the paper's F-penalty: OOM
    # avoidance is part of a hyperparameter's impact (this is why MBS ranks
    # first in Fig. 10 — it causes most of the OOMs)
    ok_vals = [t.objective for t in result.trials if not t.failed]
    floor = (min(ok_vals) - (np.std(ok_vals) + 1.0)) if ok_vals else -1.0
    X = np.stack([_encode(space, t.config) for t in result.trials])
    y = np.asarray([t.objective if not t.failed else floor
                    for t in result.trials])
    surr = RBFSurrogate()
    surr.fit(X, y)
    f = lambda Z: surr.predict(Z)[0]

    n, d = X.shape
    explain_idx = rng.choice(n, size=min(n_explain, n), replace=False)
    phis = np.zeros((len(explain_idx), d))
    for ei, xi in enumerate(explain_idx):
        x = X[xi]
        for _ in range(n_permutations):
            perm = rng.permutation(d)
            bg = X[rng.integers(n)]
            z = bg.copy()
            prev = f(z[None])[0]
            for j in perm:
                z[j] = x[j]
                cur = f(z[None])[0]
                phis[ei, j] += (cur - prev) / n_permutations
                prev = cur
    importance = np.abs(phis).mean(axis=0)
    return {p.name: float(v) for p, v in zip(space, importance)}
