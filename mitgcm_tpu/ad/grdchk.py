"""Gradient check: finite differences vs adjoint (reference: pkg/grdchk).

grdchk_main.F:27-46 flowchart: for each selected control element, perturb
by +/-eps, rerun the forward model, and compare the centered finite
difference (fc+ - fc-)/(2 eps) against the adjoint gradient component.
The reference prints `1 - fd/adj` as the agreement measure; values of
O(1e-6) with eps=1e-4 pass its ADM tests.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import jax
import jax.numpy as jnp


def grdchk(objective: Callable, xx0, positions: Sequence[Tuple[int, ...]],
           eps: float = 1.0e-4):
    """Return list of dicts: one per checked position.

    objective: a compiled J(xx), such as adjoint.make_objective returns."""
    fc0, grad = jax.value_and_grad(objective)(xx0)
    results: List[dict] = []
    for pos in positions:
        e = jnp.zeros_like(xx0).at[pos].set(eps)
        fcp = objective(xx0 + e)
        fcm = objective(xx0 - e)
        fd = (fcp - fcm) / (2.0 * eps)
        adj = grad[pos]
        denom = jnp.where(adj != 0.0, adj, 1.0)
        results.append({
            "pos": pos,
            "fc_ref": float(fc0),
            "fc_plus": float(fcp),
            "fc_minus": float(fcm),
            "fd_grad": float(fd),
            "adj_grad": float(adj),
            "rel_err": float(1.0 - fd / denom) if float(adj) != 0.0
            else float(fd),
        })
    return results
