"""Exact linear assignment for the DETR set criterion.

The JAX package matches with an on-device epsilon auction
(``transoar_tpu/models/hungarian.py``): a fixed eps, a cap of 2000
iterations, and -1 rows on cap-out. The port solves each problem exactly
with ``scipy.optimize.linear_sum_assignment``, the reference's own solver,
on the host.

**The step's one deliberate host sync.** ``hungarian_match`` takes the cost
of every decoder layer at once, ``[L, B, G, Q]``, with the present mask,
and copies both to the host in one transfer, which waits for the forward up
to the cost. It solves the L x B problems on their present rows and sends
the assignments back. Everything after it is enqueued again only once the
solve is done, so the card idles for the solve and the two small copies.
``MatchClock`` records each call's two host times (``wait_ms``: the copy to
the host, the forward's remaining device time included; ``solve_ms``: the
solves and the copy back).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


class MatchClock:
    """Host ms of each ``hungarian_match`` call."""

    def __init__(self):
        self.wait_ms, self.solve_ms = [], []


def assign(cost: np.ndarray, present: np.ndarray) -> np.ndarray:
    """cost [..., G, Q], present [..., G] (host arrays) -> the column of
    each present row, -1 for absent rows, [..., G] int64; every problem
    solved exactly on its present rows (G <= Q). A non-finite cost (a
    diverged forward) counts as the largest, so that the step still
    reaches its loss and ``trainer.nan_guard``."""
    cost = np.nan_to_num(cost, nan=1e30, posinf=1e30, neginf=-1e30)
    lead = cost.shape[:-2]
    G = cost.shape[-2]
    out = np.full(lead + (G,), -1, np.int64)
    present = np.broadcast_to(present, lead + (G,))
    for idx in np.ndindex(*lead):
        rows = np.flatnonzero(present[idx])
        if rows.size:
            r, c = linear_sum_assignment(cost[idx][rows])
            out[idx + (rows[r],)] = c
    return out


def hungarian_match(cost: torch.Tensor, present: torch.Tensor,
                    clock: MatchClock | None = None) -> torch.Tensor:
    """cost [L, B, G, Q] on any device, present [B, G] bool -> the assigned
    query of each (layer, batch, GT slot), -1 where absent, [L, B, G] int64
    on cost's device. One copy to the host and one back."""
    L, B, G, Q = cost.shape
    t0 = time.perf_counter()
    host = torch.cat([cost.detach().float().reshape(-1),
                      present.float().reshape(-1)]).cpu().numpy()
    t1 = time.perf_counter()
    cols = assign(host[:cost.numel()].reshape(L, B, G, Q),
                  host[cost.numel():].reshape(B, G) > 0.5)
    out = torch.from_numpy(cols).to(cost.device)
    if clock is not None:
        clock.wait_ms.append(1e3 * (t1 - t0))
        clock.solve_ms.append(1e3 * (time.perf_counter() - t1))
    return out
