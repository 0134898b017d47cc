"""Hard cloud-budget accounting (paper Eq. 13), PyTorch.

Mirrors ``repro/core/budget.py``.  ``charge_batch`` keeps the prototype's
strictly sequential semantics — a query is admitted only if budget remains
after every earlier query in the batch — as a loop over the batch in place
of ``lax.scan``; the running total is f32, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BudgetState(NamedTuple):
    total: torch.Tensor      # () f32 — Budget_cloud^total for the window
    used: torch.Tensor       # () f32 — Budget_cloud^used
    window_id: torch.Tensor  # () i32 — accounting window (e.g. day index)


def init_budget(total: float, window_id: int = 0, device=None) -> BudgetState:
    return BudgetState(
        total=torch.tensor(total, dtype=torch.float32, device=device),
        used=torch.tensor(0.0, dtype=torch.float32, device=device),
        window_id=torch.tensor(window_id, dtype=torch.int32, device=device))


def roll_window(state: BudgetState, window_id) -> BudgetState:
    """Reset ``used`` when the accounting window advances."""
    window_id = torch.as_tensor(window_id, dtype=torch.int32,
                                device=state.used.device)
    fresh = window_id != state.window_id
    return BudgetState(total=state.total,
                       used=torch.where(fresh, torch.zeros_like(state.used),
                                        state.used),
                       window_id=window_id)


def charge_batch(state: BudgetState, costs: torch.Tensor,
                 wants_cloud: torch.Tensor
                 ) -> tuple[torch.Tensor, BudgetState]:
    """Sequentially admit cloud requests while budget remains (Eq. 13).

    costs (B,) estimated cloud cost per query; wants_cloud (B,) bool.
    Returns (admitted (B,) bool, new state)."""
    costs = costs.float()
    used = state.used
    admitted = []
    for cost, wants in zip(costs, wants_cloud):
        ok = wants & (used + cost <= state.total)
        used = used + torch.where(ok, cost, torch.zeros_like(cost))
        admitted.append(ok)
    adm = (torch.stack(admitted) if admitted
           else torch.zeros(0, dtype=torch.bool, device=costs.device))
    return adm, state._replace(used=used)
