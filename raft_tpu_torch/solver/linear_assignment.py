"""Linear assignment problem (counterpart of
``raft_tpu.solver.linear_assignment``): the auction algorithm
(Bertsekas) with ε-scaling, the JAX package's formulation.

In a round every unassigned row bids on its best column (value minus
price), raising the price by the gap to its second best plus ε; each
column takes its highest bid, the lowest row winning a tie (the JAX
package's ``argmax`` over a dense bids matrix), and evicts its previous
owner. A phase runs rounds until every row is assigned; ε starts at n/2
on costs rescaled to span n units and falls fourfold a phase (not below
0.25/n), for ``n_phases`` phases or until ε·n < 0.5. Those rounds,
phases and rules are the JAX package's.

The JAX ``lax.while_loop`` of a phase is a host loop here. A round
after every row is assigned changes nothing, so the loop runs
``_ROUNDS_PER_SYNC`` rounds between two looks at the host: the result
is the same, and each phase's count of rounds that did work is kept
(``LinearAssignmentProblem.rounds_per_phase``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.mdarray import as_array, input_device

_NEG = -1e30
# auction rounds between two host syncs (extra rounds are no-ops)
_ROUNDS_PER_SYNC = 16


def _round(benefit, row_assign, col_owner, prices, eps: float, rows):
    """One Jacobi auction round → (row_assign, col_owner, prices, did
    work: a 0-d bool)."""
    n = benefit.shape[0]
    unassigned = row_assign < 0
    value = benefit - prices[None, :]
    best_v, best_j = value.amax(dim=1), torch.argmax(value, dim=1)
    second_v = value.scatter(1, best_j[:, None], _NEG).amax(dim=1)
    bid_amount = torch.where(unassigned,
                             prices[best_j] + (best_v - second_v + eps),
                             torch.full_like(best_v, _NEG))
    bids = torch.full((n, n), _NEG, dtype=benefit.dtype,
                      device=benefit.device)
    bids[rows, best_j] = bid_amount
    win_bid, win_row = bids.amax(dim=0), torch.argmax(bids, dim=0)
    has_bid = win_bid > _NEG / 2
    # evict the previous owners of the columns that got a bid
    evicted = torch.zeros(n + 1, dtype=torch.bool, device=benefit.device)
    evicted[torch.where(has_bid, col_owner, -1).long()] = True
    row_assign = torch.where(evicted[:n], -1, row_assign)
    # winners take their columns (a row bids on one column only)
    winners = torch.where(has_bid, win_row, n)
    grown = torch.cat([row_assign, row_assign.new_zeros(1)])
    grown[winners] = rows.to(torch.int32)
    col_owner = torch.where(has_bid, win_row.to(torch.int32), col_owner)
    prices = torch.where(has_bid, win_bid, prices)
    return grown[:n], col_owner, prices, unassigned.any()


def _auction_phase(benefit: torch.Tensor, prices: torch.Tensor, eps: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One ε-phase: rounds until every row is assigned → (row_assign,
    prices, rounds that did work)."""
    n = benefit.shape[0]
    rows = torch.arange(n, device=benefit.device)
    row_assign = torch.full((n,), -1, dtype=torch.int32,
                            device=benefit.device)
    col_owner = torch.full_like(row_assign, -1)
    rounds = torch.zeros((), dtype=torch.int64, device=benefit.device)
    while bool((row_assign < 0).any()):
        for _ in range(_ROUNDS_PER_SYNC):
            row_assign, col_owner, prices, worked = _round(
                benefit, row_assign, col_owner, prices, eps, rows)
            rounds += worked
    return row_assign, prices, int(rounds)


def _solve(cost: torch.Tensor, maximize: bool, n_phases: int):
    n = cost.shape[0]
    benefit = cost if maximize else -cost
    # scale so that the costs span ~n units (optimality gap n·ε_final < 1)
    spread = torch.clamp(benefit.max() - benefit.min(), min=1e-6)
    benefit = benefit / spread * n
    prices = torch.zeros(n, dtype=torch.float32, device=cost.device)
    eps = float(n) / 2.0
    row_assign = torch.full((n,), -1, dtype=torch.int32, device=cost.device)
    rounds: List[int] = []
    for _ in range(n_phases):
        row_assign, prices, r = _auction_phase(benefit, prices, eps)
        rounds.append(r)
        if eps * n < 0.5:
            break
        eps = max(eps / 4.0, 0.25 / n)
    col_assign = torch.full_like(row_assign, -1)
    col_assign[row_assign.long()] = torch.arange(
        n, dtype=torch.int32, device=cost.device)
    rows = torch.arange(n, device=cost.device)
    obj = cost[rows, row_assign.long()].sum()
    return row_assign, col_assign, obj, rounds


def linear_assignment(cost, maximize: bool = False, n_phases: int = 6,
                      res=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The n x n assignment → (row_assignment (n,): the column of each
    row, col_assignment (n,): the row of each column, objective).
    Minimizes unless ``maximize``."""
    cost = as_array(cost, input_device(res, cost)).float()
    expects(cost.dim() == 2 and cost.shape[0] == cost.shape[1],
            "linear_assignment: cost must be square")
    return _solve(cost, maximize, n_phases)[:3]


class LinearAssignmentProblem:
    """The reference's class API: construct with the size, ``solve``,
    then read the assignments and the objective; ``rounds_per_phase``
    holds the auction rounds of each ε-phase of the last solve."""

    def __init__(self, size: int, epsilon: float = 1e-6):
        self.size = size
        self.epsilon = epsilon
        self._row_assign = None
        self._col_assign = None
        self._obj = None
        self.rounds_per_phase: List[int] = []

    def solve(self, cost) -> torch.Tensor:
        cost = as_array(cost, input_device(None, cost)).float()
        expects(tuple(cost.shape) == (self.size, self.size),
                "LinearAssignmentProblem: cost shape mismatch")
        (self._row_assign, self._col_assign, self._obj,
         self.rounds_per_phase) = _solve(cost, False, 6)
        return self._obj

    def get_row_assignment_vector(self) -> torch.Tensor:
        return self._row_assign

    def get_col_assignment_vector(self) -> torch.Tensor:
        return self._col_assign

    def get_primal_objective_value(self) -> torch.Tensor:
        return self._obj
