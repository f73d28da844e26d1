"""Auction-algorithm EMD assignment (port of ``rfnet_tpu/ops/auction.py``).

Given two clouds of EQUAL size (n == m, n <= 4096 as in the reference op),
find a one-to-one assignment that (near-)minimises the total euclidean
distance. The Jacobi auction: every round all unassigned bidders bid at
once, each round a dense min/argmin over the cost matrix. ε starts at 1e-4
and is escalated ×100 every 40·n rounds. Off the train and eval paths (only
``losses.emd_func`` uses it); no gradient. Plain PyTorch on both devices.

The JAX function is a ``vmap`` over a ``while_loop``: a cloud's whole state
(assignment, owner, price, ε, round count) freezes once its own condition is
false while the others go on. Here the batch runs in one Python loop and a
finished cloud's state is kept by a mask. The loop asks ``.any()`` every
round, which synchronises with the card once a round.

Returns ``matchl (b, n)``, for each xyz1 point the assigned xyz2 index, and
``matchr (b, n)``, the inverse permutation.
"""

from __future__ import annotations

import torch

from rfnet_tpu_torch.ops.chamfer import _sq3, _sqrt_rn

_BIG = 1e38


def _scatter_flag(index: torch.Tensor, n: int) -> torch.Tensor:
    """(b, n) bool, true at every ``index`` (b, k) below n; n is a dump slot."""
    flag = torch.zeros((index.shape[0], n + 1), dtype=torch.bool, device=index.device)
    return flag.scatter_(1, index, torch.ones_like(index, dtype=torch.bool))[:, :n]


def _auction_round(cost, iota, assign, owner, price, eps, it):
    n = cost.shape[1]
    unassigned = assign < 0  # (b, n) bidders still bidding
    v = cost + price[:, None, :]
    best, bestj = v.min(dim=2)
    # second-best: the winner's column masked out for each bidder
    second = v.scatter(2, bestj[..., None], _BIG).min(dim=2).values
    incr = torch.where(unassigned, second - best + eps[:, None], -_BIG)
    # objects take the highest bid; ties go to the lowest bidder index
    top_incr = torch.full_like(price, -_BIG).scatter_reduce_(1, bestj, incr, "amax")
    is_top = unassigned & (incr >= top_incr.gather(1, bestj))
    winner = torch.full((cost.shape[0], n + 1), n, dtype=torch.long, device=cost.device)
    winner = winner.scatter_reduce_(1, torch.where(is_top, bestj, n), iota, "amin")[:, :n]
    won_obj = winner < n  # objects with a new owner this round
    # evict the previous owners of re-won objects, then record the winners
    assign = torch.where(_scatter_flag(torch.where(won_obj & (owner >= 0), owner, n), n),
                         -1, assign)
    dump = torch.zeros_like(assign[:, :1])
    assign = torch.cat([assign, dump], 1).scatter_(1, torch.where(won_obj, winner, n),
                                                    iota)[:, :n]
    owner = torch.where(won_obj, winner, owner)
    price = torch.where(won_obj, price + top_incr, price)
    it = it + 1
    eps = torch.where(it % (40 * max(n, 1)) == 0, eps * 100.0, eps)
    return assign, owner, price, eps, it


def auction_match(xyz1: torch.Tensor, xyz2: torch.Tensor, max_rounds: int = 8192):
    """(b, n, 3) × (b, n, 3) -> (matchl (b, n), matchr (b, n)) int32.

    Contract of the reference op's input checks: both clouds (b, n, 3) with
    the SAME n, and n <= 4096."""
    if xyz1.shape != xyz2.shape:
        raise ValueError("auction_match requires equal-size clouds (n == m)")
    if xyz1.shape[1] > 4096:
        raise ValueError("auction_match supports at most 4096 points (reference contract)")
    x1, x2 = xyz1.detach().float(), xyz2.detach().float()
    b, n, _ = x1.shape
    dev = x1.device
    cost = _sqrt_rn(_sq3(x1[:, :, None, :] - x2[:, None, :, :]))  # (b, n, n) euclidean
    iota = torch.arange(n, device=dev).expand(b, n)
    state = (
        torch.full((b, n), -1, dtype=torch.long, device=dev),  # assign: bidder -> object
        torch.full((b, n), -1, dtype=torch.long, device=dev),  # owner: object -> bidder
        torch.zeros((b, n), dtype=torch.float32, device=dev),  # price
        torch.full((b,), 1e-4, dtype=torch.float32, device=dev),  # eps
        torch.zeros((b,), dtype=torch.long, device=dev),  # rounds taken
    )
    while True:
        active = (state[0] < 0).any(dim=1) & (state[4] < max_rounds)
        if not bool(active.any()):
            break
        new = _auction_round(cost, iota, *state)
        # a cloud whose own loop has ended keeps its whole state
        state = tuple(torch.where(active.view(-1, *[1] * (o.dim() - 1)), nw, o)
                      for nw, o in zip(new, state))
    assign = state[0]
    # After the round cutoff: pair the i-th (by index) unassigned bidder with
    # the i-th unclaimed object. Each object has at most one owner, so the two
    # sets are equal in size and matchl/matchr are ALWAYS true permutations.
    unassigned = assign < 0
    claimed = _scatter_flag(torch.where(unassigned, n, assign), n)
    bidder_rank = torch.cumsum(unassigned.long(), dim=1) - 1  # rank among stragglers
    unclaimed_sorted = torch.sort(torch.where(claimed, n, iota), dim=1).values
    fill = unclaimed_sorted.gather(1, torch.clamp(bidder_rank, 0, n - 1))
    matchl = torch.where(unassigned, fill, assign)
    matchr = torch.zeros_like(matchl).scatter_(1, matchl, iota)
    return matchl.to(torch.int32), matchr.to(torch.int32)
