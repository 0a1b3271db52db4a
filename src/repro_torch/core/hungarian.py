"""Hungarian algorithm (linear sum assignment) over many tiny matrices.

The same shortest-augmenting-path (Jonker-Volgenant) scheme as the JAX
package's solver, with its operation order, its ``_INF`` and its
first-index ``argmin``, so both solvers return the same ``col4row`` even
on ties.  The reference ``vmap``s a ``fori_loop`` of ``while_loop``s over
the batch; here every loop runs over all problems at once with a per-problem
"done" mask that freezes a finished problem, exactly as a batched
``while_loop`` does.

The loops have fixed trip counts, so no iteration waits on the device to
decide whether to go on: when row ``r`` is added, ``r`` columns are matched,
so the Dijkstra scan reaches a free column within ``r + 1`` steps and the
augmenting path back from it is at most ``r + 1`` long.
"""
from __future__ import annotations

import torch

_INF = 1.0e18


def auto_pad_value(cost: torch.Tensor, valid: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Pad cost ``cmax + n * (cmax - cmin) + 1`` per problem: it always loses
    to any real match and stays inside float32 precision of the real cost
    range, so the solver maximizes the number of real-real matches."""
    big = torch.where(valid, cost, -_INF)
    small = torch.where(valid, cost, _INF)
    cmax = torch.clamp_min(big.amax(dim=(-2, -1)), 0.0)
    cmin = torch.clamp_max(small.amin(dim=(-2, -1)), 0.0)
    return cmax + n * (cmax - cmin) + 1.0


def pad_cost_matrix(cost: torch.Tensor, row_mask: torch.Tensor,
                    col_mask: torch.Tensor, n: int,
                    pad_value=None) -> torch.Tensor:
    """Embed a masked ``[..., R, C]`` cost into an ``[..., n, n]`` padded
    square matrix.  ``pad_value=None`` selects :func:`auto_pad_value`."""
    r, c = cost.shape[-2], cost.shape[-1]
    if n < r or n < c:
        raise ValueError(f"n={n} is smaller than the cost's {r}x{c}")
    valid = row_mask[..., :, None] & col_mask[..., None, :]
    if pad_value is None:
        pad_value = auto_pad_value(cost, valid, n)
    pad = torch.as_tensor(pad_value, dtype=cost.dtype,
                          device=cost.device)[..., None, None]
    out = pad.expand(cost.shape[:-2] + (n, n)).clone()
    out[..., :r, :c] = torch.where(valid, cost, pad)
    return out


def solve(cost: torch.Tensor) -> torch.Tensor:
    """Solve every ``[n, n]`` assignment problem of ``cost [..., n, n]``.

    Returns ``col4row [..., n] int32``, the column assigned to each row;
    ``cost[..., arange(n), col4row].sum(-1)`` is minimal per problem.
    """
    n = cost.shape[-1]
    batch = cost.shape[:-2]
    c = cost.reshape(-1, n, n).to(torch.float32)
    nb, dev = c.shape[0], c.device
    lane = torch.arange(nb, device=dev)
    cols = torch.arange(n, device=dev)[None]                 # [1, n]
    u = torch.zeros((nb, n), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    col4row = torch.full((nb, n), -1, dtype=torch.long, device=dev)
    row4col = torch.full_like(col4row, -1)

    for cur_row in range(n):
        # --- Dijkstra over columns for an augmenting path from cur_row ---
        spc = torch.full((nb, n), _INF, dtype=torch.float32, device=dev)
        path = torch.full((nb, n), -1, dtype=torch.long, device=dev)
        sr = torch.zeros((nb, n), dtype=torch.bool, device=dev)
        sc = torch.zeros_like(sr)
        i = torch.full((nb,), cur_row, dtype=torch.long, device=dev)
        min_val = torch.zeros((nb,), dtype=torch.float32, device=dev)
        sink = torch.full((nb,), -1, dtype=torch.long, device=dev)
        for _ in range(cur_row + 1):
            live = sink < 0
            lv = live[:, None]
            sr = sr | (lv & (cols == i[:, None]))
            red = (min_val[:, None] + c[lane, i] - u[lane, i][:, None]) - v
            upd = lv & ~sc & (red < spc)
            spc = torch.where(upd, red, spc)
            path = torch.where(upd, i[:, None], path)
            masked = torch.where(sc, _INF, spc)
            j = torch.argmin(masked, dim=1)                  # first min
            min_val = torch.where(live, spc[lane, j], min_val)
            sc = sc | (lv & (cols == j[:, None]))
            owner = row4col[lane, j]
            free = owner < 0
            sink = torch.where(live & free, j, sink)
            i = torch.where(live & ~free, owner, i)

        # --- dual updates (scipy rectangular_lsap convention) ---
        u[:, cur_row] = u[:, cur_row] + min_val
        others = sr & (cols != cur_row)
        prev = torch.gather(spc, 1, col4row.clamp(0, n - 1))
        u = torch.where(others, u + min_val[:, None] - prev, u)
        v = torch.where(sc, v + spc - min_val[:, None], v)

        # --- augment along the alternating path back from sink ---
        j = sink
        done = torch.zeros((nb,), dtype=torch.bool, device=dev)
        for _ in range(cur_row + 1):
            live = ~done
            lv = live[:, None]
            i = path[lane, j]
            row4col = torch.where(lv & (cols == j[:, None]), i[:, None],
                                  row4col)
            nxt = col4row[lane, i.clamp_min(0)]
            col4row = torch.where(lv & (cols == i[:, None]), j[:, None],
                                  col4row)
            j = torch.where(live, nxt, j)
            done = done | (live & (i == cur_row))
    return col4row.to(torch.int32).reshape(batch + (n,))


def solve_masked(cost: torch.Tensor, row_mask: torch.Tensor,
                 col_mask: torch.Tensor, n: int) -> torch.Tensor:
    """Masked rectangular assignment: ``col4row [..., n]``, where an
    invalid row, or one matched to padding, gets an arbitrary pad column.
    Callers re-validate matches (SORT's IoU gate does)."""
    return solve(pad_cost_matrix(cost, row_mask, col_mask, n))


def solve_masked_lane(cost: torch.Tensor, row_mask: torch.Tensor,
                      col_mask: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`solve_masked` for the lane layout: ``cost [R, C, *lanes]``,
    ``row_mask [R, *lanes]``, ``col_mask [C, *lanes]`` -> ``col4row
    [n, *lanes] int32``."""
    r, c = cost.shape[0], cost.shape[1]
    lanes = cost.shape[2:]
    cost_b = torch.movedim(cost.reshape(r, c, -1), -1, 0)         # [L, R, C]
    rm_b = torch.movedim((row_mask > 0).reshape(r, -1), -1, 0)    # [L, R]
    cm_b = torch.movedim((col_mask > 0).reshape(c, -1), -1, 0)    # [L, C]
    out = solve_masked(cost_b, rm_b, cm_b, n)                     # [L, n]
    return torch.movedim(out, 0, -1).reshape((n,) + lanes)
