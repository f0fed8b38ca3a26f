"""DSnoT — training-free mask refinement (port of
``vlm_compression_tpu/ops/dsnot.py``).

Two branches, with the JAX package's loop semantics:

Unstructured: per cycle, each unit (row) draws a regrow candidate from the
two-pointer walk over the signed-metric-sorted FULL column list (pruned
columns carry ``W·E[x]``, kept columns 0) and a prune candidate from the
Wanda-ordered kept-column list reordered by ``return_reorder_indice``.
Every row's mask takes ``mask[prune] = keep, mask[regrow] = pruned`` every
cycle (regrow wins when the two alias), whether or not the row still
updates, while the reconstruction error advances only where it does.  The
loop runs from cycle 0 while any row updates and ``cycle < max``, so one
cycle more changes the mask.

n:m: per cycle, each row regrows the pruned column whose signed metric
best cancels the row's error and re-prunes the weakest kept column of the
same m-block; a block whose slots are all +inf takes
``_TORCH_TOPK_TIE_IDX[m]``, elsewhere the first index of the minimum.  The
loop runs from cycle 1 while any row updates and ``cycle <= max``.

Pointers that would walk off a list are clamped to its boundary (the prune
list's is ``res_num - 1``).  Every sort is stable; the initial mask counts
with ``rounding="round"``.  All in fp32 on the caller's device, one call
per linear: the loop asks the host once a cycle whether any row still
updates, and ends exactly where the JAX loop does.

Layout: unit-major ``(units, in)``; masks returned True = keep.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vlm_compression_tpu_torch.ops.masks import unstructured_mask

# torch-CPU topk(largest=False, k=1) tie index for an all-equal row of
# width m, as the JAX package keeps it (its reference picks the re-prune
# column with topk; CUDA's topk breaks ties otherwise, so the table is
# applied on every device).  Unlisted widths take 0.
_TORCH_TOPK_TIE_IDX = {2: 0, 3: 0, 4: 2, 5: 2, 6: 3, 7: 5, 8: 6, 9: 7,
                       10: 8, 12: 9, 16: 10, 24: 15, 32: 22}


class DSnoTResult(NamedTuple):
    keep_mask: torch.Tensor
    cycles: int  # refinement cycles actually run


def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1, stable=True).indices


def return_reorder_indice(x: torch.Tensor) -> torch.Tensor:
    """Reorder indices so negatives keep their relative order and
    positives flip — the pruning candidate list's order."""
    rows, n = x.shape
    idx = torch.arange(n, dtype=torch.float32, device=x.device).expand(rows,
                                                                       n)
    inf = torch.tensor(float("inf"), device=x.device)
    pos_sorted = torch.sort(torch.where(x > 0, idx, inf), dim=1).values
    neg_sorted = torch.sort(torch.where(x < 0, idx, inf), dim=1).values
    pos_sorted = torch.flip(pos_sorted, dims=(1,))
    neg_sorted = torch.where(torch.isinf(neg_sorted), 0.0, neg_sorted)
    pos_sorted = torch.where(torch.isinf(pos_sorted), 0.0, pos_sorted)
    return (pos_sorted + neg_sorted).to(torch.int64)


def _symmetrize(a: torch.Tensor) -> torch.Tensor:
    # jnp.linalg.cholesky factors (a + aᴴ) / 2
    return (a + a.T) / 2


def dsnot_initial_metric(weight_um: torch.Tensor, scaler_row: torch.Tensor,
                         hessian: Optional[torch.Tensor] = None,
                         initial_method: str = "wanda") -> torch.Tensor:
    """The initial importance: Wanda, magnitude or SparseGPT's."""
    W = weight_um.float()
    if initial_method == "wanda":
        return torch.abs(W) * torch.sqrt(scaler_row)[None, :]
    if initial_method == "magnitude":
        return torch.abs(W)
    if initial_method == "sparsegpt":
        # one unconditional damping, no retry
        H = hessian.float()
        dead = torch.diagonal(H) == 0
        H = H + torch.diag(dead.float())
        W = torch.where(dead[None, :], 0.0, W)
        damp = 0.01 * torch.mean(torch.diagonal(H))
        eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
        H = H + damp * eye
        L = torch.linalg.cholesky(_symmetrize(H))
        hinv = torch.cholesky_solve(eye, L)
        U = torch.linalg.cholesky(_symmetrize(hinv)).T
        # a single power of the diagonal, as the JAX package has it
        return W * W / torch.diagonal(U)[None, :]
    raise ValueError(initial_method)


@torch.no_grad()
def dsnot_refine_mask(
    weight_um: torch.Tensor,
    scaler_row: torch.Tensor,
    sum_metric_row: torch.Tensor,
    var: torch.Tensor,
    sparsity,
    prune_n: int = 0,
    prune_m: int = 0,
    max_cycle_time: int = 50,
    update_threshold: float = 0.1,
    pow_of_var_regrowing: float = 1.0,
    without_same_sign: bool = True,
    without_dsnot: bool = False,
    initial_method: str = "wanda",
    hessian: Optional[torch.Tensor] = None,
) -> DSnoTResult:
    W = weight_um.float()
    units, n_in = W.shape
    dsnot_metric = W * sum_metric_row[None, :].float()
    initial_metric = dsnot_initial_metric(W, scaler_row, hessian,
                                          initial_method)

    if prune_n == 0:
        keep0 = unstructured_mask(initial_metric, float(sparsity),
                                  rounding="round")
        if without_dsnot:
            return DSnoTResult(keep0, 0)
        return _dsnot_unstructured(
            W, dsnot_metric, ~keep0, scaler_row, var,
            max_cycle_time=max_cycle_time, update_threshold=update_threshold,
            pow_of_var_regrowing=pow_of_var_regrowing,
            without_same_sign=without_same_sign)
    return _dsnot_nm(dsnot_metric, initial_metric, var, prune_n, prune_m,
                     max_cycle_time=max_cycle_time,
                     update_threshold=update_threshold,
                     pow_of_var_regrowing=pow_of_var_regrowing)


def _dsnot_nm(dsnot_metric, initial_metric, var, n, m, *, max_cycle_time,
              update_threshold, pow_of_var_regrowing) -> DSnoTResult:
    units, n_in = dsnot_metric.shape
    if n_in % m:
        raise ValueError(f"in={n_in} not divisible by m={m}")
    dev = dsnot_metric.device
    g = initial_metric.reshape(units, n_in // m, m)
    rank = _argsort(_argsort(g))
    pruned = (rank < n).reshape(units, n_in)            # True = pruned

    # the DSnoT metric zeroed at kept columns
    metric_regrow = torch.where(pruned, dsnot_metric, 0.0)
    err = torch.sum(metric_regrow, dim=1, keepdim=True)     # (units, 1)
    init_sign = torch.sign(err)
    if pow_of_var_regrowing:
        metric_regrow = metric_regrow / torch.pow(var[None, :],
                                                  pow_of_var_regrowing)
    regrow_order = _argsort(metric_regrow)

    # pruned columns promoted to +inf; consumed slots are promoted too
    imetric = torch.where(pruned, float("inf"), initial_metric)
    max_val = torch.amax(imetric, dim=1, keepdim=True) + 1.0   # = inf
    offs = torch.arange(m, device=dev)
    tie = _TORCH_TOPK_TIE_IDX.get(m, 0)
    ptrs = _pointers(units, n_in - 1, dev)
    upd = torch.ones((units, 1), dtype=torch.bool, device=dev)

    # (units, 1) columns throughout: one gather or scatter a step
    cycle = 1
    while cycle <= max_cycle_time and bool(upd.any()):
        side = (err > 0).to(torch.int64)
        regrow_col = regrow_order.gather(
            1, ptrs.gather(1, side).clamp_(0, n_in - 1))
        regrow_metric = dsnot_metric.gather(1, regrow_col)

        block_start = regrow_col - regrow_col % m
        blk_metric = imetric.gather(1, block_start + offs)
        prune_off = torch.argmin(blk_metric, dim=1, keepdim=True)
        all_inf = torch.all(torch.isposinf(blk_metric), dim=1, keepdim=True)
        prune_col = block_start + torch.where(all_inf, tie, prune_off)
        prune_metric = dsnot_metric.gather(1, prune_col)

        err_after = err + prune_metric - regrow_metric
        upd = upd & (init_sign == torch.sign(err_after)) \
            & (torch.abs(err) > update_threshold)

        imetric.scatter_(1, prune_col, max_val)
        pruned.scatter_(1, prune_col, upd)
        pruned.scatter_(1, regrow_col, ~upd)   # regrow wins on aliasing

        err = err + torch.where(upd, prune_metric - regrow_metric, 0.0)
        ptrs.scatter_add_(1, side, 1 - 2 * side)
        cycle += 1
    return DSnoTResult(~pruned, cycle - 1)


def _pointers(units: int, last, device) -> torch.Tensor:
    """(units, 2) list pointers: column 0 walks up from the start, column 1
    down from ``last``."""
    out = torch.zeros((units, 2), dtype=torch.int64, device=device)
    out[:, 1] = last
    return out


def _reorder_indice(vals: torch.Tensor, valid_len: int) -> torch.Tensor:
    """``return_reorder_indice`` over the first ``valid_len`` entries of
    each row: negatives keep their relative order, positives follow in
    flipped order, zero-valued slots map to index 0.  Slots at or past
    ``valid_len`` are 0."""
    rows, n = vals.shape
    j = torch.arange(n, device=vals.device)[None, :]
    valid = j < valid_len
    idxf = j.float().expand(rows, n)
    inf = torch.tensor(float("inf"), device=vals.device)
    neg = valid & (vals < 0)
    pos = valid & (vals > 0)
    neg_asc = torch.sort(torch.where(neg, idxf, inf), dim=1).values
    pos_asc = torch.sort(torch.where(pos, idxf, inf), dim=1).values
    n_neg = torch.sum(neg, dim=1, keepdim=True)
    n_pos = torch.sum(pos, dim=1, keepdim=True)
    # positives fill output slots [valid_len − n_pos, valid_len) in
    # descending index order: slot j reads ascending rank valid_len − 1 − j
    pos_rank = torch.clamp(valid_len - 1 - j, 0, n - 1).expand(rows, n)
    pos_at = torch.gather(pos_asc, 1, pos_rank)
    out = torch.where(j < n_neg, neg_asc,
                      torch.where(j >= valid_len - n_pos, pos_at, 0.0))
    out = torch.where(valid & torch.isfinite(out), out, 0.0)
    return out.to(torch.int64)


def _dsnot_unstructured(W, dsnot_metric, pruned0, scaler_row, var, *,
                        max_cycle_time, update_threshold,
                        pow_of_var_regrowing,
                        without_same_sign) -> DSnoTResult:
    """The unstructured regrow/prune loop.  ``pruned0`` is the initial
    True = pruned mask of the round()-count initial-metric sort."""
    units, n_in = W.shape
    dev = W.device
    # kept count: the same for every row (round(n·ratio) columns pruned)
    res_num = int((~pruned0[0]).sum())

    # regrow candidates: a stable sort of the signed metric with kept
    # columns zeroed, then de-weighted by var^pow
    metric_regrow = torch.where(pruned0, dsnot_metric, 0.0)
    err = torch.sum(metric_regrow, dim=1, keepdim=True)     # (units, 1)
    init_sign = torch.sign(err)
    if pow_of_var_regrowing:
        metric_regrow = metric_regrow / torch.pow(var[None, :],
                                                  pow_of_var_regrowing)
    regrow_order = _argsort(metric_regrow)

    # prune candidates: kept columns ascending by the Wanda metric,
    # reordered by the sign of their signed metrics
    wanda_m = torch.abs(W) * torch.sqrt(scaler_row)[None, :]
    wanda_order = _argsort(torch.where(pruned0, float("inf"), wanda_m))
    cand_vals = torch.gather(dsnot_metric, 1, wanda_order)
    prune_list = torch.gather(wanda_order, 1,
                              _reorder_indice(cand_vals, res_num))

    gptr, pptr = _pointers(units, n_in - 1, dev), _pointers(units,
                                                            res_num - 1, dev)
    pruned = pruned0.clone()
    upd = torch.ones((units, 1), dtype=torch.bool, device=dev)
    # (units, 1) columns throughout: one gather or scatter a step
    cycle = 0
    while cycle < max_cycle_time and bool(upd.any()):
        s_g = (err > 0).to(torch.int64)
        g = regrow_order.gather(1, gptr.gather(1, s_g).clamp_(0, n_in - 1))
        gm = dsnot_metric.gather(1, g)
        gptr.scatter_add_(1, s_g, 1 - 2 * s_g)

        s_p = (err < 0).to(torch.int64)
        # the prune list holds res_num entries: an exhausted pointer
        # re-reads its boundary
        p = prune_list.gather(1, pptr.gather(1, s_p).clamp_(0, res_num - 1))
        pm = dsnot_metric.gather(1, p)
        pptr.scatter_add_(1, s_p, 1 - 2 * s_p)

        upd = upd & (torch.abs(err) > update_threshold)
        if not without_same_sign:
            upd = upd & (init_sign == torch.sign(err + pm - gm))

        # every row: prune candidate kept, regrow candidate pruned
        pruned.scatter_(1, p, False)
        pruned.scatter_(1, g, True)

        err = err + torch.where(upd, pm - gm, 0.0)
        cycle += 1
    return DSnoTResult(~pruned, cycle)
