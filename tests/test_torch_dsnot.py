"""The port's DSnoT refinement (``ops/dsnot.py``) and its pruners against
the JAX package on the CPU: the same numpy-seeded inputs through
``vlm_compression_tpu.ops.dsnot`` and the port.  Masks and cycle counts
must be bit-equal in every case (no tolerance): unstructured and n:m, the
wanda, magnitude and sparsegpt initial metrics, ``without_dsnot``,
``pow_of_var_regrowing`` 0 and 1, ``without_same_sign`` both ways, and a
block driven to all +inf at each width of the tie table."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import tiny_blip
from test_torch_pipeline import SPECS, _calib_batches, _copy_spine
from vlm_compression_tpu.compression import load_pruner as jax_load_pruner
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.ops import dsnot as JD
from vlm_compression_tpu_torch.compression import load_pruner
from vlm_compression_tpu_torch.models.bridge import export_masks, flatten
from vlm_compression_tpu_torch.ops import dsnot as TD


def _inputs(seed, units=12, n_in=48, positive=False):
    """(W unit-major, scaler_row, sum_metric_row, var, hessian).  With
    ``positive`` every weight and mean activation is positive, so in an
    n:m block the kept minimum outweighs every pruned entry: each row's
    error grows, the rows keep updating, and the pointers walk off the
    regrow list and consume whole blocks."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((units, n_in)).astype(np.float32)
    x = rng.standard_normal((4 * n_in, n_in)).astype(np.float32)
    summ = rng.standard_normal(n_in).astype(np.float32) * 0.5
    if positive:
        W, summ = np.abs(W), np.abs(summ) + 0.1
    scaler = (x * x).mean(0).astype(np.float32) + 0.05
    var = (rng.random(n_in) + 0.2).astype(np.float32)
    hess = (2.0 / x.shape[0] * x.T @ x).astype(np.float32)
    return W, scaler, summ, var, hess


def _both(inputs, sparsity=0.5, **kw):
    W, scaler, summ, var, hess = inputs
    hk = kw.get("initial_method") == "sparsegpt"
    want = JD.dsnot_refine_mask(
        *(jnp.asarray(a) for a in (W, scaler, summ, var)), sparsity,
        hessian=jnp.asarray(hess) if hk else None, **kw)
    got = TD.dsnot_refine_mask(
        *(torch.from_numpy(a) for a in (W, scaler, summ, var)), sparsity,
        hessian=torch.from_numpy(hess) if hk else None, **kw)
    return want, got


def _assert_equal(want, got):
    assert got.keep_mask.dtype == torch.bool
    np.testing.assert_array_equal(got.keep_mask.numpy(),
                                  np.asarray(want.keep_mask))
    assert got.cycles == int(want.cycles)


def test_return_reorder_indice_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 11)).astype(np.float32)
    x[1, 3] = x[2, :4] = 0.0
    want = np.asarray(JD.return_reorder_indice(jnp.asarray(x)))
    np.testing.assert_array_equal(
        TD.return_reorder_indice(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("valid_len", [1, 5, 9, 11])
def test_reorder_indice_over_a_prefix_matches_jax(valid_len):
    rng = np.random.default_rng(valid_len)
    x = rng.standard_normal((5, 11)).astype(np.float32)
    x[0, :3] = 0.0
    want = np.asarray(JD._reorder_indice(jnp.asarray(x), valid_len))
    np.testing.assert_array_equal(
        TD._reorder_indice(torch.from_numpy(x), valid_len).numpy(), want)


@pytest.mark.parametrize("initial_method", ["wanda", "magnitude", "sparsegpt"])
@pytest.mark.parametrize("pow_of_var", [0.0, 1.0])
@pytest.mark.parametrize("without_same_sign", [True, False])
def test_unstructured_matches_jax(initial_method, pow_of_var,
                                  without_same_sign):
    want, got = _both(_inputs(1), 0.5, initial_method=initial_method,
                      pow_of_var_regrowing=pow_of_var,
                      without_same_sign=without_same_sign,
                      update_threshold=0.01)
    _assert_equal(want, got)
    assert got.cycles > 0


@pytest.mark.parametrize("sparsity", [0.3, 0.5, 0.7])
def test_unstructured_without_dsnot_is_the_initial_mask(sparsity):
    """The round()-count initial mask: 0.3 × 48 = 14.4 prunes 14."""
    want, got = _both(_inputs(2), sparsity, without_dsnot=True)
    _assert_equal(want, got)
    assert got.cycles == 0
    assert int((~got.keep_mask[0]).sum()) == round(48 * sparsity)


@pytest.mark.parametrize("max_cycle_time", [1, 3, 50])
def test_unstructured_stops_where_jax_does(max_cycle_time):
    """The cycle cap: one cycle more changes the mask, so the loop must
    end on the JAX loop's cycle."""
    want, got = _both(_inputs(3), 0.5, max_cycle_time=max_cycle_time,
                      update_threshold=0.01)
    _assert_equal(want, got)
    assert got.cycles == max_cycle_time


@pytest.mark.parametrize("initial_method", ["wanda", "magnitude", "sparsegpt"])
@pytest.mark.parametrize("n,m", [(2, 4), (4, 8)])
@pytest.mark.parametrize("pow_of_var", [0.0, 1.0])
def test_nm_matches_jax(initial_method, n, m, pow_of_var):
    want, got = _both(_inputs(4), 0.5, prune_n=n, prune_m=m,
                      initial_method=initial_method,
                      pow_of_var_regrowing=pow_of_var, update_threshold=0.01)
    _assert_equal(want, got)
    assert got.cycles > 0


@pytest.mark.parametrize("m", sorted(TD._TORCH_TOPK_TIE_IDX))
def test_nm_all_inf_block_takes_the_tie_table(m, monkeypatch):
    """Blocks driven to all +inf at each width of the tie table: bit-equal
    to JAX; where the table's index is not argmin's 0, the same run with
    argmin's index gives another mask, so the case reaches the table."""
    n = max(m // 2, 1)
    inputs = _inputs(5, units=6, n_in=2 * m, positive=True)
    kw = dict(prune_n=n, prune_m=m, max_cycle_time=6 * m,
              update_threshold=0.01)
    want, got = _both(inputs, 0.5, **kw)
    _assert_equal(want, got)
    if TD._TORCH_TOPK_TIE_IDX[m]:
        monkeypatch.setattr(TD, "_TORCH_TOPK_TIE_IDX", {})
        _, other = _both(inputs, 0.5, **kw)
        assert not torch.equal(other.keep_mask, got.keep_mask)


@pytest.mark.parametrize("name,kw", [
    ("blipt5_dsnot_pruner", {}),
    ("blipt5_dsnot_pruner", dict(prune_n=2, prune_m=4)),
    ("blipt5_dsnot_pruner", dict(initial_method="sparsegpt")),
])
def test_blipt5_dsnot_pruner_matches_jax(name, kw):
    """The whole sweep on the tiny fp32 InstructBLIP-T5 (masks kept):
    every keep-mask bit-equal."""
    jm, variables, tm, _ = tiny_blip(seed=61, masks=False)
    batches = _calib_batches(62)
    spec = dict(SPECS, update_threshold=0.01, **kw)
    jres, _ = jax_load_pruner(
        name, FlaxModel(jm, _copy_spine(variables)),
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
        **spec).prune(lora_model=True)
    with torch.no_grad():
        tres, _ = load_pruner(name, tm, [{k: torch.from_numpy(np.array(v))
                                          for k, v in b.items()}
                                         for b in batches],
                              **spec).prune(lora_model=True)
    got = export_masks(tres)
    want = {path[:-1]: np.asarray(m) for path, m in
            flatten(jres.variables["masks"]).items()}
    assert set(got) == set(want) and len(got) == 2 * 4 + 2 * 7 + 2 * 11
    for path in want:
        np.testing.assert_array_equal(got[path], want[path],
                                      err_msg="/".join(path))
