"""The pruners beyond the launcher grid, port vs the JAX package on the
CPU: the RIA metric (within 1e-6 relative), transposable n:m and hybrid
tile masks (bit-equal, ragged dims and ties included), and
``blipt5_ria_pruner`` and ``blipt5_wanda_pruner`` with ``hybrid_tile`` on
the tiny fp32 InstructBLIP-T5 through the bridge (every keep-mask
bit-equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import tiny_blip
from test_torch_pipeline import SPECS, _calib_batches, _copy_spine
from vlm_compression_tpu.compression import load_pruner as jax_load_pruner
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.ops import masks as JM
from vlm_compression_tpu_torch.compression import load_pruner
from vlm_compression_tpu_torch.models.bridge import export_masks, flatten
from vlm_compression_tpu_torch.ops import masks as TM


def _metric(seed, units, n_in, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        # few distinct values: many equal metrics, equal tile sums
        return rng.integers(0, 3, (units, n_in)).astype(np.float32)
    return rng.random((units, n_in), dtype=np.float32)


@pytest.mark.parametrize("alpha", [0.5, 1.0, 0.0])
@pytest.mark.parametrize("shape", [(12, 32), (7, 20)])
def test_ria_metric_matches_jax(shape, alpha):
    rng = np.random.default_rng(1)
    w = rng.standard_normal(shape).astype(np.float32)
    w[0, :3] = 0.0                       # a zero run inside a row
    sr = rng.random(shape[1], dtype=np.float32)
    want = np.asarray(JM.ria_metric(jnp.asarray(w), jnp.asarray(sr), alpha))
    got = TM.ria_metric(torch.from_numpy(w), torch.from_numpy(sr),
                        alpha).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,m", [(2, 4), (1, 4), (4, 8), (1, 2)])
@pytest.mark.parametrize("shape", [(8, 16), (24, 40)])
def test_transposable_nm_mask_matches_jax(shape, n, m, ties):
    met = _metric(2, *shape, ties=ties)
    want = np.asarray(JM.transposable_nm_mask(jnp.asarray(met), n, m))
    got = TM.transposable_nm_mask(torch.from_numpy(met), n, m).numpy()
    np.testing.assert_array_equal(got, want)
    # each tile row and column keeps at most m - n
    tiles = got.reshape(shape[0] // m, m, shape[1] // m, m)
    assert tiles.sum(axis=3).max() <= m - n
    assert tiles.sum(axis=1).max() <= m - n


def test_transposable_nm_mask_rejects_ragged_dims():
    with pytest.raises(ValueError, match="divisible"):
        TM.transposable_nm_mask(torch.zeros(6, 8), 2, 4)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("target", [0.5, 0.3, 0.1, 0.0])
@pytest.mark.parametrize("shape,tile", [((16, 32), 8), ((21, 36), 8),
                                        ((10, 12), 16), ((33, 64), 4)])
def test_hybrid_tile_mask_matches_jax(shape, tile, target, ties):
    met = _metric(3, *shape, ties=ties)
    want = np.asarray(JM.hybrid_tile_mask(jnp.asarray(met), target, 2, 4,
                                          tile=tile))
    got = TM.hybrid_tile_mask(torch.from_numpy(met), target, 2, 4,
                              tile=tile).numpy()
    np.testing.assert_array_equal(got, want)


def test_hybrid_tile_mask_rejects_an_unreachable_target():
    for mod in (JM, TM):
        x = jnp.ones((8, 8)) if mod is JM else torch.ones(8, 8)
        with pytest.raises(ValueError, match="unreachable"):
            mod.hybrid_tile_mask(x, 0.6, 2, 4, tile=4)


def _prune_both(name, seed, **kw):
    jm, variables, tm, _ = tiny_blip(seed=seed, masks=False)
    batches = _calib_batches(seed + 1)
    spec = dict(SPECS, **kw)
    jres, _ = jax_load_pruner(
        name, FlaxModel(jm, _copy_spine(variables)),
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
        **spec).prune(lora_model=True)
    with torch.no_grad():
        tres, _ = load_pruner(name, tm, [{k: torch.from_numpy(np.array(v))
                                          for k, v in b.items()}
                                         for b in batches],
                              **spec).prune(lora_model=True)
    want = {path[:-1]: np.asarray(m) for path, m in
            flatten(jres.variables["masks"]).items()}
    return export_masks(tres), want


@pytest.mark.parametrize("name,kw", [
    ("blipt5_ria_pruner", {}),
    ("blipt5_ria_pruner", dict(ria_alpha=1.0)),
    ("blipt5_ria_pruner", dict(prune_n=2, prune_m=4)),
    ("blipt5_wanda_pruner", dict(prune_n=2, prune_m=4, hybrid_tile=8,
                                 vit_prune_spec="2-0.7-1.0-1.0",
                                 t5_prune_spec="2-0.7-1.0-1.0")),
    ("blipt5_ria_pruner", dict(prune_n=2, prune_m=4, hybrid_tile=4,
                               vit_prune_spec="2-0.8-1.0-1.0",
                               t5_prune_spec="2-0.8-1.0-1.0")),
], ids=["ria", "ria_alpha1", "ria_2:4", "wanda_hybrid8", "ria_hybrid4"])
def test_pruner_masks_match_jax(name, kw):
    """The whole sweep on the tiny fp32 InstructBLIP-T5 (masks kept):
    every keep-mask bit-equal."""
    got, want = _prune_both(name, 71, **kw)
    assert set(got) == set(want) and len(got) == 2 * 4 + 2 * 7 + 2 * 11
    for path in want:
        np.testing.assert_array_equal(got[path], want[path],
                                      err_msg="/".join(path))
    if kw.get("hybrid_tile"):
        # some tiles dense, the rest 2:4: the overall kept share is the
        # spec's keep ratio to within the tiles' granularity
        kept = np.mean([m.mean() for m in got.values()])
        assert 0.5 < kept < 1.0


def test_ria_differs_from_wanda_on_the_same_model():
    """RIA is not Wanda under another name: on the same model and batches
    some mask bits differ."""
    ria, _ = _prune_both("blipt5_ria_pruner", 73)
    wanda, _ = _prune_both("blipt5_wanda_pruner", 73)
    assert sum(int((ria[p] != wanda[p]).sum()) for p in ria) > 0
