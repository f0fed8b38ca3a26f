"""Distributed pruning of the port (``compression/calibrate.py`` over a
mesh) vs the JAX package's unsharded prune on the CPU: the tiny fp32
InstructBLIP-T5's ``blipt5_wanda_pruner`` and ``blipt5_sparsegpt_pruner``
in 4 gloo ranks at (data 2, model 2) — each data rank calibrates half of
every batch, the statistics are summed over data, kernels split on their
units over model — against JAX's prune of the whole batches.

Bounds, the JAX package's own (``tests/test_sharded_prune.py`` and the
multichip dry run):
- Wanda: masks bit-equal up to at most 4 flipped bits per linear, each a
  metric tie (spread ≤ 1e-5 of its unit's largest flipped value), with
  every unit's keep count equal;
- SparseGPT: at most 6 % of each linear's bits flipped, its density within
  0.02 of JAX's, its layerwise OBS error ‖X·(W'⊙M − W₀)‖² on the original
  model's calibration inputs ≤ 1.10 × JAX's (+1e-8), and the model's
  loss on the calibration batches within 1 % of JAX's.

The norms' scales and biases are drawn (1 + 0.2·N, 0.2·N) instead of
their init (1, 0): with a unit-scale, zero-bias LayerNorm every token's
features sum to zero, so the ViT qkv's Hessian is singular to fp32
precision (its smallest eigenvalue 1e-7 of its largest), and the OBS
inverse — undamped unless the factorization fails, in both packages —
turns the data ranks' other summation order into flips that are not ties
(OBS error ±40 %).  The JAX package's own test runs bf16 weights, whose
rounding breaks that null direction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_models import blip_batch, tiny_blip, tiny_blip_configs
from torch_parallel_ranks import train_rank
from vlm_compression_tpu.compression import load_pruner
from vlm_compression_tpu.compression.pruners.base import FlaxModel
from vlm_compression_tpu_torch.models.bridge import flatten
from vlm_compression_tpu_torch.parallel.collectives import spawn
from vlm_compression_tpu_torch.parallel.dryrun import flip_ties

PRUNERS = ("blipt5_wanda_pruner", "blipt5_sparsegpt_pruner")
SPECS = dict(vit_prune_spec="2-0.5-1.0-1.0", t5_prune_spec="2-0.5-1.0-1.0",
             num_samples=16)


def _copy_spine(node):
    """The JAX engine pops block subtrees from the tree it is given."""
    if isinstance(node, dict):
        return {k: _copy_spine(v) for k, v in node.items()}
    return jnp.asarray(node)


def _batches(seed):
    rng = np.random.default_rng(seed)
    jcfg, _ = tiny_blip_configs()
    return [blip_batch(rng, jcfg, b=8, txt=6, lbl=4) for _ in range(2)]


def _jax_prune(name, jm, variables, batches):
    sink = {}
    p = load_pruner(name, FlaxModel(jm, _copy_spine(variables)),
                    [{k: jnp.asarray(v) for k, v in b.items()}
                     for b in batches], **SPECS)
    p._stats_sink = sink
    res, _ = p.prune(lora_model=True)
    masks = {"/".join(path[:-1]): np.asarray(m)
             for path, m in flatten(res.variables["masks"]).items()}
    return res.variables, masks, sink


def _drawn_norms(variables, seed):
    """Every norm's scale at 1 + 0.2·N and its bias at 0.2·N."""
    rng = np.random.default_rng(seed)

    def walk(node, path=()):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif k == "scale":
                out[k] = (1.0 + 0.2 * rng.standard_normal(np.shape(v))
                          ).astype(np.float32)
            elif k == "bias" and any("norm" in p or "ln" in p
                                     for p in path[-1:]):
                out[k] = (0.2 * rng.standard_normal(np.shape(v))
                          ).astype(np.float32)
            else:
                out[k] = v
        return out

    return dict(variables, params=walk(variables["params"]))


@pytest.fixture(scope="module")
def pruned(tmp_path_factory):
    jm, variables, _, _ = tiny_blip(seed=61, masks=False)
    variables = _drawn_norms(variables, 63)
    batches = _batches(62)
    tcfg = tiny_blip_configs()[1]
    cases = [("prune", (tcfg, variables, batches, dict(data=2, model=2),
                        name, SPECS)) for name in PRUNERS]
    ranks = spawn(train_rank, 4, "gloo",
                  str(tmp_path_factory.mktemp("prune") / "init"), 60.0,
                  args=(cases,))
    ref = {name: _jax_prune(name, jm, variables, batches)
           for name in PRUNERS}
    return jm, variables, batches, ranks, ref


def test_masks_are_whole_and_equal_on_every_rank(pruned):
    _, _, _, ranks, ref = pruned
    for i, name in enumerate(PRUNERS):
        want = ref[name][1]
        for rank in ranks:
            got = rank[i]["masks"]
            assert set(got) == set(want) and len(want) == 2 * 4 + 2 * 7 + \
                2 * 11
            for k in got:
                assert got[k].shape == want[k].shape
                np.testing.assert_array_equal(got[k], ranks[0][i]["masks"][k])


def test_sharded_wanda_masks_match_jax_up_to_metric_ties(pruned):
    _, _, _, ranks, ref = pruned
    _, want, sink = ref["blipt5_wanda_pruner"]
    got = ranks[0][0]["masks"]
    for k in want:
        kern, scaler, _ = sink[k]
        metric = (np.abs(kern.T.astype(np.float64))
                  * np.sqrt(scaler.astype(np.float64))[None, :])
        flipped = flip_ties(got[k].T, want[k].T, metric)
        assert flipped <= 4, (k, flipped)
        np.testing.assert_array_equal(got[k].sum(0), want[k].sum(0),
                                      err_msg=k)


def _calib_hessians(jm, variables, batches):
    """Σ XᵀX of every linear's input on the original model (JAX's sow)."""
    hessians = {}
    for b in batches:
        _, aux = jm.apply(variables, **{k: jnp.asarray(v)
                                        for k, v in b.items()},
                          mutable=["calib"])

        def walk(node, path=()):
            for k, v in node.items():
                if k == "input":
                    for x in v:
                        X = np.asarray(x, np.float64).reshape(-1, x.shape[-1])
                        key = "/".join(path)
                        hessians[key] = hessians.get(key, 0.0) + X.T @ X
                elif isinstance(v, dict):
                    walk(v, path + (k,))

        walk(dict(aux)["calib"])
    return hessians


def _tree_at(tree, key):
    node = tree
    for p in key.split("/"):
        node = node[p]
    return node


def _with(variables, kernels, masks):
    """The JAX variables with the port's pruned kernels and masks."""
    out = jax.tree_util.tree_map(np.asarray, dict(variables))
    params = jax.tree_util.tree_map(lambda x: x, out["params"])
    mtree = {}
    for k, m in masks.items():
        _tree_at(params, k)["kernel"] = np.asarray(kernels[k], np.float32)
        node = mtree
        for p in k.split("/"):
            node = node.setdefault(p, {})
        node["mask"] = m
    return dict(out, params=params, masks=mtree)


def test_sharded_sparsegpt_matches_jax_within_its_bounds(pruned):
    jm, variables, batches, ranks, ref = pruned
    jvars, want, _ = ref["blipt5_sparsegpt_pruner"]
    got, kernels = ranks[0][1]["masks"], ranks[0][1]["kernels"]
    hessians = _calib_hessians(jm, variables, batches)
    for k in want:
        frac = float(np.mean(got[k] != want[k]))
        assert frac <= 0.06, (k, frac)
        assert abs(got[k].mean() - want[k].mean()) <= 0.02, k
        w0 = np.asarray(_tree_at(variables["params"], k)["kernel"],
                        np.float64)

        def err(w, m):
            dw = np.asarray(w, np.float64) * m - w0
            return float(np.einsum("io,ij,jo->", dw, hessians[k], dw))

        e_ref = err(_tree_at(jvars["params"], k)["kernel"], want[k])
        e_sh = err(kernels[k], got[k])
        assert e_sh <= 1.10 * e_ref + 1e-8, (k, e_ref, e_sh)

    def model_loss(v):
        return np.mean([float(jm.apply(_copy_spine(v), **{
            kk: jnp.asarray(vv) for kk, vv in b.items()})["loss"])
            for b in batches])

    l_ref = model_loss(jax.tree_util.tree_map(np.asarray, dict(jvars)))
    l_sh = model_loss(_with(variables, kernels, got))
    assert abs(l_sh - l_ref) / max(abs(l_ref), 1e-9) < 1e-2, (l_ref, l_sh)
