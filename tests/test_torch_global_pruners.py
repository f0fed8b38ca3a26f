"""The port's global pruners (``compression/pruners/global_pruner.py``)
against the JAX package's on the CPU, from the same numpy-seeded inputs.

``global_mask``, ``layerwise_mask`` and the k-th-smallest threshold (a
radix select in the port, ``jnp.sort(flat)[k - 1]`` in JAX) are held
bit-equal, ties at the threshold included; ``mag`` / ``absmag`` on the tiny
fp32 InstructBLIP-T5 in every mode (layerwise, ``is_global``,
``prune_per_model``, ``iteration = 3``): masks and zeroed kernels
bit-equal.  ``rand`` draws other numbers than JAX (``torch.Generator``, not
threefry), so its selection is held against JAX through scores injected
by a test subclass on both sides, and its own draws must replay from the
seed.  ``aobd`` and ``mezo`` run on a two-tower toy of SparseLinear
blocks (the pruners' math, not the model, is under test; the toy keeps
JAX's jits cheap): aobd scores within rtol 1e-4, MeZO with a shared
``noise_fn``, and every mask bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_first_order import (
    EPS,
    PREFIXES,
    _tbatches,
    _jbatches,
    _Toy,
    _toy,
    _toy_jax_loss,
)
from test_torch_models import tiny_blip
from test_torch_pipeline import _calib_batches, _copy_spine
from vlm_compression_tpu.compression import load_pruner as jax_load_pruner
from vlm_compression_tpu.compression.allocator import select_prunable_keys
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.compression.pruners import global_pruner as JG
from vlm_compression_tpu_torch.compression import load_pruner
from vlm_compression_tpu_torch.compression.pruners import global_pruner as TG
from vlm_compression_tpu_torch.models.bridge import export_masks, flatten

SPECS = dict(vit_prune_spec="2-0.5-1.0-1.0", t5_prune_spec="2-0.5-1.0-1.0",
             num_samples=8)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tied_scores(seed, shapes=((6, 10), (12, 4), (3, 3), (20, 7))):
    """Integer-valued scores over a few leaves: many ties at any
    threshold, negatives, and −0.0 beside +0.0."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, shape in enumerate(shapes):
        v = rng.integers(-4, 5, shape).astype(np.float32)
        v[0, 0] = -0.0
        out[f"leaf{i}"] = v
    return out


@pytest.mark.parametrize("shapes", [((6, 10), (12, 4), (3, 3), (20, 7)),
                                    ((13, 15),)], ids=["leaves", "one_leaf"])
@pytest.mark.parametrize("k", [0, 1, 2, 37, 100, 163, 194, 195])
def test_kth_smallest_is_the_sorted_concatenation(k, shapes):
    """Several leaves (the radix select) and one (a sort)."""
    scores = _tied_scores(1, shapes)
    flat = jnp.concatenate([jnp.asarray(v).ravel() for v in scores.values()])
    want = float(JG._kth_smallest_threshold(flat, k))
    got = TG.kth_smallest([_t(v) for v in scores.values()], k)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == want          # −0.0 == +0.0: the same rule v > thr
    # the defining property, counted without a sort
    if k > 0:
        s = torch.cat([_t(v).ravel() for v in scores.values()])
        assert int((s <= got).sum()) >= k > int((s < got).sum())


def test_kth_smallest_spans_the_fp32_range():
    """Values across the whole fp32 range (both infinities, subnormals,
    the extremes) in leaves of other shapes: every k."""
    rng = np.random.default_rng(2)
    vals = np.concatenate([
        rng.standard_normal(40) * 10.0 ** rng.integers(-40, 38, 40),
        [np.inf, -np.inf, 1e-45, -1e-45, 3.4e38, -3.4e38, 0.0, 0.0]])
    vals = vals.astype(np.float32)
    leaves = [vals[:13].reshape(13, 1), vals[13:].reshape(5, 7)]
    want = np.sort(vals)
    for k in range(1, vals.size + 1):
        got = TG.kth_smallest([_t(v) for v in leaves], k)
        assert np.float32(got) == want[k - 1], k


@pytest.mark.parametrize("p", [0.0, 0.25, 0.5, 0.77, 1.0])
@pytest.mark.parametrize("max_sparsity", [1.0, 0.6])
def test_global_mask_bit_equal(p, max_sparsity):
    scores = _tied_scores(3)
    want = JG.global_mask({k: jnp.asarray(v) for k, v in scores.items()}, p,
                          max_sparsity)
    got = TG.global_mask({k: _t(v) for k, v in scores.items()}, p,
                         max_sparsity)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 1.0])
def test_layerwise_mask_bit_equal(p):
    scores = _tied_scores(4)
    scores["scalar"] = np.full((1, 1), 2.5, np.float32)
    want = JG.layerwise_mask({k: jnp.asarray(v) for k, v in scores.items()},
                             p)
    got = TG.layerwise_mask({k: _t(v) for k, v in scores.items()}, p)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # a (1, 1) score prunes int(p · 1) = 0 entries below p = 1
    assert bool(got["scalar"].all()) == (p < 1.0)


def _prune_both(name, seed, jax_cls=None, port_cls=None, **kw):
    """(JAX result variables, port module) after the same prune."""
    jm, variables, tm, _ = tiny_blip(seed=seed, masks=False)
    batches = _calib_batches(seed + 1)
    jmodel = FlaxModel(jm, _copy_spine(variables))
    jb = _jbatches(batches)
    jp = (jax_cls(jmodel, jb, **SPECS, **kw) if jax_cls
          else jax_load_pruner(name, jmodel, jb, **SPECS, **kw))
    jres, jinfo = jp.prune()
    tb = _tbatches(batches)
    tp = (port_cls(tm, tb, **SPECS, **kw) if port_cls
          else load_pruner(name, tm, tb, **SPECS, **kw))
    tres, tinfo = tp.prune()
    assert tres is tm and jinfo is None and tinfo is None
    return jres.variables, tm


def _assert_same_prune(jvars, tm):
    """Every prunable kernel (44 in the tiny model) zeroed and masked as
    in JAX, bit for bit."""
    got = export_masks(tm)
    want = {path[:-1]: np.asarray(m) for path, m in
            flatten(jvars["masks"]).items()}
    assert set(got) == set(want) and len(got) == 2 * 4 + 2 * 7 + 2 * 11
    kernels = {path[:-1]: np.asarray(v) for path, v in
               flatten(jvars["params"]).items() if path[-1] == "kernel"}
    for path in want:
        np.testing.assert_array_equal(got[path], want[path],
                                      err_msg="/".join(path))
        np.testing.assert_array_equal(
            tm.get_submodule(".".join(path)).kernel.detach().numpy(),
            kernels[path], err_msg="/".join(path))


@pytest.mark.parametrize("name,kw", [
    ("blipt5_mag_pruner", {}),
    ("blipt5_mag_pruner", dict(is_global=True)),
    ("blipt5_mag_pruner", dict(is_global=True, prune_per_model=True)),
    ("blipt5_mag_pruner", dict(iteration=3)),
    ("blipt5_mag_pruner", dict(is_global=True, iteration=3)),
    ("blipt5_absmag_pruner", {}),
    ("blipt5_absmag_pruner", dict(is_global=True)),
])
def test_magnitude_pruners_match_jax(name, kw):
    jvars, tm = _prune_both(name, 71, **kw)
    _assert_same_prune(jvars, tm)
    kept = [m.float().mean() for m in
            (tm.get_submodule(".".join(p)).mask
             for p in export_masks(tm))]
    assert 0.45 <= float(torch.stack(kept).mean()) <= 0.55


def _injected(seed):
    """One fixed score tensor per prunable kernel of the tiny model."""
    _, variables, _, _ = tiny_blip(seed=seed, masks=False)
    rng = np.random.default_rng(seed + 7)
    keys = select_prunable_keys(variables["params"], PREFIXES)
    params = flatten(variables["params"])
    return {"/".join(k): rng.standard_normal(
        params[k + ("kernel",)].shape).astype(np.float32) for k in keys}


@pytest.mark.parametrize("kw", [{}, dict(is_global=True)])
def test_rand_selection_matches_jax_on_injected_scores(kw):
    scores = _injected(73)

    class JaxInjected(JG.BlipT5RandPruner):
        def compute_importance(self, variables, keys, batches):
            return {k: jnp.asarray(v) for k, v in scores.items()}

    class PortInjected(TG.BlipT5RandPruner):
        def compute_importance(self, keys, batches):
            return {k: _t(v) for k, v in scores.items()}

    jvars, tm = _prune_both(None, 73, JaxInjected, PortInjected, **kw)
    _assert_same_prune(jvars, tm)


def test_rand_replays_from_its_seed():
    """Its own draws: one seed, the same masks; another seed, others; each
    layer at 0.5 under the layerwise mode."""
    def masks(seed):
        _, _, tm, _ = tiny_blip(seed=74, masks=False)
        load_pruner("blipt5_rand_pruner", tm, _tbatches(_calib_batches(75)),
                    seed=seed, **SPECS).prune()
        return export_masks(tm)

    a, b, c = masks(3), masks(3), masks(4)
    assert all(np.array_equal(a[p], b[p]) for p in a)
    assert any(not np.array_equal(a[p], c[p]) for p in a)
    for m in a.values():
        assert m.sum() == m.size - int(0.5 * m.size)


class _ToyModel(_Toy):
    """The toy's loss as the pruners read it: model(**batch)["loss"]."""

    def forward(self, x, y):
        return {"loss": torch.mean((super().forward(x) - y) ** 2)}


class _JaxToy:
    def apply(self, variables, **batch):
        return {"loss": _toy_jax_loss(variables, batch)}


def _toy_prune(name, seed, **kw):
    """(JAX pruner, port pruner, JAX variables, toy): the same toy weights
    and batches; MeZO's z from one shared ``noise_fn``."""
    params, batches, noise_fn = _toy(seed)
    if name == "blipt5_mezo_pruner":
        kw["noise_fn"] = noise_fn
    spec = dict(vit_prune_spec="2-0.5-1.0-1.0",
                t5_prune_spec="2-0.5-1.0-1.0", num_samples=6,
                noise_eps=EPS, num_noise=2, **kw)
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    jp = jax_load_pruner(name, FlaxModel(_JaxToy(), jvars),
                         _jbatches(batches), **spec)
    toy = _ToyModel(params)
    tp = load_pruner(name, toy, _tbatches(batches), **spec)
    return jp, tp, jvars, toy


def _assert_toy_prune(jres, toy):
    masks = flatten(jres.variables["masks"])
    for path, want in flatten(jres.variables["params"]).items():
        lin = toy.get_submodule(".".join(path[:-1]))
        np.testing.assert_array_equal(lin.kernel.detach().numpy(),
                                      np.asarray(want), err_msg=str(path))
        np.testing.assert_array_equal(
            lin.mask.numpy(), np.asarray(masks[path[:-1] + ("mask",)]),
            err_msg=str(path))


@pytest.mark.parametrize("kw", [{}, dict(is_global=True), dict(iteration=2)])
def test_aobd_matches_jax(kw):
    """|W|·mean|g| within rtol 1e-4 (fp32 gradients of the same loss);
    masks and zeroed kernels bit-equal; only the kernels were asked for
    gradients, and every requires_grad flag comes back."""
    jp, tp, jvars, toy = _toy_prune("blipt5_aobd_pruner", 81, **kw)
    keys = select_prunable_keys(jvars["params"], PREFIXES)
    batches = tp.batches()
    want = jp.compute_importance(jvars, keys, jp.batches())
    got = tp.compute_importance(keys, batches)
    assert set(got) == set(want) and len(got) == 8
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-9, err_msg=k)
    flags = {n: p.requires_grad for n, p in toy.named_parameters()}
    toy.blocks[0].fc1.kernel.requires_grad_(False)
    jres, _ = jp.prune()
    tp.prune()
    assert not toy.blocks[0].fc1.kernel.requires_grad
    toy.blocks[0].fc1.kernel.requires_grad_(True)
    assert {n: p.requires_grad for n, p in toy.named_parameters()} == flags
    assert all(p.grad is None for p in toy.parameters())
    _assert_toy_prune(jres, toy)


@pytest.mark.parametrize("kw", [{}, dict(is_global=True),
                                dict(is_global=True, prune_per_model=True)])
def test_mezo_matches_jax_under_shared_noise(kw):
    """One scalar per layer from the same z (ε = 5e-2: the projected
    gradient cancels in fp32): the same layers kept, bit for bit.  The
    layerwise mode keeps every layer whole; the global modes drop whole
    layers."""
    jp, tp, jvars, toy = _toy_prune("blipt5_mezo_pruner", 82, **kw)
    keys = select_prunable_keys(jvars["params"], PREFIXES)
    want = jp.compute_importance(jvars, keys, jp.batches())
    got = tp.compute_importance(keys, tp.batches())
    for k in want:
        assert got[k].shape == (1, 1)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-3, err_msg=k)
    before = {n: p.detach().clone() for n, p in toy.named_parameters()}
    jres, _ = jp.prune()
    tp.prune()
    _assert_toy_prune(jres, toy)
    kept = [bool(toy.get_submodule(".".join(k)).mask.all()) for k in keys]
    dropped = [not bool(toy.get_submodule(".".join(k)).mask.any())
               for k in keys]
    assert all(a or b for a, b in zip(kept, dropped))    # whole layers
    if kw:
        # 4 of 8 layers (per model: 2 of each tower's 4)
        assert sum(dropped) == 4
    else:
        assert all(kept)
        for n, p in toy.named_parameters():
            assert torch.equal(p, before[n]), n
