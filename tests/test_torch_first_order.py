"""The port's gradient-scoring slice vs the JAX package on the CPU: the
LayerSparsity allocator (first-order sums, the waterfilling, OWL counts,
both MeZO scorers under injected noise), ``blipt5_wanda_pruner`` with a
block-granular ``aobd_sum`` allocation (ratios and masks), and the
diagonal-Fisher route (``get_data_derivative`` for every leaf, the
``unstrct`` ``prune_by_importance``).

Tiny fp32 InstructBLIP-T5 with shared parameters (the weight bridge); the
JAX model runs its plain reference path (flash attention "auto" is the
reference on the CPU).  Tolerances are stated at each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import blip_batch, tiny_blip, tiny_blip_configs
from test_torch_pipeline import _calib_batches, _copy_spine
from vlm_compression_tpu.compression import allocator as JAL
from vlm_compression_tpu.compression import derivatives as JD
from vlm_compression_tpu.compression import distill_merge as JDM
from vlm_compression_tpu.compression import load_pruner as jax_load_pruner
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu_torch.compression import allocator as TAL
from vlm_compression_tpu_torch.compression import derivatives as TD
from vlm_compression_tpu_torch.compression import distill_merge as TDM
from vlm_compression_tpu_torch.compression import load_pruner
from vlm_compression_tpu_torch.models.bridge import export_masks, flatten
from vlm_compression_tpu_torch.models.layers import SparseLinear
from vlm_compression_tpu_torch.ops import attention as TA

PREFIXES = ("visual_encoder", "t5_model")


def _t(x):
    return torch.from_numpy(np.array(x))


def _jbatches(batches):
    return [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]


def _tbatches(batches):
    return [{k: _t(v) for k, v in b.items()} for b in batches]


@pytest.fixture
def dbias_calls(monkeypatch):
    """Counts the plain dbias's calls: the CPU route of the dbias kernel."""
    calls = []
    ref = TA.flash_attention_dbias_ref

    def counted(*a, **kw):
        calls.append(tuple(a[6][a[7]].shape))
        return ref(*a, **kw)

    monkeypatch.setattr(TA, "flash_attention_dbias_ref", counted)
    return calls


@pytest.fixture(scope="module")
def tiny():
    """(jax module, jax variables, port module, calibration batches): two
    batches of 4 samples."""
    jm, variables, tm, _ = tiny_blip(seed=41, masks=False)
    return jm, variables, tm, _calib_batches(42, n=2, bs=4)


# ------------------------------------------------------------- allocator


def test_prunable_keys_and_groups_match_jax(tiny):
    _, variables, tm, _ = tiny
    want = JAL.select_prunable_keys(variables["params"], PREFIXES)
    got = TAL.select_prunable_keys(tm, PREFIXES)
    assert got == want and len(got) == 2 * 4 + 2 * 7 + 2 * 11
    for gran in ("model", "block", "layer"):
        assert TAL.build_group_mapping(got, gran) == \
            JAL.build_group_mapping(want, gran)


@pytest.mark.parametrize("compute", ["obd", "aobd", "aobd-strict",
                                     "gradient"])
def test_first_order_sums_match_jax(tiny, dbias_calls, compute):
    """Per-key sums over the allocator's 8 samples, rtol 1e-4 (fp32
    gradients of the same loss, summed in other orders).  Autograd forms
    only the kernels' gradients: no bias gradient (no dbias), and every
    requires_grad flag comes back."""
    jm, variables, tm, batches = tiny
    kw = dict(original_sparsity=0.5, score_method=f"{compute}_sum",
              num_data=8, prefixes=PREFIXES)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jls = JAL.LayerSparsity(FlaxModel(jm, jvars), _jbatches(batches), **kw)
    keys = JAL.select_prunable_keys(variables["params"], PREFIXES)
    want = jls._score_first_order(jvars, keys)
    flags = {n: p.requires_grad for n, p in tm.named_parameters()}
    tm.t5_model.shared.embedding.requires_grad_(False)
    tls = TAL.LayerSparsity(tm, _tbatches(batches), **kw)
    got = tls._score_first_order(keys)
    assert not tm.t5_model.shared.embedding.requires_grad
    tm.t5_model.shared.embedding.requires_grad_(True)
    assert {n: p.requires_grad for n, p in tm.named_parameters()} == flags
    assert dbias_calls == []
    assert all(p.grad is None for p in tm.parameters())
    for k in keys:
        assert got[k] == pytest.approx(want[k], rel=1e-4), "/".join(k)


@pytest.mark.parametrize("reference_fixups", [False, True])
@pytest.mark.parametrize("case", ["spread", "clamped", "zeros"])
def test_sparsity_per_group_bit_equal(reference_fixups, case):
    """The same sums give the same ratios, bit for bit."""
    rng = np.random.default_rng(5)
    names = [f"g{i}" for i in range(12)]
    nparams = {n: int(rng.integers(100, 5000)) for n in names}
    scores = {n: float(rng.random()) for n in names}
    if case == "clamped":     # one group takes almost everything
        scores["g3"] = 1e4
    elif case == "zeros":
        scores = {n: (0.0 if i % 3 else s) for i, (n, s) in
                  enumerate(scores.items())}
    total = int(sum(nparams.values()) * 0.4)
    args = (total, scores, nparams, 0.8)
    got = TAL.compute_the_sparsity_per_group(
        *args, reference_fixups=reference_fixups)
    want = JAL.compute_the_sparsity_per_group(
        *args, reference_fixups=reference_fixups)
    assert got == want


def test_owl_counts_match_jax(tiny):
    """Outlier counts of |W|·sqrt(ΣX²) per key: equal."""
    jm, variables, tm, batches = tiny
    kw = dict(original_sparsity=0.5, score_method="owl_sum", num_data=8,
              prefixes=PREFIXES, owl_m=2.0)
    # without the activations init sowed: the scorer reads the first sown
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray,
                                              variables["params"])}
    keys = JAL.select_prunable_keys(variables["params"], PREFIXES)
    want = JAL.LayerSparsity(FlaxModel(jm, jvars), _jbatches(batches),
                             **kw)._score_owl(jvars, keys)
    got = TAL.LayerSparsity(tm, _tbatches(batches), **kw)._score_owl(keys)
    assert {k: float(v) for k, v in want.items()} == got
    assert sum(got.values()) > 0


# MeZO on a two-tower toy of SparseLinear blocks (the estimator's math, not
# the model, is under test; the toy keeps JAX's per-leaf jits cheap), with
# every z injected.  The projected gradient (l₊ − l₋)/2ε cancels in fp32,
# and lmezo sums it with its sign over noises before |·|: ε = 5e-2 and
# rtol 2e-3 (the largest difference seen at this seed is 3.5e-4).
D_TOY, F_TOY, EPS = 6, 10, 5e-2


class _ToyBlock(torch.nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.names = (a, b)
        self.add_module(a, SparseLinear(D_TOY, F_TOY, use_bias=False))
        self.add_module(b, SparseLinear(F_TOY, D_TOY, use_bias=False))

    def forward(self, h):
        a, b = (getattr(self, n) for n in self.names)
        return h + torch.tanh(b(torch.relu(a(h))))


class _Toy(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.visual_encoder = torch.nn.Module()
        self.t5_model = torch.nn.Module()
        self.t5_model.encoder = torch.nn.Module()
        self.blocks = []
        for tower, names in ((self.visual_encoder, ("fc1", "fc2")),
                             (self.t5_model.encoder, ("wi", "wo"))):
            for i in range(2):
                blk = _ToyBlock(*names)
                tower.add_module(f"blocks_{i}", blk)
                self.blocks.append(blk)
        with torch.no_grad():
            for path, leaf in flatten(params).items():
                self.get_parameter(".".join(path)).copy_(_t(leaf))

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


def _toy_jax_loss(variables, batch):
    p = variables["params"]
    h = batch["x"]
    for tower, (a, b) in ((p["visual_encoder"], ("fc1", "fc2")),
                          (p["t5_model"]["encoder"], ("wi", "wo"))):
        for i in range(2):
            node = tower[f"blocks_{i}"]
            h = h + jnp.tanh(jnp.maximum(h @ node[a]["kernel"], 0.0)
                             @ node[b]["kernel"])
    return jnp.mean((h - batch["y"]) ** 2)


def _toy_torch_loss(model, batch):
    return torch.mean((model(batch["x"]) - batch["y"]) ** 2)


def _toy(seed):
    rng = np.random.default_rng(seed)
    params = {}
    for tower, names in ((("visual_encoder",), ("fc1", "fc2")),
                         (("t5_model", "encoder"), ("wi", "wo"))):
        node = params
        for t in tower:
            node = node.setdefault(t, {})
        for i in range(2):
            node[f"blocks_{i}"] = {
                names[0]: {"kernel": rng.standard_normal(
                    (D_TOY, F_TOY)).astype(np.float32) * 0.5},
                names[1]: {"kernel": rng.standard_normal(
                    (F_TOY, D_TOY)).astype(np.float32) * 0.5}}
    batches = [{"x": rng.standard_normal((2, D_TOY)).astype(np.float32),
                "y": rng.standard_normal((2, D_TOY)).astype(np.float32)}
               for _ in range(3)]
    noise = {}

    def noise_fn(tag, key, shape):
        if (tag, key) not in noise:
            noise[(tag, key)] = rng.standard_normal(shape).astype(np.float32)
        return noise[(tag, key)]

    return params, batches, noise_fn


class _JaxHolder:
    def __init__(self, variables):
        self.variables = variables
        self.module = None


@pytest.mark.parametrize("method", ["mezo-aobd_avg", "mezo-obd_sum",
                                    "lmezo-obd_avg", "olmezo-gradient_sum",
                                    "lmezo-aobd_sum"])
def test_mezo_scorers_match_jax_under_injected_noise(method):
    params, batches, noise_fn = _toy(7)
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    kw = dict(original_sparsity=0.5, granularity="layer",
              score_method=method, num_data=6, num_noise=2, noise_eps=EPS,
              prefixes=PREFIXES, noise_fn=noise_fn)
    keys = JAL.select_prunable_keys(jvars["params"], PREFIXES)
    jls = JAL.LayerSparsity(_JaxHolder(jvars), _jbatches(batches),
                            loss_fn=_toy_jax_loss, **kw)
    toy = _Toy(params)
    tls = TAL.LayerSparsity(toy, _tbatches(batches), loss_fn=_toy_torch_loss,
                            **kw)
    assert TAL.select_prunable_keys(toy, PREFIXES) == keys
    if method.startswith("mezo"):
        want = jls._score_mezo_diff(jvars, keys)
        got = tls._score_mezo_diff(keys)
    else:
        want = jls._score_mezo_layer(jvars, keys)
        got = tls._score_mezo_layer(keys)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=1e-10,
                                   err_msg="/".join(k))
    # the kernels are back at their values
    for path, leaf in flatten(params).items():
        np.testing.assert_array_equal(
            toy.get_parameter(".".join(path)).detach().numpy(), leaf)


def test_mezo_seeded_noise_replays():
    """Without injection the port draws z from seeded generators: the same
    seed gives the same scores, another seed others."""
    params, batches, _ = _toy(8)
    toy = _Toy(params)
    kw = dict(original_sparsity=0.5, granularity="layer",
              score_method="mezo-gradient_sum", num_data=6, noise_eps=EPS,
              prefixes=PREFIXES, loss_fn=_toy_torch_loss)
    keys = TAL.select_prunable_keys(toy, PREFIXES)
    a, b, c = (TAL.LayerSparsity(toy, _tbatches(batches), seed=s,
                                 **kw)._score_mezo_diff(keys)
               for s in (3, 3, 4))
    assert a == b and a != c


# -------------------------------------------------------- path A: EcoFLaP


def test_blipt5_wanda_block_aobd_allocation_matches_jax():
    """``blipt5_wanda_pruner`` with sparsity_ratio_granularity="block" and
    score_method="aobd_sum": the per-key ratios equal JAX's, and every
    mask bit-equal."""
    jm, variables, tm, _ = tiny_blip(seed=43, masks=False)
    batches = _calib_batches(44, n=2, bs=4)
    spec = dict(vit_prune_spec="2-0.5-1.0-1.0", t5_prune_spec="2-0.5-1.0-1.0",
                num_samples=8, sparsity_ratio_granularity="block",
                score_method="aobd_sum", num_data_first_stage=4)
    jres, jratios = jax_load_pruner(
        "blipt5_wanda_pruner", FlaxModel(jm, _copy_spine(variables)),
        _jbatches(batches), **spec).prune(lora_model=True)
    with torch.no_grad():
        tres, tratios = load_pruner("blipt5_wanda_pruner", tm,
                                    _tbatches(batches),
                                    **spec).prune(lora_model=True)
    assert tratios == jratios
    assert len(set(tratios.values())) > 1          # not uniform
    assert all(0.0 <= r <= 0.8 for r in tratios.values())
    got = export_masks(tres)
    want = {path[:-1]: np.asarray(m) for path, m in
            flatten(jres.variables["masks"]).items()}
    assert set(got) == set(want) and len(got) == 2 * 4 + 2 * 7 + 2 * 11
    for path in want:
        np.testing.assert_array_equal(got[path], want[path],
                                      err_msg="/".join(path))


# ------------------------------------------------- path B: diagonal Fisher


def test_data_derivative_matches_jax_every_leaf(tiny, dbias_calls):
    """Mean |g|² over three batch-1 samples, every parameter leaf (both
    rel_embeddings included): within 5e-5 of the leaf's largest entry
    (fp32 gradients summed in other orders, squared; the largest difference
    seen is 7e-6), and for leaves whose gradient is 0 in exact arithmetic
    (the Q-Former's key biases: softmax ignores a shift of a row's scores)
    within 5e-11 of the largest entry of all, their roundoff.  Each sample
    runs the dbias of the position bias in each of T5's 2 + 2
    self-attentions."""
    jm, variables, tm, _ = tiny
    jcfg, _ = tiny_blip_configs()
    rng = np.random.default_rng(45)
    three = blip_batch(rng, jcfg, b=3, txt=5, lbl=4)
    batches = [{k: v[i:i + 1] for k, v in three.items()} for i in range(3)]
    want = {p: np.asarray(w) for p, w in flatten(JD.get_data_derivative(
        jm, jax.tree_util.tree_map(jnp.asarray, variables),
        _jbatches(batches), power=2)).items()}
    flags = {n: p.requires_grad for n, p in tm.named_parameters()}
    got = TD.get_data_derivative(tm, _tbatches(batches), power=2)
    assert {n: p.requires_grad for n, p in tm.named_parameters()} == flags
    assert len(dbias_calls) == 3 * 4
    assert set(got) == set(want)
    for path in (("t5_model", "encoder", "rel_bias", "rel_embedding"),
                 ("t5_model", "decoder", "rel_bias", "rel_embedding")):
        assert bool(got[path].gt(0).any()), path
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        g = got[path].numpy()
        assert g.dtype == np.float32 and (g >= 0).all()
        np.testing.assert_allclose(
            g, w, rtol=0, atol=5e-5 * max(float(np.abs(w).max()), 1e-6 * top),
            err_msg="/".join(path))


def test_activations_match_jax(tiny):
    """Per-linear mean squared input activation (the Wanda statistic) and
    its importance forms: rtol 1e-5."""
    jm, variables, tm, batches = tiny
    # without the activations init sowed: the JAX fold reads the first sown
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray,
                                              variables["params"])}
    want = JD.get_activations(jm, jvars, _jbatches(batches))
    got = TD.get_activations(tm, _tbatches(batches))
    assert set(got) == set(want)
    for square in (True, False):
        w_imp = JD.convert_activation_to_importance(want, square)
        g_imp = TD.convert_activation_to_importance(got, square)
        for path in want:
            np.testing.assert_allclose(g_imp[path].numpy(),
                                       np.asarray(w_imp[path]), rtol=1e-5,
                                       atol=1e-7, err_msg="/".join(path))


@pytest.mark.parametrize("keep_ratio", [0.5, 0.3, 1.0])
def test_prune_by_importance_same_index_sets(keep_ratio):
    """Tie-free scores over every leaf of the tiny T5 tower: the same
    indices zeroed, the same parameters after, the same counts."""
    _, variables, tm, _ = tiny_blip(seed=46, masks=False)
    rng = np.random.default_rng(47)
    t5 = flatten(variables["params"]["t5_model"])
    scores = {p: rng.permutation(np.asarray(v).size).reshape(
        np.shape(v)).astype(np.float32) for p, v in t5.items()}
    jparams, jidx = JDM.prune_by_importance(
        variables["params"]["t5_model"],
        {p: jnp.asarray(s) for p, s in scores.items()}, keep_ratio)
    module, tidx = TDM.prune_by_importance(
        tm.t5_model, {p: _t(s) for p, s in scores.items()}, keep_ratio)
    assert module is tm.t5_model
    assert set(tidx) == set(jidx)
    for p in jidx:
        np.testing.assert_array_equal(tidx[p].numpy(), jidx[p])
    got = {tuple(n.split(".")): v.detach().numpy()
           for n, v in tm.t5_model.named_parameters()}
    for p, v in flatten(jparams).items():
        np.testing.assert_array_equal(got[p], np.asarray(v))
    assert TDM.count_params(tm.t5_model) == JDM.count_params(jparams)
    assert TDM.count_nonzero(tm.t5_model) == JDM.count_nonzero(
        jax.tree_util.tree_map(jnp.asarray, jparams))
