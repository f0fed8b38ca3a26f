"""The port's GPipe engine (``parallel/pipeline.py``) vs the JAX package's
``pipeline_apply`` on the CPU: 4 gloo ranks against JAX's schedule over 4
of the virtual devices, with ``tests/test_pipeline.py``'s tanh-MLP block
(8 layers, 4 stages, 2 microbatches; and 4 layers over 2 stages × 2 data
ranks, the batch on the data axis) and a stack of 8 tiny ``LlamaBlock``s
(4 stages, 2 microbatches, causal, dense).  The loss is mean((y − t)²);
autograd through the port's schedule is held against ``jax.grad`` of
JAX's, stage by stage.  Tolerances: the output within 2e-5 (the JAX
test's), the loss and every gradient within 1e-4 (atol and rtol).  The
indivisible cases raise in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_torch_models import port_config
from torch_parallel_ranks import train_rank
from vlm_compression_tpu.models import llama as JL
from vlm_compression_tpu.parallel import pipeline as JP
from vlm_compression_tpu_torch.models import llama as TL
from vlm_compression_tpu_torch.models.bridge import flatten
from vlm_compression_tpu_torch.parallel import pipeline as TP
from vlm_compression_tpu_torch.parallel.collectives import spawn

F32 = dict(param_dtype="float32", dtype="float32")


def _mlp_layers(seed, n_layers, d, h):
    rng = np.random.default_rng(seed)
    return [{"w1": (rng.standard_normal((d, h)) * 0.3).astype(np.float32),
             "b1": np.zeros((h,), np.float32),
             "w2": (rng.standard_normal((h, d)) * 0.3).astype(np.float32)}
            for _ in range(n_layers)]


def _jax_mlp(p, x):
    return x + jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]


def _llama_setup(seed=5, n_layers=8, b=4, n=8):
    jcfg = JL.LlamaConfig.tiny(num_layers=n_layers, **F32)
    blk = JL.LlamaBlock(jcfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, jcfg.hidden_size)).astype(np.float32)
    cmask = jnp.where(jnp.arange(n)[None, :] <= jnp.arange(n)[:, None],
                      0.0, -1e9)[None, None]
    pos = jnp.broadcast_to(jnp.arange(n)[None], (b, n))
    layers = []
    for i in range(n_layers):
        p = blk.init(jax.random.key(10 + i), jnp.asarray(x), cmask, pos,
                     mode="dense")["params"]
        # RMSNorm scales off their init, so they carry a gradient
        p = jax.tree_util.tree_map(np.asarray, p)
        layers.append({".".join(k): (v * (1.0 + 0.1 * rng.standard_normal(
            v.shape)) if k[-1] == "scale" else v).astype(np.float32)
            for k, v in flatten(p).items()})

    def jax_block(lp, xm):
        tree = {}
        for name, v in lp.items():
            node = tree
            *head, leaf = name.split(".")
            for part in head:
                node = node.setdefault(part, {})
            node[leaf] = v
        posm = jnp.broadcast_to(jnp.arange(n)[None], (xm.shape[0], n))
        return blk.apply({"params": tree}, xm, cmask, posm, mode="dense")

    return jcfg, layers, x, jax_block


def _jax_pipeline(block_fn, layers, x, tgt, mesh, n_stages, n_micro,
                  batch_axis=None):
    stacked = JP.stack_layer_params(
        [{k: jnp.asarray(v) for k, v in lp.items()} for lp in layers])
    staged = JP.shard_stages(JP.split_stages(stacked, n_stages), mesh)
    fn = JP.make_pipeline_fn(block_fn, mesh=mesh, n_microbatches=n_micro,
                             batch_axis=batch_axis)

    def loss(st, xb):
        y = fn(st, xb)
        return jnp.mean((y - jnp.asarray(tgt)) ** 2), y

    (l, y), g = jax.value_and_grad(loss, has_aux=True)(staged, jnp.asarray(x))
    return float(l), np.asarray(y), {k: np.asarray(v) for k, v in g.items()}


CASES = {
    "mlp_4_stages": dict(stages=4, micro=2, data=1, block="mlp"),
    "mlp_2_stages_x_2_data": dict(stages=2, micro=2, data=2, block="mlp"),
    "llama_4_stages": dict(stages=4, micro=2, data=1, block="llama"),
}


@pytest.fixture(scope="module")
def pipelines(devices8, tmp_path_factory):
    rng = np.random.default_rng(9)
    setups, cases = {}, []
    for name, c in CASES.items():
        if c["block"] == "mlp":
            n_layers = 8 if c["stages"] == 4 else 4
            layers = _mlp_layers(4, n_layers, 8, 16)
            x = rng.standard_normal((8, 8)).astype(np.float32)
            block, cfg, jblock = "mlp", None, _jax_mlp
        else:
            jcfg, layers, x, jblock = _llama_setup()
            block, cfg = "llama", port_config(jcfg, TL.LlamaConfig)
        tgt = rng.standard_normal(x.shape).astype(np.float32)
        if c["data"] > 1:
            mesh = Mesh(np.asarray(devices8[:4]).reshape(c["stages"],
                                                         c["data"]),
                        ("pipe", "data"))
        else:
            mesh = Mesh(np.asarray(devices8[:4]), ("pipe",))
        setups[name] = _jax_pipeline(
            jblock, layers, x, tgt, mesh, c["stages"], c["micro"],
            batch_axis="data" if c["data"] > 1 else None)
        cases.append(("pipeline", (layers, x, tgt, c["stages"], c["micro"],
                                   block, cfg)))
    ranks = spawn(train_rank, 4, "gloo",
                  str(tmp_path_factory.mktemp("pipe") / "init"), 60.0,
                  args=(cases,))
    return setups, ranks


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_forward_matches_jax(pipelines, case):
    setups, ranks = pipelines
    i = list(CASES).index(case)
    loss, y, _ = setups[case]
    data = CASES[case]["data"]
    for r, rank in enumerate(ranks):
        got = rank[i]
        d = r % data
        per = y.shape[0] // data
        np.testing.assert_allclose(got["y"], y[d * per:(d + 1) * per],
                                   atol=2e-5, rtol=2e-5)
        if data == 1:
            np.testing.assert_allclose(got["loss"], loss, atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_gradients_match_jax(pipelines, case):
    setups, ranks = pipelines
    i = list(CASES).index(case)
    _, _, grads = setups[case]
    data = CASES[case]["data"]
    for r, rank in enumerate(ranks):
        got = rank[i]
        s = got["stage"]
        assert s == r // data
        for k, g in grads.items():
            want = g[s]
            if data > 1:
                # each data rank's loss is the mean over its half: the
                # global mean's gradient is the data ranks' average
                others = [ranks[q][i]["grads"][k] for q in range(4)
                          if ranks[q][i]["stage"] == s]
                np.testing.assert_allclose(np.mean(others, 0), want,
                                           atol=1e-4, rtol=1e-4, err_msg=k)
                continue
            np.testing.assert_allclose(got["grads"][k], want, atol=1e-4,
                                       rtol=1e-4, err_msg=k)
        assert any(np.abs(v).max() > 0 for v in got["grads"].values())


def test_indivisible_layers_and_batches_raise():
    layers = [{"w": torch.zeros(2, 2)} for _ in range(6)]
    with pytest.raises(ValueError, match="not divisible"):
        TP.split_stages(TP.stack_layer_params(layers), 4)
    with pytest.raises(ValueError, match="not divisible"):
        JP.split_stages(JP.stack_layer_params(
            [{"w": jnp.zeros((2, 2))} for _ in range(6)]), 4)
    staged = TP.split_stages(TP.stack_layer_params(layers[:4]), 1)
    stage = {k: v[0] for k, v in staged.items()}
    with pytest.raises(ValueError, match="not divisible by 2 microbatches"):
        TP.pipeline_apply(lambda p, h: h, stage, torch.zeros(3, 2),
                          mesh=None, n_microbatches=2)


def test_pipeline_without_a_pipe_axis_is_the_sequential_net():
    layers = _mlp_layers(3, 4, 8, 16)
    x = np.random.default_rng(1).standard_normal((4, 8)).astype(np.float32)
    staged = TP.split_stages(TP.stack_layer_params(
        [{k: torch.from_numpy(v) for k, v in lp.items()}
         for lp in layers]), 1)
    stage = {k: v[0] for k, v in staged.items()}
    fn = TP.make_pipeline_fn(lambda p, h: h + torch.tanh(
        h @ p["w1"] + p["b1"]) @ p["w2"], mesh=None, n_microbatches=2)
    got = fn(stage, torch.from_numpy(x)).numpy()
    want = jnp.asarray(x)
    for lp in layers:
        want = _jax_mlp({k: jnp.asarray(v) for k, v in lp.items()}, want)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
