"""The port's KD train step and generate over a mesh vs the JAX package's
unsharded ones on the CPU, in gloo ranks (``parallel.collectives.spawn``),
the JAX side run here in the test process.  Tiny fp32 InstructBLIP-T5,
LoRA ranks 4 / 2 / 8 with seeded non-zero lora_b, drawn at std 0.1 (as the
Vicuna retrain test draws them: at ``tiny_lora_blip``'s 0.3 the tiny
Q-Former's gradients are ill-conditioned, and at batch 4 a Q-Former leaf
of the port's single-process step already misses JAX's by 2.6e-4 of its
scale).  Every decoder row keeps at least one valid label: a row with
none is a known difference of the port's single-process step
(ROADMAP.md, "Known differences").

- The data-parallel repair: 2 ranks, each half of a batch whose halves
  hold different numbers of −100 labels; and the runner over a
  (data 2, model 2) mesh from ``run.model_parallel``: the ranks of a model
  group load the same samples, the data ranks different ones, and one
  step through ``RunnerBase.train_step`` equals JAX's step on the union.
- The KD step at (data 2, model 2) under the default rules and under
  ``FSDP_RULES``, against ``make_kd_train_step`` on the whole batch (as
  ``tests/test_sharding_train.py`` runs it over JAX's mesh).
- Beam-3 ``generate_t5`` at (data 2, model 2): tokens equal to JAX's.
- A bf16 row-parallel ``SparseLinear`` at model 2: each rank's products
  stay fp32 and their sum is rounded once, so the output equals the sum
  of the two row blocks' fp32 products rounded to bf16, bit for bit (and
  differs from the twice-rounded sum; without a mask, the plain product
  and the adapter: each rank's fp32 product plus its adapter part, summed
  and rounded once); dx and the LoRA A gradient equal one process's bit
  for bit (without a mask dx within a bf16 unit of its largest), B's within a bf16 unit (2^-7) of its largest
  entry: each rank's part of a replicated factor's gradient is rounded to
  the factor's dtype before the sum (ROADMAP.md, "Known differences").

Tolerances, the retrain tests' (``tests/test_torch_retrain.py``): loss,
CE and KL atol = rtol = 1e-4; every LoRA gradient within 1e-4 of its
leaf's largest; the updated LoRA within 1e-3·lr where a gradient entry is
above 1e-4 of its leaf's scale, within one step's bound (2.1·lr) where
Adam divides a near-zero gradient.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_models import (
    blip_batch,
    numpy_tree,
    random_masks,
    seeded_lora,
    tiny_blip,
    tiny_blip_configs,
    tiny_lora_configs,
)
from torch_parallel_ranks import runner_rank, train_rank
from vlm_compression_tpu.common import optims as JO
from vlm_compression_tpu.models import blip2_t5_instruct as JB
from vlm_compression_tpu.models import generation as JG
from vlm_compression_tpu.tasks import retrain as JR
from vlm_compression_tpu_torch.models.bridge import flatten
from vlm_compression_tpu_torch.parallel.collectives import spawn

KL_W, T_KD, LR, WD = 0.1, 1.0, 1e-3, 0.05


JM = JB.Blip2T5Instruct(tiny_lora_configs()[0])


def tiny_lora_blip(seed):
    """(jax module, variables as numpy): ``test_torch_models``'s tiny LoRA
    model with lora_b at std 0.1."""
    rng = np.random.default_rng(seed)
    jcfg, _ = tiny_lora_configs()
    batch = blip_batch(rng, jcfg, b=2)
    jm = JM
    v = numpy_tree(jm.init(jax.random.key(seed),
                           **{k: jnp.asarray(x) for k, x in batch.items()},
                           vit_mode="sparse_lora", llm_mode="sparse_lora",
                           qformer_mode="sparse_lora"))
    return jm, dict(params=v["params"],
                    lora=seeded_lora(v["lora"], rng, std=0.1),
                    masks=random_masks(v["params"], rng))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves(tree):
    return {".".join(p): np.asarray(v) for p, v in flatten(tree).items()}


_JAX = {}


def _jitted(jm):
    """JAX's KD step and its LoRA gradient, jitted once for the module's
    one model (every case shares its shapes)."""
    if "step" not in _JAX:
        tx = JO.make_adamw(weight_decay=WD)

        def grads(v, b):
            t_logits = jm.apply({"params": v["params"]}, **b,
                                vit_mode="dense", llm_mode="dense",
                                qformer_mode="dense")["logits"]

            def loss_fn(lora):
                out = jm.apply({"params": v["params"], "masks": v["masks"],
                                "lora": lora}, **b, vit_mode="sparse_lora",
                               llm_mode="sparse_lora",
                               qformer_mode="sparse_lora")
                return JR.kd_loss(out["loss"], out["logits"], t_logits,
                                  KL_W, T_KD)[0]

            return jax.grad(loss_fn)(v["lora"])

        _JAX.update(tx=tx, step=jax.jit(JR.make_kd_train_step(
            jm, tx, KL_W, T_KD)), grads=jax.jit(grads))
    return _JAX


def jax_kd(jm, variables, batch):
    """JAX's step on the whole batch: metrics, updated LoRA, gradients."""
    jv, jb = _jnp(variables), _jnp(batch)
    fns = _jitted(jm)
    new, met = fns["step"](JR.RessaTrainState.create(jv, fns["tx"]), jb, LR)
    return ({k: float(v) for k, v in met.items()}, _leaves(new.lora),
            _leaves(fns["grads"](jv, jb)))


def assert_step_matches(rank_out, want):
    jmet, jlora, jgrads = want
    for key in ("loss", "ce", "kl"):
        np.testing.assert_allclose(rank_out["met"][key], jmet[key],
                                   atol=1e-4, rtol=1e-4)
    assert set(rank_out["lora"]) == set(jlora)
    for name, w in jgrads.items():
        scale = float(np.abs(w).max())
        assert float(np.abs(rank_out["grads"][name] - w).max()) \
            <= 1e-4 * scale, name
    for name, w in jlora.items():
        diff = np.abs(rank_out["lora"][name] - w)
        assert diff.max() <= 2.1 * LR, name
        big = np.abs(jgrads[name]) > 1e-4 * np.abs(jgrads[name]).max()
        assert (diff[big] <= 1e-3 * LR).all(), name


def _uneven_batch(jcfg, rng, b=4):
    """A batch whose halves hold different numbers of valid labels."""
    batch = blip_batch(rng, jcfg, b=b, lbl=5)
    batch["labels"][:b // 2, -1:] = -100
    batch["labels"][b // 2:, -4:] = -100
    return batch


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """2 gloo ranks: the data-parallel step on the uneven batch."""
    jm, variables = tiny_lora_blip(seed=31)
    jcfg, tcfg = tiny_lora_configs()
    batch = _uneven_batch(jcfg, np.random.default_rng(32))
    out = spawn(train_rank, 2, "gloo",
                str(tmp_path_factory.mktemp("dp") / "init"), 60.0,
                args=([("kd", (tcfg, variables, batch, dict(data=2,
                                                            model=1),
                               "default", LR, KL_W, T_KD, WD))],))
    return out, jax_kd(jm, variables, batch)


def test_data_parallel_step_with_uneven_labels_matches_jax(two_ranks):
    out, want = two_ranks
    for rank in out:
        assert_step_matches(rank[0], want)
    for name, w in out[0][0]["lora"].items():        # one AdamW step
        np.testing.assert_array_equal(out[1][0]["lora"][name], w)


def test_a_mean_of_rank_means_is_not_the_global_loss(two_ranks):
    """The repaired fault: the halves' CE means differ, so their average
    is not the global CE the ranks report (and JAX computes)."""
    out, (jmet, _, _) = two_ranks
    assert abs(out[0][0]["met"]["ce"] - jmet["ce"]) <= 1e-4
    jm, variables = tiny_lora_blip(seed=31)
    jcfg, _ = tiny_lora_configs()
    batch = _uneven_batch(jcfg, np.random.default_rng(32))
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    ces = [float(jm.apply(_jnp(variables), **_jnp(h),
                          vit_mode="sparse_lora", llm_mode="sparse_lora",
                          qformer_mode="sparse_lora")["loss"])
           for h in halves]
    assert abs(np.mean(ces) - jmet["ce"]) > 1e-3


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """4 gloo ranks, one group: the KD step at (data 2, model 2) with the
    default rules and with FSDP's, then beam-3 generate."""
    jm, variables = tiny_lora_blip(seed=41)
    jcfg, tcfg = tiny_lora_configs()
    batch = _uneven_batch(jcfg, np.random.default_rng(42))
    gm, gvars, _, _ = tiny_blip(seed=43, masks=True)
    gjcfg = gm.cfg
    gbatch = blip_batch(np.random.default_rng(44), gjcfg, b=4)
    gtcfg = tiny_blip_configs()[1]
    gen_kw = dict(num_beams=3, max_length=8, min_length=1, eos_token_id=1,
                  pad_token_id=0, decoder_start_token_id=0)
    mesh = dict(data=2, model=2)
    cases = [("kd", (tcfg, variables, batch, mesh, "default", LR, KL_W,
                     T_KD, WD)),
             ("kd", (tcfg, variables, batch, mesh, "fsdp", LR, KL_W, T_KD,
                     WD)),
             ("generate", (gtcfg, gvars, gbatch, mesh, gen_kw)),
             ("row", (*_row_inputs(), mesh))]
    out = spawn(train_rank, 4, "gloo",
                str(tmp_path_factory.mktemp("tp") / "init"), 60.0,
                args=(cases,))
    args = ("image", "input_ids", "attention_mask", "qformer_input_ids",
            "qformer_attention_mask")
    tokens = np.asarray(JB.generate_t5(
        gm, _jnp(gvars), *[jnp.asarray(gbatch[a]) for a in args],
        gen_cfg=JG.GenerationConfig(**gen_kw)))
    return out, jax_kd(jm, variables, batch), tokens


def _row_inputs(k_in=64, n_out=48, r=4):
    """bf16-valued x (4, 8, K), kernel, a 50 % mask, LoRA A and B, and the
    output gradient g of the row-parallel linear test."""
    import torch

    rng = np.random.default_rng(45)

    def bf16(*shape, std=1.0):
        t = torch.as_tensor(rng.standard_normal(shape) * std,
                            dtype=torch.float32)
        return t.to(torch.bfloat16).float().numpy()

    return (bf16(4, 8, k_in), bf16(k_in, n_out, std=0.2),
            rng.random((k_in, n_out)) < 0.5, bf16(k_in, r, std=0.2),
            bf16(r, n_out, std=0.2), bf16(4, 8, n_out))


def test_row_parallel_bf16_linear_rounds_once(four_ranks):
    import torch

    from vlm_compression_tpu_torch.models.layers import SparseLinear
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    out, _, _ = four_ranks
    x, kernel, mask, a, b, g = (torch.as_tensor(t) for t in _row_inputs())
    bf16, f32 = torch.bfloat16, torch.float32
    xb, kb, ab, bb = (t.to(bf16) for t in (x, kernel, a, b))
    s = 16.0 / a.shape[1]
    half = kernel.shape[0] // 2
    blocks = (slice(0, half), slice(half, None))

    def once_and_twice(part):
        p = [part(rows) for rows in blocks]
        return ((p[0] + p[1]).to(bf16).float(),
                (p[0].to(bf16).float() + p[1].to(bf16).float()).to(bf16)
                .float())

    want = {
        "dense": once_and_twice(
            lambda rows: xb[..., rows].float() @ kb[rows].float()),
        "masked": once_and_twice(lambda rows: ML.masked_matmul_ref(
            xb[..., rows], kb[rows], mask[rows], f32)),
        "sparse_lora": once_and_twice(lambda rows: ML.sparse_lora_matmul_ref(
            xb[..., rows], kb[rows], mask[rows], ab[rows], bb, s, f32)),
        "unmasked": once_and_twice(lambda rows: (
            xb[..., rows].float() @ kb[rows].float()
            + s * ((xb[..., rows] @ ab[rows]) @ bb).float()))}
    # one process's linear, for the gradients
    lin = SparseLinear(*kernel.shape, use_bias=False, param_dtype=bf16,
                       device="cpu", lora_rank=a.shape[1])
    with torch.no_grad():
        lin.kernel.copy_(kb)
        lin.lora_a.copy_(ab)
        lin.lora_b.copy_(bb)
    lin.mask = mask
    xg = xb.clone().requires_grad_(True)
    (lin(xg, mode="sparse_lora").float() * g).sum().backward()
    want_da = lin.lora_a.grad.float().numpy()
    want_db = lin.lora_b.grad.float().numpy()
    lin.mask = None
    xu = xb.clone().requires_grad_(True)
    (lin(xu, mode="sparse_lora").float() * g).sum().backward()
    want_dx = xu.grad.float().numpy()
    for rank in out:
        got = rank[3]
        for mode, (once, twice) in want.items():
            np.testing.assert_array_equal(got[mode], once.numpy(), mode)
            assert (once != twice).any(), mode   # the test can tell them
        np.testing.assert_array_equal(got["dx"], xg.grad.float().numpy())
        np.testing.assert_array_equal(got["da"], want_da)
        np.testing.assert_allclose(got["db"], want_db, rtol=0,
                                   atol=2 ** -7 * np.abs(want_db).max())
        np.testing.assert_allclose(got["unmasked_dx"], want_dx, rtol=0,
                                   atol=2 ** -7 * np.abs(want_dx).max())


@pytest.mark.parametrize("case", [0, 1], ids=["default_rules", "fsdp_rules"])
def test_kd_step_on_data_model_mesh_matches_jax(four_ranks, case):
    out, want, _ = four_ranks
    for rank in out:
        assert_step_matches(rank[case], want)


def test_sharded_generate_beam3_matches_jax(four_ranks):
    out, _, want = four_ranks
    # data rank d holds rows [2d, 2d + 2); both model ranks the same
    for r, rank in enumerate(out):
        d = r // 2
        np.testing.assert_array_equal(rank[2]["tokens"],
                                      want[2 * d:2 * d + 2])


@pytest.fixture(scope="module")
def runner_ranks(tmp_path_factory):
    jm, variables = tiny_lora_blip(seed=51)
    jcfg, tcfg = tiny_lora_configs()
    batch = _uneven_batch(jcfg, np.random.default_rng(52), b=8)
    batch["labels"][4:, -4:] = -100
    samples = [{k: v[i] for k, v in batch.items()} | {"idx": i}
               for i in range(8)]
    run_cfg = dict(batch_size_train=2, model_parallel=2,
                   output_dir=str(tmp_path_factory.mktemp("runner")),
                   weight_decay=WD, kl_weight=KL_W, T=T_KD)
    out = spawn(runner_rank, 4, "gloo",
                str(tmp_path_factory.mktemp("rn") / "init"), 60.0,
                args=(tcfg, variables, samples, run_cfg, LR))
    ids = out[0]["ids"] + out[2]["ids"]       # data rank 0, then 1
    union = {k: v[ids] for k, v in batch.items()}
    return out, jax_kd(jm, variables, union)


def test_runner_loads_by_data_rank(runner_ranks):
    out, _ = runner_ranks
    assert all(r["data"] == 2 and r["model"] == 2 and r["sharded"]
               for r in out)
    assert out[0]["ids"] == out[1]["ids"] and out[2]["ids"] == out[3]["ids"]
    assert not set(out[0]["ids"]) & set(out[2]["ids"])


def test_runner_step_matches_jax_on_the_union(runner_ranks):
    out, want = runner_ranks
    for rank in out:
        assert_step_matches(rank["step"], want)


def test_spawn_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank"):
        spawn(os.path.join, 2, "gloo", str(tmp_path / "init"), 30.0,
              args=(1,))


@pytest.mark.parametrize("cli", ["train", "evaluate"])
def test_clis_join_the_process_group_before_the_build(cli, tmp_path,
                                                       monkeypatch):
    """Both CLIs call ``common.dist.init_distributed_mode`` with the run
    config before the model is built (a group the environment names —
    torchrun's — is joined there; with none it is a no-op)."""
    import importlib

    from vlm_compression_tpu_torch.common import dist as TD
    from vlm_compression_tpu_torch.models import factory

    calls = []

    class Joined(Exception):
        pass

    def init(run_cfg=None):
        calls.append(("init", run_cfg is not None))
        raise Joined

    monkeypatch.setattr(TD, "init_distributed_mode", init)
    monkeypatch.setattr(factory, "build_model",
                        lambda *a, **k: calls.append("build"))
    cfg = tmp_path / "run.yaml"
    cfg.write_text("model:\n  arch: blip2_t5_instruct\n  tiny: true\n"
                   "run:\n  task: image_text_retrain\n")
    mod = importlib.import_module(f"vlm_compression_tpu_torch.cli.{cli}")
    with pytest.raises(Joined):
        mod.run(mod.parse_args(["--cfg-path", str(cfg), "--device", "cpu"]))
    assert calls == [("init", True)]
