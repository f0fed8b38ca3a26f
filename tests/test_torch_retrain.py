"""RESSA retraining of the port vs the JAX package on the CPU: one KD train
step (loss, CE, KL, every LoRA gradient and the AdamW-updated LoRA) on the
tiny fp32 InstructBLIP-T5 with LoRA ranks 4 / 2 / 8 and seeded non-zero
lora_b, gradient accumulation, the merges, the schedulers, the AdamW
update, the KD loss and the adapter IO.

Tolerances, and why:
- loss, CE, KL: atol = rtol = 1e-4, as the tiny models' logits (fp32 on
  both sides, summation order differs);
- gradients: max |port − JAX| ≤ 1e-4 · max |JAX| per leaf — relative to the
  leaf's scale, since single entries can be near zero;
- the updated LoRA: within 1e-3·lr where a gradient entry is above
  1e-4 × its leaf's scale; Adam's first step divides by |g|, which
  amplifies the rounding of entries near zero, so there only the bound of
  one step (2.1·lr) holds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import blip_batch, tiny_lora_blip, tiny_lora_configs
from vlm_compression_tpu.common import optims as JO
from vlm_compression_tpu.compression import peft_io as JP
from vlm_compression_tpu.tasks import retrain as JR
from vlm_compression_tpu_torch.common import optims as TO
from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.compression import peft_io as TP
from vlm_compression_tpu_torch.models import blip2_t5_instruct as TB
from vlm_compression_tpu_torch.models import factory as TF
from vlm_compression_tpu_torch.models.bridge import flatten, load_jax_variables
from vlm_compression_tpu_torch.tasks import retrain as TR

KL_W, T_KD, LR = 0.1, 1.0, 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _lora_leaves(tree):
    """{dotted linear path + leaf: numpy} of a JAX lora tree."""
    return {".".join(p): np.asarray(v) for p, v in flatten(tree).items()}


def _jax_grads(jm, variables, jb):
    """JAX's loss_fn of make_kd_train_step, differentiated in the lora
    collection (the step itself does not return its gradients)."""
    t_logits = jm.apply({"params": variables["params"]}, **jb,
                        vit_mode="dense", llm_mode="dense",
                        qformer_mode="dense")["logits"]

    def loss_fn(lora):
        out = jm.apply({"params": variables["params"],
                        "masks": variables["masks"], "lora": lora}, **jb,
                       vit_mode="sparse_lora", llm_mode="sparse_lora",
                       qformer_mode="sparse_lora")
        return JR.kd_loss(out["loss"], out["logits"], t_logits, KL_W,
                          T_KD)[0]

    return jax.grad(loss_fn)(variables["lora"])


@pytest.fixture(scope="module")
def kd_step_pair():
    """One KD step of each package from the same variables and batch."""
    jm, variables, tm, batch = tiny_lora_blip(seed=21, b=2)
    jv, jb = _jnp(variables), _jnp(batch)
    tx = JO.make_adamw(weight_decay=0.05)
    jstate = JR.RessaTrainState.create(jv, tx)
    jnew, jmet = jax.jit(JR.make_kd_train_step(jm, tx, KL_W, T_KD))(
        jstate, jb, LR)
    jgrads = _lora_leaves(jax.jit(_jax_grads, static_argnums=0)(jm, jv, jb))

    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    masks_before = {n: b.clone() for n, b in tm.named_buffers()}
    state = TR.RessaTrainState.create(tm, weight_decay=0.05)
    tmet = TR.make_kd_train_step(tm, state.opt, KL_W, T_KD)(
        _port_batch(batch), LR)
    tgrads = {n: p.grad.numpy() for n, p in state.lora.items()}
    return dict(jmet=jmet, jgrads=jgrads, jlora=_lora_leaves(jnew.lora),
                tmet=tmet, tgrads=tgrads, tm=tm, before=before,
                masks_before=masks_before, lora0=_lora_leaves(jv["lora"]))


def test_kd_step_metrics_match_jax(kd_step_pair):
    jmet, tmet = kd_step_pair["jmet"], kd_step_pair["tmet"]
    for key in ("loss", "ce", "kl"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   atol=1e-4, rtol=1e-4)
    assert float(jmet["kl"]) > 0     # the seeded adapters move the student


def test_kd_step_grads_match_jax(kd_step_pair):
    jg, tg = kd_step_pair["jgrads"], kd_step_pair["tgrads"]
    # adapted linears: ViT 2 × 4, Q-Former 12 + 8, T5 2 × 7 + 2 × 11
    assert set(jg) == set(tg) and len(tg) == 2 * (8 + 20 + 14 + 22)
    for name, want in jg.items():
        # 0 for the last Q-Former layer's text FFN: only the query
        # positions leave the Q-Former
        scale = float(np.abs(want).max())
        assert float(np.abs(tg[name] - want).max()) <= 1e-4 * scale, name
    assert sum(float(np.abs(g).max()) > 0 for g in jg.values()) >= 120


def test_kd_step_adamw_update_matches_jax(kd_step_pair):
    jlora, jg, lora0 = (kd_step_pair[k] for k in ("jlora", "jgrads",
                                                  "lora0"))
    tlora = {n: p.detach().numpy()
             for n, p in TR.lora_parameters(kd_step_pair["tm"]).items()}
    for name, want in jlora.items():
        got = tlora[name]
        assert not np.array_equal(want, lora0[name]), name
        diff = np.abs(got - want)
        assert diff.max() <= 2.1 * LR, name
        big = np.abs(jg[name]) > 1e-4 * np.abs(jg[name]).max()
        assert (diff[big] <= 1e-3 * LR).all(), name
        if not big.any():               # zero gradient: weight decay alone
            assert diff.max() <= 1e-3 * LR, name


def test_kd_step_moves_only_lora(kd_step_pair):
    tm, before = kd_step_pair["tm"], kd_step_pair["before"]
    for name, p in tm.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("lora_a", "lora_b"):
            assert p.requires_grad and not torch.equal(p, before[name])
        else:
            assert not p.requires_grad and p.grad is None, name
            assert torch.equal(p, before[name]), name
    for name, buf in tm.named_buffers():
        assert torch.equal(buf, kd_step_pair["masks_before"][name]), name


def test_grad_accumulation_equals_full_batch():
    """accum_grad_iters=2 over two equal halves gives the full batch's
    gradients, metrics and update (no -100 labels: every micro-batch then
    holds the same number of CE tokens)."""
    rng = np.random.default_rng(22)
    _, _, _, batch = tiny_lora_blip(seed=22, b=4)
    batch["labels"] = rng.integers(2, 90, batch["labels"].shape).astype(
        np.int32)
    runs = []
    for accum in (1, 2):
        _, variables, tm, _ = tiny_lora_blip(seed=22, b=4)
        state = TR.RessaTrainState.create(tm)
        met = TR.make_kd_train_step(tm, state.opt, KL_W, T_KD,
                                    accum_grad_iters=accum)(
            _port_batch(batch), LR)
        runs.append((met, {n: (p.grad.clone(), p.detach().clone())
                           for n, p in state.lora.items()}))
    (m1, g1), (m2, g2) = runs
    for key in ("loss", "ce", "kl"):
        np.testing.assert_allclose(float(m2[key]), float(m1[key]),
                                   atol=1e-6, rtol=1e-5)
    for name, (grad, param) in g1.items():
        scale = float(grad.abs().max())
        assert float((g2[name][0] - grad).abs().max()) <= 1e-5 * scale
        big = grad.abs() > 1e-4 * scale
        assert bool(((g2[name][1] - param)[big].abs() <= 1e-3 * LR).all())


def test_accumulation_needs_equal_micro_batches():
    _, _, tm, batch = tiny_lora_blip(seed=23, b=2)
    state = TR.RessaTrainState.create(tm)
    step = TR.make_kd_train_step(tm, state.opt, accum_grad_iters=3)
    with pytest.raises(ValueError, match="equal micro-batches"):
        step(_port_batch(batch), LR)


@pytest.mark.parametrize("sparse", [True, False])
def test_merge_and_apply_masks_match_jax(sparse):
    _, variables, tm, _ = tiny_lora_blip(seed=24)
    jv = _jnp(variables)
    want = JR.merge_lora_into_params(jv["params"], jv["masks"], jv["lora"],
                                     sparse=sparse, alpha=16.0)
    want_masked = flatten(JR.apply_masks_to_params(want, jv["masks"]))
    TR.merge_lora_into_params(tm, sparse=sparse)
    named = dict(tm.named_parameters())
    for path, w in flatten(want).items():
        np.testing.assert_allclose(named[".".join(path)].detach().numpy(),
                                   np.asarray(w), atol=1e-6, rtol=1e-6)
    TR.apply_masks_to_params(tm)
    for path, w in want_masked.items():
        np.testing.assert_allclose(named[".".join(path)].detach().numpy(),
                                   np.asarray(w), atol=1e-6, rtol=1e-6)
    for m in tm.modules():
        if getattr(m, "mask", None) is not None:
            assert not m.kernel.detach()[~m.mask].any()


def test_kl_and_kd_loss_match_jax():
    rng = np.random.default_rng(25)
    s = rng.standard_normal((3, 5, 11)).astype(np.float32)
    t = rng.standard_normal((3, 5, 11)).astype(np.float32)
    for T in (1.0, 2.0):
        np.testing.assert_allclose(
            float(TR.kl_div_batchmean(_t(s), _t(t), T)),
            float(JR.kl_div_batchmean(jnp.asarray(s), jnp.asarray(t), T)),
            rtol=1e-6)
        got = TR.kd_loss(torch.tensor(2.5), _t(s), _t(t), 0.3, T)
        want = JR.kd_loss(jnp.asarray(2.5), jnp.asarray(s), jnp.asarray(t),
                          0.3, T)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


@pytest.mark.parametrize("run_cfg", [
    dict(lr_sched="linear_warmup_cosine_lr", max_epoch=4, min_lr=1e-5,
         init_lr=1e-4, warmup_steps=1000, warmup_lr=1e-6),
    dict(lr_sched="linear_warmup_step_lr", max_epoch=5, min_lr=1e-6,
         init_lr=3e-4, warmup_steps=10, lr_decay_rate=0.5),
    dict(init_lr=2e-4),
])
def test_lr_schedulers_match_jax(run_cfg):
    got, want = TO.make_lr_scheduler(run_cfg), JO.make_lr_scheduler(run_cfg)
    assert type(got).__name__ == type(want).__name__
    for epoch, step in [(0, 0), (0, 1), (0, 7), (0, 500), (0, 5000), (1, 0),
                        (2, 3), (4, 0)]:
        assert got(epoch, step) == pytest.approx(want(epoch, step),
                                                 rel=1e-12, abs=0)
    assert registry.get_lr_scheduler_class(
        run_cfg.get("lr_sched", "linear_warmup_cosine_lr")) is type(got)


def test_adamw_matches_optax():
    """torch AdamW (decoupled decay, no-decay group by rank and name) and
    optax scale_by_adam → add_decayed_weights → scale(−lr): the same update
    up to rounding, over three steps with changing lr."""
    rng = np.random.default_rng(26)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "bias": rng.standard_normal((3,)).astype(np.float32),
              "scale": rng.standard_normal((2, 2)).astype(np.float32)}
    tx = JO.make_adamw(weight_decay=0.05, beta2=0.98)
    jp = _jnp(params)
    opt_state = tx.init(jp)
    tparams = {k: _t(v).requires_grad_() for k, v in params.items()}
    opt = TO.make_adamw(tparams.items(), weight_decay=0.05, beta2=0.98)
    for lr in (1e-3, 5e-4, 2e-3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        opt_state.hyperparams["lr"] = jnp.asarray(lr)
        upd, opt_state = tx.update(_jnp(grads), opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        for k, p in tparams.items():
            p.grad = _t(grads[k])
        TO.set_lr(opt, lr)
        opt.step()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-7, rtol=1e-6)


def test_count_parameters_and_adapter_io_match_jax(tmp_path):
    _, variables, tm, _ = tiny_lora_blip(seed=27)
    assert TP.count_parameters(tm) == JP.count_parameters(variables)
    assert "trainable params" in TP.print_trainable_parameters(tm)
    state = TP.adapter_state(tm)
    assert set(state) == {"lora", "masks"}
    for path, want in flatten(variables["lora"]).items():
        got = state["lora"]
        for part in path:
            got = got[part]
        np.testing.assert_array_equal(got.numpy(), want)
    # round trip through torch.save into a fresh model
    path = TP.save_adapter(tm, str(tmp_path / "adapter.pt"))
    _, tcfg = tiny_lora_configs()
    fresh = TB.Blip2T5Instruct(tcfg, device="cpu")
    load_jax_variables(fresh, {"params": variables["params"]}, strict=False)
    TP.attach_adapter_state(fresh, TP.load_adapter(path))
    for (n1, p1), (n2, p2) in zip(tm.state_dict().items(),
                                  fresh.state_dict().items()):
        assert n1 == n2 and torch.equal(p1, p2), n1


def test_factory_ranks_dtype_policy_and_task():
    base = dict(arch="blip2_t5_instruct", tiny=True, lora_r_v=4, lora_r_l=8,
                lora_r_q=2, lora_alpha=16)
    _, cfg = TF.build_model_config(dict(base, tune_opt="LVQ"))
    assert (cfg.vit.lora_rank, cfg.t5.lora_rank, cfg.qformer.lora_rank) == \
        (4, 8, 2)
    assert cfg.vit.dtype == "bfloat16"
    _, cfg = TF.build_model_config(dict(base, tune_opt="L", amp=False))
    assert (cfg.vit.lora_rank, cfg.t5.lora_rank, cfg.qformer.lora_rank) == \
        (0, 8, 0)
    assert cfg.vit.dtype == cfg.t5.param_dtype == "float32"
    _, xl = TF.build_model_config(dict(model_type="flant5xl"))
    _, xxl = TF.build_model_config(dict(model_type="flant5xxl"))
    assert (xl.t5.d_model, xxl.t5.d_model) == (2048, 4096)
    with pytest.raises(NotImplementedError):
        TF.build_model_config(dict(arch="blip2_opt"))
    # the reference's use_grad_checkpoint reaches every tower's use_remat
    _, plain = TF.build_model_config(base)
    _, remat = TF.build_model_config(dict(base, use_grad_checkpoint=True))
    assert remat.vit.use_remat and remat.t5.use_remat
    assert remat == dataclasses.replace(
        plain, vit=dataclasses.replace(plain.vit, use_remat=True),
        t5=dataclasses.replace(plain.t5, use_remat=True))
    model = TF.build_model(dict(base, tune_opt="LVQ"), seed=1, device="cpu")
    assert TP.count_parameters(model)["trainable"] > 0
    task = registry.get_task_class("image_text_retrain").setup_task(
        type("Cfg", (), {"run_cfg": {"kl_weight": 0.1, "T": 1.0}})())
    assert (task.kl_weight, task.T) == (0.1, 1.0)
    batch = blip_batch(np.random.default_rng(28), tiny_lora_configs()[0])
    state = TR.RessaTrainState.create(model)
    met = task.make_train_step(model, state.opt)(_port_batch(batch), LR)
    assert all(bool(torch.isfinite(v)) for v in met.values())
