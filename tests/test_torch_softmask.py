"""Annealed soft-mask n:m pruning, port vs the JAX package on the CPU.

``soft_topn`` sums to n and is differentiable (its value and gradient
within 1e-5 of JAX's); ``hard_topn`` is bit-equal, ties included; the
starting error is within 1e-6 relative; the batched form equals one linear
at a time; ``t5_softmask_pruner`` runs end to end through the bridge; a
pruner without n:m raises.

Tolerance of a whole anneal: 48 Adam steps in float32 on two stacks may
part at a near-tie, so a trajectory is held two ways.  On the seeded
well-separated cases below the masks are bit-equal.  Everywhere (the
pruner's sweep included) the final hard-mask error is within 1e-4
relative of JAX's and at most 1 % of the groups differ; the count of
differing groups is in the assertion message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import tiny_blip
from test_torch_pipeline import _calib_batches, _copy_spine
from vlm_compression_tpu.compression import load_pruner as jax_load_pruner
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.ops import softmask as JS
from vlm_compression_tpu_torch.compression import load_pruner
from vlm_compression_tpu_torch.models.bridge import export_masks, flatten
from vlm_compression_tpu_torch.ops import softmask as TS


def _problem(seed, units=16, n_in=32, corr=True):
    """A weight and a correlated-input Hessian (2/N) XᵀX."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((units, n_in)).astype(np.float32)
    x = rng.standard_normal((256, n_in)).astype(np.float32)
    if corr:
        x = x @ rng.standard_normal((n_in, n_in)).astype(np.float32) * 0.3 + x
    h = (2.0 / x.shape[0]) * (x.T @ x)
    return w, h.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _group_diff(got, want, m):
    g = got.reshape(got.shape[0], -1, m) != want.reshape(want.shape[0], -1, m)
    return int(g.any(axis=-1).sum()), g.shape[0] * g.shape[1]


def test_soft_topn_sums_to_n_and_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 5, 4)).astype(np.float32)
    for n, tau in ((1, 2.0), (2, 0.5), (3, 0.05)):
        want = np.asarray(JS.soft_topn(jnp.asarray(logits), n,
                                       jnp.float32(tau)))
        lg = _t(logits).requires_grad_(True)
        got = TS.soft_topn(lg, n, torch.tensor(tau))
        np.testing.assert_allclose(got.sum(-1).detach().numpy(), n,
                                   rtol=1e-5)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
        # differentiable: the gradient of a weighted sum, against JAX's
        wts = rng.standard_normal(logits.shape).astype(np.float32)
        (gr,) = torch.autograd.grad((got * _t(wts)).sum(), lg)
        jgr = jax.grad(lambda l: jnp.sum(JS.soft_topn(l, n, jnp.float32(
            tau)) * wts))(jnp.asarray(logits))
        assert torch.isfinite(gr).all()
        np.testing.assert_allclose(gr.numpy(), np.asarray(jgr), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("ties", [True, False])
@pytest.mark.parametrize("n,m", [(1, 4), (2, 4), (3, 4), (3, 8), (6, 8)])
def test_hard_topn_is_bit_equal_ties_included(n, m, ties):
    rng = np.random.default_rng(1)
    logits = (rng.integers(0, 3, (10, 7, m)) if ties
              else rng.standard_normal((10, 7, m))).astype(np.float32)
    logits[0, 0] = 0.0
    logits[0, 0, ::2] = -0.0             # signed zeros compare equal
    want = np.asarray(JS.hard_topn(jnp.asarray(logits), n))
    got = TS.hard_topn(_t(logits), n).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == n).all()


@pytest.mark.parametrize("seed", [2, 3])
def test_start_error_matches_jax(seed):
    w, h = _problem(seed)
    _, _, want = JS.softmask_nm_prune(jnp.asarray(w), jnp.asarray(h), 2, 4,
                                      steps=1)
    _, _, got = TS.softmask_nm_prune(_t(w), _t(h), 2, 4, steps=1)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# (seed, n, m, steps, lr): well-separated seeded cases, masks bit-equal
SEPARATED = [(4, 2, 4, 48, 0.1), (5, 2, 4, 16, 0.1), (6, 1, 4, 24, 0.2),
             (7, 4, 8, 32, 0.1)]


@pytest.mark.parametrize("seed,n,m,steps,lr", SEPARATED)
def test_anneal_matches_jax(seed, n, m, steps, lr):
    w, h = _problem(seed)
    jk, jbest, jinit = JS.softmask_nm_prune(jnp.asarray(w), jnp.asarray(h),
                                            n, m, steps=steps, lr=lr)
    tk, tbest, tinit = TS.softmask_nm_prune(_t(w), _t(h), n, m, steps=steps,
                                            lr=lr)
    np.testing.assert_allclose(float(tbest), float(jbest), rtol=1e-4)
    assert float(tbest) <= float(tinit)
    diff, groups = _group_diff(tk.numpy(), np.asarray(jk), m)
    assert diff == 0, f"{diff} of {groups} groups differ"


def test_batched_equals_one_at_a_time():
    probs = [_problem(s) for s in (8, 9, 10)]
    ws = torch.stack([_t(w) for w, _ in probs])
    hs = torch.stack([_t(h) for _, h in probs])
    keep, best, init = TS.softmask_nm_prune_batched(ws, hs, 2, 4, steps=24)
    for i, (w, h) in enumerate(probs):
        k1, b1, i1 = TS.softmask_nm_prune(_t(w), _t(h), 2, 4, steps=24)
        assert torch.equal(keep[i], k1)
        np.testing.assert_allclose(float(best[i]), float(b1), rtol=1e-6)
        np.testing.assert_allclose(float(init[i]), float(i1), rtol=1e-6)
    # and against JAX's vmapped form
    jk, jb, _ = JS.softmask_nm_prune_batched(
        jnp.asarray(ws.numpy()), jnp.asarray(hs.numpy()), 2, 4, steps=24)
    np.testing.assert_allclose(best.numpy(), np.asarray(jb), rtol=1e-4)
    diff, groups = _group_diff(keep.reshape(-1, 32).numpy(),
                               np.asarray(jk).reshape(-1, 32), 4)
    assert diff <= 0.01 * groups, f"{diff} of {groups} groups differ"


def _record_jax_errors(monkeypatch):
    """Each linear's (err_best, err_init) of JAX's anneal, in call order.
    The sweep's mask-program prewarm calls the same functions from another
    thread on zero weights; only the main thread's calls are kept."""
    import threading

    calls = []

    def wrap(fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            if threading.current_thread() is threading.main_thread():
                calls.append((np.atleast_1d(np.asarray(out[1])),
                              np.atleast_1d(np.asarray(out[2]))))
            return out
        # the batched form vmaps the single one's unjitted body
        if hasattr(fn, "__wrapped__"):
            recorded.__wrapped__ = fn.__wrapped__
        return recorded

    for name in ("softmask_nm_prune", "softmask_nm_prune_batched"):
        monkeypatch.setattr(JS, name, wrap(getattr(JS, name)))
    return calls


def test_t5_softmask_pruner_matches_jax(monkeypatch):
    """``t5_softmask_pruner`` (2:4, 16 steps) over the tiny fp32 T5's two
    stacks, masks kept: every mask 2:4, and within the stated tolerance of
    JAX's (all the groups of a linear counted together); each linear's
    final and starting OBS errors within 1e-4 relative of JAX's, the final
    at most the starting one."""
    jcalls = _record_jax_errors(monkeypatch)
    _, variables, tm, _ = tiny_blip(seed=81, masks=False)
    from vlm_compression_tpu.models import t5 as JT
    from test_torch_models import tiny_blip_configs

    jcfg, _ = tiny_blip_configs()
    jt5 = JT.T5ForConditionalGeneration(jcfg.t5)
    jvars = {"params": variables["params"]["t5_model"]}
    batches = [{k: b[k] for k in ("input_ids", "attention_mask", "labels")}
               for b in _calib_batches(82)]
    spec = dict(prune_spec="2-0.5-1.0-1.0", num_samples=8, prune_n=2,
                prune_m=4, softmask_steps=16)
    jres, _ = jax_load_pruner(
        "t5_softmask_pruner", FlaxModel(jt5, _copy_spine(jvars)),
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
        **spec).prune(lora_model=True)
    pruner = load_pruner("t5_softmask_pruner", tm.t5_model,
                         [{k: _t(v) for k, v in b.items()} for b in batches],
                         **spec)
    with torch.no_grad():
        tres, _ = pruner.prune(lora_model=True)
    got = export_masks(tres)
    want = {p[:-1]: np.asarray(m) for p, m in
            flatten(jres.variables["masks"]).items()}
    assert set(got) == set(want) and len(got) == 2 * 7 + 2 * 11
    diff = groups = 0
    for path in want:
        g = got[path].T                       # unit-major: groups of in
        assert (g.reshape(g.shape[0], -1, 4).sum(-1) == 2).all()
        d, n = _group_diff(g, want[path].T, 4)
        diff, groups = diff + d, groups + n
    assert diff <= 0.01 * groups, f"{diff} of {groups} groups differ"
    errs = pruner.softmask_errors
    assert len(errs) == len(got)
    assert all(float(b) <= float(i) for b, i in errs)
    # both sweeps anneal the same linears in the same order
    jbest = np.concatenate([b for b, _ in jcalls])
    jinit = np.concatenate([i for _, i in jcalls])
    assert len(jbest) == len(errs)
    np.testing.assert_allclose([float(b) for b, _ in errs], jbest,
                               rtol=1e-4)
    np.testing.assert_allclose([float(i) for _, i in errs], jinit,
                               rtol=1e-4)


@pytest.mark.parametrize("kw", [{}, dict(prune_n=2), dict(prune_m=4)])
def test_softmask_needs_nm(kw):
    from vlm_compression_tpu.compression.pruners import methods as JMe
    from vlm_compression_tpu_torch.compression.pruners import methods as TMe

    for mod in (JMe, TMe):
        with pytest.raises(ValueError, match="n:m only"):
            mod.softmask_mask_fn(**kw)
