"""The three ``*_gptq_pruner`` names of the port vs the JAX package on
the CPU, on the tiny towers: joint 4-bit quantization and pruning at 0.5
over the ViT and both T5 stacks (with and without AWQ, AWQ on the
asymmetric grid, the LoRA masks kept and dropped), and the ViT and T5
tower pruners quantizing only, with AWQ on the asymmetric and the
symmetric grid, jointly, and on a 3-bit asymmetric grid with act order.
With AWQ on the asymmetric grid each linear's chosen α is held against
JAX's.  The sweeps' own
tolerances, and the two causes that move a code by a step (grid ties and
XLA's compiled arithmetic), are stated in tests/test_torch_gptq.py.

The pruner tests draw every bias of the tiny towers from the seed (a
LayerNorm's zero bias makes the Hessian of the linear it feeds singular;
see tests/test_torch_sparsegpt.py).  The tiny towers are 16 and 32 wide,
so the pruners run at group 16.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import tiny_blip
from test_torch_pipeline import SPECS, _calib_batches, _copy_spine, _t
from test_torch_sparsegpt import (
    _block_linears,
    _seeded_biases,
    _t5_case,
    _vit_case,
)
from vlm_compression_tpu.compression import load_pruner as jax_load_pruner
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu_torch.compression import load_pruner
from vlm_compression_tpu_torch.models.bridge import export_masks, flatten


# The pruners' sweeps, end to end.  Each block calibrates on activations
# replayed through the blocks the sweep has already quantized, so a code
# that rounds the other way in one block changes the next block's
# Hessians, and the difference grows down the towers.  Codes do round the
# other way: the port's H⁻¹ differs from the JAX package's in its last
# bits (the factorization routes above), and the symmetric grid puts a
# group's largest-magnitude weight exactly on a rounding tie (±7.5 steps)
# when it is the group's first column, where the last bit of the scale
# decides (the positive side is clamped back, the negative one is not).
# Measured over the cases below (tiny towers, 8 calibration samples,
# group 16): of the kernel entries, at most 8.9 % outside W_TOL without
# AWQ (0 on the T5 tower with the 3-bit asymmetric grid); of the mask
# bits, at most 1.71 %.  The bounds below hold those, and the structure
# holds exactly.
#
# AWQ.  On a symmetric grid at group 16 one entry in about 32 is such a
# tie, and the JAX package's jitted ``awq_search`` resolves them with
# XLA's compiled arithmetic, not its eager ops (which the port matches):
# on the sweep's very first linear, on inputs equal to 2e-7, its
# candidate losses differ from the port's by up to 21 % (the eager JAX
# search's by 5e-7), so its α is not the port's to compare.  There the
# kernels are held to the structure and a loose bound (measured 49 % of
# the entries outside W_TOL).  An asymmetric grid has no such ties: there
# each linear's chosen α is held against JAX's (recorded from both
# searches) — equal on every linear of the sweep's first block, whose
# inputs are the calibration batch itself, and on at least
# MIN_ALPHA_SHARE of all linears (later blocks replay activations that
# moved codes have changed, and candidates within a few per cent swap;
# measured 70-100 %) — the first block's kernels within W_TOL wherever α
# agree (measured: every entry), and at most 20 % of all kernel entries
# outside W_TOL (measured 14.8 %).
PRUNER_W_TOL = dict(rtol=5e-3, atol=5e-4)   # SparseGPT's (its tests')
MAX_KERNEL_DIFF = {"plain": 0.10, "awq": 0.20, "awq_sym": 0.55}
MAX_MASK_DIFF = 0.02
MIN_ALPHA_SHARE = 0.6
FIRST_BLOCK_W_DIFF = 0.0


def _assert_quantized_like_jax(tres, jvars, paths, lora_model, keep, kind,
                               grouped=True):
    """Structure exactly: masks all True where only quantized, 1 − s ±
    0.1 where pruned, none with lora_model=False; pruned entries zero;
    without act order (``grouped``) at most 16 values in each (unit,
    16-row group).  Against JAX: mask bits and kernel entries within the
    bounds above."""
    tparams = dict(tres.named_parameters())
    params = flatten(jvars["params"])
    got_masks = export_masks(tres)
    n_bits = n_bits_diff = n_w = n_w_diff = 0
    if lora_model:
        want = {path[:-1]: np.asarray(m) for path, m in
                flatten(jvars["masks"]).items()}
        assert set(got_masks) == set(want) == set(paths)
        for path in paths:
            assert abs(got_masks[path].mean() - keep) < 0.1
            if keep == 1.0:
                assert got_masks[path].all() and want[path].all()
            n_bits += want[path].size
            n_bits_diff += int((got_masks[path] != want[path]).sum())
    else:
        assert got_masks == {}
    for path in paths:
        want_k = np.asarray(params[path + ("kernel",)])
        got_k = tparams[".".join(path + ("kernel",))].detach().numpy()
        if lora_model:
            assert not got_k[~got_masks[path]].any(), "/".join(path)
        n_w += want_k.size
        n_w_diff += int((~np.isclose(got_k, want_k,
                                     **PRUNER_W_TOL)).sum())
        if grouped:
            groups = got_k.reshape(-1, 16, got_k.shape[1])
            distinct = max(len(np.unique(groups[g, :, u]))
                           for g in range(groups.shape[0])
                           for u in range(groups.shape[2]))
            assert distinct <= 16, "/".join(path)
    assert n_bits_diff <= MAX_MASK_DIFF * max(n_bits, 1)
    assert n_w_diff <= MAX_KERNEL_DIFF[kind] * n_w, n_w_diff / n_w


@pytest.fixture
def alphas(monkeypatch):
    """Each linear's chosen α in both sweeps, in sweep order: the port's
    from ``methods.awq_search``, the JAX package's from its search (a
    debug callback traced on the main thread, so the sweep's prewarm
    calls are left out; a vmapped group calls back once per linear, in
    order), with JAX's candidate losses; and the port's sweep order as
    (block, in-block path), the blocks counted over the towers."""
    import itertools
    import threading

    import jax
    import vlm_compression_tpu.ops.awq as JA
    import vlm_compression_tpu_torch.compression.pruners.methods as TM

    rec = {"jax": [], "port": [], "order": []}
    real_j, real_t, real_fn = JA.awq_search, TM.awq_search, TM.gptq_fn
    traced, calls = itertools.count(), itertools.count()

    def jax_search(*a, **kw):
        out = real_j(*a, **kw)
        if threading.current_thread() is threading.main_thread():
            i = next(traced)
            jax.debug.callback(
                lambda al, lo: rec["jax"].append(
                    (i, float(al), np.asarray(lo))), out.alpha, out.losses)
        return out

    def port_search(*a, **kw):
        out = real_t(*a, **kw)
        rec["port"].append(float(out.alpha))
        return out

    def gptq_fn(*a, **kw):
        fn = real_fn(*a, **kw)

        def recorded(kernels, stats, sparsities):
            call, groups = next(calls), {}
            for p, k in kernels.items():
                groups.setdefault((tuple(k.shape), float(sparsities[p])),
                                  []).append(p)
            rec["order"] += [(call, p) for g in groups.values() for p in g]
            return fn(kernels, stats, sparsities)
        return recorded

    monkeypatch.setattr(JA, "awq_search", jax_search)
    monkeypatch.setattr(TM, "awq_search", port_search)
    monkeypatch.setattr(TM, "gptq_fn", gptq_fn)
    return rec


def _assert_alphas_like_jax(rec, tres, jvars, paths, first_block):
    """The rules of the AWQ note above, on an asymmetric grid;
    ``first_block`` is the path of the block the sweep takes first."""
    import jax

    jax.effects_barrier()
    want = [(al, lo) for _, al, lo in sorted(rec["jax"], key=lambda r: r[0])]
    got, order = rec["port"], rec["order"]
    assert len(want) == len(got) == len(order) == len(paths)
    same = [a == w for a, (w, _) in zip(got, want)]
    assert sum(same) >= MIN_ALPHA_SHARE * len(same), (got, want)
    first = [i for i, (call, _) in enumerate(order) if call == 0]
    assert first and all(same[i] for i in first), (got, want)
    # the first block's kernels, where both sweeps saw the same inputs
    tparams = dict(tres.named_parameters())
    params = flatten(jvars["params"])
    first_paths = [p for p in paths if p[:len(first_block)] == first_block]
    assert sorted(p[len(first_block):] for p in first_paths) == sorted(
        order[i][1] for i in first)
    for path in first_paths:
        want_k = np.asarray(params[path + ("kernel",)])
        got_k = tparams[".".join(path + ("kernel",))].detach().numpy()
        off = (~np.isclose(got_k, want_k, **PRUNER_W_TOL)).mean()
        assert off <= FIRST_BLOCK_W_DIFF, ("/".join(path), off)


GPTQ_KNOBS = dict(gptq_group=16)


@pytest.mark.parametrize("lora_model,awq", [(True, False), (False, False),
                                            (True, True), (False, True)])
def test_blipt5_gptq_pruner_matches_jax(lora_model, awq, alphas):
    """Joint 4-bit quantization and pruning at 0.5 over the ViT and both
    T5 stacks, against JAX's sweep within the bounds above; with AWQ on
    the asymmetric grid, each linear's α held against JAX's."""
    jm, variables, tm, _ = tiny_blip(seed=51, masks=False)
    variables = _seeded_biases(variables, tm, 51)
    batches = _calib_batches(52)
    knobs = dict(GPTQ_KNOBS, gptq_awq=awq,
                 **(dict(gptq_sym=False) if awq else {}))
    jp = jax_load_pruner(
        "blipt5_gptq_pruner", FlaxModel(jm, _copy_spine(variables)),
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
        **SPECS, **knobs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres, _ = jp.prune(lora_model=lora_model)
    tp = load_pruner("blipt5_gptq_pruner", tm,
                     [{k: _t(v) for k, v in b.items()} for b in batches],
                     **SPECS, **knobs)
    assert tp.with_hessian and tp.gptq_awq == awq and tp.gptq_group == 16
    with torch.no_grad():
        tres, _ = tp.prune(lora_model=lora_model)
    assert tres is tm
    paths = _block_linears(jres.variables["params"], (
        ("visual_encoder",), ("t5_model", "encoder"), ("t5_model", "decoder")))
    assert len(paths) == 2 * 4 + 2 * 7 + 2 * 11
    _assert_quantized_like_jax(tres, jres.variables, paths, lora_model, 0.5,
                               "awq" if awq else "plain")
    if awq:
        _assert_alphas_like_jax(alphas, tres, jres.variables, paths,
                                ("visual_encoder", "blocks_0"))


@pytest.mark.parametrize("keep,awq,knobs", [
    (1.0, False, dict()), (1.0, True, dict(gptq_sym=False)),
    (1.0, True, dict()), (0.5, False, dict()),
    (1.0, False, dict(gptq_sym=False, gptq_actorder=True, gptq_bits=3))],
    ids=["quantize", "quantize_awq", "quantize_awq_sym", "joint",
         "asym3_act_order"])
@pytest.mark.parametrize("tower", ["t5", "vit"])
def test_tower_gptq_pruners_match_jax(tower, keep, awq, knobs, alphas):
    jm, variables, tm, batches, towers = (_t5_case if tower == "t5"
                                          else _vit_case)(53)
    variables = _seeded_biases(variables, tm, 53)
    spec = dict(prune_spec=f"2-{keep}-1.0-1.0", num_samples=8,
                **dict(GPTQ_KNOBS, gptq_awq=awq, **knobs))
    name = f"{tower}_gptq_pruner"
    jp = jax_load_pruner(name, FlaxModel(jm, _copy_spine(variables)),
                         [{k: jnp.asarray(v) for k, v in b.items()}
                          for b in batches], **spec)
    jres, _ = jp.prune(lora_model=True)
    tp = load_pruner(name, tm, [{k: _t(v) for k, v in b.items()}
                                for b in batches], **spec)
    with torch.no_grad():
        tres, _ = tp.prune(lora_model=True)
    paths = _block_linears(jres.variables["params"], towers)
    assert paths
    sym = knobs.get("gptq_sym", True)
    _assert_quantized_like_jax(
        tres, jres.variables, paths, True, keep,
        ("awq_sym" if sym else "awq") if awq else "plain",
        grouped=not knobs.get("gptq_actorder"))
    if awq and not sym:
        _assert_alphas_like_jax(alphas, tres, jres.variables, paths,
                                towers[0] + ("blocks_0",))
