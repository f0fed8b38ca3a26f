"""WoodFisher, port vs the JAX package on the CPU: the Sherman–Morrison
fold against JAX's ``_sm_fold`` (within 1e-5 relative of the block's
largest entry) and against an fp64 dense inverse of damp·I + (1/N) Σ g gᵀ;
``_chunk``; and the tiny fp32 InstructBLIP-T5's scores, with ``include``
and ``ignore_keys``, within 1e-4 relative of JAX's (the fisher_inv_diag
too)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import blip_batch, tiny_blip, tiny_blip_configs
from vlm_compression_tpu.compression import woodfisher as JW
from vlm_compression_tpu.compression.pruners.base import FlaxModel
from vlm_compression_tpu_torch.compression import woodfisher as TW


@pytest.mark.parametrize("n,c,parts,damp", [(12, 6, 1, 1e-2),
                                            (5, 16, 3, 1e-3),
                                            (8, 256, 2, 1e-3)])
def test_sm_fold_matches_jax_and_the_dense_inverse(n, c, parts, damp):
    rng = np.random.default_rng(0)
    grads = (rng.standard_normal((n, parts, c)) * 0.1).astype(np.float32)
    finv0 = np.broadcast_to(np.eye(c, dtype=np.float32) / damp,
                            (parts, c, c)).copy()
    want = np.asarray(JW._sm_fold(jnp.asarray(finv0), jnp.asarray(grads), n))
    got = TW._sm_fold(torch.from_numpy(finv0.copy()),
                      torch.from_numpy(grads), n).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    for p in range(parts):
        g = grads[:, p, :].astype(np.float64)
        dense = np.linalg.inv(damp * np.eye(c) + g.T @ g / n)
        np.testing.assert_allclose(got[p], dense, rtol=0,
                                   atol=2e-4 * np.abs(dense).max())
        # the diagonal, which the scores read, closely
        np.testing.assert_allclose(np.diagonal(got[p]), np.diagonal(dense),
                                   rtol=1e-4)


@pytest.mark.parametrize("numel,chunk", [(10, 4), (12, 4), (1, 3)])
def test_chunk_pads_and_reshapes_as_jax(numel, chunk):
    flat = np.arange(2 * numel, dtype=np.float32).reshape(2, numel) + 1
    want = np.asarray(JW._chunk(jnp.asarray(flat), chunk))
    got = TW._chunk(torch.from_numpy(flat), chunk).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, -(-numel // chunk), chunk)


def _both(include, ignore_keys=(), max_chunk=16, n=3):
    jm, variables, tm, _ = tiny_blip(seed=91, masks=False)
    jcfg, _ = tiny_blip_configs()
    batch = blip_batch(np.random.default_rng(92), jcfg, b=n)
    jwf = JW.WoodFisher(FlaxModel(jm, dict(variables)),
                        [{k: jnp.asarray(v) for k, v in batch.items()}],
                        num_samples=n, include=include,
                        ignore_keys=ignore_keys, max_chunk=max_chunk)
    want = jwf.compute_fisher_inv_and_importance_score()
    twf = TW.WoodFisher(tm, [{k: torch.from_numpy(np.array(v))
                              for k, v in batch.items()}],
                        num_samples=n, include=include,
                        ignore_keys=ignore_keys, max_chunk=max_chunk)
    got = twf.compute_fisher_inv_and_importance_score()
    return want, got, jwf, twf


def _close(got, want):
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path].numpy()
        assert g.shape == w.shape, path
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 * scale,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("tower", ["visual_encoder", "t5_model"])
def test_scores_match_jax_with_include(tower):
    want, got, jwf, twf = _both(lambda p: p[0] == tower)
    assert want and set(got) == set(want)
    assert all(p[0] == tower for p in got)
    _close(got, want)
    _close(twf.fisher_inv_diag, jwf.fisher_inv_diag)
    assert all(bool((s >= 0).all()) for s in got.values())


def test_scores_match_jax_with_ignore_keys():
    """Both towers, the attention leaves and biases ignored; the T5
    position embedding (a bias gradient in every self-attention) kept."""
    want, got, _, _ = _both(
        lambda p: p[0] in ("visual_encoder", "t5_model"),
        ignore_keys=("attn", "/bias"), max_chunk=32, n=2)
    assert want and set(got) == set(want)
    assert not any("attn" in "/".join(p) for p in got)
    assert ("t5_model", "encoder", "rel_bias", "rel_embedding") in got
    _close(got, want)


def test_requires_grad_flags_are_restored():
    _, _, tm, _ = tiny_blip(seed=93, masks=False)
    tm.requires_grad_(False)
    jcfg, _ = tiny_blip_configs()
    batch = blip_batch(np.random.default_rng(94), jcfg, b=2)
    TW.WoodFisher(tm, [{k: torch.from_numpy(np.array(v))
                        for k, v in batch.items()}], num_samples=1,
                  include=lambda p: p[0] == "t5_model"
                  ).compute_fisher_inv_and_importance_score()
    assert not any(p.requires_grad for p in tm.parameters())
