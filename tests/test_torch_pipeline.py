"""The port's slice end to end vs the JAX package on the CPU (tiny fp32
InstructBLIP-T5): the ``blipt5_wanda_pruner`` sweep (every mask bit-equal;
in the non-LoRA path every zeroed kernel equal) and ``generate_t5`` greedy
and beam-5 decoding (token-equal), plus the logits processors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import blip_batch, tiny_blip, tiny_blip_configs
from vlm_compression_tpu.compression import load_pruner as jax_load_pruner
from vlm_compression_tpu.compression.calibrate import linear_paths
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.models import blip2_t5_instruct as JB
from vlm_compression_tpu.models import generation as JG
from vlm_compression_tpu_torch.compression import load_pruner
from vlm_compression_tpu_torch.models import blip2_t5_instruct as TB
from vlm_compression_tpu_torch.models import generation as TG
from vlm_compression_tpu_torch.models.bridge import export_masks, flatten


def _t(x):
    return torch.from_numpy(np.array(x))


def _copy_spine(node):
    """The JAX engine pops block subtrees from the tree it is given."""
    if isinstance(node, dict):
        return {k: _copy_spine(v) for k, v in node.items()}
    return jnp.asarray(node)


def _calib_batches(seed, n=2, bs=4):
    rng = np.random.default_rng(seed)
    jcfg, _ = tiny_blip_configs()
    out = []
    for _ in range(n):
        b = blip_batch(rng, jcfg, b=bs, txt=6, lbl=4)
        out.append(b)
    return out


SPECS = dict(vit_prune_spec="2-0.5-1.0-1.0", t5_prune_spec="2-0.5-1.0-1.0",
             num_samples=8)


@pytest.mark.parametrize("lora_model", [True, False])
def test_blipt5_wanda_pruner_matches_jax(lora_model):
    jm, variables, tm, _ = tiny_blip(seed=11, masks=False)
    batches = _calib_batches(12)
    jp = jax_load_pruner(
        "blipt5_wanda_pruner", FlaxModel(jm, _copy_spine(variables)),
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches], **SPECS)
    jres, _ = jp.prune(lora_model=lora_model)
    tp = load_pruner("blipt5_wanda_pruner", tm,
                     [{k: _t(v) for k, v in b.items()} for b in batches],
                     **SPECS)
    with torch.no_grad():
        tres, _ = tp.prune(lora_model=lora_model)
    assert tres is tm

    # the pruned linears: every block linear of the ViT and both T5 stacks
    pruned = []
    params = jres.variables["params"]
    for tower in (("visual_encoder",), ("t5_model", "encoder"),
                  ("t5_model", "decoder")):
        node = params
        for p in tower:
            node = node[p]
        for bname, bparams in node.items():
            if bname.startswith("blocks_"):
                pruned += [tower + (bname,) + lp for lp in linear_paths(bparams)]
    assert len(pruned) == 2 * 4 + 2 * 7 + 2 * 11

    got = export_masks(tres)
    if lora_model:
        want = {path[:-1]: np.asarray(m) for path, m in
                flatten(jres.variables["masks"]).items()}
        assert set(got) == set(want) == set(pruned)
        for path in pruned:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg="/".join(path))
            assert abs(got[path].mean() - 0.5) < 0.1
    else:
        assert got == {}
        tparams = dict(tres.named_parameters())
        for path in pruned:
            want_k = np.asarray(flatten(params)[path + ("kernel",)])
            got_k = tparams[".".join(path + ("kernel",))].detach().numpy()
            np.testing.assert_array_equal(got_k == 0, want_k == 0,
                                          err_msg="/".join(path))
            np.testing.assert_array_equal(got_k, want_k)


GEN_CASES = [
    dict(num_beams=1),
    dict(num_beams=1, repetition_penalty=1.3, min_length=3),
    dict(num_beams=5),
    dict(num_beams=5, repetition_penalty=1.5, length_penalty=0.8,
         min_length=2),
]


@pytest.mark.parametrize("case", GEN_CASES)
def test_generate_t5_token_equal_to_jax(case):
    jm, variables, tm, batch = tiny_blip(seed=21, masks=True)
    kw = dict(max_length=8, min_length=1, eos_token_id=1, pad_token_id=0,
              decoder_start_token_id=0)
    kw.update(case)
    args = ("image", "input_ids", "attention_mask", "qformer_input_ids",
            "qformer_attention_mask")
    want = JB.generate_t5(
        jm, jax.tree_util.tree_map(jnp.asarray, variables),
        *[jnp.asarray(batch[a]) for a in args],
        gen_cfg=JG.GenerationConfig(**kw))
    got = TB.generate_t5(tm, *[_t(batch[a]) for a in args],
                         gen_cfg=TG.GenerationConfig(**kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nucleus_sampling_with_tiny_top_p_is_greedy():
    """top_p → 0 keeps only the most likely token, so sampling must give
    the greedy (argmax) sequence whatever the generator draws."""
    _, _, tm, batch = tiny_blip(seed=22, masks=True)
    args = [_t(batch[a]) for a in ("image", "input_ids", "attention_mask",
                                   "qformer_input_ids",
                                   "qformer_attention_mask")]
    kw = dict(max_length=8, eos_token_id=1, pad_token_id=0,
              decoder_start_token_id=0)
    greedy = TB.generate_t5(tm, *args, gen_cfg=TG.GenerationConfig(**kw))
    sampled = TB.generate_t5(
        tm, *args, gen_cfg=TG.GenerationConfig(do_sample=True, top_p=1e-9,
                                               **kw),
        generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(sampled.numpy(), greedy.numpy())


def test_logits_processors_match_jax():
    rng = np.random.default_rng(31)
    logits = rng.standard_normal((2, 3, 11)).astype(np.float32)
    seqs = rng.integers(-1, 11, (2, 3, 6)).astype(np.int32)
    valid = (np.arange(6) < 4)[None, None, :]
    want = np.asarray(JG.apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(seqs), jnp.asarray(valid), 1.7))
    got = TG.apply_repetition_penalty(_t(logits), _t(seqs), _t(valid), 1.7)
    np.testing.assert_array_equal(got.numpy(), want)
    for cur in (1, 4):
        np.testing.assert_array_equal(
            TG.mask_min_length(_t(logits), cur, 3, 2).numpy(),
            np.asarray(JG.mask_min_length(jnp.asarray(logits), cur, 3, 2)))
    for top_p in (0.3, 0.9):
        np.testing.assert_allclose(
            TG.top_p_filter(_t(logits), top_p).numpy(),
            np.asarray(JG.top_p_filter(jnp.asarray(logits), top_p)),
            atol=1e-6, rtol=1e-6)
