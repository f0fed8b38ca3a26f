"""Block merging, port vs the JAX package on the CPU: the parsers; the
mean, weighted and regex-gated merges of the tiny fp32 InstructBLIP-T5's
towers (every merged leaf bit-equal to JAX's, the regex matched against
the same '/'-joined names); masks merged by OR; the FFN permutation
recovering a shuffle (ViT and T5's gated FFN); the merged tiny model's
logits within the models' 1e-4 of JAX's merged model's; and the size
accounting over JAX's ``params`` collection."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import TOL, tiny_blip
from vlm_compression_tpu.compression import distill_merge as JD
from vlm_compression_tpu.models import blip2_t5_instruct as JB
from vlm_compression_tpu_torch.cli.evaluate import load_checkpoint
from vlm_compression_tpu_torch.compression import distill_merge as TD
from vlm_compression_tpu_torch.models import blip2_t5_instruct as TB
from vlm_compression_tpu_torch.models.bridge import flatten


@pytest.mark.parametrize("spec,want", [
    ("0,1;2-4;5", [[0, 1], [2, 3, 4], [5]]), ("3", [[3]]),
    ("0-3;4-7;", [[0, 1, 2, 3], [4, 5, 6, 7]]), (" 0 , 2 ; 1 ", [[0, 2], [1]])])
def test_parse_block_ids_matches_jax(spec, want):
    assert TD.parse_block_ids(spec) == JD.parse_block_ids(spec) == want


@pytest.mark.parametrize("spec", [None, "", "0.3,0.7;1,1,1;1"])
def test_parse_block_weights_matches_jax(spec):
    groups = [[0, 1], [2, 3, 4], [5]]
    assert TD.parse_block_weights(spec, groups) == \
        JD.parse_block_weights(spec, groups)


def test_parse_block_weights_rejects_a_wrong_count():
    for mod in (JD, TD):
        with pytest.raises(ValueError, match="do not match"):
            mod.parse_block_weights("1,2,3", [[0, 1]])


def _tower_state(tm, prefix):
    head = prefix + "."
    return {k[len(head):]: v for k, v in tm.state_dict().items()
            if k.startswith(head)}


def _jax_tower(variables, prefix):
    node = variables["params"]
    for k in prefix.split("."):
        node = node[k]
    return node


@pytest.mark.parametrize("groups,weights,regex", [
    ([[0, 1]], None, ".*"),
    ([[1, 0]], [[0.3, 0.7]], ".*"),
    ([[0, 1]], None, "mlp/fc1|ffn/wi_0/kernel|attn/qkv"),
    ([[1]], None, ".*"),
    ([[0], [1]], [[1.0], [2.0]], "kernel"),
], ids=["mean", "weighted", "regex", "drop_one", "scaled"])
@pytest.mark.parametrize("prefix", ["visual_encoder", "t5_model.encoder",
                                    "t5_model.decoder"])
def test_merge_matches_jax_leaf_for_leaf(prefix, groups, weights, regex):
    _, variables, tm, _ = tiny_blip(seed=101, masks=False)
    want = JD.merge_tower_blocks(_jax_tower(variables, prefix), groups,
                                 weights, modules_to_merge=regex)
    got = TD.merge_tower_blocks(_tower_state(tm, prefix), groups, weights,
                                modules_to_merge=regex)
    want = {".".join(p): np.asarray(v) for p, v in flatten(want).items()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert f"blocks_{len(groups)}.ln_1.scale" not in got


def test_masks_merge_by_or():
    """Bool leaves keep where any block keeps; a regex-gated mask keeps the
    first block's."""
    _, variables, tm, _ = tiny_blip(seed=102, masks=True)
    jtower = {b: {"mlp": {"fc1": {"mask": np.asarray(
        variables["masks"]["visual_encoder"][b]["mlp"]["fc1"]["mask"])}}}
        for b in ("blocks_0", "blocks_1")}
    state = {k: v for k, v in _tower_state(tm, "visual_encoder").items()
             if k.endswith("mlp.fc1.mask")}
    for regex, first_only in ((".*", False), ("kernel", True)):
        want = JD.merge_tower_blocks(jtower, [[0, 1]],
                                     modules_to_merge=regex)
        got = TD.merge_tower_blocks(state, [[0, 1]], modules_to_merge=regex)
        m = got["blocks_0.mlp.fc1.mask"]
        assert m.dtype == torch.bool
        np.testing.assert_array_equal(
            m.numpy(), want["blocks_0"]["mlp"]["fc1"]["mask"])
        a, b = state["blocks_0.mlp.fc1.mask"], state["blocks_1.mlp.fc1.mask"]
        assert torch.equal(m, a if first_only else a | b)


@pytest.mark.parametrize("prefix,up,down", [
    ("visual_encoder", ("mlp.fc1",), "mlp.fc2"),
    ("t5_model.encoder", ("ffn.wi_0", "ffn.wi_1"), "ffn.wo")])
def test_permutation_recovers_a_shuffle(prefix, up, down):
    """Block 1 := block 0 with its FFN hidden units shuffled (masks too):
    the permuted merge gives block 0 back, as JAX's does."""
    _, variables, tm, _ = tiny_blip(seed=103, masks=True)
    state = _tower_state(tm, prefix)
    hidden = state[f"blocks_0.{down}.kernel"].shape[0]
    perm = torch.from_numpy(np.random.default_rng(5).permutation(hidden))
    for k in [k for k in state if k.startswith("blocks_1.")]:
        del state[k]
    for k, v in list(state.items()):
        if not k.startswith("blocks_0."):
            continue
        inner = k[len("blocks_0."):]
        lin, _, leaf = inner.rpartition(".")
        if lin in up and leaf in ("kernel", "mask"):
            v = v[:, perm]
        elif lin in up and leaf == "bias":
            v = v[perm]
        elif lin == down and leaf in ("kernel", "mask"):
            v = v[perm, :]
        state["blocks_1." + inner] = v.clone()
    got = TD.merge_tower_blocks(state, [[0, 1]], permute=True)
    for k, v in state.items():
        if k.startswith("blocks_0."):
            if v.dtype == torch.bool:
                assert torch.equal(got[k], v), k
            else:
                torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-6)
    # JAX's merge of the same params tree
    jtower = {}
    for k, v in state.items():
        if k.endswith(".mask"):
            continue
        node = jtower
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v.numpy()
    want = JD.merge_tower_blocks(jtower, [[0, 1]], permute=True)
    for p, v in flatten(want).items():
        np.testing.assert_array_equal(got[".".join(p)].numpy(), v)


def test_merged_tiny_model_logits_match_jax():
    """Both towers merged pairwise (weighted for the encoder, permuted),
    each package's model rebuilt at the merged depths: logits within the
    models' 1e-4."""
    jm, variables, tm, batch = tiny_blip(seed=104, masks=False)
    params = dict(variables["params"])
    vit = JD.merge_tower_blocks(params["visual_encoder"], [[0, 1]],
                                permute=True)
    t5 = dict(params["t5_model"])
    t5["encoder"] = JD.merge_tower_blocks(t5["encoder"], [[1, 0]],
                                          [[0.25, 0.75]], permute=True)
    t5["decoder"] = JD.merge_tower_blocks(t5["decoder"], [[0, 1]],
                                          permute=True)
    params.update(visual_encoder=vit, t5_model=t5)
    jcfg = dataclasses.replace(
        jm.cfg, vit=dataclasses.replace(jm.cfg.vit, depth=1),
        t5=dataclasses.replace(jm.cfg.t5, num_layers=1,
                               num_decoder_layers=1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = JB.Blip2T5Instruct(jcfg).apply({"params": params}, **jb)

    state = tm.state_dict()
    for prefix, groups, weights in (
            ("visual_encoder", [[0, 1]], None),
            ("t5_model.encoder", [[1, 0]], [[0.25, 0.75]]),
            ("t5_model.decoder", [[0, 1]], None)):
        head = prefix + "."
        tower = {k[len(head):]: state.pop(k) for k in list(state)
                 if k.startswith(head)}
        state.update({head + k: v for k, v in TD.merge_tower_blocks(
            tower, groups, weights, permute=True).items()})
    tcfg = dataclasses.replace(
        tm.cfg, vit=dataclasses.replace(tm.cfg.vit, depth=1),
        t5=dataclasses.replace(tm.cfg.t5, num_layers=1,
                               num_decoder_layers=1))
    merged = TB.Blip2T5Instruct(tcfg, device="cpu")
    load_checkpoint(merged, state)
    with torch.no_grad():
        got = merged(**{k: torch.from_numpy(np.array(v))
                        for k, v in batch.items()})
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **TOL)


def test_size_accounting_counts_jax_params_collection():
    """``count_params`` / ``count_nonzero`` count what JAX's count over the
    ``params`` collection: the LoRA factors (JAX's ``lora`` collection)
    are left out."""
    from vlm_compression_tpu.models.factory import build_model as jax_build
    from vlm_compression_tpu_torch.models.factory import build_model

    cfg = {"arch": "blip2_t5_instruct", "tiny": True, "tune_opt": "LVQ",
           "lora_r_v": 2, "lora_r_l": 2, "lora_r_q": 2}
    _, variables = jax_build(cfg, seed=0)
    model = build_model(cfg, device="cpu")
    assert any(n.endswith("lora_a") for n, _ in model.named_parameters())
    assert TD.count_params(model) == JD.count_params(variables["params"])
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(1.0)
    assert TD.count_nonzero(model) == TD.count_params(model)
