"""The port's mesh and sharding rules (``parallel/mesh.py``) vs the JAX
package's on the CPU: mesh axis names, shapes and errors (JAX's
``test_mesh_and_sharding`` and ``test_sharding_fallback_when_indivisible``
as models), every leaf's spec of the tiny InstructBLIP-T5 (with LoRA) and
InstructBLIP-Vicuna under every rule table, with the replication fallback
where the sizes do not divide, and — in 4 gloo ranks — ``shard_params``
then ``gather_params`` bit-equal, each stored block the shape its spec
gives, the compressed forms refused, and ``data_sharding`` over
(replica, data).  Exact: specs, shapes and tensors compare equal.
"""

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from test_torch_models import tiny_lora_blip, tiny_lora_configs
from test_torch_vicuna import tiny_vicuna
from torch_parallel_ranks import round_trip_rank
from vlm_compression_tpu.parallel import mesh as JM
from vlm_compression_tpu_torch.models.bridge import flatten
from vlm_compression_tpu_torch.parallel import mesh as TM
from vlm_compression_tpu_torch.parallel.collectives import spawn

# the keys of the JAX package's dry-run line, in its order
JAX_TAIL_KEYS = ["mesh", "loss", "prune_mask_checksum", "density",
                 "mask_equal", "mask_mismatch", "blipt5_prune_layers",
                 "blipt5_mask_mismatch", "blipt5_mask_equal", "sp_encoder_ok",
                 "pipeline_loss", "sharded_flash_ok", "merged_results"]
RULES = {"default": (JM.DEFAULT_RULES, TM.DEFAULT_RULES),
         "fsdp": (JM.FSDP_RULES, TM.FSDP_RULES),
         "replicated": (JM.REPLICATED_RULES, TM.REPLICATED_RULES)}


@pytest.mark.parametrize("kw", [
    dict(data=4, model=2), dict(data=-1, model=2), dict(model=8),
    dict(pipe=4, model=2, data=1), dict(pipe=2),
    dict(data=2, model=2, dcn_data=2), dict(model=2, dcn_data=2),
    dict(pipe=2, model=2, dcn_data=2)])
def test_mesh_shape_matches_jax(devices8, kw):
    jm = JM.make_mesh(JM.MeshConfig(**kw), devices=devices8)
    names, shape = TM.mesh_shape(TM.MeshConfig(**kw), 8)
    assert names == jm.axis_names == TM.MeshConfig(**kw).axis_names()
    assert dict(zip(names, shape)) == dict(jm.shape)


@pytest.mark.parametrize("kw", [dict(data=3, model=2), dict(model=3),
                                dict(pipe=3), dict(data=2, dcn_data=3),
                                dict(data=4, model=4)])
def test_mesh_errors_match_jax(devices8, kw):
    with pytest.raises(ValueError) as want:
        JM.make_mesh(JM.MeshConfig(**kw), devices=devices8)
    with pytest.raises(ValueError) as got:
        TM.mesh_shape(TM.MeshConfig(**kw), 8)
    assert str(got.value) == str(want.value)


def test_mesh_and_sharding_rules_match_jax_on_its_toy(devices8):
    """JAX's own toy tree: q column-parallel, wo row-parallel, ln
    replicated; 6 columns over 4 model ranks fall back to replication."""
    tree = {"encoder.attn.query.kernel": (16, 8), "encoder.mlp.wo.kernel":
            (8, 16), "encoder.ln.scale": (16,)}
    specs = TM.param_partition_spec(tree)
    assert specs == {"encoder.attn.query.kernel": (None, "model"),
                     "encoder.mlp.wo.kernel": ("model", None),
                     "encoder.ln.scale": ()}
    assert not TM._spec_fits((None, "model"), (6, 6),
                             {"data": 2, "model": 4})
    assert TM._spec_fits((None, "model"), (6, 8), {"data": 2, "model": 4})


def _jax_specs(variables, mesh, rules):
    """{'/'-joined leaf path: spec tuple} the JAX package places: params
    by ``rules``, masks by ``mask_rules(rules)``, lora by the default
    table, as its KD-step test shards them."""
    out = {}
    for coll, r in (("params", rules), ("masks", JM.mask_rules(rules)),
                    ("lora", JM.DEFAULT_RULES)):
        if coll not in variables:
            continue
        placed = JM.shard_params(variables[coll], mesh, r)
        for path, leaf in flatten(placed).items():
            out["/".join(path)] = tuple(leaf.sharding.spec)
    return out


@pytest.fixture(scope="module")
def tiny_models():
    _, tv, tt, _ = tiny_lora_blip(seed=3)
    _, vv, vt, _ = tiny_vicuna(seed=4)
    return {"t5": (tv, tt), "vicuna": (vv, vt)}


@pytest.mark.parametrize("mesh_kw", [dict(data=4, model=2),
                                     dict(data=2, model=4)])
@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("which", ["t5", "vicuna"])
def test_spec_tree_matches_jax(devices8, tiny_models, which, rules,
                               mesh_kw):
    variables, model = tiny_models[which]
    jrules, trules = RULES[rules]
    jmesh = JM.make_mesh(JM.MeshConfig(**mesh_kw), devices=devices8)
    want = _jax_specs(variables, jmesh, jrules)
    got = {n.replace(".", "/"): s
           for n, s in TM.fitted_specs(model, mesh_kw, trules).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k
    # the table alone, before the fallback, as param_partition_spec
    jraw = jax.tree_util.tree_map(
        tuple, JM.param_partition_spec(variables["params"], jrules),
        is_leaf=lambda x: isinstance(x, P))
    traw = TM.param_partition_spec(model, trules)
    for path, spec in flatten(jraw).items():
        assert traw["/".join(path).replace("/", ".")] == spec


def test_sharded_leaves_are_the_megatron_set(tiny_models):
    """Which tensors the default table shards on the tiny InstructBLIP-T5
    at model = 2 (the compute plans' inputs): q/k/v and FFN-in kernels by
    columns, o/proj/FFN-out by rows, the embeddings by rows."""
    _, model = tiny_models["t5"]
    specs = TM.fitted_specs(model, {"data": 1, "model": 2})
    cols = {n for n, s in specs.items() if s == (None, "model")}
    rows = {n for n, s in specs.items() if s == ("model", None)}
    assert "visual_encoder.blocks_0.attn.qkv.kernel" in cols
    assert "qformer.layers_0.ffn_query.output_dense.kernel" in cols
    assert "qformer.layers_0.attention.output_dense.kernel" not in cols | rows
    assert "t5_model.encoder.blocks_0.self_attn.o.kernel" in rows
    assert "t5_model.shared.embedding" in rows
    assert "t5_model.encoder.rel_bias.rel_embedding" in rows
    assert "t5_model.lm_head.kernel" not in cols | rows
    assert not any("lora" in n for n in cols | rows)


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    cfg = tiny_lora_configs()[1]
    _, variables, _, _ = tiny_lora_blip(seed=5)
    path = tmp_path_factory.mktemp("mesh") / "init"
    return spawn(round_trip_rank, 4, "gloo", str(path), 60.0,
                 args=(cfg, variables))


@pytest.mark.parametrize("key", [f"{m}_{r}" for m in ("2x2", "1x4", "4x1")
                                 for r in ("default", "fsdp", "replicated")])
def test_shard_then_gather_round_trips_bit_equal(round_trip, key):
    for rank in round_trip:
        got = rank["out"][key]
        assert got["shapes_ok"] and got["equal"], (key, got)
        assert got["plans"] == 0             # gather_params drops them


@pytest.mark.parametrize("form", ["int8", "packed"])
def test_compressed_forms_do_not_shard(round_trip, form):
    for rank in round_trip:
        assert "ROADMAP.md" in rank["raised"][form]


def test_data_sharding_cuts_over_replica_and_data(round_trip):
    # (replica 2, data 2, model 1) over 4 ranks: two rows each, in order
    for r, rank in enumerate(round_trip):
        np.testing.assert_array_equal(rank["batch"], [2 * r, 2 * r + 1])


def test_dryrun_multichip_prints_the_jax_runs_keys():
    """The port's dry run (4 gloo ranks, on the CPU as asked) runs every
    section and prints one line with the keys of the JAX run's tail
    (``__graft_entry__.py``'s ``dryrun_multichip``)."""
    import re

    from vlm_compression_tpu_torch.parallel.dryrun import dryrun_multichip

    line = dryrun_multichip(4, timeout=60.0, device="cpu")
    assert re.findall(r"(\w+)=", line) == JAX_TAIL_KEYS
    assert "mask_equal=True" in line and "blipt5_mask_equal=True" in line
    assert "sharded_flash_ok=True" in line and "merged_results=9" in line


def test_dryrun_multichip_runs_on_the_card_unless_asked_for_the_cpu():
    """By default the dry run's ranks run on the card: without one it
    raises before spawning anything, naming the CPU rehearsal."""
    import torch

    from vlm_compression_tpu_torch.parallel.dryrun import dryrun_multichip

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)


@pytest.mark.parametrize("kind", ["masked", "sparse_lora"])
def test_out32_products_on_the_cpu(kind):
    """The matmuls' fp32 output (a row-parallel shard's products, rounded
    once after the sum over ranks) on the CPU: the plain version's fp32
    sums, rounded equal to the bf16 output; its gradients those of the
    bf16 output (the fp32 output gradient holds bf16 values)."""
    import torch

    from vlm_compression_tpu_torch.ops import masked_linear as ML

    g = torch.Generator().manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    x = torch.randn(3, 5, 32, generator=g).to(bf16)
    w = (torch.randn(32, 24, generator=g) * 0.2).to(bf16)
    mask = torch.rand(32, 24, generator=g) < 0.5
    a = (torch.randn(32, 4, generator=g) * 0.2).to(bf16)
    b = (torch.randn(4, 24, generator=g) * 0.2).to(bf16)
    gy = torch.randn(3, 5, 24, generator=g).to(bf16)

    def run(out_dtype):
        xs, ws, as_, bs = (t.clone().requires_grad_(True)
                           for t in (x, w, a, b))
        if kind == "masked":
            y = ML.masked_matmul(xs, ws, mask, out_dtype=out_dtype)
        else:
            y = ML.sparse_lora_matmul(xs, ws, mask, as_, bs, 4.0,
                                      out_dtype=out_dtype)
        y.backward(gy.to(y.dtype))
        grads = [t.grad for t in (xs, ws, as_, bs) if t.grad is not None]
        return y.detach(), grads

    y32, g32 = run(f32)
    y16, g16 = run(None)
    want = (ML.masked_matmul_ref(x, w, mask, f32) if kind == "masked" else
            ML.sparse_lora_matmul_ref(x, w, mask, a, b, 4.0, f32))
    assert y32.dtype == f32 and torch.equal(y32, want)
    assert torch.equal(y32.to(bf16), y16)
    assert len(g32) == len(g16) and all(
        torch.equal(p, q) for p, q in zip(g32, g16))
    with pytest.raises(TypeError, match="out_dtype"):
        ML.masked_matmul(x, w, mask, out_dtype=torch.float16)
