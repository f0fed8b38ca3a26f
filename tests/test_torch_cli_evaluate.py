"""The port's ``cli/evaluate.py`` vs the JAX CLI on the CPU, at tiny fp32
size.

A module fixture runs JAX's ``main`` once on a synthetic VQA config
(``--tiny --prune --save_pruned_model`` and the eval), builds the same
initial weights with JAX's factory from the CLI's ``--seed`` and carries
them into a port checkpoint (``models/bridge.load_jax_variables`` +
``torch.save``); the port's ``main`` then prunes and evaluates from it
with ``--device cpu``.  The pruned weights are bit-equal (fp32: a kept
weight is the carried weight itself, a pruned one zero, so the tolerance
is 0), the zero patterns identical, the masks left the same (the swept
linears' dropped, the Q-Former's carried all-true ones kept), the answers
in the result file equal, and ``eval_stats`` has JAX's keys and metric.
The chained prune at the launcher's batch 1 over prompts of several
lengths, where the JAX CLI fails, is held to its densities and its own
checkpoint.  Also held against JAX: the checkpoint evaluated again with
``--strip_lora_masks`` and with ``--quantize_int8`` (answers equal), the
tower grafts (``--vit_pruned_checkpoint`` / ``--t5_pruned_checkpoint``,
equal weights) and ``interpolate_pos_embed`` (atol = rtol = 1e-6); the
unported flags raise with their ROADMAP items; with no GPU the default
``--device`` raises; and every command the launchers build parses to
JAX's namespace.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from vlm_compression_tpu_torch.cli import evaluate as TE
from vlm_compression_tpu_torch.models.bridge import flatten

ROOT = Path(__file__).resolve().parents[1]
PRUNE = ["--tiny", "--prune", "--pruning_method", "blipt5_wanda_pruner",
         "--t5_prune_spec", "2-0.5-1.0-1.0", "--vit_prune_spec",
         "2-0.5-1.0-1.0", "--num_data_for_prune", "2",
         "--prune_batch_size", "2", "--save_pruned_model"]


def _cfg(root):
    """The fixture of tests/test_evaluate_cli.py (4 JPEGs, a VQA
    annotation file), the model in fp32."""
    from PIL import Image

    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    anns = []
    for i in range(4):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
            img_dir / f"i{i}.jpg")
        anns.append({"image": f"i{i}.jpg", "question": f"what is {i}?",
                     "question_id": i, "answer": ["yes"] * 10})
    (root / "vqa.json").write_text(json.dumps(anns))
    ann = str(root / "vqa.json")
    cfg = {
        "model": {"arch": "blip2_t5_instruct", "tiny": True, "amp": False},
        "datasets": {"coco_vqa": {
            "build_info": {"annotations": {"train": [ann], "val": [ann]},
                           "images": {"storage": str(img_dir)}},
            "vis_processor": {
                "train": {"name": "blip_image_eval", "image_size": 28},
                "eval": {"name": "blip_image_eval", "image_size": 28}},
            "text_processor": {"train": {"name": "blip_question"},
                               "eval": {"name": "blip_question"}}}},
        "run": {"task": "vqa", "batch_size_train": 4, "batch_size_eval": 4,
                "num_beams": 1, "max_len": 4, "test_splits": ["val"],
                "output_dir": str(root / "out")}}
    path = root / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _out(root, who):
    return ["--options", f"run.output_dir={root / who}"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from vlm_compression_tpu.cli import evaluate as JE
    from vlm_compression_tpu.common.config import Config
    from vlm_compression_tpu.models.factory import build_model
    from vlm_compression_tpu.models.model_zoo import default_config_path

    root = tmp_path_factory.mktemp("cli")
    cfg = _cfg(root)
    jstats = JE.main(["--cfg-path", cfg, "--job_id", "jx", *PRUNE,
                      *_out(root, "jax")])

    # the weights JAX's CLI built from --seed, carried into the port
    model_cfg = Config(cfg_path=cfg, defaults=default_config_path).model_cfg
    model_cfg["tiny"] = True
    _, variables = build_model(model_cfg, seed=42)
    variables = {k: v for k, v in variables.items()
                 if k in ("params", "masks")}
    from vlm_compression_tpu_torch.models.bridge import load_jax_variables
    from vlm_compression_tpu_torch.models.factory import (
        build_model as port_build,
    )

    init = port_build(dict(model_cfg, tiny=True), device="cpu")
    load_jax_variables(init, numpy_tree(variables))
    init_path = root / "init.pt"
    torch.save(init.state_dict(), init_path)

    tstats = TE.main(["--cfg-path", cfg, "--job_id", "tx", *PRUNE,
                      "--device", "cpu", "--pruned_checkpoint",
                      str(init_path), *_out(root, "port")])
    return dict(root=root, cfg=cfg, jax=jstats, port=tstats,
                init=str(init_path))


def numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_restore(path):
    import orbax.checkpoint as ocp

    return numpy_tree(ocp.StandardCheckpointer().restore(path))


def _answers(root, who):
    rows = json.loads((root / who / "result" /
                       "val_vqa_result.json").read_text())
    return {r["question_id"]: r["answer"] for r in rows}


def test_pruned_weights_and_masks_equal_jax(runs):
    want = _jax_restore(runs["jax"]["pruned_checkpoint"])
    got = torch.load(runs["port"]["pruned_checkpoint"], weights_only=True)
    params = {".".join(p): a for p, a in flatten(want["params"]).items()}
    masks = {".".join(p): a for p, a in flatten(want["masks"]).items()}
    assert set(got) == set(params) | set(masks)
    zeroed = 0
    for name, w in params.items():
        g = got[name].numpy()
        assert g.dtype == w.dtype == np.float32, name
        np.testing.assert_array_equal(g == 0, w == 0, err_msg=name)
        np.testing.assert_array_equal(g, w, err_msg=name)
        zeroed += int((w == 0).sum())
    for name, m in masks.items():
        np.testing.assert_array_equal(got[name].numpy(), m, err_msg=name)
    assert zeroed > 0


def test_answers_and_eval_stats_equal_jax(runs):
    root = runs["root"]
    assert _answers(root, "port") == _answers(root, "jax")
    j = json.loads((root / "jax" / "eval_stats_jx.json").read_text())
    t = json.loads((root / "port" / "eval_stats_tx.json").read_text())
    assert list(t) == list(j) == ["job_id", "prune_seconds",
                                  "pruned_checkpoint", "eval_results"]
    assert t["eval_results"] == j["eval_results"]
    assert t["eval_results"] == runs["port"]["eval_results"]


@pytest.mark.parametrize("extra,who", [(["--strip_lora_masks"], "strip"),
                                       (["--quantize_int8"], "int8")])
def test_checkpoint_eval_equals_jax(runs, extra, who):
    from vlm_compression_tpu.cli import evaluate as JE

    root = runs["root"]
    jstats = JE.main(["--cfg-path", runs["cfg"], "--job_id", f"j{who}",
                      "--tiny", "--pruned_checkpoint",
                      runs["jax"]["pruned_checkpoint"], *extra,
                      *_out(root, f"jax_{who}")])
    tstats = TE.main(["--cfg-path", runs["cfg"], "--job_id", f"t{who}",
                      "--tiny", "--device", "cpu", "--pruned_checkpoint",
                      runs["port"]["pruned_checkpoint"], *extra,
                      *_out(root, f"port_{who}")])
    assert _answers(root, f"port_{who}") == _answers(root, f"jax_{who}")
    assert tstats["eval_results"] == jstats["eval_results"]


def test_checkpoint_round_trip_and_strip(runs, tmp_path):
    from vlm_compression_tpu_torch.models.factory import build_model

    state = TE.read_checkpoint(runs["port"]["pruned_checkpoint"])
    model = build_model({"tiny": True, "amp": False}, device="cpu")
    TE.load_checkpoint(model, state)
    for name, t in model.state_dict().items():
        assert torch.equal(t, state[name]), name
    stripped = TE.strip_lora_masks(state)
    assert not any(k.endswith(".mask") for k in stripped)
    assert len(stripped) == len(state) - sum(k.endswith(".mask")
                                             for k in state)
    with pytest.raises(KeyError, match="missing"):
        TE.load_checkpoint(build_model({"tiny": True, "amp": False},
                                       device="cpu"),
                           {k: v for k, v in stripped.items()
                            if "visual_encoder" not in k})
    # a LoRA model takes a stripped checkpoint, its adapters untouched
    lora = build_model({"tiny": True, "amp": False, "tune_opt": "LVQ",
                        "lora_r_v": 2, "lora_r_l": 2, "lora_r_q": 2},
                       device="cpu")
    before = {k: v.clone() for k, v in lora.state_dict().items()
              if "lora_" in k}
    with pytest.raises(KeyError, match="missing"):
        TE.load_checkpoint(lora, stripped)
    TE.load_checkpoint(lora, stripped, keep=("lora_a", "lora_b"))
    for k, v in before.items():
        assert torch.equal(lora.state_dict()[k], v)


def test_tower_grafts_equal_jax(runs, tmp_path):
    """Whole-model checkpoints grafted tower by tower (JAX's
    ``_graft_tower_checkpoints`` on its orbax checkpoint, the port's on its
    torch one), and a bare ViT checkpoint at another image size, its
    position table interpolated."""
    from vlm_compression_tpu.cli import evaluate as JE
    from vlm_compression_tpu.common.config import Config
    from vlm_compression_tpu.models.factory import build_model
    from vlm_compression_tpu.models.model_zoo import default_config_path
    from vlm_compression_tpu_torch.models.bridge import load_jax_variables
    from vlm_compression_tpu_torch.models.factory import (
        build_model as port_build,
    )

    model_cfg = Config(cfg_path=runs["cfg"],
                       defaults=default_config_path).model_cfg
    model_cfg["tiny"] = True
    module, variables = build_model(model_cfg, seed=7)
    variables = numpy_tree({k: v for k, v in variables.items()
                            if k in ("params", "masks")})
    jpath = runs["jax"]["pruned_checkpoint"]
    want = numpy_tree(JE._graft_tower_checkpoints(
        module, dict(variables), vit_path=jpath, t5_path=jpath))
    model = port_build(dict(model_cfg), device="cpu")
    load_jax_variables(model, variables)
    tpath = runs["port"]["pruned_checkpoint"]
    TE.graft_tower_checkpoints(model, vit_path=tpath, t5_path=tpath)
    got = model.state_dict()
    for path, w in flatten(want["params"]).items():
        np.testing.assert_array_equal(got[".".join(path)].numpy(), w,
                                      err_msg=".".join(path))

    # a bare ViT tower saved at a 4x4 grid, grafted into the 2x2 model
    vit = model.visual_encoder
    bare = {k: v.clone() for k, v in vit.state_dict().items()}
    rng = np.random.default_rng(0)
    g = int(round((bare["pos_embed"].shape[1] - 1) ** 0.5))
    big = rng.standard_normal((1, 1 + (2 * g) ** 2,
                               bare["pos_embed"].shape[2])).astype(
        np.float32)
    bare["pos_embed"] = torch.from_numpy(big)
    torch.save(bare, tmp_path / "vit.pt")
    TE.graft_tower_checkpoints(model, vit_path=str(tmp_path / "vit.pt"))
    from vlm_compression_tpu.models.eva_vit import interpolate_pos_embed

    np.testing.assert_allclose(
        vit.pos_embed.detach().numpy(),
        np.asarray(interpolate_pos_embed(big, g * g)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("old,new", [(16, 49), (49, 16), (16, 16), (1, 4)])
def test_interpolate_pos_embed_equals_jax(old, new):
    from vlm_compression_tpu.models.eva_vit import interpolate_pos_embed as J
    from vlm_compression_tpu_torch.models.eva_vit import (
        interpolate_pos_embed as T,
    )

    pe = np.random.default_rng(old).standard_normal(
        (1, old + 1, 8)).astype(np.float32)
    want = np.asarray(J(pe, new))
    got = T(torch.from_numpy(pe), new).numpy()
    assert got.shape == want.shape == (1, new + 1, 8)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("flag,item", [
    (["--w8a8"], 7), (["--int8_outliers", "8"], 7), (["--quantize_int4"], 7),
    (["--int4_group", "64"], 7), (["--autotune"], 9),
    (["--speculative_gamma", "4"], 9), (["--kv_cache_int8"], 9),
    (["--kv_cache_per_row"], 9)], ids=lambda x: str(x))
def test_unported_flags_raise_with_their_item(flag, item, tmp_path):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        TE.main(["--cfg-path", "unused.yaml", "--device", "cpu", *flag])


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.main(["--cfg-path", "unused.yaml"])


def _launcher_commands(monkeypatch):
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import launch_lib
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    cmds = []
    monkeypatch.setattr(launch_lib, "_run", cmds.append)
    for pruner in launch_lib.METHOD_MATRIX:
        for family in ("t5", "vicuna"):
            launch_lib.prune_and_eval(pruner, 0.5, 0.5, family=family,
                                      extra=("--prune_batch_size", "16"))
        launch_lib.prune_and_eval(pruner, 0.6, 0.4, prune_n=2, prune_m=4,
                                  instruct=False)
    for family in ("t5", "vicuna"):
        launch_lib.eval_checkpoint("output/x/checkpoint_best", family=family)
        launch_lib.eval_checkpoint("output/x/checkpoint_best",
                                   family=family, strip=False)
    return cmds


def test_launcher_commands_parse_as_jax(monkeypatch):
    from vlm_compression_tpu.cli import evaluate as JE

    cmds = _launcher_commands(monkeypatch)
    assert len(cmds) > 100
    for cmd in cmds:
        assert cmd[1:3] == ["-m", "vlm_compression_tpu.cli.evaluate"]
        port = [cmd[0], "-m", "vlm_compression_tpu_torch.cli.evaluate",
                *cmd[3:]]
        want = vars(JE.parse_args(cmd[3:]))
        got = vars(TE.parse_args(port[3:]))
        assert got.pop("device") is None
        assert got == want, cmd


def test_with_outputs_splits_what_does_not_fuse():
    """The chained prune's hand-off from one tower to the next: batch dicts
    that fuse take the one fused output whole (as JAX's
    ``fuse_batch_dicts`` gives it); batch-1 prompts of several lengths get
    a slice each, in order."""
    from vlm_compression_tpu_torch.compression.calibrate import (
        fuse_batch_dicts,
        with_outputs,
    )

    out = torch.arange(5 * 3, dtype=torch.float32).reshape(5, 3)
    same = [{"ids": torch.full((1, 4), i), "t": ["x"]} for i in range(5)]
    got = with_outputs(same, [out], "x")
    want = fuse_batch_dicts(same)[0]
    assert len(got) == 1 and torch.equal(got[0]["x"], out)
    assert torch.equal(got[0]["ids"], want["ids"]) and got[0]["t"] == ["x"]
    ragged = [{"ids": torch.zeros((b, 3 + i), dtype=torch.int32)}
              for i, b in enumerate([1, 2, 1, 1])]
    got = with_outputs(ragged, [out], "x")
    assert [g["ids"].shape for g in got] == [r["ids"].shape for r in ragged]
    assert torch.equal(torch.cat([g["x"] for g in got]), out)
    assert [g["x"].shape[0] for g in got] == [1, 2, 1, 1]
    per = [out[:2], out[2:]]
    got = with_outputs(ragged[:2], per, "x")
    assert all(g["x"] is p for g, p in zip(got, per))


def test_cli_prunes_at_batch_1_over_prompts_of_several_lengths(tmp_path):
    """The launcher's --prune_batch_size 1 over captions of 3-6 words on
    .npy images through blip2_image_train (the JAX CLI fails there:
    ROADMAP queue 3): every tower's swept linears at half their weights,
    no mask left on them, the checkpoint equal to the model."""
    rng = np.random.default_rng(3)
    (tmp_path / "images").mkdir()
    caps = []
    for i in range(6):
        np.save(tmp_path / "images" / f"c{i}.npy",
                rng.integers(0, 256, (40, 48, 3), dtype=np.uint8))
        caps.append({"image": f"c{i}.npy",
                     "caption": " ".join(["w"] * (3 + i % 4))})
    (tmp_path / "cap.json").write_text(json.dumps(caps))
    cc = "datasets.prefix_conceptual_caption_3m"
    argv = ["--cfg-path",
            str(ROOT / "configs/projects/eval/prune_stage2_t5_instruct.yaml"),
            "--tiny", "--device", "cpu", "--prune", "--save_pruned_model",
            "--t5_prune_spec", "24-0.5-1.0-1.0", "--vit_prune_spec",
            "39-0.5-1.0-1.0", "--num_data_for_prune", "6", "--job_id", "b1",
            "--options", f"run.output_dir={tmp_path / 'out'}",
            f"{cc}.build_info.annotations.train=[{tmp_path / 'cap.json'}]",
            f"{cc}.build_info.images.storage={tmp_path / 'images'}",
            f"{cc}.vis_processor.train.image_size=28", "model.amp=false"]
    stats, runner, timer = TE.run(TE.parse_args(argv))
    assert set(timer.stats) >= {"build_seconds", "calibration_seconds",
                                "prune_seconds", "save_seconds"}
    from vlm_compression_tpu_torch.models.layers import SparseLinear

    for tower in ("visual_encoder", "t5_model.encoder", "t5_model.decoder"):
        lins = [m for n, m in runner.model.named_modules()
                if isinstance(m, SparseLinear) and
                n.startswith(tower + ".blocks_")]
        assert lins and all(m.mask is None for m in lins)
        kept = sum(int(m.kernel.count_nonzero()) for m in lins)
        assert kept / sum(m.kernel.numel() for m in lins) == \
            pytest.approx(0.5, abs=0.01), tower
    saved = TE.read_checkpoint(stats["pruned_checkpoint"])
    for k, v in runner.model.state_dict().items():
        assert torch.equal(saved[k], v), k


def test_chip_smoke_drives_the_port_cli_only():
    """chip_smoke's CLI path composes the launcher's argv itself: it
    imports neither JAX, nor the JAX package, nor scripts/launch_lib (which
    names the JAX CLI), at module level or inside a function."""
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert "vlm_compression_tpu_torch.cli" in names
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "vlm_compression_tpu", "launch_lib",
                           "scripts"), name
