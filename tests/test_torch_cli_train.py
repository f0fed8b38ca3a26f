"""The port's ``cli/train.py`` (and what it runs on: the retrain task's
datasets, the flat YAML writer, the port's launcher) vs the JAX package on
the CPU, at tiny fp32 size.

A module fixture runs JAX's ``cli.train.main`` once on the tiny caption
config of ``tests/test_cli.py`` (in fp32): a Wanda prune at the
allocation a ``--sparsity_dict`` file gives (``--sparsity_ratio_granularity
block``, so both CLIs write it back as ``sparsity_dict_<job>.yaml``), two
KD steps of SparseLoRA on LVQ, the sparse merge, the evaluation of a
captioning config (``--eval-cfg-path``) and the save.  The port's ``main`` then runs
the same argv with ``--device cpu`` from the weights JAX's factory built
(carried by ``models/bridge.load_jax_variables``, LoRA included).

Tolerances: the masks are bit-equal (the prune is exact in fp32:
``tests/test_torch_cli_evaluate.py`` holds the pruned weights
bit-equal); the trained LoRA and the
merged weights' change from the pruned ones, each as one vector, within
2e-3 of its norm (``tests/test_torch_runner.py`` says why: two Adam steps
over fp32 gradients); every merged weight exactly 0 where its mask is
false, on both sides.  The sparsity files load equal, the artifact names
and the evaluation's metric keys are JAX's, and the saved checkpoint
loads in the port's ``cli.evaluate`` with and without
``--strip_lora_masks`` (the same answers: the merged weights are zero off
their masks, so the masked and the dense products agree exactly).  Also:
``setup_task`` on both train yamls gives a retrain task that is a
``BaseTask`` and builds JAX's datasets; the YAML writer against
``yaml.safe_dump``; every command of ``scripts/torch_launch_lib.py`` is
``scripts/launch_lib.py``'s with the port's module and ``--device``, and
parses to JAX's namespace; a tiny Vicuna ``train_ressa`` run (port only:
``--t5_model_prefix llm_model``) held to the artifact contract; the
soft-mask, hybrid-tile and GPTQ flags reach ``load_pruner`` as JAX's CLI
passes them, and a ``blipt5_gptq_pruner`` prune call through both CLIs
saves the same masks and quantized kernels within the GPTQ pruners'
bounds; the unported flag raises with its
ROADMAP item; the CLI trains on
``RunnerBase`` whatever ``run.runner`` names, as JAX's does; with no GPU
the default ``--device`` raises.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from vlm_compression_tpu_torch.cli import evaluate as TE
from vlm_compression_tpu_torch.cli import train as TT
from vlm_compression_tpu_torch.models.bridge import flatten

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--prune", "--pruning_method", "blipt5_wanda_pruner",
        "--t5_prune_spec", "2-0.5-1.0-1.0", "--vit_prune_spec",
        "2-0.5-1.0-1.0", "--num_data_for_prune", "4",
        "--prune_batch_size", "2", "--sparsity_ratio_granularity", "block",
        "--train", "--sparse", "--tune_opt", "LVQ", "--lora_r_l", "4",
        "--lora_r_v", "2", "--lora_r_q", "2", "--kl_weight", "0.1", "--T",
        "1", "--evaluate", "--save_pruned_model", "--tiny"]


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(root, n, ext=".jpg", shape=(32, 32, 3), seed=0):
    from PIL import Image

    (root / "images").mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    names = []
    for i in range(n):
        arr = rng.randint(0, 255, shape, np.uint8)
        names.append(f"i{i}{ext}")
        if ext == ".npy":
            np.save(root / "images" / names[-1], arr)
        else:
            Image.fromarray(arr).save(root / "images" / names[-1])
    return names


def _configs(root, n_images=8):
    """The train and eval configs of tests/test_launcher_e2e.py (8
    captioned JPEGs; the eval a captioning pass over them), the model in
    fp32."""
    names = _images(root, n_images)
    caps = [{"image": n, "caption": f"cap number {i}", "image_id": i}
            for i, n in enumerate(names)]
    (root / "ann.json").write_text(json.dumps(caps))
    ann = [str(root / "ann.json")]
    model = {"arch": "blip2_t5_instruct", "tiny": True, "amp": False}
    ds = {"coco_caption": {
        "build_info": {"annotations": {"train": ann, "val": list(ann)},
                       "images": {"storage": str(root / "images")}},
        "vis_processor": {"train": {"name": "blip_image_eval",
                                    "image_size": 28},
                          "eval": {"name": "blip_image_eval",
                                   "image_size": 28}}}}
    train = {
        "model": model, "datasets": ds,
        "run": {"task": "image_text_retrain", "batch_size_train": 8,
                "batch_size_eval": 8, "valid_splits": [], "max_epoch": 1,
                "iters_per_epoch": 2, "init_lr": 1e-3, "min_lr": 1e-4,
                "warmup_steps": 1, "log_freq": 1}}
    evaluate = {
        "model": model, "datasets": ds,
        "run": {"task": "captioning", "batch_size_eval": 8, "max_len": 6,
                "min_len": 1, "num_beams": 1, "test_splits": ["val"]}}
    (root / "train.yaml").write_text(yaml.safe_dump(train))
    (root / "eval.yaml").write_text(yaml.safe_dump(evaluate))
    return str(root / "train.yaml"), str(root / "eval.yaml")


def _jax_init(model_cfg, seed):
    """The variables JAX's factory builds for the CLI's model config."""
    from vlm_compression_tpu.models.factory import build_model

    return numpy_tree(build_model(dict(model_cfg), seed=seed)[1])


def _sparsity_file(root, variables):
    """A per-linear allocation over the blocks of the ViT (0.4) and of
    T5's encoder (0.5) and decoder (0.6), at the allocator's keys."""
    from vlm_compression_tpu.compression.allocator import select_prunable_keys

    ratio = {"visual_encoder": 0.4, "encoder": 0.5, "decoder": 0.6}
    alloc = {"/".join(k): ratio[k[1] if k[0] == "t5_model" else k[0]]
             for k in select_prunable_keys(
                 variables["params"], ("visual_encoder", "t5_model"))}
    (root / "alloc.yaml").write_text(yaml.safe_dump(alloc))
    return str(root / "alloc.yaml"), alloc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from vlm_compression_tpu.cli import train as JT
    from vlm_compression_tpu_torch.models import factory

    root = tmp_path_factory.mktemp("cli_train")
    train_cfg, eval_cfg = _configs(root)
    model_cfg = {"arch": "blip2_t5_instruct", "tiny": True, "amp": False,
                 "tune_opt": "LVQ", "lora_r_l": 4, "lora_r_v": 2,
                 "lora_r_q": 2, "lora_alpha": 16.0}
    init = _jax_init(model_cfg, 42)
    alloc_path, alloc = _sparsity_file(root, init)
    argv = ["--cfg-path", train_cfg, "--eval-cfg-path", eval_cfg, *ARGV,
            "--sparsity_dict", alloc_path]
    jstats = JT.main([*argv, "--job_id", "jaxjob", "--options",
                      f"run.output_dir={root / 'jax'}"])

    original = factory.build_model

    def carried(cfg, seed=0, device=None):
        model = original(cfg, seed=seed, device=device)
        from vlm_compression_tpu_torch.models.bridge import (
            load_jax_variables,
        )

        load_jax_variables(model, _jax_init(cfg, seed))
        return model

    factory.build_model = carried
    try:
        tstats, runner, timer = TT.run(TT.parse_args(
            [*argv, "--job_id", "portjob", "--device", "cpu", "--options",
             f"run.output_dir={root / 'port'}"]))
    finally:
        factory.build_model = original
    return dict(root=root, eval_cfg=eval_cfg, init=init, alloc=alloc,
                jax=jstats, port=tstats, runner=runner, timer=timer)


def _jax_restore(path):
    import orbax.checkpoint as ocp

    return numpy_tree(ocp.StandardCheckpointer().restore(str(path)))


def _dotted(tree):
    return {".".join(p): a for p, a in flatten(tree).items()}


def test_masks_equal_jax(runs):
    want = _dotted(_jax_restore(runs["jax"]["pruned_checkpoint"])["masks"])
    got = torch.load(runs["port"]["pruned_checkpoint"], weights_only=True)
    got = {k[:-len(".mask")]: v for k, v in got.items()
           if k.endswith(".mask")}
    want = {k[:-len(".mask")]: v for k, v in want.items()
            if k.endswith(".mask")}
    assert set(got) == set(want)
    pruned = 0
    for name, m in want.items():
        np.testing.assert_array_equal(got[name].numpy(), m, err_msg=name)
        pruned += int((~m).sum())
    assert pruned > 0
    # the allocation: each swept linear at its block's ratio
    for key, ratio in runs["alloc"].items():
        m = want[key.replace("/", ".")]
        assert abs((~m).mean() - ratio) <= 0.05, key


def test_merged_weights_match_jax(runs):
    want = _dotted(_jax_restore(runs["jax"]["pruned_checkpoint"])["params"])
    got = torch.load(runs["port"]["pruned_checkpoint"], weights_only=True)
    init = _dotted(runs["init"]["params"])
    masks = {k[:-len(".mask")]: v.numpy() for k, v in got.items()
             if k.endswith(".mask")}
    assert set(got) == set(want) | {k + ".mask" for k in masks}
    assert not any(k.endswith((".lora_a", ".lora_b")) for k in got)
    dw, dg = [], []
    for name, w in want.items():
        g = got[name].numpy()
        owner = name.rpartition(".")[0]
        if name.endswith(".kernel") and owner in masks:
            m = masks[owner]
            assert (g[~m] == 0).all() and (w[~m] == 0).all(), name
            dw.append((w - init[name] * m).ravel())
            dg.append((g - init[name] * m).ravel())
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    dw, dg = np.concatenate(dw), np.concatenate(dg)
    assert np.linalg.norm(dw) > 0
    assert np.linalg.norm(dg - dw) <= 2e-3 * np.linalg.norm(dw)


def test_trained_lora_matches_jax(runs):
    root = runs["root"]
    want = _dotted(_jax_restore(root / "jax" / "checkpoint_0")["lora"])
    payload = torch.load(root / "port" / "checkpoint_0", weights_only=True)
    assert set(payload) == {"lora", "opt_state", "step", "masks"}
    assert payload["step"] == 2
    got = {k: v.numpy() for k, v in payload["lora"].items()}
    init = _dotted(runs["init"]["lora"])
    assert set(got) == set(want) == set(init)
    names = sorted(want)
    dw = np.concatenate([(want[n] - init[n]).ravel() for n in names])
    dg = np.concatenate([(got[n] - init[n]).ravel() for n in names])
    assert np.linalg.norm(dg - dw) <= 2e-3 * np.linalg.norm(dw)
    steps = runs["runner"].step_metrics
    assert len(steps) == 2 and all(
        np.isfinite(s[k]) for s in steps for k in ("loss", "ce", "kl"))


def test_sparsity_file_loads_equal(runs):
    root = runs["root"]
    want = yaml.safe_load((root / "jax" / "sparsity_dict_jaxjob.yaml")
                          .read_text())
    text = (root / "port" / "sparsity_dict_portjob.yaml").read_text()
    from vlm_compression_tpu_torch.common._yaml import safe_load

    assert yaml.safe_load(text) == safe_load(text) == want == runs["alloc"]


def test_artifact_names_equal_jax(runs):
    def names(who, job):
        out = runs["root"] / who
        found = [p.name for p in out.iterdir()]
        found += [f"{d}/{p.name}" for d in ("result", "training_statistics")
                  for p in (out / d).iterdir()]
        return sorted(n.replace(job, "<job>") for n in found)

    got = names("port", "portjob")
    assert got == names("jax", "jaxjob")
    for name in ("pruned_<job>", "sparsity_dict_<job>.yaml",
                 "training_statistics/<job>.yaml",
                 "training_statistics_<job>.json", "checkpoint_0",
                 "checkpoint_meta.json"):
        assert name in got, name
    j = json.loads((runs["root"] / "jax" / "training_statistics_jaxjob.json")
                   .read_text())
    t = json.loads((runs["root"] / "port" / "training_statistics_portjob.json")
                   .read_text())
    assert list(t) == list(j) == ["job_id", "prune_seconds",
                                  "train_seconds", "eval_seconds",
                                  "eval_results", "pruned_checkpoint"]
    stats = yaml.safe_load((runs["root"] / "port" / "training_statistics" /
                            "portjob.yaml").read_text())
    for phase in ("build", "calibration", "prune", "retrain", "eval",
                  "save"):
        assert stats[f"{phase}_seconds"] >= 0, phase
    assert stats["job_id"] == "portjob"


def test_eval_metric_keys_equal_jax(runs):
    want, got = runs["jax"]["eval_results"], runs["port"]["eval_results"]
    assert list(got) == list(want) == ["val"]
    assert set(got["val"]) == set(want["val"])
    assert "agg_metrics" in got["val"]


@pytest.mark.parametrize("strip", [False, True])
def test_checkpoint_loads_in_cli_evaluate(runs, strip):
    root = runs["root"]
    who = f"eval_{strip}"
    stats = TE.main(["--cfg-path", runs["eval_cfg"], "--tiny", "--device",
                     "cpu", "--pruned_checkpoint",
                     runs["port"]["pruned_checkpoint"], "--job_id", who,
                     *(["--strip_lora_masks"] if strip else []),
                     "--options", f"run.output_dir={root / who}"])
    results = sorted((root / "port" / "result").glob("val*.json"))
    assert results
    for path in results:
        assert json.loads((root / who / "result" / path.name).read_text()) \
            == json.loads(path.read_text()), path.name
    assert set(stats["eval_results"]["val"]) == \
        set(runs["port"]["eval_results"]["val"])


@pytest.mark.parametrize("train_yaml", [
    "continue_stage2_cc3m_t5_instruct.yaml",
    "continue_stage2_vicuna_instruct.yaml"])
def test_retrain_task_builds_jax_datasets(train_yaml, tmp_path):
    from vlm_compression_tpu.common.config import Config as JConfig
    from vlm_compression_tpu.models.model_zoo import (
        default_config_path as jdefaults,
    )
    from vlm_compression_tpu.tasks import setup_task as jsetup
    from vlm_compression_tpu_torch.common.config import Config
    from vlm_compression_tpu_torch.models.model_zoo import (
        default_config_path,
    )
    from vlm_compression_tpu_torch.tasks import setup_task
    from vlm_compression_tpu_torch.tasks.base import BaseTask
    from vlm_compression_tpu_torch.tasks.retrain import ImageTextRetrainTask

    names = _images(tmp_path, 6, shape=(40, 48, 3))
    caps = [{"image": n, "caption": " ".join(["word"] * (3 + i))}
            for i, n in enumerate(names)]
    (tmp_path / "cap.json").write_text(json.dumps(caps))
    path = str(ROOT / "configs/projects/train" / train_yaml)
    name = yaml.safe_load(Path(path).read_text())["datasets"]
    (name,) = list(name)
    options = [f"datasets.{name}.build_info.annotations.train="
               f"[{tmp_path / 'cap.json'}]",
               f"datasets.{name}.build_info.images.storage="
               f"{tmp_path / 'images'}"]
    cfg = Config(cfg_path=path, options=options,
                 defaults=default_config_path)
    jcfg = JConfig(cfg_path=path, options=options, defaults=jdefaults)
    task = setup_task(cfg)
    assert isinstance(task, ImageTextRetrainTask) and \
        isinstance(task, BaseTask)
    got = task.build_datasets(cfg, max_train_samples=4)
    want = jsetup(jcfg).build_datasets(jcfg, max_train_samples=4)
    assert list(got) == list(want) == [name]
    assert list(got[name]) == list(want[name]) == ["train"]
    g, w = got[name]["train"], want[name]["train"]
    assert len(g) == len(w) == 4
    g.vis_processor.rng = np.random.default_rng(5)
    w.vis_processor.rng = np.random.default_rng(5)
    gb, wb = g.collater([g[i] for i in range(4)]), \
        w.collater([w[i] for i in range(4)])
    assert set(gb) == set(wb)
    for k in wb:
        if isinstance(wb[k], np.ndarray):
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
        else:
            assert list(gb[k]) == list(wb[k]), k


def test_yaml_writer_loads_as_safe_dump():
    """The allocator's keys (the tiny model's swept linears, grouped by
    block as the ``first`` grid entry groups them) with a ratio a block."""
    from vlm_compression_tpu.compression.allocator import (
        build_group_mapping,
        select_prunable_keys,
    )
    from vlm_compression_tpu_torch.common._yaml import (
        safe_dump_flat,
        safe_load,
    )

    init = _jax_init({"arch": "blip2_t5_instruct", "tiny": True,
                      "amp": False}, 0)
    keys = select_prunable_keys(init["params"],
                                ("visual_encoder", "t5_model"))
    groups = build_group_mapping(keys, "block")
    rng = np.random.default_rng(0)
    ratio = {g: float(rng.uniform(0.2, 0.8)) for g in sorted(
        set(groups.values()))}
    mapping = {"/".join(k): ratio[groups[k]] for k in keys}
    assert len(set(mapping.values())) > 2
    text = safe_dump_flat(mapping)
    assert yaml.safe_load(text) == safe_load(text) == \
        yaml.safe_load(yaml.safe_dump(mapping)) == mapping
    odd = {"yes": 1, "on": True, "1": 2.5, "a b": None, "x": 1e-20,
           "nan": float("inf"), "s": "two words", "n": np.float32(0.5)}
    text = safe_dump_flat(odd)
    assert yaml.safe_load(text) == safe_load(text) == \
        yaml.safe_load(yaml.safe_dump({**odd, "n": 0.5}))
    with pytest.raises(ValueError, match="not a scalar"):
        safe_dump_flat({"a": {"b": 1}})


def _launchers():
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import launch_lib
        import torch_launch_lib
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    return launch_lib, torch_launch_lib


def _grid(lib, **kw):
    """Every command of the grid: each pruner's prune_and_eval and
    train_ressa, T5 and Vicuna, n:m on the stage-2 config, and
    eval_checkpoint with and without stripping."""
    jobs = []
    for pruner in lib.METHOD_MATRIX:
        for family in ("t5", "vicuna"):
            jobs.append(lib.train_ressa(pruner, 0.5, 0.5, family=family,
                                        **kw))
            lib.prune_and_eval(pruner, 0.5, 0.5, family=family, **kw)
        jobs.append(lib.train_ressa(pruner, 0.6, 0.4, prune_n=2, prune_m=4,
                                    instruct=False, **kw))
    for family in ("t5", "vicuna"):
        for strip in (True, False):
            lib.eval_checkpoint("output/x/pruned_x", family=family,
                                strip=strip, **kw)
    return jobs


def test_launcher_commands_are_the_jax_launchers(monkeypatch):
    """torch_launch_lib builds launch_lib's commands for the port's
    modules, with ``--device`` appended when one is given; every
    ``train_ressa`` command parses to JAX's ``cli.train`` namespace plus
    ``device``, every other one to ``cli.evaluate``'s."""
    from vlm_compression_tpu.cli import evaluate as JE
    from vlm_compression_tpu.cli import train as JT

    launch_lib, torch_launch_lib = _launchers()
    want = []
    monkeypatch.setattr(launch_lib, "_run", want.append)
    jobs = _grid(launch_lib)
    assert torch_launch_lib.METHOD_MATRIX == launch_lib.METHOD_MATRIX
    assert torch_launch_lib.EVAL_TASKS == launch_lib.EVAL_TASKS
    for device in (None, "cuda"):
        got = []
        assert _grid(torch_launch_lib, run=got.append, device=device) == jobs
        assert len(got) == len(want) > 100
        n_train = 0
        for g, w in zip(got, want):
            tail = ["--device", device] if device else []
            module = w[2].replace("vlm_compression_tpu.",
                                  "vlm_compression_tpu_torch.")
            assert g == [w[0], "-m", module, *w[3:], *tail]
            cli_j, cli_t = (JT, TT) if w[2].endswith(".train") else (JE, TE)
            n_train += cli_j is JT
            port = vars(cli_t.parse_args(g[3:]))
            assert port.pop("device") == device
            assert port == vars(cli_j.parse_args(w[3:])), g
        assert n_train == 3 * len(torch_launch_lib.METHOD_MATRIX)


def test_vicuna_train_ressa_holds_the_artifact_contract(tmp_path):
    """The launcher's Vicuna RESSA command (``--t5_model_prefix
    llm_model``) on a tiny model at the CPU, its data paths, output dir,
    batch and image size given by ``--options``: the ViT's and LLaMA's
    swept linears at half their weights, zero where their masks are false,
    every adapter trained, the artifacts under JAX's names, and the saved
    model (no adapters) loading strictly into a model without LoRA."""
    from vlm_compression_tpu_torch.models.factory import build_model
    from vlm_compression_tpu_torch.models.layers import SparseLinear

    _, torch_launch_lib = _launchers()
    cmds = []
    job = torch_launch_lib.train_ressa("wanda", 0.5, 0.5, family="vicuna",
                                       max_train_samples=8, device="cpu",
                                       run=cmds.append)
    (cmd,) = cmds
    names = _images(tmp_path, 8, ext=".npy", shape=(40, 48, 3))
    caps = [{"image": n, "caption": " ".join(["w"] * (3 + i % 4))}
            for i, n in enumerate(names)]
    (tmp_path / "cap.json").write_text(json.dumps(caps))
    cc = "datasets.prefix_conceptual_caption_3m"
    out = tmp_path / "out"
    argv = [*cmd[3:], "--tiny", "--options",
            f"{cc}.build_info.annotations.train=[{tmp_path / 'cap.json'}]",
            f"{cc}.build_info.images.storage={tmp_path / 'images'}",
            f"{cc}.vis_processor.train.image_size=28", "model.amp=false",
            "run.batch_size_train=4", f"run.output_dir={out}"]
    stats, runner, timer = TT.run(TT.parse_args(argv))
    model = runner.model
    assert len(runner.step_metrics) == 2 and all(
        np.isfinite(s["loss"]) for s in runner.step_metrics)
    for tower in ("visual_encoder", "llm_model"):
        lins = [m for n, m in model.named_modules()
                if isinstance(m, SparseLinear) and
                n.startswith(tower + ".blocks_")]
        assert lins and all(m.mask is not None for m in lins), tower
        kept = sum(int(m.mask.sum()) for m in lins)
        assert kept / sum(m.mask.numel() for m in lins) == \
            pytest.approx(0.5, abs=0.01), tower
        for m in lins:
            assert (m.kernel[~m.mask] == 0).all()
            assert bool(m.lora_b.count_nonzero()), tower
    for name in (f"pruned_{job}", f"training_statistics/{job}.yaml",
                 f"training_statistics_{job}.json", "checkpoint_0",
                 "checkpoint_meta.json"):
        assert (out / name).exists(), name
    saved = TE.read_checkpoint(stats["pruned_checkpoint"])
    assert not any(k.endswith((".lora_a", ".lora_b")) for k in saved)
    fresh = build_model({"arch": "blip2_vicuna_instruct", "tiny": True,
                         "amp": False}, device="cpu")
    TE.load_checkpoint(fresh, saved)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, saved[k]), k


class _ReachedLoadPruner(Exception):
    pass


@pytest.mark.parametrize("flag,value", [
    ("--softmask_steps", "8"), ("--softmask_lr", "0.5"),
    ("--hybrid_tile", "64"), ("--gptq_bits", "3"), ("--gptq_group", "64"),
    ("--gptq_asym", None), ("--gptq_actorder", None), ("--gptq_awq", None)],
    ids=lambda x: str(x))
def test_pruner_flags_reach_load_pruner_as_in_jax(flag, value, tmp_path,
                                                  monkeypatch):
    """Each soft-mask, hybrid-tile and GPTQ flag reaches ``load_pruner``
    with the value JAX's CLI passes (both CLIs stopped there): under its
    own name, ``--gptq_asym`` as ``gptq_sym=False``; a switch (no value)
    the opposite of its default."""
    import vlm_compression_tpu.compression as JC
    from vlm_compression_tpu.cli import train as JT
    import vlm_compression_tpu_torch.compression as TC

    seen = {}

    def catcher(who):
        def load_pruner(name, model, data_loader, cfg=None, **kw):
            seen[who] = kw
            raise _ReachedLoadPruner(name)
        return load_pruner

    monkeypatch.setattr(JC, "load_pruner", catcher("jax"))
    monkeypatch.setattr(TC, "load_pruner", catcher("port"))
    train_cfg, _ = _configs(tmp_path)
    argv = ["--cfg-path", train_cfg, "--prune", "--tiny", "--pruning_method",
            "blipt5_softmask_pruner", "--prune_n", "2", "--prune_m", "4",
            "--num_data_for_prune", "2", "--prune_batch_size", "2", flag,
            *([] if value is None else [value]), "--options",
            f"run.output_dir={tmp_path / 'out'}"]
    with pytest.raises(_ReachedLoadPruner):
        JT.main(argv)
    with pytest.raises(_ReachedLoadPruner):
        TT.main([*argv, "--device", "cpu"])
    key = {"gptq_asym": "gptq_sym"}.get(flag[2:], flag[2:])
    want = seen["jax"][key]
    if value is None:
        assert want is (key != "gptq_sym")
        assert seen["port"][key] is want
        return
    assert seen["port"][key] == want == type(want)(value)
    assert type(seen["port"][key]) is type(want)


GPTQ_CLI_IMAGES = 32


def test_gptq_prune_call_holds_jax_structure(tmp_path, monkeypatch):
    """``--pruning_method blipt5_gptq_pruner`` (3-bit asymmetric, group
    16, joint at 0.5, weights zeroed off the masks) through both CLIs from
    JAX's initial weights with every bias drawn from a seed, calibrated
    on 32 images at batch 8 (with zero LayerNorm biases or 4 images the
    tiny ViT's Hessians are near singular and the packages' factorizations
    part at its first linear).  Held: the saved masks bit for bit; each
    swept kernel at least half zero, at most 8 values in each (unit,
    16-row group), none left at its dense value, in both; the ViT's first
    block within W_TOL and its zeros where JAX's are; over all swept
    kernels the zeros and the entries within the bounds of
    tests/test_torch_gptq_pruners.py (measured: 0.73 % of the zero
    pattern, 4.0 % of the entries)."""
    from test_torch_gptq_pruners import (
        MAX_KERNEL_DIFF,
        MAX_MASK_DIFF,
        PRUNER_W_TOL,
    )
    from vlm_compression_tpu.cli import train as JT
    from vlm_compression_tpu.models import factory as jax_factory
    from vlm_compression_tpu_torch.models import factory
    from vlm_compression_tpu_torch.models.bridge import load_jax_variables

    jax_build, port_build, seeded = (jax_factory.build_model,
                                     factory.build_model, {})

    def seeded_init(cfg, seed):
        """JAX's initial variables, every bias from seed 61 (numpy)."""
        key = (repr(sorted(dict(cfg).items())), seed)
        if key not in seeded:
            module, variables = jax_build(dict(cfg), seed=seed)
            rng = np.random.default_rng(61)

            def walk(node):
                return {k: walk(v) if isinstance(v, dict) else
                        (0.1 * rng.standard_normal(np.shape(v))).astype(
                            v.dtype) if k == "bias" else v
                        for k, v in node.items()}

            variables = numpy_tree(variables)
            seeded[key] = (module, dict(variables,
                                        params=walk(variables["params"])))
        module, variables = seeded[key]
        return module, jax.tree_util.tree_map(np.copy, variables)

    def jax_seeded(cfg, seed=0, **kw):
        module, variables = seeded_init(cfg, seed)
        return module, jax.tree_util.tree_map(jax.numpy.asarray, variables)

    def carried(cfg, seed=0, device=None):
        model = port_build(cfg, seed=seed, device=device)
        load_jax_variables(model, seeded_init(cfg, seed)[1])
        return model

    monkeypatch.setattr(jax_factory, "build_model", jax_seeded)
    monkeypatch.setattr(factory, "build_model", carried)
    train_cfg, _ = _configs(tmp_path, GPTQ_CLI_IMAGES)
    argv = ["--cfg-path", train_cfg, "--prune", "--pruning_method",
            "blipt5_gptq_pruner", "--t5_prune_spec", "2-0.5-1.0-1.0",
            "--vit_prune_spec", "2-0.5-1.0-1.0", "--num_data_for_prune",
            str(GPTQ_CLI_IMAGES), "--prune_batch_size", "8", "--gptq_bits",
            "3", "--gptq_asym", "--gptq_group", "16", "--save_pruned_model",
            "--tiny"]
    jstats = JT.main([*argv, "--job_id", "jg", "--options",
                      f"run.output_dir={tmp_path / 'jax'}"])
    tstats = TT.main([*argv, "--job_id", "tg", "--device", "cpu",
                      "--options", f"run.output_dir={tmp_path / 'port'}"])
    saved = _jax_restore(jstats["pruned_checkpoint"])
    want = _dotted(saved["params"])
    got = {k: v.numpy() for k, v in torch.load(
        tstats["pruned_checkpoint"], weights_only=True).items()}
    want_masks = _dotted(saved["masks"])
    got_masks = {k: v for k, v in got.items() if k.endswith(".mask")}
    assert got_masks and set(got_masks) == set(want_masks)
    for k, m in want_masks.items():
        np.testing.assert_array_equal(got_masks[k], m, err_msg=k)
    dense = _dotted(next(iter(seeded.values()))[1]["params"])
    swept = sorted(k for k in want if k.endswith(".kernel")
                   and ".blocks_" in k and not k.startswith("qformer"))
    assert len(swept) == 2 * 4 + 2 * 7 + 2 * 11
    assert all(k in got for k in swept)
    for tree in (want, got):
        for k in swept:
            g = tree[k]
            assert (g == 0).mean() >= 0.5, k
            assert (g == dense[k]).mean() < 0.01, k
            groups = g.reshape(-1, 16, g.shape[1])
            assert max(len(np.unique(groups[i, :, u]))
                       for i in range(groups.shape[0])
                       for u in range(groups.shape[2])) <= 2 ** 3, k
    n = n_zero = n_off = 0
    for k in swept:
        zero_diff = int(((got[k] == 0) != (want[k] == 0)).sum())
        off = int((~np.isclose(got[k], want[k], **PRUNER_W_TOL)).sum())
        if k.startswith("visual_encoder.blocks_0."):
            assert zero_diff == off == 0, k
        n, n_zero, n_off = n + want[k].size, n_zero + zero_diff, n_off + off
    assert n_zero <= MAX_MASK_DIFF * n
    assert n_off <= MAX_KERNEL_DIFF["plain"] * n


@pytest.mark.parametrize("flag,item", [(["--autotune"], 9)],
                         ids=lambda x: str(x))
def test_unported_flags_raise_with_their_item(flag, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        TT.main(["--cfg-path", "unused.yaml", "--device", "cpu", *flag])


def test_train_runs_on_runner_base_whatever_run_runner_names(tmp_path,
                                                             monkeypatch):
    """JAX's CLI trains on ``RunnerBase`` whatever ``run.runner`` names
    (``configs/projects/blip/coco_cap_ft_iter.yaml`` names
    ``runner_iter``), so the port's does too."""
    from vlm_compression_tpu_torch.runners import RunnerBase

    class Trained(Exception):
        pass

    def train(self, **kw):
        raise Trained(type(self))

    monkeypatch.setattr(RunnerBase, "train", train)
    train_cfg, _ = _configs(tmp_path)
    with pytest.raises(Trained) as got:
        TT.main(["--cfg-path", train_cfg, "--train", "--tiny", "--device",
                 "cpu", "--options", "run.runner=runner_iter",
                 f"run.output_dir={tmp_path / 'out'}"])
    assert got.value.args[0] is RunnerBase


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.main(["--cfg-path", "unused.yaml"])
