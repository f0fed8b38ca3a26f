"""The RESSA CLI of the port (port of ``vlm_compression_tpu/cli/train.py``):
prune → SparseLoRA + KD retrain → merge → (evaluate) → save.

  python -m vlm_compression_tpu_torch.cli.train --cfg-path cfg.yaml \\
      --prune --pruning_method blipt5_wanda_pruner \\
      --t5_prune_spec 24-0.5-1.0-1.0 --vit_prune_spec 39-0.5-1.0-1.0 \\
      --train --sparse --tune_opt LVQ --lora_r_l 8 --lora_r_v 4 \\
      --lora_r_q 2 --kl_weight 0.1 --T 1 --save_pruned_model

It takes every flag of the JAX CLI, plus ``--device``: the card unless the
caller asks for the CPU (``--device cpu``); with no card and no
``--device`` it raises.  The calibration batches come from
``--prune-cfg-path``'s datasets where it is given, else the run's; the
prune keeps its masks when it will be retrained (``prune(lora_model=
--train)``); ``RunnerBase`` trains one epoch, as in the JAX CLI, whatever
``run.runner`` names; the LoRA factors merge into the weights in place
(``--sparse``: the masks re-asserted on them), and the model is saved
without its adapters, as the JAX CLI saves the merged ``params`` and
``masks`` alone.  Artifacts under ``run.output_dir``, with the JAX CLI's
names: ``pruned_<job>`` (a ``torch.save``d state dict),
``sparsity_dict_<job>.yaml`` (a non-uniform allocation),
``training_statistics/<job>.yaml`` and ``training_statistics_<job>.json``.
``--softmask_steps``, ``--softmask_lr``, ``--hybrid_tile`` and the GPTQ
knobs (``--gptq_bits``, ``--gptq_group``, ``--gptq_asym``,
``--gptq_actorder``, ``--gptq_awq``) reach the pruner as in the JAX CLI.
The flag of what is not ported yet (autotuning: ROADMAP queue 1, item 9)
parses, and raises when set.  A legacy zoo arch raises before the build:
the JAX CLI cannot train one either (``_TRAINED_ARCHS``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# flags that parse but are not ported: (flag, item); each raises when set
# to anything but the parser's default
_NOT_PORTED = (("autotune", 9),)

# the archs the CLI trains: the JAX CLI reads the language tower's
# vocabulary from ``module.cfg.t5`` or ``.llm`` and then ``.qformer``
# (cli/train.py:184-190), which the legacy zoo's configs lack; the zoo's
# heads take one ``mode``, not the per-tower modes the pretraining step
# passes (tasks/pretrain.py:28-34); and its configs carry no LoRA rank for
# the runner to train.  A zoo model's loss is differentiable: take its
# gradient directly
_TRAINED_ARCHS = ("blip2_t5_instruct", "blip2_vicuna_instruct")
_NO_ZOO_TRAINER = (
    "cli.train trains {arch!r}? No: it trains InstructBLIP (T5 or Vicuna) "
    "alone, as the JAX CLI does — a legacy zoo config has no t5 / llm / "
    "qformer tower for its tokenizers, no per-tower modes for the "
    "pretraining step and no LoRA rank for the runner; call the model's "
    "loss and its backward() directly")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="RESSA prune/retrain/evaluate")
    p.add_argument("--cfg-path", default=None)
    # the calibration loader's and the evaluation's own configs
    p.add_argument("--prune-cfg-path", default=None)
    p.add_argument("--eval-cfg-path", default=None)
    p.add_argument("--options", nargs="+", default=None)
    p.add_argument("--job_id", default=None)

    # phases
    p.add_argument("--prune", action="store_true")
    p.add_argument("--train", action="store_true")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--save_pruned_model", action="store_true")

    # pruning
    p.add_argument("--pruning_method", default="blipt5_wanda_pruner")
    p.add_argument("--prune_spec", default=None)
    p.add_argument("--t5_prune_spec", default=None)
    p.add_argument("--vit_prune_spec", default=None)
    p.add_argument("--prune_n", type=int, default=0)
    p.add_argument("--prune_m", type=int, default=0)
    p.add_argument("--num_data_for_prune", type=int, default=128)
    p.add_argument("--prune_batch_size", type=int, default=1)
    p.add_argument("--sparsity_ratio_granularity", default=None)
    p.add_argument("--score_method", default="obd_avg")
    p.add_argument("--num_data_first_stage", type=int, default=32)
    p.add_argument("--num_noise", type=int, default=1)
    p.add_argument("--noise_eps", type=float, default=1e-3)
    p.add_argument("--max_sparsity_per_layer", type=float, default=0.8)
    p.add_argument("--owl_m", type=float, default=5.0,
                   help="OWL outlier threshold for score_method owl_*")
    p.add_argument("--softmask_steps", type=int, default=48,
                   help="annealing steps for *_softmask_pruner")
    p.add_argument("--softmask_lr", type=float, default=0.1)
    p.add_argument("--hybrid_tile", type=int, default=0,
                   help="with --prune_n/m: tile-level hybrid masks — the "
                        "most salient (t x t) weight tiles stay dense, the "
                        "rest take n:m (wanda/ria only)")
    p.add_argument("--gptq_bits", type=int, default=4,
                   help="*_gptq_pruner grid bits (keep-ratio 1.0 = "
                        "quantize-only, else joint sparse+quant)")
    p.add_argument("--gptq_group", type=int, default=128,
                   help="*_gptq_pruner scale group size (0 = per-tensor "
                        "row grids)")
    p.add_argument("--gptq_asym", action="store_true",
                   help="asymmetric GPTQ grids (default symmetric)")
    p.add_argument("--gptq_actorder", action="store_true",
                   help="GPTQ desc_act column ordering")
    p.add_argument("--gptq_awq", action="store_true",
                   help="AWQ per-channel scale search before GPTQ")
    p.add_argument("--sparsity_dict", default=None)
    p.add_argument("--t5_model_prefix", default="t5_model")
    p.add_argument("--vit_model_prefix", default="visual_encoder")
    p.add_argument("--initial_method", default="wanda")   # DSnoT
    p.add_argument("--max_cycle_time", type=int, default=50)
    p.add_argument("--update_threshold", type=float, default=0.1)
    p.add_argument("--pow_of_var_regrowing", type=float, default=1.0)

    # SparseLoRA
    p.add_argument("--tune_opt", default="LVQ")
    p.add_argument("--lora_r_l", type=int, default=8)
    p.add_argument("--lora_r_v", type=int, default=4)
    p.add_argument("--lora_r_q", type=int, default=2)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--sparse", action="store_true",
                   help="SparseLoRA merge (mask over W+BA); off = plain "
                        "LoRA ablation that densifies")

    # KD
    p.add_argument("--kl_weight", type=float, default=0.01)
    p.add_argument("--T", type=float, default=2.0)
    p.add_argument("--max_train_samples", type=int, default=None)

    p.add_argument("--pack_masks", action="store_true",
                   help="bit-pack the keep-masks after the prune and the "
                        "merge (ops/bitmask.py)")
    p.add_argument("--pack_masks_group", type=int, default=128,
                   choices=(128, 256),
                   help="pack layout: 128 = 2 bits/weight, 256 = 1 "
                        "bit/weight")
    p.add_argument("--model_size", default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny towers (tests / smoke runs)")
    p.add_argument("--autotune", action="store_true",
                   help="not ported yet (ROADMAP queue 1, item 9)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    return p


def parse_args(argv=None):
    return _parser().parse_args(argv)


def _leaf(name: str) -> str:
    return name.rpartition(".")[2]


def run(args, timer=None) -> Tuple[dict, object, object]:
    """The CLI's work for parsed ``args``: (the stats written to
    ``training_statistics_<job>.json``, the training runner, holding the
    model and its steps' metrics, the ``PhaseTimer`` with the seconds of
    its phases: build, calibration, prune, retrain (the merge included),
    eval, save).  ``timer``: a ``PhaseTimer`` to record into (a fresh
    one by default)."""
    from vlm_compression_tpu_torch.cli.evaluate import _tokenizers
    from vlm_compression_tpu_torch.common._yaml import (
        safe_dump_flat,
        safe_load,
    )
    from vlm_compression_tpu_torch.common import dist
    from vlm_compression_tpu_torch.common.config import Config
    from vlm_compression_tpu_torch.common.device import resolve_device
    from vlm_compression_tpu_torch.common.profiling import PhaseTimer
    from vlm_compression_tpu_torch.compression import load_pruner
    from vlm_compression_tpu_torch.models.factory import build_model
    from vlm_compression_tpu_torch.models.layers import SparseLinear
    from vlm_compression_tpu_torch.models.model_zoo import (
        default_config_path,
    )
    from vlm_compression_tpu_torch.ops.bitmask import pack_masks_
    from vlm_compression_tpu_torch.parallel.mesh import (
        data_sharding,
        gather_params,
    )
    from vlm_compression_tpu_torch.runners import RunnerBase
    from vlm_compression_tpu_torch.runners.runner_base import _get
    from vlm_compression_tpu_torch.tasks import setup_task
    from vlm_compression_tpu_torch.tasks.preparers import (
        make_t5_batch_preparer,
        make_vicuna_batch_preparer,
    )
    from vlm_compression_tpu_torch.tasks.retrain import (
        apply_masks_to_params,
        merge_lora_into_params,
    )

    parser = _parser()
    for flag, item in _NOT_PORTED:
        if getattr(args, flag) != parser.get_default(flag):
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP queue 1, item {item})")
    device = resolve_device(args.device)
    timer = timer if timer is not None else PhaseTimer()
    np.random.seed(args.seed)

    def config(path):
        c = Config(cfg_path=path, options=args.options,
                   defaults=default_config_path)
        for section in ("model", "datasets", "run"):
            if section not in c.config:
                c.config[section] = {}
        return c

    cfg = config(args.cfg_path)
    run_cfg, model_cfg = cfg.run_cfg, cfg.model_cfg
    # the process group the environment names (torchrun), before the build
    dist.init_distributed_mode(run_cfg)
    if args.model_size:
        model_cfg["model_type"] = args.model_size
    if args.tiny:
        model_cfg["tiny"] = True
    model_cfg["tune_opt"] = args.tune_opt
    model_cfg["lora_r_l"] = args.lora_r_l
    model_cfg["lora_r_v"] = args.lora_r_v
    model_cfg["lora_r_q"] = args.lora_r_q
    model_cfg["lora_alpha"] = args.lora_alpha

    job_id = args.job_id or time.strftime("%Y%m%d%H%M%S")
    output_dir = _get(run_cfg, "output_dir", f"output/{job_id}")
    os.makedirs(output_dir, exist_ok=True)
    stats: Dict[str, object] = {"job_id": job_id}

    task = setup_task(cfg)
    if args.kl_weight is not None:
        task.kl_weight = args.kl_weight
        task.T = args.T
    arch = _get(model_cfg, "arch", "blip2_t5_instruct")
    if arch not in _TRAINED_ARCHS:
        raise NotImplementedError(_NO_ZOO_TRAINER.format(arch=arch))
    with timer.phase("build"):
        model = build_model(model_cfg, seed=args.seed, device=device)
    tok, qtok = _tokenizers(model, model_cfg)
    prepare = (make_t5_batch_preparer if arch == "blip2_t5_instruct"
               else make_vicuna_batch_preparer)(
        tok, qtok, model.cfg.max_txt_len, model.cfg.max_output_txt_len)

    datasets = task.build_datasets(cfg,
                                   max_train_samples=args.max_train_samples)
    runner = RunnerBase(cfg, task, model, datasets, job_id=job_id,
                        prepare_batch=prepare)

    sparsity_dict = None
    if args.sparsity_dict:
        with open(args.sparsity_dict) as f:
            sparsity_dict = safe_load(f.read())

    if args.prune:
        t0 = time.perf_counter()
        prune_runner = runner
        if args.prune_cfg_path:
            pcfg = config(args.prune_cfg_path)
            ptask = setup_task(pcfg)
            prune_runner = RunnerBase(pcfg, ptask, model,
                                      ptask.build_datasets(pcfg),
                                      job_id=job_id, prepare_batch=prepare)
        with timer.phase("calibration"):
            batches = [
                {k: torch.from_numpy(v) for k, v in b.items()
                 if isinstance(v, np.ndarray) and v.dtype != object}
                for b in prune_runner.get_dataloader_for_importance_computation(
                    num_data=args.num_data_for_prune,
                    batch_size=args.prune_batch_size)]
            if runner.mesh is not None:
                # each data rank calibrates its share of every batch
                batches = [data_sharding(runner.mesh)(b) for b in batches]
        with timer.phase("prune"):
            pruner = load_pruner(
                args.pruning_method, model, batches,
                prune_spec=args.prune_spec,
                t5_prune_spec=args.t5_prune_spec,
                vit_prune_spec=args.vit_prune_spec,
                prune_n=args.prune_n, prune_m=args.prune_m,
                num_samples=args.num_data_for_prune,
                sparsity_ratio_granularity=args.sparsity_ratio_granularity,
                score_method=args.score_method,
                num_data_first_stage=args.num_data_first_stage,
                num_noise=args.num_noise, noise_eps=args.noise_eps,
                max_sparsity_per_layer=args.max_sparsity_per_layer,
                owl_m=args.owl_m,
                hybrid_tile=args.hybrid_tile,
                sparsity_dict=sparsity_dict,
                t5_model_prefix=args.t5_model_prefix,
                vit_model_prefix=args.vit_model_prefix,
                initial_method=args.initial_method,
                max_cycle_time=args.max_cycle_time,
                update_threshold=args.update_threshold,
                pow_of_var_regrowing=args.pow_of_var_regrowing,
                softmask_steps=args.softmask_steps,
                softmask_lr=args.softmask_lr,
                gptq_bits=args.gptq_bits, gptq_group=args.gptq_group,
                gptq_sym=not args.gptq_asym,
                gptq_actorder=args.gptq_actorder, gptq_awq=args.gptq_awq)
            # the masks stay when the prune is retrained (the teacher runs
            # the dense weights), else the weights are zeroed
            model, sparsity_mapping = pruner.prune(lora_model=args.train)
            del batches, pruner
        runner.model = model
        stats["prune_seconds"] = round(time.perf_counter() - t0, 2)
        if sparsity_mapping:
            with open(os.path.join(output_dir,
                                   f"sparsity_dict_{job_id}.yaml"),
                      "w") as f:
                f.write(safe_dump_flat(sparsity_mapping))
        logging.info("prune done in %.1fs", stats["prune_seconds"])

    if args.train:
        t0 = time.perf_counter()
        with timer.phase("retrain"):
            runner._train_state = None   # over the pruned model's masks
            runner.train(prune_retrain=True)
            if runner.mesh is not None:
                gather_params(runner.model)     # merged whole on every rank
            # W += (A·B·α/r) ⊙ M in place; --sparse re-asserts W[~M] = 0
            merge_lora_into_params(runner.model, sparse=args.sparse)
            if args.sparse:
                apply_masks_to_params(runner.model)
        stats["train_seconds"] = round(time.perf_counter() - t0, 2)

    if runner.mesh is not None and (args.pack_masks or
                                    args.save_pruned_model) and \
            getattr(runner.model, "parallel_mesh", None) is not None:
        gather_params(runner.model)     # packed and saved whole
    if args.pack_masks and any(isinstance(m, SparseLinear) and
                               m.mask is not None
                               for m in runner.model.modules()):
        pack_masks_(runner.model, group=args.pack_masks_group)
        logging.info("masks bit-packed (%d bits/weight)",
                     256 // args.pack_masks_group)

    if args.evaluate:
        t0 = time.perf_counter()
        with timer.phase("eval"):
            erunner = runner
            if args.eval_cfg_path:
                ecfg = config(args.eval_cfg_path)
                etask = setup_task(ecfg)
                erunner = RunnerBase(ecfg, etask, runner.model,
                                     etask.build_datasets(ecfg),
                                     job_id=job_id, prepare_batch=prepare)
            # generation-driven tasks need the tokenizers to decode
            if hasattr(erunner.task, "tokenizer"):
                erunner.task.tokenizer = tok
                erunner.task.qformer_tokenizer = qtok
            results = erunner.evaluate(skip_reload=True)
        stats["eval_seconds"] = round(time.perf_counter() - t0, 2)
        stats["eval_results"] = results

    if args.save_pruned_model:
        path = os.path.abspath(os.path.join(output_dir, f"pruned_{job_id}"))
        with timer.phase("save"):
            state = runner.model.state_dict()
            if args.train:
                # merged: the weights and masks stand alone
                state = {k: v for k, v in state.items()
                         if _leaf(k) not in ("lora_a", "lora_b")}
            if dist.is_main_process():
                torch.save(state, path)
            del state
        stats["pruned_checkpoint"] = path

    timer.dump(output_dir, job_id,
               extra={k: v for k, v in stats.items()
                      if isinstance(v, (int, float, str))})
    with open(os.path.join(output_dir,
                           f"training_statistics_{job_id}.json"), "w") as f:
        json.dump(stats, f, indent=2, default=str)
    logging.info("stats: %s", {k: v for k, v in stats.items()
                               if k != "eval_results"})
    return stats, runner, timer


def main(argv: Optional[list] = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
