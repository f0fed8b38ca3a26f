"""The evaluation CLI of the port (port of
``vlm_compression_tpu/cli/evaluate.py``): optionally prune without LoRA
(the weights zeroed) and save the pruned model, then run the config's eval
suite; or evaluate a saved checkpoint, optionally without its ``lora`` and
``mask`` entries so the merged sparse weights stand alone.

  python -m vlm_compression_tpu_torch.cli.evaluate --cfg-path eval.yaml \\
      --pruned_checkpoint output/<job>/pruned_<job> [--strip_lora_masks]

It takes every flag of the JAX CLI, plus ``--device``: the card unless the
caller asks for the CPU (``--device cpu``); with no card and no
``--device`` it raises.  A checkpoint is the model's ``state_dict`` written
with ``torch.save``; it is read back with ``weights_only=True`` and strict
keys.  The flags of what is not ported yet (W8A8, int4: ROADMAP queue 1,
item 7; autotuning, speculative decoding, the int8 and per-row KV caches:
item 9) parse, and raise when set.
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

# flags that parse but are not ported: (flag, its value when unset, item)
_NOT_PORTED = (("w8a8", False, 7), ("int8_outliers", 0, 7),
               ("quantize_int4", False, 7), ("int4_group", 128, 7),
               ("autotune", False, 9), ("speculative_gamma", 0, 9),
               ("kv_cache_int8", False, 9), ("kv_cache_per_row", False, 9))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="evaluate (optionally prune)")
    p.add_argument("--cfg-path", default=None)
    p.add_argument("--options", nargs="+", default=None)
    p.add_argument("--job_id", default=None)
    p.add_argument("--prune", action="store_true")
    p.add_argument("--pruning_method", default="blipt5_wanda_pruner")
    p.add_argument("--t5_prune_spec", default=None)
    p.add_argument("--vit_prune_spec", default=None)
    p.add_argument("--prune_n", type=int, default=0)
    p.add_argument("--prune_m", type=int, default=0)
    p.add_argument("--num_data_for_prune", type=int, default=128)
    p.add_argument("--prune_batch_size", type=int, default=1)
    p.add_argument("--pruned_checkpoint", default=None)
    # per-tower pruned checkpoints (ViT position embeddings interpolated
    # when the checkpoint's image size differs)
    p.add_argument("--vit_pruned_checkpoint", default=None)
    p.add_argument("--t5_pruned_checkpoint", default=None)
    p.add_argument("--strip_lora_masks", action="store_true",
                   help="drop lora/mask entries from the restored "
                        "checkpoint")
    # sparsity-allocator knobs
    p.add_argument("--sparsity_ratio_granularity", default=None)
    p.add_argument("--score_method", default="obd_avg")
    p.add_argument("--num_data_first_stage", type=int, default=32)
    p.add_argument("--num_noise", type=int, default=1)
    p.add_argument("--max_sparsity_per_layer", type=float, default=0.8)
    p.add_argument("--owl_m", type=float, default=5.0,
                   help="OWL outlier threshold for score_method owl_*")
    p.add_argument("--sparsity_dict", default=None)
    p.add_argument("--t5_model_prefix", default="t5_model")
    p.add_argument("--vit_model_prefix", default="visual_encoder")
    p.add_argument("--power", type=int, default=2)
    # DSnoT knobs
    p.add_argument("--initial_method", default="wanda")
    p.add_argument("--without_DSnoT", dest="without_dsnot",
                   action="store_true")
    # global-pruner family knobs (blipt5_{mag,rand,aobd,mezo}_pruner)
    p.add_argument("--is_global", action="store_true")
    p.add_argument("--prune_per_model", action="store_true")
    p.add_argument("--iteration", type=int, default=1)
    p.add_argument("--save_pruned_model", action="store_true")
    p.add_argument("--quantize_int8", action="store_true",
                   help="per-output-channel absmax int8 weights for the "
                        "eval")
    p.add_argument("--w8a8", action="store_true",
                   help="not ported yet (ROADMAP queue 1, item 7)")
    p.add_argument("--autotune", action="store_true",
                   help="not ported yet (ROADMAP queue 1, item 9)")
    p.add_argument("--int8_outliers", type=int, default=0,
                   help="not ported yet (ROADMAP queue 1, item 7)")
    p.add_argument("--quantize_int4", action="store_true",
                   help="not ported yet (ROADMAP queue 1, item 7)")
    p.add_argument("--int4_group", type=int, default=128,
                   help="not ported yet (ROADMAP queue 1, item 7)")
    p.add_argument("--speculative_gamma", type=int, default=0,
                   help="not ported yet (ROADMAP queue 1, item 9)")
    p.add_argument("--kv_cache_int8", action="store_true",
                   help="not ported yet (ROADMAP queue 1, item 9)")
    p.add_argument("--kv_cache_per_row", action="store_true",
                   help="not ported yet (ROADMAP queue 1, item 9)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--model_size", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    return p.parse_args(argv)


def _leaf(name: str) -> str:
    return name.rpartition(".")[2]


def strip_lora_masks(state: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """The state dict without its LoRA factors and masks: the merged
    sparse weights alone."""
    return {k: v for k, v in state.items()
            if not (_leaf(k).startswith("lora_") or _leaf(k) == "mask")}


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A state dict written by ``--save_pruned_model`` (memory-mapped on
    the host; ``weights_only``: tensors and containers only)."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True, mmap=True)


@torch.no_grad()
def load_checkpoint(module: torch.nn.Module, state: Dict[str, torch.Tensor],
                    keep: Tuple[str, ...] = ()) -> None:
    """Copy ``state`` into ``module`` with strict keys.  Masks and int8
    kernels in the state are attached to their linears first (a fresh
    model holds neither).  ``keep``: leaf names (``lora_a``, ``mask``, …)
    of the model's own entries the state may lack; they keep their
    values."""
    from vlm_compression_tpu_torch.models.layers import (
        set_int8_kernel,
        set_mask,
    )

    for name, t in state.items():
        owner, leaf = name.rpartition(".")[::2]
        if leaf == "kernel_scale":
            set_int8_kernel(module.get_submodule(owner),
                            state[owner + ".kernel"], t)
        elif leaf == "mask":
            set_mask(module.get_submodule(owner), t)
    missing, unexpected = module.load_state_dict(state, strict=False)
    missing = [k for k in missing if _leaf(k) not in keep]
    if missing or unexpected:
        raise KeyError(f"checkpoint keys do not match the model: missing "
                       f"{missing[:8]}, unexpected {unexpected[:8]}")


def _tower_params(state: Dict[str, torch.Tensor], prefix: str
                  ) -> Dict[str, torch.Tensor]:
    """The parameters of a whole model's ``prefix`` subtree, or of a bare
    tower's state (its masks left out: a graft replaces weights only)."""
    head = prefix + "."
    if any(k.startswith(head) for k in state):
        state = {k[len(head):]: v for k, v in state.items()
                 if k.startswith(head)}
    return {k: v for k, v in state.items() if _leaf(k) != "mask"}


def graft_tower_checkpoints(model, vit_path=None, t5_path=None,
                            vit_prefix="visual_encoder",
                            t5_prefix="t5_model") -> None:
    """Load per-tower pruned checkpoints' weights into the composed model
    in place (the model keeps its masks); a ViT position table of another
    image size is interpolated to the model's."""
    from vlm_compression_tpu_torch.models.eva_vit import (
        interpolate_pos_embed,
    )

    if vit_path:
        tower = model.get_submodule(vit_prefix)
        loaded = _tower_params(read_checkpoint(vit_path), vit_prefix)
        pe, want = loaded.get("pos_embed"), tower.pos_embed
        if pe is not None and pe.shape != want.shape:
            loaded["pos_embed"] = interpolate_pos_embed(pe, want.shape[1] - 1)
        load_checkpoint(tower, loaded, keep=("mask",))
    if t5_path:
        load_checkpoint(model.get_submodule(t5_prefix),
                        _tower_params(read_checkpoint(t5_path), t5_prefix),
                        keep=("mask",))


def _tokenizers(model, model_cfg):
    from vlm_compression_tpu_torch.datasets.tokenization import (
        load_tokenizer,
    )

    vocab = None          # the language tower's vocabulary
    for attr in ("t5", "llm", "med", "text", "gpt"):
        sub = getattr(model.cfg, attr, None)
        if sub is not None and hasattr(sub, "vocab_size"):
            vocab = sub.vocab_size
            break
    tok = load_tokenizer(model_cfg.get("tokenizer_path"), vocab_size=vocab)
    qtok = (load_tokenizer(model_cfg.get("qformer_tokenizer_path"),
                           vocab_size=model.cfg.qformer.vocab_size)
            if hasattr(model.cfg, "qformer") else tok)
    return tok, qtok


def run(args) -> Tuple[dict, object, object]:
    """The CLI's work for parsed ``args``: (the eval stats written to
    ``eval_stats_<job>.json``, the runner holding the evaluated model, a
    ``PhaseTimer`` with the seconds of its phases)."""
    from vlm_compression_tpu_torch.common.config import Config
    from vlm_compression_tpu_torch.common.device import resolve_device
    from vlm_compression_tpu_torch.common.profiling import PhaseTimer
    from vlm_compression_tpu_torch.compression import load_pruner
    from vlm_compression_tpu_torch.models.factory import build_model
    from vlm_compression_tpu_torch.models.model_zoo import (
        default_config_path,
    )
    from vlm_compression_tpu_torch.runners.runner_base import RunnerBase, _get
    from vlm_compression_tpu_torch.tasks import setup_task
    from vlm_compression_tpu_torch.tasks.preparers import (
        make_t5_batch_preparer,
        make_vicuna_batch_preparer,
    )

    for flag, unset, item in _NOT_PORTED:
        if getattr(args, flag) != unset:
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP queue 1, item {item})")
    device = resolve_device(args.device)
    timer = PhaseTimer()
    cfg = Config(cfg_path=args.cfg_path, options=args.options,
                 defaults=default_config_path)
    for section in ("model", "datasets", "run"):
        if section not in cfg.config:
            cfg.config[section] = {}
    model_cfg = cfg.model_cfg
    if args.tiny:
        model_cfg["tiny"] = True
    if args.model_size:
        model_cfg["model_type"] = args.model_size

    job_id = args.job_id or time.strftime("%Y%m%d%H%M%S")
    output_dir = _get(cfg.run_cfg, "output_dir", f"output/{job_id}")
    os.makedirs(output_dir, exist_ok=True)

    task = setup_task(cfg)
    with timer.phase("build"):
        model = build_model(model_cfg, seed=args.seed, device=device)
    if args.pruned_checkpoint:
        with timer.phase("load"):
            state = read_checkpoint(args.pruned_checkpoint)
            if args.strip_lora_masks:
                state = strip_lora_masks(state)
            load_checkpoint(model, state, keep=(
                ("lora_a", "lora_b") if args.strip_lora_masks else ()))
            del state
    if args.vit_pruned_checkpoint or args.t5_pruned_checkpoint:
        with timer.phase("graft"):
            graft_tower_checkpoints(
                model, vit_path=args.vit_pruned_checkpoint,
                t5_path=args.t5_pruned_checkpoint,
                vit_prefix=args.vit_model_prefix,
                t5_prefix=args.t5_model_prefix)
    arch = _get(model_cfg, "arch", "blip2_t5_instruct")

    tok, qtok = _tokenizers(model, model_cfg)
    # generation-driven tasks need the tokenizers to decode
    if hasattr(task, "tokenizer"):
        task.tokenizer = tok
        task.qformer_tokenizer = qtok
    if arch == "blip2_t5_instruct":
        prepare = make_t5_batch_preparer(tok, qtok)
    elif arch == "blip2_vicuna_instruct":
        prepare = make_vicuna_batch_preparer(tok, qtok)
    else:
        prepare = None

    datasets = task.build_datasets(cfg)
    runner = RunnerBase(cfg, task, model, datasets, job_id=job_id,
                        prepare_batch=prepare)
    stats: Dict[str, object] = {"job_id": job_id}

    if args.prune:
        from vlm_compression_tpu_torch.common._yaml import safe_load

        t0 = time.perf_counter()
        with timer.phase("calibration"):
            batches = [
                {k: torch.from_numpy(v) for k, v in b.items()
                 if isinstance(v, np.ndarray) and v.dtype != object}
                for b in runner.get_dataloader_for_importance_computation(
                    num_data=args.num_data_for_prune, power=args.power,
                    batch_size=args.prune_batch_size)]
        sparsity_dict = None
        if args.sparsity_dict:
            with open(args.sparsity_dict) as f:
                sparsity_dict = safe_load(f.read())
        with timer.phase("prune"):
            pruner = load_pruner(
                args.pruning_method, model, batches,
                t5_prune_spec=args.t5_prune_spec,
                vit_prune_spec=args.vit_prune_spec,
                prune_n=args.prune_n, prune_m=args.prune_m,
                num_samples=args.num_data_for_prune,
                sparsity_ratio_granularity=args.sparsity_ratio_granularity,
                score_method=args.score_method,
                num_data_first_stage=args.num_data_first_stage,
                num_noise=args.num_noise,
                max_sparsity_per_layer=args.max_sparsity_per_layer,
                owl_m=args.owl_m,
                sparsity_dict=sparsity_dict,
                t5_model_prefix=args.t5_model_prefix,
                vit_model_prefix=args.vit_model_prefix,
                initial_method=args.initial_method,
                without_dsnot=args.without_dsnot,
                is_global=args.is_global,
                prune_per_model=args.prune_per_model,
                iteration=args.iteration)
            # prune WITHOUT the LoRA wrapper: the pruned weights are zeroed
            model, _ = pruner.prune(lora_model=False)
            del batches, pruner
        runner.model = model
        stats["prune_seconds"] = round(time.perf_counter() - t0, 2)
        if args.save_pruned_model:
            path = os.path.abspath(
                os.path.join(output_dir, f"pruned_{job_id}"))
            with timer.phase("save"):
                torch.save(model.state_dict(), path)
            stats["pruned_checkpoint"] = path

    if args.quantize_int8:
        from vlm_compression_tpu_torch.ops.quant import quantize_model_int8_

        quantize_model_int8_(runner.model)
        logging.info("weights quantized to int8")

    with timer.phase("eval"):
        results = runner.evaluate(skip_reload=True)
    stats["eval_results"] = results
    with open(os.path.join(output_dir, f"eval_stats_{job_id}.json"),
              "w") as f:
        json.dump(stats, f, indent=2, default=str)
    return stats, runner, timer


def main(argv: Optional[list] = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
