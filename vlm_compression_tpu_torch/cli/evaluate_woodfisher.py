"""The WoodFisher / distillation-merge evaluation CLI of the port (port of
``vlm_compression_tpu/cli/evaluate_woodfisher.py``):

  python -m vlm_compression_tpu_torch.cli.evaluate_woodfisher \\
      --cfg-path eval.yaml --distillation_init unstrct_woodfisher \\
      --get_derivative_info --num_data 64 --distill_merge_ratio 0.5

  * importance scores: WoodFisher's block Fisher inverse when
    ``--distillation_init`` contains ``woodfisher`` and
    ``--get_derivative_info`` is set, else the diagonal Fisher
    (``--get_derivative_info``) or the activation statistics
    (``--get_activation_info``), split per tower by the ``visual_encoder``
    / ``t5_model`` prefixes; or precomputed ones
    (``--vit_importance_measure`` / ``--t5_importance_measure``, ``.npz``);
  * an ``unstrct`` init zeroes the lowest-scored weights of each scored
    leaf at keep 1 − ``--distill_merge_ratio``;
  * otherwise ``--distilled_block_ids`` merges groups of blocks
    (``--distilled_block_weights``, ``--permute_before_merge``,
    ``--modules_to_merge``) and rebuilds the model at the merged depths; a
    ``|`` splits the spec into ``vit_ids|t5_ids``, and groups are clipped
    to each tower's depth;
  * ``--save_final_activations``, ``--save_pruned_indices`` and
    ``--save_importance_measure`` each write ``<output_dir>/<kind>/<job>.npz``
    (keys ``vit:<path>`` / ``t5:<path>`` as in the JAX CLI) and stop there;
  * else the original and compressed parameter counts and
    ``runner.evaluate(skip_reload=True)`` go to
    ``woodfisher_stats_<job>.json``.

It takes every flag of the JAX CLI, plus ``--device``: the card unless the
caller asks for the CPU (``--device cpu``); with no card and no
``--device`` it raises.  ``--tiny`` builds the tiny model.  WoodFisher's
block inverses take numel × 256 × 4 bytes over both towers; see
``compression/woodfisher.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="woodfisher/distill evaluate")
    p.add_argument("--cfg-path", default=None)
    p.add_argument("--options", nargs="+", default=None)
    p.add_argument("--job_id", default=None)
    # distillation / merging
    p.add_argument("--side_pretrained_weight", default=None)
    p.add_argument("--vit_side_pretrained_weight", default=None)
    p.add_argument("--distillation_init", default="sum")
    p.add_argument("--distilled_block_ids", default=None)
    p.add_argument("--distilled_block_weights", default=None)
    p.add_argument("--modules_to_merge", default=".*")
    p.add_argument("--permute_before_merge", action="store_true")
    p.add_argument("--permute_on_block_before_merge", action="store_true")
    p.add_argument("--vit_ffn_ratio", type=float, default=1.0)
    p.add_argument("--distilled_merge_ratio", type=float, default=0.5)
    p.add_argument("--distill_merge_ratio", type=float, default=0.5)
    p.add_argument("--exact", action="store_true")
    p.add_argument("--normalization", action="store_true")
    p.add_argument("--metric", default="dot")
    p.add_argument("--to_one", action="store_true")
    p.add_argument("--importance", action="store_true")
    # scoring data
    p.add_argument("--num_data", type=int, default=64)
    p.add_argument("--power", type=int, default=2)
    p.add_argument("--num_logits", type=int, default=1)
    p.add_argument("--get_derivative_info", action="store_true")
    p.add_argument("--get_activation_info", action="store_true")
    p.add_argument("--use_input_activation", action="store_true")
    p.add_argument("--vision_weight", type=float, default=0.0)
    # artifacts
    p.add_argument("--save_pruned_indices", action="store_true")
    p.add_argument("--vit_pruned_indices", default=None)
    p.add_argument("--t5_pruned_indices", default=None)
    p.add_argument("--save_importance_measure", action="store_true")
    p.add_argument("--vit_importance_measure", default=None)
    p.add_argument("--t5_importance_measure", default=None)
    p.add_argument("--save_final_activations", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    return p


def parse_args(argv=None):
    return _parser().parse_args(argv)


def _split_by_tower(scores):
    vit = {p[1:]: s for p, s in scores.items() if p[0] == "visual_encoder"}
    t5 = {p[1:]: s for p, s in scores.items() if p[0] == "t5_model"}
    return vit, t5


def _merge_spec_for(spec: Optional[str], tower: str):
    if spec is None:
        return None
    if "|" in spec:
        vit_spec, t5_spec = spec.split("|", 1)
        return vit_spec if tower == "vit" else t5_spec
    return spec


def _clip_groups(groups, depth):
    out = []
    for g in groups:
        ids = [i for i in g if 0 <= i < depth]
        if ids:
            out.append(ids)
    return out


def _load_measure(path: str, device):
    return {tuple(k.split("/")): torch.from_numpy(v).to(device)
            for k, v in np.load(path).items()}


def merge_model_blocks(model: torch.nn.Module, args) -> torch.nn.Module:
    """The model rebuilt with its ViT and T5 towers' blocks merged as the
    ``--distilled_block_*`` flags say (depths ``len(groups)``), every other
    entry of its state carried over."""
    from vlm_compression_tpu_torch.cli.evaluate import load_checkpoint
    from vlm_compression_tpu_torch.compression.distill_merge import (
        merge_tower_blocks,
        parse_block_ids,
        parse_block_weights,
    )

    cfg = model.cfg
    permute = args.permute_before_merge or args.permute_on_block_before_merge
    spec = args.distilled_block_ids
    vit_groups = _clip_groups(parse_block_ids(_merge_spec_for(spec, "vit")),
                              cfg.vit.depth)
    t5_spec = _merge_spec_for(spec, "t5")
    enc_groups = _clip_groups(parse_block_ids(t5_spec), cfg.t5.num_layers)
    dec_groups = _clip_groups(parse_block_ids(t5_spec),
                              cfg.t5.num_decoder_layers)
    plan = (("visual_encoder", vit_groups, parse_block_weights(
                _merge_spec_for(args.distilled_block_weights, "vit"),
                vit_groups)),
            ("t5_model.encoder", enc_groups, parse_block_weights(
                _merge_spec_for(args.distilled_block_weights, "t5"),
                enc_groups)),
            ("t5_model.decoder", dec_groups, None))
    state = model.state_dict()
    for prefix, groups, weights in plan:
        head = prefix + "."
        tower = {k[len(head):]: state.pop(k) for k in list(state)
                 if k.startswith(head)}
        merged = merge_tower_blocks(tower, groups, weights,
                                    modules_to_merge=args.modules_to_merge,
                                    permute=permute)
        state.update({head + k: v for k, v in merged.items()})
    new_cfg = dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, depth=len(vit_groups)),
        t5=dataclasses.replace(cfg.t5, num_layers=len(enc_groups),
                               num_decoder_layers=len(dec_groups)))
    cls, device = type(model), next(model.parameters()).device
    del model
    new = cls(new_cfg, device=device)
    load_checkpoint(new, state)
    return new


def run(args):
    """The CLI's work for parsed ``args``: (the artifact's path or the
    stats written to ``woodfisher_stats_<job>.json``, the runner holding
    the final model, a ``PhaseTimer`` with the seconds of its phases)."""
    from vlm_compression_tpu_torch.common.config import Config
    from vlm_compression_tpu_torch.common.device import resolve_device
    from vlm_compression_tpu_torch.common.profiling import PhaseTimer
    from vlm_compression_tpu_torch.compression.derivatives import (
        convert_activation_to_importance,
        get_activations,
        get_data_derivative,
    )
    from vlm_compression_tpu_torch.compression.distill_merge import (
        count_nonzero,
        count_params,
        prune_by_importance,
    )
    from vlm_compression_tpu_torch.compression.woodfisher import WoodFisher
    from vlm_compression_tpu_torch.datasets.tokenization import (
        load_tokenizer,
    )
    from vlm_compression_tpu_torch.models.factory import build_model
    from vlm_compression_tpu_torch.models.model_zoo import (
        default_config_path,
    )
    from vlm_compression_tpu_torch.runners.runner_base import RunnerBase, _get
    from vlm_compression_tpu_torch.tasks import setup_task
    from vlm_compression_tpu_torch.tasks.preparers import (
        make_t5_batch_preparer,
    )

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
    job_id = args.job_id or time.strftime("%Y%m%d%H%M%S")
    output_dir = _get(cfg.run_cfg, "output_dir", f"output/{job_id}")
    os.makedirs(output_dir, exist_ok=True)

    task = setup_task(cfg)
    with timer.phase("build"):
        model = build_model(model_cfg, seed=args.seed, device=device)
    tok = load_tokenizer(_get(model_cfg, "tokenizer_path"),
                         vocab_size=model.cfg.t5.vocab_size)
    qtok = load_tokenizer(_get(model_cfg, "qformer_tokenizer_path"),
                          vocab_size=model.cfg.qformer.vocab_size)
    if hasattr(task, "tokenizer"):
        task.tokenizer = tok
        task.qformer_tokenizer = qtok
    prepare = make_t5_batch_preparer(tok, qtok)
    datasets = task.build_datasets(cfg)
    runner = RunnerBase(cfg, task, model, datasets, job_id=job_id,
                        prepare_batch=prepare)

    orig_total_size = count_params(model)

    def scoring_batches():
        return [{k: torch.from_numpy(v).to(device) for k, v in b.items()
                 if isinstance(v, np.ndarray) and v.dtype != object}
                for b in runner.get_dataloader_for_importance_computation(
                    num_data=args.num_data, power=args.power, batch_size=1)]

    # ---- importance scores ----------------------------------------------
    vit_scores = t5_scores = None
    init = args.distillation_init or ""
    if "woodfisher" in init and args.get_derivative_info:
        with timer.phase("scores"):
            wf = WoodFisher(model, scoring_batches(),
                            num_samples=args.num_data, fisher_damp=1e-3,
                            fisher_parts=5,
                            include=lambda p: p[0] in ("visual_encoder",
                                                       "t5_model"))
            vit_scores, t5_scores = _split_by_tower(
                wf.compute_fisher_inv_and_importance_score())
            del wf
    elif args.get_derivative_info:
        with timer.phase("scores"):
            vit_scores, t5_scores = _split_by_tower(get_data_derivative(
                model, scoring_batches(), power=args.power))
    elif args.get_activation_info:
        with timer.phase("scores"):
            imp = convert_activation_to_importance(
                get_activations(model, scoring_batches()),
                square=not args.use_input_activation)
            vit_scores = {p[1:]: s for p, s in imp.items()
                          if p and p[0] == "visual_encoder"}
            t5_scores = {p[1:]: s for p, s in imp.items()
                         if p and p[0] == "t5_model"}

    # precomputed measures
    if args.vit_importance_measure:
        vit_scores = _load_measure(args.vit_importance_measure, device)
    if args.t5_importance_measure:
        t5_scores = _load_measure(args.t5_importance_measure, device)

    # ---- tower modification ---------------------------------------------
    pruned_indices = {"vit": None, "t5": None}
    if "unstrct" in init and vit_scores is not None:
        keep = 1.0 - args.distill_merge_ratio
        with timer.phase("prune"):
            _, vit_idx = prune_by_importance(model.visual_encoder,
                                             vit_scores, keep_ratio=keep)
            _, t5_idx = prune_by_importance(model.t5_model, t5_scores,
                                            keep_ratio=keep)
        pruned_indices = {"vit": vit_idx, "t5": t5_idx}
    elif args.distilled_block_ids:
        with timer.phase("merge"):
            runner.model = model = merge_model_blocks(model, args)

    # ---- artifact dumps -------------------------------------------------
    def _dump(folder, payload):
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, f"{job_id}.npz")
        np.savez(path, **payload)
        print(path)
        return path, runner, timer

    def host(t):
        return t.detach().float().cpu().numpy() if t.is_floating_point() \
            else t.detach().cpu().numpy()

    if args.save_final_activations:
        outputs = runner.get_last_activations(num_data=args.num_data,
                                              power=args.power)
        return _dump(os.path.join(output_dir, "final_activations"),
                     {"logits": outputs["logits"],
                      "texts": np.asarray(outputs["texts"], object)})
    if args.save_pruned_indices:
        payload = {}
        for tower, idx in pruned_indices.items():
            for p, v in (idx or {}).items():
                payload[f"{tower}:{'/'.join(p)}"] = host(v)
        return _dump(os.path.join(output_dir, "pruned_indices"), payload)
    if args.save_importance_measure:
        payload = {}
        for tower, sc in (("vit", vit_scores), ("t5", t5_scores)):
            for p, v in (sc or {}).items():
                payload[f"{tower}:{'/'.join(p)}"] = host(v)
        return _dump(os.path.join(output_dir, "importance_measure"), payload)

    # ---- size accounting + eval -----------------------------------------
    if "unstrct" in init:
        distilled_total_size = count_nonzero(model)
    else:
        distilled_total_size = count_params(model)
    runner.orig_total_size = orig_total_size
    runner.distilled_total_size = distilled_total_size

    with timer.phase("eval"):
        results = runner.evaluate(skip_reload=True)
    stats = {"job_id": job_id, "orig_total_size": orig_total_size,
             "distilled_total_size": distilled_total_size,
             "eval_results": results}
    with open(os.path.join(output_dir, f"woodfisher_stats_{job_id}.json"),
              "w") as f:
        json.dump(stats, f, indent=2, default=str)
    return stats, runner, timer


def main(argv: Optional[list] = None):
    logging.basicConfig(level=logging.INFO)
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
