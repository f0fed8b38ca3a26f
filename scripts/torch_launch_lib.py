"""The launcher grid of the PyTorch port: the experiment matrix of
``scripts/launch_lib.py`` composed against the port's CLIs
(``python -m vlm_compression_tpu_torch.cli.{evaluate,train}``), one
process per call, with ``--device`` appended when a device is given.

  from torch_launch_lib import train_ressa, eval_checkpoint
  job = train_ressa("wanda", 0.5, 0.5, kl_weight=0.1)
  eval_checkpoint(f"output/continue_stage2_cc3m_t5_instruct/pruned_{job}")

Each function runs its commands through ``run`` (by default: print the
command, run it, exit with its code when it fails); a caller that passes
another ``run`` (``cmds.append``) gets the commands without running them.
"""

from __future__ import annotations

import subprocess
import sys

# pruner name → (registry method, granularity, score_method)
METHOD_MATRIX = {
    "wanda": ("blipt5_wanda_pruner", "none", "obd_avg"),
    "sparsegpt": ("blipt5_sparsegpt_pruner", "none", "obd_avg"),
    "dsnot": ("blipt5_dsnot_pruner", "none", "obd_avg"),
    # EcoFLaP: Wanda masks under a non-uniform per-block budget scored by
    # zeroth-order (MeZO) or first-order gradients
    "zeroth": ("blipt5_wanda_pruner", "block", "olmezo-gradient_sum"),
    "first": ("blipt5_wanda_pruner", "block", "aobd_sum"),
    "mag": ("blipt5_mag_pruner", "none", "obd_avg"),
    "rand": ("blipt5_rand_pruner", "none", "obd_avg"),
}

EVAL_TASKS = ["okvqa_zeroshot_flant5xl_eval", "gqa_zeroshot_flant5xl_eval",
              "nocaps_flant5xl_eval", "vqav2_zeroshot_flant5xl_eval",
              "ret_flickr_eval"]

CLI = "vlm_compression_tpu_torch.cli."


def _run(cmd):
    print("+", " ".join(cmd), flush=True)
    rc = subprocess.call(cmd)
    if rc != 0:
        sys.exit(rc)


def _device(device):
    return ["--device", device] if device else []


def _suite(family: str, instruct: bool):
    """The zero-shot eval yamls of a grid point (the Vicuna grid skips
    retrieval)."""
    for task in EVAL_TASKS:
        if family == "vicuna":
            if task == "ret_flickr_eval":
                continue
            task = task.replace("_flant5xl_eval", "_vicuna_instruct_eval")
        elif instruct:
            task = task.replace("_eval", "_instruct_eval")
        yield task


def prune_and_eval(pruner: str, t5_ratio: float, vit_ratio: float,
                   prune_n: int = 0, prune_m: int = 0,
                   instruct: bool = True, model_size: str = "xl",
                   family: str = "t5", extra=(), device=None, run=_run):
    """Prune and save, then the zero-shot suite on the checkpoint."""
    method, gran, score = METHOD_MATRIX[pruner]
    prune_cfg = ("configs/projects/eval/prune_stage2_t5_instruct.yaml"
                 if instruct else "configs/projects/eval/prune_stage2.yaml")
    if family == "vicuna":
        prune_cfg = "configs/projects/eval/prune_stage2_vicuna_instruct.yaml"
    tag = (f"{pruner}_{t5_ratio}_{vit_ratio}" if prune_n == 0
           else f"{pruner}_{prune_n}:{prune_m}")
    job_id = f"prune-{model_size}-{tag}"
    cmd = [sys.executable, "-m", CLI + "evaluate",
           "--cfg-path", prune_cfg,
           "--prune", "--pruning_method", method, "--save_pruned_model",
           "--t5_prune_spec", f"24-{t5_ratio}-1.0-1.0",
           "--vit_prune_spec", f"39-{vit_ratio}-1.0-1.0",
           "--prune_n", str(prune_n), "--prune_m", str(prune_m),
           "--model_size", model_size, "--job_id", job_id,
           "--score_method", score,
           "--sparsity_ratio_granularity", gran,
           # the checkpoint path below is the one the CLI derives from
           # run.output_dir
           "--options", f"run.output_dir=output/{job_id}",
           *extra]
    if family == "vicuna":
        cmd += ["--t5_model_prefix", "llm_model"]
    run(cmd + _device(device))

    ckpt = f"output/{job_id}/pruned_{job_id}"
    for task in _suite(family, instruct):
        run([sys.executable, "-m", CLI + "evaluate",
             "--cfg-path", f"configs/projects/eval/{task}.yaml",
             "--pruned_checkpoint", ckpt,
             "--job_id", f"{job_id}-{task}", *_device(device)])


def train_ressa(pruner: str, t5_ratio: float, vit_ratio: float,
                kl_weight: float = 0.1, prune_n: int = 0, prune_m: int = 0,
                max_train_samples: int = 25000, instruct: bool = True,
                model_size: str = "xl", tune_opt: str = "LVQ",
                lora_r_v: int = 4, lora_r_l: int = 8, lora_r_q: int = 2,
                family: str = "t5", extra=(), device=None, run=_run) -> str:
    """Prune → SparseLoRA + KD retrain → merge → save; returns the job id
    (the checkpoint is ``<run.output_dir>/pruned_<job id>``)."""
    method, gran, score = METHOD_MATRIX[pruner]
    train_cfg = ("configs/projects/train/continue_stage2_cc3m_t5_instruct"
                 ".yaml" if instruct else
                 "configs/projects/train/continue_stage2_cc3m.yaml")
    if family == "vicuna":
        train_cfg = ("configs/projects/train/"
                     "continue_stage2_vicuna_instruct.yaml")
    tag = (f"{pruner}_{kl_weight}_{t5_ratio}_{vit_ratio}" if prune_n == 0
           else f"{pruner}_{kl_weight}_{prune_n}:{prune_m}")
    job_id = (f"ressa-{model_size}-{tag}_{tune_opt}_"
              f"{max_train_samples}_{lora_r_v}_{lora_r_l}_{lora_r_q}")
    cmd = [sys.executable, "-m", CLI + "train",
           "--cfg-path", train_cfg,
           "--prune", "--pruning_method", method,
           "--t5_prune_spec", f"24-{t5_ratio}-1.0-1.0",
           "--vit_prune_spec", f"39-{vit_ratio}-1.0-1.0",
           "--prune_n", str(prune_n), "--prune_m", str(prune_m),
           "--num_data_for_prune", "128", "--prune_batch_size", "1",
           "--train", "--sparse", "--tune_opt", tune_opt,
           "--lora_r_v", str(lora_r_v), "--lora_r_l", str(lora_r_l),
           "--lora_r_q", str(lora_r_q), "--lora_alpha", "16",
           "--kl_weight", str(kl_weight), "--T", "1",
           "--max_train_samples", str(max_train_samples),
           "--score_method", score,
           "--sparsity_ratio_granularity", gran,
           "--model_size", model_size, "--job_id", job_id,
           "--save_pruned_model", *extra]
    if family == "vicuna":
        cmd += ["--t5_model_prefix", "llm_model"]
    run(cmd + _device(device))
    return job_id


def eval_checkpoint(ckpt: str, family: str = "t5", instruct: bool = True,
                    strip: bool = True, extra=(), device=None, run=_run):
    """The zero-shot suite on a saved RESSA checkpoint (``strip``: its
    LoRA and mask entries left out, the merged weights alone)."""
    for task in _suite(family, instruct):
        cmd = [sys.executable, "-m", CLI + "evaluate",
               "--cfg-path", f"configs/projects/eval/{task}.yaml",
               "--pruned_checkpoint", ckpt, *extra]
        if strip:
            cmd.append("--strip_lora_masks")
        run(cmd + _device(device))
