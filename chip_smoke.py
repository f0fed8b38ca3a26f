#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  Phases,
each of which fails the run (non-zero exit, no result line) on error:

  1. device   — the card's name and its nvidia-smi name/power-limit line;
  2. build    — every hand-written kernel source compiled from csrc/ with
                nvcc, in parallel (the Hopper loop of the masked, packed and
                sparse-LoRA matmuls, masked_matmul_wgmma.cu, and of the int8
                one, int8_matmul_wgmma.cu, are sources of their own: their
                build seconds stand on their own line);
  3. kernels  — each kernel against its plain PyTorch version at the main
                path's shapes (prune, generate, retrain, the compressed
                path, and dbias at the first-order path's and every other
                broadcast pattern), in bf16 and float32, within stated
                tolerances; each bf16 masked, packed, int8 and sparse-LoRA
                shape on the main loop that ``plan`` picks (the Hopper
                loop at every calibration, training and prefill shape,
                split-K across a cluster where the output tiles do not
                fill the card; the decode kernel, csrc/matmul_decode.cu,
                at every decode shape, never the Hopper loop), packed ≡
                bool and int8 with a mask (bool, packed G 128 and 256) ≡
                int8 on codes zeroed off it, bit for bit, and two identical
                split calls of each form bit-equal; the attention backward on
                the route ``ops/attention.plan`` picks (bf16: the TMA +
                wgmma kernel) and on the mma.sync route, causal, ragged,
                dq alone and dk/dv alone, and two identical calls of the
                planned route bit-equal (dq, dk, dv) at every BWD_SHAPES
                shape and at the towers' batch 1 and 16 (dq summed over
                the kv tiles in a fixed order), the forward the backward
                starts from held there too;
                dbias of every bias of each DBIAS_SHAPES case on the
                separate dbias kernel, and, in bf16, of each bias the TMA
                + wgmma backward returns (``plan_dbias``: it keeps the
                query and key dims) from that kernel, with dq, dk, dv and
                alone, and two identical calls bit-equal at batch 16 and
                1; the forward
                on the route ``plan_forward`` picks (bf16: the TMA + wgmma
                kernel) and on the mma.sync route at every FLASH_SHAPES
                shape and causal n = m and n > m, and two identical calls
                of the new route bit-equal; the VQA eval's shapes among
                them (the beam-decode steps at M = 320, split-K; the
                ranking decoder at M = 8192, its cross k/v at 90112 rows;
                attention at batch 320 and 2048); the Vicuna path's
                (LLaMA's linears at K, N ∈ {4096, 11008}; its attention at
                d = 128 on the mma.sync kernel, under LLaMA's one additive
                bias: the calibration sweep, the primes and the decode
                steps at b = 20 and 320, and rows that see no valid key),
                two identical calls bit-equal there too; the caption
                pass's (the T5 encoder over 32 + 3 tokens, its cross k/v
                for 320 × 35 rows, the decoder's self-attention over up to
                31 cache slots); the Vicuna retrain's (sparse-LoRA at
                LLaMA's widths, M = 32 × 72, r = 8, the down projection at
                K = 11008; the Q-Former's attention over 32 + 34 tokens;
                the attention backward at d = 128 on the
                mma.sync kernels under the causal + pad bias, against the
                plain version in bf16 and fp32, two calls bit-equal); the
                retrieval path's (the pruned ViT at the eval loader's
                ragged last batch, b = 32, M = 32 × 257; the stage-1
                Q-Former's queries-only image pass at b = 64 and 32, its
                text-only pass over captions of 35 tokens at b = 256 and
                32, the ITM rerank at b = 128 over 32 + 35 tokens and its
                cross-attention to the 257 image tokens);
  4. reference — a tiny float32 InstructBLIP-T5 on the card (kernels) vs
                the same model on the CPU (plain versions): masked logits
                (bool, packed and int8 leaves), one KD train step (loss,
                LoRA gradients and update), the diagonal Fisher of every
                leaf, the aobd_sum block allocation (ratios equal) and the
                Wanda masks under it (bit-equal), the VQA task's
                ``valid_step`` in generate (beam 2) and rank mode (answers
                equal; ``predict_class_t5``'s NLLs within 1e-4);
                every pruner name of the launcher grid's other pruners
                (``t5_``/``vit_wanda``, ``{t5,vit,blipt5}_dsnot``
                unstructured and 2:4 with the wanda and sparsegpt initial
                metrics, ``blipt5_{mag,absmag,aobd,mezo}``: masks
                bit-equal; ``rand``: two runs on the card from one seed
                bit-equal); SparseGPT at an XL shape on the card vs the CPU
                (mask bits that differ), and one batched group of linears
                against its members one by one; DSnoT at the T5-XL wo
                shape, unstructured and 2:4 (at most 1e-4 of the mask
                entries differ, cycles equal); a tiny float32
                InstructBLIP-Vicuna: masked logits within 1e-4, beam-2
                ``generate_vicuna`` tokens equal, the Wanda and DSnoT masks
                over the ViT and ``llm_model`` bit-equal (DSnoT's cycles by
                linear equal); DSnoT at LLaMA-7B's down shape too; a tiny
                float32 stage-1 Blip2Qformer through ``RetrievalTask`` at
                k_test 0 and 2: score matrices within 1e-4, the same
                entries reranked, the metrics equal;
  5. main path — full-width InstructBLIP-FlanT5-XL (EVA-ViT-g 39 layers,
                Q-Former, FlanT5-XL 24+24, bf16, seeded random weights,
                SparseLoRA adapters tune_opt=LVQ with ranks 4/8/2):
                ``blipt5_wanda_pruner`` with lora_model=True (masks kept)
                on 128 synthetic calibration samples; beam-5
                ``generate_t5`` on 4 requests, twice (cold, then warm; the
                two must agree); RESSA retraining (dense teacher,
                sparse_lora student, KD loss, AdamW on the LoRA factors) for
                1 cold + 3 timed steps at batch 32, then the first two again
                from the saved starting state (LoRA leaves bit-equal to the
                first run's after two steps; every sparse-LoRA, attention
                and attention-backward shape it launched one that phase 3
                checked); the sparse merge;
                beam-5 generate from the merged model; then its zero-shot
                VQA eval through the tasks (``setup_task``, ``evaluation``,
                ``after_evaluation``) at the eval yamls' settings (batch
                64, beam 5, max_len 10): GQA cold and warm (answers equal;
                exactly 50.00 against a ground truth of each even
                question's own answer), OK-VQA with the lemmatizer (the
                VQAv2 accuracy's closed form), the answers equal to a
                direct ``generate_t5``'s decoded tokens, ranking the 64
                questions over 128 candidates in 4 chunks (answers from
                the list, NLLs finite, equal to a direct
                ``predict_class_t5``'s argmin), every masked-linear and
                attention shape of these phases one that phase 3 checked,
                and one GQA pass profiled; then NoCaps captioning through
                the captioning task at the NoCaps (and COCO) eval yaml's
                settings (batch 64, beam 5, max_len 30, min_len 8), cold
                and warm (captions equal, and equal to a direct
                ``generate_t5``'s decoded tokens; no EOS before position
                min_len; each image's own caption as its reference gives
                BLEU-1..4 and ROUGE-L of exactly 1 in the host-only
                caption metrics), once more with EOS made the top logit
                of every step (every caption ends, none before min_len,
                each equal to a direct ``generate_t5``'s), its shapes
                checked in phase 3, one pass profiled.  Each phase's
                kernels must have launched in it;
  6. compressed path — a second full-width XL model (seed 1, after the
                first is freed; no adapters): ``blipt5_sparsegpt_pruner``
                (masks kept, updated kernels) on 128 samples, with the
                Hessians it damped per tower; beam-5
                generate with bool masks; the masks bit-packed at 2 and 1
                bits a weight (tokens equal to the bool ones); int8 weights
                with packed masks (generate twice, equal); the serving form
                (weights zeroed off their masks, masks dropped, int8).
                Sizes at rest of each form; each form's generate (bool,
                packed-128/256, int8) profiled twice, on the planned loops
                and with int8 prefill and the under-filled prefill shapes
                on the WMMA loop (the plan before the Hopper loop took
                them): device time by loop (decode kernel, Hopper loop,
                WMMA loop); each phase's kernels must
                have launched in it, the bool kernel in no packed or int8
                phase;
  7. first-order path — a third full-width XL model (seed 2, no
                adapters): ``blipt5_wanda_pruner`` with the EcoFLaP
                first-order block allocation (aobd_sum on 32 samples, no
                dbias launch), the 87 group ratios, beam-5 generate twice;
                then, rebuilt dense, the diagonal Fisher over 8 batch-1
                samples (48 position-bias gradients a sample, each an
                output of the TMA + wgmma backward; the separate dbias
                kernel never launched),
                ``prune_by_importance`` at keep 0.5 and beam-5 generate;
  8. grid path — a fourth full-width XL model (seed 3, no adapters; its
                dense kernels restored between pruners):
                ``blipt5_dsnot_pruner`` (the grid's defaults, masks kept;
                the cycle histogram over the 588 linears, the refinement's
                share of the prune) and beam-5 generate; ``mag`` and
                ``rand`` layerwise, ``mag`` global (the threshold's
                defining property counted on the card); ``aobd`` on the
                128 samples (the TMA + wgmma attention backward, no bias
                gradient); the grid's zeroth entry (``blipt5_wanda_pruner``
                with a block ``olmezo-gradient_sum`` allocation) scoring
                ONE sample at batch 1 — the path's one cut: the grid scores
                32 — and beam-5 generate.  Each tower at 0.5 ± 0.01 (the
                zeroth entry: the parameter-weighted mean of its ratios and
                its masks), finite losses, every shape launched one that
                phase 3 checked;
  9. vicuna path — full-width InstructBLIP-Vicuna-7B (EVA-ViT-g 39
                layers, Q-Former 12, LLaMA 32 × 4096, ffn 11008, 32 heads of
                128, vocab 32000; bf16, seed 4; after the XL models are
                freed): ``blipt5_wanda_pruner`` with
                ``t5_model_prefix=llm_model`` on 128 synthetic packed
                samples at batch 16 (each tower 0.5 ± 0.01); beam-5
                ``generate_vicuna`` on 4 left-padded requests, cold and
                warm (tokens equal); GQA cold and warm (exactly 50.00) and
                OK-VQA (the closed form) through the tasks at the Vicuna
                eval yamls' settings, the answers equal to a direct
                ``generate_vicuna``'s; every shape launched one that phase
                3 checked, no WMMA-loop launch, and one GQA pass profiled
                (busy share, device time by kernel group, peak memory);
                then RESSA retraining of the pruned model (SparseLoRA
                tune_opt=LVQ, ranks 4/8/2, on batches collated by
                ``make_vicuna_batch_preparer``, LLaMA at n = m = 72, the
                Q-Former at 32 + 34 in every batch) with the main path's
                gates (1 cold + 3 timed steps at batch 32, the first two
                replayed bit-equal; LLaMA's attention backward on the
                mma.sync kernels at d = 128, no bias gradient, no
                WMMA-loop launch; every shape launched, sparse-LoRA and
                backward included, one that phase 3 checked), one more
                step profiled,
                the sparse merge (zero off the masks, 0.5 ± 0.01) and
                beam-5 generate from the merged model; then, rebuilt dense
                from seed 4, the Vicuna grid's DSnoT entry
                (``blipt5_dsnot_pruner``, ``t5_model_prefix=llm_model``,
                scripts/vicuna/dsnot.py's defaults; each tower 0.5 ± 0.01,
                a finite loss, the refinement's cycles, host syncs and
                seconds) and beam-5 ``generate_vicuna``, every shape held
                in phase 3;
 10. retrieval path — the stage-1 BLIP-2 Q-Former at full width (arch
                blip2, model_type coco: EVA-ViT-g 39 layers in bf16, the
                Q-Former and its heads in fp32; seed 5, after the Vicuna
                model is freed): ``vit_wanda_pruner`` on its ViT (masks
                kept, 0.5 ± 0.01), then ``RetrievalTask`` at
                ret_flickr_eval.yaml's settings (batch 64, k_test 128)
                over 160 synthetic images and 800 captions (5 an image;
                the cut: Flickr30k's test split holds 1000 × 5000), cold
                and warm (score matrices bit-equal), at k_test 0 (the ITC
                pass: score_i2t == score_t2i.T; the rerank moved exactly
                each row's ITC top-k entries off it), a direct
                ``compute_sim_matrix`` (bit-equal to the task's),
                R@1/5/10 exactly 10/50/100 both ways against a ground truth
                read off the scores' own order, every shape held in phase
                3; one image batch's 64 ITM calls profiled: the ITM call's
                device ms, and its wall ms in the warm pass and the direct
                call, with the image and caption branches' rates,
                extrapolated to the Flickr30k and COCO 5k test splits;
 11. cli path — the launcher's T5 grid point ``prune_and_eval("wanda",
                0.5, 0.5)`` (scripts/launch_lib.py:41-84) through the port's
                own ``cli.evaluate`` (argv composed here, calls made in this
                process) on full-width InstructBLIP-FlanT5-XL (seed 6): the
                prune call on prune_stage2_t5_instruct.yaml over 128
                synthetic 256 × 320 .npy images with a caption each
                (``blip2_image_train``, batch 1, the checkpoint saved with
                ``torch.save``), then the GQA instruct eval call on that
                checkpoint over 64 synthetic questions (batch 64, beam 5);
                the restored weights equal to the pruned ones tensor for
                tensor, each tower 0.5 ± 0.01, GQA exactly 50.00 in
                ``eval_stats``, the answers equal to a direct
                ``generate_t5``'s, no linear kernel launched (no masks),
                every shape held in phase 3, data and checkpoint deleted;
                each call's phases timed (build, calibration, prune, save,
                load, eval), the checkpoint's size, the peaks;
 12. profile  — the main path once more under torch.profiler (prune,
                generate, one train step), the SparseGPT prune, the
                first-order path's Fisher (its attention backward's device
                time a sample) and EcoFLaP prune, and the grid path's
                zeroth scoring of 24 keys, aobd and global magnitude
                prunes and (the cut that keeps the command under 900 s:
                at 13/8/8 of its 39/24/24 blocks, timed unprofiled at
                that depth first) its DSnoT prune: device time by kernel
                group against each phase's unprofiled wall-clock;
 13. timing   — kernel, plain-version and library-call times (CUDA events,
                L2 flushed before each call) at the main path's shapes,
                beside each kernel's bound; where the masked and sparse-LoRA
                matmuls run the Hopper loop, the WMMA loop too (forced
                through the wrappers' ``_loop`` argument); the attention
                backward's two bf16 routes (``_impl``) at every training
                shape; the backward with the position bias's gradient at
                the allocation's batch-16 and the Fisher's batch-1 shape —
                one TMA + wgmma call, in turns with the unfused route (the
                backward, then the separate dbias kernel), SDPA's backward
                with a mask gradient and the backward alone; the attention
                forward's two bf16 routes at every
                FLASH_SHAPES shape; SDPA, the attention yardstick, on each
                of its backends, the fastest timed in turns with the
                kernel; every prefill and decode shape of the compressed
                path (and the int8 linears that hold no mask) in every
                weight form on its planned loop (the Hopper loop, split or
                not; the decode kernel), in turns with the WMMA loop and
                torch.matmul on the pre-masked (dequantized) weight,
                beside the plain version and the bound.

Launch gates: each phase's kernels launched in it (and the Hopper loop in
every phase that runs the masked, packed, int8 or sparse-LoRA kernel at a
calibration, training or prefill shape, the int8 generates included; the
TMA + wgmma attention forward in the Wanda prune, the retrain step, the
EcoFLaP prune and the Fisher, and its backward in the last three; the
Fisher's position-bias gradients from that backward), none that the phase
must not run (the separate dbias kernel in the retrain step, the EcoFLaP
prune and the Fisher, the bool kernel in a packed or int8 phase, the
packed one in an int8 phase; any kernel in the magnitude and random
prunes; any attention backward in the DSnoT and zeroth prunes; the dbias
outputs, the masked matmul and the WMMA loop in the aobd prune; the dbias
outputs, the separate dbias kernel and the WMMA loop in the Vicuna
retrain, which must run the sparse-LoRA kernel on the Hopper loop and
both attention routes forward and backward); the decode kernel in every generate
phase of a masked or int8 model, and no WMMA-loop launch at all in any
generate phase, the retrain step or the three VQA phases (which must run
the Hopper loop and the TMA + wgmma forward) or the caption pass, nor in any phase of the
Vicuna path, its prune included (whose LLaMA forwards must run the
mma.sync route).  WMMA-loop launches left in other
phases are printed with their shapes and why the other loops refused
them.

The last lines are the kernel JSON, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import logging
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 (CUDA cores)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3

# tolerance: max |kernel − plain| ≤ TOL · max(1, max |plain|)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# clock cycles of the spin kernel before each timed call: about 1 ms
SPIN_CYCLES = 2_000_000


def device_ms(fn, iters=20, warmup=3) -> float:
    """Median time of one call on the card: CUDA events around each call,
    with a 512 MB write before it that evicts the 50 MB L2 (a real step
    finds its weights cold) and a spin kernel of about 1 ms that keeps the
    card busy while the host enqueues the call, so host overhead stays out
    of the reading (the write alone, 0.16 ms, did not cover a slow host)."""
    flush = torch.empty(512 * 2**20, dtype=torch.int8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def max_err(got, want) -> tuple:
    """(max |got − want|, the tolerance's scale max(1, max |want|))."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite kernel output")
    return (float((got - want).abs().max()),
            max(1.0, float(want.abs().max())))


# ------------------------------------------------------------------ shapes
# masked matmul (M, K, N): ViT calibration (M = 128 samples × 257 tokens),
# T5 encoder calibration (M = 128 × 72; also the decoder's cross k/v),
# T5 decoder calibration (M = 128 × 12), Q-Former at generate (b = 4),
# beam decode steps (M = 4 requests × 5 beams)
MM_SHAPES = [
    ("vit_qkv_calib", 32896, 1408, 4224),
    ("vit_proj_calib", 32896, 1408, 1408),
    ("vit_fc1_calib", 32896, 1408, 6144),
    ("vit_fc2_calib", 32896, 6144, 1408),
    ("qformer_self_gen", 288, 768, 768),
    ("qformer_cross_kv_gen", 1028, 1408, 768),
    ("qformer_ffn_gen", 288, 3072, 768),
    ("t5_qkvo_calib", 9216, 2048, 2048),
    ("t5_wi_calib", 9216, 2048, 5120),
    ("t5_wo_calib", 9216, 5120, 2048),
    ("t5_dec_qkvo_calib", 1536, 2048, 2048),
    ("t5_dec_wi_calib", 1536, 2048, 5120),
    ("t5_dec_wo_calib", 1536, 5120, 2048),
    ("t5_qkvo_decode", 20, 2048, 2048),
    ("t5_wi_decode", 20, 2048, 5120),
    ("t5_wo_decode", 20, 5120, 2048),
    # the VQA eval of 64 questions (vqa_path): ViT M = 64 × 257; T5 encoder
    # M = 64 × 44 (32 query tokens + the seeded batch's longest prompt, 12
    # tokens); the beam-decode steps at M = 64 × 5 beams (split-K) and the
    # cross k/v once for 320 × 44 rows; ranking in chunks of 32 candidates
    # × 64 questions × 4 label tokens (M = 8192), the cross k/v for
    # 2048 × 44 rows.  vqa_path fails if it launches a shape not listed
    ("vit_qkv_vqa", 16448, 1408, 4224),
    ("vit_proj_vqa", 16448, 1408, 1408),
    ("vit_fc1_vqa", 16448, 1408, 6144),
    ("vit_fc2_vqa", 16448, 6144, 1408),
    ("t5_qkvo_vqa", 2816, 2048, 2048),
    ("t5_wi_vqa", 2816, 2048, 5120),
    ("t5_wo_vqa", 2816, 5120, 2048),
    ("t5_cross_kv_vqa", 14080, 2048, 2048),
    ("t5_qkvo_beam_step", 320, 2048, 2048),
    ("t5_wi_beam_step", 320, 2048, 5120),
    ("t5_wo_beam_step", 320, 5120, 2048),
    ("t5_dec_qkvo_rank", 8192, 2048, 2048),
    ("t5_dec_wi_rank", 8192, 2048, 5120),
    ("t5_dec_wo_rank", 8192, 5120, 2048),
    ("t5_cross_kv_rank", 90112, 2048, 2048),
    # the NoCaps / COCO caption pass of 64 images (caption_path): the T5
    # encoder at M = 64 × 35 (32 query tokens + the 3 tokens of "a photo
    # of"), the cross k/v once for 320 × 35 rows; the ViT and the M = 320
    # beam-decode steps as in the VQA block.  caption_path fails if it
    # launches a shape not listed
    ("t5_qkvo_caption", 2240, 2048, 2048),
    ("t5_wi_caption", 2240, 2048, 5120),
    ("t5_wo_caption", 2240, 5120, 2048),
    ("t5_cross_kv_caption", 11200, 2048, 2048),
    # the Vicuna path (vicuna_path): LLaMA-7B's linears (q/k/v/o 4096 →
    # 4096, gate/up 4096 → 11008, down 11008 → 4096) in the calibration
    # sweep (M = 128 × (32 query tokens + 40 text)), the 4-request
    # generate's prime (M = 20 × 71: 32 query tokens + the 40-token prompt
    # minus its last, per beam) and decode steps (M = 20), the VQA eval's
    # prime (M = 320 × 44: the seeded batch's longest prompt is 13 tokens
    # with BOS) and beam steps (M = 320, split-K).  vicuna_path fails if
    # it launches a shape not listed
    ("llama_qkvo_calib", 9216, 4096, 4096),
    ("llama_gate_up_calib", 9216, 4096, 11008),
    ("llama_down_calib", 9216, 11008, 4096),
    ("llama_qkvo_prime_gen", 1420, 4096, 4096),
    ("llama_gate_up_prime_gen", 1420, 4096, 11008),
    ("llama_down_prime_gen", 1420, 11008, 4096),
    ("llama_qkvo_decode", 20, 4096, 4096),
    ("llama_gate_up_decode", 20, 4096, 11008),
    ("llama_down_decode", 20, 11008, 4096),
    ("llama_qkvo_prime_vqa", 14080, 4096, 4096),
    ("llama_gate_up_prime_vqa", 14080, 4096, 11008),
    ("llama_down_prime_vqa", 14080, 11008, 4096),
    ("llama_qkvo_beam_step", 320, 4096, 4096),
    ("llama_gate_up_beam_step", 320, 4096, 11008),
    ("llama_down_beam_step", 320, 11008, 4096),
    # the retrieval path (retrieval_path): the pruned ViT of the stage-1
    # Q-Former over the eval loader's batches of 64 images (the *_vqa rows,
    # M = 64 × 257) and the ragged last batch of 32 (M = 32 × 257); its
    # calibration at the *_calib rows.  retrieval_path fails if it
    # launches a shape not listed
    ("vit_qkv_ret_b32", 8224, 1408, 4224),
    ("vit_proj_ret_b32", 8224, 1408, 1408),
    ("vit_fc1_ret_b32", 8224, 1408, 6144),
    ("vit_fc2_ret_b32", 8224, 6144, 1408),
]
MM_TIMED = "vit_fc1_calib"

# flash (b, n, m, h, d, biases, scale): "rel" = (1, h, n, m) position bias,
# "pad" = (b, 1, 1, m) padding mask, "step" = (1, 1, n, m) step visibility
FLASH_SHAPES = [
    ("vit_self_calib", 128, 257, 257, 16, 88, [], 88 ** -0.5),
    ("vit_self_b16", 16, 257, 257, 16, 88, [], 88 ** -0.5),
    ("qformer_cross", 16, 32, 257, 12, 64, ["pad"], 0.125),
    ("qformer_self", 16, 72, 72, 12, 64, ["pad"], 0.125),
    ("t5_encoder_calib", 128, 72, 72, 32, 64, ["rel", "pad"], 1.0),
    ("t5_encoder_b16", 16, 72, 72, 32, 64, ["rel", "pad"], 1.0),
    ("t5_decoder_self_calib", 128, 12, 12, 32, 64, ["rel", "pad"], 1.0),
    ("t5_self_decode", 20, 1, 10, 32, 64, ["rel", "step"], 1.0),
    ("t5_cross_decode", 20, 1, 72, 32, 64, ["pad"], 1.0),
    # the VQA eval (the shapes of MM_SHAPES' VQA block): the towers at
    # b = 64 (Q-Former and T5 encoder over 32 + 12 tokens; the Q-Former's
    # cross-attention takes no mask), the beam-decode steps at b = 320
    # (self over the 11-slot cache), the ranking decoder over 2048 rows
    # (causal position bias at n = m = 4, cross over 44 keys)
    ("vit_self_b64", 64, 257, 257, 16, 88, [], 88 ** -0.5),
    ("qformer_cross_b64", 64, 32, 257, 12, 64, [], 0.125),
    ("qformer_self_b64", 64, 44, 44, 12, 64, ["pad"], 0.125),
    ("t5_encoder_b64", 64, 44, 44, 32, 64, ["rel", "pad"], 1.0),
    ("t5_self_beam_step", 320, 1, 11, 32, 64, ["rel", "step"], 1.0),
    ("t5_cross_beam_step", 320, 1, 44, 32, 64, ["pad"], 1.0),
    ("t5_decoder_self_rank", 2048, 4, 4, 32, 64, ["relc"], 1.0),
    ("t5_cross_rank", 2048, 4, 44, 32, 64, ["pad"], 1.0),
    # the caption pass: the Q-Former and T5 encoder over 32 + 3 tokens at
    # b = 64, the beam-decode steps at b = 320 (self over the cache of up
    # to 31 slots: max_len 30 + the start token; cross over 35 keys)
    ("qformer_self_caption", 64, 35, 35, 12, 64, ["pad"], 0.125),
    ("t5_encoder_caption", 64, 35, 35, 32, 64, ["rel", "pad"], 1.0),
    ("t5_self_beam_step_caption", 320, 1, 31, 32, 64, ["rel", "step"], 1.0),
    ("t5_cross_beam_step_caption", 320, 1, 35, 32, 64, ["pad"], 1.0),
    # the grid path (grid_path): the decoder's cross-attention in the
    # calibration sweeps (b = 128); the aobd pruner's passes at b = 16
    # (decoder); the zeroth entry's scoring forwards and the batch-1 stems
    # of its sweep; the towers at generate (b = 4 requests).  grid_path
    # fails if it launches a shape not listed
    ("t5_decoder_cross_calib", 128, 12, 72, 32, 64, ["pad"], 1.0),
    ("t5_decoder_self_b16", 16, 12, 12, 32, 64, ["rel", "pad"], 1.0),
    ("t5_decoder_cross_b16", 16, 12, 72, 32, 64, ["pad"], 1.0),
    ("vit_self_b1", 1, 257, 257, 16, 88, [], 88 ** -0.5),
    ("qformer_cross_b1", 1, 32, 257, 12, 64, ["pad"], 0.125),
    ("qformer_self_b1", 1, 72, 72, 12, 64, ["pad"], 0.125),
    ("t5_encoder_b1", 1, 72, 72, 32, 64, ["rel", "pad"], 1.0),
    ("t5_decoder_self_b1", 1, 12, 12, 32, 64, ["rel", "pad"], 1.0),
    ("t5_decoder_cross_b1", 1, 12, 72, 32, 64, ["pad"], 1.0),
    ("vit_self_gen", 4, 257, 257, 16, 88, [], 88 ** -0.5),
    ("qformer_cross_gen", 4, 32, 257, 12, 64, ["pad"], 0.125),
    ("qformer_self_gen", 4, 72, 72, 12, 64, ["pad"], 0.125),
    ("t5_encoder_gen", 4, 72, 72, 32, 64, ["rel", "pad"], 1.0),
    # the retrieval path: the ViT at the ragged last batch (b = 32, beside
    # vit_self_b64); the Q-Former's image pass over the 32 queries alone
    # (self-attention without a mask, cross-attention to 257 image
    # tokens) at b = 64 and 32; its text-only pass over the captions in
    # chunks of 256 and the remainder of 32, n = m = 35 (the captions
    # clipped at the task's 35 tokens) under the padding mask; the ITM
    # rerank at b = k_test = 128 (self over 32 queries + 35 tokens, cross
    # from the 32 queries to the image)
    ("vit_self_b32", 32, 257, 257, 16, 88, [], 88 ** -0.5),
    ("qformer_query_self_b64", 64, 32, 32, 12, 64, [], 0.125),
    ("qformer_query_self_b32", 32, 32, 32, 12, 64, [], 0.125),
    ("qformer_cross_b32", 32, 32, 257, 12, 64, [], 0.125),
    ("qformer_text_b256", 256, 35, 35, 12, 64, ["pad"], 0.125),
    ("qformer_text_b32", 32, 35, 35, 12, 64, ["pad"], 0.125),
    ("qformer_itm_self_b128", 128, 67, 67, 12, 64, ["pad"], 0.125),
    ("qformer_itm_cross_b128", 128, 32, 257, 12, 64, [], 0.125),
]
# the CLI path (cli_path): the launcher's --prune_batch_size 1 over
# captions of CLI_WORDS words (a token a word).  Prompts of several lengths
# do not fuse, so the Q-Former's self-attention and the T5 encoder run at
# b = 1 over 32 query tokens + L, the decoder over the L + 1 label tokens
# (the caption and EOS); the ViT stems fuse (vit_self_calib), the
# Q-Former's cross-attention is qformer_cross_b1, and the GQA eval call
# runs vqa_path's shapes.  cli_path fails if it launches a shape not listed
CLI_WORDS = range(8, 13)
FLASH_SHAPES += [shape for n in CLI_WORDS for shape in (
    (f"qformer_self_cli{n}", 1, 32 + n, 32 + n, 12, 64, ["pad"], 0.125),
    (f"t5_encoder_cli{n}", 1, 32 + n, 32 + n, 32, 64, ["rel", "pad"], 1.0),
    (f"t5_decoder_self_cli{n}", 1, n + 1, n + 1, 32, 64, ["rel", "pad"],
     1.0),
    (f"t5_decoder_cross_cli{n}", 1, n + 1, 32 + n, 32, 64, ["pad"], 1.0))]
FLASH_TIMED = "vit_self_calib"
# the Vicuna path (vicuna_path): LLaMA's self-attention, 32 heads of
# d = 128 (the mma.sync kernel: plan_forward sends TMA + wgmma only
# d <= 96), under one additive bias as the JAX package builds it — the
# calibration sweep (causal + right-padded text, b = 128), the primes (the
# cache's pad bias over the left-padded prompt + the step visibility,
# n = P, m = P + max_length) and the decode steps (n = 1 over the whole
# cache) of the 4-request generate (b = 20) and of the VQA eval (b = 320).
# A list of its own: the TMA + wgmma route does not take d = 128, and the
# scripts that force that route read FLASH_SHAPES.  vicuna_path fails if
# it launches a shape not listed
VICUNA_FLASH_SHAPES = [
    ("llama_self_calib", 128, 72, 72, 32, 128, ["cpad"], 128 ** -0.5),
    ("llama_prime_gen", 20, 71, 81, 32, 128, ["lpad"], 128 ** -0.5),
    ("llama_decode_gen", 20, 1, 81, 32, 128, ["dstep"], 128 ** -0.5),
    ("llama_prime_vqa", 320, 44, 55, 32, 128, ["lpad"], 128 ** -0.5),
    ("llama_beam_step", 320, 1, 55, 32, 128, ["dstep"], 128 ** -0.5),
    # the retrain (vicuna_retrain): causal + pad over 32 query tokens + 40
    # text tokens at the train batch, the forward of the backward below
    ("llama_self_train", 32, 72, 72, 32, 128, ["cpad"], 128 ** -0.5),
]
# the Vicuna shapes timed for the forward's row of the kernel line: the
# mma.sync kernel at the VQA eval's prime and beam-decode step
FLASH_VICUNA_TIMED = ("llama_prime_vqa", "llama_beam_step")

# retraining (scripts/launch_lib.py:87-125 train_ressa;
# configs/projects/train/continue_stage2_cc3m_t5_instruct.yaml): SparseLoRA
# on all three towers, KD with weight 0.1 at T = 1, AdamW at batch 32 with
# a linear warmup from 1e-6 towards 1e-4 over 1000 steps
LORA = dict(tune_opt="LVQ", lora_r_v=4, lora_r_l=8, lora_r_q=2,
            lora_alpha=16)
KL_WEIGHT, T_KD = 0.1, 1.0
TRAIN_BS, N_TIMED_STEPS = 32, 3
# the retrain steps replayed from the saved starting state (bit-equal)
N_REPLAY = 2
SCHED = dict(lr_sched="linear_warmup_cosine_lr", init_lr=1e-4, min_lr=1e-5,
             warmup_lr=1e-6, warmup_steps=1000, max_epoch=1)
WEIGHT_DECAY = 0.05

# sparse-LoRA (M, K, N, r) at the retrain batch: ViT (M = 32 × 257, r = 4),
# Q-Former (r = 2; its linears hold no mask on this path, so they run the
# unmasked adapter, but the kernel is held to its widths too), T5 encoder
# (M = 32 × 72) and decoder (M = 32 × 12), r = 8
LORA_SHAPES = [
    ("vit_qkv", 8224, 1408, 4224, 4),
    ("vit_proj", 8224, 1408, 1408, 4),
    ("vit_fc1", 8224, 1408, 6144, 4),
    ("vit_fc2", 8224, 6144, 1408, 4),
    ("qformer_self", 2304, 768, 768, 2),
    ("qformer_ffn", 1024, 768, 3072, 2),
    ("t5_enc_qkvo", 2304, 2048, 2048, 8),
    ("t5_enc_wi", 2304, 2048, 5120, 8),
    ("t5_enc_wo", 2304, 5120, 2048, 8),
    ("t5_dec_qkvo", 384, 2048, 2048, 8),
    ("t5_dec_wi", 384, 2048, 5120, 8),
    ("t5_dec_wo", 384, 5120, 2048, 8),
    # LLaMA-7B at the Vicuna retrain (vicuna_retrain: M = 32 × (32 query
    # tokens + 40 text), r = 8): q/k/v/o, gate/up, and down at K = 11008,
    # 172 K steps of 64 through the Hopper loop's ring
    ("llama_qkvo", 2304, 4096, 4096, 8),
    ("llama_gate_up", 2304, 4096, 11008, 8),
    ("llama_down", 2304, 11008, 4096, 8),
]
LORA_TIMED = "vit_fc1"
# the LLaMA shapes reported beside the timed one in the kernel line
LORA_LLAMA = ("llama_qkvo", "llama_gate_up", "llama_down")

# flash backward at the retrain batch (b, n, m, h, d, biases, scale);
# "relc" = the T5 decoder's position bias with its additive causal mask
BWD_SHAPES = [
    ("vit_self", 32, 257, 257, 16, 88, [], 88 ** -0.5),
    ("qformer_cross", 32, 32, 257, 12, 64, ["pad"], 0.125),
    ("qformer_self", 32, 72, 72, 12, 64, ["pad"], 0.125),
    ("t5_encoder", 32, 72, 72, 32, 64, ["rel", "pad"], 1.0),
    ("t5_decoder_self", 32, 12, 12, 32, 64, ["relc", "pad"], 1.0),
    ("t5_decoder_cross", 32, 12, 72, 32, 64, ["pad"], 1.0),
    # the Vicuna retrain (vicuna_retrain): the Q-Former's self-attention
    # over 32 query tokens + the batch's longest prompt, 34 words
    # (vicuna_train_batches gives every batch one); LLaMA's
    # self-attention: d = 128, so the mma.sync kernels (``plan`` sends
    # TMA + wgmma only d <= 96), under the one additive causal + pad bias,
    # which takes no gradient
    ("qformer_self_vicuna", 32, 66, 66, 12, 64, ["pad"], 0.125),
    ("llama_self", 32, 72, 72, 32, 128, ["cpad"], 128 ** -0.5),
]
BWD_TIMED = "vit_self"


def bwd_at(batch: int) -> list:
    """The BWD_SHAPES shapes the TMA + wgmma backward takes (``plan``),
    at another batch: 1 for the diagonal Fisher, 16 for the first-order
    allocation's and the aobd pruner's passes."""
    from vlm_compression_tpu_torch.ops import attention as A

    return [(f"{name}_b{batch}", batch, n, m, h, d, kinds, scale)
            for name, _, n, m, h, d, kinds, scale in BWD_SHAPES
            if A.plan(n, m, d) == A.WGMMA]


def bwd_held() -> list:
    """Every shape phase 3 holds the backward (and the forward it starts
    from) at against the plain version."""
    return BWD_SHAPES + bwd_at(1) + bwd_at(16)

# dbias (b, n, m, h, d, biases, scale, causal), the gradient of every bias
# in the list: the T5 encoder's self-attention at the first-order
# allocation's batch (16) and the diagonal Fisher's (1), position bias and
# padding mask; the decoder's ("relc": position bias + additive causal
# mask); then one case of each other broadcast pattern — "bn" (b, 1, n, m),
# "full" (b, h, n, m) under the causal flag, "pad" at n != m, "keyd1"
# (b, h, n, 1) — and ragged tiles (n = m = 200)
DBIAS_SHAPES = [
    ("t5_encoder_b16", 16, 72, 72, 32, 64, ["rel", "pad"], 1.0, False),
    ("t5_encoder_b1", 1, 72, 72, 32, 64, ["rel", "pad"], 1.0, False),
    ("t5_decoder_b16", 16, 12, 12, 32, 64, ["relc", "pad"], 1.0, False),
    ("t5_decoder_b1", 1, 12, 12, 32, 64, ["relc", "pad"], 1.0, False),
    ("per_batch", 4, 72, 72, 8, 64, ["bn"], 0.125, False),
    ("full_causal", 4, 72, 72, 8, 64, ["full"], 0.125, True),
    ("pad_n_ne_m", 4, 32, 257, 12, 64, ["pad"], 0.125, False),
    ("key_dim_1", 4, 72, 72, 8, 64, ["keyd1"], 0.125, False),
    ("ragged_200", 2, 200, 200, 4, 64, ["rel"], 0.125, False),
]
DBIAS_TIMED = "t5_encoder_b16"
# the diagonal Fisher's batch-1 shape, the one dbias is launched at
DBIAS_FISHER = "t5_encoder_b1"


# compressed serving (M, K, N): the prefill of N_REQ = 4 requests (ViT
# M = 4 × 257, T5 encoder M = 4 × 72; the decoder's cross k/v once for
# 4 × 5 beams) and beam decode (M = 4 requests × 5 beams); masked linears
# run the packed kernel (G = 128 and 256) and the int8 kernel with each
# mask kind
SERVE_SHAPES = [
    ("vit_qkv_prefill", 1028, 1408, 4224),
    ("vit_proj_prefill", 1028, 1408, 1408),
    ("vit_fc1_prefill", 1028, 1408, 6144),
    ("vit_fc2_prefill", 1028, 6144, 1408),
    ("t5_qkvo_prefill", 288, 2048, 2048),
    ("t5_wi_prefill", 288, 2048, 5120),
    ("t5_wo_prefill", 288, 5120, 2048),
    ("t5_cross_kv_prefill", 1440, 2048, 2048),
    ("t5_qkvo_decode", 20, 2048, 2048),
    ("t5_wi_decode", 20, 2048, 5120),
    ("t5_wo_decode", 20, 5120, 2048),
]
# int8 linears that hold no mask on the path: Q-Former (4 × (32 + 40)
# rows), t5_proj (4 × 32 query tokens), the LM head at decode
INT8_UNMASKED_SHAPES = [
    ("qformer_self_prefill", 288, 768, 768),
    ("qformer_ffn_prefill", 288, 768, 3072),
    ("t5_proj_prefill", 128, 768, 2048),
    ("lm_head_decode", 20, 2048, 32128),
]
PREFILL_TIMED = "vit_fc1_prefill"
PACKED_TIMED = "t5_wi_decode G128"
INT8_TIMED = "t5_wi_decode packed128"
INT8_PREFILL_TIMED = f"{PREFILL_TIMED} packed128"


def mm_inputs(m, k, n, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    w = (torch.randn(k, n, generator=g, device="cuda") * k ** -0.5).to(dtype)
    mask = torch.rand(k, n, generator=g, device="cuda") < 0.5
    return x, w, mask


def flash_inputs(b, n, m, h, d, kinds, dtype, seed=0):
    from vlm_compression_tpu_torch.ops.attention import NEG_INF

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)
               for s in (n, m, m))
    biases = []
    for kind in kinds:
        if kind == "rel":
            biases.append(torch.randn(1, h, n, m, generator=g, device="cuda"))
        elif kind == "pad":
            keep = torch.rand(b, 1, 1, m, generator=g, device="cuda") < 0.9
            keep[..., 0] = True
            biases.append(torch.where(keep, 0.0, NEG_INF))
        elif kind == "step":
            vis = torch.arange(m, device="cuda") <= m // 2
            biases.append(torch.where(vis, 0.0, NEG_INF)[None, None, None]
                          .expand(1, 1, n, m).contiguous())
        elif kind in ("cpad", "lpad", "lpad0", "dstep"):
            biases.append(llama_bias(kind, b, n, m, g))
        elif kind == "relc":
            vis = (torch.arange(m, device="cuda")[None, :]
                   <= torch.arange(n, device="cuda")[:, None] + (m - n))
            biases.append(torch.randn(1, h, n, m, generator=g, device="cuda")
                          + torch.where(vis, 0.0, NEG_INF))
        else:
            shape = {"bn": (b, 1, n, m), "full": (b, h, n, m),
                     "keyd1": (b, h, n, 1)}[kind]
            biases.append(torch.randn(shape, generator=g, device="cuda"))
    return q, k, v, biases


def llama_bias(kind, b, n, m, g):
    """LLaMA's one additive bias (b, 1, n, m), summed as the JAX package
    sums it: "cpad" the calibration's causal −1e9 mask + the padding bias
    of right-padded text (n = m); "lpad" a prime's pad bias over the cache
    — the 32 query slots valid, then a left-padded prompt of 0-3 pads —
    + the step visibility of rows 0 … n − 1; "lpad0" the same with the
    pads from slot 0 on, so the first rows of a padded request see no
    valid key (every score −1e9 or −2e9: the plain version averages v
    over the slots at −1e9, and so must the kernel); "dstep" a decode
    step's pad bias + visibility up to slot m − 4 (n = 1)."""
    from vlm_compression_tpu_torch.ops.attention import NEG_INF

    pads = torch.randint(0, 4, (b,), generator=g, device="cuda")
    j = torch.arange(m, device="cuda")
    if kind == "cpad":
        keep = j[None, :] < (m - pads)[:, None]
        cur = 0
    else:
        first = 0 if kind == "lpad0" else 32
        keep = (j[None, :] < first) | (j[None, :] >= first + pads[:, None])
        cur = m - 4 if kind == "dstep" else 0
    pad = torch.where(keep, 0.0, NEG_INF)[:, None, None, :]
    vis = j[None, :] <= cur + torch.arange(n, device="cuda")[:, None]
    return (pad + torch.where(vis, 0.0, NEG_INF)[None, None]).contiguous()


def lora_inputs(m, k, n, r, dtype, seed=0):
    """x, W, mask as mm_inputs; A he-uniform as initialized, B non-zero so
    that the merge matters."""
    x, w, mask = mm_inputs(m, k, n, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    bound = (6.0 / k) ** 0.5
    a = ((torch.rand(k, r, generator=g, device="cuda") * 2 - 1) * bound)
    b = torch.randn(r, n, generator=g, device="cuda") * 0.02
    return x, w, mask, a.to(dtype), b.to(dtype)


def grad_like(q, seed=5):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)


def _bound(flops, nbytes):
    """(least ms, what bounds it) at the H100 SXM's bf16 and HBM peaks."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def mm_bound_ms(m, k, n):
    return _bound(2.0 * m * n * k, 2.0 * m * k + 3.0 * k * n + 2.0 * m * n)


def packed_bound_ms(m, k, n, bits):
    """x, W (bf16), the mask at ``bits`` a weight, y: each once."""
    return _bound(2.0 * m * n * k,
                  2.0 * m * k + 2.0 * k * n + k * n * bits / 8 + 2.0 * m * n)


def int8_bound_ms(m, k, n, mask_bytes):
    """x (bf16), the int8 codes, the fp32 scale, the mask, y: each once."""
    return _bound(2.0 * m * n * k, 2.0 * m * k + k * n + 4.0 * n
                  + mask_bytes + 2.0 * m * n)


def lora_bound_ms(m, k, n, r):
    """The function's own work: the masked matmul's bytes plus A and B;
    its operations plus the delta A·B formed once (the kernel's recompute
    of A·B per M tile is a cost of its design, not of the function)."""
    return _bound(2.0 * m * n * k + 2.0 * k * n * r,
                  2.0 * m * k + 3.0 * k * n + 2.0 * m * n + 2.0 * (k + n) * r)


def flash_bwd_bound_ms(q, k, v, biases, dbias_of=()):
    """The whole backward (dq, dk and dv): five products (q·kᵀ, g·vᵀ,
    ds·k, dsᵀ·q, pᵀ·g), 10·b·h·n·m·d operations; q, k, v, g, lse, delta
    and the biases read once, dq, dk and dv written once — and the
    gradient of each bias in ``dbias_of`` written once in fp32 (no
    operation more: it is u = ds / scale, summed over the bias's broadcast
    axes)."""
    b, n, h, d = q.shape
    m = k.shape[1]
    es = q.element_size()
    flops = 10.0 * b * h * n * m * d
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * es + 8.0 * b * h * n \
        + sum(4.0 * x.numel() for x in biases) \
        + (q.numel() + k.numel() + v.numel()) * es \
        + sum(4.0 * biases[i].numel() for i in dbias_of)
    return _bound(flops, nbytes)


def flash_bound_ms(q, k, v, biases):
    """q, k, v and each bias read once; out and the fp32 lse written once;
    QKᵀ and PV at 2·n·m·d operations each per (batch, head)."""
    b, n, h, d = q.shape
    m = k.shape[1]
    flops = 4.0 * b * h * n * m * d
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + 4.0 * b * h * n + sum(4.0 * x.numel() for x in biases)
    return _bound(flops, nbytes)


# ------------------------------------------------------------------ phases


def check_kernels():
    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[-1]]
        for name, m, k, n in MM_SHAPES:
            x, w, mask = mm_inputs(m, k, n, dtype)
            before = loop_counts()
            got = ML.masked_matmul(x, w, mask)
            loop = check_loop("masked_matmul", name, m, k, n, dtype, before)
            err, scale = max_err(got, ML.masked_matmul_ref(x, w, mask))
            ok = err <= tol * scale
            log(f"  masked_matmul {name:22s} {str(dtype)[6:]:8s} "
                f"M={m} K={k} N={n} {loop:6s} max_abs_err={err:.3e} "
                f"(tol {tol * scale:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"masked_matmul {name} {dtype}")
            worst[("masked_matmul", name, dtype)] = err
        # the forward on the route ``plan_forward`` picks (bf16: the TMA +
        # wgmma kernel at every shape here) and, in bf16, on the mma.sync
        # route too; causal masking, including n > m rows that see no key
        cases = [(name, b, n, m, h, d, kinds, scale, False)
                 for name, b, n, m, h, d, kinds, scale in
                 FLASH_SHAPES + VICUNA_FLASH_SHAPES]
        cases += [("causal_n_eq_m", 2, 40, 40, 4, 64, [], 0.125, True),
                  ("causal_n_gt_m", 2, 9, 5, 4, 64, [], 0.125, True),
                  # LLaMA's prime with rows that see no valid key, held
                  # as the plain version defines them
                  ("llama_rows_seeing_no_key", 4, 44, 55, 32, 128,
                   ["lpad0"], 128 ** -0.5, False)]
        routes = [None] if dtype == torch.float32 else [None, A.MMA]
        for name, b, n, m, h, d, kinds, scale, causal in cases:
            q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, dtype)
            want = A.mha_reference(q, k_, v, biases, scale, causal)
            for impl in routes:
                route = impl or A.plan_forward(
                    n, m, d, bf16=dtype == torch.bfloat16)
                before = A.fwd_wgmma_launches
                got = A.flash_attention(q, k_, v, biases, scale, causal,
                                        _impl=impl)[0]
                if (A.fwd_wgmma_launches - before) != (route == A.WGMMA):
                    raise AssertionError(f"flash_attention {name}: route "
                                         f"{route} not taken")
                err, s = max_err(got, want)
                ok = err <= tol * s
                log(f"  flash_attention {name:22s} {str(dtype)[6:]:8s} "
                    f"{route:5s} b={b} n={n} m={m} h={h} d={d} "
                    f"biases={kinds} causal={causal} max_abs_err={err:.3e} "
                    f"(tol {tol * s:.3e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash_attention {name} {dtype} "
                                         f"{route}")
                if impl is None and not causal:
                    worst[("flash_attention", name, dtype)] = err
    # both bf16 forwards sum in a fixed order (no atomics): two identical
    # calls of the planned route at every shape are bit-equal (TMA +
    # wgmma at d <= 96; mma.sync at LLaMA's d = 128)
    for name, b, n, m, h, d, kinds, scale in \
            FLASH_SHAPES + VICUNA_FLASH_SHAPES:
        q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, torch.bfloat16)
        route = A.plan_forward(n, m, d)
        out1, lse1 = A.flash_attention(q, k_, v, biases, scale, _impl=route)
        out2, lse2 = A.flash_attention(q, k_, v, biases, scale, _impl=route)
        if not (torch.equal(out1, out2) and torch.equal(lse1, lse2)):
            raise AssertionError(f"flash_attention {name} ({route}): two "
                                 "identical calls differ")
    log("  flash_attention, the planned bf16 route: two identical calls "
        "bit-equal (out and lse) at every FLASH_SHAPES and "
        "VICUNA_FLASH_SHAPES shape")
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[-1]]
        # sparse-LoRA: the kernel sums Σ_r A·B in another order than the
        # plain version's matmul, which now and then flips one bf16 ulp of
        # the merged weight before the product: the masked matmul's
        # tolerance holds
        for name, m, k, n, r in LORA_SHAPES:
            x, w, mask, a, b = lora_inputs(m, k, n, r, dtype)
            before = loop_counts()
            got = ML.sparse_lora_matmul(x, w, mask, a, b, 16.0 / r)
            loop = check_loop("sparse_lora_matmul", name, m, k, n, dtype,
                              before, r)
            err, scale = max_err(
                got, ML.sparse_lora_matmul_ref(x, w, mask, a, b, 16.0 / r))
            ok = err <= tol * scale
            log(f"  sparse_lora_matmul {name:18s} {str(dtype)[6:]:8s} "
                f"M={m} K={k} N={n} r={r} {loop:5s} max_abs_err={err:.3e} "
                f"(tol {tol * scale:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"sparse_lora_matmul {name} {dtype}")
            worst[("sparse_lora_matmul", name, dtype)] = err
        # flash backward: dq, and dk with dv, against the plain version
        # from the same out and lse, on the route ``plan`` picks (bf16:
        # the TMA + wgmma kernel) and, in bf16, on the mma.sync route too;
        # causal n = m and n > m, ragged tiles on both sides (n = m = 200),
        # and dq alone and dk/dv alone; at the training shapes and at the
        # towers' batch 1 and 16 (the Fisher; the first-order and aobd
        # passes), the forward the backward starts from as well
        cases = [(name, b, n, m, h, d, kinds, scale, False, True, True)
                 for name, b, n, m, h, d, kinds, scale in bwd_held()]
        cases += [("causal_n_eq_m", 2, 40, 40, 4, 64, [], 0.125, True, True,
                   True),
                  ("causal_n_gt_m", 2, 9, 5, 4, 64, [], 0.125, True, True,
                   True),
                  # several kv tiles under the causal flag: the cast stops
                  # at each q tile's last visible one; rows of n > m that
                  # see no key
                  ("causal_200", 2, 200, 200, 4, 64, [], 0.125, True, True,
                   True),
                  ("causal_200_130", 2, 200, 130, 4, 64, [], 0.125, True,
                   True, True),
                  ("ragged_200", 2, 200, 200, 4, 88, ["rel"], 0.125, False,
                   True, True),
                  ("vit_self_dq_only", 4, 257, 257, 16, 88, [], 88 ** -0.5,
                   False, True, False),
                  ("vit_self_dkv_only", 4, 257, 257, 16, 88, [], 88 ** -0.5,
                   False, False, True)]
        routes = [None] if dtype == torch.float32 else [None, A.MMA]
        for name, b, n, m, h, d, kinds, scale, causal, ndq, ndkv in cases:
            q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, dtype)
            g = grad_like(q)
            out, lse = A.flash_attention(q, k_, v, biases, scale, causal)
            err, s = max_err(out, A.mha_reference(q, k_, v, biases, scale,
                                                  causal))
            if err > tol * s:
                raise AssertionError(f"flash_attention {name} {dtype}: "
                                     f"max_abs_err {err:.3e} (tol "
                                     f"{tol * s:.3e}) at a backward shape")
            want = A.flash_attention_backward_ref(q, k_, v, out, lse, g,
                                                  biases, scale, causal)
            planned = A.plan(n, m, d, bf16=dtype == torch.bfloat16)
            # where the plan is mma.sync already (LLaMA's d = 128), once
            for impl in (routes if planned != A.MMA else [None]):
                route = impl or planned
                before = A.bwd_wgmma_launches
                got = A.flash_attention_backward(
                    q, k_, v, out, lse, g, biases, scale, causal, ndq, ndkv,
                    _impl=impl)
                if (A.bwd_wgmma_launches - before) != (route == A.WGMMA):
                    raise AssertionError(f"flash_attention_bwd {name}: "
                                         f"route {route} not taken")
                errs = [(0.0, 1.0) if x is None else max_err(x, y)
                        for x, y in zip(got, want)]
                if any((x is None) != (not need) for x, need in
                       zip(got, (ndq, ndkv, ndkv))):
                    raise AssertionError(f"flash_attention_bwd {name}: "
                                         "gradients not asked for")
                ok = all(e <= tol * sc for e, sc in errs)
                log(f"  flash_attention_bwd {name:18s} {str(dtype)[6:]:8s} "
                    f"{route:5s} b={b} n={n} m={m} h={h} d={d} "
                    f"biases={kinds} causal={causal} dq={ndq} dkv={ndkv} "
                    f"max_abs_err dq/dk/dv="
                    f"{'/'.join(f'{e:.3e}' for e, _ in errs)} (tol "
                    f"{'/'.join(f'{tol * sc:.3e}' for _, sc in errs)}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash_attention_bwd {name} {dtype} "
                                         f"{route}")
                if impl is None:
                    worst[("flash_attention_bwd_dq", name, dtype)] = \
                        errs[0][0]
                    worst[("flash_attention_bwd_dkv", name, dtype)] = max(
                        errs[1][0], errs[2][0])
    # dq is summed over the kv tiles in one fixed order (a slab a kv tile,
    # added by the cast; no atomics), dk and dv in registers: two identical
    # calls of the planned route are bit-equal at every training shape and
    # at the towers' batch 1 and 16
    for name, b, n, m, h, d, kinds, scale in bwd_held():
        q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, torch.bfloat16)
        g = grad_like(q)
        out, lse = A.flash_attention(q, k_, v, biases, scale)
        one, two = (A.flash_attention_backward(q, k_, v, out, lse, g, biases,
                                               scale) for _ in range(2))
        differ = [int((x != y).sum()) for x, y in zip(one, two)]
        log(f"  flash_attention_bwd {name} two identical calls, route "
            f"{A.plan(n, m, d)}: entries that differ dq/dk/dv "
            f"{'/'.join(map(str, differ))} of {one[0].numel()}/"
            f"{one[1].numel()}/{one[2].numel()} "
            f"{'FAIL' if any(differ) else 'ok'}")
        if any(differ):
            raise AssertionError(f"flash_attention_bwd {name}: two identical "
                                 "calls differ")
    return worst


def check_compressed_kernels(worst):
    """The packed-mask kernel (G = 128, 256) against its plain version and
    bit-equal to the bool kernel; the int8 kernel (no mask, bool, packed
    G = 128, 256) against its plain version and, masked, bit-equal to the
    int8 kernel on codes zeroed off the mask without one; each on the loop
    ``plan`` picks (the decode kernel at every decode shape, the Hopper
    loop at every prefill shape, split-K where the tiles do not fill the
    card); at the compressed path's shapes.  Where the plan splits K, two
    identical calls of each form are bit-equal (the cluster's ordered
    sum)."""
    from vlm_compression_tpu_torch.ops import bitmask as BM
    from vlm_compression_tpu_torch.ops import masked_linear as ML
    from vlm_compression_tpu_torch.ops import quant as Q

    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[-1]
        tol = TOL[dt]
        for name, m, k, n in SERVE_SHAPES + INT8_UNMASKED_SHAPES:
            x, w, mask = mm_inputs(m, k, n, dtype)
            masked = (name, m, k, n) in SERVE_SHAPES
            if masked:
                bool_y = ML.masked_matmul(x, w, mask)
                for group in (128, 256):
                    packed = BM.pack_mask(mask, group)
                    before = loop_counts()
                    got = ML.masked_matmul_packed(x, w, packed)
                    loop = check_loop("masked_matmul_packed", name, m, k, n,
                                      dtype, before)
                    err, scale = max_err(
                        got, ML.masked_matmul_packed_ref(x, w, packed))
                    equal = torch.equal(got, bool_y)
                    ok = err <= tol * scale and equal
                    log(f"  masked_matmul_packed {name:20s} G{group} {dt:8s} "
                        f"M={m} K={k} N={n} {loop:6s} max_abs_err={err:.3e} "
                        f"(tol "
                        f"{tol * scale:.3e}), bit-equal to the bool kernel "
                        f"{equal} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"masked_matmul_packed {name} G{group} {dtype}")
                    worst[("masked_matmul_packed", f"{name} G{group}",
                           dtype)] = err
            q, sc = Q.quantize_weight(w)
            kinds = ((("none", None), ("bool", mask),
                      ("packed128", BM.pack_mask(mask, 128)),
                      ("packed256", BM.pack_mask(mask, 256)))
                     if masked else (("none", None),))
            # the serving form: codes zeroed off the mask, no mask — the
            # same products in the same order as the masked forms
            zeroed = (Q.int8_matmul(x, q.masked_fill(~mask, 0), sc)
                      if masked and dtype == torch.bfloat16 else None)
            for kind, mk in kinds:
                before = loop_counts()
                got = Q.int8_matmul(x, q, sc, mk)
                loop = check_loop("int8_matmul", name, m, k, n, dtype, before,
                                  int8=True)
                err, scale = max_err(got, Q.int8_matmul_ref(x, q, sc, mk))
                equal = True if zeroed is None or mk is None \
                    else torch.equal(got, zeroed)
                ok = err <= tol * scale and equal
                log(f"  int8_matmul {name:20s} {kind:9s} {dt:8s} M={m} K={k} "
                    f"N={n} {loop:6s} max_abs_err={err:.3e} (tol "
                    f"{tol * scale:.3e})"
                    f"{'' if zeroed is None or mk is None else f', bit-equal to zeroed codes without a mask {equal}'}"
                    f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"int8_matmul {name} {kind} {dtype}")
                worst[("int8_matmul", f"{name} {kind}", dtype)] = err
            splits = ML.plan(m, n, k, sm_count())[1]
            if dtype == torch.bfloat16 and splits > 1 \
                    and not name.endswith("_decode"):
                calls = {"int8": lambda: Q.int8_matmul(x, q, sc, kinds[-1][1])}
                if masked:
                    calls.update(
                        bool=lambda: ML.masked_matmul(x, w, mask),
                        packed128=lambda: ML.masked_matmul_packed(
                            x, w, kinds[2][1]))
                for form, call in calls.items():
                    if not torch.equal(call(), call()):
                        raise AssertionError(f"{name} {form}: two identical "
                                             f"split calls differ")
                log(f"  {name} ({splits} splits): two identical calls "
                    f"bit-equal ({', '.join(calls)})")


def check_dbias_kernel(worst):
    """The separate dbias kernel against its plain version, for every bias
    of each case, from the same out and lse; then, in bf16, each bias the
    TMA + wgmma backward returns (``plan_dbias`` FUSED: it keeps the query
    and key dims) from one backward call, with dq, dk, dv and alone: no
    launch of the separate kernel, one fused output counted each, every
    output (dq, dk, dv and each dbias) within the bf16 tolerance of the
    plain version's; two identical calls bit-equal
    at the T5 encoder's batch 16 (summed over the batches in order) and 1
    (stored)."""
    from vlm_compression_tpu_torch.ops import attention as A

    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[-1]
        tol = TOL[dt]
        for name, b, n, m, h, d, kinds, scale, causal in DBIAS_SHAPES:
            q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, dtype)
            g = grad_like(q)
            out, lse = A.flash_attention(q, k_, v, biases, scale, causal)
            errs = []
            for i, bias in enumerate(biases):
                args = (q, k_, v, out, lse, g, biases, i, scale, causal)
                got = A.flash_attention_dbias(*args)
                if got.shape != bias.shape or got.dtype != torch.float32:
                    raise AssertionError(f"dbias {name}: {tuple(got.shape)} "
                                         f"{got.dtype}")
                errs.append(max_err(got, A.flash_attention_dbias_ref(*args)))
            ok = all(e <= tol * sc for e, sc in errs)
            log(f"  flash_attention_bwd_dbias {name:16s} {dt:8s} b={b} n={n} "
                f"m={m} h={h} d={d} biases={kinds} causal={causal} "
                f"max_abs_err={'/'.join(f'{e:.3e}' for e, _ in errs)} (tol "
                f"{'/'.join(f'{tol * sc:.3e}' for _, sc in errs)}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention_bwd_dbias {name} {dtype}")
            worst[("flash_attention_bwd_dbias", name, dtype)] = max(
                e for e, _ in errs)
    tol = TOL["bfloat16"]
    for name, b, n, m, h, d, kinds, scale, causal in DBIAS_SHAPES:
        q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, torch.bfloat16)
        fused = [i for i, x in enumerate(biases) if A.plan_dbias(
            A.plan(n, m, d), x.shape, n, m) == A.FUSED]
        if not fused:
            log(f"  fused dbias {name:16s} none of {kinds} (the separate "
                f"kernel takes them)")
            continue
        g = grad_like(q)
        out, lse = A.flash_attention(q, k_, v, biases, scale, causal)
        want = A.flash_attention_backward_ref(q, k_, v, out, lse, g, biases,
                                              scale, causal, dbias_of=fused)
        for need in (True, False):
            before = A.dbias_launches, A.bwd_dbias_outputs
            got = A.flash_attention_backward(
                q, k_, v, out, lse, g, biases, scale, causal, need, need,
                dbias_of=fused)
            launched = (A.dbias_launches - before[0],
                        A.bwd_dbias_outputs - before[1])
            # every output of the call: dq, dk, dv (where asked for) and
            # each fused dbias
            pairs = [(x, y) for x, y in zip(got, want) if x is not None]
            errs = [max_err(x, y) for x, y in pairs]
            ok = launched == (0, len(fused)) and \
                len(pairs) == len(fused) + 3 * need and all(
                    x.shape == y.shape for x, y in pairs) and all(
                    e <= tol * sc for e, sc in errs)
            log(f"  fused dbias {name:16s} bias {fused} of {kinds}, "
                f"max_abs_err {'dq/dk/dv/' if need else ''}dbias="
                f"{'/'.join(f'{e:.3e}' for e, _ in errs)} (tol "
                f"{'/'.join(f'{tol * sc:.3e}' for _, sc in errs)}); separate "
                f"launches, fused outputs {launched} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"fused dbias {name}")
            if need:
                worst[("fused_dbias", name, torch.bfloat16)] = max(
                    e for e, _ in errs[3:])
        if name in (DBIAS_TIMED, DBIAS_FISHER):
            one, two = (A.flash_attention_backward(
                q, k_, v, out, lse, g, biases, scale, causal,
                dbias_of=fused) for _ in range(2))
            if not all(torch.equal(x, y) for x, y in zip(one, two)):
                raise AssertionError(f"fused dbias {name}: two identical "
                                     "calls differ")
            log(f"  fused dbias {name}: two identical calls bit-equal (dq, "
                f"dk, dv, dbias)")


def tiny_reference_check():
    """Tiny float32 InstructBLIP-T5 with random masks: kernels on the card
    vs plain versions on the CPU, same weights and inputs — with bool
    masks, packed at 2 and 1 bits a weight, then with int8 weights."""
    from vlm_compression_tpu_torch.models.blip2_t5_instruct import (
        Blip2T5Instruct,
        Blip2T5InstructConfig,
    )
    from vlm_compression_tpu_torch.models.bridge import random_init_
    from vlm_compression_tpu_torch.models.eva_vit import EvaViTConfig
    from vlm_compression_tpu_torch.models.layers import SparseLinear
    from vlm_compression_tpu_torch.models.qformer import QFormerConfig
    from vlm_compression_tpu_torch.models.t5 import T5Config
    from vlm_compression_tpu_torch.ops import bitmask as BM
    from vlm_compression_tpu_torch.ops import quant as Q

    f32 = dict(param_dtype="float32", dtype="float32")
    cfg = Blip2T5InstructConfig.tiny(
        vit=EvaViTConfig.tiny(**f32), qformer=QFormerConfig.tiny(
            dtype="float32"), t5=T5Config.tiny(d_model=16, **f32))
    cpu = random_init_(Blip2T5Instruct(cfg, device="cpu"), seed=3, std=0.2)
    g = torch.Generator().manual_seed(3)
    for mod in cpu.modules():
        if isinstance(mod, SparseLinear):
            mod.mask = torch.rand(mod.kernel.shape, generator=g) < 0.6
    batch = dict(
        image=torch.randn(2, 28, 28, 3, generator=g),
        input_ids=torch.randint(2, 96, (2, 5), generator=g),
        attention_mask=torch.tensor([[1, 1, 1, 0, 0], [1] * 5]),
        labels=torch.randint(2, 96, (2, 4), generator=g),
        qformer_input_ids=torch.randint(2, 64, (2, 5), generator=g),
        qformer_attention_mask=torch.ones(2, 5, dtype=torch.int64))
    tiny_vqa_check(cpu, g)
    forms = (("bool masks", None, "masked_matmul"),
             ("packed-128 masks", lambda m: BM.pack_masks_(m, 128),
              "masked_matmul_packed"),
             ("packed-256 masks", lambda m: BM.pack_masks_(m, 256),
              "masked_matmul_packed"),
             ("int8 weights, packed-256 masks", Q.quantize_model_int8_,
              "int8_matmul"))
    for label, transform, kernel in forms:
        if transform is not None:
            transform(cpu)
        gpu = copy.deepcopy(cpu).to("cuda")
        reset_counts()
        with torch.no_grad():
            want = cpu(**batch)["logits"]
            got = gpu(**{k: v.cuda() for k, v in batch.items()})["logits"]
        launched = read_counts()[kernel]
        err = float((got.cpu() - want).abs().max())
        log(f"  tiny fp32 InstructBLIP-T5 ({label}) logits, card vs CPU: "
            f"max_abs_err={err:.3e} (tol 1e-4), {kernel} launches "
            f"{launched}")
        if not (err <= 1e-4 and bool(torch.isfinite(got).all())
                and launched > 0):
            raise AssertionError(f"tiny reference check ({label})")
        del gpu


def tiny_vqa_check(cpu, g):
    """The VQA task's ``valid_step`` on the tiny float32 model with bool
    masks: on the card (kernels) vs on the CPU (plain versions), in
    generate mode (beam 2) and rank mode — answers equal — and the rank
    mode's NLL matrix within 1e-4."""
    from vlm_compression_tpu_torch.datasets.tokenization import batch_labels
    from vlm_compression_tpu_torch.models.blip2_t5_instruct import (
        predict_class_t5,
    )
    from vlm_compression_tpu_torch.tasks.vqa import VQATask

    cfg = cpu.cfg
    gpu = copy.deepcopy(cpu).to("cuda")
    toks = vqa_tokenizers(cfg)
    img = cfg.vit.img_size
    samples = {"image": torch.randn(4, img, img, 3, generator=g),
               "text_input": ["what is the man holding", "how many dogs",
                              "what color is the sky", "is there a cat"],
               "question_id": list(range(4))}
    gen = VQATask(num_beams=2, max_len=4, prompt=VQA_PROMPT, **toks)
    rank = VQATask(max_len=4, prompt=VQA_PROMPT, **toks)
    rank.answer_list = ["yes", "no", "two dogs", "red", "a man", "left"]
    reset_counts()
    with torch.no_grad():
        for label, task in (("generate, beam 2", gen), ("rank", rank)):
            want = task.valid_step(cpu, samples)
            got = task.valid_step(gpu, samples)
            log(f"  tiny fp32 VQATask valid_step ({label}), card vs CPU: "
                f"answers {[r['answer'] for r in got]}, equal "
                f"{got == want}")
            if got != want:
                raise AssertionError(f"tiny VQA check ({label})")
        labels = torch.from_numpy(batch_labels(toks["tokenizer"],
                                               rank.answer_list, 4))
        nll = [predict_class_t5(m, *enc[:3], labels, *enc[3:])
               for m, enc in ((cpu, rank._encode(cpu, samples)),
                              (gpu, rank._encode(gpu, samples)))]
    err = float((nll[1].cpu() - nll[0]).abs().max())
    launched = read_counts()
    log(f"  tiny fp32 predict_class_t5 NLLs {tuple(nll[0].shape)}, card vs "
        f"CPU: max_abs_err={err:.3e} (tol 1e-4); masked_matmul launches "
        f"{launched['masked_matmul']}, flash_attention "
        f"{launched['flash_attention']}")
    if not (err <= 1e-4 and launched["masked_matmul"] > 0
            and launched["flash_attention"] > 0):
        raise AssertionError("tiny VQA check (NLLs)")
    del gpu


def tiny_train_check():
    """One KD train step of a tiny float32 InstructBLIP-T5 with SparseLoRA
    (ranks 4/2/8, random masks, seeded non-zero lora_b): kernels on the
    card vs plain versions on the CPU.  Base weights are drawn at std 0.02:
    at std 0.2 this small model amplifies one-ulp rounding of its weights
    into ~1e-3 of its gradients, which no fixed limit on the card's
    rounding can tell from a wrong gradient.  Limits:
      - loss, CE, KL within 1e-4;
      - the whole LoRA gradient (all leaves as one vector) within 1e-4 of
        its norm, and each leaf within 1e-3 of its own norm (a leaf that is
        zero or of the wrong sign gives 1 or 2);
      - the AdamW update at lr 1e-3, which moves an entry by ~lr·sign(g):
        within 2.1·lr everywhere, and within 1e-3·lr where |g| is above
        1e-3 of its leaf's largest entry, so that a zero or flipped
        gradient there (an error of lr or 2·lr) fails."""
    from vlm_compression_tpu_torch.models.blip2_t5_instruct import (
        Blip2T5Instruct,
        Blip2T5InstructConfig,
    )
    from vlm_compression_tpu_torch.models.bridge import random_init_
    from vlm_compression_tpu_torch.models.eva_vit import EvaViTConfig
    from vlm_compression_tpu_torch.models.layers import SparseLinear
    from vlm_compression_tpu_torch.models.qformer import QFormerConfig
    from vlm_compression_tpu_torch.models.t5 import T5Config
    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.ops import masked_linear as ML
    from vlm_compression_tpu_torch.tasks.retrain import (
        RessaTrainState,
        make_kd_train_step,
    )

    lr = 1e-3
    f32 = dict(param_dtype="float32", dtype="float32")
    cfg = Blip2T5InstructConfig.tiny(
        vit=EvaViTConfig.tiny(lora_rank=4, **f32),
        qformer=QFormerConfig.tiny(lora_rank=2, dtype="float32"),
        t5=T5Config.tiny(d_model=16, lora_rank=8, **f32))
    cpu = random_init_(Blip2T5Instruct(cfg, device="cpu"), seed=5, std=0.02)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for mod in cpu.modules():
            if isinstance(mod, SparseLinear):
                mod.mask = torch.rand(mod.kernel.shape, generator=g) < 0.6
                if mod.lora_rank:
                    mod.lora_b.normal_(0.0, 0.3, generator=g)
    gpu = Blip2T5Instruct(cfg, device="cuda")
    for a, b in zip(cpu.modules(), gpu.modules()):
        if isinstance(a, SparseLinear):
            b.mask = a.mask.cuda()
    gpu.load_state_dict(cpu.state_dict())
    batch = dict(
        image=torch.randn(2, 28, 28, 3, generator=g),
        input_ids=torch.randint(2, 96, (2, 5), generator=g),
        attention_mask=torch.tensor([[1, 1, 1, 0, 0], [1] * 5]),
        labels=torch.randint(2, 96, (2, 4), generator=g),
        qformer_input_ids=torch.randint(2, 64, (2, 5), generator=g),
        qformer_attention_mask=torch.ones(2, 5, dtype=torch.int64))

    def kd_step(model):
        state = RessaTrainState.create(model, weight_decay=WEIGHT_DECAY)
        dev = model.device
        met = make_kd_train_step(model, state.opt, KL_WEIGHT, T_KD)(
            {k: v.to(dev) for k, v in batch.items()}, lr)
        return ({k: float(v) for k, v in met.items()},
                {n: (p.grad.cpu(), p.detach().cpu())
                 for n, p in state.lora.items()})

    (mc, lc), (mg, lg) = kd_step(cpu), kd_step(gpu)
    err_m = max(abs(mg[k] - mc[k]) for k in mc)
    want = torch.cat([gr.flatten() for gr, _ in lc.values()])
    got = torch.cat([lg[n][0].flatten() for n in lc])
    err_g = float((got - want).norm() / want.norm())
    err_leaf = max(float((lg[n][0] - gr).norm()) / float(gr.norm())
                   for n, (gr, _) in lc.items() if bool(gr.any()))
    err_p = err_big = 0.0
    for n, (gr, p) in lc.items():
        diff = (lg[n][1] - p).abs()
        err_p = max(err_p, float(diff.max()))
        big = gr.abs() > 1e-3 * gr.abs().max()
        err_big = max(err_big, float(diff[big].max()) if bool(big.any())
                      else float(diff.max()))
    log(f"  tiny fp32 KD step, card vs CPU: loss/ce/kl max_abs_err="
        f"{err_m:.3e} (tol 1e-4); LoRA gradient |Δg|/|g| whole "
        f"{err_g:.3e} (tol 1e-4), worst leaf {err_leaf:.3e} (tol 1e-3); "
        f"AdamW update at lr {lr:g}: max_abs_err {err_p:.3e} (tol "
        f"{2.1 * lr:.1e}), where |g| > 1e-3 of its leaf's max "
        f"{err_big:.3e} (tol {1e-3 * lr:.1e}); kl {mc['kl']:.3e}; launches "
        f"sparse_lora {ML.lora_launches}, bwd dq {A.dq_launches}, bwd dkv "
        f"{A.dkv_launches}")
    if not (err_m <= 1e-4 and err_g <= 1e-4 and err_leaf <= 1e-3
            and err_p <= 2.1 * lr and err_big <= 1e-3 * lr and mc["kl"] > 0
            and all(torch.isfinite(torch.tensor(list(mg.values()))))):
        raise AssertionError("tiny KD step, card vs CPU")


def tiny_gradient_scoring_check():
    """The gradient-scoring slice on a tiny float32 InstructBLIP-T5 (std
    0.02, as the KD check): kernels on the card vs plain versions on the
    CPU, same weights and inputs.  get_data_derivative (power 2, three
    batch-1 samples) over every leaf: within 1e-3 of the leaf's largest
    entry (entries of leaves whose gradient is 0 in exact arithmetic —
    the Q-Former's key biases — within 1e-9 of the largest of all), the
    dbias kernel launched once per T5 self-attention and sample, both
    rel_embeddings scored; the aobd_sum block allocation: every ratio
    equal; ``blipt5_wanda_pruner`` with that allocation: masks
    bit-equal."""
    from vlm_compression_tpu_torch.compression import load_pruner
    from vlm_compression_tpu_torch.compression.allocator import LayerSparsity
    from vlm_compression_tpu_torch.compression.derivatives import (
        get_data_derivative,
    )
    from vlm_compression_tpu_torch.models.blip2_t5_instruct import (
        Blip2T5Instruct,
        Blip2T5InstructConfig,
    )
    from vlm_compression_tpu_torch.models.bridge import (
        export_masks,
        random_init_,
    )
    from vlm_compression_tpu_torch.models.eva_vit import EvaViTConfig
    from vlm_compression_tpu_torch.models.qformer import QFormerConfig
    from vlm_compression_tpu_torch.models.t5 import T5Config

    f32 = dict(param_dtype="float32", dtype="float32")
    cfg = Blip2T5InstructConfig.tiny(
        vit=EvaViTConfig.tiny(**f32), qformer=QFormerConfig.tiny(
            dtype="float32"), t5=T5Config.tiny(d_model=16, **f32))
    cpu = random_init_(Blip2T5Instruct(cfg, device="cpu"), seed=9, std=0.02)
    gpu = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(9)

    def batch(b):
        return dict(
            image=torch.randn(b, 28, 28, 3, generator=g),
            input_ids=torch.randint(2, 96, (b, 5), generator=g),
            attention_mask=torch.ones(b, 5, dtype=torch.int64),
            labels=torch.randint(2, 96, (b, 4), generator=g),
            qformer_input_ids=torch.randint(2, 64, (b, 5), generator=g),
            qformer_attention_mask=torch.ones(b, 5, dtype=torch.int64))

    def on_card(batches):
        return [{k: v.cuda() for k, v in b.items()} for b in batches]

    samples, calib = [batch(1) for _ in range(3)], [batch(4), batch(4)]
    want = get_data_derivative(cpu, samples)
    reset_counts()
    got = get_data_derivative(gpu, on_card(samples))
    launched = read_counts()["flash_attention_bwd_dbias"]
    top = max(float(w.abs().max()) for w in want.values())
    err = max(float((got[p].cpu() - w).abs().max())
              / max(float(w.abs().max()), 1e-6 * top)
              for p, w in want.items())
    rel = [bool(got[("t5_model", s, "rel_bias", "rel_embedding")].gt(0)
                .any()) for s in ("encoder", "decoder")]
    log(f"  tiny fp32 get_data_derivative (power 2, 3 samples), card vs CPU: "
        f"{len(want)} leaves, worst max_abs_err / leaf max {err:.3e} (tol "
        f"1e-3); dbias launches {launched} (3 samples x 4 T5 "
        f"self-attentions); rel_embedding scored (encoder, decoder) {rel}")
    if not (set(got) == set(want) and err <= 1e-3 and launched == 12
            and all(rel)):
        raise AssertionError("tiny get_data_derivative, card vs CPU")

    kw = dict(original_sparsity=0.5, granularity="block",
              score_method="aobd_sum", num_data=8,
              prefixes=("visual_encoder", "t5_model"))
    r_cpu = LayerSparsity(cpu, calib, **kw).return_sparsity()
    r_gpu = LayerSparsity(gpu, on_card(calib), **kw).return_sparsity()
    differ = sorted(k for k in r_cpu if r_cpu[k] != r_gpu.get(k))
    log(f"  tiny fp32 aobd_sum block allocation, card vs CPU: "
        f"{len(set(r_cpu.values()))} distinct ratios over {len(r_cpu)} "
        f"linears, {len(differ)} differ")
    if set(r_cpu) != set(r_gpu) or differ:
        raise AssertionError(f"tiny allocation, card vs CPU: {differ[:4]}")

    spec = dict(vit_prune_spec="2-0.5-1.0-1.0", t5_prune_spec="2-0.5-1.0-1.0",
                num_samples=8, num_data_first_stage=8, **FIRST_ORDER)
    with torch.no_grad():
        load_pruner("blipt5_wanda_pruner", cpu, calib,
                    **spec).prune(lora_model=True)
        load_pruner("blipt5_wanda_pruner", gpu, on_card(calib),
                    **spec).prune(lora_model=True)
    mc, mg = export_masks(cpu), export_masks(gpu)
    flips = sum(int((mc[p] != mg[p]).sum()) for p in mc)
    log(f"  tiny fp32 blipt5_wanda_pruner (block, aobd_sum), card vs CPU: "
        f"{len(mc)} masks, {flips} bits differ")
    if set(mc) != set(mg) or len(mc) != 2 * 4 + 2 * 7 + 2 * 11 or flips:
        raise AssertionError("tiny first-order Wanda masks, card vs CPU")


N_CALIB, BS, TXT, LBL, N_REQ = 128, 16, 40, 12, 4
# the EcoFLaP first-order grid (scripts/t5/ecoflap_first.sh,
# scripts/launch_lib.py:24,58-66): a block-granular allocation scored by
# aobd_sum on num_data_first_stage = 32 samples, max_sparsity_per_layer 0.8
# (the cli/evaluate.py:48-50 defaults), then Wanda at the allocated ratios
FIRST_ORDER = dict(sparsity_ratio_granularity="block", score_method="aobd_sum")
# diagonal-Fisher samples (evaluate_woodfisher.py --get_derivative_info:
# batch 1); 8, not 16, to keep the run near 12 minutes
N_FISHER = 8


def sparsegpt_check():
    """SparseGPT from the same fp32 inputs on the card and on the CPU, at
    the T5-XL wo shape (2048 units × 5120 inputs; Hessian of 8192 random
    tokens): the share of mask bits that differ and the weights' largest
    difference; then one batched group — the T5 decoder's eight 2048 × 2048
    attention linears — against its members pruned one by one (wall-clock,
    synchronised, two readings each, interleaved)."""
    from vlm_compression_tpu_torch.ops import sparsegpt as SG

    g = torch.Generator(device="cuda").manual_seed(3)
    units, cols, n = 2048, 5120, 8192
    x = torch.randn(n, cols, generator=g, device="cuda")
    h = (2.0 / n) * (x.t() @ x)
    w = torch.randn(units, cols, generator=g, device="cuda") * cols ** -0.5
    del x
    t0 = time.perf_counter()
    card = SG.sparsegpt_prune(w, h, 0.5)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = SG.sparsegpt_prune(w.cpu(), h.cpu(), 0.5)
    t_cpu = time.perf_counter() - t0
    cpu_flips = int((card.keep_mask.cpu() != cpu.keep_mask).sum())
    dens = (float(card.keep_mask.float().mean()),
            float(cpu.keep_mask.float().mean()))
    werr = float((card.weight.cpu() - cpu.weight).abs().max()
                 / cpu.weight.abs().max())
    log(f"  sparsegpt {units} x {cols}, card vs CPU: {cpu_flips} of "
        f"{units * cols} mask bits differ "
        f"({cpu_flips / (units * cols):.2e}); "
        f"density {dens[0]:.5f} / {dens[1]:.5f}; max |dW| / max |W| "
        f"{werr:.2e}; {t_card:.2f} s card, {t_cpu:.2f} s CPU")
    if not (bool(torch.isfinite(card.weight).all())
            and all(abs(d - 0.5) <= 0.01 for d in dens)
            and cpu_flips <= 0.01 * units * cols):
        raise AssertionError("sparsegpt: card and CPU disagree")
    del card, cpu, w, h

    group, d = 8, 2048
    x = torch.randn(group, 4096, d, generator=g, device="cuda")
    hs = (2.0 / 4096) * (x.transpose(1, 2) @ x)
    ws = torch.randn(group, d, d, generator=g, device="cuda") * d ** -0.5
    del x

    def batched():
        return SG.sparsegpt_prune_batched(ws, hs, 0.5)

    def one_by_one():
        return [SG.sparsegpt_prune(ws[i], hs[i], 0.5) for i in range(group)]

    reads = {"batched": [], "one_by_one": []}
    outs = {}
    for name in ("batched", "one_by_one", "one_by_one", "batched",
                 "batched", "one_by_one"):
        t0 = time.perf_counter()
        outs[name] = (batched if name == "batched" else one_by_one)()
        torch.cuda.synchronize()
        reads[name].append(time.perf_counter() - t0)
    # the first reading of each pays one-time costs (cuSOLVER handles,
    # allocator growth)
    t_b, t_s = (statistics.mean(reads[k][1:]) for k in ("batched",
                                                        "one_by_one"))
    group_flips = sum(int((outs["batched"].keep_mask[i]
                     != outs["one_by_one"][i].keep_mask).sum())
                for i in range(group))
    log(f"  sparsegpt group of {group} x ({d} x {d}): batched {t_b:.3f} s, "
        f"one by one {t_s:.3f} s ({t_s / t_b:.2f}x); readings "
        f"{json.dumps({k: [round(v, 4) for v in r] for k, r in reads.items()})}"
        f"; mask bits differing between the two {group_flips}")
    return {"sparsegpt_card_vs_cpu_flips": cpu_flips,
            "sparsegpt_group8_batched_s": t_b,
            "sparsegpt_group8_one_by_one_s": t_s}


def tiny_grid_pruners_check():
    """The launcher grid's other pruners on a tiny float32 InstructBLIP-T5
    (std 0.02, biases drawn too, so the Hessians the sparsegpt initial
    metric factors are regular, as in the CPU parity tests): the same
    weights and batches on the card and on the CPU, every keep-mask
    bit-equal — ``t5_`` / ``vit_wanda_pruner`` on the bare towers,
    ``{t5,vit,blipt5}_dsnot_pruner`` (unstructured and 2:4, the wanda and
    sparsegpt initial metrics), ``blipt5_{mag,absmag,aobd,mezo}_pruner``
    (mezo under the global threshold, its z from numpy through
    ``noise_fn``); ``rand``: each layer's density, and two runs on the
    card from one seed bit-equal."""
    import numpy as np

    from vlm_compression_tpu_torch.compression import load_pruner
    from vlm_compression_tpu_torch.models.blip2_t5_instruct import (
        Blip2T5Instruct,
        Blip2T5InstructConfig,
    )
    from vlm_compression_tpu_torch.models.bridge import (
        export_masks,
        random_init_,
    )
    from vlm_compression_tpu_torch.models.eva_vit import EvaViTConfig
    from vlm_compression_tpu_torch.models.qformer import QFormerConfig
    from vlm_compression_tpu_torch.models.t5 import T5Config

    f32 = dict(param_dtype="float32", dtype="float32")
    cfg = Blip2T5InstructConfig.tiny(
        vit=EvaViTConfig.tiny(**f32), qformer=QFormerConfig.tiny(
            dtype="float32"), t5=T5Config.tiny(d_model=16, **f32))
    cpu = random_init_(Blip2T5Instruct(cfg, device="cpu"), seed=10, std=0.02)
    g = torch.Generator().manual_seed(10)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.rsplit(".", 1)[-1] == "bias":
                p.normal_(0.0, 0.02, generator=g)

    def batch(b):
        return dict(
            image=torch.randn(b, 28, 28, 3, generator=g),
            input_ids=torch.randint(2, 96, (b, 5), generator=g),
            attention_mask=torch.ones(b, 5, dtype=torch.int64),
            labels=torch.randint(2, 96, (b, 4), generator=g),
            qformer_input_ids=torch.randint(2, 64, (b, 5), generator=g),
            qformer_attention_mask=torch.ones(b, 5, dtype=torch.int64))

    calib = [batch(4), batch(4)]
    noise, nrng = {}, np.random.default_rng(10)

    def noise_fn(tag, key, shape):
        # drawn on the first run, replayed on the second
        if (tag, key) not in noise:
            noise[(tag, key)] = nrng.standard_normal(shape).astype(
                np.float32)
        return noise[(tag, key)]

    towers = {
        "t5": (lambda m: m.t5_model, ("input_ids", "attention_mask",
                                      "labels")),
        "vit": (lambda m: m.visual_encoder, ("image",)),
        "blipt5": (lambda m: m, tuple(calib[0]))}
    spec = dict(vit_prune_spec="2-0.5-1.0-1.0", t5_prune_spec="2-0.5-1.0-1.0",
                num_samples=8)
    # a low update threshold keeps DSnoT cycling at this model's scale
    ds = dict(update_threshold=1e-4)
    nm = dict(prune_n=2, prune_m=4)
    sg = dict(initial_method="sparsegpt")
    cases = [("t5_wanda_pruner", {}), ("vit_wanda_pruner", {}),
             ("t5_dsnot_pruner", ds), ("t5_dsnot_pruner", {**ds, **nm, **sg}),
             ("vit_dsnot_pruner", {**ds, **nm}),
             ("vit_dsnot_pruner", {**ds, **sg}),
             ("blipt5_dsnot_pruner", ds), ("blipt5_dsnot_pruner", {**ds, **nm}),
             ("blipt5_dsnot_pruner", {**ds, **sg}),
             ("blipt5_dsnot_pruner", {**ds, **nm, **sg}),
             ("blipt5_mag_pruner", {}),
             ("blipt5_mag_pruner", dict(is_global=True)),
             ("blipt5_absmag_pruner", {}), ("blipt5_aobd_pruner", {}),
             ("blipt5_mezo_pruner", dict(is_global=True, noise_fn=noise_fn,
                                         noise_eps=5e-2, num_samples=4))]

    def prune(name, model, batches, **kw):
        get, fields = towers[name.split("_")[0]]
        tower = get(model)
        with torch.no_grad():
            load_pruner(name, tower, [{k: b[k] for k in fields}
                                      for b in batches],
                        **{**spec, **kw}).prune(lora_model=True)
        return export_masks(tower)

    on_card = [{k: v.cuda() for k, v in b.items()} for b in calib]
    for name, kw in cases:
        mc = prune(name, copy.deepcopy(cpu), calib, **kw)
        mg = prune(name, copy.deepcopy(cpu).to("cuda"), on_card, **kw)
        flips = sum(int((mc[p] != mg[p]).sum()) for p in mc)
        dens = sum(int(m.sum()) for m in mc.values()) / sum(
            m.size for m in mc.values())
        knobs = {k: v for k, v in kw.items() if k != "noise_fn"}
        log(f"  tiny fp32 {name} {json.dumps(knobs)}, card vs CPU: "
            f"{len(mc)} masks, density {dens:.4f}, {flips} bits differ")
        if not mc or set(mc) != set(mg) or flips:
            raise AssertionError(f"tiny {name} {knobs}, card vs CPU")

    runs = [prune("blipt5_rand_pruner", copy.deepcopy(cpu).to("cuda"),
                  on_card, seed=5) for _ in range(2)]
    same = all(np.array_equal(runs[0][p], runs[1][p]) for p in runs[0])
    exact = all(int(m.sum()) == m.size - int(0.5 * m.size)
                for m in runs[0].values())
    log(f"  tiny fp32 blipt5_rand_pruner (seed 5) on the card: "
        f"{len(runs[0])} masks, each layer at 0.5: {exact}; two runs "
        f"bit-equal: {same}")
    if not (len(runs[0]) == 2 * 4 + 2 * 7 + 2 * 11 and exact and same):
        raise AssertionError("tiny rand pruner on the card")


def dsnot_xl_check():
    """DSnoT from the same fp32 inputs on the card and on the CPU at the
    T5-XL wo shape (2048 units × 5120 inputs) and at LLaMA-7B's down
    projection (4096 units × 11008 inputs: the Vicuna DSnoT entry's
    widest linear), statistics of 8192 random tokens with a mean per
    column, folded on the card; unstructured at 0.5 and 2:4, the grid's
    other knobs at their defaults: the mask entries that differ (at most
    1e-4 of them: the only source of a difference is the reduction order
    of the row error) and the cycles (equal)."""
    from vlm_compression_tpu_torch.ops.dsnot import dsnot_refine_mask
    from vlm_compression_tpu_torch.ops.stats import (
        init_calib_stats,
        update_calib_stats,
    )

    g = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for shape, units, cols in (("xl", 2048, 5120),
                               ("llama_down", 4096, 11008)):
        n = 8192
        x = torch.randn(n, cols, generator=g, device="cuda") \
            + 0.5 * torch.randn(cols, generator=g, device="cuda")
        s = update_calib_stats(init_calib_stats(cols, device="cuda"),
                               x[None])
        del x
        w = torch.randn(units, cols, generator=g, device="cuda") \
            * cols ** -0.5
        args = (w, s.scaler_row, s.sum_metric_row, s.var)
        for label, kw in (("unstructured", {}),
                          ("2:4", dict(prune_n=2, prune_m=4))):
            t0 = time.perf_counter()
            card = dsnot_refine_mask(*args, 0.5, **kw)
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = dsnot_refine_mask(*(a.cpu() for a in args), 0.5, **kw)
            t_cpu = time.perf_counter() - t0
            flips = int((card.keep_mask.cpu() != cpu.keep_mask).sum())
            log(f"  dsnot {label} {units} x {cols}, card vs CPU: {flips} of "
                f"{units * cols} mask entries differ; cycles {card.cycles} "
                f"/ {cpu.cycles}; density "
                f"{float(card.keep_mask.float().mean()):.5f}; {t_card:.3f} s "
                f"card, {t_cpu:.2f} s CPU")
            if flips > 1e-4 * units * cols or card.cycles != cpu.cycles:
                raise AssertionError(f"dsnot {label} {units} x {cols}: card "
                                     "and CPU disagree")
            out[f"dsnot_{shape}_{label}_flips"] = flips
            out[f"dsnot_{shape}_{label}_card_s"] = t_card
        del w, args, s
    return out

@contextlib.contextmanager
def dsnot_tally():
    """While the block runs, DSnoT's refinement is synchronised and timed
    around each call, and its cycles are kept per linear: yields
    {"cycles": [...], "s": seconds}."""
    from vlm_compression_tpu_torch.compression.pruners import methods as PM

    refine, tally = PM.dsnot_refine_mask, {"cycles": [], "s": 0.0}

    def timed_refine(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = refine(*a, **kw)
        torch.cuda.synchronize()
        tally["s"] += time.perf_counter() - t0
        tally["cycles"].append(res.cycles)
        return res

    PM.dsnot_refine_mask = timed_refine
    try:
        yield tally
    finally:
        PM.dsnot_refine_mask = refine


def log_dsnot_tally(tally, prune_s: float, n_linears: int,
                    prefix: str = "dsnot") -> dict:
    """The cycle histogram, host syncs (one a cycle, one a linear) and the
    refinement's share of the prune; fails unless every prunable linear
    was refined once."""
    cycles = tally["cycles"]
    hist = {c: cycles.count(c) for c in sorted(set(cycles))}
    log(f"  {prefix} refinement: {len(cycles)} linears, cycles {hist} "
        f"(cycle: linears), {sum(cycles)} cycles and about "
        f"{sum(cycles) + len(cycles)} host syncs in all; {tally['s']:.3f} s "
        f"of the prune's {prune_s:.3f} s "
        f"({100 * tally['s'] / prune_s:.1f} %)")
    if len(cycles) != n_linears:
        raise AssertionError(f"{prefix} refined {len(cycles)} linears, not "
                             f"{n_linears}")
    return {f"{prefix}_refine_s": tally["s"], f"{prefix}_cycles": sum(cycles),
            f"{prefix}_host_syncs": sum(cycles) + len(cycles)}


def synthetic_batches(cfg, n: int, bs: int, g: torch.Generator):
    """n seeded batches of bench.py:189-191's shapes (224² images, text 40,
    labels 12) with bs samples each."""
    img = cfg.vit.img_size

    def ids(shape):
        return torch.randint(3, 2000, shape, generator=g, device="cuda")

    def ones(b):
        return torch.ones(b, TXT, dtype=torch.int32, device="cuda")

    return [dict(image=torch.randn(bs, img, img, 3, generator=g,
                                   device="cuda"),
                 input_ids=ids((bs, TXT)), attention_mask=ones(bs),
                 labels=ids((bs, LBL)), qformer_input_ids=ids((bs, TXT)),
                 qformer_attention_mask=ones(bs)) for _ in range(n)]


def xl_setup(seed: int, lora: bool = True, depth: tuple = None):
    """Full-width InstructBLIP-FlanT5-XL with seeded random bf16 weights on
    the card (base weights drawn as without adapters; with ``lora``, LoRA A
    he-uniform, B zero), the synthetic calibration batches of
    bench.py:189-191 (bs 16, text 40, labels 12) and N_REQ generate
    requests.  ``depth`` = (ViT, T5 encoder, T5 decoder blocks) cuts the
    depth (every width kept); None keeps the config's 39/24/24."""
    from vlm_compression_tpu_torch.models.blip2_t5_instruct import (
        Blip2T5Instruct,
    )
    from vlm_compression_tpu_torch.models.bridge import random_init_
    from vlm_compression_tpu_torch.models.factory import (
        build_model,
        build_model_config,
    )

    model_cfg = dict(model_type="flant5xl", **(LORA if lora else {}))
    if depth is None:
        model = build_model(model_cfg, seed=seed)
    else:
        # build_model's own steps, on the config cut to ``depth``
        vit, enc, dec = depth
        _, cfg = build_model_config(model_cfg)
        cfg = dataclasses.replace(
            cfg, vit=dataclasses.replace(cfg.vit, depth=vit),
            t5=dataclasses.replace(cfg.t5, num_layers=enc,
                                   num_decoder_layers=dec))
        model = random_init_(Blip2T5Instruct(cfg), seed=seed)
    cfg = model.cfg
    img = cfg.vit.img_size
    g = torch.Generator(device="cuda").manual_seed(42 + seed)

    def ids(shape):
        return torch.randint(3, 2000, shape, generator=g, device="cuda")

    def ones(b):
        return torch.ones(b, TXT, dtype=torch.int32, device="cuda")

    batches = synthetic_batches(cfg, N_CALIB // BS, BS, g)
    req = dict(image=torch.randn(N_REQ, img, img, 3, generator=g,
                                 device="cuda"),
               input_ids=ids((N_REQ, TXT)), attention_mask=ones(N_REQ),
               qformer_input_ids=ids((N_REQ, TXT)),
               qformer_attention_mask=ones(N_REQ))
    req["attention_mask"][1, -7:] = 0           # one shorter prompt
    torch.cuda.synchronize()
    return cfg, model, batches, req


def run_prune(model, batches, name="blipt5_wanda_pruner", **kw):
    """→ (the pruned model, the allocated ratios or None)."""
    from vlm_compression_tpu_torch.compression import load_pruner

    # the launcher's specs (scripts/launch_lib.py:55-56), their block counts
    # the model's
    cfg = model.cfg
    pruner = load_pruner(name, model, batches,
                         vit_prune_spec=f"{cfg.vit.depth}-0.5-1.0-1.0",
                         t5_prune_spec=f"{cfg.t5.num_layers}-0.5-1.0-1.0",
                         num_samples=N_CALIB, **kw)
    out = pruner.prune(lora_model=True)
    torch.cuda.synchronize()
    return out


def run_generate(model, req):
    """Beam 5, max_length 10, min_length 1: the GQA zero-shot eval settings
    (configs/projects/eval/gqa_zeroshot_flant5xl_instruct_eval.yaml)."""
    from vlm_compression_tpu_torch.models.blip2_t5_instruct import generate_t5
    from vlm_compression_tpu_torch.models.generation import GenerationConfig

    gen_cfg = GenerationConfig(num_beams=5, max_length=10, min_length=1,
                               eos_token_id=1, pad_token_id=0,
                               decoder_start_token_id=0)
    seqs = generate_t5(model, req["image"], req["input_ids"],
                       req["attention_mask"], req["qformer_input_ids"],
                       req["qformer_attention_mask"], gen_cfg=gen_cfg)
    torch.cuda.synchronize()
    return seqs.cpu(), gen_cfg


KERNELS = ("masked_matmul", "flash_attention", "sparse_lora_matmul",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "masked_matmul_packed", "int8_matmul", "flash_attention_bwd_dbias",
           "matmul_decode")
# the kernels each phase of the main path runs, and so must launch;
# "wgmma_loop" counts the masked, packed, sparse-LoRA and int8 launches
# that ran the Hopper loop (calibration, training and the generate
# prefill: every shape above decode-sized M that TMA takes, split-K where
# the output tiles do not fill the card); "wmma_loop" those that ran the
# WMMA loop (what TMA cannot take), which no generate phase and no retrain
# step may make, and "wmma_calls" their shapes and why
WGMMA_LOOP = "wgmma_loop"
WMMA_LOOP = "wmma_loop"
WMMA_CALLS = "wmma_calls"
# "bwd_wgmma" counts the attention backward's TMA + wgmma launches (each
# one whole backward: pre-pass, main kernel, dq cast); the
# flash_attention_bwd_dq / _dkv counts are the mma.sync route's
BWD_WGMMA = "bwd_wgmma"
# "fwd_wgmma" counts the attention forward's TMA + wgmma launches; the
# flash_attention count is every forward's, on either route
FWD_WGMMA = "fwd_wgmma"
# "fwd_mma_or_fp32" counts the forwards on the other routes (the bf16
# mma.sync kernel, which takes LLaMA's d = 128, and the fp32 one)
FWD_MMA = "fwd_mma_or_fp32"
# "bwd_dbias_outputs" counts the bias gradients the TMA + wgmma backward
# returned (each an output of one of its launches); the
# flash_attention_bwd_dbias count is the separate dbias kernel's launches
BWD_DBIAS = "bwd_dbias_outputs"
# "matmul_decode" counts the decode kernel's launches (the bool, packed and
# int8 matmuls at decode-sized M)
DECODE = "matmul_decode"
PRUNE = ("masked_matmul", "flash_attention", WGMMA_LOOP)
SERVE = PRUNE + (DECODE,)
PHASE_KERNELS = {"prune": PRUNE + (FWD_WGMMA,), "generate_cold": SERVE,
                 "generate_warm": SERVE,
                 "retrain": ("sparse_lora_matmul", "flash_attention",
                             FWD_WGMMA, BWD_WGMMA, WGMMA_LOOP),
                 "generate_merged": SERVE,
                 "sparsegpt_prune": PRUNE, "generate_bool": SERVE,
                 "generate_packed128": ("masked_matmul_packed",
                                        "flash_attention", WGMMA_LOOP,
                                        DECODE),
                 "generate_packed256": ("masked_matmul_packed",
                                        "flash_attention", WGMMA_LOOP,
                                        DECODE),
                 "generate_int8_cold": ("int8_matmul", "flash_attention",
                                        WGMMA_LOOP, DECODE),
                 "generate_int8_warm": ("int8_matmul", "flash_attention",
                                        WGMMA_LOOP, DECODE),
                 "generate_int8_serving": ("int8_matmul", "flash_attention",
                                           WGMMA_LOOP, DECODE),
                 # the allocation's backward (dq, dk/dv), then Wanda
                 "ecoflap_prune": ("masked_matmul", "flash_attention",
                                   FWD_WGMMA, BWD_WGMMA, WGMMA_LOOP),
                 "generate_ecoflap_cold": SERVE,
                 "generate_ecoflap_warm": SERVE,
                 "fisher_derivative": ("flash_attention", FWD_WGMMA,
                                       BWD_WGMMA, BWD_DBIAS),
                 # zeroed weights, no masks: dense products (no masked or
                 # int8 linear, so no decode launch either)
                 "generate_fisher": ("flash_attention",)}
# the VQA eval of the merged model at batch 64 × 5 beams: every masked
# linear has M > 64 (the beam-decode steps' M = 320 included), so the
# Hopper loop must run and the decode kernel need not; the TMA + wgmma
# attention forward must run (the rank phase's decoder self-attention at
# n = m = L over b · C rows too)
VQA = ("masked_matmul", "flash_attention", FWD_WGMMA, WGMMA_LOOP)
PHASE_KERNELS.update(vqa_gqa=VQA, vqa_okvqa=VQA, vqa_rank=VQA,
                     caption_nocaps=VQA)
# ... and the kernels a phase must not run: a packed or int8 model never
# takes the bool-mask path, an int8 model never the bf16 packed one (its
# prefill runs the Hopper loop, its decode steps the decode kernel)
INT8_FORBIDDEN = ("masked_matmul", "masked_matmul_packed")
PHASE_FORBIDDEN = {
    "generate_packed128": ("masked_matmul", "int8_matmul"),
    "generate_packed256": ("masked_matmul", "int8_matmul"),
    "generate_int8_cold": INT8_FORBIDDEN,
    "generate_int8_warm": INT8_FORBIDDEN,
    "generate_int8_serving": INT8_FORBIDDEN,
    # RESSA and the first-order allocation differentiate no attention bias
    # (only LoRA factors; only the prunable kernels); the retrain step's
    # sparse-LoRA launches all run the Hopper loop; the Fisher's position
    # bias gradients all come from the TMA + wgmma backward
    "retrain": ("flash_attention_bwd_dbias", BWD_DBIAS, WMMA_LOOP),
    "ecoflap_prune": ("flash_attention_bwd_dbias", BWD_DBIAS),
    "fisher_derivative": ("flash_attention_bwd_dbias",)}
# the grid path: DSnoT sweeps as Wanda does (its refinement runs no kernel
# of the port); the magnitude and random pruners score with no forward at
# all; aobd differentiates the prunable kernels only (dense products, the
# attention backward on TMA + wgmma, no bias gradient); the zeroth entry
# scores with dense forwards and no backward, then sweeps as Wanda does
SCORE_ONLY = ("masked_matmul", "flash_attention")
BACKWARD = (BWD_WGMMA, "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
            "flash_attention_bwd_dbias", BWD_DBIAS)
PHASE_KERNELS.update(
    dsnot_prune=PRUNE + (FWD_WGMMA,), generate_dsnot=SERVE, mag_prune=(),
    rand_prune=(), mag_global=(),
    aobd_prune=("flash_attention", FWD_WGMMA, BWD_WGMMA),
    zeroth_prune=PRUNE + (FWD_WGMMA,), generate_zeroth=SERVE)
# the Vicuna path: the ViT and Q-Former forwards on TMA + wgmma, LLaMA's
# (d = 128) on mma.sync; no backward, and no WMMA-loop launch in any of
# its phases (the prune included)
VICUNA_GEN = SERVE + (FWD_WGMMA, FWD_MMA)
VICUNA_VQA = VQA + (FWD_MMA,)
PHASE_KERNELS.update(
    vicuna_prune=PRUNE + (FWD_WGMMA, FWD_MMA),
    generate_vicuna_cold=VICUNA_GEN, generate_vicuna_warm=VICUNA_GEN,
    vqa_vicuna_gqa=VICUNA_VQA, vqa_vicuna_okvqa=VICUNA_VQA)
PHASE_FORBIDDEN.update(vicuna_prune=BACKWARD + (WMMA_LOOP,))
# the Vicuna retrain: sparse-LoRA on the Hopper loop (ViT r 4, LLaMA r 8),
# the ViT's and Q-Former's attention forward and backward on TMA + wgmma,
# LLaMA's (d = 128) on the mma.sync kernels; no bias takes a gradient (no
# dbias output, no separate dbias kernel) and nothing runs the WMMA loop;
# then the merged model's generate
PHASE_KERNELS.update(
    vicuna_retrain=("sparse_lora_matmul", "flash_attention", FWD_WGMMA,
                    FWD_MMA, BWD_WGMMA, "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv", WGMMA_LOOP),
    generate_vicuna_merged=VICUNA_GEN)
PHASE_FORBIDDEN.update(vicuna_retrain=("flash_attention_bwd_dbias",
                                       BWD_DBIAS, WMMA_LOOP))
# the Vicuna grid's DSnoT entry sweeps as the Wanda prune does (its
# refinement runs no kernel of the port); then the generate
PHASE_KERNELS.update(vicuna_dsnot_prune=PRUNE + (FWD_WGMMA, FWD_MMA),
                     generate_vicuna_dsnot=VICUNA_GEN)
PHASE_FORBIDDEN.update(vicuna_dsnot_prune=BACKWARD + (WMMA_LOOP,))
# the retrieval path: the stage-1 model's ViT prune, then the eval passes
# (the pruned ViT's masked matmuls on the Hopper loop, every attention on
# TMA + wgmma; the Q-Former holds no mask, so its text-only branch runs
# attention alone); no backward and no WMMA-loop launch anywhere
RETRIEVAL = ("masked_matmul", "flash_attention", FWD_WGMMA, WGMMA_LOOP)
PHASE_KERNELS.update(retrieval_prune=PRUNE + (FWD_WGMMA,),
                     retrieval_cold=RETRIEVAL, retrieval_warm=RETRIEVAL,
                     retrieval_itc=RETRIEVAL, retrieval_direct=RETRIEVAL,
                     retrieval_images=RETRIEVAL,
                     retrieval_captions=("flash_attention", FWD_WGMMA))
for _phase in ("retrieval_prune", "retrieval_cold", "retrieval_warm",
               "retrieval_itc", "retrieval_direct", "retrieval_images",
               "retrieval_captions"):
    PHASE_FORBIDDEN[_phase] = BACKWARD + (WMMA_LOOP,)
PHASE_FORBIDDEN.update(
    dsnot_prune=BACKWARD, mag_prune=SCORE_ONLY, rand_prune=SCORE_ONLY,
    mag_global=SCORE_ONLY,
    aobd_prune=("flash_attention_bwd_dbias", BWD_DBIAS, "masked_matmul",
                WMMA_LOOP),
    zeroth_prune=BACKWARD)
# the CLI path: prune(lora_model=False) zeroes the weights and keeps no
# mask, so every linear of both calls and of the direct generates is a
# plain product (no matmul kernel of the port); attention on TMA + wgmma;
# no backward
CLI_PHASES = ("cli_prune", "cli_truth", "cli_eval", "cli_direct")
for _phase in CLI_PHASES:
    PHASE_KERNELS[_phase] = ("flash_attention", FWD_WGMMA)
    PHASE_FORBIDDEN[_phase] = BACKWARD + (
        "masked_matmul", "masked_matmul_packed", "int8_matmul",
        "sparse_lora_matmul", DECODE, WGMMA_LOOP, WMMA_LOOP)
# every generate phase runs its prefill on the Hopper loop and its decode
# steps on the decode kernel, every VQA and caption phase all its matmuls
# on the Hopper loop: no WMMA-loop launch at all
for _phase in PHASE_KERNELS:
    if _phase.startswith(("generate", "vqa", "caption")):
        PHASE_FORBIDDEN[_phase] = PHASE_FORBIDDEN.get(_phase, ()) + (
            WMMA_LOOP,)


def reset_counts():
    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.ops import masked_linear as ML
    from vlm_compression_tpu_torch.ops import quant as Q

    ML.launches = ML.lora_launches = ML.packed_launches = 0
    ML.wgmma_launches = ML.decode_launches = ML.wmma_launches = 0
    ML.wmma_calls.clear()
    ML.shape_launches.clear()
    ML.lora_shape_launches.clear()
    A.shape_launches.clear()
    A.bwd_shape_launches.clear()
    A.launches = A.dq_launches = A.dkv_launches = A.dbias_launches = 0
    A.fwd_wgmma_launches = A.bwd_wgmma_launches = A.bwd_dbias_outputs = 0
    Q.int8_launches = 0


def read_counts() -> dict:
    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.ops import masked_linear as ML
    from vlm_compression_tpu_torch.ops import quant as Q

    counts = dict(zip(KERNELS + (WGMMA_LOOP, FWD_WGMMA, BWD_WGMMA, WMMA_LOOP,
                                 BWD_DBIAS),
                      (ML.launches, A.launches, ML.lora_launches,
                       A.dq_launches, A.dkv_launches, ML.packed_launches,
                       Q.int8_launches, A.dbias_launches, ML.decode_launches,
                       ML.wgmma_launches, A.fwd_wgmma_launches,
                       A.bwd_wgmma_launches, ML.wmma_launches,
                       A.bwd_dbias_outputs)))
    counts[FWD_MMA] = counts["flash_attention"] - counts[FWD_WGMMA]
    counts[WMMA_CALLS] = [f"M={m} N={n} K={k} rank {r}: {why} x{c}"
                          for (m, n, k, r, why), c in ML.wmma_calls.items()]
    return counts


def read_shapes() -> dict:
    """The launches since ``reset_counts`` by shape: masked, packed,
    sparse-LoRA and int8 matmuls by (M, N, K, loop), the sparse-LoRA ones
    alone by (M, N, K, rank), attention forwards and backwards by (b, n,
    m, h, d, route)."""
    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    return {"matmul": dict(ML.shape_launches),
            "lora": dict(ML.lora_shape_launches),
            "attention": dict(A.shape_launches),
            "attention_bwd": dict(A.bwd_shape_launches)}


def attn_routes(c: dict, per: int = 1) -> str:
    """A phase's attention launches by route (per step or sample)."""
    return (f"forward: TMA + wgmma {c[FWD_WGMMA] / per:g}, mma.sync or fp32 "
            f"{(c['flash_attention'] - c[FWD_WGMMA]) / per:g}; backward: "
            f"TMA + wgmma {c[BWD_WGMMA] / per:g}, mma.sync dq "
            f"{c['flash_attention_bwd_dq'] / per:g} and dk/dv "
            f"{c['flash_attention_bwd_dkv'] / per:g}; bias gradients: TMA + "
            f"wgmma outputs {c[BWD_DBIAS] / per:g}, separate dbias kernel "
            f"{c['flash_attention_bwd_dbias'] / per:g}")


def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def expected_loop(m, k, n, dtype, rank=0, int8=False) -> str:
    """The main loop ``plan`` gives a fresh, contiguous (so aligned)
    operand set of this shape (``int8``: the int8 kernel's)."""
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    return ML.plan(m, n, k, sm_count(), bf16=dtype == torch.bfloat16,
                   rank=rank, int8=int8)[0]


def loop_counts() -> tuple:
    """(Hopper-loop, decode-kernel) launches so far."""
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    return ML.wgmma_launches, ML.decode_launches


def check_loop(what, name, m, k, n, dtype, before, rank=0,
               int8=False) -> str:
    """The launch just made (``before``: ``loop_counts()`` ahead of it) ran
    the loop ``plan`` picks: one Hopper-loop launch counted exactly when
    that is the Hopper loop, one decode-kernel launch exactly when that is
    the decode kernel; at a bf16 decode shape always the decode kernel,
    never the Hopper loop."""
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    loop = expected_loop(m, k, n, dtype, rank, int8)
    wg, dec = (a - b for a, b in zip(loop_counts(), before))
    decode_shape = name.endswith("_decode") and dtype == torch.bfloat16
    if wg != (loop == ML.WGMMA) or dec != (loop == ML.DECODE) \
            or (decode_shape and (wg or not dec)):
        raise AssertionError(f"{what} {name} {dtype}: {wg} Hopper-loop and "
                             f"{dec} decode-kernel launches, plan {loop}")
    return loop


def run_phase(rec: dict, phase: str, fn):
    """``fn()`` as one phase: the launch counts reset before it and read
    after, by kernel (``rec["counts"]``) and by shape
    (``rec["shapes"]``), its synchronised wall-clock (``rec["secs"]``)
    and peak memory (``rec["peaks"]``).  Returns what ``fn`` returns."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    rec["secs"][phase] = time.perf_counter() - t0
    rec["counts"][phase] = read_counts()
    rec["shapes"][phase] = read_shapes()
    rec["peaks"][phase] = torch.cuda.max_memory_allocated()
    return out


def new_record() -> dict:
    return {"counts": {}, "shapes": {}, "secs": {}, "peaks": {}}


def check_phase_counts(counts):
    """Each phase's kernels launched, none it must not run; the WMMA-loop
    launches left in a phase, printed with their shapes and why the other
    loops refused them."""
    for phase, c in counts.items():
        if c[WMMA_CALLS]:
            log(f"  WMMA loop in {phase}: {'; '.join(c[WMMA_CALLS])}")
        for kernel in PHASE_KERNELS[phase]:
            if c[kernel] <= 0:
                raise AssertionError(f"{kernel} never launched in {phase}")
        for kernel in PHASE_FORBIDDEN.get(phase, ()):
            if c[kernel] != 0:
                raise AssertionError(f"{kernel} launched in {phase}")


def check_generate(seqs, gen_cfg, cfg):
    if tuple(seqs.shape) != (N_REQ, gen_cfg.max_length) or \
            not bool((seqs[:, 0] == 0).all()) or \
            not bool(((seqs >= 0) & (seqs < cfg.t5.vocab_size)).all()):
        raise AssertionError(f"bad generate output {seqs}")
    return int((seqs[:, 1:] != gen_cfg.pad_token_id).sum())


def tower_density(model, of_kernels: bool = False,
                  towers=("visual_encoder", "t5_model.encoder",
                          "t5_model.decoder")) -> dict:
    """Kept share per pruned tower: of the masks, or (of_kernels) of the
    non-zero kernel entries of every masked linear."""
    from vlm_compression_tpu_torch.models.layers import SparseLinear

    out = {}
    for tower in towers:
        kept = total = n = 0
        for name, m in model.named_modules():
            if isinstance(m, SparseLinear) and m.mask is not None \
                    and name.startswith(tower):
                kept += int((m.kernel if of_kernels else m.bool_mask())
                            .count_nonzero())
                total += m.kernel.numel()
                n += 1
        out[tower] = (kept / total, n)
    return out


def run_retrain(model, batches, prefix="retrain"):
    """RESSA retraining at batch TRAIN_BS: 1 cold + N_TIMED_STEPS timed KD
    steps on ``batches`` (fresh ones); every step's loss, CE and KL finite;
    B = 0 makes the first step's lora_a gradients exactly 0 and its lora_b
    gradients non-zero, the second step's lora_a gradients non-zero; base
    parameters and masks bit-identical afterwards.  Then the first
    N_REPLAY steps again from the saved starting state (the LoRA factors
    and a fresh AdamW): every LoRA leaf bit-equal to the first run's after
    as many steps (the run reproduces; the model keeps the replay's
    factors)."""
    from vlm_compression_tpu_torch.common.optims import make_lr_scheduler
    from vlm_compression_tpu_torch.tasks.retrain import (
        RessaTrainState,
        make_kd_train_step,
    )

    before = {n: t.detach().cpu() for n, t in
              list(model.named_parameters()) + list(model.named_buffers())
              if n.rsplit(".", 1)[-1] not in ("lora_a", "lora_b")}
    state = RessaTrainState.create(model, weight_decay=WEIGHT_DECAY)
    sched = make_lr_scheduler(SCHED)
    step = make_kd_train_step(model, state.opt, KL_WEIGHT, T_KD)
    n_lora = len(state.lora) // 2
    saved = {n: p.detach().clone() for n, p in state.lora.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i, batch in enumerate(batches):
        lr = sched(0, i)
        t0 = time.perf_counter()
        met = step(batch, lr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        met = {k: float(v) for k, v in met.items()}
        nz = {leaf: sum(int(bool(p.grad.count_nonzero()))
                        for n, p in state.lora.items() if n.endswith(leaf))
              for leaf in ("lora_a", "lora_b")}
        log(f"  {prefix} step {i} ({'cold' if i == 0 else 'timed'}) lr "
            f"{lr:.4e}: {times[-1]:.3f} s, loss {met['loss']:.5f} ce "
            f"{met['ce']:.5f} kl {met['kl']:.6f}; linears with non-zero "
            f"grads: lora_a {nz['lora_a']}/{n_lora}, lora_b "
            f"{nz['lora_b']}/{n_lora}")
        if not all(v == v and abs(v) != float("inf") for v in met.values()):
            raise AssertionError(f"non-finite retrain metrics {met}")
        # every adapter but the last Q-Former layer's text FFN (whose
        # output leaves no trace in the loss) gets a gradient
        if (i == 0 and (nz["lora_a"] != 0 or nz["lora_b"] < n_lora - 2)) \
                or (i == 1 and nz["lora_a"] < n_lora - 2):
            raise AssertionError(f"step {i}: gradients {nz} of {n_lora}")
        if i + 1 == N_REPLAY:
            first = {n: p.detach().clone() for n, p in state.lora.items()}
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        for n, p in state.lora.items():
            p.copy_(saved[n])
    state.opt.zero_grad(set_to_none=True)
    state.opt.state.clear()
    for i in range(N_REPLAY):
        step(batches[i], sched(0, i))
    torch.cuda.synchronize()
    differ = {n: int((p != first[n]).sum()) for n, p in state.lora.items()
              if not torch.equal(p, first[n])}
    log(f"  {prefix} replay: {N_REPLAY} KD steps again from the saved "
        f"starting state: {len(differ)} of {len(first)} LoRA leaves differ "
        f"from the first run's ({sum(differ.values())} entries) "
        f"{'FAIL' if differ else 'ok'}")
    if differ:
        raise AssertionError(f"retrain does not reproduce: "
                             f"{sorted(differ)[:4]}")
    state.opt.zero_grad(set_to_none=True)
    state.opt.state.clear()
    changed = [n for n, t in
               list(model.named_parameters()) + list(model.named_buffers())
               if n in before and not torch.equal(t.detach().cpu(), before[n])]
    if changed:
        raise AssertionError(f"retraining changed frozen tensors {changed[:4]}")
    s_step = statistics.mean(times[1:])
    log(f"  {prefix} (tune_opt=LVQ r 4/8/2, batch {TRAIN_BS}, no gradient "
        f"accumulation, no remat): {s_step:.3f} s/step over "
        f"{N_TIMED_STEPS} timed steps, {TRAIN_BS / s_step:.1f} samples/s, "
        f"cold step {times[0]:.3f} s, peak {peak / 2**30:.2f} GiB; "
        f"{len(before)} frozen tensors bit-identical")
    return {f"{prefix}_cold_s": times[0], f"{prefix}_s_per_step": s_step,
            f"{prefix}_samples_per_s": TRAIN_BS / s_step,
            f"{prefix}_peak_bytes": peak}


def merge_and_check(model, towers=("visual_encoder", "t5_model.encoder",
                                   "t5_model.decoder")):
    """Sparse merge + re-masking; every merged kernel 0 where its mask is
    0, and each of ``towers``' kept share still 0.5 ± 0.01."""
    from vlm_compression_tpu_torch.models.layers import SparseLinear
    from vlm_compression_tpu_torch.tasks.retrain import (
        apply_masks_to_params,
        merge_lora_into_params,
    )

    t0 = time.perf_counter()
    apply_masks_to_params(merge_lora_into_params(model, sparse=True))
    torch.cuda.synchronize()
    t_merge = time.perf_counter() - t0
    bad = [n for n, m in model.named_modules()
           if isinstance(m, SparseLinear) and m.mask is not None
           and bool((m.kernel.ne(0) & ~m.mask).any())]
    if bad:
        raise AssertionError(f"merged kernels non-zero off their masks {bad[:4]}")
    for tower, (dens, n) in tower_density(model, of_kernels=True,
                                          towers=towers).items():
        log(f"  merged density {tower}: {dens:.4f} non-zero over {n} linears")
        if abs(dens - 0.5) > 0.01:
            raise AssertionError(f"merged density {tower}")
    log(f"  merge_lora_into_params(sparse=True) + apply_masks_to_params: "
        f"{t_merge:.2f} s")


# zero-shot VQA on the merged model at the eval yamls' run settings:
# configs/projects/eval/gqa_zeroshot_flant5xl_instruct_eval.yaml:13-26
# (batch_size_eval 64, seed 42, beam 5, max_len 10, min_len 1, the
# prompt); okvqa_zeroshot_flant5xl_instruct_eval.yaml:14-27 runs the same
# settings, and sets model.apply_lemmatizer: true (:4).  The synthetic
# batch is drawn from the yamls' run seed
VQA_PROMPT = "Question: {} Short answer:"
VQA_RUN = dict(batch_size_eval=64, seed=42, num_beams=5, max_len=10,
               min_len=1, prompt=VQA_PROMPT)
XL_EVAL_MODEL = dict(arch="blip2_t5_instruct", model_type="flant5xl")
OKVQA_MODEL = dict(XL_EVAL_MODEL, apply_lemmatizer=True)
# ranking: the batch's 64 questions, each over N_CANDS distinct seeded
# candidates of 1-3 words — the ranking eval's traffic in
# configs/projects/blip/eval/vqav2_eval.yaml:18,23-24 (batch_size_eval 64,
# num_ans_candidates 128, inference_method rank); the InstructBLIP-T5 eval
# yamls generate
N_CANDS = 128
# a ground truth no answer can match: SimpleTokenizer answers decode to
# "<id> <id> ...", which normalize to digits
NEVER = "never produced"
VQA_WORDS = dict(
    ask=["what color is the", "how many", "what is the", "where is the",
         "is there a", "which side of the", "what is on the"],
    noun=["dog", "man", "car", "table", "sky", "bus", "woman", "horse",
          "plate", "tree", "boat", "cat", "shirt", "window"],
    rel=["near the", "on the", "behind the", "under the", "in the",
         "next to the"],
    answer=["red", "blue", "two", "three", "left", "right", "yes", "no",
            "wood", "grass", "snow", "kitchen", "street", "water"])


def vqa_questions(n: int, seed: int = VQA_RUN["seed"]) -> list:
    """n seeded synthetic questions, as a VQA annotation holds them."""
    rng = random.Random(seed)
    w = VQA_WORDS
    return [f"{rng.choice(w['ask'])} {rng.choice(w['noun'])} "
            f"{rng.choice(w['rel'])} {rng.choice(w['noun'])}?"
            for _ in range(n)]


def vqa_samples(cfg, n: int, seed: int = VQA_RUN["seed"]) -> dict:
    """One collated eval batch of n synthetic questions (cleaned by the
    yamls' ``blip_question`` text processor) on seeded 224² images."""
    from vlm_compression_tpu_torch.datasets.processors import (
        BlipQuestionProcessor,
    )

    questions = list(map(BlipQuestionProcessor(), vqa_questions(n, seed)))
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = cfg.vit.img_size
    return {"image": torch.randn(n, img, img, 3, generator=g, device="cuda"),
            "text_input": questions, "question_id": list(range(n)),
            "instance_id": list(range(n))}


def vqa_tokenizers(cfg) -> dict:
    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
    )

    return dict(tokenizer=SimpleTokenizer(cfg.t5.vocab_size),
                qformer_tokenizer=SimpleTokenizer(cfg.qformer.vocab_size))


def vqa_closed_form(k: int) -> float:
    """VQAv2 accuracy of an answer that k of the 10 annotators gave."""
    return (k * min(1.0, (k - 1) / 3) + (10 - k) * min(1.0, k / 3)) / 10


def decode_step_routes(tally: dict, m: int) -> dict:
    """The launches at M = m (the beam-decode steps: requests × beams) by
    (N, K) and loop, beside the loop and splits ``plan`` gives the shape;
    ``tally``: ``read_shapes()["matmul"]``."""
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    rows = {}
    for (mm, n, k, route), c in sorted(tally.items()):
        if mm != m:
            continue
        loop, splits, _ = ML.plan(m, n, k, sm_count())
        row = rows.setdefault(f"N={n} K={k}", {"plan": f"{loop} x{splits}"})
        row[route] = row.get(route, 0) + c
    return rows


def check_shapes(shapes: dict, what: str):
    """Every shape the phases launched (``shapes``: phase →
    ``read_shapes()``) is one that phase 3 held against its plain version:
    the masked, packed and int8 matmuls' (MM_SHAPES; SERVE_SHAPES, where
    the bool kernel is held bit-equal to the packed one and that to its
    plain version), the sparse-LoRA matmul's with its rank (LORA_SHAPES),
    the attention forward's (FLASH_SHAPES, VICUNA_FLASH_SHAPES and the
    backward's shapes) and the attention backward's (``bwd_held``)."""
    held_bwd = {tuple(c[1:6]) for c in bwd_held()}
    mm = {(m, k, n) for _, m, k, n in MM_SHAPES + SERVE_SHAPES}
    lora = {(m, k, n, r) for _, m, k, n, r in LORA_SHAPES}
    fl = {tuple(c[1:6]) for c in FLASH_SHAPES + VICUNA_FLASH_SHAPES} \
        | held_bwd
    # a matmul launch that is not a sparse-LoRA one is the masked, packed
    # or int8 kernel's
    plain_mm = {}
    for s in shapes.values():
        for (m, n, k, _), c in s["matmul"].items():
            plain_mm[(m, k, n)] = plain_mm.get((m, k, n), 0) + c
        for (m, n, k, _), c in s["lora"].items():
            plain_mm[(m, k, n)] -= c
    seen_mm = {key for key, c in plain_mm.items() if c}
    seen_lora = {(m, k, n, r) for s in shapes.values()
                 for m, n, k, r in s["lora"]}
    seen_fl = {c[:5] for s in shapes.values() for c in s["attention"]}
    seen_bwd = {c[:5] for s in shapes.values() for c in s["attention_bwd"]}
    missing = [f"matmul M={m} K={k} N={n}"
               for m, k, n in sorted(seen_mm - mm)]
    missing += [f"sparse_lora_matmul M={m} K={k} N={n} r={r}"
                for m, k, n, r in sorted(seen_lora - lora)]
    missing += [f"attention b={b} n={n} m={m} h={h} d={d}"
                for b, n, m, h, d in sorted(seen_fl - fl)]
    missing += [f"attention backward b={b} n={n} m={m} h={h} d={d}"
                for b, n, m, h, d in sorted(seen_bwd - held_bwd)]
    log(f"  {what} shapes: {len(seen_mm)} masked-linear, {len(seen_lora)} "
        f"sparse-LoRA, {len(seen_fl)} attention and {len(seen_bwd)} "
        f"attention-backward shapes launched, {len(missing)} not checked "
        f"in phase 3")
    if missing:
        raise AssertionError(f"{what} shapes never held against the plain "
                             f"version: {missing}")


def direct_vqa_answers(model, samples) -> tuple:
    """A direct ``generate_t5`` over a collated VQA batch (images as an
    array or a tensor) at the eval yamls' settings, encoded and decoded by
    hand as the task does: (answers, token rows)."""
    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
        batch_encode,
    )
    from vlm_compression_tpu_torch.models.blip2_t5_instruct import (
        generate_t5,
    )
    from vlm_compression_tpu_torch.models.generation import GenerationConfig

    dev = next(model.parameters()).device
    tok = SimpleTokenizer(model.cfg.t5.vocab_size)
    qtok = SimpleTokenizer(model.cfg.qformer.vocab_size)
    prompts = [VQA_PROMPT.format(q) for q in samples["text_input"]]
    enc = [torch.from_numpy(a).to(dev) for a in (
        *batch_encode(tok, prompts, 128), *batch_encode(qtok, prompts, 128))]
    image = torch.as_tensor(samples["image"], device=dev)
    seqs = generate_t5(model, image, *enc, gen_cfg=GenerationConfig(
        num_beams=VQA_RUN["num_beams"], max_length=VQA_RUN["max_len"] + 1,
        min_length=VQA_RUN["min_len"])).cpu()
    out = []
    for row in seqs[:, 1:].tolist():
        row = row[:row.index(tok.eos_token_id)] \
            if tok.eos_token_id in row else row
        out.append(tok.decode(row).strip())
    return out, seqs


def vqa_path(model, cfg):
    """The zero-shot VQA evaluation of the merged model through the tasks'
    entry points (``setup_task``, ``evaluation`` → ``valid_step``,
    ``after_evaluation``), at the eval batch and the yamls' settings, no
    cut: GQA generate twice (cold; warm with a ground truth that is each
    even question's own cold answer and unreachable for the odd ones:
    exactly 50.00), OK-VQA generate with the lemmatizer (question i's own
    answer in i % 11 of its 10 slots: the closed form of the VQAv2
    accuracy), then ranking the batch over N_CANDS candidates, in more
    than one chunk.  Between the counted phases: the generate answers
    against the decoded tokens of a direct ``generate_t5`` call, the rank
    answers against the argmin of a direct ``predict_class_t5``.  Then
    every shape the phases launched must be one phase 3 checked, and one
    GQA pass runs under torch.profiler.  Returns (launch counts by phase,
    numbers)."""
    from torch.profiler import ProfilerActivity, profile

    from vlm_compression_tpu_torch.datasets.tokenization import batch_labels
    from vlm_compression_tpu_torch.evaluation.lemmatize import lemmatize
    from vlm_compression_tpu_torch.models import blip2_t5_instruct as BT
    from vlm_compression_tpu_torch.tasks.vqa import GQATask, VQATask

    n = VQA_RUN["batch_size_eval"]
    beams = VQA_RUN["num_beams"]
    samples = vqa_samples(cfg, n)
    toks = vqa_tokenizers(cfg)
    tok = toks["tokenizer"]
    counts, shapes, secs, peaks = {}, {}, {}, {}

    def start():
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    def end(phase):
        counts[phase] = read_counts()
        shapes[phase] = read_shapes()
        peaks[phase] = torch.cuda.max_memory_allocated()

    def answers_of(records):
        return [r["answer"] for r in records]

    tmp = tempfile.TemporaryDirectory(prefix="vqa_results_")
    try:
        # --- GQA: cold, then warm with the ground truth; one phase
        gqa = GQATask.setup_task(dict(run=VQA_RUN, model=XL_EVAL_MODEL),
                                 **toks)
        start()
        cold = timed("vqa_gqa_cold", lambda: gqa.evaluation(model, [samples]))
        answers = answers_of(cold)
        scored = dict(samples, answers=[
            [a] if i % 2 == 0 else [NEVER] for i, a in enumerate(answers)])
        warm = timed("vqa_gqa_warm", lambda: gqa.evaluation(model, [scored]))
        end("vqa_gqa")
        if answers_of(warm) != answers:
            raise AssertionError("GQA: the warm pass answered otherwise")
        gqa_metrics = gqa.after_evaluation(
            warm, split_name="val",
            result_dir=os.path.join(tmp.name, "gqa", "result"))
        n_empty = sum(a == "" for a in answers)
        log(f"  vqa gqa: {n} questions, beam {beams}, max_len "
            f"{VQA_RUN['max_len']}: cold {secs['vqa_gqa_cold']:.3f} s, warm "
            f"{secs['vqa_gqa_warm']:.3f} s "
            f"({n / secs['vqa_gqa_warm']:.1f} questions/s),"
            f" peak {peaks['vqa_gqa'] / 2**30:.2f} GiB; answers equal cold "
            f"vs warm; {n_empty} empty; metrics {json.dumps(gqa_metrics)}; "
            f"e.g. {json.dumps(dict(zip(samples['text_input'][:3], answers)))}")
        if gqa_metrics["acc"] != 50.0 or gqa_metrics["agg_metrics"] != 50.0:
            raise AssertionError(f"GQA accuracy {gqa_metrics}, not 50.00")
        tally = shapes["vqa_gqa"]["matmul"]
        step_rows = decode_step_routes(tally, n * beams)
        at_m = {route: sum(c for (m, _, _, r), c in tally.items()
                           if m == n * beams and r == route)
                for route in ("decode", "wgmma", "wmma", "fp32")}
        log(f"  vqa gqa, the M = {n * beams} beam-decode steps' matmul "
            f"launches by loop (both passes): {json.dumps(at_m)}; by shape, "
            f"beside plan's loop and splits: {json.dumps(step_rows)}")

        # --- the task adds no drift: a direct generate_t5 on the same
        # encoded inputs, decoded by hand
        direct, seqs = direct_vqa_answers(model, samples)
        if tuple(seqs.shape) != (n, VQA_RUN["max_len"] + 1) \
                or direct != answers:
            raise AssertionError("the GQA task's answers differ from a "
                                 "direct generate_t5's decoded tokens")

        # --- OK-VQA: lemmatized answers, k = i % 11 of 10 slots
        okvqa = VQATask.setup_task(dict(run=VQA_RUN, model=OKVQA_MODEL),
                                   **toks)
        lemmas = lemmatize(answers)
        ks = [i % 11 for i in range(n)]
        scored = dict(samples, answers=[[a] * k + [NEVER] * (10 - k)
                                        for a, k in zip(lemmas, ks)])
        start()
        ok = timed("vqa_okvqa", lambda: okvqa.evaluation(model, [scored]))
        end("vqa_okvqa")
        ok_metrics = okvqa.after_evaluation(
            ok, split_name="test",
            result_dir=os.path.join(tmp.name, "okvqa", "result"))
        want = round(100 * sum(map(vqa_closed_form, ks)) / n, 2)
        log(f"  vqa okvqa (apply_lemmatizer={okvqa.apply_lemmatizer}): "
            f"{secs['vqa_okvqa']:.3f} s, peak "
            f"{peaks['vqa_okvqa'] / 2**30:.2f} GiB; metrics "
            f"{json.dumps(ok_metrics)}, closed form {want}")
        if not okvqa.apply_lemmatizer or answers_of(ok) != lemmas \
                or ok_metrics["overall"] != want:
            raise AssertionError(f"OK-VQA {ok_metrics} against {want}")

        # --- ranking the batch over N_CANDS distinct candidates
        rng = random.Random(VQA_RUN["seed"] + 1)
        vocab = VQA_WORDS["answer"] + VQA_WORDS["noun"]
        cands = []
        while len(cands) < N_CANDS:
            c = " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3)))
            if c not in cands:
                cands.append(c)
        ranker = VQATask.setup_task(dict(run=VQA_RUN, model=XL_EVAL_MODEL),
                                    **toks)
        ranker.answer_list = cands
        labels = torch.from_numpy(batch_labels(tok, cands, ranker.max_len))
        per_chunk = max(1, BT._LOGIT_BYTES // (
            n * labels.shape[1] * cfg.t5.vocab_size * 4))
        chunks = -(-N_CANDS // per_chunk)
        if chunks < 2:
            raise AssertionError("the ranking runs predict_class_t5 in one "
                                 "chunk: its chunk loop goes untested")
        start()
        ranked = timed("vqa_rank", lambda: ranker.evaluation(model,
                                                             [samples]))
        end("vqa_rank")
        image, ids, mask, q_ids, q_mask = ranker._encode(model, samples)
        nll = BT.predict_class_t5(model, image, ids, mask, labels, q_ids,
                                  q_mask)
        finite = float(torch.isfinite(nll).float().mean())
        best = [cands[i] for i in nll.argmin(-1).tolist()]
        log(f"  vqa rank: {n} questions x {N_CANDS} candidates "
            f"(labels {tuple(labels.shape)}; {chunks} chunks of "
            f"{per_chunk} candidates, {n * per_chunk * labels.shape[1]} "
            f"decoder rows each): {secs['vqa_rank']:.3f} s, peak "
            f"{peaks['vqa_rank'] / 2**30:.2f} GiB; answers "
            f"{answers_of(ranked)[:8]}...; NLL matrix {tuple(nll.shape)} "
            f"finite share {finite}, range [{float(nll.min()):.4f}, "
            f"{float(nll.max()):.4f}]")
        if any(a not in cands for a in answers_of(ranked)) or finite != 1.0 \
                or best != answers_of(ranked):
            raise AssertionError("VQA ranking")
    finally:
        tmp.cleanup()
    check_shapes(shapes, "vqa")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gqa.evaluation(model, [samples])
        torch.cuda.synchronize()
    device_breakdown(prof, 1e3 * secs["vqa_gqa_warm"],
                     f"vqa gqa, {n} questions, beam {beams}")
    return counts, {
        "vqa_gqa_cold_s": secs["vqa_gqa_cold"],
        "vqa_gqa_warm_s": secs["vqa_gqa_warm"],
        "vqa_gqa_acc": gqa_metrics["acc"],
        "vqa_okvqa_s": secs["vqa_okvqa"],
        "vqa_okvqa_acc": ok_metrics["overall"],
        "vqa_rank_s": secs["vqa_rank"],
        "vqa_peak_bytes": max(peaks.values()),
        "vqa_decode_step_launches": at_m}


# NoCaps / COCO captioning of the merged model at the eval yamls' run
# settings: configs/projects/eval/nocaps_flant5xl_instruct_eval.yaml:13-24
# (task captioning, batch_size_eval 64, seed 42, beam 5, max_len 30,
# min_len 8; the task's default prompt "a photo of");
# caption_coco_flant5xl_instruct_eval.yaml runs the same settings on its
# test split, so one pass stands for both.  The images are drawn from the
# run seed
CAPTION_RUN = dict(task="captioning", batch_size_eval=64, seed=42,
                   num_beams=5, max_len=30, min_len=8)
CAPTION_METRICS_ONE = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L")


def caption_path(model, cfg):
    """One NoCaps pass of the merged model through the captioning task's
    entry points (``setup_task``, ``evaluation`` → ``valid_step``,
    ``after_evaluation``), at the eval batch and the yaml's settings, no
    cut: cold, then warm (captions equal); the captions equal to the
    decoded tokens of a direct ``generate_t5`` call; no EOS before
    position min_len (the start token at 0: at least min_len − 1 caption
    tokens, EOS forbidden for the first steps and allowed after); with
    each image's references set to its own caption, BLEU-1..4 and ROUGE-L
    exactly 1 (the host-only caption metrics); once more with EOS the top
    logit of every step, where min_len binds: every caption ends, none
    before min_len, each equal to a direct ``generate_t5``'s; every shape
    launched one that phase 3 checked; one pass profiled.  Returns (launch
    counts by phase, numbers)."""
    from torch.profiler import ProfilerActivity, profile

    from vlm_compression_tpu_torch.datasets.tokenization import batch_encode
    from vlm_compression_tpu_torch.models import blip2_t5_instruct as BT
    from vlm_compression_tpu_torch.models.generation import GenerationConfig
    from vlm_compression_tpu_torch.tasks.captioning import CaptionTask

    run = CAPTION_RUN
    n, beams = run["batch_size_eval"], run["num_beams"]
    max_len, min_len = run["max_len"], run["min_len"]
    g = torch.Generator(device="cuda").manual_seed(run["seed"])
    img = cfg.vit.img_size
    samples = {"image": torch.randn(n, img, img, 3, generator=g,
                                    device="cuda"),
               "image_id": list(range(n))}
    toks = vqa_tokenizers(cfg)
    tok = toks["tokenizer"]
    task = CaptionTask.setup_task(dict(run=run, model=XL_EVAL_MODEL), **toks)
    if (task.num_beams, task.max_len, task.min_len, task.prompt) != \
            (beams, max_len, min_len, "a photo of"):
        raise AssertionError("the caption task did not take the yaml's run "
                             "settings")
    secs = {}
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in ("cold", "warm"):
        t0 = time.perf_counter()
        out = task.evaluation(model, [samples])
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        if key == "cold":
            cold = out
    counts = {"caption_nocaps": read_counts()}
    shapes = {"caption_nocaps": read_shapes()}
    peak = torch.cuda.max_memory_allocated()
    captions = [r["caption"] for r in out]
    if [r["caption"] for r in cold] != captions or \
            [r["image_id"] for r in out] != samples["image_id"]:
        raise AssertionError("captioning: the warm pass captioned otherwise")

    # the task adds no drift: a direct generate_t5 on the prompt as the
    # task encodes it (32 tokens), decoded by hand
    prompts = [task.prompt] * n
    enc = [torch.from_numpy(a).cuda() for a in (
        *batch_encode(tok, prompts, 32),
        *batch_encode(toks["qformer_tokenizer"], prompts, 32))]

    def direct_captions(what):
        """The captions of a direct generate_t5 and the EOS position of
        each (max_len + 1 where none came), against the task's
        ``captions`` of ``what``; no EOS before position min_len."""
        seqs = BT.generate_t5(model, samples["image"], *enc,
                              gen_cfg=GenerationConfig(
                                  num_beams=beams, max_length=max_len + 1,
                                  min_length=min_len,
                                  repetition_penalty=1.0)).cpu()
        direct, eos_at = [], []
        for row in seqs.tolist():
            cut = row.index(tok.eos_token_id) \
                if tok.eos_token_id in row[1:] else len(row)
            eos_at.append(cut)
            direct.append(tok.decode(row[1:cut]).strip())
        if tuple(seqs.shape) != (n, max_len + 1) or \
                direct != [r["caption"] for r in what]:
            raise AssertionError("the caption task's captions differ from "
                                 "a direct generate_t5's decoded tokens")
        if min(eos_at) < min_len:
            raise AssertionError(f"an EOS before position {min_len}: "
                                 f"{sorted(eos_at)[:4]}")
        return eos_at

    eos_at = direct_captions(out)
    ended = sum(p < max_len + 1 for p in eos_at)

    # the metrics on the host: each image's references its own caption
    task.gts = {r["image_id"]: [r["caption"]] for r in out}
    tmp = tempfile.TemporaryDirectory(prefix="caption_results_")
    try:
        rd = os.path.join(tmp.name, "nocaps", "result")
        t0 = time.perf_counter()
        metrics = task.after_evaluation(out, split_name="val",
                                        result_dir=rd)
        secs["metrics"] = time.perf_counter() - t0
        with open(os.path.join(rd, "..", "evaluate.txt")) as fh:
            logged = json.loads(fh.readlines()[-1])
    finally:
        tmp.cleanup()
    n_tok = [len(c.split()) for c in captions]
    log(f"  caption nocaps: {n} images, beam {beams}, max_len {max_len}, "
        f"min_len {min_len}, prompt {task.prompt!r}: cold "
        f"{secs['cold']:.3f} s, warm {secs['warm']:.3f} s "
        f"({n / secs['warm']:.1f} captions/s), peak {peak / 2**30:.2f} GiB; "
        f"captions equal cold vs warm and to a direct generate_t5's; "
        f"tokens a caption {min(n_tok)}-{max(n_tok)}, EOS at positions "
        f"{min(eos_at)}-{max(eos_at)} ({ended} of {n} ended before "
        f"max_len); metrics against their own captions "
        f"{json.dumps(metrics)} ({secs['metrics']:.3f} s on the host); "
        f"e.g. {json.dumps(captions[:2])}")
    if any(metrics[k] != 1.0 for k in CAPTION_METRICS_ONE) \
            or metrics["SPICE"] is not None or logged != {"val": metrics}:
        raise AssertionError(f"caption metrics {metrics}")
    tally = shapes["caption_nocaps"]["matmul"]
    log(f"  caption nocaps, the M = {n * beams} beam-decode steps' matmul "
        f"launches by shape, beside plan's loop and splits: "
        f"{json.dumps(decode_step_routes(tally, n * beams))}")

    # min_len at work: the random weights' captions all run to max_len, so
    # once more with EOS the top logit of every row (a hook on lm_head's
    # output, removed afterwards): min_len alone holds EOS back, and each
    # image's best beam finishes once it may (its EOS candidate tops the
    # step), so every caption ends, none before position min_len
    eos = tok.eos_token_id

    def eos_on_top(module, args, logits):
        logits = logits.clone()
        logits[..., eos] = logits.max(-1).values + 1.0
        return logits

    hook = model.t5_model.lm_head.register_forward_hook(eos_on_top)
    try:
        reset_counts()
        out_eos = task.evaluation(model, [samples])
        shapes["caption_nocaps_eos"] = read_shapes()
        eos_at_bound = direct_captions(out_eos)
    finally:
        hook.remove()
    n_ended = sum(p < max_len + 1 for p in eos_at_bound)
    log(f"  caption nocaps with EOS the top logit of every step: EOS at "
        f"positions {min(eos_at_bound)}-{max(eos_at_bound)} ({n_ended} of "
        f"{n} ended before max_len, "
        f"{sum(p == min_len for p in eos_at_bound)} at min_len "
        f"{min_len}); captions equal to a direct generate_t5's")
    if n_ended != n:
        raise AssertionError(f"with EOS on top, {n - n_ended} captions ran "
                             f"to max_len")
    check_shapes(shapes, "caption")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        task.evaluation(model, [samples])
        torch.cuda.synchronize()
    dev_ms, groups = device_breakdown(
        prof, 1e3 * secs["warm"], f"caption nocaps, {n} images, beam {beams}")
    return counts, {
        "caption_cold_s": secs["cold"], "caption_warm_s": secs["warm"],
        "captions_per_s": n / secs["warm"], "caption_peak_bytes": peak,
        "caption_metrics_s": secs["metrics"],
        "caption_device_ms": dev_ms}


def main_path():
    from vlm_compression_tpu_torch.models.bridge import export_masks

    t0 = time.perf_counter()
    cfg, model, batches, req = xl_setup(seed=0)
    n_params = sum(p.numel() for n, p in model.named_parameters()
                   if "lora_" not in n)
    n_lora = sum(p.numel() for n, p in model.named_parameters()
                 if "lora_" in n)
    log(f"  model: InstructBLIP-FlanT5-XL, {n_params / 1e9:.3f} B params + "
        f"{n_lora / 1e6:.3f} M LoRA, bf16, random init + data "
        f"{time.perf_counter() - t0:.1f} s; cuts: none (depth 39/24/24, "
        f"{N_CALIB} calibration samples)")
    torch.cuda.reset_peak_memory_stats()

    counts = {}
    reset_counts()
    t0 = time.perf_counter()
    model, _ = run_prune(model, batches)
    t_prune = time.perf_counter() - t0
    counts["prune"] = read_counts()
    log(f"  prune attention, by route: {attn_routes(counts['prune'])}")
    masks = export_masks(model)
    for tower, (dens, n) in tower_density(model).items():
        log(f"  prune density {tower}: {dens:.4f} over {n} linears")
        if abs(dens - 0.5) > 0.01:
            raise AssertionError(f"density {tower}")
    if len(masks) != 39 * 4 + 24 * 7 + 24 * 11:
        raise AssertionError(f"{len(masks)} masked linears")
    log(f"  prune (blipt5_wanda_pruner, lora_model=True): {t_prune:.2f} s")
    del batches, masks

    # the first call pays one-time costs (lazy kernel-module loads, the
    # allocator growing); the second is the steady-state request
    t_gen, outs = {}, {}
    for phase in ("generate_cold", "generate_warm"):
        reset_counts()
        t0 = time.perf_counter()
        seqs, gen_cfg = run_generate(model, req)
        t_gen[phase] = time.perf_counter() - t0
        counts[phase] = read_counts()
        n_tok = check_generate(seqs, gen_cfg, cfg)
        outs[phase] = seqs
        log(f"  generate_t5 beam-5 ({phase}), {N_REQ} requests, max_length "
            f"10: {t_gen[phase]:.3f} s, {n_tok} tokens, "
            f"{n_tok / t_gen[phase]:.1f} tokens/s")
    if not torch.equal(outs["generate_cold"], outs["generate_warm"]):
        raise AssertionError("two generate calls on the same inputs differ")
    log(f"  tokens: {seqs.tolist()}")
    tokens_per_s = n_tok / t_gen["generate_warm"]
    peak = torch.cuda.max_memory_allocated()
    log(f"  max_memory_allocated (prune + generate): {peak / 2**30:.2f} GiB")

    reset_counts()
    retrain = run_retrain(model, synthetic_batches(
        cfg, 1 + N_TIMED_STEPS, TRAIN_BS,
        torch.Generator(device="cuda").manual_seed(7)))
    counts["retrain"] = read_counts()
    check_shapes({"retrain": read_shapes()}, "retrain")
    log(f"  retrain attention per step, by route: "
        f"{attn_routes(counts['retrain'], 1 + N_TIMED_STEPS + N_REPLAY)}")
    merge_and_check(model)
    reset_counts()
    t0 = time.perf_counter()
    seqs, gen_cfg = run_generate(model, req)
    t_merged = time.perf_counter() - t0
    counts["generate_merged"] = read_counts()
    n_tok = check_generate(seqs, gen_cfg, cfg)
    log(f"  generate_t5 beam-5 from the merged model: {t_merged:.3f} s, "
        f"{n_tok} tokens; same tokens as before retraining: "
        f"{torch.equal(seqs, outs['generate_warm'])}")
    del req
    gc.collect()
    torch.cuda.empty_cache()
    vqa_counts, vqa = vqa_path(model, cfg)
    counts.update(vqa_counts)
    caption_counts, caption = caption_path(model, cfg)
    counts.update(caption_counts)

    log(f"  launches: {json.dumps(counts)}")
    check_phase_counts(counts)
    del model
    torch.cuda.empty_cache()
    return counts, {"prune_s": t_prune,
                    "generate_cold_s": t_gen["generate_cold"],
                    "generate_s": t_gen["generate_warm"],
                    "tokens_per_s": tokens_per_s,
                    "peak_bytes": peak, **retrain,
                    "generate_merged_s": t_merged, **vqa, **caption}


class DampedLines(logging.Handler):
    """Echoes the SparseGPT pruner's per-tower damping line (Hessians that
    got damp·I before use: after a failed factorization, after an
    overflowing inverse) and keeps its counts by tower."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.by_tower = {}

    def emit(self, record):
        msg = record.getMessage()
        if "sparsegpt damped" in msg:
            name, factorization, inverse = record.args
            self.by_tower[name] = {"factorization": factorization,
                                   "inverse": inverse}
            log(f"  {msg}")


def model_sizes(model) -> dict:
    """The model-size report and the bytes at rest of one form."""
    from vlm_compression_tpu_torch.compression.peft_io import (
        bytes_at_rest,
        model_size_accounting,
    )

    return {**model_size_accounting(model), **bytes_at_rest(model)}


def compressed_path():
    """The compressed-serving path of the launcher grid on a second
    full-width XL model: SparseGPT prune (masks kept), then serving with
    bool masks, packed masks (2 and 1 bits a weight), int8 weights with
    packed masks, and the evaluate.py serving form (zeroed int8 weights,
    no masks)."""
    from vlm_compression_tpu_torch.models.layers import SparseLinear, set_mask
    from vlm_compression_tpu_torch.ops import bitmask as BM
    from vlm_compression_tpu_torch.ops import quant as Q

    t0 = time.perf_counter()
    cfg, model, batches, req = xl_setup(seed=1, lora=False)
    log(f"  model: InstructBLIP-FlanT5-XL, bf16, seed 1, no adapters, "
        f"random init (biases 0) + data {time.perf_counter() - t0:.1f} s; "
        f"cuts: none (depth 39/24/24, {N_CALIB} calibration samples)")
    torch.cuda.reset_peak_memory_stats()
    counts, secs, outs, sizes, profiles = {}, {}, {}, {}, {}

    # the pruner's INFO lines go to DampedLines alone while it prunes
    damped = DampedLines()
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    root.handlers = [damped]
    root.setLevel(logging.INFO)
    try:
        reset_counts()
        t0 = time.perf_counter()
        model, _ = run_prune(model, batches, "blipt5_sparsegpt_pruner")
        secs["sparsegpt_prune"] = time.perf_counter() - t0
        counts["sparsegpt_prune"] = read_counts()
    finally:
        root.handlers = handlers
        root.setLevel(level)
    del batches
    if set(damped.by_tower) != {"vit", "t5_encoder", "t5_decoder"}:
        raise AssertionError(f"damping reported for {sorted(damped.by_tower)}")
    for tower, (dens, n) in tower_density(model).items():
        log(f"  sparsegpt density {tower}: {dens:.4f} over {n} linears")
        if abs(dens - 0.5) > 0.01:
            raise AssertionError(f"sparsegpt density {tower}")
    linears = [m for m in model.modules()
               if isinstance(m, SparseLinear) and m.mask is not None]
    if len(linears) != 39 * 4 + 24 * 7 + 24 * 11:
        raise AssertionError(f"{len(linears)} masked linears")
    bad = [i for i, m in enumerate(linears)
           if bool((m.kernel.ne(0) & ~m.mask).any())
           or not bool(torch.isfinite(m.kernel).all())]
    if bad:
        raise AssertionError(f"{len(bad)} updated kernels non-zero off their "
                             "masks or not finite")
    log(f"  prune (blipt5_sparsegpt_pruner, lora_model=True): "
        f"{secs['sparsegpt_prune']:.2f} s; updated kernels finite and 0 off "
        f"their masks")

    def generate(phase):
        reset_counts()
        t0 = time.perf_counter()
        seqs, gen_cfg = run_generate(model, req)
        secs[phase] = time.perf_counter() - t0
        counts[phase] = read_counts()
        n_tok = check_generate(seqs, gen_cfg, cfg)
        outs[phase] = seqs
        log(f"  generate_t5 beam-5 ({phase}): {secs[phase]:.3f} s, {n_tok} "
            f"tokens, {n_tok / secs[phase]:.1f} tokens/s")
        return seqs

    def same(phase, ref):
        if not torch.equal(outs[phase], outs[ref]):
            raise AssertionError(f"{phase} tokens differ from {ref}: "
                                 f"{outs[phase].tolist()} vs "
                                 f"{outs[ref].tolist()}")

    generate("generate_bool")
    log(f"  tokens: {outs['generate_bool'].tolist()}")
    sizes["bool"] = model_sizes(model)
    profiles["bool"] = profile_generate(model, req,
                                        1e3 * secs["generate_bool"], "bool")
    for group in (128, 256):
        t0 = time.perf_counter()
        BM.pack_masks_(model, group)
        torch.cuda.synchronize()
        log(f"  pack_masks_(model, {group}): "
            f"{time.perf_counter() - t0:.2f} s")
        generate(f"generate_packed{group}")
        same(f"generate_packed{group}", "generate_bool")
        sizes[f"packed{group}"] = model_sizes(model)
        profiles[f"packed{group}"] = profile_generate(
            model, req, 1e3 * secs[f"generate_packed{group}"],
            f"packed-{group}")
    BM.pack_masks_(model, 128)   # the default layout under int8
    t0 = time.perf_counter()
    Q.quantize_model_int8_(model)
    torch.cuda.synchronize()
    log(f"  quantize_model_int8_: {time.perf_counter() - t0:.2f} s")
    generate("generate_int8_cold")
    generate("generate_int8_warm")
    same("generate_int8_warm", "generate_int8_cold")
    log(f"  tokens (int8, packed-128 masks): "
        f"{outs['generate_int8_warm'].tolist()}; equal to the bf16 ones: "
        f"{torch.equal(outs['generate_int8_warm'], outs['generate_bool'])}")
    sizes["int8_packed128"] = model_sizes(model)
    peak = torch.cuda.max_memory_allocated()

    profiles["int8_packed128"] = profile_generate(
        model, req, 1e3 * secs["generate_int8_warm"], "int8 + packed-128")

    # the evaluate.py serving form: pruned weights zeroed, masks dropped
    with torch.no_grad():
        for m in linears:
            m.kernel.masked_fill_(~m.bool_mask(), 0)
            set_mask(m, None)
    generate("generate_int8_serving")
    # the codes were 0 off the masks already (SparseGPT zeroes what it
    # prunes): the same products in the same order
    same("generate_int8_serving", "generate_int8_warm")
    sizes["int8_serving"] = model_sizes(model)

    for form, sz in sizes.items():
        log(f"  sizes {form:15s}: kernels {sz['kernels'] / 2**30:.3f} GiB, "
            f"masks {sz['masks'] / 2**30:.3f} GiB, scales "
            f"{sz['scales'] / 2**20:.2f} MiB, total "
            f"{sz['total'] / 2**30:.3f} GiB; parameters "
            f"{sz['orig_total_size']}, surviving "
            f"{sz['distilled_total_size']}")
    log(f"  max_memory_allocated (sparsegpt prune + generates): "
        f"{peak / 2**30:.2f} GiB")
    log(f"  launches: {json.dumps(counts)}")
    check_phase_counts(counts)
    del model, linears
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"sparsegpt_prune_s": secs["sparsegpt_prune"],
                    "sparsegpt_damped": damped.by_tower,
                    "generate_bool_s": secs["generate_bool"],
                    "generate_packed128_s": secs["generate_packed128"],
                    "generate_packed256_s": secs["generate_packed256"],
                    "generate_int8_s": secs["generate_int8_warm"],
                    "generate_int8_serving_s": secs["generate_int8_serving"],
                    "compressed_peak_bytes": peak,
                    "generate_device_ms": profiles,
                    "bytes_at_rest": {f: sz["total"]
                                      for f, sz in sizes.items()}}


def first_order_path():
    """The gradient-scoring family of the launcher grid on a third
    full-width XL model (seed 2, no adapters).  A: ``blipt5_wanda_pruner``
    with the EcoFLaP first-order block allocation (aobd_sum on the first
    32 of the 128 calibration samples), masks kept, then beam-5 generate
    twice.  B, on the model rebuilt dense: the diagonal Fisher
    (``get_data_derivative``, power 2, batch 1), the ``unstrct``
    ``prune_by_importance`` at keep 0.5 over the ViT and T5 leaves, then
    beam-5 generate."""
    from vlm_compression_tpu_torch.compression.derivatives import (
        get_data_derivative,
    )
    from vlm_compression_tpu_torch.compression.distill_merge import (
        count_nonzero,
        count_params,
        prune_by_importance,
    )

    counts, secs, peaks, outs = {}, {}, {}, {}

    def generate(model, req, cfg, phase):
        reset_counts()
        t0 = time.perf_counter()
        seqs, gen_cfg = run_generate(model, req)
        secs[phase] = time.perf_counter() - t0
        counts[phase] = read_counts()
        n_tok = check_generate(seqs, gen_cfg, cfg)
        outs[phase] = seqs
        log(f"  generate_t5 beam-5 ({phase}): {secs[phase]:.3f} s, {n_tok} "
            f"tokens; tokens {seqs.tolist()}")

    t0 = time.perf_counter()
    cfg, model, batches, req = xl_setup(seed=2, lora=False)
    log(f"  model: InstructBLIP-FlanT5-XL, bf16, seed 2, no adapters, random "
        f"init + data {time.perf_counter() - t0:.1f} s; cuts: none (depth "
        f"39/24/24, {N_CALIB} calibration samples, the first 32 scored)")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    model, ratios = run_prune(model, batches, **FIRST_ORDER)
    secs["ecoflap_prune"] = time.perf_counter() - t0
    counts["ecoflap_prune"] = read_counts()
    peaks["ecoflap_prune"] = torch.cuda.max_memory_allocated()
    log(f"  ecoflap prune's attention, by route: "
        f"{attn_routes(counts['ecoflap_prune'])}")
    del batches
    groups = {}
    for key, r in ratios.items():
        parts = key.split("/")
        i = next(j for j, x in enumerate(parts) if x.startswith("blocks_"))
        groups.setdefault("/".join(parts[:i + 1]), set()).add(r)
    for tower in ("visual_encoder", "t5_model/encoder", "t5_model/decoder"):
        rs = [next(iter(v)) for gname, v in groups.items()
              if gname.startswith(tower + "/")]
        log(f"  allocated sparsity {tower} ({len(rs)} blocks): "
            f"{json.dumps([round(r, 4) for r in rs])}")
    sparsities = [r for v in groups.values() for r in v]
    kernels = [model.get_submodule(k.replace("/", ".")) for k in ratios]
    kept = sum(int(m.mask.count_nonzero()) for m in kernels)
    total = sum(m.kernel.numel() for m in kernels)
    log(f"  ecoflap prune (blipt5_wanda_pruner, block, aobd_sum, "
        f"lora_model=True): {secs['ecoflap_prune']:.2f} s, {len(groups)} "
        f"groups over {len(ratios)} linears, sparsity {min(sparsities):.4f} "
        f"to {max(sparsities):.4f}, density {kept / total:.4f}; peak "
        f"{peaks['ecoflap_prune'] / 2**30:.2f} GiB; launches "
        f"{json.dumps(counts['ecoflap_prune'])}")
    if not (len(ratios) == 588 and len(groups) == 39 + 24 + 24
            and all(len(v) == 1 for v in groups.values())
            and all(0.0 <= r <= 0.8 for r in sparsities)
            and abs(kept / total - 0.5) <= 0.01):
        raise AssertionError("ecoflap allocation")
    del kernels
    generate(model, req, cfg, "generate_ecoflap_cold")
    generate(model, req, cfg, "generate_ecoflap_warm")
    if not torch.equal(outs["generate_ecoflap_cold"],
                       outs["generate_ecoflap_warm"]):
        raise AssertionError("two generate calls on the same inputs differ")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, model, batches, req = xl_setup(seed=2, lora=False)
    samples = [{k: v[i:i + 1] for k, v in batches[0].items()}
               for i in range(N_FISHER)]
    del batches
    log(f"  model rebuilt dense (seed 2): {time.perf_counter() - t0:.1f} s; "
        f"{N_FISHER} samples at batch 1")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    fisher = get_data_derivative(model, samples, power=2)
    torch.cuda.synchronize()
    secs["fisher_derivative"] = time.perf_counter() - t0
    counts["fisher_derivative"] = read_counts()
    peaks["fisher_derivative"] = torch.cuda.max_memory_allocated()
    log(f"  fisher attention per sample, by route: "
        f"{attn_routes(counts['fisher_derivative'], N_FISHER)}")
    bad = [p for p, a in fisher.items()
           if not bool(torch.isfinite(a).all()) or bool((a < 0).any())]
    rel = {s: float(fisher[("t5_model", s, "rel_bias", "rel_embedding")]
                    .sum()) for s in ("encoder", "decoder")}
    # the position bias's gradient in each T5 self-attention (24 encoder,
    # 24 decoder layers), every one an output of the TMA + wgmma backward
    per_sample = counts["fisher_derivative"][BWD_DBIAS] / N_FISHER
    log(f"  get_data_derivative (power 2, {N_FISHER} samples, batch 1): "
        f"{secs['fisher_derivative']:.2f} s "
        f"({secs['fisher_derivative'] / N_FISHER:.3f} s a sample), "
        f"{len(fisher)} leaves, {len(bad)} not finite or negative; "
        f"rel_embedding sums {json.dumps(rel)}; fused dbias outputs "
        f"{per_sample:g} a sample; peak "
        f"{peaks['fisher_derivative'] / 2**30:.2f} GiB; launches "
        f"{json.dumps(counts['fisher_derivative'])}")
    if bad or not all(v > 0 for v in rel.values()) or per_sample != 48:
        raise AssertionError(f"fisher: {bad[:4]} {rel} {per_sample}")
    t0 = time.perf_counter()
    towers = (model.visual_encoder, model.t5_model)
    for name, tower in zip(("visual_encoder", "t5_model"), towers):
        prune_by_importance(tower, {p[1:]: a for p, a in fisher.items()
                                    if p[0] == name}, keep_ratio=0.5)
    torch.cuda.synchronize()
    secs["prune_by_importance"] = time.perf_counter() - t0
    del fisher
    dens = sum(count_nonzero(t) for t in towers) / sum(
        count_params(t) for t in towers)
    log(f"  prune_by_importance (keep 0.5, visual_encoder + t5_model leaves): "
        f"{secs['prune_by_importance']:.2f} s, non-zero share {dens:.4f}")
    if abs(dens - 0.5) > 0.01:
        raise AssertionError(f"unstrct density {dens}")
    generate(model, req, cfg, "generate_fisher")
    log(f"  launches: {json.dumps(counts)}")
    check_phase_counts(counts)
    del model, towers, samples
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"ecoflap_prune_s": secs["ecoflap_prune"],
                    "ecoflap_peak_bytes": peaks["ecoflap_prune"],
                    "generate_ecoflap_s": secs["generate_ecoflap_warm"],
                    "fisher_derivative_s": secs["fisher_derivative"],
                    "fisher_peak_bytes": peaks["fisher_derivative"],
                    "prune_by_importance_s": secs["prune_by_importance"],
                    "generate_fisher_s": secs["generate_fisher"]}


# the grid's zeroth entry (scripts/launch_lib.py:23): Wanda at a
# block-granular allocation scored by olmezo-gradient_sum.  The grid scores
# 32 samples at batch 1 (cli/evaluate.py:34,48), 2 × 32 forwards for each
# of the 588 keys; here one sample (1176 forwards), the one cut of the path
ZEROTH = dict(sparsity_ratio_granularity="block",
              score_method="olmezo-gradient_sum")
N_ZEROTH, N_ZEROTH_GRID = 1, 32
# the zeroth scoring's keys traced under the profiler (profile_grid)
N_PROFILED = 24
TOWERS = ("visual_encoder", "t5_model.encoder", "t5_model.decoder")
GLOBAL_PHASES = ("mag_prune", "rand_prune", "mag_global", "aobd_prune")


def grid_path():
    """The launcher grid's other pruners on a fourth full-width XL model
    (seed 3, no adapters), its dense kernels restored between pruners (kept
    in pinned host memory): ``blipt5_dsnot_pruner`` (the wanda initial
    metric, the grid's defaults; masks kept) and beam-5 generate;
    ``blipt5_mag_pruner`` and ``blipt5_rand_pruner`` (layerwise, as the
    grid runs them), ``blipt5_mag_pruner`` with ``is_global`` (the
    threshold checked on the card: #{s ≤ thr} ≥ k > #{s < thr} over every
    leaf); ``blipt5_aobd_pruner`` on the 128 samples; the grid's zeroth
    entry (one sample scored at batch 1, the calibration at batch 1 as the
    grid feeds it) and beam-5 generate.  Gates: each tower's density
    0.5 ± 0.01 (the zeroth entry: the parameter-weighted mean of its
    ratios and of its masks), finite outputs, each phase's kernels
    launched and the forbidden ones not, every shape launched one that
    phase 3 checked."""
    from vlm_compression_tpu_torch.compression import allocator as AL
    from vlm_compression_tpu_torch.compression.pruners import (
        global_pruner as GP,
    )
    from vlm_compression_tpu_torch.models.layers import set_mask

    rec, outs, e2e = new_record(), {}, {}
    counts, secs, peaks, shapes = (rec[k] for k in ("counts", "secs",
                                                    "peaks", "shapes"))
    t0 = time.perf_counter()
    cfg, model, batches, req = xl_setup(seed=3, lora=False)
    keys = AL.select_prunable_keys(model, ("visual_encoder", "t5_model"))
    lins = [model.get_submodule(".".join(k)) for k in keys]
    linears = {t: sum(".".join(k).startswith(t) for k in keys)
               for t in TOWERS}
    dense = [torch.empty(lin.kernel.shape, dtype=lin.kernel.dtype,
                         pin_memory=True).copy_(lin.kernel) for lin in lins]
    log(f"  model: InstructBLIP-FlanT5-XL, bf16, seed 3, no adapters, random "
        f"init + data + a pinned host copy of the {len(keys)} prunable "
        f"kernels ({json.dumps(linears)}) "
        f"{time.perf_counter() - t0:.1f} s; cuts: the zeroth "
        f"entry scores {N_ZEROTH} sample at batch 1 (the grid: "
        f"{N_ZEROTH_GRID}); nothing else (depth 39/24/24, {N_CALIB} "
        f"calibration samples at batch {BS})")

    @torch.no_grad()
    def restore():
        for lin, w in zip(lins, dense):
            lin.kernel.copy_(w, non_blocking=True)
            set_mask(lin, None)
        torch.cuda.synchronize()

    def check_pruned(phase, every_tower=True):
        """Densities by tower (of the masks; the global pruners also zero
        the kernels off them), and one finite forward loss."""
        dens = tower_density(model)
        # the global pruners zero the kernels off their masks; the others
        # keep them
        zeroed = (all(not bool(lin.kernel[~lin.mask].any()) for lin in lins)
                  if phase in GLOBAL_PHASES else None)
        with torch.no_grad():
            loss = float(model(**batches[0])["loss"])
        log(f"  {phase}: {secs[phase]:.3f} s, peak "
            f"{peaks[phase] / 2**30:.2f} GiB; density by tower "
            f"{json.dumps({t: round(d, 5) for t, (d, _) in dens.items()})}"
            f"; kernels zeroed off the masks {zeroed}; loss on a "
            f"calibration batch {loss:.4f}; launches "
            f"{json.dumps(counts[phase])}")
        bad = [t for t, (d, n) in dens.items()
               if n != linears[t] or (every_tower and abs(d - 0.5) > 0.01)]
        if bad or zeroed is False or loss != loss \
                or abs(loss) == float("inf"):
            raise AssertionError(f"{phase}: {bad} {zeroed} {loss}")
        e2e[f"{phase}_s"] = secs[phase]
        e2e[f"{phase}_peak_bytes"] = peaks[phase]

    def generate(phase):
        seqs, gen_cfg = run_phase(rec, phase,
                                  lambda: run_generate(model, req))
        n_tok = check_generate(seqs, gen_cfg, cfg)
        outs[phase] = seqs
        e2e[f"{phase}_s"] = secs[phase]
        log(f"  generate_t5 beam-5 ({phase}): {secs[phase]:.3f} s, {n_tok} "
            f"tokens; tokens {seqs.tolist()}")

    # DSnoT, its refinement timed and its cycles counted per linear
    with dsnot_tally() as tally:
        run_phase(rec, "dsnot_prune", lambda: run_prune(
            model, batches, name="blipt5_dsnot_pruner"))
    e2e.update(log_dsnot_tally(tally, secs["dsnot_prune"], len(keys)))
    check_pruned("dsnot_prune")
    generate("generate_dsnot")
    restore()

    for phase, name, kw in (("mag_prune", "blipt5_mag_pruner", {}),
                            ("rand_prune", "blipt5_rand_pruner", {})):
        run_phase(rec, phase,
                  lambda: run_prune(model, batches, name=name, **kw))
        check_pruned(phase)
        restore()

    # the global threshold: its defining property, on the card
    select, seen = GP.kth_smallest, []

    def checked_select(leaves, k):
        thr = select(leaves, k)
        if len(leaves) > 1:
            le = sum(int((v <= thr).sum()) for v in leaves)
            lt = sum(int((v < thr).sum()) for v in leaves)
            seen.append((k, float(thr), le, lt,
                         sum(v.numel() for v in leaves)))
        return thr

    GP.kth_smallest = checked_select
    try:
        run_phase(rec, "mag_global", lambda: run_prune(
            model, batches, name="blipt5_mag_pruner", is_global=True))
    finally:
        GP.kth_smallest = select
    log(f"  mag_global threshold (k, thr, #<=thr, #<thr, scores): {seen}")
    if len(seen) != 1 or not seen[0][2] >= seen[0][0] > seen[0][3]:
        raise AssertionError(f"mag_global threshold {seen}")
    check_pruned("mag_global")
    restore()

    run_phase(rec, "aobd_prune", lambda: run_prune(
        model, batches, name="blipt5_aobd_pruner"))
    log(f"  aobd prune's attention, by route: "
        f"{attn_routes(counts['aobd_prune'])}")
    check_pruned("aobd_prune")
    restore()

    # the zeroth entry, fed at batch 1 as the grid feeds it; its scoring
    # timed apart from the sweep
    ones = [{k: v[i:i + 1] for k, v in b.items()} for b in batches
            for i in range(BS)]
    score, score_s = AL.mezo_layer_scalars, [0.0]

    def timed_score(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = score(*a, **kw)
        torch.cuda.synchronize()
        score_s[0] += time.perf_counter() - t0
        return out

    AL.mezo_layer_scalars = timed_score
    try:
        _, ratios = run_phase(rec, "zeroth_prune", lambda: run_prune(
            model, ones, num_data_first_stage=N_ZEROTH, **ZEROTH))
    finally:
        AL.mezo_layer_scalars = score
    forwards = 2 * N_ZEROTH * len(keys)
    ms = 1e3 * score_s[0] / forwards
    e2e["zeroth_score_s"] = score_s[0]
    e2e["zeroth_ms_per_forward"] = ms
    e2e["zeroth_grid_score_s"] = ms * 2 * N_ZEROTH_GRID * len(keys) / 1e3
    log(f"  zeroth scoring: {forwards} forwards at batch 1 in "
        f"{score_s[0]:.2f} s ({ms:.2f} ms a forward); the grid's "
        f"{N_ZEROTH_GRID} samples ({2 * N_ZEROTH_GRID * len(keys)} forwards) "
        f"at that rate {e2e['zeroth_grid_score_s']:.0f} s")
    groups = {}
    numel = {"/".join(k): lin.kernel.numel() for k, lin in zip(keys, lins)}
    for key, r in ratios.items():
        parts = key.split("/")
        i = next(j for j, x in enumerate(parts) if x.startswith("blocks_"))
        groups.setdefault("/".join(parts[:i + 1]), set()).add(r)
    for tower in ("visual_encoder", "t5_model/encoder", "t5_model/decoder"):
        rs = [next(iter(v)) for gname, v in groups.items()
              if gname.startswith(tower + "/")]
        log(f"  zeroth allocated sparsity {tower} ({len(rs)} blocks): "
            f"{json.dumps([round(r, 4) for r in rs])}")
    weighted = sum(r * numel[k] for k, r in ratios.items()) / sum(
        numel.values())
    kept = sum(int(lin.mask.count_nonzero()) for lin in lins)
    total = sum(numel.values())
    log(f"  zeroth allocation: {len(groups)} groups over {len(ratios)} "
        f"linears, parameter-weighted sparsity {weighted:.5f}, mask "
        f"density {kept / total:.5f}")
    depth = cfg.vit.depth + cfg.t5.num_layers + cfg.t5.num_decoder_layers
    if not (len(ratios) == len(keys) and len(groups) == depth
            and all(len(v) == 1 for v in groups.values())
            and abs(weighted - 0.5) <= 0.01
            and abs(kept / total - 0.5) <= 0.01):
        raise AssertionError("zeroth allocation")
    # the allocation moves density between towers: no per-tower gate
    check_pruned("zeroth_prune", every_tower=False)
    generate("generate_zeroth")
    log(f"  launches: {json.dumps(counts)}")
    check_phase_counts(counts)
    check_shapes(shapes, "grid")
    del model, lins, dense, batches, ones
    gc.collect()
    torch.cuda.empty_cache()
    return counts, e2e


# the Vicuna path (vicuna_path): InstructBLIP-Vicuna-7B as
# configs/models/blip2_vicuna_instruct_7b.yaml builds it (EVA-ViT-g 39
# layers, Q-Former 12, LLaMA 32 × 4096, ffn 11008, 32 heads of 128, vocab
# 32000), seed 4; pruned as scripts/launch_lib.py:50-51 prunes it
# (``--t5_model_prefix llm_model``) and scored with the Vicuna eval yamls
# (configs/projects/eval/gqa_zeroshot_vicuna_instruct_eval.yaml:18-29 and
# okvqa_zeroshot_vicuna_instruct_eval.yaml:4,18-29: batch 64, beam 5,
# max_len 10, min_len 1, the prompt; the lemmatizer for OK-VQA)
VICUNA_MODEL = dict(arch="blip2_vicuna_instruct", model_type="vicuna7b")
VICUNA_OKVQA_MODEL = dict(VICUNA_MODEL, apply_lemmatizer=True)
VICUNA_SEED = 4


def vicuna_tokenizers(cfg) -> dict:
    """LLaMA's special ids (pad 0, BOS 1, EOS 2) over its 32000 ids; the
    Q-Former keeps a tokenizer of its own vocabulary (LLaMA's ids overflow
    it)."""
    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
    )

    llm = cfg.llm
    return dict(tokenizer=SimpleTokenizer(
        llm.vocab_size, pad_token_id=llm.pad_token_id,
        eos_token_id=llm.eos_token_id, bos_token_id=llm.bos_token_id),
        qformer_tokenizer=SimpleTokenizer(cfg.qformer.vocab_size))


def vicuna_batches(cfg, n: int, bs: int, g: torch.Generator):
    """n seeded calibration batches as the decoder-only collator packs
    them (``pack_qa``): 224² images; TXT tokens of prompt ⊕ answer, BOS
    first, right-padded from TXT − 8 … TXT; labels −100 over the prompt
    half and the pads; the Q-Former's TXT tokens."""
    img, llm = cfg.vit.img_size, cfg.llm
    pos = torch.arange(TXT, device="cuda")[None]
    out = []
    for _ in range(n):
        ids = torch.randint(3, llm.vocab_size, (bs, TXT), generator=g,
                            device="cuda")
        ids[:, 0] = llm.bos_token_id
        lens = torch.randint(TXT - 8, TXT + 1, (bs, 1), generator=g,
                             device="cuda")
        keep = pos < lens
        out.append(dict(
            image=torch.randn(bs, img, img, 3, generator=g, device="cuda"),
            text_input_ids=torch.where(keep, ids, llm.pad_token_id),
            text_attention_mask=keep.to(torch.int32),
            labels=torch.where(keep & (pos >= TXT // 2), ids, -100),
            qformer_input_ids=torch.randint(3, 2000, (bs, TXT), generator=g,
                                            device="cuda"),
            qformer_attention_mask=torch.ones(bs, TXT, dtype=torch.int32,
                                              device="cuda")))
    return out


def vicuna_train_batches(cfg, n: int, bs: int, seed: int):
    """n retrain batches of bs samples as the Vicuna collator
    (``make_vicuna_batch_preparer``) packs them on the host: prompt ⊕
    answer of seeded words (one id a word), BOS first and EOS after the
    answer, 32-TXT ids a sample and TXT in each batch, right-padded, labels
    −100 over the prompt and the pads; the Q-Former's prompts padded to
    TXT − 6 in every batch (its first sample has the longest: a 4-word
    answer), so its attention runs one shape; seeded 224² images; moved to
    the card by the caller, as a training loop does."""
    from vlm_compression_tpu_torch.tasks.preparers import (
        make_vicuna_batch_preparer,
    )

    prepare = make_vicuna_batch_preparer(**vicuna_tokenizers(cfg))
    rng = random.Random(seed)
    g = torch.Generator().manual_seed(seed)
    words = sorted({w for group in VQA_WORDS.values() for phrase in group
                    for w in phrase.split()})
    img = cfg.vit.img_size
    out = []
    for _ in range(n):
        text_in, text_out = [], []
        for i, length in enumerate(
                [TXT] + [rng.randint(TXT - 8, TXT) for _ in range(bs - 1)]):
            a = 4 if i == 0 else rng.randint(4, min(12, length - 3))
            text_in.append(" ".join(rng.choices(words, k=length - 2 - a)))
            text_out.append(" ".join(rng.choices(words, k=a)))
        batch = prepare({"image": torch.randn(bs, img, img, 3, generator=g),
                         "text_input": text_in, "text_output": text_out})
        if batch["text_input_ids"].shape != (bs, TXT) or \
                batch["qformer_input_ids"].shape != (bs, TXT - 6):
            raise AssertionError(f"collated {batch['text_input_ids'].shape}, "
                                 f"{batch['qformer_input_ids'].shape}")
        out.append({k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    return out


def tiny_vicuna_check():
    """A tiny float32 InstructBLIP-Vicuna on the card (kernels) vs the same
    model on the CPU (plain versions): logits with random masks on every
    linear and left-padded text, within 1e-4; beam-2 ``generate_vicuna``
    over left-padded prompts (pads 0, 1, 2), tokens equal; the dense model
    pruned by ``blipt5_wanda_pruner`` and ``blipt5_dsnot_pruner`` over the
    ViT and ``llm_model``, masks bit-equal (DSnoT: its cycles by linear
    equal too)."""
    from vlm_compression_tpu_torch.compression import load_pruner
    from vlm_compression_tpu_torch.models.blip2_vicuna_instruct import (
        Blip2VicunaInstruct,
        Blip2VicunaInstructConfig,
        generate_vicuna,
    )
    from vlm_compression_tpu_torch.models.bridge import (
        export_masks,
        random_init_,
    )
    from vlm_compression_tpu_torch.models.eva_vit import EvaViTConfig
    from vlm_compression_tpu_torch.models.generation import GenerationConfig
    from vlm_compression_tpu_torch.models.layers import SparseLinear
    from vlm_compression_tpu_torch.models.llama import LlamaConfig
    from vlm_compression_tpu_torch.models.qformer import QFormerConfig

    f32 = dict(param_dtype="float32", dtype="float32")
    cfg = Blip2VicunaInstructConfig.tiny(
        vit=EvaViTConfig.tiny(**f32),
        qformer=QFormerConfig.tiny(dtype="float32"),
        llm=LlamaConfig.tiny(**f32))
    dense = random_init_(Blip2VicunaInstruct(cfg, device="cpu"), seed=12,
                         std=0.2)
    g = torch.Generator().manual_seed(12)
    cpu = copy.deepcopy(dense)
    for mod in cpu.modules():
        if isinstance(mod, SparseLinear):
            mod.mask = torch.rand(mod.kernel.shape, generator=g) < 0.6
    gpu = copy.deepcopy(cpu).to("cuda")
    mask = torch.ones(3, 6, dtype=torch.int32)
    mask[1, :1] = mask[2, :2] = 0
    ids = torch.randint(3, 96, (3, 6), generator=g) * mask
    for i in range(3):
        ids[i, i] = cfg.llm.bos_token_id
    image = torch.randn(3, 28, 28, 3, generator=g)
    q_ids = torch.randint(2, 64, (3, 5), generator=g)
    q_mask = torch.ones(3, 5, dtype=torch.int32)
    batch = dict(image=image, text_input_ids=ids, text_attention_mask=mask,
                 labels=ids * mask + (mask - 1) * 100,
                 qformer_input_ids=q_ids, qformer_attention_mask=q_mask)
    gen_cfg = GenerationConfig(num_beams=2, max_length=5, min_length=1,
                               eos_token_id=cfg.llm.eos_token_id)
    reset_counts()
    with torch.no_grad():
        want = cpu(**batch)["logits"]
        got = gpu(**{k: v.cuda() for k, v in batch.items()})["logits"]
        seqs = [generate_vicuna(m, *(t.to(dev) for t in (image, ids, mask,
                                                        q_ids, q_mask)),
                                gen_cfg=gen_cfg).cpu()
                for m, dev in ((cpu, "cpu"), (gpu, "cuda"))]
    c = read_counts()
    err = float((got.cpu() - want).abs().max())
    log(f"  tiny fp32 InstructBLIP-Vicuna (bool masks) logits, card vs CPU: "
        f"max_abs_err={err:.3e} (tol 1e-4); beam-2 generate_vicuna tokens "
        f"{seqs[1].tolist()}, equal {torch.equal(seqs[0], seqs[1])}; "
        f"masked_matmul launches {c['masked_matmul']}, attention forwards "
        f"{c['flash_attention']}")
    if not (err <= 1e-4 and bool(torch.isfinite(got).all())
            and torch.equal(seqs[0], seqs[1]) and c["masked_matmul"] > 0
            and c["flash_attention"] > 0):
        raise AssertionError("tiny Vicuna check (logits, generate)")
    del gpu
    calib = [dict(image=torch.randn(4, 28, 28, 3, generator=g),
                  text_input_ids=torch.randint(3, 96, (4, 6), generator=g),
                  text_attention_mask=torch.tensor([[1] * 6] * 3
                                                   + [[1] * 4 + [0] * 2]),
                  labels=torch.randint(3, 96, (4, 6), generator=g),
                  qformer_input_ids=torch.randint(2, 64, (4, 5), generator=g),
                  qformer_attention_mask=torch.ones(4, 5, dtype=torch.int32))
             for _ in range(2)]
    # the Vicuna grid's Wanda and DSnoT entries (DSnoT at a low update
    # threshold, which keeps its loop cycling at this model's scale)
    for name, kw in (("blipt5_wanda_pruner", {}),
                     ("blipt5_dsnot_pruner", dict(update_threshold=1e-4))):
        masks, cycles = [], []
        for dev in ("cpu", "cuda"):
            model = copy.deepcopy(dense).to(dev)
            with torch.no_grad(), dsnot_tally() as tally:
                load_pruner(name, model, calib,
                            vit_prune_spec="2-0.5-1.0-1.0",
                            t5_prune_spec="2-0.5-1.0-1.0", num_samples=8,
                            t5_model_prefix="llm_model",
                            **kw).prune(lora_model=True)
            masks.append(export_masks(model))
            cycles.append(tally["cycles"])
            del model
        differ = sum(int((masks[0][p] != masks[1][p]).sum())
                     for p in masks[0])
        log(f"  tiny fp32 InstructBLIP-Vicuna {name} (ViT + llm_model), "
            f"card vs CPU: {len(masks[1])} masks, {differ} bits differ; "
            f"DSnoT cycles by linear, card {cycles[1]}, CPU {cycles[0]}")
        if set(masks[0]) != set(masks[1]) or differ \
                or len(masks[0]) != 2 * 4 + 2 * 7 or cycles[0] != cycles[1] \
                or (name == "blipt5_dsnot_pruner"
                    and len(cycles[0]) != len(masks[0])):
            raise AssertionError(f"tiny Vicuna check ({name} masks)")

class RetrievalLoader:
    """A retrieval eval loader: batches of ``batch`` images (the last one
    ragged), the dataset (captions, ``txt2img``, ``img2txt``) on
    ``.dataset``."""

    def __init__(self, images, text, per_image: int, batch: int):
        self.images, self.batch = images, batch
        self.dataset = type("RetrievalSet", (), {})()
        self.dataset.text = text
        self.dataset.txt2img = [t // per_image for t in range(len(text))]
        self.dataset.img2txt = {
            i: list(range(i * per_image, (i + 1) * per_image))
            for i in range(len(images))}

    def __iter__(self):
        return iter({"image": self.images[s:s + self.batch]}
                    for s in range(0, len(self.images), self.batch))


def retrieval_captions(n: int, rng: random.Random, shortest: int,
                       longest: int) -> list:
    """n seeded captions of shortest-longest words (the first one the
    longest)."""
    words = sorted({w for group in VQA_WORDS.values() for phrase in group
                    for w in phrase.split()})
    return [" ".join(rng.choices(words, k=longest if i == 0 else
                                 rng.randint(shortest, longest)))
            for i in range(n)]


def tiny_retrieval_check():
    """A tiny float32 stage-1 Blip2Qformer with random masks on every
    linear, on the card (kernels) vs on the CPU (plain versions), through
    ``RetrievalTask`` at k_test 2 over 6 images in batches of 4 and 12
    captions: the score matrices within 1e-4, the entries the rerank moved
    (those off the k_test-0 ITC score) the same, the metrics equal."""
    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
    )
    from vlm_compression_tpu_torch.models.blip2_qformer import (
        Blip2Qformer,
        Blip2QformerConfig,
    )
    from vlm_compression_tpu_torch.models.bridge import random_init_
    from vlm_compression_tpu_torch.models.eva_vit import EvaViTConfig
    from vlm_compression_tpu_torch.models.layers import SparseLinear
    from vlm_compression_tpu_torch.models.qformer import QFormerConfig
    from vlm_compression_tpu_torch.tasks.retrieval import RetrievalTask

    cfg = Blip2QformerConfig.tiny(
        vit=EvaViTConfig.tiny(param_dtype="float32", dtype="float32"),
        qformer=QFormerConfig.tiny(dtype="float32"))
    cpu = random_init_(Blip2Qformer(cfg, device="cpu"), seed=13, std=0.2)
    g = torch.Generator().manual_seed(13)
    for mod in cpu.modules():
        if isinstance(mod, SparseLinear):
            mod.mask = torch.rand(mod.kernel.shape, generator=g) < 0.6
    gpu = copy.deepcopy(cpu).to("cuda")
    images = torch.randn(6, 28, 28, 3, generator=g)
    text = retrieval_captions(12, random.Random(13), 2, 9)
    tok = SimpleTokenizer(cfg.qformer.vocab_size)
    res, launched = {}, {}
    for side, model, dev in (("cpu", cpu, "cpu"), ("card", gpu, "cuda")):
        loader = RetrievalLoader(images.to(dev), text, 2, 4)
        reset_counts()
        res[side] = [RetrievalTask(k_test=k, tokenizer=tok).evaluation(
            model, loader) for k in (0, 2)]
        launched[side] = read_counts()
    moved = {side: [r[1][key] != r[0][key] for key in ("score_i2t",
                                                      "score_t2i")]
             for side, r in res.items()}
    err = max(float(abs(res["card"][i][key] - res["cpu"][i][key]).max())
              for i in (0, 1) for key in ("score_i2t", "score_t2i"))
    with tempfile.TemporaryDirectory(prefix="tiny_retrieval_") as tmp:
        metrics = {side: RetrievalTask().after_evaluation(
            r[1], result_dir=os.path.join(tmp, side, "result"))
            for side, r in res.items()}
    same_moved = all((a == b).all() for a, b in zip(moved["cpu"],
                                                    moved["card"]))
    c = launched["card"]
    log(f"  tiny fp32 Blip2Qformer RetrievalTask k_test 0 and 2, card vs "
        f"CPU: score matrices max_abs_err={err:.3e} (tol 1e-4); the "
        f"reranked entries the same {same_moved} "
        f"({[int(x.sum()) for x in moved['card']]} of "
        f"{[x.size for x in moved['card']]}); metrics equal "
        f"{metrics['cpu'] == metrics['card']} {json.dumps(metrics['card'])}"
        f"; masked_matmul launches {c['masked_matmul']}, attention "
        f"forwards {c['flash_attention']}")
    if not (err <= 1e-4 and same_moved
            and all(int(x.sum(1).min()) == int(x.sum(1).max()) == 2
                    for x in moved["card"])
            and metrics["cpu"] == metrics["card"]
            and c["masked_matmul"] > 0 and c["flash_attention"] > 0):
        raise AssertionError("tiny retrieval check")


def vicuna_path():
    """Full-width InstructBLIP-Vicuna-7B (bf16, seeded random weights, seed
    VICUNA_SEED, after the XL models are freed), through the entry points a
    user calls: ``blipt5_wanda_pruner`` with ``t5_model_prefix=llm_model``
    over the ViT and LLaMA on N_CALIB synthetic samples at batch BS (masks
    kept; each tower at 0.5 ± 0.01); beam-5 ``generate_vicuna`` on N_REQ
    left-padded requests, cold and warm (tokens equal); the GQA task cold
    and warm (warm: a ground truth of each even question's own cold answer
    → exactly 50.00) and OK-VQA with the lemmatizer (the VQAv2 accuracy's
    closed form) at the Vicuna eval yamls' settings, the answers equal to
    a direct ``generate_vicuna``'s decoded tokens; every shape launched one
    that phase 3 checked, each phase's kernels launched and no WMMA-loop
    launch; one GQA pass profiled; then the retrain (``vicuna_retrain``)
    and, on a dense model rebuilt once that one is freed, the DSnoT grid
    entry (``vicuna_dsnot``).  Returns (launches by phase, numbers)."""
    from torch.profiler import ProfilerActivity, profile

    from vlm_compression_tpu_torch.compression import load_pruner
    from vlm_compression_tpu_torch.datasets.tokenization import batch_encode
    from vlm_compression_tpu_torch.evaluation.lemmatize import lemmatize
    from vlm_compression_tpu_torch.models.blip2_vicuna_instruct import (
        generate_vicuna,
    )
    from vlm_compression_tpu_torch.models.factory import build_model
    from vlm_compression_tpu_torch.models.generation import GenerationConfig
    from vlm_compression_tpu_torch.tasks.vqa import GQATask, VQATask

    t0 = time.perf_counter()
    # with the retrain's adapters (B = 0: the masked forward ignores them,
    # and the base weights are drawn as without them)
    model = build_model(dict(VICUNA_MODEL, **LORA), seed=VICUNA_SEED)
    cfg, llm = model.cfg, model.cfg.llm
    g = torch.Generator(device="cuda").manual_seed(42 + VICUNA_SEED)
    batches = vicuna_batches(cfg, N_CALIB // BS, BS, g)
    img = cfg.vit.img_size
    # N_REQ prompts of TXT tokens, BOS first; request 1 left-padded by 7
    prompt_mask = torch.ones(N_REQ, TXT, dtype=torch.int32, device="cuda")
    prompt_mask[1, :7] = 0
    prompt = torch.randint(3, llm.vocab_size, (N_REQ, TXT), generator=g,
                           device="cuda") * prompt_mask
    prompt[0, 0] = prompt[2, 0] = prompt[3, 0] = prompt[1, 7] = \
        llm.bos_token_id
    req = (torch.randn(N_REQ, img, img, 3, generator=g, device="cuda"),
           prompt, prompt_mask,
           torch.randint(3, 2000, (N_REQ, TXT), generator=g, device="cuda"),
           torch.ones(N_REQ, TXT, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for n, p in model.named_parameters()
                   if "lora_" not in n)
    n_lora = sum(p.numel() for n, p in model.named_parameters()
                 if "lora_" in n)
    log(f"  model: InstructBLIP-Vicuna-7B, {n_params / 1e9:.3f} B params + "
        f"{n_lora / 1e6:.3f} M LoRA (tune_opt=LVQ, r 4/8/2), bf16, random "
        f"init + data {time.perf_counter() - t0:.1f} s; cuts: "
        f"none (depth {cfg.vit.depth}/{cfg.qformer.num_layers}/"
        f"{llm.num_layers}, {N_CALIB} calibration samples)")
    counts, shapes, secs, peaks = {}, {}, {}, {}

    def start():
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    def end(phase):
        counts[phase] = read_counts()
        shapes[phase] = read_shapes()
        peaks[phase] = torch.cuda.max_memory_allocated()

    # --- the Wanda prune, ViT then llm_model
    pruner = load_pruner(
        "blipt5_wanda_pruner", model, batches,
        vit_prune_spec=f"{cfg.vit.depth}-0.5-1.0-1.0",
        t5_prune_spec=f"{llm.num_layers}-0.5-1.0-1.0", num_samples=N_CALIB,
        t5_model_prefix="llm_model")
    start()
    timed("vicuna_prune", lambda: pruner.prune(lora_model=True))
    end("vicuna_prune")
    del batches, pruner
    n_masked = 0
    density = tower_density(model, towers=("visual_encoder", "llm_model"))
    for tower, (dens, n_lin) in density.items():
        n_masked += n_lin
        log(f"  vicuna prune density {tower}: {dens:.4f} over {n_lin} "
            f"linears")
        if abs(dens - 0.5) > 0.01:
            raise AssertionError(f"vicuna density {tower}")
    if n_masked != cfg.vit.depth * 4 + llm.num_layers * 7:
        raise AssertionError(f"{n_masked} masked linears")
    log(f"  vicuna prune (blipt5_wanda_pruner, t5_model_prefix=llm_model, "
        f"lora_model=True): {secs['vicuna_prune']:.2f} s, peak "
        f"{peaks['vicuna_prune'] / 2**30:.2f} GiB; attention "
        f"{attn_routes(counts['vicuna_prune'])}")

    # --- beam-5 generate on N_REQ requests, cold then warm
    gen_cfg = GenerationConfig(num_beams=5, max_length=10, min_length=1,
                               eos_token_id=llm.eos_token_id,
                               pad_token_id=llm.pad_token_id)
    outs = {}
    for phase in ("generate_vicuna_cold", "generate_vicuna_warm"):
        start()
        outs[phase] = timed(phase, lambda: generate_vicuna(
            model, *req, gen_cfg=gen_cfg)).cpu()
        end(phase)
    seqs = outs["generate_vicuna_warm"]
    if tuple(seqs.shape) != (N_REQ, gen_cfg.max_length) \
            or not torch.equal(seqs[:, 0], prompt[:, -1].int().cpu()) \
            or not bool(((seqs >= 0) & (seqs < llm.vocab_size)).all()):
        raise AssertionError(f"bad generate_vicuna output {seqs}")
    if not torch.equal(outs["generate_vicuna_cold"], seqs):
        raise AssertionError("two generate_vicuna calls on the same inputs "
                             "differ")
    n_tok = int((seqs[:, 1:] != gen_cfg.pad_token_id).sum())
    for phase in outs:
        log(f"  generate_vicuna beam-5 ({phase}), {N_REQ} requests, "
            f"max_length 10: {secs[phase]:.3f} s, {n_tok} tokens, "
            f"{n_tok / secs[phase]:.1f} tokens/s, peak "
            f"{peaks[phase] / 2**30:.2f} GiB; attention "
            f"{attn_routes(counts[phase])}")
    log(f"  tokens (first column: each prompt's last token): "
        f"{seqs.tolist()}; equal cold vs warm")

    # --- GQA cold and warm, OK-VQA, through the tasks
    n = VQA_RUN["batch_size_eval"]
    beams = VQA_RUN["num_beams"]
    samples = vqa_samples(cfg, n)
    toks = vicuna_tokenizers(cfg)
    tok = toks["tokenizer"]
    tmp = tempfile.TemporaryDirectory(prefix="vicuna_vqa_")
    try:
        gqa = GQATask.setup_task(dict(run=VQA_RUN, model=VICUNA_MODEL),
                                 **toks)
        start()
        cold = timed("vicuna_gqa_cold",
                     lambda: gqa.evaluation(model, [samples]))
        answers = [r["answer"] for r in cold]
        scored = dict(samples, answers=[
            [a] if i % 2 == 0 else [NEVER] for i, a in enumerate(answers)])
        warm = timed("vicuna_gqa_warm",
                     lambda: gqa.evaluation(model, [scored]))
        end("vqa_vicuna_gqa")
        if [r["answer"] for r in warm] != answers:
            raise AssertionError("Vicuna GQA: the warm pass answered "
                                 "otherwise")
        gqa_metrics = gqa.after_evaluation(
            warm, split_name="val",
            result_dir=os.path.join(tmp.name, "gqa", "result"))
        log(f"  vicuna gqa: {n} questions, beam {beams}, max_len "
            f"{VQA_RUN['max_len']}: cold {secs['vicuna_gqa_cold']:.3f} s, "
            f"warm {secs['vicuna_gqa_warm']:.3f} s "
            f"({n / secs['vicuna_gqa_warm']:.1f} questions/s), peak "
            f"{peaks['vqa_vicuna_gqa'] / 2**30:.2f} GiB; answers equal cold "
            f"vs warm; {sum(a == '' for a in answers)} empty; metrics "
            f"{json.dumps(gqa_metrics)}; e.g. "
            f"{json.dumps(dict(zip(samples['text_input'][:3], answers)))}")
        if gqa_metrics["acc"] != 50.0 or gqa_metrics["agg_metrics"] != 50.0:
            raise AssertionError(f"Vicuna GQA accuracy {gqa_metrics}, not "
                                 "50.00")
        # the task adds no drift: a direct generate_vicuna on the prompts
        # encoded as the task encodes them (left-padded, BOS first),
        # decoded by hand after the seed column
        prompts = [VQA_PROMPT.format(q) for q in samples["text_input"]]
        ids, mask = batch_encode(tok, prompts, 128, left_pad=True,
                                 add_bos=True)
        enc = [torch.from_numpy(a).cuda() for a in (
            ids, mask, *batch_encode(toks["qformer_tokenizer"], prompts,
                                     128))]
        direct_seqs = generate_vicuna(
            model, samples["image"], *enc, gen_cfg=GenerationConfig(
                num_beams=beams, max_length=VQA_RUN["max_len"] + 1,
                min_length=VQA_RUN["min_len"],
                eos_token_id=llm.eos_token_id)).cpu()
        direct = []
        for row in direct_seqs[:, 1:].tolist():
            row = row[:row.index(tok.eos_token_id)] \
                if tok.eos_token_id in row else row
            direct.append(tok.decode(row).strip())
        pads = sorted(set((ids.shape[1] - mask.sum(1)).tolist()))
        log(f"  vicuna gqa prompts: {tuple(ids.shape)} (the prime holds "
            f"{cfg.qformer.num_query_tokens} + {ids.shape[1] - 1} slots, "
            f"pads per prompt {pads}); answers equal to a direct "
            f"generate_vicuna's {direct == answers}")
        if direct != answers:
            raise AssertionError("the Vicuna GQA task's answers differ from "
                                 "a direct generate_vicuna's decoded tokens")

        okvqa = VQATask.setup_task(dict(run=VQA_RUN,
                                        model=VICUNA_OKVQA_MODEL), **toks)
        lemmas = lemmatize(answers)
        ks = [i % 11 for i in range(n)]
        scored = dict(samples, answers=[[a] * k + [NEVER] * (10 - k)
                                        for a, k in zip(lemmas, ks)])
        start()
        ok = timed("vicuna_okvqa", lambda: okvqa.evaluation(model, [scored]))
        end("vqa_vicuna_okvqa")
        ok_metrics = okvqa.after_evaluation(
            ok, split_name="test",
            result_dir=os.path.join(tmp.name, "okvqa", "result"))
        want = round(100 * sum(map(vqa_closed_form, ks)) / n, 2)
        log(f"  vicuna okvqa (apply_lemmatizer={okvqa.apply_lemmatizer}): "
            f"{secs['vicuna_okvqa']:.3f} s, peak "
            f"{peaks['vqa_vicuna_okvqa'] / 2**30:.2f} GiB; metrics "
            f"{json.dumps(ok_metrics)}, closed form {want}")
        if not okvqa.apply_lemmatizer \
                or [r["answer"] for r in ok] != lemmas \
                or ok_metrics["overall"] != want:
            raise AssertionError(f"Vicuna OK-VQA {ok_metrics} against {want}")
    finally:
        tmp.cleanup()
    tally = shapes["vqa_vicuna_gqa"]["matmul"]
    log(f"  vicuna gqa, the M = {n * beams} beam-decode steps' matmul "
        f"launches by shape, beside plan's loop and splits: "
        f"{json.dumps(decode_step_routes(tally, n * beams))}")
    log(f"  launches: {json.dumps(counts)}")
    check_phase_counts(counts)
    check_shapes(shapes, "vicuna")

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gqa.evaluation(model, [samples])
        torch.cuda.synchronize()
    dev_ms, groups = device_breakdown(
        prof, 1e3 * secs["vicuna_gqa_warm"],
        f"vicuna gqa, {n} questions, beam {beams}")
    log(f"  vicuna gqa profiled pass: peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    retrain = vicuna_retrain(model, req, gen_cfg, counts, shapes, secs)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    dsnot_counts, dsnot = vicuna_dsnot(req, gen_cfg)
    counts.update(dsnot_counts)
    return counts, {
        **retrain, **dsnot,
        "vicuna_prune_s": secs["vicuna_prune"],
        "vicuna_generate_cold_s": secs["generate_vicuna_cold"],
        "vicuna_generate_s": secs["generate_vicuna_warm"],
        "vicuna_tokens_per_s": n_tok / secs["generate_vicuna_warm"],
        "vicuna_gqa_cold_s": secs["vicuna_gqa_cold"],
        "vicuna_gqa_warm_s": secs["vicuna_gqa_warm"],
        "vicuna_gqa_acc": gqa_metrics["acc"],
        "vicuna_okvqa_s": secs["vicuna_okvqa"],
        "vicuna_okvqa_acc": ok_metrics["overall"],
        "vicuna_gqa_device_ms": dev_ms,
        "vicuna_peak_bytes": {k: v for k, v in peaks.items()}}


def vicuna_retrain(model, req, gen_cfg, counts, shapes, secs) -> dict:
    """RESSA retraining of the pruned InstructBLIP-Vicuna-7B (the main
    path's ``run_retrain`` and its gates, on batches collated by
    ``make_vicuna_batch_preparer``: LLaMA at n = m = 72, d = 128 on the
    mma.sync backward), one more KD step profiled (busy share, device time
    by kernel group), the sparse merge (each tower zero off its masks, at
    0.5 ± 0.01), and beam-5 ``generate_vicuna`` on the merged model.  Adds
    its phases to ``counts`` / ``shapes`` and checks them (launch gates;
    every shape launched, backward and sparse-LoRA included, one that
    phase 3 held against its plain version); returns the numbers."""
    from torch.profiler import ProfilerActivity, profile

    from vlm_compression_tpu_torch.models.blip2_vicuna_instruct import (
        generate_vicuna,
    )
    from vlm_compression_tpu_torch.tasks.retrain import (
        RessaTrainState,
        make_kd_train_step,
    )

    cfg = model.cfg
    batches = vicuna_train_batches(cfg, 2 + N_TIMED_STEPS, TRAIN_BS, seed=7)
    extra = batches.pop()
    reset_counts()
    out = run_retrain(model, batches, prefix="vicuna_retrain")
    counts["vicuna_retrain"] = read_counts()
    shapes["vicuna_retrain"] = read_shapes()
    log(f"  vicuna retrain attention per step, by route: "
        f"{attn_routes(counts['vicuna_retrain'], 1 + N_TIMED_STEPS + N_REPLAY)}")
    state = RessaTrainState.create(model, weight_decay=WEIGHT_DECAY)
    step = make_kd_train_step(model, state.opt, KL_WEIGHT, T_KD)
    step(batches[0], 1e-6)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(extra, 1e-6)
        torch.cuda.synchronize()
    dev_ms, _ = device_breakdown(prof, 1e3 * out["vicuna_retrain_s_per_step"],
                                 "vicuna retrain step")
    state.opt.zero_grad(set_to_none=True)
    del state, step, batches, extra, prof
    gc.collect()
    torch.cuda.empty_cache()
    merge_and_check(model, towers=("visual_encoder", "llm_model"))
    reset_counts()
    t0 = time.perf_counter()
    seqs = generate_vicuna(model, *req, gen_cfg=gen_cfg).cpu()
    torch.cuda.synchronize()
    secs["generate_vicuna_merged"] = time.perf_counter() - t0
    counts["generate_vicuna_merged"] = read_counts()
    shapes["generate_vicuna_merged"] = read_shapes()
    if tuple(seqs.shape) != (N_REQ, gen_cfg.max_length) \
            or not torch.equal(seqs[:, 0], req[1][:, -1].int().cpu()) \
            or not bool(((seqs >= 0) & (seqs < cfg.llm.vocab_size)).all()):
        raise AssertionError(f"bad merged generate_vicuna output {seqs}")
    log(f"  generate_vicuna beam-5 from the merged model: "
        f"{secs['generate_vicuna_merged']:.3f} s, tokens {seqs.tolist()}")
    phases = ("vicuna_retrain", "generate_vicuna_merged")
    log(f"  launches: {json.dumps({p: counts[p] for p in phases})}")
    check_phase_counts({p: counts[p] for p in phases})
    check_shapes({p: shapes[p] for p in phases}, "vicuna retrain")
    return {**out, "vicuna_retrain_device_ms": dev_ms,
            "vicuna_generate_merged_s": secs["generate_vicuna_merged"]}


def vicuna_dsnot(req, gen_cfg) -> tuple:
    """The Vicuna grid's DSnoT entry (scripts/vicuna/dsnot.py's defaults:
    keep 0.5 in the ViT and in LLaMA, unstructured, the wanda initial
    metric) through ``blipt5_dsnot_pruner`` with
    ``t5_model_prefix=llm_model``, masks kept, on a dense
    InstructBLIP-Vicuna-7B rebuilt from VICUNA_SEED once the retrained one
    is freed (the same base weights, no adapters: the random init takes
    under a second on the card, where a pinned host copy of the 380
    prunable kernels would hold 15 GB of host memory, and the retrain has
    merged its adapters into those kernels), on the Wanda prune's
    N_CALIB samples at batch BS; then beam-5 ``generate_vicuna`` on the
    N_REQ requests.  Gates: each tower 0.5 ± 0.01, a finite loss, every
    prunable linear refined once (its cycles, host syncs and seconds
    recorded as grid_path records them), the phases' launch tables and
    every shape launched one that phase 3 held."""
    from vlm_compression_tpu_torch.compression import load_pruner
    from vlm_compression_tpu_torch.models.blip2_vicuna_instruct import (
        generate_vicuna,
    )
    from vlm_compression_tpu_torch.models.factory import build_model

    t0 = time.perf_counter()
    model = build_model(VICUNA_MODEL, seed=VICUNA_SEED)
    cfg, llm = model.cfg, model.cfg.llm
    # the draws of vicuna_path: the same calibration batches
    batches = vicuna_batches(
        cfg, N_CALIB // BS, BS,
        torch.Generator(device="cuda").manual_seed(42 + VICUNA_SEED))
    torch.cuda.synchronize()
    log(f"  vicuna dsnot: the dense model rebuilt from seed {VICUNA_SEED} "
        f"(no adapters) + data {time.perf_counter() - t0:.1f} s")
    rec = new_record()
    pruner = load_pruner(
        "blipt5_dsnot_pruner", model, batches,
        vit_prune_spec=f"{cfg.vit.depth}-0.5-1.0-1.0",
        t5_prune_spec=f"{llm.num_layers}-0.5-1.0-1.0", num_samples=N_CALIB,
        t5_model_prefix="llm_model")
    with dsnot_tally() as tally:
        run_phase(rec, "vicuna_dsnot_prune",
                  lambda: pruner.prune(lora_model=True))
    secs, peaks = rec["secs"], rec["peaks"]
    n_lin = cfg.vit.depth * 4 + llm.num_layers * 7
    e2e = log_dsnot_tally(tally, secs["vicuna_dsnot_prune"], n_lin,
                          prefix="vicuna_dsnot")
    density = tower_density(model, towers=("visual_encoder", "llm_model"))
    with torch.no_grad():
        loss = float(model(**batches[0])["loss"])
    log(f"  vicuna dsnot prune (blipt5_dsnot_pruner, t5_model_prefix="
        f"llm_model, lora_model=True): {secs['vicuna_dsnot_prune']:.2f} s, "
        f"peak {peaks['vicuna_dsnot_prune'] / 2**30:.2f} GiB; density by "
        f"tower {json.dumps({t: round(d, 5) for t, (d, _) in density.items()})}"
        f" over {json.dumps({t: n for t, (_, n) in density.items()})} "
        f"linears; loss on a calibration batch {loss:.4f}; attention "
        f"{attn_routes(rec['counts']['vicuna_dsnot_prune'])}")
    if any(abs(d - 0.5) > 0.01 for d, _ in density.values()) \
            or sum(n for _, n in density.values()) != n_lin \
            or loss != loss or abs(loss) == float("inf"):
        raise AssertionError(f"vicuna dsnot: {density} {loss}")
    del batches, pruner
    seqs = run_phase(rec, "generate_vicuna_dsnot", lambda: generate_vicuna(
        model, *req, gen_cfg=gen_cfg)).cpu()
    if tuple(seqs.shape) != (N_REQ, gen_cfg.max_length) \
            or not torch.equal(seqs[:, 0], req[1][:, -1].int().cpu()) \
            or not bool(((seqs >= 0) & (seqs < llm.vocab_size)).all()):
        raise AssertionError(f"bad generate_vicuna output after DSnoT {seqs}")
    log(f"  generate_vicuna beam-5 after the DSnoT prune: "
        f"{secs['generate_vicuna_dsnot']:.3f} s, tokens {seqs.tolist()}")
    log(f"  launches: {json.dumps(rec['counts'])}")
    check_phase_counts(rec["counts"])
    check_shapes(rec["shapes"], "vicuna dsnot")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec["counts"], {
        **e2e, "vicuna_dsnot_prune_s": secs["vicuna_dsnot_prune"],
        "vicuna_dsnot_peak_bytes": peaks["vicuna_dsnot_prune"],
        "vicuna_dsnot_loss": loss,
        "vicuna_generate_dsnot_s": secs["generate_vicuna_dsnot"]}


# the retrieval path (retrieval_path): the stage-1 Q-Former as
# configs/projects/eval/ret_flickr_eval.yaml evaluates it (model: arch
# blip2, model_type coco; run: batch_size_eval 64, k_test 128; the task
# clips captions at 35 tokens; ret_coco_eval.yaml the same), its ViT pruned
# first by vit_wanda_pruner at 39-0.5-1.0-1.0 on N_CALIB synthetic images
# at batch BS; seed 5.  The cut: 160 synthetic 224² images and 800
# captions of 8-40 words, 5 an image as in Flickr30k, where the test
# splits hold the sizes of RET_FULL, to which the readings extrapolate
RETRIEVAL_MODEL = dict(arch="blip2", model_type="coco")
RETRIEVAL_RUN = dict(task="retrieval", batch_size_eval=64, k_test=128)
RETRIEVAL_SEED = 5
N_RET_IMAGES, RET_PER_IMAGE, RET_WORDS = 160, 5, (8, 40)
RET_FULL = {"flickr30k_test": (1000, 5000), "coco_5k_test": (5000, 25000)}


def retrieval_path() -> tuple:
    """The stage-1 Q-Former's retrieval eval through the task's entry
    points at ret_flickr_eval.yaml's settings: ``vit_wanda_pruner`` on
    the full-width model's ViT (masks kept; 0.5 ± 0.01), then
    ``RetrievalTask`` (ITC ranking + the ITM rerank of each row's top
    k_test) cold and warm (score matrices bit-equal), at k_test 0 (the ITC
    pass alone: score_i2t == score_t2i.T; the rerank moved exactly the
    top-min(k, n) entries of each row off it and left the rest), and a
    direct ``compute_sim_matrix`` (bit-equal to the task's; a second warm
    wall-clock); the image and caption branches timed alone; the ITM rows
    of one image batch (as compute_sim_matrix makes them) under the
    profiler: device ms an ITM call; R@1/5/10 both ways exactly 10/50/100
    against a ground truth taken from the warm scores' own order (image
    i's caption at rank i mod 10, caption t's image at rank t mod 10);
    every shape launched one that phase 3 held.  Returns (launches by
    phase, readings with the full test splits extrapolated: at the ITM
    call's device time, and at its two wall-clocks)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from vlm_compression_tpu_torch.compression import load_pruner
    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
        batch_encode,
    )
    from vlm_compression_tpu_torch.models.blip2_qformer import (
        compute_sim_matrix,
    )
    from vlm_compression_tpu_torch.models.factory import build_model
    from vlm_compression_tpu_torch.tasks.retrieval import RetrievalTask

    t0 = time.perf_counter()
    model = build_model(RETRIEVAL_MODEL, seed=RETRIEVAL_SEED)
    cfg = model.cfg
    img = cfg.vit.img_size
    g = torch.Generator(device="cuda").manual_seed(42 + RETRIEVAL_SEED)
    calib = [{"image": torch.randn(BS, img, img, 3, generator=g,
                                   device="cuda")}
             for _ in range(N_CALIB // BS)]
    images = torch.randn(N_RET_IMAGES, img, img, 3, generator=g,
                         device="cuda")
    text = retrieval_captions(N_RET_IMAGES * RET_PER_IMAGE,
                              random.Random(RETRIEVAL_SEED), *RET_WORDS)
    batch = RETRIEVAL_RUN["batch_size_eval"]
    loader = RetrievalLoader(images, text, RET_PER_IMAGE, batch)
    # the Q-Former's own vocabulary (torch raises on ids past it)
    tok = SimpleTokenizer(cfg.qformer.vocab_size)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model: stage-1 BLIP-2 Q-Former ({RETRIEVAL_MODEL}), "
        f"{n_params / 1e9:.3f} B params (ViT bf16, Q-Former and heads "
        f"fp32), random init + data {time.perf_counter() - t0:.1f} s; "
        f"cuts: {N_RET_IMAGES} images and {len(text)} captions (the test "
        f"splits: {json.dumps(RET_FULL)}), depth {cfg.vit.depth}/"
        f"{cfg.qformer.num_layers}")
    rec = new_record()
    counts, shapes, secs, peaks = (rec[k] for k in ("counts", "shapes",
                                                    "secs", "peaks"))
    run_phase(rec, "retrieval_prune", lambda: load_pruner(
        "vit_wanda_pruner", model.visual_encoder, calib,
        vit_prune_spec=f"{cfg.vit.depth}-0.5-1.0-1.0",
        num_samples=N_CALIB).prune(lora_model=True))
    del calib
    (dens, n_lin), = tower_density(model, towers=("visual_encoder",)
                                   ).values()
    log(f"  retrieval prune (vit_wanda_pruner, lora_model=True): "
        f"{secs['retrieval_prune']:.2f} s, peak "
        f"{peaks['retrieval_prune'] / 2**30:.2f} GiB; ViT density "
        f"{dens:.4f} over {n_lin} linears")
    if abs(dens - 0.5) > 0.01 or n_lin != cfg.vit.depth * 4:
        raise AssertionError(f"retrieval prune: density {dens} over {n_lin}")

    task = RetrievalTask.setup_task(dict(run=RETRIEVAL_RUN), tokenizer=tok)
    k = task.k_test
    cold = run_phase(rec, "retrieval_cold",
                     lambda: task.evaluation(model, loader))
    warm = run_phase(rec, "retrieval_warm",
                     lambda: task.evaluation(model, loader))
    itc = run_phase(rec, "retrieval_itc", lambda: RetrievalTask(
        k_test=0, tokenizer=tok).evaluation(model, loader))
    keys = ("score_i2t", "score_t2i")
    same = all(np.array_equal(cold[x], warm[x]) for x in keys)
    symmetric = np.array_equal(itc["score_i2t"], itc["score_t2i"].T)
    moved = {x: warm[x] != itc[x] for x in keys}
    topk = {x: all(set(np.flatnonzero(m).tolist())
                   == set(np.argsort(-row)[:k].tolist())
                   for m, row in zip(moved[x], itc[x])) for x in keys}
    per_row = {x: sorted(set(moved[x].sum(1).tolist())) for x in keys}
    want_rows = {x: [min(k, itc[x].shape[1])] for x in keys}
    log(f"  retrieval task (k_test {k}, batch_size_eval {batch}): "
        f"{N_RET_IMAGES} images x {len(text)} captions, cold "
        f"{secs['retrieval_cold']:.3f} s, warm {secs['retrieval_warm']:.3f} "
        f"s, peak {peaks['retrieval_warm'] / 2**30:.2f} GiB; cold == warm "
        f"{same}; at k_test 0: {secs['retrieval_itc']:.3f} s, score_i2t == "
        f"score_t2i.T {symmetric}; entries the rerank moved per row "
        f"{json.dumps(per_row)} (want {json.dumps(want_rows)}), each row's "
        f"ITC top-k {json.dumps(topk)}")
    if not (same and symmetric and per_row == want_rows
            and all(topk.values())):
        raise AssertionError("retrieval task: cold vs warm, the ITC pass or "
                             "the rerank")

    ids, mask = batch_encode(tok, text, task.max_txt_len)
    ids_d, mask_d = (torch.from_numpy(x).cuda() for x in (ids, mask))

    @torch.no_grad()
    def image_branch():
        for b in loader:
            model.forward_image(b["image"])

    @torch.no_grad()
    def caption_branch():
        for s in range(0, len(text), 256):
            model.forward_text(ids_d[s:s + 256], mask_d[s:s + 256])

    run_phase(rec, "retrieval_images", image_branch)
    run_phase(rec, "retrieval_captions", caption_branch)
    direct = run_phase(rec, "retrieval_direct", lambda: compute_sim_matrix(
        model, (b["image"] for b in loader), ids, mask, k_test=k))
    as_task = all(np.array_equal(d, warm[x]) for d, x in zip(direct, keys))
    log(f"  retrieval: captions padded to {ids.shape[1]} tokens; a direct "
        f"compute_sim_matrix {secs['retrieval_direct']:.3f} s, equal to the "
        f"task's {as_task}")
    if not as_task or ids.shape[1] != min(task.max_txt_len, RET_WORDS[1]):
        raise AssertionError("retrieval: the task's scores differ from a "
                             "direct compute_sim_matrix's")

    # the ITM rows of one image batch under the profiler, as
    # compute_sim_matrix makes them (the ITC top-k captions of each image
    # at b = k): device time an ITM call
    first = next(iter(loader))["image"]
    top = torch.from_numpy(np.stack([
        np.argsort(-row)[:k] for row in itc["score_i2t"][:len(first)]]))
    top = top.cuda()
    with torch.no_grad():
        embeds = model.image_embeds(first)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i, t in enumerate(top):
                model.itm_logits(embeds[i:i + 1].expand(k, -1, -1),
                                 ids_d[t], mask_d[t])
            torch.cuda.synchronize()
    n_itm = N_RET_IMAGES + len(text)
    itm_ms = {x: 1e3 * (secs[x] - secs["retrieval_itc"]) / n_itm
              for x in ("retrieval_warm", "retrieval_direct")}
    dev_ms, _ = device_breakdown(
        prof, len(top) * itm_ms["retrieval_warm"],
        f"retrieval: {len(top)} ITM calls at b = {k} (the wall: the warm "
        f"pass's ms a call)")
    itm_dev_ms = dev_ms / len(top)
    del prof, embeds

    # R@k at a closed form: the ground truth read off the warm scores in
    # itm_eval's own order
    gt = dict(warm, img2txt={
        i: [int(np.argsort(row)[::-1][i % 10])]
        for i, row in enumerate(warm["score_i2t"])},
        txt2img=[int(np.argsort(row)[::-1][t % 10])
                 for t, row in enumerate(warm["score_t2i"])])
    with tempfile.TemporaryDirectory(prefix="retrieval_") as tmp:
        flickr = task.after_evaluation(
            cold, result_dir=os.path.join(tmp, "flickr", "result"))
        closed = task.after_evaluation(
            gt, result_dir=os.path.join(tmp, "closed", "result"))
        with open(os.path.join(tmp, "closed", "evaluate.txt")) as fh:
            logged = json.loads(fh.read())
    want = {f"{d}_r{r}": v for d in ("txt", "img")
            for r, v in ((1, 10.0), (5, 50.0), (10, 100.0))}
    log(f"  retrieval metrics: against the 5-captions-an-image ground truth "
        f"{json.dumps(flickr)}; against the closed-form ground truth "
        f"{json.dumps(closed)} (want {json.dumps(want)})")
    if any(closed[x] != v for x, v in want.items()) \
            or logged != {"test": closed}:
        raise AssertionError(f"retrieval metrics {closed}")
    log(f"  launches: {json.dumps(counts)}")
    check_phase_counts(counts)
    check_shapes(shapes, "retrieval")

    img_rate = N_RET_IMAGES / secs["retrieval_images"]
    cap_rate = len(text) / secs["retrieval_captions"]
    walls = sorted(itm_ms.values())

    def extrapolate(ms):
        return {name: ni / img_rate + nt / cap_rate + (ni + nt) * ms / 1e3
                for name, (ni, nt) in RET_FULL.items()}

    full, lo, hi = (extrapolate(x) for x in (itm_dev_ms, *walls))
    at_walls = {x: [round(lo[x], 1), round(hi[x], 1)] for x in full}
    log(f"  retrieval readings: ITC pass {secs['retrieval_itc']:.3f} s; "
        f"{n_itm} ITM calls at b = {k}: {itm_dev_ms:.3f} ms of device time a "
        f"call, {itm_ms['retrieval_warm']:.3f} ms of wall in the warm pass "
        f"and {itm_ms['retrieval_direct']:.3f} in the direct call (the "
        f"rerank {100 * itm_dev_ms / walls[1]:.1f}-"
        f"{100 * itm_dev_ms / walls[0]:.1f} % busy); "
        f"{N_RET_IMAGES / secs['retrieval_warm']:.1f} images/s and "
        f"{len(text) / secs['retrieval_warm']:.1f} captions/s end to end "
        f"(warm); the image branch {img_rate:.1f} images/s, the caption "
        f"branch {cap_rate:.1f} captions/s; extrapolated passes (s) at the "
        f"ITM call's device time "
        f"{json.dumps({x: round(v, 1) for x, v in full.items()})}, at its "
        f"walls {json.dumps(at_walls)}")
    del model, images, loader
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {
        "retrieval_prune_s": secs["retrieval_prune"],
        "retrieval_cold_s": secs["retrieval_cold"],
        "retrieval_warm_s": secs["retrieval_warm"],
        "retrieval_direct_s": secs["retrieval_direct"],
        "retrieval_itc_s": secs["retrieval_itc"],
        "retrieval_itm_ms": itm_ms["retrieval_warm"],
        "retrieval_itm_ms_direct": itm_ms["retrieval_direct"],
        "retrieval_itm_device_ms": itm_dev_ms,
        "retrieval_images_per_s": N_RET_IMAGES / secs["retrieval_warm"],
        "retrieval_captions_per_s": len(text) / secs["retrieval_warm"],
        "retrieval_image_branch_per_s": img_rate,
        "retrieval_caption_branch_per_s": cap_rate,
        "retrieval_peak_bytes": peaks["retrieval_warm"],
        **{f"retrieval_{x}_s": v for x, v in full.items()},
        **{f"retrieval_{x}_wall_s": [lo[x], hi[x]] for x in full}}


# the launcher's T5 grid point prune_and_eval("wanda", 0.5, 0.5)
# (scripts/launch_lib.py:41-84), composed for the port's CLI: its job id,
# specs, score method and granularity; --prune_batch_size and
# --num_data_for_prune at the CLI's defaults (1 and 128), as the launcher
# leaves them.  --seed 6 for the prune call's random init, 7 for the eval
# call's (which the checkpoint must overwrite whole)
CLI_SEED = 6
CLI_JOB = "prune-xl-wanda_0.5_0.5"
CLI_EVAL = "gqa_zeroshot_flant5xl_instruct_eval"
CLI_N_CALIB = 128
CLI_IMAGE = (256, 320)      # H × W, not square: the train crop resamples
CLI_N_GQA = 64              # one batch of the GQA yaml's batch_size_eval
CLI_TOWERS = ("visual_encoder", "t5_model.encoder", "t5_model.decoder")


def cli_data(root: str) -> tuple:
    """Seeded synthetic data under ``root``: CLI_N_CALIB uint8 images of
    CLI_IMAGE saved as .npy, each with one caption of CLI_WORDS words (the
    lengths in turn; CC3M's captions run about 10 words), and CLI_N_GQA
    more with vqa_path's questions.  Returns (the caption annotation file,
    the GQA one, the image root, the GQA annotations)."""
    import numpy as np

    rng = np.random.default_rng(CLI_SEED)
    wrng = random.Random(CLI_SEED)
    images = os.path.join(root, "images")
    os.makedirs(images)
    words = [w for group in ("noun", "rel", "answer")
             for phrase in VQA_WORDS[group] for w in phrase.split()]

    def image(name):
        np.save(os.path.join(images, name), rng.integers(
            0, 256, CLI_IMAGE + (3,), dtype=np.uint8))
        return name

    caps = [{"image": image(f"cc3m_{i}.npy"), "caption": " ".join(
        wrng.choice(words) for _ in range(CLI_WORDS[i % len(CLI_WORDS)]))}
        for i in range(CLI_N_CALIB)]
    gqa = [{"image": image(f"gqa_{i}.npy"), "question": q,
            "question_id": i, "answer": [NEVER]}
           for i, q in enumerate(vqa_questions(CLI_N_GQA))]
    paths = []
    for name, anns in (("cc3m_train.json", caps), ("gqa_val.json", gqa)):
        paths.append(os.path.join(root, name))
        with open(paths[-1], "w") as f:
            json.dump(anns, f)
    return paths[0], paths[1], images, gqa


def cli_densities(model) -> dict:
    """Each pruned tower's share of non-zero weights over its blocks'
    linears (no masks: the CLI's prune zeroes the weights)."""
    from vlm_compression_tpu_torch.models.layers import SparseLinear

    out = {}
    for tower in CLI_TOWERS:
        kept = total = n = 0
        for name, m in model.named_modules():
            if isinstance(m, SparseLinear) and \
                    name.startswith(tower + ".blocks_"):
                kept += int(m.kernel.count_nonzero())
                total += m.kernel.numel()
                n += 1
        out[tower] = (kept / total, n)
    return out


def cli_path() -> tuple:
    """The launcher's T5 grid point through the port's own CLI
    (``cli.evaluate.run`` on argv composed as scripts/launch_lib.py:41-84
    composes it, in this process), on full-width InstructBLIP-FlanT5-XL
    (seed 6) and seeded synthetic data: the prune call
    (prune_stage2_t5_instruct.yaml, ``blipt5_wanda_pruner``, specs
    39/24-0.5, 128 captioned 256 × 320 .npy images through
    ``blip2_image_train`` at batch 1, ``prune(lora_model=False)``, the
    state dict saved), a direct ``generate_t5`` of the pruned model over
    the 64 GQA questions (each even question's answer becomes its ground
    truth, the odd ones' is unreachable), then the eval call (the GQA
    instruct yaml, ``--pruned_checkpoint``).  Gates: the restored model
    equal to the pruned one tensor for tensor (``torch.equal``: the saved
    state dict round trip); each tower 0.5 ± 0.01 non-zero in the restored
    weights; GQA exactly 50.00 in ``eval_stats_<job>.json``; the eval
    call's answers equal to a direct ``generate_t5`` of the restored
    model; no linear kernel (no masks), attention on TMA + wgmma, every
    shape one phase 3 held; the checkpoint and the data deleted.  Returns
    (launches by phase, readings)."""
    import shutil

    from vlm_compression_tpu_torch.cli import evaluate as E
    from vlm_compression_tpu_torch.common.config import Config
    from vlm_compression_tpu_torch.datasets.builders import load_builder
    from vlm_compression_tpu_torch.models.model_zoo import (
        default_config_path,
    )

    rec = new_record()
    repo = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="cli_path_")
    try:
        t0 = time.perf_counter()
        cap_ann, gqa_ann, images, gqa = cli_data(root)
        data_s = time.perf_counter() - t0
        out = os.path.join(root, "output")
        cc3m = "datasets.prefix_conceptual_caption_3m.build_info"
        prune_argv = [
            "--cfg-path", os.path.join(
                repo, "configs/projects/eval/prune_stage2_t5_instruct.yaml"),
            "--prune", "--pruning_method", "blipt5_wanda_pruner",
            "--save_pruned_model", "--t5_prune_spec", "24-0.5-1.0-1.0",
            "--vit_prune_spec", "39-0.5-1.0-1.0", "--prune_n", "0",
            "--prune_m", "0", "--model_size", "xl", "--job_id", CLI_JOB,
            "--score_method", "obd_avg", "--sparsity_ratio_granularity",
            "none", "--seed", str(CLI_SEED), "--options",
            f"run.output_dir={out}/{CLI_JOB}",
            f"{cc3m}.annotations.train=[{cap_ann}]",
            f"{cc3m}.images.storage={images}", *CLI_OPTIONS, *CLI_ARGS]
        eval_job = f"{CLI_JOB}-{CLI_EVAL}"
        eval_options = [f"run.output_dir={out}/{eval_job}",
                        f"datasets.gqa.build_info.annotations.val=[{gqa_ann}]",
                        f"datasets.gqa.build_info.images.storage={images}",
                        *CLI_EVAL_OPTIONS]
        eval_cfg = os.path.join(repo, f"configs/projects/eval/{CLI_EVAL}.yaml")
        eval_argv = ["--cfg-path", eval_cfg, "--pruned_checkpoint",
                     f"{out}/{CLI_JOB}/pruned_{CLI_JOB}", "--job_id",
                     eval_job, "--seed", str(CLI_SEED + 1), "--options",
                     *eval_options, *CLI_ARGS]
        free = shutil.disk_usage(root).free
        log(f"  cli: data {data_s:.2f} s ({CLI_N_CALIB} + {CLI_N_GQA} "
            f"{CLI_IMAGE[0]} x {CLI_IMAGE[1]} .npy images); {free / 2**30:.1f} "
            f"GiB free under {tempfile.gettempdir()}; the prune call: "
            f"{' '.join(prune_argv)}")

        p_stats, p_runner, p_timer = run_phase(
            rec, "cli_prune", lambda: E.run(E.parse_args(prune_argv)))
        pruned = p_runner.model
        ckpt = p_stats["pruned_checkpoint"]
        ckpt_bytes = os.path.getsize(ckpt)

        # the ground truth: a direct generate of the pruned model over the
        # batch the eval call reads (its config, builder and processors)
        cfg = Config(cfg_path=eval_cfg, options=eval_options,
                     defaults=default_config_path)
        ds = load_builder("gqa", cfg.datasets_cfg["gqa"]).build_datasets()[
            "val"]
        samples = ds.collater([ds[i] for i in range(len(ds))])
        truth = run_phase(rec, "cli_truth",
                          lambda: direct_vqa_answers(pruned, samples)[0])
        for i, (ann, a) in enumerate(zip(gqa, truth)):
            ann["answer"] = [a] if i % 2 == 0 else [NEVER]
        with open(gqa_ann, "w") as f:
            json.dump(gqa, f)

        log(f"  cli: the eval call: {' '.join(eval_argv)}")
        e_stats, e_runner, e_timer = run_phase(
            rec, "cli_eval", lambda: E.run(E.parse_args(eval_argv)))
        restored = e_runner.model
        want, got = pruned.state_dict(), restored.state_dict()
        if list(got) != list(want) or not all(
                torch.equal(got[k], want[k]) for k in want):
            raise AssertionError("the restored model differs from the "
                                 "pruned one it was saved from")
        del pruned, p_runner, want
        gc.collect()
        torch.cuda.empty_cache()
        dens = cli_densities(restored)
        with open(os.path.join(out, eval_job,
                               f"eval_stats_{eval_job}.json")) as f:
            written = json.load(f)
        with open(os.path.join(out, eval_job, "result",
                               "val_vqa_result.json")) as f:
            answers = {r["question_id"]: r["answer"] for r in json.load(f)}
        direct = run_phase(rec, "cli_direct",
                           lambda: direct_vqa_answers(restored, samples)[0])
        metrics = written["eval_results"]["val"]
        times = {"prune call": {**p_timer.stats,
                                "wall": rec["secs"]["cli_prune"],
                                "prune_seconds": p_stats["prune_seconds"]},
                 "eval call": {**e_timer.stats,
                               "wall": rec["secs"]["cli_eval"]}}
        log(f"  cli: phase seconds and live GiB {json.dumps(times)}; "
            f"checkpoint {ckpt_bytes} bytes ({ckpt_bytes / 2**30:.3f} GiB); "
            f"peaks GiB "
            f"{json.dumps({p: round(b / 2**30, 2) for p, b in rec['peaks'].items()})}; "
            f"densities {json.dumps({t: round(d, 6) for t, (d, _) in dens.items()})}; "
            f"eval_stats {json.dumps(written)}; answers e.g. "
            f"{json.dumps([answers[i] for i in range(4)])}; the Wanda prune "
            f"at batch 1: {p_timer.stats['prune_seconds']} s (with the "
            f"calibration data's loading, eval_stats' prune_seconds: "
            f"{p_stats['prune_seconds']} s)")
        for phase in CLI_PHASES:
            c = rec["counts"][phase]
            log(f"  cli {phase}: {rec['secs'][phase]:.3f} s; linear kernels "
                f"{c['masked_matmul'] + c[WGMMA_LOOP] + c[DECODE]}; "
                f"attention {attn_routes(c)}")
        for tower, (d, n) in dens.items():
            if n == 0 or abs(d - 0.5) > 0.01:
                raise AssertionError(f"cli: {tower} density {d} over {n} "
                                     "linears")
        if written != json.loads(json.dumps(e_stats, default=str)) or \
                metrics["acc"] != 50.0 or metrics["agg_metrics"] != 50.0:
            raise AssertionError(f"cli: GQA {metrics}, not 50.00")
        if [answers[i] for i in range(CLI_N_GQA)] != direct:
            raise AssertionError("cli: the eval call's answers differ from a "
                                 "direct generate_t5 of the restored model")
        del restored, e_runner
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if os.path.exists(root):
        raise AssertionError(f"cli: {root} was not deleted")
    log(f"  cli: {root} (data and checkpoint) deleted")
    check_phase_counts(rec["counts"])
    check_shapes(rec["shapes"], "cli")
    gc.collect()
    torch.cuda.empty_cache()
    return rec["counts"], {
        "cli_prune_call_s": rec["secs"]["cli_prune"],
        "cli_eval_call_s": rec["secs"]["cli_eval"],
        "cli_wanda_b1_s": p_timer.stats["prune_seconds"],
        **{f"cli_prune_{k}": v for k, v in p_timer.stats.items()},
        **{f"cli_eval_{k}": v for k, v in e_timer.stats.items()},
        "cli_checkpoint_bytes": ckpt_bytes,
        "cli_gqa_acc": metrics["acc"],
        "cli_peak_bytes": max(rec["peaks"].values())}


# the CPU rehearsal's additions to both calls (empty on the card)
CLI_ARGS, CLI_OPTIONS, CLI_EVAL_OPTIONS = [], [], []


def profile_first_order(e2e):
    """The first-order path's two gradient phases again under
    torch.profiler (device activity only) on a fresh seed-2 model: the
    diagonal Fisher over 4 samples, then the EcoFLaP prune."""
    from torch.profiler import ProfilerActivity, profile

    from vlm_compression_tpu_torch.compression.derivatives import (
        get_data_derivative,
    )

    _, model, batches, _ = xl_setup(seed=2, lora=False)
    samples = [{k: v[i:i + 1] for k, v in batches[0].items()}
               for i in range(4)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fisher = get_data_derivative(model, samples, power=2)
        torch.cuda.synchronize()
    del fisher
    total, groups = device_breakdown(
        prof, 1e3 * e2e["fisher_derivative_s"] * len(samples) / N_FISHER,
        f"fisher derivative, {len(samples)} samples")
    # the attention backward: every pass of either route, the separate
    # dbias kernel included (the Fisher launches it no more)
    bwd = {grp: ms for grp, ms in groups.items() if grp in BWD_GROUPS}
    per = sum(bwd.values()) / len(samples)
    e2e["fisher_attention_bwd_ms_per_sample"] = per
    e2e["fisher_attention_bwd_share"] = \
        sum(bwd.values()) / total if total else 0.0
    log(f"  [fisher derivative] attention backward {per:.3f} ms of device a "
        f"sample, {100 * e2e['fisher_attention_bwd_share']:.2f}% of the "
        f"Fisher's device time; by pass, ms a sample: "
        + ", ".join(f"{grp} {ms / len(samples):.3f}"
                    for grp, ms in sorted(bwd.items())))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_prune(model, batches, **FIRST_ORDER)
    device_breakdown(prof, 1e3 * e2e["ecoflap_prune_s"],
                     "ecoflap prune (allocation + Wanda)")
    del model, batches, samples
    gc.collect()
    torch.cuda.empty_cache()


# the cut that keeps the command under 900 s: the grid path's DSnoT prune
# is profiled at a third of its depth (ViT, T5 encoder, T5 decoder blocks;
# every width as at full depth), timed unprofiled at that depth.  The
# zeroth scoring and aobd stay at full depth: their walls are mostly
# per-call host work that the cut hardly shortens while it cuts their
# device time, so their busy shares would fall (on one H100 the zeroth
# scoring 4.5 s at the cut against 5.2 s at full depth, aobd 2.45 s
# against 3.48 s); the global magnitude prune takes 1.4 s at full depth
GRID_PROFILED_DEPTH = (13, 8, 8)


def profile_grid(e2e):
    """The grid path's prunes once more under torch.profiler (device
    activity only) on fresh seed-3 models: at full depth the zeroth
    entry's scoring of its first N_PROFILED keys at batch 1 (timed
    unprofiled just before), the aobd prune and the global magnitude
    prune (against the grid path's walls); the DSnoT prune at
    GRID_PROFILED_DEPTH, timed unprofiled at that depth just before."""
    from torch.profiler import ProfilerActivity, profile

    from vlm_compression_tpu_torch.compression import allocator as AL
    from vlm_compression_tpu_torch.models.layers import set_mask

    _, model, batches, _ = xl_setup(seed=3, lora=False)
    keys = AL.select_prunable_keys(model, ("visual_encoder", "t5_model"))
    sample = [{k: v[:1] for k, v in batches[0].items()}]

    def score():
        AL.mezo_layer_scalars(
            model, keys[:N_PROFILED], sample, AL.model_loss, eps=1e-3,
            num_noise=1, num_samples=1,
            z_fn=lambda tag, k, shape: AL.seeded_normal(shape, (0, 1, *tag),
                                                        "cuda"))
        torch.cuda.synchronize()

    @torch.no_grad()
    def drop_masks():
        for k in AL.select_prunable_keys(model,
                                         ("visual_encoder", "t5_model")):
            set_mask(model.get_submodule(".".join(k)), None)

    score()     # warm: the first forwards at batch 1 of this model
    t0 = time.perf_counter()
    score()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        score()
    total, _ = device_breakdown(
        prof, 1e3 * wall, f"zeroth scoring, {N_PROFILED} keys "
        f"({2 * N_PROFILED} batch-1 forwards)")
    e2e["zeroth_score_busy"] = total / (1e3 * wall)
    for label, name, kw in (("aobd_prune", "blipt5_aobd_pruner", {}),
                            ("mag_global", "blipt5_mag_pruner",
                             dict(is_global=True))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_prune(model, batches, name, **kw)
        total, _ = device_breakdown(prof, 1e3 * e2e[f"{label}_s"], label)
        e2e[f"{label}_busy"] = total / (1e3 * e2e[f"{label}_s"])
        drop_masks()
    del model, batches, sample
    gc.collect()
    torch.cuda.empty_cache()

    # the cut; DSnoT keeps the kernels, so the second prune starts from
    # the same dense weights
    _, model, batches, _ = xl_setup(seed=3, lora=False,
                                    depth=GRID_PROFILED_DEPTH)
    t0 = time.perf_counter()
    run_prune(model, batches, "blipt5_dsnot_pruner")
    wall = time.perf_counter() - t0
    drop_masks()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_prune(model, batches, "blipt5_dsnot_pruner")
    total, _ = device_breakdown(
        prof, 1e3 * wall, f"dsnot_prune at depth "
        f"{'/'.join(map(str, GRID_PROFILED_DEPTH))} (at full depth "
        f"{e2e['dsnot_prune_s']:.2f} s)")
    e2e["dsnot_prune_busy"] = total / (1e3 * wall)
    del model, batches
    gc.collect()
    torch.cuda.empty_cache()


# the attention backward's kernel groups (``_kernel_group``), both routes
BWD_GROUPS = ("flash_attention_bwd_wgmma main kernel",
              "flash_attention_bwd delta pre-pass",
              "flash_attention_bwd_wgmma dq cast",
              "flash_attention_bwd_dbias kernel",
              "flash_attention_bwd_dq kernel",
              "flash_attention_bwd_dkv kernel")
DECODE_GROUP = "matmul_decode kernel (decode route)"
SPLITK_GROUP = "WMMA loop split-K sums"
# the masked, packed, sparse-LoRA and int8 matmuls' groups are named
# "<form> kernel, <loop>"; a loop's device time is the sum of its groups
HOPPER, WMMA, FP32_LOOP = "Hopper loop", "WMMA loop", "fp32 loop"


def loop_ms(groups: dict, loop: str) -> float:
    """Device ms of one main loop of the tiled matmuls (the WMMA loop's
    split-K sums with it)."""
    return sum(t for g, t in groups.items() if g.endswith(f", {loop}")
               or (loop == WMMA and g == SPLITK_GROUP))


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "decode_kernel" in low or "matmul_decode" in low:
        return DECODE_GROUP
    if "splitk_reduce" in low:
        return SPLITK_GROUP
    if "matmul" in low or "sparse_lora" in low:
        loop = (HOPPER if "wgmma" in low else
                FP32_LOOP if "f32_kernel" in low else WMMA)
        if "int8_matmul" in low:
            return f"int8_matmul kernel, {loop}"
        # the WMMA loop's packed instantiations: <VEC, true> (bf16), <true>
        # (float32), demangled or mangled
        if "masked_matmul_packed" in low or re.search(
                r"masked_matmul_(bf16|f32)_kernel(<(\w+, )?true>"
                r"|i(lb[01]e)?lb1ee)", low):
            return f"masked_matmul_packed kernel, {loop}"
        if "masked_matmul" in low:
            return f"masked_matmul kernel, {loop}"
        return f"sparse_lora_matmul kernel, {loop}"
    if "flash_fwd_wgmma" in low:
        return "flash_attention_fwd_wgmma kernel"
    if "flash_fwd" in low:
        return "flash_attention kernel (mma.sync / fp32)"
    # the TMA + wgmma backward's three passes (before the mma.sync names:
    # "flash_bwd_dq_cast" holds "flash_bwd_dq")
    if "flash_bwd_wgmma" in low:
        return "flash_attention_bwd_wgmma main kernel"
    if "flash_bwd_delta" in low:
        return "flash_attention_bwd delta pre-pass"
    if "flash_bwd_dq_cast" in low:
        return "flash_attention_bwd_wgmma dq cast"
    if "flash_bwd_dbias" in low:
        return "flash_attention_bwd_dbias kernel"
    if "flash_bwd_dq" in low:
        return "flash_attention_bwd_dq kernel"
    if "flash_bwd_dkv" in low:
        return "flash_attention_bwd_dkv kernel"
    if any(t in low for t in ("potrf", "trsm", "trsv", "trtri", "cusolver",
                              "syrk", "lauum")):
        return "cuSOLVER/cuBLAS factor and solve"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet")):
        return "cuBLAS GEMM (dense passes, backward products)"
    if any(t in low for t in ("sort", "radix", "kthvalue")):
        return "sort/select (mask selection)"
    if "reduce" in low:
        return "reductions"
    return "other elementwise/copy"


def device_breakdown(prof, wall_ms: float, label: str) -> tuple:
    """Device time by kernel group from a torch.profiler trace (device-side
    events only), against the unprofiled wall-clock of the phase.  Reads
    the trace's raw events: ``key_averages`` builds a Python object per
    event, which took minutes for the SparseGPT prune's 2.2 M kernels.
    Returns (device ms, {group: ms})."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        acc = by_name.setdefault(e.name(), [0.0, 0])
        acc[0] += e.duration_ns() / 1e6
        acc[1] += 1
    groups, total, n_kernels = {}, 0.0, 0
    for name, (t, n) in by_name.items():
        total += t
        n_kernels += n
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + t
    if total == 0:
        log(f"  [{label}] profiler recorded no device time: not measured")
        return 0.0, {}
    log(f"  [{label}] device time {total:.1f} ms over {wall_ms:.1f} ms "
        f"unprofiled wall: device busy {100 * total / wall_ms:.1f}%; "
        f"{n_kernels} kernels, {1e3 * wall_ms / n_kernels:.1f} us of wall "
        f"each")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:38s} {t:9.1f} ms  {100 * t / total:5.1f}% of device")
    top = sorted(((t, n, name[:70]) for name, (t, n) in by_name.items()),
                 reverse=True)
    for t, n, key in top[:10]:
        log(f"    top: {t:8.1f} ms  x{n:<6d} {key}")
    return total, groups


def wmma_prefill_plan(plan):
    """``plan`` as it was before the Hopper loop took int8 and split K: the
    Hopper loop only for bf16 launches whose output tiles fill the card
    unsplit; int8 prefill and the under-filled shapes on the WMMA loop."""
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    def planned(m, n, k, sms, **kw):
        loop, splits, k_split = plan(m, n, k, sms, **kw)
        wmma = ML.split_k(m, n, k, sms)
        if loop == ML.WGMMA and (kw.get("int8") or wmma[0] > 1):
            return (ML.WMMA, *wmma)
        return loop, splits, k_split
    return planned


def profile_generate(model, req, wall_ms: float, form: str) -> dict:
    """One generate of ``form`` under torch.profiler on the planned loops,
    then one with int8 prefill and the under-filled prefill shapes on the
    WMMA loop (``wmma_prefill_plan``): each one's device ms, split by loop —
    the decode kernel, the Hopper loop, the WMMA loop (its split-K sums
    with it) — and all the masked, packed and int8 matmuls against
    everything else."""
    from torch.profiler import ProfilerActivity, profile

    from vlm_compression_tpu_torch.ops import masked_linear as ML

    out = {}
    planned = ML.plan
    for route in ("planned", "wmma_prefill"):
        ML.plan = planned if route == "planned" else wmma_prefill_plan(
            planned)
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run_generate(model, req)
        finally:
            ML.plan = planned
        total, groups = device_breakdown(
            prof, wall_ms, f"generate, {form}, "
            + ("the planned loops" if route == "planned"
               else "prefill on the WMMA loop"))
        loops = {"decode_kernel_ms": groups.get(DECODE_GROUP, 0.0),
                 "hopper_loop_ms": loop_ms(groups, HOPPER),
                 "wmma_loop_ms": loop_ms(groups, WMMA)}
        matmul = sum(loops.values())
        out[route] = {"device_ms": total, **loops, "matmuls_ms": matmul}
        log(f"  [generate, {form}] {route} loops: device {total:.1f} ms; "
            f"decode kernel {loops['decode_kernel_ms']:.1f}, Hopper loop "
            f"{loops['hopper_loop_ms']:.1f}, WMMA loop "
            f"{loops['wmma_loop_ms']:.1f}; all masked/packed/int8 matmuls "
            f"{matmul:.1f} ms, everything else {total - matmul:.1f} ms")
    return out


def profile_main_path(e2e):
    """The main path once more under torch.profiler (fresh model and data,
    seed 1), for where the device time goes: prune, generate, and one KD
    train step after an unprofiled one.  Launch counts are not read
    here."""
    from torch.profiler import ProfilerActivity, profile

    from vlm_compression_tpu_torch.tasks.retrain import (
        RessaTrainState,
        make_kd_train_step,
    )

    cfg, model, batches, req = xl_setup(seed=1)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        model, _ = run_prune(model, batches)
    device_breakdown(prof, 1e3 * e2e["prune_s"], "prune")
    with profile(activities=acts) as prof:
        run_generate(model, req)
    device_breakdown(prof, 1e3 * e2e["generate_s"], "generate")
    del batches
    state = RessaTrainState.create(model, weight_decay=WEIGHT_DECAY)
    step = make_kd_train_step(model, state.opt, KL_WEIGHT, T_KD)
    g = torch.Generator(device="cuda").manual_seed(8)
    warm, batch = synthetic_batches(cfg, 2, TRAIN_BS, g)
    step(warm, 1e-6)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        step(batch, 1e-6)
        torch.cuda.synchronize()
    device_breakdown(prof, 1e3 * e2e["retrain_s_per_step"],
                     "retrain step")
    del model, state, step
    torch.cuda.empty_cache()


def profile_sparsegpt_prune(e2e):
    """The compressed path's SparseGPT prune once more (a fresh seed-1
    model, as timed) under torch.profiler, device activity only: device
    time by kernel group against the unprofiled prune's wall-clock."""
    from torch.profiler import ProfilerActivity, profile

    _, model, batches, _ = xl_setup(seed=1, lora=False)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_prune(model, batches, "blipt5_sparsegpt_pruner")
    del model, batches
    gc.collect()
    torch.cuda.empty_cache()
    total, _ = device_breakdown(prof, 1e3 * e2e["sparsegpt_prune_s"],
                                "sparsegpt prune")
    e2e["sparsegpt_busy"] = total / (1e3 * e2e["sparsegpt_prune_s"])


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
SDPA_WORDS = {"FLASH_ATTENTION": "flash attention",
              "EFFICIENT_ATTENTION": "efficient",
              "CUDNN_ATTENTION": "cudnn"}


def sdpa_candidates(build) -> dict:
    """The library yardstick on every SDPA backend: ``build(backend)``
    returns a call of ``scaled_dot_product_attention`` pinned to that
    backend (with ``torch.nn.attention.sdpa_kernel``); each is run once.
    → backend name → the call, or 'refused: why' (SDPA's warning or
    error)."""
    import warnings

    from torch.nn.attention import SDPBackend

    out = {}
    for name in SDPA_BACKENDS:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                fn = build(getattr(SDPBackend, name))
                fn()
                torch.cuda.synchronize()
                out[name] = fn
                continue
            except (RuntimeError, ValueError, NotImplementedError) as exc:
                # SDPA warns why each backend it considered declined; keep
                # the warnings about the one pinned
                why = [str(w.message) for w in caught
                       if SDPA_WORDS[name] in str(w.message).lower()] \
                    or [str(exc)]
        text = re.sub(r"\s*\(Triggered internally at [^)]*\)\.?", "",
                      " ".join(why))
        out[name] = "refused: " + " ".join(text.split())[:240]
    return out


def pinned(backend, call):
    """``call`` run under ``sdpa_kernel(backend)``."""
    from torch.nn.attention import sdpa_kernel

    def run():
        with sdpa_kernel(backend):
            return call()
    return run


def sdpa_backward(backend, q, k, v, biases, g, scale, mask_grad=False):
    """SDPA's backward on ``backend``: the forward is run pinned (the
    backend is chosen there and its backward recorded), on contiguous
    (b, h, n, d) copies with the biases summed into one mask of q's dtype;
    the call returned is the backward alone — dq, dk, dv, and with
    ``mask_grad`` the (b, h, n, m) mask's gradient, unreduced."""
    import torch.nn.functional as F

    b, n, h, _ = q.shape
    m = k.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    mask = None
    if biases:
        mask = sum(biases).expand(b, h, n, m).to(q.dtype).contiguous()
        mask.requires_grad_(mask_grad)
    leaves = (qt, kt, vt) + ((mask,) if mask_grad else ())
    o = pinned(backend, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=scale))()
    go = g.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(o, leaves, go, retain_graph=True)


def against_library(kernel, candidates: dict) -> dict:
    """Each accepted backend timed once; then the kernel and the fastest
    backend in turns (kernel, library, library, kernel), so that the two
    are read under the same conditions.  → kernel_ms and library_ms (the
    means of their two turns), the backend, every reading."""
    each = {name: device_ms(fn) if callable(fn) else fn
            for name, fn in candidates.items()}
    timed = {name: ms for name, ms in each.items() if not isinstance(ms, str)}
    if not timed:
        k1 = device_ms(kernel)
        return {"kernel_ms": k1, "library_ms": None, "library_backend": None,
                "backends": each, "turns": (k1,)}
    best = min(timed, key=timed.get)
    k1 = device_ms(kernel)
    l1 = device_ms(candidates[best])
    l2 = device_ms(candidates[best])
    k2 = device_ms(kernel)
    return {"kernel_ms": (k1 + k2) / 2, "library_ms": (l1 + l2) / 2,
            "library_backend": best, "backends": each,
            "turns": (k1, l1, l2, k2)}


def library_note(r: dict) -> str:
    """One log fragment: each backend's time (or refusal), the turns and
    their spreads."""
    parts = [f"{name} {ms:.4f} ms" if not isinstance(ms, str)
             else f"{name} {ms}" for name, ms in r["backends"].items()]
    if r["library_ms"] is None:
        return "library: " + "; ".join(parts)
    k1, l1, l2, k2 = r["turns"]
    spread = lambda a, b: 100 * abs(a - b) / ((a + b) / 2)  # noqa: E731
    return (f"library {r['library_ms']:.4f} ms ({r['library_backend']}); "
            f"backends: {'; '.join(parts)}; turns kernel {k1:.4f} / "
            f"{k2:.4f} ms (spread {spread(k1, k2):.1f} %), library "
            f"{l1:.4f} / {l2:.4f} ms (spread {spread(l1, l2):.1f} %)")


def timing():
    import torch.nn.functional as F

    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    rows, wmma, extra = {}, {}, {}
    bf16 = torch.bfloat16

    def wmma_ms(key, fn, m, k, n, rank=0):
        """The WMMA loop's time where the plan is the Hopper loop or the
        decode kernel (forced through the wrapper's internal ``_loop``
        argument), for the loops side by side in one run; '' elsewhere."""
        if expected_loop(m, k, n, bf16, rank) not in (ML.WGMMA, ML.DECODE):
            return ""
        wmma[key] = device_ms(fn)
        return f", WMMA loop {wmma[key]:.4f} ms"

    for name, m, k, n in MM_SHAPES:
        x, w, mask = mm_inputs(m, k, n, bf16)
        wm = w * mask
        ms = device_ms(lambda: ML.masked_matmul(x, w, mask))
        old = wmma_ms(("masked_matmul", name), lambda: ML.masked_matmul(
            x, w, mask, _loop=ML.WMMA), m, k, n)
        plain = device_ms(lambda: ML.masked_matmul_ref(x, w, mask))
        lib = device_ms(lambda: torch.matmul(x, wm))
        bound, by = mm_bound_ms(m, k, n)
        rows[("masked_matmul", name)] = (ms, plain, lib, bound, by)
        log(f"  time masked_matmul {name:22s} M={m} K={k} N={n} "
            f"{expected_loop(m, k, n, bf16):5s}: kernel {ms:.4f} ms{old}, "
            f"plain {plain:.4f} ms, torch.matmul(x, W*mask) {lib:.4f} ms, "
            f"bound {bound:.4f} ms ({by})")
    for name, b, n, m, h, d, kinds, scale in \
            FLASH_SHAPES + VICUNA_FLASH_SHAPES:
        q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, bf16)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k_, v))
        bsum = None
        for x in biases:
            bsum = x if bsum is None else bsum + x
        bsum = None if bsum is None else bsum.expand(b, h, n, m).to(bf16)
        lib = against_library(
            lambda: A.attention_core(q, k_, v, biases, scale),
            sdpa_candidates(lambda be: pinned(
                be, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bsum, scale=scale))))
        ms = lib["kernel_ms"]
        mma = device_ms(lambda: A.flash_attention(q, k_, v, biases, scale,
                                                  _impl=A.MMA))
        plain = device_ms(lambda: A.mha_reference(q, k_, v, biases, scale))
        bound, by = flash_bound_ms(q, k_, v, biases)
        rows[("flash_attention", name)] = (ms, plain, lib["library_ms"],
                                           bound, by)
        extra[("flash_attention", name)] = {
            "mma_ms": mma, "library_backend": lib["library_backend"]}
        log(f"  time flash_attention {name:22s} b={b} n={n} m={m} h={h} "
            f"d={d}: the planned route ({A.plan_forward(n, m, d)}) "
            f"{ms:.4f} ms, mma.sync route {mma:.4f} ms ({mma / ms:.2f}x), "
            f"plain {plain:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"{library_note(lib)}")
    for name, m, k, n, r in LORA_SHAPES:
        x, w, mask, a, b = lora_inputs(m, k, n, r, bf16)
        s = 16.0 / r
        e = ML.sparse_lora_weight(w, mask, a, b, s)
        ms = device_ms(lambda: ML.sparse_lora_matmul(x, w, mask, a, b, s))
        old = wmma_ms(("sparse_lora_matmul", name),
                      lambda: ML.sparse_lora_matmul(x, w, mask, a, b, s,
                                                    _loop=ML.WMMA),
                      m, k, n, r)
        plain = device_ms(lambda: ML.sparse_lora_matmul_ref(x, w, mask, a,
                                                            b, s))
        lib = device_ms(lambda: torch.matmul(x, e))
        bound, by = lora_bound_ms(m, k, n, r)
        rows[("sparse_lora_matmul", name)] = (ms, plain, lib, bound, by)
        log(f"  time sparse_lora_matmul {name:14s} M={m} K={k} N={n} r={r} "
            f"{expected_loop(m, k, n, bf16, r):5s}: kernel {ms:.4f} ms{old}, "
            f"plain {plain:.4f} ms, torch.matmul(x, E) {lib:.4f} ms, bound "
            f"{bound:.4f} ms ({by})")
    # the attention backward at every training shape: the TMA + wgmma
    # route as the whole backward (delta pre-pass + main kernel + dq cast),
    # forced with ``_impl``; the mma.sync route (the pre-pass's delta, dq,
    # dk/dv) in the same call; the plain version (dq, dk, dv together);
    # the library: SDPA's backward (all three) on each backend, on
    # contiguous (b, h, n, d) copies with the biases summed into one bf16
    # mask, in turns with the new route
    for name, b, n, m, h, d, kinds, scale in BWD_SHAPES:
        q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, bf16)
        g = grad_like(q)
        out, lse = A.flash_attention(q, k_, v, biases, scale)
        args = (q, k_, v, out, lse, g, biases, scale)
        # the planned route against the library: TMA + wgmma at the
        # towers' d <= 96, mma.sync at LLaMA's d = 128 (which TMA + wgmma
        # does not take)
        route = A.plan(n, m, d)
        lib = against_library(
            lambda: A.flash_attention_backward(*args, _impl=route),
            sdpa_candidates(lambda be: sdpa_backward(be, q, k_, v, biases,
                                                     g, scale)))
        ms = lib["kernel_ms"]
        pr2 = ms if route == A.MMA else device_ms(
            lambda: A.flash_attention_backward(*args, _impl=A.MMA))
        plain = device_ms(lambda: A.flash_attention_backward_ref(*args))
        delta = device_ms(lambda: torch.einsum("bnhd,bnhd->bhn", g.float(),
                                               out.float()))
        bound, by = flash_bwd_bound_ms(q, k_, v, biases)
        for kname in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            rows[(kname, name)] = (ms, plain, lib["library_ms"], bound, by)
            extra[(kname, name)] = {"pr2_ms": pr2,
                                    "library_backend": lib["library_backend"]}
        log(f"  time flash_attention_bwd {name:16s} b={b} n={n} m={m} "
            f"h={h} d={d} (plan {route}): {route} whole "
            f"backward {ms:.4f} ms, mma.sync route {pr2:.4f} ms "
            f"({pr2 / ms:.2f}x), plain {plain:.4f} ms, bound {bound:.4f} ms "
            f"({by}); delta as a torch einsum of fp32 upcasts (the older "
            f"route's before the pre-pass) alone {delta:.4f} ms; "
            f"{library_note(lib)}")
    # the backward with the position bias's gradient, at the first-order
    # allocation's batch and at the diagonal Fisher's (batch 1, where it
    # runs); the library: SDPA's backward with a mask that requires a
    # gradient, on each backend that accepts it
    for name, b, n, m, h, d, kinds, scale, causal in DBIAS_SHAPES:
        if name in (DBIAS_TIMED, DBIAS_FISHER):
            time_dbias(rows, extra, name, b, n, m, h, d, kinds, scale,
                       causal)
    return rows, wmma, extra


def time_dbias(rows, extra, name, b, n, m, h, d, kinds, scale, causal):
    """The backward with the gradient of the first bias at one
    DBIAS_SHAPES case: one TMA + wgmma call returning dq, dk, dv and
    dbias, in turns with the unfused route (the backward, then the
    separate dbias kernel), the backward alone and SDPA's backward with a
    mask gradient (fused, unfused, alone, library, library, alone, unfused,
    fused; the means); the plain version; the bound."""
    from vlm_compression_tpu_torch.ops import attention as A

    bf16 = torch.bfloat16
    q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, bf16)
    g = grad_like(q)
    out, lse = A.flash_attention(q, k_, v, biases, scale, causal)
    args = (q, k_, v, out, lse, g, biases, scale, causal)
    if A.plan_dbias(A.plan(n, m, d), biases[0].shape, n, m) != A.FUSED:
        raise AssertionError(f"time_dbias {name}: not on the fused route")

    def fused():
        return A.flash_attention_backward(*args, dbias_of=(0,))

    def unfused():
        A.flash_attention_backward(*args)
        return A.flash_attention_dbias(q, k_, v, out, lse, g, biases, 0,
                                       scale, causal)

    def alone():
        return A.flash_attention_backward(*args)

    cands = sdpa_candidates(lambda be: sdpa_backward(
        be, q, k_, v, biases, g, scale, mask_grad=True))
    each = {be: device_ms(fn) if callable(fn) else fn
            for be, fn in cands.items()}
    timed = {be: x for be, x in each.items() if not isinstance(x, str)}
    best = min(timed, key=timed.get) if timed else None
    order = [fused, unfused, alone] + ([cands[best]] * 2 if best else []) \
        + [alone, unfused, fused]
    turns = [device_ms(fn) for fn in order]
    ms = (turns[0] + turns[-1]) / 2
    unf = (turns[1] + turns[-2]) / 2
    bwd = (turns[2] + turns[-3]) / 2
    lib = (turns[3] + turns[4]) / 2 if best else None
    plain = device_ms(lambda: A.flash_attention_backward_ref(
        *args, dbias_of=(0,)))
    bound, by = flash_bwd_bound_ms(q, k_, v, biases, dbias_of=(0,))
    rows[("flash_attention_bwd_dbias", name)] = (ms, plain, lib, bound, by)
    extra[("flash_attention_bwd_dbias", name)] = {
        "unfused_ms": unf, "backward_alone_ms": bwd,
        "dbias_cost_ms": ms - bwd, "library_backend": best,
        "turns": turns}
    log(f"  time fused dbias {name} b={b} n={n} m={m} h={h} d={d} "
        f"biases={kinds}, with the gradient of {tuple(biases[0].shape)}: "
        f"one TMA + wgmma call (dq, dk, dv, dbias) {ms:.4f} ms, the backward "
        f"alone {bwd:.4f} ms (dbias's cost {ms - bwd:.4f} ms), unfused (the "
        f"backward, then the separate dbias kernel) {unf:.4f} ms "
        f"({unf / ms:.2f}x), plain {plain:.4f} ms, bound {bound:.4f} ms "
        f"({by}); library "
        f"{'none' if lib is None else f'{lib:.4f} ms ({best})'}; backends: "
        + "; ".join(f"{be} {x:.4f} ms" if not isinstance(x, str)
                    else f"{be} {x}" for be, x in each.items())
        + f"; turns {' / '.join(f'{t:.4f}' for t in turns)} ms (SDPA: dq, "
        f"dk, dv and the unreduced (b, h, n, m) mask gradient)")


def timing_compressed(rows, wmma):
    """Every shape of the compressed path — prefill and decode, and the
    int8 linears that hold no mask — in every weight form (bool, packed G
    128 and 256, int8 with no, bool and packed-128 masks) on the loop
    ``plan`` picks (the Hopper loop at prefill, split-K where the output
    tiles do not fill the card; the decode kernel at decode), in turns
    with the WMMA loop forced through ``_loop`` and the library (planned,
    WMMA, library, library, WMMA, planned; the means), beside the plain
    version and the bound.  Library: torch.matmul on a weight masked (and
    dequantized) beforehand.  Returns the table."""
    from vlm_compression_tpu_torch.ops import bitmask as BM
    from vlm_compression_tpu_torch.ops import masked_linear as ML
    from vlm_compression_tpu_torch.ops import quant as Q

    bf16 = torch.bfloat16
    unmasked = {s[0] for s in INT8_UNMASKED_SHAPES}
    table = {}
    for name, m, k, n in SERVE_SHAPES + INT8_UNMASKED_SHAPES:
        x, w, mask = mm_inputs(m, k, n, bf16)
        q, sc = Q.quantize_weight(w)
        wq = Q.dequantize_weight(q, sc, bf16)
        packed = {g: BM.pack_mask(mask, g) for g in (128, 256)}
        forms = {
            "bool": (lambda loop=None: ML.masked_matmul(x, w, mask,
                                                        _loop=loop),
                     lambda: ML.masked_matmul_ref(x, w, mask), w * mask,
                     mm_bound_ms(m, k, n)),
            **{f"packed{g}": (
                lambda loop=None, g=g: ML.masked_matmul_packed(
                    x, w, packed[g], _loop=loop),
                lambda g=g: ML.masked_matmul_packed_ref(x, w, packed[g]),
                w * mask, packed_bound_ms(m, k, n, 256 // g))
               for g in (128, 256)},
            **{f"int8_{kind}": (
                lambda loop=None, mk=mk: Q.int8_matmul(x, q, sc, mk,
                                                       _loop=loop),
                lambda mk=mk: Q.int8_matmul_ref(x, q, sc, mk),
                wq if mk is None else wq * mask,
                int8_bound_ms(m, k, n, mask_bytes))
               for kind, mk, mask_bytes in (
                   ("none", None, 0), ("bool", mask, k * n),
                   ("packed128", packed[128], k * n * 2 / 8))}}
        if name in unmasked:
            forms = {"int8_none": forms["int8_none"]}
        decode = name.endswith("_decode")
        want = ML.DECODE if decode else ML.WGMMA
        _, splits, _ = ML.plan(m, n, k, sm_count())
        for form, (call, ref, lib_w, (bound, by)) in forms.items():
            if expected_loop(m, k, n, bf16, int8=form.startswith("int8")) \
                    != want:
                raise AssertionError(f"{name} {form}: not on the {want} "
                                     "loop")
            fns = (call, lambda: call(ML.WMMA),
                   lambda: torch.matmul(x, lib_w))
            t = [device_ms(f) for f in fns]
            t += [device_ms(f) for f in reversed(fns)]
            new, old, lib = (t[0] + t[5]) / 2, (t[1] + t[4]) / 2, \
                (t[2] + t[3]) / 2
            plain = device_ms(ref)
            key = f"{name} {form}"
            table[key] = {"loop": want, "ms": new, "wmma_loop_ms": old,
                          "library_ms": lib, "plain_ms": plain,
                          "bound_ms": bound, "bound_by": by,
                          "turns": [round(v, 5) for v in t]}
            where = "decode kernel" if decode else (
                f"Hopper loop{f' ({splits} splits)' if splits > 1 else ''}")
            log(f"  time {name:20s} {form:15s} M={m} K={k} N={n}: {where} "
                f"{new:.4f} ms (turns {t[0]:.4f} / {t[5]:.4f}), WMMA loop "
                f"{old:.4f} ({old / new:.2f}x), library {lib:.4f} (÷ "
                f"library {new / lib:.2f}), plain {plain:.4f}, bound "
                f"{bound:.5f} ms ({by}; {new / bound:.1f}x)")
            if old <= new:
                log(f"  NOTE planned loop not faster than the WMMA loop: "
                    f"{key}")
            timed = (new, plain, lib, bound, by)
            if form == "packed128" and decode:
                rows[("masked_matmul_packed", f"{name} G128")] = timed
                rows[("matmul_decode", f"{name} G128")] = timed
                wmma[("masked_matmul_packed", f"{name} G128")] = old
                wmma[("matmul_decode", f"{name} G128")] = old
            if form.startswith("int8"):
                kname = "int8_matmul" if decode else "int8_matmul_wgmma"
                rows[(kname, f"{name} {form[5:]}")] = timed
                wmma[(kname, f"{name} {form[5:]}")] = old
    log(f"[compressed table] {json.dumps(table)}")
    return table


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from vlm_compression_tpu_torch.ops import _cuda
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    from vlm_compression_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[device] {name} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} (the library yardsticks' versions)")

    t0 = time.perf_counter()
    secs = _cuda.build()
    log(f"[build] {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.1f} s; the Hopper loop "
        f"(masked_matmul_wgmma.cu and int8_matmul_wgmma.cu, their kernels "
        f"with wgmma_tile.cuh) "
        f"{secs.get('masked_matmul_wgmma', float('nan')):.1f} and "
        f"{secs.get('int8_matmul_wgmma', float('nan')):.1f} s")
    phases, t_phase = {"build": time.perf_counter() - t0}, time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        phases[name] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()

    log("[kernels] kernel vs plain version")
    worst = check_kernels()
    check_compressed_kernels(worst)
    check_dbias_kernel(worst)
    phase_done("kernels")
    log("[reference] tiny model, card vs CPU")
    tiny_reference_check()
    tiny_train_check()
    tiny_gradient_scoring_check()
    tiny_grid_pruners_check()
    tiny_vicuna_check()
    tiny_retrieval_check()
    log("[reference] SparseGPT at an XL shape, card vs CPU; one batched "
        "group against its members one by one")
    sg = sparsegpt_check()
    log("[reference] DSnoT at an XL shape, card vs CPU")
    sg.update(dsnot_xl_check())
    phase_done("reference")
    # the checks above leave the caching allocator and the heap full of
    # their tensors and graphs; the main path starts clean, as it would in
    # a process of its own
    gc.collect()
    torch.cuda.empty_cache()
    log("[main path] InstructBLIP-FlanT5-XL: Wanda prune, beam-5 generate, "
        "RESSA retrain, merge, beam-5 generate, VQA, NoCaps captioning")
    counts, e2e = main_path()
    phase_done("main path")
    gc.collect()
    torch.cuda.empty_cache()
    log("[compressed path] InstructBLIP-FlanT5-XL: SparseGPT prune, beam-5 "
        "generate with bool masks, packed masks (G 128, 256), int8 weights, "
        "the int8 serving form")
    c_counts, c_e2e = compressed_path()
    phase_done("compressed path")
    counts.update(c_counts)
    e2e.update(c_e2e, **sg)
    log("[first-order path] InstructBLIP-FlanT5-XL: EcoFLaP first-order "
        "block allocation + Wanda, beam-5 generate; diagonal Fisher, "
        "unstrct prune_by_importance, beam-5 generate")
    f_counts, f_e2e = first_order_path()
    phase_done("first-order path")
    counts.update(f_counts)
    e2e.update(f_e2e)
    gc.collect()
    torch.cuda.empty_cache()
    log("[grid path] InstructBLIP-FlanT5-XL: DSnoT prune, beam-5 generate; "
        "magnitude and random prunes, layerwise; magnitude, global; aobd; "
        "the zeroth entry (one sample scored at batch 1), beam-5 generate")
    g_counts, g_e2e = grid_path()
    phase_done("grid path")
    counts.update(g_counts)
    e2e.update(g_e2e)
    gc.collect()
    torch.cuda.empty_cache()
    log("[vicuna path] InstructBLIP-Vicuna-7B: Wanda prune (ViT and "
        "llm_model), beam-5 generate, GQA and OK-VQA through the tasks, "
        "RESSA retrain, merge, beam-5 generate; rebuilt dense: the DSnoT "
        "grid entry, beam-5 generate")
    v_counts, v_e2e = vicuna_path()
    phase_done("vicuna path")
    counts.update(v_counts)
    e2e.update(v_e2e)
    log("[retrieval path] the stage-1 BLIP-2 Q-Former: ViT Wanda prune, "
        "Flickr30k retrieval through the task (ITC ranking + ITM rerank at "
        "k_test 128), cold and warm")
    r_counts, r_e2e = retrieval_path()
    phase_done("retrieval path")
    counts.update(r_counts)
    e2e.update(r_e2e)
    log("[cli path] the launcher's T5 grid point through the port's CLI: "
        "the Wanda prune call at batch 1 (checkpoint saved), the GQA eval "
        "call on the checkpoint")
    cl_counts, cl_e2e = cli_path()
    phase_done("cli path")
    counts.update(cl_counts)
    e2e.update(cl_e2e)
    log("[profile] the main path, the SparseGPT prune, the first-order "
        "path's gradient phases and the grid path's prunes again under "
        "torch.profiler")
    profile_main_path(e2e)
    profile_sparsegpt_prune(e2e)
    profile_first_order(e2e)
    profile_grid(e2e)
    phase_done("profile")
    log("[timing] bf16, each reading the median of 20 calls, CUDA events, "
        "L2 flushed before each call; attention kernels and their library "
        "call in turns (kernel, library, library, kernel), the means")
    rows, wmma, extra = timing()
    timing_compressed(rows, wmma)
    phase_done("timing")
    log(f"[phases] wall-clock s: "
        f"{json.dumps({k: round(v, 1) for k, v in phases.items()})}")

    # the attention forward's row reports its TMA + wgmma route (its time
    # and launches, beside the mma.sync route's time and the other
    # routes' launches); the backward's two rows both report the TMA +
    # wgmma route's whole backward (its time, bound and launches, beside
    # the mma.sync route's time and launches)
    kernels = []
    csrc = "vlm_compression_tpu_torch/csrc/"
    for kname, timed, src, repl in (
            ("masked_matmul", MM_TIMED, csrc + "masked_matmul_wgmma.cu",
             "vlm_compression_tpu/ops/masked_linear.py:67"),
            ("flash_attention", FLASH_TIMED,
             csrc + "flash_attention_fwd_wgmma.cu",
             "vlm_compression_tpu/ops/attention.py:107"),
            ("sparse_lora_matmul", LORA_TIMED,
             csrc + "masked_matmul_wgmma.cu",
             "vlm_compression_tpu/ops/masked_linear.py:309"),
            ("flash_attention_bwd_dq", BWD_TIMED,
             csrc + "flash_attention_bwd_wgmma.cu",
             "vlm_compression_tpu/ops/attention.py:296"),
            ("flash_attention_bwd_dkv", BWD_TIMED,
             csrc + "flash_attention_bwd_wgmma.cu",
             "vlm_compression_tpu/ops/attention.py:331"),
            ("masked_matmul_packed", PACKED_TIMED, csrc + "matmul_decode.cu",
             "vlm_compression_tpu/ops/masked_linear.py:194"),
            ("int8_matmul", INT8_TIMED, csrc + "matmul_decode.cu",
             "vlm_compression_tpu/ops/quant.py:84"),
            ("int8_matmul_wgmma", INT8_PREFILL_TIMED,
             csrc + "int8_matmul_wgmma.cu",
             "vlm_compression_tpu/ops/quant.py:84"),
            ("flash_attention_bwd_dbias", DBIAS_TIMED,
             csrc + "flash_attention_bwd_wgmma.cu",
             "vlm_compression_tpu/ops/attention.py:371"),
            ("matmul_decode", PACKED_TIMED, csrc + "matmul_decode.cu",
             "vlm_compression_tpu/ops/masked_linear.py:194")):
        ms, plain, lib, bound, by = rows[(kname, timed)]
        bwd = kname in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
        # the decode kernel: its error at the timed shape is the packed
        # kernel's there (the same launch); it replaces the int8 TPU
        # kernel too.  The int8 Hopper route: its error is the int8
        # kernel's at the timed prefill shape; its launches are the Hopper
        # loop's in the int8 generates (which run no other form: their
        # gates forbid the bool and packed kernels)
        err_key = ({DECODE: "masked_matmul_packed",
                    "int8_matmul_wgmma": "int8_matmul",
                    "flash_attention_bwd_dbias": "fused_dbias"}.get(kname,
                                                                    kname),
                   timed, torch.bfloat16)
        # the dbias row: the bias gradients the TMA + wgmma backward
        # returned (the separate kernel's launches beside them)
        dbias = kname == "flash_attention_bwd_dbias"
        launches = {p: (c[WGMMA_LOOP] if p.startswith("generate_int8")
                        else 0) if kname == "int8_matmul_wgmma"
                    else c[BWD_DBIAS] if dbias
                    else c[kname] + (c[BWD_WGMMA] if bwd else 0)
                    for p, c in counts.items()}
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": sum(launches.values()),
            "launches_by_phase": launches,
            **({"launches_by_route": {
                "wgmma": sum(c[BWD_WGMMA] for c in counts.values()),
                "mma": sum(c[kname] for c in counts.values())},
                # the training shapes ``plan`` sends to the mma.sync
                # kernels (LLaMA's d = 128 at the Vicuna retrain), their
                # launches in that phase
                "llama_retrain": {name: dict(zip(
                    ("ms", "plain_ms", "library_ms", "bound_ms",
                     "bound_by"), rows[(kname, name)]),
                    **extra[(kname, name)],
                    max_abs_err=worst[(kname, name, torch.bfloat16)],
                    route="mma", source=csrc + "flash_attention_bwd.cu",
                    launches=counts["vicuna_retrain"][kname])
                    for name, _, n, m, _, d, *_ in BWD_SHAPES
                    if A.plan(n, m, d) == A.MMA}}
               if bwd else {}),
            **({"llama_retrain": {name: dict(zip(
                ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                rows[(kname, name)]),
                max_abs_err=worst[(kname, name, torch.bfloat16)],
                **({"wmma_loop_ms": wmma[(kname, name)]}
                   if (kname, name) in wmma else {}))
                for name in LORA_LLAMA},
                "llama_retrain_launches": counts["vicuna_retrain"][kname]}
               if kname == "sparse_lora_matmul" else {}),
            **({"launches_by_route": {
                "wgmma": sum(c[FWD_WGMMA] for c in counts.values()),
                "mma_or_fp32": sum(c[FWD_MMA] for c in counts.values())},
                "vicuna_mma": {name: dict(zip(
                    ("ms", "plain_ms", "library_ms", "bound_ms",
                     "bound_by"), rows[(kname, name)]),
                    **extra[(kname, name)])
                    for name in FLASH_VICUNA_TIMED},
                "vicuna_launches_by_route": {
                    p: {"wgmma": c[FWD_WGMMA], "mma": c[FWD_MMA]}
                    for p, c in counts.items() if "vicuna" in p}}
               if kname == "flash_attention" else {}),
            **({"launches_by_route": {
                "decode": sum(c[DECODE] for p, c in counts.items()
                              if p.startswith("generate_int8")),
                "wgmma": sum(launches.values())}}
               if kname == "int8_matmul_wgmma" else {}),
            **({"launches_by_route": {
                "fused": sum(launches.values()),
                "separate_kernel": sum(c[kname] for c in counts.values())},
                "separate_kernel_source": csrc + "flash_attention_bwd.cu"}
               if dbias else {}),
            **({"also_replaces": "vlm_compression_tpu/ops/quant.py:84"}
               if kname == DECODE else {}),
            "max_abs_err": worst[err_key],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib, "shape": timed,
            **({"at_fisher_shape": dict(zip(
                ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                 "bound_by"), (DBIAS_FISHER, *rows[(kname, DBIAS_FISHER)])),
                **extra[(kname, DBIAS_FISHER)])}
               if dbias else {}),
            **extra.get((kname, timed), {}),
            **({"wmma_loop_ms": wmma[(kname, timed)]}
               if (kname, timed) in wmma else {})})
    log(f"[e2e] {json.dumps(e2e)}  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
