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
  2b. parallel path — before anything else holds the card: a world of 1
                on NCCL in this process (``common.dist.
                init_distributed_mode`` as torchrun names it, a mesh, a
                tiny KD step, the LoRA gradients' bucket all-reduce over the
                NCCL group); then two ranks sharing device 0 on gloo with
                CUDA tensors (NCCL refuses a second rank on one device:
                scripts/torch_parallel_probe.py), each building full-width
                InstructBLIP-FlanT5-XL (seed 28): the Wanda prune at DP = 2
                and at TP = 2 on 8 calibration samples (the cut), each
                mask held bit for bit against the one-process mask function
                on the run's own statistics and the first linear's
                statistic against one process's, the flipped bits against
                the one-process prune reported beside a control (one
                process, the samples in two batches); block 0 of every
                tower in float32 at DP = 2 and TP = 2 against one process
                (outputs and LoRA gradients within 1e-4) and in bf16 at
                TP = 2 (within 2e-2: a row-parallel output rounded once,
                its shards' products fp32); one KD step of
                train_ressa's configuration at DP = 2 and TP = 2 (batch 32;
                the loss within bf16 2e-2 of one process's, the LoRA
                factors equal on the ranks; their distance from one
                process's reported beside a control: one process, the
                batch as two accumulated halves, whose loss, ce and kl
                the DP step's equal bit for bit); beam-5 generate at TP = 2
                (finite; its first-step logits' drift beside a control:
                the random XL model carries any rounding through its
                depth); T5-XL's encoder attention split over heads and over
                the batch (dq, dk, dv and both bias gradients within bf16
                2e-2); a 2-stage GPipe pipeline of 8 of Vicuna-7B's LLaMA
                blocks (the cut), 4 microbatches (output and gradients
                within bf16 2e-2 of the blocks in sequence).  Every launch
                of rows 1 and 3-7 in the ranks is recorded and each
                signature held here against its plain version; the timing
                phase times rows 1p, 3p, 4p, 5p and 7p (``par_timed``);
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
                d = 128 on the TMA + wgmma kernel and on the mma.sync
                route, under LLaMA's one additive bias: the calibration
                sweep, the primes and the decode steps at b = 20 and 320,
                the retrain's forward, and rows that see no valid key),
                two identical calls bit-equal there too; the caption
                pass's (the T5 encoder over 32 + 3 tokens, its cross k/v
                for 320 × 35 rows, the decoder's self-attention over up to
                31 cache slots); the Vicuna retrain's (sparse-LoRA at
                LLaMA's widths, M = 32 × 72, r = 8, the down projection at
                K = 11008; the Q-Former's attention over 32 + 34 tokens;
                the attention backward at d = 128 on the TMA + wgmma
                kernel and the mma.sync route under the causal + pad bias,
                against the plain version in bf16 and fp32, two calls of
                the TMA + wgmma one bit-equal); the
                retrieval path's (the pruned ViT at the eval loader's
                ragged last batch, b = 32, M = 32 × 257; the stage-1
                Q-Former's queries-only image pass at b = 64 and 32, its
                text-only pass over captions of 35 tokens at b = 256 and
                32, the ITM rerank at b = 128 over 32 + 35 tokens and its
                cross-attention to the 257 image tokens); the OPT path's
                (BLIP-2 OPT-6.7B's attention at d = 128 and scale 1 under
                the one additive bias: the primes and beam steps at b = 20
                and 320; OPT-2.7B's d = 80 at the GQA eval's prime and
                step; the queries-only Q-Former at b = 4; the pruned ViT at
                M = 4 × 257); the Vicuna rank pass's (LLaMA over 32 + the
                prompt + the candidate for 16 × 128 rows, in the task's
                chunk and in chunks of 512; the ViT at M = 16 × 257) and
                the C4 passes' (T5-XL and LLaMA at b = 1 over 128 tokens);
  4. reference — a tiny float32 InstructBLIP-T5 on the card (kernels) vs
                the same model on the CPU (plain versions): masked logits
                (bool, packed and int8 leaves), one KD train step (loss,
                LoRA gradients and update), the diagonal Fisher of every
                leaf, the aobd_sum block allocation (ratios equal) and the
                Wanda masks under it (bit-equal), the VQA task's
                ``valid_step`` in generate (beam 2) and rank mode (answers
                equal; ``predict_class_t5``'s NLLs within 1e-4);
                speculative decoding at γ 2 and 4 (masked draft, dense
                target) with batch-shared and per-row caches, each with
                and without the int8 KV cache, on the tiny T5 and Vicuna:
                tokens equal to the dense greedy decode on each device,
                tokens, rounds and commits card = CPU;
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
                entries reranked, the metrics equal; ``cli.train`` on the
                launcher's RESSA argv at ``--tiny`` in float32 (masks
                bit-equal, each step's loss, CE and KL within 1e-4, the
                trained LoRA within 2e-3 of its change); the pruners
                path's slice (``blipt5_ria_pruner``, Wanda 2:4 with hybrid
                tiles, ``blipt5_softmask_pruner``: masks bit-equal;
                WoodFisher's scores within 1e-4; a pairwise merge with the
                permutation, logits within 1e-4;
                ``cli.evaluate_woodfisher --tiny --distillation_init
                unstrct_woodfisher``: sizes, eval results and answers
                equal); ``load_model_and_preprocess`` /
                ``load_model`` / ``load_pruner`` at tiny size: a CPU
                build's checkpoint read back on the card (every tensor
                equal), masked logits card vs CPU within the bf16
                tolerance, the processors on one image;
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
                and one GQA pass profiled; the serving passes
                (``serving_path``, the same model and 64 questions): the
                dense teacher's greedy decode, GQA through the task with
                speculative_gamma 4 on batch-shared and on per-row
                caches, the beam-5 GQA pass with the int8 KV cache, each
                cold and warm (speculative rows equal to the dense
                greedy's, or a top-2 gap within the bf16 tolerance at the
                first differing token; per-row rounds ≤ shared; int8
                teacher-forced logits within 5e-2 relative RMS of the bf16
                cache's at every step; rounds, commits, syncs a round,
                cache bytes, peaks; the warm passes profiled); then NoCaps
                captioning through
                the captioning task at the NoCaps (and COCO) eval yaml's
                settings (batch 64, beam 5, max_len 30, min_len 8), cold
                and warm (captions equal, and equal to a direct
                ``generate_t5``'s decoded tokens; no EOS before position
                min_len; each image's own caption as its reference gives
                BLEU-1..4 and ROUGE-L of exactly 1 in the host-only
                caption metrics), once more with EOS made the top logit
                of every step (every caption ends, none before min_len,
                each equal to a direct ``generate_t5``'s), its shapes
                checked in phase 3, one pass profiled; C4 perplexity
                through ``LanguageModelingTask`` (32 seeded texts at
                max_len 128, batch 1): finite, and exp of the token-weighted
                loss recomputed by direct calls.  Each phase's kernels must
                have launched in it;
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
                phase.  The int4 forms, from the bf16 kernels (put back
                after): group 128 with bool and with packed-128 masks,
                beam-5 generate cold and warm each (every ``kernel_q4``
                (K/2, N) uint8 with (K/128, N) fp32 scales, one linear's
                codes and scales bit-equal to the CPU's, the bytes at rest
                the closed form, every launched shape within bf16
                tolerance of the plain version, the masked and packed
                kernels, never the int8 kernel or the WMMA loop); the W8A8
                forms on the int8 model, without and with 32 outlier
                columns (every shape within bf16 tolerance of the plain
                version, ``_int_mm`` bit-equal to a float64 product, no
                matmul kernel of the port, the switches off after); each
                form's teacher-forced logits' drift against the bf16
                model printed, not gated, over all steps and at the
                first, beside the weights' relative RMS error and two
                controls (the packed bf16 model, 0 expected; every masked
                kernel perturbed by a seeded 1e-3 and 1e-2 relative);
  6b. quant path — a full-width XL cut to 4/3/3 blocks (seed 15; the cut:
                the GPTQ sweep walks its columns one at a time):
                ``blipt5_gptq_pruner`` jointly at 0.5 / 0.5 (4 bits, group
                128, symmetric; each linear 0.5 ± 0.01, at most 16 values
                in each (unit, 128-row group), 0 off its mask), GPTQ's and
                AWQ's OBS loss at most RTN's on three linears' Hessians,
                one linear's sweep card against CPU; AWQ card against CPU
                on 512 units of that linear (the candidate losses and the
                choice; the best candidate but the identity forced: its
                scaled problem, RTN unscaled back and its loss); then the
                ViT restored
                dense and ``vit_gptq_pruner`` quantizing only with AWQ;
                beam-5 generate;
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
                ONE sample at batch 1 on a model cut to 13/8/8 blocks —
                the path's cuts: the grid scores 32 at 39/24/24 — and
                beam-5 generate.  Each tower at 0.5 ± 0.01 (the
                zeroth entry: the parameter-weighted mean of its ratios and
                its masks), finite losses, every shape launched one that
                phase 3 checked;
  9. pruners path — full-width InstructBLIP-FlanT5-XL (bf16, seeds
                10-14, no adapters, after the grid path): Wanda, then
                ``blipt5_ria_pruner`` (masks kept; each linear 0.5 ± 0.01;
                the share of bits that differ from Wanda's logged) and
                ``blipt5_wanda_pruner`` 2:4 with 64 × 64 hybrid tiles at
                0.4 (each linear 0.6 ± 0.01, every tile dense or 2:4), a
                beam-5 generate after each; transposable 2:4 of T5 wi_0's
                |W| card vs CPU, bit-equal; ``blipt5_softmask_pruner`` 2:4
                (48 steps, lr 0.1) at 4/3/3 blocks — the cut: its fp32
                products are about 2.9 PFLOP at 39/24/24 — every group of
                4 keeping 2, each linear's OBS error at most its Wanda
                start's, beam-5 generate; ``WoodFisher`` over three named
                leaves (about 14.7 GB of block inverses; 8 samples at
                batch 1): one chunk's diag(F⁻¹) within 1e-4 of an fp64
                inverse from the same gradients, which the unfolded I/damp
                must miss by over 1e-2, the attention backward on
                TMA + wgmma with 48 bias gradients a sample as its outputs;
                ``cli.evaluate_woodfisher`` on the GQA yaml over the cli
                path's data: the diagonal-Fisher ``unstrct`` prune at 0.5
                (8 samples, JAX's default 64: a cut; non-zero share 0.5 ±
                0.01) and the pairwise block merge with the permutation
                (depths 20/12/12, ``distilled_total_size`` the closed form
                from the configs), each call's answers equal to a direct
                ``generate_t5``'s, every shape held in phase 3;
 10. vicuna path — full-width InstructBLIP-Vicuna-7B (EVA-ViT-g 39
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
                the serving passes as on T5 (``serving_path``);
                then RESSA retraining of the pruned model (SparseLoRA
                tune_opt=LVQ, ranks 4/8/2, on batches collated by
                ``make_vicuna_batch_preparer``, LLaMA at n = m = 72, the
                Q-Former at 32 + 34 in every batch) with the main path's
                gates (1 cold + 3 timed steps at batch 32, the first two
                replayed bit-equal; LLaMA's attention forward and
                backward at d = 128 on the TMA + wgmma kernels, none on
                the mma.sync ones, no bias gradient, no WMMA-loop launch;
                every shape launched, sparse-LoRA and backward included,
                one that phase 3 checked), one more step profiled,
                the sparse merge (zero off the masks, 0.5 ± 0.01) and
                beam-5 generate from the merged model; then, rebuilt dense
                from seed 4, the Vicuna grid's DSnoT entry
                (``blipt5_dsnot_pruner``, ``t5_model_prefix=llm_model``,
                scripts/vicuna/dsnot.py's defaults; each tower 0.5 ± 0.01,
                a finite loss, the refinement's cycles, host syncs and
                seconds) and beam-5 ``generate_vicuna``, every shape held
                in phase 3; before that rebuild, on the pruned and merged
                7B, ranking through ``VQATask``: 16 questions over 128
                candidates (the cut: the T5 pass ranks 64), answers the
                argmin of a direct ``predict_class_vicuna`` in chunks of
                512 rows, and C4 perplexity as on T5;
 10b. opt path — full-width BLIP-2 OPT-6.7B (EVA-ViT-g 39, the Q-Former 12
                queries-only, OPT 32 × 4096, ffn 16384, 32 heads of 128,
                vocab 50272; bf16, seed 16, built from ``Blip2OPTConfig``:
                no factory builds ``blip2_opt``; after the Vicuna models
                are freed): ``vit_wanda_pruner`` on its ViT (masks kept,
                0.5 ± 0.01; OPT's linears stay plain products, as the JAX
                pruners sweep no OPT tower); beam-5 ``generate_opt`` on 4
                left-padded requests, cold and warm (tokens equal); GQA
                through the task at gqa_zeroshot_opt6.7b_eval.yaml's
                settings, cold and warm (exactly 50.00), the answers equal
                to a direct ``generate_opt``'s, one pass profiled; the
                task at speculative_gamma 4 and with the int8 KV cache,
                each equal to its direct ``generate_opt`` (their drift
                against the beam printed); OPT's attention on TMA + wgmma
                alone, every shape held in phase 3;
 11. retrieval path — the stage-1 BLIP-2 Q-Former at full width (arch
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
 11b. zoo path — the legacy image-text zoo at full width, bf16 (the
                towers' linears stored in bf16), seeded random weights and
                a 50 % per-linear magnitude mask on every linear (EVA-CLIP's
                vision tower dense): BLIP-1 base ``blip_retrieval``, ALBEF
                base ``albef_retrieval``, CLIP ``ClipConfig.base()`` and
                EVA-CLIP through ``RetrievalTask`` at k_test 128 over 64
                images and 320 captions (the cut of Flickr30k's 1000 ×
                5000): score matrices finite, each reranked row with
                exactly min(k, n) entries off the −100.0 fill, R@k and the
                extrapolation; ALBEF's pass on a 16 × 80 cut profiled (busy
                share); CLIP's text over 77 tokens; ``BlipVQA.rank_answers``
                (16 questions × 128 candidates), ten greedy
                ``BlipCaption.decode_step`` calls at batch 4, a
                ``BlipNLVR`` forward and ``BlipClassification.predict``;
                ``cli.evaluate`` on configs/projects/blip/eval/
                ret_flickr_eval.yaml over 16 seeded .npy images (the
                processor's 384 set to 224: the factory builds the 224
                tower, as JAX's does); launches of rows 1 and 4 by route;
                every shape held in phase 3 (``check_zoo_kernels``: both
                dtypes, two identical calls bit-equal) and tiny float32
                BLIP-1, ALBEF and CLIP card vs CPU in phase 4
                (``zoo_sim_matrix`` within 1e-4, the reranked entries the
                same).  Remat: after the main path's and the Vicuna
                retrain, one KD step without per-block remat, one with it
                and one without again (``remat_check``): loss and every
                LoRA gradient bit-equal, both peaks and times printed;
 11c. leg path — the rest of the legacy zoo at full width, bf16 (the
                towers' linears stored in bf16), seeded random weights, a
                50 % per-linear magnitude mask on every linear: ALPRO
                (TimeSformer-B/16 at 224, 8 frames, MED fused from layer
                6) through ``RetrievalTask`` over 32 videos × 32 captions
                at k_test 32 (every score reranked; the cut of MSRVTT's 1k
                test at k_test 1000, extrapolated), ``AlproQA`` at batch 8
                (1500 answers), ``cli.evaluate`` on
                configs/projects/alpro/eval/msrvtt_ret_eval.yaml over 16
                seeded .npy frame stacks (the cut); PNP-VQA base (BLIP-1
                base ITM and captioner, the T5-XL FiD reader) through
                ``VQARCTask`` on 16 questions at batch 16, 5 captions (the
                yaml's 100: the cut) of up to 20 tokens, answers of up to
                20 (the relevance's backward on TMA + wgmma inside the
                serving pass, no bias gradient); GPT dialogue base through
                ``DialogueTask`` at batch 16 (three-turn dialogues through
                the ``gpt_dialogue`` processor, 32 rows of i3d_flow ⊕
                i3d_rgb ⊕ vggish features through ``gpt_video_ft``), and
                ``cli.evaluate`` on configs/projects/gpt/eval/
                dialogue_avsd_eval.yaml, which must fail with the JAX
                CLI's TypeError (its processors do not fit the AVSD
                items, in both packages); one backward over all
                parameters of BLIP-1 and ALBEF pretraining, CLIP, ALPRO
                retrieval, GPT dialogue (with the video regression) and
                the FiD reader (T5's position-bias gradient as the TMA +
                wgmma backward's output): finite losses and gradients,
                seconds, peaks, the backward's launches by route.  Every
                launch of rows 1 and 4-7 is recorded (``CallRecorder``)
                and, after the path, each signature is held against its
                plain version (``check_leg_kernels``: its dtype, its
                planned route, two calls bit-equal, the backward with the
                gradients it returned there); tiny float32 ALPRO, PNP-VQA
                and GPT dialogue card vs CPU in phase 4
                (``tiny_leg_check``); the timing phase times nine of the
                signatures (``leg_timed``);
 12. cli path — the launcher's T5 grid point ``prune_and_eval("wanda",
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
                every shape held in phase 3; two more eval calls on the
                checkpoint, ``--quantize_int4`` and ``--quantize_int8
                --w8a8 --int8_outliers 32`` (every linear in that form,
                the W8A8 switches off after the call, the answers equal to
                a direct ``generate_t5`` of the same quantized model); data
                and checkpoint deleted; each call's phases timed (build, calibration, prune, save,
                load, eval), the checkpoint's size, the peaks;
 13. cli train path — the launcher's T5 RESSA grid point
                ``train_ressa("wanda", 0.5, 0.5, kl_weight=0.1,
                max_train_samples=96)`` through the port's own ``cli.train``
                (argv composed by scripts/torch_launch_lib.py, rewritten
                only for the data's paths, the output dir, the seed and
                the device; the call made in this process) on full-width
                InstructBLIP-FlanT5-XL (seed 8) and the cli path's data:
                the Wanda prune with its masks kept (at batch 16, not the
                launcher's 1: the cut that keeps the command's time), 3 KD steps
                of SparseLoRA (LVQ, r 4/8/2) at batch 32, the sparse merge,
                the save; then ``eval_checkpoint``'s GQA instruct call with
                ``--strip_lora_masks``; each tower's masks 0.5 ± 0.01,
                merged weights 0 off their masks, every lora_b trained,
                finite losses, the artifacts under the JAX CLI's names,
                the restored weights equal to the trained ones, GQA exactly
                50.00, the answers equal to a direct ``generate_t5``'s; the
                launches of each of the CLI's phases (the masked matmul in
                the prune, sparse-LoRA and the TMA + wgmma backward in the
                retrain, no WMMA, no separate dbias, dense products in the
                eval), every shape held in phase 3 (the retrain's added
                from the train loader's batches), data and checkpoints
                deleted; the phases' seconds, both checkpoints' bytes, the
                free disk, the peaks;
 14. profile  — the main path once more under torch.profiler (prune,
                generate, one train step), the SparseGPT prune at 4/3/3
                blocks (the cut: timed unprofiled at that depth first)
                and the first-order path's Fisher (its attention
                backward's device time a sample) and EcoFLaP prune: device
                time by kernel group against each phase's unprofiled
                wall-clock.  The cut that keeps the command within its
                limit once the int4, W8A8 and GPTQ phases run: the grid
                path's prunes' traces are not taken (their walls stand in
                their own path; 74.8 s of the command on one H100);
 15. timing   — kernel, plain-version and library-call times (CUDA events,
                L2 flushed before each call) at the shapes the kernel line
                reports (``timed_shapes``; the cut that keeps the command's
                time: every other shape is held in phase 3, untimed),
                beside each kernel's bound; where the masked and sparse-LoRA
                matmuls run the Hopper loop, the WMMA loop too (forced
                through the wrappers' ``_loop`` argument); the attention
                backward's two bf16 routes (``_impl``) at the ViT's and
                LLaMA's training shapes; the backward with the position
                bias's gradient at
                the allocation's batch-16 and the Fisher's batch-1 shape —
                one TMA + wgmma call, in turns with the unfused route (the
                backward, then the separate dbias kernel), SDPA's backward
                with a mask gradient and the backward alone; the attention
                forward's two bf16 routes at the ViT's, LLaMA's and OPT's
                reported shapes; SDPA, the attention yardstick, on each
                of its backends, the fastest timed in turns with the
                kernel; the compressed path's reported prefill and decode
                shapes in every weight form on its planned loop (the
                Hopper loop, split or
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
outputs, the separate dbias kernel, the WMMA loop and the mma.sync
attention forward and backward in the Vicuna retrain, which must run the
sparse-LoRA kernel on the Hopper loop and the TMA + wgmma attention
forward and backward); the decode kernel in every generate
phase of a masked or int8 model, and no WMMA-loop launch at all in any
generate phase, the retrain step or the three VQA phases (which must run
the Hopper loop and the TMA + wgmma forward) or the caption pass, nor in
any phase of the Vicuna path, its prune included, and no mma.sync
attention forward there (LLaMA's d = 128 runs the TMA + wgmma kernel);
in the serving passes the draft's steps on the decode kernel, the dense
teacher on cuBLAS, no WMMA loop and no mma.sync forward; in the pruners
path the RIA, hybrid and soft-mask prunes' replays on the Hopper loop and
their generates' steps on the decode kernel, WoodFisher's and the unstrct
CLI call's backward on TMA + wgmma with the bias gradients as its
outputs (no mma.sync backward, no separate dbias kernel), and no linear
kernel in the CLI calls (no masks); in the OPT path, the Vicuna rank and
the C4 passes the masked matmul on the Hopper loop, the attention forward
on TMA + wgmma (OPT's d = 128 included), no decode-kernel launch (OPT
holds no mask; the rest runs at M > 64), no WMMA loop, no mma.sync
forward and no backward.
WMMA-loop launches left in other phases are printed with their shapes and
why the other loops refused them.

The last lines are the kernel JSON, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import json
import logging
import math
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
    # the serving passes (serving_path, on the VQA path's merged models):
    # the masked student's draft steps at M = 64 questions (the decode
    # kernel), T5's decoder and LLaMA's linears; LLaMA's draft cache primed
    # under the masked mode at M = 64 × 44 (32 query tokens + the longest
    # prompt's 13 minus its last).  The dense teacher's products are
    # cuBLAS's; the ViT, the Q-Former and T5's cross k/v run the *_vqa
    # rows.  serving_path fails if it launches a shape not listed
    ("t5_qkvo_spec_decode", 64, 2048, 2048),
    ("t5_wi_spec_decode", 64, 2048, 5120),
    ("t5_wo_spec_decode", 64, 5120, 2048),
    ("llama_qkvo_spec_decode", 64, 4096, 4096),
    ("llama_gate_up_spec_decode", 64, 4096, 11008),
    ("llama_down_spec_decode", 64, 11008, 4096),
    ("llama_qkvo_prime_spec", 2816, 4096, 4096),
    ("llama_gate_up_prime_spec", 2816, 4096, 11008),
    ("llama_down_prime_spec", 2816, 11008, 4096),
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
    # the serving passes on T5 (serving_path, 64 questions, max_len 10 +
    # the start token, γ = SPEC_GAMMA): the speculative caches hold
    # 11 + γ + 1 slots (per-row: 11 + 2γ + 1) — the draft's steps (n = 1)
    # and the verify chunk (n = γ + 1) over them, under the position bias
    # and the step visibility, per row (b, h, n, m) with per-row caches;
    # cross-attention over the 44 encoder tokens at n = 1 and γ + 1; the
    # dense teacher's greedy reference (and the int8 cache's teacher-forced
    # check) over the 11-slot cache
    ("t5_self_spec_draft", 64, 1, 16, 32, 64, ["rel", "step"], 1.0),
    ("t5_self_spec_verify", 64, 5, 16, 32, 64, ["rel", "step"], 1.0),
    ("t5_self_spec_rows_draft", 64, 1, 20, 32, 64, ["full", "bn"], 1.0),
    ("t5_self_spec_rows_verify", 64, 5, 20, 32, 64, ["full", "bn"], 1.0),
    ("t5_cross_spec_draft", 64, 1, 44, 32, 64, ["pad"], 1.0),
    ("t5_cross_spec_verify", 64, 5, 44, 32, 64, ["pad"], 1.0),
    ("t5_self_greedy_b64", 64, 1, 11, 32, 64, ["rel", "step"], 1.0),
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
# the CLI train path (cli_train_path): the launcher's RESSA call prunes
# the first CLI_TRAIN_SAMPLES of the CLI path's captions with its masks
# kept, so the prune's replays run the masked matmul.  At the cut's batch
# of CLI_TRAIN_PRUNE_BS consecutive captions every batch holds each of
# CLI_WORDS' lengths, so every prompt pads to the longest and all the
# stems fuse: the ViT at M = 96 × 257, the T5 encoder at M = 96 × (32 +
# 12) (the decoder's cross k/v too) and the decoder at M = 96 × 13, all on
# the Hopper loop; attention at b = 96 there, and at b = 16 where the T5
# stems' inputs run the dense ViT, Q-Former and (for the decoder's) T5
# encoder a batch.  Its retrain's
# shapes follow the train loader's batches: add_cli_train_shapes() adds
# them before phase 3
CLI_TRAIN_SAMPLES = 96
CLI_TRAIN_BS = 32           # continue_stage2_cc3m_t5_instruct.yaml's
# the cut that keeps the command's time: the launcher's --prune_batch_size
# 1 becomes 16 for the train call (the CLI path keeps batch 1)
CLI_TRAIN_PRUNE_BS = 16
CLI_TRAIN_PAD = max(CLI_WORDS)
VIT_LINEARS = (("qkv", 1408, 4224), ("proj", 1408, 1408),
               ("fc1", 1408, 6144), ("fc2", 6144, 1408))
T5_LINEARS = (("qkvo", 2048, 2048), ("wi", 2048, 5120), ("wo", 5120, 2048))
MM_SHAPES += [(f"vit_{name}_cli_train", CLI_TRAIN_SAMPLES * 257, k, n)
              for name, k, n in VIT_LINEARS]
MM_SHAPES += [shape for name, k, n in T5_LINEARS for shape in (
    (f"t5_{name}_cli_train", CLI_TRAIN_SAMPLES * (32 + CLI_TRAIN_PAD), k, n),
    (f"t5_dec_{name}_cli_train", CLI_TRAIN_SAMPLES * (CLI_TRAIN_PAD + 1), k,
     n))]
_q, _d = 32 + CLI_TRAIN_PAD, CLI_TRAIN_PAD + 1
FLASH_SHAPES += [
    ("vit_self_cli_train", CLI_TRAIN_SAMPLES, 257, 257, 16, 88, [],
     88 ** -0.5),
    ("qformer_self_cli_prune", CLI_TRAIN_PRUNE_BS, _q, _q, 12, 64, ["pad"],
     0.125),
    ("t5_encoder_cli_prune", CLI_TRAIN_PRUNE_BS, _q, _q, 32, 64,
     ["rel", "pad"], 1.0),
    ("t5_encoder_cli_train", CLI_TRAIN_SAMPLES, _q, _q, 32, 64,
     ["rel", "pad"], 1.0),
    ("t5_decoder_self_cli_train", CLI_TRAIN_SAMPLES, _d, _d, 32, 64,
     ["rel", "pad"], 1.0),
    ("t5_decoder_cross_cli_train", CLI_TRAIN_SAMPLES, _d, _q, 32, 64,
     ["pad"], 1.0)]
# the retrain's attention backward shapes (add_cli_train_shapes)
CLI_TRAIN_BWD_SHAPES: list = []
# the pruners path's first evaluate_woodfisher call (pruners_path) scores
# the GQA yaml's first WF_CLI_DATA questions at batch 1, forward and
# backward, each prompt at its own length (the Q-Former and the T5
# encoder over 32 query tokens + the prompt, the decoder over the label);
# add_wf_cli_shapes() adds them before phase 3 (the ViT and the Q-Former's
# cross-attention at batch 1 are the Fisher's)
WF_CLI_DATA = 8
WF_CLI_BWD_SHAPES: list = []
# the Vicuna path (vicuna_path): LLaMA's self-attention, 32 heads of
# d = 128 (the TMA + wgmma kernel at DP = 128, like every other tower's
# attention), under one additive bias as the JAX package builds it — the
# calibration sweep (causal + right-padded text, b = 128), the primes (the
# cache's pad bias over the left-padded prompt + the step visibility,
# n = P, m = P + max_length) and the decode steps (n = 1 over the whole
# cache) of the 4-request generate (b = 20) and of the VQA eval (b = 320).
# A list of its own (the Vicuna path's; phase 3 holds both routes at each
# shape, as at FLASH_SHAPES'; scripts/torch_fwd_check.py reads both).
# vicuna_path fails if it launches a shape not listed
VICUNA_FLASH_SHAPES = [
    ("llama_self_calib", 128, 72, 72, 32, 128, ["cpad"], 128 ** -0.5),
    ("llama_prime_gen", 20, 71, 81, 32, 128, ["lpad"], 128 ** -0.5),
    ("llama_decode_gen", 20, 1, 81, 32, 128, ["dstep"], 128 ** -0.5),
    ("llama_prime_vqa", 320, 44, 55, 32, 128, ["lpad"], 128 ** -0.5),
    ("llama_beam_step", 320, 1, 55, 32, 128, ["dstep"], 128 ** -0.5),
    # the retrain (vicuna_retrain): causal + pad over 32 query tokens + 40
    # text tokens at the train batch, the forward of the backward below
    ("llama_self_train", 32, 72, 72, 32, 128, ["cpad"], 128 ** -0.5),
    # the serving passes (serving_path, 64 questions): the primes of the
    # speculative caches (44 prefix slots + 11 + γ + 1, per-row + 2γ), the
    # draft's steps and the verify chunk (n = γ + 1) over them; the dense
    # teacher's greedy reference (and the int8 cache's teacher-forced
    # check) at b = 64 over 44 + 11 slots
    ("llama_prime_spec", 64, 44, 60, 32, 128, ["lpad"], 128 ** -0.5),
    ("llama_draft_spec", 64, 1, 60, 32, 128, ["dstep"], 128 ** -0.5),
    ("llama_verify_spec", 64, 5, 60, 32, 128, ["dstep"], 128 ** -0.5),
    ("llama_prime_spec_rows", 64, 44, 64, 32, 128, ["lpad"], 128 ** -0.5),
    ("llama_draft_spec_rows", 64, 1, 64, 32, 128, ["dstep"], 128 ** -0.5),
    ("llama_verify_spec_rows", 64, 5, 64, 32, 128, ["dstep"],
     128 ** -0.5),
    ("llama_prime_greedy", 64, 44, 55, 32, 128, ["lpad"], 128 ** -0.5),
    ("llama_step_greedy", 64, 1, 55, 32, 128, ["dstep"], 128 ** -0.5),
]
# the Vicuna shapes timed for the forward's row of the kernel line (the
# TMA + wgmma kernel at d = 128, the mma.sync route's time beside it): the
# VQA eval's prime and beam-decode step, the retrain's forward
FLASH_VICUNA_TIMED = ("llama_prime_vqa", "llama_beam_step",
                      "llama_self_train")
# the OPT path (opt_path; BLIP-2 OPT-6.7B, 32 heads of d = 128): OPT scales
# its queries before the product, so attention runs at scale 1 under the
# one additive bias LLaMA's takes (the cache's pad bias + the step
# visibility) — the 4-request generate's prime and steps (b = 20, the
# 40-token prompt minus its last after 32 query tokens), the GQA eval's
# (b = 320; the prompts 13 tokens with BOS, as Vicuna's); its speculative
# and int8-cache passes run the LLaMA rows' (b, n, m) at b = 64 and 320.
# OPT-2.7B's d = 80 (2560 / 32) at the GQA eval's prime and step is held
# here too, though no path runs that model.  The Q-Former takes no text:
# its self-attention runs over the 32 queries alone (b = 4 and 64).
# opt_path fails if it launches a shape not listed
OPT_FLASH_SHAPES = [
    ("opt_prime_gen", 20, 71, 81, 32, 128, ["lpad"], 1.0),
    ("opt_decode_gen", 20, 1, 81, 32, 128, ["dstep"], 1.0),
    ("opt_prime_vqa", 320, 44, 55, 32, 128, ["lpad"], 1.0),
    ("opt_beam_step", 320, 1, 55, 32, 128, ["dstep"], 1.0),
    ("opt27_prime_vqa", 320, 44, 55, 32, 80, ["lpad"], 1.0),
    ("opt27_beam_step", 320, 1, 55, 32, 80, ["dstep"], 1.0),
    ("qformer_query_self_gen", 4, 32, 32, 12, 64, [], 0.125),
]
VICUNA_FLASH_SHAPES += OPT_FLASH_SHAPES
# the OPT shapes timed for the forward's row of the kernel line
FLASH_OPT_TIMED = ("opt_prime_vqa", "opt_beam_step", "opt27_prime_vqa",
                   "opt27_beam_step")
# ranking on Vicuna (vicuna_rank, at the end of the Vicuna path): the rank
# pass of VICUNA_RANK_N questions over N_CANDS candidates (vqav2_eval.yaml's
# num_ans_candidates; the T5 rank pass runs 64 questions: the cut), the
# b · C rows through LLaMA in one chunk by the task and in chunks of
# VICUNA_RANK_CHUNK by a direct call; C4 perplexity (c4_pass) of C4_TEXTS
# seeded texts at the task's max_len 128, batch 1
# (c4_prefix_derivative_compute.yaml's batch_size_eval), on the main path's
# merged T5-XL and on the Vicuna 7B.  add_rank_c4_shapes() adds their
# shapes before phase 3
VICUNA_RANK_N = 16
VICUNA_RANK_CHUNK = 512
C4_TEXTS = 32
C4_LEN = 128
LLAMA_LINEARS = (("qkvo", 4096, 4096), ("gate_up", 4096, 11008),
                 ("down", 11008, 4096))
MM_SHAPES += [(f"vit_{name}_rank", VICUNA_RANK_N * 257, k, n)
              for name, k, n in VIT_LINEARS]
MM_SHAPES += [(f"t5_{name}_c4", C4_LEN, k, n) for name, k, n in T5_LINEARS]
MM_SHAPES += [(f"llama_{name}_c4", C4_LEN, k, n)
              for name, k, n in LLAMA_LINEARS]
FLASH_SHAPES += [
    ("t5_c4", 1, C4_LEN, C4_LEN, 32, 64, ["rel", "pad"], 1.0),
    ("llama_c4", 1, C4_LEN, C4_LEN, 32, 128, ["cpad"], 128 ** -0.5)]

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
    # self-attention: d = 128 (the TMA + wgmma kernel at DP = 128, its dV
    # and dQ products on a warpgroup of their own), under the one additive
    # causal + pad bias, which takes no gradient
    ("qformer_self_vicuna", 32, 66, 66, 12, 64, ["pad"], 0.125),
    ("llama_self", 32, 72, 72, 32, 128, ["cpad"], 128 ** -0.5),
]
BWD_TIMED = "vit_self"
# more backward gates at LLaMA's head dim (b, n, m, h, d, biases, scale,
# causal, dq, dk/dv): four q and kv tiles under the calibration's causal +
# pad bias, with dq alone and dk/dv alone; the causal flag at n = m and
# n > m
BWD_D128_EXTRA = [
    ("llama_cpad_200", 2, 200, 200, 8, 128, ["cpad"], 128 ** -0.5, False,
     True, True),
    ("llama_cpad_200_dq_only", 2, 200, 200, 8, 128, ["cpad"], 128 ** -0.5,
     False, True, False),
    ("llama_cpad_200_dkv_only", 2, 200, 200, 8, 128, ["cpad"], 128 ** -0.5,
     False, False, True),
    ("llama_causal_200", 2, 200, 200, 4, 128, [], 128 ** -0.5, True, True,
     True),
    ("llama_causal_200_130", 2, 200, 130, 4, 128, [], 128 ** -0.5, True,
     True, True)]


def bwd_at(batch: int) -> list:
    """The BWD_SHAPES shapes the TMA + wgmma backward takes (``plan``),
    at another batch: 1 for the diagonal Fisher, 16 for the first-order
    allocation's and the aobd pruner's passes (on the XL model: LLaMA's
    backward runs in the Vicuna retrain alone)."""
    from vlm_compression_tpu_torch.ops import attention as A

    return [(f"{name}_b{batch}", batch, n, m, h, d, kinds, scale)
            for name, _, n, m, h, d, kinds, scale in BWD_SHAPES
            if A.plan(n, m, d) == A.WGMMA and not name.startswith("llama")]


def bwd_held() -> list:
    """Every shape phase 3 holds the backward (and the forward it starts
    from) at against the plain version."""
    return (BWD_SHAPES + CLI_TRAIN_BWD_SHAPES + WF_CLI_BWD_SHAPES
            + bwd_at(1) + bwd_at(16))


def cli_train_lengths() -> list:
    """The longest caption (words) of each of the train call's batches, in
    its loader's order (shuffled from seed 0, the ragged tail dropped)
    over the first CLI_TRAIN_SAMPLES captions of ``cli_data``."""
    from vlm_compression_tpu_torch.datasets.loaders import DataLoader

    words = [CLI_WORDS[i % len(CLI_WORDS)] for i in range(CLI_TRAIN_SAMPLES)]
    return sorted({max(b) for b in DataLoader(words, CLI_TRAIN_BS,
                                              shuffle=True, drop_last=True)})


def add_cli_train_shapes() -> list:
    """The train call's retrain shapes at batch CLI_TRAIN_BS, for each
    batch's longest caption L (``cli_train_lengths``): the Q-Former's
    self-attention and the T5 encoder over 32 query tokens + L, the
    decoder over the L + 1 label tokens (sparse-LoRA at r = 8 on both;
    the ViT's and the Q-Former's cross-attention are the main path's),
    added to the lists phase 3 holds.  Returns the lengths."""
    lengths = cli_train_lengths()
    for words in lengths:
        q, d = 32 + words, words + 1
        CLI_TRAIN_BWD_SHAPES.extend([
            (f"qformer_self_cli_train{words}", CLI_TRAIN_BS, q, q, 12, 64,
             ["pad"], 0.125),
            (f"t5_encoder_cli_train{words}", CLI_TRAIN_BS, q, q, 32, 64,
             ["rel", "pad"], 1.0),
            (f"t5_decoder_self_cli_train{words}", CLI_TRAIN_BS, d, d, 32, 64,
             ["relc", "pad"], 1.0),
            (f"t5_decoder_cross_cli_train{words}", CLI_TRAIN_BS, d, q, 32,
             64, ["pad"], 1.0)])
        LORA_SHAPES.extend(
            [(f"t5_enc_{name}_cli_train{words}", CLI_TRAIN_BS * q, k, n, 8)
             for name, k, n in T5_LINEARS]
            + [(f"t5_dec_{name}_cli_train{words}", CLI_TRAIN_BS * d, k, n, 8)
               for name, k, n in T5_LINEARS])
    return lengths

def wf_cli_lengths() -> list:
    """(Q-Former prompt, T5 prompt, label) token counts of each of the
    first WF_CLI_DATA GQA questions as evaluate_woodfisher's scoring
    loader prepares them at batch 1: the yaml's ``blip_question``
    processor, the CLI's tokenizers and ``cli_data``'s answer."""
    import numpy as np

    from vlm_compression_tpu_torch.datasets.processors import (
        BlipQuestionProcessor,
    )
    from vlm_compression_tpu_torch.datasets.tokenization import (
        load_tokenizer,
    )
    from vlm_compression_tpu_torch.models.qformer import QFormerConfig
    from vlm_compression_tpu_torch.models.t5 import T5Config
    from vlm_compression_tpu_torch.tasks.preparers import (
        make_t5_batch_preparer,
    )

    prepare = make_t5_batch_preparer(
        load_tokenizer(None, vocab_size=T5Config.flan_t5_xl().vocab_size),
        load_tokenizer(None, vocab_size=QFormerConfig().vocab_size))
    out = []
    for q in map(BlipQuestionProcessor(), vqa_questions(WF_CLI_DATA)):
        b = prepare({"image": np.zeros((1, 1, 1, 3), np.float32),
                     "text_input": [q], "text_output": [NEVER]})
        out.append((b["qformer_input_ids"].shape[1],
                    b["input_ids"].shape[1], b["labels"].shape[1]))
    return out


def add_wf_cli_shapes() -> list:
    """The attention shapes (forward and backward) of the first
    evaluate_woodfisher call's batch-1 scoring, added to the lists phase
    3 holds.  Returns the (Q-Former, T5, label) lengths."""
    lengths = sorted(set(wf_cli_lengths()))
    for lq, lt, ll in lengths:
        q, t = 32 + lq, 32 + lt
        WF_CLI_BWD_SHAPES.extend([
            (f"qformer_self_wf{lq}", 1, q, q, 12, 64, ["pad"], 0.125),
            (f"t5_encoder_wf{lt}", 1, t, t, 32, 64, ["rel", "pad"], 1.0),
            (f"t5_decoder_self_wf{ll}", 1, ll, ll, 32, 64, ["relc", "pad"],
             1.0),
            (f"t5_decoder_cross_wf{ll}_{lt}", 1, ll, t, 32, 64, ["pad"],
             1.0)])
    return lengths

def vicuna_rank_lengths() -> tuple:
    """(prompt, candidate) tokens of the Vicuna rank pass as the task
    encodes them: the first VICUNA_RANK_N questions' prompts right-padded
    (no BOS) and the candidates at the task's max_len."""
    from vlm_compression_tpu_torch.datasets.processors import (
        BlipQuestionProcessor,
    )
    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
        batch_encode,
    )

    tok = SimpleTokenizer(32000)
    prompts = [VQA_PROMPT.format(q) for q in map(
        BlipQuestionProcessor(), vqa_questions(VICUNA_RANK_N))]
    return (batch_encode(tok, prompts, 128)[0].shape[1],
            batch_encode(tok, rank_candidates(),
                         VQA_RUN["max_len"])[0].shape[1])


def add_rank_c4_shapes() -> tuple:
    """The Vicuna rank pass's shapes, added to the lists phase 3 holds:
    LLaMA over [32 query tokens ⊕ prompt ⊕ candidate] for every (question,
    candidate) row — the task's chunk (the default, by
    ``predict_class_vicuna``'s logit budget) and the direct call's
    VICUNA_RANK_CHUNK rows — and the Q-Former's self-attention over 32 +
    the prompt at VICUNA_RANK_N images.  Returns (prompt, candidate,
    sequence, the task's rows a chunk)."""
    from vlm_compression_tpu_torch.models import blip2_vicuna_instruct as BV

    p, c = vicuna_rank_lengths()
    n = 32 + p + c
    total = VICUNA_RANK_N * N_CANDS
    rows = max(1, BV._LOGIT_BYTES // (c * 32000 * 4))
    sizes = {f"llama_rank{b}": b for per in (rows, VICUNA_RANK_CHUNK)
             for b in {min(per, total - r0) for r0 in range(0, total, per)}}
    for name, b in sorted(sizes.items()):
        VICUNA_FLASH_SHAPES.append((name, b, n, n, 32, 128, ["cpad"],
                                    128 ** -0.5))
        MM_SHAPES.extend((f"llama_{lin}_{name}", b * n, k, nn)
                         for lin, k, nn in LLAMA_LINEARS)
    FLASH_SHAPES.append(("qformer_self_rank", VICUNA_RANK_N, 32 + p, 32 + p,
                         12, 64, ["pad"], 0.125))
    return p, c, n, rows


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
    # the TMA + wgmma backward's d = 128 instantiation with its dbias
    # output: four q and kv tiles, the causal flag hiding some
    ("rel_causal_d128", 2, 200, 200, 4, 128, ["rel"], 128 ** -0.5, True),
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
        elif kind == "medc":
            # MED's causal mask with its right padding, one (b, 1, n, m)
            # bias; the first key always kept
            keep = torch.rand(b, 1, 1, m, generator=g, device="cuda") < 0.9
            keep[..., 0] = True
            vis = (torch.arange(m, device="cuda")[None, :]
                   <= torch.arange(n, device="cuda")[:, None] + (m - n))
            biases.append(torch.where(keep & vis, 0.0, NEG_INF))
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
    over the slots at −1e9, and so must the kernel); "dstep" the pad bias
    + the visibility of a decode step (n = 1: up to slot m − 4) or of a
    speculative verify chunk (query i up to slot m − 3 − n + i)."""
    from vlm_compression_tpu_torch.ops.attention import NEG_INF

    pads = torch.randint(0, 4, (b,), generator=g, device="cuda")
    j = torch.arange(m, device="cuda")
    if kind == "cpad":
        keep = j[None, :] < (m - pads)[:, None]
        cur = 0
    else:
        first = 0 if kind == "lpad0" else 32
        keep = (j[None, :] < first) | (j[None, :] >= first + pads[:, None])
        cur = m - 3 - n if kind == "dstep" else 0
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
        # wgmma kernel at every shape here, LLaMA's d = 128 included) and,
        # in bf16, on the mma.sync route too; causal masking, including
        # n > m rows that see no key
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
    # calls of the planned route (TMA + wgmma, at LLaMA's d = 128 too) at
    # every shape are bit-equal, LLaMA's rows that see no valid key
    # included
    for name, b, n, m, h, d, kinds, scale in \
            FLASH_SHAPES + VICUNA_FLASH_SHAPES + [
                ("llama_rows_seeing_no_key", 4, 44, 55, 32, 128, ["lpad0"],
                 128 ** -0.5)]:
        q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, torch.bfloat16)
        route = A.plan_forward(n, m, d)
        out1, lse1 = A.flash_attention(q, k_, v, biases, scale, _impl=route)
        out2, lse2 = A.flash_attention(q, k_, v, biases, scale, _impl=route)
        if not (torch.equal(out1, out2) and torch.equal(lse1, lse2)):
            raise AssertionError(f"flash_attention {name} ({route}): two "
                                 "identical calls differ")
    log("  flash_attention, the planned bf16 route: two identical calls "
        "bit-equal (out and lse) at every FLASH_SHAPES and "
        "VICUNA_FLASH_SHAPES shape and llama_rows_seeing_no_key")
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
        # LLaMA's d = 128 at four q and kv tiles (the dK warpgroup reuses
        # each Pᵀ and dSᵀ buffer after the dV/dQ one frees it), causal, and
        # with dq alone (no dK or dV product) and dk/dv alone (no dQ
        # product)
        cases += BWD_D128_EXTRA
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
            # where the plan is mma.sync already, once
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
    # calls of the planned route are bit-equal at every training shape, at
    # the towers' batch 1 and 16 and at LLaMA's d = 128 over four kv tiles
    for name, b, n, m, h, d, kinds, scale in bwd_held() + [
            c[:8] for c in BWD_D128_EXTRA if c[9] and c[10] and not c[8]]:
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
    from vlm_compression_tpu_torch.models.blip2_t5_instruct import generate_t5
    from vlm_compression_tpu_torch.models.generation import GenerationConfig

    tiny_serving_check(
        cpu, generate_t5, [batch[k] for k in (
            "image", "input_ids", "attention_mask", "qformer_input_ids",
            "qformer_attention_mask")],
        GenerationConfig(num_beams=1, max_length=8, min_length=2,
                         eos_token_id=1, pad_token_id=0),
        "InstructBLIP-T5")
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


def tiny_serving_check(cpu, generate, args, gen_cfg, label):
    """Speculative decoding and the KV-cache forms on a tiny float32 model
    with random masks (``generate``: ``generate_t5`` or
    ``generate_vicuna``), the card (kernels) vs the CPU (plain versions):
    with batch-shared and per-row caches, each with and without the int8
    cache, the speculative output at γ 2 and 4 (the masked student drafts,
    the dense teacher verifies) equals plain greedy under the dense mode
    token for token on each device, and the card's tokens, rounds and
    commits equal the CPU's."""
    from vlm_compression_tpu_torch.models.factory import set_kv_cache_

    gpu = copy.deepcopy(cpu).to("cuda")
    reset_counts()
    rounds = {}
    try:
        with torch.no_grad():
            for per_row in (False, True):
                for int8 in (False, True):
                    out = {}
                    for m, dev in ((cpu, "cpu"), (gpu, "cuda")):
                        set_kv_cache_(m, int8=int8, per_row=per_row)
                        a = [t.to(dev) for t in args]
                        greedy = generate(m, *a, gen_cfg=gen_cfg,
                                          llm_mode="dense").cpu()
                        out[dev] = [greedy]
                        for gamma in (2, 4):
                            stats = {}
                            spec = generate(
                                m, *a, gen_cfg=gen_cfg, llm_mode="dense",
                                draft_llm_mode="masked",
                                speculative_gamma=gamma, stats=stats).cpu()
                            out[dev] += [spec, stats]
                            if not torch.equal(spec, greedy):
                                raise AssertionError(
                                    f"tiny {label} serving check: γ {gamma} "
                                    f"(per_row={per_row}, int8={int8}) on "
                                    f"{dev}: {spec.tolist()} against greedy "
                                    f"{greedy.tolist()}")
                    key = ("per-row" if per_row else "shared") + (
                        " int8" if int8 else "")
                    rounds[key] = [st["rounds"] for st in out["cuda"][2::2]]
                    if not all(torch.equal(x, y) if torch.is_tensor(x)
                               else x == y
                               for x, y in zip(out["cpu"], out["cuda"])):
                        raise AssertionError(
                            f"tiny {label} serving check ({key}): card "
                            f"{out['cuda']} against CPU {out['cpu']}")
    finally:
        set_kv_cache_(cpu)
    c = read_counts()
    log(f"  tiny fp32 {label} speculative decoding (γ 2, 4; masked draft, "
        f"dense target) and the KV-cache forms, card vs CPU: tokens equal "
        f"to dense greedy on both, card = CPU (tokens, rounds, commits); "
        f"rounds by cache form at γ 2, 4 {json.dumps(rounds)}; "
        f"masked_matmul launches {c['masked_matmul']}, attention forwards "
        f"{c['flash_attention']}")
    if not (c["masked_matmul"] > 0 and c["flash_attention"] > 0):
        raise AssertionError(f"tiny {label} serving check: no launches")
    del gpu


def tiny_loader_check():
    """The package-level loaders at tiny size, card against CPU:
    ``load_model_and_preprocess("blip2_t5_instruct", tiny=True)`` built on
    the CPU, its state saved, and ``load_model(..., device="cuda",
    checkpoint=...)`` reading it back (every tensor equal); the two
    models' masked forward (bf16: the factory's dtype policy) within the
    bf16 tolerance, the card's on its kernels (a random mask on every
    linear); the processors' arrays equal on one image; ``load_pruner``
    building the registry's class on the card's model."""
    import vlm_compression_tpu_torch as T
    from vlm_compression_tpu_torch.models.layers import SparseLinear, set_mask

    cpu, vis, txt = T.load_model_and_preprocess("blip2_t5_instruct",
                                                tiny=True, device="cpu")
    g = torch.Generator().manual_seed(17)
    for m in cpu.modules():
        if isinstance(m, SparseLinear) and m.kernel is not None:
            set_mask(m, torch.rand(m.kernel.shape, generator=g) < 0.5)
    with tempfile.TemporaryDirectory(prefix="loader_") as tmp:
        path = os.path.join(tmp, "tiny.pt")
        torch.save(cpu.state_dict(), path)
        gpu = T.load_model("blip2_t5_instruct", tiny=True, device="cuda",
                           checkpoint=path)
    want = cpu.state_dict()
    same = all(torch.equal(t.cpu(), want[k])
               for k, t in gpu.state_dict().items())
    pixels = torch.randint(0, 256, (37, 45, 3), generator=g,
                           dtype=torch.uint8).numpy()
    img = cpu.cfg.vit.img_size
    image = torch.from_numpy(vis["eval"](pixels))[None].expand(2, img, img,
                                                               3)
    ids = torch.randint(3, 60, (2, 6), generator=g, dtype=torch.int32)
    batch = dict(image=image, input_ids=ids,
                 attention_mask=torch.ones_like(ids), labels=ids[:, :4],
                 qformer_input_ids=ids,
                 qformer_attention_mask=torch.ones_like(ids))
    reset_counts()
    with torch.no_grad():
        lc = cpu(**batch)["logits"]
        lg = gpu(**{k: v.cuda() for k, v in batch.items()})["logits"].cpu()
    launched = read_counts()
    err, scale = max_err(lg, lc)
    pruner = T.load_pruner("vit_wanda_pruner", gpu.visual_encoder, [],
                           vit_prune_spec="2-0.5-1.0-1.0")
    log(f"  tiny load_model / load_model_and_preprocess, card vs CPU: "
        f"state dicts equal {same}; processors {sorted(vis)} / "
        f"{sorted(txt)} at {img}px (eval image {tuple(image.shape[1:])}); "
        f"masked logits max_abs_err={err:.3e} (tol "
        f"{TOL['bfloat16'] * scale:.3e}); masked_matmul launches "
        f"{launched['masked_matmul']}; load_pruner gives "
        f"{type(pruner).__name__}")
    if not (same and err <= TOL["bfloat16"] * scale
            and launched["masked_matmul"] > 0
            and type(pruner) is T.registry.get_pruner_class(
                "vit_wanda_pruner")
            and txt["eval"]("A Dog!") == "a dog"):
        raise AssertionError("tiny loader check")
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
# mma.sync kernel, for views TMA cannot take and d off the wgmma kernel's,
# and the fp32 one)
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
# the Vicuna path: every attention forward on TMA + wgmma, LLaMA's (d =
# 128) too, none on the mma.sync kernel; no backward, and no WMMA-loop
# launch in any of its phases (the prune included)
VICUNA_GEN = SERVE + (FWD_WGMMA,)
PHASE_KERNELS.update(
    vicuna_prune=PRUNE + (FWD_WGMMA,),
    generate_vicuna_cold=VICUNA_GEN, generate_vicuna_warm=VICUNA_GEN,
    vqa_vicuna_gqa=VQA, vqa_vicuna_okvqa=VQA)
PHASE_FORBIDDEN.update(vicuna_prune=BACKWARD + (WMMA_LOOP, FWD_MMA))
# the Vicuna retrain: sparse-LoRA on the Hopper loop (ViT r 4, LLaMA r 8),
# every attention forward and backward on TMA + wgmma (LLaMA's d = 128
# included), none on the mma.sync kernels; no bias takes a gradient (no
# dbias output, no separate dbias kernel) and nothing runs the WMMA loop;
# then the merged model's generate
PHASE_KERNELS.update(
    vicuna_retrain=("sparse_lora_matmul", "flash_attention", FWD_WGMMA,
                    BWD_WGMMA, WGMMA_LOOP),
    generate_vicuna_merged=VICUNA_GEN)
PHASE_FORBIDDEN.update(vicuna_retrain=(
    "flash_attention_bwd_dbias", BWD_DBIAS, WMMA_LOOP, FWD_MMA,
    "flash_attention_bwd_dq", "flash_attention_bwd_dkv"))
# the Vicuna grid's DSnoT entry sweeps as the Wanda prune does (its
# refinement runs no kernel of the port); then the generate
PHASE_KERNELS.update(vicuna_dsnot_prune=PRUNE + (FWD_WGMMA,),
                     generate_vicuna_dsnot=VICUNA_GEN)
PHASE_FORBIDDEN.update(vicuna_dsnot_prune=BACKWARD + (WMMA_LOOP, FWD_MMA))
for _phase in ("generate_vicuna_cold", "generate_vicuna_warm",
               "vqa_vicuna_gqa", "vqa_vicuna_okvqa", "generate_vicuna_merged",
               "generate_vicuna_dsnot"):
    PHASE_FORBIDDEN[_phase] = PHASE_FORBIDDEN.get(_phase, ()) + (FWD_MMA,)
# the serving passes (serving_path) on the VQA path's merged T5 and on the
# pruned Vicuna: the ViT and Q-Former at b = 64 on the Hopper loop and
# every attention on TMA + wgmma in all of them; the dense teacher's
# greedy reference decodes on cuBLAS (no decode-sized masked product);
# the speculative passes' draft steps (the masked student at M = 64) on
# the decode kernel; the int8-cache beam passes at M = 320 on the Hopper
# loop.  No WMMA loop, no mma.sync forward (LLaMA's d = 128 included), no
# backward anywhere
SERVE_FAMILIES = ("t5", "vicuna")
for _fam in SERVE_FAMILIES:
    for _when in ("cold", "warm"):
        PHASE_KERNELS[f"serve_{_fam}_greedy_{_when}"] = VQA
        PHASE_FORBIDDEN[f"serve_{_fam}_greedy_{_when}"] = BACKWARD + (
            DECODE, WMMA_LOOP, FWD_MMA)
        for _form in ("spec", "spec_rows"):
            PHASE_KERNELS[f"serve_{_fam}_{_form}_{_when}"] = VQA + (DECODE,)
            PHASE_FORBIDDEN[f"serve_{_fam}_{_form}_{_when}"] = BACKWARD + (
                WMMA_LOOP, FWD_MMA)
        PHASE_KERNELS[f"serve_{_fam}_kv8_{_when}"] = VQA
        PHASE_FORBIDDEN[f"serve_{_fam}_kv8_{_when}"] = BACKWARD + (
            WMMA_LOOP, FWD_MMA)
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
# the OPT path: the ViT's Wanda prune, then every pass of the pruned model —
# its ViT on the Hopper loop (M ≥ 4 × 257), every attention on TMA + wgmma
# (OPT's d = 128 included), OPT's linears plain products (the JAX pruners
# sweep no OPT tower: it holds no mask, so no decode-kernel launch); no
# backward, no WMMA loop, no mma.sync forward anywhere
OPT_PHASES = ("generate_opt_cold", "generate_opt_warm", "vqa_opt_gqa",
              "opt_gqa_direct", "vqa_opt_spec", "opt_spec_direct",
              "vqa_opt_kv8", "opt_kv8_direct")
PHASE_KERNELS["opt_prune"] = PRUNE + (FWD_WGMMA,)
PHASE_FORBIDDEN["opt_prune"] = BACKWARD + (WMMA_LOOP, FWD_MMA)
for _phase in OPT_PHASES:
    PHASE_KERNELS[_phase] = VQA
    PHASE_FORBIDDEN[_phase] = BACKWARD + (DECODE, WMMA_LOOP, FWD_MMA)
# ranking on the pruned Vicuna (the ViT at M = 16 × 257, LLaMA over the
# b · C rows, all on the Hopper loop) and C4 perplexity at batch 1 (M =
# 128: the Hopper loop, not the decode kernel) on T5-XL and Vicuna
for _phase in ("vicuna_rank", "vicuna_rank_direct", "c4_t5", "c4_vicuna"):
    PHASE_KERNELS[_phase] = VQA
    PHASE_FORBIDDEN[_phase] = BACKWARD + (DECODE, WMMA_LOOP, FWD_MMA)
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
# the CLI train path: the train call's phases as its PhaseTimer names them
# — the build, the calibration data and the save launch nothing; the
# prune keeps its masks (prune(lora_model=True)), so its replays run the
# masked matmul (every fused stem on the Hopper loop, none at a decode
# shape) and no backward; the retrain runs
# sparse-LoRA on the Hopper loop and the attention forward and backward
# on TMA + wgmma, no bias gradient and no WMMA loop; then the eval call on
# the checkpoint with its masks stripped and the direct generates run
# dense products, as the CLI path's do
NOTHING = KERNELS + (WGMMA_LOOP, FWD_WGMMA, BWD_WGMMA, WMMA_LOOP, BWD_DBIAS)
CLI_TRAIN_PHASES = ("cli_train_build", "cli_train_calibration",
                    "cli_train_prune", "cli_train_retrain", "cli_train_save")
for _phase in ("cli_train_build", "cli_train_calibration", "cli_train_save"):
    PHASE_KERNELS[_phase] = ()
    PHASE_FORBIDDEN[_phase] = NOTHING
PHASE_KERNELS.update(
    cli_train_prune=PRUNE + (FWD_WGMMA,),
    cli_train_retrain=("sparse_lora_matmul", "flash_attention", FWD_WGMMA,
                       BWD_WGMMA, WGMMA_LOOP))
PHASE_FORBIDDEN.update(
    cli_train_prune=BACKWARD + ("sparse_lora_matmul", "masked_matmul_packed",
                                "int8_matmul", DECODE, WMMA_LOOP),
    cli_train_retrain=("flash_attention_bwd_dbias", BWD_DBIAS, WMMA_LOOP,
                       "masked_matmul_packed", "int8_matmul"))
for _phase in ("cli_train_truth", "cli_train_eval", "cli_train_direct"):
    PHASE_KERNELS[_phase] = PHASE_KERNELS["cli_eval"]
    PHASE_FORBIDDEN[_phase] = PHASE_FORBIDDEN["cli_eval"]
# the pruners path: RIA, hybrid-tile and soft-mask prunes keep their
# masks (the Wanda sweep's kernels, no backward), their generates run the
# Hopper loop and the decode kernel; WoodFisher's per-sample gradients
# run the attention backward on TMA + wgmma with the position bias's
# gradient as its output (no mma.sync backward, no separate dbias kernel,
# no linear kernel: the model holds no mask); the evaluate_woodfisher
# calls (the unstrct one scores with the same backward, the merge one
# does not) and the direct generates after them run dense products
WF_LINEAR = ("masked_matmul", "masked_matmul_packed", "int8_matmul",
             "sparse_lora_matmul", DECODE, WGMMA_LOOP, WMMA_LOOP)
WF_BACKWARD = (BWD_WGMMA, BWD_DBIAS)
for _phase in ("pruners_wanda_prune", "ria_prune", "hybrid_prune",
               "softmask_prune"):
    PHASE_KERNELS[_phase] = PRUNE + (FWD_WGMMA,)
    PHASE_FORBIDDEN[_phase] = BACKWARD + (WMMA_LOOP, FWD_MMA)
for _phase in ("generate_ria", "generate_hybrid", "generate_softmask"):
    PHASE_KERNELS[_phase] = SERVE + (FWD_WGMMA,)
    PHASE_FORBIDDEN[_phase] = BACKWARD + (FWD_MMA,)
PHASE_KERNELS.update(
    woodfisher=("flash_attention", FWD_WGMMA) + WF_BACKWARD,
    wf_cli_unstrct=("flash_attention", FWD_WGMMA) + WF_BACKWARD,
    wf_cli_unstrct_direct=("flash_attention", FWD_WGMMA),
    wf_cli_merge=("flash_attention", FWD_WGMMA),
    wf_cli_merge_direct=("flash_attention", FWD_WGMMA))
_MMA_BACKWARD = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dbias")
PHASE_FORBIDDEN.update(
    woodfisher=_MMA_BACKWARD + WF_LINEAR + (FWD_MMA,),
    wf_cli_unstrct=_MMA_BACKWARD + WF_LINEAR + (FWD_MMA,),
    wf_cli_unstrct_direct=BACKWARD + WF_LINEAR + (FWD_MMA,),
    wf_cli_merge=BACKWARD + WF_LINEAR + (FWD_MMA,),
    wf_cli_merge_direct=BACKWARD + WF_LINEAR + (FWD_MMA,))
# the compressed path's int4 forms: the masked products on the
# dequantized weights (the bool kernel with bool masks, the packed one with
# packed), prefill on the Hopper loop, decode steps on the decode kernel,
# never the int8 kernel; its W8A8 forms: every linear an int8 × int8
# product (torch._int_mm), so no matmul kernel of the port at all
W8A8_OUTLIERS = 32
INT4_FORMS = ("int4_bool", "int4_packed128")
W8A8_FORMS = ("w8a8", f"w8a8_out{W8A8_OUTLIERS}")
NO_LINEAR_KERNEL = ("masked_matmul", "masked_matmul_packed", "int8_matmul",
                    "sparse_lora_matmul", DECODE, WGMMA_LOOP, WMMA_LOOP)
for _when in ("cold", "warm"):
    PHASE_KERNELS[f"generate_int4_bool_{_when}"] = SERVE + (FWD_WGMMA,)
    PHASE_FORBIDDEN[f"generate_int4_bool_{_when}"] = BACKWARD + (
        "int8_matmul", "masked_matmul_packed")
    PHASE_KERNELS[f"generate_int4_packed128_{_when}"] = (
        "masked_matmul_packed", "flash_attention", FWD_WGMMA, WGMMA_LOOP,
        DECODE)
    PHASE_FORBIDDEN[f"generate_int4_packed128_{_when}"] = BACKWARD + (
        "int8_matmul", "masked_matmul")
    for _form in W8A8_FORMS:
        PHASE_KERNELS[f"generate_{_form}_{_when}"] = ("flash_attention",
                                                      FWD_WGMMA)
        PHASE_FORBIDDEN[f"generate_{_form}_{_when}"] = BACKWARD \
            + NO_LINEAR_KERNEL
# the quant path: the GPTQ prunes replay their blocks through the masked
# matmul (no backward), the generate after them as the other generates
PHASE_KERNELS.update(gptq_prune=PRUNE + (FWD_WGMMA,),
                     awq_vit_prune=PRUNE + (FWD_WGMMA,),
                     generate_gptq=SERVE + (FWD_WGMMA,))
PHASE_FORBIDDEN.update(gptq_prune=BACKWARD + (WMMA_LOOP, FWD_MMA),
                       awq_vit_prune=BACKWARD + (WMMA_LOOP, FWD_MMA),
                       generate_gptq=BACKWARD + (FWD_MMA,))
# the CLI path's quantized eval calls and their direct generates: no
# masks, so int4 is a plain product on the dequantized weight and W8A8 an
# int8 × int8 one: attention alone
CLI_QUANT_PHASES = ("cli_eval_int4", "cli_direct_int4", "cli_eval_w8a8",
                    "cli_direct_w8a8")
for _phase in CLI_QUANT_PHASES:
    PHASE_KERNELS[_phase] = ("flash_attention", FWD_WGMMA)
    PHASE_FORBIDDEN[_phase] = BACKWARD + NO_LINEAR_KERNEL
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


def d128_launches(shapes: dict) -> dict:
    """LLaMA's d = 128 attention launches, forward and backward, by route
    in each phase (``shapes``: phase → ``read_shapes()``)."""
    out = {}
    for phase, tally in shapes.items():
        row = {"forward": {}, "backward": {}}
        for part, key in (("forward", "attention"),
                          ("backward", "attention_bwd")):
            for (_, _, _, _, d, route), c in tally[key].items():
                if d == 128:
                    row[part][route] = row[part].get(route, 0) + c
        out[phase] = row
    return out


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


def rank_candidates() -> list:
    """N_CANDS distinct seeded candidate answers of 1-3 words."""
    rng = random.Random(VQA_RUN["seed"] + 1)
    vocab = VQA_WORDS["answer"] + VQA_WORDS["noun"]
    cands = []
    while len(cands) < N_CANDS:
        c = " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3)))
        if c not in cands:
            cands.append(c)
    return cands


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
    mm = {(m, k, n) for _, m, k, n in MM_SHAPES + SERVE_SHAPES} \
        | {(m, k, n) for _, m, k, n, _ in zoo_mm_shapes()}
    lora = {(m, k, n, r) for _, m, k, n, r in LORA_SHAPES}
    fl = {tuple(c[1:6]) for c in FLASH_SHAPES + VICUNA_FLASH_SHAPES
          + zoo_flash_shapes()} | held_bwd
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
        cands = rank_candidates()
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


# speculative decoding and the int8 / per-row KV caches (serving_path) on
# the VQA path's models, through GQATask at the eval yaml's settings with
# the run config's speculative_gamma (the masked student drafts, the dense
# teacher verifies, greedy), and its beam-5 pass with the int8 cache
SPEC_GAMMA = 4
# the int8 cache's teacher-forced decode logits against the bf16 cache's:
# relative RMS at every step, the bound the serving slice was asked to
# meet; a miss is printed and recorded, not a failure (the gate on the
# int8 path is layer 0's codes, bit for bit)
KV8_REL_RMS = 5e-2


@contextlib.contextmanager
def recording(module, name: str, into: list):
    """``module.name`` (a generate the task calls) wrapped to keep each
    output (the token rows) in ``into`` while the context lasts."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        into.append(out.cpu())
        return out

    setattr(module, name, wrapped)
    try:
        yield into
    finally:
        setattr(module, name, fn)


@torch.no_grad()
def forced_logits(model, enc, seqs, mode: str, vicuna: bool):
    """Teacher-forced decode of ``seqs`` (b, L) through the KV cache of
    the model's current form at ``mode`` (the ViT and Q-Former masked, as
    the tasks run them): (the logits that predicted columns 1 … L − 1,
    (b, L − 1, V) fp32; the cache after the last step)."""
    from vlm_compression_tpu_torch.models.blip2_vicuna_instruct import (
        prefix_inputs,
    )
    from vlm_compression_tpu_torch.models.generation import make_t5_step
    from vlm_compression_tpu_torch.models.llama import make_causal_step

    image, ids, mask, q_ids, q_mask = enc
    L = seqs.shape[1]
    if vicuna:
        prefix = model.encode_image(image, "masked", q_ids, q_mask, "masked")
        pe, pm = prefix_inputs(model.llm_model, prefix, ids[:, :-1],
                               mask[:, :-1].to(torch.int32))
        step, cache = make_causal_step(model.llm_model, pe, pm, mode=mode,
                                       max_decode_len=L)
    else:
        e, em = model.encode_multimodal(image, ids, mask, q_ids, q_mask,
                                        "masked", mode, "masked")
        step, cache = make_t5_step(model.t5_model, e, em, mode, L)
    seqs = seqs.to(image.device)
    out = []
    for i in range(L - 1):
        logits, cache = step(seqs[:, i:i + 1], cache)
        out.append(logits[:, -1].float())
    return torch.stack(out, dim=1), cache


def kv_cache_bytes(layers: int, b: int, slots: int, h: int, d: int,
                   dtype, int8: bool) -> int:
    """Bytes of a decoder's self-attention caches, from the buffers
    ``init_kv_cache`` allocates (on the meta device: no memory)."""
    from vlm_compression_tpu_torch.models.kvcache import init_kv_cache

    kv = init_kv_cache(b, slots, h, d, dtype, "meta", int8=int8)
    return layers * sum(t.numel() * t.element_size() for t in kv.values()
                        if torch.is_tensor(t))


def serving_path(model, cfg, vicuna: bool):
    """The decoding half of the serving extras on a full-width pruned model
    (its masks kept), reused as built: the GQA eval of 64 questions through
    ``GQATask`` at the eval yaml's settings — the dense teacher's greedy
    decode (``generate_t5`` / ``generate_vicuna``, llm_mode "dense": the
    reference), then ``speculative_gamma`` SPEC_GAMMA with batch-shared
    caches and with per-row ones (``set_kv_cache_``), then the yaml's beam-5
    pass with the int8 cache; each cold and warm (answers equal).  Gates:
    every speculative row equal to the dense greedy's, or else the dense
    greedy's top-2 logit gap at its first differing position within the
    bf16 tolerance (the verify chunk and the single step take other tiles
    and routes); per-row rounds ≤ shared rounds; the int8 cache's
    teacher-forced decode logits against the bf16 cache's at every step,
    printed as within KV8_REL_RMS relative RMS or not (a finding, not a
    gate: random weights amplify the round trip through the depth), while
    the first layer's cached codes and scales, whose k/v no upstream
    rounding reaches, must equal ``quantize_kv`` of the bf16 cache's bit
    for bit; each phase's launches (PHASE_KERNELS) and shapes
    (``check_shapes``).  Prints rounds, commits, the mean accepted
    a round per row, walls, host syncs a round (``set_sync_debug_mode``),
    the cache bytes and the peaks; the warm passes profiled.  Returns
    (launches by phase, shapes by phase, numbers)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from vlm_compression_tpu_torch.models import (
        blip2_t5_instruct as BT,
        blip2_vicuna_instruct as BV,
    )
    from vlm_compression_tpu_torch.models.factory import set_kv_cache_
    from vlm_compression_tpu_torch.models.generation import (
        GenerationConfig,
        speculative_max_len,
    )
    from vlm_compression_tpu_torch.models.kvcache import (
        dequantize_kv,
        quantize_kv,
    )
    from vlm_compression_tpu_torch.tasks import vqa as V

    fam = "vicuna" if vicuna else "t5"
    gen_name = "generate_vicuna" if vicuna else "generate_t5"
    generate = getattr(BV if vicuna else BT, gen_name)
    n, L = VQA_RUN["batch_size_eval"], VQA_RUN["max_len"] + 1
    samples = vqa_samples(cfg, n)
    toks = (vicuna_tokenizers if vicuna else vqa_tokenizers)(cfg)
    model_cfg = VICUNA_MODEL if vicuna else XL_EVAL_MODEL
    tower = cfg.llm if vicuna else cfg.t5
    eos = tower.eos_token_id if vicuna else 1
    tol = TOL["bfloat16"]
    rec, nums, seqs = new_record(), {}, {}

    def task(**run):
        return V.GQATask.setup_task(dict(run=dict(VQA_RUN, **run),
                                         model=model_cfg), **toks)

    enc = task()._encode(model, samples, decoder_only=vicuna)
    greedy_cfg = GenerationConfig(num_beams=1, max_length=L,
                                  min_length=VQA_RUN["min_len"],
                                  eos_token_id=eos)

    # --- the dense teacher's greedy decode: the speculative reference
    for when in ("cold", "warm"):
        seqs["greedy"] = run_phase(
            rec, f"serve_{fam}_greedy_{when}", lambda: generate(
                model, *enc, gen_cfg=greedy_cfg, llm_mode="dense")).cpu()
    log(f"  serving {fam} greedy (the dense teacher, direct "
        f"{gen_name}): cold {rec['secs'][f'serve_{fam}_greedy_cold']:.3f} "
        f"s, warm {rec['secs'][f'serve_{fam}_greedy_warm']:.3f} s, peak "
        f"{rec['peaks'][f'serve_{fam}_greedy_warm'] / 2**30:.2f} GiB")
    dense_logits = None

    # --- speculative, batch-shared then per-row caches
    stats = {}
    for form, per_row in (("spec", False), ("spec_rows", True)):
        set_kv_cache_(model, per_row=per_row)
        spec = task(speculative_gamma=SPEC_GAMMA)
        answers = {}
        for when in ("cold", "warm"):
            before = dict(spec.spec_stats)
            rows = []
            with recording(V, gen_name, rows):
                recs = run_phase(rec, f"serve_{fam}_{form}_{when}",
                                 lambda: spec.evaluation(model, [samples]))
            answers[when] = [r["answer"] for r in recs]
            seqs[(form, when)] = rows[0]
            stats[(form, when)] = {k: spec.spec_stats[k] - before[k]
                                   for k in ("rounds", "committed", "rows")}
        if answers["cold"] != answers["warm"] or not torch.equal(
                seqs[(form, "cold")], seqs[(form, "warm")]) \
                or stats[(form, "cold")] != stats[(form, "warm")]:
            raise AssertionError(f"serving {fam} {form}: cold and warm "
                                 "passes differ")
        got, want = seqs[(form, "warm")], seqs["greedy"]
        differ = (got != want).any(1).nonzero().flatten().tolist()
        gaps = []
        if differ:
            if dense_logits is None:
                set_kv_cache_(model)
                dense_logits = forced_logits(model, enc, want, "dense",
                                             vicuna)[0].cpu()
                set_kv_cache_(model, per_row=per_row)
            for r in differ:
                j = int((got[r] != want[r]).nonzero()[0])
                top = dense_logits[r, j - 1].topk(2).values
                gap = float(top[0] - top[1])
                gaps.append(dict(row=r, position=j, gap=gap,
                                 tol=tol * max(1.0, abs(float(top[0])))))
        st = stats[(form, "warm")]
        mean_acc = st["committed"] / (st["rounds"] * st["rows"])
        log(f"  serving {fam} {form} (γ {SPEC_GAMMA}, masked draft, dense "
            f"target): rounds {st['rounds']}, committed {st['committed']} "
            f"over {st['rows']} rows, mean accepted a round per row "
            f"{mean_acc:.4f}; cold "
            f"{rec['secs'][f'serve_{fam}_{form}_cold']:.3f} s, warm "
            f"{rec['secs'][f'serve_{fam}_{form}_warm']:.3f} s, peak "
            f"{rec['peaks'][f'serve_{fam}_{form}_warm'] / 2**30:.2f} GiB; "
            f"{n - len(differ)} of {n} rows equal to the dense greedy; "
            f"differing rows (first position, dense top-2 gap, tolerance) "
            f"{json.dumps(gaps)}")
        if any(x["gap"] > x["tol"] for x in gaps):
            raise AssertionError(f"serving {fam} {form}: a row differs from "
                                 f"the dense greedy past a near-tie {gaps}")
        nums[f"{fam}_{form}"] = dict(st, mean_accepted=mean_acc,
                                     rows_equal=n - len(differ), gaps=gaps)
    set_kv_cache_(model)
    if stats[("spec_rows", "warm")]["rounds"] > \
            stats[("spec", "warm")]["rounds"]:
        raise AssertionError(f"serving {fam}: per-row caches took more "
                             f"rounds than shared ones {stats}")

    # host syncs a round: a direct speculative call under the sync debug
    # mode (each synchronizing call warns once)
    st = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            generate(model, *enc, gen_cfg=greedy_cfg, llm_mode="dense",
                     draft_llm_mode="masked", speculative_gamma=SPEC_GAMMA,
                     stats=st)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    log(f"  serving {fam} host syncs: {syncs} in a direct speculative call "
        f"of {st['rounds']} rounds ({syncs / st['rounds']:.2f} a round)")
    nums[f"{fam}_syncs"] = dict(syncs=syncs, rounds=st["rounds"])

    # --- the eval yaml's beam-5 pass with the int8 cache
    set_kv_cache_(model, int8=True)
    kv8 = task()
    answers = [[r["answer"] for r in run_phase(
        rec, f"serve_{fam}_kv8_{when}",
        lambda: kv8.evaluation(model, [samples]))]
        for when in ("cold", "warm")]
    if answers[0] != answers[1]:
        raise AssertionError(f"serving {fam} kv8: cold and warm differ")
    l8, c8 = forced_logits(model, enc, seqs["greedy"], "masked", vicuna)
    set_kv_cache_(model)
    l16, c16 = forced_logits(model, enc, seqs["greedy"], "masked", vicuna)
    rel = [float((l8[:, i] - l16[:, i]).norm() / l16[:, i].norm())
           for i in range(L - 1)]
    # the caches: layer 0's k/v see no upstream rounding, so its int8
    # codes and scales are quantize_kv of the bf16 cache's, bit for bit;
    # the round trip's own error, layer by layer
    filled = c16["layers"][0]["self"]["index"]
    first_equal, trip = True, []
    for i, (a, b) in enumerate(zip(c16["layers"], c8["layers"])):
        for name in ("key", "value"):
            x = a["self"][name][:, :filled]
            codes, scales = quantize_kv(x)
            if i == 0:
                first_equal &= torch.equal(
                    codes, b["self"][name][:, :filled]) and torch.equal(
                    scales, b["self"][name + "_scale"][:, :filled])
            back = dequantize_kv(codes, scales, torch.float32)
            trip.append(float((back - x.float()).norm() / x.float().norm()))
    del l8, l16, c8, c16
    bf16 = getattr(torch, tower.dtype)
    slots = L + (enc[1].shape[1] - 1 + cfg.qformer.num_query_tokens
                 if vicuna else 0)
    heads = tower.num_heads
    d = tower.head_dim if vicuna else tower.d_kv
    layers = tower.num_layers if vicuna else tower.num_decoder_layers
    kv_bytes = {f"{w}_beam{VQA_RUN['num_beams']}": kv_cache_bytes(
        layers, n * VQA_RUN["num_beams"], slots, heads, d, bf16, w == "int8")
        for w in ("bf16", "int8")}
    spec_slots = speculative_max_len(L, SPEC_GAMMA, False) + slots - L
    kv_bytes.update({f"{w}_spec": 2 * kv_cache_bytes(
        layers, n, spec_slots, heads, d, bf16, w == "int8")
        for w in ("bf16", "int8")})
    log(f"  serving {fam} kv8 (beam {VQA_RUN['num_beams']}, int8 KV cache): "
        f"cold {rec['secs'][f'serve_{fam}_kv8_cold']:.3f} s, warm "
        f"{rec['secs'][f'serve_{fam}_kv8_warm']:.3f} s, peak "
        f"{rec['peaks'][f'serve_{fam}_kv8_warm'] / 2**30:.2f} GiB; KV-cache "
        f"bytes (self-attention, all layers; the speculative pair's two "
        f"caches) {json.dumps(kv_bytes)}; teacher-forced decode logits "
        f"(masked mode, the dense greedy's tokens), int8 vs bf16 cache, "
        f"relative RMS by step {[round(x, 6) for x in rel]}: bound "
        f"{KV8_REL_RMS} {'met' if max(rel) <= KV8_REL_RMS else 'MISSED'}; "
        f"the cached k/v's own int8 round trip, relative RMS over the "
        f"{len(trip)} key and value caches {min(trip):.6f}-{max(trip):.6f}; "
        f"layer 0's int8 codes and scales equal to quantize_kv of the bf16 "
        f"cache's: {first_equal}")
    if not first_equal:
        raise AssertionError(f"serving {fam} kv8: layer 0's int8 cache is "
                             "not quantize_kv of the bf16 cache's")
    nums[f"{fam}_kv8"] = dict(rel_rms=rel, bound_met=max(rel) <= KV8_REL_RMS,
                              round_trip=[min(trip), max(trip)],
                              kv_bytes=kv_bytes)

    for phase in ("greedy", "spec", "spec_rows", "kv8"):
        c = rec["counts"][f"serve_{fam}_{phase}_warm"]
        log(f"  serving {fam} {phase} launches (warm): masked "
            f"{c['masked_matmul']} (decode kernel {c[DECODE]}, Hopper loop "
            f"{c[WGMMA_LOOP]}, WMMA loop {c[WMMA_LOOP]}); attention "
            f"{attn_routes(c)}")
    check_phase_counts(rec["counts"])
    check_shapes(rec["shapes"], f"serving {fam}")

    # --- the warm passes once more under the profiler
    for phase, form, fn in (
            ("greedy", {}, lambda: generate(model, *enc, gen_cfg=greedy_cfg,
                                            llm_mode="dense")),
            ("spec", {}, lambda: task(
                speculative_gamma=SPEC_GAMMA).evaluation(model, [samples])),
            ("spec_rows", dict(per_row=True), lambda: task(
                speculative_gamma=SPEC_GAMMA).evaluation(model, [samples])),
            ("kv8", dict(int8=True), lambda: kv8.evaluation(model,
                                                            [samples]))):
        set_kv_cache_(model, **form)
        wall = 1e3 * rec["secs"][f"serve_{fam}_{phase}_warm"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev_ms, _ = device_breakdown(prof, wall, f"serving {fam} {phase}")
        nums[f"{fam}_{phase}_device_ms"] = dev_ms
        nums[f"{fam}_{phase}_busy"] = dev_ms / wall
    set_kv_cache_(model)
    nums.update({f"{k}_s": v for k, v in rec["secs"].items()})
    nums[f"{fam}_serve_peaks"] = dict(rec["peaks"])
    return rec["counts"], rec["shapes"], nums


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
    counts["remat_t5"], remat_shapes, remat = remat_check(
        model, synthetic_batches(cfg, 1, TRAIN_BS, torch.Generator(
            device="cuda").manual_seed(7))[0], "t5")
    check_shapes({"remat_t5": remat_shapes}, "remat")
    retrain.update(remat)
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
    serve_counts, _, serve = serving_path(model, cfg, vicuna=False)
    counts.update(serve_counts)
    caption_counts, caption = caption_path(model, cfg)
    counts.update(caption_counts)
    c4_counts, c4 = c4_pass(model, vqa_tokenizers(cfg)["tokenizer"],
                            "c4_t5")
    counts.update(c4_counts)

    log(f"  launches: {json.dumps(counts)}")
    check_phase_counts(counts)
    del model
    torch.cuda.empty_cache()
    return counts, {"prune_s": t_prune,
                    "generate_cold_s": t_gen["generate_cold"],
                    "generate_s": t_gen["generate_warm"],
                    "tokens_per_s": tokens_per_s,
                    "peak_bytes": peak, **retrain,
                    "generate_merged_s": t_merged, **vqa, **caption, **c4,
                    "serving": serve}


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
    # the drift reference of the int4 and W8A8 forms
    ref_logits, _ = forced_logits(model, req_enc(req), outs["generate_bool"],
                                  "masked", False)
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
    controls = drift_controls(model, req, outs["generate_bool"], ref_logits)
    log(f"  drift controls (teacher-forced logits against the bf16 "
        f"model's, relative RMS over all steps, first step in brackets): "
        f"packed-256 masks {fmt_drift(controls['packed'])}; "
        + "; ".join(f"kernels x (1 + {eps:g} z), weights off by "
                    f"{controls[f'perturbed_{eps:g}']['weight_rel_rms']:.3e}"
                    f" relative RMS: "
                    f"{fmt_drift(controls[f'perturbed_{eps:g}'])}"
                    for eps in DRIFT_EPS)
        + f"; restored {fmt_drift(controls['restored'])}; "
        f"{controls['s']:.1f} s")
    q4_rec, q4_out = int4_forms(model, cfg, req, outs["generate_bool"],
                                ref_logits)
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
    w8_rec, w8_out = w8a8_forms(model, cfg, req, outs["generate_bool"],
                                ref_logits)
    del ref_logits

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
    counts.update(q4_rec["counts"], **w8_rec["counts"])
    log(f"  launches: {json.dumps(counts)}")
    check_phase_counts(counts)
    del model, linears
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {**q4_out, **w8_out, "drift_controls": controls,
                    "sparsegpt_prune_s": secs["sparsegpt_prune"],
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


# ---------------------------------------------------------------------------
# int4 weights and W8A8 products on the compressed path's model
# ---------------------------------------------------------------------------

# the linear whose int4 codes and scales are held bit for bit against the
# CPU's quantize_weight_int4 of its bf16 kernel
INT4_NAMED = "t5_model.decoder.blocks_0.ffn.wo"


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got - want) ** 2).mean().sqrt()
                 / (want ** 2).mean().sqrt())


def drift(logits: torch.Tensor, ref: torch.Tensor) -> dict:
    """Teacher-forced logits (b, L − 1, V) against the bf16 model's: the
    relative RMS over every step and at the first step alone."""
    return {"all": rel_rms(logits, ref),
            "first_step": rel_rms(logits[:, 0], ref[:, 0])}


def fmt_drift(d: dict) -> str:
    return f"{d['all']:.4f} (first step {d['first_step']:.4f})"


# the controls of the drift readings: each masked kernel of the bf16 model
# times (1 + eps·z), z seeded standard normal, then rounded to bf16 (on
# one H100 a perturbation of 1e-1 read as 1e-3 and 1e-2 do: 1.3194)
DRIFT_EPS = (1e-3, 1e-2)


@torch.no_grad()
def drift_controls(model, req, seqs, ref_logits) -> dict:
    """The drift readings' controls on the compressed bf16 model: its
    teacher-forced logits with the masks packed (the same products as the
    reference's bool masks: 0 expected), then with every masked kernel
    perturbed by each DRIFT_EPS (the kernels kept on the host meanwhile
    and put back after), beside the relative RMS change of the weights."""
    t0 = time.perf_counter()
    enc = req_enc(req)
    logits, _ = forced_logits(model, enc, seqs, "masked", False)
    out = {"packed": drift(logits, ref_logits)}
    lins = [m for m in sparse_linears(model).values() if m.mask is not None]
    saved = [m.kernel.detach().to("cpu", copy=True) for m in lins]
    g = torch.Generator(device="cuda").manual_seed(23)
    for eps in DRIFT_EPS:
        num = den = 0.0
        for m, k in zip(lins, saved):
            w = k.to(m.kernel.device).float()
            new = (w * (1 + eps * torch.randn(w.shape, generator=g,
                                              device="cuda"))).to(k.dtype)
            num = num + ((new.float() - w) ** 2).sum()
            den = den + (w ** 2).sum()
            m.kernel.copy_(new)
        logits, _ = forced_logits(model, enc, seqs, "masked", False)
        out[f"perturbed_{eps:g}"] = dict(
            weight_rel_rms=float((num / den).sqrt()),
            **drift(logits, ref_logits))
    for m, k in zip(lins, saved):
        m.kernel.copy_(k)
    logits, _ = forced_logits(model, enc, seqs, "masked", False)
    out["restored"] = drift(logits, ref_logits)
    out["s"] = time.perf_counter() - t0
    return out


def within_bf16(got: torch.Tensor, plain: torch.Tensor) -> float:
    """The largest |got − plain| / max(1, |plain|); the gate is 2e-2."""
    err = (got.double() - plain).abs() / plain.abs().clamp(min=1.0)
    return float(err.max())


def sparse_linears(model) -> dict:
    from vlm_compression_tpu_torch.models.layers import SparseLinear

    return {n: m for n, m in model.named_modules()
            if isinstance(m, SparseLinear)}


@torch.no_grad()
def check_int4_shapes(lins: dict, shapes: dict, what: str) -> tuple:
    """Every (M, K, N) the int4 phases launched a matmul kernel at, through
    ``int4_matmul`` on the card with the codes, scales and mask of a
    linear of that (K, N) and seeded bf16 inputs, against the plain
    product (fp64: the dequantized weight, zero off its mask): within
    bf16 2e-2 × max(1, |plain|).  Returns (shapes held, worst error)."""
    from vlm_compression_tpu_torch.ops import quant as Q

    by_kn = {}
    for m in lins.values():
        if m.kernel_q4 is not None and m.mask is not None:
            by_kn.setdefault((m.in_features, m.features), m)
    seen = sorted({(mm, k, n) for s in shapes.values()
                   for (mm, n, k, _) in s["matmul"]})
    g = torch.Generator(device="cuda").manual_seed(21)
    worst = 0.0
    for mm, k, n in seen:
        lin = by_kn[(k, n)]
        x = torch.randn(mm, k, generator=g, device="cuda").to(torch.bfloat16)
        y = Q.int4_matmul(x, lin.kernel_q4, lin.kernel_scale, lin.mask)
        w = Q.dequantize_weight_int4(lin.kernel_q4, lin.kernel_scale).double()
        plain = x.double() @ torch.where(lin.bool_mask(), w, 0.0)
        worst = max(worst, within_bf16(y, plain))
    if worst > TOL["bfloat16"]:
        raise AssertionError(f"{what}: int4_matmul off its plain version by "
                             f"{worst:.3e}")
    return len(seen), worst


def w8a8_plain(x, q, scale, mask, k_out: int) -> torch.Tensor:
    """The W8A8 product's plain version in fp64: the ``k_out`` activation
    columns of largest magnitude against their weight rows, the rest
    quantized per row to int8 steps and multiplied by the dequantized
    weight."""
    from vlm_compression_tpu_torch.ops import quant as Q

    x2 = x.reshape(-1, x.shape[-1]).double()
    w = q.double() * scale.double()[None, :]
    if mask is not None:
        w = torch.where(mask, w, 0.0)
    y = torch.zeros(x2.shape[0], w.shape[1], dtype=torch.float64,
                    device=x.device)
    if k_out:
        idx = Q.top_k_indices(x2.abs().amax(dim=0), k_out)
        y = x2[:, idx] @ w[idx]
        keep = torch.ones(x2.shape[1], dtype=torch.bool, device=x.device)
        keep[idx] = False
        x2 = torch.where(keep[None, :], x2, 0.0)
    sx = x2.abs().amax(dim=1).clamp(min=1e-12) / 127.0
    xq = torch.clamp(torch.round(x2 / sx[:, None]), -127, 127)
    return y + (xq * sx[:, None]) @ w


@torch.no_grad()
def check_w8a8_shapes(lins: dict, calls: dict, k_out: int,
                      what: str) -> tuple:
    """Every (M, K, N) a W8A8 phase ran (``calls``: shape → linear name),
    through the W8A8 product on the card with that linear's codes, scales
    and mask and seeded bf16 inputs, against ``w8a8_plain``: within bf16
    2e-2 × max(1, |plain|); and ``_int_mm``'s int32 output at the shape,
    on seeded int8 codes against the linear's (masked) codes, bit-equal
    to their float64 product.  Returns (shapes held, worst error)."""
    from vlm_compression_tpu_torch.ops import quant as Q

    g = torch.Generator(device="cuda").manual_seed(22)
    worst = 0.0
    for (mm, k, n), name in sorted(calls.items()):
        lin = lins[name]
        mask = lin.bool_mask()
        x = torch.randn(mm, k, generator=g, device="cuda").to(torch.bfloat16)
        fn = (functools.partial(Q.int8_matmul_outlier, num_outliers=k_out)
              if k_out else Q.int8_matmul_dynamic)
        y = fn(x, lin.kernel, lin.kernel_scale, lin.mask)
        worst = max(worst, within_bf16(
            y, w8a8_plain(x, lin.kernel, lin.kernel_scale, mask, k_out)))
        xq = torch.randint(-127, 128, (mm, k), generator=g, device="cuda",
                           dtype=torch.int8)
        qw = lin.kernel if mask is None else torch.where(mask, lin.kernel, 0)
        acc = Q.int_mm(xq, qw)
        if acc.dtype != torch.int32 or not torch.equal(
                acc.double(), xq.double() @ qw.double()):
            raise AssertionError(f"{what}: _int_mm at M={mm} K={k} N={n} "
                                 "differs from the float64 product")
    if worst > TOL["bfloat16"]:
        raise AssertionError(f"{what}: W8A8 off its plain version by "
                             f"{worst:.3e}")
    return len(calls), worst


def generate_form(model, cfg, req, rec, form: str) -> torch.Tensor:
    """Beam-5 generate of one weight form, cold then warm (tokens equal);
    returns the tokens."""
    toks = {}
    for when in ("cold", "warm"):
        phase = f"generate_{form}_{when}"
        seqs, gen_cfg = run_phase(rec, phase, lambda: run_generate(model, req))
        n_tok = check_generate(seqs, gen_cfg, cfg)
        toks[when] = seqs
        log(f"  generate_t5 beam-5 ({form}, {when}): "
            f"{rec['secs'][phase]:.3f} s, {n_tok} tokens")
    if not torch.equal(toks["cold"], toks["warm"]):
        raise AssertionError(f"{form}: warm tokens differ from cold")
    return toks["warm"]


def req_enc(req) -> tuple:
    return (req["image"], req["input_ids"], req["attention_mask"],
            req["qformer_input_ids"], req["qformer_attention_mask"])


@torch.no_grad()
def int4_forms(model, cfg, req, seqs, ref_logits) -> tuple:
    """The compressed model in int4 (group 128, every linear: all their
    input widths are multiples of it), from its bf16 kernels: beam-5
    generate with its bool masks and with the masks packed at G = 128,
    each cold and warm.  Gates: every ``kernel_q4`` (K/2, N) uint8 and
    every scale (K/128, N) fp32; INT4_NAMED's codes and scales bit-equal
    to ``quantize_weight_int4`` of its bf16 kernel on the CPU; the bytes
    at rest the closed form; each launched shape within bf16 tolerance of
    the plain version.  The teacher-forced logits' relative RMS drift
    against the bf16 model's is printed, not gated.  The bf16 kernels are
    put back after.  Returns (record, readings)."""
    from torch import nn

    from vlm_compression_tpu_torch.compression.peft_io import bytes_at_rest
    from vlm_compression_tpu_torch.models.layers import set_mask
    from vlm_compression_tpu_torch.ops import bitmask as BM
    from vlm_compression_tpu_torch.ops import quant as Q

    rec, out = new_record(), {}
    lins = sparse_linears(model)
    for m in lins.values():                   # the bool masks back
        if m.mask is not None:
            set_mask(m, m.bool_mask())
    saved = {n: m.kernel.detach().clone() for n, m in lins.items()}
    named_cpu = saved[INT4_NAMED].cpu()
    t0 = time.perf_counter()
    Q.quantize_model_int4_(model)
    torch.cuda.synchronize()
    out["int4_quantize_s"] = time.perf_counter() - t0
    g = Q.INT4_GROUP
    for n, m in lins.items():
        k, f = m.in_features, m.features
        if m.kernel is not None or m.kernel_q4 is None \
                or m.kernel_q4.dtype != torch.uint8 \
                or tuple(m.kernel_q4.shape) != (k // 2, f) \
                or m.kernel_scale.dtype != torch.float32 \
                or tuple(m.kernel_scale.shape) != (k // g, f):
            raise AssertionError(f"int4: {n} holds {m.kernel_q4} / "
                                 f"{m.kernel_scale}")
    want_q, want_s = Q.quantize_weight_int4(named_cpu)
    lin = lins[INT4_NAMED]
    if not (torch.equal(lin.kernel_q4.cpu(), want_q)
            and torch.equal(lin.kernel_scale.cpu(), want_s)):
        raise AssertionError(f"int4: {INT4_NAMED}'s codes or scales differ "
                             "from the CPU's")
    sizes = bytes_at_rest(model)
    closed = dict(
        kernels=sum(m.in_features * m.features // 2 for m in lins.values()),
        scales=sum(4 * (m.in_features // g) * m.features
                   for m in lins.values()),
        masks=sum(m.in_features * m.features for m in lins.values()
                  if m.mask is not None))
    if any(sizes[k] != v for k, v in closed.items()):
        raise AssertionError(f"int4 bytes at rest {sizes} vs {closed}")
    out["int4_bytes_at_rest"] = sizes["total"]
    # the weights' relative RMS error of the int4 form and of the int8 one
    # (what the drift readings stand beside)
    err = {"int4": 0.0, "int8": 0.0}
    ref = 0.0
    for n, m in lins.items():
        w = saved[n].float()
        err["int4"] = err["int4"] + ((Q.dequantize_weight_int4(
            m.kernel_q4, m.kernel_scale) - w) ** 2).sum()
        err["int8"] = err["int8"] + ((Q.dequantize_weight(
            *Q.quantize_weight(w)) - w) ** 2).sum()
        ref = ref + (w ** 2).sum()
    out["weight_rel_rms"] = {k: float((v / ref).sqrt())
                             for k, v in err.items()}
    log(f"  quantize_model_int4_ (group {g}): {out['int4_quantize_s']:.2f} "
        f"s; {len(lins)} kernels (K/2, N) uint8 + (K/{g}, N) fp32 scales; "
        f"{INT4_NAMED} bit-equal to the CPU's; bytes at rest "
        f"{json.dumps(sizes)} = the closed form; the weights' relative RMS "
        f"error: int4 {out['weight_rel_rms']['int4']:.4e}, int8 "
        f"{out['weight_rel_rms']['int8']:.4e}")
    enc = req_enc(req)
    for form in INT4_FORMS:
        if form == "int4_packed128":
            BM.pack_masks_(model, 128)
        toks = generate_form(model, cfg, req, rec, form)
        logits, _ = forced_logits(model, enc, seqs, "masked", False)
        out[f"{form}_drift"] = drift(logits, ref_logits)
        out[f"{form}_s"] = rec["secs"][f"generate_{form}_warm"]
        log(f"  {form}: tokens {toks.tolist()}, equal to the bf16 ones: "
            f"{torch.equal(toks, seqs)}; teacher-forced logits' relative "
            f"RMS against the bf16 model's "
            f"{fmt_drift(out[f'{form}_drift'])} (a reading on random "
            f"weights, not gated)")
    for form in INT4_FORMS:
        phases = {p: s for p, s in rec["shapes"].items() if form in p}
        held, worst = check_int4_shapes(lins, phases, form)
        log(f"  {form}: {held} launched shapes held against the plain "
            f"version, worst {worst:.3e}")
    check_shapes(rec["shapes"], "int4")
    for n, m in lins.items():                 # the bf16 kernels back
        m.kernel = nn.Parameter(saved.pop(n))
        m.kernel_q4 = None
        m.kernel_scale = None
    return rec, out


@torch.no_grad()
def w8a8_forms(model, cfg, req, seqs, ref_logits) -> tuple:
    """The int8 model (packed-128 masks) with the W8A8 products:
    ``use_dynamic_int8`` alone, then with W8A8_OUTLIERS outlier columns,
    beam-5 generate cold and warm each, the switches restored after.
    Gates: each (M, K, N) a W8A8 product ran at within bf16 tolerance of
    its plain version, ``_int_mm`` bit-equal to a float64 product there,
    the switch off after.  Drift printed as for int4.  Returns (record,
    readings)."""
    from vlm_compression_tpu_torch.ops import quant as Q

    rec, out = new_record(), {}
    lins = sparse_linears(model)
    calls = {form: {} for form in W8A8_FORMS}
    current = []

    def hook_for(name):
        def hook(mod, args):
            if current:
                x = args[0]
                key = (x.numel() // x.shape[-1], x.shape[-1], mod.features)
                calls[current[0]].setdefault(key, name)
        return hook

    handles = [m.register_forward_pre_hook(hook_for(n))
               for n, m in lins.items()]
    enc = req_enc(req)
    # the weight-only int8 model's drift, the yardstick of the W8A8 ones
    logits, _ = forced_logits(model, enc, seqs, "masked", False)
    out["int8_drift"] = drift(logits, ref_logits)
    log(f"  int8 (weight-only): teacher-forced logits' relative RMS against "
        f"the bf16 model's {fmt_drift(out['int8_drift'])} (not gated)")
    try:
        with Q.int8_switches():
            Q.use_dynamic_int8(True)
            for form in W8A8_FORMS:
                Q.set_int8_outliers(W8A8_OUTLIERS if "out" in form else 0)
                current[:] = [form]
                toks = generate_form(model, cfg, req, rec, form)
                current.clear()
                logits, _ = forced_logits(model, enc, seqs, "masked", False)
                out[f"{form}_drift"] = drift(logits, ref_logits)
                out[f"{form}_s"] = rec["secs"][f"generate_{form}_warm"]
                log(f"  {form}: tokens {toks.tolist()}, equal to the bf16 "
                    f"ones: {torch.equal(toks, seqs)}; teacher-forced "
                    f"logits' relative RMS against the bf16 model's "
                    f"{fmt_drift(out[f'{form}_drift'])} (not gated)")
    finally:
        for h in handles:
            h.remove()
    if Q.dynamic_int8_enabled() or Q.int8_outliers():
        raise AssertionError("the W8A8 switches are still set")
    for form in W8A8_FORMS:
        k_out = W8A8_OUTLIERS if "out" in form else 0
        held, worst = check_w8a8_shapes(lins, calls[form], k_out, form)
        log(f"  {form}: {held} shapes held against the plain version, "
            f"worst {worst:.3e}; _int_mm bit-equal to float64 at each")
    log("  W8A8 switches off after the phase")
    return rec, out


# ---------------------------------------------------------------------------
# GPTQ and AWQ on a cut XL
# ---------------------------------------------------------------------------

# the cut: the GPTQ sweep walks its columns one at a time (about 846 k
# columns at 39/24/24, against 175 k at this depth); every width kept
# 4/3/3 since PR 23 (8/5/5 before: room for the zoo path)
GPTQ_DEPTH = (4, 3, 3)
GPTQ_SEED = 15
GPTQ_GROUP = 128
# the linears whose calibration Hessians the OBS-loss gates read: (tower,
# block, path in the block); the first also runs card against CPU
GPTQ_NAMED = (("vit", 0, ("attn", "qkv")), ("t5_encoder", 0, ("ffn", "wi_0")),
              ("t5_decoder", 0, ("ffn", "wo")))
# the GPTQ parity tests' bound on symmetric grids
# (tests/test_torch_gptq.py: SYM_TIE_SHARE)
GPTQ_TIE_SHARE = 0.03
GPTQ_W_TOL = 1e-5
# AWQ card against the CPU: on the first GPTQ_NAMED linear's first
# AWQ_UNITS output units (the CPU's 22 candidate losses take seconds
# otherwise), the candidate losses within AWQ_LOSS_RTOL (fp32 sums in
# another order; the rounded weights themselves are equal)
AWQ_UNITS = 512
AWQ_LOSS_RTOL = 1e-4


def count_kernels(prof) -> int:
    from torch.autograd import DeviceType

    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA)


def swept_columns(model, towers) -> int:
    """Columns the sweep walks: each block's equal-shape groups, their
    input width once each."""
    from vlm_compression_tpu_torch.models.layers import SparseLinear

    total = 0
    for tower in towers:
        blocks = model.get_submodule(tower)
        for name, block in blocks.named_children():
            if not name.startswith("blocks_"):
                continue
            shapes = {tuple(m.kernel.shape) for m in block.modules()
                      if isinstance(m, SparseLinear)}
            total += sum(k for k, _ in shapes)
    return total


def obs_loss(w: torch.Tensor, q: torch.Tensor, h: torch.Tensor) -> float:
    d = (w - q.float()).float()
    return float((torch.matmul(d, h) * d).sum())


@torch.no_grad()
def awq_check(w: torch.Tensor, h: torch.Tensor, sr: torch.Tensor) -> dict:
    """``awq_search`` on the card against the CPU on the same weights,
    Hessian and ``scaler_row``: every candidate's loss within
    AWQ_LOSS_RTOL, the card's choice within that of the CPU's best.  Then
    the best candidate other than the identity, forced: its scales card
    against CPU, ``apply_awq``'s scaled problem and ``unscale_weight`` of
    RTN in scaled space bit-equal to the CPU's (at most GPTQ_TIE_SHARE of
    the entries off, the grid's ties), equal to ``awq_rtn_quantize``, and
    its OBS loss recomputed from them within AWQ_LOSS_RTOL of the
    search's own loss for that candidate.  Returns the readings."""
    from vlm_compression_tpu_torch.ops import awq as AW
    from vlm_compression_tpu_torch.ops import gptq as GQ

    kw = dict(groupsize=GPTQ_GROUP)
    w = w.contiguous()
    cw, ch, csr = w.cpu(), h.cpu(), sr.cpu()
    card, cpu = AW.awq_search(w, sr, h, **kw), AW.awq_search(cw, csr, ch, **kw)
    lc, lp = card.losses.cpu().double(), cpu.losses.double()
    loss_rel = float(((lc - lp).abs() / lp.abs()).max())
    chose = int(card.losses.argmin())
    if loss_rel > AWQ_LOSS_RTOL \
            or float(lp[chose]) > (1 + AWQ_LOSS_RTOL) * float(lp.min()):
        raise AssertionError(f"awq: card's candidate losses off the CPU's by "
                             f"{loss_rel:.3e}, or its choice {chose} not the "
                             "CPU's best")
    n = lp.numel() - 1
    a = int(lp[:n].argmin())          # the best candidate but the identity
    alphas, cand = AW._candidates(w.float(), sr, n)
    _, cand_cpu = AW._candidates(cw.float(), csr, n)
    s = cand[a]
    s_rel = float(((s.cpu() - cand_cpu[a]).abs() / cand_cpu[a]).max())
    if bool((s == 1).all()):
        raise AssertionError("awq: the forced candidate is the identity")
    ws, hs = AW.apply_awq(w, h, s)
    back = AW.unscale_weight(GQ.rtn_quantize(ws, **kw), s)
    cws, chs = AW.apply_awq(cw, ch, s.cpu())
    cback = AW.unscale_weight(GQ.rtn_quantize(cws, **kw), s.cpu())
    off = float((back.cpu() != cback).float().mean())
    forced = obs_loss(w, back, h)
    forced_rel = abs(forced - float(card.losses[a])) / float(card.losses[a])
    if not (torch.equal(ws.cpu(), cws) and torch.equal(hs.cpu(), chs)) \
            or off > GPTQ_TIE_SHARE or s_rel > AWQ_LOSS_RTOL \
            or not torch.equal(back, AW.awq_rtn_quantize(w, s, **kw)) \
            or not forced_rel <= AWQ_LOSS_RTOL:
        raise AssertionError(
            f"awq at alpha {float(alphas[a]):.2f}: scaled problem equal "
            f"{torch.equal(ws.cpu(), cws)} / {torch.equal(hs.cpu(), chs)}, "
            f"entries off {off:.3e}, scales off {s_rel:.3e}, recomputed loss "
            f"off {forced_rel:.3e}")
    return {"losses_rel": loss_rel, "alpha": float(card.alpha),
            "cpu_alpha": float(cpu.alpha),
            "forced_alpha": float(alphas[a]), "forced_loss": forced,
            "forced_loss_rel": forced_rel, "identity_loss": float(lc[-1]),
            "scales_rel": s_rel, "entries_off": off}


def quant_path() -> tuple:
    """GPTQ on a dense full-width XL cut to GPTQ_DEPTH (seed 15, no
    adapters, 128 calibration samples at batch 16): (a)
    ``blipt5_gptq_pruner`` jointly at 0.5 / 0.5 (4 bits, group 128,
    symmetric, no act order, masks kept); (b) on the ViT restored dense,
    ``vit_gptq_pruner`` quantizing only (keep 1.0) with ``gptq_awq``;
    then beam-5 generate.  Gates: each joint-pruned linear 0.5 ± 0.01; at
    most 16 values in each (unit, 128-row group), exactly 0 off the masks;
    for the three GPTQ_NAMED linears, GPTQ's OBS loss on their Hessian at
    most RTN's on the same grid and AWQ's at most plain RTN's; the first
    one's ``gptq_quantize`` on the card against the CPU's on the same
    Hessian (keep masks equal, at most GPTQ_TIE_SHARE of the weights off
    by more than GPTQ_W_TOL); (b)'s masks all True; launches and shapes
    as the other paths.  Returns (launches by phase, readings)."""
    from torch.profiler import ProfilerActivity, profile

    from vlm_compression_tpu_torch.compression import load_pruner
    from vlm_compression_tpu_torch.models.layers import set_mask
    from vlm_compression_tpu_torch.ops import awq as AW
    from vlm_compression_tpu_torch.ops import gptq as GQ
    from vlm_compression_tpu_torch.ops.stats import finalize_hessian

    t0 = time.perf_counter()
    cfg, model, batches, req = xl_setup(GPTQ_SEED, lora=False,
                                        depth=GPTQ_DEPTH)
    depth = "/".join(map(str, GPTQ_DEPTH))
    towers = ("visual_encoder", "t5_model.encoder", "t5_model.decoder")
    cols = swept_columns(model, towers)
    log(f"  model: InstructBLIP-FlanT5-XL, bf16, seed {GPTQ_SEED}, no "
        f"adapters, cut to {depth} blocks (the cut; 39/24/24 at full depth), "
        f"{time.perf_counter() - t0:.1f} s; {N_CALIB} calibration samples "
        f"at batch {BS}; the sweep walks {cols} columns")
    rec, out = new_record(), {"gptq_columns": cols}
    vit = model.visual_encoder
    vit_lins = sparse_linears(vit)
    dense_vit = {n: m.kernel.detach().clone() for n, m in vit_lins.items()}
    captured, calls = {}, []
    pruner = load_pruner(
        "blipt5_gptq_pruner", model, batches,
        vit_prune_spec=f"{GPTQ_DEPTH[0]}-0.5-1.0-1.0",
        t5_prune_spec=f"{GPTQ_DEPTH[1]}-0.5-1.0-1.0", num_samples=N_CALIB,
        gptq_group=GPTQ_GROUP)
    make = pruner.make_mask_fn

    def capturing(lora_model, tower="llm"):
        fn = make(lora_model, tower)

        def mask_fn(kernels, stats, sparsities):
            n_llm = calls.count("llm")
            where = (("vit", calls.count("vit")) if tower == "vit" else
                     ("t5_encoder", n_llm) if n_llm < GPTQ_DEPTH[1] else
                     ("t5_decoder", n_llm - GPTQ_DEPTH[1]))
            calls.append(tower)
            for tw, blk, path in GPTQ_NAMED:
                if (tw, blk) == where:
                    captured[tw] = (kernels[path].detach().t().float(),
                                    finalize_hessian(stats[path]),
                                    stats[path].scaler_row.clone())
            return fn(kernels=kernels, stats=stats, sparsities=sparsities)
        return mask_fn

    pruner.make_mask_fn = capturing
    run_phase(rec, "gptq_prune", lambda: pruner.prune(lora_model=True))
    del pruner
    secs = rec["secs"]["gptq_prune"]
    out["gptq_prune_s"] = secs
    log(f"  (a) blipt5_gptq_pruner at 0.5 / 0.5 (4 bits, group "
        f"{GPTQ_GROUP}, symmetric): {secs:.2f} s, "
        f"{1e6 * secs / cols:.1f} us a column; "
        f"peak {rec['peaks']['gptq_prune'] / 2**30:.2f} GiB")
    # the joint prune's structure
    n_lin = 0
    for tower in towers:
        for name, m in sparse_linears(model.get_submodule(tower)).items():
            keep = m.bool_mask()
            dens = float(keep.float().mean())
            if abs(dens - 0.5) > 0.01:
                raise AssertionError(f"gptq: {tower}.{name} density {dens}")
            k = m.kernel
            if bool(k[~keep].ne(0).any()) or not bool(
                    torch.isfinite(k).all()):
                raise AssertionError(f"gptq: {tower}.{name} non-zero off "
                                     "its mask or not finite")
            grp = k.float().reshape(k.shape[0] // GPTQ_GROUP, GPTQ_GROUP,
                                    k.shape[1])
            distinct = 1 + (grp.sort(dim=1).values.diff(dim=1) != 0).sum(1)
            if int(distinct.max()) > 16:
                raise AssertionError(f"gptq: {tower}.{name} holds "
                                     f"{int(distinct.max())} values in a "
                                     "(unit, group) slab")
            n_lin += 1
    log(f"  (a) {n_lin} linears 0.5 ± 0.01, exactly 0 off their masks, at "
        f"most 16 values in each (unit, {GPTQ_GROUP}-row group)")
    # GPTQ and AWQ against RTN on three linears' own Hessians
    for tw, blk, path in GPTQ_NAMED:
        w, h, sr = captured[tw]
        res = GQ.gptq_quantize(w, h, groupsize=GPTQ_GROUP)
        rtn = GQ.rtn_quantize(w, groupsize=GPTQ_GROUP)
        sc = AW.awq_search(w, sr, h, groupsize=GPTQ_GROUP)
        awq = AW.awq_rtn_quantize(w, sc.s, groupsize=GPTQ_GROUP)
        losses = {"gptq": obs_loss(w, res.weight, h),
                  "rtn": obs_loss(w, rtn, h), "awq": obs_loss(w, awq, h)}
        out[f"gptq_obs_{tw}"] = losses
        log(f"  OBS loss, {tw} block {blk} {'/'.join(path)} "
            f"{tuple(w.shape)}: GPTQ {losses['gptq']:.6g}, RTN "
            f"{losses['rtn']:.6g}, AWQ (alpha {float(sc.alpha):.2f}) "
            f"{losses['awq']:.6g}")
        if losses["gptq"] > losses["rtn"] or losses["awq"] > losses["rtn"]:
            raise AssertionError(f"gptq: {tw} loss GPTQ / AWQ above RTN's")
    tw, blk, path = GPTQ_NAMED[0]
    w, h, sr = captured[tw]
    aw = awq_check(w[:AWQ_UNITS], h, sr)
    out["awq_card_vs_cpu"] = aw
    log(f"  AWQ card vs CPU, {tw} block {blk} {'/'.join(path)}, its first "
        f"{AWQ_UNITS} units: 22 candidate losses within "
        f"{aw['losses_rel']:.2e} (bound {AWQ_LOSS_RTOL}), alpha "
        f"{aw['alpha']:.2f} (CPU {aw['cpu_alpha']:.2f}); forced alpha "
        f"{aw['forced_alpha']:.2f} "
        f"(the best but the identity): scales within {aw['scales_rel']:.2e}, "
        f"the scaled problem bit-equal, RTN unscaled back off on "
        f"{100 * aw['entries_off']:.3f}% of entries, loss recomputed "
        f"{aw['forced_loss']:.6g} (search's within "
        f"{aw['forced_loss_rel']:.2e}; identity {aw['identity_loss']:.6g})")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        card = GQ.gptq_quantize(w, h, groupsize=GPTQ_GROUP)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    launches = count_kernels(prof)
    t0 = time.perf_counter()
    cpu = GQ.gptq_quantize(w.cpu(), h.cpu(), groupsize=GPTQ_GROUP)
    cpu_s = time.perf_counter() - t0
    codes = float((card.codes.cpu() != cpu.codes).float().mean())
    off = float((~torch.isclose(card.weight.cpu(), cpu.weight,
                                rtol=GPTQ_W_TOL, atol=GPTQ_W_TOL))
                .float().mean())
    per_col = launches / w.shape[1]
    out.update(gptq_launches_per_column=per_col,
               gptq_sweep_launches=per_col * cols,
               gptq_card_vs_cpu={"codes": codes, "weights_off": off})
    log(f"  {tw} block {blk} {'/'.join(path)} card vs CPU on its Hessian: "
        f"codes differ {100 * codes:.3f}%, weights off by more than "
        f"{GPTQ_W_TOL} {100 * off:.3f}% (bound {100 * GPTQ_TIE_SHARE}%), "
        f"keep masks equal; card {card_s:.2f} s (profiled), CPU "
        f"{cpu_s:.2f} s; {launches} kernels, {per_col:.1f} a column: about "
        f"{per_col * cols / 1e6:.2f} M for the sweep at {depth}")
    if not torch.equal(card.keep_mask.cpu(), cpu.keep_mask) \
            or off > GPTQ_TIE_SHARE or codes > GPTQ_TIE_SHARE:
        raise AssertionError("gptq: card and CPU sweeps differ beyond the "
                             "parity tests' bound")
    del captured, card, cpu, w, h
    # (b) the ViT restored dense, quantized only, with AWQ
    with torch.no_grad():
        for n, m in vit_lins.items():
            m.kernel.copy_(dense_vit.pop(n))
            set_mask(m, None)
    vp = load_pruner("vit_gptq_pruner", vit, batches, num_samples=N_CALIB,
                     prune_spec=f"{GPTQ_DEPTH[0]}-1.0-1.0-1.0", gptq_awq=True,
                     gptq_group=GPTQ_GROUP)
    run_phase(rec, "awq_vit_prune", lambda: vp.prune(lora_model=True))
    del vp
    out["awq_vit_prune_s"] = rec["secs"]["awq_vit_prune"]
    for n, m in vit_lins.items():
        if m.mask is None or not bool(m.mask.all()) \
                or not bool(torch.isfinite(m.kernel).all()):
            raise AssertionError(f"awq: ViT {n} mask not all True or kernel "
                                 "not finite")
    log(f"  (b) vit_gptq_pruner, keep 1.0, gptq_awq: "
        f"{out['awq_vit_prune_s']:.2f} s; every ViT mask all True")
    del batches
    seqs, gen_cfg = run_phase(rec, "generate_gptq",
                              lambda: run_generate(model, req))
    n_tok = check_generate(seqs, gen_cfg, cfg)
    out["generate_gptq_s"] = rec["secs"]["generate_gptq"]
    log(f"  generate_t5 beam-5 (GPTQ T5, AWQ ViT): "
        f"{out['generate_gptq_s']:.3f} s, {n_tok} tokens: {seqs.tolist()}")
    log(f"  launches: {json.dumps(rec['counts'])}")
    check_phase_counts(rec["counts"])
    check_shapes(rec["shapes"], "quant")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec["counts"], out


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
# of the 588 keys.  Two cuts: one sample, on a model cut to ZEROTH_DEPTH
# blocks (every width kept; 196 keys, 392 forwards).  At full depth its
# 1176 batch-1 forwards took 132-197 s of a command that must stay under
# 1200 s, host-bound (PERF.md §4)
ZEROTH = dict(sparsity_ratio_granularity="block",
              score_method="olmezo-gradient_sum")
N_ZEROTH, N_ZEROTH_GRID = 1, 32
ZEROTH_DEPTH = (13, 8, 8)
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
    grid feeds it) on a fresh seed-3 model cut to ZEROTH_DEPTH, and beam-5
    generate.  Gates: each tower's density
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
        f"{N_ZEROTH_GRID}) on a model cut to "
        f"{'/'.join(map(str, ZEROTH_DEPTH))} blocks; nothing else (depth "
        f"39/24/24, {N_CALIB} calibration samples at batch {BS})")

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

    # the zeroth entry at ZEROTH_DEPTH (the cut), on a fresh seed-3 model
    # that the closures above read, fed at batch 1 as the grid feeds it;
    # its scoring timed apart from the sweep
    del model, lins, dense, batches
    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, batches, req = xl_setup(seed=3, lora=False,
                                        depth=ZEROTH_DEPTH)
    keys = AL.select_prunable_keys(model, ("visual_encoder", "t5_model"))
    lins = [model.get_submodule(".".join(k)) for k in keys]
    linears = {t: sum(".".join(k).startswith(t) for k in keys)
               for t in TOWERS}
    log(f"  zeroth model: cut to {'/'.join(map(str, ZEROTH_DEPTH))} "
        f"blocks (the cut; every width kept), seed 3, {len(keys)} keys "
        f"({json.dumps(linears)})")
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
    log(f"  zeroth scoring at {'/'.join(map(str, ZEROTH_DEPTH))} blocks: "
        f"{forwards} forwards at batch 1 in {score_s[0]:.2f} s ({ms:.2f} "
        f"ms a forward); the grid scores {N_ZEROTH_GRID} samples over 588 "
        f"keys at 39/24/24 ({2 * N_ZEROTH_GRID * 588} forwards)")
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
    del model, lins, batches, ones
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
    tiny_serving_check(cpu, generate_vicuna, [image, ids, mask, q_ids, q_mask],
                       dataclasses.replace(gen_cfg, num_beams=1,
                                           max_length=7),
                       "InstructBLIP-Vicuna")
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
    ragged) under ``key`` (ALPRO's: ``video``), the dataset (captions,
    ``txt2img``, ``img2txt``) on ``.dataset``."""

    def __init__(self, images, text, per_image: int, batch: int,
                 key: str = "image"):
        self.images, self.batch, self.key = images, batch, key
        self.dataset = type("RetrievalSet", (), {})()
        self.dataset.text = text
        self.dataset.txt2img = [t // per_image for t in range(len(text))]
        self.dataset.img2txt = {
            i: list(range(i * per_image, (i + 1) * per_image))
            for i in range(len(images))}

    def __iter__(self):
        return iter({self.key: self.images[s:s + self.batch]}
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


def c4_texts(n: int = C4_TEXTS, seed: int = VQA_RUN["seed"]) -> list:
    """n seeded texts of C4_LEN to 2 · C4_LEN words: each encodes past the
    task's max_len, so every batch is one (1, C4_LEN) row, as a C4
    document of a few hundred tokens is."""
    rng = random.Random(seed)
    words = [w for part in VQA_WORDS.values() for phrase in part
             for w in phrase.split()]
    return [" ".join(rng.choice(words) for _ in range(
        rng.randint(C4_LEN, 2 * C4_LEN))) + "." for _ in range(n)]


def c4_pass(model, tok, phase: str) -> tuple:
    """C4 perplexity through ``LanguageModelingTask`` (the language_modeling
    task of c4_prefix_derivative_compute.yaml, batch 1) on ``model``'s
    language tower (LLaMA causally, T5 as the seq2seq denoiser) over
    C4_TEXTS seeded texts, then each batch's loss recomputed by a direct
    call of the tower: the perplexity finite and exp of the recomputed
    token-weighted loss (within 1e-6 relative), every shape held in phase
    3.  Returns (launches by phase, numbers)."""
    import numpy as np

    from vlm_compression_tpu_torch.datasets.tokenization import batch_encode
    from vlm_compression_tpu_torch.tasks import setup_task

    texts = c4_texts()
    task = setup_task({"run": {"task": "language_modeling"}}, tokenizer=tok)
    batches = [{"text_input": [t], "instance_id": [i]}
               for i, t in enumerate(texts)]
    rec = new_record()
    res = run_phase(rec, phase, lambda: task.evaluation(model, batches))
    metrics = task.after_evaluation(res, split_name="test")
    lm = model.llm_model if hasattr(model, "llm_model") else model.t5_model
    tot = weighted = 0.0
    with torch.no_grad():
        for t in texts:
            ids, mask = batch_encode(tok, [t], task.max_len, add_bos=True,
                                     add_eos=True)
            labels = np.where(mask.astype(bool), ids, -100).astype(np.int32)
            out = lm(*(torch.from_numpy(a).cuda() for a in (ids, mask)),
                     labels=torch.from_numpy(labels).cuda())
            tot += int(mask.sum())
            weighted += float(out["loss"]) * int(mask.sum())
    ppl = math.exp(min(weighted / tot, 20))
    log(f"  {phase}: {len(texts)} texts at batch 1, {int(tot)} tokens "
        f"({sorted({r['n_tokens'] for r in res})} a text): "
        f"{rec['secs'][phase]:.3f} s ({tot / rec['secs'][phase]:.0f} "
        f"tokens/s), peak {rec['peaks'][phase] / 2**30:.2f} GiB; metrics "
        f"{json.dumps(metrics)}; recomputed directly: ppl {ppl!r}; "
        f"attention {attn_routes(rec['counts'][phase])}")
    if not (math.isfinite(metrics["ppl"])
            and abs(metrics["ppl"] - ppl) <= 1e-6 * ppl
            and metrics["agg_metrics"] == -metrics["ppl"]):
        raise AssertionError(f"{phase}: ppl {metrics} against {ppl}")
    check_shapes(rec["shapes"], phase)
    return rec["counts"], {f"{phase}_s": rec["secs"][phase],
                           f"{phase}_ppl": metrics["ppl"]}


def vicuna_rank(model) -> tuple:
    """Ranking on the pruned InstructBLIP-Vicuna-7B through ``VQATask``
    (vqav2_eval.yaml's inference_method rank): VICUNA_RANK_N questions over
    N_CANDS candidates (the cut: the T5 rank pass runs 64), the ViT and
    the Q-Former once per image, the b · C rows through LLaMA in the
    task's chunk; then a direct ``predict_class_vicuna`` in chunks of
    VICUNA_RANK_CHUNK rows: answers from the list, NLLs finite, the task's
    answers its argmin; every shape held in phase 3.  Returns (launches by
    phase, numbers)."""
    from vlm_compression_tpu_torch.datasets.tokenization import batch_encode
    from vlm_compression_tpu_torch.models.blip2_vicuna_instruct import (
        predict_class_vicuna,
    )
    from vlm_compression_tpu_torch.tasks.vqa import VQATask

    cfg = model.cfg
    toks = vicuna_tokenizers(cfg)
    samples = vqa_samples(cfg, VICUNA_RANK_N)
    cands = rank_candidates()
    ranker = VQATask.setup_task(dict(run=VQA_RUN, model=VICUNA_MODEL), **toks)
    ranker.answer_list = cands
    rec = new_record()
    ranked = run_phase(rec, "vicuna_rank",
                       lambda: ranker.evaluation(model, [samples]))
    picked = [r["answer"] for r in ranked]
    image, ids, mask, q_ids, q_mask = ranker._encode(model, samples)
    c_ids, c_mask = (torch.from_numpy(a) for a in batch_encode(
        toks["tokenizer"], cands, ranker.max_len))
    nll = run_phase(rec, "vicuna_rank_direct", lambda: predict_class_vicuna(
        model, image, ids, mask, c_ids, c_mask, q_ids, q_mask,
        rows_per_chunk=VICUNA_RANK_CHUNK))
    finite = float(torch.isfinite(nll).float().mean())
    best = [cands[i] for i in nll.argmin(-1).tolist()]
    secs, peaks = rec["secs"], rec["peaks"]
    rows = VICUNA_RANK_N * N_CANDS
    log(f"  vicuna rank: {VICUNA_RANK_N} questions x {N_CANDS} candidates "
        f"({rows} rows of 32 + {ids.shape[1]} + {c_ids.shape[1]} tokens): "
        f"task {secs['vicuna_rank']:.3f} s ({rows / secs['vicuna_rank']:.0f}"
        f" rows/s), peak {peaks['vicuna_rank'] / 2**30:.2f} GiB; direct in "
        f"chunks of {VICUNA_RANK_CHUNK} rows {secs['vicuna_rank_direct']:.3f}"
        f" s, peak {peaks['vicuna_rank_direct'] / 2**30:.2f} GiB; answers "
        f"{picked[:8]}...; NLL matrix {tuple(nll.shape)} finite share "
        f"{finite}, range [{float(nll.min()):.4f}, {float(nll.max()):.4f}]; "
        f"the task's answers the direct call's argmin {best == picked}")
    if any(a not in cands for a in picked) or finite != 1.0 \
            or best != picked:
        raise AssertionError("Vicuna ranking")
    check_shapes(rec["shapes"], "vicuna rank")
    return rec["counts"], {"vicuna_rank_s": secs["vicuna_rank"],
                           "vicuna_rank_direct_s": secs["vicuna_rank_direct"],
                           "vicuna_rank_peak_bytes": peaks["vicuna_rank"]}


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
    serve_counts, serve_shapes, serve = serving_path(model, cfg, vicuna=True)
    counts.update(serve_counts)
    shapes.update(serve_shapes)
    retrain = vicuna_retrain(model, req, gen_cfg, counts, shapes, secs)
    rank_counts, rank = vicuna_rank(model)
    counts.update(rank_counts)
    c4_counts, c4 = c4_pass(model, vicuna_tokenizers(cfg)["tokenizer"],
                            "c4_vicuna")
    counts.update(c4_counts)
    check_phase_counts({**rank_counts, **c4_counts})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    dsnot_counts, dsnot = vicuna_dsnot(req, gen_cfg)
    counts.update(dsnot_counts)
    # LLaMA's d = 128 attention by phase and route: each phase launched
    # it, on the TMA + wgmma kernels alone (the mma.sync counters also
    # read 0 there: check_phase_counts); the retrain and remat phases
    # backward too
    d128 = d128_launches(shapes)
    d128.update(dsnot.pop("vicuna_d128_dsnot"))
    log(f"  vicuna: LLaMA's d = 128 attention launches by phase and route "
        f"{json.dumps(d128)}")
    for phase, row in d128.items():
        trains = phase in ("vicuna_retrain", "remat_vicuna")
        if not row["forward"] or set(row["forward"]) != {"wgmma"} or \
                set(row["backward"]) - {"wgmma"} or \
                trains != bool(row["backward"]):
            raise AssertionError(f"vicuna {phase}: d = 128 launches {row}")
    return counts, {
        "vicuna_d128_launches": d128,
        **retrain, **dsnot, **rank, **c4,
        "vicuna_prune_s": secs["vicuna_prune"],
        "vicuna_generate_cold_s": secs["generate_vicuna_cold"],
        "vicuna_generate_s": secs["generate_vicuna_warm"],
        "vicuna_tokens_per_s": n_tok / secs["generate_vicuna_warm"],
        "vicuna_gqa_cold_s": secs["vicuna_gqa_cold"],
        "vicuna_gqa_warm_s": secs["vicuna_gqa_warm"],
        "vicuna_gqa_acc": gqa_metrics["acc"],
        "vicuna_okvqa_s": secs["vicuna_okvqa"],
        "vicuna_okvqa_acc": ok_metrics["overall"],
        "vicuna_gqa_device_ms": dev_ms, "vicuna_serving": serve,
        "vicuna_peak_bytes": {k: v for k, v in peaks.items()}}


def vicuna_retrain(model, req, gen_cfg, counts, shapes, secs) -> dict:
    """RESSA retraining of the pruned InstructBLIP-Vicuna-7B (the main
    path's ``run_retrain`` and its gates, on batches collated by
    ``make_vicuna_batch_preparer``: LLaMA at n = m = 72, d = 128 on the
    TMA + wgmma backward), one more KD step profiled (busy share, device time
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
    counts["remat_vicuna"], shapes["remat_vicuna"], remat = remat_check(
        model, batches[0], "vicuna")
    out.update(remat)
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
    phases = ("vicuna_retrain", "remat_vicuna", "generate_vicuna_merged")
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
        **e2e, "vicuna_d128_dsnot": d128_launches(rec["shapes"]),
        "vicuna_dsnot_prune_s": secs["vicuna_dsnot_prune"],
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
OPT_SEED = 16
# gqa_zeroshot_opt6.7b_eval.yaml's run settings are VQA_RUN's (batch 64,
# beam 5, max_len 10, min_len 1, its prompt); its model section names the
# arch no factory builds (the model is built from Blip2OPTConfig)
OPT_MODEL = dict(arch="blip2_opt", model_type="pretrain_opt6.7b")


def opt_tokenizers(cfg) -> dict:
    """OPT's special ids (pad 1, BOS = EOS = 2) over its 50272 ids; the
    Q-Former's own vocabulary for the ids the task encodes (BLIP-2 OPT's
    Q-Former reads no text)."""
    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
    )

    opt = cfg.opt
    return dict(tokenizer=SimpleTokenizer(
        opt.vocab_size, pad_token_id=opt.pad_token_id,
        eos_token_id=opt.eos_token_id, bos_token_id=opt.bos_token_id),
        qformer_tokenizer=SimpleTokenizer(cfg.qformer.vocab_size))


def opt_path() -> tuple:
    """Full-width BLIP-2 OPT-6.7B (EVA-ViT-g 39, the Q-Former 12, OPT 32 ×
    4096, ffn 16384, 32 heads of 128, vocab 50272; bf16, seeded random
    weights, seed OPT_SEED; built from ``Blip2OPTConfig`` directly, as the
    JAX package's tests build it: no factory has a ``blip2_opt`` arch;
    after the Vicuna models are freed), through the entry points a user
    calls: ``vit_wanda_pruner`` on the ViT (masks kept, 0.5 ± 0.01; the JAX
    pruners sweep no OPT tower); beam-5 ``generate_opt`` on N_REQ
    left-padded requests, cold and warm (tokens equal); ``GQATask`` at
    gqa_zeroshot_opt6.7b_eval.yaml's settings cold and warm (warm: each
    even question's own cold answer as its ground truth → exactly 50.00),
    its answers equal to a direct ``generate_opt``'s decoded tokens, one
    pass profiled; the task at ``speculative_gamma`` SPEC_GAMMA and with
    the int8 KV cache, each equal to its direct ``generate_opt`` (their
    answers against the bf16 beam's printed, not gated: random weights);
    every shape launched one that phase 3 held; OPT's d = 128 attention on
    TMA + wgmma alone.  Returns (launches by phase, numbers)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from vlm_compression_tpu_torch.compression import load_pruner
    from vlm_compression_tpu_torch.datasets.tokenization import batch_encode
    from vlm_compression_tpu_torch.models.blip2_opt import (
        Blip2OPT,
        Blip2OPTConfig,
        generate_opt,
    )
    from vlm_compression_tpu_torch.models.bridge import random_init_
    from vlm_compression_tpu_torch.models.factory import set_kv_cache_
    from vlm_compression_tpu_torch.models.generation import GenerationConfig
    from vlm_compression_tpu_torch.models.opt import OPTConfig
    from vlm_compression_tpu_torch.tasks.vqa import GQATask

    t0 = time.perf_counter()
    model = random_init_(Blip2OPT(Blip2OPTConfig(opt=OPTConfig.opt_6_7b()),
                                  device="cuda"), seed=OPT_SEED)
    cfg, opt = model.cfg, model.cfg.opt
    g = torch.Generator(device="cuda").manual_seed(42 + OPT_SEED)
    img = cfg.vit.img_size
    calib = [{"image": torch.randn(BS, img, img, 3, generator=g,
                                   device="cuda")}
             for _ in range(N_CALIB // BS)]
    # N_REQ prompts of TXT tokens, BOS first; request 1 left-padded by 7
    prompt_mask = torch.ones(N_REQ, TXT, dtype=torch.int32, device="cuda")
    prompt_mask[1, :7] = 0
    prompt = torch.randint(3, opt.vocab_size, (N_REQ, TXT), generator=g,
                           device="cuda")
    prompt = torch.where(prompt_mask == 1, prompt, opt.pad_token_id)
    prompt[0, 0] = prompt[2, 0] = prompt[3, 0] = prompt[1, 7] = \
        opt.bos_token_id
    req = (torch.randn(N_REQ, img, img, 3, generator=g, device="cuda"),
           prompt, prompt_mask)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"  model: BLIP-2 OPT-6.7B, {n_params / 1e9:.3f} B params, "
        f"{n_bytes / 1e9:.2f} GB at rest, bf16 (the Q-Former and opt_proj "
        f"fp32), random init + data {time.perf_counter() - t0:.1f} s; "
        f"cuts: none (depth {cfg.vit.depth}/{cfg.qformer.num_layers}/"
        f"{opt.num_layers}, {N_CALIB} calibration images)")
    rec = new_record()
    counts, shapes, secs, peaks = (rec[k] for k in ("counts", "shapes",
                                                    "secs", "peaks"))

    # --- the ViT's Wanda prune (masks kept)
    run_phase(rec, "opt_prune", lambda: load_pruner(
        "vit_wanda_pruner", model.visual_encoder, calib,
        vit_prune_spec=f"{cfg.vit.depth}-0.5-1.0-1.0",
        num_samples=N_CALIB).prune(lora_model=True))
    del calib
    (dens, n_lin), = tower_density(model, towers=("visual_encoder",)
                                   ).values()
    n_masked = sum(1 for _, m in model.named_modules()
                   if getattr(m, "mask", None) is not None)
    log(f"  opt prune (vit_wanda_pruner, lora_model=True): "
        f"{secs['opt_prune']:.2f} s, peak "
        f"{peaks['opt_prune'] / 2**30:.2f} GiB; ViT density {dens:.4f} over "
        f"{n_lin} linears, {n_masked} masked linears in the model; "
        f"attention {attn_routes(counts['opt_prune'])}")
    if abs(dens - 0.5) > 0.01 or n_lin != cfg.vit.depth * 4 \
            or n_masked != n_lin:
        raise AssertionError(f"opt prune: density {dens} over {n_lin} "
                             f"({n_masked} masked)")

    # --- beam-5 generate on N_REQ requests, cold then warm
    gen_cfg = GenerationConfig(num_beams=5, max_length=10, min_length=1,
                               eos_token_id=opt.eos_token_id,
                               pad_token_id=opt.pad_token_id)
    outs = {}
    for phase in ("generate_opt_cold", "generate_opt_warm"):
        outs[phase] = run_phase(rec, phase, lambda: generate_opt(
            model, *req, gen_cfg=gen_cfg)).cpu()
    seqs = outs["generate_opt_warm"]
    if tuple(seqs.shape) != (N_REQ, gen_cfg.max_length) \
            or not torch.equal(seqs[:, 0], prompt[:, -1].int().cpu()) \
            or not bool(((seqs >= 0) & (seqs < opt.vocab_size)).all()):
        raise AssertionError(f"bad generate_opt output {seqs}")
    if not torch.equal(outs["generate_opt_cold"], seqs):
        raise AssertionError("two generate_opt calls on the same inputs "
                             "differ")
    n_tok = int((seqs[:, 1:] != gen_cfg.pad_token_id).sum())
    for phase in outs:
        log(f"  generate_opt beam-5 ({phase}), {N_REQ} requests, "
            f"max_length 10: {secs[phase]:.3f} s, {n_tok} tokens, "
            f"{n_tok / secs[phase]:.1f} tokens/s, peak "
            f"{peaks[phase] / 2**30:.2f} GiB; attention "
            f"{attn_routes(counts[phase])}")
    log(f"  tokens (first column: each prompt's last token): "
        f"{seqs.tolist()}; equal cold vs warm")

    # --- GQA through the task, cold and warm; a direct generate_opt
    n = VQA_RUN["batch_size_eval"]
    beams = VQA_RUN["num_beams"]
    samples = vqa_samples(cfg, n)
    toks = opt_tokenizers(cfg)
    tok = toks["tokenizer"]
    prompts = [VQA_PROMPT.format(q) for q in samples["text_input"]]
    ids, mask = batch_encode(tok, prompts, 128, left_pad=True, add_bos=True)
    enc = [torch.from_numpy(a).cuda() for a in (ids, mask)]

    def decoded(rows):
        out = []
        for row in rows[:, 1:].tolist():
            row = row[:row.index(tok.eos_token_id)] \
                if tok.eos_token_id in row else row
            out.append(tok.decode(row).strip())
        return out

    def direct(phase, **kw):
        gcfg = GenerationConfig(
            num_beams=1 if kw else beams,
            max_length=VQA_RUN["max_len"] + 1,
            min_length=VQA_RUN["min_len"], eos_token_id=opt.eos_token_id,
            pad_token_id=opt.pad_token_id)
        return decoded(run_phase(rec, phase, lambda: generate_opt(
            model, samples["image"], *enc, gen_cfg=gcfg, **kw)).cpu())

    gqa = GQATask.setup_task(dict(run=VQA_RUN, model=OPT_MODEL), **toks)
    cold = run_phase(rec, "vqa_opt_gqa",
                     lambda: gqa.evaluation(model, [samples]))
    secs["opt_gqa_cold"] = secs["vqa_opt_gqa"]
    answers = [r["answer"] for r in cold]
    scored = dict(samples, answers=[
        [a] if i % 2 == 0 else [NEVER] for i, a in enumerate(answers)])
    t0 = time.perf_counter()
    warm = gqa.evaluation(model, [scored])
    torch.cuda.synchronize()
    secs["opt_gqa_warm"] = time.perf_counter() - t0
    if [r["answer"] for r in warm] != answers:
        raise AssertionError("OPT GQA: the warm pass answered otherwise")
    tmp = tempfile.TemporaryDirectory(prefix="opt_vqa_")
    try:
        gqa_metrics = gqa.after_evaluation(
            warm, split_name="val",
            result_dir=os.path.join(tmp.name, "gqa", "result"))
    finally:
        tmp.cleanup()
    log(f"  opt gqa: {n} questions, beam {beams}, max_len "
        f"{VQA_RUN['max_len']}: cold {secs['opt_gqa_cold']:.3f} s, warm "
        f"{secs['opt_gqa_warm']:.3f} s ({n / secs['opt_gqa_warm']:.1f} "
        f"questions/s), peak {peaks['vqa_opt_gqa'] / 2**30:.2f} GiB; "
        f"answers equal cold vs warm; {sum(a == '' for a in answers)} "
        f"empty; metrics {json.dumps(gqa_metrics)}; e.g. "
        f"{json.dumps(dict(zip(samples['text_input'][:3], answers)))}")
    if gqa_metrics["acc"] != 50.0 or gqa_metrics["agg_metrics"] != 50.0:
        raise AssertionError(f"OPT GQA accuracy {gqa_metrics}, not 50.00")
    # the task adds no drift: a direct generate_opt on the prompts encoded
    # as the task encodes them (left-padded, BOS first), decoded by hand
    same = direct("opt_gqa_direct") == answers
    pads = sorted(set((ids.shape[1] - mask.sum(1)).tolist()))
    log(f"  opt gqa prompts: {tuple(ids.shape)} (the prime holds "
        f"{cfg.qformer.num_query_tokens} + {ids.shape[1] - 1} slots, pads "
        f"per prompt {pads}); answers equal to a direct generate_opt's "
        f"{same}")
    if not same:
        raise AssertionError("the OPT GQA task's answers differ from a "
                             "direct generate_opt's decoded tokens")
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gqa.evaluation(model, [samples])
        torch.cuda.synchronize()
    dev_ms, _ = device_breakdown(prof, 1e3 * secs["opt_gqa_warm"],
                                 f"opt gqa, {n} questions, beam {beams}")
    log(f"  opt gqa profiled pass: peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # --- speculative decoding and the int8 KV cache through the task
    forms = {}
    for form, run, kv8 in (
            ("spec", dict(VQA_RUN, speculative_gamma=SPEC_GAMMA), False),
            ("kv8", VQA_RUN, True)):
        set_kv_cache_(model, int8=kv8)
        try:
            task = GQATask.setup_task(dict(run=run, model=OPT_MODEL), **toks)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                got = [r["answer"] for r in run_phase(
                    rec, f"vqa_opt_{form}",
                    lambda: task.evaluation(model, [samples]))]
            kw = (dict(llm_mode="dense", draft_llm_mode="masked",
                       speculative_gamma=SPEC_GAMMA) if form == "spec"
                  else {})
            want = direct(f"opt_{form}_direct", **kw)
        finally:
            set_kv_cache_(model)
        moved = sum(a != b for a, b in zip(got, answers))
        forms[form] = {"s": secs[f"vqa_opt_{form}"],
                       "answers_moved_vs_bf16_beam": moved,
                       "peak_bytes": peaks[f"vqa_opt_{form}"],
                       **(task.spec_stats if form == "spec" else {})}
        log(f"  opt gqa {form} (speculative_gamma "
            f"{run.get('speculative_gamma', 0)}, int8 KV cache {kv8}): "
            f"{secs[f'vqa_opt_{form}']:.3f} s, peak "
            f"{peaks[f'vqa_opt_{form}'] / 2**30:.2f} GiB; answers equal to "
            f"its direct generate_opt {got == want}; {moved} of {n} differ "
            f"from the bf16 beam-5 pass's (printed, not gated: random "
            f"weights); {json.dumps(forms[form])}")
        if got != want:
            raise AssertionError(f"OPT GQA {form}: the task's answers differ "
                                 "from its direct generate_opt's")

    log(f"  launches: {json.dumps(counts)}")
    check_phase_counts(counts)
    check_shapes(shapes, "opt")
    d128 = d128_launches(shapes)
    log(f"  opt: OPT's d = 128 attention launches by phase and route "
        f"{json.dumps(d128)}")
    for phase in OPT_PHASES:
        row = d128[phase]
        if not row["forward"] or set(row["forward"]) != {"wgmma"} \
                or row["backward"]:
            raise AssertionError(f"opt {phase}: d = 128 launches {row}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {
        "opt_d128_launches": d128, "opt_params": n_params,
        "opt_prune_s": secs["opt_prune"],
        "opt_generate_cold_s": secs["generate_opt_cold"],
        "opt_generate_s": secs["generate_opt_warm"],
        "opt_tokens_per_s": n_tok / secs["generate_opt_warm"],
        "opt_gqa_cold_s": secs["opt_gqa_cold"],
        "opt_gqa_warm_s": secs["opt_gqa_warm"],
        "opt_gqa_acc": gqa_metrics["acc"], "opt_gqa_device_ms": dev_ms,
        "opt_forms": forms, "opt_peak_bytes": dict(peaks)}


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
        gc.collect()
        torch.cuda.empty_cache()
        quant = cli_quant_calls(rec, eval_cfg, eval_job, eval_options, out,
                                samples)
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
        **quant,
        "cli_prune_call_s": rec["secs"]["cli_prune"],
        "cli_eval_call_s": rec["secs"]["cli_eval"],
        "cli_wanda_b1_s": p_timer.stats["prune_seconds"],
        **{f"cli_prune_{k}": v for k, v in p_timer.stats.items()},
        **{f"cli_eval_{k}": v for k, v in e_timer.stats.items()},
        "cli_checkpoint_bytes": ckpt_bytes,
        "cli_gqa_acc": metrics["acc"],
        "cli_peak_bytes": max(rec["peaks"].values())}


def cli_quant_calls(rec, eval_cfg, eval_job, eval_options, out,
                    samples) -> dict:
    """Two more GQA eval calls on the cli path's checkpoint: one with
    ``--quantize_int4``, one with ``--quantize_int8 --w8a8
    --int8_outliers 32``.  Gates: every linear of the evaluated model in
    that form; the W8A8 switches off when the call returns; the answers
    equal to a direct ``generate_t5`` of the same quantized model (with
    the switches set for W8A8); attention alone launched (no masks).
    Returns the readings."""
    from vlm_compression_tpu_torch.cli import evaluate as E
    from vlm_compression_tpu_torch.ops import quant as Q

    readings = {}
    for form, extra in (("int4", ["--quantize_int4"]),
                        ("w8a8", ["--quantize_int8", "--w8a8",
                                  "--int8_outliers", str(W8A8_OUTLIERS)])):
        job = f"{eval_job}-{form}"
        argv = ["--cfg-path", eval_cfg, "--pruned_checkpoint",
                f"{out}/{CLI_JOB}/pruned_{CLI_JOB}", "--job_id", job,
                "--seed", str(CLI_SEED + 1), *extra, "--options",
                f"run.output_dir={out}/{job}", *eval_options[1:], *CLI_ARGS]
        log(f"  cli: the {form} eval call: {' '.join(argv)}")
        stats, runner, timer = run_phase(
            rec, f"cli_eval_{form}", lambda: E.run(E.parse_args(argv)))
        if Q.dynamic_int8_enabled() or Q.int8_outliers():
            raise AssertionError(f"cli {form}: the W8A8 switches were left "
                                 "set")
        lins = sparse_linears(runner.model).values()
        if not all((m.kernel_q4 is not None) if form == "int4"
                   else (m.kernel.dtype == torch.int8) for m in lins):
            raise AssertionError(f"cli {form}: a linear is not in {form}")
        with open(os.path.join(out, job, "result",
                               "val_vqa_result.json")) as f:
            answers = {r["question_id"]: r["answer"] for r in json.load(f)}
        with Q.int8_switches():
            if form == "w8a8":
                Q.use_dynamic_int8(True)
                Q.set_int8_outliers(W8A8_OUTLIERS)
            direct = run_phase(
                rec, f"cli_direct_{form}",
                lambda: direct_vqa_answers(runner.model, samples)[0])
        if [answers[i] for i in range(CLI_N_GQA)] != direct:
            raise AssertionError(f"cli {form}: the eval call's answers "
                                 "differ from a direct generate_t5 of the "
                                 "quantized model")
        metrics = stats["eval_results"]["val"]
        readings[f"cli_eval_{form}_s"] = rec["secs"][f"cli_eval_{form}"]
        readings[f"cli_eval_{form}_acc"] = metrics["acc"]
        log(f"  cli {form}: {rec['secs'][f'cli_eval_{form}']:.2f} s "
            f"({json.dumps(timer.stats)}), GQA {metrics['acc']} (not gated: "
            f"the truth is the bf16 model's), answers = a direct "
            f"generate_t5 of the quantized model; peak "
            f"{rec['peaks'][f'cli_eval_{form}'] / 2**30:.2f} GiB; "
            f"attention {attn_routes(rec['counts'][f'cli_eval_{form}'])}")
        del runner, lins
        gc.collect()
        torch.cuda.empty_cache()
    return readings


# the CPU rehearsal's additions to both calls (empty on the card)
CLI_ARGS, CLI_OPTIONS, CLI_EVAL_OPTIONS = [], [], []

# the launcher's T5 RESSA grid point train_ressa("wanda", 0.5, 0.5,
# kl_weight=0.1, max_train_samples=96) (scripts/torch_launch_lib.py, the
# port's copy of scripts/launch_lib.py:87-125), its argv rewritten only
# where the environment needs it: the data's paths and run.output_dir
# (--options), --seed 8 (9 for the eval call's init, which the checkpoint
# overwrites), --device cuda
CLI_TRAIN_SEED = 8
# the CPU rehearsal's additions to the train call (empty on the card)
CLI_TRAIN_OPTIONS: list = []


def launcher_commands(fn, *args, **kw) -> list:
    """The commands the port's launcher function ``fn`` (of
    scripts/torch_launch_lib.py, by name) composes, without running
    them."""
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts"))
    try:
        import torch_launch_lib
    finally:
        sys.path.pop(0)
    cmds = []
    getattr(torch_launch_lib, fn)(*args, run=cmds.append, **kw)
    return cmds


def repo_path(argv: list, flag: str = "--cfg-path") -> list:
    """``argv`` with the launcher's repo-relative ``flag`` path made
    absolute (the same file, wherever the script runs from)."""
    argv = list(argv)
    i = argv.index(flag) + 1
    argv[i] = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           argv[i])
    return argv


def phase_recorder(rec: dict, prefix: str):
    """A ``PhaseTimer`` for the CLI's ``run`` that records each of its
    phases into ``rec`` as ``run_phase`` does, as ``prefix + name``: the
    launch counts reset at its start and read at its end, with its shapes,
    seconds and peak.  A launch between two phases (none is counted
    there) fails."""
    from vlm_compression_tpu_torch.common.profiling import PhaseTimer

    class Recorder(PhaseTimer):
        @contextlib.contextmanager
        def phase(self, name, trace=False):
            stray = {k: v for k, v in read_counts().items()
                     if isinstance(v, int) and v}
            if stray:
                raise AssertionError(f"launches outside the CLI's phases, "
                                     f"before {name}: {stray}")
            key = prefix + name
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with super().phase(name, trace):
                yield
            torch.cuda.synchronize()
            rec["secs"][key] = time.perf_counter() - t0
            rec["counts"][key] = read_counts()
            rec["shapes"][key] = read_shapes()
            rec["peaks"][key] = torch.cuda.max_memory_allocated()
            reset_counts()

    reset_counts()
    return Recorder()


def lora_b_untrained(model) -> list:
    """The adapters whose lora_b is still all 0, but for the last Q-Former
    layer's text FFN (its output leaves no trace in the loss: only the
    query positions leave the Q-Former)."""
    from vlm_compression_tpu_torch.models.layers import SparseLinear

    last = f"qformer.layers_{model.cfg.qformer.num_layers - 1}.ffn."
    return [name for name, m in model.named_modules()
            if isinstance(m, SparseLinear) and m.lora_rank
            and not name.startswith(last)
            and not bool(m.lora_b.count_nonzero())]


def tiny_cli_train_check():
    """``cli.train`` on the launcher's RESSA argv at ``--tiny`` in fp32,
    on the card and on the CPU from the same weights (the factory's
    seeded CPU init, copied to the card) over 16 of ``cli_data``'s
    captions at batch 8, the images resized to 28 × 28 by
    ``blip_image_eval`` (``blip2_image_train``'s crops are drawn from an
    unseeded generator, so the two runs would see other pixels): two KD
    steps at lr 1e-3 (at the
    yaml's warmup lr, 1e-6, an update is a few fp32 ulps of a lora_a
    entry, so rounding alone would fill the difference).  Limits
    (tests/test_torch_retrain.py, tests/test_torch_runner.py): masks
    bit-equal; each step's loss, CE and KL within 1e-4; the trained LoRA's
    change, as one vector, within 2e-3 of its norm, and every entry within
    one Adam step (2.1·lr) a step of the CPU's; the card run launched the
    masked matmul (the prune), sparse-LoRA and the attention backward."""
    import shutil

    from vlm_compression_tpu_torch.cli import train as T
    from vlm_compression_tpu_torch.models import factory
    from vlm_compression_tpu_torch.models.layers import SparseLinear

    (cmd,) = launcher_commands("train_ressa", "wanda", 0.5, 0.5,
                               kl_weight=0.1, max_train_samples=16)
    root = tempfile.mkdtemp(prefix="tiny_cli_train_")
    original = factory.build_model

    def seeded_on_the_cpu(cfg, seed=0, device=None):
        cpu = original(cfg, seed=seed, device="cpu")
        inits[torch.device(device).type] = {n: p.detach().clone()
                         for n, p in cpu.named_parameters() if "lora_" in n}
        if torch.device(device).type == "cpu":
            return cpu
        model = original(cfg, seed=seed, device=device)
        model.load_state_dict(cpu.state_dict())
        return model

    runs, inits = {}, {}
    factory.build_model = seeded_on_the_cpu
    try:
        cap_ann, _, images, _ = cli_data(root)
        cc3m = "datasets.instruct_cc3m_caption"
        for dev in ("cuda", "cpu"):
            argv = repo_path(cmd[3:]) + [
                "--tiny", "--device", dev, "--options",
                f"run.output_dir={root}/{dev}", "run.batch_size_train=8",
                "run.init_lr=1e-3", "run.warmup_lr=1e-3",
                "model.amp=false", f"{cc3m}.vis_processor.train.image_size=28",
                f"{cc3m}.vis_processor.train.name=blip_image_eval",
                f"{cc3m}.build_info.annotations.train=[{cap_ann}]",
                f"{cc3m}.build_info.images.storage={images}"]
            reset_counts()
            runs[dev] = T.run(T.parse_args(argv))[1]
            if dev == "cuda":
                torch.cuda.synchronize()
                launched = read_counts()
    finally:
        factory.build_model = original
        shutil.rmtree(root, ignore_errors=True)
    gpu, cpu = runs["cuda"], runs["cpu"]
    cpu_modules = dict(cpu.model.named_modules())
    masks = {n: (m.mask, cpu_modules[n].mask)
             for n, m in gpu.model.named_modules()
             if isinstance(m, SparseLinear) and m.mask is not None}
    flips = sum(int((g.cpu() != c).sum()) for g, c in masks.values())
    err_m = max(abs(g[k] - c[k]) / max(1.0, abs(c[k]))
                for g, c in zip(gpu.step_metrics, cpu.step_metrics)
                for k in ("loss", "ce", "kl"))
    lr = sum(s["lr"] for s in cpu.step_metrics)
    la, lc = gpu.train_state.lora, cpu.train_state.lora
    init = inits["cpu"]
    if set(init) != set(lc) or any(not torch.equal(init[n], inits["cuda"][n])
                                   for n in init):
        raise AssertionError("tiny cli.train: the two runs' initial LoRA "
                             "factors differ")
    dg = torch.cat([(la[n].detach().cpu() - init[n]).flatten() for n in lc])
    dc = torch.cat([(lc[n].detach() - init[n]).flatten() for n in lc])
    rel = float((dg - dc).norm() / dc.norm())
    worst = float((dg - dc).abs().max())
    log(f"  tiny fp32 cli.train (the launcher's RESSA argv), card vs CPU: "
        f"{len(gpu.step_metrics)} steps; {len(masks)} masks, {flips} bits "
        f"differ; loss/ce/kl max err {err_m:.3e} (tol 1e-4); LoRA change "
        f"|Δ|/|Δ_cpu| {rel:.3e} (tol 2e-3), max |Δ| {worst:.3e} (tol "
        f"{2.1 * lr:.2e}); launches masked_matmul "
        f"{launched['masked_matmul']}, sparse_lora "
        f"{launched['sparse_lora_matmul']}, attention backward "
        f"{launched[BWD_WGMMA] + launched['flash_attention_bwd_dq']}")
    if not (len(gpu.step_metrics) == len(cpu.step_metrics) == 2
            and masks and not flips and err_m <= 1e-4 and rel <= 2e-3
            and worst <= 2.1 * lr and launched["masked_matmul"] > 0
            and launched["sparse_lora_matmul"] > 0
            and launched[BWD_WGMMA] + launched["flash_attention_bwd_dq"] > 0):
        raise AssertionError("tiny cli.train, card vs CPU")


def cli_train_path() -> tuple:
    """The launcher's T5 RESSA grid point through the port's own
    ``cli.train`` and ``cli.evaluate`` (argv composed by
    scripts/torch_launch_lib.py, calls made in this process) on
    full-width InstructBLIP-FlanT5-XL (seed 8) and ``cli_data``'s seeded
    images and captions: the train call (Wanda 0.5 over 96 captions at
    batch CLI_TRAIN_PRUNE_BS, the cut, masks kept; LVQ r 4/8/2, KD 0.1 at T 1, 3 steps at batch
    32; the sparse merge; the model saved without its adapters), a
    direct ``generate_t5`` of the trained model with its masks dropped
    (the ground truth: each even question's answer; the odd ones'
    unreachable), then ``eval_checkpoint``'s GQA instruct call on the
    checkpoint with ``--strip_lora_masks``.  Gates: each tower's masks
    0.5 ± 0.01; every merged weight 0 where its mask is false; every
    lora_b moved off 0 (but the last Q-Former layer's text FFN's); every
    step's loss, CE and KL finite; the artifacts under JAX's names; the
    restored model equal to the trained one without its adapters and
    masks, tensor for tensor; GQA exactly 50.00 in ``eval_stats``; the
    eval call's answers equal to a direct ``generate_t5`` of the restored
    model; the launches of each CLI phase (masked matmul in the prune,
    sparse-LoRA and the TMA + wgmma backward in the retrain, no WMMA, no
    separate dbias, dense products in the eval); every shape held in phase
    3; the data and both checkpoints deleted.  Returns (launches by phase,
    readings)."""
    import shutil

    from vlm_compression_tpu_torch.cli import evaluate as E
    from vlm_compression_tpu_torch.cli import train as T
    from vlm_compression_tpu_torch.common.config import Config
    from vlm_compression_tpu_torch.datasets.builders import load_builder
    from vlm_compression_tpu_torch.models.layers import SparseLinear, set_mask
    from vlm_compression_tpu_torch.models.model_zoo import (
        default_config_path,
    )

    rec = new_record()
    root = tempfile.mkdtemp(prefix="cli_train_path_")
    try:
        t0 = time.perf_counter()
        cap_ann, gqa_ann, images, gqa = cli_data(root)
        data_s = time.perf_counter() - t0
        out = os.path.join(root, "output")
        (cmd,) = launcher_commands(
            "train_ressa", "wanda", 0.5, 0.5, kl_weight=0.1,
            max_train_samples=CLI_TRAIN_SAMPLES, device="cuda")
        job = cmd[cmd.index("--job_id") + 1]
        cc3m = "datasets.instruct_cc3m_caption.build_info"
        train_argv = repo_path(cmd[3:])
        i = train_argv.index("--prune_batch_size") + 1
        log(f"  cli train: the cut: --prune_batch_size "
            f"{train_argv[i]} -> {CLI_TRAIN_PRUNE_BS}")
        train_argv[i] = str(CLI_TRAIN_PRUNE_BS)
        train_argv += [
            "--seed", str(CLI_TRAIN_SEED), "--options",
            f"run.output_dir={out}/{job}",
            f"{cc3m}.annotations.train=[{cap_ann}]",
            f"{cc3m}.images.storage={images}", *CLI_TRAIN_OPTIONS, *CLI_ARGS]
        free = shutil.disk_usage(root).free
        log(f"  cli train: data {data_s:.2f} s; {free / 2**30:.1f} GiB free "
            f"under {tempfile.gettempdir()}; the train call: "
            f"{' '.join(train_argv)}")
        timer = phase_recorder(rec, "cli_train_")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_stats, t_runner, _ = T.run(T.parse_args(train_argv), timer=timer)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        # the recorder resets the peak at each phase
        train_peak = max(rec["peaks"][p] for p in CLI_TRAIN_PHASES)
        model = t_runner.model
        job_dir = os.path.join(out, job)
        ckpt = t_stats["pruned_checkpoint"]
        sizes = {name: os.path.getsize(os.path.join(job_dir, name))
                 for name in (f"pruned_{job}", "checkpoint_0")}
        missing = [name for name in (
            f"pruned_{job}", f"training_statistics/{job}.yaml",
            f"training_statistics_{job}.json", "checkpoint_0",
            "checkpoint_meta.json")
            if not os.path.exists(os.path.join(job_dir, name))]
        dens = tower_density(model)
        unmasked = sum(int(m.kernel[~m.mask].count_nonzero())
                       for m in model.modules()
                       if isinstance(m, SparseLinear) and m.mask is not None)
        untrained = lora_b_untrained(model)
        steps = t_runner.step_metrics
        log(f"  cli train: the call {train_s:.2f} s, peak "
            f"{train_peak / 2**30:.2f} GiB; phases "
            f"{json.dumps({k: round(v, 3) for k, v in rec['secs'].items()})}; "
            f"steps {json.dumps(steps)}; checkpoint bytes "
            f"{json.dumps(sizes)}; mask densities "
            f"{json.dumps({t: round(d, 6) for t, (d, _) in dens.items()})}; "
            f"non-zero weights off their masks {unmasked}; adapters with "
            f"lora_b still 0 {untrained}; artifacts missing {missing}")
        if missing or unmasked or untrained or len(steps) != 3 or not all(
                math.isfinite(s[k]) for s in steps
                for k in ("loss", "ce", "kl")):
            raise AssertionError("cli train: the train call's gates")
        for tower, (d, n) in dens.items():
            if n == 0 or abs(d - 0.5) > 0.01:
                raise AssertionError(f"cli train: {tower} mask density {d} "
                                     f"over {n} linears")

        # the model the stripped checkpoint holds: the merged weights, no
        # masks (masked mode then runs plain products); its direct
        # generate is the ground truth
        for m in model.modules():
            if isinstance(m, SparseLinear):
                set_mask(m, None)
        eval_job = f"{job}-{CLI_EVAL}"
        eval_options = [f"run.output_dir={out}/{eval_job}",
                        f"datasets.gqa.build_info.annotations.val=[{gqa_ann}]",
                        f"datasets.gqa.build_info.images.storage={images}",
                        *CLI_EVAL_OPTIONS]
        ecmds = launcher_commands("eval_checkpoint", ckpt, device="cuda")
        (ecmd,) = [c for c in ecmds if c[c.index("--cfg-path") + 1]
                   .endswith(f"/{CLI_EVAL}.yaml")]
        eval_argv = repo_path(ecmd[3:]) + [
            "--job_id", eval_job, "--seed", str(CLI_TRAIN_SEED + 1),
            "--options", *eval_options, *CLI_ARGS]
        cfg = Config(cfg_path=eval_argv[eval_argv.index("--cfg-path") + 1],
                     options=eval_options, defaults=default_config_path)
        ds = load_builder("gqa", cfg.datasets_cfg["gqa"]).build_datasets()[
            "val"]
        samples = ds.collater([ds[i] for i in range(len(ds))])
        truth = run_phase(rec, "cli_train_truth",
                          lambda: direct_vqa_answers(model, samples)[0])
        for i, (ann, a) in enumerate(zip(gqa, truth)):
            ann["answer"] = [a] if i % 2 == 0 else [NEVER]
        with open(gqa_ann, "w") as f:
            json.dump(gqa, f)

        log(f"  cli train: the eval call: {' '.join(eval_argv)}")
        e_stats, e_runner, e_timer = run_phase(
            rec, "cli_train_eval", lambda: E.run(E.parse_args(eval_argv)))
        restored = e_runner.model
        want = {k: v for k, v in model.state_dict().items()
                if k.rpartition(".")[2] not in ("lora_a", "lora_b")}
        got = restored.state_dict()
        if list(got) != list(want) or not all(
                torch.equal(got[k], want[k]) for k in want):
            raise AssertionError("cli train: the restored model differs "
                                 "from the trained one it was saved from")
        del model, t_runner, want
        gc.collect()
        torch.cuda.empty_cache()
        with open(os.path.join(out, eval_job,
                               f"eval_stats_{eval_job}.json")) as f:
            written = json.load(f)
        with open(os.path.join(out, eval_job, "result",
                               "val_vqa_result.json")) as f:
            answers = {r["question_id"]: r["answer"] for r in json.load(f)}
        direct = run_phase(rec, "cli_train_direct",
                           lambda: direct_vqa_answers(restored, samples)[0])
        metrics = written["eval_results"]["val"]
        log(f"  cli train: eval call {rec['secs']['cli_train_eval']:.2f} s "
            f"{json.dumps(e_timer.stats)}; peaks GiB "
            f"{json.dumps({p: round(b / 2**30, 2) for p, b in rec['peaks'].items()})}; "
            f"eval_stats {json.dumps(written)}; answers e.g. "
            f"{json.dumps([answers[i] for i in range(4)])}")
        for phase in CLI_TRAIN_PHASES + ("cli_train_truth", "cli_train_eval",
                                         "cli_train_direct"):
            c = rec["counts"][phase]
            log(f"  cli train {phase}: {rec['secs'][phase]:.3f} s; masked "
                f"{c['masked_matmul']} (Hopper loop {c[WGMMA_LOOP]}, decode "
                f"{c[DECODE]}, WMMA {c[WMMA_LOOP]}), sparse-LoRA "
                f"{c['sparse_lora_matmul']}; attention {attn_routes(c)}")
        if written != json.loads(json.dumps(e_stats, default=str)) or \
                metrics["acc"] != 50.0 or metrics["agg_metrics"] != 50.0:
            raise AssertionError(f"cli train: GQA {metrics}, not 50.00")
        if [answers[i] for i in range(CLI_N_GQA)] != direct:
            raise AssertionError("cli train: the eval call's answers differ "
                                 "from a direct generate_t5 of the restored "
                                 "model")
        del restored, e_runner
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if os.path.exists(root):
        raise AssertionError(f"cli train: {root} was not deleted")
    log(f"  cli train: {root} (data and both checkpoints) deleted")
    check_phase_counts(rec["counts"])
    check_shapes(rec["shapes"], "cli train")
    gc.collect()
    torch.cuda.empty_cache()
    return rec["counts"], {
        "cli_train_call_s": train_s,
        "cli_train_eval_call_s": rec["secs"]["cli_train_eval"],
        **{f"{k}_s": v for k, v in rec["secs"].items()},
        "cli_train_prune_seconds": t_stats["prune_seconds"],
        "cli_train_train_seconds": t_stats["train_seconds"],
        "cli_train_steps": steps,
        "cli_train_checkpoint_bytes": sizes[f"pruned_{job}"],
        "cli_train_checkpoint_0_bytes": sizes["checkpoint_0"],
        "cli_train_free_bytes": free,
        "cli_train_gqa_acc": metrics["acc"],
        "cli_train_peak_bytes": max(rec["peaks"].values())}


# the pruners beyond the launcher grid (pruners_path), seeds 10-14: RIA and
# the hybrid tiles on one full-width model, the soft-mask anneal at a
# depth cut (its fp32 products, about 2.9 PFLOP at full depth), WoodFisher
# over named leaves (the CLI's two whole towers would need about 3.9 TB of
# block inverses), then evaluate_woodfisher twice at full width
PRUNERS_SEED = 10
HYBRID_TILE = 64
# 4/3/3 since PR 23 (8/5/5 before: room for the zoo path)
SOFTMASK_DEPTH = (4, 3, 3)
N_WF = 8
WF_LEAVES = (("visual_encoder", "blocks_0", "attn", "qkv", "kernel"),
             ("t5_model", "encoder", "blocks_0", "self_attn", "q", "kernel"),
             ("t5_model", "encoder", "blocks_0", "self_attn", "v", "kernel"))
WF_CHUNK = 256
WF_CLI_EVAL = "gqa_zeroshot_flant5xl_instruct_eval"


def pruned_masks(model) -> dict:
    """name → bool keep-mask (in, out) of every masked linear."""
    from vlm_compression_tpu_torch.models.layers import SparseLinear

    return {n: m.bool_mask() for n, m in model.named_modules()
            if isinstance(m, SparseLinear) and m.mask is not None}


def clear_masks(model):
    from vlm_compression_tpu_torch.models.layers import SparseLinear

    for m in model.modules():
        if isinstance(m, SparseLinear):
            m.mask = None


def hybrid_tiles(mask: torch.Tensor, tile: int) -> tuple:
    """(dense tiles, 2:4 tiles, other tiles) of a keep-mask (in, out): a
    tile is dense when it keeps everything, 2:4 when every group of 4
    consecutive inputs of each of its units keeps exactly 2."""
    k, n = mask.shape
    if k % tile or n % tile:
        raise AssertionError(f"hybrid tiles: {k} x {n} not in {tile}-tiles")
    dense = mask.reshape(k // tile, tile, n // tile, tile).all(dim=3).all(
        dim=1)
    nm = (mask.reshape(k // 4, 4, n).sum(dim=1) == 2).reshape(
        k // tile, tile // 4, n // tile, tile).all(dim=3).all(dim=1)
    return (int(dense.sum()), int((nm & ~dense).sum()),
            int((~(dense | nm)).sum()))


def block_params(cfg) -> dict:
    """Parameters of one ViT, T5 encoder and T5 decoder block, from the
    configs (modules built on the meta device)."""
    from vlm_compression_tpu_torch.models.eva_vit import EvaBlock
    from vlm_compression_tpu_torch.models.t5 import T5Block

    def count(m):
        return sum(p.numel() for p in m.parameters())

    return {"vit": count(EvaBlock(cfg.vit, device="meta")),
            "enc": count(T5Block(cfg.t5, False, device="meta")),
            "dec": count(T5Block(cfg.t5, True, device="meta"))}


def pruners_path() -> tuple:
    """The pruners beyond the launcher grid and WoodFisher with block
    merging, on full-width InstructBLIP-FlanT5-XL (bf16, seeded random
    weights, no adapters, the 128 calibration samples of bench.py:189-191
    at batch 16).

    A (seed 10): Wanda, then, masks cleared, ``blipt5_ria_pruner`` at the
    launcher's specs with ``lora_model=True`` (masks kept; the share of
    mask bits that differ from Wanda's logged), beam-5 generate; masks
    cleared, ``blipt5_wanda_pruner`` 2:4 with ``hybrid_tile`` 64 at
    sparsity 0.4, beam-5 generate; transposable 2:4 of T5 ``wi_0``'s
    |W| (5120 × 2048) on the card and the CPU.  Gates: each RIA linear
    0.5 ± 0.01; each hybrid linear 0.6 ± 0.01, every 64 × 64 tile dense
    or 2:4; the transposable masks bit-equal.
    B (seed 11, depth SOFTMASK_DEPTH: the cut): ``blipt5_softmask_pruner``
    2:4, 48 steps, lr 0.1, beam-5 generate.  Gates: every group of 4
    keeps 2; each linear's OBS error at most its Wanda start's.
    C (seed 12): ``WoodFisher`` over WF_LEAVES, N_WF samples at batch 1.
    Gates: one 256-entry chunk's diag(F⁻¹) within 1e-4 relative of an
    fp64 inverse of damp·I + (1/N) Σ g gᵀ from the same gradients, and
    the seed I/damp more than 1e-2 from it (else the first gate could not
    fail a fold that does nothing); the attention backward on TMA + wgmma, 48 bias gradients a sample as its
    outputs.
    D (seeds 13, 14): ``cli.evaluate_woodfisher`` on the GQA yaml over
    ``cli_data``: the diagonal-Fisher ``unstrct`` prune at 0.5 (8
    samples: the cut; JAX's default is 64), then the pairwise block merge
    with ``--permute_before_merge`` (ViT 39 → 20, T5 24 + 24 → 12 + 12).
    Gates: the scored towers' non-zero share 0.5 ± 0.01; the depths;
    ``distilled_total_size`` the closed form from the configs; each call's
    answers equal to a direct ``generate_t5`` of its model."""
    import shutil

    import numpy as np

    from vlm_compression_tpu_torch.cli import evaluate_woodfisher as W
    from vlm_compression_tpu_torch.common.config import Config
    from vlm_compression_tpu_torch.compression import load_pruner
    from vlm_compression_tpu_torch.compression.distill_merge import (
        count_nonzero,
        count_params,
    )
    from vlm_compression_tpu_torch.compression.woodfisher import WoodFisher
    from vlm_compression_tpu_torch.datasets.builders import load_builder
    from vlm_compression_tpu_torch.models.model_zoo import (
        default_config_path,
    )
    from vlm_compression_tpu_torch.ops.masks import transposable_nm_mask

    rec, e2e = new_record(), {}
    secs = rec["secs"]

    def generate(model, req, cfg, phase):
        seqs, gen_cfg = run_phase(rec, phase, lambda: run_generate(model,
                                                                   req))
        n_tok = check_generate(seqs, gen_cfg, cfg)
        log(f"  {phase}: {secs[phase]:.3f} s, {n_tok} tokens; masked "
            f"{rec['counts'][phase]['masked_matmul']} (Hopper loop "
            f"{rec['counts'][phase][WGMMA_LOOP]}, decode "
            f"{rec['counts'][phase][DECODE]}, WMMA "
            f"{rec['counts'][phase][WMMA_LOOP]})")

    def prune_log(phase, what):
        c = rec["counts"][phase]
        log(f"  {what}: {secs[phase]:.2f} s, peak "
            f"{rec['peaks'][phase] / 2**30:.2f} GiB; masked "
            f"{c['masked_matmul']} (Hopper loop {c[WGMMA_LOOP]}, WMMA "
            f"{c[WMMA_LOOP]}); attention {attn_routes(c)}")

    # A: RIA against Wanda, then the hybrid tiles, on one model
    t0 = time.perf_counter()
    cfg, model, batches, req = xl_setup(seed=PRUNERS_SEED, lora=False)
    log(f"  model: InstructBLIP-FlanT5-XL, bf16, seed {PRUNERS_SEED}, no "
        f"adapters, random init + data {time.perf_counter() - t0:.1f} s; "
        f"cuts: none (depth 39/24/24, {N_CALIB} calibration samples)")
    run_phase(rec, "pruners_wanda_prune", lambda: run_prune(model, batches))
    prune_log("pruners_wanda_prune", "blipt5_wanda_pruner (the reference)")
    wanda = {n: m.clone() for n, m in pruned_masks(model).items()}
    clear_masks(model)
    run_phase(rec, "ria_prune",
              lambda: run_prune(model, batches, name="blipt5_ria_pruner"))
    prune_log("ria_prune", "blipt5_ria_pruner (alpha 0.5, lora_model=True)")
    ria = pruned_masks(model)
    flips = sum(int((ria[n] != wanda[n]).sum()) for n in ria)
    total = sum(m.numel() for m in ria.values())
    dens = {n: float(m.float().mean()) for n, m in ria.items()}
    del wanda
    log(f"  ria: {len(ria)} linears, density {min(dens.values()):.6f} to "
        f"{max(dens.values()):.6f}; {flips} of {total} mask bits "
        f"({flips / total:.4f}) differ from Wanda's on the same model and "
        f"batches")
    n_lin = 4 * cfg.vit.depth + 7 * cfg.t5.num_layers + \
        11 * cfg.t5.num_decoder_layers
    if len(ria) != n_lin or any(
            abs(d - 0.5) > 0.01 for d in dens.values()) or flips == 0:
        raise AssertionError(f"ria: {len(ria)} linears, densities "
                             f"{min(dens.values())}-{max(dens.values())}, "
                             f"{flips} flips")
    del ria
    generate(model, req, cfg, "generate_ria")

    clear_masks(model)

    def hybrid():
        pruner = load_pruner(
            "blipt5_wanda_pruner", model, batches,
            vit_prune_spec=f"{cfg.vit.depth}-0.6-1.0-1.0",
            t5_prune_spec=f"{cfg.t5.num_layers}-0.6-1.0-1.0",
            num_samples=N_CALIB, prune_n=2, prune_m=4,
            hybrid_tile=HYBRID_TILE)
        return pruner.prune(lora_model=True)

    run_phase(rec, "hybrid_prune", hybrid)
    prune_log("hybrid_prune", f"blipt5_wanda_pruner 2:4, hybrid_tile "
              f"{HYBRID_TILE}, sparsity 0.4")
    hyb = pruned_masks(model)
    dens = {n: float(m.float().mean()) for n, m in hyb.items()}
    tiles = [hybrid_tiles(m, HYBRID_TILE) for m in hyb.values()]
    n_dense, n_nm, n_bad = (sum(t[i] for t in tiles) for i in range(3))
    log(f"  hybrid: {len(hyb)} linears, density {min(dens.values()):.6f} "
        f"to {max(dens.values()):.6f}; {n_dense} dense and {n_nm} 2:4 "
        f"tiles of {HYBRID_TILE} x {HYBRID_TILE}, {n_bad} neither")
    if len(hyb) != n_lin or n_bad or any(abs(d - 0.6) > 0.01
                                       for d in dens.values()):
        raise AssertionError("hybrid tiles")
    del hyb, tiles
    generate(model, req, cfg, "generate_hybrid")

    met = model.t5_model.encoder.blocks_0.ffn.wi_0.kernel.detach().float(
        ).abs().T.contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = transposable_nm_mask(met, 2, 4)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = transposable_nm_mask(met.cpu(), 2, 4)
    t_cpu = time.perf_counter() - t0
    u, k = on_cpu.shape
    tiles = on_cpu.reshape(u // 4, 4, k // 4, 4)
    worst = max(int(tiles.sum(dim=3).max()), int(tiles.sum(dim=1).max()))
    differ = int((on_card.cpu() != on_cpu).sum())
    log(f"  transposable 2:4 of |T5 wi_0| {tuple(met.shape)}: card "
        f"{t_card:.3f} s, CPU {t_cpu:.3f} s; kept "
        f"{float(on_cpu.float().mean()):.4f}; most kept in a tile row or "
        f"column {worst}; {differ} bits differ card vs CPU")
    if differ or worst > 2:
        raise AssertionError("transposable n:m, card vs CPU")
    e2e.update(transposable_card_s=t_card, transposable_cpu_s=t_cpu)
    del model, batches, met, on_card, on_cpu, tiles
    gc.collect()
    torch.cuda.empty_cache()

    # B: the soft-mask anneal at the depth cut
    v, en, de = SOFTMASK_DEPTH
    t0 = time.perf_counter()
    cfg, model, batches, req = xl_setup(seed=PRUNERS_SEED + 1, lora=False,
                                        depth=SOFTMASK_DEPTH)
    log(f"  model: InstructBLIP-FlanT5-XL cut to {v}/{en}/{de} blocks (the "
        f"cut: the anneal's fp32 products, about 2.9 PFLOP at 39/24/24; "
        f"every width kept), seed {PRUNERS_SEED + 1}, "
        f"{time.perf_counter() - t0:.1f} s")
    pruner = load_pruner("blipt5_softmask_pruner", model, batches,
                         vit_prune_spec=f"{v}-0.5-1.0-1.0",
                         t5_prune_spec=f"{en}-0.5-1.0-1.0",
                         num_samples=N_CALIB, prune_n=2, prune_m=4,
                         softmask_steps=48, softmask_lr=0.1)
    run_phase(rec, "softmask_prune", lambda: pruner.prune(lora_model=True))
    prune_log("softmask_prune", "blipt5_softmask_pruner 2:4, 48 steps, lr "
              "0.1")
    soft = pruned_masks(model)
    bad = sum(int((m.reshape(m.shape[0] // 4, 4, -1).sum(dim=1) != 2).sum())
              for m in soft.values())
    errs = torch.stack([torch.stack(e) for e in pruner.softmask_errors]
                       ).double().cpu()
    ratio = errs[:, 0] / errs[:, 1].clamp_min(1e-30)
    n_lin = 4 * v + 7 * en + 11 * de
    log(f"  softmask: {len(soft)} linears, {bad} groups of 4 not keeping "
        f"2; err_best / err_init mean {float(ratio.mean()):.4f} (min "
        f"{float(ratio.min()):.4f}, max {float(ratio.max()):.4f}), "
        f"{int((ratio < 1).sum())} linears improved")
    if len(soft) != n_lin or len(errs) != n_lin or bad or bool(
            (errs[:, 0] > errs[:, 1]).any()):
        raise AssertionError("softmask masks or errors")
    e2e.update(softmask_prune_s=secs["softmask_prune"],
               softmask_err_ratio_mean=float(ratio.mean()))
    del soft, pruner
    generate(model, req, cfg, "generate_softmask")
    del model, batches
    gc.collect()
    torch.cuda.empty_cache()

    # C: WoodFisher over named leaves
    cfg, model, batches, req = xl_setup(seed=PRUNERS_SEED + 2, lora=False)
    samples = [{k: t[i:i + 1] for k, t in batches[0].items()}
               for i in range(N_WF)]
    del batches
    params = dict(model.named_parameters())
    sizes = {"/".join(p): params[".".join(p)].numel() for p in WF_LEAVES}
    inv_bytes = {p: -(-n // WF_CHUNK) * WF_CHUNK ** 2 * 4
                 for p, n in sizes.items()}
    log(f"  woodfisher leaves (weights, block-inverse bytes): "
        f"{json.dumps({p: [sizes[p], inv_bytes[p]] for p in sizes})}; "
        f"total {sum(inv_bytes.values()) / 1e9:.2f} GB")
    wf = WoodFisher(model, samples, num_samples=N_WF,
                    include=lambda p: p in WF_LEAVES)
    probe, grads = WF_LEAVES[0], []
    chunk = wf._chunk_size(sizes["/".join(probe)])
    per_sample = wf._per_sample_grads

    def recording():
        for g in per_sample():
            grads.append(g[probe].reshape(-1)[:chunk].double().clone())
            yield g

    wf._per_sample_grads = recording
    scores = run_phase(rec, "woodfisher",
                       wf.compute_fisher_inv_and_importance_score)
    c = rec["counts"]["woodfisher"]
    g = torch.stack(grads)
    dense = torch.linalg.inv(wf.fisher_damp * torch.eye(
        chunk, dtype=torch.float64, device=g.device) + g.T @ g / N_WF)
    got = wf.fisher_inv_diag[probe].reshape(-1)[:chunk].double()
    rel = float(((got - torch.diagonal(dense)).abs()
                 / torch.diagonal(dense).abs()).max())
    # the gate must be able to fail a fold that does nothing: the seed
    # I/damp has to miss the fp64 diagonal by far more than the tolerance
    noop = float(((1.0 / wf.fisher_damp - torch.diagonal(dense)).abs()
                  / torch.diagonal(dense).abs()).max())
    bad = [p for p, s in scores.items()
           if not bool(torch.isfinite(s).all()) or bool((s < 0).any())]
    per = c[BWD_DBIAS] / N_WF
    log(f"  woodfisher ({N_WF} samples at batch 1): {secs['woodfisher']:.2f} "
        f"s ({secs['woodfisher'] / N_WF:.3f} s a sample), peak "
        f"{rec['peaks']['woodfisher'] / 2**30:.2f} GiB; {len(scores)} "
        f"leaves scored, {len(bad)} not finite or negative; chunk 0 "
        f"({chunk} entries) of "
        f"{'/'.join(probe)}: diag(F^-1) vs fp64 inverse, max relative "
        f"error {rel:.3e} (tol 1e-4), diag range "
        f"{float(got.min()):.4e}-{float(got.max()):.4e} against 1/damp "
        f"{1.0 / wf.fisher_damp:.4e}, the unfolded I/damp's max relative "
        f"error {noop:.3e} (must exceed 1e-2); attention per "
        f"sample {attn_routes(c, N_WF)}")
    if (set(scores) != set(WF_LEAVES) or bad or rel > 1e-4 or noop < 1e-2
            or per != 48):
        raise AssertionError(f"woodfisher: {bad} {rel} {noop} {per}")
    e2e.update(woodfisher_s=secs["woodfisher"],
               woodfisher_peak_bytes=rec["peaks"]["woodfisher"],
               woodfisher_chunk_rel_err=rel,
               woodfisher_chunk_unfolded_rel_err=noop)
    del model, samples, wf, scores, grads, g, dense
    gc.collect()
    torch.cuda.empty_cache()

    # D: the CLI, twice
    repo = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="wf_cli_")
    try:
        _, gqa_ann, images, _ = cli_data(root)
        eval_cfg = os.path.join(repo, f"configs/projects/eval/{WF_CLI_EVAL}.yaml")
        options = [f"datasets.gqa.build_info.annotations.val=[{gqa_ann}]",
                   f"datasets.gqa.build_info.images.storage={images}",
                   *CLI_EVAL_OPTIONS]
        cfgd = Config(cfg_path=eval_cfg, options=options,
                      defaults=default_config_path)
        ds = load_builder("gqa", cfgd.datasets_cfg["gqa"]).build_datasets()[
            "val"]
        gqa_samples = ds.collater([ds[i] for i in range(len(ds))])
        vit_ids = ";".join(f"{i},{i + 1}" for i in range(0, 38, 2)) + ";38"
        t5_ids = ";".join(f"{i},{i + 1}" for i in range(0, 24, 2))
        calls = (
            ("wf_cli_unstrct", PRUNERS_SEED + 3,
             ["--get_derivative_info", "--distillation_init", "unstrct",
              "--distill_merge_ratio", "0.5", "--num_data",
              str(WF_CLI_DATA)]),
            ("wf_cli_merge", PRUNERS_SEED + 4,
             ["--distilled_block_ids", f"{vit_ids}|{t5_ids}",
              "--permute_before_merge"]))
        for phase, seed, flags in calls:
            job = f"{phase}-{seed}"
            argv = ["--cfg-path", eval_cfg, *flags, "--job_id", job,
                    "--seed", str(seed), "--options",
                    f"run.output_dir={root}/{job}", *options, *CLI_ARGS]
            log(f"  {phase}: python -m vlm_compression_tpu_torch.cli."
                f"evaluate_woodfisher {' '.join(argv)}")
            stats, runner, timer = run_phase(
                rec, phase, lambda: W.run(W.parse_args(argv)))
            model = runner.model
            with open(os.path.join(root, job, "result",
                                   "val_vqa_result.json")) as f:
                answers = {r["question_id"]: r["answer"]
                           for r in json.load(f)}
            direct = run_phase(rec, f"{phase}_direct", lambda: (
                direct_vqa_answers(model, gqa_samples)[0]))
            same = [answers[i] for i in range(len(direct))] == direct
            c = rec["counts"][phase]
            log(f"  {phase}: {secs[phase]:.2f} s, peak "
                f"{rec['peaks'][phase] / 2**30:.2f} GiB, phases "
                f"{json.dumps(timer.stats)}; sizes "
                f"{stats['orig_total_size']} -> "
                f"{stats['distilled_total_size']}; eval "
                f"{json.dumps(stats['eval_results'])}; answers equal to a "
                f"direct generate_t5: {same}; attention {attn_routes(c)}")
            if not same:
                raise AssertionError(f"{phase}: the answers differ from a "
                                     "direct generate_t5")
            if phase == "wf_cli_unstrct":
                towers = (model.visual_encoder, model.t5_model)
                share = sum(count_nonzero(t) for t in towers) / sum(
                    count_params(t) for t in towers)
                log(f"  {phase}: non-zero share of the scored towers "
                    f"{share:.6f}")
                if abs(share - 0.5) > 0.01 or stats[
                        "distilled_total_size"] != count_nonzero(model):
                    raise AssertionError(f"{phase}: share {share}")
                e2e.update(wf_cli_unstrct_s=secs[phase],
                           wf_cli_unstrct_share=share)
            else:
                per = block_params(model.cfg)
                depths = (model.cfg.vit.depth, model.cfg.t5.num_layers,
                          model.cfg.t5.num_decoder_layers,
                          len(model.visual_encoder.block_names),
                          len(model.t5_model.encoder.block_names),
                          len(model.t5_model.decoder.block_names))
                want = stats["orig_total_size"] - sum(
                    (d - -(-d // 2)) * per[t] for d, t in (
                        (cfg.vit.depth, "vit"), (cfg.t5.num_layers, "enc"),
                        (cfg.t5.num_decoder_layers, "dec")))
                log(f"  {phase}: depths {depths}; block parameters "
                    f"{json.dumps(per)}; distilled_total_size "
                    f"{stats['distilled_total_size']}, closed form {want}")
                half = tuple(-(-d // 2) for d in (
                    cfg.vit.depth, cfg.t5.num_layers,
                    cfg.t5.num_decoder_layers))
                if depths != half + half or stats[
                        "distilled_total_size"] != want or \
                        count_params(model) != want:
                    raise AssertionError(f"{phase}: depths {depths}, size "
                                         f"{stats['distilled_total_size']} "
                                         f"!= {want}")
                e2e.update(wf_cli_merge_s=secs[phase],
                           wf_cli_merge_merge_s=timer.stats.get(
                               "merge_seconds"))
            del model, runner
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check_phase_counts(rec["counts"])
    check_shapes(rec["shapes"], "pruners")
    log(f"  pruners: phase seconds "
        f"{json.dumps({p: round(t, 3) for p, t in secs.items()})}; peaks GiB "
        f"{json.dumps({p: round(b / 2**30, 2) for p, b in rec['peaks'].items()})}")
    e2e.update(ria_prune_s=secs["ria_prune"],
               hybrid_prune_s=secs["hybrid_prune"])
    return rec["counts"], e2e


def tiny_pruners_check():
    """The pruners path's slice on a tiny float32 InstructBLIP-T5 (std
    0.02, biases drawn too), the same weights and batches on the card and
    the CPU: ``blipt5_ria_pruner``, ``blipt5_wanda_pruner`` 2:4 with
    hybrid tiles of 4 and ``blipt5_softmask_pruner`` 2:4 (16 steps), every
    keep-mask bit-equal; WoodFisher's scores over both towers (chunks of
    16, 3 samples) within 1e-4 relative of each leaf's entries; both
    towers merged pairwise with the permutation, the merged model's logits
    within 1e-4; ``cli.evaluate_woodfisher`` at ``--tiny`` with
    ``--distillation_init unstrct_woodfisher`` from the factory's CPU init
    (the GQA yaml over ``cli_data``, images at 28²): the size stats, the
    eval results and the answers equal."""
    import shutil

    from vlm_compression_tpu_torch.cli import evaluate_woodfisher as W
    from vlm_compression_tpu_torch.compression import load_pruner
    from vlm_compression_tpu_torch.compression.distill_merge import (
        merge_tower_blocks,
    )
    from vlm_compression_tpu_torch.compression.woodfisher import WoodFisher
    from vlm_compression_tpu_torch.models import factory
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
    cpu = random_init_(Blip2T5Instruct(cfg, device="cpu"), seed=12, std=0.02)
    g = torch.Generator().manual_seed(12)
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

    def on_card(batches):
        return [{k: v.cuda() for k, v in b.items()} for b in batches]

    calib = [batch(4), batch(4)]
    nm = dict(prune_n=2, prune_m=4)
    cases = [("blipt5_ria_pruner", {}),
             ("blipt5_wanda_pruner", dict(
                 nm, hybrid_tile=4, vit_prune_spec="2-0.7-1.0-1.0",
                 t5_prune_spec="2-0.7-1.0-1.0")),
             ("blipt5_softmask_pruner", dict(nm, softmask_steps=16))]
    for name, kw in cases:
        masks = []
        for model, batches in ((copy.deepcopy(cpu), calib),
                               (copy.deepcopy(cpu).to("cuda"),
                                on_card(calib))):
            spec = dict(vit_prune_spec="2-0.5-1.0-1.0",
                        t5_prune_spec="2-0.5-1.0-1.0", num_samples=8)
            with torch.no_grad():
                load_pruner(name, model, batches,
                            **{**spec, **kw}).prune(lora_model=True)
            masks.append(export_masks(model))
        mc, mg = masks
        flips = sum(int((mc[p] != mg[p]).sum()) for p in mc)
        dens = sum(int(m.sum()) for m in mc.values()) / sum(
            m.size for m in mc.values())
        log(f"  tiny fp32 {name} {json.dumps(kw)}, card vs CPU: {len(mc)} "
            f"masks, density {dens:.4f}, {flips} bits differ")
        if len(mc) != 2 * 4 + 2 * 7 + 2 * 11 or set(mc) != set(mg) or flips:
            raise AssertionError(f"tiny {name}, card vs CPU")

    samples = [batch(1) for _ in range(3)]
    scores = []
    for model, batches in ((cpu, samples),
                           (copy.deepcopy(cpu).to("cuda"),
                            on_card(samples))):
        scores.append(WoodFisher(
            model, batches, num_samples=3, max_chunk=16,
            include=lambda p: p[0] in ("visual_encoder", "t5_model"),
        ).compute_fisher_inv_and_importance_score())
    sc, sg = scores
    err = max(float(((sg[p].cpu() - w).abs() / (
        w.abs() + 1e-6 * float(w.abs().max()) + 1e-30)).max())
        for p, w in sc.items())
    log(f"  tiny fp32 WoodFisher (both towers, chunks of 16, 3 samples), "
        f"card vs CPU: {len(sc)} leaves, worst relative error {err:.3e} "
        f"(tol 1e-4)")
    if set(sc) != set(sg) or err > 1e-4:
        raise AssertionError("tiny WoodFisher, card vs CPU")

    logits = []
    for dev in ("cpu", "cuda"):
        state = {k: v.to(dev) for k, v in cpu.state_dict().items()}
        for prefix in ("visual_encoder", "t5_model.encoder",
                       "t5_model.decoder"):
            head = prefix + "."
            tower = {k[len(head):]: state.pop(k) for k in list(state)
                     if k.startswith(head)}
            state.update({head + k: v for k, v in merge_tower_blocks(
                tower, [[0, 1]], permute=True).items()})
        merged = Blip2T5Instruct(dataclasses.replace(
            cfg, vit=dataclasses.replace(cfg.vit, depth=1),
            t5=dataclasses.replace(cfg.t5, num_layers=1,
                                   num_decoder_layers=1)), device=dev)
        merged.load_state_dict(state)
        with torch.no_grad():
            logits.append(merged(**{k: v.to(dev) for k, v in
                                    calib[0].items()})["logits"].cpu())
    err = float((logits[1] - logits[0]).abs().max())
    log(f"  tiny fp32 pairwise merge with the permutation (depth 1/1/1), "
        f"card vs CPU: logits max_abs_err {err:.3e} (tol 1e-4)")
    if err > 1e-4:
        raise AssertionError("tiny merged logits, card vs CPU")

    original = factory.build_model

    def seeded_on_the_cpu(model_cfg, seed=0, device=None):
        model = original(model_cfg, seed=seed, device="cpu")
        return model if torch.device(device).type == "cpu" else \
            model.to(device)

    root = tempfile.mkdtemp(prefix="tiny_wf_cli_")
    runs = {}
    factory.build_model = seeded_on_the_cpu
    try:
        _, gqa_ann, images, _ = cli_data(root)
        repo = os.path.dirname(os.path.abspath(__file__))
        for dev in ("cuda", "cpu"):
            argv = ["--cfg-path", os.path.join(
                repo, f"configs/projects/eval/{WF_CLI_EVAL}.yaml"),
                "--tiny", "--distillation_init", "unstrct_woodfisher",
                "--get_derivative_info", "--num_data", "2", "--device", dev,
                "--job_id", dev, "--options", f"run.output_dir={root}/{dev}",
                "model.amp=false", "datasets.gqa.vis_processor.eval."
                "image_size=28",
                f"datasets.gqa.build_info.annotations.val=[{gqa_ann}]",
                f"datasets.gqa.build_info.images.storage={images}"]
            stats = W.main(argv)
            with open(os.path.join(root, dev, "result",
                                   "val_vqa_result.json")) as f:
                runs[dev] = (stats, {r["question_id"]: r["answer"]
                                     for r in json.load(f)})
    finally:
        factory.build_model = original
        shutil.rmtree(root, ignore_errors=True)
    (sg_, ag), (sc_, ac) = runs["cuda"], runs["cpu"]
    same = {k: sg_[k] == sc_[k] for k in ("orig_total_size",
                                          "distilled_total_size",
                                          "eval_results")}
    log(f"  tiny fp32 cli.evaluate_woodfisher (unstrct_woodfisher, 2 "
        f"samples), card vs CPU: sizes {sg_['orig_total_size']} -> "
        f"{sg_['distilled_total_size']}; equal {json.dumps(same)}; "
        f"{sum(ag[k] == ac[k] for k in ac)} of {len(ac)} answers equal")
    if not all(same.values()) or ag != ac:
        raise AssertionError("tiny cli.evaluate_woodfisher, card vs CPU")


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


# the cut that keeps the command within its limit: the SparseGPT prune's
# trace at 2/2/2 of its 39/24/24 blocks (at 8/5/5 the two prunes took
# 66.0 s of the profile phase on one H100; 4/3/3 in PRs 21-22); the
# compressed path runs it at full depth.  The grid path's prunes are not traced (their walls stand in
# their own path)
# 2/2/2 since PR 23 (4/3/3 before: room for the zoo path)
SPARSEGPT_PROFILED_DEPTH = (2, 2, 2)


def profile_sparsegpt_prune(e2e):
    """The compressed path's SparseGPT prune once more under
    torch.profiler, device activity only, at SPARSEGPT_PROFILED_DEPTH (the
    cut): a fresh seed-1 model of that depth pruned unprofiled, then
    another profiled; device time by kernel group against the unprofiled
    wall-clock at that depth."""
    from torch.profiler import ProfilerActivity, profile

    def pruned(prof=None):
        _, model, batches, _ = xl_setup(seed=1, lora=False,
                                        depth=SPARSEGPT_PROFILED_DEPTH)
        t0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            run_prune(model, batches, "blipt5_sparsegpt_pruner")
        wall = time.perf_counter() - t0
        del model, batches
        gc.collect()
        torch.cuda.empty_cache()
        return wall

    wall = pruned()
    prof = profile(activities=[ProfilerActivity.CUDA])
    pruned(prof)
    total, _ = device_breakdown(
        prof, 1e3 * wall, f"sparsegpt prune at depth "
        f"{'/'.join(map(str, SPARSEGPT_PROFILED_DEPTH))} (at full depth "
        f"{e2e['sparsegpt_prune_s']:.2f} s)")
    e2e["sparsegpt_busy"] = total / (1e3 * wall)


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


def timed_shapes() -> set:
    """The shapes the kernel line reports, the only ones the timing phase
    times (the cut that keeps the command's time: every other shape is
    held against its plain version in phase 3, untimed)."""
    return ({MM_TIMED, FLASH_TIMED, LORA_TIMED, BWD_TIMED, *LORA_LLAMA,
             *FLASH_VICUNA_TIMED, *FLASH_OPT_TIMED}
            | {c[0] for c in BWD_SHAPES if c[5] == 128})


def timing():
    import torch.nn.functional as F

    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    rows, wmma, extra = {}, {}, {}
    bf16 = torch.bfloat16
    timed = timed_shapes()

    def wmma_ms(key, fn, m, k, n, rank=0):
        """The WMMA loop's time where the plan is the Hopper loop or the
        decode kernel (forced through the wrapper's internal ``_loop``
        argument), for the loops side by side in one run; '' elsewhere."""
        if expected_loop(m, k, n, bf16, rank) not in (ML.WGMMA, ML.DECODE):
            return ""
        wmma[key] = device_ms(fn)
        return f", WMMA loop {wmma[key]:.4f} ms"

    for name, m, k, n in MM_SHAPES:
        if name not in timed:
            continue
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
        if name not in timed:
            continue
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
        if name not in timed:
            continue
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
        if name not in timed:
            continue
        q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, bf16)
        g = grad_like(q)
        out, lse = A.flash_attention(q, k_, v, biases, scale)
        args = (q, k_, v, out, lse, g, biases, scale)
        # the planned route against the library: TMA + wgmma at every
        # shape, LLaMA's d = 128 included
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
    """The compressed path's shapes the kernel line reports (the decode
    shape of PACKED_TIMED / INT8_TIMED and the prefill shape of
    INT8_PREFILL_TIMED; the cut: the other shapes are held in phase 3,
    untimed) in every weight form (bool, packed G 128 and 256, int8 with
    no, bool and packed-128 masks) on the loop
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
    reported = {key.split()[0] for key in (PACKED_TIMED, INT8_TIMED,
                                           INT8_PREFILL_TIMED)}
    table = {}
    for name, m, k, n in SERVE_SHAPES + INT8_UNMASKED_SHAPES:
        if name not in reported:
            continue
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


# ------------------------------------------------------------------ the zoo
# The legacy image-text zoo at full width, bf16, seeded random weights:
# BLIP-1 base (ViT-B/16 at 224, MED-BERT-base 12 × 768, vocabulary 30524),
# ALBEF base (fusion from layer 6), CLIP ``ClipConfig.base()`` and EVA-CLIP
# (EVA ViT-g with CLIP's text tower).  Every linear of BLIP-1, ALBEF and
# CLIP, and of EVA-CLIP outside its vision tower, gets a 50 % per-linear
# magnitude mask (``ops/masks.unstructured_mask`` of |W|): no JAX pruner
# sweeps these towers.  The retrieval task runs at ``k_test`` 128 on the
# cut of ZOO_IMAGES images × ZOO_PER_IMAGE captions (Flickr30k's test set
# is 1000 × 5000); every caption's tokens are clipped at the task's 35
# (the longest caption has 40 words, a token a word).  Then direct calls
# of the other BLIP-1 heads and one ``cli.evaluate`` call on the BLIP
# retrieval yaml.
ZOO_SEED = 17
ZOO_IMAGES, ZOO_PER_IMAGE = 64, 5
ZOO_RUN = dict(task="retrieval", batch_size_eval=64, k_test=128)
ZOO_TXT = 35
ZOO_WORDS = (8, 40)
ZOO_PATCHES = 197                     # ViT-B/16 at 224: 14 · 14 + CLS
ZOO_FAMILIES = ("blip_retrieval", "albef_retrieval", "clip", "eva_clip")
ZOO_VQA = (16, 128)                   # questions × candidate answers
ZOO_Q_WORDS, ZOO_A_WORDS = 8, 3       # the longest question and answer
ZOO_DEC_B, ZOO_DEC_STEPS = 4, 10      # BlipCaption.decode_step, greedy
ZOO_SMALL_B, ZOO_SMALL_WORDS = 4, 12  # the NLVR and classification calls
ZOO_N_CLASSES = 3
CLIP_CTX, CLIP_CTX_B = 77, 16         # a direct encode_text over 77 tokens
ZOO_CLI_YAML = "configs/projects/blip/eval/ret_flickr_eval.yaml"
ZOO_CLI_IMAGE = (256, 320)
ZOO_CLI_IMAGES = 16                   # the CLI call's cut: 16 × 80
# the pass traced for the busy share: ALBEF's, on the CLI call's cut of
# ZOO_CLI_IMAGES images (its ITM rows as the full pass's, fewer of them)
ZOO_PROFILED = "albef_retrieval"
# the towers' linears, stored in bf16 here (the configs' param_dtype is
# float32, as in the JAX package: each product would cast its kernel and
# bias first); the ITC projections and heads stay float32
ZOO_TOWERS = ("visual_encoder.", "text_encoder.", "visual.",
              "text.resblocks_")
ZOO_TINY = ("blip_retrieval", "albef_retrieval", "clip")

# the zoo path: every retrieval family's masked towers on the Hopper loop
# and its float32 heads on the CUDA-core loop, every attention on TMA +
# wgmma (d = 64; EVA-CLIP's 88); the greedy caption steps on the decode
# kernel; the CLI's model holds no mask (attention alone); no backward and
# no WMMA loop anywhere.  Remat: the retrain step's kernels, twice
ZOO_PHASES = tuple(f"zoo_{a}" for a in ZOO_FAMILIES) + (
    f"zoo_{ZOO_PROFILED}_cut", "zoo_clip_ctx77", "zoo_blip_vqa", "zoo_blip_caption", "zoo_blip_nlvr",
    "zoo_blip_classification", "zoo_cli")
PHASE_KERNELS.update({p: RETRIEVAL for p in ZOO_PHASES})
PHASE_KERNELS.update(zoo_clip_ctx77=("masked_matmul", "flash_attention",
                                     FWD_WGMMA, WGMMA_LOOP),
                     zoo_blip_caption=SERVE + (FWD_WGMMA,),
                     zoo_cli=("flash_attention", FWD_WGMMA),
                     remat_t5=PHASE_KERNELS["retrain"],
                     remat_vicuna=PHASE_KERNELS["retrain"])
for _phase in ZOO_PHASES:
    PHASE_FORBIDDEN[_phase] = BACKWARD + (WMMA_LOOP,)
PHASE_FORBIDDEN.update(remat_t5=PHASE_FORBIDDEN["retrain"],
                       remat_vicuna=PHASE_FORBIDDEN["retrain"])


def zoo_mm_shapes() -> list:
    """(name, M, K, N, dtype) of every masked linear the zoo path runs:
    the towers in bf16, the ITC projections and the heads in float32."""
    T, P, H, W = ZOO_TXT, ZOO_PATCHES, 768, 512
    n_txt = ZOO_IMAGES * ZOO_PER_IMAGE
    k_i2t = min(ZOO_RUN["k_test"], n_txt)
    k_t2i = min(ZOO_RUN["k_test"], ZOO_IMAGES)
    q, c = ZOO_VQA
    out = []

    def add(name, m, k, n, dtype=torch.bfloat16):
        out.append((name, m, k, n, dtype))

    def vit(tag, b):
        add(f"zoo_vit_qkv_{tag}", b * P, H, 3 * H)
        add(f"zoo_vit_proj_{tag}", b * P, H, H)
        add(f"zoo_vit_fc1_{tag}", b * P, H, 4 * H)
        add(f"zoo_vit_fc2_{tag}", b * P, 4 * H, H)

    def med(tag, rows):
        add(f"zoo_med_qkvo_{tag}", rows, H, H)
        add(f"zoo_med_ffn1_{tag}", rows, H, 4 * H)
        add(f"zoo_med_ffn2_{tag}", rows, 4 * H, H)

    def clip_text(tag, rows):
        add(f"zoo_clip_qkv_{tag}", rows, W, 3 * W)
        add(f"zoo_clip_proj_{tag}", rows, W, W)
        add(f"zoo_clip_fc_{tag}", rows, W, 4 * W)
        add(f"zoo_clip_cproj_{tag}", rows, 4 * W, W)

    vit("b64", ZOO_IMAGES)
    vit("b16", q)
    vit("b4", ZOO_SMALL_B)
    med("text", n_txt * T)
    med("i2t", k_i2t * T)
    med("t2i", k_t2i * T)
    add("zoo_med_cross_kv_i2t", k_i2t * P, H, H)
    med("vqa_q", q * ZOO_Q_WORDS)
    med("vqa_a", q * c * ZOO_A_WORDS)
    add("zoo_med_cross_kv_vqa_a", q * c * ZOO_Q_WORDS, H, H)
    for t in range(1, ZOO_DEC_STEPS + 1):
        med(f"dec{t}_decode", ZOO_DEC_B * t)
    med("small", ZOO_SMALL_B * ZOO_SMALL_WORDS)
    # the profiled pass on the CLI call's cut
    n_cut = ZOO_CLI_IMAGES * ZOO_PER_IMAGE
    med("cut_text", n_cut * T)
    med("cut_t2i", ZOO_CLI_IMAGES * T)
    add("zoo_med_cross_kv_cut_i2t", n_cut * P, H, H)
    add("zoo_med_cross_kv_nlvr", ZOO_SMALL_B * 2 * P, H, H)
    clip_text("text", n_txt * T)
    clip_text("ctx77", CLIP_CTX_B * CLIP_CTX)
    f32 = torch.float32
    add("zoo_vision_proj", ZOO_IMAGES, H, 256, f32)
    add("zoo_text_proj", n_txt, H, 256, f32)
    add("zoo_itm_head_i2t", k_i2t, H, 2, f32)
    add("zoo_itm_head_t2i", k_t2i, H, 2, f32)
    add("zoo_vision_proj_cut", ZOO_CLI_IMAGES, H, 256, f32)
    add("zoo_text_proj_cut", n_cut, H, 256, f32)
    add("zoo_itm_head_cut_i2t", n_cut, H, 2, f32)
    add("zoo_itm_head_cut_t2i", ZOO_CLI_IMAGES, H, 2, f32)
    add("zoo_cls_head_nlvr", ZOO_SMALL_B, H, 2, f32)
    add("zoo_cls_head", ZOO_SMALL_B, H, ZOO_N_CLASSES, f32)
    add("zoo_clip_visual_proj", ZOO_IMAGES, H, W, f32)
    add("zoo_clip_text_proj", n_txt, W, W, f32)
    add("zoo_clip_text_proj_ctx77", CLIP_CTX_B, W, W, f32)
    add("zoo_eva_clip_visual_proj", ZOO_IMAGES, 1408, 1024, f32)
    add("zoo_eva_clip_text_proj", n_txt, W, 1024, f32)
    seen, uniq = set(), []
    for row in out:
        if row[1:] not in seen:
            seen.add(row[1:])
            uniq.append(row)
    return uniq


def zoo_flash_shapes() -> list:
    """(name, b, n, m, h, d, biases, scale, causal) of every attention the
    zoo path runs.  "pad": MED's (b, 1, 1, m) padding bias (its all-ones
    image mask is a bias too); "medc": MED's causal mask with its padding,
    one (b, 1, n, n) bias; CLIP's text runs the causal flag, no bias."""
    T, P, s = ZOO_TXT, ZOO_PATCHES, 0.125
    n_txt = ZOO_IMAGES * ZOO_PER_IMAGE
    k_i2t = min(ZOO_RUN["k_test"], n_txt)
    k_t2i = min(ZOO_RUN["k_test"], ZOO_IMAGES)
    q, c = ZOO_VQA
    Ls = ZOO_SMALL_WORDS
    out = [("zoo_vit_b64", ZOO_IMAGES, P, P, 12, 64, [], s, False),
           ("zoo_vit_b16", q, P, P, 12, 64, [], s, False),
           ("zoo_vit_b4", ZOO_SMALL_B, P, P, 12, 64, [], s, False),
           ("zoo_eva_vit_b64", ZOO_IMAGES, 257, 257, 16, 88, [],
            88 ** -0.5, False),
           ("zoo_med_text", n_txt, T, T, 12, 64, ["pad"], s, False),
           ("zoo_med_self_i2t", k_i2t, T, T, 12, 64, ["pad"], s, False),
           ("zoo_med_cross_i2t", k_i2t, T, P, 12, 64, ["pad"], s, False),
           ("zoo_med_self_t2i", k_t2i, T, T, 12, 64, ["pad"], s, False),
           ("zoo_med_cross_t2i", k_t2i, T, P, 12, 64, ["pad"], s, False),
           ("zoo_vqa_q_self", q, ZOO_Q_WORDS, ZOO_Q_WORDS, 12, 64, ["pad"],
            s, False),
           ("zoo_vqa_q_cross", q, ZOO_Q_WORDS, P, 12, 64, ["pad"], s, False),
           ("zoo_vqa_a_self", q * c, ZOO_A_WORDS, ZOO_A_WORDS, 12, 64,
            ["medc"], s, False),
           ("zoo_vqa_a_cross", q * c, ZOO_A_WORDS, ZOO_Q_WORDS, 12, 64,
            ["pad"], s, False),
           ("zoo_small_self", ZOO_SMALL_B, Ls, Ls, 12, 64, ["pad"], s,
            False),
           ("zoo_nlvr_cross", ZOO_SMALL_B, Ls, 2 * P, 12, 64, ["pad"], s,
            False),
           ("zoo_cls_cross", ZOO_SMALL_B, Ls, P, 12, 64, ["pad"], s, False),
           ("zoo_clip_text", n_txt, T, T, 8, 64, [], s, True),
           # the CLI call's cut: its captions, and the rerank over them
           # and over its images
           ("zoo_cli_text", ZOO_CLI_IMAGES * ZOO_PER_IMAGE, T, T, 12, 64,
            ["pad"], s, False),
           ("zoo_cli_cross_i2t", ZOO_CLI_IMAGES * ZOO_PER_IMAGE, T, P, 12,
            64, ["pad"], s, False),
           ("zoo_cli_self_t2i", ZOO_CLI_IMAGES, T, T, 12, 64, ["pad"], s,
            False),
           ("zoo_cli_cross_t2i", ZOO_CLI_IMAGES, T, P, 12, 64, ["pad"], s,
            False),
           ("zoo_clip_ctx77", CLIP_CTX_B, CLIP_CTX, CLIP_CTX, 8, 64, [], s,
            True)]
    for t in range(1, ZOO_DEC_STEPS + 1):
        out += [(f"zoo_dec_self_{t}", ZOO_DEC_B, t, t, 12, 64, ["medc"], s,
                 False),
                (f"zoo_dec_cross_{t}", ZOO_DEC_B, t, P, 12, 64, ["pad"], s,
                 False)]
    return out


# timed for the kernel line: the Hopper loop (the ViT, the ITM rerank's
# MED), the float32 loop (the ITM head), the decode kernel (a greedy step);
# attention at the ViT's n = m = 197, the rerank's cross-attention over
# 35 × 197, CLIP's causal 77 and MED's text pass
ZOO_MM_TIMED = ("zoo_vit_qkv_b64", "zoo_med_ffn1_i2t", "zoo_itm_head_i2t",
                "zoo_med_qkvo_dec10_decode")
ZOO_FLASH_TIMED = ("zoo_vit_b64", "zoo_med_cross_i2t", "zoo_clip_ctx77",
                   "zoo_med_text")


def zoo_mm_bound_ms(m, k, n, dtype):
    """x, W, the bool mask and y each once; the bf16 or float32 peak."""
    if dtype == torch.bfloat16:
        return mm_bound_ms(m, k, n)
    t_ops = 2.0 * m * n * k / PEAK_F32_FLOPS
    t_bytes = (4.0 * m * k + 5.0 * k * n + 4.0 * m * n) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_zoo_kernels(worst):
    """Rows 1 and 4 at every zoo shape against their plain versions:
    the masked matmul on the loop ``plan`` picks (bf16 tower shapes in
    bf16 and float32, the float32 heads in float32), the attention forward
    on the route ``plan_forward`` picks (and, in bf16, on the mma.sync
    route); two identical calls of each bit-equal."""
    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    n_mm = n_fl = 0
    for name, m, k, n, own in zoo_mm_shapes():
        dtypes = ((torch.bfloat16, torch.float32) if own == torch.bfloat16
                  else (torch.float32,))
        for dtype in dtypes:
            tol = TOL[str(dtype).split(".")[-1]]
            x, w, mask = mm_inputs(m, k, n, dtype)
            before = loop_counts()
            got = ML.masked_matmul(x, w, mask)
            loop = check_loop("masked_matmul", name, m, k, n, dtype, before)
            err, scale = max_err(got, ML.masked_matmul_ref(x, w, mask))
            again = ML.masked_matmul(x, w, mask)
            same = torch.equal(got, again)
            ok = err <= tol * scale and same
            log(f"  masked_matmul {name:28s} {str(dtype)[6:]:8s} M={m} "
                f"K={k} N={n} {loop:6s} max_abs_err={err:.3e} (tol "
                f"{tol * scale:.3e}), two calls bit-equal {same} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"masked_matmul {name} {dtype}")
            if dtype == own:
                worst[("masked_matmul", name, dtype)] = err
            n_mm += 1
    for name, b, n, m, h, d, kinds, scale, causal in zoo_flash_shapes():
        for dtype in (torch.bfloat16, torch.float32):
            tol = TOL[str(dtype).split(".")[-1]]
            q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, dtype)
            want = A.mha_reference(q, k_, v, biases, scale, causal)
            planned = A.plan_forward(n, m, d, bf16=dtype == torch.bfloat16)
            routes = [planned] + ([A.MMA] if dtype == torch.bfloat16
                                  and planned != A.MMA else [])
            for route in routes:
                before = A.fwd_wgmma_launches
                impl = None if route == planned else route
                got, lse = A.flash_attention(q, k_, v, biases, scale, causal,
                                             _impl=impl)
                if (A.fwd_wgmma_launches - before) != (route == A.WGMMA):
                    raise AssertionError(f"flash_attention {name}: route "
                                         f"{route} not taken")
                err, s = max_err(got, want)
                same = True
                if route == planned:
                    got2, lse2 = A.flash_attention(q, k_, v, biases, scale,
                                                   causal)
                    same = torch.equal(got, got2) and torch.equal(lse, lse2)
                ok = err <= tol * s and same
                log(f"  flash_attention {name:22s} {str(dtype)[6:]:8s} "
                    f"{route:5s} b={b} n={n} m={m} h={h} d={d} "
                    f"biases={kinds} causal={causal} max_abs_err={err:.3e} "
                    f"(tol {tol * s:.3e}), two calls bit-equal {same} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash_attention {name} {dtype} "
                                         f"{route}")
                if route == planned and dtype == torch.bfloat16:
                    worst[("flash_attention", name, dtype)] = err
                n_fl += 1
    log(f"  the zoo's shapes: {n_mm} masked-matmul and {n_fl} attention "
        f"checks, each within its tolerance and bit-equal to a second "
        f"identical call")


def zoo_bf16_towers_(model, towers: tuple = ZOO_TOWERS):
    """The towers' linears (those under ``towers``) stored in bf16,
    kernels and biases; the heads and projections outside them stay
    float32."""
    from vlm_compression_tpu_torch.models.layers import SparseLinear

    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, SparseLinear) and name.startswith(towers):
                m.kernel.data = m.kernel.data.to(torch.bfloat16)
                if m.bias is not None:
                    m.bias.data = m.bias.data.to(torch.bfloat16)


def zoo_masks_(model, skip: tuple = ()) -> int:
    """A 50 % per-linear magnitude mask on every SparseLinear whose name
    does not start with one of ``skip``: each output unit keeps the larger
    half of its |w| (``ops/masks.unstructured_mask``).  Returns how many
    linears it masked."""
    from vlm_compression_tpu_torch.models.layers import SparseLinear, set_mask
    from vlm_compression_tpu_torch.ops.masks import unstructured_mask

    n = 0
    for name, m in model.named_modules():
        if isinstance(m, SparseLinear) and not (skip and name.startswith(
                skip)):
            metric = m.kernel.detach().float().abs().T
            set_mask(m, unstructured_mask(metric, 0.5).T.contiguous())
            n += 1
    return n


def zoo_retrieval_set(seed: int) -> tuple:
    """ZOO_IMAGES seeded images (b, 224, 224, 3) on the card and
    ZOO_PER_IMAGE seeded captions an image, the first one the longest."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randn(ZOO_IMAGES, 224, 224, 3, generator=g,
                         device="cuda")
    text = retrieval_captions(ZOO_IMAGES * ZOO_PER_IMAGE,
                              random.Random(seed), *ZOO_WORDS)
    return images, text


def zoo_fill_check(res: dict, rerank: bool, label: str,
                   n_img: int = ZOO_IMAGES):
    """The score matrices' shapes; every entry finite; with the ITM rerank
    each row keeps min(k_test, columns) entries off the −100.0 fill."""
    n_txt = n_img * ZOO_PER_IMAGE
    for key, shape in (("score_i2t", (n_img, n_txt)),
                       ("score_t2i", (n_txt, n_img))):
        s = res[key]
        if s.shape != shape or not bool((s == s).all()):
            raise AssertionError(f"{label} {key}: shape {s.shape}")
        if rerank:
            kept = (s != -100.0).sum(1)
            want = min(ZOO_RUN["k_test"], shape[1])
            if not bool((kept == want).all()):
                raise AssertionError(f"{label} {key}: {kept.min()}-"
                                     f"{kept.max()} entries reranked a row, "
                                     f"not {want}")


def zoo_route_counts(c: dict) -> dict:
    """A phase's launches of rows 1 and 4 by route."""
    other = (c["masked_matmul"] - c[WGMMA_LOOP] - c[DECODE] - c[WMMA_LOOP])
    return {"masked_matmul": {"hopper": c[WGMMA_LOOP], "decode": c[DECODE],
                              "wmma": c[WMMA_LOOP], "fp32": other},
            "flash_attention": {"wgmma": c[FWD_WGMMA],
                                "mma_or_fp32": c[FWD_MMA]}}


def zoo_cli(rec: dict) -> dict:
    """One ``cli.evaluate`` call on the BLIP retrieval yaml over
    ZOO_CLI_IMAGES seeded ``.npy`` images (ZOO_CLI_IMAGE, uint8) and
    ZOO_PER_IMAGE captions an image, the processor's ``image_size`` set to
    224: the factory builds ViT-B/16 at 224 whatever the yaml says (only
    ``num_classes`` is read, in both packages), and the yaml's 384 would
    meet a 197-token ``pos_embed``.  Returns its R@k and seconds."""
    from vlm_compression_tpu_torch.cli.evaluate import parse_args, run

    root = os.path.dirname(os.path.abspath(__file__))
    import numpy as np

    rng = np.random.default_rng(ZOO_SEED)
    text = retrieval_captions(ZOO_CLI_IMAGES * ZOO_PER_IMAGE,
                              random.Random(ZOO_SEED + 1), *ZOO_WORDS)
    with tempfile.TemporaryDirectory(prefix="zoo_cli_") as tmp:
        os.makedirs(os.path.join(tmp, "img"))
        anns = []
        for i in range(ZOO_CLI_IMAGES):
            np.save(os.path.join(tmp, "img", f"{i}.npy"),
                    rng.integers(0, 256, ZOO_CLI_IMAGE + (3,),
                                 dtype=np.uint8))
            anns.append({"image": f"{i}.npy", "caption": text[
                i * ZOO_PER_IMAGE:(i + 1) * ZOO_PER_IMAGE]})
        ann = os.path.join(tmp, "test.json")
        with open(ann, "w") as f:
            json.dump(anns, f)
        argv = ["--cfg-path", os.path.join(root, ZOO_CLI_YAML),
                "--job_id", "zoo", "--seed", str(ZOO_SEED), "--options",
                f"datasets.flickr30k.build_info.annotations.test=[{ann}]",
                "datasets.flickr30k.build_info.images.storage="
                f"{os.path.join(tmp, 'img')}",
                "datasets.flickr30k.vis_processor.eval.image_size=224",
                f"run.output_dir={os.path.join(tmp, 'out')}"]
        log(f"  cli.evaluate {ZOO_CLI_YAML}: the yaml's "
            f"vis_processor.eval.image_size 384 set to 224 with --options "
            f"(the factory builds ViT-B/16 at 224 whatever the yaml says, "
            f"as the JAX package's does; a 384 image would meet its "
            f"197-token pos_embed)")
        stats, _, timer = run_phase(rec, "zoo_cli",
                                    lambda: run(parse_args(argv)))
    res = stats["eval_results"]["test"]
    log(f"  cli.evaluate blip_retrieval (k_test {ZOO_RUN['k_test']}, "
        f"{ZOO_CLI_IMAGES} images × {ZOO_CLI_IMAGES * ZOO_PER_IMAGE} "
        f"captions, the cut; seed {ZOO_SEED}; no masks: dense linears): "
        f"{rec['secs']['zoo_cli']:.2f} s, phases {json.dumps(timer.stats)}"
        f"; {json.dumps(res)}")
    if not {"txt_r1", "img_r1", "r_mean"} <= set(res):
        raise AssertionError(f"cli.evaluate zoo retrieval: {res}")
    return {"zoo_cli_s": rec["secs"]["zoo_cli"], "zoo_cli_metrics": res}


def zoo_direct(rec: dict) -> dict:
    """The other BLIP-1 heads at full width, each with the masks of
    ``zoo_masks_``: ``BlipVQA.rank_answers`` (ZOO_VQA questions ×
    candidates), ten greedy ``BlipCaption.decode_step`` calls at batch
    ZOO_DEC_B, a ``BlipNLVR`` forward and ``BlipClassification.predict``;
    outputs finite, of their shapes."""
    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
        batch_encode,
    )
    from vlm_compression_tpu_torch.models.factory import build_model

    g = torch.Generator(device="cuda").manual_seed(ZOO_SEED + 2)
    rng = random.Random(ZOO_SEED + 2)
    tok = SimpleTokenizer(30524)

    def ids(texts):
        i, m = batch_encode(tok, texts, ZOO_TXT)
        return (torch.from_numpy(i).cuda(), torch.from_numpy(m).cuda())

    def image(b):
        return torch.randn(b, 224, 224, 3, generator=g, device="cuda")

    q, c = ZOO_VQA
    out = {}
    for arch in ("blip_vqa", "blip_caption", "blip_nlvr",
                 "blip_classification"):
        node = dict(arch=arch)
        if arch == "blip_classification":
            node["num_classes"] = ZOO_N_CLASSES
        model = build_model(node, seed=ZOO_SEED)
        zoo_bf16_towers_(model)
        zoo_masks_(model)
        with torch.no_grad():
            if arch == "blip_vqa":
                img, (qi, qm) = image(q), ids(retrieval_captions(
                    q, rng, 4, ZOO_Q_WORDS))
                ci, cm = ids(retrieval_captions(c, rng, 1, ZOO_A_WORDS))
                got = run_phase(rec, "zoo_blip_vqa", lambda: model.rank_answers(
                    img, qi, qm, ci, cm))
                want = (q, c)
            elif arch == "blip_caption":
                emb = model.encode_image(image(ZOO_DEC_B))

                def greedy():
                    seq = torch.full((ZOO_DEC_B, 1), 2, dtype=torch.int64,
                                     device="cuda")
                    for _ in range(ZOO_DEC_STEPS):
                        logits = model.decode_step(emb, seq,
                                                   torch.ones_like(seq))
                        seq = torch.cat([seq, logits[:, -1].argmax(-1,
                                                                  True)], 1)
                    return seq

                got = run_phase(rec, "zoo_blip_caption", greedy)
                want = (ZOO_DEC_B, ZOO_DEC_STEPS + 1)
            elif arch == "blip_nlvr":
                ti, tm = ids(retrieval_captions(ZOO_SMALL_B, rng, 4,
                                                ZOO_SMALL_WORDS))
                a, b = image(ZOO_SMALL_B), image(ZOO_SMALL_B)
                got = run_phase(rec, "zoo_blip_nlvr", lambda: model(
                    a, b, ti, tm, labels=torch.zeros(
                        ZOO_SMALL_B, dtype=torch.int64, device="cuda")))
                want = (ZOO_SMALL_B, 2)
            else:
                ti, tm = ids(retrieval_captions(ZOO_SMALL_B, rng, 4,
                                                ZOO_SMALL_WORDS))
                a = image(ZOO_SMALL_B)
                got = run_phase(rec, "zoo_blip_classification",
                                lambda: model.predict(a, ti, tm))
                want = (ZOO_SMALL_B, ZOO_N_CLASSES)
        t = got["logits"] if isinstance(got, dict) else got
        if tuple(t.shape) != want or not bool(torch.isfinite(
                t.float()).all()):
            raise AssertionError(f"zoo {arch}: {tuple(t.shape)} vs {want}")
        phase = f"zoo_{arch}"
        out[f"{phase}_s"] = rec["secs"][phase]
        log(f"  {arch}: {rec['secs'][phase]:.3f} s, output "
            f"{tuple(t.shape)}, launches by route "
            f"{json.dumps(zoo_route_counts(rec['counts'][phase]))}")
        del model
        torch.cuda.empty_cache()
    return out


def zoo_path() -> tuple:
    """The zoo path (see ZOO_SEED's comment): the four retrieval families
    through ``RetrievalTask`` at k_test 128 (BLIP-1's pass profiled once
    more for the busy share), CLIP's text over 77 tokens, the other
    BLIP-1 heads and the CLI call.  Every launched shape was held in
    phase 3; rows 1 and 4 launched in each phase; no backward, no WMMA
    loop."""
    from torch.profiler import ProfilerActivity, profile

    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
        batch_encode,
    )
    from vlm_compression_tpu_torch.evaluation.retrieval_metrics import (
        itm_eval,
    )
    from vlm_compression_tpu_torch.models.factory import build_model
    from vlm_compression_tpu_torch.tasks.retrieval import RetrievalTask

    rec, out = new_record(), {}
    images, text = zoo_retrieval_set(ZOO_SEED)
    loader = RetrievalLoader(images, text, ZOO_PER_IMAGE,
                             ZOO_RUN["batch_size_eval"])
    n_img, n_txt = ZOO_IMAGES, ZOO_IMAGES * ZOO_PER_IMAGE
    full_img, full_txt = RET_FULL["flickr30k_test"]
    for arch in ZOO_FAMILIES:
        t0 = time.perf_counter()
        model = build_model(dict(arch=arch), seed=ZOO_SEED)
        zoo_bf16_towers_(model)
        clip = arch.endswith("clip")
        n_mask = zoo_masks_(model, ("visual.",) if arch == "eva_clip"
                            else ())
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        vocab = (model.cfg.text if clip else model.cfg.med).vocab_size
        task = RetrievalTask(k_test=ZOO_RUN["k_test"],
                             tokenizer=SimpleTokenizer(vocab))
        phase = f"zoo_{arch}"
        res = run_phase(rec, phase, lambda: task.evaluation(model, loader))
        zoo_fill_check(res, not clip, arch)
        metrics = itm_eval(res["score_i2t"], res["score_t2i"],
                           res["txt2img"], res["img2txt"])
        secs = rec["secs"][phase]
        # the rerank dominates: k_test ITM rows for each image and caption
        # at the full set, against this cut's (ITC alone for CLIP: linear
        # in the images and captions)
        k = ZOO_RUN["k_test"]
        scale = ((full_img + full_txt) / (n_img + n_txt) if clip else
                 (full_img * k + full_txt * k)
                 / (n_img * min(k, n_txt) + n_txt * min(k, n_img)))
        log(f"  {arch}: {n_params / 1e6:.1f} M params, {n_mask} masked "
            f"linears, built in {build_s:.1f} s; retrieval (k_test {k}, "
            f"{n_img} images × {n_txt} captions, the cut of Flickr30k's "
            f"{full_img} × {full_txt}): {secs:.3f} s, peak "
            f"{rec['peaks'][phase] / 2**30:.2f} GiB; extrapolated to "
            f"Flickr30k's test {secs * scale:.0f} s; "
            f"{json.dumps(metrics)}; launches by route "
            f"{json.dumps(zoo_route_counts(rec['counts'][phase]))}")
        out[f"{phase}_s"] = secs
        out[f"{phase}_flickr30k_s"] = secs * scale
        out[f"{phase}_metrics"] = metrics
        if arch == ZOO_PROFILED:
            n_cut = ZOO_CLI_IMAGES * ZOO_PER_IMAGE
            cut = RetrievalLoader(images[:ZOO_CLI_IMAGES], text[:n_cut],
                                  ZOO_PER_IMAGE, ZOO_RUN["batch_size_eval"])
            cut_res = run_phase(rec, f"{phase}_cut",
                                lambda: task.evaluation(model, cut))
            zoo_fill_check(cut_res, True, f"{arch} cut", ZOO_CLI_IMAGES)
            wall = rec["secs"][f"{phase}_cut"]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                task.evaluation(model, cut)
                torch.cuda.synchronize()
            dev_ms, _ = device_breakdown(
                prof, 1e3 * wall, f"zoo {arch} pass, {ZOO_CLI_IMAGES} × "
                f"{n_cut} (the cut of the profile)")
            out[f"{phase}_busy"] = dev_ms / (1e3 * wall)
            del prof
        if arch == "clip":
            ids, _ = batch_encode(SimpleTokenizer(vocab), retrieval_captions(
                CLIP_CTX_B, random.Random(ZOO_SEED), CLIP_CTX, CLIP_CTX + 8),
                CLIP_CTX)
            ids = torch.from_numpy(ids).cuda()
            with torch.no_grad():
                feats = run_phase(rec, "zoo_clip_ctx77",
                                  lambda: model.encode_text(ids))
            if tuple(feats.shape) != (CLIP_CTX_B, model.cfg.embed_dim) \
                    or not bool(torch.isfinite(feats).all()):
                raise AssertionError(f"clip encode_text: {feats.shape}")
            log(f"  clip encode_text over {CLIP_CTX} tokens, batch "
                f"{CLIP_CTX_B}: {rec['secs']['zoo_clip_ctx77']:.4f} s")
        del model, task
        gc.collect()
        torch.cuda.empty_cache()
    del images, loader
    out.update(zoo_direct(rec))
    gc.collect()
    torch.cuda.empty_cache()
    out.update(zoo_cli(rec))
    log(f"  launches: {json.dumps(rec['counts'])}")
    check_phase_counts(rec["counts"])
    check_shapes(rec["shapes"], "zoo path")
    out["zoo_launches_by_route"] = {
        p: zoo_route_counts(c) for p, c in rec["counts"].items()}
    return rec["counts"], out


def tiny_zoo_check():
    """Tiny float32 BLIP-1, ALBEF and CLIP retrieval models with random
    masks on every linear, on the card (kernels) vs on the CPU (plain
    versions): ``zoo_sim_matrix`` at k_test 0 and 3 over 6 images in
    batches of 4 and 2 and 12 captions: the sims within 1e-4, each
    rerank's picked entries (those off the −100.0 fill) the same."""
    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
        batch_encode,
    )
    from vlm_compression_tpu_torch.models.bridge import random_init_
    from vlm_compression_tpu_torch.models.factory import build_model
    from vlm_compression_tpu_torch.models.layers import SparseLinear
    from vlm_compression_tpu_torch.tasks.retrieval import zoo_sim_matrix

    for i, arch in enumerate(ZOO_TINY):
        cpu = random_init_(build_model(dict(arch=arch, tiny=True, amp=False),
                                       device="cpu"), seed=19 + i, std=0.2)
        g = torch.Generator().manual_seed(19 + i)
        for mod in cpu.modules():
            if isinstance(mod, SparseLinear):
                mod.mask = torch.rand(mod.kernel.shape, generator=g) < 0.6
        gpu = copy.deepcopy(cpu).to("cuda")
        images = torch.randn(6, 28, 28, 3, generator=g)
        ids, mask = batch_encode(SimpleTokenizer(64), retrieval_captions(
            12, random.Random(19 + i), 2, 9), 35)
        res, launched = {}, {}
        for side, model, dev in (("cpu", cpu, "cpu"), ("card", gpu, "cuda")):
            batches = [images[:4].to(dev), images[4:].to(dev)]
            reset_counts()
            res[side] = [zoo_sim_matrix(model, batches, ids, mask, k_test=k)
                         for k in (0, 3)]
            launched[side] = read_counts()
        err = max(float(abs(g_ - w).max()) for r_c, r_w in zip(
            res["card"], res["cpu"]) for g_, w in zip(r_c, r_w))
        same = all(((g_ == -100.0) == (w == -100.0)).all()
                   for g_, w in zip(res["card"][1], res["cpu"][1]))
        c = launched["card"]
        log(f"  tiny fp32 {arch} zoo_sim_matrix k_test 0 and 3, card vs "
            f"CPU: max_abs_err={err:.3e} (tol 1e-4); the reranked entries "
            f"the same {same}; masked_matmul launches {c['masked_matmul']}, "
            f"attention forwards {c['flash_attention']}")
        if not (err <= 1e-4 and same and c["masked_matmul"] > 0
                and c["flash_attention"] > 0):
            raise AssertionError(f"tiny zoo check {arch}")


def remat_check(model, batch, label: str) -> tuple:
    """One KD step without per-block remat, one with it (``set_remat_``)
    and one without again, each from the same LoRA factors with a fresh
    AdamW: the loss, CE, KL and every LoRA gradient bit-equal (the
    recompute re-enters the same kernels with the same plans and kv
    order); each step's seconds and peak memory.  The factors are restored and remat switched off after.
    Returns (the launches of both steps, their shapes, the numbers)."""
    from vlm_compression_tpu_torch.models.factory import set_remat_
    from vlm_compression_tpu_torch.tasks.retrain import (
        RessaTrainState,
        make_kd_train_step,
    )

    state = RessaTrainState.create(model, weight_decay=WEIGHT_DECAY)
    saved = {n: p.detach().clone() for n, p in state.lora.items()}
    runs = {}
    reset_counts()
    # plain, remat, plain: the two plain steps hold the step's run-to-run
    # determinism beside remat's
    for key, on in (("plain", False), ("remat", True), ("again", False)):
        set_remat_(model, on)
        with torch.no_grad():
            for n, p in state.lora.items():
                p.copy_(saved[n])
        state = RessaTrainState.create(model, weight_decay=WEIGHT_DECAY)
        step = make_kd_train_step(model, state.opt, KL_WEIGHT, T_KD)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        met = step(batch, 1e-6)
        torch.cuda.synchronize()
        runs[key] = dict(s=time.perf_counter() - t0,
                        peak=torch.cuda.max_memory_allocated(),
                        met={k: v.detach().clone() for k, v in met.items()},
                        grads={n: p.grad.detach().clone()
                               for n, p in state.lora.items()})
        state.opt.zero_grad(set_to_none=True)
    set_remat_(model, False)
    with torch.no_grad():
        for n, p in state.lora.items():
            p.copy_(saved[n])
    counts, shapes = read_counts(), read_shapes()
    off, on, again = runs["plain"], runs["remat"], runs["again"]

    def differ(a, b):
        met = [k for k in a["met"] if not torch.equal(a["met"][k],
                                                      b["met"][k])]
        grads = {n: int((a["grads"][n] != b["grads"][n]).sum())
                 for n in a["grads"]
                 if not torch.equal(a["grads"][n], b["grads"][n])}
        return met, grads

    diff_met, diff = differ(off, on)
    rerun_met, rerun = differ(off, again)
    bad = bool(diff or diff_met or rerun or rerun_met)
    log(f"  {label} KD step (batch {TRAIN_BS}) without remat: "
        f"{off['s']:.3f} s and again {again['s']:.3f} s, peak "
        f"{off['peak'] / 2**30:.2f} GiB; with remat (every EVA-ViT and "
        f"{label} block checkpointed): {on['s']:.3f} s, peak "
        f"{on['peak'] / 2**30:.2f} GiB; loss "
        f"{float(on['met']['loss']):.6f}; remat vs not: metrics that differ "
        f"{diff_met}, LoRA gradients that differ {len(diff)} of "
        f"{len(off['grads'])} ({sum(diff.values())} entries); the plain "
        f"step twice: {rerun_met}, {len(rerun)} "
        f"{'FAIL' if bad else 'ok'}")
    if bad:
        raise AssertionError(f"{label} remat: gradients differ "
                             f"{sorted(diff)[:4]} {diff_met}; plain twice "
                             f"{sorted(rerun)[:4]} {rerun_met}")
    del state, step, runs
    gc.collect()
    torch.cuda.empty_cache()
    return counts, shapes, {
        f"remat_{label}_plain_s": off["s"],
        f"remat_{label}_plain_again_s": again["s"],
        f"remat_{label}_s": on["s"],
        f"remat_{label}_plain_peak_bytes": off["peak"],
        f"remat_{label}_peak_bytes": on["peak"]}


def timing_zoo(worst) -> dict:
    """Rows 1 and 4 at the zoo's timed shapes (ZOO_MM_TIMED,
    ZOO_FLASH_TIMED): the kernel, the plain version, the library call
    (``torch.matmul(x, W*mask)``; SDPA on its fastest backend, in turns)
    and the bound, each a median of CUDA-event readings."""
    import torch.nn.functional as F

    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    rows = {}
    for name, m, k, n, dtype in zoo_mm_shapes():
        if name not in ZOO_MM_TIMED:
            continue
        x, w, mask = mm_inputs(m, k, n, dtype)
        wm = w * mask
        ms = device_ms(lambda: ML.masked_matmul(x, w, mask))
        plain = device_ms(lambda: ML.masked_matmul_ref(x, w, mask))
        lib = device_ms(lambda: torch.matmul(x, wm))
        bound, by = zoo_mm_bound_ms(m, k, n, dtype)
        loop = expected_loop(m, k, n, dtype)
        rows[("masked_matmul", name)] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
            bound_by=by, loop=loop, dtype=str(dtype)[6:], shape=[m, k, n],
            max_abs_err=worst[("masked_matmul", name, dtype)])
        log(f"  time masked_matmul {name:26s} {str(dtype)[6:]:8s} M={m} "
            f"K={k} N={n} {loop:6s}: kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, torch.matmul(x, W*mask) {lib:.4f} ms, bound {bound:.4f} "
            f"ms ({by})")
    bf16 = torch.bfloat16
    for name, b, n, m, h, d, kinds, scale, causal in zoo_flash_shapes():
        if name not in ZOO_FLASH_TIMED:
            continue
        q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, bf16)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k_, v))
        bsum = None
        for x in biases:
            bsum = x if bsum is None else bsum + x
        bsum = None if bsum is None else bsum.expand(b, h, n, m).to(bf16)
        lib = against_library(
            lambda: A.attention_core(q, k_, v, biases, scale, causal),
            sdpa_candidates(lambda be: pinned(
                be, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bsum, scale=scale,
                    is_causal=causal))))
        plain = device_ms(lambda: A.mha_reference(q, k_, v, biases, scale,
                                                  causal))
        bound, by = flash_bound_ms(q, k_, v, biases)
        if causal:      # the visible half of q·kᵀ and p·v
            bound, by = _bound(2.0 * b * h * n * (n + 1) * d,
                               (2 * q.numel() + k_.numel() + v.numel())
                               * q.element_size() + 4.0 * b * h * n)
        route = A.plan_forward(n, m, d)
        rows[("flash_attention", name)] = dict(
            ms=lib["kernel_ms"], plain_ms=plain,
            library_ms=lib["library_ms"],
            library_backend=lib["library_backend"], bound_ms=bound,
            bound_by=by, route=route, shape=[b, n, m, h, d],
            biases=kinds, causal=causal,
            max_abs_err=worst[("flash_attention", name, bf16)])
        log(f"  time flash_attention {name:22s} b={b} n={n} m={m} h={h} "
            f"d={d} causal={causal} ({route}): {lib['kernel_ms']:.4f} ms, "
            f"plain {plain:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"{library_note(lib)}")
    return rows


# ------------------------------------------------------------------ the
# rest of the legacy zoo: ALPRO over video, PNP-VQA, GPT dialogue and the
# zoo losses' gradients

LEG_SEED = 18
# ALPRO: msrvtt_ret_eval.yaml's task on a cut of 32 videos × 32 captions
# at k_test 32 (all of them; the yaml's 1000 is MSRVTT's whole 1k test)
ALPRO_VIDEOS, ALPRO_FRAMES = 32, 8
ALPRO_RUN = dict(task="retrieval", batch_size_eval=64, k_test=32)
ALPRO_FULL = (1000, 1000)                 # MSRVTT 1k-A: videos × captions
ALPRO_WORDS = (8, 30)
ALPRO_QA_B, ALPRO_QA_CLASSES = 8, 1500    # alpro_qa_msrvtt.yaml
ALPRO_CLI_YAML = "configs/projects/alpro/eval/msrvtt_ret_eval.yaml"
ALPRO_CLI_VIDEOS = 16                     # the CLI call's cut: 16 × 16
ALPRO_CLI_STACK = (10, 96, 128)           # frames × H × W of each .npy
# PNP-VQA: vqav2_eval.yaml's settings, num_captions cut from 100 to 5
PNP_Q, PNP_BATCH = 16, 16
PNP_RUN = dict(task="vqa_reading_comprehension", num_captions=5,
               cap_max_length=20, max_len=20, num_beams=1)
PNP_YAML_CAPTIONS = 100
# GPT dialogue: dialogue_avsd_eval.yaml's batch, three-turn dialogues, 32
# frames of i3d_flow ⊕ i3d_rgb ⊕ vggish features
GPT_B, GPT_FT_T = 16, 32
GPT_FEATS = (("i3d_flow", 2048), ("i3d_rgb", 2048), ("vggish", 128))
GPT_TOKENIZER_VOCAB = 50257               # GPT-2's; the 5 specials follow
GPT_CLI_YAML = "configs/projects/gpt/eval/dialogue_avsd_eval.yaml"
# the training half: one backward over all parameters of each
TRAIN_HALF = (("blip_pretrain", 8), ("albef_pretrain", 8), ("clip", 8),
              ("alpro_retrieval", 4), ("gpt_dialogue", 8),
              ("pnp_unifiedqav2_fid", 4))

LEG_FWD = ("masked_matmul", "flash_attention", FWD_WGMMA, WGMMA_LOOP)
LEG_TRAIN = LEG_FWD + (BWD_WGMMA,)
LEG_PHASES = ("alpro_retrieval", "alpro_qa", "alpro_cli", "pnp_vqarc",
              "gpt_dialogue", "gpt_cli") + tuple(
                  f"train_{a}" for a, _ in TRAIN_HALF)
PHASE_KERNELS.update(alpro_retrieval=LEG_FWD, alpro_qa=LEG_FWD,
                     alpro_cli=("flash_attention", FWD_WGMMA),
                     pnp_vqarc=LEG_FWD + (DECODE, BWD_WGMMA),
                     gpt_dialogue=LEG_FWD, gpt_cli=())
PHASE_KERNELS.update({f"train_{a}": LEG_TRAIN for a, _ in TRAIN_HALF})
PHASE_KERNELS["train_pnp_unifiedqav2_fid"] = LEG_TRAIN + (BWD_DBIAS,)
# no WMMA loop anywhere; no backward in the forward phases; no bias
# gradient but the FiD reader's position bias (the TMA + wgmma backward's
# output, never the separate kernel); the relevance pass's backward takes
# no bias gradient (the all-ones image bias is a constant)
for _phase in LEG_PHASES:
    PHASE_FORBIDDEN[_phase] = (WMMA_LOOP, "flash_attention_bwd_dbias") + (
        () if _phase == "train_pnp_unifiedqav2_fid" else (BWD_DBIAS,))
for _phase in ("alpro_retrieval", "alpro_qa", "alpro_cli", "gpt_dialogue",
               "gpt_cli"):
    PHASE_FORBIDDEN[_phase] = BACKWARD + (WMMA_LOOP,)


class CallRecorder:
    """Records the signature of every launch of rows 1 and 3-7 while
    active: the masked matmul by (M, K, N, dtype), the sparse-LoRA matmul
    by (M, K, N, rank, dtype); the attention forward
    and backward by (b, n, m, h, d, dtype, bias shapes, scale, causal)
    (and, backward, which gradients it returned), each with the phase that
    first launched it and its biases (a copy of the first call's), so
    that every shape a path ran is held against its plain version after."""

    def __init__(self):
        self.mm, self.fwd, self.bwd, self.lora = {}, {}, {}, {}
        # the fp32-output launches (a row-parallel shard's products)
        self.mm32, self.lora32 = {}, {}
        self.phase = None

    @contextlib.contextmanager
    def active(self):
        from vlm_compression_tpu_torch.ops import attention as A
        from vlm_compression_tpu_torch.ops import masked_linear as ML

        mm_cuda, fwd, bwd = (ML._masked_matmul_cuda, A.flash_attention,
                             A.flash_attention_backward)
        lora_cuda = ML._sparse_lora_cuda

        def mm_rec(x, w, mask, loop=None, out32=False):
            key = (x.numel() // x.shape[-1], w.shape[0], w.shape[1],
                   x.dtype)
            (self.mm32 if out32 else self.mm).setdefault(key, self.phase)
            return mm_cuda(x, w, mask, loop, out32=out32)

        def lora_rec(x, w, mask, a, b, scale, loop=None, out32=False):
            key = (x.numel() // x.shape[-1], w.shape[0], w.shape[1],
                   a.shape[1], x.dtype)
            (self.lora32 if out32 else self.lora).setdefault(key, self.phase)
            return lora_cuda(x, w, mask, a, b, scale, loop, out32=out32)

        def sig(q, k, biases, scale, causal):
            b, n, h, d = q.shape
            return (b, n, k.shape[1], h, d, q.dtype,
                    tuple(tuple(x.shape) for x in biases), float(scale),
                    bool(causal))

        def keep(biases):
            return [x.detach().clone() for x in biases]

        def fwd_rec(q, k, v, biases=(), scale=1.0, causal=False, **kw):
            key = sig(q, k, biases, scale, causal)
            if key not in self.fwd:
                self.fwd[key] = (self.phase, keep(biases))
            return fwd(q, k, v, biases, scale, causal, **kw)

        def bwd_rec(q, k, v, out, lse, g, biases=(), scale=1.0,
                    causal=False, need_dq=True, need_dkv=True, dbias_of=(),
                    **kw):
            key = sig(q, k, biases, scale, causal) + (
                bool(need_dq), bool(need_dkv), tuple(dbias_of))
            if key not in self.bwd:
                self.bwd[key] = (self.phase, keep(biases))
            return bwd(q, k, v, out, lse, g, biases, scale, causal,
                       need_dq=need_dq, need_dkv=need_dkv,
                       dbias_of=dbias_of, **kw)

        ML._masked_matmul_cuda, A.flash_attention = mm_rec, fwd_rec
        A.flash_attention_backward = bwd_rec
        ML._sparse_lora_cuda = lora_rec
        try:
            yield self
        finally:
            ML._masked_matmul_cuda, A.flash_attention = mm_cuda, fwd
            A.flash_attention_backward = bwd
            ML._sparse_lora_cuda = lora_cuda


LEG_CALLS = CallRecorder()


def leg_phase(rec: dict, phase: str, fn):
    """``run_phase`` with the recorder's phase set."""
    LEG_CALLS.phase = phase
    return run_phase(rec, phase, fn)


# each arch's towers (its linears stored in bf16 on the card)
LEG_TOWERS = {"alpro_retrieval": ("visual_encoder.", "text_encoder."),
              "alpro_qa": ("visual_encoder.", "text_encoder."),
              "pnp_vqa": ("itm.visual_encoder.", "itm.text_encoder.",
                          "cap.text_encoder."),
              "gpt_dialogue": ("h_",), "blip_pretrain": ZOO_TOWERS,
              "albef_pretrain": ZOO_TOWERS, "clip": ZOO_TOWERS}


def leg_model(arch: str, seed: int, **node):
    """A full-width zoo model from the factory, its towers' linears in
    bf16, a 50 % magnitude mask on every linear; (model, build seconds,
    parameters)."""
    from vlm_compression_tpu_torch.models.factory import build_model

    t0 = time.perf_counter()
    model = build_model(dict(node, arch=arch), seed=seed)
    zoo_bf16_towers_(model, LEG_TOWERS.get(arch, ()))
    zoo_masks_(model)
    torch.cuda.synchronize()
    return (model, time.perf_counter() - t0,
            sum(p.numel() for p in model.parameters()))


def bwd_routes(c: dict) -> dict:
    """A phase's attention-backward launches (rows 5-6) and bias gradients
    (row 7) by route."""
    return {"rows_5_6": {"wgmma": c[BWD_WGMMA],
                         "mma_dq": c["flash_attention_bwd_dq"],
                         "mma_dkv": c["flash_attention_bwd_dkv"]},
            "row_7": {"fused_outputs": c[BWD_DBIAS],
                      "separate_kernel": c["flash_attention_bwd_dbias"]}}


def alpro_cli(rec: dict) -> dict:
    """One ``cli.evaluate`` call on msrvtt_ret_eval.yaml over
    ALPRO_CLI_VIDEOS seeded uint8 ``.npy`` frame stacks (ALPRO_CLI_STACK,
    subsampled to 8 frames and resized to 224 by ``alpro_video_eval``),
    one caption each, k_test set to all of them (the cut)."""
    from vlm_compression_tpu_torch.cli.evaluate import parse_args, run
    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(LEG_SEED)
    text = retrieval_captions(ALPRO_CLI_VIDEOS, random.Random(LEG_SEED),
                              *ALPRO_WORDS)
    with tempfile.TemporaryDirectory(prefix="alpro_cli_") as tmp:
        os.makedirs(os.path.join(tmp, "vid"))
        anns = []
        for i in range(ALPRO_CLI_VIDEOS):
            np.save(os.path.join(tmp, "vid", f"{i}.npy"),
                    rng.integers(0, 256, ALPRO_CLI_STACK + (3,),
                                 dtype=np.uint8))
            anns.append({"video": f"{i}.npy", "caption": [text[i]]})
        ann = os.path.join(tmp, "test.json")
        with open(ann, "w") as f:
            json.dump(anns, f)
        argv = ["--cfg-path", os.path.join(root, ALPRO_CLI_YAML),
                "--job_id", "alpro", "--seed", str(LEG_SEED), "--options",
                f"datasets.msrvtt_retrieval.build_info.annotations.test="
                f"[{ann}]",
                "datasets.msrvtt_retrieval.build_info.images.storage="
                f"{os.path.join(tmp, 'vid')}",
                f"run.k_test={ALPRO_CLI_VIDEOS}",
                f"run.output_dir={os.path.join(tmp, 'out')}"]
        stats, _, timer = leg_phase(rec, "alpro_cli",
                                    lambda: run(parse_args(argv)))
    res = stats["eval_results"]["test"]
    log(f"  cli.evaluate {ALPRO_CLI_YAML} (k_test {ALPRO_CLI_VIDEOS}, "
        f"{ALPRO_CLI_VIDEOS} videos × {ALPRO_CLI_VIDEOS} captions, the cut; "
        f"seed {LEG_SEED}; no masks: dense linears): "
        f"{rec['secs']['alpro_cli']:.2f} s, phases "
        f"{json.dumps(timer.stats)}; {json.dumps(res)}")
    if not {"txt_r1", "img_r1", "r_mean"} <= set(res):
        raise AssertionError(f"cli.evaluate alpro retrieval: {res}")
    return {"alpro_cli_s": rec["secs"]["alpro_cli"],
            "alpro_cli_metrics": res}


def alpro_part(rec: dict, out: dict):
    """ALPRO retrieval through ``RetrievalTask`` (k_test 32 over 32 × 32,
    every score reranked), ``AlproQA`` at batch 8 directly, the CLI call;
    returns the retrieval model for the training half."""
    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
        batch_encode,
    )
    from vlm_compression_tpu_torch.evaluation.retrieval_metrics import (
        itm_eval,
    )
    from vlm_compression_tpu_torch.tasks.retrieval import RetrievalTask

    model, build_s, n_params = leg_model("alpro_retrieval", LEG_SEED)
    g = torch.Generator(device="cuda").manual_seed(LEG_SEED)
    px = model.cfg.timesformer.img_size
    videos = torch.randn(ALPRO_VIDEOS, ALPRO_FRAMES, px, px, 3,
                         generator=g, device="cuda")
    text = retrieval_captions(ALPRO_VIDEOS, random.Random(LEG_SEED),
                              *ALPRO_WORDS)
    tok = SimpleTokenizer(model.cfg.med.vocab_size)
    task = RetrievalTask(k_test=ALPRO_RUN["k_test"], tokenizer=tok)
    loader = RetrievalLoader(videos, text, 1, ALPRO_RUN["batch_size_eval"],
                             key="video")
    res = leg_phase(rec, "alpro_retrieval",
                    lambda: task.evaluation(model, loader))
    for key in ("score_i2t", "score_t2i"):
        s = res[key]
        if s.shape != (ALPRO_VIDEOS, ALPRO_VIDEOS) or not bool(
                (s == s).all()) or bool((s == -100.0).any()):
            raise AssertionError(f"alpro {key}: {s.shape}, every entry "
                                 f"reranked at k_test {ALPRO_RUN['k_test']}")
    metrics = itm_eval(res["score_i2t"], res["score_t2i"], res["txt2img"],
                       res["img2txt"])
    secs = rec["secs"]["alpro_retrieval"]
    k, (fv, ft) = ALPRO_RUN["k_test"], ALPRO_FULL
    # the VTM rerank dominates: k_test fusion rows for each video and each
    # caption at the full set (the yaml's k_test 1000: all of them)
    scale = (fv * min(1000, ft) + ft * min(1000, fv)) / (
        ALPRO_VIDEOS * min(k, ALPRO_VIDEOS) * 2)
    log(f"  alpro_retrieval: {n_params / 1e6:.1f} M params, built in "
        f"{build_s:.1f} s; retrieval (k_test {k}, {ALPRO_VIDEOS} videos of "
        f"{ALPRO_FRAMES} frames × {ALPRO_VIDEOS} captions, the cut of "
        f"MSRVTT's {fv} × {ft} at k_test 1000): {secs:.3f} s, peak "
        f"{rec['peaks']['alpro_retrieval'] / 2**30:.2f} GiB; extrapolated "
        f"{secs * scale:.0f} s; {json.dumps(metrics)}; launches by route "
        f"{json.dumps(zoo_route_counts(rec['counts']['alpro_retrieval']))}")
    out.update(alpro_retrieval_s=secs, alpro_retrieval_msrvtt_s=secs * scale,
               alpro_retrieval_metrics=metrics,
               alpro_retrieval_params=n_params)
    del videos, loader, task, res
    qa, build_s, n_params = leg_model("alpro_qa", LEG_SEED + 1,
                                      num_classes=ALPRO_QA_CLASSES)
    vid = torch.randn(ALPRO_QA_B, ALPRO_FRAMES, px, px, 3, generator=g,
                      device="cuda")
    ids, mask = batch_encode(tok, retrieval_captions(
        ALPRO_QA_B, random.Random(LEG_SEED + 1), 4, 12), 35)
    ids, mask = (torch.from_numpy(t).cuda() for t in (ids, mask))
    labels = torch.arange(ALPRO_QA_B, device="cuda") * 7 % ALPRO_QA_CLASSES
    with torch.no_grad():
        got = leg_phase(rec, "alpro_qa", lambda: qa(vid, ids, mask,
                                                    labels=labels))
    if tuple(got["logits"].shape) != (ALPRO_QA_B, ALPRO_QA_CLASSES) or \
            not bool(torch.isfinite(got["loss"])):
        raise AssertionError(f"alpro_qa: {tuple(got['logits'].shape)}")
    log(f"  alpro_qa ({n_params / 1e6:.1f} M params; {ALPRO_QA_CLASSES} "
        f"answers, {ALPRO_FRAMES} frames: the QA yamls' n_frms 16 meets "
        f"the 8 rows of time_embed, as in JAX) at batch {ALPRO_QA_B}: "
        f"{rec['secs']['alpro_qa']:.3f} s, loss {float(got['loss']):.4f}; "
        f"launches by route "
        f"{json.dumps(zoo_route_counts(rec['counts']['alpro_qa']))}")
    out["alpro_qa_s"] = rec["secs"]["alpro_qa"]
    del qa, vid, got
    gc.collect()
    torch.cuda.empty_cache()
    out.update(alpro_cli(rec))
    return model


def pnp_part(rec: dict, out: dict):
    """PNP-VQA base (BLIP-1 base ITM and captioner, the T5-XL reader)
    through ``VQARCTask`` on PNP_Q questions at batch PNP_BATCH; returns
    the model (its reader serves the training half)."""
    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
    )
    from vlm_compression_tpu_torch.tasks import setup_task

    model, build_s, n_params = leg_model("pnp_vqa", LEG_SEED + 2)
    g = torch.Generator(device="cuda").manual_seed(LEG_SEED + 2)
    rng = random.Random(LEG_SEED + 2)
    blip = model.cfg.blip
    med_vocab, px = blip.med.vocab_size, blip.vit.img_size
    task = setup_task({"run": PNP_RUN},
                      tokenizer=SimpleTokenizer(med_vocab))
    samples = {"image": torch.randn(PNP_Q, px, px, 3, generator=g,
                                    device="cuda"),
               "text_input": retrieval_captions(PNP_Q, rng, 4, 10),
               "question_id": list(range(PNP_Q)),
               "answers": [["yes", "no"]] * PNP_Q}
    result = leg_phase(rec, "pnp_vqarc",
                       lambda: task.valid_step(model, samples))
    cams, caps, answers = result[0]
    rel = torch.tensor([c["gradcam"] for c in cams])
    n_patch = model.cfg.blip.vit.num_patches
    if tuple(rel.shape) != (PNP_Q, n_patch) or not bool(
            torch.isfinite(rel).all()) or len(answers) != PNP_Q or any(
            len(c["caption"]) != PNP_RUN["num_captions"] for c in caps):
        raise AssertionError(f"pnp_vqarc: relevance {tuple(rel.shape)}")
    with tempfile.TemporaryDirectory(prefix="pnp_") as tmp:
        metrics = task.after_evaluation(result, split_name="val",
                                        result_dir=os.path.join(tmp, "r"))
    c = rec["counts"]["pnp_vqarc"]
    log(f"  pnp_vqa ({n_params / 1e6:.1f} M params, built in {build_s:.1f} "
        f"s; the questions tokenized in MED's vocabulary {med_vocab}: the "
        f"reader's {model.cfg.t5.vocab_size} overflows MED's) through "
        f"VQARCTask, "
        f"{PNP_Q} questions at batch {PNP_BATCH}, num_captions "
        f"{PNP_RUN['num_captions']} (the cut of the yaml's "
        f"{PNP_YAML_CAPTIONS}), cap_max_length {PNP_RUN['cap_max_length']}, "
        f"max_len {PNP_RUN['max_len']}: {rec['secs']['pnp_vqarc']:.3f} s, "
        f"peak {rec['peaks']['pnp_vqarc'] / 2**30:.2f} GiB; relevance "
        f"{tuple(rel.shape)}; answers {[a['answer'] for a in answers[:4]]}"
        f"…; metrics {json.dumps(metrics)}; launches by route "
        f"{json.dumps(zoo_route_counts(c))}; the relevance backward in "
        f"this serving pass: {json.dumps(bwd_routes(c))}")
    out.update(pnp_vqarc_s=rec["secs"]["pnp_vqarc"],
               pnp_relevance_shape=list(rel.shape),
               pnp_bwd_routes=bwd_routes(c), pnp_params=n_params)
    return model


def gpt_batch(n: int, seed: int, ft_root: str) -> dict:
    """``n`` seeded three-turn AVSD dialogues through the ``gpt_dialogue``
    processor, right-padded (ids and types 0, labels −1), and their
    i3d_flow ⊕ i3d_rgb ⊕ vggish features through ``gpt_video_ft`` from
    ``.npy`` files written under ``ft_root``."""
    import numpy as np

    from vlm_compression_tpu_torch.datasets.processors import (
        GPTDialogueProcessor,
        load_processor,
    )
    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
    )

    proc = GPTDialogueProcessor(
        max_turns=3, tokenizer=SimpleTokenizer(GPT_TOKENIZER_VOCAB))
    feats = load_processor("gpt_video_ft", {
        "visual_ft": [n for n, _ in GPT_FEATS[:2]],
        "audio_ft": [GPT_FEATS[2][0]]})
    rng = np.random.default_rng(seed)
    words = retrieval_captions(4 * n, random.Random(seed), 3, 9)
    seqs, fts = [], []
    for i in range(n):
        ann = {"caption": words[4 * i], "summary": words[4 * i + 1],
               "dialog": [{"question": words[(4 * i + t) % len(words)],
                           "answer": words[(4 * i + t + 1) % len(words)]}
                          for t in range(3)],
               "question": words[4 * i + 2], "answer": words[4 * i + 3]}
        seqs.append(proc(ann))
        for name, dim in GPT_FEATS:
            os.makedirs(os.path.join(ft_root, name), exist_ok=True)
            np.save(os.path.join(ft_root, name, f"v{i}.npy"),
                    rng.standard_normal((GPT_FT_T, dim)).astype(np.float32))
        fts.append(feats(ft_root, f"v{i}")["video_fts"])
    width = max(len(s["input_ids"]) for s in seqs)
    batch = {key: np.stack([np.pad(s[key], (0, width - len(s[key])),
                                   constant_values=fill) for s in seqs])
             for key, fill in (("input_ids", 0), ("token_type_ids", 0),
                               ("labels", -1))}
    batch["video_fts"] = np.stack(fts)
    return batch


def gpt_part(rec: dict, out: dict):
    """GPT dialogue base through ``DialogueTask`` at batch GPT_B, and the
    ``cli.evaluate`` call on dialogue_avsd_eval.yaml, which fails in the
    JAX package too (its processors do not fit the AVSD items)."""
    from vlm_compression_tpu_torch.cli.evaluate import parse_args, run
    from vlm_compression_tpu_torch.tasks.dialogue_rc import DialogueTask

    model, build_s, n_params = leg_model("gpt_dialogue", LEG_SEED + 3)
    with tempfile.TemporaryDirectory(prefix="avsd_") as tmp:
        batch = gpt_batch(GPT_B, LEG_SEED + 3, tmp)
    task = DialogueTask.setup_task({"run": {"max_len": 20}})
    with torch.no_grad():
        losses = leg_phase(rec, "gpt_dialogue",
                           lambda: task.valid_step(model, batch))
    metrics = task.after_evaluation(losses)
    if not math.isfinite(metrics["agg_metrics"]):
        raise AssertionError(f"gpt dialogue: {metrics}")
    log(f"  gpt_dialogue ({n_params / 1e6:.1f} M params, built in "
        f"{build_s:.1f} s) through DialogueTask at batch {GPT_B}: "
        f"{GPT_FT_T} feature rows of {sum(d for _, d in GPT_FEATS)} "
        f"(video_ff in fp32) before {batch['input_ids'].shape[1]} tokens of "
        f"three-turn dialogues; {rec['secs']['gpt_dialogue']:.3f} s, "
        f"metric {json.dumps(metrics)}; launches by route "
        f"{json.dumps(zoo_route_counts(rec['counts']['gpt_dialogue']))}")
    out.update(gpt_dialogue_s=rec["secs"]["gpt_dialogue"],
               gpt_dialogue_metric=metrics["agg_metrics"],
               gpt_params=n_params)
    root = os.path.dirname(os.path.abspath(__file__))
    import numpy as np

    with tempfile.TemporaryDirectory(prefix="avsd_cli_") as tmp:
        np.save(os.path.join(tmp, "v0.npy"),
                np.zeros((4, 32, 32, 3), np.uint8))
        ann = os.path.join(tmp, "test.json")
        with open(ann, "w") as f:
            json.dump([{"video": "v0.npy", "caption": "a", "question": "b",
                        "answer": "c", "dialog": []}], f)
        argv = ["--cfg-path", os.path.join(root, GPT_CLI_YAML), "--job_id",
                "avsd", "--seed", str(LEG_SEED), "--options",
                f"datasets.avsd_dialogue.build_info.annotations.test=[{ann}]",
                f"datasets.avsd_dialogue.build_info.images.storage={tmp}",
                "run.test_splits=[test]",
                f"run.output_dir={os.path.join(tmp, 'out')}"]

        def call():
            try:
                run(parse_args(argv))
            except TypeError as exc:
                return str(exc)
            return None

        why = leg_phase(rec, "gpt_cli", call)
    if not why or "vname" not in why:
        raise AssertionError(f"cli.evaluate on {GPT_CLI_YAML}: expected the "
                             f"JAX CLI's TypeError, got {why!r}")
    log(f"  cli.evaluate {GPT_CLI_YAML}: fails as the JAX CLI fails "
        f"(TypeError: {why}) — the gpt_video_ft processor takes (ft_root, "
        f"vname), the AVSD item passes it one frame; "
        f"{rec['secs']['gpt_cli']:.2f} s")
    return model


def train_batch(arch: str, b: int, model, g) -> dict:
    """Seeded inputs of each arch's loss at full width (captions of 30
    words, MED's and CLIP's vocabularies)."""
    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
        batch_encode,
    )

    rng = random.Random(LEG_SEED + 4)
    cfg = model.cfg
    vocab = (cfg.text.vocab_size if arch == "clip" else cfg.vocab_size
             if arch == "pnp_unifiedqav2_fid" else getattr(
                 cfg, "med", cfg).vocab_size)
    tower = getattr(cfg, "timesformer", None) or getattr(cfg, "vit", None)
    px = tower.img_size if tower is not None else 0
    width = min(35, getattr(getattr(cfg, "text", None), "context_length",
                            35))
    ids, mask = (torch.from_numpy(t).cuda() for t in batch_encode(
        SimpleTokenizer(vocab), retrieval_captions(b, rng, 10, 30), width))

    def image():
        return torch.randn(b, px, px, 3, generator=g, device="cuda")

    if arch == "blip_pretrain":
        return dict(image=image(), input_ids=ids, attention_mask=mask,
                    labels=torch.where(mask.bool(), ids, -100))
    if arch == "albef_pretrain":
        mlm = ids.clone()
        mlm[:, 3::5] = min(103, vocab - 1)      # BERT's [MASK]
        lbl = torch.where(mlm != ids, ids, -100)
        return dict(image=image(), input_ids=ids, attention_mask=mask,
                    mlm_input_ids=mlm, mlm_labels=lbl)
    if arch == "clip":
        return dict(image=image(), input_ids=ids)
    if arch == "alpro_retrieval":
        return dict(video=torch.randn(b, ALPRO_FRAMES, px, px, 3,
                                      generator=g, device="cuda"),
                    input_ids=ids, attention_mask=mask)
    if arch == "gpt_dialogue":
        with tempfile.TemporaryDirectory(prefix="avsd_train_") as tmp:
            return {k: torch.from_numpy(v).cuda()
                    for k, v in gpt_batch(b, LEG_SEED + 5, tmp).items()}
    # the FiD reader: 5 contexts of up to 64 tokens a question, T5 labels
    n_ctx = PNP_RUN["num_captions"]
    c_ids, c_mask = (torch.from_numpy(t).cuda() for t in batch_encode(
        SimpleTokenizer(vocab), retrieval_captions(b * n_ctx, rng, 20, 60),
        64))
    labels = torch.randint(4, vocab, (b, 4), generator=g, device="cuda")
    return dict(ctx_ids=c_ids.reshape(b, n_ctx, -1),
                ctx_mask=c_mask.reshape(b, n_ctx, -1), labels=labels)


def train_half(rec: dict, out: dict, built: dict):
    """One backward over all parameters of each TRAIN_HALF loss in masked
    mode (the models of the paths above where built: ALPRO retrieval, GPT
    dialogue, PNP-VQA's reader): a finite loss and finite gradients; the
    seconds, the peak memory and the backward's launches by route."""
    g = torch.Generator(device="cuda").manual_seed(LEG_SEED + 4)
    for i, (arch, b) in enumerate(TRAIN_HALF):
        model = built.get(arch)
        if model is None:
            model = leg_model(arch, LEG_SEED + 10 + i)[0]
        batch = train_batch(arch, b, model, g)
        model.zero_grad(set_to_none=True)

        def step():
            loss = model(**batch, mode="masked")["loss"]
            loss.backward()
            return loss

        phase = f"train_{arch}"
        loss = leg_phase(rec, phase, step)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        finite = bool(torch.isfinite(loss.detach())) and all(
            bool(torch.isfinite(x).all()) for x in grads)
        c = rec["counts"][phase]
        log(f"  {phase} (batch {b}, masked): loss {loss.item():.4f}, "
            f"{len(grads)} gradient leaves, finite {finite}; "
            f"{rec['secs'][phase]:.3f} s, peak "
            f"{rec['peaks'][phase] / 2**30:.2f} GiB; backward launches "
            f"{json.dumps(bwd_routes(c))}")
        if not finite or not grads:
            raise AssertionError(f"{phase}: loss {loss.item()}")
        out[f"{phase}_s"] = rec["secs"][phase]
        out[f"{phase}_peak_bytes"] = rec["peaks"][phase]
        out[f"{phase}_bwd_routes"] = bwd_routes(c)
        model.zero_grad(set_to_none=True)
        del batch, loss, grads
        if arch not in built:
            del model
        gc.collect()
        torch.cuda.empty_cache()


def leg_path() -> tuple:
    """The video, reading-comprehension and dialogue path and the training
    half (see LEG_SEED's comment), every launch of rows 1 and 4-7
    recorded by ``LEG_CALLS``; the phases' launch gates."""
    rec, out = new_record(), {}
    with LEG_CALLS.active():
        alpro = alpro_part(rec, out)
        gc.collect()
        torch.cuda.empty_cache()
        pnp = pnp_part(rec, out)
        gpt = gpt_part(rec, out)
        train_half(rec, out, {"alpro_retrieval": alpro, "gpt_dialogue": gpt,
                              "pnp_unifiedqav2_fid": pnp.reader})
    del alpro, pnp, gpt
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  launches: {json.dumps(rec['counts'])}")
    check_phase_counts(rec["counts"])
    out["leg_launches_by_route"] = {
        p: dict(zoo_route_counts(c), **bwd_routes(c))
        for p, c in rec["counts"].items()}
    out["leg_phase_s"] = dict(rec["secs"])
    return rec, out


def check_leg_kernels(rec: dict, worst, calls: CallRecorder = None,
                      prefix: str = "leg_") -> dict:
    """Rows 1 and 4-7 (and 3, the sparse-LoRA matmul, where ``calls``
    recorded it) at every signature the leg path (or the path ``calls``
    recorded) launched (recorded,
    so none is missed; the launch tallies cross-checked against them):
    each in its dtype on its planned route against the plain version
    (bf16 2e-2 × max(1, |plain|), fp32 1e-4), two identical calls
    bit-equal; the backward with the gradients it returned there (dq,
    dk / dv, the bias gradients) from a forward of the kernel.  Returns
    the names of the checked signatures (for the timing phase)."""
    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    calls = LEG_CALLS if calls is None else calls
    names = {"mm": {}, "fwd": {}, "bwd": {}, "lora": {}}
    n_checks = 0

    def held(what, name, err, scale, same, dtype, detail):
        nonlocal n_checks
        tol = TOL[str(dtype).split(".")[-1]] * scale
        ok = err <= tol and same
        log(f"  {what} {name:34s} {str(dtype)[6:]:8s} {detail} "
            f"max_abs_err={err:.3e} (tol {tol:.3e}), two calls bit-equal "
            f"{same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{what} {name} {dtype}")
        n_checks += 1

    for (m, k, n, dtype), phase in sorted(calls.mm.items(),
                                          key=lambda kv: str(kv)):
        name = f"{prefix}{phase}_M{m}_K{k}_N{n}"
        x, w, mask = mm_inputs(m, k, n, dtype)
        got = ML.masked_matmul(x, w, mask)
        err, scale = max_err(got, ML.masked_matmul_ref(x, w, mask))
        same = torch.equal(got, ML.masked_matmul(x, w, mask))
        held("masked_matmul", name, err, scale, same, dtype,
             f"M={m} K={k} N={n} {expected_loop(m, k, n, dtype):6s}")
        worst[("masked_matmul", name, dtype)] = err
        names["mm"][name] = (m, k, n, dtype, phase)
    for (m, k, n, r, dtype), phase in sorted(calls.lora.items(),
                                             key=lambda kv: str(kv)):
        name = f"{prefix}{phase}_M{m}_K{k}_N{n}_r{r}"
        x, w, mask, a, b = lora_inputs(m, k, n, r, dtype)
        s = LORA["lora_alpha"] / r
        got = ML.sparse_lora_matmul(x, w, mask, a, b, s)
        err, scale = max_err(got, ML.sparse_lora_matmul_ref(x, w, mask, a,
                                                            b, s))
        same = torch.equal(got, ML.sparse_lora_matmul(x, w, mask, a, b, s))
        held("sparse_lora_matmul", name, err, scale, same, dtype,
             f"M={m} K={k} N={n} r={r} "
             f"{expected_loop(m, k, n, dtype, rank=r):6s}")
        worst[("sparse_lora_matmul", name, dtype)] = err
        names["lora"][name] = (m, k, n, r, dtype, phase)
    # the fp32-output launches: the same kernel's sums before its one
    # rounding, so rounded they equal its bf16 output bit for bit, and they
    # hold more than bf16 keeps
    f32 = torch.float32
    for kind, sigs in (("mm", calls.mm32), ("lora", calls.lora32)):
        for key, phase in sorted(sigs.items(), key=lambda kv: str(kv)):
            m, k, n = key[:3]
            dtype = key[-1]
            if kind == "mm":
                name = f"{prefix}{phase}_M{m}_K{k}_N{n}_out32"
                x, w, mask = mm_inputs(m, k, n, dtype)

                def call(**kw):
                    return ML.masked_matmul(x, w, mask, **kw)
                ref = ML.masked_matmul_ref(x, w, mask, f32)
                what, detail = "masked_matmul", f"M={m} K={k} N={n}"
            else:
                r = key[3]
                name = f"{prefix}{phase}_M{m}_K{k}_N{n}_r{r}_out32"
                x, w, mask, a, b = lora_inputs(m, k, n, r, dtype)
                s = LORA["lora_alpha"] / r

                def call(**kw):
                    return ML.sparse_lora_matmul(x, w, mask, a, b, s, **kw)
                ref = ML.sparse_lora_matmul_ref(x, w, mask, a, b, s, f32)
                what, detail = ("sparse_lora_matmul",
                                f"M={m} K={k} N={n} r={r}")
            got = call(out_dtype=f32)
            err, scale = max_err(got, ref)
            once = torch.equal(got.to(dtype), call())
            finer = bool((got != got.to(dtype).float()).any())
            same = torch.equal(got, call(out_dtype=f32))
            held(what, name, err, scale, same and once and finer, dtype,
                 f"{detail} fp32 out, rounded equal to the bf16 output "
                 f"{once}, finer than bf16 {finer}")
            worst[(what, name, dtype)] = err
    for key, (phase, biases) in calls.fwd.items():
        b, n, m, h, d, dtype, shapes, scale, causal = key
        name = f"{prefix}{phase}_b{b}_n{n}_m{m}" + ("_causal" if causal
                                                    else "")
        q, k_, v, _ = flash_inputs(b, n, m, h, d, [], dtype)
        want = A.mha_reference(q, k_, v, biases, scale, causal)
        got, lse = A.flash_attention(q, k_, v, biases, scale, causal)
        err, s = max_err(got, want)
        got2, lse2 = A.flash_attention(q, k_, v, biases, scale, causal)
        same = torch.equal(got, got2) and torch.equal(lse, lse2)
        held("flash_attention", name, err, s, same, dtype,
             f"{A.plan_forward(n, m, d, bf16=dtype == torch.bfloat16):5s} "
             f"b={b} n={n} m={m} h={h} d={d} biases={list(shapes)}")
        worst[("flash_attention", name, dtype)] = err
        names["fwd"][name] = key
    for key, (phase, biases) in calls.bwd.items():
        b, n, m, h, d, dtype, shapes, scale, causal, dq_, dkv_, dbias_of = key
        name = (f"{prefix}{phase}_b{b}_n{n}_m{m}"
                + ("_causal" if causal else "")
                + ("_dbias" if dbias_of else ""))
        q, k_, v, _ = flash_inputs(b, n, m, h, d, [], dtype)
        g = grad_like(q)
        o, lse = A.flash_attention(q, k_, v, biases, scale, causal)
        args = (q, k_, v, o, lse, g, biases, scale, causal)
        kw = dict(need_dq=dq_, need_dkv=dkv_, dbias_of=dbias_of)
        got = A.flash_attention_backward(*args, **kw)
        again = A.flash_attention_backward(*args, **kw)
        want = A.flash_attention_backward_ref(*args, dbias_of=dbias_of)
        err, s, same = 0.0, 1.0, True
        for gi, ai, wi in zip(got, again, want):
            if gi is None:
                continue
            e, sc = max_err(gi, wi)
            err, s = max(err, e), max(s, sc)
            same = same and torch.equal(gi, ai)
        held("flash_attention_backward", name, err, s, same, dtype,
             f"{A.plan(n, m, d, bf16=dtype == torch.bfloat16):5s} b={b} "
             f"n={n} m={m} h={h} d={d} biases={list(shapes)} dq={dq_} "
             f"dk/dv={dkv_} dbias_of={list(dbias_of)}")
        worst[("flash_attention_backward", name, dtype)] = err
        names["bwd"][name] = key
    # every launch the tallies counted is one the recorder saw
    seen_mm = {(m, k, n) for m, k, n, _ in (*calls.mm, *calls.mm32)} | {
        (m, k, n) for m, k, n, _, _ in (*calls.lora, *calls.lora32)}
    seen_fl = {c[:5] for c in calls.fwd}
    seen_bwd = {c[:5] for c in calls.bwd}
    missing = []
    for s in rec["shapes"].values():
        missing += [("matmul", m, k, n) for m, n, k, _ in s["matmul"]
                    if (m, k, n) not in seen_mm]
        missing += [("attention", *c[:5]) for c in s["attention"]
                    if c[:5] not in seen_fl]
        missing += [("attention backward", *c[:5])
                    for c in s["attention_bwd"] if c[:5] not in seen_bwd]
    log(f"  the path's signatures: {len(calls.mm)} masked-matmul, "
        f"{len(calls.lora)} sparse-LoRA, {len(calls.mm32)} and "
        f"{len(calls.lora32)} of them with fp32 output, "
        f"{len(calls.fwd)} attention-forward and {len(calls.bwd)} "
        f"attention-backward, {n_checks} checks; launches the recorder "
        f"missed: {missing[:6]}")
    if missing:
        raise AssertionError(f"{prefix or 'parallel '}path: launches not "
                             f"recorded {missing}")
    return names


def tiny_leg_check():
    """Tiny float32 ALPRO retrieval, PNP-VQA and GPT dialogue with random
    masks on every linear, on the card (kernels) vs the CPU (plain
    versions): ALPRO's loss and ``zoo_sim_matrix`` at k_test 0 and 3 over
    6 videos (the reranked entries the same); PNP-VQA's relevance, caption
    logits and reader loss (the relevance a backward through the card's
    kernels); GPT dialogue's logits and loss with the video prefix; all
    within 1e-4."""
    from vlm_compression_tpu_torch.datasets.tokenization import (
        SimpleTokenizer,
        batch_encode,
    )
    from vlm_compression_tpu_torch.models.bridge import random_init_
    from vlm_compression_tpu_torch.models.factory import build_model
    from vlm_compression_tpu_torch.models.layers import SparseLinear
    from vlm_compression_tpu_torch.tasks.retrieval import zoo_sim_matrix

    def pair(arch, seed):
        cpu = random_init_(build_model(dict(arch=arch, tiny=True, amp=False),
                                       device="cpu"), seed=seed, std=0.2)
        g = torch.Generator().manual_seed(seed)
        for mod in cpu.modules():
            if isinstance(mod, SparseLinear):
                mod.mask = torch.rand(mod.kernel.shape, generator=g) < 0.6
        return cpu, copy.deepcopy(cpu).to("cuda"), g

    def compare(label, fn, cpu, gpu):
        reset_counts()
        want = fn(cpu, "cpu")
        got = fn(gpu, "cuda")
        c = read_counts()
        err = max(float((a.float().cpu() - b.float()).abs().max())
                  for a, b in zip(got, want))
        log(f"  tiny fp32 {label}, card vs CPU: max_abs_err={err:.3e} (tol "
            f"1e-4); launches masked_matmul {c['masked_matmul']}, attention "
            f"forwards {c['flash_attention']}, backwards {c[BWD_WGMMA]} + "
            f"{c['flash_attention_bwd_dq']} + {c['flash_attention_bwd_dkv']}")
        if not (err <= 1e-4 and c["masked_matmul"] > 0
                and c["flash_attention"] > 0):
            raise AssertionError(f"tiny leg check {label}")
        return got, want

    tok = SimpleTokenizer(64)
    ids, mask = (torch.from_numpy(t) for t in batch_encode(
        tok, retrieval_captions(12, random.Random(31), 2, 9), 35))
    cpu, gpu, g = pair("alpro_retrieval", 31)
    vids = torch.randn(6, 2, 28, 28, 3, generator=g)

    def alpro(model, dev):
        batches = [vids[:4].to(dev), vids[4:].to(dev)]
        sims = [s for k in (0, 3) for s in zoo_sim_matrix(
            model, batches, ids, mask, k_test=k)]
        with torch.no_grad():
            loss = model(vids[:4].to(dev), ids[:4].to(dev),
                         mask[:4].to(dev))["loss"]
        return [torch.as_tensor(s) for s in sims] + [loss[None]]

    got, want = compare("alpro_retrieval zoo_sim_matrix k_test 0, 3 and "
                        "the loss", alpro, cpu, gpu)
    if not all(bool(((a == -100.0) == (b == -100.0)).all())
               for a, b in zip(got[2:4], want[2:4])):
        raise AssertionError("tiny alpro: the reranked entries differ")
    cpu, gpu, g = pair("pnp_vqa", 32)
    img = torch.randn(3, 28, 28, 3, generator=g)
    ctx = torch.randint(4, 96, (3, 2, 6), generator=g)

    def pnp(model, dev):
        with torch.no_grad():
            o = model(img.to(dev), ids[:3].to(dev), mask[:3].to(dev),
                      cap_ids=ids[3:6, :5].to(dev), ctx_ids=ctx.to(dev),
                      ctx_mask=torch.ones_like(ctx).to(dev),
                      labels=ctx[:, 0, :4].to(dev))
        return [o["relevance"], o["caption_logits"], o["loss"][None]]

    compare("pnp_vqa relevance, caption logits, reader loss", pnp, cpu, gpu)
    cpu, gpu, g = pair("gpt_dialogue", 33)
    tok_ids = torch.randint(1, 64, (3, 9), generator=g)
    fts = torch.randn(3, 4, 8, generator=g)

    def gpt(model, dev):
        with torch.no_grad():
            o = model(tok_ids.to(dev), video_fts=fts.to(dev),
                      labels=tok_ids.to(dev))
        return [o["logits"], o["loss"][None]]

    compare("gpt_dialogue logits and loss with video", gpt, cpu, gpu)


# timed for the kernel line at the leg path's shapes (picked from the
# recorded signatures by what each stands for)
def leg_timed(names: dict) -> dict:
    """{row: (kind, name)} of the signatures timed: row 1, TimeSformer's
    largest product and GPT's float32 video_ff (K = 4224); row 4, the
    temporal (n = m = 8) and spatial (n = m = 197) attention, GPT's causal
    trunk and the FiD reader's cross-attention over the contexts; rows
    5-6, the PNP relevance backward and ALPRO's temporal backward; row 7,
    the FiD reader's backward with its position bias's gradient."""
    def pick(kind, pred, size):
        cands = [(n, k) for n, k in names[kind].items() if pred(n, k)]
        return max(cands, key=lambda nk: size(nk[1]))[0] if cands else None

    mm_size = lambda k: k[0] * k[1] * k[2]  # noqa: E731
    at_size = lambda k: k[0] * k[1] * k[2]  # noqa: E731
    out = {
        "timesformer_linear": ("mm", pick(
            "mm", lambda n, k: k[4] == "alpro_retrieval"
            and k[3] == torch.bfloat16, mm_size)),
        "gpt_video_ff": ("mm", pick(
            "mm", lambda n, k: k[1] == sum(d for _, d in GPT_FEATS)
            and k[3] == torch.float32,
            mm_size)),
        "temporal": ("fwd", pick(
            "fwd", lambda n, k: k[1] == k[2] == ALPRO_FRAMES
            and "alpro_retrieval" in n, at_size)),
        "spatial": ("fwd", pick(
            "fwd", lambda n, k: k[1] == k[2] == ZOO_PATCHES
            and "alpro_retrieval" in n, at_size)),
        "gpt_causal": ("fwd", pick(
            "fwd", lambda n, k: k[8] and "gpt_dialogue" in n, at_size)),
        "fid_cross": ("fwd", pick(
            "fwd", lambda n, k: "pnp_vqarc" in n and k[2] > 64 and k[4] == 64
            and k[3] == 32, at_size)),
        "pnp_relevance_bwd": ("bwd", pick(
            "bwd", lambda n, k: "pnp_vqarc" in n, at_size)),
        "temporal_bwd": ("bwd", pick(
            "bwd", lambda n, k: "train_alpro" in n
            and k[1] == k[2] == ALPRO_FRAMES, at_size)),
        "fid_dbias": ("bwd", pick(
            "bwd", lambda n, k: bool(k[11]), at_size))}
    return {row: v for row, v in out.items() if v[1] is not None}


def timing_leg(names: dict, worst, calls: CallRecorder = None,
               timed=None) -> dict:
    """The leg path's timed signatures (``leg_timed``; or ``timed`` of the
    path ``calls`` recorded): the kernel, the plain version, the library
    call (``torch.matmul`` of the pre-masked weight, of the merged one for
    the sparse-LoRA matmul; SDPA on its fastest backend, in turns; SDPA's
    backward, with a mask gradient for row 7) and the bound, each a median
    of CUDA-event readings."""
    import torch.nn.functional as F

    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    calls = LEG_CALLS if calls is None else calls
    rows = {}
    for label, (kind, name) in (timed or leg_timed)(names).items():
        key = names[kind][name]
        if kind == "lora":
            m, k, n, r, dtype, _ = key
            x, w, mask, a, b = lora_inputs(m, k, n, r, dtype)
            s = LORA["lora_alpha"] / r
            merged_w = ML.merge_sparse_lora(w, mask, a, b, s)
            ms = device_ms(lambda: ML.sparse_lora_matmul(x, w, mask, a, b,
                                                         s))
            plain = device_ms(lambda: ML.sparse_lora_matmul_ref(
                x, w, mask, a, b, s))
            lib = device_ms(lambda: torch.matmul(x, merged_w))
            bound, by = lora_bound_ms(m, k, n, r)
            rows[label] = dict(kernel="sparse_lora_matmul", signature=name,
                               ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=bound, bound_by=by,
                               loop=expected_loop(m, k, n, dtype, rank=r),
                               dtype=str(dtype)[6:], shape=[m, k, n, r],
                               max_abs_err=worst[("sparse_lora_matmul", name,
                                                  dtype)])
            log(f"  time {label} sparse_lora_matmul {name} M={m} K={k} "
                f"N={n} r={r}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"torch.matmul(x, merged W) {lib:.4f} ms, bound "
                f"{bound:.4f} ms ({by})")
            continue
        if kind == "mm":
            m, k, n, dtype, _ = key
            x, w, mask = mm_inputs(m, k, n, dtype)
            wm = w * mask
            ms = device_ms(lambda: ML.masked_matmul(x, w, mask))
            plain = device_ms(lambda: ML.masked_matmul_ref(x, w, mask))
            lib = device_ms(lambda: torch.matmul(x, wm))
            bound, by = zoo_mm_bound_ms(m, k, n, dtype)
            rows[label] = dict(kernel="masked_matmul", signature=name,
                               ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=bound, bound_by=by,
                               loop=expected_loop(m, k, n, dtype),
                               dtype=str(dtype)[6:], shape=[m, k, n],
                               max_abs_err=worst[("masked_matmul", name,
                                                  dtype)])
            log(f"  time {label} masked_matmul {name} M={m} K={k} N={n} "
                f"{str(dtype)[6:]}: kernel {ms:.4f} ms, plain {plain:.4f} "
                f"ms, torch.matmul(x, W*mask) {lib:.4f} ms, bound "
                f"{bound:.4f} ms ({by})")
            continue
        b, n, m, h, d, dtype, shapes, scale, causal = key[:9]
        biases = (calls.fwd if kind == "fwd" else calls.bwd)[key][1]
        q, k_, v, _ = flash_inputs(b, n, m, h, d, [], dtype)
        bsum = None
        for x in biases:
            bsum = x if bsum is None else bsum + x
        if kind == "fwd":
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k_, v))
            mask_ = None if bsum is None else bsum.expand(b, h, n, m).to(
                dtype)
            lib = against_library(
                lambda: A.flash_attention(q, k_, v, biases, scale, causal),
                sdpa_candidates(lambda be: pinned(
                    be, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask_, scale=scale,
                        is_causal=causal))))
            plain = device_ms(lambda: A.mha_reference(q, k_, v, biases,
                                                      scale, causal))
            bound, by = flash_bound_ms(q, k_, v, biases)
            kernel, route = "flash_attention", A.plan_forward(n, m, d)
            err = worst[("flash_attention", name, dtype)]
        else:
            dq_, dkv_, dbias_of = key[9:]
            g = grad_like(q)
            o, lse = A.flash_attention(q, k_, v, biases, scale, causal)
            args = (q, k_, v, o, lse, g, biases, scale, causal)
            lib = against_library(
                lambda: A.flash_attention_backward(
                    *args, need_dq=dq_, need_dkv=dkv_, dbias_of=dbias_of),
                sdpa_candidates(lambda be: sdpa_backward(
                    be, q, k_, v, biases, g, scale,
                    mask_grad=bool(dbias_of))))
            plain = device_ms(lambda: A.flash_attention_backward_ref(
                *args, dbias_of=dbias_of))
            bound, by = flash_bwd_bound_ms(q, k_, v, biases, dbias_of)
            kernel = ("flash_attention_bwd_dbias" if dbias_of
                      else "flash_attention_bwd")
            route = A.plan(n, m, d)
            err = worst[("flash_attention_backward", name, dtype)]
        rows[label] = dict(kernel=kernel, signature=name,
                           ms=lib["kernel_ms"], plain_ms=plain,
                           library_ms=lib["library_ms"],
                           library_backend=lib["library_backend"],
                           bound_ms=bound, bound_by=by, route=route,
                           shape=[b, n, m, h, d], biases=list(shapes),
                           causal=causal, max_abs_err=err)
        log(f"  time {label} {kernel} {name} b={b} n={n} m={m} h={h} d={d} "
            f"causal={causal} ({route}): {lib['kernel_ms']:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bound:.4f} ms ({by}); "
            f"{library_note(lib)}")
    return rows



# ---------------------------------------------------------------------------
# The parallel path: tensor-, data- and pipeline-parallel ranks
# (``vlm_compression_tpu_torch/parallel``) sharing the one card, each phase
# held against the same work in one process
# ---------------------------------------------------------------------------
PAR_SEED = 28
PAR_WORLD = 2
# NCCL refuses two ranks on one device (scripts/torch_parallel_probe.py):
# the two-rank phases run on gloo with CUDA tensors (the pipeline's hops
# staged through the host); a world of 1 runs on NCCL in this process
PAR_BACKEND = "gloo"
PAR_TIMEOUT = 900.0           # each collective, and the wait for the ranks
PAR_ATTN = dict(b=16, n=72, h=32, d=64)   # T5-XL's encoder self-attention
PAR_PIPE = dict(blocks=8, stages=2, micro=4, batch=8, seq=72)
PAR_LR = SCHED["init_lr"]
# the parallel path's prunes calibrate on 8 samples, not 128 (the cut:
# gloo moves the TP = 2 sweep's activations through the host: 127 s at
# 128, 27 s at 32, 19 s at 16)
PAR_CALIB = 8
PAR_BLOCK_B = 8              # the block checks' batch
# a LoRA gradient entry counts as decided where it is above this share of
# its leaf's largest: below it, bf16 rounding may flip its sign, and Adam's
# first step moves a flipped entry by 2·lr
PAR_BIG = 2e-2
PAR_MAX_TIES = 4              # flipped metric ties a linear may hold
PAR_TIE = 1e-5                # a tie: the flipped values' spread over the max
PAR_DENSITY = 0.01
PAR_CALLS = CallRecorder()
PAR_PHASES = ("par_prune_tp", "par_prune_dp", "par_kd_tp", "par_kd_dp",
              "par_blocks_tp", "par_blocks_dp", "par_blocks_tp_bf16",
              "par_generate_tp", "par_attention_heads",
              "par_attention_batch", "par_pipeline")
PAR_REFS = ("par_prune_ref", "par_prune_ctrl", "par_kd_ref", "par_kd_ctrl",
            "par_generate_ref")
# the Wanda control's two calibration batches: unequal, so that the
# engine does not fuse them and every block runs at other row counts
PAR_CTRL_SPLIT = 3
PHASE_KERNELS.update({
    "par_prune_ref": PRUNE, "par_prune_ctrl": PRUNE, "par_prune_tp": PRUNE,
    "par_prune_dp": PRUNE,
    "par_kd_ref": ("sparse_lora_matmul", "flash_attention", BWD_WGMMA),
    "par_kd_ctrl": ("sparse_lora_matmul", "flash_attention", BWD_WGMMA),
    "par_kd_tp": ("sparse_lora_matmul", "flash_attention", BWD_WGMMA),
    "par_kd_dp": ("sparse_lora_matmul", "flash_attention", BWD_WGMMA),
    "par_blocks_tp": ("sparse_lora_matmul", "flash_attention",
                      "flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
    "par_blocks_dp": ("sparse_lora_matmul", "flash_attention",
                      "flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
    "par_blocks_tp_bf16": ("sparse_lora_matmul", "flash_attention",
                           BWD_WGMMA),
    "par_generate_ref": SERVE, "par_generate_tp": SERVE,
    "par_attention_heads": ("flash_attention", BWD_WGMMA, BWD_DBIAS),
    "par_attention_batch": ("flash_attention", BWD_WGMMA, BWD_DBIAS),
    "par_pipeline": ("flash_attention", BWD_WGMMA)})
for _phase in ("par_kd_ref", "par_kd_ctrl", "par_kd_tp", "par_kd_dp",
               "par_generate_ref", "par_generate_tp", "par_pipeline"):
    PHASE_FORBIDDEN[_phase] = (WMMA_LOOP,)


def par_prune_checks(model, ref_masks, ref_sink: dict, own: dict,
                     kernels: dict = None) -> dict:
    """A Wanda prune's masks, linear by linear, on whole kernels
    (``kernels``: {linear name: whole kernel}, where the model's are
    sharded; the model's own otherwise):
    - against the one-process mask function (``wanda_mask_fn``: the ViT's
      flat threshold, the T5 stacks' per-unit top-k) on the whole kernel
      and the run's own statistics (``own``: summed over data, gathered
      over model): the flipped bits, 0 expected (the unit split and the
      gathers decide nothing);
    - the first linear's statistic (the ViT block 0 qkv's, whose input is
      the stem's on every rank) against one process's (``ref_sink``);
    - with ``ref_masks`` (the one-process prune's, on the host), the
      flipped bits and,
      per unit, whether its flipped entries are metric ties (the Wanda
      metric of the one-process statistics spread over at most PAR_TIE of
      their largest);
    - the three towers' densities."""
    import types

    from vlm_compression_tpu_torch.compression.pruners.methods import (
        wanda_mask_fn,
    )
    from vlm_compression_tpu_torch.models.layers import SparseLinear, whole

    fns = {flat: wanda_mask_fn(flat_threshold=flat) for flat in (False,
                                                                 True)}
    own_flips, worst, flips, non_ties, linears, dens = 0, 0, 0, 0, 0, {}
    with torch.no_grad():
        for name, m in model.named_modules():
            if not isinstance(m, SparseLinear) or m.mask is None:
                continue
            linears += 1
            key = name.replace(".", "/")
            kern = whole(m, "kernel") if kernels is None else kernels[name]
            got = m.mask
            tower = name.split(".blocks_")[0]
            kept, total = dens.get(tower, (0, 0))
            dens[tower] = (kept + int(got.sum()), total + got.numel())
            scaler, sp = own[key]
            want = fns[name.startswith("visual_encoder")](
                kernels={0: kern}, stats={0: types.SimpleNamespace(
                    scaler_row=scaler.to(kern.device))},
                sparsities={0: sp}).masks[0]
            own_flips += int((want != got).sum())
            if ref_masks is None:
                continue
            diff = got != ref_masks[name].to(got.device)
            k = int(diff.sum())
            if not k:
                continue
            flips += k
            worst = max(worst, k)
            i, j = diff.nonzero(as_tuple=True)
            metric = kern[i, j].float().abs() * torch.sqrt(
                ref_sink[key][0].to(kern.device)[i])
            units = got.shape[1]
            hi = torch.full((units,), -float("inf"), device=metric.device
                            ).scatter_reduce(0, j, metric, "amax")
            lo = torch.full((units,), float("inf"), device=metric.device
                            ).scatter_reduce(0, j, metric, "amin")
            hit = torch.zeros(units, dtype=torch.bool, device=metric.device)
            hit[j] = True
            non_ties += int(((hi - lo) > PAR_TIE * hi)[hit].sum())
    first = "visual_encoder/blocks_0/attn/qkv"
    a, b = own[first][0].double(), ref_sink.get(first, own[first])[0].double()
    return dict(linears=linears, own_stats_flips=own_flips,
                first_stat_rel=float((a - b).abs().max() / b.abs().max()),
                flips=flips, worst=worst, non_tie_units=non_ties,
                density={t: kept / total for t, (kept, total) in dens.items()})


def par_block_checks(model, mesh, key: str, phase, ref=None,
                     dt=torch.float32) -> tuple:
    """Block 0 of the ViT, the Q-Former and both T5 stacks at full width
    (batch PAR_BLOCK_B, the main path's lengths), in float32 (bf16
    weights are exact in float32; ``dt`` bfloat16: as they are),
    sparse-LoRA mode with lora_b drawn non-zero (seeded: the same on every
    call), forward and backward of Σ y ⊙ g over ``mesh`` — TP = 2 (the
    model sharded by the caller) or DP = 2 (the batch cut here) — with the
    LoRA gradients reduced as the KD step reduces them, against one
    process on the same inputs (``ref``; computed here, on the whole
    model, when None; with ``mesh`` None only that).  Float32 (each
    parameter back to its own dtype after): a fault in the split shows
    far above the float32 tolerance.  In bf16 the gate holds that a
    row-parallel output is rounded once (its partials summed in fp32):
    rounded twice, TP = 2 reached 1.09 of the bf16 tolerance on T5's
    cross-attention key B on one H100.  Returns ({key: the worst output
    and LoRA-gradient error over the tolerance, 1e-4 (bf16 2e-2) ×
    max(1, |x|), a leaf's largest for a gradient}, ref)."""
    from vlm_compression_tpu_torch.models.layers import lora_linears
    from vlm_compression_tpu_torch.models.t5 import causal_mask
    from vlm_compression_tpu_torch.parallel.mesh import data_sharding
    from vlm_compression_tpu_torch.tasks.retrain import (
        freeze_base_,
        reduce_lora_grads_,
    )

    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(PAR_SEED + 7)
    b, nq = PAR_BLOCK_B, cfg.qformer.num_query_tokens

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    vit, qf = model.visual_encoder.blocks_0, model.qformer.layers_0
    enc, dec = model.t5_model.encoder, model.t5_model.decoder
    n_vit = cfg.vit.num_patches + 1
    dm = cfg.t5.d_model
    inputs = dict(vit=rand(b, n_vit, cfg.vit.embed_dim),
                  qf=rand(b, nq + TXT, cfg.qformer.hidden_size),
                  img=rand(b, n_vit, cfg.vit.embed_dim),
                  enc=rand(b, nq + TXT, dm), dec=rand(b, LBL, dm),
                  mem=rand(b, nq + TXT, dm))
    outs_g = {k: rand(*inputs[k].shape) for k in ("vit", "qf", "enc",
                                                  "dec")}
    blocks = {"vit": vit, "qformer": qf, "t5_encoder": enc.blocks_0,
              "t5_decoder": dec.blocks_0}
    lins = [(f"{tag}.{n}", m) for tag, blk in blocks.items()
            for n, m in lora_linears(blk)]
    dtypes = [(p, p.dtype) for blk in blocks.values()
              for p in blk.parameters()]
    if dt == torch.float32:
        for blk in blocks.values():
            blk.float()
    with torch.no_grad():
        for _, m in lins:
            m.lora_b.copy_(torch.randn(m.lora_b.shape, generator=g,
                                       device="cuda") * 0.02)
    freeze_base_(model)
    dp = mesh is not None and "model" in mesh.mesh_dim_names and \
        mesh.size(mesh.mesh_dim_names.index("model")) == 1
    cut = data_sharding(mesh) if dp else (lambda x: x)

    def run(mesh=None):
        c = cut if mesh is not None else (lambda x: x)
        x = {k: c(v) for k, v in inputs.items()}
        gy = {k: c(v) for k, v in outs_g.items()}
        for _, m in lins:
            m.lora_a.grad = m.lora_b.grad = None
        n_enc, n_dec = x["enc"].shape[1], x["dec"].shape[1]
        ys = {"vit": vit(x["vit"], mode="sparse_lora"),
              "qf": qf(x["qf"], None, x["img"], None, nq,
                       mode="sparse_lora"),
              "enc": enc.blocks_0(x["enc"], None,
                                  enc.rel_bias(n_enc, n_enc), None, None,
                                  mode="sparse_lora"),
              "dec": dec.blocks_0(x["dec"], x["mem"],
                                  dec.rel_bias(n_dec, n_dec)
                                  + causal_mask(n_dec, device="cuda"),
                                  None, None, mode="sparse_lora")}
        torch.autograd.backward([ys[k] for k in ys], [gy[k] for k in ys])
        if mesh is not None:
            reduce_lora_grads_(model, mesh)
        return ({k: y.detach() for k, y in ys.items()},
                {n: (m.lora_a.grad.clone(), m.lora_b.grad.clone())
                 for n, m in lins})

    if ref is None:
        ref = run()
    if mesh is None:
        for p, d in dtypes:
            p.data = p.data.to(d)
        return {}, ref
    ref_y, ref_g = ref
    ys, gs = phase(f"par_blocks_{key}", lambda: run(mesh))
    tol = TOL[str(dt).split(".")[-1]]
    worst_y = 0.0
    for k in ys:
        e, sc = max_err(ys[k], cut(ref_y[k]))
        worst_y = max(worst_y, e / (tol * sc))
    worst_g, leaf = 0.0, None
    for n, pair in gs.items():
        for part, got, want in zip(("lora_a", "lora_b"), pair, ref_g[n]):
            e, sc = max_err(got, want)
            if e / (tol * sc) > worst_g:
                worst_g, leaf = e / (tol * sc), f"{n}.{part}"
    for p, dt in dtypes:               # each back to its own dtype
        p.data = p.data.to(dt)
    return ({key: dict(worst_y=worst_y, worst_grad=worst_g,
                       worst_leaf=leaf, linears=len(lins))}, ref)


def par_lora_diff(lora: dict, ref: dict, grads: dict) -> dict:
    """The LoRA factors after a step against the one-process step's: the
    largest difference over lr, everywhere and where the gradient entry is
    decided (above PAR_BIG of its leaf's largest)."""
    worst, decided = 0.0, 0.0
    for n, p in lora.items():
        d = (p.detach().float() - ref[n].float()).abs()
        g = grads[n].float().abs()
        worst = max(worst, float(d.max()) / PAR_LR)
        big = g > PAR_BIG * float(g.max()) if float(g.max()) > 0 else g > 0
        if bool(big.any()):
            decided = max(decided, float(d[big].max()) / PAR_LR)
    return dict(worst_over_lr=worst, decided_over_lr=decided)


def par_checksum(tensors) -> float:
    """One number that two ranks holding the same tensors agree on."""
    return float(sum(t.detach().double().sum() * (i + 1)
                     for i, t in enumerate(tensors)))


def par_rank(rank: int, world: int) -> dict:
    """One rank of the parallel path: the phases in order on one XL model
    (seed PAR_SEED, the same on both ranks), the one-process references on
    rank 0 while rank 1 waits at a barrier.  Returns the phases' numbers,
    this rank's launch record and the signatures its sharded phases
    launched."""
    import torch.distributed as dist

    from vlm_compression_tpu_torch.compression import load_pruner
    from vlm_compression_tpu_torch.models.bridge import random_init_
    from vlm_compression_tpu_torch.models.factory import build_model_config
    from vlm_compression_tpu_torch.models.layers import (
        SparseLinear,
        set_mask,
    )
    from vlm_compression_tpu_torch.models.llama import LlamaBlock
    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.parallel import collectives as C
    from vlm_compression_tpu_torch.parallel.dryrun import make_block_fn
    from vlm_compression_tpu_torch.parallel.mesh import (
        MeshConfig,
        axis_index,
        data_sharding,
        gather_params,
        make_mesh,
        shard_params,
    )
    from vlm_compression_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        shard_stages,
        split_stages,
        stack_layer_params,
    )
    from vlm_compression_tpu_torch.tasks.retrain import (
        RessaTrainState,
        lora_parameters,
        make_kd_train_step,
    )

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    me0 = rank == 0
    rec, out = new_record(), {"rank": rank}
    t0 = time.perf_counter()
    cfg, model, batches, req = xl_setup(PAR_SEED, lora=True)
    g = torch.Generator(device="cuda").manual_seed(PAR_SEED + 100)
    train = synthetic_batches(cfg, 1, TRAIN_BS, g)[0]
    lora0 = {n: p.detach().clone() for n, p in lora_parameters(model).items()}
    out["build_s"] = time.perf_counter() - t0
    log(f"  [rank {rank}] XL built in {out['build_s']:.1f} s")
    mesh_tp = make_mesh(MeshConfig(data=1, model=world))
    mesh_dp = make_mesh(MeshConfig(data=world, model=1))

    staged = out["staged"] = {}

    def phase(name, fn):
        PAR_CALLS.phase = name
        before = dict(C.HOST_STAGED)
        with PAR_CALLS.active():
            got = run_phase(rec, name, fn)
        st = staged[name] = {k: C.HOST_STAGED[k] - before[k]
                             for k in before}
        log(f"  [rank {rank}] {name} {rec['secs'][name]:.2f} s, peak "
            f"{rec['peaks'][name] / 2**30:.2f} GiB, gloo staged "
            f"{st['bytes'] / 2**30:.2f} GiB in {st['collectives']} "
            f"collectives ({time.perf_counter() - t0:.1f} s in)")
        return got

    def linears():
        return [(n, m) for n, m in model.named_modules()
                if isinstance(m, SparseLinear)]

    def prune(bs, sink):
        p = load_pruner("blipt5_wanda_pruner", model, bs,
                        vit_prune_spec=f"{cfg.vit.depth}-0.5-1.0-1.0",
                        t5_prune_spec=f"{cfg.t5.num_layers}-0.5-1.0-1.0",
                        num_samples=PAR_CALIB)
        p._stats_sink = sink
        p.prune(lora_model=True)

    def same_on_all(x: float) -> bool:
        t = torch.tensor([x], dtype=torch.float64, device="cuda")
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return all(float(q) == float(parts[0]) for q in parts)

    # The one-process references run on rank 0 (rank 1 waits); the DP = 2
    # phases run on the whole model; then the model is sharded once for
    # every TP = 2 phase, the prune last (it replaces the masks the KD
    # steps and generate ran on)
    calib = [{k: v[:PAR_CALIB] for k, v in batches[0].items()}]
    cut = data_sharding(mesh_dp)

    def kd(batch, accum=1):
        state = RessaTrainState.create(model, weight_decay=WEIGHT_DECAY)
        met = make_kd_train_step(model, state.opt, KL_WEIGHT, T_KD,
                                 accum_grad_iters=accum)(batch, PAR_LR)
        lora = state.lora
        return ({k: float(v) for k, v in met.items()},
                {n: p.detach().clone() for n, p in lora.items()},
                {n: p.grad.detach().clone() for n, p in lora.items()})

    def reset_lora():
        with torch.no_grad():
            for n, p in lora_parameters(model).items():
                p.copy_(lora0[n])
                p.grad = None

    def kd_report(name, met, lora):
        out[name] = dict(met=met, same_on_ranks=same_on_all(
            par_checksum(lora.values())))
        if me0:
            out[name].update(par_lora_diff(lora, ref_lora, ref_grads),
                             loss_err=abs(met["loss"] - ref_met["loss"]),
                             ref_met=ref_met)

    keys = ("image", "input_ids", "attention_mask", "qformer_input_ids",
            "qformer_attention_mask")
    enc = tuple(req[k] for k in keys)

    def generate():
        seqs, _ = run_generate(model, req)
        logits, _ = forced_logits(model, enc, seqs[:, :2], "masked", False)
        return seqs, logits[:, 0]

    def prune_report(key, own, kernels=None):
        # the masks are whole on every rank: rank 0 checks them
        out[f"{key}_same_on_ranks"] = same_on_all(par_checksum(
            m.mask for _, m in linears() if m.mask is not None))
        if me0:
            out[key] = par_prune_checks(model, ref_masks, ref_sink, own,
                                        kernels)

    # 1. Wanda in one process, then its control (one process, the samples
    # in two unequal batches), then at DP = 2 (PAR_CALIB samples: the cut)
    ref_sink, ref_masks = {}, {}
    if me0:
        phase("par_prune_ref", lambda: prune(calib, ref_sink))
        # on the host: rank 0 reaches a one-process KD step's peak later
        ref_masks = {n: m.mask.cpu() for n, m in linears()
                     if m.mask is not None}
        for _, m in linears():
            set_mask(m, None)
        ctrl_sink = {}
        phase("par_prune_ctrl", lambda: prune(
            [{k: v[sl] for k, v in calib[0].items()}
             for sl in (slice(0, PAR_CTRL_SPLIT),
                        slice(PAR_CTRL_SPLIT, PAR_CALIB))], ctrl_sink))
        out["prune_ctrl"] = par_prune_checks(model, ref_masks, ref_sink,
                                             ctrl_sink)
        del ctrl_sink
        for _, m in linears():
            set_mask(m, None)
    dist.barrier()
    own = {}
    shard_params(model, mesh_dp)            # nothing divides over data
    phase("par_prune_dp", lambda: prune([cut(b) for b in calib], own))
    prune_report("prune_dp", own)
    gather_params(model)                    # drops the mesh; moves nothing

    # 2. one block of each tower in float32 (each rank's first backward),
    # then one KD step of train_ressa's configuration on the DP masks
    out["blocks"], block_ref = par_block_checks(model, mesh_dp, "dp", phase)
    _, block_ref16 = par_block_checks(model, None, "ref_bf16", phase,
                                      dt=torch.bfloat16)
    reset_lora()
    ref_met = ref_lora = ref_grads = None
    if me0:
        ref_met, ref_lora, ref_grads = phase("par_kd_ref", lambda: kd(train))
        reset_lora()
        # the control: one process, the batch as two accumulated halves
        # (every label valid: the same loss), each half planned as a data
        # rank's
        met, ctrl_lora, _ = phase("par_kd_ctrl", lambda: kd(train, accum=2))
        out["kd_ctrl"] = dict(met=met, loss_err=abs(
            met["loss"] - ref_met["loss"]), **par_lora_diff(
                ctrl_lora, ref_lora, ref_grads))
        reset_lora()
    dist.barrier()
    shard_params(model, mesh_dp)
    met, lora, _ = phase("par_kd_dp", lambda: kd(cut(train)))
    gather_params(model)
    kd_report("par_kd_dp", met, lora)
    if me0:
        # DP = 2 against the control, which runs the same two halves
        out["par_kd_dp"]["vs_ctrl"] = max(
            float((p.float() - ctrl_lora[n].float()).abs().max())
            for n, p in lora.items())
        del ctrl_lora
    del lora
    reset_lora()

    # 3. beam 5 over N_REQ requests, its first-step logits; the control:
    # one process with the requests in two halves (other kernel plans)
    ref_seqs = ref_logits = ctrl = None
    if me0:
        ref_seqs, ref_logits = phase("par_generate_ref", generate)
        half = N_REQ // 2
        ctrl = torch.cat([forced_logits(
            model, tuple(t[sl] for t in enc), ref_seqs[sl, :2], "masked",
            False)[0][:, 0] for sl in (slice(0, half),
                                       slice(half, N_REQ))])
    dist.barrier()

    # 4. TP = 2: the model sharded once
    shard_params(model, mesh_tp)
    out["blocks"].update(par_block_checks(model, mesh_tp, "tp", phase,
                                          block_ref)[0])
    out["blocks"].update(par_block_checks(model, mesh_tp, "tp_bf16", phase,
                                          block_ref16, dt=torch.bfloat16)[0])
    del block_ref, block_ref16
    reset_lora()
    met, lora, _ = phase("par_kd_tp", lambda: kd(train))
    kd_report("par_kd_tp", met, lora)
    del lora, ref_lora, ref_grads
    reset_lora()
    seqs, logits = phase("par_generate_tp", generate)
    if me0:
        out["generate_tp"] = dict(
            finite=bool(torch.isfinite(logits).all()),
            shape_ok=tuple(seqs.shape) == tuple(ref_seqs.shape),
            drift=rel_rms(logits.float(), ref_logits.float()),
            control_drift=rel_rms(ctrl.float(), ref_logits.float()),
            token_mismatch=int((seqs != ref_seqs).sum()))
    for _, m in linears():
        set_mask(m, None)
    own = {}
    phase("par_prune_tp", lambda: prune(calib, own))
    # rank 0 checks against whole kernels drawn again from the seed (the
    # prune keeps the kernels, lora_model): gathering the shards would
    # move every kernel through the host
    whole_model = kernels = None
    if me0:
        from vlm_compression_tpu_torch.models.factory import build_model

        whole_model = build_model(dict(model_type="flant5xl", **LORA),
                                  seed=PAR_SEED)
        kernels = {n: m.kernel for n, m in whole_model.named_modules()
                   if isinstance(m, SparseLinear)}
    prune_report("prune_tp", own, kernels)
    del model, batches, calib, train, req, lora0, ref_masks, whole_model
    del kernels
    gc.collect()
    torch.cuda.empty_cache()

    # 4. T5-XL's encoder self-attention, split over heads, then batch
    a = PAR_ATTN
    q, k, v, biases = flash_inputs(a["b"], a["n"], a["n"], a["h"], a["d"],
                                   ["rel", "pad"], torch.bfloat16, seed=7)
    gq = grad_like(q)

    def attn_grads(mesh=None):
        qkv = [t.detach().clone() for t in (q, k, v)]
        bs = [x.detach().clone().requires_grad_(True) for x in biases]
        if mesh is not None:
            nb = mesh.size(mesh.mesh_dim_names.index("data"))
            nh = mesh.size(mesh.mesh_dim_names.index("model"))
            ib, ih = axis_index(mesh, "data"), axis_index(mesh, "model")
            b, h = a["b"] // nb, a["h"] // nh
            qkv = [t[ib * b:(ib + 1) * b, :, ih * h:(ih + 1) * h]
                   .contiguous() for t in qkv]
            gl = gq[ib * b:(ib + 1) * b, :, ih * h:(ih + 1) * h]
        else:
            gl = gq
        for t in qkv:
            t.requires_grad_(True)
        o = (A.sharded_attention_core(*qkv, bs, scale=1.0, mesh=mesh)
             if mesh is not None else A.attention_core(*qkv, bs, scale=1.0))
        torch.autograd.backward(o, gl)
        return [t.grad for t in qkv] + [x.grad for x in bs]

    ref = attn_grads()          # one process, on each rank (small)
    out["attention"] = {}
    for name, mesh in (("par_attention_heads", mesh_tp),
                       ("par_attention_batch", mesh_dp)):
        got = phase(name, lambda: attn_grads(mesh))
        nb = mesh.size(mesh.mesh_dim_names.index("data"))
        nh = mesh.size(mesh.mesh_dim_names.index("model"))
        ib, ih = axis_index(mesh, "data"), axis_index(mesh, "model")
        b, h = a["b"] // nb, a["h"] // nh
        worst = 0.0
        for i, (x, want) in enumerate(zip(got, ref)):
            if i < 3:
                want = want[ib * b:(ib + 1) * b, :, ih * h:(ih + 1) * h]
            e, s = max_err(x, want)
            worst = max(worst, e / (TOL["bfloat16"] * s))
        out["attention"][name] = dict(worst_over_tol=worst)
    del q, k, v, biases, gq, ref

    # 5. 8 of Vicuna-7B's LLaMA blocks, 2 stages, 4 microbatches
    pp = PAR_PIPE
    _, vcfg = build_model_config(dict(VICUNA_MODEL))
    lcfg = vcfg.llm
    layers = []
    for i in range(pp["blocks"]):
        blk = LlamaBlock(lcfg, device="cuda")
        random_init_(blk, PAR_SEED + i)
        layers.append({n: p.detach() for n, p in blk.named_parameters()})
        del blk
    gx = torch.Generator(device="cuda").manual_seed(PAR_SEED + 50)
    x = torch.randn(pp["batch"], pp["seq"], lcfg.hidden_size, generator=gx,
                    device="cuda").to(torch.bfloat16)
    fn = make_block_fn("llama", lcfg, "cuda")

    def seq_ref():
        tree = [{n: t.clone().requires_grad_(True) for n, t in lp.items()}
                for lp in layers]
        h = x
        for lp in tree:
            h = fn(lp, h)
        loss = torch.mean(h.float() ** 2)
        loss.backward()
        return h.detach(), [{n: t.grad for n, t in lp.items()} for lp in tree]

    y_ref, g_ref = seq_ref()
    mesh_pp = make_mesh(MeshConfig(pipe=pp["stages"], data=1, model=1))

    def piped():
        stage = shard_stages(split_stages(stack_layer_params(layers),
                                          pp["stages"]), mesh_pp,
                             requires_grad=True)
        y = pipeline_apply(fn, stage, x, mesh=mesh_pp,
                           n_microbatches=pp["micro"])
        torch.mean(y.float() ** 2).backward()
        return y.detach(), {n: t.grad for n, t in stage.items()}

    C.HOST_STAGED["hops"] = 0
    y, grads = phase("par_pipeline", piped)
    s = axis_index(mesh_pp, "pipe")
    per = pp["blocks"] // pp["stages"]
    e, sc = max_err(y, y_ref)
    worst = e / (TOL["bfloat16"] * sc)
    for n, gs in grads.items():
        for j in range(per):
            e, sc = max_err(gs[j], g_ref[s * per + j][n])
            worst = max(worst, e / (TOL["bfloat16"] * sc))
    out["pipeline"] = dict(worst_over_tol=worst, stage=s,
                           host_hops=C.HOST_STAGED["hops"])
    out["rec"] = rec
    out["calls"] = {kind: getattr(PAR_CALLS, kind)
                    for kind in ("mm", "lora", "mm32", "lora32", "fwd",
                                 "bwd")}
    out["total_s"] = time.perf_counter() - t0
    return out


def par_timed(names: dict) -> dict:
    """{row: (kind, name)} of the parallel path's timed signatures: 1p the
    TP prune's largest masked matmul (a linear at half its N or K), 3p the
    TP KD step's largest sparse-LoRA matmul, 4p its T5 attention forward
    at 32 / 2 local heads, 5p/6p its largest backward there, 7p the direct
    head-sharded attention's backward with the position bias's
    gradient."""
    def pick(kind, pred, size):
        cands = [(n, k) for n, k in names[kind].items() if pred(n, k)]
        return max(cands, key=lambda nk: size(nk[1]))[0] if cands else None

    mm_size = lambda k: k[0] * k[1] * k[2]  # noqa: E731
    at_size = lambda k: k[0] * k[1] * k[2] * k[3]  # noqa: E731
    heads = PAR_ATTN["h"] // PAR_WORLD
    out = {
        "1p": ("mm", pick("mm", lambda n, k: k[-1] == "par_prune_tp"
                          and k[3] == torch.bfloat16, mm_size)),
        "3p": ("lora", pick("lora", lambda n, k: k[-1] == "par_kd_tp",
                            mm_size)),
        "4p": ("fwd", pick("fwd", lambda n, k: n.startswith("par_kd_tp")
                           and k[3] == heads and k[4] == PAR_ATTN["d"],
                           at_size)),
        "5p": ("bwd", pick("bwd", lambda n, k: n.startswith("par_kd_tp")
                           and not k[11], at_size)),
        "7p": ("bwd", pick("bwd", lambda n, k: n.startswith(
            "par_attention_heads") and bool(k[11]), at_size))}
    return {row: v for row, v in out.items() if v[1] is not None}


def nccl_world_of_one() -> dict:
    """``common.dist.init_distributed_mode``'s NCCL branch in this process,
    a world of 1 named by the environment as torchrun names it: a mesh on
    it, a KD step of the tiny fp32 model on the card, and the LoRA
    gradients' data-parallel bucket reduction over the NCCL group (an
    identity over one rank); the group destroyed after."""
    import socket

    from vlm_compression_tpu_torch.common import dist as D
    from vlm_compression_tpu_torch.parallel import dryrun as DR
    from vlm_compression_tpu_torch.parallel.mesh import (
        MeshConfig,
        make_mesh,
        shard_params,
    )
    from vlm_compression_tpu_torch.tasks import retrain as R

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    D._initialized = False
    t0 = time.perf_counter()
    try:
        D.init_distributed_mode(None)
        backend = torch.distributed.get_backend()
        mesh = make_mesh(MeshConfig())
        t_init = time.perf_counter() - t0
        tcfg = DR.tiny_config(lora=True)
        model = DR.build_model(tcfg, None, device="cuda")
        shard_params(model, mesh)
        state = R.RessaTrainState.create(model)
        batch = DR.to_device(DR.tiny_batch(tcfg, 4, 0), "cuda")
        met = R.make_kd_train_step(model, state.opt, KL_WEIGHT, T_KD)(
            batch, 1e-3)
        grads = [p.grad for p in state.lora.values()]
        before = [t.clone() for t in grads]
        R.bucket_all_reduce_(grads, mesh.get_group("data"))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(before, grads))
        t_step = time.perf_counter() - t0 - t_init
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        D._initialized = False
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return dict(backend=backend, loss=float(met["loss"]),
                reduced_same=same, mesh=list(mesh.mesh_dim_names),
                init_s=t_init, step_s=t_step)


def parallel_path() -> tuple:
    """The NCCL world of 1 here, then PAR_WORLD gloo ranks sharing the card
    (``par_rank``); every gate checked here.  Returns (the ranks' launch
    record merged, phases named ``par_r<rank>_<phase>``; the numbers)."""
    import tempfile

    from vlm_compression_tpu_torch.parallel.collectives import spawn

    t0 = time.perf_counter()
    nccl = nccl_world_of_one()
    log(f"  NCCL world of 1 (init_distributed_mode, the environment naming "
        f"it): backend {nccl['backend']}, mesh {nccl['mesh']}, a tiny KD "
        f"step loss {nccl['loss']:.5f}, the LoRA gradients' bucket "
        f"all-reduce over the NCCL group an identity: {nccl['reduced_same']}"
        f" ({time.perf_counter() - t0:.1f} s: the group and mesh "
        f"{nccl['init_s']:.1f} s, the model, step and reduction "
        f"{nccl['step_s']:.1f} s)")
    if nccl["backend"] != "nccl" or not nccl["reduced_same"]:
        raise AssertionError(f"NCCL world of 1: {nccl}")
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = spawn(par_rank, PAR_WORLD, PAR_BACKEND,
                     os.path.join(tmp, "init"), PAR_TIMEOUT)
    wall = time.perf_counter() - t1
    r0 = outs[0]
    log(f"  {PAR_WORLD} ranks on {PAR_BACKEND} with CUDA tensors (NCCL "
        f"refuses two ranks on one device: scripts/torch_parallel_probe.py)"
        f": spawn to join {wall:.1f} s; XL built in {r0['build_s']:.1f} s a "
        f"rank; a rank's phases {[round(o['total_s'], 1) for o in outs]} s")
    merged = new_record()
    for o in outs:
        for part in ("counts", "shapes", "secs", "peaks"):
            for ph, val in o["rec"][part].items():
                merged[part][f"par_r{o['rank']}_{ph}"] = val
    for ph in PAR_REFS + PAR_PHASES:
        secs = [o["rec"]["secs"].get(ph) for o in outs]
        peaks = [o["rec"]["peaks"].get(ph) for o in outs]
        secs_s = ", ".join("-" if x is None else f"{x:.2f}" for x in secs)
        peak_s = ", ".join("-" if x is None else f"{x / 2**30:.2f}"
                           for x in peaks)
        together = sum(x or 0 for x in peaks)
        moved = ", ".join(
            "-" if ph not in o["staged"] else
            f"{o['staged'][ph]['bytes'] / 2**30:.2f}" for o in outs)
        log(f"  {ph}: s by rank [{secs_s}], peak GiB by rank [{peak_s}], "
            f"together {together / 2**30:.2f}; gloo staged GiB by rank "
            f"[{moved}]; " + attn_routes(outs[0]["rec"]["counts"][ph]))
        if together > torch.cuda.get_device_properties(0).total_memory:
            raise AssertionError(f"{ph}: the ranks' peaks do not fit")
    for ph, c in merged["counts"].items():
        base = ph.split("_", 2)[2]
        for kernel in PHASE_KERNELS[base]:
            if c[kernel] <= 0:
                raise AssertionError(f"{kernel} never launched in {ph}")
        for kernel in PHASE_FORBIDDEN.get(base, ()):
            if c[kernel] != 0:
                raise AssertionError(f"{kernel} launched in {ph}")
    fails = []

    def gate(ok, what):
        if not ok:
            fails.append(what)
        return "ok" if ok else "FAIL"

    for key in ("prune_tp", "prune_dp"):
        d = r0[key]
        # TP = 2 folds the same stem outputs (0 expected); at DP = 2 the
        # stem's float32 patch product runs at half the rows, and a few of
        # its outputs round to the neighbouring bf16 value
        first_tol = 0.0 if key == "prune_tp" else 1e-3
        ok = (d["own_stats_flips"] == 0
              and d["first_stat_rel"] <= first_tol
              and all(abs(x - 0.5) <= PAR_DENSITY
                      for x in d["density"].values())
              and r0[f"{key}_same_on_ranks"])
        log(f"  Wanda at {key[-2:].upper()} = 2 ({PAR_CALIB} samples, the "
            f"cut): masks against the one-process mask function on the "
            f"whole kernels and the run's own statistics: "
            f"{d['own_stats_flips']} flipped bits; the ViT block 0 qkv's "
            f"statistic against one process's: {d['first_stat_rel']:.2e} "
            f"relative (bound {first_tol:g}); densities "
            f"{ {t: round(x, 4) for t, x in d['density'].items()} }; masks "
            f"equal on the ranks {r0[f'{key}_same_on_ranks']} "
            f"{gate(ok, key)}. Against the one-process prune (not gated: "
            f"bf16 rounding in another order, carried through 87 random "
            f"blocks, moves the statistics of every later block): "
            f"{d['flips']} flipped bits over {d['linears']} linears (at "
            f"most {d['worst']} in one), {d['non_tie_units']} units with "
            f"flips that are not metric ties")
    c = r0["prune_ctrl"]
    log(f"  Wanda control (one process, the {PAR_CALIB} samples in batches "
        f"of {PAR_CTRL_SPLIT} and {PAR_CALIB - PAR_CTRL_SPLIT}: other row "
        f"counts in every block) against the one-process prune (not "
        f"gated): {c['flips']} flipped bits over {c['linears']} linears (at "
        f"most {c['worst']} in one), {c['non_tie_units']} units with flips "
        f"that are not metric ties; against the mask function on its own "
        f"statistics {c['own_stats_flips']} flipped bits; the first "
        f"linear's statistic {c['first_stat_rel']:.2e} relative")
    for key in ("par_kd_tp", "par_kd_dp"):
        d = r0[key]
        loss_tol = TOL["bfloat16"] * max(1.0, abs(d["ref_met"]["loss"]))
        ok = (d["loss_err"] <= loss_tol
              and all(math.isfinite(v) for v in d["met"].values())
              and all(o[key]["same_on_ranks"] for o in outs))
        log(f"  KD step {key[-2:].upper()} = 2 (batch {TRAIN_BS}) vs one "
            f"process: loss {d['met']['loss']:.5f} vs "
            f"{d['ref_met']['loss']:.5f} (err {d['loss_err']:.2e}, tol "
            f"{loss_tol:.2e}), ce {d['met']['ce']:.5f}, kl "
            f"{d['met']['kl']:.6f}; LoRA equal on the ranks "
            f"{all(o[key]['same_on_ranks'] for o in outs)} "
            f"{gate(ok, key)}; the LoRA factors after the update against "
            f"one process's (not gated: the random model's gradients "
            f"follow its activations' rounding): largest difference "
            f"{d['worst_over_lr']:.3f}·lr, {d['decided_over_lr']:.3f}·lr "
            f"where the gradient is above {PAR_BIG:g} of its leaf's largest")
    c = r0["kd_ctrl"]
    log(f"  KD control (one process, the batch as two accumulated halves) "
        f"vs one process (not gated): loss {c['met']['loss']:.5f} (err "
        f"{c['loss_err']:.2e}); the LoRA factors after the update: largest "
        f"difference {c['worst_over_lr']:.3f}·lr, "
        f"{c['decided_over_lr']:.3f}·lr where the gradient is above "
        f"{PAR_BIG:g} of its leaf's largest")
    # each DP rank runs one half as the control's micro-batch runs it, and
    # the shares' sum is the halves' mean bit for bit (every label valid)
    d = r0["par_kd_dp"]
    ok = d["met"] == c["met"]
    log(f"  KD step DP = 2 against the control: loss, ce and kl bit-equal "
        f"{gate(ok, 'kd_dp_vs_control')}; the LoRA factors after the "
        f"update differ by at most {d['vs_ctrl']:.3e} (not gated)")
    kd = {k: r0[k] for k in ("par_kd_dp", "par_kd_tp")}
    log(f"  drift from one process, DP = 2 / TP = 2 / control: Wanda "
        f"flipped bits {r0['prune_dp']['flips']} / "
        f"{r0['prune_tp']['flips']} / {r0['prune_ctrl']['flips']}, non-tie "
        f"units {r0['prune_dp']['non_tie_units']} / "
        f"{r0['prune_tp']['non_tie_units']} / "
        f"{r0['prune_ctrl']['non_tie_units']}; KD loss "
        f"{kd['par_kd_dp']['loss_err']:.2e} / "
        f"{kd['par_kd_tp']['loss_err']:.2e} / {c['loss_err']:.2e}; LoRA "
        f"decided entries {kd['par_kd_dp']['decided_over_lr']:.3f} / "
        f"{kd['par_kd_tp']['decided_over_lr']:.3f} / "
        f"{c['decided_over_lr']:.3f}·lr; generate (TP and its control "
        f"only) {r0['generate_tp']['drift']:.4f} / "
        f"{r0['generate_tp']['control_drift']:.4f} relative RMS")
    for key, d in r0["blocks"].items():
        ok = d["worst_y"] <= 1.0 and d["worst_grad"] <= 1.0
        dt = "bf16" if key.endswith("_bf16") else "float32"
        log(f"  block 0 of the ViT, Q-Former and both T5 stacks at "
            f"{key[:2].upper()} = 2 ({dt}, batch {PAR_BLOCK_B}, sparse-LoRA, "
            f"{d['linears']} adapted linears) vs one process on the same "
            f"inputs: outputs worst {d['worst_y']:.3f} and LoRA gradients "
            f"worst {d['worst_grad']:.3f} ({d['worst_leaf']}) of the {dt} "
            f"tolerance "
            f"{gate(ok, 'blocks_' + key)}")
    d = r0["generate_tp"]
    ok = d["finite"] and d["shape_ok"]
    log(f"  beam-5 generate of {N_REQ} at TP = 2: finite first-step logits, "
        f"tokens of the one-process shape {gate(ok, 'generate_tp')}; their "
        f"relative RMS against one process's {d['drift']:.4f}, the control "
        f"(one process, the requests in two halves) {d['control_drift']:.4f}"
        f" (not gated); tokens differing {d['token_mismatch']}")
    for o in outs:
        for name, a in o["attention"].items():
            ok = a["worst_over_tol"] <= 1.0
            log(f"  rank {o['rank']} {name}: dq, dk, dv and both bias "
                f"gradients against one process, worst "
                f"{a['worst_over_tol']:.3f} of the bf16 tolerance "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fails.append(name)
        p = o["pipeline"]
        ok = p["worst_over_tol"] <= 1.0
        log(f"  rank {o['rank']} pipeline stage {p['stage']}: output and "
            f"gradients against the sequential blocks, worst "
            f"{p['worst_over_tol']:.3f} of the bf16 tolerance; "
            f"{p['host_hops']} hops staged through the host "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append("pipeline")
    if fails:
        raise AssertionError(f"parallel path: {fails}")
    # the signatures the ranks launched, for the kernel checks and timing
    for o in outs:
        for kind, got in o["calls"].items():
            mine = getattr(PAR_CALLS, kind)
            for key, val in got.items():
                if key in mine:
                    continue
                if kind in ("fwd", "bwd"):
                    ph, bs = val
                    val = (ph, [torch.as_tensor(x).cuda() for x in bs])
                mine[key] = val
    e2e = {"parallel_wall_s": time.perf_counter() - t0,
           "parallel_spawn_s": wall,
           "parallel_backend": PAR_BACKEND, "parallel_nccl_world1": nccl,
           "parallel_phase_s": {f"par_r{o['rank']}_{ph}": s
                                for o in outs
                                for ph, s in o["rec"]["secs"].items()},
           "parallel_peaks": {f"par_r{o['rank']}_{ph}": s
                              for o in outs
                              for ph, s in o["rec"]["peaks"].items()},
           "parallel_prune": {k: r0[k] for k in ("prune_tp", "prune_dp",
                                                 "prune_ctrl")},
           "parallel_kd_control": r0["kd_ctrl"],
           "parallel_staged": {o["rank"]: o["staged"] for o in outs},
           "parallel_kd": {k: {x: y for x, y in r0[k].items()
                               if x != "ref_met"}
                           for k in ("par_kd_tp", "par_kd_dp")},
           "parallel_generate": r0["generate_tp"],
           "parallel_blocks": r0["blocks"],
           "parallel_attention": {o["rank"]: o["attention"] for o in outs},
           "parallel_pipeline": {o["rank"]: o["pipeline"] for o in outs}}
    return merged, e2e


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
    # the parallel path first: its ranks share the card with this process,
    # which holds nothing yet
    worst = {}
    log(f"[parallel path] InstructBLIP-FlanT5-XL at full width, "
        f"{PAR_WORLD} ranks sharing the card: Wanda at TP = 2 and at DP = 2 "
        f"({PAR_CALIB} samples in one batch: the cut), one KD step at TP = "
        f"2 and at "
        f"DP = 2 (batch {TRAIN_BS}), beam-5 generate at TP = 2, block 0 of "
        f"each tower, one-process controls, T5-XL's "
        f"encoder attention split over heads and over the batch, a GPipe "
        f"pipeline of {PAR_PIPE['blocks']} of Vicuna-7B's LLaMA blocks (the "
        f"cut) over {PAR_PIPE['stages']} stages; each against one process; "
        f"a world of 1 on NCCL")
    par_rec, p_e2e = parallel_path()
    phase_done("parallel path")
    log("[kernels] rows 1 and 3-7 at every signature the parallel path's "
        "ranks launched (recorded in each rank, held here)")
    par_names = check_leg_kernels(par_rec, worst, calls=PAR_CALLS,
                                  prefix="")
    phase_done("parallel kernels")

    lengths = add_cli_train_shapes()
    wf_lengths = add_wf_cli_shapes()
    rank_p, rank_c, rank_n, rank_rows = add_rank_c4_shapes()
    log(f"[kernels] kernel vs plain version (with the CLI train path's "
        f"retrain shapes: its batches' longest captions {lengths} words; "
        f"the pruners path's batch-1 scoring: (Q-Former, T5, label) "
        f"tokens {wf_lengths}; the Vicuna rank pass: prompts of {rank_p} "
        f"and candidates of {rank_c} tokens, LLaMA over {rank_n}, "
        f"{rank_rows} rows a chunk in the task)")
    worst.update(check_kernels())
    check_compressed_kernels(worst)
    check_dbias_kernel(worst)
    log("[kernels] rows 1 and 4 at the zoo path's shapes")
    check_zoo_kernels(worst)
    phase_done("kernels")
    log("[reference] tiny model, card vs CPU")
    tiny_reference_check()
    tiny_train_check()
    tiny_gradient_scoring_check()
    tiny_grid_pruners_check()
    tiny_vicuna_check()
    tiny_retrieval_check()
    tiny_cli_train_check()
    tiny_pruners_check()
    tiny_loader_check()
    tiny_zoo_check()
    tiny_leg_check()
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
        "RESSA retrain, merge, beam-5 generate, VQA, serving (speculative "
        "decoding, per-row and int8 KV caches), NoCaps captioning, C4 "
        "perplexity")
    counts, e2e = main_path()
    phase_done("main path")
    counts.update(par_rec["counts"])
    e2e.update(p_e2e)
    del par_rec
    gc.collect()
    torch.cuda.empty_cache()
    log("[compressed path] InstructBLIP-FlanT5-XL: SparseGPT prune, beam-5 "
        "generate with bool masks, packed masks (G 128, 256), int4 weights "
        "(bool and packed-128 masks), int8 weights, W8A8 (with and without "
        "outlier columns), the int8 serving form")
    c_counts, c_e2e = compressed_path()
    phase_done("compressed path")
    counts.update(c_counts)
    e2e.update(c_e2e, **sg)
    log(f"[quant path] InstructBLIP-FlanT5-XL cut to "
        f"{'/'.join(map(str, GPTQ_DEPTH))} blocks (the cut): GPTQ joint "
        f"4-bit at 0.5 (blipt5_gptq_pruner), AWQ + GPTQ on the ViT "
        f"(vit_gptq_pruner, keep 1.0), beam-5 generate")
    gq_counts, gq_e2e = quant_path()
    phase_done("quant path")
    counts.update(gq_counts)
    e2e.update(gq_e2e)
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
        "the zeroth entry (one sample scored at batch 1, at 13/8/8 blocks), "
        "beam-5 generate")
    g_counts, g_e2e = grid_path()
    phase_done("grid path")
    counts.update(g_counts)
    e2e.update(g_e2e)
    gc.collect()
    torch.cuda.empty_cache()
    log("[pruners path] InstructBLIP-FlanT5-XL: RIA (against Wanda) and "
        "hybrid 2:4 tiles, beam-5 generate each; transposable 2:4; the "
        f"soft-mask anneal at {'/'.join(map(str, SOFTMASK_DEPTH))} blocks "
        "(the cut), beam-5 generate; "
        "WoodFisher over named leaves; cli.evaluate_woodfisher: the unstrct "
        "prune and the pairwise block merge, each with its GQA pass")
    p_counts, p_e2e = pruners_path()
    phase_done("pruners path")
    counts.update(p_counts)
    e2e.update(p_e2e)
    gc.collect()
    torch.cuda.empty_cache()
    log("[vicuna path] InstructBLIP-Vicuna-7B: Wanda prune (ViT and "
        "llm_model), beam-5 generate, GQA and OK-VQA through the tasks, "
        "serving (speculative decoding, per-row and int8 KV caches), "
        "RESSA retrain, merge, beam-5 generate, ranking, C4 perplexity; "
        "rebuilt dense: the DSnoT grid entry, beam-5 generate")
    v_counts, v_e2e = vicuna_path()
    phase_done("vicuna path")
    counts.update(v_counts)
    e2e.update(v_e2e)
    gc.collect()
    torch.cuda.empty_cache()
    log("[opt path] BLIP-2 OPT-6.7B: the ViT's Wanda prune, beam-5 "
        "generate_opt, GQA through the task, speculative decoding and the "
        "int8 KV cache")
    o_counts, o_e2e = opt_path()
    phase_done("opt path")
    counts.update(o_counts)
    e2e.update(o_e2e)
    log("[retrieval path] the stage-1 BLIP-2 Q-Former: ViT Wanda prune, "
        "Flickr30k retrieval through the task (ITC ranking + ITM rerank at "
        "k_test 128), cold and warm")
    r_counts, r_e2e = retrieval_path()
    phase_done("retrieval path")
    counts.update(r_counts)
    e2e.update(r_e2e)
    log("[zoo path] the legacy zoo at full width, bf16, 50 % magnitude "
        "masks: BLIP-1, ALBEF, CLIP and EVA-CLIP through the retrieval "
        f"task at k_test {ZOO_RUN['k_test']} on {ZOO_IMAGES} images × "
        f"{ZOO_IMAGES * ZOO_PER_IMAGE} captions (the cut), CLIP's text over "
        f"{CLIP_CTX} tokens, BlipVQA.rank_answers, BlipCaption.decode_step, "
        "BlipNLVR, BlipClassification.predict, and cli.evaluate on the "
        "BLIP retrieval yaml")
    z_counts, z_e2e = zoo_path()
    phase_done("zoo path")
    counts.update(z_counts)
    e2e.update(z_e2e)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[leg path] the rest of the legacy zoo at full width, bf16, 50 % "
        f"magnitude masks: ALPRO (TimeSformer-B/16, {ALPRO_FRAMES} frames) "
        f"through the retrieval task on {ALPRO_VIDEOS} videos × "
        f"{ALPRO_VIDEOS} captions at k_test {ALPRO_RUN['k_test']} (the "
        f"cut), AlproQA at batch {ALPRO_QA_B}, cli.evaluate on "
        f"{ALPRO_CLI_YAML}; PNP-VQA base through VQARCTask ({PNP_Q} "
        f"questions, {PNP_RUN['num_captions']} captions: the cut); GPT "
        f"dialogue through DialogueTask at batch {GPT_B} and cli.evaluate "
        f"on {GPT_CLI_YAML}; one backward of each zoo loss")
    leg_rec, l_e2e = leg_path()
    phase_done("leg path")
    counts.update(leg_rec["counts"])
    e2e.update(l_e2e)
    log("[kernels] rows 1 and 4-7 at every signature the leg path launched "
        "(recorded)")
    leg_names = check_leg_kernels(leg_rec, worst)
    del leg_rec
    phase_done("leg kernels")

    gc.collect()
    torch.cuda.empty_cache()
    log("[cli path] the launcher's T5 grid point through the port's CLI: "
        "the Wanda prune call at batch 1 (checkpoint saved), the GQA eval "
        "call on the checkpoint, and again with --quantize_int4 and with "
        "--quantize_int8 --w8a8 --int8_outliers 32")
    cl_counts, cl_e2e = cli_path()
    phase_done("cli path")
    counts.update(cl_counts)
    e2e.update(cl_e2e)
    log("[cli train path] the launcher's T5 RESSA grid point through the "
        "port's CLI: the train call (Wanda at batch 16, the cut; the "
        "launcher's 1; masks kept; "
        "SparseLoRA + KD, 3 steps at batch 32; merge; save), the GQA eval "
        "call on the checkpoint, stripped")
    ct_counts, ct_e2e = cli_train_path()
    phase_done("cli train path")
    counts.update(ct_counts)
    e2e.update(ct_e2e)
    log("[profile] the main path, the SparseGPT prune (at "
        f"{'/'.join(map(str, SPARSEGPT_PROFILED_DEPTH))} blocks, the cut) "
        "and the first-order path's gradient phases again under "
        "torch.profiler (the cut: the grid path's prunes are no longer "
        "traced; their walls stand in their own path)")
    for part in (profile_main_path, profile_sparsegpt_prune,
                 profile_first_order):
        t0 = time.perf_counter()
        part(e2e)
        log(f"  [{part.__name__}] {time.perf_counter() - t0:.1f} s")
    phase_done("profile")
    log("[timing] bf16, each reading the median of 20 calls, CUDA events, "
        "L2 flushed before each call; attention kernels and their library "
        "call in turns (kernel, library, library, kernel), the means; the "
        "shapes the kernel line reports (the cut: the others are held in "
        "phase 3, untimed)")
    rows, wmma, extra = timing()
    timing_compressed(rows, wmma)
    zoo_rows = timing_zoo(worst)
    leg_rows = timing_leg(leg_names, worst)
    par_rows = timing_leg(par_names, worst, calls=PAR_CALLS,
                          timed=par_timed)
    phase_done("timing")
    log(f"[phases] wall-clock s: "
        f"{json.dumps({k: round(v, 1) for k, v in phases.items()})}")

    # the attention forward's row reports its TMA + wgmma route (its time
    # and launches, beside the mma.sync route's time and the other
    # routes' launches), and LLaMA's d = 128 shapes on their planned route
    # (``llama_d128``); the backward's two rows both report the TMA +
    # wgmma route's whole backward (its time, bound and launches, beside
    # the mma.sync route's time and launches), and LLaMA's at the Vicuna
    # retrain (``llama_retrain``)
    kernels = []
    csrc = "vlm_compression_tpu_torch/csrc/"
    vicuna_shape = {name: (n, m, d)
                    for name, _, n, m, _, d, *_ in VICUNA_FLASH_SHAPES}
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
                # LLaMA's d = 128 at the Vicuna retrain, on its planned
                # route (the whole backward's ms; "pr2_ms" the mma.sync
                # route's, the earlier time), its launches in that phase
                # by route
                "llama_retrain": {name: dict(zip(
                    ("ms", "plain_ms", "library_ms", "bound_ms",
                     "bound_by"), rows[(kname, name)]),
                    **extra[(kname, name)],
                    max_abs_err=worst[(kname, name, torch.bfloat16)],
                    route=A.plan(n, m, d),
                    source=csrc + ("flash_attention_bwd_wgmma.cu"
                                   if A.plan(n, m, d) == A.WGMMA
                                   else "flash_attention_bwd.cu"),
                    launches=e2e["vicuna_d128_launches"]["vicuna_retrain"][
                        "backward"])
                    for name, _, n, m, _, d, *_ in BWD_SHAPES if d == 128}}
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
                # LLaMA's d = 128 on its planned route ("mma_ms": the
                # mma.sync route's, the earlier time)
                "llama_d128": {name: dict(zip(
                    ("ms", "plain_ms", "library_ms", "bound_ms",
                     "bound_by"), rows[(kname, name)]),
                    **extra[(kname, name)],
                    max_abs_err=worst[(kname, name, torch.bfloat16)],
                    route=A.plan_forward(*vicuna_shape[name]))
                    for name in FLASH_VICUNA_TIMED},
                "vicuna_launches_by_route": {
                    p: {"wgmma": c[FWD_WGMMA], "mma": c[FWD_MMA]}
                    for p, c in counts.items() if "vicuna" in p},
                "llama_d128_launches_by_phase": {
                    p: c["forward"]
                    for p, c in e2e["vicuna_d128_launches"].items()},
                # BLIP-2 OPT's shapes (d = 128 at 6.7B, d = 80 at 2.7B;
                # scale 1, the queries pre-scaled) on their planned route
                # ("mma_ms": the mma.sync route's), its launches by phase
                "opt": {name: dict(zip(
                    ("ms", "plain_ms", "library_ms", "bound_ms",
                     "bound_by"), rows[(kname, name)]),
                    **extra[(kname, name)],
                    max_abs_err=worst[(kname, name, torch.bfloat16)],
                    route=A.plan_forward(*vicuna_shape[name]))
                    for name in FLASH_OPT_TIMED},
                "opt_launches_by_phase": {
                    p: {"wgmma": counts[p][FWD_WGMMA],
                        "mma": counts[p][FWD_MMA]}
                    for p in ("opt_prune",) + OPT_PHASES}}
               if kname == "flash_attention" else {}),
            # the OPT path's pruned ViT (its only masked linears) by phase
            **({"opt_launches_by_phase": {
                p: {"launches": counts[p][kname],
                    "hopper": counts[p][WGMMA_LOOP],
                    "decode": counts[p][DECODE]}
                for p in ("opt_prune",) + OPT_PHASES}}
               if kname == "masked_matmul" else {}),
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
            # the zoo path's shapes (d = 64 attention, MED's padding and
            # causal biases, CLIP's causal text, the float32 heads), and
            # the zoo path's launches by route
            **({"zoo": {name: r for (kn, name), r in zoo_rows.items()
                        if kn == kname},
                "zoo_launches_by_route": {
                    p: r[kname]
                    for p, r in e2e["zoo_launches_by_route"].items()}}
               if kname in ("masked_matmul", "flash_attention") else {}),
            # the leg path's shapes (ALPRO's TimeSformer, PNP-VQA, GPT
            # dialogue, the zoo losses' backward) and its launches by route
            **({"video_rc_dialogue": {
                label: r for label, r in leg_rows.items()
                if r["kernel"] == {"flash_attention_bwd_dq":
                                   "flash_attention_bwd",
                                   "flash_attention_bwd_dkv":
                                   "flash_attention_bwd"}.get(kname, kname)},
                "video_rc_dialogue_launches_by_route": {
                    p: r for p, r in e2e["leg_launches_by_route"].items()}}
               if kname in ("masked_matmul", "flash_attention",
                            "flash_attention_bwd_dq",
                            "flash_attention_bwd_dkv",
                            "flash_attention_bwd_dbias") else {}),
            # the parallel path's sharded shapes (half the heads, half of
            # N or K), timed in this process; their launches are in
            # launches_by_phase under par_r<rank>_<phase>
            **({"parallel": {
                label: r for label, r in par_rows.items()
                if r["kernel"] == {"flash_attention_bwd_dq":
                                   "flash_attention_bwd",
                                   "flash_attention_bwd_dkv":
                                   "flash_attention_bwd"}.get(kname, kname)}}
               if kname in ("masked_matmul", "sparse_lora_matmul",
                            "flash_attention", "flash_attention_bwd_dq",
                            "flash_attention_bwd_dkv",
                            "flash_attention_bwd_dbias") else {}),
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
