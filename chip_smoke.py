#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  Phases,
each of which fails the run (non-zero exit, no result line) on error:

  1. device   — the card's name and its nvidia-smi name/power-limit line;
  2. build    — both hand-written kernels compiled from csrc/ with nvcc, in
                parallel;
  3. kernels  — each kernel against its plain PyTorch version at the main
                path's shapes, in bf16 and float32, within stated
                tolerances;
  4. reference — a tiny float32 InstructBLIP-T5 on the card (kernels) vs
                the same model on the CPU (plain versions);
  5. main path — full-width InstructBLIP-FlanT5-XL (EVA-ViT-g 39 layers,
                Q-Former, FlanT5-XL 24+24, bf16, seeded random weights):
                ``blipt5_wanda_pruner`` with lora_model=True (masks kept)
                on 128 synthetic calibration samples, then beam-5
                ``generate_t5`` on 4 requests, twice (cold, then warm; the
                two must agree).  Every kernel's launch count must rise in
                the prune and in each generate phase;
  6. profile  — the main path once more under torch.profiler: device time
                by kernel group against the phase's unprofiled wall-clock;
  7. timing   — kernel, plain-version and library-call times (CUDA events,
                L2 flushed before each call) at the main path's shapes,
                beside each kernel's bound.

The last lines are the kernel JSON, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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


def device_ms(fn, iters=20, warmup=3) -> float:
    """Median time of one call on the card: CUDA events around each call,
    with a 512 MB write before it that evicts the 50 MB L2 (a real step
    finds its weights cold) and keeps the card busy while the host enqueues
    the call, so host overhead stays out of the reading."""
    flush = torch.empty(512 * 2**20, dtype=torch.int8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
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
]
FLASH_TIMED = "vit_self_calib"


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
    return q, k, v, biases


def mm_bound_ms(m, k, n):
    flops = 2.0 * m * n * k
    nbytes = 2.0 * m * k + 3.0 * k * n + 2.0 * m * n
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_bound_ms(q, k, v, biases):
    """q, k, v and each bias read once; out and the fp32 lse written once;
    QKᵀ and PV at 2·n·m·d operations each per (batch, head)."""
    b, n, h, d = q.shape
    m = k.shape[1]
    flops = 4.0 * b * h * n * m * d
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + 4.0 * b * h * n + sum(4.0 * x.numel() for x in biases)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ------------------------------------------------------------------ phases


def check_kernels():
    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[-1]]
        for name, m, k, n in MM_SHAPES:
            x, w, mask = mm_inputs(m, k, n, dtype)
            err, scale = max_err(ML.masked_matmul(x, w, mask),
                                 ML.masked_matmul_ref(x, w, mask))
            ok = err <= tol * scale
            log(f"  masked_matmul {name:22s} {str(dtype)[6:]:8s} "
                f"M={m} K={k} N={n} max_abs_err={err:.3e} "
                f"(tol {tol * scale:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"masked_matmul {name} {dtype}")
            worst[("masked_matmul", name, dtype)] = err
        for name, b, n, m, h, d, kinds, scale in FLASH_SHAPES:
            q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, dtype)
            err, s = max_err(A.attention_core(q, k_, v, biases, scale),
                             A.mha_reference(q, k_, v, biases, scale))
            ok = err <= tol * s
            log(f"  flash_attention {name:22s} {str(dtype)[6:]:8s} "
                f"b={b} n={n} m={m} h={h} d={d} biases={kinds} "
                f"max_abs_err={err:.3e} (tol {tol * s:.3e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention {name} {dtype}")
            worst[("flash_attention", name, dtype)] = err
        # causal masking, including n > m rows that see no key
        for b, n, m in ((2, 40, 40), (2, 9, 5)):
            q, k_, v, _ = flash_inputs(b, n, m, 4, 64, [], dtype)
            err, s = max_err(A.attention_core(q, k_, v, (), 0.125, True),
                             A.mha_reference(q, k_, v, (), 0.125, True))
            log(f"  flash_attention causal n={n} m={m} {str(dtype)[6:]} "
                f"max_abs_err={err:.3e}")
            if err > tol * s:
                raise AssertionError("flash_attention causal")
    return worst


def tiny_reference_check():
    """Tiny float32 InstructBLIP-T5 with random masks: kernels on the card
    vs plain versions on the CPU, same weights and inputs."""
    from vlm_compression_tpu_torch.models.blip2_t5_instruct import (
        Blip2T5Instruct,
        Blip2T5InstructConfig,
    )
    from vlm_compression_tpu_torch.models.bridge import random_init_
    from vlm_compression_tpu_torch.models.eva_vit import EvaViTConfig
    from vlm_compression_tpu_torch.models.layers import SparseLinear
    from vlm_compression_tpu_torch.models.qformer import QFormerConfig
    from vlm_compression_tpu_torch.models.t5 import T5Config

    f32 = dict(param_dtype="float32", dtype="float32")
    cfg = Blip2T5InstructConfig.tiny(
        vit=EvaViTConfig.tiny(**f32), qformer=QFormerConfig.tiny(
            dtype="float32"), t5=T5Config.tiny(d_model=16, **f32))
    cpu = random_init_(Blip2T5Instruct(cfg, device="cpu"), seed=3, std=0.2)
    g = torch.Generator().manual_seed(3)
    for mod in cpu.modules():
        if isinstance(mod, SparseLinear):
            mod.mask = torch.rand(mod.kernel.shape, generator=g) < 0.6
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
    with torch.no_grad():
        want = cpu(**batch)["logits"]
        got = gpu(**{k: v.cuda() for k, v in batch.items()})["logits"].cpu()
    err = float((got - want).abs().max())
    log(f"  tiny fp32 InstructBLIP-T5 masked logits, card vs CPU: "
        f"max_abs_err={err:.3e} (tol 1e-4)")
    if not (err <= 1e-4 and bool(torch.isfinite(got).all())):
        raise AssertionError("tiny reference check")


N_CALIB, BS, TXT, LBL, N_REQ = 128, 16, 40, 12, 4


def xl_setup(seed: int):
    """Full-width InstructBLIP-FlanT5-XL with seeded random bf16 weights on
    the card, the synthetic calibration batches of bench.py:189-191
    (bs 16, text 40, labels 12) and N_REQ generate requests."""
    from vlm_compression_tpu_torch.models.blip2_t5_instruct import (
        Blip2T5Instruct,
        Blip2T5InstructConfig,
    )
    from vlm_compression_tpu_torch.models.bridge import random_init_

    cfg = Blip2T5InstructConfig.flan_t5_xl()
    model = random_init_(Blip2T5Instruct(cfg), seed=seed)
    img = cfg.vit.img_size
    g = torch.Generator(device="cuda").manual_seed(42 + seed)

    def ids(shape):
        return torch.randint(3, 2000, shape, generator=g, device="cuda")

    def ones(b):
        return torch.ones(b, TXT, dtype=torch.int32, device="cuda")

    batches = [dict(image=torch.randn(BS, img, img, 3, generator=g,
                                      device="cuda"),
                    input_ids=ids((BS, TXT)), attention_mask=ones(BS),
                    labels=ids((BS, LBL)), qformer_input_ids=ids((BS, TXT)),
                    qformer_attention_mask=ones(BS))
               for _ in range(N_CALIB // BS)]
    req = dict(image=torch.randn(N_REQ, img, img, 3, generator=g,
                                 device="cuda"),
               input_ids=ids((N_REQ, TXT)), attention_mask=ones(N_REQ),
               qformer_input_ids=ids((N_REQ, TXT)),
               qformer_attention_mask=ones(N_REQ))
    req["attention_mask"][1, -7:] = 0           # one shorter prompt
    torch.cuda.synchronize()
    return cfg, model, batches, req


def run_prune(model, batches):
    from vlm_compression_tpu_torch.compression import load_pruner

    pruner = load_pruner("blipt5_wanda_pruner", model, batches,
                         vit_prune_spec="39-0.5-1.0-1.0",
                         t5_prune_spec="24-0.5-1.0-1.0", num_samples=N_CALIB)
    model, _ = pruner.prune(lora_model=True)
    torch.cuda.synchronize()
    return model


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


def main_path():
    from vlm_compression_tpu_torch.models.bridge import export_masks
    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    t0 = time.perf_counter()
    cfg, model, batches, req = xl_setup(seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model: InstructBLIP-FlanT5-XL, {n_params / 1e9:.3f} B params, "
        f"bf16, random init + data {time.perf_counter() - t0:.1f} s; cuts: "
        f"none (depth 39/24/24, {N_CALIB} calibration samples)")
    torch.cuda.reset_peak_memory_stats()

    counts = {}
    ML.launches = A.launches = 0
    t0 = time.perf_counter()
    model = run_prune(model, batches)
    t_prune = time.perf_counter() - t0
    counts["prune"] = {"masked_matmul": ML.launches,
                       "flash_attention": A.launches}
    masks = export_masks(model)
    for tower in ("visual_encoder", "t5_model.encoder", "t5_model.decoder"):
        ms = [m for p, m in masks.items() if ".".join(p).startswith(tower)]
        dens = sum(int(m.sum()) for m in ms) / sum(m.size for m in ms)
        log(f"  prune density {tower}: {dens:.4f} over {len(ms)} linears")
        if abs(dens - 0.5) > 0.01:
            raise AssertionError(f"density {tower}")
    if len(masks) != 39 * 4 + 24 * 7 + 24 * 11:
        raise AssertionError(f"{len(masks)} masked linears")
    log(f"  prune (blipt5_wanda_pruner, lora_model=True): {t_prune:.2f} s")

    # the first call pays one-time costs (lazy kernel-module loads, the
    # allocator growing); the second is the steady-state request
    t_gen, outs = {}, {}
    for phase in ("generate_cold", "generate_warm"):
        ML.launches = A.launches = 0
        t0 = time.perf_counter()
        seqs, gen_cfg = run_generate(model, req)
        t_gen[phase] = time.perf_counter() - t0
        counts[phase] = {"masked_matmul": ML.launches,
                         "flash_attention": A.launches}
        if tuple(seqs.shape) != (N_REQ, gen_cfg.max_length) or \
                not bool((seqs[:, 0] == 0).all()) or \
                not bool(((seqs >= 0) & (seqs < cfg.t5.vocab_size)).all()):
            raise AssertionError(f"bad generate output {seqs}")
        n_tok = int((seqs[:, 1:] != gen_cfg.pad_token_id).sum())
        outs[phase] = seqs
        log(f"  generate_t5 beam-5 ({phase}), {N_REQ} requests, max_length "
            f"10: {t_gen[phase]:.3f} s, {n_tok} tokens, "
            f"{n_tok / t_gen[phase]:.1f} tokens/s")
    if not torch.equal(outs["generate_cold"], outs["generate_warm"]):
        raise AssertionError("two generate calls on the same inputs differ")
    log(f"  tokens: {seqs.tolist()}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  max_memory_allocated: {peak / 2**30:.2f} GiB")
    log(f"  launches: {json.dumps(counts)}")
    for phase, c in counts.items():
        for kernel, n in c.items():
            if n <= 0:
                raise AssertionError(f"{kernel} never launched in {phase}")
    del model, batches, masks
    torch.cuda.empty_cache()
    return counts, {"prune_s": t_prune,
                    "generate_cold_s": t_gen["generate_cold"],
                    "generate_s": t_gen["generate_warm"],
                    "tokens_per_s": n_tok / t_gen["generate_warm"],
                    "peak_bytes": peak}


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "masked_matmul" in low:
        return "masked_matmul kernel"
    if "flash_fwd" in low:
        return "flash_attention kernel"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet")):
        return "cuBLAS GEMM (dense capture passes)"
    if "sort" in low or "radix" in low:
        return "sort (mask selection)"
    if "reduce" in low:
        return "reductions"
    return "other elementwise/copy"


def device_breakdown(prof, wall_ms: float, label: str) -> None:
    """Device time by kernel group from a torch.profiler trace (device-side
    kernel events only), against the unprofiled wall-clock of the phase."""
    from torch.autograd import DeviceType

    groups, top, total = {}, [], 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t <= 0:
            continue
        total += t / 1e3
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + t / 1e3
        top.append((t / 1e3, e.count, e.key[:70]))
    if total == 0:
        log(f"  [{label}] profiler recorded no device time: not measured")
        return
    log(f"  [{label}] device time {total:.1f} ms over {wall_ms:.1f} ms "
        f"unprofiled wall: device busy {100 * total / wall_ms:.1f}%")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:38s} {t:9.1f} ms  {100 * t / total:5.1f}% of device")
    for t, n, key in sorted(top, reverse=True)[:10]:
        log(f"    top: {t:8.1f} ms  x{n:<6d} {key}")


def profile_main_path(e2e):
    """The main path once more under torch.profiler (fresh model and data,
    seed 1), for where the device time goes.  Launch counts are not read
    here."""
    from torch.profiler import ProfilerActivity, profile

    _, model, batches, req = xl_setup(seed=1)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        model = run_prune(model, batches)
    device_breakdown(prof, 1e3 * e2e["prune_s"], "prune")
    with profile(activities=acts) as prof:
        run_generate(model, req)
    device_breakdown(prof, 1e3 * e2e["generate_s"], "generate")
    del model, batches
    torch.cuda.empty_cache()


def timing():
    import torch.nn.functional as F

    from vlm_compression_tpu_torch.ops import attention as A
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    rows = {}
    bf16 = torch.bfloat16
    for name, m, k, n in MM_SHAPES:
        x, w, mask = mm_inputs(m, k, n, bf16)
        wm = w * mask
        ms = device_ms(lambda: ML.masked_matmul(x, w, mask))
        plain = device_ms(lambda: ML.masked_matmul_ref(x, w, mask))
        lib = device_ms(lambda: torch.matmul(x, wm))
        bound, by = mm_bound_ms(m, k, n)
        rows[("masked_matmul", name)] = (ms, plain, lib, bound, by)
        log(f"  time masked_matmul {name:22s} M={m} K={k} N={n}: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"torch.matmul(x, W*mask) {lib:.4f} ms, bound {bound:.4f} ms "
            f"({by})")
    for name, b, n, m, h, d, kinds, scale in FLASH_SHAPES:
        q, k_, v, biases = flash_inputs(b, n, m, h, d, kinds, bf16)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k_, v))
        bsum = None
        for x in biases:
            bsum = x if bsum is None else bsum + x
        bsum = None if bsum is None else bsum.expand(b, h, n, m).to(bf16)
        ms = device_ms(lambda: A.attention_core(q, k_, v, biases, scale))
        plain = device_ms(lambda: A.mha_reference(q, k_, v, biases, scale))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bsum, scale=scale))
        bound, by = flash_bound_ms(q, k_, v, biases)
        rows[("flash_attention", name)] = (ms, plain, lib, bound, by)
        log(f"  time flash_attention {name:22s} b={b} n={n} m={m} h={h} "
            f"d={d}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa {lib:.4f} ms, bound {bound:.4f} ms ({by})")
    return rows


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[device] {name} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _cuda.build()
    log(f"[build] {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.1f} s")

    log("[kernels] kernel vs plain version")
    worst = check_kernels()
    log("[reference] tiny model, card vs CPU")
    tiny_reference_check()
    log("[main path] InstructBLIP-FlanT5-XL: Wanda prune + beam-5 generate")
    counts, e2e = main_path()
    log("[profile] the main path again under torch.profiler")
    profile_main_path(e2e)
    log("[timing] bf16, median of 20 calls, CUDA events, L2 flushed before "
        "each call")
    rows = timing()

    kernels = []
    for kname, timed, src, repl in (
            ("masked_matmul", MM_TIMED,
             "vlm_compression_tpu_torch/csrc/masked_matmul.cu",
             "vlm_compression_tpu/ops/masked_linear.py:67"),
            ("flash_attention", FLASH_TIMED,
             "vlm_compression_tpu_torch/csrc/flash_attention.cu",
             "vlm_compression_tpu/ops/attention.py:107")):
        ms, plain, lib, bound, by = rows[(kname, timed)]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": repl,
            "launches": sum(c[kname] for c in counts.values()),
            "launches_by_phase": {p: c[kname] for p, c in counts.items()},
            "max_abs_err": worst[(kname, timed, torch.bfloat16)],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib, "shape": timed})
    log(f"[e2e] {json.dumps(e2e)}  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
