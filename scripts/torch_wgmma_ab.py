#!/usr/bin/env python3
"""Time one of the Hopper (TMA + wgmma) kernels in one checkout, so that
two checkouts can be compared on one card.

    python3 scripts/torch_wgmma_ab.py <checkout root> <label> [target]

Imports ``chip_smoke`` and ``vlm_compression_tpu_torch`` from the given
checkout root (its kernels build into that checkout's ``build/``) and
prints one line, ``[<target> <label>]``.  Run the two checkouts in turns in
one call (A, B, B, A), as the comparison of two versions on one card asks.
The targets:

- ``matmul`` (the default): the bool-mask matmul at ViT fc1 and qkv
  calibration, T5 wi calibration and ViT fc1 prefill, and the sparse-LoRA
  matmul at ViT fc1 training (r = 4) — shapes whose output tiles fill the
  card, so the loop runs unsplit in every version that has it;
- ``bwd``: the bf16 attention backward (dq, dk and dv), forced onto the
  TMA + wgmma route, at every ``BWD_SHAPES`` shape and at the ViT's,
  the Q-Former cross-attention's and the T5 encoder's shapes at smaller
  batches (the diagonal Fisher's 1 among them); then, at the T5 encoder's
  position bias ((1, 32, 72, 72) at batch 16 and 1), the backward with the
  bias's gradient — one call with ``dbias_of`` where the checkout has it,
  else the backward followed by ``flash_attention_dbias`` — and the
  backward without it;
- ``bwd128``: the same backward at LLaMA's d = 128 alone: the Vicuna
  retrain's ``llama_self`` (b 32, n = m = 72, its causal + pad bias), the
  same at batch 8, and four q and kv tiles (b 8, n = m = 200, h 32);
- ``fisher``: chip_smoke's full-width InstructBLIP-FlanT5-XL (seed 2,
  dense, as its first-order path builds it), ``get_data_derivative``
  (power 2) once on one batch-1 sample to warm up, then on 4 samples under
  torch.profiler (device activity only): the device time a sample of every
  attention-backward kernel group (chip_smoke's ``_kernel_group``), their
  sum, and the whole Fisher's device time a sample.

``matmul`` and ``bwd`` give ``device_ms`` (median of 20 calls, L2 flushed,
host enqueue covered) for each shape, from the ``chip_smoke.py`` beside
this script, so that every checkout is timed by the same harness.
"""

import importlib.util
import inspect
import sys
import time
from pathlib import Path

root, label = sys.argv[1], sys.argv[2]
target = sys.argv[3] if len(sys.argv) > 3 else "matmul"
sys.path.insert(0, root)

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "timing", Path(__file__).resolve().parents[1] / "chip_smoke.py")
timing = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(timing)
device_ms = timing.device_ms

torch.backends.cuda.matmul.allow_tf32 = False
bf16 = torch.bfloat16

# the backward's shapes besides BWD_SHAPES: smaller batches of the ViT's,
# the Q-Former cross-attention's and the T5 encoder's
BWD_BATCHES = [
    (f"vit_self_b{b}", b, 257, 257, 16, 88, [], 88 ** -0.5)
    for b in (1, 2, 4, 8, 16)] + [
    (f"qformer_cross_b{b}", b, 32, 257, 12, 64, ["pad"], 0.125)
    for b in (1, 8)] + [
    ("t5_encoder_b1", 1, 72, 72, 32, 64, ["rel", "pad"], 1.0)]


def matmul():
    from vlm_compression_tpu_torch.ops import masked_linear as ML

    out = []
    for name, m, k, n in [("vit_fc1_calib", 32896, 1408, 6144),
                          ("vit_qkv_calib", 32896, 1408, 4224),
                          ("t5_wi_calib", 9216, 2048, 5120),
                          ("vit_fc1_prefill", 1028, 1408, 6144)]:
        x, w, mask = CS.mm_inputs(m, k, n, bf16)
        before = ML.wgmma_launches
        ML.masked_matmul(x, w, mask)
        assert ML.wgmma_launches == before + 1, "not on the Hopper loop"
        ms = device_ms(lambda: ML.masked_matmul(x, w, mask))
        out.append(f"{name} {ms:.4f}")
    x, w, mask, a, b = CS.lora_inputs(8224, 1408, 6144, 4, bf16)
    ms = device_ms(lambda: ML.sparse_lora_matmul(x, w, mask, a, b, 4.0))
    out.append(f"lora_vit_fc1 {ms:.4f}")
    return out


def bwd():
    from vlm_compression_tpu_torch.ops import attention as A

    fused = "dbias_of" in inspect.signature(
        A.flash_attention_backward).parameters
    out = []
    for name, b, n, m, h, d, kinds, scale in CS.BWD_SHAPES + BWD_BATCHES:
        if A.plan(n, m, d) != A.WGMMA:     # off the route in this checkout
            continue
        q, k, v, biases = CS.flash_inputs(b, n, m, h, d, kinds, bf16)
        g = CS.grad_like(q)
        o, lse = A.flash_attention(q, k, v, biases, scale)
        args = (q, k, v, o, lse, g, biases, scale)
        ms = device_ms(lambda: A.flash_attention_backward(
            *args, _impl=A.WGMMA))
        out.append(f"{name} {ms:.4f}")
    for name, b in (("t5_bias_b16", 16), ("t5_bias_b1", 1)):
        q, k, v, biases = CS.flash_inputs(b, 72, 72, 32, 64, ["rel", "pad"],
                                          bf16)
        g = CS.grad_like(q)
        o, lse = A.flash_attention(q, k, v, biases, 1.0)
        args = (q, k, v, o, lse, g, biases, 1.0)
        if fused:
            with_db = device_ms(lambda: A.flash_attention_backward(
                *args, dbias_of=(0,)))
        else:
            with_db = device_ms(lambda: (
                A.flash_attention_backward(*args),
                A.flash_attention_dbias(q, k, v, o, lse, g, biases, 0, 1.0)))
        alone = device_ms(lambda: A.flash_attention_backward(*args))
        out.append(f"{name} with dbias {with_db:.4f} alone {alone:.4f}")
    return out


def bwd128():
    from vlm_compression_tpu_torch.ops import attention as A

    out = []
    for name, b, n, m, h in (("llama_self", 32, 72, 72, 32),
                             ("llama_self_b8", 8, 72, 72, 32),
                             ("llama_cpad_200", 8, 200, 200, 32)):
        q, k, v, biases = CS.flash_inputs(b, n, m, h, 128, ["cpad"], bf16)
        g = CS.grad_like(q)
        o, lse = A.flash_attention(q, k, v, biases, 128 ** -0.5)
        args = (q, k, v, o, lse, g, biases, 128 ** -0.5)
        ms = device_ms(lambda: A.flash_attention_backward(
            *args, _impl=A.WGMMA))
        out.append(f"{name} {ms:.4f}")
    return out


def fisher():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vlm_compression_tpu_torch.compression.derivatives import (
        get_data_derivative,
    )

    n_samples = 4
    _, model, batches, _ = CS.xl_setup(seed=2, lora=False)
    samples = [{k: v[i:i + 1] for k, v in batches[0].items()}
               for i in range(n_samples + 1)]
    del batches
    get_data_derivative(model, samples[:1], power=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        get_data_derivative(model, samples[1:], power=2)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    groups, total = {}, 0.0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        ms = e.duration_ns() / 1e6
        total += ms
        g = CS._kernel_group(e.name())
        if g.startswith("flash_attention_bwd"):
            groups[g] = groups.get(g, 0.0) + ms
    bwd_ms = sum(groups.values())
    return [f"attention backward {bwd_ms / n_samples:.4f} ms of device a "
            f"sample ({100 * bwd_ms / total:.2f} % of the Fisher's "
            f"{total / n_samples:.3f} ms a sample; wall "
            f"{1e3 * wall / n_samples:.1f} ms a sample, profiled); by group, "
            f"ms a sample: " + ", ".join(f"{g} {ms / n_samples:.4f}"
                                         for g, ms in sorted(groups.items()))]


TARGETS = {"matmul": matmul, "bwd": bwd, "bwd128": bwd128, "fisher": fisher}

if __name__ == "__main__":
    print(f"[{target} {label}] " + ", ".join(TARGETS[target]()), flush=True)
