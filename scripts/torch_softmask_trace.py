#!/usr/bin/env python3
"""Where the soft-mask anneal's time goes on the card, at FlanT5-XL's and
EVA-ViT-g's linear shapes.

    python3 scripts/torch_softmask_trace.py [--steps 48] [--trace-steps 4]

For each group of equal-shape linears the pruner anneals together (the
ViT's qkv, proj, fc1 and fc2 alone; T5's q/k/v/o as one group of 4 in the
encoder and 8 in the decoder, wi_0/wi_1 as one of 2, wo alone) it times
``ops/softmask.softmask_nm_prune_batched`` (2:4) on seeded random weights
and a seeded (2/N) XᵀX Hessian, CUDA events around the call, beside the
three float32 products a step would take alone (``torch.bmm``, TF32 off)
and the achieved rate.  One group is traced with ``torch.profiler`` for
``--trace-steps`` steps: device time by kernel name.  Last, ``hard_topn``
(m × m comparisons) is held bit-equal to, and timed against, the JAX
package's double stable argsort on ties and on random logits.  Prints one
JSON line per group, the profile's top kernels and the rank A/B.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])

# (name, G, units, in): the equal-shape groups of one block
GROUPS = [("vit_qkv", 1, 4224, 1408), ("vit_proj", 1, 1408, 1408),
          ("vit_fc1", 1, 6144, 1408), ("vit_fc2", 1, 1408, 6144),
          ("t5_enc_qkvo", 4, 2048, 2048), ("t5_dec_qkvo", 8, 2048, 2048),
          ("t5_wi", 2, 5120, 2048), ("t5_wo", 1, 2048, 5120)]


def problem(g, u, k, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(g, u, k, generator=gen, device="cuda")
    x = torch.randn(g, 2048, k, generator=gen, device="cuda")
    h = torch.bmm(x.transpose(1, 2), x) * (2.0 / 2048)
    return w, h


def events(fn, reps=1):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--trace-steps", type=int, default=4)
    ap.add_argument("--trace", default="vit_fc2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from vlm_compression_tpu_torch.ops.softmask import (
        softmask_nm_prune_batched,
    )

    total = 0.0
    for name, g, u, k in GROUPS:
        w, h = problem(g, u, k)
        softmask_nm_prune_batched(w, h, 2, 4, steps=2)      # warm up
        ms = events(lambda: softmask_nm_prune_batched(w, h, 2, 4,
                                                      steps=args.steps))
        d = torch.randn_like(w)
        mm = events(lambda: torch.bmm(d, h), reps=5)
        flops = 3 * args.steps * 2 * g * u * k * k
        total += ms
        print(json.dumps({
            "group": name, "G": g, "units": u, "in": k,
            "steps": args.steps, "anneal_ms": ms,
            "ms_a_step": ms / args.steps, "bmm_ms": mm,
            "three_bmm_share": 3 * args.steps * mm / ms,
            "tflops": flops / ms / 1e9,
            "bmm_tflops": 2 * g * u * k * k / mm / 1e9}), flush=True)
        if name == args.trace:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                softmask_nm_prune_batched(w, h, 2, 4,
                                          steps=args.trace_steps)
                torch.cuda.synchronize()
            by = {}
            for e in prof.key_averages():
                dev = getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
                if dev > 0:
                    by[e.key] = by.get(e.key, 0) + dev
            top = sorted(by.items(), key=lambda kv: -kv[1])[:15]
            print(json.dumps({"trace": name, "steps": args.trace_steps,
                              "device_us_by_kernel": top}), flush=True)
        del w, h, d
        torch.cuda.empty_cache()
    print(json.dumps({"sum_of_groups_ms": total}))

    # the hard mask's rank: the port's m × m comparisons against the JAX
    # package's double stable argsort (kept here as the reference)
    from vlm_compression_tpu_torch.ops.softmask import hard_topn

    def by_sorts(lg, n):
        order = torch.argsort(torch.argsort(-lg, dim=-1, stable=True),
                              dim=-1, stable=True)
        return order < n

    gen = torch.Generator(device="cuda").manual_seed(1)
    lg = torch.randint(0, 3, (1, 1408, 1536, 4), generator=gen,
                       device="cuda").float()
    same = bool(torch.equal(hard_topn(lg, 2), by_sorts(lg, 2)))
    lg = torch.randn(1, 1408, 1536, 4, generator=gen, device="cuda")
    same &= bool(torch.equal(hard_topn(lg, 2), by_sorts(lg, 2)))
    print(json.dumps({
        "hard_topn_shape": list(lg.shape), "equal": same,
        "sorts_ms": events(lambda: by_sorts(lg, 2), reps=10),
        "comparisons_ms": events(lambda: hard_topn(lg, 2), reps=10)}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"wall {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
