#!/usr/bin/env python3
"""Time the Hopper (TMA + wgmma) matmul loop's unsplit bf16 shapes in one
checkout, so that two checkouts can be compared on one card.

    python3 scripts/torch_wgmma_ab.py <checkout root> <label>

Imports ``chip_smoke`` and ``vlm_compression_tpu_torch`` from the given
checkout root (its kernels build into that checkout's ``build/``), runs
the bool-mask matmul at ViT fc1 and qkv calibration, T5 wi calibration
and ViT fc1 prefill, and the sparse-LoRA matmul at ViT fc1 training
(r = 4) — shapes whose output tiles fill the card, so the loop runs
unsplit in every version that has it — and prints one line, ``[ab
<label>]``, of chip_smoke's ``device_ms`` for each (median of 20 calls, L2
flushed).  Run the two checkouts in turns in one call (A, B, B, A), as the
comparison of two versions on one card asks.
"""

import sys

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from vlm_compression_tpu_torch.ops import masked_linear as ML  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
out = []
for name, m, k, n in [("vit_fc1_calib", 32896, 1408, 6144),
                      ("vit_qkv_calib", 32896, 1408, 4224),
                      ("t5_wi_calib", 9216, 2048, 5120),
                      ("vit_fc1_prefill", 1028, 1408, 6144)]:
    x, w, mask = CS.mm_inputs(m, k, n, torch.bfloat16)
    before = ML.wgmma_launches
    ML.masked_matmul(x, w, mask)
    assert ML.wgmma_launches == before + 1, "not on the Hopper loop"
    ms = CS.device_ms(lambda: ML.masked_matmul(x, w, mask))
    out.append(f"{name} {ms:.4f}")
x, w, mask, a, b = CS.lora_inputs(8224, 1408, 6144, 4, torch.bfloat16)
ms = CS.device_ms(lambda: ML.sparse_lora_matmul(x, w, mask, a, b, 4.0))
out.append(f"lora_vit_fc1 {ms:.4f}")
print(f"[ab {label}] " + ", ".join(out), flush=True)
