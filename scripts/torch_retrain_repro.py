#!/usr/bin/env python3
"""Does the full-width RESSA retrain reproduce from call to call?  Two KD
steps from one saved state, twice, on each bf16 attention-backward route,
in one process on one CUDA card.

    python3 scripts/torch_retrain_repro.py <checkout root> <label>

Imports ``chip_smoke`` and ``vlm_compression_tpu_torch`` from the given
checkout root (its kernels build into that checkout's ``build/``), so that
two checkouts can be compared in one call.  Builds chip_smoke's
full-width InstructBLIP-FlanT5-XL (seed 0, SparseLoRA adapters), prunes it
with Wanda as the main path does, and saves the LoRA factors.  Then, once
on the route ``ops/attention.plan`` picks (bf16: the TMA + wgmma kernel)
and once with every bf16 backward sent to the mma.sync kernels (``plan``
replaced by one that answers MMA, as ``_impl=MMA`` forces a single call):
restore the saved factors and a fresh AdamW, run two KD steps at the
retrain batch (chip_smoke's TRAIN_BS, its first two learning rates), keep
the LoRA leaves; again; and print, for each route, how many leaves and
entries differ between the two runs and the largest difference, one
``[repro <label>]`` line per route.  chip_smoke's retrain phase replays
the planned route alone; the mma.sync run here is what tells a cause in
the Hopper backward from one elsewhere in the step.
"""

import sys

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from vlm_compression_tpu_torch.common.optims import (  # noqa: E402
    make_lr_scheduler,
)
from vlm_compression_tpu_torch.ops import attention as A  # noqa: E402
from vlm_compression_tpu_torch.tasks.retrain import (  # noqa: E402
    RessaTrainState,
    make_kd_train_step,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

cfg, model, batches, _ = CS.xl_setup(seed=0)
model, _ = CS.run_prune(model, batches)
del batches
state = RessaTrainState.create(model, weight_decay=CS.WEIGHT_DECAY)
step = make_kd_train_step(model, state.opt, CS.KL_WEIGHT, CS.T_KD)
sched = make_lr_scheduler(CS.SCHED)
gen = torch.Generator(device="cuda").manual_seed(7)
kd = CS.synthetic_batches(cfg, 2, CS.TRAIN_BS, gen)
saved = {n: p.detach().clone() for n, p in state.lora.items()}


def two_steps() -> dict:
    """The saved factors and a fresh AdamW, then two KD steps."""
    with torch.no_grad():
        for n, p in state.lora.items():
            p.copy_(saved[n])
    state.opt.zero_grad(set_to_none=True)
    state.opt.state.clear()
    for i, batch in enumerate(kd):
        step(batch, sched(0, i))
    torch.cuda.synchronize()
    return {n: p.detach().clone() for n, p in state.lora.items()}


planned = A.plan
for route in ("planned", "mma"):
    if route == "mma":
        A.plan = lambda n, m, d, *, bf16=True, aligned=True: (
            A.MMA if bf16 else A.FP32)
    launches = A.bwd_wgmma_launches, A.dq_launches
    first, second = two_steps(), two_steps()
    wg, mma = (a - b for a, b in zip((A.bwd_wgmma_launches, A.dq_launches),
                                     launches))
    leaves = [n for n in first if not torch.equal(first[n], second[n])]
    entries = sum(int((first[n] != second[n]).sum()) for n in leaves)
    top = max((float((first[n].float() - second[n].float()).abs().max())
               for n in leaves), default=0.0)
    print(f"[repro {label}] {route}: {len(leaves)} of {len(first)} LoRA "
          f"leaves differ ({entries} entries, max |diff| {top:.3e}) between "
          f"two runs of two KD steps at batch {CS.TRAIN_BS}; attention "
          f"backward launches: TMA + wgmma {wg}, mma.sync dq {mma}",
          flush=True)
    A.plan = planned
