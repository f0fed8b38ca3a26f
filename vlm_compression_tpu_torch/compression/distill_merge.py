"""Layer distillation by merging, and importance-guided unstructured
pruning (port of ``vlm_compression_tpu/compression/distill_merge.py``).

  * ``parse_block_ids`` / ``parse_block_weights``: ``"0,1;2-4;5"`` groups
    and their merge weights;
  * ``merge_tower_blocks``: each group of ``blocks_<i>`` merged into one
    block (weighted sum; bool masks by OR), optionally after aligning each
    later block's FFN hidden units to the group's first
    (``permute_block_like``: a linear assignment on the units' weight
    vectors), and gated by a regex on the in-block names;
  * ``prune_by_importance``: the ``unstrct`` inits, zeroing the
    lowest-scored weights of each scored parameter.

The merge works on a tower's state dict (the port's dotted names,
``blocks_3.mlp.fc1.kernel``).  The regex is matched against the JAX
package's '/'-joined in-block name (``mlp/fc1/kernel``), so one regex
selects the same leaves in both packages.  The port keeps Flax's (in, out)
kernel layout, so the FFN hidden dim is axis 1 of an up kernel and axis 0
of a down kernel, as there.  The merge is a one-time transformation of
weights and runs where the tensors lie.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def parse_block_ids(spec: str) -> List[List[int]]:
    """'0,1;2,3;4' → [[0,1],[2,3],[4]]; '0-3;4-7' ranges too."""
    groups = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        ids: List[int] = []
        for tok in part.split(","):
            tok = tok.strip()
            if "-" in tok:
                a, b = tok.split("-")
                ids.extend(range(int(a), int(b) + 1))
            else:
                ids.append(int(tok))
        groups.append(ids)
    return groups


def parse_block_weights(spec: Optional[str], groups: List[List[int]]
                        ) -> List[List[float]]:
    """Per-group merge weights; uniform by default."""
    if not spec:
        return [[1.0 / len(g)] * len(g) for g in groups]
    out = []
    for part, g in zip(spec.split(";"), groups):
        ws = [float(t) for t in part.split(",")]
        if len(ws) != len(g):
            raise ValueError(f"weights {ws} do not match group {g}")
        out.append(ws)
    return out


def _assign(cost: np.ndarray) -> np.ndarray:
    """Min-cost assignment (rows → cols)."""
    from scipy.optimize import linear_sum_assignment

    _, cols = linear_sum_assignment(cost)
    return cols


def _ffn_permutation(ref: Dict[str, torch.Tensor],
                     other: Dict[str, torch.Tensor], up_key: str,
                     down_key: str) -> Optional[np.ndarray]:
    """Permutation of the FFN hidden dim aligning ``other`` to ``ref``
    (state dicts of one FFN container), or None when a key is missing.
    Similarity: the cosine of the units' concatenated up and down weight
    vectors, in float32 where the weights lie; the assignment on the
    host."""
    try:
        ru, rd, ou, od = (d[k + ".kernel"].detach().float()
                          for d, k in ((ref, up_key), (ref, down_key),
                                       (other, up_key), (other, down_key)))
    except KeyError:
        return None
    rvec = torch.cat([ru.T, rd], dim=1)              # (hidden, in+out)
    ovec = torch.cat([ou.T, od], dim=1)
    rn = rvec / (torch.linalg.vector_norm(rvec, dim=1, keepdim=True) + 1e-8)
    on = ovec / (torch.linalg.vector_norm(ovec, dim=1, keepdim=True) + 1e-8)
    return _assign((-(rn @ on.T)).cpu().numpy())     # maximise similarity


def _apply_ffn_permutation(block: Dict[str, torch.Tensor], perm: np.ndarray,
                           up_keys: Sequence[str], down_key: str
                           ) -> Dict[str, torch.Tensor]:
    """The FFN container's state with its hidden units permuted: columns
    of the up kernels, biases and masks, rows of the down kernel and
    mask."""
    block = dict(block)
    for key, leaf in list(block.items()):
        lin, _, name = key.rpartition(".")
        p = torch.as_tensor(perm, device=leaf.device)
        if lin in up_keys and name in ("kernel", "mask"):
            block[key] = leaf[:, p]
        elif lin in up_keys and name == "bias":
            block[key] = leaf[p]
        elif lin == down_key and name in ("kernel", "mask"):
            block[key] = leaf[p, :]
    return block


_FFN_LAYOUTS = (
    # (container path in block, up keys, down key)
    (("mlp",), ("fc1",), "fc2"),                # EVA ViT
    (("ffn",), ("wi_0", "wi_1"), "wo"),         # T5 gated
)


def _split(state: Dict[str, torch.Tensor], prefix: str):
    """(the entries under ``prefix.`` with it stripped, the rest)."""
    head = prefix + "."
    inner = {k[len(head):]: v for k, v in state.items()
             if k.startswith(head)}
    return inner, {k: v for k, v in state.items() if not k.startswith(head)}


def permute_block_like(ref_block: Dict[str, torch.Tensor],
                       block: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """``block``'s FFN hidden units aligned to ``ref_block``'s (block state
    dicts); unchanged when no layout is recognised."""
    for path, up_keys, down_key in _FFN_LAYOUTS:
        prefix = ".".join(path)
        node_r, _ = _split(ref_block, prefix)
        node_o, rest = _split(block, prefix)
        if not (node_r and node_o):
            continue
        perm = _ffn_permutation(node_r, node_o, up_keys[0], down_key)
        if perm is None:
            continue
        inner = _apply_ffn_permutation(node_o, perm, up_keys, down_key)
        return {**rest, **{f"{prefix}.{k}": v for k, v in inner.items()}}
    return block


def merge_tower_blocks(tower_state: Dict[str, torch.Tensor],
                       block_ids: List[List[int]],
                       block_weights: Optional[List[List[float]]] = None,
                       modules_to_merge: str = ".*",
                       permute: bool = False,
                       block_prefix: str = "blocks_"
                       ) -> Dict[str, torch.Tensor]:
    """Merge groups of ``<block_prefix><i>`` blocks of a tower's state dict
    into one block each.

    Returns a new state dict with ``len(block_ids)`` blocks numbered from
    0; entries outside the blocks pass through, and the blocks in no group
    are dropped.  A float leaf is the weighted sum of the group's leaves
    (in float32, cast back); a bool mask keeps where any block keeps.  A
    leaf whose '/'-joined in-block name does not match
    ``modules_to_merge`` takes the group's first block's value."""
    pat = re.compile(modules_to_merge)
    weights = block_weights or [[1.0 / len(g)] * len(g) for g in block_ids]
    blocks: Dict[int, Dict[str, torch.Tensor]] = {}
    out = {}
    for key, leaf in tower_state.items():
        head, _, inner = key.partition(".")
        if head.startswith(block_prefix) and \
                head[len(block_prefix):].isdigit():
            blocks.setdefault(int(head[len(block_prefix):]), {})[inner] = leaf
        else:
            out[key] = leaf

    aligned = {}
    if permute:
        # each later block aligned to its group's first; the assignments
        # are independent and release the GIL, so they run in threads
        def align(job):
            group = block_ids[job[0]]
            return permute_block_like(blocks[group[0]], blocks[group[job[1]]])

        jobs = [(g, j) for g, group in enumerate(block_ids)
                for j in range(1, len(group))]
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            aligned = dict(zip(jobs, pool.map(align, jobs)))
    for new_i, (group, ws) in enumerate(zip(block_ids, weights)):
        members = [aligned.get((new_i, j), blocks[i])
                   for j, i in enumerate(group)]
        for name, first in members[0].items():
            leaves = [b[name] for b in members]
            if not pat.search(name.replace(".", "/")):
                merged = first
            elif first.dtype == torch.bool:    # masks: keep where any keeps
                merged = leaves[0]
                for leaf in leaves[1:]:
                    merged = merged | leaf
            else:
                acc = 0
                for w, leaf in zip(ws, leaves):
                    acc = acc + w * leaf.float()
                merged = acc.to(first.dtype)
            out[f"{block_prefix}{new_i}.{name}"] = merged
    return out


@torch.no_grad()
def prune_by_importance(module: torch.nn.Module,
                        scores: Dict[Path, torch.Tensor],
                        keep_ratio: float
                        ) -> Tuple[torch.nn.Module, Dict[Path, torch.Tensor]]:
    """Zero the round(size·(1 − keep_ratio)) lowest-importance entries of
    each scored parameter of ``module`` (keys: parameter paths relative to
    it), in place; returns (module, {path: the zeroed flat indices, sorted,
    int32}).  The select is a per-leaf k-smallest (``torch.topk``) on the
    parameter's own device; which of tied scores go is unspecified, as in
    the JAX package's ``np.argpartition``."""
    params = dict(module.named_parameters())
    pruned = {}
    for path, imp in scores.items():
        leaf = params[".".join(path)]
        flat_imp = torch.as_tensor(imp).to(device=leaf.device,
                                           dtype=torch.float32).reshape(-1)
        k_prune = int(round(flat_imp.numel() * (1.0 - keep_ratio)))
        if k_prune <= 0:
            continue
        idx = torch.topk(flat_imp, k_prune, largest=False,
                         sorted=False).indices
        leaf.view(-1)[idx] = 0
        pruned[path] = torch.sort(idx).values.to(torch.int32)
    return module, pruned


def _base_params(module: torch.nn.Module):
    """The parameters of JAX's ``params`` collection: all but the LoRA
    factors (JAX's ``lora`` collection)."""
    return [p for n, p in module.named_parameters()
            if not n.rpartition(".")[2].startswith("lora_")]


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in _base_params(module))


def count_nonzero(module: torch.nn.Module) -> int:
    """Non-zero entries of the floating parameters."""
    return sum(int(torch.count_nonzero(p)) for p in _base_params(module)
               if p.is_floating_point())
