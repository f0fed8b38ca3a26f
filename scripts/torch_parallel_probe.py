"""What the process-group backends take when two ranks share one card.

Run on a machine with one GPU, from the repository root:

    python3 scripts/torch_parallel_probe.py

Spawns two ranks (``parallel.collectives.spawn``) on device 0 three
times: with NCCL (an all-reduce of a CUDA tensor; NCCL is expected to
refuse two ranks on one device); with gloo on CUDA tensors (all-reduce,
all-gather, broadcast) and a send / recv staged through the host; and
with gloo, a send / recv of a CUDA tensor (a group of its own: a rank may
abort on it).  Prints one JSON object: per group and operation "ok" or
the error's first line.
"""

import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _first_line(exc) -> str:
    return f"{type(exc).__name__}: {str(exc).strip().splitlines()[0][:200]}" \
        if str(exc).strip() else type(exc).__name__


def probe_rank(rank, world, backend, what="collectives"):
    torch.cuda.set_device(0)
    out = {}
    t = torch.full((4,), float(rank + 1), device="cuda")

    def p2p(host: bool):
        x = torch.arange(4.0, device="cuda")
        if host:
            x = x.cpu()
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(x, 0)

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as exc:        # reported, not raised: a probe
            out[name] = _first_line(exc)

    if what == "send_recv_cuda":
        attempt("send_recv_cuda", lambda: p2p(False))
        return out
    attempt("all_reduce", lambda: dist.all_reduce(t))
    if backend == "nccl":
        return out
    parts = [torch.empty_like(t) for _ in range(world)]
    attempt("all_gather", lambda: dist.all_gather(parts, t))
    attempt("broadcast", lambda: dist.broadcast(t, 0))
    attempt("send_recv_host", lambda: p2p(True))
    return out


def main() -> int:
    from vlm_compression_tpu_torch.parallel.collectives import spawn

    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    for label, backend, what in (("nccl", "nccl", "collectives"),
                                 ("gloo", "gloo", "collectives"),
                                 ("gloo_cuda_p2p", "gloo", "send_recv_cuda")):
        with tempfile.TemporaryDirectory() as tmp:
            try:
                outs = spawn(probe_rank, 2, backend,
                             os.path.join(tmp, "init"), 60.0,
                             args=(backend, what))
                report[label] = outs[1]
            except RuntimeError as exc:
                report[label] = {"spawn": " ".join(str(exc).split())[-300:]}
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
