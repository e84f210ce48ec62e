"""What a gloo process group answers for CUDA tensors, two ranks on one card.

NCCL refuses two ranks on one card ("Duplicate GPU detected"), so a mesh of
processes that shares one card can only run on gloo. This script spawns two
processes on card 0, joins them in a gloo group over a ``file://`` store
and tries, on CUDA tensors: ``all_reduce`` SUM and MAX in float32 and
bfloat16, ``broadcast``, ``all_gather`` (a list),
``all_gather_into_tensor`` and ``all_to_all_single``. Each answer is a
JSON line on rank 0: ``ok`` with the largest error against the exact
result, or the error's type and first line.

  python3 tools/torch_gloo_cuda_probe.py

Exits non-zero without a card.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2
N = 1 << 20


def _try(name, fn, out):
    try:
        err = fn()
        out[name] = {"ok": True, "max_abs_err": err}
    except Exception as e:  # noqa: BLE001 - the answer is what it raised
        out[name] = {"ok": False, "error": type(e).__name__,
                     "message": str(e).splitlines()[0][:300]}


def _rank(rank, store, path):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {"backend": dist.get_backend()}

    def reduce(op, dtype):
        def run():
            x = torch.arange(N, device=dev, dtype=torch.float32) % 251
            mine = (x + rank).to(dtype)
            y = mine.clone()
            dist.all_reduce(y, op=getattr(dist.ReduceOp, op))
            parts = [(x + r).to(dtype).float() for r in range(WORLD)]
            want = sum(parts) if op == "SUM" else torch.stack(parts).amax(0)
            assert y.device == dev and y.dtype == dtype
            return float((y.float() - want).abs().max())
        return run

    for op in ("SUM", "MAX"):
        for dtype in (torch.float32, torch.bfloat16):
            _try(f"all_reduce {op} {str(dtype)[6:]}", reduce(op, dtype), out)

    def broadcast():
        y = torch.full((N,), float(rank + 1), device=dev)
        dist.broadcast(y, src=0)
        return float((y - 1.0).abs().max())

    def gather_list():
        x = torch.full((N,), float(rank), device=dev)
        parts = [torch.empty_like(x) for _ in range(WORLD)]
        dist.all_gather(parts, x)
        return max(float((p - r).abs().max()) for r, p in enumerate(parts))

    def gather_into():
        x = torch.full((N,), float(rank), device=dev)
        y = torch.empty((WORLD * N,), device=dev)
        dist.all_gather_into_tensor(y, x)
        return max(float((y[r * N:(r + 1) * N] - r).abs().max())
                   for r in range(WORLD))

    def all_to_all():
        x = torch.arange(WORLD * N, device=dev, dtype=torch.float32) \
            + rank * WORLD * N
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        want = torch.cat([torch.arange(rank * N, (rank + 1) * N, device=dev,
                                       dtype=torch.float32) + r * WORLD * N
                          for r in range(WORLD)])
        return float((y - want).abs().max())

    _try("broadcast", broadcast, out)
    _try("all_gather", gather_list, out)
    _try("all_gather_into_tensor", gather_into, out)
    _try("all_to_all_single", all_to_all, out)
    torch.cuda.synchronize()
    if rank == 0:
        with open(path, "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    tmp = tempfile.mkdtemp(prefix="gloo_probe_")
    path = os.path.join(tmp, "out.json")
    mp.start_processes(_rank, args=(os.path.join(tmp, "store"), path),
                       nprocs=WORLD, start_method="spawn")
    with open(path) as f:
        out = json.load(f)
    print(json.dumps({"torch": torch.__version__,
                      "device": torch.cuda.get_device_name(0), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
