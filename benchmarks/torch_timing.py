"""The benchmark twins' clock: seconds per call of a function, on the card
from CUDA events around calls queued behind held device work, on the CPU
from the host clock. ``chip_smoke.py``'s ``time_ms`` holds the card the
same way (:func:`hold_the_card`).

Imported as ``benchmarks.torch_timing``: run the twins from the repo's
root with ``python -m benchmarks.<name>``.
"""
import time

import torch

_BLOCKERS = {}


def hold_the_card(device) -> None:
    """Queue about 3 ms of device work (two large bf16 products, which also
    sweep the L2 cache), so that what the host enqueues next piles up behind
    it and then runs back to back, with no wait for the host in between."""
    dev = torch.device(device)
    big = _BLOCKERS.get(dev)
    if big is None:
        big = _BLOCKERS[dev] = torch.ones((8192, 8192), dtype=torch.bfloat16,
                                          device=dev)
    torch.mm(big, big)
    torch.mm(big, big)


def seconds_per_call(fn, device, iters: int) -> float:
    """Seconds per call of ``fn`` over ``iters`` calls, after one warm call.

    On a CUDA device the calls are enqueued while the card is held busy
    (:func:`hold_the_card`) and bracketed by two CUDA events, so the time is
    the card's for as long as the host enqueues the calls faster than the
    held work drains: device time for a few short calls, host time for a
    path whose host work outlasts its device work (many small launches). On
    the CPU, the host clock."""
    dev = torch.device(device)
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_the_card(dev)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
