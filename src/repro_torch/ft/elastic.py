"""Fault tolerance: straggler detection, heartbeat bookkeeping, elastic
re-mesh policy, checkpoint-based recovery.

``StragglerMonitor``, ``Heartbeat``, ``HeartbeatTracker``, ``ElasticPlan``
and ``plan_remesh`` are copies of the reference's (pure host code), pinned
to its source by ``tests/test_torch_checkpoint.py``:

- ``StragglerMonitor``: robust per-step timing (median + k*MAD) that flags
  outlier steps — a slow step throttles the run, so detection must be
  cheap.
- ``HeartbeatTracker``: dead hosts from missed heartbeats (poll-based).
- ``ElasticPlan`` / ``plan_remesh``: given the surviving device count, the
  largest valid (data, model) mesh and the new global batch.

``recover`` restores the latest checkpoint onto one device (``device`` in
place of the reference's target shardings: a mesh, ``launch.mesh.
elastic_mesh``'s included, is held as tensor dimensions on that one
device, and ``checkpoint.ckpt.restore(shardings=)`` checks a tree against
one) or builds a fresh state.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional


class StragglerMonitor:
    def __init__(self, window: int = 50, k_mad: float = 5.0,
                 min_steps: int = 10):
        self.window = window
        self.k_mad = k_mad
        self.min_steps = min_steps
        self.times: list[float] = []
        self.flagged: list[tuple[int, float]] = []
        self._t0: Optional[float] = None
        self.step = 0

    def start_step(self):
        self._t0 = time.monotonic()

    def end_step(self) -> bool:
        """Record one step; True if this step is a straggler outlier."""
        dt = time.monotonic() - self._t0
        return self.observe(dt)

    def observe(self, dt: float) -> bool:
        self.step += 1
        hist = self.times[-self.window:]
        is_out = False
        if len(hist) >= self.min_steps:
            med = statistics.median(hist)
            mad = statistics.median([abs(x - med) for x in hist]) or 1e-9
            is_out = dt > med + self.k_mad * mad * 1.4826
        self.times.append(dt)
        if is_out:
            self.flagged.append((self.step, dt))
        return is_out

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0


@dataclasses.dataclass
class Heartbeat:
    host: int
    last_seen: float


class HeartbeatTracker:
    """Detect dead hosts from missed heartbeats (poll-based)."""

    def __init__(self, n_hosts: int, timeout_s: float = 60.0):
        self.timeout = timeout_s
        now = time.monotonic()
        self.beats = {h: Heartbeat(h, now) for h in range(n_hosts)}

    def beat(self, host: int, t: Optional[float] = None):
        self.beats[host].last_seen = t if t is not None else time.monotonic()

    def dead_hosts(self, now: Optional[float] = None) -> list[int]:
        now = now if now is not None else time.monotonic()
        return [h for h, b in self.beats.items()
                if now - b.last_seen > self.timeout]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    n_devices: int
    global_batch: int
    note: str

    @property
    def mesh_shape(self):
        return (self.data, self.model)


def plan_remesh(n_surviving: int, model: int, old_global_batch: int,
                min_data: int = 1) -> ElasticPlan:
    """Largest (data, model) mesh from survivors; lane axis preserved.

    Batch policy: keep per-data-shard batch constant (scales global batch
    down with data axis) so activation memory per device is unchanged.
    """
    data = max(n_surviving // model, min_data)
    if data * model > n_surviving:
        raise ValueError(f"cannot build mesh: {n_surviving} devices "
                         f"< model axis {model}")
    # keep global batch divisible by the new data axis
    per_shard = max(old_global_batch // data, 1)
    new_batch = per_shard * data
    return ElasticPlan(data, model, data * model, new_batch,
                       note=f"remesh {data}x{model} from {n_surviving} "
                            f"survivors; global_batch {new_batch}")


def recover(ckpt_dir: str, device, build_state: Callable,
            step_hint: Optional[int] = None):
    """Restore-or-init onto ``device``."""
    from repro_torch.checkpoint import ckpt
    step, state = ckpt.restore(ckpt_dir, step=step_hint, device=device)
    if state is None:
        return 0, build_state()
    return step, state
