"""PyTorch port, the lane- and cluster-partitioned Ara engines:
``repro_torch.core.vector_engine.LaneEngine`` and
``repro_torch.core.cluster.ClusterEngine`` against the port's
``ReferenceEngine`` and against the JAX engines.

On the CPU (``device="cpu"``):

- the 21-cell SEW x LMUL grid, 5 programs a cell, in float32, float64 and
  int32 (the integer cells): the LaneEngine at 2 and 4 lanes and the
  ClusterEngine at (2,2), (2,4), (4,2), (4,1) and (1,4) equal the
  ReferenceEngine bit for bit, one runner per engine for the whole grid;
- one subprocess with 8 fake XLA devices and x64 runs the JAX LaneEngine
  (2 lanes) and ClusterEngines ((2,2), (2,4), (4,2)) over one program a
  cell, and a 4-lane JAX LaneEngine over the reference test's
  matmul / daxpy / slide-reduce / gather programs; the port's engines of
  the same topologies give the same bits;
- the topology is signature material (flat 4, 2x2, 4x1 never share a
  runner), the register file is element-partitioned, and only the VLSU and
  SLDU rows (and the sticky vxsat) fold across lanes, in two stages for
  the ClusterEngine;
- the constructors' contracts and the CUDA-graph bookkeeping at 4 lanes.

The same engines on the card are held to the CPU run and to the card's
ReferenceEngine by ``chip_smoke.py`` phase ``vector_engine_lanes``.
"""
import numpy as np
import pytest
import torch

from conftest import run_devices
from repro_torch.configs import ara
from repro_torch.core import isa, staging
from repro_torch.core.cluster import (CLUSTER_AXES, ClusterEngine,
                                      make_cluster_mesh)
from repro_torch.core.vector_engine import (LaneEngine, ReferenceEngine,
                                            make_lane_mesh)
from repro_torch.testing import differential as diff

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

V = diff.VLMAX64
WIN = diff.grid_window(V)
CFG = ara.AraConfig(lanes=2)
TORCH = {"float32": torch.float32, "float64": torch.float64,
         "int32": torch.int32}
# (kind, lanes) for the LaneEngine, (kind, clusters, lanes per cluster)
TOPOLOGIES = [("lane", 2), ("lane", 4), ("cluster", 2, 2), ("cluster", 2, 4),
              ("cluster", 4, 2), ("cluster", 4, 1), ("cluster", 1, 4)]


def _topology_id(t):
    return f"lane{t[1]}" if t[0] == "lane" else f"cluster{t[1]}x{t[2]}"


def _make(topology, dtype="float64", cache=None, vlmax=V, cfg=CFG):
    cache = staging.TraceCache() if cache is None else cache
    if topology[0] == "lane":
        return LaneEngine(cfg, make_lane_mesh(topology[1]), vlmax=vlmax,
                          dtype=TORCH[dtype], cache=cache, device="cpu")
    return ClusterEngine(cfg, topology[1], topology[2], vlmax=vlmax,
                         dtype=TORCH[dtype], cache=cache, device="cpu")


def _reference(dtype="float64", cache=None, vlmax=V, cfg=CFG):
    return ReferenceEngine(cfg, vlmax=vlmax, dtype=TORCH[dtype],
                           cache=staging.TraceCache() if cache is None
                           else cache, device="cpu")


def _same_bits(a, b) -> bool:
    """Equal dtype, shape and bit patterns (any NaN matches any NaN)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    same = a.view(f"u{a.itemsize}") == b.view(f"u{b.itemsize}")
    if a.dtype.kind == "f":
        same |= np.isnan(a) & np.isnan(b)
    return bool(np.all(same))


def _sregs(s):
    return np.array([s[k] for k in range(32)])


def _assert_runs_equal(got, want, what):
    (gm, gs), (wm, ws) = got, want
    assert len(gm) == len(wm)
    for i in range(len(gm)):
        assert _same_bits(gm[i], wm[i]), (what, i, "memory")
        assert _same_bits(_sregs(gs[i]), _sregs(ws[i])), (what, i, "sregs")


def _cell(sew, lmul, seeds):
    out = [diff.random_program(np.random.RandomState(s), sew, lmul)
           for s in seeds]
    return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]


# ---------------------------------------------------------------------------
# the grid: every topology against the ReferenceEngine, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topology", TOPOLOGIES, ids=_topology_id)
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_grid_bit_exact_against_the_reference_engine(dtype, topology):
    """5 programs a cell (int32 storage: the integer cells), one batch a
    cell through both engines on one fresh cache: the whole grid builds
    one runner per engine (``compiles == 2``)."""
    cache = staging.TraceCache()
    ref, eng = _reference(dtype, cache), _make(topology, dtype, cache)
    assert eng.lanes == (topology[1] if topology[0] == "lane"
                         else topology[1] * topology[2])
    n = 0
    for sew, lmul, seeds in diff.cells(5):
        if dtype == "int32" and sew not in isa.INT_SEWS:
            continue
        progs, mems, srs = _cell(sew, lmul, seeds)
        want = ref.run_many(progs, mems, [dict(s) for s in srs], window=WIN)
        got = eng.run_many(progs, mems, [dict(s) for s in srs], window=WIN)
        _assert_runs_equal(got, want, (sew, lmul))
        n += len(seeds)
    assert n == 5 * sum(1 for s, _ in diff.vtype_combos()
                        if dtype != "int32" or s in isa.INT_SEWS)
    assert cache.stats.compiles == 2, cache.stats
    assert sum(cache.stats.folds.values()) > 0     # the grid exchanges


# ---------------------------------------------------------------------------
# the JAX lane and cluster engines (fake devices, x64, one subprocess)
# ---------------------------------------------------------------------------

JAX_TOPOLOGIES = [("lane", 2), ("cluster", 2, 2), ("cluster", 2, 4),
                  ("cluster", 4, 2)]
JAX_CODE = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs.ara import AraConfig
from repro.core import isa
from repro.core.cluster import ClusterEngine
from repro.core.vector_engine import LaneEngine
from repro.testing import differential as diff
cfg = AraConfig(lanes=2)
batch = [diff.random_program(np.random.RandomState(seeds[0]), sew, lmul)
         for sew, lmul, seeds in diff.cells(1)]
engines = {"lane2": LaneEngine(
    cfg, jax.sharding.Mesh(np.array(jax.devices()[:2]), ("lanes",)),
    vlmax=diff.VLMAX64, dtype=jnp.float64)}
for c, l in ((2, 2), (2, 4), (4, 2)):
    engines["cluster%%dx%%d" %% (c, l)] = ClusterEngine(
        cfg, c, l, vlmax=diff.VLMAX64, dtype=jnp.float64)
out = {}
for name, eng in engines.items():
    mems, srs = eng.run_many([b[0] for b in batch], [b[1] for b in batch],
                             [dict(b[2]) for b in batch],
                             window=diff.grid_window(diff.VLMAX64))
    for i, (m, s) in enumerate(zip(mems, srs)):
        out["%%s_m%%d" %% (name, i)] = m
        out["%%s_s%%d" %% (name, i)] = np.array([s[k] for k in range(32)])
cfg = AraConfig(lanes=4)
lane = LaneEngine(cfg, jax.sharding.Mesh(np.array(jax.devices()[:4]),
                                         ("lanes",)), dtype=jnp.float64)
progs, mems, srs = %(programs)s
mems, srs = lane.run_many(progs, mems, srs)
for i, (m, s) in enumerate(zip(mems, srs)):
    out["lane4_m%%d" %% i] = m
    out["lane4_s%%d" %% i] = np.array([s[k] for k in range(32)])
np.savez(%(path)r, **out)
print("JAX_LANES_OK", len(out))
"""
# the reference test's 4-lane programs (tests/test_vector_engine.py,
# test_lane_engine_matches_reference), as source both packages evaluate
PROGRAMS_4 = """(lambda rng, n, vlmax: (
    [isa.matmul_program(n, 0, n * n, 2 * n * n, t=4, vlmax=vlmax),
     isa.daxpy_program(64, 0, 64, vlmax=vlmax),
     [isa.VSETVL(16), isa.VLD(5, 0)] + isa.slide_reduce_program(5, 16, sd=1),
     [isa.VSETVL(16), isa.VLD(7, 0), isa.VGATHER(8, 32, 7), isa.VST(8, 16)]],
    [rng.randn(3 * n * n), rng.randn(128), rng.randn(16),
     np.concatenate([rng.randint(0, 32, 16).astype(float), rng.randn(48)])],
    [None, {0: 2.0}, None, None]))(np.random.RandomState(0), 16, cfg.vlmax_dp)
"""


@pytest.fixture(scope="module")
def jax_lanes(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_lanes") / "lanes.npz"
    out = run_devices(JAX_CODE % {"path": str(path),
                                  "programs": PROGRAMS_4},
                      n_devices=8, x64=True)
    assert "JAX_LANES_OK" in out
    return np.load(path)


@pytest.mark.parametrize("topology", JAX_TOPOLOGIES, ids=_topology_id)
def test_grid_bit_exact_against_the_jax_engines(jax_lanes, topology):
    """One program a cell in float64: the port's engine of the JAX
    engine's topology gives its bits (the JAX engines run under x64 on
    8 fake devices, their folds real ``psum``/``pmax`` across devices)."""
    eng = _make(topology, "float64")
    batch = [diff.random_program(np.random.RandomState(seeds[0]), sew, lmul)
             for sew, lmul, seeds in diff.cells(1)]
    mems, srs = eng.run_many([b[0] for b in batch], [b[1] for b in batch],
                             [dict(b[2]) for b in batch], window=WIN)
    name = _topology_id(topology)
    for i, (m, s) in enumerate(zip(mems, srs)):
        assert _same_bits(m, jax_lanes[f"{name}_m{i}"]), (name, i)
        assert _same_bits(_sregs(s), jax_lanes[f"{name}_s{i}"]), (name, i)
    assert len(batch) == len(diff.vtype_combos()) == 21


def test_four_lane_programs_bit_exact_against_the_jax_engine(jax_lanes):
    """Listing-1 at n = 16, DAXPY, the slide+add reduction and a gather
    on 4 lanes (the reference's ``test_lane_engine_matches_reference``
    programs, in one batch): the JAX LaneEngine's bits, and the port's
    ReferenceEngine's."""
    cfg = ara.AraConfig(lanes=4)
    progs, mems, srs = eval(PROGRAMS_4)
    lane = LaneEngine(cfg, make_lane_mesh(4), dtype=torch.float64,
                      cache=staging.TraceCache(), device="cpu")
    got = lane.run_many(progs, mems, srs)
    for i, (m, s) in enumerate(zip(*got)):
        assert _same_bits(m, jax_lanes[f"lane4_m{i}"]), i
        assert _same_bits(_sregs(s), jax_lanes[f"lane4_s{i}"]), i
    _assert_runs_equal(got, ReferenceEngine(cfg, device="cpu").run_many(
        progs, mems, srs), "reference")
    n = 16
    a, b, c = (mems[0][k * n * n:(k + 1) * n * n].reshape(n, n)
               for k in range(3))
    np.testing.assert_allclose(got[0][0][2 * n * n:].reshape(n, n),
                               a @ b + c, rtol=1e-12, atol=1e-12)
    assert abs(float(got[1][2][1]) - mems[2].sum()) < 1e-12
    idx = mems[3][:16].astype(int)
    assert _same_bits(got[0][3][16:32], mems[3][32 + idx])


# ---------------------------------------------------------------------------
# topology, layout and the fold counter
# ---------------------------------------------------------------------------


def test_equal_lane_count_topologies_do_not_share_signatures():
    """A flat 4-lane mesh, a 2x2 and a 4x1 cluster grid all run 4 lanes;
    their reconciliation nesting differs, so each builds its own runner
    (the twin of the reference's
    ``test_equal_lane_count_topologies_do_not_share_signatures``)."""
    cache = staging.TraceCache()
    flat = LaneEngine(CFG, make_lane_mesh(4), vlmax=8, cache=cache,
                      device="cpu")
    grid22 = ClusterEngine(CFG, 2, 2, vlmax=8, cache=cache, device="cpu")
    grid41 = ClusterEngine(CFG, 4, 1, vlmax=8, cache=cache, device="cpu")
    sigs = [e.signature(window=8, mem_words=64, prog_len=8, batch=1)
            for e in (flat, grid22, grid41)]
    assert len(set(sigs)) == 3, sigs
    assert all(s.lanes == 4 for s in sigs)
    mem = np.arange(64, dtype=float)
    prog = [isa.VSETVL(8, 32, 2), isa.VLD(0, 0), isa.VFMUL(0, 0, 0),
            isa.VST(0, 40)]
    outs = [e.run(prog, mem)[0] for e in (flat, grid22, grid41)]
    st = cache.stats
    assert st.compiles == 3 and st.misses == 3 and st.hits == 0, st
    flat.run(prog, mem)
    assert cache.stats.hits == 1
    assert _same_bits(outs[0], outs[1]) and _same_bits(outs[0], outs[2])
    assert staging.mesh_fingerprint(make_cluster_mesh(2, 2), CLUSTER_AXES) \
        == grid22.mesh_key == (("clusters", 2), ("lanes", 2))
    assert flat.mesh_key == (("lanes", 4),)


@pytest.mark.parametrize("lanes", [2, 4, 8])
def test_register_file_is_element_partitioned(lanes):
    """Element ``m`` of a register group lives on lane ``m % lanes``,
    local slot ``m // lanes``, at register ``base + (m // lanes) // spr``
    (the interleaved VRF of §III-E2, kept across register groups); the
    lane-major window reads it under its global id."""
    eng = LaneEngine(CFG, make_lane_mesh(lanes), vlmax=8,
                     cache=staging.TraceCache(), device="cpu")
    mem = np.arange(64, dtype=float)
    eng.run([isa.VSETVL(8, 64, 2), isa.VLD(0, 0), isa.VST(0, 40)], mem)
    runner, = eng.cache._fns.values()
    slots, window = runner.sig.slots, runner.window
    vpr = 8 * 64 // 32                             # SEW=32: 16 a register
    read, write, _ = runner._layout(vpr)
    ids = runner.ids.numpy()
    assert sorted(ids.tolist()) == list(range(window))
    spr = vpr // lanes
    for q, m in enumerate(ids):
        lane, p = m % lanes, m // lanes
        for base in (0, 5, 30):
            reg = base + p // spr
            want = lane * (isa.NUM_VREGS + 1) * slots + p % spr
            assert int(read[base, q]) == want + min(reg, 31) * slots
            assert int(write[base, q]) == want + min(reg, 32) * slots


FOLD_FREE = [isa.VSETVL(8, 32, 1), isa.VLD(1, 0), isa.VLD(2, 8),
             isa.VLDS(3, 0, 2), isa.VFADD(4, 1, 2), isa.VFMUL(5, 4, 1),
             isa.VFMA(5, 1, 2), isa.VINS(6, 0), isa.VFMA_VS(6, 0, 1),
             isa.VMFLT(7, 1, 2), isa.VMFEQ(isa.MASK_REG, 1, 1),
             isa.VMERGE(8, 1, 2), isa.VMAND(9, 7, 7),
             isa.VGATHER(10, 16, 11), isa.LDSCALAR(3, 4),
             isa.VSETVL(8, 32, 1), isa.VADD(12, 1, 2)]
# rows that exchange, with the (unit, folds) each makes
EXCHANGES = [
    ("VST", [isa.VST(1, 40)], "vlsu", 2),
    ("VSSEG", [isa.VSSEG(1, 40, 2)], "vlsu", 4),
    ("VSUXEI", [isa.VLD(11, 16), isa.VSUXEI(1, 40, 11)], "vlsu", 2),
    ("VSLIDE", [isa.VSLIDE(3, 1, 2)], "sldu", 1),
    ("VEXT", [isa.VEXT(1, 1, 3)], "sldu", 1),
    ("VREDSUM", [isa.VREDSUM(3, 1)], "sldu", 2),
    ("VREDMAX", [isa.VREDMAX(3, 1)], "sldu", 2),
    ("VSADD", [isa.VSADD(3, 1, 2)], "vxsat", 1),
]


def _fold_run(eng, prog):
    mem = np.zeros(64)
    mem[:16] = np.arange(16) % 7 - 3.0
    eng.cache.stats.reset()
    eng.run(prog, mem)
    return eng.cache.stats


@pytest.mark.parametrize("topology", [("lane", 4), ("cluster", 2, 2)],
                         ids=_topology_id)
def test_lane_local_rows_fold_nothing(topology):
    """Arithmetic, compares, logicals, VMERGE, VINS, loads and gathers
    stay in their lane: a program of only those makes no fold (the
    paper's scalability property)."""
    st = _fold_run(_make(topology), FOLD_FREE)
    assert sum(st.folds.values()) == 0 and not st.fold_stages, st


@pytest.mark.parametrize("name,rows,unit,folds", EXCHANGES,
                         ids=[e[0] for e in EXCHANGES])
def test_exchanges_fold_on_their_unit(name, rows, unit, folds):
    """Each store (VST, VSSEG per field, VSUXEI) folds on the VLSU, each
    VSLIDE, VEXT and reduction on the SLDU, each saturating op once for
    the sticky vxsat: the flat LaneEngine over its one axis, the
    ClusterEngine in two stages (within a cluster, then across), the
    ReferenceEngine never."""
    prog = [isa.VSETVL(8, 32, 1), isa.VLD(1, 0), isa.VLD(2, 8)] + rows
    flat = _fold_run(_make(("lane", 4)), prog)
    assert dict(flat.folds) == {unit: folds}, flat
    assert dict(flat.fold_stages) == {"lanes": folds}
    nested = _fold_run(_make(("cluster", 2, 2)), prog)
    assert dict(nested.folds) == {unit: folds}
    assert dict(nested.fold_stages) == {"lanes": folds, "clusters": folds}
    ref = _fold_run(_reference(), prog)
    assert not ref.folds and not ref.fold_stages
    for st in (flat, nested):
        assert st.compiles == 1


def test_fold_counts_scale_with_the_rows_and_the_batch_not_the_lanes():
    """A fold is one exchange of a row for its group of programs: twice
    the rows, twice the folds; a batch of three programs sharing the rows'
    opcodes folds once a row; 8 lanes fold as often as 2."""
    prog = [isa.VSETVL(8, 32, 1), isa.VLD(1, 0), isa.VST(1, 40),
            isa.VREDSUM(3, 1), isa.VST(3, 48)]
    counts = []
    for topology in (("lane", 2), ("lane", 8), ("cluster", 4, 2)):
        eng = _make(topology)
        counts.append(dict(_fold_run(eng, prog).folds))
        eng.cache.stats.reset()
        eng.run_many([prog] * 3, [np.zeros(64)] * 3)
        assert dict(eng.cache.stats.folds) == counts[-1]
    assert counts == [{"vlsu": 4, "sldu": 2}] * 3
    snap = eng.cache.stats.snapshot()
    eng.run(prog, np.zeros(64))
    assert dict(snap.folds) == counts[0]            # a copy, not a view
    assert dict(eng.cache.stats.folds) == {"vlsu": 8, "sldu": 4}


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------


def test_lane_engine_contracts():
    """The reference's constructors: float32 storage by default (the
    ReferenceEngine's is float64), VLMAX trimmed to a multiple of the
    lanes, ``kind`` "lane" / "cluster", the topology and the mesh key."""
    lane = LaneEngine(CFG, make_lane_mesh(3), vlmax=8, device="cpu")
    assert lane.dtype == torch.float32 and lane.kind == "lane"
    assert lane.vlmax == 6 and lane.lanes == 3
    assert lane.axis == "lanes" and lane.mesh.shape == {"lanes": 3}
    assert LaneEngine(CFG, make_lane_mesh(4), device="cpu").vlmax \
        == CFG.vlmax_dp
    clu = ClusterEngine(CFG, 2, 3, vlmax=16, device="cpu")
    assert clu.dtype == torch.float32 and clu.kind == "cluster"
    assert clu.topology == (2, 3) and clu.lanes == 6 and clu.vlmax == 12
    assert clu.signature(8, 64, 8, 1).clusters == 2
    assert ReferenceEngine(CFG, device="cpu").dtype == torch.float64
    named = LaneEngine(CFG, make_lane_mesh(2, axis="x"), axis="x",
                       device="cpu")
    assert named.mesh_key == (("x", 2),)
    with pytest.raises(ValueError, match="not in the mesh"):
        LaneEngine(CFG, make_lane_mesh(2), axis="x", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        LaneEngine(CFG, make_lane_mesh(2), dtype=torch.float16,
                   device="cpu")


@pytest.mark.parametrize("shape", [(0, 2), (2, 0), (-1, 4)])
def test_make_cluster_mesh_validates_its_shape(shape):
    with pytest.raises(ValueError, match="must be >= 1"):
        make_cluster_mesh(*shape)
    with pytest.raises(ValueError):
        ClusterEngine(CFG, *shape, device="cpu")


def test_make_cluster_mesh_counts_no_devices():
    """A deliberate difference from the reference, whose
    ``make_cluster_mesh`` raises when fewer than clusters x lanes devices
    exist (``tests/test_cluster.py::
    test_make_cluster_mesh_requires_enough_devices``): one card holds
    every lane, so any valid shape builds, in a process with no card."""
    mesh = make_cluster_mesh(2, 2)
    assert mesh.axis_names == CLUSTER_AXES and mesh.shape == {
        "clusters": 2, "lanes": 2}
    assert make_cluster_mesh(8, 8, axes=("c", "l")).shape == {"c": 8, "l": 8}
    assert not hasattr(mesh, "devices")


def test_graph_replay_matches_eager_at_four_lanes(monkeypatch):
    """The twin of ``test_graph_replay_matches_eager`` on a 4-lane
    LaneEngine: with every group shape that recurs twice replayed (a
    stand-in capture whose replay reruns the branch), a batch of
    Listing-1 programs beside grid programs gives the eager run's bits
    and the eager run's fold counts."""
    class Replay:
        captured = 0

        def __init__(self, fn):
            self.replay = fn
            Replay.captured += 1

    n, rng = 6, np.random.RandomState(0)
    progs, mems = [], []
    for _ in range(3):
        progs.append(isa.matmul_program(n, 0, n * n, 2 * n * n, t=4,
                                        vlmax=V))
        mems.append(rng.randn(3 * n * n))
    for seed, (sew, lmul) in enumerate([(32, 2), (16, 1), (64, 4)]):
        p, m, _ = diff.random_program(np.random.RandomState(seed), sew, lmul)
        progs.append(p)
        mems.append(m)
    srs = [{0: 0.5}] * len(progs)
    eng = _make(("lane", 4))
    eager = eng.run_many(progs, mems, srs, window=WIN)
    folds = dict(eng.cache.stats.folds)
    runner, = eng.cache._fns.values()
    assert runner.graphs is False
    monkeypatch.setattr(staging, "_capture", Replay)
    monkeypatch.setattr(staging, "_drain", lambda device: None)
    monkeypatch.setattr(staging, "GRAPH_MIN_REPEATS", 2)
    runner.graphs = True
    eng.cache.stats.reset()
    _assert_runs_equal(eng.run_many(progs, mems, srs, window=WIN), eager,
                       "replayed")
    assert Replay.captured >= 10
    assert dict(eng.cache.stats.folds) == folds and folds["vlsu"] > 0


def test_build_runner_checks_the_mesh_against_the_signature():
    """``mesh``/``axis``/``axes`` describe the signature's topology: a
    mesh of other sizes, a cluster pair for a flat signature, or both
    spellings at once raise ``ValueError``."""
    lane4 = _make(("lane", 4)).signature(8, 64, 8, 1)
    grid22 = _make(("cluster", 2, 2)).signature(8, 64, 8, 1)
    stats = staging.CacheStats()
    with pytest.raises(ValueError, match="do not describe"):
        staging.build_runner(lane4, stats, mesh=make_lane_mesh(2))
    with pytest.raises(ValueError, match="do not describe"):
        staging.build_runner(lane4, stats, axes=CLUSTER_AXES)
    with pytest.raises(ValueError, match="do not describe"):
        staging.build_runner(grid22, stats, mesh=make_cluster_mesh(4, 1))
    with pytest.raises(ValueError, match="not both"):
        staging.build_runner(grid22, stats, axis="lanes", axes=CLUSTER_AXES)
    with pytest.raises(ValueError, match="no runner"):
        staging.Runner(staging.Signature("ref", 2, 8, 8, 64, 8, 1,
                                         "float32"), stats)
    assert stats.compiles == 0
