"""The port's device execution scheduler (accord_tpu_torch/ops/exec_plane.py)
against the JAX package's, on the CPU.

The burns of tests/test_exec_plane.py run through both packages on the same
seed and config with the plane PRIMARY (releases come only from harvested
frontiers; the host WaitingOn stays on as the oracle and every release
asserts it drained): the port's planes on the CPU run the frontier kernels'
plain versions, the JAX planes run the JAX kernels on the CPU. Each pair
must commit the identical history (`collect_log=True`), lose nothing, and
count the same plane and coordinator counters (every `exec.*` and
`exec_coord.*` counter but the wall-clock harvest stall). Then the
compile-free units of tests/test_exec_frontier.py, ported: the checksum
twin, the gen-drop count and `_consume_compact`'s direct slice, checksum
fallback and overflow bump.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from accord_tpu.ops.exec_plane import ExecPlane as JaxPlane
from accord_tpu.sim import burn as jax_burn
from accord_tpu.sim.cluster import ClusterConfig as JaxConfig
from accord_tpu_torch.ops import kernels as tk
from accord_tpu_torch.ops.exec_plane import ExecPlane as PortPlane
from accord_tpu_torch.sim import burn as port_burn
from accord_tpu_torch.sim.cluster import ClusterConfig as PortConfig


def _exec_counters(report) -> dict:
    return {k: v for k, v in report.counters.items()
            if k.startswith(("exec.", "exec_coord."))
            and not k.endswith("harvest_stall_s")}


def _pair(seed, ops, cfg=None, **kw):
    cfg = dict(exec_plane=True, **(cfg or {}))
    launches = dict(tk.LAUNCHES)
    a = jax_burn.run_burn(seed, ops=ops, collect_log=True,
                          config=JaxConfig(**cfg), **kw)
    b = port_burn.run_burn(seed, ops=ops, collect_log=True,
                           config=PortConfig(exec_device="cpu", **cfg), **kw)
    assert tk.LAUNCHES == launches, "a CPU plane launched a CUDA kernel"
    assert a.log == b.log
    assert b.lost == a.lost == 0
    ca, cb = _exec_counters(a), _exec_counters(b)
    assert cb == ca
    assert cb.get("exec.releases", 0) > 0
    return a, b


def test_fused_burn_matches_jax():
    """Two stores per node: the ExecCoordinator fuses their frontiers."""
    _, b = _pair(11, 80)
    assert b.acked == 80 and b.failed == 0
    assert b.counters["exec_coord.fused_dispatches"] > 0


def test_compact_burn_matches_jax():
    _, b = _pair(13, 80, dict(exec_compact=True))
    assert b.counters["exec_coord.readback_bytes"] > 0
    assert b.counters.get("exec_coord.compact_fallbacks", 0) == 0


@pytest.mark.parametrize("compact", [False, True])
def test_solo_burn_matches_jax(compact):
    """One store per node: no coordinator, each plane dispatches its own
    execution_frontier (or frontier_compact)."""
    _, b = _pair(11, 80, dict(stores_per_node=1, exec_compact=compact))
    assert "exec_coord.dispatches" not in b.counters
    assert b.counters["exec.readback_bytes"] > 0


def test_unfused_two_store_burn_matches_jax():
    _pair(5, 60, dict(exec_fuse=False))


def test_port_burn_deterministic():
    cfg = PortConfig(exec_plane=True, exec_device="cpu")
    a = port_burn.run_burn(13, ops=60, collect_log=True, config=cfg)
    b = port_burn.run_burn(13, ops=60, collect_log=True,
                           config=PortConfig(exec_plane=True,
                                             exec_device="cpu"))
    assert a.log == b.log


@pytest.mark.parametrize("seed", (3, 9))
def test_chaos_burn_matches_jax(seed):
    _pair(seed, 100, dict(durability=True, durability_interval_ms=500.0),
          chaos_drop=0.1, chaos_partitions=True)


def test_durability_truncation_burn_matches_jax():
    _, b = _pair(17, 120, dict(durability=True, durability_interval_ms=300.0))
    assert b.failed == 0


def _bounded_pair(seed, ops):
    """Both packages' planes start at 64 rows: the arena must compact dead
    history rather than grow, identically on both sides."""
    planes = {"jax": [], "port": []}
    origs = {"jax": JaxPlane.__init__, "port": PortPlane.__init__}

    def spy(side):
        def init(self, store, **kw):
            kw["initial_cap"] = 64
            origs[side](self, store, **kw)
            planes[side].append(self)
        return init

    JaxPlane.__init__, PortPlane.__init__ = spy("jax"), spy("port")
    try:
        _pair(seed, ops, dict(durability=True, durability_interval_ms=300.0))
    finally:
        JaxPlane.__init__, PortPlane.__init__ = origs["jax"], origs["port"]
    assert planes["port"]
    assert [p.cap for p in planes["port"]] == [p.cap for p in planes["jax"]]
    assert [p._gen for p in planes["port"]] == \
        [p._gen for p in planes["jax"]]
    assert max(p._gen for p in planes["port"]) > 0, "no plane compacted"
    return max(p.cap for p in planes["port"])


def test_arena_compacts_at_small_cap_matches_jax():
    assert _bounded_pair(21, 120) <= 512


@pytest.mark.slow
def test_arena_stays_bounded_matches_jax():
    """tests/test_exec_plane.py's 400-op leg through both packages."""
    worst = _bounded_pair(21, 400)
    assert worst <= 512, f"exec arena grew to {worst} despite compaction"


def test_planes_default_to_the_card():
    """device=None means the card: without one the plane, the coordinator
    and the cluster raise instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    from accord_tpu_torch.ops.exec_plane import ExecCoordinator
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PortPlane(_Store())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExecCoordinator(_Node())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_burn.run_burn(1, ops=4, config=PortConfig(exec_plane=True))


# -- compile-free units (tests/test_exec_frontier.py, ported) ---------------

def test_frontier_checksum_host_position_weighted():
    indptr = np.asarray([0, 3, 5], np.int32)
    rows = np.asarray([1, 4, 9, 2, 7, 0, 0, 0], np.int32)
    base = tk.frontier_checksum_host(indptr, rows)
    assert base == tk.frontier_checksum_host(indptr.copy(), rows.copy())
    swapped = rows.copy()
    swapped[0], swapped[1] = swapped[1], swapped[0]
    assert tk.frontier_checksum_host(indptr, swapped) != base
    bumped = rows.copy()
    bumped[2] += 1
    assert tk.frontier_checksum_host(indptr, bumped) != base
    assert tk.frontier_checksum_host(
        np.asarray([0, 2, 5], np.int32), rows) != base


class _Sched:
    def __init__(self):
        self.calls = []

    def once(self, delay_ms, fn):
        self.calls.append((delay_ms, fn))


class _Node:
    def __init__(self):
        self.scheduler = _Sched()
        self.device_poll_ms = None


class _Store:
    def __init__(self):
        self.node = _Node()

    def command_if_present(self, txn_id):
        return None


def test_gen_drop_counts_and_reticks():
    plane = PortPlane(_Store(), initial_cap=64, device="cpu")
    plane._gen = 3
    plane._apply_rows([1, 2, 5], gen=2)
    assert plane.dropped_frontiers == 1
    assert plane.releases == 0
    assert plane.store.node.scheduler.calls, "drop must re-arm the tick"
    plane._apply_frontier(np.zeros(2, np.int32), gen=0)
    assert plane.dropped_frontiers == 2


class _RecPlane:
    def __init__(self):
        self.rows_calls = []
        self.frontier_calls = []

    def _apply_rows(self, rows, gen):
        self.rows_calls.append((list(rows), gen))

    def _apply_frontier(self, packed, gen):
        self.frontier_calls.append((np.asarray(packed).copy(), gen))


class _Owner:
    def __init__(self):
        self.readback_bytes = 0
        self.readback_full_equiv = 0
        self.compact_fallbacks = 0
        self.compact_overflows = 0
        self.observed = []
        self._out_tiers = None

    def _observe_bound(self, total):
        self.observed.append(total)


def _two_plane_fixture():
    """Two 64-row planes: plane0 releases rows {1, 40}, plane1 {3}. The
    host lanes come from the port's frontier_compact on planes built to
    release exactly those rows, and match the hand-built expectation."""
    packed = np.zeros(4, np.int32)
    packed[0] = 1 << 1          # plane0 row 1   (global bit 1)
    packed[1] = 1 << 8          # plane0 row 40  (global bit 40)
    packed[2] = 1 << 3          # plane1 row 3   (global bit 67)
    indptr = np.asarray([0, 2, 3], np.int32)
    rows = np.zeros(8, np.int32)
    rows[:3] = (1, 40, 67)
    csum = tk.frontier_checksum_host(indptr, rows)

    def plane(released):
        pending = torch.zeros(64, dtype=torch.bool)
        pending[list(released)] = True
        return (torch.zeros(64, 2, dtype=torch.int32),
                torch.zeros(64, 3, dtype=torch.int32),
                torch.zeros(64, dtype=torch.bool), pending,
                torch.zeros(64, dtype=torch.bool))

    got = tk.frontier_compact((plane({1, 40}), plane({3})), out_cap=8)
    assert got[0].tolist() == indptr.tolist()
    assert got[1].tolist() == rows.tolist()
    assert int(got[2]) & 0xFFFFFFFF == csum
    assert got[3].tolist() == packed.tolist()
    return (indptr, rows, csum), got[3], (_RecPlane(), _RecPlane())


def test_consume_compact_direct_slice():
    from accord_tpu_torch.ops.exec_plane import _consume_compact
    host, packed, (p0, p1) = _two_plane_fixture()
    owner = _Owner()
    entries = [(p0, (0, 2), 7), (p1, (2, 4), 9)]
    _consume_compact(owner, (None, packed), host, entries, 8)
    assert p0.rows_calls == [([1, 40], 7)]
    assert p1.rows_calls == [([3], 9)]
    assert not p0.frontier_calls and not p1.frontier_calls
    assert owner.readback_full_equiv == 4 * 4
    assert owner.readback_bytes == host[0].nbytes + host[1].nbytes + 4
    assert owner.observed == [3]
    assert owner.compact_fallbacks == 0 and owner.compact_overflows == 0


def test_consume_compact_checksum_fallback():
    from accord_tpu_torch.ops.exec_plane import _consume_compact
    host, packed, (p0, p1) = _two_plane_fixture()
    indptr, rows, csum = host
    bad = (indptr, rows, csum ^ 0x5A5A)
    owner = _Owner()
    entries = [(p0, (0, 2), 7), (p1, (2, 4), 9)]
    _consume_compact(owner, (None, packed), bad, entries, 8)
    assert owner.compact_fallbacks == 1
    assert not p0.rows_calls and not p1.rows_calls
    (pk0, g0), = p0.frontier_calls
    (pk1, g1), = p1.frontier_calls
    assert (g0, g1) == (7, 9)

    def decode(pk):
        return np.nonzero(np.unpackbits(pk.view(np.uint8),
                                        bitorder="little"))[0].tolist()
    assert decode(pk0) == [1, 40]
    assert decode(pk1) == [3]
    assert owner.readback_bytes > host[0].nbytes + host[1].nbytes + 4


def test_consume_compact_overflow_bumps_tier():
    from accord_tpu_torch.ops.exec_plane import _consume_compact
    from accord_tpu_torch.ops.tiers import OutCapTiers
    host, packed, (p0, p1) = _two_plane_fixture()
    owner = _Owner()
    owner._out_tiers = OutCapTiers(tk.FRONTIER_OUT_TIERS,
                                   tk.FRONTIER_OUT_TIERS[-1] * 2)
    before = owner._out_tiers.pick(1)
    entries = [(p0, (0, 2), 7), (p1, (2, 4), 9)]
    _consume_compact(owner, (None, packed), host, entries, 2)
    assert owner.compact_overflows == 1
    assert owner.observed == [3]
    assert p0.frontier_calls and p1.frontier_calls
    assert owner._out_tiers.pick(1) > before
