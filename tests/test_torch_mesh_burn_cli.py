"""The cluster tick through the port, continued (tests/test_torch_mesh_burn.py
holds the rest; the cases are split over files so that test workers
spread them): the crash-restart lane padding and the module CLI, each
history held against the JAX package's run_mesh_burn.
"""
from __future__ import annotations

import pytest

from accord_tpu.sim.mesh_burn import run_mesh_burn as jax_mesh_burn
from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
from tests.test_torch_mesh_burn import _logs

pytestmark = pytest.mark.mesh_burn


def test_crash_restart_lane_pads_out():
    """A crashed node drops out of the cluster tick (its lane pads out of
    the merge under pad_node_tiers); the restarted incarnation's fresh
    resolver re-adopts the engine through the factory; the history still
    matches the per-node loop and the JAX package."""
    kw = dict(nodes=4, crash_restart=True, crash_down_ms=400.0,
              pad_node_tiers=8)
    mesh, _eng, loop = _logs(29, 70, **kw)
    assert mesh.log == loop.log


def test_cli_reconcile(capsys):
    """The module CLI's --reconcile leg on the CPU (two runs of each seed,
    identical logs, exit 0), whose history is the JAX package's."""
    from accord_tpu_torch.sim import mesh_burn
    rc = mesh_burn.main(["--seed", "1", "--ops", "40", "--nodes", "3",
                         "--reconcile", "--megakernel", "--device", "cpu"])
    assert rc == 0
    assert '"deterministic": true' in capsys.readouterr().out
    rep, _ = run_mesh_burn(1, 40, nodes=3, megakernel=True, device="cpu",
                           collect_log=True)
    ref, _ = jax_mesh_burn(1, 40, nodes=3, collect_log=True)
    assert rep.log == ref.log
