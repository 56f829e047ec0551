"""The port stands alone: importing it, and running a burn through it on
the CPU, loads neither JAX nor Triton nor any module of the JAX package;
its resolver refuses to move to the CPU on its own; and no source file of
the package, nor chip_smoke.py, imports JAX or names a JAX-package module.

The first two run in a subprocess, because this test process has already
loaded JAX (tests/conftest.py).
"""
from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_BURN = r"""
import json, sys
import accord_tpu_torch
from accord_tpu_torch.ops.resolver import BatchDepsResolver
from accord_tpu_torch.sim.burn import run_burn
from accord_tpu_torch.sim.cluster import ClusterConfig
r = run_burn(seed=2, ops=20, concurrency=8, config=ClusterConfig(
    num_nodes=3, rf=3, deps_batch_window_ms=2.0,
    deps_resolver_factory=lambda: BatchDepsResolver(num_buckets=128,
                                                    device="cpu")))
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "triton", "accord_tpu")
             or m.startswith(("jax.", "jaxlib.", "triton.", "accord_tpu.")))
print(json.dumps({"acked": r.acked, "bad": bad}))
"""

_NO_DEVICE = r"""
import json, torch
from accord_tpu_torch.ops.resolver import BatchDepsResolver
try:
    BatchDepsResolver()
    raised = None
except RuntimeError as e:
    raised = str(e)
print(json.dumps({"cuda": torch.cuda.is_available(), "raised": raised}))
"""


_SLICE6 = r"""
import json, sys, torch
from accord_tpu_torch import graft_entry
from accord_tpu_torch.ops import mailbox
from accord_tpu_torch.parallel import mesh
from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
rep, _ = run_mesh_burn(3, 12, nodes=3, megakernel=True, device_messages=True,
                       device="cpu")
step, args = graft_entry.entry("cpu")
deps, levels = step(*args)
raised = {}
for name, fn in (("plane", lambda: mailbox.MailboxPlane(4)),
                 ("entry", graft_entry.entry)):
    try:
        fn()
        raised[name] = None
    except RuntimeError as e:
        raised[name] = str(e)
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "triton", "accord_tpu")
             or m.startswith(("jax.", "jaxlib.", "triton.", "accord_tpu.")))
print(json.dumps({"acked": rep.acked, "cuda": torch.cuda.is_available(),
                  "delivered": rep.counters["device_messages_delivered"],
                  "deps": int(deps.sum()), "raised": raised, "bad": bad,
                  "example": len(mesh.example_resolve_batch())}))
"""


def _run(code: str) -> dict:
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_burn_loads_no_jax_triton_or_reference_module():
    res = _run(_BURN)
    assert res["acked"] > 0
    assert res["bad"] == []


def test_batch_resolver_without_device_raises_without_card():
    res = _run(_NO_DEVICE)
    if not res["cuda"]:
        assert res["raised"] and "no CUDA device" in res["raised"]


def test_sources_import_no_jax_and_no_reference_module():
    files = [p for p in (ROOT / "accord_tpu_torch").rglob("*")
             if p.suffix in (".py", ".cu", ".cuh")]
    files.append(ROOT / "chip_smoke.py")
    jax_import = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    reference = re.compile(
        r"\baccord_tpu\.|\bfrom\s+accord_tpu\s+import|\bimport\s+accord_tpu\b(?!_)")
    offenders = []
    for p in files:
        text = p.read_text()
        if jax_import.search(text) or reference.search(text):
            offenders.append(str(p.relative_to(ROOT)))
    assert len(files) > 70
    assert offenders == []


def test_message_plane_and_graft_entry_load_no_jax():
    """The mailbox module, the graft entry and the parallel example inputs
    import no JAX or JAX-package module, even while a device-messages
    megakernel burn and the entry run; without a card, MailboxPlane and
    entry() raise instead of moving to the CPU."""
    res = _run(_SLICE6)
    assert res["acked"] > 0 and res["delivered"] > 0 and res["deps"] > 0
    assert res["bad"] == []
    assert res["example"] == 9
    if not res["cuda"]:
        for name in ("plane", "entry"):
            assert res["raised"][name] and "no CUDA device" in \
                res["raised"][name]
