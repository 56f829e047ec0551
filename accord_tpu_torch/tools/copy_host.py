"""The port's copy of the host layers, and the audit that keeps it honest.

The host layers (protocol, local engine, messages, simulator, observability)
are plain Python with no device code. The port keeps its own copy of each
one, file for file, with the package prefix renamed and nothing else
changed, except at the few places where the reference reaches JAX, a
device the port names explicitly, or a device plane this port does not
have yet. Those places are listed in
EDITED, by their line span in the reference file.

    python -m accord_tpu_torch.tools.copy_host --write   # (re)copy unedited files
    python -m accord_tpu_torch.tools.copy_host --audit   # diff every copy

`--write` never overwrites a file listed in EDITED (the edits would be
lost); it copies the renamed reference over every other module. `--audit`
prints one line per module: `same`, or the reference line spans the copy
changes, and fails when a change falls outside the declared spans.
"""
from __future__ import annotations

import argparse
import difflib
import pathlib
import re
import sys
from typing import Dict, List, Tuple

ROOT = pathlib.Path(__file__).resolve().parents[2]
REF = ROOT / "accord_tpu"
PORT = ROOT / "accord_tpu_torch"

HOST_MODULES = (
    "api/__init__.py",
    "coordinate/__init__.py", "coordinate/ephemeral.py",
    "coordinate/errors.py", "coordinate/maxconflict.py",
    "coordinate/recover.py", "coordinate/syncpoint.py",
    "coordinate/tracking.py", "coordinate/transaction.py",
    "impl/__init__.py", "impl/durability.py", "impl/progress.py",
    "local/__init__.py", "local/bootstrap.py", "local/cfk.py",
    "local/command.py", "local/commands.py", "local/node.py",
    "local/status.py", "local/store.py", "local/stores.py",
    "messages/__init__.py", "messages/accept.py", "messages/apply_msg.py",
    "messages/base.py", "messages/commit.py", "messages/durability.py",
    "messages/epoch.py", "messages/fetch.py", "messages/getdeps.py",
    "messages/inform.py", "messages/preaccept.py", "messages/propagate.py",
    "messages/read.py", "messages/recover.py", "messages/wait.py",
    "obs/__init__.py", "obs/export.py", "obs/metrics.py", "obs/trace.py",
    "primitives/__init__.py", "primitives/deps.py",
    "primitives/keyspace.py", "primitives/routes.py",
    "primitives/syncpoint.py", "primitives/timestamp.py",
    "primitives/txn.py", "primitives/writes.py",
    "sim/__init__.py", "sim/burn.py", "sim/cluster.py",
    "sim/list_store.py", "sim/mesh_burn.py", "sim/network.py", "sim/queue.py",
    "sim/scheduler.py", "sim/topology_randomizer.py", "sim/verifier.py",
    "sim/wire.py",
    "topology/__init__.py", "topology/manager.py", "topology/shard.py",
    "topology/topologies.py", "topology/topology.py",
    "utils/__init__.py", "utils/async_.py", "utils/faults.py",
    "utils/interval_index.py", "utils/invariants.py",
    "utils/range_map.py", "utils/rng.py", "utils/sorted_arrays.py",
    # numpy-only modules of the device layer
    "ops/tiers.py", "ops/encoding.py", "ops/fault_plane.py",
)

# reference line spans (1-based, inclusive) that the copy may change, and why
EDITED: Dict[str, Tuple[Tuple[int, int, str], ...]] = {
    "obs/trace.py": (
        (21, 25, "docstring: the port has no tracer to guard against"),
        (29, 50, "drop the jax-tracing guard"),
        (93, 96, "drop the guard's call in the append funnel"),
    ),
    "sim/cluster.py": (
        (40, 40, "ClusterConfig(exec_device=): the exec planes' device"),
        (43, 43, "ClusterConfig(cmd_device=): the cmd planes' device"),
        (92, 92, "ClusterConfig.exec_device"),
        (109, 109, "ClusterConfig.cmd_device"),
        (357, 379, "exec and cmd planes built on exec_device / "
                   "cmd_device"),
    ),
    "sim/mesh_burn.py": (
        (202, 205, "an exec ticket holds the port's (_DevBuf, packed)"),
        (274, 274, "the quorum `met` lane reads back from a torch tensor"),
        (451, 465, "the merged dispatch's demux: every plan's window in "
                   "one lane_slice_many launch, each plan's call its view"),
        (517, 518, "no jax import"),
        (526, 538, "megakernel staging hands protocol_tick (or "
                   "sharded_protocol_tick) numpy lanes"),
        (583, 584, "quorum lanes as numpy"),
        (684, 684, "run_mesh_burn(device=, mesh=): the kernels' device, "
                   "the sharded resolvers' mesh"),
        (707, 727, "sharded=True: the resolvers on `mesh` (make_mesh() "
                   "by default), and with the exec and cmd planes on "
                   "`device`"),
        (781, 781, "--device"),
        (803, 803, "--device"),
    ),
    "sim/network.py": (
        (364, 364, "the port's MailboxPlane and its device helper"),
        (369, 369, "the plane on the device(s) of the resolvers the tick "
                   "engine adopted: a CPU burn stays on the CPU, a mesh "
                   "across cards gives each shard's rings to its card"),
    ),
}


def rename(text: str) -> str:
    """The one mechanical change every copy carries: the package prefix of
    every import, dotted or `from <package> import x`."""
    text = re.sub(r"\bfrom accord_tpu(\s+)import\b",
                  r"from accord_tpu_torch\1import", text)
    return re.sub(r"\baccord_tpu\.", "accord_tpu_torch.", text)


def changed_spans(ref_text: str, port_text: str) -> List[Tuple[int, int]]:
    """Reference line spans (1-based, inclusive) the port's copy replaces
    or deletes; a pure insertion reports the line it follows."""
    a = ref_text.splitlines()
    b = port_text.splitlines()
    out = []
    sm = difflib.SequenceMatcher(a=a, b=b, autojunk=False)
    for tag, i1, i2, _j1, _j2 in sm.get_opcodes():
        if tag == "equal":
            continue
        out.append((i1 + 1, max(i2, i1 + 1)))
    return out


def audit_module(rel: str) -> Tuple[bool, str]:
    """(ok, description) for one copied module."""
    ref = rename((REF / rel).read_text())
    port_path = PORT / rel
    if not port_path.exists():
        return False, "missing"
    spans = changed_spans(ref, port_path.read_text())
    if not spans:
        return rel not in EDITED, "same"
    allowed = EDITED.get(rel, ())
    bad = [s for s in spans
           if not any(lo <= s[0] and s[1] <= hi for lo, hi, _ in allowed)]
    desc = ", ".join(f"{lo}-{hi}" for lo, hi in spans)
    if bad:
        return False, "undeclared change at " + ", ".join(
            f"{lo}-{hi}" for lo, hi in bad)
    return True, "edited " + desc


def write() -> None:
    for rel in HOST_MODULES:
        dst = PORT / rel
        if rel in EDITED and dst.exists():
            continue
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(rename((REF / rel).read_text()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--audit", action="store_true")
    args = ap.parse_args(argv)
    if args.write:
        write()
    ok = True
    if args.audit or not args.write:
        for rel in HOST_MODULES:
            good, desc = audit_module(rel)
            ok &= good
            print(f"{'ok ' if good else 'BAD'} {rel}: {desc}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
