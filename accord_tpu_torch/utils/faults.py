"""Protocol fault-injection flags (reference: utils/Faults.java:21).

Each flag disables an OPTIONAL robustness/efficiency step the protocol's
safety must not depend on; the burn matrix runs with them enabled to prove
it. Module-level statics, like the reference: the simulator sets them for a
run and restores them after (single-threaded, deterministic).

FAST_PATH_DISABLED: never take the fast path (always run the Accept round).
The fast path is purely an optimization; correctness must be identical
without it.

TRANSACTION_UNMERGED_DEPS / SYNCPOINT_UNMERGED_DEPS: skip merging the
Accept-round deps into the Commit (reference: ProposeTxn.java:48,
ProposeSyncPoint.java:55). In the REFERENCE this is optional because cfk
manages per-key execution ordering implicitly (every earlier committed txn
on the key gates execution, whether or not it is in the committed deps --
local/cfk/CommandsForKey.java:83-168). In THIS design execution ordering
derives exclusively from the committed deps, so the merge is LOAD-BEARING:
enabling these flags produces real lost-update anomalies, and
tests/test_adversarial.py asserts the strict-serializability verifier
CATCHES them (guarding both the invariant and the checker).

(The reference's *_INSTABILITY flags skip its standalone Stabilise round;
this design has no such round -- Commit carries the read and is itself the
stability point -- so there is no equivalent step to skip.)
"""
from __future__ import annotations

FAST_PATH_DISABLED = False
TRANSACTION_UNMERGED_DEPS = False
SYNCPOINT_UNMERGED_DEPS = False


class scoped:
    """Context manager for tests: set flags, restore on exit."""

    def __init__(self, **flags: bool):
        self.flags = flags
        self.saved = {}

    def __enter__(self):
        g = globals()
        for k, v in self.flags.items():
            self.saved[k] = g[k]
            g[k] = v
        return self

    def __exit__(self, *exc):
        globals().update(self.saved)
        return False
