"""CommandStores: the intra-node sharding layer.

Role-equivalent to the reference's CommandStores (local/CommandStores.java:79):
splits the node's owned ranges over N single-threaded CommandStores via a
pluggable splitter (reference: ShardDistributor.EvenSplit) and fans requests
out with map-reduce over the intersecting stores. This is the reference's
intra-node parallelism dimension (SURVEY.md 2.10); in the TPU build it is also
the unit of micro-batching: every store's pending deps scans drain into the
shared per-node tick, which fuses them into ONE device call per tick
(ops/resolver.py routes results back by store-id lane; each store keeps its
own arena and generation pins).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, TYPE_CHECKING

from accord_tpu_torch.local.store import CommandStore
from accord_tpu_torch.primitives.keyspace import Range, Ranges, Seekables
from accord_tpu_torch.utils.async_ import AsyncResult, all_of
from accord_tpu_torch.utils.invariants import Invariants

if TYPE_CHECKING:
    from accord_tpu_torch.local.node import Node


def even_int_splitter(rng: Range, parts: int) -> List[Range]:
    """Default splitter for integer-like key domains (reference:
    ShardDistributor.EvenSplit with integer Splitter)."""
    lo, hi = rng.start, rng.end
    try:
        width = (hi - lo) // parts
    except TypeError:  # non-arithmetic bounds: no split
        return [rng]
    if width <= 0:
        return [rng]
    bounds = [lo + i * width for i in range(parts)] + [hi]
    return [Range(bounds[i], bounds[i + 1]) for i in range(parts) if bounds[i] < bounds[i + 1]]


class CommandStores:
    def __init__(self, node: "Node", num_stores: int, global_ranges: Ranges,
                 splitter: Callable[[Range, int], List[Range]] = even_int_splitter,
                 progress_log_factory=None, deps_resolver=None,
                 store_factory: Callable[..., CommandStore] = CommandStore):
        """`global_ranges` is the WHOLE cluster key domain: each store gets a
        fixed 1/num_stores slice of it, and topology changes only adjust what
        the node owns of each slice (update_topology). The stable intra-node
        partition means per-key state never migrates between stores."""
        self.node = node
        self.splitter = splitter
        per_store: List[List[Range]] = [[] for _ in range(num_stores)]
        for rng in global_ranges:
            pieces = splitter(rng, num_stores)
            if len(pieces) < num_stores:
                # unsplittable: give whole pieces to store 0..
                for i, p in enumerate(pieces):
                    per_store[i % num_stores].append(p)
            else:
                for i, p in enumerate(pieces):
                    per_store[i].append(p)
        self.stores: List[CommandStore] = [
            store_factory(i, node, Ranges(rs), progress_log_factory, deps_resolver)
            for i, rs in enumerate(per_store)
        ]

    # -- topology change (reference: CommandStores.updateTopology,
    # local/CommandStores.java:646) ------------------------------------------
    def update_topology(self, topology) -> AsyncResult:
        """Apply a new epoch: recompute each store's owned share of its slice;
        ranges gained relative to the prior epoch are bootstrapped (history
        acquired + safe-to-read gating) before the returned result fires."""
        owned = topology.ranges_for_node(self.node.id)
        pending: List[AsyncResult] = []
        for s in self.stores:
            new_owned = owned.intersection(s.slice_ranges)
            added, removed = s.set_owned(topology.epoch, new_owned)
            if not removed.is_empty():
                # a removed range's data stays SERVABLE here (complete below
                # the handover; reads gate on readiness + data gaps, not
                # ownership) -- but if the range ever comes back, re-adding
                # triggers a fresh bootstrap below.
                # in-flight bootstraps for removed ranges are moot: abort them
                # (their data gap stays marked); any still-owned remainder is
                # re-acquired under this epoch
                for b in [b for b in s.active_bootstraps
                          if b.ranges.intersects(removed)]:
                    b.abort()
                    remainder = b.ranges.intersection(new_owned)
                    if not remainder.is_empty():
                        pending.append(self._bootstrap(s, topology.epoch, remainder))
                # wait edges on deps whose shared keys all moved away can
                # never resolve locally -- elide them now (see
                # CommandStore.reevaluate_waiters ownership elision)
                s.reevaluate_waiters()
            if not added.is_empty():
                pending.append(self._bootstrap(s, topology.epoch, added))
        if not pending:
            from accord_tpu_torch.utils.async_ import success
            return success(None)
        return all_of(pending).map(lambda _: None)

    def _bootstrap(self, store: CommandStore, epoch: int, added: Ranges) -> AsyncResult:
        from accord_tpu_torch.local.bootstrap import Bootstrap
        return Bootstrap.run(self.node, store, epoch, added)

    # -- selection -----------------------------------------------------------
    def intersecting(self, seekables: Seekables) -> List[CommandStore]:
        return [s for s in self.stores if not s.ranges.is_empty() and s.owns(seekables)]

    def unsafe_for_key(self, key) -> Optional[CommandStore]:
        for s in self.stores:
            if s.ranges.contains_key(key):
                return s
        return None

    def all(self) -> Sequence[CommandStore]:
        return self.stores

    def owned_ranges(self) -> Ranges:
        out = Ranges.EMPTY
        for s in self.stores:
            out = out.union(s.ranges)
        return out

    # -- fan-out -------------------------------------------------------------
    def map_reduce(self, seekables: Seekables,
                   map_fn: Callable[[CommandStore], object],
                   reduce_fn: Callable[[object, object], object]) -> AsyncResult:
        """Run map_fn on every store intersecting seekables (each on its own
        execution context), reduce the results (reference:
        CommandStores.mapReduceConsume, local/CommandStores.java:626)."""
        targets = self.intersecting(seekables)
        if not targets:
            # topology churn can deliver a request for ranges this node has
            # never owned (e.g. a read sliced below the route); reduce of
            # nothing is None and the caller decides how to reply
            from accord_tpu_torch.utils.async_ import success
            return success(None)
        chains = [s.submit(map_fn) for s in targets]
        return all_of(chains).map(lambda vs: _reduce_non_null(vs, reduce_fn))

    def for_each(self, seekables: Seekables,
                 fn: Callable[[CommandStore], None]) -> AsyncResult:
        targets = self.intersecting(seekables)
        chains = [s.execute(fn) for s in targets]
        return all_of(chains).map(lambda _: None)


def _reduce_non_null(values: list, reduce_fn):
    acc = None
    for v in values:
        if v is None:
            continue
        acc = v if acc is None else reduce_fn(acc, v)
    return acc
