"""The liveness engine: notice stalled transactions and drive recovery.

Role-equivalent to the reference's SimpleProgressLog (impl/
SimpleProgressLog.java:78): every CommandStore reports command lifecycle
events here; entries that stop progressing past a stall threshold get a
CheckStatus probe (MaybeRecover) that either repairs local knowledge
(Propagate) or escalates to full Recover/Invalidate. One engine per node;
the per-store ProgressLog facade tags events with their store.

Tracked entries:
  - home-shard commands from preaccept onwards (the home shard owns each
    txn's liveness, reference ProgressShard.Home),
  - every replica's stable-but-not-applied commands (straggler repair),
  - dependencies a local command is blocked waiting on (reference Blocked
    state machine).

Scheduling is event-driven: a check tick is queued only while entries exist,
so a quiesced cluster's event queue drains (which the burn test relies on).
Attempts back off exponentially with deterministic jitter.
"""
from __future__ import annotations

from typing import Dict, Optional

from accord_tpu_torch.api import ProgressLog
from accord_tpu_torch.local.status import Status
from accord_tpu_torch.obs.trace import REC, node_pid, node_ts
from accord_tpu_torch.primitives.keyspace import Keys, Seekables
from accord_tpu_torch.primitives.timestamp import TxnId


class _Tracked:
    __slots__ = ("txn_id", "participants", "last_status", "last_change_ms",
                 "attempts", "next_attempt_ms", "in_flight", "home", "home_key",
                 "last_token", "awaited")

    def __init__(self, txn_id: TxnId, participants, status: Status, now_ms: float,
                 home: bool = True, home_key=None):
        self.txn_id = txn_id
        self.participants = participants
        self.last_status = status
        self.last_change_ms = now_ms
        self.attempts = 0
        self.next_attempt_ms = 0.0
        self.in_flight = False
        # merged ProgressToken from the last probe: remote movement between
        # probes (a new ballot, durability, a phase advance ANYWHERE) resets
        # the escalation backoff even when local state is unchanged
        # (reference: SimpleProgressLog compares successive ProgressTokens)
        self.last_token = None
        # home-shard ownership (reference ProgressShard.Home vs NonHome):
        # home entries drive recovery at full cadence; non-home entries defer
        # and first INFORM the home shard instead of probing themselves
        self.home = home
        self.home_key = home_key
        # a LOCAL waiter is blocked on this txn (reference BlockedUntil):
        # chased at full cadence regardless of home ownership -- the
        # non-home defer exists for orphaned preaccepts nobody waits on
        self.awaited = False


class ProgressEngine:
    def __init__(self, node=None, interval_ms: float = 250.0,
                 stall_ms: float = 1500.0, home_defer: float = 3.0,
                 inform_home: bool = True, recovery_scan=None):
        self.node = None
        self.rng = None
        self.interval_ms = interval_ms
        self.stall_ms = stall_ms
        # non-home entries wait home_defer x stall before acting at all, and
        # their first action is InformOfTxnId to the home shard, not a probe
        # (reference: SimpleProgressLog NonHomeState.StillUnsafe ->
        # InformHomeOfTxn); home_defer=1.0 + inform_home=False restores
        # every-replica-probes behavior (the gossip test compares the two)
        self.home_defer = home_defer
        self.inform_home = inform_home
        # stuck-waiter sweep candidate selection (ops/cmd_plane recovery
        # scan): None walks every live waiter (the reference path); "host"
        # pre-filters through the arena shadows' stall predicate; "device"
        # answers it as ONE recovery_scan query per sweep (host-verified,
        # counted fallback) -- "host" and "device" are bit-identical by
        # construction, the differential the storm bench drives
        self.recovery_scan = recovery_scan
        self.tracked: Dict[TxnId, _Tracked] = {}
        self._scheduled = False
        if node is not None:
            self.bind(node)

    def bind(self, node) -> None:
        """Late binding: store factories need the engine before the Node
        object exists (Node builds its stores in its constructor)."""
        self.node = node
        self.rng = node.rng.fork()

    def log_for(self, store) -> "StoreProgressLog":
        return StoreProgressLog(self, store)

    # -- tracking ------------------------------------------------------------
    def track(self, txn_id: TxnId, participants: Optional[Seekables],
              status: Status, home: Optional[bool] = True,
              home_key=None, awaited: bool = False) -> None:
        """`home=None` means the caller does not know whether this store is
        the home shard: an existing entry keeps its current home value
        (no silent promotion to home cadence), a new entry defaults to
        home -- the conservative cadence for an entry nobody has
        classified yet. `awaited` marks a txn a local waiter is blocked on:
        it is chased at full cadence whatever its home classification."""
        now = self.node.now_millis()
        entry = self.tracked.get(txn_id)
        if entry is None:
            if participants is None:
                return  # nowhere to address a probe yet
            entry = _Tracked(txn_id, participants, status, now,
                             home if home is not None else True, home_key)
            entry.awaited = awaited
            entry.next_attempt_ms = now + self._stall(entry) + self._jitter()
            self.tracked[txn_id] = entry
        else:
            if participants is not None:
                entry.participants = participants
            if awaited and not entry.awaited:
                # a waiter appeared: leave home alone, but pull a deferred
                # non-home timer in to full cadence -- the blocked dep must
                # be chased now, not after the orphan defer
                entry.awaited = True
                entry.next_attempt_ms = min(
                    entry.next_attempt_ms,
                    now + self.stall_ms + self._jitter())
            if home and not entry.home:
                # another store here owns the home key: promote, and pull the
                # deferred non-home timer back to home cadence (the first
                # recovery action must not inherit the 3x defer)
                entry.home = True
                entry.next_attempt_ms = min(
                    entry.next_attempt_ms,
                    now + self.stall_ms + self._jitter())
            if home_key is not None and entry.home_key is None:
                entry.home_key = home_key
            if status > entry.last_status:
                # progress: reset the stall clock
                entry.last_status = status
                entry.last_change_ms = now
                entry.attempts = 0
                entry.next_attempt_ms = now + self._stall(entry) + self._jitter()
        self._ensure_scheduled()

    def _stall(self, entry: _Tracked) -> float:
        # the defer applies only to non-home UNDECIDED entries nobody waits
        # on (the orphaned-preaccept net): for decided txns every replica
        # must fetch its own outcome regardless, and a blocked-on dep must
        # be chased promptly, so deferring would only slow repair
        if entry.home or entry.awaited or entry.last_status.is_decided:
            return self.stall_ms
        return self.stall_ms * self.home_defer

    def clear(self, txn_id: TxnId) -> None:
        """A store reports the txn locally finished. The engine is node-wide
        while commands advance per-store, so only drop the entry once EVERY
        owning store is applied/terminal; otherwise leave it for the tick
        loop to re-check."""
        entry = self.tracked.get(txn_id)
        if entry is not None and self._locally_resolved(entry):
            self.tracked.pop(txn_id, None)
            if not self.tracked:
                # going idle: one sweep so a stuck waiter missed by
                # entry-level tracking still re-arms the tick loop
                self._sweep_stuck_waiters()
                self._ensure_scheduled()

    def _jitter(self) -> float:
        return self.rng.next_int(int(self.stall_ms)) / 2.0

    # -- the check loop ------------------------------------------------------
    def _ensure_scheduled(self) -> None:
        if not self._scheduled and self.tracked:
            self._scheduled = True
            self.node.scheduler.once(self.interval_ms, self._tick)

    def _tick(self) -> None:
        self._scheduled = False
        self._sweep_stuck_waiters()
        now = self.node.now_millis()
        for entry in list(self.tracked.values()):
            if self._locally_resolved(entry):
                self.tracked.pop(entry.txn_id, None)
                continue
            if entry.in_flight or now < entry.next_attempt_ms:
                continue
            self._attempt(entry, now)
        self._ensure_scheduled()

    def _sweep_stuck_waiters(self) -> None:
        """Engine invariant: every command with pending wait edges on a
        currently-owned range is tracked. Individual tracking can be lost to
        clear()-time races (an entry judged resolved by one store's state
        while another store's copy still waits); the sweep reinstates them so
        the serial blocked-dep repair chain can never silently stop. Scans
        only the per-store live-waiter index (maintained by commands.py),
        not every command; stale index entries self-clean here."""
        for store in self.node.command_stores.all():
            self._maybe_heal_gaps(store)
            for txn_id in self._sweep_waiters(store):
                cmd = store.command_if_present(txn_id)
                wo = cmd.waiting_on if cmd is not None else None
                if cmd is None or wo is None or wo.is_done() \
                        or cmd.status.is_terminal:
                    store.live_waiters.discard(txn_id)
                    continue
                # wait edges can be created AFTER a range moved away (commits
                # arriving through the unsynced multi-epoch window), missing
                # the topology-update reevaluation: elide the blocking edge
                # here if its shared keys all left current ownership. Checks
                # only the MIN blocked dep per sweep (cost-bounded; chains
                # unwind one tick at a time).
                blocked = min(wo.commit) if wo.commit else (
                    min(wo.apply) if wo.apply else None)
                if blocked is not None \
                        and store.maybe_elide_lost_dep(cmd, blocked) \
                        and wo.is_done():
                    store.live_waiters.discard(txn_id)
                    continue
                if txn_id in self.tracked:
                    continue
                participants = None
                if cmd.route is not None:
                    participants = cmd.route.participants
                elif cmd.txn is not None:
                    participants = cmd.txn.keys
                if participants is None:
                    continue
                if not store.current_owned().intersects(participants):
                    continue  # frozen leftover on a lost range
                self.track(txn_id, participants, cmd.status)

    def _sweep_waiters(self, store) -> list:
        """The waiter set one sweep walks. The reference path is every
        entry in the store's live-waiter index; under a recovery-scan mode
        the cmd arena answers "which rows are live-band AND stalled" first
        (host shadows or one device query) and the walk visits only
        candidates still in the index -- plus any waiter the arena has
        never seen (no row => the scan cannot speak for it)."""
        if self.recovery_scan is None:
            return list(store.live_waiters)
        plane = getattr(store, "cmd_plane", None)
        if plane is None:
            return list(store.live_waiters)
        now = self.node.now_millis()
        if self.recovery_scan == "device":
            cand = plane.recovery_scan_device(now, self.stall_ms)
        else:
            cand = plane.recovery_scan_host(now, self.stall_ms)
        waiters = [t for t in cand if t in store.live_waiters]
        waiters.extend(t for t in store.live_waiters
                       if t not in plane.row_of)
        return waiters

    def _maybe_heal_gaps(self, store) -> None:
        """A data gap on a CURRENTLY-OWNED range means this replica's copy is
        incomplete yet it is the one coordinators will read from: self-heal
        by re-acquiring the slice with a bootstrap (ESP floor + snapshot
        fetch), exactly as if the range had just been added. Without this, a
        gap marked after the range's last (re-)bootstrap poisons it forever
        and recovery reads livelock (reference analog: Agent.onStale is the
        host's cue to re-bootstrap a stale shard)."""
        gaps = store.data_gaps.intersection(store.current_owned())
        if gaps.is_empty():
            return
        for b in store.active_bootstraps:
            gaps = gaps.difference(b.ranges)
        if gaps.is_empty():
            return
        # rate-limit: under churn, gaps are marked continuously and a heal
        # per 250ms sweep tick is a bootstrap storm; one heal per stall
        # window converges without swamping the cluster
        now = self.node.now_millis()
        last = getattr(store, "_last_gap_heal_ms", None)
        if last is not None and now - last < self.stall_ms:
            return
        store._last_gap_heal_ms = now
        # repair gaps (missing data known universally applied) heal by union
        # data repair -- a gap-checked bootstrap fetch deadlocks when every
        # current replica is itself gapped; fresh-history gaps need the full
        # ESP + snapshot acquisition
        repair = gaps.intersection(store.repair_gaps)
        if not repair.is_empty():
            self._run_data_repair(store, repair)
            gaps = gaps.difference(repair)
        if not gaps.is_empty():
            from accord_tpu_torch.local.bootstrap import Bootstrap
            Bootstrap.run(self.node, store, self.node.epoch, gaps)

    def _run_data_repair(self, store, ranges) -> None:
        """Union data repair: read every node's current data for `ranges`
        unconditionally and merge. Completes only when EVERY other node
        replied: a repair-gap write was applied at every replica of its
        shard at the epoch its durability floor advanced, and data stores
        only grow, so the union over all nodes is guaranteed to contain it
        -- but no smaller reply set is safe under topology churn (the
        then-replica set is unknowable from the current topology, so any
        partial-quorum bound can complete with zero holders). A missing
        reply just retries on the next sweep (the gap stays marked)."""
        from accord_tpu_torch.messages.base import Callback
        from accord_tpu_torch.messages.fetch import DataRepairOk, DataRepairRead
        node = self.node
        topology = node.topology_manager.current()
        others = sorted(set(topology.nodes()) - {node.id})
        if not others:
            store.fill_gap(ranges)
            return

        class _Repair(Callback):
            def __init__(self):
                self.merged: Dict = {}
                self.got = 0
                self.answered = 0
                self.done = False

            def on_success(self, from_node, reply):
                if self.done or not isinstance(reply, DataRepairOk):
                    return
                for key, entries in reply.data.items():
                    self.merged.setdefault(key, set()).update(entries)
                self.got += 1
                self.answered += 1
                self._maybe_finish()

            def on_failure(self, from_node, failure):
                if self.done:
                    return
                self.answered += 1
                self._maybe_finish()

            def _maybe_finish(self):
                if self.got >= len(others):
                    self.done = True
                    node.data_store.merge_entries(self.merged)
                    store.fill_gap(ranges)
                elif self.answered >= len(others):
                    self.done = True  # unreachable node(s): next sweep retries

        cb = _Repair()
        for to in others:
            node.send(to, DataRepairRead(ranges), cb)

    def _locally_resolved(self, entry: _Tracked) -> bool:
        """Done when every local store owning the participants has the command
        applied or terminal (a truncated record -- dropped below the
        durability floor -- counts as terminal)."""
        for store in self.node.command_stores.all():
            if not store.current_owned().intersects(entry.participants):
                # the range moved away (or never arrived): the handover
                # barrier covered the ordering obligation and the CURRENT
                # owners carry the liveness one. Leftover records here are
                # frozen state awaiting floor truncation -- peers may have
                # erased the outcomes they wait on, so no repair can ever
                # finish them, and they gate nothing that is still served.
                continue
            cmd = store.command_if_present(entry.txn_id)
            if cmd is not None and (cmd.has_been(Status.APPLIED)
                                    or cmd.status.is_terminal):
                continue
            # truncation is judged on the command's FULL participant set when
            # known (its route), not the possibly-narrower set the entry was
            # tracked under: commit/apply refuse on the route scope, so the
            # resolver must finalize on the same scope or a half-floored
            # record can neither apply nor resolve (the seed-13 endless
            # probe->refuse wedge)
            parts = entry.participants
            if cmd is not None and cmd.route is not None:
                parts = cmd.route.participants
            if store.is_truncated(entry.txn_id, parts):
                # below the truncation floor: the outcome is durable
                # cluster-wide, and the txn will never individually finish
                # here. A leftover record -- resurrected by a waiter, or a
                # pre-floor straggler the durability rounds overtook -- is
                # finished as TRUNCATED so its waiters drop their edges.
                # (The floor is durable state, so answering probes TRUNCATED
                # from this record stays truthful.)
                if cmd is not None and cmd.status != Status.TRUNCATED:
                    from accord_tpu_torch.local import commands as _commands
                    if entry.txn_id.kind.is_write and not store.bootstrap_covers(
                            entry.txn_id, parts):
                        # a durable write this store never applied and no
                        # snapshot delivered: its data can only be repaired
                        # by a future bootstrap -- mark only the currently-
                        # owned slice (lost ranges are never re-bootstrapped,
                        # so their gap would poison historical serving)
                        store.mark_repair_gap(
                            store.owned(parts).to_ranges().intersection(
                                store.current_owned()))
                    # ORDER MATTERS: status must be terminal BEFORE the
                    # notify/clear calls -- clear() re-enters this predicate
                    # for the same entry, and only the terminal status makes
                    # the re-entrant evaluation (and any re-run of this
                    # branch) a no-op
                    cmd.status = Status.TRUNCATED
                    _commands.notify_listeners(store, cmd)
                    store.progress_log.clear(entry.txn_id)
                continue
            if cmd is None or cmd.status == Status.NOT_DEFINED:
                if store.bootstrap_covers(entry.txn_id, entry.participants):
                    # the snapshot delivered the effects and nothing waits
                    # on the (absent) record: no obligation here. The record
                    # is NOT marked terminal -- bootstrap coverage is local
                    # knowledge, and a TRUNCATED answer to probes would
                    # wrongly assert a cluster-durable outcome was erased.
                    continue
                return False
            return False
        return True

    def _known_durability(self, entry: _Tracked):
        """Max durability any local store records for this txn (fed by the
        persist path's InformDurable broadcast and by probe gossip)."""
        from accord_tpu_torch.local.status import Durability
        best = Durability.NOT_DURABLE
        for store in self.node.command_stores.all():
            cmd = store.command_if_present(entry.txn_id)
            if cmd is not None and cmd.durability > best:
                best = cmd.durability
        return best

    def _attempt(self, entry: _Tracked, now: float) -> None:
        from accord_tpu_torch.coordinate.recover import MaybeRecover
        from accord_tpu_torch.local.status import Durability
        entry.in_flight = True
        entry.attempts += 1
        durability = self._known_durability(entry)
        durable = durability >= Durability.MAJORITY
        # a majority-durable txn needs no recovery race, only outcome fetch:
        # spread the attempts out (and see allow_invalidate below)
        backoff = self.stall_ms * (2 ** min(entry.attempts + (1 if durable else 0), 4))
        entry.next_attempt_ms = now + backoff + self._jitter()
        if self.inform_home and not entry.home and entry.attempts == 1 \
                and entry.home_key is not None \
                and not entry.last_status.is_decided:
            # a stalled UNDECIDED txn on a non-home replica: the home shard
            # owns the recover-or-invalidate decision, so the cheap first
            # action is telling it the txn exists; this replica escalates to
            # its own probe only if the txn is still stalled next attempt
            # (home shard dead/partitioned). Decided txns skip this: each
            # replica must fetch its own outcome anyway, home can't help.
            self._inform_home_of_txn(entry)
            entry.in_flight = False
            return
        self._retrack_blocking_deps(entry)

        def done(value, failure):
            entry.in_flight = False
            self._ensure_scheduled()

        def on_token(token, entry=entry):
            prev = entry.last_token
            entry.last_token = token if prev is None else prev.merge(token)
            if prev is not None and prev < entry.last_token:
                # something moved cluster-wide since the last probe: whoever
                # is driving it is alive, so stop escalating our backoff
                entry.attempts = 1

        self.node.counters["progress_probes"] += 1
        if REC.enabled:
            REC.instant(node_pid(self.node), "txn", "progress_probe",
                        node_ts(self.node),
                        args={"txn": str(entry.txn_id),
                              "attempts": entry.attempts})
        # durable => the outcome exists on a quorum: never race to
        # invalidate it, just fetch (the InformDurable gossip's teeth)
        MaybeRecover.probe(self.node, entry.txn_id, entry.participants,
                           allow_invalidate=not durable,
                           token_sink=on_token) \
            .add_callback(done)

    def _inform_home_of_txn(self, entry: _Tracked) -> None:
        """Send InformOfTxnId to the home shard's replicas (reference:
        coordinate/InformHomeOfTxn.java:55). Fire-and-forget: failures fall
        through to this replica's own probe on the next attempt."""
        from accord_tpu_torch.messages.inform import InformOfTxnId
        from accord_tpu_torch.primitives.routes import Route
        node = self.node
        try:
            shard = node.topology_manager.current().shard_for_key(entry.home_key)
        except Exception:
            return  # topology moved under us; next attempt probes instead
        route = Route(entry.home_key, entry.participants)
        for to in shard.nodes:
            if to != node.id:
                node.counters["informs_of_txn_sent"] += 1
                node.send(to, InformOfTxnId(entry.txn_id, route))

    def _retrack_blocking_deps(self, entry: _Tracked) -> None:
        """Blocked-dep tracking is normally established by the one-shot
        waiting() report, but an ownership race can clear it prematurely: a
        dep can look locally resolved while a store that gains its range in
        a LATER epoch resurrects an empty record and blocks on it forever --
        and probing the waiter alone is always redundant (its outcome is
        already known locally). Re-derive the waiter's current minimum
        blocked dependency from its WaitingOn each probe attempt so the
        repair chain can never be lost."""
        from accord_tpu_torch.local.commands import _dep_participants
        for store in self.node.command_stores.all():
            if not store.current_owned().intersects(entry.participants):
                continue  # frozen leftover on a lost range: not our liveness
            cmd = store.command_if_present(entry.txn_id)
            if cmd is None or cmd.waiting_on is None:
                continue
            wo = cmd.waiting_on
            blocked = min(wo.commit) if wo.commit else (
                min(wo.apply) if wo.apply else None)
            if blocked is not None:
                self.track(blocked, _dep_participants(store, cmd, blocked),
                           Status.NOT_DEFINED)


class StoreProgressLog(ProgressLog):
    """Per-store facade feeding the node's single engine."""

    def __init__(self, engine: ProgressEngine, store):
        self.engine = engine
        self.store = store

    def _participants(self, command):
        if command.route is not None:
            return command.route.participants
        if command.txn is not None:
            return command.txn.keys
        return None

    def _home_key(self, command):
        return command.route.home_key if command.route is not None else None

    def _track(self, command, is_home: bool) -> None:
        self.engine.track(command.txn_id, self._participants(command),
                          command.status, home=is_home,
                          home_key=self._home_key(command))

    def preaccepted(self, command, is_home: bool) -> None:
        # home entries drive recovery; non-home UNDECIDED entries are the
        # orphaned-preaccept safety net (reference NonHomeState): if the
        # coordinator dies before any home replica witnessed the txn, a
        # non-home witness informs the home shard after a deferred stall
        self._track(command, is_home)

    def accepted(self, command, is_home: bool) -> None:
        self._track(command, is_home)

    def committed(self, command, is_home: bool) -> None:
        self._track(command, is_home)

    def stable(self, command, is_home: bool) -> None:
        # every replica watches stable-but-unapplied commands: this is what
        # repairs stragglers that missed the Apply broadcast
        self._track(command, is_home)

    def readyToExecute(self, command) -> None:
        if REC.enabled:
            node = self.engine.node
            REC.txn_step(node_pid(node), command.txn_id, "ready_to_execute",
                         node_ts(node))
        # the caller does not know whether this store is home: home=None
        # preserves the entry's existing classification instead of silently
        # promoting a non-home entry to home cadence
        self.engine.track(command.txn_id, self._participants(command),
                          command.status, home=None,
                          home_key=self._home_key(command))

    def executed(self, command, is_home: bool) -> None:
        self._track(command, is_home)

    def informed_of_txn(self, command) -> None:
        # a peer says this txn exists and we own its home key: drive it
        self.engine.track(command.txn_id, self._participants(command),
                          command.status, home=True,
                          home_key=self._home_key(command))

    def durable(self, command) -> None:
        self.engine.clear(command.txn_id)

    def waiting(self, blocked_by: TxnId, blocked_until, participants) -> None:
        # a waiter does not know the blocked dep's home shard: home=None
        # keeps an already-tracked entry's classification, and awaited=True
        # chases it at full cadence (reference BlockedUntil)
        self.engine.track(blocked_by, participants, Status.NOT_DEFINED,
                          home=None, awaited=True)

    def clear(self, txn_id: TxnId) -> None:
        self.engine.clear(txn_id)

    def gap_marked(self) -> None:
        # heal promptly even when no entries are tracked (the tick loop only
        # runs while something is tracked); the cooldown inside bounds storms
        eng, store = self.engine, self.store
        eng.node.scheduler.once(eng.interval_ms,
                                lambda: eng._maybe_heal_gaps(store))
