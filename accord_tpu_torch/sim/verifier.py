"""Strict-serializability checking for the list-store workload.

Role-equivalent to the reference's StrictSerializabilityVerifier
(test verify/StrictSerializabilityVerifier.java:58). Because every write
appends a globally unique value and each key's list is the serialization
order of its writes, observed reads expose per-key orders directly.

Two tiers of checking:

A. Direct per-key checks (cheap, precise error messages):
  1. per-key order consistency: all observed sequences for a key are
     prefixes of one total order;
  2. read-own-write exclusion: a txn never observes its own append;
  3. real-time (strict) ordering per key: if txn A completed before txn B
     started, B observes at least everything A observed, and every key A
     (ack'd) wrote is visible to B's reads of that key;
  4. no reads from the future: observed values must belong to writes that
     were issued before the reader completed.

B. Cross-key happens-before closure (the reference's max-predecessor graph,
   StrictSerializabilityVerifier.java:58-120, re-expressed):

   Nodes are *states* ``(key, step)`` — "key has seen exactly `step`
   writes"; write #s creates state s. Each witnessed txn contributes a
   *point* node p (its serialization point) with edges

     (K, lo_K) -> p      write lo_K of K happened at-or-before p
     p -> (K, hi_K)      write hi_K of K happens strictly after p

   where a read of K observing `n` values gives (lo, hi) = (n, n+1), and a
   write of K landing at list index q makes state q+1 EQUAL to p (its own
   write IS write #q+1, applied at p: a pair of non-strict edges), with
   p -> (K, q+2) bounding the next write.  Edges carry strictness: a read
   observation (K, i) -> p is strict (the observed write happened at a
   different, earlier point), p -> (K, hi) is strict, own-write equality is
   non-strict.  Same-key states chain (K, i) -> (K, j>i) strictly.
   Real-time edges ride a chain of virtual time nodes: every completion
   links p -> rt_i (non-strict), every txn starting after that completion
   links rt_i -> p' (strict).  A cycle containing a strict edge witnesses a
   non-serializable history; detection is by propagating, per node, the
   maximum (step, strict) predecessor per key (memoized transitive-closure
   frontier, as in the reference) and failing when a state's own key
   reaches a predecessor step > its own, or == with a strict path.

Unknown-outcome txns (client timeouts) register their values as "maybe":
allowed to appear, never required.  Blind writes (no read of the written
key — not generated by the burn, but possible via maelstrom) resolve their
list position lazily, when the value first shows up in an observed order or
in the final state.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Tuple


class HistoryViolation(AssertionError):
    pass


class _Node:
    """One vertex of the happens-before graph.

    `key` is a workload key for state nodes, or None for point / rt nodes
    (whose identity needs no tracking: any cycle necessarily passes through
    state nodes, where it is detected).  `preds` maps workload key ->
    (max step known to precede this node, was any edge on the path strict).
    """
    __slots__ = ("key", "step", "preds", "succs")

    def __init__(self, key, step: int):
        self.key = key
        self.step = step
        self.preds: Dict[object, Tuple[int, bool]] = {}
        self.succs: List[Tuple["_Node", bool]] = []

    def __repr__(self):
        if self.key is None:
            return f"_Node(point/rt@{self.step})"
        return f"_Node({self.key},{self.step})"


class _KeyHistory:
    __slots__ = ("order", "read_marks", "write_marks", "steps", "nodes",
                 "claims")

    def __init__(self):
        self.order: Tuple[int, ...] = ()   # longest observed sequence
        # (end_us, seq_len) for completed reads, append-ordered by end_us
        self.read_marks: List[Tuple[int, int]] = []
        # (end_us, value) for ack'd writes, append-ordered by end_us
        self.write_marks: List[Tuple[int, int]] = []
        self.steps: List[int] = []              # sorted step indexes w/ nodes
        self.nodes: Dict[int, _Node] = {}       # step -> graph node
        # step -> value: which write claims to have created that state
        # (from its own read length); checked against the observed order
        self.claims: Dict[int, int] = {}


class StrictSerializabilityVerifier:
    def __init__(self):
        self._keys: Dict[object, _KeyHistory] = {}
        self._issued: Dict[int, int] = {}    # value -> issue (start) time
        self._acked: set = set()             # values of ack'd writes
        # blind-write resolution: value -> (key, point node)
        self._pending: Dict[int, Tuple[object, _Node]] = {}
        # real-time chain: completion times + their rt nodes, end-ordered
        self._rt_ends: List[int] = []
        self._rt_nodes: List[_Node] = []
        self.witnessed = 0

    def _key(self, key) -> _KeyHistory:
        h = self._keys.get(key)
        if h is None:
            h = _KeyHistory()
            self._keys[key] = h
        return h

    # -- workload bookkeeping ------------------------------------------------
    def on_issue_write(self, value: int, start_us: int) -> None:
        self._issued[value] = start_us

    # -- happens-before graph ------------------------------------------------
    def _state_node(self, key, step: int) -> _Node:
        h = self._key(key)
        node = h.nodes.get(step)
        if node is not None:
            return node
        node = _Node(key, step)
        h.nodes[step] = node
        idx = bisect_left(h.steps, step)
        h.steps.insert(idx, step)
        # chain: previous same-key state happens before this, this before next
        if idx > 0:
            self._add_edge(h.nodes[h.steps[idx - 1]], node, strict=True)
        if idx + 1 < len(h.steps):
            self._add_edge(node, h.nodes[h.steps[idx + 1]], strict=True)
        return node

    def _add_edge(self, u: _Node, v: _Node, *, strict: bool) -> None:
        u.succs.append((v, strict))
        if self._merge_from(u, v, strict):
            self._propagate(v)

    def _merge_from(self, u: _Node, v: _Node, strict: bool) -> bool:
        """Fold u's predecessor frontier (plus u itself) into v, ORing the
        edge's strictness onto each path; detect a cycle the moment v's own
        key reaches a predecessor step > v.step, or == via a strict path.
        Keeping only the lexicographic max (step, strict) per key is safe:
        a dominated entry's violation is implied by the dominating one."""
        vp = v.preds
        changed = False
        for k, (s, f) in u.preds.items():
            nf = f or strict
            cur = vp.get(k)
            if cur is None or cur[0] < s or (cur[0] == s and nf and not cur[1]):
                vp[k] = (s, nf)
                changed = True
        if u.key is not None:
            cur = vp.get(u.key)
            if cur is None or cur[0] < u.step or (
                    cur[0] == u.step and strict and not cur[1]):
                vp[u.key] = (u.step, strict)
                changed = True
        if v.key is not None:
            own = vp.get(v.key)
            if own is not None and (own[0] > v.step
                                    or (own[0] == v.step and own[1])):
                raise HistoryViolation(
                    f"cross-key serializability cycle: state "
                    f"({v.key},{v.step}) is strictly preceded by "
                    f"({v.key},{own[0]}) through the happens-before closure")
        return changed

    def _propagate(self, start: _Node) -> None:
        stack = [start]
        while stack:
            n = stack.pop()
            for t, strict in n.succs:
                if self._merge_from(n, t, strict):
                    stack.append(t)

    def _rt_before(self, start_us: int) -> Optional[_Node]:
        """Latest rt node whose completion time is strictly before start."""
        idx = bisect_left(self._rt_ends, start_us)
        return self._rt_nodes[idx - 1] if idx > 0 else None

    def _new_rt(self, end_us: int) -> _Node:
        node = _Node(None, len(self._rt_nodes))
        if self._rt_nodes:
            self._add_edge(self._rt_nodes[-1], node, strict=False)
        self._rt_ends.append(end_us)
        self._rt_nodes.append(node)
        return node

    def _resolve_position(self, key, value: int, index: int) -> None:
        """A blind write's value showed up at `index` of key's order: its
        point wrote state index+1 (equality), so wire the deferred edges."""
        pending = self._pending.pop(value, None)
        if pending is None:
            return
        pkey, point = pending
        if pkey != key:
            raise HistoryViolation(
                f"write {value} issued for key {pkey} observed on key {key}")
        state = self._state_node(key, index + 1)
        self._add_edge(state, point, strict=False)
        self._add_edge(point, state, strict=False)
        self._add_edge(point, self._state_node(key, index + 2), strict=True)

    def _claim(self, key, step: int, value: int) -> None:
        """A write claims (from its own read length) that it created state
        `step` of `key`.  Two writes claiming the same state, or a claim
        contradicting the observed order, is a lost-update-shaped violation
        the equality edges alone cannot see."""
        h = self._key(key)
        prev = h.claims.setdefault(step, value)
        if prev != value:
            raise HistoryViolation(
                f"key {key}: writes {prev} and {value} both observed "
                f"{step - 1} prior values — both claim list index {step - 1}")
        if len(h.order) >= step and h.order[step - 1] != value:
            raise HistoryViolation(
                f"key {key}: write {value} observed {step - 1} prior values "
                f"so claims list index {step - 1}, but the observed order has "
                f"{h.order[step - 1]} there: {h.order}")

    # -- the main check ------------------------------------------------------
    def witness(self, start_us: int, end_us: int,
                reads: Dict[object, Tuple[int, ...]],
                writes: Dict[object, int]) -> None:
        """Called at client completion of an ack'd txn."""
        self.witnessed += 1
        for key, seq in reads.items():
            h = self._key(key)
            own = writes.get(key)
            if own is not None and own in seq:
                raise HistoryViolation(
                    f"txn observed its own write {own} on key {key}: {seq}")
            for v in seq:
                if v not in self._issued:
                    raise HistoryViolation(f"key {key}: read unknown value {v}")
                if self._issued[v] > end_us:
                    raise HistoryViolation(
                        f"key {key}: value {v} read before it was issued")
            self._check_prefix(key, h, seq)
            # real-time read monotonicity: longest seq observed by any txn
            # that completed before we started must be a prefix of ours
            required = self._max_len_before(h.read_marks, start_us)
            if len(seq) < required:
                raise HistoryViolation(
                    f"key {key}: read of len {len(seq)} ({seq}) missing writes "
                    f"observed by a txn completed before this one started "
                    f"(required >= {required}; order={h.order})")
            # real-time write visibility: ack'd writes completed before our
            # start must be visible
            seq_set = set(seq)
            for w_end, w_val in h.write_marks:
                if w_end >= start_us:
                    break
                if w_val not in seq_set:
                    raise HistoryViolation(
                        f"key {key}: ack'd write {w_val} (completed {w_end}us) "
                        f"not visible to read started {start_us}us: {seq}")
            h.read_marks.append((end_us, len(seq)))
        for key, value in writes.items():
            self._acked.add(value)
            self._key(key).write_marks.append((end_us, value))

        # -- cross-key happens-before closure --
        point = _Node(None, 0)
        rt_prev = self._rt_before(start_us)
        if rt_prev is not None:
            self._add_edge(rt_prev, point, strict=True)
        for key, seq in reads.items():
            if key in writes:
                continue
            n = len(seq)
            # observed write #n happened at a strictly earlier point (n > 0)
            self._add_edge(self._state_node(key, n), point, strict=n > 0)
            self._add_edge(point, self._state_node(key, n + 1), strict=True)
        for key, value in writes.items():
            seq = reads.get(key)
            if seq is None:
                # blind write: resolve now if the value was already observed,
                # else park it until its list position shows up
                h = self._key(key)
                self._pending[value] = (key, point)
                if value in h.order:
                    self._resolve_position(key, value, h.order.index(value))
                continue
            q = len(seq)  # own write lands at index q => creates state q+1
            self._claim(key, q + 1, value)
            state = self._state_node(key, q + 1)
            self._add_edge(state, point, strict=False)   # equality: write
            self._add_edge(point, state, strict=False)   # q+1 happens AT p
            self._add_edge(point, self._state_node(key, q + 2), strict=True)
        self._add_edge(point, self._new_rt(end_us), strict=False)

    def _check_prefix(self, key, h: _KeyHistory, seq: Tuple[int, ...]) -> None:
        n = min(len(seq), len(h.order))
        if seq[:n] != h.order[:n]:
            raise HistoryViolation(
                f"key {key}: divergent orders {seq} vs {h.order}")
        if len(seq) > len(h.order):
            old_n = len(h.order)
            h.order = tuple(seq)
            for i in range(old_n, len(seq)):
                claimed = h.claims.get(i + 1)
                if claimed is not None and claimed != seq[i]:
                    raise HistoryViolation(
                        f"key {key}: observed order has {seq[i]} at index {i} "
                        f"but write {claimed} claimed it (read {i} prior "
                        f"values): {seq}")
                if self._pending:
                    self._resolve_position(key, seq[i], i)

    @staticmethod
    def _max_len_before(marks: List[Tuple[int, int]], start_us: int) -> int:
        best = 0
        for end, ln in marks:
            if end >= start_us:
                break
            if ln > best:
                best = ln
        return best

    # -- final (quiescent) checks --------------------------------------------
    def check_final_state(self, key_lists: Dict[object, Tuple[int, ...]]) -> None:
        """At quiescence, the authoritative per-key lists must extend the
        observed orders, and every ack'd write must be present somewhere."""
        present = set()
        for key, final in key_lists.items():
            h = self._keys.get(key)
            if h is not None:
                n = min(len(final), len(h.order))
                if final[:n] != h.order[:n]:
                    raise HistoryViolation(
                        f"key {key}: final list {final} diverges from observed "
                        f"order {h.order}")
                if len(final) < len(h.order):
                    raise HistoryViolation(
                        f"key {key}: final list {final} shorter than observed "
                        f"{h.order}")
            for i, v in enumerate(final):
                claimed = h.claims.get(i + 1) if h is not None else None
                if claimed is not None and claimed != v:
                    raise HistoryViolation(
                        f"key {key}: final list has {v} at index {i} but "
                        f"write {claimed} claimed it (read {i} prior values): "
                        f"{final}")
                if self._pending:
                    self._resolve_position(key, v, i)
            present.update(final)
        missing = self._acked - present
        if missing:
            raise HistoryViolation(f"ack'd writes missing from final state: {missing}")
