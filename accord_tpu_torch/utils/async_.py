"""Asynchronous continuation primitives.

Equivalent in role to the reference's AsyncChain/AsyncResult monadic pipeline
(utils/async/AsyncChain.java:29, AsyncChains.java): all cross-node and
cross-store control flow is expressed as callback chains. Unlike the JVM
version there are no threads here -- the whole cluster runs on one logical
event loop -- so callbacks run synchronously at set() time, which preserves
simulation determinism by construction.
"""
from __future__ import annotations

from typing import Any, Callable, Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")
U = TypeVar("U")

# Callback signature: fn(result, failure) with exactly one of them non-None
# (result may legitimately be None for success-with-no-value; failure None
# means success).
Callback = Callable[[Any, Optional[BaseException]], None]


class AsyncResult(Generic[T]):
    """A settable single-assignment result with synchronous callback delivery."""

    __slots__ = ("_done", "_value", "_failure", "_callbacks")

    def __init__(self) -> None:
        self._done = False
        self._value: Optional[T] = None
        self._failure: Optional[BaseException] = None
        self._callbacks: List[Callback] = []

    # -- producer side -------------------------------------------------------
    def set_success(self, value: T = None) -> "AsyncResult[T]":
        if self._done:
            raise RuntimeError("result already set")
        self._done = True
        self._value = value
        self._fire()
        return self

    def set_failure(self, failure: BaseException) -> "AsyncResult[T]":
        if self._done:
            raise RuntimeError("result already set")
        self._done = True
        self._failure = failure
        self._fire()
        return self

    def try_set_success(self, value: T = None) -> bool:
        if self._done:
            return False
        self.set_success(value)
        return True

    def try_set_failure(self, failure: BaseException) -> bool:
        if self._done:
            return False
        self.set_failure(failure)
        return True

    def _fire(self) -> None:
        callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self._value, self._failure)

    # -- consumer side -------------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done

    @property
    def success(self) -> bool:
        return self._done and self._failure is None

    @property
    def failure(self) -> Optional[BaseException]:
        return self._failure

    def value(self) -> T:
        if not self._done:
            raise RuntimeError("result not set")
        if self._failure is not None:
            raise self._failure
        return self._value  # type: ignore[return-value]

    def add_callback(self, cb: Callback) -> "AsyncResult[T]":
        if self._done:
            cb(self._value, self._failure)
        else:
            self._callbacks.append(cb)
        return self

    def on_success(self, fn: Callable[[T], None]) -> "AsyncResult[T]":
        return self.add_callback(lambda v, f: fn(v) if f is None else None)

    def on_failure(self, fn: Callable[[BaseException], None]) -> "AsyncResult[T]":
        return self.add_callback(lambda v, f: fn(f) if f is not None else None)

    # -- combinators ---------------------------------------------------------
    def map(self, fn: Callable[[T], U]) -> "AsyncResult[U]":
        out: AsyncResult[U] = AsyncResult()

        def cb(v, f):
            if f is not None:
                out.set_failure(f)
            else:
                try:
                    out.set_success(fn(v))
                except BaseException as e:  # noqa: BLE001 - propagate into chain
                    out.set_failure(e)

        self.add_callback(cb)
        return out

    def flat_map(self, fn: Callable[[T], "AsyncResult[U]"]) -> "AsyncResult[U]":
        out: AsyncResult[U] = AsyncResult()

        def cb(v, f):
            if f is not None:
                out.set_failure(f)
            else:
                try:
                    inner = fn(v)
                except BaseException as e:  # noqa: BLE001
                    out.set_failure(e)
                    return
                inner.add_callback(
                    lambda v2, f2: out.set_failure(f2) if f2 is not None else out.set_success(v2)
                )

        self.add_callback(cb)
        return out

    def recover(self, fn: Callable[[BaseException], T]) -> "AsyncResult[T]":
        out: AsyncResult[T] = AsyncResult()

        def cb(v, f):
            if f is None:
                out.set_success(v)
            else:
                try:
                    out.set_success(fn(f))
                except BaseException as e:  # noqa: BLE001
                    out.set_failure(e)

        self.add_callback(cb)
        return out


# Reference parity: AsyncChain is the lazy variant; in our synchronous world a
# chain IS a result, so we alias the name for readability at call sites.
AsyncChain = AsyncResult


def settable() -> AsyncResult:
    return AsyncResult()


def success(value=None) -> AsyncResult:
    return AsyncResult().set_success(value)


def failure(exc: BaseException) -> AsyncResult:
    return AsyncResult().set_failure(exc)


def all_of(results: List[AsyncResult]) -> AsyncResult[list]:
    """Completes with the list of values once every input completes; fails fast
    with the first failure."""
    out: AsyncResult[list] = AsyncResult()
    if not results:
        return out.set_success([])
    remaining = [len(results)]
    values: List[Any] = [None] * len(results)

    def make_cb(i: int) -> Callback:
        def cb(v, f):
            if out.done:
                return
            if f is not None:
                out.set_failure(f)
                return
            values[i] = v
            remaining[0] -= 1
            if remaining[0] == 0:
                out.set_success(values)

        return cb

    for i, r in enumerate(results):
        r.add_callback(make_cb(i))
    return out


def reduce_all(results: List[AsyncResult], fn: Callable[[Any, Any], Any]) -> AsyncResult:
    return all_of(results).map(lambda vs: _reduce(vs, fn))


def _reduce(values: list, fn):
    acc = values[0]
    for v in values[1:]:
        acc = fn(acc, v)
    return acc
