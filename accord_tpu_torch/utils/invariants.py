"""Invariant / paranoia assertion layer.

The reference gates expensive correctness checks behind paranoia tiers driven by
system properties (accord-core utils/Invariants.java:31-57, cost classes
NONE/LINEAR/SUPERLINEAR). We do the same with environment variables so the burn
test can run with full checking while benchmarks run lean.

  ACCORD_TPU_PARANOIA         = none | linear | superlinear   (default linear)
"""
from __future__ import annotations

import os


class IllegalState(RuntimeError):
    pass


class IllegalArgument(ValueError):
    pass


_LEVELS = {"none": 0, "linear": 1, "superlinear": 2}


class Invariants:
    paranoia: int = _LEVELS.get(os.environ.get("ACCORD_TPU_PARANOIA", "linear"), 1)

    @staticmethod
    def check_state(condition: bool, msg: str = "illegal state", *args) -> None:
        if not condition:
            raise IllegalState(msg % args if args else msg)

    @staticmethod
    def check_argument(condition: bool, msg: str = "illegal argument", *args) -> None:
        if not condition:
            raise IllegalArgument(msg % args if args else msg)

    @staticmethod
    def non_null(value, msg: str = "unexpected null"):
        if value is None:
            raise IllegalState(msg)
        return value

    @classmethod
    def paranoid(cls) -> bool:
        """Linear-cost checks enabled?"""
        return cls.paranoia >= 1

    @classmethod
    def super_paranoid(cls) -> bool:
        """Superlinear-cost checks enabled?"""
        return cls.paranoia >= 2

    @classmethod
    def if_paranoid(cls, condition_fn, msg: str = "paranoia check failed") -> None:
        if cls.paranoia >= 1 and not condition_fn():
            raise IllegalState(msg)
