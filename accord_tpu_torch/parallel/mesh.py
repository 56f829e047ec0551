"""Example inputs of the JAX package's `parallel/mesh.py`, as the port's own
copy (that module imports JAX; these two functions are numpy only).

`example_batch` feeds the graft entry (accord_tpu_torch/graft_entry.py);
`example_resolve_batch` gives deps_resolve-shaped inputs. The sharded
kernels of that module, over torch.distributed, are ROADMAP queue 1 item 4.
"""
from __future__ import annotations

import numpy as np

from accord_tpu_torch.ops.encoding import WITNESS_TABLE


def example_batch(n: int = 64, k: int = 256, seed: int = 0):
    """Deterministic example inputs for compile checks and dry runs."""
    rng = np.random.default_rng(seed)
    bitmaps = (rng.random((n, k)) < 0.05).astype(np.float32)
    hlcs = np.sort(rng.integers(0, 100_000, n))
    ts = np.stack([np.zeros(n, np.int32), hlcs.astype(np.int32),
                   rng.integers(0, 1 << 16, n).astype(np.int32)], axis=1)
    kinds = rng.integers(0, 2, n).astype(np.int32)  # READ/WRITE mix
    return bitmaps, ts, kinds, WITNESS_TABLE.copy()


def example_resolve_batch(cap: int = 512, k: int = 256, b: int = 16,
                          nnz: int = 64, seed: int = 0):
    """Deterministic random inputs in deps_resolve's exact signature shape
    (CSR subject entries padded with out-of-bounds row B, 3-lane int32
    timestamps, arena lanes) -- shared by the dry-run and the
    sharded-vs-single differential tests so the invariants live in one
    place."""
    rng = np.random.default_rng(seed)
    live = rng.random(nnz) < 0.6
    subj_of = np.where(live, rng.integers(0, b, nnz), b).astype(np.int32)
    subj_keys = rng.integers(0, k, nnz).astype(np.int32)
    sb = np.stack([np.zeros(b, np.int32),
                   rng.integers(1000, 100_000, b).astype(np.int32),
                   rng.integers(0, 100, b).astype(np.int32)], 1)
    sknd = rng.integers(0, 5, b).astype(np.int32)
    act_bm = (rng.random((cap, k)) < 0.05).astype(np.float32)
    act_ts = np.stack([np.zeros(cap, np.int32),
                       rng.integers(0, 90_000, cap).astype(np.int32),
                       rng.integers(0, 100, cap).astype(np.int32)], 1)
    act_kinds = rng.integers(0, 5, cap).astype(np.int32)
    act_valid = rng.random(cap) < 0.9
    return (subj_of, subj_keys, sb, sknd, act_bm, act_ts, act_kinds,
            act_valid, WITNESS_TABLE.copy())
