"""The port's twins of the repository's `__graft_entry__` entry points.

entry(device=None)  -- one forward step of the flagship data-plane program
                       -- the deps matrix (K18), the execute-order closure
                       (K19) and the wavefronts (K20) -- on
                       `example_batch(n=128, k=256)`.
dryrun_multichip(n_devices, device=None)
                    -- the FULL sharded step over an n-device mesh (rows
                       over 'data', the bucket contraction over 'model',
                       gathered rounds in the closure and the levels) on
                       small shapes, and the sharded resolver against the
                       single-device K1.

    step, args = entry()            # on the card (raises without one)
    deps, levels = step(*args)
    step, args = entry("cpu")       # the kernels' plain versions
    dryrun_multichip(8)             # 8 cards, or one card 8 times
    dryrun_multichip(8, "cpu")      # the plain versions on a CPU mesh

The bitmaps go to the kernels packed (int32 [n, k/32], carry.pack_bitmaps).
The mesh is the port's single-controller one (parallel/mesh.py): where
fewer cards than `n_devices` are visible, one card stands for every
device of the mesh, as the reference's dry run stands virtual CPU devices
in for chips.
"""
from __future__ import annotations


def entry(device=None):
    import torch

    from accord_tpu_torch.ops import carry
    from accord_tpu_torch.ops import kernels as K
    from accord_tpu_torch.ops.resolver import _resolve_device
    from accord_tpu_torch.parallel.mesh import example_batch

    dev = _resolve_device(device, "graft_entry.entry")
    bitmaps, ts, kinds, table = example_batch(n=128, k=256)

    def step(words, ts, kinds, table):
        valid = torch.ones(words.shape[0], dtype=torch.bool,
                           device=words.device)
        deps = K.deps_matrix(words, ts, kinds, words, ts, kinds, valid,
                             table)
        closed = K.transitive_closure(deps, 7)
        levels = K.execution_wavefronts(closed, 7)
        return deps, levels

    args = (carry.packed(bitmaps, dev),
            *(torch.from_numpy(a).to(dev) for a in (ts, kinds, table)))
    return step, args


def dryrun_multichip(n_devices: int, device=None) -> None:
    import torch

    from accord_tpu_torch.ops import carry
    from accord_tpu_torch.ops import kernels as K
    from accord_tpu_torch.ops.resolver import _resolve_device
    from accord_tpu_torch.parallel.mesh import (example_batch,
                                                example_resolve_batch,
                                                make_mesh,
                                                sharded_deps_resolve,
                                                sharded_deps_step)

    dev = _resolve_device(device, "graft_entry.dryrun_multichip")
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.device_count() >= n_devices:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    mesh = make_mesh(devices=devices)
    home = mesh.device(0, 0)
    step = sharded_deps_step(mesh, closure_iters=4)
    data_dim = mesh.shape["data"]
    model_dim = mesh.shape["model"]
    n = max(32, 8 * data_dim)
    k = 128 * model_dim
    bitmaps, ts, kinds, table = example_batch(n=n, k=k)
    deps, levels = step(carry.packed(bitmaps, home),
                        *(torch.from_numpy(a).to(home)
                          for a in (ts, kinds, table)))
    assert deps.shape == (n, n) and levels.shape == (n,)

    # the production multi-device path: the sharded resolver (arena rows
    # over 'data', bucket contraction over 'model') must run over the same
    # mesh AND agree with the single-device kernel (K1)
    lanes = example_resolve_batch(cap=32 * data_dim * 4, k=k, b=8, seed=1)
    args = [torch.from_numpy(a).to(home) for a in lanes]
    args[4] = carry.packed(lanes[4], home)
    sharded = sharded_deps_resolve(mesh)(*args)
    single = K.deps_resolve(*args)
    assert torch.equal(sharded, single), "sharded resolver kernel diverged"
