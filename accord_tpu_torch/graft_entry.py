"""The port's twin of the repository's `__graft_entry__.entry`: one forward
step of the flagship data-plane program -- the deps matrix (K18), the
execute-order closure (K19) and the wavefronts (K20) -- on
`example_batch(n=128, k=256)`.

    step, args = entry()            # on the card (raises without one)
    deps, levels = step(*args)
    step, args = entry("cpu")       # the kernels' plain versions

The bitmaps go to the kernels packed (int32 [n, k/32], carry.pack_bitmaps).
The twin of `dryrun_multichip` waits for the multi-GPU port (ROADMAP queue
1 item 4).
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
