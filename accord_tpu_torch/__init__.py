"""accord_tpu_torch: the PyTorch/CUDA port of the accord_tpu package.

The protocol, the local engine, the messages and the deterministic
simulator are this package's own copies of the reference's host layers
(see tools/copy_host.py); the device layer (`ops/`) runs on PyTorch, with
every kernel on a ported path written by hand in CUDA C++ for Hopper
(`csrc/`). Importing the package loads neither JAX nor Triton, and
builds nothing: the kernels compile at their first launch on a card.

Ported so far: the key-domain batched PreAccept deps path
(ops.resolver.BatchDepsResolver). ROADMAP.md lists the rest.
"""

__version__ = "0.1.0"
