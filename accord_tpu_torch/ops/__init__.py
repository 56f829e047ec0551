"""The port's device layer: the key-domain deps path on PyTorch, with its
kernels hand-written in CUDA for Hopper (`accord_tpu_torch/csrc/`).

  kernels.py   CUDA wrappers + their plain PyTorch versions
  mailbox.py   the device message plane (MailboxPlane, K17 mailbox_route)
  resolver.py  DepsResolver SPI, BatchDepsResolver (device arenas per store)
  deltas.py    single-lane dirty-row uploads (row_scatter)
  carry.py     a JAX arena's (or mailbox plane's, or dense adjacency's)
               lanes -> this port's device lanes
  _ext.py      nvcc build + ctypes loading of csrc/*.cu
  tiers.py, encoding.py, fault_plane.py   numpy-only copies of the reference
"""
