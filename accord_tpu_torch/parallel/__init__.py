"""Multi-device layer of the port: a single-controller (data, model) mesh
of torch devices and the sharded deps data plane (mesh.py)."""
from accord_tpu_torch.parallel.mesh import make_mesh, sharded_deps_step

__all__ = ["make_mesh", "sharded_deps_step"]
