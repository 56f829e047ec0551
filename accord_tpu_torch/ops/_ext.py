"""Build and load the port's CUDA kernels.

Every `accord_tpu_torch/csrc/*.cu` file is one shared library with a plain
C interface: `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`, one process per source, all started together, into
`build/accord_tpu_torch/` at the repository root (named by a hash of the
sources, so an edit rebuilds). The libraries load with `ctypes`; every
pointer and the stream pass as `c_void_p`. Each C entry point returns
`cudaGetLastError()` after its launches, and `call` raises when that is
not 0, so a refused launch never passes silently. `entry` is the lean
form of `call` for the small kernels whose host path is most of their
time (K4, K15): the function is resolved once with its argtypes set.

Nothing here runs when the module is imported: the first kernel launch
builds, so an installation without a card or nvcc (the CPU tests) never
reaches it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "accord_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], Callable[..., None]] = {}
# wall seconds of the last build (all sources, in parallel); None until built
build_seconds: Optional[float] = None
# `-Xptxas -v` output per source from the last build (registers, spills)
ptxas_log: Dict[str, str] = {}


def nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Dict[str, pathlib.Path]:
    """Compile every source (in parallel) unless this digest is built;
    returns name -> library path."""
    global build_seconds
    tag = _digest()
    BUILD.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    out = {p.stem: BUILD / f"{p.stem}-{tag}.so" for p in sources}
    todo = [p for p in sources if not out[p.stem].exists()]
    if not todo:
        return out
    t0 = time.perf_counter()
    exe = nvcc()
    procs = []
    for p in todo:
        tmp = BUILD / f"{p.stem}-{tag}.{os.getpid()}.tmp.so"
        cmd = [exe, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
               "-o", str(tmp), str(p)]
        procs.append((p, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for p, tmp, proc in procs:
        log, _ = proc.communicate()
        ptxas_log[p.stem] = log
        if proc.returncode != 0:
            errors.append(f"{p.name}:\n{log}")
            continue
        os.replace(tmp, out[p.stem])
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    build_seconds = time.perf_counter() - t0
    return out


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` (building all on first use)."""
    handle = _LIBS.get(name)
    if handle is None:
        for stem, path in build().items():
            if stem not in _LIBS:
                _LIBS[stem] = ctypes.CDLL(str(path))
        handle = _LIBS[name]
    return handle


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a contiguous CUDA tensor."""
    return ctypes.c_void_p(t.data_ptr())


def ctypes_null() -> ctypes.c_void_p:
    return ctypes.c_void_p(None)


def stream() -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise(handle, name: str, entry: str, rc: int) -> None:
    err = handle.accord_error_string
    err.restype = ctypes.c_char_p
    raise RuntimeError(f"{name}.{entry}: CUDA error {rc}: "
                       f"{err(ctypes.c_int(rc)).decode()}")


def call(name: str, entry: str, *args) -> None:
    """Run one C entry point of `csrc/<name>.cu` and raise on its
    cudaGetLastError() result. Ints pass as c_int unless already ctypes;
    a ctypes array passes as a pointer to its first element."""
    handle = lib(name)
    fn = getattr(handle, entry)
    fn.restype = ctypes.c_int
    cargs = [a if isinstance(a, (ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.Array))
             else ctypes.c_int(a) for a in args]
    rc = fn(*cargs)
    if rc != 0:
        _raise(handle, name, entry, rc)


def entry(name: str, entry_name: str,
          argtypes: Sequence[type]) -> Callable[..., None]:
    """The lean launch path: one C entry point of `csrc/<name>.cu`,
    resolved once with its `argtypes` and restype set, called with plain
    Python ints (pointers and the stream as ints, `raw_stream()`), raising
    on a nonzero cudaGetLastError() result exactly as `call` does."""
    key = (name, entry_name)
    f = _ENTRIES.get(key)
    if f is None:
        handle = lib(name)
        fn = getattr(handle, entry_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int

        def f(*args, _fn=fn, _handle=handle):
            rc = _fn(*args)
            if rc != 0:
                _raise(_handle, name, entry_name, rc)
        _ENTRIES[key] = f
    return f


def raw_stream(index: int) -> int:
    """The current CUDA stream of card `index` (a CUDA tensor's
    `device.index`) as an int, without building a Stream object."""
    import torch
    return torch._C._cuda_getCurrentRawStream(index)
