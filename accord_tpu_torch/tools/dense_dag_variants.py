"""Time K18 (deps_matrix), K19 (transitive_closure) and K21
(dag_wavefronts_packed) of `csrc/dense_dag.cu` beside the parent's kernels
and the variants that lost.

Builds three libraries, in parallel: the parent's kernels
(`tools/dense_dag_parent.cu`), the shipped source (K18's overlap as
`mma.sync.m16n8k256.b1.and.popc` on the tensor cores) and K18
register-tiled on the CUDA cores (`tools/dense_dag_cuda_cores.cu`,
walking each subject row's nonzero words). K19 without the early exit is
the shipped library's pack_rows and `iterations` closure_rows over every
row, ping-ponged (no unpack). On chip_smoke.py's dense batch (K18 at
4,096 x 16,384, K 1,024; K19 at N 8,192, 13 iterations) each variant's C
entries are called directly on preallocated outputs, held bit-equal to
the plain version, and timed as device ms: a CUDA graph of calls
replayed between CUDA events, the variants interleaved (A B C C B A,
three rounds) and the median kept. The bf16 matmul yardsticks (K18's
overlap stage, one K19 squaring) are timed the same way. `ptxas -v`
lines of the kernels are kept. K21 runs on bench_dag's DAG (chip_smoke.py's
generator, seed 5) at N 100,000 and at N 8,192, 192 levels: the parent's
(2 x max_levels + 3 stream operations; its entry has the shipped
signature), the shipped one (one persistent cooperative launch; DW_K 16
words a lane a scan step, DW_B 4 kept words a lane tests at once, DW_C 64
blocking words kept a row) and copies of the shipped source with DW_K 8,
DW_B 8 and DW_C 32, each held bit-equal to the plain version and timed the
same way.

    python -m accord_tpu_torch.tools.dense_dag_variants

Needs a card and nvcc. Prints the card line and one JSON object.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
TOOLS = pathlib.Path(__file__).resolve().parent
SHIPPED = ROOT / "accord_tpu_torch" / "csrc" / "dense_dag.cu"
# name -> (source, its #define values changed: a copy of it is built)
VARIANTS = {"parent": (TOOLS / "dense_dag_parent.cu", {}),
            "shipped": (SHIPPED, {}),
            "deps_register_tiled": (TOOLS / "dense_dag_cuda_cores.cu", {}),
            "k21_dw_k8": (SHIPPED, {"DW_K": 8}),
            "k21_dw_b8": (SHIPPED, {"DW_B": 8}),
            "k21_dw_c32": (SHIPPED, {"DW_C": 32})}
K18 = ("parent", "deps_register_tiled", "shipped")
K19 = ("parent", "shipped", "closure_no_exit")
K21 = ("parent", "shipped", "k21_dw_k8", "k21_dw_b8", "k21_dw_c32")
K21_SIZES = ((100_000, 2), (8_192, 20))   # (N, calls a graph)
K21_LEVELS = 192
K21_BUF_ROW = 2 * 65 + 5   # int32 scratch a row, enough for DW_C <= 64
CALLS = {"deps_matrix": 100, "transitive_closure": 4}
ROUNDS = 3
VP, I = ctypes.c_void_p, ctypes.c_int


def build_variants() -> tuple:
    """(name -> loaded library, name -> ptxas lines of K18's and K19's
    kernels), all compiled in parallel."""
    from accord_tpu_torch.ops import _ext
    from accord_tpu_torch.tools import deps_block_variants as dbv
    out_dir = _ext.BUILD / "dense_dag_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (path, values) in VARIANTS.items():
        so = out_dir / f"{name}.so"
        if values:
            path = dbv.with_constants(path, out_dir / f"{name}.cu", values)
        procs[name] = (so, subprocess.Popen(
            [_ext.nvcc(), *_ext.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_ext.CSRC), "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
        ptxas[name] = _kernel_lines(log)
    return libs, ptxas


def _kernel_lines(log: str) -> dict:
    """kernel -> its ptxas 'Used ... registers' and spill lines."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = next((k for k in ("deps_matrix_kernel",
                                    "closure_tile_kernel",
                                    "closure_square_kernel",
                                    "dag_settle_kernel", "dag_round_kernel")
                        if k in m.group(1)), None)
        elif cur and ("registers" in line or "spill" in line):
            out.setdefault(cur, []).append(line.split("info    :")[-1]
                                           .strip())
    return out


def _fn(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _stream() -> int:
    """The current stream (a graph capture's own while capturing)."""
    from accord_tpu_torch.ops import _ext
    return _ext.raw_stream(0)


def deps_caller(lib, args, out):
    """One K18 launch of `lib` on args into out."""
    sw, sb, sk, aw, at, ak, av, wt = args
    fn = _fn(lib, "deps_matrix", (VP,) * 8 + (I,) * 5 + (VP, VP))
    ptrs = [t.data_ptr() for t in args]
    b, kw = sw.shape
    dims = (wt.shape[0], wt.shape[1], b, aw.shape[0], kw)

    def call():
        rc = fn(*ptrs, *dims, out.data_ptr(), _stream())
        if rc:
            raise RuntimeError(f"deps_matrix: CUDA error {rc}")
    return call


def closure_caller(lib, parent: bool, adj, iters: int, bufs):
    """One K19 call (pack, squarings, unpack) of `lib` on adj into bufs'
    out; the shipped signature also takes the flags scratch and the
    worked counter."""
    n = adj.shape[0]
    pa, pb, out, flags, worked = bufs
    if parent:
        fn = _fn(lib, "transitive_closure", (VP, I, I, VP, VP, VP, VP))
        ptrs = (adj.data_ptr(), n, iters, pa.data_ptr(), pb.data_ptr(),
                out.data_ptr())
    else:
        fn = _fn(lib, "transitive_closure", (VP, I, I) + (VP,) * 6)
        ptrs = (adj.data_ptr(), n, iters, pa.data_ptr(), pb.data_ptr(),
                out.data_ptr(), flags.data_ptr(), worked.data_ptr())

    def call():
        rc = fn(*ptrs, _stream())
        if rc:
            raise RuntimeError(f"transitive_closure: CUDA error {rc}")
    return call


def closure_no_exit_caller(lib, adj, iters: int, bufs):
    """K19 without the early exit: the shipped library's pack_rows, then
    `iters` closure_rows over every row, each from the previous result
    (no unpack: the result stays packed in bufs[iters % 2])."""
    n = adj.shape[0]
    pack = _fn(lib, "pack_rows", (VP, I, I, VP, VP))
    rows = _fn(lib, "closure_rows", (VP, I, I, I, VP, VP, VP))
    ping = (bufs[0].data_ptr(), bufs[1].data_ptr())
    flags = bufs[3].data_ptr()

    def call():
        st = _stream()
        rc = pack(adj.data_ptr(), n, n, ping[0], st)
        for it in range(iters):
            rc = rc or rows(ping[it % 2], n, 0, n, ping[(it + 1) % 2],
                            flags, st)
        if rc:
            raise RuntimeError(f"closure_rows: CUDA error {rc}")
    return call


def k21_caller(lib, adj, levels: int, out, buf, flags):
    """One K21 call of `lib` (the shipped signature, the parent's too) on
    adj into out, over its own scratch."""
    n, nw = adj.shape
    fn = _fn(lib, "dag_wavefronts_packed", (VP, I, I, I, VP, VP, VP, I, VP))
    ptrs = (adj.data_ptr(), n, nw, levels, out.data_ptr(), buf.data_ptr(),
            flags.data_ptr(), 0)

    def call():
        rc = fn(*ptrs, _stream())
        if rc:
            raise RuntimeError(f"dag_wavefronts_packed: CUDA error {rc}")
    return call


# the parent's K21 alone, bound in place of the shipped entry (chip_smoke)
_PARENT: list = []


def _parent_so() -> pathlib.Path:
    from accord_tpu_torch.ops import _ext
    return _ext.BUILD / "dense_dag_variants" / "parent_only.so"


def start_parent_build():
    """Start nvcc on the parent's file alone; finish_parent_build waits."""
    from accord_tpu_torch.ops import _ext
    so = _parent_so()
    so.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_ext.nvcc(), *_ext.NVCC_FLAGS, "-I", str(_ext.CSRC), "-o", str(so),
         str(VARIANTS["parent"][0])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def finish_parent_build(proc) -> ctypes.CDLL:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for dense_dag_parent.cu:\n{log}")
    _PARENT[:] = [ctypes.CDLL(str(_parent_so()))]
    return _PARENT[0]


@contextlib.contextmanager
def k21_parent():
    """Inside, K21's entry resolves to the parent's library (through
    deps_block_variants.bound)."""
    from accord_tpu_torch.ops import kernels
    from accord_tpu_torch.tools import deps_block_variants as dbv
    lib = _PARENT[0] if _PARENT else finish_parent_build(
        start_parent_build())
    with dbv.bound(lib, {("dense_dag", "dag_wavefronts_packed"):
                         kernels._DAG_ARGS}, "parent K21"):
        yield


def graph_device_ms(fn, calls: int) -> float:
    """Device ms a call: `calls` calls of fn in one CUDA graph, replayed
    three times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * calls)


def interleaved(fns: dict, calls: int) -> dict:
    """name -> (median device ms, samples), the names timed A B C C B A
    for ROUNDS rounds."""
    names = list(fns)
    samples = {n: [] for n in names}
    for _ in range(ROUNDS):
        for n in names + names[::-1]:
            samples[n].append(graph_device_ms(fns[n], calls))
    return {n: (statistics.median(v), v) for n, v in samples.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dense_dag_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from accord_tpu_torch.ops import kernels as tk
    card = smoke.card_line(True)
    libs, ptxas = build_variants()
    dev = torch.device("cuda")
    dm_args, mid = smoke.dense_batch_args("cuda", False)
    report = {"card": card, "ptxas": ptxas, "calls_a_graph": CALLS}

    # K18
    want = tk.deps_matrix_plain(*dm_args)
    fns = {}
    for name in K18:
        out = torch.empty_like(want)
        fns[name] = deps_caller(libs[name], dm_args, out)
        out.zero_()
        fns[name]()
        err = smoke.max_abs_err(out, want)
        smoke.check(err == 0, f"deps_matrix {name}: differs from the plain "
                    f"version by {err}")
    sw, aw = dm_args[0], dm_args[3]
    s_bf = tk._unpack_bits(sw).to(torch.bfloat16)
    a_bf = tk._unpack_bits(aw).to(torch.bfloat16).T.contiguous()
    fns["library_bf16_matmul"] = lambda: torch.matmul(s_bf, a_bf)
    k18 = interleaved(fns, CALLS["deps_matrix"])
    report["deps_matrix"] = {
        "shape": [int(sw.shape[0]), int(aw.shape[0]), 32 * int(sw.shape[1])],
        "device_ms": {n: v[0] for n, v in k18.items()},
        "device_ms_samples": {n: v[1] for n, v in k18.items()}}

    # K19
    iters = 13
    want_w = torch.zeros(1, dtype=torch.int32, device=dev)
    want = tk.transitive_closure_plain(mid, iters, want_w)
    n = mid.shape[0]
    nw = (n + 31) // 32
    fns, worked = {}, {}
    for name in K19:
        bufs = (torch.empty(n, nw, dtype=torch.int32, device=dev),
                torch.empty(n, nw, dtype=torch.int32, device=dev),
                torch.empty_like(mid),
                torch.zeros(16, dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))
        if name == "closure_no_exit":
            fns[name] = closure_no_exit_caller(libs["shipped"], mid, iters,
                                               bufs)
            fns[name]()
            got = tk._unpack_bits(bufs[iters % 2])[:, :n]
        else:
            fns[name] = closure_caller(libs[name], name == "parent", mid,
                                       iters, bufs)
            fns[name]()
            got = bufs[2]
            if name != "parent":
                worked[name] = int(bufs[4])
        err = smoke.max_abs_err(got, want)
        smoke.check(err == 0, f"transitive_closure {name}: differs from the "
                    f"plain version by {err}")
    smoke.check(worked["shipped"] == int(want_w),
                f"transitive_closure: {worked['shipped']} squarings did work, "
                f"the plain version counts {int(want_w)}")
    rf = mid.to(torch.bfloat16)
    fns["library_bf16_squaring"] = lambda: torch.matmul(rf, rf)
    k19 = interleaved(fns, CALLS["transitive_closure"])
    report["transitive_closure"] = {
        "n": int(n), "iterations": iters, "squarings_worked": worked,
        "device_ms": {n_: v[0] for n_, v in k19.items()},
        "device_ms_samples": {n_: v[1] for n_, v in k19.items()}}

    # K21
    k21 = {}
    for n, calls in K21_SIZES:
        adj = smoke._dag_words(n, "cuda", 5)
        want = tk.dag_wavefronts_packed_plain(adj, K21_LEVELS)
        fns = {}
        for name in K21:
            out = torch.empty(n, dtype=torch.int32, device=dev)
            buf = torch.empty(K21_BUF_ROW * n + 2 * (n // 32)
                              + 2 * K21_LEVELS, dtype=torch.int32,
                              device=dev)
            flags = torch.zeros(4, dtype=torch.int32, device=dev)
            fns[name] = k21_caller(libs[name], adj, K21_LEVELS, out, buf,
                                   flags)
            out.fill_(-7)
            fns[name]()
            err = smoke.max_abs_err(out, want)
            smoke.check(err == 0, f"dag_wavefronts_packed {name} at N {n}: "
                        f"differs from the plain version by {err}")
            smoke.check(not bool(flags.any()), f"dag_wavefronts_packed "
                        f"{name}: its flags are not left zeroed")
        t = interleaved(fns, calls)
        k21[str(n)] = {"depth": int(want.max()),
                       "settled": bool((want >= 0).all()),
                       "levels": K21_LEVELS, "calls_a_graph": calls,
                       "device_ms": {k: v[0] for k, v in t.items()},
                       "device_ms_samples": {k: v[1] for k, v in t.items()}}
        del adj
        torch.cuda.empty_cache()
    report["dag_wavefronts_packed"] = k21
    print(card)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
