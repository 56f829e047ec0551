"""Time the sharded finalize's table (csrc/finalize_csr.cu `fin_shard_tab`:
every key finalize of a sharded tick in ONE launch) and K22's fragment
merge (csrc/mesh_combine.cu `fragment_merge`, ONE launch) beside their
parents (`tools/sharded_finalize_parent.cu`), on the same card in the same
process.

The parent's file builds alone (nvcc, seconds: a plain C interface).
`parent_stage()` puts the parent's graph stage in place of the shipped one
(ops/tick_graph.py `_stage_fin_shard`): each finalize its own chain of
graph nodes -- a count launch over every (data, model) shard's record, K22's
counts_scan, a compaction launch into per-shard fragments (each after a
memset) and the parent's merge -- through the parent's entries.
`parent_merge()` binds the parent's merge (same C signature) in ops/_ext.py's
entry cache (deps_block_variants.bound), with an accumulator of its own in
place of the shipped wrapper's zeroed scratch, which the parent would leave
dirty. The pair helpers (A B B A interleaved graph replays, three rounds,
the median; every pair bit-equal):

    tab_pair(mesh, wt, key_in, fins)   a sharded_protocol_tick graph of the
                                       key stage and the finalizes (their
                                       outputs compared), the replay with
                                       each stage
    table_pairs(mesh, specs)           the table's launch alone, CALLS a
                                       graph, beside a build of it without
                                       its record cache (each word loading
                                       its record's fields;
                                       `uncached_table()` binds it) and
                                       beside the single-device table on
                                       the specs
    merge_pair(frags, indptr, act_ts)  one _sum_merge_fragments call,
                                       CALLS calls a graph
    scan_pair(counts, bounds)          one _gather_counts call beside the
                                       parent's counts_scan
                                       (`parent_scan()`), CALLS a graph

Run alone it times the table at the 10k tick (128 finalizes, chip_smoke.py's
merged tick) on the virtual 4 x 2 mesh and on make_mesh(), beside the key
stage's replay alone and as its launch alone, and the merge and the counts
scan at the sharded key burn's largest call
(800 ops) and at the PreAccept batch's sharded finalize (chip_smoke.py's
batch: 4,096 slots, cap 16,384):

    python -m accord_tpu_torch.tools.sharded_finalize_variants

Needs a card and nvcc. Prints the card line and one JSON object.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import pathlib
import subprocess
import sys

from accord_tpu_torch.tools import deps_block_variants as dbv

ROOT = pathlib.Path(__file__).resolve().parents[2]
PARENT = pathlib.Path(__file__).resolve().parent / \
    "sharded_finalize_parent.cu"
_LIB: list = []      # the parent's library, the uncached table's
_ACC: list = []      # the parent merge's accumulator, one a process
_VP, _I = ctypes.c_void_p, ctypes.c_int
# the parent's stage entries
_PACK_ARGS = (_VP, _VP, _I, _I, _VP, _I, _I, _I, _I, _VP, _VP, _VP, _VP,
              _VP, _I, _I, _VP, _VP)
_COUNT_TAB_ARGS = (_VP, _I, _I, _VP, _I, _VP)
_COMPACT_TAB_ARGS = (_VP, _I, _I, _I, _VP, _I, _VP)


def _dir() -> pathlib.Path:
    from accord_tpu_torch.ops import _ext
    return _ext.BUILD / "sharded_finalize_variants"


# the sharded table's word source without its record cache: each word
# divides for its shard and loads the fields it reads from that record
_UNCACHED_SPAN = """struct ShardSpan {
  const ShardFin* rec;
  int wl;

  __device__ __forceinline__ unsigned word(int sl, int wd, long long,
                                           unsigned* kw) const {
    const int d = wd / wl;
    return rec[d].word(sl, wd - d * wl, kw);
  }
};
"""


def _uncached_source(dst: pathlib.Path) -> pathlib.Path:
    """A copy of csrc/finalize_csr.cu whose ShardSpan is _UNCACHED_SPAN."""
    from accord_tpu_torch.ops import _ext
    text = (_ext.CSRC / "finalize_csr.cu").read_text()
    start = text.find("struct ShardSpan {")
    end = text.find("};\n", start)
    if start < 0 or end < 0:
        raise RuntimeError("finalize_csr.cu defines no ShardSpan")
    dst.write_text(text[:start] + _UNCACHED_SPAN + text[end + 3:])
    return dst


def start_build():
    """Start nvcc on the parent's file and on a copy of csrc/finalize_csr.cu
    without the table's record cache (_UNCACHED_SPAN), to overlap the
    shipped build; finish_build waits for them."""
    from accord_tpu_torch.ops import _ext
    out = _dir()
    out.mkdir(parents=True, exist_ok=True)
    uncached = _uncached_source(out / "uncached.cu")
    return [subprocess.Popen(
        [_ext.nvcc(), *_ext.NVCC_FLAGS, "-I", str(_ext.CSRC), "-o",
         str(out / f"{src.stem}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for src in (PARENT, uncached)]


def finish_build(procs) -> ctypes.CDLL:
    for proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.args[-1]}):\n{log}")
    _LIB[:] = [ctypes.CDLL(str(_dir() / f"{stem}.so"))
               for stem in (PARENT.stem, "uncached")]
    return _LIB[0]


def _lib() -> ctypes.CDLL:
    return _LIB[0] if _LIB else finish_build(start_build())


def _fn(lib, name: str, argtypes):
    """lib's entry `name` with its argtypes, raising on a CUDA error."""
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int

    def call(*args):
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"parent {name}: CUDA error {rc}")
    return call


def _parent_stage_fn(lib):
    """The parent's _stage_fin_shard (ops/tick_graph.py) over the parent's
    entries: a count launch over every (data, model) shard's record,
    counts_scan, a compaction launch over every data shard's record and
    the merge, each finalize its own chain."""
    import torch
    from accord_tpu_torch.ops import node_lane as nl
    from accord_tpu_torch.ops import tick_graph as tg
    from accord_tpu_torch.parallel import mesh as pm
    pack = _fn(lib, "shard_fin_pack", _PACK_ARGS)
    count_tab = _fn(lib, "fin_shard_count_tab", _COUNT_TAB_ARGS)
    compact_tab = _fn(lib, "fin_shard_compact_tab", _COMPACT_TAB_ARGS)
    scan = _fn(lib, "counts_scan", pm._COUNTS_SCAN_ARGS)
    merge = _fn(lib, "fragment_merge", pm._MERGE_ARGS)
    rec = int(lib.shard_fin_bytes())

    def stage(P, ext, spec, args, src, mesh):
        kind, rows, words, out_cap = spec
        (r0, w_lo, word_off, kid_rows, slot_subj, slot_kid, subj_row,
         act_ts) = args
        data, model = mesh.shape["data"], mesh.shape["model"]
        s_ref, s_view, wt = src
        nr = s_view[2][0]
        kc, w = kid_rows.shape
        wl = w // data
        s = slot_subj.shape[0]
        r = nl.dyn_start(r0, nr, rows)
        c = nl.dyn_start(w_lo, wt, words)
        off = min(max(int(word_off), 0), words - w)
        P.sig.append(("sfin", kind, rows, words, out_cap))
        k_ptr, ss, sk, sr = (P.ptr(x) for x in (kid_rows, slot_subj,
                                                slot_kid, subj_row))
        ts = P.inp(act_ts)
        split = s % model == 0
        ents = [(d, m) for d in range(data) for m in range(model)
                if split or m == 0]
        ctab = P.alloc("p", rec * len(ents))
        xtab = P.alloc("p", rec * data)
        counts = P.alloc("f", 4 * data * s)
        bounds = P.alloc("f", 4 * data * model)
        seg = P.alloc("f", 4 * data * s)
        frags = P.alloc("f", 4 * data * out_cap)
        acc = P.alloc("f", 12)
        outs = [P.out(sh, torch.int32) for sh in ((s + 1,), (out_cap,),
                                                  (out_cap, 3), (), ())]
        indptr, dep_rows, dep_ts, bound, csum = (o[0] for o in outs)
        blk_ref = tg._shift(s_ref, 4 * (r * wt + c + off))

        def write(pin_addr, bases):
            blk, kid = tg._addr(bases, blk_ref), tg._addr(bases, k_ptr)
            lanes = [tg._addr(bases, x) for x in (ss, sk, sr)]
            cnt, bnd = tg._addr(bases, counts), tg._addr(bases, bounds)
            sgb, frg = tg._addr(bases, seg), tg._addr(bases, frags)
            for i, (d, m) in enumerate(ents + [(d, 0) for d in range(data)]):
                lo, hi = (m * (s // model), (m + 1) * (s // model)) \
                    if split else (0, s)
                dst = pin_addr + (ctab[1] + i * rec if i < len(ents)
                                  else xtab[1] + (i - len(ents)) * rec)
                pack(dst, blk + 4 * d * wl, wt, rows, kid + 4 * d * wl, w,
                     kc, wl, d * wl, *lanes,
                     cnt + 4 * d * s if m == 0 else None,
                     bnd + 4 * (d * model + m), lo, hi, sgb + 4 * d * s,
                     frg + 4 * d * out_cap)
        P.calls.append(write)

        def go(B):
            A = tg._addrs(B)
            count_tab(A(ctab), len(ents), s, A(bounds), data * model,
                      ext.stream())
            scan(A(counts), data, s, A(bounds), data * model, A(indptr),
                 A(seg), A(bound), ext.stream())
            compact_tab(A(xtab), data, s, out_cap, A(frags), data * out_cap,
                        ext.stream())
            merge(A(frags), data, out_cap, A(ts), act_ts.shape[0], s,
                  A(indptr), A(dep_rows), A(dep_ts), A(csum), A(acc),
                  ext.stream())
        P.launches.append(go)
        for name in ("finalize_shard_tab", "finalize_shard_tab",
                     "counts_scan", "fragment_merge"):
            P.count(name)
        return tuple(o[1] for o in outs)
    return stage


@contextlib.contextmanager
def parent_stage():
    """Inside, the sharded tick's finalize stage is the parent's chain
    (the tick graphs' cache set aside, as deps_block_variants.bound
    does)."""
    from accord_tpu_torch.ops import tick_graph as tg
    lib = _lib()
    orig = tg._stage_fin_shard
    tg._stage_fin_shard = _parent_stage_fn(lib)
    try:
        with dbv.bound(lib, {}, "parent sharded finalize"):
            yield
    finally:
        tg._stage_fin_shard = orig


class _MergeShim:
    """The parent's fragment_merge as the entry cache calls it, its
    accumulator argument replaced by one of its own: the parent memsets
    and leaves its three sums there, which the shipped wrapper's zeroed
    scratch must not keep."""

    def __init__(self, fn, acc: int):
        self._fn, self._acc = fn, acc

    @property
    def argtypes(self):
        return self._fn.argtypes

    @argtypes.setter
    def argtypes(self, v):
        self._fn.argtypes = v

    @property
    def restype(self):
        return self._fn.restype

    @restype.setter
    def restype(self, v):
        self._fn.restype = v

    def __call__(self, *args):
        args = list(args)
        args[10] = self._acc
        return self._fn(*args)


@contextlib.contextmanager
def parent_merge():
    """Inside, K22's fragment_merge resolves to the parent's four stream
    operations."""
    import types

    import torch
    from accord_tpu_torch.parallel import mesh as pm
    lib = _lib()
    if not _ACC:
        _ACC.append(torch.zeros(4, dtype=torch.int32, device="cuda"))
    shim = types.SimpleNamespace(fragment_merge=_MergeShim(
        lib.fragment_merge, _ACC[0].data_ptr()))
    with dbv.bound(shim, {("mesh_combine", "fragment_merge"):
                          pm._MERGE_ARGS}, "parent K22 merge"):
        yield


@contextlib.contextmanager
def uncached_table():
    """Inside, the sharded finalize table's launch resolves to the build
    without its record cache."""
    from accord_tpu_torch.ops import kernels as tk
    _lib()
    with dbv.bound(_LIB[1], {("finalize_csr", "fin_shard_tab"):
                             tk._FIN_TAB_ARGS}, "uncached table"):
        yield


def table_pairs(mesh, specs) -> dict:
    """The table's launch alone over finalize specs (sharded_finalize_tab's
    launcher, CALLS launches a graph): the shipped one beside the build
    without its record cache, and beside the single-device table
    (kernels.fin_tab_launcher) on the same specs; outputs bit-equal."""
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.parallel import mesh as pm

    def make():
        return pm.sharded_finalize_tab_launcher(mesh, specs)
    out = {"uncached": dbv.body_pair(make, parent=uncached_table)}
    launch, outs = make()
    s_launch, s_outs = tk.fin_tab_launcher(specs)
    g, s_g = (dbv._capture(x, dbv.CALLS) for x in (launch, s_launch))
    t = dbv._interleaved({"new": (g.replay, dbv.CALLS),
                          "single": (s_g.replay, dbv.CALLS)})
    out["single_device"] = {"new_ms": t["new"]["ms"],
                            "single_ms": t["single"]["ms"],
                            "bit_equal": dbv._same(outs, s_outs)}
    return out


@contextlib.contextmanager
def parent_scan():
    """Inside, K22's counts_scan resolves to the parent's (one block of 256
    threads, a slot each, walking the slots 256 at a time)."""
    from accord_tpu_torch.parallel import mesh as pm
    with dbv.bound(_lib(), {("mesh_combine", "counts_scan"):
                            pm._COUNTS_SCAN_ARGS}, "parent K22 scan"):
        yield


def scan_pair(counts, bounds) -> dict:
    """The shipped and the parent's counts_scan on one _gather_counts
    call: outputs bit-equal, each side's device ms a call."""
    from accord_tpu_torch.parallel import mesh as pm
    return dbv.call_pair(lambda: pm._gather_counts(counts, bounds),
                         parent=parent_scan)


def merge_pair(frags, indptr, act_ts) -> dict:
    """The shipped and the parent's merge on one _sum_merge_fragments
    call: outputs bit-equal, each side's device ms a call."""
    from accord_tpu_torch.parallel import mesh as pm
    return dbv.call_pair(lambda: pm._sum_merge_fragments(frags, indptr,
                                                         act_ts),
                         parent=parent_merge)


def tab_pair(mesh, wt, key_in, fins) -> dict:
    """The sharded_protocol_tick graph of the key stage and `fins` with
    each finalize stage: the finalizes' outputs bit-equal, each side's
    replay ms (less the key stage's replay alone: the finalize stage's
    time)."""
    from accord_tpu_torch.parallel import mesh as pm
    return dbv.replay_pair(
        lambda: pm.sharded_protocol_tick(mesh, wt, key_in=key_in, fins=fins),
        lambda o: o[2], parent=parent_stage)


def key_stage_ms(mesh, wt, key_in) -> float:
    """The replay ms of the key stage's graph alone (median of the same
    interleaved rounds' samples)."""
    from accord_tpu_torch.ops import tick_graph
    from accord_tpu_torch.parallel import mesh as pm
    keep = pm.sharded_protocol_tick(mesh, wt, key_in=key_in)  # noqa: F841
    graph = next(reversed(tick_graph._GRAPHS.values())).graph
    return dbv._interleaved({"key": (graph.replay, 1)})["key"]["ms"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sharded_finalize_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from accord_tpu_torch.ops import _ext
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.parallel import mesh as pm
    proc = start_build()
    _ext.build()
    finish_build(proc)
    dev = "cuda"
    res = {"table": {}, "merge": {}}
    t = smoke.merged_tick_inputs(dev, False, tk)
    wt, key_in, fins = t["wt"], t["key_in"], tuple(t["fins"])
    vmesh = pm.make_mesh(devices=["cuda:0"] * 8)
    specs = smoke.key_fin_specs(tk, wt, t["kw"])
    for label, mesh in (("virtual_4x2", vmesh), ("make_mesh", pm.make_mesh())):
        pair = tab_pair(mesh, wt, key_in, fins)
        key = key_stage_ms(mesh, wt, key_in)
        res["table"][label] = dict(
            pair, key_stage_ms=key, fin_stage_ms=pair["new_ms"] - key,
            parent_fin_stage_ms=pair["parent_ms"] - key, finalizes=len(fins),
            launch=table_pairs(mesh, specs))
    res["scan"] = {}
    rec = smoke.Recorder(tk, names=("_sum_merge_fragments",
                                    "_gather_counts"))
    with rec:
        smoke.burn(dev, 800, [], mesh=vmesh)
    res["merge"]["key_burn"] = merge_pair(
        *rec.get("_sum_merge_fragments")[0])
    res["scan"]["key_burn"] = scan_pair(*rec.get("_gather_counts")[0])
    frec = smoke.Recorder(tk, names=("finalize_csr",))
    with frec:
        smoke.preaccept_batch(dev, 10_000, 4_096)
    args, kw = frec.get("finalize_csr")
    brec = smoke.Recorder(tk, names=("_sum_merge_fragments",
                                     "_gather_counts"))
    with brec:
        pm.sharded_finalize_csr(vmesh)(*args, **kw)
    res["merge"]["preaccept_batch"] = merge_pair(
        *brec.get("_sum_merge_fragments")[0])
    res["scan"]["preaccept_batch"] = scan_pair(
        *brec.get("_gather_counts")[0])
    ok = all(r["bit_equal"] for part in res.values() for r in part.values())
    ok = ok and all(v["bit_equal"] for r in res["table"].values()
                    for v in r["launch"].values())
    print(smoke.card_line(True))
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
