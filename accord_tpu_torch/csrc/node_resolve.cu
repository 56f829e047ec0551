// K13 and K14: the cluster tick's node-lane deps queries, one device call
// over every (plan, store) block of every node.
//
// Replace accord_tpu/ops/node_lane.py `node_fused_deps_resolve` (:89,
// body :110) and `node_fused_range_deps_resolve` (:133, body :151). They
// are K1 and K5 with the block loop moved onto the device: a block TABLE
// in device memory holds, per block, the arena lanes' pointers, its cap
// and its output word offset, and its header holds the output pointer, so
// the query is one launch however many nodes the tick stacks (K1 issues
// one per block), and a CUDA graph can replay it with new snapshots by
// rewriting the table. Subject s answers block z only when
// subj_node[s] == slots[z] (the globally unique (plan, store) slot); pad
// blocks carry slot -1, which no subject holds.
//
//   K13: one launch, grid (run of 64-subject tiles, block, 32-word
//        group): K1's block body (deps_block.cuh) over the packed subject
//        words of K1's subject pass. A tile first reads its subjects' node
//        slots; with none of the block's it writes its zero tile (16-byte
//        stores, 128 B of each row) and moves on, touching no subject
//        word, witness entry or arena lane: at the 10k tick ~98% of
//        tiles, so the call costs about the writing of its output.
//   K14: one launch over the range table (range_block.cuh: a CTA stages
//        its subject tile's intervals from the list, in any order, ORs the
//        overlap ballots in shared memory and masks them; ownership first)
//        that also writes the covered-bucket words, then K13's launch over
//        the key table on the covered words, gated by subj_is_range.
//        Either side may be empty.
//
// The sharded protocol megakernel (accord_tpu_torch/ops/tick_graph.py,
// replacing the `_fused_key_resolve_blocks` / `_fused_range_resolve_blocks`
// shard_map stages of accord_tpu/parallel/mesh.py :683), on a mesh whose
// shards share one card, runs these launches over the single-device
// tables. A CTA reads a row's bucket words whole -- every 'model' slice
// [m * nwl, (m + 1) * nwl) -- against the subject's whole words, so the
// hits of all slices are ORed before the one store: OR_m pack(ov_m & rest)
// == pack(OR_m ov_m & rest) (csrc/mesh_combine.cu), and the 'data' shards'
// rows are the block's rows in order. The result is the reference's
// folded one, written straight into the tick's output: no partial, no
// fold, no copy. Across cards the 'model' partials live on different
// cards and still fold by K22 (parallel/mesh.py).
//
// What bounds them: bytes -- the output, B x sum(cap)/32 words, is mostly
// zero words written once (as 16-byte stores); the arena lanes of a block
// are read once per subject tile that holds one of its subjects, and only
// the row words that hold a valid row.
#include "range_block.cuh"

struct KeyBlk {              // 48 bytes
  const unsigned* bm;        // packed bucket words [cap, nw]
  const int* ts;             // [cap, 3]
  const int* kinds;          // [cap]
  const unsigned char* valid;
  int cap, out_off, pad0, pad1;
};

extern "C" int node_table_sizes(int* out) {
  out[0] = (int)sizeof(TabHdr);
  out[1] = (int)sizeof(KeyBlk);
  out[2] = (int)sizeof(RngBlk);
  return 0;
}

__global__ void __launch_bounds__(KT_THREADS, KT_MIN_CTAS)
node_key_kernel(const unsigned char* __restrict__ tab,
                const unsigned* __restrict__ subj_words,
                const int* __restrict__ subj_before,
                const int* __restrict__ subj_kinds,
                const int* __restrict__ subj_node,
                const int* __restrict__ slots,
                const unsigned char* __restrict__ gate, int b, int nw,
                const int* __restrict__ witness, int nk, int out_stride,
                int gw) {
  const TabHdr* h = (const TabHdr*)tab;
  const KeyBlk bk = ((const KeyBlk*)(tab + sizeof(TabHdr)))[blockIdx.y];
  if ((int)blockIdx.z * gw >= (bk.cap >> 5)) return;  // whole CTA
  resolve_body(subj_words, subj_before, subj_kinds, subj_node,
               slots[blockIdx.y], gate, b, bk.bm, nw, bk.ts, bk.kinds,
               bk.valid, bk.cap, nw, witness, nk, h->out, out_stride,
               bk.out_off, gw);
}

// K13 (and K14's key side, gate = subj_is_range, subj_words = the covered
// words): out[s, off_z + w] for every subject s, block z and row word w.
extern "C" int node_key_resolve(const void* tab, int nblocks, int max_cap,
                                const void* subj_words,
                                const void* subj_before,
                                const void* subj_kinds, const void* subj_node,
                                const void* slots, const void* gate, int b,
                                int nw, const void* witness, int nk,
                                int out_stride, void* stream) {
  if (nw > MAX_NW || nk * nk > 64 || (max_cap & 31))
    return (int)cudaErrorInvalidValue;
  if (nblocks <= 0 || b <= 0 || max_cap <= 0) return 0;
  if (nblocks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const KeyGeom g = key_geom(max_cap, b, nw, nblocks);
  node_key_kernel<<<g.grid, g.threads, g.smem, st>>>(
      (const unsigned char*)tab, (const unsigned*)subj_words,
      (const int*)subj_before, (const int*)subj_kinds, (const int*)subj_node,
      (const int*)slots, (const unsigned char*)gate, b, nw,
      (const int*)witness, nk, out_stride, g.gw);
  ACCORD_CHECK();
  return 0;
}

// K14's range side over its block table (TabHdr, then nblk RngBlk in
// device memory; range_block.cuh) in ONE launch, and with cov set the
// covered words of the key side -- the slices [cov_base + m * k_local,
// + k_local) of k_total buckets, m < slices, at cov + m * b * k_local / 32
// -- in the same launch (tab may be null when nblk == 0). Block z answers
// the subjects with subj_node[s] == slots[z].
extern "C" int node_range_resolve(const void* tab, int nblk, int max_cap,
                                  const void* iv_of, const void* iv_s,
                                  const void* iv_e, int nv,
                                  const void* subj_before,
                                  const void* subj_kinds,
                                  const void* subj_node, const void* slots,
                                  int b, const void* witness, int nk,
                                  int out_stride, void* cov, int cov_base,
                                  int k_local, int k_total, int slices,
                                  void* stream) {
  RangeArgs a;
  a.iv_of = (const int*)iv_of;
  a.iv_s = (const int*)iv_s;
  a.iv_e = (const int*)iv_e;
  a.subj_before = (const int*)subj_before;
  a.subj_kinds = (const int*)subj_kinds;
  a.subj_store = (const int*)subj_node;
  a.slots = (const int*)slots;
  a.witness = (const int*)witness;
  a.cov = (unsigned*)cov;
  a.nv = nv;
  a.b = b;
  a.nk = nk;
  a.out_stride = out_stride;
  a.nblk = nblk;
  a.cov_base = cov_base;
  a.k_local = k_local;
  a.k_total = k_total;
  a.slices = slices;
  if (nblk > 0 && (subj_node == nullptr || slots == nullptr || tab == nullptr))
    return (int)cudaErrorInvalidValue;
  return launch_range_tab(tab, max_cap, a, (cudaStream_t)stream);
}
