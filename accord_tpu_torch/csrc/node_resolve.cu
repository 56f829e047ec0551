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
//   K14: K5's covered-bucket pass once, then per side one launch over its
//        table: the range side ORs each interval's overlap bits per
//        subject (atomicOr, order-free) and masks them row by row; the
//        key side is K13's launch over the covered words, gated by
//        subj_is_range. Either side may be empty.
//
// The sharded protocol megakernel (accord_tpu_torch/ops/tick_graph.py,
// replacing the `_fused_key_resolve_blocks` / `_fused_range_resolve_blocks`
// shard_map stages of accord_tpu/parallel/mesh.py :683) runs the same
// bodies over SHARD tables: node_key_shard takes one KeyShard entry per
// (block, 'data' shard, 'model' shard) -- the shard's row range, its
// bucket-word column slice read in place through the arena's row stride,
// its subject words and its 'model' partial -- in one launch; the range
// side's entries are RngBlk rows per (block, 'data' shard) through
// node_range_resolve as it is. The 'model' partials then OR-fold (K22).
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

struct RngBlk {              // 48 bytes
  const int* start;          // [cap]
  const int* end;
  const int* ts;             // [cap, 3]
  const int* kinds;
  const unsigned char* valid;
  int cap, out_off;
};

struct TabHdr {              // 16 bytes, then the blocks
  unsigned* out;
  long long nblk;
};

struct KeyShard {            // 64 bytes
  const unsigned* bm;        // the shard's first row, first 'model' word
  const int* ts;             // the shard's rows
  const int* kinds;
  const unsigned char* valid;
  const unsigned* sw;        // subject words of the 'model' slice [b, nwl]
  unsigned* out;             // the 'model' partial [b, out_stride]
  int cap, out_off;          // the shard's rows; its first word column
  int bm_stride, pad;        // the arena's row stride in words
};

extern "C" int node_shard_bytes() { return (int)sizeof(KeyShard); }

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

__global__ void __launch_bounds__(KT_THREADS, KT_MIN_CTAS)
node_key_shard_kernel(const KeyShard* __restrict__ tab,
                      const int* __restrict__ subj_before,
                      const int* __restrict__ subj_kinds,
                      const int* __restrict__ subj_node,
                      const int* __restrict__ slots,
                      const unsigned char* __restrict__ gate, int b, int nwl,
                      const int* __restrict__ witness, int nk,
                      int out_stride, int gw) {
  const KeyShard e = tab[blockIdx.y];
  if ((int)blockIdx.z * gw >= (e.cap >> 5)) return;  // whole CTA
  resolve_body(e.sw, subj_before, subj_kinds, subj_node, slots[blockIdx.y],
               gate, b, e.bm, e.bm_stride, e.ts, e.kinds, e.valid, e.cap,
               nwl, witness, nk, e.out, out_stride, e.out_off, gw);
}

// K13 over a shard table of nent KeyShard entries (slots[e]: entry e's
// block slot; gate as node_key_resolve): each entry writes its rows' words
// of its 'model' partial at out[s, out_off + w].
extern "C" int node_key_shard(const void* tab, int nent, int max_cap,
                              const void* subj_before, const void* subj_kinds,
                              const void* subj_node, const void* slots,
                              const void* gate, int b, int nwl,
                              const void* witness, int nk, int out_stride,
                              void* stream) {
  if (nwl > MAX_NW || nk * nk > 64 || (max_cap & 31))
    return (int)cudaErrorInvalidValue;
  if (nent <= 0 || b <= 0 || max_cap <= 0) return 0;
  if (nent > 65535) return (int)cudaErrorInvalidValue;
  const KeyGeom g = key_geom(max_cap, b, nwl, nent);
  node_key_shard_kernel<<<g.grid, g.threads, g.smem, (cudaStream_t)stream>>>(
      (const KeyShard*)tab, (const int*)subj_before, (const int*)subj_kinds,
      (const int*)subj_node, (const int*)slots, (const unsigned char*)gate,
      b, nwl, (const int*)witness, nk, out_stride, g.gw);
  ACCORD_CHECK();
  return 0;
}

__global__ void node_range_any_kernel(const unsigned char* __restrict__ tab,
                                      const int* __restrict__ iv_of,
                                      const int* __restrict__ iv_s,
                                      const int* __restrict__ iv_e, int nv,
                                      int b, unsigned* __restrict__ anyr,
                                      int stride) {
  const RngBlk bk = ((const RngBlk*)(tab + sizeof(TabHdr)))[blockIdx.y];
  range_any_body(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5,
                 threadIdx.x & 31, iv_of, iv_s, iv_e, nv, b, bk.start,
                 bk.end, bk.cap, anyr, stride, bk.out_off);
}

__global__ void __launch_bounds__(WARPS * 32)
node_range_mask_kernel(const unsigned char* __restrict__ tab,
                       const unsigned* __restrict__ anyr,
                       const int* __restrict__ subj_before,
                       const int* __restrict__ subj_kinds,
                       const int* __restrict__ subj_node,
                       const int* __restrict__ slots, int b,
                       const int* __restrict__ witness, int nk, int stride) {
  const TabHdr* h = (const TabHdr*)tab;
  const RngBlk bk = ((const RngBlk*)(tab + sizeof(TabHdr)))[blockIdx.z];
  if ((int)blockIdx.x * WARPS >= (bk.cap >> 5)) return;  // whole block
  range_mask_body(anyr, subj_before, subj_kinds, subj_node,
                  slots[blockIdx.z], b, bk.ts, bk.kinds, bk.valid, bk.cap,
                  witness, nk, h->out, stride, bk.out_off);
}

// K14's range side over its block table: anyr (scratch, [b, stride]) is
// zeroed, OR-ed per subject, then masked into the table's output.
extern "C" int node_range_resolve(const void* tab, int nblocks, int max_cap,
                                  const void* iv_of, const void* iv_s,
                                  const void* iv_e, int nv,
                                  const void* subj_before,
                                  const void* subj_kinds,
                                  const void* subj_node, const void* slots,
                                  int b, const void* witness, int nk,
                                  void* anyr, int stride, void* stream) {
  if (nk * nk > 64 || (max_cap & 31)) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0 || b <= 0 || max_cap <= 0) return 0;
  if (nblocks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int words = max_cap >> 5;
  cudaMemsetAsync(anyr, 0, (size_t)b * stride * sizeof(unsigned), st);
  ACCORD_CHECK();
  const long long threads = (long long)nv * words * 32;
  if (threads > 0) {
    dim3 g1((unsigned)((threads + 255) / 256), nblocks);
    node_range_any_kernel<<<g1, 256, 0, st>>>(
        (const unsigned char*)tab, (const int*)iv_of, (const int*)iv_s,
        (const int*)iv_e, nv, b, (unsigned*)anyr, stride);
    ACCORD_CHECK();
  }
  dim3 g2((words + WARPS - 1) / WARPS, (b + SUBJ_TILE - 1) / SUBJ_TILE,
          nblocks);
  node_range_mask_kernel<<<g2, WARPS * 32, 0, st>>>(
      (const unsigned char*)tab, (const unsigned*)anyr,
      (const int*)subj_before, (const int*)subj_kinds, (const int*)subj_node,
      (const int*)slots, b, (const int*)witness, nk, stride);
  ACCORD_CHECK();
  return 0;
}
