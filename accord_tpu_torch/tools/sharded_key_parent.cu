// The parent of the sharded megakernel's key stage (ops/tick_graph.py
// `_stage_key_shard`), kept to time the shipped stage beside it on the
// same card: node_key_shard over one KeyShard entry per (block, 'data'
// shard, 'model' shard), each writing its rows' words into its own 'model'
// partial in the graph's fixed memory, which K22's or_fold
// (csrc/mesh_combine.cu) then ORs into a fixed-memory result that the
// graph's last table_copy scatters to the tick's buffer. Built only by
// tools/key_stage_mailbox_variants.py and chip_smoke.py, never by
// ops/_ext.py; the tool's parent stage launches it with the shipped
// or_fold and copy.
#include "deps_block.cuh"

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
