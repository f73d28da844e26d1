// K7: exact one-sided nearest-neighbour scan over z-sorted clouds that skips
// target tiles and chunks by their bounding boxes.
//
// Replaces the TPU kernel rfnet_tpu/ops/pallas/chamfer_pruned.py:
// nn_pruned_pallas (body _make_kernel). Contract: both clouds are sorted by
// z. For every query it returns the least squared distance to the target
// cloud and the index (into the sorted target) of the nearest target, the
// lowest index winning ties. Distances are sums of squared differences
// rounded step by step and every bound is taken through the same rounded
// chain, so no skip needs slack (the argument is in nn_tiles.cuh). On the
// same z-sorted inputs the result equals K3's (nn_dyn.cu) and the plain
// version's (ops/chamfer.py:_nn_sorted_plain) bit for bit, distances and
// indices.
//
// Design (nn_tiles.cuh, the walk it shares with K8): two queries a thread, a
// warp's 64 consecutive queries skip a tile or a chunk of 32 targets by a
// warp vote on their point-to-box bounds; the block visits the target tiles
// in a fixed order, from the tile whose z range reaches its middle query's
// z, wrapping, and stages (cp.async, two buffers, the next copy overlapping
// the current scan) only the tiles some warp's box can still reach; a tile
// none wants costs no barrier.
//
// Bound on the H100: 8 fp32 operations and a compare a pair, over the pairs
// of the chunks no exact box rule can skip; the bytes are 12 a point read
// and 8 a query written. A z-sorted run of queries spans the cloud's x/y
// extent, so a warp's queries reach more chunks than any one of them needs:
// that union, not the bound, sets K7's pace.

#include "nn_tiles.cuh"

// boxes: scratch for the chunk and tile boxes (nn_tiles_launch); visited
// receives for each block (b, query blocks) the number of tiles it staged.
extern "C" int rfnet_nn_pruned(const void* query, const void* target, void* boxes, int b, int n,
                               int m, int warps, int tile_m, void* dist, void* idx, void* visited,
                               void* stream) {
  return rfnet::nn_tiles_launch<false>(query, target, boxes, b, n, m, warps, tile_m, dist, idx,
                                       visited, stream);
}
