// K8: exact one-sided nearest-neighbour scan over Morton-sorted clouds that
// takes target tiles best-first by a box-to-box lower bound.
//
// Replaces the TPU kernel rfnet_tpu/ops/pallas/chamfer_tile.py:nn_tile_pallas
// (body _make_kernel). Contract: both clouds are sorted along a space-filling
// (Morton) curve, so a run of consecutive points is a compact box, not a
// z-shell. For every query it returns the least squared distance to the
// target cloud and the index (into the sorted target) of the nearest target,
// the lowest index winning ties. It is exact for any input order; the order
// only decides how much of the scan is skipped. It takes up to 2^25 targets
// a cloud: beyond 2 097 152 the sort keys of 128-target tiles do not fit
// shared memory, and the wrapper widens the tile until they do (up to
// 16 384 tiles of 2 048; the TPU kernel takes at most 128 tiles).
//
// Exactness. Distances are sums of squared differences rounded step by step,
// and every bound (query box to tile box, query to tile or chunk box) is
// taken through the same rounded chain, so none exceeds the rounded distance
// of a pair it covers and no slack is needed (the argument is in
// nn_tiles.cuh; the TPU kernel widens its break by 4 ulps because its bound
// and its |t|^2 - 2 q.t distances come from different op chains). Whatever
// the visit order, chunk winners taken by strict < and merged by
// d < best || (d == best && j < best_j) leave the lowest index of the least
// distance, so the result equals the plain version's
// (ops/chamfer.py:_nn_sorted_plain) bit for bit.
//
// Design (nn_tiles.cuh, the walk it shares with K7): the block bounds its
// query box against every tile's box and sorts the (bound, tile) keys once
// (bitonic, in shared memory): the order of a repeated argmin, least bound
// first, lowest index on equal bounds, without a reduction a round. It walks
// the sorted list; each warp looks ahead for the next tile its own box can
// reach within its largest best, the block stages the least such step
// (cp.async, two buffers, the next copy overlapping the current scan), and
// the walk ends when no warp wants a tile: past the first key whose bound
// exceeds every live query's best, or earlier. Two queries a thread; a warp
// skips a staged tile or a chunk of 32 targets by a vote of its queries'
// point-to-box bounds.
//
// Bound on the H100: 8 fp32 operations and a compare a pair, over the pairs
// of the chunks no exact box rule can skip; the bytes are 12 a point read
// and 8 a query written.

#include "nn_tiles.cuh"

// boxes: scratch for the chunk and tile boxes (nn_tiles_launch); visited
// receives for each block (b, query blocks) the number of tiles it staged.
extern "C" int rfnet_nn_tile(const void* query, const void* target, void* boxes, int b, int n,
                             int m, int warps, int tile_m, void* dist, void* idx, void* visited,
                             void* stream) {
  return rfnet::nn_tiles_launch<true>(query, target, boxes, b, n, m, warps, tile_m, dist, idx,
                                      visited, stream);
}
