"""Point-cloud op zoo: the same public names as ``rfnet_tpu.ops``.

=====================  =============================================
op                     kernel (CUDA tensors) / plain PyTorch
=====================  =============================================
chamfer.nn_distance, nearest_neighbor          K4 ``csrc/nn_dense.cu``
chamfer.nearest_neighbor_coords                K2 ``csrc/nn_coords.cu``
chamfer_pruned.nearest_neighbor_pruned         K7 ``csrc/nn_pruned.cu``
chamfer.nearest_neighbor_tile                  K8 ``csrc/nn_tile.cu``
chamfer.chamfer_sample_means, nn_sample_mean_one
                                               K3 ``csrc/nn_dyn.cu`` (or K8),
                                               backward K5 ``csrc/nn_grad.cu``
fps.farthest_point_sample, sampling            K1 ``csrc/fps.cu``
emd.approx_match_cost                          K6 ``csrc/emd_cost.cu``
knn.knn                                        K10 ``csrc/knn.cu``
vector_attention.vector_attention              K11 ``csrc/attn.cu``
emd.approx_match, match_cost, approx_match_cost_diff
fps.gather_point, grouping.*, interpolate.*, auction.auction_match
                                               plain PyTorch on both devices
=====================  =============================================

Importing this package builds no kernel: each is built at its first launch.
"""

from rfnet_tpu_torch.ops.auction import auction_match
from rfnet_tpu_torch.ops.chamfer import (
    chamfer_sample_means,
    nearest_neighbor,
    nearest_neighbor_coords,
    nearest_neighbor_tile,
    nn_distance,
    nn_sample_mean_one,
)
from rfnet_tpu_torch.ops.chamfer_pruned import nearest_neighbor_pruned
from rfnet_tpu_torch.ops.emd import (
    approx_match,
    approx_match_cost,
    approx_match_cost_diff,
    match_cost,
)
from rfnet_tpu_torch.ops.fps import farthest_point_sample, gather_point, sampling
from rfnet_tpu_torch.ops.grouping import group_point, knn_point, query_ball_point
from rfnet_tpu_torch.ops.interpolate import three_interpolate, three_nn

__all__ = [
    "nn_distance",
    "nearest_neighbor",
    "nearest_neighbor_coords",
    "nearest_neighbor_pruned",
    "nearest_neighbor_tile",
    "chamfer_sample_means",
    "nn_sample_mean_one",
    "farthest_point_sample",
    "gather_point",
    "sampling",
    "query_ball_point",
    "group_point",
    "knn_point",
    "three_nn",
    "three_interpolate",
    "approx_match",
    "approx_match_cost",
    "approx_match_cost_diff",
    "match_cost",
    "auction_match",
]
