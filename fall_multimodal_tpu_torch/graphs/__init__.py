from fall_multimodal_tpu_torch.graphs.topology import (
    LAYOUTS,
    SkeletonLayout,
    binary_adjacency,
    build_adjacency,
    embgcn_static_adjacency,
    hop_distance,
    normalize_digraph,
    normalize_undigraph,
)

__all__ = [
    "LAYOUTS",
    "SkeletonLayout",
    "binary_adjacency",
    "build_adjacency",
    "embgcn_static_adjacency",
    "hop_distance",
    "normalize_digraph",
    "normalize_undigraph",
]
