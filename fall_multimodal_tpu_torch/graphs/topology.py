"""Skeleton graph topologies and adjacency precompute.

Pure-numpy, executed once at model build time; the resulting ``(K, V, V)``
partition stack is registered as a constant buffer of each backbone. This is
the PyTorch port's own copy of ``fall_multimodal_tpu/graphs/topology.py``
(the port imports nothing of the JAX package); keep the two identical.

Behavioral parity with the reference graph layer
(``Fall_2_Spatial_Temporal_SR/Model/graph.py:6-137`` and the Gen-3 superset
``Multimodal_Fall3/model/musa_model.py:201-359``), re-derived here as
vectorized numpy rather than per-element python loops:

* layouts: ``coco_cut`` (14 joints), ``coco_mmpose`` (18), ``openpose`` (18),
  ``ntu-rgb+d`` (25), ``ntu_edge`` (24);
* strategies: ``uniform`` (K=1), ``distance`` (K=max_hop+1), ``spatial``
  (ST-GCN partitioning, K=1+2*max_hop for contiguous hops);
* hop distance via boolean matrix powers; D^-1 column normalization
  (``normalize_digraph``) and D^-1/2 A D^-1/2 (``normalize_undigraph``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SkeletonLayout:
    """A named skeleton: joint count, undirected bone list, center joint."""

    name: str
    num_node: int
    neighbor_links: Tuple[Tuple[int, int], ...]
    center: int

    @property
    def edges(self) -> List[Tuple[int, int]]:
        """Self-loops + bones (both counted by the hop-distance BFS)."""
        return [(i, i) for i in range(self.num_node)] + list(self.neighbor_links)


# Joint indexing matches the reference layouts so that pretrained pose
# extractors and committed CSVs remain directly usable.
# coco_cut: COCO minus eyes/ears, plus a 14th synthetic "center" joint
# (midpoint of joints 1,2 added at data prep; see data/preprocess.py).
_COCO_CUT = SkeletonLayout(
    name="coco_cut",
    num_node=14,
    neighbor_links=(
        (6, 4), (4, 2), (2, 13), (13, 1), (5, 3), (3, 1), (12, 10),
        (10, 8), (8, 2), (11, 9), (9, 7), (7, 1), (13, 0),
    ),
    center=13,
)

_COCO_MMPOSE = SkeletonLayout(
    name="coco_mmpose",
    num_node=18,
    neighbor_links=(
        (0, 1), (1, 3), (0, 2), (2, 4), (17, 0),
        (17, 6), (6, 8), (8, 10),
        (17, 5), (5, 7), (7, 9),
        (17, 12), (12, 14), (14, 16),
        (17, 11), (11, 13), (13, 15),
    ),
    center=17,
)

_OPENPOSE = SkeletonLayout(
    name="openpose",
    num_node=18,
    neighbor_links=(
        (4, 3), (3, 2), (7, 6), (6, 5), (13, 12), (12, 11),
        (10, 9), (9, 8), (11, 5), (8, 2), (5, 1), (2, 1),
        (0, 1), (15, 0), (14, 0), (17, 15), (16, 14),
    ),
    center=1,
)

# NTU RGB+D joints are 1-based in the dataset docs; stored 0-based here.
_NTU_RGBD = SkeletonLayout(
    name="ntu-rgb+d",
    num_node=25,
    neighbor_links=tuple(
        (i - 1, j - 1)
        for (i, j) in (
            (1, 2), (2, 21), (3, 21), (4, 3), (5, 21),
            (6, 5), (7, 6), (8, 7), (9, 21), (10, 9),
            (11, 10), (12, 11), (13, 1), (14, 13), (15, 14),
            (16, 15), (17, 1), (18, 17), (19, 18), (20, 19),
            (22, 23), (23, 8), (24, 25), (25, 12),
        )
    ),
    center=20,
)

_NTU_EDGE = SkeletonLayout(
    name="ntu_edge",
    num_node=24,
    neighbor_links=tuple(
        (i - 1, j - 1)
        for (i, j) in (
            (1, 2), (3, 2), (4, 3), (5, 2), (6, 5), (7, 6),
            (8, 7), (9, 2), (10, 9), (11, 10), (12, 11),
            (13, 1), (14, 13), (15, 14), (16, 15), (17, 1),
            (18, 17), (19, 18), (20, 19), (21, 22), (22, 8),
            (23, 24), (24, 12),
        )
    ),
    center=2,
)

LAYOUTS: Dict[str, SkeletonLayout] = {
    layout.name: layout
    for layout in (_COCO_CUT, _COCO_MMPOSE, _OPENPOSE, _NTU_RGBD, _NTU_EDGE)
}


def hop_distance(
    num_node: int, edges: Sequence[Tuple[int, int]], max_hop: int = 1
) -> np.ndarray:
    """Pairwise hop distance, clipped: unreachable-within-max_hop -> +inf.

    Matches the matrix-power BFS of the reference (``graph.py:103-115``).
    """
    adj = np.zeros((num_node, num_node), dtype=np.float64)
    for i, j in edges:
        adj[j, i] = 1.0
        adj[i, j] = 1.0

    dist = np.full((num_node, num_node), np.inf)
    reach = np.stack([np.linalg.matrix_power(adj, d) > 0 for d in range(max_hop + 1)])
    # Iterate high->low so the smallest hop count wins.
    for d in range(max_hop, -1, -1):
        dist[reach[d]] = d
    return dist


def normalize_digraph(adj: np.ndarray) -> np.ndarray:
    """Column normalization A @ D^-1 (reference ``graph.py:118-126``)."""
    deg = adj.sum(axis=0)
    inv = np.where(deg > 0, 1.0 / np.where(deg > 0, deg, 1.0), 0.0)
    return adj * inv[None, :]


def normalize_undigraph(adj: np.ndarray) -> np.ndarray:
    """Symmetric normalization D^-1/2 A D^-1/2 (reference ``graph.py:129-137``)."""
    deg = adj.sum(axis=0)
    inv_sqrt = np.where(deg > 0, deg, 1.0) ** -0.5 * (deg > 0)
    return inv_sqrt[:, None] * adj * inv_sqrt[None, :]


def build_adjacency(
    layout: str = "coco_cut",
    strategy: str = "spatial",
    max_hop: int = 1,
    dilation: int = 1,
) -> np.ndarray:
    """Build the ``(K, V, V)`` normalized adjacency partition stack.

    Strategies (ST-GCN partitioning, arXiv:1801.07455):

    * ``uniform``: one partition containing all hops ``<= max_hop``;
    * ``distance``: one partition per hop;
    * ``spatial``: per hop, split by distance-to-center into (root+closer)
      and further partitions; hop 0 contributes the root partition only.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"Unknown skeleton layout: {layout!r}; have {sorted(LAYOUTS)}")
    lay = LAYOUTS[layout]
    hops = hop_distance(lay.num_node, lay.edges, max_hop)
    valid_hops = range(0, max_hop + 1, dilation)

    within = np.zeros((lay.num_node, lay.num_node))
    for hop in valid_hops:
        within[hops == hop] = 1.0
    norm_adj = normalize_digraph(within)

    if strategy == "uniform":
        return norm_adj[None].astype(np.float64)

    if strategy == "distance":
        parts = [np.where(hops == hop, norm_adj, 0.0) for hop in valid_hops]
        return np.stack(parts)

    if strategy == "spatial":
        # dist_center[j] compared pairwise: entry [j, i] follows the
        # reference's index convention (rows j, cols i).
        dc = hops[:, lay.center]
        same = dc[:, None] == dc[None, :]
        closer = dc[:, None] > dc[None, :]
        parts: List[np.ndarray] = []
        for hop in valid_hops:
            on_hop = hops == hop
            a_root = np.where(on_hop & same, norm_adj, 0.0)
            if hop == 0:
                parts.append(a_root)
            else:
                a_closer = np.where(on_hop & closer, norm_adj, 0.0)
                a_further = np.where(on_hop & ~same & ~closer, norm_adj, 0.0)
                parts.append(a_root + a_closer)
                parts.append(a_further)
        return np.stack(parts)

    raise ValueError(f"Unknown partition strategy: {strategy!r}")


def binary_adjacency(layout: str = "coco_cut", max_hop: int = 1) -> np.ndarray:
    """Unnormalized 0/1 reachability within ``max_hop`` (incl. self-loops)."""
    if layout not in LAYOUTS:
        raise ValueError(
            f"Unknown layout {layout!r}; available: {sorted(LAYOUTS)}"
        )
    lay = LAYOUTS[layout]
    hops = hop_distance(lay.num_node, lay.edges, max_hop)
    return (np.isfinite(hops)).astype(np.float64)


def embgcn_static_adjacency(adj: np.ndarray) -> np.ndarray:
    """EmbGCN's nonstandard static support (reference ``EmbGCN.py:14-26,63-64``).

    W' = W + 0.5 I; D = diag(1/rowsum(W')); S = sqrt(D) W' sqrt(D), followed
    by a row softmax (the reference applies ``F.softmax`` over dim=1 at
    construction). Note this is *not* the textbook D^-1/2 W D^-1/2 — the
    diagonal holds 1/rowsum, not rowsum; parity requires reproducing it.
    """
    if adj.shape[0] != adj.shape[1]:
        raise ValueError("adjacency must be square")
    n = adj.shape[0]
    w = adj.astype(np.float64) + 0.5 * np.eye(n)
    d = np.diag(1.0 / w.sum(axis=1))
    s = np.sqrt(d) @ w @ np.sqrt(d)
    # Row softmax (torch F.softmax defaults to dim=1 for 2-D input).
    e = np.exp(s - s.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)
