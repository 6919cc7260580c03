"""Clustering + spatial index structures (reference
`deeplearning4j-core/.../clustering/` — kmeans, kd-tree, vp-tree, quadtree,
sp-tree — and t-SNE `plot/BarnesHutTsne.java` / `plot/Tsne.java`).

Counterpart of `deeplearning4j_tpu/clustering`. k-means' Lloyd
iterations and exact t-SNE run as torch ops on the card (`device="cuda"`
unless the caller asks for the CPU; the O(N²) distance matrix is one
product in full f32); k-means++ seeding, the perplexity search, the tree
structures (nearest-neighbor queries) and Barnes-Hut t-SNE are host numpy,
copied from the JAX package."""
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering  # noqa: F401
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.vptree import VPTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.quadtree import QuadTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.sptree import SpTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.tsne import BarnesHutTsne, Tsne  # noqa: F401
