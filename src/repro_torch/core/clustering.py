"""K-means clustering (paper Sec. 3.2 — LIDER Stage 1).

Lloyd's algorithm. The assignment step (:func:`assign_chunked`) runs
through ``kernels.ops.kmeans_assign_op``: on the card one call of the
``kmeans_assign`` CUDA kernels over all N, which never builds the (N, c)
distance matrix; on the CPU its plain version, a matmul plus an argmin over
chunks of points, as in the JAX package. The Lloyd sums
(:func:`cluster_sums`) add each cluster's rows in one fixed order on every
device, so two builds of the same corpus and seed give the same centroids
bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.ops import kmeans_assign_op


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # (c, d)
    assignment: torch.Tensor  # (N,) int32


def assign_chunked(
    x: torch.Tensor, centroids: torch.Tensor, *, chunk: int = 4096
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment -> (assignment (N,) int32, min_dist (N,)).

    Squared L2 via ``|x|^2 - 2 x.c + |c|^2``; ties go to the first minimum.
    ``chunk`` bounds the plain version's (chunk, c) distances on the CPU;
    the kernel takes all N at once.
    """
    return kmeans_assign_op(x, centroids, chunk=chunk)


def cluster_sums(x: torch.Tensor, idx: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """Per-cluster sums of the rows of ``x``, ``(N, d), (N,) -> (c, d)``.

    On the CPU an ``index_add_``, which adds in index order, the order of
    the JAX package's ``segment_sum`` there (the CPU parity tests rely on
    it). On the card ``index_add_`` adds in the order its atomics land,
    which changes from run to run, so there the sums are an
    ``index_put_`` with ``accumulate``: PyTorch's CUDA path sorts the
    indices stably and adds each cluster's rows serially in row order, one
    order for every call, so a rebuild reproduces a build's centroids bit
    for bit (``chip_smoke.py`` holds two builds equal).
    """
    sums = torch.zeros((n_clusters, x.shape[1]), dtype=x.dtype, device=x.device)
    if x.device.type == "cpu":
        return sums.index_add_(0, idx, x)
    return sums.index_put_((idx,), x, accumulate=True)


def kmeans_step(
    x: torch.Tensor, centroids: torch.Tensor, *, n_clusters: int, chunk: int = 4096
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd iteration -> (sums (c,d), counts (c,), assignment (N,)).
    The counts are integers below 2**24, exact in float32."""
    assignment, _ = assign_chunked(x, centroids, chunk=chunk)
    idx = assignment.to(torch.int64)
    sums = cluster_sums(x, idx, n_clusters)
    counts = torch.zeros(n_clusters, dtype=torch.int64, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx)).to(torch.float32)
    return sums, counts, assignment


def update_centroids(
    centroids: torch.Tensor, sums: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """New centroids; empty clusters keep their previous centroid."""
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where(counts[:, None] > 0.5, new, centroids)


def init_centroids(
    generator: torch.Generator, x: torch.Tensor, n_clusters: int
) -> torch.Tensor:
    """Seeded init from distinct corpus points."""
    n = x.shape[0]
    if n < n_clusters:
        raise ValueError(
            f"cannot draw {n_clusters} distinct centroids from {n} points; "
            f"pass n_clusters <= {n} (or grow the corpus)"
        )
    idx = torch.randperm(n, generator=generator, device=generator.device)[:n_clusters]
    return x[idx.to(x.device)]


def group_by_cluster(
    assignment: torch.Tensor, n_clusters: int, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack point ids into capacity-padded per-cluster slots.

    Returns ``(gids (c, capacity) int32 with -1 padding, sizes (c,) int32)``;
    points past ``capacity`` in a cluster are dropped and ``sizes`` clamped.
    Slot order within a cluster is point order (a stable sort).
    """
    n = assignment.shape[0]
    c = n_clusters
    a = assignment.to(torch.int64)
    sizes = torch.bincount(a, minlength=c)[:c]
    order = torch.sort(a, stable=True).indices
    sorted_assign = a[order]
    starts = torch.cumsum(sizes, 0) - sizes
    rank = torch.arange(n, device=a.device) - starts[sorted_assign]
    keep = rank < capacity
    flat = torch.where(keep, sorted_assign * capacity + rank, c * capacity)
    buf = torch.full((c * capacity + 1,), -1, dtype=torch.int32, device=a.device)
    buf[flat[keep]] = order[keep].to(torch.int32)
    return buf[:-1].reshape(c, capacity), torch.clamp(sizes, max=capacity).to(torch.int32)


def kmeans(
    generator: torch.Generator,
    x: torch.Tensor,
    n_clusters: int,
    *,
    iters: int = 20,
    chunk: int = 4096,
) -> KMeansResult:
    """Full Lloyd loop on one device (the offline Stage-1 builder)."""
    centroids = init_centroids(generator, x, n_clusters)
    for _ in range(iters):
        sums, counts, _ = kmeans_step(x, centroids, n_clusters=n_clusters, chunk=chunk)
        centroids = update_centroids(centroids, sums, counts)
    _, _, assignment = kmeans_step(x, centroids, n_clusters=n_clusters, chunk=chunk)
    return KMeansResult(centroids=centroids, assignment=assignment)
