"""The CUDA nearest-centroid kernel (``csrc/kmeans_assign.cu``) and its
wrapper.

Replaces ``repro/kernels/kmeans_assign.py::kmeans_assign``: for each row
the squared L2 distance ``x_sq - 2 x.c + c_sq`` to every centroid and the
running (min, first argmin), in one launch over all N rows, without
writing the (N, c) distances. The source says what bounds it and how its
design answers that. A row's assignment depends only on the row and the
centroids (a fixed order over d), so an upserted row lands where a rebuild
puts it.

The wrapper validates, allocates and launches on the current stream; it
never runs on CPU tensors (``ops`` sends those to
``ref.kmeans_assign_ref``) and raises when the launch fails.
``kmeans_assign.launches`` counts launches.
"""
from __future__ import annotations

import torch

from .launch import I, LL, P, bind, check, launch, on_cuda


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, d), (c, d) float32 -> (assignment (N,) int32, min squared L2
    (N,) float32), ties to the first minimum."""
    device = on_cuda("kmeans_assign", x, "kmeans_assign_ref")
    if x.dim() != 2 or centroids.dim() != 2:
        raise ValueError("x must be (N, d) and centroids (c, d)")
    n, d = x.shape
    c = centroids.shape[0]
    if c < 1:
        raise ValueError("kmeans_assign needs at least one centroid")
    check("x", x, torch.float32, (n, d), device)
    check("centroids", centroids, torch.float32, (c, d), device)
    assign = torch.empty((n,), dtype=torch.int32, device=device)
    min_d = torch.empty((n,), dtype=torch.float32, device=device)
    if n == 0:
        return assign, min_d
    fn = bind("kmeans_assign", "kmeans_assign_launch", [P, LL, I, P, I, P, P, P])
    launch(
        "kmeans_assign", fn, x.data_ptr(), n, d, centroids.data_ptr(), c,
        assign.data_ptr(), min_d.data_ptr(), device=device,
    )
    kmeans_assign.launches += 1
    return assign, min_d


kmeans_assign.launches = 0
