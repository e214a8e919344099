"""The CUDA nearest-centroid kernel (``csrc/kmeans_assign.cu``) and its
wrapper.

Replaces ``repro/kernels/kmeans_assign.py::kmeans_assign``: for each row
the squared L2 distance ``x_sq - 2 x.c + c_sq`` to every centroid and the
running (min, first argmin) over all N rows, without writing the (N, c)
distances. A call is two launches: the centroids' norms and TF32 splits
into a scratch, then the assignment, whose ``x.c`` runs on the tensor
cores in split TF32 (three TF32 products per float32 product, within
float32 rounding). The source says what bounds it and how its design
answers that. A row's assignment depends only on the row and the
centroids (a fixed order over d), so an upserted row lands where a
rebuild puts it.

The wrapper validates, allocates and launches on the current stream; it
never runs on CPU tensors (``ops`` sends those to
``ref.kmeans_assign_ref``) and raises when the launch fails.
``kmeans_assign.launches`` counts launches, ``LAUNCHES_PER_CALL`` a call.
"""
from __future__ import annotations

import torch

from .launch import I, LL, P, bind, check, count, launch, on_cuda, tma_rows

LAUNCHES_PER_CALL = 2  # the centroid-norm kernel, then the assignment kernel


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
    x, ld = tma_rows(x)  # the kernel's tensor map reads 16-byte aligned rows
    # The centroids' TF32 splits (padded to whole tiles) and norms.
    floats = bind("kmeans_assign", "kmeans_assign_scratch_floats", [I, I], LL)(c, d)
    scratch = torch.empty((floats,), dtype=torch.float32, device=device)
    fn = bind("kmeans_assign", "kmeans_assign_launch", [P, LL, I, LL, P, I, P, P, P, P])
    launch(
        "kmeans_assign", fn, x.data_ptr(), n, d, ld, centroids.data_ptr(), c,
        scratch.data_ptr(), assign.data_ptr(), min_d.data_ptr(), device=device,
    )
    count(kmeans_assign, LAUNCHES_PER_CALL)
    return assign, min_d


kmeans_assign.launches = 0
