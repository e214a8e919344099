"""Product quantization baselines: PQ, OPQ (learned rotation), PCA-PQ.

PQ [Jégou et al. 2010]: split d into m subspaces, k-means 2**bits codewords
per subspace, score by asymmetric distance computation (ADC): for the
inner-product metric the table is ``LUT[j, code] = <q_j, c_{j,code}>`` and a
corpus score is a sum of m table lookups.

OPQ [Ge et al. 2013]: alternate (encode, Procrustes-rotate) to learn R.
PCA-PQ: project to a lower dimension with PCA before PQ (paper baseline 4).

The codebooks train with ``clustering.kmeans`` and the codes are the
nearest codewords (``kernels.ops.kmeans_assign_op``), so on the card both
run the ``kmeans_assign`` kernel on each subspace's (N, d/m) column slice.
The ADC scan is plain PyTorch, as it is plain ``jnp`` in the JAX package:
per chunk of 65,536 codes the m lookups added in subspace order, its top-k
merged into the running top-k with ``jax.lax.top_k``'s order of ties
(``utils.stable_topk``).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import clustering
from ..core_model import TopK
from ..utils import stable_topk
from ._common import leaf


@dataclasses.dataclass(frozen=True)
class PQParams:
    codebooks: torch.Tensor  # (m, n_codes, ds)
    codes: torch.Tensor  # (N, m) int32
    rotation: torch.Tensor | None  # (d, d_proj): OPQ rotation or PCA projection
    n_subspaces: int
    n_codes: int

    @property
    def device(self) -> torch.device:
        return self.codebooks.device


def _subspace(x: torch.Tensor, j: int, ds: int) -> torch.Tensor:
    """Columns ``[j*ds, (j+1)*ds)`` of ``x`` (a strided view)."""
    return x[:, j * ds : (j + 1) * ds]


def _encode(codebooks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(N, d_proj) -> (N, m) int32 nearest-codeword ids per subspace."""
    m, _, ds = codebooks.shape
    cols = [clustering.assign_chunked(_subspace(x, j, ds), codebooks[j])[0] for j in range(m)]
    return torch.stack(cols, dim=1).to(torch.int32)


def _decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    m, _, ds = codebooks.shape
    rows = [codebooks[j][codes[:, j].to(torch.int64)] for j in range(m)]
    return torch.cat(rows, dim=1)


def _train_codebooks(
    generator: torch.Generator, x: torch.Tensor, m: int, n_codes: int, iters: int
) -> torch.Tensor:
    """(m, n_codes, d/m) codebooks, one k-means per subspace, in order."""
    ds = x.shape[1] // m
    return torch.stack([
        clustering.kmeans(generator, _subspace(x, j, ds), n_codes, iters=iters).centroids
        for j in range(m)
    ])


def _pca(x: torch.Tensor, out_dim: int) -> torch.Tensor:
    mu = x.mean(0)
    cov = (x - mu).T @ (x - mu) / x.shape[0]
    _, vecs = torch.linalg.eigh(cov)
    return torch.flip(vecs, dims=(1,))[:, :out_dim]  # (d, out_dim), descending eigenvalues


def build_pq(
    generator: torch.Generator,
    embs: torch.Tensor,
    *,
    n_subspaces: int = 8,
    bits: int = 8,
    kmeans_iters: int = 15,
    opq_iters: int = 0,
    pca_dim: int | None = None,
) -> PQParams:
    embs = embs.to(device=generator.device, dtype=torch.float32)
    n_codes = 2**bits
    rotation = None
    x = embs
    if pca_dim is not None:
        rotation = _pca(embs, pca_dim)
        x = embs @ rotation
    if opq_iters > 0:
        d = x.shape[1]
        r = torch.eye(d, device=embs.device) if rotation is None else rotation
        xr = embs @ r if rotation is not None else x
        cbs = _train_codebooks(generator, xr, n_subspaces, n_codes, kmeans_iters)
        for _ in range(opq_iters):
            recon = _decode(cbs, _encode(cbs, xr))
            # Procrustes: R = argmin ||X R - recon|| = U V^T of X^T recon.
            u, _, vt = torch.linalg.svd(embs.T @ recon, full_matrices=False)
            r = u @ vt
            xr = embs @ r
            cbs = _train_codebooks(generator, xr, n_subspaces, n_codes, kmeans_iters)
        rotation = r
        x = xr
        codebooks = cbs
    else:
        codebooks = _train_codebooks(generator, x, n_subspaces, n_codes, kmeans_iters)
    return PQParams(
        codebooks=codebooks,
        codes=_encode(codebooks, x),
        rotation=rotation,
        n_subspaces=n_subspaces,
        n_codes=n_codes,
    )


def params_from_numpy(leaves: dict, *, device) -> PQParams:
    """The port's params from the numpy leaves of the JAX package's
    ``PQParams``: ``codebooks``, ``codes`` and ``rotation`` (absent or None
    when there is none)."""
    codebooks = leaf(leaves, "codebooks", device, torch.float32)
    rot = leaves.get("rotation")
    return PQParams(
        codebooks=codebooks,
        codes=leaf(leaves, "codes", device, torch.int32),
        rotation=None if rot is None else leaf(leaves, "rotation", device, torch.float32),
        n_subspaces=codebooks.shape[0],
        n_codes=codebooks.shape[1],
    )


def adc_lut(params: PQParams, queries: torch.Tensor) -> torch.Tensor:
    """Inner-product ADC lookup tables (B, m, n_codes)."""
    q = queries if params.rotation is None else queries @ params.rotation
    m, _, ds = params.codebooks.shape
    qs = q.reshape(q.shape[0], m, ds)
    return torch.einsum("bms,mks->bmk", qs, params.codebooks)


def adc_scores(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(B, m, n_codes) tables, (C, m) codes -> (B, C) approximate inner
    products: the m lookups added in subspace order."""
    codes = codes.to(torch.int64)
    out = torch.index_select(lut[:, 0], 1, codes[:, 0])
    for j in range(1, codes.shape[1]):
        out += torch.index_select(lut[:, j], 1, codes[:, j])
    return out


def pq_search(params: PQParams, queries: torch.Tensor, *, k: int, chunk: int = 65536) -> TopK:
    n = params.codes.shape[0]
    queries = queries.to(device=params.device, dtype=torch.float32)
    b = queries.shape[0]
    lut = adc_lut(params, queries)
    ids = torch.full((b, k), -1, dtype=torch.int64, device=queries.device)
    scores = torch.full((b, k), float("-inf"), device=queries.device)
    for start in range(0, n, chunk):
        s = adc_scores(lut, params.codes[start : start + chunk])
        top_s, top_i = stable_topk(s, min(k, chunk))
        all_s = torch.cat([scores, top_s], dim=-1)
        all_i = torch.cat([ids, top_i + start], dim=-1)
        scores, m = stable_topk(all_s, k)
        ids = torch.gather(all_i, -1, m)
    return TopK(ids=ids.to(torch.int32), scores=scores)
