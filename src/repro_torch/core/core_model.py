"""LIDER core model (paper Sec. 3.1): ESK-LSH + key re-scaling + RMI.

Indexes one embedding space (the centroid set inside LIDER). Holds ``H``
sorted hashkey arrays and one RMI per array; search is::

    query -> H hashkeys -> re-scale -> RMI position -> window of R = r0*k
          -> gather candidate rows -> exact scores -> dedup top-k

The last three steps are one call of ``verify_topk_op`` (the ``fused_verify``
kernel on the card); two on an int8 table (first pass, exact rescore).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import bank as bank_lib
from . import lsh as lsh_lib
from . import rescale as rescale_lib
from . import rmi as rmi_lib
from ..kernels.ops import verify_topk_op


class TopK(NamedTuple):
    ids: torch.Tensor  # (..., k) int32, -1 for empty slots
    scores: torch.Tensor  # (..., k) float32


@dataclasses.dataclass(frozen=True)
class CoreModelParams:
    lsh: lsh_lib.LSHParams
    rescale: rescale_lib.RescaleParams  # leaves shaped (H,)
    rmi: rmi_lib.RMIParams  # leaves shaped (H,) / (H, W)
    sorted_keys: torch.Tensor  # (H, L) int64
    sorted_ids: torch.Tensor  # (H, L) int32 — rows of the embedding table

    @property
    def n_arrays(self) -> int:
        return self.lsh.n_arrays

    @property
    def array_len(self) -> int:
        return self.sorted_keys.shape[-1]


def fit_core_model(
    lsh: lsh_lib.LSHParams, embs: torch.Tensor, *, n_leaves: int = 10
) -> CoreModelParams:
    """Index ``embs`` (L, d) under the given hash functions."""
    keys = lsh_lib.hash_vectors(lsh, embs).T.contiguous()  # (H, L)
    sorted_keys, order = lsh_lib.sort_hashkeys(keys)
    resc, rmi = bank_lib.fit_sorted_array(
        sorted_keys, torch.ones_like(sorted_keys, dtype=torch.bool), n_leaves=n_leaves
    )
    return CoreModelParams(
        lsh=lsh, rescale=resc, rmi=rmi, sorted_keys=sorted_keys,
        sorted_ids=order.to(torch.int32),
    )


def build_core_model(
    generator: torch.Generator,
    embs: torch.Tensor,
    *,
    n_arrays: int,
    key_len: int | None = None,
    n_leaves: int = 10,
) -> CoreModelParams:
    """Draw ``n_arrays`` hash functions and index ``embs`` (L, d)."""
    n, dim = embs.shape
    key_len = key_len or lsh_lib.suggest_key_len(n)
    lsh = lsh_lib.make_lsh(generator, dim, n_arrays, key_len)
    return fit_core_model(lsh, embs, n_leaves=n_leaves)


def predict_positions(
    cm: CoreModelParams, queries: torch.Tensor, *, refine: bool = False
) -> torch.Tensor:
    """(B, d) queries -> (H, B) float32 predicted positions in each array.

    ``refine=True`` replaces the RMI prediction with an exact binary search.
    """
    qkeys = lsh_lib.hash_vectors(cm.lsh, queries).T.contiguous()  # (H, B)
    if refine:
        return lsh_lib.query_position(cm.sorted_keys, qkeys).to(torch.float32)
    scaled = rescale_lib.rescale(cm.rescale.unsqueeze(-1), qkeys)  # (H, B)
    return rmi_lib.predict(cm.rmi, scaled)


def candidate_windows(
    cm: CoreModelParams, positions: torch.Tensor, width: int
) -> torch.Tensor:
    """Bi-directional expansion: (H, B) positions -> (B, H*width) row ids."""
    h, b = positions.shape
    arr_len = cm.array_len
    width = min(width, arr_len)
    start = torch.clamp(
        torch.round(positions).to(torch.int64) - width // 2, 0, arr_len - width
    )
    idx = start[..., None] + torch.arange(width, device=positions.device)  # (H, B, R)
    cand = torch.gather(cm.sorted_ids, 1, idx.reshape(h, -1)).reshape(h, b, width)
    return cand.permute(1, 0, 2).reshape(b, -1)


def search_core_model(
    cm: CoreModelParams,
    embs: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    r0: int = 4,
    refine: bool = False,
    scales: torch.Tensor | None = None,
    rescore_embs: torch.Tensor | None = None,
    rescore_factor: int = 4,
) -> TopK:
    """Full paper search path on a single core model.

    With ``scales`` set, ``embs`` is an int8 code table: the first pass
    scores in the integer domain and its provisional top-``rescore_factor
    * k`` is rescored exactly from ``rescore_embs`` (the float table).
    """
    positions = predict_positions(cm, queries, refine=refine)
    cand_ids = candidate_windows(cm, positions, width=r0 * k)
    if scales is not None:
        if rescore_embs is None:
            raise ValueError("quantized search needs rescore_embs")
        kp = min(max(rescore_factor, 1) * k, cand_ids.shape[-1])
        prov, _ = verify_topk_op(embs, cand_ids, queries, k=kp, scales=scales)
        ids, sc = verify_topk_op(
            rescore_embs, torch.clamp(prov, min=0), queries, k=k, out_ids=prov
        )
        return TopK(ids=ids, scores=sc)
    ids, sc = verify_topk_op(embs, cand_ids, queries, k=k)
    return TopK(ids=ids, scores=sc)
