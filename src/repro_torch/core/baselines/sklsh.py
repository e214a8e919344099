"""Original SK-LSH baseline (Liu et al. 2014), paper baseline 8.

One flat index over the whole corpus: H sorted hashkey arrays, exact binary
search for the query position (no RMI), then the global iterative
expansion's fixed point in one shot: a 2T window per array around the
query position, every one of the H*2T candidates ranked by ``dist_e``, the
best T verified. The hash of the corpus and of the queries is
``lsh.hash_vectors`` (the ``lsh_hash`` kernel on the card); the ranking
and the verification are plain PyTorch, as they are plain ``jnp`` in the
JAX package, with its order of ties (``utils.stable_topk``).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import lsh as lsh_lib
from ..core_model import TopK
from ..utils import dedup_topk, stable_topk
from ._common import leaf, score_candidates


@dataclasses.dataclass(frozen=True)
class SKLSHParams:
    lsh: lsh_lib.LSHParams
    sorted_keys: torch.Tensor  # (H, N) int64
    sorted_ids: torch.Tensor  # (H, N) int32

    @property
    def device(self) -> torch.device:
        return self.sorted_keys.device


def sorted_arrays(lsh: lsh_lib.LSHParams, embs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The corpus's (H, N) keys, each array sorted, and the row order."""
    keys = lsh_lib.hash_vectors(lsh, embs).T.contiguous()
    sorted_keys, order = lsh_lib.sort_hashkeys(keys)
    return sorted_keys, order.to(torch.int32)


def build_sklsh(
    generator: torch.Generator,
    embs: torch.Tensor,
    *,
    n_arrays: int = 24,
    key_len: int | None = None,
) -> SKLSHParams:
    """Hash the corpus into ``n_arrays`` sorted arrays of ``key_len``-bit
    keys (default ``suggest_key_len(N)``) on the generator's device."""
    n, dim = embs.shape
    key_len = key_len or lsh_lib.suggest_key_len(n)
    lsh = lsh_lib.make_lsh(generator, dim, n_arrays, key_len)
    sorted_keys, order = sorted_arrays(lsh, embs.to(lsh.projections.device))
    return SKLSHParams(lsh=lsh, sorted_keys=sorted_keys, sorted_ids=order)


def params_from_numpy(leaves: dict, *, device) -> SKLSHParams:
    """The port's params from the numpy leaves of the JAX package's
    ``SKLSHParams``: ``lsh.projections``, ``sorted_keys``, ``sorted_ids``."""
    keys = leaf(leaves, "sorted_keys", device)
    proj = leaf(leaves, "lsh.projections", device, torch.float32)
    h = keys.shape[0]
    return SKLSHParams(
        lsh=lsh_lib.LSHParams(projections=proj, n_arrays=h, key_len=proj.shape[1] // h),
        sorted_keys=keys,
        sorted_ids=leaf(leaves, "sorted_ids", device, torch.int32),
    )


def window_candidates(
    params, qkeys: torch.Tensor, width: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per array, the ``width`` sorted slots around each query key's
    insertion point: (H, B, W) keys and row ids."""
    h, n = params.sorted_keys.shape
    pos = lsh_lib.query_position(params.sorted_keys, qkeys.T.contiguous())  # (H, B)
    start = torch.clamp(pos - width // 2, 0, n - width)
    idx = start[..., None] + torch.arange(width, device=pos.device)  # (H, B, W)
    flat = (idx + torch.arange(h, device=pos.device)[:, None, None] * n).reshape(-1)
    shape = idx.shape
    return (params.sorted_keys.reshape(-1)[flat].view(shape),
            params.sorted_ids.reshape(-1)[flat].view(shape))


def sklsh_search(
    params: SKLSHParams,
    embs: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    n_candidates: int | None = None,
    window_bits: int = 8,
) -> TopK:
    h, n = params.sorted_keys.shape
    m = params.lsh.key_len
    queries = queries.to(device=params.device, dtype=torch.float32)
    b = queries.shape[0]
    t = n_candidates or 4 * k  # paper: "several times k"
    width = min(2 * t, n)

    qkeys = lsh_lib.hash_vectors(params.lsh, queries)  # (B, H)
    win_keys, win_ids = window_candidates(params, qkeys, width)
    # Rank the pooled windows by extended hashkey distance to the query
    # key; keep the T globally closest (the iterative expansion's visits).
    d = lsh_lib.dist_e(win_keys, qkeys.T[..., None], m, window_bits)  # (H, B, W)
    d = d.permute(1, 0, 2).reshape(b, -1)
    ids = win_ids.permute(1, 0, 2).reshape(b, -1)
    _, sel = stable_topk(-d, min(t, d.shape[-1]))  # smallest dist_e, ties by slot
    cand_ids = torch.gather(ids, -1, sel)  # (B, T)
    scores = score_candidates(embs, cand_ids, queries)
    out_ids, out_sc = dedup_topk(cand_ids, scores, k)
    return TopK(ids=out_ids, scores=out_sc)
