"""Multi-probe LSH baseline (Lv et al. 2007; FALCONN-style), paper
baseline 7.

L hash tables of M-bit hyperplane keys. Buckets are equality ranges in a
sorted (key, id) array. Probing flips low-|margin| bits of the query key:
the probe sequence takes subsets of the ``n_flip_bits`` smallest-margin
bits, ordered by summed margin penalty, and scans each probed bucket up to
``bucket_cap`` entries.

The corpus's and the queries' keys come from ``lsh.hash_vectors`` (the
``lsh_hash`` kernel on the card). The probe sequence needs the queries'
margins ``|q . p|``, which the kernel does not write, so they are a plain
``torch.matmul``; on the card a bit whose margin is within float32 rounding
of 0 may be set in the kernel's key and not by the product's sign, which
only reorders the probes of a bit the sequence flips first. Probe ranking,
bucket scans and scoring are plain PyTorch, with ``jax.lax.top_k``'s order
of ties (``utils.stable_topk``).
"""
from __future__ import annotations

import dataclasses
import itertools

import torch

from .. import lsh as lsh_lib
from ..core_model import TopK
from ..utils import dedup_topk, stable_topk
from ._common import score_candidates
from .sklsh import params_from_numpy as _sorted_from_numpy
from .sklsh import sorted_arrays


@dataclasses.dataclass(frozen=True)
class MPLSHParams:
    lsh: lsh_lib.LSHParams
    sorted_keys: torch.Tensor  # (L, N) int64
    sorted_ids: torch.Tensor  # (L, N) int32

    @property
    def device(self) -> torch.device:
        return self.sorted_keys.device


def build_mplsh(
    generator: torch.Generator,
    embs: torch.Tensor,
    *,
    n_tables: int = 24,
    key_len: int | None = None,
) -> MPLSHParams:
    n, dim = embs.shape
    key_len = key_len or lsh_lib.suggest_key_len(n)
    lsh = lsh_lib.make_lsh(generator, dim, n_tables, key_len)
    sorted_keys, order = sorted_arrays(lsh, embs.to(lsh.projections.device))
    return MPLSHParams(lsh=lsh, sorted_keys=sorted_keys, sorted_ids=order)


def params_from_numpy(leaves: dict, *, device) -> MPLSHParams:
    """The port's params from the numpy leaves of the JAX package's
    ``MPLSHParams`` (the same leaves as SK-LSH's)."""
    p = _sorted_from_numpy(leaves, device=device)
    return MPLSHParams(lsh=p.lsh, sorted_keys=p.sorted_keys, sorted_ids=p.sorted_ids)


def probe_keys(params, queries: torch.Tensor, n_probes: int, n_flip_bits: int) -> torch.Tensor:
    """(B, L, P) keys to probe: each query key with the cheapest subsets of
    its ``n_flip_bits`` lowest-margin bits flipped, the unflipped key first."""
    l = params.sorted_keys.shape[0]
    m = params.lsh.key_len
    b = queries.shape[0]
    f = min(n_flip_bits, m)
    qkeys = lsh_lib.hash_vectors(params.lsh, queries)  # (B, L)
    margins = torch.abs(queries @ params.lsh.projections).reshape(b, l, m)
    _, flip_pos = stable_topk(-margins, f)  # (B, L, f) bit indices, 0 = MSB
    flip_masks = torch.ones_like(flip_pos) << (m - 1 - flip_pos)
    flip_margin = torch.gather(margins, -1, flip_pos)  # (B, L, f)
    subsets = torch.tensor(
        list(itertools.product((0, 1), repeat=f)), dtype=torch.float32, device=queries.device
    )  # (2^f, f); row 0 = no flips
    penalties = flip_margin @ subsets.T  # (B, L, 2^f)
    _, probe_sel = stable_topk(-penalties, min(n_probes, 2**f))  # (B, L, P)
    chosen = subsets.to(torch.int64)[probe_sel]  # (B, L, P, f)
    xor = torch.sum(chosen * flip_masks[:, :, None, :], dim=-1)
    return qkeys[:, :, None] ^ xor


def mplsh_search(
    params: MPLSHParams,
    embs: torch.Tensor,
    queries: torch.Tensor,
    *,
    k: int,
    n_probes: int = 8,
    n_flip_bits: int = 4,
    bucket_cap: int = 64,
) -> TopK:
    l, n = params.sorted_keys.shape
    queries = queries.to(device=params.device, dtype=torch.float32)
    b = queries.shape[0]
    pk = probe_keys(params, queries, n_probes, n_flip_bits)  # (B, L, P)
    flatp = pk.permute(1, 0, 2).reshape(l, -1).contiguous()  # (L, B*P)
    # A bucket is an equality range of a sorted array; scan up to bucket_cap.
    lo = torch.searchsorted(params.sorted_keys, flatp, side="left")
    hi = torch.searchsorted(params.sorted_keys, flatp, side="right")
    idx = lo[..., None] + torch.arange(bucket_cap, device=lo.device)  # (L, BP, cap)
    valid = idx < hi[..., None]
    flat = torch.clamp(idx, 0, n - 1) + torch.arange(l, device=lo.device)[:, None, None] * n
    cand = params.sorted_ids.reshape(-1)[flat.reshape(-1)].view(idx.shape)
    cand = torch.where(valid, cand, -1)  # (L, B*P, cap)
    cand = cand.reshape(l, b, -1).permute(1, 0, 2).reshape(b, -1)
    scores = score_candidates(embs, cand, queries)
    ids, sc = dedup_topk(cand, scores, k)
    return TopK(ids=ids, scores=sc)
