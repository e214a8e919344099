"""RecSys model zoo: SASRec, two-tower retrieval, DIN, xDeepFM.

The port of the JAX package's ``models/recsys.py``. Each model is an
``nn.Module`` whose parameters carry the reference's names (SASRec's
``blocks.{i}`` and xDeepFM's ``cin.{i}`` are the reference's lists);
:func:`params_to_numpy` / :func:`params_from_numpy` carry the weights
between the module and the reference's numpy tree (:mod:`.tree`). Every
parameter is float32, as in the reference.

The shared substrate is the embedding lookup. On one device the
reference's lookup is a plain ``take``, whose gradient is a dense
scatter-add; here it is ``F.embedding`` with its dense gradient, so AdamW
updates the same rows as the reference's (a sparse gradient would leave the
untouched rows' moments and weight decay alone).

On a grid (``launch.mesh.use_grid``, parameters laid out by
:func:`param_specs` through ``sharding.shard_module``) the tables split
their vocabulary rows over ``model`` and :func:`embedding_lookup` is the
reference's ``shard_map``: a masked local take, summed over ``model``
(forward bit-equal to the plain take; the backward of the sum is the
identity, so each rank's rows get the gradient once). The batch splits
over the data axes (``sharding.shard_batch``), xDeepFM's rows after the
lookup over every axis, and each loss is the mean over the global batch,
the same value on every rank. Two-tower's in-batch softmax scores each
user against every item of the **global** batch: the item vectors (and
``sampling_logq``) are all-gathered over the data axes.

The two-tower ``retrieval_cand`` path is the paper's own workload: score
users against ~1e6 precomputed item embeddings, brute force here
(:func:`two_tower_score_candidates`, the Flat baseline) or through a LIDER
index over the item-tower embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..core.utils import stable_topk
from ..device import resolve_device
from ..launch.mesh import current_grid
from . import layers, sharding, tree
from .sharding import ALL, DP, TP


# ---------------------------------------------------------------------------
# Embedding substrate
# ---------------------------------------------------------------------------


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``, differentiable with a dense gradient. Under an
    ambient grid ``table`` is the rank's rows (split over ``model``) and
    ``ids`` the rank's rows of the batch: a masked local take summed over
    ``model``; the table's gradient is summed over the data axes."""
    grid = current_grid()
    names = () if grid is None else grid.axis_names
    table = sharding.materialize(table, grid, sharding.physical_axes(DP, names))
    tp = sharding.physical_axes(TP, names)
    return sharding.reduce_from(sharding.vocab_take(table, ids, grid, tp), grid, tp)


class _Split:
    """The axes of one call on a grid: its rows split over the logical axes
    ``rows``, its parameters read through ``sharding.materialize`` over
    them (so their gradients sum over those axes)."""

    def __init__(self, grid, rows: str = DP):
        self.grid = grid
        names = () if grid is None else grid.axis_names
        self.tp = sharding.physical_axes(TP, names)
        self.rows = sharding.physical_axes(rows, names)

    def w(self, p: torch.Tensor) -> torch.Tensor:
        return sharding.materialize(p, self.grid, self.rows)

    def mlp(self, p: Mapping[str, torch.Tensor]) -> dict:
        return {k: self.w(v) for k, v in p.items()}

    def mean(self, local_sum: torch.Tensor, local_count: int) -> torch.Tensor:
        """The global mean from the rank's sum over its ``local_count`` rows."""
        n = sharding.size_of(self.grid, self.rows)
        return sharding.reduce_from(local_sum / (local_count * n), self.grid, self.rows)


def embedding_bag(
    table: torch.Tensor, ids: torch.Tensor, segment_ids: torch.Tensor, n_bags: int
) -> torch.Tensor:
    """EmbeddingBag(sum): multi-hot ids reduced per bag."""
    rows = embedding_lookup(table, ids)
    return rows.new_zeros((n_bags, *rows.shape[1:])).index_add(0, segment_ids, rows)


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


def _mlp_params(dims, device) -> nn.ParameterDict:
    n = len(dims) - 1
    return nn.ParameterDict(
        {f"w{i}": _param((dims[i], dims[i + 1]), device) for i in range(n)}
        | {f"b{i}": _param((dims[i + 1],), device) for i in range(n)}
    )


def _mlp_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor, n: int, act=F.relu,
               final_act: bool = False) -> torch.Tensor:
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)


def _bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    y = y.float()
    return -torch.mean(y * F.logsigmoid(logits) + (1 - y) * F.logsigmoid(-logits))


def _bce_global(logits: torch.Tensor, y: torch.Tensor, rows: str) -> torch.Tensor:
    """:func:`_bce`, under an ambient grid the mean over every rank's rows
    (split over the logical axes ``rows``)."""
    grid = current_grid()
    if grid is None:
        return _bce(logits, y)
    y = y.float()
    nll = -torch.sum(y * F.logsigmoid(logits) + (1 - y) * F.logsigmoid(-logits))
    return _Split(grid, rows).mean(nll, logits.shape[0])


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str  # sasrec | two_tower | din | xdeepfm
    embed_dim: int
    item_vocab: int = 1_048_576
    seq_len: int = 50
    # two-tower
    n_user_fields: int = 4
    n_item_fields: int = 2
    field_vocab: int = 131_072
    tower_dims: tuple[int, ...] = (1024, 512, 256)
    # din
    attn_dims: tuple[int, ...] = (80, 40)
    mlp_dims: tuple[int, ...] = (200, 80)
    # xdeepfm
    n_sparse: int = 39
    cin_dims: tuple[int, ...] = (200, 200, 200)
    dnn_dims: tuple[int, ...] = (400, 400)
    # sasrec
    n_blocks: int = 2
    n_heads: int = 1
    dtype: torch.dtype = torch.float32


class _Recsys(nn.Module):
    """A recsys model: parameters allocated on a device, not initialised
    (:func:`init` draws them); ``SCALES`` are the reference's init scales
    of its embedding tables."""

    SCALES: dict = {}

    def __init__(self, cfg: RecsysConfig):
        super().__init__()
        self.cfg = cfg


# ---------------------------------------------------------------------------
# SASRec (Kang & McAuley 2018)
# ---------------------------------------------------------------------------


class SASRec(_Recsys):
    SCALES = {"item_emb": 0.02, "pos_emb": 0.02}

    def __init__(self, cfg: RecsysConfig, device):
        super().__init__(cfg)
        d = cfg.embed_dim
        self.item_emb = _param((cfg.item_vocab, d), device)
        self.pos_emb = _param((cfg.seq_len, d), device)
        self.ln_f = _param((d,), device)
        self.blocks = nn.ModuleList(
            nn.ParameterDict({n: _param((d, d), device) for n in ("wq", "wk", "wv", "wo", "w1", "w2")}
                             | {n: _param((d,), device) for n in ("ln1", "ln2")})
            for _ in range(cfg.n_blocks)
        )


def sasrec_forward(model: SASRec, seq: torch.Tensor) -> torch.Tensor:
    """seq (B, S) item ids (0 = padding) -> hidden states (B, S, d)."""
    cfg = model.cfg
    b, s = seq.shape
    d, nh = cfg.embed_dim, cfg.n_heads
    sp = _Split(current_grid())
    h = embedding_lookup(model.item_emb, seq) + sp.w(model.pos_emb)[None, :s]
    for blk in model.blocks:
        blk = sp.mlp(blk)
        x = layers.rms_norm(h, blk["ln1"])
        q = (x @ blk["wq"]).reshape(b, s, nh, d // nh)
        k = (x @ blk["wk"]).reshape(b, s, nh, d // nh)
        v = (x @ blk["wv"]).reshape(b, s, nh, d // nh)
        o = layers.flash_attention(q, k, v, causal=True, q_chunk=s, kv_chunk=s)
        h = h + o.reshape(b, s, d) @ blk["wo"]
        x = layers.rms_norm(h, blk["ln2"])
        h = h + F.relu(x @ blk["w1"]) @ blk["w2"]
    return layers.rms_norm(h, sp.w(model.ln_f))


def sasrec_loss(model: SASRec, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """BCE with one positive (next item) and one sampled negative per step."""
    h = sasrec_forward(model, batch["seq"])
    pos = embedding_lookup(model.item_emb, batch["pos"])
    neg = embedding_lookup(model.item_emb, batch["neg"])
    pos_s = torch.sum(h * pos, -1)
    neg_s = torch.sum(h * neg, -1)
    mask = (batch["pos"] > 0).float()
    loss = -F.logsigmoid(pos_s) - F.logsigmoid(-neg_s)
    grid = current_grid()
    if grid is None:
        return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)
    sp = _Split(grid)
    count = sharding.all_reduce_nograd(torch.sum(mask), grid, sp.rows)
    return sharding.reduce_from(torch.sum(loss * mask) / torch.clamp(count, min=1.0), grid, sp.rows)


# ---------------------------------------------------------------------------
# Two-tower retrieval (Yi et al., RecSys'19)
# ---------------------------------------------------------------------------


class TwoTower(_Recsys):
    SCALES = {"user_emb": 0.02, "item_emb": 0.02}

    def __init__(self, cfg: RecsysConfig, device):
        super().__init__(cfg)
        d = cfg.embed_dim
        self.user_emb = _param((cfg.field_vocab * cfg.n_user_fields, d), device)
        self.item_emb = _param((cfg.item_vocab, d), device)
        self.user_tower = _mlp_params((cfg.n_user_fields * d,) + cfg.tower_dims, device)
        self.item_tower = _mlp_params((cfg.n_item_fields * d,) + cfg.tower_dims, device)


def user_embed(model: TwoTower, user_fields: torch.Tensor) -> torch.Tensor:
    """user_fields (B, n_user_fields) -> (B, d_out), unit norm."""
    cfg = model.cfg
    b, f = user_fields.shape
    offset = torch.arange(f, dtype=user_fields.dtype, device=user_fields.device) * cfg.field_vocab
    x = embedding_lookup(model.user_emb, user_fields + offset).reshape(b, -1)
    tower = _Split(current_grid()).mlp(model.user_tower)
    return _normalize(_mlp_apply(tower, x, len(cfg.tower_dims)))


def item_embed(model: TwoTower, item_fields: torch.Tensor) -> torch.Tensor:
    """item_fields (B, n_item_fields): column 0 the item id, the rest
    categorical fields, looked up in ``user_emb`` at offsets from
    ``field_vocab`` on (as in the reference) -> (B, d_out), unit norm."""
    cfg = model.cfg
    b, f = item_fields.shape
    rows0 = embedding_lookup(model.item_emb, item_fields[:, 0])
    offset = torch.arange(1, f, dtype=item_fields.dtype, device=item_fields.device) * cfg.field_vocab
    rest = embedding_lookup(model.user_emb, item_fields[:, 1:] + offset).reshape(b, -1)
    x = torch.cat([rows0, rest], dim=-1)
    tower = _Split(current_grid()).mlp(model.item_tower)
    return _normalize(_mlp_apply(tower, x, len(cfg.tower_dims)))


def two_tower_loss(model: TwoTower, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """In-batch sampled softmax at temperature 0.05 with the logQ
    correction (``sampling_logq``, when the batch has it)."""
    u = user_embed(model, batch["user_fields"])
    i = item_embed(model, batch["item_fields"])
    logq = batch.get("sampling_logq")
    grid = current_grid()
    if grid is None:
        logits = (u @ i.T) / 0.05
        if logq is not None:
            logits = logits - logq[None, :]
        return -torch.mean(torch.diagonal(F.log_softmax(logits.float(), dim=-1)))
    # Every user of the rank against every item of the global batch: the
    # items' gradients from every rank's users are summed back to their rank.
    sp = _Split(grid)
    items = sharding.gather(i, grid, sp.rows, 0)
    logits = (u @ items.T) / 0.05
    if logq is not None:
        logits = logits - sharding.gather(logq.detach(), grid, sp.rows, 0)[None, :]
    logp = F.log_softmax(logits.float(), dim=-1)
    b = u.shape[0]
    labels = sharding.my_index(grid, sp.rows) * b + torch.arange(b, device=u.device)
    return sp.mean(-torch.sum(logp[torch.arange(b, device=u.device), labels]), b)


@torch.no_grad()
def two_tower_score_candidates(
    model: TwoTower, user_fields: torch.Tensor, cand_embs: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """retrieval_cand: (B, F) users against (N_cand, d_out) precomputed
    item embeddings -> (scores, ids) of the top k, ties in index order (as
    ``jax.lax.top_k``). The brute-force path: the Flat baseline."""
    u = user_embed(model, user_fields)
    return stable_topk(u @ cand_embs.T, k)


# ---------------------------------------------------------------------------
# DIN (Zhou et al. 2018)
# ---------------------------------------------------------------------------


class DIN(_Recsys):
    SCALES = {"item_emb": 0.02}

    def __init__(self, cfg: RecsysConfig, device):
        super().__init__(cfg)
        d = cfg.embed_dim
        self.item_emb = _param((cfg.item_vocab, d), device)
        self.attn = _mlp_params((4 * d,) + cfg.attn_dims + (1,), device)
        self.mlp = _mlp_params((3 * d,) + cfg.mlp_dims + (1,), device)


def din_forward(model: DIN, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """history (B, S), target (B,) -> CTR logits (B,). The attention
    weights take no softmax (DIN keeps their intensity); the pooled history
    is divided by the count of its non-padding items."""
    cfg = model.cfg
    sp = _Split(current_grid())
    hist = embedding_lookup(model.item_emb, batch["history"])  # (B, S, d)
    tgt = embedding_lookup(model.item_emb, batch["target"])  # (B, d)
    t = tgt[:, None, :].expand_as(hist)
    a_in = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    w = _mlp_apply(sp.mlp(model.attn), a_in, len(cfg.attn_dims) + 1)[..., 0]  # (B, S)
    mask = (batch["history"] > 0).to(w.dtype)
    w = w * mask
    pooled = torch.einsum("bs,bsd->bd", w, hist) / torch.clamp(
        torch.sum(mask, -1, keepdim=True), min=1.0)
    x = torch.cat([pooled, tgt, pooled * tgt], dim=-1)
    return _mlp_apply(sp.mlp(model.mlp), x, len(cfg.mlp_dims) + 1)[..., 0]


def din_loss(model: DIN, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return _bce_global(din_forward(model, batch), batch["label"], DP)


# ---------------------------------------------------------------------------
# xDeepFM (Lian et al. 2018)
# ---------------------------------------------------------------------------


class XDeepFM(_Recsys):
    SCALES = {"emb": 0.02, "linear": 0.01}

    def __init__(self, cfg: RecsysConfig, device):
        super().__init__(cfg)
        d, m = cfg.embed_dim, cfg.n_sparse
        self.emb = _param((cfg.field_vocab * m, d), device)
        self.linear = _param((cfg.field_vocab * m, 1), device)
        prev = (m,) + cfg.cin_dims[:-1]
        self.cin = nn.ParameterList(_param((hp * m, h), device) for hp, h in zip(prev, cfg.cin_dims))
        self.cin_out = _param((sum(cfg.cin_dims), 1), device)
        self.dnn = _mlp_params((m * d,) + cfg.dnn_dims + (1,), device)


def xdeepfm_forward(model: XDeepFM, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """fields (B, n_sparse) per-field ids -> CTR logits (B,): the linear
    term, the CIN and the DNN, summed."""
    cfg = model.cfg
    fields = batch["fields"]
    b, m = fields.shape
    offset = torch.arange(m, dtype=fields.dtype, device=fields.device) * cfg.field_vocab
    flat_ids = fields + offset
    x0 = embedding_lookup(model.emb, flat_ids)  # (B, m, d)
    linear = torch.sum(embedding_lookup(model.linear, flat_ids), dim=(1, 2))
    grid = current_grid()
    sp = _Split(grid, ALL)
    if grid is not None:
        # The rows after the (model-split) lookup split over every axis:
        # the rank keeps its tp-th share of its data rank's rows, and the
        # others' shares of the gradient come back through the sum.
        x0, linear = (_tp_rows(t, grid, sp.tp) for t in (x0, linear))
        b = x0.shape[0]
    # CIN: x^{k+1}_h = sum_{i,j} W^k_{h,ij} (x^k_i * x^0_j)
    xk, pools = x0, []
    for w in model.cin:
        z = torch.einsum("bhd,bmd->bhmd", xk, x0).reshape(b, -1, cfg.embed_dim)  # (B, Hk*m, d)
        xk = torch.einsum("bzd,zh->bhd", z, sp.w(w))  # (B, Hk+1, d)
        pools.append(torch.sum(xk, dim=-1))
    cin_logit = (torch.cat(pools, dim=-1) @ sp.w(model.cin_out))[:, 0]
    dnn_logit = _mlp_apply(sp.mlp(model.dnn), x0.reshape(b, -1), len(cfg.dnn_dims) + 1)[:, 0]
    return linear + cin_logit + dnn_logit


def _tp_rows(t: torch.Tensor, grid, tp: tuple[str, ...]) -> torch.Tensor:
    n = sharding.size_of(grid, tp)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split over {tp}")
    rows = t.shape[0] // n
    return sharding.copy_to(t, grid, tp).narrow(0, sharding.my_index(grid, tp) * rows, rows)


def xdeepfm_loss(model: XDeepFM, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """BCE; under an ambient grid ``batch`` holds the rank's rows over the
    data axes, and each model rank scores its share of them."""
    logits = xdeepfm_forward(model, batch)
    y = batch["label"]
    grid = current_grid()
    if grid is not None:
        y = _tp_rows(y, grid, _Split(grid).tp)
    return _bce_global(logits, y, ALL)


# ---------------------------------------------------------------------------
# Shared entry points
# ---------------------------------------------------------------------------

MODELS = {"sasrec": SASRec, "two_tower": TwoTower, "din": DIN, "xdeepfm": XDeepFM}

LOSS = {
    "sasrec": sasrec_loss,
    "two_tower": two_tower_loss,
    "din": din_loss,
    "xdeepfm": xdeepfm_loss,
}


def param_specs(model: _Recsys) -> dict:
    """Vocabulary-split tables over ``model``, everything else whole: the
    reference's tree of specs (the same names, lists as lists)."""
    def spec_for(name: str, p) -> tuple:
        if any(n in ("item_emb", "user_emb", "emb", "linear") for n in name.split(".")):
            return ("model",) + (None,) * (p.dim() - 1)
        return (None,) * p.dim()

    return tree.param_tree({n: spec_for(n, p) for n, p in model.named_parameters()})


def init(seed: int, cfg: RecsysConfig, *, device: str | torch.device | None = None) -> _Recsys:
    """The model of ``cfg.kind`` drawn from ``seed`` by a ``torch.Generator``
    on ``device`` (None = the CUDA device), at the reference's scales."""
    model = MODELS[cfg.kind](cfg, resolve_device(device))
    dev = next(model.parameters()).device
    tree.draw(model, torch.Generator(device=dev).manual_seed(seed), model.SCALES)
    return model


def params_to_numpy(model: _Recsys) -> dict:
    """The module's weights as the reference's parameter tree of numpy arrays."""
    return tree.to_numpy(model)


def params_from_numpy(t, cfg: RecsysConfig, *, device: str | torch.device | None = None) -> _Recsys:
    """A model of ``cfg.kind`` on ``device`` holding the weights of the
    reference's parameter tree."""
    return tree.load(MODELS[cfg.kind](cfg, resolve_device(device)), t)
