"""Plain reference of a LIDER search (paper Sec. 3.3.2) over a given index,
the judge of served answers, and the work the verification must do.

The index is handed over as plain tensors (``state``, see
:data:`STATE_KEYS`): the k-means centroids, the centroid retriever's sorted
key arrays (ids, re-scale statistics, RMI), and the cluster bank's sorted key
arrays, sorted positions and global ids with their re-scale statistics and
RMIs. The hash projections are not taken from the program: they are drawn
again from the build seed, as the build draws them (``torch.randn`` of shape
``(d, H * M)`` from a ``torch.Generator`` seeded ``build_seed + 1`` for the
centroid retriever and ``build_seed + 2`` for the bank). Scores are never
taken from the program's tables: they are float64 dot products of the
queries with the corpus rows, made again from the seed.

Search, for each query:

1. Layer 1: hash the query with the centroid projections (``H_c`` keys of
   ``M_c`` sign bits, big-endian), re-scale each key and predict its
   position with the array's RMI, take a window of ``R_c = r0_c * n_probe``
   sorted centroids around it, score the centroids found, keep the best
   ``n_probe``.
2. Layer 2: in each probed cluster the same with the bank projections and
   the cluster's arrays, a window of ``R = min(r0 * k, Lp)`` slots.
3. Verification: the best ``k`` distinct passages of all candidates.

The program decides signs and orders in float32, the reference in
float64, so a decision that lies within a band of its threshold may go
either way. The judge therefore builds two candidate sets: the *union* of
every resolution of those decisions (a hash bit whose float64 projection
lies within ``band_key`` of 0, a centroid whose score lies within
``band_score`` of the ``n_probe``-th, a window start one slot either way)
and the *core* common to all of them. A correct answer holds only ids of
the union, its scores are the passages' scores, and its ``k``-th is no
worse than the core's ``k``-th. The window's position in each array is
re-computed with the program's float32 operations, in the same order, so
that the RMI's leaf is chosen alike.

The control (:func:`control_answers`) is this search put in the
program's place with every product in TF32: inputs rounded to 10 mantissa
bits, as a tensor core reads float32.
"""
from __future__ import annotations

import torch

PAD_KEY = 0xFFFFFFFF
NEG_INF = float("-inf")

STATE_KEYS = (
    "centroids",  # (c, d) float32
    "c_sorted_keys", "c_sorted_ids",  # (Hc, c) int64
    "c_key_min", "c_key_max", "c_length",  # (Hc,) int64, int64, float32
    "c_root_w", "c_root_b", "c_rmi_length",  # (Hc,) float32
    "c_leaf_w", "c_leaf_b",  # (Hc, Wc) float32
    "b_sorted_keys",  # (c, H, Lp) int64
    "b_sorted_pos",  # (c, H, Lp) int64, -1 at pads
    "b_gids",  # (c, Lp) int64, -1 at free slots
    "b_key_min", "b_key_max", "b_length",  # (c, H)
    "b_root_w", "b_root_b", "b_rmi_length",  # (c, H) float32
    "b_leaf_w", "b_leaf_b",  # (c, H, W) float32
)


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------


def draw_projections(seed: int, dim: int, n_arrays: int, key_len: int,
                     device: torch.device) -> torch.Tensor:
    """The build's hash projections, drawn again from its seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((dim, n_arrays * key_len), generator=g, device=device, dtype=torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits, ties to
    even), still typed float32."""
    i = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    i = (i + 0xFFF + ((i >> 13) & 1)) & 0xFFFFE000
    i = torch.where(i >= 2**31, i - 2**32, i)
    return i.to(torch.int32).view(torch.float32)


def dots(a: torch.Tensor, b: torch.Tensor, *, tf32: bool = False) -> torch.Tensor:
    """``a @ b`` from float32 inputs: in float64, or with ``tf32`` as a
    tensor core's TF32 product (inputs rounded to TF32, whose products are
    exact in float32, summed in float32), returned in float64."""
    if tf32:
        return (round_tf32(a) @ round_tf32(b)).to(torch.float64)
    return a.to(torch.float64) @ b.to(torch.float64)


def corpus_scores(q: torch.Tensor, corpus: torch.Tensor, *, tf32: bool = False,
                  chunk: int = 1 << 18) -> torch.Tensor:
    """(B, N) scores of the queries against every corpus row: float64, or
    with ``tf32`` float32 TF32 products of a corpus already rounded to TF32
    (:func:`round_tf32`)."""
    if tf32:
        return round_tf32(q) @ corpus.T
    qd = q.to(torch.float64)
    out = torch.empty((q.shape[0], corpus.shape[0]), dtype=torch.float64, device=q.device)
    for s in range(0, corpus.shape[0], chunk):
        out[:, s:s + chunk] = qd @ corpus[s:s + chunk].to(torch.float64).T
    return out


def hash_keys(x: torch.Tensor, proj: torch.Tensor, n_arrays: int, key_len: int, *,
              band: float = 0.0, tf32: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, d) rows -> ``(keys (n, H) int64, ambiguous (n, H, M) bool)``:
    bit ``j`` of array ``h`` is ``x . proj[:, h M + j] >= 0``, packed
    big-endian; a bit is ambiguous where that product lies within ``band``
    of 0."""
    p = dots(x, proj, tf32=tf32).view(-1, n_arrays, key_len)
    w = 2 ** torch.arange(key_len - 1, -1, -1, device=x.device, dtype=torch.int64)
    keys = ((p >= 0).to(torch.int64) * w).sum(-1)
    return keys, p.abs() < band


def key_alternatives(keys: torch.Tensor, amb: torch.Tensor,
                     key_len: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every other key that the ambiguous bits of a (row, array) allow ->
    ``(rows, arrays, keys)``, each (m,) int64. More than 8 ambiguous bits
    in one key (256 keys) means a band far wider than rounding: refused."""
    rows, arrays, alts = [], [], []
    for r, h in torch.nonzero(amb.any(-1)).tolist():
        bits = torch.nonzero(amb[r, h]).flatten().tolist()
        if len(bits) > 8:
            raise ValueError(f"{len(bits)} ambiguous bits in one key: the band is too wide")
        base = int(keys[r, h])
        for m in range(1, 2 ** len(bits)):
            key = base
            for j, b in enumerate(bits):
                if (m >> j) & 1:
                    key ^= 1 << (key_len - 1 - b)
            rows.append(r)
            arrays.append(h)
            alts.append(key)
    dev = keys.device
    as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    return as_t(rows), as_t(arrays), as_t(alts)


def rescale32(kmin, kmax, length, keys):
    """Min-max re-scaling of int64 keys onto [0, length - 1], in float32
    with the program's operations in its order."""
    clipped = torch.minimum(torch.maximum(keys, kmin), kmax)
    diff = (clipped - kmin).to(torch.float32)
    span = torch.clamp((kmax - kmin).to(torch.float32), min=1.0)
    hi = torch.clamp(length - 1.0, min=0.0)
    return torch.minimum(torch.clamp(diff / span * hi, min=0.0), hi)


def predict32(root_w, root_b, leaf_w, leaf_b, length, n_leaves: int, x):
    """Two-layer linear RMI prediction in float32: the root picks a leaf,
    the leaf's line predicts, clipped to [0, length - 1]. ``leaf_w`` and
    ``leaf_b`` carry a trailing leaf axis."""
    hi = torch.clamp(length - 1.0, min=0.0)
    pred = torch.minimum(torch.clamp(root_w * x + root_b, min=0.0), hi)
    leaf = torch.floor(pred * n_leaves / torch.clamp(length, min=1.0))
    leaf = torch.clamp(leaf.to(torch.int64), 0, n_leaves - 1)[..., None]
    lw = torch.gather(leaf_w, -1, leaf)[..., 0]
    lb = torch.gather(leaf_b, -1, leaf)[..., 0]
    return torch.minimum(torch.clamp(lw * x + lb, min=0.0), hi)


def window_bounds(pos: torch.Tensor, width: int, arr_len: int, kind: str):
    """``[lo, hi)`` of the window of ``width`` sorted slots centred on the
    rounded position, clamped into the array. ``kind``: ``"exact"``;
    ``"union"`` of the windows whose start lies one slot either way;
    ``"core"``, their intersection."""
    s = torch.round(pos).to(torch.int64) - width // 2
    clamp = lambda v: torch.clamp(v, 0, arr_len - width)
    if kind == "exact":
        lo = clamp(s)
        return lo, lo + width
    if kind == "union":
        return clamp(s - 1), clamp(s + 1) + width
    if kind == "core":
        return clamp(s + 1), clamp(s - 1) + width
    raise ValueError(kind)


def _positions(st: dict, prefix: str, n_leaves: int, idx: tuple, keys: torch.Tensor):
    """Predicted positions of ``keys`` in the arrays ``st[prefix*][idx]``."""
    g = lambda name: st[prefix + name][idx]
    scaled = rescale32(g("key_min"), g("key_max"), g("length"), keys)
    return predict32(g("root_w"), g("root_b"), g("leaf_w"), g("leaf_b"), g("rmi_length"),
                     n_leaves, scaled)


# ---------------------------------------------------------------------------
# Candidate sets
# ---------------------------------------------------------------------------


def centroid_candidates(st: dict, cfg: dict, q: torch.Tensor, proj: torch.Tensor, kind: str, *,
                        band: float = 0.0, tf32: bool = False) -> torch.Tensor:
    """(B, c) mask of the centroids that layer 1's windows reach."""
    hc, mc = cfg["n_arrays_centroid"], cfg["key_len_centroid"]
    c = st["centroids"].shape[0]
    width = min(cfg["r0_centroid"] * cfg["n_probe"], c)
    keys, amb = hash_keys(q, proj, hc, mc, band=band, tf32=tf32)
    b = q.shape[0]
    h = torch.arange(hc, device=q.device).expand(b, hc)
    rows = torch.arange(b, device=q.device)[:, None].expand(b, hc)
    if kind == "union" and amb.any():
        ar, ah, ak = key_alternatives(keys, amb, mc)
        rows = torch.cat([rows.reshape(-1), ar])
        h = torch.cat([h.reshape(-1), ah])
        keys = torch.cat([keys.reshape(-1), ak])
        sure = torch.ones_like(rows, dtype=torch.bool)
    else:
        rows, h, keys = rows.reshape(-1), h.reshape(-1), keys.reshape(-1)
        sure = ~amb.any(-1).reshape(-1)
    pos = _positions(st, "c_", cfg["n_leaves_centroid"], (h,), keys)
    lo, hi = window_bounds(pos, width, c, kind)
    idx = lo[:, None] + torch.arange(width + 2, device=q.device)
    ok = idx < hi[:, None]
    if kind == "core":
        ok &= sure[:, None]
    ids = st["c_sorted_ids"][h[:, None], torch.clamp(idx, max=c - 1)]
    mask = torch.zeros((b, c), dtype=torch.bool, device=q.device)
    mask[rows[:, None].expand_as(ids)[ok], ids[ok]] = True
    return mask


def routed_sets(scores: torch.Tensor, union: torch.Tensor, core: torch.Tensor, n_probe: int,
                band: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The clusters some resolution routes to (``union``) and those every
    resolution routes to (``core``), each (B, c) bool."""
    c = scores.shape[1]
    n = min(n_probe, c)
    kth_core = torch.topk(torch.where(core, scores, NEG_INF), n, dim=1).values[:, -1:]
    r_union = union & (scores >= kth_core - band)
    asc = torch.sort(torch.where(union, scores, NEG_INF), dim=1).values
    ahead = c - torch.searchsorted(asc, (scores - band).contiguous(), side="left")
    return r_union, core & (ahead <= n)


def bank_candidates(st: dict, cfg: dict, q: torch.Tensor, proj: torch.Tensor,
                    clusters: torch.Tensor, kind: str, n_rows: int, *, band: float = 0.0,
                    tf32: bool = False, flat: bool = False) -> torch.Tensor:
    """(B, n_rows) mask of what layer 2's windows in ``clusters`` (B, c)
    reach: global ids, or flat ``cluster * Lp + slot`` rows with ``flat``."""
    h_n, m = cfg["n_arrays"], cfg["key_len"]
    c, _, lp = st["b_sorted_pos"].shape
    width = min(cfg["r0"] * cfg["k"], lp)
    keys, amb = hash_keys(q, proj, h_n, m, band=band, tf32=tf32)
    qi, cl = torch.nonzero(clusters, as_tuple=True)
    hh = torch.arange(h_n, device=q.device).repeat(qi.shape[0])
    qq, cc = qi.repeat_interleave(h_n), cl.repeat_interleave(h_n)
    kk = keys[qq, hh]
    sure = ~amb.any(-1)[qq, hh]
    if kind == "union" and amb.any():
        ar, ah, ak = key_alternatives(keys, amb, m)
        # each alternative key in every cluster its query probes
        pair = clusters[ar]  # (m, c)
        ai, acl = torch.nonzero(pair, as_tuple=True)
        qq = torch.cat([qq, ar[ai]])
        cc = torch.cat([cc, acl])
        hh = torch.cat([hh, ah[ai]])
        kk = torch.cat([kk, ak[ai]])
        sure = torch.cat([sure, torch.ones_like(ai, dtype=torch.bool)])
    mask = torch.zeros((q.shape[0], n_rows), dtype=torch.bool, device=q.device)
    step = 1 << 16  # windows at a time
    for s in range(0, qq.shape[0], step):
        q_, c_, h_, k_ = qq[s:s + step], cc[s:s + step], hh[s:s + step], kk[s:s + step]
        pos = _positions(st, "b_", cfg["n_leaves"], (c_, h_), k_)
        lo, hi = window_bounds(pos, width, lp, kind)
        idx = lo[:, None] + torch.arange(width + 2, device=q.device)
        ok = idx < hi[:, None]
        if kind == "core":
            ok &= sure[s:s + step, None]
        slot = st["b_sorted_pos"][c_[:, None], h_[:, None], torch.clamp(idx, max=lp - 1)]
        ok &= slot >= 0
        if flat:
            tgt = c_[:, None] * lp + torch.clamp(slot, min=0)
        else:
            tgt = st["b_gids"][c_[:, None], torch.clamp(slot, min=0)]
            ok &= tgt >= 0
        mask[q_[:, None].expand_as(tgt)[ok], tgt[ok]] = True
    return mask


def top_n(scores: torch.Tensor, mask: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The best ``n`` masked entries a row -> ``(ids (B, n), values)``,
    ids -1 and values -inf past the masked count."""
    v, i = torch.topk(torch.where(mask, scores, NEG_INF), min(n, scores.shape[1]), dim=1)
    return torch.where(torch.isneginf(v), -1, i), v


# ---------------------------------------------------------------------------
# Judge, control and verification work
# ---------------------------------------------------------------------------


def judge(st: dict, cfg: dict, q: torch.Tensor, corpus: torch.Tensor, proj_c: torch.Tensor,
          proj_b: torch.Tensor, ids: torch.Tensor, scores: torch.Tensor, *, band_key: float,
          band_score: float) -> dict:
    """Hold served answers (B, k) against the reference for their queries.

    Returns ``score_err`` (the largest distance of a served score from the
    passage's float64 score), ``topk_gap`` (the largest amount by which a
    served passage's score lies below the core set's k-th best) and
    ``bad`` (served ids outside the union set, repeated, not a prefix of the
    row, out of score order, and rows shorter than the core set allows)."""
    k = cfg["k"]
    n = corpus.shape[0]
    u_c = centroid_candidates(st, cfg, q, proj_c, "union", band=band_key)
    k_c = centroid_candidates(st, cfg, q, proj_c, "core", band=band_key)
    s_c = dots(q, st["centroids"].T)
    r_u, r_c = routed_sets(s_c, u_c, k_c, cfg["n_probe"], band_score)
    union = bank_candidates(st, cfg, q, proj_b, r_u, "union", n, band=band_key)
    core = bank_candidates(st, cfg, q, proj_b, r_c, "core", n, band=band_key)
    exact_all = corpus_scores(q, corpus)

    ids = ids.to(torch.int64)
    valid = ids >= 0
    safe = torch.clamp(ids, 0, n - 1)
    exact = torch.gather(exact_all, 1, safe)
    err = torch.where(valid, (scores.to(torch.float64) - exact).abs(), 0.0)
    foreign = valid & ~torch.gather(union, 1, safe)
    srt = torch.sort(torch.where(valid, ids, -1), dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    not_prefix = ~valid[:, :-1] & valid[:, 1:]
    disorder = (scores[:, 1:] > scores[:, :-1]) & valid[:, 1:]
    need = torch.clamp(core.sum(1), max=k)
    short = valid.sum(1) < need
    kth = torch.topk(torch.where(core, exact_all, NEG_INF), min(k, n), dim=1).values[:, -1]
    worst = torch.where(valid, exact, float("inf")).min(1).values
    gap = torch.where(torch.isfinite(kth) & valid.any(1), kth - worst, NEG_INF)
    best = torch.topk(exact_all, min(k, n), dim=1).indices
    hits = (ids[:, :, None] == best[:, None, :]) & valid[:, :, None]
    return {
        "score_err": float(err.max()),
        "topk_gap": float(gap.max()),
        "bad": int(foreign.sum() + dup.sum() + not_prefix.sum() + disorder.sum() + short.sum()),
        "foreign": int(foreign.sum()),
        "short": int(short.sum()),
        "recall": float(hits.any(1).sum(1).double().div(k).sum()),
    }


def control_answers(st: dict, cfg: dict, q: torch.Tensor, corpus: torch.Tensor,
                    proj_c: torch.Tensor, proj_b: torch.Tensor, *,
                    block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference search with every product in TF32, ``block`` queries
    at a time, over a corpus already rounded to TF32 -> ``(ids (B, k),
    float32 scores)``: what a program that routed, hashed and verified in
    TF32 would serve."""
    ids, scores = [], []
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block]
        u_c = centroid_candidates(st, cfg, qb, proj_c, "exact", tf32=True)
        cids, _ = top_n(dots(qb, st["centroids"].T, tf32=True), u_c, cfg["n_probe"])
        clusters = torch.zeros_like(u_c)
        rows = torch.arange(qb.shape[0], device=q.device)[:, None].expand_as(cids)
        clusters[rows[cids >= 0], cids[cids >= 0]] = True
        cand = bank_candidates(st, cfg, qb, proj_b, clusters, "exact", corpus.shape[0], tf32=True)
        i, v = top_n(corpus_scores(qb, corpus, tf32=True), cand, cfg["k"])
        ids.append(i)
        scores.append(v.to(torch.float32))
    return torch.cat(ids), torch.cat(scores)


def verify_work(st: dict, cfg: dict, q: torch.Tensor, proj_c: torch.Tensor,
                proj_b: torch.Tensor, touched_c: torch.Tensor, touched_b: torch.Tensor) -> dict:
    """The candidates the verification of a block of queries must score:
    distinct (query, row) pairs of the routing and in-cluster calls, on the
    exact windows of a float64 search. ``touched_c`` (c,) and ``touched_b``
    (c * Lp,) collect, in place, the rows a batch reads."""
    u_c = centroid_candidates(st, cfg, q, proj_c, "exact")
    s_c = dots(q, st["centroids"].T)
    cids, _ = top_n(s_c, u_c, cfg["n_probe"])
    clusters = torch.zeros_like(u_c)
    rows = torch.arange(q.shape[0], device=q.device)[:, None].expand_as(cids)
    clusters[rows[cids >= 0], cids[cids >= 0]] = True
    c, _, lp = st["b_sorted_pos"].shape
    cand = bank_candidates(st, cfg, q, proj_b, clusters, "exact", c * lp, flat=True)
    touched_c |= u_c.any(0)
    touched_b |= cand.any(0)
    return {"routing_pairs": int(u_c.sum()), "incluster_pairs": int(cand.sum())}
