"""The index a search cell's set-up built, checked by itself against the
corpus it was built from.

The search reference (:mod:`.lider`) follows the program's index: its
k-means centroids, bank layout, sorted key arrays and learned models. This
module checks that state stage by stage, so that the search check does not
rest on an index it never looked at:

- centroids: the k-means run again in float64 from the same inputs: the
  initial centroids drawn again from the build seed (``torch.randperm`` of
  the corpus rows from a ``torch.Generator`` seeded ``build_seed``, the
  first ``c``), then the configuration's Lloyd steps (nearest centroid by
  squared distance, each centroid the mean of its members, an empty
  cluster keeping its centroid). float32 and float64 part near-tied points
  differently, and over the steps a few clusters settle apart, so the
  check counts the program centroids farther than ``tol_centroid`` (L2)
  from the refit's (``centroids_off``), which a limit holds well below
  what a build from another draw, or one stopped steps early, reads;
- layout: every passage in exactly one slot, slots filled from the front
  of each cluster, passages in id order within a cluster;
- partition: each passage in the cluster of its nearest centroid (float64
  squared distance, within ``band_dist`` of the nearest);
- keys: each sorted array holds the float64 hash keys of its rows (a bit
  whose projection lies within ``band_key`` of 0 may read either way) with
  the projections drawn again from the build seed, in non-decreasing order,
  equal keys in slot order, pads last;
- re-scale statistics: the first and last valid key, the valid count;
- RMI: the root line and each leaf's line, fitted again in float64 by
  weighted least squares on the same re-scaled keys and the leaves the
  program's root picks, predict within ``pos_tol`` slots of the program's.

Besides the fault counts, :func:`check_index` returns the readings the
bands are set from: how far from its threshold a decision lay where the
program's float32 went the other way than float64. :func:`tf32_readings`
gives the same readings for a build in TF32, the control.
"""
from __future__ import annotations

import torch

from .lider import PAD_KEY, dots, rescale32, round_tf32


def _bits(keys: torch.Tensor, key_len: int) -> torch.Tensor:
    """(..., H) int64 keys -> (..., H, M) bool sign bits, big-endian."""
    w = 2 ** torch.arange(key_len - 1, -1, -1, device=keys.device, dtype=torch.int64)
    return (keys[..., None] & w) != 0


def bit_readings(bits: torch.Tensor, proj: torch.Tensor, band: float) -> tuple[int, float]:
    """Sign bits (..., H, M) taken against the float64 projections ``proj``
    of the same shape -> ``(keys with a bit that differs where the
    projection lies ``band`` or more from 0, the largest |projection| of a
    bit that differs)``."""
    differ = bits != (proj >= 0)
    far = (differ & (proj.abs() >= band)).any(-1)
    largest = float(proj.abs()[differ].max()) if bool(differ.any()) else 0.0
    return int(far.sum()), largest


def kmeans_refit(corpus: torch.Tensor, n_clusters: int, iters: int, build_seed: int, *,
                 chunk_rows: int = 1 << 18) -> list[torch.Tensor]:
    """The build's k-means run again in float64 -> the centroids (c, d)
    after each Lloyd step, the initial draw first."""
    n, dev = corpus.shape[0], corpus.device
    g = torch.Generator(device=dev).manual_seed(build_seed)
    cent = corpus[torch.randperm(n, generator=g, device=dev)[:n_clusters]].double()
    steps = [cent]
    for _ in range(iters):
        sums = torch.zeros_like(cent)
        counts = torch.zeros(n_clusters, dtype=torch.float64, device=dev)
        c_sq = (cent * cent).sum(1)
        for s in range(0, n, chunk_rows):
            x = corpus[s:s + chunk_rows].double()
            a = torch.argmin(c_sq - 2.0 * (x @ cent.T), dim=1)
            sums.index_put_((a,), x, accumulate=True)  # one order of sums on every run
            counts += torch.bincount(a, minlength=n_clusters)
        cent = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], cent)
        steps.append(cent)
    return steps


def centroid_readings(centroids: torch.Tensor, steps: list[torch.Tensor],
                      tol: float) -> dict:
    """Program centroids against the refit's last step: how many lie more
    than ``tol`` (L2) from it (``centroids_off``; also at other distances),
    the largest distance, and how many a build that stopped after each
    earlier step would put that far off."""
    final = steps[-1]
    dist = torch.linalg.vector_norm(centroids.double() - final, dim=1)
    off = lambda d, t=tol: int((d > t).sum())
    return {
        "centroids_off": off(dist), "centroid_dist": float(dist.max()),
        "centroids_off_at": {f"{t:g}": off(dist, t) for t in (1e-5, 1e-4, 1e-3, 1e-2)},
        "centroids_off_if_stopped": [off(torch.linalg.vector_norm(s - final, dim=1))
                                     for s in steps[:-1]],
    }


def _wls(x, y, w):
    """Weighted least squares over the last axis in float64 -> (slope, intercept)."""
    n = w.sum(-1, keepdim=True)
    mx = (w * x).sum(-1, keepdim=True) / torch.clamp(n, min=1e-300)
    my = (w * y).sum(-1, keepdim=True) / torch.clamp(n, min=1e-300)
    cov = (w * (x - mx) * (y - my)).sum(-1, keepdim=True)
    var = (w * (x - mx) ** 2).sum(-1, keepdim=True)
    slope = torch.where(var > 1e-12, cov / torch.clamp(var, min=1e-300), 0.0)
    return slope, my - slope * mx


def rmi_mismatches(sorted_keys, valid, kmin, kmax, length, root_w, root_b, leaf_w, leaf_b,
                   rmi_length, *, pos_tol: float, tf32: bool = False) -> tuple[int, float]:
    """Over arrays (..., L): keys whose root or leaf prediction departs by
    more than ``pos_tol`` slots from a float64 refit, plus arrays whose RMI
    length is not their valid count -> ``(count, the largest departure in
    slots)``. With ``tf32`` the refit reads the re-scaled keys rounded to
    TF32, as a fit in TF32 would."""
    n_leaves = leaf_w.shape[-1]
    x = rescale32(kmin[..., None], kmax[..., None], length[..., None], sorted_keys)
    w = valid.to(torch.float64)
    xd = (round_tf32(x) if tf32 else x).to(torch.float64)
    y = torch.arange(x.shape[-1], device=x.device, dtype=torch.float64).expand_as(xd)
    rw, rb = _wls(xd, y, w)
    dev_root = torch.where(valid, (root_w[..., None].double() * x.double()
                                   + root_b[..., None].double() - (rw * xd + rb)).abs(), 0.0)
    hi = torch.clamp(rmi_length - 1.0, min=0.0)[..., None]
    pred = torch.minimum(torch.clamp(root_w[..., None] * x + root_b[..., None], min=0.0), hi)
    leaf = torch.floor(pred * n_leaves / torch.clamp(rmi_length, min=1.0)[..., None])
    leaf = torch.clamp(leaf.to(torch.int64), 0, n_leaves - 1)
    one = torch.nn.functional.one_hot(leaf, n_leaves).to(torch.float64) * w[..., None]
    xs, ys = xd[..., None], y[..., None]
    n_l = one.sum(-2)
    mx = (one * xs).sum(-2) / torch.clamp(n_l, min=1e-300)
    my = (one * ys).sum(-2) / torch.clamp(n_l, min=1e-300)
    dx, dy = xs - mx[..., None, :], ys - my[..., None, :]
    cov, var = (one * dx * dy).sum(-2), (one * dx * dx).sum(-2)
    lw = torch.where(var > 1e-12, cov / torch.clamp(var, min=1e-300), 0.0)
    lb = my - lw * mx
    g = lambda t: torch.gather(t, -1, leaf)
    ref = g(lw) * xd + g(lb)
    prog = g(leaf_w).double() * x.double() + g(leaf_b).double()
    dev_leaf = torch.where(valid, (prog - ref).abs(), 0.0)
    bad = ((dev_root > pos_tol) | (dev_leaf > pos_tol)) & valid
    count = int(bad.sum()) + int((rmi_length != valid.sum(-1).to(rmi_length.dtype)).sum())
    return count, float(torch.maximum(dev_root, dev_leaf).max()) if valid.any() else 0.0


def _order_faults(sk, ids, valid) -> int:
    """Sorted arrays (..., L) out of order: keys that fall, equal keys out of
    slot order, pads that are not pads."""
    down = (sk[..., 1:] < sk[..., :-1]) & valid[..., 1:]
    tie = (sk[..., 1:] == sk[..., :-1]) & (ids[..., 1:] <= ids[..., :-1]) & valid[..., 1:]
    pads = ~valid & ((sk != PAD_KEY) | (ids != -1))
    return int(down.sum() + tie.sum() + pads.sum())


def _bank_arrays(st: dict, s: int, e: int):
    """Clusters ``s:e`` of the bank -> (sorted keys, sorted slots, valid,
    the passage id of each sorted slot, sizes (m, 1, 1))."""
    sk, sp = st["b_sorted_keys"][s:e], st["b_sorted_pos"][s:e].to(torch.int64)
    gids = st["b_gids"][s:e].to(torch.int64)
    lp = gids.shape[1]
    sz = (gids >= 0).sum(1)[:, None, None]
    valid = (torch.arange(lp, device=sk.device) < sz).expand_as(sk)
    gid = torch.gather(gids[:, None, :].expand_as(sp), 2, torch.clamp(sp, min=0))
    return sk, sp, valid, gid, sz


def check_index(st: dict, cfg: dict, corpus: torch.Tensor, proj_c: torch.Tensor,
                proj_b: torch.Tensor, build_seed: int, *, band_key: float, band_dist: float,
                pos_tol: float, tol_centroid: float, chunk_rows: int = 1 << 18,
                chunk_clusters: int = 64) -> tuple[dict, dict]:
    """Count the faults of each stage but the centroids -> ``({stage:
    count}, readings)``; the readings hold ``centroids_off``, the count of
    centroids more than ``tol_centroid`` from the float64 refit."""
    n, _ = corpus.shape
    gids = st["b_gids"].to(torch.int64)
    c, lp = gids.shape
    dev = corpus.device
    h_n, m = cfg["n_arrays"], cfg["key_len"]
    valid = gids >= 0
    sizes = valid.sum(1)
    slot = torch.arange(lp, device=dev)
    out, rd = {}, {}

    cent = st["centroids"]
    steps = kmeans_refit(corpus, c, cfg["kmeans_iters"], build_seed, chunk_rows=chunk_rows)
    rd.update(centroid_readings(cent, steps, tol_centroid))
    del steps

    counts = torch.bincount(gids[valid], minlength=n)
    out["layout"] = int((valid != (slot < sizes[:, None])).sum() + (counts != 1).sum()
                        + ((gids[:, 1:] <= gids[:, :-1]) & valid[:, 1:]).sum())

    # the bank's arrays: order and statistics, and each row's key as stored
    prog_keys = torch.full((n, h_n), -1, dtype=torch.int64, device=dev)
    order_f, resc_f, rmi_f, rmi_dev = 0, 0, 0, 0.0
    for s in range(0, c, chunk_clusters):
        e = min(s + chunk_clusters, c)
        sk, sp, v, gid, sz = _bank_arrays(st, s, e)
        expect = torch.where(slot >= lp - sz, slot - (lp - sz), -1)
        order_f += int((torch.sort(sp, dim=-1).values != expect).sum())
        order_f += _order_faults(sk, sp, v)
        h = torch.arange(h_n, device=dev)[None, :, None].expand_as(sk)
        prog_keys[gid[v], h[v]] = sk[v]
        last = torch.gather(sk, 2, torch.clamp(sz - 1, min=0).expand(-1, h_n, 1))[..., 0]
        resc_f += int((st["b_key_min"][s:e] != sk[..., 0]).sum()
                      + (st["b_key_max"][s:e] != last).sum()
                      + (st["b_length"][s:e] != sz[..., 0].float()).sum())
        f, dv = rmi_mismatches(
            sk, v, st["b_key_min"][s:e], st["b_key_max"][s:e], st["b_length"][s:e],
            st["b_root_w"][s:e], st["b_root_b"][s:e], st["b_leaf_w"][s:e], st["b_leaf_b"][s:e],
            st["b_rmi_length"][s:e], pos_tol=pos_tol)
        rmi_f, rmi_dev = rmi_f + f, max(rmi_dev, dv)

    # each row: its cluster's centroid the nearest, its stored keys its own
    cluster_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
    cluster_of[gids[valid]] = torch.arange(c, device=dev)[:, None].expand(c, lp)[valid]
    c_sq = (cent.double() ** 2).sum(1)
    far, gap, key_f, flip = 0, 0.0, 0, 0.0
    for s in range(0, n, chunk_rows):
        x = corpus[s:s + chunk_rows]
        d2 = c_sq - 2.0 * dots(x, cent.T)
        own = torch.gather(d2, 1, torch.clamp(cluster_of[s:s + chunk_rows], min=0)[:, None])[:, 0]
        g = own - d2.min(1).values
        far += int((g > band_dist).sum())
        gap = max(gap, float(g.max()))
        p = dots(x, proj_b).view(-1, h_n, m)
        f, fl = bit_readings(_bits(prog_keys[s:s + chunk_rows], m), p, band_key)
        key_f, flip = key_f + f, max(flip, fl)
    out["partition"] = far + int((cluster_of < 0).sum())
    out["bank_keys"] = order_f + key_f
    out["bank_rescale"], out["bank_rmi"] = resc_f, rmi_f

    # centroid retriever: every centroid once in each array
    hc, mc = cfg["n_arrays_centroid"], cfg["key_len_centroid"]
    sk_c, ids_c = st["c_sorted_keys"], st["c_sorted_ids"].to(torch.int64)
    all_c = torch.ones_like(sk_c, dtype=torch.bool)
    perm = int((torch.sort(ids_c, dim=1).values != torch.arange(c, device=dev)).sum())
    prog_c = torch.full((c, hc), -1, dtype=torch.int64, device=dev)
    prog_c[ids_c, torch.arange(hc, device=dev)[:, None].expand_as(ids_c)] = sk_c
    f, fl = bit_readings(_bits(prog_c, mc), dots(cent, proj_c).view(c, hc, mc), band_key)
    out["centroid_keys"] = perm + _order_faults(sk_c, ids_c, all_c) + f
    flip = max(flip, fl)
    out["centroid_rescale"] = int((st["c_key_min"] != sk_c[:, 0]).sum()
                                  + (st["c_key_max"] != sk_c[:, -1]).sum()
                                  + (st["c_length"] != float(c)).sum())
    f, dv = rmi_mismatches(
        sk_c, all_c, st["c_key_min"], st["c_key_max"], st["c_length"], st["c_root_w"],
        st["c_root_b"], st["c_leaf_w"], st["c_leaf_b"], st["c_rmi_length"], pos_tol=pos_tol)
    out["centroid_rmi"], rmi_dev = f, max(rmi_dev, dv)
    rd.update(key_flip=flip, dist_gap=gap, rmi_dev=rmi_dev)
    return out, rd


def tf32_readings(st: dict, cfg: dict, corpus: torch.Tensor, q: torch.Tensor,
                  proj_c: torch.Tensor, proj_b: torch.Tensor, *, band_key: float,
                  band_score: float, band_dist: float, pos_tol: float,
                  chunk_rows: int = 1 << 18, chunk_clusters: int = 64) -> dict:
    """The readings of :func:`check_index`, and the centroid scores', for
    decisions made in TF32 over the same index: the control's. Each
    ``*_over`` counts what would fall outside its band."""
    n = corpus.shape[0]
    cent = st["centroids"]
    c, h_n, m = cent.shape[0], cfg["n_arrays"], cfg["key_len"]
    c_sq = (cent.double() ** 2).sum(1)
    rd = dict(key_flip=0.0, key_over=0, dist_gap=0.0, dist_over=0)
    for s in range(0, n, chunk_rows):
        x = corpus[s:s + chunk_rows]
        d2 = c_sq - 2.0 * dots(x, cent.T)
        a = torch.argmin(c_sq - 2.0 * dots(x, cent.T, tf32=True), dim=1)
        g = torch.gather(d2, 1, a[:, None])[:, 0] - d2.min(1).values
        rd["dist_gap"] = max(rd["dist_gap"], float(g.max()))
        rd["dist_over"] += int((g > band_dist).sum())
        p = dots(x, proj_b).view(-1, h_n, m)
        f, fl = bit_readings(dots(x, proj_b, tf32=True).view(-1, h_n, m) >= 0, p, band_key)
        rd["key_over"] += f
        rd["key_flip"] = max(rd["key_flip"], fl)
    hc, mc = cfg["n_arrays_centroid"], cfg["key_len_centroid"]
    f, fl = bit_readings(dots(cent, proj_c, tf32=True).view(c, hc, mc) >= 0,
                         dots(cent, proj_c).view(c, hc, mc), band_key)
    rd["key_over"] += f
    rd["key_flip"] = max(rd["key_flip"], fl)
    err = (dots(q, cent.T, tf32=True) - dots(q, cent.T)).abs()
    rd["score_err"], rd["score_over"] = float(err.max()), int((err > band_score).sum())
    rmi_over, rmi_dev = 0, 0.0
    for s in range(0, c, chunk_clusters):
        e = min(s + chunk_clusters, c)
        sk, _, v, _, _ = _bank_arrays(st, s, e)
        f, dv = rmi_mismatches(
            sk, v, st["b_key_min"][s:e], st["b_key_max"][s:e], st["b_length"][s:e],
            st["b_root_w"][s:e], st["b_root_b"][s:e], st["b_leaf_w"][s:e], st["b_leaf_b"][s:e],
            st["b_rmi_length"][s:e], pos_tol=pos_tol, tf32=True)
        rmi_over, rmi_dev = rmi_over + f, max(rmi_dev, dv)
    rd.update(rmi_dev=rmi_dev, rmi_over=rmi_over)
    return rd
