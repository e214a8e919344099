"""The decomposition the per-query kernels rely on, checked on the CPU.

``fused_verify`` and ``sketch_prefilter`` cut each query's C candidates
into chunks (``split_candidates``), keep a top-k per chunk, and merge the
partial lists by one rule: sort the union on (score descending, id
ascending), keep the first entry of each id, take the first k, pad with
(-1, -inf). Here the plain versions (``ref.verify_topk_ref``,
``ref.sketch_topk_ref``) run chunk by chunk with the wrapper's cuts, the
partial lists are merged by that rule in numpy, and the result must equal
the whole call bit for bit: ids and score bits, on float32, int8, packed
int4 and sketch tables. One case is also held against the JAX package's
Pallas kernels in interpret mode, on the same numpy inputs. The CUDA
kernels meet the same cases in ``tests/test_torch_kernels.py`` (marked
``gpu``) and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import quant, ref
from repro_torch.kernels.fused_verify import MAX_CHUNK, split_candidates

D = 32


def _case(kind: str, seed: int = 0):
    """(embs, row_ids, out_ids, queries, k) as numpy, one per edge case."""
    rng = np.random.default_rng(seed)
    n, b, c, k = 3_000, 2, 9_001, 60
    if kind == "k = C":
        c = k = 4_096
    if kind == "k above a chunk's distinct rows":
        n, c, k = 1_500, 9_000, 4_096
    if kind == "k above the shared-memory list":  # the large-k path, 3 chunks
        n, c, k = 20_000, 12_000, 6_400
    if kind == "k above C, one chunk":
        c, k = 3_000, 6_400
    embs = rng.standard_normal((n, D)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    rows = rng.integers(0, n, (b, c)).astype(np.int32)
    out = rows.copy()
    _, chunk = split_candidates(c)
    if kind == "one id in every chunk":
        rows[:, ::97] = 5
        out = rows.copy()
    elif kind == "a chunk of only invalid ids":
        out[:, chunk : 2 * chunk] = -1
    elif kind == "ties at the k-th score across chunks":
        embs = embs[np.arange(n) % 40]  # 75 ids share each score
    elif kind == "C not a multiple of the chunk":
        out[rng.random((b, c)) < 0.3] = -1
        out[-1] = -1  # an all-invalid query row
    q = rng.standard_normal((b, D)).astype(np.float32)
    return embs, rows, out, q, k


KINDS = [
    "one id in every chunk",
    "a chunk of only invalid ids",
    "ties at the k-th score across chunks",
    "C not a multiple of the chunk",
    "k = C",
    "k above a chunk's distinct rows",
    "k above the shared-memory list",
    "k above C, one chunk",
]
TABLES = ["float32", "int8", "int4", "sketch"]


def _plain(table: str, embs, rows, out, q, k):
    """The plain version of ``table``'s kernel on numpy inputs -> numpy."""
    e, r, o, qq = (torch.from_numpy(a) for a in (embs, rows, out, q))
    if table == "sketch":
        ids, sc = ref.sketch_topk_ref(quant.sketch_rows(e), r, qq, k=k, out_ids=o)
    elif table == "float32":
        ids, sc = ref.verify_topk_ref(e, r, qq, k=k, out_ids=o)
    else:
        codes, scales = (quant.quantize_rows if table == "int8" else quant.quantize_rows_int4)(e)
        ids, sc = ref.verify_topk_ref(codes, r, qq, k=k, out_ids=o, scales=scales,
                                      code_dtype=table)
    return ids.numpy(), sc.numpy()


def merge_partials(ids: np.ndarray, scores: np.ndarray, k: int):
    """The kernels' merge of (B, S*k) partial lists: (score desc, id asc),
    the first entry of each id, the first k, (-1, -inf) past them."""
    b = ids.shape[0]
    out_ids = np.full((b, k), -1, np.int32)
    out_sc = np.full((b, k), -np.inf, np.float32)
    for i in range(b):
        keep = scores[i] != -np.inf  # padding
        r_ids, r_sc = ids[i][keep], scores[i][keep]
        order = np.lexsort((r_ids, -r_sc))
        seen, m = set(), 0
        for j in order:
            if m == k:
                break
            if r_ids[j] in seen:
                continue
            seen.add(r_ids[j])
            out_ids[i, m], out_sc[i, m] = r_ids[j], r_sc[j]
            m += 1
    return out_ids, out_sc


def _chunked(table: str, embs, rows, out, q, k):
    n_chunks, chunk = split_candidates(rows.shape[1])
    parts = [
        _plain(table, embs, rows[:, i * chunk : (i + 1) * chunk],
               out[:, i * chunk : (i + 1) * chunk], q, k)
        for i in range(n_chunks)
    ]
    return merge_partials(np.concatenate([p[0] for p in parts], axis=1),
                          np.concatenate([p[1] for p in parts], axis=1), k)


def _assert_bit_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32), want[1].view(np.int32))


@pytest.mark.parametrize("c", [0, 1, 400, 800, 1_600, 4_000, 4_096, 4_097, 9_001, 80_000, 80_003])
def test_split_candidates_covers_c_in_equal_chunks(c):
    n_chunks, chunk = split_candidates(c)
    assert chunk <= MAX_CHUNK
    assert (n_chunks - 1) * chunk < max(c, 1) <= n_chunks * max(chunk, 1)
    if c <= MAX_CHUNK:  # routing (800), rescore (400), the int4 pass (1,600)
        assert n_chunks == 1
    if c == 80_000:  # the in-cluster call: one chunk per probed cluster's H * R
        assert (n_chunks, chunk) == (20, 4_000)


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("kind", KINDS)
def test_chunked_plain_version_equals_whole_call(kind, table):
    embs, rows, out, q, k = _case(kind)
    whole = _plain(table, embs, rows, out, q, k)
    _assert_bit_equal(_chunked(table, embs, rows, out, q, k), whole)
    if kind == "a chunk of only invalid ids":
        assert split_candidates(rows.shape[1])[0] >= 3
    if kind == "C not a multiple of the chunk":
        n_chunks, chunk = split_candidates(rows.shape[1])
        assert rows.shape[1] % chunk and (whole[0][-1] == -1).all()
    if kind == "ties at the k-th score across chunks":  # more ids hold the k-th score than fit
        every = _plain(table, embs, rows, out, q, 4_096)
        assert ((every[1] == whole[1][:, k - 1 : k]).sum(1) > (whole[1] == whole[1][:, k - 1 : k]).sum(1)).all()


@pytest.mark.parametrize("table", TABLES)
def test_chunked_plain_version_equals_jax_kernel_interpret(table):
    """The chunked plain version against the JAX package's Pallas kernel in
    interpret mode, C = 8,193 (three chunks), on the same numpy inputs."""
    import importlib

    import jax.numpy as jnp
    from repro.kernels import quant as jquant

    jfv = importlib.import_module("repro.kernels.fused_verify")

    rng = np.random.default_rng(11)
    n, b, c, k = 2_000, 1, 8_193, 20
    embs = rng.standard_normal((n, D)).astype(np.float32)
    rows = rng.integers(0, n, (b, c)).astype(np.int32)
    rows[:, ::97] = 5
    out = rows.copy()
    out[rng.random((b, c)) < 0.2] = -1
    q = rng.standard_normal((b, D)).astype(np.float32)
    got = _chunked(table, embs, rows, out, q, k)
    je, jr, jo, jq = (jnp.asarray(a) for a in (embs, rows, out, q))
    kw = dict(k=k, out_ids=jo, block_c=2_048, interpret=True)
    if table == "sketch":
        wi, ws = jfv.sketch_prefilter(jquant.sketch_rows(je), jr, jq, **kw)
    elif table == "float32":
        wi, ws = jfv.fused_verify(je, jr, jq, **kw)
    else:
        quantize = jquant.quantize_rows if table == "int8" else jquant.quantize_rows_int4
        codes, scales = quantize(je)
        wi, ws = jfv.fused_verify(codes, jr, jq, scales=scales, code_dtype=table, **kw)
    np.testing.assert_array_equal(got[0], np.asarray(wi))
    if table == "float32":  # the two sum in different orders (ROADMAP §3)
        np.testing.assert_allclose(got[1], np.asarray(ws), rtol=1e-5, atol=1e-6)
    else:
        _assert_bit_equal(got, (np.asarray(wi), np.asarray(ws, dtype=np.float32)))
