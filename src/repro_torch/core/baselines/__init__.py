"""ANN baselines the paper evaluates against (Sec. 7.1.2): Flat (exact),
PQ (with OPQ and PCA-PQ as options), IVF-PQ, the original SK-LSH and a
FALCONN-style multi-probe LSH, all returning the core library's ``TopK``.
Each approximate baseline's module also has ``params_from_numpy``, which
takes the numpy leaves of an index the JAX package built."""
from .flat import flat_search
from .ivfpq import IVFPQParams, build_ivfpq, ivfpq_search
from .mplsh import MPLSHParams, build_mplsh, mplsh_search
from .pq import PQParams, build_pq, pq_search
from .sklsh import SKLSHParams, build_sklsh, sklsh_search

__all__ = [
    "flat_search",
    "PQParams",
    "build_pq",
    "pq_search",
    "IVFPQParams",
    "build_ivfpq",
    "ivfpq_search",
    "SKLSHParams",
    "build_sklsh",
    "sklsh_search",
    "MPLSHParams",
    "build_mplsh",
    "mplsh_search",
]
