"""A checkout-shaped directory with one tiny configuration and two tiny
cells, for driving the harness on the CPU in the tests."""
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

CONFIG = {
    "name": "tiny", "reference": "lider", "limits": "tiny", "corpus_size": 8192, "dim": 32,
    "k": 10, "n_clusters": 64, "n_probe": 8, "n_arrays": 4, "n_arrays_centroid": 4,
    "key_len": 10, "key_len_centroid": 6, "n_leaves": 5, "n_leaves_centroid": 4, "r0": 4,
    "r0_centroid": 4, "kmeans_iters": 3, "capacity": None, "pad_multiple": 8,
    "storage_dtype": "float32", "rescore_tier": "device", "spread": 0.35, "query_noise": 0.08,
}
CLOSED = {"loop": "closed", "batch": 64, "in_flight": 2, "pool_batches": 4, "keep_per_batch": 16,
          "check_queries": 64, "trace_from": 2, "trace_batches": 2}
OPEN = {"loop": "open", "batch": 32, "pattern": "zipf", "zipf_a": 1.1, "pool": 256, "tenants": 1,
        "rate": 1500.0, "cache_size": 0, "dynamic_batch": False, "check_queries": 64,
        "trace_seconds": 0.2}


def make_root(tmp: Path) -> Path:
    """``tmp`` as a checkout holding the tiny cells ``tiny-closed`` and
    ``tiny-open``, with the real metric entries pointed at them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    lim = json.loads((BENCH / "limits" / "lider-msmarco.json").read_text())
    lim["judge_bytes"] = 1e8
    files = {
        "perfbench/configs/tiny.json": CONFIG, "perfbench/limits/tiny.json": lim,
        "perfbench/traffic/tiny-closed.json": CLOSED, "perfbench/traffic/tiny-open.json": OPEN,
    }
    bench["configs"] = [{"name": "tiny", "source": "tests", "file": "perfbench/configs/tiny.json",
                         "reduced": [], "why": "tests"}]
    bench["workloads"] = [
        {"name": f"tiny-{t}", "config": "tiny", "traffic": f"tiny-{t}", "chips": 1, "why": "tests"}
        for t in ("closed", "open")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-open" if "open" in w else "tiny-closed" for w in m["workloads"]]
    files["BENCHMARK.json"] = bench
    for name, obj in files.items():
        p = tmp / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(obj))
    return tmp
