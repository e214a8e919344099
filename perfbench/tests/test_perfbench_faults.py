"""A whole run of each kind of cell, on the CPU at a tiny size: sound, it
comes out correct; with an answer altered where the search produces it,
it comes out not correct."""
import functools
import time

import pytest
import torch

from pbench import cell
from perfbench_tiny import CONFIG, make_root


def alter_answers(search, env):
    """Every query's best passage replaced by the next passage id, its
    score kept."""
    @functools.wraps(search)
    def altered(*args, **kw):
        out = search(*args, **kw)
        ids = out.ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % CONFIG["corpus_size"]
        return type(out)(ids, out.scores)
    return altered


@pytest.mark.parametrize("loop", ["closed", "open"])
@pytest.mark.parametrize("fault", [None, alter_answers], ids=["sound", "altered"])
def test_run_is_correct_only_when_sound(tmp_path, loop, fault):
    root = make_root(tmp_path)
    out = cell.run(f"tiny-{loop}", 2**31 + 17, 0.3, True, device=torch.device("cpu"),
                   t_start=time.perf_counter(), root=root, search_hook=fault)
    res = out["result"]
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["correct"] is (fault is None)
    if fault is not None:
        assert out["checks"]["bad_answers"][0] > 0 or out["checks"]["score_err"][0] > 1e-3
