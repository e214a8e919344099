"""What a run imports: never JAX, its relatives or the JAX package (compared
by whole top-level names, since the port's name begins with the JAX
package's), and the reference nothing of the program."""
import json
import subprocess
import sys

from perfbench_tiny import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN_IMPORTS = """
import json, sys
sys.argv = ["run.py"]
sys.path.insert(0, {bench!r})
import run
from pbench import cell, system, loops, trace, data, peaks
from pbench.reference import lider, lider_index
bench = json.load(open({root!r} + "/BENCHMARK.json"))
for m in bench["end_to_end"] + bench["per_layer"]:
    cell.reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF_IMPORTS = """
import json, sys
sys.path.insert(0, {bench!r})
from pbench.reference import lider, lider_index
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(bench=str(BENCH), root=str(ROOT))],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax_and_no_jax_package():
    mods = _top_level(RUN_IMPORTS)
    assert "repro_torch" in mods  # the program is there, under its own name
    assert not mods & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    mods = _top_level(REF_IMPORTS)
    assert not mods & (FORBIDDEN | {"repro_torch"})


def test_forbidden_names_are_compared_whole():
    from pbench import cell

    assert cell.forbidden_modules(["repro_torch", "repro_torch.core.lider", "jaxtyping",
                                   "flaxen.x", "numpy"]) == []
    assert cell.forbidden_modules(["repro.core.lider", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "repro"]
