"""The whole-name check of loaded modules, and that neither the harness
nor the references load JAX, the JAX package or (the references) the
port."""

import ast
import subprocess
import sys

from portbench import harness
from portbench.yardstick.jaxcheck import forbidden_modules


def test_whole_top_level_names():
    assert forbidden_modules(["akka_tpu_torch", "akka_tpu_torch.ops",
                              "jaxtyping", "akka_tpu_tools", "numpy"]) == []
    assert forbidden_modules(["akka_tpu.sharding", "jax", "jaxlib.xla",
                              "flax.linen", "torch"]) == \
        ["akka_tpu", "flax", "jax", "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_references_import_no_program():
    for path in (harness.PKG / "reference").glob("*.py"):
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "akka_tpu",
                            "akka_tpu_torch", "portbench"}, path


def test_harness_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "from portbench.yardstick import trace, keys, roofline\n"
        "for w in ('counter-zipf', 'ring-one'):\n"
        "    c = harness.load_cell(w)\n"
        "    harness.load_module('systems', c.config['system'])\n"
        "    harness.load_module('reference', c.config['name'])\n"
        "    [harness.load_module('metrics', m['name']) for m in c.per_layer]\n"
        "from portbench.yardstick.jaxcheck import forbidden_modules\n"
        "print(forbidden_modules())\n" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
