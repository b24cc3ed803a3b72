"""The port's copied frontend against the JAX package's — the drift guard.

``repro_torch.core`` keeps its own copies of the framework-free frontend
(``ast``, ``parser``, ``logic``, ``analysis``, ``plan``, ``stm``,
``algorithms``, ``interpreter``), because the card it runs on has no JAX and
importing ``repro.core`` imports the JAX compiler. These tests hold each
copy to its original: the same source apart from the package name, and for
every program × schedule × fuse the same superstep plan and the same STM
cost models. The same holds for the framework-free modules of the model
slices (``configs/common.py``, ``models/recsys/config.py`` and the config
modules of the ported architectures). They also check that the port
imports without JAX.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import algorithms as jalg  # noqa: E402
from repro.core import parser as jparser  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import stm as jstm  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core import parser as tparser  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import stm as tstm  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
COPIED = ("ast", "parser", "logic", "analysis", "plan", "stm", "algorithms", "interpreter")


@pytest.mark.parametrize("module", COPIED)
def test_copy_matches_original_source(module):
    """A copied module differs from the JAX package's only in its imports."""
    port = (SRC / "repro_torch" / "core" / f"{module}.py").read_text()
    orig = (SRC / "repro" / "core" / f"{module}.py").read_text()
    assert port.replace("repro_torch.", "repro.") == orig


#: modules outside ``core`` copied from the JAX package, by path under the
#: package: the model slices' configs, the GNN package's head and the
#: partition statistics
COPIED_MODELS = (
    "configs/common.py",
    "configs/h2o_danube_1_8b.py",
    "configs/qwen3_32b.py",
    "configs/qwen2_5_32b.py",
    "configs/autoint.py",
    "configs/graphsage_reddit.py",
    "configs/gat_cora.py",
    "configs/pna.py",
    "configs/graphcast.py",
    "models/recsys/config.py",
    "models/gnn/config.py",
    "models/gnn/__init__.py",
    "graph/partition/stats.py",
)


@pytest.mark.parametrize("path", COPIED_MODELS)
def test_model_copy_matches_original_source(path):
    """A copied module differs from the JAX package's only in the package
    name (``configs/common.py``, ``models/recsys/config.py`` and
    ``models/gnn/config.py`` import nothing of it and are byte copies)."""
    port = (SRC / "repro_torch" / path).read_text()
    orig = (SRC / "repro" / path).read_text()
    assert port.replace("repro_torch.", "repro.") == orig
    if "repro." not in orig:
        assert port == orig


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("schedule", ["pull", "push", "naive", "auto"])
@pytest.mark.parametrize("name", sorted(jalg.ALL))
def test_program_plan_matches(name, schedule, fuse):
    """Same superstep structure: the items (supersteps with their op parts,
    loops) render identically, and so do the per-step plans and costs."""
    jprog = jparser.parse(jalg.ALL[name])
    tprog = tparser.parse(talg.ALL[name])
    assert repr(tprog) == repr(jprog)
    jpp = jplan.lower_program(jprog, schedule=schedule)
    tpp = tplan.lower_program(tprog, schedule=schedule)
    if fuse:
        jpp, tpp = jplan.fuse(jpp), tplan.fuse(tpp)
    assert repr(tpp.items) == repr(jpp.items)
    assert tpp.describe() == jpp.describe()
    assert tpp.cost() == jpp.cost()
    assert [p.describe() for _, p in tpp.step_plans] == [
        p.describe() for _, p in jpp.step_plans
    ]


@pytest.mark.parametrize("name", sorted(jalg.ALL))
def test_superstep_report_matches(name):
    """Same STM cost models under every compilation regime."""
    jrep = jstm.superstep_report(jparser.parse(jalg.ALL[name]))
    trep = tstm.superstep_report(tparser.parse(talg.ALL[name]))
    assert {k: dataclasses.astuple(v) for k, v in trep.items()} == {
        k: dataclasses.astuple(v) for k, v in jrep.items()
    }


def test_port_imports_without_jax():
    """``repro_torch`` imports with ``jax`` and ``repro`` unimportable, and
    runs the graph path in both placements (the partitioned one on one
    shard), a GNN forward, a sampled GraphSAGE minibatch and one reduced
    training step (``repro_torch.optim``, ``repro_torch.launch.train``)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.core, repro_torch.graph, "
        "repro_torch.pregel, repro_torch.kernels, repro_torch.configs, "
        "repro_torch.models, repro_torch.models.transformer, "
        "repro_torch.models.recsys, repro_torch.launch.serve, repro_torch.data, "
        "repro_torch.models.gnn, repro_torch.graph.sampler, "
        "repro_torch.data.pipeline\n"
        "from repro_torch.graph import generators\n"
        "from repro_torch.core import compile_program, algorithms\n"
        "g = generators.chain(8, device='cpu')\n"
        "compile_program(algorithms.SSSP, g).run()\n"
        "from repro_torch import configs\n"
        "for arch in configs.all_arch_ids():\n"
        "    configs.get_spec(arch)\n"
        "repro_torch.launch.serve.main(['--reduced', '--device', 'cpu', "
        "'--batch', '1', '--prompt-len', '8', '--decode-steps', '2'])\n"
        "from repro_torch.models.recsys import autoint\n"
        "cfg = configs.get_spec('autoint').reduced\n"
        "p = autoint.init(cfg, device='cpu')\n"
        "b = next(repro_torch.data.recsys_batches(4, cfg.n_fields, "
        "cfg.vocab_per_field, device='cpu'))\n"
        "autoint.forward(p, b, cfg)\n"
        "from repro_torch.models.gnn import models as gm\n"
        "gcfg = configs.resolve_gnn_config(configs.get_spec('gat-cora').reduced, "
        "'full_graph_sm', {'d_feat': 6})\n"
        "gb = repro_torch.data.gnn_full_batch(32, 3.0, 6, 3, device='cpu')\n"
        "assert gm.forward(gm.init(gcfg, device='cpu'), gb, gcfg).shape == (32, 3)\n"
        "scfg = configs.get_spec('graphsage-reddit').reduced\n"
        "mb = next(repro_torch.data.gnn_minibatches(g, gb['x'][:8], gb['labels'][:8], "
        "4, scfg.fanouts, __import__('torch').Generator()))\n"
        "assert gm.sage_minibatch_forward(gm.init(scfg, device='cpu'), mb, scfg).shape "
        "== (4, 3)\n"
        "import repro_torch.graph.partition, repro_torch.dist\n"
        "from repro_torch.pregel import run_bsp\n"
        "cp = compile_program(algorithms.WCC, g)\n"
        "res = run_bsp(cp.prog, g, cp.init_fields(), placement='partitioned', "
        "n_shards=1)\n"
        "assert res.fields['C'].tolist() == [0] * 8\n"
        "import repro_torch.optim, repro_torch.launch.train as tr\n"
        "losses = tr.train('h2o-danube-1.8b', True, steps=1, batch=1, seq=8, "
        "device='cpu', log=lambda line: None)\n"
        "assert len(losses) == 1 and losses[0] > 0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
