"""The port's examples (``examples/torch_*.py``) against the JAX computations
they mirror, on the CPU, on the same graph or the same weights.

* quickstart: SSSP's distances within the suite's f32 tolerance (rtol =
  atol = 2e-5; the interpreter oracle inside the example holds too), its
  trips and superstep counts exactly;
* connected components: S-V's labels exactly, fused against staged pull
  and naive inside the example, the trips and the executed supersteps
  equal to JAX's ``run_bsp``;
* gnn_cora: step 0's loss within 1e-4 (relative) of JAX's from JAX's own
  initial parameters, and the final accuracy past the example's 0.8;
* serve_lm: the greedy tokens of prefill + 32 decode steps equal JAX's
  from JAX's parameters and prompts.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import algorithms as jalg  # noqa: E402
from repro.core import compile_program as jax_compile  # noqa: E402
from repro.graph import generators as JG  # noqa: E402
from repro.models.gnn import models as jgm  # noqa: E402
from repro.models.transformer import TransformerConfig as JTransformerConfig  # noqa: E402
from repro.models.transformer import model as jtm  # noqa: E402
from repro.pregel import run_bsp as jax_run_bsp  # noqa: E402
from repro_torch.models.transformer import model as ttm  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(autouse=True)
def one_thread():
    """The examples' many small ops on one intra-op thread: with the
    suite's workers sharing the cores, a thread pool a worker only adds
    contention (gnn_cora's 200 steps ran 20× slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_quickstart_matches_jax():
    res = _load("torch_quickstart").run("cpu")
    g = JG.rmat(10, avg_degree=8, directed=True, weighted=True, seed=7)
    out, trips, counts = jax_compile(jalg.SSSP, g).run()
    want = np.asarray(out["D"])
    assert np.allclose(res["D"], want, rtol=2e-5, atol=2e-5, equal_nan=True)
    assert np.array_equal(np.isinf(res["D"]), np.isinf(want))
    assert res["trips"] == list(trips)
    assert res["counts"] == dict(counts)


def test_connected_components_match_jax():
    res = _load("torch_connected_components").run("cpu")
    g = JG.rmat(11, avg_degree=6, directed=False, seed=3)
    cp = jax_compile(jalg.SV, g)
    out, trips, counts = cp.run()
    assert np.array_equal(res["D"], np.asarray(out["D"]))
    assert res["trips"] == list(trips) and res["counts"] == dict(counts)
    f0 = cp.init_fields()
    pull = jax_run_bsp(cp.prog, g, f0, schedule="pull")
    naive = jax_run_bsp(cp.prog, g, f0, schedule="naive", fuse=False)
    assert res["pull"].supersteps == pull.supersteps
    assert res["naive"].supersteps == naive.supersteps
    assert res["pull"].trips == list(pull.trips) and res["naive"].trips == list(naive.trips)


def test_gnn_cora_matches_jax():
    jex, tex = _load("gnn_cora"), _load("torch_gnn_cora")
    g, x, labels = jex.community_graph()
    cfg = tex.config(x.shape[1])
    params = jgm.init(jax.random.PRNGKey(0), cfg)
    batch = {"x": x, "src": g.src, "dst": g.dst, "emask": g.edge_mask, "labels": labels,
             "lmask": jnp.ones((g.n_vertices,), jnp.float32)}
    want = float(jgm.loss_fn(params, batch, cfg))
    res = tex.train("cpu", params=_numpy_tree(params), log=lambda line: None)
    assert abs(res["losses"][0] - want) <= 1e-4 * abs(want)
    assert res["acc"] > 0.8 and len(res["losses"]) == tex.EPOCHS


def test_serve_lm_matches_jax():
    tex = _load("torch_serve_lm")
    cfg = tex.config()
    jcfg = JTransformerConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    params = jtm.init(jax.random.PRNGKey(0), jcfg)
    prompts = jax.random.randint(jax.random.PRNGKey(1), (4, 64), 0, cfg.vocab_size)
    prefill = jax.jit(lambda p, t: jtm.prefill(p, t, jcfg, full_logits=False))
    decode = jax.jit(lambda p, c, t: jtm.decode_step(p, c, t, jcfg))
    logits, cache = prefill(params, prompts)
    cur = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    toks = [cur]
    for _ in range(32):
        logits, cache = decode(params, cache, cur)
        cur = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(cur)
    want = np.asarray(jnp.concatenate(toks, axis=1))
    tparams = ttm.params_from_arrays(cfg, _numpy_tree(params), "cpu")
    res = tex.serve(tparams, cfg, torch.from_numpy(np.asarray(prompts, np.int32)), 32)
    assert res["capacity"] == cache["k"].shape[2] == 32
    assert np.array_equal(res["tokens"].numpy(), want)


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_connected_components",
                                  "torch_serve_lm"])
def test_example_main_runs_on_cpu(name, capsys):
    _load(name).main(["--device", "cpu"])
    assert capsys.readouterr().out
