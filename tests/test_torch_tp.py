"""The port's dense LM tensor- and sequence-parallel over the mesh's
``model`` axis, held to the JAX package's under the same mesh, on the CPU.

``tests/torch_tp_reference.py``'s ``make_inputs`` draws every input once
(numpy seeds; parameters from the JAX initialiser, carried across); then
two subprocesses run at once: the reference, JAX on 4 fake devices jitted
under its own shardings, and ``tests/torch_tp_ranks.py``, the port on 4
gloo ranks, each holding its shards and its data shard's rows. For the
reduced h2o-danube-1.8b and qwen3-32b (f32, 2 kv heads: held whole on
``(data, model) = (1, 4)``, split on ``(2, 2)``):

* the loss within ``TOL`` and every gradient within ``GRAD_F32`` ·
  max|g| (``tests/test_torch_mesh.py``'s bounds), gathered whole;
* two trainer steps with the parameters in ``fsdp`` and in ``zero1``: the
  losses and the parameters after them within ``TOL``; each rank's live
  parameter and AdamW moment shapes JAX's shard shapes;
* a rank's logits ``[B/data, S, V/m]``;
* a prefill past h2o-danube's window (its ring wraps): the logits within
  ``TOL``, each rank's cache JAX's cache shard for that rank (its rows,
  its ``C/m`` slots, every kv head) within ``TOL``, of JAX's shard shape;
* three decode steps on that cache: the logits within ``TOL``.

In process: on a one-rank mesh the LM's outputs and gradients are bit-equal
to those without a mesh (the tensor-parallel path is not taken), for the
MoE configs too, and :func:`head_plan` on the pod meshes' model axis of 16.
The MoE configs on the mesh are ``tests/test_torch_tp_moe.py``'s, which
runs the same checks through :func:`run_pair`.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_tp_reference as ref  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-5
GRAD_F32 = 1e-4
CASES = [(arch, tag) for arch in ref.ARCHS for tag in ref.MESHES]


def run_pair(out, archs, timeout=240):
    """``(jax, port)`` result dicts of the two subprocesses, run at once on
    the inputs of ``archs`` in the directory ``out``."""
    ref.make_inputs(out / "inputs.npz", archs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {
        name: subprocess.Popen([sys.executable, str(ROOT / "tests" / script), str(out), *archs],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                               cwd=str(ROOT), env=env)
        for name, script in (("jax", "torch_tp_reference.py"), ("port", "torch_tp_ranks.py"))
    }
    logs = {}
    try:
        for name, proc in procs.items():
            logs[name] = proc.communicate(timeout=timeout)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    for name, proc in procs.items():
        assert proc.returncode == 0, f"{name}:\n{logs.get(name, '')[-6000:]}"
    return dict(np.load(out / "jax.npz")), dict(np.load(out / "torch.npz"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """``(jax, port)`` result dicts of the two subprocesses."""
    return run_pair(tmp_path_factory.mktemp("tp"), ref.ARCHS)


def _close(got, want, what, tol=TOL):
    """Within ``tol`` relative, or ``tol`` · max|want| absolute."""
    atol = tol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=what)


def _under(res, prefix):
    return sorted(k for k in res if k.startswith(prefix))


@pytest.mark.parametrize("arch,tag", CASES)
def test_loss_and_gradients(results, arch, tag):
    """The loss within ``TOL`` of JAX's on the mesh, and the gradient of
    every leaf (the rank's shards gathered whole, replicated leaves summed
    over the model ranks and averaged over the data ranks) within
    ``GRAD_F32`` · max|g|."""
    jax_res, port = results
    key = f"{arch}/{tag}"
    _close(port[f"{key}/loss"], jax_res[f"{key}/loss"], "loss")
    keys = _under(jax_res, f"{key}/grads/")
    assert keys and keys == _under(port, f"{key}/grads/")
    for k in keys:
        _close(port[k], jax_res[k], k, GRAD_F32)


@pytest.mark.parametrize("mode", ref.MODES)
@pytest.mark.parametrize("arch,tag", CASES)
def test_train_steps(results, arch, tag, mode):
    """Two ``make_step`` steps on the rank's shards (``mode``: the
    parameters in ``fsdp``, or over ``model`` only with the moments in
    ``fsdp``) against JAX's ``step_fn`` under the same placement: the
    losses and every parameter after them within ``TOL``."""
    jax_res, port = results
    key = f"{arch}/{tag}/{mode}"
    _close(port[f"{key}/losses"], jax_res[f"{key}/losses"], "losses")
    keys = _under(jax_res, f"{key}/params/")
    assert keys and keys == _under(port, f"{key}/params/")
    for k in keys:
        _close(port[k], jax_res[k], k)


@pytest.mark.parametrize("mode", ref.MODES)
@pytest.mark.parametrize("arch,tag", CASES)
def test_live_shard_shapes(results, arch, tag, mode):
    """Every rank's live parameter and moment shards have the shape of
    JAX's shards of them after the steps."""
    jax_res, port = results
    key = f"{arch}/{tag}/{mode}"
    for part in ("params", "m", "v"):
        keys = _under(jax_res, f"{key}/shape/{part}/")
        assert keys
        for rank in range(4):
            for k in keys:
                got = port[k.replace("/shape/", f"/shape/{rank}/")]
                assert tuple(got) == tuple(jax_res[k]), (rank, k)


@pytest.mark.parametrize("arch,tag", CASES)
def test_logits_are_the_ranks_vocabulary_block(results, arch, tag):
    """A rank's logits are ``[B / data, S, V / model]``: no rank holds the
    whole vocabulary's."""
    from repro_torch import configs

    cfg = configs.get_spec(arch).reduced
    n_data, n_model = ref.MESHES[tag]
    for rank in range(4):
        got = tuple(results[1][f"{arch}/{tag}/logits_shape/{rank}"])
        assert got == (ref.BATCH // n_data, ref.SEQ, cfg.vocab_size // n_model)


@pytest.mark.parametrize("arch,tag", CASES)
def test_supervised_checkpoint_of_the_shards(results, arch, tag):
    """``launch.train.Supervised`` on the ``(data, model)`` mesh: the model runs
    tensor-parallel over the rows its data shard holds, its two losses are
    JAX's ``fsdp`` step's, and its checkpoint — the shards gathered into
    whole arrays with their specs — holds JAX's parameters after the
    steps, each split leaf's spec naming ``model``."""
    import json

    jax_res, port = results
    key = f"{arch}/{tag}"
    assert bool(port[f"{key}/supervised/on_mesh"])
    _close(port[f"{key}/supervised/losses"], jax_res[f"{key}/fsdp/losses"], "losses")
    step_dir = Path(str(port["ckpt_root"])) / arch / tag / f"step_{ref.TRAIN_STEPS:08d}"
    keys = json.loads((step_dir / "manifest.json").read_text())["keys"]
    arrays = np.load(step_dir / "arrays.npz")
    for k in _under(jax_res, f"{key}/fsdp/params/"):
        path = "params/" + k[len(f"{key}/fsdp/params/"):]
        _close(arrays[path], jax_res[k], path)
    assert "model" in keys["params/layers/wq"]["spec"]
    assert "model" in keys["params/embed"]["spec"]


def _rank_slices(shape, spec_entries, mesh_shape, coordinate):
    """The block of a ``shape`` array that the rank at ``coordinate`` holds
    under a spec (entries ``None`` or a mesh axis name)."""
    axes = ("data", "model")
    out = []
    for n, entry in zip(shape, spec_entries):
        if entry is None:
            out.append(slice(None))
            continue
        parts = mesh_shape[axes.index(entry)]
        i = coordinate[axes.index(entry)]
        out.append(slice(i * n // parts, (i + 1) * n // parts))
    return tuple(out)


@pytest.mark.parametrize("arch,tag", CASES)
def test_prefill(results, arch, tag):
    """The prefill's logits (each rank's rows and vocabulary block,
    gathered whole) within ``TOL`` of JAX's; each rank's cache is JAX's
    cache shard for that rank under ``lm_cache_spec`` — its rows and its
    ``C/m`` slots of every kv head, JAX's shard shape — within ``TOL``."""
    jax_res, port = results
    key = f"{arch}/{tag}/prefill"
    _close(port[f"{key}/logits"], jax_res[f"{key}/logits"], "logits")
    spec = ast.literal_eval(str(jax_res[f"{key}/cache_spec"]))
    assert spec[2] == "model"
    for part in ("k", "v"):
        want = jax_res[f"{key}/{part}"]
        for rank in range(4):
            coord = tuple(port[f"{arch}/{tag}/coordinate/{rank}"])
            got = port[f"{key}/{part}/{rank}"]
            assert tuple(got.shape) == tuple(jax_res[f"{key}/{part}_shard_shape"])
            _close(got, want[_rank_slices(want.shape, spec, ref.MESHES[tag], coord)],
                   f"{part} rank {rank}")


@pytest.mark.parametrize("arch,tag", CASES)
def test_decode_steps(results, arch, tag):
    """Three decode steps on the prefill's cache: each rank attends over
    its own slots, the ranks' partial attentions combined by their
    log-sum-exp; the logits within ``TOL`` of JAX's on the mesh."""
    jax_res, port = results
    for s in range(ref.DECODE_STEPS):
        k = f"{arch}/{tag}/decode{s}"
        _close(port[k], jax_res[k], k)


@pytest.mark.parametrize("arch", ref.ARCHS + ref.MOE_ARCHS)
def test_one_rank_mesh_is_the_plain_path(arch):
    """On a one-rank mesh the loss, every gradient, the prefill's logits and
    cache and two decode steps are bit-equal to those without a mesh: no
    collective, the one-rank code."""
    import torch

    from repro_torch import configs
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import train as tr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import model as tm

    cfg = configs.get_spec(arch).reduced
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, dtype=torch.int32)
    labels = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, dtype=torch.int32)

    def run():
        params = tm.init(cfg, 3, "cpu", trainable=True)
        loss, grads = tr.value_and_grad(lambda p, b: tm.loss_fn(p, b, cfg), params,
                                        {"tokens": tokens, "labels": labels})
        with torch.no_grad():
            logits, cache = tm.prefill(params, tokens, cfg)
            steps = [tm.decode_step_(params, cache, tokens[:, i:i + 1], cfg) for i in range(2)]
        return [loss, *grads.values(), logits, cache["k"], cache["v"], *steps]

    plain = run()
    shd.activate(make_mesh((1, 1), ("data", "model"), device="cpu"))
    try:
        assert shd.model_axis() is None
        meshed = run()
    finally:
        shd.deactivate()
    assert len(plain) == len(meshed)
    for a, b in zip(plain, meshed):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,want", [
    ("h2o-danube-1.8b", ((2, 1), False)),  # 32 heads, 8 kv heads: one kv head a rank
    ("qwen3-32b", ((4, 1), False)),  # 64 heads, 8 kv heads
    ("qwen2.5-32b", ((40, 8), True)),  # 40 heads: JAX holds them whole on every rank
])
def test_head_plan_on_sixteen_model_ranks(arch, want):
    """The heads a rank of the pod meshes' model axis (16) attends with and
    the kv heads they read, on every rank: the rank's block of the query
    heads reading one kv head, or all heads where 16 does not divide them."""
    from repro_torch import configs
    from repro_torch.dist.sharding import ModelAxis
    from repro_torch.models.transformer import model as tm

    cfg = configs.get_spec(arch).config
    (nq, nk), whole = want
    for r in range(16):
        (q0, q1), (k0, k1) = tm.head_plan(cfg, ModelAxis(None, 16, r))
        assert (q1 - q0, k1 - k0) == (nq, nk)
        assert (q0 == 0 and q1 == cfg.n_heads) == whole
        if not whole:
            assert q0 == r * nq and k0 == q0 * cfg.n_kv_heads // cfg.n_heads


def test_head_plan_refuses_uneven_groups():
    """Query heads whose kv heads do not map evenly onto a rank's block
    raise, rather than attending with the wrong kv heads."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.dist.sharding import ModelAxis
    from repro_torch.models.transformer import model as tm

    cfg = dataclasses.replace(configs.get_spec("qwen3-32b").reduced, n_heads=6, n_kv_heads=3)
    with pytest.raises(NotImplementedError):
        tm.head_plan(cfg, ModelAxis(None, 2, 0))  # heads 0, 1, 2 read kv heads 0, 0, 1
