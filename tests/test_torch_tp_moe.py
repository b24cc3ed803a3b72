"""The port's MoE LMs tensor- and sequence-parallel over the mesh's ``model``
axis, their routed experts expert-parallel, held to the JAX package's under
the same mesh, on the CPU.

The reduced deepseek-moe-16b (4 heads over 4 kv heads, 8 experts top-2, a
shared expert) and qwen3-moe-235b-a22b (8 heads over 2 kv heads: held whole
on ``(data, model) = (1, 4)``, split on ``(2, 2)``; no shared expert), in
float32, through ``tests/test_torch_tp.py``'s pair of subprocesses
(:func:`test_torch_tp.run_pair`: JAX on 4 fake devices jitted under its own
shardings, the port on 4 gloo ranks holding their shards and their data
shard's rows) and its checks:

* the loss within ``TOL`` and every gradient within ``GRAD_F32`` ·
  max|g|, gathered whole — the shared experts' column and row blocks, the
  routed experts' stacks, the router summed over the ranks;
* two trainer steps in ``fsdp`` and in ``zero1``, the parameters after
  them within ``TOL``, and each rank's live parameter and moment shapes
  JAX's shard shapes (attention, shared-expert and expert leaves among
  them);
* a rank's logits ``[B/data, S, V/m]``; ``Supervised`` on the mesh and its
  checkpoint;
* a prefill (each rank's cache JAX's ``C/m``-slot shard) and three decode
  steps within ``TOL``.

And of the MoE layers: the slots every layer of a forward drops equal to
JAX's, data shard by data shard, and every model rank of a data shard
routing its tokens bit for bit alike (the expert ids and kept slots of
every layer: what ``moe._own_rows`` relies on); and a config whose
experts the model axis does not divide, against one rank.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_tp as tp  # noqa: E402
import torch_tp_reference as ref  # noqa: E402

CASES = [(arch, tag) for arch in ref.MOE_ARCHS for tag in ref.MESHES]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """``(jax, port)`` result dicts of the two subprocesses."""
    return tp.run_pair(tmp_path_factory.mktemp("tp_moe"), ref.MOE_ARCHS, timeout=600)


@pytest.mark.parametrize("arch,tag", CASES)
def test_loss_and_gradients(results, arch, tag):
    """The loss and every gradient, the MoE leaves among them, as
    :func:`test_torch_tp.test_loss_and_gradients` holds them."""
    keys = [k for k in results[0] if k.startswith(f"{arch}/{tag}/grads/")]
    assert any("/moe/w1" in k for k in keys) and any("/moe/router" in k for k in keys)
    if arch == "deepseek-moe-16b":
        assert any("/moe/shared/w2" in k for k in keys)
    tp.test_loss_and_gradients(results, arch, tag)


@pytest.mark.parametrize("mode", ref.MODES)
@pytest.mark.parametrize("arch,tag", CASES)
def test_train_steps(results, arch, tag, mode):
    """Two ``make_step`` steps against JAX's ``step_fn`` under the same
    placement (:func:`test_torch_tp.test_train_steps`)."""
    tp.test_train_steps(results, arch, tag, mode)


@pytest.mark.parametrize("mode", ref.MODES)
@pytest.mark.parametrize("arch,tag", CASES)
def test_live_shard_shapes(results, arch, tag, mode):
    """Every rank's live parameter and moment shards have JAX's shard
    shapes (:func:`test_torch_tp.test_live_shard_shapes`); the attention,
    shared-expert and expert leaves are split over ``model`` as JAX's rules
    split them."""
    tp.test_live_shard_shapes(results, arch, tag, mode)
    jax_res = results[0]
    n_model = ref.MESHES[tag][1]
    shape = {k.rsplit("/shape/params/", 1)[1]: tuple(v) for k, v in jax_res.items()
             if k.startswith(f"{arch}/{tag}/{mode}/shape/params/")}
    whole = {k.rsplit("/params/", 1)[1]: v.shape for k, v in jax_res.items()
             if k.startswith(f"{arch}/{tag}/{mode}/params/")}
    assert shape["layers/wq"][-1] * n_model == whole["layers/wq"][-1]
    assert shape["layers/moe/w1"][1] * n_model == whole["layers/moe/w1"][1]
    if arch == "deepseek-moe-16b":
        assert shape["layers/moe/shared/w1"][-1] * n_model == whole["layers/moe/shared/w1"][-1]
        assert shape["layers/moe/shared/w2"][1] * n_model == whole["layers/moe/shared/w2"][1]


@pytest.mark.parametrize("arch,tag", CASES)
def test_logits_are_the_ranks_vocabulary_block(results, arch, tag):
    """A rank's logits are ``[B / data, S, V / model]``."""
    tp.test_logits_are_the_ranks_vocabulary_block(results, arch, tag)


@pytest.mark.parametrize("arch,tag", CASES)
def test_supervised_checkpoint_of_the_shards(results, arch, tag):
    """``launch.train.Supervised`` on the mesh: JAX's losses, and its
    checkpoint JAX's parameters with specs naming ``model``."""
    tp.test_supervised_checkpoint_of_the_shards(results, arch, tag)


@pytest.mark.parametrize("arch,tag", CASES)
def test_prefill(results, arch, tag):
    """The prefill's logits, and each rank's cache JAX's ``C/m``-slot shard
    of it (:func:`test_torch_tp.test_prefill`)."""
    tp.test_prefill(results, arch, tag)


@pytest.mark.parametrize("arch,tag", CASES)
def test_decode_steps(results, arch, tag):
    """Three decode steps on the rank's slots (:func:`test_torch_tp.
    test_decode_steps`)."""
    tp.test_decode_steps(results, arch, tag)


@pytest.mark.parametrize("arch,tag", CASES)
def test_drop_counts_per_layer(results, arch, tag):
    """The slots each layer of a forward drops on every rank equal JAX's
    for the rank's data shard (capacity is per data shard); the configs
    drop some."""
    jax_res, port = results
    want = jax_res[f"{arch}/{tag}/drops"]  # [data shards, layers]
    assert want.sum() > 0
    for rank in range(4):
        d = int(port[f"{arch}/{tag}/coordinate/{rank}"][0])
        np.testing.assert_array_equal(port[f"{arch}/{tag}/drops/{rank}"], want[d],
                                      err_msg=f"rank {rank}")


@pytest.mark.parametrize("arch,tag", CASES)
def test_model_ranks_route_alike(results, arch, tag):
    """Every model rank of a data shard routes its tokens bit for bit alike
    at every layer — the expert ids and the kept slots — as the EP
    combine's exchange of rows assumes; the data shards route their own."""
    port = results[1]
    by_data = {}
    for rank in range(4):
        d = int(port[f"{arch}/{tag}/coordinate/{rank}"][0])
        by_data.setdefault(d, []).append(port[f"{arch}/{tag}/routes/{rank}"])
    assert len(by_data) == ref.MESHES[tag][0]
    for d, routes in by_data.items():
        assert len(routes) == ref.MESHES[tag][1]
        for r in routes[1:]:
            np.testing.assert_array_equal(r, routes[0], err_msg=f"data shard {d}")


@pytest.mark.parametrize("arch", ref.MOE_ARCHS)
def test_experts_the_axis_does_not_divide(results, arch):
    """6 experts on (1, 4), which ``moe_ffn_ep`` cannot split: every rank
    runs the routed FFN whole (JAX's ``_moe_ffn_local``) with its gradient
    counted once, the rest tensor-parallel; the loss and every gradient
    within ``TOL`` / ``GRAD_F32`` of the same config on one rank."""
    port = results[1]
    assert int(port[f"{arch}/fallback/expert_parallel_calls"]) == 0
    want, got = port[f"{arch}/fallback/loss"]
    tp._close(got, want, "loss")
    assert float(port[f"{arch}/fallback/grad_rel"]) <= tp.GRAD_F32
