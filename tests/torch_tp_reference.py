"""The JAX package's LMs on a mesh of 4 fake CPU devices, laid out by its
own shardings: the reference of ``tests/test_torch_tp.py`` (the dense
configs, :data:`ARCHS`) and ``tests/test_torch_tp_moe.py`` (the MoE ones,
:data:`MOE_ARCHS`).

    python tests/torch_tp_reference.py OUT_DIR [ARCH ...]

:func:`make_inputs` (called by the test, in its own process) draws every
input from numpy seeds and the parameters from the JAX initialiser, and
writes them to ``OUT_DIR/inputs.npz``; this script, run with 4 fake
devices, reads them and writes to ``OUT_DIR/jax.npz`` what JAX computes on
``("data", "model") = (1, 4)`` and ``(2, 2)`` for each config named (by
default :data:`ARCHS`), each function jitted under ``param_shardings`` /
``batch_shardings`` / ``lm_cache_spec`` as the JAX dry-run's ``lm_cell``
places it: the loss and its gradients, two trainer steps with the
parameters in ``fsdp`` and in ``zero1`` (the moments in ``fsdp``), and
the shard shape of every live leaf after them, a prefill's logits and KV
cache, and three decode steps on that cache; for an MoE config also the
slots each layer of a forward drops, by data shard (:func:`drop_log`).
``tests/torch_tp_ranks.py`` runs the port on the same inputs over 4 gloo
ranks.
"""

from __future__ import annotations

import contextlib
import os
import sys

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from torch_mesh_reference import flat, unflat  # noqa: E402  (numpy only at import)

#: the reduced dense configs (2 kv heads each: on 4 model ranks the kv
#: heads are held whole, on 2 they are split)
ARCHS = ("h2o-danube-1.8b", "qwen3-32b")
#: the reduced MoE configs (8 experts top-2): deepseek-moe's 4 heads over 4
#: kv heads and a shared expert, qwen3-moe's 8 heads over 2 kv heads
MOE_ARCHS = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
MODES = ("fsdp", "zero1")
BATCH, SEQ = 4, 16
#: the prefill's tokens: past h2o-danube's reduced window of 32, so its
#: ring buffer wraps
PREFILL_SEQ = 40
DECODE_STEPS = 3
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 2, 3e-3, 1


def make_inputs(path, archs=ARCHS):
    """Every input of the reference and of the port's ranks for ``archs``
    (the parameters and batches of each seeded by its place in
    :data:`ARCHS` + :data:`MOE_ARCHS`)."""
    import jax

    from repro import configs
    from repro.data.pipeline import token_batches
    from repro.models.transformer import model as tm

    rng = np.random.default_rng(23)
    out = {}
    for arch in archs:
        i = (ARCHS + MOE_ARCHS).index(arch)
        cfg = configs.get_spec(arch).reduced
        out.update(flat(tm.init(jax.random.PRNGKey(30 + i), cfg), f"{arch}/params"))
        data = token_batches(BATCH, SEQ, cfg.vocab_size, seed=40 + i)
        for step in range(TRAIN_STEPS):
            for k, v in next(data).items():
                out[f"{arch}/batch{step}/{k}"] = np.asarray(v)
        out[f"{arch}/prompt"] = rng.integers(0, cfg.vocab_size, (BATCH, PREFILL_SEQ)).astype(
            np.int32)
        out[f"{arch}/decode"] = rng.integers(0, cfg.vocab_size,
                                             (DECODE_STEPS, BATCH, 1)).astype(np.int32)
    np.savez(path, **out)


def _mesh(shape):
    import jax

    from repro.dist import compat  # noqa: F401  (mesh-API shims)

    return jax.make_mesh(shape, ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)


@contextlib.contextmanager
def drop_log(log):
    """``repro``'s ``moe.dispatch_indices`` wrapped while inside: each call
    of it in a (data, model) shard of ``moe_ffn_ep``'s ``shard_map`` appends
    the slots it drops to ``log[(data index, model index)]``, in call order
    (a host callback, run as each shard's program reaches it)."""
    import jax

    from repro.models.transformer import moe as jmoe

    dispatch = jmoe.dispatch_indices

    def record(d, m, n):
        log.setdefault((int(d), int(m)), []).append(int(n))

    def wrapped(expert_idx, n_experts, cap):
        pos, keep = dispatch(expert_idx, n_experts, cap)
        jax.debug.callback(record, jax.lax.axis_index("data"), jax.lax.axis_index("model"),
                           keep.size - keep.sum())
        return pos, keep

    jmoe.dispatch_indices = wrapped
    try:
        yield log
    finally:
        jmoe.dispatch_indices = dispatch


def run_case(a, res, arch, tag, mesh):
    """Every function of one config on one mesh (see module)."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import configs
    from repro.dist import sharding as shd
    from repro.models.transformer import model as tm
    from repro.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule

    cfg = configs.get_spec(arch).reduced
    key = f"{arch}/{tag}"
    params = jax.tree_util.tree_map(jnp.asarray, unflat(a, f"{arch}/params"))
    batches = [jax.tree_util.tree_map(jnp.asarray, unflat(a, f"{arch}/batch{i}"))
               for i in range(TRAIN_STEPS)]
    oc = AdamWConfig(lr=TRAIN_LR)

    def loss_fn(p, b):
        return tm.loss_fn(p, b, cfg)

    shd.activate(mesh)
    try:
        with mesh:
            pshard = shd.param_shardings("lm", params, mesh)
            bshard = shd.batch_shardings("lm", batches[0], mesh)
            loss, grads = jax.jit(jax.value_and_grad(loss_fn),
                                  in_shardings=(pshard, bshard))(params, batches[0])
            res[f"{key}/loss"] = np.asarray(loss)
            res.update(flat(jax.device_get(grads), f"{key}/grads"))
            if cfg.moe is not None:  # each layer's dropped slots, by data shard
                with drop_log({}) as log:
                    jax.block_until_ready(jax.jit(lambda p, t: tm.forward(p, t, cfg)[0],
                                                  in_shardings=(pshard, bshard["tokens"]))(
                        params, batches[0]["tokens"]))
                n_data, n_model = mesh.devices.shape
                for d in range(n_data):
                    counts = [log[(d, m)] for m in range(n_model)]
                    assert all(c == counts[0] for c in counts), counts
                    assert len(counts[0]) == cfg.n_layers, counts
                res[f"{key}/drops"] = np.asarray([log[(d, 0)] for d in range(n_data)])

            for mode in MODES:
                mshard = shd.param_shardings("lm", params, mesh, mode)
                state_shard = {"params": mshard, "opt": {
                    "m": pshard, "v": pshard, "step": shd.replicated(jnp.zeros(()), mesh)}}

                @functools.partial(jax.jit, in_shardings=(state_shard, bshard),
                                   out_shardings=(state_shard, None))
                def step_fn(state, batch):
                    p, o = state["params"], state["opt"]
                    loss, g = jax.value_and_grad(loss_fn)(p, batch)
                    lr_scale = cosine_schedule(o["step"], warmup=TRAIN_WARMUP, total=TRAIN_STEPS)
                    p, o = adamw_update(g, o, p, oc, lr_scale=lr_scale)
                    return {"params": p, "opt": o}, {"loss": loss}

                state = {"params": params, "opt": adamw_init(params, oc)}
                losses = []
                for b in batches:
                    state, metrics = step_fn(state, b)
                    losses.append(float(metrics["loss"]))
                res[f"{key}/{mode}/losses"] = np.asarray(losses, np.float32)
                res.update(flat(jax.device_get(state["params"]), f"{key}/{mode}/params"))
                for part, tree in (("params", state["params"]), ("m", state["opt"]["m"]),
                                   ("v", state["opt"]["v"])):
                    shapes = jax.tree_util.tree_map(
                        lambda x: np.asarray(x.sharding.shard_shape(x.shape)), tree)
                    res.update(flat(shapes, f"{key}/{mode}/shape/{part}"))

            prompt = jnp.asarray(a[f"{arch}/prompt"])
            c = tm.cache_len(cfg, PREFILL_SEQ)
            cspec = shd.lm_cache_spec(mesh, cfg, BATCH, c)
            cshard = {"k": NamedSharding(mesh, cspec), "v": NamedSharding(mesh, cspec),
                      "length": NamedSharding(mesh, P())}
            tshard = NamedSharding(mesh, shd.lm_batch_spec(mesh, BATCH))
            dp = shd.lm_batch_spec(mesh, BATCH)[0]
            logits, cache = jax.jit(
                lambda p, t: tm.prefill(p, t, cfg), in_shardings=(pshard, tshard),
                out_shardings=(NamedSharding(mesh, P(dp, None, "model")), cshard))(params, prompt)
            res[f"{key}/prefill/logits"] = np.asarray(logits)
            for part in ("k", "v"):
                res[f"{key}/prefill/{part}"] = np.asarray(cache[part])
                res[f"{key}/prefill/{part}_shard_shape"] = np.asarray(
                    cache[part].sharding.shard_shape(cache[part].shape))
            res[f"{key}/prefill/cache_spec"] = np.asarray(str(tuple(cspec)))
            step = jax.jit(lambda p, cch, t: tm.decode_step(p, cch, t, cfg),
                           in_shardings=(pshard, cshard, tshard),
                           out_shardings=(NamedSharding(mesh, P(dp, "model")), cshard))
            for i in range(DECODE_STEPS):
                logits, cache = step(params, cache, jnp.asarray(a[f"{arch}/decode"][i]))
                res[f"{key}/decode{i}"] = np.asarray(logits)
    finally:
        shd.deactivate()


def main(out_dir, archs=ARCHS):
    a = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    res = {}
    for arch in archs:
        for tag, shape in MESHES.items():
            run_case(a, res, arch, tag, _mesh(shape))
    np.savez(os.path.join(out_dir, "jax.npz"), **{k: np.asarray(v) for k, v in res.items()})
    print("REFERENCE_OK")


if __name__ == "__main__":
    main(sys.argv[1], tuple(sys.argv[2:]) or ARCHS)
