"""The port's checkpoint, fault tolerance and supervised trainer against
the JAX package, on the CPU.

* every case of tests/test_checkpoint_ft.py on the port
  (``repro_torch.checkpoint``, ``repro_torch.ft``, the grad compressor);
* the on-disk format both ways: a checkpoint the JAX package wrote (reduced
  models, f32, with AdamW state) restored by the port equal leaf for leaf
  to ``params_from_arrays`` / ``opt_state_from_arrays`` of the same
  arrays, and the port's restored by JAX's ``restore_checkpoint`` into
  JAX's tree, bit-equal; the archive's members and the manifest equal to
  JAX's byte for byte, bf16 leaves included; JAX's own restore of a bf16
  leaf raising ``TypeError`` (a quirk of the reference, ROADMAP §C);
* the supervised trainer (``launch.train.Supervised``) against JAX's
  ``TrainSupervisor`` over JAX's ``step_fn`` (no mesh, as
  tests/test_torch_train.py's ``_jax_losses``) from the same parameters:
  a retry before the first checkpoint (the port's step updates its tensors
  in place, so the replay starts from a host copy), a retry after one, a
  resume, and a preemption; equal retries, restarts, steps and step
  indices, losses within ``LOSS_REL`` (1e-5, tests/test_torch_train.py),
  and the final checkpoints' f32 leaves within ``GRAD_F32`` (1e-4 ·
  max|leaf|, the same file's f32 gradient tolerance: the two packages sum
  in other orders);
* the CLI with ``--inject-failures`` printing JAX's ``done`` line, and the
  ``tiny`` preset of examples/torch_train_lm.py with one injected failure.
"""

import json
import os
import re
import runpy
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro import ft as jft  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.ft import FailureInjector, StragglerMonitor, TrainSupervisor  # noqa: E402
from repro_torch.ft.failures import InjectedFailure  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.gnn import models as tgm  # noqa: E402
from repro_torch.models.recsys import autoint as tai  # noqa: E402
from repro_torch.models.transformer import model as ttm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim.grad_compress import (  # noqa: E402
    compress,
    compress_with_feedback,
    decompress,
    make_compressed_dp_grad_fn,
)

ROOT = Path(__file__).resolve().parent.parent
LOSS_REL, GRAD_F32 = 1e-5, 1e-4


def _np(x) -> np.ndarray:
    """A leaf's values as numpy (bf16 as its bit pattern)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    arr = np.asarray(x)
    return arr.view(np.int16) if arr.dtype.name == "bfloat16" else arr


def _leaves(tree):
    return dict(tck.checkpoint._flatten(tree))


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert list(got) == list(want)
    for k in want:
        g, w = _np(got[k]), _np(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# -- tests/test_checkpoint_ft.py on the port ------------------------------------


def small_state():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)},
        "opt": {"m": torch.zeros(3, 4), "step": torch.tensor(7, dtype=torch.int32)},
    }


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        state = small_state()
        tck.save_checkpoint(tmp_path, 3, state)
        restored, step, _ = tck.restore_checkpoint(tmp_path, state)
        assert step == 3
        _assert_trees_equal(restored, state)

    def test_latest_step_picks_newest_complete(self, tmp_path):
        state = small_state()
        tck.save_checkpoint(tmp_path, 1, state)
        tck.save_checkpoint(tmp_path, 5, state)
        os.makedirs(tmp_path / "step_00000009.tmp")  # a torn write is ignored
        assert tck.latest_step(tmp_path) == 5

    def test_async_checkpointer(self, tmp_path):
        ck = tck.AsyncCheckpointer(tmp_path, keep=2)
        state = small_state()
        for s in (1, 2, 3):
            ck.save(s, state)
        ck.wait()
        assert tck.latest_step(tmp_path) == 3
        assert not (tmp_path / "step_00000001").exists()  # gc kept the last two

    def test_async_snapshot_is_whole_when_save_returns(self, tmp_path):
        """The tensors may be updated in place right after ``save``: the
        checkpoint holds the values at the call (the trainer's step
        updates its state in place)."""
        ck = tck.AsyncCheckpointer(tmp_path)
        state = small_state()
        ck.save(1, state)
        state["params"]["w"].add_(100.0)
        ck.wait()
        restored, _, _ = tck.restore_checkpoint(tmp_path, state)
        _assert_trees_equal(restored["params"]["w"], small_state()["params"]["w"])

    def test_elastic_restore_across_mesh_shapes(self, tmp_path):
        """Save, restore under a one-rank mesh, and with no mesh."""
        mesh1 = make_mesh((1,), ("data",), device="cpu")
        state = {"w": torch.arange(16.0).reshape(4, 4)}
        tck.save_checkpoint(tmp_path, 1, state)
        restored, _, _ = tck.restore_checkpoint(tmp_path, state, mesh=mesh1)
        _assert_trees_equal(restored, state)
        restored2, _, _ = tck.restore_checkpoint(tmp_path, state)
        _assert_trees_equal(restored2, state)


class TestSupervisor:
    def _setup(self, tmp_path, fail_at=()):
        calls = {"n": 0}

        def step_fn(state, batch):
            calls["n"] += 1
            new = {"x": state["x"] + batch, "step": state["step"] + 1}
            return new, {"loss": float(new["x"][0])}

        sup = TrainSupervisor(
            step_fn,
            batch_for_step=lambda i: torch.ones(2) * (i + 1),
            ckpt_dir=str(tmp_path),
            ckpt_every=2,
            injector=FailureInjector(list(fail_at)),
        )
        init = {"x": torch.zeros(2), "step": torch.tensor(0)}
        return sup, init, calls

    def test_clean_run(self, tmp_path):
        sup, init, _ = self._setup(tmp_path)
        state, step, _ = sup.run(init, 6)
        assert step == 6 and float(state["x"][0]) == 21.0

    def test_recovers_from_injected_failure(self, tmp_path):
        sup, init, _ = self._setup(tmp_path, fail_at=[3])
        state, step, _ = sup.run(init, 6)
        assert step == 6 and sup.retries == 1 and float(state["x"][0]) == 21.0

    def test_resume_from_checkpoint(self, tmp_path):
        sup, init, _ = self._setup(tmp_path)
        sup.run(init, 4)
        sup2, init2, calls2 = self._setup(tmp_path)
        state, step, _ = sup2.run(init2, 6)
        assert step == 6 and sup2.restarts == 1
        assert calls2["n"] == 2 and float(state["x"][0]) == 21.0

    def test_exhausted_retries_raise(self, tmp_path):
        sup, init, _ = self._setup(tmp_path, fail_at=[0])
        sup.max_retries = 0
        with pytest.raises(InjectedFailure):
            sup.run(init, 3)


class TestStraggler:
    def test_detection(self):
        mon = StragglerMonitor(factor=2.0, warmup=1)
        assert not mon.observe(0, 1.0)
        assert not mon.observe(1, 1.1)
        assert mon.observe(2, 5.0)
        assert len(mon.events) == 1 and mon.ema < 1.5


class TestGradCompression:
    def test_roundtrip_error_bounded(self):
        g = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 64)))
        q, s = compress(g)
        assert float((decompress(q, s) - g).abs().max()) <= float(s) * 0.5 + 1e-6

    def test_error_feedback_accumulates(self):
        g = torch.from_numpy(np.random.default_rng(1).normal(size=(32,)) * 1e-3).float()
        res, total = torch.zeros(32), torch.zeros(32)
        for _ in range(50):
            q, s, res = compress_with_feedback(g, res)
            total = total + decompress(q, s)
        np.testing.assert_allclose((total / 50).numpy(), g.numpy(), rtol=0.3, atol=2e-4)

    def test_compressed_dp_matches_exact_mean(self):
        mesh = make_mesh((1,), ("data",), device="cpu")

        def loss_fn(p, b):
            return ((b @ p["w"]) ** 2).mean()

        params = {"w": torch.from_numpy(np.random.default_rng(2).normal(size=(4, 3)))
                  .float().requires_grad_(True)}
        batch = torch.from_numpy(np.random.default_rng(3).normal(size=(8, 4))).float()
        fn = make_compressed_dp_grad_fn(loss_fn, mesh)
        _, grads, _ = fn(params, batch, {"w": torch.zeros(4, 3)})
        (exact,) = torch.autograd.grad(loss_fn(params, batch), params["w"])
        atol = float(exact.abs().max()) / 254 + 1e-6
        np.testing.assert_allclose(grads["w"].numpy(), exact.numpy(), rtol=0.05, atol=atol)


# -- the on-disk format, both ways -------------------------------------------------

FORMAT_ARCHS = ["h2o-danube-1.8b", "deepseek-moe-16b", "gat-cora", "pna", "autoint"]


def _convert(arch):
    spec = tconfigs.get_spec(arch)
    cfg = spec.reduced
    fn = {"lm": ttm.params_from_arrays, "gnn": tgm.params_from_arrays,
          "recsys": tai.params_from_arrays}[spec.family]
    return lambda tree: fn(cfg, tree, "cpu")


def _jax_state(arch, state_dtype=None):
    """JAX's reduced parameters and one AdamW step's state (nonzero
    moments), each leaf a numpy array."""
    _, _, jp, _, _ = jtrain.build(arch, True, 2, 8, 0)
    oc = jadamw.AdamWConfig(state_dtype=state_dtype)
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype), jp)
    jp, jo = jadamw.adamw_update(grads, jadamw.adamw_init(jp, oc), jp, oc)
    return jax.tree_util.tree_map(np.asarray, {"params": jp, "opt": jo})


def _port_state(arch, jstate):
    """The same state carried across to the port, in the JAX nesting."""
    convert = _convert(arch)
    params = convert(jstate["params"])
    opt = tadamw.opt_state_from_arrays(convert, jstate["opt"])
    return ttrain.state_tree(params, opt)


@pytest.mark.parametrize("arch", FORMAT_ARCHS)
def test_port_restores_jax_checkpoint(arch, tmp_path):
    """A checkpoint written by the JAX package, restored by the port into
    the JAX nesting of its own state: equal leaf for leaf (bit for bit) to
    ``params_from_arrays`` / ``opt_state_from_arrays`` of the arrays."""
    jstate = _jax_state(arch)
    jck.save_checkpoint(tmp_path, 1, jstate)
    want = _port_state(arch, jstate)
    target = ttrain.host_copy(tck.checkpoint.tree_map(torch.zeros_like, want))
    restored, step, _ = tck.restore_checkpoint(tmp_path, target)
    assert step == 1
    _assert_trees_equal(restored, want)


@pytest.mark.parametrize("arch", FORMAT_ARCHS)
def test_jax_restores_port_checkpoint(arch, tmp_path):
    """The port's checkpoint, restored by JAX's ``restore_checkpoint`` into
    JAX's tree: bit-equal to the arrays the port's state came from; the
    manifest and every archive member byte-equal to JAX's own save."""
    jstate = _jax_state(arch)
    tck.save_checkpoint(tmp_path / "port", 2, _port_state(arch, jstate), {"note": 1})
    restored, step, extra = jck.restore_checkpoint(tmp_path / "port", jstate)
    assert step == 2 and extra == {"note": 1}
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, restored), jstate)
    jck.save_checkpoint(tmp_path / "jax", 2, jstate, {"note": 1})
    _assert_same_files(tmp_path / "port" / "step_00000002", tmp_path / "jax" / "step_00000002")


def _assert_same_files(got_dir, want_dir):
    assert json.loads((got_dir / "manifest.json").read_text()) == json.loads(
        (want_dir / "manifest.json").read_text())
    with zipfile.ZipFile(got_dir / "arrays.npz") as g, \
            zipfile.ZipFile(want_dir / "arrays.npz") as w:
        assert g.namelist() == w.namelist()
        for name in w.namelist():
            assert g.read(name) == w.read(name), name


def test_bf16_leaves_written_as_jax_writes_them(tmp_path):
    """bf16 moments (``state_dtype="bfloat16"``) and a bf16 parameter: the
    port's archive members and manifest byte-equal to JAX's (the 2-byte
    patterns under a '<V2' header, "bfloat16" in the manifest), and the
    port reads JAX's file back bit for bit by the manifest's dtype."""
    jstate = _jax_state("h2o-danube-1.8b", state_dtype="bfloat16")
    jstate["params"]["ln_f"] = np.asarray(jnp.asarray(jstate["params"]["ln_f"], jnp.bfloat16))
    assert np.asarray(jstate["opt"]["m"]["embed"]).dtype.name == "bfloat16"
    tstate = tck.checkpoint.tree_map(lambda a: torch.from_numpy(_np(a).copy()).view(
        torch.bfloat16) if np.asarray(a).dtype.name == "bfloat16" else torch.from_numpy(
        np.array(a)), jstate)
    tck.save_checkpoint(tmp_path / "port", 1, tstate)
    jck.save_checkpoint(tmp_path / "jax", 1, jstate)
    _assert_same_files(tmp_path / "port" / "step_00000001", tmp_path / "jax" / "step_00000001")
    restored, _, _ = tck.restore_checkpoint(tmp_path / "jax", tstate)
    assert restored["opt"]["m"]["embed"].dtype == torch.bfloat16
    _assert_trees_equal(restored, tstate)


def test_jax_cannot_restore_its_own_bf16_leaf(tmp_path):
    """Quirk of the reference (ROADMAP §C): ``repro.checkpoint`` writes a
    bf16 leaf as a 2-byte void and its restore rejects it. If this starts
    passing through, revisit the note."""
    tree = {"w": jnp.ones((2, 3), jnp.bfloat16)}
    jck.save_checkpoint(tmp_path, 1, tree)
    with pytest.raises(TypeError, match="V2"):
        jck.restore_checkpoint(tmp_path, tree)


# -- the supervised trainer against JAX's TrainSupervisor ---------------------------

ARCH, BATCH, SEQ, WARMUP, TOTAL = "h2o-danube-1.8b", 2, 24, 2, 5


@pytest.fixture(scope="module")
def jax_job():
    """JAX's ``build`` of the reduced LM and its jitted ``step_fn`` (the
    JAX trainer's, without the mesh), compiled once for the module."""
    _, _, jparams, loss_fn, batch_for_step = jtrain.build(ARCH, True, BATCH, SEQ, 0)
    oc = jadamw.AdamWConfig(lr=3e-4)

    @jax.jit
    def step_fn(state, batch):
        p, o = state["params"], state["opt"]
        loss, g = jax.value_and_grad(loss_fn)(p, batch)
        lr_scale = jschedule.cosine_schedule(o["step"], warmup=WARMUP, total=TOTAL)
        p, o = jadamw.adamw_update(g, o, p, oc, lr_scale=lr_scale)
        return {"params": p, "opt": o}, {"loss": loss}

    return jparams, oc, step_fn, batch_for_step


def _jax_supervised(job, ckpt_dir, n_steps, fail_at=(), ckpt_every=50, preempt_at=None):
    jparams, oc, step_fn, batch_for_step = job
    losses = []
    sup = None

    def wrapped(state, batch):
        i = int(state["opt"]["step"])
        new, metrics = step_fn(state, batch)
        losses.append((i, float(metrics["loss"])))
        if i == preempt_at:
            sup._preempted = True
        return new, metrics

    sup = jft.TrainSupervisor(wrapped, batch_for_step, ckpt_dir=str(ckpt_dir),
                              ckpt_every=ckpt_every,
                              injector=jft.FailureInjector(list(fail_at)))
    init = {"params": jparams, "opt": jadamw.adamw_init(jparams, oc)}
    code = None
    try:
        _, step, _ = sup.run(init, n_steps)
    except SystemExit as e:
        step, code = None, e.code
    return sup, step, losses, code


def _port_supervised(job, ckpt_dir, n_steps, fail_at=(), ckpt_every=50, preempt_at=None):
    jparams = job[0]
    spec, _, p, loss_fn, bfs = ttrain.build(ARCH, True, BATCH, SEQ, 0, "cpu",
                                            jax.tree_util.tree_map(np.asarray, jparams))
    run = ttrain.Supervised(spec.family, p, loss_fn, bfs, tadamw.AdamWConfig(lr=3e-4),
                            warmup=WARMUP, total=TOTAL, ckpt_dir=str(ckpt_dir),
                            ckpt_every=ckpt_every, inject_failures=fail_at, device="cpu",
                            log=lambda line: None)
    if preempt_at is not None:
        step_fn = run.sup.step_fn

        def preempting(state, batch):
            i = int(state["opt"]["step"])
            out = step_fn(state, batch)
            if i == preempt_at:
                run.sup._preempted = True
            return out

        run.sup.step_fn = preempting
    code = None
    try:
        step, _ = run.run(n_steps)
    except SystemExit as e:
        step, code = None, e.code
    return run.sup, step, run.losses, code


def _assert_final_checkpoints_close(port_dir, jax_dir):
    step = jck.latest_step(jax_dir)
    assert tck.latest_step(port_dir) == step
    got_dir, want_dir = (Path(d) / f"step_{step:08d}" for d in (port_dir, jax_dir))
    got_m = json.loads((got_dir / "manifest.json").read_text())
    want_m = json.loads((want_dir / "manifest.json").read_text())
    assert got_m == want_m | {"keys": got_m["keys"]}  # step and extra
    assert got_m["keys"] == want_m["keys"]
    with np.load(got_dir / "arrays.npz") as g, np.load(want_dir / "arrays.npz") as w:
        for key in w.files:
            want, got = w[key], g[key]
            if want.dtype == np.float32:
                atol = GRAD_F32 * max(float(np.abs(want).max()), 1e-30)
                np.testing.assert_allclose(got, want, rtol=GRAD_F32, atol=atol, err_msg=key)
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)


SCENARIOS = {
    # (runs of (n_steps, fail_at, ckpt_every, preempt_at)), expected (retries, restarts)
    "retry_before_first_checkpoint": ([(4, [1], 50, None)], (1, 0)),
    "retry_after_checkpoint": ([(5, [3], 2, None)], (1, 0)),
    "resume": ([(3, [], 2, None), (5, [], 2, None)], (0, 1)),
    "preemption": ([(5, [], 50, 2)], (0, 0)),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_supervised_trainer_matches_jax(scenario, jax_job, tmp_path):
    """The port's supervised run and JAX's ``TrainSupervisor`` over the same
    reduced LM, parameters and batches: equal retries, restarts, final step
    (or exit code 143 and the step saved with ``{"preempted": true}``), the
    same step indices run in the same order (replays included), losses
    within ``LOSS_REL``, and the final checkpoints' f32 leaves within
    ``GRAD_F32`` of JAX's."""
    runs, (retries, restarts) = SCENARIOS[scenario]
    for n_steps, fail_at, every, preempt in runs:
        want = _jax_supervised(jax_job, tmp_path / "jax", n_steps, fail_at, every, preempt)
        got = _port_supervised(jax_job, tmp_path / "port", n_steps, fail_at, every, preempt)
        (jsup, jstep, jlosses, jcode), (tsup, tstep, tlosses, tcode) = want, got
        assert (tsup.retries, tsup.restarts, tstep, tcode) == (
            jsup.retries, jsup.restarts, jstep, jcode)
        assert [i for i, _ in tlosses] == [i for i, _ in jlosses]
        np.testing.assert_allclose([x for _, x in tlosses], [x for _, x in jlosses],
                                   rtol=LOSS_REL)
    assert (tsup.retries, tsup.restarts) == (retries, restarts)
    if scenario == "preemption":
        assert tcode == 143
        manifest = json.loads((tmp_path / "port" / "step_00000003" / "manifest.json")
                              .read_text())
        assert manifest["extra"] == {"preempted": True}
    elif scenario == "retry_before_first_checkpoint":
        assert [i for i, _ in tlosses] == [0, 0, 1, 2, 3]
        assert tlosses[0][1] == tlosses[1][1]  # the replay starts from the initial state
    _assert_final_checkpoints_close(tmp_path / "port", tmp_path / "jax")


def test_supervised_cli_prints_jax_done_line(tmp_path, capsys, monkeypatch):
    """``--inject-failures`` through both CLIs on the same flags: the
    port's ``done`` line is JAX's apart from the loss (the parameters are
    each package's own random draws); one retry, no restart."""
    flags = ["--arch", "autoint", "--reduced", "--steps", "4", "--batch", "8",
             "--log-every", "2", "--ckpt-every", "2", "--inject-failures", "3"]
    ttrain.main(flags + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train"] + flags + ["--ckpt-dir", str(tmp_path / "jax")])
    jtrain.main()
    want = capsys.readouterr().out.splitlines()
    pattern = r"done at step 4: loss=\d+\.\d{4} retries=1 restarts=0 stragglers=\d+"
    assert re.fullmatch(pattern, got[-1]) and re.fullmatch(pattern, want[-1]), (got, want)
    assert [line.split()[:2] for line in got[:-1]] == [line.split()[:2] for line in want[:-1]]
    assert tck.latest_step(tmp_path / "port") == jck.latest_step(tmp_path / "jax") == 4


def test_example_tiny_preset_recovers(tmp_path, capsys):
    """examples/torch_train_lm.py, preset ``tiny``, on the CPU for a few
    steps with one injected failure (before its first checkpoint): the
    loss comes down and the run reports one retry."""
    example = runpy.run_path(str(ROOT / "examples" / "torch_train_lm.py"))
    example["main"](["--preset", "tiny", "--steps", "24", "--batch", "2", "--seq", "32",
                     "--device", "cpu", "--ckpt-dir", str(tmp_path),
                     "--inject-failures", "5"])
    out = capsys.readouterr().out
    assert "retries=1 restarts=0" in out and "converging" in out
    assert tck.latest_step(tmp_path) == 24


# -- the archive reader and the card's drill, rehearsed ------------------------------


def test_reader_checks_crc_and_reads_numpy_archives(tmp_path):
    """The restore's archive reader: a CRC-32 over chunks read in threads
    equals zlib's over the whole; a flipped byte in a member's data raises
    ``BadZipFile`` as ``np.load`` does; a compressed ``np.savez`` archive
    (read through ``numpy.lib.format``) gives ``np.load``'s arrays."""
    import zlib

    from repro_torch.checkpoint.checkpoint import _crc32, _NpzReader

    buf = np.random.default_rng(0).integers(0, 256, (200 << 20) + 7, dtype=np.uint8)
    assert _crc32(memoryview(buf), 12345) == zlib.crc32(buf, 12345)
    state = {"w": torch.arange(12.0).reshape(3, 4), "s": torch.tensor(3, dtype=torch.int32)}
    path = tck.save_checkpoint(tmp_path, 1, state) / "arrays.npz"
    raw = bytearray(path.read_bytes())
    raw[raw.find(np.float32(11.0).tobytes())] ^= 1
    path.write_bytes(bytes(raw))
    with pytest.raises(zipfile.BadZipFile), _NpzReader(path) as data:
        data["w"]
    packed = tmp_path / "packed.npz"
    np.savez_compressed(packed, a=np.arange(10.0), b=np.ones((2, 3), np.int32))
    with _NpzReader(packed) as data, np.load(packed) as want:
        for key in ("a", "b"):
            np.testing.assert_array_equal(data[key], want[key])


def _chip_smoke():
    """``chip_smoke.py`` at the root of the repo, imported as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_drill_keys_are_jax_paths():
    """The card's drill holds its checkpoint's keys to ``H2O_JAX_PATHS``:
    the paths of JAX's parameter tree for h2o-danube-1.8b's full config."""
    cfg = jtrain.configs.get_spec("h2o-danube-1.8b").config
    flat = jax.tree_util.tree_flatten_with_path(jtrain.tm.abstract_params(cfg))[0]
    paths = ["/".join(str(k.key) for k in kp) for kp, _ in flat]
    assert tuple(paths) == _chip_smoke().H2O_JAX_PATHS


def test_drill_rehearsal_on_the_cpu(capsys):
    """``chip_smoke.ckpt_drill`` at the reduced size on the CPU: the run
    stopped at step 3 and the one restored, failed and replayed to step 6
    give the uninterrupted run's losses and state bit for bit."""
    _chip_smoke().ckpt_drill(0, torch.device("cpu"), "cpu", reduced=True)
    lines = {line.split(" ", 1)[0]: json.loads(line.split(" ", 1)[1])
             for line in capsys.readouterr().out.splitlines() if line.startswith("ckpt")}
    drill = lines["ckpt_drill"]
    assert drill["bit_equal"] and drill["runs"]["B"]["retries"] == 1
    assert drill["runs"]["B"]["restarts"] == 1 and drill["runs"]["A"]["step"] == 3
    assert drill["runs"]["B"]["losses"] == [drill["reference_losses"][i] for i in (3, 3, 4, 5)]
    assert len(lines["ckpt"]["restore_s"]) == 2
