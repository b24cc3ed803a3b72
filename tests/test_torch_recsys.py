"""The port's AutoInt serving path against the JAX package, on the CPU.

The reduced AutoInt config (8 fields × 1,000 rows × 8, f32) with the JAX
package's own initialised parameters carried across as numpy arrays, and
the embedding bags that back its lookup. On the CPU the ``embedding_bag``
wrapper takes its plain version. Tolerances: lookups are exact (a one-slot
bag with weight 1 is a copy); forward, query embeddings, retrieval scores
and the bag sums at rtol = atol = 1e-5 (f32, other summation orders);
retrieval ids exactly, on random (tie-free) candidates.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.recsys import autoint as jai  # noqa: E402
from repro.models.recsys import embedding as jemb  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models.recsys import autoint as tai  # noqa: E402
from repro_torch.models.recsys import embedding as temb  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def model():
    cfg = jconfigs.get_spec("autoint").reduced
    tree = jax.tree_util.tree_map(np.asarray, jai.init(jax.random.PRNGKey(3), cfg))
    return (
        cfg,
        jax.tree_util.tree_map(jnp.asarray, tree),
        tai.params_from_arrays(tconfigs.get_spec("autoint").reduced, tree, device="cpu"),
    )


def _fields(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_per_field, (batch, cfg.n_fields)).astype(np.int32)


def test_init_layout_matches(model):
    """The port's own ``init`` gives the JAX tree's structure, shapes and
    dtypes."""
    cfg, jparams, _ = model
    own = tai.init(tconfigs.get_spec("autoint").reduced, seed=0, device="cpu")
    jleaves, jdef = jax.tree_util.tree_flatten(jparams)
    tleaves, tdef = jax.tree_util.tree_flatten(own)
    assert tdef == jdef
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}"


def test_lookup_clips_the_flat_index(model):
    """Out-of-range ids clip the flat ``[F·V, D]`` index, not each field's:
    id V of field f reads row 0 of field f + 1, −1 of field f the last row
    of field f − 1, and past the last field the last row — as in JAX."""
    cfg, jparams, tparams = model
    v = cfg.vocab_per_field
    ids = _fields(cfg, 4, 0)
    ids[0, :4] = [v, -1, 2 * v + 3, -(10**6)]
    ids[1, -1] = 10**7
    ids[2, 3] = v - 1
    want = np.asarray(jai.lookup(jparams, jnp.asarray(ids)))
    got = tai.lookup(tparams, _t(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    tables = np.asarray(jparams["tables"])
    np.testing.assert_array_equal(got.numpy()[0, 0], tables[1, 0])
    np.testing.assert_array_equal(got.numpy()[0, 1], tables[0, v - 1])
    np.testing.assert_array_equal(got.numpy()[1, -1], tables[-1, -1])


def test_forward_and_loss_match(model):
    cfg, jparams, tparams = model
    batch = next(jpipe.recsys_batches(64, cfg.n_fields, cfg.vocab_per_field, seed=5))
    tbatch = {k: _t(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        tai.forward(tparams, tbatch, cfg).numpy(),
        np.asarray(jai.forward(jparams, batch, cfg)), **TOL,
    )
    np.testing.assert_allclose(
        tai.loss_fn(tparams, tbatch, cfg).item(),
        float(jai.loss_fn(jparams, batch, cfg)), **TOL,
    )


def test_query_embedding_and_retrieval_match(model):
    cfg, jparams, tparams = model
    rng = np.random.default_rng(9)
    fields = _fields(cfg, 3, 1)
    cands = rng.normal(size=(5000, cfg.d_attn)).astype(np.float32)
    jbatch = {"fields": jnp.asarray(fields), "candidates": jnp.asarray(cands)}
    tbatch = {"fields": _t(fields), "candidates": _t(cands)}
    np.testing.assert_allclose(
        tai.query_embedding(tparams, tbatch, cfg).numpy(),
        np.asarray(jai.query_embedding(jparams, jbatch, cfg)), **TOL,
    )
    jscores, jids = jai.retrieval_score(jparams, jbatch, cfg, top_k=100)
    tscores, tids = tai.retrieval_score(tparams, tbatch, cfg, top_k=100)
    assert tids.dtype == torch.int32 and tuple(tids.shape) == (3, 100)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), **TOL)


@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "weights"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_modes(mode, masked, weighted):
    """Fixed-width bags, ids out of range included, == the JAX function."""
    rng = np.random.default_rng(10)
    v, d, b, h = 60, 8, 12, 5
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(-3, v + 3, (b, h)).astype(np.int32)
    w = rng.normal(size=(b, h)).astype(np.float32) if weighted else None
    mask = rng.random((b, h)) < 0.7 if masked else None
    if masked:
        mask[0] = False  # an empty bag
    opt = lambda x, f: None if x is None else f(x)  # noqa: E731
    want = jemb.embedding_bag(jnp.asarray(table), jnp.asarray(idx), opt(w, jnp.asarray),
                              opt(mask, jnp.asarray), mode=mode)
    got = temb.embedding_bag(_t(table), _t(idx), opt(w, _t), opt(mask, _t), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("weighted", [False, True], ids=["ones", "weights"])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_ragged_modes(mode, weighted):
    """Ragged bags (sorted bag ids, empty bags, ids out of range) through
    the port's gather + segment_reduce == the JAX function."""
    rng = np.random.default_rng(11)
    v, d, n_bags, t = 40, 6, 10, 50
    table = rng.normal(size=(v, d)).astype(np.float32)
    flat = rng.integers(-2, v + 2, t).astype(np.int32)
    bags = np.sort(rng.integers(0, n_bags, t)).astype(np.int32)
    bags[bags == 4] = 5  # bag 4 empty
    bags = np.sort(bags)
    w = rng.normal(size=t).astype(np.float32) if weighted else None
    want = jemb.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat), jnp.asarray(bags),
                                     n_bags, None if w is None else jnp.asarray(w), mode=mode)
    got = temb.embedding_bag_ragged(_t(table), _t(flat), _t(bags), n_bags,
                                    None if w is None else _t(w), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_recsys_batches_same_draws():
    """One seed gives the JAX generator's batches, as int32/f32 tensors."""
    jit = jpipe.recsys_batches(256, 39, 1_000_000, seed=4)
    tit = tpipe.recsys_batches(256, 39, 1_000_000, seed=4, device="cpu")
    for _ in range(2):
        jb, tb = next(jit), next(tit)
        assert tb["fields"].dtype == torch.int32 and tb["labels"].dtype == torch.float32
        np.testing.assert_array_equal(tb["fields"].numpy(), np.asarray(jb["fields"]))
        np.testing.assert_array_equal(tb["labels"].numpy(), np.asarray(jb["labels"]))


def test_autoint_config_is_the_jax_one():
    j, t = jconfigs.get_spec("autoint"), tconfigs.get_spec("autoint")
    assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)
    assert t.config.d_head == j.config.d_head


def test_entry_points_default_to_the_card():
    """Without ``device=`` the AutoInt path asks for the card, and without
    one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = tconfigs.get_spec("autoint").reduced
    with pytest.raises(RuntimeError, match="cuda"):
        tai.init(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        next(tpipe.recsys_batches(4, cfg.n_fields, cfg.vocab_per_field))
