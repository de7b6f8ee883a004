"""The port's Algorithm 2 (asymptotic ensemble learning, Sec. 9) against the
reference package's, on synthetic HIGGS-like data at the reference's
fixture size (20,000 records, K = 20).

Each reference test of ``tests/test_ensemble.py`` has its counterpart on
host tensors.  JAX's threefry keys cannot be drawn in PyTorch, so the
side-by-side tests carry the reference's initial weights across with
``params_from_numpy`` (a test-side learner hands them out in the order the
reference's loop draws them) and then hold:

* ``fit`` of logreg and of the MLP, and the stacked trainer: within the
  reference's own vmap-vs-solo tolerance, rtol 2e-3 and atol 2e-4;
* ``Ensemble.predict_proba`` given the same stacked parameters: 1e-6;
* ``asymptotic_ensemble_learn`` and ``ds.ensemble``: the same blocks and
  ``blocks_used``, and accuracies equal except for evaluation points whose
  top-two probability margin is below 1e-5 (and one float32 rounding of
  the reference's mean: the port counts exactly).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rsp as ref_rsp
from repro.core import ensemble as ref_ens
from repro_torch import rsp
from repro_torch.core import (
    Ensemble,
    RSPSpec,
    RSPStore,
    asymptotic_ensemble_learn,
    ensemble_vs_single_model,
    make_logreg,
    make_mlp,
    params_from_numpy,
    train_base_models_vmapped,
    two_stage_partition_np,
)
from repro_torch.data import make_higgs_like

RTOL, ATOL = 2e-3, 2e-4     # tests/test_ensemble.py's vmap-vs-solo tolerance
PROBA_TOL = 1e-6
MARGIN = 1e-5


@pytest.fixture(scope="module")
def higgs():
    N, Ne, K = 20000, 4000, 20
    x, y = make_higgs_like(N + Ne, seed=2, class_sep=1.5)
    xe, ye = x[N:], y[N:]
    data = np.concatenate([x[:N], y[:N, None].astype(np.float32)], axis=1)
    spec = RSPSpec(num_records=N, num_blocks=K, num_original_blocks=K, seed=5)
    blocks = two_stage_partition_np(data, spec)
    return blocks[:, :, :-1].copy(), blocks[:, :, -1].astype(np.int32), xe, ye


def _t(higgs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in higgs)


def _close(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


def _numpy(params) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# The reference's tests, on host tensors
# ---------------------------------------------------------------------------

def test_vmapped_base_models_match_sequential(higgs):
    bx, by, xe, ye = _t(higgs)
    learner = make_logreg(bx.shape[-1], 2, steps=50, lr=0.5)
    stacked = train_base_models_vmapped(learner, torch.Generator().manual_seed(0), bx[:3], by[:3])
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        solo = learner.fit(learner.init(gen), bx[i], by[i])
        _close({k: v[i] for k, v in stacked.items()}, solo)


def test_ensemble_accuracy_plateaus(higgs):
    bx, by, xe, ye = _t(higgs)
    learner = make_logreg(bx.shape[-1], 2, steps=150, lr=0.5)
    ens, hist = asymptotic_ensemble_learn(
        bx, by, learner=learner, eval_x=xe, eval_y=ye, g=4, seed=0
    )
    assert len(hist.accuracy) >= 2
    assert hist.accuracy[-1] > 0.70  # far above chance
    # termination before exhausting all blocks (plateau detected), Fig 6
    assert ens.num_models <= bx.shape[0]


def test_ensemble_matches_single_full_data_model(higgs):
    """Paper's central Fig-6 claim: block ensemble ~ single full-data model."""
    bx, by, xe, ye = _t(higgs)
    learner = make_logreg(bx.shape[-1], 2, steps=150, lr=0.5)
    ens_acc, single_acc = ensemble_vs_single_model(bx, by, xe, ye, learner=learner, seed=0)
    assert ens_acc >= single_acc - 0.01  # equivalent within 1 pt


def test_ensemble_beats_single_block_model(higgs):
    bx, by, xe, ye = _t(higgs)
    learner = make_mlp(bx.shape[-1], 2, hidden=16, steps=150, lr=0.05)
    ens, hist = asymptotic_ensemble_learn(
        bx, by, learner=learner, eval_x=xe, eval_y=ye, g=4, seed=1, max_batches=2
    )
    params = learner.fit(learner.init(torch.Generator().manual_seed(9)), bx[0], by[0])
    single_block_acc = float(
        (torch.argmax(learner.predict_proba(params, xe), -1) == ye).float().mean()
    )
    assert ens.accuracy(xe, ye) >= single_block_acc - 0.02


def test_ensemble_history_monotone_blocks(higgs):
    bx, by, xe, ye = _t(higgs)
    learner = make_logreg(bx.shape[-1], 2, steps=50, lr=0.5)
    _, hist = asymptotic_ensemble_learn(
        bx, by, learner=learner, eval_x=xe, eval_y=ye, g=3, seed=2, max_batches=3
    )
    assert hist.blocks_used == sorted(hist.blocks_used)
    assert all(b % 3 == 0 for b in hist.blocks_used)


def test_store_backed_ensemble_reads_only_sampled_blocks(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(1024, 5)).astype(np.float32)
    data[:, -1] = (rng.random(1024) < 0.5).astype(np.float32)
    rsp.partition(data, blocks=8, seed=2, backend="np", num_classes=2,
                  device="cpu").save(str(tmp_path / "s"))
    ds = rsp.open(str(tmp_path / "s"), device="cpu")
    loaded: set[int] = set()
    orig = RSPStore.load_block

    def spying(self, block_id, **kw):
        loaded.add(block_id)
        return orig(self, block_id, **kw)

    monkeypatch.setattr(RSPStore, "load_block", spying)
    learner = rsp.make_logreg(data.shape[1] - 1, 2, steps=20)
    ens, _ = ds.ensemble(
        learner, eval_x=data[:64, :-1], eval_y=data[:64, -1].astype(np.int32),
        g=3, batches=1, seed=0,
    )
    assert len(loaded) == 3  # one batch of g blocks, nothing else
    assert ens.params["w"].shape == (3, 4, 2)


def test_ensemble_needs_num_classes():
    ds = rsp.partition(np.zeros((64, 3), np.float32), blocks=4, backend="np", device="cpu")
    with pytest.raises(ValueError, match="num_classes"):
        ds.ensemble(make_logreg(2, 2), eval_x=np.zeros((4, 2)), eval_y=np.zeros(4))
    with pytest.raises(ValueError, match="fetch_blocks"):
        asymptotic_ensemble_learn(learner=make_logreg(2, 2), eval_x=None, eval_y=None, g=2)


# ---------------------------------------------------------------------------
# Side by side with the reference, from carried-across initial weights
# ---------------------------------------------------------------------------

def _ref_inits(ref_learner, seed: int, g: int, num_blocks: int) -> list[dict]:
    """The reference loop's initial weights, in the order it draws them:
    ``PRNGKey(seed)`` -> ``split`` per batch -> ``split(sub, g)``."""
    key, out, left = jax.random.PRNGKey(seed), [], num_blocks
    while left > 0:
        take = min(g, left)
        key, sub = jax.random.split(key)
        stacked = params_from_numpy(_numpy(jax.vmap(ref_learner.init)(jax.random.split(sub, take))),
                                    "cpu")
        out += [{k: v[i] for k, v in stacked.items()} for i in range(take)]
        left -= take
    return out


def _replaying(learner, inits: list[dict]):
    """``learner`` whose ``init`` hands out ``inits`` in order."""
    it = iter(inits)
    return dataclasses.replace(learner, init=lambda gen, *a: next(it))


LEARNERS = {
    "logreg": lambda f: (make_logreg(f, 2, steps=300), ref_ens.make_logreg(f, 2, steps=300)),
    "mlp": lambda f: (make_mlp(f, 2, hidden=16, steps=150),
                      ref_ens.make_mlp(f, 2, hidden=16, steps=150)),
}


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_fit_matches_the_reference(higgs, name):
    bx, by, xe, ye = higgs
    learner, ref_learner = LEARNERS[name](bx.shape[-1])
    init = _numpy(ref_learner.init(jax.random.PRNGKey(3)))
    want = ref_learner.fit(init, jnp.asarray(bx[4]), jnp.asarray(by[4]))
    got = learner.fit(params_from_numpy(init, "cpu"), torch.from_numpy(bx[4]),
                      torch.from_numpy(by[4]))
    _close(got, want)
    proba = learner.predict_proba(got, torch.from_numpy(xe))
    want_proba = ref_learner.predict_proba(want, jnp.asarray(xe))
    np.testing.assert_allclose(proba.numpy(), np.asarray(want_proba), atol=ATOL)


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_stacked_trainer_matches_the_reference(higgs, name):
    bx, by, _, _ = higgs
    learner, ref_learner = LEARNERS[name](bx.shape[-1])
    key = jax.random.PRNGKey(7)
    want = ref_ens.train_base_models_vmapped(ref_learner, key, jnp.asarray(bx[:4]),
                                             jnp.asarray(by[:4]))
    inits = _numpy(jax.vmap(ref_learner.init)(jax.random.split(key, 4)))
    stacked = params_from_numpy(inits, "cpu")
    replay = _replaying(learner, [{k: v[i] for k, v in stacked.items()} for i in range(4)])
    got = train_base_models_vmapped(replay, torch.Generator(), torch.from_numpy(bx[:4]),
                                    torch.from_numpy(by[:4]))
    _close(got, want)


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_predict_proba_matches_the_reference(higgs, name):
    bx, by, xe, ye = higgs
    learner, ref_learner = LEARNERS[name](bx.shape[-1])
    stacked = ref_ens.train_base_models_vmapped(  # trained: far from uniform
        ref_learner, jax.random.PRNGKey(1), jnp.asarray(bx[:6]), jnp.asarray(by[:6]))
    ref = ref_ens.Ensemble(ref_learner)
    ref.add_stacked(stacked, 6)
    ens = Ensemble(learner)
    ens.add_stacked(params_from_numpy(_numpy(stacked), "cpu"), 6)
    assert ens.num_models == 6
    want = np.asarray(ref.predict_proba(jnp.asarray(xe)))
    np.testing.assert_allclose(ens.predict_proba(torch.from_numpy(xe)).numpy(), want,
                               rtol=0, atol=PROBA_TOL)
    assert abs(ens.accuracy(torch.from_numpy(xe), torch.from_numpy(ye))
               - ref.accuracy(jnp.asarray(xe), jnp.asarray(ye))) <= _acc_tol(want)


def _acc_tol(proba: np.ndarray) -> float:
    """How far two accuracies may differ: the share of points whose top-two
    probability margin is below MARGIN (their argmax may fall either way),
    plus one float32 rounding of the reference's mean."""
    top2 = np.sort(proba, axis=-1)[:, -2:]
    return float(np.mean(top2[:, 1] - top2[:, 0] < MARGIN)) + 2.0 ** -24


def _same_history(ens, hist, ref_ens_, ref_hist, ref_learner, xe, ye):
    assert hist.blocks_used == ref_hist.blocks_used
    assert len(hist.accuracy) == len(ref_hist.accuracy)
    for m, acc, want in zip(ref_hist.blocks_used, hist.accuracy, ref_hist.accuracy):
        part = ref_ens.Ensemble(ref_learner)
        part.add_stacked(jax.tree.map(lambda a: a[:m], ref_ens_._stacked), m)
        assert abs(acc - want) <= _acc_tol(np.asarray(part.predict_proba(jnp.asarray(xe))))


@pytest.mark.parametrize("g,seed,max_batches", [(4, 0, None), (3, 2, 3)])
def test_asymptotic_learning_matches_the_reference(higgs, g, seed, max_batches):
    bx, by, xe, ye = higgs
    learner, ref_learner = make_logreg(28, 2, steps=150), ref_ens.make_logreg(28, 2, steps=150)
    ref, ref_hist = ref_ens.asymptotic_ensemble_learn(
        jnp.asarray(bx), jnp.asarray(by), learner=ref_learner, eval_x=jnp.asarray(xe),
        eval_y=jnp.asarray(ye), g=g, seed=seed, max_batches=max_batches)
    replay = _replaying(learner, _ref_inits(ref_learner, seed, g, bx.shape[0]))
    ens, hist = asymptotic_ensemble_learn(
        torch.from_numpy(bx), torch.from_numpy(by), learner=replay, eval_x=torch.from_numpy(xe),
        eval_y=torch.from_numpy(ye), g=g, seed=seed, max_batches=max_batches)
    _same_history(ens, hist, ref, ref_hist, ref_learner, xe, ye)
    _close(ens.params, ref._stacked)


@pytest.mark.parametrize("stored", [False, True], ids=["memory", "store"])
def test_dataset_ensemble_matches_the_reference(higgs, tmp_path, stored):
    bx, by, xe, ye = higgs
    data = np.concatenate([bx, by[..., None].astype(np.float32)], axis=-1).reshape(-1, 29)
    ref_ds = ref_rsp.partition(data, blocks=10, seed=4, backend="np", num_classes=2)
    ds = rsp.partition(data, blocks=10, seed=4, backend="np", num_classes=2, device="cpu")
    if stored:
        ref_ds.save(str(tmp_path / "c"))
        ref_ds, ds = ref_rsp.open(str(tmp_path / "c")), rsp.open(str(tmp_path / "c"), device="cpu")
    ref_learner = ref_ens.make_logreg(28, 2, steps=100)
    ref, ref_hist = ref_ds.ensemble(ref_learner, eval_x=xe, eval_y=ye, g=3, batches=2, seed=6)
    replay = _replaying(make_logreg(28, 2, steps=100), _ref_inits(ref_learner, 6, 3, 10))
    ens, hist = ds.ensemble(replay, eval_x=xe, eval_y=ye, g=3, batches=2, seed=6)
    _same_history(ens, hist, ref, ref_hist, ref_learner, xe, ye)
    _close(ens.params, ref._stacked)
    xs, ys = ds._split_xy(ds.take([2, 5]))
    want_x, want_y = ref_ds._split_xy(np.asarray(ref_ds.take([2, 5])))
    np.testing.assert_array_equal(xs.numpy(), want_x)
    np.testing.assert_array_equal(ys.numpy(), want_y)


def test_params_from_numpy_carries_the_stacked_weights():
    stacked = {"w": np.arange(12, dtype=np.float64).reshape(2, 3, 2), "b": np.ones((2, 2))}
    got = params_from_numpy(stacked, "cpu")
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in got.values())
    np.testing.assert_array_equal(got["w"].numpy(), stacked["w"].astype(np.float32))

