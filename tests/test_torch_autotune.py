"""The port's autotuner (``repro_torch.kernels.autotune``) against the
cases of the reference's ``tests/test_autotune.py``, plus what the port
adds: its own cache file, no measurement on a CPU tensor, kernel
configurations only among the candidates, and the shuffle's tile search
at the reference's default with tuning off.

The tuner's mechanics are driven with a stand-in device key (the tests
run without a card), and measured times come from a stub table, as the
reference's tests do."""

import json
import os

import numpy as np
import pytest
import torch

from repro.kernels import autotune as ref_autotune
from repro_torch import obs, rsp
from repro_torch.kernels import autotune
from repro_torch.kernels.autotune import Autotuner, Candidate
from repro_torch.kernels.block_sketch import ops as bs_ops
from repro_torch.kernels.block_sketch.kernel import DEFAULT_CONFIG as BS_DEFAULT
from repro_torch.kernels.plan import QueryPlan, compile_plan, plan_sketch
from repro_torch.kernels.plan import ops as plan_ops
from repro_torch.kernels.rsp_shuffle import ops as rs_ops

CARD = "Stand-in Card|0123456789abcdef"


def _card(device):
    return CARD


def _times(table):
    """A measure() stub returning fixed seconds by label, and a call log."""
    calls = []

    def measure(c):
        calls.append(c.label)
        return table[c.label]

    return measure, calls


@pytest.fixture
def tuner(tmp_path):
    return Autotuner(path=str(tmp_path / "autotune_torch.json"), device_key=_card)


CANDS = [Candidate.of("cuda", threads=256), Candidate.of("cuda", threads=1024),
         Candidate.of("cuda", threads=512, path="rows")]
DEFAULT = Candidate.of("cuda", threads=512)
DEV = torch.device("cpu")   # the stand-in key names it as a card


def test_off_mode_returns_default_without_measuring(tuner, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    assert not autotune.enabled()
    measure, calls = _times({})
    got = tuner.choose("k", "r1024xf8:float32", CANDS, measure, default=DEFAULT, device=DEV)
    assert got == DEFAULT
    assert calls == [] and tuner.measurements == 0
    assert not os.path.exists(tuner._file())  # touches no files


@pytest.mark.parametrize("value", ["0", "false", "no", "OFF", "off"])
def test_off_spellings(value, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", value)
    assert not autotune.enabled()
    assert not ref_autotune.enabled()   # the same spellings as the reference


def test_measured_winner_and_cache_hit(tuner, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    labels = [c.label for c in CANDS]
    measure, calls = _times(dict(zip(labels, (3e-3, 1e-3, 2e-3))))
    got = tuner.choose("k", "key", CANDS, measure, default=DEFAULT, device=DEV, repeats=2)
    assert got == CANDS[1]
    assert tuner.measurements == 1
    assert calls.count(labels[0]) == 2  # best-of-repeats per candidate
    calls.clear()
    again = tuner.choose("k", "key", CANDS, measure, default=DEFAULT, device=DEV)
    assert again == CANDS[1]
    assert calls == [] and tuner.measurements == 1


def test_persistence_round_trip(tuner, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    labels = [c.label for c in CANDS]
    measure, _ = _times(dict(zip(labels, (2e-3, 3e-3, 1e-3))))
    tuner.choose("k", "key", CANDS, measure, default=DEFAULT, device=DEV)
    with open(tuner._file()) as f:
        disk = json.load(f)
    ((name, rec),) = disk.items()
    assert name == f"k|key|{CARD}"
    assert rec["impl"] == "cuda" and dict(rec["params"]) == {"threads": 512, "path": "rows"}
    assert not rec["fallback"] and rec["excluded"] == []
    assert rec["measured_us"][labels[2]] == pytest.approx(1e3)

    fresh = Autotuner(path=tuner._file(), device_key=_card)   # a later process
    measure2, calls2 = _times({})
    got = fresh.choose("k", "key", CANDS, measure2, default=DEFAULT, device=DEV)
    assert got == CANDS[2]
    assert calls2 == [] and fresh.measurements == 0
    assert fresh.lookup("k", "key", DEV) == CANDS[2]
    assert fresh.lookup("k", "other", DEV) is None
    # another build of the kernels (another source hash) is another device
    other = Autotuner(path=tuner._file(), device_key=lambda d: "Stand-in Card|ffff")
    assert other.lookup("k", "key", DEV) is None


def _runs(table):
    """A measure() stub returning, for each label, its listed seconds in
    turn (one a round), and a call log."""
    calls = []

    def measure(c):
        calls.append(c.label)
        return table[c.label][calls.count(c.label) - 1]

    return measure, calls


def test_candidates_are_timed_in_turns(tuner, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    labels = [c.label for c in CANDS]
    measure, calls = _runs({lab: [1e-3, 1e-3, 1e-3] for lab in labels})
    tuner.choose("k", "key", CANDS, measure, default=DEFAULT, device=DEV, repeats=3)
    assert calls == labels * 3   # round by round, not candidate by candidate


@pytest.mark.parametrize("gap, kept", [(0.0, True), (0.5e-6, True), (1.5e-6, False)],
                         ids=["tie", "within", "beyond"])
def test_default_stays_unless_beaten_beyond_the_spread(tuner, monkeypatch, gap, kept):
    """The default's runs span 1 us; a candidate whose best run is faster
    by no more than that is noise, and the default stays."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    cands = CANDS + [DEFAULT]
    base = 10e-6
    table = {CANDS[0].label: [base + 5e-6] * 3, CANDS[1].label: [base + 6e-6] * 3,
             CANDS[2].label: [base - gap, base - gap + 0.2e-6, base - gap + 0.1e-6],
             DEFAULT.label: [base + 1e-6, base, base + 0.5e-6]}
    measure, _ = _runs(table)
    got = tuner.choose("k", "key", cands, measure, default=DEFAULT, device=DEV, repeats=3)
    assert got == (DEFAULT if kept else CANDS[2])
    ((_, rec),) = tuner.records().items()
    assert rec["spread_us"][DEFAULT.label] == pytest.approx(1.0)
    assert rec["measured_us"][DEFAULT.label] == pytest.approx(10.0)
    assert rec["us"] == pytest.approx(10.0 if kept else 10.0 - gap * 1e6)


def test_a_default_outside_the_candidates_is_not_favoured(tuner, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    labels = [c.label for c in CANDS]
    measure, _ = _runs({labels[0]: [3e-3, 1e-3], labels[1]: [2e-3, 2e-3],
                        labels[2]: [4e-3, 4e-3]})
    got = tuner.choose("k", "key", CANDS, measure, default=DEFAULT, device=DEV, repeats=2)
    assert got == CANDS[0]   # the fastest best run, however wide its spread


def test_kernel_defaults_are_among_their_candidates():
    """The default-keeping rule needs the default measured: each kernel's
    untuned configuration is one of its candidates, at 0 bins as at 128."""
    assert rs_ops.default_config(1100, 116) in rs_ops.shuffle_candidates(1100, 116)
    assert rs_ops.default_config(110, 116) in rs_ops.shuffle_candidates(110, 116)
    tuner_defaults = {}

    def spy(kernel, key, candidates, measure, *, default, device, repeats=3):
        tuner_defaults[kernel, key] = (default, tuple(candidates))
        return default

    x = torch.zeros((300, 5))
    lo, invw = bs_ops.grid_tensors(np.full(5, -3.0), np.full(5, 3.0), 16, "cpu")
    plan = QueryPlan(predicates="c0 > 0.0", columns=[1, 2])
    lo2, invw2 = bs_ops.grid_tensors(np.full(2, -3.0), np.full(2, 3.0), 16, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(autotune, "choose", spy)
        for bins in (0, 16):
            bs_ops.sketch_config(x, lo, invw, bins=bins)
            plan_ops.plan_config(plan, x, lo2 if bins else None, invw2 if bins else None,
                                 bins=bins)
    assert len(tuner_defaults) == 4
    for default, cands in tuner_defaults.values():
        assert default in cands


def test_rotation_reads_past_the_l2(monkeypatch):
    x = torch.arange(64, dtype=torch.float32).reshape(16, 4)   # 256 bytes
    monkeypatch.setattr(autotune, "L2_BYTES_H100", 1000)
    rot = autotune.Rotation(x)
    got = [rot(i) for i in range(9)]
    assert got[0] is x and got[8] is x                  # 8 = ceil(2 * 1000 / 256) copies
    assert len({t.data_ptr() for t in got[:8]}) == 8    # distinct storage
    assert all(torch.equal(t, x) for t in got)
    monkeypatch.setattr(autotune, "L2_BYTES_H100", 100)
    assert autotune.Rotation(x)(1) is x                 # already past it: x alone
    monkeypatch.setattr(autotune, "L2_BYTES_H100", 1 << 30)
    big = autotune.Rotation(x)
    assert len({big(i).data_ptr() for i in range(64)}) == autotune.MAX_COPIES


def test_failing_candidate_is_disqualified(tuner, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")

    def measure(c):
        if c.get("path") == "rows":
            raise RuntimeError("launch refused")
        return 1e-3 if c.get("threads") == 1024 else 2e-3

    got = tuner.choose("k", "key", CANDS, measure, default=DEFAULT, device=DEV)
    assert got == CANDS[1]
    with open(tuner._file()) as f:
        (rec,) = json.load(f).values()
    assert rec["excluded"] == [f"{CANDS[2].label} (error: RuntimeError)"]
    assert CANDS[2].label not in rec["measured_us"]


def test_all_excluded_falls_back_to_default(tuner, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")

    def measure(c):
        raise ValueError("no kernel here")

    got = tuner.choose("k", "key", CANDS, measure, default=DEFAULT, device=DEV)
    assert got == DEFAULT
    with open(tuner._file()) as f:
        (rec,) = json.load(f).values()
    assert rec["fallback"] and rec["us"] is None and len(rec["excluded"]) == 3


def test_clear_forgets_disk_and_memory(tuner, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    measure, _ = _times({c.label: 1e-3 for c in CANDS})
    tuner.choose("k", "key", CANDS, measure, default=DEFAULT, device=DEV)
    assert os.path.exists(tuner._file())
    tuner.clear()
    assert not os.path.exists(tuner._file())
    assert tuner.lookup("k", "key", DEV) is None


def test_cache_path_env_override(tmp_path, monkeypatch):
    target = str(tmp_path / "elsewhere.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", target)
    assert autotune.cache_path() == target
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    assert autotune.cache_path().endswith(os.path.join("results", "bench", "autotune_torch.json"))


def test_shape_key_buckets_rows():
    assert autotune.shape_key(600, 8) == autotune.shape_key(1024, 8) == "r1024xf8:float32"
    assert autotune.shape_key(1025, 8) == "r2048xf8:float32"
    assert autotune.shape_key(1024, 9) != autotune.shape_key(1024, 8)
    assert autotune.shape_key(1024, 8, "float64") != autotune.shape_key(1024, 8)
    for rows in (1, 600, 1025, 110_000):   # the reference's buckets
        assert autotune.shape_key(rows, 29) == ref_autotune.shape_key(rows, 29)


def test_candidate_labels_and_params():
    assert Candidate("cuda").label == "cuda"
    assert Candidate("cuda", 256).label == "cuda:256"
    c = Candidate.of("cuda", threads=512, path="staged")
    assert c.label == "cuda,path=staged,threads=512"
    assert c == Candidate.of("cuda", path="staged", threads=512)
    assert c.get("threads") == 512 and c.get("missing", 7) == 7


def test_obs_counts_a_tuning_run(tuner, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    obs.reset()
    obs.enable()
    try:
        measure, _ = _times({c.label: 1e-3 for c in CANDS})
        tuner.choose("rsp_shuffle", "key", CANDS, measure, default=DEFAULT, device=DEV)
        tuner.choose("rsp_shuffle", "key", CANDS, measure, default=DEFAULT, device=DEV)
        snap = obs.get_registry().snapshot()
    finally:
        obs.reset()
    (runs,) = snap["rsp_autotune_runs_total"]["series"]
    assert runs["labels"] == {"kernel": "rsp_shuffle"} and runs["value"] == 1
    (hist,) = snap["rsp_autotune_measure_seconds"]["series"]
    assert hist["count"] == 1


def test_cpu_tensor_returns_the_default_without_measuring(tmp_path, monkeypatch):
    """On a CPU tensor only the plain versions run: the default tuner
    (whose device key names CUDA devices only) measures nothing, even with
    tuning on, and writes no file."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    t = Autotuner(path=str(tmp_path / "t.json"))
    assert autotune.device_key(torch.device("cpu")) is None
    measure, calls = _times({c.label: 1e-3 for c in CANDS})
    assert t.choose("k", "key", CANDS, measure, default=DEFAULT, device=DEV) == DEFAULT
    assert calls == [] and t.measurements == 0 and not os.path.exists(t._file())
    assert t.lookup("k", "key", DEV) is None


def test_auto_paths_on_the_cpu_never_write_a_cache(tmp_path, monkeypatch):
    """With tuning on, every ``impl="auto"`` path on CPU tensors runs its
    plain version and leaves both the port's and the reference's cache
    files as they were."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    ref_file = ref_autotune.cache_path()
    port_file = autotune.cache_path()
    assert os.path.basename(port_file) == "autotune_torch.json" and port_file != ref_file

    def state(p):
        return os.stat(p).st_mtime_ns if os.path.exists(p) else None

    before = (state(ref_file), state(port_file))
    n0 = autotune.get_tuner().measurements
    x = np.random.default_rng(0).normal(size=(512, 4)).astype(np.float32)
    bs_ops.block_sketch(x, bins=8, lo=-4.0, hi=4.0, impl="auto")
    plan_sketch(x, QueryPlan(predicates="c0 > 0.0"), bins=8, lo=-4.0, hi=4.0, impl="auto")
    rs_ops.rsp_randomize_block(torch.from_numpy(x), 3)
    rsp.partition(np.tile(x, (4, 1)), blocks=4, backend="cuda", device="cpu", summaries=False)
    assert autotune.get_tuner().measurements == n0
    assert (state(ref_file), state(port_file)) == before


def test_candidate_lists_hold_no_plain_version():
    lists = {
        "rsp_shuffle": rs_ops.shuffle_candidates(1100, 116),
        "rsp_shuffle rows": rs_ops.shuffle_candidates(110, 116),
        "block_sketch": bs_ops.block_sketch_candidates(128),
        "block_sketch moments": bs_ops.block_sketch_candidates(0),
        "plan_sketch": plan_ops.plan_candidates(128),
    }
    for name, cands in lists.items():
        assert cands, name
        assert {c.impl for c in cands} == {"cuda"}, name
        assert all(v not in ("torch", "ref", "np", "jax") for c in cands for _, v in c.params)
        assert len(set(cands)) == len(cands), name
    paths = {c.get("path") for c in lists["rsp_shuffle"]}
    assert paths == {"staged", "rows"}
    assert {c.get("path") for c in lists["rsp_shuffle rows"]} == {"rows"}  # 110 x 116 B: no 16 B tile
    assert {c.get("path") for c in lists["plan_sketch"]} == {"stage", "gather"}
    assert not any(c.get("hist_in_smem") for c in lists["block_sketch moments"])


def test_failing_kernel_candidates_are_excluded_never_replaced(tmp_path, monkeypatch):
    """A candidate whose launch raises (here: no card for the kernel) is
    excluded; with none left the record is a fallback to the default
    kernel configuration, never to the plain version."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    t = Autotuner(path=str(tmp_path / "t.json"), device_key=_card)
    monkeypatch.setattr(autotune, "_TUNER", t)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(300, 5)).astype(np.float32))
    lo, invw = bs_ops.grid_tensors(np.full(5, -3.0), np.full(5, 3.0), 16, "cpu")
    assert bs_ops.sketch_config(x, lo, invw, bins=16) == BS_DEFAULT
    plan = QueryPlan(predicates="c0 > 0.0", columns=[1, 2])
    lo2, invw2 = bs_ops.grid_tensors(np.full(2, -3.0), np.full(2, 3.0), 16, "cpu")
    got = plan_ops.plan_config(plan, x, lo2, invw2, bins=16)
    assert got == plan_ops.default_candidate(plan, 5, 16)
    recs = t.records()
    assert len(recs) == 2
    for rec in recs.values():
        assert rec["fallback"] and rec["impl"] == "cuda" and rec["measured_us"] == {}
        assert rec["excluded"] and all("(error: ValueError)" in e for e in rec["excluded"])


def test_rsp_randomize_block_with_tuning_off_takes_the_reference_tile(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2048, 3)).astype(np.float32))
    assert rs_ops.randomize_tile(x, 5) == rs_ops.DEFAULT_SHUFFLE_TILE == 256
    got = rs_ops.rsp_randomize_block(x, 5)
    assert torch.equal(got, rs_ops.rsp_randomize_block(x, 5, tile_rows=256))
    assert not torch.equal(got, rs_ops.rsp_randomize_block(x, 5, tile_rows=512))
    assert torch.equal(torch.sort(got[:, 0]).values, torch.sort(x[:, 0]).values)
    # 640 rows: 256 does not divide them; the largest tile that does (128)
    y = x[:640]
    assert rs_ops.randomize_tile(y, 5) == 128
    assert torch.equal(rs_ops.rsp_randomize_block(y, 5),
                       rs_ops.rsp_randomize_block(y, 5, tile_rows=128))
    with pytest.raises(ValueError, match="no tile"):
        rs_ops.rsp_randomize_block(x[:100], 5)


def test_auto_paths_deterministic_with_tuning_off(monkeypatch):
    """conftest pins REPRO_AUTOTUNE=off: the ``impl="auto"`` entry points
    run no measurement (the reference's test, on the port)."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    before = autotune.get_tuner().measurements
    x = np.random.default_rng(0).normal(size=(512, 4)).astype(np.float32)
    a = bs_ops.block_sketch(x, bins=8, lo=-4.0, hi=4.0, impl="auto")
    b = bs_ops.block_sketch(x, bins=8, lo=-4.0, hi=4.0, impl="ref")
    np.testing.assert_allclose(a.mean, b.mean, rtol=1e-5, atol=1e-6)
    plan = QueryPlan(predicates="c0 > 0.0")
    r = plan_sketch(x, plan, impl="auto")
    np.testing.assert_allclose(r.sketches[0].mean, plan_sketch(x, plan, impl="ref").sketches[0].mean,
                               rtol=1e-5, atol=1e-5)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(rs_ops.rsp_randomize_block(t, 0).numpy(),
                                  rs_ops.rsp_randomize_block(t, 0).numpy())
    assert autotune.get_tuner().measurements == before


def test_compile_cache_keys_on_tuning():
    plan = QueryPlan(predicates="c1 < 0.5")
    plan_ops.cache_clear()
    a = compile_plan(plan, num_features=4, bins=0, impl="cuda", device="cpu")
    b = compile_plan(plan, num_features=4, bins=0, impl="cuda", device="cpu", tuned=True)
    c = compile_plan(plan, num_features=4, bins=0, impl="torch", device="cpu", tuned=True)
    d = compile_plan(plan, num_features=4, bins=0, impl="torch", device="cpu")
    assert a is not b and c is d   # a plain executor has nothing to tune
    assert plan_ops.cache_info()["size"] == 3
