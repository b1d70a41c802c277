"""The port's launch-plan tuner (``repro_torch.kernels.autotune``,
``repro_torch.roofline.svm_tune``; ROADMAP A.12) against the cases of
``tests/test_autotune.py`` and the JAX reference.

Correctness contract under test:
* with no cache entry every launch takes the plan it took before the
  tuner existed (the analytic plan functions), bit for bit — held here
  on the plans the ``ops`` wrappers hand their launchers (the launchers
  are stubbed: on the CPU the wrappers run the plain versions, which
  take no plan; ``tests/test_torch_cuda.py`` holds the kernels' bits on
  the card);
* a cache entry changes only the plan: the wrapper launches the tuned
  knobs, an explicit knob wins over it, and an entry that is malformed
  or whose plan the plan function rejects is dropped and counted, never
  launched; a missing / corrupted / version-mismatched file is an
  empty cache;
* the runtime resolution is memoised per shape: the cache is read once
  a distinct shape, not once a launch;
* the default plan is always evaluated by ``tune``, so the tuned result
  is never worse than the default under the chosen objective;
* against the reference: ``shape_bucket``, ``cache_key``,
  ``parse_shape`` and ``DEFAULT_SHAPES`` are equal, and the hill-climb,
  fed one synthetic score table through both ``tune``s, visits the same
  configurations in the same order and picks the same best.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro.roofline import svm_tune as jsvm_tune
from repro_torch.kernels import autotune
from repro_torch.kernels import decision as D
from repro_torch.kernels import feature_map as FM
from repro_torch.kernels import kkt_select as KS
from repro_torch.kernels import ops
from repro_torch.kernels import rbf_gram as G
from repro_torch.roofline import collect, svm_tune

CPU = torch.device("cpu")
# one shape of each kernel at the main path's sizes (PERF.md §6) and one
# small one
SHAPES = [("rbf_gram", (2048, 29491, 102)), ("rbf_gram", (100, 300, 20)),
          ("rff_features", (29491, 1024, 102)),
          ("rff_features", (1024, 1024, 102)), ("kkt_select", (29491,)),
          ("kkt_select", (70,)), ("decision", (3277, 17, 102)),
          ("decision", (37, 1413, 102)),
          ("multitask_decision", (6, 1024, 986, 102)),
          ("multitask_decision", (3, 1, 3792, 102))]


@pytest.fixture
def isolated_cache(tmp_path):
    """Pin the runtime tuning cache to a per-test path; restore after."""
    path = str(tmp_path / "autotune.json")
    autotune.set_cache_path(path)
    yield path
    autotune.set_cache_path(None)


def _write(path, entries, version=autotune.CACHE_VERSION):
    with open(path, "w") as f:
        json.dump({"version": version, "entries": entries}, f)
    autotune.reset()


def _entry(kernel, shape, cfg, dtype="fp32", device="cpu"):
    return {autotune.cache_key(device, kernel, dtype, shape):
            {"config": cfg}}


# ------------------------------------------------------------- candidates
@pytest.mark.parametrize("kernel,shape", SHAPES)
def test_candidates_include_default_and_fit_the_shared_memory(kernel, shape):
    cands = autotune.candidates(kernel, shape)
    default = autotune.default_config(kernel, shape)
    assert default in cands
    for cfg in cands:
        assert set(cfg) == set(autotune.KNOBS[kernel])
        p = autotune.plan(kernel, shape, "fp32", cfg)
        assert getattr(p, "smem_bytes", 0) <= G.SMEM_LIMIT, (cfg, p)
        assert autotune.config_of(kernel, p) == cfg


@pytest.mark.parametrize("kernel,shape", SHAPES)
def test_default_config_is_the_analytic_plan(kernel, shape):
    """The default is the plan each kernel takes without a tuner."""
    want = {"rbf_gram": lambda n, m, d: G.gram_plan(n, m, d),
            "rff_features": lambda n, k, d: FM.rff_plan(n, k, d),
            "kkt_select": KS.n_blocks,
            "decision": lambda t, n, d: D.decision_plan(t, 1, n, d),
            "multitask_decision":
                lambda tasks, t, w, d: D.decision_plan(t, tasks, w, d),
            }[kernel](*shape)
    assert autotune.plan(kernel, shape) == want
    assert autotune.default_config(kernel, shape) == autotune.config_of(
        kernel, want)


def test_candidates_clip_to_small_shapes():
    # a tiny problem does not propose tiles beyond its pow2-rounded shape
    for cfg in autotune.candidates("rbf_gram", (20, 100, 10)):
        assert cfg["rows"] <= 32
    for cfg in autotune.candidates("decision", (3, 17, 102)):
        assert cfg == {"rows": 64, "splits": 1}
    assert autotune.candidates("kkt_select", (70,)) == [{"blocks": 1}]
    assert autotune.clip_to_candidates("rbf_gram", {"rows": 128},
                                       (20, 100, 10)) == {"rows": 32}
    assert autotune.clip_to_candidates(
        "decision", {"rows": 128, "splits": 64}, (3, 17, 102)) == {
        "rows": 64, "splits": 1}
    assert autotune.clip_to_candidates(
        "multitask_decision", {"rows": 128, "splits": 64},
        (6, 1024, 986, 102)) == {"rows": 128, "splits": 16}
    assert autotune.clip_to_candidates("kkt_select", {"blocks": 300},
                                       (29491,)) == {"blocks": 128}


def test_bf16_admits_wider_tiles_than_fp32():
    # bf16 halves the words of depth a row tile holds in shared memory
    big = (4096, 4096, 128)
    fp32 = autotune.candidates("rbf_gram", big, "fp32")
    bf16 = autotune.candidates("rbf_gram", big, "bf16")
    assert len(bf16) >= len(fp32)
    assert {"rows": 128} in bf16 and {"rows": 128} not in fp32


def test_shape_bucket_and_cache_key():
    assert autotune.shape_bucket("rbf_gram", (1000, 1024, 100)) == \
        "n1024_m1024_d128"
    assert autotune.shape_bucket("kkt_select", (5000,)) == "n8192"
    key = autotune.cache_key("cpu", "rbf_gram", "bf16", (1000, 1024, 100))
    assert key == "cpu|rbf_gram|bf16|n1024_m1024_d128"
    with pytest.raises(ValueError):
        autotune.shape_bucket("rbf_gram", (10, 10))
    assert autotune.device_kind(CPU) == "cpu"


@pytest.mark.parametrize("kernel,shape", SHAPES + [
    ("rbf_gram", (1, 1, 1)), ("multitask_decision", (36, 7, 7430, 3))])
def test_bucket_and_key_equal_the_reference(kernel, shape):
    assert autotune.shape_bucket(kernel, shape) == \
        jat.shape_bucket(kernel, shape)
    for dtype in ("fp32", "bf16"):
        assert autotune.cache_key("cpu", kernel, dtype, shape) == \
            jat.cache_key("cpu", kernel, dtype, shape)
    assert sorted(autotune.KNOBS) == sorted(jat.DEFAULTS)


# -------------------------------------------------------------- hillclimb
@pytest.mark.parametrize("kernel,shape", SHAPES)
def test_tune_roofline_never_worse_than_default(kernel, shape):
    res = autotune.tune(kernel, shape, budget=6, objective="roofline",
                        device="cpu")
    assert res.objective == "roofline"
    assert res.default.config == autotune.default_config(kernel, shape)
    assert res.trace[0] is res.default
    assert res.best.score <= res.default.score
    assert res.best.roofline_s <= res.default.roofline_s
    assert 1 <= len(res.trace) <= 6
    assert res.best.config in autotune.candidates(kernel, shape)
    assert all(ev.wall_s is None for ev in res.trace)


def test_tune_objectives_on_the_cpu():
    # wall times the kernels, which run only on the card; auto falls back
    # to the estimate there
    with pytest.raises(ValueError, match="on the card"):
        autotune.tune("rbf_gram", (128, 128, 64), objective="wall",
                      device="cpu")
    with pytest.raises(ValueError, match="unknown objective"):
        autotune.tune("rbf_gram", (128, 128, 64), objective="combined",
                      device="cpu")
    res = autotune.tune("rbf_gram", (128, 128, 64), objective="auto",
                        device="cpu")
    assert res.objective == "roofline"


def test_roofline_estimate_rewards_bigger_tiles_and_bf16():
    shape = (4096, 4096, 64)
    small = autotune.roofline_estimate("rbf_gram", shape, "fp32",
                                       {"rows": 32})
    big = autotune.roofline_estimate("rbf_gram", shape, "fp32",
                                     {"rows": 128})
    assert big["hbm_bytes"] < small["hbm_bytes"]
    assert big["flops"] == small["flops"]
    bf16 = autotune.roofline_estimate("rbf_gram", shape, "bf16",
                                      {"rows": 32})
    assert bf16["hbm_bytes"] < small["hbm_bytes"]
    assert bf16["t_compute_s"] < small["t_compute_s"]
    # wave quantisation: 29 blocks of kkt_select fill 29 of 132 SMs
    few = autotune.roofline_estimate("kkt_select", (29491,), "fp32",
                                     {"blocks": 29})
    assert few["waves"] == 1
    assert few["t_total_est_s"] == pytest.approx(
        max(few["t_compute_s"], few["t_memory_s"]) * 132 / 29)


def test_roofline_terms_are_the_h100_constants():
    terms = collect.roofline_terms(hbm_bytes=3.35e12, fp32_flops=67e12,
                                   tf32_flops=2 * 495e12)
    assert terms["t_memory_s"] == pytest.approx(1.0)
    assert terms["t_compute_s"] == pytest.approx(2.0)
    assert terms["dominant"] == "compute"
    assert terms["t_total_est_s"] == pytest.approx(2.0)
    assert collect.roofline_terms(hbm_bytes=0.0, bf16_flops=989e12)[
        "t_compute_s"] == pytest.approx(1.0)


def _synthetic_space():
    rows, splits = (32, 64, 128, 256), (1, 2, 4, 8, 16)
    return [{"rows": r, "splits": s} for r in rows for s in splits]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("budget", [3, 6, 12])
def test_hill_climb_equals_the_reference(monkeypatch, seed, budget):
    """One synthetic score table fed to both tuners (their candidate
    space, default and estimate replaced in the test): the same
    configurations in the same order, the same best."""
    space = _synthetic_space()
    rng = np.random.default_rng(seed)
    table = {tuple(sorted(c.items())): float(v)
             for c, v in zip(space, rng.permutation(len(space)) + 1.0)}
    default = space[int(rng.integers(len(space)))]

    def estimate(cfg):
        return {"t_total_est_s": table[tuple(sorted(cfg.items()))]}

    monkeypatch.setattr(jat, "candidates", lambda *a: space)
    monkeypatch.setattr(jat, "clip_to_candidates", lambda *a: dict(default))
    monkeypatch.setattr(jat, "roofline_estimate", lambda *a: estimate(a[3]))
    monkeypatch.setattr(autotune, "candidates", lambda *a: space)
    monkeypatch.setattr(autotune, "default_config", lambda *a: dict(default))
    monkeypatch.setattr(autotune, "roofline_estimate",
                        lambda *a: estimate(a[3]))
    shape = (1024, 1024, 128)
    ref = jat.tune("rbf_gram", shape, budget=budget, objective="roofline")
    got = autotune.tune("rbf_gram", shape, budget=budget,
                        objective="roofline", device="cpu")
    assert [e.config for e in got.trace] == [e.config for e in ref.trace]
    assert got.best.config == ref.best.config
    assert got.default.config == ref.default.config == default


def test_off_ladder_default_steps_to_the_powers_of_two_around_it():
    # kkt_select's analytic 29 blocks at n = 29,491: no 58 or 14 in the
    # space, so its neighbours are 32 and 16
    space = autotune.candidates("kkt_select", (29491,))
    assert autotune._neighbours({"blocks": 29}, space) == [
        {"blocks": 32}, {"blocks": 16}]
    assert autotune._neighbours({"blocks": 32}, space) == [
        {"blocks": 64}, {"blocks": 16}]


# ------------------------------------------------------------- disk cache
def _tune_tiny(kernel="rbf_gram", shape=(256, 256, 128)):
    return autotune.tune(kernel, shape, dtype="fp32", budget=4,
                         objective="roofline", device="cpu")


def test_cache_roundtrip(isolated_cache):
    res = _tune_tiny()
    cache = autotune.TuningCache()
    key = autotune.cache_key("cpu", "rbf_gram", "fp32", (256, 256, 128))
    cache.put(key, res)
    cache.save(isolated_cache)

    loaded = autotune.TuningCache.load(isolated_cache)
    assert loaded.get(key) == res.best.config
    assert loaded.dropped == []
    raw = json.load(open(isolated_cache))
    assert raw["version"] == autotune.CACHE_VERSION
    rec = raw["entries"][key]
    assert rec["n_evaluated"] == len(res.trace)
    assert set(rec) == {"config", "objective", "wall_s", "roofline_s",
                        "default_wall_s", "default_roofline_s",
                        "n_evaluated"}


def test_missing_cache_falls_back_to_the_analytic_plan(isolated_cache):
    assert not os.path.exists(isolated_cache)
    assert autotune.lookup("rbf_gram", (256, 256, 128), device=CPU) is None
    plan = autotune.resolve_gram(256, 256, 128, torch.float32, CPU, 132)
    assert plan == G.gram_plan(256, 256, 128)


def test_corrupted_cache_falls_back(isolated_cache):
    with open(isolated_cache, "w") as f:
        f.write("{not json at all")
    assert autotune.TuningCache.load(isolated_cache).entries == {}
    autotune.reset()
    assert autotune.lookup("rbf_gram", (256, 256, 128), device=CPU) is None


def test_version_mismatch_falls_back(isolated_cache):
    _write(isolated_cache, _entry("rbf_gram", (256, 256, 64), {"rows": 32}),
           version=autotune.CACHE_VERSION + 1)
    assert autotune.TuningCache.load(isolated_cache).entries == {}
    assert autotune.lookup("rbf_gram", (256, 256, 64), device=CPU) is None


def test_malformed_and_infeasible_entries_are_dropped(isolated_cache):
    good = _entry("rbf_gram", (256, 256, 64), {"rows": 32})
    bad = {
        "bad1": "not a dict",
        "bad2": {"no_config_key": 1},
        "cpu|rbf_gram|fp32": {"config": {"rows": 32}},
        "cpu|nope|fp32|n1": {"config": {"rows": 32}},
        "cpu|rbf_gram|fp32|n256_k256_d64": {"config": {"rows": 32}},
        **_entry("rbf_gram", (256, 256, 65), {"block_n": 128}),
        **_entry("rbf_gram", (256, 256, 66), {"rows": "32"}),
        **_entry("rbf_gram", (256, 256, 67), {"rows": True}),
        # the reference's configuration of the same key (a TPU's tiles)
        **_entry("rbf_gram", (256, 256, 68), {"block_n": 256,
                                              "block_m": 256,
                                              "block_d": 128}),
        # plans the plan functions reject at both ends of the bucket
        **_entry("rbf_gram", (256, 256, 32), {"rows": 48}),
        **_entry("rff_features", (256, 256, 32), {"rows": 32}),
        **_entry("kkt_select", (4096,), {"blocks": 1000}),
        **_entry("decision", (256, 100, 32), {"rows": 64, "splits": 3}),
        **_entry("multitask_decision", (2, 256, 100, 32),
                 {"rows": 96, "splits": 1}),
    }
    _write(isolated_cache, {**good, **bad})
    loaded = autotune.TuningCache.load(isolated_cache)
    assert set(loaded.entries) == set(good)
    assert sorted(loaded.dropped) == sorted(bad)
    assert autotune.lookup("rbf_gram", (256, 256, 64), device=CPU) == {
        "rows": 32}
    assert autotune.runtime_cache().dropped == loaded.dropped
    assert not autotune.feasible("kkt_select", (4096,), "fp32",
                                 {"blocks": 1000})


def test_entry_feasible_in_part_of_its_bucket_is_kept(isolated_cache):
    """128-row Gram tiles fit the shared memory at d = 102 but not at
    d = 128 (float32): the d128 bucket's entry is kept at load, launched
    at 102 and dropped (counted) at 128, where the analytic plan runs."""
    _write(isolated_cache, _entry("rbf_gram", (2048, 32768, 128),
                                  {"rows": 128}))
    assert autotune.runtime_cache().dropped == []
    at_102 = autotune.resolve_gram(2048, 29491, 102, torch.float32, CPU, 132)
    assert at_102.rows == 128
    at_128 = autotune.resolve_gram(2048, 29491, 128, torch.float32, CPU, 132)
    assert at_128 == G.gram_plan(2048, 29491, 128) and at_128.rows == 64
    assert len(autotune.runtime_cache().dropped) == 1


def test_entry_infeasible_at_a_narrower_shape_of_its_bucket(isolated_cache):
    """16 splits fit the bucket's widest bank (1,024 SVs, 16 segments) but
    not a 600-SV one (10): at that shape the entry is dropped and counted,
    and the launch takes its analytic plan."""
    _write(isolated_cache, _entry("multitask_decision", (6, 1024, 1024, 102),
                                  {"rows": 64, "splits": 16}))
    wide = autotune.resolve_decision("multitask_decision", 1024, 6, 1024, 102,
                                     torch.float32, CPU, 132)
    assert (wide.rows, wide.splits) == (64, 16)
    assert autotune.runtime_cache().dropped == []
    narrow = autotune.resolve_decision("multitask_decision", 1024, 6, 600,
                                       102, torch.float32, CPU, 132)
    assert narrow == D.decision_plan(1024, 6, 600, 102)
    assert len(autotune.runtime_cache().dropped) == 1
    assert "(6, 1024, 600, 102)" in autotune.runtime_cache().dropped[0]


def test_env_var_overrides_cache_location(tmp_path, monkeypatch):
    p = str(tmp_path / "alt.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", p)
    assert autotune.default_cache_path() == p
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
    assert autotune.default_cache_path().endswith(
        os.path.join(".cache", "repro_torch", "autotune.json"))
    # the reference's variable is not read
    monkeypatch.setenv("REPRO_TUNE_CACHE", p)
    assert autotune.default_cache_path() != p


# ------------------------------------------------------ runtime fast path
class _Launches:
    """The wrappers' launchers replaced by recorders: every ``ops``
    wrapper takes its card path on CPU tensors and hands its plan (or
    kkt_select's block count) here instead of launching."""

    def __init__(self, monkeypatch):
        self.plans = []
        monkeypatch.setattr(ops, "_on_card", lambda *a: True)
        monkeypatch.setattr(ops, "_sm_count", lambda dev: 132)
        monkeypatch.setattr(ops, "current_stream", lambda: 0)
        monkeypatch.setattr(ops._build, "library", lambda: None)

        def plan_of(*a, plan, **kw):
            self.plans.append(plan)
            return 0

        def blocks_of(*a, blocks, **kw):
            self.plans.append(blocks)
            return 0

        for mod, name in ((G, "launch_block"), (FM, "launch"),
                          (D, "launch_decision"), (D, "launch_multitask")):
            monkeypatch.setattr(mod, name, plan_of)
        monkeypatch.setattr(KS, "launch", blocks_of)

    def call(self, kernel, shape, cfg=None):
        inputs = autotune.bench_inputs(kernel, shape, "fp32", "cpu")
        autotune.run(kernel, inputs, "fp32", cfg or {})
        return self.plans.pop()


# SHAPES with the Gram's columns and the map's rows cut to stay small
LAUNCH_SHAPES = [(k, {(2048, 29491, 102): (2048, 1843, 102),
                      (29491, 1024, 102): (1843, 1024, 102)}.get(s, s))
                 for k, s in SHAPES]


@pytest.mark.parametrize("kernel,shape", LAUNCH_SHAPES)
def test_wrappers_launch_the_analytic_plan_without_a_cache(
        isolated_cache, monkeypatch, kernel, shape):
    launches = _Launches(monkeypatch)
    assert launches.call(kernel, shape) == autotune.plan(kernel, shape)
    ops.reset_launches()


@pytest.mark.parametrize("kernel,shape,cfg", [
    ("rbf_gram", (300, 700, 20), {"rows": 32}),
    ("rff_features", (1024, 1024, 102), {"rows": 128}),
    ("kkt_select", (29491,), {"blocks": 64}),
    ("decision", (700, 300, 102), {"rows": 128, "splits": 2}),
    ("multitask_decision", (6, 1024, 986, 102), {"rows": 64, "splits": 4})])
def test_wrappers_launch_the_tuned_entry_and_explicit_knobs_win(
        isolated_cache, monkeypatch, kernel, shape, cfg):
    launches = _Launches(monkeypatch)
    default = autotune.default_config(kernel, shape)
    assert cfg != default
    _write(isolated_cache, _entry(kernel, shape, cfg))
    tuned = launches.call(kernel, shape)
    assert autotune.config_of(kernel, tuned) == cfg
    assert tuned == autotune.plan(kernel, shape, "fp32", cfg)
    # an explicit knob wins over the entry
    explicit = launches.call(kernel, shape, default)
    assert autotune.config_of(kernel, explicit) == default
    # another device's entry is not this one's
    _write(isolated_cache, _entry(kernel, shape, cfg, device="NVIDIA H100"))
    assert autotune.config_of(kernel, launches.call(kernel, shape)) == \
        default
    ops.reset_launches()


def test_resolution_reads_the_cache_once_a_shape(isolated_cache,
                                                 monkeypatch):
    _write(isolated_cache, _entry("kkt_select", (29491,), {"blocks": 64}))
    reads = []
    lookup = autotune.lookup
    monkeypatch.setattr(autotune, "lookup",
                        lambda *a, **k: reads.append(a) or lookup(*a, **k))
    for _ in range(100):
        assert autotune.resolve_kkt(29491, CPU) == 64
        assert autotune.resolve_kkt(29000, CPU) == 64   # same bucket
    assert len(reads) == 2           # one a distinct shape
    autotune.reset()                 # a tune run: read again
    assert autotune.resolve_kkt(29491, CPU) == 64
    assert len(reads) == 3
    assert autotune.resolve_kkt(29491, CPU, 8) == 8   # explicit: no read
    assert len(reads) == 3


def test_explicit_knob_outside_the_plan_raises(isolated_cache):
    with pytest.raises(ValueError, match="rows"):
        autotune.resolve_gram(256, 256, 64, torch.float32, CPU, 132, 48)
    with pytest.raises(ValueError, match="blocks"):
        autotune.resolve_kkt(4096, CPU, 0)
    with pytest.raises(ValueError, match="splits"):
        autotune.resolve_decision("decision", 256, 1, 100, 32,
                                  torch.float32, CPU, 132, 64, 3)


# ---------------------------------------------------------- command line
def test_svm_tune_cli_writes_cache(tmp_path, capsys):
    out = str(tmp_path / "cli.json")
    rc = svm_tune.main(["--kernel", "rbf_gram", "--shape", "256x256x64",
                        "--budget", "2", "--objective", "roofline",
                        "--out", out])
    assert rc == 0
    raw = json.load(open(out))
    assert raw["version"] == autotune.CACHE_VERSION
    assert len(raw["entries"]) == 1
    (key, rec), = raw["entries"].items()
    assert key == "cpu|rbf_gram|fp32|n256_m256_d64"
    assert set(rec["config"]) == {"rows"}
    printed = capsys.readouterr().out
    assert "default -> tuned roofline est" in printed
    autotune.reset()


def test_svm_tune_cli_dry_run_over_every_kernel(tmp_path, capsys):
    out = str(tmp_path / "dry.json")
    assert svm_tune.main(["--kernel", "all", "--objective", "roofline",
                          "--budget", "3", "--dry-run", "--out", out]) == 0
    assert not os.path.exists(out)
    printed = capsys.readouterr().out
    for kernel in autotune.KNOBS:
        assert kernel in printed


def test_svm_tune_cli_rejects_bad_shape():
    with pytest.raises(ValueError, match="positive 'x'-separated"):
        svm_tune.parse_shape("rbf_gram", "256x256")
    with pytest.raises(ValueError):
        svm_tune.parse_shape("kkt_select", "0")


def test_svm_tune_shapes_and_parsing_equal_the_reference():
    assert svm_tune.DEFAULT_SHAPES == jsvm_tune.DEFAULT_SHAPES
    for kernel, shapes in svm_tune.DEFAULT_SHAPES.items():
        for text in shapes + ["7x9x11x13", "5", "2X3x4"]:
            try:
                want = jsvm_tune.parse_shape(kernel, text)
            except ValueError:
                with pytest.raises(ValueError):
                    svm_tune.parse_shape(kernel, text)
            else:
                assert svm_tune.parse_shape(kernel, text) == want
