"""The port's roofline tools (``repro_torch.roofline``), the counterparts
of ``repro/roofline/{collect,differential,hillclimb,inspect_hlo,
report}.py``, on reduced configs traced on a fake (data 2, model 4) mesh
(``launch.dryrun``: fake process group, fake tensors, nothing
allocated) and small input shapes.

* ``roofline_terms``: the three terms against the H100's constants, the
  collective term at NVLink's rate within one node and the NIC's beyond.
* ``differential.probe``: fed the same two synthetic shallow records as
  the reference's ``probe`` (each package's ``lower_combo``
  monkeypatched), its ``extrapolated`` equals the reference's
  ``corrected`` exactly. On real traces the full-depth count equals the
  two-depth extrapolation where the depth is a multiple of the period
  (mamba2), and differs by the shared-attention arithmetic where it is
  not (zamba2 with its period of 6 at 8 layers: 2 applications counted,
  1 + 2 / 6 extrapolated; at its 38 layers 7 against 6.33).
* ``hillclimb.run``: ``accum4`` counts ``baseline``'s FLOPs (the
  microbatch loop is eager; the reference's x MICROBATCHES would count
  4x), and the switches are reset after a run, a failing one too.
* ``report``: ``fmt_table`` has the reference's columns; 6·N·D per rank
  and the useful ratio equal the reference's ``analyze`` on the same row
  numbers.
* ``inspect_hlo.top_collectives``: the largest collectives, each with a
  ``models/`` source line, whose bytes sum to the record's.
* The four CLIs exit 0 on a reduced combo.
"""
import json
import sys
import types

import pytest

from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as DR
from repro_torch.models import runtime as RT
from repro_torch.roofline import collect, differential, hillclimb
from repro_torch.roofline import inspect_hlo, report

MESH = (2, 4)


def tiny(kind: str, batch: int = 4, seq: int = 32) -> InputShape:
    return InputShape(f"tiny_{kind}", seq, batch, kind)


# ------------------------------------------------------------ collect
def test_roofline_terms_have_a_collective_term():
    t = collect.roofline_terms(hbm_bytes=0.0, bf16_flops=989e12,
                               collective_bytes_total=2 * 450e9, n_ranks=8)
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["t_collective_s"] == pytest.approx(2.0)
    assert t["dominant"] == "collective"
    assert t["t_total_est_s"] == pytest.approx(2.0)
    # a mesh past one node goes at the NIC's rate
    t = collect.roofline_terms(hbm_bytes=3.35e12,
                               collective_bytes_total=50e9, n_ranks=256)
    assert t["t_collective_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(1.0)
    # the kernel-bound callers pass no collectives: two terms as before
    t = collect.roofline_terms(hbm_bytes=3.35e12, fp32_flops=2 * 67e12)
    assert t["t_collective_s"] == 0.0 and t["dominant"] == "compute"
    assert "TPU" not in report.RATES and "H100" in report.RATES


# ------------------------------------------------------- differential
PAIR = {"flops": (1.234e12, 2.5e12), "bytes": (3.0e11, 5.7e11),
        "ag": (1.0e9, 1.9e9), "ar": (4.0e8, 7.5e8), "rs": (0.0, 2.0e6)}


def _shallow(i: int, reference: bool) -> dict:
    kinds = {"all-gather": PAIR["ag"][i], "all-reduce": PAIR["ar"][i],
             "reduce-scatter": PAIR["rs"][i], "all-to-all": 0.0}
    if reference:
        kinds["collective-permute"] = 0.0
    coll = {"per_kind_bytes": kinds, "total_bytes": sum(kinds.values())}
    if reference:
        return {"status": "ok", "n_devices": 256, "collectives": coll,
                "cost": {"flops": PAIR["flops"][i], "transcendentals": 0.0,
                         "bytes_accessed": PAIR["bytes"][i]}}
    return {"status": "ok", "n_ranks": 256, "collectives": coll,
            "flops": PAIR["flops"][i], "bytes_accessed": PAIR["bytes"][i],
            "memory": {}}


def test_extrapolation_is_the_reference_formula(monkeypatch):
    from repro.models import runtime as JRT
    from repro.roofline import differential as jdiff
    arch = "zamba2_1p2b"
    l1, l2 = differential.DEPTH_PAIRS[arch]
    assert (l1, l2) == jdiff.DEPTH_PAIRS[arch]
    assert differential.DEPTH_PAIRS == jdiff.DEPTH_PAIRS

    def fake(reference):
        def lower_combo(_arch, _shape, *, multi_pod, n_layers, **_kw):
            assert not multi_pod
            i = {l1: 0, l2: 1}.get(n_layers)
            return _shallow(0 if i is None else i, reference)
        return lower_combo
    # the reference imports its dry run inside probe; its module sets
    # XLA_FLAGS at import, so a stand-in takes its place
    monkeypatch.setitem(sys.modules, "repro.launch.dryrun",
                        types.SimpleNamespace(lower_combo=fake(True)))
    monkeypatch.setattr(JRT, "UNROLL_SCANS", False)   # probe sets it
    monkeypatch.setattr(DR, "lower_combo", fake(False))
    want = jdiff.probe(arch, "train_4k", multi_pod=False)["corrected"]
    got = differential.probe(arch, "train_4k", multi_pod=False)
    assert got["depth_pair"] == [l1, l2] and got["n_layers"] == 38
    assert got["shallow_flops"] == list(PAIR["flops"])
    for k, v in got["extrapolated"].items():
        assert v == want[k], k
    for k, v in got["corrected"].items():
        if k.startswith("per_layer_"):
            assert v == want[k], k


def _probe(arch, depth, **kw):
    return differential.probe(arch, "tiny", multi_pod=False, depth=depth,
                              input_shape=tiny("prefill"), mesh_shape=MESH,
                              reduced=True, **kw)


def test_full_depth_equals_extrapolation_on_a_period_multiple(monkeypatch):
    monkeypatch.setitem(differential.DEPTH_PAIRS, "mamba2_780m", (2, 4))
    rec = _probe("mamba2_780m", 6)
    got, ext = rec["corrected"], rec["extrapolated"]
    for k in ("flops", "bytes_accessed", "collective_total",
              "coll_all-gather", "coll_all-reduce"):
        assert got[k] == pytest.approx(ext[k], rel=1e-12), k
    assert got["collective_total"] > 0
    assert rec["corrected_from"] == "full-depth trace"
    assert rec["full_depth"]["n_ranks"] == 8


def test_full_depth_counts_zamba2s_shared_attention():
    """Attention before layers 0 and 6: 2 applications at 8 layers; the
    pair (6, 12) gives 1 + 2 / 6. The gap is 2/3 of one application,
    read from depths 6, 7 and 8 (layer 6 carries one, layer 7 none)."""
    over = {"shared_attn_every": 6}
    rec = _probe("zamba2_1p2b", 8, cfg_overrides=over)
    c7 = DR.lower_combo("zamba2_1p2b", "tiny", n_layers=7,
                        shape=tiny("prefill"), mesh_shape=MESH,
                        reduced=True, cfg_overrides=over)["flops"]
    c6, c8 = rec["shallow_flops"][0], rec["corrected"]["flops"]
    attn = (c7 - c6) - (c8 - c7)
    assert attn > 0
    gap = rec["corrected"]["flops"] - rec["extrapolated"]["flops"]
    assert gap == pytest.approx((2 - (1 + 2 / 6)) * attn, rel=1e-9)
    assert differential.gap(rec) > 0


# ---------------------------------------------------------- hillclimb
def test_accum4_counts_baselines_flops(monkeypatch):
    monkeypatch.setitem(differential.DEPTH_PAIRS, "phi4_mini_3p8b", (1, 2))
    kw = dict(input_shape=tiny("train", batch=8, seq=16), mesh_shape=MESH,
              reduced=True)
    base = hillclimb.run("phi4_mini_3p8b", "tiny", "baseline", **kw)
    acc = hillclimb.run("phi4_mini_3p8b", "tiny", "accum4", **kw)
    assert acc["corrected"]["flops"] == base["corrected"]["flops"] > 0
    assert RT.MICROBATCHES == 1       # reset after the run
    for r in (base, acc):
        assert set(r["terms"]) == {"t_compute_s", "t_memory_s",
                                   "t_collective_s", "dominant",
                                   "t_total_est_s"}
        assert r["full_depth_memory"]["temp_bytes"] > 0
        assert r["corrected_from"] == "full-depth trace"


def test_variant_switches_are_reset_after_a_failing_run():
    before = {k: getattr(RT, k) for k in RT.FLAGS}
    with pytest.raises(KeyError):
        hillclimb.run("no_such_arch", "tiny", "fit8")
    assert {k: getattr(RT, k) for k in RT.FLAGS} == before
    assert set(hillclimb.VARIANTS) >= {"baseline", "accum4", "serve_tp"}
    for flags in hillclimb.VARIANTS.values():
        assert {k.upper() for k in flags} <= set(RT.FLAGS)


# ------------------------------------------------------------- report
def test_report_matches_the_references_analysis(monkeypatch):
    from repro.configs import base as jbase
    from repro.roofline import report as jreport
    rec = DR.lower_combo("mamba2_780m", "tiny_train", shape=tiny("train"),
                         mesh_shape=MESH, reduced=True)
    row = report.analyze(rec)
    ref_row = {"arch": rec["arch"], "shape": rec["shape"],
               "multi_pod": False, "status": "ok",
               "n_devices": rec["n_ranks"],
               "cost": {"flops": rec["flops"],
                        "bytes_accessed": rec["bytes_accessed"]},
               "collectives": rec["collectives"], "memory": rec["memory"]}
    monkeypatch.setattr(jreport, "get_config",
                        lambda a: jbase.reduced(jbase.get_config(a)))
    monkeypatch.setitem(jreport.INPUT_SHAPES, "tiny_train",
                        jbase.InputShape("tiny_train", 32, 4, "train"))
    want = jreport.analyze(ref_row)
    assert row["model_flops_per_rank"] == pytest.approx(
        want["model_flops_per_dev"], rel=1e-12)
    assert row["useful_ratio"] == pytest.approx(want["useful_ratio"],
                                                rel=1e-12)
    assert set(row["terms"]) == set(want["terms"])
    ours = report.fmt_table([row], multi_pod=False).splitlines()
    theirs = jreport.fmt_table([want], multi_pod=False).splitlines()
    head = [c.strip() for c in ours[0].split("|")]
    ref_head = [c.strip() for c in theirs[0].split("|")]
    assert len(head) == len(ref_head) and head[:7] == ref_head[:7]
    assert len(ours) == len(theirs) == 3
    assert ours[2].count("|") == theirs[2].count("|")


# -------------------------------------------------------- inspect_hlo
def test_top_collectives_name_their_model_source():
    rec = DR.lower_combo("zamba2_1p2b", "tiny_decode", shape=tiny("decode"),
                         mesh_shape=MESH, reduced=True,
                         keep_collectives=True)
    recs = rec["_collectives"]
    assert sum(r["bytes"] for r in recs) == rec["collectives"]["total_bytes"]
    top = inspect_hlo.top_collectives(recs, n=5)
    assert 0 < len(top) <= 5
    assert [t[0] for t in top] == sorted((t[0] for t in top), reverse=True)
    assert top[0][0] == max(r["bytes"] for r in recs)
    for b, kind, shape, source in top:
        assert kind in collect.KINDS and shape.startswith("[")
        assert source.startswith("models/") and ".py:" in source
    assert "_collectives" not in DR.lower_combo(
        "zamba2_1p2b", "tiny_decode", shape=tiny("decode"),
        mesh_shape=MESH, reduced=True)


# --------------------------------------------------------------- CLIs
def test_the_four_clis_run_a_reduced_combo(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(differential.DEPTH_PAIRS, "mamba2_780m", (1, 2))
    combo = ["--arch", "mamba2_780m", "--shape", "decode_32k", "--reduced",
             "--mesh", "2x4"]
    rows, diff = tmp_path / "dryrun.jsonl", tmp_path / "diff.jsonl"
    assert DR.main([*combo, "--out", str(rows)]) == 0
    assert differential.main([*combo, "--out", str(diff)]) == 0
    assert hillclimb.main([*combo, "--variant", "serve_tp",
                           "--skip-full"]) == 0
    assert inspect_hlo.main(combo) == 0
    capsys.readouterr()
    assert report.main([str(rows), f"--diff={diff}"]) == 0
    out = capsys.readouterr().out
    assert "## Single-pod (2x4 = 8 ranks)" in out
    assert "| mamba2_780m | decode_32k |" in out and "not a measurement" in out
    rec = json.loads(diff.read_text())
    assert rec["status"] == "ok" and "full_depth" not in rec
    assert rec["corrected"]["flops"] == pytest.approx(
        rec["extrapolated"]["flops"], rel=1e-12)
