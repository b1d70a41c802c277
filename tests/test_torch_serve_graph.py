"""The ``Predictor``'s decide programs: one a batch bucket, a CUDA graph
on the card.

A ``serve.Predictor`` serves each slice of a request through its
bucket's program: the padded rows copied into static buffers, the
program run (on the card, for the kernel route and low-rank packs, one
replay of a CUDA graph captured at the bucket's first call), and the
(n_tasks, bucket) output read back once. A graph replays on the tensors
it captured, so a static buffer rebound anywhere, or split-launch
scratch shared with another graph, gives wrong numbers without raising.

CPU part (runs everywhere; nothing is captured on the CPU):

* the program function, run eagerly, against the JAX reference's
  ``Predictor.decision_values`` on the same pack (saved by the port,
  loaded by the reference): binary, OvO (with an empty-SV bank), OvR,
  SVR, fp16 and bf16 OvO, a linear-kernel pack (the plain path),
  Nystrom and RFF packs; every bucket of the ladder and a request
  longer than ``max_batch``; decisions within the serving tolerance of
  ``tests/test_torch_serve.py``, labels equal, and ``n_programs`` equal
  to the reference's. The JAX side is imported inside the fixture and
  skips where torch sees a card (the reference is the CPU oracle);
* the programs' static buffers keep their storage (``data_ptr``) over
  calls; a predictor's own split-launch scratch holds every plan of the
  ladder; eight threads of mixed sizes on one predictor give the serial
  results; ``predictor.CUDA_GRAPHS`` off and on give equal results;
  nothing is captured.

Card part (``requires_cuda``; skips here with a reason), at widths that
split the decision kernel's SV axis: graph against eager
(``CUDA_GRAPHS`` off) bit for bit at every bucket for each pack kind,
with equal ``ops.launches``; one capture a warmed bucket and none after
(``CompileGuard``); two predictors warmed on one thread replayed from
two threads at once; captures on one thread beside replays on another;
an eviction frees the graphs' memory. On the
machine with the card::

    PYTHONPATH=src python -m pytest -q tests/test_torch_serve_graph.py
"""
import contextlib
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.analysis import CompileGuard
from repro_torch.core import kernels as TK
from repro_torch.kernels import decision as D
from repro_torch.kernels import ops
from repro_torch.serve import predictor as P
from repro_torch import serve as tserve
from torch_helpers import cuda  # noqa: F401  (fixture)

DECISION_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_torch_serve.py
MAX_BATCH = 16
# a request a bucket of the ladder (1 .. 16), then one past max_batch
# (slices of 16, 16 and 5 -> bucket 8)
SIZES = (1, 2, 3, 7, 16, 37)
KINDS = ("binary", "ovo", "ovr", "svr", "ovo_fp16", "ovo_bf16", "linear",
         "nystrom", "rff")
SV_KINDS = ("binary", "ovo", "ovr", "svr", "ovo_fp16", "ovo_bf16")


def _bucket(rng, ids, w, counts, d, spread):
    """A serving bucket of tasks ``ids`` at SV width ``w``: the real SVs
    of each task first, zero-padded past its count."""
    t = len(ids)
    sv = np.zeros((t, w, d), np.float32)
    coef = np.zeros((t, w), np.float32)
    for i, c in enumerate(counts):
        sv[i, :c] = rng.normal(0.0, spread, (c, d))
        coef[i, :c] = rng.normal(0.0, 1.0, c)
    return tserve.TaskBucket(
        task_ids=np.asarray(ids, np.int64), sv_x=sv, sv_coef=coef,
        b=rng.normal(0.0, 0.3, t).astype(np.float32),
        sv_counts=np.asarray(counts, np.int64))


def _ovo_pairs(m):
    return np.array([(i, j) for i in range(m) for j in range(i + 1, m)],
                    np.int64)


def make_pack(kind, *, d=7, wide=1, seed=0):
    """A seeded pack of ``kind`` over d features; ``wide`` scales the
    SV widths (the card cases take widths past one 64-SV tile)."""
    rng = np.random.default_rng(seed)
    kp = TK.KernelParams(name="linear" if kind == "linear" else "rbf",
                         gamma=1.0 / d)
    spread = 1.0

    def bucket(ids, w, counts):
        return _bucket(rng, ids, w * wide, [c * wide for c in counts], d,
                       spread)

    if kind in ("binary", "linear", "svr"):
        g = bucket([0], 16, [13])
        svr = kind == "svr"
        return tserve.PackedModel(
            kind="svr" if svr else "svc", kernel=kp, n_features=d,
            n_tasks=1, buckets=(g,), strategy="svr" if svr else "binary",
            classes=None if svr else np.array([3, 8]),
            pairs=None if svr else np.array([[1, 0]], np.int64))
    if kind.startswith("ovo"):
        # six tasks of four classes: a T = 3 bank, a T = 2 bank and an
        # empty-SV bank (a task whose SVs all fell out: its bias alone)
        buckets = (bucket([0, 3, 5], 16, [16, 11, 9]),
                   bucket([1, 2], 8, [8, 5]),
                   _bucket(rng, [4], 0, [0], d, spread))
        pack = tserve.PackedModel(
            kind="svc", kernel=kp, n_features=d, n_tasks=6, buckets=buckets,
            strategy="ovo", decision="vote", classes=np.arange(4) * 10,
            pairs=_ovo_pairs(4))
        return pack if kind == "ovo" else tserve.quantize(
            pack, kind.split("_")[1])
    if kind == "ovr":
        buckets = (bucket([2, 0], 16, [12, 15]), bucket([1], 4, [4]))
        return tserve.PackedModel(
            kind="svc", kernel=kp, n_features=d, n_tasks=3, buckets=buckets,
            strategy="ovr", decision="vote", classes=np.array([1, 2, 5]),
            pairs=np.array([[0, -1], [1, -1], [2, -1]], np.int64))
    rank = 12 * wide
    if kind == "nystrom":
        fm = tserve.LowRankMap(
            kind="nystrom",
            a=rng.normal(0.0, spread, (10 * wide, d)).astype(np.float32),
            b=rng.normal(0.0, 0.5, (10 * wide, rank)).astype(np.float32))
        n_tasks, strategy = 1, "binary"
    else:   # rff: an OvO pack of four classes
        fm = tserve.LowRankMap(
            kind="rff",
            a=rng.normal(0.0, np.sqrt(2.0 * kp.gamma),
                         (d, rank)).astype(np.float32),
            b=rng.uniform(0.0, 2 * np.pi, rank).astype(np.float32))
        n_tasks, strategy = 6, "ovo"
    return tserve.PackedModel(
        kind="svc", kernel=kp, n_features=d, n_tasks=n_tasks, buckets=(),
        strategy=strategy, decision="vote",
        classes=np.arange(4 if strategy == "ovo" else 2),
        pairs=(_ovo_pairs(4) if strategy == "ovo"
               else np.array([[1, 0]], np.int64)),
        feature_map=fm,
        linear_w=rng.normal(0.0, 1.0, (n_tasks, rank)).astype(np.float32),
        linear_b=rng.normal(0.0, 0.3, n_tasks).astype(np.float32))


def rows(n, d=7, seed=1):
    return np.random.default_rng(seed).normal(0.0, 1.0, (n, d)) \
        .astype(np.float32)


@contextlib.contextmanager
def graphs(on: bool):
    saved = P.CUDA_GRAPHS
    P.CUDA_GRAPHS = on
    try:
        yield
    finally:
        P.CUDA_GRAPHS = saved


def _captures(guard) -> int:
    return sum(e.startswith("cuda graph capture") for e in guard.compiled)


# ------------------------------------------------------------- CPU part
@pytest.fixture
def ref():
    """The JAX reference's serving package on the CPU, imported when a
    test runs; skipped where torch sees a card (the reference is the CPU
    oracle, and a JAX beside a card would run on it)."""
    if torch.cuda.is_available():
        pytest.skip("the reference parity cases run on a machine without "
                    "a card (JAX on the CPU)")
    pytest.importorskip("jax")
    from repro import serve as jserve
    return jserve


@pytest.mark.parametrize("kind", KINDS)
def test_program_matches_reference_every_bucket(tmp_path, ref, kind):
    pack = make_pack(kind)
    path = tmp_path / f"{kind}.npz"
    tserve.save(path, pack)
    want = ref.Predictor(ref.load(path), max_batch=MAX_BATCH)
    engines = ("pallas", "chunked") if kind in SV_KINDS else ("pallas",)
    x = rows(40)
    for engine in engines:
        got = tserve.Predictor(tserve.load(path), engine=engine,
                               max_batch=MAX_BATCH, device="cpu")
        for n in SIZES:
            np.testing.assert_allclose(got.decision_values(x[:n]),
                                       want.decision_values(x[:n]),
                                       err_msg=f"{engine} {n} rows",
                                       **DECISION_TOL)
            if pack.kind == "svc":   # an SVR's predict is its values
                np.testing.assert_array_equal(got.predict(x[:n]),
                                              want.predict(x[:n]))
        assert got.n_programs == want.n_programs, engine
        assert sorted(got._programs) == [1, 2, 4, 8, 16]


def test_empty_sv_bank_serves_its_bias():
    pack = make_pack("ovo")
    empty = next(g for g in pack.buckets if g.sv_x.shape[1] == 0)
    pred = tserve.Predictor(pack, engine="pallas", max_batch=MAX_BATCH,
                            device="cpu")
    df = pred.decision_values(rows(37))
    np.testing.assert_array_equal(
        df[empty.task_ids], np.broadcast_to(empty.b[:, None], (1, 37)))
    # the ledger, as the reference's: only the banks with SVs
    assert pred.n_programs == 2 * 2   # (2 banks) x buckets 16 and 8


def test_program_buffers_keep_their_storage():
    """Each bucket's static rows and output (and their host staging) are
    made once and written in place by every later call of any size."""
    pred = tserve.Predictor(make_pack("ovo"), engine="pallas",
                            max_batch=MAX_BATCH, device="cpu")
    x = rows(64)
    pred.warmup(SIZES)
    ptrs = {b: tuple(t.data_ptr() for t in (p.z, p.out, p.z_host,
                                            p.out_host))
            for b, p in pred._programs.items()}
    first = {n: pred.decision_values(x[:n]) for n in SIZES}
    for n in (5, 37, 1, 64, 16, 2, 3):
        df = pred.decision_values(x[:n])
        if n in first:
            np.testing.assert_array_equal(df, first[n])
    assert {b: tuple(t.data_ptr() for t in (p.z, p.out, p.z_host,
                                            p.out_host))
            for b, p in pred._programs.items()} == ptrs
    # the program function itself, on fresh buffers, gives those bits
    prog = pred._programs[8]
    out = torch.zeros_like(prog.out)
    pred._decide(torch.from_numpy(np.pad(x[32:37], ((0, 3), (0, 0)))), out)
    np.testing.assert_array_equal(out.numpy()[:, :5], first[37][:, 32:])


def test_eight_threads_of_mixed_sizes_give_the_serial_results():
    pred = tserve.Predictor(make_pack("ovr"), engine="pallas",
                            max_batch=MAX_BATCH, device="cpu")
    x = rows(64)
    sizes = (1, 3, 16, 37, 5, 64, 2, 9)
    want = {n: pred.decision_values(x[:n]) for n in sizes}
    errors = []

    def worker(k):
        try:
            for n in sizes[k:] + sizes[:k]:
                np.testing.assert_array_equal(pred.decision_values(x[:n]),
                                              want[n])
        except AssertionError as e:   # reported below, on the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors
    assert pred.n_requests == 9 * sum(sizes)


@pytest.mark.parametrize("t,w", [(1, 17), (6, 986), (3, 3792), (36, 200),
                                 (2, 64 * 64 * 3 + 5)])
def test_own_scratch_holds_every_plan(t, w):
    """A predictor's own split-launch scratch, made once at max_batch,
    holds what ``decision.scratch`` asks of any plan (row tile, split
    count) at any bucket of the ladder: a capture never has to grow it
    (which raises inside a capture)."""
    partial, ticket = D.own_scratch([(1, 5), (t, w)], 1024, "cpu")
    assert not ticket.any()
    for nt in (1 << k for k in range(11)):
        segments = D.decision_plan(nt, t, w, 102).segments
        for rows in (64, 128):
            for splits in range(2, segments + 1):
                plan = D.plan_with(nt, t, w, 102, rows, splits)
                assert 2 * t * plan.segments * nt <= partial.numel()
                assert t * -(-nt // plan.rows) <= ticket.numel()


@pytest.mark.parametrize("kind", ["ovo", "rff"])
def test_graph_switch_gives_equal_results_on_cpu(kind):
    x = rows(40)
    got = {}
    for on in (True, False):
        with graphs(on):
            pred = tserve.Predictor(make_pack(kind), engine="pallas",
                                    max_batch=MAX_BATCH, device="cpu")
        assert pred._graphed is False   # the CPU never captures
        got[on] = [pred.decision_values(x[:n]) for n in SIZES]
    for a, b in zip(got[True], got[False]):
        np.testing.assert_array_equal(a, b)


def test_cpu_captures_nothing():
    pred = tserve.Predictor(make_pack("rff"), max_batch=MAX_BATCH,
                            device="cpu")
    with CompileGuard(budget=100) as g:
        pred.warmup(SIZES)
        pred.predict(rows(37))
    assert _captures(g) == 0
    assert pred.graph_stats["captures"] == 0
    assert all(p.graph is None for p in pred._programs.values())
    assert sum(e.startswith("predictor program") for e in g.compiled) == 5


# ------------------------------------------------------------ card part
CARD_D = 102
CARD_WIDE = 64   # SV widths 64 x (4 .. 16): several segments a bank
CARD_MAX_BATCH = 256
CARD_SIZES = (1, 2, 3, 5, 9, 17, 33, 65, 129, 256, 600)


def card_pack(kind):
    return make_pack(kind, d=CARD_D, wide=CARD_WIDE if kind in SV_KINDS
                     else 8)


def card_rows(n, seed=1):
    return rows(n, CARD_D, seed)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["binary", "ovo", "ovr", "svr", "ovo_fp16",
                                  "ovo_bf16", "nystrom", "rff"])
def test_graph_equals_eager_bit_for_bit(cuda, kind):  # noqa: F811
    """Every bucket served by a replay gives the eager program's bits and
    counts its launches; a warmed bucket is captured once, and nothing
    is captured after warmup."""
    pack, x = card_pack(kind), card_rows(max(CARD_SIZES))
    runs = {}
    for on in (True, False):
        with graphs(on):
            pred = tserve.Predictor(pack, engine="pallas",
                                    max_batch=CARD_MAX_BATCH, device=cuda)
        with CompileGuard(budget=1000) as warm:
            pred.warmup(CARD_SIZES)
        torch.cuda.synchronize()
        ops.reset_launches()
        with CompileGuard(budget=0, note="warm predictor"):
            dfs = [torch.from_numpy(pred.decision_values(x[:n]))
                   for n in CARD_SIZES]
        torch.cuda.synchronize()
        runs[on] = (dfs, dict(ops.launches), _captures(warm),
                    pred.graph_stats)
    (g_dfs, g_launch, g_caps, g_stats), (e_dfs, e_launch, e_caps, _) = \
        runs[True], runs[False]
    for n, a, b in zip(CARD_SIZES, g_dfs, e_dfs):
        assert torch.equal(a, b), f"{kind}: {n} rows"
    assert g_launch == e_launch
    # every route but the Nystrom map's (a plain torch Gram) launches
    # a kernel of the port
    assert any(g_launch.values()) == (kind != "nystrom")
    n_buckets = len({min(CARD_MAX_BATCH, 1 << (n - 1).bit_length())
                     for n in CARD_SIZES})
    assert g_caps == g_stats["captures"] == n_buckets and e_caps == 0
    assert g_stats["replays"] >= len(CARD_SIZES)


@pytest.mark.requires_cuda
def test_two_predictors_replayed_from_two_threads(cuda):  # noqa: F811
    """Two predictors captured on one thread (one capture stream) own
    their split-launch scratch: replayed at once from two threads, each
    gives its serial bits."""
    preds = [tserve.Predictor(card_pack(k), engine="pallas",
                              max_batch=CARD_MAX_BATCH, device=cuda)
             .warmup(CARD_SIZES) for k in ("ovo", "ovr")]
    x = card_rows(max(CARD_SIZES))
    want = [{n: p.decision_values(x[:n]) for n in CARD_SIZES} for p in preds]
    errors = []

    def worker(k):
        try:
            for _ in range(20):
                for n in CARD_SIZES:
                    np.testing.assert_array_equal(
                        preds[k].decision_values(x[:n]), want[k][n])
        except AssertionError as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and not errors
    assert all(p.graph_stats["replays"] > 20 * len(CARD_SIZES)
               for p in preds)


@pytest.mark.requires_cuda
def test_captures_beside_replays_on_another_thread(cuda):  # noqa: F811
    """New predictors warmed (captured) on this thread while another
    thread replays a warm one: every replay keeps its bits and every
    capture succeeds."""
    warm = tserve.Predictor(card_pack("ovo"), engine="pallas",
                            max_batch=CARD_MAX_BATCH, device=cuda)
    warm.warmup(CARD_SIZES)
    x = card_rows(max(CARD_SIZES))
    want = {n: warm.decision_values(x[:n]) for n in CARD_SIZES}
    stop, errors, served = threading.Event(), [], [0]

    def replays():
        try:
            while not stop.is_set():
                for n in CARD_SIZES:
                    np.testing.assert_array_equal(warm.decision_values(x[:n]),
                                                  want[n])
                    served[0] += 1
        except Exception as e:   # noqa: BLE001 -- reported on this thread
            errors.append(e)

    th = threading.Thread(target=replays)
    th.start()
    captured = []
    try:
        for kind in ("ovr", "rff", "ovo_bf16", "binary"):
            pred = tserve.Predictor(card_pack(kind), engine="pallas",
                                    max_batch=CARD_MAX_BATCH, device=cuda)
            pred.warmup(CARD_SIZES)
            captured.append(pred.graph_stats["captures"])
    except Exception as e:   # noqa: BLE001 -- reported with the other's
        errors.append(e)
    finally:
        stop.set()
        th.join(timeout=120)
    assert not th.is_alive() and not errors, errors
    assert captured == [9] * 4 and served[0] > 0


@pytest.mark.requires_cuda
def test_eviction_frees_the_graphs_memory(cuda):  # noqa: F811
    """An evicted predictor's banks, buffers, graphs and pool go: the
    allocated and (after ``empty_cache``) reserved bytes fall back to
    where they were before its admission."""
    reg = tserve.ModelRegistry(max_resident=1, engine="pallas",
                               max_batch=CARD_MAX_BATCH, device=cuda,
                               warmup_sizes=CARD_SIZES)
    reg.register("ovo", card_pack("ovo"))
    reg.register("rff", card_pack("rff"))
    levels = []
    for _ in range(2):   # the second cycle finds every shared cache made
        for name in ("ovo", "rff"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = (torch.cuda.memory_allocated(),
                      torch.cuda.memory_reserved())
            pred = reg.get(name)
            assert pred.graph_stats["captures"] > 0
            del pred
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            assert reg.evict(name)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            levels.append((before, held, (torch.cuda.memory_allocated(),
                                          torch.cuda.memory_reserved())))
    for before, held, after in levels[2:]:
        assert held > before[0]
        assert after == before
