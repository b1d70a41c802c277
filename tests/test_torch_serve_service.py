"""The port's service layer: ``ServingService``, ``ModelRegistry`` and the
``Predictor`` under concurrency (the cases of
``tests/test_serve_service.py``), on the CPU.

* A service answer is what the underlying predictor serves for the same
  rows: labels exactly, decision values to DF_TOL (on the CPU the
  decision entry runs its plain version, whose float32 sums may round
  otherwise in a merged batch; on the card the kernel gives the same
  bits, which ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` check),
  for any mix of ops, models, row counts and submitter threads; bursts
  coalesce, a full window flushes at once, ``close`` flushes, is
  idempotent, enqueues one sentinel and fails what queued behind it.
* ``ModelRegistry``: LRU eviction order, re-admission serves the same
  bits, explicit evict / unregister / replace / path registration, one
  admission under concurrent ``get``, ``stats`` a snapshot.
* The ``Predictor``: concurrent callers get the serial values and an
  exact row count; warmup keeps concurrent rows' counts; the reference's
  compile guard becomes "``n_programs`` does not grow during a
  mixed-size replay after warmup".
* The slice as a whole against the reference: one quantized pack
  behind both packages' services.
* Every entry point defaults to ``device="cuda"`` and raises without a
  card.
"""
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.data.synth import (make_blobs, make_imbalanced_blobs,
                              make_synth_regression)
from repro_torch import serve
from repro_torch.core.svm import SVC, SVR
from repro_torch.serve import service as service_mod

DF_TOL = dict(rtol=2e-4, atol=1e-4)   # tests/test_torch_serve.py
TIMEOUT = 60                          # seconds any future may take


@pytest.fixture(scope="module")
def binary_problem():
    x, y = make_blobs(30, 2, 4, sep=3.0, seed=0)
    return x, y, SVC(gamma=0.5, device="cpu").fit(x, y)


@pytest.fixture(scope="module")
def ovo_problem():
    x, y = make_imbalanced_blobs([40, 25, 12, 9], 4, sep=3.0, seed=1)
    return x, y, SVC(gamma=0.5, device="cpu").fit(x, y)


@pytest.fixture(scope="module")
def svr_problem():
    x, y = make_synth_regression(60, 5, seed=2)
    return x, y, SVR(gamma=0.5, epsilon=0.05, device="cpu").fit(x, y)


def _service(models, **kw):
    kw.setdefault("engine", "chunked")
    return serve.ServingService(models, device="cpu", **kw)


def _same(got, want, op):
    if op == "predict":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **DF_TOL)


# ---------------------------------------------------------------- service
@pytest.mark.parametrize("engine", ["pallas", "chunked"])
@pytest.mark.parametrize("sv_dtype", ["fp32", "bf16"])
def test_service_matches_predictor_outputs(ovo_problem, engine, sv_dtype):
    x, _, model = ovo_problem
    packed = serve.pack(model, sv_dtype=sv_dtype)
    pred = serve.Predictor(packed, engine=engine,
                           device="cpu").warmup((1, 8, 32))
    with _service(packed, engine=engine, window_ms=5.0) as svc:
        futs = [(svc.submit(x[i:i + 3], op="predict"), "predict", i, 3)
                for i in range(0, 24, 3)]
        futs += [(svc.submit(x[i], op="decision_function"),
                  "decision_function", i, 1) for i in range(24, 30)]
        futs += [(svc.submit(x[i:i + 2], op="values"), "values", i, 2)
                 for i in range(30, 40, 2)]
        for fut, op, i, n in futs:
            got = fut.result(timeout=TIMEOUT)
            _same(got, pred.decode(pred.decision_values(x[i:i + n]), op), op)


def test_service_batches_a_burst(binary_problem):
    x, _, model = binary_problem
    svc = _service(serve.pack(model), window_ms=50.0)
    try:
        svc.predict(x[:1])                       # warm
        futs = [svc.submit(x[i]) for i in range(20)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        s = svc.stats
        assert s["n_requests"] == 21 and s["n_rows"] == 21
        # the burst of 20 coalesced into far fewer decision calls
        assert s["n_batches"] <= 1 + 4
        assert s["max_batch_rows"] >= 8
        assert s["rows_per_batch"] == s["n_rows"] / s["n_batches"]
    finally:
        svc.close()


def test_service_flushes_when_bucket_fills(binary_problem):
    """A full max_batch window dispatches at once, not after the (long)
    batching window."""
    x, _, model = binary_problem
    svc = _service(serve.pack(model), window_ms=10_000.0, max_batch=8)
    try:
        svc.predict(x[:8])                       # warm; full at once
        t0 = time.perf_counter()
        futs = [svc.submit(x[i]) for i in range(8)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        assert time.perf_counter() - t0 < 5.0    # not the 10 s window
        assert svc.stats["n_full_flushes"] >= 2
    finally:
        svc.close()


def test_service_multi_model_routing(binary_problem, svr_problem):
    xc, _, clf = binary_problem
    xr, _, reg_model = svr_problem
    models = {"clf": serve.pack(clf), "reg": serve.pack(reg_model)}
    with _service(models, window_ms=5.0) as svc:
        fc = [svc.submit(xc[i], model="clf") for i in range(8)]
        fr = [svc.submit(xr[i], model="reg") for i in range(8)]
        got_c = np.concatenate([f.result(timeout=TIMEOUT) for f in fc])
        got_r = np.concatenate([f.result(timeout=TIMEOUT) for f in fr])
        assert set(svc.registry.resident) == {"clf", "reg"}
    np.testing.assert_array_equal(got_c, clf.predict(xc[:8]))
    np.testing.assert_allclose(got_r, reg_model.predict(xr[:8]), **DF_TOL)


def test_service_submit_validation(binary_problem):
    x, _, model = binary_problem
    with _service(serve.pack(model), window_ms=0.0) as svc:
        with pytest.raises(KeyError, match="unknown model"):
            svc.submit(x[:2], model="nope")
        with pytest.raises(ValueError, match="op"):
            svc.submit(x[:2], op="proba")
        with pytest.raises(ValueError, match="request"):
            svc.submit(np.zeros((2, 9), np.float32))
        with pytest.raises(ValueError, match="request"):
            svc.submit(np.zeros((0, x.shape[1]), np.float32))
    with pytest.raises(ValueError, match="window_ms"):
        _service(serve.pack(model), window_ms=-1)


def test_service_close_flushes_and_rejects(binary_problem):
    x, _, model = binary_problem
    svc = _service(serve.pack(model), window_ms=200.0)
    futs = [svc.submit(x[i]) for i in range(5)]
    svc.close()                      # mid-window: flushes, never drops
    got = np.concatenate([f.result(timeout=TIMEOUT) for f in futs])
    np.testing.assert_array_equal(got, model.predict(x[:5]))
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(x[:1])
    svc.close()                      # idempotent
    assert not svc._worker.is_alive()


def test_service_over_existing_predictor(binary_problem):
    x, _, model = binary_problem
    pred = serve.Predictor(serve.pack(model), engine="chunked", device="cpu")
    with serve.ServingService(pred, window_ms=1.0, device="cpu") as svc:
        np.testing.assert_array_equal(svc.predict(x[:7]),
                                      model.predict(x[:7]))
        assert svc.registry is None
    assert pred.n_requests >= 7      # served through the shared predictor


def test_service_concurrent_submitters(ovo_problem):
    """More submitter threads than cores, one batcher, a short switch
    interval: every future resolves to exactly its own rows' outputs,
    and the counters lose no update."""
    x, _, model = ovo_problem
    want = model.predict(x)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _service(serve.pack(model), window_ms=2.0) as svc:
            def one(i):
                j = i % (len(x) - 4)
                return j, svc.submit(x[j:j + 4]).result(timeout=TIMEOUT)

            with ThreadPoolExecutor(max_workers=16) as ex:
                for j, got in ex.map(one, range(96)):
                    np.testing.assert_array_equal(got, want[j:j + 4])
            s = svc.stats
    finally:
        sys.setswitchinterval(interval)
    assert s["n_requests"] == 96 and s["n_rows"] == 4 * 96
    assert s["n_window_flushes"] + s["n_full_flushes"] >= s["n_batches"]


# --------------------------------------------------------------- registry
def test_registry_lru_eviction_and_readmission(binary_problem, ovo_problem):
    xa, _, ma = binary_problem
    _, _, mb = ovo_problem
    reg = serve.ModelRegistry(max_resident=2, engine="pallas",
                              warmup_sizes=(4,), device="cpu")
    reg.register("a", serve.pack(ma))
    reg.register("b", serve.pack(mb))
    reg.register("c", serve.pack(ma, sv_dtype="fp16"))
    va = reg.get("a").decision_values(xa[:4])
    reg.get("b")
    assert reg.resident == ("a", "b")
    reg.get("a")                              # refresh recency
    assert reg.resident == ("b", "a")
    reg.get("c")                              # evicts b (LRU), not a
    assert reg.resident == ("a", "c")
    assert reg.stats == {"hits": 1, "admissions": 3, "evictions": 1}
    assert reg.get("c")._banks[0][0].dtype == torch.float16
    # evict + re-admit serves the same bits (same host pack)
    reg.get("b")                              # evicts a
    assert "a" not in reg.resident
    np.testing.assert_array_equal(reg.get("a").decision_values(xa[:4]), va)


def test_registry_explicit_evict_and_unregister(binary_problem):
    _, _, model = binary_problem
    reg = serve.ModelRegistry(max_resident=2, engine="chunked",
                              device="cpu")
    reg.register("m", serve.pack(model))
    assert reg.evict("m") is False            # never admitted
    reg.get("m")
    assert reg.evict("m") is True and reg.resident == ()
    assert "m" in reg and len(reg) == 1       # host arrays survive
    assert reg.names == ("m",) and reg.model("m").n_tasks == 1
    reg.unregister("m")
    assert "m" not in reg
    with pytest.raises(KeyError, match="not registered"):
        reg.get("m")
    with pytest.raises(ValueError, match="max_resident"):
        serve.ModelRegistry(max_resident=0, device="cpu")


def test_registry_register_replace_and_path(binary_problem, tmp_path):
    x, _, model = binary_problem
    path = tmp_path / "m.npz"
    serve.save(path, serve.pack(model, sv_dtype="bf16"))
    reg = serve.ModelRegistry(engine="chunked", device="cpu")
    reg.register("m", path)                   # path form loads (v3 here)
    first = reg.get("m")
    assert first.model.sv_dtype == "bf16"
    with pytest.raises(ValueError, match="already registered"):
        reg.register("m", serve.pack(model))
    reg.register("m", serve.pack(model), replace=True)
    assert reg.resident == ()                 # replace evicts residency
    second = reg.get("m")
    assert second is not first and second.model.sv_dtype == "fp32"


def test_registry_thread_safe_admission(binary_problem):
    _, _, model = binary_problem
    reg = serve.ModelRegistry(max_resident=1, engine="chunked",
                              warmup_sizes=(), device="cpu")
    reg.register("m", serve.pack(model))
    with ThreadPoolExecutor(max_workers=8) as ex:
        preds = list(ex.map(lambda _: reg.get("m"), range(32)))
    assert all(p is preds[0] for p in preds)  # admitted exactly once
    assert reg.stats["admissions"] == 1 and reg.stats["hits"] == 31


def test_registry_stats_is_a_snapshot(binary_problem):
    _, _, model = binary_problem
    reg = serve.ModelRegistry(engine="chunked", warmup_sizes=(),
                              device="cpu")
    reg.register("m", serve.pack(model))
    reg.get("m")
    s = reg.stats
    s["admissions"] = 999                    # the caller's copy
    s["bogus"] = 1
    assert reg.stats == {"hits": 0, "admissions": 1, "evictions": 0}
    assert reg.stats is not reg.stats


# ---------------------------------------------------------- thread safety
def test_predictor_concurrent_decision_values(ovo_problem):
    """Concurrent callers get the serial values exactly and the served-
    row counter is the exact total."""
    x, _, model = ovo_problem
    pred = serve.Predictor(serve.pack(model), engine="pallas", device="cpu")
    pred.warmup(batch_sizes=(4, 16))
    slices = [(i % 40, 4 + (i % 3) * 12) for i in range(48)]
    want = {(s, n): pred.decision_values(x[s:s + n]) for s, n in
            set(slices)}
    served0 = pred.n_requests
    barrier = threading.Barrier(8)
    errors = []

    def worker(idx):
        try:
            barrier.wait(timeout=30)
            for k in range(idx, len(slices), 8):
                s, n = slices[k]
                np.testing.assert_array_equal(
                    pred.decision_values(x[s:s + n]), want[(s, n)])
        except (AssertionError, threading.BrokenBarrierError) as e:
            errors.append(e)                 # reported on the main thread

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert pred.n_requests == served0 + sum(n for _, n in slices)


def test_predictor_decode_validates_op(binary_problem):
    _, _, model = binary_problem
    pred = serve.Predictor(serve.pack(model), engine="chunked", device="cpu")
    df = pred.decision_values(np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match="op"):
        pred.decode(df, "proba")


def test_warmup_concurrent_requests_keep_their_counts(binary_problem):
    """warmup subtracts exactly its own synthetic rows under the lock, so
    rows real callers served meanwhile keep their counts."""
    x, _, model = binary_problem
    pred = serve.Predictor(serve.pack(model), engine="chunked", device="cpu")
    pred.decision_values(x[:3])
    assert pred.n_requests == 3
    rows = [0]
    stop = threading.Event()
    started = threading.Event()

    def real_traffic():
        started.set()
        while not stop.is_set():
            pred.decision_values(x[:2])
            rows[0] += 2

    t = threading.Thread(target=real_traffic)
    t.start()
    try:
        started.wait(timeout=30)
        pred.warmup((1, 4, 16, 64))          # overlaps the live traffic
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert pred.n_requests == 3 + rows[0]


# ----------------------------------------------- lock-discipline regressions
def test_service_racing_closers_enqueue_one_sentinel(binary_problem):
    """Racing close() calls elect one closer under the stats lock, so
    exactly one sentinel is enqueued."""
    _, _, model = binary_problem
    packed = serve.pack(model)
    for _ in range(4):                       # give the race some chances
        svc = _service(packed, window_ms=0.0)
        sentinels = []
        orig_put = svc._q.put

        def put(item, *a, _orig=orig_put, _log=sentinels, **k):
            if item is service_mod._SENTINEL:
                _log.append(item)
            return _orig(item, *a, **k)

        svc._q.put = put
        barrier = threading.Barrier(6)

        def closer():
            barrier.wait(timeout=30)
            svc.close()

        threads = [threading.Thread(target=closer) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert len(sentinels) == 1
        with pytest.raises(RuntimeError, match="closed"):
            svc.submit(np.zeros((1, packed.n_features), np.float32))


def test_service_submitters_racing_close_never_hang(binary_problem):
    """Futures issued around a racing close() all terminate: a result, a
    closed-service rejection at submit, or 'closed before dispatch'."""
    x, _, model = binary_problem
    want = model.predict(x)
    svc = _service(serve.pack(model), window_ms=1.0)
    svc.predict(x[:1])                       # warm
    futs: list = []
    barrier = threading.Barrier(5)

    def submitter(i):
        barrier.wait(timeout=30)
        for j in range(25):
            try:
                futs.append((svc.submit(x[(i + j) % len(x)]), i, j))
            except RuntimeError:             # service closed: expected
                return

    def closer():
        barrier.wait(timeout=30)
        time.sleep(0.005)
        svc.close()

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(4)] + [threading.Thread(target=closer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    for fut, i, j in futs:
        try:
            got = fut.result(timeout=TIMEOUT)
            np.testing.assert_array_equal(got, want[(i + j) % len(x)][None])
        except RuntimeError as e:
            assert "closed" in str(e)


# ------------------------------------------------ the program-shape ledger
@pytest.mark.parametrize("engine", ["pallas", "chunked"])
def test_service_replay_keeps_the_program_count(ovo_problem, engine):
    """After warmup at the covering buckets, a burst of odd-sized
    requests through the service adds no (bank, batch bucket) program
    shape: ``n_programs`` does not grow."""
    x, _, model = ovo_problem
    with _service(serve.pack(model, sv_dtype="fp16"), engine=engine,
                  window_ms=2.0) as svc:
        # merged windows reach ~120 rows: the 128 bucket
        for t in (1, 2, 4, 8, 16, 32, 64, len(x)):
            svc.predict(x[:t])
        pred = svc.registry.get("default")
        warm = pred.n_programs
        futs = [svc.submit(x[i % 30:i % 30 + 1 + i % 5]) for i in range(40)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        assert pred.n_programs == warm


# -------------------------------------------- the slice against the reference
@pytest.mark.parametrize("sv_dtype", ["fp16", "bf16"])
def test_service_over_quantized_pack_matches_reference(ovo_problem, tmp_path,
                                                       sv_dtype):
    """A reference v3 artifact behind both packages' services: labels
    equal, decision values within DF_TOL."""
    x, y, _ = ovo_problem
    from repro.core.svm import SVC as JSVC
    path = tmp_path / "q.npz"
    jserve.save(path, jserve.pack(JSVC(solver="smo", gamma=0.5).fit(x, y),
                                  sv_dtype=sv_dtype))
    reg = serve.ModelRegistry(engine="pallas", device="cpu")
    reg.register("q", path)
    with serve.ServingService(reg, window_ms=2.0, device="cpu") as svc, \
            jserve.ServingService(jserve.load(path), engine="chunked",
                                  window_ms=2.0) as ref:
        for op in ("predict", "values"):
            got = [svc.submit(x[i:i + 3], model="q", op=op)
                   for i in range(0, 60, 3)]
            want = [ref.submit(x[i:i + 3], op=op) for i in range(0, 60, 3)]
            for g, w in zip(got, want):
                _same(g.result(timeout=TIMEOUT), w.result(timeout=TIMEOUT),
                      op)


# ------------------------------------------------------------------ devices
def test_entry_points_default_to_the_card(binary_problem, monkeypatch):
    """Predictor, ModelRegistry and ServingService take device="cuda" by
    default and raise without a card; a service refuses models that run
    on another device than its own."""
    _, _, model = binary_problem
    packed = serve.pack(model)
    cpu_pred = serve.Predictor(packed, engine="chunked", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: serve.Predictor(packed),
                 lambda: serve.ModelRegistry(),
                 lambda: serve.ServingService(packed),
                 lambda: serve.ServingService(cpu_pred)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="runs on cpu|run on cpu"):
        serve.ServingService(cpu_pred)
