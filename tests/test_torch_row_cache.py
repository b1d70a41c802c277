"""The LRU row cache of the exact SMO solver, against the reference.

The port's cached row entry (``ops.gram_row_cached``) performs the
lookup, the row and the cache's update in one launch on the card; on
the CPU it runs ``rbf_gram.lru_row_plain``, the lookup the chunked
engine runs. Held here: after every call of a seeded sequence of 200
indices (a hot set that repeats, and enough distinct indices to evict
from 8 slots many times), keys, stamps, clock, hits and misses equal
the reference's ``ChunkedKernelEngine`` bit for bit, and each returned
row and the slot store agree with the reference's to the Gram bounds
(tests/test_kernels_pallas.py). tests/test_torch_cuda.py holds the
kernel to this plain path bit for bit in the state on the card.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import kernel_engine as JKE
from repro.core import kernels as JK
from repro_torch.core import kernel_engine as TKE
from repro_torch.core import kernels as TK
from repro_torch.data import make_blobs, normalize
from repro_torch.kernels import ops
from repro_torch.kernels import rbf_gram as G
from torch_helpers import np_, tt

GRAM_TOL = dict(rtol=2e-5, atol=2e-6)
SLOTS = 8


def lookup_sequence(n: int, length: int = 200, seed: int = 0) -> np.ndarray:
    """Indices with repeats (a hot set of 5 rows, 60 % of the calls) and
    evictions (the rest uniform over n >> SLOTS rows)."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(n, 5, replace=False)
    cold = rng.integers(0, n, length)
    return np.where(rng.random(length) < 0.6, rng.choice(hot, length), cold)


def _state(c):
    return [np_(v) for v in (c.keys, c.stamp, c.clock, c.hits, c.misses)]


@pytest.mark.parametrize("mode", ["rbf", "linear"])
@pytest.mark.parametrize("backend", ["chunked", "pallas"])
def test_lru_state_follows_the_reference(backend, mode):
    x, _ = make_blobs(48, 2, 6, sep=1.5, seed=3)
    x = normalize(x)
    kw = dict(name=mode, gamma=0.2)
    jeng = JKE.ChunkedKernelEngine(jnp.asarray(x), JK.KernelParams(**kw),
                                   JKE.EngineConfig(cache_slots=SLOTS))
    teng = TKE.make_engine(tt(x), TK.KernelParams(**kw), TKE.EngineConfig(
        backend=backend, cache_slots=SLOTS))
    jc, tc = jeng.init_cache(), teng.init_cache()
    jrow = jax.jit(jeng.row)   # the reference's solver loop traces it too
    seq = lookup_sequence(len(x))
    for i in seq:
        jr, jc = jrow(jnp.int32(i), jc)
        tr, tc2 = teng.row(torch.tensor(int(i)), tc)
        assert tc2 is tc                 # updated in place
        np.testing.assert_allclose(np_(tr), np_(jr), **GRAM_TOL)
        for got, want in zip(_state(tc), _state(jc)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(np_(tc.rows), np_(jc.rows), **GRAM_TOL)
    hits, misses = int(tc.hits), int(tc.misses)
    assert hits + misses == len(seq) and hits > 60 and misses > 3 * SLOTS


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cached_entry_equals_the_engine_lookup(dtype):
    """ops.gram_row_cached (plain path) leaves the state the chunked
    engine's lookup leaves, and returns the uncached entry's row."""
    rng = np.random.default_rng(1)
    x = tt(rng.normal(size=(70, 9))).to(ops.tile_dtype(dtype))
    x2 = TK.sqnorms(x)

    def fresh():
        return (torch.full((SLOTS,), -1, dtype=torch.int64),
                torch.zeros(SLOTS, dtype=torch.int64),
                torch.zeros((SLOTS, 70)),
                *(torch.zeros((), dtype=torch.int64) for _ in range(3)))

    a, b = fresh(), fresh()
    for i in lookup_sequence(70, seed=2):
        it = torch.tensor(int(i))
        row = ops.gram_row(x, x2, it, gamma=0.1)
        got = ops.gram_row_cached(x, x2, it, *a, gamma=0.1)
        want = G.lru_row_plain(*b, it, lambda j: G.gram_row_plain(
            x, x2, j, gamma=0.1))
        assert torch.equal(got, row) and torch.equal(want, row)
        for u, v in zip(a, b):
            assert torch.equal(u, v)


def test_cached_entry_checks_its_state():
    x = torch.zeros((10, 3))
    x2 = TK.sqnorms(x)
    keys = torch.full((4,), -1, dtype=torch.int64)
    good = dict(keys=keys, stamp=torch.zeros(4, dtype=torch.int64),
                rows=torch.zeros((4, 10)),
                clock=torch.zeros((), dtype=torch.int64),
                hits=torch.zeros((), dtype=torch.int64),
                misses=torch.zeros((), dtype=torch.int64))
    i = torch.tensor(3)
    for name, bad in [("rows", torch.zeros((4, 9))),
                      ("stamp", torch.zeros(4, dtype=torch.int32)),
                      ("clock", torch.zeros(1, dtype=torch.int64)),
                      ("keys", torch.zeros((0,), dtype=torch.int64))]:
        with pytest.raises(ValueError, match="gram_row_cached"):
            ops.gram_row_cached(x, x2, i, **{**good, name: bad})
    with pytest.raises(ValueError, match="one-task"):
        ops.gram_row_cached(x[None], x2[None], i[None], **good)
    ops.reset_launches()
    ops.gram_row_cached(x, x2, i, **good)
    assert ops.launches["rbf_gram_row_cached"] == 0   # plain path on CPU
    assert int(good["misses"]) == 1 and int(good["keys"][0]) == 3
