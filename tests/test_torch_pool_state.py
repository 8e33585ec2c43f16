"""The port's device form of the page accounting (``serving/pages.py``:
``PoolState``, ``pool_alloc``, ``pool_retain``, ``pool_release``,
``pool_free_count``) against the JAX package's jitted functions
(``repro/serving/pages.py``) and the host ``PagePool``, on the CPU.

Seeded sequences of allocations (lowest free pages first; past the free
count the null page 0), retains (prefix sharing) and releases give the
JAX functions' refcounts and pages after every operation, and the host
pool's wherever it accepts the operation (it raises on an allocation
past the free count and on a double free, where the pure functions
return page 0 and clamp at 0).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import pages as JP
from repro_torch.serving import pages as P


def _check(state, jstate, host=None):
    got = state.refcount.numpy()
    np.testing.assert_array_equal(got, np.asarray(jstate.refcount))
    assert state.refcount.dtype == torch.int32
    assert int(P.pool_free_count(state)) == int(JP.pool_free_count(jstate))
    if host is not None:
        np.testing.assert_array_equal(got, host.refcount)
        assert int(P.pool_free_count(state)) == host.free_pages


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pool_ops_match_jax_and_host_pool(seed):
    rng = np.random.RandomState(seed)
    kv_pages = int(rng.randint(4, 24))
    state = P.make_pool_state(kv_pages, device="cpu")
    jstate = JP.make_pool_state(kv_pages)
    host = P.PagePool(kv_pages)
    held = []  # pages with a reference to drop, one entry a reference
    for _ in range(60):
        op = rng.choice(["alloc", "retain", "release"], p=[0.45, 0.2, 0.35])
        if op == "alloc":
            n = int(rng.randint(1, 5))
            state, pages = P.pool_alloc(state, n)
            jstate, jpages = JP.pool_alloc(jstate, n)
            assert pages.dtype == torch.int32
            np.testing.assert_array_equal(pages.numpy(), np.asarray(jpages))
            if n <= host.free_pages:
                assert host.alloc(n) == pages.tolist()
                held += pages.tolist()
            else:  # the pure functions return the null page past the free
                with pytest.raises(P.PagePoolExhausted):
                    host.alloc(n)
                host = None
                break
        elif op == "retain" and held:
            pages = rng.choice(held, size=min(len(held), 3), replace=False)
            pages = np.append(pages, 0)  # the null page: no-op
            state = P.pool_retain(state, torch.tensor(pages, dtype=torch.int32))
            jstate = JP.pool_retain(jstate, jnp.asarray(pages, jnp.int32))
            host.retain(pages.tolist())
            held += [int(p) for p in pages if p > 0]
        elif op == "release" and held:
            pick = rng.choice(len(held), size=min(len(held), 2), replace=False)
            pages = [held[i] for i in pick]
            if len(set(pages)) < len(pages):
                pages = pages[:1]
            for p in pages:
                held.remove(p)
            pages = np.asarray(pages + [0], np.int32)
            state = P.pool_release(state, torch.tensor(pages))
            jstate = JP.pool_release(jstate, jnp.asarray(pages))
            host.release(pages.tolist())
        _check(state, jstate, host)
    # past the free count: page 0 for the missing ones, no read back
    n = int(P.pool_free_count(state)) + 2
    state, pages = P.pool_alloc(state, n)
    jstate, jpages = JP.pool_alloc(jstate, n)
    np.testing.assert_array_equal(pages.numpy(), np.asarray(jpages))
    assert pages.tolist()[-2:] == [0, 0]
    _check(state, jstate)


def test_pool_release_clamps_at_zero():
    """Releasing a free page changes nothing (the host pool calls it a
    double free), as the reference's clamp does."""
    state = P.make_pool_state(6)
    jstate = JP.make_pool_state(6)
    state, _ = P.pool_alloc(state, 2)
    jstate, _ = JP.pool_alloc(jstate, 2)
    pages = np.asarray([1, 4, 5, 0], np.int32)  # 4 and 5 are free
    state = P.pool_release(state, torch.tensor(pages))
    jstate = JP.pool_release(jstate, jnp.asarray(pages))
    _check(state, jstate)
    assert state.refcount.tolist() == [1, 0, 1, 0, 0, 0]
    with pytest.raises(ValueError, match="kv_pages"):
        P.make_pool_state(1)
