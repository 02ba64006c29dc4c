"""The port's paged-KV bookkeeping against the JAX package's, op for op.

``repro_torch.kvcache`` (allocator, block tables, Algorithm 3) and
``repro_torch.serve.scheduler`` are numpy copies of the JAX package's
modules; here both packages run one seeded op sequence — allocation under
churn, growth, frees, bad-page retirement, admission with preemption — and
every observable must be equal (integers and lists: tolerance 0).
"""
import numpy as np
import pytest

from repro.kvcache import allocator as j_alloc
from repro.kvcache import block_table as j_bt
from repro.serve import scheduler as j_sched
from repro_torch.kvcache import allocator as t_alloc
from repro_torch.kvcache import block_table as t_bt
from repro_torch.serve import scheduler as t_sched


def _observe(a, max_pages):
    return dict(
        tables={r: a.block_table(r, max_pages).tolist() for r in a.seqs},
        blocks={r: list(s.blocks) for r, s in a.seqs.items()},
        hist=a.contiguity_histogram(),
        util=a.utilization(),
        snap=a.snapshot_state())


def _churn(mod, seed, policy, n_pages=256, n_ops=120):
    """One seeded op sequence on one package's allocator; returns what it
    observed after every op."""
    rng = np.random.default_rng(seed)
    a = mod.PagedKVAllocator(n_pages, max_order=6, alloc_policy=policy)
    seen, live, nxt = [], [], 0
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.45 or not live:
            r = a.allocate(nxt, int(rng.integers(1, 24)))
            seen.append(("alloc", nxt, r is not None))
            if r is not None:
                live.append(nxt)
            nxt += 1
        elif op < 0.65:
            rid = live[int(rng.integers(len(live)))]
            seen.append(("extend", rid, a.extend(rid, int(rng.integers(1, 6)))))
        elif op < 0.9:
            rid = live.pop(int(rng.integers(len(live))))
            a.free(rid)
            seen.append(("free", rid))
        else:
            pages = [int(p) for p in rng.integers(0, n_pages, size=4)]
            seen.append(("owners", a.owners_of(pages)))
            seen.append(("retire", a.retire_pages(pages)))
        seen.append(_observe(a, 64))
    return seen


@pytest.mark.parametrize("policy", ["buddy_best", "page"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_jax_under_churn(seed, policy):
    assert _churn(t_alloc, seed, policy) == _churn(j_alloc, seed, policy)


def test_allocator_restore_round_trip():
    a = t_alloc.PagedKVAllocator(128, max_order=5)
    for i in range(6):
        a.allocate(i, 3 + 2 * i)
    a.free(2)
    snap = a.snapshot_state()
    b = t_alloc.PagedKVAllocator(128, max_order=5)
    b.restore_state(snap)
    assert _observe(a, 32) == _observe(b, 32)
    assert a.allocate(99, 9).pages == b.allocate(99, 9).pages


def _tables(seed, B=4, n_pages=256, max_pages=48):
    rng = np.random.default_rng(seed)
    a = t_alloc.PagedKVAllocator(n_pages, max_order=6,
                                 alloc_policy="buddy_best")
    for i in range(12):
        a.allocate(100 + i, int(rng.integers(1, 9)))
    for i in range(12):
        if rng.random() < 0.5:
            a.free(100 + i)
    rows = []
    for b in range(B):
        a.allocate(b, int(rng.integers(1, max_pages)))
        rows.append(a.block_table(b, max_pages))
    return np.stack(rows), a.contiguity_histogram()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_descriptor_tables_match_jax(seed):
    bt, hist = _tables(seed)
    for psi in (1, 2, 3, 4):
        K = t_bt.choose_kernel_classes(hist, psi=psi)
        assert K == j_bt.choose_kernel_classes(hist, psi=psi)
        for k in range(4):
            for row in bt:
                np.testing.assert_array_equal(
                    t_bt.window_coverage(row, k), j_bt.window_coverage(row, k))
        for row in bt:
            ta, ja = t_bt.assign_classes(row, K), j_bt.assign_classes(row, K)
            assert ta.keys() == ja.keys()
            for k in ta:
                np.testing.assert_array_equal(ta[k], ja[k])
        td, jd = t_bt.descriptor_tables(bt, K), j_bt.descriptor_tables(bt, K)
        assert td.keys() == jd.keys()
        for k in td:
            for x, y in zip(td[k], jd[k]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        assert (t_bt.dma_descriptor_count(bt, K)
                == j_bt.dma_descriptor_count(bt, K))


def _schedule(sched_mod, alloc_mod, seed):
    """Admission, preemption and release on a small pool, with the event
    tap recording every mapping change."""
    rng = np.random.default_rng(seed)
    a = alloc_mod.PagedKVAllocator(64, max_order=5)
    events = []
    s = sched_mod.KVScheduler(a, 3, event_tap=lambda k, r: events.append(
        (k, r)))
    need = {r: int(rng.integers(4, 30)) for r in range(10)}
    for r in range(10):
        s.enqueue(r)
    seen = []
    for _ in range(30):
        adm = s.admit(need.__getitem__,
                      on_admit=lambda r: events.append(("on_admit", r)),
                      on_preempt=lambda r: events.append(("on_preempt", r)))
        seen.append((adm, list(s.waiting), list(s.running), dict(s.slots),
                     s.preemptions, s.snapshot_state()))
        if s.running and rng.random() < 0.6:
            s.release(s.running[int(rng.integers(len(s.running)))])
        if not s.has_work:
            break
    return seen, events


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_matches_jax(seed):
    assert (_schedule(t_sched, t_alloc, seed)
            == _schedule(j_sched, j_alloc, seed))
