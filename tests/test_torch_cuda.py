"""The CUDA TLB-sweep kernel against its plain PyTorch version, on the card.

Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when
``torch.cuda.is_available()`` is False (decided in the fixture, never at
import, so every xdist worker collects the same tests).  On a machine with
a card run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The kernel must equal the plain version bit for bit — counters, coverage
samples and the whole ``[L, T]`` ppn array — on static, dynamic,
multi-tenant, nested and parity-fault batches covering all 10 method kinds
and every policy knob, and it must count one launch per batch.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from _torch_helpers import WORLDS, pkg, world_cells
from repro_torch.core.lane_program import needs_switch_pass
from repro_torch.core.sweep import batches_of, pack_batch, run_sweep
from repro_torch.kernels.tlb_sweep import LAUNCHES, run_lanes, run_lanes_ref
from repro_torch.kernels.tlb_sweep.ops import as_tensors

pytestmark = pytest.mark.cuda

P = pkg(tcore)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _kernel_vs_plain(cells, dev):
    switched = False
    for group in batches_of(cells, range(len(cells))):
        lanes, stacks, st0, sb = pack_batch([cells[i] for i in group])
        switched |= needs_switch_pass(lanes)
        lt, stt, s0t = as_tensors(lanes, stacks, st0, dev)
        n0 = LAUNCHES["tlb_sweep"]
        k_st, k_pp = run_lanes(lt, stt, s0t, sb)
        torch.cuda.synchronize()
        assert LAUNCHES["tlb_sweep"] == n0 + 1
        r_st, r_pp = run_lanes_ref(lt, stt, s0t, sb)
        assert LAUNCHES["tlb_sweep"] == n0 + 1     # plain runs not counted
        for key in ("counters", "cov_samples"):
            np.testing.assert_array_equal(k_st[key].cpu().numpy(),
                                          r_st[key].cpu().numpy(), key)
        np.testing.assert_array_equal(k_pp.cpu().numpy(), r_pp.cpu().numpy())
    return switched


@pytest.mark.parametrize("world", WORLDS)
def test_kernel_matches_plain(cuda, world):
    switched = _kernel_vs_plain(world_cells(P, world), cuda)
    # the multi-tenant batch compiles and runs the switch template
    assert switched == (world in ("multitenant", "nested"))


def test_run_sweep_on_card_translates_every_access(cuda):
    cells = world_cells(P, "static")
    n0 = LAUNCHES["tlb_sweep"]
    res = run_sweep(cells, cache=False, device="cuda")
    assert LAUNCHES["tlb_sweep"] == n0 + 1
    m, tr = cells[0].mapping, cells[0].trace
    for r in res:
        np.testing.assert_array_equal(r.ppn, np.asarray(m.ppn)[tr])
        assert (r.l1_hits + r.l2_regular_hits + r.l2_coalesced_hits
                + r.walks) == r.accesses


def test_kernel_rejects_out_of_range_trace(cuda):
    cells = world_cells(P, "static")[:2]
    lanes, stacks, st0, sb = pack_batch(cells)
    stacks = dict(stacks, trace=stacks["trace"].copy())
    stacks["trace"][0, 5] = stacks["maps"].shape[1]        # vpn == P
    lt, stt, s0t = as_tensors(lanes, stacks, st0, cuda)
    with pytest.raises(ValueError, match="trace vpn"):
        run_lanes(lt, stt, s0t, sb)
