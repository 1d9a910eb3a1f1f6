"""The work counts against hand counts at small shapes."""

import torch

from port_bench.harness import work
from port_bench.harness.device import PEAK_BYTES, PEAK_FLOPS


def test_chain_flops_by_hand():
    # hidden 2, c_dim 3, one block, one point: fc_p 3x2, fc_c 3x2, two 2x2, head 2x1
    assert work.chain_flops(1, 2, 3, 1) == 2 * (3 * 2 + 3 * 2 + 2 * 2 * 2 + 2)
    assert work.chain_flops(7, 32, 32, 5) == 7 * 2 * (96 + 5 * (1024 + 2048) + 32)


def test_k1_work_by_hand():
    flops, nbytes = work.k1_work(10, 4, 4, 2)
    assert flops == 10 * 2 * (12 + 2 * (16 + 32) + 4)
    assert nbytes == 10 * ((3 + 4) * 4 + 4)


def test_k2_cimg_work_counts_gated_rows_only():
    base, nbytes = work.k2_cimg_work(10, 0, 4, 4, 2, 4)
    gated, _ = work.k2_cimg_work(10, 3, 4, 4, 2, 4)
    assert base == work.chain_flops(10, 4, 4, 2)
    assert gated - base == 2 * 3 * 4 * 4
    assert nbytes == 10 * ((3 + 4 + 4) * 4 + 4)


def test_k2_batched_work_reads_coords_once():
    flops, nbytes = work.k2_batched_work(4, 10, 4, 4, 2)
    assert flops == 4 * work.chain_flops(10, 4, 4, 2)
    assert nbytes == 3 * 10 * 4 + 4 * 10 * (4 * 4 + 4)


def test_roofline_takes_the_larger_bound():
    assert work.least_s(PEAK_FLOPS, 0) == 1.0
    assert work.least_s(0, PEAK_BYTES) == 1.0
    assert abs(work.roofline_pct(PEAK_FLOPS, 0, 2.0) - 50.0) < 1e-9
    assert work.roofline_pct(1, 1, 0) is None


def test_model_flops_counts_a_linear():
    lin = torch.nn.Linear(8, 4)
    out, flops = work.model_flops(lin, torch.ones(5, 8))
    assert out.shape == (5, 4) and flops == 2 * 5 * 8 * 4
