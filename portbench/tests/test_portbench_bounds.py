"""Operation and byte counts against hand counts."""

from __future__ import annotations

import pytest

from portbench import bounds


def test_k2_int8r_bound_is_the_kernel_tables():
    # 3 int8 products of [256, 1024] by [1024, 1M]: 1.572864e12 operations at
    # 1,979 TOP/s = 0.7948 ms; bytes 2 query planes 524,288 + 2 corpus planes
    # 2.048e9 + scales 4e6 + 256 x 31,360 candidates x 8 = 2,116,749,568 at
    # 3.35 TB/s = 0.6319 ms
    seconds, by = bounds.k2_int8r_bound(256, 1_000_000, 1_003_520, 1024)
    assert by == "operations"
    assert seconds == pytest.approx(1.572864e12 / 1979e12)
    t_bytes, _ = bounds.kernel_bound(256, 1_000_000, 1024, 0, 1, 2, 2, 1979e12, 31_360, scales=True)
    assert t_bytes == pytest.approx(2_116_749_568 / 3.35e12)


def test_scan_bound_counts_distinct_blocks_once():
    # 100 distinct blocks of 1024 rows x (128 + 32) bytes = 16,384,000; queries
    # 8 x 1024 x 2 = 16,384; probe entries 32 x 8 = 256; candidates 8 x 512 x 8
    # = 32,768: 16,433,408 bytes. Operations 2 x 8 x 1024 x 200 x 1024
    t, by = bounds.scan_bound(100, 200, 32, 1024, 1024, 8, 512)
    assert by == "bytes"
    assert t == pytest.approx(16_433_408 / 3.35e12)
    t_ops, by = bounds.scan_bound(100, 800, 32, 1024, 1024, 8, 512)
    assert by == "operations" and t_ops == pytest.approx(2 * 8 * 1024 * 800 * 1024 / 989e12)


def test_encoder_flops_of_bge_m3():
    model = {"hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 24}
    assert bounds.encoder_layer_params(model) * 24 == 301_989_888  # the issue's ~302M
    # one sequence of 10 tokens: 24 x (2 x 12,582,912 x 10 + 4 x 10^2 x 1024)
    assert bounds.encoder_flops(model, [10]) == 6_049_628_160
    assert bounds.encoder_flops(model, [10, 10]) == 2 * 6_049_628_160


def test_scanned_blocks_leave_out_blocks_that_hold_no_row():
    import torch

    from portbench.metrics_util import scanned_blocks

    # 2 lists of 3 blocks of 4 slots: list 0 holds 5 rows (blocks 0-1), list 1 holds 2 (block 3)
    gid = torch.full((24,), -1)
    gid[:5] = torch.arange(5)
    gid[12:14] = torch.arange(5, 7)
    tier = {"gid": gid, "block_n": 4}
    scan = {"probe_blocks": torch.tensor([[0, 3], [3, 0]]), "blocks_per_list": 3}
    assert scanned_blocks(scan, tier).tolist() == [0, 1, 3, 3, 0, 1]
