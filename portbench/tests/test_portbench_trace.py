"""The trace reduction on a hand-made Chrome trace."""

from __future__ import annotations

import math

from portbench.metrics_util import idle_share
from portbench.trace import Trace


def _x(cat, name, ts, dur, corr=None, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": dict(args)}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


EVENTS = [
    _x("user_annotation", "portbench.hybrid", 0, 100),
    _x("cpu_op", "aten::mm", 5, 7),
    _x("cuda_runtime", "cudaLaunchKernel", 6, 2, corr=1),
    _x("cuda_driver", "cuLaunchKernelEx", 20, 2, corr=2),
    _x("cuda_runtime", "cudaLaunchKernel", 150, 2, corr=3),
    _x("cpu_op", "aten::item", 110, 60),
    _x("kernel", "void partial_topk_kernel<6, 64>", 30, 20, corr=1),
    _x("kernel", "nvjet_gemm", 40, 30, corr=2),
    _x("gpu_memcpy", "Memcpy DtoH", 80, 10, corr=9),
    _x("kernel", "outside", 160, 10, corr=3),
    _x("gpu_user_annotation", "portbench.hybrid", 30, 60),
]


def test_busy_union_and_idle_share():
    t = Trace(EVENTS, window_s=170e-6)
    assert t.busy_intervals() == [(30.0, 70.0), (80.0, 90.0), (160.0, 170.0)]
    assert math.isclose(t.busy_s, 60e-6)
    assert math.isclose(idle_share(t), 100.0 * (1 - 60 / 170))


def test_launches_in_a_range_by_correlation():
    t = Trace(EVENTS, window_s=1.0)
    assert t.kernels_launched_in("portbench.hybrid") == 2
    assert t.range_count("portbench.hybrid") == 1
    assert math.isclose(t.kernel_seconds(lambda n: "partial_topk_kernel" in n), 20e-6)


def test_breakdown_tops_and_idle_gaps_by_host_op():
    t = Trace(EVENTS, window_s=1.0)
    assert t.top_device_ops(2) == [["nvjet_gemm", 30e-6], ["void partial_topk_kernel<6, 64>", 20e-6]]
    gaps = dict(t.idle_gaps())
    # 0-30 (mid 15: inside the hybrid range, after aten::mm ended), 70-80 and
    # 90-160 (mid 125: aten::item)
    assert math.isclose(gaps["portbench.hybrid"], 40e-6)
    assert math.isclose(gaps["aten::item"], 70e-6)
