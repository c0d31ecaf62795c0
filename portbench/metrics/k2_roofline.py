"""K2 (kernels/flat_partial_topk.cu over the int8-residual mirror): the
least time of a batch's call (portbench/bounds.py, counted from the cell's
shapes) over the device time of the kernel by name in the traced slice,
per batch, in percent."""

from portbench import bounds, data

KERNEL = "partial_topk_kernel"


def read(run):
    if run.trace is None or not run.trace.range_count("portbench.hybrid"):
        return None
    seconds = run.trace.kernel_seconds(lambda name: KERNEL in name)
    if seconds <= 0:
        return None
    batches = run.trace.range_count("portbench.hybrid")
    spec = run.config["corpus"]
    bound, _ = bounds.k2_int8r_bound(run.traffic["batch"], spec["rows"], data.round_up(spec["rows"], data.ROW_BLOCK),
                                     data.round_up(spec["dim"], data.DIM_BLOCK))
    return 100.0 * bound * batches / seconds
