"""The timed path broken underneath the harness, on tiny cells on the CPU:
each fault a retrieval cell can have must come out as not correct, the
number that catches it past its limit and well past the sound run's
reading. (A one-card cell has no exchange between cards to leave out.)"""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.tests.tiny import tiny_spec

SEED = 3_000_000_031


def _stale(system):
    """A step that returns its state unchanged: fusion hands back the first
    batch's answer for every later batch."""
    import intool_rag_tpu_torch.index.hybrid as hybrid

    fuse, first = hybrid._fuse, []

    def stale(*a, **kw):
        out = fuse(*a, **kw)
        first.append(out) if not first else None
        return first[0] if first[0][0].shape == out[0].shape else out

    hybrid._fuse = stale
    return lambda: setattr(hybrid, "_fuse", fuse)


def _half_batch(system):
    """Half of the batch left out: the second half of the queries gets the
    first half's embeddings."""
    embed = system.retriever._embed

    def half(queries):
        emb = embed(queries)
        h = emb.shape[0] // 2
        return emb[:h].repeat(2, 1)[: emb.shape[0]] if h else emb

    system.retriever._embed = half
    return lambda: None


def _altered_answer(system):
    """An answer altered where it is produced: the first fused row of every
    query moves to the next corpus row."""
    import intool_rag_tpu_torch.index.hybrid as hybrid

    fuse = hybrid._fuse

    def altered(*a, **kw):
        vals, rows = fuse(*a, **kw)
        rows = rows.clone()
        rows[:, 0] = rows[:, 0] + 1
        return vals, rows

    hybrid._fuse = altered
    return lambda: setattr(hybrid, "_fuse", fuse)


def _dense_half_corpus(system):
    """The dense kernel scans half the corpus: the flat plan's valid rows
    halved."""
    dense = system.engine.dense
    plan = dense.flat_plan

    def half(k, **kw):
        arrays, statics = plan(k, **kw)
        return arrays, dict(statics, valid_n=statics["valid_n"] // 2)

    dense.flat_plan = half
    return lambda: None


def _bm25_not_its_top(system):
    """BM25 hands fusion rows other than its top: ranks k/2 to 3k/2."""
    import intool_rag_tpu_torch.index.hybrid as hybrid

    dispatch = hybrid.bm25_dispatch

    def shifted(qt, qf, arrays, *, k, **kw):
        vals, rows = dispatch(qt, qf, arrays, k=2 * k, **kw)
        return vals[:, k // 2 : k // 2 + k], rows[:, k // 2 : k // 2 + k]

    hybrid.bm25_dispatch = shifted
    return lambda: setattr(hybrid, "bm25_dispatch", dispatch)


def _wrong_probes(system):
    """The capacity tier probes the wrong lists: each probe moves to the next
    list id (with its centroid dots)."""
    import intool_rag_tpu_torch.index.bits_index as bits_index

    probes = bits_index.tile_probes

    def wrong(queries, centroids, nprobe):
        order, qs, table, _ = probes(queries, centroids, nprobe)
        table = (table + 1) % centroids.shape[0]
        c_sel = (qs @ centroids.T).gather(1, table.repeat_interleave(8, dim=0))
        return order, qs, table, c_sel

    bits_index.tile_probes = wrong
    return lambda: setattr(bits_index, "tile_probes", probes)


def _scan_part_of_lists(system):
    """K3 scans the first eighth of each probed list's blocks: about half
    the rows a list holds, the tier being sized at four times its rows."""
    import intool_rag_tpu_torch.index.bits_index as bits_index

    scan = bits_index.ivf_bits_topk

    def half(qs, codes, scales, probe_blocks, c_sel, k, *, blocks_per_list, **kw):
        return scan(qs, codes, scales, probe_blocks, c_sel, k, blocks_per_list=max(1, blocks_per_list // 8), **kw)

    bits_index.ivf_bits_topk = half
    return lambda: setattr(bits_index, "ivf_bits_topk", scan)


def _row_left_out(system):
    """The capacity tier leaves a row out: each append's first row is never
    stored (its slot stays empty)."""
    from intool_rag_tpu_torch.index.bits_index import IVFBitsIndex

    append = IVFBitsIndex.append

    def leaky(self, embeddings):
        gids = append(self, embeddings)
        slot = int((self.gid == int(gids[0])).nonzero()[0, 0])
        self.gid[slot] = -1
        self.scales[slot // self.block_n, 0, slot % self.block_n] = -1.0
        return gids

    IVFBitsIndex.append = leaky
    return lambda: setattr(IVFBitsIndex, "append", append)


def _run(kind, fault=None):
    undo = []
    try:
        result, _ = harness.run_cell("tiny", SEED, 1.0, False, device="cpu", spec=tiny_spec(kind),
                                     faults=None if fault is None else lambda system: undo.append(fault(system)))
    finally:
        for u in undo:
            u()
    return result


@pytest.fixture(scope="module")
def sound():
    return {kind: _run(kind) for kind in ("flat", "bits")}


@pytest.mark.parametrize("fault,kind,number", [
    (_stale, "flat", "fused_gap"),
    (_half_batch, "flat", "emb_dist"),
    (_altered_answer, "flat", "fused_gap"),
    (_dense_half_corpus, "flat", "dense_miss"),
    (_bm25_not_its_top, "flat", "bm25_miss"),
    (_wrong_probes, "bits", "probe_gap"),
    (_scan_part_of_lists, "bits", "dense_miss"),
    (_row_left_out, "bits", "placement"),
])
def test_fault_is_not_correct(sound, fault, kind, number):
    result = _run(kind, fault)
    assert result["correct"] is False
    check, before = result["checks"][number], sound[kind]["checks"][number]["value"]
    assert check["value"] > check["limit"] and check["value"] > 3 * before, (result["checks"], before)
