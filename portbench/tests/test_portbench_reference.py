"""The reference's capacity-tier rules against the port's own tier, on the
CPU: the probe rule, the placement and the scan's scores."""

from __future__ import annotations

import torch

from portbench.reference import search as ref_search


def _tier(n=6000, d=64, nlist=8):
    from intool_rag_tpu_torch.index.bits_index import IVFBitsIndex

    g = torch.Generator().manual_seed(3)
    x = torch.randn((n, d), generator=g)
    x = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    index = IVFBitsIndex.train(x[: 8 * nlist].float(), nlist, capacity=4 * n, refine=True, device="cpu")
    index.append(x)
    return index, x


def test_probe_rule_matches_the_ports_tiles():
    from intool_rag_tpu_torch.index.bits_index import tile_probes

    index, _ = _tier()
    q = torch.randn((37, 64), generator=torch.Generator().manual_seed(5))
    q = q / q.norm(dim=1, keepdim=True)
    order, _, probes, _ = tile_probes(q, index.centroids, 3)
    assert ref_search.probe_gap(q, index.centroids, order, probes) < 1e-6
    ref_order, ref_probes = ref_search.probe_table(q, index.centroids, 3)
    assert torch.equal(ref_order, order)
    assert ref_search.probe_gap(q, index.centroids, ref_order, ref_probes) < 1e-6
    wrong = probes.clone()
    wrong[:, 0] = (wrong[:, 0] + 1) % index.nlist
    assert ref_search.probe_gap(q, index.centroids, order, wrong) > 1e-3


def test_placement_and_scan_follow_the_ports_tier():
    index, x = _tier()
    lists, slots, once = ref_search.row_lists(index.gid, index.cap_l, x.shape[0])
    assert once and (lists >= 0).all()
    assert ref_search.misplaced(x, x.shape[0], index.centroids, lists) == 0.0
    moved = lists.clone()
    moved[:10] = (moved[:10] + 3) % index.nlist
    assert ref_search.misplaced(x, x.shape[0], index.centroids, moved, choices=1) > 0
    # every list probed: the tier's scan (exact tail) against the reference's scores
    q = torch.randn((16, 64), generator=torch.Generator().manual_seed(6))
    q = q / q.norm(dim=1, keepdim=True)
    vals, rows = index.search(q, 20, nprobe=index.nlist, tail="exact")
    member = torch.ones((16, index.nlist), dtype=torch.bool)
    ref_vals, ref_rows = ref_search.bits_topk(q, x, x.shape[0], index.centroids, lists, member, 20)
    assert (ref_vals[:, 0] - ref_vals[:, -1]).min() > 0
    overlap = [len(set(a.tolist()) & set(b.tolist())) for a, b in zip(rows, ref_rows)]
    assert min(overlap) >= 18
